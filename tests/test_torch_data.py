"""The port's data pipeline against the JAX package's: partitions, client
weights, loader batches and synthetic images and tokens, all identical
arrays (both are numpy)."""
import numpy as np
import pytest

from repro import data as jd
from repro_torch import data as td


def _eq_lists(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("n,clients,seed", [(1000, 10, 0), (517, 7, 3),
                                            (64, 40, 1)])
def test_partitions_and_weights_identical(n, clients, seed):
    labels = np.random.default_rng(seed).integers(0, 10, n).astype(np.int32)
    _eq_lists(td.iid_partition(labels, clients, seed),
              jd.iid_partition(labels, clients, seed))
    for alpha in (0.1, 0.5, 5.0):
        want = jd.dirichlet_partition(labels, clients, alpha, seed)
        got = td.dirichlet_partition(labels, clients, alpha, seed)
        _eq_lists(got, want)
        w = td.client_weights(got)
        assert w.dtype == np.float32
        np.testing.assert_array_equal(w, jd.client_weights(want))


@pytest.mark.parametrize("noise,seed", [(0.35, 0), (3.0, 2)])
def test_synthetic_images_identical(noise, seed):
    a = jd.SyntheticImages(num_train=300, num_test=50, noise=noise, seed=seed)
    b = td.SyntheticImages(num_train=300, num_test=50, noise=noise, seed=seed)
    np.testing.assert_array_equal(b.templates, a.templates)
    for split in ("train_set", "test_set"):
        for x, y in zip(getattr(b, split)(), getattr(a, split)()):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def test_loader_round_batches_identical():
    imgs, labels = jd.SyntheticImages(num_train=400, num_test=10).train_set()
    shards = jd.iid_partition(labels, 8, 0)
    arrays = {"images": imgs, "labels": labels}
    a = jd.FederatedLoader(arrays, shards, 4, 5, seed=3)
    b = td.FederatedLoader(arrays, shards, 4, 5, seed=3)
    assert b.num_clients == a.num_clients == 8
    for r in (0, 1, 17):
        want, got = a.round_batch(r), b.round_batch(r)
        assert set(got) == set(want)
        for k in want:
            assert got[k].shape == (8, 5, 4) + arrays[k].shape[1:]
            np.testing.assert_array_equal(got[k], want[k])


def test_synthetic_tokens_identical():
    a = jd.SyntheticTokens(vocab_size=300, seq_len=16, num_clients=3, seed=1)
    b = td.SyntheticTokens(vocab_size=300, seq_len=16, num_clients=3, seed=1)
    for c in range(3):
        np.testing.assert_array_equal(b.batch(c, 4, 7), a.batch(c, 4, 7))
    np.testing.assert_array_equal(td.round_batches(b, 3, 2, 4, 5),
                                  jd.round_batches(a, 3, 2, 4, 5))
