"""The port's dry run (``repro_torch.launch.dryrun``) and its cost models:
the kernels traced shape-only (no launch; each priced at its own work by
``FlopCounterMode``), the step counter's bytes and temp peak on a step
whose answer is known, a full-width granite-3-2b prefill's FLOPs against
an explicit count from its config, the record on the card and on a
production layout, and ``model_flops`` / ``from_dryrun`` /
``energy_record`` against the JAX package's on the same records."""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro.energy import costs as jcosts
from repro_torch.configs import dryrun_pairs, get_config, get_shape
from repro_torch.configs.base import InputShape
from repro_torch.energy import costs as tcosts
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.launch import dryrun, steps


@pytest.fixture(scope="module")
def jax_dryrun():
    """The reference's dryrun module.  Importing it sets XLA_FLAGS (512
    host devices) for a backend not yet started: start this process's
    first, and put the variable back."""
    jax.devices()
    old = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as mod
    if old is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = old
    return mod


def test_kernels_trace_shape_only_at_their_own_work():
    """Under FakeTensorMode the four ops allocate their outputs and launch
    nothing; FlopCounterMode counts causal / windowed attention at the
    pairs the mask keeps, the scan at its chunked products and an
    aggregation at 2 C M."""
    before = ops.launch_counts()
    with FakeTensorMode():
        q = torch.empty((2, 300, 8, 64), dtype=torch.bfloat16)
        kv = torch.empty((2, 300, 2, 64), dtype=torch.bfloat16)
        x = torch.empty((1, 512, 8, 32))
        dt = torch.empty((1, 512, 8))
        A = torch.empty((8,))
        Bm = torch.empty((1, 512, 2, 16))
        w = torch.empty((1000,))
        ws = torch.empty((4, 1000))
        s = torch.empty((4,))
        tree = {"a": torch.empty((3, 5)), "b": [torch.empty((7,))]}
        stack = {"a": torch.empty((4, 3, 5)), "b": [torch.empty((4, 7))]}
        for causal, window in ((True, 0), (True, 64), (False, 0)):
            with FlopCounterMode(display=False) as fc:
                out = ops.flash_attention(q, kv, kv, causal=causal,
                                          window=window)
            assert out.shape == q.shape and out.dtype == q.dtype
            assert fc.get_total_flops() == fa.work_flops(
                2, 300, 300, 8, 64, causal, window)
        with FlopCounterMode(display=False) as fc:
            y, h = ops.ssd_scan(x, dt, A, Bm, Bm, chunk=128)
        assert y.shape == x.shape and h.shape == (1, 8, 32, 16)
        assert fc.get_total_flops() == ssd.work_flops(1, 512, 8, 32, 2, 16,
                                                      128)
        with FlopCounterMode(display=False) as fc:
            out = ops.fused_agg(w, ws, s)
            new = ops.fused_agg_tree(tree, stack, s)
        assert out.shape == w.shape
        assert new["a"].shape == (3, 5) and new["b"][0].shape == (7,)
        assert fc.get_total_flops() == 2 * 4 * 1000 + 2 * 4 * (15 + 7)
    assert ops.launch_counts() == before
    # causal attention is half the square (and a window less), not all of it
    assert fa.work_flops(1, 2048, 2048, 1, 64, True, 0) == \
        4 * 64 * 2048 * 2049 // 2
    assert fa.work_flops(1, 4096, 4096, 1, 64, True, 2048) < \
        fa.work_flops(1, 4096, 4096, 1, 64, True, 0)


def test_step_counter_counts_bytes_and_the_temp_peak():
    with FakeTensorMode():
        a = torch.empty((1000,))                       # 4000 bytes

        def step(x):
            y = x + 1            # reads 4000, writes 4000; live 4000
            z = y * 2            # 8000; live 8000 (peak)
            del y                # live 4000
            return z.view(10, 100).sum()   # view moves none; sum 4000 + 4

        with dryrun.StepCounter((a,)) as c:
            step(a)
    assert c.bytes == 8000 + 8000 + 4004
    assert c.temp_peak == 8000


def _explicit_prefill_flops(cfg, B, S):
    """2 M N K of every product of a dense transformer's prefill over S
    tokens, the causal attention at its visible pairs, and the unembedding
    of the last position."""
    d, q, kv, ff = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff
    per_layer = 2 * B * S * (d * q + 2 * d * kv + q * d + 3 * d * ff)
    attn = 4 * B * cfg.num_heads * cfg.head_dim * S * (S + 1) // 2
    vpad = ((cfg.vocab_size + 127) // 128) * 128
    return cfg.num_layers * (per_layer + attn) + 2 * B * d * vpad


def test_granite_prefill_flops_at_full_width_match_an_explicit_count():
    cfg = get_config("granite-3-2b")
    B, S = 1, 2048
    b = steps.build_step(cfg, InputShape("p", S, B, "prefill"), None,
                         device="cpu")
    tr = dryrun.trace(b)
    want = _explicit_prefill_flops(cfg, B, S)
    assert abs(tr["flops"] - want) <= 0.02 * want, (tr["flops"], want)
    assert tr["flops_by_op"]["repro_torch.flash_attention"] == \
        cfg.num_layers * fa.work_flops(B, S, S, cfg.num_heads,
                                       cfg.head_dim, True, 0)
    logits, cache = tr["outputs"]
    assert tuple(logits.shape) == (B, 1, cfg.vocab_size)
    assert dryrun.tree_bytes(cache) == 2 * cfg.num_layers * B * S * \
        cfg.kv_dim * 2


def test_record_on_the_card_and_on_a_production_layout():
    cfg = get_config("mamba2-1.3b")
    rec = dryrun.run_one("mamba2-1.3b", "decode_32k", "card", device="cpu")
    b = steps.build_step(cfg, get_shape("decode_32k"), None, device="cpu")
    m = rec["memory"]
    assert m["argument_bytes_per_device"] == dryrun.tree_bytes(b.args,
                                                               "cpu")
    assert m["output_bytes_per_device"] > 0 and m["temp_bytes_per_device"] > 0
    assert rec["partitioned"] and rec["cost"]["loop_calibrated"] is False
    assert rec["collective_bytes_per_device"] == 0.0
    r = rec["roofline"]
    assert r["t_compute_s"] == rec["cost"]["flops_per_device"] / 989e12
    assert r["t_memory_s"] == rec["cost"]["bytes_per_device"] / 3.35e12
    assert r["dominant"] == "memory"
    assert rec["energy"] == tcosts.energy_record(
        rec["cost"]["flops_per_device"], cfg.num_active_params(), 1)

    spec = dryrun.run_one("mamba2-1.3b", "prefill_32k", "single",
                          device="cpu")
    assert not spec["partitioned"]
    assert spec["cost"]["bytes_per_device"] is None
    assert spec["cost"]["flops_per_device"] == \
        spec["cost"]["flops_global"] / 256
    sm = spec["memory"]
    assert 0 < sm["argument_bytes_per_device"] < sm["argument_bytes_global"]
    assert sm["temp_bytes_per_device"] is None
    with pytest.raises(ValueError, match="does not divide"):
        with FakeTensorMode():
            x = torch.empty((10, 4))
        dryrun.per_device_bytes([x], [steps.P("data", None)],
                                dryrun._mesh_of("single")[1])


def test_model_flops_match_the_reference_for_every_pair(jax_dryrun):
    from repro.configs import get_config as jax_config

    for arch, shape in dryrun_pairs():
        for T in (1, 5):
            assert dryrun.model_flops(get_config(arch), get_shape(shape),
                                      T) == \
                jax_dryrun.model_flops(jax_config(arch), get_shape(shape), T)


def _records():
    """Records as both packages write them (the keys from_dryrun reads)."""
    out = []
    r = np.random.default_rng(0)
    for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        for active in (None, 1.5e9):
            out.append({"shape": shape,
                        "cost": {"flops_per_device": float(r.uniform(1e9,
                                                                     1e15))},
                        "params_analytic": 2.5e9, "params_active": active})
    return out


def test_from_dryrun_and_energy_record_equal_the_references():
    recs = _records()
    for rec in recs:
        for T in (1, 5):
            assert dataclasses.asdict(tcosts.from_dryrun(rec, T)) == \
                dataclasses.asdict(jcosts.from_dryrun(rec, T))
        assert tcosts.energy_record(rec["cost"]["flops_per_device"], 2.5e9,
                                    5) == \
            jcosts.energy_record(rec["cost"]["flops_per_device"], 2.5e9, 5)
    dec = [x for x in recs if x["shape"] in ("decode_32k", "long_500k")]
    pre = [x for x in recs if x["shape"] == "prefill_32k"]
    for d in dec:
        for p in [None] + pre:
            for kw in ({}, {"batch": 3, "prompt_len": 77}):
                a = tcosts.DecodeCostModel.from_dryrun(d, p, **kw)
                b = jcosts.DecodeCostModel.from_dryrun(d, p, **kw)
                assert (a.joules_per_prefill_token,
                        a.joules_per_decode_step,
                        a.joules_per_response_upload) == \
                    (float(b.joules_per_prefill_token),
                     float(b.joules_per_decode_step),
                     float(b.joules_per_response_upload))
