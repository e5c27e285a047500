"""Tests that need an NVIDIA card (marker ``cuda``; they skip without one).

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_kernels_cuda.py

(``--noconftest``: the suite's conftest imports JAX.)  The kernel is held
against its plain version within ``flash_attention.kernel_tolerance``
(bf16: twice the largest move of rounding P to bf16, plus the output's
rounding; fp32: the reference's 2e-5); ``chip_smoke.py`` repeats the check
at the main path's shapes.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import get_model
from repro_torch.serve.engine import DecodeEngine, EngineConfig, Request

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(B, S, H, K, D, dtype, device, seed=0):
    r = np.random.default_rng(seed)
    mk = lambda h: torch.tensor(r.standard_normal((B, S, h, D)) * 0.5,
                                dtype=torch.float32).to(dtype).to(device)
    return mk(H), mk(K), mk(K)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128])
def test_kernel_matches_plain(card, dtype, D):
    """Batch 2, ragged length 200, GQA 8/2, all three masks; the launch
    counter moves once per launch."""
    q, k, v = _qkv(2, 200, 8, 2, D, dtype, card)
    for causal, window in ((True, 0), (True, 64), (False, 0)):
        before = fa.flash_attention_cuda.launches
        got = ops.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        assert fa.flash_attention_cuda.launches == before + 1
        want = fa.flash_attention_plain(q, k, v, causal=causal,
                                        window=window)
        tol = fa.kernel_tolerance(q, k, v, want, causal=causal,
                                  window=window)
        err = (got.float() - want.float()).abs()
        assert bool((err <= tol).all()), (err / tol).max().item()


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(card):
    q, k, v = _qkv(1, 16, 4, 2, 64, torch.float32, card)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention_cuda(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_cuda(q[..., :32], k[..., :32], v[..., :32])
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_cuda(q.transpose(1, 3).contiguous()
                                .transpose(1, 3), k, v)
    with pytest.raises(ValueError, match="multiple of KV heads"):
        fa.flash_attention_cuda(q[:, :, :3], k, v)


@pytest.mark.cuda
def test_engine_on_card_matches_engine_on_cpu(card):
    """granite-3-2b smoke config in fp32: greedy tokens through the engine
    on the card (flash kernel in prefill) equal those on the CPU (plain
    path), for staggered mixed-length prompts."""
    cfg = get_smoke_config("granite-3-2b")
    model = get_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0))
    on_card = _to(params, card)
    specs = [(12, 6), (16, 4), (9, 8), (14, 5)]
    prompts = [np.random.default_rng(i).integers(0, cfg.vocab_size, S)
               for i, (S, _) in enumerate(specs)]
    config = EngineConfig(slots=2, cache_len=25, max_new=8)

    def run(p, device):
        return DecodeEngine(model, p, config, device=device).run(
            [Request(rid=i, tokens=prompts[i], max_new=g)
             for i, (_, g) in enumerate(specs)], arrivals=[0, 0, 2, 3])

    before = fa.flash_attention_cuda.launches
    got, want = run(on_card, card), run(params, "cpu")
    assert fa.flash_attention_cuda.launches - before == (
        len(specs) * cfg.num_layers)
    for i in range(len(specs)):
        np.testing.assert_array_equal(got[i].tokens, want[i].tokens)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)
