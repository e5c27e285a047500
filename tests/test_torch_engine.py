"""The port's continuous-batching engine against the JAX package's: greedy
tokens must be identical (granite-3-2b and mamba2-1.3b smoke configs, fp32,
params carried across by ``repro_torch.convert``), and the slot lifecycle
must hold: KV caches for the attention family, conv and SSM state caches
for the state-space family."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import get_model as jax_model
from repro.serve.engine import DecodeEngine as JaxEngine
from repro.serve.engine import EngineConfig as JaxConfig
from repro.serve.engine import Request as JaxRequest
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch.serve import generate
from repro_torch.models import get_model
from repro_torch.serve.engine import (DecodeEngine, EngineConfig, Request,
                                      pick_tokens)

_SETUP = {}


def _setup(arch="granite-3-2b"):
    if arch not in _SETUP:
        jm = jax_model(jax_smoke(arch))
        jp = jm.init_params(jax.random.PRNGKey(0))
        tm = get_model(get_smoke_config(arch))
        _SETUP[arch] = (jm, jp, tm, params_from_numpy(jp, device="cpu"))
    return _SETUP[arch]


def _prompt(S, seed, vocab=515):
    return np.random.default_rng(seed).integers(0, vocab, S).astype(np.int32)


def _engine(tm, tp, **kw):
    return DecodeEngine(tm, tp, EngineConfig(**kw), device="cpu")


def _solo(tm, tp, tokens, gen, cache_len):
    out = generate(tm, tp, {"tokens": torch.tensor(tokens, dtype=torch.long)[None]},
                   gen, cache_len, device="cpu")
    return out[0].numpy()


def test_staggered_mixed_lengths_identical_to_jax_engine_and_generate():
    """Mixed prompt lengths and budgets, arrivals staggered so inserts land
    between decode steps of running slots: every request's greedy tokens
    equal the JAX engine's and the port's single-stream `generate`."""
    jm, jp, tm, tp = _setup()
    specs = [(12, 6), (16, 4), (9, 8), (14, 5), (16, 8)]   # (S, gen)
    arrivals = [0, 0, 2, 3, 9]
    cache_len, max_new = 16 + 8 + 1, 8
    prompts = [_prompt(S, 10 + i) for i, (S, _) in enumerate(specs)]

    jeng = JaxEngine(jm, jp, JaxConfig(slots=2, cache_len=cache_len,
                                       max_new=max_new))
    jdone = jeng.run([JaxRequest(rid=i, tokens=prompts[i], max_new=g)
                      for i, (_, g) in enumerate(specs)], arrivals=arrivals)
    teng = _engine(tm, tp, slots=2, cache_len=cache_len, max_new=max_new)
    tdone = teng.run([Request(rid=i, tokens=prompts[i], max_new=g)
                      for i, (_, g) in enumerate(specs)], arrivals=arrivals)

    assert set(tdone) == set(jdone) == set(range(len(specs)))
    for i, (S, g) in enumerate(specs):
        assert tdone[i].tokens.shape == (g,)
        assert tdone[i].tokens.dtype == np.int32
        np.testing.assert_array_equal(tdone[i].tokens, jdone[i].tokens,
                                      err_msg=f"request {i} vs JAX engine")
        np.testing.assert_array_equal(
            tdone[i].tokens, _solo(tm, tp, prompts[i], g, cache_len),
            err_msg=f"request {i} vs generate")
        assert tdone[i].prompt_len == jdone[i].prompt_len == S
        assert tdone[i].slot == jdone[i].slot
    assert teng.stats == jeng.stats


def test_ssm_staggered_mixed_lengths_identical_to_jax_engine():
    """mamba2-1.3b: prompts of chunk-multiple lengths (16, 32: the chunked
    scan) and ragged ones (the per-step recurrence), staggered so inserts
    land between decode steps: every request's greedy tokens equal the JAX
    engine's and the port's single-stream `generate`; the engines' slot
    assignments and counters agree."""
    jm, jp, tm, tp = _setup("mamba2-1.3b")
    specs = [(16, 6), (32, 4), (9, 8), (14, 5), (32, 8), (1, 3)]
    arrivals = [0, 0, 2, 3, 9, 10]
    cache_len, max_new = 32 + 8 + 1, 8
    prompts = [_prompt(S, 30 + i, 512) for i, (S, _) in enumerate(specs)]

    jeng = JaxEngine(jm, jp, JaxConfig(slots=2, cache_len=cache_len,
                                       max_new=max_new))
    jdone = jeng.run([JaxRequest(rid=i, tokens=prompts[i], max_new=g)
                      for i, (_, g) in enumerate(specs)], arrivals=arrivals)
    teng = _engine(tm, tp, slots=2, cache_len=cache_len, max_new=max_new)
    tdone = teng.run([Request(rid=i, tokens=prompts[i], max_new=g)
                      for i, (_, g) in enumerate(specs)], arrivals=arrivals)
    assert set(tdone) == set(jdone) == set(range(len(specs)))
    for i, (S, g) in enumerate(specs):
        np.testing.assert_array_equal(tdone[i].tokens, jdone[i].tokens,
                                      err_msg=f"request {i} vs JAX engine")
        np.testing.assert_array_equal(
            tdone[i].tokens, _solo(tm, tp, prompts[i], g, cache_len),
            err_msg=f"request {i} vs generate")
        assert tdone[i].prompt_len == S and tdone[i].slot == jdone[i].slot
    assert teng.stats == jeng.stats


def test_ssm_slot_reuse_matches_jax_engine():
    """mamba2-1.3b, one slot: a request decoded in a reclaimed slot, after a
    longer occupant, equals the JAX engine's tokens and its own solo run:
    the insert overwrote the slot's conv and SSM states."""
    jm, jp, tm, tp = _setup("mamba2-1.3b")
    cache_len = 45
    p1, p2 = _prompt(32, 40, 512), _prompt(7, 41, 512)
    kw = dict(slots=1, cache_len=cache_len, max_new=6)
    reqs = [(p1, 6), (p2, 5)]
    jdone = JaxEngine(jm, jp, JaxConfig(**kw)).run(
        [JaxRequest(rid=i, tokens=p, max_new=g)
         for i, (p, g) in enumerate(reqs)])
    engine = _engine(tm, tp, **kw)
    tdone = engine.run([Request(rid=i, tokens=p, max_new=g)
                        for i, (p, g) in enumerate(reqs)])
    assert tdone[0].slot == tdone[1].slot == 0
    for i, (p, g) in enumerate(reqs):
        np.testing.assert_array_equal(tdone[i].tokens, jdone[i].tokens)
        np.testing.assert_array_equal(tdone[i].tokens,
                                      _solo(tm, tp, p, g, cache_len))
    assert set(engine._cache) == {"conv", "ssm"}


def test_ring_cache_engine_matches_jax_engine():
    """Sliding-window ring caches: prompts longer than the window, decode
    wrapping around it."""
    import dataclasses
    jcfg = dataclasses.replace(jax_smoke("granite-3-2b"), sliding_window=8)
    jm = jax_model(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tm = get_model(dataclasses.replace(get_smoke_config("granite-3-2b"),
                                       sliding_window=8))
    tp = params_from_numpy(jp, device="cpu")
    prompts = [_prompt(S, 20 + S) for S in (11, 5, 14)]
    kw = dict(slots=2, cache_len=8, max_new=9, ring=True, window=8)
    jdone = JaxEngine(jm, jp, JaxConfig(**kw)).run(
        [JaxRequest(rid=i, tokens=p, max_new=9) for i, p in enumerate(prompts)],
        arrivals=[0, 1, 3])
    tdone = _engine(tm, tp, **kw).run(
        [Request(rid=i, tokens=p, max_new=9) for i, p in enumerate(prompts)],
        arrivals=[0, 1, 3])
    for i in range(3):
        np.testing.assert_array_equal(tdone[i].tokens, jdone[i].tokens)


def test_slot_reclaim_and_reuse_no_stale_cache():
    """A finished slot returns to the allocator, and a request decoded in
    the reused slot (after a longer previous occupant) matches its solo
    run: the insert overwrote the whole slot slice."""
    _, _, tm, tp = _setup()
    cache_len = 20
    engine = _engine(tm, tp, slots=1, cache_len=cache_len, max_new=4)
    p1, p2 = _prompt(15, 2), _prompt(6, 3)
    slot1 = engine.prefill_request(Request(rid="a", tokens=p1, max_new=4))
    assert engine.free_slots == 0
    with pytest.raises(RuntimeError, match="no free slot"):
        engine.prefill_request(Request(rid="b", tokens=p2, max_new=4))
    finished = []
    while not finished:
        finished = engine.generate_step()
    assert finished[0].rid == "a" and engine.free_slots == 1
    slot2 = engine.prefill_request(Request(rid="b", tokens=p2, max_new=4))
    assert slot2 == slot1
    # the reused slot holds only the new prompt's keys beyond its length
    assert not engine._cache["k"][:, slot2, len(p2):].any()
    done = {}
    while engine.active_count:
        for f in engine.generate_step():
            done[f.rid] = f
    np.testing.assert_array_equal(done["b"].tokens,
                                  _solo(tm, tp, p2, 4, cache_len))


def test_max_new_one_finishes_on_prefill():
    _, _, tm, tp = _setup()
    engine = _engine(tm, tp, slots=2, cache_len=13, max_new=4)
    p = _prompt(8, 5)
    engine.prefill_request(Request(rid=0, tokens=p, max_new=1))
    assert engine.free_slots == 2            # reclaimed immediately
    assert engine.stats["steps"] == 0
    done = engine.run([], arrivals=[])       # drain the queued completion
    np.testing.assert_array_equal(done[0].tokens, _solo(tm, tp, p, 1, 13))


def test_sampling_valid_and_reproducible():
    _, _, tm, tp = _setup()
    prompts = [_prompt(8, 7 + i) for i in range(3)]
    config = EngineConfig(slots=2, cache_len=15, max_new=6, greedy=False,
                          temperature=2.0)

    def draw(seed):
        engine = DecodeEngine(tm, tp, config, device="cpu",
                              rng=torch.Generator().manual_seed(seed))
        done = engine.run([Request(rid=i, tokens=p, max_new=6)
                           for i, p in enumerate(prompts)])
        return np.stack([done[i].tokens for i in range(3)])

    a, b, c = draw(1), draw(1), draw(2)
    assert a.shape == (3, 6)
    assert np.all(a >= 0) and np.all(a < tm.cfg.vocab_size)
    np.testing.assert_array_equal(a, b)              # same rng -> same draws
    assert not np.array_equal(a, c), "rng does not reach the sampler"


def test_gumbel_sampling_follows_softmax():
    """The sampler draws from softmax(logits / T): frequencies over 20000
    draws within 0.02 of the probabilities (binomial sd <= 0.0036)."""
    logits = torch.tensor([[0.0, 1.0, 2.0, -1.0]])
    g = torch.Generator().manual_seed(0)
    n = 20000
    draws = torch.cat([pick_tokens(logits, False, 2.0, [g]) for _ in range(n)])
    freq = torch.bincount(draws, minlength=4).double() / n
    probs = torch.softmax(logits[0].double() / 2.0, -1)
    assert torch.allclose(freq, probs, atol=0.02), (freq, probs)


def test_admission_and_config_validation():
    _, _, tm, tp = _setup()
    engine = _engine(tm, tp, slots=1, cache_len=12, max_new=4)
    with pytest.raises(ValueError, match="exceeds cache_len"):
        engine.prefill_request(Request(rid=0, tokens=np.zeros(10, np.int32),
                                       max_new=4))
    for bad in (0, 5):                       # outside [1, config.max_new]
        with pytest.raises(ValueError, match="max_new"):
            engine.prefill_request(Request(rid=0, tokens=np.zeros(6, np.int32),
                                           max_new=bad))
    assert engine.free_slots == 1            # failed admissions leak no slot
    with pytest.raises(ValueError, match="arrival steps"):
        engine.run([Request(rid=0, tokens=np.zeros(3, np.int32), max_new=2)],
                   arrivals=[0, 1])
    with pytest.raises(ValueError, match="at least one slot"):
        EngineConfig(slots=0, cache_len=8, max_new=2)
    with pytest.raises(ValueError, match="max_new"):
        EngineConfig(slots=1, cache_len=8, max_new=0)
    with pytest.raises(ValueError, match="temperature"):
        EngineConfig(slots=1, cache_len=8, max_new=2, greedy=False,
                     temperature=0.0)


def test_device_defaults_to_cuda_and_raises_without_card():
    _, _, tm, tp = _setup()
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DecodeEngine(tm, tp, EngineConfig(slots=1, cache_len=8, max_new=2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate(tm, tp, {"tokens": torch.zeros((1, 3), dtype=torch.long)},
                 2, 8)


def test_decode_cost_model_matches_reference():
    from repro.energy import costs as jcosts
    from repro_torch.energy import costs as tcosts
    for name in ("JOULES_PER_FLOP", "JOULES_PER_BYTE_RADIO", "DEVICE_WATTS"):
        assert getattr(tcosts, name) == getattr(jcosts, name)
    pairs = [(tcosts.DecodeCostModel.from_params(2.5e9),
              jcosts.DecodeCostModel.from_params(2.5e9)),
             (tcosts.DecodeCostModel.from_microbench(3e-5, 2e-2, watts=700.0),
              jcosts.DecodeCostModel.from_microbench(3e-5, 2e-2, watts=700.0))]
    for got, want in pairs:
        for S, gen in ((2048, 32), (1, 1)):
            np.testing.assert_allclose(got.request_cost(S, gen),
                                       float(want.request_cost(S, gen)),
                                       rtol=1e-6)     # reference: fp32 math
    with pytest.raises(ValueError, match="seconds/token"):
        tcosts.DecodeCostModel.from_microbench(0.0, 1e-3)


def test_microbench_record_has_reference_fields():
    from repro_torch.serve.microbench import engine_microbench, measured_cost
    _, _, tm, tp = _setup()
    rec = engine_microbench(tm, tp, slots=2, prompt_len=8, gen=4, reps=1,
                            device="cpu")
    for key in ("prefill_ms", "insert_ms", "decode_step_ms", "prefill_tok_s",
                "decode_tok_s", "seconds_per_prefill_token",
                "seconds_per_decode_token", "device_watts",
                "joules_per_decode_token_measured",
                "joules_per_decode_token_analytic"):
        assert rec[key] > 0, key
    assert rec["device"] == "cpu"
    cost = measured_cost(rec, watts=2.0)
    assert cost.joules_per_decode_step == 2.0 * rec["seconds_per_decode_token"]


def test_ssm_microbench_prices_the_chunked_prefill():
    """The per-stage microbenchmark on mamba2-1.3b: a chunk-multiple prompt
    (the chunked scan), every stage timed, the SSM cache inserted."""
    from repro_torch.serve.microbench import engine_microbench
    _, _, tm, tp = _setup("mamba2-1.3b")
    rec = engine_microbench(tm, tp, slots=2, prompt_len=16, gen=4, reps=1,
                            device="cpu")
    assert rec["arch"] == "mamba2-1.3b" and rec["prompt_len"] == 16
    for key in ("prefill_ms", "insert_ms", "decode_step_ms",
                "joules_per_decode_token_measured"):
        assert rec[key] > 0, key


_MOE = {}


def _moe_setup(mode):
    """olmoe-1b-7b smoke in ``mode``: the params do not depend on it."""
    import dataclasses
    if "jp" not in _MOE:
        _MOE["jp"] = jax_model(jax_smoke("olmoe-1b-7b")).init_params(
            jax.random.PRNGKey(0))
        _MOE["tp"] = params_from_numpy(_MOE["jp"], device="cpu")
    jm = jax_model(dataclasses.replace(jax_smoke("olmoe-1b-7b"),
                                       moe_mode=mode))
    tm = get_model(dataclasses.replace(get_smoke_config("olmoe-1b-7b"),
                                       moe_mode=mode))
    return jm, _MOE["jp"], tm, _MOE["tp"]


@pytest.mark.parametrize("mode", ["dense", "dispatch", "sorted",
                                  "sorted_local"])
def test_moe_engine_identical_to_jax_engine(mode):
    """olmoe-1b-7b in each MoE mode, 3 slots, staggered mixed prompts: the
    greedy tokens equal the JAX engine's, which decodes each slot alone.
    The port decodes the slots in one batch; in ``sorted`` mode it routes
    each slot's row on its own, as a batch-1 decode does."""
    jm, jp, tm, tp = _moe_setup(mode)
    specs = [(12, 6), (16, 4), (12, 7), (16, 5)]     # two prefill shapes
    arrivals = [0, 0, 1, 4]
    kw = dict(slots=3, cache_len=16 + 7 + 1, max_new=7)
    prompts = [_prompt(S, 50 + i, 512) for i, (S, _) in enumerate(specs)]
    jdone = JaxEngine(jm, jp, JaxConfig(**kw)).run(
        [JaxRequest(rid=i, tokens=prompts[i], max_new=g)
         for i, (_, g) in enumerate(specs)], arrivals=arrivals)
    tdone = _engine(tm, tp, **kw).run(
        [Request(rid=i, tokens=prompts[i], max_new=g)
         for i, (_, g) in enumerate(specs)], arrivals=arrivals)
    assert set(tdone) == set(jdone) == set(range(len(specs)))
    for i, (S, g) in enumerate(specs):
        np.testing.assert_array_equal(tdone[i].tokens, jdone[i].tokens,
                                      err_msg=f"{mode} request {i}")
        assert tdone[i].slot == jdone[i].slot


def test_sorted_moe_decode_routes_each_slot_alone():
    """``moe_mode="sorted"``: one batched decode step of 3 slots equals each
    slot decoded alone (batch 1), even where a capacity shared by the 3
    slots' tokens would drop some."""
    _, _, tm, tp = _moe_setup("sorted")
    cache_len = 12
    rows = []
    for i, S in enumerate((5, 9, 7)):
        _, c = tm.prefill(tp, {"tokens": torch.tensor(
            _prompt(S, 60 + i, 512), dtype=torch.long)[None]},
            cache_len=cache_len)
        rows.append((S, c))
    cache = {n: torch.cat([c[n] for _, c in rows], dim=1) for n in ("k", "v")}
    tok = torch.tensor([3, 3, 3])           # one token: the same experts
    batched, _ = tm.decode_step(tp, tok, cache, torch.tensor([5, 9, 7]))
    for b, (S, c) in enumerate(rows):
        alone, _ = tm.decode_step(tp, tok[b:b + 1], c, S)
        torch.testing.assert_close(batched[b], alone[0], rtol=1e-5,
                                   atol=1e-5)


def test_vlm_engine_with_extras_identical_to_jax_engine():
    """internvl2-76b smoke: each request carries its own ``vision_embeds``
    (n_vis, d) through ``Request.extras``; the greedy tokens equal the JAX
    engine's, and differ from a run without them."""
    jm, jp, tm, tp = _setup("internvl2-76b")
    n_vis, d = tm.cfg.vision_tokens, tm.cfg.d_model
    specs = [(12, 5), (16, 6), (12, 4)]
    kw = dict(slots=2, cache_len=16 + 6 + 1, max_new=6)
    prompts = [_prompt(S, 70 + i, 512) for i, (S, _) in enumerate(specs)]
    vis = [np.random.default_rng(80 + i).standard_normal(
        (n_vis, d)).astype(np.float32) for i in range(len(specs))]
    jdone = JaxEngine(jm, jp, JaxConfig(**kw)).run(
        [JaxRequest(rid=i, tokens=prompts[i], max_new=g,
                    extras={"vision_embeds": vis[i]})
         for i, (_, g) in enumerate(specs)], arrivals=[0, 1, 2])
    tdone = _engine(tm, tp, **kw).run(
        [Request(rid=i, tokens=prompts[i], max_new=g,
                 extras={"vision_embeds": vis[i]})
         for i, (_, g) in enumerate(specs)], arrivals=[0, 1, 2])
    plain = _engine(tm, tp, **kw).run(
        [Request(rid=i, tokens=prompts[i], max_new=g)
         for i, (_, g) in enumerate(specs)], arrivals=[0, 1, 2])
    for i in range(len(specs)):
        np.testing.assert_array_equal(tdone[i].tokens, jdone[i].tokens,
                                      err_msg=f"request {i}")
    assert any((tdone[i].tokens != plain[i].tokens).any()
               for i in range(len(specs)))
