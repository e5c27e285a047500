"""Continuous-batching decode engine over a slotted KV cache (port of the JAX
package's ``serve/engine.py``).

The lifecycle is the reference's:

* a free-slot allocator (slot 0 first);
* ``prefill_request`` prefills one request and writes its cache into a free
  slot *between* decode steps, overwriting the slot's whole ``cache_len``
  slice, so a reclaimed slot's stale keys/values never reach a new request;
* ``generate_step`` advances every slot one token, each at its own absolute
  position.  Inactive slots decode too (fixed shapes), but their token is
  held and their output row untouched;
* a ``max_new == 1`` request finishes on its prefill;
* reclaim fetches the finished row to the host before freeing the slot.

Where the reference ``vmap``s a scalar-position decode over slots, the port
runs one batched ``decode_step`` with a per-slot position vector (B,); the
results are the same.  The decode writes the cache in place.  Greedy picks
``argmax`` (the first index on ties, as ``jnp.argmax``).  Sampling draws
Gumbel noise from a per-slot ``torch.Generator``; it cannot reproduce JAX's
bits, only its distribution.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any

import numpy as np
import torch

from repro_torch.device import require_same_device, resolve_device
from repro_torch.tree import tree_leaves


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static engine shape."""

    slots: int                      # running-batch width (cache rows)
    cache_len: int                  # KV/ring cache length per slot
    max_new: int                    # output-buffer capacity per request
    ring: bool = False              # sliding-window ring cache writes
    window: int | None = None       # attention window (None = cfg default)
    greedy: bool = True             # argmax vs temperature sampling
    temperature: float = 1.0

    def __post_init__(self):
        if self.slots < 1:
            raise ValueError(f"need at least one slot (got {self.slots})")
        if self.max_new < 1:
            raise ValueError(f"max_new must be >= 1 (got {self.max_new})")
        if not self.greedy and not self.temperature > 0.0:
            raise ValueError(
                f"temperature must be > 0 for sampling "
                f"(got {self.temperature}); use greedy=True for argmax")


@dataclasses.dataclass(frozen=True)
class Request:
    """One decode request: a prompt and a generation budget."""

    rid: Any                        # caller's request id (dict key of result)
    tokens: Any                     # (S,) int prompt tokens
    max_new: int                    # tokens to generate (incl. the prefill's)
    extras: dict | None = None      # modality extras, unbatched (e.g.
    #                                 vision_embeds (n_vis, d), frames
    #                                 (encoder_seq, d)); prefill only


@dataclasses.dataclass(frozen=True)
class Finished:
    """A completed request: exactly ``max_new`` generated tokens."""

    rid: Any
    tokens: np.ndarray              # (max_new,) int32 generated tokens
    prompt_len: int
    slot: int                       # which slot served it (reclaim telemetry)


def pick_tokens(logits, greedy: bool, temperature: float, generators):
    """Next tokens from (n, V) fp32 logits.  Greedy: ``argmax``.  Sampled:
    ``argmax(logits / T + Gumbel noise)``, row i's noise drawn from
    ``generators[i]`` (a categorical draw from ``softmax(logits / T)``)."""
    if greedy:
        return logits.argmax(-1)
    tiny = torch.finfo(torch.float32).tiny
    u = torch.stack([torch.rand(logits.shape[-1], generator=g,
                                device=logits.device) for g in generators])
    gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
    return (logits / temperature + gumbel).argmax(-1)


class DecodeEngine:
    """Continuous-batching decode over a slotted cache.

    Host-side lifecycle state (positions, generation counts, the allocator)
    lives in numpy; device state (the slotted cache, last tokens, output
    buffer, per-slot generators) lives on ``device``.  Drive loop::

        engine = DecodeEngine(model, params, EngineConfig(...))
        done = engine.run(requests, arrivals=[0, 0, 3, 5])   # staggered
        done[rid].tokens                                      # (max_new,)

    ``params`` must already be on ``device`` (default ``"cuda"``, which
    raises without a card).
    """

    def __init__(self, model, params, config: EngineConfig,
                 rng: torch.Generator | None = None, device="cuda"):
        if model.decode_step is None:
            raise ValueError(f"{model.cfg.name} has no decode path")
        self.device = resolve_device(device)
        require_same_device(params["embed"]["tok"], self.device, "params")
        self.model, self.params, self.config = model, params, config
        self.reset(rng)

    # ------------------------------------------------------------ state ----
    def reset(self, rng: torch.Generator | None = None):
        """Fresh engine state; ``rng`` seeds each admitted request's
        sampling generator (default: seed 0)."""
        cfg, slots, dev = self.config, self.config.slots, self.device
        if rng is None:
            rng = torch.Generator(device=dev).manual_seed(0)
        self._rng = rng
        self._cache = self.model.init_cache(slots, cfg.cache_len, device=dev)
        self._tok = torch.zeros(slots, dtype=torch.long, device=dev)
        self._out = torch.zeros((slots, cfg.max_new), dtype=torch.long,
                                device=dev)
        self._gens = [torch.Generator(device=dev).manual_seed(i)
                      for i in range(slots)]
        self._pos = np.zeros(slots, np.int64)      # abs pos of the fed token
        self._gen = np.zeros(slots, np.int64)      # tokens produced so far
        self._want = np.zeros(slots, np.int64)     # tokens requested
        self._active = np.zeros(slots, bool)
        self._rid = [None] * slots
        self._free = list(range(slots - 1, -1, -1))   # pop() -> slot 0 first
        self._finished: list[Finished] = []
        self.stats = {"inserts": 0, "steps": 0, "slot_steps": 0,
                      "idle_steps": 0}

    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def active_count(self) -> int:
        return int(self._active.sum())

    # ------------------------------------------------------------ stages ---
    def _prefill(self, batch):
        """A batch-1 prompt {tokens (1, S), extras (1, ...)} -> ((1, V)
        logits, the request's cache)."""
        logits, pcache = self.model.prefill(
            self.params, batch, cache_len=self.config.cache_len,
            window=self.config.window)
        return (logits[:, -1] if logits.dim() == 3 else logits), pcache

    def _new_generator(self) -> torch.Generator:
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=self._rng,
                                 device=self._rng.device))
        return torch.Generator(device=self.device).manual_seed(seed)

    def _insert(self, pcache, first_tok, slot: int):
        """Write a prefilled request into ``slot``: its whole cache slice
        (every leaf of the cache tree, slots on axis 1), its last token,
        and an output row holding only the first token."""
        for c, p in zip(tree_leaves(self._cache), tree_leaves(pcache)):
            c[:, slot] = p[:, 0]
        self._tok[slot] = first_tok
        self._out[slot] = 0
        self._out[slot, 0] = first_tok

    def _step(self, pos, active, gen_idx):
        """Advance every slot one token (device tensors pos, active,
        gen_idx of shape (slots,))."""
        cfg = self.config
        logits, self._cache = self.model.decode_step(
            self.params, self._tok, self._cache, pos, ring=cfg.ring,
            window=cfg.window)
        nxt = pick_tokens(logits, cfg.greedy, cfg.temperature, self._gens)
        nxt = torch.where(active, nxt, self._tok)
        row = torch.arange(cfg.slots, device=self.device)
        idx = gen_idx.clamp(0, cfg.max_new - 1)
        self._out[row, idx] = torch.where(active, nxt, self._out[row, idx])
        self._tok = nxt

    def _host_vector(self, a: np.ndarray):
        # torch.tensor copies: torch.as_tensor would alias the numpy buffer
        # on the CPU, and the host updates it right after the step
        return torch.tensor(a, device=self.device)

    # -------------------------------------------------------- lifecycle ----
    def prefill_request(self, request: Request) -> int:
        """Prefill a request and insert it into a free slot (between steps).

        Returns the slot index.  Raises if no slot is free.  A
        ``max_new == 1`` request finishes immediately: its only token comes
        from the prefill itself.
        """
        if not self._free:
            raise RuntimeError(
                f"no free slot (all {self.config.slots} busy); "
                f"call generate_step until one is reclaimed")
        cfg = self.config
        tokens = np.asarray(request.tokens)
        if tokens.ndim == 2:
            tokens = tokens[0]
        S = int(tokens.shape[0])
        if not 1 <= request.max_new <= cfg.max_new:
            raise ValueError(f"max_new={request.max_new} outside "
                             f"[1, {cfg.max_new}] (the engine's out-buffer "
                             f"capacity)")
        if not cfg.ring and S + request.max_new > cfg.cache_len:
            raise ValueError(
                f"prompt ({S}) + max_new ({request.max_new}) exceeds "
                f"cache_len ({cfg.cache_len}) for a non-ring cache")

        batch = {"tokens": torch.tensor(tokens, dtype=torch.long,
                                        device=self.device)[None]}
        for k, v in (request.extras or {}).items():
            batch[k] = torch.as_tensor(v, device=self.device)[None]
        logits, pcache = self._prefill(batch)
        gen = self._new_generator()
        first = pick_tokens(logits, cfg.greedy, cfg.temperature, [gen])[0]

        slot = self._free.pop()
        self._insert(pcache, first, slot)
        self._gens[slot] = gen
        self._pos[slot] = S
        self._gen[slot] = 1
        self._want[slot] = request.max_new
        self._active[slot] = True
        self._rid[slot] = request.rid
        self.stats["inserts"] += 1
        if request.max_new == 1:        # prefill already produced everything
            self._reclaim(slot)
        return slot

    def generate_step(self) -> list[Finished]:
        """One decode step for every active slot; reclaim the ones that hit
        their generation budget.  Returns the requests finished by this step
        (plus any ``max_new == 1`` completions queued since the last call).
        """
        if not self._active.any():
            self.stats["idle_steps"] += 1
            return self._pop_finished()
        self._step(self._host_vector(self._pos),
                   self._host_vector(self._active),
                   self._host_vector(self._gen))
        self.stats["steps"] += 1
        self.stats["slot_steps"] += int(self._active.sum())
        self._gen[self._active] += 1
        self._pos[self._active] += 1
        for slot in np.nonzero(self._active & (self._gen >= self._want))[0]:
            self._reclaim(int(slot))
        return self._pop_finished()

    def run(self, requests, arrivals=None) -> dict:
        """Drive a workload to completion: admit arrivals into free slots
        between steps, advance the running batch, reclaim finished slots.

        ``arrivals`` gives each request's arrival step (default: all at 0 —
        admitted as slots allow).  Returns ``{rid: Finished}``.
        """
        if arrivals is None:
            arrivals = [0] * len(requests)
        if len(arrivals) != len(requests):
            raise ValueError(f"{len(arrivals)} arrival steps for "
                             f"{len(requests)} requests")
        pending = deque(sorted(zip(arrivals, range(len(requests)), requests),
                               key=lambda t: t[:2]))
        done: dict = {}
        t = 0
        while pending or self._active.any():
            while pending and pending[0][0] <= t and self._free:
                self.prefill_request(pending.popleft()[2])
            for f in self.generate_step():
                done[f.rid] = f
            t += 1
        for f in self._pop_finished():
            done[f.rid] = f
        return done

    # --------------------------------------------------------- internal ----
    def _reclaim(self, slot: int):
        """Fetch the finished request's tokens and free its slot.  The fetch
        happens BEFORE the slot re-enters the allocator, so the next
        occupant's insert can't overwrite an uncollected output row."""
        want = int(self._want[slot])
        toks = self._out[slot, :want].cpu().numpy().astype(np.int32)
        self._finished.append(Finished(rid=self._rid[slot], tokens=toks,
                                       prompt_len=int(self._pos[slot])
                                       - int(self._gen[slot]) + 1,
                                       slot=slot))
        self._active[slot] = False
        self._rid[slot] = None
        self._gen[slot] = 0
        self._want[slot] = 0
        self._free.append(slot)

    def _pop_finished(self) -> list[Finished]:
        out, self._finished = self._finished, []
        return out
