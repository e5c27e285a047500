"""Span timers, profiler wiring and the retrace sentinel (port of the JAX
package's ``obs/profile.py``).

`span` times a named region on the host clock, opens a
``torch.profiler.record_function`` of the same name (and an NVTX range
once CUDA is in use), so the names line up in a captured trace, and emits
a ``span`` event when an `Obs` is attached.  Module-level totals
(`span_totals`) are kept without any log.  A host clock around queued
launches times their dispatch: a span that should cover the device's work
pulls its result to the host inside it.

`annotate` is `span` as a decorator; `profiler_trace` captures a
``torch.profiler`` trace of CPU and CUDA activity into a directory as a
Chrome trace.

`RetraceSentinel` keeps the reference's ``snapshot`` / ``check`` contract.
The port has no jit caches: what it watches by default is the number of
kernel libraries loaded (``kernels.build.load``'s cache), so a kernel
built or loaded in the middle of a run, the port's recompile, logs a
``retrace_warning`` event.
"""
from __future__ import annotations

import contextlib
import functools
import logging
import os
import time
from typing import Callable

import torch

logger = logging.getLogger("repro_torch.obs")

# name -> [count, total_ms]
_SPAN_TOTALS: dict[str, list] = {}


def span_totals() -> dict[str, dict]:
    """Accumulated span timings since the last `reset_spans`."""
    return {k: {"count": v[0], "total_ms": round(v[1], 3)}
            for k, v in _SPAN_TOTALS.items()}


def reset_spans() -> None:
    _SPAN_TOTALS.clear()


def _annotations(name: str) -> contextlib.ExitStack:
    """The profiler annotations of a span; whatever fails to open is left
    out (instrumentation never raises)."""
    stack = contextlib.ExitStack()
    try:
        stack.enter_context(torch.profiler.record_function(name))
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            stack.enter_context(torch.cuda.nvtx.range(name))
    except Exception:                                    # pragma: no cover
        pass
    return stack


@contextlib.contextmanager
def span(name: str, obs=None):
    """``with span("fleet_chunk"):`` — host wall time and a profiler
    annotation.  Folds into `span_totals` and emits ``{"kind": "span",
    "name": ..., "ms": ...}`` to ``obs`` (when given) on a normal exit."""
    stack = _annotations(name)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        try:
            stack.close()
        except Exception:                                # pragma: no cover
            pass
    ms = (time.perf_counter() - t0) * 1e3
    agg = _SPAN_TOTALS.setdefault(name, [0, 0.0])
    agg[0] += 1
    agg[1] += ms
    if obs is not None:
        obs.event("span", name=name, ms=round(ms, 3))


def annotate(name: str) -> Callable:
    """Decorator: every call of the function is a `span` named ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


@contextlib.contextmanager
def profiler_trace(log_dir: str | None):
    """A ``torch.profiler`` capture (CPU, and CUDA where there is a card)
    over the region, exported as a Chrome trace into ``log_dir``; ``None``
    is a no-op, so an optional ``--profile-dir`` threads straight in."""
    if not log_dir:
        yield
        return
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


def _default_watch() -> dict[str, Callable[[], int]]:
    """The kernel libraries loaded so far (built on first use)."""
    from repro_torch.kernels import build
    return {"kernel_libraries": lambda: build.load.cache_info().currsize}


class RetraceSentinel:
    """Watches counters between `snapshot` and `check` calls.

    >>> sentinel = RetraceSentinel(obs)
    >>> sentinel.snapshot()          # after the warm-up chunk
    >>> ...                          # more chunks
    >>> sentinel.check()             # [] if nothing grew, else warns

    ``check(expect=k)`` tolerates ``k`` new entries; anything beyond logs a
    ``retrace_warning`` event and a `logging` warning per grown counter and
    re-snapshots, so one regression is reported once.
    """

    def __init__(self, obs=None,
                 watch: dict[str, Callable[[], int]] | None = None):
        self.obs = obs
        self.watch = _default_watch() if watch is None else dict(watch)
        self._base: dict[str, int] | None = None

    def sizes(self) -> dict[str, int]:
        return {name: int(size()) for name, size in self.watch.items()}

    def snapshot(self) -> dict[str, int]:
        self._base = self.sizes()
        return dict(self._base)

    def check(self, expect: int = 0, context: str = "") -> list[dict]:
        """Compare against the last snapshot; returns the offending deltas
        (empty: nothing grew)."""
        if self._base is None:
            self.snapshot()
            return []
        grown = []
        now = self.sizes()
        for name, size in now.items():
            delta = size - self._base.get(name, size)
            if delta > expect:
                grown.append({"fn": name, "delta": delta, "size": size,
                              "context": context})
                logger.warning(
                    "unexpected retrace: %s grew by %d%s (a kernel built or "
                    "loaded in the middle of a run)", name, delta,
                    f" during {context}" if context else "")
                if self.obs is not None:
                    self.obs.event("retrace_warning", **grown[-1])
        self._base = now
        return grown
