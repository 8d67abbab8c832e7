"""Phase timers, counters and device-trace hooks.

The reference has no observability beyond stderr dots (SURVEY §5); this is
the framework-level replacement:

* :func:`phase` — context manager accumulating wall time per named phase
  (nested phases attribute to the innermost name only when exclusive=True).
* :func:`count` — named counters (reads aligned, batches dispatched, host
  fallbacks, device entries...).
* :func:`report` — one JSON object with phases, counters and totals; the
  mia CLI prints it to stderr under ``--profile``.
* :func:`device_trace` — wraps a region in ``torch.profiler`` trace
  collection when MIA_TORCH_TRACE_DIR is set (a Chrome trace, for
  chrome://tracing or Perfetto).

Zero overhead when disabled: ``enable()`` must be called first; every hook
checks one module flag.
"""
from __future__ import annotations

import json
import os
import sys
import time
from contextlib import contextmanager

_enabled = False
_phases: dict[str, float] = {}
_counts: dict[str, int] = {}
_t0 = 0.0


def enable() -> None:
    global _enabled, _t0
    _enabled = True
    _t0 = time.time()
    _phases.clear()
    _counts.clear()


def enabled() -> bool:
    return _enabled


@contextmanager
def phase(name: str):
    """Accumulate wall time under ``name`` (no-op when disabled)."""
    if not _enabled:
        yield
        return
    t0 = time.time()
    try:
        yield
    finally:
        _phases[name] = _phases.get(name, 0.0) + (time.time() - t0)


def add_time(name: str, seconds: float) -> None:
    """Accumulate an externally measured duration (no-op when disabled)."""
    if _enabled:
        _phases[name] = _phases.get(name, 0.0) + seconds


def count(name: str, n: int = 1) -> None:
    if _enabled:
        _counts[name] = _counts.get(name, 0) + n


@contextmanager
def device_trace():
    """Collect a ``torch.profiler`` trace of the wrapped region (host
    activity, and the card's kernels and copies when there is one) when
    MIA_TORCH_TRACE_DIR is set; writes ``mia_trace_<pid>.json`` there."""
    trace_dir = os.environ.get("MIA_TORCH_TRACE_DIR")
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, f"mia_trace_{os.getpid()}.json"))


def report(out=None) -> dict:
    """Emit the collected profile as one JSON line (stderr by default)."""
    rep = {
        "total_s": round(time.time() - _t0, 3),
        "phases_s": {k: round(v, 3) for k, v in sorted(_phases.items())},
        "counters": dict(sorted(_counts.items())),
    }
    if _enabled:
        print("MIA_PROFILE " + json.dumps(rep), file=out or sys.stderr)
    return rep
