"""Structured per-stage timers.

The reference's compile-time `#define TIME` prints per-phase ns
timings in the identify loop (Compare.hpp:2739-2846, 3085-3427); here a
process-wide registry accumulates wall time per named stage and every
mode prints its total ("OUT: Time: ..." main.cpp:684).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

_ACC: dict[str, float] = defaultdict(float)
_COUNT: dict[str, int] = defaultdict(int)


@contextlib.contextmanager
def stage(name: str):
    """Accumulate wall time under `name` (nestable)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _ACC[name] += time.perf_counter() - t0
        _COUNT[name] += 1


def report(printer=print) -> dict[str, float]:
    """Print and return the per-stage totals, reference-style."""
    for name in sorted(_ACC, key=_ACC.get, reverse=True):
        printer(f"OUT: Time {name}: {_ACC[name]:.6f} s ({_COUNT[name]}x)")
    return dict(_ACC)


def reset() -> None:
    _ACC.clear()
    _COUNT.clear()
