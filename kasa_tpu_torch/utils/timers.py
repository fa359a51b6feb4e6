"""The port's recorder: per-stage timers, spans and counters.

The reference's compile-time `#define TIME` prints per-phase ns
timings in the identify loop (Compare.hpp:2739-2846, 3085-3427); here a
process-wide registry accumulates wall time per named stage and every
mode prints its total ("OUT: Time: ..." main.cpp:684).

Besides those totals the recorder keeps spans and counters:

- a span records its name, its id, its parent's id (per thread, by
  nesting), the thread, the batch that was the thread's current one
  when it closed, and start and end from time.perf_counter_ns().  Every
  stage() is a span too, so the drive loop's stages parent the spans
  inside the batch API.  Finished spans are kept in memory, the newest
  SPAN_CAP of them, until someone reads them (finished, self_times,
  report).
- batch ids: a dispatcher takes one per batch from a process-wide
  counter (next_batch) and carries it in the batch's handle; fetching
  the handle makes it the consumer thread's current batch (set_batch).
- count(name, n) adds to the counter's process total and, while
  recording, to the innermost open span of the thread.

Recording is on only while a torch.profiler session is active or the
operator asked for --verbose (verbose()).  The profiler's state is read
at each batch boundary (next_batch, set_batch); while recording is off
a span site costs one check of the module global ON: no clock read, no
allocation, no record_function.  While a profiler session is active
each span is also a torch.profiler.record_function range, so a profile
with CPU activity shows the spans on its own timeline and, by its
correlation ids, which span launched each kernel.  to_trace_ns maps a
span's stamps to the realtime ns that the profiler gives device events.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import defaultdict, deque

import torch

SPAN_CAP = 1 << 18      # finished spans kept; the oldest are dropped

ON = False              # spans and per-span counts are being recorded
_VERBOSE = False
_ANCHOR: tuple | None = None    # (time_ns, perf_counter_ns), one reading

_ACC: dict[str, float] = defaultdict(float)
_COUNT: dict[str, int] = defaultdict(int)
_TOTALS: dict[str, int] = defaultdict(int)
_SPANS: deque = deque(maxlen=SPAN_CAP)
_SPAN_IDS = itertools.count(1)
_BATCH_IDS = itertools.count(1)
_TLS = threading.local()
_LOCK = threading.Lock()        # the totals take adds from several threads


def _profiling() -> bool:
    """A torch.profiler session is active, whatever its activities."""
    return bool(getattr(torch.autograd.profiler, "_is_profiler_enabled",
                        False)) or torch._C._autograd._profiler_enabled()


def _refresh() -> None:
    """Recording follows --verbose and the profiler; the clocks' pair
    for to_trace_ns is read as it turns on."""
    global ON, _ANCHOR
    on = _VERBOSE or _profiling()
    if on and not ON:
        _ANCHOR = (time.time_ns(), time.perf_counter_ns())
    ON = on


def verbose(on: bool = True) -> None:
    """The operator asked for --verbose (or no longer does)."""
    global _VERBOSE
    _VERBOSE = on
    _refresh()


def _stack() -> list:
    try:
        return _TLS.stack
    except AttributeError:
        _TLS.stack = []
        return _TLS.stack


# ---------------------------------------------------------------- batches

def next_batch() -> int:
    """A new batch id, made the calling thread's current batch (a
    dispatcher, as its batch starts)."""
    b = next(_BATCH_IDS)
    _TLS.batch = b
    _refresh()
    return b


def set_batch(b: int | None) -> None:
    """Make `b`, a handle's batch, the calling thread's current batch."""
    _TLS.batch = b
    _refresh()


def batch() -> int | None:
    """The calling thread's current batch."""
    return getattr(_TLS, "batch", None)


# ------------------------------------------------------------------ spans

class Span:
    """One span; t0 and t1 in perf_counter ns, `counts` the counters
    added while it was the thread's innermost open span."""

    __slots__ = ("name", "id", "parent", "thread", "batch", "t0", "t1",
                 "counts", "_rf")

    def __init__(self, name: str, rf):
        self.name = name
        self.counts = None
        self._rf = rf

    def __enter__(self):
        st = _stack()
        self.parent = st[-1].id if st else None
        self.id = next(_SPAN_IDS)
        self.thread = threading.get_ident()
        if self._rf is not None:
            self._rf.__enter__()
        st.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        _stack().pop()
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        self.batch = getattr(_TLS, "batch", None)
        _SPANS.append(self)
        return False

    @property
    def ns(self) -> int:
        return self.t1 - self.t0


class _Null:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def span(name: str):
    """A span named `name` (a context manager); while recording is off,
    the one shared no-op."""
    if not ON:
        return _NULL
    prof = _profiling()
    if not (prof or _VERBOSE):
        _refresh()              # the profiler has stopped
        return _NULL
    return Span(name,
                torch.autograd.profiler.record_function(name) if prof
                else None)


class _Stage:
    __slots__ = ("name", "t0", "sp")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.sp = span(self.name)
        self.sp.__enter__()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        with _LOCK:
            _ACC[self.name] += dt
            _COUNT[self.name] += 1
        self.sp.__exit__(*exc)
        return False


def stage(name: str) -> _Stage:
    """Accumulate wall time under `name` (nestable); a span as well
    while recording is on."""
    return _Stage(name)


# --------------------------------------------------------------- counters

def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name`: to its process total, and while
    recording to the thread's innermost open span."""
    with _LOCK:
        _TOTALS[name] += n
    if ON:
        st = getattr(_TLS, "stack", None)
        if st:
            sp = st[-1]
            if sp.counts is None:
                sp.counts = {}
            sp.counts[name] = sp.counts.get(name, 0) + n


def counter(name: str) -> int:
    """The process total of the counter `name` since the last reset."""
    return _TOTALS.get(name, 0)


# ---------------------------------------------------------------- readers

def finished(name: str | None = None, t0: float | None = None,
             t1: float | None = None) -> list:
    """The kept spans named `name` (None: all) that ended inside
    [t0, t1], in perf_counter seconds as time.perf_counter() gives them."""
    lo = float("-inf") if t0 is None else t0 * 1e9
    hi = float("inf") if t1 is None else t1 * 1e9
    return [s for s in list(_SPANS)
            if (name is None or s.name == name) and lo <= s.t1 <= hi]


def self_times(spans: list | None = None) -> dict:
    """{name: (self ns, spans)} over `spans` (the kept ones): a span's
    self time is its duration less its children's."""
    spans = list(_SPANS) if spans is None else spans
    inner: dict = defaultdict(int)
    for s in spans:
        if s.parent is not None:
            inner[s.parent] += s.ns
    out: dict = {}
    for s in spans:
        ns, n = out.get(s.name, (0, 0))
        out[s.name] = (ns + s.ns - inner.get(s.id, 0), n + 1)
    return out


def to_trace_ns(t_ns: int) -> int:
    """A span stamp (perf_counter ns) -> realtime ns, the clock of the
    profiler's device events, by the pair read when recording turned
    on (or now, if it never has)."""
    global _ANCHOR
    if _ANCHOR is None:
        _ANCHOR = (time.time_ns(), time.perf_counter_ns())
    return t_ns - _ANCHOR[1] + _ANCHOR[0]


def report(printer=print) -> dict[str, float]:
    """Print and return the per-stage totals, reference-style; then each
    counter's total and each span name's self time, where any were
    recorded."""
    for name in sorted(_ACC, key=_ACC.get, reverse=True):
        printer(f"OUT: Time {name}: {_ACC[name]:.6f} s ({_COUNT[name]}x)")
    for name in sorted(_TOTALS):
        printer(f"OUT: Count {name}: {_TOTALS[name]}")
    own = self_times()
    for name in sorted(own, key=lambda k: own[k][0], reverse=True):
        ns, n = own[name]
        printer(f"OUT: Self {name}: {ns / 1e9:.6f} s ({n}x)")
    return dict(_ACC)


def reset() -> None:
    """Forget the stage totals, the counters and the kept spans."""
    _ACC.clear()
    _COUNT.clear()
    _TOTALS.clear()
    _SPANS.clear()
