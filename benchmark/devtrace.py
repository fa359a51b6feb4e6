"""The device trace of a window (torch.profiler, CUDA activity only) and
its reduction: device busy time, time by kernel name, idle gaps named by
the benchmark's host spans that ran across them."""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np


@dataclass
class Trace:
    busy_s: float           # union of device operations inside the window
    window_s: float         # the window's length
    device_s: float         # sum of every device operation's time
    kernel_s: float         # the same, kernels alone (no copy or set)
    batches: int            # batches whose work the trace holds
    device_ops: list        # [name, seconds], the 10 that took most time
    idle_gaps: list         # [host spans, seconds], the 10 longest gaps
    ops: int                # device operations traced
    aligned: float          # share of dispatch spans holding an H2D copy


class Tracer:
    """torch.profiler over the card, started before the window and
    stopped after the drain.  Event times are on the realtime clock;
    the host spans are perf_counter seconds, mapped by one pair of
    readings taken at start."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])

    def start(self):
        self.prof.start()
        self.rt0, self.pc0 = time.time_ns(), time.perf_counter_ns()

    def stop(self):
        import torch
        torch.cuda.synchronize()
        self.prof.stop()

    def to_ns(self, t: float) -> float:
        """perf_counter seconds -> realtime ns."""
        return t * 1e9 + (self.rt0 - self.pc0)

    def device_events(self) -> list:
        """(name, start ns, duration ns) of every kernel, copy and set."""
        out = []
        for ev in self.prof.profiler.kineto_results.events():
            if "CUDA" not in str(ev.device_type()):
                continue
            out.append((ev.name(), ev.start_ns(), ev.duration_ns()))
        return out


def is_copy(name: str) -> bool:
    """A copy or a set (the profiler's "Memcpy ..." and "Memset ..."
    activities), not a kernel."""
    return name.startswith(("Memcpy", "Memset"))


def _union(iv: np.ndarray) -> np.ndarray:
    """Sorted, merged intervals of (n, 2) [start, end)."""
    if len(iv) == 0:
        return iv
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    end = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), bool)
    new[1:] = iv[1:, 0] > end[:-1]
    starts = iv[new, 0]
    ends = np.maximum.reduceat(iv[:, 1], np.nonzero(new)[0])
    return np.stack([starts, ends], 1)


def host_spans(win) -> dict:
    """The benchmark's spans by thread: producer (dispatch, queue wait,
    flush) and consumer (fetch wait, decode, recompute), as perf_counter
    (start, end, name)."""
    prod, cons = [], []
    for r in win.records:
        prod.append((r.t_dispatch0, r.t_dispatch1, "dispatch"))
        if r.t_queued:
            prod.append((r.t_dispatch1, r.t_queued, "queue"))
        if r.t_done:
            cons.append((r.t_fetch0, r.t_fetched, "fetch_wait"))
            cons.append((r.t_fetched, r.t_decoded, "decode"))
            if r.t_done > r.t_decoded:
                cons.append((r.t_decoded, r.t_done,
                             "recompute" if r.recomputed else "decode"))
    prod += [(a, b, "flush") for a, b in win.flushes]
    return dict(producer=sorted(prod), consumer=sorted(cons))


def _label(spans: list, t: float) -> str:
    starts = [s[0] for s in spans]
    i = np.searchsorted(starts, t, side="right") - 1
    if i >= 0 and spans[i][0] <= t < spans[i][1]:
        return spans[i][2]
    return "idle"


def reduce(tracer: Tracer, win) -> Trace:
    ev = tracer.device_events()
    lo, hi = tracer.to_ns(win.t0), tracer.to_ns(win.t_close)
    if ev:
        iv = np.array([(s, s + d) for _, s, d in ev], np.float64)
    else:
        iv = np.zeros((0, 2))
    u = _union(iv)
    clipped = np.clip(u, lo, hi)
    busy_ns = float(np.sum(clipped[:, 1] - clipped[:, 0])) if len(u) else 0.0
    by_name: dict = {}
    for name, s, d in ev:
        if s + d > lo and s < hi:
            by_name[name] = by_name.get(name, 0.0) \
                + (min(s + d, hi) - max(s, lo)) / 1e9
    ops = sorted(([n[:120], v] for n, v in by_name.items()),
                 key=lambda x: -x[1])[:10]
    # idle gaps inside the window, named by what each host thread did
    # at the gap's middle
    edges = np.concatenate([[lo], clipped.reshape(-1), [hi]]) if len(u) \
        else np.array([lo, hi])
    gaps = edges.reshape(-1, 2)
    gaps = gaps[gaps[:, 1] > gaps[:, 0]]
    spans = host_spans(win)
    named = []
    for a, b in gaps[np.argsort(gaps[:, 0] - gaps[:, 1])][:10]:
        mid = ((a + b) / 2 - (tracer.rt0 - tracer.pc0)) / 1e9
        named.append([f"producer:{_label(spans['producer'], mid)} "
                      f"consumer:{_label(spans['consumer'], mid)}",
                      (b - a) / 1e9])
    # the clocks agree where each dispatch's synchronous H2D copy of its
    # matrix starts inside the dispatch span
    h2d = np.sort([s for n, s, _ in ev if "HtoD" in n])
    spans_ns = np.array([(tracer.to_ns(r.t_dispatch0),
                          tracer.to_ns(r.t_dispatch1)) for r in win.records])
    aligned = 0.0
    if len(h2d) and len(spans_ns):
        at = np.searchsorted(h2d, spans_ns[:, 0])
        inside = (at < len(h2d)) & (h2d[np.minimum(at, len(h2d) - 1)]
                                    <= spans_ns[:, 1])
        aligned = float(inside.mean())
    return Trace(busy_ns / 1e9, (hi - lo) / 1e9,
                 float(sum(d for _, _, d in ev)) / 1e9,
                 float(sum(d for n, _, d in ev if not is_copy(n))) / 1e9,
                 len(win.records), ops, named, len(ev), aligned)
