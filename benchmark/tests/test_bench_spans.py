"""The six per-layer metrics that read the port's recorder: their values
on a synthetic recorder, their silence without one, a CPU window under
the profiler, and the traced tiny cell on the card."""

import time
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import harness, runner
from benchmark.tests import tiny

NAMES = ("h2d_ms", "fetch_wait_ms", "readback_ms", "readback_mib",
         "csr_overflow_pct", "launches_per_batch")
MS = 1_000_000


@pytest.fixture
def recorder():
    from kasa_tpu_torch.utils import timers
    timers.verbose(False)
    timers.reset()
    yield timers
    timers.verbose(False)
    timers.reset()


def _span(timers, name, sid, parent, batch, t0_ms, t1_ms, **counts):
    s = timers.Span(name, None)
    s.id, s.parent, s.batch, s.thread = sid, parent, batch, 1
    s.t0, s.t1 = int(t0_ms * MS), int(t1_ms * MS)
    s.counts = {k.replace("_", "."): v for k, v in counts.items()} or None
    timers._SPANS.append(s)
    return s


def _batch(timers, b, at, overflow):
    """Batch b's spans from `at` ms: dispatch 30 ms (h2d 2, step 20 with
    7 launches), fetch 1, decode 100 (lists 60 where the CSR overflowed;
    readback 1 MiB packed, 128 MiB more with the lists)."""
    sid = 100 * b
    d = _span(timers, "dispatch", sid, None, b, at, at + 30)
    _span(timers, "dispatch.h2d", sid + 1, d.id, b, at, at + 2,
          h2d_bytes=5)
    _span(timers, "dispatch.step", sid + 2, d.id, b, at + 2, at + 22,
          launches=7)
    _span(timers, "fetch", sid + 3, None, b, at + 40, at + 41)
    dec = _span(timers, "decode", sid + 4, None, b, at + 41, at + 141,
                readback_bytes=(129 if overflow else 1) << 20,
                csr_overflow=int(overflow))
    if overflow:
        _span(timers, "decode.lists", sid + 5, dec.id, b, at + 50, at + 110)


def _run(t0_ms, t1_ms):
    return SimpleNamespace(t0=t0_ms / 1e3, t_close=t1_ms / 1e3)


def test_readers_on_a_synthetic_recorder(recorder):
    _batch(recorder, 1, 1000, True)
    _batch(recorder, 2, 1200, False)
    _batch(recorder, 3, 1400, True)
    _batch(recorder, 4, 1600, True)     # its decode ends after the window
    # the window holds batches 2 and 3 whole, batch 4's dispatch and
    # fetch; batch 1's decode ends before it
    got = {n: harness.metric_reader(n)(_run(1150, 1700)) for n in NAMES}
    assert got["h2d_ms"] == pytest.approx(2.0)
    assert got["fetch_wait_ms"] == pytest.approx(1.0)
    assert got["readback_ms"] == pytest.approx(30.0)      # (0 + 60) / 2
    assert got["readback_mib"] == pytest.approx(65.0)     # (1 + 129) / 2
    assert got["csr_overflow_pct"] == pytest.approx(50.0)
    assert got["launches_per_batch"] == pytest.approx(7.0)


def test_readers_are_silent_without_spans(recorder, monkeypatch):
    run = _run(0, 1e9)
    assert all(harness.metric_reader(n)(run) is None for n in NAMES)
    _batch(recorder, 1, 1000, True)
    # a recorder without spans (the port before them) reads nothing
    monkeypatch.delattr(recorder, "finished")
    assert all(harness.metric_reader(n)(run) is None for n in NAMES)


def test_cpu_window_under_the_profiler(session, recorder):
    """A window of the tiny cell on the CPU with a profiler session
    open: the recorder is on for it, and every reader reads."""
    from torch.profiler import ProfilerActivity, profile
    ring = session.draw(3)
    if not hasattr(session, "disp"):
        session.load()
    batches = session.assemble(ring, 3)
    session.window(batches, count=len(batches))
    assert recorder.finished() == []        # the untraced warm-up
    with profile(activities=[ProfilerActivity.CPU]):
        win = session.window(batches, count=2 * len(batches))
    run = SimpleNamespace(t0=win.t0, t_close=time.perf_counter(),
                          records=win.records)
    got = {n: harness.metric_reader(n)(run) for n in NAMES}
    assert all(v is not None for v in got.values()), got
    assert got["launches_per_batch"] == 0       # plain versions
    assert 0 <= got["csr_overflow_pct"] <= 100
    packed = min(4 * (2 * b.rows_pad + 2 * b.cap + 4) for b in batches)
    assert got["readback_mib"] >= packed / 2**20
    decoded = [r for r in win.records if r.t_done]
    assert len(recorder.finished("decode")) == len(decoded)
    # the recorder's dispatch spans against the benchmark's own stamps
    own = np.mean([r.t_dispatch1 - r.t_dispatch0 for r in win.records])
    spans = np.mean([s.ns for s in recorder.finished("dispatch")]) / 1e9
    assert spans <= own


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_tiny_cell_traced_reads_the_recorder(card, tmp_path, recorder):
    """The traced tiny long-read cell on the card: the six metrics read
    beside the benchmark's own, and the run stays correct."""
    sess = tiny.session("dense2k.long_e", str(tmp_path), device="cuda")
    res, lines = runner.run_cell(sess.cell, 5, 1.0, True, "cuda",
                                 time.perf_counter(), lambda m: None,
                                 session=sess)
    assert res["correct"], lines
    assert set(NAMES) <= set(res["metrics"]), res["metrics"]
    assert res["metrics"]["launches_per_batch"]["value"] >= 6
