"""The plain reference agrees with the port's CPU path on a tiny corpus
of each configuration, through the whole run, host recompute included."""

import time

import numpy as np
import pytest

from benchmark import compare, harness, reference, runner
from benchmark.tests import tiny


def test_run_is_correct_against_the_reference(session):
    res, lines = runner.run_cell(session.cell, 2**31 + 99, 0.5, False,
                                 "cpu", time.perf_counter(),
                                 lambda m: None, session=session)
    assert res["correct"], lines
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checked"
    # no device peak on the CPU
    assert set(res["metrics"]) == {"reads_per_s", "setup_s"}
    assert len(lines) == len(compare.NAMES)


def test_host_recompute_path_is_correct(session, monkeypatch):
    """Budgets cut to nothing flag every read; the recompute rebuilds
    every list and adds the count-overflow reads to the profile."""
    from kasa_tpu_torch.match import turbo
    monkeypatch.setattr(turbo, "batch_budgets",
                        lambda *a, **k: (64, 64, 4))
    ring = session.draw(31)
    if not hasattr(session, "disp"):
        session.load()
    batches = session.assemble(ring, 31)
    win = session.window(batches, count=len(batches) + 1)
    assert sum(r.recomputed for r in win.records) > 0
    ref = compare.Reference(session.index_path, session.cfg,
                            session.traffic, batches, "cpu")
    numbers, _ = compare.check_window(ref, win)
    assert compare.verdict(numbers, session.cell.limits), numbers


def test_reference_hits_are_not_trivial(session):
    ring = session.draw(5)
    if not hasattr(session, "disp"):
        session.load()
    batches = session.assemble(ring, 5)
    idx = reference.Index(session.index_path, session.cfg["k_low"],
                          session.cfg["k_high"], "cpu")
    bh = reference.BatchHits(idx, batches[0].mates, session.traffic["six"],
                             session.traffic["unique"])
    sc = reference.read_scores(idx, bh, np.arange(batches[0].reads))
    hits = [len(t) for t, _ in reference.answers_of(sc)]
    assert min(hits) >= 1 and max(hits) > 1
    # the longest read of the ring is among the compared ones
    lens = [sum(np.diff(o) for _, o in b.mates) for b in batches]
    longest = max(x.max() for x in lens)
    assert any(lens[b.idx][b.sample].max() == longest for b in batches)


def test_unique_counts_each_window_once():
    """-e: a read made of one window repeated counts it once."""
    cell = tiny.cell("dense2k.long_e")
    assert cell.traffic["unique"]
    blob = np.frombuffer(b"ACG" * 40, np.uint8)
    offs = np.array([0, len(blob)])
    _, offs_l, reads = reference.batch_lines([(blob, offs)], False)
    parts = list(reference.windows(blob, offs_l, reads, 12, 7, True, "cpu"))
    words, valid, read = parts[0]
    # three frames of a period-3 read: one full window each, plus the
    # distinct windows that reach past the read's end
    assert len(read) == len(set(zip(*[w.tolist() for w in words])))
    assert harness.forbidden_modules(["x"]) == []


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["dense2k.long_e", "wide2k.pe150_six"])
def test_tiny_cell_on_the_card(card, name, tmp_path):
    """The kernels' path at the tiny size, traced: correct, and every
    per-layer metric read."""
    sess = tiny.session(name, str(tmp_path), device="cuda")
    res, lines = runner.run_cell(sess.cell, 5, 1.0, True, "cuda",
                                 time.perf_counter(), lambda m: None,
                                 session=sess)
    assert res["correct"], lines
    assert res["device"]["busy_s"] > 0
    assert {"dispatch_ms", "decode_ms", "step_device_ms", "tables_gib",
            "device_idle_pct"} <= set(res["metrics"])
