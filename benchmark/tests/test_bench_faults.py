"""The check fails what it has to fail: the control (the reference in
bfloat16, below the float32 the configurations state) and a whole run
with the timed path broken underneath, on the tiny cells (the harness's
look for a card skipped, the port's CPU path under it).

The cells run on one card, so no exchange between cards can be left
out."""

import time

import numpy as np
import torch

from benchmark import compare, runner


def _run(session, seed=2**31 + 7):
    return runner.run_cell(session.cell, seed, 0.3, False, "cpu",
                           time.perf_counter(), lambda m: None,
                           session=session)


def test_control_comes_out_not_correct(session):
    ring = session.draw(11)
    if not hasattr(session, "disp"):
        session.load()
    batches = session.assemble(ring, 11)
    win = session.window(batches, count=2 * len(batches))
    ref = compare.Reference(session.index_path, session.cfg,
                            session.traffic, batches, "cpu")
    sound, _ = compare.check_window(ref, win)
    assert compare.verdict(sound, session.cell.limits), sound
    ctl = compare.control(ref, [r.ring for r in win.records])
    assert not compare.verdict(ctl, session.cell.limits), ctl
    lim = session.cell.limits
    assert ctl["score_err"] > 3 * lim["score_err"]
    assert ctl["profile_err"] > 3 * lim["profile_err"]
    # float32 in the same place reads like the program: the limits sit
    # between the precision the configurations state and the one below
    f32 = compare.control(ref, [r.ring for r in win.records], torch.float32)
    assert f32["score_err"] < lim["score_err"]


def _wrap(monkeypatch, after=None, before=None):
    from kasa_tpu_torch.match import turbo
    orig = turbo.fused_turbo_acc

    def step(tt, byte_mat, lut, acc_ca, acc_cu, num_reads, *a, **k):
        if before is not None:
            byte_mat = before(byte_mat, num_reads, k)
        keep = (acc_ca.clone(), acc_cu.clone())
        out = orig(tt, byte_mat, lut, acc_ca, acc_cu, num_reads, *a, **k)
        if after is not None:
            out = after(out, acc_ca, acc_cu, keep, num_reads)
        return out
    monkeypatch.setattr(turbo, "fused_turbo_acc", step)


def test_state_left_unchanged_fails(session, monkeypatch):
    def unchanged(out, acc_ca, acc_cu, keep, R):
        acc_ca.copy_(keep[0])
        acc_cu.copy_(keep[1])
        return out
    _wrap(monkeypatch, after=unchanged)
    res, lines = _run(session)
    assert not res["correct"], lines
    assert res["checked"]["profile_err"]["value"] >= 0.99


def test_half_the_batch_left_out_fails(session, monkeypatch):
    def halve(mat, R, k):
        # R counts the padded rows: blank the later half of the reads
        lpr = k.get("lines_per_read", 1)
        reads = int((mat != ord("X")).any(1).sum()) // lpr
        mat = mat.clone()
        mat[(reads // 2) * lpr:] = ord("X")
        return mat
    _wrap(monkeypatch, before=halve)
    res, lines = _run(session)
    assert not res["correct"], lines
    assert res["checked"]["hits_wrong"]["value"] > 0


def test_answer_altered_where_produced_fails(session, monkeypatch):
    def alter(out, acc_ca, acc_cu, keep, R):
        packed, ht, hk = out
        cap = (len(packed) - 2 * R - 4) // 2
        packed[2 * R:2 * R + 2 * cap].view(torch.float32) \
            .view(cap, 2)[:, 1].mul_(1.001)
        hk.mul_(1.001)
        return packed, ht, hk
    _wrap(monkeypatch, after=alter)
    res, lines = _run(session)
    assert not res["correct"], lines
    assert res["checked"]["score_err"]["value"] > 5e-4


def test_sound_run_stays_correct(session):
    res, lines = _run(session, 123)
    assert res["correct"], lines
    assert np.isfinite(res["checked"]["score_err"]["value"])
