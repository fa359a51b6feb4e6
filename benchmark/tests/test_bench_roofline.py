"""step_roofline_pct's least bytes come from the inputs and the answers
alone: the same batches and answers give the same bytes whatever path
produced them, and the key sectors are the reference's."""

from types import SimpleNamespace

import numpy as np
import torch

from benchmark import compare, harness, reference, runner


def _setup(session, seed):
    ring = session.draw(seed)
    if not hasattr(session, "disp"):
        session.load()
    return session.assemble(ring, seed)


def test_least_bytes_depend_on_inputs_and_answers(session):
    batches = _setup(session, 77)
    win = session.window(batches, count=2 * len(batches))
    ref = compare.Reference(session.index_path, session.cfg,
                            session.traffic, batches, "cpu")
    _, sectors = compare.check_window(ref, win, want_sectors=True)
    _, again = compare.check_window(ref, win, want_sectors=True)
    assert sectors == again and all(v > 0 for v in sectors.values())
    S, K = session.S, session.num_k
    got = runner.least_bytes(batches, win, sectors, K, S)
    # a stand-in window with the same batches and answers, and no
    # timing or device state of its own
    fake = SimpleNamespace(records=[SimpleNamespace(ring=r.ring,
                                                    hits=r.hits)
                                    for r in win.records])
    assert runner.least_bytes(batches, fake, sectors, K, S) == got
    # each pass of a ring batch counts the same bytes
    per = {}
    for r in win.records:
        b = runner.least_bytes(batches, SimpleNamespace(records=[r]),
                               sectors, K, S)
        assert per.setdefault(r.ring, b) == b
    bt = batches[0]
    assert per[0] >= bt.mat.nbytes + 4 * bt.reads + 8 * K * S


def test_key_sectors_are_the_reference_searches(session):
    batches = _setup(session, 78)
    idx = reference.Index(session.index_path, session.cfg["k_low"],
                          session.cfg["k_high"], "cpu")
    bh = reference.BatchHits(idx, batches[0].mates, session.traffic["six"],
                             session.traffic["unique"])
    matched = sum(int(g.numel()) for g in bh.gid)
    assert 0 < bh.key_sectors <= matched
    assert bh.key_sectors * 32 <= idx.n * idx.key_bytes + 32
    # the taxa side: each matched group's taxa, sector by sector
    for lv, g in zip(idx.levels, bh.gid):
        want = set()
        for gi in torch.unique(g).tolist():
            a, b = int(lv.pstart[gi]), int(lv.pstart[gi + 1])
            want |= set(range(a * 4 // 32, (b * 4 - 1) // 32 + 1))
        assert reference.taxa_sectors(lv, g) == len(want)
    assert bh.taxa_sectors > 0


def test_roofline_reader_is_silent_without_a_trace():
    read = harness.metric_reader("step_roofline_pct")
    assert read(SimpleNamespace(trace=None, least_bytes=1.0,
                                peak={"hbm_bytes_per_s": 3.35e12})) is None
    tr = SimpleNamespace(device_s=0.5)
    v = read(SimpleNamespace(trace=tr, least_bytes=3.35e11,
                             peak={"hbm_bytes_per_s": 3.35e12}))
    assert np.isclose(v, 20.0)


def test_kernel_reader_leaves_out_copies():
    from benchmark import devtrace
    read = harness.metric_reader("kernel_device_ms")
    assert read(SimpleNamespace(trace=None)) is None
    assert devtrace.is_copy("Memcpy DtoH (Device -> Pageable)")
    assert devtrace.is_copy("Memset (Device)")
    assert not devtrace.is_copy("turbo_match_kernel")
    tr = SimpleNamespace(kernel_s=0.25, batches=5)
    assert np.isclose(read(SimpleNamespace(trace=tr)), 50.0)
