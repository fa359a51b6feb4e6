"""The port's recorder (kasa_tpu_torch/utils/timers.py): stage totals
always, spans and per-span counters only while a torch.profiler session
is active or --verbose asked for them, batch ids carried from dispatch
through fetch to decode, and the clocks shared with the device trace."""

import threading
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(2)


@pytest.fixture
def timers():
    """The recorder, emptied and off (no profiler, no --verbose)."""
    from kasa_tpu_torch.utils import timers
    timers.verbose(False)
    timers.reset()
    timers.set_batch(None)
    assert not timers.ON
    yield timers
    timers.verbose(False)
    timers.reset()


@pytest.fixture
def recording(timers):
    """The recorder on, as under --verbose."""
    timers.verbose(True)
    assert timers.ON
    return timers


def _tree(timers):
    with timers.span("outer"):
        with timers.span("inner"):
            timers.count("things", 2)
        with timers.span("inner"):
            timers.count("things", 3)
        timers.count("outer.things")


def test_off_records_nothing_and_stage_totals_accumulate(timers):
    for _ in range(3):
        with timers.stage("fast/dispatch"):
            _tree(timers)
    assert timers.finished() == []
    assert timers._COUNT["fast/dispatch"] == 3
    assert timers._ACC["fast/dispatch"] > 0
    # counter totals are kept whether or not spans are recorded
    assert timers.counter("things") == 15
    assert timers.counter("outer.things") == 3


def test_off_span_site_is_one_global_check(timers, monkeypatch):
    """While recording is off a span site reads no clock, builds no span
    and no record_function, and asks nothing of the profiler."""
    from kasa_tpu_torch import kernels

    def refuse(*a, **k):
        raise AssertionError("called while recording is off")
    monkeypatch.setattr(timers.time, "perf_counter_ns", refuse)
    monkeypatch.setattr(timers, "Span", refuse)
    monkeypatch.setattr(timers, "_profiling", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    for _ in range(100):
        site = timers.span("dispatch.h2d")
        assert site is timers._NULL
        with site:
            pass
    # the kernel wrappers' launch site: the C call alone
    calls = []
    monkeypatch.setattr(kernels, "_fn",
                        lambda sym: lambda *a: calls.append(sym) or 0)
    before = kernels.COUNTS["encode"]
    kernels._launch("kasa_encode_windows", "encode")
    assert calls == ["kasa_encode_windows"]
    assert kernels.COUNTS["encode"] == before + 1
    kernels.COUNTS["encode"] = before


@pytest.mark.parametrize("on", [False, True], ids=["off", "recording"])
def test_launch_span_named_by_its_counter(timers, monkeypatch, on):
    from kasa_tpu_torch import kernels
    timers.verbose(on)
    monkeypatch.setattr(kernels, "_fn", lambda sym: lambda *a: 0)
    before = sum(kernels.COUNTS.values())
    with timers.span("dispatch.step"):
        kernels._launch("kasa_turbo_match", "turbo_match")
        kernels._launch("kasa_dedup_windows_long", "dedup.long")
    assert sum(kernels.COUNTS.values()) == before + 2
    kernels.COUNTS["turbo_match"] -= 1
    kernels.COUNTS["dedup.long"] -= 1
    names = [s.name for s in timers.finished()]
    assert names == (["launch.turbo_match", "launch.dedup.long",
                      "dispatch.step"] if on else [])


def test_profiler_session_records_ids_parents_thread_batch(timers):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        b = timers.next_batch()          # a batch boundary reads the state
        assert timers.ON
        with timers.stage("fast/dispatch"):
            with timers.span("dispatch"):
                with timers.span("dispatch.h2d"):
                    torch.ones(4) + 1
                with timers.span("dispatch.step"):
                    pass
    spans = {s.name: s for s in timers.finished()}
    assert set(spans) == {"fast/dispatch", "dispatch", "dispatch.h2d",
                          "dispatch.step"}
    assert len({s.id for s in spans.values()}) == 4
    assert spans["fast/dispatch"].parent is None
    assert spans["dispatch"].parent == spans["fast/dispatch"].id
    assert spans["dispatch.h2d"].parent == spans["dispatch"].id
    assert spans["dispatch.step"].parent == spans["dispatch"].id
    assert {s.batch for s in spans.values()} == {b}
    assert {s.thread for s in spans.values()} == {threading.get_ident()}
    for s in spans.values():
        assert 0 < s.t0 <= s.t1
    # each span is a record_function range on the profiler's timeline
    names = {e.name for e in prof.events()}
    assert {"dispatch", "dispatch.h2d", "dispatch.step"} <= names
    # the session is over: the next span site turns recording off
    assert timers.span("after") is timers._NULL and not timers.ON


def test_self_time_is_duration_less_children(recording):
    timers = recording
    with timers.span("decode"):
        time.sleep(0.002)
        with timers.span("decode.lists"):
            with timers.span("decode.lists.d2h"):
                time.sleep(0.003)
            with timers.span("decode.lists.copy"):
                time.sleep(0.001)
    by = {s.name: s for s in timers.finished()}
    own = timers.self_times()
    kids = by["decode.lists.d2h"].ns + by["decode.lists.copy"].ns
    assert own["decode.lists"] == (by["decode.lists"].ns - kids, 1)
    assert own["decode"] == (by["decode"].ns - by["decode.lists"].ns, 1)
    assert own["decode.lists.d2h"] == (by["decode.lists.d2h"].ns, 1)
    assert own["decode"][0] >= 2_000_000
    assert sum(ns for ns, _ in own.values()) == by["decode"].ns


def test_counters_attach_to_innermost_span(recording):
    timers = recording
    timers.count("outside")
    _tree(timers)
    spans = timers.finished()
    assert [s.counts for s in spans] == [{"things": 2}, {"things": 3},
                                         {"outer.things": 1}]
    assert timers.counter("things") == 5 and timers.counter("outside") == 1


def test_spans_are_kept_per_thread(recording):
    """Two threads nest their own spans: a consumer's span is never the
    parent of a producer's, and each takes its own current batch."""
    timers = recording
    go = threading.Barrier(2)

    def work(name, b):
        timers.set_batch(b)
        with timers.span(name):
            go.wait()
            with timers.span(name + ".child"):
                go.wait()
    ts = [threading.Thread(target=work, args=(n, b))
          for n, b in (("dispatch", 7), ("decode", 8))]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    by = {s.name: s for s in timers.finished()}
    assert by["dispatch.child"].parent == by["dispatch"].id
    assert by["decode.child"].parent == by["decode"].id
    assert by["dispatch"].batch == by["dispatch.child"].batch == 7
    assert by["decode"].batch == by["decode.child"].batch == 8
    assert by["dispatch"].thread != by["decode"].thread


def test_totals_lose_no_add_across_threads(timers):
    """More threads than cores adding to one counter and one stage, with
    the interpreter switching threads as often as it can."""
    import os
    import sys
    n, per = 2 * (os.cpu_count() or 4), 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(per):
                timers.count("adds")
                with timers.stage("s"):
                    pass
        ts = [threading.Thread(target=work) for _ in range(n)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert timers.counter("adds") == n * per
    assert timers._COUNT["s"] == n * per


def test_finished_keeps_the_window(recording):
    timers = recording
    with timers.span("fetch"):
        pass
    t0 = time.perf_counter()
    with timers.span("fetch"):
        pass
    with timers.span("decode"):
        pass
    t1 = time.perf_counter()
    with timers.span("fetch"):
        pass
    assert len(timers.finished("fetch")) == 3
    assert len(timers.finished("fetch", t0, t1)) == 1
    assert [s.name for s in timers.finished(None, t0, t1)] == ["fetch",
                                                               "decode"]


def _packed(rows_pad, rb, cap, hc, flags, csr, total):
    p = np.zeros(2 * rows_pad + 2 * cap + 4, np.int32)
    p[:rb] = hc
    p[rows_pad:rows_pad + rb] = flags
    p[2 * rows_pad:2 * rows_pad + 2 * len(csr)] = np.asarray(csr).ravel()
    p[-2] = total
    p[-1] = int(np.count_nonzero(flags))
    return p


@pytest.mark.parametrize("overflow", [False, True],
                         ids=["csr_holds_the_hits", "csr_overflows"])
def test_decode_counters(recording, overflow):
    from kasa_tpu_torch.match.tiered import SingleTurboDispatch_decode
    timers = recording
    rows_pad, rb, cap, W = 8, 5, 6, 4
    hc = np.array([1, 2, 0, 3, 0])
    flags = np.array([0, 2, 0, 3, 0])     # bit 0 ofc, bit 1 ofl
    one = np.float32(1.5).view(np.int32)
    csr = [(3, one), (1, one), (2, one), (0, one), (4, one), (5, one)]
    total = 9 if overflow else int(hc.sum())
    packed = _packed(rows_pad, rb, cap, hc, flags, csr, total)
    ht_d = torch.arange(rows_pad * W, dtype=torch.int32).reshape(rows_pad, W)
    hk_d = torch.full((rows_pad, W), 0.25, dtype=torch.float32)
    out = SingleTurboDispatch_decode(packed, rows_pad, rb, cap, True, ht_d,
                                     hk_d)
    hc_o, ofc, ofl, nflag, ht, hk = out
    assert list(hc_o) == list(hc) and nflag == 2
    assert list(ofl) == [False, True, False, True, False]
    by = {s.name: s for s in timers.finished()}
    dec = by["decode"]
    assert dec.counts == {
        "hits": total, "reads.flagged": 2, "csr.overflow": int(overflow),
        "readback.bytes": packed.nbytes + (8 * rb * W if overflow else 0)}
    if overflow:
        assert ht.shape == (rb, W) and (ht == ht_d[:rb].numpy()).all()
        assert set(by) == {"decode", "decode.lists", "decode.lists.d2h",
                           "decode.lists.copy"}
        assert by["decode.lists"].parent == dec.id
        # each list read back, then copied, in turn
        assert [s.name for s in timers.finished()][:4] == [
            "decode.lists.d2h", "decode.lists.copy"] * 2
        assert by["decode.lists.d2h"].parent == by["decode.lists"].id
    else:
        assert ht.shape == (rb, 3) and list(ht[3]) == [0, 4, 5]
        assert set(by) == {"decode", "decode.csr"}


def test_decode_without_lists_reads_back_the_packed_row(recording):
    from kasa_tpu_torch.match.tiered import SingleTurboDispatch_decode
    packed = _packed(4, 2, 2, [1, 0], [1, 0], [(0, 0)], 5)
    *_, ht, hk = SingleTurboDispatch_decode(packed, 4, 2, 2, False, None,
                                            None)
    assert ht is None and hk is None
    (dec,) = recording.finished()
    assert dec.counts["csr.overflow"] == 1
    assert dec.counts["readback.bytes"] == packed.nbytes


def test_handle_carries_its_batch_to_the_consumer(recording):
    from kasa_tpu_torch.match.fast import _fetch, _to_host
    timers = recording
    b = timers.next_batch()
    handle = _to_host([torch.arange(3)], torch.device("cpu"))
    timers.next_batch()
    seen = []

    def consumer():
        out = _fetch(handle)
        seen.append((timers.batch(), out[0].tolist()))
    t = threading.Thread(target=consumer)
    t.start()
    t.join()
    assert seen == [(b, [0, 1, 2])]
    (fetch,) = timers.finished("fetch")
    assert fetch.batch == b and fetch.thread != threading.get_ident()


@pytest.fixture(scope="module")
def tiny_index(tmp_path_factory):
    from kasa_tpu_torch import synth
    d = tmp_path_factory.mktemp("trace_synth")
    p = synth.generate(str(d), num_species=24, genome_len=1500,
                       core_genes=4, reads=60, small_reads=10,
                       warm_reads=10, smoke_reads=40, log=lambda *a: None,
                       pairs=False)
    return p


def _dispatcher(index):
    from kasa_tpu_torch.config import Config
    from kasa_tpu_torch.match.fast import BatchAssembler, SingleTurboDispatch
    from kasa_tpu_torch.match.pipeline import _load_index
    from kasa_tpu_torch.match.turbo import load_or_build_turbo
    cfg = Config()
    limbs, _, highest_k, content, _, tax_rows = _load_index(cfg, index)
    S = content.num_species
    tt = load_or_build_turbo(index, limbs, tax_rows, highest_k, cfg.lower_k,
                             cfg.higher_k, S, torch.device("cpu"))
    num_k = cfg.higher_k - cfg.lower_k + 1
    return (SingleTurboDispatch(tt, num_k, S),
            BatchAssembler(highest_k, cfg.lower_k))


def _reads(fastq, n):
    with open(fastq, "rb") as fh:
        lines = fh.read().splitlines()
    seqs = [np.frombuffer(lines[4 * i + 1], np.uint8) for i in range(n)]
    offs = np.zeros(n + 1, np.int64)
    np.cumsum([len(s) for s in seqs], out=offs[1:])
    return np.concatenate(seqs), offs


def test_dispatch_fetch_decode_share_a_batch_id(recording, tiny_index):
    """Two batches of the tiny synthetic index through dispatch, fetch
    and decode on the CPU: each batch's three spans carry one id, the two
    batches' ids differ, and the counters land on their spans."""
    from kasa_tpu_torch.core.alphabet import build_codon_code_lut
    from kasa_tpu_torch.match.fast import _bucket, _len_bucket
    timers = recording
    disp, asm = _dispatcher(tiny_index["index"])
    lut = torch.from_numpy(build_codon_code_lut().astype(np.int32))
    ca, cu = disp.new_acc()
    blob, offs = _reads(tiny_index["smoke"], 32)
    handles = []
    for r0, r1 in ((0, 16), (16, 32)):
        o = offs[r0:r1 + 1] - offs[r0]
        maxlen = _len_bucket(int(np.diff(o).max()) + asm.marker_len,
                             asm.min_line)
        rows_pad = _bucket(r1 - r0, 512)
        mat = asm.assemble(blob[offs[r0]:offs[r1]], o, maxlen, rows_pad)
        cap = disp.csr_cap(rows_pad)
        h, ht_d, hk_d = disp.dispatch(mat, lut, ca, cu, rows_pad,
                                      asm.window_target(maxlen), cap)
        handles.append((h, ht_d, hk_d, rows_pad, r1 - r0, cap, mat.nbytes))
    hits = []
    for h, ht_d, hk_d, rows_pad, rb, cap, _ in handles:
        packed = disp.fetch(h)[0]
        hc, *_ = disp.decode(packed, rows_pad, rb, cap, True, ht_d, hk_d)
        hits.append(int(hc.sum()))
    disp.reduce_acc(ca, cu)
    ids = []
    for i, name in enumerate(("dispatch", "fetch", "decode")):
        got = timers.finished(name)
        assert len(got) == 2, name
        ids.append([s.batch for s in got])
    assert ids[0] == ids[1] == ids[2]
    assert ids[0][0] != ids[0][1] and None not in ids[0]
    h2d = timers.finished("dispatch.h2d")
    assert [s.counts["h2d.bytes"] for s in h2d] == [x[-1] for x in handles]
    dispatch = timers.finished("dispatch")
    assert [s.parent for s in h2d] == [s.id for s in dispatch]
    # the plain versions call no kernel wrapper
    assert [s.counts["launches"] for s in timers.finished("dispatch.step")] \
        == [0, 0]
    assert [s.counts["hits"] for s in timers.finished("decode")] == hits
    (flush,) = timers.finished("flush")
    assert flush.counts["flush.bytes"] == ca.nbytes + cu.nbytes


def test_recompute_counts_each_read(timers, tiny_index):
    """The exact host recompute counts recompute.reads whether or not
    spans are recorded (the drive loop's fallback total)."""
    from kasa_tpu_torch.core.alphabet import build_codon_code_lut
    from kasa_tpu_torch.match.turbo import host_classify_read, read_windows_np
    disp, asm = _dispatcher(tiny_index["index"])
    blob, offs = _reads(tiny_index["smoke"], 2)
    lut = build_codon_code_lut().astype(np.int32)
    for r in range(2):
        o = offs[r:r + 2] - offs[r]
        maxlen = int(o[-1]) + asm.marker_len
        mat = asm.assemble(blob[offs[r]:offs[r + 1]], o, maxlen, 1)
        q = read_windows_np(mat, lut, asm.highest_k, False, False,
                            asm.window_target(maxlen))
        host_classify_read(disp.tt, q)
    assert timers.counter("recompute.reads") == 2
    assert timers.finished() == []


def test_to_trace_ns_matches_time_ns(recording):
    from torch.profiler import ProfilerActivity, profile
    timers = recording
    for _ in range(3):
        gap = timers.to_trace_ns(time.perf_counter_ns()) - time.time_ns()
        assert abs(gap) < 1_000_000
    # the pair is read again as recording turns on under a profiler
    timers.verbose(False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        timers.set_batch(None)
        assert timers.ON
        with timers.span("mark"):
            pass
    (mark,) = timers.finished("mark")
    ev = next(e for e in prof.profiler.kineto_results.events()
              if e.name() == "mark")
    # the profiler's range opens before the span's stamp and on its clock
    assert abs(timers.to_trace_ns(mark.t0) - ev.start_ns()) < 1_000_000


def test_report_adds_counts_and_self_times(recording):
    timers = recording
    with timers.stage("fast/fetch"):
        with timers.span("fetch"):
            timers.count("reads", 12)
    lines = []
    out = timers.report(lines.append)
    assert set(out) == {"fast/fetch"}
    assert lines[0].startswith("OUT: Time fast/fetch: ")
    assert "OUT: Count reads: 12" in lines
    selfs = [x for x in lines if x.startswith("OUT: Self ")]
    assert {x[len("OUT: Self "):].rsplit(":", 1)[0] for x in selfs} \
        == {"fast/fetch", "fetch"}


def test_cli_verbose_records_and_reports(timers, tmp_path, capsys):
    """identify --verbose on the CPU: the report ends with each counter
    and each span's self time; the recorder is off again afterwards."""
    from pathlib import Path

    from kasa_tpu_torch.cli import main
    root = Path(__file__).resolve().parent.parent
    gold = root / "tests" / "golden"
    rc = main(["kasa", "identify", "-d", str(gold / "exampleIndex"),
               "-c", str(gold / "exampleIndex_content.txt"),
               "-i", str(root / "fixtures" / "reads.fastq"),
               "-q", str(tmp_path / "o.json"), "-p", str(tmp_path / "p.csv"),
               "--device", "cpu", "--verbose"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "OUT: Time fast/dispatch: " in out
    assert "OUT: Count reads: " in out and "OUT: Count hits: " in out
    assert "OUT: Self dispatch: " in out and "OUT: Self decode: " in out
    assert not timers.ON
