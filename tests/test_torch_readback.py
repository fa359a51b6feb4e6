"""The dense hit lists' readback in the batch API (match/fast.py
SingleTurboDispatch, match/tiered.py SingleTurboDispatch_decode): lists
read back at dispatch into each batch's own host memory, the late
synchronous read in decode, and the CSR arm give one answer; the
counters readback.prefetch, readback.late and readback.unused; and the
switch that follows the last decoded batch.

The card's test (skips without one; imports no JAX):

    python3 -m pytest --noconftest -q -m cuda tests/test_torch_readback.py
"""

import numpy as np
import pytest
import torch

from test_torch_trace import _packed

torch.set_num_threads(2)


@pytest.fixture
def recording():
    """The recorder, emptied and on, as under --verbose."""
    from kasa_tpu_torch.utils import timers
    timers.reset()
    timers.verbose(True)
    yield timers
    timers.verbose(False)
    timers.reset()


# ------------------------------------------------- synthetic batches

ROWS_PAD, RB, W = 8, 5, 4
HC = np.array([1, 2, 0, 3, 0])
FLAGS = np.array([0, 2, 0, 3, 0])      # bit 0 ofc, bit 1 ofl


def _lists():
    """Dense (ROWS_PAD, W) lists whose rows start with each read's hits,
    and the same hits in read order as CSR pairs."""
    rng = np.random.default_rng(5)
    ht = rng.integers(0, 100, size=(ROWS_PAD, W)).astype(np.int32)
    hk = rng.random((ROWS_PAD, W)).astype(np.float32)
    csr = [(int(ht[r, i]), int(hk[r, i:i + 1].view(np.int32)[0]))
           for r in range(RB) for i in range(HC[r])]
    return ht, hk, csr


def _batch(overflow):
    """(packed, ht_d, hk_d): the CSR holds the 6 hits, or (overflow) it
    has room for 4 of them and the lists hold the answer."""
    ht, hk, csr = _lists()
    cap = 4 if overflow else 6
    packed = _packed(ROWS_PAD, RB, cap, HC, FLAGS, csr[:cap], int(HC.sum()))
    return packed, cap, torch.from_numpy(ht), torch.from_numpy(hk)


@pytest.mark.parametrize("arm", ["prefetched", "late", "csr"])
def test_the_three_arms_give_one_answer(recording, arm):
    from kasa_tpu_torch.match.tiered import SingleTurboDispatch_decode
    packed, cap, ht_d, hk_d = _batch(overflow=arm != "csr")
    lists = (ht_d.numpy().copy(), hk_d.numpy().copy()) \
        if arm == "prefetched" else None
    hc, ofc, ofl, nflag, ht, hk = SingleTurboDispatch_decode(
        packed, ROWS_PAD, RB, cap, True, ht_d, hk_d, lists)
    assert list(hc) == list(HC) and nflag == 2
    assert list(ofc) == [False, False, False, True, False]
    assert list(ofl) == [False, True, False, True, False]
    ref_t, ref_k, _ = _lists()
    for r in range(RB):
        assert list(ht[r, :hc[r]]) == list(ref_t[r, :HC[r]])
        assert list(hk[r, :hc[r]]) == list(ref_k[r, :HC[r]])
    names = {s.name for s in recording.finished()}
    assert ("decode.lists.d2h" in names) == (arm == "late")
    assert ("decode.lists" in names) == (arm != "csr")


def test_readback_bytes_do_not_depend_on_the_arm(recording):
    from kasa_tpu_torch.match.tiered import SingleTurboDispatch_decode
    packed, cap, ht_d, hk_d = _batch(overflow=True)
    for lists in ((ht_d.numpy(), hk_d.numpy()), None):
        SingleTurboDispatch_decode(packed, ROWS_PAD, RB, cap, True, ht_d,
                                   hk_d, lists)
    got = [s.counts["readback.bytes"] for s in recording.finished("decode")]
    assert got == [packed.nbytes + 8 * RB * W] * 2


def test_switch_follows_the_last_decode(recording):
    """On at the start; after each decode, on exactly when that batch
    wanted its lists and overflowed its CSR."""
    from types import SimpleNamespace
    from kasa_tpu_torch.match.fast import SingleTurboDispatch
    disp = SingleTurboDispatch(SimpleNamespace(device="cpu"), 6, 24)
    assert disp.prefetch_lists
    seen = []
    for want, overflow in ((True, True), (False, True), (True, True),
                           (True, False), (True, True)):
        packed, cap, ht_d, hk_d = _batch(overflow)
        disp.decode(packed, ROWS_PAD, RB, cap, want, ht_d, hk_d)
        seen.append(disp.prefetch_lists)
    assert seen == [True, False, True, False, True]


# ----------------------------------------- batches through dispatch

@pytest.fixture(scope="module")
def long_index(tmp_path_factory):
    """A tiny synthetic index (24 genomes of 6 kbp) and 1-4 kbp reads
    cut from its genomes with 0.5 % substitutions."""
    from kasa_tpu_torch import synth
    d = tmp_path_factory.mktemp("readback_synth")
    n_sp, glen, core = 24, 6000, 4
    p = synth.generate(str(d), num_species=n_sp, genome_len=glen,
                       core_genes=core, reads=8, small_reads=0,
                       warm_reads=0, smoke_reads=8, log=lambda *a: None,
                       pairs=False)
    genomes = synth._gen_genomes(np.random.default_rng(synth.SEED), n_sp,
                                 glen, core)
    rng = np.random.default_rng(11)
    reads = []
    for _ in range(256):
        g = genomes[int(rng.integers(0, n_sp))]
        n = int(rng.integers(1000, 4001))
        off = int(rng.integers(0, glen - n))
        r = g[off:off + n].copy()
        err = np.nonzero(rng.random(n) < 0.005)[0]
        r[err] = np.frombuffer(b"ACGT", np.uint8)[
            rng.integers(0, 4, size=len(err))]
        reads.append(r)
    return p["index"], reads


def _dispatcher(index, device):
    from kasa_tpu_torch.config import Config
    from kasa_tpu_torch.match.fast import BatchAssembler, SingleTurboDispatch
    from kasa_tpu_torch.match.pipeline import _load_index
    from kasa_tpu_torch.match.turbo import load_or_build_turbo
    cfg = Config()
    limbs, _, highest_k, content, _, tax_rows = _load_index(cfg, index)
    S = content.num_species
    tt = load_or_build_turbo(index, limbs, tax_rows, highest_k, cfg.lower_k,
                             cfg.higher_k, S, device)
    num_k = cfg.higher_k - cfg.lower_k + 1
    return (SingleTurboDispatch(tt, num_k, S),
            BatchAssembler(highest_k, cfg.lower_k))


def _ring(asm, reads, per_batch, n_batches):
    """(mat, rows_pad, w, rb) of n_batches batches of per_batch reads."""
    from kasa_tpu_torch.match.fast import _bucket, _len_bucket
    ring = []
    for b in range(n_batches):
        rs = reads[b * per_batch:(b + 1) * per_batch]
        offs = np.zeros(len(rs) + 1, np.int64)
        np.cumsum([len(r) for r in rs], out=offs[1:])
        maxlen = _len_bucket(int(np.diff(offs).max()) + asm.marker_len,
                             asm.min_line)
        rows_pad = _bucket(len(rs), 512)
        mat = asm.assemble(np.concatenate(rs), offs, maxlen, rows_pad)
        ring.append((mat, rows_pad, asm.window_target(maxlen), len(rs)))
    return ring


def _drive(disp, ring, device, cap, prefetch, in_flight=2):
    """Dispatch the ring with `in_flight` batches queued, fetch and
    decode each with lists wanted, as the drive loop does; prefetch
    False forces the switch off before every dispatch.  -> the decoded
    (hc, ofc, ofl, nflag, ht, hk) of each batch, and its device lists
    (ht_d, hk_d)."""
    from kasa_tpu_torch.core.alphabet import build_codon_code_lut
    lut = torch.from_numpy(build_codon_code_lut().astype(np.int32)) \
        .to(device)
    ca, cu = disp.new_acc()
    queued, out, dev = [], [], []

    def consume():
        h, ht_d, hk_d, rows_pad, rb = queued.pop(0)
        packed = disp.fetch(h)[0]
        out.append(disp.decode(packed, rows_pad, rb, cap, True, ht_d, hk_d))
        dev.append((ht_d, hk_d))

    for mat, rows_pad, w, rb in ring:
        if not prefetch:
            disp.prefetch_lists = False
        h, ht_d, hk_d = disp.dispatch(mat, lut, ca, cu, rows_pad, w, cap)
        queued.append((h, ht_d, hk_d, rows_pad, rb))
        if len(queued) > in_flight:
            consume()
    while queued:
        consume()
    return out, dev


def _same_answers(a, b, rtol=0.0):
    """Equal decoded batches; the scores within rtol where the two come
    from two runs of the card's step, whose float32 sums are not bound
    to one order."""
    for (hc, ofc, ofl, nflag, ht, hk), (hc2, ofc2, ofl2, nflag2, ht2,
                                        hk2) in zip(a, b, strict=True):
        assert (hc == hc2).all() and (ofc == ofc2).all()
        assert (ofl == ofl2).all() and nflag == nflag2
        for r in range(len(hc)):
            assert (ht[r, :hc[r]] == ht2[r, :hc2[r]]).all()
            np.testing.assert_allclose(hk[r, :hc[r]], hk2[r, :hc2[r]],
                                       rtol=rtol, atol=0)


# a cap of 2 hits a read: every batch of long reads overflows its CSR,
# as on a full index
CAP_PER_READ = 2


@pytest.mark.parametrize("case", ["prefetch", "late", "unused"])
def test_each_counter_counts_its_case(recording, long_index, case):
    index, reads = long_index
    device = torch.device("cpu")
    disp, asm = _dispatcher(index, device)
    ((mat, rows_pad, w, rb),) = _ring(asm, reads, 8, 1)
    cap = CAP_PER_READ * rb if case != "unused" \
        else disp.csr_cap(rows_pad)
    disp.prefetch_lists = case != "late"
    _drive(disp, [(mat, rows_pad, w, rb)], device, cap, prefetch=True)
    got = {n: recording.counter(f"readback.{n}")
           for n in ("prefetch", "late", "unused")}
    assert got == {"prefetch": int(case != "late"),
                   "late": int(case == "late"),
                   "unused": int(case == "unused")}
    assert recording.counter("csr.overflow") == int(case != "unused")


def test_prefetched_and_late_runs_agree(recording, long_index):
    """Three batches of long reads, two in flight: every one overflows,
    the prefetched run reads no list late, and both runs decode the same
    lists."""
    index, reads = long_index
    device = torch.device("cpu")
    disp, asm = _dispatcher(index, device)
    ring = _ring(asm, reads, 8, 3)
    cap = CAP_PER_READ * 8
    pre, _ = _drive(disp, ring, device, cap, prefetch=True)
    assert recording.counter("readback.prefetch") == 3
    assert recording.counter("readback.late") == 0
    assert recording.counter("csr.overflow") == 3
    late, _ = _drive(disp, ring, device, cap, prefetch=False)
    assert recording.counter("readback.late") == 3
    _same_answers(pre, late)


def test_in_place_writes_stay_in_their_batch(recording, long_index):
    """A caller that rewrites one batch's returned lists in place (the
    drive loop's recompute fixes) leaves every other batch's alone."""
    index, reads = long_index
    device = torch.device("cpu")
    disp, asm = _dispatcher(index, device)
    ring = _ring(asm, reads, 8, 2)
    cap = CAP_PER_READ * 8
    (first, second), _ = _drive(disp, ring, device, cap, prefetch=True)
    keep = second[4].copy(), second[5].copy()
    first[4][:] = -1
    first[5][:] = -1.0
    assert (second[4] == keep[0]).all() and (second[5] == keep[1]).all()


def test_a_packed_row_not_fetched_last_reads_late(recording):
    """decode takes the prefetched lists only with the packed row that
    the last fetch returned; any other row reads its lists late."""
    from types import SimpleNamespace
    from kasa_tpu_torch.match.fast import SingleTurboDispatch
    disp = SingleTurboDispatch(SimpleNamespace(device="cpu"), 6, 24)
    packed, cap, ht_d, hk_d = _batch(overflow=True)
    handle = ([torch.from_numpy(packed), ht_d, hk_d], None, None)
    fetched = disp.fetch(handle)
    assert len(fetched) == 1 and fetched[0] is not None
    disp.decode(fetched[0].copy(), ROWS_PAD, RB, cap, True, ht_d, hk_d)
    assert recording.counter("readback.late") == 1
    assert disp._fetched is None


# ------------------------------------------------------------ the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the pinned readback and its copy "
                    "stream exist only on a card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_prefetch_matches_the_late_path(recording, long_index, cuda):
    """Four batches of 64 long reads, three in flight, through the CUDA
    kernels: with the lists read back at dispatch (pinned memory, copy
    stream) no batch reads late, and the decoded lists equal those of a
    run with the switch forced off: bit for bit the batch's own device
    lists, and the other run's to float32 rounding."""
    index, reads = long_index
    disp, asm = _dispatcher(index, cuda)
    ring = _ring(asm, reads, 64, 4)
    cap = CAP_PER_READ * 64
    pre, dev = _drive(disp, ring, cuda, cap, prefetch=True, in_flight=3)
    assert recording.counter("readback.prefetch") == 4
    assert recording.counter("readback.late") == 0
    assert recording.counter("csr.overflow") == 4
    for (hc, *_, ht, hk), (ht_d, hk_d) in zip(pre, dev):
        rb = len(hc)
        assert (ht == ht_d[:rb].cpu().numpy()).all()
        assert (hk == hk_d[:rb].cpu().numpy()).all()
    late, _ = _drive(disp, ring, cuda, cap, prefetch=False, in_flight=3)
    assert recording.counter("readback.late") == 4
    _same_answers(pre, late, rtol=1e-5)
