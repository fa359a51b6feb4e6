"""The CUDA kernels of kasa_tpu_torch against their plain PyTorch
versions, on the card: K1-K13, the per-file, counts-only, list,
additive and sloppy arms, the five-limb arms of K1, K2 and K5, the long
arms (K3 pre and K5 above 4,096 slots or windows per read: K3's
histogram in shared memory and, past its key range, its global arm; K5's
in shared memory and, past its capacity, in global memory; K6's slot
table in global memory), K4's budget cut inside a T, K7's two arms on
either side of their chunk limits, K12's ascending-id arm, K4 split for
the mesh and K14 mesh_merge.
CUDA kernels have no CPU mode: without a GPU these tests skip.  On a machine with one (and without JAX):

    python3 -m pytest --noconftest -q -m cuda tests/test_torch_kernels.py
"""

import pathlib

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "golden"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _close(a, b):
    torch.testing.assert_close(a.cpu(), b.cpu(), rtol=2e-5, atol=1e-4)


def _tiers(budget_drop):
    from kasa_tpu_torch.match import turbo as PT
    from test_turbo import _index_with_tiers, S
    if budget_drop:
        limbs, taxids, hot = _index_with_tiers(
            n=20_000, heavy_ts=(4, 8, 16, 16, 16, 16))
        R, kpr, seed = 32, 24, 31
    else:
        limbs, taxids, hot = _index_with_tiers()
        R, kpr, seed = 64, 32, 23
    saved = PT.HOT_SETS
    PT.HOT_SETS = 1 if budget_drop else saved
    try:
        arrays, meta = PT.build_tables_np(limbs, taxids.astype(np.int32),
                                          12, 7, 12, S)
    finally:
        PT.HOT_SETS = saved
    rng = np.random.default_rng(seed)
    q = limbs[rng.integers(0, len(taxids), size=R * kpr)].copy()
    for i, kl in enumerate(hot):
        for j in range(4):
            q[(i * 4 + j) * kpr + 5] = kl
    return arrays, meta, q, R, kpr, (64 if budget_drop else None)


def test_encode_kernel(cuda):
    from kasa_tpu_torch.core import encode as E
    rng = np.random.default_rng(1)
    mat = torch.from_numpy(rng.choice(np.frombuffer(b"ACGTXZacgt", np.uint8),
                                      size=(300, 176))).to(cuda)
    lut = torch.from_numpy(E.build_codon_code_lut().astype(np.int32)).to(cuda)
    assert torch.equal(E.encode_windows(mat, lut, 141).cpu(),
                       E.encode_windows_plain(mat, lut, 141).cpu())
    # one frame (window c starts at byte 3c) and protein (byte & 31)
    assert torch.equal(E.encode_windows(mat, lut, 47, one_frame=True).cpu(),
                       E.encode_windows_plain(mat, lut, 47,
                                              one_frame=True).cpu())
    assert torch.equal(E.encode_windows(mat, lut, 165, protein=True).cpu(),
                       E.encode_windows_plain(mat, lut, 165,
                                              protein=True).cpu())


@pytest.mark.parametrize("kpr", [30, 282, 4096])
def test_dedup_kernel(cuda, kpr):
    from kasa_tpu_torch.match import turbo as PT
    rng = np.random.default_rng(kpr)
    R = 64
    q = rng.integers(0, 1 << 30, size=(R * kpr, 2), dtype=np.int32)
    q[:, 0] &= 0x3FF
    src = rng.integers(0, R * kpr, size=R * kpr // 3)
    q[(src // kpr) * kpr + rng.integers(0, kpr, size=len(src))] = q[src]
    qd = torch.from_numpy(q).to(cuda)
    got = PT.dedup_windows(qd, R, kpr)
    want = PT.dedup_windows_plain(qd, R, kpr)
    assert torch.equal(got.cpu(), want.cpu())
    assert int((want[:, 0] == PT.POISON_LIMB).sum()) > 0


@pytest.mark.parametrize("budget_drop", [False, True])
def test_turbo_kernels(cuda, budget_drop):
    from kasa_tpu_torch.match import turbo as PT
    arrays, meta, q_np, R, kpr, eb = _tiers(budget_drop)
    tt = PT.tables_from_numpy(arrays, meta, cuda)
    q = torch.from_numpy(q_np).to(cuda)
    S, nk = meta["num_species"], 6
    skey, mpay = PT.turbo_match(q, tt, R, kpr)
    sk2, mp2 = PT.turbo_match_plain(q, tt, R, kpr)
    assert torch.equal(skey.cpu(), sk2.cpu())
    assert torch.equal(mpay.cpu(), mp2.cpu())
    pre = PT.turbo_reads_pre(skey, mpay)
    pre2 = PT.turbo_reads_pre_plain(skey, mpay)
    for a, b in zip(pre, pre2):
        assert torch.equal(a.cpu(), b.cpu())
    ck, cc, runs, mcnt, cp = pre2
    ca1 = torch.zeros((nk, S), device=cuda)
    ca2 = torch.zeros((nk, S), device=cuda)
    m1 = PT.turbo_multi(cp, mcnt, runs, tt, ca1, PT.MULTI_BUDGET,
                        eb or PT.EXP_BUDGET)
    m2 = PT.turbo_multi_plain(cp, mcnt, runs, tt, ca2, PT.MULTI_BUDGET,
                              eb or PT.EXP_BUDGET)
    assert torch.equal(m1[0].cpu(), m2[0].cpu())
    assert torch.equal(m1[4].cpu(), m2[4].cpu())
    for a, b in zip(m1[1:4], m2[1:4]):
        _close(a, b)
    _close(ca1, ca2)
    if budget_drop:
        assert m2[0].any() and 0 < int(m2[4][1]) <= 64
    cu1 = torch.zeros((nk, S), dtype=torch.int32, device=cuda)
    cu2 = torch.zeros((nk, S), dtype=torch.int32, device=cuda)
    cap = 4 * R
    p1 = PT.turbo_reads_post(ck, cc, m2[0], m2[1], tt.weights, ca1, cu1,
                             m2[4], cap)
    p2 = PT.turbo_reads_post_plain(ck, cc, m2[0], m2[1], tt.weights, ca2,
                                   cu2, m2[4], cap)
    ints = torch.ones(p1[0].numel(), dtype=torch.bool)
    ints[2 * R + 1:2 * R + 2 * cap:2] = False
    assert torch.equal(p1[0].cpu()[ints], p2[0].cpu()[ints])
    assert torch.equal(p1[1].cpu(), p2[1].cpu())
    _close(p1[2], p2[2])
    assert torch.equal(cu1.cpu(), cu2.cpu())
    _close(ca1, ca2)


def test_files_arm_kernels(cuda):
    """K4 and K3 (post) with a 3-file file_of_read: (F, numK, S) counts
    and (F * numK, H) hot credits against the plain versions."""
    from kasa_tpu_torch.match import turbo as PT
    arrays, meta, q_np, R, _, _ = _tiers(False)
    kpr = 16            # 96 slots per read: no read over CW runs
    tt = PT.tables_from_numpy(arrays, meta, cuda)
    q = torch.from_numpy(q_np[:R * kpr]).to(cuda)
    S, nk, F = meta["num_species"], 6, 3
    fo = torch.tensor(np.repeat(np.arange(F), [R // 4, R // 2, R - 3 * R // 4])
                      .astype(np.int32), device=cuda)
    skey, mpay = PT.turbo_match(q, tt, R, kpr)
    ck, cc, runs, mcnt, cp = PT.turbo_reads_pre(skey, mpay)
    ca1 = torch.zeros((F, nk, S), device=cuda)
    ca2 = torch.zeros((F, nk, S), device=cuda)
    m1 = PT.turbo_multi(cp, mcnt, runs, tt, ca1, PT.MULTI_BUDGET,
                        PT.EXP_BUDGET, fo)
    m2 = PT.turbo_multi_plain(cp, mcnt, runs, tt, ca2, PT.MULTI_BUDGET,
                              PT.EXP_BUDGET, fo)
    assert torch.equal(m1[0].cpu(), m2[0].cpu())
    assert m1[3].shape == (F * nk, tt.hotmask.shape[0])
    for a, b in zip(m1[1:4], m2[1:4]):
        _close(a, b)
    _close(ca1, ca2)
    cu1 = torch.zeros((F, nk, S), dtype=torch.int32, device=cuda)
    cu2 = torch.zeros((F, nk, S), dtype=torch.int32, device=cuda)
    cap = 4 * R
    p1 = PT.turbo_reads_post(ck, cc, m2[0], m2[1], tt.weights, ca1, cu1,
                             m2[4], cap, fo)
    p2 = PT.turbo_reads_post_plain(ck, cc, m2[0], m2[1], tt.weights, ca2,
                                   cu2, m2[4], cap, fo)
    assert torch.equal(p1[1].cpu(), p2[1].cpu())
    assert torch.equal(cu1.cpu(), cu2.cpu())
    assert (cu2.sum(dim=(1, 2)) > 0).all()
    assert float(m2[3].sum()) > 0           # hot credits
    _close(ca1, ca2)


def test_wrappers_refuse_bad_tensors(cuda):
    from kasa_tpu_torch import kernels
    lut = torch.zeros(512, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        kernels.encode_windows(torch.zeros((4, 40), dtype=torch.int32,
                                           device=cuda), lut, 5)
    with pytest.raises(ValueError):
        kernels.encode_windows(torch.zeros((4, 40), dtype=torch.uint8),
                               lut, 5)


def _sparse(monkeypatch, case):
    """Tables without a hot tier (SPARSE_FOLD_S forced low) and a batch:
    small (S = 40, many multi groups), tiers (every T up to 200), or
    wide_read (tiers, with read 0 all T = 200 windows and read 1 half
    T = 60 ones: more than WM distinct taxa and several chunks of lanes
    in K6)."""
    from kasa_tpu_torch.match import turbo as PT
    monkeypatch.setattr(PT, "SPARSE_FOLD_S", 8)
    if case == "small":
        from test_torch_sparse import _index_and_queries, S
        limbs, taxids, q, R, kpr = _index_and_queries()
    else:
        from test_turbo import _index_with_tiers, S
        limbs, taxids, hot = _index_with_tiers()
        rng = np.random.default_rng(23)
        R, kpr = 64, 32
        q = limbs[rng.integers(0, len(taxids), size=R * kpr)].copy()
        if case == "wide_read":
            q[:kpr] = hot[-1]
            q[kpr:kpr + kpr // 2] = hot[-2]
    arrays, meta = PT.build_tables_np(limbs, taxids.astype(np.int32), 12, 7,
                                      12, S)
    assert arrays["hotmask"].shape[0] == 1
    return arrays, meta, q, R, kpr


@pytest.mark.parametrize("case", ["small", "tiers", "wide_read"])
def test_sparse_fold_kernels(cuda, monkeypatch, case):
    """K6 against sparse_fold_plain, K4's counts-only arm and K3's list
    arm against their plain versions, and the whole sparse batch step."""
    from kasa_tpu_torch import kernels
    from kasa_tpu_torch.match import turbo as PT
    arrays, meta, q_np, R, kpr = _sparse(monkeypatch, case)
    tt = PT.tables_from_numpy(arrays, meta, cuda)
    q = torch.from_numpy(q_np).to(cuda)
    S, nk = meta["num_species"], 6
    skey, mpay = PT.turbo_match(q, tt, R, kpr)
    ck, cc, runs, mcnt, cp = PT.turbo_reads_pre(skey, mpay)
    ca1 = torch.zeros((nk, S), device=cuda)
    ca2 = torch.zeros((nk, S), device=cuda)
    m1 = PT.turbo_multi(cp, mcnt, runs, tt, ca1, PT.MULTI_BUDGET,
                        PT.EXP_BUDGET, counts_only=True)
    m2 = PT.turbo_multi_plain(cp, mcnt, runs, tt, ca2, PT.MULTI_BUDGET,
                              PT.EXP_BUDGET, counts_only=True)
    assert m1[1] is None and m1[2] is None and m1[3] is None
    assert torch.equal(m1[0].cpu(), m2[0].cpu())
    assert torch.equal(m1[4].cpu(), m2[4].cpu())
    _close(ca1, ca2)
    ofc = m2[0]
    launched = kernels.COUNTS["sparse_fold"]
    f1 = PT.sparse_fold(cp, mcnt, ofc, tt)
    assert kernels.COUNTS["sparse_fold"] == launched + 1
    f2 = PT.sparse_fold_plain(cp, mcnt, ofc, tt)
    assert torch.equal(f1[0].cpu(), f2[0].cpu())
    assert torch.equal(f1[2].cpu(), f2[2].cpu())
    _close(f1[1], f2[1])
    if case == "wide_read":
        assert bool(f2[2][0]) and not bool(ofc[0])
    cu1 = torch.zeros((nk, S), dtype=torch.int32, device=cuda)
    cu2 = torch.zeros((nk, S), dtype=torch.int32, device=cuda)
    cap = 4 * R
    p1 = PT.turbo_reads_post(ck, cc, ofc, None, tt.weights, ca1, cu1, m2[4],
                             cap, None, f2)
    p2 = PT.turbo_reads_post_plain(ck, cc, ofc, None, tt.weights, ca2, cu2,
                                   m2[4], cap, None, f2)
    ints = torch.ones(p1[0].numel(), dtype=torch.bool)
    ints[2 * R + 1:2 * R + 2 * cap:2] = False
    assert torch.equal(p1[0].cpu()[ints], p2[0].cpu()[ints])
    assert torch.equal(p1[1].cpu(), p2[1].cpu())
    _close(p1[2], p2[2])
    assert torch.equal(cu1.cpu(), cu2.cpu())
    _close(ca1, ca2)


def _wide_tables():
    from kasa_tpu_torch.match import turbo as PT
    from test_torch_wide import _case, HK, MIN_K, MAX_K
    limbs, tax_rows, q, R, kpr, S = _case()
    arrays, meta = PT.build_tables_np(limbs, tax_rows, HK, MIN_K, MAX_K, S)
    return arrays, meta, q, R, kpr


def test_five_limb_kernels(cuda):
    """The L = 5 arms of K1 (DNA, one frame, protein at highestK = 25),
    K2 and the whole batch step on 128-bit tables, against the plain
    versions."""
    from kasa_tpu_torch.core import encode as E
    from kasa_tpu_torch.match import turbo as PT
    rng = np.random.default_rng(25)
    mat = torch.from_numpy(rng.choice(np.frombuffer(b"ACGTXZacgt", np.uint8),
                                      size=(300, 176))).to(cuda)
    lut = torch.from_numpy(E.build_codon_code_lut().astype(np.int32)).to(cuda)
    for w, mode in ((102, {}), (34, {"one_frame": True}),
                    (152, {"protein": True})):
        got = E.encode_windows(mat, lut, w, highest_k=25, **mode)
        assert got.shape == (300 * w, 5)
        assert torch.equal(got.cpu(), E.encode_windows_plain(
            mat, lut, w, highest_k=25, **mode).cpu())
    arrays, meta, q_np, R, kpr = _wide_tables()
    tt = PT.tables_from_numpy(arrays, meta, cuda)
    q = torch.from_numpy(q_np).to(cuda)
    skey, mpay = PT.turbo_match(q, tt, R, kpr)
    sk2, mp2 = PT.turbo_match_plain(q, tt, R, kpr)
    assert torch.equal(skey.cpu(), sk2.cpu())
    assert torch.equal(mpay.cpu(), mp2.cpu())
    S, nk = meta["num_species"], 6
    outs = []
    for t, qq in ((tt, q), (PT.tables_from_numpy(arrays, meta, "cpu"),
                            q.cpu())):
        ca = torch.zeros((nk, S), device=qq.device)
        cu = torch.zeros((nk, S), dtype=torch.int32, device=qq.device)
        outs.append(PT.turbo_core(t, qq, R, kpr, ca, cu, 160 * R)
                    + (ca, cu))
    (p1, ht1, hk1, ca1, cu1), (p2, ht2, hk2, ca2, cu2) = outs
    ints = torch.ones(p1.numel(), dtype=torch.bool)
    ints[2 * R + 1:2 * R + 2 * 160 * R:2] = False
    assert torch.equal(p1.cpu()[ints], p2[ints])
    assert torch.equal(ht1.cpu(), ht2)
    assert torch.equal(cu1.cpu(), cu2)
    _close(hk1, hk2)
    _close(ca1, ca2)


@pytest.mark.parametrize("kpr", [76, 152, 4096])
def test_dedup_kernel_five_limbs(cuda, kpr):
    """K5's L = 5 arm (80 KB of shared memory at 4,096 windows)."""
    from kasa_tpu_torch.match import turbo as PT
    rng = np.random.default_rng(kpr)
    R = 8 if kpr == 4096 else 64
    q = rng.integers(0, 1 << 30, size=(R * kpr, 5), dtype=np.int32)
    q[:, :2] &= 0x7
    src = rng.integers(0, R * kpr, size=R * kpr // 3)
    q[(src // kpr) * kpr + rng.integers(0, kpr, size=len(src))] = q[src]
    qd = torch.from_numpy(q).to(cuda)
    want = PT.dedup_windows_plain(qd, R, kpr)
    assert torch.equal(PT.dedup_windows(qd, R, kpr).cpu(), want.cpu())
    assert int((want == PT.POISON_LIMB).all(dim=1).sum()) > 0


# ---------------------------------------------------------------------------
# the tiered path: K7, K8 and K3's additive arm

@pytest.mark.parametrize("M,C", [(1, 1), (5000, 4), (70_001, 300)])
def test_tiered_route_kernel(cuda, M, C):
    """The stable routing is deterministic: the kernel's routed arrays
    and cuts equal the plain version's exactly."""
    from kasa_tpu_torch.match import tiered as TI
    rng = np.random.default_rng(M)
    q = rng.integers(0, 1 << 30, size=(M, 2), dtype=np.int64)
    q[rng.random(M) < 0.05, 0] = sum(30 << (5 * j) for j in range(6))
    # some '^' letters (code 30) inside the k range
    bad = rng.random(M) < 0.2
    q[bad, 1] |= 30 << (5 * rng.integers(0, 6, size=int(bad.sum())))
    limb0 = np.unique(rng.integers(1 << 20, 1 << 30, size=C))[:C]
    qd = torch.from_numpy(q.astype(np.int32)).to(cuda)
    l0 = torch.from_numpy(np.sort(limb0).astype(np.int32)).to(cuda)
    got = TI.tiered_route(qd, l0, 7, 12)
    want = TI.tiered_route_plain(qd, l0, 7, 12)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b.cpu())


@pytest.mark.parametrize("C,arm", [(4, "tiered_route"),
                                   (7, "tiered_route"),
                                   (8, "tiered_route.global"),
                                   (11_999, "tiered_route.global"),
                                   (12_000, "tiered_route.global"),
                                   (20_011, "tiered_route.global")])
def test_tiered_route_kernel_arms(cuda, C, arm):
    """K7's two arms on either side of the shared arm's chunk limit and
    past its shared-memory capacity (12,000 chunks, ROADMAP F2): the
    arm's counter moves, and the routed arrays and cuts equal the plain
    version's exactly; windows fall below the first chunk, on chunk
    starts and past the last one."""
    from kasa_tpu_torch import kernels
    from kasa_tpu_torch.match import tiered as TI
    rng = np.random.default_rng(C)
    M = 300_007
    limb0 = np.sort(rng.choice(np.arange(1 << 20, 1 << 30, 1 << 14), C,
                               replace=False))
    q = rng.integers(0, 1 << 30, size=(M, 2), dtype=np.int64)
    # a third of the windows sit on a chunk's first limb0, a thousand
    # below the first chunk
    on = rng.random(M) < 0.3
    q[on, 0] = limb0[rng.integers(0, C, size=int(on.sum()))]
    q[:1000, 0] = rng.integers(0, limb0[0], size=1000)
    bad = rng.random(M) < 0.2
    q[bad, 1] |= 30 << (5 * rng.integers(0, 6, size=int(bad.sum())))
    qd = torch.from_numpy(q.astype(np.int32)).to(cuda)
    l0 = torch.from_numpy(limb0.astype(np.int32)).to(cuda)
    kernels.reset_counts()
    got = TI.tiered_route(qd, l0, 7, 12)
    assert kernels.COUNTS[arm] == 1
    want = TI.tiered_route_plain(qd, l0, 7, 12)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b.cpu())
    # no window at all: every cut is 0
    empty = TI.tiered_route(qd[:0], l0, 7, 12)[3]
    assert int(empty.abs().sum()) == 0


def _tier_chunks(tmp_path):
    """The port's chunk tables of tests/test_turbo.py's tiers index (T =
    4, 13, 30 on the device, 61, 201 on the host) in >= 4 chunks, and
    queries over it."""
    from kasa_tpu_torch.index import artifacts
    from kasa_tpu_torch.match.tiered import TieredTurboDispatch
    from test_turbo import _index_with_tiers, S
    limbs, taxids, hot = _index_with_tiers(n=30_000,
                                           heavy_ts=(3, 12, 29, 60, 200))
    idx = str(tmp_path / "kIdx")
    artifacts.write_index(idx, limbs, taxids, 12)
    disp = TieredTurboDispatch(idx, limbs, taxids.astype(np.int32), 12, 7,
                               12, S, 7000, torch.device("cpu"),
                               cache_dir=str(tmp_path / "cache"))
    assert len(disp.chunks) >= 4
    rng = np.random.default_rng(2)
    R, kpr = 64, 36
    q = limbs[rng.integers(0, len(limbs), size=R * kpr)].copy()
    miss = rng.random(R * kpr) < 0.3
    q[miss, 1] ^= (rng.integers(1, 31, size=int(miss.sum()))
                   .astype(np.int32) << 5)
    for i in range(R):
        q[i * kpr + 3] = hot[i % len(hot)]
    return disp, np.ascontiguousarray(q), R, kpr, S


@pytest.mark.parametrize("case", ["chunks", "short_steps",
                                  "above_every_row"])
def test_tiered_pass_kernel(cuda, tmp_path, case):
    """K8 over every chunk against the plain version, on the windows K7
    routed: the T1 keys and big flags identical, the score rows and
    counts within the contract (atomics add in another order); the
    search from the chunk's prefix table (built by K8's own kernel, held
    to tiered_prefix_plain), one launch a chunk; windows above every row
    of the unpadded chunk, where the fixed bisect ends at n + 1; and a
    step count one short of the chunk's bit length refused."""
    from kasa_tpu_torch import kernels
    from kasa_tpu_torch.match import tiered as TI
    disp, q_np, R, kpr, S = _tier_chunks(tmp_path)
    nk = 6
    steps = disp.num_steps
    sizes = [b - a for a, b in disp.chunks]
    if case == "above_every_row":
        # the last window of every read above the last key of the largest
        # chunk, which has no pad row, and routed to it
        last = int(disp.key64[disp.chunks[sizes.index(max(sizes))][1] - 1])
        assert last & ((1 << 30) - 1) < (1 << 30) - 1
        q_np[kpr - 1::kpr, 0] = last >> 30
        q_np[kpr - 1::kpr, 1] = (1 << 30) - 1
    q = torch.from_numpy(q_np).to(cuda)
    l0 = disp.chunk_limb0.to(cuda)
    qr, vbr, posr, cuts = TI.tiered_route(q, l0, 7, 12)
    w = disp.weights.to(cuda)
    masks = disp.masks.to(cuda)
    m = R * kpr
    st = [(torch.full((m + 1, nk), TI.SENT, dtype=torch.int32, device=cuda),
           torch.zeros(R * S + 1, device=cuda),
           torch.zeros(nk * S + 1, device=cuda),
           torch.zeros(R + 1, dtype=torch.int32, device=cuda))
          for _ in range(2)]
    ends = cuts.tolist()[1:] + [m]
    kernels.reset_counts()
    for ci in range(len(disp.chunks)):
        with np.load(disp._chunk_file(ci)) as z:
            tabs = tuple(torch.from_numpy(z[f]).to(cuda)
                         for f in TI.TIERED_FIELDS)
        pfx = kernels.tiered_prefix(tabs[0])
        assert torch.equal(pfx.cpu(), TI.tiered_prefix_plain(tabs[0]).cpu())
        tabs += (pfx,)
        lo, hi = int(cuts[ci]), ends[ci]
        if case == "short_steps":
            with pytest.raises(ValueError, match="do not cover"):
                TI.tiered_pass(tabs, w, qr, vbr, posr, lo, hi, *st[0],
                               steps - 1, disp.msteps, masks, disp.full, S,
                               kpr)
        TI.tiered_pass(tabs, w, qr, vbr, posr, lo, hi, *st[0], steps,
                       disp.msteps, masks, disp.full, S, kpr)
        TI.tiered_pass_plain(tabs, w, qr, vbr, posr, lo, hi, *st[1], steps,
                             disp.msteps, masks, disp.full, S, kpr)
        assert torch.equal(st[0][0].cpu(), st[1][0].cpu())
        assert torch.equal(st[0][3].cpu(), st[1][3].cpu())
        _close(st[0][1], st[1][1])
        _close(st[0][2], st[1][2])
    n = disp.chunk_pad
    chunks = len(disp.chunks)
    assert kernels.COUNTS["tiered_pass"] == chunks
    assert kernels.COUNTS["tiered_pass.prefix"] == chunks
    assert int(st[1][3].sum()) > 0 and int((st[1][1] > 0).sum()) > 80
    if case == "above_every_row":
        assert max(sizes) == n


def test_additive_finish_kernel(cuda, tmp_path):
    """K3 pre with every run kept (cw = SW, no payloads) and post's
    additive arm against the plain versions, on pass outputs and on
    random extremes (over WOUT T1 taxa, over min(S, 256) multi taxa)."""
    from kasa_tpu_torch.match import tiered as TI
    from kasa_tpu_torch.match import turbo as PT
    disp, q_np, R, kpr, S = _tier_chunks(tmp_path)
    nk = 6
    q = torch.from_numpy(q_np)
    qr, vbr, posr, cuts = TI.tiered_route_plain(q, disp.chunk_limb0, 7, 12)
    m = R * kpr
    skey = torch.full((m + 1, nk), TI.SENT, dtype=torch.int32)
    sflat, cflat = torch.zeros(R * S + 1), torch.zeros(nk * S + 1)
    big = torch.zeros(R + 1, dtype=torch.int32)
    ends = cuts.tolist()[1:] + [m]
    for ci in range(len(disp.chunks)):
        with np.load(disp._chunk_file(ci)) as z:
            tabs = tuple(torch.from_numpy(z[f]) for f in TI.TIERED_FIELDS)
        TI.tiered_pass_plain(tabs, disp.weights, qr, vbr, posr,
                             int(cuts[ci]), ends[ci], skey, sflat, cflat,
                             big, disp.num_steps, disp.msteps, disp.masks,
                             disp.full, S, kpr)
    rng = np.random.default_rng(3)
    S2, R2 = 600, 48
    t1 = np.arange((R2 * kpr + 1) * nk).reshape(-1, nk) % S2
    hit = rng.random(t1.shape) < 0.3
    sk2 = np.where(hit, t1 * 8 + np.arange(nk), PT.SENT).astype(np.int32)
    dens = np.where(np.arange(R2) % 5 == 0, 0.6, 0.05)
    sf2 = np.where(rng.random((R2, S2)) < dens[:, None],
                   rng.random((R2, S2)), 0.0).astype(np.float32)
    cases = [(skey, sflat, cflat, big, R, S),
             (torch.from_numpy(sk2),
              torch.from_numpy(np.r_[sf2.reshape(-1), 0].astype(np.float32)),
              torch.from_numpy(rng.random(nk * S2 + 1).astype(np.float32)),
              torch.from_numpy((rng.random(R2 + 1) < 0.2).astype(np.int32)),
              R2, S2)]
    w = disp.weights.to(cuda)
    for sk, sf, cf, bg, RR, SS in cases:
        sk, sf, cf, bg = (x.to(cuda) for x in (sk, sf, cf, bg))
        SW = kpr * nk
        pre = PT.turbo_reads_pre(sk[:RR * kpr].view(RR, SW), None, cw=SW,
                                 num_species=SS)
        pre2 = PT.turbo_reads_pre_plain(sk[:RR * kpr].view(RR, SW), None,
                                        cw=SW)
        assert pre[3] is None and pre[4] is None
        for a, b in zip(pre[:3], pre2[:3]):
            assert torch.equal(a.cpu(), b.cpu())
        accs = [(torch.ones((nk, SS), device=cuda),
                 torch.ones((nk, SS), dtype=torch.int32, device=cuda))
                for _ in range(2)]
        cap = 4 * RR
        p1 = TI.tiered_finish(sk, sf, cf, bg, w, *accs[0], RR, kpr, cap)
        ck, cc = pre2[0], pre2[1]
        p2 = PT.turbo_reads_post_plain(
            ck, cc, bg[:RR] > 0, sf[:RR * SS].view(RR, SS), w, *accs[1],
            torch.zeros(2, dtype=torch.int32, device=cuda), cap,
            wm=min(SS, 256), additive=True, cadd=cf[:nk * SS])
        ints = torch.ones(p1[0].numel(), dtype=torch.bool)
        ints[2 * RR + 1:2 * RR + 2 * cap:2] = False
        assert torch.equal(p1[0].cpu()[ints], p2[0].cpu()[ints])
        assert torch.equal(p1[1].cpu(), p2[1].cpu())
        _close(p1[2], p2[2])
        _close(p1[0].cpu()[~ints].view(torch.float32),
               p2[0].cpu()[~ints].view(torch.float32))
        assert torch.equal(accs[0][1].cpu(), accs[1][1].cpu())
        _close(accs[0][0], accs[1][0])
        flags = p2[0][RR:2 * RR].cpu()
        assert bool((flags & 2).any())


@pytest.mark.parametrize("wout", [300, 2000])
def test_reads_post_wide_lists(cuda, wout):
    """K3 post with hit lists wider than its shared arrays (a long batch's,
    turbo.batch_budgets): T1 runs and dense multi rows of up to ~1,000
    taxa a read against the plain version; with lists as wide as the
    S = 2,000 taxa only the count-flagged reads are flagged for lists."""
    from kasa_tpu_torch.match import turbo as PT
    rng = np.random.default_rng(wout)
    R, S, nk, cw = 24, 2000, 6, 160
    ck = np.full((R, cw), PT.SENT, np.int32)
    cc = np.zeros((R, cw), np.int32)
    for r in range(R):
        n = int(rng.integers(0, 2 * cw))
        keys = np.unique(rng.integers(0, S, n) * 8
                         + rng.integers(0, nk, n))[:cw]
        ck[r, :len(keys)] = keys
        cc[r, :len(keys)] = rng.integers(1, 50, len(keys))
    dens = rng.random((R, 1)) * 0.5
    dm = np.where(rng.random((R, S)) < dens, rng.random((R, S)), 0.0)
    ofc = rng.random(R) < 0.15
    args = [torch.from_numpy(x).to(cuda) for x in
            (ck, cc, ofc, dm.astype(np.float32))]
    w = torch.rand(nk).to(cuda)
    for cap in (4 * R, R * wout):
        outs = []
        for fn in (PT.turbo_reads_post, PT.turbo_reads_post_plain):
            ca = torch.zeros((nk, S), device=cuda)
            cu = torch.zeros((nk, S), dtype=torch.int32, device=cuda)
            p = fn(*args, w, ca, cu, torch.zeros(2, dtype=torch.int32,
                                                 device=cuda), cap,
                   wm=wout, wout=wout)
            outs.append([t.cpu() for t in (*p, ca, cu)])
        (p1, ht1, hk1, ca1, cu1), (p2, ht2, hk2, ca2, cu2) = outs
        ints = torch.ones(p1.numel(), dtype=torch.bool)
        ints[2 * R + 1:2 * R + 2 * cap:2] = False
        assert torch.equal(p1[ints], p2[ints])
        assert torch.equal(ht1, ht2) and torch.equal(cu1, cu2)
        _close(p1[~ints].view(torch.float32), p2[~ints].view(torch.float32))
        _close(hk1, hk2)
        _close(ca1, ca2)
        ofl = (p2[R:2 * R] & 2) > 0
        if wout >= S:
            assert torch.equal(ofl, torch.from_numpy(ofc))
        else:
            assert bool((ofl & ~torch.from_numpy(ofc)).any())
        assert int(p2[:R].max()) > 256


def _classic_case(case, limbs, taxids, highest_k, M, R, S, kpr):
    """The windows, read ids, flags and read count of one K9 case."""
    from test_torch_classic import _queries
    from kasa_tpu_torch.kernels import ids_ascend
    q, rid, valid, _ = _queries(limbs, highest_k, M, R, seed=S)
    if case == "one_taxon":
        # every window of read r drawn from the entries of one taxon of
        # the heavy groups (repeated limbs)
        rng = np.random.default_rng(5)
        dup = np.zeros(len(limbs), bool)
        same_next = np.all(limbs[1:] == limbs[:-1], axis=1)
        dup[1:] |= same_next
        dup[:-1] |= same_next
        taxa = np.unique(taxids[dup])
        for r in range(R):
            rows = np.nonzero(taxids == taxa[r % len(taxa)])[0]
            q[r * kpr:(r + 1) * kpr] = limbs[rng.choice(rows, size=kpr)]
        valid[:] = True
    elif case == "ascending":
        # ids ascend with gaps: odd reads and the last read have no window
        rid = rid * 2
        R = 2 * R + 1
    elif case == "split_run":
        # read 0's second half moved to the end: two runs of read 0
        half = (M // R) // 2
        order = np.r_[np.arange(half), np.arange(M // R, M),
                      np.arange(half, M // R)]
        q, rid, valid = q[order], rid[order], valid[order]
    elif case == "shuffled":
        order = np.random.default_rng(6).permutation(M)
        q, rid, valid = q[order], rid[order], valid[order]
    return q, rid, valid, R, kpr == 0 and ids_ascend(torch.from_numpy(rid))


@pytest.mark.parametrize("highest_k,min_k,max_k,S,kpr,case", [
    (12, 4, 12, 64, 0, ""), (12, 4, 12, 64, 32, ""), (25, 12, 25, 64, 0, ""),
    (25, 12, 25, 64, 32, ""), (25, 12, 25, 4000, 32, ""),
    (25, 1, 6, 64, 0, ""), (12, 7, 12, 64, 64, "one_taxon"),
    (25, 12, 25, 64, 0, "ascending"), (25, 1, 25, 64, 32, ""),
    (25, 1, 25, 64, 0, "ascending"), (12, 7, 12, "cap", 32, ""),
    (12, 7, 12, "cap+1", 32, ""), (12, 7, 12, "cap", 0, "ascending"),
    (12, 7, 12, 64, 0, "split_run"), (12, 7, 12, 64, 0, "shuffled"),
    (25, 12, 25, 4000, 0, "shuffled")],
    ids=["L2_scatter", "L2_uniform", "L5_scatter", "L5_uniform",
         "L5_global_counts", "L5_k1_6", "one_taxon_reads",
         "L5_14_levels_ascending", "L5_25_levels_uniform",
         "L5_25_levels_ascending", "S_at_row_capacity",
         "S_above_row_capacity", "S_at_row_capacity_ascending",
         "read_split_over_two_runs", "ids_shuffled",
         "L5_global_arm_global_counts"])
def test_classic_classify_kernel(cuda, highest_k, min_k, max_k, S, kpr,
                                 case):
    """K9 against its plain version: identical hit cells, counts_unique
    and tail_pairs, floats within the contract; each case asserts the
    arm it takes (kernels.classic_arm on the ids, which the wrapper
    checks itself; its own counter): the local arm, its counts in device
    memory, for the uniform layout and read ids that ascend (with reads
    of no window), up to S at the shared-row capacity; the global arm for
    ids that do not ascend (a read in two runs, shuffled windows), one
    species above the capacity, with and without the per-block shared
    counts (8 * numK * S bytes fit or not: L5_global_arm_global_counts
    does not)."""
    from test_torch_classic import _index
    from kasa_tpu_torch import kernels
    from kasa_tpu_torch.match.device import (StackedTables, classify_batch,
                                             classify_batch_plain)
    from kasa_tpu_torch.match.join import DeviceIndex
    budget = kernels.classic_smem_budget(cuda)
    if isinstance(S, str):
        S = budget // 8 + (S == "cap+1")
    limbs, taxids = _index(highest_k, 20_000, S, seed=highest_k + min_k)
    t = StackedTables.build(DeviceIndex(
        limbs, taxids, {i: i for i in range(S)}, highest_k, min_k, max_k,
        S, cuda))
    R = 64 if case == "one_taxon" else 128
    M = R * kpr if case == "one_taxon" else 4096
    q, rid, valid, R, ascending = _classic_case(case, limbs, taxids,
                                                highest_k, M, R, S, kpr)
    q, rid, valid = (torch.from_numpy(a).to(cuda) for a in (q, rid, valid))
    want_arm = kernels.classic_arm(S, kpr > 0 or ascending, budget)
    assert want_arm == ("global" if case in ("split_run", "shuffled")
                        or S > budget // 8 else "local")
    kernels.reset_counts()
    s1, ca1, cu1, t1 = classify_batch(t, q, rid, valid, R, 2, kpr)
    s2, ca2, cu2, t2 = classify_batch_plain(t, q, rid, valid, R, 2, kpr)
    torch.cuda.synchronize()
    assert kernels.COUNTS["classic_classify"] == (want_arm == "local")
    assert kernels.COUNTS["classic_classify.global"] == (want_arm
                                                         == "global")
    assert torch.equal(s1 > 0, s2 > 0) and int(cu2.sum()) > 0
    _close(s1, s2)
    _close(ca1, ca2)
    assert torch.equal(cu1, cu2)
    assert int(t1) == t2 > 0


def test_sloppy_arm_kernel(cuda):
    """K1's sloppy arm (-j) against encode + sloppy_reduce_plain, DNA and
    protein rows."""
    from kasa_tpu_torch.core import encode as E
    rng = np.random.default_rng(9)
    mat = torch.from_numpy(rng.choice(np.frombuffer(b"ACGTXZacgt^", np.uint8),
                                      size=(300, 176))).to(cuda)
    lut = torch.from_numpy(E.build_codon_code_lut().astype(np.int32)).to(cuda)
    aas = torch.from_numpy(E.aas_code_lut()).to(cuda)
    for w, protein in ((141, False), (165, True)):
        got = E.encode_windows(mat, lut, w, protein=protein, aas_lut=aas)
        want = E.sloppy_reduce_plain(
            E.encode_windows_plain(mat, lut, w, protein=protein), aas)
        assert torch.equal(got.cpu(), want.cpu())


@pytest.mark.parametrize("highest_k,min_k,max_k", [
    (12, 1, 12), (12, 7, 12), (25, 20, 25), (25, 12, 25)],
    ids=["L2_k1_12", "L2_k7_12", "L5_k20_25", "L5_k12_25"])
def test_join_kernels(cuda, highest_k, min_k, max_k):
    """K12, K10 and K11 in the join engine's order against their plain
    versions: the sort identical (both order by (limbs..., read id)),
    every K10 output identical, K11's hit cells identical and its scores
    within the contract."""
    from test_torch_join import _index, _queries
    from kasa_tpu_torch.match import join as J
    from kasa_tpu_torch.match.device import StackedTables
    S, R = 9, 300
    limbs, taxids = _index(highest_k, 20_000, S, seed=highest_k + min_k)
    t = StackedTables.build(J.DeviceIndex(
        limbs, taxids, {i: i for i in range(S)}, highest_k, min_k, max_k,
        S, cuda))
    q, rid = _queries(limbs, highest_k, 30_000, R, seed=min_k)
    q, rid = torch.from_numpy(q).to(cuda), torch.from_numpy(rid).to(cuda)
    qs, rs = J.sort_queries(q, rid, R)
    pq, pr = J.sort_queries_plain(q, rid)
    torch.cuda.synchronize()
    assert torch.equal(qs.cpu(), pq.cpu()) and torch.equal(rs.cpu(), pr.cpu())
    got = J.join_match(t, qs)
    want = J.join_match_plain(t, qs)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())
    matched, g, T, start, ok = want
    valid = matched & ok
    assert int(valid.sum()) > 0 and int((T > 1).sum()) > 0
    s1 = J.join_scatter(t, valid, T, start, rs, R)
    s2 = J.join_scatter_plain(t, valid, T, start, rs, R)
    torch.cuda.synchronize()
    assert torch.equal(s1 > 0, s2 > 0)
    _close(s1, s2)


@pytest.mark.parametrize("M,L,R", [(1, 2, 1), (1024, 2, 1025),
                                   (70_001, 5, 8192), (300_000, 2, 65_536)])
def test_query_sort_kernel(cuda, M, L, R):
    """K12 on random 30-bit limbs (many equal windows) and read ids of
    0..31 bits, at tile edges: identical to the plain stable sorts."""
    from kasa_tpu_torch.match.join import sort_queries, sort_queries_plain
    rng = np.random.default_rng(M)
    q = rng.integers(0, 1 << 30, size=(M, L), dtype=np.int64)
    q[:, 0] &= 0x3FFFF000
    q[::3] = q[0]
    q = torch.from_numpy(q.astype(np.int32)).to(cuda)
    rid = torch.from_numpy(rng.integers(0, R, size=M).astype(np.int32)) \
        .to(cuda)
    got = sort_queries(q, rid, R)
    want = sort_queries_plain(q, rid)
    torch.cuda.synchronize()
    assert torch.equal(got[0].cpu(), want[0].cpu())
    assert torch.equal(got[1].cpu(), want[1].cpu())


def _sweep_tile(L):
    """Rows per tile of the one-sweep passes (csrc/radix.cuh sweep_tile)."""
    return 256 * min(12, 48 // (L + 1))


@pytest.mark.parametrize("L", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("size", ["one", "tile-1", "tile", "tile+1", "many",
                                  "equal"])
def test_query_sort_ascending_ids_kernel(cuda, size, L):
    """K12 as the join path calls it, sort_queries(..., ids_ascending=True):
    a stable sort by the limbs alone over read ids that ascend, identical
    to the plain (limbs, read id) sort at M = 1, at a tile's edges, over
    many tiles, and with every key equal (each tile's look-back then
    waits on one digit of every earlier tile)."""
    from kasa_tpu_torch import kernels
    from kasa_tpu_torch.match.join import sort_queries, sort_queries_plain
    tile = _sweep_tile(L)
    M = {"one": 1, "tile-1": tile - 1, "tile": tile, "tile+1": tile + 1,
         "many": 37 * tile + 5, "equal": 37 * tile + 5}[size]
    rng = np.random.default_rng(M + L)
    q = rng.integers(0, 1 << 30, size=(M, L), dtype=np.int64)
    q[:, 0] &= 0x3FFFF000
    q[::3] = q[0]
    if size == "equal":
        q[:] = q[0]
    R = max(M // 100, 1)
    rid = np.sort(rng.integers(0, R, size=M)).astype(np.int32)
    qd = torch.from_numpy(q.astype(np.int32)).to(cuda)
    rd = torch.from_numpy(rid).to(cuda)
    n = kernels.COUNTS["query_sort"]
    got = sort_queries(qd, rd, R, ids_ascending=True)
    assert kernels.COUNTS["query_sort"] == n + 1
    want = sort_queries_plain(qd, rd)
    torch.cuda.synchronize()
    assert torch.equal(got[0].cpu(), want[0].cpu())
    assert torch.equal(got[1].cpu(), want[1].cpu())


# ---------------------------------------------------------------------------
# long read lines: the long arms of K3 (pre) and K5, K6's global table

def _dup_windows(R, kpr, L, seed):
    """(R * kpr, L) int32 windows with few distinct first limbs and a
    third of them copies of others in the same read."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 1 << 30, size=(R * kpr, L), dtype=np.int32)
    q[:, 0] &= 0x3F
    src = rng.integers(0, R * kpr, size=R * kpr // 3)
    q[(src // kpr) * kpr + rng.integers(0, kpr, size=len(src))] = q[src]
    return q


@pytest.mark.parametrize("L,kpr", [(2, 4097), (2, 9000), (5, 5000)])
def test_dedup_kernel_long_arm(cuda, L, kpr):
    """K5 above 4,096 windows per read: the shared-memory radix arm, the
    same sorted layout and poisoned duplicates as the plain version."""
    from kasa_tpu_torch import kernels
    from kasa_tpu_torch.match import turbo as PT
    R = 6
    qd = torch.from_numpy(_dup_windows(R, kpr, L, kpr + L)).to(cuda)
    n = kernels.COUNTS["dedup.long"]
    got = PT.dedup_windows(qd, R, kpr)
    assert kernels.COUNTS["dedup.long"] == n + 1
    want = PT.dedup_windows_plain(qd, R, kpr)
    assert torch.equal(got.cpu(), want.cpu())
    assert int((want == PT.POISON_LIMB).all(dim=1).sum()) > 0


@pytest.mark.parametrize("L,edge", [(2, "first"), (2, "last"), (2, "over"),
                                    (5, "first"), (5, "last"), (5, "over")])
def test_dedup_kernel_arms(cuda, L, edge):
    """K5 at the edges of its shared-memory arm: 4,097 windows a read, the
    last kpr whose rows and indices fit one block
    (kernels.dedup_long_max), and one more, which takes the global arm;
    each launch counted under its own arm only, each identical to the
    plain version."""
    from kasa_tpu_torch import kernels
    from kasa_tpu_torch.match import turbo as PT
    last = kernels.dedup_long_max(L, cuda)
    assert PT.DEDUP_CAP < last < 65_535
    kpr = {"first": PT.DEDUP_CAP + 1, "last": last, "over": last + 1}[edge]
    arm = "dedup.global" if edge == "over" else "dedup.long"
    R = 3
    qd = torch.from_numpy(_dup_windows(R, kpr, L, kpr)).to(cuda)
    before = dict(kernels.COUNTS)
    got = PT.dedup_windows(qd, R, kpr)
    moved = {k: v - before[k] for k, v in kernels.COUNTS.items()
             if v != before[k]}
    assert moved == {arm: 1}
    want = PT.dedup_windows_plain(qd, R, kpr)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want.cpu())
    assert int((want == PT.POISON_LIMB).all(dim=1).sum()) > 0


LONG_ARMS = {"long_smem": "turbo_reads.long_smem",
             "global": "turbo_reads.long"}


def _force_long_arm(monkeypatch, arm):
    """K3 pre's global arm on rows whose key range fits the histogram:
    a card whose histogram holds no key."""
    from kasa_tpu_torch import kernels
    if arm == "global":
        monkeypatch.setattr(kernels, "reads_hist_max", lambda *a: 0)
    return LONG_ARMS[arm]


@pytest.mark.parametrize("arm", list(LONG_ARMS))
@pytest.mark.parametrize("SW,cw", [(4097, 160), (30_000, 160),
                                   (5000, 5000), (4000, 4500)],
                         ids=["just_over", "long", "additive", "cw_over"])
def test_turbo_reads_pre_long_arm(cuda, monkeypatch, SW, cw, arm):
    """K3 pre's long arms, the shared-memory histogram and the global
    radix passes: slot keys of few taxa (long runs) with sentinels and
    multi payloads between them, a row of sentinels only and a row of
    one key; cw = SW is the tiered finish's additive arm (every run kept,
    no payloads)."""
    from kasa_tpu_torch import kernels
    from kasa_tpu_torch.match import turbo as PT
    rng = np.random.default_rng(SW + cw)
    R, S = 12, 300
    keys = (rng.integers(0, S, size=(R, SW)) * 8
            + rng.integers(0, 6, size=(R, SW))).astype(np.int32)
    keys[rng.random((R, SW)) < 0.3] = PT.SENT
    keys[0] = PT.SENT
    keys[1] = 7
    mpay = np.where(rng.random((R, SW)) < 0.2,
                    rng.integers(0, 1 << 20, size=(R, SW)), -1)
    skey = torch.from_numpy(keys).to(cuda)
    mp = None if cw == SW else torch.from_numpy(mpay.astype(np.int32)) \
        .to(cuda)
    counter = _force_long_arm(monkeypatch, arm)
    kernels.reset_counts()
    got = PT.turbo_reads_pre(skey, mp, cw, num_species=S)
    assert {k: v for k, v in kernels.COUNTS.items() if v} == {counter: 1}
    want = PT.turbo_reads_pre_plain(skey, mp, cw)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a.cpu(), b.cpu())
    assert int(want[2].max()) > min(cw, 160)


@pytest.mark.parametrize("arm", list(LONG_ARMS))
def test_long_batch_step(cuda, monkeypatch, arm):
    """The whole batch step (K2, K3 pre's long arms, K4, the dense fold,
    K3 post) on reads of 700 windows x 6 levels (4,200 slots) against the
    plain step on the same tables."""
    from kasa_tpu_torch import kernels
    from kasa_tpu_torch.match import turbo as PT
    from test_turbo import _index_with_tiers, S
    limbs, taxids, hot = _index_with_tiers()
    arrays, meta = PT.build_tables_np(limbs, taxids.astype(np.int32), 12, 7,
                                      12, S)
    rng = np.random.default_rng(700)
    R, kpr = 16, 700
    q = limbs[rng.integers(0, len(taxids), size=R * kpr)].copy()
    outs = []
    counter = _force_long_arm(monkeypatch, arm)
    kernels.reset_counts()
    for dev in (cuda, torch.device("cpu")):
        tt = PT.tables_from_numpy(arrays, meta, dev)
        ca = torch.zeros((6, S), device=dev)
        cu = torch.zeros((6, S), dtype=torch.int32, device=dev)
        p, ht, hk = PT.turbo_core(tt, torch.from_numpy(q).to(dev), R, kpr,
                                  ca, cu, 160 * R)
        outs.append([t.cpu() for t in (p, ht, hk, ca, cu)])
    assert kernels.COUNTS[counter] == 1
    assert sum(kernels.COUNTS[c] for c in LONG_ARMS.values()) == 1
    (p1, ht1, hk1, ca1, cu1), (p2, ht2, hk2, ca2, cu2) = outs
    ints = torch.ones(p1.numel(), dtype=torch.bool)
    ints[2 * R + 1:2 * R + 2 * 160 * R:2] = False
    assert torch.equal(p1[ints], p2[ints])
    assert torch.equal(ht1, ht2) and torch.equal(cu1, cu2)
    _close(hk1, hk2)
    _close(ca1, ca2)
    assert int(p2[:R].sum()) > 0


@pytest.mark.parametrize("edge", ["fill", "over"])
def test_turbo_reads_pre_hist_capacity(cuda, edge):
    """K3 pre on long rows whose key range is the widest the
    shared-memory long arm's histogram holds (kernels.reads_hist_max)
    and one past it, which takes the global arm."""
    from kasa_tpu_torch import kernels
    from kasa_tpu_torch.match import turbo as PT
    cw = PT.CW
    kmax = kernels.reads_hist_max(cuda) - (edge == "fill")
    rng = np.random.default_rng(kmax)
    R, SW = 3, 5000
    keys = rng.integers(max(kmax - 3000, 0), kmax, size=(R, SW)) \
        .astype(np.int32)
    keys[rng.random((R, SW)) < 0.4] = PT.SENT
    keys[0, 17] = kmax
    keys[1, 40:200] = kmax - 8
    mpay = np.where(keys == PT.SENT, rng.integers(0, 1 << 20, size=(R, SW)),
                    -1).astype(np.int32)
    skey = torch.from_numpy(keys).to(cuda)
    mp = torch.from_numpy(mpay).to(cuda)
    arm = "turbo_reads.long_smem" if edge == "fill" else "turbo_reads.long"
    kernels.reset_counts()
    got = kernels.turbo_reads_pre(skey, mp, PT.SENT, cw, kmax + 1)
    assert kernels.COUNTS[arm] == 1
    want = PT.turbo_reads_pre_plain(skey, mp, cw)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b.cpu())
    assert int(want[2].max()) > cw


@pytest.mark.parametrize("S", [2048, 10_002])
def test_turbo_reads_short_arm(cuda, S):
    """K3 pre's short arm at SW = 1,692 (282 windows at six levels under
    --six) on rows of no real key up to all of them, with keys of two and
    of three 8-bit digits, and K3 post on its runs: identical to the
    plain versions."""
    from kasa_tpu_torch import kernels
    from kasa_tpu_torch.match import turbo as PT
    rng = np.random.default_rng(S)
    R, SW = 64, 1692
    keys = (rng.integers(0, S, size=(R, SW)) * 8
            + rng.integers(0, 6, size=(R, SW))).astype(np.int32)
    # rows from no real key up to all of them
    drop = rng.random((R, SW)) < np.linspace(0.0, 1.0, R)[:, None]
    keys[drop] = PT.SENT
    keys[:, ::7] = keys[:, :1]
    skey = torch.from_numpy(keys).to(cuda)
    mpay = torch.from_numpy(np.where(drop, rng.integers(0, 1 << 20, size=(
        R, SW)), -1).astype(np.int32)).to(cuda)
    kernels.reset_counts()
    got = PT.turbo_reads_pre(skey, mpay)
    assert kernels.COUNTS["turbo_reads"] == 1
    want = PT.turbo_reads_pre_plain(skey, mpay)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b.cpu())
    ck, cc, runs, _, _ = want
    ofc = torch.from_numpy(rng.random(R) < 0.2).to(cuda)
    dm = torch.from_numpy(np.where(rng.random((R, S)) < 0.03,
                                   rng.random((R, S)), 0.0)
                          .astype(np.float32)).to(cuda)
    w = torch.tensor([1.0, 0.9, 0.8, 0.7, 0.6, 0.5], device=cuda)
    diag = torch.tensor([5, 6], dtype=torch.int32, device=cuda)
    cap = 4 * R
    outs = []
    for fn in (PT.turbo_reads_post, PT.turbo_reads_post_plain):
        ca = torch.zeros((6, S), device=cuda)
        cu = torch.zeros((6, S), dtype=torch.int32, device=cuda)
        outs.append((*fn(ck, cc, ofc, dm, w, ca, cu, diag, cap), ca, cu))
    (p1, ht1, hk1, ca1, cu1), (p2, ht2, hk2, ca2, cu2) = outs
    ints = torch.ones(p1.numel(), dtype=torch.bool)
    ints[2 * R + 1:2 * R + 2 * cap:2] = False
    assert torch.equal(p1.cpu()[ints], p2.cpu()[ints])
    assert torch.equal(ht1.cpu(), ht2.cpu()) and torch.equal(cu1.cpu(),
                                                           cu2.cpu())
    _close(hk1, hk2)
    _close(ca1, ca2)


def test_long_batch_one_long_read(cuda):
    """The batch step on 15 reads of 140 windows and one of 7,981 (an 8
    kbp read): every row padded to 47,886 slots, mostly sentinels; K3
    pre takes its shared-memory long arm.  Against the plain step on the
    same tables."""
    from kasa_tpu_torch import kernels
    from kasa_tpu_torch.match import turbo as PT
    from test_turbo import _index_with_tiers, S
    limbs, taxids, _ = _index_with_tiers()
    arrays, meta = PT.build_tables_np(limbs, taxids.astype(np.int32), 12, 7,
                                      12, S)
    rng = np.random.default_rng(7981)
    R, kpr = 16, 7981
    q = limbs[rng.integers(0, len(taxids), size=R * kpr)].copy()
    # windows past a short read's end: '^' letters, which no level takes
    caret = sum(30 << (5 * j) for j in range(6))
    rows = q.reshape(R, kpr, 2)
    rows[1:, 140:] = caret
    outs = []
    kernels.reset_counts()
    for dev in (cuda, torch.device("cpu")):
        tt = PT.tables_from_numpy(arrays, meta, dev)
        ca = torch.zeros((6, S), device=dev)
        cu = torch.zeros((6, S), dtype=torch.int32, device=dev)
        mb, eb, wout = PT.batch_budgets(kpr * 6, S)
        p, ht, hk = PT.turbo_core(tt, torch.from_numpy(q).to(dev), R, kpr,
                                  ca, cu, 160 * R, mb, eb, wout=wout)
        outs.append([t.cpu() for t in (p, ht, hk, ca, cu)])
    assert kernels.COUNTS["turbo_reads.long_smem"] == 1
    assert kernels.COUNTS["turbo_multi"] == 1
    (p1, ht1, hk1, ca1, cu1), (p2, ht2, hk2, ca2, cu2) = outs
    ints = torch.ones(p1.numel(), dtype=torch.bool)
    ints[2 * R + 1:2 * R + 2 * 160 * R:2] = False
    assert torch.equal(p1[ints], p2[ints])
    assert torch.equal(ht1, ht2) and torch.equal(cu1, cu2)
    _close(hk1, hk2)
    _close(ca1, ca2)
    assert int(p2[:R].sum()) > 0


def test_turbo_multi_mid_cut(cuda):
    """K4 under an expansion budget that admits every cold slot below a
    middle T* and then half of T*'s slots, with reads holding a slot above
    T*: flags and diag identical to the plain version, floats within the
    contract; some reads with T* slots admitted and some flagged."""
    from kasa_tpu_torch import kernels
    from kasa_tpu_torch.match import turbo as PT
    from test_turbo import _index_with_tiers, S
    limbs, taxids, hot = _index_with_tiers(
        n=20_000, heavy_ts=(3, 4, 6, 8, 8, 13, 16, 30))
    saved = PT.HOT_SETS
    PT.HOT_SETS = 1
    try:
        arrays, meta = PT.build_tables_np(limbs, taxids.astype(np.int32),
                                          12, 7, 12, S)
    finally:
        PT.HOT_SETS = saved
    rng = np.random.default_rng(47)
    R, kpr = 48, 24
    q = limbs[rng.integers(0, len(taxids), size=R * kpr)].copy()
    for i, kl in enumerate(hot):
        for j in range(3):
            q[(i * 5 + j) * kpr + 4 + j] = kl
    tt = PT.tables_from_numpy(arrays, meta, cuda)
    skey, mpay = PT.turbo_match_plain(torch.from_numpy(q).to(cuda), tt, R,
                                      kpr)
    _, _, runs, mcnt, cp = PT.turbo_reads_pre_plain(skey, mpay)
    valid = torch.arange(cp.shape[1], device=cuda)[None, :] < mcnt[:, None]
    mp = cp[valid].long()
    rid = torch.nonzero(valid)[:, 0]
    row0 = tt.grp2[((mp & 7) * tt.n + (mp >> 3)).clamp(
        max=tt.num_k * tt.n - 1)].long()
    Ts = tt.d_tax4[row0[row0 > 0], 0].long().cpu().numpy()
    rid = rid[row0 > 0].cpu().numpy()
    vals, cnt = np.unique(Ts, return_counts=True)
    mid = [t for t, c in zip(vals, cnt) if c >= 2 and t < vals.max()]
    tstar = int(mid[len(mid) // 2])
    c = int(cnt[vals == tstar][0]) // 2
    eb = int(sum(int(n) * ((int(t) + 3) >> 2) for t, n in zip(vals, cnt)
                 if t < tstar)) + ((tstar + 3) >> 2) * c
    ca1 = torch.zeros((6, S), device=cuda)
    ca2 = torch.zeros((6, S), device=cuda)
    kernels.reset_counts()
    m1 = PT.turbo_multi(cp, mcnt, runs, tt, ca1, PT.MULTI_BUDGET, eb)
    assert kernels.COUNTS["turbo_multi"] == 1
    m2 = PT.turbo_multi_plain(cp, mcnt, runs, tt, ca2, PT.MULTI_BUDGET, eb)
    assert torch.equal(m1[0].cpu(), m2[0].cpu())
    assert torch.equal(m1[4].cpu(), m2[4].cpu())
    for a, b in zip(m1[1:4], m2[1:4]):
        _close(a, b)
    _close(ca1, ca2)
    flagged = m2[0].cpu().numpy()
    assert flagged[np.unique(rid[Ts > tstar])].all()
    star = np.unique(rid[Ts == tstar])
    assert 0 < flagged[star].sum() < len(star)


def test_sparse_fold_global_table(cuda, monkeypatch):
    """K6 with more than 4,096 slots per read: the slot table in global
    scratch instead of shared memory."""
    from kasa_tpu_torch.match import turbo as PT
    from test_turbo import _index_with_tiers, S
    monkeypatch.setattr(PT, "SPARSE_FOLD_S", 8)
    limbs, taxids, hot = _index_with_tiers()
    arrays, meta = PT.build_tables_np(limbs, taxids.astype(np.int32), 12, 7,
                                      12, S)
    tt = PT.tables_from_numpy(arrays, meta, cuda)
    rng = np.random.default_rng(800)
    R, kpr = 8, 800
    q = torch.from_numpy(limbs[rng.integers(0, len(taxids),
                                            size=R * kpr)]).to(cuda)
    skey, mpay = PT.turbo_match_plain(q, tt, R, kpr)
    _, _, runs, mcnt, cp = PT.turbo_reads_pre_plain(skey, mpay)
    ca = torch.zeros((6, S), device=cuda)
    ofc = PT.turbo_multi_plain(cp, mcnt, runs, tt, ca, PT.MULTI_BUDGET,
                               PT.EXP_BUDGET, counts_only=True)[0]
    assert cp.shape[1] > PT.SW_CAP and int(mcnt.max()) > 0
    f1 = PT.sparse_fold(cp, mcnt, ofc, tt)
    f2 = PT.sparse_fold_plain(cp, mcnt, ofc, tt)
    assert torch.equal(f1[0].cpu(), f2[0].cpu())
    assert torch.equal(f1[2].cpu(), f2[2].cpu())
    _close(f1[1], f2[1])


# ---------------------------------------------------------------------------
# K13 sort_dedup

@pytest.mark.parametrize("N,L", [(1, 2), (5000, 2), (1025, 5),
                                 (1 << 20, 5), (3_000_001, 2)])
def test_sort_dedup_kernel(cuda, N, L):
    """K13 on 30-bit limbs with many exact duplicates, rows equal in all
    limbs but one, and taxids at and above 2^31: identical to the plain
    version (the result is unique, so any correct sort gives it)."""
    from kasa_tpu_torch import kernels
    from kasa_tpu_torch.index.build import sort_dedup, sort_dedup_plain
    rng = np.random.default_rng(N + L)
    base = rng.integers(0, 1 << 30, size=(max(N // 4, 1), L), dtype=np.int32)
    limbs = base[rng.integers(0, len(base), N)].copy()
    limbs[rng.random(N) < 0.1, L - 1] ^= 1
    tax = rng.choice(np.array([1, 7, 2**31 - 1, 2**31, 2**32 - 1],
                              np.uint64), N).astype(np.uint32).view(np.int32)
    q = torch.from_numpy(limbs).to(cuda)
    t = torch.from_numpy(tax).to(cuda)
    n = kernels.COUNTS["sort_dedup"]
    got = sort_dedup(q, t)
    assert kernels.COUNTS["sort_dedup"] == n + 1
    want = sort_dedup_plain(q, t)
    assert torch.equal(got[0].cpu(), want[0].cpu())
    assert torch.equal(got[1].cpu(), want[1].cpu())
    assert len(want[1]) <= N


@pytest.mark.parametrize("counts_only", [False, True],
                         ids=["dense", "counts_only"])
@pytest.mark.parametrize("budget_drop", [False, True])
def test_turbo_multi_split_kernel(cuda, budget_drop, counts_only):
    """K4 split (the mesh's flag_reduce between its cut and expansion)
    against the plain version's split, with a reduce that ORs in every
    fifth read as another shard would, on the dense and the counts-only
    arm (the expansion's recount of the rows used in diag[1] included);
    flag_reduce=None stays the fused launch."""
    from kasa_tpu_torch import kernels
    from kasa_tpu_torch.match import turbo as PT
    arrays, meta, q_np, R, kpr, eb = _tiers(budget_drop)
    tt = PT.tables_from_numpy(arrays, meta, cuda)
    q = torch.from_numpy(q_np).to(cuda)
    S, nk = meta["num_species"], 6
    skey, mpay = PT.turbo_match_plain(q, tt, R, kpr)
    ck, cc, runs, mcnt, cp = PT.turbo_reads_pre_plain(skey, mpay)
    extra = torch.zeros(R, dtype=torch.bool, device=cuda)
    extra[::5] = True
    seen = []

    def reduce(f):
        seen.append(f.clone())
        return f | extra
    ca1 = torch.zeros((nk, S), device=cuda)
    ca2 = torch.zeros((nk, S), device=cuda)
    kernels.reset_counts()
    m1 = PT.turbo_multi(cp, mcnt, runs, tt, ca1, PT.MULTI_BUDGET,
                        eb or PT.EXP_BUDGET, counts_only=counts_only,
                        flag_reduce=reduce)
    assert kernels.COUNTS["turbo_multi"] == 1
    assert kernels.COUNTS["turbo_multi.split"] == 1
    m2 = PT.turbo_multi_plain(cp, mcnt, runs, tt, ca2, PT.MULTI_BUDGET,
                              eb or PT.EXP_BUDGET, counts_only=counts_only,
                              flag_reduce=reduce)
    assert torch.equal(seen[0].cpu(), seen[1].cpu())    # the cut's flags
    assert torch.equal(m1[0].cpu(), m2[0].cpu())
    assert torch.equal(m1[4].cpu(), m2[4].cpu())
    for a, b in zip(m1[1:4], m2[1:4]):
        assert (a is None) == counts_only == (b is None)
        if not counts_only:
            _close(a, b)
    _close(ca1, ca2)
    assert counts_only or bool((m1[1][extra] == 0).all())
    ca3 = torch.zeros((nk, S), device=cuda)
    m3 = PT.turbo_multi(cp, mcnt, runs, tt, ca3, PT.MULTI_BUDGET,
                        eb or PT.EXP_BUDGET, counts_only=counts_only)
    assert kernels.COUNTS["turbo_multi.split"] == 1
    assert torch.equal(m3[0].cpu(), seen[0].cpu())


def _shard_lists(ip, R, wout, seed):
    rng = np.random.default_rng(seed)
    hts = np.full((ip, R, wout), 2 ** 31 - 1, np.int32)
    hks = np.zeros((ip, R, wout), np.float32)
    for s in range(ip):
        n = rng.integers(0, wout + 1, size=R)
        for r in range(R):
            taxa = np.sort(rng.choice(3 * wout, size=n[r], replace=False))
            hts[s, r, :n[r]] = taxa
            hks[s, r, :n[r]] = rng.random(n[r]).astype(np.float32) * 3
    return hts, hks, rng.random(R) < 0.1, rng.random(R) < 0.1


@pytest.mark.parametrize("ip,R,wout,cap", [
    (2, 100, 160, 64_000), (4, 33, 20, 200), (8, 40, 640, 50_000),
    (3, 1000, 160, 400_000)])
def test_mesh_merge_kernel(cuda, ip, R, wout, cap):
    """K14 against its plain version: shared taxa, empty slots, reads
    over wout taxa, a CSR that overflows (cap 200), and the long arm
    (8 x 640 pairs a read, sorted in global memory)."""
    from kasa_tpu_torch import kernels
    from kasa_tpu_torch.parallel.turbo_mesh import (mesh_merge,
                                                    mesh_merge_plain)
    hts, hks, ofc, ofl = _shard_lists(ip, R, wout, ip * R)
    args = [torch.from_numpy(a) for a in (hts, hks, ofc, ofl | ofc)]
    kernels.reset_counts()
    got = mesh_merge(*(a.to(cuda) for a in args), cap)
    long = ip * wout > kernels.MERGE_SHORT_CAP
    assert kernels.COUNTS["mesh_merge.long" if long else "mesh_merge"] == 1
    want = mesh_merge_plain(*args, cap)
    p1, p2 = got[0].cpu(), want[0]
    ints = torch.ones(p1.numel(), dtype=torch.bool)
    ints[2 * R + 1:2 * R + 2 * cap:2] = False
    assert torch.equal(p1[ints], p2[ints])
    _close(p1[~ints].view(torch.float32), p2[~ints].view(torch.float32))
    assert torch.equal(got[1].cpu(), want[1])
    _close(got[2], want[2])
