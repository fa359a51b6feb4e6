"""The CUDA kernels of kasa_tpu_torch against their plain PyTorch
versions, on the card: K1-K6, the per-file, counts-only and list arms,
and the five-limb arms of K1, K2 and K5.  CUDA kernels have no CPU mode: without a GPU
these tests skip.  On a machine with one (and without JAX):

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
