"""The arms of K7 tiered_route, K3 turbo_reads pre and K4 turbo_multi,
on the CPU.

K7 (csrc/tiered_route.cu) routes a batch's windows to their index
chunks through per-segment offsets in shared memory below 8 chunks and
through a radix sort of the windows by chunk from 8 on (where the shared
arm could not hold the offsets of 12,000 chunks or more); the routing
the kernels are held to on the card is tiered_route_plain, which these
tests hold to kasa_tpu's chunk_cuts at 12,000 and 20,011 chunks.  K3 pre
picks its arm from the row width and the key range of the index's
species (kernels.reads_pre_arm).  K4's budget cut admits the cold slots of
every T below T* and the first c slots of T*: the batch step of both
packages under budgets that cut mid-histogram, and under a worklist
budget below the batch's multi slots."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

RTOL, ATOL = 2e-5, 1e-4


# ---------------------------------------------------------------------------
# K7

@pytest.mark.parametrize("C,arm", [(1, "shared"), (7, "shared"),
                                   (8, "global"), (11_999, "global"),
                                   (12_000, "global"), (20_011, "global")])
def test_tiered_route_arm(C, arm):
    """The shared arm below 8 chunks (where it beats the global arm on
    the H100), the global arm from 8 chunks on, and past the 11,999 the
    shared arm's offsets could hold in 48 KB."""
    from kasa_tpu_torch import kernels
    assert kernels.tiered_route_arm(C) == arm
    with pytest.raises(ValueError):
        kernels.tiered_route_arm(0)


def _route_case(C, M=60_000):
    """M windows over C chunk starts (limb 0, sorted, distinct): a third
    sit on a chunk's first limb 0, 500 below the first chunk."""
    rng = np.random.default_rng(C)
    limb0 = np.sort(rng.choice(np.arange(1 << 20, 1 << 30, 1 << 14), C,
                               replace=False)).astype(np.int32)
    q = rng.integers(0, 1 << 30, size=(M, 2)).astype(np.int32)
    on = rng.random(M) < 0.3
    q[on, 0] = limb0[rng.integers(0, C, size=int(on.sum()))]
    q[:500, 0] = rng.integers(0, limb0[0], size=500)
    return q, limb0


@pytest.mark.parametrize("C", [12_000, 20_011])
def test_route_plain_matches_chunk_cuts(C):
    """tiered_route_plain's cuts equal kasa_tpu's chunk_cuts on the
    windows sorted by key, exactly; each chunk's range holds the windows
    of kasa_tpu's range, in window order (bin 0, below the first chunk,
    first)."""
    import jax.numpy as jnp
    from kasa_tpu.match import tiered as JTI
    from kasa_tpu_torch.match import tiered as TI
    q, limb0 = _route_case(C)
    M = len(q)
    qr, _, posr, cuts = TI.tiered_route_plain(
        torch.from_numpy(q), torch.from_numpy(limb0), 7, 12)
    order = np.lexsort((q[:, 1], q[:, 0]))
    want = np.asarray(JTI.chunk_cuts(jnp.asarray(q[order]),
                                     jnp.asarray(limb0)))
    np.testing.assert_array_equal(cuts.numpy(), want)
    posr = posr.numpy()
    np.testing.assert_array_equal(qr.numpy(), q[posr])
    edges = np.concatenate([[0], want, [M]])
    for a, b in zip(edges[:-1], edges[1:]):
        seg = posr[a:b]
        assert np.all(np.diff(seg) > 0)
        np.testing.assert_array_equal(seg, np.sort(order[a:b]))
    assert want[0] >= 500 and len(np.unique(want)) > C // 2


# ---------------------------------------------------------------------------
# K3 pre

def test_reads_pre_arm():
    """Rows of at most SW_CAP slots keeping at most SW_CAP runs take the
    short arm whatever their keys; wider rows take the shared-memory long
    arm while the key range (8 S for S species) fits the histogram's
    capacity, the global arm above it, and need the range to be given:
    the wrapper refuses a long row without the species count, on the CPU
    as on the card."""
    from kasa_tpu_torch import kernels
    from kasa_tpu_torch.match import turbo as PT
    CW, SW_CAP = PT.CW, PT.SW_CAP
    assert kernels.reads_pre_arm(846, CW, None, 0) == "short"
    assert kernels.reads_pre_arm(SW_CAP, SW_CAP, 1 << 30, 0) == "short"
    cap = 58_000
    for SW, cw in ((SW_CAP + 1, CW), (47_886, CW), (846, SW_CAP + 1)):
        assert kernels.reads_pre_arm(SW, cw, cap, cap) == "long_smem"
        assert kernels.reads_pre_arm(SW, cw, cap + 1, cap) == "global"
        with pytest.raises(ValueError, match="key range"):
            kernels.reads_pre_arm(SW, cw, None, cap)
    # the default corpus (2,047 species) and the 10,001-species one
    assert kernels.reads_pre_arm(47_886, CW, 8 * 2047, cap) == "long_smem"
    assert kernels.reads_pre_arm(47_886, CW, 8 * 10_001, cap) == "global"
    skey = torch.full((2, SW_CAP + 1), PT.SENT, dtype=torch.int32)
    with pytest.raises(ValueError, match="num_species"):
        PT.turbo_reads_pre(skey, None)
    with pytest.raises(ValueError, match="num_species"):
        PT.turbo_reads_pre(skey[:, :846], None, cw=SW_CAP + 1)
    runs = PT.turbo_reads_pre(skey, None, num_species=1)[2]
    assert (runs == 0).all()


def test_long_rows_match_turbo_classify():
    """Rows longer than SW_CAP (700 windows at six levels, 4,200 slots;
    the long arms of K3 pre on the card): the port's batch step against
    kasa_tpu's turbo_classify on the same windows, with reads whose
    windows repeat (runs longer than one) and a read of one window
    repeated (one run a level): hit lists, counts and flags identical,
    floats within the contract."""
    import jax.numpy as jnp
    import kasa_tpu.match.turbo as JT
    from kasa_tpu_torch.match import turbo as PT
    from test_torch_core import _port_tables
    from test_turbo import S, _index_with_tiers

    limbs, taxids, _ = _index_with_tiers()
    rng = np.random.default_rng(4200)
    R, kpr = 4, 700
    q = limbs[rng.integers(0, len(taxids), size=R * kpr)].copy()
    q[kpr:2 * kpr] = q[kpr:kpr + 50][rng.integers(0, 50, size=kpr)]
    q[2 * kpr:3 * kpr] = q[2 * kpr]
    jt = JT.TurboTables.build_from_arrays(limbs, taxids.astype(np.int32),
                                          12, 7, 12, S)
    tt = _port_tables(jt)
    skey, _ = PT.turbo_match_plain(torch.from_numpy(q), tt, R, kpr)
    assert skey.shape[1] > PT.SW_CAP
    ht_j, hk_j, hc_j, ca_j, cu_j, ofc_j, ofl_j = [
        np.asarray(o) for o in JT.turbo_classify(
            jt.keys2, jt.rowdat, jt.router, jt.sub2, jt.grp2, jt.d_tax4,
            jt.weights, jt.masks2, jt.hotmask, jt.t_hot, jnp.asarray(q),
            jt.num_steps, 7, 12, 12, S, R, kpr)]
    ca = torch.zeros((6, S))
    cu = torch.zeros((6, S), dtype=torch.int32)
    packed, ht, hk = PT.turbo_core(tt, torch.from_numpy(q), R, kpr, ca, cu,
                                   160 * R)
    packed = packed.numpy()
    flags = packed[R:2 * R]
    np.testing.assert_array_equal(packed[:R], hc_j)
    np.testing.assert_array_equal(flags & 1, ofc_j.astype(np.int32))
    np.testing.assert_array_equal((flags >> 1) & 1, ofl_j.astype(np.int32))
    np.testing.assert_array_equal(ht.numpy(), ht_j)
    np.testing.assert_allclose(hk.numpy(), hk_j, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ca.numpy(), ca_j, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(cu.numpy(), cu_j)
    runs = PT.turbo_reads_pre_plain(skey, None, PT.CW)[2]
    assert int(runs[2]) <= 6 < int(runs[0]) and int(hc_j.sum()) > 0


# ---------------------------------------------------------------------------
# K4's budget cut

def _cold_ts(tt, q, R, kpr):
    """The T of every cold multi slot, in worklist (read-major) order,
    with its read; and each read's multi slots."""
    from kasa_tpu_torch.match import turbo as PT
    skey, mpay = PT.turbo_match_plain(q, tt, R, kpr)
    _, _, _, mcnt, cp = PT.turbo_reads_pre_plain(skey, mpay)
    iota = torch.arange(cp.shape[1])
    valid = iota[None, :] < mcnt[:, None]
    mp = cp[valid].long()
    rid = torch.nonzero(valid)[:, 0]
    ki, psel = mp & 7, mp >> 3
    row0 = tt.grp2[(ki * tt.n + psel).clamp(max=tt.num_k * tt.n - 1)].long()
    cold = row0 > 0
    return tt.d_tax4[row0[cold], 0].long().numpy(), rid[cold].numpy(), \
        mcnt.numpy()


@pytest.mark.parametrize("kind", ["exp_cut", "multi_cut"])
def test_budget_cut_matches_turbo_classify(monkeypatch, kind):
    """exp_cut: an expansion budget that admits every cold slot below a
    middle T*, then c > 0 of its slots, with reads holding a slot above
    T*; multi_cut: a worklist budget below the batch's multi slots, so
    every read with one is flagged.  The port's batch step against
    kasa_tpu's turbo_classify under the same budgets: hit lists, counts
    and flags identical, floats within the contract."""
    import jax
    import jax.numpy as jnp
    import kasa_tpu.match.turbo as JT
    from kasa_tpu_torch.match import turbo as PT
    from test_torch_core import _port_tables
    from test_turbo import S, _index_with_tiers

    limbs, taxids, hot = _index_with_tiers(
        n=20_000, heavy_ts=(3, 4, 6, 8, 8, 13, 16, 30))
    rng = np.random.default_rng(47)
    R, kpr = 48, 24
    q = limbs[rng.integers(0, len(taxids), size=R * kpr)].copy()
    for i, kl in enumerate(hot):
        for j in range(3):
            q[(i * 5 + j) * kpr + 4 + j] = kl
    monkeypatch.setattr(JT, "HOT_SETS", 1)
    jt = JT.TurboTables.build_from_arrays(limbs, taxids.astype(np.int32),
                                          12, 7, 12, S)
    tt = _port_tables(jt)
    qt = torch.from_numpy(q)
    Ts, rid, mcnt = _cold_ts(tt, qt, R, kpr)
    total = int(mcnt.sum())
    mb, eb = JT.MULTI_BUDGET, JT.EXP_BUDGET
    if kind == "exp_cut":
        vals, cnt = np.unique(Ts, return_counts=True)
        mid = [t for t, c in zip(vals, cnt) if c >= 2 and t < vals.max()]
        tstar = int(mid[len(mid) // 2])
        rp = (tstar + 3) >> 2
        c = int(cnt[vals == tstar][0]) // 2
        eb = int(sum(int(n) * ((int(t) + 3) >> 2)
                     for t, n in zip(vals, cnt) if t < tstar)) + rp * c
        assert 0 < c < int(cnt[vals == tstar][0])
        assert tstar > vals.min() and len(np.unique(rid[Ts > tstar])) >= 1
    else:
        mb = total - 7
    monkeypatch.setattr(JT, "MULTI_BUDGET", mb)
    monkeypatch.setattr(JT, "EXP_BUDGET", eb)
    # the budgets are read when the program is traced: jax.clear_caches
    # drops the traced programs too (a jit's _clear_cache keeps them)
    jax.clear_caches()
    try:
        ht_j, hk_j, hc_j, ca_j, cu_j, ofc_j, ofl_j = [
            np.asarray(o) for o in JT.turbo_classify(
                jt.keys2, jt.rowdat, jt.router, jt.sub2, jt.grp2, jt.d_tax4,
                jt.weights, jt.masks2, jt.hotmask, jt.t_hot, jnp.asarray(q),
                jt.num_steps, 7, 12, 12, S, R, kpr)]
    finally:
        jax.clear_caches()
    ca = torch.zeros((6, S))
    cu = torch.zeros((6, S), dtype=torch.int32)
    cap = 160 * R
    packed, ht, hk = PT.turbo_core(tt, qt, R, kpr, ca, cu, cap, mb, eb)
    packed = packed.numpy()
    flags = packed[R:2 * R]
    np.testing.assert_array_equal(packed[:R], hc_j)
    np.testing.assert_array_equal(flags & 1, ofc_j.astype(np.int32))
    np.testing.assert_array_equal((flags >> 1) & 1, ofl_j.astype(np.int32))
    np.testing.assert_array_equal(ht.numpy(), ht_j)
    np.testing.assert_allclose(hk.numpy(), hk_j, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ca.numpy(), ca_j, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(cu.numpy(), cu_j)
    flagged = flags & 1
    if kind == "exp_cut":
        # reads with a slot above T* are flagged, some with T* slots are
        # admitted and some are not
        assert flagged[np.unique(rid[Ts > tstar])].all()
        star = np.unique(rid[Ts == tstar])
        assert 0 < flagged[star].sum() < len(star)
        assert 0 < int(packed[-3]) <= eb
    else:
        assert int(packed[-4]) == total and int(packed[-3]) == 0
        assert flagged[mcnt > 0].all() and (mcnt == 0).any()
