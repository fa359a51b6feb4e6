"""kasa_tpu_torch's tiered beyond-resident identify (match/tiered.py:
chunk tables, K7's routing, K8's chunk pass, K3's additive arm, the
host ADD) against kasa_tpu/match/tiered.py, on the CPU.

Every test feeds the same numpy inputs to both packages.  The contract
(ROADMAP.md): integers identical (chunk tables, cuts, validity bits, T1
keys, big flags, hit counts, flags, the CSR, unique counts), floats
within rtol 2e-5 / atol 1e-4; the all-counts of a whole identify run
within rtol 2e-5 / atol 2e-3 and its per-read scores within rtol 2e-4,
as kasa_tpu's own tiered test allows (tests/test_tiered.py:117-131).

kasa_tpu's chunk pass runs every lane of a PASS_CAP-wide pass until the
largest group of the pass is expanded, so a lane with a smaller group
also adds the taxa rows that follow its own (ROADMAP.md, Queue 3).  The
comparisons with kasa_tpu's passes run them one window at a time
(PASS_CAP = 1: its arithmetic without that cross-lane loop)."""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_tiered import synth_corpus_big_groups
from test_turbo import S as TS, _index_with_tiers, _oracle
from test_torch_tables import drop_sidecars  # noqa: F401

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
RTOL, ATOL = 2e-5, 1e-4
MIN_K, MAX_K, HK = 7, 12, 12
NUM_K = MAX_K - MIN_K + 1
# chunk size of the identify comparisons: kasa_tpu's 2^16-entry floor
# would leave the ~44 k-entry corpus in one chunk
CORPUS_CHUNK = 10_000


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """tests/test_tiered.py's corpus: 120 species, a T = 80 gene (over
    TMAX: the host ADD) and a T ~ 24 gene (on the device), 600 reads."""
    d = tmp_path_factory.mktemp("tier_corpus")
    idx, fq, n = synth_corpus_big_groups(d)
    return pathlib.Path(idx), fq, n


@pytest.fixture(scope="module")
def tiers(tmp_path_factory):
    """tests/test_turbo.py's index with heavy groups of T = 4, 13, 30
    (on the device: each key already held one taxon), 61 and 201 (host),
    written as an index file (the chunk cache's stamp)."""
    from kasa_tpu.index import artifacts
    limbs, taxids, hot = _index_with_tiers(n=30_000,
                                           heavy_ts=(3, 12, 29, 60, 200))
    d = tmp_path_factory.mktemp("tier_index")
    idx = str(d / "kIdx")
    artifacts.write_index(idx, limbs, taxids, 12)
    return idx, limbs, taxids, hot


def _load(idx):
    """The port's (limbs, tax_rows, S) of an index family."""
    from kasa_tpu_torch.config import Config
    from kasa_tpu_torch.match.pipeline import _load_index
    cfg = Config()
    cfg.content_file = str(idx) + "_content.txt"
    limbs, _, _, content, _, tax_rows = _load_index(cfg, str(idx))
    return limbs, tax_rows, content.num_species


def _dispatches(idx, limbs, tax_rows, S, chunk_entries, d):
    """kasa_tpu's and the port's TieredTurboDispatch of one index at one
    chunk size, each with its own cache directory."""
    from kasa_tpu.match.tiered import TieredTurboDispatch as JD
    from kasa_tpu_torch.match.tiered import TieredTurboDispatch as PD
    jd = JD(str(idx), limbs, tax_rows, HK, MIN_K, MAX_K, S, chunk_entries,
            cache_dir=str(d / "jcache"))
    pd = PD(str(idx), limbs, tax_rows, HK, MIN_K, MAX_K, S, chunk_entries,
            torch.device("cpu"), cache_dir=str(d / "tcache"))
    return jd, pd


def _tabs(disp, ci):
    from kasa_tpu_torch.match.tiered import TIERED_FIELDS
    with np.load(disp._chunk_file(ci)) as z:
        return {f: z[f] for f in TIERED_FIELDS + ("n",)}


# ---------------------------------------------------------------------------
# (a) chunk tables and the chunk plan

@pytest.mark.parametrize("which", ["tiers", "corpus"])
def test_chunk_tables_match_jax(tmp_path, tiers, corpus, which):
    from kasa_tpu.match.tiered import build_chunk_tables as jbuild
    from kasa_tpu_torch.match.tiered import build_chunk_tables as pbuild
    if which == "tiers":
        idx, limbs, taxids, _ = tiers
        tax_rows, S, ce = taxids.astype(np.int32), TS, 7000
    else:
        idx = corpus[0]
        limbs, tax_rows, S = _load(idx)
        ce = CORPUS_CHUNK
    jd, pd = _dispatches(idx, limbs, tax_rows, S, ce, tmp_path)
    assert len(pd.chunks) >= 4
    assert pd.chunks == jd.chunks
    for attr in ("chunk_pad", "num_steps", "msteps", "mpad", "drpad",
                 "mlevel_max"):
        assert getattr(pd, attr) == getattr(jd, attr), attr
    np.testing.assert_array_equal(pd.chunk_limb0.numpy(),
                                  np.asarray(jd.chunk_limb0))
    for ci in range(len(pd.chunks)):
        jz, tz = _tabs(jd, ci), _tabs(pd, ci)
        for f, v in jz.items():
            assert tz[f].dtype == v.dtype and np.array_equal(tz[f], v), \
                (ci, f)
    a, b = pd.chunks[1]
    jt = jbuild(np.ascontiguousarray(limbs[a:b]), tax_rows[a:b], HK, MIN_K,
                MAX_K, pd.chunk_pad)
    pt = pbuild(np.ascontiguousarray(limbs[a:b]), tax_rows[a:b], HK, MIN_K,
                MAX_K, pd.chunk_pad)
    assert set(jt) == set(pt)
    for f in jt:
        np.testing.assert_array_equal(pt[f], jt[f])


# ---------------------------------------------------------------------------
# (b) K7's plain version against tiered_prepare + chunk_cuts

def _read_matrix(fq, R):
    """The first R reads of a fastq as a (R, 176) 'X'-padded byte
    matrix."""
    lines = pathlib.Path(fq).read_bytes().splitlines()
    mat = np.full((R, 176), ord("X"), np.uint8)
    for r in range(R):
        seq = np.frombuffer(lines[4 * r + 1], np.uint8)
        mat[r, :len(seq)] = seq
    return mat


@pytest.mark.parametrize("unique", [False, True], ids=["default", "unique"])
def test_route_matches_prepare_and_cuts(tmp_path, corpus, unique):
    import jax.numpy as jnp
    from kasa_tpu.core.encode import build_codon_code_lut
    from kasa_tpu.match.tiered import chunk_cuts, tiered_prepare
    from kasa_tpu_torch.core.encode import encode_windows_plain
    from kasa_tpu_torch.match.tiered import tiered_route_plain
    from kasa_tpu_torch.match.turbo import dedup_windows_plain
    idx, fq, _ = corpus
    limbs, tax_rows, S = _load(idx)
    jd, pd = _dispatches(idx, limbs, tax_rows, S, CORPUS_CHUNK, tmp_path)
    R, w = 96, 176 - 36 + 1
    mat = _read_matrix(fq, R)
    lut = np.asarray(build_codon_code_lut(), np.int32)
    qs, vb, ps = tiered_prepare(jnp.asarray(mat), jnp.asarray(lut), HK,
                                MIN_K, MAX_K, False, False, w, R, unique)
    q = encode_windows_plain(torch.from_numpy(mat), torch.from_numpy(lut), w)
    if unique:
        q = dedup_windows_plain(q, R, w)
    M = R * w
    # the index's chunks, and the same without the first (windows below
    # the first chunk are routed first and never searched)
    for skip in (0, 1):
        cuts_j = np.asarray(chunk_cuts(qs, jd.chunk_limb0[skip:]))
        qr, vbr, posr, cuts = tiered_route_plain(q, pd.chunk_limb0[skip:],
                                                 MIN_K, MAX_K)
        np.testing.assert_array_equal(cuts.numpy(), cuts_j)
        assert np.count_nonzero(np.diff(np.r_[cuts_j, M])) >= 3
        assert (cuts_j[0] > 0) == bool(skip)
        vj, pj = np.asarray(vb), np.asarray(ps)
        # the validity bits of every window, by its position
        v1 = np.empty(M, np.int32)
        v1[pj] = vj
        v2 = np.empty(M, np.int32)
        v2[posr.numpy()] = vbr.numpy()
        np.testing.assert_array_equal(v2, v1)
        # each chunk (and the windows below the first) the same multiset;
        # the port's routing keeps window order inside a chunk
        bounds = [0] + list(cuts_j) + [M]
        rows_j = np.c_[np.asarray(qs), vj, pj]
        rows_t = np.c_[qr.numpy(), vbr.numpy(), posr.numpy()]
        for a, b in zip(bounds[:-1], bounds[1:]):
            sj = rows_j[a:b][np.lexsort(rows_j[a:b].T[::-1])]
            st = rows_t[a:b][np.lexsort(rows_t[a:b].T[::-1])]
            np.testing.assert_array_equal(st, sj)
            assert np.all(np.diff(posr.numpy()[a:b]) > 0)


# ---------------------------------------------------------------------------
# (c) K8's plain version against tiered_chunk_pass

def _tier_queries(limbs, hot, R, kpr, seed=2):
    """kasa_tpu's oracle-test queries: index windows, 30 % of them
    mutated, a heavy-group key in every read's slot 3."""
    rng = np.random.default_rng(seed)
    m = R * kpr
    q = limbs[rng.integers(0, len(limbs), size=m)].copy()
    miss = rng.random(m) < 0.3
    q[miss, 1] ^= (rng.integers(1, 31, size=int(miss.sum()))
                   .astype(np.int32) << 5)
    for i in range(R):
        q[i * kpr + 3] = hot[i % len(hot)]
    return np.ascontiguousarray(q)


@pytest.fixture
def jax_single_lane(monkeypatch):
    """kasa_tpu's chunk pass one window per pass (PASS_CAP = 1, retraced
    by jax.clear_caches)."""
    import jax
    import kasa_tpu.match.tiered as JTi
    monkeypatch.setattr(JTi, "PASS_CAP", 1)
    jax.clear_caches()
    yield
    jax.clear_caches()


def _jax_passes(jd, q, R, kpr, S):
    """kasa_tpu's state after each chunk: (skey, sflat, cflat, big) numpy
    copies per chunk, windows routed by its own sort and cuts."""
    import jax.numpy as jnp
    from kasa_tpu.match.tiered import (I32_MAX, PASS_CAP, TIERED_FIELDS,
                                       chunk_cuts, tiered_chunk_pass,
                                       window_vbits_np)
    m = len(q)
    vb = window_vbits_np(q, MIN_K, MAX_K)
    order = np.lexsort((q[:, 1], q[:, 0]))
    q_s, vb_s = jnp.asarray(q[order]), jnp.asarray(vb[order])
    ps_s = jnp.asarray(np.arange(m, dtype=np.int32)[order])
    pad = max(PASS_CAP - m, 0)
    if pad:
        q_s = jnp.concatenate([q_s, jnp.full((pad, 2), I32_MAX)])
        vb_s = jnp.concatenate([vb_s, jnp.zeros((pad,), jnp.int32)])
        ps_s = jnp.concatenate([ps_s, jnp.full((pad,), m, jnp.int32)])
    cuts = np.asarray(chunk_cuts(q_s[:m], jd.chunk_limb0))
    skey = jnp.full((m + 1, NUM_K), I32_MAX, jnp.int32)
    sflat = jnp.zeros((R * S + 1,), jnp.float32)
    cflat = jnp.zeros((NUM_K * S + 1,), jnp.float32)
    big = jnp.zeros((R + 1,), jnp.int32)
    ends = list(cuts[1:]) + [m]
    states = []
    for ci in range(len(jd.chunks)):
        lo, hi = int(cuts[ci]), int(ends[ci])
        z = np.load(jd._chunk_file(ci))
        tabs = tuple(jnp.asarray(z[f]) for f in TIERED_FIELDS)
        for off in range(lo, hi, PASS_CAP):
            skey, sflat, cflat, big = tiered_chunk_pass(
                *tabs, jd.weights, q_s, vb_s, ps_s, off,
                min(off + PASS_CAP, hi), skey, sflat, cflat, big,
                jd.num_steps, jd.msteps, MIN_K, MAX_K, HK, S, kpr)
        states.append(tuple(np.array(x) for x in (skey, sflat, cflat, big)))
    return states


def _port_passes(pd, q, R, kpr, S):
    """The port's state after each chunk (plain versions)."""
    from kasa_tpu_torch.match.tiered import (SENT, TIERED_FIELDS,
                                             tiered_pass_plain,
                                             tiered_route_plain)
    m = len(q)
    qr, vbr, posr, cuts = tiered_route_plain(torch.from_numpy(q),
                                             pd.chunk_limb0, MIN_K, MAX_K)
    skey = torch.full((m + 1, NUM_K), SENT, dtype=torch.int32)
    sflat = torch.zeros(R * S + 1)
    cflat = torch.zeros(NUM_K * S + 1)
    big = torch.zeros(R + 1, dtype=torch.int32)
    ends = cuts.tolist()[1:] + [m]
    states = []
    for ci in range(len(pd.chunks)):
        z = _tabs(pd, ci)
        tabs = tuple(torch.from_numpy(z[f]) for f in TIERED_FIELDS)
        tiered_pass_plain(tabs, pd.weights, qr, vbr, posr,
                          int(cuts[ci]), ends[ci], skey, sflat, cflat, big,
                          pd.num_steps, pd.msteps, pd.masks, pd.full, S,
                          kpr)
        states.append(tuple(x.numpy().copy()
                            for x in (skey, sflat, cflat, big)))
    return states


def test_chunk_pass_matches_jax(tmp_path, tiers, jax_single_lane):
    idx, limbs, taxids, hot = tiers
    R, kpr = 12, 36
    jd, pd = _dispatches(idx, limbs, taxids.astype(np.int32), TS, 7000,
                         tmp_path)
    q = _tier_queries(limbs, hot, R, kpr)
    js, ts = _jax_passes(jd, q, R, kpr, TS), _port_passes(pd, q, R, kpr, TS)
    assert len(js) == len(ts) >= 4
    for ci, (j, t) in enumerate(zip(js, ts)):
        np.testing.assert_array_equal(t[0], j[0], err_msg=f"skey {ci}")
        np.testing.assert_array_equal(t[3], j[3], err_msg=f"big {ci}")
        np.testing.assert_allclose(t[1], j[1], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(t[2], j[2], rtol=RTOL, atol=ATOL)
    skey, sflat, _, big = ts[-1]
    assert (skey != np.iinfo(np.int32).max).any() and big[:R].any()
    assert (sflat > 0).sum() > 80     # the T = 4, 13 and 30 groups


def test_chunk_pass_expands_only_its_group(tmp_path, jax_single_lane):
    """Two multi groups in one chunk (T = 2 and T = 9, taxa rows adjacent
    in d_tax4) and one read hitting each: the port's pass gives each
    read its own group's taxa at w(k)/T, as kasa_tpu's pass of one
    window does (at its own PASS_CAP both lanes share a pass and the
    T = 2 read also gets the T = 9 group's first eight taxa)."""
    from kasa_tpu.index import artifacts
    from kasa_tpu_torch.match.join import weight

    def key(seed):
        lt = np.random.default_rng(seed).integers(1, 27, size=12)
        return (sum(int(lt[j]) << (5 * (5 - j)) for j in range(6)),
                sum(int(lt[6 + j]) << (5 * (5 - j)) for j in range(6)))
    A, B = key(1), key(2)
    rows = sorted([(*A, t) for t in (3, 5)]
                  + [(*B, t) for t in range(10, 19)])
    limbs = np.array([r[:2] for r in rows], np.int32)
    tax = np.array([r[2] for r in rows], np.int32)
    idx = str(tmp_path / "two")
    artifacts.write_index(idx, limbs, tax.astype(np.uint32), 12)
    S = 40
    jd, pd = _dispatches(idx, limbs, tax, S, 1 << 16, tmp_path)
    q = np.array([A, B], np.int32)
    j, t = _jax_passes(jd, q, 2, 1, S)[-1], _port_passes(pd, q, 2, 1, S)[-1]
    np.testing.assert_allclose(t[1], j[1], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t[2], j[2], rtol=RTOL, atol=ATOL)
    wsum = sum(float(weight(k)) for k in range(MIN_K, MAX_K + 1))
    got = t[1][:2 * S].reshape(2, S)
    want = np.zeros((2, S))
    want[0, [3, 5]] = wsum / 2
    want[1, 10:19] = wsum / 9
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# (d) K3's additive arm (plain) against tiered_finish

def _finish_inputs(kind, tmp_path, tiers):
    """(skey, sflat, cflat, big, R, kpr, S): kasa_tpu's pass outputs on
    the tiered queries, or random extremes (reads with more than WOUT T1
    taxa, more than min(S, 256) multi taxa, flagged reads)."""
    R, kpr = 48, 36
    if kind == "passes":
        idx, limbs, taxids, hot = tiers
        jd, _ = _dispatches(idx, limbs, taxids.astype(np.int32), TS, 7000,
                            tmp_path)
        q = _tier_queries(limbs, hot, R, kpr, seed=7)
        skey, sflat, cflat, big = _jax_passes(jd, q, R, kpr, TS)[-1]
        return skey, sflat, cflat, big, R, kpr, TS
    rng = np.random.default_rng(3)
    S = 600
    m = R * kpr
    tax = rng.integers(0, S, size=(m + 1, NUM_K))
    # the first four reads: ~190 distinct T1 taxa each (over WOUT)
    tax[:kpr * 4] = np.arange(kpr * 4 * NUM_K).reshape(-1, NUM_K) % S
    keys = (tax * 8 + np.arange(NUM_K)).astype(np.int32)
    hit = rng.random((m + 1, NUM_K)) < np.where(
        np.arange(m + 1)[:, None] < 4 * kpr, 0.9, 0.1)
    skey = np.where(hit, keys, np.iinfo(np.int32).max).astype(np.int32)
    dens = np.where(np.arange(R) % 5 == 0, 0.6, 0.05)
    sflat = np.where(rng.random((R, S)) < dens[:, None],
                     rng.random((R, S)), 0.0).astype(np.float32)
    sflat = np.r_[sflat.reshape(-1), 0].astype(np.float32)
    cflat = rng.random(NUM_K * S + 1).astype(np.float32)
    big = (rng.random(R + 1) < 0.2).astype(np.int32)
    return skey, sflat, cflat, big, R, kpr, S


@pytest.mark.parametrize("kind", ["passes", "extremes"])
def test_additive_finish_matches_tiered_finish(tmp_path, tiers, kind):
    import jax.numpy as jnp
    from kasa_tpu.match.tiered import tiered_finish as jfinish
    from kasa_tpu_torch.match.tiered import tiered_finish as pfinish
    from kasa_tpu_torch.match.turbo import WOUT
    from kasa_tpu_torch.match.join import weight
    skey, sflat, cflat, big, R, kpr, S = _finish_inputs(kind, tmp_path,
                                                        tiers)
    cap = 4 * R
    w = np.array([weight(MAX_K - ki) for ki in range(NUM_K)], np.float32)
    acc0 = np.random.default_rng(1).random((NUM_K, S)).astype(np.float32)
    cu0 = np.arange(NUM_K * S, dtype=np.int32).reshape(NUM_K, S) % 7
    jp, jht, jhk, jca, jcu = (np.asarray(x) for x in jfinish(
        jnp.asarray(skey), jnp.asarray(sflat), jnp.asarray(cflat),
        jnp.asarray(big), jnp.asarray(w), jnp.asarray(acc0),
        jnp.asarray(cu0), MIN_K, MAX_K, S, R, kpr, cap))
    ca, cu = torch.from_numpy(acc0.copy()), torch.from_numpy(cu0.copy())
    tp, tht, thk = pfinish(torch.from_numpy(skey.copy()),
                           torch.from_numpy(sflat.copy()),
                           torch.from_numpy(cflat.copy()),
                           torch.from_numpy(big.copy()), torch.from_numpy(w),
                           ca, cu, R, kpr, cap)
    tp = tp.numpy()
    # [hc | flags | CSR (tax, ksum bits) | ...tail]: kasa_tpu's tail is
    # (total, nflag), the port's (mtot, eused, total, nflag)
    n = 2 * R + 2 * cap
    ints = np.ones(n, bool)
    ints[2 * R + 1::2] = False
    np.testing.assert_array_equal(tp[:n][ints], jp[:n][ints])
    np.testing.assert_allclose(tp[:n][~ints].view(np.float32),
                               jp[:n][~ints].view(np.float32),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(tp[-2:], jp[-2:])
    np.testing.assert_array_equal(tht.numpy(), jht[:, :WOUT])
    np.testing.assert_allclose(thk.numpy(), jhk[:, :WOUT], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(cu.numpy(), jcu)
    np.testing.assert_allclose(ca.numpy(), jca, rtol=RTOL, atol=ATOL)
    flags = tp[R:2 * R]
    assert (flags & 1).any() and (flags & 2).any()
    if kind == "extremes":
        assert ((flags >> 1) & ~flags & 1).any()    # rebuilt, not big


# ---------------------------------------------------------------------------
# (e) device counts + host ADD = the oracle

def test_tiered_matches_oracle(tmp_path, tiers):
    from kasa_tpu_torch.match.tiered import (TMAX, host_ranges_classify,
                                             tiered_finish, window_vbits_np)
    idx, limbs, taxids, hot = tiers
    R, kpr = 64, 36
    _, pd = _dispatches(idx, limbs, taxids.astype(np.int32), TS, 7000,
                        tmp_path)
    q = _tier_queries(limbs, hot, R, kpr)
    skey, sflat, cflat, big = (torch.from_numpy(x) for x in
                               _port_passes(pd, q, R, kpr, TS)[-1])
    ca = torch.zeros((NUM_K, TS))
    cu = torch.zeros((NUM_K, TS), dtype=torch.int32)
    packed, ht, hk = tiered_finish(skey, sflat, cflat, big, pd.weights, ca,
                                   cu, R, kpr, 16 * R)
    packed = packed.numpy()
    ca = ca.numpy().astype(np.float64)
    cu = cu.numpy().astype(np.int64)
    flags = packed[R:2 * R]
    assert (flags & 1).any(), "T > TMAX groups should flag reads"
    fixes = {r: pd.host_fixup(q[r * kpr:(r + 1) * kpr])
             for r in np.nonzero(flags)[0]}
    for r in np.nonzero(flags & 1)[0]:
        _, ca2, cu2 = fixes[r]
        ca += ca2
        cu += cu2
    exp_scores, exp_ca, exp_cu = _oracle(limbs, taxids, q, R, kpr)
    np.testing.assert_allclose(ca, exp_ca, rtol=2e-5, atol=2e-3)
    np.testing.assert_array_equal(cu, exp_cu)
    hc = packed[:R]
    for r in range(R):
        qr = q[r * kpr:(r + 1) * kpr]
        if flags[r]:
            got = sorted(fixes[r][0].items())
        else:
            got = [(int(ht[r, i]), float(hk[r, i])) for i in range(hc[r])]
        want = [(int(t), float(exp_scores[r, t]))
                for t in np.nonzero(exp_scores[r])[0]]
        assert [t for t, _ in got] == [t for t, _ in want], r
        np.testing.assert_allclose([v for _, v in got],
                                   [v for _, v in want], rtol=RTOL,
                                   atol=ATOL)
    # the host ADD is exactly the T > TMAX groups, and one pass gives the
    # full list whatever its t_min
    vb = window_vbits_np(q, MIN_K, MAX_K)
    sc_all, ca_all, _ = host_ranges_classify(
        pd.key64, pd.tax_rows, q, vb, MIN_K, MAX_K, HK, TS, t_min=0)
    np.testing.assert_allclose(ca_all, exp_ca, rtol=2e-5, atol=2e-3)
    sc_big, _, _ = host_ranges_classify(
        pd.key64, pd.tax_rows, q, vb, MIN_K, MAX_K, HK, TS, t_min=TMAX)
    assert sc_big == sc_all
    assert TMAX == 30


# ---------------------------------------------------------------------------
# (f) identify on the tiered corpus

@pytest.fixture
def small_chunks(monkeypatch):
    """Both packages over budget and in CORPUS_CHUNK-entry chunks: the
    port's chunk size, and kasa_tpu's through a TieredTurboDispatch that
    takes it (its selection computes the size inline)."""
    import kasa_tpu.match.tiered as JTi
    from kasa_tpu_torch.match import tiered as PTi
    base = JTi.TieredTurboDispatch

    class Chunked(base):
        def __init__(self, index_path, limbs, tax_rows, highest_k, min_k,
                     max_k, num_species, chunk_entries, cache_dir=None):
            super().__init__(index_path, limbs, tax_rows, highest_k, min_k,
                             max_k, num_species, CORPUS_CHUNK, cache_dir)
    monkeypatch.setattr(JTi, "TieredTurboDispatch", Chunked)
    monkeypatch.setattr(PTi, "chunk_entries_for", lambda b, k: CORPUS_CHUNK)
    monkeypatch.setenv("KASA_MESH_DP", "1")
    monkeypatch.setenv("KASA_MESH_IP", "1")
    return monkeypatch


def _tier_budget(n):
    """-m for a device budget of a sixteenth of the resident tables (the
    CPU budget is 0.8 of -m).  tests/test_tiered.py takes a quarter, which
    kasa_tpu on the 8 host devices of tests/conftest.py meets by sharding
    over 4 of them (its mesh arm, forced back to one device by
    KASA_MESH_DP/IP = 1): its tiered path needs tables too large for all
    8."""
    from kasa_tpu_torch.match.fast import bytes_per_entry_resident
    return int(bytes_per_entry_resident(6) * n // 16 / 0.8)


def _reads(fq, d, name, a, b):
    """Reads a..b-1 of a fastq as a file of their own."""
    lines = pathlib.Path(fq).read_bytes().splitlines(keepends=True)
    p = d / name
    p.write_bytes(b"".join(lines[4 * a:4 * b]))
    return str(p)


def _identify(pkg, idx, fq, out, overrides, mem=None):
    if pkg == "jax":
        from kasa_tpu.config import Config
        from kasa_tpu.match.pipeline import identify
        cfg = Config()
        cfg.engine = "tpu"
    else:
        from kasa_tpu_torch.config import Config
        from kasa_tpu_torch.match.pipeline import identify
        cfg = Config()
    cfg.content_file = str(idx) + "_content.txt"
    cfg.num_of_beasts = 1000
    if mem:
        cfg.memory_avail = mem
    for k, v in overrides.items():
        setattr(cfg, k, v)
    kw = {} if pkg == "jax" else {"device": "cpu"}
    res = identify(cfg, index_path=str(idx), input_path=fq,
                   out_file=str(out) + ".json", profile_file=str(out) + ".csv",
                   **kw)
    return res, json.load(open(str(out) + ".json")), \
        open(str(out) + ".csv").read()


def _agree_tiered(a, b):
    """Identify outputs under the tiered contract: the same taxa per
    read, scores within rtol 2e-4; unique counts identical, all-counts
    within rtol 2e-5 / atol 2e-3."""
    (ra, ja, _), (rb, jb, _) = a, b
    assert ra[2:] == rb[2:]
    np.testing.assert_array_equal(np.asarray(ra[1], np.int64),
                                  np.asarray(rb[1], np.int64))
    np.testing.assert_allclose(ra[0], rb[0], rtol=2e-5, atol=2e-3)
    assert len(ja) == len(jb)
    for x, y in zip(ja, jb):
        assert x["Read number"] == y["Read number"]
        hx = {h["tax ID"]: h for h in x["Top hits"] + x["Further hits"]}
        hy = {h["tax ID"]: h for h in y["Top hits"] + y["Further hits"]}
        assert set(hx) == set(hy), f"read {x['Read number']}"
        for t, h in hx.items():
            np.testing.assert_allclose(float(hy[t]["k-mer Score"]),
                                       float(h["k-mer Score"]),
                                       rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("case", ["default", "six_e", "paired"])
def test_identify_tiered_agrees(tmp_path, corpus, small_chunks,
                                jax_single_lane, case):
    """The port's tiered identify against kasa_tpu's (its chunk pass one
    window per pass: at its own PASS_CAP it adds other groups' taxa to 58
    of the corpus's 600 reads, ROADMAP.md Queue 3) and against the port's
    resident run, on the corpus's first 300 reads (150 pairs)."""
    from kasa_tpu_torch.match import fast
    from kasa_tpu_torch.utils import timers
    idx, fq, n = corpus
    ov = {"six_e": {"six_frames": True, "unique": True}}.get(case, {})
    if case == "paired":
        ov = {"paired_end_1": _reads(fq, tmp_path, "m1.fastq", 0, 150),
              "paired_end_2": _reads(fq, tmp_path, "m2.fastq", 150, 300)}
        fq = ""
    else:
        fq = _reads(fq, tmp_path, "head.fastq", 0, 300)
    mem = _tier_budget(n)
    jt = _identify("jax", idx, fq, tmp_path / "jt", ov, mem)
    import kasa_tpu.match.fast as JF
    assert type(JF.LAST_DISPATCH).__name__ == "Chunked"
    assert len(JF.LAST_DISPATCH.chunks) >= 4
    timers.reset()
    pt = _identify("port", idx, fq, tmp_path / "pt", ov, mem)
    disp = fast.LAST_DISPATCH
    assert type(disp).__name__ == "TieredTurboDispatch"
    assert len(disp.chunks) >= 4 and timers.counter("recompute.add_reads") > 0
    pr = _identify("port", idx, fq, tmp_path / "pr", ov)
    assert type(fast.LAST_DISPATCH).__name__ == "SingleTurboDispatch"
    _agree_tiered(jt, pt)
    _agree_tiered(pr, pt)


# ---------------------------------------------------------------------------
# (g) the resident tables' row overflow routes to the tiered path

@pytest.mark.parametrize("min_k", [7, 5], ids=["tiered", "classic"])
def test_row_overflow_routes_to_tiered(tmp_path, corpus, monkeypatch,
                                       min_k):
    """kasa_tpu fast.py:383-402: a TurboRowOverflow from the resident
    build streams the index tiered when it is eligible (64-bit, min_k >=
    6); else the classic engine (K9) takes it.  Either run agrees with
    the resident turbo run of the same reads."""
    from kasa_tpu_torch.match import fast
    from kasa_tpu_torch.match import turbo as PT
    idx, fq, _ = corpus

    def overflow(*a, **k):
        raise PT.TurboRowOverflow("d_tax4 would need 2^31 rows")
    ov = {"lower_k": min_k}
    ref = _identify("port", idx, fq, tmp_path / "ref", ov)
    monkeypatch.setattr(PT, "load_or_build_turbo", overflow)
    got = _identify("port", idx, fq, tmp_path / "t", ov)
    assert type(fast.LAST_DISPATCH).__name__ == (
        "TieredTurboDispatch" if min_k >= 6 else "StackedTables")
    _agree_tiered(ref, got)


# ---------------------------------------------------------------------------
# (h) identify_multiple on a tiered index

def _folder(fq, d):
    lines = pathlib.Path(fq).read_bytes().splitlines(keepends=True)
    d.mkdir()
    for i in range(3):
        (d / f"part{i}.fastq").write_bytes(
            b"".join(lines[4 * 200 * i:4 * 200 * (i + 1)]))
    return str(d)


@pytest.mark.parametrize("profiles", [False, True],
                         ids=["lists", "profiles"])
def test_identify_multiple_on_tiered(tmp_path, corpus, small_chunks,
                                     profiles):
    """Without profiles the packed stream goes through the tiered
    dispatch (per-file outputs as the resident run's); with profiles
    the port raises: neither package has per-file tiered counts."""
    from kasa_tpu_torch.config import Config
    from kasa_tpu_torch.match import fast
    from kasa_tpu_torch.match.pipeline import identify_multiple
    idx, fq, n = corpus
    folder = _folder(fq, tmp_path / "in")

    def run(tag, mem=None):
        cfg = Config()
        cfg.content_file = str(idx) + "_content.txt"
        cfg.index_file = str(idx)
        cfg.input = folder
        cfg.num_of_beasts = 1000
        cfg.read_to_taxa_file = str(tmp_path / f"{tag}_")
        cfg.table_file = str(tmp_path / f"{tag}p_") if profiles else ""
        if mem:
            cfg.memory_avail = mem
        return identify_multiple(cfg, device="cpu")
    if profiles:
        with pytest.raises(NotImplementedError, match="per-file"):
            run("t", _tier_budget(n))
        return
    run("r")
    run("t", _tier_budget(n))
    assert type(fast.LAST_DISPATCH).__name__ == "TieredTurboDispatch"
    for i in range(3):
        a = json.load(open(tmp_path / f"r_part{i}.json"))
        b = json.load(open(tmp_path / f"t_part{i}.json"))
        assert len(a) == len(b) == 200
        for x, y in zip(a, b):
            hx = {h["tax ID"]: h for h in x["Top hits"] + x["Further hits"]}
            hy = {h["tax ID"]: h for h in y["Top hits"] + y["Further hits"]}
            assert set(hx) == set(hy)
            for t, h in hx.items():
                np.testing.assert_allclose(float(hy[t]["k-mer Score"]),
                                           float(h["k-mer Score"]),
                                           rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# the dispatch's caches and the port's isolation

def test_streamed_chunks_agree_with_device_cached(tmp_path, corpus):
    """Chunks uploaded for every batch (from host RAM, or reloaded from
    the npz cache) give the packed readback and counts of chunks kept on
    the device."""
    from kasa_tpu_torch.core.alphabet import build_codon_code_lut
    idx, fq, _ = corpus
    limbs, tax_rows, S = _load(idx)
    _, pd = _dispatches(idx, limbs, tax_rows, S, CORPUS_CHUNK, tmp_path)
    R = 128
    mat = np.full((R, 176), ord("X"), np.uint8)
    mat[:96] = _read_matrix(fq, 96)
    lut = torch.from_numpy(build_codon_code_lut().astype(np.int32))
    outs = []
    for dev_n, ram in ((len(pd.chunks), True), (1, True), (0, False)):
        pd._dev_chunks.clear()
        pd._ram_chunks.clear()
        pd._dev_cache_n, pd._ram_cache_ok = dev_n, ram
        pd._dev_cache_ok = dev_n >= len(pd.chunks)
        pd.streamed_bytes = 0
        ca, cu = pd.new_acc()
        for _ in range(2):
            handle, _, _ = pd.dispatch(mat, lut, ca, cu, R, 141, 4 * R)
        outs.append((pd.fetch(handle)[0].copy(), ca.numpy().copy(),
                     cu.numpy().copy(), pd.streamed_bytes))
        assert len(pd._dev_chunks) == dev_n
        assert len(pd._ram_chunks) == (len(pd.chunks) - dev_n if ram else 0)
    for packed, ca, cu, streamed in outs[1:]:
        np.testing.assert_array_equal(packed, outs[0][0])
        np.testing.assert_array_equal(cu, outs[0][2])
        np.testing.assert_allclose(ca, outs[0][1], rtol=RTOL, atol=ATOL)
        assert streamed > 0
    assert outs[0][3] == 0
    # the two fully streamed batches uploaded every chunk twice
    total = sum(sum(v.nbytes for k, v in _tabs(pd, ci).items() if k != "n")
                for ci in range(len(pd.chunks)))
    assert outs[2][3] == 2 * total


def test_tiered_runs_with_jax_blocked(tmp_path, corpus):
    """A fresh interpreter in which importing jax or kasa_tpu fails runs
    the tiered identify on the CPU (KASA_DEVICE_BUDGET of 64 KiB)."""
    idx, fq, _ = corpus
    code = f"""
import sys
sys.modules['jax'] = None
sys.modules['kasa_tpu'] = None
import torch
torch.set_num_threads(2)
from kasa_tpu_torch.config import Config
from kasa_tpu_torch.match import fast
from kasa_tpu_torch.match.pipeline import identify
cfg = Config()
cfg.content_file = {str(idx) + '_content.txt'!r}
cfg.temp_path = {str(tmp_path)!r}
out = identify(cfg, index_path={str(idx)!r}, input_path={fq!r},
               out_file={str(tmp_path / 'o.json')!r}, device='cpu')
assert out[2] == 600
assert type(fast.LAST_DISPATCH).__name__ == 'TieredTurboDispatch'
assert not any(m.startswith('jax') and sys.modules[m] is not None
               for m in sys.modules)
print('PORT-OK')
"""
    env = dict(os.environ, KASA_DEVICE_BUDGET=str(64 << 10))
    env.pop("JAX_PLATFORMS", None)
    r = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "PORT-OK" in r.stdout
    assert (tmp_path / "oocache_turbo_torch_0" / "turbo_stamp.txt").exists()
