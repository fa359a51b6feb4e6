"""The join engine of kasa_tpu_torch against kasa_tpu's, on the CPU.

Kernel level, on seeded numpy inputs at L = 2 (k levels 1..12) and L = 5
(k levels 20..25), with queries below and above every key and queries
with '^' letters:
  - the plain lower bound (ops/search.py) against searchsorted_limbs;
  - K10's plain version (match/join.py join_match_plain) against
    _match_one_keff and the cumulative '^' test of _letters_block;
  - K11's plain version (join_scatter_plain) against _score_scatter;
  - K12's plain version (sort_queries_plain) against sort_queries: the
    limb order identical, the read ids of each distinct window the same
    multiset (kasa_tpu's lax.sort is not stable; the port's order is
    (limbs..., read id)).
Engine level: match_and_score against kasa_tpu's on the golden 64- and
128-bit indices, plain, -e, --coverage and without score rows.
End to end: --coverage (which the default engine routes to the join
engine) and --engine join against kasa_tpu's runs and the goldens.

The contract: integers identical, floats within rtol 2e-5 / atol 1e-4;
the profiles, whose float64 group sums the port takes in kasa_tpu's
order, byte-identical."""

import filecmp
import json
import pathlib

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "golden"
FIXTURES = REPO / "fixtures"
CONTENT = GOLDEN / "exampleIndex_content.txt"
RTOL, ATOL = 2e-5, 1e-4


def _pack(letters):
    """(n, k) 5-bit letters -> (n, ceil(k / 6)) int32 limbs."""
    n, k = letters.shape
    out = np.zeros((n, -(-k // 6)), np.int32)
    for j in range(k):
        out[:, j // 6] |= letters[:, j].astype(np.int32) << (5 * (5 - j % 6))
    return out


def _index(highest_k, n, num_species, seed):
    """A sorted, deduplicated index of letters over a small alphabet, so
    that prefixes repeat at the low levels, with taxa from num_species;
    a third of the entries are copies of others with only their last
    six letters redrawn, so that groups of several taxa form at the top
    levels too."""
    rng = np.random.default_rng(seed)
    letters = rng.integers(1, 5, size=(n, highest_k))
    copies = letters[rng.integers(0, n, size=n // 3)].copy()
    copies[:, -6:] = rng.integers(1, 3, size=(len(copies), 6))
    letters = np.concatenate([letters, copies])
    limbs = _pack(letters)
    taxids = rng.integers(1, num_species, size=len(limbs)).astype(np.uint32)
    L = limbs.shape[1]
    order = np.lexsort((taxids,) + tuple(limbs[:, i]
                                         for i in range(L - 1, -1, -1)))
    limbs, taxids = limbs[order], taxids[order]
    keep = np.ones(len(taxids), bool)
    keep[1:] = np.any(limbs[1:] != limbs[:-1], axis=1) \
        | (taxids[1:] != taxids[:-1])
    return limbs[keep], taxids[keep]


def _queries(limbs, highest_k, M, R, seed):
    """M windows drawn from the index, 40 % with one letter changed, 15 %
    with a '^' letter at a random position, the first two rows below and
    above every key; read ids in [0, R)."""
    rng = np.random.default_rng(seed)
    q = limbs[rng.integers(0, len(limbs), size=M)].copy()
    for frac, code in ((0.4, None), (0.15, 30)):
        pick = np.nonzero(rng.random(M) < frac)[0]
        pos = rng.integers(0, highest_k, size=len(pick))
        sh = (5 * (5 - pos % 6)).astype(np.int32)
        new = (rng.integers(1, 6, size=len(pick)) if code is None
               else np.full(len(pick), code)).astype(np.int32)
        li = pos // 6
        q[pick, li] = (q[pick, li] & ~(31 << sh)) | (new << sh)
    q[0] = 0
    q[1] = (1 << 30) - 1
    rid = rng.integers(0, R, size=M).astype(np.int32)
    return q, rid


CASES = [
    # id, highest_k, min_k, max_k
    ("L2_k1_12", 12, 1, 12),
    ("L5_k20_25", 25, 20, 25),
]
S = 9


@pytest.fixture(scope="module", params=[c[1:] for c in CASES],
                ids=[c[0] for c in CASES])
def case(request):
    """An index and a batch with both packages' tables."""
    from kasa_tpu.match.join import DeviceIndex as JD
    from kasa_tpu_torch.match.device import StackedTables
    from kasa_tpu_torch.match.join import DeviceIndex as TD
    highest_k, min_k, max_k = request.param
    limbs, taxids = _index(highest_k, 3000, S, seed=highest_k)
    q, rid = _queries(limbs, highest_k, 2500, 40, seed=highest_k + 1)
    t2r = {t: t for t in range(S)}
    jd = JD(limbs, taxids, t2r, highest_k, min_k, max_k, S)
    ts = StackedTables.build(TD(limbs, taxids, t2r, highest_k, min_k, max_k,
                                S, "cpu"))
    return dict(limbs=limbs, q=q, rid=rid, jd=jd, ts=ts, min_k=min_k,
                max_k=max_k)


def test_lower_bound_against_searchsorted_limbs(case):
    """The port's lower bound equals kasa_tpu's, except that kasa_tpu's
    fixed-step bisect ends at n + 1 above every key, where the port ends
    at n (ops/search.py)."""
    import jax.numpy as jnp
    from kasa_tpu.ops.search import num_steps_for, searchsorted_limbs
    from kasa_tpu_torch.ops.search import lower_bound_plain
    limbs, q = case["limbs"], case["q"]
    n = len(limbs)
    want = np.asarray(searchsorted_limbs(jnp.asarray(limbs), jnp.asarray(q),
                                         num_steps_for(n)))
    got = lower_bound_plain(torch.from_numpy(limbs),
                            torch.from_numpy(q)).numpy()
    assert want[1] == n + 1 and got[1] == n and got[0] == 0
    np.testing.assert_array_equal(got, np.minimum(want, n))


def test_join_match_plain_against_jax(case):
    """K10's plain version: per level the match flag, group, T and start
    equal _match_one_keff's, and ok equals the cumulative '^' test of
    _letters_block (join.py:280-285)."""
    import jax.numpy as jnp
    from kasa_tpu.match.join import _letters_block, _match_one_keff
    from kasa_tpu_torch.match.join import join_match_plain
    jd, ts, q = case["jd"], case["ts"], case["q"]
    min_k, max_k = case["min_k"], case["max_k"]
    matched, g, T, start, ok = (a.numpy() for a in join_match_plain(
        ts, torch.from_numpy(q)))
    qj = jnp.asarray(q)
    letters = np.asarray(_letters_block(qj, tuple(range(min_k - 1, max_k))))
    cum_ok = np.cumprod(letters != 30, axis=1).astype(bool)
    hits = 0
    for k in range(min_k, max_k + 1):
        jt = jd.tables[k]
        jm, jg, jT, js = (np.asarray(a) for a in _match_one_keff(
            jd.idx_limbs, jt.grp_id, jt.grp_start, jt.mask, qj,
            jd.num_steps))
        ki = max_k - k
        np.testing.assert_array_equal(matched[ki], jm)
        np.testing.assert_array_equal(g[ki], jg)
        np.testing.assert_array_equal(T[ki], jT)
        np.testing.assert_array_equal(start[ki], js)
        np.testing.assert_array_equal(ok[ki], cum_ok[:, k - min_k])
        hits += int((jm & cum_ok[:, k - min_k]).sum())
        assert not jm[:2].any()
    # every regime occurs: matches, misses, '^' blocked levels, T > 1
    assert 0 < hits < matched.size and not ok.all() and (T > 1).any()


def test_join_scatter_plain_against_jax(case):
    """K11's plain version against _score_scatter, level by level in
    kasa_tpu, all levels at once in the port."""
    import jax.numpy as jnp
    from kasa_tpu.match.join import _score_scatter, weight
    from kasa_tpu_torch.match.join import join_match_plain, join_scatter_plain
    jd, ts, q, rid = case["jd"], case["ts"], case["q"], case["rid"]
    max_k, R = case["max_k"], 40
    matched, g, T, start, ok = join_match_plain(ts, torch.from_numpy(q))
    valid = matched & ok
    got = join_scatter_plain(ts, valid, T, start, torch.from_numpy(rid),
                             R).numpy()
    scores = jnp.zeros((R, S), jnp.float32)
    for ki in range(ts.num_k):
        v = valid[ki].numpy()
        occ_T = T[ki].numpy()[v].astype(np.int64)
        cum = np.zeros(len(occ_T) + 1, np.int64)
        np.cumsum(occ_T, out=cum[1:])
        val = np.float32(weight(max_k - ki)) \
            * (np.float32(1.0) / occ_T.astype(np.float32))
        scores = _score_scatter(
            jnp.asarray(cum.astype(np.int32)),
            jnp.asarray(start[ki].numpy()[v]), jnp.asarray(val),
            jnp.asarray(rid[v]), jd.tables[max_k - ki].d_tax,
            jnp.zeros(len(occ_T), jnp.int32), scores,
            1 << (int(cum[-1]) - 1).bit_length(), S)
    want = np.asarray(scores)
    assert (want > 0).sum() > 50
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_read_order_plain_against_jax(case):
    """K11's read arm and K10's read-order records, plain versions,
    against kasa_tpu: the batch's read ids made ascending (encode_batch's
    layout), K12's plain version carrying each window's position, K10's
    heads at those positions equal to what _match_one_keff and
    _letters_block give each window in the batch's own order (lo its
    first valid level, hi its first valid level of T > 1, the taxon of a
    T = 1 level at lo; wide_at its sorted row where hi < numK), the
    levels nested as the read arm relies on (valid from lo to the last
    level, T not falling, one taxon over the T = 1 levels), and the read
    arm's scores equal to _score_scatter's of the same windows: hit
    cells identical, scores within the contract."""
    import jax.numpy as jnp
    from kasa_tpu.match.join import (_letters_block, _match_one_keff,
                                     _score_scatter, weight)
    from kasa_tpu_torch.match.join import (join_match_plain,
                                           join_scatter_reads_plain,
                                           pack_heads, sort_queries_plain,
                                           unpack_heads)
    jd, ts, q = case["jd"], case["ts"], case["q"]
    min_k, max_k, R = case["min_k"], case["max_k"], 40
    rid = np.sort(case["rid"])
    M = len(rid)
    qs, pos = sort_queries_plain(torch.from_numpy(q),
                                 torch.arange(M, dtype=torch.int32))
    assert sorted(pos.tolist()) == list(range(M))
    _, _, Tk, sk, _, heads, wide_at = join_match_plain(ts, qs, pos)
    nk = ts.num_k
    qj = jnp.asarray(q)
    letters = np.asarray(_letters_block(qj, tuple(range(min_k - 1, max_k))))
    cum_ok = np.cumprod(letters != 30, axis=1).astype(bool)
    scores = jnp.zeros((R, S), jnp.float32)
    valid = np.zeros((nk, M), bool)
    T = np.zeros((nk, M), np.int64)
    taxon = np.full((nk, M), -1, np.int64)
    for k in range(min_k, max_k + 1):
        jt = jd.tables[k]
        jm, _, jT, js = (np.asarray(a) for a in _match_one_keff(
            jd.idx_limbs, jt.grp_id, jt.grp_start, jt.mask, qj,
            jd.num_steps))
        ki = max_k - k
        v = jm & cum_ok[:, k - min_k]
        valid[ki], T[ki] = v, jT
        dt = np.asarray(jt.d_tax)
        taxon[ki] = np.where(v & (jT == 1), dt[np.where(jT == 1, js, 0)], -1)
        occ_T = jT[v].astype(np.int64)
        cum = np.zeros(len(occ_T) + 1, np.int64)
        np.cumsum(occ_T, out=cum[1:])
        val = np.float32(weight(k)) \
            * (np.float32(1.0) / occ_T.astype(np.float32))
        scores = _score_scatter(
            jnp.asarray(cum.astype(np.int32)), jnp.asarray(js[v]),
            jnp.asarray(val), jnp.asarray(rid[v]), jt.d_tax,
            jnp.zeros(len(occ_T), jnp.int32), scores,
            1 << (int(cum[-1]) - 1).bit_length(), S)
    kis = np.arange(nk)[:, None]
    lo = np.where(valid, kis, nk).min(axis=0)
    hi = np.where(valid & (T > 1), kis, nk).min(axis=0)
    # the nesting: valid from lo on, T not falling, one T = 1 taxon
    np.testing.assert_array_equal(valid, kis >= lo)
    assert bool((np.diff(np.where(valid, T, 0), axis=0)[valid[:-1]]
                 >= 0).all())
    x = taxon[np.minimum(lo, nk - 1), np.arange(M)]
    one = (kis >= lo) & (kis < hi)
    np.testing.assert_array_equal(np.where(one, taxon, -1),
                                  np.where(one, x, -1))
    heads, wide_at = heads.numpy(), wide_at.numpy()
    np.testing.assert_array_equal(
        unpack_heads(heads), (np.where(lo < hi, x, -1), lo, hi))
    np.testing.assert_array_equal(heads, pack_heads(
        np.where(lo < hi, x, -1), lo, hi))
    inv = np.argsort(pos.numpy())
    np.testing.assert_array_equal(wide_at, np.where(hi < nk, inv, -1))
    assert (lo < hi).sum() > 100 and (hi < nk).sum() > 100
    got = join_scatter_reads_plain(ts, torch.from_numpy(heads),
                                   torch.from_numpy(wide_at), Tk, sk,
                                   torch.from_numpy(rid), R).numpy()
    want = np.asarray(scores)
    assert (want > 0).sum() > 50
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("taxon,lo,hi", [
    (-1, 25, 25), (0, 0, 0), (32_766, 0, 25), (32_766, 24, 25),
    (12_345, 3, 7)])
def test_head_packing(taxon, lo, hi):
    """K10's 4-byte heads (csrc/common.cuh pack_head, join.pack_heads):
    the taxon + 1 in 15 bits, lo and hi up to numK = 25 in 5 bits each;
    every edge packs to a non-negative int32 and unpacks to itself, in
    torch and numpy alike."""
    from kasa_tpu_torch.match.join import HEAD_S_MAX, pack_heads, \
        unpack_heads
    assert taxon < HEAD_S_MAX
    h = pack_heads(torch.tensor([taxon], dtype=torch.int32),
                   torch.tensor([lo], dtype=torch.int32),
                   torch.tensor([hi], dtype=torch.int32))
    assert h.dtype == torch.int32 and 0 <= int(h) < 1 << 25
    assert [int(x) for x in unpack_heads(h)] == [taxon, lo, hi]
    hn = pack_heads(np.int32(taxon), np.int32(lo), np.int32(hi))
    assert int(hn) == int(h)
    assert [int(x) for x in unpack_heads(hn)] == [taxon, lo, hi]


@pytest.mark.parametrize("past", [False, True], ids=["widest", "past"])
def test_heads_widest_taxon_against_jax(past):
    """The heads at the edge of their packing, against kasa_tpu: an index
    of HEAD_S_MAX species whose taxa are the top ones, so that T = 1
    groups name taxon HEAD_S_MAX - 1; join_match_plain's heads unpack to
    the lo, hi and taxon kasa_tpu's _match_one_keff and _letters_block
    give each window.  One species more and the plain version refuses
    heads, and the CPU's scatter arm is the global one."""
    import jax.numpy as jnp
    from kasa_tpu.match.join import DeviceIndex as JD
    from kasa_tpu.match.join import _letters_block, _match_one_keff
    from kasa_tpu_torch.match import join as J
    from kasa_tpu_torch.match.device import StackedTables
    hk, min_k, max_k = 12, 7, 12
    S = J.HEAD_S_MAX + past
    limbs, _ = _index(hk, 2000, 9, seed=41)
    rng = np.random.default_rng(42)
    taxids = rng.integers(S - 4, S, size=len(limbs)).astype(np.uint32)
    t2r = {t: t for t in range(S - 4, S)}
    ts = StackedTables.build(J.DeviceIndex(limbs, taxids, t2r, hk, min_k,
                                           max_k, S, "cpu"))
    q, _ = _queries(limbs, hk, 1500, 1, seed=43)
    M = len(q)
    qs, pos = J.sort_queries_plain(torch.from_numpy(q),
                                   torch.arange(M, dtype=torch.int32))
    if past:
        with pytest.raises(ValueError):
            J.join_match_plain(ts, qs, pos)
        assert J.scatter_arm(ts, True, 1 << 20) == "global"
        return
    assert J.scatter_arm(ts, True, 1 << 20) == "reads"
    heads = J.join_match_plain(ts, qs, pos)[5].numpy()
    jd = JD(limbs, taxids, t2r, hk, min_k, max_k, S)
    nk = ts.num_k
    qj = jnp.asarray(q)
    letters = np.asarray(_letters_block(qj, tuple(range(min_k - 1, max_k))))
    cum_ok = np.cumprod(letters != 30, axis=1).astype(bool)
    valid = np.zeros((nk, M), bool)
    T = np.zeros((nk, M), np.int64)
    taxon = np.full((nk, M), -1, np.int64)
    for k in range(min_k, max_k + 1):
        jt = jd.tables[k]
        jm, _, jT, js = (np.asarray(a) for a in _match_one_keff(
            jd.idx_limbs, jt.grp_id, jt.grp_start, jt.mask, qj,
            jd.num_steps))
        ki = max_k - k
        valid[ki] = jm & cum_ok[:, k - min_k]
        T[ki] = jT
        dt = np.asarray(jt.d_tax)
        taxon[ki] = np.where(valid[ki] & (jT == 1),
                             dt[np.where(jT == 1, js, 0)], -1)
    kis = np.arange(nk)[:, None]
    lo = np.where(valid, kis, nk).min(axis=0)
    hi = np.where(valid & (T > 1), kis, nk).min(axis=0)
    x = np.where(lo < hi, taxon[np.minimum(lo, nk - 1), np.arange(M)], -1)
    np.testing.assert_array_equal(J.unpack_heads(heads), (x, lo, hi))
    assert int(x.max()) == S - 1 and (lo < hi).sum() > 100


def test_sort_queries_plain_against_jax(case):
    """K12's plain version: kasa_tpu's limb order, and per distinct
    window the same read ids, which the port orders ascending."""
    from kasa_tpu.match.join import sort_queries
    from kasa_tpu_torch.match.join import sort_queries_plain
    q, rid = case["q"], case["rid"]
    wq, wr = sort_queries(q, rid)
    gq, gr = (a.numpy() for a in sort_queries_plain(torch.from_numpy(q),
                                                     torch.from_numpy(rid)))
    np.testing.assert_array_equal(gq, wq)
    new = np.r_[True, np.any(gq[1:] != gq[:-1], axis=1)]
    grp = np.cumsum(new)
    np.testing.assert_array_equal(gr, wr[np.lexsort((wr, grp))])
    assert (~new).sum() > 100


# ---------------------------------------------------------------------------
# match_and_score on the golden indices

def _golden_batch(index, min_k):
    """The first batch of fixtures/reads.fastq, encoded by kasa_tpu."""
    from kasa_tpu.core.encode import Encoder
    from kasa_tpu.index import artifacts
    from kasa_tpu.match import ingest
    from kasa_tpu.match.pipeline import encode_batch, load_content_for_identify
    limbs, taxids, hk, _ = artifacts.read_index(str(GOLDEN / index))
    content = load_content_for_identify(str(CONTENT))
    batch = next(ingest.read_file_batches(
        str(FIXTURES / "reads.fastq"), ingest.BatchBuilder(hk, min_k)))
    q, r = encode_batch(batch, Encoder(device=False), hk, False, False)
    return limbs, taxids, hk, content, q, r, batch.num_reads


MODES = [
    ("plain", {}),
    ("unique", {"unique": True}),
    ("coverage", {"coverage": True}),
    ("no_scores", {"want_scores": False}),
]


@pytest.mark.parametrize("index,min_k,max_k", [
    ("exampleIndex", 7, 12), ("exampleIndex128", 20, 25)],
    ids=["exampleIndex", "exampleIndex128"])
def test_match_and_score_against_jax(index, min_k, max_k):
    """The port's match_and_score (K12, K10, K11 plain versions, host
    statistics) against kasa_tpu's on the first batch of
    fixtures/reads.fastq, in every mode: counts_all bit-identical (the
    same float64 sums in the same order), counts_unique and counts_total
    identical, scores within the contract."""
    from kasa_tpu.match.join import DeviceIndex as JD
    from kasa_tpu.match.join import match_and_score as jms
    from kasa_tpu_torch.match.device import StackedTables
    from kasa_tpu_torch.match.join import DeviceIndex as TD
    from kasa_tpu_torch.match.join import JoinIndex
    from kasa_tpu_torch.match.join import match_and_score as tms
    limbs, taxids, hk, content, q, r, R = _golden_batch(index, min_k)
    S_ = content.num_species
    t2r = content.tax_to_idx
    jd = JD(limbs, taxids, t2r, hk, min_k, max_k, S_)
    ji = JoinIndex(StackedTables.build(TD(limbs, taxids, t2r, hk, min_k,
                                          max_k, S_, "cpu")))
    for tag, kw in MODES:
        want = jms(jd, q, r, R, **kw)
        got = tms(ji, q, r, R, **kw)
        np.testing.assert_array_equal(got.counts_all, want.counts_all,
                                      err_msg=tag)
        np.testing.assert_array_equal(got.counts_unique, want.counts_unique)
        np.testing.assert_array_equal(got.counts_total, want.counts_total)
        assert got.counts_unique.sum() > 0
        if tag == "coverage":
            assert got.counts_total.sum() > 0
        np.testing.assert_array_equal(got.scores > 0, want.scores > 0)
        np.testing.assert_allclose(got.scores, want.scores, rtol=RTOL,
                                   atol=ATOL, err_msg=tag)


@pytest.mark.parametrize("index,min_k,max_k", [
    ("exampleIndex", 7, 12), ("exampleIndex128", 20, 25)],
    ids=["exampleIndex", "exampleIndex128"])
def test_match_and_score_read_arm(monkeypatch, index, min_k, max_k):
    """match_and_score takes K11's read arm on a batch whose read ids
    ascend (K12 carrying positions, K10 its records) and the global arm
    under -e; the read arm's scores equal the global arm's on the same
    batch (hit cells identical, within the contract), its counts
    identical."""
    from kasa_tpu_torch.match import join as J
    from kasa_tpu_torch.match.device import StackedTables
    limbs, taxids, hk, content, q, r, R = _golden_batch(index, min_k)
    t2r = content.tax_to_idx
    ji = J.JoinIndex(StackedTables.build(J.DeviceIndex(
        limbs, taxids, t2r, hk, min_k, max_k, content.num_species, "cpu")))
    assert bool((np.diff(r) >= 0).all())
    calls = []
    for name in ("join_scatter_reads", "join_scatter"):
        orig = getattr(J, name)
        monkeypatch.setattr(J, name, lambda *a, _o=orig, _n=name: (
            calls.append(_n), _o(*a))[1])
    reads = J.match_and_score(ji, q, r, R, coverage=True)
    assert calls == ["join_scatter_reads"]
    J.match_and_score(ji, q, r, R, unique=True)
    assert calls[1:] == ["join_scatter"]
    monkeypatch.setattr(J, "scatter_arm", lambda t, read_order, R: "global")
    glob = J.match_and_score(ji, q, r, R, coverage=True)
    assert calls[2:] == ["join_scatter"]
    for f in ("counts_all", "counts_unique", "counts_total"):
        np.testing.assert_array_equal(getattr(reads, f), getattr(glob, f))
    assert (glob.scores > 0).sum() > 0
    np.testing.assert_array_equal(reads.scores > 0, glob.scores > 0)
    np.testing.assert_allclose(reads.scores, glob.scores, rtol=RTOL,
                               atol=ATOL)


# ---------------------------------------------------------------------------
# end to end

def _run(pkg, index, inp, over, stem):
    if pkg == "jax":
        from kasa_tpu.config import Config
        from kasa_tpu.match.pipeline import identify
        kw = {}
    else:
        from kasa_tpu_torch.config import Config
        from kasa_tpu_torch.match.pipeline import identify
        kw = {"device": "cpu"}
    cfg = Config()
    cfg.content_file = str(CONTENT)
    cfg.engine = "tpu"
    for k, v in over.items():
        setattr(cfg, k, v)
    out = stem.parent / (stem.name + f"_{pkg}")
    identify(cfg, index_path=str(GOLDEN / index), input_path=inp,
             out_file=str(out) + ".json", profile_file=str(out) + ".csv",
             **kw)
    return pathlib.Path(str(out) + ".json"), pathlib.Path(str(out) + ".csv")


def _json_agrees(ref_path, got_path):
    ref, got = json.load(open(ref_path)), json.load(open(got_path))
    assert len(ref) == len(got) > 0
    for a, b in zip(ref, got):
        for f in ("Read number", "Specifier from input file", "Length"):
            assert a[f] == b[f]
        ha = {h["tax ID"]: h for h in a["Top hits"] + a["Further hits"]}
        hb = {h["tax ID"]: h for h in b["Top hits"] + b["Further hits"]}
        assert set(ha) == set(hb), f"read {a['Read number']}: hit taxa"
        for t, h in ha.items():
            np.testing.assert_allclose(float(hb[t]["k-mer Score"]),
                                       float(h["k-mer Score"]),
                                       rtol=RTOL, atol=ATOL)


def test_coverage_default_engine_against_golden(tmp_path, capsys):
    """--coverage on the default engine takes the join engine in both
    packages (the same OUT: line): the profile, genome coverage columns
    and all, byte-identical to the reference binary's
    (tests/golden/reads_cov_profile.csv) and to kasa_tpu's; the per-read
    scores, float32 sums taken in another order, within the contract of
    the golden and of kasa_tpu's run."""
    inp = str(FIXTURES / "reads.fastq")
    jj, jp = _run("jax", "exampleIndex", inp, {"coverage": True},
                  tmp_path / "cov")
    jax_out = capsys.readouterr().out
    tj, tp = _run("torch", "exampleIndex", inp, {"coverage": True},
                  tmp_path / "cov")
    assert "OUT: --coverage uses the join engine" in jax_out
    assert "OUT: --coverage uses the join engine" in capsys.readouterr().out
    assert filecmp.cmp(tp, GOLDEN / "reads_cov_profile.csv", shallow=False)
    assert filecmp.cmp(tp, jp, shallow=False)
    _json_agrees(GOLDEN / "reads_cov.json", tj)
    _json_agrees(jj, tj)


JOIN_CASES = [
    # tag, index, input, overrides
    ("default", "exampleIndex", "reads.fastq", {}),
    ("k12", "exampleIndex", "reads.fastq", {"lower_k": 12, "higher_k": 12}),
    ("six", "exampleIndex", "reads.fastq", {"six_frames": True}),
    ("one", "exampleIndex", "reads.fastq", {"one_frame": True}),
    ("unique", "exampleIndex", "reads.fastq", {"unique": True}),
    ("fasta", "exampleIndex", "reads.fasta", {}),
    ("gz", "exampleIndex", "reads.fastq.gz", {}),
    ("edge", "exampleIndex", "edge.fasta", {}),
    ("coverage", "exampleIndex", "reads.fastq", {"coverage": True}),
    ("paired", "exampleIndex", "",
     {"paired_end_1": str(FIXTURES / "reads_1.fastq"),
      "paired_end_2": str(FIXTURES / "reads_2.fastq")}),
    ("k25_20", "exampleIndex128", "reads.fastq",
     {"lower_k": 20, "higher_k": 25}),
    ("k25_20_unique", "exampleIndex128", "reads.fastq",
     {"lower_k": 20, "higher_k": 25, "unique": True}),
]


@pytest.mark.parametrize("index,inp,over", [c[1:] for c in JOIN_CASES],
                         ids=[c[0] for c in JOIN_CASES])
def test_engine_join_against_jax(tmp_path, index, inp, over):
    """--engine join: the profile byte-identical to kasa_tpu's join run,
    the per-read output within the contract."""
    over = dict(over, engine="join")
    inp = str(FIXTURES / inp) if inp else ""
    jj, jp = _run("jax", index, inp, over, tmp_path / "j")
    tj, tp = _run("torch", index, inp, over, tmp_path / "j")
    assert filecmp.cmp(tp, jp, shallow=False)
    _json_agrees(jj, tj)
