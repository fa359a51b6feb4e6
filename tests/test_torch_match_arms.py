"""K2's search and K11's arms, on the CPU.

K2 (csrc/turbo_match.cu) runs one thread a window: after the router and
the sub-router, the warp copies, in two rounds of 16 windows, the rows
[lo - 1, hi] of each window's bucket (up to 32 rows at L = 2, 8 above,
as the 16-byte chunks of rowdat around them, packed into the round's
pool of shared memory), then each thread runs the reference's
fixed-step bisect over its copy, a row outside it coming from memory (a
bucket wider than a copy first steps through keys2 in memory until its
range fits; a window that finds the pool full reads every row from
memory).  search_model is that search in numpy, lane for lane; it must
give the pos of turbo_search_plain on every window, at L = 2..5, on
tables built to hit every edge (edge_case: a bucket of exactly RESID
rows, fat buckets through the sub-router, a sub-bucket of 40 rows that
takes num_steps to 6, windows below and above every key and with '^'
letters) and on a table of kasa_tpu_torch/synth.py's generator.  The
card tests (tests/test_torch_kernels.py) hold the kernel to
turbo_match_plain on the same tables.

K11 (csrc/join_scatter.cu) runs one thread per (level, occurrence),
whose T terms add in float64 to its read's row: scatter_model is that in
numpy, held to join_scatter_plain on the cases the card tests run
(scatter_case).  Both plain versions are held to kasa_tpu on the same
edge inputs: turbo_match_plain through the batch step against
turbo_classify, join_scatter_plain against _score_scatter."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

CAP = {2: 32, 3: 8, 4: 8, 5: 8}   # rows a window's copy holds (kCap)
PART = 16                    # windows a round copies
POOL = 256                   # 16-byte chunks the copies of a round share
HK = {2: 12, 3: 18, 4: 24, 5: 25}
S = 12


def _pack(letters):
    """(n, k) 5-bit letters -> (n, ceil(k / 6)) int32 limbs."""
    n, k = letters.shape
    out = np.zeros((n, -(-k // 6)), np.int32)
    for j in range(k):
        out[:, j // 6] |= letters[:, j].astype(np.int32) << (5 * (5 - j % 6))
    return out


def _shared_prefix(rng, n, hk, p):
    """n keys of hk letters sharing their first p letters; at p = 5 the
    fifth letter's low bit is free (limb 0's top 24 bits, the router's
    bucket, shared; the sub-router's first bit not)."""
    letters = rng.integers(1, 26, size=(n, hk))
    letters[:, :p] = letters[0, :p]
    if p == 5:
        letters[:, 4] = (letters[0, 4] & ~1) | rng.integers(0, 2, n)
    return letters


def edge_case(L, case, index=False):
    """Turbo tables (arrays, meta) of an index of 64- (L = 2) or 128-bit
    keys (L = 3..5: highestK 18, 24, 25; k levels highestK - 5 ..
    highestK) and windows (M, L) int32 that reach every edge of K2's
    search: 3,000 random keys; a router bucket of exactly RESID = 8 rows
    (limb 0's top 24 bits shared); a fat bucket of 80 keys through the
    sub-router (sub-buckets of up to 9-10 rows); under case "deep" a
    sub-bucket of 40 keys (the first 10 letters shared: every sub-router
    bit), so that num_steps is 6 (4 otherwise), wider than a window's
    copy of 32 rows; a third of the keys twice, with a
    second taxon (T = 2).  Windows: every special key as is and with one
    letter from the sixth on redrawn, random keys as is and with a
    letter past min_k redrawn, random windows, 300 with a '^' letter,
    one below every key (all letters 0), one above every key (all 29)
    and one just above the largest key.  index: also return the index's
    (limbs, taxids)."""
    from kasa_tpu_torch.match import turbo as PT
    hk = HK[L]
    rng = np.random.default_rng(100 * L + (case == "deep"))
    parts = [rng.integers(1, 26, size=(3000, hk)),
             _shared_prefix(rng, PT.RESID, hk, 5),
             _shared_prefix(rng, 80, hk, 5)]
    if case == "deep":
        parts.append(_shared_prefix(rng, 40, hk, 10))
    keys = np.unique(_pack(np.concatenate(parts)), axis=0)
    twice = keys[rng.random(len(keys)) < 1 / 3]
    limbs = np.concatenate([keys, twice])
    taxids = np.concatenate([rng.integers(0, S, len(keys)),
                             rng.integers(0, S, len(twice))])
    order = np.lexsort((taxids,) + tuple(limbs[:, i]
                                         for i in range(L - 1, -1, -1)))
    limbs, taxids = limbs[order], taxids[order]
    keep = np.ones(len(limbs), bool)
    keep[1:] = np.any(limbs[1:] != limbs[:-1], axis=1) \
        | (taxids[1:] != taxids[:-1])
    limbs, taxids = limbs[keep], taxids[keep].astype(np.int32)
    arrays, meta = PT.build_tables_np(limbs, taxids, hk, hk - 5, hk, S)

    special = np.concatenate(parts[1:])
    redrawn = special.copy()
    col = rng.integers(5, hk, size=len(redrawn))
    redrawn[np.arange(len(redrawn)), col] = rng.integers(1, 26,
                                                         len(redrawn))
    some = parts[0][:1500].copy()
    some[np.arange(1500), rng.integers(hk - 6, hk, 1500)] = \
        rng.integers(1, 26, 1500)
    hat = rng.integers(1, 26, size=(300, hk))
    hat[np.arange(300), rng.integers(0, hk, 300)] = 30
    top = np.zeros((1, hk), np.int64)
    top_key = limbs[-1:].copy()
    last = hk - 1
    letter = (top_key[0, last // 6] >> (5 * (5 - last % 6))) & 31
    top_key[0, last // 6] += 1 << (5 * (5 - last % 6))
    assert letter < 29
    q = np.concatenate([_pack(special), _pack(redrawn), _pack(parts[0]),
                        _pack(some), _pack(rng.integers(0, 30, (500, hk))),
                        _pack(hat), _pack(top), _pack(top + 29), top_key])
    q = np.ascontiguousarray(q, np.int32)
    return (arrays, meta, q) + ((limbs, taxids) if index else ())


def _lex_less(rows, q):
    """rows < q, lexicographic over the limbs (as the kernels compare)."""
    L = q.shape[1]
    less = rows[:, L - 1] < q[:, L - 1]
    for i in range(L - 2, -1, -1):
        less = (rows[:, i] < q[:, i]) | ((rows[:, i] == q[:, i]) & less)
    return less


def search_model(arrays, meta, q):
    """K2's search in numpy, lane for lane -> (pos, the rows at pos_c and
    prev_c, {"copy": gathers served by a window's copy, "memory": by
    memory, "steps_from_memory": bisect steps before the copy})."""
    n, ns = meta["n"], meta["num_steps"]
    keys2, rowdat = arrays["keys2"], arrays["rowdat"]
    router, sub2 = arrays["router"], arrays["sub2"]
    M, L = q.shape
    W = L + 2
    q0, q1 = q[:, 0].astype(np.int64), q[:, 1].astype(np.int64)
    rr = router[q0 >> 6]
    lo, hi = rr[:, 0].astype(np.int64), rr[:, 1].astype(np.int64)
    fat = hi < 0
    code = -hi[fat]
    subkey = ((q0[fat] & 0x3F) << 18) | (q1[fat] >> 12)
    srow = sub2[(code >> 5) + (subkey >> (24 - (code & 31)))]
    lo[fat], hi[fat] = srow[:, 0], srow[:, 1]
    stats = {"copy": 0, "memory": 0, "steps_from_memory": 0}
    # a bucket wider than a copy: its first steps from keys2
    step = np.zeros(M, np.int64)
    for s in range(ns):
        act = (step == s) & (hi - lo + 2 > CAP[L])
        mid = (lo + hi) >> 1
        less = _lex_less(keys2[np.minimum(mid, n - 1)], q)
        lo = np.where(act & less, mid + 1, lo)
        hi = np.where(act & ~less, mid, hi)
        step += act
        stats["steps_from_memory"] += int(act.sum())
    # rows [cs, ce] as the 16-byte chunks [a0, a0 + 16 n16) of rowdat,
    # packed in the pool of the window's round (16 windows of a warp)
    cs = np.maximum(lo - 1, 0)
    ce = np.minimum(np.minimum(hi, n - 1), cs + CAP[L] - 1)
    b0 = cs * W * 4
    a0 = b0 & ~15
    n16 = np.where(ce >= cs, ((((ce + 1) * W * 4 + 15) & ~15) - a0) >> 4, 0)
    pad = np.zeros(-len(n16) % PART, np.int64)
    per_part = np.concatenate([n16, pad]).reshape(-1, PART)
    off16 = (np.cumsum(per_part, axis=1) - per_part).reshape(-1)[:M]
    full = off16 + n16 > POOL
    n16[full], cs[full], ce[full] = 0, 1, 0
    flat = np.concatenate([rowdat.reshape(-1), np.zeros(4, np.int32)])
    pool = np.zeros((len(per_part), POOL * 4), np.int32)
    win = np.repeat(np.arange(M), n16 * 4)
    k = np.arange(len(win)) - np.repeat(np.cumsum(n16 * 4) - n16 * 4,
                                        n16 * 4)
    pool[win // PART, off16[win] * 4 + k] = flat[a0[win] // 4 + k]

    def row(r):
        held = (r >= cs) & (r <= ce)
        at = off16 * 4 + (b0 - a0) // 4 + (r - cs) * W
        out = pool[np.arange(M)[:, None] // PART,
                   np.clip(at, 0, POOL * 4 - W)[:, None]
                   + np.arange(W)[None, :]]
        out[~held] = rowdat[r[~held]]
        stats["copy"] += int(held.sum())
        stats["memory"] += int((~held).sum())
        return out

    for s in range(ns):
        act = s < ns - step
        mid = (lo + hi) >> 1
        less = _lex_less(row(np.minimum(mid, n - 1))[:, :L], q)
        lo = np.where(act & less, mid + 1, lo)
        hi = np.where(act & ~less, mid, hi)
    pos = lo
    at = row(np.minimum(pos, n - 1))
    pv = row(np.minimum(np.maximum(pos - 1, 0), n - 1))
    return pos, at, pv, stats


def _check_model(arrays, meta, q):
    from kasa_tpu_torch.match import turbo as PT
    tt = PT.tables_from_numpy(arrays, meta, "cpu")
    want = PT.turbo_search_plain(torch.from_numpy(q), tt).numpy()
    pos, at, pv, stats = search_model(arrays, meta, q)
    np.testing.assert_array_equal(pos, want)
    n = meta["n"]
    np.testing.assert_array_equal(at, arrays["rowdat"][np.minimum(pos,
                                                                  n - 1)])
    np.testing.assert_array_equal(
        pv, arrays["rowdat"][np.minimum(np.maximum(pos - 1, 0), n - 1)])
    return want, stats


@pytest.mark.parametrize("case", ["resid", "deep"])
@pytest.mark.parametrize("L", [2, 3, 4, 5])
def test_search_model_matches_plain_on_edges(L, case):
    """The model of K2's search gives turbo_search_plain's pos on every
    edge window, with the rows at pos and pos - 1 of the reference."""
    arrays, meta, q = edge_case(L, case)
    assert meta["num_steps"] == (6 if case == "deep" else 4)
    pos, stats = _check_model(arrays, meta, q)
    n = meta["n"]
    assert (pos == 0).any() and (pos == n + 1).any()
    assert (arrays["router"][:, 1] < 0).any()
    # at L = 2 the 40-row sub-bucket steps from keys2 until it fits a
    # copy, and its 40 windows in a row fill their rounds' pools: the
    # windows past the pool read from memory; at L = 3..5 the 8-row
    # bucket and the fat buckets' sub-buckets step too, and the pools
    # never fill; elsewhere the copies serve every gather, the clamped
    # rows past the last key too
    deep = case == "deep"
    assert (stats["steps_from_memory"] > 0) == (deep or L > 2)
    assert stats["copy"] > 0
    assert (stats["memory"] > 0) == (deep and L == 2)


@pytest.mark.parametrize("case", ["resid", "deep"])
@pytest.mark.parametrize("L", [2, 3, 4, 5])
def test_turbo_plain_matches_reference_on_edges(L, case):
    """The port's batch step (turbo_core, whose slots come from
    turbo_match_plain) against kasa_tpu's turbo_classify (_turbo_core) on
    the edge tables and windows, one window a read: tables identical,
    hit lists, counts and flags identical, floats within the contract.
    With the card tests (K2 bit for bit against turbo_match_plain on the
    same tables) the chain kernel -> plain version -> reference closes on
    these edges."""
    import jax.numpy as jnp
    import kasa_tpu.match.turbo as JT
    from kasa_tpu_torch.match import turbo as PT
    from test_torch_tables import _assert_same_arrays, jax_arrays
    arrays, meta, q, limbs, taxids = edge_case(L, case, index=True)
    hk = HK[L]
    jt = JT.TurboTables.build_from_arrays(limbs, taxids, hk, hk - 5, hk, S)
    ja, jm = jax_arrays(jt)
    _assert_same_arrays(arrays, ja)
    assert meta == jm
    tt = PT.tables_from_numpy(arrays, meta, "cpu")
    R = q.shape[0]
    ht_j, hk_j, hc_j, ca_j, cu_j, ofc_j, ofl_j = [
        np.asarray(o) for o in JT.turbo_classify(
            jt.keys2, jt.rowdat, jt.router, jt.sub2, jt.grp2, jt.d_tax4,
            jt.weights, jt.masks2, jt.hotmask, jt.t_hot, jnp.asarray(q),
            jt.num_steps, hk - 5, hk, hk, S, R, 1)]
    ca = torch.zeros((6, S))
    cu = torch.zeros((6, S), dtype=torch.int32)
    # kasa_tpu's hit lists are as wide as a read's slots allow
    packed, ht, hks = PT.turbo_core(tt, torch.from_numpy(q), R, 1, ca, cu,
                                    160 * R, wout=ht_j.shape[1])
    packed = packed.numpy()
    flags = packed[R:2 * R]
    np.testing.assert_array_equal(packed[:R], hc_j)
    np.testing.assert_array_equal(flags & 1, ofc_j.astype(np.int32))
    np.testing.assert_array_equal((flags >> 1) & 1, ofl_j.astype(np.int32))
    np.testing.assert_array_equal(ht.numpy(), ht_j)
    np.testing.assert_allclose(hks.numpy(), hk_j, rtol=2e-5, atol=1e-4)
    np.testing.assert_allclose(ca.numpy(), ca_j, rtol=2e-5, atol=1e-4)
    np.testing.assert_array_equal(cu.numpy(), cu_j)
    assert int(hc_j.sum()) > 0 and (hc_j == 0).any()


def test_search_model_matches_plain_on_synth_table():
    """The same on the tables of a small corpus of kasa_tpu_torch.synth
    (its genomes and index at k 7..12), windows drawn from the index
    with one letter redrawn in a third of them."""
    from kasa_tpu_torch import synth
    from kasa_tpu_torch.match import turbo as PT
    rng = np.random.default_rng(7)
    genomes = synth._gen_genomes(rng, 40, 2_000, 8, synth.CORE_PER_GENOME)
    limbs, taxids = synth._index_from_genomes(genomes)
    # genome g has taxid g + 1: content row g
    arrays, meta = PT.build_tables_np(limbs, (taxids - 1).astype(np.int32),
                                      12, 7, 12, 40)
    q = limbs[rng.integers(0, len(limbs), 20_000)].copy()
    pick = np.nonzero(rng.random(len(q)) < 1 / 3)[0]
    col = rng.integers(0, 12, len(pick))
    sh = 5 * (5 - col % 6)
    q[pick, col // 6] = (q[pick, col // 6] & ~(31 << sh)) \
        | (rng.integers(1, 26, len(pick)) << sh)
    _, stats = _check_model(arrays, meta, np.ascontiguousarray(q))
    assert stats["copy"] > 0


SCATTER_CASES = ("zero_rows", "one_taxon", "largest_t", "one_read",
                 "unique", "wide_s")


def scatter_case(case, dev="cpu"):
    """K11's inputs for `case` (tables of numK = 6 levels with random
    d_tax rows and weights; the occurrences in key order, read ids
    random): "zero_rows" leaves the first half of the reads without an
    occurrence and the last with occurrences none of which is valid;
    "one_taxon" gives read 3 5,000 valid occurrences of one taxon at
    every level (T = 1); "largest_t" groups of all S taxa; "one_read"
    R = 1; "unique" the read ids of a -e batch (duplicate (window, read)
    pairs dropped, dedup_unique order: windows by key, a window's reads
    ascending); "wide_s" S = 30,000 species.  -> (tables, valid, T,
    start, read ids, R) on `dev`."""
    from types import SimpleNamespace
    from kasa_tpu_torch.match.engine import dedup_unique
    rng = np.random.default_rng(SCATTER_CASES.index(case) + 70)
    S = 30_000 if case == "wide_s" else 300
    nk, R, M, tmax = 6, 500, 40_000, max(20_000, S)
    if case == "one_read":
        R = 1
    rid = rng.integers(0, R, M).astype(np.int32)
    if case == "unique":
        q = rng.integers(0, 300, size=(M, 2)).astype(np.int32)
        q, rid = dedup_unique(q, rid)
        M = len(rid)
    d_tax = rng.integers(0, S, size=(nk, tmax)).astype(np.int32)
    T = rng.integers(1, 5, size=(nk, M)).astype(np.int32)
    start = (rng.random((nk, M)) * (tmax - T + 1)).astype(np.int32)
    valid = rng.random((nk, M)) < 0.7
    if case == "zero_rows":
        rid = rng.integers(R // 2, R, M).astype(np.int32)
        valid[:, rid == R - 1] = False
    if case == "one_taxon":
        rid[:5000] = 3
        d_tax[:, 0] = 7
        T[:, :5000], start[:, :5000], valid[:, :5000] = 1, 0, True
    if case == "largest_t":
        d_tax[:, :S] = rng.permuted(np.tile(np.arange(S), (nk, 1)), axis=1)
        T[:, ::97], start[:, ::97] = S, 0
    t = SimpleNamespace(
        num_k=nk, num_species=S, d_tax=torch.from_numpy(d_tax).to(dev),
        weights=torch.from_numpy(rng.random(nk).astype(np.float32)).to(dev))
    return (t, torch.from_numpy(valid).to(dev), torch.from_numpy(T).to(dev),
            torch.from_numpy(start).to(dev), torch.from_numpy(rid).to(dev),
            R)


READ_CASES = ("zero_rows", "one_taxon", "largest_t", "one_read", "wide",
              "s_given")


def read_case(case, dev="cpu", S=None):
    """K11's read arm's inputs for `case`, its levels nested as K10's
    are (valid from a window's first valid level lo on, T = 1 on [lo, hi)
    with one taxon, T > 1 on [hi, numK)): tables of numK = 6 levels whose
    d_tax rows start with every taxon once (a T = 1 group's start is its
    taxon) and then random runs; the windows in read order with read ids
    ascending, and a random key order for K10's outputs.  "zero_rows"
    leaves the first half of the reads without a window and the last
    read's windows without a valid level; "one_taxon" gives read 3 5,000
    windows of taxon 7 at every level; "largest_t" groups of all S taxa;
    "one_read" R = 1; "wide" every valid level T > 1; "s_given" the S
    given.  -> (tables, (valid, T, start, read ids) in key order, heads,
    wide_at, read ids in read order, R) on `dev`."""
    from types import SimpleNamespace
    from kasa_tpu_torch.match.join import pack_heads
    rng = np.random.default_rng(READ_CASES.index(case) + 90)
    S = S or (300 if case != "largest_t" else 2_000)
    nk, R, M = 6, 500, 40_000
    if case == "one_read":
        R = 1
    tmax = 2 * S + 20_000
    d_tax = rng.integers(0, S, size=(nk, tmax)).astype(np.int32)
    d_tax[:, :S] = np.arange(S)
    d_tax[:, S:2 * S] = rng.permuted(np.tile(np.arange(S), (nk, 1)), axis=1)
    rid = np.sort(rng.integers(R // 2 if case == "zero_rows" else 0, R,
                               M)).astype(np.int32)
    lo = rng.integers(0, nk + 1, M)
    hi = lo + rng.integers(0, nk + 1 - lo)
    if case == "wide":
        hi = lo
    x = rng.integers(0, S, M)
    Tw = rng.integers(2, 6, size=(nk, M))
    sw = (rng.random((nk, M)) * (tmax - 2 * S - 6)).astype(np.int64) + 2 * S
    if case == "largest_t":
        big = rng.random((nk, M)) < 0.01
        Tw[big], sw[big] = S, S
    if case == "zero_rows":
        lo[rid == R - 1] = hi[rid == R - 1] = nk
    if case == "one_taxon":
        rid[:5000], lo[:5000], hi[:5000], x[:5000] = 3, 0, nk, 7
        rid = np.sort(rid)
    kis = np.arange(nk)[:, None]
    valid = kis >= lo
    one = valid & (kis < hi)
    T = np.where(one, 1, np.where(valid, Tw, rng.integers(0, 9, (nk, M))))
    start = np.where(one, x, sw).astype(np.int32)
    perm = rng.permutation(M)          # key order i <- read order perm[i]
    inv = np.argsort(perm)
    heads = pack_heads(np.where(lo < hi, x, -1), lo, hi).astype(np.int32)
    wide_at = np.where(hi < nk, inv, -1).astype(np.int32)
    t = SimpleNamespace(
        num_k=nk, num_species=S, d_tax=torch.from_numpy(d_tax).to(dev),
        weights=torch.from_numpy(rng.random(nk).astype(np.float32)).to(dev))

    def key(a):
        return torch.from_numpy(np.ascontiguousarray(a[..., perm])).to(dev)
    return (t, (key(valid), key(T.astype(np.int32)), key(start), key(rid)),
            torch.from_numpy(heads).to(dev), torch.from_numpy(wide_at).to(dev),
            torch.from_numpy(rid).to(dev), R)


@pytest.mark.parametrize("case", READ_CASES[:5])
def test_read_case_plain_matches_plain(case):
    """The read arm's plain version on each read case's heads gives
    join_scatter_plain's scores on the same windows in key order: hit
    cells identical, within the contract (the card tests hold K11's read
    arm to both)."""
    from kasa_tpu_torch.match import join as J
    t, (valid, T, start, rk), heads, wide_at, rid, R = read_case(case)
    assert bool((rid[1:] >= rid[:-1]).all())
    got = J.join_scatter_reads_plain(t, heads, wide_at, T, start, rid, R)
    want = J.join_scatter_plain(t, valid, T, start, rk, R)
    assert torch.equal(got > 0, want > 0) and int((want > 0).sum()) > 0
    torch.testing.assert_close(got, want, rtol=2e-5, atol=1e-4)


def scatter_model(t, valid, T, start, rid, R):
    """K11's adds in numpy, thread for thread: each valid (level,
    occurrence) adds its float32 term w(k) * (1/T), in float64, to its
    read's cell of each of its group's T taxa; each cell rounded to
    float32 once -> ((R, S) float32 scores, the adds)."""
    d_tax, w = t.d_tax.numpy(), t.weights.numpy()
    valid, T, start, rid = (a.numpy() for a in (valid, T, start, rid))
    out = np.zeros((R, t.num_species), np.float64)
    ki, m = np.nonzero(valid)
    adds = 0
    for k, o in zip(ki, m):
        val = np.float64(w[k] * (np.float32(1) / np.float32(T[k, o])))
        np.add.at(out[rid[o]], d_tax[k, start[k, o]:start[k, o] + T[k, o]],
                  val)
        adds += int(T[k, o])
    return torch.from_numpy(out.astype(np.float32)), adds


@pytest.mark.parametrize("case", ["zero_rows", "one_taxon", "largest_t",
                                  "unique"])
def test_scatter_model_matches_plain(case):
    """The model of K11's adds gives join_scatter_plain's scores (hit
    cells identical, within rtol 2e-5 / atol 1e-4), one add per
    (occurrence, taxon) pair; on "one_taxon" read 3's cell of taxon 7
    sums 30,000 terms in float64."""
    from kasa_tpu_torch.match import join as J
    t, valid, T, start, rid, R = scatter_case(case)
    got, adds = scatter_model(t, valid, T, start, rid, R)
    want = J.join_scatter_plain(t, valid, T, start, rid, R)
    assert torch.equal(got > 0, want > 0)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=1e-4)
    assert adds == int(T[valid].long().sum())


@pytest.mark.parametrize("case", ["zero_rows", "largest_t", "one_read",
                                  "unique"])
def test_scatter_plain_matches_reference_on_cases(case):
    """join_scatter_plain against kasa_tpu's _score_scatter, level by
    level, on the cases the card tests hold K11 to it on: the chain
    kernel -> plain version -> reference closes on these inputs."""
    import jax.numpy as jnp
    from kasa_tpu.match.join import _score_scatter
    from kasa_tpu_torch.match import join as J
    t, valid, T, start, rid, R = scatter_case(case)
    got = J.join_scatter_plain(t, valid, T, start, rid, R).numpy()
    S, w = t.num_species, t.weights.numpy()
    scores = jnp.zeros((R, S), jnp.float32)
    for ki in range(t.num_k):
        v = valid[ki].numpy()
        occ_T = T[ki].numpy()[v].astype(np.int64)
        cum = np.zeros(len(occ_T) + 1, np.int64)
        np.cumsum(occ_T, out=cum[1:])
        val = w[ki] * (np.float32(1.0) / occ_T.astype(np.float32))
        scores = _score_scatter(
            jnp.asarray(cum.astype(np.int32)),
            jnp.asarray(start[ki].numpy()[v]), jnp.asarray(val),
            jnp.asarray(rid.numpy()[v]), jnp.asarray(t.d_tax[ki].numpy()),
            jnp.zeros(len(occ_T), jnp.int32), scores,
            1 << (int(cum[-1]) - 1).bit_length(), S)
    want = np.asarray(scores)
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-4)


def test_join_scatter_arm_edges():
    """K11's arm function at its edges: the read arm where the read ids
    ascend, the batch holds READ_ARM_MIN_READS reads or more and a row of
    S 8-byte cells fits the block's shared memory; the global arm one
    step past each."""
    from kasa_tpu_torch import kernels as K
    smem, n = K.H100_SMEM_OPTIN, K.READ_ARM_MIN_READS
    S = (smem - K._SCATTER_RESERVE) // 8
    assert K.join_scatter_arm(S, True, smem, n) == "reads"
    assert K.join_scatter_arm(S + 1, True, smem, n) == "global"
    assert K.join_scatter_arm(S, True, smem, n - 1) == "global"
    assert K.join_scatter_arm(S, False, smem, n) == "global"
