"""The classic engine of kasa_tpu_torch against kasa_tpu's, on the CPU,
at the kernel level: the plain version of K9 (match/device.py
classify_batch_plain) against kasa_tpu's classify_batch in its three
regimes (run-scan, dense, scatter), the stacked tables array for array,
and the plain version of K1's sloppy arm against kasa_tpu's
sloppy_reduce.  The contract: identical hit cells and integer counts
(unique counts, tail_pairs), floats within rtol 2e-5 / atol 1e-4.
Identify end to end: tests/test_torch_classic_identify.py."""

import pathlib

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "golden"
CONTENT = GOLDEN / "exampleIndex_content.txt"
RTOL, ATOL = 2e-5, 1e-4


# ---------------------------------------------------------------------------
# kernel level

def _pack(letters):
    """(n, k) 5-bit letters -> (n, ceil(k / 6)) int32 limbs."""
    n, k = letters.shape
    L = -(-k // 6)
    out = np.zeros((n, L), np.int32)
    for j in range(k):
        out[:, j // 6] |= letters[:, j].astype(np.int32) << (5 * (5 - j % 6))
    return out


def _index(highest_k, n, num_species, seed, skew=True, heavy=6,
           heavy_t=(20, 60)):
    """A sorted, deduplicated index of random letters: skewed first
    letters (long limb-0 runs) unless skew is False, plus `heavy` groups
    of T in heavy_t taxa (tests/test_device_128.py's _index_128)."""
    rng = np.random.default_rng(seed)
    letters = rng.integers(1, 27, size=(n, highest_k))
    if skew:
        letters[:, 0] = rng.integers(1, 4, size=n)
        letters[:, 1] = rng.integers(1, 5, size=n)
    limbs = _pack(letters)
    taxids = rng.integers(1, num_species, size=n).astype(np.uint32)
    extra_l, extra_t = [limbs], [taxids]
    for _ in range(heavy):
        T = int(rng.integers(*heavy_t))
        extra_l.append(np.repeat(limbs[rng.integers(0, n)][None], T, 0))
        extra_t.append(rng.choice(np.arange(1, num_species), size=T,
                                  replace=False).astype(np.uint32))
    limbs, taxids = np.concatenate(extra_l), np.concatenate(extra_t)
    L = limbs.shape[1]
    order = np.lexsort((taxids,) + tuple(limbs[:, i]
                                         for i in range(L - 1, -1, -1)))
    limbs, taxids = limbs[order], taxids[order]
    keep = np.ones(len(taxids), bool)
    keep[1:] = np.any(limbs[1:] != limbs[:-1], axis=1) \
        | (taxids[1:] != taxids[:-1])
    return limbs[keep], taxids[keep]


def _queries(limbs, highest_k, M, R, seed):
    """M windows drawn from the index, 30 % with one letter changed, 10 %
    with a '^' letter, 10 % of the rows padding (q_valid False); read ids
    of a uniform layout of R reads."""
    rng = np.random.default_rng(seed)
    q = limbs[rng.integers(0, len(limbs), size=M)].copy()
    L = q.shape[1]
    for frac, code in ((0.3, None), (0.1, 30)):
        pick = np.nonzero(rng.random(M) < frac)[0]
        pos = rng.integers(0, highest_k, size=len(pick))
        sh = (5 * (5 - pos % 6)).astype(np.int32)
        new = (rng.integers(1, 27, size=len(pick)) if code is None
               else np.full(len(pick), code)).astype(np.int32)
        li = pos // 6
        q[pick, li] = (q[pick, li] & ~(31 << sh)) | (new << sh)
    valid = rng.random(M) >= 0.1
    rid = (np.arange(M) // (M // R)).astype(np.int32)
    return q, rid, valid, L


def _tables(limbs, taxids, highest_k, min_k, max_k, S):
    from kasa_tpu.match.device import StackedTables as JS
    from kasa_tpu.match.join import DeviceIndex as JD
    from kasa_tpu_torch.match.device import StackedTables as TS
    from kasa_tpu_torch.match.join import DeviceIndex as TD
    t2r = {t: t for t in range(S)}
    js = JS.build(JD(limbs, taxids, t2r, highest_k, min_k, max_k, S))
    ts = TS.build(TD(limbs, taxids, t2r, highest_k, min_k, max_k, S, "cpu"))
    return js, ts


KERNEL_CASES = [
    # id, highest_k, min_k, max_k, regime
    ("L2_k1_12", 12, 1, 12, "scatter"),
    ("L2_k1_12_dense", 12, 1, 12, "dense"),
    ("L2_k4_12", 12, 4, 12, "scatter"),
    ("L2_k4_12_dense", 12, 4, 12, "dense"),
    ("L2_k7_12", 12, 7, 12, "scatter"),
    ("L2_k7_12_dense", 12, 7, 12, "dense"),
    ("L2_k7_12_runscan", 12, 7, 12, "runscan"),
    ("L5_k12_25", 25, 12, 25, "scatter"),
    ("L5_k12_25_dense", 25, 12, 25, "dense"),
    ("L5_k1_6", 25, 1, 6, "scatter"),
    ("L5_k4_17", 25, 4, 17, "dense"),
    ("L5_k7_20", 25, 7, 20, "scatter"),
]


@pytest.mark.parametrize("highest_k,min_k,max_k,regime",
                         [c[1:] for c in KERNEL_CASES],
                         ids=[c[0] for c in KERNEL_CASES])
def test_classify_plain_matches_jax(highest_k, min_k, max_k, regime):
    """K9's plain version against kasa_tpu's classify_batch at cap 2 (its
    tail loop runs on every heavy group): identical hit cells,
    counts_unique and tail_pairs (run-scan reports 0), scores and
    counts_all within the contract.  1,024 queries: at k = 1 every valid
    query adds 1/T to every taxon, and kasa_tpu's float32 scatter over
    many more adds drifts beyond rtol 2e-5 from the exact sums."""
    from kasa_tpu.match.device import classify_batch as jcb
    from kasa_tpu_torch.match.device import classify_batch
    S = 64 if regime != "runscan" else 32
    limbs, taxids = _index(highest_k, 20_000, S, seed=highest_k + min_k,
                           skew=regime != "runscan",
                           heavy_t=(3, 6) if regime == "runscan" else (20, 60))
    js, ts = _tables(limbs, taxids, highest_k, min_k, max_k, S)
    R, M = 32, 1024
    q, rid, valid, _ = _queries(limbs, highest_k, M, R, seed=min_k)
    kpr = 0 if regime == "scatter" else M // R
    run_scan_w = 0
    if regime == "runscan":
        assert js.max_run <= 16
        run_scan_w = js.max_run
    cap = 2
    s1, ca1, cu1, t1 = (np.asarray(x) for x in jcb(
        js.idx_limbs, js.grp_id, js.grp_start, js.d_tax, js.masks,
        js.weights, js.run_start, js.run_end, js.prefix_tbl, js.idx_tax,
        q, rid, valid, js.num_steps, js.sub_steps, min_k, max_k, highest_k,
        S, R, cap, kmers_per_read=kpr, run_scan_w=run_scan_w,
        dense_scores=regime != "scatter"))
    s2, ca2, cu2, t2 = classify_batch(
        ts, torch.from_numpy(q), torch.from_numpy(rid),
        torch.from_numpy(valid), R, cap, kpr)
    assert cu1.sum() > 0 and (s1 > 0).sum() > 0
    np.testing.assert_array_equal(s2.numpy() > 0, s1 > 0)
    np.testing.assert_allclose(s2.numpy(), s1, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ca2.numpy(), ca1, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(cu2.numpy(), cu1)
    if regime != "runscan":
        assert t2 == int(t1) and t2 > 0


def _reference_extras(ts, tax_rows):
    """kasa_tpu's run_start, idx_tax, max_run, num_steps and sub_steps,
    which serve only its other lowerings, from the arrays K9 reads (the
    limb-0 run ends, the prefix table) and the port's taxon rows."""
    from kasa_tpu_torch.ops.search import num_steps_for
    run_end = ts.run_end.numpy()
    ends = np.unique(run_end)
    starts = np.r_[0, ends[:-1]].astype(np.int32)
    run_start = starts[np.searchsorted(ends, np.arange(ts.n), side="right")]
    max_run = int((run_end - run_start).max())
    return {"run_start": run_start,
            "idx_tax": np.asarray(tax_rows, np.int32),
            "max_run": max_run,
            "num_steps": num_steps_for(int(np.diff(ts.prefix_tbl.numpy())
                                           .max())),
            "sub_steps": num_steps_for(max_run)}


@pytest.mark.parametrize("index,k", [("exampleIndex", (4, 12)),
                                     ("exampleIndex128", (12, 25)),
                                     ("exampleIndex128", (1, 7))],
                         ids=["64bit_k4_12", "128bit_k12_25", "128bit_k1_7"])
def test_stacked_tables_equal_jax(index, k):
    from kasa_tpu.index import artifacts as A
    from kasa_tpu.match.pipeline import load_content_for_identify
    limbs, taxids, highest_k, _ = A.read_index(str(GOLDEN / index))
    c = load_content_for_identify(str(CONTENT))
    from kasa_tpu.match.device import StackedTables as JS
    from kasa_tpu.match.join import DeviceIndex as JD
    from kasa_tpu_torch.match.device import StackedTables as TS
    from kasa_tpu_torch.match.join import DeviceIndex as TD
    args = (limbs, taxids, c.tax_to_idx, highest_k, *k, c.num_species)
    js = JS.build(JD(*args))
    td = TD(*args, "cpu")
    ts = TS.build(td)
    for f in ("idx_limbs", "grp_id", "grp_start", "d_tax", "masks",
              "weights", "run_end", "prefix_tbl"):
        a, b = np.asarray(getattr(js, f)), getattr(ts, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    for f, b in _reference_extras(ts, td.tax_rows).items():
        a = getattr(js, f)
        if isinstance(b, np.ndarray):
            a = np.asarray(a)
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(b, a, err_msg=f)
        else:
            assert a == b, f
    for f in ("min_k", "max_k", "highest_k", "num_species"):
        assert getattr(js, f) == getattr(ts, f), f


def test_sloppy_plain_matches_jax():
    """K1's sloppy arm: its plain version bit-identical to kasa_tpu's
    sloppy_reduce on every letter pair (the LUT's out-of-bounds tail
    included), and through the encoder."""
    import jax.numpy as jnp
    from kasa_tpu.core import encode as JE
    from kasa_tpu_torch.core import encode as TE
    rng = np.random.default_rng(5)
    letters = rng.integers(0, 32, size=(4096, 12))
    letters[:1024, :2] = np.stack(np.divmod(np.arange(1024), 32), 1)
    limbs = _pack(letters)
    aas_j = JE.aas_code_lut()
    np.testing.assert_array_equal(TE.aas_code_lut(), aas_j)
    ref = np.asarray(JE.sloppy_reduce(jnp.asarray(limbs),
                                      jnp.asarray(aas_j)))
    got = TE.sloppy_reduce_plain(torch.from_numpy(limbs),
                                 torch.from_numpy(TE.aas_code_lut()))
    np.testing.assert_array_equal(got.numpy(), ref)
    buf = rng.choice(np.frombuffer(b"ACGTZX", np.uint8), size=3000)
    want = np.asarray(JE.Encoder(sloppy=True, device=False)
                      .encode_dna_buffer(buf, 12))
    have = TE.Encoder(sloppy=True, device="cpu").encode_dna_buffer(buf, 12)
    np.testing.assert_array_equal(have, want)
    with pytest.raises(ValueError, match="12 letters"):
        TE.Encoder(sloppy=True, device="cpu").encode_dna_buffer(buf, 25)


def test_run_classify_matches_jax():
    """run_classify (kasa_tpu device.py:468): the batch padded to a power
    of two of at least 1,024 rows in the scatter layout, cap 16."""
    from kasa_tpu.match.device import run_classify as jrun
    from kasa_tpu_torch.match.device import run_classify
    S = 64
    limbs, taxids = _index(25, 20_000, S, seed=3)
    js, ts = _tables(limbs, taxids, 25, 12, 25, S)
    q, rid, valid, _ = _queries(limbs, 25, 1500, 30, seed=4)
    q, rid = q[valid], rid[valid]
    s1, ca1, cu1, t1 = (np.asarray(x) for x in jrun(js, q, rid, 30))
    s2, ca2, cu2, t2 = run_classify(ts, q, rid, 30)
    np.testing.assert_array_equal(s2.numpy() > 0, s1 > 0)
    np.testing.assert_allclose(s2.numpy(), s1, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ca2.numpy(), ca1, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(cu2.numpy(), cu1)
    assert t2 == int(t1) > 0
