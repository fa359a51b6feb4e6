"""kasa_tpu_torch's batch step (the plain versions of kernels K1-K4 and
their orchestration) against kasa_tpu's turbo kernel, on the same tables
and budgets, under the port's contract: integer outputs identical (hit
taxa, hit counts, both flags, unique counts, the packed readback except
the ksum bits), floats within rtol 2e-5 / atol 1e-4."""

import pathlib

import numpy as np
import pytest
import torch

from test_torch_tables import jax_arrays

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "golden"
RTOL, ATOL = 2e-5, 1e-4


def _port_tables(jt):
    from kasa_tpu_torch.match import turbo as PT
    return PT.tables_from_numpy(*jax_arrays(jt), "cpu")


def _assert_packed(pp, jp, R, cap):
    """Packed readback: every int32 identical except the ksum bits of
    the CSR pairs, which hold floats within the contract."""
    assert pp.shape == jp.shape
    ints = np.ones(len(jp), bool)
    ints[2 * R + 1:2 * R + 2 * cap:2] = False
    np.testing.assert_array_equal(pp[ints], jp[ints])
    np.testing.assert_allclose(
        pp[2 * R + 1:2 * R + 2 * cap:2].view(np.float32),
        jp[2 * R + 1:2 * R + 2 * cap:2].view(np.float32),
        rtol=RTOL, atol=ATOL)


def test_golden_batch_matches_fused_turbo_acc():
    """fixtures/reads.fastq as one padded 512-row batch on the golden
    index: packed readback, dense lists and both accumulators."""
    import jax.numpy as jnp
    from kasa_tpu.index import artifacts
    from kasa_tpu.match import turbo as JT
    from kasa_tpu.match.join import map_tax_rows
    from kasa_tpu.match.pipeline import load_content_for_identify
    from kasa_tpu_torch.core.alphabet import build_codon_code_lut
    from kasa_tpu_torch.match import turbo as PT
    from kasa_tpu_torch.match.fast import BatchAssembler
    from kasa_tpu_torch.native import load_fastx, sanitize_inplace

    limbs, taxids, _, _ = artifacts.read_index(str(GOLDEN / "exampleIndex"))
    content = load_content_for_identify(
        str(GOLDEN / "exampleIndex_content.txt"))
    S = content.num_species
    jt = JT.TurboTables.build_from_arrays(
        limbs, map_tax_rows(taxids, content.tax_to_idx), 12, 7, 12, S)
    seq, so, _, _, _ = load_fastx(str(REPO / "fixtures" / "reads.fastq"),
                                  True)
    sanitize_inplace(seq, False)
    asm = BatchAssembler(12, 7)
    maxlen = (int(np.diff(so).max()) + asm.marker_len + 15) // 16 * 16
    R = 512
    mat = asm.assemble(seq, so.astype(np.int64), maxlen, R)
    w = asm.window_target(maxlen)
    lut = build_codon_code_lut().astype(np.int32)
    cap = 4 * R

    jout = JT.fused_turbo_acc(
        jt.keys2, jt.rowdat, jt.router, jt.sub2, jt.grp2, jt.d_tax4,
        jt.weights, jt.masks2, jt.hotmask, jt.t_hot, jnp.asarray(mat),
        jnp.asarray(lut), jnp.zeros((6, S), jnp.float32),
        jnp.zeros((6, S), jnp.int32), jt.num_steps, 7, 12, 12, S, R,
        False, False, 1, w, cap)
    jp, jht, jhk, jca, jcu = [np.asarray(o) for o in jout]

    ca = torch.zeros((6, S))
    cu = torch.zeros((6, S), dtype=torch.int32)
    pp, pht, phk = PT.fused_turbo_acc(
        _port_tables(jt), torch.from_numpy(mat), torch.from_numpy(lut),
        ca, cu, R, w, cap)
    _assert_packed(pp.numpy(), jp, R, cap)
    assert int(jp[-2]) > 0
    np.testing.assert_array_equal(pht.numpy(), jht)
    np.testing.assert_allclose(phk.numpy(), jhk, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ca.numpy(), jca, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(cu.numpy(), jcu)


def _tiers_case(kind):
    from test_turbo import _index_with_tiers
    if kind == "tiers":
        limbs, taxids, hot = _index_with_tiers()
        rng = np.random.default_rng(23)
        R, kpr = 64, 32
        q = limbs[rng.integers(0, len(taxids), size=R * kpr)].copy()
        miss = rng.random(R * kpr) < 0.3
        q[miss, 1] ^= (rng.integers(1, 31, size=int(miss.sum()))
                       .astype(np.int32) << 5)
        for i, kl in enumerate(hot):
            q[i * kpr + 3] = kl
    else:
        limbs, taxids, hot = _index_with_tiers(
            n=20_000, heavy_ts=(4, 8, 16, 16, 16, 16))
        rng = np.random.default_rng(31)
        R, kpr = 32, 24
        q = limbs[rng.integers(0, len(taxids), size=R * kpr)].copy()
        for i, kl in enumerate(hot):
            for j in range(4):
                q[(i * 4 + j) * kpr + 5] = kl
    return limbs, taxids.astype(np.int32), q, R, kpr


@pytest.mark.parametrize("kind", ["tiers", "budget_drop"])
def test_core_matches_turbo_classify(monkeypatch, kind):
    """tiers: every multi-taxa tier plus a T = 200 group and > CW run
    reads (overflow flags).  budget_drop: EXP_BUDGET = 64 and no hot
    tier, so the expansion budget cuts inside a run of equal T (T = 16
    four times) and the dropped reads must be flagged bit for bit."""
    import jax.numpy as jnp
    import kasa_tpu.match.turbo as JT
    from kasa_tpu_torch.match import turbo as PT
    from test_turbo import S

    eb = None
    if kind == "budget_drop":
        eb = 64
        monkeypatch.setattr(JT, "EXP_BUDGET", eb)
        monkeypatch.setattr(JT, "HOT_SETS", 1)
    JT.turbo_classify._clear_cache()
    try:
        limbs, tax_rows, q, R, kpr = _tiers_case(kind)
        jt = JT.TurboTables.build_from_arrays(limbs, tax_rows, 12, 7, 12, S)
        ht_j, hk_j, hc_j, ca_j, cu_j, ofc_j, ofl_j = [np.asarray(o) for o in
            JT.turbo_classify(
                jt.keys2, jt.rowdat, jt.router, jt.sub2, jt.grp2,
                jt.d_tax4, jt.weights, jt.masks2, jt.hotmask, jt.t_hot,
                jnp.asarray(q), jt.num_steps, 7, 12, 12, S, R, kpr)]
    finally:
        JT.turbo_classify._clear_cache()
    ca = torch.zeros((6, S))
    cu = torch.zeros((6, S), dtype=torch.int32)
    cap = 160 * R
    packed, ht, hk = PT.turbo_core(_port_tables(jt), torch.from_numpy(q),
                                   R, kpr, ca, cu, cap, None, eb)
    packed = packed.numpy()
    flags = packed[R:2 * R]
    assert ofc_j.any()
    np.testing.assert_array_equal(packed[:R], hc_j)
    np.testing.assert_array_equal(flags & 1, ofc_j.astype(np.int32))
    np.testing.assert_array_equal((flags >> 1) & 1, ofl_j.astype(np.int32))
    assert int(packed[-1]) == int((ofc_j | ofl_j).sum())
    np.testing.assert_array_equal(ht.numpy(), ht_j)
    np.testing.assert_allclose(hk.numpy(), hk_j, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ca.numpy(), ca_j, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(cu.numpy(), cu_j)
    if kind == "budget_drop":
        assert 0 < int(packed[-3]) <= eb     # expansion rows admitted


def test_slot_cap_raises():
    """A batch whose reads have more slots than K3's shared-memory arm
    sorts (683 windows x 6 levels = 4,098): reads of 700 bp cut from the
    golden genomes, as one padded batch on the golden index, through both
    packages' fused_turbo_acc: packed readback, lists and accumulators
    under the contract."""
    import jax.numpy as jnp
    from kasa_tpu.index import artifacts
    from kasa_tpu.match import turbo as JT
    from kasa_tpu.match.join import map_tax_rows
    from kasa_tpu.match.pipeline import load_content_for_identify
    from kasa_tpu_torch.core.alphabet import build_codon_code_lut
    from kasa_tpu_torch.host.fastx import iter_records
    from kasa_tpu_torch.match import turbo as PT
    from kasa_tpu_torch.match.fast import BatchAssembler

    limbs, taxids, _, _ = artifacts.read_index(str(GOLDEN / "exampleIndex"))
    content = load_content_for_identify(
        str(GOLDEN / "exampleIndex_content.txt"))
    S = content.num_species
    jt = JT.TurboTables.build_from_arrays(
        limbs, map_tax_rows(taxids, content.tax_to_idx), 12, 7, 12, S)
    genomes = [r.seq for r in iter_records(str(REPO / "fixtures"
                                               / "example.fasta"))]
    R = 8
    seq = "".join(g[100 * i:100 * i + 700] for i, g in
                  enumerate(genomes * 2))[:R * 700]
    seq = np.frombuffer(seq.encode(), np.uint8).copy()
    so = np.arange(R + 1, dtype=np.int64) * 700
    asm = BatchAssembler(12, 7)
    maxlen = (700 + asm.marker_len + 15) // 16 * 16
    mat = asm.assemble(seq, so, maxlen, R)
    w = asm.window_target(maxlen)
    assert w * 6 > PT.SW_CAP
    lut = build_codon_code_lut().astype(np.int32)
    cap = 4 * R
    jout = JT.fused_turbo_acc(
        jt.keys2, jt.rowdat, jt.router, jt.sub2, jt.grp2, jt.d_tax4,
        jt.weights, jt.masks2, jt.hotmask, jt.t_hot, jnp.asarray(mat),
        jnp.asarray(lut), jnp.zeros((6, S), jnp.float32),
        jnp.zeros((6, S), jnp.int32), jt.num_steps, 7, 12, 12, S, R,
        False, False, 1, w, cap)
    jp, jht, jhk, jca, jcu = [np.asarray(o) for o in jout]
    ca = torch.zeros((6, S))
    cu = torch.zeros((6, S), dtype=torch.int32)
    pp, pht, phk = PT.fused_turbo_acc(
        _port_tables(jt), torch.from_numpy(mat), torch.from_numpy(lut),
        ca, cu, R, w, cap)
    _assert_packed(pp.numpy(), jp, R, cap)
    assert int(jp[-2]) > 0 and int(jcu.sum()) > 0
    np.testing.assert_array_equal(pht.numpy(), jht)
    np.testing.assert_allclose(phk.numpy(), jhk, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ca.numpy(), jca, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(cu.numpy(), jcu)

def _golden_batch(R=512):
    """kasa_tpu's tables of the golden index at k 7..12 and
    fixtures/reads.fastq as one padded batch of R rows."""
    from kasa_tpu.index import artifacts
    from kasa_tpu.match import turbo as JT
    from kasa_tpu.match.join import map_tax_rows
    from kasa_tpu.match.pipeline import load_content_for_identify
    from kasa_tpu_torch.core.alphabet import build_codon_code_lut
    from kasa_tpu_torch.match.fast import BatchAssembler
    from kasa_tpu_torch.native import load_fastx, sanitize_inplace
    limbs, taxids, _, _ = artifacts.read_index(str(GOLDEN / "exampleIndex"))
    content = load_content_for_identify(
        str(GOLDEN / "exampleIndex_content.txt"))
    S = content.num_species
    jt = JT.TurboTables.build_from_arrays(
        limbs, map_tax_rows(taxids, content.tax_to_idx), 12, 7, 12, S)
    seq, so, _, _, _ = load_fastx(str(REPO / "fixtures" / "reads.fastq"),
                                  True)
    sanitize_inplace(seq, False)
    asm = BatchAssembler(12, 7)
    maxlen = (int(np.diff(so).max()) + asm.marker_len + 15) // 16 * 16
    mat = asm.assemble(seq, so.astype(np.int64), maxlen, R)
    lut = build_codon_code_lut().astype(np.int32)
    return jt, S, mat, lut, asm.window_target(maxlen)


def _jt_args(jt):
    return (jt.keys2, jt.rowdat, jt.router, jt.sub2, jt.grp2, jt.d_tax4,
            jt.weights, jt.masks2, jt.hotmask, jt.t_hot)


def _assert_classify(port, jax_out):
    ht, hk, hc, ca, cu, ofc, ofl = [t.numpy() for t in port]
    ht_j, hk_j, hc_j, ca_j, cu_j, ofc_j, ofl_j = [np.asarray(o)
                                                  for o in jax_out]
    np.testing.assert_array_equal(hc, hc_j)
    np.testing.assert_array_equal(ofc, ofc_j)
    np.testing.assert_array_equal(ofl, ofl_j)
    np.testing.assert_array_equal(ht, ht_j)
    np.testing.assert_allclose(hk, hk_j, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ca, ca_j, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(cu, cu_j)
    assert hc.sum() > 0


def test_turbo_classify_matches_jax():
    """The port's turbo_classify (kasa_tpu turbo.py:1011) on the golden
    batch's windows against kasa_tpu's: all seven outputs."""
    import jax.numpy as jnp
    from kasa_tpu.core.encode import dna_to_aa_codes_np, encode_windows_np
    from kasa_tpu.match import turbo as JT
    from kasa_tpu_torch.match import turbo as PT
    jt, S, mat, lut, w = _golden_batch()
    R = mat.shape[0]
    q = np.concatenate([encode_windows_np(
        dna_to_aa_codes_np(np.concatenate([row, np.zeros(36, np.uint8)]),
                           lut), 12, 3)[:w] for row in mat])
    jout = JT.turbo_classify(*_jt_args(jt), jnp.asarray(q), jt.num_steps, 7,
                             12, 12, S, R, w)
    _assert_classify(PT.turbo_classify(_port_tables(jt), torch.from_numpy(q),
                                       R, w), jout)


def test_fused_turbo_matches_jax():
    """fused_turbo (kasa_tpu turbo.py:1142): the byte matrix through K1's
    plain version and the step."""
    import jax.numpy as jnp
    from kasa_tpu.match import turbo as JT
    from kasa_tpu_torch.match import turbo as PT
    jt, S, mat, lut, w = _golden_batch()
    R = mat.shape[0]
    jout = JT.fused_turbo(*_jt_args(jt), jnp.asarray(mat), jnp.asarray(lut),
                          jt.num_steps, 7, 12, 12, S, R, False, False, 1, w)
    _assert_classify(PT.fused_turbo(_port_tables(jt), torch.from_numpy(mat),
                                    torch.from_numpy(lut), R, w), jout)


@pytest.mark.parametrize("probe", ["encode", "t1sort", "fold", None],
                         ids=["encode", "t1sort", "fold", "all"])
def test_fused_turbo_probe_matches_jax(probe):
    """fused_turbo_probe (kasa_tpu turbo.py:1027): the checksum after each
    stage the port can stop after; the stage names that fall inside one
    kernel here are refused."""
    import jax.numpy as jnp
    from kasa_tpu.match import turbo as JT
    from kasa_tpu_torch.match import turbo as PT
    jt, S, mat, lut, w = _golden_batch()
    R = mat.shape[0]
    j = float(JT.fused_turbo_probe(*_jt_args(jt), jnp.asarray(mat),
                                   jnp.asarray(lut), jt.num_steps, 7, 12,
                                   12, S, R, False, False, 1, w, probe))
    tt = _port_tables(jt)
    args = (tt, torch.from_numpy(mat), torch.from_numpy(lut), R, w)
    p = PT.fused_turbo_probe(*args, probe)
    np.testing.assert_allclose(p, j, rtol=RTOL)
    assert p != 0
    with pytest.raises(ValueError, match="stops after"):
        PT.fused_turbo_probe(*args, "wsort1")
