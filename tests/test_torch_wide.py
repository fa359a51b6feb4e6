"""kasa_tpu_torch on 128-bit indices (k <= 25: L = 5 limbs of 30 bits)
against kasa_tpu's limb-generic turbo path, on the CPU: the tables bit
for bit (built and through the .tabs sidecar, both ways), the plain
L-limb arms of K1 (encode), K2 (search and slots) and K5 (dedup), the
whole batch step, and identify on tests/golden/exampleIndex128 at k
20..25 (default, --six, -e).

The contract (ROADMAP.md): integers identical, floats within rtol 2e-5 /
atol 1e-4."""

import json
import pathlib
import shutil

import numpy as np
import pytest
import torch

from test_torch_core import _assert_packed
from test_torch_identify import assert_identify_agrees
from test_torch_tables import _assert_same_arrays, jax_arrays

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "golden"
FIXTURES = REPO / "fixtures"
RTOL, ATOL = 2e-5, 1e-4
MIN_K, MAX_K, HK, L = 20, 25, 25, 5
ALPHABET = np.frombuffer(b"ACGTXZacgt", np.uint8)
PROTEIN = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY^[", np.uint8)


def _case():
    """tests/test_turbo128.py's index (every multi-taxa tier up to T =
    200) and queries (30 % with a changed last letter, every tier
    planted)."""
    from test_turbo128 import S, _index128
    limbs, taxids, hot = _index128()
    rng = np.random.default_rng(3)
    R, kpr = 32, 16
    q = limbs[rng.integers(0, len(taxids), size=R * kpr)].copy()
    miss = rng.random(R * kpr) < 0.3
    q[miss, 4] ^= (rng.integers(1, 31, size=int(miss.sum()))
                   .astype(np.int32) << 25)
    for i, kl in enumerate(hot):
        q[i * kpr] = kl
    return limbs, taxids.astype(np.int32), q, R, kpr, S


def _tables():
    from kasa_tpu.match.turbo import TurboTables
    limbs, tax_rows, q, R, kpr, S = _case()
    jt = TurboTables.build_from_arrays(limbs, tax_rows, HK, MIN_K, MAX_K, S)
    return jt, limbs, tax_rows, q, R, kpr, S


def test_builder_matches_jax_128():
    from kasa_tpu_torch.match import turbo as PT
    jt, limbs, tax_rows, _, _, _, S = _tables()
    arrays, meta = PT.build_tables_np(limbs, tax_rows, HK, MIN_K, MAX_K, S)
    ja, jm = jax_arrays(jt)
    assert ja["keys2"].shape[1] == L and ja["rowdat"].shape[1] == L + 2
    _assert_same_arrays(arrays, ja)
    assert meta == jm


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_sidecar_128_read_by_the_other_package(tmp_path, writer):
    from kasa_tpu.match import turbo as JT
    from kasa_tpu_torch.match import turbo as PT
    jt, limbs, tax_rows, _, _, _, S = _tables()
    crc = PT._tax_rows_crc(tax_rows)
    path = str(tmp_path / f"idx.turbo_{MIN_K}_{MAX_K}.npz")
    ja, jm = jax_arrays(jt)
    if writer == "jax":
        JT.save_turbo(jt, path, crc)
        arrays, meta = PT.load_turbo_np(path, limbs, crc)
        _assert_same_arrays(arrays, ja)
        assert meta == jm
    else:
        PT.save_turbo(*PT.build_tables_np(limbs, tax_rows, HK, MIN_K, MAX_K,
                                          S), path, crc)
        back = JT.load_turbo(path, limbs, crc)
        assert back is not None
        _assert_same_arrays(jax_arrays(back)[0], ja)
        assert jax_arrays(back)[1] == jm


def _slots_oracle(jt, q, R, kpr):
    """Numpy oracle of K2's outputs on windows below the last key: the
    lower bound of each window among the distinct keys (kasa_tpu's
    lex_lower_bound_np), the rows at pos and pos-1, and per level the
    masked compare over the five limbs."""
    from kasa_tpu.core import kmer
    from kasa_tpu.match.turbo import lex_lower_bound_np
    keys = np.asarray(jt.keys2)
    rowdat = np.asarray(jt.rowdat)
    n, nk = len(keys), MAX_K - MIN_K + 1
    pos = lex_lower_bound_np(keys, q)
    at = rowdat[np.minimum(pos, n - 1)]
    pv = rowdat[np.maximum(pos - 1, 0)]
    ok = np.ones(len(q), bool)
    cum = {}
    for p in range(MIN_K - 1, MAX_K):
        ok &= kmer.letter_at(q, p, HK) != 30
        cum[p + 1] = ok.copy()
    skey = np.full((len(q), nk), 2**31 - 1, np.int64)
    mpay = np.full((len(q), nk), -1, np.int64)
    for ki in range(nk):
        m = kmer.prefix_masks(HK, MAX_K - ki)
        hit_at = (pos < n) & ((at[:, :L] & m) == (q & m)).all(axis=1)
        hit_pv = (pos > 0) & ((pv[:, :L] & m) == (q & m)).all(axis=1)
        matched = (hit_at | hit_pv) & cum[MAX_K - ki]
        row = np.where(hit_pv[:, None], pv, at)
        tc = (row[:, L + 1] >> (5 * ki)) & 31
        psel = np.where(hit_pv, pos - 1, np.minimum(pos, n - 1))
        skey[:, ki] = np.where(matched & (tc == 1), row[:, L] * 8 + ki,
                               skey[:, ki])
        mpay[:, ki] = np.where(matched & (tc >= 2), psel * 8 + ki, -1)
    return skey.reshape(R, kpr * nk), mpay.reshape(R, kpr * nk), pos < n


def test_search_and_slots_plain_match_oracle():
    """K2's plain L-limb arm: the lexicographic bisect over five limbs and
    the per-level masked compares, against the numpy oracle built on
    kasa_tpu's lower bound, slot for slot."""
    from kasa_tpu_torch.match import turbo as PT
    jt, _, _, q, R, kpr, _ = _tables()
    tt = PT.tables_from_numpy(*jax_arrays(jt), "cpu")
    skey, mpay = PT.turbo_match(torch.from_numpy(q), tt, R, kpr)
    want_s, want_m, inside = _slots_oracle(jt, q, R, kpr)
    keep = np.repeat(inside, MAX_K - MIN_K + 1).reshape(R, -1)
    assert keep.mean() > 0.9
    np.testing.assert_array_equal(skey.numpy()[keep], want_s[keep])
    np.testing.assert_array_equal(mpay.numpy()[keep], want_m[keep])
    assert (want_m >= 0).any() and (want_s < 2**31 - 1).any()


def test_core_matches_turbo_classify_128():
    """The whole batch step on the 128-bit tables against kasa_tpu's
    turbo_classify: hit lists, both flags, counts, packed readback."""
    import jax.numpy as jnp
    from kasa_tpu.match import turbo as JT
    from kasa_tpu_torch.match import turbo as PT
    jt, _, _, q, R, kpr, S = _tables()
    ht_j, hk_j, hc_j, ca_j, cu_j, ofc_j, ofl_j = [np.asarray(o) for o in
        JT.turbo_classify(jt.keys2, jt.rowdat, jt.router, jt.sub2, jt.grp2,
                          jt.d_tax4, jt.weights, jt.masks2, jt.hotmask,
                          jt.t_hot, jnp.asarray(q), jt.num_steps, MIN_K,
                          MAX_K, HK, S, R, kpr)]
    nk = MAX_K - MIN_K + 1
    ca = torch.zeros((nk, S))
    cu = torch.zeros((nk, S), dtype=torch.int32)
    cap = 160 * R
    packed, ht, hk = PT.turbo_core(
        PT.tables_from_numpy(*jax_arrays(jt), "cpu"), torch.from_numpy(q),
        R, kpr, ca, cu, cap)
    packed = packed.numpy()
    flags = packed[R:2 * R]
    assert ofl_j.any() and hc_j.sum() > 0
    np.testing.assert_array_equal(packed[:R], hc_j)
    np.testing.assert_array_equal(flags & 1, ofc_j.astype(np.int32))
    np.testing.assert_array_equal((flags >> 1) & 1, ofl_j.astype(np.int32))
    np.testing.assert_array_equal(ht.numpy(), ht_j)
    np.testing.assert_allclose(hk.numpy(), hk_j, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ca.numpy(), ca_j, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(cu.numpy(), cu_j)


def _jax_windows(mat, lut, w, protein, one_frame):
    """kasa_tpu/match/turbo.py fused_turbo_acc prologue (1206-1216) at
    highestK = 25."""
    import jax.numpy as jnp
    from kasa_tpu.core.encode import dna_to_aa_codes, encode_windows
    rows, maxlen = mat.shape
    stride = 1 if protein else 3
    flat = jnp.concatenate([jnp.asarray(mat).reshape(-1),
                            jnp.zeros((stride * HK,), jnp.uint8)])
    aa = dna_to_aa_codes(flat, jnp.asarray(lut), protein=protein)
    win = encode_windows(aa, HK, stride)
    win = win[:rows * maxlen].reshape(rows, maxlen, -1)
    if one_frame and not protein:
        win = win[:, ::3]
    return np.asarray(win[:, :w].reshape(rows * w, -1))


@pytest.mark.parametrize("protein,one_frame,maxlen",
                         [(False, False, 176), (False, False, 75),
                          (False, True, 160), (True, False, 64)],
                         ids=["dna", "dna_one_window", "one_frame",
                              "protein"])
def test_encode_five_limbs_matches_jax(protein, one_frame, maxlen):
    """K1's plain L-limb arm (and the numpy twin of the host recompute)
    against fused_turbo_acc's windowing at highestK = 25: five limbs, the
    last holding one letter, bit-identical."""
    from kasa_tpu.match.turbo import read_windows_np as j_read_windows
    from kasa_tpu_torch.core import encode as PE
    from kasa_tpu_torch.match.fast import BatchAssembler
    from kasa_tpu_torch.match.turbo import read_windows_np
    rng = np.random.default_rng(maxlen + protein)
    mat = rng.choice(PROTEIN if protein else ALPHABET, size=(40, maxlen))
    lut = PE.build_codon_code_lut().astype(np.int32)
    w = BatchAssembler(HK, MIN_K, protein, False, one_frame) \
        .window_target(maxlen)
    got = PE.encode_windows(torch.from_numpy(mat), torch.from_numpy(lut), w,
                            protein, one_frame, HK)
    assert got.shape == (40 * w, L)
    np.testing.assert_array_equal(got.numpy(),
                                  _jax_windows(mat, lut, w, protein,
                                               one_frame))
    with pytest.raises(ValueError):
        PE.encode_windows(torch.from_numpy(mat), torch.from_numpy(lut),
                          w + 1, protein, one_frame, HK)
    np.testing.assert_array_equal(
        read_windows_np(mat[:2], lut, HK, protein, one_frame, w),
        j_read_windows(mat[:2], lut, HK, protein, one_frame, w))


@pytest.mark.parametrize("kpr", [76, 152])
def test_dedup_five_limbs_matches_jax(kpr):
    """K5's plain L-limb arm against kasa_tpu's dedup_read_windows on
    seeded five-limb windows with planted duplicates and windows that
    differ in one limb only: bit-identical, sorted layout included; the
    host twin keeps exactly the distinct windows."""
    import jax.numpy as jnp
    from kasa_tpu.match.turbo import dedup_read_windows
    from kasa_tpu.match.turbo import dedup_windows_np as j_dedup_np
    from kasa_tpu_torch.match import turbo as PT
    rng = np.random.default_rng(kpr)
    R = 48
    q = rng.integers(0, 1 << 30, size=(R * kpr, L), dtype=np.int32)
    q[:, :2] &= 0x7                   # few distinct leading limbs
    src = rng.integers(0, R * kpr, size=R * kpr // 3)
    dst = (src // kpr) * kpr + rng.integers(0, kpr, size=len(src))
    q[dst] = q[src]
    q[dst[::2], 4] ^= 1 << 25         # twins but for the last limb
    want = np.asarray(dedup_read_windows(jnp.asarray(q), R, kpr))
    got = PT.dedup_windows(torch.from_numpy(q), R, kpr).numpy()
    assert (want == PT.POISON_LIMB).all(axis=1).sum() > R
    np.testing.assert_array_equal(got, want)
    for r in range(3):
        rows = q[r * kpr:(r + 1) * kpr]
        np.testing.assert_array_equal(PT.dedup_windows_np(rows),
                                      j_dedup_np(rows))


INDEX128 = ("exampleIndex128", "exampleIndex128_info.txt",
            "exampleIndex128_f.txt", "exampleIndex128_trie",
            "exampleIndex128_trie.txt", "exampleIndex_content.txt")


@pytest.fixture(scope="module")
def index128_dir(tmp_path_factory):
    """A private copy of the golden 128-bit index: both packages write
    their table sidecar next to the index."""
    d = tmp_path_factory.mktemp("torch_index128")
    for f in INDEX128:
        shutil.copy(GOLDEN / f, d / f)
    return d


@pytest.mark.parametrize("case", ["default", "six", "unique"])
def test_identify_128_agrees_with_jax_turbo(tmp_path, monkeypatch,
                                            index128_dir, case):
    from kasa_tpu.config import Config as JConfig
    from kasa_tpu.match.pipeline import identify as jidentify
    from kasa_tpu_torch.config import Config
    from kasa_tpu_torch.match import fast
    from kasa_tpu_torch.match.pipeline import identify
    monkeypatch.setenv("KASA_MESH_DP", "1")
    ov = {"six": {"six_frames": True}, "unique": {"unique": True}}\
        .get(case, {})
    src = str(FIXTURES / "reads.fastq")
    d = index128_dir
    outs = {}
    for who, cfg in (("j", JConfig()), ("t", Config())):
        cfg.content_file = str(d / "exampleIndex_content.txt")
        cfg.lower_k, cfg.higher_k = MIN_K, MAX_K
        for k, v in ov.items():
            setattr(cfg, k, v)
        kw = dict(index_path=str(d / "exampleIndex128"), input_path=src,
                  out_file=str(tmp_path / f"{who}.json"),
                  profile_file=str(tmp_path / f"{who}.csv"))
        if who == "j":
            cfg.engine = "tpu"
            jidentify(cfg, **kw)
        else:
            outs[who] = identify(cfg, device="cpu", **kw)
    ca, cu, nreads, nk = outs["t"]
    assert nreads == 300 and nk > 0 and cu.sum() > 0
    assert fast.LAST_DISPATCH.tt.keys2.shape[1] == L
    assert_identify_agrees(json.load(open(tmp_path / "j.json")),
                           json.load(open(tmp_path / "t.json")),
                           (tmp_path / "j.csv").read_text(),
                           (tmp_path / "t.csv").read_text(),
                           MAX_K - MIN_K + 1)


def test_128_bit_artifacts_round_trip(tmp_path):
    """The port reads the golden 128-bit records as kasa_tpu does and its
    writer gives back the same bytes."""
    from kasa_tpu.index import artifacts as JA
    from kasa_tpu_torch.index import artifacts as PA
    limbs, taxids, hk, itype = PA.read_index(str(GOLDEN / "exampleIndex128"))
    jl, jtax, jhk, jtype = JA.read_index(str(GOLDEN / "exampleIndex128"))
    assert (hk, itype) == (jhk, jtype) == (25, PA.INDEX_TYPE_128)
    np.testing.assert_array_equal(limbs, jl)
    np.testing.assert_array_equal(taxids, jtax)
    PA.write_index(str(tmp_path / "idx"), limbs, taxids, hk)
    assert (tmp_path / "idx").read_bytes() == \
        (GOLDEN / "exampleIndex128").read_bytes()
    assert PA.read_info(str(tmp_path / "idx")) == \
        PA.read_info(str(GOLDEN / "exampleIndex128"))


def test_cli_identify_128(tmp_path, index128_dir):
    """python -m kasa_tpu_torch identify on the 128-bit index, k 25..20."""
    from kasa_tpu_torch.cli import main
    d = index128_dir
    rc = main(["kasa_tpu_torch", "identify", "-d", str(d / "exampleIndex128"),
               "-c", str(d / "exampleIndex_content.txt"), "-k", "25", "20",
               "-i", str(FIXTURES / "reads.fastq"),
               "-q", str(tmp_path / "o.json"), "-p", str(tmp_path / "p.csv"),
               "--device", "cpu"])
    assert rc == 0 and len(json.load(open(tmp_path / "o.json"))) == 300
    head = (tmp_path / "p.csv").read_text().splitlines()[0]
    assert "25" in head and "20" in head


@pytest.mark.parametrize("unique", [False, True], ids=["default", "unique"])
def test_golden_batch_128_matches_fused_turbo_acc(unique):
    """fixtures/reads.fastq as one padded 512-row batch on the golden
    128-bit index at k 20..25 (K1's five-limb windows, K5 under -e, the
    search and the packed readback) against kasa_tpu's fused_turbo_acc:
    packed readback identical in its integer lanes, lists and both
    accumulators under the contract."""
    import jax.numpy as jnp
    from kasa_tpu.index import artifacts
    from kasa_tpu.match import turbo as JT
    from kasa_tpu.match.join import map_tax_rows
    from kasa_tpu.match.pipeline import load_content_for_identify
    from kasa_tpu_torch.core.alphabet import build_codon_code_lut
    from kasa_tpu_torch.match import turbo as PT
    from kasa_tpu_torch.match.fast import BatchAssembler
    from kasa_tpu_torch.native import load_fastx, sanitize_inplace
    limbs, taxids, _, _ = artifacts.read_index(str(GOLDEN / "exampleIndex128"))
    content = load_content_for_identify(
        str(GOLDEN / "exampleIndex_content.txt"))
    S, nk = content.num_species, MAX_K - MIN_K + 1
    jt = JT.TurboTables.build_from_arrays(
        limbs, map_tax_rows(taxids, content.tax_to_idx), HK, MIN_K, MAX_K, S)
    seq, so, _, _, _ = load_fastx(str(FIXTURES / "reads.fastq"), True)
    sanitize_inplace(seq, False)
    asm = BatchAssembler(HK, MIN_K)
    maxlen = (int(np.diff(so).max()) + asm.marker_len + 15) // 16 * 16
    R = 512
    mat = asm.assemble(seq, so.astype(np.int64), maxlen, R)
    w = asm.window_target(maxlen)
    lut = build_codon_code_lut().astype(np.int32)
    cap = 4 * R
    jp, jht, jhk, jca, jcu = [np.asarray(o) for o in JT.fused_turbo_acc(
        jt.keys2, jt.rowdat, jt.router, jt.sub2, jt.grp2, jt.d_tax4,
        jt.weights, jt.masks2, jt.hotmask, jt.t_hot, jnp.asarray(mat),
        jnp.asarray(lut), jnp.zeros((nk, S), jnp.float32),
        jnp.zeros((nk, S), jnp.int32), jt.num_steps, MIN_K, MAX_K, HK, S, R,
        False, False, 1, w, cap, unique)]
    ca = torch.zeros((nk, S))
    cu = torch.zeros((nk, S), dtype=torch.int32)
    pp, pht, phk = PT.fused_turbo_acc(
        PT.tables_from_numpy(*jax_arrays(jt), "cpu"), torch.from_numpy(mat),
        torch.from_numpy(lut), ca, cu, R, w, cap, unique=unique)
    _assert_packed(pp.numpy(), jp, R, cap)
    assert int(jp[-2]) > 0
    np.testing.assert_array_equal(pht.numpy(), jht)
    np.testing.assert_allclose(phk.numpy(), jhk, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ca.numpy(), jca, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(cu.numpy(), jcu)
