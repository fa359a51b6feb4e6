"""kasa_tpu_torch identify's flag variants against kasa_tpu's turbo engine
on the CPU (the port's plain kernel versions): --six, --one, -e, -z, -a,
paired-end, halved indices, --filter and identify_multiple, plus the
kernel-level pieces they add (K5 dedup, the per-file count arms of K3
and K4, the protein and one-frame arms of K1).

The contract (ROADMAP.md): integers identical (hit taxa, unique counts,
flags, the packed readback's integer lanes), floats within rtol 2e-5 /
atol 1e-4; per-file all-counts summed over a batch within rtol 2e-5 /
atol 2e-3, as kasa_tpu's own packed-multi test allows
(tests/test_fast_helpers.py:130-134)."""

import gzip
import json
import pathlib
import shutil

import numpy as np
import pytest
import torch

from test_torch_identify import assert_identify_agrees

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "golden"
FIXTURES = REPO / "fixtures"
RTOL, ATOL = 2e-5, 1e-4
INDEX_FAMILIES = ("exampleIndex", "exampleIndex_s", "protIndex")

# NCBI gc.prt layout as kASA's setCodonTable reads it (kASA.hpp:579-615):
# table 4 (mycoplasma) reads TGA as W where the built-in alphabet has ']'
GC_PRT = """--**************************************************************
Genetic-code-table ::= {
 {
  name "Mycoplasma Mitochondrial; Protozoan Mitochondrial" ,
  name "SGC3" ,
  id 4 ,
  ncbieaa  "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
  sncbieaa "--MM------**-------M------------MMMM---------------M------------"
  -- Base1  TTTTTTTTTTTTTTTTCCCCCCCCCCCCCCCCAAAAAAAAAAAAAAAAGGGGGGGGGGGGGGGG
  -- Base2  TTTTCCCCAAAAGGGGTTTTCCCCAAAAGGGGTTTTCCCCAAAAGGGGTTTTCCCCAAAAGGGG
  -- Base3  TCAGTCAGTCAGTCAGTCAGTCAGTCAGTCAGTCAGTCAGTCAGTCAGTCAGTCAGTCAGTCAG
 }
}
"""


@pytest.fixture(scope="module")
def index_dir(tmp_path_factory):
    """Private copies of the golden index families: both packages write
    their table sidecar next to the index."""
    d = tmp_path_factory.mktemp("torch_flags_index")
    for f in GOLDEN.iterdir():
        if f.is_file() and f.name.startswith(INDEX_FAMILIES):
            shutil.copy(f, d / f.name)
    return d


def _protein_reads(path):
    """Protein reads that hit protIndex (the golden protein_reads.fasta
    matches nothing)."""
    from kasa_tpu_torch.synth import protein_reads
    return protein_reads(str(FIXTURES / "protein.fasta"), str(path))


def _configure(cfg, d, overrides, tmp_path):
    cfg.content_file = str(d / overrides.pop("content",
                                             "exampleIndex_content.txt"))
    if overrides.pop("alpha", False):
        (tmp_path / "gc.prt").write_text(GC_PRT)
        cfg.codon_table, cfg.codon_id = str(tmp_path / "gc.prt"), "4"
    if overrides.pop("paired", False):
        cfg.paired_end_1 = str(FIXTURES / "reads_1.fastq")
        cfg.paired_end_2 = str(FIXTURES / "reads_2.fastq")
    for k, v in overrides.items():
        setattr(cfg, k, v)
    return cfg


def _run_jax(d, index, inp, overrides, out, prof, tmp_path):
    from kasa_tpu.config import Config
    from kasa_tpu.match.pipeline import identify
    cfg = _configure(Config(), d, dict(overrides), tmp_path)
    cfg.engine = "tpu"
    return identify(cfg, index_path=str(d / index), input_path=inp,
                    out_file=out and str(out),
                    profile_file=prof and str(prof))


def _run_port(d, index, inp, overrides, out, prof, tmp_path):
    from kasa_tpu_torch.config import Config
    from kasa_tpu_torch.match.pipeline import identify
    cfg = _configure(Config(), d, dict(overrides), tmp_path)
    return identify(cfg, index_path=str(d / index), input_path=inp,
                    out_file=out and str(out),
                    profile_file=prof and str(prof), device="cpu")


CASES = {
    "six": ("exampleIndex", "reads.fastq", {"six_frames": True}),
    "one": ("exampleIndex", "reads.fastq", {"one_frame": True}),
    "unique": ("exampleIndex", "reads.fastq", {"unique": True}),
    "unique_six": ("exampleIndex", "reads.fastq",
                   {"unique": True, "six_frames": True}),
    "paired": ("exampleIndex", "", {"paired": True}),
    "paired_six": ("exampleIndex", "", {"paired": True,
                                        "six_frames": True}),
    "protein": ("protIndex", None,
                {"translated": True, "content": "protIndex_content.txt"}),
    "alpha": ("exampleIndex", "reads.fastq", {"alpha": True}),
    "halved": ("exampleIndex_s", "reads.fastq", {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_flags_agree_with_jax_turbo(tmp_path, monkeypatch, index_dir, case):
    # kasa_tpu's single-device turbo strategy is the port's counterpart
    # (the 8 host devices of tests/conftest.py would select its mesh)
    monkeypatch.setenv("KASA_MESH_DP", "1")
    index, inp, ov = CASES[case]
    src = str(FIXTURES / inp) if inp else ""
    if inp is None:
        src = _protein_reads(tmp_path / "protein_reads.fasta")
    _run_jax(index_dir, index, src, ov, tmp_path / "j.json",
             tmp_path / "j.csv", tmp_path)
    ca, cu, nreads, nk = _run_port(index_dir, index, src, ov,
                                   tmp_path / "t.json", tmp_path / "t.csv",
                                   tmp_path)
    assert nreads > 0 and nk > 0 and cu.sum() > 0
    assert_identify_agrees(json.load(open(tmp_path / "j.json")),
                           json.load(open(tmp_path / "t.json")),
                           (tmp_path / "j.csv").read_text(),
                           (tmp_path / "t.csv").read_text(), 6)


FILTER_CASES = {
    "single": ({}, "reads_filt.json", ("filt_clean.fastq",
                                       "filt_cont.fastq")),
    "single_gz": ({"gzip_out": True}, "reads_filt.json",
                  ("filt_clean.fastq", "filt_cont.fastq")),
    "paired": ({"paired": True}, "readsp_filt.json",
               ("filtp_clean_1.fastq", "filtp_clean_2.fastq",
                "filtp_cont_1.fastq", "filtp_cont_2.fastq")),
}


def _read_split(base, gz):
    if gz:
        with gzip.open(str(base) + ".gz", "rb") as fh:
            return fh.read()
    return pathlib.Path(base).read_bytes()


@pytest.mark.parametrize("case", list(FILTER_CASES))
def test_filter_split_files_match(tmp_path, monkeypatch, index_dir, case):
    """--filter: the clean / contaminant split files are byte-identical
    to kasa_tpu's turbo run and to the reference's goldens; the per-read
    output agrees with the golden under the contract."""
    monkeypatch.setenv("KASA_MESH_DP", "1")
    ov, golden_json, goldens = FILTER_CASES[case]
    paired = ov.get("paired", False)
    src = "" if paired else str(FIXTURES / "reads.fastq")
    prefix = "filtp" if paired else "filt"
    for who, run in (("j", _run_jax), ("t", _run_port)):
        o = dict(ov, filter=True,
                 filtered_clean_out=str(tmp_path / f"{who}_{prefix}_clean"),
                 filtered_contaminants_out=str(
                     tmp_path / f"{who}_{prefix}_cont"))
        run(index_dir, "exampleIndex", src, o, tmp_path / f"{who}.json",
            None, tmp_path)
    gz = ov.get("gzip_out", False)
    for g in goldens:
        want = (GOLDEN / g).read_bytes()
        assert _read_split(tmp_path / f"t_{g}", gz) == want, g
        assert _read_split(tmp_path / f"j_{g}", gz) == want, g
    ref = json.load(open(GOLDEN / golden_json))
    got = json.load(open(tmp_path / "t.json"))
    assert len(ref) == len(got)
    for er, tr in zip(ref, got):
        assert er["Read number"] == tr["Read number"]
        eh = {h["tax ID"]: h for h in er["Top hits"] + er["Further hits"]}
        th = {h["tax ID"]: h for h in tr["Top hits"] + tr["Further hits"]}
        assert set(eh) == set(th)
        for tid, h in eh.items():
            np.testing.assert_allclose(float(th[tid]["k-mer Score"]),
                                       float(h["k-mer Score"]),
                                       rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("reads_per_batch", [None, 7, 1],
                         ids=["one_batch", "straddling", "one_read"])
def test_identify_multiple_profiles(tmp_path, monkeypatch, index_dir,
                                    reads_per_batch):
    """identify_multiple on fixtures/multi with profiles: per-read
    outputs and profiles agree with the reference's goldens, and the
    per-file count matrices with kasa_tpu's packed run (unique counts
    identical, all-counts within rtol 2e-5 / atol 2e-3).  one_batch:
    both files share one batch; straddling: 7 reads per batch, one batch
    spans the boundary; one_read: one read per batch, the padded rows
    on the last file."""
    from kasa_tpu.config import Config as JConfig
    from kasa_tpu.match.pipeline import identify as jidentify
    from kasa_tpu_torch.config import Config
    from kasa_tpu_torch.match import fast
    from kasa_tpu_torch.match.pipeline import identify_multiple
    monkeypatch.setenv("KASA_MESH_DP", "1")
    monkeypatch.setenv("KASA_MESH_IP", "1")
    d = index_dir
    cfg = JConfig()
    cfg.engine = "tpu"
    cfg.content_file = str(d / "exampleIndex_content.txt")
    ref = jidentify(cfg, index_path=str(d / "exampleIndex"),
                    input_path=str(FIXTURES / "multi"),
                    out_file=str(tmp_path / "jq_"),
                    profile_file=str(tmp_path / "jp_"))
    if reads_per_batch:
        monkeypatch.setattr(fast, "READS_PER_BATCH", reads_per_batch)
    cfg = Config()
    cfg.content_file = str(d / "exampleIndex_content.txt")
    cfg.index_file = str(d / "exampleIndex")
    cfg.input = str(FIXTURES / "multi")
    cfg.read_to_taxa_file = str(tmp_path / "tq_")
    cfg.table_file = str(tmp_path / "tp_")
    got = identify_multiple(cfg, device="cpu")
    assert len(got) == len(ref) == 2
    for (ca1, cu1, n1, k1), (ca2, cu2, n2, k2) in zip(got, ref):
        assert (n1, k1) == (n2, k2)
        np.testing.assert_array_equal(np.asarray(cu1, np.int64),
                                      np.asarray(cu2, np.int64))
        np.testing.assert_allclose(ca1, ca2, rtol=2e-5, atol=2e-3)
    for name in ("a", "b"):
        assert_identify_agrees(
            json.load(open(GOLDEN / f"multi_q_{name}.json")),
            json.load(open(tmp_path / f"tq_{name}.json")),
            (GOLDEN / f"multi_p_{name}.csv").read_text(),
            (tmp_path / f"tp_{name}.csv").read_text(), 6)


def test_folder_under_six_runs_per_file(tmp_path, monkeypatch, index_dir):
    """A folder under --six takes the per-file loop (the packed stream is
    single-line only, as in kasa_tpu): outputs named <q><name>.json /
    <p><name>.csv, each agreeing with kasa_tpu's per-file run."""
    monkeypatch.setenv("KASA_MESH_DP", "1")
    folder = tmp_path / "in"
    folder.mkdir()
    for m in (1, 2):
        shutil.copy(FIXTURES / f"reads_{m}.fastq", folder / f"m{m}.fastq")
    ov = {"six_frames": True}
    _run_jax(index_dir, "exampleIndex", str(folder), ov, tmp_path / "jq_",
             tmp_path / "jp_", tmp_path)
    got = _run_port(index_dir, "exampleIndex", str(folder), ov,
                    tmp_path / "tq_", tmp_path / "tp_", tmp_path)
    assert [r[2] for r in got] == [120, 120]
    for m in (1, 2):
        assert_identify_agrees(
            json.load(open(tmp_path / f"jq_m{m}.json")),
            json.load(open(tmp_path / f"tq_m{m}.json")),
            (tmp_path / f"jp_m{m}.csv").read_text(),
            (tmp_path / f"tp_m{m}.csv").read_text(), 6)


def test_long_read_pairs_raise_under_six(tmp_path, monkeypatch, index_dir):
    """2x250 bp pairs under --six: 4 lines x 237 windows x 6 levels =
    5,688 slots per read, more than K3's shared-memory arm sorts (2x150 bp
    pairs have 3,384); they classify as kasa_tpu classifies them."""
    from test_torch_long import genome_reads
    monkeypatch.setenv("KASA_MESH_DP", "1")
    names = [f"p{i}" for i in range(3)]
    for m in (1, 2):
        genome_reads(tmp_path / f"long_{m}.fasta", [250] * 3, 250 + m, names)
    ov = {"six_frames": True,
          "paired_end_1": str(tmp_path / "long_1.fasta"),
          "paired_end_2": str(tmp_path / "long_2.fasta")}
    _run_jax(index_dir, "exampleIndex", "", ov, tmp_path / "j.json",
             tmp_path / "j.csv", tmp_path)
    got = _run_port(index_dir, "exampleIndex", "", ov, tmp_path / "o.json",
                    tmp_path / "o.csv", tmp_path)
    assert got[2] == 3 and got[1].sum() > 0
    assert_identify_agrees(json.load(open(tmp_path / "j.json")),
                           json.load(open(tmp_path / "o.json")),
                           (tmp_path / "j.csv").read_text(),
                           (tmp_path / "o.csv").read_text(), 6)


# ---------------------------------------------------------------------------
# kernel level

@pytest.mark.parametrize("kpr", [30, 282])
def test_dedup_plain_matches_jax(kpr):
    """K5's plain version against kasa_tpu's dedup_read_windows on
    seeded limbs with planted duplicates (and windows equal in one limb
    only): bit-identical, sorted layout included."""
    import jax.numpy as jnp
    from kasa_tpu.match.turbo import dedup_read_windows
    from kasa_tpu_torch.match import turbo as PT
    rng = np.random.default_rng(kpr)
    R = 64
    q = rng.integers(0, 1 << 30, size=(R * kpr, 2), dtype=np.int32)
    q[:, 0] &= 0x3FFF             # few distinct limb0 values
    src = rng.integers(0, R * kpr, size=R * kpr // 3)
    dst = (src // kpr) * kpr + rng.integers(0, kpr, size=len(src))
    q[dst] = q[src]                              # duplicates in a read
    q[dst[::2], 1] ^= 1                          # limb0-only twins
    q[::kpr] = PT.POISON_LIMB                    # already poisoned
    want = np.asarray(dedup_read_windows(jnp.asarray(q), R, kpr))
    got = PT.dedup_windows(torch.from_numpy(q), R, kpr).numpy()
    assert (want == PT.POISON_LIMB).any(axis=1).sum() > R
    np.testing.assert_array_equal(got, want)
    # the host twin keeps exactly the distinct windows of a read
    for r in range(3):
        rows = q[r * kpr:(r + 1) * kpr]
        kept = PT.dedup_windows_np(rows)
        w = want[r * kpr:(r + 1) * kpr]
        w = w[~((w[:, 0] == PT.POISON_LIMB) & (w[:, 1] == PT.POISON_LIMB))]
        assert len(np.unique(rows, axis=0)) == len(kept)
        assert {tuple(x) for x in kept} >= {tuple(x) for x in w}


def _golden_batch(R):
    from kasa_tpu_torch.match.fast import BatchAssembler
    from kasa_tpu_torch.native import load_fastx, sanitize_inplace
    seq, so, _, _, _ = load_fastx(str(FIXTURES / "reads.fastq"), True)
    sanitize_inplace(seq, False)
    asm = BatchAssembler(12, 7)
    maxlen = (int(np.diff(so).max()) + asm.marker_len + 15) // 16 * 16
    return asm.assemble(seq, so.astype(np.int64), maxlen, R), \
        asm.window_target(maxlen)


def test_files_arm_matches_fused_turbo_files():
    """The per-file count arms of K3 (post) and K4 through the port's
    batch step against kasa_tpu's fused_turbo_files on the golden tables
    with a 3-file file_of_read (padded rows on the last file), under -e
    so K5 runs too: packed readback identical in its integer lanes, the
    (F, numK, S) counts under the contract."""
    import jax.numpy as jnp
    from kasa_tpu.index import artifacts
    from kasa_tpu.match import turbo as JT
    from kasa_tpu.match.join import map_tax_rows
    from kasa_tpu.match.pipeline import load_content_for_identify
    from kasa_tpu_torch.core.alphabet import build_codon_code_lut
    from kasa_tpu_torch.match import turbo as PT
    from test_torch_core import _assert_packed, _port_tables

    limbs, taxids, _, _ = artifacts.read_index(str(GOLDEN / "exampleIndex"))
    content = load_content_for_identify(
        str(GOLDEN / "exampleIndex_content.txt"))
    S = content.num_species
    jt = JT.TurboTables.build_from_arrays(
        limbs, map_tax_rows(taxids, content.tax_to_idx), 12, 7, 12, S)
    R = 512
    mat, w = _golden_batch(R)
    lut = build_codon_code_lut().astype(np.int32)
    cap = 4 * R
    fo = np.full(R, 2, np.int32)
    fo[:100] = 0
    fo[100:230] = 1
    jp, jht, jhk, jca, jcu = [np.asarray(o) for o in JT.fused_turbo_files(
        jt.keys2, jt.rowdat, jt.router, jt.sub2, jt.grp2, jt.d_tax4,
        jt.weights, jt.masks2, jt.hotmask, jt.t_hot, jnp.asarray(mat),
        jnp.asarray(lut), jnp.asarray(fo), jt.num_steps, 7, 12, 12, S, R,
        False, False, 1, w, cap, True, num_files=3)]
    ca = torch.zeros((3, 6, S))
    cu = torch.zeros((3, 6, S), dtype=torch.int32)
    pp, pht, phk = PT.fused_turbo_acc(
        _port_tables(jt), torch.from_numpy(mat), torch.from_numpy(lut), ca,
        cu, R, w, cap, unique=True, file_of_read=torch.from_numpy(fo))
    _assert_packed(pp.numpy(), jp, R, cap)
    np.testing.assert_array_equal(pht.numpy(), jht)
    np.testing.assert_allclose(phk.numpy(), jhk, rtol=RTOL, atol=ATOL)
    assert (jcu.sum(axis=(1, 2)) > 0).all()
    np.testing.assert_array_equal(cu.numpy(), jcu)
    np.testing.assert_allclose(ca.numpy(), jca, rtol=RTOL, atol=ATOL)


ALPHABET = np.frombuffer(b"ACGTXZacgt", np.uint8)
PROTEIN = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY^[", np.uint8)


def _jax_windows(mat, lut, w, protein, one_frame):
    """kasa_tpu/match/turbo.py fused_turbo_acc prologue (1206-1216)."""
    import jax.numpy as jnp
    from kasa_tpu.core.encode import dna_to_aa_codes, encode_windows
    rows, maxlen = mat.shape
    stride = 1 if protein else 3
    flat = jnp.concatenate([jnp.asarray(mat).reshape(-1),
                            jnp.zeros((stride * 12,), jnp.uint8)])
    aa = dna_to_aa_codes(flat, jnp.asarray(lut), protein=protein)
    win = encode_windows(aa, 12, stride)
    win = win[:rows * maxlen].reshape(rows, maxlen, -1)
    if one_frame and not protein:
        win = win[:, ::3]
    return np.asarray(win[:, :w].reshape(rows * w, -1))


@pytest.mark.parametrize("protein,one_frame,maxlen",
                         [(True, False, 64), (False, True, 176),
                          (False, True, 97)],
                         ids=["protein", "one_frame", "one_frame_ragged"])
def test_encode_modes_match_jax(protein, one_frame, maxlen):
    """K1's protein and one-frame plain versions (and their numpy twins
    for the host recompute) against fused_turbo_acc's windowing:
    bit-identical, the last window of each row inside the row."""
    from kasa_tpu.match.turbo import read_windows_np as j_read_windows
    from kasa_tpu_torch.core import encode as PE
    from kasa_tpu_torch.match.fast import BatchAssembler
    from kasa_tpu_torch.match.turbo import read_windows_np
    rng = np.random.default_rng(maxlen)
    mat = rng.choice(PROTEIN if protein else ALPHABET, size=(40, maxlen))
    lut = PE.build_codon_code_lut().astype(np.int32)
    w = BatchAssembler(12, 7, protein, False, one_frame).window_target(maxlen)
    got = PE.encode_windows(torch.from_numpy(mat), torch.from_numpy(lut), w,
                            protein, one_frame)
    np.testing.assert_array_equal(got.numpy(),
                                  _jax_windows(mat, lut, w, protein,
                                               one_frame))
    with pytest.raises(ValueError):
        PE.encode_windows(torch.from_numpy(mat), torch.from_numpy(lut),
                          w + 1, protein, one_frame)
    np.testing.assert_array_equal(
        read_windows_np(mat[:2], lut, 12, protein, one_frame, w),
        j_read_windows(mat[:2], lut, 12, protein, one_frame, w))


@pytest.mark.parametrize("lines_per_read,w,factor,wout", [
    (1, 141, 1, 160), (2, 141, 1, 160), (4, 141, 2, 320),
    (1, 7981, 29, 2047), (1, 700, 3, 480)])
def test_multi_budget_per_two_lines(lines_per_read, w, factor, wout):
    """The drive loop keeps kasa_tpu's MULTI_BUDGET, EXP_BUDGET and WOUT
    for reads of one or two 150 bp lines (141 windows) and scales them
    by the read's slots over two such lines beyond: pairs under --six,
    and long lines (7,981 windows: an 8 kbp read), whose hit lists are
    capped at the index's S = 2,047 taxa."""
    from types import SimpleNamespace
    from kasa_tpu_torch.match import fast, turbo
    disp = fast.SingleTurboDispatch(SimpleNamespace(device="cpu"), 6, 2047)
    assert disp.budgets_for(lines_per_read, w) == (
        factor * turbo.MULTI_BUDGET, factor * turbo.EXP_BUDGET, wout)
