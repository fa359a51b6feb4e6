"""The classic engine of kasa_tpu_torch against kasa_tpu's, end to end
on the CPU: the port's identify (device="cpu") against kasa_tpu's
--engine tpu on every route to the classic engine, the fused path (a
128-bit index over 14 k levels, min_k < 5, KASA_TPU_NO_TURBO) and the
per-batch engine (paired-end on the classic path, -j, --coherence,
reads above MAXLEN_CAP, batches that split a read), and an empty input.
Kernel level: tests/test_torch_classic.py.

The contract: identical hit taxa and integer counts, floats within
rtol 2e-5 / atol 1e-4.  Every hit is written (-b 1000): the float sums
of the two packages can order two equal scores apart, and the writer's
top-N counts distinct scores.

kasa_tpu's fused classic branch names an undefined `tax_to_row`
(kasa_tpu/match/fast.py:502) and fails with a NameError on every index
the turbo structure declines; the tests give that module the global it
names (the content file's taxid -> row map) so the reference runs.  They
also show kasa_tpu's fused classic path ignoring -e (ROADMAP Queue 3)."""

import json
import pathlib
import shutil

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "golden"
FIXTURES = REPO / "fixtures"
CONTENT = GOLDEN / "exampleIndex_content.txt"
RTOL, ATOL = 2e-5, 1e-4
ALL_HITS = 1000


@pytest.fixture
def jax_classic(monkeypatch):
    """kasa_tpu's fused classic branch reads a module global
    `tax_to_row` that nothing defines (fast.py:502): give it the content
    file's map.  The JAX package's file is not touched."""
    import kasa_tpu.match.fast as jf
    from kasa_tpu.match.pipeline import load_content_for_identify
    monkeypatch.setenv("KASA_MESH_DP", "1")
    monkeypatch.setattr(jf, "tax_to_row",
                        load_content_for_identify(str(CONTENT)).tax_to_idx,
                        raising=False)


def _jax_per_batch(monkeypatch):
    """Route kasa_tpu to its per-batch engine (TpuEngine), as its own
    FastPathUnavailable does."""
    import kasa_tpu.match.fast as jf

    def unavailable(*a, **k):
        raise jf.FastPathUnavailable("per-batch engine")
    monkeypatch.setattr(jf, "fast_identify", unavailable)


def _run(pkg, index, inp, ov, out, engine="tpu"):
    if pkg == "jax":
        from kasa_tpu.config import Config
        from kasa_tpu.match.pipeline import identify
        cfg = Config()
        cfg.engine = engine
        kw = {}
    else:
        from kasa_tpu_torch.config import Config
        from kasa_tpu_torch.match.pipeline import identify
        cfg = Config()
        kw = {"device": "cpu"}
    cfg.content_file = str(CONTENT)
    cfg.num_of_beasts = ALL_HITS
    for k, v in ov.items():
        setattr(cfg, k, v)
    path = index if isinstance(index, pathlib.Path) else GOLDEN / index
    res = identify(cfg, index_path=str(path), input_path=inp,
                   out_file=str(out) + ".json",
                   profile_file=str(out) + ".csv", **kw)
    return res, json.load(open(str(out) + ".json")), \
        open(str(out) + ".csv").read()


def _agree(ref, got, num_k, coherence=False):
    """The contract on two identify runs: read fields and hit taxa equal,
    k-mer scores within rtol 2e-5 / atol 1e-4, the profile's unique counts
    identical and its floats within the same tolerance; --coherence
    values equal (host numpy in both)."""
    (rr, rj, rp), (gr, gj, gp) = ref, got
    assert rr[2:] == gr[2:]
    assert len(rj) == len(gj) > 0
    for a, b in zip(rj, gj):
        for f in ("Read number", "Specifier from input file", "Length"):
            assert a[f] == b[f]
        ha = {h["tax ID"]: h for h in a["Top hits"] + a["Further hits"]}
        hb = {h["tax ID"]: h for h in b["Top hits"] + b["Further hits"]}
        assert set(ha) == set(hb), f"read {a['Read number']}: hit taxa"
        for t, h in ha.items():
            np.testing.assert_allclose(float(hb[t]["k-mer Score"]),
                                       float(h["k-mer Score"]),
                                       rtol=RTOL, atol=ATOL)
            if coherence:
                assert hb[t]["Coherence"] == h["Coherence"]
    el, tl = rp.splitlines(), gp.splitlines()
    assert len(el) == len(tl) and el[0] == tl[0]
    for e, t in zip(el[1:], tl[1:]):
        ec, tc = e.split(","), t.split(",")
        assert ec[:2 + num_k] == tc[:2 + num_k]
        np.testing.assert_allclose(np.array(tc[2 + num_k:], float),
                                   np.array(ec[2 + num_k:], float),
                                   rtol=RTOL, atol=ATOL)


K128 = {"lower_k": 12, "higher_k": 25}
PAIRED = {"paired_end_1": str(FIXTURES / "reads_1.fastq"),
          "paired_end_2": str(FIXTURES / "reads_2.fastq")}

FUSED_CASES = [
    ("k25_12", "exampleIndex128", "reads.fastq", K128),
    ("k25_12_six", "exampleIndex128", "reads.fastq",
     dict(K128, six_frames=True)),
    ("k25_12_one", "exampleIndex128", "reads.fastq",
     dict(K128, one_frame=True)),
    ("k25_12_fasta", "exampleIndex128", "reads.fasta", K128),
    ("k25_12_gz", "exampleIndex128", "reads.fastq.gz", K128),
    ("k12_4", "exampleIndex", "reads.fastq", {"lower_k": 4}),
]


@pytest.mark.parametrize("index,inp,ov", [c[1:] for c in FUSED_CASES],
                         ids=[c[0] for c in FUSED_CASES])
def test_fused_classic_agrees_with_jax(tmp_path, jax_classic, index, inp,
                                       ov):
    """The turbo structure declines (14 k levels on a 128-bit index, min_k
    * 5 < 24): both packages take the fused classic path."""
    from kasa_tpu_torch.match import fast
    src = str(FIXTURES / inp)
    ref = _run("jax", index, src, ov, tmp_path / "j")
    got = _run("port", index, src, ov, tmp_path / "t")
    assert type(fast.LAST_DISPATCH).__name__ == "StackedTables"
    _agree(ref, got, ov["higher_k"] - ov["lower_k"] + 1 if "higher_k" in ov
           else 12 - ov["lower_k"] + 1)


NO_TURBO_CASES = [
    ("default", "reads.fastq", {}),
    ("six", "reads.fastq", {"six_frames": True}),
    ("edge", "edge.fasta", {}),
    ("one", "reads.fastq", {"one_frame": True}),
    ("fasta", "reads.fasta", {}),
    ("gz", "reads.fastq.gz", {}),
    ("k910", "reads.fastq", {"lower_k": 9, "higher_k": 10}),
]


@pytest.mark.parametrize("inp,ov", [c[1:] for c in NO_TURBO_CASES],
                         ids=[c[0] for c in NO_TURBO_CASES])
def test_no_turbo_agrees_with_jax(tmp_path, monkeypatch, jax_classic, inp,
                                  ov):
    """KASA_TPU_NO_TURBO on the cases of kasa_tpu's
    test_cli_tpu_engine_agrees_with_exact (coverage is the join engine's;
    -e is test_unique_fault_is_not_repeated)."""
    from kasa_tpu_torch.match import fast
    monkeypatch.setenv("KASA_TPU_NO_TURBO", "1")
    src = str(FIXTURES / inp)
    ref = _run("jax", "exampleIndex", src, ov, tmp_path / "j")
    got = _run("port", "exampleIndex", src, ov, tmp_path / "t")
    assert type(fast.LAST_DISPATCH).__name__ == "StackedTables"
    _agree(ref, got, ov.get("higher_k", 12) - ov.get("lower_k", 7) + 1)


@pytest.fixture
def repeat_reads(tmp_path):
    """Reads that repeat one 60 bp piece of a genome of
    fixtures/example.fasta three times, so their windows repeat (the
    reads of fixtures/reads.fastq repeat none: -e changes nothing
    there)."""
    from kasa_tpu_torch.host.fastx import iter_records
    seqs = [r.seq for r in iter_records(str(FIXTURES / "example.fasta"))]
    rng = np.random.default_rng(3)
    lines = []
    for i in range(40):
        s = seqs[i % len(seqs)]
        o = int(rng.integers(0, len(s) - 60))
        lines.append(f">rep{i}\n{s[o:o + 60] * 3}\n")
    p = tmp_path / "repeats.fasta"
    p.write_text("".join(lines))
    return str(p)


def test_unique_fault_is_not_repeated(tmp_path, monkeypatch, jax_classic,
                                      repeat_reads):
    """-e on the classic path.  kasa_tpu's fused run ignores it
    (fast.py:500-618 never reads cfg.unique): its -e output equals its
    output without -e.  The port dedups each read's windows (K5) and
    equals kasa_tpu's per-batch TpuEngine and its exact engine with -e."""
    monkeypatch.setenv("KASA_TPU_NO_TURBO", "1")
    src = repeat_reads
    e = {"unique": True}
    fused_e = _run("jax", "exampleIndex", src, e, tmp_path / "fe")
    fused = _run("jax", "exampleIndex", src, {}, tmp_path / "f")
    assert fused_e[1] == fused[1] and fused_e[2] == fused[2]
    got = _run("port", "exampleIndex", src, e, tmp_path / "t")
    exact = _run("jax", "exampleIndex", src, e, tmp_path / "x",
                 engine="exact")
    _agree(exact, got, 6)
    _jax_per_batch(monkeypatch)
    per_batch = _run("jax", "exampleIndex", src, e, tmp_path / "p")
    _agree(per_batch, got, 6)
    # and the -e run differs from the run without it
    assert got[2] != fused[2]


def test_paired_classic_runs_per_batch(tmp_path, jax_classic):
    """Paired-end input on the classic path: both packages hand it to the
    per-batch engine (kasa_tpu fast.py:498-499)."""
    ref = _run("jax", "exampleIndex128", "", dict(K128, **PAIRED),
               tmp_path / "j")
    got = _run("port", "exampleIndex128", "", dict(K128, **PAIRED),
               tmp_path / "t")
    _agree(ref, got, 14)


def test_coherence_agrees_with_jax_and_golden(tmp_path):
    """--coherence runs the per-batch engine in both packages; against
    the reference binary's tests/golden/reads_coh.json under the contract
    (its default three hits per read)."""
    src = str(FIXTURES / "reads.fastq")
    ov = {"post_process": True}
    ref = _run("jax", "exampleIndex", src, ov, tmp_path / "j")
    got = _run("port", "exampleIndex", src, ov, tmp_path / "t")
    _agree(ref, got, 6, coherence=True)
    assert any("Coherence" in h for r in got[1]
               for h in r["Top hits"] + r["Further hits"])
    from kasa_tpu_torch.config import Config
    from kasa_tpu_torch.match.pipeline import identify
    cfg = Config()
    cfg.content_file = str(CONTENT)
    cfg.post_process = True
    res = identify(cfg, index_path=str(GOLDEN / "exampleIndex"),
                   input_path=src, out_file=str(tmp_path / "g.json"),
                   profile_file=str(tmp_path / "g.csv"), device="cpu")
    golden = (res, json.load(open(GOLDEN / "reads_coh.json")),
              (GOLDEN / "reads_coh_profile.csv").read_text())
    _agree(golden, (res, json.load(open(tmp_path / "g.json")),
                    (tmp_path / "g.csv").read_text()), 6, coherence=True)


@pytest.fixture
def reduced_index(tmp_path):
    """The golden 64-bit index with its k-mers folded by kasa_tpu's
    sloppy reduction (six letters in limb 0, limb 1 zero), deduplicated,
    beside the golden frequency and content files: an index that -j
    reads match.  (A sloppy index family, as kasa_tpu's build writes it,
    has no _f.txt: its identify stops at the missing file in both
    packages.)"""
    from kasa_tpu.core.encode import aas_code_lut, sloppy_reduce_np
    from kasa_tpu.index import artifacts as A
    limbs, taxids, _, _ = A.read_index(str(GOLDEN / "exampleIndex"))
    red = sloppy_reduce_np(limbs, aas_code_lut())
    order = np.lexsort((taxids, red[:, 1], red[:, 0]))
    red, taxids = red[order], taxids[order]
    keep = np.ones(len(taxids), bool)
    keep[1:] = np.any(red[1:] != red[:-1], axis=1) \
        | (taxids[1:] != taxids[:-1])
    out = tmp_path / "reducedIndex"
    A.write_index(str(out), red[keep], taxids[keep], 12)
    A.write_trie(str(out), *A.trie_from_sorted_prefixes(red[keep][:, 0]))
    shutil.copy(GOLDEN / "exampleIndex_f.txt", str(out) + "_f.txt")
    return out


@pytest.mark.parametrize("which", ["golden", "reduced"])
def test_sloppy_agrees_with_jax(tmp_path, reduced_index, which):
    """-j: the per-batch engine with the sloppy fold (K1's arm) in both
    packages, on the golden 64-bit index (the reduced windows match none
    of its k-mers) and on its sloppy-reduced twin (they do)."""
    index = "exampleIndex" if which == "golden" else reduced_index
    src = str(FIXTURES / "reads.fastq")
    ov = {"sloppy": True}
    ref = _run("jax", index, src, ov, tmp_path / "j")
    got = _run("port", index, src, ov, tmp_path / "t")
    hits = sum(1 for r in got[1] if r["Top hits"])
    assert (hits > 0) == (which == "reduced")
    _agree(ref, got, 6)


def test_sloppy_index_family_has_no_frequencies(tmp_path):
    """kasa_tpu's sloppy index family (tests/golden/exampleIndexSloppy)
    has no _f.txt: -j identify on it stops there in both packages."""
    for pkg in ("jax", "port"):
        with pytest.raises(FileNotFoundError, match="_f.txt"):
            _run(pkg, "exampleIndexSloppy", str(FIXTURES / "reads.fastq"),
                 {"sloppy": True}, tmp_path / pkg)


@pytest.fixture
def giant_reads(tmp_path):
    """fixtures/example.fasta's genomes joined into reads above
    MAXLEN_CAP, in 70-character lines, plus one short read."""
    from kasa_tpu_torch.match.fast import MAXLEN_CAP
    from kasa_tpu_torch.host.fastx import iter_records
    seqs = [r.seq for r in iter_records(str(FIXTURES / "example.fasta"))]
    reads = ["".join(seqs[:4]), "".join(seqs[4:]), seqs[0][:150]]
    assert len(reads[0]) > MAXLEN_CAP and len(reads[1]) > MAXLEN_CAP
    p = tmp_path / "giant.fasta"
    p.write_text("".join(
        f">g{i}\n" + "".join(s[j:j + 70] + "\n" for j in range(0, len(s), 70))
        for i, s in enumerate(reads)))
    return str(p)


def test_giant_reads_run_per_batch(tmp_path, giant_reads):
    """Reads above MAXLEN_CAP: the fast path declines in both packages
    and the per-batch engine runs."""
    ref = _run("jax", "exampleIndex", giant_reads, {}, tmp_path / "j")
    got = _run("port", "exampleIndex", giant_reads, {}, tmp_path / "t")
    _agree(ref, got, 6)


def test_batches_split_reads_mid_read(tmp_path, monkeypatch, giant_reads):
    """Memory-bounded batching (tests/test_identify_parity.py:215) with a
    chunk size small enough that the giant reads are split across
    batches: partial scores carry over (saved_scores).  The chunk size and
    the soft budget are set alike in both packages."""
    from kasa_tpu.match import chunking as JC
    from kasa_tpu_torch.match import chunking as TC
    seen = []
    orig = TC.chunked_batches

    def counting(*a, **k):
        for b in orig(*a, **k):
            seen.append(b.add_tail)
            yield b
    for mod in (JC, TC):
        monkeypatch.setattr(mod, "_HUNDRED_MB", 24 * 2000)
        monkeypatch.setattr(mod, "identify_soft_budget",
                            lambda *a, **k: 24 * 2000 + 24 * 6000)
    monkeypatch.setattr(TC, "chunked_batches", counting)
    ref = _run("jax", "exampleIndex", giant_reads, {}, tmp_path / "j")
    got = _run("port", "exampleIndex", giant_reads, {}, tmp_path / "t")
    assert len(seen) > 3 and any(seen)
    _agree(ref, got, 6)


def test_empty_input_raises_as_jax(tmp_path, monkeypatch):
    """An empty input stops at the format check (sniff_format) in both
    packages, before either engine: kasa_tpu's `R_total == 0` branch
    (fast.py:458-459) is unreachable from a file, since the native loader
    finds a record in any file that starts with '>' or '@'.  The port
    keeps that branch: given no records, its fused path declines with
    FastPathUnavailable, as kasa_tpu's does."""
    src = tmp_path / "empty.fastq"
    src.write_text("")
    for pkg in ("jax", "port"):
        with pytest.raises(ValueError, match="does not start with"):
            _run(pkg, "exampleIndex", str(src), {}, tmp_path / pkg)
    from kasa_tpu_torch.config import Config
    from kasa_tpu_torch.match import fast
    from kasa_tpu_torch.match.pipeline import _load_index
    none = (np.zeros(0, np.uint8), np.zeros(1, np.int64),
            np.zeros(0, np.uint8), np.zeros(1, np.int64),
            np.zeros(0, np.int32))
    monkeypatch.setattr(fast, "_parse", lambda path: none)
    cfg = Config()
    cfg.content_file = str(CONTENT)
    limbs, taxids, hk, content, freqs, rows = _load_index(
        cfg, str(GOLDEN / "exampleIndex"))
    with pytest.raises(fast.FastPathUnavailable, match="empty input"):
        fast.fast_identify(cfg, str(GOLDEN / "exampleIndex"), str(src),
                           None, None, content, freqs, limbs, taxids, hk,
                           rows, torch.device("cpu"))


def test_folder_falls_back_per_file(tmp_path, monkeypatch, jax_classic):
    """A folder under KASA_TPU_NO_TURBO: the packed multi-file path needs
    the turbo structure, so both packages run each file on its own
    (kasa_tpu pipeline.py:195-206) through the classic engine."""
    monkeypatch.setenv("KASA_TPU_NO_TURBO", "1")
    folder = str(FIXTURES / "multi")
    outs = {}
    for pkg in ("jax", "port"):
        d = tmp_path / pkg
        d.mkdir()
        if pkg == "jax":
            from kasa_tpu.config import Config
            from kasa_tpu.match.pipeline import identify
            cfg = Config()
            cfg.engine = "tpu"
            kw = {}
        else:
            from kasa_tpu_torch.config import Config
            from kasa_tpu_torch.match.pipeline import identify
            cfg = Config()
            kw = {"device": "cpu"}
        cfg.content_file = str(CONTENT)
        cfg.num_of_beasts = ALL_HITS
        res = identify(cfg, index_path=str(GOLDEN / "exampleIndex"),
                       input_path=folder, out_file=str(d / "q_"),
                       profile_file=str(d / "p_"), **kw)
        outs[pkg] = {n: (res[i], json.load(open(d / f"q_{n}.json")),
                         (d / f"p_{n}.csv").read_text())
                     for i, n in enumerate(("a", "b"))}
    from kasa_tpu_torch.match import fast
    assert type(fast.LAST_DISPATCH).__name__ == "StackedTables"
    for n in ("a", "b"):
        _agree(outs["jax"][n], outs["port"][n], 6)
