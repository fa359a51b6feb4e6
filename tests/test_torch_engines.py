"""The exact engine, --visualize and the per-batch engine's chunk
streaming (oocore) of kasa_tpu_torch, on the CPU.

  - --engine exact: byte-identical to the reference binary's goldens on
    the cases of tests/test_identify_parity.py (the port encodes with
    K1's plain version where kasa_tpu encodes on the host: the windows
    are identical), and through the 128-bit walk on exampleIndex128
    byte-identical to kasa_tpu's run;
  - --visualize: byte-identical to tests/golden/visualize_one_read.txt;
  - oocore, mirroring kasa_tpu's tests/test_oocore.py: the chunk plan
    equal to kasa_tpu's, chunked classify (K9's plain version per chunk)
    equal to the resident engine, identify under a memory budget equal
    to the resident run."""

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


def _identify(over, inp, out_file, profile_file, index="exampleIndex"):
    from kasa_tpu_torch.config import Config
    from kasa_tpu_torch.match.pipeline import identify
    cfg = Config()
    cfg.content_file = str(CONTENT)
    for k, v in over.items():
        setattr(cfg, k, v)
    return identify(cfg, index_path=str(GOLDEN / index), input_path=inp,
                    out_file=str(out_file),
                    profile_file=str(profile_file) if profile_file else None,
                    device="cpu")


EXACT_CASES = [
    # tag, input, golden out, golden profile, overrides
    ("default", "reads.fastq", "reads_identify.json", "reads_profile.csv", {}),
    ("tsv", "reads.fastq", "reads_identify.tsv", "reads_profile_tsv.csv",
     {"output_format": "tsv"}),
    ("jsonl", "reads.fastq", "reads_identify.jsonl", None,
     {"output_format": "jsonl"}),
    ("kraken", "reads.fastq", "reads_identify.ktsv", None,
     {"output_format": "kraken"}),
    ("k12", "reads.fastq", "reads_k12.json", "reads_k12_profile.csv",
     {"lower_k": 12, "higher_k": 12}),
    ("six", "reads.fastq", "reads_six.json", "reads_six_profile.csv",
     {"six_frames": True}),
    ("one", "reads.fastq", "reads_one.json", "reads_one_profile.csv",
     {"one_frame": True}),
    ("unique", "reads.fastq", "reads_unique.json", "reads_unique_profile.csv",
     {"unique": True}),
    ("fasta", "reads.fasta", "reads_fasta.json", "reads_fasta_profile.csv", {}),
    # the golden reads_gz.json is empty: the same reads as reads.fastq
    ("gz", "reads.fastq.gz", "reads_identify.json", None, {}),
    ("edge", "edge.fasta", "edge.json", "edge_profile.csv", {}),
    ("coverage", "reads.fastq", "reads_cov.json", "reads_cov_profile.csv",
     {"coverage": True}),
    ("paired", "", "reads_paired.json", "reads_paired_profile.csv",
     {"paired_end_1": str(FIXTURES / "reads_1.fastq"),
      "paired_end_2": str(FIXTURES / "reads_2.fastq")}),
]


@pytest.mark.parametrize("inp,out,prof,over", [c[1:] for c in EXACT_CASES],
                         ids=[c[0] for c in EXACT_CASES])
def test_exact_engine_matches_golden(tmp_path, inp, out, prof, over):
    o = tmp_path / out
    p = tmp_path / prof if prof else None
    _identify(dict(over, engine="exact"), str(FIXTURES / inp) if inp else "",
              o, p)
    assert filecmp.cmp(o, GOLDEN / out, shallow=False)
    if prof:
        assert filecmp.cmp(p, GOLDEN / prof, shallow=False)


def test_exact_walk128_matches_jax(tmp_path):
    """A 128-bit index through the exact engine's walk (the reference's
    uint64-truncated comparator, match/walk128.py): per-read output and
    profile byte-identical to kasa_tpu's exact run."""
    from kasa_tpu.config import Config
    from kasa_tpu.match.pipeline import identify
    over = {"lower_k": 20, "higher_k": 25, "engine": "exact"}
    inp = str(FIXTURES / "reads.fastq")
    cfg = Config()
    cfg.content_file = str(CONTENT)
    for k, v in over.items():
        setattr(cfg, k, v)
    identify(cfg, index_path=str(GOLDEN / "exampleIndex128"), input_path=inp,
             out_file=str(tmp_path / "j.json"),
             profile_file=str(tmp_path / "j.csv"))
    _identify(over, inp, tmp_path / "t.json", tmp_path / "t.csv",
              index="exampleIndex128")
    assert filecmp.cmp(tmp_path / "t.json", tmp_path / "j.json",
                       shallow=False)
    assert filecmp.cmp(tmp_path / "t.csv", tmp_path / "j.csv", shallow=False)
    assert len(json.load(open(tmp_path / "t.json"))) == 300


def test_cli_engines(tmp_path, capsys):
    """--engine exact|join on the CLI: the exact engine's output and the
    join engine's --coverage profile byte-identical to the goldens; an
    engine kasa_tpu does not know is refused as kasa_tpu refuses it."""
    from kasa_tpu_torch.cli import main
    base = ["kasa_tpu_torch", "identify", "-d", str(GOLDEN / "exampleIndex"),
            "-c", str(CONTENT), "-i", str(FIXTURES / "reads.fastq"),
            "--device", "cpu"]
    assert main(base + ["--engine", "exact", "-q", str(tmp_path / "e.json"),
                        "-p", str(tmp_path / "e.csv")]) == 0
    assert filecmp.cmp(tmp_path / "e.json", GOLDEN / "reads_identify.json",
                       shallow=False)
    assert filecmp.cmp(tmp_path / "e.csv", GOLDEN / "reads_profile.csv",
                       shallow=False)
    assert main(base + ["--engine", "join", "--coverage",
                        "-q", str(tmp_path / "j.json"),
                        "-p", str(tmp_path / "j.csv")]) == 0
    assert filecmp.cmp(tmp_path / "j.csv", GOLDEN / "reads_cov_profile.csv",
                       shallow=False)
    assert main(base + ["--engine", "fast", "-q",
                        str(tmp_path / "x.json")]) == 1
    assert "--engine must be exact, tpu or join" in capsys.readouterr().err


def test_visualize_matches_golden(tmp_path, capsys):
    """--visualize: the frame strings, aligned matches and per-taxon
    scores byte-identical to the reference binary's print."""
    capsys.readouterr()
    _identify({"visualize": True}, str(FIXTURES / "one_read.fastq"),
              tmp_path / "v.json", None)
    assert capsys.readouterr().out == \
        (GOLDEN / "visualize_one_read.txt").read_text()


# ---------------------------------------------------------------------------
# oocore

def test_plan_chunks_equal_jax():
    from kasa_tpu.match.oocore import plan_chunks as jplan
    from kasa_tpu_torch.index import artifacts
    from kasa_tpu_torch.match.oocore import plan_chunks
    path = str(GOLDEN / "exampleIndex")
    _prefixes, counts = artifacts.read_trie(path)
    run_starts = set(np.cumsum([0] + [int(c) for c in counts]).tolist())
    n, _ = artifacts.read_info(path)
    for budget in (2000, 3000, 1 << 16):
        chunks = plan_chunks(path, budget)
        assert chunks == jplan(path, budget)
        assert chunks[0][0] == 0 and chunks[-1][1] == n
        assert all(a in run_starts and b in run_starts and a < b
                   for a, b in chunks)
    assert len(plan_chunks(path, 2000)) > 2


def test_chunked_classify_equals_resident(tmp_path):
    """K9's plain version per chunk of 3,000 entries, summed, against the
    resident engine over the whole index: integers identical, floats
    within the contract."""
    from kasa_tpu_torch.index import artifacts
    from kasa_tpu_torch.match.engine import TpuEngine
    from kasa_tpu_torch.match.oocore import TieredIndex
    from kasa_tpu_torch.match.pipeline import load_content_for_identify
    limbs, taxids, _, _ = artifacts.read_index(str(GOLDEN / "exampleIndex"))
    content = load_content_for_identify(str(CONTENT))
    S = content.num_species
    rng = np.random.default_rng(5)
    m = 4096
    q = limbs[rng.integers(0, len(limbs), size=m)].copy()
    miss = rng.random(m) < 0.3
    q[miss, 1] ^= (rng.integers(1, 31, size=int(miss.sum()))
                   .astype(np.int32) << 5)
    rid = rng.integers(0, 64, size=m).astype(np.int32)
    full = TpuEngine(limbs, taxids, content.tax_to_idx, 12, 7, 12, S,
                     "cpu").classify(q, rid, 64)
    tiered = TieredIndex(str(GOLDEN / "exampleIndex"), content.tax_to_idx,
                         7, 12, S, 3000, "cpu",
                         cache_dir=str(tmp_path / "cache"))
    assert len(tiered.chunks) > 3
    part = tiered.classify(q, rid, 64)
    assert part.counts_unique.sum() > 0
    np.testing.assert_array_equal(part.counts_unique, full.counts_unique)
    np.testing.assert_array_equal(part.scores > 0, full.scores > 0)
    np.testing.assert_allclose(part.counts_all, full.counts_all, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(part.scores, full.scores, rtol=RTOL,
                               atol=ATOL)
    # a second instance reads the cache the first wrote
    again = TieredIndex(str(GOLDEN / "exampleIndex"), content.tax_to_idx,
                        7, 12, S, 3000, "cpu",
                        cache_dir=str(tmp_path / "cache"))
    np.testing.assert_array_equal(again.classify(q, rid, 64).scores,
                                  part.scores)


def test_identify_under_memory_budget_equals_resident(tmp_path, capsys):
    """--coherence (the per-batch engine) under a memory budget below the
    tables streams index chunks (here the 2^16-entry floor makes one)
    and writes what the resident run writes, coherence values and all;
    the chunk cache lands in the -t directory."""
    from kasa_tpu_torch.match import fast, oocore
    over = {"post_process": True}
    inp = str(FIXTURES / "reads.fastq")
    _identify(over, inp, tmp_path / "r.json", tmp_path / "r.csv")
    _identify(dict(over, memory_avail=1 << 20, temp_path=str(tmp_path),
                   call_idx=7), inp, tmp_path / "t.json", tmp_path / "t.csv")
    assert "streaming 65536-entry chunks" in capsys.readouterr().out
    assert isinstance(fast.LAST_DISPATCH, oocore.TieredIndex)
    assert (tmp_path / "oocache_torch_7" / "chunk_00000.npz").exists()
    ref, got = (json.load(open(tmp_path / f)) for f in ("r.json", "t.json"))
    assert len(ref) == len(got) == 300
    for a, b in zip(ref, got):
        ha = {h["tax ID"]: h for h in a["Top hits"] + a["Further hits"]}
        hb = {h["tax ID"]: h for h in b["Top hits"] + b["Further hits"]}
        assert set(ha) == set(hb)
        for t, h in ha.items():
            assert hb[t]["Coherence"] == h["Coherence"]
            np.testing.assert_allclose(float(hb[t]["k-mer Score"]),
                                       float(h["k-mer Score"]), rtol=RTOL,
                                       atol=ATOL)
    rl, tl = ((tmp_path / f).read_text().splitlines()
              for f in ("r.csv", "t.csv"))
    assert [ln.split(",")[:8] for ln in rl] == [ln.split(",")[:8]
                                                for ln in tl]
