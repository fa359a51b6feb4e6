"""Long read lines on the turbo path against kasa_tpu on the CPU: reads
whose slots per read (SW = windows x k levels, over every line of the
read) exceed the 4,096 that K3's shared-memory arm sorts, and -e on reads
of more than the 4,096 windows that K5's shared-memory arm sorts.  On the
card those batches take the long arms of K3 and K5 (tests/
test_torch_kernels.py holds them to their plain versions); here the
plain versions run, end to end through identify, and so does the classic
engine's fused -e above 4,096 windows.

The contract (ROADMAP.md): read fields and hit taxa identical, k-mer
scores within rtol 2e-5 / atol 1e-4, the profile's unique counts
identical and its floats within the same tolerance."""

import json
import pathlib
import shutil

import numpy as np
import pytest
import torch

from test_torch_classic_identify import (K128, _agree, _jax_per_batch,
                                         _run, jax_classic)  # noqa: F401
from test_torch_identify import assert_identify_agrees
from test_torch_tables import drop_sidecars  # noqa: F401

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "golden"
FIXTURES = REPO / "fixtures"


def genome_reads(path, lens, seed, names=None):
    """Reads cut from the genomes of fixtures/example.fasta (1 %
    substitutions), one per length in `lens`, written as fasta."""
    from kasa_tpu_torch.host.fastx import iter_records
    seqs = [r.seq for r in iter_records(str(FIXTURES / "example.fasta"))]
    rng = np.random.default_rng(seed)
    out = []
    for i, n in enumerate(lens):
        s = seqs[i % len(seqs)]
        n = min(n, len(s))
        o = int(rng.integers(0, len(s) - n + 1))
        b = np.frombuffer(s[o:o + n].encode(), np.uint8).copy()
        sub = rng.random(n) < 0.01
        b[sub] = np.frombuffer(b"ACGT", np.uint8)[
            rng.integers(0, 4, int(sub.sum()))]
        name = names[i] if names else f"long{i}"
        out.append(f">{name}\n{b.tobytes().decode()}\n")
    pathlib.Path(path).write_text("".join(out))
    return str(path)


@pytest.fixture(scope="module")
def index_dir(tmp_path_factory):
    """A private copy of exampleIndex: both packages write their table
    sidecar next to the index."""
    d = tmp_path_factory.mktemp("torch_long_index")
    for suffix in ("", "_f.txt", "_info.txt", "_trie", "_trie.txt",
                   "_content.txt"):
        shutil.copy(GOLDEN / f"exampleIndex{suffix}", d)
    return d


def _both(d, src, ov, tmp_path, pair=None):
    """kasa_tpu's turbo run and the port's (device="cpu") on the same
    input; -> (jax json, port json, jax profile, port profile)."""
    from kasa_tpu.config import Config as JC
    from kasa_tpu.match.pipeline import identify as jid
    from kasa_tpu_torch.config import Config as TC
    from kasa_tpu_torch.match.pipeline import identify as tid
    outs = []
    for tag, cfg, ident, kw in (("j", JC(), jid, {}),
                                ("t", TC(), tid, {"device": "cpu"})):
        cfg.content_file = str(d / "exampleIndex_content.txt")
        if tag == "j":
            cfg.engine = "tpu"
        if pair:
            cfg.paired_end_1, cfg.paired_end_2 = pair
        for k, v in ov.items():
            setattr(cfg, k, v)
        res = ident(cfg, index_path=str(d / "exampleIndex"),
                    input_path=src, out_file=str(tmp_path / f"{tag}.json"),
                    profile_file=str(tmp_path / f"{tag}.csv"), **kw)
        outs.append(res)
    assert outs[0][2:] == outs[1][2:] and outs[1][2] > 0
    return (json.load(open(tmp_path / "j.json")),
            json.load(open(tmp_path / "t.json")),
            (tmp_path / "j.csv").read_text(),
            (tmp_path / "t.csv").read_text())


def test_long_pairs_unique_under_six(tmp_path, monkeypatch, index_dir):
    """2 x 1,100 bp pairs under --six -e: 4 lines x 1,085 windows = 4,340
    windows per read (K5's long arm) and 26,040 slots (K3's).  The 2 x
    250 bp pairs of the same flags without -e are
    tests/test_torch_flags.py's."""
    monkeypatch.setenv("KASA_MESH_DP", "1")
    names = [f"p{i}" for i in range(4)]
    pair = [genome_reads(tmp_path / f"m{m}.fasta", [1100] * 4, 1100 + m,
                         names) for m in (1, 2)]
    jj, tj, jp, tp = _both(index_dir, "", {"six_frames": True,
                                           "unique": True}, tmp_path, pair)
    assert any(r["Top hits"] for r in tj)
    assert_identify_agrees(jj, tj, jp, tp, 6)


def test_multi_folder_under_six(tmp_path, monkeypatch, index_dir):
    """fixtures/multi under --six (b.fasta's read of 762 windows: 9,144
    slots): each file's outputs against kasa_tpu's per-file run."""
    monkeypatch.setenv("KASA_MESH_DP", "1")
    from kasa_tpu.config import Config as JC
    from kasa_tpu.match.pipeline import identify as jid
    from kasa_tpu_torch.config import Config as TC
    from kasa_tpu_torch.match.pipeline import identify as tid
    for tag, cfg, ident, kw in (("j", JC(), jid, {}),
                                ("t", TC(), tid, {"device": "cpu"})):
        cfg.content_file = str(index_dir / "exampleIndex_content.txt")
        cfg.six_frames = True
        if tag == "j":
            cfg.engine = "tpu"
        ident(cfg, index_path=str(index_dir / "exampleIndex"),
              input_path=str(FIXTURES / "multi"),
              out_file=str(tmp_path / f"{tag}q_"),
              profile_file=str(tmp_path / f"{tag}p_"), **kw)
    for name in ("a", "b"):
        assert_identify_agrees(
            json.load(open(tmp_path / f"jq_{name}.json")),
            json.load(open(tmp_path / f"tq_{name}.json")),
            (tmp_path / f"jp_{name}.csv").read_text(),
            (tmp_path / f"tp_{name}.csv").read_text(), 6)


@pytest.mark.parametrize("unique", [False, True], ids=["default", "e"])
def test_long_single_end_reads(tmp_path, monkeypatch, index_dir, unique):
    """Single-end reads of 1-4.6 kbp in one batch (every row padded to the
    longest: 4,577 windows, 27,462 slots per read), with and without -e
    (K5 above 4,096 windows)."""
    from kasa_tpu_torch.utils import timers
    monkeypatch.setenv("KASA_MESH_DP", "1")
    src = genome_reads(tmp_path / "long.fasta",
                       [1000, 2400, 4600, 1700, 3100, 150], 11)
    timers.reset()
    jj, tj, jp, tp = _both(index_dir, src, {"unique": unique}, tmp_path)
    assert sum(len(r["Top hits"]) for r in tj) >= 5
    # the batch's budgets and lists scale with its slots: no read goes to
    # the host recompute
    assert (timers.counter("recompute.reads"), timers.counter("reads")) \
        == (0, 6)
    assert_identify_agrees(jj, tj, jp, tp, 6)


def test_classic_unique_above_dedup_cap(tmp_path, monkeypatch, jax_classic):
    """-e on the classic path (exampleIndex128 at -k 25 12) with reads of
    more than 4,096 windows: the port's fused classic path dedups them
    through K5 (its long arm on the card) and classifies them in one
    batch; kasa_tpu's per-batch engine on the same reads (its fused
    classic branch ignores -e) dedups on the host."""
    from kasa_tpu_torch.match import fast
    src = genome_reads(tmp_path / "long.fasta", [4300, 900, 4500], 5)
    routes = []
    orig = fast._fast_identify_classic

    def spy(*a, **k):
        out = orig(*a, **k)
        routes.append("fused")
        return out
    monkeypatch.setattr(fast, "_fast_identify_classic", spy)
    ov = dict(K128, unique=True)
    got = _run("port", "exampleIndex128", src, ov, tmp_path / "t")
    assert routes == ["fused"]
    assert type(fast.LAST_DISPATCH).__name__ == "StackedTables"
    _jax_per_batch(monkeypatch)
    ref = _run("jax", "exampleIndex128", src, ov, tmp_path / "j")
    _agree(ref, got, 14)


def test_long_reads_on_the_tiered_path(tmp_path, monkeypatch, index_dir):
    """The tiered path's batch tail keeps every run (cw = SW, K3's
    additive arm): with long reads that is the long arm at cw > 4,096.
    The port's tiered run at a 100 kB device budget against kasa_tpu's
    tiered run at the same budget (its chunk pass one window per pass, as
    tests/test_torch_tiered.py runs it; on the 8 devices of
    tests/conftest.py kasa_tpu shards instead while its tables fit 8 times
    the budget) and against the port's resident
    run of the same reads, every hit written."""
    import kasa_tpu.match.fast as JF
    from test_torch_tiered import _agree_tiered, _identify
    from kasa_tpu_torch.match import fast
    from kasa_tpu_torch.match.tiered import TieredTurboDispatch
    src = genome_reads(tmp_path / "long.fasta", [1000, 2400, 900, 150], 13)
    idx = index_dir / "exampleIndex"
    resident = _identify("port", idx, src, tmp_path / "r", {})
    monkeypatch.setenv("KASA_DEVICE_BUDGET", "100000")
    monkeypatch.setenv("KASA_MESH_DP", "1")
    monkeypatch.setenv("KASA_MESH_IP", "1")
    jax_tiered = _identify("jax", idx, src, tmp_path / "j", {})
    assert type(JF.LAST_DISPATCH).__name__ == "TieredTurboDispatch"
    tiered = _identify("port", idx, src, tmp_path / "t", {})
    assert isinstance(fast.LAST_DISPATCH, TieredTurboDispatch)
    assert resident[0][1].sum() > 0
    _agree_tiered(jax_tiered, tiered)
    _agree_tiered(resident, tiered)
