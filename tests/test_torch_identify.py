"""kasa_tpu_torch identify end to end against kasa_tpu's turbo engine,
the flags outside this slice, and the port's isolation from JAX.

End to end: the port's identify(device="cpu") (plain versions of the
kernels) and kasa_tpu's identify(engine="tpu") on the golden index must
agree: the same hit taxa per read, k-mer scores within rtol 2e-5 /
atol 1e-4, and identical unique-count columns in the profile."""

import ast
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "golden"
FIXTURES = REPO / "fixtures"
INDEX_FILES = ("exampleIndex", "exampleIndex_info.txt", "exampleIndex_f.txt",
               "exampleIndex_content.txt", "exampleIndex_trie",
               "exampleIndex_trie.txt")


@pytest.fixture(scope="module")
def index_dir(tmp_path_factory):
    """A private copy of the golden index family: both packages write
    their table sidecar next to the index."""
    d = tmp_path_factory.mktemp("torch_index")
    for f in INDEX_FILES:
        shutil.copy(GOLDEN / f, d / f)
    return d


def _run_jax(d, inp, overrides, out, prof):
    from kasa_tpu.config import Config
    from kasa_tpu.match.pipeline import identify
    cfg = Config()
    cfg.content_file = str(d / "exampleIndex_content.txt")
    for k, v in overrides.items():
        setattr(cfg, k, v)
    cfg.engine = overrides.get("engine", "tpu")
    identify(cfg, index_path=str(d / "exampleIndex"), input_path=inp,
             out_file=str(out), profile_file=str(prof))


def _run_port(d, inp, overrides, out, prof):
    from kasa_tpu_torch.config import Config
    from kasa_tpu_torch.match.pipeline import identify
    cfg = Config()
    cfg.content_file = str(d / "exampleIndex_content.txt")
    for k, v in overrides.items():
        setattr(cfg, k, v)
    return identify(cfg, index_path=str(d / "exampleIndex"),
                    input_path=inp, out_file=str(out),
                    profile_file=str(prof), device="cpu")


def assert_identify_agrees(ref_json, got_json, ref_prof, got_prof,
                           num_k):
    """The port's contract on identify outputs (json + profile CSV)."""
    assert len(ref_json) == len(got_json)
    for er, tr in zip(ref_json, got_json):
        for field in ("Read number", "Specifier from input file", "Length"):
            assert er[field] == tr[field]
        eh = {h["tax ID"]: h for h in er["Top hits"] + er["Further hits"]}
        th = {h["tax ID"]: h for h in tr["Top hits"] + tr["Further hits"]}
        assert set(eh) == set(th), f"read {er['Read number']}: hit taxa"
        for tid, h in eh.items():
            np.testing.assert_allclose(float(h["k-mer Score"]),
                                       float(th[tid]["k-mer Score"]),
                                       rtol=2e-5, atol=1e-4)
    el, tl = ref_prof.splitlines(), got_prof.splitlines()
    assert len(el) == len(tl) and el[0] == tl[0]
    for e, t in zip(el[1:], tl[1:]):
        ec, tc = e.split(","), t.split(",")
        assert ec[:2 + num_k] == tc[:2 + num_k]     # taxon + unique counts
        np.testing.assert_allclose(np.array(tc[2 + num_k:], float),
                                   np.array(ec[2 + num_k:], float),
                                   rtol=2e-5, atol=1e-4)


@pytest.mark.parametrize("tag,inp,overrides", [
    ("default", "reads.fastq", {}),
    ("edge", "edge.fasta", {}),
    ("fasta", "reads.fasta", {}),
    ("gz", "reads.fastq.gz", {}),
    ("k910", "reads.fastq", {"lower_k": 9, "higher_k": 10}),
], ids=["default", "edge", "fasta", "gz", "k910"])
def test_identify_agrees_with_jax_turbo(tmp_path, monkeypatch, index_dir,
                                        tag, inp, overrides):
    # kasa_tpu's single-device turbo strategy is the port's counterpart
    # (the 8 host devices of tests/conftest.py would select its mesh)
    monkeypatch.setenv("KASA_MESH_DP", "1")
    src = str(FIXTURES / inp)
    _run_jax(index_dir, src, overrides, tmp_path / "j.json",
             tmp_path / "j.csv")
    ca, cu, nreads, nk = _run_port(index_dir, src, overrides,
                                   tmp_path / "t.json", tmp_path / "t.csv")
    assert nreads > 0 and nk > 0 and cu.sum() > 0
    num_k = overrides.get("higher_k", 12) - overrides.get("lower_k", 7) + 1
    assert_identify_agrees(json.load(open(tmp_path / "j.json")),
                           json.load(open(tmp_path / "t.json")),
                           (tmp_path / "j.csv").read_text(),
                           (tmp_path / "t.csv").read_text(), num_k)


def _tokens(line):
    return [t for t in re.split(rb'[\t;, :{}"\[\]]+', line) if t]


@pytest.mark.parametrize("fmt", ["jsonl", "tsv", "kraken"])
def test_output_formats_match_jax_turbo(tmp_path, monkeypatch, index_dir,
                                        fmt):
    """The native writer formats the same hit lists: line by line, the
    kraken/tsv/jsonl text has the same tokens, numbers within the
    contract's tolerance."""
    monkeypatch.setenv("KASA_MESH_DP", "1")
    src = str(FIXTURES / "reads.fastq")
    ov = {"output_format": fmt}
    _run_jax(index_dir, src, ov, tmp_path / "j.out", tmp_path / "j.csv")
    _run_port(index_dir, src, ov, tmp_path / "t.out", tmp_path / "t.csv")
    jl = (tmp_path / "j.out").read_bytes().splitlines()
    tl = (tmp_path / "t.out").read_bytes().splitlines()
    assert len(jl) == len(tl) > 100
    for a, b in zip(jl, tl):
        ta, tb = _tokens(a), _tokens(b)
        assert len(ta) == len(tb), (a, b)
        for x, y in zip(ta, tb):
            try:
                fx, fy = float(x), float(y)
            except ValueError:
                assert x == y, (a, b)
                continue
            np.testing.assert_allclose(fy, fx, rtol=2e-5, atol=1e-4)


def test_visualize_agrees_with_jax(tmp_path, capsys, index_dir):
    """--visualize on the first 5 reads of reads.fastq (the print grows
    with the square of the input: all of it is 1.2 GB), on the default
    engine (the per-batch engine) and on the join engine: the printed
    frames, matches and scores are identical (host code over the same
    windows), the per-read output and profile agree under the contract."""
    src = tmp_path / "five.fastq"
    src.write_text("".join(open(FIXTURES / "reads.fastq").readlines()[:20]))
    for engine in ("tpu", "join"):
        ov = {"visualize": True, "engine": engine}
        capsys.readouterr()
        _run_jax(index_dir, str(src), ov, tmp_path / "j.json",
                 tmp_path / "j.csv")
        want = capsys.readouterr().out
        _run_port(index_dir, str(src), ov, tmp_path / "t.json",
                  tmp_path / "t.csv")
        got = capsys.readouterr().out
        assert got == want and got.count("Scores: ") > 0
        assert_identify_agrees(json.load(open(tmp_path / "j.json")),
                               json.load(open(tmp_path / "t.json")),
                               (tmp_path / "j.csv").read_text(),
                               (tmp_path / "t.csv").read_text(), 6)


def _over_budget_agree(tmp_path, index_dir, ov, capsys):
    """kasa_tpu's run and the port's of reads.fastq under `ov` with a
    1 MiB memory budget: both stream index chunks through the per-batch
    engine (the same OUT: line), and the outputs agree under the
    contract."""
    src = str(FIXTURES / "reads.fastq") if "paired_end_1" not in ov else ""
    ov = dict(ov, memory_avail=1 << 20)
    capsys.readouterr()
    _run_jax(index_dir, src, ov, tmp_path / "j.json", tmp_path / "j.csv")
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if "streaming" in ln]
    res = _run_port(index_dir, src, ov, tmp_path / "t.json",
                    tmp_path / "t.csv")
    assert line and line[0] in capsys.readouterr().out.splitlines()
    from kasa_tpu_torch.match import fast, oocore
    assert isinstance(fast.LAST_DISPATCH, oocore.TieredIndex)
    assert res[2] > 0
    assert_identify_agrees(json.load(open(tmp_path / "j.json")),
                           json.load(open(tmp_path / "t.json")),
                           (tmp_path / "j.csv").read_text(),
                           (tmp_path / "t.csv").read_text(), 6)


def test_sloppy_over_memory_budget_agrees_with_jax(tmp_path, index_dir,
                                                   capsys):
    """-j over the memory budget (-m): the per-batch engine streams index
    chunks (oocore, K9 per chunk) in both packages."""
    _over_budget_agree(tmp_path, index_dir, {"sloppy": True}, capsys)


def test_paired_no_turbo_over_memory_budget_agrees_with_jax(
        tmp_path, monkeypatch, index_dir, capsys):
    """Paired-end input on the classic path (KASA_TPU_NO_TURBO) over the
    memory budget: the per-batch engine's chunk streaming in both
    packages (kasa_tpu routed there as its FastPathUnavailable does)."""
    import kasa_tpu.match.fast as jf

    def unavailable(*a, **k):
        raise jf.FastPathUnavailable("per-batch engine")
    monkeypatch.setattr(jf, "fast_identify", unavailable)
    monkeypatch.setenv("KASA_TPU_NO_TURBO", "1")
    _over_budget_agree(tmp_path, index_dir, {
        "paired_end_1": str(FIXTURES / "reads_1.fastq"),
        "paired_end_2": str(FIXTURES / "reads_2.fastq")}, capsys)


@pytest.mark.parametrize("case", ["k25_20", "k10_5"])
def test_over_budget_keeps_resident_tables(tmp_path, monkeypatch, index_dir,
                                           case):
    """An index over the device budget that tiered streaming cannot take
    (128-bit, or min_k < 6) keeps resident turbo tables on one device,
    as kasa_tpu does (fast.py:342-351, 375-404): under
    KASA_DEVICE_BUDGET=1 the port writes kasa_tpu's output, the profile
    byte-identical."""
    from kasa_tpu_torch.match import fast
    monkeypatch.setenv("KASA_DEVICE_BUDGET", "1")
    monkeypatch.setenv("KASA_MESH_DP", "1")
    if case == "k25_20":
        # the 128-bit family under the name the helpers read
        d = tmp_path / "idx128"
        d.mkdir()
        for suffix in ("", "_info.txt", "_f.txt", "_trie", "_trie.txt"):
            shutil.copy(GOLDEN / ("exampleIndex128" + suffix),
                        d / ("exampleIndex" + suffix))
        shutil.copy(index_dir / "exampleIndex_content.txt",
                    d / "exampleIndex_content.txt")
        ov = {"lower_k": 20, "higher_k": 25}
    else:
        d, ov = index_dir, {"lower_k": 5, "higher_k": 10}
    # every hit written: tied scores may come out in another order
    ov["num_of_beasts"] = 1000
    src = str(FIXTURES / "reads.fastq")
    _run_jax(d, src, ov, tmp_path / "j.json", tmp_path / "j.csv")
    res = _run_port(d, src, ov, tmp_path / "t.json", tmp_path / "t.csv")
    assert type(fast.LAST_DISPATCH).__name__ == "SingleTurboDispatch"
    assert res[2] == 300
    assert (tmp_path / "t.csv").read_bytes() == \
        (tmp_path / "j.csv").read_bytes()
    assert_identify_agrees(json.load(open(tmp_path / "j.json")),
                           json.load(open(tmp_path / "t.json")),
                           (tmp_path / "j.csv").read_text(),
                           (tmp_path / "t.csv").read_text(), 6)


def test_many_line_lengths_stay_under_the_slot_cap(tmp_path, monkeypatch,
                                                   index_dir):
    """Ten batches of one read each, ten distinct padded lengths, the
    last read 600 bp (624 padded, 589 windows x 6 = 3534 slots, under
    the 4096 cap): every batch keeps its own 16-multiple length, and the
    output equals that of one batch over the same reads."""
    from kasa_tpu_torch.match import fast
    from kasa_tpu_torch.match.turbo import SW_CAP
    rng = np.random.default_rng(7)
    lens = [40 * i for i in range(1, 10)] + [600]
    src = tmp_path / "lens.fasta"
    src.write_text("".join(
        f">r{i}\n{''.join(rng.choice(list('ACGT'), size=n))}\n"
        for i, n in enumerate(lens)))
    assert all(fast._len_bucket(n + 15, 36) % 16 == 0 for n in lens)
    assert (fast._len_bucket(615, 36) - 35) * 6 <= SW_CAP
    one = _run_port(index_dir, str(src), {}, tmp_path / "a.json",
                    tmp_path / "a.csv")
    monkeypatch.setattr(fast, "READS_PER_BATCH", 1)
    each = _run_port(index_dir, str(src), {}, tmp_path / "b.json",
                     tmp_path / "b.csv")
    assert one[2] == each[2] == len(lens) and one[3] == each[3]
    assert_identify_agrees(json.load(open(tmp_path / "a.json")),
                           json.load(open(tmp_path / "b.json")),
                           (tmp_path / "a.csv").read_text(),
                           (tmp_path / "b.csv").read_text(), 6)


def test_cli_identify_and_other_modes(tmp_path, index_dir):
    from kasa_tpu_torch.cli import main
    d = index_dir
    rc = main(["kasa_tpu_torch", "identify", "-d", str(d / "exampleIndex"),
               "-c", str(d / "exampleIndex_content.txt"),
               "-i", str(FIXTURES / "reads.fastq"),
               "-q", str(tmp_path / "o.json"), "-p", str(tmp_path / "p.csv"),
               "--device", "cpu"])
    assert rc == 0 and len(json.load(open(tmp_path / "o.json"))) > 0
    rc = main(["kasa_tpu_torch", "identify_multiple",
               "-d", str(d / "exampleIndex"),
               "-c", str(d / "exampleIndex_content.txt"),
               "-i", str(FIXTURES / "multi"), "-q", str(tmp_path / "m_"),
               "-p", str(tmp_path / "mp_"), "--one", "-e", "--device", "cpu"])
    assert rc == 0 and len(json.load(open(tmp_path / "m_b.json"))) == 3
    assert main(["kasa_tpu_torch", "build", "-i", "x", "-d", "y"]) == 1


def test_default_device_without_cuda_raises():
    from kasa_tpu_torch import resolve_device
    from kasa_tpu_torch.config import Config
    from kasa_tpu_torch.match.pipeline import identify
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        identify(Config(), index_path=str(GOLDEN / "exampleIndex"),
                 input_path=str(FIXTURES / "reads.fastq"))
    assert resolve_device("cpu").type == "cpu"


def _imports(path):
    tree = ast.parse(pathlib.Path(path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_kasa_tpu():
    files = sorted((REPO / "kasa_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "kasa_tpu"), (f, mod)


def test_port_runs_with_jax_blocked(tmp_path, index_dir):
    """A fresh interpreter in which importing jax or kasa_tpu fails runs
    the golden identify on the CPU."""
    code = f"""
import sys
sys.modules['jax'] = None
sys.modules['kasa_tpu'] = None
import torch
torch.set_num_threads(2)
from kasa_tpu_torch.config import Config
from kasa_tpu_torch.match.pipeline import identify
cfg = Config()
cfg.content_file = {str(index_dir / 'exampleIndex_content.txt')!r}
out = identify(cfg, index_path={str(index_dir / 'exampleIndex')!r},
               input_path={str(FIXTURES / 'reads.fastq')!r},
               out_file={str(tmp_path / 'o.json')!r}, device='cpu')
assert out[2] > 0
assert not any(m.startswith('jax') and sys.modules[m] is not None
               for m in sys.modules)
print('PORT-OK')
"""
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    r = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "PORT-OK" in r.stdout
