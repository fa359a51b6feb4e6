"""kasa_tpu_torch's index build against kasa_tpu's on the CPU: K13's
plain version (sort_dedup_plain) against kasa_tpu's sort_dedup_device on
both of its routes, and build_index's artifact family byte for byte
against kasa_tpu's and the reference binary's goldens at highestK 12 and
25, for protein, sloppy (-j), -g, a custom codon table (-a), the spill
path and --continue."""

import filecmp
import pathlib

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "golden"
FIXTURES = REPO / "fixtures"
CONTENT = str(GOLDEN / "exampleIndex_content.txt")
ARTIFACTS = ("", "_info.txt", "_trie", "_trie.txt", "_f.txt")


def _rows(L, n, seed):
    """Seeded (n, L) 30-bit limbs with many exact duplicates and rows
    equal in all limbs but one, and taxids at and above 2^31."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 1 << 30, size=(n // 4, L), dtype=np.int32)
    limbs = base[rng.integers(0, len(base), n)].copy()
    limbs[rng.random(n) < 0.1, L - 1] ^= 1
    limbs[rng.random(n) < 0.05, 0] = 0
    tax = rng.choice(np.array([1, 7, 2**31 - 1, 2**31, 2**31 + 5,
                               2**32 - 2, 2**32 - 1], np.uint64), n)
    return limbs, tax.astype(np.uint32)


@pytest.mark.parametrize("device_sort", [False, True],
                         ids=["host", "lax_sort"])
@pytest.mark.parametrize("L", [2, 5])
def test_sort_dedup_plain_matches_jax(monkeypatch, L, device_sort):
    """kasa_tpu's sort_dedup_device, by its host lexsort and by its
    device lax.sort (KASA_BUILD_DEVICE_SORT), against the port's K13
    plain version: the same rows, bit for bit."""
    from kasa_tpu.index.build import sort_dedup_device as jsd
    from kasa_tpu_torch.index.build import sort_dedup_device
    if device_sort:
        monkeypatch.setenv("KASA_BUILD_DEVICE_SORT", "1")
    else:
        monkeypatch.delenv("KASA_BUILD_DEVICE_SORT", raising=False)
    limbs, tax = _rows(L, 5000, 40 + L)
    jl, jt = jsd(limbs, tax)
    pl, pt = sort_dedup_device(limbs, tax, "cpu")
    assert pt.dtype == np.uint32 and len(pt) < len(tax)
    np.testing.assert_array_equal(pl, jl)
    np.testing.assert_array_equal(pt, jt)
    assert pt.max() >= 2**31


def test_sort_dedup_plain_empty_and_single():
    from kasa_tpu_torch.index.build import sort_dedup_plain
    for n in (0, 1):
        q = torch.zeros((n, 5), dtype=torch.int32)
        t = torch.full((n,), -1, dtype=torch.int32)
        a, b = sort_dedup_plain(q, t)
        assert a.shape == (n, 5) and b.shape == (n,)


def _build(pkg, out, **kw):
    if pkg == "jax":
        from kasa_tpu.index.build import build_index
    else:
        from kasa_tpu_torch.index.build import build_index
        kw["device"] = "cpu"
    fasta = kw.pop("fasta", str(FIXTURES / "example.fasta"))
    content = kw.pop("content", CONTENT)
    return build_index(fasta, content, str(out), **kw)


def _same(a, b, suffixes=ARTIFACTS):
    for s in suffixes:
        assert filecmp.cmp(f"{a}{s}", f"{b}{s}", shallow=False), \
            f"{a}{s} differs from {b}{s}"


def _alpha_encoder(pkg, tmp_path):
    from kasa_tpu_torch.synth import STANDARD_GC_PRT
    table = tmp_path / "gc.prt"
    table.write_text(STANDARD_GC_PRT)

    class Cfg:
        codon_table, codon_id = str(table), "1"
    if pkg == "jax":
        from kasa_tpu.core.encode import Encoder, custom_code_lut
        return Encoder(codon_code_lut=custom_code_lut(Cfg), device=False)
    from kasa_tpu_torch.core.encode import Encoder, custom_code_lut
    return Encoder(codon_code_lut=custom_code_lut(Cfg), device="cpu")


CASES = {
    "k12": ({}, "exampleIndex", ARTIFACTS),
    "k25": ({"highest_k": 25}, "exampleIndex128", ARTIFACTS),
    "protein": ({"protein": True, "fasta": str(FIXTURES / "protein.fasta"),
                 "content": str(GOLDEN / "protIndex_content.txt")},
                "protIndex", ARTIFACTS),
    "sloppy": ({"sloppy": True}, "exampleIndexSloppy",
               ("", "_taxOnly", "_info.txt", "_trie", "_trie.txt")),
    "g50": ({"shrink_percentage": 50.0}, None, ARTIFACTS),
    "one_frame": ({"one_frame": True}, None, ARTIFACTS),
    "six_k25": ({"six_frames": True, "highest_k": 25}, None, ARTIFACTS),
    "alpha": ({"alpha": True}, "alphaIndex", ARTIFACTS),
}


@pytest.mark.parametrize("case", list(CASES))
def test_build_matches_jax(tmp_path, case):
    """The artifact family of both packages' build_index, byte for byte,
    and the reference binary's where it made one."""
    kw, golden, suffixes = CASES[case]
    outs = []
    for pkg in ("jax", "port"):
        k = dict(kw, turbo_sidecar=False)
        if k.pop("alpha", False):
            k["encoder"] = _alpha_encoder(pkg, tmp_path)
        out = tmp_path / pkg
        limbs, tax = _build(pkg, out, **k)
        outs.append((out, limbs, tax))
    (jo, jl, jt), (to, tl, tt) = outs
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(tt, jt)
    assert len(tt) > 1000
    _same(jo, to, suffixes)
    if golden:
        _same(to, GOLDEN / golden, suffixes)
    if case == "sloppy":
        assert not pathlib.Path(f"{to}_f.txt").exists()


@pytest.mark.parametrize("highest_k", [12, 25])
def test_build_spill_path(tmp_path, highest_k):
    """A soft limit of 10,000 entries: every run is sorted (K13's plain
    version at highestK 25) and spilled, then merged on the host; the
    artifacts equal the one-pass build's golden."""
    golden = "exampleIndex" if highest_k == 12 else "exampleIndex128"
    _build("port", tmp_path / "spill", highest_k=highest_k,
           soft_limit=10000, temp_dir=str(tmp_path))
    _same(tmp_path / "spill", GOLDEN / golden)
    assert not list(tmp_path.glob("kasa_tpu_c0_run_*.npz"))


@pytest.mark.parametrize("highest_k", [12, 25])
def test_build_continue_from_spills(tmp_path, monkeypatch, highest_k):
    """--continue: a build that spilled its runs and stopped before the
    merge is resumed from them (main.cpp:329-331; Read.hpp:3102-3110);
    runs of another call index in the same directory are not adopted."""
    from kasa_tpu_torch.index import build as B
    golden = "exampleIndex" if highest_k == 12 else "exampleIndex128"
    spill_dir = tmp_path / "spills"
    spill_dir.mkdir()

    def stop(self):
        self._spill()
        raise KeyboardInterrupt
    monkeypatch.setattr(B.KmerAccumulator, "finalize", stop)
    with pytest.raises(KeyboardInterrupt):
        _build("port", tmp_path / "dead", highest_k=highest_k,
               soft_limit=10000, temp_dir=str(spill_dir), call_idx=3)
    monkeypatch.undo()
    assert len(list(spill_dir.glob("kasa_tpu_c3_run_*.npz"))) > 1
    with pytest.raises(RuntimeError, match="no temporary runs"):
        _build("port", tmp_path / "other", highest_k=highest_k,
               temp_dir=str(spill_dir), continue_build=True, call_idx=4)
    _build("port", tmp_path / "resumed", highest_k=highest_k,
           temp_dir=str(spill_dir), continue_build=True, call_idx=3)
    _same(tmp_path / "resumed", GOLDEN / golden)


def test_build_writes_the_turbo_sidecar(tmp_path):
    """build's turbo sidecar (the identify tables of k 7..12) is the one
    identify builds for the same index: identify reads it."""
    from kasa_tpu_torch.config import Config
    from kasa_tpu_torch.match import turbo
    from kasa_tpu_torch.match.pipeline import identify
    out = tmp_path / "ex"
    _build("port", out, turbo_sidecar=True)
    assert (tmp_path / "ex.turbo_7_12.npz.tabs" / "meta.json").exists()
    turbo._TT_RAM_CACHE.clear()
    cfg = Config()
    cfg.content_file = CONTENT
    identify(cfg, index_path=str(out),
             input_path=str(FIXTURES / "reads.fastq"),
             out_file=str(tmp_path / "o.json"),
             profile_file=str(tmp_path / "p.csv"), device="cpu")
    turbo._TT_RAM_CACHE.clear()
    identify(cfg, index_path=str(GOLDEN / "exampleIndex"),
             input_path=str(FIXTURES / "reads.fastq"),
             out_file=str(tmp_path / "g.json"),
             profile_file=str(tmp_path / "g.csv"), device="cpu")
    assert filecmp.cmp(tmp_path / "o.json", tmp_path / "g.json",
                       shallow=False)
    assert filecmp.cmp(tmp_path / "p.csv", tmp_path / "g.csv",
                       shallow=False)


def test_build_cli_needs_cuda_or_cpu(tmp_path, monkeypatch):
    """build without --device asks for the card: on a host without CUDA
    it fails before it writes anything; with --device cpu it writes the
    golden family."""
    from kasa_tpu_torch.cli import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ["kasa_tpu_torch", "build", "-i", str(FIXTURES / "example.fasta"),
            "-c", CONTENT, "-d", str(tmp_path / "c"), "--kH", "25"]
    assert main(args) == 1
    assert not (tmp_path / "c").exists()
    assert main(args + ["--device", "cpu"]) == 0
    _same(tmp_path / "c", GOLDEN / "exampleIndex128")


@pytest.mark.parametrize("flag", ["--sidecar", "--no-sidecar"])
def test_build_cli_sidecar_flag(tmp_path, flag):
    """build writes the turbo sidecar unless --no-sidecar says not to."""
    from kasa_tpu_torch.cli import main
    out = tmp_path / "ex"
    assert main(["kasa_tpu_torch", "build", "-i",
                 str(FIXTURES / "example.fasta"), "-c", CONTENT, "-d",
                 str(out), flag, "--device", "cpu"]) == 0
    _same(out, GOLDEN / "exampleIndex")
    tabs = tmp_path / "ex.turbo_7_12.npz.tabs"
    assert tabs.exists() == (flag == "--sidecar")
