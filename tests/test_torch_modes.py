"""kasa_tpu_torch's CLI modes besides identify against kasa_tpu's and the
reference binary's goldens, on the CPU: generateCF, update, delete,
merge, shrink (three strategies), half and the auxiliary modes
(getFrequency, trie, redundancy, checkContentFile, translate, test,
howmuchtaxids, showVec, transform, fuckit), each through both packages'
`main` and compared byte for byte (files, or printed output).

generateCF and update read a taxonomy: the tests write a small one
(kasa_tpu_torch.synth.taxonomy_from_content) under which generateCF
gives back the golden content files, so no taxonomy is downloaded."""

import filecmp
import pathlib
import shutil

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "golden"
FIXTURES = REPO / "fixtures"
ARTIFACTS = ("", "_info.txt", "_trie", "_trie.txt", "_f.txt")


def _same(a, b, suffixes=ARTIFACTS):
    for s in suffixes:
        assert filecmp.cmp(f"{a}{s}", f"{b}{s}", shallow=False), \
            f"{a}{s} differs from {b}{s}"


def _main(pkg, *args):
    if pkg == "jax":
        from kasa_tpu.cli import main
    else:
        from kasa_tpu_torch.cli import main
    assert main([pkg, *map(str, args)]) == 0


def _both(tmp_path, *args, device=True):
    """The mode in both packages, each writing under its own directory
    (every `{out}` in args becomes it); -> (kasa_tpu's dir, the port's)."""
    dirs = []
    for pkg in ("jax", "port"):
        d = tmp_path / pkg
        d.mkdir(exist_ok=True)
        a = [str(x).replace("{out}", str(d)) for x in args]
        if pkg == "port" and device:
            a += ["--device", "cpu"]
        _main(pkg, *a)
        dirs.append(d)
    return dirs


@pytest.fixture(scope="module")
def taxonomy(tmp_path_factory):
    from kasa_tpu_torch.synth import taxonomy_from_content
    return pathlib.Path(taxonomy_from_content(
        str(GOLDEN / "exampleIndex_u_content.txt"),
        str(tmp_path_factory.mktemp("taxonomy"))))


@pytest.fixture
def index_copy(tmp_path):
    """A private copy of exampleIndex's family (modes that write next to
    the index)."""
    d = tmp_path / "idx"
    d.mkdir()
    for s in ARTIFACTS + ("_content.txt",):
        shutil.copy(f"{GOLDEN / 'exampleIndex'}{s}", f"{d / 'ex'}{s}")
    return d / "ex"


@pytest.mark.parametrize("memory", ["default", "m1"])
def test_generate_cf(tmp_path, taxonomy, memory):
    """generateCF on fixtures/example.fasta: the golden content file, in
    both packages, with the default memory and under -m 1 (1 GB)."""
    mem = ["-m", "1"] if memory == "m1" else []
    j, t = _both(tmp_path, "generateCF", "-c", "{out}/c.txt", "-i",
                 FIXTURES / "example.fasta", "-f", taxonomy / "acc2tax.txt",
                 "-y", taxonomy, "-u", "species", *mem, device=False)
    _same(j / "c.txt", t / "c.txt", ("",))
    _same(t / "c.txt", GOLDEN / "exampleIndex_content.txt", ("",))


def test_generate_cf_chunked_merge_chain(tmp_path, taxonomy):
    """The chunked generator itself (2 accessions a chunk, a merge chain
    of temporary content files) in both packages."""
    from kasa_tpu.index.content import generate_content_file as jg
    from kasa_tpu_torch.index.content import generate_content_file as tg
    for tag, gen in (("j", jg), ("t", tg)):
        gen(str(FIXTURES / "example.fasta"), str(tmp_path / f"{tag}.txt"),
            acc2tax_path=str(taxonomy / "acc2tax.txt"),
            taxonomy_path=str(taxonomy), tax_level="species",
            memory_bound=1)
    _same(tmp_path / "j.txt", tmp_path / "t.txt", ("",))
    _same(tmp_path / "t.txt", GOLDEN / "exampleIndex_content.txt", ("",))


def test_update(tmp_path, taxonomy):
    j, t = _both(tmp_path, "update", "-d", GOLDEN / "exampleIndex", "-o",
                 "{out}/u", "-i", FIXTURES / "example2.fasta", "-f",
                 taxonomy / "acc2tax.txt", "-y", taxonomy, "-u", "species")
    _same(t / "u", GOLDEN / "exampleIndex_u", ARTIFACTS + ("_content.txt",))
    _same(j / "u", t / "u", ARTIFACTS + ("_content.txt",))


def test_delete(tmp_path):
    j, t = _both(tmp_path, "delete", "-d", GOLDEN / "exampleIndex", "-o",
                 "{out}/d", "-l", GOLDEN / "delnodes_test.dmp", "-c",
                 GOLDEN / "exampleIndex_content.txt", device=False)
    _same(t / "d", GOLDEN / "exampleIndex_del")
    _same(j / "d", t / "d")


def test_merge(tmp_path):
    """The reference writes no _info.txt for a merged index and an
    all-zero frequency file (Read.hpp:3180-3243)."""
    suffixes = ("", "_trie", "_trie.txt", "_f.txt", "_content.txt")
    j, t = _both(tmp_path, "merge", "--firstIndex", GOLDEN / "exampleIndex",
                 "--secondIndex", GOLDEN / "index2", "-o", "{out}/m",
                 "-c1", GOLDEN / "exampleIndex_content.txt", "-c2",
                 GOLDEN / "index2_content.txt", device=False)
    _same(t / "m", GOLDEN / "index_merged", suffixes)
    _same(j / "m", t / "m", suffixes)
    assert not (t / "m_info.txt").exists()


@pytest.mark.parametrize("mode,flags,golden", [
    ("shrink", ["-s", "2"], "exampleIndex_s"),
    ("shrink", ["-s", "1", "-g", "50"], "exampleIndex_g50"),
    ("shrink", ["-s", "3"], "exampleIndex_ent"),
    ("half", [], "exampleIndex_s"),
], ids=["half_s2", "every_nth", "entropy", "half_mode"])
def test_shrink(tmp_path, mode, flags, golden):
    j, t = _both(tmp_path, mode, *flags, "-d", GOLDEN / "exampleIndex",
                 "-o", "{out}/s", "-c", GOLDEN / "exampleIndex_content.txt",
                 device=False)
    _same(t / "s", GOLDEN / golden)
    _same(j / "s", t / "s")


def test_get_frequency_and_trie(tmp_path, index_copy):
    """getFrequency and trie rebuild a removed _f.txt and _trie."""
    for s in ("_f.txt", "_trie"):
        pathlib.Path(f"{index_copy}{s}").unlink()
    _main("port", "getFrequency", "-d", index_copy, "-c",
          GOLDEN / "exampleIndex_content.txt")
    _main("port", "trie", "-d", index_copy)
    _same(index_copy, GOLDEN / "exampleIndex", ("_f.txt", "_trie"))


def test_get_frequency_128(tmp_path):
    d = tmp_path / "i"
    d.mkdir()
    for s in ARTIFACTS:
        shutil.copy(f"{GOLDEN / 'exampleIndex128'}{s}", f"{d / 'w'}{s}")
    (d / "w_f.txt").unlink()
    _main("port", "getFrequency", "-d", d / "w", "-c",
          GOLDEN / "exampleIndex_content.txt")
    _same(d / "w", GOLDEN / "exampleIndex128", ("_f.txt",))


def _printed(capsys, *args, feed=None, monkeypatch=None):
    """Both packages' printed output of one mode run."""
    outs = []
    for pkg in ("jax", "port"):
        if feed is not None:
            answers = iter(feed)
            monkeypatch.setattr("builtins.input", lambda: next(answers))
        _main(pkg, *args)
        outs.append(capsys.readouterr().out)
    return outs


def test_redundancy(capsys):
    j, t = _printed(capsys, "redundancy", "-d", GOLDEN / "exampleIndex",
                    "-c", GOLDEN / "exampleIndex_content.txt")
    assert "99% of the k-mers" in t
    assert j.split("OUT: Time")[0] == t.split("OUT: Time")[0]


def test_test_mode(capsys, tmp_path):
    """test: every index entry whose 12 letters a line of the search
    file names."""
    from kasa_tpu_torch.core import kmer
    from kasa_tpu_torch.index import artifacts
    limbs, _, _, _ = artifacts.read_index(str(GOLDEN / "exampleIndex"))
    words = {kmer.limbs_to_string(limbs[i], 12) for i in (0, 99, 5000)}
    (tmp_path / "s.txt").write_text("\n".join(sorted(words)) + "\n")
    j, t = _printed(capsys, "test", "-d", GOLDEN / "exampleIndex", "-i",
                    tmp_path / "s.txt")
    body = t.split("OUT: Time")[0]
    assert j.split("OUT: Time")[0] == body and len(body.splitlines()) >= 3


def test_show_vec(capsys, monkeypatch):
    """showVec: the first 20 entries, then 'e' (the last 20), then 'q'."""
    j, t = _printed(capsys, "showVec", "-d", GOLDEN / "exampleIndex",
                    feed=["e", "q"], monkeypatch=monkeypatch)
    body = t.split("OUT: Time")[0]
    assert j.split("OUT: Time")[0] == body and len(body.splitlines()) == 40


def test_how_much_taxids(tmp_path):
    """howmuchtaxids lists the k-mers of five or more taxa: on an index of
    seeded k-mers, some shared by up to 8 taxa (the golden one has
    none)."""
    import numpy as np
    from kasa_tpu_torch.core import kmer
    from kasa_tpu_torch.index import artifacts
    rng = np.random.default_rng(5)
    keys = np.sort(rng.integers(0, 1 << 60, 300, dtype=np.uint64))
    reps = rng.integers(1, 9, len(keys))
    keys = np.repeat(keys, reps)
    tax = np.concatenate([np.arange(1, r + 1) for r in reps])
    artifacts.write_index(str(tmp_path / "many"), kmer.u64_to_limbs(keys),
                          tax.astype(np.uint32))
    j, t = _both(tmp_path, "howmuchtaxids", "-d", tmp_path / "many",
                 "-t", "{out}/", device=False)
    _same(j / "frequentkMers.txt", t / "frequentkMers.txt", ("",))
    assert (t / "frequentkMers.txt").stat().st_size > 0


def test_translate(tmp_path):
    j, t = _both(tmp_path, "translate", "-i", FIXTURES / "reads.fastq",
                 "-o", "{out}/tr.fastq", device=False)
    _same(j / "tr.fastq", t / "tr.fastq", ("",))
    _same(t / "tr.fastq", GOLDEN / "reads_translated.fastq", ("",))


def test_check_content_file(tmp_path):
    src = tmp_path / "broken.txt"
    src.write_text("Alpha\t11\t11;12\tACC1;ACC2\nBeta\t22\t22\tACC3\n"
                   "Alpha dup\t11\t13;12\tACC2;ACC4\n"
                   "EWAN_dummy\t22\t22\tACC9\n")
    j, t = _both(tmp_path, "checkContentFile", "-c1", src, "-c2",
                 "{out}/fixed.txt", device=False)
    _same(j / "fixed.txt", t / "fixed.txt", ("",))
    assert (t / "fixed.txt").read_text().splitlines() == [
        "Alpha\t11\t11;12;13\tACC1;ACC2;ACC4", "Beta\t22\t22\tACC3"]


def test_transform(tmp_path):
    j, t = _both(tmp_path, "transform", "-d", GOLDEN / "exampleIndex", "-o",
                 "{out}/tf", device=False)
    suffixes = ("", "_2", "_counts.txt", "_info.txt")
    _same(t / "tf", GOLDEN / "transformed", suffixes)
    _same(j / "tf", t / "tf", suffixes)


def test_fuckit(tmp_path):
    j, t = _both(tmp_path, "fuckit", "-d", GOLDEN / "exampleIndex", "-o",
                 "{out}/fk", "-c", GOLDEN / "exampleIndex_content.txt",
                 device=False)
    _same(t / "fk", GOLDEN / "fuckedIndex")
    _same(j / "fk", t / "fk")
