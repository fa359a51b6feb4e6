"""kasa_tpu_torch.tools against kasa_tpu.tools (tests/test_tools.py holds
kasa_tpu's against the reference scripts): each tool of
``python -m kasa_tpu_torch.tools`` on the golden outputs, byte for byte
against kasa_tpu's run of the same tool.  The taxonomy tools read a
small two-rank taxonomy the test writes (species under genera) over the
taxa of tests/golden/exampleIndex_content.txt."""

import json
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "golden"
FIXTURES = REPO / "fixtures"


def run_both(tmp_path, tool, *args, out_flag="-o"):
    """The tool in both packages; -> (kasa_tpu's bytes, the port's)."""
    from kasa_tpu.tools.__main__ import main as jmain
    from kasa_tpu_torch.tools.__main__ import main as tmain
    outs = []
    for tag, main in (("j", jmain), ("t", tmain)):
        out = tmp_path / f"{tag}.out"
        tail = [out_flag, str(out)] if out_flag else [str(out)]
        assert main([tool, *args, *tail]) == 0
        outs.append(out.read_bytes())
    return outs


@pytest.fixture(scope="module")
def taxdumps(tmp_path_factory):
    """nodes.dmp and names.dmp: every taxon of the golden content file a
    species under its own genus (taxid + 10^8), genera under the root."""
    d = tmp_path_factory.mktemp("taxdump")
    nodes = ["1\t|\t1\t|\tno rank\t|\n"]
    names = ["1\t|\troot\t|\t\t|\tscientific name\t|\n"]
    for line in (GOLDEN / "exampleIndex_content.txt").read_text() \
            .splitlines():
        name, taxid = line.split("\t")[:2]
        genus = str(int(taxid) % 100_000_000 + 100_000_000)
        nodes += [f"{taxid}\t|\t{genus}\t|\tspecies\t|\n",
                  f"{genus}\t|\t1\t|\tgenus\t|\n"]
        names += [f"{taxid}\t|\t{name}\t|\t\t|\tscientific name\t|\n",
                  f"{genus}\t|\t{name.split()[0]}\t|\t\t|\t"
                  "scientific name\t|\n"]
    (d / "nodes.dmp").write_text("".join(nodes))
    (d / "names.dmp").write_text("".join(names))
    return str(d / "nodes.dmp"), str(d / "names.dmp")


@pytest.mark.parametrize("tool,inp", [
    ("jsonToFrequencies", "reads_identify.json"),
    ("jsonToFrequenciesTopOnly", "reads_identify.json"),
    ("jsonLToFrequencies", "reads_identify.jsonl"),
    ("jsonLToFrequenciesTopOnly", "reads_identify.jsonl"),
    ("tsvToFrequencies", "reads_identify.tsv"),
])
def test_frequencies_parity(tmp_path, tool, inp):
    j, t = run_both(tmp_path, tool, "-i", str(GOLDEN / inp))
    assert j == t and len(t) > 0


def test_frequencies_threshold(tmp_path):
    j, t = run_both(tmp_path, "jsonToFrequencies", "-i",
                    str(GOLDEN / "reads_identify.json"), "-t", "0.5")
    assert j == t and len(t) > 0


def _freqs(tmp_path):
    from kasa_tpu_torch.tools.__main__ import main
    freqs = tmp_path / "freqs.tsv"
    assert main(["jsonToFrequencies", "-i",
                 str(GOLDEN / "reads_identify.json"), "-o", str(freqs)]) == 0
    return str(freqs)


def test_sum_freqs_on_tax_lvl(tmp_path, taxdumps):
    nodes, names = taxdumps
    j, t = run_both(tmp_path, "sumFreqsOnTaxLvl", "-i", _freqs(tmp_path),
                    "-n", nodes, "-m", names, "-r", "genus")
    assert j == t and len(t) > 0


@pytest.mark.parametrize("u", ["n", "u", "o"])
def test_csv_to_cami(tmp_path, taxdumps, u):
    nodes, names = taxdumps
    j, t = run_both(tmp_path, "csvToCAMI", "-i",
                    str(GOLDEN / "reads_profile.csv"), "-n", nodes, "-m",
                    names, "-k", "12", "-u", u)
    assert j == t and len(t) > 0


def test_freqs_to_cami_and_krona(tmp_path, taxdumps):
    nodes, names = taxdumps
    j, t = run_both(tmp_path, "freqsToCAMI", "-i", _freqs(tmp_path), "-n",
                    nodes, "-m", names)
    assert j == t and len(t) > 0
    cami = tmp_path / "cami.txt"
    cami.write_bytes(t)
    j, t = run_both(tmp_path, "camiToKrona", "-i", str(cami))
    assert j == t and len(t) > 0


def test_json_to_cami_bin(tmp_path):
    j, t = run_both(tmp_path, "jsonToCAMIBin", "-i",
                    str(GOLDEN / "reads_identify.json"))
    assert j == t and len(t) > 0


def test_json_to_jsonl(tmp_path):
    j, t = run_both(tmp_path, "jsonToJsonL",
                    str(GOLDEN / "reads_identify.json"), out_flag=None)
    assert j == t and len(t) > 0


@pytest.fixture(scope="module")
def spaced_fastq(tmp_path_factory):
    """fixtures/reads.fastq with a space after each name: the specifiers
    of the golden outputs end in one (the reference writes the header's
    first word and its separator), and the read tools match names
    exactly."""
    lines = (FIXTURES / "reads.fastq").read_text().splitlines(True)
    for i in range(0, len(lines), 4):
        lines[i] = lines[i].rstrip("\n") + " \n"
    fq = tmp_path_factory.mktemp("spaced") / "reads.fastq"
    fq.write_text("".join(lines))
    return str(fq)


@pytest.mark.parametrize("tool,inp", [
    ("getNotIdentifiedJson", "reads_identify.json"),
    ("getNotIdentifiedJsonL", "reads_identify.jsonl"),
])
def test_get_not_identified(tmp_path, spaced_fastq, tool, inp):
    j, t = run_both(tmp_path, tool, "-i", str(GOLDEN / inp), "-f",
                    spaced_fastq, "-t", "0.9")
    assert j == t and len(t) > 0


def test_get_reads_for_taxon(tmp_path, spaced_fastq):
    reads = json.load(open(GOLDEN / "reads_identify.json"))
    taxid = next(r["Top hits"][0]["tax ID"] for r in reads if r["Top hits"])
    j, t = run_both(tmp_path, "getReadsForTaxonFromJsonl", "-i",
                    str(GOLDEN / "reads_identify.jsonl"), "-f",
                    spaced_fastq, "-t", taxid)
    assert j == t and len(t) > 0


def test_reconstruct_dna_roundtrip():
    import numpy as np
    from kasa_tpu.tools.reconstruct import translate_frames as jtf
    from kasa_tpu_torch.tools.reconstruct import reconstruct, translate_frames
    rng = np.random.default_rng(0)
    for length in (3, 10, 37, 120):
        dna = "".join("ACGT"[i] for i in rng.integers(0, 4, size=length))
        frames = translate_frames(dna)
        assert frames == jtf(dna)
        result = reconstruct(frames)
        assert result[:length - 2] == dna[:length - 2]
        assert translate_frames(result) == frames


def test_cli_lists_the_tools(capsys):
    from kasa_tpu_torch.tools.__main__ import TOOLS, main
    from kasa_tpu.tools.__main__ import TOOLS as JTOOLS
    assert sorted(TOOLS) == sorted(JTOOLS)
    assert main([]) != 0
    assert "jsonToFrequencies" in capsys.readouterr().out
