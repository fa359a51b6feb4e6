"""Read-extraction and format utilities over per-read output.

Covers getNotIdentifiedJson.py, getNotIdentifiedJsonL.py,
getReadsForTaxonFromJsonl.py, jsonToJsonL.py and
downloadGenomesFromContent.py from the reference scripts/ directory.
"""

from __future__ import annotations

import json
import os


def _extract_reads(fastx_path: str, wanted: set[str], out_path: str) -> None:
    """Copy records whose header (sans '>'/'@') is in `wanted`.  Fastq
    records are copied as 4 fixed lines, fasta sequence lines follow
    their header (scripts/getNotIdentifiedJson.py:36-59)."""
    with open(fastx_path) as fh, open(out_path, "w") as out:
        first = next(fh)
        is_fastq = first.startswith("@")
        fh.seek(0)
        writing = False
        for line in fh:
            if line.startswith("@") or line.startswith(">"):
                name = line.rstrip("\r\n").lstrip("@>")
                if name in wanted:
                    if is_fastq:
                        out.write(line + next(fh) + next(fh) + next(fh))
                        writing = False
                    else:
                        out.write(line)
                        writing = True
                else:
                    writing = False
            elif writing:
                out.write(line)


def _unidentified(reads, threshold: float) -> set[str]:
    wanted = set()
    for read in reads:
        hits = read["Top hits"]
        if not hits or hits[0]["Relative Score"] < threshold:
            wanted.add(read["Specifier from input file"])
    return wanted


def get_not_identified_json(json_path: str, fastx_path: str, out_path: str,
                            threshold: float = 0.0) -> None:
    """scripts/getNotIdentifiedJson.py."""
    with open(json_path) as fh:
        reads = json.load(fh)
    _extract_reads(fastx_path, _unidentified(reads, threshold), out_path)


def get_not_identified_jsonl(jsonl_path: str, fastx_path: str, out_path: str,
                             threshold: float = 0.0) -> None:
    """scripts/getNotIdentifiedJsonL.py."""
    with open(jsonl_path) as fh:
        reads = [json.loads(line) for line in fh]
    _extract_reads(fastx_path, _unidentified(reads, threshold), out_path)


def get_reads_for_taxon(jsonl_path: str, fastx_path: str, out_path: str,
                        taxid: str) -> None:
    """scripts/getReadsForTaxonFromJsonl.py: extract reads whose best
    top hit is `taxid`."""
    wanted = set()
    with open(jsonl_path) as fh:
        for line in fh:
            read = json.loads(line)
            hits = read["Top hits"]
            if hits and hits[0]["tax ID"] == taxid:
                wanted.add(read["Specifier from input file"])
    _extract_reads(fastx_path, wanted, out_path)


def json_to_jsonl(json_path: str, jsonl_path: str) -> None:
    """scripts/jsonToJsonL.py."""
    with open(json_path) as fh:
        reads = json.load(fh)
    with open(jsonl_path, "w") as out:
        for read in reads:
            json.dump(read, out)
            out.write("\n")


def download_genomes_from_content(content_path: str, out_dir: str) -> None:
    """scripts/downloadGenomesFromContent.py: fetch every accession in a
    content file from NCBI efetch.  Network-gated; skips files that
    already exist."""
    import urllib.request
    with open(content_path) as fh:
        for line in fh:
            line = line.rstrip("\r\n")
            if not line:
                continue
            for acc in line.split("\t")[3].split(";"):
                if not acc:
                    continue
                dest = os.path.join(out_dir, acc + ".fasta")
                if os.path.isfile(dest):
                    print("File already exists")
                    continue
                print("Downloading file:", acc + ".fasta")
                url = ("https://eutils.ncbi.nlm.nih.gov/entrez/eutils/"
                       "efetch.fcgi?db=nuccore&id=" + acc
                       + "&rettype=fasta&retmode=text")
                with open(dest, "wb") as out:
                    out.write(urllib.request.urlopen(url).read())
