"""CAMI profiling/binning format converters + Krona export.

Covers csvToCAMI.py, freqsToCAMI.py, jsonToCAMIBin.py and camiToKrona.py
from the reference scripts/ directory.
"""

from __future__ import annotations

import json

from .taxonomy import CAMI_RANKS, cami_path, load_names, load_nodes

CAMI_PROFILE_HEADER = (
    "#CAMI Submission for Taxonomic Profiling\n@SampleID:\n@Version:0.9.2\n"
    "@Ranks:superkingdom|phylum|class|order|family|genus|species|strain\n"
    "@TaxonomyID:?\n@__program__:kASA\n"
    "@@TAXID\tRANK\tTAXPATH\tTAXPATHSN\tPERCENTAGE\n")


def _emit_cami_profile(quantities: list[tuple[str, float]],
                       nodes: dict, names: dict, out_path: str) -> None:
    """quantities: (taxid, percentage) rows already thresholded.  Each
    row's percentage is added to every ancestor on its CAMI path; rows
    are emitted grouped by rank, insertion-ordered within a rank
    (scripts/csvToCAMI.py:88-141)."""
    tax_paths: dict[str, list] = {}
    for tid, quantity in quantities:
        if tid not in nodes:
            continue
        id_path, name_path, rank_path = cami_path(tid, nodes, names)
        for i in range(len(id_path) - 1, -1, -1):
            anc = id_path[i]
            if anc == "":
                continue
            if anc in tax_paths:
                tax_paths[anc][4] += quantity
            else:
                tax_paths[anc] = [anc, rank_path[i],
                                  "|".join(id_path[:i + 1]),
                                  "|".join(name_path[:i + 1]), quantity]
    with open(out_path, "w") as out:
        out.write(CAMI_PROFILE_HEADER)
        for rank in CAMI_RANKS:
            for row in tax_paths.values():
                if row[1] == rank:
                    out.write("\t".join(row[:4]) + "\t" + str(row[4]) + "\n")


def csv_to_cami(in_path: str, nodes_path: str, names_path: str, out_path: str,
                k_value: str = "12", which: str = "n",
                threshold: float = 0.0) -> None:
    """scripts/csvToCAMI.py: profile CSV -> CAMI profiling format.
    `which`: 'u' = Unique rel. freq. column for k, 'o' = Overall rel.
    freq., anything else = Non-unique rel. freq."""
    nodes = load_nodes(nodes_path)
    names = load_names(names_path)
    want = {"u": "Unique", "o": "Overall"}.get(which, "Non-unique")
    with open(in_path) as fh:
        header = next(fh).split(",")
        row_idx = 2
        for i, entry in enumerate(header):
            if want in entry and k_value in entry and "rel. freq." in entry:
                row_idx = i
                break
        quantities = []
        for line in fh:
            line = line.rstrip("\r\n")
            if line == "":
                break
            cols = line.split(",")
            q = float(cols[row_idx]) * 100.0
            if q > threshold:
                quantities.append((cols[0], q))
    _emit_cami_profile(quantities, nodes, names, out_path)


def freqs_to_cami(in_path: str, nodes_path: str, names_path: str,
                  out_path: str, threshold: float = 0.0) -> None:
    """scripts/freqsToCAMI.py: frequency table (from
    tools.frequencies) -> CAMI profiling format; column 3 * 100."""
    nodes = load_nodes(nodes_path)
    names = load_names(names_path)
    quantities = []
    with open(in_path) as fh:
        for line in fh:
            line = line.rstrip("\r\n")
            if line == "":
                break
            cols = line.split("\t")
            q = float(cols[3]) * 100.0
            if q > threshold:
                quantities.append((cols[0], q))
    _emit_cami_profile(quantities, nodes, names, out_path)


def json_to_cami_bin(in_path: str, out_path: str) -> None:
    """scripts/jsonToCAMIBin.py: per-read json -> CAMI binning format
    (best top hit per read)."""
    with open(in_path) as fh:
        reads = json.load(fh)
    with open(out_path, "w") as out:
        out.write("#CAMI Format for Binning created from kASA json output\n"
                  "@Version:0.9.0\n@SEQUENCEID\tTAXID")
        for read in reads:
            hits = read["Top hits"]
            if hits:
                out.write("\n" + read["Specifier from input file"] + "\t"
                          + hits[0]["tax ID"])


def cami_to_krona(in_path: str, out_path: str) -> None:
    """scripts/camiToKrona.py: CAMI profile -> Krona text input.  Rows
    of the smallest rank present carry their percentage; all other rows
    are emitted with 0.0; the remainder to 100 is appended."""
    with open(in_path) as fh:
        lines = fh.readlines()
    rank = ""
    rank_idx = 0
    for line in lines:
        if "@" in line or "#" in line:
            continue
        if CAMI_RANKS[rank_idx] in line:
            rank = CAMI_RANKS[rank_idx]
        elif rank_idx + 1 < len(CAMI_RANKS):
            rank_idx += 1
    total = 0.0
    with open(out_path, "w") as out:
        for line in lines:
            if "@" in line or "#" in line:
                continue
            line = line.rstrip("\n")
            if line == "":
                continue
            cols = line.split("\t")
            if rank == cols[1]:
                total += float(cols[4])
                out.write(cols[4] + "\t" + cols[3].replace("|", "\t") + "\n")
            else:
                out.write("0.0\t" + cols[3].replace("|", "\t") + "\n")
        out.write(str(100 - total))
