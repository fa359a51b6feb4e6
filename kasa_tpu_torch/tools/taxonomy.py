"""Shared NCBI-taxonomy-dump helpers for the tools package.

Parsing matches the reference scripts' ad-hoc readers
(scripts/sumFreqsOnTaxLvl.py:30-46, scripts/csvToCAMI.py:38-53):
nodes.dmp rows are `taxid | parent | rank | ...`, names.dmp rows are
`taxid | name | unique-name | class |` and only "scientific name" rows
are kept.
"""

from __future__ import annotations

CAMI_RANKS = ["superkingdom", "phylum", "class", "order", "family",
              "genus", "species", "strain"]


def load_nodes(path: str) -> dict[str, tuple[str, str]]:
    """taxid -> (parent taxid, rank)."""
    nodes: dict[str, tuple[str, str]] = {}
    with open(path) as fh:
        for line in fh:
            parts = line.split("|")
            tid = parts[0].rstrip("\t")
            nodes[tid] = (parts[1].strip("\t"), parts[2].strip("\t"))
    return nodes


def load_names(path: str) -> dict[str, str]:
    """taxid -> scientific name."""
    names: dict[str, str] = {}
    with open(path) as fh:
        for line in fh:
            parts = line.split("|")
            if parts[3] == "\tscientific name\t":
                names[parts[0].rstrip("\t")] = parts[1].strip("\t")
    return names


def climb_to_rank(taxid: str, rank: str,
                  nodes: dict[str, tuple[str, str]]) -> str:
    """Walk parent pointers until `rank` (or the root) is reached;
    returns the taxid whose rank matched (or the last one visited),
    mirroring scripts/sumFreqsOnTaxLvl.py:63-71."""
    if taxid not in nodes:
        return taxid
    next_id, next_rank = nodes[taxid]
    while next_rank != rank and next_id != "1":
        taxid = next_id
        next_id, next_rank = nodes[taxid]
    return taxid


def cami_path(taxid: str, nodes: dict[str, tuple[str, str]],
              names: dict[str, str]) -> tuple[list[str], list[str], list[str]]:
    """Root-ward (taxids, names, ranks) path for the CAMI profiling
    format.  "no rank" levels contribute empty id/name slots but keep
    their rank slot, exactly like scripts/csvToCAMI.py:88-112."""
    id_path = [taxid]
    name_path = [names.get(taxid, "unnamed")]
    rank_path = [nodes[taxid][1]]
    next_id, curr_rank = nodes[taxid][0], nodes[taxid][1]
    while curr_rank != "superkingdom" and taxid != "1":
        taxid = next_id
        curr_rank = nodes[taxid][1]
        if curr_rank != "no rank":
            id_path.insert(0, next_id)
            name_path.insert(0, names.get(next_id, "unnamed"))
        else:
            id_path.insert(0, "")
            name_path.insert(0, "")
        rank_path.insert(0, curr_rank)
        next_id = nodes[taxid][0]
    return id_path, name_path, rank_path
