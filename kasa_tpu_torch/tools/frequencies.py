"""Per-read output -> per-taxon frequency tables.

Covers jsonToFrequencies.py, jsonLToFrequencies.py, tsvToFrequencies.py
and the ...TopOnly variants plus sumFreqsOnTaxLvl.py from the reference
scripts/ directory.  A "frequency table" here is the scripts' TSV:
``taxid \t name \t count \t count/readCount`` sorted by truncated count
descending.
"""

from __future__ import annotations

import json

from .taxonomy import climb_to_rank, load_names, load_nodes


def _accumulate(result: dict, hits: list, threshold: float) -> None:
    """Split one read's credit 1/until over its score-tied leading hits
    (scripts/jsonToFrequencies.py:36-52)."""
    if not hits:
        return
    starting = hits[0]["Relative Score"]
    if starting < threshold:
        return
    until = 0
    for h in hits:
        if h["Relative Score"] >= starting:
            until += 1
        else:
            break
    for h in hits[:until]:
        tid = h["tax ID"]
        name, count = result.get(tid, (h["Name"], 0.0))
        result[tid] = (name, count + 1.0 / until)


def _accumulate_all_equally(result: dict, hits: list, threshold: float) -> None:
    """jsonLToFrequenciesTopOnly.py:36-52 splits over ALL top hits
    (no tie-break scan), unlike the other four scripts."""
    if not hits:
        return
    if hits[0]["Relative Score"] < threshold:
        return
    for h in hits:
        tid = h["tax ID"]
        name, count = result.get(tid, (h["Name"], 0.0))
        result[tid] = (name, count + 1.0 / len(hits))


def _write_table(result: dict, read_count: int, out_path: str) -> None:
    rows = [(tid, name, count, count / read_count)
            for tid, (name, count) in result.items()]
    # the reference sorts on the truncated count (scripts/jsonToFrequencies.py:60)
    rows.sort(key=lambda r: int(r[2]), reverse=True)
    with open(out_path, "w") as out:
        for tid, name, count, freq in rows:
            out.write(f"{tid}\t{name}\t{count}\t{freq}\n")


def json_to_frequencies(in_path: str, out_path: str, threshold: float = 0.0,
                        top_only: bool = False) -> None:
    """scripts/jsonToFrequencies.py / jsonToFrequenciesTopOnly.py."""
    with open(in_path) as fh:
        reads = json.load(fh)
    result: dict = {}
    read_count = 0
    for read in reads:
        read_count += 1
        hits = list(read["Top hits"])
        if not top_only:
            hits += read["Further hits"]
        _accumulate(result, hits, threshold)
    _write_table(result, read_count, out_path)


def jsonl_to_frequencies(in_path: str, out_path: str, threshold: float = 0.0,
                         top_only: bool = False) -> None:
    """scripts/jsonLToFrequencies.py / jsonLToFrequenciesTopOnly.py."""
    result: dict = {}
    read_count = 0
    with open(in_path) as fh:
        for line in fh:
            read = json.loads(line)
            read_count += 1
            if top_only:
                _accumulate_all_equally(result, list(read["Top hits"]), threshold)
            else:
                _accumulate(result, read["Top hits"] + read["Further hits"],
                            threshold)
    _write_table(result, read_count, out_path)


def tsv_to_frequencies(in_path: str, out_path: str,
                       threshold: float = 0.0) -> None:
    """scripts/tsvToFrequencies.py: same logic over the tsv per-read
    format (columns: #read, specifier, taxids;, names;, scores;, ...)."""
    result: dict = {}
    read_count = 0
    with open(in_path) as fh:
        next(fh)
        for line in fh:
            cols = line.rstrip("\r\n").split("\t")
            read_count += 1
            if cols[2] == "-":
                continue
            taxids = cols[2].split(";")
            names = cols[3].split(";")
            scores = [float(s.split(",")[0]) for s in cols[4].split(";")]
            starting = scores[0]
            if starting < threshold:
                continue
            until = 0
            for s in scores:
                if s >= starting:
                    until += 1
                else:
                    break
            for i in range(until):
                name, count = result.get(taxids[i], (names[i], 0.0))
                result[taxids[i]] = (name, count + 1.0 / until)
    _write_table(result, read_count, out_path)


def sum_freqs_on_tax_level(freq_path: str, nodes_path: str, names_path: str,
                           rank: str, out_path: str) -> None:
    """scripts/sumFreqsOnTaxLvl.py: aggregate a frequency table's column
    3 (relative frequency) up the taxonomy to `rank`."""
    nodes = load_nodes(nodes_path)
    names = load_names(names_path)
    result: dict[str, float] = {}
    with open(freq_path) as fh:
        for line in fh:
            line = line.rstrip("\r\n")
            if not line:
                continue
            cols = line.split("\t")
            tid, quantity = cols[0], float(cols[3])
            if tid not in nodes:
                continue
            anc = climb_to_rank(tid, rank, nodes)
            result[anc] = result.get(anc, 0.0) + quantity
    with open(out_path, "w") as out:
        for tid, total in result.items():
            out.write(f"{names[tid]}\t{nodes[tid][1]}\t{total}\n")
