"""Content file generation ("generateCF") and merging (port of
kasa_tpu/index/content.py, host code).

Replicates the reference's GenerateContentFile.hpp semantics:

  * scan reference fasta headers for accession numbers: the accession is
    the first '.'-containing '|'-separated token of the first
    space-separated word (GenerateContentFile.hpp:357-366);
  * headers without an accession get dummy taxids counting down from
    uint32_max-1 and names ``EWAN_<n>`` (:154-161, :292-295);
  * accession -> taxid via NCBI accession2taxid TSVs (2- or 4-column,
    gz or plain; :64-121);
  * climb nodes.dmp to the requested taxonomic level (:223-257),
    keeping the original id if the climb hits root;
  * names from names.dmp "scientific name" rows (:170-179);
  * rows sorted by taxid (numeric, or lexicographic with
    --taxidasstr), written as
    ``name \\t taxid \\t lowest-taxids; \\t accessions;[ \\t line#]``.

The content file maps taxa to dense indices 1..N at identify load time
(index 0 = "non_unique", Compare.hpp:111-180).
"""

from __future__ import annotations

import gzip
import os
import sys
from dataclasses import dataclass, field

DUMMY_TAXID_START = (1 << 32) - 2  # 4294967294 (GenerateContentFile.hpp:307)

_LEVELS = {
    "lowest", "subspecies", "species", "genus", "family", "order",
    "class", "phylum", "kingdom", "superkingdom", "domain",
}


def extract_accession(header: str) -> str:
    """header WITHOUT the leading '>' -> accession or '' if none."""
    first_word = header.split(" ")[0]
    for token in first_word.split("|"):
        if "." in token:
            return token
    return ""


def _open_maybe_gz(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "r")


def gather_files(path: str) -> list[str]:
    """A path may be a file or a directory of files (Utilities
    gatherFilesFromPath)."""
    if os.path.isdir(path):
        return sorted(
            os.path.join(path, f) for f in os.listdir(path)
            if not f.startswith(".")
        )
    return [path]


def scan_fasta_accessions(fasta_paths: list[str]) -> tuple[list[str], list[str], dict]:
    """Returns (accessions_in_order, dummy_headers_in_order,
    acc->header map for 'lowest' naming)."""
    accs: list[str] = []
    seen = set()
    dummies: list[str] = []
    seen_dummy = set()
    names_from_fasta = {}
    for path in fasta_paths:
        with _open_maybe_gz(path) as fh:
            for line in fh:
                line = line.rstrip("\n")
                if not line or line[0] != ">":
                    continue
                header = line[1:]
                acc = extract_accession(header)
                if acc:
                    if acc not in seen:
                        seen.add(acc)
                        accs.append(acc)
                        names_from_fasta[acc] = header.replace(",", " ")
                else:
                    if header not in seen_dummy:
                        seen_dummy.add(header)
                        dummies.append(header)
    return accs, dummies, names_from_fasta


def load_acc2taxid(acc2tax_path: str, wanted: set[str]) -> dict[str, str]:
    """acc -> taxid for all accessions in `wanted`.

    Column layout auto-detected from the first line: 2 columns ->
    (acc, taxid); otherwise NCBI 4-column (accession, accession.version,
    taxid, gi) using columns 1 and 2 (GenerateContentFile.hpp:64-91).
    """
    out: dict[str, str] = {}
    for path in gather_files(acc2tax_path):
        with _open_maybe_gz(path) as fh:
            first = fh.readline()
            cols = first.rstrip("\n").split("\t")
            acc_i, tax_i = (0, 1) if len(cols) == 2 else (1, 2)
            fh.seek(0) if not path.endswith(".gz") else None
            if path.endswith(".gz"):
                fh.close()
                fh = _open_maybe_gz(path)
            for line in fh:
                parts = line.rstrip("\n").split("\t")
                if len(parts) <= max(acc_i, tax_i):
                    continue
                acc = parts[acc_i]
                if acc in wanted and acc not in out:
                    out[acc] = parts[tax_i]
                    if len(out) == len(wanted):
                        break
            fh.close()
    return out


def load_names(taxonomy_path: str) -> dict[str, str]:
    names = {}
    with open(os.path.join(taxonomy_path, "names.dmp")) as fh:
        for line in fh:
            parts = line.split("|")
            if len(parts) > 3 and parts[3] == "\tscientific name\t":
                names[parts[0].strip()] = parts[1].strip()
    return names


def load_nodes(taxonomy_path: str) -> dict[str, tuple[str, str]]:
    """taxid -> (parent, rank)."""
    nodes = {}
    with open(os.path.join(taxonomy_path, "nodes.dmp")) as fh:
        for line in fh:
            parts = line.split("|")
            nodes[parts[0].strip()] = (parts[1].strip(), parts[2].strip())
    return nodes


def climb_to_level(taxid: str, level: str, nodes: dict) -> str:
    """Reference climb loop (GenerateContentFile.hpp:223-244): walk up
    until the *parent entry's* rank matches, keep original if the walk
    reaches root."""
    upper = taxid
    entry = nodes.get(upper, ("1", ""))
    while entry[1] != level and entry[0] != "1":
        upper = entry[0]
        entry = nodes[upper]
    if entry[0] == "1" and entry[1] != level:
        return taxid
    return upper if entry[1] == level else taxid


@dataclass
class ContentEntry:
    name: str
    taxid: str
    lowest_taxids: list[str] = field(default_factory=list)
    accessions: list[str] = field(default_factory=list)
    str_index: str = ""  # only with --taxidasstr (5th column)


def read_content_file(path: str) -> list[ContentEntry]:
    out = []
    with open(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line:
                continue
            parts = line.split("\t")
            if len(parts) < 4:
                raise ValueError(f"Content file line has <4 columns: {line!r}")
            out.append(ContentEntry(
                name=parts[0], taxid=parts[1],
                lowest_taxids=parts[2].split(";"),
                accessions=parts[3].split(";"),
                str_index=parts[4] if len(parts) > 4 else "",
            ))
    return out


def write_content_file(path: str, entries: list[ContentEntry], taxids_as_strings: bool = False):
    with open(path, "w") as fh:
        for i, e in enumerate(entries, start=1):
            row = [e.name.replace(",", ""), e.taxid,
                   ";".join(e.lowest_taxids), ";".join(e.accessions)]
            if taxids_as_strings:
                row.append(str(i))
            fh.write("\t".join(row) + "\n")


def generate_content_file(
    fasta_input: str,
    out_path: str,
    acc2tax_path: str = "",
    taxonomy_path: str = "",
    tax_level: str = "species",
    taxids_as_strings: bool = False,
    verbose: bool = False,
    memory_bound: int | None = None,
) -> list[ContentEntry]:
    """memory_bound (bytes): cap on accession-map residency.  When the
    scanned accession list would exceed it, accessions are processed in
    chunks -- per chunk, only that chunk's acc->taxid rows are loaded
    and a temporary content file is written; the temp files then merge
    pairwise into the final file (the reference's memory-chunked
    generator + merge chain, GenerateContentFile.hpp:23-303, 424-430).
    """
    tax_level = tax_level.lower()
    if tax_level not in _LEVELS:
        print("WARNING: No known tax. level specified. I'll just go with species...",
              file=sys.stderr)
        tax_level = "species"

    fasta_files = gather_files(fasta_input)
    accs, dummies, names_from_fasta = scan_fasta_accessions(fasta_files)

    entries: list[ContentEntry] = []
    if tax_level == "lowest":
        # each accession its own taxon, ids 1..N, names from fasta headers
        groups = {}
        for i, acc in enumerate(accs, start=1):
            groups[str(i)] = ([str(i)], [acc])
        names = {str(i): names_from_fasta[acc] for i, acc in
                 zip(map(str, range(1, len(accs) + 1)), accs)}
        nodes = {}
    else:
        names = load_names(taxonomy_path)
        nodes = load_nodes(taxonomy_path)
        # ~200 B/accession across list + map + groups (floor 2 only
        # reachable with a deliberately tiny bound, e.g. tests)
        chunk = max((memory_bound or (1 << 62)) // 200, 2)
        if len(accs) > chunk:
            return _generate_chunked(
                accs, dummies, names, nodes, acc2tax_path, tax_level,
                out_path, taxids_as_strings, verbose, int(chunk))
        acc2tax = load_acc2taxid(acc2tax_path, set(accs))
        # accessions without taxid join the dummy pool
        no_taxid = [a for a in accs if a not in acc2tax]
        dummies = dummies + no_taxid  # reference appends them to vEntriesWithoutAccNr
        groups: dict[str, tuple[list[str], list[str]]] = {}
        for acc in accs:
            tid = acc2tax.get(acc)
            if tid is None:
                continue
            upper = climb_to_level(tid, tax_level, nodes)
            lows, al = groups.setdefault(upper, ([], []))
            if tid not in lows:
                lows.append(tid)
            al.append(acc)

    def sort_key(t):
        return t if taxids_as_strings else int(t)

    unnamed_counter = 0
    for tid in sorted(groups, key=sort_key):
        lows, al = groups[tid]
        name = names.get(tid)
        if name is None:
            name = f"unnamed_{unnamed_counter}"
            unnamed_counter += 1
        entries.append(ContentEntry(
            name=name.replace(",", " "), taxid=tid,
            lowest_taxids=sorted(set(lows), key=sort_key),
            accessions=sorted(set(al)),
        ))

    pool = DUMMY_TAXID_START
    for i, header in enumerate(dummies):
        entries.append(ContentEntry(
            name=f"EWAN_{i}", taxid=str(pool),
            lowest_taxids=[str(pool)], accessions=[header],
        ))
        pool -= 1

    write_content_file(out_path, entries, taxids_as_strings)
    if verbose:
        print(f"OUT: content file with {len(entries)} entries -> {out_path}")
    return entries


def _generate_chunked(accs, dummies, names, nodes, acc2tax_path,
                      tax_level, out_path, taxids_as_strings, verbose,
                      chunk: int) -> list[ContentEntry]:
    """Memory-bounded generateCF: per accession chunk, load only that
    chunk's acc->taxid rows, write a temp content file, then merge the
    temp files pairwise (mergeContentFiles chain).  Dummies (headers
    without accessions + accessions without taxids) are appended once
    at the end so their countdown ids match the unchunked path."""
    import tempfile

    tmpdir = tempfile.mkdtemp(prefix="kasa_cf_")
    temp_files: list[str] = []
    extra_dummies: list[str] = []
    for ci in range(0, len(accs), chunk):
        part = accs[ci:ci + chunk]
        acc2tax = load_acc2taxid(acc2tax_path, set(part))
        extra_dummies.extend(a for a in part if a not in acc2tax)
        groups: dict[str, tuple[list[str], list[str]]] = {}
        for acc in part:
            tid = acc2tax.get(acc)
            if tid is None:
                continue
            upper = climb_to_level(tid, tax_level, nodes)
            lows, al = groups.setdefault(upper, ([], []))
            if tid not in lows:
                lows.append(tid)
            al.append(acc)
        del acc2tax

        def sort_key(t):
            return t if taxids_as_strings else int(t)
        part_entries = []
        for tid in sorted(groups, key=sort_key):
            lows, al = groups[tid]
            part_entries.append(ContentEntry(
                name=(names.get(tid) or "unnamed_?").replace(",", " "),
                taxid=tid, lowest_taxids=sorted(set(lows), key=sort_key),
                accessions=sorted(set(al))))
        path = os.path.join(tmpdir, f"cf_{len(temp_files)}.txt")
        write_content_file(path, part_entries, taxids_as_strings)
        temp_files.append(path)
        if verbose:
            print(f"OUT: content chunk {len(temp_files)}: "
                  f"{len(part)} accessions, {len(part_entries)} taxa",
                  flush=True)

    merged = temp_files[0]
    for i, nxt in enumerate(temp_files[1:]):
        out = os.path.join(tmpdir, f"cf_m{i}.txt")
        merge_content_files(merged, nxt, out)
        os.remove(merged)
        os.remove(nxt)
        merged = out

    entries = read_content_file(merged)
    os.remove(merged)
    os.rmdir(tmpdir)
    # resolve "unnamed_?" counters in first-seen order (the unchunked
    # path numbers unnamed taxa as it emits them)
    unnamed_counter = 0
    for e in entries:
        if e.name == "unnamed_?":
            e.name = f"unnamed_{unnamed_counter}"
            unnamed_counter += 1
    pool = DUMMY_TAXID_START
    all_dummies = dummies + extra_dummies
    for i, header in enumerate(all_dummies):
        entries.append(ContentEntry(
            name=f"EWAN_{i}", taxid=str(pool),
            lowest_taxids=[str(pool)], accessions=[header]))
        pool -= 1
    write_content_file(out_path, entries, taxids_as_strings)
    if verbose:
        print(f"OUT: content file with {len(entries)} entries -> "
              f"{out_path}")
    return entries


def merge_content_files(path1: str, path2: str, out_path: str,
                        merge_existing_indices: bool = False
                        ) -> tuple[dict[int, int], dict[int, int]]:
    """2-way merge of sorted content files (GenerateContentFile.hpp:449-611).

    Returns (old-dummy->new-dummy maps) for each input, used to remap
    dummy taxids when merging/updating indices.
    """
    e1 = read_content_file(path1)
    e2 = read_content_file(path2)
    taxids_as_strings = any(e.str_index for e in e1 + e2)

    def is_dummy(e):
        return "EWAN" in e.name

    remap1: dict[int, int] = {}
    remap2: dict[int, int] = {}
    dummy_accs: list[str] = []
    pool = (1 << 32) - 1  # counts down (GenerateContentFile.hpp:478)
    merged: dict = {}
    order: list[str] = []

    def key(t):
        return t if taxids_as_strings else int(t)

    for src, remap in ((e1, remap1), (e2, remap2)):
        for e in src:
            if is_dummy(e):
                if merge_existing_indices:
                    remap[int(e.taxid)] = pool
                    pool -= 1
                dummy_accs.append(";".join(e.accessions))
                continue
            if e.taxid in merged:
                m = merged[e.taxid]
                m.lowest_taxids = sorted(set(m.lowest_taxids) | set(e.lowest_taxids), key=key)
                m.accessions = sorted(set(m.accessions) | set(e.accessions))
                m.name = e.name  # second file's name wins on equal (ref :551)
            else:
                merged[e.taxid] = ContentEntry(
                    e.name, e.taxid, list(e.lowest_taxids), list(e.accessions))
                order.append(e.taxid)

    entries = [merged[t] for t in sorted(merged, key=key)]
    dummy_id = (1 << 32) - 1
    ewan_name = 0
    for accs in dummy_accs:
        entries.append(ContentEntry(
            name=f"EWAN_{ewan_name}", taxid=str(dummy_id),
            lowest_taxids=[str(dummy_id)], accessions=[accs],
        ))
        ewan_name += 1
        dummy_id -= 1

    write_content_file(out_path, entries, taxids_as_strings)
    return remap1, remap2
