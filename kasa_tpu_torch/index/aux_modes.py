"""Small maintenance modes: getFrequency, trie, redundancy,
checkContentFile, translate, test, howmuchtaxids, showVec, transform and
fuckit (main.cpp:1336-1490); port of kasa_tpu/index/aux_modes.py, host
code throughout."""

from __future__ import annotations

import numpy as np

from ..config import Config
from ..core.alphabet import build_codon_lut
from . import artifacts
from .build import compute_frequencies
from .content import read_content_file


def get_frequency(cfg: Config):
    """Recreate <idx>_f.txt from index + content file (main.cpp:1336-1362,
    kASA.hpp:449-575)."""
    index_path = cfg.index_file or cfg.db_out
    content = cfg.content_file or index_path + "_content.txt"
    limbs, taxids, highest_k, itype = artifacts.read_index(index_path)
    if itype == artifacts.INDEX_TYPE_HALF:
        raise RuntimeError("getFrequency cannot run on shrunken (halved) indices")
    entries = read_content_file(content)
    freq = compute_frequencies(limbs, taxids, entries, highest_k, lowest_k=1)
    artifacts.write_frequency_file(index_path, entries, freq)


def rebuild_trie(cfg: Config):
    """Recreate <idx>_trie/<idx>_trie.txt from the index
    (main.cpp:1422-1457, Trie.hpp:366-394)."""
    index_path = cfg.index_file or cfg.db_out
    limbs, taxids, highest_k, itype = artifacts.read_index(index_path)
    if itype == artifacts.INDEX_TYPE_HALF:
        raise RuntimeError("trie cannot run on shrunken (halved) indices")
    prefixes, counts = artifacts.trie_from_sorted_prefixes(limbs[:, 0])
    artifacts.write_trie(index_path, prefixes, counts)


def redundancy(cfg: Config):
    """Taxa-per-k-mer histogram; report the 99%-quantile count
    (Shrink.hpp:35-72, main.cpp:1364-1419)."""
    index_path = cfg.index_file or cfg.db_out
    limbs, taxids, highest_k, itype = artifacts.read_index(index_path)
    if itype == artifacts.INDEX_TYPE_HALF:
        raise RuntimeError("redundancy cannot be called on shrunken indices!")
    n = len(taxids)
    if n == 0:
        print("OUT: index is empty")
        return 0
    # run lengths of equal k-mers
    new = np.r_[True, np.any(limbs[1:] != limbs[:-1], axis=1)]
    run_ids = np.cumsum(new) - 1
    run_lens = np.bincount(run_ids)
    hist = np.bincount(run_lens)          # hist[c] = #k-mers with c taxa
    if cfg.verbose:
        print(f"Number of unique k-mers: {len(run_lens) - 1}")
        print("Histogram\nFrequency Counts Percentage")
    percentage = 0.0
    idx99 = 0
    for c in range(1, len(hist)):
        if hist[c] and cfg.verbose:
            print(c, hist[c], 100.0 * float(hist[c]) * c / n)
        percentage += float(hist[c]) * c / n
        if percentage >= 0.99 and idx99 == 0:
            idx99 = c
    if idx99 == 1:
        print("OUT: 99% of the k-mers in your index have only one taxon. "
              "Using unique frequencies makes sense.")
    elif idx99 < 4:
        print(f"OUT: 99% of the k-mers in your index have {idx99} or less "
              "taxa. Using unique frequencies could make sense.")
    else:
        print(f"OUT: 99% of the k-mers in your index have {idx99} or less "
              "taxa. You should consider looking at the non-unique "
              "frequencies as well.")
    return idx99


def check_content_file(cfg: Config):
    """checkContentFile mode (checkIfContentFileIsCorrupted,
    Utilities.hpp:926-1010; main.cpp:1459-1462): read content file 1
    (-c1), merge rows sharing a taxid (union of species-ID and
    accession columns; duplicate *dummy* rows -- name containing
    "EWAN" -- are dropped, not merged), and write the fixed file to
    content file 2 (-c2).  Five-or-more-column files are treated as
    --taxidasstr output and keep their line-index column (the merged
    row takes the LATEST duplicate's index, as the reference does).

    Deviation: the reference emits rows/joined fields in
    unordered_map/set iteration order (non-deterministic); we keep
    first-seen row order and insertion-ordered unions."""
    src = cfg.content_file1 or cfg.content_file or cfg.input
    dst = cfg.content_file2 or cfg.db_out
    tax_as_str = False
    rows: dict = {}     # taxid -> [name, specIDs, accNrs, lineIdx]
    merged = 0
    with open(src, encoding="latin-1") as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line:
                continue
            parts = line.split("\t")
            if len(parts) < 4:
                print(f"ERROR: Content file row with "
                      f"{len(parts)} column(s) skipped: "
                      f"{line[:80]}", flush=True)
                merged += 1
                continue
            if len(parts) >= 5 and not tax_as_str:
                tax_as_str = True
            if tax_as_str and len(parts) < 5:
                print(f"ERROR: Content file row missing its index "
                      f"column skipped: {line[:80]}", flush=True)
                merged += 1
                continue
            dummy = "EWAN" in parts[0]
            entry = rows.get(parts[1])
            if entry is not None:
                if not dummy:
                    print(f"OUT: Content file is corrupted, duplicate "
                          f"entries {parts[0]} and {entry[0]} were "
                          "found. Merging them now...", flush=True)
                    merged += 1
                    spec = dict.fromkeys(entry[1].split(";"))
                    spec.update(dict.fromkeys(parts[2].split(";")))
                    acc = dict.fromkeys(entry[2].split(";"))
                    acc.update(dict.fromkeys(parts[3].split(";")))
                    entry[1] = ";".join(spec)
                    entry[2] = ";".join(acc)
                    if tax_as_str:
                        entry[3] = parts[4]
            else:
                rows[parts[1]] = [parts[0], parts[2], parts[3],
                                  parts[4] if tax_as_str else ""]
    if dst:
        with open(dst, "w", encoding="latin-1") as out:
            for tax, e in rows.items():
                tail = ("\t" + e[3]) if tax_as_str else ""
                out.write(f"{e[0]}\t{tax}\t{e[1]}\t{e[2]}{tail}\n")
    if merged == 0:
        print("OUT: Content file looks fine.")
    return merged


def translate_file(cfg: Config):
    """Dump a 1-frame translation of a fastq file
    (translateFileInOneFrame, Read.hpp:297-339): 4-line cycle of
    name / translated AA / '+' line / 'I'*len quality."""
    lut = build_codon_lut()  # 366-entry char table
    if cfg.codon_table:
        from ..core.alphabet import apply_custom_codon_table
        lut = apply_custom_codon_table(lut, cfg.codon_table, cfg.codon_id)
    with open(cfg.input) as fin, open(cfg.db_out or cfg.read_to_taxa_file, "w") as fout:
        state = 0
        quali_len = 0
        for line in fin:
            line = line.rstrip("\n")
            if line == "":
                continue
            if state == 0:
                fout.write(line + "\n")
                state = 1
            elif state == 1:
                raw = np.frombuffer(line.encode("ascii"), np.uint8).copy()
                bad = ~np.isin(raw, np.frombuffer(b"ACGTacgt", np.uint8))
                raw[bad] = ord("Z")
                n_aa = len(raw) // 3
                aa = []
                for j in range(n_aa):
                    c1, c2, c3 = raw[3 * j], raw[3 * j + 1], raw[3 * j + 2]
                    idx = ((int(c1) & 14) << 5) | ((int(c2) & 14) << 2) | ((int(c3) & 14) >> 1)
                    aa.append(chr(lut[idx]))
                s = "".join(aa).rstrip(" ")
                quali_len = len(s)
                fout.write(s + "\n")
                state = 2
            elif state == 2:
                fout.write(line + "\n")
                state = 3
            else:
                fout.write("I" * quali_len + "\n")
                state = 0


def test_kmers(cfg: Config, search_file: str):
    """`test` mode (main.cpp:1492-1529): look up the k-mers listed (one
    AA string per line) and print '<aa12> <taxid>' for every index
    entry matching them, in index order."""
    from ..core import kmer

    index_path = cfg.index_file or cfg.db_out
    limbs, taxids, highest_k, itype = artifacts.read_index(index_path)
    keys = kmer.limbs_to_u64(limbs) if highest_k <= 12 else None
    with open(search_file) as fh:
        wanted = [line.rstrip("\n") for line in fh if line.strip()]
    for s in wanted:
        q = kmer.limbs_to_u64(kmer.string_to_limbs(s, 12)[None, :])[0]
        lo = int(np.searchsorted(keys, q, side="left"))
        hi = int(np.searchsorted(keys, q, side="right"))
        for i in range(lo, hi):
            print(kmer.limbs_to_string(limbs[i], 12), taxids[i])


def how_much_taxids(cfg: Config):
    """`howmuchtaxids` mode (main.cpp:1531-1563): write
    <temp>/frequentkMers.txt listing k-mers carried by many taxa.
    Faithfully reproduces the reference's walk, including its quirks:
    the first entry of a group is never inserted into the taxid set
    (so groups qualify at >= 5 entries and the first taxon may be
    missing), the flushed line is labeled with the NEXT group's k-mer,
    and the final group is never flushed."""
    from ..core import kmer

    index_path = cfg.index_file or cfg.db_out
    limbs, taxids, highest_k, itype = artifacts.read_index(index_path)
    keys = kmer.limbs_to_u64(limbs)
    out_path = (cfg.temp_path or "") + "frequentkMers.txt"
    new = np.r_[True, keys[1:] != keys[:-1]]
    starts = np.nonzero(new)[0]
    ends = np.r_[starts[1:], len(keys)]
    with open(out_path, "w") as out:
        for g in range(len(starts) - 1):  # last group never flushes
            s, e = int(starts[g]), int(ends[g])
            if e - s >= 5:
                tax = sorted(set(int(t) for t in taxids[s + 1:e]))
                out.write(kmer.limbs_to_string(limbs[int(ends[g])], 12)
                          + "".join(f" {t}" for t in tax) + "\n")


def show_vec(cfg: Config):
    """`showVec` mode (main.cpp:1565-1583, kASA.hpp:414-444):
    interactive index dump, 20 entries at a time; 'q' quits, 'e' jumps
    to the last 20, 'l' + an AA string prints the next match."""
    from ..core import kmer

    index_path = cfg.index_file or cfg.db_out
    limbs, taxids, highest_k, itype = artifacts.read_index(index_path)
    if itype == artifacts.INDEX_TYPE_128:
        hi, lo = kmer.limbs_to_u128_parts(limbs)
        values = [(int(h) << 64) | int(l) for h, l in zip(hi, lo)]
        k_shown = 25
    else:
        values = kmer.limbs_to_u64(limbs).tolist()
        k_shown = 12
    i, counter, lookup = 0, 0, ""
    while i < len(values):
        if counter == 20:
            counter = 0
            if not lookup:
                cmd = input()
                if cmd in ("q", "Q"):
                    return
                if cmd == "l":
                    lookup = input()
                if cmd == "e":
                    i = max(len(values) - 20, 0)
        if lookup:
            if kmer.limbs_to_string(limbs[i], k_shown) == lookup:
                print(values[i], kmer.limbs_to_string(limbs[i], k_shown),
                      taxids[i])
                lookup = ""
        else:
            print(values[i], kmer.limbs_to_string(limbs[i], k_shown),
                  taxids[i])
            counter += 1
        i += 1


def transform_index(cfg: Config):
    """`transform` dev mode (main.cpp:1585-1631): experimental CSR-like
    re-encoding of a 64-bit index into three column files --
    ``<out>`` (unique k-mers, u64), ``<out>_2`` (the taxid of every
    pair, u32, in index order), ``<out>_counts.txt`` (start offset of
    each unique k-mer's pair run) and ``<out>_info.txt``
    "<unique>\\n<pairs>".  Keeps the reference's iSeen=0 seed, so a
    leading all-'@' k-mer would merge into the implicit first run."""
    from ..core import kmer

    index_path = cfg.index_file or cfg.first_old_index
    out = cfg.db_out
    limbs, taxids, highest_k, itype = artifacts.read_index(index_path)
    if itype != artifacts.INDEX_TYPE_64:
        raise RuntimeError("transform supports 64-bit indices only")
    keys = kmer.limbs_to_u64(limbs)
    prev = np.r_[np.zeros(1, np.uint64), keys[:-1]] if len(keys) else keys
    new = keys != prev
    uniq = keys[new]
    offsets = np.nonzero(new)[0]
    artifacts._write_blocks(out, uniq.astype("<u8"), artifacts.BLOCK_64)
    artifacts._write_blocks(out + "_2", taxids.astype("<u4"),
                            artifacts.BLOCK_64)
    with open(out + "_counts.txt", "w") as fh:
        fh.writelines(f"{int(o)}\n" for o in offsets)
    with open(out + "_info.txt", "w") as fh:
        fh.write(f"{len(uniq)}\n{len(keys)}")


def spaced_reencode_u64(keys: np.ndarray) -> np.ndarray:
    """The `fuckit` re-encoding (main.cpp:1671-1676): keep the letters
    at even positions 0,2,4,6,8,10 of the 12-letter k-mer and pack them
    into the top six letter slots (a spaced-seed view of the index)."""
    out = np.zeros_like(keys)
    j = 0
    for i in range(55, 4, -10):
        out |= (keys & (np.uint64(31) << np.uint64(i))) << np.uint64(j)
        j += 5
    return out


def fuckit_reencode(cfg: Config):
    """`fuckit` dev mode (main.cpp:1634-1713): re-encode every k-mer
    with the spaced-seed packing, sort, and store ONLY the dense
    content-row of each pair as a u16 vector (taxaOnly) + trie over the
    re-encoded prefixes + a copy of the frequency file.  Pairs are NOT
    deduplicated after the re-encoding (faithful to the reference)."""
    from ..core import kmer

    index_path = cfg.index_file or cfg.first_old_index
    out = cfg.db_out
    limbs, taxids, highest_k, itype = artifacts.read_index(index_path)
    if itype != artifacts.INDEX_TYPE_64:
        raise RuntimeError("fuckit supports 64-bit indices only")
    # content rows: only 4-column lines get an index (main.cpp:1640-1650)
    ids_as_idx = {0: 0}
    counter = 1
    with open(cfg.content_file, encoding="latin-1") as fh:
        for line in fh:
            line = line.rstrip("\n")
            if line and len(line.split("\t")) == 4:
                ids_as_idx[int(line.split("\t")[1])] = counter
                counter += 1
    keys = spaced_reencode_u64(kmer.limbs_to_u64(limbs))
    order = np.lexsort((taxids, keys))
    keys, taxids = keys[order], taxids[order]
    rows = np.array([ids_as_idx[int(t)] for t in taxids], dtype=np.uint16)
    artifacts._write_blocks(out, rows.astype("<u2"), artifacts.BLOCK_64)
    with open(out + "_info.txt", "w") as fh:
        fh.write(f"{len(rows)}")
    with open(index_path + "_f.txt", "rb") as src, \
            open(out + "_f.txt", "wb") as dst:
        dst.write(src.read())
    prefixes, counts = artifacts.trie_from_sorted_prefixes(
        (keys >> np.uint64(30)).astype(np.uint32))
    artifacts.write_trie(out, prefixes, counts)
