"""On-disk index artifact family, byte-compatible with the reference
(port of kasa_tpu/index/artifacts.py).

An index named ``<idx>`` consists of (SURVEY §5; reference README 462-479):

  <idx>            sorted (k-mer, taxid) records, dedup'd; 64-bit: 12 B
                   packed (u64 LE kmer, u32 LE taxid), file padded with
                   zeros to 2101248-byte stxxl blocks (MetaHeader.h:137);
                   128-bit: 20 B packed (u128 LE, u32), blocks of 2048000;
                   halved: 6 B packed (u32 suffix, u16 taxon index)
  <idx>_info.txt   entry count [+ "\\n128" or "\\n3" type tag]
  <idx>_trie       RLE of the 6-letter prefixes: 12 B packed
                   (u64 LE count, u32 LE prefix) (Trie.hpp:366-394)
  <idx>_trie.txt   number of trie records
  <idx>_f.txt      per-taxon k-mer validity counts, k = highestK..lowestK
                   (kASA.hpp:449-575)
  <idx>_content.txt  taxa metadata (index/content.py)

In memory the k-mers live as int32 limb arrays (core/kmer.py).
"""

from __future__ import annotations

import os

import numpy as np

from ..core import kmer

BLOCK_64 = 2101248
BLOCK_128 = 2048000
BLOCK_HALF = 2101248

REC_64 = np.dtype([("kmer", "<u8"), ("taxid", "<u4")])
# uint128_t is {uint64 LOWER, uint64 UPPER} on little-endian (uint128_t.hpp:74)
REC_128 = np.dtype([("lo", "<u8"), ("hi", "<u8"), ("taxid", "<u4")])
REC_HALF = np.dtype([("suffix", "<u4"), ("taxidx", "<u2")])
REC_TRIE = np.dtype([("count", "<u8"), ("prefix", "<u4")])

INDEX_TYPE_64 = 0
INDEX_TYPE_128 = 128
INDEX_TYPE_HALF = 3


def read_info(path: str) -> tuple[int, int]:
    """<idx>_info.txt -> (num_entries, index_type)."""
    with open(path + "_info.txt") as fh:
        tokens = fh.read().split()
    n = int(tokens[0])
    itype = int(tokens[1]) if len(tokens) > 1 else INDEX_TYPE_64
    return n, itype


def write_info(path: str, n: int, itype: int = INDEX_TYPE_64):
    with open(path + "_info.txt", "w") as fh:
        fh.write(str(n))
        if itype == INDEX_TYPE_128:
            fh.write("\n128")
        elif itype == INDEX_TYPE_HALF:
            fh.write("\n3")


def _write_blocks(path: str, rec: np.ndarray, block: int) -> None:
    """rec's bytes, zero-padded to whole stxxl blocks."""
    nbytes = rec.nbytes
    with open(path, "wb") as fh:
        rec.tofile(fh)
        fh.write(b"\x00" * (-(-max(nbytes, 1) // block) * block - nbytes))


def write_index(path: str, limbs: np.ndarray, taxids: np.ndarray,
                highest_k: int = 12):
    """Sorted (N, L) limbs + taxids (N,) -> packed index + info: 64-bit
    records for highest_k <= 12, 128-bit ones above."""
    if highest_k <= 12:
        rec = np.empty(len(taxids), dtype=REC_64)
        rec["kmer"] = kmer.limbs_to_u64(limbs)
        block, itype = BLOCK_64, INDEX_TYPE_64
    else:
        hi, lo = kmer.limbs_to_u128_parts(limbs)
        rec = np.empty(len(taxids), dtype=REC_128)
        rec["lo"], rec["hi"] = lo, hi
        block, itype = BLOCK_128, INDEX_TYPE_128
    rec["taxid"] = taxids.astype(np.uint32)
    _write_blocks(path, rec, block)
    write_info(path, len(taxids), itype)


def write_index_packed(path: str, keys: np.ndarray, taxids: np.ndarray):
    """64-bit write_index from packed u64 keys (the build's native path
    keeps its keys packed end to end)."""
    rec = np.empty(len(taxids), dtype=REC_64)
    rec["kmer"] = keys
    rec["taxid"] = taxids.astype(np.uint32)
    _write_blocks(path, rec, BLOCK_64)
    write_info(path, len(taxids), INDEX_TYPE_64)


def write_halved_index(path: str, suffixes: np.ndarray, taxidx: np.ndarray):
    """Halved records (u32 suffix of the last six letters, u16 content
    row) + info type 3."""
    rec = np.empty(len(suffixes), dtype=REC_HALF)
    rec["suffix"] = suffixes.astype(np.uint32)
    rec["taxidx"] = taxidx.astype(np.uint16)
    _write_blocks(path, rec, BLOCK_HALF)
    write_info(path, len(suffixes), INDEX_TYPE_HALF)


def write_tax_only(path: str, rows: np.ndarray):
    """Sloppy-mode (-j) `<idx>_taxOnly`: u16 dense content row per index
    entry, stxxl-block padded (taxaOnly typedef MetaHeader.h:142); the
    index file itself is then replaced by a copy (Read.hpp:3134-3151)."""
    rec = np.ascontiguousarray(rows, dtype="<u2")
    _write_blocks(path + "_taxOnly", rec, BLOCK_64)
    _write_blocks(path, rec, BLOCK_64)


def read_tax_only(path: str) -> np.ndarray:
    n, _ = read_info(path)
    return np.fromfile(path + "_taxOnly", dtype="<u2", count=n)


_READ_INDEX_CACHE: dict = {}


def read_index(path: str) -> tuple[np.ndarray, np.ndarray, int, int]:
    """-> (limbs (N, L) int32, taxids (N,) uint32, highest_k,
    index_type): 64-bit indices give L = 2 and highest_k 12, 128-bit ones
    L = 5 and highest_k 25.  A halved index gives its raw records: limb
    1 the stored suffix, limb 0 zero, the u16 taxon indices as taxids
    (read_halved_reconstructed rebuilds the full k-mers).

    One-entry RAM cache keyed by (path, mtime, size): repeated identify
    calls over the same index skip the artifact load."""
    n, itype = read_info(path)
    try:
        st = os.stat(path)
        key = (os.path.abspath(path), st.st_mtime_ns, st.st_size)
    except OSError:
        key = None
    if key is not None and key in _READ_INDEX_CACHE:
        return _READ_INDEX_CACHE[key]
    if itype == INDEX_TYPE_128:
        rec = np.fromfile(path, dtype=REC_128, count=n)
        out = (kmer.u128_parts_to_limbs(rec["hi"], rec["lo"]),
               rec["taxid"].copy(), 25, itype)
    elif itype == INDEX_TYPE_HALF:
        rec = np.fromfile(path, dtype=REC_HALF, count=n)
        limbs = np.zeros((n, 2), dtype=np.int32)
        limbs[:, 1] = rec["suffix"].astype(np.int32)
        out = (limbs, rec["taxidx"].astype(np.uint32), 12, itype)
    else:
        rec = np.fromfile(path, dtype=REC_64, count=n)
        out = (kmer.u64_to_limbs(rec["kmer"]), rec["taxid"].copy(), 12,
               itype)
    if key is not None:
        _READ_INDEX_CACHE.clear()
        _READ_INDEX_CACHE[key] = out
    return out


def write_trie(path: str, prefixes: np.ndarray, counts: np.ndarray):
    """RLE prefix table -> <idx>_trie + <idx>_trie.txt (Trie.hpp:366-394)."""
    rec = np.empty(len(prefixes), dtype=REC_TRIE)
    rec["count"] = counts.astype(np.uint64)
    rec["prefix"] = prefixes.astype(np.uint32)
    nbytes = rec.nbytes
    total = -(-max(nbytes, 1) // BLOCK_64) * BLOCK_64
    with open(path + "_trie", "wb") as fh:
        rec.tofile(fh)
        if total > nbytes:
            fh.write(b"\x00" * (total - nbytes))
    with open(path + "_trie.txt", "w") as fh:
        fh.write(str(len(prefixes)))


def read_trie(path: str) -> tuple[np.ndarray, np.ndarray]:
    """<idx>_trie -> (prefixes (P,) uint32, counts (P,) uint64)."""
    with open(path + "_trie.txt") as fh:
        n = int(fh.read().split()[0])
    rec = np.fromfile(path + "_trie", dtype=REC_TRIE, count=n)
    return rec["prefix"].copy(), rec["count"].copy()


def read_halved_reconstructed(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Full (limbs (N, 2) int32, taxon rows (N,) int32) of a halved
    index: each entry's prefix comes from the trie RLE, expanded
    cumulatively as Trie::LoadFromStxxlVec does (Trie.hpp:415-447);
    entries beyond the trie counts (the one lost to the reference's
    last-record quirk) are dropped (kasa_tpu/index/shrink.py:193)."""
    n, itype = read_info(path)
    if itype != INDEX_TYPE_HALF:
        raise ValueError(f"{path} is not a halved index")
    rec = np.fromfile(path, dtype=REC_HALF, count=n)
    prefixes, counts = read_trie(path)
    total = int(counts.sum())
    suffix = rec["suffix"][:total].astype(np.uint64)
    rows = rec["taxidx"][:total].astype(np.int32)
    prefix_per_entry = np.repeat(prefixes.astype(np.uint64),
                                 counts.astype(np.int64))
    keys = (prefix_per_entry << np.uint64(30)) | suffix
    return kmer.u64_to_limbs(keys), rows


def trie_from_sorted_prefixes(prefix_limb: np.ndarray
                              ) -> tuple[np.ndarray, np.ndarray]:
    """limb0 column (sorted) -> (unique prefixes, run lengths)."""
    n = len(prefix_limb)
    if n == 0:
        return np.zeros(0, np.uint32), np.zeros(0, np.uint64)
    starts = np.r_[0, np.nonzero(prefix_limb[1:] != prefix_limb[:-1])[0] + 1]
    counts = np.diff(np.r_[starts, n])
    return prefix_limb[starts].astype(np.uint32), counts.astype(np.uint64)


def write_frequency_file(path: str, content_entries, freq: np.ndarray):
    """freq: (num_taxa+1, maxNumK) uint64, row 0 = "non_unique".

    Columns are written k = highestK .. lowestK (kASA.hpp:547-570)."""
    with open(path + "_f.txt", "w") as fh:
        fh.write("non_unique")
        for v in freq[0]:
            fh.write(f"\t{int(v)}")
        fh.write("\n")
        for row, entry in zip(freq[1:], content_entries):
            fh.write(entry.name.replace(",", ""))
            for v in row:
                fh.write(f"\t{int(v)}")
            fh.write("\n")


def read_frequency_file(path: str) -> tuple[list, np.ndarray]:
    names, rows = [], []
    with open(path + "_f.txt") as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line:
                continue
            parts = line.split("\t")
            names.append(parts[0])
            rows.append([int(x) for x in parts[1:]])
    return names, np.asarray(rows, dtype=np.uint64)
