"""shrink mode -- three strategies (Shrink.hpp:24-30, 313-511); port of
kasa_tpu/index/shrink.py (the halved index's reader is
index/artifacts.py read_halved_reconstructed):

  1 EveryNth:  drop g%% of k-mers per taxon, round-robin
               (deleteEveryNth, Shrink.hpp:270-307)
  2 TrieHalf:  lossless halving -- move the 6-letter prefix into the
               trie file, store (low-30-bit suffix u32, taxon index u16)
               (putHalfInTrie, Shrink.hpp:78-143); k in [7,12], <=65535
               taxa; info type tag 3
  3 Entropy:   drop k-mers with normalized letter entropy <= 0.5
               (deleteViaEntropy, Shrink.hpp:152-232)

Including the reference's quirks: the halved trie's LAST record stores
count-1 (count 1 if the last prefix is a singleton) so the final index
entry is unreachable (Shrink.hpp:126-131), and strategies 1/3 write the
frequency file with raw (not comma-stripped) names over every content
row.
"""

from __future__ import annotations

import math
import shutil

import numpy as np

from ..config import Config
from ..core import kmer
from . import artifacts

SUFFIX_MASK = np.uint64((1 << 30) - 1)
CARET6 = np.uint64(1039104990)  # "^^^^^^" in the low 30 bits (Shrink.hpp:108)


def _load_content_maps(path: str):
    """taxid->dense idx and idx->raw name (ShrinkLib, Shrink.hpp:325-348)."""
    ids_as_idx = {0: 0}
    idx_to_name = {0: "non_unique"}
    taxids_as_strings = False
    counter = 1
    with open(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line:
                continue
            parts = line.split("\t")
            if len(parts) >= 5 and not taxids_as_strings:
                taxids_as_strings = True
            if len(parts) >= 4:
                key = int(parts[4]) if taxids_as_strings else int(parts[1])
                ids_as_idx[key] = counter
                idx_to_name[counter] = parts[0]
                counter += 1
    return ids_as_idx, idx_to_name, counter


def _count_freqs(keys: np.ndarray, rows: np.ndarray, num_rows: int,
                 highest_k: int) -> np.ndarray:
    """countFreqs (Shrink.hpp:252-265): freq[row][j] counts kept entries
    whose letter at shift 5*j != '^'; j=0 <-> k=highestK."""
    freq = np.zeros((num_rows, highest_k), dtype=np.uint64)
    for j in range(highest_k):
        valid = ((keys >> np.uint64(5 * j)) & np.uint64(31)) != 30
        np.add.at(freq[:, j], rows[valid], 1)
    return freq


def _write_shrink_freq(path: str, idx_to_name: dict, freq: np.ndarray):
    """Frequency writer of strategies 1/3 (Shrink.hpp:407-415): every
    content row, raw names."""
    with open(path + "_f.txt", "w") as fh:
        for j in range(freq.shape[0]):
            fh.write(idx_to_name[j])
            for v in freq[j]:
                fh.write(f"\t{int(v)}")
            fh.write("\n")


def shrink_index(cfg: Config):
    index_in = cfg.index_file
    out_path = cfg.db_out
    if index_in == out_path:
        raise RuntimeError("Paths and names of input and output are the same!")
    content = cfg.content_file or index_in + "_content.txt"
    ids_as_idx, idx_to_name, num_rows = _load_content_maps(content)

    limbs, taxids, highest_k, itype = artifacts.read_index(index_in)
    strategy = cfg.shrink_strategy
    if strategy == 2:
        if itype != artifacts.INDEX_TYPE_64:
            raise RuntimeError("This index is either already halved or of a "
                               "type which cannot be halved. Sorry...")
        if num_rows > 65535:
            raise RuntimeError("Index can only be halved, if less than 65535 "
                               "species are inside the index!")
        return _shrink_half(limbs, taxids, ids_as_idx, index_in, out_path)

    keys = kmer.limbs_to_u64(limbs) if highest_k <= 12 else None
    rows = np.array([ids_as_idx[int(t)] for t in taxids], dtype=np.int64)

    if strategy == 1:
        keep = _every_nth_keep(rows, num_rows, abs(cfg.shrink_percentage))
    elif strategy == 3:
        keep = _entropy_keep(limbs, highest_k)
    else:
        raise RuntimeError("Not implemented yet")  # Overrepresented stub (Shrink.hpp:237-249)

    out_limbs, out_tax, out_rows = limbs[keep], taxids[keep], rows[keep]
    if keys is None:
        # 128-bit: compute letter validity from limbs
        freq = np.zeros((num_rows, highest_k), dtype=np.uint64)
        for j in range(highest_k):
            letters = kmer.letter_at(out_limbs, highest_k - 1 - j, highest_k)
            valid = letters != 30
            np.add.at(freq[:, j], out_rows[valid], 1)
    else:
        freq = _count_freqs(keys[keep], out_rows, num_rows, highest_k)

    artifacts.write_index(out_path, out_limbs, out_tax, highest_k)
    prefixes, counts = artifacts.trie_from_sorted_prefixes(out_limbs[:, 0])
    artifacts.write_trie(out_path, prefixes, counts)
    _write_shrink_freq(out_path, idx_to_name, freq)


def _every_nth_keep(rows: np.ndarray, num_rows: int, percent: float) -> np.ndarray:
    """deleteEveryNth (Shrink.hpp:270-307): per-taxon counter starting
    at 1; drop when it equals the truncated next-throw-out mark."""
    step = 100.0 / np.float32(percent)
    steps = np.ones(num_rows + 1, dtype=np.int64)
    nxt = np.full(num_rows + 1, step, dtype=np.float64)
    keep = np.ones(len(rows), dtype=bool)
    for i, idx in enumerate(rows):
        if steps[idx] == int(nxt[idx]):
            keep[i] = False
            nxt[idx] += step
        steps[idx] += 1
    return keep


def _entropy_keep(limbs: np.ndarray, highest_k: int) -> np.ndarray:
    """deleteViaEntropy (Shrink.hpp:152-232): keep whole equal-k-mer
    groups whose normalized letter entropy exceeds 0.5."""
    n = len(limbs)
    keep = np.zeros(n, dtype=bool)
    new = np.r_[True, np.any(limbs[1:] != limbs[:-1], axis=1)]
    group_starts = np.nonzero(new)[0]
    group_ends = np.r_[group_starts[1:], n]
    # letters (G, highest_k) for one representative per group
    reps = limbs[group_starts]
    letters = np.stack([kmer.letter_at(reps, p, highest_k)
                        for p in range(highest_k)], axis=1)
    for g in range(len(group_starts)):
        # float32 summands * log2(float32), summed in double (Shrink.hpp:186-200)
        _, counts = np.unique(letters[g], return_counts=True)
        h2 = 0.0
        for c in counts:
            s = np.float32(np.float32(c) / np.float32(highest_k))
            h2 += float(np.float32(s * np.log2(s)))
        entropy = (-h2 * math.log(2.0)) / math.log(22.0)
        if entropy > 0.5:
            keep[group_starts[g]:group_ends[g]] = True
    return keep


def _shrink_half(limbs: np.ndarray, taxids: np.ndarray, ids_as_idx: dict,
                 index_in: str, out_path: str):
    """putHalfInTrie (Shrink.hpp:78-143) + ShrinkLib TrieHalf arm
    (Shrink.hpp:436-452)."""
    keys = kmer.limbs_to_u64(limbs)
    suffixes = keys & SUFFIX_MASK
    kept = suffixes != CARET6
    k_keys = keys[kept]
    k_suffix = (k_keys & SUFFIX_MASK).astype(np.uint32)
    k_rows = np.array([ids_as_idx[int(t)] for t in taxids[kept]], dtype=np.uint16)
    prefixes = (k_keys >> np.uint64(30)).astype(np.uint32)

    artifacts.write_halved_index(out_path, k_suffix, k_rows)

    # trie RLE with the reference's last-record quirk
    if len(prefixes):
        change = np.r_[np.nonzero(prefixes[1:] != prefixes[:-1])[0] + 1, len(prefixes)]
        starts = np.r_[0, change[:-1]]
        run_prefix = prefixes[starts]
        run_count = (change - starts).astype(np.uint64)
        last = len(run_count) - 1
        run_count[last] = run_count[last] - 1 if run_count[last] > 1 else 1
        artifacts.write_trie(out_path, run_prefix, run_count)
    else:
        artifacts.write_trie(out_path, np.zeros(0, np.uint32), np.zeros(0, np.uint64))

    shutil.copyfile(index_in + "_f.txt", out_path + "_f.txt")

