"""Reference-exact identify scoring (bit-for-bit float parity).
(a copy of kasa_tpu/match/exact.py: numpy on the host, no device work)

The reference's hot loop (compareWithDatabase, Compare.hpp:679-1069) is a
stateful merge-join whose float accumulation ORDER (and two AVX
batching quirks) determine the low bits of every score.  This module
reproduces those semantics without simulating the walk, using the
derived event model:

* Per trie range and per k in [minK, maxK], the walk opens one "group"
  per distinct matched k-prefix and flushes it when the NEXT group at
  that level opens (Compare.hpp:907-955) or at range end in k-ascending
  order (Compare.hpp:1032-1041).  Flush order is therefore sortable by
  (opening query position, is-opener, k).
* A flush adds, per taxon t of the group (insertion order = ascending
  first occurrence in the index segment, sBitArray BitArray.hpp:98-146):
    - counts_all[k][t]    += double(H)/T        (scoreMatch*, double)
    - counts_unique[k][t] += H        if T == 1
    - counts_total[k][t]  += 1        (--coverage)
    - score matrix adds of w(k)*(1.f/T) with
      - T <= 3 (scoreMatchNonAVX, Compare.hpp:516-532): one sequential
        float32 add per occurrence of each read in the hit list;
      - T > 3  (scoreMatchAVX, Compare.hpp:534-597): the hit list is
        re-walked from the START for each taxon into a shared 8-slot
        block; a taxon's chunk is min(H, 8 - fill) pairs, surplus
        occurrences are DROPPED for that taxon, and duplicate cells
        within one block collapse to a single add (load-before-add).
        Both quirks are reproduced faithfully.
* An occurrence participates at level k iff its k-prefix exists in the
  index and no query letter in positions [minK-1, k-1] is '^'
  (Compare.hpp:836, 897).

The final per-cell accumulation replays every add in flush order with a
sequential float32 (float64 for counts) left fold via a padded
``np.add.accumulate`` so rounding matches C++ exactly.

64-bit keys only (highestK == 12); the 128-bit path uses the fast
engine (match/join.py).
"""

from __future__ import annotations

import numpy as np

from .join import weight


class ExactResult:
    def __init__(self, num_k: int, num_species: int, num_reads: int):
        self.scores = np.zeros((num_reads, num_species), dtype=np.float32)
        self.counts_all = np.zeros((num_k, num_species), dtype=np.float64)
        self.counts_unique = np.zeros((num_k, num_species), dtype=np.uint64)
        self.counts_total = np.zeros((num_k, num_species), dtype=np.uint64)


def _rank_prefixes(idx_limbs: np.ndarray, q_limbs: np.ndarray,
                   mask: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Dense order-preserving surrogate keys for masked limb rows --
    the 128-bit path's replacement for u64 prefix shifts.  Rank arrays
    preserve ordering and equality, so searchsorted/grouping semantics
    are unchanged."""
    im = idx_limbs & mask
    qm = q_limbs & mask
    comb = np.concatenate([im, qm])
    order = np.lexsort(tuple(comb[:, i] for i in range(comb.shape[1] - 1, -1, -1)))
    rows = comb[order]
    new = np.r_[True, np.any(rows[1:] != rows[:-1], axis=1)]
    ranks_sorted = np.cumsum(new) - 1
    ranks = np.empty(len(comb), dtype=np.int64)
    ranks[order] = ranks_sorted
    return ranks[:len(im)], ranks[len(im):]


def exact_identify_batch(
    idx_keys: np.ndarray | None,  # (N,) uint64 sorted index k-mers (64-bit path)
    idx_tax_rows: np.ndarray,     # (N,) int32 species rows
    q_keys: np.ndarray | None,    # (M,) uint64 sorted query k-mers
    read_ids: np.ndarray,         # (M,) int32
    min_k: int,
    max_k: int,
    highest_k: int,
    num_reads: int,
    num_species: int,
    coverage: bool = False,
    want_scores: bool = True,
    idx_limbs: np.ndarray | None = None,   # 128-bit path: (N, L) / (M, L)
    q_limbs: np.ndarray | None = None,
) -> ExactResult:
    from ..core import kmer as kmer_mod

    num_k = max_k - min_k + 1
    res = ExactResult(num_k, num_species, num_reads)
    use_limbs = idx_keys is None
    M = len(q_limbs) if use_limbs else len(q_keys)
    N = len(idx_limbs) if use_limbs else len(idx_keys)
    if M == 0 or N == 0:
        return res

    def prefix(keys, k):
        return keys >> np.uint64(5 * (highest_k - k))

    # validity: letters at positions minK-1 .. maxK-1 must not be '^'(30)
    ok = np.empty((M, num_k), dtype=bool)
    for j in range(num_k):
        pos = min_k - 1 + j
        if use_limbs:
            letters = kmer_mod.letter_at(q_limbs, pos, highest_k)
        else:
            letters = (q_keys >> np.uint64(5 * (highest_k - 1 - pos))) & np.uint64(31)
        ok[:, j] = letters != 30
    cum_ok = np.cumprod(ok, axis=1).astype(bool)   # column j -> k = minK+j

    # per-level match data
    level = {}
    for k in range(min_k, max_k + 1):
        if use_limbs:
            ip, qp = _rank_prefixes(idx_limbs, q_limbs,
                                    kmer_mod.prefix_masks(highest_k, k))
        else:
            ip = prefix(idx_keys, k)
            qp = prefix(q_keys, k)
        lo = np.searchsorted(ip, qp, side="left")
        matched = (lo < N) & (ip[np.minimum(lo, N - 1)] == qp)
        level[k] = (qp, ip, matched)

    # trie ranges: keyed on the first min(minK, 6) letters
    # (sortInputAndCheckInvalidkMers_sta, Compare.hpp:1086/1109)
    kr = min(min_k, 6)
    if use_limbs:
        ipr, rp = _rank_prefixes(idx_limbs, q_limbs,
                                 kmer_mod.prefix_masks(highest_k, kr))
    else:
        rp = prefix(q_keys, kr)
        ipr = prefix(idx_keys, kr)
    lo_r = np.searchsorted(ipr, rp, side="left")
    matched_r = (lo_r < N) & (ipr[np.minimum(lo_r, N - 1)] == rp)
    ridx = np.nonzero(matched_r)[0]
    if len(ridx) == 0:
        return res
    rvals = rp[ridx]
    range_starts = ridx[np.r_[True, rvals[1:] != rvals[:-1]]]   # positions opening a new range

    # ---- build flush events
    events = []  # (flush_pos, tag, k_asc, k, run_prefix, occ_positions)
    for k in range(min_k, max_k + 1):
        qp, ip, matched = level[k]
        vmask = matched & cum_ok[:, k - min_k]
        pos = np.nonzero(vmask)[0]
        if len(pos) == 0:
            continue
        pp = qp[pos]
        starts = np.nonzero(np.r_[True, pp[1:] != pp[:-1]])[0]
        ends = np.r_[starts[1:], len(pos)]
        run_range = rp[pos[starts]]
        for i in range(len(starts)):
            occ = pos[starts[i]:ends[i]]
            if i + 1 < len(starts) and run_range[i + 1] == run_range[i]:
                key = (int(pos[ends[i]]), 1, k - min_k)
            else:
                j = np.searchsorted(range_starts, occ[0], side="right") - 1
                bpos = int(range_starts[j + 1]) if j + 1 < len(range_starts) else M
                key = (bpos, 0, k - min_k)
            events.append((key, k, int(pp[starts[i]]), occ))
    events.sort(key=lambda e: e[0])

    # ---- replay events
    score_cells, score_vals = [], []
    count_cells, count_vals = [], []
    S = num_species
    for (key, k, pfx, occ) in events:
        ki = max_k - k            # profile row index (0 = maxK)
        qp, ip, _ = level[k]
        a = int(np.searchsorted(ip, ip.dtype.type(pfx), side="left"))
        b = int(np.searchsorted(ip, ip.dtype.type(pfx), side="right"))
        seg_tax = idx_tax_rows[a:b]
        uniq, first_pos = np.unique(seg_tax, return_index=True)
        taxa = uniq[np.argsort(first_pos, kind="stable")].astype(np.int64)
        T = len(taxa)
        H = len(occ)
        reads = read_ids[occ].astype(np.int64)

        counts_val = np.float64(H) / np.float64(T)
        count_cells.append(ki * S + taxa)
        count_vals.append(np.full(T, counts_val))
        if T == 1:
            res.counts_unique[ki, taxa[0]] += np.uint64(H)
        if coverage:
            np.add.at(res.counts_total[ki], taxa, 1)

        if want_scores:
            score = np.float32(weight(k) * np.float32(np.float32(1.0) / np.float32(T)))
            if T <= 3:
                # sequential adds: per taxon, one add per occurrence
                cells = (reads[None, :] * S + taxa[:, None]).ravel()
                score_cells.append(cells)
                score_vals.append(np.full(cells.shape, score, dtype=np.float32))
            else:
                # AVX path: per taxon only the first min(H, 8-fill)
                # occurrences enter the shared block; duplicate cells in
                # a block collapse to one add.
                B = 0
                cel = []
                for t in taxa:
                    m = min(H, 8 - B)
                    chunk_reads = np.unique(reads[:m])
                    cel.append(chunk_reads * S + t)
                    B = 0 if B + m == 8 else B + m
                cells = np.concatenate(cel)
                score_cells.append(cells)
                score_vals.append(np.full(cells.shape, score, dtype=np.float32))

    # ---- exact sequential folds
    if count_cells:
        flat = res.counts_all.reshape(-1)
        _fold_cells(flat, np.concatenate(count_cells),
                    np.concatenate(count_vals))
    if want_scores and score_cells:
        flat = res.scores.reshape(-1)
        _fold_cells(flat, np.concatenate(score_cells),
                    np.concatenate(score_vals).astype(np.float32))
    return res


def _fold_cells(flat: np.ndarray, cells: np.ndarray, values: np.ndarray):
    """Sequential per-cell left fold of `values` (already in add order)."""
    order = np.argsort(cells, kind="stable")
    c, v = cells[order], values[order].astype(flat.dtype)
    first = np.r_[True, c[1:] != c[:-1]]
    seg_ids = np.cumsum(first) - 1
    seg_start = np.nonzero(first)[0]
    width = int(np.diff(np.r_[seg_start, len(c)]).max())
    ncell = len(seg_start)
    pad = np.zeros((ncell, width + 1), dtype=flat.dtype)
    pad[:, 0] = flat[c[seg_start]]
    col = np.arange(len(c)) - seg_start[seg_ids] + 1
    pad[seg_ids, col] = v
    acc = np.add.accumulate(pad, axis=1, dtype=flat.dtype)
    flat[c[seg_start]] = acc[:, -1]
