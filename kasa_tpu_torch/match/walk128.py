"""Faithful walk emulation of compareWithDatabase for 128-bit indices.
(a copy of kasa_tpu/match/walk128.py: pure Python, no device work)

The reference declares its comparison functor as
``function<uint8_t(const uint64_t&, const uint64_t&, const int32_t&)>``
(Compare.hpp:700) while the 128-bit instantiation passes uint128
prefixes -- every compare() therefore TRUNCATES both operands to their
low 64 bits, while the two lower_bound searches (Compare.hpp:824, 980)
use true uint128 comparisons.  The resulting behavior (spurious
equalities at k >= 13, phantom hit-list entries whose unwritten slots
score read id 0, etc.) cannot be captured by the clean group/event
model, so for bit parity this module ports the walk statement by
statement (Compare.hpp:679-1069), including:

  * the 100-slot vReadIDs resize leaving unwritten zeros that the
    flush scores as read 0 (Compare.hpp:721-728),
  * the AVX hit-list truncation / in-block dedup for T > 3 groups
    (scoreMatchAVX, Compare.hpp:534-597),
  * sequential float32 / float64 accumulation order.

k-mers are Python ints (arbitrary precision stands in for uint128).
This is the compatibility engine for 128-bit identify; the clean fast
engine (match/join.py / device.py) implements the intended semantics.
"""

from __future__ import annotations

import numpy as np

U64 = (1 << 64) - 1


class Walk128Result:
    def __init__(self, num_k: int, num_species: int, num_reads: int):
        self.scores = np.zeros((num_reads, num_species), dtype=np.float32)
        self.counts_all = np.zeros((num_k, num_species), dtype=np.float64)
        self.counts_unique = np.zeros((num_k, num_species), dtype=np.uint64)
        self.counts_total = np.zeros((num_k, num_species), dtype=np.uint64)


def _compare_trunc(a: int, b: int) -> int:
    """compareTwoKmers through the uint64-typed std::function: 0 in<idx,
    1 equal, 2 in>idx -- on the LOW 64 BITS only."""
    a &= U64
    b &= U64
    if a < b:
        return 0
    if a == b:
        return 1
    return 2


def walk_identify_128(
    idx_keys: list,            # sorted python-int kmers (125 bits)
    idx_tax_rows: np.ndarray,  # (N,) int32 species rows
    q_keys: list,              # sorted python-int query kmers
    read_ids: np.ndarray,      # (M,) int32
    min_k: int,
    max_k: int,
    highest_k: int,            # 25
    num_reads: int,
    num_species: int,
    coverage: bool = False,
    want_scores: bool = True,
    vis: list | None = None,           # --visualize sink: (lib_kmer>>shift, k, raw_taxid)
    idx_raw_tax: np.ndarray | None = None,  # raw taxids for vis entries
) -> Walk128Result:
    num_k = max_k - min_k + 1
    res = Walk128Result(num_k, num_species, num_reads)
    N, M = len(idx_keys), len(q_keys)
    if N == 0 or M == 0:
        return res
    ks = [max_k - i for i in range(num_k)]          # _aOfK
    shifts = [5 * (highest_k - k) for k in ks]

    scores = res.scores

    def flush(ik: int, taxa: list, hits: list, positions: int):
        T = len(taxa)
        H = positions
        if T == 0:
            return
        ki = ik  # _aOfK index == profile row (0 = maxK)
        w = np.float32(np.float32(ks[ik] * ks[ik]) / np.float32(625.0))
        score = np.float32(w * np.float32(np.float32(1.0) / np.float32(T)))
        counts = np.float64(H) / np.float64(T)
        # hit list with the resize-zeros quirk: slots beyond written
        # entries read as stored (list already models the vector)
        hl = hits[:H] + [0] * max(0, H - len(hits))
        if want_scores and T > 3:
            # scoreMatchAVX: 8-slot blocks, per-taxon chunk min(H, 8-B)
            B = 0
            for t in taxa:
                m = min(H, 8 - B)
                seen_cells = set()
                for r in hl[:m]:
                    if r not in seen_cells:
                        scores[r, t] = np.float32(scores[r, t] + score)
                        seen_cells.add(r)
                res.counts_all[ki, t] += counts
                if coverage:
                    res.counts_total[ki, t] += 1
                B = 0 if B + m == 8 else B + m
        else:
            for t in taxa:
                res.counts_all[ki, t] += counts
                if coverage:
                    res.counts_total[ki, t] += 1
                if T == 1:
                    res.counts_unique[ki, t] += np.uint64(H)
                if want_scores:
                    for r in hl:
                        scores[r, t] = np.float32(scores[r, t] + score)

    # ---- trie ranges on the first 6 letters (kmer >> 95 for 128-bit)
    kr = min(min_k, 6)
    shift_r = 5 * (highest_k - kr)
    # per query: (range_start, range_len) or None
    import bisect
    idx_prefix_r = [k >> shift_r for k in idx_keys]

    def get_range(qk: int):
        p = qk >> shift_r
        lo = bisect.bisect_left(idx_prefix_r, p)
        if lo >= N or idx_prefix_r[lo] != p:
            return None
        hi = bisect.bisect_right(idx_prefix_r, p)
        return (lo, hi - lo - 1)   # (start, length) with END INCLUSIVE at start+length

    ranges = [get_range(q) for q in q_keys]

    # vReadIDs backing stores persist across ranges (declared outside
    # the range loop, Compare.hpp:732); only positions/seen/taxa reset
    hit_lists = [[] for _ in range(num_k)]
    positions = [0] * num_k
    mem_seen = [0] * num_k
    taxa = [[] for _ in range(num_k)]
    taxa_sets = [set() for _ in range(num_k)]

    def add_hit(ik, rid):
        hl = hit_lists[ik]
        pos = positions[ik]
        if len(hl) <= pos:
            hl.extend([0] * (pos + 100 - len(hl)))
        hl[pos] = rid
        positions[ik] = pos + 1

    def mark(ik, row):
        if row not in taxa_sets[ik]:
            taxa_sets[ik].add(row)
            taxa[ik].append(row)

    vin = 0
    while vin < M:
        seen_range = ranges[vin]
        if seen_range is None:
            vin += 1
            continue
        range_start, range_len = seen_range
        in_start = vin
        while vin < M and (ranges[vin] == seen_range or ranges[vin] is None):
            vin += 1
        in_end = vin

        # reset per range (Compare.hpp:768-774)
        for j in range(num_k):
            positions[j] = 0
            mem_seen[j] = 0
            taxa[j] = []
            taxa_sets[j] = set()
        seen_input = 0
        it = range_start                            # seenResultIt
        range_end = range_start + range_len         # rangeEndIt (inclusive)
        determine_begin = True

        for i in range(in_start, in_end):
            if ranges[i] is None:
                continue
            cur = q_keys[i]
            rid = int(read_ids[i])
            cur_shift_min = cur >> shifts[num_k - 1]
            input_iterated = True

            # determine first occurrence (Compare.hpp:803-829)
            if (seen_input != cur and (idx_keys[min(it, N - 1)] >> shifts[num_k - 1]) != cur_shift_min
                    and determine_begin):
                if (idx_keys[range_start] >> shifts[num_k - 1]) == cur_shift_min:
                    it = range_start
                elif (idx_keys[range_end] >> shifts[num_k - 1]) == cur_shift_min:
                    t = 1
                    while (idx_keys[range_end - t] >> shifts[num_k - 1]) == cur_shift_min:
                        t += 1
                    it = range_end - (t - 1)
                else:
                    lo_p = idx_keys[range_start] >> shifts[num_k - 1]
                    hi_p = idx_keys[range_end] >> shifts[num_k - 1]
                    if cur_shift_min < lo_p or cur_shift_min > hi_p:
                        # Compare.hpp:819 continues BEFORE the
                        # bDetermineBeginForMatching=false at :830
                        continue
                    # true uint128 lower_bound (Compare.hpp:824)
                    a, b = range_start, range_end + 1
                    while a < b:
                        mid = (a + b) // 2
                        if (idx_keys[mid] >> shifts[num_k - 1]) < cur_shift_min:
                            a = mid + 1
                        else:
                            b = mid
                    it = a
            determine_begin = False

            # '^' early skip at minK (Compare.hpp:836)
            if (cur_shift_min & 31) == 30:
                continue

            # duplicate / exhausted path (Compare.hpp:841-853)
            if _compare_trunc(seen_input, cur) == 1 or it == range_end + 1:
                for ik in range(num_k - 1, -1, -1):
                    if _compare_trunc(cur >> shifts[ik], mem_seen[ik]) == 1:
                        add_hit(ik, rid)
                continue
            else:
                seen_input = cur

            breakout = False
            while it != range_end + 1 and not breakout:
                lib_key = idx_keys[it]
                lib_tax = int(idx_tax_rows[it])
                ik = num_k - 1
                while ik >= 0:
                    sh = shifts[ik]
                    cur_s = cur >> sh
                    lib_s = lib_key >> sh
                    cmp = _compare_trunc(cur_s, lib_s)
                    if cmp == 0:
                        if input_iterated:
                            for ik2 in range(ik, -1, -1):
                                if _compare_trunc(cur >> shifts[ik2], mem_seen[ik2]) == 1:
                                    add_hit(ik2, rid)
                                else:
                                    break
                        breakout = True
                        break
                    elif cmp == 1:
                        if (cur_s & 31) == 30:
                            breakout = True
                            break
                        if vis is not None:
                            # _matchedkMers push (Compare.hpp:902-904):
                            # the LIBRARY suffix at this k + raw taxid
                            vis.append((lib_s, ks[ik], int(idx_raw_tax[it])))
                        if _compare_trunc(cur_s, mem_seen[ik]) == 1:
                            mark(ik, lib_tax)
                            if input_iterated:
                                add_hit(ik, rid)
                        else:
                            flush(ik, taxa[ik], hit_lists[ik], positions[ik])
                            positions[ik] = 0
                            add_hit(ik, rid)
                            taxa[ik] = []
                            taxa_sets[ik] = set()
                            mark(ik, lib_tax)
                            mem_seen[ik] = cur_s
                        ik -= 1
                    else:
                        # index < input: forward skip (Compare.hpp:957-993);
                        # the guard at :963 is a RAW uint128 operator>
                        t = 1
                        while it + t != range_end + 1:
                            nxt = idx_keys[it + t]
                            if cur_s > (nxt >> sh):
                                until = num_k - 1
                                while until >= 0:
                                    if _compare_trunc(mem_seen[until], nxt >> shifts[until]) == 1:
                                        mark(until, int(idx_tax_rows[it + t]))
                                        until -= 1
                                    else:
                                        break
                                if until < num_k - 1:
                                    t += 1
                                else:
                                    # true uint128 lower_bound (Compare.hpp:980)
                                    a, b = it + t, range_end + 1
                                    while a < b:
                                        mid = (a + b) // 2
                                        if (idx_keys[mid] >> sh) < cur_s:
                                            a = mid + 1
                                        else:
                                            b = mid
                                    t = a - it
                                    break
                            else:
                                break
                        it += t
                        break
                if ik == -1:
                    it += 1
                input_iterated = False

        # range-end tail sweep (Compare.hpp:1007-1028)
        t = 0
        while it + t != range_end + 1 and it + t <= range_end:
            nxt = idx_keys[it + t]
            until = num_k - 1
            while until >= 0:
                if _compare_trunc(mem_seen[until], nxt >> shifts[until]) == 1:
                    mark(until, int(idx_tax_rows[it + t]))
                    until -= 1
                else:
                    break
            if until < num_k - 1:
                t += 1
            else:
                break

        # final flush, minK first (Compare.hpp:1032-1041)
        for ik in range(num_k - 1, -1, -1):
            flush(ik, taxa[ik], hit_lists[ik], positions[ik])

    return res
