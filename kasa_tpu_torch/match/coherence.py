"""--coherence post-processing (postProcess, Compare.hpp:2607-2728);
host numpy, ported from kasa_tpu/match/coherence.py.

In post-process mode every emitted k-mer window carries (readID, frame,
position) and the matcher records the LARGEST k at which it matched the
index (setMatchLength, MetaHeader.h:184; called throughout the walk,
e.g. Compare.hpp:948, final write wins = largest matched k since
_aOfK[i] = maxK - i iterates k ascending).  The post-process then sorts
matches by (readID, frame, position) and scans for maximal overlapping
match clusters; a read's coherence is

    max over clusters of (maxOverlap + 1 - 1/countOfMax).

The walk below replicates the reference exactly, including its quirks:
countOfMax is NOT reset between clusters of the same frame (only at
read/frame boundaries), zero-length entries advance the scan without
updating the cluster end, and an empty cluster flush computes
``overlap + 1 - 1/0`` = -inf in float arithmetic (a no-op under max).
"""

from __future__ import annotations

import numpy as np


def max_match_lengths(idx_keys: np.ndarray, q_keys: np.ndarray,
                      min_k: int, max_k: int, highest_k: int) -> np.ndarray:
    """Per query k-mer: the largest valid k in [min_k, max_k] whose
    k-prefix exists in the sorted index (0 if none).  Validity: no '^'
    letter in positions [min_k-1, k-1] (Compare.hpp:836, 897).  Queries
    need not be sorted."""
    M = len(q_keys)
    out = np.zeros(M, dtype=np.int32)
    N = len(idx_keys)
    if N == 0 or M == 0:
        return out
    ok = np.ones(M, dtype=bool)
    for j, k in enumerate(range(min_k, max_k + 1)):
        pos = min_k - 1 + j
        letters = (q_keys >> np.uint64(5 * (highest_k - 1 - pos))) & np.uint64(31)
        ok = ok & (letters != 30)
        shift = np.uint64(5 * (highest_k - k))
        ip = idx_keys >> shift
        qp = q_keys >> shift
        lo = np.searchsorted(ip, qp, side="left")
        matched = (lo < N) & (ip[np.minimum(lo, N - 1)] == qp) & ok
        out[matched] = k
    return out


def coherence_scores(read_ids: np.ndarray, frames: np.ndarray,
                     positions: np.ndarray, match_lens: np.ndarray,
                     num_reads: int, six_frames: bool) -> np.ndarray:
    """Faithful replica of postProcess (Compare.hpp:2607-2728)."""
    scores = np.zeros(num_reads, dtype=np.float32)
    n = len(read_ids)
    if n == 0:
        return scores
    order = np.lexsort((positions, frames, read_ids))
    rid = read_ids[order]
    frm = frames[order]
    pos = positions[order].astype(np.int64)
    mlen = match_lens[order].astype(np.int64)

    idx = 0
    last_end = 0
    cur_overlap = 0
    count_of_max = 0

    # find first match (Compare.hpp:2635-2647)
    read = 0
    while idx < n:
        if mlen[idx] != 0:
            read = int(rid[idx])
            last_end = int(pos[idx] + mlen[idx])
            idx += 1
            break
        idx += 1

    def flush(read_id: int):
        nonlocal cur_overlap
        cand = (np.float32(cur_overlap) + np.float32(1.0)
                - (np.float32(np.inf) if count_of_max == 0
                   else np.float32(1.0) / np.float32(count_of_max)))
        if read_id < num_reads:
            scores[read_id] = max(scores[read_id], cand)

    def bump(next_overlap: int):
        nonlocal cur_overlap, count_of_max
        if next_overlap > cur_overlap:
            cur_overlap = next_overlap
            count_of_max = 1
        elif next_overlap == cur_overlap:
            count_of_max += 1

    while read < num_reads and idx < n:
        fb = 0
        while fb < 1 + int(six_frames):
            if idx >= n:   # trailing zero-length entries exhausted input
                break      # (the reference would throw std::out_of_range)
            ml = int(mlen[idx])
            if ml != 0:
                p = int(pos[idx])
                if p <= last_end:
                    if p + ml < last_end:
                        bump(ml)
                    else:
                        bump(last_end - p)
                else:
                    flush(read)
                    cur_overlap = 0
                last_end = p + ml

            idx += 1
            if idx == n:
                flush(read)
                break
            if int(rid[idx]) != read:
                flush(read)
                last_end = (1 << 32) - 1
                cur_overlap = 0
                count_of_max = 0
                break
            if int(frm[idx]) != fb:
                flush(read)
                cur_overlap = 0
                count_of_max = 0
                fb += 1
                while idx < n:
                    if mlen[idx] != 0:
                        last_end = int(pos[idx] + mlen[idx])
                        idx += 1
                        break
                    idx += 1
        read += 1
    return scores
