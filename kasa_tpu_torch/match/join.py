"""The join engine (port of kasa_tpu/match/join.py): group tables over
the sorted index, the k-weighting, and the multi-k match + score of one
batch that --coverage and --engine join run.

For each k and each distinct k-prefix p of the index, T_p is the set of
distinct taxa of the entries whose k-prefix is p; a query occurrence
with prefix p adds w(k)/|T_p| to each of those taxa, with
w(k) = (k/25)^2 (Compare.hpp:392).  An occurrence counts at k while
none of its letters at positions min_k-1 .. k-1 is '^' (letter 30).

Per batch (match_and_score), on the device, each step a kernel with its
plain PyTorch version beside it (the wrappers take the plain version
for CPU tensors only):

  K12 query_sort (csrc/query_sort.cu): the batch's windows sorted by
      (limbs..., read id) -- kasa_tpu's lax.sort, join.py:225; where the
      read ids ascend it carries each window's position in the batch
      instead of its read id;
  K10 join_match (csrc/join_match.cu): per query and level, the match
      flag, group, T and d_tax start, and the '^' validity --
      kasa_tpu's _match_one_keff (join.py:175, over
      ops/search.py:30 searchsorted_limbs) and _letters_block (189);
      given the positions, also a head per window at its position (the
      taxon of its one-taxon levels and where its levels of several taxa
      begin, and for those its row in the key-order outputs);
  K11 join_scatter (csrc/join_scatter.cu): every valid occurrence adds
      w(k)/T to its read's score row for each of its group's T taxa --
      kasa_tpu's _score_scatter (join.py:200); from K10's heads in read
      order (a block per read, its row in shared memory) where the read
      ids ascend, else from K10's key-order outputs and the sorted read
      ids;

and on the host, as in kasa_tpu, the exact float64 group statistics of
the profile (counts_all, counts_unique and, under --coverage,
counts_total) and the -e dedup.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from ..core import kmer


def weight(k: int) -> np.float32:
    """w(k) = k^2/625 as float32 (the reference's tabulated literals)."""
    return np.float32(np.float32(k * k) / np.float32(625.0))


def map_tax_rows(taxids: np.ndarray, tax_to_row: dict) -> np.ndarray:
    """Vectorized taxid -> dense content row mapping: one searchsorted
    against the content file's sorted taxids (S entries), O(n log S).

    (np.unique(return_inverse=True) here cost ~13 s per identify call
    at 33M entries -- measured round 3; the dict itself is tiny.)"""
    if len(taxids) == 0:
        return np.zeros(0, np.int32)
    keys = np.fromiter(tax_to_row.keys(), dtype=np.int64,
                       count=len(tax_to_row))
    vals = np.fromiter(tax_to_row.values(), dtype=np.int32,
                       count=len(tax_to_row))
    kmax = int(keys.max(initial=0))
    kmin = int(keys.min(initial=0))
    if 0 <= kmin and kmax < (1 << 26):
        # dense LUT: one gather instead of searchsorted (which runs at
        # only ~6M queries/s on 33M-element int64 inputs)
        lut = np.full(kmax + 2, -1, np.int32)
        lut[keys] = vals
        rows = lut[np.minimum(taxids, kmax + 1).astype(np.int64)]
        if (rows < 0).any():
            missing = int(taxids[np.nonzero(rows < 0)[0][0]])
            raise KeyError(missing)
        return rows
    order = np.argsort(keys)
    keys, vals = keys[order], vals[order]
    q = taxids.astype(np.int64)
    idx = np.searchsorted(keys, q)
    idx = np.minimum(idx, len(keys) - 1)
    rows = vals[idx]
    bad = keys[idx] != q
    if bad.any():
        missing = int(taxids[np.nonzero(bad)[0][0]])
        raise KeyError(missing)   # same failure mode as the dict path
    return rows


@dataclass
class GroupTable:
    """Per-keff group structures over the sorted index, host numpy
    arrays (match/device.py StackedTables stacks and uploads them)."""
    keff: int
    grp_id: np.ndarray     # (N,) int32 group id per index entry
    grp_start: np.ndarray  # (G+1,) int32 offsets into d_tax
    d_tax: np.ndarray      # (T,) int32 distinct taxon rows per group
    mask: np.ndarray       # (L,) int32 prefix mask


def build_group_table(limbs: np.ndarray, tax_rows: np.ndarray,
                      highest_k: int, keff: int) -> GroupTable:
    mask = kmer.prefix_masks(highest_k, keff)
    masked = limbs & mask
    n = len(tax_rows)
    if n == 0:
        return GroupTable(keff, np.zeros(0, np.int32), np.zeros(1, np.int32),
                          np.zeros(0, np.int32), mask)
    new = np.empty(n, dtype=bool)
    new[0] = True
    new[1:] = np.any(masked[1:] != masked[:-1], axis=1)
    grp_id = np.cumsum(new, dtype=np.int32) - 1
    num_groups = int(grp_id[-1]) + 1
    # distinct (group, tax) pairs.  grp_id is already non-decreasing,
    # so sorting (grp_id << 24 | tax) ranks pairs lexicographically;
    # the native record sort replaces np.lexsort's stable argsorts
    # (~0.35 us/elem -- 6 levels x 197M entries cost ~13 min of the
    # r3 turbo-table build, VERDICT r3 weak #5)
    pair_grp = d_tax = None
    if n and grp_id[-1] < (1 << 28) and 0 <= int(tax_rows.min()) \
            and int(tax_rows.max()) < (1 << 24):
        from ..native import sort_kmer_tax
        packed = (grp_id.astype(np.uint64) << np.uint64(24)) \
            | tax_rows.astype(np.uint64)
        dummy = np.zeros(n, np.uint32)
        if sort_kmer_tax(packed, dummy, 52, os.cpu_count() or 1):
            first = np.empty(n, dtype=bool)
            first[0] = True
            first[1:] = packed[1:] != packed[:-1]
            pp = packed[first]
            d_tax = (pp & np.uint64((1 << 24) - 1)).astype(np.int32)
            pair_grp = (pp >> np.uint64(24)).astype(np.int32)
    if pair_grp is None:
        order = np.lexsort((tax_rows, grp_id))
        g_s, t_s = grp_id[order], tax_rows[order]
        first = np.empty(n, dtype=bool)
        first[0] = True
        first[1:] = (g_s[1:] != g_s[:-1]) | (t_s[1:] != t_s[:-1])
        d_tax = t_s[first].astype(np.int32)
        pair_grp = g_s[first]
    grp_start = np.searchsorted(pair_grp, np.arange(num_groups + 1)).astype(np.int32)
    return GroupTable(keff, grp_id, grp_start, d_tax, mask)


class DeviceIndex:
    """The sorted index and its per-k group tables (kasa_tpu join.py:150).
    The group tables stay host numpy arrays (StackedTables stacks and
    uploads them); idx_limbs is also a tensor on `device`.  tax_rows, the
    dense content row of every entry, is mapped from taxids when not
    given (a halved index carries its rows)."""

    def __init__(self, limbs: np.ndarray, taxids: np.ndarray,
                 tax_to_row: dict, highest_k: int, min_k: int, max_k: int,
                 num_species: int, device, tax_rows: np.ndarray | None = None):
        from ..ops.search import num_steps_for
        self.highest_k = highest_k
        self.min_k = min_k
        self.max_k = max_k
        self.num_species = num_species  # rows 0..S-1 (0 = non_unique)
        self.n = len(taxids)
        self.num_limbs = limbs.shape[1] if self.n \
            else kmer.num_limbs(highest_k)
        self.idx_limbs_np = limbs
        self.idx_limbs = torch.from_numpy(
            np.ascontiguousarray(limbs, np.int32)).to(device)
        self.tax_rows = (np.asarray(tax_rows, np.int32) if tax_rows is not None
                         else map_tax_rows(taxids, tax_to_row))
        self.keffs = list(range(min_k, max_k + 1))
        # the levels build in parallel threads (numpy and the native
        # sort release the GIL): 14 levels of 32.6 M five-limb entries
        # take ~4x less wall time in 8 threads than in one
        from concurrent.futures import ThreadPoolExecutor
        workers = max(1, min(len(self.keffs), os.cpu_count() or 1, 8))
        with ThreadPoolExecutor(workers) as ex:
            self.tables = dict(zip(self.keffs, ex.map(
                lambda k: build_group_table(limbs, self.tax_rows, highest_k,
                                            k), self.keffs)))
        self.num_steps = num_steps_for(self.n)


# ---------------------------------------------------------------------------
# the join engine: per-batch match + score

class JoinIndex:
    """The join engine's index on one device: the classic engine's
    stacked group tables (match/device.py StackedTables: the sorted
    index, per level grp_id, grp_start, d_tax, masks and weights, and
    the prefix buckets and limb-0 runs K10's search narrows through),
    uploaded once, and the per-level taxa on the host for the group
    statistics.  Level row ki <-> k = max_k - ki throughout."""

    def __init__(self, tables):
        self.tables = tables
        self.d_tax_host = tables.d_tax.cpu().numpy()


def load_join_index(index_path, limbs, taxids, tax_to_row, highest_k: int,
                    min_k: int, max_k: int, num_species: int, device,
                    tax_rows=None) -> JoinIndex:
    """The tables from the classic engine's builder and RAM cache
    (match/device.py load_or_build_classic)."""
    from .device import load_or_build_classic
    return JoinIndex(load_or_build_classic(
        index_path, limbs, taxids, tax_to_row, highest_k, min_k, max_k,
        num_species, device, tax_rows))


def sort_queries_plain(q: torch.Tensor, read_ids: torch.Tensor):
    """Plain version of K12: the (M, L) windows and their read ids
    sorted by (limbs..., read id), by stable sorts from the last key."""
    order = torch.argsort(read_ids, stable=True)
    for i in range(q.shape[1] - 1, -1, -1):
        order = order[torch.argsort(q[order, i], stable=True)]
    return q[order], read_ids[order]


def sort_queries(q: torch.Tensor, read_ids: torch.Tensor, num_reads: int,
                 ids_ascending: bool = False):
    """K12 wrapper (kasa_tpu join.py:225): (M, L) int32 windows and (M,)
    int32 read ids in [0, num_reads) -> both sorted by (limbs...,
    read id).  kasa_tpu's lax.sort orders by the limbs only, so its read
    ids among equal windows come in an unspecified order.  When the ids
    already ascend (ids_ascending: a batch as encode_batch lays it out,
    its lines in order), the kernel sorts stably by the limbs alone,
    which keeps that order."""
    if q.device.type == "cpu":
        return sort_queries_plain(q, read_ids)
    from .. import kernels
    rid_bits = 0 if ids_ascending else max(num_reads - 1, 0).bit_length()
    return kernels.query_sort(q, read_ids, rid_bits)


# K10's read-order head of a window, 4 bytes (csrc/common.cuh
# pack_head): its one-taxon levels' taxon + 1 in bits 0-14 (0 for none),
# lo in bits 15-19, hi in bits 20-24.  Heads exist where K11's read arm
# takes a batch; on the card its row of S float64 cells keeps S below
# 29,049 (kernels.join_scatter_arm), under HEAD_S_MAX
HEAD_S_MAX = (1 << 15) - 1


def pack_heads(taxon, lo, hi):
    """Heads of taxon (-1 for none), lo and hi (int tensors or arrays
    of one shape) -> csrc/common.cuh pack_head."""
    return (taxon + 1) | lo << 15 | hi << 20


def unpack_heads(h):
    """-> (taxon, -1 for none; lo; hi) of packed heads."""
    return (h & 0x7FFF) - 1, (h >> 15) & 31, (h >> 20) & 31


def _check_match(t, q):
    if q.dim() != 2 or q.shape[1] != t.idx_limbs.shape[1]:
        raise ValueError(f"queries of shape {tuple(q.shape)} against an "
                         f"index of {t.idx_limbs.shape[1]} limbs")


def join_match_plain(t, q: torch.Tensor, pos: torch.Tensor | None = None):
    """Plain version of K10 for StackedTables t and (M, L) int32 queries
    -> (matched, g, T, start, ok), each (numK, M), row ki <-> k = max_k -
    ki: matched (bool), the group g, its taxa count T and its start in
    d_tax[ki] (int32; 0, 0 and grp_start[0] where unmatched, as
    kasa_tpu's _match_one_keff gives them), and ok (bool): no '^' at
    positions min_k-1 .. k-1 (kasa_tpu's cumulative _letters_block
    test).  One lower bound of the full key decides every level: k-prefix
    groups nest in the sorted order, so a query's level-k group, where it
    exists, holds the entry at pos or at pos - 1.

    With pos ((M,) int32, each query's position in the batch before the
    sort, a permutation of 0 .. M-1), also the read-order records K11's
    read arm takes (csrc/join_match.cu), at row pos[m] of each: heads
    (M,) int32, pack_heads of the taxon d_tax[lo][start] where T == 1 at
    lo, the query's first valid level (matched and ok), else -1; lo; and
    hi, its first valid level with T > 1 (numK where none of either);
    and wide_at (M,) int32, m where hi < numK, else -1.  Valid levels
    nest (a query valid at ki is valid at every ki' > ki, in a group
    holding the deeper one's entries): its T = 1 levels are [lo, hi), one
    taxon, its T > 1 levels [hi, numK).  Raises for an index of more than
    HEAD_S_MAX species with pos."""
    from ..ops.search import lower_bound_plain
    from .device import _valid_levels
    _check_match(t, q)
    nk, n, M = t.num_k, t.n, q.shape[0]
    i32 = dict(dtype=torch.int32, device=q.device)
    matched = torch.zeros((nk, M), dtype=torch.bool, device=q.device)
    g = torch.zeros((nk, M), **i32)
    T = torch.zeros((nk, M), **i32)
    start = torch.zeros((nk, M), **i32)
    ok = torch.zeros((nk, M), dtype=torch.bool, device=q.device)
    heads = wide_at = None
    dest = None if pos is None else pos.long()
    if pos is not None:
        if t.num_species > HEAD_S_MAX:
            raise ValueError(f"S = {t.num_species}: a head names at most "
                             f"{HEAD_S_MAX} taxa")
        heads = torch.full((M,), pack_heads(-1, nk, nk), **i32)
        wide_at = torch.full((M,), -1, **i32)
    outs = (matched, g, T, start, ok) + (
        () if heads is None else (heads, wide_at))
    if M == 0 or n == 0:
        return outs
    kv = _valid_levels(q, t.min_k, t.max_k)
    pos = lower_bound_plain(t.idx_limbs, q)
    at = t.idx_limbs[pos.clamp(max=n - 1)]
    prev = t.idx_limbs[(pos - 1).clamp(min=0)]
    for ki in range(nk):
        mask = t.masks[ki]
        qm = q & mask
        eq_at = (pos < n) & ((at & mask) == qm).all(dim=1)
        eq_prev = (pos > 0) & ((prev & mask) == qm).all(dim=1)
        matched[ki] = eq_at | eq_prev
        e = torch.where(eq_at, pos, pos - 1).clamp(0, n - 1)
        gk = torch.where(matched[ki], t.grp_id[ki][e].long(),
                         torch.zeros_like(e))
        gs = t.grp_start[ki]
        g[ki] = gk.int()
        T[ki] = torch.where(matched[ki], gs[gk + 1] - gs[gk],
                            torch.zeros_like(gs[gk]))
        start[ki] = gs[gk]
        ok[ki] = kv >= t.max_k - ki
    if heads is not None:
        valid = matched & ok
        kis = torch.arange(nk, device=q.device)[:, None]
        lo = torch.where(valid, kis, nk).min(dim=0).values
        hi = torch.where(valid & (T > 1), kis, nk).min(dim=0).values
        at = lo.clamp(max=nk - 1)
        m = torch.arange(M, device=q.device)
        one = (lo < nk) & (T[at, m] == 1)
        taxon = t.d_tax[at, torch.where(one, start[at, m], 0).long()]
        heads[dest] = pack_heads(torch.where(one, taxon, -1), lo, hi).int()
        wide_at[dest] = torch.where(hi < nk, m, -1).int()
    return outs


def join_match(t, q: torch.Tensor, pos: torch.Tensor | None = None):
    """K10 wrapper: the CUDA kernel on a CUDA tensor, else the plain
    version (join_match_plain)."""
    if q.device.type == "cpu":
        return join_match_plain(t, q, pos)
    from .. import kernels
    return kernels.join_match(t, q, pos)


def join_scatter_plain(t, valid, T, start, read_ids, num_reads: int):
    """Plain version of K11: every occurrence valid at level ki (valid,
    T, start (numK, M) from K10; read_ids (M,)) adds w(k) * (1/T), the
    float32 value kasa_tpu scatters, to its read's score row for each of
    the T taxa d_tax[ki][start .. start + T).  -> (num_reads, S) float32
    scores, summed in float64 and rounded once."""
    S = t.num_species
    dev = read_ids.device
    scores = torch.zeros((num_reads, S), dtype=torch.float64, device=dev)
    for ki in range(t.num_k):
        idx = torch.nonzero(valid[ki])[:, 0]
        if idx.numel() == 0:
            continue
        Tv = T[ki][idx].long()
        val = (t.weights[ki] * (1.0 / Tv.float())).double()
        pair = torch.repeat_interleave(torch.arange(Tv.numel(), device=dev),
                                       Tv)
        j = torch.arange(pair.numel(), device=dev) \
            - (torch.cumsum(Tv, 0) - Tv)[pair]
        tax = t.d_tax[ki][start[ki][idx].long()[pair] + j].long()
        scores.view(-1).index_add_(
            0, read_ids[idx].long()[pair] * S + tax, val[pair])
    return scores.float()


def join_scatter(t, valid, T, start, read_ids, num_reads: int):
    """K11 wrapper, its global arm (occurrences in key order): the CUDA
    kernel on a CUDA tensor, else the plain version
    (join_scatter_plain)."""
    if read_ids.device.type == "cpu":
        return join_scatter_plain(t, valid, T, start, read_ids, num_reads)
    from .. import kernels
    return kernels.join_scatter(t, valid, T, start, read_ids, num_reads)


def join_scatter_reads_plain(t, heads, wide_at, T, start, read_ids,
                             num_reads: int):
    """Plain version of K11's read arm: K10's records (heads, wide_at;
    join_match_plain with pos) in the batch's own order, K10's key-order
    T and start, and the batch's read ids (M,) -> the (num_reads, S)
    float32 scores of join_scatter_plain: a query's T = 1 levels [lo,
    hi) add w(k) each to its read's cell of its head's taxon, its
    T > 1 levels [hi, numK) add w(k) * (1/T) to each of the group's T
    taxa d_tax[ki][start .. start + T) (T and start at its row
    wide_at), summed in float64 and rounded once."""
    S = t.num_species
    dev = read_ids.device
    nk = t.num_k
    scores = torch.zeros((num_reads, S), dtype=torch.float64, device=dev)
    taxon, lo, hi = unpack_heads(heads)
    rid = read_ids.long()
    for ki in range(nk):
        one = (taxon >= 0) & (lo <= ki) & (ki < hi)
        scores.view(-1).index_add_(
            0, rid[one] * S + taxon[one].long(),
            t.weights[ki].double().expand(int(one.sum())))
        wide = (wide_at >= 0) & (hi <= ki)
        row = wide_at[wide].long()
        Tv = T[ki][row].long()
        if Tv.numel() == 0:
            continue
        val = (t.weights[ki] * (1.0 / Tv.float())).double()
        pair = torch.repeat_interleave(torch.arange(Tv.numel(), device=dev),
                                       Tv)
        j = torch.arange(pair.numel(), device=dev) \
            - (torch.cumsum(Tv, 0) - Tv)[pair]
        tax = t.d_tax[ki][start[ki][row].long()[pair] + j].long()
        scores.view(-1).index_add_(0, rid[wide][pair] * S + tax, val[pair])
    return scores.float()


def join_scatter_reads(t, heads, wide_at, T, start, read_ids,
                       num_reads: int):
    """K11 wrapper, its read arm: the CUDA kernel on a CUDA tensor, else
    the plain version (join_scatter_reads_plain)."""
    if read_ids.device.type == "cpu":
        return join_scatter_reads_plain(t, heads, wide_at, T, start,
                                        read_ids, num_reads)
    from .. import kernels
    return kernels.join_scatter_reads(t, heads, wide_at, T, start, read_ids,
                                      num_reads)


def scatter_arm(t, read_order: bool, num_reads: int) -> str:
    """K11's arm for a batch of num_reads reads on t's device: on the
    card kernels.join_scatter_arm ("reads" where the batch comes in read
    order, its read ids ascending, it is large enough and the read's row
    fits a block's shared memory; else "global"); on the CPU, where
    either arm is its plain version, "reads" wherever the read ids
    ascend and a head can name every taxon (HEAD_S_MAX)."""
    if t.device.type == "cpu":
        return "reads" if read_order and t.num_species <= HEAD_S_MAX \
            else "global"
    from .. import kernels
    return kernels.join_scatter_arm(t.num_species, read_order,
                                    kernels.dedup_smem(t.device), num_reads)


class MatchResult:
    def __init__(self, num_k: int, num_species: int, num_reads: int):
        self.scores = np.zeros((num_reads, num_species), dtype=np.float32)
        self.counts_all = np.zeros((num_k, num_species), dtype=np.float64)
        self.counts_unique = np.zeros((num_k, num_species), dtype=np.uint64)
        self.counts_total = np.zeros((num_k, num_species), dtype=np.uint64)


def match_and_score(ji: JoinIndex, q_limbs: np.ndarray,
                    read_ids: np.ndarray, num_reads: int,
                    unique: bool = False, coverage: bool = False,
                    want_scores: bool = True) -> MatchResult:
    """The multi-k match of one encoded batch (kasa_tpu join.py:243): K12,
    K10 and K11 on the tables' device, the group statistics on the host.
    The score rows stay on the device across the levels and come back
    once."""
    from ..utils import timers
    t = ji.tables
    res = MatchResult(t.num_k, t.num_species, num_reads)
    if len(read_ids) == 0 or t.n == 0:
        return res
    d = t.device
    with timers.stage("join/sort"):
        rid = np.ascontiguousarray(read_ids, np.int32)
        # encode_batch's read ids ascend (one id per line, lines in
        # order): K12 then sorts by the limbs alone
        ascending = bool((rid[1:] >= rid[:-1]).all())
        q = torch.from_numpy(np.ascontiguousarray(q_limbs, np.int32)).to(d)
        r = torch.from_numpy(rid).to(d)
        # the read arm of K11 takes the occurrences in read order: K12
        # carries each window's position and K10 writes its head there
        # (-e drops windows on the host after the sort: the global arm)
        reads = want_scores and not unique \
            and scatter_arm(t, ascending, num_reads) == "reads"
        if reads:
            pos = torch.arange(len(rid), dtype=torch.int32, device=d)
            q, pos = sort_queries(q, pos, len(rid), ids_ascending=True)
        else:
            q, r = sort_queries(q, r, num_reads, ids_ascending=ascending)
        if unique:
            # -e: duplicate (kmer, readID) pairs dropped on the host, as
            # in kasa_tpu (join.py:263-277); the order stays (limbs...,
            # read id)
            from .engine import dedup_unique
            ql, rl = dedup_unique(q.cpu().numpy(), r.cpu().numpy())
            q = torch.from_numpy(np.ascontiguousarray(ql)).to(d)
            r = torch.from_numpy(np.ascontiguousarray(rl)).to(d)
    with timers.stage("join/match"):
        out = join_match(t, q, pos if reads else None)
        matched, g, T, start, ok = out[:5]
        valid = matched & ok
        per_level = valid.sum(dim=1).cpu().numpy()
        gv, Tv, sv = (a[valid].cpu().numpy() for a in (g, T, start))
    with timers.stage("join/host-stats"):
        cuts = np.concatenate([[0], np.cumsum(per_level)])
        for ki in range(t.num_k):
            a, b = int(cuts[ki]), int(cuts[ki + 1])
            if a == b:
                continue
            _group_stats(res, ki, gv[a:b], Tv[a:b], sv[a:b],
                         ji.d_tax_host[ki], coverage)
    if want_scores:
        with timers.stage("join/scatter"):
            scores = (join_scatter_reads(t, out[5], out[6], T, start, r,
                                         num_reads) if reads
                      else join_scatter(t, valid, T, start, r, num_reads))
            res.scores = scores.cpu().numpy()
    return res


def _group_stats(res: MatchResult, ki: int, vg, vT, vstart, dt, coverage):
    """The profile counts of level ki from its valid occurrences (in
    window order, so each group's occurrences are one run): per matched
    group of H occurrences and T taxa, every taxon gets H/T in float64
    counts_all, H in counts_unique when T == 1, and 1 in counts_total
    under --coverage.  The taxa are expanded in kasa_tpu's order (group
    by group, each group's taxa in d_tax order) and each cell is summed
    in that order, so the float64 counts are bit-identical to kasa_tpu's
    np.add.at sums."""
    seg_first = np.empty(len(vg), dtype=bool)
    seg_first[0] = True
    seg_first[1:] = vg[1:] != vg[:-1]
    h = np.bincount(np.cumsum(seg_first) - 1)
    seg_T = vT[seg_first]
    seg_start = vstart[seg_first]
    ofs = np.cumsum(seg_T) - seg_T
    tax_flat = dt[np.repeat(seg_start - ofs, seg_T)
                  + np.arange(int(seg_T.sum()))]
    h_flat = np.repeat(h, seg_T)
    T_flat = np.repeat(seg_T, seg_T)
    S = res.counts_all.shape[1]
    # bincount adds in index order from 0.0, as np.add.at does into the
    # level's zero row
    res.counts_all[ki] += np.bincount(
        tax_flat, weights=h_flat.astype(np.float64) / T_flat, minlength=S)
    uniq = T_flat == 1
    res.counts_unique[ki] += np.bincount(
        tax_flat[uniq], weights=h_flat[uniq], minlength=S).astype(np.uint64)
    if coverage:
        res.counts_total[ki] += np.bincount(
            tax_flat, minlength=S).astype(np.uint64)
