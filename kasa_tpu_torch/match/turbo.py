"""Turbo classify path on PyTorch + CUDA (port of kasa_tpu/match/turbo.py).

One batch of reads goes through six hand-written CUDA kernels
(kasa_tpu_torch/csrc/, bound in kasa_tpu_torch/kernels.py):

  K1 encode        (core/encode.py)   bytes -> (M, L) int32 limb windows
  K2 turbo_match   (this module)      router + bisect search and per-level
                                      slots over L limbs: T==1 keys
                                      tax*8+ki, multi payloads psel*8+ki
  K3 turbo_reads   (this module)      per read, in shared memory: before
                                      K4 the sort of the read's real T1
                                      keys, runs/CW compaction and the
                                      multi-slot compaction; after K4 the
                                      T1 fold, the per-read hit lists and
                                      the packed CSR readback
  K4 turbo_multi   (this module)      the global multi worklist: exact T,
                                      expansion-budget flags (a
                                      block-wide cut), the CSR expansion
                                      folded into the (numK, S) counts by
                                      atomics and into each read's (R, S)
                                      score row in shared memory, hot-set
                                      credits
  K5 dedup         (this module)      -e: per read, the windows sorted and
                                      duplicates poisoned (before K2)
  K6 sparse_fold   (this module)      the sparse regime's per-read multi
                                      lists (after K4's counts-only arm)

K3 (post) and K4 also take a file_of_read map (identify_multiple): the
counts then go to an (F, numK, S) matrix, one slab per file.

Two regimes, as in kasa_tpu (turbo.py:818): the dense fold (S <=
SPARSE_FOLD_S, or tables with a hot tier) builds (R, S) score rows in
K4 and folds the hot sets through two products; the sparse fold (more
species and no hot tier) has K4 add only to the counts and K6 build each
read's list of its first WM multi taxa, which K3 (post) reads instead of
a score row.  L is 2 for 64-bit indices (k <= 12) and 3..5 for 128-bit
ones (k <= 25).

Every kernel has a plain PyTorch version of the same function here, with
the same outputs.  A wrapper takes the plain version only for tensors on
the CPU; on a CUDA tensor it launches the kernel or raises.

Scoring semantics are those of kasa_tpu's turbo kernel (split credit
w(k)/T, '^' validity, per-k prefix groups; reads over a budget are
flagged and recomputed exactly on the host by host_classify_read).
"""

from __future__ import annotations

import json
import os
import shutil
import zlib
from dataclasses import dataclass

import numpy as np
import torch

from ..core import kmer
from ..utils import timers
from .join import weight

ROUTER_BITS = 24            # dense router over the top bits of limb0
SUB_BITS = 24               # max extra bits resolved by a sub-router
RESID = 8                   # target residual bucket size
LIMB_BITS = 30              # 6 letters x 5 bits per limb

MULTI_BUDGET = 1 << 19      # global multi-slot worklist size per batch
EXP_BUDGET = 1 << 19        # (slot, 4-taxa-row) expansion rows per batch
# hot taxa-set tier: the top HOT_SETS taxa sets (by index-entry weight)
# are scored as a dense (R, H) credit matrix folded through one
# (R, H) @ (H, S) product instead of per-pair atomics
HOT_SETS = 512
# above this species count the multi credits fold into per-read lists
# (K6, kasa_tpu's sorted (read, tax) pair list) instead of (R, S) score
# rows, and the table builder skips the hot tier
SPARSE_FOLD_S = 4096
HOT_MASK_BYTES = 64 << 20

# packed-readback sizing: CSR hit-list capacity is CSR_CAP_FACTOR *
# reads per batch; device count accumulators flush every COUNT_FLUSH
# batches (f32 drift stays bounded; host totals are f64)
CSR_CAP_FACTOR = 4
COUNT_FLUSH = 64


class TurboRowOverflow(RuntimeError):
    """d_tax4 would need >= 2^31 rows: int32 grp2 pointers would wrap."""


CW = 160                    # compact (tax, k) runs kept per read (T1)
WOUT = 160                  # distinct taxa emitted per read
WM = 160                    # distinct multi taxa folded per read
# a window of six '^' letters: always invalid at every k, used to
# poison -e duplicates (kasa_tpu turbo.py:117)
POISON_LIMB = sum(30 << (5 * j) for j in range(6))
I32_MAX = np.int32(2**31 - 1)
# T1 slot keys are tax*8+ki.  kasa_tpu narrows them to int16 (sentinel
# 32767) when S <= 4095 to halve its global sorts; here the sort runs in
# shared memory, so the keys stay int32 with one sentinel for every S
# (the key order, and so every output, is the same).
SENT = int(I32_MAX)
# K3 sorts the real keys among a read's SW = W * numK slot keys in shared
# memory, up to SW = 4096 (a 150 bp read has 846, W = 141, numK = 6); a
# batch with more slots per read takes a long arm: in one block's shared
# memory while its rows' real keys fit, else in global memory.  K5 and
# K6 switch at the same width.
SW_CAP = 4096
DEDUP_CAP = 4096
# slots per read that one MULTI_BUDGET, EXP_BUDGET and WOUT serve: two
# 150 bp lines at six levels (2 x 141 windows x 6).  The drive loop
# scales all three by a batch's slots per read over this (batch_budgets),
# so that long read lines and pairs under --six do not overflow them and
# go to the host recompute.
BUDGET_SLOTS = 1692


def batch_budgets(slots_per_read: int, num_species: int,
                  multi_budget: int = MULTI_BUDGET,
                  exp_budget: int = EXP_BUDGET) -> tuple[int, int, int]:
    """-> (multi budget, expansion budget, hit-list width) of a batch
    with slots_per_read slots per read: the budgets times
    ceil(slots_per_read / BUDGET_SLOTS) (at least once), the list width
    WOUT times as much but no wider than the num_species taxa a list can
    hold (and never below WOUT)."""
    scale = max(1, -(-slots_per_read // BUDGET_SLOTS))
    return (multi_budget * scale, exp_budget * scale,
            max(WOUT, min(WOUT * scale, num_species)))


def _num_steps(n: int) -> int:
    s = 1
    while (1 << s) < n + 1:
        s += 1
    return s


def lex_lower_bound_np(keys: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Vectorized lower_bound of each q row in lexicographically sorted
    `keys` (n, L) int32 (numpy has no multi-column searchsorted)."""
    n = len(keys)
    m = len(q)
    lo = np.zeros(m, np.int64)
    if n == 0:
        return lo
    hi = np.full(m, n, np.int64)
    for _ in range(int(np.ceil(np.log2(n + 1))) + 1):
        act = lo < hi
        mid = (lo + hi) >> 1
        rows = keys[np.minimum(mid, n - 1)]
        less = np.zeros(m, bool)
        eq = np.ones(m, bool)
        for i in range(keys.shape[1]):
            less |= eq & (rows[:, i] < q[:, i])
            eq &= rows[:, i] == q[:, i]
        lo = np.where(act & less, mid + 1, lo)
        hi = np.where(act & ~less, mid, hi)
    return lo


def turbo_supported(n: int, num_limbs: int, min_k: int, max_k: int,
                    num_species: int) -> bool:
    """Preconditions of the resident turbo tables (kasa_tpu's check)."""
    num_k = max_k - min_k + 1
    return (n > 0 and 2 <= num_limbs <= 5 and num_k <= 6
            and min_k * 5 >= ROUTER_BITS
            and num_species < (1 << 24)
            and num_k * n < (1 << 31)
            and n < (1 << 28))


@dataclass
class TurboTables:
    """Device tables for the turbo kernels plus the host data of the
    exact per-read recompute.  Field names and layouts are those of
    kasa_tpu's TurboTables, so tables built by either package load into
    the other (tables_from_numpy, the .tabs sidecar)."""
    keys2: torch.Tensor     # (n, L) int32 sorted distinct limbs
    rowdat: torch.Tensor    # (n, L+2) int32 [limbs..., tax, tpack]
    router: torch.Tensor    # (2^ROUTER_BITS, 2) int32 [lo, meta]
    sub2: torch.Tensor      # (SUB, 2) int32 [lo, hi] sub-router rows
    grp2: torch.Tensor      # (numK * n,) int32 row ptr / -(hot+1) / 0
    d_tax4: torch.Tensor    # (DR, 4) int32 header+taxa rows per group
    weights: torch.Tensor   # (numK,) float32 w(k), row ki <-> k=maxK-ki
    masks2: torch.Tensor    # (numK, L) int32 prefix masks
    hotmask: torch.Tensor   # (H, S) f32 0/1 membership of hot taxa sets
    t_hot: torch.Tensor     # (H,) int32 distinct-taxa count per hot set
    num_steps: int
    min_k: int
    max_k: int
    highest_k: int
    num_species: int
    n: int
    host_limbs: np.ndarray  # (N_entries, L) int32, with duplicates
    host_grp_start: list
    host_d_tax: list
    host_grp_id: list
    host_masks: np.ndarray  # (numK, L) int32
    _host_key64: np.ndarray | None = None

    @property
    def device(self) -> torch.device:
        return self.keys2.device

    @property
    def num_k(self) -> int:
        return self.max_k - self.min_k + 1

    def host_key64(self) -> np.ndarray:
        if self._host_key64 is None:
            self._host_key64 = \
                (self.host_limbs[:, 0].astype(np.int64) << LIMB_BITS) \
                | self.host_limbs[:, 1].astype(np.int64)
        return self._host_key64


DEVICE_FIELDS = ("keys2", "rowdat", "router", "sub2", "grp2", "d_tax4",
                 "weights", "masks2", "hotmask", "t_hot")
META_FIELDS = ("num_steps", "min_k", "max_k", "highest_k", "num_species",
               "n")


def tables_from_numpy(arrays: dict, meta: dict, device) -> TurboTables:
    """Turbo tables on `device` from numpy arrays laid out as kasa_tpu's
    TurboTables fields.

    arrays: the ten device fields (keys2 ... t_hot) plus host_limbs,
    host_grp_start, host_d_tax, host_grp_id (lists of numK arrays) and,
    optionally, host_masks (defaults to masks2).  meta: num_steps,
    min_k, max_k, highest_k, num_species, n."""
    dev = torch.device(device)

    def up(a):
        a = np.require(np.asarray(a), requirements=["C", "W"])
        return torch.from_numpy(a).to(dev)
    tabs = {f: up(arrays[f]) for f in DEVICE_FIELDS}
    masks_np = np.asarray(arrays.get("host_masks", arrays["masks2"]))
    return TurboTables(
        **tabs, **{f: int(meta[f]) for f in META_FIELDS},
        host_limbs=arrays["host_limbs"],
        host_grp_start=list(arrays["host_grp_start"]),
        host_d_tax=list(arrays["host_d_tax"]),
        host_grp_id=list(arrays["host_grp_id"]),
        host_masks=np.array(masks_np, np.int32))


def build_tables_np(limbs, tax_rows, highest_k, min_k, max_k,
                    num_species) -> tuple[dict, dict]:
    """Numpy twin of kasa_tpu's TurboTables.build_from_arrays: the same
    arrays, bit for bit, as (arrays, meta) for tables_from_numpy."""
    from .join import build_group_table
    with timers.stage("ttbuild/group-tables"):
        tables = [build_group_table(limbs, tax_rows, highest_k, max_k - ki)
                  for ki in range(max_k - min_k + 1)]
    return _build(limbs, tax_rows, tables, highest_k, min_k, max_k,
                  num_species)


def _build(limbs, tax_rows, tables, highest_k, min_k, max_k, num_species):
    n_entries = len(tax_rows)
    num_k = max_k - min_k + 1
    L = limbs.shape[1] if n_entries else 2
    host_limbs = limbs

    # DEVICE tables hold one row per DISTINCT full key:
    # (timed: stage profile of first-contact table construction) equal-key
    # runs (multi-taxa groups, up to hundreds of entries) pinned
    # the bisect depth -- no router can split equal keys -- and the
    # kernel only ever needs group-level data at a position (T==1
    # implies a single entry; multi reads taxa through grp2).  The
    # HOST fallback keeps the full entry-level arrays.
    with timers.stage("ttbuild/dedup-keys"):
        uniq = np.ones(n_entries, bool)
        uniq[1:] = np.any(limbs[1:] != limbs[:-1], axis=1)
        upos = np.nonzero(uniq)[0]
        limbs = np.ascontiguousarray(limbs[upos])
        # 60-bit prefix key of the first two limbs: drives router /
        # sub-router construction (their thresholds live in the top
        # 40 bits, so a prefix lower_bound equals the full-key one)
        key64 = (limbs[:, 0].astype(np.int64) << LIMB_BITS) \
            | limbs[:, 1].astype(np.int64)
        tax = tax_rows[upos].astype(np.int32)
        n = len(upos)

    # per-level T per entry (clamped) + flat grp table + d_tax4
    # layout: each multi group owns a HEADER row [T, 0, 0, 0]
    # followed by ceil(T/4) taxa rows; grp2 points at the header
    tpack = np.zeros(n, np.int32)
    grp2 = np.zeros((num_k * n,), np.int32)
    d_tax4_parts = [np.zeros((1, 4), np.int32)]   # row 0 reserved
    row_next = 1
    masks2 = np.zeros((num_k, L), np.int32)
    for ki in range(num_k):
      with timers.stage("ttbuild/grp2+dtax"):
        t = tables[ki]
        masks2[ki] = t.mask
        sizes = np.diff(t.grp_start).astype(np.int64)   # (G,)
        gid_d = t.grp_id[upos]                   # per distinct key
        T_entry = sizes[gid_d]                           # (n,)
        tpack |= (np.minimum(T_entry, 31) << (5 * ki)).astype(np.int32)
        multi = sizes >= 2
        rows_per = np.where(multi, 1 + (sizes + 3) // 4, 0)
        row_base = np.zeros(len(sizes) + 1, np.int64)
        np.cumsum(rows_per, out=row_base[1:])
        total_rows = int(row_base[-1])
        grp_row = np.where(multi, row_next + row_base[:-1], 0)
        grp2[ki * n:(ki + 1) * n] = grp_row[gid_d]
        if total_rows:
            # taxa rows pad their unused tail lanes with -1: the
            # kernel masks expansion lanes by `taxa >= 0` instead
            # of gathering a per-slot T bound (r5).  Header rows
            # only ever have column 0 read.
            buf = np.full(total_rows * 4, -1, np.int32)
            sizes32 = np.diff(t.grp_start)
            mg = np.nonzero(multi)[0]
            buf[row_base[mg] * 4] = sizes32[mg]          # headers
            pair_grp = np.repeat(np.arange(len(sizes32)), sizes32)
            within = np.arange(len(t.d_tax)) - t.grp_start[pair_grp]
            sel = multi[pair_grp]
            dst = (row_base[pair_grp[sel]] + 1) * 4 + within[sel]
            buf[dst] = t.d_tax[sel]
            d_tax4_parts.append(buf.reshape(-1, 4))
            row_next += total_rows
            if row_next >= (1 << 31):
                raise TurboRowOverflow(
                    f"multi-group taxa table needs {row_next:,} "
                    "rows (>= 2^31): int32 grp2 pointers would "
                    "wrap")
    d_tax4 = np.concatenate(d_tax4_parts, axis=0)

    # ---- hot taxa sets: hash each multi group's taxa set (sum of
    # per-taxon mix hashes -- order-free, sets are equal iff sums
    # collide only with ~2^-64 probability), weight by index-entry
    # count, take the global top H; hot groups store -(hot_id+1)
    # in grp2 column 1 instead of a d_tax4 row
    tm_hot = timers.stage("ttbuild/hotsets")
    tm_hot.__enter__()
    H = min(HOT_SETS, max(HOT_MASK_BYTES // max(4 * num_species, 1),
                          1))
    mix = (np.arange(num_species, dtype=np.uint64)
           + np.uint64(0x9E3779B97F4A7C15))
    mix = (mix ^ (mix >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    mix = (mix ^ (mix >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    mix = mix ^ (mix >> np.uint64(31))
    all_h, all_w = [], []
    per_ki_gh = []
    hot_eligible = num_species <= SPARSE_FOLD_S
    for ki in range(num_k):
        if not hot_eligible:
            per_ki_gh.append(np.zeros(0, np.uint64))
            continue
        t = tables[ki]
        G = len(t.grp_start) - 1
        if G == 0:
            per_ki_gh.append(np.zeros(0, np.uint64))
            continue
        gh = np.add.reduceat(mix[t.d_tax], t.grp_start[:-1]) \
            if len(t.d_tax) else np.zeros(G, np.uint64)
        sizes = np.diff(t.grp_start)
        entry_w = np.bincount(t.grp_id, minlength=G)
        multi_g = sizes >= 2
        per_ki_gh.append(gh)
        all_h.append(gh[multi_g])
        all_w.append(entry_w[multi_g])
    hotmask = np.zeros((1, num_species), np.float32)
    t_hot = np.zeros(1, np.int32)
    hot_hashes = np.zeros(0, np.uint64)
    if num_species > SPARSE_FOLD_S:
        all_h = []          # sparse-fold regime: no hot tier
    if all_h and sum(len(a) for a in all_h):
        hcat = np.concatenate(all_h)
        wcat = np.concatenate(all_w).astype(np.int64)
        # rank distinct sets by weight: native sort of (hash, w)
        # brings equal hashes adjacent (np.unique re-sorts with a
        # stable mergesort, ~60 s at 100M multi groups -- profiled
        # r4 ttbuild/hotsets)
        from ..native import sort_kmer_tax
        hs = hcat.copy()
        ws32 = np.minimum(wcat, (1 << 31) - 1).astype(np.uint32)
        if sort_kmer_tax(hs, ws32, 64, os.cpu_count() or 1):
            newh = np.empty(len(hs), bool)
            newh[0] = True
            newh[1:] = hs[1:] != hs[:-1]
            uh = hs[newh]
            gidx = np.cumsum(newh) - 1
            # bincount ~10x np.add.at; f64 exact below 2^53
            wsum = np.bincount(
                gidx, weights=ws32.astype(np.float64),
                minlength=len(uh)).astype(np.int64)
        else:
            uh, inv = np.unique(hcat, return_inverse=True)
            wsum = np.zeros(len(uh), np.int64)
            np.add.at(wsum, inv, wcat)
        top = np.argsort(wsum)[::-1][:H]
        hot_hashes = uh[top]
        order_h = np.argsort(hot_hashes)
        hot_hashes = hot_hashes[order_h]
        hotmask = np.zeros((len(hot_hashes), num_species),
                           np.float32)
        t_hot = np.zeros(len(hot_hashes), np.int32)
        filled = np.zeros(len(hot_hashes), bool)
        for ki in range(num_k):
            t = tables[ki]
            gh = per_ki_gh[ki]
            if not len(gh):
                continue
            pos = np.searchsorted(hot_hashes, gh)
            pos_c = np.minimum(pos, len(hot_hashes) - 1)
            is_hot = (hot_hashes[pos_c] == gh) \
                & (np.diff(t.grp_start) >= 2)
            # representative fill of each hot set's mask row
            need = is_hot & ~filled[pos_c]
            for g in np.nonzero(need)[0]:
                hid = int(pos_c[g])
                if filled[hid]:
                    continue
                hotmask[hid, t.d_tax[t.grp_start[g]:
                                     t.grp_start[g + 1]]] = 1.0
                t_hot[hid] = t.grp_start[g + 1] - t.grp_start[g]
                filled[hid] = True
            # rewrite grp2 for hot groups: -(hot_id + 1)
            gid_d = t.grp_id[upos]
            hot_of_e = np.where(is_hot[gid_d],
                                -(pos_c[gid_d].astype(np.int64)
                                  + 1), 0)
            seg = grp2[ki * n:(ki + 1) * n]
            sel = hot_of_e != 0
            seg[sel] = hot_of_e[sel]

    tm_hot.__exit__(None, None, None)
    tm_router = timers.stage("ttbuild/router")
    tm_router.__enter__()
    rowdat = np.empty((n, L + 2), np.int32)
    rowdat[:, :L] = limbs
    rowdat[:, L], rowdat[:, L + 1] = tax, tpack

    # router (lo, meta): meta >= 0 is the bucket end; meta < 0 points
    # at a dense sub-router resolving the next s bits of the key
    buckets = (limbs[:, 0] >> (LIMB_BITS - ROUTER_BITS)).astype(np.int64)
    edges = np.searchsorted(
        buckets, np.arange((1 << ROUTER_BITS) + 1)).astype(np.int32)
    sizes_b = np.diff(edges)
    fat = sizes_b > RESID
    meta = edges[1:].copy()
    max_resid = int(sizes_b[~fat].max()) if (~fat).any() else 1
    if fat.any():
        fat_ids = np.nonzero(fat)[0].astype(np.int64)
        s_b = np.clip(np.ceil(np.log2(
            sizes_b[fat].astype(np.float64) / RESID)).astype(np.int64),
            1, SUB_BITS)
        reps = (1 << s_b)
        base = np.zeros(len(reps) + 1, np.int64)
        np.cumsum(reps, out=base[1:])
        fb = np.repeat(np.arange(len(fat_ids)), reps)
        within = np.arange(int(base[-1])) - base[fb]
        # threshold key for sub-bucket i of fat bucket b:
        # key60 >= (b << 36) | (i << (36 - s_b))
        shift_full = 60 - ROUTER_BITS
        thr = (fat_ids[fb] << shift_full) \
            | (within << (shift_full - s_b[fb]))
        lo_all = np.searchsorted(key64, thr).astype(np.int32)
        hi_all = np.empty_like(lo_all)
        hi_all[:-1] = lo_all[1:]
        last_pos = (base[1:] - 1).astype(np.int64)
        hi_all[last_pos] = edges[fat_ids + 1]
        sub2 = np.stack([lo_all, hi_all], axis=1)
        meta[fat_ids] = -(base[:-1] * 32 + s_b).astype(np.int32)
        max_resid = max(max_resid, int((hi_all - lo_all).max()))
    else:
        sub2 = np.zeros((1, 2), np.int32)
    router = np.stack([edges[:-1], meta], axis=1)

    tm_router.__exit__(None, None, None)

    w = np.array([weight(max_k - ki) for ki in range(num_k)], np.float32)
    arrays = dict(
        keys2=np.ascontiguousarray(limbs), rowdat=rowdat, router=router,
        sub2=sub2, grp2=grp2, d_tax4=d_tax4, weights=w, masks2=masks2,
        hotmask=hotmask, t_hot=t_hot, host_limbs=host_limbs,
        host_grp_start=[t.grp_start for t in tables],
        host_d_tax=[t.d_tax for t in tables],
        host_grp_id=[t.grp_id for t in tables],
        host_masks=masks2)
    meta = dict(num_steps=_num_steps(max_resid), min_k=min_k, max_k=max_k,
                highest_k=highest_k, num_species=num_species, n=n)
    return arrays, meta


# ---------------------------------------------------------------------------
# K2 turbo_match: search + slots (kasa_tpu turbo.py:569-667)

def turbo_match_plain(q: torch.Tensor, tt: TurboTables, num_reads: int,
                      kmers_per_read: int):
    """(M, L) int32 windows -> (skey, mpay), both (R, SW) int32 with
    slot s = window * numK + ki of its read:
      skey: tax*8+ki for a T == 1 match at level ki, else SENT;
      mpay: psel*8+ki for a multi-taxa (T >= 2) match, else -1.
    The bisect compares the L limbs lexicographically and each level's
    prefix compare masks every limb (zero past the level's k).  Mirrors
    kasa_tpu bit for bit, including its clamped gathers when the search
    runs past the last key (pos = n + 1)."""
    n = tt.n
    num_k = tt.num_k
    M, L = q.shape
    R, kpr = num_reads, kmers_per_read
    SW = kpr * num_k
    q0, q1 = q[:, 0], q[:, 1]

    def letter(pos):
        i, j = divmod(pos, kmer.LETTERS_PER_LIMB)
        shift = kmer.BITS_PER_LETTER * (kmer.LETTERS_PER_LIMB - 1 - j)
        return (q[:, i] >> shift) & 31
    ok = torch.ones(M, dtype=torch.bool, device=q.device)
    cum_ok_by_k = []
    for pos in range(tt.min_k - 1, tt.max_k):
        ok = ok & (letter(pos) != 30)
        cum_ok_by_k.append(ok)
    cum_ok = [cum_ok_by_k[num_k - 1 - ki] for ki in range(num_k)]

    bucket = (q0 >> (LIMB_BITS - ROUTER_BITS)).long()
    rr = tt.router[bucket]
    lo, meta = rr[:, 0], rr[:, 1]
    is_sub = meta < 0
    code = torch.where(is_sub, -meta, torch.full_like(meta, 32))
    sub_base = code >> 5
    s = torch.where(is_sub, code & 31, torch.full_like(code, SUB_BITS))
    subkey = ((q0 & 0x3F) << (SUB_BITS - 6)) \
        | (q1 >> (LIMB_BITS - (SUB_BITS - 6)))
    sidx = sub_base + (subkey >> (SUB_BITS - s))
    srow = tt.sub2[torch.where(is_sub, sidx, torch.zeros_like(sidx)).long()]
    lo = torch.where(is_sub, srow[:, 0], lo)
    hi = torch.where(is_sub, srow[:, 1], meta)
    for _ in range(tt.num_steps):
        mid = (lo + hi) >> 1
        kk = tt.keys2[mid.clamp(max=n - 1).long()]
        less = kk[:, L - 1] < q[:, L - 1]
        for i in range(L - 2, -1, -1):
            less = (kk[:, i] < q[:, i]) | ((kk[:, i] == q[:, i]) & less)
        lo = torch.where(less, mid + 1, lo)
        hi = torch.where(less, hi, mid)
    pos = lo
    pos_c = pos.clamp(max=n - 1)
    at_n = pos >= n
    prev = (pos - 1).clamp(min=0)
    at = tt.rowdat[pos_c.long()]
    pv = tt.rowdat[prev.clamp(max=n - 1).long()]
    prev_ok = pos > 0

    masks = torch.from_numpy(np.asarray(tt.host_masks, np.int32)) \
        .to(q.device)
    skeys, mpays = [], []
    for ki in range(num_k):
        qm = q & masks[ki]
        hit_at = ~at_n & ((at[:, :L] & masks[ki]) == qm).all(dim=1)
        hit_pv = prev_ok & ((pv[:, :L] & masks[ki]) == qm).all(dim=1)
        matched = (hit_at | hit_pv) & cum_ok[ki]
        tax = torch.where(hit_pv, pv[:, L], at[:, L])
        tp = torch.where(hit_pv, pv[:, L + 1], at[:, L + 1])
        tc = (tp >> (5 * ki)) & 31
        psel = torch.where(hit_pv, prev, pos_c)
        skeys.append(torch.where(matched & (tc == 1), tax * 8 + ki,
                                 torch.full_like(tax, SENT)))
        mpays.append(torch.where(matched & (tc >= 2), psel * 8 + ki,
                                 torch.full_like(psel, -1)))
    skey = torch.stack(skeys, dim=1).reshape(R, SW)
    mpay = torch.stack(mpays, dim=1).reshape(R, SW)
    return skey.contiguous(), mpay.contiguous()


def turbo_match(q: torch.Tensor, tt: TurboTables, num_reads: int,
                kmers_per_read: int):
    """K2 wrapper: the CUDA kernel on a CUDA tensor, else the plain
    version."""
    if q.device.type == "cpu":
        return turbo_match_plain(q, tt, num_reads, kmers_per_read)
    from .. import kernels
    return kernels.turbo_match(q, tt, num_reads, kmers_per_read, SENT)


# ---------------------------------------------------------------------------
# K3 turbo_reads, first entry point: before K4 (kasa_tpu turbo.py:672-738)

def turbo_reads_pre_plain(skey: torch.Tensor, mpay: torch.Tensor | None,
                          cw: int = CW):
    """Per read: sort the T1 keys, find the (tax, k) runs, keep the
    first cw runs, and compact the multi payloads to the row's front.
    -> ck (R, cw) int32 run keys (SENT-padded), cc (R, cw) int32 run
    counts, runs (R,) int32 runs per read, mcnt (R,) int32 multi slots
    per read, cp (R, SW) int32 compacted payloads (-1 after mcnt).
    Without mpay (the tiered finish: cw = SW, every run kept) mcnt and cp
    are None."""
    R, SW = skey.shape
    dev = skey.device
    sk, _ = torch.sort(skey, dim=1)
    valid = sk != SENT
    sent_col = torch.full((R, 1), SENT, dtype=sk.dtype, device=dev)
    nxt = torch.cat([sk[:, 1:], sent_col], dim=1)
    run_end = (sk != nxt) & valid
    prv = torch.cat([torch.full((R, 1), -1, dtype=sk.dtype, device=dev),
                     sk[:, :-1]], dim=1)
    iota = torch.arange(SW, dtype=torch.int32, device=dev).expand(R, SW)
    start = torch.cummax(torch.where(sk != prv, iota,
                                     torch.full_like(iota, -1)), dim=1)[0]
    run_c = torch.where(run_end, iota - start + 1, torch.zeros_like(iota))
    runs = run_end.sum(dim=1, dtype=torch.int32)
    ckey = torch.where(run_end, sk, torch.full_like(sk, SENT))
    ck, order = torch.sort(ckey, dim=1, stable=True)
    cc = torch.gather(run_c, 1, order)
    ncol = min(cw, SW)
    ck = torch.full((R, cw), SENT, dtype=torch.int32, device=dev)\
        .index_copy_(1, torch.arange(ncol, device=dev), ck[:, :ncol])
    cc = torch.zeros((R, cw), dtype=torch.int32, device=dev)\
        .index_copy_(1, torch.arange(ncol, device=dev), cc[:, :ncol])
    if mpay is None:
        return ck, cc, runs, None, None

    is_m = mpay >= 0
    mcnt = is_m.sum(dim=1, dtype=torch.int32)
    _, morder = torch.sort((~is_m).to(torch.int8), dim=1, stable=True)
    cp = torch.gather(mpay, 1, morder)
    cp = torch.where(iota < mcnt[:, None], cp, torch.full_like(cp, -1))
    return ck, cc, runs, mcnt, cp


def turbo_reads_pre(skey: torch.Tensor, mpay: torch.Tensor | None,
                    cw: int = CW, num_species: int | None = None):
    """K3 (pre) wrapper.  Rows of more than SW_CAP slots, or cw above
    it, need num_species: their slot keys lie below 8 * num_species,
    which picks the kernel's long arm."""
    if num_species is None and max(skey.shape[1], cw) > SW_CAP:
        raise ValueError(f"SW={skey.shape[1]}, cw={cw}: long rows need "
                         "num_species")
    if skey.device.type == "cpu":
        return turbo_reads_pre_plain(skey, mpay, cw)
    from .. import kernels
    return kernels.turbo_reads_pre(
        skey, mpay, SENT, cw, None if num_species is None else 8 * num_species)


# ---------------------------------------------------------------------------
# K4 turbo_multi: the global multi worklist (kasa_tpu turbo.py:672-869)

def turbo_multi_plain(cp, mcnt, runs, tt: TurboTables, acc_ca,
                      multi_budget: int, exp_budget: int,
                      file_of_read=None, counts_only: bool = False,
                      flag_reduce=None):
    """The batch's multi slots in read-major worklist order (at most
    B = min(multi_budget, R*SW) of them): exact T from the group header
    or the hot-set table; cold slots sorted stably by T and admitted
    while the expansion rows fit exp_budget; per-read overflow flags;
    the cold expansion folded into acc_ca (in place) and into the
    (R, S) score rows; hot-set credits per (read, set) and (k, set).

    With file_of_read (R,) int32, acc_ca is (F, numK, S) and a slot of
    read r counts in slab file_of_read[r] (kasa_tpu's fused_turbo_files).
    counts_only (the sparse regime, kasa_tpu's cflat at turbo.py:871-880)
    adds to acc_ca only: dm, a3w and a3c come back None.
    flag_reduce (the mesh, kasa_tpu turbo.py:768-769): called on the
    per-read flags after the cut and before anything is counted; its
    result (the flags ORed over the index shards) masks the expansion.

    -> ofc (R,) bool, dm (R, S) f32, a3w (R, H) f32, a3c (F*numK, H) f32,
       diag (2,) int32 [multi slots, expansion rows used]."""
    R, SW = cp.shape
    dev = cp.device
    n, num_k, S = tt.n, tt.num_k, tt.num_species
    H = tt.hotmask.shape[0]
    F = acc_ca.shape[0] if file_of_read is not None else 1
    fk_of = (file_of_read.long() * num_k if file_of_read is not None
             else torch.zeros(R, dtype=torch.long, device=dev))
    B = min(int(multi_budget), R * SW)
    total = int(mcnt.sum())
    batch_of = total > B
    rid = torch.repeat_interleave(torch.arange(R, device=dev),
                                  mcnt.long())
    base = torch.cumsum(mcnt.long(), 0) - mcnt.long()
    nb = min(total, B)
    rid = rid[:nb]
    within = torch.arange(nb, device=dev) - base[rid]
    mp = cp[rid, within]
    ki = (mp & 7).long()
    psel = (mp >> 3).long()
    row0 = tt.grp2[(ki * n + psel).clamp(max=num_k * n - 1)]
    hot = row0 < 0
    cold = row0 > 0
    hid = torch.where(hot, -row0 - 1, torch.zeros_like(row0)).long()
    hdr = tt.d_tax4[torch.where(cold, row0, torch.zeros_like(row0)).long(),
                    0]
    T = torch.where(cold, hdr, torch.where(hot, tt.t_hot[hid],
                                           torch.zeros_like(hdr)))

    ord_key = torch.where(cold, T, torch.full_like(T, SENT))
    sk2, perm = torch.sort(ord_key, stable=True)
    valid_s = sk2 != SENT
    T_s = torch.where(valid_s, sk2, torch.zeros_like(sk2)).long()
    rows_per = torch.where(valid_s, (T_s + 3) >> 2, torch.zeros_like(T_s))
    base_s = torch.cumsum(rows_per, 0) - rows_per
    fits = valid_s & (base_s + rows_per <= int(exp_budget))
    dropped = valid_s & ~fits
    rid_s = rid[perm]
    of_i = torch.zeros(R, dtype=torch.bool, device=dev)
    of_i[rid_s[dropped]] = True
    ofc = of_i | (runs > CW)
    if batch_of:
        ofc = ofc | (mcnt > 0)
    if flag_reduce is not None:
        ofc = flag_reduce(ofc)
    ok_slot = fits & ~ofc[rid_s]
    eused = int(rows_per[ok_slot].sum())

    # cold expansion: each admitted slot's taxa rows after its header
    w = tt.weights
    diag = torch.tensor([total, eused], dtype=torch.int32, device=dev)
    dm = None if counts_only else \
        torch.zeros((R, S), dtype=torch.float32, device=dev)
    okr = rows_per[ok_slot]
    if len(okr):
        sl = torch.repeat_interleave(torch.arange(len(okr), device=dev), okr)
        j = torch.arange(len(sl), device=dev) \
            - (torch.cumsum(okr, 0) - okr)[sl]
        row0_ok = row0[perm][ok_slot].long()
        taxa = tt.d_tax4[(row0_ok[sl] + 1 + j)
                         .clamp(max=tt.d_tax4.shape[0] - 1)]
        okt = taxa >= 0
        inv = 1.0 / T_s[ok_slot].to(torch.float32)
        ki_ok = ki[perm][ok_slot]
        rid_ok = rid_s[ok_slot]
        inv_e = inv[sl][:, None].expand(-1, 4)[okt]
        # in place: the batch's cold counts go straight into the
        # accumulator (no per-batch (numK, S) copy)
        fk_ok = fk_of[rid_ok] + ki_ok
        acc_ca.view(-1).index_add_(
            0, (fk_ok[sl][:, None] * S + taxa)[okt], inv_e)
        if dm is not None:
            wv = (w[ki_ok] * inv)[sl][:, None].expand(-1, 4)[okt]
            dm.view(-1).index_add_(0, (rid_ok[sl][:, None] * S + taxa)[okt],
                                   wv)
    if counts_only:
        return ofc, None, None, None, diag

    a3w = torch.zeros((R, H), dtype=torch.float32, device=dev)
    a3c = torch.zeros((F * num_k, H), dtype=torch.float32, device=dev)
    ok_hot = hot & ~ofc[rid]
    if bool(ok_hot.any()):
        inv_h = 1.0 / T[ok_hot].clamp(min=1).to(torch.float32)
        a3w.view(-1).index_add_(0, rid[ok_hot] * H + hid[ok_hot],
                                w[ki[ok_hot]] * inv_h)
        a3c.view(-1).index_add_(
            0, (fk_of[rid[ok_hot]] + ki[ok_hot]) * H + hid[ok_hot], inv_h)
    return ofc, dm, a3w, a3c, diag


def turbo_multi(cp, mcnt, runs, tt: TurboTables, acc_ca,
                multi_budget: int, exp_budget: int, file_of_read=None,
                counts_only: bool = False, flag_reduce=None):
    """K4 wrapper.  With flag_reduce the kernel runs split: the cut, then
    flag_reduce on its flags, then the expansion under the result."""
    if cp.device.type == "cpu":
        return turbo_multi_plain(cp, mcnt, runs, tt, acc_ca, multi_budget,
                                 exp_budget, file_of_read, counts_only,
                                 flag_reduce)
    from .. import kernels
    return kernels.turbo_multi(cp, mcnt, runs, tt, acc_ca, multi_budget,
                               exp_budget, CW, SENT, file_of_read,
                               counts_only, flag_reduce)


# ---------------------------------------------------------------------------
# K6 sparse_fold: the sparse regime's per-read multi lists (kasa_tpu
# turbo.py:881-918)

def fold_lanes(cp, mcnt, ofc, tt: TurboTables):
    """The sparse fold's lanes: every cold slot of an unflagged read (all
    of them were admitted: a dropped slot flags its read) expands into
    one lane per taxon of its group.  -> (rid, tax, w(k)/T), each (N,),
    in slot order."""
    R, SW = cp.shape
    dev = cp.device
    n, num_k = tt.n, tt.num_k
    iota = torch.arange(SW, device=dev)
    slot = torch.nonzero((iota[None, :] < mcnt[:, None]) & ~ofc[:, None])
    mp = cp[slot[:, 0], slot[:, 1]]
    ki = (mp & 7).long()
    row0 = tt.grp2[(ki * n + (mp >> 3).long()).clamp(max=num_k * n - 1)]\
        .long()
    cold = row0 > 0
    rid, ki, row0 = slot[cold, 0], ki[cold], row0[cold]
    T = tt.d_tax4[row0, 0].long()
    val = tt.weights[ki] * (1.0 / T.to(torch.float32))
    sl = torch.repeat_interleave(torch.arange(len(T), device=dev), T)
    j = torch.arange(len(sl), device=dev) - (torch.cumsum(T, 0) - T)[sl]
    taxa = tt.d_tax4.view(-1)[(row0[sl] + 1) * 4 + j].long()
    return rid[sl], taxa, val[sl]


def sparse_fold_plain(cp, mcnt, ofc, tt: TurboTables):
    """The sparse regime's multi lists, as kasa_tpu builds them from the
    lanes of fold_lanes: a 2-key sort of the lanes by (read, tax), run
    ends, each run's rank within its read, and a rank-addressed scatter
    into (R, WM+1) lists whose last column marks a read with more than
    WM distinct multi taxa.
    -> (mk (R, WM) int32 SENT-padded, mv (R, WM) f32, multi_of (R,)
    bool)."""
    R = cp.shape[0]
    dev = cp.device
    rid, taxa, val = fold_lanes(cp, mcnt, ofc, tt)
    # the 2-key sort as one int64 key (read << 32 | tax), stable
    ks, order = torch.sort((rid << 32) | taxa, stable=True)
    vs = val[order]
    k1s, k2s = ks >> 32, ks & 0xFFFFFFFF
    nxt = torch.cat([ks[1:], ks.new_full((1,), -1)])
    run_end = ks != nxt
    re_i = run_end.long()
    cexc = torch.cumsum(re_i, 0) - re_i
    rdstart = k1s != torch.cat([k1s.new_full((1,), -1), k1s[:-1]])
    if len(ks):
        rank = cexc - torch.cummax(torch.where(rdstart, cexc,
                                               torch.full_like(cexc, -1)),
                                   0)[0]
    else:
        rank = cexc
    wmp = WM + 1
    dest = k1s * wmp + rank.clamp(max=WM)
    mkf = torch.full((R * wmp,), SENT, dtype=torch.int32, device=dev)
    mkf[dest[run_end]] = k2s[run_end].to(torch.int32)
    mvf = torch.zeros((R * wmp,), dtype=torch.float32, device=dev)\
        .index_add_(0, dest, vs)
    mk = mkf.view(R, wmp)[:, :WM].contiguous()
    multi_of = mkf.view(R, wmp)[:, WM] != SENT
    mv = torch.where(mk != SENT, mvf.view(R, wmp)[:, :WM],
                     torch.zeros_like(mk, dtype=torch.float32))
    return mk, mv.contiguous(), multi_of


def sparse_fold(cp, mcnt, ofc, tt: TurboTables):
    """K6 wrapper."""
    if cp.device.type == "cpu":
        return sparse_fold_plain(cp, mcnt, ofc, tt)
    from .. import kernels
    return kernels.sparse_fold(cp, mcnt, ofc, tt, WM, SENT)


# ---------------------------------------------------------------------------
# K3 turbo_reads, second entry point: after K4 (kasa_tpu turbo.py:922-996
# and the fused_turbo_acc tail, 1226-1241)

def _segment_sums(keys, vals):
    """Row-wise sums over runs of equal keys in sorted (R, C) keys ->
    (run keys, run sums, run ends count per row); runs compact to the
    left, padding keys SENT and sums 0."""
    R, C = keys.shape
    dev = keys.device
    prv = torch.cat([torch.full((R, 1), -1, dtype=keys.dtype, device=dev),
                     keys[:, :-1]], dim=1)
    seg = torch.cumsum((keys != prv).to(torch.int64), dim=1) - 1
    sums = torch.zeros((R, C), dtype=vals.dtype, device=dev)\
        .scatter_add_(1, seg, vals)
    rkeys = torch.full((R, C), SENT, dtype=keys.dtype, device=dev)\
        .scatter_(1, seg, keys)
    nxt = torch.cat([keys[:, 1:], torch.full((R, 1), SENT,
                                             dtype=keys.dtype, device=dev)],
                    dim=1)
    nends = ((keys != nxt) & (keys != SENT)).sum(dim=1)
    return rkeys, sums, nends


def turbo_reads_post_plain(ck, cc, ofc, dm, weights, acc_ca, acc_cu, diag,
                           csr_cap: int, file_of_read=None, mlist=None, *,
                           wm: int = WM, additive: bool = False,
                           cadd=None, wout: int = WOUT):
    """T1 fold into the count accumulators (in place), per-read hit
    lists (T1 taxa + the read's first wm multi taxa, merged, first wout
    kept), flags, and the packed int32 readback:
    [hc (R) | flags (R) | CSR (tax, ksum bits) * csr_cap | mtot, eused,
    sum hc, flagged reads].  The multi taxa come from dm, the (R, S)
    score rows (dense regime), or, with dm None, from mlist = (mk, mv,
    multi_of), K6's lists (sparse regime).  With file_of_read the
    accumulators are (F, numK, S) and read r's runs go to slab
    file_of_read[r].

    A flagged read (ofc) counts nothing and contributes no T1 score: the
    host recomputes it whole.  The additive arm (the tiered finish) keeps
    its counts and scores instead (the host only adds its big groups),
    and adds cadd, the batch's (numK * S,) multi counts, to acc_ca.
    Flag bit0 is ofc, bit1 the list rebuild (ofc, more than wout T1
    taxa, more than wm multi taxa, or more than wout merged).
    -> (packed, ht (R, wout), hk (R, wout))."""
    R = ck.shape[0]
    S = acc_ca.shape[-1]
    dev = ck.device
    keep = torch.ones_like(ofc) if additive else ~ofc
    cvalid = ck != SENT
    cki = torch.where(cvalid, ck & 7, torch.zeros_like(ck)).long()
    ctax = torch.where(cvalid, ck >> 3, torch.zeros_like(ck)).long()
    sel = cvalid & keep[:, None]
    if file_of_read is not None:
        cki_f = file_of_read.long()[:, None] * weights.shape[0] + cki
    else:
        cki_f = cki
    cell = (cki_f * S + ctax)[sel]
    # in place: T1 counts feed both accumulators directly
    acc_ca.view(-1).index_add_(0, cell, cc[sel].to(torch.float32))
    acc_cu.view(-1).index_add_(0, cell, cc[sel])
    if cadd is not None:
        acc_ca.view(-1).add_(cadd)

    ccf = torch.where(keep[:, None], cc, torch.zeros_like(cc))\
        .to(torch.float32)
    ks_v = torch.where(cvalid, weights[cki] * ccf, torch.zeros_like(ccf))
    tkey = torch.where(cvalid, ctax.to(torch.int32),
                       torch.full_like(ck, SENT))
    ok1, os1, ntax1 = _segment_sums(tkey, ks_v)

    if dm is not None:
        iota_s = torch.arange(S, dtype=torch.int32, device=dev).expand(R, S)
        mk = torch.where(dm > 0, iota_s, torch.full_like(iota_s, SENT))
        mk2, midx = torch.sort(mk, dim=1, stable=True)
        mk2 = mk2[:, :wm]
        mv2 = torch.gather(dm, 1, midx)[:, :wm]
        mv2 = torch.where(mk2 != SENT, mv2, torch.zeros_like(mv2))
        multi_of = (dm > 0).sum(dim=1) > wm
    else:
        mk2, mv2, multi_of = mlist

    allk = torch.cat([ok1[:, :wout], mk2], dim=1)
    allv = torch.cat([os1[:, :wout], mv2], dim=1)
    k3, p3 = torch.sort(allk, dim=1, stable=True)
    v3 = torch.gather(allv, 1, p3)
    v3 = torch.where(k3 != SENT, v3, torch.zeros_like(v3))
    hk3, hs3, ntax = _segment_sums(k3, v3)
    if hk3.shape[1] < wout:
        # the lists are wout wide even where the merged rows are narrower
        pad = wout - hk3.shape[1]
        hk3 = torch.cat([hk3, torch.full((R, pad), SENT, dtype=hk3.dtype,
                                         device=dev)], dim=1)
        hs3 = torch.cat([hs3, torch.zeros((R, pad), dtype=hs3.dtype,
                                          device=dev)], dim=1)
    ofl = ofc | (ntax1 > wout) | multi_of | (ntax > wout)
    ht = hk3[:, :wout].contiguous()
    hk = hs3[:, :wout].contiguous()
    hc = ntax.clamp(max=wout).to(torch.int32)
    flags = ofc.to(torch.int32) | (ofl.to(torch.int32) << 1)

    cum = torch.cumsum(hc, 0) - hc
    iw = torch.arange(wout, dtype=torch.int32, device=dev)
    dest = cum[:, None] + iw[None, :]
    ok = (iw[None, :] < hc[:, None]) & (dest < csr_cap)
    dest = torch.where(ok, dest, torch.full_like(dest, csr_cap)).long()
    pairs = torch.stack([ht, hk.view(torch.int32)], dim=-1).reshape(-1, 2)
    csr = torch.zeros((csr_cap + 1, 2), dtype=torch.int32, device=dev)
    csr[dest.reshape(-1)[ok.reshape(-1)]] = pairs[ok.reshape(-1)]
    tail = torch.stack([diag[0], diag[1], hc.sum(dtype=torch.int32),
                        (flags != 0).sum(dtype=torch.int32)])
    packed = torch.cat([hc, flags, csr[:csr_cap].reshape(-1),
                        tail.to(torch.int32)])
    return packed, ht, hk


def turbo_reads_post(ck, cc, ofc, dm, weights, acc_ca, acc_cu, diag,
                     csr_cap: int, file_of_read=None, mlist=None, *,
                     wm: int = WM, additive: bool = False, cadd=None,
                     wout: int = WOUT):
    """K3 (post) wrapper."""
    if ck.device.type == "cpu":
        return turbo_reads_post_plain(ck, cc, ofc, dm, weights, acc_ca,
                                      acc_cu, diag, csr_cap, file_of_read,
                                      mlist, wm=wm, additive=additive,
                                      cadd=cadd, wout=wout)
    from .. import kernels
    return kernels.turbo_reads_post(ck, cc, ofc, dm, weights, acc_ca,
                                    acc_cu, diag, csr_cap, SENT, wout, wm,
                                    file_of_read, mlist, additive=additive,
                                    cadd=cadd)


# ---------------------------------------------------------------------------
# K5 dedup: -e (kasa_tpu turbo.py:128 dedup_read_windows)

def dedup_windows_plain(q: torch.Tensor, num_reads: int,
                        kmers_per_read: int) -> torch.Tensor:
    """(R * kpr, L) int32 read-major windows -> the same windows sorted
    per read by (limb0, ..., limb L-1), every window equal to its
    predecessor replaced by POISON_LIMB in all its limbs.  Limbs are
    non-negative 30-bit values, so stable sorts from the last limb to the
    first order them as kasa_tpu's L-key sort."""
    R, kpr, L = num_reads, kmers_per_read, q.shape[1]
    rows = q.reshape(R, kpr, L)
    order = torch.arange(kpr, device=q.device).expand(R, kpr)
    for i in range(L - 1, -1, -1):
        _, o = torch.sort(torch.gather(rows[:, :, i], 1, order), dim=1,
                          stable=True)
        order = torch.gather(order, 1, o)
    ss = torch.gather(rows, 1, order[:, :, None].expand(R, kpr, L))
    dup = torch.zeros((R, kpr), dtype=torch.bool, device=q.device)
    dup[:, 1:] = (ss[:, 1:] == ss[:, :-1]).all(dim=2)
    out = torch.where(dup[:, :, None], torch.full_like(ss, POISON_LIMB), ss)
    return out.reshape(R * kpr, L).contiguous()


def dedup_windows(q: torch.Tensor, num_reads: int,
                  kmers_per_read: int) -> torch.Tensor:
    """K5 wrapper."""
    if q.device.type == "cpu":
        return dedup_windows_plain(q, num_reads, kmers_per_read)
    from .. import kernels
    return kernels.dedup_windows(q, num_reads, kmers_per_read, POISON_LIMB)


def dedup_windows_np(q: np.ndarray) -> np.ndarray:
    """Host twin for the overflow fallback: distinct windows only, in
    first-occurrence order (kasa_tpu turbo.py:148-158)."""
    if q.shape[1] == 2:
        q64 = (q[:, 0].astype(np.int64) << LIMB_BITS) \
            | q[:, 1].astype(np.int64)
        _, first = np.unique(q64, return_index=True)
        return q[np.sort(first)]
    qq = np.ascontiguousarray(q)
    v = qq.view([("", qq.dtype)] * qq.shape[1]).ravel()
    _, first = np.unique(v, return_index=True)
    return qq[np.sort(first)]


# ---------------------------------------------------------------------------
# the batch step (kasa_tpu turbo.py:1175 fused_turbo_acc)

def fused_turbo_acc(tt: TurboTables, byte_mat: torch.Tensor,
                    lut: torch.Tensor, acc_ca: torch.Tensor,
                    acc_cu: torch.Tensor, num_reads: int, w_per_line: int,
                    csr_cap: int, multi_budget: int | None = None,
                    exp_budget: int | None = None, *, protein: bool = False,
                    one_frame: bool = False, lines_per_read: int = 1,
                    unique: bool = False, file_of_read=None,
                    wout: int = WOUT):
    """One batch: (rows, maxlen) uint8 read matrix, lines_per_read rows
    per read -> packed readback.

    acc_ca (numK, S) f32 and acc_cu (numK, S) int32 accumulate this
    batch's counts IN PLACE (kasa_tpu donates and returns new buffers).
    With file_of_read ((R,) int32, non-decreasing) they are (F, numK, S)
    and each read counts in its file's slab (kasa_tpu's
    fused_turbo_files).  unique (-e) dedups each read's windows (K5)
    before the search.  Returns (packed, hit_tax, hit_ksum): packed
    (2R + 2*csr_cap + 4,) int32 as in kasa_tpu; hit_tax/hit_ksum the
    dense (R, wout) lists the decode reads when the CSR overflows
    csr_cap (kasa_tpu's lists are WOUT wide; batch_budgets widens a
    long batch's)."""
    from ..core.encode import encode_windows
    kpr = w_per_line * lines_per_read
    q = encode_windows(byte_mat, lut, w_per_line, protein, one_frame,
                       tt.highest_k)
    if unique:
        q = dedup_windows(q, num_reads, kpr)
    return turbo_core(tt, q, num_reads, kpr, acc_ca, acc_cu, csr_cap,
                      multi_budget, exp_budget, file_of_read, wout)


def turbo_core(tt: TurboTables, q: torch.Tensor, num_reads: int,
               kmers_per_read: int, acc_ca: torch.Tensor,
               acc_cu: torch.Tensor, csr_cap: int,
               multi_budget: int | None = None,
               exp_budget: int | None = None, file_of_read=None,
               wout: int = WOUT, flag_reduce=None):
    """The classify step on (R * kpr, L) int32 windows in read-major
    layout (kasa_tpu's _turbo_core plus the packed tail): K2, K3 (pre),
    K4, then the dense fold (the two hot-set products) or, for more than
    SPARSE_FOLD_S species without a hot tier, the sparse fold (K4's
    counts-only arm and K6), then K3 (post).  The dense fold lists up to
    wout multi taxa a read, the sparse fold K6's WM.  flag_reduce (the
    mesh) makes K4's count-overflow flags global before anything is
    counted: K4 expands, K6 folds and K3 post counts under them."""
    sparse = tt.hotmask.shape[0] <= 1 and tt.num_species > SPARSE_FOLD_S
    mb = int(multi_budget or MULTI_BUDGET)
    eb = int(exp_budget or EXP_BUDGET)
    skey, mpay = turbo_match(q, tt, num_reads, kmers_per_read)
    ck, cc, runs, mcnt, cp = turbo_reads_pre(skey, mpay,
                                             num_species=tt.num_species)
    ofc, dm, a3w, a3c, diag = turbo_multi(cp, mcnt, runs, tt, acc_ca, mb, eb,
                                          file_of_read, counts_only=sparse,
                                          flag_reduce=flag_reduce)
    if sparse:
        mlist = sparse_fold(cp, mcnt, ofc, tt)
        return turbo_reads_post(ck, cc, ofc, None, tt.weights, acc_ca,
                                acc_cu, diag, csr_cap, file_of_read, mlist,
                                wout=wout)
    # hot-set products against the 0/1 membership mask (kasa_tpu leaves
    # them to an XLA dot); TF32 is off (kasa_tpu_torch/__init__.py)
    dm.addmm_(a3w, tt.hotmask)
    acc_ca.view(-1, tt.num_species).addmm_(a3c, tt.hotmask)
    return turbo_reads_post(ck, cc, ofc, dm, tt.weights, acc_ca, acc_cu,
                            diag, csr_cap, file_of_read, wm=wout, wout=wout)


# ---------------------------------------------------------------------------
# kasa_tpu's standalone entry points over the same step (turbo.py:1011,
# 1027, 1142): no count accumulators to carry, the outputs unpacked

def turbo_classify(tt: TurboTables, q: torch.Tensor, num_reads: int,
                   kmers_per_read: int, multi_budget: int | None = None,
                   exp_budget: int | None = None):
    """kasa_tpu's turbo_classify: the step on (R * kpr, L) encoded
    windows -> (hit_tax (R, WOUT) int32, hit_ksum (R, WOUT) f32,
    hit_count (R,) int32, counts_all (numK, S) f32, counts_unique
    (numK, S) int32, oflow_flag (R,) bool, oflow_lists (R,) bool)."""
    R, S = num_reads, tt.num_species
    acc_ca = torch.zeros((tt.num_k, S), dtype=torch.float32,
                         device=q.device)
    acc_cu = torch.zeros((tt.num_k, S), dtype=torch.int32, device=q.device)
    packed, ht, hk = turbo_core(tt, q, R, kmers_per_read, acc_ca, acc_cu,
                                R * WOUT, multi_budget, exp_budget)
    flags = packed[R:2 * R]
    return (ht, hk, packed[:R], acc_ca, acc_cu, (flags & 1) > 0,
            (flags & 2) > 0)


def fused_turbo(tt: TurboTables, byte_mat: torch.Tensor, lut: torch.Tensor,
                num_reads: int, w_per_line: int, *, protein: bool = False,
                one_frame: bool = False, lines_per_read: int = 1):
    """kasa_tpu's fused_turbo: a (rows, maxlen) uint8 read matrix through
    K1 and turbo_classify."""
    from ..core.encode import encode_windows
    q = encode_windows(byte_mat, lut, w_per_line, protein, one_frame,
                       tt.highest_k)
    return turbo_classify(tt, q, num_reads, w_per_line * lines_per_read)


# the stages fused_turbo_probe can stop after; kasa_tpu's other stage
# names ("search", "slots", "wsort1", "wsort2", "bands") fall inside one
# kernel here (K2, K4)
PROBE_STAGES = ("encode", "t1sort", "fold")


def fused_turbo_probe(tt: TurboTables, byte_mat: torch.Tensor,
                      lut: torch.Tensor, num_reads: int, w_per_line: int,
                      probe: str | None, *, protein: bool = False,
                      one_frame: bool = False, lines_per_read: int = 1):
    """kasa_tpu's fused_turbo_probe, for profiling: fused_turbo stopped
    after stage `probe`, returning one float checksum of it, the same
    number kasa_tpu's gives: "encode" the int32 sum of the windows,
    "t1sort" the T == 1 slots plus their runs (after K2 and K3 pre),
    "fold" the sum of both count matrices; None runs the whole step and
    sums the hit counts, counts_all and the hit scores."""
    from ..core.encode import encode_windows
    if probe is not None and probe not in PROBE_STAGES:
        raise ValueError(f"probe {probe!r}: the port stops after "
                         f"{PROBE_STAGES} or None")
    q = encode_windows(byte_mat, lut, w_per_line, protein, one_frame,
                       tt.highest_k)
    kpr = w_per_line * lines_per_read
    if probe == "encode":
        wrapped = q.to(torch.int64).sum().item() & 0xFFFFFFFF
        return float(np.float32(np.uint32(wrapped).view(np.int32)))
    if probe == "t1sort":
        skey, mpay = turbo_match(q, tt, num_reads, kpr)
        _, _, runs, _, _ = turbo_reads_pre(skey, mpay,
                                           num_species=tt.num_species)
        n1 = int((skey != SENT).sum()) + int(runs.sum())
        return float(np.float32(n1))
    ht, hk, hc, ca, cu, _, _ = turbo_classify(tt, q, num_reads, kpr)
    if probe == "fold":
        return float(ca.sum() + cu.sum().to(torch.float32))
    return float(hc.sum().to(torch.float32) + ca.sum() + hk.sum())


# ---------------------------------------------------------------------------
# exact host recompute of flagged reads (kasa_tpu turbo.py:1061)

def host_classify_read(tables: TurboTables, q_limbs: np.ndarray):
    """Exact scoring of ONE read's windows on host (overflow fallback).

    Mirrors the kernel's pos/prev full-key logic in numpy with the
    unpadded CSR taxa lists (no budgets).  Returns
    (hits dict tax -> ksum float32, counts_all (numK, S) f64 add,
    counts_unique (numK, S) int add)."""
    num_k = tables.max_k - tables.min_k + 1
    S = tables.num_species
    idx_limbs = tables.host_limbs
    n = len(idx_limbs)
    L = q_limbs.shape[1]
    if L == 2:
        q64 = (q_limbs[:, 0].astype(np.int64) << LIMB_BITS) \
            | q_limbs[:, 1].astype(np.int64)
        pos = np.searchsorted(tables.host_key64(), q64)
    else:
        pos = lex_lower_bound_np(idx_limbs, q_limbs)
    pos_c = np.minimum(pos, n - 1)
    prev = np.maximum(pos - 1, 0)

    def letter(p):
        i, j = divmod(p, kmer.LETTERS_PER_LIMB)
        shift = kmer.BITS_PER_LETTER * (kmer.LETTERS_PER_LIMB - 1 - j)
        return (q_limbs[:, i] >> shift) & 31
    ok = np.ones(len(q_limbs), bool)
    cum = {}
    for p in range(tables.min_k - 1, tables.max_k):
        ok = ok & (letter(p) != 30)
        cum[p + 1] = ok.copy()

    counts_all = np.zeros((num_k, S), np.float64)
    counts_unique = np.zeros((num_k, S), np.int64)
    score_vec = np.zeros(S, np.float32)
    for ki in range(num_k):
        k = tables.max_k - ki
        mrow = tables.host_masks[ki]
        qm = q_limbs & mrow
        hit_at = (pos < n) & np.all(
            (idx_limbs[pos_c] & mrow) == qm, axis=1)
        hit_pv = (pos > 0) & np.all(
            (idx_limbs[prev] & mrow) == qm, axis=1)
        matched = (hit_at | hit_pv) & cum[k]
        if not matched.any():
            continue
        psel = np.where(hit_pv, prev, pos_c)
        gs = tables.host_grp_start[ki]
        dt = tables.host_d_tax[ki]
        w = np.float32(weight(k))
        g = tables.host_grp_id[ki][psel[matched]]
        starts = gs[g].astype(np.int64)
        T = (gs[g + 1] - gs[g]).astype(np.int64)
        total = int(T.sum())
        if total == 0:
            continue
        cum_t = np.cumsum(T) - T
        flat = np.arange(total, dtype=np.int64)
        within = flat - np.repeat(cum_t, T)
        tax_flat = dt[np.repeat(starts, T) + within]
        invT = 1.0 / T
        np.add.at(counts_all[ki], tax_flat, np.repeat(invT, T))
        uniq = T == 1
        if uniq.any():
            np.add.at(counts_unique[ki], dt[starts[uniq]], 1)
        sv32 = np.zeros(S, np.float32)
        np.add.at(sv32, tax_flat,
                  np.repeat((w / T).astype(np.float32), T))
        score_vec += sv32
    nz = np.nonzero(score_vec)[0]
    scores = {int(t): np.float32(score_vec[t]) for t in nz}
    return scores, counts_all, counts_unique


def read_windows_np(mat_rows: np.ndarray, lut_np: np.ndarray,
                    highest_k: int, protein: bool, one_frame: bool,
                    w_per_line: int) -> np.ndarray:
    """Host twin of the batch windowing for ONE read's padded line(s)
    (overflow fallback).  mat_rows: (lpr, maxlen) uint8."""
    from ..core.encode import dna_to_aa_codes_np, encode_windows_np
    stride = 1 if protein else 3
    outs = []
    for line in mat_rows:
        buf = np.concatenate([line, np.zeros(stride * highest_k, np.uint8)])
        aa = dna_to_aa_codes_np(buf, lut_np, protein=protein)
        win = encode_windows_np(aa, highest_k, stride)
        if one_frame and not protein:
            win = win[::3]
        outs.append(win[:w_per_line])
    return np.concatenate(outs, axis=0)


# ---------------------------------------------------------------------------
# the .tabs sidecar (kasa_tpu turbo.py:1321-1476), same format both ways

_CACHE_VERSION = 8
_TT_RAM_CACHE: dict = {}


def _tax_rows_crc(tax_rows: np.ndarray) -> int:
    """Checksum of the taxon-row mapping baked into rowdat/d_tax (the
    content file can change without the index file changing)."""
    return zlib.crc32(np.ascontiguousarray(tax_rows, np.int32).tobytes())


def save_turbo(arrays: dict, meta: dict, path: str, tax_crc: int = 0):
    """Persist the tables as a DIRECTORY of raw .npy files (path gets a
    .tabs suffix), the layout kasa_tpu's load_turbo reads."""
    d = path + ".tabs"
    tmp = f"{d}.{os.getpid()}.tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    files = {f: arrays[f] for f in DEVICE_FIELDS}
    num_k = meta["max_k"] - meta["min_k"] + 1
    for i in range(num_k):
        files[f"gs{i}"] = arrays["host_grp_start"][i]
        files[f"dt{i}"] = arrays["host_d_tax"][i]
        files[f"gi{i}"] = arrays["host_grp_id"][i]
    for name, a in files.items():
        np.save(os.path.join(tmp, name + ".npy"), np.asarray(a))
    with open(os.path.join(tmp, "meta.json"), "w") as fh:
        json.dump({"version": _CACHE_VERSION, "tax_crc": int(tax_crc),
                   "n_entries": int(len(arrays["host_limbs"])),
                   "resid": RESID, "sub_bits": SUB_BITS,
                   "params": [int(meta[f]) for f in META_FIELDS]}, fh)
    shutil.rmtree(d, ignore_errors=True)
    try:
        os.replace(tmp, d)
    except OSError:
        # another process renamed its copy first: keep that one
        shutil.rmtree(tmp, ignore_errors=True)


def load_turbo_np(path: str, limbs: np.ndarray,
                  tax_crc: int | None = None):
    """-> (arrays, meta) from a .tabs sidecar, or None when it is
    missing, stale or of another version."""
    d = path + ".tabs"
    try:
        with open(os.path.join(d, "meta.json")) as fh:
            meta_j = json.load(fh)
        if meta_j["version"] != _CACHE_VERSION:
            return None
        if tax_crc is not None and meta_j["tax_crc"] != tax_crc:
            return None
        if meta_j["n_entries"] != len(limbs):
            return None
        if meta_j.get("resid", 8) != RESID \
                or meta_j.get("sub_bits", 16) != SUB_BITS:
            return None
        meta = dict(zip(META_FIELDS, meta_j["params"]))

        def arr(name):
            return np.load(os.path.join(d, name + ".npy"), mmap_mode="r")
        num_k = meta["max_k"] - meta["min_k"] + 1
        arrays = {f: arr(f) for f in DEVICE_FIELDS}
        arrays["host_masks"] = np.array(arrays["masks2"])
        arrays["host_limbs"] = limbs
        arrays["host_grp_start"] = [arr(f"gs{i}") for i in range(num_k)]
        arrays["host_d_tax"] = [arr(f"dt{i}") for i in range(num_k)]
        arrays["host_grp_id"] = [arr(f"gi{i}") for i in range(num_k)]
        return arrays, meta
    except (OSError, ValueError, KeyError):
        return None


def load_or_build_turbo(index_path: str, limbs: np.ndarray,
                        tax_rows: np.ndarray, highest_k: int, min_k: int,
                        max_k: int, num_species: int, device,
                        content_token=None, tag: str = "") -> TurboTables:
    """Process + disk cached turbo tables for an on-disk index: the
    sidecar `<index>.turbo_<minK>_<maxK><tag>.npz.tabs` is read when
    fresh, else the tables are built and the sidecar written.  A mesh
    shard passes its slice of the index and a tag naming the shard.

    content_token: a stamp of the content file (its mtime_ns): with it,
    repeat calls hit the RAM cache without re-CRCing the tax-row
    mapping (0.1 s at 32.7 M entries); the CRC still guards the disk
    sidecar."""
    fast_key = None
    if content_token is not None:
        try:
            fast_key = (os.path.abspath(index_path),
                        os.path.getmtime(index_path), min_k, max_k,
                        num_species, "tok", content_token, str(device), tag)
        except OSError:
            fast_key = None
        if fast_key in _TT_RAM_CACHE:
            return _TT_RAM_CACHE[fast_key]
    with timers.stage("turbo/tables-crc"):
        tax_crc = _tax_rows_crc(tax_rows)
    key = None
    try:
        key = (os.path.abspath(index_path), os.path.getmtime(index_path),
               min_k, max_k, num_species, tax_crc, str(device), tag)
    except OSError:
        pass
    if key is not None and key in _TT_RAM_CACHE:
        if fast_key is not None:
            _TT_RAM_CACHE[fast_key] = _TT_RAM_CACHE[key]
        return _TT_RAM_CACHE[key]
    got = None
    cache_path = f"{index_path}.turbo_{min_k}_{max_k}{tag}.npz"
    meta_path = os.path.join(cache_path + ".tabs", "meta.json")
    fresh = (os.path.exists(meta_path)
             and os.path.getmtime(meta_path) >= os.path.getmtime(index_path))
    if key is not None and fresh:
        with timers.stage("turbo/tables-diskload"):
            got = load_turbo_np(cache_path, limbs, tax_crc)
    if got is None:
        with timers.stage("turbo/tables-build"):
            got = build_tables_np(limbs, tax_rows, highest_k, min_k, max_k,
                                  num_species)
        if key is not None:
            try:
                save_turbo(*got, cache_path, tax_crc)
            except OSError:
                pass
    with timers.stage("turbo/tables-upload"):
        tt = tables_from_numpy(*got, device)
    if key is not None:
        _TT_RAM_CACHE.clear()   # device memory: hold one index at a time
        _TT_RAM_CACHE[key] = tt
        if fast_key is not None:
            _TT_RAM_CACHE[fast_key] = tt
    return tt
