"""The tiered beyond-resident identify (port of kasa_tpu/match/tiered.py)
and the decode of the packed per-batch readback.

An index whose turbo tables exceed the device budget is cut on the host
into chunks that start on a new limb0 value (k >= 6 prefixes nest inside
limb0 runs), each chunk in a compact layout (build_chunk_tables):

  rowdat  (pad, 4) int32 [l0, l1, tax, tpack], tpack = per-level
          min(T, 31) in 5-bit fields (31 = big, added on the host);
  mstart  ragged int32 flat + moff offsets: per level, the sorted entry
          indices of the multi (2 <= T <= TMAX) group starts;
  mrow    same layout: the group's d_tax4 row;
  d_tax4  (DR, 4) int32 taxa rows, -1 tail sentinels.

Per batch, on the device:

  K1 encode (and K5 dedup under -e) make the windows as on the resident
     path;
  K7 tiered_route (kasa_tpu's tiered_prepare + chunk_cuts) computes each
     window's validity bits and routes the windows to the chunk owning
     their limb0 (histogram, exclusive scan, stable scatter; the chunk
     offsets equal kasa_tpu's cuts);
  K8 tiered_pass (kasa_tpu's tiered_chunk_pass), once per chunk with
     windows, searches that chunk: T == 1 keys to the window's (M+1,
     numK) slot row, multi groups with T <= TMAX expanded into the dense
     (R, S) score rows and the (numK, S) counts, a per-read big flag for
     any hit with T > TMAX;
  K3's additive arm (kasa_tpu's tiered_finish): the resident tail over
     the full slot width, flagged reads' counts kept, lists from the
     dense rows with WM = min(S, 256).

Chunks stay on the device while a share of the budget lasts; the rest
are uploaded for every batch (from a host-RAM copy when it fits, else
from the npz chunk cache on disk).  The host then ADDS what the skipped
T > TMAX groups contribute to a flagged read and rebuilds truncated
lists in full, both from one pass over the read's windows (host_fixup):
a fixed split, so counts never depend on what else is in the batch.

Every device piece has a plain PyTorch version here; the wrappers take it
only for CPU tensors and launch the kernel on CUDA tensors.
"""

from __future__ import annotations

import json
import os
import zlib

import numpy as np
import torch

from ..core import kmer
from ..utils import timers
from .fast import TurboDispatchBase, device_table_budget
from .join import build_group_table, weight
from .turbo import I32_MAX, LIMB_BITS, SENT, batch_budgets, \
    turbo_reads_post, turbo_reads_pre

TMAX = 30                   # device-handled taxa per group (the 5-bit
                            # tpack clamp makes 31 = "big")
PASS_CAP = 1 << 15          # kasa_tpu's windows per chunk pass (a fixed
                            # compiled shape there; K8 takes a chunk's
                            # windows in one launch)
TIERED_FIELDS = ("rowdat", "mstart", "mrow", "moff", "d_tax4")
_TIER_CACHE_VERSION = 4


def bytes_per_entry_tiered(num_k: int) -> int:
    """Device bytes per entry of the compact chunk layout: 16 B rowdat +
    amortized taxa rows + ragged multi-start tables (kasa_tpu's
    estimate)."""
    return 24


def chunk_entries_for(budget: int, num_k: int) -> int:
    """Entries per chunk for a device budget of `budget` bytes: three
    quarters of it in the compact layout, at least 2^16."""
    return max(int(budget * 0.75) // bytes_per_entry_tiered(num_k), 1 << 16)


# ---------------------------------------------------------------------------
# tables (host, numpy)

def build_chunk_tables(limbs: np.ndarray, tax_rows: np.ndarray,
                       highest_k: int, min_k: int, max_k: int,
                       pad_to: int) -> dict:
    """One chunk's compact tables (module docstring), rowdat padded to
    pad_to rows of I32_MAX.  Bit for bit kasa_tpu's."""
    n = len(tax_rows)
    num_k = max_k - min_k + 1
    tables = [build_group_table(limbs, tax_rows, highest_k, max_k - ki)
              for ki in range(num_k)]
    rowdat = np.full((pad_to, 4), I32_MAX, np.int32)
    rowdat[:n, 0:2] = limbs
    rowdat[:n, 2] = tax_rows
    tpack = np.zeros(n, np.int32)
    mstart_l, mrow_l = [], []
    d_parts = [np.full((1, 4), -1, np.int32)]    # row 0 reserved
    row_next = 1
    for ki in range(num_k):
        t = tables[ki]
        sizes = np.diff(t.grp_start).astype(np.int64)      # (G,)
        T_entry = sizes[t.grp_id]
        tpack |= (np.minimum(T_entry, 31) << (5 * ki)).astype(np.int32)
        multi_g = (sizes >= 2) & (sizes <= TMAX)
        # first entry index of each group (grp_id is non-decreasing)
        entry_start = np.r_[0, 1 + np.nonzero(np.diff(t.grp_id))[0]] \
            if n else np.zeros(0, np.int64)
        rows_per = np.where(multi_g, (sizes + 3) // 4, 0)
        rb = np.zeros(len(sizes) + 1, np.int64)
        np.cumsum(rows_per, out=rb[1:])
        total_rows = int(rb[-1])
        mstart_l.append(entry_start[multi_g].astype(np.int32))
        mrow_l.append((row_next + rb[:-1][multi_g]).astype(np.int32))
        if total_rows:
            buf = np.full(total_rows * 4, -1, np.int32)
            sizes32 = np.diff(t.grp_start)
            pair_grp = np.repeat(np.arange(len(sizes32)), sizes32)
            within = np.arange(len(t.d_tax)) - t.grp_start[pair_grp]
            sel = multi_g[pair_grp]
            dst = rb[pair_grp[sel]] * 4 + within[sel]
            buf[dst] = t.d_tax[sel]
            d_parts.append(buf.reshape(-1, 4))
            row_next += total_rows
    d_tax4 = np.concatenate(d_parts, axis=0)
    rowdat[:n, 3] = tpack
    moff = np.zeros(num_k + 1, np.int32)
    np.cumsum([len(a) for a in mstart_l], out=moff[1:])
    mstart = np.concatenate(mstart_l) if moff[-1] \
        else np.zeros(1, np.int32)
    mrow = np.concatenate(mrow_l) if moff[-1] else np.zeros(1, np.int32)
    return dict(rowdat=rowdat, mstart=mstart, mrow=mrow, moff=moff,
                d_tax4=d_tax4, n=np.int64(n))


def chunk_plan(limbs: np.ndarray, chunk_entries: int) -> list:
    """[(a, b), ...] entry ranges: each chunk takes whole limb0 runs while
    they fit chunk_entries (a first run longer than that alone).  The
    greedy walk of kasa_tpu (tiered.py:558-571), one bisect per chunk."""
    n = len(limbs)
    run_starts = np.nonzero(limbs[1:, 0] != limbs[:-1, 0])[0] + 1
    bounds = np.r_[run_starts, n]          # run ends, increasing
    cuts = [0]
    while cuts[-1] < n:
        a = cuts[-1]
        i = int(np.searchsorted(bounds, a + chunk_entries, side="right")) - 1
        if i < 0 or bounds[i] <= a:
            i = int(np.searchsorted(bounds, a, side="right"))
        cuts.append(int(bounds[i]))
    return [(cuts[i], cuts[i + 1]) for i in range(len(cuts) - 1)]


def _steps(n: int) -> int:
    s = 1
    while (1 << s) < n + 1:
        s += 1
    return s


# ---------------------------------------------------------------------------
# K7 tiered_route (kasa_tpu tiered.py:140 tiered_prepare, 184 chunk_cuts)

def window_vbits(q: torch.Tensor, min_k: int, max_k: int) -> torch.Tensor:
    """(M, 2) windows -> (M,) int32 validity bits: bit ki set while no
    letter min_k-1 .. k-1 is '^' (k = max_k - ki)."""
    ok = torch.ones(q.shape[0], dtype=torch.bool, device=q.device)
    vbits = torch.zeros(q.shape[0], dtype=torch.int32, device=q.device)
    for pos in range(min_k - 1, max_k):
        i, j = divmod(pos, kmer.LETTERS_PER_LIMB)
        shift = kmer.BITS_PER_LETTER * (kmer.LETTERS_PER_LIMB - 1 - j)
        ok = ok & (((q[:, i] >> shift) & 31) != 30)
        vbits |= ok.to(torch.int32) << (max_k - (pos + 1))
    return vbits


def tiered_route_plain(q: torch.Tensor, chunk_limb0: torch.Tensor,
                       min_k: int, max_k: int):
    """(M, 2) int32 windows -> (qr (M, 2), vbr (M,), posr (M,), cuts (C,))
    int32: the windows grouped by the chunk owning their limb0 (the last
    chunk whose first limb0 is <= the window's), windows below the first
    chunk first, each group in window order; cuts[c] = the first routed
    position of chunk c, the number of windows whose limb0 sorts below
    chunk_limb0[c] (kasa_tpu's chunk_cuts on its sorted windows)."""
    vbits = window_vbits(q, min_k, max_k)
    C = chunk_limb0.shape[0]
    bins = torch.searchsorted(chunk_limb0, q[:, 0].contiguous(), right=True)
    order = torch.sort(bins, stable=True).indices
    counts = torch.bincount(bins, minlength=C + 1)
    cuts = torch.cumsum(counts, 0)[:C].to(torch.int32)
    return (q[order].contiguous(), vbits[order].contiguous(),
            order.to(torch.int32), cuts)


def tiered_route(q: torch.Tensor, chunk_limb0: torch.Tensor, min_k: int,
                 max_k: int):
    """K7 wrapper: the CUDA kernel on a CUDA tensor, else the plain
    version."""
    if q.device.type == "cpu":
        return tiered_route_plain(q, chunk_limb0, min_k, max_k)
    from .. import kernels
    return kernels.tiered_route(q, chunk_limb0, min_k, max_k)


# ---------------------------------------------------------------------------
# K8 tiered_pass (kasa_tpu tiered.py:201 tiered_chunk_pass)

def level_masks(highest_k: int, min_k: int, max_k: int):
    """-> ((numK, 2) masks of each level's k-prefix on the two limbs,
    the full-key masks (2,)), python ints."""
    masks = [[int(m) for m in kmer.prefix_masks(highest_k, max_k - ki)[:2]]
             for ki in range(max_k - min_k + 1)]
    full = [int(m) for m in kmer.prefix_masks(highest_k, highest_k)[:2]]
    return masks, full


def tiered_pass_plain(tabs, weights, qr, vbr, posr, lo: int, hi: int,
                      skey, sflat, cflat, big, num_steps: int, msteps: int,
                      masks, full, num_species: int, kmers_per_read: int):
    """Search the routed windows [lo, hi) against one chunk's tables and
    add to the batch state in place: skey (M+1, numK) int32 T == 1 keys
    tax*8+ki at the window's position (I32_MAX otherwise), sflat (R*S+1,)
    f32 score rows and cflat (numK*S+1,) f32 counts of the multi groups
    with T <= TMAX (each taxon of the group gets w(k)/T and 1/T), big
    (R+1,) int32 set to 1 for a read with a hit on a group of T > TMAX.

    kasa_tpu's arithmetic: the fixed-step bisect over the padded rowdat
    with min(mid, n-1), the at/prev hit test per level (prev wins when it
    hits), the msteps bisect over the level's slice of mstart with its
    act guard and mp-1 clamps.  A lane expands its own group's
    ceil(T/4) taxa rows only."""
    rowdat, mstart, mrow_t, moff, d_tax4 = tabs[:5]
    S = num_species
    dev = qr.device
    n = rowdat.shape[0]
    q = qr[lo:hi]
    vb = vbr[lo:hi]
    ps = posr[lo:hi].long()
    qh, ql = q[:, 0], q[:, 1]
    m = hi - lo
    blo = torch.zeros(m, dtype=torch.int64, device=dev)
    bhi = torch.full((m,), n, dtype=torch.int64, device=dev)
    for _ in range(num_steps):
        mid = (blo + bhi) >> 1
        kk = rowdat[mid.clamp(max=n - 1)]
        less = (kk[:, 0] < qh) | ((kk[:, 0] == qh) & (kk[:, 1] < ql))
        blo = torch.where(less, mid + 1, blo)
        bhi = torch.where(less, bhi, mid)
    pos = blo
    pos_c = pos.clamp(max=n - 1)
    at_n = pos >= n
    at = rowdat[pos_c]
    prev = (pos - 1).clamp(min=0)
    # a window above every key ends at pos = n + 1 (the fixed step
    # count): its prev row gathers clamped to n - 1, as a JAX gather
    # does, while psel keeps prev = n
    pv = rowdat[prev.clamp(max=n - 1)]
    prev_ok = pos > 0
    rid = ps // kmers_per_read
    mp = mstart.shape[0]
    dr = d_tax4.shape[0]
    moff_h = [int(v) for v in moff.tolist()]
    masks = masks.tolist()
    big_hit = torch.zeros(m, dtype=torch.bool, device=dev)
    for ki in range(len(masks)):
        hit_at, hit_pv = ~at_n, prev_ok
        for i in range(2):
            mi = masks[ki][i]
            if mi == 0:
                continue
            if mi == full[i]:
                hit_at = hit_at & (at[:, i] == q[:, i])
                hit_pv = hit_pv & (pv[:, i] == q[:, i])
            else:
                qi = q[:, i] & mi
                hit_at = hit_at & ((at[:, i] & mi) == qi)
                hit_pv = hit_pv & ((pv[:, i] & mi) == qi)
        matched = (hit_at | hit_pv) & (((vb >> ki) & 1) == 1)
        tax = torch.where(hit_pv, pv[:, 2], at[:, 2])
        tp = torch.where(hit_pv, pv[:, 3], at[:, 3])
        psel = torch.where(hit_pv, prev, pos_c)
        tc = torch.where(matched, (tp >> (5 * ki)) & 31,
                         torch.zeros_like(tp))
        skey[ps, ki] = torch.where(tc == 1, tax * 8 + ki,
                                   torch.full_like(tax, SENT))
        small = matched & (tc >= 2) & (tc <= TMAX)
        big_hit |= matched & (tc > TMAX)
        if not bool(small.any()):
            continue
        mbase = moff_h[ki]
        mlo = torch.zeros(m, dtype=torch.int64, device=dev)
        mhi = torch.full((m,), moff_h[ki + 1] - mbase, dtype=torch.int64,
                         device=dev)
        for _ in range(msteps):
            act = mlo < mhi
            mid = (mlo + mhi) >> 1
            le = mstart[(mbase + mid).clamp(max=mp - 1)] <= psel
            mlo = torch.where(act & le, mid + 1, mlo)
            mhi = torch.where(act & ~le, mid, mhi)
        rowb = mrow_t[(mbase + (mlo - 1).clamp(min=0)).clamp(max=mp - 1)]
        T = tc[small].long()
        rowb, rid_s = rowb[small].long(), rid[small]
        nrow = (T + 3) >> 2
        sl = torch.repeat_interleave(torch.arange(len(T), device=dev), nrow)
        j = torch.arange(len(sl), device=dev) - (torch.cumsum(nrow, 0)
                                                 - nrow)[sl]
        taxa = d_tax4[(rowb[sl] + j).clamp(max=dr - 1)].long()
        ok = taxa >= 0
        inv = 1.0 / T.to(torch.float32)
        val = weights[ki] * inv
        sflat.index_add_(0, (rid_s[sl][:, None] * S + taxa)[ok],
                         val[sl][:, None].expand(-1, 4)[ok])
        cflat.index_add_(0, (ki * S + taxa)[ok],
                         inv[sl][:, None].expand(-1, 4)[ok])
    big[rid[big_hit]] = 1


PREFIX_BITS = 20


def tiered_prefix_plain(rowdat: torch.Tensor) -> torch.Tensor:
    """Plain version of K8's prefix table (kernels.tiered_prefix), for a
    chunk's (n, 4) rowdat whose pad rows hold INT32_MAX: 2^20 buckets of
    limb 0 from base (the first row's) in steps of 2^shift, the least
    shift that puts the last real row in the last bucket or below; entry
    b of 2^20 + 1 the first row whose limb 0 is >= base + (b << shift),
    then base and shift."""
    x = rowdat[:, 0].long().contiguous()
    nreal = int(torch.searchsorted(x, torch.tensor(1 << 30,
                                                   device=x.device)))
    base = int(x[0]) if nreal else 0
    span = int(x[nreal - 1]) - base if nreal else 0
    shift = 0
    while (span >> shift) >= (1 << PREFIX_BITS):
        shift += 1
    keys = base + (torch.arange((1 << PREFIX_BITS) + 1, dtype=torch.int64,
                                device=x.device) << shift)
    starts = torch.searchsorted(x, keys).to(torch.int32)
    return torch.cat([starts, torch.tensor([base, shift], dtype=torch.int32,
                                           device=x.device)])


def tiered_pass(tabs, weights, qr, vbr, posr, lo: int, hi: int, skey, sflat,
                cflat, big, num_steps: int, msteps: int, masks, full,
                num_species: int, kmers_per_read: int):
    """K8 wrapper (tabs: a chunk's TIERED_FIELDS, on the card followed by
    its prefix table, kernels.tiered_prefix; masks: the (numK, 2) int32
    level masks of level_masks, full: the two full-key masks)."""
    if qr.device.type == "cpu":
        return tiered_pass_plain(tabs, weights, qr, vbr, posr, lo, hi, skey,
                                 sflat, cflat, big, num_steps, msteps, masks,
                                 full, num_species, kmers_per_read)
    from .. import kernels
    return kernels.tiered_pass(tabs, weights, qr, vbr, posr, lo, hi, skey,
                               sflat, cflat, big, num_steps, msteps, masks,
                               full, num_species, kmers_per_read, TMAX)


# ---------------------------------------------------------------------------
# K3's additive arm (kasa_tpu tiered.py:354 tiered_finish)

def tiered_finish(skey, sflat, cflat, big, weights, acc_ca, acc_cu,
                  num_reads: int, kmers_per_read: int, csr_cap: int):
    """The batch tail over the filled slot buffers, through K3: pre with
    every (tax, k) run kept (cw = SW, no multi payloads), post's additive
    arm (counts of flagged reads kept, the batch's multi counts cflat
    added, lists from the dense (R, S) rows with WM = min(S, 256), flag
    bit0 = big, bit1 = rebuild; both lists widened for a long batch as
    batch_budgets widens the resident path's).  acc_ca/acc_cu take the
    counts in place.
    -> (packed (2R + 2*csr_cap + 4,) int32, ht, hk (R, wout))."""
    R = num_reads
    num_k = acc_ca.shape[0]
    S = acc_ca.shape[1]
    SW = kmers_per_read * num_k
    ck, cc, _, _, _ = turbo_reads_pre(skey[:R * kmers_per_read].view(R, SW),
                                      None, cw=SW, num_species=S)
    diag = torch.zeros(2, dtype=torch.int32, device=skey.device)
    wout = batch_budgets(SW, S)[2]
    return turbo_reads_post(ck, cc, big[:R] > 0, sflat[:R * S].view(R, S),
                            weights, acc_ca, acc_cu, diag, csr_cap,
                            wm=max(min(S, 256), wout), additive=True,
                            cadd=cflat[:num_k * S], wout=wout)


# ---------------------------------------------------------------------------
# host fixup (the additive contract)

def host_ranges_classify(key64: np.ndarray, tax_rows: np.ndarray,
                         q_limbs: np.ndarray, vbits: np.ndarray,
                         min_k: int, max_k: int, highest_k: int,
                         num_species: int, t_min: int = 0):
    """Exact per-read classification straight off the sorted key64
    array: the group at level k is [lower_bound(qm), lower_bound(qm +
    2^shift)).  The scores take every group; the counts only the groups
    with T > t_min: t_min = TMAX gives exactly the device's skipped
    contributions, t_min = 0 the full read's.
    -> (scores dict, ca add (numK, S) f64, cu add (numK, S) int64)."""
    num_k = max_k - min_k + 1
    S = num_species
    q64 = (q_limbs[:, 0].astype(np.int64) << LIMB_BITS) \
        | q_limbs[:, 1].astype(np.int64)
    ca = np.zeros((num_k, S), np.float64)
    cu = np.zeros((num_k, S), np.int64)
    score = np.zeros(S, np.float32)
    for ki in range(num_k):
        k = max_k - ki
        shift = np.int64(5 * (highest_k - k))
        qm = (q64 >> shift) << shift
        valid = ((vbits >> ki) & 1).astype(bool)
        lo = np.searchsorted(key64, qm)
        hi = np.searchsorted(key64, qm + (np.int64(1) << shift))
        w = np.float32(weight(k))
        for i in np.nonzero(valid & (hi > lo))[0]:
            taxa = np.unique(tax_rows[lo[i]:hi[i]])
            T = len(taxa)
            score[taxa] += np.float32(w / np.float32(T))
            if T <= t_min:
                continue
            ca[ki, taxa] += 1.0 / T
            if T == 1:
                cu[ki, taxa] += 1
    nz = np.nonzero(score)[0]
    return ({int(t): float(score[t]) for t in nz}, ca, cu)


def window_vbits_np(q_limbs: np.ndarray, min_k: int, max_k: int
                    ) -> np.ndarray:
    """Host twin of the validity bits."""
    ok = np.ones(len(q_limbs), bool)
    vbits = np.zeros(len(q_limbs), np.int32)
    for pos in range(min_k - 1, max_k):
        i, j = divmod(pos, kmer.LETTERS_PER_LIMB)
        shift = kmer.BITS_PER_LETTER * (kmer.LETTERS_PER_LIMB - 1 - j)
        ok = ok & (((q_limbs[:, i] >> shift) & 31) != 30)
        vbits = vbits | np.where(ok, 1 << (max_k - (pos + 1)), 0)
    return vbits


# ---------------------------------------------------------------------------
# dispatch

class TieredTurboDispatch(TurboDispatchBase):
    """Drive-loop strategy for indices over the device budget: the same
    interface and packed readback as SingleTurboDispatch, chunk-streamed
    tables inside dispatch().  additive_fixup marks the T > TMAX host-ADD
    contract."""

    additive_fixup = True
    tt = None                   # no resident tables

    def __init__(self, index_path: str, limbs: np.ndarray,
                 tax_rows: np.ndarray, highest_k: int, min_k: int,
                 max_k: int, num_species: int, chunk_entries: int,
                 device: torch.device, cache_dir: str | None = None):
        if min_k < 6:
            raise ValueError("tiered turbo needs prefix-aligned chunks "
                             "(min_k >= 6)")
        num_k = max_k - min_k + 1
        super().__init__(torch.device(device), num_k, num_species)
        self.min_k, self.max_k = min_k, max_k
        self.highest_k = highest_k
        self.S = num_species
        self.num_k = num_k
        self.key64 = (limbs[:, 0].astype(np.int64) << LIMB_BITS) \
            | limbs[:, 1].astype(np.int64)
        self.tax_rows = np.ascontiguousarray(tax_rows, np.int32)
        self.reads_per_batch = int(os.environ.get("KASA_TIERED_READS",
                                                  1 << 15))
        self.weights = torch.tensor(
            [float(weight(max_k - ki)) for ki in range(num_k)],
            dtype=torch.float32, device=self.device)
        masks, self.full = level_masks(highest_k, min_k, max_k)
        self.masks = torch.tensor(masks, dtype=torch.int32,
                                  device=self.device)

        self.chunks = chunk_plan(limbs, chunk_entries)
        self.chunk_pad = max(b - a for a, b in self.chunks)
        self.chunk_limb0 = torch.tensor(
            [int(limbs[a, 0]) for a, _ in self.chunks], dtype=torch.int32,
            device=self.device)
        self.num_steps = _steps(self.chunk_pad)

        self.cache_dir = cache_dir or (index_path + "_oocache_turbo_torch")
        self._build_cache(index_path, limbs)
        self.msteps = _steps(self.mlevel_max)
        # chunks stay on the device until 0.6 of the budget is spent
        # (kasa_tpu probes with -m = 4 GiB: the card's own free memory on
        # CUDA, 0.8 * 4 GiB on the CPU, KASA_DEVICE_BUDGET first); the
        # rest upload for every batch
        class _B:
            memory_avail = 4 << 30
        self._per_chunk_dev = (self.chunk_pad * 16 + self.mpad * 8
                               + self.drpad * 16)
        if self.device.type == "cuda":
            # K8's prefix table, kept with the chunk
            self._per_chunk_dev += 4 * ((1 << PREFIX_BITS) + 3)
        self._dev_budget = 0.6 * device_table_budget(_B, self.device)
        self._dev_cache_n = min(
            int(self._dev_budget // max(self._per_chunk_dev, 1)),
            len(self.chunks))
        self._dev_cache_ok = self._dev_cache_n >= len(self.chunks)
        self._dev_chunks: dict = {}
        # host-RAM copies of the streamed chunks when they fit half the
        # free RAM (else every batch reloads them from the npz cache)
        self._ram_chunks: dict = {}
        try:
            avail = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
        except (ValueError, OSError):
            avail = 0
        per_chunk = bytes_per_entry_tiered(num_k) * self.chunk_pad
        self._ram_cache_ok = per_chunk * len(self.chunks) < avail * 0.5
        # telemetry: bytes uploaded for chunks not kept on the device,
        # and batches
        self.streamed_bytes = 0
        self.batches = 0

    # ---------------------------------------------------------- cache
    def _stamp(self, index_path):
        st = os.stat(index_path)
        crc = zlib.crc32(self.tax_rows.tobytes())
        return (f"turbo_torch{_TIER_CACHE_VERSION},{st.st_size},"
                f"{st.st_mtime_ns},{self.min_k},{self.max_k},{self.S},"
                f"{self.chunk_pad},{len(self.chunks)},{TMAX},{crc}")

    def _chunk_file(self, ci):
        return os.path.join(self.cache_dir, f"turbo_{ci:05d}.npz")

    def _build_cache(self, index_path, limbs):
        """Chunk tables on disk, one npz per chunk, ragged mstart/mrow
        and d_tax4 padded to the maxima over all chunks; a stamp of the
        index, the k range, the chunk plan and the tax-row map marks them
        fresh."""
        os.makedirs(self.cache_dir, exist_ok=True)
        stamp_f = os.path.join(self.cache_dir, "turbo_stamp.txt")
        pads_f = os.path.join(self.cache_dir, "turbo_pads.json")
        stamp = self._stamp(index_path)
        try:
            with open(stamp_f) as fh:
                fresh = fh.read() == stamp
            if fresh:
                with open(pads_f) as fh:
                    p = json.load(fh)
                self.mpad, self.drpad = p["mpad"], p["drpad"]
                self.mlevel_max = p["mlevel_max"]
                return
        except (OSError, ValueError, KeyError):
            pass
        raw = []
        for a, b in self.chunks:
            with timers.stage("tiered/build_chunk"):
                raw.append(build_chunk_tables(
                    np.ascontiguousarray(limbs[a:b]), self.tax_rows[a:b],
                    self.highest_k, self.min_k, self.max_k, self.chunk_pad))
        self.mpad = max(max(len(t["mstart"]) for t in raw), 1)
        self.drpad = max(max(t["d_tax4"].shape[0] for t in raw), 1)
        self.mlevel_max = max(
            max(int(np.max(np.diff(t["moff"]))) for t in raw), 1)
        for ci, t in enumerate(raw):
            ms = np.full((self.mpad,), I32_MAX, np.int32)
            mr = np.zeros((self.mpad,), np.int32)
            ms[:len(t["mstart"])] = t["mstart"]
            mr[:len(t["mrow"])] = t["mrow"]
            dt = np.full((self.drpad, 4), -1, np.int32)
            dt[:t["d_tax4"].shape[0]] = t["d_tax4"]
            np.savez(self._chunk_file(ci), rowdat=t["rowdat"],
                     mstart=ms, mrow=mr, moff=t["moff"], d_tax4=dt,
                     n=t["n"])
        with open(pads_f, "w") as fh:
            json.dump({"mpad": self.mpad, "drpad": self.drpad,
                       "mlevel_max": self.mlevel_max}, fh)
        with open(stamp_f, "w") as fh:
            fh.write(stamp)

    def _tables(self, ci):
        """Chunk ci's tables on the device, on the card followed by K8's
        prefix table (kernels.tiered_prefix, built once per upload): from
        the device cache, else uploaded from the host-RAM copy or the npz
        file."""
        tabs = self._dev_chunks.get(ci)
        if tabs is not None:
            return tabs
        dev_keep = len(self._dev_chunks) < self._dev_cache_n
        zc = self._ram_chunks.get(ci)
        if zc is None:
            with np.load(self._chunk_file(ci)) as z:
                zc = {f: z[f] for f in TIERED_FIELDS}
            if self._ram_cache_ok and not dev_keep:
                self._ram_chunks[ci] = zc
        tabs = tuple(torch.from_numpy(zc[f]).to(self.device)
                     for f in TIERED_FIELDS)
        if self.device.type == "cuda":
            from .. import kernels
            tabs += (kernels.tiered_prefix(tabs[0]),)
        if dev_keep:
            self._dev_chunks[ci] = tabs
        else:
            self.streamed_bytes += sum(zc[f].nbytes for f in TIERED_FIELDS)
        return tabs

    # ------------------------------------------------------- strategy
    def dispatch(self, mat: np.ndarray, lut, acc_ca, acc_cu, rows_pad: int,
                 w: int, cap: int, file_of_read=None, protein=False,
                 one_frame=False, lines_per_read=1, unique=False):
        """One batch through K1 (K5), K7, K8 per chunk and K3's additive
        arm.  -> (handle of the packed readback, ht, hk)."""
        from ..core.encode import encode_windows
        from .turbo import dedup_windows
        if file_of_read is not None:
            raise NotImplementedError(
                "per-file counts on a tiered index: kasa_tpu has no "
                "dispatch_files on its TieredTurboDispatch")
        kpr = w * lines_per_read
        dev = self.device
        timers.next_batch()
        with timers.stage("tiered/prepare"):
            q = encode_windows(torch.from_numpy(mat).to(dev), lut, w,
                               protein, one_frame, self.highest_k)
            if unique:
                q = dedup_windows(q, rows_pad, kpr)
            qr, vbr, posr, cuts = tiered_route(q, self.chunk_limb0,
                                               self.min_k, self.max_k)
            M = q.shape[0]
            cuts_h = cuts.cpu().tolist()
        num_k, S = self.num_k, self.S
        skey = torch.full((M + 1, num_k), SENT, dtype=torch.int32, device=dev)
        sflat = torch.zeros(rows_pad * S + 1, dtype=torch.float32, device=dev)
        cflat = torch.zeros(num_k * S + 1, dtype=torch.float32, device=dev)
        big = torch.zeros(rows_pad + 1, dtype=torch.int32, device=dev)
        ends = cuts_h[1:] + [M]
        for ci in range(len(self.chunks)):
            lo, hi = cuts_h[ci], ends[ci]
            if hi <= lo:
                continue
            with timers.stage("tiered/load_chunk"):
                tabs = self._tables(ci)
            with timers.stage("tiered/passes"):
                tiered_pass(tabs, self.weights, qr, vbr, posr, lo, hi, skey,
                            sflat, cflat, big, self.num_steps, self.msteps,
                            self.masks, self.full, S, kpr)
                # a streamed chunk's pass ends before the next upload, so
                # the two timers split the batch's device time
                if not self._dev_cache_ok and dev.type == "cuda":
                    torch.cuda.synchronize(dev)
        packed, ht, hk = tiered_finish(skey, sflat, cflat, big, self.weights,
                                       acc_ca, acc_cu, rows_pad, kpr, cap)
        self.batches += 1
        return self._to_host([packed]), ht, hk

    def host_fixup(self, q_limbs):
        """The additive contract's host share of one flagged read, in
        one pass over its windows: the full list, and the counts of the
        T > TMAX groups the device skipped.
        -> (scores dict, ca add (numK, S) f64, cu add (numK, S) int64)."""
        with timers.span("recompute"):
            timers.count("recompute.reads")
            vb = window_vbits_np(q_limbs, self.min_k, self.max_k)
            return host_ranges_classify(
                self.key64, self.tax_rows, q_limbs, vb, self.min_k,
                self.max_k, self.highest_k, self.S, t_min=TMAX)


# ---------------------------------------------------------------------------
# decode (kasa_tpu tiered.py:778)

def SingleTurboDispatch_decode(packed, rows_pad, rb, cap, want_lists,
                               ht_d, hk_d, lists=None):
    """packed (2R + 2*cap + 4,) int32 -> (hc, ofc, ofl, nflag, ht, hk)
    for the batch's first rb reads.  When the batch's hits overflow the
    CSR (total > cap) the answer takes the dense (R, WOUT) lists: views
    of `lists`, host arrays that dispatch read back, or else (late) a
    copy of the device lists ht_d / hk_d.  Recorded as the span "decode"
    with the counters hits, reads.flagged, csr.overflow, readback.bytes
    (what the answer read back, either way), readback.late and
    readback.unused (lists read back that the answer did not take)."""
    with timers.span("decode"):
        hc_full = packed[:rows_pad]
        fl = packed[rows_pad:2 * rows_pad]
        ofc = (fl[:rb] & 1).astype(bool)
        ofl = (fl[:rb] >> 1).astype(bool)
        nflag = int(packed[-1])
        total = int(packed[-2])
        ht = hk = None
        lists_read = want_lists and total > cap
        if timers.ON:
            timers.count("hits", total)
            timers.count("reads.flagged", int(ofl.sum()))
            timers.count("csr.overflow", int(total > cap))
            timers.count("readback.bytes", packed.nbytes + (
                8 * rb * ht_d.shape[1] if lists_read else 0))
            if not lists_read and lists is not None:
                timers.count("readback.unused")
        if want_lists and not lists_read:
            with timers.span("decode.csr"):
                hc = hc_full[:rb]
                maxc = max(int(hc.max()) if rb else 0, 1)
                csr = packed[2 * rows_pad:2 * rows_pad + 2 * cap] \
                    .reshape(cap, 2)
                ht = np.zeros((rb, maxc), np.int32)
                hk = np.zeros((rb, maxc), np.float32)
                rr = np.repeat(np.arange(rb), hc)
                cum = np.cumsum(hc) - hc
                cc = np.arange(len(rr)) - np.repeat(cum, hc)
                ht[rr, cc] = csr[:len(rr), 0]
                hk[rr, cc] = csr[:len(rr), 1].view(np.float32)
        elif lists_read and lists is not None:
            with timers.span("decode.lists"):
                ht, hk = lists[0][:rb], lists[1][:rb]
        elif lists_read:
            with timers.span("decode.lists"):
                if timers.ON:
                    timers.count("readback.late")
                # each list read back, then copied, in turn: the consumer
                # holds the interpreter lock through a copy and frees it
                # through a read, so the producer's launches interleave
                late = []
                for t in (ht_d, hk_d):
                    with timers.span("decode.lists.d2h"):
                        h = t[:rb].cpu()
                    with timers.span("decode.lists.copy"):
                        late.append(h.numpy().copy())
                    del h
                ht, hk = late
        return hc_full[:rb].copy(), ofc, ofl, nflag, ht, hk
