"""The classic device engine (port of kasa_tpu/match/device.py): the
stacked per-k group tables and classify_batch, kernel K9
(csrc/classic_classify.cu), with its plain PyTorch version.

For every query window and every k level in [min_k, max_k] (row ki <->
k = max_k - ki) the engine finds the query's k-prefix group in the
sorted index: T = the group's distinct taxa, and each of them gets
w(k)/T in the read's score row and 1/T in counts_all[ki]; a group of
one taxon also adds 1 to counts_unique[ki].  A query is valid at k
while none of its letters at positions min_k-1 .. k-1 is '^' (letter
30).  Every taxon of every group is added: no cap truncates the
expansion (kasa_tpu's base tile plus tail loop, device.py:434-460);
`cap` only sets tail_pairs = sum of max(T - cap, 0) over the matched
(query, level) pairs, the work kasa_tpu's tail loop does.

The plain version and the kernel find the groups the same way: one
lower bound of the full key per query decides every level, because
k-prefix groups nest inside the sorted order (the level-k group [a, b)
of q pins lower_bound(q) into [a, b], so a non-empty group shows q's
k-prefix at pos or pos - 1, an empty one at neither).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core import kmer
from ..ops.search import lower_bound_plain
from .join import DeviceIndex, weight

# the dense prefix table resolves the first four letters of limb 0
# (kasa_tpu device.py:46: 20 bits, a 4 MB table)
PREFIX_BITS = 20
_PREFIX_SHIFT = 30 - PREFIX_BITS


@dataclass
class StackedTables:
    """Per-k group tables padded and stacked (kasa_tpu device.py:53),
    tensors on one device: the arrays K9 reads, each equal to kasa_tpu's.
    kasa_tpu's run_start, idx_tax and step counts serve its other
    lowerings and are not built."""
    idx_limbs: torch.Tensor    # (N, L) int32 sorted index
    grp_id: torch.Tensor       # (numK, N) int32
    grp_start: torch.Tensor    # (numK, Gmax) int32 offsets into d_tax rows
    d_tax: torch.Tensor        # (numK, Tmax) int32
    masks: torch.Tensor        # (numK, L) int32 prefix masks
    weights: torch.Tensor      # (numK,) float32 w(k)
    run_end: torch.Tensor      # (N,) int32 end (exclusive) of the
                               # entry's limb-0 run
    prefix_tbl: torch.Tensor   # (2^PREFIX_BITS + 1,) int32 bucket offsets
    min_k: int
    max_k: int
    highest_k: int
    num_species: int

    @property
    def n(self) -> int:
        return self.idx_limbs.shape[0]

    @property
    def num_k(self) -> int:
        return self.max_k - self.min_k + 1

    @property
    def device(self) -> torch.device:
        return self.idx_limbs.device

    @classmethod
    def build(cls, dev: DeviceIndex) -> "StackedTables":
        ks = list(range(dev.max_k, dev.min_k - 1, -1))
        n = dev.n
        num_k = len(ks)
        g_max = max(int(dev.tables[k].grp_start.shape[0]) for k in ks)
        t_max = max(int(dev.tables[k].d_tax.shape[0]) for k in ks)
        L = dev.num_limbs
        grp_id = np.zeros((num_k, n), np.int32)
        grp_start = np.zeros((num_k, g_max), np.int32)
        d_tax = np.zeros((num_k, t_max), np.int32)
        masks = np.zeros((num_k, L), np.int32)
        w = np.zeros((num_k,), np.float32)
        for i, k in enumerate(ks):
            t = dev.tables[k]
            grp_id[i, :] = t.grp_id
            gs = t.grp_start
            grp_start[i, :len(gs)] = gs
            grp_start[i, len(gs):] = gs[-1] if len(gs) else 0
            d_tax[i, :len(t.d_tax)] = t.d_tax
            masks[i, :] = t.mask
            w[i] = weight(k)
        limb0 = dev.idx_limbs_np[:, 0] if n else np.zeros(0, np.int32)
        if n:
            new = np.r_[True, limb0[1:] != limb0[:-1]]
            starts = np.nonzero(new)[0]
            ends = np.r_[starts[1:], n].astype(np.int32)
            run_end = ends[np.cumsum(new) - 1]
        else:
            run_end = np.zeros(0, np.int32)
        prefix_tbl = np.searchsorted(
            limb0.astype(np.int64),
            np.arange((1 << PREFIX_BITS) + 1, dtype=np.int64)
            << _PREFIX_SHIFT).astype(np.int32)
        d = dev.idx_limbs.device

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(d)
        return cls(dev.idx_limbs, up(grp_id), up(grp_start), up(d_tax),
                   up(masks), up(w), up(run_end), up(prefix_tbl), dev.min_k,
                   dev.max_k, dev.highest_k, dev.num_species)


# the last StackedTables built, by index file, k range, taxon rows and
# device: identify runs on one index reuse them (one index at a time)
_ST_RAM_CACHE: dict = {}


def load_or_build_classic(index_path: str | None, limbs, taxids, tax_to_row,
                          highest_k: int, min_k: int, max_k: int,
                          num_species: int, device,
                          tax_rows=None) -> StackedTables:
    """The classic tables on `device`, built on the host (timers
    classic/tables-build, classic/tables-upload) or taken from the RAM
    cache when the same index file, k range and taxon rows were built on
    the same device before."""
    import os
    from ..utils import timers
    from .turbo import _tax_rows_crc
    if tax_rows is None:
        from .join import map_tax_rows
        tax_rows = map_tax_rows(taxids, tax_to_row)
    key = None
    if index_path is not None:
        try:
            key = (os.path.abspath(index_path), os.path.getmtime(index_path),
                   min_k, max_k, num_species, _tax_rows_crc(tax_rows),
                   str(torch.device(device)))
        except OSError:
            key = None
    if key is not None and key in _ST_RAM_CACHE:
        return _ST_RAM_CACHE[key]
    with timers.stage("classic/tables-build"):
        dev = DeviceIndex(limbs, taxids, tax_to_row, highest_k, min_k,
                          max_k, num_species, "cpu", tax_rows)
        host = StackedTables.build(dev)
        del dev
    with timers.stage("classic/tables-upload"):
        d = torch.device(device)
        t = host if d.type == "cpu" else StackedTables(
            *(getattr(host, f).to(d) for f in _TENSORS),
            *(getattr(host, f) for f in _SCALARS))
    if key is not None:
        _ST_RAM_CACHE.clear()
        _ST_RAM_CACHE[key] = t
    return t


_TENSORS = ("idx_limbs", "grp_id", "grp_start", "d_tax", "masks", "weights",
            "run_end", "prefix_tbl")
_SCALARS = ("min_k", "max_k", "highest_k", "num_species")


def _check(t: StackedTables, q, read_ids, q_valid, num_reads, kpr):
    M, L = q.shape
    if L != t.idx_limbs.shape[1]:
        raise ValueError(f"queries of {L} limbs against an index of "
                         f"{t.idx_limbs.shape[1]}")
    if q_valid.shape != (M,):
        raise ValueError("q_valid must be (M,)")
    if kpr > 0:
        if M % kpr or M // kpr > num_reads:
            raise ValueError(f"{M} queries are not {num_reads} reads of "
                             f"{kpr} windows")
    elif read_ids is None or read_ids.shape != (M,):
        raise ValueError("the scatter layout needs (M,) read_ids")


def _valid_levels(q: torch.Tensor, min_k: int, max_k: int) -> torch.Tensor:
    """(M,) the largest k still valid (no '^' at min_k-1 .. k-1); a value
    below min_k means no level is valid."""
    kv = torch.full((q.shape[0],), max_k, dtype=torch.int64,
                    device=q.device)
    for p in range(max_k - 1, min_k - 2, -1):
        i, j = divmod(p, kmer.LETTERS_PER_LIMB)
        letter = (q[:, i] >> (kmer.BITS_PER_LETTER
                              * (kmer.LETTERS_PER_LIMB - 1 - j))) & 31
        kv = torch.where(letter == 30, torch.full_like(kv, p), kv)
    return kv


def classify_batch_plain(t: StackedTables, q: torch.Tensor,
                         read_ids: torch.Tensor | None,
                         q_valid: torch.Tensor, num_reads: int,
                         cap: int = 16, kmers_per_read: int = 0):
    """Plain PyTorch version of K9 (kasa_tpu device.py:156 classify_batch).

    q (M, L) int32 windows; the read of row m is m // kmers_per_read
    (the uniform layout) or read_ids[m] (kmers_per_read 0); q_valid (M,)
    bool.  -> (scores (num_reads, S) f32, counts_all (numK, S) f32,
    counts_unique (numK, S) int32, tail_pairs int).  The float32 terms
    w(k)/T and 1/T are those of the kernel and of kasa_tpu; their sums
    are taken in float64 and rounded once, so this version sits closest
    to the exact sums (the kernel's and kasa_tpu's float32 sums each
    drift from them in their own order)."""
    _check(t, q, read_ids, q_valid, num_reads, kmers_per_read)
    dev = q.device
    M = q.shape[0]
    S, nk, n = t.num_species, t.num_k, t.n
    f64 = dict(dtype=torch.float64, device=dev)
    scores = torch.zeros((num_reads, S), **f64)
    counts_all = torch.zeros((nk, S), **f64)
    counts_unique = torch.zeros((nk, S), dtype=torch.int32, device=dev)
    if M == 0 or n == 0:
        return scores.float(), counts_all.float(), counts_unique, 0
    kv = _valid_levels(q, t.min_k, t.max_k)
    pos = lower_bound_plain(t.idx_limbs, q)
    at = t.idx_limbs[pos.clamp(max=n - 1)]
    prev = t.idx_limbs[(pos - 1).clamp(min=0)]
    rows = (torch.arange(M, device=dev) // kmers_per_read
            if kmers_per_read else read_ids.long())
    tail = 0
    for ki in range(nk):
        k = t.max_k - ki
        mask = t.masks[ki]
        qm = q & mask
        eq_at = (pos < n) & ((at & mask) == qm).all(dim=1)
        eq_prev = (pos > 0) & ((prev & mask) == qm).all(dim=1)
        m_idx = torch.nonzero((eq_at | eq_prev) & (kv >= k) & q_valid)[:, 0]
        if m_idx.numel() == 0:
            continue
        e = torch.where(eq_at[m_idx], pos[m_idx], pos[m_idx] - 1)
        g = t.grp_id[ki][e].long()
        ts = t.grp_start[ki][g].long()
        T = t.grp_start[ki][g + 1].long() - ts
        tail += int((T - cap).clamp(min=0).sum())
        Tf = T.to(torch.float32)
        w_over_t = (t.weights[ki] / Tf).double()
        inv_t = (1.0 / Tf).double()
        # every (query, taxon) pair of the matched groups
        pair_q = torch.repeat_interleave(torch.arange(T.numel(), device=dev),
                                         T)
        first = torch.cumsum(T, 0) - T
        j = torch.arange(pair_q.numel(), device=dev) - first[pair_q]
        tax = t.d_tax[ki][ts[pair_q] + j].long()
        scores.view(-1).index_add_(0, rows[m_idx][pair_q] * S + tax,
                                   w_over_t[pair_q])
        counts_all[ki].index_add_(0, tax, inv_t[pair_q])
        uniq = T == 1
        counts_unique[ki].index_add_(
            0, t.d_tax[ki][ts[uniq]].long(),
            torch.ones(int(uniq.sum()), dtype=torch.int32, device=dev))
    return scores.float(), counts_all.float(), counts_unique, tail


def classify_batch(t: StackedTables, q: torch.Tensor,
                   read_ids: torch.Tensor | None, q_valid: torch.Tensor,
                   num_reads: int, cap: int = 16, kmers_per_read: int = 0):
    """K9 wrapper: the CUDA kernel on a CUDA tensor, else the plain
    version.  tail_pairs comes back a 0-d int32 tensor from the kernel,
    an int from the plain version."""
    if q.device.type == "cpu":
        return classify_batch_plain(t, q, read_ids, q_valid, num_reads,
                                    cap, kmers_per_read)
    _check(t, q, read_ids, q_valid, num_reads, kmers_per_read)
    from .. import kernels
    return kernels.classic_classify(t, q, read_ids, q_valid, num_reads, cap,
                                    kmers_per_read)


def _bucket(n: int, minimum: int) -> int:
    size = minimum
    while size < n:
        size <<= 1
    return size


def run_classify(tables: StackedTables, q_limbs: np.ndarray,
                 read_ids: np.ndarray, num_reads: int, cap: int = 16):
    """Host wrapper (kasa_tpu device.py:468): pad the batch to a power of
    two of at least 1,024 rows and classify in the scatter layout."""
    m = len(read_ids)
    m_pad = _bucket(m, 1024)
    L = tables.idx_limbs.shape[1]
    q = np.zeros((m_pad, L), np.int32)
    q[:m] = q_limbs
    # the pad rows take the last read id, so that the ids ascend (K9's
    # local arm)
    r = np.full((m_pad,), read_ids[-1] if m else 0, np.int32)
    r[:m] = read_ids
    v = np.zeros((m_pad,), bool)
    v[:m] = True
    d = tables.device
    return classify_batch(tables, torch.from_numpy(q).to(d),
                          torch.from_numpy(r).to(d),
                          torch.from_numpy(v).to(d), num_reads, cap)
