"""The classic engine on the (dp, ip) mesh (port of
kasa_tpu/parallel/mesh.py): prefix-aligned index shards over "ip", the
query batch split by reads over "dp".

Each rank holds one index shard's classic tables (match/device.py
StackedTables) and runs K9 (classify_batch) on its dp block of queries
against them; a sum over "ip" merges the partial scores, counts and
tail-pair counts, and a gather over "dp" lays the blocks out as
kasa_tpu's (dp, ...) results.  Shards are aligned to 6-letter-prefix
runs, so a k >= 6 prefix group never spans two shards and each shard's
group tables are exact.  kasa_tpu stacks its shards on one array and
pads each by replicating its last entry; a rank here holds only its own
shard, so there is no padding.  As in kasa_tpu, only tests and tools
call these (the CLI's mesh is parallel/turbo_mesh.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .dist import gather_over, sum_over

# an all-'^' entry: the shard of an empty prefix range holds it alone,
# and no valid query window matches it at any k (letter 30 at every
# position invalidates the window)
POISON_LIMB = sum(30 << (5 * j) for j in range(6))


def prefix_aligned_boundaries(limb0: np.ndarray,
                              num_shards: int) -> np.ndarray:
    """Split points (num_shards+1,) aligned to 6-letter-prefix runs.

    Equal-size targets are snapped to the nearest prefix-run boundary
    (the trie data IS the histogram, SURVEY 'skewed prefix
    distribution').  The first 6 letters live in limb0.
    """
    n = len(limb0)
    run_starts = np.r_[0, np.nonzero(limb0[1:] != limb0[:-1])[0] + 1]
    bounds = [0]
    for s in range(1, num_shards):
        target = s * n // num_shards
        j = np.searchsorted(run_starts, target)
        cand = []
        if j < len(run_starts):
            cand.append(run_starts[j])
        if j > 0:
            cand.append(run_starts[j - 1])
        best = min(cand, key=lambda x: abs(int(x) - target))
        bounds.append(max(int(best), bounds[-1]))
    bounds.append(n)
    return np.asarray(bounds, dtype=np.int64)


def shard_slice(limbs: np.ndarray, tax: np.ndarray, bounds: np.ndarray,
                s: int):
    """Shard s's entries; an empty shard gets the one POISON_LIMB entry
    (taxon row or id 0)."""
    lo, hi = int(bounds[s]), int(bounds[s + 1])
    if hi == lo:
        return (np.full((1, limbs.shape[1]), POISON_LIMB, np.int32),
                np.zeros(1, tax.dtype))
    return (np.ascontiguousarray(limbs[lo:hi]),
            np.ascontiguousarray(tax[lo:hi]))


@dataclass
class ShardedIndex:
    """One rank's index shard: K9's tables of entries
    [bounds[shard], bounds[shard + 1]) on its device, and every shard's
    first limb-0 value for the host router."""
    tables: object              # match.device.StackedTables of the shard
    shard: int
    num_shards: int
    bounds: np.ndarray          # (ip + 1,) prefix-aligned entry bounds
    shard_lo: np.ndarray        # (ip,) first limb0 of each shard

    @classmethod
    def build(cls, limbs: np.ndarray, taxids: np.ndarray, tax_to_row: dict,
              highest_k: int, min_k: int, max_k: int, num_species: int,
              num_shards: int, shard: int = 0,
              device=None) -> "ShardedIndex":
        """Shard `shard` of num_shards on `device` (None = cuda)."""
        from .. import resolve_device
        from ..match.device import StackedTables
        from ..match.join import DeviceIndex, map_tax_rows
        device = resolve_device(device)
        n = len(taxids)
        bounds = prefix_aligned_boundaries(limbs[:, 0], num_shards)
        tax_rows = map_tax_rows(taxids, tax_to_row)
        sl, st = shard_slice(limbs, tax_rows, bounds, shard)
        dev = DeviceIndex(sl, np.zeros(len(st), np.uint32), tax_to_row,
                          highest_k, min_k, max_k, num_species, device, st)
        shard_lo = np.array(
            [int(limbs[min(int(bounds[s]), n - 1), 0])
             for s in range(num_shards)], np.int32)
        shard_lo[0] = np.iinfo(np.int32).min   # shard 0 owns all below
        return cls(StackedTables.build(dev), shard, num_shards, bounds,
                   shard_lo)


def _classify_over_ip(si: ShardedIndex, mesh, q, rid, valid,
                      num_reads: int, cap: int):
    """K9 on this rank's queries against its shard, the partials summed
    over "ip", the dp blocks gathered: kasa_tpu's (scores (dp, R, S),
    counts_all (dp, numK, S), counts_unique (dp, numK, S), tail pairs
    (dp,))."""
    from ..match.device import classify_batch
    scores, call, cuniq, tail = classify_batch(si.tables, q, rid, valid,
                                               num_reads, cap)
    tail = torch.as_tensor(tail, dtype=torch.int32,
                           device=scores.device).reshape(1)
    out = []
    for t in (scores, call, cuniq, tail):
        out.append(gather_over(mesh.dp_group, sum_over(mesh.ip_group, t)))
    out[3] = out[3].reshape(-1)
    return tuple(out)


def _on(x, device, dtype):
    return torch.as_tensor(np.asarray(x), dtype=dtype).to(device)


def make_sharded_classifier(si: ShardedIndex, mesh, num_reads_per_dp: int,
                            m_per_dp: int, cap: int = 16):
    """-> (run, tables): run(q (dp, m_per_dp, L), rid (dp, m_per_dp),
    valid (dp, m_per_dp)), the same arrays on every rank; each rank
    classifies block [dp_index] against its shard (kasa_tpu mesh.py:148,
    its local_step at 176)."""
    assert si.num_shards == mesh.ip
    dev = si.tables.device

    def run(q, rid, valid):
        d = mesh.dp_index
        return _classify_over_ip(
            si, mesh, _on(np.asarray(q)[d], dev, torch.int32),
            _on(np.asarray(rid)[d], dev, torch.int32),
            _on(np.asarray(valid)[d], dev, torch.bool), num_reads_per_dp,
            cap)

    return run, si.tables


def route_queries(si: ShardedIndex, q: np.ndarray, rid: np.ndarray,
                  valid: np.ndarray, dp: int, m_cap: int):
    """Host-side prefix routing (the all_to_all alternative): each
    query goes ONLY to the shard owning its limb0 range, packed as
    (dp, ip, m_cap) blocks.

    Shards are prefix-run aligned, so ownership is a single
    searchsorted on the shards' first limb0 values.

    Returns (q_blocks, rid_blocks, valid_blocks, overflowed) --
    `overflowed` counts queries dropped because a (dp, ip) block
    exceeded m_cap; callers grow m_cap (bucketed) until it is zero."""
    ip = len(si.shard_lo)
    m = len(rid)
    per_dp = -(-m // dp)
    L = q.shape[1]
    qb = np.zeros((dp, ip, m_cap, L), np.int32)
    rb = np.zeros((dp, ip, m_cap), np.int32)
    vb = np.zeros((dp, ip, m_cap), bool)
    overflow = 0
    owner_all = np.searchsorted(si.shard_lo, q[:, 0], "right") - 1
    for d in range(dp):
        lo, hi = d * per_dp, min((d + 1) * per_dp, m)
        # vectorized pack: stable-sort by owner, then entry j of owner
        # s lands in block cell (s, j); invalid queries sort to a
        # sentinel owner and are dropped
        owner = np.where(valid[lo:hi], owner_all[lo:hi], ip)
        order = np.argsort(owner, kind="stable")
        os_ = owner[order]
        starts = np.searchsorted(os_, np.arange(ip + 1))
        within = np.arange(len(os_)) - starts[np.minimum(os_, ip)]
        keep = (os_ < ip) & (within < m_cap)
        overflow += int(np.sum((os_ < ip) & (within >= m_cap)))
        src = lo + order[keep]
        qb[d, os_[keep], within[keep]] = q[src]
        rb[d, os_[keep], within[keep]] = rid[src]
        vb[d, os_[keep], within[keep]] = True
    return qb, rb, vb, overflow


def make_routed_classifier(si: ShardedIndex, mesh, num_reads_per_dp: int,
                           m_cap: int, cap: int = 16):
    """Like make_sharded_classifier, but run takes the host-routed
    (dp, ip, m_cap) blocks of route_queries: each rank classifies block
    [dp_index, ip_index], only the queries its shard owns (kasa_tpu
    mesh.py:260, its local_step at 287); the sum over "ip" still merges
    each read's partials, since one read's windows route to many
    shards."""
    assert si.num_shards == mesh.ip
    dev = si.tables.device

    def run(q, rid, valid):
        d, i = mesh.dp_index, mesh.ip_index
        v = np.asarray(valid)[d, i]
        r = np.asarray(rid)[d, i]
        # the block's pad cells after its windows take the last window's
        # read id, so that the ids ascend and K9 takes its local arm
        r = np.where(v, r, np.maximum.accumulate(r))
        return _classify_over_ip(
            si, mesh, _on(np.asarray(q)[d, i], dev, torch.int32),
            _on(r, dev, torch.int32), _on(v, dev, torch.bool),
            num_reads_per_dp, cap)

    return run, si.tables
