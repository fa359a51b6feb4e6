"""The per-batch classic engine (port of kasa_tpu/match/engine.py): the
resident StackedTables and one classify_batch (K9) per batch of encoded
query windows, behind the per-batch interface of match/pipeline.py:

  ingest -> encode (K1) -> [here] classify (K9) -> rank -> write

Counts are exact per batch (every taxon of every group is added);
scores differ from the exact engine only by float summation order.
"""

from __future__ import annotations

import numpy as np
import torch


# the cap kasa_tpu's TpuEngine and fused classic path pass to
# classify_batch (it sets only tail_pairs); above DENSE_MAX_S species a
# batch takes the scatter layout (kasa_tpu engine.py:84)
CAP = 8
DENSE_MAX_S = 512


class TpuMatchResult:
    def __init__(self, num_k: int, num_species: int, num_reads: int):
        self.scores = np.zeros((num_reads, num_species), dtype=np.float32)
        self.counts_all = np.zeros((num_k, num_species), dtype=np.float64)
        self.counts_unique = np.zeros((num_k, num_species), dtype=np.uint64)
        self.tail_pairs = 0


def dedup_unique(q_limbs: np.ndarray, read_ids: np.ndarray):
    """-e: drop duplicate (kmer, readID) pairs (Compare.hpp:3167)."""
    L = q_limbs.shape[1]
    order = np.lexsort((read_ids,) + tuple(
        q_limbs[:, i] for i in range(L - 1, -1, -1)))
    ql, rl = q_limbs[order], read_ids[order]
    keep = np.empty(len(rl), dtype=bool)
    keep[0] = True
    keep[1:] = np.any(ql[1:] != ql[:-1], axis=1) | (rl[1:] != rl[:-1])
    return ql[keep], rl[keep]


def layout(q_limbs: np.ndarray, read_ids: np.ndarray, num_reads: int,
           num_species: int):
    """A batch's windows as K9 takes them -> (q (M, L), read ids (M,) or
    None, q_valid (M,), kmers_per_read).  Up to DENSE_MAX_S species the
    uniform layout: each read's windows at its block start, blocks of the
    batch's most windows per read rounded up to 16 (kasa_tpu
    engine.py:103-118); above it the scatter layout, the windows as they
    come with explicit read ids."""
    m = len(read_ids)
    if num_species > DENSE_MAX_S:
        return (np.ascontiguousarray(q_limbs, np.int32),
                np.ascontiguousarray(read_ids, np.int32),
                np.ones((m,), bool), 0)
    counts = np.bincount(read_ids, minlength=num_reads)
    kpr = max((int(counts.max()) + 15) // 16 * 16, 16)
    order = np.argsort(read_ids, kind="stable")
    ql, rl = q_limbs[order], read_ids[order]
    offs = np.zeros(num_reads, dtype=np.int64)
    np.cumsum(counts[:-1], out=offs[1:])
    dst = rl.astype(np.int64) * kpr + (np.arange(m) - offs[rl])
    q = np.zeros((num_reads * kpr, q_limbs.shape[1]), np.int32)
    v = np.zeros((num_reads * kpr,), bool)
    q[dst] = ql
    v[dst] = True
    return q, None, v, kpr


class TpuEngine:
    """Resident classic tables on `device` and K9 per batch (kasa_tpu
    engine.py:55), in the layout `layout` gives the batch: the two
    layouts of kasa_tpu's dense and scatter lowerings, one kernel."""

    def __init__(self, limbs: np.ndarray, taxids: np.ndarray,
                 tax_to_row: dict, highest_k: int, min_k: int, max_k: int,
                 num_species: int, device, tax_rows: np.ndarray | None = None,
                 index_path: str | None = None):
        from .device import load_or_build_classic
        self.min_k, self.max_k = min_k, max_k
        self.highest_k = highest_k
        self.num_species = num_species
        self.device = torch.device(device)
        self.tables = load_or_build_classic(
            index_path, limbs, taxids, tax_to_row, highest_k, min_k, max_k,
            num_species, self.device, tax_rows)

    def classify(self, q_limbs: np.ndarray, read_ids: np.ndarray,
                 num_reads: int, unique: bool = False) -> TpuMatchResult:
        from .device import classify_batch
        t = self.tables
        res = TpuMatchResult(self.max_k - self.min_k + 1, self.num_species,
                             num_reads)
        if len(read_ids) == 0 or t.n == 0:
            return res
        if unique:
            q_limbs, read_ids = dedup_unique(q_limbs, read_ids)
        q, r, v, kpr = layout(q_limbs, read_ids, num_reads,
                              self.num_species)
        d = self.device
        scores, counts_all, counts_unique, tail = classify_batch(
            t, torch.from_numpy(q).to(d),
            None if r is None else torch.from_numpy(r).to(d),
            torch.from_numpy(v).to(d), num_reads, CAP, kpr)
        res.scores = scores.cpu().numpy()
        res.counts_all = counts_all.cpu().numpy().astype(np.float64)
        res.counts_unique = counts_unique.cpu().numpy().astype(np.uint64)
        res.tail_pairs = int(tail)
        return res
