"""Out-of-core identify for the per-batch engine (port of
kasa_tpu/match/oocore.py): a 64-bit index whose classic tables exceed
the memory budget (-m) streams limb0-run-aligned index chunks through
the device, each chunk classified by K9 (csrc/classic_classify.cu,
match/device.py classify_batch) in the scatter layout, and the scores
and counts summed.

Chunk boundaries fall on limb0-run boundaries, so every k >= 6 prefix
group lives inside one chunk (k >= 6 masks cover all of limb 0; groups
nest inside limb0 runs): each (query, level) group is scored by exactly
one chunk and the integer counts add up exactly.

Each chunk's StackedTables (match/device.py) are built once per index,
k range and chunk plan on the host and kept in an npz cache of the
port's own format, in ``<index>_oocache_torch/`` (or the caller's
directory); kasa_tpu's ``<index>_oocache/`` is a different format and
neither package reads the other's.  The kernel takes each chunk's sizes
at run time, so chunks keep their own shapes: no padding rows.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..core import kmer
from ..index import artifacts
from ..utils import timers
from .device import _TENSORS, StackedTables

CACHE_FORMAT = "kasa_tpu_torch oocore 1"


def bytes_per_entry(num_limbs: int, num_k: int) -> int:
    """Resident bytes per index entry kasa_tpu charges the device tables
    (oocore.py:49): the turbo layout's keys, row data, per-level groups
    and padded taxa."""
    return 4 * num_limbs + num_k * 8 + 48


def plan_chunks(path: str, chunk_entries: int) -> list[tuple[int, int]]:
    """Cut [0, N) into limb0-run-aligned chunks of <= chunk_entries (a
    run larger than the budget is a chunk of its own), greedily from the
    start: kasa_tpu's plan (oocore.py:55), one search of the run
    boundaries per chunk instead of a Python loop over the runs.  The
    run lengths come from the trie file: its prefix is limb 0's letters
    (Trie.hpp:366-394)."""
    _prefixes, counts = artifacts.read_trie(path)
    bounds = np.concatenate([[0], np.cumsum(np.asarray(counts, np.int64))])
    n = int(bounds[-1])
    cuts = [0]
    while cuts[-1] < n:
        j = int(np.searchsorted(bounds, cuts[-1] + chunk_entries, "right"))
        if bounds[j - 1] <= cuts[-1]:
            j = int(np.searchsorted(bounds, cuts[-1], "right")) + 1
        cuts.append(int(bounds[j - 1]))
    if n == 0:
        cuts.append(0)
    return [(cuts[i], cuts[i + 1]) for i in range(len(cuts) - 1)]


class TieredIndex:
    """Chunked classic tables of an on-disk 64-bit index, classified
    chunk by chunk on `device`."""

    def __init__(self, path: str, tax_to_row: dict, min_k: int, max_k: int,
                 num_species: int, chunk_entries: int, device,
                 cache_dir: str | None = None):
        n, itype = artifacts.read_info(path)
        if itype != artifacts.INDEX_TYPE_64:
            raise ValueError("tiered identify supports 64-bit indices")
        if min_k < 6:
            raise ValueError("tiered identify needs k >= 6 (prefix-aligned "
                             "chunks)")
        self.path = path
        self.n = n
        self.min_k, self.max_k = min_k, max_k
        self.num_k = max_k - min_k + 1
        self.num_species = num_species
        self.tax_to_row = tax_to_row
        self.device = torch.device(device)
        self.chunks = plan_chunks(path, chunk_entries)
        self.cache_dir = cache_dir or (path + "_oocache_torch")
        self.uploaded_bytes = 0     # chunk bytes moved to the device
        self.batches = 0            # batches classified
        self._build_cache()

    def _chunk_file(self, ci: int) -> str:
        return os.path.join(self.cache_dir, f"chunk_{ci:05d}.npz")

    def _stamp(self) -> str:
        st = os.stat(self.path)
        return (f"{CACHE_FORMAT},{st.st_size},{st.st_mtime_ns},{self.min_k},"
                f"{self.max_k},{self.num_species},{self.chunks}")

    def _build_cache(self):
        from .join import DeviceIndex
        os.makedirs(self.cache_dir, exist_ok=True)
        stamp_f = os.path.join(self.cache_dir, "stamp.txt")
        stamp = self._stamp()
        try:
            with open(stamp_f) as fh:
                if fh.read() == stamp:
                    return
        except OSError:
            pass
        rec = np.memmap(self.path, dtype=artifacts.REC_64, mode="r",
                        shape=(self.n,))
        for ci, (a, b) in enumerate(self.chunks):
            with timers.stage("oocore/build_chunk"):
                limbs = kmer.u64_to_limbs(np.ascontiguousarray(
                    rec[a:b]["kmer"]))
                taxids = np.ascontiguousarray(rec[a:b]["taxid"])
                t = StackedTables.build(DeviceIndex(
                    limbs, taxids, self.tax_to_row, 12, self.min_k,
                    self.max_k, self.num_species, "cpu"))
                np.savez(self._chunk_file(ci),
                         **{f: getattr(t, f).numpy() for f in _TENSORS})
        del rec
        with open(stamp_f, "w") as fh:
            fh.write(stamp)

    def device_tables(self):
        """Yield each chunk's StackedTables on the device, loaded from
        the cache."""
        for ci in range(len(self.chunks)):
            with timers.stage("oocore/load_chunk"):
                z = np.load(self._chunk_file(ci))
                arrs = [torch.from_numpy(z[f]).to(self.device)
                        for f in _TENSORS]
                self.uploaded_bytes += sum(a.numel() * a.element_size()
                                           for a in arrs)
                yield StackedTables(*arrs, self.min_k, self.max_k, 12,
                                    self.num_species)

    def classify(self, q_limbs: np.ndarray, read_ids: np.ndarray,
                 num_reads: int, unique: bool = False):
        """Every chunk's K9 over the batch, scores and counts summed
        (kasa_tpu oocore.py:203); the interface of engine.TpuEngine."""
        from .device import classify_batch
        from .engine import CAP, TpuMatchResult, dedup_unique
        res = TpuMatchResult(self.num_k, self.num_species, num_reads)
        if len(read_ids) == 0 or self.n == 0:
            return res
        if unique:
            q_limbs, read_ids = dedup_unique(q_limbs, read_ids)
        self.batches += 1
        d = self.device
        q = torch.from_numpy(np.ascontiguousarray(q_limbs, np.int32)).to(d)
        r = torch.from_numpy(np.ascontiguousarray(read_ids, np.int32)).to(d)
        v = torch.ones(len(read_ids), dtype=torch.bool, device=d)
        scores = torch.zeros((num_reads, self.num_species),
                             dtype=torch.float32, device=d)
        counts_all = torch.zeros((self.num_k, self.num_species),
                                 dtype=torch.float64, device=d)
        counts_unique = torch.zeros((self.num_k, self.num_species),
                                    dtype=torch.int64, device=d)
        tail = 0
        for t in self.device_tables():
            s, ca, cu, tp = classify_batch(t, q, r, v, num_reads, CAP)
            scores += s
            counts_all += ca.double()
            counts_unique += cu.long()
            tail = tail + tp
        res.scores = scores.cpu().numpy()
        res.counts_all = counts_all.cpu().numpy()
        res.counts_unique = counts_unique.cpu().numpy().astype(np.uint64)
        res.tail_pairs = int(tail)
        return res
