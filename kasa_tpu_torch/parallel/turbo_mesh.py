"""The turbo classify on the (dp, ip) mesh (port of
kasa_tpu/parallel/turbo_mesh.py): the fused identify path sharded over
the ranks of a process group, one device per rank.

  dim "dp" (data parallel): every rank parses and assembles the same
      batch and classifies its dp block of the rows: throughput.
  dim "ip" (index parallel): the sorted index splits into contiguous
      shards aligned to 6-letter-prefix runs; since min_k >= 6 every
      k-prefix group lives whole inside one shard, so each shard's turbo
      tables are exact on their own: memory.

A rank builds only its own shard's tables (match/turbo.py's builder on
the shard's slice, with a sidecar of its own); kasa_tpu stacks the ip
shards on one array and pads them to a common length, which one shard
per rank does not need.  Per batch and rank (turbo_mesh_step):
  1. K1 windows its dp rows (and K5 dedups them under -e);
  2. K2, K3 pre and K4's cut run against the shard; the cut's
     count-overflow flags are ORed over "ip" before anything is counted
     (kasa_tpu's flag_reduce: a read flagged on any shard counts nothing
     on every shard, so the host's exact recompute adds it once), then
     K4's expansion (or K6), the hot-set products and K3 post;
  3. each rank's count matrices accumulate in place; reduce_acc sums
     them over the whole mesh once per flush (kasa_tpu sums over "ip"
     per batch: the integers are identical, the floats differ by
     addition order);
  4. the per-read hit lists are gathered over "ip" and merged per read
     by K14 (mesh_merge: sort by taxon, sum, keep the first wout, CSR
     pack), one packed row per dp block in kasa_tpu's mesh layout;
  5. the dp rows are gathered to every rank; rank 0 decodes them,
     recomputes flagged reads on the host against the whole index's
     host tables (kept on rank 0's host: kasa_tpu keeps the full tables
     on device 0) and writes every output.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from ..match.fast import TurboDispatchBase
from ..match.turbo import (CSR_CAP_FACTOR, EXP_BUDGET, LIMB_BITS,
                           MULTI_BUDGET, SENT, batch_budgets)
from ..utils import timers
from .dist import gather_over, or_over, sum_over
from .mesh import prefix_aligned_boundaries, shard_slice


@dataclass
class HostTables:
    """The whole index's fields of the exact host recompute
    (turbo.host_classify_read reads these and nothing else)."""
    host_limbs: np.ndarray
    host_grp_start: list
    host_d_tax: list
    host_grp_id: list
    host_masks: np.ndarray
    min_k: int
    max_k: int
    num_species: int
    _host_key64: np.ndarray | None = None

    def host_key64(self) -> np.ndarray:
        if self._host_key64 is None:
            self._host_key64 = \
                (self.host_limbs[:, 0].astype(np.int64) << LIMB_BITS) \
                | self.host_limbs[:, 1].astype(np.int64)
        return self._host_key64


def whole_host_tables(index_path: str | None, limbs: np.ndarray,
                      tax_rows: np.ndarray, highest_k: int, min_k: int,
                      max_k: int, num_species: int) -> HostTables:
    """The whole index's host fields: from the index's fresh turbo
    sidecar (memory-mapped) when there is one, else the per-k group
    tables built on the host."""
    from ..match.join import build_group_table
    from ..match.turbo import _tax_rows_crc, load_turbo_np
    num_k = max_k - min_k + 1
    got = None
    if index_path is not None:
        cache = f"{index_path}.turbo_{min_k}_{max_k}.npz"
        meta = os.path.join(cache + ".tabs", "meta.json")
        if os.path.exists(meta) and \
                os.path.getmtime(meta) >= os.path.getmtime(index_path):
            got = load_turbo_np(cache, limbs, _tax_rows_crc(tax_rows))
    if got is not None:
        a = got[0]
        return HostTables(limbs, a["host_grp_start"], a["host_d_tax"],
                          a["host_grp_id"], a["host_masks"], min_k, max_k,
                          num_species)
    with timers.stage("turbo/mesh-host-tables"):
        tables = [build_group_table(limbs, tax_rows, highest_k, max_k - ki)
                  for ki in range(num_k)]
    return HostTables(limbs, [t.grp_start for t in tables],
                      [t.d_tax for t in tables],
                      [t.grp_id for t in tables],
                      np.stack([t.mask for t in tables]).astype(np.int32),
                      min_k, max_k, num_species)


@dataclass
class ShardedTurboTables:
    """One rank's index shard as turbo tables on its device, and (on
    rank 0) the whole index's host tables."""
    shard: object           # match.turbo.TurboTables of entries
                            # [bounds[index], bounds[index + 1])
    index: int
    ip: int
    bounds: np.ndarray      # (ip + 1,) prefix-aligned entry bounds
    host: object = None     # HostTables (or TurboTables) on rank 0

    @classmethod
    def build(cls, limbs: np.ndarray, tax_rows: np.ndarray, highest_k: int,
              min_k: int, max_k: int, num_species: int, ip: int,
              index: int, device, host=None,
              index_path: str | None = None) -> "ShardedTurboTables":
        """Shard `index` of ip: the entries between its prefix-aligned
        bounds (an empty shard: the one POISON_LIMB entry, which no valid
        window matches), built by the turbo builder and, with
        index_path, cached in a sidecar of its own
        (<index>.turbo_<minK>_<maxK>.ip<ip>s<index>.npz.tabs)."""
        from ..match.turbo import (build_tables_np, load_or_build_turbo,
                                   tables_from_numpy, turbo_supported)
        assert min_k >= 6, "prefix-aligned shards need min_k >= 6"
        assert turbo_supported(len(tax_rows), limbs.shape[1], min_k, max_k,
                               num_species)
        bounds = prefix_aligned_boundaries(limbs[:, 0], ip)
        sl, st = shard_slice(limbs, tax_rows.astype(np.int32), bounds,
                             index)
        with timers.stage("turbo/mesh-tables"):
            if index_path is not None:
                tt = load_or_build_turbo(index_path, sl, st, highest_k,
                                         min_k, max_k, num_species, device,
                                         tag=f".ip{ip}s{index}")
            else:
                tt = tables_from_numpy(
                    *build_tables_np(sl, st, highest_k, min_k, max_k,
                                     num_species), device)
        return cls(tt, index, ip, bounds, host)


# ---------------------------------------------------------------------------
# K14 mesh_merge: the merge of the gathered shard lists and the CSR pack
# (kasa_tpu turbo_mesh.py:230-275)

def mesh_merge_plain(hts: torch.Tensor, hks: torch.Tensor,
                     ofc: torch.Tensor, ofl: torch.Tensor, cap: int):
    """(ip, R, wout) shard lists (taxon rows, SENT in an empty slot;
    ksums) and the shard-ORed flags -> (packed (2R + 2 cap + 2,) int32:
    [hc | flags | CSR (tax, ksum bits) x cap | total, flagged reads],
    ht_m (R, wout), hk_m (R, wout)): per read a stable sort of its
    ip x wout pairs by taxon, the sum of each taxon's ksums in shard
    order, the first wout taxa in taxon order; ofl |= more than wout
    taxa, hc = min(ntax, wout)."""
    from ..match.turbo import _segment_sums
    ip, R, wout = hts.shape
    dev = hts.device
    tk = hts.permute(1, 0, 2).reshape(R, ip * wout)
    tv = hks.permute(1, 0, 2).reshape(R, ip * wout)
    k2, order = torch.sort(tk, dim=1, stable=True)
    v2 = torch.gather(tv, 1, order)
    v2 = torch.where(k2 != SENT, v2, torch.zeros_like(v2))
    rk, sums, ntax = _segment_sums(k2, v2)
    ht_m = rk[:, :wout].contiguous()
    hk_m = torch.where(ht_m != SENT, sums[:, :wout],
                       torch.zeros_like(sums[:, :wout])).contiguous()
    ofl_m = ofl | (ntax > wout)
    hc = ntax.clamp(max=wout).to(torch.int32)
    flags = ofc.to(torch.int32) | (ofl_m.to(torch.int32) << 1)
    cum = torch.cumsum(hc, 0) - hc
    iw = torch.arange(wout, dtype=torch.int32, device=dev)
    dest = cum[:, None] + iw[None, :]
    ok = (iw[None, :] < hc[:, None]) & (dest < cap)
    pairs = torch.stack([ht_m, hk_m.view(torch.int32)], dim=-1)
    csr = torch.zeros((cap, 2), dtype=torch.int32, device=dev)
    csr[dest[ok].long()] = pairs[ok]
    tail = torch.stack([hc.sum(dtype=torch.int32),
                        (flags != 0).sum(dtype=torch.int32)])
    packed = torch.cat([hc, flags, csr.reshape(-1), tail.to(torch.int32)])
    return packed, ht_m, hk_m


def mesh_merge(hts, hks, ofc, ofl, cap: int):
    """K14 wrapper: the CUDA kernel on CUDA tensors, else the plain
    version."""
    if hts.device.type == "cpu":
        return mesh_merge_plain(hts, hks, ofc, ofl, cap)
    from .. import kernels
    return kernels.mesh_merge(hts, hks, ofc.contiguous(), ofl.contiguous(),
                              cap)


# ---------------------------------------------------------------------------
# the step (kasa_tpu turbo_mesh.py:159 make_turbo_mesh_step, 187 step)

def turbo_mesh_step(st: ShardedTurboTables, mesh, mat: torch.Tensor,
                    lut: torch.Tensor, acc_ca: torch.Tensor,
                    acc_cu: torch.Tensor, num_reads: int, w: int, cap: int,
                    multi_budget: int, exp_budget: int, wout: int, *,
                    protein: bool = False, one_frame: bool = False,
                    lines_per_read: int = 1, unique: bool = False,
                    file_of_read=None):
    """This rank's dp block: mat (num_reads * lines_per_read, maxlen)
    uint8 on the rank's device -> (packed, ht_m (R, wout), hk_m) after
    the merge over "ip"; the block's counts go into acc_ca / acc_cu in
    place.  Every rank of the mesh calls it for every batch, with the
    same w, cap, budgets and wout."""
    from ..core.encode import encode_windows
    from ..match.turbo import dedup_windows, turbo_core
    tt = st.shard
    kpr = w * lines_per_read
    ipg = mesh.ip_group

    def global_or(flags):
        with timers.stage("mesh/or"):
            return or_over(ipg, flags)
    q = encode_windows(mat, lut, w, protein, one_frame, tt.highest_k)
    if unique:
        q = dedup_windows(q, num_reads, kpr)
    # one shard (ip = 1) has no other shard's flags to take in
    packed_s, ht, hk = turbo_core(tt, q, num_reads, kpr, acc_ca, acc_cu,
                                  cap, multi_budget, exp_budget,
                                  file_of_read, wout,
                                  flag_reduce=global_or if mesh.ip > 1
                                  else None)
    fl = packed_s[num_reads:2 * num_reads]
    ofc = (fl & 1) > 0                     # already global (the split)
    ofl = global_or((fl & 2) > 0)          # a shard's truncated list
    with timers.stage("mesh/gather"):
        hts = gather_over(ipg, ht)
        hks = gather_over(ipg, hk)
    return mesh_merge(hts, hks, ofc, ofl, cap)


class MeshTurboDispatch(TurboDispatchBase):
    """The drive loop's strategy on the mesh (kasa_tpu turbo_mesh.py:292),
    on every rank: dispatch runs this rank's dp block through
    turbo_mesh_step and gathers the packed dp rows; rank 0 (`writer`)
    also recomputes flagged reads against `tt`, the whole index's host
    tables, and writes."""

    def __init__(self, st: ShardedTurboTables, mesh):
        super().__init__(st.shard.device, st.shard.num_k,
                         st.shard.num_species)
        self.st = st
        self.mesh = mesh
        self.dp = mesh.dp
        self.tt = st.host
        self.writer = mesh.rank == 0
        self.multi_budget = MULTI_BUDGET
        self.exp_budget = EXP_BUDGET

    def budgets_for(self, lines_per_read: int, w: int) -> tuple:
        """The single-device budgets (SingleTurboDispatch.budgets_for)
        for a block's reads; the same on every rank, so every shard's
        lists are wout wide."""
        num_k, num_species = self._acc_shape
        return batch_budgets(w * lines_per_read * num_k, num_species,
                             self.multi_budget, self.exp_budget)

    def reduce_acc(self, acc_ca, acc_cu):
        """Each rank counted its shard's groups for its dp rows: the sum
        over the whole mesh is the batch's counts."""
        with timers.stage("mesh/reduce-acc"):
            for t in (acc_ca, acc_cu):
                sum_over(None, t)       # the default group: every rank
        return super().reduce_acc(acc_ca, acc_cu)

    def round_rows(self, rows_pad: int) -> int:
        """rows_pad must split evenly over dp."""
        return -(-rows_pad // self.dp) * self.dp

    def csr_cap(self, rows_pad: int) -> int:
        return CSR_CAP_FACTOR * (rows_pad // self.dp)

    def dispatch(self, mat: np.ndarray, lut, acc_ca, acc_cu, rows_pad: int,
                 w: int, cap: int, file_of_read: np.ndarray | None = None,
                 **mode):
        """Queue this rank's dp block and gather every block's packed
        row.  The handle holds the (dp, plen) rows on the host; when a
        block's hits overflow its CSR, the dense merged lists of every
        block come back too (every rank sees the same tails, so all of
        them take part in that gather)."""
        lpr = mode.get("lines_per_read", 1)
        R = rows_pad // self.dp
        d = self.mesh.dp_index
        mat_d = torch.from_numpy(
            np.ascontiguousarray(mat[d * R * lpr:(d + 1) * R * lpr])) \
            .to(self.device)
        fo = None if file_of_read is None else \
            torch.from_numpy(file_of_read[d * R:(d + 1) * R]).to(self.device)
        mb, eb, wout = self.budgets_for(lpr, w)
        packed, ht_m, hk_m = turbo_mesh_step(
            self.st, self.mesh, mat_d, lut, acc_ca, acc_cu, R, w, cap, mb,
            eb, wout, file_of_read=fo, **mode)
        dpg = self.mesh.dp_group
        with timers.stage("mesh/gather"):
            rows = gather_over(dpg, packed).cpu()
            ht = hk = None
            if bool((rows[:, -2] > cap).any()):
                ht = gather_over(dpg, ht_m).cpu().numpy()
                hk = gather_over(dpg, hk_m).cpu().numpy()
        return ([rows], None), ht, hk

    def decode(self, packed: np.ndarray, rows_pad: int, rb: int, cap: int,
               want_lists: bool, ht_d=None, hk_d=None):
        """(dp, plen) packed rows -> the batch's (hc, ofc, ofl, nflag,
        ht, hk) over its first rb reads (kasa_tpu turbo_mesh.py:362);
        ht_d / hk_d: the (dp, R, wout) dense lists when a block's CSR
        overflowed."""
        dp = self.dp
        R = rows_pad // dp
        hc = packed[:, :R].reshape(-1)
        fl = packed[:, R:2 * R].reshape(-1)
        ofc = (fl[:rb] & 1).astype(bool)
        ofl = (fl[:rb] >> 1).astype(bool)
        # rank 0 alone holds the whole index's host tables: another rank
        # recomputes nothing
        nflag = int(packed[:, -1].sum()) if self.writer else 0
        ht = hk = None
        if want_lists:
            if ht_d is not None:
                ht = ht_d.reshape(rows_pad, -1)[:rb].copy()
                hk = hk_d.reshape(rows_pad, -1)[:rb].copy()
            else:
                maxc = max(int(hc[:rb].max()) if rb else 0, 1)
                ht = np.zeros((rb, maxc), np.int32)
                hk = np.zeros((rb, maxc), np.float32)
                for d in range(dp):
                    r0, r1 = d * R, min((d + 1) * R, rb)
                    if r1 <= r0:
                        break
                    hcd = hc[r0:r1]
                    csr = packed[d, 2 * R:2 * R + 2 * cap].reshape(cap, 2)
                    tot = int(hcd.sum())
                    rr = np.repeat(np.arange(r1 - r0), hcd)
                    cum = np.cumsum(hcd) - hcd
                    cc = np.arange(tot) - np.repeat(cum, hcd)
                    ht[r0 + rr, cc] = csr[:tot, 0]
                    hk[r0 + rr, cc] = csr[:tot, 1].view(np.float32)
        return hc[:rb].copy(), ofc, ofl, nflag, ht, hk
