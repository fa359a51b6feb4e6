"""Throughput identify pipeline (port of kasa_tpu/match/fast.py): one
device, or every rank of a process group on the turbo mesh
(parallel/turbo_mesh.py, chosen here by select_turbo_dispatch).

native file parse -> vectorized padded read matrix -> one turbo batch
step on the device per batch (resident tables: match/turbo.py
fused_turbo_acc, the CUDA kernels K1-K6; an index over the device
budget: match/tiered.py, chunk-streamed tables through K1, K5, K7, K8
and K3) -> packed readback decode -> exact host recompute of flagged
reads (tiered: the host adds the big groups and rebuilds truncated
lists) -> native rank+format -> file.  Where the turbo structure does
not apply (more than six k levels, min_k * 5 < 24, KASA_TPU_NO_TURBO,
int32 row pointers that would wrap), the classic engine takes the same
padded matrices: fused_classify, K1 (+ K5 under -e) and K9 per batch,
dense score rows to the native ranker.  Input the fused path does not
cover raises FastPathUnavailable, and the pipeline runs its per-batch
engine (kasa_tpu's routing).  A writer thread consumes
finished batches in order, so host post-processing of batch i overlaps
device work of batch i+1; the per-taxon count matrices accumulate on
the device and are flushed every COUNT_FLUSH batches (one (numK, S)
slab per file for identify_multiple with profiles).

Reads are laid out as a (rows, maxlen) uint8 matrix padded with 'X'
('^' for protein), lines_per_read rows per read (two under --six, times
two mates for paired-end).  The false-k-mer marker is 'X' too
(Read.hpp:1068-1078), so a row is the read followed by 'X' up to maxlen;
the uniform windows per row over-count, but every window past the
read's true count has a '^' letter at a checked position and
contributes nothing.
"""

from __future__ import annotations

import os
import queue as _queue
import threading as _threading
import time as _time
from collections import deque

import numpy as np
import torch

from ..host import fastx
from ..utils import timers
from .turbo import COUNT_FLUSH, CSR_CAP_FACTOR, EXP_BUDGET, MULTI_BUDGET

READS_PER_BATCH = 8192
MAXLEN_CAP = 8192       # longer reads take the per-batch engine


class FastPathUnavailable(RuntimeError):
    """Input the fused path does not cover (kasa_tpu fast.py:68): the
    pipeline runs the per-batch engine instead."""

# (fallback_reads, total_reads) of the last identify run
LAST_FALLBACK = (0, 0)
# the dispatch strategy of the last identify run (telemetry)
LAST_DISPATCH = None


def bytes_per_entry_resident(num_k: int, num_limbs: int = 2) -> int:
    """Estimated device bytes per index entry of the resident turbo
    tables: keys 4*L + rowdat 4*(L+2) + grp2 4*numK, plus ~20% slack for
    d_tax4 (the 134 MB router and the hot mask are fixed costs)."""
    return int((4 * num_limbs + 4 * (num_limbs + 2) + 4 * num_k) * 1.2)


def device_table_budget(cfg, device: torch.device) -> int:
    """Bytes of device memory the index tables may occupy: 85 % of the
    card's free memory, -m (80 %) on the CPU, KASA_DEVICE_BUDGET wins."""
    env = os.environ.get("KASA_DEVICE_BUDGET")
    if env:
        return int(env)
    if device.type == "cuda":
        free, _total = torch.cuda.mem_get_info(device)
        return int(free * 0.85)
    return int(cfg.memory_avail * 0.8)


class BatchAssembler:
    """Vectorized ragged -> padded matrix assembly (host, numpy)."""

    def __init__(self, highest_k: int, min_k: int, protein: bool = False,
                 six: bool = False, one_frame: bool = False):
        from ..core.alphabet import build_revcomp_lut
        self.highest_k = highest_k
        self.protein = protein
        self.six = six and not protein
        self.one_frame = one_frame
        self.revcomp = build_revcomp_lut()
        self.padc = ord("^") if protein else ord("X")
        self.marker_len = (highest_k - min_k) if protein \
            else (highest_k - min_k) * 3

    @property
    def min_line(self) -> int:
        """Shortest padded line: one window's span."""
        return self.highest_k if self.protein else 3 * self.highest_k

    def window_target(self, maxlen: int) -> int:
        """Uniform windows per line for a padded line of `maxlen`."""
        if self.protein:
            return maxlen - self.highest_k + 1
        if self.one_frame:
            return maxlen // 3 - self.highest_k + 1
        return maxlen - 3 * self.highest_k + 1

    def true_counts(self, lens: np.ndarray) -> np.ndarray:
        """calculatekMerCount per line (line = read + marker)."""
        ll = lens + self.marker_len
        if self.protein:
            c = np.where(ll > self.highest_k + 1, ll - self.highest_k + 1, 0)
        elif self.one_frame:
            d3 = ll // 3
            c = np.where(d3 > self.highest_k + 1, d3 - self.highest_k + 1, 0)
        else:
            c = np.where(ll > 3 * self.highest_k + 1,
                         ll - 3 * self.highest_k + 1, 0)
        if self.six:
            c = c * 2
        return c

    def assemble(self, blob: np.ndarray, offs: np.ndarray, maxlen: int,
                 rows_pad: int) -> np.ndarray:
        """blob: sanitized bytes; offs: (R+1,) read offsets.  Returns
        (rows_pad * lpr, maxlen) uint8, 'X'/'^'-padded; under --six the
        RC line precedes the forward line of each read (Read.hpp:612-630)."""
        return self.assemble_multi([blob], [offs], maxlen, rows_pad)

    def assemble_multi(self, blobs: list, offs_list: list, maxlen: int,
                       rows_pad: int) -> np.ndarray:
        """Paired-end assembly: each read owns lpr = mates * (2 if --six
        else 1) adjacent rows, mate m's line(s) at offset m * spm
        (readFastqa_pairedEnd emits the first mate's line(s), then the
        second's, under one read id, Read.hpp:834-1050)."""
        spm = 2 if self.six else 1
        lpr = spm * len(blobs)
        out = np.full((rows_pad * lpr, maxlen), self.padc, np.uint8)
        for m, (blob, offs) in enumerate(zip(blobs, offs_list)):
            self._assemble_into(out, blob, offs, maxlen, lpr, m * spm)
        return out

    def _assemble_into(self, out: np.ndarray, blob: np.ndarray,
                       offs: np.ndarray, maxlen: int, lpr: int,
                       row_off: int) -> None:
        """Write one mate's line(s): read r's rows start at r * lpr +
        row_off (RC first under --six, then forward)."""
        R = len(offs) - 1
        lens = np.diff(offs)
        out_flat = out.reshape(-1)
        src = np.arange(len(blob), dtype=np.int64)
        rid = np.repeat(np.arange(R, dtype=np.int64), lens)
        within = src - offs[rid]
        if self.six:
            fwd_rows = lpr * rid + row_off + 1
            out_flat[fwd_rows * maxlen + within] = blob[src]
            # short reads are padded BEFORE the reverse complement
            # (paddingOfSmallReads, then reverseComplement), so the RC
            # row gets an 'X' prefix
            need = np.maximum(0, 3 * self.highest_k - self.marker_len - lens)
            rc_rows = lpr * rid + row_off
            rc_within = need[rid] + (lens[rid] - 1 - within)
            out_flat[rc_rows * maxlen + rc_within] = self.revcomp[blob[src]]
        else:
            out_flat[(lpr * rid + row_off) * maxlen + within] = blob[src]


def _bucket(n: int, minimum: int) -> int:
    size = minimum
    while size < n:
        size <<= 1
    return size


def _len_bucket(n: int, minimum: int, step: int = 16) -> int:
    """Round the padded line length up to a multiple of `step` (a 150 bp
    read plus the 15-char marker is 165 chars -> 176, 141 windows).
    kasa_tpu coarsens rare lengths to a power of two to bound its
    compiled shapes; the kernels here take any length, so the port
    keeps the fine bucket (and the slot-cap check up front covers every
    batch)."""
    n = max(n, minimum)
    return (n + step - 1) // step * step


class TurboDispatchBase:
    """What the drive loop needs of every dispatch strategy besides
    dispatch(): the device count accumulators, the CSR capacity, the
    asynchronous readback and its decode.  `writer`: this process
    decodes and writes (every rank of a mesh dispatches; rank 0
    writes)."""

    additive_fixup = False
    writer = True

    def __init__(self, device: torch.device, num_k: int, num_species: int):
        self.device = device
        self._acc_shape = (num_k, num_species)

    def new_acc(self, num_files: int | None = None):
        shape = self._acc_shape if num_files is None \
            else (num_files, *self._acc_shape)
        return (torch.zeros(shape, dtype=torch.float32, device=self.device),
                torch.zeros(shape, dtype=torch.int32, device=self.device))

    def reduce_acc(self, acc_ca, acc_cu):
        """-> host (f64, int64) copies; the device buffers are zeroed in
        place for the next flush window."""
        ca = acc_ca.cpu().numpy().astype(np.float64)
        cu = acc_cu.cpu().numpy().astype(np.int64)
        acc_ca.zero_()
        acc_cu.zero_()
        return ca, cu

    def csr_cap(self, rows_pad: int) -> int:
        return CSR_CAP_FACTOR * rows_pad

    def round_rows(self, rows_pad: int) -> int:
        return rows_pad

    def _to_host(self, tensors):
        return _to_host(tensors, self.device)

    def fetch(self, handle) -> list:
        return _fetch(handle)

    def decode(self, packed: np.ndarray, rows_pad: int, rb: int,
               cap: int, want_lists: bool, ht_d=None, hk_d=None):
        from .tiered import SingleTurboDispatch_decode
        return SingleTurboDispatch_decode(packed, rows_pad, rb, cap,
                                          want_lists, ht_d, hk_d)


class SingleTurboDispatch(TurboDispatchBase):
    """Single-device dispatch/decode strategy for the turbo drive loop
    over resident tables.

    The multi worklist and expansion budgets are plain runtime sizes
    (kasa_tpu freezes them per run because each value is a compiled
    shape), and the kernels' scratch comes from PyTorch's caching
    allocator."""

    def __init__(self, tt, num_k: int, num_species: int):
        super().__init__(tt.device, num_k, num_species)
        self.tt = tt
        self.multi_budget = MULTI_BUDGET
        self.exp_budget = EXP_BUDGET

    def budgets_for(self, lines_per_read: int, w: int) -> tuple:
        """(multi budget, expansion budget, hit-list width) of a batch of
        w windows a line: kasa_tpu's MULTI_BUDGET, EXP_BUDGET and WOUT
        for each BUDGET_SLOTS slots of a read (turbo.batch_budgets).  On
        the synthetic corpus a batch of reads of two 150 bp lines (--six,
        or pairs) needs ~55 % of the multi budget and pairs under --six
        need twice that (chip_smoke.py's budgets phase prints both); a
        batch of 1-8 kbp reads needs ~1,200 multi slots a read and lists
        of up to ~650 taxa, so kasa_tpu's fixed sizes would send every
        one of its reads to the host recompute."""
        from .turbo import batch_budgets
        num_k, num_species = self._acc_shape
        return batch_budgets(w * lines_per_read * num_k, num_species,
                             self.multi_budget, self.exp_budget)

    def dispatch(self, mat: np.ndarray, lut, acc_ca, acc_cu, rows_pad: int,
                 w: int, cap: int, file_of_read: np.ndarray | None = None,
                 **mode):
        """Queue one batch; `mode` (protein, one_frame, lines_per_read,
        unique) goes to fused_turbo_acc.  With file_of_read the
        accumulators are the (F, numK, S) slabs of the batch's files.
        Returns (handle of the packed readback, ht, hk)."""
        from .turbo import fused_turbo_acc
        mat_d = torch.from_numpy(mat).to(self.device)
        fo = None if file_of_read is None \
            else torch.from_numpy(file_of_read).to(self.device)
        mb, eb, wout = self.budgets_for(mode.get("lines_per_read", 1), w)
        packed, ht, hk = fused_turbo_acc(
            self.tt, mat_d, lut, acc_ca, acc_cu, rows_pad, w, cap, mb, eb,
            file_of_read=fo, wout=wout, **mode)
        return self._to_host([packed]), ht, hk


def _tiered(cfg, index_path, limbs, tax_rows, highest_k, budget, device,
            S):
    """The tiered strategy: chunks of (budget * 0.75) / 24 entries (at
    least 2^16), cached under cfg.temp_path or next to the index."""
    from .tiered import TieredTurboDispatch, chunk_entries_for
    min_k, max_k = cfg.lower_k, cfg.higher_k
    chunk_entries = chunk_entries_for(budget, max_k - min_k + 1)
    with timers.stage("tiered/tables"):
        return TieredTurboDispatch(
            index_path, limbs, tax_rows, highest_k, min_k, max_k, S,
            chunk_entries, device,
            cache_dir=(os.path.join(cfg.temp_path,
                                    f"oocache_turbo_torch_{cfg.call_idx}")
                       if cfg.temp_path else None))


def mesh_shape(world: int, min_ip: int, min_k: int,
               num_limbs: int) -> tuple[int, int] | None:
    """(dp, ip) of the turbo mesh, or None for one device (kasa_tpu
    fast.py:797-816): KASA_MESH_IP / KASA_MESH_DP force a shape, ip
    defaults to min_ip and dp to world // ip; no mesh when dp * ip <= 1
    or above the world (the ranks stand for kasa_tpu's devices), below
    min_k 6 or for tables of more than two limbs."""
    ip = int(os.environ.get("KASA_MESH_IP", 0) or 0) or max(min_ip, 1)
    dp = int(os.environ.get("KASA_MESH_DP", 0) or 0) or max(world // ip, 1)
    if dp * ip <= 1 or dp * ip > world or min_k < 6 or num_limbs != 2:
        return None
    return dp, ip


def select_turbo_dispatch(cfg, index_path, limbs, taxids, content,
                          highest_k, tax_rows, device: torch.device):
    """The dispatch strategy for this index on `device` (kasa_tpu
    fast.py:299): resident turbo tables when they fit the device budget
    (or -r); over the budget, a 64-bit index over at most six k levels
    from min_k >= 6 first shards over the mesh's "ip" when 1/ip of the
    tables fits (the smallest such ip up to the world size), else takes
    tiered chunk streaming (also when the resident tables' int32 row
    pointers would wrap); a forced mesh (KASA_MESH_IP / KASA_MESH_DP)
    never streams.  The mesh (parallel/turbo_mesh.py) runs whenever the
    process group has more than one rank or a shape is forced
    (mesh_shape).  None where kasa_tpu returns None: the turbo structure
    does not apply, KASA_TPU_NO_TURBO is set, or the row pointers would
    wrap without a tiered path (the classic engine runs).  An
    over-budget index that neither the mesh nor tiered streaming can
    take keeps resident tables, as kasa_tpu does (fast.py:342-351,
    375-404).  In a multi-process run, a rank other than 0 whose route
    is not the mesh raises NotWriter (parallel/dist.py writer_only)."""
    from ..parallel import dist as pdist
    from .tiered import TMAX, chunk_entries_for
    from .turbo import (TurboRowOverflow, load_or_build_turbo,
                        turbo_supported)
    min_k, max_k = cfg.lower_k, cfg.higher_k
    num_k = max_k - min_k + 1
    S = content.num_species
    n_idx = len(taxids)
    num_limbs = limbs.shape[1] if n_idx else 2
    eligible_resident = turbo_supported(n_idx, num_limbs, min_k, max_k, S)
    eligible_tiered = (n_idx > 0 and num_limbs == 2 and num_k <= 6
                       and min_k >= 6 and S < (1 << 24))
    if not (eligible_resident or eligible_tiered) \
            or os.environ.get("KASA_TPU_NO_TURBO"):
        pdist.writer_only()
        return None
    world = pdist.world_size()
    budget = device_table_budget(cfg, device)
    if world > 1:
        # every rank takes the same route: the smallest rank's budget
        # (ranks that share a card see different free memory); on the
        # rank's device, which NCCL needs
        b = torch.tensor([budget], dtype=torch.int64, device=device)
        torch.distributed.all_reduce(b, op=torch.distributed.ReduceOp.MIN)
        budget = int(b.item())
    table_bytes = bytes_per_entry_resident(num_k, num_limbs) * max(n_idx, 1)
    over = not cfg.ram and table_bytes > budget
    min_ip = 1
    if over and min_k >= 6:
        while min_ip < world and table_bytes // min_ip > budget:
            min_ip <<= 1
        if table_bytes // min_ip > budget or min_ip > world or min_ip == 1:
            min_ip = 0          # sharding cannot fit: tiered
    mesh_forced = max(int(os.environ.get("KASA_MESH_IP", "0") or 0),
                      int(os.environ.get("KASA_MESH_DP", "0") or 0)) > 1
    shape = mesh_shape(world, max(min_ip, 1), min_k, num_limbs) \
        if eligible_resident else None
    tiered = eligible_tiered and over \
        and (min_ip == 0 or not eligible_resident) and not mesh_forced
    if shape is None or tiered:
        pdist.writer_only()
    if tiered:
        print(f"OUT: turbo tables ({table_bytes >> 20} MiB) exceed the "
              "memory budget; tiered turbo streams "
              f"{chunk_entries_for(budget, num_k)}-entry "
              f"chunks (T>{TMAX} groups on host)", flush=True)
        return _tiered(cfg, index_path, limbs, tax_rows, highest_k, budget,
                       device, S)
    if not eligible_resident:
        raise FastPathUnavailable(
            "index too large for resident turbo and tiered streaming was "
            "excluded (-r or mesh override)")
    if shape is not None and shape[1] > 1:
        return make_mesh_dispatch(cfg, index_path, limbs, tax_rows,
                                  highest_k, S, device, *shape)
    try:
        content_token = os.stat(cfg.content_file
                                or index_path + "_content.txt").st_mtime_ns
    except OSError:
        content_token = None
    try:
        with timers.stage("turbo/tables"):
            tt = load_or_build_turbo(index_path, limbs, tax_rows, highest_k,
                                     min_k, max_k, S, device, content_token)
    except TurboRowOverflow as e:
        # multi-heavy index: the resident tables' int32 row pointers
        # would wrap; the tiered chunks' tables stay int32-safe
        pdist.writer_only()
        if not eligible_tiered:
            print(f"OUT: {e}; using the classic engine", flush=True)
            return None
        print(f"OUT: {e}; streaming tiered turbo instead", flush=True)
        return _tiered(cfg, index_path, limbs, tax_rows, highest_k, budget,
                       device, S)
    if shape is not None:
        return make_mesh_dispatch(cfg, index_path, limbs, tax_rows,
                                  highest_k, S, device, *shape, whole=tt)
    return SingleTurboDispatch(tt, num_k, S)


def make_mesh_dispatch(cfg, index_path, limbs, tax_rows, highest_k: int,
                       num_species: int, device, dp: int, ip: int,
                       whole=None):
    """The turbo mesh over every rank (kasa_tpu fast.py:797
    make_turbo_dispatch's mesh arm): each rank builds its ip shard's
    tables (at ip = 1 the whole index's, `whole`), rank 0 also holds the
    whole index's host tables for the exact recompute."""
    from ..parallel.dist import make_identify_mesh
    from ..parallel.turbo_mesh import (MeshTurboDispatch,
                                       ShardedTurboTables,
                                       whole_host_tables)
    mesh = make_identify_mesh(ip=ip, dp=dp)
    min_k, max_k = cfg.lower_k, cfg.higher_k
    if whole is not None:
        st = ShardedTurboTables(whole, 0, 1, np.array([0, len(tax_rows)]),
                                whole)
    else:
        host = whole_host_tables(index_path, limbs, tax_rows, highest_k,
                                 min_k, max_k, num_species) \
            if mesh.rank == 0 else None
        st = ShardedTurboTables.build(limbs, tax_rows, highest_k, min_k,
                                      max_k, num_species, ip, mesh.ip_index,
                                      device, host, index_path)
    if mesh.rank == 0:
        print(f"OUT: turbo mesh active: {mesh.describe()}", flush=True)
    return MeshTurboDispatch(st, mesh)


def _parse(path: str):
    from ..native import get_lib, load_fastx
    if get_lib() is None:
        raise RuntimeError("the native host library (g++ and zlib) is "
                           "unavailable")
    fmt = fastx.sniff_format(path)
    with timers.stage("fast/parse"):
        parsed = load_fastx(path, fmt == "fastq")
    if parsed is None:
        raise RuntimeError(f"could not parse {path}")
    return parsed


def _check_input(seqs: list, lens: np.ndarray, protein: bool) -> None:
    """Before any output is written: reads above MAXLEN_CAP go to the
    per-batch engine (FastPathUnavailable), spaces or tabs inside a read
    raise; then sanitize in place."""
    from ..native import sanitize_inplace
    if int(lens.max()) > MAXLEN_CAP:
        raise FastPathUnavailable("giant reads need the chunked pipeline")
    for seq in seqs:
        if np.any((seq == ord(" ")) | (seq == ord("\t"))):
            raise RuntimeError("Spaces or tabs inside read, "
                               "please check your input.")
        sanitize_inplace(seq, protein)


def fast_identify(cfg, index_path: str, input_path: str,
                  out_file: str | None, profile_file: str | None,
                  content, freqs, limbs, taxids, highest_k: int,
                  tax_rows, device: torch.device):
    """Drive the fused pipeline over one input file, or a paired-end pair
    (cfg.paired_end_1/2): the turbo strategies, or the classic engine
    where select_turbo_dispatch returns None.  Returns (counts_all,
    counts_unique, reads, k-mers in input).  Raises FastPathUnavailable
    for an empty input, reads above MAXLEN_CAP and paired-end input on
    the classic engine (kasa_tpu fast.py:458-499)."""
    protein = cfg.translated
    paired = bool(cfg.paired_end_1)
    paths = [cfg.paired_end_1, cfg.paired_end_2] if paired else [input_path]
    mates = [_parse(p) for p in paths]
    seq, seq_off, name_blob, name_off, nlines = mates[0]
    # the reference zips mates: unequal files end at the shorter
    R_total = min(len(m[1]) - 1 for m in mates)
    if R_total == 0:
        raise FastPathUnavailable("empty input")
    mate_lens = [np.diff(m[1])[:R_total] for m in mates]
    all_lens = np.concatenate(mate_lens)
    _check_input([m[0] for m in mates], all_lens, protein)
    asm = BatchAssembler(highest_k, cfg.lower_k, protein, cfg.six_frames,
                         cfg.one_frame)
    lpr = (2 if asm.six else 1) * len(mates)
    # report lengths follow the reference's char counter (raw chars +
    # one newline per sequence line); paired mates share one read id
    # with summed lengths and names joined by a space
    # (readFastqa_pairedEnd, Read.hpp:834-1050)
    rep_lens = sum(ln + m[4][:R_total] for ln, m in zip(mate_lens, mates)) \
        .astype(np.uint32)
    if paired:
        name_blob, name_off = _join_name_blobs(
            name_blob, name_off, mates[1][2], mates[1][3], R_total)

    disp = select_turbo_dispatch(cfg, index_path, limbs, taxids, content,
                                 highest_k, tax_rows, device)
    global LAST_DISPATCH
    LAST_DISPATCH = disp
    if disp is None:
        if paired:
            raise FastPathUnavailable("paired-end rides the turbo path only")
        from .device import load_or_build_classic
        tables = load_or_build_classic(
            index_path, limbs, taxids, content.tax_to_idx, highest_k,
            cfg.lower_k, cfg.higher_k, content.num_species, device, tax_rows)
        LAST_DISPATCH = tables
        return _fast_identify_classic(
            cfg, tables, asm, seq, seq_off, name_blob, name_off, rep_lens,
            R_total, out_file, profile_file, content, freqs, input_path)
    return _fast_identify_turbo(
        cfg, disp, asm, lpr, [(m[0], m[1]) for m in mates], name_blob,
        name_off, rep_lens, R_total, out_file, profile_file, content, freqs,
        input_path)


def fused_classify(tables, mat: torch.Tensor, lut: torch.Tensor,
                   rows_pad: int, w: int, lines_per_read: int = 1,
                   protein: bool = False, one_frame: bool = False,
                   unique: bool = False):
    """One classic batch (kasa_tpu fast.py:138 fused_classify): the
    (rows_pad * lines_per_read, maxlen) uint8 matrix -> K1 windows, the
    first w of every line, the read's lines adjacent -> (under -e, K5:
    each read's repeated windows poisoned, which no level matches;
    kasa_tpu's fused classic path skips this step) -> K9 in the uniform
    layout.
    -> classify_batch's (scores (rows_pad, S), counts_all, counts_unique,
    tail_pairs)."""
    from ..core.encode import encode_windows
    from .device import classify_batch
    from .engine import CAP
    from .turbo import dedup_windows
    q = encode_windows(mat, lut, w, protein, one_frame, tables.highest_k)
    kpr = w * lines_per_read
    if unique:
        q = dedup_windows(q, rows_pad, kpr)
    valid = torch.ones(q.shape[0], dtype=torch.bool, device=q.device)
    return classify_batch(tables, q, None, valid, rows_pad, CAP, kpr)


def _to_host(tensors, device: torch.device):
    """Handle of device results: on a CUDA device each is copied into
    pinned host memory behind the batch's kernels and an event marks
    their arrival."""
    if device.type != "cuda":
        return tensors, None
    hosts = []
    for t in tensors:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        hosts.append(h)
    done = torch.cuda.Event()
    done.record()
    return hosts, done


def _fetch(handle) -> list:
    """Host numpy views of a batch's results (waits for its batch
    only)."""
    tensors, done = handle
    if done is not None:
        done.synchronize()
    return [t.numpy() for t in tensors]


def _fast_identify_classic(cfg, tables, asm, seq, seq_off, name_blob,
                           name_off, rep_lens, R_total, out_file,
                           profile_file, content, freqs, input_path):
    """Classic drive loop (kasa_tpu fast.py:500-618): one fused_classify
    per READS_PER_BATCH reads; while the host ranks and writes batch i,
    batch i + 1 runs on the device.  Per-batch float32 counts are summed
    in float64 on the host.  -e dedups each read's windows on the device
    (K5, at any length up to MAXLEN_CAP), where kasa_tpu's fused classic
    branch ignores -e; the result is its per-batch engine's, which dedups
    on the host."""
    from ..core.alphabet import build_codon_code_lut
    from ..core.encode import custom_code_lut
    from ..host import output as out_mod
    from ..native import NativeRanker

    highest_k = asm.highest_k
    min_k, max_k = cfg.lower_k, cfg.higher_k
    num_k = max_k - min_k + 1
    S = content.num_species
    protein = cfg.translated
    lpr = 2 if asm.six else 1
    lens = np.diff(seq_off)[:R_total]
    device = tables.device
    lut_np = custom_code_lut(cfg)
    lut = torch.from_numpy(np.asarray(
        lut_np if lut_np is not None else build_codon_code_lut(),
        dtype=np.int32)).to(device)

    ranker = None
    if out_file or cfg.filter:
        ranker = NativeRanker(
            content.idx_to_tax, content.organisms, freqs[:, 0],
            min_k, max_k, highest_k, protein, cfg.num_frames,
            cfg.threshold, cfg.num_of_beasts, cfg.output_format,
            filter_on=cfg.filter, error_threshold=cfg.error_threshold,
            coherence_threshold=cfg.coherence_threshold)
        if not ranker.ok:
            raise RuntimeError("the native ranker is unavailable")
    counts_all = np.zeros((num_k, S), dtype=np.float64)
    counts_unique = np.zeros((num_k, S), dtype=np.uint64)
    num_kmers_in_input = 0
    filtered_ids: list = []
    fh = None
    if out_file:
        fh = open(out_file, "wb")
        if cfg.output_format == "json":
            fh.write(b"[\n")
        elif cfg.output_format == "tsv":
            fh.write(b"#Read number\tSpecifier from input file\tMatched "
                     b"taxa\tNames\tScores{relative,k-mer}\tError\n")

    inflight: deque = deque()

    def drain(block_all=False):
        nonlocal num_kmers_in_input
        while inflight and (block_all or len(inflight) > 1):
            handle, r0, r1, nk = inflight.popleft()
            with timers.stage("fast/fetch"):
                scores, ca, cu = _fetch(handle)
            counts_all[:] += ca.astype(np.float64)
            counts_unique[:] += cu.astype(np.uint64)
            num_kmers_in_input += nk
            if ranker is None:
                continue
            with timers.stage("fast/rank+write"):
                names = [name_blob[name_off[i]:name_off[i + 1]]
                         .tobytes().decode("latin-1") + " "
                         for i in range(r0, r1)]
                text, flags = ranker.format(scores, names,
                                            rep_lens[r0:r1], r0)
                if fh is not None:
                    fh.write(text)
                if flags is not None:
                    filtered_ids.extend((r0 + np.nonzero(flags)[0]).tolist())

    t_start = _time.perf_counter()
    try:
        for r0 in range(0, R_total, READS_PER_BATCH):
            r1 = min(r0 + READS_PER_BATCH, R_total)
            if cfg.verbose and r0:
                frac = r0 / R_total
                el = _time.perf_counter() - t_start
                print(f"OUT: Progress of current file: {frac * 100.0:.2f} %"
                      f" (ETA: {el / frac - el:.0f}s)", flush=True)
            blens = lens[r0:r1]
            with timers.stage("fast/assemble"):
                maxlen = _len_bucket(int(blens.max()) + asm.marker_len,
                                     asm.min_line)
                rows_pad = _bucket(r1 - r0, 512)
                mat = asm.assemble(seq[seq_off[r0]:seq_off[r1]],
                                   (seq_off[r0:r1 + 1] - seq_off[r0])
                                   .astype(np.int64), maxlen, rows_pad)
                nk = int(asm.true_counts(blens).sum())
            with timers.stage("fast/dispatch"):
                scores_d, ca_d, cu_d, _tail = fused_classify(
                    tables, torch.from_numpy(mat).to(device), lut, rows_pad,
                    asm.window_target(maxlen), lpr, protein, cfg.one_frame,
                    cfg.unique)
                inflight.append((_to_host([scores_d[:r1 - r0], ca_d, cu_d],
                                          device), r0, r1, nk))
            drain()
        drain(block_all=True)
        if fh is not None and cfg.output_format == "json":
            fh.write(b"\n]")
    finally:
        if fh is not None:
            fh.close()

    if profile_file:
        out_mod.write_profile(
            profile_file, content.organisms, content.idx_to_tax,
            counts_all, counts_unique, None, freqs, num_kmers_in_input,
            R_total, min_k, max_k, cfg.num_frames, coverage=False)
    if cfg.filter:
        from .pipeline import write_filtered
        write_filtered(cfg, input_path, filtered_ids)
    if cfg.verbose:
        timers.report()
    global LAST_FALLBACK
    LAST_FALLBACK = (0, R_total)       # the classic engine recomputes none
    return counts_all, counts_unique, R_total, num_kmers_in_input


def _join_name_blobs(blob1, off1, blob2, off2, R):
    """Paired-end specifier: "name1 name2" per read (each mate's name
    plus a trailing space is appended, Read.hpp:869-874; the drive loop
    adds the final trailing space)."""
    n1 = np.diff(off1[:R + 1])
    n2 = np.diff(off2[:R + 1])
    off = np.zeros(R + 1, np.int64)
    np.cumsum(n1 + 1 + n2, out=off[1:])
    buf = np.full(int(off[-1]), ord(" "), np.uint8)
    src1 = np.arange(int(off1[R]), dtype=np.int64)
    rid1 = np.repeat(np.arange(R, dtype=np.int64), n1)
    buf[off[rid1] + (src1 - off1[rid1])] = blob1[src1]
    src2 = np.arange(int(off2[R]), dtype=np.int64)
    rid2 = np.repeat(np.arange(R, dtype=np.int64), n2)
    buf[off[rid2] + n1[rid2] + 1 + (src2 - off2[rid2])] = blob2[src2]
    return buf, off


def fast_identify_multi(cfg, index_path: str, files: list, out_files: list,
                        content, freqs, limbs, taxids, highest_k: int,
                        tax_rows, device: torch.device,
                        profile_files: list | None = None):
    """identify_multiple packing: a folder of single-end files
    classified as ONE read stream with shared batches and per-file
    output demux (read numbers restart in each file).  With
    profile_files, every batch runs the per-file count arms of K3/K4
    (kasa_tpu's fused_turbo_files), so each file gets its own count
    matrices even when a batch spans a file boundary.

    Returns per-file (ca, cu, reads, k-mers in input) tuples (ca, cu
    None without profiles)."""
    protein = cfg.translated
    parsed = [_parse(f) for f in files]
    seq = np.concatenate([p[0] for p in parsed])
    seq_off_parts, name_off_parts = [], []
    soff = noff = 0
    bounds = [0]
    for p in parsed:
        seq_off_parts.append(p[1][:-1] + soff)
        soff += p[1][-1]
        name_off_parts.append(p[3][:-1] + noff)
        noff += p[3][-1]
        bounds.append(bounds[-1] + len(p[1]) - 1)
    seq_off = np.concatenate(seq_off_parts + [np.array([soff])])
    name_blob = np.concatenate([p[2] for p in parsed])
    name_off = np.concatenate(name_off_parts + [np.array([noff])])
    nlines = np.concatenate([p[4] for p in parsed])
    R_total = bounds[-1]
    if R_total == 0:
        raise FastPathUnavailable("empty inputs")
    lens = np.diff(seq_off)
    asm = BatchAssembler(highest_k, cfg.lower_k, protein, False,
                         cfg.one_frame)
    _check_input([seq], lens, protein)
    rep_lens = (lens + nlines[:R_total]).astype(np.uint32)

    disp = select_turbo_dispatch(cfg, index_path, limbs, taxids, content,
                                 highest_k, tax_rows, device)
    if disp is None:
        raise FastPathUnavailable("turbo structure unavailable")
    if profile_files and disp.additive_fixup:
        raise NotImplementedError(
            "identify_multiple with profiles on an index over the device "
            "budget: the tiered path has no per-file counts (kasa_tpu's "
            "TieredTurboDispatch has no dispatch_files either and fails "
            "there)")
    global LAST_DISPATCH
    LAST_DISPATCH = disp
    segments = [dict(start=bounds[i], end=bounds[i + 1], out=out_files[i],
                     fh=None,
                     profile=profile_files[i] if profile_files else None)
                for i in range(len(files))]
    ca, cu, _, _ = _fast_identify_turbo(
        cfg, disp, asm, 1, [(seq, seq_off)], name_blob, name_off, rep_lens,
        R_total, "-", None, content, freqs, files[0], segments=segments)
    from ..host import output as out_mod
    min_k, max_k = cfg.lower_k, cfg.higher_k
    out = []
    for i, seg in enumerate(segments):
        nr = bounds[i + 1] - bounds[i]
        nk = int(asm.true_counts(lens[bounds[i]:bounds[i + 1]]).sum())
        if seg["profile"]:
            out_mod.write_profile(
                seg["profile"], content.organisms, content.idx_to_tax,
                ca[i], cu[i], None, freqs, nk, nr, min_k, max_k,
                cfg.num_frames, coverage=False)
            out.append((ca[i], cu[i], nr, nk))
        else:
            out.append((None, None, nr, nk))
    return out


def _fast_identify_turbo(cfg, disp, asm, lpr, mate_views, name_blob,
                         name_off, rep_lens, R_total, out_file, profile_file,
                         content, freqs, input_path, segments=None):
    """Turbo drive loop (kasa_tpu fast.py:953): batches go to the
    device in order; ONE writer thread fetches, decodes, recomputes
    flagged reads on the host, ranks and writes, in FIFO order.

    segments (identify_multiple): per-file read ranges of the one
    stream, each with its own output file and, with profiles, its own
    host count totals."""
    from ..core.alphabet import build_codon_code_lut
    from ..core.encode import custom_code_lut
    from ..host import output as out_mod
    from ..native import NativeRanker
    from .turbo import dedup_windows_np, host_classify_read, read_windows_np

    tt = disp.tt
    additive = disp.additive_fixup
    highest_k = asm.highest_k
    min_k, max_k = cfg.lower_k, cfg.higher_k
    num_k = max_k - min_k + 1
    S = content.num_species
    protein = cfg.translated
    lut_np = custom_code_lut(cfg)
    lut_np = np.asarray(lut_np if lut_np is not None
                        else build_codon_code_lut(), dtype=np.int32)
    lut = torch.from_numpy(lut_np).to(disp.device)
    mode = dict(protein=protein, one_frame=cfg.one_frame,
                lines_per_read=lpr, unique=cfg.unique)

    per_file_counts = segments is not None \
        and any(seg["profile"] for seg in segments)
    if not disp.writer:
        # a mesh rank other than 0 dispatches its dp blocks and joins
        # every collective (with rank 0's count slabs); rank 0 alone
        # recomputes, ranks and writes
        out_file = profile_file = None
        for seg in segments or ():
            seg["out"] = seg["profile"] = None

    ranker = None
    if disp.writer and (out_file or cfg.filter):
        ranker = NativeRanker(
            content.idx_to_tax, content.organisms, freqs[:, 0],
            min_k, max_k, highest_k, protein, cfg.num_frames,
            cfg.threshold, cfg.num_of_beasts, cfg.output_format,
            filter_on=cfg.filter, error_threshold=cfg.error_threshold,
            coherence_threshold=cfg.coherence_threshold)
        if not ranker.ok:
            raise RuntimeError("the native ranker is unavailable")

    # with per-file counts every file has its own (numK, S) slab, on the
    # device and on the host
    acc_lead = (len(segments),) if per_file_counts else ()
    counts_all = np.zeros(acc_lead + (num_k, S), dtype=np.float64)
    counts_unique = np.zeros(acc_lead + (num_k, S), dtype=np.uint64)
    seg_ends = np.array([seg["end"] for seg in segments or ()], np.int64)
    num_kmers_in_input = 0
    fallback_reads = 0
    filtered_ids: list = []

    hdr = (b"[\n" if cfg.output_format == "json" else
           b"#Read number\tSpecifier from input file\tMatched "
           b"taxa\tNames\tScores{relative,k-mer}\tError\n"
           if cfg.output_format == "tsv" else b"")
    fh = None
    if segments is not None:
        # each output file frames its own read range; batches may span
        # file boundaries
        for seg in segments:
            seg["fh"] = open(seg["out"], "wb") if seg["out"] else None
            if seg["fh"] is not None and hdr:
                seg["fh"].write(hdr)
    elif out_file:
        fh = open(out_file, "wb")
        if hdr:
            fh.write(hdr)

    def file_of(global_r):
        """Index of the file (segment) that holds read `global_r`."""
        return np.searchsorted(seg_ends, global_r, side="right")

    def read_q(mat, r, w):
        q = read_windows_np(mat[r * lpr:(r + 1) * lpr], lut_np, highest_k,
                            protein, cfg.one_frame, w)
        return dedup_windows_np(q) if cfg.unique else q

    def consume(item):
        nonlocal num_kmers_in_input, fallback_reads
        handle, ht_d, hk_d, r0, r1, nk, mat, w, rows_pad, cap = item
        rb = r1 - r0
        num_kmers_in_input += int(nk)
        with timers.stage("fast/fetch"):
            fetched = disp.fetch(handle)
        packed = fetched[0]
        hc, ofc, ofl, nflag, ht, hk = disp.decode(
            packed, rows_pad, rb, cap, ranker is not None, ht_d, hk_d)
        # without a ranker only count-overflow rows need recompute; with
        # one, every truncated list (ofl is a superset of ofc) is rebuilt
        need_fix = ofl if ranker is not None else ofc
        if nflag and need_fix.any():
            with timers.stage("turbo/fallback"):
                rows = np.nonzero(need_fix)[0]
                fallback_reads += len(rows)
                fixes = {}
                wmax = ht.shape[1] if ht is not None else 0
                for r in rows:
                    q = read_q(mat, int(r), w)
                    if additive:
                        # tiered contract: the device counted every group
                        # of T <= TMAX; the host ADDS the big groups (ofc
                        # bit) and rebuilds truncated lists (ofl bit)
                        scores, ca2, cu2 = disp.host_fixup(q)
                        if ofc[r]:
                            counts_all[:] += ca2
                            counts_unique[:] += cu2.astype(np.uint64)
                            disp.host_add_reads += 1
                        if ranker is None:
                            continue
                        disp.host_rebuild_reads += 1
                    else:
                        scores, ca2, cu2 = host_classify_read(tt, q)
                        if ofc[r]:
                            f = file_of(r0 + int(r)) if per_file_counts \
                                else ()
                            counts_all[f] += ca2
                            counts_unique[f] += cu2.astype(np.uint64)
                        if ranker is None:
                            continue
                    items = sorted((int(t), float(v))
                                   for t, v in scores.items() if v > 0.0)
                    fixes[int(r)] = items
                    wmax = max(wmax, len(items))
                if ranker is not None:
                    if wmax > ht.shape[1]:
                        ht2 = np.zeros((rb, wmax), np.int32)
                        hk2 = np.zeros((rb, wmax), np.float32)
                        ht2[:, :ht.shape[1]] = ht
                        hk2[:, :ht.shape[1]] = hk
                        ht, hk = ht2, hk2
                    for r, items in fixes.items():
                        hc[r] = len(items)
                        for i, (t, v) in enumerate(items):
                            ht[r, i] = t
                            hk[r, i] = v
        if ranker is None:
            return
        with timers.stage("fast/rank+write"):
            names = [name_blob[name_off[i]:name_off[i + 1]]
                     .tobytes().decode("latin-1") + " "
                     for i in range(r0, r1)]
            if segments is None:
                text, flags = ranker.format_sparse(
                    ht, hk, hc, names, rep_lens[r0:r1], r0)
                if fh is not None:
                    fh.write(text)
                if flags is not None:
                    filtered_ids.extend((r0 + np.nonzero(flags)[0]).tolist())
                return
            # split the batch at file boundaries; read numbers restart
            # in each file
            for seg in segments:
                a, b = max(r0, seg["start"]), min(r1, seg["end"])
                if b <= a:
                    continue
                text, _ = ranker.format_sparse(
                    ht[a - r0:b - r0], hk[a - r0:b - r0], hc[a - r0:b - r0],
                    names[a - r0:b - r0], rep_lens[a:b], a - seg["start"])
                if seg["fh"] is not None:
                    seg["fh"].write(text)

    work_q: _queue.Queue = _queue.Queue(maxsize=4)
    writer_exc: list = []

    def _writer_loop():
        while True:
            item = work_q.get()
            try:
                if item is None:
                    return
                if not writer_exc:
                    consume(item)
            except BaseException as e:       # surfaced by the producer
                writer_exc.append(e)
            finally:
                work_q.task_done()

    writer_thread = _threading.Thread(target=_writer_loop, daemon=True)
    writer_thread.start()

    def submit(item):
        if writer_exc:
            raise writer_exc[0]
        work_q.put(item)

    # device count accumulators (added to in place by every batch),
    # flushed every COUNT_FLUSH batches so f32 drift stays bounded
    acc_ca, acc_cu = disp.new_acc(*acc_lead)
    sin_flush = 0

    def flush_counts():
        nonlocal sin_flush
        work_q.join()   # the writer owns counts_* until the queue drains
        if writer_exc:
            raise writer_exc[0]
        with timers.stage("fast/fetch-counts"):
            ca_h, cu_h = disp.reduce_acc(acc_ca, acc_cu)
            counts_all[:] += ca_h
            counts_unique[:] += cu_h.astype(np.uint64)
        sin_flush = 0

    t_start = _time.perf_counter()
    rpb = getattr(disp, "reads_per_batch", None) or READS_PER_BATCH
    producer_ok = False
    try:
        for r0 in range(0, R_total, rpb):
            r1 = min(r0 + rpb, R_total)
            if cfg.verbose and r0:
                frac = r0 / R_total
                el = _time.perf_counter() - t_start
                print(f"OUT: Progress of current file: {frac * 100.0:.2f} %"
                      f" (ETA: {el / frac - el:.0f}s)", flush=True)
            with timers.stage("fast/assemble"):
                blobs, offs_list, nk = [], [], 0
                line_target = asm.min_line
                for mseq, moff in mate_views:
                    blens = np.diff(moff[r0:r1 + 1])
                    line_target = max(line_target,
                                      int(blens.max()) + asm.marker_len)
                    blobs.append(mseq[moff[r0]:moff[r1]])
                    offs_list.append((moff[r0:r1 + 1] - moff[r0])
                                     .astype(np.int64))
                    nk += int(asm.true_counts(blens).sum())
                maxlen = _len_bucket(line_target, asm.min_line)
                rows_pad = disp.round_rows(_bucket(r1 - r0, 512))
                mat = asm.assemble_multi(blobs, offs_list, maxlen, rows_pad)
            if sin_flush >= COUNT_FLUSH:
                flush_counts()
            with timers.stage("fast/dispatch"):
                w = asm.window_target(maxlen)
                cap = disp.csr_cap(rows_pad)
                ca_b, cu_b, fo = acc_ca, acc_cu, None
                if per_file_counts:
                    # the batch's reads may span files: the kernels count
                    # into the slabs of files f0..f1 (padded rows take f1)
                    f0, f1 = int(file_of(r0)), int(file_of(r1 - 1))
                    fo = np.full(rows_pad, f1 - f0, np.int32)
                    fo[:r1 - r0] = file_of(np.arange(r0, r1)) - f0
                    ca_b, cu_b = acc_ca[f0:f1 + 1], acc_cu[f0:f1 + 1]
                handle, ht_d, hk_d = disp.dispatch(
                    mat, lut, ca_b, cu_b, rows_pad, w, cap, fo, **mode)
                sin_flush += 1
                submit((handle, ht_d, hk_d, r0, r1, nk, mat, w, rows_pad,
                        cap))
        flush_counts()
        producer_ok = True
    finally:
        # always hand the writer its sentinel and join it, so an error
        # never leaks the thread or an open output handle
        work_q.put(None)
        writer_thread.join()
        if not producer_ok:
            handles = ([sg["fh"] for sg in segments]
                       if segments is not None else [fh])
            for h in handles:
                if h is not None:
                    h.close()
    if writer_exc:
        raise writer_exc[0]
    global LAST_FALLBACK
    LAST_FALLBACK = (fallback_reads, R_total)
    if fallback_reads:
        print(f"OUT: turbo host-fallback recomputed {fallback_reads} of "
              f"{R_total} reads "
              f"({100.0 * fallback_reads / max(R_total, 1):.3f} %)",
              flush=True)

    tail = b"\n]" if cfg.output_format == "json" else b""
    for h in ([sg["fh"] for sg in segments] if segments is not None
              else [fh]):
        if h is not None:
            h.write(tail)
            h.close()

    if profile_file:
        out_mod.write_profile(
            profile_file, content.organisms, content.idx_to_tax,
            counts_all, counts_unique, None, freqs,
            num_kmers_in_input, R_total, min_k, max_k, cfg.num_frames,
            coverage=False)

    if cfg.filter and ranker is not None:
        from .pipeline import write_filtered
        write_filtered(cfg, input_path, filtered_ids)

    if cfg.verbose:
        timers.report()

    return counts_all, counts_unique, R_total, num_kmers_in_input
