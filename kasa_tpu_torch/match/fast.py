"""Throughput identify pipeline (port of kasa_tpu/match/fast.py, turbo
strategy only).

native file parse -> vectorized padded read matrix -> one turbo batch
step on the device per batch (match/turbo.py fused_turbo_acc: four
CUDA kernels) -> packed readback decode -> exact host recompute of
flagged reads -> native rank+format -> file.  A writer thread consumes
finished batches in order, so host post-processing of batch i overlaps
device work of batch i+1; the per-taxon count matrices accumulate on
the device and are flushed every COUNT_FLUSH batches.

Reads are laid out as a (rows, maxlen) uint8 matrix padded with 'X'.
The false-k-mer marker is 'X' too (Read.hpp:1068-1078), so a row is the
read followed by 'X' up to maxlen; the W = maxlen - 3*highestK + 1
windows per row over-count, but every window past the read's true
count has a '^' letter at a checked position and contributes nothing.
"""

from __future__ import annotations

import os
import queue as _queue
import threading as _threading
import time as _time

import numpy as np
import torch

from ..host import fastx
from ..utils import timers
from .turbo import COUNT_FLUSH, CSR_CAP_FACTOR, EXP_BUDGET, MULTI_BUDGET

READS_PER_BATCH = 8192
MAXLEN_CAP = 8192

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
    """Vectorized ragged -> padded matrix assembly (host, numpy), for
    single-end DNA in three frames."""

    def __init__(self, highest_k: int, min_k: int):
        self.highest_k = highest_k
        self.padc = ord("X")
        self.marker_len = (highest_k - min_k) * 3

    def window_target(self, maxlen: int) -> int:
        """Uniform windows per line for a padded line of `maxlen`."""
        return maxlen - 3 * self.highest_k + 1

    def true_counts(self, lens: np.ndarray) -> np.ndarray:
        """calculatekMerCount per line (line = read + marker)."""
        ll = lens + self.marker_len
        return np.where(ll > 3 * self.highest_k + 1,
                        ll - 3 * self.highest_k + 1, 0)

    def assemble(self, blob: np.ndarray, offs: np.ndarray, maxlen: int,
                 rows_pad: int) -> np.ndarray:
        """blob: sanitized bytes; offs: (R+1,) read offsets.  Returns
        (rows_pad, maxlen) uint8, 'X'-padded."""
        out = np.full((rows_pad, maxlen), self.padc, np.uint8)
        R = len(offs) - 1
        lens = np.diff(offs)
        src = np.arange(len(blob), dtype=np.int64)
        rid = np.repeat(np.arange(R, dtype=np.int64), lens)
        within = src - offs[rid]
        out.reshape(-1)[rid * maxlen + within] = blob[src]
        return out


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


class SingleTurboDispatch:
    """Single-device dispatch/decode strategy for the turbo drive loop.

    The multi worklist and expansion budgets are plain runtime sizes
    (kasa_tpu freezes them per run because each value is a compiled
    shape), and the kernels' scratch comes from PyTorch's caching
    allocator."""

    def __init__(self, tt, num_k: int, num_species: int):
        self.tt = tt
        self.device = tt.device
        self._acc_shape = (num_k, num_species)
        self.multi_budget = MULTI_BUDGET
        self.exp_budget = EXP_BUDGET

    def new_acc(self):
        return (torch.zeros(self._acc_shape, dtype=torch.float32,
                            device=self.device),
                torch.zeros(self._acc_shape, dtype=torch.int32,
                            device=self.device))

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

    def dispatch(self, mat: np.ndarray, lut, acc_ca, acc_cu, rows_pad: int,
                 w: int, cap: int):
        """Queue one batch.  Returns (packed handle, ht, hk): on a CUDA
        device the packed readback is copied into pinned host memory
        behind the batch's kernels and an event marks its arrival."""
        from .turbo import fused_turbo_acc
        dev = self.device
        mat_d = torch.from_numpy(mat).to(dev)
        packed, ht, hk = fused_turbo_acc(
            self.tt, mat_d, lut, acc_ca, acc_cu, rows_pad, w, cap,
            self.multi_budget, self.exp_budget)
        if dev.type != "cuda":
            return (packed, None), ht, hk
        host = torch.empty(packed.shape, dtype=packed.dtype,
                           pin_memory=True)
        host.copy_(packed, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return (host, done), ht, hk

    def fetch(self, handle) -> np.ndarray:
        """Host view of a batch's packed readback (waits for its batch
        only)."""
        packed, done = handle
        if done is not None:
            done.synchronize()
        return packed.numpy()

    def decode(self, packed: np.ndarray, rows_pad: int, rb: int,
               cap: int, want_lists: bool, ht_d=None, hk_d=None):
        from .tiered import SingleTurboDispatch_decode
        return SingleTurboDispatch_decode(packed, rows_pad, rb, cap,
                                          want_lists, ht_d, hk_d)


def select_turbo_dispatch(cfg, index_path, limbs, taxids, content,
                          highest_k, tax_rows, device: torch.device):
    """The resident turbo strategy for this index on `device`.  Indices
    that need another strategy (too large for the device, more than six
    k levels, min_k*5 < 24, ...) raise NotImplementedError: the tiered
    path, the mesh and the classic engine are later slices."""
    from .turbo import turbo_supported, load_or_build_turbo
    min_k, max_k = cfg.lower_k, cfg.higher_k
    num_k = max_k - min_k + 1
    S = content.num_species
    num_limbs = limbs.shape[1] if len(taxids) else 2
    if not turbo_supported(len(taxids), num_limbs, min_k, max_k, S):
        raise NotImplementedError(
            "this index/k range needs the classic engine (turbo tables "
            "need n > 0, <= 6 k levels and min_k >= 5), a later slice of "
            "the port")
    budget = device_table_budget(cfg, device)
    table_bytes = bytes_per_entry_resident(num_k, num_limbs) \
        * max(len(taxids), 1)
    if not cfg.ram and table_bytes > budget:
        raise NotImplementedError(
            f"turbo tables ({table_bytes >> 20} MiB) exceed the device "
            f"budget ({budget >> 20} MiB): the tiered streaming path is a "
            "later slice of the port")
    try:
        content_token = os.stat(cfg.content_file
                                or index_path + "_content.txt").st_mtime_ns
    except OSError:
        content_token = None
    with timers.stage("turbo/tables"):
        tt = load_or_build_turbo(index_path, limbs, tax_rows, highest_k,
                                 min_k, max_k, S, device, content_token)
    return SingleTurboDispatch(tt, num_k, S)


def fast_identify(cfg, index_path: str, input_path: str,
                  out_file: str | None, profile_file: str | None,
                  content, freqs, limbs, taxids, highest_k: int,
                  tax_rows, device: torch.device):
    """Drive the turbo pipeline over one single-end input file.  Returns
    (counts_all, counts_unique, reads, k-mers in input)."""
    from ..native import get_lib, load_fastx, sanitize_inplace
    from .turbo import check_slot_cap

    min_k, max_k = cfg.lower_k, cfg.higher_k
    num_k = max_k - min_k + 1
    if get_lib() is None:
        raise RuntimeError("the native host library (g++ and zlib) is "
                           "unavailable")
    fmt = fastx.sniff_format(input_path)
    with timers.stage("fast/parse"):
        parsed = load_fastx(input_path, fmt == "fastq")
    if parsed is None:
        raise RuntimeError(f"could not parse {input_path}")
    seq, seq_off, name_blob, name_off, nlines = parsed
    R_total = len(seq_off) - 1
    lens = np.diff(seq_off)
    if R_total == 0:
        raise NotImplementedError("an empty input is a later slice of the "
                                  "port (kasa_tpu runs its parity engine)")
    maxraw = int(lens.max())
    asm = BatchAssembler(highest_k, min_k)
    if maxraw > MAXLEN_CAP:
        raise NotImplementedError("reads above MAXLEN_CAP need the chunked "
                                  "pipeline, a later slice of the port")
    # before any output is written: no batch's bucket is longer
    check_slot_cap(asm.window_target(
        (max(maxraw + asm.marker_len, 3 * highest_k) + 15) // 16 * 16),
        num_k)
    if np.any((seq == ord(" ")) | (seq == ord("\t"))):
        raise RuntimeError("Spaces or tabs inside read, "
                           "please check your input.")
    sanitize_inplace(seq, False)
    # report lengths follow the reference's char counter (raw chars +
    # one newline per sequence line)
    rep_lens = (lens + nlines[:R_total]).astype(np.uint32)

    disp = select_turbo_dispatch(cfg, index_path, limbs, taxids, content,
                                 highest_k, tax_rows, device)
    global LAST_DISPATCH
    LAST_DISPATCH = disp
    return _fast_identify_turbo(
        cfg, disp, asm, (seq, seq_off), name_blob, name_off, rep_lens,
        R_total, out_file, profile_file, content, freqs, highest_k)


def _fast_identify_turbo(cfg, disp, asm, mate_view, name_blob, name_off,
                         rep_lens, R_total, out_file, profile_file, content,
                         freqs, highest_k):
    """Turbo drive loop (kasa_tpu fast.py:953): batches go to the
    device in order; ONE writer thread fetches, decodes, recomputes
    flagged reads on the host, ranks and writes, in FIFO order."""
    from ..core.alphabet import build_codon_code_lut
    from ..host import output as out_mod
    from ..native import NativeRanker
    from .turbo import host_classify_read, read_windows_np

    tt = disp.tt
    min_k, max_k = cfg.lower_k, cfg.higher_k
    num_k = max_k - min_k + 1
    S = content.num_species
    lut_np = np.asarray(build_codon_code_lut(), dtype=np.int32)
    lut = torch.from_numpy(lut_np).to(disp.device)

    ranker = None
    if out_file:
        ranker = NativeRanker(
            content.idx_to_tax, content.organisms, freqs[:, 0],
            min_k, max_k, highest_k, False, cfg.num_frames,
            cfg.threshold, cfg.num_of_beasts, cfg.output_format)
        if not ranker.ok:
            raise RuntimeError("the native ranker is unavailable")

    counts_all = np.zeros((num_k, S), dtype=np.float64)
    counts_unique = np.zeros((num_k, S), dtype=np.uint64)
    num_kmers_in_input = 0
    fallback_reads = 0

    hdr = (b"[\n" if cfg.output_format == "json" else
           b"#Read number\tSpecifier from input file\tMatched "
           b"taxa\tNames\tScores{relative,k-mer}\tError\n"
           if cfg.output_format == "tsv" else b"")
    fh = None
    if out_file:
        fh = open(out_file, "wb")
        if hdr:
            fh.write(hdr)

    seq, seq_off = mate_view

    def consume(item):
        nonlocal num_kmers_in_input, fallback_reads
        handle, ht_d, hk_d, r0, r1, nk, mat, w, rows_pad, cap = item
        rb = r1 - r0
        num_kmers_in_input += int(nk)
        with timers.stage("fast/fetch"):
            packed = disp.fetch(handle)
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
                    q = read_windows_np(mat[r:r + 1], lut_np, highest_k, w)
                    scores, ca2, cu2 = host_classify_read(tt, q)
                    if ofc[r]:
                        counts_all[:] += ca2
                        counts_unique[:] += cu2.astype(np.uint64)
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
        if ranker is not None:
            with timers.stage("fast/rank+write"):
                names = [name_blob[name_off[i]:name_off[i + 1]]
                         .tobytes().decode("latin-1") + " "
                         for i in range(r0, r1)]
                text, _flags = ranker.format_sparse(
                    ht, hk, hc, names, rep_lens[r0:r1], r0)
                fh.write(text)

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
    acc_ca, acc_cu = disp.new_acc()
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
    rpb = READS_PER_BATCH
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
                blens = np.diff(seq_off[r0:r1 + 1])
                line_target = max(3 * highest_k,
                                  int(blens.max()) + asm.marker_len)
                maxlen = _len_bucket(line_target, 3 * highest_k)
                rows_pad = _bucket(r1 - r0, 512)
                blob = seq[seq_off[r0]:seq_off[r1]]
                offs = (seq_off[r0:r1 + 1] - seq_off[r0]).astype(np.int64)
                mat = asm.assemble(blob, offs, maxlen, rows_pad)
                nk = int(asm.true_counts(blens).sum())
            if sin_flush >= COUNT_FLUSH:
                flush_counts()
            with timers.stage("fast/dispatch"):
                w = asm.window_target(maxlen)
                cap = disp.csr_cap(rows_pad)
                handle, ht_d, hk_d = disp.dispatch(mat, lut, acc_ca, acc_cu,
                                                   rows_pad, w, cap)
                sin_flush += 1
                submit((handle, ht_d, hk_d, r0, r1, nk, mat, w, rows_pad,
                        cap))
        flush_counts()
        producer_ok = True
    finally:
        # always hand the writer its sentinel and join it, so an error
        # never leaks the thread or the open output handle
        work_q.put(None)
        writer_thread.join()
        if not producer_ok and fh is not None:
            fh.close()
    if writer_exc:
        raise writer_exc[0]
    global LAST_FALLBACK
    LAST_FALLBACK = (fallback_reads, R_total)
    if fallback_reads:
        print(f"OUT: turbo host-fallback recomputed {fallback_reads} of "
              f"{R_total} reads "
              f"({100.0 * fallback_reads / max(R_total, 1):.3f} %)",
              flush=True)

    if fh is not None:
        if cfg.output_format == "json":
            fh.write(b"\n]")
        fh.close()

    if profile_file:
        out_mod.write_profile(
            profile_file, content.organisms, content.idx_to_tax,
            counts_all, counts_unique, None, freqs,
            num_kmers_in_input, R_total, min_k, max_k, cfg.num_frames,
            coverage=False)

    if cfg.verbose:
        timers.report()

    return counts_all, counts_unique, R_total, num_kmers_in_input
