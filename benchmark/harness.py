"""One cell of the benchmark, driven from its data files.

A run: set-up (the port's kernels built or loaded, the configuration's
index family generated once into ``benchmark/cache/``, the index and its
turbo tables loaded through the port, the reads drawn from the seed and
assembled into a ring of batches in pinned host memory, one pass of the
ring to warm up), then the measured window: one thread dispatches the
ring's batches in turn through ``SingleTurboDispatch.dispatch`` and one
consumer thread takes them from a queue of ``in_flight``, as the port's
drive loop does (fetch, decode with per-read hit lists, the host
recompute of flagged reads, the fold into the profile; the count
accumulators reduced every ``COUNT_FLUSH`` batches and at the end).
After the window every dispatched batch is drained and checked against
the plain reference.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import queue
import sys
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from . import corpus

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
CACHE = os.path.join(BENCH, "cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "kasa_tpu")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is
    JAX's or the JAX package's, compared whole: kasa_tpu_torch passes."""
    names = modules if modules is not None else list(sys.modules)
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)


def _json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell `name` of BENCHMARK.json with its files: configs/<config>.json,
    traffic/<traffic>.json, limits/<cell>.json, and the metrics it
    reports (an entry without "workloads" is reported by every cell)."""
    man = _json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    w = cells[name]
    conf = next(c for c in man["configs"] if c["name"] == w["config"])

    def mine(m):
        return name in m.get("workloads", [name])
    return Cell(name, int(w["chips"]), _json(os.path.join(root, conf["file"])),
                _json(os.path.join(BENCH, "traffic", w["traffic"] + ".json")),
                _json(os.path.join(BENCH, "limits", name + ".json")),
                [m for m in man["end_to_end"] if mine(m)],
                [m for m in man["per_layer"] if mine(m)])


def metric_reader(name: str):
    """The read(run) function of metrics/<name>.py."""
    path = os.path.join(BENCH, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Batch:
    """One batch of the ring, assembled as the drive loop assembles it."""
    idx: int
    mates: list             # per mate (blob, offs): the reads as drawn
    mat: np.ndarray         # (rows_pad * lpr, maxlen) uint8, pinned on a card
    reads: int
    rows_pad: int
    w: int
    cap: int
    sample: np.ndarray      # rows whose answers are compared


@dataclass
class Record:
    """One dispatched batch: its host clock (perf_counter seconds) and
    counts."""
    ring: int
    reads: int
    t_dispatch0: float = 0.0
    t_dispatch1: float = 0.0
    t_queued: float = 0.0
    t_fetch0: float = 0.0
    t_fetched: float = 0.0
    t_decoded: float = 0.0
    t_done: float = 0.0
    recomputed: int = 0
    hits: int = 0


@dataclass
class Window:
    """What a measured window leaves: the records of every dispatched
    batch, the sampled answers, the folded profile."""
    t0: float
    t_close: float
    seconds: float
    records: list
    answers: list           # (ring, row, hit taxa, hit scores)
    counts_all: np.ndarray
    counts_unique: np.ndarray
    flushes: list = field(default_factory=list)   # (t0, t1) of each flush


class Session:
    """The port loaded for one cell: set-up once, then rings and windows."""

    def __init__(self, cell: Cell, device, log, cache: str = CACHE):
        self.cell = cell
        self.cfg, self.traffic = cell.config, cell.traffic
        self.device = torch.device(device)
        self.log = log
        self.cache = cache
        self.parts: dict = {}

    def _part(self, name, fn, *a, **kw):
        t = time.perf_counter()
        out = fn(*a, **kw)
        dt = time.perf_counter() - t
        self.parts[name] = self.parts.get(name, 0.0) + dt
        self.log(f"set-up {name}: {dt:.3f} s")
        return out

    def build(self):
        """The port's kernels and host library, built on the first run
        of a checkout into kasa_tpu_torch/_build."""
        from kasa_tpu_torch import kernels
        from kasa_tpu_torch.native import get_lib
        if self.device.type == "cuda":
            self._part("build", kernels.build_all)
        self._part("build", get_lib)

    def prepare_index(self) -> str:
        d = os.path.join(self.cache, self.cfg["name"])
        self.index_path = self._part(
            "generate", corpus.ensure_index, self.cfg, d, self.device,
            self.log)
        gpath = os.path.join(d, "genomes.npy")
        if not os.path.exists(gpath):
            np.save(gpath + ".tmp.npy", corpus.genomes(self.cfg))
            os.replace(gpath + ".tmp.npy", gpath)
        self.genomes = np.load(gpath)
        return self.index_path

    def load(self):
        """The index and its turbo tables through the port (the first
        run builds the tables on the host and writes the .tabs sidecar
        beside the index)."""
        from kasa_tpu_torch.config import Config
        from kasa_tpu_torch.core.alphabet import build_codon_code_lut
        from kasa_tpu_torch.match.fast import (BatchAssembler,
                                               SingleTurboDispatch)
        from kasa_tpu_torch.match.pipeline import _load_index
        from kasa_tpu_torch.match.turbo import load_or_build_turbo
        pcfg = Config()
        pcfg.lower_k, pcfg.higher_k = self.cfg["k_low"], self.cfg["k_high"]
        limbs, _, highest_k, content, _, tax_rows = self._part(
            "load_index", _load_index, pcfg, self.index_path)
        self.num_k = pcfg.higher_k - pcfg.lower_k + 1
        self.S = content.num_species
        tabs = self.index_path + f".turbo_{pcfg.lower_k}_{pcfg.higher_k}.npz.tabs"
        part = "load_tables" if os.path.isdir(tabs) else "build_tables"
        self.tt = self._part(part, load_or_build_turbo, self.index_path,
                             limbs, tax_rows, highest_k, pcfg.lower_k,
                             pcfg.higher_k, self.S, self.device)
        if self.tt.host_limbs.shape[1] == 2:
            # the host recompute's key array, built at its first use
            self._part("load_tables", self.tt.host_key64)
        self.disp = SingleTurboDispatch(self.tt, self.num_k, self.S)
        self.asm = BatchAssembler(highest_k, pcfg.lower_k, False,
                                  self.traffic["six"], False)
        self.lpr = (2 if self.asm.six else 1) \
            * (2 if self.traffic["paired"] else 1)
        self.lut_np = np.asarray(build_codon_code_lut(), np.int32)
        self.lut = torch.from_numpy(self.lut_np).to(self.device)
        self.mode = dict(protein=False, one_frame=False,
                         lines_per_read=self.lpr,
                         unique=self.traffic["unique"])

    def tables_bytes(self) -> int:
        from kasa_tpu_torch.match.turbo import DEVICE_FIELDS
        return sum(getattr(self.tt, f).numel()
                   * getattr(self.tt, f).element_size()
                   for f in DEVICE_FIELDS)

    def draw(self, seed: int) -> list:
        """The seed's reads, drawn on the device (before the tables are
        loaded: the draw's memory is freed, and the peak that the run
        reports starts after it)."""
        gen_t = torch.from_numpy(self.genomes).to(self.device)
        ring = self._part("draw", corpus.draw_ring, self.traffic, gen_t,
                          seed)
        del gen_t
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return ring

    def assemble(self, ring: list, seed: int) -> list:
        return self._part("assemble", self._assemble, ring, seed)

    def _assemble(self, ring: list, seed: int) -> list:
        """Each batch as _fast_identify_turbo assembles it; the rows to
        compare drawn from the seed, with the longest read of the ring."""
        from kasa_tpu_torch.match.fast import _bucket, _len_bucket
        rng = np.random.default_rng([int(seed) % (1 << 63), 17])
        longest = max(((int(sum(np.diff(o).max() for _, o in mates)), b)
                       for b, mates in enumerate(ring)))[1]
        out = []
        for b, mates in enumerate(ring):
            rb = len(mates[0][1]) - 1
            line_target = self.asm.min_line
            for blob, offs in mates:
                line_target = max(line_target, int(np.diff(offs).max())
                                  + self.asm.marker_len)
            maxlen = _len_bucket(line_target, self.asm.min_line)
            rows_pad = self.disp.round_rows(_bucket(rb, 512))
            mat = self.asm.assemble_multi([m[0] for m in mates],
                                          [m[1] for m in mates], maxlen,
                                          rows_pad)
            if self.device.type == "cuda":
                pinned = torch.empty(mat.shape, dtype=torch.uint8,
                                     pin_memory=True)
                pinned.numpy()[...] = mat
                mat = pinned.numpy()
            k = min(self.traffic["sample_per_batch"], rb)
            sample = rng.choice(rb, size=k, replace=False)
            if b == longest:
                lens = sum(np.diff(o) for _, o in mates)
                sample = np.union1d(sample, [int(np.argmax(lens))])
            out.append(Batch(b, mates, mat, rb, rows_pad,
                             self.asm.window_target(maxlen),
                             self.disp.csr_cap(rows_pad), np.sort(sample)))
        return out

    def window(self, batches: list, seconds: float | None = None,
               count: int | None = None) -> Window:
        """Dispatch the ring in turn for `seconds` (or `count` batches),
        then drain: every dispatched batch is decoded, recomputed where
        flagged and folded."""
        from kasa_tpu_torch.match.turbo import (COUNT_FLUSH,
                                                dedup_windows_np,
                                                host_classify_read,
                                                read_windows_np)
        disp, tt, asm = self.disp, self.tt, self.asm
        num_k, S, lpr = self.num_k, self.S, self.lpr
        unique = self.traffic["unique"]
        counts_all = np.zeros((num_k, S), np.float64)
        counts_unique = np.zeros((num_k, S), np.int64)
        records, answers, errors, flushes = [], [], [], []
        work_q: queue.Queue = queue.Queue(maxsize=self.traffic["in_flight"])

        def consume(item):
            rec, bt, handle, ht_d, hk_d = item
            rec.t_fetch0 = time.perf_counter()
            packed = disp.fetch(handle)[0]
            rec.t_fetched = time.perf_counter()
            hc, ofc, ofl, nflag, ht, hk = disp.decode(
                packed, bt.rows_pad, bt.reads, bt.cap, True, ht_d, hk_d)
            rec.t_decoded = time.perf_counter()
            # a per-read output needs every truncated list rebuilt (ofl
            # holds ofc), as the drive loop's consume with a ranker
            if nflag and ofl.any():
                rows = np.nonzero(ofl)[0]
                rec.recomputed = len(rows)
                fixes, wmax = {}, ht.shape[1]
                for r in rows:
                    q = read_windows_np(bt.mat[r * lpr:(r + 1) * lpr],
                                        self.lut_np, asm.highest_k, False,
                                        False, bt.w)
                    if unique:
                        q = dedup_windows_np(q)
                    scores, ca2, cu2 = host_classify_read(tt, q)
                    if ofc[r]:
                        counts_all[:] += ca2
                        counts_unique[:] += cu2
                    items = sorted((int(t), float(v))
                                   for t, v in scores.items() if v > 0.0)
                    fixes[int(r)] = items
                    wmax = max(wmax, len(items))
                if wmax > ht.shape[1]:
                    ht2 = np.zeros((bt.reads, wmax), np.int32)
                    hk2 = np.zeros((bt.reads, wmax), np.float32)
                    ht2[:, :ht.shape[1]] = ht
                    hk2[:, :ht.shape[1]] = hk
                    ht, hk = ht2, hk2
                for r, items in fixes.items():
                    hc[r] = len(items)
                    for i, (t, v) in enumerate(items):
                        ht[r, i] = t
                        hk[r, i] = v
            rec.hits = int(hc.sum())
            for r in bt.sample:
                n = int(hc[r])
                answers.append((bt.idx, int(r), ht[r, :n].copy(),
                                hk[r, :n].copy()))
            rec.t_done = time.perf_counter()

        def consumer():
            while True:
                item = work_q.get()
                try:
                    if item is None:
                        return
                    if not errors:
                        consume(item)
                except BaseException as e:     # raised by the producer
                    errors.append(e)
                finally:
                    work_q.task_done()

        acc_ca, acc_cu = disp.new_acc()

        def flush():
            t = time.perf_counter()
            work_q.join()
            if errors:
                raise errors[0]
            ca, cu = disp.reduce_acc(acc_ca, acc_cu)
            counts_all[:] += ca
            counts_unique[:] += cu
            flushes.append((t, time.perf_counter()))

        thread = threading.Thread(target=consumer, daemon=True)
        thread.start()
        since_flush, i = 0, 0
        t0 = time.perf_counter()
        t_close = t0 + seconds if seconds is not None else None
        try:
            while (time.perf_counter() < t_close if seconds is not None
                   else i < count):
                if since_flush >= COUNT_FLUSH:
                    flush()
                    since_flush = 0
                bt = batches[i % len(batches)]
                rec = Record(bt.idx, bt.reads)
                rec.t_dispatch0 = time.perf_counter()
                handle, ht_d, hk_d = disp.dispatch(
                    bt.mat, self.lut, acc_ca, acc_cu, bt.rows_pad, bt.w,
                    bt.cap, None, **self.mode)
                rec.t_dispatch1 = time.perf_counter()
                records.append(rec)
                if errors:
                    raise errors[0]
                work_q.put((rec, bt, handle, ht_d, hk_d))
                rec.t_queued = time.perf_counter()
                since_flush += 1
                i += 1
            if t_close is None:
                t_close = time.perf_counter()
            flush()
        finally:
            work_q.put(None)
            thread.join()
        if errors:
            raise errors[0]
        return Window(t0, t_close, t_close - t0, records, answers,
                      counts_all, counts_unique, flushes)

    def free(self):
        """Drop the port's device state (before the reference runs),
        with the tables that the port's process cache holds."""
        from kasa_tpu_torch.match import turbo
        for name in ("disp", "tt", "lut"):
            if hasattr(self, name):
                delattr(self, name)
        turbo._TT_RAM_CACHE.clear()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
