"""One run of a cell: set-up, the measured window, the drain, the
reference check, the metrics -> the result's line."""

from __future__ import annotations

import json
import os
import sys
import time
from types import SimpleNamespace

import torch

from . import compare, harness


def peaks() -> dict:
    with open(os.path.join(harness.BENCH, "peaks.json")) as fh:
        return json.load(fh)


def least_bytes(batches: list, win, sectors: dict, num_k: int,
                S: int) -> float:
    """The least bytes of every dispatched batch's step: its input
    matrix, one int32 hit count and an (int32, float32) pair a hit read
    back, the (numK, S) f32 and int32 count slabs written once, and the
    distinct 32-byte sectors of the index keys that its windows' matches
    land on and of the taxa of the groups they match at every k
    (computed by the reference from the inputs)."""
    total = 0.0
    for rec in win.records:
        bt = batches[rec.ring]
        total += (bt.mat.nbytes + 4 * bt.reads + 8 * rec.hits
                  + 8 * num_k * S + 32 * sectors[rec.ring])
    return total


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, log=None, session=None, control=False):
    """-> (result dict, check lines).  `session` lets a caller pass a
    Session it has built and prepared (tests, calibrate.py); by default
    this sets one up.  `control` adds the control's numbers over the
    same window under the result's "control" (calibrate.py)."""
    log = log or (lambda m: print(m, file=sys.stderr, flush=True))
    dev = torch.device(device)
    sess = session or harness.Session(cell, dev, log)
    if session is None:
        sess.build()
        sess.prepare_index()
    ring = sess.draw(seed)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    if session is None or not hasattr(sess, "disp"):
        sess.load()
    batches = sess.assemble(ring, seed)
    del ring
    # warm-up: warm_batches batches (at least one pass of the ring)
    # through the whole path, so the window starts in the steady state
    sess._part("warm", sess.window, batches, None,
               max(len(batches), cell.traffic["warm_batches"]))
    tracer = None
    if trace:
        from . import devtrace
        tracer = devtrace.Tracer()
        tracer.start()
    setup_s = time.perf_counter() - t_start
    win = sess.window(batches, seconds=seconds)
    if tracer is not None:
        tracer.stop()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    tables = sess.tables_bytes()
    num_k, S = sess.num_k, sess.S
    sess.free()
    tr = None
    if tracer is not None:
        from . import devtrace
        tr = devtrace.reduce(tracer, win)
        del tracer
    t = time.perf_counter()
    ref = compare.Reference(sess.index_path, sess.cfg, sess.traffic,
                            batches, dev)
    numbers, sectors = compare.check_window(ref, win, want_sectors=trace)
    ctl = (compare.control(ref, [r.ring for r in win.records])
           if control else None)
    del ref
    check_s = time.perf_counter() - t
    correct = compare.verdict(numbers, cell.limits)
    run = SimpleNamespace(
        seconds=win.seconds, t0=win.t0, t_close=win.t_close,
        records=win.records, setup_s=setup_s, peak_bytes=peak,
        tables_bytes=tables, trace=tr, peak=peaks(),
        least_bytes=(least_bytes(batches, win, sectors, num_k, S)
                     if trace else None))
    specs = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in specs:
        v = harness.metric_reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    done = [r for r in win.records if r.t_done]
    log(f"run {cell.name} seed {seed}: {len(win.records)} batches "
        f"dispatched, {sum(r.reads for r in done)} reads decoded, "
        f"{sum(r.recomputed for r in done)} recomputed; set-up "
        f"parts {json.dumps({k: round(v, 3) for k, v in sess.parts.items()})}; "
        f"check {check_s:.1f} s")
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct),
              "attempted": int(sum(r.reads for r in win.records)),
              "failed": int(sum(r.reads for r in win.records
                                if not r.t_done)),
              "metrics": metrics, "device": device_info}
    if tr is not None:
        device_info["busy_s"] = tr.busy_s
        device_info["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.device_ops,
                               "idle_gaps": tr.idle_gaps}
        log(f"trace: {tr.ops} device operations, {tr.device_s:.6f} s of "
            f"device time for {tr.batches} batches; clocks aligned on "
            f"{100 * tr.aligned:.1f} % of dispatches")
    if ctl is not None:
        result["control"] = ctl
    result["checked"] = {k: {"value": numbers[k], "limit": cell.limits[k]}
                         for k in compare.NAMES}
    return result, compare.lines(numbers, cell.limits)
