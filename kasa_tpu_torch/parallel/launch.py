"""Run the CLI, or any function, on N ranks of one host from Python (the
tests and chip_smoke.py; from a shell, torchrun does the same).

Each rank is a process of its own (torch.multiprocessing, start method
spawn) with torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK,
LOCAL_WORLD_SIZE) and a file:// rendezvous in the run's directory, so
concurrent runs never share a port.  A rank joins the process group
(dist.init_distributed), calls its target, and leaves a record of its
result, its kernel launch counts (kernels.COUNTS) and its host stage
timers in rank<r>.pt, its stdout and stderr in rank<r>.log.  On one
card, N ranks share it over gloo (dist.backend_for).
"""

from __future__ import annotations

import contextlib
import importlib
import os
import tempfile
import time


def _rank_main(rank: int, world: int, target: str, args: tuple, env: dict,
               out_dir: str, device, threads: int | None):
    os.environ.update(env)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      KASA_DIST_INIT="file://" + os.path.join(out_dir,
                                                             "rendezvous"))
    import torch
    if threads:
        torch.set_num_threads(threads)
    from .. import kernels
    from ..utils import timers
    from . import dist
    mod, fn = target.split(":")
    with open(os.path.join(out_dir, f"rank{rank}.log"), "w") as log, \
            contextlib.redirect_stdout(log), contextlib.redirect_stderr(log):
        dist.init_distributed(device)
        try:
            result = getattr(importlib.import_module(mod), fn)(*args)
        finally:
            dist.shutdown()
    torch.save({"result": result, "counts": dict(kernels.COUNTS),
                "timers": dict(timers._ACC),
                "timer_counts": dict(timers._COUNT)},
               os.path.join(out_dir, f"rank{rank}.pt"))


def run_ranks(world: int, target: str, args: tuple = (),
              env: dict | None = None, out_dir: str | None = None,
              device=None, threads: int | None = None,
              timeout: float = 1800.0) -> list:
    """Call `target` ("module:function") with *args on `world` ranks of
    this host; their group's device is `device` (None = cuda).  Returns
    each rank's record ({"result", "counts", "timers", "timer_counts",
    "log"}), rank 0 first.  A rank that raises ends every rank, and
    this raises; so do ranks still running after `timeout` seconds
    (a collective that never completes), which are killed."""
    import torch
    import torch.multiprocessing as mp
    out_dir = out_dir or tempfile.mkdtemp(prefix="kasa_ranks_")
    os.makedirs(out_dir, exist_ok=True)
    rdv = os.path.join(out_dir, "rendezvous")
    if os.path.exists(rdv):
        os.remove(rdv)
    ctx = mp.start_processes(
        _rank_main, args=(world, target, tuple(args), dict(env or {}),
                          out_dir, device, threads),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
            raise TimeoutError(f"{target}: {world} ranks still running "
                               f"after {timeout} s (logs in {out_dir})")
    recs = []
    for r in range(world):
        rec = torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                         weights_only=False)
        rec["log"] = os.path.join(out_dir, f"rank{r}.log")
        recs.append(rec)
    return recs


def run_cli(world: int, cli_args: list, env: dict | None = None,
            out_dir: str | None = None, threads: int | None = None,
            timeout: float = 1800.0) -> list:
    """The CLI (kasa_tpu_torch <mode> ...) on `world` ranks; every
    rank's record as run_ranks gives it, "result" the CLI's exit code."""
    device = None
    if "--device" in cli_args:
        device = cli_args[cli_args.index("--device") + 1]
    return run_ranks(world, "kasa_tpu_torch.cli:main",
                     (["kasa_tpu_torch", *cli_args],), env, out_dir, device,
                     threads, timeout)
