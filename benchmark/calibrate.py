"""The readings that a cell's limits are set from, in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 1,2,3 --seconds <s>

For each seed: one run of the cell as benchmark/run.py makes it
(runner.run_cell, on a Session set up once), and the check's numbers of
the program (the lower readings).  For each control seed also the
control's: the reference put in the program's place over the same
batches, its scores and profile summed in bfloat16, the precision below
the float32 that the configuration states (the upper readings).  One
JSON line each.  The benchmark's runs never run the control.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path[:] = [ROOT] + [p for p in sys.path
                            if os.path.abspath(p or ".") != HERE]
    import torch
    from benchmark import harness, runner
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    torch.set_num_threads(4)
    cell = harness.load_cell(args.workload, ROOT)

    def log(m):
        print(m, file=sys.stderr, flush=True)
    sess = harness.Session(cell, "cuda", log)
    sess.build()
    sess.prepare_index()
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        result, _ = runner.run_cell(cell, seed, args.seconds, False, "cuda",
                                    time.perf_counter(), log, session=sess,
                                    control=seed in controls)
        numbers = {k: v["value"] for k, v in result["checked"].items()}
        print(json.dumps(dict(kind="program", seed=seed,
                              correct=result["correct"],
                              metrics=result["metrics"], **numbers)),
              flush=True)
        if "control" in result:
            print(json.dumps(dict(kind="control", seed=seed,
                                  **result["control"])), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
