"""recompute_pct (host recompute): reads recomputed by
host_classify_read over the reads decoded in the window, in %."""


def read(run):
    done = [r for r in run.records if 0 < r.t_done <= run.t_close]
    reads = sum(r.reads for r in done)
    return 100.0 * sum(r.recomputed for r in done) / reads if reads else None
