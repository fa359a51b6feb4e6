"""reads_per_s: reads with final results (decoded, recomputed where
flagged) in the window over the window's seconds; a pair is one read."""


def read(run):
    done = [r.reads for r in run.records if 0 < r.t_done <= run.t_close]
    return sum(done) / run.seconds if done else None
