"""decode_ms (batch API): host ms a batch in decode, the host recompute
and the fold, after fetch's wait, mean over the batches completed in
the window; a span of the benchmark."""


def read(run):
    d = [r.t_done - r.t_fetched for r in run.records
         if 0 < r.t_done <= run.t_close]
    return 1e3 * sum(d) / len(d) if d else None
