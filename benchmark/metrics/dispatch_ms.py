"""dispatch_ms (batch API): host ms a batch inside
SingleTurboDispatch.dispatch (the matrix's H2D copy, the launches, the
asynchronous readback), mean over the window's dispatches; a span of
the benchmark around the call."""


def read(run):
    d = [r.t_dispatch1 - r.t_dispatch0 for r in run.records
         if r.t_dispatch0 < run.t_close]
    return 1e3 * sum(d) / len(d) if d else None
