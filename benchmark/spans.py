"""The port's recorder (kasa_tpu_torch.utils.timers) as the per-layer
metrics read it: spans and their counters, kept while the traced run's
profiler was on.  Every function gives None where the port has no
recorder or recorded nothing, so a metric stays out of the line."""


def _finished():
    from kasa_tpu_torch.utils import timers
    return getattr(timers, "finished", None)


def window(run, name: str):
    """The spans named `name` that ended inside the window
    [run.t0, run.t_close] (perf_counter seconds, the clock of
    run.records), or None."""
    finished = _finished()
    if finished is None:
        return None
    return finished(name, run.t0, run.t_close) or None


def kept(name: str) -> list:
    """Every kept span named `name`, wherever it ended."""
    finished = _finished()
    return finished(name) if finished is not None else []


def count(span, name: str) -> int:
    """The counter `name` added while `span` was the innermost one."""
    return (span.counts or {}).get(name, 0)


def mean_ms(spans):
    """Mean duration in ms, or None."""
    if not spans:
        return None
    return sum(s.t1 - s.t0 for s in spans) / len(spans) / 1e6
