"""device_idle_pct (device): share of the window in which no kernel,
copy or set ran on the card (union of the profiler's device events)."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
