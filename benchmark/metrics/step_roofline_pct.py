"""step_roofline_pct (batch step): the least bytes of the traced
batches' steps (runner.least_bytes: inputs, answers read back, count
slabs, the distinct 32-byte key sectors that the matches land on) at
the card's peak bandwidth, over their device time, in %."""


def read(run):
    t = run.trace
    if t is None or t.device_s <= 0 or not run.least_bytes:
        return None
    return 100.0 * run.least_bytes / run.peak["hbm_bytes_per_s"] / t.device_s
