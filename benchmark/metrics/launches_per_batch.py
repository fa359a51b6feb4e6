"""launches_per_batch (batch step): kernel-wrapper calls a batch (the
counter launches of the span dispatch.step, from kernels.COUNTS), mean
over the steps that ended in the window; the port's own recorder."""

from benchmark import spans


def read(run):
    steps = spans.window(run, "dispatch.step")
    if not steps:
        return None
    return sum(spans.count(s, "launches") for s in steps) / len(steps)
