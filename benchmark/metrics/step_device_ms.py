"""step_device_ms (batch step): device ms a batch, every kernel, copy
and set of the traced run (torch.profiler) over the batches it holds."""


def read(run):
    t = run.trace
    if t is None or t.device_s <= 0 or not t.batches:
        return None
    return 1e3 * t.device_s / t.batches
