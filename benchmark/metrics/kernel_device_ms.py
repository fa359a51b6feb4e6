"""kernel_device_ms (batch step): device ms a batch of the kernels
alone, without the copies and sets, in the traced run (torch.profiler)
over the batches it holds: the step's own work, apart from the host
that paces the copies."""


def read(run):
    t = run.trace
    if t is None or t.kernel_s <= 0 or not t.batches:
        return None
    return 1e3 * t.kernel_s / t.batches
