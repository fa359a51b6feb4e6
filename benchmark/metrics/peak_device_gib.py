"""peak_device_gib: torch.cuda.max_memory_allocated() over the port's
set-up (tables upload, ring, warm-up) and the window, in GiB."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None
