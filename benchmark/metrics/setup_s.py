"""setup_s: process start to the first timed batch: build or load of the
kernels, the index family (generated on a checkout's first run), the
index and tables loaded through the port, the reads drawn and assembled,
one warm-up pass of the ring."""


def read(run):
    return run.setup_s
