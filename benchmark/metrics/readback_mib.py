"""readback_mib (batch API): MiB a batch read back to the host (the
packed row, and the dense hit lists where the CSR overflowed), the
counter readback.bytes of each decode that ended in the window, mean;
the port's own recorder."""

from benchmark import spans


def read(run):
    decoded = spans.window(run, "decode")
    if not decoded:
        return None
    return sum(spans.count(d, "readback.bytes") for d in decoded) \
        / len(decoded) / 2**20
