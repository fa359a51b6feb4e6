"""csr_overflow_pct (batch API): batches whose hits overflowed the CSR
(the counter csr.overflow) over the batches decoded in the window, in %;
the port's own recorder."""

from benchmark import spans


def read(run):
    decoded = spans.window(run, "decode")
    if not decoded:
        return None
    return 100.0 * sum(spans.count(d, "csr.overflow") > 0
                       for d in decoded) / len(decoded)
