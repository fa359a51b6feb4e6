"""readback_ms (batch API): host ms a batch in the span decode.lists
(the dense hit lists' copy to the host and the two copies out of it),
mean over the batches whose decode ended in the window, 0 for a batch
whose hits the CSR held; the port's own recorder."""

from benchmark import spans


def read(run):
    decoded = spans.window(run, "decode")
    if not decoded:
        return None
    lists: dict = {}
    for s in spans.kept("decode.lists"):
        lists[s.parent] = lists.get(s.parent, 0) + s.t1 - s.t0
    return sum(lists.get(d.id, 0) for d in decoded) / len(decoded) / 1e6
