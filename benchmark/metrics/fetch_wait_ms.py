"""fetch_wait_ms (batch API): host ms a batch that the consumer waits in
the span fetch for its batch's readback event, mean over the spans that
ended in the window; the port's own recorder."""

from benchmark import spans


def read(run):
    return spans.mean_ms(spans.window(run, "fetch"))
