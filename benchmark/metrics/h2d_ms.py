"""h2d_ms (batch API): host ms a batch in the span dispatch.h2d of
SingleTurboDispatch.dispatch, the read matrix's synchronous copy to the
card, mean over the spans that ended in the window; the port's own
recorder, on while the traced run's profiler is."""

from benchmark import spans


def read(run):
    return spans.mean_ms(spans.window(run, "dispatch.h2d"))
