"""The device's idle share under a request stream: 1 - the union of device
operations over the traced slice, in percent. The clients keep a request
in flight all through the window, so every idle moment is one in which a
request waited."""

from gpubench import trace as tr


def read(run):
    if run.loop != "stream" or run.trace is None or run.trace.window_s <= 0:
        return None
    return 100 * (1 - tr.busy_s(run.trace) / run.trace.window_s)
