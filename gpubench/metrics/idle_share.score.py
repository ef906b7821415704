"""The device's idle share in offline scoring: 1 - the union of device
operations over the traced slice, in percent."""

from gpubench import trace as tr


def read(run):
    if run.loop != "score" or run.trace is None or run.trace.window_s <= 0:
        return None
    return 100 * (1 - tr.busy_s(run.trace) / run.trace.window_s)
