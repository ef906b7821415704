"""Device time of one forward in offline scoring: the kernels (not copies or
fills) in the traced slice over the ``engine.forward`` calls made in it."""

from gpubench import trace as tr


def read(run):
    if run.loop != "score" or run.trace is None or run.forwards_traced <= 0:
        return None
    s = tr.device_seconds(run.trace, lambda n: tr.kernel_class(n) != "copies and fills")
    return s / run.forwards_traced * 1e3 if s > 0 else None
