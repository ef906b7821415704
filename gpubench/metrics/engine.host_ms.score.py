"""The engine's own host time a device batch in offline scoring: over the
``engine/batch`` spans that began and ended in the traced slice, the mean of
the summed self time of their ``engine/pad`` (the input's conversion and
padding), ``engine/h2d``, ``engine/d2h`` and ``engine/deliver`` spans, from
the program's spans (``gpubench/program_spans.py``)."""

from gpubench import program_spans

NAMES = ("engine/pad", "engine/h2d", "engine/d2h", "engine/deliver")


def read(run):
    if run.loop != "score":
        return None
    return program_spans.host_ms_per_batch(run, NAMES)
