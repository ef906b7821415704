"""The engine's own host time a device batch under a request stream: over
the ``engine/batch`` spans that began and ended in the traced slice, the
mean of the summed self time of their ``engine/group``, ``engine/pad``,
``engine/h2d``, ``engine/d2h`` and ``engine/deliver`` spans (not
``engine/take``, the wait for a request, nor ``engine/device_wait``, nor the
model's), from the program's spans (``gpubench/program_spans.py``)."""

from gpubench import program_spans

NAMES = ("engine/group", "engine/pad", "engine/h2d", "engine/d2h", "engine/deliver")


def read(run):
    if run.loop != "stream":
        return None
    return program_spans.host_ms_per_batch(run, NAMES)
