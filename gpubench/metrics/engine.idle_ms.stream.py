"""Device idle time that the engine's host work leaves, a device batch,
under a request stream: the idle ms of the traced slice whose gaps began
under an ``engine/*`` span of the program other than ``engine/take`` and
``engine/device_wait``, over the ``engine/batch`` spans begun in the slice
(``gpubench/program_spans.py``)."""

from gpubench import program_spans


def read(run):
    if run.loop != "stream":
        return None
    return program_spans.idle_ms_per(run, program_spans.engine_work, program_spans.BATCH)
