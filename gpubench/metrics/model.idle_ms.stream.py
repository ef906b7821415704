"""Device idle time while the host enqueues the forward, a forward, under a
request stream: the idle ms of the traced slice whose gaps began under a
``model/*`` span of the program, over the ``model/forward`` spans begun in
the slice (``gpubench/program_spans.py``): the device starved by the
forward's launches."""

from gpubench import program_spans


def read(run):
    if run.loop != "stream":
        return None
    return program_spans.idle_ms_per(run, lambda label: label.startswith("model/"),
                                     program_spans.FORWARD)
