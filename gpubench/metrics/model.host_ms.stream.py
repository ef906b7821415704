"""The host's time inside each ``engine.forward`` call of the window (the
enqueue of one device batch; no sync), averaged over the calls begun before
the traced slice, since the profiler slows the enqueue."""


def read(run):
    if run.loop != "stream" or not run.forward_host_s:
        return None
    return sum(run.forward_host_s) / len(run.forward_host_s) * 1e3
