"""A request stream's throughput: the frames of all requests whose heat
maps came back between the window's start and its close, over the window.
With a request always waiting behind the one served, this is the engine's
capacity."""


def read(run):
    if run.loop != "stream" or run.seconds <= 0:
        return None
    return run.frames_in_window / run.seconds
