"""Offline scoring: frames whose heat maps came back in the window, over the
window (the last call's return closes it)."""


def read(run):
    if run.loop != "score" or run.window_s <= 0:
        return None
    return run.frames / run.window_s
