"""The share of the card's bf16 peak that a request stream reaches: the
forward operations of every frame served in the window
(``flops.frame_flops``) over the window, over 989 TFLOP/s."""

from gpubench.flops import PEAK_FLOPS


def read(run):
    if run.loop != "stream" or run.seconds <= 0 or run.frames_in_window <= 0:
        return None
    return (100 * run.frames_in_window * run.flops_per_frame / run.seconds
            / PEAK_FLOPS["bfloat16"])
