"""The share of the card's bf16 peak that offline scoring reaches: the
forward operations of every frame scored (``flops.frame_flops``) over the
window, over 989 TFLOP/s."""

from gpubench.flops import PEAK_FLOPS


def read(run):
    if run.loop != "score" or run.window_s <= 0 or run.frames <= 0:
        return None
    return 100 * run.frames * run.flops_per_frame / run.window_s / PEAK_FLOPS["bfloat16"]
