"""K2's share of its roofline: the bound of one forward's K2 calls
(``flops.k2_bound_s``, from the shapes of the blocks the strip gate takes)
times the forwards begun in the traced slice, over the device time of K2's
kernels there. It reads nothing where K2 did not run, and nothing where any
forward of the window launched K2 on another number of blocks than
``flops.k2_blocks`` lists: the bound would then be another call's."""

from gpubench import flops
from gpubench import trace as tr


def read(run):
    if run.trace is None or run.forwards_traced <= 0:
        return None
    t = run.cell.traffic
    blocks = flops.k2_blocks(run.cell.arch, t["height"], t["width"], 1)
    if not blocks or any(n.get("K2", 0) != len(blocks) for n in run.forward_launches):
        return None
    busy = tr.device_seconds(run.trace, lambda n: tr.kernel_class(n) == "K2")
    if busy <= 0:
        return None
    bound = flops.k2_bound_s(run.cell.arch, t["height"], t["width"], 1)
    return 100 * run.forwards_traced * bound / busy
