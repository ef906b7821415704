"""K3's share of its roofline: the bound of one forward's K3 call
(``flops.k3_bound_s``, the head's needed work from shapes) times the
forwards begun in the traced slice, over the device time of K3's kernel
there. It reads nothing where K3 did not run, and nothing where any forward
of the window launched K3 other than once."""

from gpubench import flops
from gpubench import trace as tr


def read(run):
    if run.trace is None or run.forwards_traced <= 0:
        return None
    if not run.forward_launches or any(n.get("K3", 0) != 1 for n in run.forward_launches):
        return None
    busy = tr.device_seconds(run.trace, lambda n: tr.kernel_class(n) == "K3")
    if busy <= 0:
        return None
    t = run.cell.traffic
    return 100 * run.forwards_traced * flops.k3_bound_s(run.cell.arch, t["height"],
                                                         t["width"]) / busy
