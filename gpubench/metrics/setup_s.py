"""Set-up: seconds from the process's start to the window's start (imports,
the kernel build where the checkout has none, the model, the weights, the
inputs and the warm-up of the cell's shapes)."""


def read(run):
    return run.setup_s
