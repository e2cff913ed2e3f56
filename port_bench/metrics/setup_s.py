"""`setup_s`: from the process's start to the measured window: imports,
the inputs, the agent, the kernels' build or load, and the checked
windows that warm every shape up."""


def read(ctx):
    return ctx.get("setup_s")
