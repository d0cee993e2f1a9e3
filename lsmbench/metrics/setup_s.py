"""setup_s, s (host clock): from the start of the process to the start of
the window: imports, the kernels' build where it is not yet in the
checkout, the data made on the card, the deployment and its warm-up."""


def read(run):
    return run.setup_s
