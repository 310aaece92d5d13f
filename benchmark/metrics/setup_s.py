"""Seconds from the process's start to the window's: imports, kernels,
renders or the render cache, the decoder fit or its cache, the warm-up."""


def read(run):
    return run.setup_s
