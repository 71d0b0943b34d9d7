"""Seconds from the process's start to the window's: imports, the lap's
render, the program's construction, its kernels' build or load, warm-up
and graph captures."""


def read(run):
    return run.setup_s
