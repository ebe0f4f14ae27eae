"""Seconds from the process's start to the end of set-up: imports, the
world, the kernels' build or load, the models, and the prefix or warm-up run
through the loop (host clock)."""


def read(run):
    return run.setup_s
