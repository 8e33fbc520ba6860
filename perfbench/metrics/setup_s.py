"""Seconds from the process's start to the window's first request:
corpus and container, weights, runtime, kernel builds, warm-up and
graph captures."""


def read(run):
    return run.setup_s
