"""Kernel launches (kernels/dispatch.py launch_counts) per request in the window."""


def read(run):
    w = run.window
    return run.launches / w.units if w.units else None
