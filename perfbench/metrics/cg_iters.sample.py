"""CG iterations per solve (solvers/cg.py), mean over the window's solves."""


def read(run):
    its = run.window.iters
    return sum(its) / len(its) if its else None
