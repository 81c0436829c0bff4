"""Set-up: graph, walks, program state and warm-up requests, compilation included (s)."""


def read(run):
    return run.setup_s
