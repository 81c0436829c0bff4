"""The plain reference that decides ``correct``.

Plain PyTorch in float64 (walks in the sampler's own integer and float32
arithmetic).  It imports nothing of ``repro_torch``: where it needs the
port's arithmetic (the walk sampler's counter RNG), it holds a frozen copy.
It takes only the inputs the harness made (graph arrays, seeds, nodes, y)
and recomputes everything the program derived from them.
"""
