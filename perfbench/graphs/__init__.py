"""Frozen copies of the graph generators the configurations name.

The benchmark's inputs must not change when the port changes its own
generators, so the edge lists, the padded ELL build and the signals are
copied here (from ``repro_torch.graphs``) and never imported from the port.
"""
