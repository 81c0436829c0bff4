"""Launchers of the LM scaffold (port of ``repro/launch/``): serving so far."""
