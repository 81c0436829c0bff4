"""Value taps: device values into the host registry (port of
``repro/obs/taps.py``).

A *tap* records values a hot path computes (CG iteration counts, residual
norms, convergence flags, row counts).  The JAX package stages a host
callback inside its jitted code; the port has no jit, so a tap is a direct
host call made where the value is computed.

The overhead contract: every tap checks :func:`registry.enabled` first.
Disabled (the default), it returns before touching its values, so it
reads nothing from the device and adds no synchronisation.  Enabled, a
tap that is given tensors reads them (one device-to-host copy each);
``sample=k`` thins a high-frequency tap by its name's tick, and only every
k-th occurrence reads its values at all — the per-iteration CG residual
trajectory uses this, so an enabled flight record stays bounded.
"""
from __future__ import annotations

import numpy as np
import torch

from . import registry


def _pyval(v):
    """A tensor, numpy value or Python scalar → a JSON-able Python value
    (scalars stay scalars, bools stay bools)."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    arr = np.asarray(v)
    if arr.ndim == 0:
        x = arr.item()
        return bool(x) if arr.dtype == np.bool_ else x
    return arr.tolist()


def tap_dict(
    name: str,
    values: dict,
    *,
    hist: tuple[str, ...] = (),
    meta: dict | None = None,
    sample: int = 1,
    event: bool = True,
) -> None:
    """Record a named group of values in one call.

    Per occurrence: the counter ``<name>.count`` increments; each value in
    ``hist`` lands in the ``<name>.<key>`` histogram; boolean values count
    into the ``<name>.<key>`` counter (total = ``<name>.count``); everything
    else sets the ``<name>.<key>`` gauge.  With ``event=True`` a ``tap``
    record also streams to the sinks, carrying the ``meta`` dict alongside
    the values.  No-op, and no device read, when observability is
    disabled."""
    if not registry.enabled():
        return
    reg = registry.REGISTRY
    if not reg.tap_tick(name, sample):
        return
    payload = {k: _pyval(v) for k, v in values.items()}
    reg.inc(f"{name}.count")
    for k, v in payload.items():
        if isinstance(v, bool):
            reg.inc(f"{name}.{k}", 1 if v else 0)
        elif k in hist and np.isscalar(v):
            reg.observe(f"{name}.{k}", float(v))
        elif np.isscalar(v):
            reg.set_gauge(f"{name}.{k}", float(v))
    if event:
        rec = {"type": "tap", "name": name, "values": payload}
        if meta:
            rec["meta"] = dict(meta)
        reg.emit(rec)


def tap(
    name: str,
    value,
    *,
    kind: str = "gauge",
    sample: int = 1,
    event: bool = True,
) -> None:
    """Record one scalar (``kind`` in {"gauge", "hist", "counter"})."""
    if not registry.enabled():
        return
    reg = registry.REGISTRY
    if not reg.tap_tick(name, sample):
        return
    x = _pyval(value)
    if kind == "hist":
        reg.observe(name, float(x))
    elif kind == "counter":
        reg.inc(name, float(x))
    else:
        reg.set_gauge(name, float(x))
    if event:
        reg.emit({"type": "tap", "name": name, "values": {"value": x}})


def count(name: str, n: int = 1, labels: dict | None = None) -> None:
    """Increment a counter once per execution of the enclosing code (a
    direct host call here, so it counts calls by construction).  Nothing
    recorded when disabled."""
    if registry.enabled():
        registry.REGISTRY.inc(name, n, labels)
