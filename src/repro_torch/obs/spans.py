"""Nested wall-clock span tracing aligned with torch profiles (port of
``repro/obs/spans.py``).

    with obs.span("serving.wave") as sp:
        out = step(...)
        sp.block_on(out)          # honest device timing: wait before stop
        sp.note(fill=0.75)        # extra attrs into the span event

Spans are **host-side**: they time dispatch + (when blocked) device
execution with ``time.perf_counter``.  Every enabled span also enters a
``torch.profiler.record_function`` range, so span names line up with the
kernels in a ``torch.profiler`` trace.

CUDA launches are asynchronous: without blocking, a span measures enqueue
time, not compute.  ``block=`` / :meth:`Span.block_on` make the span
synchronize the CUDA devices of the given tensors (any nesting of
dicts/lists/tuples/dataclasses of tensors) *inside* the timed window — the
explicit opt-in for honest device timing.  CPU tensors need no wait.

Nesting is tracked with a contextvar stack: each span event records its
``path`` (slash-joined ancestry) and ``depth``, and the duration lands in
the ``span.<name>`` histogram of the registry.  When observability is
disabled, :func:`span` yields a shared no-op object: one predicate check,
nothing recorded, no profiler range entered, no synchronisation.  The port
has no jit trace, so every enabled span records (the JAX package's
no-op-under-trace rule has nothing to apply to).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from contextvars import ContextVar

import torch

from . import registry

_stack: ContextVar[tuple[str, ...]] = ContextVar("repro_torch_obs_spans",
                                                 default=())


class Span:
    """One live span: attach attrs / a block target while inside it."""

    __slots__ = ("name", "path", "depth", "attrs", "_block")

    def __init__(self, name: str, path: str, depth: int):
        self.name = name
        self.path = path
        self.depth = depth
        self.attrs: dict = {}
        self._block = None

    def note(self, **attrs) -> None:
        """Attach extra key/values to the span event (fill ratios, sizes)."""
        self.attrs.update(attrs)

    def block_on(self, value) -> None:
        """Synchronize the CUDA devices of ``value``'s tensors before the
        span closes, so the recorded duration includes device execution."""
        self._block = value


class _NullSpan:
    """Shared no-op stand-in yielded when observability is disabled."""

    __slots__ = ()

    def note(self, **attrs) -> None:
        pass

    def block_on(self, value) -> None:
        pass


_NULL = _NullSpan()


def _cuda_devices(value, out: set) -> set:
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            out.add(value.device)
    elif isinstance(value, dict):
        for v in value.values():
            _cuda_devices(v, out)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _cuda_devices(v, out)
    elif dataclasses.is_dataclass(value) and not isinstance(value, type):
        for fld in dataclasses.fields(value):
            _cuda_devices(getattr(value, fld.name), out)
    return out


def _block(value) -> None:
    for dev in _cuda_devices(value, set()):
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def span(name: str, *, block=None, **attrs):
    """Time a host-side region as a nested span named ``name``.

    ``block`` (or :meth:`Span.block_on` inside the region) opts into
    device-honest timing; ``attrs`` seed the span event's attributes.
    Zero work when observability is disabled."""
    if not registry.enabled():
        yield _NULL
        return
    parent = _stack.get()
    path = "/".join((*parent, name))
    token = _stack.set((*parent, name))
    sp = Span(name, path, depth=len(parent))
    if attrs:
        sp.note(**attrs)
    if block is not None:
        sp.block_on(block)
    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(name):
            yield sp
            if sp._block is not None:
                _block(sp._block)
    finally:
        dur = time.perf_counter() - t0
        _stack.reset(token)
        registry.REGISTRY.observe(f"span.{name}", dur)
        event = {
            "type": "span",
            "name": name,
            "path": path,
            "depth": sp.depth,
            "dur_s": dur,
            "blocked": sp._block is not None,
        }
        if sp.attrs:
            event["attrs"] = sp.attrs
        registry.REGISTRY.emit(event)
