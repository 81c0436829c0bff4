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
the ``span.<name>`` histogram of the registry.  Each root span (depth 0)
takes the next number of a process-wide sequence, and every span event and
tap event under that root carries it as ``"request"``, so the events of
one request group together.

A span is in one of three states:

  * observability enabled: recorded as above, inside a profiler range;
  * disabled while a torch profiler is recording: the ``record_function``
    range alone, so a profiled run sees the program's layers on the
    profiler's own clock.  Nothing is recorded in the registry and nothing
    blocks: ``block=`` and :meth:`Span.block_on` are ignored, so the span
    neither synchronises nor reads from the device;
  * disabled with no profiler: a shared no-op — two predicate checks,
    nothing recorded, no profiler range entered (``record_function`` costs
    far more than the checks even with no profiler running), no
    synchronisation.

The port has no jit trace, so every enabled span records (the JAX package's
no-op-under-trace rule has nothing to apply to).
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import time
from contextvars import ContextVar

import torch

from . import registry

# The port's spans that have no counterpart in the JAX package: the layer
# boundaries inside the posterior path (its draws, the operator products,
# the column-index build, the CG loop, its iterations and host reads), which
# the JAX package runs inside one jit.  Both packages' records hold the same
# spans once these are taken out.
PORT_SPANS = ("posterior.draw", "features.take_rows", "walks.column_index",
              "linops.phi", "linops.phi_t", "linops.khat", "solver.cg",
              "solver.cg.iter", "solver.cg.read")

_stack: ContextVar[tuple[str, ...]] = ContextVar("repro_torch_obs_spans",
                                                 default=())
_request: ContextVar[int | None] = ContextVar("repro_torch_obs_request",
                                              default=None)
_requests = itertools.count()
_profiling = torch._C._autograd._profiler_enabled


def current_request() -> int | None:
    """The sequence number of the enclosing root span, None outside one."""
    return _request.get()


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
_OFF = contextlib.nullcontext(_NULL)   # obs disabled, no profiler


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


def span(name: str, *, block=None, **attrs):
    """Time a host-side region as a nested span named ``name``.

    ``block`` (or :meth:`Span.block_on` inside the region) opts into
    device-honest timing; ``attrs`` seed the span event's attributes.
    With obs disabled: only a profiler range while a torch profiler is
    recording (no block, no record), else zero work."""
    if registry.enabled():
        return _recorded(name, block, attrs)
    if _profiling():
        return _profiler_range(name)
    return _OFF


@contextlib.contextmanager
def _profiler_range(name: str):
    with torch.profiler.record_function(name):
        yield _NULL


@contextlib.contextmanager
def _recorded(name: str, block, attrs: dict):
    parent = _stack.get()
    path = "/".join((*parent, name))
    token = _stack.set((*parent, name))
    root = _request.set(next(_requests)) if not parent else None
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
            "request": _request.get(),
        }
        if sp.attrs:
            event["attrs"] = sp.attrs
        if root is not None:
            _request.reset(root)
        registry.REGISTRY.emit(event)
