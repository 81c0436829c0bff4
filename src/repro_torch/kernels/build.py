"""Build and load the port's CUDA kernels (nvcc → shared library → ctypes).

Each source ``kernels/csrc/<name>.cu`` is compiled at first use by one
``nvcc`` call into its own shared library with a plain C interface; no
PyTorch header is included, so a build takes seconds.  Libraries are cached
under ``build/repro_torch/`` at the repository root, keyed by a hash of the
source and the flags, and written under a temporary name then renamed, so
concurrent processes never load a half-written file.  ``-Xptxas -v`` output
(registers, shared memory, spills per kernel) is kept beside each library
and returned by :func:`ptxas_report`.

Nothing here runs at import: the CPU tests import every module of the port.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import sys
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("walk_sampler", "ell_spmv", "ell_spmv_t", "khat_fused", "gram_block",
           "woodbury_apply", "flash_attention", "rmsnorm")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}
_FNS: dict[tuple[str, str], object] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH); the CUDA "
            "kernels of repro_torch are built from source at first use"
        )
    return found


def _paths(name: str) -> tuple[Path, Path, Path]:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    return src, lib, lib.with_suffix(".ptxas.txt")


def _start(name: str):
    """Start the nvcc of one source; None when its library is cached."""
    src, lib, log = _paths(name)
    if lib.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.tmp{os.getpid()}")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, lib, log, cmd


def _finish(name: str, started) -> None:
    proc, tmp, lib, log, cmd = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{out}"
        )
    log.write_text(out)
    os.replace(tmp, lib)


def build_all(names=SOURCES) -> None:
    """Compile every missing library, one nvcc per source, all in parallel."""
    started = {n: _start(n) for n in names}
    errors = []
    for n, s in started.items():
        if s is None:
            continue
        try:
            _finish(n, s)
        except RuntimeError as e:  # collect every failing source, then raise
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(_paths(name)[1]))
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def bind(name: str, fn: str, argtypes: list):
    """C entry point ``fn`` of library ``name`` with its argtypes set.

    Every entry point returns ``cudaGetLastError()`` after its launch as an
    int; the returned callable raises RuntimeError when that is not 0."""
    bound = _FNS.get((name, fn))
    if bound is not None:
        return bound
    lib = load(name)
    c_fn = getattr(lib, fn)
    c_fn.argtypes = argtypes
    c_fn.restype = ctypes.c_int

    def call(*args):
        rc = c_fn(*args)
        if rc != 0:
            msg = lib.repro_cuda_error_string(rc).decode()
            raise RuntimeError(f"{name}:{fn} failed: CUDA error {rc} ({msg})")

    _FNS[(name, fn)] = call
    return call


def ptxas_report(names=SOURCES) -> dict[str, str]:
    """The ``-Xptxas -v`` lines of each built library (registers, spills)."""
    out = {}
    for n in names:
        log = _paths(n)[2]
        if log.exists():
            out[n] = "\n".join(
                ln for ln in log.read_text().splitlines()
                if "ptxas info" in ln or "spill" in ln
            )
    return out


def ptxas_functions(name: str) -> list[dict]:
    """Each kernel function of a built library, from its ``-Xptxas -v``
    log: mangled name, registers, spill stores and loads (bytes)."""
    out, cur = [], None
    for ln in _paths(name)[2].read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = dict(function=m.group(1), registers=None, spill_stores=0,
                       spill_loads=0)
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def on_cuda(kernel: str, *tensors) -> bool:
    """True if every tensor lies on one CUDA device, False if all are on the
    CPU (or all on ``meta``: shapes without storage, which the dry run
    traces through the plain versions); raises on anything else.  This is
    the whole dispatch rule of the port: a CPU tensor goes to the plain
    version, a CUDA tensor to the kernel, and nothing sends a CUDA tensor to
    the plain version."""
    first = tensors[0].get_device()   # -1 off the card: no Device objects
    if first >= 0 and all(t.get_device() == first for t in tensors[1:]):
        return True
    devices = {t.device for t in tensors}
    if len(devices) == 1:
        (dev,) = devices
        if dev.type in ("cpu", "meta"):
            return False
        if dev.type == "cuda":
            return True
    raise ValueError(
        f"{kernel}: all tensors must lie on the CPU or on one CUDA device, "
        f"got {sorted(str(d) for d in devices)}"
    )


def is_dtensor(t) -> bool:
    """True for a ``torch.distributed`` DTensor (a sharded LM tensor, which
    the LM kernels' wrappers run shard by shard).  Imports nothing when
    ``torch.distributed.tensor`` has not been loaded: then no tensor can be
    one."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def grad_placements(own: tuple, lead: tuple) -> tuple:
    """The placements of the gradient of a ``local_map`` input placed
    ``own``, beside the input placed ``lead`` that splits the work: on a
    mesh dim where ``lead`` is sharded and this input replicated, each
    rank's local gradient is a partial sum."""
    from torch.distributed.tensor import Partial

    return tuple(Partial() if o.is_replicate() and ld.is_shard() else o
                 for o, ld in zip(own, lead))


def check(kernel: str, t, name: str, dtypes, ndims) -> None:
    """Raise unless ``t`` has one of ``dtypes``, one of ``ndims`` and is
    contiguous (the kernels index raw row-major memory)."""
    if t.dtype not in dtypes:
        raise TypeError(f"{kernel}: {name} must be one of {dtypes}, got {t.dtype}")
    if t.dim() not in ndims:
        raise ValueError(f"{kernel}: {name} must have ndim in {ndims}, got {t.dim()}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")


def ptr(t) -> int:
    """The tensor's data pointer, for a ``c_void_p`` argument."""
    return t.data_ptr()


def stream(device) -> int:
    """PyTorch's current stream on ``device`` as a raw pointer, for a
    ``c_void_p`` argument; read without building a ``torch.cuda.Stream``
    where the CUDA build of PyTorch offers the raw call."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(device.index)
    return torch.cuda.current_stream(device).cuda_stream


_CURRENT = contextlib.nullcontext()


def device(dev):
    """A context that makes ``dev`` the current CUDA device for a launch:
    none at all when it already is (the usual case), since entering
    ``torch.cuda.device`` costs microseconds of host time every call."""
    if dev.index == torch.cuda.current_device():
        return _CURRENT
    return torch.cuda.device(dev)
