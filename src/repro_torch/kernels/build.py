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

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("walk_sampler", "ell_spmv", "ell_spmv_t", "khat_fused")
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


def on_cuda(kernel: str, *tensors) -> bool:
    """True if every tensor lies on one CUDA device, False if all are on the
    CPU; raises on anything else.  This is the whole dispatch rule of the
    port: a CPU tensor goes to the plain version, a CUDA tensor to the
    kernel, and nothing sends a CUDA tensor to the plain version."""
    devices = {t.device for t in tensors}
    if len(devices) == 1:
        (dev,) = devices
        if dev.type == "cpu":
            return False
        if dev.type == "cuda":
            return True
    raise ValueError(
        f"{kernel}: all tensors must lie on the CPU or on one CUDA device, "
        f"got {sorted(str(d) for d in devices)}"
    )


def check(kernel: str, t, name: str, dtypes, ndims) -> None:
    """Raise unless ``t`` has one of ``dtypes``, one of ``ndims`` and is
    contiguous (the kernels index raw row-major memory)."""
    if t.dtype not in dtypes:
        raise TypeError(f"{kernel}: {name} must be one of {dtypes}, got {t.dtype}")
    if t.dim() not in ndims:
        raise ValueError(f"{kernel}: {name} must have ndim in {ndims}, got {t.dim()}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device) -> ctypes.c_void_p:
    """PyTorch's current stream on ``device`` as a C pointer."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
