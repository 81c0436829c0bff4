"""PyTorch port, the kernel build's helpers on the CPU: the parser of the
``-Xptxas -v`` log that chip_smoke.py gates spills with, and the dispatch
rule's fast path for tensors that lie on one device."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402

LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z3fooPf' for 'sm_90a'
ptxas info    : Function properties for _Z3fooPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN2tc3barILi80EEEvv' for 'sm_90a'
ptxas info    : Function properties for _ZN2tc3barILi80EEEvv
    56 bytes stack frame, 64 bytes spill stores, 60 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 56 bytes cumulative stack size
"""


def test_ptxas_functions_reads_registers_and_spills(tmp_path, monkeypatch):
    log = tmp_path / "libx.ptxas.txt"
    log.write_text(LOG)
    monkeypatch.setattr(build, "_paths", lambda name: (None, None, log))
    got = build.ptxas_functions("x")
    assert got == [
        dict(function="_Z3fooPf", registers=40, spill_stores=0, spill_loads=0),
        dict(function="_ZN2tc3barILi80EEEvv", registers=128, spill_stores=64,
             spill_loads=60),
    ]


def test_on_cuda_is_false_on_the_cpu_and_raises_when_mixed():
    cpu = torch.zeros(3)
    assert build.on_cuda("k", cpu, cpu[:1]) is False
    with pytest.raises(ValueError, match="one CUDA device"):
        build.on_cuda("k", cpu, torch.zeros(3, device="meta"))


def test_ptr_is_the_data_pointer():
    t = torch.zeros(4)
    assert build.ptr(t) == t.data_ptr()
