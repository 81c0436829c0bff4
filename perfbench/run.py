"""Run one cell of the benchmark once; see ``harness/cli.py``.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>
"""
import os
import sys
from pathlib import Path

if __name__ == "__main__":
    ROOT = Path(__file__).resolve().parents[1]
    # Kernel caches at fixed paths inside the checkout, so that only a
    # checkout's first run builds or compiles; one host thread for
    # PyTorch's CPU pool, since the host only launches work.
    build = ROOT / "build" / "perfbench"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["OMP_NUM_THREADS"] = "1"
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench.harness import cli

    sys.exit(cli.main())
