"""Batched serving example on the PyTorch port: greedy generation with the
LM scaffold's ServeLoop.

    PYTHONPATH=src python -m repro_torch.examples.serve_batch --arch gemma3-4b
    PYTHONPATH=src python -m repro_torch.examples.serve_batch --device cpu

The twin of examples/serve_batch.py, with the same flags and defaults (the
reduced config of ``--arch``, batch 4, six requests of 8 prompt tokens),
plus ``--device``: it runs on the CUDA card unless ``--device cpu`` is given.
The parameters come from the port's own initialisation (seed 0), not the
JAX package's, so the tokens differ from the JAX example's.
"""
import argparse

import numpy as np

from repro_torch.configs import get_config, reduce_config
from repro_torch.launch.serve import Request, ServeLoop
from repro_torch.models import model


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="gemma3-4b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = reduce_config(get_config(args.arch))
    params = model.init_params(cfg, seed=0, device=args.device)
    loop = ServeLoop(cfg, params, batch=args.batch, max_len=64)

    rng = np.random.default_rng(0)
    reqs = [
        Request(prompt=rng.integers(0, cfg.vocab_size, 8).astype(np.int32),
                max_new_tokens=args.new_tokens)
        for _ in range(6)
    ]
    loop.run(reqs, progress=lambda live, queued: print(
        f"  decode step: {live} live, {queued} queued"))
    for i, r in enumerate(reqs):
        print(f"request {i}: generated {len(r.generated)} tokens: {r.generated[:8]}...")
    return reqs


if __name__ == "__main__":
    main()
