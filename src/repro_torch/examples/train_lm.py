"""End-to-end LM training driver of the port (twin of examples/train_lm.py).

    PYTHONPATH=src python -m repro_torch.examples.train_lm --preset tiny --device cpu
    PYTHONPATH=src python -m repro_torch.examples.train_lm --preset 100m --steps 300

``tiny`` is the reduced config of ``--arch`` and runs in seconds on the CPU;
``100m`` is a ~100M-parameter llama-style model.  Runs on the CUDA card
unless ``--device`` says otherwise.  Checkpoints under --ckpt; kill and rerun
to resume."""
import argparse

from repro_torch.configs import get_config, reduce_config
from repro_torch.launch.train import train_loop
from repro_torch.models.config import LayerSpec, ModelConfig


def preset_100m() -> ModelConfig:
    return ModelConfig(
        name="llama-100m", family="decoder",
        d_model=768, n_heads=12, n_kv_heads=4, d_ff=2048, vocab_size=32_000,
        stages=((12, (LayerSpec(kind="attn"),)),),
        remat="none", dtype="float32",
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--preset", choices=["tiny", "100m"], default="tiny")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    if args.preset == "100m":
        cfg = preset_100m()
    else:
        cfg = reduce_config(get_config(args.arch))
    print(f"training {cfg.name}: {cfg.param_count()/1e6:.1f}M params, "
          f"{args.steps} steps @ batch {args.batch} × seq {args.seq}")

    state, history = train_loop(
        cfg, steps=args.steps, ckpt_dir=args.ckpt, ckpt_every=50,
        lr=args.lr, global_batch=args.batch, seq_len=args.seq,
        microbatches=args.microbatches, device=args.device,
    )
    for h in history:
        print(f"  step {h['step']:5d}  loss {h['loss']:.4f}")
    print("done; final step", int(state.step))
    return history


if __name__ == "__main__":
    main()
