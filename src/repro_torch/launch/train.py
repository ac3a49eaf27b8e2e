"""Training launcher (port of ``repro/launch/train.py``), one device:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
      --smoke --steps 2 --device cpu

Runs on ``cuda`` unless ``--device`` names another device.  ``--ckpt-dir``
waits for the checkpoint slice (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import argparse

from ..configs import get_config, get_smoke_config, list_archs
from ..train.optimizer import OptimizerConfig
from ..train.trainer import TrainerConfig, train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "bf16", "int8"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    print(f"[launch] {cfg.name} on {args.device or 'cuda'}")
    out = train(
        cfg,
        TrainerConfig(steps=args.steps, batch=args.batch,
                      seq_len=args.seq_len, seed=args.seed,
                      checkpoint_dir=args.ckpt_dir),
        OptimizerConfig(name=args.optimizer, lr=args.lr,
                        grad_compression=args.grad_compression),
        device=args.device,
    )
    print(f"[launch] done; final loss {out['losses'][-1]:.4f}")
    return out


if __name__ == "__main__":
    main()
