"""Loss curves of GPT-2 124M under ``ShardedTrainStep``, fp8 beside fp32.

    python3 tools/fp8_loss_curves.py [--lr 1e-3 3e-4 1e-4] [--steps 8]
        [--batch bench|shifted]

For each learning rate, the fp8 and fp32 steps of ``chip_smoke.py``'s
phase 9 (``chip_smoke.fp8_train_steps``: full width, batch 8 x seq 1024,
dropout 0, seeded ``Uniform(0.07)`` weights, ``adam``) take ``--steps``
steps each, in turns, on one fixed batch (``chip_smoke.fp8_train_batch``):
"bench" draws x and y apart, as bench.py's fp8 row does; "shifted" takes y
as x shifted by one token. Prints the card's ``nvidia-smi`` name and power
limit, then one line of losses per precision and rate. Needs one CUDA
card.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

import torch


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--lr", type=float, nargs="+", default=[1e-3, 3e-4, 1e-4])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--batch", choices=("bench", "shifted"), default="bench")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    from chip_smoke import fp8_train_batch, fp8_train_steps

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    x, y = fp8_train_batch(dev, shifted=args.batch == "shifted")
    for lr in args.lr:
        s8, s32 = fp8_train_steps(dev, lr)
        curves = {"fp8": [], "fp32": []}
        for _ in range(args.steps):
            curves["fp8"].append(s8(x, y).item())
            curves["fp32"].append(s32(x, y).item())
        for name, losses in curves.items():
            print(f"batch={args.batch} lr={lr:g} {name}: "
                  + " ".join(f"{v:.4f}" for v in losses), flush=True)
        del s8, s32
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
