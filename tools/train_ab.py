"""Time the GPT-2 124M bf16 training step of one tree of the port on the card.

    python tools/train_ab.py --root <tree> --label <name> [--np] [--loop N]

Imports ``mxnet_tpu_torch`` from ``<tree>`` (a ``git archive`` of a commit,
or ``.``) and measures the same step whatever the tree: ``chip_smoke.py``
phase 16's configuration (GPT-2 124M at full width, seed-0 weights, batch
8 x 1024, ``amp.init("bfloat16")``, AdamW through the Trainer), driven
by tensors, eager and then hybridized (``net.hybridize()``,
``loss.hybridize()``). For each mode: two warm-up steps, then ``--repeats``
timed runs of ``--steps`` steps (synchronized host clock), the device ms
and busy share of two profiled steps (``torch.profiler``'s CUDA events),
and the host's kernel and graph launch calls a step (its runtime API
events). ``--np`` drives the step the reference's way, from ``mx.np``
arrays (``loss.backward()``: ``chip_smoke.py`` phase 27's eager step).
``--loop N`` times, beside the step, a tight eager loop of N elementwise
``mx.np`` ops on the card (``chip_smoke.py`` phase 30's loop): its host
wall time over ``--repeats`` runs, and its device ms and launch calls
scaled from a profiled loop of 1000 ops; with ``--steps 0`` the loop
alone. The host
planes stay off, as a tree without them runs. Prints one line
``TRAIN_AB <label> {...}`` with the card's name and power limit. Run it on
two trees in turns in one call (parent, change, change, parent) to
compare them.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as onp
import torch

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel",
                "cudaGraphLaunch")


def profile_step(step):
    """(device ms of one step, host launch calls of one step) over two
    profiled steps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            step()
        torch.cuda.synchronize()
    device_us, calls = 0.0, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            device_us += e.time_range.elapsed_us()
        elif e.name in LAUNCH_CALLS:
            calls[e.name] = calls.get(e.name, 0) + 1
    return device_us / 2 / 1e3, {k: v / 2 for k, v in calls.items()}


def time_loop(mx, dev, n, repeats, profiled=1000):
    """A tight eager loop of ``n`` elementwise mx.np ops on a 64-element
    array: host wall ms of each run; device ms and launch calls of one
    run, scaled from two profiled loops of ``profiled`` ops (a profiled
    window of 2 x 10000 launches is more than the profiler takes)."""
    a = mx.np.ones((64,), ctx=mx.gpu(dev.index or 0))

    def loop(k=n):
        b = a
        for _ in range(k // 2):
            b = b * 1.0001
            b = b + 0.5
        return b
    loop()
    walls = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loop()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    device_ms, calls = profile_step(lambda: loop(profiled))
    scale = n / profiled
    calls = {k: v * scale for k, v in calls.items()}
    return {"ops": n, "wall_ms": float(onp.median(walls)),
            "wall_ms_runs": walls, "device_ms": device_ms * scale,
            "host_launch_calls": calls,
            "host_launch_calls_total": sum(calls.values())}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--label", required=True)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--np", action="store_true",
                    help="drive the step from mx.np arrays")
    ap.add_argument("--loop", type=int, default=0,
                    help="also time a loop of this many mx.np ops")
    ap.add_argument("--eager-only", action="store_true",
                    help="time the eager step only")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    os.chdir(root)
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.gpt import GPTForCausalLM, gpt2_124m
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    batch, seq, vocab = 8, 1024, 50257
    net = GPTForCausalLM(backbone=gpt2_124m(
        vocab_size=vocab, max_length=seq, dropout=0.0, embed_dropout=0.0,
        device=dev)).initialize(seed=0)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    ids = torch.from_numpy(onp.random.RandomState(0).randint(
        0, vocab, (batch, seq + 1))).to(dev)
    x, y = ids[:, :-1], ids[:, 1:]
    if args.np:
        gpu = mx.gpu(dev.index or 0)
        x, y = (mx.np.array(t.cpu().numpy(), ctx=gpu) for t in (x, y))
    trainer = mx.gluon.Trainer(net.collect_params(), "adamw",
                               {"learning_rate": 1e-4, "wd": 0.01})

    def step():
        with mx.autograd.record():
            loss = loss_fn(net(x), y)
        if args.np:
            loss.backward()
        else:
            mx.autograd.backward(loss)
        trainer.step(batch)
        return loss

    out = {"card": card, "torch": torch.__version__,
           "cuda": torch.version.cuda, "np": args.np}
    if args.loop:
        out["loop"] = time_loop(mx, dev, args.loop, args.repeats)
    if not args.steps:
        print(f"TRAIN_AB {args.label} " + json.dumps(out), flush=True)
        return
    mx.amp.init("bfloat16")
    for mode in ("eager",) if args.eager_only else ("eager", "hybridized"):
        if mode == "hybridized":
            net.hybridize()
            loss_fn.hybridize()
        for _ in range(2):
            step()
        walls = []
        for _ in range(args.repeats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(args.steps):
                step()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) / args.steps * 1e3)
        device_ms, calls = profile_step(step)
        wall = float(onp.median(walls))
        out[mode] = {"step_ms": wall, "step_ms_runs": walls,
                     "device_ms": device_ms,
                     # a profiled window slower than the timed runs gives
                     # no share that was measured
                     "device_busy_share": device_ms / wall
                     if device_ms <= wall else None,
                     "host_launch_calls_per_step": calls,
                     "host_launch_calls_total": sum(calls.values())}
    print(f"TRAIN_AB {args.label} " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
