"""Time the serving main path of one tree of the port on the card.

    python tools/serve_ab.py --root <tree> --label <name>

Imports ``chip_smoke.py`` and ``mxnet_tpu_torch`` from ``<tree>`` (a
``git archive`` of a commit, or ``.``), runs its phase 3 (GPT-2 124M at
full width, ``serve.load(net, max_slots=8)``, warmup, 16 greedy requests
of 32 tokens, the tie-aware checks), then measures that engine the same
way whatever the tree: three timed runs of phase 3's mix (tokens/s, TTFT
p50/p99, TPOT p50 from the requests' own records), the device busy share
of one profiled run, decode ms a step with all 8 slots live (synchronized
host clock over 24 steps) and the host runtime calls a decode step
(``torch.profiler``'s CPU events over 4 steps). Prints one line ``SERVE_AB
<label> {...}`` with the card's name and power limit. Run it on two trees
in turns in one call (parent, change, change, parent) to compare them.
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


def percentile(vals, q):
    return float(onp.percentile(vals, q)) if vals else None


def mix_run(eng, prompts, n_new=32):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new_tokens=n_new) for p in prompts]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ttft = sorted(r.ttft for r in reqs)
    tpot = sorted(r.tpot for r in reqs)
    return {"tokens_per_s": sum(len(r.generated) for r in reqs) / wall,
            "ttft_p50_ms": percentile(ttft, 50) * 1e3,
            "ttft_p99_ms": percentile(ttft, 99) * 1e3,
            "tpot_p50_ms": percentile(tpot, 50) * 1e3, "wall_s": wall}


def live_slots(eng, prompts, n_new):
    """Fill every slot with a long request and run until all are live."""
    reqs = [eng.submit(p, max_new_tokens=n_new)
            for p in prompts[:eng.max_slots]]
    eng.step()
    eng.step()
    torch.cuda.synchronize()
    return reqs


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--label", required=True)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    os.chdir(root)
    import chip_smoke as cs
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    out = cs.phase_main_path(dev)
    eng = out[1]
    rs = onp.random.RandomState(0)
    lengths = cs.prompt_lengths(rs, [b for b in eng.buckets if b <= 512], 16)
    prompts = [rs.randint(0, 50257, n) for n in lengths]
    runs = [mix_run(eng, prompts) for _ in range(3)]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        profiled = mix_run(eng, prompts)
    device_ms = sum(e.time_range.elapsed_us() for e in prof.events()
                    if e.device_type == DeviceType.CUDA) / 1e3

    steps = 24
    reqs = live_slots(eng, prompts, steps + 8)
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    eng.run()
    reqs = live_slots(eng, prompts, 12)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            eng.step()
        torch.cuda.synchronize()
    calls = {}
    for e in prof.events():
        if e.name.startswith(("cuda", "cu")) \
                and e.name != "cudaDeviceSynchronize":
            calls[e.name] = calls.get(e.name, 0) + 1
    eng.run()
    assert all(r.finished for r in reqs)
    row = {"card": card, "runs": runs,
           "tokens_per_s": percentile([r["tokens_per_s"] for r in runs], 50),
           "ttft_p50_ms": percentile([r["ttft_p50_ms"] for r in runs], 50),
           "ttft_p99_ms": percentile([r["ttft_p99_ms"] for r in runs], 50),
           "tpot_p50_ms": percentile([r["tpot_p50_ms"] for r in runs], 50),
           "device_ms": device_ms,
           "device_busy_share": device_ms / (profiled["wall_s"] * 1e3),
           "decode_ms_per_step_8_live": step_ms,
           "host_calls_per_decode_step": {k: v / 4 for k, v in
                                          sorted(calls.items())},
           "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9}
    print(f"SERVE_AB {args.label} " + json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
