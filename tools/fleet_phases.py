"""Run the elastic fleets' phases of ``chip_smoke.py`` alone on the card.

    python tools/fleet_phases.py

Builds the flash-attention kernels (the only ones these phases run),
runs phase 3 (GPT-2 124M served at full width: the tokens and the e2e row
phase 44 compares with), phase 43 (four ranks on the card under
``FleetSupervisor``: degrade, restore, re-expand) and phase 44
(``ServeFleet``: crash, rolling update, bad canary, sole-replica
crash-and-rebuild, stall), each with ``chip_smoke.py``'s own checks, and
writes every reading to ``chiprun_out/fleet_phases.json``. Needs one
H100 and finishes within 900 seconds.
"""
from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main():
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: these phases need an "
                "NVIDIA GPU")
    from mxnet_tpu_torch import _native
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _native.build(["flash_attention_fwd", "flash_attention_bwd"])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    cs.check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    dev = torch.device("cuda", 0)
    net, eng, row, reqs, prompts, _ = cs.timed("3", cs.phase_main_path, dev)
    base = [r.generated for r in reqs]
    del net, eng, reqs
    gc.collect()
    torch.cuda.empty_cache()
    out = {"card": card, "serve": row}
    with tempfile.TemporaryDirectory(prefix="fleet_phases_") as root:
        cfg = cs.mesh_config(cs.dp_config())
        with open(os.path.join(root, "dp_config.json"), "w") as f:
            json.dump(cfg, f)
        out["gpt_fleet_drill_train"] = cs.timed(
            "43", cs.phase_gpt_fleet, dev, card, root, cfg)
        gc.collect()
        torch.cuda.empty_cache()
        out["serve_fleet"] = cs.timed("44", cs.phase_serve_fleet, dev, card,
                                      root, prompts, base, row)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "fleet_phases.json"),
              "w") as f:
        json.dump(out, f)
    print("FLEET_PHASES_OK", flush=True)


if __name__ == "__main__":
    main()
