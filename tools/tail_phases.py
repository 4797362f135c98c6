"""Run the operator tail's and sparse storage's phases of ``chip_smoke.py``
alone on the card.

    python tools/tail_phases.py

Builds the flash-attention kernels (the only hand-written kernels these
phases run), then runs phase 45 (the new ``npx`` ops on the card against
the CPU, ``npx.rnn``'s cuDNN route against its plain loop, the attention
entry on kernels 1-3 at BERT-base width), phase 46 (the 2 x 650 LSTM
language model, eager on both routes and hybridized beside the eager
runs' live graphs) and phase 47 (sparse storage: the LM with a row-sparse
embedding against its dense control, lazy against dense Adam on a
793,471 x 512 table, ``mx.nd``'s legacy names against the CPU and a CSR
dot at Criteo's width), each with ``chip_smoke.py``'s own checks, and
writes every reading to ``chiprun_out/tail_phases.json``. Needs one
H100; about 3 minutes with the builds.
"""
from __future__ import annotations

import gc
import json
import os
import subprocess
import sys

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
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    dev = torch.device("cuda", 0)
    out = {"card": card, "torch": torch.__version__,
           "cuda": torch.version.cuda}
    out["npx_tail"] = cs.timed("45", cs.phase_npx_tail, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    out["lstm_lm_train"] = cs.timed("46", cs.phase_lstm_lm, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    out["sparse_train"] = cs.timed("47", cs.phase_sparse, dev, card)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "tail_phases.json"),
              "w") as f:
        json.dump(out, f, indent=1, default=str)


if __name__ == "__main__":
    main()
