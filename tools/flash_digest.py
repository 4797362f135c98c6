"""Digests of the flash-attention kernels' outputs, to compare two trees bit
for bit on one card.

    python3 tools/flash_digest.py --root DIR --out FILE.json
    python3 tools/flash_digest.py --compare A.json B.json

The first form imports ``mxnet_tpu_torch`` from the checkout at ``--root``
(building its kernels there), runs the forward kernel and the two backward
kernels (dK/dV, dQ) on seeded inputs at four shapes (the GPT-2 training
shape b*h 96, s 1024, d 64, causal; 12 x 200 x 64 non-causal; 3 x 129 x
127 x 128 causal; 4 x 65 x 257 x 16 non-causal), fp32 and bf16, and writes
the sha256 of each output. The backward's inputs (lse and delta) come from
a float64 attention computed here, so they do not depend on the tree's
forward. The second form prints which digests differ and exits 1 if a
backward output does. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import math
import sys

import numpy as onp
import torch

SHAPES = [(96, 1024, 1024, 64, True), (12, 200, 200, 64, False),
          (3, 129, 127, 128, True), (4, 65, 257, 16, False)]


def _sha(t):
    return hashlib.sha256(t.contiguous().cpu().view(torch.uint8).numpy()
                          .tobytes()).hexdigest()


def _inputs(bh, sq, sk, d, causal, dtype, dev, seed):
    """q, k, v, do in ``dtype`` and float64 (lse, delta) as float32."""
    rs = onp.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rs.randn(bh, n, d).astype("float32"))
                   .to(dev, dtype) for n in (sq, sk, sk, sq))
    s = q.double() @ k.double().transpose(1, 2) / math.sqrt(d)
    if causal:
        valid = torch.ones(sq, sk, dtype=torch.bool, device=dev).tril()
        s = s.masked_fill(~valid, -math.inf)
    lse = torch.logsumexp(s, dim=-1, keepdim=True)
    out = torch.softmax(s, dim=-1) @ v.double()
    delta = (do.double() * out).sum(dim=-1, keepdim=True)
    return q, k, v, do, lse.float(), delta.float()


def digest(root):
    sys.path.insert(0, root)
    from mxnet_tpu_torch.ops import flash_attention as fa
    dev = torch.device("cuda", 0)
    out = {}
    for i, (bh, sq, sk, d, causal) in enumerate(SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do, lse, delta = _inputs(bh, sq, sk, d, causal, dtype,
                                              dev, seed=i)
            fwd_out, fwd_lse = fa.flash_attention_fwd(q, k, v, causal)
            dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                causal)
            dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal)
            torch.cuda.synchronize()
            key = f"bh={bh} sq={sq} sk={sk} d={d} causal={causal} " \
                  f"{str(dtype)[6:]}"
            out[key] = {"fwd_out": _sha(fwd_out), "fwd_lse": _sha(fwd_lse),
                        "dk": _sha(dk), "dv": _sha(dv), "dq": _sha(dq)}
    return out


def compare(a, b):
    """Print the outputs whose digests differ; 1 if a backward one does."""
    bad = 0
    for key in a:
        for name in a[key]:
            same = a[key][name] == b[key][name]
            if not same:
                print(f"{key} {name}: differs")
                bad |= not name.startswith("fwd")
    print("backward outputs " + ("DIFFER" if bad else "bit for bit equal"))
    return int(bad)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root")
    ap.add_argument("--out")
    ap.add_argument("--compare", nargs=2)
    args = ap.parse_args()
    if args.compare:
        a, b = (json.load(open(p)) for p in args.compare)
        sys.exit(compare(a, b))
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    with open(args.out, "w") as f:
        json.dump(digest(args.root), f, indent=1)


if __name__ == "__main__":
    main()
