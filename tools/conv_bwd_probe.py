"""Build kernel 8 (``csrc/conv_bwd.cu``) alone and hold it against its plain
version on the card, then time its CUDA kernels one by one at ResNet-50's
four stage shapes.

    python3 tools/conv_bwd_probe.py [--times]

Prints the compiler's register / spill report and the count of tensor-core
instructions (HMMA) of each kernel, each case's max|diff| / max|plain| of
dx and dw (limit 2e-4) with a second launch compared bit for bit, and with
``--times`` the device ms of each CUDA kernel of a call (``torch.profiler``,
three input sets in turn). Run from the repository root on a machine with
an NVIDIA H100; quicker than ``chip_smoke.py`` when only kernel 8 changed.
"""
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main():
    from mxnet_tpu_torch import _native
    from mxnet_tpu_torch.ops import conv_bwd as cb
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    lib = _native.build(["conv_bwd"])["conv_bwd"]
    for line in cs.ptxas_summary(_native.build_logs.get("conv_bwd", "")):
        print(line)
    print("HMMA:", cs.tensor_core_counts(lib, cs.conv_name, r"\bHMMA\."))
    gen = torch.Generator(device=dev).manual_seed(3)
    ok = True
    shapes = [(n, h, w, c, c) for (n, h, w, c) in cs.CONV_STAGES]
    for (n, h, w, c, o) in shapes + cs.CONV_EDGES:
        args = cs.conv_inputs(cb, dev, gen, n, h, w, c, o)
        dx, dw, _, _ = cb.fused_conv3x3_bn_relu_bwd(*args)
        again = cb.fused_conv3x3_bn_relu_bwd(*args)
        torch.cuda.synchronize()
        da, x, y, wt, gamma, beta, mean, var = args
        _, _, vec = cb.bwd_stats(da, y, gamma, beta, mean, var)
        pdx, pdw = cb.fused_conv3x3_bn_relu_bwd_plain(da, x, y, wt, vec)
        e = (cs.rel_err(dx, pdx), cs.rel_err(dw, pdw))
        same = torch.equal(again[0], dx) and torch.equal(again[1], dw)
        good = max(e) <= cs.CONV_TOL and same
        ok &= good
        print(f"N={n} H={h} W={w} C={c} O={o}: dx {e[0]:.3e} dw {e[1]:.3e} "
              f"repeat {'equal' if same else 'DIFFERS'} "
              f"{'ok' if good else 'FAIL'}", flush=True)
    if "--times" in sys.argv:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
        for (n, h, w, c, o) in shapes:
            sets = [cs.conv_inputs(cb, dev, gen, n, h, w, c, o)
                    for _ in range(3)]
            turn = [0]

            def call():
                turn[0] = (turn[0] + 1) % 3
                return cb.fused_conv3x3_bn_relu_bwd(*sets[turn[0]])
            total, top = cs.device_profile(call, 20, warmup=2, top=6,
                                           match="conv_bwd_")
            print(f"N={n} H={h} W={w} C=O={c}: CUDA kernels {total:.4f} ms: "
                  + ", ".join(f"{name.split('conv_bwd_')[1].split('(')[0]} "
                              f"{ms:.4f}" for name, ms in top), flush=True)
            del sets
    print("ALL OK" if ok else "FAILED")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
