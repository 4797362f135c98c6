"""Build the low-bit matmul kernels (``csrc/int8_matmul.cu`` and
``csrc/fp8_matmul.cu``, which share ``csrc/lowbit_gemm.cuh``) and hold them
against their plain versions on the card; with ``--times``, time the int8
kernel at the BERT-base shapes at each GEMM tile width.

    python3 tools/int8_matmul_probe.py [--times]

Prints the compiler's register / spill report, the count of ``wgmma``
instructions (IGMMA, HGMMA) of each GEMM kernel, chip_smoke.py's phases 2d
and 2e (every case of both kernels against its plain version, the int8
kernel at both tile widths) and the int8 prepare pass's s8 scratch against
``int8_operands_plain`` bit for bit. With ``--times``: at each BERT-base
shape and tile width (128 x 128, 128 x 192, and the kernel's own choice),
the device ms (``torch.profiler``, three input sets in turn) of the call,
of its prepare pass and of its GEMM, beside the bound and the
``quantize_int8`` -> ``torch._int_mm`` composition; then chip_smoke.py's
phase 10 (the fp8 kernel's times). Run from the repository root on a
machine with an NVIDIA H100; quicker than ``chip_smoke.py`` when only the
low-bit kernels changed.
"""
import itertools
import json
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def check_scratch(qm, dev, gen):
    """The prepare pass's s8 scratch (x, and w where K % 16 != 0) against
    int8_operands_plain, pad included, bit for bit."""
    ok = True
    for m, k, n, offset in ((37, 256, 130, True), (64, 200, 70, False),
                            (4096, 768, 768, False), (129, 784, 193, False)):
        x, wq, ws, xs, b = cs.int8_inputs(qm, dev, gen, m, k, n, offset)
        pxq, pwq = qm.int8_operands_plain(x, wq, xs)
        kp = pxq.shape[1]
        xq = torch.full((m, kp), 99, dtype=torch.int8, device=dev)
        wsc = (None if kp == k else
               torch.full((n, kp), 99, dtype=torch.int8, device=dev))
        out = torch.empty((m, n), device=dev)
        qm._int8_launch(x, wq, ws, qm._scale_tensor(xs, dev), b, None, out,
                        xq, wsc)
        torch.cuda.synchronize()
        same = torch.equal(xq, pxq) and (wsc is None or torch.equal(wsc, pwq))
        ok &= same
        print(f"  scratch M={m} K={k} N={n}{' offset x' if offset else ''}: "
              f"{'bit for bit' if same else 'DIFFERS'}", flush=True)
    return ok


def times(qm, dev, gen):
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    for (m, k, n) in cs.INT8_BERT_SHAPES:
        act = "tanh" if m == cs.BERT_BATCH else None
        sets = []
        for _ in range(3):
            x = torch.randn(m, k, device=dev, generator=gen)
            w = torch.randn(n, k, device=dev, generator=gen) * 0.05
            ws = w.abs().amax(dim=1) / 127
            wq = torch.round(w / ws[:, None]).clamp(-127, 127).to(torch.int8)
            xs = torch.tensor([x.abs().max().item() / 127], device=dev)
            sets.append((x, wq, ws, xs, torch.randn(n, device=dev,
                                                    generator=gen)))
        turn = itertools.cycle(sets)

        def kernel():
            x, wq, ws, xs, b = next(turn)
            return qm.quantized_matmul(x, wq, ws, xs, bias=b, act=act)

        def composition():
            x, wq, ws, xs, b = next(turn)
            acc = torch._int_mm(qm.quantize_int8(x, xs), wq.t())
            out = acc * (xs * ws) + b
            return out if act is None else torch.tanh(out)

        bound, by = cs.int8_bound_ms(m, k, n)
        row = {"bound_ms": bound, "bound_by": by}
        try:
            row["composition_ms"] = cs.device_ms(composition, 30)
        except RuntimeError:
            row["composition_ms"] = None
        for bn in (128, 192, 0):
            qm.quantized_matmul.tile_n = bn
            try:
                r = {part: cs.device_profile(kernel, 30, match=match)[0]
                     for part, match in (("ms", ""),
                                         ("prepare_ms", "int8_prepare"),
                                         ("gemm_ms", "int8_gemm"))}
                r["call_ms"] = cs.cuda_ms(kernel, 30)
            finally:
                qm.quantized_matmul.tile_n = 0
            r["ms"] = r["ms"] or r["call_ms"]  # the profiler saw nothing
            r["share_of_bound"] = bound / r["ms"]
            r["tops"] = 2 * m * n * k / (r["ms"] * 1e-3) / 1e12
            row[f"n{bn}" if bn else "auto"] = r
        print(f"int8_matmul (M, K, N) = ({m}, {k}, {n}) act={act} bias: "
              + json.dumps(row), flush=True)


def main():
    from mxnet_tpu_torch import _native
    from mxnet_tpu_torch.ops import quant_matmul as qm
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    libs = _native.build(["int8_matmul", "fp8_matmul"])
    for name in libs:
        for line in cs.ptxas_summary(_native.build_logs.get(name, "")):
            print(line)
    print("IGMMA:", cs.tensor_core_counts(libs["int8_matmul"],
                                          cs.int8_gemm_name, r"\bIGMMA\."))
    print("HGMMA:", cs.tensor_core_counts(libs["fp8_matmul"],
                                          cs.fp8_gemm_name, r"\bHGMMA\."))
    gen = torch.Generator(device=dev).manual_seed(11)
    ok = check_scratch(qm, dev, gen)
    print(json.dumps(cs.phase_int8_vs_plain(dev)))
    print(json.dumps(cs.phase_fp8_vs_plain(dev)))
    if "--times" in sys.argv:
        times(qm, dev, gen)
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip()
        cs.phase_fp8_times(dev, card)
    if not ok:
        sys.exit(1)


if __name__ == "__main__":
    main()
