"""Build the ln_residual kernels (``csrc/ln_residual.cu``) alone, hold them
against their plain versions on the card and, with ``--times``, time the
backward (kernel 5) at BERT-base's row width over a range of row counts.

    python3 tools/ln_residual_probe.py [--times] [--skip-check]

Prints the build time, the compiler's register / spill report of the
instantiations (and each one that spills), then chip_smoke.py's phase 2c
(every dtype, shape and mask case against the plain version, the repeats
bit for bit). With ``--times``: for n in ``LN_PROBE_ROWS`` (default 512,
4096, 16384, 65536) rows x D 768, p 0.1, the mask in x's dtype, fp32 and
bf16, the backward kernel's device ms (``torch.profiler``, twice, three
input sets in turn where they fit so that the working set exceeds the
50 MB L2), device kernels a call, its grid and its share of the bound;
then chip_smoke.py's phase 8. Run from the repository root on a machine
with an NVIDIA H100; quicker than ``chip_smoke.py`` when only these
kernels changed.
"""
import itertools
import os
import subprocess
import sys
import time

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def times(lr, dev, card):
    """The backward at each size of ``LN_PROBE_ROWS``: the kernel's device
    ms (mean of its profiled launches), device kernels a call, its grid
    and its share of the bound, fp32 and bf16."""
    gen = torch.Generator(device=dev).manual_seed(5)
    sizes = [int(v) for v in os.environ.get(
        "LN_PROBE_ROWS", f"512,{cs.LN_ROWS},16384,65536").split(",")]
    for n in sizes:
        for dtype in (torch.float32, torch.bfloat16):
            sets = []
            for _ in range(3 if n <= cs.LN_ROWS else 1):
                x, h, m, g, b, do = cs.ln_inputs(dev, gen, n, cs.LN_DIM,
                                                 cs.LN_P, dtype)
                _, mean, rstd = lr.ln_residual_fwd(x, h, m, g, b, cs.LN_P)
                sets.append((x, h, m, g, mean, rstd, do))
            turn = itertools.cycle(sets)

            def call():
                x, h, m, g, mean, rstd, do = next(turn)
                return lr.ln_residual_bwd(x, h, m, g, mean, rstd, do,
                                          cs.LN_P)

            bound, _ = cs.ln_bound_ms(n, cs.LN_DIM, dtype, dtype, "bwd")
            runs = [cs.device_kernels(call, 30, "ln_residual_bwd_kernel")
                    for _ in range(2)]
            blocks = lr._workspace_floats(
                n, cs.LN_DIM, lr._DTYPE_CODES[dtype], lr._MASK_KINDS[dtype],
                1) // (2 * cs.LN_DIM)
            print(f"bwd n={n} D={cs.LN_DIM} {str(dtype)[6:]} ({blocks} "
                  f"blocks) [{card}]: kernel "
                  + " / ".join(f"{ms:.4f}" for _, ms, _ in runs)
                  + f" ms, {runs[0][0]:g} kernels/call, bound {bound:.4f} "
                  f"ms ({bound / min(ms for _, ms, _ in runs):.0%})",
                  flush=True)


def main():
    check_only = "--times" not in sys.argv
    if not torch.cuda.is_available():
        cs.fail("needs an NVIDIA GPU")
    from mxnet_tpu_torch import _native
    from mxnet_tpu_torch.ops import ln_residual as lr
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    libs = _native.build(["ln_residual"])
    print(f"build seconds: {time.perf_counter() - t0:.1f}")
    log = _native.build_logs.get("ln_residual")
    if log is not None:
        for line in cs.ptxas_summary(log):
            print(line)
        for line in log.splitlines():
            if "error" in line or "warning" in line:
                print(f"  {line.strip()}")
        spills = cs.spill_bytes(log, cs.ln_kernel_name)
        print(f"largest spill stores: {spills}")
        name = None
        for line in log.splitlines():  # each instantiation that spills
            if "Compiling entry function" in line:
                name = line.split("'")[1]
            elif name and "spill stores" in line and \
                    not line.strip().startswith("0 bytes stack frame, 0"):
                print(f"  {name}: {line.strip()}")
    print(f"built {libs['ln_residual'].name}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    if "--skip-check" not in sys.argv:
        t0 = time.perf_counter()
        errs = cs.phase_ln_vs_plain(dev)
        print(f"phase 2c seconds: {time.perf_counter() - t0:.1f}; largest "
              f"errors {errs}", flush=True)
    if not check_only:
        times(lr, dev, card)
        cs.phase_ln_times(dev, card)
    print("probe ok")


if __name__ == "__main__":
    main()
