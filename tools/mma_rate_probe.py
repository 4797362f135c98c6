"""The card's rate of tensor-core ``mma.sync.m16n8k8`` TF32 products.

    python3 tools/mma_rate_probe.py

Builds a small kernel (``nvcc`` for sm_90a, into a temporary directory)
whose warps issue back-to-back m16n8k8 TF32 ``mma.sync`` into 8 (or 16)
independent accumulators from registers, at 4 to 16 warps an SM, and
prints mma per clock per SM and TFLOP/s (1024 multiply-adds an mma). The
ceiling a kernel built of these products can reach, beside the 495 TFLOP/s
TF32 peak of the data sheet (which ``wgmma`` reaches). Run from the
repository root on a machine with an NVIDIA H100.
"""
import ctypes
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

SRC = r"""
#include <cstdint>
template <int ACC>
__global__ void mma_loop(float* out, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1.0f + threadIdx.x * 1e-7f + i);
  for (int i = 0; i < 2; ++i) b[i] = __float_as_uint(0.5f + i);
  float c[ACC][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < ACC; ++k)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                   "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                   : "+f"(c[k][0]), "+f"(c[k][1]), "+f"(c[k][2]), "+f"(c[k][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
                     "r"(b[1]));
  }
  float s = 0.f;
  for (int k = 0; k < ACC; ++k) s += c[k][0] + c[k][1] + c[k][2] + c[k][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run(float* out, int acc, int blocks, int threads, int iters) {
  if (acc == 8) mma_loop<8><<<blocks, threads>>>(out, iters);
  else mma_loop<16><<<blocks, threads>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}
"""


def main():
    from mxnet_tpu_torch import _native
    tmp = tempfile.mkdtemp()
    src, lib = os.path.join(tmp, "mma.cu"), os.path.join(tmp, "mma.so")
    with open(src, "w") as f:
        f.write(SRC)
    subprocess.run([_native._nvcc(), *_native.NVCC_FLAGS, "-o", lib, src],
                   check=True, capture_output=True)
    so = ctypes.CDLL(lib)
    so.run.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = None
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    try:
        clock = float(smi.split(",")[-1].split()[0]) * 1e6
    except ValueError:
        pass
    iters = 4096
    for acc in (8, 16):
        for warps in (4, 8, 12, 16):
            threads = 32 * warps
            out = torch.empty(sms * threads, device="cuda")
            so.run(out.data_ptr(), acc, sms, threads, 16)
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            rc = so.run(out.data_ptr(), acc, sms, threads, iters)
            end.record()
            torch.cuda.synchronize()
            assert rc == 0, rc
            sec = start.elapsed_time(end) / 1e3
            mma = sms * warps * acc * iters
            per_clk = (f", {mma / sms / sec / clock:.3f} mma/clk/SM at "
                       f"{clock / 1e6:.0f} MHz" if clock else "")
            print(f"acc {acc} warps/SM {warps}: {sec * 1e3:.3f} ms, "
                  f"{mma * 2048 / sec / 1e12:.1f} TFLOP/s TF32{per_clk}",
                  flush=True)


if __name__ == "__main__":
    main()
