// The activations of the low-bit matmul kernels' epilogue (fp8_matmul.cu
// and int8_matmul.cu, through lowbit_gemm.cuh).
#pragma once

#include <cuda_runtime.h>

namespace quant_mma {

enum Act { kNone = 0, kRelu = 1, kSigmoid = 2, kTanh = 3, kGelu = 4 };

__device__ __forceinline__ float activate(float o, int act) {
  switch (act) {
    case kRelu:
      return o < 0.f ? 0.f : o;  // NaN passes through, as torch's relu
    case kSigmoid:
      return 1.f / (1.f + expf(-o));
    case kTanh:
      return tanhf(o);
    case kGelu:  // tanh form (jax.nn.gelu's default)
      return 0.5f * o *
             (1.f + tanhf(0.7978845608028654f * (o + 0.044715f * o * o * o)));
    default:
      return o;
  }
}

}  // namespace quant_mma
