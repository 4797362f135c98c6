// Pieces of the low-bit matmul kernels: the epilogue's activations (both
// fp8_matmul.cu and int8_matmul.cu), and the int8 kernel's 128 x 128 x 64
// block tile and copy of the (N, K) byte weight tile into shared memory.
//
// The int8 kernel feeds the m16n8k32 tensor-core product (s8 operands): a
// thread holds 4 consecutive bytes of a row of A (row g / g + 8, bytes 4t
// and 16 + 4t) and 4 consecutive bytes of a row of w (column g of B), with
// g = lane / 4 and t = lane % 4. Shared-memory rows are padded to kLds
// bytes so those 4-byte loads are free of bank conflicts.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace quant_mma {

constexpr int kBM = 128, kBN = 128, kBK = 64;
constexpr int kThreads = 256;
constexpr int kLds = kBK + 16;  // bytes per shared-memory row

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

// Copy the (kBN, kBK) byte tile of w (N, K) at (n0, k0) into shared memory,
// zero past the ragged edges. VEC: K % 16 == 0 and w 16-byte aligned.
template <bool VEC>
__device__ __forceinline__ void load_w(uint8_t* sb, const uint8_t* w, int n0,
                                       int k0, int N, int K) {
  if (VEC) {
#pragma unroll
    for (int p = 0; p < kBN * kBK / 16 / kThreads; ++p) {
      const int idx = p * kThreads + threadIdx.x;
      const int r = idx >> 2, c = (idx & 3) * 16;
      const int gn = n0 + r, gk = k0 + c;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (gn < N && gk < K)
        v = *reinterpret_cast<const uint4*>(w + (size_t)gn * K + gk);
      *reinterpret_cast<uint4*>(sb + r * kLds + c) = v;
    }
  } else {
#pragma unroll 4
    for (int p = 0; p < kBN * kBK / kThreads; ++p) {
      const int idx = p * kThreads + threadIdx.x;
      const int r = idx >> 6, c = idx & 63;
      const int gn = n0 + r, gk = k0 + c;
      sb[r * kLds + c] = (gn < N && gk < K) ? w[(size_t)gn * K + gk] : 0;
    }
  }
}

}  // namespace quant_mma
