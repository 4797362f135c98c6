// Fused int8 quantize + matmul + epilogue for Hopper (sm_90a).
//
// Replaces the TPU kernel of mxnet_tpu/ops/pallas/quant_matmul.py:
//   int8_matmul_kernel <- _int8_kernel (launched by quantized_matmul).
// For x (M, K) fp32, w (N, K) int8, ws (N,) fp32, a scalar x_scale xs, an
// optional bias (N,) fp32 and an activation:
//   q   = int8(clamp(rint(x / xs), -127, 127))
//   acc = q @ w^T                     s8 x s8 products, int32 accumulator
//   out = act(float(acc) * (xs * ws[n]) + bias[n])            (M, N) fp32
// with the reference's arithmetic:
//   - x / xs is an IEEE division (__fdiv_rn), not a multiply by 1/xs;
//   - the value is converted first (__float2int_rn: round half to even,
//     +-inf saturated, NaN -> 0) and the int clamped after, so NaN gives 0
//     as the JAX cast does (clamping the float first with fminf/fmaxf
//     would turn NaN into +-127);
//   - the accumulator is exact: |acc| <= 127^2 K < 2^31 for K up to
//     133,143, far above any shape here;
//   - the epilogue keeps the association (xs * ws[n]) first, then acc *,
//     then + bias, each rounded on its own (no fused multiply-add), then
//     the activation (relu, sigmoid, tanh, or tanh-form gelu).
//
// What bounds it on the H100: bytes at the BERT-base inference shapes. For
// (M, K, N) = (4096, 768, 768) (query, key, value, out) the kernel must
// read x (12.6 MB fp32) and w (0.6 MB) and write out (12.6 MB): 25.8 MB,
// ~7.7 us at 3.35 TB/s, against 4.8 G int8 operations, ~2.4 us at the
// 1979 TOP/s dense int8 rate; (4096, 768, 3072) and (4096, 3072, 768)
// (ffn_1, ffn_2) move 65.3 MB (~19.5 us) for 19.3 G operations (~9.8 us).
//
// What the design does about it (a simple kernel that is right first;
// fp8_matmul.cu's quantize-once pass and TMA-fed wgmma GEMM, with the
// helpers of hopper_gemm.cuh, are the way to make it fast): each
// 256-thread block owns a 128 x 128 output tile and walks K
// in steps of 64. Per step it reads the fp32 x tile (16-byte loads where K
// and the pointers allow, else one value a thread), quantizes it in
// registers and stores the int8 bytes in shared memory next to the w tile,
// so x crosses device memory as fp32 once per column tile and never as an
// int8 copy. Eight warps, 2 x 4, each own 64 x 32 of the tile and issue
// mma.sync.m16n8k32.s32.s8.s8.s32 (A row-major from the x tile, B "col"
// straight from w's (N, K) rows: no transpose) into int32 registers.
// Blocks walk the column tiles of one row tile next to each other, so the
// re-reads of x come from L2. Ragged edges are zero-filled in shared
// memory (zero quantizes to zero and adds nothing) and masked at the
// store. Not yet done: a pipelined (cp.async / TMA) load, wgmma,
// quantizing each x row tile once for all its column tiles, and a
// persistent schedule.
//
// Plain C interface, bound from Python with ctypes: each launch goes onto
// the caller's stream, allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "quant_mma.cuh"

namespace {

using namespace quant_mma;

// One fp32 value to an int8 byte by the JAX rule (see the header).
__device__ __forceinline__ uint32_t to_s8(float v, float xs) {
  const int q = __float2int_rn(__fdiv_rn(v, xs));
  return static_cast<uint32_t>(min(max(q, -127), 127)) & 0xFFu;
}

__device__ __forceinline__ uint32_t quant4(float4 v, float xs) {
  return to_s8(v.x, xs) | (to_s8(v.y, xs) << 8) | (to_s8(v.z, xs) << 16) |
         (to_s8(v.w, xs) << 24);
}

__device__ __forceinline__ void mma(int (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Quantize the (kBM, kBK) x tile at (m0, k0) into shared memory.
template <bool VEC>
__device__ __forceinline__ void load_x(uint8_t* sa, const float* x, float xs,
                                       int m0, int k0, int M, int K) {
  if (VEC) {  // K % 16 == 0: a float4 is in range whole or not at all
#pragma unroll
    for (int p = 0; p < kBM * kBK / 4 / kThreads; ++p) {
      const int idx = p * kThreads + threadIdx.x;
      const int r = idx >> 4, c = (idx & 15) * 4;
      const int gm = m0 + r, gk = k0 + c;
      uint32_t q = 0;
      if (gm < M && gk < K)
        q = quant4(*reinterpret_cast<const float4*>(x + (size_t)gm * K + gk),
                   xs);
      *reinterpret_cast<uint32_t*>(sa + r * kLds + c) = q;
    }
  } else {
#pragma unroll 4
    for (int p = 0; p < kBM * kBK / kThreads; ++p) {
      const int idx = p * kThreads + threadIdx.x;
      const int r = idx >> 6, c = idx & 63;
      const int gm = m0 + r, gk = k0 + c;
      uint32_t q = 0;
      if (gm < M && gk < K) q = to_s8(x[(size_t)gm * K + gk], xs);
      sa[r * kLds + c] = static_cast<uint8_t>(q);
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    int8_matmul_kernel(const float* __restrict__ x,
                       const uint8_t* __restrict__ w,
                       const float* __restrict__ ws,
                       const float* __restrict__ xs_ptr,
                       const float* __restrict__ bias, float* __restrict__ out,
                       int M, int N, int K, int act) {
  __shared__ __align__(16) uint8_t sa[kBM * kLds];
  __shared__ __align__(16) uint8_t sb[kBN * kLds];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const float xs = *xs_ptr;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    load_x<VEC>(sa, x, xs, m0, k0, M, K);
    load_w<VEC>(sb, w, n0, k0, N, K);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint8_t* p = sa + (wm + i * 16 + g) * kLds + kk + t * 4;
        a[i][0] = *reinterpret_cast<const uint32_t*>(p);
        a[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kLds);
        a[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        a[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kLds + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint8_t* p = sb + (wn + j * 8 + g) * kLds + kk + t * 4;
        b[j][0] = *reinterpret_cast<const uint32_t*>(p);
        b[j][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }

  // epilogue: c0, c1 at (g, 2t), (g, 2t + 1); c2, c3 eight rows below
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = n0 + wn + j * 8 + t * 2 + e;
      if (col >= N) continue;
      const float s = __fmul_rn(xs, ws[col]);
      const float bn = bias != nullptr ? bias[col] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + wm + i * 16 + g + h * 8;
          if (row >= M) continue;
          float o = __fmul_rn(__int2float_rn(acc[i][j][h * 2 + e]), s);
          if (bias != nullptr) o = __fadd_rn(o, bn);
          out[(size_t)row * N + col] = activate(o, act);
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// x (M, K) fp32, w (N, K) int8, ws (N,) fp32, xs one fp32 on the device,
// bias (N,) fp32 or null, out (M, N) fp32, all contiguous. act: 0 none,
// 1 relu, 2 sigmoid, 3 tanh, 4 gelu (tanh form). vec = 1: K % 16 == 0 and
// x, w 16-byte aligned.
int int8_matmul(const void* x, const void* w, const void* ws, const void* xs,
                const void* bias, void* out, int M, int N, int K, int act,
                int vec, void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || act < kNone || act > kGelu ||
      (M + kBM - 1) / kBM > 65535 || (vec && K % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto xp = static_cast<const float*>(x);
  auto wp = static_cast<const uint8_t*>(w);
  auto wsp = static_cast<const float*>(ws);
  auto xsp = static_cast<const float*>(xs);
  auto bp = static_cast<const float*>(bias);
  auto op = static_cast<float*>(out);
  if (vec)
    int8_matmul_kernel<true>
        <<<grid, kThreads, 0, s>>>(xp, wp, wsp, xsp, bp, op, M, N, K, act);
  else
    int8_matmul_kernel<false>
        <<<grid, kThreads, 0, s>>>(xp, wp, wsp, xsp, bp, op, M, N, K, act);
  return static_cast<int>(cudaGetLastError());
}

const char* int8_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
