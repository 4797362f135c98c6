// Fused fp8 quantize + matmul + epilogue for Hopper (sm_90a).
//
// Replaces the TPU kernel of mxnet_tpu/ops/pallas/quant_matmul.py:
//   fp8_matmul_kernel <- _fp8_kernel (launched by fp8_matmul).
// For x (M, K) fp32, w (N, K) fp8 (e4m3fn or e5m2), ws (N,) fp32, a scalar
// x_scale xs, an optional bias (N,) fp32 and an activation:
//   xq  = fp8(x / xs)                 in the activation's format (afmt)
//   acc = xq @ w^T                    fp8 x fp8 products, fp32 accumulator
//   out = act(acc * (xs * ws[n]) + bias[n])                 (M, N) fp32
// with the reference's arithmetic:
//   - x / xs is an IEEE division (__fdiv_rn), not a multiply by 1/xs;
//   - the cast rounds to nearest even and does NOT saturate: past the
//     format's top it gives NaN in e4m3fn (|v| > 464, which is 448 plus
//     half an ulp; the tie at 464 rounds down to 448) and +-inf in e5m2
//     (|v| >= 61440, where the tie rounds up), as the JAX cast
//     (ml_dtypes) does, while the hardware cvt and torch's .to() saturate;
//   - the epilogue keeps the association (xs * ws[n]) first, then acc *,
//     then + bias, each rounded on its own (no fused multiply-add), then
//     the activation (relu, sigmoid, tanh, or tanh-form gelu).
//
// What bounds it on the H100: bytes at the fp8 training shapes. For
// (M, K, N) = (8192, 768, 768) the kernel must read x (25.2 MB fp32) and
// write out (25.2 MB) for 9.7 GFLOP: ~15 us at 3.35 TB/s against ~5 us at
// the 1979 TFLOP/s fp8 rate; (8192, 768, 3072) and (8192, 3072, 768) move
// ~128 MB (~38 us) for 38.7 GFLOP (~20 us).
//
// What the design does about it (a simple kernel that is right first):
// each 256-thread block owns a 128 x 128 output tile and walks K in steps
// of 64. Per step it reads the fp32 x tile (16-byte loads where K and the
// pointers allow, else one value a thread), quantizes it in registers and
// stores the fp8 bytes in shared memory next to the fp8 w tile, so x
// crosses device memory as fp32 once per column tile and never as an fp8
// copy. Eight warps, 2 x 4, each own 64 x 32 of the tile and issue the
// fp8 tensor-core product mma.sync.m16n8k32 (A row-major from the x tile,
// B "col" straight from w's (N, K) rows: no transpose) into fp32
// registers. Shared-memory rows are padded to 80 bytes so the fragment
// loads are free of bank conflicts. Blocks walk the column tiles of one
// row tile next to each other, so the re-reads of x come from L2. Ragged
// edges are zero-filled in shared memory (zero is exact in the fp8 dot)
// and masked at the store. Not yet done: a pipelined (cp.async / TMA)
// load, wgmma, and a persistent schedule.
//
// Plain C interface, bound from Python with ctypes: each launch goes onto
// the caller's stream, allocates nothing and returns cudaGetLastError().

#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "quant_mma.cuh"

namespace {

using namespace quant_mma;

// One fp32 value to fp8 (fmt 0 = e4m3fn, 1 = e5m2) by the JAX rule.
template <int FMT>
__device__ __forceinline__ uint32_t to_fp8(float v) {
  uint32_t q = __nv_cvt_float_to_fp8(v, __NV_SATFINITE,
                                     FMT == 0 ? __NV_E4M3 : __NV_E5M2);
  const float a = fabsf(v);
  if (FMT == 0) {
    if (a > 464.f) q = 0x7Fu;  // NaN
  } else if (a >= 61440.f) {
    q = v < 0.f ? 0xFCu : 0x7Cu;  // -inf, +inf
  }
  return q;
}

template <int FMT>
__device__ __forceinline__ uint32_t quant4(float4 v, float xs) {
  return to_fp8<FMT>(__fdiv_rn(v.x, xs)) |
         (to_fp8<FMT>(__fdiv_rn(v.y, xs)) << 8) |
         (to_fp8<FMT>(__fdiv_rn(v.z, xs)) << 16) |
         (to_fp8<FMT>(__fdiv_rn(v.w, xs)) << 24);
}

template <int AF, int BF>
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
#define FP8_MMA(TA, TB)                                                    \
  asm volatile(                                                            \
      "mma.sync.aligned.m16n8k32.row.col.f32." TA "." TB                   \
      ".f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"       \
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])                     \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]))
  if constexpr (AF == 0 && BF == 0) {
    FP8_MMA("e4m3", "e4m3");
  } else if constexpr (AF == 0) {
    FP8_MMA("e4m3", "e5m2");
  } else if constexpr (BF == 0) {
    FP8_MMA("e5m2", "e4m3");
  } else {
    FP8_MMA("e5m2", "e5m2");
  }
#undef FP8_MMA
}

// Quantize the (kBM, kBK) x tile at (m0, k0) into shared memory.
template <int AF, bool VEC>
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
        q = quant4<AF>(
            *reinterpret_cast<const float4*>(x + (size_t)gm * K + gk), xs);
      *reinterpret_cast<uint32_t*>(sa + r * kLds + c) = q;
    }
  } else {
#pragma unroll 4
    for (int p = 0; p < kBM * kBK / kThreads; ++p) {
      const int idx = p * kThreads + threadIdx.x;
      const int r = idx >> 6, c = idx & 63;
      const int gm = m0 + r, gk = k0 + c;
      uint32_t q = 0;
      if (gm < M && gk < K) q = to_fp8<AF>(__fdiv_rn(x[(size_t)gm * K + gk], xs));
      sa[r * kLds + c] = static_cast<uint8_t>(q);
    }
  }
}

template <int AF, int BF, bool VEC>
__global__ void __launch_bounds__(kThreads)
    fp8_matmul_kernel(const float* __restrict__ x,
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

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    load_x<AF, VEC>(sa, x, xs, m0, k0, M, K);
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
        for (int j = 0; j < 4; ++j) mma<AF, BF>(acc[i][j], a[i], b[j]);
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
          float o = __fmul_rn(acc[i][j][h * 2 + e], s);
          if (bias != nullptr) o = __fadd_rn(o, bn);
          out[(size_t)row * N + col] = activate(o, act);
        }
      }
    }
  }
}

template <int AF, int BF>
cudaError_t launch(bool vec, const float* x, const uint8_t* w,
                   const float* ws, const float* xs, const float* bias,
                   float* out, int M, int N, int K, int act, cudaStream_t s) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  if (vec)
    fp8_matmul_kernel<AF, BF, true>
        <<<grid, kThreads, 0, s>>>(x, w, ws, xs, bias, out, M, N, K, act);
  else
    fp8_matmul_kernel<AF, BF, false>
        <<<grid, kThreads, 0, s>>>(x, w, ws, xs, bias, out, M, N, K, act);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (M, K) fp32, w (N, K) fp8 bytes, ws (N,) fp32, xs one fp32 on the
// device, bias (N,) fp32 or null, out (M, N) fp32, all contiguous.
// afmt / wfmt: 0 = e4m3fn, 1 = e5m2 (the activation's cast and w's
// storage); act: 0 none, 1 relu, 2 sigmoid, 3 tanh, 4 gelu (tanh form).
// vec = 1: K % 16 == 0 and x, w 16-byte aligned.
int fp8_matmul(const void* x, const void* w, const void* ws, const void* xs,
               const void* bias, void* out, int M, int N, int K, int afmt,
               int wfmt, int act, int vec, void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || afmt < 0 || afmt > 1 || wfmt < 0 ||
      wfmt > 1 || act < kNone || act > kGelu ||
      (M + kBM - 1) / kBM > 65535 || (vec && K % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto xp = static_cast<const float*>(x);
  auto wp = static_cast<const uint8_t*>(w);
  auto wsp = static_cast<const float*>(ws);
  auto xsp = static_cast<const float*>(xs);
  auto bp = static_cast<const float*>(bias);
  auto op = static_cast<float*>(out);
  cudaError_t err;
  if (afmt == 0 && wfmt == 0)
    err = launch<0, 0>(vec, xp, wp, wsp, xsp, bp, op, M, N, K, act, s);
  else if (afmt == 0)
    err = launch<0, 1>(vec, xp, wp, wsp, xsp, bp, op, M, N, K, act, s);
  else if (wfmt == 0)
    err = launch<1, 0>(vec, xp, wp, wsp, xsp, bp, op, M, N, K, act, s);
  else
    err = launch<1, 1>(vec, xp, wp, wsp, xsp, bp, op, M, N, K, act, s);
  return static_cast<int>(err);
}

const char* fp8_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
