// fp8 quantize + matmul + epilogue for Hopper (sm_90a).
//
// Replaces the TPU kernel of mxnet_tpu/ops/pallas/quant_matmul.py:
//   _fp8_kernel (launched by fp8_matmul).
// For x (M, K) fp32, w (N, K) fp8 (e4m3fn or e5m2), ws (N,) fp32, a scalar
// x_scale xs, an optional bias (N,) fp32 and an activation:
//   xq  = fp8(x / xs)                 in the activation's format (afmt)
//   acc = xq @ w^T                    exact fp8 products, fp32 sums
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
// What bounds it on the H100: bytes. At the GPT-2 fp8 training shapes
// (M, K, N) = (8192, 768, 768) the call must read x (25.2 MB fp32) and
// write out (25.2 MB): 15.2 us at 3.35 TB/s against 4.9 us of fp8
// products at 1979 TFLOP/s; (8192, 768, 3072) and (8192, 3072, 768) move
// ~128 MB (38.3 us) for 19.5 us of products.
//
// The design: two kernels behind one C entry point.
//   1. fp8_prepare_kernel quantizes x once, by the rule above, and writes
//      each fp8 value widened to f16 (exact: f16 holds every e4m3fn and
//      e5m2 value, NaN and inf included) into a scratch (M, Kp), Kp = K
//      rounded up to the GEMM's k-tile of 64, zero in the pad; it widens
//      w into an (N, Kp) scratch the same way. One index space of 8-value
//      chunks over both, walked by one wave of blocks; 16-byte loads where
//      a chunk lies in its row on 16 bytes.
//   2. fp8_gemm_kernel, the persistent GEMM of lowbit_gemm.cuh (shared
//      with int8_matmul.cu) at 128 x 128 output tiles: one block an SM,
//      tiles in turn, columns fastest, so that the blocks running together
//      share x's row tiles in L2; one producer thread keeps a ring of 5
//      stages full with TMA loads (x and w tiles of 64 values of K,
//      128-byte swizzle, mbarriers); two consumer warpgroups, 64 rows
//      each, issue wgmma.m64n128k16.f32.f16.f16 from the swizzled tiles
//      (both K-major: no transpose) into fp32 registers, keeping one
//      stage's products in flight while the previous stage is released;
//      setmaxnreg gives the consumers 232 registers and the producer 40.
//      The epilogue computes the reference's arithmetic from the
//      accumulators (instantiated per activation and bias, so that its
//      loop over the 64 values of a thread carries no branch), with each
//      column's xs * ws[n] and bias loaded before the main loop, stages
//      the tile in shared memory in the 128-byte swizzle and writes it
//      with TMA stores where N % 4 == 0 (rows on 16 bytes); otherwise
//      straight from the registers, a full 32-byte sector a row and 4
//      lanes (float2 where N is even). No split-K, no atomics: a second
//      launch gives the same bits.
//
// Why f16 products, and not fp8 wgmma: the card's fp8 wgmma sums its 32
// products with too few bits. Measured on an NVIDIA H100 80GB HBM3 (700 W)
// against the plain version at (8192, 3072, 768), the largest error was
// 7.2x / 15.9x / 26.4x the tolerance (2^-20 of sum |products| x |xs * ws|)
// with the partial sum promoted into fp32 registers after every 1 / 2 / 4
// k32 wgmma, and 42x at the worst ragged shape even after every one. The
// f16 wgmma, whose products of widened fp8 values are exact, reads at most
// 8.4e-8 of that sum (0.09x the tolerance) over a whole K of 3072 without
// any promotion. It runs at half the fp8 rate, and the widened copy of x
// costs 2 bytes a value instead of 1.
//
// Measured on the same card (device ms, torch.profiler, chip_smoke.py
// phase 10): the call takes 0.040-0.042 / 0.104 / 0.110-0.111 ms at the
// three shapes above, 34-39% of the bound, of which the prepare pass
// 0.016 / 0.018 / 0.052-0.054 (memory-bound at ~2.3-2.8 TB/s). In the
// GEMM the epilogue does not overlap the main loop; with the activation
// a runtime switch on each value it cost 3-19% more. Storer warps
// copying the staged tile, stores straight from the accumulators,
// staggered K walks, runs of consecutive tiles a block and L2 eviction
// hints were each measured no faster than the TMA store; ping-pong
// consumers (each owning whole tiles) were 8-9% slower at the first and
// third shapes, 2.6% faster at the second, and spilled; a 128 x 256 tile
// spilled. A ring of 5 stages (the most that fits beside the staged
// tile) and barrier waits that spin rather than suspend took 2-6% off.
//
// Plain C interface, bound from Python with ctypes: both launches go onto
// the caller's stream, allocate nothing and return cudaGetLastError().

#include <cuda.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "hopper_gemm.cuh"
#include "lowbit_gemm.cuh"

namespace {

constexpr int kBN = 128;        // columns of a tile
constexpr int kPThreads = 256;  // prepare kernel
using Op = lowbit_gemm::F16;

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

// The f16 bits of an fp8 value.
template <int FMT>
__device__ __forceinline__ uint32_t widen(uint32_t q) {
  return __nv_cvt_fp8_to_halfraw(static_cast<__nv_fp8_storage_t>(q),
                                 FMT == 0 ? __NV_E4M3 : __NV_E5M2)
      .x;
}

// xq (M, Kp) = f16(fp8(x / xs)) and wq (N, Kp) = f16(w), zero in columns
// K..Kp-1 (see the header).
template <int AF, int BF>
__global__ void __launch_bounds__(kPThreads)
    fp8_prepare_kernel(const float* __restrict__ x,
                       const float* __restrict__ xs_ptr,
                       const uint8_t* __restrict__ w,
                       uint16_t* __restrict__ xq, uint16_t* __restrict__ wq,
                       int M, int N, int K, int Kp) {
  const int chunks = Kp / 8;
  const long long x_items = static_cast<long long>(M) * chunks;
  const long long total = x_items + static_cast<long long>(N) * chunks;
  const float xs = *xs_ptr;
  for (long long i = static_cast<long long>(blockIdx.x) * kPThreads +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * kPThreads) {
    const bool is_x = i < x_items;
    const long long item = is_x ? i : i - x_items;
    const int r = static_cast<int>(item / chunks);
    const int c =
        static_cast<int>(item - static_cast<long long>(r) * chunks) * 8;
    uint32_t h[8];
    if (is_x) {
      const float* src = x + static_cast<size_t>(r) * K + c;
      float v[8];
      if (c + 8 <= K && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
        const float4 f0 = reinterpret_cast<const float4*>(src)[0];
        const float4 f1 = reinterpret_cast<const float4*>(src)[1];
        v[0] = f0.x;
        v[1] = f0.y;
        v[2] = f0.z;
        v[3] = f0.w;
        v[4] = f1.x;
        v[5] = f1.y;
        v[6] = f1.z;
        v[7] = f1.w;
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = c + j < K ? src[j] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
        h[j] = c + j < K ? widen<AF>(to_fp8<AF>(__fdiv_rn(v[j], xs))) : 0u;
    } else {
      const uint8_t* src = w + static_cast<size_t>(r) * K + c;
      uint32_t b[8];
      if (c + 8 <= K && (reinterpret_cast<uintptr_t>(src) & 7) == 0) {
        const uint2 u = *reinterpret_cast<const uint2*>(src);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          b[j] = ((j < 4 ? u.x : u.y) >> (8 * (j & 3))) & 0xFFu;
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = c + j < K ? src[j] : 0u;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) h[j] = c + j < K ? widen<BF>(b[j]) : 0u;
    }
    uint16_t* dst = (is_x ? xq : wq) + static_cast<size_t>(r) * Kp + c;
    *reinterpret_cast<uint4*>(dst) =
        make_uint4(h[0] | (h[1] << 16), h[2] | (h[3] << 16),
                   h[4] | (h[5] << 16), h[6] | (h[7] << 16));
  }
}

template <bool TMA_STORE>
__global__ void __launch_bounds__(lowbit_gemm::kThreads, 1)
    fp8_gemm_kernel(const __grid_constant__ CUtensorMap tm_a,
                    const __grid_constant__ CUtensorMap tm_b,
                    const __grid_constant__ CUtensorMap tm_c,
                    const float* __restrict__ ws,
                    const float* __restrict__ xs_ptr,
                    const float* __restrict__ bias, float* __restrict__ out,
                    int M, int N, int k_tiles, int act) {
  extern __shared__ uint8_t smem_raw[];
  lowbit_gemm::gemm<Op, kBN, TMA_STORE>(smem_raw, &tm_a, &tm_b, &tm_c, ws,
                                        xs_ptr, bias, out, M, N, k_tiles,
                                        act);
}

template <int AF, int BF>
void launch_prepare(const float* x, const float* xs, const uint8_t* w,
                    uint16_t* xq, uint16_t* wq, int M, int N, int K, int Kp,
                    cudaStream_t s) {
  const long long items = static_cast<long long>(M + N) * (Kp / 8);
  const long long wave =
      static_cast<long long>(lowbit_gemm::sm_count()) * 8;
  const long long need = (items + kPThreads - 1) / kPThreads;
  fp8_prepare_kernel<AF, BF>
      <<<static_cast<int>(need < wave ? need : wave), kPThreads, 0, s>>>(
          x, xs, w, xq, wq, M, N, K, Kp);
}

}  // namespace

extern "C" {

// x (M, K) fp32, w (N, K) fp8 bytes, ws (N,) fp32, xs one fp32 on the
// device, bias (N,) fp32 or null, out (M, N) fp32 on 16 bytes, all
// contiguous; xq (M, Kp) and wq (N, Kp) f16 scratch on 16 bytes, with Kp
// = K rounded up to 64 (at least 64). afmt / wfmt: 0 = e4m3fn, 1 = e5m2
// (the activation's cast and w's storage); act: 0 none, 1 relu, 2 sigmoid,
// 3 tanh, 4 gelu (tanh form).
int fp8_matmul(const void* x, const void* w, const void* ws, const void* xs,
               const void* bias, void* out, void* xq, void* wq, int M, int N,
               int K, int Kp, int afmt, int wfmt, int act, void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || Kp < K || Kp < Op::kKElems ||
      Kp % Op::kKElems != 0 || afmt < 0 || afmt > 1 || wfmt < 0 ||
      wfmt > 1 || act < quant_mma::kNone || act > quant_mma::kGelu ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(xq) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(wq) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto xp = static_cast<const float*>(x);
  auto xsp = static_cast<const float*>(xs);
  auto wp = static_cast<const uint8_t*>(w);
  auto xqp = static_cast<uint16_t*>(xq);
  auto wqp = static_cast<uint16_t*>(wq);
  if (afmt == 0 && wfmt == 0)
    launch_prepare<0, 0>(xp, xsp, wp, xqp, wqp, M, N, K, Kp, s);
  else if (afmt == 0)
    launch_prepare<0, 1>(xp, xsp, wp, xqp, wqp, M, N, K, Kp, s);
  else if (wfmt == 0)
    launch_prepare<1, 0>(xp, xsp, wp, xqp, wqp, M, N, K, Kp, s);
  else
    launch_prepare<1, 1>(xp, xsp, wp, xqp, wqp, M, N, K, Kp, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  CUtensorMap ta, tb, tc;
  auto outp = static_cast<float*>(out);
  if (!lowbit_gemm::encode_maps<Op, kBN>(&ta, &tb, &tc,
                                         CU_TENSOR_MAP_DATA_TYPE_UINT16, 2,
                                         xq, wq, outp, M, N, Kp))
    return static_cast<int>(cudaErrorInvalidValue);
  auto wsp = static_cast<const float*>(ws);
  auto bp = static_cast<const float*>(bias);
  const int k_tiles = Kp / Op::kKElems;
  err = N % 4 == 0
            ? lowbit_gemm::launch<kBN, true, fp8_gemm_kernel<true>>(
                  ta, tb, tc, wsp, xsp, bp, outp, M, N, k_tiles, act, s)
            : lowbit_gemm::launch<kBN, false, fp8_gemm_kernel<false>>(
                  ta, tb, tc, wsp, xsp, bp, outp, M, N, k_tiles, act, s);
  return static_cast<int>(err);
}

const char* fp8_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
