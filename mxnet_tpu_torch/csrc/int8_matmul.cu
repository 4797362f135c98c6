// Fused int8 quantize + matmul + epilogue for Hopper (sm_90a).
//
// Replaces the TPU kernel of mxnet_tpu/ops/pallas/quant_matmul.py:
//   _int8_kernel (launched by quantized_matmul).
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
// (M, K, N) = (4096, 768, 768) (query, key, value, out) the call must read
// x (12.6 MB fp32) and w (0.6 MB) and write out (12.6 MB): 25.8 MB,
// ~7.7 us at 3.35 TB/s, against 4.8 G int8 operations, ~2.4 us at the
// 1979 TOP/s dense int8 rate; (4096, 768, 3072) and (4096, 3072, 768)
// (ffn_1, ffn_2) move 65.3 MB (~19.5 us) for 19.3 G operations (~9.8 us).
//
// The design: two kernels behind one C entry point.
//   1. int8_prepare_kernel quantizes x once, by the rule above, into an s8
//      scratch (M, Kp), Kp = K rounded up to 16 so that rows lie on the
//      16-byte strides TMA needs, zero in the pad (zero adds nothing to an
//      exact sum, as the reference's own padding adds nothing). Where
//      K % 16 != 0 (or w does not start on 16 bytes) it also copies w into
//      an (N, Kp) scratch; otherwise the GEMM reads the caller's w. Each
//      thread takes 4 values of a row at a time, four such items in
//      flight, neighbouring threads on neighbouring items; x is read with
//      16-byte loads where the item lies on 16 bytes, else one value at a
//      time (x at any 4-byte offset works). It moves 5 bytes an x value.
//   2. int8_gemm_kernel, the persistent TMA-fed wgmma GEMM of
//      lowbit_gemm.cuh (shared with fp8_matmul.cu): one block an SM,
//      128 x BN output tiles in turn, columns fastest; a producer thread
//      keeps a ring of stages of 128 values of K (one 128-byte swizzle
//      row of each operand, both K-major as s8 wgmma requires: w (N, K)
//      needs no transpose) full with TMA loads; two consumer warpgroups
//      issue wgmma.m64nBNk32.s32.s8.s8 into int32 registers; the epilogue
//      (instantiated per activation and bias) stages the tile in the
//      128-byte swizzle and stores it with TMA where N % 4 == 0, else
//      straight from the registers. BN is 128 or 192, chosen per shape by
//      the waves of tiles over the SMs (tile_n below). Ragged M, N and K
//      are TMA's zero fill and the store's masking. No split-K, no
//      atomics: a second launch gives the same bits.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (device ms, torch.profiler,
// chip_smoke.py phase 12, bias): 0.0172 / 0.0397 / 0.0410 ms at (4096,
// 768, 768) / (4096, 768, 3072) / (4096, 3072, 768), 45-49% of the bound
// (281-487 TOP/s), of which the prepare pass 0.0076 / 0.0088 / 0.0223-
// 0.0226 (~2.7 TB/s at the third shape); 0.0098 at the pooler's (32, 768,
// 768) with tanh. The one-stage mma.sync kernel this replaces took 0.089 /
// 0.32 / 0.30 / 0.029, and quantize_int8 -> torch._int_mm -> epilogue
// takes 0.083 / 0.19 / 0.28 / 0.023. Tiles of 128 x 192 were faster than
// 128 x 128 at the three large shapes (0.0176 / 0.0398 / 0.0421 against
// 0.0202 / 0.0412 / 0.0478), 128 x 128 at the pooler's (0.0098 against
// 0.0110). Quantizing x inside the GEMM instead (fp32 tiles by TMA,
// converted by three producer warps into the s8 stage) was bit for bit
// but 3.3-5.4x slower: each x row tile is then quantized once per column
// tile, and the GEMM becomes conversion-bound.
//
// Plain C interface, bound from Python with ctypes: both launches go onto
// the caller's stream, allocate nothing and return cudaGetLastError().

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <initializer_list>

#include "hopper_gemm.cuh"
#include "lowbit_gemm.cuh"

namespace {

using Op = lowbit_gemm::S8;

constexpr int kPThreads = 256;  // prepare kernel
constexpr int kUnroll = 4;      // items in flight a prepare thread
constexpr int kKAlign = 16;     // Kp is a multiple of it

// One fp32 value to an int8 byte by the JAX rule (see the header).
__device__ __forceinline__ uint32_t to_s8(float v, float xs) {
  const int q = __float2int_rn(__fdiv_rn(v, xs));
  return static_cast<uint32_t>(min(max(q, -127), 127)) & 0xFFu;
}

// xq (M, Kp) = q(x / xs) and, where wq is not null, wq (N, Kp) = w, both
// zero in columns K..Kp-1. An item is 4 consecutive values of a row (one
// 32-bit word of the scratch); zero loaded into the pad quantizes to 0
// whatever xs is (0 / 0 is NaN, which converts to 0).
__global__ void __launch_bounds__(kPThreads)
    int8_prepare_kernel(const float* __restrict__ x,
                        const float* __restrict__ xs_ptr,
                        const uint8_t* __restrict__ w,
                        uint32_t* __restrict__ xq, uint32_t* __restrict__ wq,
                        int M, int N, int K, int Kp) {
  const int quads = Kp / 4;
  const long long x_items = static_cast<long long>(M) * quads;
  const long long stride = static_cast<long long>(gridDim.x) * kPThreads;
  const long long first =
      static_cast<long long>(blockIdx.x) * kPThreads + threadIdx.x;
  const float xs = *xs_ptr;
  for (long long i = first; i < x_items; i += kUnroll * stride) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long item = i + u * stride;
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (item < x_items) {
        const int r = static_cast<int>(item / quads);
        const int c =
            static_cast<int>(item - static_cast<long long>(r) * quads) * 4;
        const float* src = x + static_cast<size_t>(r) * K + c;
        if (c + 4 <= K && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
          v[u] = __ldcs(reinterpret_cast<const float4*>(src));
        } else {
          if (c < K) v[u].x = src[0];
          if (c + 1 < K) v[u].y = src[1];
          if (c + 2 < K) v[u].z = src[2];
          if (c + 3 < K) v[u].w = src[3];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long item = i + u * stride;
      if (item < x_items)
        xq[item] = to_s8(v[u].x, xs) | (to_s8(v[u].y, xs) << 8) |
                   (to_s8(v[u].z, xs) << 16) | (to_s8(v[u].w, xs) << 24);
    }
  }
  if (wq == nullptr) return;
  const long long w_items = static_cast<long long>(N) * quads;
  for (long long i = first; i < w_items; i += stride) {
    const int r = static_cast<int>(i / quads);
    const int c = static_cast<int>(i - static_cast<long long>(r) * quads) * 4;
    const uint8_t* src = w + static_cast<size_t>(r) * K + c;
    uint32_t q = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c + j < K) q |= static_cast<uint32_t>(src[j]) << (8 * j);
    wq[i] = q;
  }
}

template <int BN, bool TMA_STORE>
__global__ void __launch_bounds__(lowbit_gemm::kThreads, 1)
    int8_gemm_kernel(const __grid_constant__ CUtensorMap tm_a,
                     const __grid_constant__ CUtensorMap tm_b,
                     const __grid_constant__ CUtensorMap tm_c,
                     const float* __restrict__ ws,
                     const float* __restrict__ xs_ptr,
                     const float* __restrict__ bias, float* __restrict__ out,
                     int M, int N, int k_tiles, int act) {
  extern __shared__ uint8_t smem_raw[];
  lowbit_gemm::gemm<Op, BN, TMA_STORE>(smem_raw, &tm_a, &tm_b, &tm_c, ws,
                                       xs_ptr, bias, out, M, N, k_tiles,
                                       act);
}

// Columns of an output tile: the width whose tiles take the fewest
// tile-columns in the slowest block's walk (waves x BN), the wider on a
// tie (fewer tiles re-read x). Measured on the H100 at the BERT-base
// shapes: 192 at (4096, 768, 768), (4096, 768, 3072) and (4096, 3072,
// 768), 128 at (32, 768, 768), each the faster of the two there.
int tile_n(int M, int N) {
  const int sms = lowbit_gemm::sm_count();
  const long long rows = (M + lowbit_gemm::kBM - 1) / lowbit_gemm::kBM;
  long long best = -1;
  int pick = 192;
  for (int bn : {192, 128}) {
    const long long tiles = rows * ((N + bn - 1) / bn);
    const long long cost = (tiles + sms - 1) / sms * bn;
    if (best < 0 || cost < best) {
      best = cost;
      pick = bn;
    }
  }
  return pick;
}

template <int BN>
cudaError_t launch_gemm(const void* xq, const void* wt, const float* ws,
                        const float* xs, const float* bias, float* out, int M,
                        int N, int Kp, int act, cudaStream_t s) {
  CUtensorMap ta, tb, tc;
  if (!lowbit_gemm::encode_maps<Op, BN>(&ta, &tb, &tc,
                                        CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, xq,
                                        wt, out, M, N, Kp))
    return cudaErrorInvalidValue;
  const int k_tiles = (Kp + Op::kKElems - 1) / Op::kKElems;
  return N % 4 == 0
             ? lowbit_gemm::launch<BN, true, int8_gemm_kernel<BN, true>>(
                   ta, tb, tc, ws, xs, bias, out, M, N, k_tiles, act, s)
             : lowbit_gemm::launch<BN, false, int8_gemm_kernel<BN, false>>(
                   ta, tb, tc, ws, xs, bias, out, M, N, k_tiles, act, s);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

// x (M, K) fp32, w (N, K) int8, ws (N,) fp32, xs one fp32 on the device,
// bias (N,) fp32 or null, out (M, N) fp32 on 16 bytes, all contiguous; xq
// an (M, Kp) s8 scratch on 16 bytes, Kp = K rounded up to 16 (at least
// 16); wq an (N, Kp) s8 scratch on 16 bytes, or null where K == Kp and w
// lies on 16 bytes (the GEMM then reads w). act: 0 none, 1 relu,
// 2 sigmoid, 3 tanh, 4 gelu (tanh form). bn: the tile's columns, 128 or
// 192, or 0 for the rule of tile_n.
int int8_matmul(const void* x, const void* w, const void* ws, const void* xs,
                const void* bias, void* out, void* xq, void* wq, int M, int N,
                int K, int Kp, int act, int bn, void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || Kp < K || Kp < kKAlign ||
      Kp % kKAlign != 0 || act < quant_mma::kNone ||
      act > quant_mma::kGelu || (bn != 0 && bn != 128 && bn != 192) ||
      !aligned16(out) || !aligned16(xq) ||
      (wq != nullptr ? !aligned16(wq) : K != Kp || !aligned16(w)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto xsp = static_cast<const float*>(xs);
  const long long items = static_cast<long long>(M) * (Kp / 4);
  const long long w_items =
      wq != nullptr ? static_cast<long long>(N) * (Kp / 4) : 0;
  const long long per_thread = (items + kUnroll - 1) / kUnroll;
  const long long need =
      ((per_thread > w_items ? per_thread : w_items) + kPThreads - 1) /
      kPThreads;
  const long long wave = static_cast<long long>(lowbit_gemm::sm_count()) * 8;
  int8_prepare_kernel<<<static_cast<int>(need < wave ? need : wave),
                        kPThreads, 0, s>>>(
      static_cast<const float*>(x), xsp, static_cast<const uint8_t*>(w),
      static_cast<uint32_t*>(xq), static_cast<uint32_t*>(wq), M, N, K, Kp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const void* wt = wq != nullptr ? wq : w;
  auto wsp = static_cast<const float*>(ws);
  auto bp = static_cast<const float*>(bias);
  auto outp = static_cast<float*>(out);
  if (bn == 0) bn = tile_n(M, N);
  err = bn == 192
            ? launch_gemm<192>(xq, wt, wsp, xsp, bp, outp, M, N, Kp, act, s)
            : launch_gemm<128>(xq, wt, wsp, xsp, bp, outp, M, N, Kp, act, s);
  return static_cast<int>(err);
}

const char* int8_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
