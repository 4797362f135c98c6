// Flash-attention forward for Hopper (sm_90a), fp32 and bf16 inputs, on the
// tensor cores.
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas/flash_attention.py
// (_fwd -> _fwd_kernel, launched at :94, the forward of the public
// flash_attention), the same function: for each (batch*head, query row) it
// streams the keys in tiles with an online softmax,
//     s     = q k^T * scale, masked with -1e30 where k_pos >= seq_k or
//             (causal, top-left aligned) q_pos < k_pos
//     m_new = max(m, rowmax s),  p = exp(s - m_new),  corr = exp(m - m_new)
//     l     = corr l + rowsum(p)                     (p in fp32)
//     acc   = corr acc + p v    (p rounded to the input dtype first, as :54;
//                                fp32 accumulation)
// skips causal key tiles past the diagonal, and writes
//     out = acc / max(l, 1e-30)            (input dtype)
//     lse = m + log(max(l, 1e-30))         (fp32, one per row)
//
// What bounds it on the H100: at the training shape (b*h = 96, s = 1024,
// d = 64, causal) the call does 4*d flops per visible (q, k) pair, 12.9
// GFLOP, on 50.7 MB (fp32) of q, k, v, out and lse: bound by operations,
// 0.19 ms at the 67 TFLOP/s of plain fp32 FMAs or 0.078 ms at the rate
// this design uses for fp32, three TF32 products per product at 495
// TFLOP/s; in bf16 by bytes, 0.0076 ms of products at 989 TFLOP/s against
// 0.0151 ms to move its 25.4 MB at 3.35 TB/s. With one warp's 16 rows
// against a whole streamed tile, every K/V fragment read from shared
// memory feeds one product, so shared-memory bandwidth (bf16) and the
// instructions that split the K/V operands (fp32) come after the tensor
// cores, and mma.sync reaches only part of the rate that wgmma would.
//
// What the design does about it (the backward's, flash_mma.cuh):
//  - Every product is a tensor-core mma.sync: bf16 m16n8k16 with bf16
//    operands and fp32 accumulation fed by ldmatrix (.trans for V), fp32
//    m16n8k8 TF32 in the 3xTF32 split (flash_attention_bwd.cu's header
//    says why; one TF32 pass misses fp32 parity at 1e-4).
//  - Q resident, K/V streamed: a block of 4 warps owns 64 query rows, 16 a
//    warp; Q's A fragments are loaded once (fp32: split into hi/lo once,
//    always with the inf/NaN check) and kept in registers for the whole key
//    walk, except fp32 at d = 128, whose hi/lo fragments would spill beside
//    the accumulator: those blocks split Q from shared memory at each
//    k-step. K and V stream through a two-stage ring of 16-byte cp.async
//    copies (tile t+1 loads while tile t computes, one barrier a tile), 32
//    rows a tile in fp32, 64 in bf16 (the backward dQ kernel's rule).
//  - p never leaves registers: each warp turns its s accumulator fragments
//    straight into the A operand of p v. In bf16 that conversion is the
//    reference's rounding of p to the input dtype; l sums the fp32 p. Row
//    max and row sum reduce over the quad that shares a row (lanes 4g..4g+3
//    hold rows g and g+8); m, l and corr live in registers, and acc is
//    rescaled by corr in fp32.
//  - fp32 rounds as the plain version does, not only as accurately: s is
//    each k-step's three products summed from zero and added with fp32
//    adds (mma_rn), p = expf(s*scale - m) with each operation rounded on
//    its own, and each streamed tile's p v products are summed into a
//    zeroed partial that one fp32 add brings into acc (add_products): the
//    tensor core's fp32 accumulation is not round-to-nearest.
//  - inf and NaN: the integer TF32 rounding would turn the card's NaN
//    into -0, so each thread tests the K/V values it copied as a tile
//    lands, the tile's barrier ORs the flags, and from the first tile
//    holding an inf or NaN on, the block splits K and V with the check
//    (hi = 0, lo = x); Q and p always take it. The row max keeps NaN
//    (max.NaN), as the plain version's amax does.
//  - Masks by index, and only where a tile needs them: a warp-uniform
//    branch masks the scores of a tile that cuts the causal diagonal or
//    seq_k (one bit a score marks them, and their p is set to exactly 0);
//    testing every score on every tile was the first version's largest
//    cost after the products. Causal: key tiles past the block's last row
//    are never loaded, a warp whose rows all precede a tile skips its
//    products (a tile it cannot see leaves m, l and acc as they are), and
//    the heaviest query tiles launch first. Ragged tails: the copies
//    zero-fill rows past seq_q and seq_k, those keys are masked, rows past
//    seq_q are never stored; no padded copies.
// wgmma, TMA and warp specialisation are later work.
//
// Plain C interface, bound from Python with ctypes: the launch goes onto
// the caller's stream, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "device_once.cuh"
#include "flash_mma.cuh"

namespace {

using namespace flash_mma;

constexpr float kNegInf = -1e30f;

// whether Q's A fragments stay in registers: not fp32 at d = 128, whose
// hi/lo fragments (128 registers a thread) beside the accumulator (64)
// would spill
template <typename T, int D>
__host__ __device__ constexpr bool q_in_registers() {
  return !(sizeof(T) == sizeof(float) && D == 128);
}

template <typename T, int D>
constexpr size_t smem_bytes() {
  // Q, then the K, V ring
  return sizeof(T) * row_stride<T, D>() *
         (kRows + 2 * kStages * stream_rows<T, D, false>());
}

// max that keeps NaN, as the plain version's amax and the reference's
// jnp.max do (fmaxf returns the other operand)
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;\n" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// the max (kMax) or the sum of x over the quad of lanes that holds a row
template <bool kMax>
__device__ __forceinline__ float quad_reduce(float x) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, off);
    x = kMax ? max_nan(x, y) : x + y;
  }
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int seq_q, int seq_k,
                     int causal, float scale) {
  using F = Frag<T>;
  constexpr int kK = F::kK;
  constexpr int KS = D / kK;  // k-steps of q k^T
  constexpr bool kQReg = q_in_registers<T, D>();
  constexpr int BN = stream_rows<T, D, false>();  // key rows a tile
  constexpr int SD = row_stride<T, D>();
  constexpr int NT = BN / 8;  // n8 tiles of the warp's s (and p)
  constexpr int OT = D / 8;   // n8 tiles of its output
  constexpr int NJ = partial_tiles<T, D>();

  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);  // [kRows][SD]
  T* ks = qs + kRows * SD;             // [kStages][BN][SD]
  T* vs = ks + kStages * BN * SD;      // [kStages][BN][SD]

  const int tid = threadIdx.x, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = 16 * (tid >> 5);  // the warp's first query row in the tile
  const int bh = blockIdx.y;
  // causal: the last query tiles walk the most key tiles; they start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const size_t qoff = static_cast<size_t>(bh) * seq_q;
  const T* kb = k + static_cast<size_t>(bh) * seq_k * D;
  const T* vb = v + static_cast<size_t>(bh) * seq_k * D;

  int n_kt = (seq_k + BN - 1) / BN;
  if (causal) {
    // only key tiles starting at or before the tile's last real row
    const int last_row = min(q0 + kRows, seq_q) - 1;
    n_kt = min(n_kt, last_row / BN + 1);
  }
  auto prefetch = [&](int kt, int st) {
    copy_rows<T, D, BN>(ks + st * BN * SD, kb, kt * BN, seq_k, tid);
    copy_rows<T, D, BN>(vs + st * BN * SD, vb, kt * BN, seq_k, tid);
  };
  copy_rows<T, D, kRows>(qs, q + qoff * D, q0, seq_q, tid);
  prefetch(0, 0);
  cp_async_commit();

  // the statistics of the thread's rows wr + g and wr + g + 8
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[OT][4];
#pragma unroll
  for (int j = 0; j < OT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }
  typename F::A qa[kQReg ? KS : 1];

  bool checked = false;  // fp32: a K/V tile (or Q in shared memory) held
                         // an inf or NaN
  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt & 1;
    const T* kt_s = ks + st * BN * SD;
    const T* vt_s = vs + st * BN * SD;
    cp_async_wait_all();
    // tile kt landed; every warp is done with tile kt-1
    if constexpr (sizeof(T) == sizeof(float)) {
      bool bad = checked | copied_non_finite<D, BN>(kt_s, tid) |
                 copied_non_finite<D, BN>(vt_s, tid);
      if (!kQReg && kt == 0) bad |= copied_non_finite<D, kRows>(qs, tid);
      checked = __syncthreads_or(bad);
    } else {
      __syncthreads();
    }
    if constexpr (kQReg) {
      if (kt == 0) {
#pragma unroll
        for (int c = 0; c < KS; ++c)
          load_a<SD, true>(qa[c], qs, wr, c * kK, lane);
      }
    }
    if (kt + 1 < n_kt) prefetch(kt + 1, st ^ 1);
    cp_async_commit();
    const int k0 = kt * BN;
    // causal: the warp's rows all precede the tile; its -1e30 scores would
    // give corr = 1 and p = 0, leaving m, l and acc as they are
    if (causal && wr + 15 + q0 < k0) continue;

    with_split<T>(checked, [&](auto checked_split) {
      constexpr bool kChecked = decltype(checked_split)::value;
      // s = Q K^T for the warp's 16 queries
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      }
#pragma unroll
      for (int c = 0; c < KS; ++c) {
        typename F::A qf;
        if constexpr (kQReg) {
          qf = qa[c];
        } else {
          load_a<SD, kChecked>(qf, qs, wr, c * kK, lane);
        }
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          typename F::B kf[2];
          load_b_nt2<SD, kChecked>(kf, kt_s, 8 * j, c * kK, lane);
          mma_rn(s[j], qf, kf[0]);
          mma_rn(s[j + 1], qf, kf[1]);
        }
      }

      // element e of tile j is query q0 + wr + g + 8 (e / 2), key
      // k0 + 8 j + 2 t + e % 2. On a tile that cuts the causal diagonal or
      // seq_k, bit 4 j + e of `hidden` marks a masked score
      static_assert(NT * 4 <= 32, "one bit a score");
      const bool edge = (causal && k0 + BN - 1 > q0 + wr) || k0 + BN > seq_k;
      uint32_t hidden = 0;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = __fmul_rn(s[j][e], scale);
      }
      if (edge) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 8 * j + 2 * t + (e & 1);
            const int row = q0 + wr + g + 8 * (e >> 1);
            if (key >= seq_k || (causal && key > row)) {
              hidden |= 1u << (4 * j + e);
              s[j][e] = kNegInf;
            }
          }
        }
      }
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = max_nan(mx[e >> 1], s[j][e]);
      }
      float corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m_new = max_nan(m[h], quad_reduce<true>(mx[h]));
        corr[h] = expf(__fsub_rn(m[h], m_new));
        m[h] = m_new;
      }
      // p in place of s (exactly 0 where masked), and its row sums
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = expf(__fsub_rn(s[j][e], m[e >> 1]));
      }
      if (edge) {
#pragma unroll
        for (int i = 0; i < NT * 4; ++i) {
          if (hidden >> i & 1u) s[i / 4][i % 4] = 0.f;
        }
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[e >> 1] += s[j][e];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
        l[h] = __fadd_rn(__fmul_rn(corr[h], l[h]), quad_reduce<false>(sum[h]));
#pragma unroll
      for (int j = 0; j < OT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[j][e] = __fmul_rn(corr[e >> 1], acc[j][e]);
      }

      // acc += p V over the tile's keys
#pragma unroll
      for (int j0 = 0; j0 < OT; j0 += NJ)
        add_products<T, SD, NJ, kChecked>(acc, s, vt_s, j0, lane);
    });
  }
  cp_async_wait_all();

  float l_safe[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) l_safe[h] = max_nan(l[h], 1e-30f);
#pragma unroll
  for (int j = 0; j < OT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[j][e] = __fdiv_rn(acc[j][e], l_safe[e >> 1]);
  }
  store_rows<T, D>(out + qoff * D, acc, q0 + wr, seq_q, lane);
  if (t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + wr + g + 8 * h;
      if (row < seq_q) lse[qoff + row] = __fadd_rn(m[h], logf(l_safe[h]));
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int bh, int seq_q, int seq_k, int causal,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, D>();
  const cudaError_t attr = device_once::opt_in_smem<flash_fwd_kernel<T, D>>(
      static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((seq_q + kRows - 1) / kRows, bh);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), seq_q, seq_k, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v,
                       void* out, void* lse, int bh, int seq_q, int seq_k,
                       int d, int causal, float scale, cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch<T, 16>(q, k, v, out, lse, bh, seq_q, seq_k, causal,
                           scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, out, lse, bh, seq_q, seq_k, causal,
                           scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, lse, bh, seq_q, seq_k, causal,
                           scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, lse, bh, seq_q, seq_k, causal,
                            scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// q (bh, seq_q, d), k/v (bh, seq_k, d), out (bh, seq_q, d): contiguous, in
// the input dtype (0 = float32, 1 = bfloat16), q, k and v 16-byte aligned;
// lse (bh, seq_q) float32.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* out, void* lse, int bh, int seq_q, int seq_k,
                        int d, int causal, float scale, int dtype,
                        void* stream) {
  if (bh <= 0 || seq_q <= 0 || seq_k <= 0 || bh > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  // the 16-byte copies read q, k and v rows whole
  if (!(aligned16(q) && aligned16(k) && aligned16(v)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(dispatch_d<float>(q, k, v, out, lse, bh, seq_q,
                                              seq_k, d, causal, scale, s));
  if (dtype == 1)
    return static_cast<int>(dispatch_d<__nv_bfloat16>(
        q, k, v, out, lse, bh, seq_q, seq_k, d, causal, scale, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
