// Flash-attention backward for Hopper (sm_90a), fp32 and bf16 inputs: two
// kernels in one library, dK/dV and dQ, on the tensor cores.
//
// Replaces the TPU kernels of mxnet_tpu/ops/pallas/flash_attention.py
// (_flash_bwd): _bwd_dkv_kernel (launched at :252) and _bwd_dq_kernel
// (launched at :275), with the recompute math of _bwd_block:
//     s     = q k^T * scale, masked where q_pos >= seq_q, k_pos >= seq_k or
//             (causal, top-left aligned) q_pos < k_pos
//     p     = exp(s - lse) where valid, else exactly 0
//     dp    = do v^T
//     ds    = p * (dp - delta) * scale      (delta = rowsum(do * out), fp32)
//     dV    = p^T do     (p rounded to the input dtype first, as :177)
//     dK    = ds^T q     (ds rounded to the input dtype first, as :180)
//     dQ    = ds k       (ds rounded to the input dtype first, as :208)
// Accumulation is fp32; the outputs are written once in the input dtype.
//
// What bounds them on the H100: at the training shape (b*h = 96, s = 1024,
// d = 64, causal) dK/dV does 8*d flops per visible (q, k) pair (s and dp
// recomputed, then dV and dK): 25.8 GFLOP; dQ does 6*d (s, dp, dQ): 19.3
// GFLOP. They move ~0.15 GB and ~0.13 GB (fp32), so both are bound by
// operations: in bf16 0.026 / 0.020 ms at 989 TFLOP/s; in fp32 0.385 /
// 0.289 ms at the 67 TFLOP/s of plain fp32 FMAs, or 0.156 / 0.117 ms at
// the rate this design uses for fp32, three TF32 products per product at
// 495 TFLOP/s. With one warp's 16 rows against a whole streamed tile,
// every operand fragment read from shared memory feeds one product, so
// shared-memory bandwidth (bf16) and the instructions that split the
// operands (fp32) come next after the tensor cores, and mma.sync reaches
// only part of the rate that wgmma would.
//
// What the design does about it:
//  - Every product is a tensor-core mma.sync. bf16: m16n8k16 with bf16
//    operands and fp32 accumulation, operands fed by ldmatrix (.trans for
//    the transposed ones): the reference's "input-dtype operands, fp32
//    accumulate". fp32: m16n8k8 TF32 in the 3xTF32 split. Each operand is
//    split once as it enters registers, hi = cvt.rna.tf32(x), lo =
//    cvt.rna.tf32(x - hi) (the rounding written as two integer operations:
//    bit for bit the instruction's on finite values), and each
//    product is three mma, lo*hi + hi*lo + hi*hi, small terms first; only
//    lo*lo (~2^-22 of |x y|) is dropped. Plain TF32 (11 bits) misses fp32
//    parity at 1e-4; the split keeps about 21 bits of each product
//    (tests/test_torch_flash_tf32_split.py emulates it against float64).
//    The tensor core does not round its fp32 accumulation to nearest, and
//    that error grows with the number of mma summed into one register. So
//    fp32 sums each k-step's three s and dp products from zero and adds
//    them with fp32 adds (mma_rn: p and ds then stay within an ulp or two
//    of the plain version's, which fp8 and int8 roundings downstream
//    need), and sums each streamed tile's dV/dK/dQ products into a zeroed
//    partial added with one fp32 add (add_products: a 1024-query sum is
//    otherwise 3 x 128 mma deep). p is exp(s * scale - lse) rounded as
//    the plain version rounds it (p_of).
//  - inf and NaN: the integer rounding would turn the card's NaN
//    (0x7FFFFFFF) into -0, and cvt.rna's inf split (inf, NaN) makes
//    inf * y NaN, so the checked split sends an inf or NaN x as hi = 0,
//    lo = x. The check costs three instructions a split (+36-40% fp32
//    time on the H100 when every split takes it), so each thread tests
//    the values it copied as a tile lands (x * 0 is NaN only for them),
//    the tile's barrier ORs the flags (__syncthreads_or), and from the
//    first tile holding an inf or NaN on, the block splits with the
//    check. p and ds, made in registers, always take it.
//  - p and ds never leave registers: each warp owns 16 rows (key rows in
//    dK/dV, query rows in dQ), computes its rows of s^T/dp^T (or s/dp)
//    against the streamed tile, and turns those accumulator fragments
//    straight into the A operands of dV += p^T do, dK += ds^T q (or
//    dQ += ds k). In bf16 that is the rounding to the input dtype; in fp32
//    the k index of the second product is permuted to match the
//    accumulator layout, and the B operand is read in the same order.
//  - Asynchronous tile ring: dK/dV keeps one block's K/V tile resident and
//    streams Q, dO, lse and delta; dQ keeps Q/dO resident and streams K/V.
//    Two stages of 16-byte cp.async copies: tile t+1 loads while tile t
//    computes, one __syncthreads() a tile. Blocks of 4 warps own 64 rows;
//    streamed tiles are 32 rows in fp32 (three blocks an SM) and 64 in
//    bf16 (stream_rows). Shared rows are padded by 16 bytes, which makes
//    ldmatrix (bf16) and the fp32 fragment loads free of bank conflicts.
//  - The TPU kernels carry their accumulators across a sequential grid
//    axis; Hopper runs blocks in no order, so that axis is the loop inside
//    one block, and the two-kernel split needs no atomics: repeated
//    launches are bit-identical. Causal tiles wholly above the diagonal
//    are skipped, and the heaviest tiles launch first. Ragged tails are
//    masked by index: rows past seq_q / seq_k are zero-filled by the copy,
//    get p = ds = 0 and are never stored; no padded copies are made. Every
//    key row below seq_k of dK/dV is written, zeros included.
// wgmma, TMA and warp specialisation are later work.
//
// Plain C interface, bound from Python with ctypes: each launch goes onto
// the caller's stream, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "flash_mma.cuh"

namespace {

using namespace flash_mma;

template <typename T, int D, bool kDkv>
constexpr size_t smem_bytes() {
  constexpr int BN = stream_rows<T, D, kDkv>();
  // dK/dV: lse and delta of each stage, then K, V and the Q, dO ring;
  // dQ: Q, dO and the K, V ring (its lse and delta live in registers)
  return (kDkv ? sizeof(float) * kStages * 2 * BN : 0) +
         sizeof(T) * row_stride<T, D>() * (2 * kRows + 2 * kStages * BN);
}

// n fp32 values of a row vector from row0, zero past seq
__device__ __forceinline__ void copy_vec(float* dst, const float* src,
                                         int row0, int seq, int n, int tid) {
  for (int i = tid; i < n; i += kThreads) {
    const bool ok = row0 + i < seq;
    cp_async4(dst + i, src + (ok ? row0 + i : 0), ok);
  }
}

// p = exp(s * scale - lse), each operation rounded on its own as the
// reference and the plain version compute it (no fused multiply-add, no
// exp2 with log2(e) folded in): a p that differs by an ulp or two moves
// fp8 and int8 roundings downstream
__device__ __forceinline__ float p_of(float s, float scale, float lse) {
  return expf(__fsub_rn(__fmul_rn(s, scale), lse));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv, int seq_q,
                         int seq_k, int causal, float scale) {
  using F = Frag<T>;
  constexpr int kK = F::kK;
  constexpr int BN = stream_rows<T, D, true>();  // query rows a tile
  constexpr int SD = row_stride<T, D>();
  constexpr int NT = BN / 8;  // n8 tiles of the warp's s^T and dp^T
  constexpr int OT = D / 8;   // n8 tiles of its dK and dV
  constexpr int NJ = partial_tiles<T, D>();

  extern __shared__ __align__(16) unsigned char smem[];
  float* rows = reinterpret_cast<float*>(smem);  // [kStages][lse, delta][BN]
  T* ks = reinterpret_cast<T*>(rows + kStages * 2 * BN);  // [kRows][SD]
  T* vs = ks + kRows * SD;                                 // [kRows][SD]
  T* qs = vs + kRows * SD;            // [kStages][BN][SD]
  T* dos = qs + kStages * BN * SD;    // [kStages][BN][SD]

  const int tid = threadIdx.x, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = 16 * (tid >> 5);  // the warp's first key row in the tile
  const int bh = blockIdx.y;
  // causal: the first key tiles see the most query tiles; they start first
  const int k0 = blockIdx.x * kRows;
  const T* qb = q + static_cast<size_t>(bh) * seq_q * D;
  const T* dob = dout + static_cast<size_t>(bh) * seq_q * D;
  const float* lseb = lse + static_cast<size_t>(bh) * seq_q;
  const float* delb = delta + static_cast<size_t>(bh) * seq_q;

  const int n_qt = (seq_q + BN - 1) / BN;
  // causal: query tiles wholly above the key tile's first key see none of
  // it (every q_pos < k0); k0 is a multiple of BN, so the first tile that
  // reaches the diagonal is k0 / BN, whatever seq_q and seq_k are
  const int qt0 = causal ? k0 / BN : 0;
  auto prefetch = [&](int qt, int st) {
    copy_rows<T, D, BN>(qs + st * BN * SD, qb, qt * BN, seq_q, tid);
    copy_rows<T, D, BN>(dos + st * BN * SD, dob, qt * BN, seq_q, tid);
    copy_vec(rows + st * 2 * BN, lseb, qt * BN, seq_q, BN, tid);
    copy_vec(rows + st * 2 * BN + BN, delb, qt * BN, seq_q, BN, tid);
  };
  if (qt0 < n_qt) {
    const size_t koff = static_cast<size_t>(bh) * seq_k * D;
    copy_rows<T, D, kRows>(ks, k + koff, k0, seq_k, tid);
    copy_rows<T, D, kRows>(vs, v + koff, k0, seq_k, tid);
    prefetch(qt0, 0);
  }
  cp_async_commit();

  float acc_dk[OT][4], acc_dv[OT][4];
#pragma unroll
  for (int j = 0; j < OT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[j][e] = acc_dv[j][e] = 0.f;
  }

  bool checked = false;  // fp32: K, V or a Q/dO tile held an inf or NaN
  for (int qt = qt0; qt < n_qt; ++qt) {
    const int st = (qt - qt0) & 1;
    const T* qt_s = qs + st * BN * SD;
    const T* dot_s = dos + st * BN * SD;
    cp_async_wait_all();
    // tile qt landed; every warp is done with tile qt-1
    if constexpr (sizeof(T) == sizeof(float)) {
      bool bad = checked | copied_non_finite<D, BN>(qt_s, tid) |
                 copied_non_finite<D, BN>(dot_s, tid);
      if (qt == qt0)
        bad |= copied_non_finite<D, kRows>(ks, tid) |
               copied_non_finite<D, kRows>(vs, tid);
      checked = __syncthreads_or(bad);
    } else {
      __syncthreads();
    }
    if (qt + 1 < n_qt) prefetch(qt + 1, st ^ 1);
    cp_async_commit();
    const float* lse_s = rows + st * 2 * BN;
    const float* del_s = lse_s + BN;
    const int q0 = qt * BN;

    with_split<T>(checked, [&](auto checked_split) {
      constexpr bool kChecked = decltype(checked_split)::value;
      // s^T = K Q^T and dp^T = V dO^T for the warp's 16 keys
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      }
#pragma unroll
      for (int c0 = 0; c0 < D; c0 += kK) {
        typename F::A ka, va;
        load_a<SD, kChecked>(ka, ks, wr, c0, lane);
        load_a<SD, kChecked>(va, vs, wr, c0, lane);
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          typename F::B qf[2], of[2];
          load_b_nt2<SD, kChecked>(qf, qt_s, 8 * j, c0, lane);
          load_b_nt2<SD, kChecked>(of, dot_s, 8 * j, c0, lane);
          mma_rn(s[j], ka, qf[0]);
          mma_rn(s[j + 1], ka, qf[1]);
          mma_rn(dp[j], va, of[0]);
          mma_rn(dp[j + 1], va, of[1]);
        }
      }

      // p^T and ds^T in place: element e of tile j is key k0 + wr + g +
      // 8 (e / 2), query q0 + 8 j + 2 t + e % 2
      const bool edge = (causal && q0 < k0 + kRows) || q0 + BN > seq_q ||
                        k0 + kRows > seq_k;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = 8 * j + 2 * t + (e & 1);
          const int key = k0 + wr + g + 8 * (e >> 1);
          const bool ok = !edge || (q0 + qc < seq_q && key < seq_k &&
                                    (!causal || q0 + qc >= key));
          const float p = ok ? p_of(s[j][e], scale, lse_s[qc]) : 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - del_s[qc]) * scale;
        }
      }

      // dV += p^T dO, dK += ds^T Q over the tile's queries
#pragma unroll
      for (int j0 = 0; j0 < OT; j0 += NJ)
        add_products<T, SD, NJ, kChecked>(acc_dv, s, dot_s, j0, lane);
#pragma unroll
      for (int j0 = 0; j0 < OT; j0 += NJ)
        add_products<T, SD, NJ, kChecked>(acc_dk, dp, qt_s, j0, lane);
    });
  }
  cp_async_wait_all();

  // every key row below seq_k is written, zeros included (a causal key
  // tile that no query reaches)
  const size_t koff = static_cast<size_t>(bh) * seq_k * D;
  store_rows<T, D>(dk + koff, acc_dk, k0 + wr, seq_k, lane);
  store_rows<T, D>(dv + koff, acc_dv, k0 + wr, seq_k, lane);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        T* __restrict__ dq, int seq_q, int seq_k, int causal,
                        float scale) {
  using F = Frag<T>;
  constexpr int kK = F::kK;
  constexpr int BN = stream_rows<T, D, false>();  // key rows a tile
  constexpr int SD = row_stride<T, D>();
  constexpr int NT = BN / 8;  // n8 tiles of the warp's s and dp
  constexpr int OT = D / 8;   // n8 tiles of its dQ
  constexpr int NJ = partial_tiles<T, D>();

  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);  // [kRows][SD]
  T* dos = qs + kRows * SD;            // [kRows][SD]
  T* ks = dos + kRows * SD;            // [kStages][BN][SD]
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
  copy_rows<T, D, kRows>(dos, dout + qoff * D, q0, seq_q, tid);
  prefetch(0, 0);
  cp_async_commit();

  // lse and delta of the thread's two query rows
  float lse_r[2], del[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + wr + g + 8 * h;
    lse_r[h] = row < seq_q ? lse[qoff + row] : 0.f;
    del[h] = row < seq_q ? delta[qoff + row] : 0.f;
  }

  float acc[OT][4];
#pragma unroll
  for (int j = 0; j < OT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }

  bool checked = false;  // fp32: Q, dO or a K/V tile held an inf or NaN
  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt & 1;
    const T* kt_s = ks + st * BN * SD;
    const T* vt_s = vs + st * BN * SD;
    cp_async_wait_all();
    // tile kt landed; every warp is done with tile kt-1
    if constexpr (sizeof(T) == sizeof(float)) {
      bool bad = checked | copied_non_finite<D, BN>(kt_s, tid) |
                 copied_non_finite<D, BN>(vt_s, tid);
      if (kt == 0)
        bad |= copied_non_finite<D, kRows>(qs, tid) |
               copied_non_finite<D, kRows>(dos, tid);
      checked = __syncthreads_or(bad);
    } else {
      __syncthreads();
    }
    if (kt + 1 < n_kt) prefetch(kt + 1, st ^ 1);
    cp_async_commit();
    const int k0 = kt * BN;

    with_split<T>(checked, [&](auto checked_split) {
      constexpr bool kChecked = decltype(checked_split)::value;
      // s = Q K^T and dp = dO V^T for the warp's 16 queries
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      }
#pragma unroll
      for (int c0 = 0; c0 < D; c0 += kK) {
        typename F::A qa, oa;
        load_a<SD, kChecked>(qa, qs, wr, c0, lane);
        load_a<SD, kChecked>(oa, dos, wr, c0, lane);
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          typename F::B kf[2], vf[2];
          load_b_nt2<SD, kChecked>(kf, kt_s, 8 * j, c0, lane);
          load_b_nt2<SD, kChecked>(vf, vt_s, 8 * j, c0, lane);
          mma_rn(s[j], qa, kf[0]);
          mma_rn(s[j + 1], qa, kf[1]);
          mma_rn(dp[j], oa, vf[0]);
          mma_rn(dp[j + 1], oa, vf[1]);
        }
      }

      // ds in place of dp: element e of tile j is query q0 + wr + g +
      // 8 (e / 2), key k0 + 8 j + 2 t + e % 2
      const bool edge = (causal && k0 + BN > q0) || q0 + kRows > seq_q ||
                        k0 + BN > seq_k;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const int row = q0 + wr + g + 8 * h;
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          const bool ok = !edge || (row < seq_q && key < seq_k &&
                                    (!causal || row >= key));
          const float p = ok ? p_of(s[j][e], scale, lse_r[h]) : 0.f;
          dp[j][e] = p * (dp[j][e] - del[h]) * scale;
        }
      }

      // dQ += ds K over the tile's keys
#pragma unroll
      for (int j0 = 0; j0 < OT; j0 += NJ)
        add_products<T, SD, NJ, kChecked>(acc, dp, kt_s, j0, lane);
    });
  }
  cp_async_wait_all();

  store_rows<T, D>(dq + qoff * D, acc, q0 + wr, seq_q, lane);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* d0;  // dK (dK/dV) or dQ (dQ)
  void* d1;  // dV (dK/dV)
  int bh, seq_q, seq_k, causal;
  float scale;
  cudaStream_t stream;
};

// above 48 KB a block's dynamic shared memory has to be opted into; once
// per instantiation (a function-local static initialises once)
template <typename K>
cudaError_t opt_in(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a) {
  constexpr size_t smem = smem_bytes<T, D, true>();
  static const cudaError_t attr = opt_in(flash_bwd_dkv_kernel<T, D>, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.seq_k + kRows - 1) / kRows, a.bh);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.d0), static_cast<T*>(a.d1), a.seq_q,
      a.seq_k, a.causal, a.scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const Args& a) {
  constexpr size_t smem = smem_bytes<T, D, false>();
  static const cudaError_t attr = opt_in(flash_bwd_dq_kernel<T, D>, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.seq_q + kRows - 1) / kRows, a.bh);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.d0), a.seq_q, a.seq_k, a.causal, a.scale);
  return cudaGetLastError();
}

template <typename T, bool kDkv>
cudaError_t dispatch_d(const Args& a, int d) {
  switch (d) {
    case 16:
      return kDkv ? launch_dkv<T, 16>(a) : launch_dq<T, 16>(a);
    case 32:
      return kDkv ? launch_dkv<T, 32>(a) : launch_dq<T, 32>(a);
    case 64:
      return kDkv ? launch_dkv<T, 64>(a) : launch_dq<T, 64>(a);
    case 128:
      return kDkv ? launch_dkv<T, 128>(a) : launch_dq<T, 128>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <bool kDkv>
int dispatch(const Args& a, int d, int dtype) {
  if (a.bh <= 0 || a.seq_q <= 0 || a.seq_k <= 0 || a.bh > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  // the 16-byte copies read q, k, v and dout rows whole
  if (!(aligned16(a.q) && aligned16(a.k) && aligned16(a.v) &&
        aligned16(a.dout)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (dtype == 0) return static_cast<int>(dispatch_d<float, kDkv>(a, d));
  if (dtype == 1)
    return static_cast<int>(dispatch_d<__nv_bfloat16, kDkv>(a, d));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// q/dout (bh, seq_q, d), k/v (bh, seq_k, d): contiguous and 16-byte
// aligned, in the input dtype (0 = float32, 1 = bfloat16); lse/delta (bh,
// seq_q) float32; dk/dv (bh, seq_k, d) in the input dtype.
int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dk, void* dv, int bh,
                            int seq_q, int seq_k, int d, int causal,
                            float scale, int dtype, void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), dk, dv, bh, seq_q, seq_k,
               causal, scale, static_cast<cudaStream_t>(stream)};
  return dispatch<true>(a, d, dtype);
}

// as above; dq (bh, seq_q, d) in the input dtype
int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dq, int bh, int seq_q,
                           int seq_k, int d, int causal, float scale,
                           int dtype, void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), dq, nullptr, bh, seq_q,
               seq_k, causal, scale, static_cast<cudaStream_t>(stream)};
  return dispatch<false>(a, d, dtype);
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
