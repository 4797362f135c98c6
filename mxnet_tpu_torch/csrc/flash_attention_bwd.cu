// Flash-attention backward for Hopper (sm_90a), fp32 and bf16 inputs: two
// kernels in one library, dK/dV and dQ.
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
// d = 64, causal, fp32) dK/dV does 8*d flops per visible (q, k) pair
// (recompute s and dp, then dV and dK): 25.8 GFLOP, 0.385 ms at the 67
// TFLOP/s fp32 rate; dQ does 6*d (s, dp, dQ): 19.3 GFLOP, 0.289 ms. They
// move ~0.15 GB and ~0.13 GB (~0.045 / ~0.038 ms at 3.35 TB/s), so in fp32
// both are bound by operations. fp32 parity at 1e-4 rules out TF32, so the
// products are plain fp32 FMAs.
//
// What the design does about it: scores, p and ds never touch device
// memory, and every element staged in shared memory is reused 64 times.
// The TPU kernels carry their accumulators across a sequential grid axis;
// Hopper runs blocks in no order, so that axis becomes a loop inside one
// block and nothing carries between blocks:
//  - dK/dV: one block of 256 threads owns one (bh, 64-row key tile). K and
//    V stay in shared memory while the block walks the query tiles (when
//    causal, from the first tile that reaches the key tile's diagonal);
//    each thread keeps a 4 x (D/16) slice of dK and of dV in registers.
//  - dQ: one block owns one (bh, 64-row query tile), keeps Q, dO, lse and
//    delta in shared memory and walks the key tiles (when causal, up to
//    the diagonal); each thread keeps a 4 x (D/16) slice of dQ.
// The two-kernel split needs no atomics. A thread computes a 4 x 4 block
// of s and dp from shared memory (tiles padded by one column, so the
// column reads are free of bank conflicts). Ragged tails are masked by
// index: rows past seq_q / seq_k are zero-filled in shared memory, get
// p = ds = 0, and are never stored; no padded copies are made. bf16 is
// widened to fp32 on the way into shared memory. Tensor cores (wgmma), TMA
// and warp specialisation are later work.
//
// Plain C interface, bound from Python with ctypes: each launch goes onto
// the caller's stream, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr int kPP = kBlockK + 1;  // padded row of a p / ds tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// the value an fp32 number takes once cast to the input dtype
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// shared memory of a block: n_tiles (64, D+1) fp32 tiles, n_st (64, 65)
// p / ds tiles and the 64 lse and 64 delta values of a query tile
template <int D>
constexpr size_t smem_bytes(int n_tiles, int n_st) {
  return sizeof(float) * (n_tiles * 64 * (D + 1) + n_st * 64 * kPP + 2 * 64);
}

// rows [row0, row0 + 64) of a (seq, D) matrix into a (64, D+1) fp32 tile,
// zero past seq
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int seq, int tid) {
  for (int i = tid; i < 64 * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int row = row0 + r;
    dst[r * (D + 1) + c] =
        row < seq ? to_f32(src[static_cast<size_t>(row) * D + c]) : 0.f;
  }
}

// the 64 lse and delta values of the query tile at q0, zero past seq_q
__device__ __forceinline__ void load_rows(float* lses, float* dels,
                                          const float* lse,
                                          const float* delta, int q0,
                                          int seq_q, int tid) {
  if (tid < 64) {
    const int row = q0 + tid;
    lses[tid] = row < seq_q ? lse[row] : 0.f;
    dels[tid] = row < seq_q ? delta[row] : 0.f;
  }
}

// out[i][j] = sum_c a[ty + 16 i][c] * b[tx + 16 j][c] over two (64, D+1)
// tiles: this thread's 4 x 4 block of a . b^T
template <int D>
__device__ __forceinline__ void tile_dot(const float* a, const float* b,
                                         int ty, int tx, float (&out)[4][4]) {
  constexpr int DP = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) out[i][j] = 0.f;
  }
#pragma unroll 8
  for (int c = 0; c < D; ++c) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty + 16 * i) * DP + c];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * DP + c];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) out[i][j] = fmaf(av[i], bv[j], out[i][j]);
    }
  }
}

// p and ds of this thread's 4 x 4 block of the (query tile q0, key tile
// k0) pair, from the raw products s = q . k^T and dp = do . v^T
__device__ __forceinline__ void p_ds(const float (&s)[4][4],
                                     const float (&dp)[4][4],
                                     const float* lses, const float* dels,
                                     int q0, int k0, int ty, int tx,
                                     int seq_q, int seq_k, int causal,
                                     float scale, float (&p)[4][4],
                                     float (&ds)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int row = q0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + tx + 16 * j;
      const bool ok =
          row < seq_q && col < seq_k && (!causal || row >= col);
      const float pv = ok ? expf(s[i][j] * scale - lses[r]) : 0.f;
      p[i][j] = pv;
      ds[i][j] = pv * (dp[i][j] - dels[r]) * scale;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv, int seq_q,
                         int seq_k, int causal, float scale) {
  constexpr int DP = D + 1;
  constexpr int OJ = D / 16;  // output columns per thread

  extern __shared__ float smem[];
  float* ks = smem;                  // [kBlockK][DP]
  float* vs = ks + kBlockK * DP;     // [kBlockK][DP]
  float* qs = vs + kBlockK * DP;     // [kBlockQ][DP]
  float* dos = qs + kBlockQ * DP;    // [kBlockQ][DP]
  float* ps = dos + kBlockQ * DP;    // [kBlockQ][kPP], p by (query, key)
  float* dss = ps + kBlockQ * kPP;   // [kBlockQ][kPP], ds by (query, key)
  float* lses = dss + kBlockQ * kPP;  // [kBlockQ]
  float* dels = lses + kBlockQ;       // [kBlockQ]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.y;
  // causal: the first key tiles see the most query tiles; they start first
  const int k0 = blockIdx.x * kBlockK;

  const size_t qoff = static_cast<size_t>(bh) * seq_q;
  const size_t koff = static_cast<size_t>(bh) * seq_k;
  load_tile<T, D>(ks, k + koff * D, k0, seq_k, tid);
  load_tile<T, D>(vs, v + koff * D, k0, seq_k, tid);

  float acc_dk[4][OJ], acc_dv[4][OJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int o = 0; o < OJ; ++o) {
      acc_dk[i][o] = 0.f;
      acc_dv[i][o] = 0.f;
    }
  }

  const int n_qt = (seq_q + kBlockQ - 1) / kBlockQ;
  // causal: query tiles wholly above the key tile's first key see none of
  // it (every q_pos < k0); with equal 64-row tiles the first tile that
  // reaches the diagonal is k0 / 64, whatever seq_q and seq_k are
  const int qt0 = causal ? k0 / kBlockQ : 0;
  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * kBlockQ;
    __syncthreads();  // K/V staged; the previous tile fully consumed
    load_tile<T, D>(qs, q + qoff * D, q0, seq_q, tid);
    load_tile<T, D>(dos, dout + qoff * D, q0, seq_q, tid);
    load_rows(lses, dels, lse + qoff, delta + qoff, q0, seq_q, tid);
    __syncthreads();

    float s[4][4], dp[4][4], p[4][4], ds[4][4];
    tile_dot<D>(qs, ks, ty, tx, s);
    tile_dot<D>(dos, vs, ty, tx, dp);
    p_ds(s, dp, lses, dels, q0, k0, ty, tx, seq_q, seq_k, causal, scale,
            p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ps[(ty + 16 * i) * kPP + tx + 16 * j] = round_to<T>(p[i][j]);
        dss[(ty + 16 * i) * kPP + tx + 16 * j] = round_to<T>(ds[i][j]);
      }
    }
    __syncthreads();  // p and ds of the tile complete

    // dV[kr][c] += sum_q p[q][kr] do[q][c], dK[kr][c] += sum_q ds[q][kr]
    // q[q][c]; this thread owns key rows ty + 16 i, columns tx + 16 o
#pragma unroll 4
    for (int qq = 0; qq < kBlockQ; ++qq) {
      float pv[4], dsv[4], dov[OJ], qv[OJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = ps[qq * kPP + ty + 16 * i];
        dsv[i] = dss[qq * kPP + ty + 16 * i];
      }
#pragma unroll
      for (int o = 0; o < OJ; ++o) {
        dov[o] = dos[qq * DP + tx + 16 * o];
        qv[o] = qs[qq * DP + tx + 16 * o];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int o = 0; o < OJ; ++o) {
          acc_dv[i][o] = fmaf(pv[i], dov[o], acc_dv[i][o]);
          acc_dk[i][o] = fmaf(dsv[i], qv[o], acc_dk[i][o]);
        }
      }
    }
  }

  // every key row below seq_k is written, zeros included (a causal key
  // tile that no query reaches)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= seq_k) continue;
    T* dkr = dk + (koff + row) * D;
    T* dvr = dv + (koff + row) * D;
#pragma unroll
    for (int o = 0; o < OJ; ++o) {
      dkr[tx + 16 * o] = from_f32<T>(acc_dk[i][o]);
      dvr[tx + 16 * o] = from_f32<T>(acc_dv[i][o]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        T* __restrict__ dq, int seq_q, int seq_k, int causal,
                        float scale) {
  constexpr int DP = D + 1;
  constexpr int OJ = D / 16;

  extern __shared__ float smem[];
  float* qs = smem;                   // [kBlockQ][DP]
  float* dos = qs + kBlockQ * DP;     // [kBlockQ][DP]
  float* ks = dos + kBlockQ * DP;     // [kBlockK][DP]
  float* vs = ks + kBlockK * DP;      // [kBlockK][DP]
  float* dss = vs + kBlockK * DP;     // [kBlockQ][kPP], ds by (query, key)
  float* lses = dss + kBlockQ * kPP;  // [kBlockQ]
  float* dels = lses + kBlockQ;       // [kBlockQ]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.y;
  // causal: the last query tiles walk the most key tiles; they start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;

  const size_t qoff = static_cast<size_t>(bh) * seq_q;
  const size_t koff = static_cast<size_t>(bh) * seq_k;
  load_tile<T, D>(qs, q + qoff * D, q0, seq_q, tid);
  load_tile<T, D>(dos, dout + qoff * D, q0, seq_q, tid);
  load_rows(lses, dels, lse + qoff, delta + qoff, q0, seq_q, tid);

  float acc[4][OJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int o = 0; o < OJ; ++o) acc[i][o] = 0.f;
  }

  int n_kt = (seq_k + kBlockK - 1) / kBlockK;
  if (causal) {
    // only key tiles starting at or before the tile's last real row
    const int last_row = min(q0 + kBlockQ, seq_q) - 1;
    n_kt = min(n_kt, last_row / kBlockK + 1);
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // Q/dO staged; the previous tile fully consumed
    load_tile<T, D>(ks, k + koff * D, k0, seq_k, tid);
    load_tile<T, D>(vs, v + koff * D, k0, seq_k, tid);
    __syncthreads();

    float s[4][4], dp[4][4], p[4][4], ds[4][4];
    tile_dot<D>(qs, ks, ty, tx, s);
    tile_dot<D>(dos, vs, ty, tx, dp);
    p_ds(s, dp, lses, dels, q0, k0, ty, tx, seq_q, seq_k, causal, scale,
            p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dss[(ty + 16 * i) * kPP + tx + 16 * j] = round_to<T>(ds[i][j]);
    }
    __syncthreads();  // ds of the tile complete

    // dQ[qr][c] += sum_k ds[qr][k] k[k][c]; this thread owns query rows
    // ty + 16 i, columns tx + 16 o
#pragma unroll 4
    for (int kk = 0; kk < kBlockK; ++kk) {
      float dsv[4], kv[OJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dss[(ty + 16 * i) * kPP + kk];
#pragma unroll
      for (int o = 0; o < OJ; ++o) kv[o] = ks[kk * DP + tx + 16 * o];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int o = 0; o < OJ; ++o) acc[i][o] = fmaf(dsv[i], kv[o], acc[i][o]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= seq_q) continue;
    T* dqr = dq + (qoff + row) * D;
#pragma unroll
    for (int o = 0; o < OJ; ++o) dqr[tx + 16 * o] = from_f32<T>(acc[i][o]);
  }
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
  constexpr size_t smem = smem_bytes<D>(4, 2);
  static const cudaError_t attr = opt_in(flash_bwd_dkv_kernel<T, D>, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.seq_k + kBlockK - 1) / kBlockK, a.bh);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.d0), static_cast<T*>(a.d1), a.seq_q,
      a.seq_k, a.causal, a.scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const Args& a) {
  constexpr size_t smem = smem_bytes<D>(4, 1);
  static const cudaError_t attr = opt_in(flash_bwd_dq_kernel<T, D>, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.seq_q + kBlockQ - 1) / kBlockQ, a.bh);
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

template <bool kDkv>
int dispatch(const Args& a, int d, int dtype) {
  if (a.bh <= 0 || a.seq_q <= 0 || a.seq_k <= 0 || a.bh > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return static_cast<int>(dispatch_d<float, kDkv>(a, d));
  if (dtype == 1)
    return static_cast<int>(dispatch_d<__nv_bfloat16, kDkv>(a, d));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// q/dout (bh, seq_q, d), k/v (bh, seq_k, d): contiguous, in the input
// dtype (0 = float32, 1 = bfloat16); lse/delta (bh, seq_q) float32;
// dk/dv (bh, seq_k, d) in the input dtype.
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
