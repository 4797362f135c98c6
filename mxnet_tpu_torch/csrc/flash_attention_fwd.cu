// Flash-attention forward for Hopper (sm_90a), fp32 and bf16 inputs.
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas/flash_attention.py
// (_fwd -> _fwd_kernel, the forward of the public flash_attention): the
// same function, exactly. For each (batch*head, query row) it streams the
// keys in tiles with an online softmax (running max m, running sum l,
// fp32 accumulator), masks keys >= seq_k and, when causal, keys past the
// query row (q < k, top-left aligned) with -1e30, skips causal key tiles
// past the diagonal, and writes
//     out = acc / max(l, 1e-30)            (input dtype)
//     lse = m + log(max(l, 1e-30))         (fp32, one per row)
//
// What bounds it on the H100: at the serving shape (b*h = 12, s = 512,
// d = 64, causal) the call does ~0.40 GFLOP on ~6.3 MB of q/k/v/out in
// fp32. The products are plain fp32 FMAs (no TF32, so the kernel matches
// the plain version at fp32 tolerance), so the bound is the 67 TFLOP/s
// non-tensor-core rate, ~6 us; in bf16 the same call is bound by memory
// (~0.9 us at 3.35 TB/s) once the products move to the tensor cores.
//
// What the design does about it: scores never touch device memory. One
// thread block of 256 threads owns one (bh, 64-row query tile); the query
// tile and each 64-row key/value tile are staged once through shared
// memory (as fp32), and every thread computes a 4x4 block of scores and a
// 4 x (D/16) block of the output from shared memory, so each element
// loaded from device memory is reused 64 times. Row maxima and sums are
// reduced with warp shuffles inside the 16 threads that share a row.
// Ragged tails are masked by index (rows past seq_q are not stored, keys
// past seq_k are zero-filled and masked), never by padding in memory.
// bf16 inputs are widened to fp32 on the way into shared memory, so both
// dtypes share the fp32 FMA path; tensor-core MMA (wgmma), TMA and warp
// specialisation are later work.
//
// Plain C interface, bound from Python with ctypes: the launch goes onto
// the caller's stream, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr float kNegInf = -1e30f;

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

template <int D>
constexpr size_t smem_bytes() {
  // Q and K tiles padded by one column (conflict-free column reads),
  // V unpadded, P padded by one column.
  return sizeof(float) * (kBlockQ * (D + 1) + kBlockK * (D + 1) +
                          kBlockK * D + kBlockQ * (kBlockK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int seq_q, int seq_k,
                     int causal, float scale) {
  constexpr int DP = D + 1;
  constexpr int PP = kBlockK + 1;
  constexpr int RI = kBlockQ / 16;  // query rows per thread
  constexpr int CJ = kBlockK / 16;  // key columns per thread
  constexpr int OJ = D / 16;        // output columns per thread

  extern __shared__ float smem[];
  float* qs = smem;                 // [kBlockQ][DP]
  float* ks = qs + kBlockQ * DP;    // [kBlockK][DP]
  float* vs = ks + kBlockK * DP;    // [kBlockK][D]
  float* ps = vs + kBlockK * D;     // [kBlockQ][PP]

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // column group
  const int ty = tid >> 4;  // row group
  const int bh = blockIdx.y;
  // the last query tiles carry the most causal work: start them first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;

  const T* qb = q + static_cast<size_t>(bh) * seq_q * D;
  const T* kb = k + static_cast<size_t>(bh) * seq_k * D;
  const T* vb = v + static_cast<size_t>(bh) * seq_k * D;

  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int row = q0 + r;
    qs[r * DP + c] =
        row < seq_q ? to_f32(qb[static_cast<size_t>(row) * D + c]) : 0.f;
  }

  float m[RI], l[RI], acc[RI][OJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int o = 0; o < OJ; ++o) acc[i][o] = 0.f;
  }

  int n_tiles = (seq_k + kBlockK - 1) / kBlockK;
  if (causal) {
    // only key tiles starting at or before the tile's last real row
    const int last_row = min(q0 + kBlockQ, seq_q) - 1;
    n_tiles = min(n_tiles, last_row / kBlockK + 1);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // Q staged / previous tile fully consumed
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const int row = k0 + r;
      const bool in = row < seq_k;
      const size_t g = static_cast<size_t>(row) * D + c;
      ks[r * DP + c] = in ? to_f32(kb[g]) : 0.f;
      vs[r * D + c] = in ? to_f32(vb[g]) : 0.f;
    }
    __syncthreads();

    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
    }
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float a[RI], b[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) a[i] = qs[(ty + 16 * i) * DP + c];
#pragma unroll
      for (int j = 0; j < CJ; ++j) b[j] = ks[(tx + 16 * j) * DP + c];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int row = q0 + ty + 16 * i;
      bool ok[CJ];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int col = k0 + tx + 16 * j;
        ok[j] = col < seq_k && (!causal || col <= row);
        s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 threads of a row are one half of a warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        ps[(ty + 16 * i) * PP + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = corr * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int o = 0; o < OJ; ++o) acc[i][o] *= corr;
    }
    __syncthreads();  // P complete

#pragma unroll 8
    for (int kk = 0; kk < kBlockK; ++kk) {
      float p[RI], w[OJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) p[i] = ps[(ty + 16 * i) * PP + kk];
#pragma unroll
      for (int o = 0; o < OJ; ++o) w[o] = vs[kk * D + tx + 16 * o];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
#pragma unroll
        for (int o = 0; o < OJ; ++o) acc[i][o] = fmaf(p[i], w[o], acc[i][o]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= seq_q) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
    T* orow = out + (static_cast<size_t>(bh) * seq_q + row) * D;
#pragma unroll
    for (int o = 0; o < OJ; ++o)
      orow[tx + 16 * o] = from_f32<T>(acc[i][o] / l_safe);
    if (tx == 0)
      lse[static_cast<size_t>(bh) * seq_q + row] = m[i] + logf(l_safe);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int bh, int seq_q, int seq_k, int causal,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  // above 48 KB a block's dynamic shared memory has to be opted into;
  // once per instantiation (a function-local static initialises once)
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((seq_q + kBlockQ - 1) / kBlockQ, bh);
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

}  // namespace

extern "C" {

// q (bh, seq_q, d), k/v (bh, seq_k, d), out (bh, seq_q, d): contiguous, in
// the input dtype (0 = float32, 1 = bfloat16); lse (bh, seq_q) float32.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* out, void* lse, int bh, int seq_q, int seq_k,
                        int d, int causal, float scale, int dtype,
                        void* stream) {
  if (bh <= 0 || seq_q <= 0 || seq_k <= 0 || bh > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
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
