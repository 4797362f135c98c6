// Fused dropout + residual add + LayerNorm for Hopper (sm_90a): the
// forward and its backward, fp32 and bf16 rows.
//
// Replaces the TPU kernels of mxnet_tpu/ops/pallas/ln_residual.py:
//   ln_residual_fwd_kernel <- _fwd_kernel (launched by _run_fwd),
//   ln_residual_bwd_kernel <- _bwd_kernel (launched by _ln_residual_bwd).
// Per row of an (n, D) stream, with scale = 1/(1-p) (1 when p = 0):
//   s    = x + h*m*scale            m: the dropout keep mask (absent: 1)
//   mean = sum(s)/D,  var = sum((s-mean)^2)/D   (two passes, not E[s^2])
//   rstd = 1/sqrt(var + eps)       (IEEE sqrtf and division, as torch's
//                                   rsqrt on the CPU; not rsqrtf)
//   out  = (s-mean)*rstd*gamma + beta
// and, from (x, h, m, mean, rstd) and the cotangent do,
//   xhat = (s-mean)*rstd,  dxhat = do*gamma
//   ds   = rstd*(dxhat - mean(dxhat) - xhat*mean(dxhat*xhat))
//   dx = ds,  dh = ds*m*scale,  dgamma = sum_rows do*xhat,
//   dbeta = sum_rows do.
// Everything is computed in fp32; out/dx/dh are stored in the input dtype,
// mean and rstd in fp32.
//
// What bounds it on the H100: bytes. At the BERT-base training shape
// (n = 32*128 rows, D = 768, fp32, float mask) the forward moves x, h, m
// and out (50.3 MB, ~15 us at 3.35 TB/s) and the backward x, h, m, do, dx
// and dh (75.5 MB, ~22.5 us) for ~10 and ~20 flops per element.
//
// What the design does about it: every element crosses device memory once
// each way. A row lives in registers (at most 32 fp32 values a thread),
// so the mean, the variance and the normalisation read it once; the
// backward recomputes s from (x, h, m) instead of saving it, keeping only
// two fp32 values a row between the passes. Rows of D <= 1024 take one
// warp each (four rows per 128-thread block, warp-shuffle sums); wider
// rows, up to 8192, take a 256-thread block each (shuffles, then eight
// warp partials through shared memory). Loads and stores are 16 bytes a
// thread where D and the pointers' alignment allow (4 fp32 or 8 bf16
// values), else one value a thread; neighbouring threads touch
// neighbouring addresses either way. Ragged rows are masked by index,
// never padded in memory. The TPU kernel's dgamma/dbeta accumulator, one
// (8, D) block revisited by a sequential grid, has no counterpart here:
// each backward block walks a contiguous chunk of rows, every thread keeps
// the partial sums of its own columns in registers, the block folds its
// warps' partials through shared memory in a fixed order, and writes one
// fp32 row into a (G, D) buffer that the caller sums. No atomics, so the
// result is the same from run to run.
//
// Plain C interface, bound from Python with ctypes: each launch goes onto
// the caller's stream, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kMaxPerThread = 32;  // row values a thread holds
constexpr int kWarpRows = 4;       // rows (warps) per block when D <= 1024
constexpr int kWarpMaxDim = 32 * kMaxPerThread;        // 1024
constexpr int kBlockThreads = 256;                     // D > 1024
constexpr int kMaxDim = kBlockThreads * kMaxPerThread;  // 8192

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(uint8_t v) {
  return v ? 1.f : 0.f;
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// VEC consecutive values moved by one load or store instruction (16 bytes
// for 4 fp32 or 8 bf16 values).
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ void load(const T* p, float* out) {
  const Pack<T, VEC> pk = *reinterpret_cast<const Pack<T, VEC>*>(p);
#pragma unroll
  for (int i = 0; i < VEC; ++i) out[i] = to_f32(pk.v[i]);
}

template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const float* in) {
  Pack<T, VEC> pk;
#pragma unroll
  for (int i = 0; i < VEC; ++i) pk.v[i] = from_f32<T>(in[i]);
  *reinterpret_cast<Pack<T, VEC>*>(p) = pk;
}

// Sum over the W threads that share a row: a warp (W = 32) or the whole
// block (W = 256, through ``red``). Every thread gets the same total.
template <int W>
__device__ __forceinline__ float row_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if (W == 32) return v;
  __syncthreads();  // ``red`` is free again
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int i = 0; i < W / 32; ++i) t += red[i];
  return t;
}

// s = x + h*m*scale, unfused (no FMA contraction), as the plain version
// computes it.
__device__ __forceinline__ float residual(float x, float h, float m,
                                          float scale) {
  return __fadd_rn(x, __fmul_rn(__fmul_rn(h, m), scale));
}

// One row group: the W threads of a row, and which of the row's values
// each holds: chunk j of thread ``lane`` starts at column (j*W + lane)*VEC.
template <int W, int VEC>
struct Cols {
  static constexpr int kChunks = kMaxPerThread / VEC;
  __device__ static int col(int j, int lane) { return (j * W + lane) * VEC; }
};

template <typename T, typename M, bool MASK, int VEC, int W>
__global__ void __launch_bounds__(W == 32 ? 32 * kWarpRows : W)
    ln_residual_fwd_kernel(const T* __restrict__ x, const T* __restrict__ h,
                           const M* __restrict__ mask,
                           const T* __restrict__ gamma,
                           const T* __restrict__ beta, T* __restrict__ out,
                           float* __restrict__ mean_out,
                           float* __restrict__ rstd_out, int n, int dim,
                           float scale, float eps) {
  using C = Cols<W, VEC>;
  __shared__ float red[32];
  const int lane = W == 32 ? (threadIdx.x & 31) : threadIdx.x;
  const int row =
      W == 32 ? blockIdx.x * kWarpRows + (threadIdx.x >> 5) : blockIdx.x;
  // W = 32: a warp without a row leaves (no block-wide barrier follows);
  // W = 256: the whole block shares one row
  if (row >= n) return;
  const size_t base = static_cast<size_t>(row) * dim;

  float s[kMaxPerThread];
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < C::kChunks; ++j) {
    const int c = C::col(j, lane);
    if (c < dim) {
      float xv[VEC], hv[VEC], mv[VEC];
      load<T, VEC>(x + base + c, xv);
      load<T, VEC>(h + base + c, hv);
      if (MASK) {
        load<M, VEC>(mask + base + c, mv);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) mv[i] = 1.f;
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        s[j * VEC + i] = residual(xv[i], hv[i], mv[i], scale);
        sum += s[j * VEC + i];
      }
    }
  }
  const float mean = row_sum<W>(sum, red) / dim;
  float sq = 0.f;
#pragma unroll
  for (int j = 0; j < C::kChunks; ++j) {
    if (C::col(j, lane) < dim) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float d = s[j * VEC + i] - mean;
        sq += d * d;
      }
    }
  }
  const float rstd = 1.f / sqrtf(row_sum<W>(sq, red) / dim + eps);
#pragma unroll
  for (int j = 0; j < C::kChunks; ++j) {
    const int c = C::col(j, lane);
    if (c < dim) {
      float gv[VEC], bv[VEC], ov[VEC];
      load<T, VEC>(gamma + c, gv);
      load<T, VEC>(beta + c, bv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float xhat = __fmul_rn(s[j * VEC + i] - mean, rstd);
        ov[i] = __fadd_rn(__fmul_rn(xhat, gv[i]), bv[i]);
      }
      store<T, VEC>(out + base + c, ov);
    }
  }
  if (lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

// Writes one row of column partials (dgamma or dbeta) of a backward block.
// W = 256: the block is one row group and ``acc`` is already its sum;
// W = 32: the four warps' partials are folded through ``part`` in warp
// order. ``acc`` is a reference to a register array, indexed only by
// unrolled constants, so it stays in registers.
template <int W, int VEC>
__device__ __forceinline__ void write_partials(
    const float (&acc)[kMaxPerThread], float* part, float* dst, int dim,
    int lane, int group) {
  using C = Cols<W, VEC>;
  float* out = W == 32 ? part + group * dim : dst;
#pragma unroll
  for (int j = 0; j < C::kChunks; ++j) {
    const int c = C::col(j, lane);
    if (c < dim) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) out[c + i] = acc[j * VEC + i];
    }
  }
  if (W != 32) return;
  __syncthreads();
  for (int c = threadIdx.x; c < dim; c += blockDim.x) {
    float t = 0.f;
#pragma unroll
    for (int g = 0; g < kWarpRows; ++g) t += part[g * dim + c];
    dst[c] = t;
  }
  __syncthreads();  // ``part`` is free again
}

template <typename T, typename M, bool MASK, int VEC, int W>
__global__ void __launch_bounds__(W == 32 ? 32 * kWarpRows : W)
    ln_residual_bwd_kernel(const T* __restrict__ x, const T* __restrict__ h,
                           const M* __restrict__ mask,
                           const T* __restrict__ gamma,
                           const float* __restrict__ mean_in,
                           const float* __restrict__ rstd_in,
                           const T* __restrict__ dout, T* __restrict__ dx,
                           T* __restrict__ dh, float* __restrict__ dg_part,
                           float* __restrict__ db_part, int n, int dim,
                           int rows_per_block, float scale) {
  using C = Cols<W, VEC>;
  constexpr int kGroups = W == 32 ? kWarpRows : 1;  // rows in flight
  __shared__ float red[64];
  // W = 32: the four warps' dgamma/dbeta partials, one row each
  __shared__ float part[W == 32 ? kWarpRows * kWarpMaxDim : 1];
  const int lane = W == 32 ? (threadIdx.x & 31) : threadIdx.x;
  const int group = W == 32 ? (threadIdx.x >> 5) : 0;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(n, r0 + rows_per_block);

  float dg[kMaxPerThread], db[kMaxPerThread];
#pragma unroll
  for (int k = 0; k < kMaxPerThread; ++k) dg[k] = db[k] = 0.f;

  // W = 32: each warp walks every fourth row of the chunk, with no
  // block-wide barrier inside the loop; W = 256: the block walks them all
  for (int row = r0 + group; row < r1; row += kGroups) {
    const size_t base = static_cast<size_t>(row) * dim;
    const float mean = mean_in[row];
    const float rstd = rstd_in[row];
    float xhat[kMaxPerThread], dov[kMaxPerThread];
    float a = 0.f, b = 0.f;  // sum(dxhat), sum(dxhat*xhat)
#pragma unroll
    for (int j = 0; j < C::kChunks; ++j) {
      const int c = C::col(j, lane);
      if (c < dim) {
        float xv[VEC], hv[VEC], mv[VEC], ov[VEC], gv[VEC];
        load<T, VEC>(x + base + c, xv);
        load<T, VEC>(h + base + c, hv);
        if (MASK) {
          load<M, VEC>(mask + base + c, mv);
        } else {
#pragma unroll
          for (int i = 0; i < VEC; ++i) mv[i] = 1.f;
        }
        load<T, VEC>(dout + base + c, ov);
        load<T, VEC>(gamma + c, gv);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const int k = j * VEC + i;
          xhat[k] = __fmul_rn(residual(xv[i], hv[i], mv[i], scale) - mean,
                              rstd);
          dov[k] = ov[i];
          const float gy = __fmul_rn(ov[i], gv[i]);  // dxhat
          a += gy;
          b += gy * xhat[k];
        }
      }
    }
    const float mean_a = row_sum<W>(a, red) / dim;
    const float mean_b = row_sum<W>(b, red + 32) / dim;
#pragma unroll
    for (int j = 0; j < C::kChunks; ++j) {
      const int c = C::col(j, lane);
      if (c < dim) {
        // the mask and gamma again: this row's lines are still in L1
        float mv[VEC], gv[VEC], dxv[VEC], dhv[VEC];
        if (MASK) {
          load<M, VEC>(mask + base + c, mv);
        } else {
#pragma unroll
          for (int i = 0; i < VEC; ++i) mv[i] = 1.f;
        }
        load<T, VEC>(gamma + c, gv);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const int k = j * VEC + i;
          const float gy = __fmul_rn(dov[k], gv[i]);
          const float ds =
              rstd * (gy - mean_a - __fmul_rn(xhat[k], mean_b));
          dxv[i] = ds;
          dhv[i] = __fmul_rn(__fmul_rn(ds, mv[i]), scale);
          dg[k] += dov[k] * xhat[k];
          db[k] += dov[k];
        }
        store<T, VEC>(dx + base + c, dxv);
        store<T, VEC>(dh + base + c, dhv);
      }
    }
  }

  const size_t at = static_cast<size_t>(blockIdx.x) * dim;
  write_partials<W, VEC>(dg, part, dg_part + at, dim, lane, group);
  write_partials<W, VEC>(db, part, db_part + at, dim, lane, group);
}

template <typename T, typename M, bool MASK, int VEC, int W>
cudaError_t launch_fwd(const void* x, const void* h, const void* mask,
                       const void* gamma, const void* beta, void* out,
                       void* mean, void* rstd, int n, int dim, float scale,
                       float eps, cudaStream_t stream) {
  const int threads = W == 32 ? 32 * kWarpRows : W;
  const int blocks = W == 32 ? (n + kWarpRows - 1) / kWarpRows : n;
  ln_residual_fwd_kernel<T, M, MASK, VEC, W><<<blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(h),
      static_cast<const M*>(mask), static_cast<const T*>(gamma),
      static_cast<const T*>(beta), static_cast<T*>(out),
      static_cast<float*>(mean), static_cast<float*>(rstd), n, dim, scale,
      eps);
  return cudaGetLastError();
}

template <typename T, typename M, bool MASK, int VEC, int W>
cudaError_t launch_bwd(const void* x, const void* h, const void* mask,
                       const void* gamma, const void* mean, const void* rstd,
                       const void* dout, void* dx, void* dh, void* dg_part,
                       void* db_part, int n, int dim, int rows_per_block,
                       float scale, cudaStream_t stream) {
  const int threads = W == 32 ? 32 * kWarpRows : W;
  const int blocks = (n + rows_per_block - 1) / rows_per_block;
  ln_residual_bwd_kernel<T, M, MASK, VEC, W><<<blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(h),
      static_cast<const M*>(mask), static_cast<const T*>(gamma),
      static_cast<const float*>(mean), static_cast<const float*>(rstd),
      static_cast<const T*>(dout), static_cast<T*>(dx), static_cast<T*>(dh),
      static_cast<float*>(dg_part), static_cast<float*>(db_part), n, dim,
      rows_per_block, scale);
  return cudaGetLastError();
}

// The instantiation for (row width, vector loads, mask kind), as a functor
// template ``Op<T, M, MASK, VEC, W>`` with a static ``run(args...)``.
template <template <typename, typename, bool, int, int> class Op,
          typename T, int VEC, int W, typename... Args>
cudaError_t by_mask(int mask_kind, Args... args) {
  switch (mask_kind) {
    case 0:  // no mask (p = 0): none is read
      return Op<T, uint8_t, false, VEC, W>::run(args...);
    case 1:  // 0/1 in the input dtype
      return Op<T, T, true, VEC, W>::run(args...);
    case 2:  // bool / uint8
      return Op<T, uint8_t, true, VEC, W>::run(args...);
    default:
      return cudaErrorInvalidValue;
  }
}

template <template <typename, typename, bool, int, int> class Op,
          typename T, typename... Args>
cudaError_t dispatch(int dim, int vec, int mask_kind, Args... args) {
  constexpr int kVec = 16 / sizeof(T);
  if (dim <= kWarpMaxDim) {
    return vec ? by_mask<Op, T, kVec, 32>(mask_kind, args...)
               : by_mask<Op, T, 1, 32>(mask_kind, args...);
  }
  return vec ? by_mask<Op, T, kVec, kBlockThreads>(mask_kind, args...)
             : by_mask<Op, T, 1, kBlockThreads>(mask_kind, args...);
}

template <typename T, typename M, bool MASK, int VEC, int W>
struct Fwd {
  template <typename... Args>
  static cudaError_t run(Args... args) {
    return launch_fwd<T, M, MASK, VEC, W>(args...);
  }
};

template <typename T, typename M, bool MASK, int VEC, int W>
struct Bwd {
  template <typename... Args>
  static cudaError_t run(Args... args) {
    return launch_bwd<T, M, MASK, VEC, W>(args...);
  }
};

bool bad_shape(int n, int dim, int vec, int elem) {
  return n <= 0 || dim <= 0 || dim > kMaxDim || (vec && dim % (16 / elem));
}

}  // namespace

extern "C" {

// x, h, out (n, d) contiguous in the input dtype (0 = float32,
// 1 = bfloat16); mask (n, d) in the input dtype (mask_kind 1) or uint8
// (mask_kind 2), or none (mask_kind 0, p = 0); gamma, beta (d,) in the
// input dtype; mean, rstd (n,) float32. vec = 1: every pointer is 16-byte
// aligned (8-byte for a uint8 mask with bf16, 4-byte with fp32) and d is
// a multiple of 16 bytes' worth of values.
int ln_residual_fwd(const void* x, const void* h, const void* mask,
                    const void* gamma, const void* beta, void* out,
                    void* mean, void* rstd, int n, int d, float scale,
                    float eps, int dtype, int mask_kind, int vec,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && !bad_shape(n, d, vec, 4))
    return static_cast<int>(dispatch<Fwd, float>(
        d, vec, mask_kind, x, h, mask, gamma, beta, out, mean, rstd, n, d,
        scale, eps, s));
  if (dtype == 1 && !bad_shape(n, d, vec, 2))
    return static_cast<int>(dispatch<Fwd, __nv_bfloat16>(
        d, vec, mask_kind, x, h, mask, gamma, beta, out, mean, rstd, n, d,
        scale, eps, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward: x, h, mask, gamma, mean, rstd as saved by the forward,
// dout like x; writes dx, dh (n, d) in the input dtype and one fp32 row of
// dgamma and dbeta partials per block into dg_part, db_part
// (ceil(n / rows_per_block), d).
int ln_residual_bwd(const void* x, const void* h, const void* mask,
                    const void* gamma, const void* mean, const void* rstd,
                    const void* dout, void* dx, void* dh, void* dg_part,
                    void* db_part, int n, int d, int rows_per_block,
                    float scale, int dtype, int mask_kind, int vec,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows_per_block <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0 && !bad_shape(n, d, vec, 4))
    return static_cast<int>(dispatch<Bwd, float>(
        d, vec, mask_kind, x, h, mask, gamma, mean, rstd, dout, dx, dh,
        dg_part, db_part, n, d, rows_per_block, scale, s));
  if (dtype == 1 && !bad_shape(n, d, vec, 2))
    return static_cast<int>(dispatch<Bwd, __nv_bfloat16>(
        d, vec, mask_kind, x, h, mask, gamma, mean, rstd, dout, dx, dh,
        dg_part, db_part, n, d, rows_per_block, scale, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* ln_residual_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
