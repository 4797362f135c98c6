// Fused dropout + residual add + LayerNorm for Hopper (sm_90a): the
// forward and its backward, rows of fp32, bf16 or fp16.
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
// Everything is computed in fp32, as the reference casts every input to
// fp32 inside its kernel. The rows (x, h, do, out, dx, dh) share one dtype
// here (the wrapper widens a mixed pair to fp32, which is exact); gamma and
// beta are read in their own dtype and dgamma/dbeta written in it; the
// mask is read in its own dtype (uint8/bool, fp32, bf16 or fp16, holding
// 0/1); mean and rstd are fp32.
//
// What bounds it on the H100: bytes. At the BERT-base training shape
// (n = 32*128 rows, D = 768, fp32, a mask in x's dtype) the forward moves
// x, h, m and out (50.3 MB, ~15 us at 3.35 TB/s) and the backward x, h, m,
// do, dx and dh (75.5 MB, ~22.5 us; bf16 half of each) for ~10 and ~20
// flops per element.
//
// What the forward does about it: every element crosses device memory once
// each way. A row lives in registers (at most 32 fp32 values a thread), so
// the mean, the variance and the normalisation read it once. Rows of
// D <= 1024 take one warp each (four rows per 128-thread block,
// warp-shuffle sums); wider rows, up to 8192, take a 256-thread block each
// (shuffles, then eight warp partials through shared memory). Loads and
// stores are 16 bytes a thread where D and the pointers' alignment allow,
// else one value a thread. Ragged rows are masked by index, never padded.
//
// What the backward does about it (one launch a call, cooperative):
// - A grid sized by occupancy: the SMs times the blocks of this
//   instantiation that fit on one (queried once, cached), all resident at
//   once. Each block walks a contiguous chunk of rows; each row group (a
//   warp for D <= 1024, four to a block; the whole 256-thread block above)
//   walks every fourth row of it (every row for a block).
// - Rows kept in flight: each row group owns a ring of 2 (4-byte rows) or
//   3 (2-byte rows) shared-memory stages, fewer where shared memory runs
//   short. Every thread stages its own columns of x, h, m, do (and the
//   row's mean and rstd) with cp.async (16 bytes, 4 or 8 for a narrow
//   mask), so the loads of the next rows are in flight while a row is
//   reduced and stored, and no barrier is needed: a thread only ever reads
//   what it copied. Each element of the mask is read from device memory
//   once; the second pass over a row reads the stage again. The first
//   rows' copies are issued before gamma is converted into shared memory.
//   Without the 16-byte path (D or a pointer off the vector width) nothing
//   is staged, a block takes each row, and the passes read device memory.
// - Registers sized by the row: the dgamma/dbeta partials of a thread's
//   columns are instantiated for 8, 16, 24 or 32 values a thread (D <=
//   256 / 512 / 768 / 1024 for a warp; 16 or 32 for a block, D <= 4096 /
//   8192), so BERT's 768 keeps 24 of each; none spills. gamma sits in
//   shared memory as fp32.
// - dgamma/dbeta summed inside the kernel, in a fixed order, without float
//   atomics: each block folds its warps' partials through shared memory
//   (warp order) and writes one fp32 row of partials; then a grid barrier
//   (one thread a block takes a ticket from an int32 counter after
//   __threadfence; the last to arrive zeroes it and bumps a generation word
//   that releases the others: two counters per device and stream, kept by
//   the caller and zeroed once). After it each block sums its slice of the
//   columns over every block's row (copied at once into shared memory,
//   rows split a fixed number of ways, each part in row order, the parts
//   in order) and writes dgamma/dbeta in gamma's dtype. The result is the
//   same bit for bit from run to run. Measured at BERT's shape (PERF.md):
//   the barrier and this sum cost ~4 us of ~33 (fp32), the reason the
//   call stays above its bound; a two-level ticket fold in which the last
//   block of each group of ~sqrt(G) blocks, then the last group, summed
//   the rows was ~3 us slower.
//
// Plain C interface, bound from Python with ctypes: each launch goes onto
// the caller's stream, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>
#include <cstddef>
#include <cstdint>
#include <mutex>
#include <type_traits>

#include "device_once.cuh"

namespace {

constexpr int kMaxPerThread = 32;  // row values a thread holds (forward)
constexpr int kWarpRows = 4;       // rows (warps) per block when D <= 1024
constexpr int kWarpMaxDim = 32 * kMaxPerThread;        // 1024
constexpr int kBlockThreads = 256;                     // D > 1024
constexpr int kMaxDim = kBlockThreads * kMaxPerThread;  // 8192

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
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
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// One value of a (D,) vector whose dtype is known only at run time
// (0 = float32, 1 = bfloat16, 2 = float16).
__device__ __forceinline__ void store_any(void* p, int dtype, int i,
                                          float v) {
  if (dtype == 1)
    static_cast<__nv_bfloat16*>(p)[i] = from_f32<__nv_bfloat16>(v);
  else if (dtype == 2)
    static_cast<__half*>(p)[i] = from_f32<__half>(v);
  else
    static_cast<float*>(p)[i] = v;
}

// VEC consecutive values moved by one load or store instruction (16 bytes
// for 4 fp32 or 8 bf16/fp16 values; VEC * sizeof(M) bytes of a mask).
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

template <typename M, bool MASK, int VEC>
__device__ __forceinline__ void load_mask(const M* p, float* out) {
  if (MASK) {
    load<M, VEC>(p, out);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = 1.f;
  }
}

// -- asynchronous copies into shared memory -----------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// BYTES (4, 8, 16 or 32) global -> shared; both sides aligned to
// min(BYTES, 16). 16-byte pieces bypass L1 (.cg): every element is used
// once from device memory.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (BYTES >= 16) {
#pragma unroll
    for (int o = 0; o < BYTES; o += 16)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       smem_addr(static_cast<char*>(dst) + o)),
                   "l"(static_cast<const char*>(src) + o)
                   : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(BYTES)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most ``pending`` (0, 1 or 2) of this thread's newest copy
// groups are still in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending >= 2)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else if (pending == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// -- row sums ----------------------------------------------------------------

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

// Two row sums at once (their shuffles interleave); ``red`` holds 2 * W/32.
template <int W>
__device__ __forceinline__ void row_sum2(float& a, float& b, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  if (W == 32) return;
  constexpr int kWarps = W / 32;
  __syncthreads();  // ``red`` is free again
  if ((threadIdx.x & 31) == 0) {
    red[threadIdx.x >> 5] = a;
    red[kWarps + (threadIdx.x >> 5)] = b;
  }
  __syncthreads();
  a = b = 0.f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    a += red[i];
    b += red[kWarps + i];
  }
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
__device__ __forceinline__ int col(int j, int lane) {
  return (j * W + lane) * VEC;
}

// -- forward -----------------------------------------------------------------

template <typename T, typename G, typename M, bool MASK, int VEC, int W>
__global__ void __launch_bounds__(W == 32 ? 32 * kWarpRows : W)
    ln_residual_fwd_kernel(const T* __restrict__ x, const T* __restrict__ h,
                           const M* __restrict__ mask,
                           const G* __restrict__ gamma,
                           const G* __restrict__ beta, T* __restrict__ out,
                           float* __restrict__ mean_out,
                           float* __restrict__ rstd_out, int n, int dim,
                           float scale, float eps) {
  constexpr int kChunks = kMaxPerThread / VEC;
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
  for (int j = 0; j < kChunks; ++j) {
    const int c = col<W, VEC>(j, lane);
    if (c < dim) {
      float xv[VEC], hv[VEC], mv[VEC];
      load<T, VEC>(x + base + c, xv);
      load<T, VEC>(h + base + c, hv);
      load_mask<M, MASK, VEC>(mask + base + c, mv);
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
  for (int j = 0; j < kChunks; ++j) {
    if (col<W, VEC>(j, lane) < dim) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float d = s[j * VEC + i] - mean;
        sq += d * d;
      }
    }
  }
  const float rstd = 1.f / sqrtf(row_sum<W>(sq, red) / dim + eps);
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int c = col<W, VEC>(j, lane);
    if (c < dim) {
      float gv[VEC], bv[VEC], ov[VEC];
      load<G, VEC>(gamma + c, gv);
      load<G, VEC>(beta + c, bv);
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

// -- backward ----------------------------------------------------------------

struct BwdArgs {
  const void* x;
  const void* h;
  const void* mask;
  const void* gamma;
  const float* mean;
  const float* rstd;
  const void* dout;
  void* dx;
  void* dh;
  void* dgamma;
  void* dbeta;
  float* part;   // (G, 2, D): each block's row of partials
  int* tickets;  // [0]: blocks arrived at the barrier; [1]: its generation
  int n, dim, rows_per_block, stages, stage_bytes, ring_offset;
  int gamma_dtype;
  float scale;
};

__host__ __device__ constexpr int round_up(int v, int to) {
  return (v + to - 1) / to * to;
}

// Offsets inside one stage of a row group's ring: x, h, do (T), the mask
// (M), then each thread's (mean, rstd) pair.
template <typename T, typename M, bool MASK, int W>
struct StageLayout {
  __host__ __device__ static int rows(int dim) {
    return round_up(dim * static_cast<int>(sizeof(T)), 128);
  }
  __host__ __device__ static int mask(int dim) {
    return MASK ? round_up(dim * static_cast<int>(sizeof(M)), 128) : 0;
  }
  __host__ __device__ static int stats(int dim) {
    return 3 * rows(dim) + mask(dim);
  }
  __host__ __device__ static int bytes(int dim) {
    return stats(dim) + round_up(W * 8, 128);
  }
};

// gamma (D,) as fp32 into shared memory, eight loads a thread in flight
// before their stores (a load then a store each would wait out one L2
// round trip per value: the compiler cannot move a global load past a
// store through another pointer).
template <typename G>
__device__ __forceinline__ void gamma_to_shared(const G* __restrict__ g,
                                                float* gam, int dim) {
  constexpr int kBatch = 8;
  for (int c0 = threadIdx.x; c0 < dim; c0 += kBatch * blockDim.x) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int c = c0 + u * blockDim.x;
      v[u] = c < dim ? to_f32(g[c]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int c = c0 + u * blockDim.x;
      if (c < dim) gam[c] = v[u];
    }
  }
}

// (one block an SM at least: ptxas otherwise held the 256-thread
// instantiations to 128 registers and spilled)
template <typename T, typename M, bool MASK, int VEC, int W, int PER>
__global__ void __launch_bounds__(W == 32 ? 32 * kWarpRows : W, 1)
    ln_residual_bwd_kernel(const BwdArgs a) {
  using L = StageLayout<T, M, MASK, W>;
  constexpr int kGroups = W == 32 ? kWarpRows : 1;  // row groups a block
  constexpr int kChunks = PER / VEC;
  constexpr bool kStaged = VEC > 1;  // the 16-byte path stages its rows
  static_assert(PER % VEC == 0, "a thread holds whole chunks");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float red[2 * (W / 32)];
  __shared__ float scratch[W == 32 ? 32 * kWarpRows : W];
  // the dynamic region follows the static variables: align it to 128
  // bytes by hand (the plan adds the slack)
  unsigned char* smem =
      smem_raw + ((128 - (smem_addr(smem_raw) & 127)) & 127);
  const int dim = a.dim;
  const int lane = W == 32 ? (threadIdx.x & 31) : threadIdx.x;
  const int group = W == 32 ? (threadIdx.x >> 5) : 0;
  const T* __restrict__ x = static_cast<const T*>(a.x);
  const T* __restrict__ h = static_cast<const T*>(a.h);
  const M* __restrict__ mask = static_cast<const M*>(a.mask);
  const T* __restrict__ dout = static_cast<const T*>(a.dout);
  T* __restrict__ dx = static_cast<T*>(a.dx);
  T* __restrict__ dh = static_cast<T*>(a.dh);

  const int r0 = blockIdx.x * a.rows_per_block;
  const int r1 = min(a.n, r0 + a.rows_per_block);
  const int first = r0 + group;  // this group's rows: first + k*kGroups
  const int count = first < r1 ? (r1 - first + kGroups - 1) / kGroups : 0;
  unsigned char* ring =
      smem + a.ring_offset + group * a.stages * a.stage_bytes;

  // stage row k of this group (a copy group even when there is none, so
  // that the count of groups in flight stays fixed)
  auto issue = [&](int k) {
    if (k < count) {
      const size_t base = static_cast<size_t>(first + k * kGroups) * dim;
      unsigned char* st = ring + (k % a.stages) * a.stage_bytes;
      const int rb = L::rows(dim);
#pragma unroll
      for (int j = 0; j < kChunks; ++j) {
        const int c = col<W, VEC>(j, lane);
        if (c < dim) {
          constexpr int kRowBytes = VEC * sizeof(T);
          cp_async<kRowBytes>(st + c * sizeof(T), x + base + c);
          cp_async<kRowBytes>(st + rb + c * sizeof(T), h + base + c);
          cp_async<kRowBytes>(st + 2 * rb + c * sizeof(T), dout + base + c);
          if (MASK)
            cp_async<VEC * sizeof(M)>(st + 3 * rb + c * sizeof(M),
                                      mask + base + c);
        }
      }
      const int row = first + k * kGroups;
      float* stat = reinterpret_cast<float*>(st + L::stats(dim)) + 2 * lane;
      cp_async<4>(stat, a.mean + row);
      cp_async<4>(stat + 1, a.rstd + row);
    }
    cp_async_commit();
  };

  float dg[PER], db[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) dg[k] = db[k] = 0.f;

  if (kStaged)
    for (int k = 0; k + 1 < a.stages; ++k) issue(k);
  // gamma as fp32 in shared memory, while the first rows are in flight
  float* gam = reinterpret_cast<float*>(smem);
  if (a.gamma_dtype == 1)
    gamma_to_shared(static_cast<const __nv_bfloat16*>(a.gamma), gam, dim);
  else if (a.gamma_dtype == 2)
    gamma_to_shared(static_cast<const __half*>(a.gamma), gam, dim);
  else
    gamma_to_shared(static_cast<const float*>(a.gamma), gam, dim);
  __syncthreads();
  for (int k = 0; k < count; ++k) {
    const int row = first + k * kGroups;
    const size_t base = static_cast<size_t>(row) * dim;
    const T *xs, *hs, *os;
    const M* ms;
    float mean, rstd;
    if (kStaged) {
      issue(k + a.stages - 1);
      cp_async_wait(a.stages - 1);  // row k has landed
      const unsigned char* st = ring + (k % a.stages) * a.stage_bytes;
      const int rb = L::rows(dim);
      xs = reinterpret_cast<const T*>(st);
      hs = reinterpret_cast<const T*>(st + rb);
      os = reinterpret_cast<const T*>(st + 2 * rb);
      ms = reinterpret_cast<const M*>(st + 3 * rb);
      const float* stat =
          reinterpret_cast<const float*>(st + L::stats(dim)) + 2 * lane;
      mean = stat[0];
      rstd = stat[1];
    } else {
      xs = x + base;
      hs = h + base;
      os = dout + base;
      ms = mask + base;
      mean = a.mean[row];
      rstd = a.rstd[row];
    }

    // pass 1: sum(dxhat), sum(dxhat*xhat), and the dgamma/dbeta partials
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int c = col<W, VEC>(j, lane);
      if (c < dim) {
        float xv[VEC], hv[VEC], mv[VEC], ov[VEC], gv[VEC];
        load<T, VEC>(xs + c, xv);
        load<T, VEC>(hs + c, hv);
        load_mask<M, MASK, VEC>(ms + c, mv);
        load<T, VEC>(os + c, ov);
        load<float, VEC>(gam + c, gv);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const int k2 = j * VEC + i;
          const float xhat =
              __fmul_rn(residual(xv[i], hv[i], mv[i], a.scale) - mean, rstd);
          const float gy = __fmul_rn(ov[i], gv[i]);  // dxhat
          sa += gy;
          sb += gy * xhat;
          dg[k2] += ov[i] * xhat;
          db[k2] += ov[i];
        }
      }
    }
    row_sum2<W>(sa, sb, red);
    const float mean_a = sa / dim;
    const float mean_b = sb / dim;

    // pass 2: the same values again (from the stage), then dx and dh
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int c = col<W, VEC>(j, lane);
      if (c < dim) {
        float xv[VEC], hv[VEC], mv[VEC], ov[VEC], gv[VEC], dxv[VEC],
            dhv[VEC];
        load<T, VEC>(xs + c, xv);
        load<T, VEC>(hs + c, hv);
        load_mask<M, MASK, VEC>(ms + c, mv);
        load<T, VEC>(os + c, ov);
        load<float, VEC>(gam + c, gv);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float xhat =
              __fmul_rn(residual(xv[i], hv[i], mv[i], a.scale) - mean, rstd);
          const float gy = __fmul_rn(ov[i], gv[i]);
          const float ds = rstd * (gy - mean_a - __fmul_rn(xhat, mean_b));
          dxv[i] = ds;
          dhv[i] = __fmul_rn(__fmul_rn(ds, mv[i]), a.scale);
        }
        store<T, VEC>(dx + base + c, dxv);
        store<T, VEC>(dh + base + c, dhv);
      }
    }
  }
  if (kStaged) cp_async_wait(0);  // the trailing (empty) copy groups

  // this block's row of partials, [dgamma | dbeta]
  const int nblk = gridDim.x;
  float* part = a.part;
  float* mine = part + static_cast<size_t>(blockIdx.x) * 2 * dim;
  if (W == 32) {
    // fold the warps' partials in warp order through shared memory
    __syncthreads();  // every warp is done with its ring
    float* fold = reinterpret_cast<float*>(smem + a.ring_offset);
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int c = col<W, VEC>(j, lane);
      if (c < dim) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          fold[(2 * group) * dim + c + i] = dg[j * VEC + i];
          fold[(2 * group + 1) * dim + c + i] = db[j * VEC + i];
        }
      }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < 2 * dim; c += blockDim.x) {
      float t = 0.f;
#pragma unroll
      for (int g = 0; g < kGroups; ++g) t += fold[g * 2 * dim + c];
      mine[c] = t;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int c = col<W, VEC>(j, lane);
      if (c < dim) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          mine[c + i] = dg[j * VEC + i];
          mine[dim + c + i] = db[j * VEC + i];
        }
      }
    }
  }

  // every block co-resident (cooperative launch): a grid barrier, then
  // each block sums its slice of the columns over every block's row. The
  // barrier reverses a sense: each block reads the generation word, then
  // arrives; the last to arrive zeroes the count and bumps the generation,
  // which releases the others. One thread fences for the block (its
  // writes are ordered before it by __syncthreads), as cooperative
  // groups' grid sync does.
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile int* gen = a.tickets + 1;
    const int seen = *gen;
    __threadfence();
    if (atomicAdd(a.tickets, 1) == nblk - 1) {
      a.tickets[0] = 0;
      __threadfence();
      atomicAdd(a.tickets + 1, 1);
    } else {
      while (*gen == seen) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
  // this block's columns [c0, c1) of every block's row, copied at once
  // into shared memory (the ring is free), then summed over the rows: the
  // rows split ``phases`` ways, each part in row order, the parts in order
  const int cols = 2 * dim;
  const int per = (cols + nblk - 1) / nblk;
  const int c0 = min(cols, blockIdx.x * per), c1 = min(cols, c0 + per);
  const int wc = c1 - c0;
  float* slab = reinterpret_cast<float*>(smem + a.ring_offset);
  for (int i = threadIdx.x; i < nblk * wc; i += blockDim.x) {
    const int r = i / wc;
    cp_async<4>(slab + i, part + static_cast<size_t>(r) * cols + c0 + i -
                              r * wc);
  }
  cp_async_commit();
  cp_async_wait(0);
  __syncthreads();
  for (int cb = 0; cb < wc; cb += blockDim.x) {
    const int w = min(wc - cb, static_cast<int>(blockDim.x));
    const int phases = blockDim.x / w;
    const int ci = threadIdx.x % w, rp = threadIdx.x / w;
    float t = 0.f;
    if (rp < phases)
      for (int r = rp; r < nblk; r += phases) t += slab[r * wc + cb + ci];
    scratch[threadIdx.x] = t;
    __syncthreads();
    if (threadIdx.x < w) {
      float v = 0.f;
      for (int q = 0; q < phases; ++q) v += scratch[q * w + threadIdx.x];
      const int c = c0 + cb + threadIdx.x;
      if (c < dim)
        store_any(a.dgamma, a.gamma_dtype, c, v);
      else
        store_any(a.dbeta, a.gamma_dtype, c - dim, v);
    }
    __syncthreads();  // ``scratch`` is free again
  }
}

// -- host side ---------------------------------------------------------------

template <typename T>
struct Tag {
  using type = T;
};

// f(Tag<T>) for a dtype code: 0 = float32, 1 = bfloat16, 2 = float16
template <typename F>
cudaError_t by_dtype(int code, F&& f) {
  switch (code) {
    case 0:
      return f(Tag<float>{});
    case 1:
      return f(Tag<__nv_bfloat16>{});
    case 2:
      return f(Tag<__half>{});
    default:
      return cudaErrorInvalidValue;
  }
}

// f(Tag<M>, MASK) for a mask kind: 0 = none (p = 0; none is read),
// 1 = uint8/bool, 2 = float32, 3 = bfloat16, 4 = float16
template <typename F>
cudaError_t by_mask(int kind, F&& f) {
  switch (kind) {
    case 0:
      return f(Tag<uint8_t>{}, std::false_type{});
    case 1:
      return f(Tag<uint8_t>{}, std::true_type{});
    case 2:
      return f(Tag<float>{}, std::true_type{});
    case 3:
      return f(Tag<__nv_bfloat16>{}, std::true_type{});
    case 4:
      return f(Tag<__half>{}, std::true_type{});
    default:
      return cudaErrorInvalidValue;
  }
}

int elem_size(int code) { return code == 0 ? 4 : 2; }

bool bad_shape(int n, int dim, int vec, int elem) {
  return n <= 0 || dim <= 0 || dim > kMaxDim || (vec && dim % (16 / elem));
}

struct Fwd {
  const void *x, *h, *mask, *gamma, *beta;
  void *out, *mean, *rstd;
  int n, dim;
  float scale, eps;
  cudaStream_t stream;

  template <typename T, typename G, typename M, bool MASK, int VEC, int W>
  cudaError_t launch() const {
    const int threads = W == 32 ? 32 * kWarpRows : W;
    const int blocks = W == 32 ? (n + kWarpRows - 1) / kWarpRows : n;
    ln_residual_fwd_kernel<T, G, M, MASK, VEC, W>
        <<<blocks, threads, 0, stream>>>(
            static_cast<const T*>(x), static_cast<const T*>(h),
            static_cast<const M*>(mask), static_cast<const G*>(gamma),
            static_cast<const G*>(beta), static_cast<T*>(out),
            static_cast<float*>(mean), static_cast<float*>(rstd), n, dim,
            scale, eps);
    return cudaGetLastError();
  }
};

struct DeviceInfo {
  int sms = 0;
  int smem_optin = 0;
  cudaError_t err = cudaSuccess;
};

using device_once::current_device;
using device_once::kMaxDevices;

// The current device's SM count and opt-in shared memory a block, queried
// once a device.
const DeviceInfo& device_info() {
  static DeviceInfo info[kMaxDevices];
  static std::once_flag once[kMaxDevices];
  static const DeviceInfo bad = [] {
    DeviceInfo i;
    i.err = cudaErrorInvalidDevice;
    return i;
  }();
  const int dev = current_device();
  if (dev < 0) return bad;
  std::call_once(once[dev], [dev] {
    DeviceInfo& i = info[dev];
    i.err = cudaDeviceGetAttribute(&i.sms, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (i.err == cudaSuccess)
      i.err = cudaDeviceGetAttribute(
          &i.smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  });
  return info[dev];
}

// How one backward call is cut: the grid, each row group's ring, the
// shared memory.
struct BwdPlan {
  int blocks = 0, threads = 0, rows_per_block = 0, stages = 0;
  int stage_bytes = 0, ring_offset = 0, smem = 0;
  long long workspace_floats(int dim) const {
    return static_cast<long long>(blocks) * 2 * dim;
  }
};

template <typename T, typename M, bool MASK, int VEC, int W, int PER>
cudaError_t plan_bwd(int n, int dim, BwdPlan* p) {
  using L = StageLayout<T, M, MASK, W>;
  constexpr int kGroups = W == 32 ? kWarpRows : 1;
  const DeviceInfo& dev = device_info();
  if (dev.err != cudaSuccess) return dev.err;
  p->threads = W == 32 ? 32 * kWarpRows : W;
  p->ring_offset = round_up(dim * 4, 128);  // after gamma's fp32 copy
  p->stage_bytes = VEC > 1 ? L::bytes(dim) : 0;
  p->stages = VEC > 1 ? (sizeof(T) == 2 ? 3 : 2) : 1;
  // the warps' partials (W = 32), or this block's columns of every
  // block's row for the final sum (at most 2*dim + blocks floats)
  const int fold = std::max(W == 32 ? kGroups * 2 * dim * 4 : 0,
                            (2 * dim + dev.sms * 32) * 4);
  auto smem_of = [&](int s) {
    return p->ring_offset + std::max(kGroups * s * p->stage_bytes, fold);
  };
  // dynamic shared memory a block may take, leaving room for the static
  const int limit = dev.smem_optin - 2048;
  while (p->stages > 1 && smem_of(p->stages) + 128 > limit) --p->stages;
  p->smem = smem_of(p->stages) + 128;  // + the base's alignment slack
  if (p->smem > limit) return cudaErrorInvalidValue;

  // blocks of this instantiation an SM of the current device holds at
  // this shared memory, cached a device as (smem << 32 | blocks); the
  // attribute set below is the current device's too
  static std::atomic<long long> cache[kMaxDevices];
  const int cur = current_device();
  if (cur < 0) return cudaErrorInvalidDevice;
  std::atomic<long long>& cached = cache[cur];
  long long c = cached.load();
  int occ;
  if (c > 0 && static_cast<int>(c >> 32) == p->smem) {
    occ = static_cast<int>(c & 0xffffffffLL);
  } else {
    auto kern = ln_residual_bwd_kernel<T, M, MASK, VEC, W, PER>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern,
                                                        p->threads, p->smem);
    if (e != cudaSuccess) return e;
    if (occ <= 0) return cudaErrorInvalidConfiguration;
    cached.store(static_cast<long long>(p->smem) << 32 | occ);
  }
  const int most = dev.sms * occ;
  int blocks = std::min(most, (n + kGroups - 1) / kGroups);
  p->rows_per_block = (n + blocks - 1) / blocks;
  p->blocks = (n + p->rows_per_block - 1) / p->rows_per_block;
  return cudaSuccess;
}

// The backward's instantiation for (rows, mask, vector path, D): calls
// op.template run<T, M, MASK, VEC, W, PER>().
template <typename Op>
cudaError_t dispatch_bwd(int dtype, int mask_kind, int vec, int dim,
                         const Op& op) {
  return by_dtype(dtype, [&](auto t) {
    using T = typename decltype(t)::type;
    return by_mask(mask_kind, [&](auto m, auto has) {
      using M = typename decltype(m)::type;
      constexpr bool MASK = decltype(has)::value;
      constexpr int kVec = 16 / sizeof(T);
      // without the 16-byte path a block takes each row group (any D)
      if (!vec) return op.template run<T, M, MASK, 1, kBlockThreads, 32>();
      // values a thread holds: the fewest of 8/16/24/32 that cover D for
      // a warp, of 16/32 for a block
      if (dim <= kWarpMaxDim) {
        switch ((dim + 32 * 8 - 1) / (32 * 8)) {
          case 1:
            return op.template run<T, M, MASK, kVec, 32, 8>();
          case 2:
            return op.template run<T, M, MASK, kVec, 32, 16>();
          case 3:
            return op.template run<T, M, MASK, kVec, 32, 24>();
          default:
            return op.template run<T, M, MASK, kVec, 32, 32>();
        }
      }
      return dim <= kBlockThreads * 16
                 ? op.template run<T, M, MASK, kVec, kBlockThreads, 16>()
                 : op.template run<T, M, MASK, kVec, kBlockThreads, 32>();
    });
  });
}

struct BwdPlanOp {
  int n, dim;
  BwdPlan* plan;
  template <typename T, typename M, bool MASK, int VEC, int W, int PER>
  cudaError_t run() const {
    return plan_bwd<T, M, MASK, VEC, W, PER>(n, dim, plan);
  }
};

struct BwdLaunchOp {
  BwdArgs args;
  long long workspace_floats;
  int ticket_count;
  cudaStream_t stream;
  template <typename T, typename M, bool MASK, int VEC, int W, int PER>
  cudaError_t run() const {
    BwdPlan p;
    cudaError_t e =
        plan_bwd<T, M, MASK, VEC, W, PER>(args.n, args.dim, &p);
    if (e != cudaSuccess) return e;
    if (p.workspace_floats(args.dim) > workspace_floats || ticket_count < 2)
      return cudaErrorInvalidValue;
    BwdArgs a = args;
    a.rows_per_block = p.rows_per_block;
    a.stages = p.stages;
    a.stage_bytes = p.stage_bytes;
    a.ring_offset = p.ring_offset;
    // cooperative: every block resident at once (or no launch), which
    // the grid barrier before the fold relies on
    void* params[] = {&a};
    e = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(
            ln_residual_bwd_kernel<T, M, MASK, VEC, W, PER>),
        dim3(p.blocks), dim3(p.threads), params, p.smem, stream);
    return e != cudaSuccess ? e : cudaGetLastError();
  }
};

}  // namespace

extern "C" {

// x, h, out (n, d) contiguous in the row dtype (0 = float32, 1 = bfloat16,
// 2 = float16); gamma, beta (d,) in gamma_dtype (same codes); mask (n, d)
// of mask_kind (0 = none at p = 0, 1 = uint8/bool, 2 = float32,
// 3 = bfloat16, 4 = float16); mean, rstd (n,) float32. vec = 1: d is a
// multiple of 16 bytes' worth of row values and every pointer is aligned
// to that many of its own elements.
int ln_residual_fwd(const void* x, const void* h, const void* mask,
                    const void* gamma, const void* beta, void* out,
                    void* mean, void* rstd, int n, int d, float scale,
                    float eps, int dtype, int gamma_dtype, int mask_kind,
                    int vec, void* stream) {
  if (dtype < 0 || dtype > 2 || bad_shape(n, d, vec, elem_size(dtype)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Fwd op{x, h, mask, gamma, beta, out, mean, rstd, n, d, scale, eps,
               static_cast<cudaStream_t>(stream)};
  return static_cast<int>(by_dtype(dtype, [&](auto t) {
    using T = typename decltype(t)::type;
    return by_dtype(gamma_dtype, [&](auto g) {
      using G = typename decltype(g)::type;
      return by_mask(mask_kind, [&](auto m, auto has) {
        using M = typename decltype(m)::type;
        constexpr bool MASK = decltype(has)::value;
        constexpr int kVec = 16 / sizeof(T);
        // without the 16-byte path a block takes each row (any D)
        if (!vec) return op.launch<T, G, M, MASK, 1, kBlockThreads>();
        return d <= kWarpMaxDim
                   ? op.launch<T, G, M, MASK, kVec, 32>()
                   : op.launch<T, G, M, MASK, kVec, kBlockThreads>();
      });
    });
  }));
}

// The backward's scratch: the fp32 floats of ``work`` that a call with
// these arguments needs (2 d for each block of its grid).
int ln_residual_bwd_workspace(int n, int d, int dtype, int mask_kind,
                              int vec, long long* floats) {
  if (dtype < 0 || dtype > 2 || bad_shape(n, d, vec, elem_size(dtype)))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdPlan p;
  const cudaError_t e =
      dispatch_bwd(dtype, mask_kind, vec, d, BwdPlanOp{n, d, &p});
  if (e != cudaSuccess) return static_cast<int>(e);
  *floats = p.workspace_floats(d);
  return 0;
}

// The backward: x, h, mask, mean, rstd as saved by the forward, dout like
// x (the same codes and vec rule as the forward); writes dx, dh (n, d) in
// the row dtype and dgamma, dbeta (d,) in gamma_dtype. work: fp32 scratch
// of at least ln_residual_bwd_workspace's floats; tickets: ticket_count
// int32 counters, zero before the first call and left zero by every call
// (one set per stream: calls on one stream may share them).
int ln_residual_bwd(const void* x, const void* h, const void* mask,
                    const void* gamma, const void* mean, const void* rstd,
                    const void* dout, void* dx, void* dh, void* dgamma,
                    void* dbeta, void* work, long long work_floats,
                    void* tickets, int ticket_count, int n, int d,
                    float scale, int dtype, int gamma_dtype, int mask_kind,
                    int vec, void* stream) {
  if (dtype < 0 || dtype > 2 || gamma_dtype < 0 || gamma_dtype > 2 ||
      bad_shape(n, d, vec, elem_size(dtype)))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a{};
  a.x = x;
  a.h = h;
  a.mask = mask;
  a.gamma = gamma;
  a.mean = static_cast<const float*>(mean);
  a.rstd = static_cast<const float*>(rstd);
  a.dout = dout;
  a.dx = dx;
  a.dh = dh;
  a.dgamma = dgamma;
  a.dbeta = dbeta;
  a.part = static_cast<float*>(work);
  a.tickets = static_cast<int*>(tickets);
  a.n = n;
  a.dim = d;
  a.gamma_dtype = gamma_dtype;
  a.scale = scale;
  return static_cast<int>(dispatch_bwd(
      dtype, mask_kind, vec, d,
      BwdLaunchOp{a, work_floats, ticket_count,
                  static_cast<cudaStream_t>(stream)}));
}

const char* ln_residual_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
