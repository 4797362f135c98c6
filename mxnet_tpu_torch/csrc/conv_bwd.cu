// Fused conv3x3 + BatchNorm + ReLU backward for Hopper (sm_90a), fp32,
// NCHW: kernel 8 of the port.
//
// Replaces the TPU kernel of mxnet_tpu/ops/pallas_conv_bwd.py:
//   conv_bwd_dgrad_kernel, conv_bwd_wgrad_kernel (+ conv_bwd_reduce_kernel)
//     <- _bwd_kernel (launched by fused_conv3x3_bn_relu_bwd).
// Inputs: da and y (N, O, H, W), x (N, C, H, W), the weights as
// wt[kh][kw][o][c] (w OIHW permuted by the caller), and the stats pass's
// (8, O) vector vec = [mu, inv, gamma, beta, c1, c2, s1, 0]. On every tile
// the kernels recompute, each operation rounded on its own (no FMA
// contraction, so the mask and dy are the plain version's bit for bit),
//   xhat = (y - mu)*inv,  dz = (gamma*xhat + beta > 0) ? da : 0,
//   dy   = s1*((dz - c1) - xhat*c2),
// and then, with zero padding of one pixel (stride 1, SAME),
//   dgrad: dx[n,c,h,w] = sum_{o,kh,kw} dy[n,o,h+1-kh,w+1-kw] * w[o,c,kh,kw]
//   wgrad: dw[o,c,kh,kw] = sum_{n,h,w} dy[n,o,h,w] * x[n,c,h+kh-1,w+kw-1]
// in fp32. dy is never written to device memory.
//
// What bounds it on the H100: operations. Both products are 18*M*C*O
// flops (M = N*H*W): at ResNet-50's four 3x3 stages (batch 32, C = O =
// 64..512) 14.8 GFLOP a call, 0.22 ms at the 67 TFLOP/s fp32 rate, against
// ~0.03 ms for the bytes (da, y and x read once, dx and dw written once).
//
// What the design does about it: both products are implicit GEMMs on
// 64 x 64 output tiles with a reduction step of 16, 256 threads a block,
// each thread a 4 x 4 register tile of fp32 FMAs fed by two 16-byte
// shared-memory loads a step (the operands' rows are 64 wide, so a step
// reads 8 values for 16 FMAs). dgrad's rows are pixels and its columns
// input channels; its reduction walks 16 output channels at a time and,
// inside, the 9 taps, so the 16 x 64 dy tile of each tap is recomputed from
// da and y (cached in L1/L2) as it is loaded and the stats vector of those
// 16 channels sits in shared memory. wgrad's rows are output channels and
// its columns (c, kh, kw) in OIHW order, so its output is dw's own layout;
// its reduction over the pixels is cut into `splits` runs (enough blocks to
// fill the card where O x 9C is small), each run writing its own fp32
// partial of dw, which conv_bwd_reduce_kernel sums in a fixed order. No
// atomics: two launches on equal inputs give equal bits. No tensor cores,
// TMA or wgmma in this first version (the redesign's work): the kernels
// are plain fp32 FMAs on shared-memory tiles, without double buffering.
// Ragged edges (pixels, channels, taps) are masked by index.
//
// Plain C interface, bound from Python with ctypes: every launch goes onto
// the caller's stream, allocates nothing and is checked with
// cudaGetLastError().

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;   // output tile, rows and columns
constexpr int kDepth = 16;  // reduction step
constexpr int kPad = 4;     // wgrad's shared rows: 68 floats, 16-byte aligned
constexpr int kStats = 7;   // mu, inv, gamma, beta, c1, c2, s1

// dy of one element from da, y and its channel's stats (sv[row * stride]).
__device__ __forceinline__ float recompute_dy(float da, float y,
                                              const float* sv, int stride) {
  const float mu = sv[0], inv = sv[stride], gamma = sv[2 * stride];
  const float beta = sv[3 * stride], c1 = sv[4 * stride];
  const float c2 = sv[5 * stride], s1 = sv[6 * stride];
  const float xhat = __fmul_rn(__fsub_rn(y, mu), inv);
  const float z = __fadd_rn(__fmul_rn(gamma, xhat), beta);
  const float dz = z > 0.f ? da : 0.f;
  return __fmul_rn(s1, __fsub_rn(__fsub_rn(dz, c1), __fmul_rn(xhat, c2)));
}

// One 16-step of a 64 x 64 tile: a thread's rows r0..r0+3 of sa (16 x lda)
// times its columns c0..c0+3 of sb (16 x ldb).
template <int LDA, int LDB>
__device__ __forceinline__ void tile_fma(float (*sa)[LDA], float (*sb)[LDB],
                                         int r0, int c0,
                                         float (&acc)[4][4]) {
#pragma unroll
  for (int k = 0; k < kDepth; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(&sa[k][r0]);
    const float4 b = *reinterpret_cast<const float4*>(&sb[k][c0]);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

// dx tile: 64 pixels (rows m = n*H*W + h*W + w) x 64 input channels.
__global__ void __launch_bounds__(kThreads)
conv_bwd_dgrad_kernel(const float* __restrict__ vec,
                      const float* __restrict__ da,
                      const float* __restrict__ y,
                      const float* __restrict__ wt, float* __restrict__ dx,
                      int N, int H, int W, int C, int O) {
  __shared__ __align__(16) float sa[kDepth][kTile];  // dy: (o, pixel)
  __shared__ __align__(16) float sb[kDepth][kTile];  // w:  (o, c)
  __shared__ float sv[kStats][kDepth];
  const int tid = threadIdx.x;
  const int hw = H * W;
  const int M = N * hw;
  const int m0 = blockIdx.x * kTile;
  const int cb = blockIdx.y * kTile;
  // loads: one pixel / channel column per thread, rows lrow + 4r
  const int lm = tid & (kTile - 1);
  const int lrow = tid >> 6;
  const int pm = m0 + lm;
  const bool pm_ok = pm < M;
  int pn = 0, ph = 0, pw = 0;
  if (pm_ok) {
    pn = pm / hw;
    const int r = pm - pn * hw;
    ph = r / W;
    pw = r - ph * W;
  }
  const int lc = cb + lm;
  // products: rows (pixels) 4*tx.., columns (channels) 4*ty..
  const int tx = tid & 15, ty = tid >> 4;
  float acc[4][4] = {};
  for (int o0 = 0; o0 < O; o0 += kDepth) {
    if (tid < kStats * kDepth) {
      const int row = tid / kDepth, col = tid - row * kDepth;
      sv[row][col] = o0 + col < O ? vec[(size_t)row * O + o0 + col] : 0.f;
    }
    __syncthreads();
    for (int tap = 0; tap < 9; ++tap) {
      const int kh = tap / 3, kw = tap - kh * 3;
      const int hs = ph + 1 - kh, ws = pw + 1 - kw;
      const bool in = pm_ok && hs >= 0 && hs < H && ws >= 0 && ws < W;
      const size_t pix = (size_t)pn * O * hw + (size_t)hs * W + ws;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int lo = lrow + 4 * r;
        const int o = o0 + lo;
        float v = 0.f;
        if (in && o < O) {
          const size_t idx = pix + (size_t)o * hw;
          v = recompute_dy(__ldg(da + idx), __ldg(y + idx), &sv[0][lo],
                           kDepth);
        }
        sa[lo][lm] = v;
        sb[lo][lm] = (o < O && lc < C)
                         ? __ldg(wt + ((size_t)tap * O + o) * C + lc)
                         : 0.f;
      }
      __syncthreads();
      tile_fma<kTile, kTile>(sa, sb, 4 * tx, 4 * ty, acc);
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + 4 * tx + i;
    if (m >= M) continue;
    const int n = m / hw;
    const int r = m - n * hw;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = cb + 4 * ty + j;
      if (c < C) dx[((size_t)n * C + c) * hw + r] = acc[i][j];
    }
  }
}

// dw tile: 64 output channels x 64 columns q = c*9 + kh*3 + kw, over the
// pixel rows [split*rows, min(M, (split+1)*rows)).
__global__ void __launch_bounds__(kThreads)
conv_bwd_wgrad_kernel(const float* __restrict__ vec,
                      const float* __restrict__ da,
                      const float* __restrict__ y,
                      const float* __restrict__ x, float* __restrict__ out,
                      int N, int H, int W, int C, int O, int rows) {
  __shared__ __align__(16) float sa[kDepth][kTile + kPad];  // dy: (pixel, o)
  __shared__ __align__(16) float sb[kDepth][kTile + kPad];  // x:  (pixel, q)
  __shared__ float sv[kStats][kTile];
  const int tid = threadIdx.x;
  const int hw = H * W;
  const int M = N * hw;
  const int K9 = 9 * C;
  const int qb = blockIdx.x * kTile;
  const int ob = blockIdx.y * kTile;
  const int split = blockIdx.z;
  for (int i = tid; i < kStats * kTile; i += kThreads) {
    const int row = i / kTile, col = i - row * kTile;
    sv[row][col] = ob + col < O ? vec[(size_t)row * O + ob + col] : 0.f;
  }
  // loads: one pixel a thread (lm), columns lcol + 16r
  const int lm = tid & 15;
  const int lcol = tid >> 4;
  int qc[4], qh[4], qw[4];
  bool q_ok[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int q = qb + lcol + 16 * r;
    q_ok[r] = q < K9;
    qc[r] = q / 9;
    const int tap = q - qc[r] * 9;
    qh[r] = tap / 3 - 1;
    qw[r] = tap - (tap / 3) * 3 - 1;
  }
  // products: rows (output channels) 4*tx.., columns (q) 4*ty..
  const int tx = tid & 15, ty = tid >> 4;
  float acc[4][4] = {};
  const int mb = split * rows;
  const int me = min(M, mb + rows);
  __syncthreads();
  for (int m0 = mb; m0 < me; m0 += kDepth) {
    const int m = m0 + lm;
    const bool ok = m < me;
    int n = 0, h = 0, w = 0;
    if (ok) {
      n = m / hw;
      const int r = m - n * hw;
      h = r / W;
      w = r - h * W;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int lo = lcol + 16 * r;
      const int o = ob + lo;
      float v = 0.f;
      if (ok && o < O) {
        const size_t idx = ((size_t)n * O + o) * hw + (size_t)h * W + w;
        v = recompute_dy(__ldg(da + idx), __ldg(y + idx), &sv[0][lo], kTile);
      }
      sa[lm][lo] = v;
      const int hs = h + qh[r], ws = w + qw[r];
      float xv = 0.f;
      if (ok && q_ok[r] && hs >= 0 && hs < H && ws >= 0 && ws < W) {
        xv = __ldg(x + ((size_t)n * C + qc[r]) * hw + (size_t)hs * W + ws);
      }
      sb[lm][lo] = xv;
    }
    __syncthreads();
    tile_fma<kTile + kPad, kTile + kPad>(sa, sb, 4 * tx, 4 * ty, acc);
    __syncthreads();
  }
  float* part = out + (size_t)split * O * K9;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int o = ob + 4 * tx + i;
    if (o >= O) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int q = qb + 4 * ty + j;
      if (q < K9) part[(size_t)o * K9 + q] = acc[i][j];
    }
  }
}

// dw = sum over splits of the partials, in split order.
__global__ void conv_bwd_reduce_kernel(const float* __restrict__ part,
                                       float* __restrict__ dw, int splits,
                                       size_t count) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < count;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += part[(size_t)k * count + i];
    dw[i] = s;
  }
}

}  // namespace

extern "C" {

// vec (8, O); da, y (N, O, H, W); x (N, C, H, W); wt (3, 3, O, C); dx (N,
// C, H, W); dw (O, C, 3, 3); part (splits, O, 9C) when splits > 1 (else
// unused: the single split writes dw). All fp32, contiguous, on the device
// of `stream`. Returns the first launch error, or 0.
int conv3x3_bn_relu_bwd(const float* vec, const float* da, const float* y,
                        const float* x, const float* wt, float* dx, float* dw,
                        float* part, int N, int H, int W, int C, int O,
                        int splits, int rows, cudaStream_t stream) {
  const int M = N * H * W;
  const dim3 dgrid((M + kTile - 1) / kTile, (C + kTile - 1) / kTile);
  conv_bwd_dgrad_kernel<<<dgrid, kThreads, 0, stream>>>(vec, da, y, wt, dx,
                                                        N, H, W, C, O);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 wgrid((9 * C + kTile - 1) / kTile, (O + kTile - 1) / kTile,
                   splits);
  conv_bwd_wgrad_kernel<<<wgrid, kThreads, 0, stream>>>(
      vec, da, y, x, splits > 1 ? part : dw, N, H, W, C, O, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t count = (size_t)O * 9 * C;
  const int blocks = static_cast<int>(
      (count + kThreads - 1) / kThreads < 4096
          ? (count + kThreads - 1) / kThreads : 4096);
  conv_bwd_reduce_kernel<<<blocks, kThreads, 0, stream>>>(part, dw, splits,
                                                          count);
  return static_cast<int>(cudaGetLastError());
}

const char* conv3x3_bn_relu_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
