// Fused conv3x3 + BatchNorm + ReLU backward for Hopper (sm_90a), fp32 and
// bf16, NCHW: kernel 8 of the port.
//
// Replaces the TPU kernel of mxnet_tpu/ops/pallas_conv_bwd.py:
//   conv_bwd_wsplit_kernel, conv_bwd_dgrad_kernel, conv_bwd_wgrad_kernel
//   (+ conv_bwd_reduce_kernel) <- _bwd_kernel (launched by
//   fused_conv3x3_bn_relu_bwd), fp32; and its bf16 instantiation,
//   conv_bwd_wcopy_bf16_kernel, conv_bwd_dgrad_bf16_kernel,
//   conv_bwd_wgrad_bf16_kernel (+ conv_bwd_reduce_kernel storing bf16),
//   described at "the bf16 instantiation" below.
// Inputs: da and y (N, O, H, W), x (N, C, H, W), the weights w (O, C, 3,
// 3), and the stats pass's (8, O) vector vec = [mu, inv, gamma, beta, c1,
// c2, s1, 0]. The kernels recompute, each operation rounded on its own (no
// FMA contraction, so the mask and dy are the plain version's bit for bit),
//   xhat = (y - mu)*inv,  dz = (gamma*xhat + beta > 0) ? da : 0,
//   dy   = s1*((dz - c1) - xhat*c2),
// and then, with zero padding of one pixel (stride 1, SAME),
//   dgrad: dx[n,c,h,w] = sum_{o,kh,kw} dy[n,o,h+1-kh,w+1-kw] * w[o,c,kh,kw]
//   wgrad: dw[o,c,kh,kw] = sum_{n,h,w} dy[n,o,h,w] * x[n,c,h+kh-1,w+kw-1]
// to fp32 accuracy. dy is never written to device memory.
//
// What bounds it on the H100: operations. Both products are 18*M*C*O
// flops (M = N*H*W): at ResNet-50's four 3x3 stages (batch 32, C = O =
// 64..512) 14.8 GFLOP a call. Both run on the tensor cores as 3xTF32 (x =
// hi + lo, a.b = a.lo b.hi + a.hi b.lo + a.hi b.hi, as the fp32 flash
// kernels do; one TF32 pass would miss fp32 accuracy), three TF32
// products each: 0.09 ms at the 495 TFLOP/s TF32 rate, against 0.22 ms
// for fp32 FMAs at 67 TFLOP/s and ~0.03 ms for the bytes (da, y and x read
// once, dx and dw written once).
//
// The design:
// - The padded grid. Both products index pixels by their place in a grid
//   with one zero column after every image row and one zero row after
//   every image (row stride W+1, (H+1)(W+1) places an image). A 3x3 tap
//   is then a constant shift of the place, (dh)(W+1) + dw, and lands on a
//   zero place wherever the tap leaves the image, so a tile of consecutive
//   places with a halo of W+2 places on each side holds every neighbour
//   its taps read, already zero-padded. A linear tile keeps the mma tiles
//   full at any W (a tile of whole image rows would leave 16-row mma tiles
//   part empty at 7 x 7); the zero places cost (H+W+1)/((H+1)(W+1)) of
//   dgrad's rows (3.5% at 56 x 56, 23% at 7 x 7).
// - Split once. Every operand value is split into its hi and lo TF32
//   parts, with the inf/NaN check (mma_common.cuh), once, when it is
//   written into shared memory: two planes, so a fragment is a plain
//   ldmatrix (or shared load) and no warp repeats a split. The weights
//   are split by a prepare pass (conv_bwd_wsplit_kernel) into planes
//   [hi|lo][tap][c][o], o padded with zeros to a multiple of 8.
// - dgrad (conv_bwd_dgrad_kernel): a block owns 128 places x 64 input
//   channels (8 warps of 32 x 32), two blocks an SM. For each chunk of 8
//   output channels it copies da and y of its halo (128 + 2(W+2) places,
//   rows as they lie in memory), recomputes dy once into the halo planes,
//   and the 9 taps are 9 shifted ldmatrix reads of them against the weight
//   tile of each tap: 24 mma.sync m16n8k8 a tap and warp. Where the grid
//   of blocks is thin (7 x 7) or O is long, the output channels are cut
//   into `dsplits` runs, each writing its own fp32 partial of dx, summed
//   in a fixed order by conv_bwd_reduce_kernel.
// - wgrad (conv_bwd_wgrad_kernel): a block owns 32 output x 32 input
//   channels x all 9 taps (9 warps, one a tap, 32 x 32 each), two blocks
//   an SM. Its reduction runs over chunks of real pixels (not the zero
//   places, whose 0 * inf would put a NaN where the plain version has
//   none): a patch of PR x PC pixels of one image where such patches tile
//   it (8 x 8 at 56 x 56, 4 x 14 at 28 x 28: a halo of (PR+2)(PC+2) x
//   places), else 64 consecutive pixels (a halo of their places plus W+2
//   on each side). For each chunk it recomputes the 32 x 64 dy tile once
//   and loads the chunk's x halo once; each warp reads its tap's shifted
//   view of the halo through a table of the pixels' places. The chunks
//   are cut into `splits` runs, each writing its own fp32 partial of dw,
//   summed in a fixed order by conv_bwd_reduce_kernel. dw comes out in
//   OIHW.
// - Overlap: a two-stage ring of cp.async copies. The next chunk's da, y
//   and x (or weight tiles) are copied while the current chunk's products
//   run. dgrad's da and y land in rows of places (4-byte copies in a
//   row's order, free of bank conflicts) and are split into the planes;
//   wgrad's land in the hi and lo slots of the chunk's planes (lanes along
//   pixels, coalesced) and are split in place, x likewise.
// - Accuracy: the tensor core's fp32 accumulation is not round-to-nearest
//   and its error grows with the count of mma summed into one register.
//   Both kernels sum a run straight into their accumulators and bound the
//   run instead: at most 32 chunks a split (dgrad_splits, wgrad_splits in
//   ops/conv_bwd.py), 32 x 27 or 32 x 24 mma into one register, ~1e-5 of
//   the largest value. A zeroed partial a chunk (the flash kernels' way)
//   measured 7e-7 but costs 32 registers a thread, which spilled wgrad at
//   the 96 registers of two 288-thread blocks an SM (one block an SM ran
//   it slower) and slowed dgrad's unrolled taps.
// - Measured on the H100 (PERF.md): both kernels run at ~30% of the
//   card's mma.sync TF32 rate, with the copies and splits of a chunk not
//   hidden behind its products. Neither wider warp tiles (64 x 32), half
//   the weight traffic (256-place blocks), producer warps that copy and
//   split while 8 consumer warps multiply (one block an SM), nor wgmma
//   with both operands in shared memory (a shifted run of halo places is
//   a K-major tile without swizzle; its double-buffered planes leave one
//   block an SM at 56 x 56) made dgrad faster over a step; dgrad beside
//   wgrad on two streams was barely faster.
// - No atomics: two launches on equal inputs give equal bits.
//
// Plain C interface, bound from Python with ctypes: every launch goes onto
// the caller's stream, allocates nothing and is checked with
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "mma_common.cuh"

namespace {

using namespace mma_common;

constexpr int kStats = 7;   // mu, inv, gamma, beta, c1, c2, s1
constexpr int kTaps = 9;
constexpr int kChunk = 8;   // dgrad: output channels a chunk (one k8 step)
// dgrad
constexpr int kDgThreads = 256;  // 8 warps: 4 along places x 2 along c
constexpr int kDgRows = 128;     // places a block
constexpr int kDgCols = 64;      // input channels a block
constexpr int kWTile = kTaps * kDgCols * kChunk;  // one plane of a w stage
// wgrad
constexpr int kWgThreads = 288;  // 9 warps, one a tap
constexpr int kWgRows = 32;      // output channels a block
constexpr int kWgCols = 32;      // input channels a block
constexpr int kWgPixels = 64;    // pixels a chunk
constexpr int kWgLd = kWgPixels + 4;  // dy plane row stride: ldmatrix rows
                                      // 272 bytes apart hit 8 bank groups
constexpr int kDyPlane = kWgRows * kWgLd;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// dgrad's halo: the block's 128 places and W+2 on each side
__host__ __device__ inline int dgrad_halo(int W) {
  return kDgRows + 2 * (W + 1) + 2;
}

// row stride of dgrad's raw da / y rows: 4 mod 8 words, so the two
// channel halves a warp reads in its convert step fall in distinct banks
__host__ __device__ inline int dgrad_raw_ld(int W) {
  return cdiv(dgrad_halo(W), 8) * 8 + 4;
}

__host__ __device__ inline size_t dgrad_smem_bytes(int W) {
  const int halo = dgrad_halo(W);
  return sizeof(uint32_t) * (2 * 2 * static_cast<size_t>(kWTile) +
                             2 * static_cast<size_t>(halo) * kChunk +
                             2 * static_cast<size_t>(dgrad_raw_ld(W)) * kChunk +
                             halo + kStats * kChunk);
}

// wgrad's x halo of a linear chunk, an upper bound over chunks: 64
// consecutive pixels span at most 63 + (row breaks) + (image breaks)(W+1)
// places, and the taps reach W+2 places further on each side
__host__ __device__ inline int wgrad_linear_halo(int H, int W) {
  constexpr int k = kWgPixels - 1;
  const int rb = k / W + 1 < k ? k / W + 1 : k;
  const int ib = k / (H * W) + 1 < k ? k / (H * W) + 1 : k;
  return k + rb + ib * (W + 1) + 2 * (W + 1) + 3;
}

// wgrad's chunk: a patch of PR x PC pixels of one image where such patches
// tile the image (PR | H, PC | W) with 56..64 pixels and a halo, (PR+2) x
// (PC+2), smaller per pixel than the linear chunk's; else (0, 0): 64
// consecutive pixels. The largest patch wins, then the smallest halo, then
// the widest.
inline void wgrad_patch(int H, int W, int& PR, int& PC) {
  PR = PC = 0;
  for (int pc = 1; pc <= W && pc <= kWgPixels; ++pc) {
    if (W % pc) continue;
    int pr = kWgPixels / pc;
    while (H % pr) --pr;
    const int area = pr * pc, halo = (pr + 2) * (pc + 2);
    const int best = PR * PC, best_halo = (PR + 2) * (PC + 2);
    if (area > best || (area == best && halo <= best_halo)) {
      PR = pr;
      PC = pc;
    }
  }
  if (PR * PC < 56 || (PR + 2) * (PC + 2) * kWgPixels >=
                          wgrad_linear_halo(H, W) * PR * PC)
    PR = PC = 0;
}

// wgrad's x halo: a patch's (PR+2) rows of PC+2 places, and where the
// patch has fewer than 64 pixels, 2 more zero rows and 3 places that the
// missing pixels' taps read
__host__ __device__ inline int wgrad_halo(int H, int W, int PR, int PC) {
  if (PR == 0) return wgrad_linear_halo(H, W);
  return PR * PC < kWgPixels ? (PR + 4) * (PC + 2) + 3 : (PR + 2) * (PC + 2);
}

// x plane row stride: 4 mod 8 words, so the 8 rows g of a B fragment load
// fall in distinct banks
__host__ __device__ inline int wgrad_xs(int xh) { return cdiv(xh, 8) * 8 + 4; }

inline size_t wgrad_smem_bytes(int H, int W, int PR, int PC) {
  const int xh = wgrad_halo(H, W, PR, PC);
  return sizeof(uint32_t) *
         (2 * 2 * static_cast<size_t>(kDyPlane) +
          2 * 2 * static_cast<size_t>(kWgCols) * wgrad_xs(xh) +
          3 * (2 * kWgPixels + static_cast<size_t>(xh) + 1) +
          kStats * kWgRows);
}

// dy of one element from da, y and its channel's stats s[0..6]
__device__ __forceinline__ float recompute_dy(float da, float y,
                                              const float (&s)[kStats]) {
  const float xhat = __fmul_rn(__fsub_rn(y, s[0]), s[1]);
  const float z = __fadd_rn(__fmul_rn(s[2], xhat), s[3]);
  const float dz = z > 0.f ? da : 0.f;
  return __fmul_rn(s[6], __fsub_rn(__fsub_rn(dz, s[4]), __fmul_rn(xhat, s[5])));
}

// the element offset (n*chans*H*W + h*W + w) of place q of the padded grid
// in an NCHW tensor of `chans` channels, or -1 for a zero place
__device__ __forceinline__ int place_offset(int q, int H, int W, int P,
                                            int chans) {
  if (q < 0 || q >= P) return -1;
  const int Wp = W + 1, HpWp = (H + 1) * Wp;
  const int n = q / HpWp, rem = q - n * HpWp, r = rem / Wp, w = rem - r * Wp;
  return r < H && w < W ? n * chans * H * W + r * W + w : -1;
}

// the place of pixel m = n*H*W + h*W + w (m past the last pixel continues
// into zero places)
__device__ __forceinline__ int place_of(int m, int H, int W) {
  const int HW = H * W, Wp = W + 1;
  const int n = m / HW, rem = m - n * HW, r = rem / W;
  return n * (H + 1) * Wp + r * Wp + (rem - r * W);
}

// the 16-byte half kc of shared row `row` (8 words), halves swapped on
// every other group of 4 rows: 8 consecutive rows, from any start, then
// hit 8 distinct bank groups in an ldmatrix
__device__ __forceinline__ int swz(int row, int kc) {
  return (kc ^ ((row >> 2) & 1)) << 2;
}

// w (O, C, 3, 3) -> wsp [2][9][C][Opad]: the hi and lo TF32 parts, zero
// for o >= O; a 32 x 32 tile of the (O, 9C) matrix a block, transposed
// through shared memory so both the reads and the writes are coalesced
__global__ void __launch_bounds__(256)
conv_bwd_wsplit_kernel(const float* __restrict__ w, uint32_t* __restrict__ wsp,
                       int C, int O, int Opad) {
  __shared__ float t[32][33];
  const int K9 = kTaps * C;
  const int q0 = blockIdx.x * 32, o0 = blockIdx.y * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int r = ty; r < 32; r += 8) {
    const int o = o0 + r, q = q0 + tx;
    t[r][tx] = o < O && q < K9 ? __ldg(w + static_cast<size_t>(o) * K9 + q)
                               : 0.f;
  }
  __syncthreads();
  const size_t plane = static_cast<size_t>(K9) * Opad;
  for (int r = ty; r < 32; r += 8) {
    const int q = q0 + r, o = o0 + tx;
    if (q >= K9 || o >= Opad) continue;
    const int c = q / kTaps, tap = q - c * kTaps;
    uint32_t hi, lo;
    split<true>(t[tx][r], hi, lo);
    const size_t i = (static_cast<size_t>(tap) * C + c) * Opad + o;
    wsp[i] = hi;
    wsp[plane + i] = lo;
  }
}

// dx (or a partial of it) for 128 places x 64 input channels, over the
// output-channel chunks [blockIdx.z * cps, min(chunks, (blockIdx.z+1) cps))
__global__ void __launch_bounds__(kDgThreads, 2)
conv_bwd_dgrad_kernel(const float* __restrict__ vec,
                      const float* __restrict__ da,
                      const float* __restrict__ y,
                      const uint32_t* __restrict__ wsp,
                      float* __restrict__ out, int N, int H, int W, int C,
                      int O, int Opad, int cps) {
  extern __shared__ __align__(16) uint32_t sm[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Wp = W + 1, HW = H * W, P = N * (H + 1) * Wp;
  const int halo = dgrad_halo(W);
  const int hplane = halo * kChunk, rld = dgrad_raw_ld(W);
  uint32_t* wring = sm;                 // [2 stages][hi|lo][9][64][8]
  uint32_t* hs = sm + 2 * 2 * kWTile;   // dy planes [hi|lo][halo][8]
  float* raw = reinterpret_cast<float*>(hs + 2 * hplane);  // [da|y][8][rld]
  float* sstat = raw + 2 * kChunk * rld;                      // [7][8]
  int* pix = reinterpret_cast<int*>(sstat + kStats * kChunk);  // [halo]
  const int p0 = blockIdx.x * kDgRows;
  const int cb = blockIdx.y * kDgCols;
  const int c_begin = blockIdx.z * cps;
  const int c_end = min(cdiv(O, kChunk), c_begin + cps);
  const size_t wplane = static_cast<size_t>(kTaps) * C * Opad;

  for (int q = tid; q < halo; q += kDgThreads)
    pix[q] = place_offset(p0 - Wp - 1 + q, H, W, P, O);
  __syncthreads();

  // chunk ci's stats, da and y (rows of places, as they lie in memory),
  // and its 9 weight tiles into stage st of the ring
  auto issue = [&](int ci, int st) {
    const int o0 = ci * kChunk;
    if (tid < kStats * kChunk) {
      const int r = tid / kChunk, o = o0 + tid % kChunk;
      cp_async4(sstat + tid,
                vec + static_cast<size_t>(r) * O + (o < O ? o : 0), o < O);
    }
    for (int q = tid; q < halo; q += kDgThreads) {
      const int off = pix[q];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const bool ok = off >= 0 && o0 + j < O;
        const size_t g = ok ? off + static_cast<size_t>(o0 + j) * HW : 0;
        cp_async4(raw + j * rld + q, da + g, ok);
        cp_async4(raw + (kChunk + j) * rld + q, y + g, ok);
      }
    }
    uint32_t* ws = wring + st * 2 * kWTile;
    for (int i = tid; i < 2 * kTaps * kDgCols * 2; i += kDgThreads) {
      const int half = i & 1, row = (i >> 1) % kDgCols;
      const int pt = (i >> 1) / kDgCols;  // plane * 9 + tap
      const int plane = pt / kTaps, tap = pt - plane * kTaps;
      const bool ok = cb + row < C;
      const uint32_t* src =
          wsp + plane * wplane +
          (static_cast<size_t>(tap) * C + (ok ? cb + row : 0)) * Opad + o0 +
          half * 4;
      cp_async16(ws + (pt * kDgCols + row) * kChunk + swz(row, half), src,
                 ok);
    }
    cp_async_commit();
  };

  // dy of chunk ci into the hi and lo planes: a thread takes 4 channels
  // (half kc) of every 128th place
  const int kc = tid & 1;
  auto convert = [&](int ci) {
    const int o0 = ci * kChunk + 4 * kc;
    float s[4][kStats];
#pragma unroll
    for (int r = 0; r < kStats; ++r) {
      const float4 v =
          *reinterpret_cast<const float4*>(sstat + r * kChunk + 4 * kc);
      s[0][r] = v.x;
      s[1][r] = v.y;
      s[2][r] = v.z;
      s[3][r] = v.w;
    }
    for (int q = tid >> 1; q < halo; q += kDgThreads / 2) {
      const int slot = q * kChunk + swz(q, kc);
      float av[4], bv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        av[j] = raw[(4 * kc + j) * rld + q];
        bv[j] = raw[(kChunk + 4 * kc + j) * rld + q];
      }
      const bool in = pix[q] >= 0;
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float v =
            in && o0 + j < O ? recompute_dy(av[j], bv[j], s[j]) : 0.f;
        split<true>(v, hi[j], lo[j]);
      }
      *reinterpret_cast<uint4*>(hs + slot) = make_uint4(hi[0], hi[1], hi[2],
                                                        hi[3]);
      *reinterpret_cast<uint4*>(hs + hplane + slot) =
          make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
  };

  // warp tile: places wm*32.., channels wn*32..; shared-memory addresses
  // in bytes: this lane's A row (the halo place of its output row for the
  // tap (2, 2), shift 0) and its B rows of the two n16 halves
  const int wm = warp & 3, wn = warp >> 2;
  const int a_row = wm * 32 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_kc = lane >> 4;
  const uint32_t a_base = smem_addr(hs);
  uint32_t b_base[2];
#pragma unroll
  for (int jj = 0; jj < 2; ++jj) {
    const int n = wn * 32 + jj * 16 + ((lane >> 4) & 1) * 8 + (lane & 7);
    b_base[jj] = smem_addr(wring) + 4 * (n * kChunk + swz(n, (lane >> 3) & 1));
  }
  float acc[2][4][4] = {};

  // the mma of a chunk go straight into acc: a split sums at most 32
  // chunks (dgrad_splits), 27 x 32 mma into one register
  auto products = [&](int st) {
    const uint32_t ws = 4 * st * 2 * kWTile;
#pragma unroll
    for (int tap = 0; tap < kTaps; ++tap) {
      const int kh = tap / 3, kw = tap - 3 * kh;
      // the place this lane reads; +16 rows keeps the swizzle bit
      const int q = a_row + (2 - kh) * Wp + (2 - kw);
      const uint32_t a = a_base + 4 * (q * kChunk + swz(q, a_kc));
      uint32_t ahi[2][4], alo[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        ldsm_x4_at(ahi[i], a + 4 * 16 * kChunk * i);
        ldsm_x4_at(alo[i], a + 4 * (16 * kChunk * i + hplane));
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        uint32_t bh[4], bl[4];
        const uint32_t b = b_base[jj] + ws + 4 * tap * kDgCols * kChunk;
        ldsm_x4_at(bh, b);
        ldsm_x4_at(bl, b + 4 * kWTile);
#pragma unroll
        for (int jt = 0; jt < 2; ++jt) {
          const uint32_t bhi[2] = {bh[2 * jt], bh[2 * jt + 1]};
          const uint32_t blo[2] = {bl[2 * jt], bl[2 * jt + 1]};
#pragma unroll
          for (int i = 0; i < 2; ++i)
            mma_3xtf32(acc[i][2 * jj + jt], ahi[i], alo[i], bhi, blo);
        }
      }
    }
  };

  if (c_begin < c_end) issue(c_begin, 0);
  int st = 0;
  for (int ci = c_begin; ci < c_end; ++ci, st ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // chunk ci landed; every warp is past chunk ci-1
    convert(ci);
    __syncthreads();  // chunk ci's dy planes are written, its raw rows read
    if (ci + 1 < c_end) issue(ci + 1, st ^ 1);
    products(st);
  }

  float* dst = out + static_cast<size_t>(blockIdx.z) * N * C * HW;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int off = place_offset(p0 + wm * 32 + 16 * i + g + 8 * h, H, W,
                                   P, C);
      if (off < 0) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = cb + wn * 32 + 8 * j + 2 * t + e;
          if (c < C) dst[off + static_cast<size_t>(c) * HW] = acc[i][j][2 * h + e];
        }
      }
    }
  }
}

// dw (or a partial of it) for 32 output x 32 input channels x 9 taps, over
// the chunks [blockIdx.z * cps, min(chunks, (blockIdx.z + 1) * cps)): PR x
// PC patches, or (PR = 0) runs of 64 consecutive pixels
__global__ void __launch_bounds__(kWgThreads, 2)
conv_bwd_wgrad_kernel(const float* __restrict__ vec,
                      const float* __restrict__ da,
                      const float* __restrict__ y,
                      const float* __restrict__ x, float* __restrict__ out,
                      int N, int H, int W, int C, int O, int PR, int PC,
                      int cps) {
  extern __shared__ __align__(16) uint32_t sm[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Wp = W + 1, HW = H * W, M = N * HW, P = N * (H + 1) * Wp;
  const int XH = wgrad_halo(H, W, PR, PC), XS = wgrad_xs(XH);
  const int HS = PR ? PC + 2 : Wp;  // the x halo's row stride
  const int per_image = PR ? (H / PR) * (W / PC) : 0;
  const int xplane = kWgCols * XS;
  uint32_t* dring = sm;                    // [2 stages][hi|lo][32][kWgLd]
  uint32_t* xring = sm + 2 * 2 * kDyPlane;  // [2 stages][hi|lo][32][XS]
  int* kpix = reinterpret_cast<int*>(xring + 2 * 2 * xplane);  // [3][64]
  int* koff = kpix + 3 * kWgPixels;                             // [3][64]
  int* xpix = koff + 3 * kWgPixels;                             // [3][XH]
  int* xlen = xpix + 3 * XH;                                    // [3]
  float* sstat = reinterpret_cast<float*>(xlen + 3);           // [7][32]
  const int cb = blockIdx.x * kWgCols, ob = blockIdx.y * kWgRows;
  const int total = PR ? N * per_image : cdiv(M, kWgPixels);
  const int kb = blockIdx.z * cps;
  const int chunks = min(total - kb, cps);

  // chunk kb+ci's tables into set tb: each pixel's da/y offset (-1: no
  // pixel) and place in the x halo, each halo place's x offset (-1: zero)
  auto tables = [&](int ci, int tb) {
    int len;
    if (PR == 0) {  // 64 consecutive pixels, past M continuing in zeros
      const int k0 = (kb + ci) * kWgPixels;
      const int xb = place_of(k0, H, W) - Wp - 1;
      len = place_of(k0 + kWgPixels - 1, H, W) + Wp + 2 - xb;
      if (tid < kWgPixels) {
        const int m = k0 + tid;
        kpix[tb * kWgPixels + tid] =
            m < M ? (m / HW) * O * HW + (m - (m / HW) * HW) : -1;
        koff[tb * kWgPixels + tid] = place_of(m, H, W) - xb;
      }
      for (int q = tid; q < len; q += kWgThreads)
        xpix[tb * XH + q] = place_offset(xb + q, H, W, P, C);
    } else {  // a PR x PC patch from (r0, c0) of image n
      const int n = (kb + ci) / per_image, rem = kb + ci - n * per_image;
      const int band = rem / (W / PC);
      const int r0 = band * PR, c0 = (rem - band * (W / PC)) * PC;
      len = XH;
      if (tid < kWgPixels) {
        const int kr = tid / PC, kc = tid - kr * PC;
        const bool in = tid < PR * PC;
        kpix[tb * kWgPixels + tid] =
            in ? n * O * HW + (r0 + kr) * W + c0 + kc : -1;
        koff[tb * kWgPixels + tid] =
            in ? (kr + 1) * HS + kc + 1 : (PR + 3) * HS + 1;
      }
      for (int q = tid; q < len; q += kWgThreads) {
        const int hr = q / HS, r = r0 - 1 + hr, c = c0 - 1 + q - hr * HS;
        xpix[tb * XH + q] = hr < PR + 2 && r >= 0 && r < H && c >= 0 && c < W
                                ? n * C * HW + r * W + c
                                : -1;
      }
    }
    if (tid == 0) xlen[tb] = len;
  };

  // chunk ci's da, y and x into the hi and lo slots of its planes
  auto issue = [&](int ci, int st, int tb) {
    if (tid < 256) {  // lanes along pixels: coalesced
      const int k = tid & (kWgPixels - 1), off = kpix[tb * kWgPixels + k];
      const int o0 = tid >> 6;  // channels o0, o0 + 4, ..
      uint32_t* d = dring + st * 2 * kDyPlane + o0 * kWgLd + k;
      size_t g = (off >= 0 ? off : 0) + static_cast<size_t>(ob + o0) * HW;
#pragma unroll 2
      for (int o = o0; o < kWgRows; o += 4, d += 4 * kWgLd, g += 4 * HW) {
        const bool ok = off >= 0 && ob + o < O;
        cp_async4(d, da + (ok ? g : 0), ok);
        cp_async4(d + kDyPlane, y + (ok ? g : 0), ok);
      }
    }
    uint32_t* xs = xring + st * 2 * xplane;
    const int len = xlen[tb];
    for (int q = tid; q < len; q += kWgThreads) {
      const int off = xpix[tb * XH + q];
#pragma unroll 8
      for (int c = 0; c < kWgCols; ++c) {
        const bool ok = off >= 0 && cb + c < C;
        const size_t g = ok ? off + static_cast<size_t>(cb + c) * HW : 0;
        cp_async4(xs + c * XS + q, x + g, ok);
      }
    }
    cp_async_commit();
  };

  // dy (threads 0..255: channel tid/8, 8 pixels) and x split in place
  for (int i = tid; i < kStats * kWgRows; i += kWgThreads) {
    const int r = i / kWgRows, o = ob + i % kWgRows;
    sstat[i] = o < O ? vec[static_cast<size_t>(r) * O + o] : 0.f;
  }
  auto convert = [&](int st, int tb) {
    if (tid < 256) {
      float s[kStats];
#pragma unroll
      for (int r = 0; r < kStats; ++r) s[r] = sstat[r * kWgRows + (tid >> 3)];
      uint32_t* ds = dring + st * 2 * kDyPlane;
      const int o = tid >> 3, k0 = (tid & 7) * 8;
      const bool och = ob + o < O;
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int col = o * kWgLd + k0 + 4 * v;
        const float4 a = *reinterpret_cast<const float4*>(ds + col);
        const float4 b = *reinterpret_cast<const float4*>(ds + kDyPlane + col);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool in = och && kpix[tb * kWgPixels + k0 + 4 * v + j] >= 0;
          split<true>(in ? recompute_dy(av[j], bv[j], s) : 0.f, hi[j], lo[j]);
        }
        *reinterpret_cast<uint4*>(ds + col) =
            make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(ds + kDyPlane + col) =
            make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
    }
    uint32_t* xs = xring + st * 2 * xplane;
    const int len = xlen[tb];
    for (int q = tid; q < len; q += kWgThreads) {
#pragma unroll 8
      for (int c = 0; c < kWgCols; ++c) {
        uint32_t hi, lo;
        split<true>(__uint_as_float(xs[c * XS + q]), hi, lo);
        xs[c * XS + q] = hi;
        xs[xplane + c * XS + q] = lo;
      }
    }
  };

  // warp `tap`: dw[.., .., kh, kw], reading x at the pixel's place + shift
  const int tap = warp, kh = tap / 3, kw = tap - 3 * kh;
  const int shift = (kh - 1) * HS + (kw - 1);
  const int g = lane >> 2, t = lane & 3;
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 4;
  float acc[2][4][4] = {};

  // shared-memory addresses in bytes: this lane's A rows in the dy planes
  // and its B row g of the x planes
  const uint32_t a_base = smem_addr(dring) + 4 * (a_row * kWgLd + a_col);
  const uint32_t b_base = smem_addr(xring) + 4 * (g * XS + shift);
  const uint32_t k_base = smem_addr(koff) + 4 * t;
  auto products = [&](int st, int tb) {
    const uint32_t ad = a_base + 4 * st * 2 * kDyPlane;
    const uint32_t bx = b_base + 4 * st * 2 * xplane;
    const uint32_t ko = k_base + 4 * tb * kWgPixels;
#pragma unroll
    for (int kk = 0; kk < kWgPixels / 8; ++kk) {
      const uint32_t x0 = bx + 4 * lds32(ko + 32 * kk);
      const uint32_t x1 = bx + 4 * lds32(ko + 32 * kk + 16);
      uint32_t ahi[2][4], alo[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint32_t a = ad + 4 * (16 * i * kWgLd + 8 * kk);
        ldsm_x4_at(ahi[i], a);
        ldsm_x4_at(alo[i], a + 4 * kDyPlane);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t rj = 4 * 8 * j * XS;
        const uint32_t bhi[2] = {lds32(x0 + rj), lds32(x1 + rj)};
        const uint32_t blo[2] = {lds32(x0 + rj + 4 * xplane),
                                 lds32(x1 + rj + 4 * xplane)};
#pragma unroll
        for (int i = 0; i < 2; ++i)
          mma_3xtf32(acc[i][j], ahi[i], alo[i], bhi, blo);
      }
    }
  };

  tables(0, 0);
  if (chunks > 1) tables(1, 1);
  __syncthreads();
  issue(0, 0, 0);
  for (int ci = 0; ci < chunks; ++ci) {
    const int st = ci & 1, tb = ci % 3;
    cp_async_wait_all();
    __syncthreads();  // chunk ci landed; every warp is past chunk ci-1
    convert(st, tb);
    if (ci + 1 < chunks) issue(ci + 1, st ^ 1, (ci + 1) % 3);
    if (ci + 2 < chunks) tables(ci + 2, (ci + 2) % 3);
    __syncthreads();  // chunk ci's planes are split
    products(st, tb);
  }

  float* dst = out + static_cast<size_t>(blockIdx.z) * O * kTaps * C;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = ob + 16 * i + g + 8 * h;
      if (o >= O) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = cb + 8 * j + 2 * t + e;
          if (c < C)
            dst[(static_cast<size_t>(o) * C + c) * kTaps + tap] =
                acc[i][j][2 * h + e];
        }
      }
    }
  }
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// out = sum over splits of the fp32 partials, in split order (stored in
// bf16 for the bf16 instantiation)
template <typename OutT>
__global__ void conv_bwd_reduce_kernel(const float* __restrict__ part,
                                       OutT* __restrict__ out, int splits,
                                       size_t count) {
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < count; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += part[k * count + i];
    store_out(out + i, s);
  }
}

template <typename OutT>
cudaError_t launch_reduce(const float* part, OutT* out, int splits,
                          size_t count, cudaStream_t stream) {
  const size_t blocks = (count + 255) / 256;
  conv_bwd_reduce_kernel<OutT>
      <<<static_cast<int>(blocks < 4096 ? blocks : 4096), 256, 0, stream>>>(
          part, out, splits, count);
  return cudaGetLastError();
}

// -- the bf16 instantiation ----------------------------------------------------
//
// The reference's kernel at bf16 (pallas_conv_bwd.py:61-95, 153-163): dy
// recomputed in fp32 as above and rounded to bf16 (da's dtype), each
// product a bf16 x bf16 product summed in fp32 (mma.sync m16n8k16: one
// instruction where fp32 takes three TF32 products), dx stored in bf16 (x's
// dtype), dw summed in fp32 and stored in bf16 (w's dtype). The structure
// is the fp32 kernels': the padded grid, dgrad over 128 places x 64 input
// channels with a two-stage cp.async ring of weight tiles, wgrad over 32 x
// 32 channels x 9 taps with one warp a tap, the same runs (fp32 partials
// summed in a fixed order by a reduce pass where the reduction splits), no
// atomics. What differs:
// - A chunk of dgrad's reduction is 16 output channels (one k16 step). A
//   row of 16 bf16 is 8 words, the fp32 chunk's row, so the dy plane, the
//   weight tiles, their swizzle and the ldmatrix addressing are the fp32
//   kernel's; there is no split and no lo plane.
// - The weights are copied once into [9][C][Opad] bf16 (Opad = O rounded
//   up to 16), dgrad's layout (conv_bwd_wcopy_bf16_kernel).
// - da, y and x are 2-byte values at places with no 4-byte alignment,
//   below cp.async's smallest copy: both kernels read them with plain
//   loads (dy recomputed on the way into shared memory) between their
//   barriers, so only dgrad's weight tiles overlap the products. This is
//   the simple first design; its time is in PERF.md.
// - wgrad's x operand is gathered from the halo through the pixels' table,
//   two 16-bit values to a register.

using bf16 = __nv_bfloat16;

constexpr int kBChunk = 16;            // dgrad: output channels a chunk
constexpr int kWgLdB = kWgPixels + 8;  // wgrad: dy tile row stride (bf16),
                                       // 144 bytes: 8 ldmatrix rows hit 8
                                       // bank groups

// x halo row stride (bf16): 4 mod 8 words
__host__ __device__ inline int wgrad_xs_bf16(int xh) {
  return cdiv(xh, 16) * 16 + 8;
}

__host__ __device__ inline size_t dgrad_bf16_smem_bytes(int W) {
  const int halo = dgrad_halo(W);
  return sizeof(uint32_t) * (2 * static_cast<size_t>(kWTile) +
                             static_cast<size_t>(halo) * kChunk +
                             kStats * kBChunk + halo);
}

inline size_t wgrad_bf16_smem_bytes(int H, int W, int PR, int PC) {
  const int xh = wgrad_halo(H, W, PR, PC);
  return sizeof(bf16) * (static_cast<size_t>(kWgRows) * kWgLdB +
                         static_cast<size_t>(kWgCols) * wgrad_xs_bf16(xh)) +
         sizeof(uint32_t) * (2 * kWgPixels + static_cast<size_t>(xh) + 1 +
                             kStats * kWgRows);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// w (O, C, 3, 3) bf16 -> wb [9][C][Opad] bf16, zero for o >= O; a 32 x 32
// tile of the (O, 9C) matrix a block, transposed through shared memory
__global__ void __launch_bounds__(256)
conv_bwd_wcopy_bf16_kernel(const unsigned short* __restrict__ w,
                           unsigned short* __restrict__ wb, int C, int O,
                           int Opad) {
  __shared__ unsigned short t[32][34];
  const int K9 = kTaps * C;
  const int q0 = blockIdx.x * 32, o0 = blockIdx.y * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int r = ty; r < 32; r += 8) {
    const int o = o0 + r, q = q0 + tx;
    t[r][tx] = o < O && q < K9 ? w[static_cast<size_t>(o) * K9 + q]
                               : static_cast<unsigned short>(0);
  }
  __syncthreads();
  for (int r = ty; r < 32; r += 8) {
    const int q = q0 + r, o = o0 + tx;
    if (q >= K9 || o >= Opad) continue;
    const int c = q / kTaps, tap = q - c * kTaps;
    wb[(static_cast<size_t>(tap) * C + c) * Opad + o] = t[tx][r];
  }
}

// dx (or an fp32 partial of it) for 128 places x 64 input channels, over
// the 16-channel chunks [blockIdx.z * cps, min(chunks, (blockIdx.z+1) cps))
template <typename OutT>
__global__ void __launch_bounds__(kDgThreads, 2)
conv_bwd_dgrad_bf16_kernel(const float* __restrict__ vec,
                           const bf16* __restrict__ da,
                           const bf16* __restrict__ y,
                           const bf16* __restrict__ wb,
                           OutT* __restrict__ out, int N, int H, int W, int C,
                           int O, int Opad, int cps) {
  extern __shared__ __align__(16) uint32_t sm[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Wp = W + 1, HW = H * W, P = N * (H + 1) * Wp;
  const int halo = dgrad_halo(W);
  uint32_t* wring = sm;                 // [2 stages][9][64][8 words]
  uint32_t* hs = sm + 2 * kWTile;       // dy plane [halo][8 words]
  float* sstat = reinterpret_cast<float*>(hs + halo * kChunk);  // [7][16]
  int* pix = reinterpret_cast<int*>(sstat + kStats * kBChunk);   // [halo]
  const int p0 = blockIdx.x * kDgRows;
  const int cb = blockIdx.y * kDgCols;
  const int c_begin = blockIdx.z * cps;
  const int c_end = min(cdiv(O, kBChunk), c_begin + cps);

  for (int q = tid; q < halo; q += kDgThreads)
    pix[q] = place_offset(p0 - Wp - 1 + q, H, W, P, O);
  __syncthreads();

  // chunk ci's stats and its 9 weight tiles into stage st of the ring
  auto issue = [&](int ci, int st) {
    const int o0 = ci * kBChunk;
    if (tid < kStats * kBChunk) {
      const int r = tid / kBChunk, o = o0 + tid % kBChunk;
      cp_async4(sstat + tid,
                vec + static_cast<size_t>(r) * O + (o < O ? o : 0), o < O);
    }
    uint32_t* ws = wring + st * kWTile;
    for (int i = tid; i < kTaps * kDgCols * 2; i += kDgThreads) {
      const int half = i & 1, row = (i >> 1) % kDgCols;
      const int tap = (i >> 1) / kDgCols;
      const bool ok = cb + row < C;
      const bf16* src = wb +
                        (static_cast<size_t>(tap) * C + (ok ? cb + row : 0)) *
                            Opad +
                        ci * kBChunk + half * 8;
      cp_async16(ws + (tap * kDgCols + row) * kChunk + swz(row, half), src,
                 ok);
    }
    cp_async_commit();
  };

  // dy of chunk ci, rounded to bf16, into the plane: a thread takes all 16
  // channels of every 256th place (lanes along places: coalesced loads)
  auto convert = [&](int ci) {
    const int o0 = ci * kBChunk;
    for (int q = tid; q < halo; q += kDgThreads) {
      const int off = pix[q];
      uint32_t wv[kChunk];
#pragma unroll
      for (int j = 0; j < kBChunk; j += 2) {
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int o = o0 + j + e;
          const bool ok = off >= 0 && o < O;
          const size_t g = ok ? off + static_cast<size_t>(o) * HW : 0;
          const float a = __bfloat162float(da[g]);
          const float b = __bfloat162float(y[g]);
          float s[kStats];
#pragma unroll
          for (int r = 0; r < kStats; ++r) s[r] = sstat[r * kBChunk + j + e];
          v[e] = ok ? recompute_dy(a, b, s) : 0.f;
        }
        wv[j / 2] = pack_bf16x2(v[0], v[1]);
      }
      *reinterpret_cast<uint4*>(hs + q * kChunk + swz(q, 0)) =
          make_uint4(wv[0], wv[1], wv[2], wv[3]);
      *reinterpret_cast<uint4*>(hs + q * kChunk + swz(q, 1)) =
          make_uint4(wv[4], wv[5], wv[6], wv[7]);
    }
  };

  // warp tile: places wm*32.., channels wn*32.., addressed as the fp32
  // kernel's (a row of 16 bf16 is a row of 8 words)
  const int wm = warp & 3, wn = warp >> 2;
  const int a_row = wm * 32 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_kc = lane >> 4;
  const uint32_t a_base = smem_addr(hs);
  uint32_t b_base[2];
#pragma unroll
  for (int jj = 0; jj < 2; ++jj) {
    const int n = wn * 32 + jj * 16 + ((lane >> 4) & 1) * 8 + (lane & 7);
    b_base[jj] = smem_addr(wring) + 4 * (n * kChunk + swz(n, (lane >> 3) & 1));
  }
  float acc[2][4][4] = {};

  auto products = [&](int st) {
    const uint32_t ws = 4 * st * kWTile;
#pragma unroll
    for (int tap = 0; tap < kTaps; ++tap) {
      const int kh = tap / 3, kw = tap - 3 * kh;
      const int q = a_row + (2 - kh) * Wp + (2 - kw);
      const uint32_t a = a_base + 4 * (q * kChunk + swz(q, a_kc));
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) ldsm_x4_at(af[i], a + 4 * 16 * kChunk * i);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        uint32_t bh[4];
        ldsm_x4_at(bh, b_base[jj] + ws + 4 * tap * kDgCols * kChunk);
#pragma unroll
        for (int jt = 0; jt < 2; ++jt) {
#pragma unroll
          for (int i = 0; i < 2; ++i)
            mma_bf16(acc[i][2 * jj + jt], af[i], bh[2 * jt], bh[2 * jt + 1]);
        }
      }
    }
  };

  if (c_begin < c_end) issue(c_begin, 0);
  int st = 0;
  for (int ci = c_begin; ci < c_end; ++ci, st ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // chunk ci's tiles landed; every warp is past ci-1
    convert(ci);
    __syncthreads();  // chunk ci's dy plane is written, its stats read
    if (ci + 1 < c_end) issue(ci + 1, st ^ 1);
    products(st);
  }

  OutT* dst = out + static_cast<size_t>(blockIdx.z) * N * C * HW;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int off = place_offset(p0 + wm * 32 + 16 * i + g + 8 * h, H, W,
                                   P, C);
      if (off < 0) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = cb + wn * 32 + 8 * j + 2 * t + e;
          if (c < C)
            store_out(dst + off + static_cast<size_t>(c) * HW,
                      acc[i][j][2 * h + e]);
        }
      }
    }
  }
}

// dw (or an fp32 partial of it) for 32 output x 32 input channels x 9
// taps, over the chunks [blockIdx.z * cps, min(chunks, (blockIdx.z+1) cps))
template <typename OutT>
__global__ void __launch_bounds__(kWgThreads, 2)
conv_bwd_wgrad_bf16_kernel(const float* __restrict__ vec,
                           const bf16* __restrict__ da,
                           const bf16* __restrict__ y,
                           const unsigned short* __restrict__ x,
                           OutT* __restrict__ out, int N, int H, int W, int C,
                           int O, int PR, int PC, int cps) {
  extern __shared__ __align__(16) uint32_t sm[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Wp = W + 1, HW = H * W, M = N * HW, P = N * (H + 1) * Wp;
  const int XH = wgrad_halo(H, W, PR, PC), XS = wgrad_xs_bf16(XH);
  const int HS = PR ? PC + 2 : Wp;  // the x halo's row stride
  const int per_image = PR ? (H / PR) * (W / PC) : 0;
  bf16* dys = reinterpret_cast<bf16*>(sm);  // [32][kWgLdB]
  unsigned short* xs =
      reinterpret_cast<unsigned short*>(dys + kWgRows * kWgLdB);  // [32][XS]
  int* kpix = reinterpret_cast<int*>(xs + kWgCols * XS);  // [64]
  int* koff = kpix + kWgPixels;                            // [64]
  int* xpix = koff + kWgPixels;                            // [XH]
  int* xlen = xpix + XH;                                   // [1]
  float* sstat = reinterpret_cast<float*>(xlen + 1);       // [7][32]
  const int cb = blockIdx.x * kWgCols, ob = blockIdx.y * kWgRows;
  const int total = PR ? N * per_image : cdiv(M, kWgPixels);
  const int kb = blockIdx.z * cps;
  const int chunks = min(total - kb, cps);

  for (int i = tid; i < kStats * kWgRows; i += kWgThreads) {
    const int r = i / kWgRows, o = ob + i % kWgRows;
    sstat[i] = o < O ? vec[static_cast<size_t>(r) * O + o] : 0.f;
  }

  // chunk kb+ci's tables, as the fp32 kernel's (one set)
  auto tables = [&](int ci) {
    int len;
    if (PR == 0) {  // 64 consecutive pixels, past M continuing in zeros
      const int k0 = (kb + ci) * kWgPixels;
      const int xb = place_of(k0, H, W) - Wp - 1;
      len = place_of(k0 + kWgPixels - 1, H, W) + Wp + 2 - xb;
      if (tid < kWgPixels) {
        const int m = k0 + tid;
        kpix[tid] = m < M ? (m / HW) * O * HW + (m - (m / HW) * HW) : -1;
        koff[tid] = place_of(m, H, W) - xb;
      }
      for (int q = tid; q < len; q += kWgThreads)
        xpix[q] = place_offset(xb + q, H, W, P, C);
    } else {  // a PR x PC patch from (r0, c0) of image n
      const int n = (kb + ci) / per_image, rem = kb + ci - n * per_image;
      const int band = rem / (W / PC);
      const int r0 = band * PR, c0 = (rem - band * (W / PC)) * PC;
      len = XH;
      if (tid < kWgPixels) {
        const int kr = tid / PC, kc = tid - kr * PC;
        const bool in = tid < PR * PC;
        kpix[tid] = in ? n * O * HW + (r0 + kr) * W + c0 + kc : -1;
        koff[tid] = in ? (kr + 1) * HS + kc + 1 : (PR + 3) * HS + 1;
      }
      for (int q = tid; q < len; q += kWgThreads) {
        const int hr = q / HS, r = r0 - 1 + hr, c = c0 - 1 + q - hr * HS;
        xpix[q] = hr < PR + 2 && r >= 0 && r < H && c >= 0 && c < W
                      ? n * C * HW + r * W + c
                      : -1;
      }
    }
    if (tid == 0) *xlen = len;
  };

  // dy (threads 0..255: pixel tid % 64, channels tid / 64 + 4i) rounded to
  // bf16, and the x halo, into shared memory
  auto load = [&]() {
    if (tid < 256) {
      const int k = tid & (kWgPixels - 1), off = kpix[k];
#pragma unroll 4
      for (int o = tid >> 6; o < kWgRows; o += 4) {
        const bool ok = off >= 0 && ob + o < O;
        const size_t g = ok ? off + static_cast<size_t>(ob + o) * HW : 0;
        const float a = __bfloat162float(da[g]);
        const float b = __bfloat162float(y[g]);
        float s[kStats];
#pragma unroll
        for (int r = 0; r < kStats; ++r) s[r] = sstat[r * kWgRows + o];
        dys[o * kWgLdB + k] = __float2bfloat16_rn(ok ? recompute_dy(a, b, s)
                                                     : 0.f);
      }
    }
    const int len = *xlen;
    for (int q = tid; q < len; q += kWgThreads) {
      const int off = xpix[q];
#pragma unroll 8
      for (int c = 0; c < kWgCols; ++c) {
        const bool ok = off >= 0 && cb + c < C;
        const unsigned short v =
            x[ok ? off + static_cast<size_t>(cb + c) * HW : 0];
        xs[c * XS + q] = ok ? v : static_cast<unsigned short>(0);
      }
    }
  };

  // warp `tap`: dw[.., .., kh, kw], reading x at the pixel's place + shift
  const int tap = warp, kh = tap / 3, kw = tap - 3 * kh;
  const int shift = (kh - 1) * HS + (kw - 1);
  const int g = lane >> 2, t = lane & 3;
  // bytes: this lane's ldmatrix row of the dy tile
  const uint32_t a_base =
      smem_addr(dys) + 2 * ((lane & 15) * kWgLdB + (lane >> 4) * 8);
  float acc[2][4][4] = {};
  auto products = [&]() {
#pragma unroll
    for (int kk = 0; kk < kWgPixels / 16; ++kk) {
      const int k0 = kk * 16 + 2 * t;
      const int q0 = koff[k0] + shift, q1 = koff[k0 + 1] + shift;
      const int q2 = koff[k0 + 8] + shift, q3 = koff[k0 + 9] + shift;
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4_at(af[i], a_base + 2 * (16 * i * kWgLdB + 16 * kk));
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned short* row = xs + (8 * j + g) * XS;
        const uint32_t b0 = row[q0] | (static_cast<uint32_t>(row[q1]) << 16);
        const uint32_t b1 = row[q2] | (static_cast<uint32_t>(row[q3]) << 16);
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_bf16(acc[i][j], af[i], b0, b1);
      }
    }
  };

  for (int ci = 0; ci < chunks; ++ci) {
    __syncthreads();  // every warp is past chunk ci-1 (and sstat is set)
    tables(ci);
    __syncthreads();
    load();
    __syncthreads();
    products();
  }

  OutT* dst = out + static_cast<size_t>(blockIdx.z) * O * kTaps * C;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = ob + 16 * i + g + 8 * h;
      if (o >= O) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = cb + 8 * j + 2 * t + e;
          if (c < C)
            store_out(dst + (static_cast<size_t>(o) * C + c) * kTaps + tap,
                      acc[i][j][2 * h + e]);
        }
      }
    }
  }
}

template <typename OutT>
cudaError_t launch_dgrad_bf16(const float* vec, const bf16* da, const bf16* y,
                              const bf16* wb, OutT* out, int N, int H, int W,
                              int C, int O, int Opad, int dsplits, int cps,
                              cudaStream_t stream) {
  const size_t smem = dgrad_bf16_smem_bytes(W);
  cudaError_t err = cudaFuncSetAttribute(
      conv_bwd_dgrad_bf16_kernel<OutT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int P = N * (H + 1) * (W + 1);
  conv_bwd_dgrad_bf16_kernel<OutT>
      <<<dim3(cdiv(P, kDgRows), cdiv(C, kDgCols), dsplits), kDgThreads, smem,
         stream>>>(vec, da, y, wb, out, N, H, W, C, O, Opad, cps);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t launch_wgrad_bf16(const float* vec, const bf16* da, const bf16* y,
                              const unsigned short* x, OutT* out, int N,
                              int H, int W, int C, int O, int splits,
                              int cps_w, cudaStream_t stream) {
  int PR, PC;
  wgrad_patch(H, W, PR, PC);
  const size_t smem = wgrad_bf16_smem_bytes(H, W, PR, PC);
  cudaError_t err = cudaFuncSetAttribute(
      conv_bwd_wgrad_bf16_kernel<OutT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  conv_bwd_wgrad_bf16_kernel<OutT>
      <<<dim3(cdiv(C, kWgCols), cdiv(O, kWgRows), splits), kWgThreads, smem,
         stream>>>(vec, da, y, x, out, N, H, W, C, O, PR, PC, cps_w);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory of the dgrad and wgrad kernels at this H x W, in bytes,
// and wgrad's patch (0 x 0: linear chunks of 64 pixels).
void conv3x3_bn_relu_bwd_smem(int H, int W, size_t* dgrad, size_t* wgrad,
                              int* patch_rows, int* patch_cols) {
  *dgrad = dgrad_smem_bytes(W);
  wgrad_patch(H, W, *patch_rows, *patch_cols);
  *wgrad = wgrad_smem_bytes(H, W, *patch_rows, *patch_cols);
}

// vec (8, O); da, y (N, O, H, W); x (N, C, H, W); w (O, C, 3, 3); wsp
// (2, 9, C, Opad) scratch for the split weights (Opad = O rounded up to 8);
// dx (N, C, H, W); dw (O, C, 3, 3); dpart (dsplits, N, C, H, W) when
// dsplits > 1 and wpart (splits, O, 9C) when splits > 1 (else unused). dgrad
// cuts the ceil(O/8) output-channel chunks into runs of `cps`, dsplits of
// them; wgrad cuts the pixels into runs of `rows` (a multiple of 64),
// splits of them. All fp32 (wsp: the TF32 bits), contiguous, on the device
// of `stream`. Returns the first launch error, or 0.
int conv3x3_bn_relu_bwd(const float* vec, const float* da, const float* y,
                        const float* x, const float* w, uint32_t* wsp,
                        float* dx, float* dw, float* dpart, float* wpart,
                        int N, int H, int W, int C, int O, int dsplits,
                        int cps, int splits, int cps_w,
                        cudaStream_t stream) {
  const int Opad = cdiv(O, kChunk) * kChunk;
  conv_bwd_wsplit_kernel<<<dim3(cdiv(kTaps * C, 32), cdiv(Opad, 32)), 256, 0,
                           stream>>>(w, wsp, C, O, Opad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t dsmem = dgrad_smem_bytes(W);
  err = cudaFuncSetAttribute(conv_bwd_dgrad_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dsmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int P = N * (H + 1) * (W + 1);
  conv_bwd_dgrad_kernel<<<dim3(cdiv(P, kDgRows), cdiv(C, kDgCols), dsplits),
                          kDgThreads, dsmem, stream>>>(
      vec, da, y, wsp, dsplits > 1 ? dpart : dx, N, H, W, C, O, Opad, cps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dsplits > 1) {
    err = launch_reduce(dpart, dx, dsplits, static_cast<size_t>(N) * C * H * W,
                 stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }

  int PR, PC;
  wgrad_patch(H, W, PR, PC);
  const size_t wsmem = wgrad_smem_bytes(H, W, PR, PC);
  err = cudaFuncSetAttribute(conv_bwd_wgrad_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(wsmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  conv_bwd_wgrad_kernel<<<dim3(cdiv(C, kWgCols), cdiv(O, kWgRows), splits),
                          kWgThreads, wsmem, stream>>>(
      vec, da, y, x, splits > 1 ? wpart : dw, N, H, W, C, O, PR, PC, cps_w);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(launch_reduce(wpart, dw, splits,
                                 static_cast<size_t>(O) * kTaps * C, stream));
}

// Shared memory of the bf16 dgrad and wgrad kernels at this H x W, in
// bytes.
void conv3x3_bn_relu_bwd_bf16_smem(int H, int W, size_t* dgrad,
                                   size_t* wgrad) {
  int PR, PC;
  wgrad_patch(H, W, PR, PC);
  *dgrad = dgrad_bf16_smem_bytes(W);
  *wgrad = wgrad_bf16_smem_bytes(H, W, PR, PC);
}

// The bf16 instantiation: da, y, x, w, dx and dw bf16 (their bits, as
// 16-bit words), vec (8, O) fp32; wb (9, C, Opad) bf16 scratch for the
// copied weights (Opad = O rounded up to 16); dpart (dsplits, N, C, H, W)
// and wpart (splits, O, 9C) fp32 when split (else unused). dgrad cuts the
// ceil(O/16) output-channel chunks into runs of `cps`, dsplits of them;
// wgrad cuts the pixels as the fp32 entry does. Returns the first launch
// error, or 0.
int conv3x3_bn_relu_bwd_bf16(const float* vec, const void* da, const void* y,
                             const void* x, const void* w, void* wb, void* dx,
                             void* dw, float* dpart, float* wpart, int N,
                             int H, int W, int C, int O, int dsplits, int cps,
                             int splits, int cps_w, cudaStream_t stream) {
  const int Opad = cdiv(O, kBChunk) * kBChunk;
  const auto* da_b = static_cast<const bf16*>(da);
  const auto* y_b = static_cast<const bf16*>(y);
  conv_bwd_wcopy_bf16_kernel<<<dim3(cdiv(kTaps * C, 32), cdiv(Opad, 32)), 256,
                               0, stream>>>(
      static_cast<const unsigned short*>(w), static_cast<unsigned short*>(wb),
      C, O, Opad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* wb_b = static_cast<const bf16*>(wb);
  if (dsplits > 1) {
    err = launch_dgrad_bf16<float>(vec, da_b, y_b, wb_b, dpart, N, H, W, C, O,
                                   Opad, dsplits, cps, stream);
    if (err == cudaSuccess)
      err = launch_reduce(dpart, static_cast<bf16*>(dx), dsplits,
                               static_cast<size_t>(N) * C * H * W, stream);
  } else {
    err = launch_dgrad_bf16<bf16>(vec, da_b, y_b, wb_b, static_cast<bf16*>(dx),
                                  N, H, W, C, O, Opad, 1, cps, stream);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* x_u = static_cast<const unsigned short*>(x);
  if (splits > 1) {
    err = launch_wgrad_bf16<float>(vec, da_b, y_b, x_u, wpart, N, H, W, C, O,
                                   splits, cps_w, stream);
    if (err == cudaSuccess)
      err = launch_reduce(wpart, static_cast<bf16*>(dw), splits,
                               static_cast<size_t>(O) * kTaps * C, stream);
  } else {
    err = launch_wgrad_bf16<bf16>(vec, da_b, y_b, x_u, static_cast<bf16*>(dw),
                                  N, H, W, C, O, 1, cps_w, stream);
  }
  return static_cast<int>(err);
}

const char* conv3x3_bn_relu_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
