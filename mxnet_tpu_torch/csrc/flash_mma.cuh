// Pieces shared by the flash-attention kernels (flash_attention_fwd.cu,
// flash_attention_bwd.cu), which have one design: blocks of 4 warps own 64
// rows, 16 a warp, with one operand pair resident and the other streamed
// through a two-stage ring of 16-byte cp.async copies; every product is a
// tensor-core mma.sync, bf16 m16n8k16 fed by ldmatrix, fp32 m16n8k8 TF32 in
// the 3xTF32 split; and accumulator fragments turn straight into A
// operands, so p (and ds) never leave registers. Here: the block shape and
// the streamed-tile rule, the row copies, the fragments, their loaders and
// products (mma, mma_rn, add_products), the split with its inf/NaN check,
// and the stores; the copies, ldmatrix, the split and the TF32 product
// come from mma_common.cuh. flash_attention_bwd.cu's header says why each
// rounding is where it is.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "mma_common.cuh"

namespace flash_mma {

using mma_common::cp_async16;
using mma_common::cp_async4;
using mma_common::cp_async_commit;
using mma_common::cp_async_wait_all;
using mma_common::ldsm_x4;
using mma_common::ldsm_x4_t;
using mma_common::mma_tf32;
using mma_common::smem_addr;
using mma_common::split;
using mma_common::to_tf32;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // the rows a block owns: 16 a warp
constexpr int kStages = 2;          // depth of the streamed-tile ring

// rows of a streamed tile. fp32 takes 32: its dK/dV and dQ blocks then fit
// three to an SM (registers and shared memory), where 64-row tiles fit two,
// and on the H100 both kernels ran faster so; bf16 keeps 64, except for
// dK/dV at d = 128, whose dK and dV accumulators (128 floats a thread)
// need the room. The forward, which streams K/V past resident Q as dQ
// does, takes dQ's rule (kDkv false): 64 rows in fp32, or 32 or 128 in
// bf16, ran slower there.
template <typename T, int D, bool kDkv>
__host__ __device__ constexpr int stream_rows() {
  return sizeof(T) == sizeof(float) || (kDkv && D == 128) ? 32 : 64;
}

// a shared row of D elements, padded by 16 bytes
template <typename T, int D>
__host__ __device__ constexpr int row_stride() {
  return D + 16 / static_cast<int>(sizeof(T));
}

// rows [row0, row0 + R) of a (seq, D) matrix into R padded shared rows,
// zero past seq
template <typename T, int D, int R>
__device__ __forceinline__ void copy_rows(T* dst, const T* src, int row0,
                                          int seq, int tid) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  constexpr int kPerRow = D / kVec;
  constexpr int SD = row_stride<T, D>();
#pragma unroll
  for (int i = tid; i < R * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * kVec;
    const bool ok = row0 + r < seq;
    cp_async16(dst + r * SD + c,
               src + static_cast<size_t>(ok ? row0 + r : 0) * D + c, ok);
  }
}

// -- tensor-core fragments ----------------------------------------------------
//
// Layouts of mma.sync with g = lane / 4, t = lane % 4: the accumulator of
// an m16n8 tile holds (row g, cols 2t, 2t+1) and (row g+8, cols 2t, 2t+1).
// Loaders, with the tile in shared memory at row stride SD:
//   load_a:     A (16 x kK) = tile[r0.., k0..]             (row-major A)
//   load_b_nt2: B (kK x 16) = tile[n0.., k0..]^T, two n8 tiles (x tile^T)
//   load_b_nn2: B (kK x 16) = tile[k0.., n0..], two n8 tiles   (x tile)
//   a_from_c:   A (16 x kK) from accumulator tiles whose columns are k

template <typename T>
struct Frag;

// bf16: m16n8k16, a register holds two bf16 of consecutive k
template <>
struct Frag<__nv_bfloat16> {
  static constexpr int kK = 16;
  struct A {
    uint32_t x[4];
  };
  struct B {
    uint32_t x[2];
  };
};

// fp32 as 3xTF32: m16n8k8, each operand as its hi and lo TF32 parts
template <>
struct Frag<float> {
  static constexpr int kK = 8;
  struct A {
    uint32_t hi[4], lo[4];
  };
  struct B {
    uint32_t hi[2], lo[2];
  };
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// whether one of the fp32 values that this thread copied into the tile
// with copy_rows<float, D, R> is inf or NaN (x * 0 is NaN only for
// those); its own copies are visible to it once they have landed
template <int D, int R>
__device__ __forceinline__ bool copied_non_finite(const float* tile,
                                                  int tid) {
  constexpr int kPerRow = D / 4;
  constexpr int SD = row_stride<float, D>();
  float acc = 0.f;
#pragma unroll
  for (int i = tid; i < R * kPerRow; i += kThreads) {
    const float4 x = *reinterpret_cast<const float4*>(
        tile + (i / kPerRow) * SD + (i % kPerRow) * 4);
    acc = __fmaf_rn(x.x, 0.f, __fmaf_rn(x.y, 0.f, acc));
    acc = __fmaf_rn(x.z, 0.f, __fmaf_rn(x.w, 0.f, acc));
  }
  return acc != acc;
}

// body(std::bool_constant<checked>): fp32 takes the checked split where
// asked; bf16 has no split
template <typename T, typename Body>
__device__ __forceinline__ void with_split(bool checked, Body&& body) {
  if constexpr (sizeof(T) == sizeof(float)) {
    if (checked) {
      body(std::true_type{});
      return;
    }
  }
  body(std::false_type{});
}

// bf16 loaders: matrix i of an x4 ldmatrix takes its row addresses from
// lanes 8i..8i+7
template <int SD, bool kChecked>
__device__ __forceinline__ void load_a(Frag<__nv_bfloat16>::A& a,
                                       const __nv_bfloat16* tile, int r0,
                                       int k0, int lane) {
  ldsm_x4(a.x, tile + (r0 + (lane & 15)) * SD + k0 + (lane >> 4) * 8);
}

template <int SD, bool kChecked>
__device__ __forceinline__ void load_b_nt2(Frag<__nv_bfloat16>::B (&b)[2],
                                           const __nv_bfloat16* tile, int n0,
                                           int k0, int lane) {
  const int m = lane >> 3;
  uint32_t r[4];
  ldsm_x4(r, tile + (n0 + (lane & 7) + (m >> 1) * 8) * SD + k0 + (m & 1) * 8);
  b[0].x[0] = r[0];
  b[0].x[1] = r[1];
  b[1].x[0] = r[2];
  b[1].x[1] = r[3];
}

template <int SD, bool kChecked>
__device__ __forceinline__ void load_b_nn2(Frag<__nv_bfloat16>::B (&b)[2],
                                           const __nv_bfloat16* tile, int k0,
                                           int n0, int lane) {
  const int m = lane >> 3;
  uint32_t r[4];
  ldsm_x4_t(r,
            tile + (k0 + (lane & 7) + (m & 1) * 8) * SD + n0 + (m >> 1) * 8);
  b[0].x[0] = r[0];
  b[0].x[1] = r[1];
  b[1].x[0] = r[2];
  b[1].x[1] = r[3];
}

// k-step st of the accumulator tiles c: tiles 2st and 2st+1, rounded to
// bf16 (the reference's rounding of p and ds to the input dtype)
template <int NT>
__device__ __forceinline__ void a_from_c(Frag<__nv_bfloat16>::A& a,
                                         const float (&c)[NT][4], int st) {
  a.x[0] = pack_bf16(c[2 * st][0], c[2 * st][1]);
  a.x[1] = pack_bf16(c[2 * st][2], c[2 * st][3]);
  a.x[2] = pack_bf16(c[2 * st + 1][0], c[2 * st + 1][1]);
  a.x[3] = pack_bf16(c[2 * st + 1][2], c[2 * st + 1][3]);
}

__device__ __forceinline__ void mma(float (&c)[4],
                                    const Frag<__nv_bfloat16>::A& a,
                                    const Frag<__nv_bfloat16>::B& b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a.x[0]), "r"(a.x[1]), "r"(a.x[2]), "r"(a.x[3]), "r"(b.x[0]),
        "r"(b.x[1]));
}

// fp32 loaders. The m16n8k8 A fragment holds (row g, k t), (row g+8, k t),
// (row g, k t+4), (row g+8, k t+4); B holds (k t, col g), (k t+4, col g).
template <int SD, bool kChecked>
__device__ __forceinline__ void load_a(Frag<float>::A& a, const float* tile,
                                       int r0, int k0, int lane) {
  const float* p = tile + (r0 + (lane >> 2)) * SD + k0 + (lane & 3);
  split<kChecked>(p[0], a.hi[0], a.lo[0]);
  split<kChecked>(p[8 * SD], a.hi[1], a.lo[1]);
  split<kChecked>(p[4], a.hi[2], a.lo[2]);
  split<kChecked>(p[8 * SD + 4], a.hi[3], a.lo[3]);
}

template <int SD, bool kChecked>
__device__ __forceinline__ void load_b_nt2(Frag<float>::B (&b)[2],
                                           const float* tile, int n0, int k0,
                                           int lane) {
  const float* p = tile + (n0 + (lane >> 2)) * SD + k0 + (lane & 3);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    split<kChecked>(p[8 * j * SD], b[j].hi[0], b[j].lo[0]);
    split<kChecked>(p[8 * j * SD + 4], b[j].hi[1], b[j].lo[1]);
  }
}

// the k index permuted to match a_from_c: "k t" is row k0 + 2t, "k t+4"
// is row k0 + 2t + 1
template <int SD, bool kChecked>
__device__ __forceinline__ void load_b_nn2(Frag<float>::B (&b)[2],
                                           const float* tile, int k0, int n0,
                                           int lane) {
  const float* p = tile + (k0 + 2 * (lane & 3)) * SD + n0 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    split<kChecked>(p[8 * j], b[j].hi[0], b[j].lo[0]);
    split<kChecked>(p[SD + 8 * j], b[j].hi[1], b[j].lo[1]);
  }
}

// k-step st of the accumulator tiles c is tile st; its column 2t takes
// "k t" and column 2t+1 "k t+4" (fp32 p and ds are not rounded). Always
// checked: p and ds may be inf or NaN from finite tiles (lse, delta)
template <int NT>
__device__ __forceinline__ void a_from_c(Frag<float>::A& a,
                                         const float (&c)[NT][4], int st) {
  split<true>(c[st][0], a.hi[0], a.lo[0]);
  split<true>(c[st][2], a.hi[1], a.lo[1]);
  split<true>(c[st][1], a.hi[2], a.lo[2]);
  split<true>(c[st][3], a.hi[3], a.lo[3]);
}

// 3xTF32: c += a.lo b.hi + a.hi b.lo + a.hi b.hi
__device__ __forceinline__ void mma(float (&c)[4], const Frag<float>::A& a,
                                    const Frag<float>::B& b) {
  mma_tf32(c, a.lo, b.hi);
  mma_tf32(c, a.hi, b.lo);
  mma_tf32(c, a.hi, b.hi);
}

// c += a b, the three products summed from zero and added to c with
// round-to-nearest fp32 adds (bf16: one mma into c). The s and dp
// products take this form: in one 24-mma chain per tile, the tensor
// core's accumulation moves p and ds by a few ulp off the plain version,
// enough to flip a near-zero gradient's sign downstream of fp8 rounding
__device__ __forceinline__ void mma_rn(float (&c)[4], const Frag<float>::A& a,
                                       const Frag<float>::B& b) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma(t, a, b);
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += t[i];
}
__device__ __forceinline__ void mma_rn(float (&c)[4],
                                       const Frag<__nv_bfloat16>::A& a,
                                       const Frag<__nv_bfloat16>::B& b) {
  mma(c, a, b);
}

// acc[j0 + j] += A B over the k-steps of one streamed tile, for the NJ
// output tiles from j0: A from the accumulator tiles c (p^T, ds^T or ds),
// B = tile (dO, Q or K). fp32 sums the tile into a zeroed partial first and
// adds that to acc with one fp32 add: the tensor core's accumulation
// (not round-to-nearest) then covers one tile's k-steps, not the whole
// sequence's, which keeps the 3xTF32 products within fp32 parity over
// 1024-key sums. bf16 accumulates in place (the partial is acc itself).
template <typename T, int SD, int NJ, bool kChecked, int NT, int OT>
__device__ __forceinline__ void add_products(float (&acc)[OT][4],
                                             const float (&c)[NT][4],
                                             const T* tile, int j0,
                                             int lane) {
  using F = Frag<T>;
  constexpr bool kPartial = sizeof(T) == sizeof(float);
  float part[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) part[j][e] = kPartial ? 0.f : acc[j0 + j][e];
  }
#pragma unroll
  for (int kst = 0; kst < NT * 8 / F::kK; ++kst) {
    typename F::A a;
    a_from_c(a, c, kst);
#pragma unroll
    for (int j = 0; j < NJ; j += 2) {
      typename F::B b[2];
      load_b_nn2<SD, kChecked>(b, tile, kst * F::kK, 8 * (j0 + j), lane);
      mma(part[j], a, b[0]);
      mma(part[j + 1], a, b[1]);
    }
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[j0 + j][e] = kPartial ? acc[j0 + j][e] + part[j][e] : part[j][e];
  }
}

// output tiles a call of add_products takes: fp32 at d = 128 in two
// halves, so that the partial fits beside the accumulators
template <typename T, int D>
__host__ __device__ constexpr int partial_tiles() {
  return sizeof(T) == sizeof(float) && D == 128 ? D / 16 : D / 8;
}

// two consecutive outputs of a row, in the input dtype
__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

// the warp's accumulator tiles acc[D/8] of rows row0 + g, row0 + g + 8
// (below seq) into the (seq, D) output
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* out, const float (&acc)[D / 8][4],
                                           int row0, int seq, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    if (row >= seq) continue;
    T* dst = out + static_cast<size_t>(row) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store2(dst + 8 * j, acc[j][2 * h], acc[j][2 * h + 1]);
  }
}

}  // namespace flash_mma
