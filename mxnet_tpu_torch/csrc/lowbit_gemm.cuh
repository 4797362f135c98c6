// The persistent TMA-fed wgmma GEMM of the low-bit matmul kernels, with
// their epilogue out = act(float(acc) * (xs * ws[n]) + bias[n]):
//   - fp8_matmul.cu: f16 operands (fp8 values widened, so every product is
//     exact), fp32 sums, wgmma.m64n128k16.f32.f16.f16;
//   - int8_matmul.cu: s8 operands, exact int32 sums,
//     wgmma.m64nNk32.s32.s8.s8 with N = 128 or 192.
// Each kernel file wraps gemm<Op, BN, TMA_STORE> in a __global__ of its own
// name (so the profiler and cuobjdump tell them apart) and launches it
// through launch<>.
//
// The design (written for fp8 first; PERF.md has the measurements):
// persistent, one block an SM walking kBM x BN output tiles in turn,
// columns fastest, so that the blocks running together share x's row
// tiles in L2. One producer thread keeps a ring of stages full with TMA
// loads of the x and w tiles (128 bytes of K a stage: one 128-byte swizzle
// row; both operands K-major, so w (N, K) needs no transpose); two
// consumer warpgroups, 64 rows each, issue wgmma from the swizzled tiles,
// keeping one stage's products in flight while the previous stage is
// released; setmaxnreg gives the consumers 232 registers and the producer
// 40 (ptxas still holds each thread to 168). The epilogue applies the
// reference's arithmetic (xs * ws[n] first, then acc *, then + bias, each
// rounded on its own, then the activation) from the accumulators; it is
// instantiated per activation and bias, so its loop over a thread's values
// carries no branch on them. Each column's scale and bias are loaded into
// registers before the main loop, which hides their latency (ColScales).
// The tile is staged in shared memory in the
// 128-byte swizzle and written with TMA stores where N % 4 == 0 (rows on
// 16 bytes), else stored straight from the registers. No split-K, no
// atomics: a second launch gives the same bits.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "hopper_gemm.cuh"
#include "quant_mma.cuh"

namespace lowbit_gemm {

using namespace hopper;

constexpr int kBM = 128;       // rows of a tile: two consumer warpgroups
constexpr int kKBytes = 128;   // bytes of K a stage: one 128-byte swizzle
constexpr int kThreads = 384;  // producer warpgroup + two consumers
constexpr int kMaxStages = 5;
constexpr int kSmemLimit = 232448;  // dynamic shared memory of a block

// f16 operands, fp32 accumulators
struct F16 {
  using Acc = float;
  static constexpr int kKElems = 64;  // values of K a stage
};

// s8 operands, int32 accumulators (exact)
struct S8 {
  using Acc = int;
  static constexpr int kKElems = 128;
};

template <int BN, bool TMA_STORE>
struct Smem {
  static constexpr int kABytes = kBM * kKBytes;
  static constexpr int kBBytes = BN * kKBytes;
  static constexpr int kCBytes = TMA_STORE ? kBM * BN * 4 : 0;  // staging
  // the column scales and biases of tiles wider than 128 (ColScales)
  static constexpr int kSBytes = BN > 128 ? 2 * 2 * BN * 4 : 0;
  static constexpr int kFit =
      (kSmemLimit - 1024 - kCBytes - kSBytes - 2 * 8 * 8) /
      (kABytes + kBBytes);
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kBytes = 1024 + kStages * (kABytes + kBBytes) +
                                kCBytes + kSBytes + 2 * kStages * 8;
  static_assert(kStages >= 2, "the ring needs two stages");
};

// -- the products ------------------------------------------------------------

#define LBG_F8(i)                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define LBG_R8(i)                                                      \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),          \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])
#define LBG_D64                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "   \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "   \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define LBG_D96                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "   \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "   \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "   \
  "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "   \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "   \
  "%93, %94, %95}"

// d += A (64 rows x 16 of K) . B (128 rows x 16 of K)^T, f16 operands from
// shared-memory descriptors.
__device__ __forceinline__ void mma(F16, float (&d)[64], uint64_t da,
                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 " LBG_D64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : LBG_F8(0), LBG_F8(8), LBG_F8(16), LBG_F8(24), LBG_F8(32),
        LBG_F8(40), LBG_F8(48), LBG_F8(56)
      : "l"(da), "l"(db), "n"(1));
}

// d += A (64 rows x 32 of K) . B (128 rows x 32 of K)^T, s8 operands.
__device__ __forceinline__ void mma(S8, int (&d)[64], uint64_t da,
                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " LBG_D64
      ", %64, %65, p;\n}\n"
      : LBG_R8(0), LBG_R8(8), LBG_R8(16), LBG_R8(24), LBG_R8(32),
        LBG_R8(40), LBG_R8(48), LBG_R8(56)
      : "l"(da), "l"(db), "n"(1));
}

// d += A (64 rows x 32 of K) . B (192 rows x 32 of K)^T, s8 operands.
__device__ __forceinline__ void mma(S8, int (&d)[96], uint64_t da,
                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 " LBG_D96
      ", %96, %97, p;\n}\n"
      : LBG_R8(0), LBG_R8(8), LBG_R8(16), LBG_R8(24), LBG_R8(32),
        LBG_R8(40), LBG_R8(48), LBG_R8(56), LBG_R8(64), LBG_R8(72),
        LBG_R8(80), LBG_R8(88)
      : "l"(da), "l"(db), "n"(1));
}
#undef LBG_F8
#undef LBG_R8
#undef LBG_D64
#undef LBG_D96

__device__ __forceinline__ float to_float(float a) { return a; }
__device__ __forceinline__ float to_float(int a) { return __int2float_rn(a); }

__device__ __forceinline__ void acc_fence(float& r) { reg_fence(r); }
__device__ __forceinline__ void acc_fence(int& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// -- the epilogue --------------------------------------------------------------

// The epilogue's column scales xs * ws[n] and biases. A thread's columns
// are 8j + 2 (lane % 4) + e. A tile of up to 128 columns keeps each
// thread's own values in registers (value 2j + e of BN / 4). A wider one
// keeps them in shared memory, BN scales then BN biases for each consumer
// warpgroup: thread tid loads the pair of columns 2 tid, 2 tid + 1 before
// the main loop and stores it after (publish), and the epilogue reads the
// pairs it needs. ptxas holds a thread to 168 registers at 384 threads a
// block, and 96 int32 accumulators of a 192-column tile beside 96 scale
// registers spilled (beside 12, spread over the lanes and fetched with
// shuffles, they still spilled 24 bytes).
template <int BN>
struct ColScales {
  static constexpr bool kShared = BN > 128;
  static constexpr int kRegs = kShared ? 2 : BN / 4;
  float s[kRegs], b[kRegs];
  float* sm;  // kShared: this warpgroup's 2 x BN floats

  __device__ __forceinline__ void load(const float* __restrict__ ws,
                                       const float* __restrict__ bias,
                                       float xs, int n0, int N, int tid,
                                       int lane) {
#pragma unroll
    for (int t = 0; t < kRegs; ++t) {
      const int gc = kShared ? n0 + 2 * tid + t
                             : n0 + (t >> 1) * 8 + (lane & 3) * 2 + (t & 1);
      s[t] = gc < N ? __fmul_rn(xs, ws[gc]) : 0.f;
      b[t] = bias != nullptr && gc < N ? bias[gc] : 0.f;
    }
  }

  __device__ __forceinline__ void publish(int tid) {
    if constexpr (kShared) {
      if (2 * tid >= BN) return;
      *reinterpret_cast<float2*>(sm + 2 * tid) = make_float2(s[0], s[1]);
      *reinterpret_cast<float2*>(sm + BN + 2 * tid) = make_float2(b[0], b[1]);
    }
  }

  // The scales (and with BIAS the biases) of columns 8j + 2 (lane % 4) and
  // the one after it.
  template <bool BIAS>
  __device__ __forceinline__ void get(int j, int lane, float2& sc,
                                      float2& bc) const {
    if constexpr (kShared) {
      const int col = j * 8 + (lane & 3) * 2;
      sc = *reinterpret_cast<const float2*>(sm + col);
      if (BIAS) bc = *reinterpret_cast<const float2*>(sm + BN + col);
    } else {
      sc = make_float2(s[2 * j], s[2 * j + 1]);
      if (BIAS) bc = make_float2(b[2 * j], b[2 * j + 1]);
    }
  }
};

// Staging index of output (r, c) of a consumer's 64-row half tile: boxes of
// 64 rows x 32 fp32 (128 bytes) in the TMA store's 128-byte swizzle, so
// that a warp's float2 writes fall in distinct banks.
__device__ __forceinline__ int stage_index(int r, int c) {
  return (c >> 5) * (64 * 32) + r * 32 + ((((c & 31) >> 2) ^ (r & 7)) << 2) +
         (c & 3);
}

// The epilogue of a consumer's 64 x BN half tile at (row0, n0):
// act(float(acc) * s[n] + b[n]), each operation rounded on its own, into
// the staging tile (TMA_STORE) or straight to out. Accumulator d[4j + i]
// holds row 16 warp + lane / 4 (+ 8 for i >= 2), column 8j + 2 (lane % 4)
// + (i & 1).
template <bool TMA_STORE, int ACT, bool BIAS, int BN, class Acc>
__device__ __forceinline__ void epilogue(const Acc (&acc)[BN / 2],
                                         const ColScales<BN>& cs,
                                         float* stage, float* out, int M,
                                         int N, int row0, int n0, int warp,
                                         int lane) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = j * 8 + (lane & 3) * 2;
    const int gc = n0 + col;
    float2 sc, bc;
    cs.template get<BIAS>(j, lane, sc, bc);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 16 + (lane >> 2) + h * 8;
      float o0 = __fmul_rn(to_float(acc[4 * j + 2 * h]), sc.x);
      float o1 = __fmul_rn(to_float(acc[4 * j + 2 * h + 1]), sc.y);
      if (BIAS) {
        o0 = __fadd_rn(o0, bc.x);
        o1 = __fadd_rn(o1, bc.y);
      }
      o0 = quant_mma::activate(o0, ACT);
      o1 = quant_mma::activate(o1, ACT);
      if (TMA_STORE) {
        *reinterpret_cast<float2*>(stage + stage_index(r, col)) =
            make_float2(o0, o1);
      } else {
        const int gr = row0 + r;
        if (gr < M) {
          float* p = out + static_cast<size_t>(gr) * N + gc;
          if (gc + 1 < N && (N & 1) == 0) {
            *reinterpret_cast<float2*>(p) = make_float2(o0, o1);
          } else {
            if (gc < N) p[0] = o0;
            if (gc + 1 < N) p[1] = o1;
          }
        }
      }
    }
  }
}

// -- the kernel body -------------------------------------------------------------

// out (M, N) = epilogue(A (M, K) . B (N, K)^T) for the operand maps tm_a,
// tm_b (boxes of kBM / BN rows x Op::kKElems values, 128-byte swizzle) and,
// with TMA_STORE, the output map tm_c (boxes of 64 rows x 32 fp32).
// smem_raw: the block's dynamic shared memory, Smem<BN, TMA_STORE>::kBytes.
template <class Op, int BN, bool TMA_STORE>
__device__ __forceinline__ void gemm(
    uint8_t* smem_raw, const CUtensorMap* tm_a, const CUtensorMap* tm_b,
    const CUtensorMap* tm_c, const float* __restrict__ ws,
    const float* __restrict__ xs_ptr, const float* __restrict__ bias,
    float* __restrict__ out, int M, int N, int k_tiles, int act) {
  using L = Smem<BN, TMA_STORE>;
  using Acc = typename Op::Acc;
  constexpr int kStages = L::kStages;
  uint8_t* const smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* const sa = smem;
  uint8_t* const sb = sa + kStages * L::kABytes;
  float* const sc = reinterpret_cast<float*>(sb + kStages * L::kBBytes);
  float* const scales =
      reinterpret_cast<float*>(reinterpret_cast<uint8_t*>(sc) + L::kCBytes);
  uint64_t* const full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<uint8_t*>(scales) + L::kSBytes);
  uint64_t* const empty = full + kStages;

  const int n_tiles = (N + BN - 1) / BN;
  const int tiles = ((M + kBM - 1) / kBM) * n_tiles;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread keeps the ring of TMA loads full
    reg_dealloc<40>();
    if (threadIdx.x == 0) {
      int s = 0;
      uint32_t ph = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t / n_tiles) * kBM, n0 = (t % n_tiles) * BN;
        for (int k = 0; k < k_tiles; ++k) {
          mbar_wait(&empty[s], ph ^ 1);
          mbar_expect_tx(&full[s], L::kABytes + L::kBBytes);
          tma_load_2d(sa + s * L::kABytes, tm_a, &full[s], k * Op::kKElems,
                      m0);
          tma_load_2d(sb + s * L::kBBytes, tm_b, &full[s], k * Op::kKElems,
                      n0);
          if (++s == kStages) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
  } else {
    reg_alloc<232>();
    const int c = wg - 1;  // rows c*64 .. c*64+63 of the tile
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid >> 5, lane = tid & 31;
    float* const stage = sc + c * 64 * BN;
    const float xs = *xs_ptr;
    int s = 0;
    uint32_t ph = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t / n_tiles) * kBM, n0 = (t % n_tiles) * BN;
      // the epilogue's column scales and biases, loaded now so that the
      // main loop hides their latency
      ColScales<BN> cs;
      cs.sm = scales + c * 2 * BN;
      cs.load(ws, bias, xs, n0, N, tid, lane);
      Acc acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
      int prev = -1;
      for (int k = 0; k < k_tiles; ++k) {
        mbar_wait(&full[s], ph);
        const uint64_t da =
            desc_sw128(sa + s * L::kABytes + c * 64 * kKBytes);
        const uint64_t db = desc_sw128(sb + s * L::kBBytes);
        wgmma_fence();
#pragma unroll
        for (int kb = 0; kb < kKBytes / 32; ++kb)
          mma(Op{}, acc, da + 2 * kb, db + 2 * kb);
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done
        if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = s;
        if (++s == kStages) {
          s = 0;
          ph ^= 1;
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc_fence(acc[i]);
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);

      // epilogue: act(float(acc) * (xs * ws[n]) + bias[n])
      cs.publish(tid);
      if (TMA_STORE && tid == 0) tma_store_wait_read();  // the last stores
      if (TMA_STORE || ColScales<BN>::kShared) named_barrier(1 + c, 128);
#define LBG_EPILOGUE(A)                                                   \
  (bias != nullptr                                                        \
       ? epilogue<TMA_STORE, A, true, BN>(acc, cs, stage, out, M, N,      \
                                          m0 + c * 64, n0, warp, lane)    \
       : epilogue<TMA_STORE, A, false, BN>(acc, cs, stage, out, M, N,     \
                                           m0 + c * 64, n0, warp, lane))
      switch (act) {
        case quant_mma::kRelu:
          LBG_EPILOGUE(quant_mma::kRelu);
          break;
        case quant_mma::kSigmoid:
          LBG_EPILOGUE(quant_mma::kSigmoid);
          break;
        case quant_mma::kTanh:
          LBG_EPILOGUE(quant_mma::kTanh);
          break;
        case quant_mma::kGelu:
          LBG_EPILOGUE(quant_mma::kGelu);
          break;
        default:
          LBG_EPILOGUE(quant_mma::kNone);
      }
#undef LBG_EPILOGUE
      if (TMA_STORE) {
        fence_async_shared();
        named_barrier(1 + c, 128);
        if (tid == 0) {
#pragma unroll
          for (int b = 0; b < BN / 32; ++b)
            tma_store_2d(tm_c, stage + b * 64 * 32, n0 + b * 32,
                         m0 + c * 64);
          tma_store_commit();
        }
      } else if (ColScales<BN>::kShared) {
        named_barrier(1 + c, 128);  // the scales are read: the next tile's
      }                             // publish may overwrite them
    }
    if (TMA_STORE && tid == 0) tma_store_wait();
  }
}

// -- host ------------------------------------------------------------------------

inline int sm_count() {
  static const int n = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v > 0 ? v : 1;
  }();
  return n;
}

// The maps of the two K-major operands (rows of Kp elements of elem_bytes,
// Kp * elem_bytes on 16 bytes) and, where N % 4 == 0, of out (M, N) fp32.
// False where TMA cannot encode them.
template <class Op, int BN>
bool encode_maps(CUtensorMap* ta, CUtensorMap* tb, CUtensorMap* tc,
                 CUtensorMapDataType type, int elem_bytes, const void* a,
                 const void* b, float* out, int M, int N, int Kp) {
  const uint64_t row = static_cast<uint64_t>(Kp) * elem_bytes;
  if (!encode_2d(ta, type, a, M, Kp, row, kBM, Op::kKElems,
                 CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_2d(tb, type, b, N, Kp, row, BN, Op::kKElems,
                 CU_TENSOR_MAP_SWIZZLE_128B))
    return false;
  if (N % 4 != 0) {
    *tc = *tb;  // unused
    return true;
  }
  return encode_2d(tc, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, out, M, N,
                   static_cast<uint64_t>(N) * 4, 64, 32,
                   CU_TENSOR_MAP_SWIZZLE_128B);
}

// One persistent launch of KERN (a __global__ wrapping gemm<Op, BN,
// TMA_STORE>): a block an SM, at most one a tile.
template <int BN, bool TMA_STORE, auto KERN>
cudaError_t launch(const CUtensorMap& ta, const CUtensorMap& tb,
                   const CUtensorMap& tc, const float* ws, const float* xs,
                   const float* bias, float* out, int M, int N, int k_tiles,
                   int act, cudaStream_t s) {
  constexpr int smem = Smem<BN, TMA_STORE>::kBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      KERN, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const int tiles = ((M + kBM - 1) / kBM) * ((N + BN - 1) / BN);
  const int grid = tiles < sm_count() ? tiles : sm_count();
  KERN<<<grid, kThreads, smem, s>>>(ta, tb, tc, ws, xs, bias, out, M, N,
                                    k_tiles, act);
  return cudaGetLastError();
}

}  // namespace lowbit_gemm
