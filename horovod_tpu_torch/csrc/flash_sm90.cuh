// The Hopper (sm_90a) core shared by the attention kernels #9, #10 and #11
// (flash_attn.cu) and #12 (flash_smallseq.cu): TMA loads into 128-byte-
// swizzled shared memory, wgmma products, and the register layouts that
// let a score tile go from its accumulators straight into the next product.
// The conv GEMM (#3, #4 in conv_fused.cu) takes its wgmma, descriptors,
// barriers, register split and tensor maps from here too, with the 2-D
// TMA loads and stores below.
//
// A CTA has Cfg::WGS consumer warpgroups and a producer:
//   * warps 0 .. 4 WGS - 1 are the consumer warpgroups of 64 rows each:
//     q rows in the forwards and in dQ, k rows in dK/dV.  All read every
//     streamed tile, so a tile staged once feeds them all;
//   * the last warp (or warpgroup) is the producer.  One thread issues the
//     TMA loads: the CTA's resident ("own") tiles once (Q; Q and dO; or K
//     and V), then the streamed pairs of BK rows (K and V, or Q and dO,
//     with the rows' lse and delta for dK/dV) into a ring of STAGES slots.
//     Each slot has a full barrier for each tile of the pair (the
//     producer's expect_tx, completed by the TMA's bytes) and an empty
//     barrier (one arrival from each consumer warp when it is done with
//     the slot).
//
// Products:
//   * scores, S = Q K^T (and dP = dO V^T, S^T = K Q^T, dP^T = V dO^T):
//     wgmma m64nBKk16, both operands from shared memory in the canonical
//     K-major 128-byte-swizzled layout (a 64-column bf16 row is exactly 128
//     bytes; D 128 is two such column halves).  The k-steps of 16 columns
//     advance the descriptors' start address by 32 bytes inside the
//     swizzle atom;
//   * accumulations, O += P V (and dQ += dS K, dV += P^T dO, dK += dS^T Q):
//     wgmma m64nDk16 with A from registers (a score tile's accumulator
//     layout is the A-fragment layout, two 8-column groups a k-step) and B
//     a streamed tile through the transposed (MN-major) descriptor form:
//     its rows are the reduction dimension, so no transpose and no fragment
//     shuffling.
//
// Tensor maps are built per call on the host for the [B, L, H, D]
// operands, as 4-D maps (D, H, L, B) with a box of (64, 1, rows, 1): rows
// past L are zero-filled by the TMA, so a ragged edge never reads into the
// next batch.  The row statistics [B, H, Lq] f32 are one 1-D run of
// B H Lq values (a 2-D map would need Lq * 4 bytes to be a multiple of 16).
// A TMA box must start 16-byte aligned, so a tile's statistics are loaded
// from the aligned position at or below its first row, BK + 4 values; the
// box may run into the next head's row or, at the end, be zero-filled, and
// the kernel masks those columns.
// cuTensorMapEncodeTiled is looked up at run time (cudaGetDriverEntryPoint),
// so nothing links against libcuda.
//
// _build.py hashes this header (and flash_common.cuh, whose 16-bit pack and
// quad reductions it uses) into each library that includes it.

#pragma once

#include <cuda.h>
#include <limits.h>
#include <math.h>

#include <type_traits>

#include "flash_common.cuh"

namespace {
namespace sm90 {

constexpr float LOG2E = 1.4426950408889634f;
constexpr uint32_t ROW_BYTES = 128;     // one swizzled 64-column row

// Tile configuration: head dim D, rows of a streamed tile BK, ring slots
// STAGES, consumer warpgroups WGS (64 rows each; the CTA's own rows are
// ROWS), CTAs an SM, resident tiles RES (1: Q; 2: Q and dO, or K and V)
// and STATS (the streamed rows' lse and delta come with them).  At one CTA
// an SM the producer is a whole warpgroup that hands its registers to the
// consumers (setmaxnreg: it keeps 24, they take what is left of the SM's
// 65,536, at most 240); with more CTAs it is a single warp and the launch
// bound shares the registers out.
template <int D_, int BK_, int STAGES_, int WGS_, int CTAS_, int RES_ = 1,
          bool STATS_ = false>
struct Cfg {
  static constexpr int D = D_, BK = BK_, STAGES = STAGES_, WGS = WGS_;
  static constexpr int CTAS = CTAS_, RES = RES_;
  static constexpr bool STATS = STATS_;
  // Two or more consumer warpgroups take turns to issue their products (a
  // token passed round them on named barriers 1 .. WGS), so one's
  // elementwise pass overlaps the others' products.
  static constexpr bool PINGPONG = WGS > 1;
  static constexpr int ROWS = 64 * WGS;
  static constexpr int CONSUMER_WARPS = 4 * WGS;
  static constexpr bool REG_SPLIT = CTAS == 1;
  static constexpr int THREADS =
      REG_SPLIT ? 128 * (WGS + 1) : 32 * (CONSUMER_WARPS + 1);
  static constexpr int PRODUCER_REGS = 24;
  static constexpr int CONSUMER_REGS =
      (65536 - 128 * PRODUCER_REGS) / (128 * WGS) / 8 * 8 > 240
          ? 240
          : (65536 - 128 * PRODUCER_REGS) / (128 * WGS) / 8 * 8;
  static constexpr int HALVES = D / 64;  // 128-byte column halves of a row
  static constexpr int NS = BK / 2;      // score accumulators a thread
  static constexpr int NO = D / 2;       // output accumulators a thread
  static constexpr uint32_t OWN_BYTES = ROWS * D * 2;
  static constexpr uint32_t TILE_BYTES = BK * D * 2;
  // A slot's lse and delta: STATS_BOX values each, STATS_STRIDE bytes
  // apart (a TMA destination is 128-byte aligned).
  static constexpr int STATS_BOX = BK + 4;
  static constexpr uint32_t STATS_STRIDE = (STATS_BOX * 4 + 127) / 128 * 128;
  static constexpr uint32_t STATS_BYTES = STATS ? 2 * STATS_STRIDE : 0;
  static constexpr uint32_t STATS_TX = STATS ? 2 * STATS_BOX * 4 : 0;
  static constexpr uint32_t SMEM = 1024 + RES * OWN_BYTES +
                                   2 * STAGES * TILE_BYTES +
                                   STAGES * STATS_BYTES;
  static constexpr int BARS = 1 + 3 * STAGES;
};

// ---- wgmma -----------------------------------------------------------------

// Wgmma<T, N>::ss(d, da, db, scale_d): d (+)= A B for a 64 x N x 16 step,
// A and B from shared memory (K-major).  ::rs(d, a, db, scale_d): the same
// with A from registers and B MN-major (transposed descriptor).
template <typename T, int N>
struct Wgmma;

template <>
struct Wgmma<bf16, 64> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  static __device__ __forceinline__ void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  }
};

template <>
struct Wgmma<bf16, 128> {
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  static __device__ __forceinline__ void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  }
};

template <>
struct Wgmma<__half, 64> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  static __device__ __forceinline__ void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  }
};

template <>
struct Wgmma<__half, 128> {
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  static __device__ __forceinline__ void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  }
};

// m64n32k16, the score products of 32-row streamed tiles (dK/dV at D 128).
template <>
struct Wgmma<bf16, 32> {
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<__half, 32> {
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accesses of accumulator registers across
// the asynchronous products that own them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle.  K-major operands
// ignore the leading offset; their 8-row groups are 1024 bytes apart.  An
// MN-major operand steps between its 64-column halves by `lbo` and
// between its 8-row groups by 1024 bytes.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// The register split of a one-CTA-an-SM configuration: each side calls
// its own once, right after the roles part (the paths never rejoin).
template <class C>
__device__ __forceinline__ void producer_regs() {
  if constexpr (C::REG_SPLIT)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        C::PRODUCER_REGS));
}
template <class C>
__device__ __forceinline__ void consumer_regs() {
  if constexpr (C::REG_SPLIT)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        C::CONSUMER_REGS));
}

// ---- barriers and TMA ------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void bar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_load_1d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2}], [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(bar)
      : "memory");
}
// 2-D boxes of a row-major matrix (the GEMM of conv_fused.cu): a load that
// completes on `bar`, and a store from shared memory that joins the issuing
// thread's bulk group (bulk_commit; bulk_wait_read<N> returns once all but
// the newest N groups have read their shared memory, bulk_wait<N> once
// they have written).  Coordinates are (column, row).
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], "
      "[%3];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(src)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}
// Makes this thread's shared-memory writes visible to a later TMA store.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// An f32 of shared memory (read after the barrier that filled it).
__device__ __forceinline__ float lds(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- the ring --------------------------------------------------------------

// Shared-memory addresses of one CTA: the resident tiles, the slots of the
// streamed pairs (each tile a run of 128-byte rows per column half,
// 1024-byte aligned for the swizzle), the slots' row statistics (lse then
// delta, C::STATS_BOX f32 each), and the barriers.
template <class C>
struct Ring {
  uint32_t base, bars;
  __device__ Ring(unsigned char* raw, uint64_t* bar_array)
      : base((smem_addr(raw) + 1023u) & ~1023u), bars(smem_addr(bar_array)) {}
  __device__ uint32_t own(int i) const { return base + i * C::OWN_BYTES; }
  __device__ uint32_t first(int s) const {
    return base + C::RES * C::OWN_BYTES + s * C::TILE_BYTES;
  }
  __device__ uint32_t second(int s) const {
    return base + C::RES * C::OWN_BYTES + (C::STAGES + s) * C::TILE_BYTES;
  }
  __device__ uint32_t stats(int s) const {
    return base + C::RES * C::OWN_BYTES + 2 * C::STAGES * C::TILE_BYTES +
           s * C::STATS_BYTES;
  }
  __device__ uint32_t full_own() const { return bars; }
  __device__ uint32_t full_first(int s) const { return bars + 8 * (1 + s); }
  __device__ uint32_t full_second(int s) const {
    return bars + 8 * (1 + C::STAGES + s);
  }
  __device__ uint32_t empty(int s) const {
    return bars + 8 * (1 + 2 * C::STAGES + s);
  }
  // Thread 0 sets up the barriers; every thread of the CTA calls this.
  __device__ void init() const {
    if (threadIdx.x == 0) {
      bar_init(full_own(), 1);
      for (int s = 0; s < C::STAGES; ++s) {
        bar_init(full_first(s), 1);
        bar_init(full_second(s), 1);
        bar_init(empty(s), C::CONSUMER_WARPS);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
};

// A ring step's slot and the parity its barriers wait on.
template <class C>
__device__ __forceinline__ int slot_of(int it) {
  return it % C::STAGES;
}
template <class C>
__device__ __forceinline__ uint32_t parity_of(int it) {
  return (it / C::STAGES) & 1;
}

// A kernel's parameters: the tensor maps of its resident tiles, of its
// streamed tiles and of the row statistics (lse, delta), and the caller's
// arguments.  Maps a kernel does not use stay zero.
template <class A>
struct Params {
  CUtensorMap own[2], tile[2], stats[2];
  A a;
};

// The producer thread: rows [own_row, own_row + C::ROWS) of head
// `own_head` of each resident tile, then `steps` streamed steps.  Step
// `it` loads streamed tile tile0 + it of head `head` (or tile0 + it - wrap
// past `wrap`, in a two-pass walk); its second tile, and the row
// statistics from 1-D position stats0 + the tile's first row (rounded
// down to 16 bytes: `stats_of`), only where `second_from <= it`; otherwise
// it arrives on the second barrier without bytes, so the slot's phases
// stay in step for the consumers.
template <class C, class A>
__device__ void produce(const Ring<C>& r, const Params<A>& p, int own_head,
                        int own_row, int head, int b, int tile0, int wrap,
                        int steps, int second_from, int stats0) {
  bar_expect(r.full_own(), C::RES * C::OWN_BYTES);
#pragma unroll
  for (int i = 0; i < C::RES; ++i)
#pragma unroll
    for (int hf = 0; hf < C::HALVES; ++hf)
      tma_load(r.own(i) + hf * C::ROWS * ROW_BYTES, &p.own[i], r.full_own(),
               64 * hf, own_head, own_row, b);
  for (int it = 0; it < steps; ++it) {
    const int s = slot_of<C>(it);
    bar_wait(r.empty(s), parity_of<C>(it) ^ 1);  // a fresh slot passes
    const int row = (tile0 + (it < wrap ? it : it - wrap)) * C::BK;
    bar_expect(r.full_first(s), C::TILE_BYTES);
#pragma unroll
    for (int hf = 0; hf < C::HALVES; ++hf)
      tma_load(r.first(s) + hf * C::BK * ROW_BYTES, &p.tile[0],
               r.full_first(s), 64 * hf, head, row, b);
    if (it >= second_from) {
      bar_expect(r.full_second(s), C::TILE_BYTES + C::STATS_TX);
#pragma unroll
      for (int hf = 0; hf < C::HALVES; ++hf)
        tma_load(r.second(s) + hf * C::BK * ROW_BYTES, &p.tile[1],
                 r.full_second(s), 64 * hf, head, row, b);
      if constexpr (C::STATS) {
        const int at = (stats0 + row) & ~3;
        tma_load_1d(r.stats(s), &p.stats[0], r.full_second(s), at);
        tma_load_1d(r.stats(s) + C::STATS_STRIDE, &p.stats[1],
                    r.full_second(s), at);
      }
    } else {
      bar_arrive(r.full_second(s));
    }
  }
}

// The shared-memory address of the lse of the first row of the streamed
// tile in slot s, at 1-D position `at` (its delta is C::STATS_STRIDE bytes
// further): the box starts at `at` rounded down to 16 bytes.
template <class C>
__device__ __forceinline__ uint32_t stats_of(const Ring<C>& r, int s, int at) {
  return r.stats(s) + 4 * (at & 3);
}

// The consumer warps' release of slot s: one arrival a warp, after the
// warp's products that read the slot have completed.
template <class C>
__device__ __forceinline__ void release(const Ring<C>& r, int s) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) bar_arrive(r.empty(s));
}

// The turn-taking of ping-pong: wait for warpgroup wg's turn; pass the
// turn on to the next warpgroup.  Warpgroup WGS - 1 hands the first turn
// to warpgroup 0 (start_turns); every warpgroup then takes the same
// number of turns, so the ring of barriers never waits for a missing one.
template <class C>
__device__ __forceinline__ void start_turns(int wg) {
  if constexpr (C::PINGPONG)
    if (wg == C::WGS - 1)
      asm volatile("bar.arrive %0, %1;\n" ::"r"(1), "r"(256) : "memory");
}
template <class C>
__device__ __forceinline__ void take_turn(int wg) {
  if constexpr (C::PINGPONG)
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "r"(256) : "memory");
}
template <class C>
__device__ __forceinline__ void pass_turn(int wg) {
  if constexpr (C::PINGPONG)
    asm volatile("bar.arrive %0, %1;\n" ::"r"(1 + (wg + 1) % C::WGS),
                 "r"(256)
                 : "memory");
}

// Issues acc = A B^T for warpgroup wg's 64 rows of the resident tile at
// `own` against the streamed tile at `tile`, both K-major over D; not
// committed.
template <typename T, class C>
__device__ __forceinline__ void ss_products(float (&acc)[C::NS], uint32_t own,
                                            uint32_t tile, int wg) {
#pragma unroll
  for (int kk = 0; kk < C::D / 16; ++kk) {
    const uint32_t col = (kk & 3) * 32;
    const uint64_t da = desc(own + (kk >> 2) * C::ROWS * ROW_BYTES +
                             wg * 64 * ROW_BYTES + col, 16);
    const uint64_t db = desc(tile + (kk >> 2) * C::BK * ROW_BYTES + col, 16);
    Wgmma<T, C::BK>::ss(acc, da, db, kk > 0);
  }
}

// Issues acc += A B, A in registers (the A fragments of a score tile) and
// B the streamed tile at `tile`, whose rows are the reduction dimension;
// not committed.
template <typename T, class C>
__device__ __forceinline__ void rs_products(float (&acc)[C::NO],
                                            const uint32_t (&a)[C::BK / 16][4],
                                            uint32_t tile) {
#pragma unroll
  for (int kk = 0; kk < C::BK / 16; ++kk)
    Wgmma<T, C::D>::rs(acc, a[kk],
                       desc(tile + kk * 16 * ROW_BYTES, C::BK * ROW_BYTES), 1);
}

// Issues S = Q K^T for warpgroup wg's 64 rows against slot `slot`, as
// one committed group (the caller waits).
template <typename T, class C>
__device__ __forceinline__ void qk_issue(float (&s)[C::NS], const Ring<C>& r,
                                         int slot, int wg) {
  ss_products<T, C>(s, r.own(0), r.first(slot), wg);
  wgmma_commit();
}

// Issues O += P V against slot `slot`, P already in A fragments, as one
// committed group.
template <typename T, class C>
__device__ __forceinline__ void pv_issue(float (&o)[C::NO],
                                         const uint32_t (&a)[C::BK / 16][4],
                                         const Ring<C>& r, int slot) {
  rs_products<T, C>(o, a, r.second(slot));
  wgmma_commit();
}

// A score tile (P or dS, after the elementwise pass) rounded to the
// accumulation's type, in its A fragments: two 8-column groups a k-step.
template <typename T, int NS>
__device__ __forceinline__ void to_a(uint32_t (&a)[NS / 8][4],
                                     const float (&p)[NS]) {
#pragma unroll
  for (int kk = 0; kk < NS / 8; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[kk][i] = Mma<T>::pack(p[8 * kk + 2 * i], p[8 * kk + 2 * i + 1]);
}

// The products of warpgroup wg over n K/V tiles, ring steps step0 ..
// step0 + n - 1 (tiles kb0 ..): per tile S = Q K^T, then `soft(s, kb,
// corr)` turns S into P in place and gives each row's rescale of O (kept
// at 1 when RESCALE is false), and O = O * corr + P V.  Software-
// pipelined inside the warpgroup: tile j + 1's Q K^T is issued, and tile
// j's P V beside it, before tile j + 1's softmax, which then runs on the
// FP and MUFU units while the tensor cores work.  Each slot is released
// once its P V has completed.
template <typename T, class C, bool RESCALE, class Soft>
__device__ __forceinline__ void attend(float (&o)[C::NO], const Ring<C>& r,
                                       int wg, int step0, int kb0, int n,
                                       Soft&& soft) {
  if (n <= 0) {  // no products, but the turn it would have taken
    take_turn<C>(wg);
    pass_turn<C>(wg);
    return;
  }
  float s[C::NS];
  uint32_t a[C::BK / 16][4];
  float corr[2];
  bar_wait(r.full_first(slot_of<C>(step0)), parity_of<C>(step0));
  take_turn<C>(wg);
  wgmma_fence();
  qk_issue<T, C>(s, r, slot_of<C>(step0), wg);
  pass_turn<C>(wg);
  wgmma_wait<0>();
  fence_regs(s);
  soft(s, kb0, corr);
  to_a<T>(a, s);
  if (RESCALE) {
#pragma unroll
    for (int i = 0; i < C::NO; ++i) o[i] *= corr[(i >> 1) & 1];
  }
  for (int j = 1; j < n; ++j) {
    const int it = step0 + j, prev = it - 1;
    bar_wait(r.full_first(slot_of<C>(it)), parity_of<C>(it));
    bar_wait(r.full_second(slot_of<C>(prev)), parity_of<C>(prev));
    fence_regs(o);
    take_turn<C>(wg);
    wgmma_fence();
    qk_issue<T, C>(s, r, slot_of<C>(it), wg);
    pv_issue<T, C>(o, a, r, slot_of<C>(prev));
    pass_turn<C>(wg);
    wgmma_wait<1>();  // S is in; P V may still run
    fence_regs(s);
    soft(s, kb0 + j, corr);
    wgmma_wait<0>();
    fence_regs(o);
    release(r, slot_of<C>(prev));
    if (RESCALE) {
#pragma unroll
      for (int i = 0; i < C::NO; ++i) o[i] *= corr[(i >> 1) & 1];
    }
    to_a<T>(a, s);
  }
  const int last = step0 + n - 1;
  bar_wait(r.full_second(slot_of<C>(last)), parity_of<C>(last));
  fence_regs(o);
  take_turn<C>(wg);
  wgmma_fence();
  pv_issue<T, C>(o, a, r, slot_of<C>(last));
  pass_turn<C>(wg);
  wgmma_wait<0>();
  fence_regs(o);
  release(r, slot_of<C>(last));
}

// The backward's products of warpgroup wg over n streamed tiles, ring
// steps step0 .. step0 + n - 1.  Per tile the two score products x =
// own(0) first^T and y = own(1) second^T (S and dP in dQ, S^T and dP^T in
// dK/dV), then `grad(x, y, j, slot)` turns them in place into the A
// operands of the accumulations, acc[0] += x first and, when ACCS is 2,
// acc[1] += y second (dQ += dS K; dK += dS^T Q and dV += P^T dO).
// Pipelined as `attend` is: tile j + 1's scores are issued beside tile
// j's accumulations, before tile j + 1's elementwise pass.  Takes n + 1
// ping-pong turns (1 when n is 0), as `attend` does.
template <typename T, class C, int ACCS, class Grad>
__device__ __forceinline__ void backward(float (&acc)[ACCS][C::NO],
                                         const Ring<C>& r, int wg, int step0,
                                         int n, Grad&& grad) {
  if (n <= 0) {
    take_turn<C>(wg);
    pass_turn<C>(wg);
    return;
  }
  float x[C::NS], y[C::NS];
  uint32_t ax[C::BK / 16][4], ay[C::BK / 16][4];
  auto arrive = [&](int it) {
    bar_wait(r.full_first(slot_of<C>(it)), parity_of<C>(it));
    bar_wait(r.full_second(slot_of<C>(it)), parity_of<C>(it));
  };
  auto scores = [&](int slot) {
    ss_products<T, C>(x, r.own(0), r.first(slot), wg);
    ss_products<T, C>(y, r.own(1), r.second(slot), wg);
    wgmma_commit();
  };
  auto accumulate = [&](int slot) {
    rs_products<T, C>(acc[0], ax, r.first(slot));
    if constexpr (ACCS == 2) rs_products<T, C>(acc[1], ay, r.second(slot));
    wgmma_commit();
  };
  auto fence_acc = [&]() {
#pragma unroll
    for (int i = 0; i < ACCS; ++i) fence_regs(acc[i]);
  };
  auto operands = [&](int j, int slot) {
    fence_regs(x);
    fence_regs(y);
    grad(x, y, j, slot);
  };
  auto frags = [&]() {
    to_a<T>(ax, x);
    if constexpr (ACCS == 2) to_a<T>(ay, y);
  };
  arrive(step0);
  take_turn<C>(wg);
  wgmma_fence();
  scores(slot_of<C>(step0));
  pass_turn<C>(wg);
  wgmma_wait<0>();
  operands(0, slot_of<C>(step0));
  frags();
  for (int j = 1; j < n; ++j) {
    const int it = step0 + j, prev = it - 1;
    arrive(it);
    fence_acc();
    take_turn<C>(wg);
    wgmma_fence();
    scores(slot_of<C>(it));
    accumulate(slot_of<C>(prev));
    pass_turn<C>(wg);
    wgmma_wait<1>();  // the scores are in; the accumulations may still run
    operands(j, slot_of<C>(it));
    wgmma_wait<0>();
    fence_acc();
    release(r, slot_of<C>(prev));
    frags();
  }
  const int last = step0 + n - 1;
  fence_acc();
  take_turn<C>(wg);
  wgmma_fence();
  accumulate(slot_of<C>(last));
  pass_turn<C>(wg);
  wgmma_wait<0>();
  fence_acc();
  release(r, slot_of<C>(last));
}

// The ring steps [from, to) of tiles a warpgroup does not need: wait
// for them (so the slots' phases stay in step) and release them.  Each
// stands in for one step of `attend` or `backward` (one turn) when
// `with_second`; without, for a step that loads only the first tile.
template <class C>
__device__ __forceinline__ void skip(const Ring<C>& r, int wg, int from,
                                     int to, bool with_second) {
  for (int it = from; it < to; ++it) {
    bar_wait(r.full_first(slot_of<C>(it)), parity_of<C>(it));
    if (with_second)
      bar_wait(r.full_second(slot_of<C>(it)), parity_of<C>(it));
    release(r, slot_of<C>(it));
    if (with_second) {
      take_turn<C>(wg);
      pass_turn<C>(wg);
    }
  }
}

// Score (row, column) of accumulator i of a thread: rows g and g + 8 of its
// warp's 16, columns 8 (i / 4) + 2 t + (i & 1).
__device__ __forceinline__ int acc_col(int i, int t) {
  return 8 * (i >> 2) + 2 * t + (i & 1);
}

// Sets to -inf the scores a row may not see: columns at or past lk, and
// under `causal` columns past the row's position (qpos(row) = row + shift
// against kpos(col) = col).
template <int NS>
__device__ __forceinline__ void mask(float (&s)[NS], const int (&row)[2],
                                     int k0, int lk, bool causal, int shift,
                                     int t) {
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int col = k0 + acc_col(i, t);
    if (col >= lk || (causal && row[(i >> 1) & 1] + shift < col))
      s[i] = -INFINITY;
  }
}

// The same for a transposed tile (S^T: rows are keys, columns queries
// q0 ..): columns at or past lq, and under `causal` queries that do not
// see the row's key (q + shift < key).
template <int NS>
__device__ __forceinline__ void mask_t(float (&s)[NS], const int (&key)[2],
                                       int q0, int lq, bool causal, int shift,
                                       int t) {
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int q = q0 + acc_col(i, t);
    if (q >= lq || (causal && q + shift < key[(i >> 1) & 1]))
      s[i] = -INFINITY;
  }
}

// Each row's max over a tile of scores, agreed by the quad that holds it.
template <int NS>
__device__ __forceinline__ void row_max(const float (&s)[NS], float (&mx)[2]) {
#pragma unroll
  for (int i = 0; i < NS; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  mx[0] = quad_max(mx[0]);
  mx[1] = quad_max(mx[1]);
}

// Number of K tiles of C::BK rows that q rows [r0, r0 + rows) can see, of
// Lq q rows and Lk keys; under `causal` q row i sees key j when
// i + shift >= j.
template <class C>
__device__ __forceinline__ int visible_tiles(int r0, int rows, int Lq, int Lk,
                                             bool causal, int shift) {
  if (r0 >= Lq) return 0;
  int nk = (Lk + C::BK - 1) / C::BK;
  if (causal) {
    const int lim = shift + min(r0 + rows, Lq) - 1;
    nk = lim < 0 ? 0 : min(nk, lim / C::BK + 1);
  }
  return nk;
}

// The first Q tile of C::BK rows whose last row sees key k0: under
// `causal` q row i sees key j when i + shift >= j.
template <class C>
__device__ __forceinline__ int first_q_tile(int k0, bool causal, int shift) {
  if (!causal) return 0;
  const int need = k0 - shift - (C::BK - 1);
  return need <= 0 ? 0 : (need + C::BK - 1) / C::BK;
}

// ---- the host side ---------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult got;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &got);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &got);
#endif
    if (err != cudaSuccess || got != cudaDriverEntryPointSuccess) return nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The tensor map of a [B, L, heads, D] operand read as boxes of 64 columns
// of one head, `rows` sequence rows and one batch.
inline bool make_map(CUtensorMap* map, const void* ptr, int fp16, int D,
                     int heads, int L, int B, int rows) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)L,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)L * heads * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return fn(map,
            fp16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            4, const_cast<void*>(ptr), dims, strides, box, step,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The tensor map of a [rows, cols] row-major 16-bit matrix, read or written
// as boxes of 64 columns (128 bytes, the swizzle atom) and `box_rows` rows;
// the TMA zero-fills a load past either edge and clips a store there.
inline bool make_map_2d(CUtensorMap* map, const void* ptr, int fp16, int rows,
                        int cols, int box_rows) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  return fn(map,
            fp16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            2, const_cast<void*>(ptr), dims, strides, box, step,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The tensor map of n f32 values read as one 1-D run, boxes of `rows`.
inline bool make_row_map(CUtensorMap* map, const float* ptr, long long n,
                         int rows) {
  EncodeTiled fn = encoder();
  if (fn == nullptr || n <= 0 || n > INT_MAX) return false;
  const cuuint64_t dims[1] = {(cuuint64_t)n};
  const cuuint64_t strides[1] = {0};  // rank 1: none is read
  const cuuint32_t box[1] = {(cuuint32_t)rows};
  const cuuint32_t step[1] = {1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<float*>(ptr),
            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One [B, L, heads, D] operand of a launch (ptr null: none), and the row
// statistics lse and delta [B, H, Lq] (n = B H Lq values; null: none).
struct Operand {
  const void* ptr;
  int heads, L;
};
struct Stats {
  const float* lse;
  const float* delta;
  long long n;
};

// Launches a kernel of configuration C on T operands: one CTA per (C::ROWS
// rows of own0, head of H, batch), with the tensor maps built here (a
// streamed operand of no rows, whose tiles are never loaded, gets none).
// Fails if a map cannot be built.
template <typename T, class C, class A, typename Kernel>
cudaError_t launch(Kernel kernel, const A& a, int B, int H, Operand own0,
                   Operand own1, Operand tile0, Operand tile1, Stats stats,
                   cudaStream_t stream) {
  const dim3 grid((own0.L + C::ROWS - 1) / C::ROWS, H, B);
  if (grid.x == 0 || grid.z == 0) return cudaSuccess;
  const int fp16 = std::is_same<T, __half>::value;
  Params<A> p = {};
  p.a = a;
  const Operand own[2] = {own0, own1}, tile[2] = {tile0, tile1};
  bool ok = true;
  for (int i = 0; i < 2; ++i) {
    if (own[i].ptr != nullptr)
      ok = ok && make_map(&p.own[i], own[i].ptr, fp16, C::D, own[i].heads,
                          own[i].L, B, C::ROWS);
    if (tile[i].ptr != nullptr && tile[i].L > 0)
      ok = ok && make_map(&p.tile[i], tile[i].ptr, fp16, C::D, tile[i].heads,
                          tile[i].L, B, C::BK);
  }
  if (stats.lse != nullptr && stats.n > 0)
    ok = ok && make_row_map(&p.stats[0], stats.lse, stats.n, C::STATS_BOX) &&
         make_row_map(&p.stats[1], stats.delta, stats.n, C::STATS_BOX);
  if (!ok) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace sm90
}  // namespace
