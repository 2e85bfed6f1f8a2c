// Fused 1x1-conv matmul kernels for Hopper (sm_90a), plain C interface.
//
// Replaces the two Pallas TPU kernels of horovod_tpu/ops/conv_fused.py:
//   * _mm_kernel       (via _mm_forward)       -> hvdt_mm_bn_relu
//       y = relu((a @ w) * scale + bias), f32 accumulation, one 16-bit write;
//   * _mm_stats_kernel (matmul_batch_stats)    -> hvdt_mm_stats
//       z = a @ w written once, plus per-BM-row partial sums of z and z^2
//       taken from the f32 accumulator: s1/s2 [ceil(M/BM), N].
//
// Operands: a [M, K] row-major; the weight is passed TRANSPOSED, as wt
// [N, K] row-major (the OIHW layout of a 1x1 conv weight): both K-major,
// the form in which wgmma reads A and B from shared memory.  bf16 or fp16,
// both of one type; the output in the same type.
//
// What bounds them on this card.  ResNet-50's 26 fused 1x1 convs at batch
// 64 have M = 3136 .. 200704 and K, N = 128 .. 2048.  Most sit at or below
// the card's ~295 FLOP/byte line: the largest (M 200704, K 256, N 128)
// needs 46 us for its compulsory bytes against 13 us of bf16 tensor work;
// the stage-4 convs (M 3136, K or N 2048) are about even (5.4 us of bytes,
// 6.6 us of tensor work).  So the design moves each byte once and keeps the
// tensor cores fed while the bytes move:
//   * one pass reads a and wt and writes the output once; the BN affine
//     (#3) or the batch statistics (#4) come from the f32 accumulators in
//     registers, never from a second pass over z nor from an f32 tile in
//     shared memory;
//   * loads are 2-D TMA boxes of 64 K-columns (128 bytes, the swizzle atom)
//     into a ring of STAGES slots, each an A tile of BM x 64 and a W tile
//     of BN x 64, filled by one producer thread and released by the
//     consumer warps; the TMA zero-fills rows past M, columns past N and K
//     past its end, so a ragged edge needs no predicate and adds exactly 0
//     to s1/s2;
//   * products are wgmma m64nBNk16 from 128-byte-swizzled shared memory,
//     both operands K-major (flash_sm90.cuh), two 64-row halves a tile;
//   * the kernel is persistent: one CTA an SM walks the tiles, N fastest
//     within a BM-row panel (the panel stays in L2 while its N tiles pass;
//     W is at most 2 MB), and the producer runs ahead into the next tile's
//     slots, so the ring carries the loads across tiles (at K 128-256 a
//     tile has only 2-4 slots);
//   * the two consumer warpgroups own alternate tiles and take turns to
//     issue their products (ping-pong, on flash_sm90.cuh's turns), so one's
//     epilogue runs under the other's products (with both on one tile
//     the tensor cores idled through every epilogue: slower at every
//     shape);
//   * the epilogue packs each thread's accumulators (after the affine and
//     relu for #3) straight into a 128-byte-swizzled staging tile, which
//     one TMA store writes out (clipping rows past M and columns past N)
//     while the next tile's products run;
//   * #4's column sums: each thread adds its four rows of each column, the
//     8 lanes that hold a column reduce-scatter their sums in 3 shuffle
//     steps, and the 4 warps' partials are added through shared memory in
//     warp order: a fixed association, no atomics, so s1/s2 are
//     bit-identical from run to run.
// Tiles: BM 128 (the s1/s2 row height), BN 128, 4 ring slots, at every
// shape.  Timed on the card (PERF.md): 64-wide tiles were slower even where
// 128-wide ones leave SMs idle (M 3136, N 512: 100 tiles for 132 SMs),
// since each W byte then feeds half the products; 4 slots tied 5; clusters
// of two CTAs sharing their W tile by TMA multicast were slower at every
// shape.
//
// Requirements checked by the Python wrapper: K % 8 == 0, N % 8 == 0, K > 0
// (TMA row strides are multiples of 16 bytes), 16-byte-aligned contiguous
// operands.  Each entry returns cudaGetLastError() after its launch, or an
// error if a tensor map cannot be built.

#include "flash_sm90.cuh"

namespace {

constexpr int BM = 128;  // tile rows, and the row count of an s1/s2 partial
constexpr int BK = 64;   // K columns a ring slot: one swizzle atom

// The tiles and roles.  One CTA an SM: warpgroups 0 and 1 consume, each
// owning whole BM x BN output tiles (the CTA's even and odd ones) and
// taking turns to issue their products (ping-pong), so one's epilogue runs
// while the other's products do; warpgroup 2 is the producer and hands its
// registers to them (setmaxnreg).
struct Tiles {
  static constexpr int BN = 128, STAGES = 4;
  static constexpr int WGS = 2;
  static constexpr bool PINGPONG = true;
  static constexpr bool REG_SPLIT = true;
  static constexpr int THREADS = 384;
  static constexpr int PRODUCER_REGS = 40;
  static constexpr int CONSUMER_REGS = 232;
  static constexpr int NA = BN / 2;  // accumulators a thread, per 64 rows
  static constexpr int NQ = BN / 4;  // columns a thread holds
  static constexpr uint32_t A_BYTES = BM * BK * 2;
  static constexpr uint32_t SLOT = A_BYTES + BN * BK * 2;
  static constexpr uint32_t OUT = BM * BN * 2;  // a warpgroup's staged tile
  // One tile's warp partials of s1 and s2, [warp][2][BN] f32.
  static constexpr uint32_t RED = 4 * 2 * BN * 4;
  static constexpr uint32_t smem(bool stats) {
    return 1024 + STAGES * SLOT + WGS * OUT + (stats ? WGS * 2 * RED : 0);
  }
};
using C = Tiles;  // the name flash_sm90.cuh's helpers give a configuration

struct GemmArgs {
  const float* scale;  // #3: [N] f32
  const float* bias;
  float* s1;           // #4: [ceil(M/BM), N] f32
  float* s2;
  int M, N, K, relu;
};

struct GemmParams {
  CUtensorMap a, w, out;
  GemmArgs g;
};

__device__ __forceinline__ void sts32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
// The 128 threads of warpgroup wg meet (named barriers 1 and 2 are the
// turns').
__device__ __forceinline__ void sync_wg(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(3 + wg) : "memory");
}
// One arrival a warp on a slot's empty barrier, after the warp's products
// that read the slot have completed.
__device__ __forceinline__ void release(uint32_t bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) sm90::bar_arrive(bar);
}

// One step of a reduce-scatter across the lanes that differ in `mask`: a
// lane keeps the upper half of v where its mask bit is set, else the lower
// half, each plus the partner lane's value of it.
template <int Q>
__device__ __forceinline__ void fold(const float (&v)[Q], float (&out)[Q / 2],
                                     int mask) {
  const bool hi = threadIdx.x & mask;
#pragma unroll
  for (int i = 0; i < Q / 2; ++i) {
    const float send = hi ? v[i] : v[i + Q / 2];
    out[i] = (hi ? v[i + Q / 2] : v[i]) +
             __shfl_xor_sync(0xffffffffu, send, mask);
  }
}

// The tile's column sums of z and z^2 over its BM rows into row m0 / BM of
// s1 and s2: q1/q2 hold this thread's sums over its four rows of column
// 8 (i / 2) + 2 t + (i & 1) of the tile.  `red` is warpgroup wg's
// [warp][2][BN] buffer of this tile.
__device__ __forceinline__ void column_sums(const float (&q1)[C::NQ],
                                            const float (&q2)[C::NQ],
                                            uint32_t red, int wg,
                                            const GemmArgs& g, int m0,
                                            int n0) {
  constexpr int Q = C::NQ;
  const int lane = threadIdx.x & 31, t = lane & 3, w4 = (threadIdx.x >> 5) & 3;
  // The 8 lanes of a column differ in lane bits 2-4: after the three folds
  // each holds Q / 8 of the warp's column sums, from index `off`.
  float h1[Q / 2], h2[Q / 2], u1[Q / 4], u2[Q / 4], f1[Q / 8], f2[Q / 8];
  fold(q1, h1, 16);
  fold(q2, h2, 16);
  fold(h1, u1, 8);
  fold(h2, u2, 8);
  fold(u1, f1, 4);
  fold(u2, f2, 4);
  const int off = (lane >> 4 & 1) * (Q / 2) + (lane >> 3 & 1) * (Q / 4) +
                  (lane >> 2 & 1) * (Q / 8);
#pragma unroll
  for (int i = 0; i < Q / 8; ++i) {
    const int q = off + i, col = 8 * (q >> 1) + 2 * t + (q & 1);
    const uint32_t at = red + 4 * (w4 * 2 * C::BN + col);
    sts32(at, __float_as_uint(f1[i]));
    sts32(at + 4 * C::BN, __float_as_uint(f2[i]));
  }
  sync_wg(wg);
  for (int c = threadIdx.x & 127; c < 2 * C::BN; c += 128) {
    const int which = c / C::BN, col = c % C::BN;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w)
      s += sm90::lds(red + 4 * (w * 2 * C::BN + which * C::BN + col));
    if (n0 + col < g.N)
      (which ? g.s2 : g.s1)[(long long)(m0 / BM) * g.N + n0 + col] = s;
  }
}

// The persistent GEMM: #3 (STATS false) applies scale, bias and relu; #4
// writes z and the column partial sums.
template <typename T, bool STATS>
__device__ __forceinline__ void gemm(const GemmParams& p) {
  extern __shared__ unsigned char gemm_smem[];
  __shared__ uint64_t bars[2 * C::STAGES];
  const GemmArgs& g = p.g;
  const uint32_t base = (sm90::smem_addr(gemm_smem) + 1023u) & ~1023u;
  const uint32_t full0 = sm90::smem_addr(bars);
  const uint32_t empty0 = full0 + 8 * C::STAGES;
  const int tiles_n = (g.N + C::BN - 1) / C::BN;
  const int tiles = (g.M + BM - 1) / BM * tiles_n;
  const int ksteps = (g.K + BK - 1) / BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      sm90::bar_init(full0 + 8 * s, 1);
      sm90::bar_init(empty0 + 8 * s, 4);  // the warps of one warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp >= 4 * C::WGS) {
    sm90::producer_regs<C>();
    if (threadIdx.x == 128 * C::WGS) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / tiles_n * BM, n0 = tile % tiles_n * C::BN;
        for (int kb = 0; kb < ksteps; ++kb, ++it) {
          const int s = it % C::STAGES;
          const uint32_t slot = base + s * C::SLOT, full = full0 + 8 * s;
          // A fresh slot passes; a used one waits for its 4 releases.
          sm90::bar_wait(empty0 + 8 * s, ((it / C::STAGES) & 1) ^ 1);
          sm90::bar_expect(full, C::SLOT);
          sm90::tma_load_2d(slot, &p.a, full, kb * BK, m0);
          sm90::tma_load_2d(slot + C::A_BYTES, &p.w, full, kb * BK, n0);
        }
      }
    }
    return;
  }
  sm90::consumer_regs<C>();

  // Warpgroup wg takes the CTA's tiles wg, wg + 2, ... (ring steps j ksteps
  // onwards for its j-th); a thread holds rows r0 and r0 + 8 of each 64-row
  // half, as wgmma's accumulators lay them out.
  const int wg = warp >> 2, t = lane & 3;
  const int r0 = 16 * (warp & 3) + (lane >> 2);
  const uint32_t stage = base + C::STAGES * C::SLOT + wg * C::OUT;
  const uint32_t red = base + C::STAGES * C::SLOT + C::WGS * C::OUT +
                       wg * 2 * C::RED;
  const bool leader = (threadIdx.x & 127) == 0;
  sm90::start_turns<C>(wg);
  float acc[2][C::NA];
  int count = 0;
  for (int j = wg, tile = blockIdx.x + wg * gridDim.x; tile < tiles;
       j += C::WGS, tile += C::WGS * gridDim.x, ++count) {
    const int m0 = tile / tiles_n * BM, n0 = tile % tiles_n * C::BN;
    sm90::take_turn<C>(wg);
    for (int kb = 0, it = j * ksteps; kb < ksteps; ++kb, ++it) {
      const int s = it % C::STAGES;
      const uint32_t slot = base + s * C::SLOT;
      sm90::bar_wait(full0 + 8 * s, (it / C::STAGES) & 1);
      sm90::wgmma_fence();
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t da =
              sm90::desc(slot + h * 64 * sm90::ROW_BYTES + 32 * kk, 16);
          const uint64_t db = sm90::desc(slot + C::A_BYTES + 32 * kk, 16);
          sm90::Wgmma<T, C::BN>::ss(acc[h], da, db, kb > 0 || kk > 0);
        }
      sm90::wgmma_commit();
      if (kb > 0) {  // the previous slot's products are done with it
        sm90::wgmma_wait<1>();
        release(empty0 + 8 * ((it - 1) % C::STAGES));
      }
    }
    sm90::pass_turn<C>(wg);  // the other warpgroup's products queue behind
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc[0]);
    sm90::fence_regs(acc[1]);
    release(empty0 + 8 * ((j * ksteps + ksteps - 1) % C::STAGES));

    // The staging tile is free once this warpgroup's previous store has
    // read it.
    if (leader) sm90::bulk_wait_read<0>();
    sync_wg(wg);
    float q1[STATS ? C::NQ : 1], q2[STATS ? C::NQ : 1];
#pragma unroll
    for (int jc = 0; jc < C::BN / 8; ++jc) {  // 8-column groups
      const int col = n0 + 8 * jc + 2 * t;
      float sc[2] = {1.f, 1.f}, bi[2] = {0.f, 0.f};
      if constexpr (!STATS) {
        if (col < g.N) {
          sc[0] = g.scale[col];
          sc[1] = g.scale[col + 1];
          bi[0] = g.bias[col];
          bi[1] = g.bias[col + 1];
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float v0 = acc[h][4 * jc + 2 * r], v1 = acc[h][4 * jc + 2 * r + 1];
          if constexpr (!STATS) {
            v0 = v0 * sc[0] + bi[0];
            v1 = v1 * sc[1] + bi[1];
            if (g.relu) {
              v0 = fmaxf(v0, 0.f);
              v1 = fmaxf(v1, 0.f);
            }
          }
          // Row `row` of the 64-column half jc / 8, 16-byte chunk jc % 8,
          // swizzled as the TMA reads it: chunk ^ (row % 8).
          const int row = 64 * h + r0 + 8 * r;
          sts32(stage + (jc >> 3) * BM * sm90::ROW_BYTES +
                    row * sm90::ROW_BYTES + (((jc & 7) ^ (row & 7)) << 4) +
                    4 * t,
                Mma<T>::pack(v0, v1));
        }
      if constexpr (STATS) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x1 = 0.f, x2 = 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) {  // rows r0, r0 + 8, r0 + 64, r0 + 72
            const float v = acc[i >> 1][4 * jc + 2 * (i & 1) + e];
            x1 += v;
            x2 += v * v;
          }
          q1[2 * jc + e] = x1;
          q2[2 * jc + e] = x2;
        }
      }
    }
    sm90::fence_async_shared();
    sync_wg(wg);
    if (leader && m0 < g.M) {
#pragma unroll
      for (int ch = 0; ch < C::BN / 64; ++ch)
        if (n0 + 64 * ch < g.N)
          sm90::tma_store_2d(&p.out, stage + ch * BM * sm90::ROW_BYTES,
                             n0 + 64 * ch, m0);
      sm90::bulk_commit();
    }
    // Two buffers of partials, alternating by tile: a thread writes a
    // buffer again only after every thread of its warpgroup has passed the
    // next tile's first barrier, so after every read of it.
    if constexpr (STATS)
      column_sums(q1, q2, red + (count & 1) * C::RED, wg, g, m0, n0);
  }
  if (leader) sm90::bulk_wait<0>();  // the stores have left shared memory
}

template <typename T>
__global__ void __launch_bounds__(C::THREADS, 1)
    mm_bn_relu_kernel(const __grid_constant__ GemmParams p) {
  gemm<T, false>(p);
}

template <typename T>
__global__ void __launch_bounds__(C::THREADS, 1)
    mm_stats_kernel(const __grid_constant__ GemmParams p) {
  gemm<T, true>(p);
}

int num_sms() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 0;
  }
  return n;
}

template <typename T, typename Kernel>
cudaError_t run(Kernel kernel, bool stats, const void* a, const void* wt,
                void* out, const GemmArgs& g, cudaStream_t stream) {
  const int tiles = (g.M + BM - 1) / BM * ((g.N + C::BN - 1) / C::BN);
  if (tiles == 0) return cudaSuccess;
  const int sms = num_sms();
  if (sms <= 0) return cudaErrorInvalidDevice;
  const int fp16 = std::is_same<T, __half>::value;
  GemmParams p = {};
  p.g = g;
  if (!sm90::make_map_2d(&p.a, a, fp16, g.M, g.K, BM) ||
      !sm90::make_map_2d(&p.w, wt, fp16, g.N, g.K, C::BN) ||
      !sm90::make_map_2d(&p.out, out, fp16, g.M, g.N, BM))
    return cudaErrorInvalidValue;
  const int smem = (int)C::smem(stats);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<tiles < sms ? tiles : sms, C::THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Tile height: the row count of each s1/s2 partial.
int hvdt_conv_fused_block_m() { return BM; }

int hvdt_mm_bn_relu(const void* a, const void* wt, const void* scale,
                    const void* bias, void* out, int M, int N, int K,
                    int relu, int fp16, void* stream) {
  GemmArgs g = {};
  g.scale = (const float*)scale;
  g.bias = (const float*)bias;
  g.M = M;
  g.N = N;
  g.K = K;
  g.relu = relu;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(fp16 ? run<__half>(mm_bn_relu_kernel<__half>, false, a, wt,
                                  out, g, st)
                    : run<bf16>(mm_bn_relu_kernel<bf16>, false, a, wt, out,
                                g, st));
}

int hvdt_mm_stats(const void* a, const void* wt, void* z, void* s1, void* s2,
                  int M, int N, int K, int fp16, void* stream) {
  GemmArgs g = {};
  g.s1 = (float*)s1;
  g.s2 = (float*)s2;
  g.M = M;
  g.N = N;
  g.K = K;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(fp16 ? run<__half>(mm_stats_kernel<__half>, true, a, wt, z, g,
                                  st)
                    : run<bf16>(mm_stats_kernel<bf16>, true, a, wt, z, g,
                                st));
}

}  // extern "C"
