// Fused 1x1-conv matmul kernels for Hopper (sm_90a), plain C interface.
//
// Replaces the two Pallas TPU kernels of horovod_tpu/ops/conv_fused.py:
//   * _mm_kernel       (via _mm_forward)       -> hvdt_mm_bn_relu
//       y = relu((a @ w) * scale + bias), f32 accumulation, one bf16 write;
//   * _mm_stats_kernel (matmul_batch_stats)    -> hvdt_mm_stats
//       z = a @ w written once in bf16, plus per-M-tile partial sums of z
//       and z^2 taken from the f32 accumulator: s1/s2 [ceil(M/BM), N].
//
// Operands: a [M, K] bf16 row-major; the weight is passed TRANSPOSED, as
// wt [N, K] bf16 row-major (the OIHW layout of a 1x1 conv weight), which is
// the column-major B operand the tensor cores take directly.
//
// What bounds it on this card.  ResNet-50's fused 1x1 convs have K and N in
// 128..2048 and M = batch*H*W in the tens of thousands: at bs 64 the
// stage-2 conv3 (M=12544, K=256, N=1024) is 6.6 GFLOP (6.6 us at 989
// TFLOP/s bf16) against 32.6 MB of compulsory traffic (9.7 us at 3.35
// TB/s), so these products are memory-bound or close to it.  The design
// therefore spends its effort on moving each byte once: one pass reads a
// and w, and the only [M, N] traffic is the single bf16 write of the
// output; the BN affine (#3) or the batch statistics (#4) are computed
// from the f32 accumulator tile while it is still on chip, instead of in a
// second pass over z.
//
// Design (simple and correct first; wgmma/TMA are later work):
//   * one 256-thread CTA per 128x128 output tile, K walked in 32-wide
//     steps; a cp.async double buffer stages the A and W tiles in shared
//     memory (rows padded to 40 bf16 against bank conflicts), zero-filling
//     the ragged M/N/K edges;
//   * 8 warps in a 2x4 layout, each owning a 64x32 sub-tile as 4x2
//     tensor-core fragments (nvcuda::wmma bf16 16x16x16, f32 accumulate);
//   * epilogue: the accumulator tile goes to shared memory (f32, 66 KB of
//     dynamic shared memory reusing the staging buffers), then
//       - #3 applies scale/bias/relu and writes bf16 in 16-byte stores;
//       - #4 writes z in bf16 the same way, and 128 threads each reduce one
//         column over the tile's rows in a fixed order into s1/s2.  No
//         atomics: the partial sums are bit-identical from run to run, and
//         the caller sums the [ceil(M/128), N] partials as the JAX package
//         sums its [M/bm, N] ones.
//
// Requirements checked by the Python wrapper: K % 8 == 0, N % 8 == 0,
// 16-byte-aligned contiguous operands (16-byte cp.async and vector stores).
// Each entry returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int NTHREADS = 256;
constexpr int LDS = BK + 8;    // staging row stride, bf16 elements
constexpr int LDC = BN + 4;    // accumulator tile row stride, f32 elements
constexpr int STAGE_ELEMS = (BM + BN) * LDS;
constexpr size_t SMEM_STAGES = 2 * STAGE_ELEMS * sizeof(bf16);
constexpr size_t SMEM_C = (size_t)BM * LDC * sizeof(float);
constexpr size_t SMEM_BYTES = SMEM_C > SMEM_STAGES ? SMEM_C : SMEM_STAGES;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int src_size = pred ? 16 : 0;  // 0 bytes read: the 16 bytes are zeroed
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_size)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage one BK-wide slice of the A tile (BM rows) and of the W tile (BN
// rows of wt) into shared memory, 16 bytes per copy.
__device__ __forceinline__ void load_stage(bf16* sA, bf16* sB,
                                           const bf16* __restrict__ a,
                                           const bf16* __restrict__ wt,
                                           int M, int N, int K, int m0,
                                           int n0, int k0, int tid) {
  constexpr int CHUNKS = BK / 8;
#pragma unroll
  for (int c = tid; c < BM * CHUNKS; c += NTHREADS) {
    int r = c / CHUNKS, kc = (c % CHUNKS) * 8;
    int gr = m0 + r, gk = k0 + kc;
    bool p = gr < M && gk < K;
    cp_async16(sA + r * LDS + kc, p ? a + (size_t)gr * K + gk : a, p);
  }
#pragma unroll
  for (int c = tid; c < BN * CHUNKS; c += NTHREADS) {
    int r = c / CHUNKS, kc = (c % CHUNKS) * 8;
    int gn = n0 + r, gk = k0 + kc;
    bool p = gn < N && gk < K;
    cp_async16(sB + r * LDS + kc, p ? wt + (size_t)gn * K + gk : wt, p);
  }
}

// The K loop: leaves the CTA's f32 accumulator tile in shared memory
// (row-major, stride LDC) and returns after a barrier.
__device__ __forceinline__ float* mma_tile(unsigned char* smem,
                                           const bf16* __restrict__ a,
                                           const bf16* __restrict__ wt,
                                           int M, int N, int K, int m0,
                                           int n0) {
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 4;  // 0..1: 64-row half of the tile
  const int wn = warp % 4;  // 0..3: 32-column quarter of the tile
  bf16* stages = reinterpret_cast<bf16*>(smem);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int ktiles = (K + BK - 1) / BK;
  load_stage(stages, stages + BM * LDS, a, wt, M, N, K, m0, n0, 0, tid);
  cp_async_commit();
  for (int kt = 0; kt < ktiles; ++kt) {
    if (kt + 1 < ktiles) {
      bf16* nA = stages + ((kt + 1) & 1) * STAGE_ELEMS;
      load_stage(nA, nA + BM * LDS, a, wt, M, N, K, m0, n0, (kt + 1) * BK,
                 tid);
    }
    cp_async_commit();   // possibly empty: keeps the group count uniform
    cp_async_wait<1>();  // every group but the newest has landed
    __syncthreads();
    const bf16* sA = stages + (kt & 1) * STAGE_ELEMS;
    const bf16* sB = sA + BM * LDS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(fa[i], sA + (wm * 64 + i * 16) * LDS + kk, LDS);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], sB + (wn * 32 + j * 16) * LDS + kk, LDS);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();  // the next iteration refills this stage
  }
  cp_async_wait<0>();
  __syncthreads();

  float* sC = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(sC + (wm * 64 + i * 16) * LDC + wn * 32 + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  return sC;
}

// Write the tile (after the optional affine + relu) as bf16, 8 values per
// 16-byte store.  N % 8 == 0, so a chunk is wholly in or out of bounds.
template <bool AFFINE>
__device__ __forceinline__ void store_tile(const float* sC,
                                           bf16* __restrict__ out,
                                           const float* __restrict__ scale,
                                           const float* __restrict__ bias,
                                           int relu, int M, int N, int m0,
                                           int n0) {
  constexpr int CHUNKS = BN / 8;
  for (int c = threadIdx.x; c < BM * CHUNKS; c += NTHREADS) {
    int r = c / CHUNKS, cc = (c % CHUNKS) * 8;
    int gr = m0 + r, gc = n0 + cc;
    if (gr >= M || gc >= N) continue;
    uint32_t words[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float v0 = sC[r * LDC + cc + 2 * q];
      float v1 = sC[r * LDC + cc + 2 * q + 1];
      if (AFFINE) {
        v0 = v0 * scale[gc + 2 * q] + bias[gc + 2 * q];
        v1 = v1 * scale[gc + 2 * q + 1] + bias[gc + 2 * q + 1];
        if (relu) {
          v0 = fmaxf(v0, 0.0f);
          v1 = fmaxf(v1, 0.0f);
        }
      }
      __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
      words[q] = *reinterpret_cast<uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(out + (size_t)gr * N + gc) =
        make_uint4(words[0], words[1], words[2], words[3]);
  }
}

__global__ void __launch_bounds__(NTHREADS)
    mm_bn_relu_kernel(const bf16* __restrict__ a, const bf16* __restrict__ wt,
                      const float* __restrict__ scale,
                      const float* __restrict__ bias, bf16* __restrict__ out,
                      int M, int N, int K, int relu) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const float* sC = mma_tile(smem, a, wt, M, N, K, m0, n0);
  store_tile<true>(sC, out, scale, bias, relu, M, N, m0, n0);
}

__global__ void __launch_bounds__(NTHREADS)
    mm_stats_kernel(const bf16* __restrict__ a, const bf16* __restrict__ wt,
                    bf16* __restrict__ z, float* __restrict__ s1,
                    float* __restrict__ s2, int M, int N, int K) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const float* sC = mma_tile(smem, a, wt, M, N, K, m0, n0);
  store_tile<false>(sC, z, nullptr, nullptr, 0, M, N, m0, n0);
  // Column partial sums of the f32 accumulator over this tile's valid
  // rows, in row order: fixed association, no atomics.
  const int col = threadIdx.x;
  if (col < BN && n0 + col < N) {
    const int rows = min(BM, M - m0);
    float t1 = 0.0f, t2 = 0.0f;
    for (int r = 0; r < rows; ++r) {
      float v = sC[r * LDC + col];
      t1 += v;
      t2 += v * v;
    }
    s1[(size_t)blockIdx.x * N + n0 + col] = t1;
    s2[(size_t)blockIdx.x * N + n0 + col] = t2;
  }
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)SMEM_BYTES);
}

}  // namespace

extern "C" {

// Tile height: the row count of each s1/s2 partial.
int hvdt_conv_fused_block_m() { return BM; }

int hvdt_mm_bn_relu(const void* a, const void* wt, const void* scale,
                    const void* bias, void* out, int M, int N, int K,
                    int relu, void* stream) {
  cudaError_t err = prepare(mm_bn_relu_kernel);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  mm_bn_relu_kernel<<<grid, NTHREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const bf16*)a, (const bf16*)wt, (const float*)scale,
      (const float*)bias, (bf16*)out, M, N, K, relu);
  return (int)cudaGetLastError();
}

int hvdt_mm_stats(const void* a, const void* wt, void* z, void* s1, void* s2,
                  int M, int N, int K, void* stream) {
  cudaError_t err = prepare(mm_stats_kernel);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  mm_stats_kernel<<<grid, NTHREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const bf16*)a, (const bf16*)wt, (bf16*)z, (float*)s1, (float*)s2, M, N,
      K);
  return (int)cudaGetLastError();
}

}  // extern "C"
