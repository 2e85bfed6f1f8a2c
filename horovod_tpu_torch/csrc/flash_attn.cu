// Flash-attention kernels for Hopper (sm_90a), plain C interface.
//
// Replaces the three streaming Pallas TPU kernels of
// horovod_tpu/ops/pallas_kernels.py:
//   * _kernel     (via _flash_call: flash_attention, flash_block_update)
//                 -> hvdt_flash_fwd: online-softmax forward with an
//                    (acc, m, l) carry, or with the carry started at
//                    (0, -1e30, 0) and finished to (o = acc / l,
//                    lse = m + log l) in the same kernel;
//   * _dq_kernel  (flash_grad_block) -> hvdt_flash_dq: dQ from the saved
//                    logsumexp and delta = rowsum(dO * O);
//   * _dkv_kernel (flash_grad_block) -> hvdt_flash_dkv: dK, dV per q-head
//                    (the caller sums a GQA group afterwards).
//
// Layout: q, k, v, dO and o are [B, L, H(or Hkv), D] contiguous in bf16 or
// fp16 (the framework's layout: no transposes); the carry acc, dq and the
// per-q-head dk/dv are [B, L, H, D] f32; m, l, lse and delta [B, H, L] f32.
// Causal masking compares global positions q_offset + i >= k_offset + j;
// GQA reads kv head h / (H / Hkv), no K/V copy is made.
//
// What bounds them on this card.  At the LM path's shape (B 16, H 16,
// L 4096, D 64, causal) a forward does 2 * B*H*D * L(L+1)/2 * 2 = 5.5e11
// FLOP against about 0.27 GB of compulsory bytes: 0.56 ms of bf16 tensor
// work at 989 TFLOP/s against 0.08 ms of memory traffic at 3.35 TB/s, so
// all three kernels are bound by operations (dq does three products, dkv
// four).  The design keeps every score tile on chip: S = QK^T lives in the
// registers of the mma.sync accumulators, is turned into P (or dS) there
// and fed straight back as the A operand of the next product, so device
// memory sees only Q, K, V, dO once per CTA and the outputs once.  Causal
// blocks above the diagonal are never loaded or multiplied (the loop ends
// at the last visible block, as the TPU kernel's pl.when pruning does);
// only the blocks that straddle the diagonal evaluate the mask.
//
// Design (simple and correct first; wgmma/TMA are later work):
//   * the TPU kernels' sequential grid dimension (ik, or iq for dkv), whose
//     accumulators sit in VMEM scratch between grid steps, becomes a loop
//     inside one CTA; nothing is carried between CTAs;
//   * one 128-thread CTA (4 warps) per (q block of 64 rows, head, batch)
//     for the forward and dq, walking 64-row K/V blocks; one per (k block
//     of 64 rows, head, batch) for dkv, walking Q/dO blocks (64 rows at
//     D 64, 32 at D 128 to bound registers); each warp owns 16 rows;
//   * the streamed tiles come through shared memory with a cp.async
//     double buffer (rows padded by 8 elements against bank conflicts,
//     the ragged edge zero-filled); the resident tile is loaded once;
//   * products are mma.sync.m16n8k16 bf16/fp16 tensor-core tiles with f32
//     accumulators in registers; A/B fragments are read from shared memory
//     with 32-bit loads, or as 16-bit pairs where the operand's reduction
//     dimension is the tile's row dimension;
//   * numerics follow the TPU kernels: masked scores are -1e30 (not -inf),
//     p = exp(s - m_new) is zeroed where masked, P is rounded to V's type
//     before PV, l is the f32 sum of the unrounded p and is clamped at
//     1e-30 before o = acc / l; dq rounds dS to K's type, dkv rounds P to
//     dO's and dS to Q's type; expf/logf are the accurate forms.  A key
//     past the end of a ragged sequence counts as absent (-inf, p = 0).
//
// Requirements checked by the Python wrapper: D in {64, 128}, bf16 or fp16
// operands of one type, contiguous, 16-byte aligned.  Each entry returns
// cudaGetLastError() after its launch.  The mma, cp.async and fragment
// helpers are shared with flash_smallseq.cu through flash_common.cuh.

#include <math.h>

#include "flash_common.cuh"

namespace {

constexpr int BQ = 64;         // q rows per CTA (fwd, dq): 4 warps x 16
constexpr int BK = 64;         // k rows per step (fwd, dq) / per CTA (dkv)
constexpr float NEG = -1e30f;  // the TPU kernels' mask value

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;     // bwd: dO
  const float* lse;     // bwd
  const float* delta;   // bwd
  const float* acc_in;  // fwd carry in (null: zeros / -1e30 / zeros)
  const float* m_in;
  const float* l_in;
  float* acc_out;       // fwd carry out (when o is null) / dq / dk
  float* m_out;
  float* l_out;         // dv in dkv
  void* o;              // fwd: finished output (null: carry mode)
  float* lse_out;
  int B, H, Hkv, Lq, Lk, q_offset, k_offset, causal;
  float scale;
};

__device__ __forceinline__ bool visible(const Args& a, int qrow, int krow) {
  return krow < a.Lk && (!a.causal || a.q_offset + qrow >= a.k_offset + krow);
}

// Number of K blocks a q block [q0, q0 + BQ) can see.
__device__ __forceinline__ int k_blocks(const Args& a, int q0) {
  int nk = (a.Lk + BK - 1) / BK;
  if (a.causal) {
    int lim = a.q_offset + min(q0 + BQ, a.Lq) - 1 - a.k_offset;
    nk = lim < 0 ? 0 : min(nk, lim / BK + 1);
  }
  return nk;
}

// ---- #9: forward ----------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS) flash_fwd_kernel(Args a) {
  constexpr int LDS = D + 8;
  constexpr int NS = BK / 8;  // score n-tiles
  constexpr int NO = D / 8;   // output n-tiles
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + BQ * LDS;      // two stages
  T* sV = sK + 2 * BK * LDS;  // two stages

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const long long qs = (long long)a.H * D, ks = (long long)a.Hkv * D;
  const T* qp = static_cast<const T*>(a.q) + b * a.Lq * qs + h * D;
  const T* kp = static_cast<const T*>(a.k) + b * a.Lk * ks + hk * D;
  const T* vp = static_cast<const T*>(a.v) + b * a.Lk * ks + hk * D;
  const int nk = k_blocks(a, q0);
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  float o[NO][4];
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  if (a.acc_in != nullptr) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row[r] >= a.Lq) continue;
      const float* ap = a.acc_in + ((long long)(b * a.Lq + row[r]) * a.H + h) * D;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        float2 x = *reinterpret_cast<const float2*>(ap + 8 * j + 2 * t);
        o[j][2 * r] = x.x;
        o[j][2 * r + 1] = x.y;
      }
      m[r] = a.m_in[(long long)(b * a.H + h) * a.Lq + row[r]];
      l[r] = a.l_in[(long long)(b * a.H + h) * a.Lq + row[r]];
    }
  }

  load_tile<T, D, BQ>(sQ, qp, qs, q0, a.Lq);
  if (nk > 0) {
    load_tile<T, D, BK>(sK, kp, ks, 0, a.Lk);
    load_tile<T, D, BK>(sV, vp, ks, 0, a.Lk);
  }
  cp_async_commit();

  for (int kb = 0; kb < nk; ++kb) {
    const int st = kb & 1;
    if (kb + 1 < nk) {
      load_tile<T, D, BK>(sK + (st ^ 1) * BK * LDS, kp, ks, (kb + 1) * BK, a.Lk);
      load_tile<T, D, BK>(sV + (st ^ 1) * BK * LDS, vp, ks, (kb + 1) * BK, a.Lk);
    }
    cp_async_commit();   // possibly empty: keeps the group count uniform
    cp_async_wait<1>();  // every group but the newest has landed
    __syncthreads();
    const T* cK = sK + st * BK * LDS;
    const T* cV = sV + st * BK * LDS;

    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t fa[4];
      frag_a<T, LDS>(fa, sQ, warp * 16, kk * 16, g, t);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        uint32_t fb[2];
        frag_b_rows<T, LDS>(fb, cK, j * 8, kk * 16, g, t);
        Mma<T>::run(s[j], fa, fb);
      }
    }

    // Scale and mask, then the online-softmax update of (m, l, o).
    const int k0 = kb * BK;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * j + 2 * t + (e & 1);
        float x = s[j][e] * a.scale;
        if (col >= a.Lk)
          x = -INFINITY;
        else if (a.causal && a.q_offset + row[e >> 1] < a.k_offset + col)
          x = NEG;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float mn[2], corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mn[r] = fmaxf(m[r], quad_max(mx[r]));
      corr[r] = expf(m[r] - mn[r]);
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * j + 2 * t + (e & 1);
        const float p =
            visible(a, row[e >> 1], col) ? expf(s[j][e] - mn[e >> 1]) : 0.f;
        s[j][e] = p;
        sum[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = l[r] * corr[r] + quad_sum(sum[r]);
      m[r] = mn[r];
    }
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      o[j][0] *= corr[0];
      o[j][1] *= corr[0];
      o[j][2] *= corr[1];
      o[j][3] *= corr[1];
    }
    // o += P V, P rounded to V's type.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t fa[4];
      acc_to_a<T>(fa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        uint32_t fb[2];
        frag_b_cols<T, LDS>(fb, cV, kk * 16, j * 8, g, t);
        Mma<T>::run(o[j], fa, fb);
      }
    }
    __syncthreads();  // the next iteration refills this stage
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= a.Lq) continue;
    const long long off = ((long long)(b * a.Lq + row[r]) * a.H + h) * D;
    const long long moff = (long long)(b * a.H + h) * a.Lq + row[r];
    if (a.o != nullptr) {
      const float lc = fmaxf(l[r], 1e-30f);
      T* op = static_cast<T*>(a.o) + off;
#pragma unroll
      for (int j = 0; j < NO; ++j)
        *reinterpret_cast<uint32_t*>(op + 8 * j + 2 * t) =
            Mma<T>::pack(o[j][2 * r] / lc, o[j][2 * r + 1] / lc);
      if (t == 0) a.lse_out[moff] = m[r] + logf(lc);
    } else {
      float* ap = a.acc_out + off;
#pragma unroll
      for (int j = 0; j < NO; ++j)
        *reinterpret_cast<float2*>(ap + 8 * j + 2 * t) =
            make_float2(o[j][2 * r], o[j][2 * r + 1]);
      if (t == 0) {
        a.m_out[moff] = m[r];
        a.l_out[moff] = l[r];
      }
    }
  }
}

// ---- #10: dQ --------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS) flash_dq_kernel(Args a) {
  constexpr int LDS = D + 8;
  constexpr int NS = BK / 8;
  constexpr int NO = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sO = sQ + BQ * LDS;      // dO
  T* sK = sO + BQ * LDS;      // two stages
  T* sV = sK + 2 * BK * LDS;  // two stages

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const long long qs = (long long)a.H * D, ks = (long long)a.Hkv * D;
  const T* qp = static_cast<const T*>(a.q) + b * a.Lq * qs + h * D;
  const T* dp = static_cast<const T*>(a.dout) + b * a.Lq * qs + h * D;
  const T* kp = static_cast<const T*>(a.k) + b * a.Lk * ks + hk * D;
  const T* vp = static_cast<const T*>(a.v) + b * a.Lk * ks + hk * D;
  const int nk = k_blocks(a, q0);
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float lse[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long moff = (long long)(b * a.H + h) * a.Lq + row[r];
    lse[r] = row[r] < a.Lq ? a.lse[moff] : 0.f;
    dl[r] = row[r] < a.Lq ? a.delta[moff] : 0.f;
  }

  float dq[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;

  load_tile<T, D, BQ>(sQ, qp, qs, q0, a.Lq);
  load_tile<T, D, BQ>(sO, dp, qs, q0, a.Lq);
  if (nk > 0) {
    load_tile<T, D, BK>(sK, kp, ks, 0, a.Lk);
    load_tile<T, D, BK>(sV, vp, ks, 0, a.Lk);
  }
  cp_async_commit();

  for (int kb = 0; kb < nk; ++kb) {
    const int st = kb & 1;
    if (kb + 1 < nk) {
      load_tile<T, D, BK>(sK + (st ^ 1) * BK * LDS, kp, ks, (kb + 1) * BK, a.Lk);
      load_tile<T, D, BK>(sV + (st ^ 1) * BK * LDS, vp, ks, (kb + 1) * BK, a.Lk);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* cK = sK + st * BK * LDS;
    const T* cV = sV + st * BK * LDS;

    float s[NS][4], pd[NS][4];  // scores, then dP
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = pd[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t fq[4], fo[4];
      frag_a<T, LDS>(fq, sQ, warp * 16, kk * 16, g, t);
      frag_a<T, LDS>(fo, sO, warp * 16, kk * 16, g, t);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        uint32_t fb[2];
        frag_b_rows<T, LDS>(fb, cK, j * 8, kk * 16, g, t);
        Mma<T>::run(s[j], fq, fb);
        frag_b_rows<T, LDS>(fb, cV, j * 8, kk * 16, g, t);
        Mma<T>::run(pd[j], fo, fb);
      }
    }
    // p = exp(s * scale - lse) where visible; dS = p * (dP - delta) * scale
    const int k0 = kb * BK;
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int col = k0 + 8 * j + 2 * t + (e & 1);
        const float p =
            visible(a, row[r], col) ? expf(s[j][e] * a.scale - lse[r]) : 0.f;
        s[j][e] = p * (pd[j][e] - dl[r]) * a.scale;
      }
    // dq += dS K, dS rounded to K's type.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t fa[4];
      acc_to_a<T>(fa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        uint32_t fb[2];
        frag_b_cols<T, LDS>(fb, cK, kk * 16, j * 8, g, t);
        Mma<T>::run(dq[j], fa, fb);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= a.Lq) continue;
    float* out = a.acc_out + ((long long)(b * a.Lq + row[r]) * a.H + h) * D;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      *reinterpret_cast<float2*>(out + 8 * j + 2 * t) =
          make_float2(dq[j][2 * r], dq[j][2 * r + 1]);
  }
}

// ---- #11: dK, dV ----------------------------------------------------------

template <int D>
struct DkvTile {
  static constexpr int BQ2 = D == 64 ? 64 : 32;  // q rows per step
};

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS) flash_dkv_kernel(Args a) {
  constexpr int LDS = D + 8;
  constexpr int BQ2 = DkvTile<D>::BQ2;
  constexpr int NS = BQ2 / 8;
  constexpr int NO = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + BK * LDS;
  T* sQ = sV + BK * LDS;        // two stages
  T* sO = sQ + 2 * BQ2 * LDS;   // dO, two stages
  float* sL = reinterpret_cast<float*>(sO + 2 * BQ2 * LDS);  // lse, 2 stages
  float* sD = sL + 2 * BQ2;                                  // delta

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * BK;  // longest (earliest) rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const long long qs = (long long)a.H * D, ks = (long long)a.Hkv * D;
  const T* qp = static_cast<const T*>(a.q) + b * a.Lq * qs + h * D;
  const T* dp = static_cast<const T*>(a.dout) + b * a.Lq * qs + h * D;
  const T* kp = static_cast<const T*>(a.k) + b * a.Lk * ks + hk * D;
  const T* vp = static_cast<const T*>(a.v) + b * a.Lk * ks + hk * D;
  const float* lp = a.lse + (long long)(b * a.H + h) * a.Lq;
  const float* delp = a.delta + (long long)(b * a.H + h) * a.Lq;
  const int nq = (a.Lq + BQ2 - 1) / BQ2;
  int iq0 = 0;
  if (a.causal) {  // first q block whose last row reaches this k block
    const int need = a.k_offset + k0 - a.q_offset - (BQ2 - 1);
    iq0 = need <= 0 ? 0 : (need + BQ2 - 1) / BQ2;
  }
  const int krow[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};

  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  load_tile<T, D, BK>(sK, kp, ks, k0, a.Lk);
  load_tile<T, D, BK>(sV, vp, ks, k0, a.Lk);
  if (iq0 < nq) {
    load_tile<T, D, BQ2>(sQ, qp, qs, iq0 * BQ2, a.Lq);
    load_tile<T, D, BQ2>(sO, dp, qs, iq0 * BQ2, a.Lq);
    if (threadIdx.x < BQ2) {
      const int r = iq0 * BQ2 + threadIdx.x;
      sL[threadIdx.x] = r < a.Lq ? lp[r] : 0.f;
      sD[threadIdx.x] = r < a.Lq ? delp[r] : 0.f;
    }
  }
  cp_async_commit();

  for (int iq = iq0; iq < nq; ++iq) {
    const int st = (iq - iq0) & 1;
    if (iq + 1 < nq) {
      const int n = st ^ 1;
      load_tile<T, D, BQ2>(sQ + n * BQ2 * LDS, qp, qs, (iq + 1) * BQ2, a.Lq);
      load_tile<T, D, BQ2>(sO + n * BQ2 * LDS, dp, qs, (iq + 1) * BQ2, a.Lq);
      if (threadIdx.x < BQ2) {
        const int r = (iq + 1) * BQ2 + threadIdx.x;
        sL[n * BQ2 + threadIdx.x] = r < a.Lq ? lp[r] : 0.f;
        sD[n * BQ2 + threadIdx.x] = r < a.Lq ? delp[r] : 0.f;
      }
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* cQ = sQ + st * BQ2 * LDS;
    const T* cO = sO + st * BQ2 * LDS;
    const float* cL = sL + st * BQ2;
    const float* cD = sD + st * BQ2;

    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 k rows x BQ2 q columns.
    float s[NS][4], pd[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = pd[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t fk[4], fv[4];
      frag_a<T, LDS>(fk, sK, warp * 16, kk * 16, g, t);
      frag_a<T, LDS>(fv, sV, warp * 16, kk * 16, g, t);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        uint32_t fb[2];
        frag_b_rows<T, LDS>(fb, cQ, j * 8, kk * 16, g, t);
        Mma<T>::run(s[j], fk, fb);
        frag_b_rows<T, LDS>(fb, cO, j * 8, kk * 16, g, t);
        Mma<T>::run(pd[j], fv, fb);
      }
    }
    // P^T and dS^T; a q row past the end of a ragged sequence counts as
    // absent.
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1);
        const int qrow = iq * BQ2 + c;
        const float p = (qrow < a.Lq && visible(a, qrow, krow[e >> 1]))
                            ? expf(s[j][e] * a.scale - cL[c])
                            : 0.f;
        s[j][e] = p;
        pd[j][e] = p * (pd[j][e] - cD[c]) * a.scale;
      }
    // dV += P^T dO (P rounded to dO's type); dK += dS^T Q (dS to Q's).
#pragma unroll
    for (int kk = 0; kk < BQ2 / 16; ++kk) {
      uint32_t fp[4], fs[4];
      acc_to_a<T>(fp, s[2 * kk], s[2 * kk + 1]);
      acc_to_a<T>(fs, pd[2 * kk], pd[2 * kk + 1]);
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        uint32_t fb[2];
        frag_b_cols<T, LDS>(fb, cO, kk * 16, j * 8, g, t);
        Mma<T>::run(dv[j], fp, fb);
        frag_b_cols<T, LDS>(fb, cQ, kk * 16, j * 8, g, t);
        Mma<T>::run(dk[j], fs, fb);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (krow[r] >= a.Lk) continue;
    const long long off = ((long long)(b * a.Lk + krow[r]) * a.H + h) * D;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      *reinterpret_cast<float2*>(a.acc_out + off + 8 * j + 2 * t) =
          make_float2(dk[j][2 * r], dk[j][2 * r + 1]);
      *reinterpret_cast<float2*>(a.l_out + off + 8 * j + 2 * t) =
          make_float2(dv[j][2 * r], dv[j][2 * r + 1]);
    }
  }
}

template <typename T, int D>
constexpr size_t fwd_smem() {
  return (size_t)(BQ + 4 * BK) * (D + 8) * sizeof(T);
}
template <typename T, int D>
constexpr size_t dq_smem() {
  return (size_t)(2 * BQ + 4 * BK) * (D + 8) * sizeof(T);
}
template <typename T, int D>
constexpr size_t dkv_smem() {
  return (size_t)(2 * BK + 4 * DkvTile<D>::BQ2) * (D + 8) * sizeof(T) +
         4 * DkvTile<D>::BQ2 * sizeof(float);
}

// kind: 0 forward, 1 dq, 2 dkv.
template <typename T, int D>
cudaError_t dispatch(int kind, const Args& a, cudaStream_t stream) {
  if (kind == 0)
    return launch(flash_fwd_kernel<T, D>, fwd_smem<T, D>(),
                  dim3((a.Lq + BQ - 1) / BQ, a.H, a.B), a, stream);
  if (kind == 1)
    return launch(flash_dq_kernel<T, D>, dq_smem<T, D>(),
                  dim3((a.Lq + BQ - 1) / BQ, a.H, a.B), a, stream);
  return launch(flash_dkv_kernel<T, D>, dkv_smem<T, D>(),
                dim3((a.Lk + BK - 1) / BK, a.H, a.B), a, stream);
}

int run(int kind, const Args& a, int D, int fp16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (D != 64 && D != 128) return (int)cudaErrorInvalidValue;
  if (a.H <= 0 || a.Hkv <= 0 || a.H % a.Hkv) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (fp16)
    err = D == 64 ? dispatch<__half, 64>(kind, a, s)
                  : dispatch<__half, 128>(kind, a, s);
  else
    err = D == 64 ? dispatch<bf16, 64>(kind, a, s)
                  : dispatch<bf16, 128>(kind, a, s);
  return (int)err;
}

Args make_args(const void* q, const void* k, const void* v, int B, int H,
               int Hkv, int Lq, int Lk, int q_offset, int k_offset,
               int causal, float scale) {
  Args a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.B = B;
  a.H = H;
  a.Hkv = Hkv;
  a.Lq = Lq;
  a.Lk = Lk;
  a.q_offset = q_offset;
  a.k_offset = k_offset;
  a.causal = causal;
  a.scale = scale;
  return a;
}

}  // namespace

extern "C" {

// Forward.  acc_in/m_in/l_in may be null (carry starts at 0, -1e30, 0).
// With o non-null the finished (o, lse) is written; otherwise the carry
// (acc_out, m_out, l_out).
int hvdt_flash_fwd(const void* q, const void* k, const void* v,
                   const void* acc_in, const void* m_in, const void* l_in,
                   void* acc_out, void* m_out, void* l_out, void* o,
                   void* lse, int B, int H, int Hkv, int Lq, int Lk, int D,
                   int fp16, int q_offset, int k_offset, int causal,
                   float scale, void* stream) {
  Args a = make_args(q, k, v, B, H, Hkv, Lq, Lk, q_offset, k_offset, causal,
                     scale);
  a.acc_in = (const float*)acc_in;
  a.m_in = (const float*)m_in;
  a.l_in = (const float*)l_in;
  a.acc_out = (float*)acc_out;
  a.m_out = (float*)m_out;
  a.l_out = (float*)l_out;
  a.o = o;
  a.lse_out = (float*)lse;
  return run(0, a, D, fp16, stream);
}

int hvdt_flash_dq(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dq, int B, int H, int Hkv, int Lq, int Lk, int D,
                  int fp16, int q_offset, int k_offset, int causal,
                  float scale, void* stream) {
  Args a = make_args(q, k, v, B, H, Hkv, Lq, Lk, q_offset, k_offset, causal,
                     scale);
  a.dout = dout;
  a.lse = (const float*)lse;
  a.delta = (const float*)delta;
  a.acc_out = (float*)dq;
  return run(1, a, D, fp16, stream);
}

// dk/dv are per q-head, [B, Lk, H, D] f32.
int hvdt_flash_dkv(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dk, void* dv, int B, int H, int Hkv, int Lq, int Lk,
                   int D, int fp16, int q_offset, int k_offset, int causal,
                   float scale, void* stream) {
  Args a = make_args(q, k, v, B, H, Hkv, Lq, Lk, q_offset, k_offset, causal,
                     scale);
  a.dout = dout;
  a.lse = (const float*)lse;
  a.delta = (const float*)delta;
  a.acc_out = (float*)dk;
  a.l_out = (float*)dv;
  return run(2, a, D, fp16, stream);
}

}  // extern "C"
