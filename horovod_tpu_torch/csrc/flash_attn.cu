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
// four).  Every score tile stays on chip: S = QK^T lives in the registers
// of the tensor-core accumulators, is turned into P (or dS) there and fed
// straight back as the A operand of the next product, so device memory
// sees only Q, K, V, dO once per CTA and the outputs once.  Causal blocks
// above the diagonal are never loaded or multiplied (the loop ends at the
// last visible block, as the TPU kernel's pl.when pruning does).
//
// #9, the forward, runs on the Hopper core of flash_sm90.cuh, which it
// shares with #12.  Against its operations bound:
//   * products are wgmma (the only way to the tensor cores' full rate):
//     S = QK^T from 128-byte-swizzled shared memory, O += PV with P from
//     registers and V through the transposed descriptor;
//   * one CTA owns 192 q rows (three consumer warpgroups of 64) at D 64
//     and at D 128, so each K/V tile pulled through L2 feeds 192 rows: at
//     64 rows a CTA the forward moved 8.7 GB through L2 a call, at 192
//     2.9 GB.  A producer warpgroup keeps TMA loads of 128 (D 64) or 64
//     (D 128) K/V rows in a 3-slot ring and gives its registers to the
//     consumers (setmaxnreg: 160 each);
//   * inside a warpgroup, tile j+1's QK^T and tile j's PV are issued before
//     tile j+1's softmax, which runs while the tensor cores work; the
//     warpgroups take turns to issue (ping-pong), so one's softmax
//     overlaps the others' products;
//   * only tiles that straddle the causal diagonal or the ragged end are
//     masked; p = 2^(s * scale * log2e - m * log2e), one FFMA and one ex2;
//   * the tiles (FwdCfg below) were chosen by timing other BK, ring
//     slots, warpgroups and CTAs an SM on the card (PERF.md).
//
// #10 and #11, the backward (simple and correct first; wgmma/TMA are
// later work):
//   * the TPU kernels' sequential grid dimension (ik, or iq for dkv), whose
//     accumulators sit in VMEM scratch between grid steps, becomes a loop
//     inside one CTA; nothing is carried between CTAs;
//   * one 128-thread CTA (4 warps) per (q block of 64 rows, head, batch)
//     for dq, walking 64-row K/V blocks; one per (k block of 64 rows,
//     head, batch) for dkv, walking Q/dO blocks (64 rows at D 64, 32 at
//     D 128 to bound registers); each warp owns 16 rows;
//   * the streamed tiles come through shared memory with a cp.async
//     double buffer (rows padded by 8 elements against bank conflicts,
//     the ragged edge zero-filled); the resident tile is loaded once;
//   * products are mma.sync.m16n8k16 bf16/fp16 tensor-core tiles with f32
//     accumulators in registers; A/B fragments are read from shared memory
//     with 32-bit loads, or as 16-bit pairs where the operand's reduction
//     dimension is the tile's row dimension.
//
// Numerics follow the TPU kernels: masked scores are -1e30 (not -inf),
// p = exp(s - m_new) is zeroed where masked, P is rounded to V's type
// before PV, l is the f32 sum of the unrounded p and is clamped at 1e-30
// before o = acc / l; dq rounds dS to K's type, dkv rounds P to dO's and
// dS to Q's type.  A key past the end of a ragged sequence counts as
// absent (-inf, p = 0).  In the forward a q row that sees no key passes
// its carry (acc, m, l) through bit for bit.
//
// Requirements checked by the Python wrapper: D in {64, 128}, bf16 or fp16
// operands of one type, contiguous, 16-byte aligned.  Each entry returns
// cudaGetLastError() after its launch (the forward also fails if a tensor
// map cannot be built).  The mma, cp.async and fragment helpers are shared
// with flash_smallseq.cu through flash_common.cuh.

#include <math.h>

#include "flash_common.cuh"
#include "flash_sm90.cuh"

namespace {

constexpr int BQ = 64;         // q rows per CTA (dq): 4 warps x 16
constexpr int BK = 64;         // k rows per step (dq) / per CTA (dkv)
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

// ---- #9: forward, on the Hopper core (flash_sm90.cuh) ---------------------

// The tiles: 192 q rows a CTA (three consumer warpgroups, ping-pong), 128
// K/V rows a step at D 64 and 64 at D 128, three ring slots, one CTA an SM.
template <int D>
using FwdCfg = sm90::Cfg<D, D == 64 ? 128 : 64, 3, 3, 1>;

template <typename T, int D>
__global__ void __launch_bounds__(FwdCfg<D>::THREADS, FwdCfg<D>::CTAS)
    flash_fwd_kernel(const __grid_constant__ sm90::FwdParams<Args> p) {
  using C = FwdCfg<D>;
  extern __shared__ unsigned char sm90_smem[];
  __shared__ uint64_t bars[C::BARS];
  const Args& a = p.a;
  const sm90::Ring<C> ring(sm90_smem, bars);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * C::BQ;  // longest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int shift = a.q_offset - a.k_offset;
  const int nk =
      sm90::visible_tiles<C>(q0, C::BQ, a.Lq, a.Lk, a.causal, shift);
  ring.init();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= C::CONSUMER_WARPS) {
    sm90::producer_regs<C>();
    if (threadIdx.x == 32 * C::CONSUMER_WARPS && nk > 0)
      sm90::produce(ring, &p.q, &p.k, &p.v, h, h / (a.H / a.Hkv), b, q0, nk,
                    nk, 0);
    return;
  }
  sm90::consumer_regs<C>();
  sm90::start_turns<C>(warp >> 2);

  // Warpgroup wg owns rows [r0, r0 + 64); each thread rows g and g + 8 of
  // its warp's 16, as wgmma's accumulators lay them out.
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int r0 = q0 + 64 * wg;
  const int row[2] = {r0 + 16 * (warp & 3) + g, r0 + 16 * (warp & 3) + g + 8};
  const int nk_wg =
      sm90::visible_tiles<C>(r0, 64, a.Lq, a.Lk, a.causal, shift);

  // The carry: o in the accumulators' layout, m per row, and l as this
  // thread's share of the row sum (the quad adds its four at the end).
  float o[C::NO];
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < C::NO; ++i) o[i] = 0.f;
  if (a.acc_in != nullptr) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row[r] >= a.Lq) continue;
      const float* ap =
          a.acc_in + ((long long)(b * a.Lq + row[r]) * a.H + h) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const float2 x = *reinterpret_cast<const float2*>(ap + 8 * j + 2 * t);
        o[4 * j + 2 * r] = x.x;
        o[4 * j + 2 * r + 1] = x.y;
      }
      const long long moff = (long long)(b * a.H + h) * a.Lq + row[r];
      m[r] = a.m_in[moff];
      if (t == 0) l[r] = a.l_in[moff];
    }
  }

  // Online softmax of a tile: masks only where the tile straddles the
  // diagonal or the ragged end; masked scores are -1e30 (the TPU kernel's
  // value) in the max and give p = 0; p = 2^(s scale log2e - m log2e).
  const float sl2 = a.scale * sm90::LOG2E;
  auto soft = [&](float(&s)[C::NS], int kb, float(&corr)[2]) {
    const int k0 = kb * C::BK;
    if (k0 + C::BK > a.Lk || (a.causal && r0 + shift < k0 + C::BK - 1))
      sm90::mask(s, row, k0, a.Lk, a.causal, shift, t);
    float mx[2] = {-INFINITY, -INFINITY}, nl2[2];
    sm90::row_max(s, mx);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn = fmaxf(m[r], fmaxf(mx[r] * a.scale, NEG));
      corr[r] = sm90::ex2((m[r] - mn) * sm90::LOG2E);
      nl2[r] = -mn * sm90::LOG2E;
      m[r] = mn;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < C::NS; ++i) {
      s[i] = sm90::ex2(fmaf(s[i], sl2, nl2[(i >> 1) & 1]));
      l[(i >> 1) & 1] += s[i];
    }
  };
  if (nk > 0) sm90::bar_wait(ring.full_q(), 0);
  sm90::attend<T, C, true>(o, ring, wg, 0, 0, nk_wg, soft);
  sm90::skip(ring, wg, nk_wg, nk, true);

  const float lsum[2] = {quad_sum(l[0]), quad_sum(l[1])};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= a.Lq) continue;
    const long long off = ((long long)(b * a.Lq + row[r]) * a.H + h) * D;
    const long long moff = (long long)(b * a.H + h) * a.Lq + row[r];
    if (a.o != nullptr) {
      const float lc = fmaxf(lsum[r], 1e-30f);
      T* op = static_cast<T*>(a.o) + off;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(op + 8 * j + 2 * t) = Mma<T>::pack(
            o[4 * j + 2 * r] / lc, o[4 * j + 2 * r + 1] / lc);
      if (t == 0) a.lse_out[moff] = m[r] + logf(lc);
    } else {
      float* ap = a.acc_out + off;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(ap + 8 * j + 2 * t) =
            make_float2(o[4 * j + 2 * r], o[4 * j + 2 * r + 1]);
      if (t == 0) {
        a.m_out[moff] = m[r];
        a.l_out[moff] = lsum[r];
      }
    }
  }
}

template <typename T, int D>
cudaError_t fwd(const Args& a, cudaStream_t stream) {
  return sm90::launch_fwd<T, FwdCfg<D>>(flash_fwd_kernel<T, D>, a, a.q, a.k,
                                        a.v, a.B, a.H, a.Hkv, a.Lq, a.Lk,
                                        stream);
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
  if (kind == 0) return fwd<T, D>(a, stream);
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
