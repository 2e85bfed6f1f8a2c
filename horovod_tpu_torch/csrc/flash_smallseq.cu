// Whole-sequence ("smallseq") attention kernels for Hopper (sm_90a), plain
// C interface.
//
// Replaces the two head-batched single-block Pallas TPU kernels behind
// flash_attention_smallseq in horovod_tpu/ops/pallas_kernels.py:
//   * _smallseq_fwd_kernel -> hvdt_smallseq_fwd: o = softmax(q k^T * scale) v
//                    and lse = m + log(sum) over the whole sequence, against
//                    the row's exact final max (no online carry);
//   * _smallseq_bwd_kernel -> hvdt_smallseq_bwd: dq, dk, dv from the saved
//                    lse, with delta = rowsum(dO * O) computed inside and a
//                    GQA group's dk/dv summed inside; one launch a call.
//
// Layout: q, k, v, dO, o, dq, dk, dv are [B, L, H(or Hkv), D] contiguous in
// bf16 or fp16 (the framework's layout: no transposes); lse is [B, H, L]
// f32.  GQA reads kv head h / (H / Hkv); no K/V copy is made.
//
// What bounds them on this card.  At the LM path's shape (B 128, H 16,
// L 512, D 64, bf16, causal) the forward does 2 products of 2*D*L(L+1)/2
// FLOP per (batch, head), 6.9e10 FLOP in all (0.070 ms at 989 TFLOP/s),
// against 0.541 GB of compulsory bytes (q, k, v read, o written, lse:
// 0.161 ms at 3.35 TB/s); the backward does 5 products, 1.7e11 FLOP
// (0.174 ms), against 1.08 GB (q, k, v, dO, O and lse read, dq, dk, dv
// written: 0.322 ms).  Both are bound by bytes: about 128 FLOP a byte
// against the card's ~295.  So the design reads every operand from device
// memory about once: the CTAs of one (batch, head) are adjacent in the
// grid, so the tiles each of them streams come from L2 after the first
// reader, and scores, probabilities and dS never leave the registers.
//
// Forward design (#12), on the Hopper core of flash_sm90.cuh that it
// shares with #9.  Against its bytes bound, the kernel is held back less by
// bandwidth than by the latency of each CTA's short chain of steps (at
// L 512 a q tile sees at most 8 K tiles), so the design keeps many CTAs in
// flight:
//   * one CTA per (64-row q tile, head, batch): one consumer warpgroup and
//     one producer warp (160 threads), three CTAs an SM at D 64 and two at
//     D 128, each with a 2-slot TMA ring of 64 K/V rows; one CTA's waits
//     overlap the others' products.  The TPU kernel batches
//     heads_per_block heads in one program to save per-grid-step cost,
//     which the card does not pay; heads_per_block shapes nothing here (it
//     shapes the plain version's loop).  These tiles beat 128- and
//     192-row CTAs, BK 128 and 3 slots on the card (PERF.md);
//   * two passes over the visible K tiles: the first finds each row's exact
//     max of s = q k^T * scale (-1e30 where masked), the second forms
//     p = exp(s - max) against that final max, sums the unrounded p in f32
//     and accumulates p rounded to V's type times V (wgmma, P from
//     registers, pipelined as in #9).  An online softmax would round p
//     against a running max, at other points than the TPU kernel; the
//     second q k^T is cheap at a bytes-bound shape, and its K tiles come
//     from L2;
//   * tiles above the causal diagonal are neither loaded nor multiplied.
//     The TPU kernel multiplies and masks them; a masked p is exactly 0, so
//     skipping them changes no number; only tiles that straddle the
//     diagonal or the ragged end evaluate the mask;
//   * o = acc / sum with no clamp and lse = max + log(sum), as the TPU
//     kernel does; s * scale is rounded before the subtraction
//     (__fmul_rn), at the TPU kernel's rounding point, then
//     p = 2^(x * log2e - max * log2e) (one FFMA and one ex2).
//
// Backward design (#13): one launch, two CTA roles by blockIdx.x, no atomics
// (a run repeats to the last bit):
//   * role A, first in the grid (the longer CTAs start first): one CTA per
//     (64-row k tile, kv head, batch) walks the visible q tiles of every q
//     head of its GQA group (64 rows a step at D 64, 32 at D 128 to bound
//     registers), recomputes p^T = exp(k q^T * scale - lse) and
//     dP^T = v dO^T in registers and accumulates dV += round(p)^T dO and
//     dK += round(dS)^T q in f32 registers over the whole group, so the
//     group sum happens inside the kernel;
//   * role B: one CTA per (64-row q tile, head, batch) walks the visible k
//     tiles, dq += round(dS) k;
//   * each role computes delta = rowsum(dO * O) in f32 for the q rows it
//     stages, from the O the forward wrote;
//   * dq, dk and dv are written in the input type straight from the f32
//     accumulators.  The TPU kernel writes f32 and casts outside; both round
//     the same f32 value once, and writing 16 bits saves 0.4 GB of traffic
//     at the path's shape.
//
// Any L >= 1 works: rows past the end are zero-filled when staged (by the
// TMA in the forward), a key past the end counts as absent (p = 0) and
// rows past the end are not written.  Requirements checked by the Python wrapper: D in {64, 128},
// bf16 or fp16 operands of one type, contiguous, 16-byte aligned.  Each
// entry returns cudaGetLastError() after its launch.

#include <limits.h>
#include <math.h>

#include "flash_common.cuh"
#include "flash_sm90.cuh"

namespace {

constexpr int BQ = 64;         // q rows per CTA (role B)
constexpr int BK = 64;         // k rows per step (role B) / CTA (role A)
constexpr float NEG = -1e30f;  // the TPU kernels' mask value

template <int D>
struct BwdTile {
  static constexpr int BQ2 = D == 64 ? 64 : 32;  // q rows per role-A step
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;  // backward: dO
  void* o;           // forward: written; backward: the forward's output
  float* lse;        // forward: written; backward: read
  void* dq;
  void* dk;
  void* dv;
  int B, H, Hkv, L, causal;
  float scale;
};

__device__ __forceinline__ bool visible(const Args& a, int qrow, int krow) {
  return qrow < a.L && krow < a.L && (!a.causal || qrow >= krow);
}

// Number of K tiles a q tile [q0, q0 + BQ) can see.
__device__ __forceinline__ int k_tiles(const Args& a, int q0) {
  const int nk = (a.L + BK - 1) / BK;
  return a.causal ? min(nk, (min(q0 + BQ, a.L) - 1) / BK + 1) : nk;
}

// delta[r] = sum_d dO[r][d] * O[r][d] in f32 for the ROWS rows of two
// staged tiles; NTHREADS / ROWS neighbouring threads share a row.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void row_delta(float* sD, const T* sdO,
                                          const T* sO) {
  constexpr int LDS = D + 8;
  constexpr int TPR = NTHREADS / ROWS;
  constexpr int PER = D / TPR;
  const int r = threadIdx.x / TPR, part = threadIdx.x % TPR;
  const T* x = sdO + r * LDS + part * PER;
  const T* y = sO + r * LDS + part * PER;
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < PER; i += 2) {
    const float2 u = Mma<T>::unpack(ld32(x + i));
    const float2 w = Mma<T>::unpack(ld32(y + i));
    acc += __fmul_rn(u.x, w.x);
    acc += __fmul_rn(u.y, w.y);
  }
#pragma unroll
  for (int off = 1; off < TPR; off <<= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (part == 0) sD[r] = acc;
}

// ---- #12: forward, on the Hopper core (flash_sm90.cuh) --------------------

// The tiles: 64 q rows a CTA (one consumer warpgroup), 64 K/V rows a
// step, two ring slots, three CTAs an SM at D 64 and two at D 128.
template <int D>
using FwdCfg = sm90::Cfg<D, 64, 2, 1, D == 64 ? 3 : 2>;

template <typename T, int D>
__global__ void __launch_bounds__(FwdCfg<D>::THREADS, FwdCfg<D>::CTAS)
    smallseq_fwd_kernel(const __grid_constant__ sm90::Params<Args> p) {
  using C = FwdCfg<D>;
  extern __shared__ unsigned char sm90_smem[];
  __shared__ uint64_t bars[C::BARS];
  const Args& a = p.a;
  const sm90::Ring<C> ring(sm90_smem, bars);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * C::ROWS;  // longest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int nk = sm90::visible_tiles<C>(q0, C::ROWS, a.L, a.L, a.causal, 0);
  ring.init();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= C::CONSUMER_WARPS) {
    sm90::producer_regs<C>();
    // Steps 0 .. nk-1 bring K for the max, nk .. 2nk-1 K and V again.
    if (threadIdx.x == 32 * C::CONSUMER_WARPS && nk > 0)
      sm90::produce(ring, p, h, q0, h / (a.H / a.Hkv), b, 0, nk, 2 * nk, nk,
                    0);
    return;
  }
  sm90::consumer_regs<C>();
  sm90::start_turns<C>(warp >> 2);

  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int r0 = q0 + 64 * wg;
  const int row[2] = {r0 + 16 * (warp & 3) + g, r0 + 16 * (warp & 3) + g + 8};
  const int nk_wg = sm90::visible_tiles<C>(r0, 64, a.L, a.L, a.causal, 0);

  float o[C::NO];
#pragma unroll
  for (int i = 0; i < C::NO; ++i) o[i] = 0.f;
  float mx[2] = {-INFINITY, -INFINITY}, nl2[2], sum[2] = {0.f, 0.f};
  auto masked = [&](float(&s)[C::NS], int kb) {
    const int k0 = kb * C::BK;
    if (k0 + C::BK > a.L || (a.causal && r0 < k0 + C::BK - 1))
      sm90::mask(s, row, k0, a.L, a.causal, 0, t);
  };
  if (nk > 0) sm90::bar_wait(ring.full_own(), 0);

  // First pass, steps 0 .. nk-1: each row's max of the raw scores.
  for (int it = 0; it < nk_wg; ++it) {
    const int slot = sm90::slot_of<C>(it);
    float s[C::NS];
    sm90::bar_wait(ring.full_first(slot), sm90::parity_of<C>(it));
    sm90::fence_regs(s);
    sm90::wgmma_fence();
    sm90::qk_issue<T, C>(s, ring, slot, wg);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s);
    sm90::release(ring, slot);
    masked(s, it);
    sm90::row_max(s, mx);
  }
  sm90::skip(ring, wg, nk_wg, nk, false);

  // The exact final max of s * scale, rounded as the TPU kernel rounds it
  // (rounding is monotonic, so the max of the rounded scores is the
  // rounded max); -1e30 where a row sees nothing.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(__fmul_rn(mx[r], a.scale), NEG);
    nl2[r] = -mx[r] * sm90::LOG2E;
  }

  // Second pass, steps nk .. 2nk-1: p = exp(s * scale - max) against the
  // final max, its f32 sum, and P V with P rounded to V's type.
  auto soft = [&](float(&s)[C::NS], int kb, float(&)[2]) {
    masked(s, kb);
#pragma unroll
    for (int i = 0; i < C::NS; ++i) {
      s[i] = sm90::ex2(
          fmaf(__fmul_rn(s[i], a.scale), sm90::LOG2E, nl2[(i >> 1) & 1]));
      sum[(i >> 1) & 1] += s[i];
    }
  };
  sm90::attend<T, C, false>(o, ring, wg, nk, 0, nk_wg, soft);
  sm90::skip(ring, wg, nk + nk_wg, 2 * nk, true);

  const float l[2] = {quad_sum(sum[0]), quad_sum(sum[1])};
  const long long bl = (long long)b * a.L;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= a.L) continue;
    T* op = static_cast<T*>(a.o) + ((bl + row[r]) * a.H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(op + 8 * j + 2 * t) = Mma<T>::pack(
          o[4 * j + 2 * r] / l[r], o[4 * j + 2 * r + 1] / l[r]);
    if (t == 0)
      a.lse[(long long)(b * a.H + h) * a.L + row[r]] = mx[r] + logf(l[r]);
  }
}

template <typename T, int D>
cudaError_t fwd(const Args& a, cudaStream_t stream) {
  return sm90::launch<T, FwdCfg<D>>(
      smallseq_fwd_kernel<T, D>, a, a.B, a.H, {a.q, a.H, a.L}, {},
      {a.k, a.Hkv, a.L}, {a.v, a.Hkv, a.L}, {}, stream);
}

// ---- #13, role A: dK and dV of one k tile over a GQA group ---------------

template <typename T, int D>
__device__ __forceinline__ void bwd_dkv(const Args& a, int k0, int hk, int b,
                                        unsigned char* smem) {
  constexpr int LDS = D + 8;
  constexpr int BQ2 = BwdTile<D>::BQ2;
  constexpr int NS = BQ2 / 8;
  constexpr int NO = D / 8;
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + BK * LDS;
  T* sQ = sV + BK * LDS;         // two stages
  T* sdO = sQ + 2 * BQ2 * LDS;   // two stages
  T* sO = sdO + 2 * BQ2 * LDS;   // two stages
  float* sL = reinterpret_cast<float*>(sO + 2 * BQ2 * LDS);  // lse, 2 stages
  float* sD = sL + 2 * BQ2;                                  // delta

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int group = a.H / a.Hkv;
  const long long qs = (long long)a.H * D, ks = (long long)a.Hkv * D;
  const long long bl = (long long)b * a.L;
  const T* kp = static_cast<const T*>(a.k) + bl * ks + hk * D;
  const T* vp = static_cast<const T*>(a.v) + bl * ks + hk * D;
  const int nq = (a.L + BQ2 - 1) / BQ2;
  int iq0 = 0;
  if (a.causal) {  // first q tile whose last row reaches this k tile
    const int need = k0 - (BQ2 - 1);
    iq0 = need <= 0 ? 0 : (need + BQ2 - 1) / BQ2;
  }
  const int per_head = nq - iq0;   // >= 1: k0 < L
  const int steps = group * per_head;
  const int krow[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};

  // Step n visits q tile iq0 + n % per_head of q head hk * group + n /
  // per_head: the q, dO and O tiles and the lse of its rows into stage st.
  auto stage = [&](int n, int st) {
    const int h = hk * group + n / per_head;
    const int r0 = (iq0 + n % per_head) * BQ2;
    const long long off = bl * qs + h * D;
    load_tile<T, D, BQ2>(sQ + st * BQ2 * LDS, static_cast<const T*>(a.q) + off,
                         qs, r0, a.L);
    load_tile<T, D, BQ2>(sdO + st * BQ2 * LDS,
                         static_cast<const T*>(a.dout) + off, qs, r0, a.L);
    load_tile<T, D, BQ2>(sO + st * BQ2 * LDS,
                         static_cast<const T*>(a.o) + off, qs, r0, a.L);
    if (threadIdx.x < BQ2) {
      const int r = r0 + threadIdx.x;
      sL[st * BQ2 + threadIdx.x] =
          r < a.L ? a.lse[(long long)(b * a.H + h) * a.L + r] : 0.f;
    }
  };

  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  load_tile<T, D, BK>(sK, kp, ks, k0, a.L);
  load_tile<T, D, BK>(sV, vp, ks, k0, a.L);
  stage(0, 0);
  cp_async_commit();

  for (int n = 0; n < steps; ++n) {
    const int st = n & 1;
    if (n + 1 < steps) stage(n + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* cQ = sQ + st * BQ2 * LDS;
    const T* cdO = sdO + st * BQ2 * LDS;
    const float* cL = sL + st * BQ2;
    const float* cD = sD + st * BQ2;
    row_delta<T, D, BQ2>(sD + st * BQ2, cdO, sO + st * BQ2 * LDS);
    __syncthreads();

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
        frag_b_rows<T, LDS>(fb, cdO, j * 8, kk * 16, g, t);
        Mma<T>::run(pd[j], fv, fb);
      }
    }
    // P^T and dS^T = P^T * (dP^T - delta) * scale.
    const int q0 = (iq0 + n % per_head) * BQ2;
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1);
        const float p =
            visible(a, q0 + c, krow[e >> 1])
                ? expf(__fmul_rn(s[j][e], a.scale) - cL[c])
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
        frag_b_cols<T, LDS>(fb, cdO, kk * 16, j * 8, g, t);
        Mma<T>::run(dv[j], fp, fb);
        frag_b_cols<T, LDS>(fb, cQ, kk * 16, j * 8, g, t);
        Mma<T>::run(dk[j], fs, fb);
      }
    }
    __syncthreads();  // the next step refills this stage
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (krow[r] >= a.L) continue;
    const long long off = ((bl + krow[r]) * a.Hkv + hk) * D;
    T* dkp = static_cast<T*>(a.dk) + off;
    T* dvp = static_cast<T*>(a.dv) + off;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      *reinterpret_cast<uint32_t*>(dkp + 8 * j + 2 * t) =
          Mma<T>::pack(dk[j][2 * r], dk[j][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dvp + 8 * j + 2 * t) =
          Mma<T>::pack(dv[j][2 * r], dv[j][2 * r + 1]);
    }
  }
}

// ---- #13, role B: dQ of one q tile -----------------------------------------

template <typename T, int D>
__device__ __forceinline__ void bwd_dq(const Args& a, int q0, int h, int b,
                                       unsigned char* smem) {
  constexpr int LDS = D + 8;
  constexpr int NS = BK / 8;
  constexpr int NO = D / 8;
  T* sQ = reinterpret_cast<T*>(smem);
  T* sdO = sQ + BQ * LDS;
  T* sO = sdO + BQ * LDS;
  T* sK = sO + BQ * LDS;      // two stages
  T* sV = sK + 2 * BK * LDS;  // two stages
  float* sD = reinterpret_cast<float*>(sV + 2 * BK * LDS);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int hk = h / (a.H / a.Hkv);
  const long long qs = (long long)a.H * D, ks = (long long)a.Hkv * D;
  const long long bl = (long long)b * a.L;
  const long long qoff = bl * qs + h * D;
  const T* kp = static_cast<const T*>(a.k) + bl * ks + hk * D;
  const T* vp = static_cast<const T*>(a.v) + bl * ks + hk * D;
  const int nk = k_tiles(a, q0);
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float lse[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    lse[r] = row[r] < a.L ? a.lse[(long long)(b * a.H + h) * a.L + row[r]]
                          : 0.f;

  load_tile<T, D, BQ>(sQ, static_cast<const T*>(a.q) + qoff, qs, q0, a.L);
  load_tile<T, D, BQ>(sdO, static_cast<const T*>(a.dout) + qoff, qs, q0, a.L);
  load_tile<T, D, BQ>(sO, static_cast<const T*>(a.o) + qoff, qs, q0, a.L);
  cp_async_commit();
  if (nk > 0) {
    load_tile<T, D, BK>(sK, kp, ks, 0, a.L);
    load_tile<T, D, BK>(sV, vp, ks, 0, a.L);
  }
  cp_async_commit();
  cp_async_wait<1>();  // q, dO and O have landed
  __syncthreads();
  row_delta<T, D, BQ>(sD, sdO, sO);
  __syncthreads();
  const float dl[2] = {sD[warp * 16 + g], sD[warp * 16 + g + 8]};

  float dq[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;

  for (int kb = 0; kb < nk; ++kb) {
    const int st = kb & 1;
    if (kb + 1 < nk) {
      load_tile<T, D, BK>(sK + (st ^ 1) * BK * LDS, kp, ks, (kb + 1) * BK, a.L);
      load_tile<T, D, BK>(sV + (st ^ 1) * BK * LDS, vp, ks, (kb + 1) * BK, a.L);
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
      frag_a<T, LDS>(fo, sdO, warp * 16, kk * 16, g, t);
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
        const float p = visible(a, row[r], col)
                            ? expf(__fmul_rn(s[j][e], a.scale) - lse[r])
                            : 0.f;
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
    if (row[r] >= a.L) continue;
    T* out = static_cast<T*>(a.dq) + ((bl + row[r]) * a.H + h) * D;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      *reinterpret_cast<uint32_t*>(out + 8 * j + 2 * t) =
          Mma<T>::pack(dq[j][2 * r], dq[j][2 * r + 1]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS) smallseq_bwd_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nkt = (a.L + BK - 1) / BK;
  const int n_a = nkt * a.Hkv * a.B;
  int idx = blockIdx.x;
  if (idx < n_a) {  // role A: (k tile, kv head, batch), earliest k first
    const int tile = idx % nkt;
    idx /= nkt;
    bwd_dkv<T, D>(a, tile * BK, idx % a.Hkv, idx / a.Hkv, smem);
  } else {          // role B: (q tile, head, batch), latest q first
    idx -= n_a;
    const int nqt = (a.L + BQ - 1) / BQ;
    const int tile = nqt - 1 - idx % nqt;
    idx /= nqt;
    bwd_dq<T, D>(a, tile * BQ, idx % a.H, idx / a.H, smem);
  }
}

template <typename T, int D>
constexpr size_t bwd_smem() {
  constexpr int BQ2 = BwdTile<D>::BQ2;
  constexpr size_t dkv =
      (size_t)(2 * BK + 6 * BQ2) * (D + 8) * sizeof(T) + 4 * BQ2 * sizeof(float);
  constexpr size_t dq =
      (size_t)(3 * BQ + 4 * BK) * (D + 8) * sizeof(T) + BQ * sizeof(float);
  return dkv > dq ? dkv : dq;
}

template <typename T, int D>
cudaError_t dispatch(int bwd, const Args& a, cudaStream_t stream) {
  if (!bwd) return fwd<T, D>(a, stream);
  const long long ctas = (long long)((a.L + BK - 1) / BK) * a.Hkv * a.B +
                         (long long)((a.L + BQ - 1) / BQ) * a.H * a.B;
  if (ctas > INT_MAX) return cudaErrorInvalidValue;
  return launch(smallseq_bwd_kernel<T, D>, bwd_smem<T, D>(),
                dim3((unsigned)ctas), a, stream);
}

int run(int bwd, const Args& a, int D, int fp16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (D != 64 && D != 128) return (int)cudaErrorInvalidValue;
  if (a.H <= 0 || a.Hkv <= 0 || a.H % a.Hkv || a.L < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (fp16)
    err = D == 64 ? dispatch<__half, 64>(bwd, a, s)
                  : dispatch<__half, 128>(bwd, a, s);
  else
    err = D == 64 ? dispatch<bf16, 64>(bwd, a, s)
                  : dispatch<bf16, 128>(bwd, a, s);
  return (int)err;
}

Args make_args(const void* q, const void* k, const void* v, int B, int H,
               int Hkv, int L, int causal, float scale) {
  Args a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.B = B;
  a.H = H;
  a.Hkv = Hkv;
  a.L = L;
  a.causal = causal;
  a.scale = scale;
  return a;
}

}  // namespace

extern "C" {

// Forward: o [B, L, H, D] in q's type and lse [B, H, L] f32.
int hvdt_smallseq_fwd(const void* q, const void* k, const void* v, void* o,
                      void* lse, int B, int H, int Hkv, int L, int D,
                      int fp16, int causal, float scale, void* stream) {
  Args a = make_args(q, k, v, B, H, Hkv, L, causal, scale);
  a.o = o;
  a.lse = (float*)lse;
  return run(0, a, D, fp16, stream);
}

// Backward: dq [B, L, H, D], dk and dv [B, L, Hkv, D] (group-summed), all
// in q's type, from dO, the forward's o and lse.
int hvdt_smallseq_bwd(const void* q, const void* k, const void* v,
                      const void* dout, const void* o, const void* lse,
                      void* dq, void* dk, void* dv, int B, int H, int Hkv,
                      int L, int D, int fp16, int causal, float scale,
                      void* stream) {
  Args a = make_args(q, k, v, B, H, Hkv, L, causal, scale);
  a.dout = dout;
  a.o = const_cast<void*>(o);
  a.lse = (float*)lse;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  return run(1, a, D, fp16, stream);
}

}  // extern "C"
