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
// L 4096, D 64, causal) one product over the visible (q, k) pairs is
// 2 * B*H*D * L(L+1)/2 = 2.75e11 FLOP: the forward does two (0.56 ms of
// bf16 tensor work at 989 TFLOP/s), dQ three (0.83 ms) and dK/dV four
// (1.11 ms), against 0.08-0.33 ms of compulsory bytes at 3.35 TB/s, so all
// three are bound by operations.  Every score tile stays on chip: it lives
// in the registers of the tensor-core accumulators, is turned into P or dS
// there and fed straight back as the A operand of the next product, so
// device memory sees only the operands once per CTA and the outputs once.
// Causal tiles above the diagonal are never loaded or multiplied (the loop
// ends at the last visible tile, as the TPU kernels' pl.when pruning does).
//
// All three run on the Hopper core of flash_sm90.cuh (#12 shares it).
// Against the operations bound:
//   * products are wgmma, the only way to the tensor cores' full rate:
//     scores from 128-byte-swizzled shared memory, both operands K-major;
//     accumulations with the score tile from registers and the streamed
//     tile through the transposed descriptor;
//   * a CTA owns several warpgroups of 64 rows, so each tile pulled
//     through L2 feeds them all (at 64 rows a CTA the three kernels each
//     moved 8.7 GB through L2 a call): #9 192 q rows, #10 192 q rows at
//     D 64 (128 at D 128), #11 128 k rows.  A producer warpgroup keeps TMA
//     loads of the streamed tiles in a 3-slot ring and gives its registers
//     to the consumers (setmaxnreg);
//   * inside a warpgroup, tile j+1's score products are issued beside
//     tile j's accumulations, before tile j+1's elementwise pass, which
//     runs while the tensor cores work; the warpgroups take turns to issue
//     (ping-pong), so one's elementwise pass overlaps the others' products;
//   * only tiles that straddle the causal diagonal or a ragged end are
//     masked; p = 2^(s * scale * log2e - lse * log2e) (or - m * log2e in
//     the forward), one FFMA and one ex2;
//   * the tiles (FwdCfg, DqCfg, DkvCfg below) were chosen by timing other
//     tiles on the card (PERF.md).
//
// #10 (dQ) is almost the forward: the CTA's Q and dO are resident, K and V
// stream; S = Q K^T and dP = dO V^T are the score products, dS = p (dP -
// delta) scale is rounded to K's type in its A fragments, and dQ += dS K
// reads K through the transposed descriptor as the forward reads V.  Each
// thread keeps its two rows' lse and delta in registers.  Registers a
// thread: S and dP BK/2 each, dQ D/2, dS's fragments BK/4: 112 at BK 64,
// D 64, inside the 160 of three consumer warpgroups.
//
// #11 (dK/dV) is the transposed formulation, so that everything stays in
// registers: the CTA's K and V are resident, Q and dO stream with their
// rows' lse and delta; S^T = K Q^T and dP^T = V dO^T are the score
// products, P^T and dS^T are formed in place with lse and delta taken per
// column, and dV += P^T dO, dK += dS^T Q read dO and Q through the
// transposed descriptor.  lse and delta reach shared memory through the
// TMA as one 1-D run (see flash_sm90.cuh), so any Lq works.  Registers a
// thread: S^T and dP^T BK/2 each, dK and dV D/2 each, two sets of
// fragments BK/4 each: 160 at D 64 and BK 64, and 176 at D 128 with BK
// 32 (224 at BK 64), against the 240 of two consumer warpgroups.  A warpgroup whose first visible q tile comes
// later than its CTA's skips the earlier ring steps (`skip`), so the
// ring's phases and the ping-pong turns stay in step.
//
// Numerics follow the TPU kernels: masked scores are -1e30 (not -inf) in
// the forward, p = exp(s - m_new) is zeroed where masked, P is rounded to
// V's type before PV, l is the f32 sum of the unrounded p and is clamped
// at 1e-30 before o = acc / l; in the backward p = exp(s * scale - lse)
// and exactly 0 where a pair is not visible, dS = p (dP - delta) scale,
// dq rounds dS to K's type, dkv rounds P to dO's and dS to Q's type.  A
// key past the end of a ragged sequence, and in dK/dV a q row past it,
// counts as absent: the TMA zero-fills those rows and the mask sets their
// scores to -inf before the exponential (a zero row is not absent:
// p = exp(0 - lse)), so a row that sees no key (lse near -1e30) never
// overflows into a product.  In the forward a q row that sees no key
// passes its carry (acc, m, l) through bit for bit.
//
// Requirements checked by the Python wrapper: D in {64, 128}, bf16 or fp16
// operands of one type, contiguous, 16-byte aligned (lse and delta too).
// Each entry returns cudaGetLastError() after its launch, or an error if a
// tensor map cannot be built.

#include <math.h>

#include "flash_sm90.cuh"

namespace {

constexpr float NEG = -1e30f;  // the TPU kernels' mask value

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;     // backward: dO
  const float* lse;     // backward (dkv reads lse and delta by TMA maps)
  const float* delta;
  const float* acc_in;  // forward carry in (null: zeros / -1e30 / zeros)
  const float* m_in;
  const float* l_in;
  float* acc_out;       // forward carry out (when o is null)
  float* m_out;
  float* l_out;
  void* o;              // forward: finished output (null: carry mode)
  float* lse_out;
  float* dq;            // backward outputs, f32, dk/dv per q head
  float* dk;
  float* dv;
  int B, H, Hkv, Lq, Lk, q_offset, k_offset, causal;
  float scale;
};

// ---- #9: forward, on the Hopper core (flash_sm90.cuh) ---------------------

// The tiles: 192 q rows a CTA (three consumer warpgroups, ping-pong), 128
// K/V rows a step at D 64 and 64 at D 128, three ring slots, one CTA an SM.
template <int D>
using FwdCfg = sm90::Cfg<D, D == 64 ? 128 : 64, 3, 3, 1>;

template <typename T, int D>
__global__ void __launch_bounds__(FwdCfg<D>::THREADS, FwdCfg<D>::CTAS)
    flash_fwd_kernel(const __grid_constant__ sm90::Params<Args> p) {
  using C = FwdCfg<D>;
  extern __shared__ unsigned char sm90_smem[];
  __shared__ uint64_t bars[C::BARS];
  const Args& a = p.a;
  const sm90::Ring<C> ring(sm90_smem, bars);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * C::ROWS;  // longest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int shift = a.q_offset - a.k_offset;
  const int nk =
      sm90::visible_tiles<C>(q0, C::ROWS, a.Lq, a.Lk, a.causal, shift);
  ring.init();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= C::CONSUMER_WARPS) {
    sm90::producer_regs<C>();
    if (threadIdx.x == 32 * C::CONSUMER_WARPS && nk > 0)
      sm90::produce(ring, p, h, q0, h / (a.H / a.Hkv), b, 0, nk, nk, 0, 0);
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
  if (nk > 0) sm90::bar_wait(ring.full_own(), 0);
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
  return sm90::launch<T, FwdCfg<D>>(
      flash_fwd_kernel<T, D>, a, a.B, a.H, {a.q, a.H, a.Lq}, {}, {a.k, a.Hkv, a.Lk},
      {a.v, a.Hkv, a.Lk}, {}, stream);
}

// ---- #10: dQ, on the Hopper core ------------------------------------------

// The tiles: 192 q rows a CTA at D 64 (three consumer warpgroups) and 128
// at D 128 (two), 64 K/V rows a step, three ring slots, one CTA an SM.
template <int D>
using DqCfg = sm90::Cfg<D, 64, 3, D == 64 ? 3 : 2, 1, 2>;

template <typename T, int D>
__global__ void __launch_bounds__(DqCfg<D>::THREADS, DqCfg<D>::CTAS)
    flash_dq_kernel(const __grid_constant__ sm90::Params<Args> p) {
  using C = DqCfg<D>;
  extern __shared__ unsigned char sm90_smem[];
  __shared__ uint64_t bars[C::BARS];
  const Args& a = p.a;
  const sm90::Ring<C> ring(sm90_smem, bars);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * C::ROWS;  // longest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int shift = a.q_offset - a.k_offset;
  const int nk =
      sm90::visible_tiles<C>(q0, C::ROWS, a.Lq, a.Lk, a.causal, shift);
  ring.init();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= C::CONSUMER_WARPS) {
    sm90::producer_regs<C>();
    // Q and dO resident; K and V tiles 0 .. nk-1.
    if (threadIdx.x == 32 * C::CONSUMER_WARPS && nk > 0)
      sm90::produce(ring, p, h, q0, h / (a.H / a.Hkv), b, 0, nk, nk, 0, 0);
    return;
  }
  sm90::consumer_regs<C>();
  sm90::start_turns<C>(warp >> 2);

  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int r0 = q0 + 64 * wg;
  const int row[2] = {r0 + 16 * (warp & 3) + g, r0 + 16 * (warp & 3) + g + 8};
  const int nk_wg =
      sm90::visible_tiles<C>(r0, 64, a.Lq, a.Lk, a.causal, shift);
  // Each row's -lse log2e and delta (0 past Lq: those rows are not written).
  float nl[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long moff = (long long)(b * a.H + h) * a.Lq + row[r];
    nl[r] = row[r] < a.Lq ? -a.lse[moff] * sm90::LOG2E : 0.f;
    dl[r] = row[r] < a.Lq ? a.delta[moff] : 0.f;
  }
  float dq[1][C::NO];
#pragma unroll
  for (int i = 0; i < C::NO; ++i) dq[0][i] = 0.f;

  // S and dP of K/V tile j into dS = p (dP - delta) scale, in place in S;
  // p = 2^(s scale log2e - lse log2e), and exactly 0 where masked.
  const float sl2 = a.scale * sm90::LOG2E;
  auto grad = [&](float(&s)[C::NS], float(&dp)[C::NS], int j, int) {
    const int k0 = j * C::BK;
    if (k0 + C::BK > a.Lk || (a.causal && r0 + shift < k0 + C::BK - 1))
      sm90::mask(s, row, k0, a.Lk, a.causal, shift, t);
#pragma unroll
    for (int i = 0; i < C::NS; ++i) {
      const int r = (i >> 1) & 1;
      const float pr = sm90::ex2(fmaf(s[i], sl2, nl[r]));
      s[i] = pr * (dp[i] - dl[r]) * a.scale;
    }
  };
  if (nk > 0) sm90::bar_wait(ring.full_own(), 0);
  sm90::backward<T, C, 1>(dq, ring, wg, 0, nk_wg, grad);
  sm90::skip(ring, wg, nk_wg, nk, true);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= a.Lq) continue;
    float* out = a.dq + ((long long)(b * a.Lq + row[r]) * a.H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(out + 8 * j + 2 * t) =
          make_float2(dq[0][4 * j + 2 * r], dq[0][4 * j + 2 * r + 1]);
  }
}

template <typename T, int D>
cudaError_t dq(const Args& a, cudaStream_t stream) {
  return sm90::launch<T, DqCfg<D>>(
      flash_dq_kernel<T, D>, a, a.B, a.H, {a.q, a.H, a.Lq},
      {a.dout, a.H, a.Lq}, {a.k, a.Hkv, a.Lk}, {a.v, a.Hkv, a.Lk}, {},
      stream);
}

// ---- #11: dK, dV, on the Hopper core --------------------------------------

// The tiles: 128 k rows a CTA (two consumer warpgroups), 64 Q/dO rows a
// step at D 64 and 32 at D 128 (at 64 the scores, dK, dV and both sets of
// fragments would need 224 of the 240 registers a thread, and ptxas spills
// and serializes the wgmma), three ring slots, one CTA an SM.
template <int D>
using DkvCfg = sm90::Cfg<D, D == 64 ? 64 : 32, 3, 2, 1, 2, true>;

template <typename T, int D>
__global__ void __launch_bounds__(DkvCfg<D>::THREADS, DkvCfg<D>::CTAS)
    flash_dkv_kernel(const __grid_constant__ sm90::Params<Args> p) {
  using C = DkvCfg<D>;
  extern __shared__ unsigned char sm90_smem[];
  __shared__ uint64_t bars[C::BARS];
  const Args& a = p.a;
  const sm90::Ring<C> ring(sm90_smem, bars);
  const int k0 = blockIdx.x * C::ROWS;  // earliest keys (the most q) first
  const int h = blockIdx.y, b = blockIdx.z;
  const int shift = a.q_offset - a.k_offset;
  const int nq = (a.Lq + C::BK - 1) / C::BK;
  const int iq0 = sm90::first_q_tile<C>(k0, a.causal, shift);
  const int steps = max(nq - iq0, 0);
  const int stats0 = (b * a.H + h) * a.Lq;  // lse/delta of row 0, 1-D
  ring.init();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= C::CONSUMER_WARPS) {
    sm90::producer_regs<C>();
    // K and V resident; Q and dO tiles iq0 .. nq-1 with their lse, delta.
    if (threadIdx.x == 32 * C::CONSUMER_WARPS && steps > 0)
      sm90::produce(ring, p, h / (a.H / a.Hkv), k0, h, b, iq0, steps, steps,
                    0, stats0);
    return;
  }
  sm90::consumer_regs<C>();
  sm90::start_turns<C>(warp >> 2);

  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int r0 = k0 + 64 * wg;
  const int key[2] = {r0 + 16 * (warp & 3) + g, r0 + 16 * (warp & 3) + g + 8};
  // This warpgroup's q tiles: from its own first visible one (no later
  // than the CTA's end), none if all its keys are past Lk.
  const int skipped =
      r0 < a.Lk
          ? min(max(sm90::first_q_tile<C>(r0, a.causal, shift), iq0) - iq0,
                steps)
          : steps;
  float acc[2][C::NO];  // dK, dV
#pragma unroll
  for (int i = 0; i < C::NO; ++i) acc[0][i] = acc[1][i] = 0.f;

  // S^T and dP^T of Q/dO tile iq0 + skipped + j into dS^T (in S^T's
  // registers) and P^T (in dP^T's): p = 2^(s scale log2e - lse log2e) per
  // column, exactly 0 where masked; dS = p (dP - delta) scale.
  const float sl2 = a.scale * sm90::LOG2E;
  auto grad = [&](float(&s)[C::NS], float(&dp)[C::NS], int j, int slot) {
    const int q0 = (iq0 + skipped + j) * C::BK;
    if (q0 + C::BK > a.Lq || (a.causal && q0 + shift < r0 + 63))
      sm90::mask_t(s, key, q0, a.Lq, a.causal, shift, t);
    const uint32_t st = sm90::stats_of(ring, slot, stats0 + q0);
#pragma unroll
    for (int i = 0; i < C::NS; ++i) {
      if (i & 2) continue;  // accumulators i and i + 2 share a column
      const uint32_t at = st + 4 * sm90::acc_col(i, t);
      const float nl = -sm90::lds(at) * sm90::LOG2E;
      const float dl = sm90::lds(at + C::STATS_STRIDE);
#pragma unroll
      for (int j = i; j <= i + 2; j += 2) {
        const float pr = sm90::ex2(fmaf(s[j], sl2, nl));
        s[j] = pr * (dp[j] - dl) * a.scale;
        dp[j] = pr;
      }
    }
  };
  if (steps > 0) sm90::bar_wait(ring.full_own(), 0);
  sm90::skip(ring, wg, 0, skipped, true);
  sm90::backward<T, C, 2>(acc, ring, wg, skipped, steps - skipped, grad);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= a.Lk) continue;
    const long long off = ((long long)(b * a.Lk + key[r]) * a.H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<float2*>(a.dk + off + 8 * j + 2 * t) =
          make_float2(acc[0][4 * j + 2 * r], acc[0][4 * j + 2 * r + 1]);
      *reinterpret_cast<float2*>(a.dv + off + 8 * j + 2 * t) =
          make_float2(acc[1][4 * j + 2 * r], acc[1][4 * j + 2 * r + 1]);
    }
  }
}

template <typename T, int D>
cudaError_t dkv(const Args& a, cudaStream_t stream) {
  return sm90::launch<T, DkvCfg<D>>(
      flash_dkv_kernel<T, D>, a, a.B, a.H, {a.k, a.Hkv, a.Lk},
      {a.v, a.Hkv, a.Lk}, {a.q, a.H, a.Lq}, {a.dout, a.H, a.Lq},
      {a.lse, a.delta, (long long)a.B * a.H * a.Lq}, stream);
}

// kind: 0 forward, 1 dq, 2 dkv.
template <typename T, int D>
cudaError_t dispatch(int kind, const Args& a, cudaStream_t stream) {
  if (kind == 0) return fwd<T, D>(a, stream);
  if (kind == 1) return dq<T, D>(a, stream);
  return dkv<T, D>(a, stream);
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
  a.dq = (float*)dq;
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
  a.dk = (float*)dk;
  a.dv = (float*)dv;
  return run(2, a, D, fp16, stream);
}

}  // extern "C"
