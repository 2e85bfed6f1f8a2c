// The attention backward bodies on the Hopper core of flash_sm90.cuh,
// shared by two sources:
//   * flash_attn.cu, the streaming form: #10 dQ and #11 dK/dV of one
//     Q x K/V block pair at any offsets, f32 outputs, dK/dV per q head
//     (the caller sums a GQA group), delta read from the caller;
//   * flash_smallseq.cu, the whole-sequence form (WHOLE): #13 as two
//     launches on one stream.  dQ runs first, forms delta = rowsum(dO O)
//     of its own q rows and writes it beside lse; dK/dV then reads lse
//     and delta through the 1-D stats map.  A dK/dV CTA owns a kv head and
//     walks the q heads of its GQA group one after another (the ring's
//     steps run on across heads), so dK and dV stay in the same f32
//     registers over the whole group.  Outputs are in the operands' 16-bit
//     type, rounded once from the f32 accumulators.  Offsets are 0 and
//     Lq == Lk.
//
// dQ is almost the forward: the CTA's Q and dO are resident, K and V
// stream; S = Q K^T and dP = dO V^T are the score products, dS = p (dP -
// delta) scale is rounded to K's type in its A fragments, and dQ += dS K
// reads K through the transposed descriptor as the forward reads V.  Each
// thread keeps its two rows' lse and delta in registers.  Registers a
// thread: S and dP BK/2 each, dQ D/2, dS's fragments BK/4 (112 at BK 64,
// D 64).
//
// dK/dV is the transposed formulation, so that everything stays in
// registers: the CTA's K and V are resident, Q and dO stream with their
// rows' lse and delta; S^T = K Q^T and dP^T = V dO^T are the score
// products, P^T and dS^T are formed in place with lse and delta taken per
// column, and dV += P^T dO, dK += dS^T Q read dO and Q through the
// transposed descriptor.  Registers a thread: S^T and dP^T BK/2 each, dK
// and dV D/2 each, two sets of fragments BK/4 each (160 at D 64 and BK
// 64, 176 at D 128 with BK 32).  A warpgroup whose first visible q tile
// comes later than its CTA's skips the earlier ring steps of each head
// (`skip`), so the ring's phases and the ping-pong turns stay in step.
//
// Only tiles that straddle the causal diagonal or a ragged end are
// masked; p = 2^(s scale log2e - lse log2e), one FFMA and one ex2, and
// exactly 0 where a pair is not visible; dS = p (dP - delta) scale; P is
// rounded to dO's type, dS to Q's (and K's).  A key past the end of a
// ragged sequence, and in dK/dV a q row past it, counts as absent: the
// TMA zero-fills those rows and the mask sets their scores to -inf before
// the exponential (a zero row is not absent: p = exp(0 - lse)).  No
// atomics: a call repeats to the last bit.

#pragma once

#include "flash_sm90.cuh"

namespace {
namespace sm90 {

// The backward kernels' arguments.  dq, dk and dv are f32 in the streaming
// form and in the operands' type T in the whole-sequence form.  delta is
// read (streaming dQ; both dK/dV forms read it through the stats map) or
// written (whole-sequence dQ, which also reads dout and o for it).
struct BwdArgs {
  const void* dout;
  const void* o;
  const float* lse;  // [B, H, Lq]
  float* delta;      // [B, H, Lq]
  void* dq;          // [B, Lq, H, D]
  void* dk;          // [B, Lk, H, D] per q head, or [B, Lk, Hkv, D]
  void* dv;
  int B, H, Hkv, Lq, Lk, q_offset, k_offset, causal;
  float scale;
};

// delta = rowsum(dO O) in f32 of q row `row` (0 past Lq), by the quad of
// threads that holds the row: thread t reads 16-byte chunks t, t + 4, ...
// of the row's dO and O, and the quad adds its four partial sums.
template <typename T, int D>
__device__ __forceinline__ float row_delta(const BwdArgs& a, int b, int h,
                                           int row, int t) {
  float acc = 0.f;
  if (row < a.Lq) {
    const long long off = ((long long)(b * a.Lq + row) * a.H + h) * D;
    const uint4* x = reinterpret_cast<const uint4*>(
        static_cast<const T*>(a.dout) + off);
    const uint4* y =
        reinterpret_cast<const uint4*>(static_cast<const T*>(a.o) + off);
#pragma unroll
    for (int c = t; c < D / 8; c += 4) {
      const uint4 u = x[c], w = y[c];
      const uint32_t us[4] = {u.x, u.y, u.z, u.w};
      const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 p = Pair<T>::unpack(us[i]), q = Pair<T>::unpack(ws[i]);
        acc = fmaf(p.x, q.x, acc);
        acc = fmaf(p.y, q.y, acc);
      }
    }
  }
  return quad_sum(acc);
}

// Writes row `row` of an output from the accumulators of this thread
// (columns 8 j + 2 t, 8 j + 2 t + 1 of acc[4 j + 2 r], acc[4 j + 2 r + 1]):
// f32 pairs, or pairs packed to T.
template <typename T, int D, bool PACK>
__device__ __forceinline__ void store_row(void* out, long long off,
                                          const float* acc, int r, int t) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const float lo = acc[4 * j + 2 * r], hi = acc[4 * j + 2 * r + 1];
    if constexpr (PACK)
      *reinterpret_cast<uint32_t*>(static_cast<T*>(out) + off + 8 * j +
                                   2 * t) = Pair<T>::pack(lo, hi);
    else
      *reinterpret_cast<float2*>(static_cast<float*>(out) + off + 8 * j +
                                 2 * t) = make_float2(lo, hi);
  }
}

// dQ of one CTA: q rows [q0, q0 + C::ROWS) of head blockIdx.y, batch
// blockIdx.z, against every K/V tile they see.  Called by a __global__
// kernel of configuration C (launch bounds C::THREADS, C::CTAS).
template <typename T, class C, bool WHOLE>
__device__ __forceinline__ void dq_body(const Params<BwdArgs>& p) {
  constexpr int D = C::D;
  extern __shared__ unsigned char sm90_smem[];
  __shared__ uint64_t bars[C::BARS];
  const BwdArgs& a = p.a;
  const Ring<C> ring(sm90_smem, bars);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * C::ROWS;  // longest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int shift = a.q_offset - a.k_offset;
  const int nk = visible_tiles<C>(q0, C::ROWS, a.Lq, a.Lk, a.causal, shift);
  ring.init();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= C::CONSUMER_WARPS) {
    producer_regs<C>();
    // Q and dO resident; K and V tiles 0 .. nk-1.
    if (threadIdx.x == 32 * C::CONSUMER_WARPS && nk > 0)
      produce(ring, p, h, q0, h / (a.H / a.Hkv), b, 0, nk, nk, 0, 0);
    return;
  }
  consumer_regs<C>();
  start_turns<C>(warp >> 2);

  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int r0 = q0 + 64 * wg;
  const int row[2] = {r0 + 16 * (warp & 3) + g, r0 + 16 * (warp & 3) + g + 8};
  const int nk_wg = visible_tiles<C>(r0, 64, a.Lq, a.Lk, a.causal, shift);
  // Each row's -lse log2e and delta (0 past Lq: those rows are not
  // written).  The whole-sequence form forms delta here, once per q row,
  // and writes it for the dK/dV launch that follows on the stream.
  float nl[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long moff = (long long)(b * a.H + h) * a.Lq + row[r];
    nl[r] = row[r] < a.Lq ? -a.lse[moff] * LOG2E : 0.f;
    if constexpr (WHOLE) {
      dl[r] = row_delta<T, D>(a, b, h, row[r], t);
      if (t == 0 && row[r] < a.Lq) a.delta[moff] = dl[r];
    } else {
      dl[r] = row[r] < a.Lq ? a.delta[moff] : 0.f;
    }
  }
  float dq[1][C::NO];
#pragma unroll
  for (int i = 0; i < C::NO; ++i) dq[0][i] = 0.f;

  // S and dP of K/V tile j into dS = p (dP - delta) scale, in place in S;
  // p = 2^(s scale log2e - lse log2e), and exactly 0 where masked.
  const float sl2 = a.scale * LOG2E;
  auto grad = [&](float(&s)[C::NS], float(&dp)[C::NS], int j, int) {
    const int k0 = j * C::BK;
    if (k0 + C::BK > a.Lk || (a.causal && r0 + shift < k0 + C::BK - 1))
      mask(s, row, k0, a.Lk, a.causal, shift, t);
#pragma unroll
    for (int i = 0; i < C::NS; ++i) {
      const int r = (i >> 1) & 1;
      const float pr = ex2(fmaf(s[i], sl2, nl[r]));
      s[i] = pr * (dp[i] - dl[r]) * a.scale;
    }
  };
  if (nk > 0) bar_wait(ring.full_own(), 0);
  backward<T, C, 1>(dq, ring, wg, 0, nk_wg, grad);
  skip(ring, wg, nk_wg, nk, true);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= a.Lq) continue;
    store_row<T, D, WHOLE>(a.dq, ((long long)(b * a.Lq + row[r]) * a.H + h) * D,
                           dq[0], r, t);
  }
}

// dK and dV of one CTA: k rows [k0, k0 + C::ROWS) of batch blockIdx.z
// against the q tiles that see them.  Streaming form: of q head
// blockIdx.y (its kv head's rows), written per q head.  Whole-sequence
// form: of kv head blockIdx.y, over each q head of its GQA group in turn,
// written once for the group.
template <typename T, class C, bool WHOLE>
__device__ __forceinline__ void dkv_body(const Params<BwdArgs>& p) {
  constexpr int D = C::D;
  extern __shared__ unsigned char sm90_smem[];
  __shared__ uint64_t bars[C::BARS];
  const BwdArgs& a = p.a;
  const Ring<C> ring(sm90_smem, bars);
  const int k0 = blockIdx.x * C::ROWS;  // earliest keys (the most q) first
  const int b = blockIdx.z;
  const int group = WHOLE ? a.H / a.Hkv : 1;  // q heads this CTA walks
  const int h0 = WHOLE ? blockIdx.y * group : blockIdx.y;  // the first
  const int kvh = WHOLE ? blockIdx.y : blockIdx.y / (a.H / a.Hkv);
  const int shift = a.q_offset - a.k_offset;
  const int nq = (a.Lq + C::BK - 1) / C::BK;
  const int iq0 = first_q_tile<C>(k0, a.causal, shift);
  const int per_head = max(nq - iq0, 0);
  const int steps = group * per_head;
  const int stats0 = (b * a.H + h0) * a.Lq;  // lse/delta of row 0, 1-D
  ring.init();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= C::CONSUMER_WARPS) {
    producer_regs<C>();
    // K and V resident; Q and dO tiles iq0 .. nq-1 of each head with
    // their lse, delta.
    if (threadIdx.x == 32 * C::CONSUMER_WARPS && steps > 0)
      produce(ring, p, kvh, k0, h0, b, iq0, per_head, steps, 0, stats0, 1,
              a.Lq);
    return;
  }
  consumer_regs<C>();
  start_turns<C>(warp >> 2);

  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int r0 = k0 + 64 * wg;
  const int key[2] = {r0 + 16 * (warp & 3) + g, r0 + 16 * (warp & 3) + g + 8};
  // This warpgroup's q tiles of each head: from its own first visible one
  // (no later than the CTA's end), none if all its keys are past Lk.
  const int skipped =
      r0 < a.Lk
          ? min(max(first_q_tile<C>(r0, a.causal, shift), iq0) - iq0,
                per_head)
          : per_head;
  float acc[2][C::NO];  // dK, dV
#pragma unroll
  for (int i = 0; i < C::NO; ++i) acc[0][i] = acc[1][i] = 0.f;

  // S^T and dP^T of Q/dO tile tile0 + j of the current head into dS^T
  // (in S^T's registers) and P^T (in dP^T's): p = 2^(s scale log2e - lse
  // log2e) per column, exactly 0 where masked; dS = p (dP - delta) scale.
  const float sl2 = a.scale * LOG2E;
  const int tile0 = iq0 + skipped;
  int hstats = stats0;  // the current head's lse/delta of row 0
  auto grad = [&](float(&s)[C::NS], float(&dp)[C::NS], int j, int slot) {
    const int q0 = (tile0 + j) * C::BK;
    if (q0 + C::BK > a.Lq || (a.causal && q0 + shift < r0 + 63))
      mask_t(s, key, q0, a.Lq, a.causal, shift, t);
    const uint32_t st = stats_of(ring, slot, hstats + q0);
#pragma unroll
    for (int i = 0; i < C::NS; ++i) {
      if (i & 2) continue;  // accumulators i and i + 2 share a column
      const uint32_t at = st + 4 * acc_col(i, t);
      const float nl = -lds(at) * LOG2E;
      const float dl = lds(at + C::STATS_STRIDE);
#pragma unroll
      for (int e = i; e <= i + 2; e += 2) {
        const float pr = ex2(fmaf(s[e], sl2, nl));
        s[e] = pr * (dp[e] - dl) * a.scale;
        dp[e] = pr;
      }
    }
  };
  if (steps > 0) bar_wait(ring.full_own(), 0);
  for (int hi = 0; hi < group; ++hi) {
    const int step0 = hi * per_head;
    hstats = stats0 + hi * a.Lq;
    skip(ring, wg, step0, step0 + skipped, true);
    backward<T, C, 2>(acc, ring, wg, step0 + skipped, per_head - skipped,
                      grad);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= a.Lk) continue;
    const long long off =
        ((long long)(b * a.Lk + key[r]) * (WHOLE ? a.Hkv : a.H) + blockIdx.y) *
        D;
    store_row<T, D, WHOLE>(a.dk, off, acc[0], r, t);
    store_row<T, D, WHOLE>(a.dv, off, acc[1], r, t);
  }
}

}  // namespace sm90
}  // namespace
