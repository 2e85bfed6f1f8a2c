// Whole-sequence ("smallseq") attention kernels for Hopper (sm_90a), plain
// C interface.
//
// Replaces the two head-batched single-block Pallas TPU kernels behind
// flash_attention_smallseq in horovod_tpu/ops/pallas_kernels.py:
//   * _smallseq_fwd_kernel -> hvdt_smallseq_fwd: o = softmax(q k^T * scale) v
//                    and lse = m + log(sum) over the whole sequence, against
//                    the row's exact final max (no online carry);
//   * _smallseq_bwd_kernel -> hvdt_smallseq_bwd: dq, dk, dv from the saved
//                    lse, with delta = rowsum(dO * O) computed once per q
//                    row and a GQA group's dk/dv summed inside; two
//                    launches a call (dQ, then dK/dV).
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
// Backward design (#13): the whole-sequence form of the backward bodies
// that #10 and #11 run (flash_bwd_sm90.cuh), not a backward of its own.
// Two launches on the caller's stream, no atomics (a call repeats to the
// last bit):
//   * dQ: one CTA per (64-row q tile, head, batch), Q and dO resident, the
//     visible K/V tiles streamed 32 rows a step; its threads form delta =
//     rowsum(dO * O) in f32 for their own q rows (16-byte loads, a quad
//     sum), keep it in registers for dS and write it to a [B, H, L] f32
//     scratch tensor beside lse;
//   * dK/dV: one CTA per (64-row k tile, kv head, batch) (128 rows in two
//     warpgroups at D 128), K and V resident, walks the visible Q/dO tiles
//     of each q head of its GQA group in turn (the ring's steps run on
//     across heads), with their rows' lse and delta through the 1-D stats
//     map; dK and dV stay in f32 registers over the whole group, so the
//     group sum happens inside the kernel.  The stream orders it after dQ,
//     which wrote the delta it reads;
//   * dq, dk and dv are written in the input type straight from the f32
//     accumulators.  The TPU kernel writes f32 and casts outside; both round
//     the same f32 value once, and writing 16 bits saves 0.4 GB of traffic
//     at the path's shape.
// Against the bytes bound the design moves about 1.62 GB at the path's
// shape (each launch reads its operands once: 0.81 GB each, 0.48 ms), and,
// as in #12, is held back by the latency of short chains (1-16 steps of 32
// rows); the tiles (DqCfg, DkvCfg below: 64-row CTAs, 2-3 an SM) beat
// 128- and 192-row CTAs, 64-row steps and fewer slots on the card
// (PERF.md).
//
// Any L >= 1 works: rows past the end are zero-filled by the TMA, a key
// past the end counts as absent (p = 0) and rows past the end are not
// written.  Requirements checked by the Python wrapper: D in {64, 128},
// bf16 or fp16 operands of one type, contiguous, 16-byte aligned (lse
// too).  Each entry returns cudaGetLastError() after its launches, or an
// error if a tensor map cannot be built.

#include <math.h>

#include "flash_bwd_sm90.cuh"

namespace {

constexpr float NEG = -1e30f;  // the TPU kernels' mask value

// The forward's arguments (the backward's are sm90::BwdArgs); q, k and v
// reach every kernel through its tensor maps.
struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;     // written
  float* lse;  // written
  int B, H, Hkv, L, causal;
  float scale;
};

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
      *reinterpret_cast<uint32_t*>(op + 8 * j + 2 * t) = Pair<T>::pack(
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

// ---- #13: dQ and dK/dV, the whole-sequence form of the backward bodies
// in flash_bwd_sm90.cuh ------------------------------------------------------

// The tiles of dQ: 64 q rows a CTA (one consumer warpgroup and a producer
// warp), 32 K/V rows a step; at D 64 four ring slots and three CTAs an SM,
// at D 128 two slots and two CTAs.
template <int D>
using DqCfg = sm90::Cfg<D, 32, D == 64 ? 4 : 2, 1, D == 64 ? 3 : 2, 2>;

// The tiles of dK/dV: at D 64, 64 k rows a CTA, 32 Q/dO rows a step, three
// ring slots, two CTAs an SM; at D 128 those of #11 (128 k rows, two
// consumer warpgroups, one CTA an SM): with one warpgroup a CTA, dK and dV
// would not fit the registers of two CTAs an SM.
template <int D>
using DkvCfg = sm90::Cfg<D, 32, 3, D == 64 ? 1 : 2, D == 64 ? 2 : 1, 2, true>;

template <typename T, int D>
__global__ void __launch_bounds__(DqCfg<D>::THREADS, DqCfg<D>::CTAS)
    smallseq_dq_kernel(const __grid_constant__ sm90::Params<sm90::BwdArgs> p) {
  sm90::dq_body<T, DqCfg<D>, true>(p);
}

template <typename T, int D>
__global__ void __launch_bounds__(DkvCfg<D>::THREADS, DkvCfg<D>::CTAS)
    smallseq_dkv_kernel(const __grid_constant__ sm90::Params<sm90::BwdArgs> p) {
  sm90::dkv_body<T, DkvCfg<D>, true>(p);
}

// Two launches on one stream: dQ (which writes delta), then dK/dV (which
// reads it); the stream orders them.
template <typename T, int D>
cudaError_t bwd(const Args& f, const sm90::BwdArgs& a, cudaStream_t stream) {
  cudaError_t err = sm90::launch<T, DqCfg<D>>(
      smallseq_dq_kernel<T, D>, a, a.B, a.H, {f.q, a.H, a.Lq},
      {a.dout, a.H, a.Lq}, {f.k, a.Hkv, a.Lk}, {f.v, a.Hkv, a.Lk}, {},
      stream);
  if (err != cudaSuccess) return err;
  return sm90::launch<T, DkvCfg<D>>(
      smallseq_dkv_kernel<T, D>, a, a.B, a.Hkv, {f.k, a.Hkv, a.Lk},
      {f.v, a.Hkv, a.Lk}, {f.q, a.H, a.Lq}, {a.dout, a.H, a.Lq},
      {a.lse, a.delta, (long long)a.B * a.H * a.Lq}, stream);
}

template <typename T, int D>
cudaError_t dispatch(int kind, const Args& f, const sm90::BwdArgs& a,
                     cudaStream_t stream) {
  return kind == 0 ? fwd<T, D>(f, stream) : bwd<T, D>(f, a, stream);
}

int run(int kind, const Args& f, const sm90::BwdArgs& a, int D, int fp16,
        void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (D != 64 && D != 128) return (int)cudaErrorInvalidValue;
  if (f.H <= 0 || f.Hkv <= 0 || f.H % f.Hkv || f.L < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (fp16)
    err = D == 64 ? dispatch<__half, 64>(kind, f, a, s)
                  : dispatch<__half, 128>(kind, f, a, s);
  else
    err = D == 64 ? dispatch<bf16, 64>(kind, f, a, s)
                  : dispatch<bf16, 128>(kind, f, a, s);
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
  Args f = make_args(q, k, v, B, H, Hkv, L, causal, scale);
  f.o = o;
  f.lse = (float*)lse;
  return run(0, f, {}, D, fp16, stream);
}

// Backward: dq [B, L, H, D], dk and dv [B, L, Hkv, D] (group-summed), all
// in q's type, from dO, the forward's o and lse [B, H, L] f32; delta
// [B, H, L] f32 is scratch, written by the first launch and read by the
// second.
int hvdt_smallseq_bwd(const void* q, const void* k, const void* v,
                      const void* dout, const void* o, const void* lse,
                      void* delta, void* dq, void* dk, void* dv, int B, int H,
                      int Hkv, int L, int D, int fp16, int causal,
                      float scale, void* stream) {
  const Args f = make_args(q, k, v, B, H, Hkv, L, causal, scale);
  sm90::BwdArgs a = {};
  a.dout = dout;
  a.o = o;
  a.lse = (const float*)lse;
  a.delta = (float*)delta;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.B = B;
  a.H = H;
  a.Hkv = Hkv;
  a.Lq = a.Lk = L;
  a.causal = causal;
  a.scale = scale;
  return run(1, f, a, D, fp16, stream);
}

}  // extern "C"
