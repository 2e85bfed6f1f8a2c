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
// One launch a call each.
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
// Which code each kernel runs: #9's body is here, on the core of
// flash_sm90.cuh (TMA ring, wgmma, ping-pong; #12 and the conv GEMM share
// it).  #10 and #11 are the streaming form of the backward bodies of
// flash_bwd_sm90.cuh (dq_body, dkv_body), which #13 (flash_smallseq.cu)
// instantiates in its whole-sequence form; those bodies' note gives their
// formulation and register budgets.  Against the operations bound:
//   * products are wgmma, the only way to the tensor cores' full rate;
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
// Numerics follow the TPU kernels: masked scores are -1e30 (not -inf) in
// the forward, p = exp(s - m_new) is zeroed where masked, P is rounded to
// V's type before PV, l is the f32 sum of the unrounded p and is clamped
// at 1e-30 before o = acc / l; in the backward p = exp(s * scale - lse)
// and exactly 0 where a pair is not visible, dS = p (dP - delta) scale,
// dq rounds dS to K's type, dkv rounds P to dO's and dS to Q's type.  A
// row that sees no key (lse near -1e30) never overflows into a product.
// In the forward a q row that sees no key passes its carry (acc, m, l)
// through bit for bit.
//
// Requirements checked by the Python wrapper: D in {64, 128}, bf16 or fp16
// operands of one type, contiguous, 16-byte aligned (lse and delta too).
// Each entry returns cudaGetLastError() after its launch, or an error if a
// tensor map cannot be built.

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
  const float* acc_in;  // forward carry in (null: zeros / -1e30 / zeros)
  const float* m_in;
  const float* l_in;
  float* acc_out;       // forward carry out (when o is null)
  float* m_out;
  float* l_out;
  void* o;              // forward: finished output (null: carry mode)
  float* lse_out;
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
        *reinterpret_cast<uint32_t*>(op + 8 * j + 2 * t) = Pair<T>::pack(
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

// ---- #10 and #11: dQ and dK/dV, the streaming form of the backward
// bodies in flash_bwd_sm90.cuh -----------------------------------------------

// The tiles of #10: 192 q rows a CTA at D 64 (three consumer warpgroups)
// and 128 at D 128 (two), 64 K/V rows a step, three ring slots, one CTA an
// SM.
template <int D>
using DqCfg = sm90::Cfg<D, 64, 3, D == 64 ? 3 : 2, 1, 2>;

// The tiles of #11: 128 k rows a CTA (two consumer warpgroups), 64 Q/dO
// rows a step at D 64 and 32 at D 128 (at 64 the scores, dK, dV and both
// sets of fragments would need 224 of the 240 registers a thread, and
// ptxas spills and serializes the wgmma), three ring slots, one CTA an SM.
template <int D>
using DkvCfg = sm90::Cfg<D, D == 64 ? 64 : 32, 3, 2, 1, 2, true>;

template <typename T, int D>
__global__ void __launch_bounds__(DqCfg<D>::THREADS, DqCfg<D>::CTAS)
    flash_dq_kernel(const __grid_constant__ sm90::Params<sm90::BwdArgs> p) {
  sm90::dq_body<T, DqCfg<D>, false>(p);
}

template <typename T, int D>
__global__ void __launch_bounds__(DkvCfg<D>::THREADS, DkvCfg<D>::CTAS)
    flash_dkv_kernel(const __grid_constant__ sm90::Params<sm90::BwdArgs> p) {
  sm90::dkv_body<T, DkvCfg<D>, false>(p);
}

template <typename T, int D>
cudaError_t dq(const Args& f, const sm90::BwdArgs& a, cudaStream_t stream) {
  return sm90::launch<T, DqCfg<D>>(
      flash_dq_kernel<T, D>, a, a.B, a.H, {f.q, a.H, a.Lq},
      {a.dout, a.H, a.Lq}, {f.k, a.Hkv, a.Lk}, {f.v, a.Hkv, a.Lk}, {},
      stream);
}

template <typename T, int D>
cudaError_t dkv(const Args& f, const sm90::BwdArgs& a, cudaStream_t stream) {
  return sm90::launch<T, DkvCfg<D>>(
      flash_dkv_kernel<T, D>, a, a.B, a.H, {f.k, a.Hkv, a.Lk},
      {f.v, a.Hkv, a.Lk}, {f.q, a.H, a.Lq}, {a.dout, a.H, a.Lq},
      {a.lse, a.delta, (long long)a.B * a.H * a.Lq}, stream);
}

// kind: 0 forward, 1 dq, 2 dkv.
template <typename T, int D>
cudaError_t dispatch(int kind, const Args& f, const sm90::BwdArgs& a,
                     cudaStream_t stream) {
  if (kind == 0) return fwd<T, D>(f, stream);
  if (kind == 1) return dq<T, D>(f, a, stream);
  return dkv<T, D>(f, a, stream);
}

int run(int kind, const Args& f, const sm90::BwdArgs& a, int D, int fp16,
        void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (D != 64 && D != 128) return (int)cudaErrorInvalidValue;
  if (f.H <= 0 || f.Hkv <= 0 || f.H % f.Hkv) return (int)cudaErrorInvalidValue;
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

sm90::BwdArgs bwd_args(const Args& f, const void* dout, const void* lse,
                       const void* delta) {
  sm90::BwdArgs a = {};
  a.dout = dout;
  a.lse = (const float*)lse;
  a.delta = (float*)delta;
  a.B = f.B;
  a.H = f.H;
  a.Hkv = f.Hkv;
  a.Lq = f.Lq;
  a.Lk = f.Lk;
  a.q_offset = f.q_offset;
  a.k_offset = f.k_offset;
  a.causal = f.causal;
  a.scale = f.scale;
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
  return run(0, a, {}, D, fp16, stream);
}

int hvdt_flash_dq(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dq, int B, int H, int Hkv, int Lq, int Lk, int D,
                  int fp16, int q_offset, int k_offset, int causal,
                  float scale, void* stream) {
  const Args f = make_args(q, k, v, B, H, Hkv, Lq, Lk, q_offset, k_offset,
                           causal, scale);
  sm90::BwdArgs a = bwd_args(f, dout, lse, delta);
  a.dq = dq;
  return run(1, f, a, D, fp16, stream);
}

// dk/dv are per q-head, [B, Lk, H, D] f32.
int hvdt_flash_dkv(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dk, void* dv, int B, int H, int Hkv, int Lq, int Lk,
                   int D, int fp16, int q_offset, int k_offset, int causal,
                   float scale, void* stream) {
  const Args f = make_args(q, k, v, B, H, Hkv, Lq, Lk, q_offset, k_offset,
                           causal, scale);
  sm90::BwdArgs a = bwd_args(f, dout, lse, delta);
  a.dk = dk;
  a.dv = dv;
  return run(2, f, a, D, fp16, stream);
}

}  // extern "C"
