// T-tick on/off integrate-and-fire spike encoder for Hopper (sm_90a):
// activation -> signed spike count in {-T..T}, int8, and optionally the
// rate decode of those counts.
//
// Replaces the TPU kernel `lif_encode_pallas` / `_lif_encode_kernel`
// (src/repro/kernels/lif_encode.py). Plain version and wrapper:
// src/repro_torch/kernels/lif_encode.py. Bound with ctypes through the
// plain C function `lif_encode_launch` at the bottom of this file. A
// second entry, `lif_encode_bwd_launch`, runs the encoder's surrogate
// gradient for training (see "Backward" below).
//
// What it computes, for x [M, C] and channel c, in f32 as the TPU
// kernel computes: xn = x / scale[c]; the on and off populations
// integrate clip(xn, 0, 1) and clip(-xn, 0, 1) from a membrane of 0.5
// for T ticks, each tick `u = u + d; fire if u >= 1; u -= 1 on a spike`
// (subtract reset); the count difference is written, gated by
// |xn| - theta[c] / scale[c] >= 0. At most one population fires: the
// other's drive is 0 and its membrane stays at 0.5. So the kernel
// integrates clip(|xn|, 0, 1) once (-xn == |xn| exactly for xn < 0),
// with a drive of 0 where the gate is closed, and gives the count the
// sign of xn: the same count as the difference.
//
// The gate compares normalised values, as the JAX `spike` codec does
// (`spike.encode` with `faithful=True` divides x and theta by scale
// before `lif_rate_encode_signed`), not the raw `|x| >= theta` of the
// TPU kernel: the two differ only where fl(|x|/s) == fl(theta/s) while
// |x| < theta, and the served path must match the codec.
//
// bf16 mode (`math_bf16` = 1), for bfloat16 activations: the JAX codec
// then computes in the activation's dtype, and XLA rounds every op to
// bf16, as PyTorch's bf16 ops do (an f32 op on bf16 values, then one
// rounding). So the kernel rounds x, theta and scale to bf16 and rounds
// after each divide and subtract of the gate: xn = bf16(x / s),
// thn = bf16(theta / s), the gate bf16(|xn| - thn) >= 0.
//
// The tick, u = r(u + d); fire on r(u - 1) >= 0; on a spike u = r(u - 1)
// (r: the compute type's rounding), is computed in a form that gives the
// same bits with fewer operations. The membrane stays in [0, 2) and
// d in [0, 1], so u - 1 >= 0 exactly when u >= 1, and then u - 1 is
// exact (Sterbenz): the tick is w = r(u + d); f = (w >= 1 ? 1 : 0);
// u = w - f, three operations, with no rounding after the add. In bf16
// the add is one correctly rounded bf16 add (`fma.rn.bf16x2` with a
// factor of 1), on both channels of a thread at once: rounding the f32
// sum of two bf16 values to bf16 is that same rounding (24 >= 2 x 8 + 2
// bits, so the double rounding is innocuous), and the compare and the
// exact subtraction are bf16x2 operations too. A tiny drive flushed to
// 0 by the bf16 unit changes no count: a membrane that such a drive
// moves never reaches 1 in T <= 127 ticks.
//
// Decode epilogue (`dscale` not null): the caller passes the decode's
// per-channel factor exp(log_scale) / T as the JAX `spike.decode`
// computes it in x's dtype, and the kernel also writes
// decoded = count * dscale[c], rounded once to x's dtype: the single
// multiply of `rate_decode_signed`. A count (|count| <= 127) times a
// bf16 value is exact in f32, so the one rounding is PyTorch's.
//
// Exactness: the divisions are IEEE (never build with --use_fast_math,
// -prec-div=false or -ftz=true); the tick has no multiply, so no FMA
// contraction can change it.
//
// What bounds it: at [256, 1024] the cold read of x (after a write that
// flushes the L2) and the tick arithmetic (3 operations per tick of an
// element, one IEEE divide) take about a microsecond each; at the
// decode rows, [4, 1024], the launch itself. Design: a thread owns two
// channels of one row (a 2-D grid: channel pairs by rows). It issues
// its loads of x, theta, scale and the decode factor before any
// arithmetic, so each thread waits on memory once, and keeps both
// channels' tick chains in registers. Threads owning more channels or
// more rows, to share the per-channel work, were slower at both row
// counts: the ticks, not the per-channel divide, dominate, and fewer
// threads hide their latency worse. An odd channel count, or a buffer
// that is not aligned for the pair accesses, takes scalar loads and
// stores (kVec = false).

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr long kMaxRows = 65535;  // gridDim.y; blocks loop over more rows

using repro::to_f32;

// The value of an op's f32 result in the compute type: itself in f32,
// rounded to the nearest bf16 (ties to even) in bf16 mode.
template <bool kBf16>
__device__ __forceinline__ float rnd(float v) {
  return kBf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

__device__ __forceinline__ float clip01(float v) {
  return v > 0.0f ? (v < 1.0f ? v : 1.0f) : 0.0f;
}

__device__ __forceinline__ void load_pair(const float* p, float* v) {
  const float2 w = *reinterpret_cast<const float2*>(p);
  v[0] = w.x;
  v[1] = w.y;
}
__device__ __forceinline__ void load_pair(const __nv_bfloat16* p, float* v) {
  const float2 w = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  v[0] = w.x;
  v[1] = w.y;
}
__device__ __forceinline__ void store_pair(float* p, const float* v) {
  *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, const float* v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
}

// T ticks of the two drives d[0..1] (values of the compute type in
// [0, 1]); n[v] receives the spike count of each. The count is not
// summed tick by tick: the resets subtract exactly 1, so
// u_T = 0.5 + T d + E - n, where E, the sum of the T adds' rounding
// errors, is below T ulp(2) / 2 = T 2^-24 (f32) or T 2^-8 (bf16,
// under 0.5 for T <= 127). So n = rint(0.5 + T d - u_T), computed in
// f32 to well within the remaining margin.
template <bool kBf16>
__device__ __forceinline__ void ticks(const float* d, int T, int* n) {
  float u[2];
  if constexpr (kBf16) {
    constexpr unsigned kOne = 0x3F803F80u;       // bf16x2 (1, 1)
    constexpr unsigned kMinusOne = 0xBF80BF80u;  // bf16x2 (-1, -1)
    const __nv_bfloat162 dd = __floats2bfloat162_rn(d[0], d[1]);
    const unsigned d2 = *reinterpret_cast<const unsigned*>(&dd);
    unsigned m = 0x3F003F00u;                    // bf16x2 (0.5, 0.5)
    for (int t = 0; t < T; ++t) {
      unsigned w, f;
      asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(w) : "r"(m), "r"(kOne),
          "r"(d2));
      asm("set.ge.bf16x2.bf16x2 %0, %1, %2;" : "=r"(f) : "r"(w), "r"(kOne));
      asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(m) : "r"(f),
          "r"(kMinusOne), "r"(w));
    }
    const float2 mf = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&m));
    u[0] = mf.x;
    u[1] = mf.y;
  } else {
    u[0] = u[1] = 0.5f;
    for (int t = 0; t < T; ++t)
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const float w = u[v] + d[v];
        float f;                                  // 1.0f on a spike
        asm("set.ge.f32.f32 %0, %1, 0f3F800000;" : "=f"(f) : "f"(w));
        u[v] = w - f;
      }
  }
#pragma unroll
  for (int v = 0; v < 2; ++v)
    n[v] = (int)rintf(__fmaf_rn((float)T, d[v], 0.5f) - u[v]);
}

template <typename X, bool kBf16, bool kVec>
__global__ void __launch_bounds__(kThreads) lif_encode_kernel(
    const X* __restrict__ x, const float* __restrict__ theta,
    const float* __restrict__ scale, const float* __restrict__ dscale,
    int8_t* __restrict__ out, X* __restrict__ dec, long M, int C, int T) {
  const int c0 = 2 * (blockIdx.x * kThreads + threadIdx.x);
  if (c0 >= C) return;
  const bool two = kVec || c0 + 1 < C;   // the second channel exists
  const int c1 = two ? c0 + 1 : c0;
  const bool decode = dscale != nullptr;
  for (long row = blockIdx.y; row < M; row += gridDim.y) {
    const long off = row * C + c0;
    // every load before any arithmetic
    float xv[2];
    if (kVec) {
      load_pair(x + off, xv);
    } else {
      xv[0] = to_f32(x[off]);
      xv[1] = to_f32(x[off + (c1 - c0)]);
    }
    const float sc[2] = {scale[c0], scale[c1]};
    const float th[2] = {theta[c0], theta[c1]};
    float ds[2] = {0.0f, 0.0f};
    if (decode) {
      ds[0] = dscale[c0];
      ds[1] = dscale[c1];
    }

    float d[2];
    bool neg[2];
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const float s = rnd<kBf16>(sc[v]);
      const float thn = rnd<kBf16>(rnd<kBf16>(th[v]) / s);
      const float xn = rnd<kBf16>(rnd<kBf16>(xv[v]) / s);
      const float a = fabsf(xn);
      d[v] = rnd<kBf16>(a - thn) >= 0.0f ? clip01(a) : 0.0f;
      neg[v] = xn < 0.0f;
    }
    int n[2];
    ticks<kBf16>(d, T, n);

    int c[2];
    float y[2];
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      c[v] = neg[v] ? -n[v] : n[v];
      // the decode factor in x's dtype, then one IEEE multiply
      y[v] = (float)c[v] * rnd<sizeof(X) == 2>(ds[v]);
    }
    if (kVec) {
      *reinterpret_cast<uint16_t*>(out + off) =
          (uint16_t)((c[0] & 0xFF) | (c[1] & 0xFF) << 8);
      if (decode) store_pair(dec + off, y);
    } else {
      out[off] = (int8_t)c[0];
      if (decode) repro::store(dec + off, y[0]);
      if (two) {
        out[off + 1] = (int8_t)c[1];
        if (decode) repro::store(dec + off + 1, y[1]);
      }
    }
  }
}

bool aligned(const void* p, unsigned bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename X>
void launch(const void* xp, const float* theta, const float* scale,
            const float* dscale, int8_t* out, void* decp, long M, int C,
            int T, int math_bf16, cudaStream_t stream) {
  const X* x = static_cast<const X*>(xp);
  X* dec = static_cast<X*>(decp);
  const bool vec = C % 2 == 0 && aligned(x, 2 * sizeof(X)) &&
                   aligned(out, 2) &&
                   (dec == nullptr || aligned(dec, 2 * sizeof(X)));
  const dim3 grid((unsigned)(((C + 1) / 2 + kThreads - 1) / kThreads),
                  (unsigned)(M < kMaxRows ? M : kMaxRows));
#define LIF_LAUNCH(B, V)                                           \
  lif_encode_kernel<X, B, V><<<grid, kThreads, 0, stream>>>(       \
      x, theta, scale, dscale, out, dec, M, C, T)
  if (math_bf16) {
    if (vec) LIF_LAUNCH(true, true); else LIF_LAUNCH(true, false);
  } else {
    if (vec) LIF_LAUNCH(false, true); else LIF_LAUNCH(false, false);
  }
#undef LIF_LAUNCH
}

// ---------------------------------------------------------------------------
// Backward (surrogate gradient), f32: the VJP of the reference's
// `lif_rate_encode_signed(xn, thn, T)` (src/repro/core/spike.py) with
// respect to its pre-normalised input xn [M, C] and its threshold thn
// [C], element by element, as PyTorch's autograd computes it through the
// plain tick loop (`if_count` with the fast-sigmoid `spike_step`,
// src/repro_torch/core/spike.py):
//   out = (n_on - n_off) * H(|xn| - thn)
//   n_on = IF(clip(xn, 0, 1)), n_off = IF(clip(-xn, 0, 1))
//   IF(d): u = 0.5; T times { u = u + d; s = H(u - 1); u = u - s; n += s }
// Each H takes the surrogate derivative surr(v) = (1 / (1 + 10|v|)^2) * 10
// (PyTorch's `10 / t`: a reciprocal, then a product). The kernel
// recomputes both populations' T ticks in registers (T <= kMaxTicks),
// keeping each tick's v = u - 1, and walks them back:
//   gs = gn - gu; gu = gu + gs * surr(v_t); gd += gu   (t = T-1 .. 0)
// The clip passes the gradient inside (0, 1) and half of it at either
// end, and |xn| passes +1 at 0: JAX's derivatives, which the plain
// version's `clip01` and `abs_` take. dthn is written per element
// ([M, C]); the sum over rows and the division by the scale stay in
// PyTorch's autograd around the launch. One thread an element.

constexpr int kMaxTicks = 16;
constexpr int kBwdThreads = 256;

__device__ __forceinline__ float surrogate(float v) {
  const float q = __fadd_rn(1.0f, __fmul_rn(10.0f, fabsf(v)));
  return __fmul_rn(__frcp_rn(__fmul_rn(q, q)), 10.0f);
}

// The derivative of clip(v, 0, 1): 1 inside, 1/2 at either end, else 0.
__device__ __forceinline__ float clip_weight(float v) {
  return (v > 0.0f && v < 1.0f) ? 1.0f
                                : ((v == 0.0f || v == 1.0f) ? 0.5f : 0.0f);
}

// The gradient of the count of one population with respect to its
// drive d, for the count's cotangent gn.
__device__ __forceinline__ float if_count_vjp(float d, int T, float gn,
                                              float* n_out) {
  float v[kMaxTicks];
  float u = 0.5f, n = 0.0f;
#pragma unroll
  for (int t = 0; t < kMaxTicks; ++t) {
    if (t < T) {
      const float w = __fadd_rn(u, d);
      v[t] = __fsub_rn(w, 1.0f);
      const float s = v[t] >= 0.0f ? 1.0f : 0.0f;
      u = __fsub_rn(w, s);
      n = __fadd_rn(n, s);
    }
  }
  *n_out = n;
  float gu = 0.0f, gd = 0.0f;
#pragma unroll
  for (int t = kMaxTicks - 1; t >= 0; --t) {
    if (t < T) {
      const float gs = __fsub_rn(gn, gu);
      gu = __fadd_rn(gu, __fmul_rn(gs, surrogate(v[t])));
      gd = __fadd_rn(gd, gu);
    }
  }
  return gd;
}

__global__ void __launch_bounds__(kBwdThreads) lif_encode_bwd_kernel(
    const float* __restrict__ xn, const float* __restrict__ thn,
    const float* __restrict__ g, float* __restrict__ dxn,
    float* __restrict__ dthn, long n_elem, int C, int T) {
  const long i = (long)blockIdx.x * kBwdThreads + threadIdx.x;
  if (i >= n_elem) return;
  const float x = xn[i];
  const float th = thn[i % C];
  const float gi = g[i];
  const float va = __fsub_rn(fabsf(x), th);
  const float gate = va >= 0.0f ? 1.0f : 0.0f;
  const float dp = x > 0.0f ? (x < 1.0f ? x : 1.0f) : 0.0f;
  const float nx = -x;
  const float dn = nx > 0.0f ? (nx < 1.0f ? nx : 1.0f) : 0.0f;
  const float g_diff = __fmul_rn(gi, gate);
  float n_on, n_off;
  const float gd_on = if_count_vjp(dp, T, g_diff, &n_on);
  const float gd_off = if_count_vjp(dn, T, -g_diff, &n_off);
  const float g_gate = __fmul_rn(gi, __fsub_rn(n_on, n_off));
  const float g_va = __fmul_rn(g_gate, surrogate(va));
  float dx = x >= 0.0f ? g_va : -g_va;
  dx = __fadd_rn(dx, __fmul_rn(gd_on, clip_weight(x)));
  dx = __fsub_rn(dx, __fmul_rn(gd_off, clip_weight(nx)));
  dxn[i] = dx;
  dthn[i] = -g_va;
}

}  // namespace

// x [M, C] f32 (x_bf16 = 0) or bf16 (x_bf16 = 1); theta, scale [C] f32;
// out [M, C] int8; math_bf16 = 1 computes in bf16 (see above), 0 in f32.
// With dscale [C] f32 (else null), dec [M, C] in x's dtype receives
// out * dscale rounded once. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int lif_encode_launch(const void* x, const float* theta,
                                 const float* scale, const float* dscale,
                                 int8_t* out, void* dec, long M, int C, int T,
                                 int x_bf16, int math_bf16,
                                 cudaStream_t stream) {
  if (x_bf16)
    launch<__nv_bfloat16>(x, theta, scale, dscale, out, dec, M, C, T,
                          math_bf16, stream);
  else
    launch<float>(x, theta, scale, dscale, out, dec, M, C, T, math_bf16,
                  stream);
  return (int)cudaGetLastError();
}

// xn, g, dxn, dthn [M, C] f32; thn [C] f32; 1 <= T <= 16. Launches on
// `stream`; returns cudaGetLastError().
extern "C" int lif_encode_bwd_launch(const float* xn, const float* thn,
                                     const float* g, float* dxn, float* dthn,
                                     long M, int C, int T,
                                     cudaStream_t stream) {
  const long n = M * (long)C;
  const unsigned blocks = (unsigned)((n + kBwdThreads - 1) / kBwdThreads);
  lif_encode_bwd_kernel<<<blocks, kBwdThreads, 0, stream>>>(
      xn, thn, g, dxn, dthn, n, C, T);
  return (int)cudaGetLastError();
}
