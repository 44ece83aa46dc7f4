// Backward of a spike-coded boundary's encode -> wire -> decode roundtrip
// for Hopper (sm_90a): the hand-derived VJP of the signed rate code.
//
// The reference computes it in jnp (`spike.roundtrip_vjp`,
// src/repro/core/spike.py), the backward of every coded collective's
// custom VJP (`_roundtrip_bwd`, src/repro/core/boundary.py); no TPU
// kernel replaces it. Plain version and wrapper:
// src/repro_torch/kernels/roundtrip_bwd.py. Bound with ctypes through the
// plain C function `roundtrip_bwd_launch` at the bottom of this file.
//
// What it computes, for x, g [M, C] and channel c, in f32:
//   mag = |x|, sgn = sign(x), in = 1[0 < mag < s], gate = 1[mag >= th]
//   cm = rint(clip(mag / s, 0, 1) * T), ymag = cm * sT
//   q = 1 + 10 |mag - th|, surr = (1 / (q q)) * 10
//   dx = g (gate in + ymag surr)                  (x's dtype)
//   dth[c] = sum over rows of ((-g sgn) ymag) surr
//   dls[c] = sum over rows of ((g sgn) gate) ((-mag in) + ymag)
// with s = exp(log_scale) and sT = s / T taken from the caller (PyTorch
// computes them, so the factors are the plain version's bits).
//
// Exactness: every op is one IEEE-rounded intrinsic, in the plain
// version's order, so no FMA contraction can change a bit of dx; never
// build with --use_fast_math. The two channel sums are deterministic:
// a block owns 32 channels (a lane each), each of its warps sums its
// rows (w, w + kWarps, ...) in order, and warp 0 adds the warps'
// partials in order. No atomics.
//
// What bounds it: the read of x and g and the write of dx (3 x M x C
// elements); ~25 operations an element. The grid has one block per 32
// channels, so [2048, 1024] runs 32 blocks of 16 warps; each warp
// issues the loads of four rows before it computes them.

#include "common.cuh"

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 4;  // rows a warp loads before it computes them

template <typename X>
__device__ __forceinline__ void store_dx(X* p, float v) {
  repro::store(p, v);
}

template <typename X>
__global__ void __launch_bounds__(kThreads) roundtrip_bwd_kernel(
    const X* __restrict__ x, const X* __restrict__ g,
    const float* __restrict__ theta, const float* __restrict__ scale,
    const float* __restrict__ scale_t, X* __restrict__ dx,
    float* __restrict__ dth, float* __restrict__ dls, long M, int C, int T) {
  __shared__ float part_th[kWarps][32];
  __shared__ float part_ls[kWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  const bool live = c < C;
  float s = 1.0f, st = 0.0f, th = 0.0f;
  if (live) {
    s = scale[c];
    st = scale_t[c];
    th = theta[c];
  }
  const float Tf = (float)T;
  float acc_th = 0.0f, acc_ls = 0.0f;
  for (long r0 = (long)warp * kRows; r0 < M; r0 += (long)kWarps * kRows) {
    float xv[kRows], gv[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const long r = r0 + i;
      xv[i] = 0.0f;
      gv[i] = 0.0f;
      if (live && r < M) {
        xv[i] = repro::to_f32(x[r * C + c]);
        gv[i] = repro::to_f32(g[r * C + c]);
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const long r = r0 + i;
      if (!live || r >= M) continue;
      const float mag = fabsf(xv[i]);
      const float sgn = xv[i] > 0.0f ? 1.0f : (xv[i] < 0.0f ? -1.0f : 0.0f);
      const float in_rng = (mag > 0.0f && mag < s) ? 1.0f : 0.0f;
      const float gate = mag >= th ? 1.0f : 0.0f;
      float cl = __fdiv_rn(mag, s);
      cl = cl > 0.0f ? (cl < 1.0f ? cl : 1.0f) : 0.0f;
      const float cm = rintf(__fmul_rn(cl, Tf));
      const float ymag = __fmul_rn(cm, st);
      const float v = __fsub_rn(mag, th);
      const float q = __fadd_rn(1.0f, __fmul_rn(10.0f, fabsf(v)));
      const float surr = __fmul_rn(__frcp_rn(__fmul_rn(q, q)), 10.0f);
      const float gf = gv[i];
      const float d = __fmul_rn(
          gf, __fadd_rn(__fmul_rn(gate, in_rng), __fmul_rn(ymag, surr)));
      store_dx(dx + r * C + c, d);
      const float t_th = __fmul_rn(__fmul_rn(__fmul_rn(-gf, sgn), ymag),
                                   surr);
      const float t_ls = __fmul_rn(
          __fmul_rn(__fmul_rn(gf, sgn), gate),
          __fadd_rn(__fmul_rn(-mag, in_rng), ymag));
      acc_th = __fadd_rn(acc_th, t_th);
      acc_ls = __fadd_rn(acc_ls, t_ls);
    }
  }
  part_th[warp][lane] = acc_th;
  part_ls[warp][lane] = acc_ls;
  __syncthreads();
  if (warp == 0 && live) {
    float a = part_th[0][lane], b = part_ls[0][lane];
    for (int w = 1; w < kWarps; ++w) {
      a = __fadd_rn(a, part_th[w][lane]);
      b = __fadd_rn(b, part_ls[w][lane]);
    }
    dth[c] = a;
    dls[c] = b;
  }
}

}  // namespace

// x, g [M, C] f32 (x_bf16 = 0) or bf16 (x_bf16 = 1); theta, scale,
// scale_t [C] f32; dx [M, C] in x's dtype; dth, dls [C] f32. Launches on
// `stream`; returns cudaGetLastError().
extern "C" int roundtrip_bwd_launch(const void* x, const void* g,
                                    const float* theta, const float* scale,
                                    const float* scale_t, void* dx,
                                    float* dth, float* dls, long M, int C,
                                    int T, int x_bf16, cudaStream_t stream) {
  const dim3 grid((unsigned)((C + 31) / 32));
  if (x_bf16)
    roundtrip_bwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(g), theta, scale, scale_t,
        static_cast<__nv_bfloat16*>(dx), dth, dls, M, C, T);
  else
    roundtrip_bwd_kernel<float><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(g), theta,
        scale, scale_t, static_cast<float*>(dx), dth, dls, M, C, T);
  return (int)cudaGetLastError();
}
