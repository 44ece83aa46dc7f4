// T-tick on/off integrate-and-fire spike encoder for Hopper (sm_90a):
// activation -> signed spike count in {-T..T}, int8.
//
// Replaces the TPU kernel `lif_encode_pallas` / `_lif_encode_kernel`
// (src/repro/kernels/lif_encode.py). Plain version and wrapper:
// src/repro_torch/kernels/lif_encode.py. Bound with ctypes through the
// plain C function `lif_encode_launch` at the bottom of this file.
//
// One thread per element of x [M, C] (row-major, channel c = i % C).
// In f32, as the TPU kernel computes: xn = x / scale[c]; the on and off
// populations integrate clip(xn, 0, 1) and clip(-xn, 0, 1) from a
// membrane of 0.5 for T ticks, each tick `u = u + d; fire if u >= 1;
// u -= 1 on a spike` (subtract reset), all in registers; the count
// difference is written once, gated by |xn| - theta[c] / scale[c] >= 0.
// At most one population fires: the other's drive is 0 and its
// membrane stays at 0.5. So the thread integrates clip(|xn|, 0, 1) once
// (-xn == |xn| exactly for xn < 0), only where the gate is open, and
// gives the count the sign of xn: the same count as the difference.
//
// The gate compares normalised values, as the JAX `spike` codec does
// (`spike.encode` with `faithful=True` divides x and theta by scale
// before `lif_rate_encode_signed`), not the raw `|x| >= theta` of the
// TPU kernel: the two differ only where fl(|x|/s) == fl(theta/s) while
// |x| < theta, and the served path must match the codec. theta / scale
// is one IEEE division per element, the same correctly rounded f32
// value the codec computes per channel.
//
// bf16 mode (`math_bf16` = 1), for bfloat16 activations: the JAX codec
// then computes in the activation's dtype, and XLA rounds every op to
// bf16. So the kernel rounds x, theta and scale to bf16 and applies
// __float2bfloat16_rn after each divide, subtract and add, and to each
// operand it compares: xn = bf16(x / s), thn = bf16(theta / s), the gate
// bf16(|xn| - thn) >= 0, each tick u = bf16(u + d), fire on
// bf16(u - 1) >= 0, u = bf16(u - 1). Every op is an f32 op on bf16
// values followed by one rounding, the same value PyTorch's bf16 ops
// give on the CPU and the card.
//
// Exactness: the divisions are IEEE (never build with --use_fast_math,
// -prec-div=false or -ftz=true); the tick loop has no multiply, so no
// FMA contraction can change it.
//
// What bounds it: memory — x read once (4 bytes), the count written once
// (1 byte), per element; at most ~4T operations per element (one
// population's add, compare, reset and count per tick) stay below the
// card's f32 rate. The simple design reads x coalesced, one element
// per thread; wider loads and fusing the encode into the producer of x
// are the later steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// The value of an op's f32 result in the compute type: itself in f32,
// rounded to the nearest bf16 (ties to even) in bf16 mode.
template <bool kBf16>
__device__ __forceinline__ float rnd(float v) {
  return kBf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

__device__ __forceinline__ float clip01(float v) {
  return v > 0.0f ? (v < 1.0f ? v : 1.0f) : 0.0f;
}

template <bool kBf16>
__device__ __forceinline__ int if_count(float drive, int T) {
  float u = 0.5f;
  int count = 0;
  for (int t = 0; t < T; ++t) {
    u = rnd<kBf16>(u + drive);
    if (rnd<kBf16>(u - 1.0f) >= 0.0f) {
      u = rnd<kBf16>(u - 1.0f);
      ++count;
    }
  }
  return count;
}

template <typename X, bool kBf16>
__global__ void __launch_bounds__(kThreads) lif_encode_kernel(
    const X* __restrict__ x, const float* __restrict__ theta,
    const float* __restrict__ scale, int8_t* __restrict__ out, long n,
    int C, int T) {
  long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int c = (int)(i % C);
  const float s = rnd<kBf16>(scale[c]);
  const float xn = rnd<kBf16>(rnd<kBf16>(to_f32(x[i])) / s);
  const float thn = rnd<kBf16>(rnd<kBf16>(theta[c]) / s);
  const float a = fabsf(xn);
  const int count =
      rnd<kBf16>(a - thn) >= 0.0f ? if_count<kBf16>(clip01(a), T) : 0;
  out[i] = (int8_t)(xn < 0.0f ? -count : count);
}

template <typename X>
void launch(const void* x, const float* theta, const float* scale,
            int8_t* out, long n, int C, int T, int math_bf16,
            cudaStream_t stream) {
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  const X* xt = static_cast<const X*>(x);
  if (math_bf16)
    lif_encode_kernel<X, true><<<blocks, kThreads, 0, stream>>>(
        xt, theta, scale, out, n, C, T);
  else
    lif_encode_kernel<X, false><<<blocks, kThreads, 0, stream>>>(
        xt, theta, scale, out, n, C, T);
}

}  // namespace

// x [M, C] f32 (x_bf16 = 0) or bf16 (x_bf16 = 1); theta, scale [C] f32;
// out [M, C] int8; math_bf16 = 1 computes in bf16 (see above), 0 in f32.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int lif_encode_launch(const void* x, const float* theta,
                                 const float* scale, int8_t* out, long M,
                                 int C, int T, int x_bf16, int math_bf16,
                                 cudaStream_t stream) {
  const long n = M * (long)C;
  if (x_bf16)
    launch<__nv_bfloat16>(x, theta, scale, out, n, C, T, math_bf16, stream);
  else
    launch<float>(x, theta, scale, out, n, C, T, math_bf16, stream);
  return (int)cudaGetLastError();
}
