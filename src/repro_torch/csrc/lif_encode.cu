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

__device__ __forceinline__ float clip01(float v) {
  return v > 0.0f ? (v < 1.0f ? v : 1.0f) : 0.0f;
}

__device__ __forceinline__ int if_count(float drive, int T) {
  float u = 0.5f;
  int count = 0;
  for (int t = 0; t < T; ++t) {
    u = u + drive;
    if (u >= 1.0f) {
      u = u - 1.0f;
      ++count;
    }
  }
  return count;
}

template <typename X>
__global__ void __launch_bounds__(kThreads) lif_encode_kernel(
    const X* __restrict__ x, const float* __restrict__ theta,
    const float* __restrict__ scale, int8_t* __restrict__ out, long n,
    int C, int T) {
  long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int c = (int)(i % C);
  const float s = scale[c];
  const float xn = to_f32(x[i]) / s;
  const float thn = theta[c] / s;
  const float a = fabsf(xn);
  const int count = a - thn >= 0.0f ? if_count(clip01(a), T) : 0;
  out[i] = (int8_t)(xn < 0.0f ? -count : count);
}

}  // namespace

// x [M, C] f32 (x_bf16 = 0) or bf16 (x_bf16 = 1); theta, scale [C] f32;
// out [M, C] int8. Launches on `stream`; returns cudaGetLastError().
extern "C" int lif_encode_launch(const void* x, const float* theta,
                                 const float* scale, int8_t* out, long M,
                                 int C, int T, int x_bf16,
                                 cudaStream_t stream) {
  const long n = M * (long)C;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  if (x_bf16)
    lif_encode_kernel<__nv_bfloat16><<<blocks, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), theta, scale, out, n, C, T);
  else
    lif_encode_kernel<float><<<blocks, kThreads, 0, stream>>>(
        static_cast<const float*>(x), theta, scale, out, n, C, T);
  return (int)cudaGetLastError();
}
