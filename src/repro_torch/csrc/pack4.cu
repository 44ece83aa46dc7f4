// 4-bit two-per-byte pack and unpack of the spike wire for Hopper
// (sm_90a): uint8 [M, C] (C even) <-> uint8 [M, C/2], with
// out[k] = v[2k] | v[2k+1] << 4 along the last axis.
//
// Replaces the TPU kernels `pack4_pallas` / `_pack4_kernel` and
// `unpack4_pallas` / `_unpack4_kernel` (src/repro/kernels/pack4.py).
// Plain versions and wrappers: src/repro_torch/kernels/pack4.py. Bound
// with ctypes through the plain C functions `pack4_launch` and
// `unpack4_launch` at the bottom of this file.
//
// With C even and rows contiguous, the pairs of the last axis are the
// pairs of the flat array, so both kernels walk the flat bytes: pack
// runs one thread per output byte, unpack one per input byte. Values
// are combined exactly as the oracle does in uint8 (`hi << 4` drops
// hi's high bits, `lo` is not masked), so every byte value, not only
// those below 16, gives the oracle's result.
//
// What bounds them: memory — n bytes one way, n/2 the other, no
// arithmetic to speak of. Byte-wide accesses waste most of each memory
// transaction; vector loads of 16 bytes a thread are the later step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) pack4_kernel(
    const uint8_t* __restrict__ in, uint8_t* __restrict__ out, long n_out) {
  long k = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n_out) return;
  const unsigned lo = in[2 * k];
  const unsigned hi = in[2 * k + 1];
  out[k] = (uint8_t)(lo | (hi << 4));
}

__global__ void __launch_bounds__(kThreads) unpack4_kernel(
    const uint8_t* __restrict__ in, uint8_t* __restrict__ out, long n_in) {
  long k = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n_in) return;
  const unsigned v = in[k];
  out[2 * k] = (uint8_t)(v & 0xFu);
  out[2 * k + 1] = (uint8_t)((v >> 4) & 0xFu);
}

unsigned blocks_for(long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

// in [n_out * 2] uint8 -> out [n_out] uint8. Returns cudaGetLastError().
extern "C" int pack4_launch(const uint8_t* in, uint8_t* out, long n_out,
                            cudaStream_t stream) {
  pack4_kernel<<<blocks_for(n_out), kThreads, 0, stream>>>(in, out, n_out);
  return (int)cudaGetLastError();
}

// in [n_in] uint8 -> out [n_in * 2] uint8. Returns cudaGetLastError().
extern "C" int unpack4_launch(const uint8_t* in, uint8_t* out, long n_in,
                              cudaStream_t stream) {
  unpack4_kernel<<<blocks_for(n_in), kThreads, 0, stream>>>(in, out, n_in);
  return (int)cudaGetLastError();
}
