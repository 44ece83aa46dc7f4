// 4-bit two-per-byte pack and unpack of the spike wire for Hopper
// (sm_90a): uint8 [M, C] (C even) <-> uint8 [M, C/2], with
// out[k] = v[2k] | v[2k+1] << 4 along the last axis; and the pack fused
// with the wire's bias, signed counts [M, C] (f32 or bf16) -> the packed
// bytes of uint8(counts + T).
//
// Replaces the TPU kernels `pack4_pallas` / `_pack4_kernel` and
// `unpack4_pallas` / `_unpack4_kernel` (src/repro/kernels/pack4.py).
// Plain versions and wrappers: src/repro_torch/kernels/pack4.py. Bound
// with ctypes through the plain C functions `pack4_launch`,
// `pack4_counts_launch` and `unpack4_launch` at the bottom of this file.
//
// With C even and rows contiguous, the pairs of the last axis are the
// pairs of the flat array, so every kernel walks the flat bytes. Values
// are combined exactly as the oracle does in uint8 (`hi << 4` drops
// hi's high bits, `lo` is not masked), so every byte value, not only
// those below 16, gives the oracle's result. A count becomes its wire
// byte as PyTorch's `(counts + T).to(torch.uint8)` makes it: the sum in
// the counts' dtype (rounded to bf16 for bf16 counts), then through
// int64 to uint8.
//
// What bounds them: memory — n bytes one way, n/2 the other (4n or 2n
// bytes of counts in), no arithmetic to speak of; at the decode rows,
// [4, 1024], the launch itself. Each thread of a pack makes one 16-byte
// load (16 wire bytes, or 4 f32 or 8 bf16 counts), combines the pairs
// four bytes at a time in 32-bit lanes, and makes one store of 8, 2 or
// 4 bytes; blocks of 128 threads spread [256, 1024] over the SMs. A
// buffer that is not aligned for those accesses, and the last thread's
// ragged end, take byte loads and stores.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;      // unpack
constexpr int kPackThreads = 128;

// Two words of four wire bytes each -> four packed bytes: per word,
// byte 0 = b0 | b1 << 4 and byte 2 = b2 | b3 << 4 in uint8, then bytes
// 0 and 2 of each word side by side.
__device__ __forceinline__ unsigned pack_words(unsigned a, unsigned b) {
  a = (a & 0x00FF00FFu) | ((a >> 4) & 0x00F000F0u);
  b = (b & 0x00FF00FFu) | ((b >> 4) & 0x00F000F0u);
  return __byte_perm(a, b, 0x6420);
}

__device__ __forceinline__ uint8_t pack_pair(unsigned lo, unsigned hi) {
  return (uint8_t)(lo | (hi << 4));
}

// The wire byte of one value: a uint8 wire byte as it is; a count as
// (counts + T).to(torch.uint8) makes it.
__device__ __forceinline__ unsigned wire_byte(uint8_t v, float) { return v; }
template <typename X>
__device__ __forceinline__ unsigned wire_byte(X c, float T) {
  float v = repro::to_f32(c) + T;
  if constexpr (sizeof(X) == 2) v = __bfloat162float(__float2bfloat16_rn(v));
  return (uint8_t)(long long)v;
}

// in [2 n_out] values of X -> out [n_out] packed bytes. A thread takes
// 16 bytes of input, kIn values, and writes kIn / 2 bytes.
template <typename X>
__global__ void __launch_bounds__(kPackThreads) pack4_kernel(
    const X* __restrict__ in, uint8_t* __restrict__ out, long n_out,
    float T, bool vec) {
  constexpr int kIn = 16 / sizeof(X);
  constexpr int kOut = kIn / 2;
  const long o = kOut * ((long)blockIdx.x * kPackThreads + threadIdx.x);
  if (o >= n_out) return;
  if (vec && o + kOut <= n_out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(in + 2 * o);
    unsigned w[kIn / 4];                 // wire bytes, four to a word
    if constexpr (sizeof(X) == 1) {
      w[0] = raw.x; w[1] = raw.y; w[2] = raw.z; w[3] = raw.w;
    } else {
      const X* v = reinterpret_cast<const X*>(&raw);
#pragma unroll
      for (int i = 0; i < kIn / 4; ++i)
        w[i] = wire_byte(v[4 * i], T) | wire_byte(v[4 * i + 1], T) << 8 |
               wire_byte(v[4 * i + 2], T) << 16 |
               wire_byte(v[4 * i + 3], T) << 24;
    }
    if constexpr (kOut == 8)
      *reinterpret_cast<uint2*>(out + o) =
          make_uint2(pack_words(w[0], w[1]), pack_words(w[2], w[3]));
    else if constexpr (kOut == 4)
      *reinterpret_cast<unsigned*>(out + o) = pack_words(w[0], w[1]);
    else
      *reinterpret_cast<uint16_t*>(out + o) = (uint16_t)pack_words(w[0], 0);
    return;
  }
  for (long k = o; k < o + kOut && k < n_out; ++k)
    out[k] = pack_pair(wire_byte(in[2 * k], T), wire_byte(in[2 * k + 1], T));
}

// One thread per input byte.
__global__ void __launch_bounds__(kThreads) unpack4_kernel(
    const uint8_t* __restrict__ in, uint8_t* __restrict__ out, long n_in) {
  long k = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n_in) return;
  const unsigned v = in[k];
  out[2 * k] = (uint8_t)(v & 0xFu);
  out[2 * k + 1] = (uint8_t)((v >> 4) & 0xFu);
}

unsigned blocks_for(long n, int threads = kThreads) {
  return (unsigned)((n + threads - 1) / threads);
}

bool aligned(const void* p, unsigned bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename X>
int launch_pack(const X* in, uint8_t* out, long n_out, float T,
                cudaStream_t stream) {
  constexpr int kOut = 8 / sizeof(X);
  const bool vec = aligned(in, 16) && aligned(out, kOut);
  pack4_kernel<X><<<blocks_for((n_out + kOut - 1) / kOut, kPackThreads),
                    kPackThreads, 0, stream>>>(in, out, n_out, T, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// in [n_out * 2] uint8 -> out [n_out] uint8. Returns cudaGetLastError().
extern "C" int pack4_launch(const uint8_t* in, uint8_t* out, long n_out,
                            cudaStream_t stream) {
  return launch_pack(in, out, n_out, 0.0f, stream);
}

// counts [n_out * 2] f32 (bf16 = 0) or bf16 (bf16 = 1) -> out [n_out]
// uint8, the packed wire bytes of (counts + T). Returns
// cudaGetLastError().
extern "C" int pack4_counts_launch(const void* in, uint8_t* out, long n_out,
                                   int T, int bf16, cudaStream_t stream) {
  if (bf16)
    return launch_pack(static_cast<const __nv_bfloat16*>(in), out, n_out,
                       (float)T, stream);
  return launch_pack(static_cast<const float*>(in), out, n_out, (float)T,
                     stream);
}

// in [n_in] uint8 -> out [n_in * 2] uint8. Returns cudaGetLastError().
extern "C" int unpack4_launch(const uint8_t* in, uint8_t* out, long n_in,
                              cudaStream_t stream) {
  unpack4_kernel<<<blocks_for(n_in), kThreads, 0, stream>>>(in, out, n_in);
  return (int)cudaGetLastError();
}
