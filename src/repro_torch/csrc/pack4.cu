// 4-bit two-per-byte pack and unpack of the spike wire for Hopper
// (sm_90a): uint8 [M, C] (C even) <-> uint8 [M, C/2], with
// out[k] = v[2k] | v[2k+1] << 4 along the last axis; the pack fused
// with the wire's bias, signed counts [M, C] (f32 or bf16) -> the packed
// bytes of uint8(counts + T); and the unpack fused with the wire's
// unbias and the rate decode, packed bytes [M, C/2] -> (nibble - T) *
// decode_scale[c] in f32 or bf16.
//
// Replaces the TPU kernels `pack4_pallas` / `_pack4_kernel` and
// `unpack4_pallas` / `_unpack4_kernel` (src/repro/kernels/pack4.py).
// Plain versions and wrappers: src/repro_torch/kernels/pack4.py. Bound
// with ctypes through the plain C functions `pack4_launch`,
// `pack4_counts_launch`, `unpack4_launch` and `unpack4_decode_launch` at
// the bottom of this file.
//
// With C even and rows contiguous, the pairs of the last axis are the
// pairs of the flat array, so every kernel walks the flat bytes. Values
// are combined exactly as the oracle does in uint8 (`hi << 4` drops
// hi's high bits, `lo` is not masked), so every byte value, not only
// those below 16, gives the oracle's result; the unpack takes every
// byte value apart. A count becomes its wire byte as PyTorch's
// `(counts + T).to(torch.uint8)` makes it: the sum in the counts' dtype
// (rounded to bf16 for bf16 counts), then through int64 to uint8. A
// nibble becomes its decoded value as `(nibble.to(dtype) - T) *
// decode_scale` does in PyTorch: the difference (an integer, exact in
// the output dtype for T <= 127), then one IEEE multiply rounded once to
// it (a product of two bf16 values is exact in f32). Both are written
// as __fsub_rn / __fmul_rn, so no contraction can change a rounding;
// never build with --use_fast_math.
//
// What bounds them: memory — n bytes one way, n/2 the other (4n or 2n
// bytes of counts in, 8n or 4n bytes of decoded values out), no
// arithmetic to speak of; at the decode rows, [4, 1024], the launch
// itself. Each thread of a pack makes one 16-byte load (16 wire bytes,
// or 4 f32 or 8 bf16 counts), combines the pairs four bytes at a time
// in 32-bit lanes, and makes one store of 8, 2 or 4 bytes. The unpacks
// are the reverse: a thread loads one aligned word of packed bytes (8
// for the uint8 unpack, 4 for the decode), spreads each word's nibbles
// into 8 bytes with `__byte_perm` and masks, and stores 16 bytes (the
// decode: the 8 values' 32 or 16 bytes, beside one 32- or 16-byte load
// of their 8 decode factors). Blocks of 128 threads spread [256, 1024]
// over the SMs. A buffer that is not aligned for those accesses, a
// channel count the decode's 8 values a thread do not divide, and the
// last thread's ragged end take byte loads and scalar stores.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;

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
__global__ void __launch_bounds__(kThreads) pack4_kernel(
    const X* __restrict__ in, uint8_t* __restrict__ out, long n_out,
    float T, bool vec) {
  constexpr int kIn = 16 / sizeof(X);
  constexpr int kOut = kIn / 2;
  const long o = kOut * ((long)blockIdx.x * kThreads + threadIdx.x);
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

// Four packed bytes -> their eight nibbles, one a byte, low nibble
// first: the inverse of pack_words. Bytes 0 and 1 of `w` fill the first
// word, bytes 2 and 3 the second; each byte is doubled, then the low
// copy keeps its low nibble and the high copy its high one.
__device__ __forceinline__ uint2 unpack_word(unsigned w) {
  const unsigned a = __byte_perm(w, 0, 0x1100);
  const unsigned b = __byte_perm(w, 0, 0x3322);
  return make_uint2((a & 0x000F000Fu) | ((a >> 4) & 0x0F000F00u),
                    (b & 0x000F000Fu) | ((b >> 4) & 0x0F000F00u));
}

// in [n_in] packed bytes -> out [2 n_in] nibbles. A thread takes 8
// bytes of input and writes 16.
__global__ void __launch_bounds__(kThreads) unpack4_kernel(
    const uint8_t* __restrict__ in, uint8_t* __restrict__ out, long n_in,
    bool vec) {
  const long k = 8 * ((long)blockIdx.x * kThreads + threadIdx.x);
  if (k >= n_in) return;
  if (vec && k + 8 <= n_in) {
    const uint2 w = *reinterpret_cast<const uint2*>(in + k);
    const uint2 lo = unpack_word(w.x), hi = unpack_word(w.y);
    *reinterpret_cast<uint4*>(out + 2 * k) =
        make_uint4(lo.x, lo.y, hi.x, hi.y);
    return;
  }
  for (long i = k; i < k + 8 && i < n_in; ++i) {
    const unsigned v = in[i];
    out[2 * i] = (uint8_t)(v & 0xFu);
    out[2 * i + 1] = (uint8_t)((v >> 4) & 0xFu);
  }
}

// The decoded value of one nibble: (nibble - T), an integer in
// [-127, 15] and so exact in f32 and in bf16, times the decode factor,
// rounded once to the output type by the store.
__device__ __forceinline__ float decoded(unsigned nibble, float T,
                                         float dscale) {
  return __fmul_rn(__fsub_rn((float)nibble, T), dscale);
}

// 8 values of Y at a 16-byte aligned address, as f32 (a bf16 value is
// the high half of its f32), and back, each rounded once to Y.
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}
__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ unsigned bf16_pair(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]),
                 bf16_pair(v[4], v[5]), bf16_pair(v[6], v[7]));
}

// in [n_in] packed bytes -> out [2 n_in] values of Y, the channel of
// out[i] being i % C (C even, so a byte's two nibbles share a row). A
// thread takes 4 bytes of input and writes 8 values, all of one row
// when C % 8 == 0.
template <typename Y>
__global__ void __launch_bounds__(kThreads) unpack4_decode_kernel(
    const uint8_t* __restrict__ in, const Y* __restrict__ dscale,
    Y* __restrict__ out, long n_in, int C, float T, bool vec) {
  const long k = 4 * ((long)blockIdx.x * kThreads + threadIdx.x);
  if (k >= n_in) return;
  if (vec && k + 4 <= n_in) {
    const unsigned w = *reinterpret_cast<const unsigned*>(in + k);
    const int c0 = (int)((2 * k) % C);
    float ds[8], y[8];
    load8(dscale + c0, ds);
    const uint2 nib = unpack_word(w);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      y[i] = decoded(((i < 4 ? nib.x : nib.y) >> (8 * (i % 4))) & 0xFu, T,
                     ds[i]);
    store8(out + 2 * k, y);
    return;
  }
  for (long i = k; i < k + 4 && i < n_in; ++i) {
    const unsigned v = in[i];
    const int c = (int)((2 * i) % C);
    repro::store(out + 2 * i,
                 decoded(v & 0xFu, T, repro::to_f32(dscale[c])));
    repro::store(out + 2 * i + 1,
                 decoded((v >> 4) & 0xFu, T, repro::to_f32(dscale[c + 1])));
  }
}

unsigned blocks_for(long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

bool aligned(const void* p, unsigned bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename X>
int launch_pack(const X* in, uint8_t* out, long n_out, float T,
                cudaStream_t stream) {
  constexpr int kOut = 8 / sizeof(X);
  const bool vec = aligned(in, 16) && aligned(out, kOut);
  pack4_kernel<X><<<blocks_for((n_out + kOut - 1) / kOut),
                    kThreads, 0, stream>>>(in, out, n_out, T, vec);
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
  const bool vec = aligned(in, 8) && aligned(out, 16);
  unpack4_kernel<<<blocks_for((n_in + 7) / 8), kThreads, 0, stream>>>(
      in, out, n_in, vec);
  return (int)cudaGetLastError();
}

// in [n_in] uint8, the packed rows of C / 2 bytes -> out [n_in * 2]
// f32 (bf16 = 0) or bf16 (bf16 = 1), (nibble - T) * dscale[c] with
// dscale [C] in out's dtype. Returns cudaGetLastError().
extern "C" int unpack4_decode_launch(const uint8_t* in, void* out, long n_in,
                                     const void* dscale, int C, int T,
                                     int bf16, cudaStream_t stream) {
  const unsigned blocks = blocks_for((n_in + 3) / 4);
  const bool vec = C % 8 == 0 && aligned(in, 4) && aligned(out, 16) &&
                   aligned(dscale, 16);
  if (bf16)
    unpack4_decode_kernel<<<blocks, kThreads, 0, stream>>>(
        in, static_cast<const __nv_bfloat16*>(dscale),
        static_cast<__nv_bfloat16*>(out), n_in, C, (float)T, vec);
  else
    unpack4_decode_kernel<<<blocks, kThreads, 0, stream>>>(
        in, static_cast<const float*>(dscale), static_cast<float*>(out),
        n_in, C, (float)T, vec);
  return (int)cudaGetLastError();
}
