// Spike-count matmul with the rate decode fused, for Hopper (sm_90a):
//   y[m, n] = sum_k  c[m, k] * (scale[k] * f32(1/T)) * W[k, n]
// int8 counts c [M, K] straight off the wire, W [K, N] f32 or bf16,
// scale [K] f32; f32 accumulation, one rounding to the output type
// (f32 or bf16) at the end.
//
// Replaces the TPU kernel `count_matmul_pallas` / `_count_matmul_kernel`
// (src/repro/kernels/count_matmul.py). Plain version and wrapper:
// src/repro_torch/kernels/count_matmul.py. Bound with ctypes through the
// plain C function `count_matmul_launch` at the bottom of this file.
//
// As the TPU kernel computes it: the decode scale of channel k is
// scale[k] * inv_T with inv_T = f32(1/T) (not scale[k] / T; the two
// differ in the last place), the decoded activation is f32(c) times that
// scale, rounded to f32, and the product with W is summed in f32 over K.
// The decoded activations never reach device memory.
//
// Design (simple first): one block per BM x BN output tile; K walks in
// steps of BK = 32 through shared memory. Each step the block decodes a
// BM x BK tile of counts into f32 activations (stored k-major, rows
// padded by one float so that neither the stores nor the reads conflict
// on a bank) and converts a BK x BN tile of W to f32; each thread then
// accumulates TM x TN outputs with f32 FMAs on the CUDA cores, its
// columns strided by BN / TN so that a warp reads consecutive words.
// Ragged M, K and N are bounds-checked: out-of-range activations and
// weights load as 0 and out-of-range outputs are not stored, which gives
// the JAX wrapper's zero padding. Two tile shapes: 64 x 64 (4 x 4 a
// thread) in general, 16 x 32 (1 x 2 a thread) for M <= 16, so that a
// decode batch of a few rows still spreads W over more blocks. No
// library call, no tensor cores, no TF32.
//
// What bounds it: at the decode shape (M = 4) memory — W is read once,
// 2 bytes an element in bf16, and there are only 8 operations per W
// element; at the prefill shape (M = 256) the 2 M K N operations at the
// card's f32 rate outside the tensor cores. This design re-reads each W
// tile once per row block and does one shared-memory load per FMA
// pair, far from either bound; wgmma on bf16 tiles fed by TMA (the
// counts are exact in bf16, the decode scale can move to W's rows or to
// an f32 epilogue) is the later step.
//
// Exactness: no --use_fast_math; the decode products use __fmul_rn, so
// no contraction can fold them into the accumulation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBK = 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <int BM, int BN, int TM, int TN, typename W, typename O>
__global__ void __launch_bounds__((BM / TM) * (BN / TN)) count_matmul_kernel(
    const int8_t* __restrict__ c, const W* __restrict__ w,
    const float* __restrict__ scale, O* __restrict__ out, int M, int K,
    int N, float inv_T) {
  constexpr int kCols = BN / TN;            // thread columns
  constexpr int kRows = BM / TM;            // thread rows
  constexpr int kThreads = kCols * kRows;
  __shared__ float a_s[kBK][BM + 1];        // decoded counts, k-major
  __shared__ float w_s[kBK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % kCols, ty = tid / kCols;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // counts tile: consecutive threads read consecutive k of one row
    for (int idx = tid; idx < BM * kBK; idx += kThreads) {
      const int mm = idx / kBK, kk = idx % kBK;
      const int m = m0 + mm, k = k0 + kk;
      float a = 0.0f;
      if (m < M && k < K)
        a = __fmul_rn((float)c[(long)m * K + k], __fmul_rn(scale[k], inv_T));
      a_s[kk][mm] = a;
    }
    // weight tile: consecutive threads read consecutive n of one row
    for (int idx = tid; idx < kBK * BN; idx += kThreads) {
      const int kk = idx / BN, nn = idx % BN;
      const int k = k0 + kk, n = n0 + nn;
      w_s[kk][nn] = (k < K && n < N) ? to_f32(w[(long)k * N + n]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = a_s[kk][ty + i * kRows];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = w_s[kk][tx + j * kCols];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + i * kRows;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + j * kCols;
      if (n < N) store(&out[(long)m * N + n], acc[i][j]);
    }
  }
}

template <int BM, int BN, int TM, int TN, typename W, typename O>
void launch(const int8_t* c, const void* w, const float* scale, void* out,
            int M, int K, int N, float inv_T, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  count_matmul_kernel<BM, BN, TM, TN, W, O>
      <<<grid, (BM / TM) * (BN / TN), 0, stream>>>(
          c, static_cast<const W*>(w), scale, static_cast<O*>(out), M, K, N,
          inv_T);
}

template <typename W, typename O>
void launch_tiles(const int8_t* c, const void* w, const float* scale,
                  void* out, int M, int K, int N, float inv_T,
                  cudaStream_t stream) {
  if (M <= 16)
    launch<16, 32, 1, 2, W, O>(c, w, scale, out, M, K, N, inv_T, stream);
  else
    launch<64, 64, 4, 4, W, O>(c, w, scale, out, M, K, N, inv_T, stream);
}

}  // namespace

// counts [M, K] int8; w [K, N] f32 (w_bf16 = 0) or bf16 (w_bf16 = 1);
// scale [K] f32; out [M, N] f32 (out_bf16 = 0) or bf16 (out_bf16 = 1);
// inv_T = f32(1/T). All row-major and contiguous. Launches on `stream`;
// returns cudaGetLastError().
extern "C" int count_matmul_launch(const int8_t* counts, const void* w,
                                   const float* scale, void* out, int M,
                                   int K, int N, float inv_T, int w_bf16,
                                   int out_bf16, cudaStream_t stream) {
  if (w_bf16 && out_bf16)
    launch_tiles<__nv_bfloat16, __nv_bfloat16>(counts, w, scale, out, M, K,
                                               N, inv_T, stream);
  else if (w_bf16)
    launch_tiles<__nv_bfloat16, float>(counts, w, scale, out, M, K, N,
                                       inv_T, stream);
  else if (out_bf16)
    launch_tiles<float, __nv_bfloat16>(counts, w, scale, out, M, K, N,
                                       inv_T, stream);
  else
    launch_tiles<float, float>(counts, w, scale, out, M, K, N, inv_T,
                               stream);
  return (int)cudaGetLastError();
}
