// Paged-decode attention for Hopper (sm_90a): one pass over a slot's
// compacted page list — page gather, online-softmax flash decode over
// K1 >= 1 query tokens, locally normalised partial + LSE, and an
// optional int8 absmax epilogue that writes the coded combine's wire.
//
// Replaces the TPU kernel `paged_decode_pallas` / `_paged_decode_kernel`
// (src/repro/kernels/paged_decode.py). Plain version and wrapper:
// src/repro_torch/kernels/paged_decode.py. Bound with ctypes through the
// plain C function `paged_decode_launch` at the bottom of this file.
//
// Grid (slot, kv head). A block serves the g = Hq/Hkv query heads of its
// kv head for all K1 query tokens (nq = K1*g rows), so the g heads of a
// GQA group share every staged page. The block walks the slot's list in
// order, reading cl_page/cl_pos itself; per page it stages that kv
// head's K and V rows in shared memory (converted to f32), scores them,
// and folds them into a running max m, normaliser l and accumulator acc,
// all f32 in shared memory.
//
// Sentinel arithmetic is the oracle's (`ref.paged_decode_ref`): a -1
// list entry reads page 0 with every entry masked, masked scores are
// -1e30 (not -inf) and m starts at -1e30, so an all -1 row yields the
// oracle's finite uniform mean of page 0's V and lse == -1e30. Rows are
// never skipped. Rounding in the epilogue is rintf (half to even), as
// jnp.round.
//
// What bounds it: the K/V bytes of the live pages, read once, plus q
// and the outputs — decode attention does ~1 FLOP per byte, far below
// the card's ridge point. This first version stages one page at a time
// with plain loads and no overlap of copy and compute; a page ring with
// cp.async/TMA, more query rows per block and split-K over long lists
// are the later steps toward that bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const float* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ cl_page,
    const int* __restrict__ cl_pos, const int* __restrict__ qpos,
    float* __restrict__ o_out, int8_t* __restrict__ wire_out,
    float* __restrict__ scale_out, float* __restrict__ lse_out, int K1,
    int Hq, int Hkv, int dh, int P_loc, int psz, int ppc, int window,
    float cap, float sm_scale, int encode_wire) {
  const int b = blockIdx.x;
  const int h = blockIdx.y;            // kv head
  const int g = Hq / Hkv;              // query heads per kv head
  const int nq = K1 * g;               // query rows of this block
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  extern __shared__ float smem[];
  float* k_s = smem;                   // [psz][dh]
  float* v_s = k_s + psz * dh;         // [psz][dh]
  float* q_s = v_s + psz * dh;         // [nq][dh]
  float* acc_s = q_s + nq * dh;        // [nq][dh]
  float* p_s = acc_s + nq * dh;        // [nq][psz] scores, then probs
  float* m_s = p_s + nq * psz;         // [nq] running max
  float* l_s = m_s + nq;               // [nq] running normaliser
  float* a_s = l_s + nq;               // [nq] this page's rescale
  int* qp_s = reinterpret_cast<int*>(a_s + nq);  // [K1]

  // row r <-> (query token r / g, query head h*g + r % g)
  for (int i = tid; i < nq * dh; i += blockDim.x) {
    const int r = i / dh, d = i % dh;
    const int qh = h * g + r % g;
    q_s[i] = q[((size_t)(b * K1 + r / g) * Hq + qh) * dh + d];
    acc_s[i] = 0.f;
  }
  for (int r = tid; r < nq; r += blockDim.x) {
    m_s[r] = kNeg;
    l_s[r] = 0.f;
  }
  for (int i = tid; i < K1; i += blockDim.x) qp_s[i] = qpos[b * K1 + i];
  __syncthreads();

  for (int c = 0; c < ppc; ++c) {
    const int row = cl_page[b * ppc + c];
    const bool valid = row >= 0 && row < P_loc;
    const int safe = valid ? row : 0;
    const int base = cl_pos[b * ppc + c];

    // 1. stage kv head h of the page
    const size_t page_off = (size_t)safe * psz * Hkv * dh;
    for (int i = tid; i < psz * dh; i += blockDim.x) {
      const int t = i / dh, d = i % dh;
      const size_t off = page_off + ((size_t)t * Hkv + h) * dh + d;
      k_s[i] = to_f32(k_pool[off]);
      v_s[i] = to_f32(v_pool[off]);
    }
    __syncthreads();

    // 2. scaled, capped, masked scores
    for (int i = tid; i < nq * psz; i += blockDim.x) {
      const int r = i / psz, t = i % psz;
      const float* qr = q_s + r * dh;
      const float* kt = k_s + t * dh;
      float s = 0.f;
      for (int d = 0; d < dh; ++d) s = fmaf(qr[d], kt[d], s);
      s *= sm_scale;
      if (cap != 0.f) s = cap * tanhf(s / cap);
      const int kp = base + t;
      const int qp = qp_s[r / g];
      const bool ok = valid && kp <= qp && (window == 0 || qp - kp < window);
      p_s[i] = ok ? s : kNeg;
    }
    __syncthreads();

    // 3. online-softmax statistics, one warp per row
    for (int r = warp; r < nq; r += nwarps) {
      float mx = kNeg;
      for (int t = lane; t < psz; t += 32) mx = fmaxf(mx, p_s[r * psz + t]);
      mx = warp_max(mx);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < psz; t += 32) {
        const float p = expf(p_s[r * psz + t] - m_new);
        p_s[r * psz + t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // 4. rescale the accumulator and add P V
    for (int i = tid; i < nq * dh; i += blockDim.x) {
      const int r = i / dh, d = i % dh;
      const float* pr = p_s + r * psz;
      float acc = acc_s[i] * a_s[r];
      for (int t = 0; t < psz; ++t) acc = fmaf(pr[t], v_s[t * dh + d], acc);
      acc_s[i] = acc;
    }
    __syncthreads();
  }

  // epilogue: normalise, lse, and either the f32 partial or its int8 wire
  for (int r = warp; r < nq; r += nwarps) {
    const size_t orow = (size_t)(b * K1 + r / g) * Hq + h * g + r % g;
    const float l = fmaxf(l_s[r], 1e-30f);
    const float* ar = acc_s + r * dh;
    if (lane == 0) lse_out[orow] = m_s[r] + logf(l);
    if (encode_wire) {
      float amax = 0.f;
      for (int d = lane; d < dh; d += 32) amax = fmaxf(amax, fabsf(ar[d] / l));
      amax = warp_max(amax);
      const float s = fmaxf(amax, 1e-6f) / 127.f;
      for (int d = lane; d < dh; d += 32)
        wire_out[orow * dh + d] = (int8_t)rintf((ar[d] / l) / s);
      if (lane == 0) scale_out[orow] = s;
    } else {
      for (int d = lane; d < dh; d += 32) o_out[orow * dh + d] = ar[d] / l;
    }
  }
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* cl_page, const void* cl_pos, const void* qpos,
           void* o, void* wire, void* wscale, void* lse, int B, int K1,
           int Hq, int Hkv, int dh, int P_loc, int psz, int ppc, int window,
           float cap, float sm_scale, int encode_wire, void* stream) {
  const int nq = K1 * (Hq / Hkv);
  const size_t smem =
      sizeof(float) * ((size_t)2 * psz * dh + (size_t)2 * nq * dh +
                       (size_t)nq * psz + (size_t)3 * nq) +
      sizeof(int) * (size_t)K1;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(B, Hkv);
  paged_decode_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(cl_page),
      static_cast<const int*>(cl_pos), static_cast<const int*>(qpos),
      static_cast<float*>(o), static_cast<int8_t*>(wire),
      static_cast<float*>(wscale), static_cast<float*>(lse), K1, Hq, Hkv, dh,
      P_loc, psz, ppc, window, cap, sm_scale, encode_wire);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched). The caller
// validated shapes, dtypes, devices and contiguity; o is unused when
// encode_wire != 0, wire and wscale are unused when it is 0.
extern "C" int paged_decode_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* cl_page, const void* cl_pos, const void* qpos, void* o,
    void* wire, void* wscale, void* lse, int B, int K1, int Hq, int Hkv,
    int dh, int P_loc, int psz, int ppc, int window, float cap,
    float sm_scale, int encode_wire, int pool_bf16, void* stream) {
  if (B <= 0 || K1 <= 0 || Hkv <= 0 || Hq % Hkv != 0 || dh <= 0 ||
      psz <= 0 || ppc < 0 || P_loc <= 0)
    return (int)cudaErrorInvalidValue;
  if (pool_bf16)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, cl_page, cl_pos, qpos, o,
                                 wire, wscale, lse, B, K1, Hq, Hkv, dh, P_loc,
                                 psz, ppc, window, cap, sm_scale, encode_wire,
                                 stream);
  return launch<float>(q, k_pool, v_pool, cl_page, cl_pos, qpos, o, wire,
                       wscale, lse, B, K1, Hq, Hkv, dh, P_loc, psz, ppc,
                       window, cap, sm_scale, encode_wire, stream);
}
