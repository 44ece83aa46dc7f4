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
// What bounds it: the K/V bytes of the live pages, read once, plus q and
// the outputs — decode attention does ~1 operation per byte, far below
// the card's ridge point. At the serve shape that is ~1.4 MB, under a
// microsecond, so what the kernel can win is latency: how few dependent
// trips to memory stand between launch and the last store.
//
// Design. Grid (slot, kv head, row group). The nq = K1*g query rows of a
// kv head (its g = Hq/Hkv query heads for all K1 query tokens) are split
// into row groups of at most kRowCap rows, and a block serves one group,
// so the rows of a group share every staged page and q, acc, p and m/l
// scale with the rows of one block, not with the whole GQA group: an MQA
// verify step (48 heads on one kv head, 192 rows) runs as 24 blocks of 8
// rows per slot instead of one block that does not fit. Where B x Hkv
// blocks leave SMs idle, the groups are halved while the grid still fits
// one block per SM (gemma2-2b's 4 slots x 4 kv heads run 128 blocks of
// one row at K1 = 4), and fewer rows a group are taken where a group
// does not fit shared memory. A row's arithmetic does not depend on its
// group: the groups only change which block computes it.
// 1. The block reads the slot's list and query positions once, in the
//    same round of loads as its queries, and keeps only the entries that
//    hold a key some query may see (a valid pool row with a position
//    inside the causal window of some query token). -1 entries and
//    wholly masked pages are skipped: for a row that has seen a valid
//    key (m > -1e30) such a page gives alpha = expf(0) = 1 and p = 0, so
//    skipping it leaves m, l and acc bit for bit as they were. Only
//    when some query token sees no key at all (an evicted slot, all -1)
//    does the block walk every entry as the oracle does — a -1 entry
//    reads page 0 fully masked, masked scores are -1e30 and m starts at
//    -1e30 — which yields the oracle's uniform mean of page 0 and
//    lse == -1e30. Rows are never dropped.
// 2. The kept entries are dealt to the block's warps in turn: as many
//    warps as fit shared memory, up to 8 (3 for f32 pages at dh 256).
//    Each warp streams its pages through a 2-stage cp.async ring in its
//    own shared memory (16-byte copies where the rows allow), so the
//    next page loads while this one is scored, and keeps its own running
//    max m, normaliser l and accumulator acc per row, all f32. Scoring
//    gives each lane a key and walks the row in 4-element chunks rotated
//    by the lane (no bank conflict); P.V gives each lane two dims.
// 3. The warps' (m, l, acc) are combined in warp order — m = max, then
//    l and acc rescaled by expf(m_w - m) — so two launches give the same
//    bits. Rounding in the epilogue is rintf (half to even), as
//    jnp.round.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using repro::warp_max;
using repro::warp_sum;

constexpr float kNeg = -1e30f;
constexpr int kMaxWarps = 8;
constexpr int kRowCap = 8;  // query rows of one block, at most
constexpr size_t kSmemLimit = 227 * 1024;

__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) & ~(size_t)15;
}

// Byte offsets of one block's shared memory, the same on host and device.
struct Layout {
  size_t q, kv, acc, p, ml, ent, total;
  // nq: the query rows of one block (one row group)
  __host__ __device__ Layout(int nw, int nq, int K1, int dh, int psz,
                             int ppc, int elem) {
    size_t o = 0;
    q = o;    // [nq][dh] f32 queries
    o += align16((size_t)nq * dh * 4);
    kv = o;   // per warp [2 stages][K, V][psz][dh], the pool's type
    o += align16((size_t)nw * 4 * psz * dh * elem);
    acc = o;  // per warp [nq][dh] f32
    o += align16((size_t)nw * nq * dh * 4);
    p = o;    // per warp [nq][psz] f32 scores, then probabilities
    o += align16((size_t)nw * nq * psz * 4);
    ml = o;   // per warp [m | l][nq] f32
    o += align16((size_t)nw * 2 * nq * 4);
    ent = o;  // [ppc] rows, positions, live flags, kept list; [K1] qpos,
              // has-key flags; the kept list's length
    o += align16((size_t)(4 * ppc + 2 * K1 + 1) * 4);
    total = o;
  }
};

__device__ __forceinline__ void load4(const float* p, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&f)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  f[0] = __uint_as_float(u.x << 16); f[1] = __uint_as_float(u.x & 0xffff0000u);
  f[2] = __uint_as_float(u.y << 16); f[3] = __uint_as_float(u.y & 0xffff0000u);
}
__device__ __forceinline__ void load2(const float* p, float (&f)[2]) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  f[0] = v.x; f[1] = v.y;
}
__device__ __forceinline__ void load2(const __nv_bfloat16* p, float (&f)[2]) {
  const unsigned u = *reinterpret_cast<const unsigned*>(p);
  f[0] = __uint_as_float(u << 16); f[1] = __uint_as_float(u & 0xffff0000u);
}

// T: pool element type; CP: bytes per cp.async (16, or 4 where the rows
// are not 16-byte multiples)
template <typename T, int CP>
__global__ void __launch_bounds__(kMaxWarps * 32) paged_decode_kernel(
    const float* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ cl_page,
    const int* __restrict__ cl_pos, const int* __restrict__ qpos,
    float* __restrict__ o_out, int8_t* __restrict__ wire_out,
    float* __restrict__ scale_out, float* __restrict__ lse_out, int K1,
    int Hq, int Hkv, int dh, int P_loc, int psz, int ppc, int window,
    float cap, float sm_scale, int encode_wire, int rpb) {
  const int b = blockIdx.x;
  const int h = blockIdx.y;            // kv head
  const int g = Hq / Hkv;              // query heads per kv head
  // this block's rows r0 .. r0 + nq - 1 of the kv head's K1 * g; local
  // row r is global row r0 + r <-> query token (r0 + r) / g, head
  // h * g + (r0 + r) % g
  const int r0 = blockIdx.z * rpb;
  const int nq = min(rpb, K1 * g - r0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;

  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(nw, rpb, K1, dh, psz, ppc, (int)sizeof(T));
  float* q_s = reinterpret_cast<float*>(smem + L.q);
  T* kv_w = reinterpret_cast<T*>(smem + L.kv) + (size_t)warp * 4 * psz * dh;
  float* acc_all = reinterpret_cast<float*>(smem + L.acc);
  float* acc_w = acc_all + (size_t)warp * nq * dh;
  float* p_w = reinterpret_cast<float*>(smem + L.p) + (size_t)warp * nq * psz;
  float* ml_all = reinterpret_cast<float*>(smem + L.ml);
  float* m_w = ml_all + warp * 2 * nq;
  float* l_w = m_w + nq;
  int* ent_row = reinterpret_cast<int*>(smem + L.ent);  // -1 = no page
  int* ent_pos = ent_row + ppc;
  int* ent_live = ent_pos + ppc;
  int* kept = ent_live + ppc;
  int* qp_s = kept + ppc;
  int* hk_s = qp_s + K1;
  int* nkept_s = hk_s + K1;

  // 1. queries, state, positions and the list, all loads issued
  //    together; then which entries hold a key some query token may see
  for (int i = tid; i < nq * dh; i += blockDim.x) {
    const int r = r0 + i / dh, d = i % dh;
    q_s[i] = q[((size_t)(b * K1 + r / g) * Hq + h * g + r % g) * dh + d];
  }
  for (int c = tid; c < ppc; c += blockDim.x) {
    ent_row[c] = cl_page[b * ppc + c];
    ent_pos[c] = cl_pos[b * ppc + c];
  }
  for (int i = tid; i < nw * nq * dh; i += blockDim.x) acc_all[i] = 0.f;
  for (int i = tid; i < nw * nq; i += blockDim.x) {
    ml_all[(i / nq) * 2 * nq + i % nq] = kNeg;
    ml_all[(i / nq) * 2 * nq + nq + i % nq] = 0.f;
  }
  for (int i = tid; i < K1; i += blockDim.x) {
    qp_s[i] = qpos[b * K1 + i];
    hk_s[i] = 0;
  }
  __syncthreads();
  for (int c = tid; c < ppc; c += blockDim.x) {
    const int row = ent_row[c];
    const int base = ent_pos[c];
    const bool valid = row >= 0 && row < P_loc;
    int live = 0;
    for (int i = 0; i < K1 && valid; ++i) {
      // the latest key a query at qp may see in this page
      const int qp = qp_s[i];
      const int kmax = min(base + psz - 1, qp);
      if (kmax >= base && (window == 0 || qp - kmax < window)) {
        live = 1;
        hk_s[i] = 1;
      }
    }
    ent_row[c] = valid ? row : -1;
    ent_live[c] = live;
  }
  __syncthreads();
  if (warp == 0) {
    bool every = true;  // every query token sees some key
    for (int i = 0; i < K1; ++i) every = every && hk_s[i] != 0;
    int n = 0;
    for (int c0 = 0; c0 < ppc; c0 += 32) {
      const int c = c0 + lane;
      const bool take = c < ppc && (!every || ent_live[c]);
      const unsigned ball = __ballot_sync(0xffffffffu, take);
      if (take) kept[n + __popc(ball & ((1u << lane) - 1u))] = c;
      n += __popc(ball);
    }
    if (lane == 0) *nkept_s = n;
  }
  __syncthreads();
  const int nkept = *nkept_s;

  // 2. this warp's pages through its 2-stage ring
  const int per_row = dh * (int)sizeof(T) / CP;  // copies per token row
  auto issue = [&](int j, int stage) {
    const int row = max(ent_row[kept[j]], 0);     // -1 reads page 0
    const size_t page = (size_t)row * psz * Hkv * dh;
    T* ks = kv_w + (size_t)stage * 2 * psz * dh;
    T* vs = ks + (size_t)psz * dh;
    for (int i = lane; i < psz * per_row; i += 32) {
      const int t = i / per_row, cc = i % per_row;
      const size_t src = page + ((size_t)t * Hkv + h) * dh;
      char* kd = reinterpret_cast<char*>(ks + (size_t)t * dh) + cc * CP;
      char* vd = reinterpret_cast<char*>(vs + (size_t)t * dh) + cc * CP;
      const char* kg = reinterpret_cast<const char*>(k_pool + src) + cc * CP;
      const char* vg = reinterpret_cast<const char*>(v_pool + src) + cc * CP;
      if (CP == 16) {
        repro::cp_async16(kd, kg, 16);
        repro::cp_async16(vd, vg, 16);
      } else {
        repro::cp_async4(kd, kg);
        repro::cp_async4(vd, vg);
      }
    }
  };
  auto process = [&](int c, int stage) {
    const T* ks = kv_w + (size_t)stage * 2 * psz * dh;
    const T* vs = ks + (size_t)psz * dh;
    const bool valid = ent_row[c] >= 0;
    const int base = ent_pos[c];
    const int nch = dh / 4;
    for (int r = 0; r < nq; ++r) {
      const int qp = qp_s[(r0 + r) / g];
      const float* qr = q_s + (size_t)r * dh;
      float* pr = p_w + (size_t)r * psz;
      // scaled, capped, masked scores: a lane per key
      float mx = kNeg;
      for (int t = lane; t < psz; t += 32) {
        const T* kt = ks + (size_t)t * dh;
        float s = 0.f;
        int ch = t % nch;
        for (int j = 0; j < nch; ++j) {
          float qv[4], kv[4];
          load4(qr + 4 * ch, qv);
          load4(kt + 4 * ch, kv);
          s = fmaf(qv[0], kv[0], s);
          s = fmaf(qv[1], kv[1], s);
          s = fmaf(qv[2], kv[2], s);
          s = fmaf(qv[3], kv[3], s);
          if (++ch == nch) ch = 0;
        }
        s *= sm_scale;
        if (cap != 0.f) s = cap * tanhf(s / cap);
        const int kp = base + t;
        const bool ok = valid && kp <= qp && (window == 0 || qp - kp < window);
        s = ok ? s : kNeg;
        pr[t] = s;
        mx = fmaxf(mx, s);
      }
      // online-softmax statistics
      mx = warp_max(mx);
      const float m_old = m_w[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < psz; t += 32) {
        const float p = expf(pr[t] - m_new);
        pr[t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      const float alpha = expf(m_old - m_new);
      __syncwarp();  // probabilities in; every lane has read m_old
      if (lane == 0) {
        m_w[r] = m_new;
        l_w[r] = l_w[r] * alpha + sum;
      }
      // rescale the accumulator and add P V: two dims a lane
      for (int d = 2 * lane; d < dh; d += 64) {
        float a0 = acc_w[(size_t)r * dh + d] * alpha;
        float a1 = acc_w[(size_t)r * dh + d + 1] * alpha;
        for (int t = 0; t < psz; ++t) {
          const float p = pr[t];
          float v[2];
          load2(vs + (size_t)t * dh + d, v);
          a0 = fmaf(p, v[0], a0);
          a1 = fmaf(p, v[1], a1);
        }
        acc_w[(size_t)r * dh + d] = a0;
        acc_w[(size_t)r * dh + d + 1] = a1;
      }
    }
  };

  int stage = 0;
  if (warp < nkept) issue(warp, 0);
  repro::cp_async_commit();
  for (int j = warp; j < nkept; j += nw, stage ^= 1) {
    if (j + nw < nkept) issue(j + nw, stage ^ 1);
    repro::cp_async_commit();
    repro::cp_async_wait<1>();  // this lane's copies of page j are in
    __syncwarp();               // and every lane's
    process(kept[j], stage);
    __syncwarp();               // the stage is free for page j + 2 nw
  }
  repro::cp_async_wait<0>();
  __syncthreads();

  // 3. combine the warps in order; normalise, lse, and either the f32
  //    partial or its int8 wire
  for (int r = warp; r < nq; r += nw) {
    float m = kNeg;
    for (int w = 0; w < nw; ++w) m = fmaxf(m, ml_all[w * 2 * nq + r]);
    float e[kMaxWarps];
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < kMaxWarps; ++w) {
      e[w] = w < nw ? expf(ml_all[w * 2 * nq + r] - m) : 0.f;
      if (w < nw) l += ml_all[w * 2 * nq + nq + r] * e[w];
    }
    l = fmaxf(l, 1e-30f);
    const int R = r0 + r;
    const size_t orow = (size_t)(b * K1 + R / g) * Hq + h * g + R % g;
    if (lane == 0) lse_out[orow] = m + logf(l);
    float* o_r = acc_all + (size_t)r * dh;  // warp 0's row r holds o
    float amax = 0.f;
    for (int d = lane; d < dh; d += 32) {
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < kMaxWarps; ++w)
        if (w < nw) a += acc_all[((size_t)w * nq + r) * dh + d] * e[w];
      const float o = a / l;
      amax = fmaxf(amax, fabsf(o));
      if (encode_wire)
        o_r[d] = o;
      else
        o_out[orow * dh + d] = o;
    }
    if (encode_wire) {
      amax = warp_max(amax);
      const float s = fmaxf(amax, 1e-6f) / 127.f;
      for (int d = lane; d < dh; d += 32)
        wire_out[orow * dh + d] = (int8_t)rintf(o_r[d] / s);
      if (lane == 0) scale_out[orow] = s;
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The card's SM count (the current device's, read once).
int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 1;
  }
  return n;
}

// Rows per block and warps per block of a launch over `heads` = B x Hkv
// kv heads: row groups of at most kRowCap rows, halved while twice the
// groups still give at most one block per SM, split evenly; fewer rows a
// group while one warp's layout does not fit; then as many warps (up to
// kMaxWarps) as fit. Returns false when even one row and one warp do not
// fit.
template <typename T>
bool plan(int nq, int heads, int K1, int dh, int psz, int ppc, int* rpb,
          int* nw) {
  auto bytes = [&](int w, int rows) {
    return Layout(w, rows, K1, dh, psz, ppc, (int)sizeof(T)).total;
  };
  auto blocks = [&](int rows) {
    return (long long)heads * ((nq + rows - 1) / rows);
  };
  int rows = min(nq, kRowCap);
  while (rows > 1 && blocks((rows + 1) / 2) <= sm_count())
    rows = (rows + 1) / 2;
  while (rows > 1 && bytes(1, rows) > kSmemLimit) rows = (rows + 1) / 2;
  const int groups = (nq + rows - 1) / rows;
  rows = (nq + groups - 1) / groups;
  int w = kMaxWarps;
  while (w > 1 && bytes(w, rows) > kSmemLimit) --w;
  *rpb = rows;
  *nw = w;
  return bytes(w, rows) <= kSmemLimit;
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* cl_page, const void* cl_pos, const void* qpos,
           void* o, void* wire, void* wscale, void* lse, int B, int K1,
           int Hq, int Hkv, int dh, int P_loc, int psz, int ppc, int window,
           float cap, float sm_scale, int encode_wire, void* stream) {
  const int nq = K1 * (Hq / Hkv);
  int rpb, nw;
  if (!plan<T>(nq, B * Hkv, K1, dh, psz, ppc, &rpb, &nw))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      Layout(nw, rpb, K1, dh, psz, ppc, (int)sizeof(T)).total;
  const int groups = (nq + rpb - 1) / rpb;
  const bool cp16 = dh * sizeof(T) % 16 == 0 && aligned16(k_pool) &&
                    aligned16(v_pool);
  auto kernel =
      cp16 ? &paged_decode_kernel<T, 16> : &paged_decode_kernel<T, 4>;
  static size_t granted[2] = {0, 0};
  const cudaError_t e = repro::allow_smem(kernel, smem, granted[cp16]);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(B, Hkv, groups), nw * 32, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(cl_page),
      static_cast<const int*>(cl_pos), static_cast<const int*>(qpos),
      static_cast<float*>(o), static_cast<int8_t*>(wire),
      static_cast<float*>(wscale), static_cast<float*>(lse), K1, Hq, Hkv, dh,
      P_loc, psz, ppc, window, cap, sm_scale, encode_wire, rpb);
  return (int)cudaGetLastError();
}

}  // namespace

// Rows per block and warps per block the launch would take at a shape
// (pool_bf16: 2-byte pages) on the current device, or 0 for a shape that
// does not fit shared memory even at one row and one warp a block (the
// wrapper refuses it before the launch).
extern "C" int paged_decode_plan(int B, int K1, int Hq, int Hkv, int dh,
                                 int psz, int ppc, int pool_bf16, int* rpb,
                                 int* nw) {
  if (B <= 0 || K1 <= 0 || Hkv <= 0 || Hq % Hkv != 0 || dh <= 0 ||
      psz <= 0 || ppc < 0)
    return 0;
  const int nq = K1 * (Hq / Hkv);
  return pool_bf16
             ? plan<__nv_bfloat16>(nq, B * Hkv, K1, dh, psz, ppc, rpb, nw)
             : plan<float>(nq, B * Hkv, K1, dh, psz, ppc, rpb, nw);
}

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a shape the kernel does not take (dh not a
// multiple of 4, or one row and one warp beyond the shared-memory
// limit).
// The caller validated shapes, dtypes, devices and contiguity; o is
// unused when encode_wire != 0, wire and wscale are unused when it is 0.
extern "C" int paged_decode_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* cl_page, const void* cl_pos, const void* qpos, void* o,
    void* wire, void* wscale, void* lse, int B, int K1, int Hq, int Hkv,
    int dh, int P_loc, int psz, int ppc, int window, float cap,
    float sm_scale, int encode_wire, int pool_bf16, void* stream) {
  if (B <= 0 || K1 <= 0 || Hkv <= 0 || Hq % Hkv != 0 || dh <= 0 ||
      dh % 4 != 0 || psz <= 0 || ppc < 0 || P_loc <= 0)
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
