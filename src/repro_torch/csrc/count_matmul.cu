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
// scale, rounded to f32 (__fmul_rn, so no contraction folds it into the
// accumulation), and the product with W is summed in f32 over K. The
// decoded activations never reach device memory.
//
// Three designs, picked by shape:
//
// * M <= 16 (decode rows): W streaming, bound by W's bytes (2 bytes an
//   element in bf16 against 2M operations). A block owns 64 columns and
//   one K range of a thread-block cluster of up to 8 blocks that split K,
//   so [4,1024]x[1024,2816] runs 352 blocks. It decodes its count rows
//   into shared memory once; each thread issues all of its W loads (16
//   bytes each, 4 rows in bf16) before it touches the decoded counts,
//   then accumulates every one of the M rows for its 8 (bf16) or 4 (f32)
//   columns. Partials are summed in a fixed order: a shuffle tree over
//   the K groups of a warp, the warps in order, then the cluster's blocks
//   in rank order through distributed shared memory. No atomics: two
//   launches on the same inputs give the same bits.
// * M > 16, bf16 W (prefill rows): tensor cores. The decoded f32
//   activation a splits exactly into three bf16 planes, hi = bf16(a),
//   mid = bf16(a - hi), lo = a - hi - mid (8 + 8 + 8 significant bits
//   hold a's 24), and each plane times a bf16 W is exact in f32, so the
//   sum of the three mma.sync products is the f32 sum of a*W up to the
//   order of the adds. Each 32-deep K tile is summed by the tensor cores
//   from zero and then added to the running f32 sum with IEEE adds, so
//   the cores' own accumulation spans 32 products, not K. 64 x 128
//   tiles, 8 warps of 32 x 32, about two blocks an SM. W, count and scale
//   tiles arrive through a 4-stage cp.async ring; each K tile is decoded
//   into the planes from shared memory, two activations a conversion.
//   The cluster splits K so that the grid is about one block per SM
//   ([256,1024]x[1024,2816]: 88 tiles x 2), and its partial tiles are
//   summed in rank order as above. What bounds it is 3 x 2MKN bf16
//   tensor-core operations; what holds it back here is the shared-memory
//   reads of the three A planes, which four warps each read again.
// * M > 16, f32 W (off the served path): the register-tiled 64 x 64 f32
//   kernel, 4 x 4 outputs a thread through shared memory, bound by the
//   2MKN operations at the f32 rate outside the tensor cores.
//
// Ragged M, K and N are bounds-checked in every design: out-of-range
// activations and weights read as 0 and out-of-range outputs are not
// stored, which gives the JAX wrapper's zero padding. 16-byte loads are
// taken where N (or K) and the pointers allow them, element loads
// elsewhere. No library call, no TF32, no --use_fast_math.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using repro::store;
using repro::to_f32;

constexpr int kThreads = 256;
constexpr int kMaxSplit = 8;  // the portable cluster size

// The TPU kernel's decoded activation, f32(c) * (scale * f32(1/T)).
__device__ __forceinline__ float decode(int c, float scale, float inv_T) {
  return __fmul_rn((float)c, __fmul_rn(scale, inv_T));
}

// Sum the partial tiles [rows][ld] that the S blocks of this cluster hold
// in shared memory at `part` (columns [0, cols) of each row; cols and ld
// multiples of 4), in rank order; the block of rank r sums and stores the
// r-th slice of the tile at (m0, n0). Each thread reads four columns at a
// time and issues all of its distributed-shared-memory reads for U such
// groups before it stores any, so the reads overlap.
template <typename O>
__device__ void cluster_reduce_store(float* part, int S, int rows, int cols,
                                     int ld, O* out, int m0, int n0, int M,
                                     int N) {
  constexpr int U = 4;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  cluster.sync();  // every block's partial is written
  const int cols4 = cols / 4, total = rows * cols4;
  const int per = (total + S - 1) / S;
  const int end = min(total, (rank + 1) * per);
  for (int i0 = rank * per + (int)threadIdx.x; i0 < end;
       i0 += U * (int)blockDim.x) {
    float4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * (int)blockDim.x;
      if (i >= end) continue;
      const int off = (i / cols4) * ld + (i % cols4) * 4;
      v[u] = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(part, 0) + off);
      for (int q = 1; q < S; ++q) {
        const float4 x = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(part, q) + off);
        v[u].x += x.x;
        v[u].y += x.y;
        v[u].z += x.z;
        v[u].w += x.w;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * (int)blockDim.x;
      const int m = m0 + i / cols4, n = n0 + (i % cols4) * 4;
      if (i >= end || m >= M) continue;
      const float e[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (n + j < N) store(&out[(long)m * N + n + j], e[j]);
    }
  }
  cluster.sync();  // no block leaves while another reads its partial
}

// ---------------------------------------------------------------------------
// M <= 16: W streaming
// ---------------------------------------------------------------------------

// 16 bytes of W row `row` from column n0: 4 f32 or 8 bf16, zero past N.
// `vec`: N is a multiple of the chunk and W is 16-byte aligned.
__device__ __forceinline__ uint4 load_chunk(const float* row, int n0, int N,
                                            int vec) {
  if (n0 >= N) return make_uint4(0u, 0u, 0u, 0u);
  if (vec) return __ldg(reinterpret_cast<const uint4*>(row + n0));
  float f[4];
#pragma unroll
  for (int v = 0; v < 4; ++v) f[v] = n0 + v < N ? row[n0 + v] : 0.0f;
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 load_chunk(const __nv_bfloat16* row, int n0,
                                            int N, int vec) {
  if (n0 >= N) return make_uint4(0u, 0u, 0u, 0u);
  if (vec) return __ldg(reinterpret_cast<const uint4*>(row + n0));
  const unsigned short* r = reinterpret_cast<const unsigned short*>(row);
  unsigned h[8];
#pragma unroll
  for (int v = 0; v < 8; ++v) h[v] = n0 + v < N ? r[n0 + v] : 0u;
  return make_uint4(h[0] | h[1] << 16, h[2] | h[3] << 16, h[4] | h[5] << 16,
                    h[6] | h[7] << 16);
}

__device__ __forceinline__ void unpack(uint4 u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(uint4 u, float (&f)[8]) {
  const unsigned x[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // bf16 -> f32 is a 16-bit shift
    f[2 * i] = __uint_as_float(x[i] << 16);
    f[2 * i + 1] = __uint_as_float(x[i] & 0xffff0000u);
  }
}

template <int MB, typename W, typename O>
__global__ void __launch_bounds__(kThreads) count_matmul_stream(
    const int8_t* __restrict__ c, const W* __restrict__ w,
    const float* __restrict__ scale, O* __restrict__ out, int M, int K,
    int N, float inv_T, int vec) {
  constexpr int VEC = 16 / sizeof(W);   // columns a thread owns
  constexpr int BN = 64;                // columns a block owns
  constexpr int TPR = BN / VEC;         // threads across a W row
  constexpr int KG = kThreads / TPR;    // K groups of a block
  constexpr int KP = 128;               // K rows decoded per pass
  constexpr int RPT = KP / KG;          // W rows a thread loads per pass
  constexpr int AS = MB + 4;            // a_s row stride, floats
  constexpr int NW = kThreads / 32;
  __shared__ __align__(16) float a_s[KP * AS];      // decoded, k-major
  __shared__ __align__(16) float part[NW * MB * BN];

  const int S = gridDim.y, rank = blockIdx.y;  // the cluster spans y
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int col = tid % TPR, kg = tid / TPR;
  const int n0 = blockIdx.x * BN + col * VEC;
  const int kchunk = (K + S - 1) / S;
  const int kb = min(K, rank * kchunk), ke = min(K, kb + kchunk);

  float acc[MB][VEC];
#pragma unroll
  for (int m = 0; m < MB; ++m)
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[m][v] = 0.0f;

  for (int p0 = kb; p0 < ke; p0 += KP) {
    const int np = min(KP, ke - p0);
    uint4 raw[RPT];  // every W load of the pass in flight at once
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int kk = kg + j * KG;
      raw[j] = kk < np ? load_chunk(w + (long)(p0 + kk) * N, n0, N, vec)
                       : make_uint4(0u, 0u, 0u, 0u);
    }
    for (int i = tid; i < KP * MB; i += kThreads) {
      const int m = i / KP, kk = i % KP;  // a warp reads 32 k of one row
      a_s[kk * AS + m] = kk < np && m < M
                             ? decode(c[(long)m * K + p0 + kk],
                                      scale[p0 + kk], inv_T)
                             : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      float wf[VEC];
      unpack(raw[j], wf);
      const float* ar = a_s + (kg + j * KG) * AS;
#pragma unroll
      for (int m4 = 0; m4 < MB; m4 += 4) {
        const float4 a4 = *reinterpret_cast<const float4*>(ar + m4);
        const float av[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int v = 0; v < VEC; ++v)
            acc[m4 + i][v] = fmaf(av[i], wf[v], acc[m4 + i][v]);
      }
    }
    __syncthreads();  // a_s is rewritten by the next pass
  }

  // the K groups of a warp, a shuffle tree; then the warps in order
#pragma unroll
  for (int m = 0; m < MB; ++m)
#pragma unroll
    for (int v = 0; v < VEC; ++v)
#pragma unroll
      for (int o = TPR; o < 32; o <<= 1)
        acc[m][v] += __shfl_xor_sync(0xffffffffu, acc[m][v], o);
  if (lane < TPR) {
#pragma unroll
    for (int m = 0; m < MB; ++m)
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        part[(warp * MB + m) * BN + col * VEC + v] = acc[m][v];
  }
  __syncthreads();
  for (int i = tid; i < MB * BN; i += kThreads) {
    float s = part[i];
    for (int q = 1; q < NW; ++q) s += part[q * MB * BN + i];
    part[i] = s;
  }
  cluster_reduce_store(part, S, MB, BN, BN, out, 0, blockIdx.x * BN, M, N);
}

// ---------------------------------------------------------------------------
// M > 16, bf16 W: three bf16 planes of the activations on the tensor cores
// ---------------------------------------------------------------------------

namespace mma {
constexpr int BM = 64, BN = 128, BK = 32, STAGES = 4;
constexpr int WN = BN / 4;         // a warp's columns (8 warps: 2 x 4)
constexpr int NJ = WN / 8;         // its n8 blocks
constexpr int AST = BK + 8;        // bf16 a plane row (80 bytes: ldmatrix
                                   // reads no bank twice)
constexpr int WST = BN + 8;        // bf16 a W row (272 bytes)
// shared memory: the three bf16 planes of one decoded tile, then a ring of
// STAGES raw tiles (W, int8 counts, f32 scales), all copied by cp.async
constexpr int A_BYTES = 3 * BM * AST * 2;
constexpr int W_BYTES = BK * WST * 2;
constexpr int C_BYTES = BM * BK;
constexpr int S_BYTES = BK * 4;
constexpr int STAGE_BYTES = W_BYTES + C_BYTES + S_BYTES;
constexpr size_t SMEM = A_BYTES + (size_t)STAGES * STAGE_BYTES;
constexpr int PLD = BN + 4;        // f32 partial tile row
static_assert((size_t)BM * PLD * 4 <= SMEM, "partial tile must fit");
static_assert(A_BYTES % 16 == 0 && W_BYTES % 16 == 0 && C_BYTES % 16 == 0 &&
                  STAGE_BYTES % 16 == 0, "16-byte alignment");
}  // namespace mma

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <typename O>
__global__ void __launch_bounds__(kThreads) count_matmul_mma(
    const int8_t* __restrict__ c, const __nv_bfloat16* __restrict__ w,
    const float* __restrict__ scale, O* __restrict__ out, int M, int K,
    int N, float inv_T, int vec) {
  using namespace mma;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* planes = reinterpret_cast<__nv_bfloat16*>(smem);

  const int S = gridDim.z, rank = blockIdx.z;  // the cluster spans z
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // a warp's 32 x WN of the tile
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int KT = (K + BK - 1) / BK;
  const int t0 = (int)((long)KT * rank / S);
  const int nt = (int)((long)KT * (rank + 1) / S) - t0;
  const bool vec_w = vec & 1, vec_c = vec & 2, vec_s = vec & 4;

  // raw tile t -> stage s: 16-byte cp.async where the rows allow, zero
  // filled past M, K and N; element copies otherwise
  auto issue = [&](int t, int s) {
    unsigned char* st = smem + A_BYTES + s * STAGE_BYTES;
    __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(st);
    int8_t* cs = reinterpret_cast<int8_t*>(st + W_BYTES);
    float* ss = reinterpret_cast<float*>(st + W_BYTES + C_BYTES);
    const int k0 = (t0 + t) * BK;
#pragma unroll
    for (int i = 0; i < BK * BN / 8 / kThreads; ++i) {  // W: 16-byte chunks
      const int idx = tid + i * kThreads;
      const int r = idx / (BN / 8), cc = idx % (BN / 8) * 8;
      const int k = k0 + r, n = n0 + cc;
      __nv_bfloat16* dst = ws + r * WST + cc;
      if (vec_w) {
        const bool ok = k < K && n < N;
        repro::cp_async16(dst, ok ? (const void*)(w + (long)k * N + n)
                                  : (const void*)w, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = k < K && n + e < N ? w[(long)k * N + n + e]
                                      : __ushort_as_bfloat16(0);
      }
    }
    if (vec_c) {  // counts: 64 rows of 2 chunks
      if (tid < BM * BK / 16) {
        const int r = tid >> 1, h = (tid & 1) * 16;
        const int m = m0 + r, k = k0 + h;
        const bool ok = m < M && k < K;
        repro::cp_async16(cs + r * BK + h, ok ? c + (long)m * K + k : c,
                          ok ? 16 : 0);
      }
    } else {
      const int r = tid >> 2, e0 = (tid & 3) * 8, m = m0 + r;
#pragma unroll
      for (int e = e0; e < e0 + 8; ++e)
        cs[r * BK + e] = m < M && k0 + e < K ? c[(long)m * K + k0 + e] : 0;
    }
    if (vec_s) {  // scales: 8 chunks
      if (tid >= kThreads - BK / 4) {
        const int j = (tid - (kThreads - BK / 4)) * 4, k = k0 + j;
        repro::cp_async16(ss + j, k < K ? scale + k : scale, k < K ? 16 : 0);
      }
    } else if (tid < BK) {
      ss[tid] = k0 + tid < K ? scale[k0 + tid] : 0.0f;
    }
  };

  // stage s's counts -> the three bf16 planes: 8 consecutive k of row cm
  // a thread
  const int cm = tid >> 2, ck = (tid & 3) * 8;
  auto decode_planes = [&](int s) {
    const unsigned char* st = smem + A_BYTES + s * STAGE_BYTES;
    const uint2 raw =
        *reinterpret_cast<const uint2*>(st + W_BYTES + cm * BK + ck);
    const float* ss =
        reinterpret_cast<const float*>(st + W_BYTES + C_BYTES) + ck;
    uint32_t pl[3][4];  // hi, mid, lo; 8 bf16 each
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      float2 a;  // two decoded activations, split pairwise: each
      a.x = decode((int8_t)((e < 4 ? raw.x : raw.y) >> (8 * (e & 3))),
                   ss[e], inv_T);
      a.y = decode((int8_t)((e < 4 ? raw.x : raw.y) >> (8 * (e & 3) + 8)),
                   ss[e + 1], inv_T);
      // difference is exact, so a == hi + mid + lo
      const __nv_bfloat162 hi = __float22bfloat162_rn(a);
      const float2 r1 = make_float2(__fsub_rn(a.x, __low2float(hi)),
                                    __fsub_rn(a.y, __high2float(hi)));
      const __nv_bfloat162 md = __float22bfloat162_rn(r1);
      const __nv_bfloat162 lo = __float22bfloat162_rn(
          make_float2(__fsub_rn(r1.x, __low2float(md)),
                      __fsub_rn(r1.y, __high2float(md))));
      pl[0][e / 2] = bits(hi);
      pl[1][e / 2] = bits(md);
      pl[2][e / 2] = bits(lo);
    }
#pragma unroll
    for (int p = 0; p < 3; ++p)
      *reinterpret_cast<uint4*>(planes + p * BM * AST + cm * AST + ck) =
          make_uint4(pl[p][0], pl[p][1], pl[p][2], pl[p][3]);
  };

  float acc[2][NJ][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  auto compute = [&](int s) {
    const __nv_bfloat16* ws = reinterpret_cast<const __nv_bfloat16*>(
        smem + A_BYTES + s * STAGE_BYTES);
    float tile[2][NJ][4];  // this K tile's sum, from zero
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) tile[i][j][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t bfr[NJ][2];
#pragma unroll
      for (int nj = 0; nj < NJ / 2; ++nj) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, ws + (ks + (lane & 15)) * WST + wn * WN +
                                 nj * 16 + (lane >> 4) * 8);
        bfr[2 * nj][0] = r[0];
        bfr[2 * nj][1] = r[1];
        bfr[2 * nj + 1][0] = r[2];
        bfr[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int p = 2; p >= 0; --p) {  // small planes first
        uint32_t af[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          ldmatrix_x4(af[mi], planes + p * BM * AST +
                                  (wm * 32 + mi * 16 + (lane & 15)) * AST +
                                  ks + (lane >> 4) * 8);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int nj = 0; nj < NJ; ++nj)
            mma_bf16(tile[mi][nj], af[mi], bfr[nj]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += tile[i][j][e];
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nt) issue(s, s);
    repro::cp_async_commit();
  }
  for (int t = 0; t < nt; ++t) {
    repro::cp_async_wait<STAGES - 2>();  // this thread's copies of tile t
    __syncthreads();  // everyone's tile t is in; tile t-1 is consumed
    if (t + STAGES - 1 < nt) issue(t + STAGES - 1, (t + STAGES - 1) % STAGES);
    repro::cp_async_commit();
    decode_planes(t % STAGES);
    __syncthreads();
    compute(t % STAGES);
  }
  repro::cp_async_wait<0>();
  __syncthreads();  // the partial tile reuses the buffers

  float* part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj) {
      const int r = wm * 32 + mi * 16 + (lane >> 2);
      const int cc = wn * WN + nj * 8 + (lane & 3) * 2;
      *reinterpret_cast<float2*>(part + r * PLD + cc) =
          make_float2(acc[mi][nj][0], acc[mi][nj][1]);
      *reinterpret_cast<float2*>(part + (r + 8) * PLD + cc) =
          make_float2(acc[mi][nj][2], acc[mi][nj][3]);
    }
  cluster_reduce_store(part, S, BM, BN, PLD, out, m0, n0, M, N);
}

// ---------------------------------------------------------------------------
// M > 16, f32 W: register-tiled f32 FMAs through shared memory
// ---------------------------------------------------------------------------

constexpr int kBK = 32;

template <int BM, int BN, int TM, int TN, typename W, typename O>
__global__ void __launch_bounds__((BM / TM) * (BN / TN)) count_matmul_tile(
    const int8_t* __restrict__ c, const W* __restrict__ w,
    const float* __restrict__ scale, O* __restrict__ out, int M, int K,
    int N, float inv_T) {
  constexpr int kCols = BN / TN;            // thread columns
  constexpr int kRows = BM / TM;            // thread rows
  constexpr int kTileThreads = kCols * kRows;
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
    for (int idx = tid; idx < BM * kBK; idx += kTileThreads) {
      const int mm = idx / kBK, kk = idx % kBK;
      const int m = m0 + mm, k = k0 + kk;
      a_s[kk][mm] = m < M && k < K ? decode(c[(long)m * K + k], scale[k],
                                            inv_T)
                                   : 0.0f;
    }
    // weight tile: consecutive threads read consecutive n of one row
    for (int idx = tid; idx < kBK * BN; idx += kTileThreads) {
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

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 132;
  }
  return n;
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// Launch `kernel` on `grid` with clusters of `split` blocks along the
// grid's last split axis (y for the stream kernel, z for the mma kernel).
template <typename... KArgs, typename... Args>
cudaError_t launch_split(void (*kernel)(KArgs...), dim3 grid, dim3 cluster,
                         size_t smem, cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster.x;
  attr[0].val.clusterDim.y = cluster.y;
  attr[0].val.clusterDim.z = cluster.z;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <int MB, typename W, typename O>
cudaError_t launch_stream(const int8_t* c, const void* w, const float* scale,
                          void* out, int M, int K, int N, float inv_T,
                          cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(W);
  // at least 64 K rows a block, at most the portable cluster
  const int split = max(1, min(kMaxSplit, (K + 63) / 64));
  const int vec = N % VEC == 0 && aligned(w, 16);
  return launch_split(count_matmul_stream<MB, W, O>,
                      dim3((N + 63) / 64, split), dim3(1, split, 1), 0,
                      stream, c, static_cast<const W*>(w), scale,
                      static_cast<O*>(out), M, K, N, inv_T, vec);
}

template <typename O>
cudaError_t launch_mma(const int8_t* c, const void* w, const float* scale,
                       void* out, int M, int K, int N, float inv_T,
                       cudaStream_t stream) {
  static size_t granted = 0;
  auto kernel = count_matmul_mma<O>;
  cudaError_t e = repro::allow_smem(kernel, mma::SMEM, granted);
  if (e != cudaSuccess) return e;
  const int tn = (N + mma::BN - 1) / mma::BN, tm = (M + mma::BM - 1) / mma::BM;
  const int kt = (K + mma::BK - 1) / mma::BK;
  // about one block per SM, each K split at least one K tile
  int split = (sm_count() + tn * tm - 1) / (tn * tm);
  split = max(1, min(split, min(kMaxSplit, kt)));
  const int vec = (N % 8 == 0 && aligned(w, 16)) |
                  (K % 16 == 0 && aligned(c, 16)) << 1 |
                  (K % 4 == 0 && aligned(scale, 16)) << 2;
  return launch_split(kernel, dim3(tn, tm, split), dim3(1, 1, split),
                      mma::SMEM, stream, c,
                      static_cast<const __nv_bfloat16*>(w), scale,
                      static_cast<O*>(out), M, K, N, inv_T, vec);
}

template <typename W, typename O>
cudaError_t launch_tile(const int8_t* c, const void* w, const float* scale,
                        void* out, int M, int K, int N, float inv_T,
                        cudaStream_t stream) {
  constexpr int BM = 64, BN = 64, TM = 4, TN = 4;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  count_matmul_tile<BM, BN, TM, TN, W, O>
      <<<grid, (BM / TM) * (BN / TN), 0, stream>>>(
          c, static_cast<const W*>(w), scale, static_cast<O*>(out), M, K, N,
          inv_T);
  return cudaSuccess;
}

template <typename W, typename O>
cudaError_t dispatch(const int8_t* c, const void* w, const float* scale,
                     void* out, int M, int K, int N, float inv_T,
                     cudaStream_t stream) {
  if (M <= 4)
    return launch_stream<4, W, O>(c, w, scale, out, M, K, N, inv_T, stream);
  if (M <= 8)
    return launch_stream<8, W, O>(c, w, scale, out, M, K, N, inv_T, stream);
  if (M <= 16)
    return launch_stream<16, W, O>(c, w, scale, out, M, K, N, inv_T, stream);
  if constexpr (std::is_same<W, __nv_bfloat16>::value)
    return launch_mma<O>(c, w, scale, out, M, K, N, inv_T, stream);
  else
    return launch_tile<W, O>(c, w, scale, out, M, K, N, inv_T, stream);
}

}  // namespace

// counts [M, K] int8; w [K, N] f32 (w_bf16 = 0) or bf16 (w_bf16 = 1);
// scale [K] f32; out [M, N] f32 (out_bf16 = 0) or bf16 (out_bf16 = 1);
// inv_T = f32(1/T). All row-major and contiguous. Launches on `stream`;
// returns the launch's error, else cudaGetLastError().
extern "C" int count_matmul_launch(const int8_t* counts, const void* w,
                                   const float* scale, void* out, int M,
                                   int K, int N, float inv_T, int w_bf16,
                                   int out_bf16, cudaStream_t stream) {
  cudaError_t e;
  if (w_bf16 && out_bf16)
    e = dispatch<__nv_bfloat16, __nv_bfloat16>(counts, w, scale, out, M, K,
                                               N, inv_T, stream);
  else if (w_bf16)
    e = dispatch<__nv_bfloat16, float>(counts, w, scale, out, M, K, N, inv_T,
                                       stream);
  else if (out_bf16)
    e = dispatch<float, __nv_bfloat16>(counts, w, scale, out, M, K, N, inv_T,
                                       stream);
  else
    e = dispatch<float, float>(counts, w, scale, out, M, K, N, inv_T, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
