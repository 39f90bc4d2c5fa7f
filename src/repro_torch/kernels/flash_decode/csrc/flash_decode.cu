// Decode attention (one query token per row against the KV cache) for
// Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces: src/repro/kernels/flash_decode/kernel.py:65 `flash_decode_pallas`
// (Pallas body `_decode_kernel`, :25): per-row `lengths`, window
// `kpos > len - 1 - window`, tanh softcap, all G q heads of one kv head per
// program, fp32 (acc, m, l), p cast to the cache's dtype before PV.
//
// Bound on the H100: bytes. Every cached K and V element is used for G
// multiply-adds against one query, ~G/2 FLOP per byte of bf16 cache, far
// below the ~295 FLOP/byte ridge; the least time is the valid part of the
// cache over 3.35 TB/s. At serving sizes that is a few microseconds, so
// what the kernel must do is put every tile's copy in flight at once and
// keep each block's chain of dependent steps short.
//
// Both kernels split the cache along L into chunks of `split` positions,
// one block per (chunk, kv head, row; for bf16 also per 16 q heads), and
// each block reads its own row's length from device memory (this replaces
// the TPU's scalar prefetch): a chunk wholly outside the row's valid range
// or window exits at once and writes nothing. The host chooses `split` per
// call from L, B and KV so that the blocks fill the 132 SMs (kernel.py). A
// second, small kernel combines the chunks' partial (acc, m, l) with the
// max-rescaled sum of flash_attention/ops.py:384-388, over the chunks that
// hold valid positions only. `flash_decode_partials` runs the same partial
// kernels on one slice of a sequence-sharded cache whose first row is
// global position `pos_offset` (masks and window at global positions) and
// merges its chunks into the slice's unnormalised (acc, m, l) instead; the
// ranks combine those (flash_attention/ops.py:_decode_mha_seq_sharded,
// replacing the reference's shard_map body at its ops.py:367-397). The cache is read in its own dtype, so no step
// copies or casts the whole cache.
//
// bf16 q with a bf16 cache, head dims 16-256 (`decode_mma_kernel`; the
// served case): K and V stay bf16 in shared memory. They arrive by TMA
// through 4-D maps over [B, L, KV, D] (as flash_attention.cu's K and V),
// 64 positions a tile, swizzled, into a ring of 2-4 stages with one
// mbarrier each; one thread issues the first stages' copies before any
// math, so a chunk's tiles are in flight together. Both products run on
// the tensor cores with mma.sync m16n8k16: the G <= 16 q heads of the
// block are the 16 rows of A (zero-padded; G 17-32 takes two blocks), K
// comes by ldmatrix as B of S = Q K^T, p is rounded to bf16 in registers
// (the accumulator layout of S is the A layout of P V) and V comes by
// ldmatrix.trans. Each of the four warps owns 16 positions of every tile
// with its own running max and sum; the warps' partials meet once, at the
// end, in shared memory. wgmma's 64 rows would waste 57 of 64 at qwen2-7b's
// G = 7, so mma.sync is the grain here.
//
// fp32 q or an fp32 cache (`decode_partial_kernel`): the CUDA cores in fp32
// (rounding q to bf16 for the tensor cores would miss the fp32
// tolerance). 32-position K/V tiles are loaded with 16-byte loads into fp32
// shared memory; a G that is not a power of two is looped over, never
// padded.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"   // TMA, mbarrier, mma.sync and ldmatrix helpers (kernels/csrc)

namespace {

constexpr int DBK = 32;     // cache positions per tile (== warp size)
constexpr int DNT = 128;    // threads per block
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The positions [start, end) of chunk sp that a row of length len attends
// to; empty when the chunk lies outside the valid range or window. The
// cache holds L positions starting at global position off; len is first
// clamped to lclamp (the whole cache: L, a slice of it: INT_MAX).
__device__ __forceinline__ void chunk_range(int len, int L, int window, int split, int sp,
                                            int off, int lclamp, int& start, int& end) {
  len = min(len, lclamp);
  const int lo = window > 0 ? max(0, len - window) : 0;
  start = max(sp * split, lo - off);
  end = min(min((sp + 1) * split, len - off), L);
}

// -------------------------------------------------- fp32: the CUDA cores

template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src, long long stride,
                                          int valid, int rows, int D) {
  constexpr int VEC = 16 / sizeof(T);
  const int vpr = D / VEC;
  for (int i = threadIdx.x; i < rows * vpr; i += blockDim.x) {
    const int r = i / vpr, c = (i - r * vpr) * VEC;
    float* o = dst + r * ld + c;
    if (r < valid) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + r * stride + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < VEC; ++j) o[j] = to_f(e[j]);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) o[j] = 0.f;
    }
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

inline int smem_floats(int G, int D) {
  return G * D + DBK * (D + 1) + DBK * D + G * DBK + G * D + 3 * G;
}

// Partial softmax over the positions of chunk sp of one (row, kv head).
template <typename TQ, typename TC>
__global__ void __launch_bounds__(DNT)
decode_partial_kernel(const TQ* __restrict__ q, const TC* __restrict__ kc,
                      const TC* __restrict__ vc, const int* __restrict__ lengths,
                      float* __restrict__ acc_out, float* __restrict__ m_out,
                      float* __restrict__ l_out, int L, int H, int KV, int D, int split,
                      float scale, int window, float softcap, int off, int lclamp) {
  const int sp = blockIdx.x, n = blockIdx.y, b = blockIdx.z;
  int start, end;
  chunk_range(lengths[b], L, window, split, sp, off, lclamp, start, end);
  if (start >= end) return;         // the combine skips this chunk

  extern __shared__ float smem[];
  const int G = H / KV, LDK = D + 1;
  float* qs = smem;                 // [G][D]
  float* Ks = qs + G * D;           // [DBK][D+1]
  float* Vs = Ks + DBK * LDK;       // [DBK][D]
  float* Ps = Vs + DBK * D;         // [G][DBK]
  float* accs = Ps + G * DBK;       // [G][D]
  float* ms = accs + G * D;         // [G]
  float* ls = ms + G;               // [G]
  float* cs = ls + G;               // [G]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  load_tile<TQ>(qs, D, q + ((long long)b * H + (long long)n * G) * D, D, G, G, D);
  for (int i = tid; i < G * D; i += DNT) accs[i] = 0.f;
  for (int g = tid; g < G; g += DNT) {
    ms[g] = NEG_INF;
    ls[g] = 0.f;
  }

  const long long row = (long long)KV * D;
  const TC* kb = kc + (long long)b * L * row + (long long)n * D;
  const TC* vb = vc + (long long)b * L * row + (long long)n * D;

  for (int t0 = start; t0 < end; t0 += DBK) {
    const int nv = min(DBK, end - t0);
    __syncthreads();
    load_tile<TC>(Ks, LDK, kb + t0 * row, row, nv, DBK, D);
    load_tile<TC>(Vs, D, vb + t0 * row, row, nv, DBK, D);
    __syncthreads();

    for (int e = tid; e < G * DBK; e += DNT) {
      const int g = e / DBK, c = e - g * DBK;
      const float* qr = qs + g * D;
      const float* kr = Ks + c * LDK;
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot += qr[d] * kr[d];
      float x = dot * scale;
      if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
      Ps[e] = c < nv ? x : NEG_INF;
    }
    __syncthreads();

    for (int g = warp; g < G; g += DNT / 32) {
      const float x = Ps[g * DBK + lane];
      const float m_old = ms[g];
      const float m_new = fmaxf(m_old, warp_max(x));
      const float p = lane < nv ? expf(x - m_new) : 0.f;   // explicit mask on p
      const float sum = warp_sum(p);
      Ps[g * DBK + lane] = to_f(from_f<TC>(p));             // p in the cache dtype
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        ls[g] = ls[g] * corr + sum;
        ms[g] = m_new;
        cs[g] = corr;
      }
    }
    __syncthreads();

    for (int e = tid; e < G * D; e += DNT) {
      const int g = e / D, d = e - g * D;
      const float* pr = Ps + g * DBK;
      float a = accs[e] * cs[g];
      for (int c = 0; c < nv; ++c) a += pr[c] * Vs[c * D + d];
      accs[e] = a;
    }
  }
  __syncthreads();

  const long long base = (((long long)b * KV + n) * gridDim.x + sp) * G;
  for (int e = tid; e < G * D; e += DNT) acc_out[base * D + e] = accs[e];
  for (int g = tid; g < G; g += DNT) {
    m_out[base + g] = ms[g];
    l_out[base + g] = ls[g];
  }
}

// ------------------------------------------- bf16: mma.sync, TMA-fed ring

constexpr int MBK = 64;     // cache positions per tile: 16 for each of the 4 warps

template <int D>
struct Dc {
  static constexpr int SW = D >= 64 ? 128 : 2 * D;   // swizzle span = bytes of one box row
  static constexpr int EB = SW / 2;                  // bf16 in one box row
  static constexpr int NB = D / EB;                  // boxes across D
  static constexpr int TILE = MBK * D * 2;           // one K or V tile
  static constexpr int ST = D == 256 ? 2 : D == 128 ? 3 : 4;   // ring stages
  static constexpr int Q_LD = D * 2 + 16;            // bytes of a q row (+16: no bank conflicts)
  static constexpr int RING = ST * 2 * TILE;
  static constexpr int SMEM = RING + 16 * Q_LD + 8 * ST + 1024;
  // the warps' partials at the end reuse the ring: acc [4][16][D], m, l [4][16]
  static_assert(4 * 16 * (D + 2) * 4 <= RING, "the warps' partials fit the ring");
};

// smem address of (row, column d) of a tile of rows of D bf16 stored as
// boxes of EB columns with the maps' swizzle
template <int D>
__device__ __forceinline__ uint32_t tile_addr(uint32_t tile, int row, int d) {
  using C = Dc<D>;
  return tile + (d / C::EB) * MBK * C::SW + swizzle(row * C::SW + (d % C::EB) * 2, C::SW);
}

template <int D>
__global__ void __launch_bounds__(128)
decode_mma_kernel(const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
                  const __nv_bfloat16* __restrict__ q, const int* __restrict__ lengths,
                  float* __restrict__ acc_out, float* __restrict__ m_out,
                  float* __restrict__ l_out, int L, int H, int KV, int split, int nsplit,
                  float scale, int window, float softcap, int off, int lclamp) {
  using C = Dc<D>;
  const int sp = blockIdx.x, b = blockIdx.z;
  const int G = H / KV, MT = (G + 15) / 16;
  const int n = blockIdx.y / MT, g0 = (blockIdx.y % MT) * 16;   // kv head, first q head
  int start, end;
  chunk_range(lengths[b], L, window, split, sp, off, lclamp, start, end);
  if (start >= end) return;         // the combine skips this chunk
  const int n_tiles = (end - start + MBK - 1) / MBK;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t ring = smem_u32(base);               // stage s: K tile, then V tile
  const uint32_t sq = ring + C::RING;                 // 16 q rows of D bf16
  const uint32_t bars = sq + 16 * C::Q_LD;            // one full barrier per stage
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  auto load = [&](int it) {         // tile it into stage it % ST (one thread)
    const int s = it % C::ST, t0 = start + it * MBK;
    const uint32_t bar = bars + 8u * s, sk = ring + s * 2 * C::TILE;
    mbar_expect_tx(bar, 2 * C::TILE);
#pragma unroll
    for (int j = 0; j < C::NB; ++j) {
      tma_load(sk + j * MBK * C::SW, &tm_k, bar, j * C::EB, n, t0, b);
      tma_load(sk + C::TILE + j * MBK * C::SW, &tm_v, bar, j * C::EB, n, t0, b);
    }
  };
  if (tid == 0) {
    for (int s = 0; s < C::ST; ++s) mbar_init(bars + 8u * s, 1);
    mbar_fence_init();
    for (int it = 0; it < min(C::ST, n_tiles); ++it) load(it);
  }
  // q rows g0 .. g0 + 15 of this kv head's G (zero past G), 16 bytes a thread
  const __nv_bfloat16* qb = q + ((long long)b * H + (long long)n * G + g0) * D;
  for (int i = tid; i < 16 * (D / 8); i += 128) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    const uint4 v = g0 + r < G ? *reinterpret_cast<const uint4*>(qb + r * D + c)
                               : make_uint4(0u, 0u, 0u, 0u);
    *reinterpret_cast<uint4*>(base + C::RING + r * C::Q_LD + c * 2) = v;
  }
  __syncthreads();

  // this thread's accumulator rows: q heads r and r + 8 of the 16
  const int r = lane >> 2, cq = 2 * (lane & 3);
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;   // l: this thread's partial sums

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % C::ST;
    const uint32_t sk = ring + s * 2 * C::TILE, sv = sk + C::TILE;
    mbar_wait(bars + 8u * s, (it / C::ST) & 1);
    const int p0 = start + it * MBK + 16 * warp;      // this warp's first position
    const int nv = end - p0;                          // its valid positions (all if >= 16)
    if (nv > 0) {
      // S [16 q heads x 16 positions] = Q K^T over D in steps of 16
      float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4], kb[4];
        ldmatrix_x4(a, sq + ((lane & 7) + ((lane >> 3) & 1) * 8) * C::Q_LD +
                           (16 * kk + (lane >> 4) * 8) * 2);
        ldmatrix_x4(kb, tile_addr<D>(sk, 16 * warp + (lane & 7) + (lane >> 4) * 8,
                                     16 * kk + ((lane >> 3) & 1) * 8));
        mma_bf16(sc[0], a, kb[0], kb[1]);
        mma_bf16(sc[1], a, kb[2], kb[3]);
      }
      // softmax on the fragments: sc[t][i] is head r + 8 (i >> 1), position
      // p0 + 8 t + cq + (i & 1); fp32 throughout
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float x = sc[t][i] * scale;
          if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
          sc[t][i] = 8 * t + cq + (i & 1) < nv ? x : NEG_INF;
        }
      float mx0 = fmaxf(fmaxf(sc[0][0], sc[0][1]), fmaxf(sc[1][0], sc[1][1]));
      float mx1 = fmaxf(fmaxf(sc[0][2], sc[0][3]), fmaxf(sc[1][2], sc[1][3]));
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float corr0 = ex2((m0 - mn0) * LOG2E), corr1 = ex2((m1 - mn1) * LOG2E);
      m0 = mn0;
      m1 = mn1;
      uint32_t pa[4];               // P in bf16 as the A fragment of m16k16
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        float p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)   // explicit mask on p: a masked position adds 0
          p[i] = 8 * t + cq + (i & 1) < nv ? ex2((sc[t][i] - (i < 2 ? mn0 : mn1)) * LOG2E) : 0.f;
        l0 = l0 * (t == 0 ? corr0 : 1.f) + p[0] + p[1];
        l1 = l1 * (t == 0 ? corr1 : 1.f) + p[2] + p[3];
        pa[2 * t] = pack_bf16(p[0], p[1]);
        pa[2 * t + 1] = pack_bf16(p[2], p[3]);
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[j][0] *= corr0;
        acc[j][1] *= corr0;
        acc[j][2] *= corr1;
        acc[j][3] *= corr1;
      }
      if (nv < 16) {
        // rows past the chunk's end may lie past the row's length, where
        // the cache holds anything: zero them so that p = 0 meets no NaN
        for (int i = lane; i < (16 - nv) * (D / 8); i += 32) {
          const int rr = 16 * warp + nv + i / (D / 8), d = (i % (D / 8)) * 8;
          asm volatile("st.shared.v4.b32 [%0], {%1, %1, %1, %1};\n" ::"r"(tile_addr<D>(sv, rr, d)),
                       "r"(0u)
                       : "memory");
        }
        __syncwarp();
      }
      // O += P V over this warp's 16 positions, D in steps of 16
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, tile_addr<D>(sv, 16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8,
                                           16 * dn + (lane >> 4) * 8));
        mma_bf16(acc[2 * dn], pa, vb[0], vb[1]);
        mma_bf16(acc[2 * dn + 1], pa, vb[2], vb[3]);
      }
    }
    if (it + C::ST < n_tiles) {
      __syncthreads();              // every warp is done with stage s: refill it
      if (tid == 0) load(it + C::ST);
    }
  }

#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }
  // the warps' partials meet in shared memory (the ring: every copy has
  // landed, since every warp waited on every tile)
  __syncthreads();
  float* pacc = reinterpret_cast<float*>(base);       // [4][16][D]
  float* pm = pacc + 4 * 16 * D;                      // [4][16]
  float* pl = pm + 4 * 16;                            // [4][16]
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(pacc + (warp * 16 + r + 8 * h) * D + 8 * j + cq) =
          make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
  if ((lane & 3) == 0) {
    pm[warp * 16 + r] = m0;
    pm[warp * 16 + r + 8] = m1;
    pl[warp * 16 + r] = l0;
    pl[warp * 16 + r + 8] = l1;
  }
  __syncthreads();
  const int rows = min(16, G - g0);
  const long long out0 = (((long long)b * KV + n) * nsplit + sp) * G + g0;
  for (int i = tid; i < rows * D; i += 128) {
    const int h = i / D, d = i - h * D;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < 4; ++w) M = fmaxf(M, pm[w * 16 + h]);
    float a = 0.f, l = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float e = ex2((pm[w * 16 + h] - M) * LOG2E);
      a += pacc[(w * 16 + h) * D + d] * e;
      l += pl[w * 16 + h] * e;
    }
    acc_out[(out0 + h) * D + d] = a;
    if (d == 0) {
      m_out[out0 + h] = M;
      l_out[out0 + h] = l;
    }
  }
}

// ---------------------------------------------------------------- combine

// The chunks' partials of one (row, q head, dim d) reduced over the chunks
// [s0, s1) that hold the row's valid positions, in a cache of L positions
// starting at global position off (len first clamped to lclamp, as in
// chunk_range): M = max_s m_s, num = sum_s acc_s e^(m_s - M) and den =
// sum_s l_s e^(m_s - M). No such chunk gives M NEG_INF and num = den = 0.
__device__ __forceinline__ void reduce_chunks(const float* __restrict__ acc,
                                              const float* __restrict__ m,
                                              const float* __restrict__ l, int len, int L,
                                              int window, int split, int off, int lclamp,
                                              long long base, int G, int g, int D, int d,
                                              float& M, float& num, float& den) {
  len = min(len, lclamp);
  const int lo = max((window > 0 ? max(0, len - window) : 0) - off, 0);
  const int hi = min(len - off, L);                   // local valid positions [lo, hi)
  const int s0 = lo / split, s1 = hi > lo ? (hi - 1) / split + 1 : s0;   // chunks [s0, s1)
  M = NEG_INF;
  for (int s = s0; s < s1; ++s) M = fmaxf(M, m[(base + s) * G + g]);
  num = 0.f;
  den = 0.f;
  for (int s = s0; s < s1; ++s) {
    const long long i = (base + s) * G + g;
    const float w = expf(m[i] - M);
    num += acc[i * D + d] * w;
    den += l[i] * w;
  }
}

// out[b, 0, h, d] = sum_s acc_s e^(m_s - M) / (sum_s l_s e^(m_s - M) + 1e-30)
// over the chunks s that hold valid positions; grid (H, B), D threads.
template <typename TQ>
__global__ void decode_combine_kernel(const float* __restrict__ acc, const float* __restrict__ m,
                                      const float* __restrict__ l,
                                      const int* __restrict__ lengths, TQ* __restrict__ out,
                                      int L, int H, int KV, int D, int split, int nsplit,
                                      int window) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x, G = H / KV;
  const int n = h / G, g = h - n * G;
  float M, num, den;
  reduce_chunks(acc, m, l, lengths[b], L, window, split, 0, L,
                ((long long)b * KV + n) * nsplit, G, g, D, d, M, num, den);
  out[((long long)b * H + h) * D + d] = from_f<TQ>(num / (den + 1e-30f));
}

// The chunks' partials of one slice merged into the slice's own
// unnormalised (acc, m, l) [B, KV, G(, D)]: the combine above without the
// division, over the chunks with valid positions at the slice's offset.
// A slice with none gives acc 0, m NEG_INF, l 0. Grid (H, B), D threads.
__global__ void decode_merge_kernel(const float* __restrict__ acc, const float* __restrict__ m,
                                    const float* __restrict__ l, const int* __restrict__ lengths,
                                    float* __restrict__ acc_out, float* __restrict__ m_out,
                                    float* __restrict__ l_out, int L, int H, int KV, int D,
                                    int split, int nsplit, int window, int off) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x, G = H / KV;
  const int n = h / G, g = h - n * G;
  float M, num, den;
  reduce_chunks(acc, m, l, lengths[b], L, window, split, off, 0x7fffffff,
                ((long long)b * KV + n) * nsplit, G, g, D, d, M, num, den);
  const long long o = ((long long)b * KV + n) * G + g;
  acc_out[o * D + d] = num;
  if (d == 0) {
    m_out[o] = M;
    l_out[o] = den;
  }
}

// ----------------------------------------------------------------- launch

template <typename TQ, typename TC>
cudaError_t launch_fp32(const void* q, const void* kc, const void* vc, const int* lengths,
                        float* acc, float* m, float* l, int B, int L, int H, int KV, int D,
                        int split, int nsplit, int window, float softcap, float scale,
                        int off, int lclamp, cudaStream_t st) {
  const int G = H / KV;
  const int bytes = smem_floats(G, D) * (int)sizeof(float);
  static int configured = 48 * 1024;
  if (bytes > configured) {
    cudaError_t e = cudaFuncSetAttribute(decode_partial_kernel<TQ, TC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    configured = bytes;
  }
  decode_partial_kernel<TQ, TC><<<dim3(nsplit, KV, B), DNT, bytes, st>>>(
      static_cast<const TQ*>(q), static_cast<const TC*>(kc), static_cast<const TC*>(vc), lengths,
      acc, m, l, L, H, KV, D, split, scale, window, softcap, off, lclamp);
  return cudaGetLastError();
}

// 4-D map over a contiguous bf16 cache [B, L, KV, D], box {EB, 1, MBK, 1}
template <int D>
int encode_cache(CUtensorMap* map, const void* ptr, int B, int L, int KV) {
  using C = Dc<D>;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)KV, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)KV * D * 2,
                                 (cuuint64_t)L * KV * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)C::EB, 1, (cuuint32_t)MBK, 1};
  return encode_bf16(map, ptr, 4, dims, strides, box, C::SW);
}

template <int D>
int launch_mma(const void* q, const void* kc, const void* vc, const int* lengths, float* acc,
               float* m, float* l, int B, int L, int H, int KV, int split, int nsplit, int window,
               float softcap, float scale, int off, int lclamp, cudaStream_t st) {
  using C = Dc<D>;
  CUtensorMap tk, tv;
  int rc = encode_cache<D>(&tk, kc, B, L, KV);
  if (rc == 0) rc = encode_cache<D>(&tv, vc, B, L, KV);
  if (rc != 0) return rc;
  cudaError_t e = cudaFuncSetAttribute(decode_mma_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const int MT = (H / KV + 15) / 16;
  decode_mma_kernel<D><<<dim3(nsplit, KV * MT, B), 128, C::SMEM, st>>>(
      tk, tv, static_cast<const __nv_bfloat16*>(q), lengths, acc, m, l, L, H, KV, split, nsplit,
      scale, window, softcap, off, lclamp);
  return (int)cudaGetLastError();
}

template <typename TQ>
cudaError_t launch_combine(const float* acc, const float* m, const float* l, const int* lengths,
                           void* out, int B, int L, int H, int KV, int D, int split, int nsplit,
                           int window, cudaStream_t st) {
  decode_combine_kernel<TQ><<<dim3(H, B), D, 0, st>>>(acc, m, l, lengths, static_cast<TQ*>(out),
                                                      L, H, KV, D, split, nsplit, window);
  return cudaGetLastError();
}

// The kernel, by dtype and shape alone: bf16 q with a bf16 cache at head
// dims 16, 32, 64, 128 and 256 takes the tensor-core kernel, everything
// else the fp32 CUDA-core kernel.
bool tensor_cores(int q_dtype, int cache_dtype, int D) {
  return q_dtype == 1 && cache_dtype == 1 &&
         (D == 16 || D == 32 || D == 64 || D == 128 || D == 256);
}

// The chunks' partial kernel `tensor_cores` names, over a cache of L
// positions that starts at global position off (lengths clamped to lclamp).
int launch_partials(const void* q, const void* k_cache, const void* v_cache, const int* lengths,
                    float* acc, float* m, float* l, int B, int L, int H, int KV, int D,
                    int q_dtype, int cache_dtype, int split, int nsplit, int window,
                    float softcap, float scale, int off, int lclamp, cudaStream_t st) {
  int rc;
#define FD_ARGS lengths, acc, m, l, B, L, H, KV, D, split, nsplit, window, softcap, scale, off, \
                lclamp, st
#define FD_MMA_ARGS q, k_cache, v_cache, lengths, acc, m, l, B, L, H, KV, split, nsplit, window, \
                    softcap, scale, off, lclamp, st
  if (tensor_cores(q_dtype, cache_dtype, D)) {
    switch (D) {
      case 16: rc = launch_mma<16>(FD_MMA_ARGS); break;
      case 32: rc = launch_mma<32>(FD_MMA_ARGS); break;
      case 64: rc = launch_mma<64>(FD_MMA_ARGS); break;
      case 128: rc = launch_mma<128>(FD_MMA_ARGS); break;
      default: rc = launch_mma<256>(FD_MMA_ARGS); break;
    }
  } else if (q_dtype == 0) {
    rc = cache_dtype ? (int)launch_fp32<float, __nv_bfloat16>(q, k_cache, v_cache, FD_ARGS)
                     : (int)launch_fp32<float, float>(q, k_cache, v_cache, FD_ARGS);
  } else {
    rc = cache_dtype ? (int)launch_fp32<__nv_bfloat16, __nv_bfloat16>(q, k_cache, v_cache, FD_ARGS)
                     : (int)launch_fp32<__nv_bfloat16, float>(q, k_cache, v_cache, FD_ARGS);
  }
#undef FD_ARGS
#undef FD_MMA_ARGS
  return rc;
}

}  // namespace

// q_dtype / cache_dtype: 0 = float32, 1 = bfloat16. acc/m/l are fp32
// scratch of [B, KV, ceil(L/split), G(, D)] elements. Two launches: the
// kernel `tensor_cores` names, then the combine. Returns 0, a cudaError_t
// or ENCODE_ERROR + a CUresult; the Python wrapper raises on non-zero.
extern "C" int flash_decode_fwd(const void* q, const void* k_cache, const void* v_cache,
                                const int* lengths, float* acc, float* m, float* l, void* out,
                                int B, int L, int H, int KV, int D, int q_dtype, int cache_dtype,
                                int split, int window, float softcap, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (split <= 0 || (q_dtype | cache_dtype) & ~1) return (int)cudaErrorInvalidValue;
  const int nsplit = (L + split - 1) / split;
  const int rc = launch_partials(q, k_cache, v_cache, lengths, acc, m, l, B, L, H, KV, D, q_dtype,
                                 cache_dtype, split, nsplit, window, softcap, scale, 0, L, st);
  if (rc != 0) return rc;
  return q_dtype ? (int)launch_combine<__nv_bfloat16>(acc, m, l, lengths, out, B, L, H, KV, D,
                                                      split, nsplit, window, st)
                 : (int)launch_combine<float>(acc, m, l, lengths, out, B, L, H, KV, D, split,
                                              nsplit, window, st);
}

// The unnormalised partials of one slice of a sequence-sharded cache:
// k_cache/v_cache [B, L, KV, D] hold global positions [pos_offset,
// pos_offset + L), lengths are global. acc/m/l are the chunks' scratch as
// in flash_decode_fwd; acc_out [B, KV, G, D], m_out/l_out [B, KV, G] fp32
// get the slice's (acc, m, l) with masks and window at global positions.
// Two launches: the partial kernel, then the merge.
extern "C" int flash_decode_partials(const void* q, const void* k_cache, const void* v_cache,
                                     const int* lengths, float* acc, float* m, float* l,
                                     float* acc_out, float* m_out, float* l_out, int B, int L,
                                     int H, int KV, int D, int q_dtype, int cache_dtype, int split,
                                     int pos_offset, int window, float softcap, float scale,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (split <= 0 || pos_offset < 0 || (q_dtype | cache_dtype) & ~1)
    return (int)cudaErrorInvalidValue;
  const int nsplit = (L + split - 1) / split;
  const int rc = launch_partials(q, k_cache, v_cache, lengths, acc, m, l, B, L, H, KV, D, q_dtype,
                                 cache_dtype, split, nsplit, window, softcap, scale, pos_offset,
                                 0x7fffffff, st);
  if (rc != 0) return rc;
  decode_merge_kernel<<<dim3(H, B), D, 0, st>>>(acc, m, l, lengths, acc_out, m_out, l_out, L, H,
                                                KV, D, split, nsplit, window, pos_offset);
  return (int)cudaGetLastError();
}

// The partial kernel flash_decode_fwd would launch: 1 the tensor-core
// kernel, 0 the fp32 CUDA-core kernel.
extern "C" int flash_decode_variant(int q_dtype, int cache_dtype, int D) {
  return tensor_cores(q_dtype, cache_dtype, D);
}

extern "C" const char* flash_decode_error_string(int err) {
  return hopper_error_string(err);
}
