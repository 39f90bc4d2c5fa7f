// RWKV6 (Finch) wkv scan for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces: src/repro/kernels/rwkv6_scan/kernel.py:64 `rwkv6_scan_pallas`
// (Pallas body `_rwkv_kernel`, :23): per (row, head), a [D, D] fp32 state
// resident on chip across the whole sequence, log-decay clamped to
// [-5, -1e-6], bonus u on the diagonal, the final state written once.
//
// Bound on the H100: at rwkv6-7b's B 1-2, S 601, H 64, D 64 the least time
// is ~0.01-0.02 ms, by the fp32 operations of the per-step form or by the
// bytes of r, k, v, w and the output. What held the per-step kernel
// (below) at 0.53-0.78 ms was not the chain of steps: measured on an H100
// 80GB HBM3 (700 W), its loads alone took 0.017-0.019 ms and its
// recurrence alone (loads replaced by a fixed tile) 0.18-0.19 ms, but the
// two together 0.53 ms at B 2 and 0.78 at B 1, because each 16-step tile
// was staged by a loop with runtime bounds that waited on device memory
// once per iteration (16 iterations a thread at B 2, 32 at B 1), with no
// copy in flight while the steps ran.
//
// Two kernels, chosen by dtype and shape alone (`chunked`):
//
// bf16 r/k/v with D in {16, 32, 64, 128} and S >= 1 (`rwkv6_chunk_kernel`,
// the served case): the chunked form on the tensor cores. Within a chunk of
// CK = 16 steps, with P_i = prod_{s<i} w_s (the decay before step i),
// T = P_16 and Q_j = prod_{s>j} w_s, all per key dimension d:
//
//   out_i = (r_i P_i) S + sum_{j<i} A_ij v_j + (r_i . u . k_i) v_i,
//   A_ij  = sum_d r_i[d] k_j[d] prod_{j<s<i} w_s[d],
//   S    <- diag(T) S + sum_j (k_j Q_j) v_j^T.
//
// Every factor is a product of clamped decays, each in [e^-5, 1): no
// exp(-cumsum) appears (the TPU kernel's k / A_j reaches e^80 within a
// chunk), and nothing is ever larger than its input. The products are
// running products of the clamped w (no exp, no log).
//
// The block is one (row, head, slice of DV = 16 NW v columns), warp-
// specialised. 256 producer threads build a chunk's decays (a product scan
// over the threads of each d) and A (each thread one key step j and D / 16
// d, every query step interleaved by selects, the 16 threads of j summed by
// a reduce-scatter of shuffles) into one of two work buffers. NW consumer
// warps each keep 16 columns of the fp32 state, transposed (S^T [16 v x
// D]), in mma.sync accumulator fragments for the whole sequence and write
// them once at the end. Because the accumulator layout of S^T is the
// A-operand layout of m16n8k16, out^T = S^T (r P)^T + V^T A^T and S^T <-
// S^T diag(T) + V^T (k Q) are mma.sync products with S^T and V^T
// (ldmatrix.trans of the v tile) as A. The state never rounds through
// bf16: S^T, r P, k Q and A enter the tensor cores as three bf16 parts
// (x = hi + mid + lo to 2^-27 |x|) and their products down to 2^-18 are
// kept, so each product is exact to ~2^-24, as the fp32 per-step form;
// with two parts (2^-16), outputs of |out| ~ 9 rounded to the other side
// of a bf16 midpoint from the plain version's, beyond the 5e-2 tolerance.
// r, k and w (fp32) tiles [CK, D] and the block's v tile [CK, DV] arrive
// by TMA from 3-D maps over [B, S, H D] into a CST-stage mbarrier ring
// that the first consumer refills; the map zero-fills steps past S, and
// the producers take their decay as 1 and their k as 0, so they neither
// decay nor add to the state. The output leaves through shared memory by
// a TMA store, which the map clips at S. The host (kernel.py:plan)
// chooses the v split from B H and the SM count.
//
// Measured on an H100 80GB HBM3 (700 W) at B 2, S 601: 0.069 ms; 0.050
// with A left out, 0.057 without the decays, 0.051 without the products:
// the parts add although producers and consumers run in separate warps,
// and B 4 (two blocks an SM) takes twice as long. What bounds it is one
// SM's throughput on one (row, head), not device memory; a second
// producer group and a deeper ring (4-6 stages) did not move it.
//
// fp32 r/k/v, D = 8, or S = 0 (`rwkv6_scan_kernel`): the exact
// per-step recurrence in fp32 on the CUDA cores. One block per (head,
// row, slice of v columns); four neighbouring lanes share one v column and
// hold D/4 rows of it in registers; 16-step tiles of r, k, v and the decay
// are staged in shared memory, the steps run from there, and the loop
// stops at S.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"   // TMA, mbarrier, mma.sync and ldmatrix helpers (kernels/csrc)

namespace {

constexpr int TC = 16;       // time steps staged in shared memory at once
constexpr int KSPLIT = 4;    // lanes sharing one v column
constexpr float LOG_DECAY_CLAMP = 5.0f;

// -------------------------------------------- per-step kernel (fp32, D 8)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// grid (H, B, D / dv); block KSPLIT * dv threads; v columns [z*dv, z*dv+dv)
template <typename T, int D>
__global__ void __launch_bounds__(KSPLIT * D)
rwkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                  const float* __restrict__ w, const float* __restrict__ u,
                  const float* __restrict__ s0, T* __restrict__ out, float* __restrict__ s_out,
                  int S, int H, int dv) {
  constexpr int KR = D / KSPLIT;              // state rows per lane
  __shared__ float rs[TC][D], ks[TC][D], ws[TC][D], vs[TC][D], os[TC][D];
  const int h = blockIdx.x, b = blockIdx.y, v0 = blockIdx.z * dv;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int q = tid % KSPLIT, vc = tid / KSPLIT, col = v0 + vc;

  const long long sbase = ((long long)b * H + h) * D * D;
  float s[KR], uu[KR];
#pragma unroll
  for (int i = 0; i < KR; ++i) {
    const int kk = i * KSPLIT + q;
    s[i] = s0 ? s0[sbase + (long long)kk * D + col] : 0.f;
    uu[i] = u[h * D + kk];
  }

  const long long tstride = (long long)H * D;              // one time step
  const long long base = (long long)b * S * tstride + (long long)h * D;
  for (int t0 = 0; t0 < S; t0 += TC) {
    const int tc = min(TC, S - t0);
    __syncthreads();                    // the previous tile's readers are done
    for (int e = tid; e < tc * D; e += nthr) {
      const int t = e / D, d = e - t * D;
      const long long g = base + (t0 + t) * tstride + d;
      rs[t][d] = to_f(r[g]);
      ks[t][d] = to_f(k[g]);
      const float lw = logf(fminf(fmaxf(w[g], 1e-30f), 1.f));
      ws[t][d] = expf(fminf(fmaxf(lw, -LOG_DECAY_CLAMP), -1e-6f));
    }
    for (int e = tid; e < tc * dv; e += nthr) {
      const int t = e / dv, d = e - t * dv;
      vs[t][d] = to_f(v[base + (t0 + t) * tstride + v0 + d]);
    }
    __syncthreads();
    for (int t = 0; t < tc; ++t) {
      const float vv = vs[t][vc];
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < KR; ++i) {
        const int kk = i * KSPLIT + q;
        const float kv = ks[t][kk] * vv;
        acc = fmaf(rs[t][kk], fmaf(uu[i], kv, s[i]), acc);   // r (S + u k v)
        s[i] = fmaf(ws[t][kk], s[i], kv);                    // w S + k v
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (q == 0) os[t][vc] = acc;
    }
    __syncthreads();
    for (int e = tid; e < tc * dv; e += nthr) {
      const int t = e / dv, d = e - t * dv;
      out[base + (t0 + t) * tstride + v0 + d] = from_f<T>(os[t][d]);
    }
  }
#pragma unroll
  for (int i = 0; i < KR; ++i)
    s_out[sbase + (long long)(i * KSPLIT + q) * D + col] = s[i];
}

template <typename T, int D>
cudaError_t launch(const void* r, const void* k, const void* v, const float* w, const float* u,
                   const float* s0, void* out, float* s_out, int B, int S, int H, int vsplit,
                   cudaStream_t st) {
  const int dv = D / vsplit;
  rwkv6_scan_kernel<T, D><<<dim3(H, B, vsplit), KSPLIT * dv, 0, st>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v), w, u, s0,
      static_cast<T*>(out), s_out, S, H, dv);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* r, const void* k, const void* v, const float* w, const float* u,
                     const float* s0, void* out, float* s_out, int B, int S, int H, int D,
                     int vsplit, cudaStream_t st) {
  switch (D) {
    case 8: return launch<T, 8>(r, k, v, w, u, s0, out, s_out, B, S, H, vsplit, st);
    case 16: return launch<T, 16>(r, k, v, w, u, s0, out, s_out, B, S, H, vsplit, st);
    case 32: return launch<T, 32>(r, k, v, w, u, s0, out, s_out, B, S, H, vsplit, st);
    case 64: return launch<T, 64>(r, k, v, w, u, s0, out, s_out, B, S, H, vsplit, st);
    case 128: return launch<T, 128>(r, k, v, w, u, s0, out, s_out, B, S, H, vsplit, st);
    default: return cudaErrorInvalidValue;
  }
}


// ------------------------------------- chunked kernel (bf16, tensor cores)

constexpr int CK = 16;      // steps per chunk: the M, N and K of one mma tile
constexpr int CST = 3;      // ring stages
constexpr int PNT = 256;    // producer threads: a chunk's decays and A
constexpr int NBUF = 2;     // work buffers between producers and consumers

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

template <int D, int NW>
struct Rk {
  static constexpr int NT = PNT + 32 * NW;           // + one consumer warp per 16 v columns
  static constexpr int DV = 16 * NW;                 // v columns of the block
  static constexpr int TPD = PNT / D;                // threads per d walking the decays (parts)
  static constexpr int SPT = CK / TPD;               // steps per walking thread
  static constexpr int DG = D / 16;                  // d per thread building A (16 per key step)
  static constexpr int VEB = DV > 64 ? 64 : DV;      // v columns per TMA box
  static constexpr int VSW = 2 * VEB;                // its swizzle: one box row
  static constexpr int NVB = DV / VEB;
  static constexpr int V_BYTES = CK * DV * 2;
  static constexpr int R_BYTES = CK * D * 2;         // r or k tile
  static constexpr int W_BYTES = CK * D * 4;
  static constexpr int TX = V_BYTES + 2 * R_BYTES + W_BYTES;   // bytes a stage receives
  // stage: v (swizzled, 1024-aligned), r, k, w
  static constexpr int ST_R = round_up(V_BYTES, 1024);
  static constexpr int ST_K = ST_R + R_BYTES;
  static constexpr int ST_W = ST_K + R_BYTES;
  static constexpr int STAGE = round_up(ST_W + W_BYTES, 1024);
  // a work buffer (producers -> consumers): r P and k Q as three bf16
  // parts [3][CK][D + 8], A as three parts [3][CK][CK + 8] (padded rows:
  // ldmatrix without bank conflicts), the chunk's decay T [D]
  static constexpr int LD = (D + 8) * 2;             // bytes of a padded row
  static constexpr int LDA = (CK + 8) * 2;
  static constexpr int B_KQ = 3 * CK * LD;
  static constexpr int B_A = B_KQ + 3 * CK * LD;
  static constexpr int B_DEC = B_A + 3 * CK * LDA;
  static constexpr int BUF = round_up(B_DEC + D * 4, 128);
  // then the producers' clamped w in fp32 [CK][D] and scan scratch, two
  // output tiles [CK][DV] bf16 and the barriers
  static constexpr int W_BUF = CST * STAGE;
  static constexpr int W_WF = W_BUF + NBUF * BUF;
  static constexpr int W_PP = W_WF + CK * D * 4;     // the walk's part products [TPD][D]
  static constexpr int W_O = round_up(W_PP + TPD * D * 4, 128);
  static constexpr int W_BAR = W_O + 2 * CK * DV * 2;
  static constexpr int SMEM = W_BAR + 8 * (CST + 2 * NBUF) + 1024;   // + alignment slack
  static_assert(TPD * SPT == CK && DG * 16 == D, "the thread maps tile D and CK");
};

// N consecutive fp32 / bf16 values from shared memory as floats, in
// 16-, 8- or 4-byte loads (p aligned to the load)
template <int N>
__device__ __forceinline__ void ld_f32(float (&v)[N], const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int k = 0; k < N / 4; ++k) {
      const float4 f = reinterpret_cast<const float4*>(p)[k];
      v[4 * k] = f.x; v[4 * k + 1] = f.y; v[4 * k + 2] = f.z; v[4 * k + 3] = f.w;
    }
  } else if constexpr (N == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    v[0] = f.x; v[1] = f.y;
  } else {
    v[0] = p[0];
  }
}

template <int N>
__device__ __forceinline__ void ld_bf16(float (&v)[N], const __nv_bfloat16* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int k = 0; k < N / 4; ++k) {
      const uint2 raw = reinterpret_cast<const uint2*>(p)[k];
      const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
      const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
      v[4 * k] = a.x; v[4 * k + 1] = a.y; v[4 * k + 2] = b.x; v[4 * k + 3] = b.y;
    }
  } else if constexpr (N == 2) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    v[0] = a.x; v[1] = a.y;
  } else {
    v[0] = __bfloat162float(p[0]);
  }
}

// x as three bf16 parts x = p[0] + p[1] + p[2] + O(2^-27 x): each the
// rounding of what the parts before it leave; written `stride` apart
__device__ __forceinline__ void split3(float x, __nv_bfloat16* p, int stride) {
  const __nv_bfloat16 hi = __float2bfloat16(x);
  const float r = x - __bfloat162float(hi);
  const __nv_bfloat16 mid = __float2bfloat16(r);
  p[0] = hi;
  p[stride] = mid;
  p[2 * stride] = __float2bfloat16(r - __bfloat162float(mid));
}

// two neighbouring accumulator values as three bf16x2 A-operand words
__device__ __forceinline__ void split3_pair(float a, float b, uint32_t& hi, uint32_t& mid,
                                            uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float ra = a - __low2float(h), rb = b - __high2float(h);
  const __nv_bfloat162 m = __floats2bfloat162_rn(ra, rb);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = pack_bf16(ra - __low2float(m), rb - __high2float(m));
}

// One round of reduce_scatter16: lanes whose bit O is set keep the upper
// half of their O pairs, the others the lower, and add the partner's
template <int O>
__device__ __forceinline__ void reduce_round(float (&v)[16], int l) {
  const bool upper = l & O;
#pragma unroll
  for (int k = 0; k < O; ++k) {
    const float send = upper ? v[k] : v[k + O];
    const float keep = upper ? v[k + O] : v[k];
    v[k] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

// Sum of v[i] over the 16 lanes of a half warp, for every i: afterwards
// v[0] of lane l holds the sum of everyone's v[l % 16] (15 shuffles).
__device__ __forceinline__ void reduce_scatter16(float (&v)[16], int l) {
  reduce_round<8>(v, l);
  reduce_round<4>(v, l);
  reduce_round<2>(v, l);
  reduce_round<1>(v, l);
}

// grid (H, B, D / DV); block NT threads, warp-specialised: threads
// 0..PNT-1 produce each chunk's decays and A into work buffer c % NBUF;
// consumer warp w (threads PNT + 32 w ..) owns v columns v0 + 16 w ..
// v0 + 16 w + 15 (v0 = blockIdx.z * DV), runs the chunk's products, stores
// its output and refills the ring. A producer runs up to NBUF chunks ahead.
template <int D, int NW>
__global__ void __launch_bounds__(PNT + 32 * NW)
rwkv6_chunk_kernel(const __grid_constant__ CUtensorMap tm_r, const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_w,
                   const __grid_constant__ CUtensorMap tm_o, const float* __restrict__ u,
                   const float* __restrict__ s0, float* __restrict__ s_out, int S, int H) {
  using C = Rk<D, NW>;
  const int h = blockIdx.x, b = blockIdx.y, v0 = blockIdx.z * C::DV;
  const int tid = threadIdx.x;
  const int nchunks = (S + CK - 1) / CK;
  constexpr int RS = D + 8, AS = CK + 8;             // row strides in elements
  constexpr int PR = CK * RS, PA = CK * AS;          // elements between parts

  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t sbase = smem_u32(base);
  const uint32_t full = sbase + C::W_BAR;            // [CST] TMA landed
  const uint32_t wfull = full + 8 * CST;             // [NBUF] work buffer produced
  const uint32_t wempty = wfull + 8 * NBUF;          // [NBUF] work buffer consumed
  auto rp = [&](int buf) { return reinterpret_cast<__nv_bfloat16*>(base + C::W_BUF + buf * C::BUF); };
  auto kq = [&](int buf) { return rp(buf) + C::B_KQ / 2; };
  auto am = [&](int buf) { return rp(buf) + C::B_A / 2; };
  auto dec = [&](int buf) { return reinterpret_cast<float*>(base + C::W_BUF + buf * C::BUF + C::B_DEC); };
  float* wf = reinterpret_cast<float*>(base + C::W_WF);   // [CK][D]

  auto load = [&](int c) {          // chunk c into stage c % CST (one thread)
    const int s = c % CST, t0 = c * CK;
    const uint32_t bar = full + 8u * s, st = sbase + s * C::STAGE;
    mbar_expect_tx(bar, C::TX);
#pragma unroll
    for (int j = 0; j < C::NVB; ++j)
      tma_load(st + j * CK * C::VSW, &tm_v, bar, h * D + v0 + j * C::VEB, t0, b);
    tma_load(st + C::ST_R, &tm_r, bar, h * D, t0, b);
    tma_load(st + C::ST_K, &tm_k, bar, h * D, t0, b);
    tma_load(st + C::ST_W, &tm_w, bar, h * D, t0, b);
  };
  if (tid == 0) {
    for (int s = 0; s < CST; ++s) mbar_init(full + 8u * s, 1);
    for (int i = 0; i < NBUF; ++i) {
      mbar_init(wfull + 8u * i, 1);
      mbar_init(wempty + 8u * i, 1);
    }
    mbar_fence_init();
    for (int c = 0; c < min(CST, nchunks); ++c) load(c);
  }
  __syncthreads();                  // barriers initialised

  if (tid < PNT) {
    // ------------------------------------------------------- producers
    // the walking thread: d = wd, steps [wp SPT, wp SPT + SPT) (a warp's
    // lanes take neighbouring d of one part: its accesses to a [CK][D]
    // tile hit 32 banks once); the A thread: key step aj, d in [ag DG,
    // ag DG + DG)
    const int wd = tid % D, wp = tid / D;
    float* pp = reinterpret_cast<float*>(base + C::W_PP);   // [TPD][D]
    const int aj = tid / 16, ag = tid % 16;
    float uu[C::DG];
#pragma unroll
    for (int x = 0; x < C::DG; ++x) uu[x] = u[h * D + ag * C::DG + x];
    const float wmin = expf(-LOG_DECAY_CLAMP), wmax = expf(-1e-6f);
    for (int c = 0; c < nchunks; ++c) {
      const int s = c % CST, buf = c % NBUF, nvalid = min(CK, S - c * CK);
      const uint8_t* stage = base + s * C::STAGE;
      const __nv_bfloat16* rt = reinterpret_cast<const __nv_bfloat16*>(stage + C::ST_R);
      const __nv_bfloat16* kt = reinterpret_cast<const __nv_bfloat16*>(stage + C::ST_K);
      const float* wt = reinterpret_cast<const float*>(stage + C::ST_W);
      if (c >= NBUF) mbar_wait(wempty + 8u * buf, (c / NBUF - 1) & 1);
      mbar_wait(full + 8u * s, (c / CST) & 1);

      // (1) the decays of d = wd: this thread's SPT steps, then the
      // products of the other parts of d, through shared memory, for P_i
      // (before step i), Q_j (after step j) and T; steps past S decay by 1
      // and add k = 0
      {
        __nv_bfloat16* rpb = rp(buf);
        __nv_bfloat16* kqb = kq(buf);
        float wc[C::SPT], rv[C::SPT], kv[C::SPT];
        float part = 1.f;
#pragma unroll
        for (int x = 0; x < C::SPT; ++x) {
          const int t = wp * C::SPT + x;
          wc[x] = t < nvalid ? fminf(fmaxf(wt[t * D + wd], wmin), wmax) : 1.f;
          rv[x] = __bfloat162float(rt[t * D + wd]);
          kv[x] = t < nvalid ? __bfloat162float(kt[t * D + wd]) : 0.f;
          wf[t * D + wd] = wc[x];
          part *= wc[x];
        }
        pp[wp * D + wd] = part;
        named_barrier(1, PNT);
        float p = 1.f, qd = 1.f;     // the parts before and after this one
#pragma unroll
        for (int o = 0; o < C::TPD; ++o) {
          const float v = pp[o * D + wd];
          p *= o < wp ? v : 1.f;
          qd *= o > wp ? v : 1.f;
        }
        if (wp == C::TPD - 1) dec(buf)[wd] = p * part;   // T: the whole chunk
#pragma unroll
        for (int x = 0; x < C::SPT; ++x) {
          const int t = wp * C::SPT + x;
          split3(rv[x] * p, rpb + t * RS + wd, PR);
          p *= wc[x];
        }
#pragma unroll
        for (int x = C::SPT - 1; x >= 0; --x) {
          const int t = wp * C::SPT + x;
          split3(kv[x] * qd, kqb + t * RS + wd, PR);
          qd *= wc[x];
        }
      }
      named_barrier(1, PNT);        // (2) reads the clamped w of (1)

      // (2) A [CK x CK], lower triangle with the bonus on the diagonal:
      // this thread's partials over its DG d for key step aj and every
      // query step i, as sum_d r_i k_aj e with ke = k_aj e kept per d and
      // e = prod_{aj < s < i} w_s (selects, no branch, so the steps
      // interleave), then summed over the 16 threads of aj; past S nothing
      // needs masking (those rows of out are never stored)
      {
        const int d0 = ag * C::DG;
        float ke[C::DG], av[CK], rr[C::DG], ww[C::DG];
        ld_bf16(ke, kt + aj * D + d0);
        ld_bf16(rr, rt + aj * D + d0);
        float diag = 0.f;
#pragma unroll
        for (int x = 0; x < C::DG; ++x) diag = fmaf(rr[x] * uu[x], ke[x], diag);
#pragma unroll
        for (int i = 0; i < CK; ++i) {
          if (i >= 2) {
            ld_f32(ww, wf + (i - 1) * D + d0);
#pragma unroll
            for (int x = 0; x < C::DG; ++x) ke[x] *= i > aj + 1 ? ww[x] : 1.f;
          }
          ld_bf16(rr, rt + i * D + d0);
          float a = 0.f;
#pragma unroll
          for (int x = 0; x < C::DG; ++x) a = fmaf(rr[x], ke[x], a);
          av[i] = i > aj ? a : (i == aj ? diag : 0.f);
        }
        reduce_scatter16(av, ag);   // av[0] = A[ag][aj]
        split3(av[0], am(buf) + ag * AS + aj, PA);
      }
      named_barrier(1, PNT);        // the buffer is whole; wf and pp are free
      if (tid == 0) mbar_arrive(wfull + 8u * buf);
    }
    return;
  }

  // ---------------------------------------------------------- consumers
  const int ctid = tid - PNT, warp = ctid >> 5, lane = ctid & 31;
  const int g = lane >> 2, q = lane & 3;             // accumulator row / column pair
  // this warp's state S^T [16 v x D]: st[n][i] is v = vb + g + 8 (i >> 1),
  // d = 8 n + 2 q + (i & 1)
  const int vb = v0 + 16 * warp;
  const long long sb = ((long long)b * H + h) * D * D;     // s[d][v] at sb + d D + v
  float st[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      st[n][i] = s0 ? s0[sb + (long long)(8 * n + 2 * q + (i & 1)) * D + vb + g + 8 * (i >> 1)] : 0.f;

  for (int c = 0; c < nchunks; ++c) {
    const int s = c % CST, buf = c % NBUF, t0 = c * CK;
    mbar_wait(full + 8u * s, (c / CST) & 1);
    mbar_wait(wfull + 8u * buf, (c / NBUF) & 1);

    // out^T = S^T (r P)^T + V^T A^T, then S^T <- S^T diag(T) + V^T (k Q)
    const uint32_t sv = sbase + s * C::STAGE;
    uint32_t va[4];                 // V^T [16 v x 16 steps] as the A operand
    {
      const int t = (lane & 7) + ((lane >> 4) & 1) * 8, col = 16 * warp + ((lane >> 3) & 1) * 8;
      ldmatrix_x4_trans(va, sv + (col / C::VEB) * CK * C::VSW +
                                swizzle(t * C::VSW + (col % C::VEB) * 2, C::VSW));
    }
    // every operand but V (exact in bf16) as three bf16 parts, so each
    // product is exact to ~2^-24 (the parts' products below 2^-18 are
    // dropped); three accumulators by the parts' order of magnitude
    float o[3][2][4] = {};
    const uint32_t srp = smem_u32(rp(buf)), skq = smem_u32(kq(buf)), sam = smem_u32(am(buf));
    const float* decb = dec(buf);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t sh[4], sm[4], sl[4], bh[4], bm[4], bl[4];
#pragma unroll
      for (int f = 0; f < 4; ++f)   // a0..a3: (rows g / g + 8) x (d 16 kk + 2 q / + 8)
        split3_pair(st[2 * kk + (f >> 1)][2 * (f & 1)], st[2 * kk + (f >> 1)][2 * (f & 1) + 1],
                    sh[f], sm[f], sl[f]);
      const uint32_t addr = srp + ((lane & 7) + (lane >> 4) * 8) * RS * 2 +
                            (16 * kk + ((lane >> 3) & 1) * 8) * 2;
      ldmatrix_x4(bh, addr);
      ldmatrix_x4(bm, addr + PR * 2);
      ldmatrix_x4(bl, addr + PR * 4);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        mma_bf16(o[0][n], sh, bh[2 * n], bh[2 * n + 1]);
        mma_bf16(o[1][n], sh, bm[2 * n], bm[2 * n + 1]);
        mma_bf16(o[1][n], sm, bh[2 * n], bh[2 * n + 1]);
        mma_bf16(o[2][n], sh, bl[2 * n], bl[2 * n + 1]);
        mma_bf16(o[2][n], sm, bm[2 * n], bm[2 * n + 1]);
        mma_bf16(o[2][n], sl, bh[2 * n], bh[2 * n + 1]);
      }
    }
    {
      const uint32_t addr = sam + ((lane & 7) + (lane >> 4) * 8) * AS * 2 + ((lane >> 3) & 1) * 16;
#pragma unroll
      for (int part = 0; part < 3; ++part) {
        uint32_t ab[4];
        ldmatrix_x4(ab, addr + part * PA * 2);
        mma_bf16(o[part][0], va, ab[0], ab[1]);
        mma_bf16(o[part][1], va, ab[2], ab[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const float d0 = decb[8 * n + 2 * q], d1 = decb[8 * n + 2 * q + 1];
      st[n][0] *= d0;
      st[n][1] *= d1;
      st[n][2] *= d0;
      st[n][3] *= d1;
    }
#pragma unroll
    for (int dn = 0; dn < D / 16; ++dn) {
      const uint32_t addr = skq + ((lane & 7) + ((lane >> 3) & 1) * 8) * RS * 2 +
                            (16 * dn + (lane >> 4) * 8) * 2;
      float inc[2][4] = {};         // V^T (k Q), smallest part first
#pragma unroll
      for (int part = 2; part >= 0; --part) {
        uint32_t kb[4];
        ldmatrix_x4_trans(kb, addr + part * PR * 2);
        mma_bf16(inc[0], va, kb[0], kb[1]);
        mma_bf16(inc[1], va, kb[2], kb[3]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        st[2 * dn][i] += inc[0][i];
        st[2 * dn + 1][i] += inc[1][i];
      }
    }
    // out^T fragments into output tile c % 2 [CK steps][DV] (the store
    // that read it two chunks ago has finished: consumer 0 waited below)
    __nv_bfloat16* ot = reinterpret_cast<__nv_bfloat16*>(base + C::W_O) + (c & 1) * CK * C::DV;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ot[(8 * n + 2 * q + (i & 1)) * C::DV + 16 * warp + g + 8 * (i >> 1)] =
            __float2bfloat16(o[0][n][i] + (o[1][n][i] + o[2][n][i]));
    fence_proxy_async();
    if (ctid == 0) bulk_wait_read<0>();   // the previous chunk's store has read its tile
    named_barrier(2, 32 * NW);      // the output tile is whole; stage s and buf are read
    if (ctid == 0) {
      mbar_arrive(wempty + 8u * buf);
      tma_store(&tm_o, smem_u32(ot), h * D + v0, t0, b);
      bulk_commit();
      if (c + CST < nchunks) load(c + CST);   // the producers are done with chunk c too
    }
  }
  if (ctid == 0) bulk_wait_read<0>();   // shared memory read before exit

#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      s_out[sb + (long long)(8 * n + 2 * q + (i & 1)) * D + vb + g + 8 * (i >> 1)] = st[n][i];
}

// 3-D map over [B, S, H D] (innermost first), box {box0, CK, 1}
int encode_seq(CUtensorMap* map, CUtensorMapDataType type, int esize, const void* ptr, int B,
               int S, int HD, int box0, int sw) {
  const cuuint64_t dims[3] = {(cuuint64_t)HD, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)HD * esize, (cuuint64_t)S * HD * esize};
  const cuuint32_t box[3] = {(cuuint32_t)box0, (cuuint32_t)CK, 1};
  return encode_map(map, type, ptr, 3, dims, strides, box, sw);
}

template <int D, int NW>
int launch_chunked(const void* r, const void* k, const void* v, const float* w, const float* u,
                   const float* s0, void* out, float* s_out, int B, int S, int H,
                   cudaStream_t st) {
  using C = Rk<D, NW>;
  constexpr CUtensorMapDataType BF16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap tr, tk, tv, tw, to;
  const int HD = H * D;
  int rc = encode_seq(&tr, BF16, 2, r, B, S, HD, D, 0);
  if (rc == 0) rc = encode_seq(&tk, BF16, 2, k, B, S, HD, D, 0);
  if (rc == 0) rc = encode_seq(&tv, BF16, 2, v, B, S, HD, C::VEB, C::VSW);
  if (rc == 0) rc = encode_seq(&tw, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, w, B, S, HD, D, 0);
  if (rc == 0) rc = encode_seq(&to, BF16, 2, out, B, S, HD, C::DV, 0);
  if (rc != 0) return rc;
  cudaError_t e = cudaFuncSetAttribute(rwkv6_chunk_kernel<D, NW>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  rwkv6_chunk_kernel<D, NW><<<dim3(H, B, D / C::DV), C::NT, C::SMEM, st>>>(tr, tk, tv, tw, to, u,
                                                                        s0, s_out, S, H);
  return (int)cudaGetLastError();
}

// The kernel, by dtype and shape alone: bf16 r/k/v at D 16, 32, 64 or 128
// with S >= 1 take the chunked tensor-core kernel, everything else the
// per-step kernel.
bool chunked(int dtype, int D, int S) {
  return dtype == 1 && S >= 1 && (D == 16 || D == 32 || D == 64 || D == 128);
}

// v splits the chunked kernel takes: DV = D / vsplit = 16 NW columns a
// block, NW in {1, 2, 4, 8}
bool chunked_split(int D, int vsplit) {
  return vsplit >= 1 && D % vsplit == 0 && (D / vsplit) % 16 == 0;
}

int dispatch_chunked(const void* r, const void* k, const void* v, const float* w, const float* u,
                     const float* s0, void* out, float* s_out, int B, int S, int H, int D,
                     int vsplit, cudaStream_t st) {
  const int nw = D / vsplit / 16;
#define RK_ARGS r, k, v, w, u, s0, out, s_out, B, S, H, st
  switch (D * 16 + nw) {
    case 16 * 16 + 1: return launch_chunked<16, 1>(RK_ARGS);
    case 32 * 16 + 1: return launch_chunked<32, 1>(RK_ARGS);
    case 32 * 16 + 2: return launch_chunked<32, 2>(RK_ARGS);
    case 64 * 16 + 1: return launch_chunked<64, 1>(RK_ARGS);
    case 64 * 16 + 2: return launch_chunked<64, 2>(RK_ARGS);
    case 64 * 16 + 4: return launch_chunked<64, 4>(RK_ARGS);
    case 128 * 16 + 1: return launch_chunked<128, 1>(RK_ARGS);
    case 128 * 16 + 2: return launch_chunked<128, 2>(RK_ARGS);
    case 128 * 16 + 4: return launch_chunked<128, 4>(RK_ARGS);
    case 128 * 16 + 8: return launch_chunked<128, 8>(RK_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef RK_ARGS
}

int per_step(const void* r, const void* k, const void* v, const float* w, const float* u,
             const float* s0, void* out, float* s_out, int B, int S, int H, int D, int dtype,
             int vsplit, cudaStream_t st) {
  if (vsplit < 1 || D % vsplit || D / vsplit < 8) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return (int)dispatch<float>(r, k, v, w, u, s0, out, s_out, B, S, H, D, vsplit, st);
    case 1: return (int)dispatch<__nv_bfloat16>(r, k, v, w, u, s0, out, s_out, B, S, H, D, vsplit, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// r, k, v: [B, S, H, D] in `dtype` (0 = float32, 1 = bfloat16); w: [B, S, H,
// D] fp32; u: [H, D] fp32; s0: [B, H, D, D] fp32 (k-major) or null for a zero
// state; out: [B, S, H, D] in `dtype`; s_out: [B, H, D, D] fp32; pointers
// 16-byte aligned. `vsplit` blocks share one (row, head): D / vsplit v
// columns each, a multiple of 16 for the chunked kernel (`chunked_split`),
// at least 8 for the per-step kernel. One launch, of the kernel `chunked`
// names. Returns 0, a cudaError_t or ENCODE_ERROR + a CUresult; the Python
// wrapper raises on non-zero.
extern "C" int rwkv6_scan_fwd(const void* r, const void* k, const void* v, const float* w,
                              const float* u, const float* s0, void* out, float* s_out, int B,
                              int S, int H, int D, int dtype, int vsplit, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (chunked(dtype, D, S)) {
    if (!chunked_split(D, vsplit)) return (int)cudaErrorInvalidValue;
    return dispatch_chunked(r, k, v, w, u, s0, out, s_out, B, S, H, D, vsplit, st);
  }
  return per_step(r, k, v, w, u, s0, out, s_out, B, S, H, D, dtype, vsplit, st);
}

// The per-step kernel at any dtype and shape it takes, whatever
// `chunked` says: chip_smoke.py times it beside the chunked kernel. The
// wrapper never calls it.
extern "C" int rwkv6_scan_per_step_fwd(const void* r, const void* k, const void* v,
                                       const float* w, const float* u, const float* s0, void* out,
                                       float* s_out, int B, int S, int H, int D, int dtype,
                                       int vsplit, void* stream) {
  return per_step(r, k, v, w, u, s0, out, s_out, B, S, H, D, dtype, vsplit,
                  static_cast<cudaStream_t>(stream));
}

// The kernel rwkv6_scan_fwd would launch: 1 the chunked tensor-core
// kernel, 0 the per-step kernel.
extern "C" int rwkv6_scan_variant(int dtype, int D, int S) { return chunked(dtype, D, S); }

extern "C" const char* rwkv6_scan_error_string(int err) { return hopper_error_string(err); }
