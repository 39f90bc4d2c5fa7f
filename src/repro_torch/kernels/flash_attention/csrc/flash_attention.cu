// Prefill flash attention for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py:73 `flash_attention`
// (Pallas body `_attn_kernel`, :25): blocked online-softmax GQA attention,
// causal with q_offset, sliding window `kpos > qpos - window`, tanh
// softcap, ragged kv `kpos < T`, p multiplied by the mask explicitly so a
// fully masked tile adds exactly zero, p rounded to v's dtype before the PV
// product, out = acc / (l + 1e-30). Training also asks for the row's
// log-sum-exp, the residual of the reference's custom VJP
// (src/repro/kernels/flash_attention/ops.py:148-156): lse = m + log(max(l,
// 1e-30)) in natural log, fp32 [B, S, H] (the reference's [B, S, KV, G]),
// written where the output is when the caller passes a pointer (serving
// passes none). m stays in natural units in both routes (the bf16 route
// folds log2(e) into its exp2 only), so no base change is needed; a row
// that sees no key keeps m = -1e30 and l = 0, and its lse is -1e30.
//
// Bound on the H100: operations for long prompts, bytes for short ones.
// A causal prefill does ~2*S*D FLOP per K/V element and reads q and writes
// o once; at qwen2-7b's heads (H 28, KV 4, D 128) the operations bound
// (989 TFLOP/s bf16) passes the bytes bound (3.35 TB/s) near S = 700; at
// B 4, S 512 they are 7.6 us and 10.0 us. Both products are matrix
// products, so only the tensor cores can approach either bound.
//
// bf16 (attn_fwd_wgmma): both products on the tensor cores with `wgmma`.
// One block per (head, batch row, q tile of 64 rows per consumer
// warpgroup: two warpgroups, 128 rows, at D <= 128; one at D 256, where the
// 64 x 256 fp32 accumulator alone is 128 registers a thread). Q, K and V
// stay bf16 in shared memory, loaded by TMA through 4-D tensor maps over
// [B, S or T, heads, D] (so the zero fill of a ragged tile stops at the
// batch row's own S or T), 128-byte swizzled (64-byte at D 32, 32-byte at
// D 16), a box row holding at most 64 bf16: D 128 and 256 tiles are two and
// four boxes wide. One thread issues the loads into a 2-stage ring of K and
// V tiles (64 kv rows at D 128, 32 at D 256, 128 below), each stage with an
// mbarrier for K and one for V, so the next tile's copy runs under this
// tile's products; the Q tile is loaded once. S = Q K^T is an SS wgmma
// (both K-major); the softmax runs in fp32 on the accumulator fragments in
// the reference's order (scale, softcap, mask, running max and sum, exp2
// with log2(e) folded in), each step a branch-free pass over the
// fragments; P is converted to bf16 in place and fed from registers as the
// A operand of O += P V, with V [T, D] row-major as the transposed
// (MN-major) B operand. The mask is computed only on tiles that straddle
// the causal or window diagonal or the end of T; tiles masked for all of a
// warpgroup's rows are skipped; the longest causal q tiles launch first.
// O / l goes back through the warpgroup's Q tile and one TMA store per box
// (the map clips rows past S). The tensor map encoder lives in libcuda;
// the runtime's entry-point query returns it, so the library needs no
// -lcuda.
//
// What bounds it on this card: a warpgroup runs Q K^T, the softmax and
// P V one after another, so its tensor cores wait through its softmax;
// the overlap comes from other warpgroups. The tile shapes are chosen so
// that two blocks (four warpgroups) fit on an SM: 124 registers a thread
// and 96 KB of shared memory at D 128. Measured on one H100 (PERF.md):
// ~190 TFLOP/s at B 4, S 512 and ~310 at B 8, S 1023, against SDPA's ~240
// and ~440; overlapping one tile's softmax with the next tile's Q K^T
// inside a warpgroup, and a producer warp, are the next steps.
//
// fp32 (attn_fwd_kernel): the CUDA-core kernel of the first port, kept as
// it was. The tensor cores would compute fp32 inputs in TF32 (about three
// decimal digits), outside the fp32 tolerance of 2e-5. One block per q tile
// of 64 rows over 32-row K/V tiles, Q, K, V and P staged in fp32 shared
// memory, the running max m, sum l and a D/4-wide slice of acc in
// registers (four threads own one q row); fully masked K/V tiles skipped.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include "hopper.cuh"   // TMA, mbarrier and wgmma helpers (kernels/csrc)

namespace {

constexpr float NEG_INF = -1e30f;

// ------------------------------------------------- fp32: the CUDA cores

constexpr int BQ = 64;            // q rows per block
constexpr int BK = 32;            // kv rows per tile
constexpr int NT = 4 * BQ;        // four threads per q row

// `rows` rows of D floats into shared memory (row stride ld); rows at or
// past `valid` are zero-filled. 16-byte loads: D * 4 and the row starts are
// multiples of 16 bytes (checked by the Python wrapper).
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src, long long stride,
                                          int valid, int rows, int D) {
  const int vpr = D / 4;
  for (int i = threadIdx.x; i < rows * vpr; i += blockDim.x) {
    const int r = i / vpr, c = (i - r * vpr) * 4;
    float* o = dst + r * ld + c;
    const float4 x = r < valid ? *reinterpret_cast<const float4*>(src + r * stride + c)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
    o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
  }
}

template <int D>
constexpr int smem_floats() {
  return BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1);
}

template <int D>
__global__ void __launch_bounds__(NT)
attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse, int S,
                int T_len, int H, int KV, float scale, int causal, int window, float softcap,
                int q_offset) {
  extern __shared__ float smem[];
  constexpr int LDQ = D + 1, LDK = D + 1, LDV = D, LDP = BK + 1;
  constexpr int NS = BK / 4, NA = D / 4;
  float* Qs = smem;
  float* Ks = Qs + BQ * LDQ;
  float* Vs = Ks + BK * LDK;
  float* Ps = Vs + BK * LDV;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int n = h / (H / KV);
  const int tid = threadIdx.x, r = tid >> 2, j4 = tid & 3;
  const int qpos = q_offset + q0 + r;
  const long long q_row = (long long)H * D, kv_row = (long long)KV * D;
  const float* kb = k + (long long)b * T_len * kv_row + (long long)n * D;
  const float* vb = v + (long long)b * T_len * kv_row + (long long)n * D;

  load_tile(Qs, LDQ, q + ((long long)b * S + q0) * q_row + (long long)h * D, q_row,
            min(BQ, S - q0), BQ, D);

  // kv positions any row of this tile may see; tiles outside are skipped
  int lo = 0, hi = T_len;
  if (causal) hi = min(hi, q_offset + min(q0 + BQ, S));
  if (window > 0) lo = max(lo, q_offset + q0 - window + 1);

  float m = NEG_INF, l = 0.f;
  float acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.f;

  for (int k0 = (lo / BK) * BK; k0 < hi; k0 += BK) {
    const int kval = min(BK, T_len - k0);
    __syncthreads();
    load_tile(Ks, LDK, kb + k0 * kv_row, kv_row, kval, BK, D);
    load_tile(Vs, LDV, vb + k0 * kv_row, kv_row, kval, BK, D);
    __syncthreads();

    float s[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = 0.f;
    const float* qr = Qs + r * LDQ;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qv = qr[d];
#pragma unroll
      for (int i = 0; i < NS; ++i) s[i] += qv * Ks[(j4 + 4 * i) * LDK + d];
    }

    bool ok[NS];
    float mx = NEG_INF;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int kpos = k0 + j4 + 4 * i;
      float x = s[i] * scale;
      if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
      bool valid = kpos < T_len;
      if (causal) valid = valid && kpos <= qpos;
      if (window > 0) valid = valid && kpos > qpos - window;
      ok[i] = valid;
      s[i] = valid ? x : NEG_INF;
      mx = fmaxf(mx, s[i]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const float p = ok[i] ? expf(s[i] - m_new) : 0.f;   // explicit mask on p
      sum += p;
      Ps[r * LDP + j4 + 4 * i] = p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float corr = expf(m - m_new);
    l = l * corr + sum;
    m = m_new;
    __syncwarp();   // the row's P is read only by the four threads that wrote it

#pragma unroll
    for (int i = 0; i < NA; ++i) acc[i] *= corr;
    const float* pr = Ps + r * LDP;
    for (int c = 0; c < kval; ++c) {
      const float p = pr[c];
      const float* vr = Vs + c * LDV + j4;
#pragma unroll
      for (int i = 0; i < NA; ++i) acc[i] += p * vr[4 * i];
    }
  }

  if (q0 + r < S) {
    float* orow = o + ((long long)b * S + q0 + r) * q_row + (long long)h * D;
#pragma unroll
    for (int i = 0; i < NA; ++i) orow[j4 + 4 * i] = acc[i] / (l + 1e-30f);
    if (lse != nullptr && j4 == 0)
      lse[((long long)b * S + q0 + r) * H + h] = m + logf(fmaxf(l, 1e-30f));
  }
}

template <int D>
int launch_fp32(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S,
                int T_len, int H, int KV, int causal, int window, float softcap, float scale,
                int q_offset, cudaStream_t stream) {
  const int bytes = smem_floats<D>() * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(attn_fwd_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  attn_fwd_kernel<D><<<grid, NT, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, S, T_len, H, KV, scale, causal, window, softcap, q_offset);
  return (int)cudaGetLastError();
}

// ------------------------------------ bf16: wgmma on the tensor cores, TMA

// Tile shape: two blocks fit an SM at D 128 and 256 (PERF.md).
template <int D>
struct Cfg {
  static constexpr int NWG = D == 256 ? 1 : 2;         // consumer warpgroups, 64 q rows each
  static constexpr int BQ = 64 * NWG;                  // q rows per block
  static constexpr int BK =                            // kv rows per tile
      D == 256 ? 32 : D == 128 ? 64 : 128;
  static constexpr int ST = 2;                         // stages of the K/V ring
  static constexpr int SW = D >= 64 ? 128 : 2 * D;     // swizzle span = bytes of one box row
  static constexpr int EB = SW / 2;                    // bf16 in one box row
  static constexpr int NB = D / EB;                    // boxes across D
  static constexpr uint64_t LAYOUT = SW == 128 ? 1 : SW == 64 ? 2 : 3;   // wgmma descriptor
  static constexpr int Q_BYTES = 64 * D * 2;           // one warpgroup's q tile
  static constexpr int KV_BYTES = BK * D * 2;          // one K or V tile
  static constexpr int SMEM = NWG * Q_BYTES + 2 * ST * KV_BYTES + 8 * (1 + 2 * ST) + 1024;
};

// tanh(x) = 1 - 2 / (e^2x + 1) on the SFU: absolute error ~1e-7 (an fp32
// ulp of 1), +-1 at the ends (rcp(inf) = 0)
__device__ __forceinline__ float tanh_sfu(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(ex2(x * (2.f * LOG2E)) + 1.f));
  return fmaf(-2.f, r, 1.f);
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::NWG * 128, 1)
attn_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_o,
               float* __restrict__ lse, int S, int T_len, int H, int KV, float scale, int causal,
               int window, float softcap, int q_offset) {
  using C = Cfg<D>;
  constexpr int BK = C::BK, ST = C::ST, SW = C::SW, EB = C::EB;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;   // swizzle atoms need 1024 B
  const uint32_t sK = sQ + C::NWG * C::Q_BYTES;
  const uint32_t sV = sK + ST * C::KV_BYTES;
  const uint32_t bar_q = sV + ST * C::KV_BYTES;               // then K full [ST], V full [ST]
  auto bar_k = [&](int s) { return bar_q + 8u * (1 + s); };
  auto bar_v = [&](int s) { return bar_q + 8u * (1 + ST + s); };

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * C::BQ;        // longest causal tiles first
  const int n = h / (H / KV);
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid & 127) >> 5, lane = tid & 31;

  // kv tiles any row of this block may see; tiles outside are never loaded
  int lo = 0, hi = T_len;
  if (causal) hi = min(hi, q_offset + min(q0 + C::BQ, S));
  if (window > 0) lo = max(lo, q_offset + q0 - window + 1);
  const int t0 = lo / BK;
  const int n_tiles = hi > lo ? (hi + BK - 1) / BK - t0 : 0;

  auto load_kv = [&](int it) {   // tile it into stage it % ST (one thread)
    const int s = it % ST, k0 = (t0 + it) * BK;
    mbar_expect_tx(bar_k(s), C::KV_BYTES);
#pragma unroll
    for (int j = 0; j < C::NB; ++j)
      tma_load(sK + s * C::KV_BYTES + j * BK * SW, &tm_k, bar_k(s), j * EB, n, k0, b);
    mbar_expect_tx(bar_v(s), C::KV_BYTES);
#pragma unroll
    for (int j = 0; j < C::NB; ++j)
      tma_load(sV + s * C::KV_BYTES + j * BK * SW, &tm_v, bar_v(s), j * EB, n, k0, b);
  };

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(bar_k(s), 1);
      mbar_init(bar_v(s), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0 && n_tiles > 0) {
    mbar_expect_tx(bar_q, C::NWG * C::Q_BYTES);
    for (int w = 0; w < C::NWG; ++w)
      for (int j = 0; j < C::NB; ++j)
        tma_load(sQ + w * C::Q_BYTES + j * 64 * SW, &tm_q, bar_q, j * EB, h, q0 + 64 * w, b);
    for (int it = 0; it < min(ST, n_tiles); ++it) load_kv(it);
  }
  __syncwarp();

  // this thread's accumulator rows: r0 and r0 + 8 of the warpgroup's 64
  const int qw0 = q0 + 64 * wg;
  const int r0 = 16 * warp + (lane >> 2), cq = 2 * (lane & 3);
  const int qpos0 = q_offset + qw0 + r0, qpos1 = qpos0 + 8;
  const int qa = q_offset + qw0, qb = q_offset + min(qw0 + 64, S) - 1;   // valid rows' positions
  const uint32_t sQw = sQ + wg * C::Q_BYTES;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;   // l: this thread's partial sums

  if (n_tiles > 0) mbar_wait(bar_q, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % ST;
    const uint32_t parity = (it / ST) & 1;
    const int k0 = (t0 + it) * BK, k1 = k0 + BK - 1;
    const bool dead = qw0 >= S || k0 >= T_len || (causal && k0 > qb) ||
                      (window > 0 && k1 <= qa - window);
    if (!dead) {
      const bool need_mask =
          k1 >= T_len || (causal && k1 > qa) || (window > 0 && k0 <= qb - window);
      mbar_wait(bar_k(s), parity);
      __syncwarp();

      // S = Q K^T over D in steps of 16 (32 bytes inside a swizzled box row)
      float sc[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = ((kk * 16) % EB) * 2;
        const uint64_t da = gmma_desc(sQw + (kk * 16 / EB) * 64 * SW + off, 16, 8 * SW, C::LAYOUT);
        const uint64_t db = gmma_desc(sK + s * C::KV_BYTES + (kk * 16 / EB) * BK * SW + off, 16,
                                      8 * SW, C::LAYOUT);
        wgmma_ss(sc, da, db, kk > 0);
      }
      wgmma_commit();
      fence_regs(sc);
      wgmma_wait_all();
      fence_regs(sc);

      // softmax on the fragments: sc[j] is row r0 + 8 * ((j >> 1) & 1),
      // column 8 * (j >> 2) + cq + (j & 1); fp32 throughout
      auto valid = [&](int j) {
        const int kpos = k0 + 8 * (j >> 2) + cq + (j & 1);
        const int qpos = (j & 2) ? qpos1 : qpos0;
        bool ok = kpos < T_len;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        return ok;
      };
      float mx0 = NEG_INF, mx1 = NEG_INF;
      // each step is its own branch-free pass; a uniform branch per tile
      // picks the softcap and mask passes
      if (softcap > 0.f) {
#pragma unroll
        for (int j = 0; j < BK / 2; ++j) sc[j] = tanh_sfu(sc[j] * scale / softcap) * softcap;
      } else {
#pragma unroll
        for (int j = 0; j < BK / 2; ++j) sc[j] *= scale;
      }
      if (need_mask) {
#pragma unroll
        for (int j = 0; j < BK / 2; ++j)
          if (!valid(j)) sc[j] = NEG_INF;
      }
#pragma unroll
      for (int j = 0; j < BK / 2; j += 4) {
        mx0 = fmaxf(mx0, fmaxf(sc[j], sc[j + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[j + 2], sc[j + 3]));
      }
#pragma unroll
      for (int d = 1; d <= 2; d <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, d));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, d));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float corr0 = ex2((m0 - mn0) * LOG2E), corr1 = ex2((m1 - mn1) * LOG2E);
      const float ms0 = mn0 * LOG2E, ms1 = mn1 * LOG2E;
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int j = 0; j < BK / 2; j += 4) {
        sc[j] = ex2(fmaf(sc[j], LOG2E, -ms0));
        sc[j + 1] = ex2(fmaf(sc[j + 1], LOG2E, -ms0));
        sc[j + 2] = ex2(fmaf(sc[j + 2], LOG2E, -ms1));
        sc[j + 3] = ex2(fmaf(sc[j + 3], LOG2E, -ms1));
      }
      if (need_mask) {   // explicit mask on p: a masked tile adds exactly 0
#pragma unroll
        for (int j = 0; j < BK / 2; ++j)
          if (!valid(j)) sc[j] = 0.f;
      }
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 2; j += 4) {
        sum0 += sc[j] + sc[j + 1];
        sum1 += sc[j + 2] + sc[j + 3];
      }
      l0 = l0 * corr0 + sum0;
      l1 = l1 * corr1 + sum1;
#pragma unroll
      for (int j = 0; j < D / 2; ++j) acc[j] *= (j & 2) ? corr1 : corr0;
      // P in bf16 as the A fragments of m64k16: the accumulator layout of
      // columns 16 kk .. 16 kk + 15 is the A layout
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pa[kk][i] = pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);

      // O += P V over the tile's kv rows in steps of 16 (two 8-row swizzle
      // atoms); V is MN-major: its D columns are the leading dimension
      mbar_wait(bar_v(s), parity);
      __syncwarp();
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t db = gmma_desc(sV + s * C::KV_BYTES + kk * 16 * SW, BK * SW, 8 * SW,
                                      C::LAYOUT);
        wgmma_rs(acc, pa[kk], db);
      }
      wgmma_commit();
      fence_regs(acc);
      wgmma_wait_all();
      fence_regs(acc);
    }
    __syncthreads();   // every warpgroup is done with stage s: refill it
    if (tid == 0) {
      // the copies have landed (a warpgroup that skipped the tile did not
      // wait): no copy is in flight into a stage being refilled, or at exit
      mbar_wait(bar_k(s), parity);
      mbar_wait(bar_v(s), parity);
      if (it + ST < n_tiles) load_kv(it + ST);
    }
    __syncwarp();
  }

#pragma unroll
  for (int d = 1; d <= 2; d <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, d);
    l1 += __shfl_xor_sync(0xffffffffu, l1, d);
  }
  // epilogue: O / l in bf16 into the warpgroup's q tile (its last reader,
  // the last S wgmma, has completed), swizzled as the map expects, then
  // one TMA store per box; rows past S are not written
  if (qw0 >= S) return;
  if (lse != nullptr && (lane & 3) == 0) {   // m and l agree across the row's 4 lanes
    const long long row = (long long)b * S + qw0 + r0;
    if (qw0 + r0 < S) lse[row * H + h] = m0 + logf(fmaxf(l0, 1e-30f));
    if (qw0 + r0 + 8 < S) lse[(row + 8) * H + h] = m1 + logf(fmaxf(l1, 1e-30f));
  }
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int col = 8 * i + cq;
    const uint32_t box = sQw + (col / EB) * 64 * SW;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float l = half ? l1 : l0;
      uint32_t off = (r0 + 8 * half) * SW + (col % EB) * 2;
      off ^= ((off >> 7) & (SW / 16 - 1)) << 4;   // the TMA's swizzle of 16-byte chunks
      const uint32_t v =
          pack_bf16(acc[4 * i + 2 * half] / (l + 1e-30f), acc[4 * i + 2 * half + 1] / (l + 1e-30f));
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(box + off), "r"(v) : "memory");
    }
  }
  fence_proxy_async();              // visible to the TMA
  named_barrier(1 + wg, 128);       // this warpgroup's writes
  if ((tid & 127) == 0) {
#pragma unroll
    for (int j = 0; j < C::NB; ++j) tma_store(&tm_o, sQw + j * 64 * SW, j * EB, h, qw0, b);
    bulk_commit();
    bulk_wait_read<0>();            // smem read before exit
  }
}

// 4-D map over a contiguous bf16 [B, L, heads, D], box {EB, 1, rows, 1}
template <int D>
int encode(CUtensorMap* map, const void* ptr, int B, int L, int heads, int rows) {
  using C = Cfg<D>;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)L * heads * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)C::EB, 1, (cuuint32_t)rows, 1};
  return encode_bf16(map, ptr, 4, dims, strides, box, C::SW);
}

__global__ void fill_kernel(float* __restrict__ x, long long n, float value) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    x[i] = value;
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S,
                int T_len, int H, int KV, int causal, int window, float softcap, float scale,
                int q_offset, cudaStream_t stream) {
  using C = Cfg<D>;
  if (T_len == 0) {   // nothing to attend to: acc / (0 + 1e-30) = 0, lse = m = -1e30
    cudaError_t e = cudaMemsetAsync(o, 0, (size_t)B * S * H * D * 2, stream);
    if (e != cudaSuccess || lse == nullptr) return (int)e;
    const long long n = (long long)B * S * H;
    fill_kernel<<<(int)((n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024), 256, 0, stream>>>(
        lse, n, NEG_INF);
    return (int)cudaGetLastError();
  }
  CUtensorMap tq, tk, tv, to;
  int rc = encode<D>(&tq, q, B, S, H, 64);
  if (rc == 0) rc = encode<D>(&tk, k, B, T_len, KV, C::BK);
  if (rc == 0) rc = encode<D>(&tv, v, B, T_len, KV, C::BK);
  if (rc == 0) rc = encode<D>(&to, o, B, S, H, 64);
  if (rc != 0) return rc;
  cudaError_t e = cudaFuncSetAttribute(attn_fwd_wgmma<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(H, B, (S + C::BQ - 1) / C::BQ);
  attn_fwd_wgmma<D><<<grid, C::NWG * 128, C::SMEM, stream>>>(
      tq, tk, tv, to, lse, S, T_len, H, KV, scale, causal, window, softcap, q_offset);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (wgmma + TMA); q, k, v and
// o all of it. lse: fp32 [B, S, H], or nullptr for none. Returns 0, a
// cudaError_t, or ENCODE_ERROR + a CUresult; the Python wrapper raises on
// non-zero.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int B, int S, int T_len, int H, int KV, int D,
                                   int dtype, int causal, int window, float softcap, float scale,
                                   int q_offset, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ls = static_cast<float*>(lse);
#define FA_ARGS q, k, v, o, ls, B, S, T_len, H, KV, causal, window, softcap, scale, q_offset, st
  if (dtype == 0) switch (D) {
      case 16: return launch_fp32<16>(FA_ARGS);
      case 32: return launch_fp32<32>(FA_ARGS);
      case 64: return launch_fp32<64>(FA_ARGS);
      case 128: return launch_fp32<128>(FA_ARGS);
      case 256: return launch_fp32<256>(FA_ARGS);
    }
  if (dtype == 1) switch (D) {
      case 16: return launch_bf16<16>(FA_ARGS);
      case 32: return launch_bf16<32>(FA_ARGS);
      case 64: return launch_bf16<64>(FA_ARGS);
      case 128: return launch_bf16<128>(FA_ARGS);
      case 256: return launch_bf16<256>(FA_ARGS);
    }
#undef FA_ARGS
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int err) {
  return hopper_error_string(err);
}
