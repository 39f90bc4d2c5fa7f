// Attention backward for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces: src/repro/kernels/flash_attention/ops.py:159 `_mha_bwd_impl`,
// the backward of the reference's custom VJP (XLA code, not Pallas): given
// (q, k, v, out, lse, dout) it recomputes each tile's scores and returns
// (dq, dk, dv). Per (query i, key j) pair, as the reference writes it:
//   s = (q_i . k_j) * scale, softcapped s = tanh(s / c) * c with t = tanh,
//   p = exp(s - lse_i) masked (causal with q_offset, window, kpos < T),
//   dp = dout_i . v_j, ds = p * (dp - delta_i) (* (1 - t^2) under a softcap),
//   delta_i = rowsum(dout_i * out_i) in fp32,
//   dq_i += ds * k_j * scale, dk_j += ds * q_i * scale, dv_j += p * dout_i,
// with p and ds rounded to the input dtype before their products and every
// sum in fp32. A masked pair contributes exactly zero (p is selected to 0,
// never multiplied by the mask).
//
// Bound on the H100: operations. The two passes below make seven products
// of 2 D FLOP a visible pair and head (S and dP twice, dV, dK, dQ); at
// internvl2-2b's train_4k heads (B 2, S 4096, H 16, KV 8, D 128, causal)
// that is 4.8e11 FLOP, 0.486 ms at 989 TFLOP/s bf16. The bytes (q, k, v,
// out, dout read, dq, dk, dv written, ~0.1 GB) take a tenth of that.
//
// Three launches on the caller's stream:
// - bwd_prep: delta = rowsum(dout * out) in fp32 and lse * log2(e), both
//   transposed to [B, H, Sp] (Sp = S rounded up to ROW_PAD) so that a block
//   reads 64 consecutive queries' values with one TMA copy; the padded rows
//   get lse = +inf and delta = 0, so their p and ds are exactly 0 and no
//   kernel masks queries past S.
// - dK/dV (attn_bwd_dkdv): one block per (KV head, batch row, block of
//   keys). K and V stay in shared memory; Q, dO and the lse and delta of 64
//   queries stream through a TMA ring, over every query head of the GQA
//   group and every query tile that sees the block (from the causal
//   diagonal; up to the window's end). The block computes the transposed
//   tile, S^T = K Q^T and dP^T = V dO^T (SS wgmma, K-major), so P^T and dS^T
//   come out in the accumulator layout that is the A-fragment layout of the
//   next products: dV += P^T dO and dK += dS^T Q run as RS wgmma with dO and
//   Q as the MN-major B operand, the same tiles the first products read
//   K-major. The fp32 dK and dV stay in registers for the whole loop, so the
//   sum over the group's heads needs no atomics and the result is
//   deterministic.
// - dQ (attn_bwd_dq): one block per (head, batch row, 128 queries), Q and dO
//   loaded once, K and V through a TMA ring; S = Q K^T and dP = dO V^T (SS),
//   dS in registers, dQ += dS K (RS, K MN-major).
// In both, two consumer warpgroups share the ring and do not keep step: the
// second one done with a stage issues its refill (a count in shared memory
// says which), so one warpgroup's softmax runs under the other's products;
// and without a softcap p is computed while dP's product still runs.
// Tiles: D decides them. At D <= 128 the dK/dV block holds 128 keys, one
// warpgroup on each 64; at D 256 the 64 x 256 fp32 dK and dV would need 256
// registers a thread, so the block holds 64 keys and its two warpgroups
// split D: each computes the whole S^T and dP^T tile and accumulates half of
// dK's and dV's columns. The dQ block's key tile is 128 keys at D <= 128
// and 32 at D 256, for the same reason; the rings have 3 stages, 2 where
// shared memory allows no more (dK/dV at D 256, dQ at D >= 128). Dead tiles
// (no visible pair for a warpgroup's rows) are skipped, the mask is
// computed only on tiles that cross the causal or window diagonal or the
// end of T, and the longest blocks launch first.
//
// What bounds it on this card: a warpgroup's products wait through its own
// softmax, which only the other warpgroup's products hide; dK, dV, S^T and
// dP^T take ~225 registers a thread, so no third warpgroup fits. Measured
// on one H100 (PERF.md): 1.07 ms at internvl2-2b's train_4k heads, 46% of
// the seven products' bound, against SDPA's backward's 0.90 ms. A producer
// warp with register budgets per role (setmaxnreg) is the next step.
//
// fp32 inputs run on the CUDA cores in full fp32 (attn_bwd_dkdv_fp32,
// attn_bwd_dq_fp32), as the forward's fp32 route: the tensor cores would
// compute them in TF32. Four threads own one row (a key row for dK/dV, a
// query row for dQ), tiles staged in padded fp32 shared memory.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>

#include "hopper.cuh"   // TMA, mbarrier and wgmma helpers (kernels/csrc)

namespace {

constexpr int ROW_PAD = 128;   // Sp = S rounded up to this (kernel.py: ROW_PAD)

// tanh(x) = 1 - 2 / (e^2x + 1) on the SFU, as the forward computes it
__device__ __forceinline__ float tanh_sfu(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(ex2(x * (2.f * LOG2E)) + 1.f));
  return fmaf(-2.f, r, 1.f);
}

__device__ __forceinline__ bool visible(int kpos, int qpos, int causal, int window) {
  bool ok = true;
  if (causal) ok = kpos <= qpos;
  if (window > 0) ok = ok && kpos > qpos - window;
  return ok;
}

// ------------------------------------------- preprocess: delta and lse

__device__ __forceinline__ float dot8(const float* a, const float* b) {
  const float4 a0 = reinterpret_cast<const float4*>(a)[0], a1 = reinterpret_cast<const float4*>(a)[1];
  const float4 b0 = reinterpret_cast<const float4*>(b)[0], b1 = reinterpret_cast<const float4*>(b)[1];
  return a0.x * b0.x + a0.y * b0.y + a0.z * b0.z + a0.w * b0.w + a1.x * b1.x + a1.y * b1.y +
         a1.z * b1.z + a1.w * b1.w;
}

__device__ __forceinline__ float dot8(const __nv_bfloat16* a, const __nv_bfloat16* b) {
  const uint4 x = *reinterpret_cast<const uint4*>(a), y = *reinterpret_cast<const uint4*>(b);
  const __nv_bfloat162* xa = reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162* ya = reinterpret_cast<const __nv_bfloat162*>(&y);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(xa[i]), w = __bfloat1622float2(ya[i]);
    s += u.x * w.x + u.y * w.y;
  }
  return s;
}

// D / 8 consecutive threads per (b, s, h) row, 8 elements each; writes
// lse2[b, h, s] = lse * log2(e) and delta[b, h, s], and +inf / 0 for the
// padded rows s in [S, Sp). The thread count, B * Sp * H * D / 8, is a
// multiple of 32 (Sp of ROW_PAD), so every lane of a warp runs each
// iteration of the grid-stride loop.
template <typename T>
__global__ void bwd_prep(const T* __restrict__ out, const T* __restrict__ dout,
                         const float* __restrict__ lse, float* __restrict__ lse2,
                         float* __restrict__ delta, int S, int Sp, int H, int D, long long n) {
  const int L = D / 8;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long row = i / L;
    const int part = (int)(i - row * L);
    const int h = (int)(row % H);
    const long long bs = row / H;
    const int s = (int)(bs % Sp);
    const long long b = bs / Sp;
    float acc = 0.f;
    const long long src = ((b * S + s) * H + h) * D + part * 8;
    if (s < S) acc = dot8(out + src, dout + src);
    for (int off = L / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (part == 0) {
      const long long dst = (b * H + h) * Sp + s;
      delta[dst] = s < S ? acc : 0.f;
      lse2[dst] = s < S ? lse[(b * S + s) * H + h] * LOG2E : INFINITY;
    }
  }
}

// ------------------------------------ bf16: wgmma on the tensor cores, TMA

template <int D>
struct Bwd {
  static constexpr int SW = D >= 64 ? 128 : 2 * D;     // swizzle span = bytes of one box row
  static constexpr int EB = SW / 2;                    // bf16 in one box row
  static constexpr int NB = D / EB;                    // boxes across D
  static constexpr uint64_t LAYOUT = SW == 128 ? 1 : SW == 64 ? 2 : 3;   // wgmma descriptor
  static constexpr int TILE = 64 * D * 2;              // a 64-row tile: NB boxes of 64 rows
  // dK/dV: two warpgroups, on 64 keys each (KW 2) or on half of D each (CW 2)
  static constexpr int ST = D == 256 ? 2 : 3;          // stages of the Q/dO ring
  static constexpr int KW = D == 256 ? 1 : 2;
  static constexpr int CW = 2 / KW;
  static constexpr int BN = 64 * KW;                   // keys per block
  static constexpr int DC = D / CW;                    // dK/dV columns per warpgroup
  static constexpr int BM = 64;                        // queries per tile
  static constexpr int KV_SMEM =
      2 * KW * TILE + ST * 2 * TILE + ST * 2 * BM * 4 + 8 * (1 + 2 * ST) + 4 * ST + 1024;
  // dQ: two warpgroups of 64 query rows; BK keys per tile, QST stages of
  // the K/V ring
  static constexpr int BK = D == 256 ? 32 : 128;
  static constexpr int QST = D >= 128 ? 2 : 3;
  static constexpr int KT = BK * D * 2;                // one K or V tile
  static constexpr int Q_SMEM = 2 * 2 * TILE + QST * 2 * KT + 8 * (1 + 2 * QST) + 4 * QST + 1024;
};

// descriptor of a K-major operand: k-step kk (16 elements of D) of a tile
// of `rows`-row boxes
template <int D>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int rows, int kk) {
  using C = Bwd<D>;
  const uint32_t off = ((kk * 16) % C::EB) * 2;
  return gmma_desc(tile + (kk * 16 / C::EB) * rows * C::SW + off, 16, 8 * C::SW, C::LAYOUT);
}

// descriptor of an MN-major B operand (D along N): rows 16 kk .. 16 kk + 15
// of a tile of `rows`-row boxes, from box `box0` on
template <int D>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int rows, int kk, int box0) {
  using C = Bwd<D>;
  return gmma_desc(tile + box0 * rows * C::SW + kk * 16 * C::SW, rows * C::SW, 8 * C::SW,
                   C::LAYOUT);
}

// bf16 pair (cols c, c + 1 of row r) into a swizzled box of `rows` rows
template <int D>
__device__ __forceinline__ void st_pair(uint32_t tile, int rows, int r, int col, float a, float b) {
  using C = Bwd<D>;
  const uint32_t box = tile + (col / C::EB) * rows * C::SW;
  uint32_t off = r * C::SW + (col % C::EB) * 2;
  off ^= ((off >> 7) & (C::SW / 16 - 1)) << 4;   // the TMA's swizzle of 16-byte chunks
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(box + off), "r"(pack_bf16(a, b)) : "memory");
}

template <int D>
__global__ void __launch_bounds__(256, 1)
attn_bwd_dkdv(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
              const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
              const __grid_constant__ CUtensorMap tm_dk, const __grid_constant__ CUtensorMap tm_dv,
              const __grid_constant__ CUtensorMap tm_lse, const __grid_constant__ CUtensorMap tm_dl,
              int S, int T_len, int H, int KV, float scale, int causal, int window, float softcap,
              int q_offset) {
  using C = Bwd<D>;
  constexpr int BM = C::BM, ST = C::ST, SW = C::SW, EB = C::EB, NB = C::NB, DC = C::DC;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sK = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sV = sK + C::KW * C::TILE;
  const uint32_t sQ = sV + C::KW * C::TILE;        // [ST] tiles
  const uint32_t sO = sQ + ST * C::TILE;           // dO, [ST] tiles
  const uint32_t sL = sO + ST * C::TILE;           // lse2, [ST][BM] fp32
  const uint32_t sD = sL + ST * BM * 4;            // delta, [ST][BM] fp32
  const uint32_t bar_kv = sD + ST * BM * 4;        // then Q full [ST], dO full [ST]
  auto bar_q = [&](int s) { return bar_kv + 8u * (1 + s); };
  auto bar_o = [&](int s) { return bar_kv + 8u * (1 + ST + s); };
  const float* Ls = reinterpret_cast<const float*>(smem_raw + (sL - smem_u32(smem_raw)));
  const float* Ds = reinterpret_cast<const float*>(smem_raw + (sD - smem_u32(smem_raw)));
  // per stage, the warpgroups that are done with it (see release)
  unsigned* done = reinterpret_cast<unsigned*>(smem_raw + (bar_kv + 8 * (1 + 2 * ST) - smem_u32(smem_raw)));

  const int n = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * C::BN;   // longest causal blocks first
  const int G = H / KV;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid & 127) >> 5, lane = tid & 31;

  // query tiles that see a key of this block
  int qlo = 0, qhi = S;
  if (causal) qlo = max(0, k0 - q_offset);
  if (window > 0) qhi = min(S, k0 + C::BN - 1 + window - q_offset);
  const int t0 = qlo / BM;
  const int nq = qhi > qlo ? (qhi + BM - 1) / BM - t0 : 0;
  const int n_tiles = G * nq;

  auto load_q = [&](int it) {   // tile it into stage it % ST (one thread)
    const int s = it % ST, h = n * G + it / nq, q0 = (t0 + it % nq) * BM;
    mbar_expect_tx(bar_q(s), C::TILE + BM * 4);
#pragma unroll
    for (int j = 0; j < NB; ++j)
      tma_load(sQ + s * C::TILE + j * 64 * SW, &tm_q, bar_q(s), j * EB, h, q0, b);
    tma_load(sL + s * BM * 4, &tm_lse, bar_q(s), q0, b * H + h);
    mbar_expect_tx(bar_o(s), C::TILE + BM * 4);
#pragma unroll
    for (int j = 0; j < NB; ++j)
      tma_load(sO + s * C::TILE + j * 64 * SW, &tm_do, bar_o(s), j * EB, h, q0, b);
    tma_load(sD + s * BM * 4, &tm_dl, bar_o(s), q0, b * H + h);
  };

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(bar_q(s), 1);
      mbar_init(bar_o(s), 1);
      done[s] = 0;
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0 && n_tiles > 0) {
    mbar_expect_tx(bar_kv, 2 * C::KW * C::TILE);
    for (int w = 0; w < C::KW; ++w)
      for (int j = 0; j < NB; ++j) {
        tma_load(sK + (w * NB + j) * 64 * SW, &tm_k, bar_kv, j * EB, n, k0 + 64 * w, b);
        tma_load(sV + (w * NB + j) * 64 * SW, &tm_v, bar_kv, j * EB, n, k0 + 64 * w, b);
      }
    for (int it = 0; it < min(ST, n_tiles); ++it) load_q(it);
  }
  __syncwarp();

  // this warpgroup's keys (kg) and dK/dV columns (cg); the thread's
  // accumulator rows r0 and r0 + 8 of its 64 keys, columns cq, cq + 1 of 8
  const int kg = C::KW == 2 ? wg : 0, cg = C::CW == 2 ? wg : 0;
  const int ka = k0 + 64 * kg, kz = ka + 63;
  const int r0 = 16 * warp + (lane >> 2), cq = 2 * (lane & 3);
  const int kpos0 = ka + r0, kpos1 = kpos0 + 8;
  const uint32_t sKw = sK + kg * C::TILE, sVw = sV + kg * C::TILE;

  float dk[DC / 2], dv[DC / 2];
#pragma unroll
  for (int i = 0; i < DC / 2; ++i) dk[i] = dv[i] = 0.f;

  if (n_tiles > 0) mbar_wait(bar_kv, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % ST;
    const uint32_t parity = (it / ST) & 1;
    const int q0 = (t0 + it % nq) * BM;
    const int qa = q_offset + q0, qb = qa + BM - 1;   // the tile's query positions
    const bool dead = ka >= T_len || (causal && ka > qb) || (window > 0 && kz <= qa - window);
    // every warpgroup waits for the tile, dead or not: none can release a
    // stage for a tile whose copies were not issued yet (see below)
    mbar_wait(bar_q(s), parity);
    mbar_wait(bar_o(s), parity);
    __syncwarp();
    if (!dead) {
      const bool need_mask = (causal && kz > qa) || (window > 0 && ka <= qb - window);

      // S^T = K Q^T and dP^T = V dO^T over D, one group
      float st[BM / 2], dpt[BM / 2];
#pragma unroll
      for (int i = 0; i < BM / 2; ++i) st[i] = dpt[i] = 0.f;
      fence_regs(st);
      fence_regs(dpt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(st, desc_k<D>(sKw, 64, kk), desc_k<D>(sQ + s * C::TILE, 64, kk), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(dpt, desc_k<D>(sVw, 64, kk), desc_k<D>(sO + s * C::TILE, 64, kk), kk > 0);
      wgmma_commit();
      fence_regs(st);
      fence_regs(dpt);

      // p and ds on the fragments: st[j] is key row r0 + 8 * ((j >> 1) & 1),
      // query column 8 * (j >> 2) + cq + (j & 1); fp32 throughout
      const float* L = Ls + s * BM;
      const float* Dl = Ds + s * BM;
      auto masked = [&](int i, int e) {
        return need_mask &&
               !visible((e & 2) ? kpos1 : kpos0, qa + 8 * i + cq + (e & 1), causal, window);
      };
      if (softcap > 0.f) {   // ds needs the softcap's 1 - tanh^2 beside p: one pass
        wgmma_wait_all();
        fence_regs(st);
        fence_regs(dpt);
#pragma unroll
        for (int i = 0; i < BM / 8; ++i) {
          const float2 l2 = *reinterpret_cast<const float2*>(L + 8 * i + cq);
          const float2 d2 = *reinterpret_cast<const float2*>(Dl + 8 * i + cq);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = 4 * i + e;
            const float t = tanh_sfu(st[j] * scale / softcap);
            float p = ex2(fmaf(t * softcap, LOG2E, -((e & 1) ? l2.y : l2.x)));
            if (masked(i, e)) p = 0.f;
            st[j] = p;
            dpt[j] = p * (dpt[j] - ((e & 1) ? d2.y : d2.x)) * (1.f - t * t);
          }
        }
      } else {   // p while dP^T is still on the tensor cores, then ds
        wgmma_wait<1>();
        fence_regs(st);
#pragma unroll
        for (int i = 0; i < BM / 8; ++i) {
          const float2 l2 = *reinterpret_cast<const float2*>(L + 8 * i + cq);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = 4 * i + e;
            const float p = ex2(fmaf(st[j] * scale, LOG2E, -((e & 1) ? l2.y : l2.x)));
            st[j] = masked(i, e) ? 0.f : p;
          }
        }
        wgmma_wait_all();
        fence_regs(dpt);
#pragma unroll
        for (int i = 0; i < BM / 8; ++i) {
          const float2 d2 = *reinterpret_cast<const float2*>(Dl + 8 * i + cq);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = 4 * i + e;
            dpt[j] = st[j] * (dpt[j] - ((e & 1) ? d2.y : d2.x));
          }
        }
      }
      // P^T and dS^T in bf16 as the A fragments of m64k16 (the accumulator
      // layout of columns 16 kk .. 16 kk + 15 is the A layout)
      uint32_t pa[BM / 16][4], da[BM / 16][4];
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pa[kk][i] = pack_bf16(st[8 * kk + 2 * i], st[8 * kk + 2 * i + 1]);
          da[kk][i] = pack_bf16(dpt[8 * kk + 2 * i], dpt[8 * kk + 2 * i + 1]);
        }

      // dV += P^T dO, dK += dS^T Q over the tile's queries: dO and Q are the
      // MN-major B operand (D along N), this warpgroup's DC columns
      fence_regs(dv);
      fence_regs(dk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk)
        wgmma_rs(dv, pa[kk], desc_mn<D>(sO + s * C::TILE, 64, kk, cg * (DC / EB)));
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk)
        wgmma_rs(dk, da[kk], desc_mn<D>(sQ + s * C::TILE, 64, kk, cg * (DC / EB)));
      wgmma_commit();
      fence_regs(dv);
      fence_regs(dk);
      wgmma_wait_all();
      fence_regs(dv);
      fence_regs(dk);
    }
    // the second warpgroup done with stage s refills it, so the two need
    // not keep step: one's softmax runs under the other's products. Each
    // arrives once a tile, after the tile's copies landed, so the count of
    // stage s is odd exactly at the second arrival of its current tile.
    named_barrier(1 + wg, 128);     // this warpgroup's reads of stage s are done
    if ((tid & 127) == 0) {
      __threadfence_block();
      if ((atomicAdd(done + s, 1u) & 1u) && it + ST < n_tiles) load_q(it + ST);
    }
    __syncwarp();
  }
  __syncthreads();   // K and V read by both warpgroups: free to overwrite

  // epilogue: dK * scale and dV in bf16 into the K and V tiles, swizzled as
  // the maps expect, then one TMA store per box; keys past T are clipped
  if (ka >= T_len) return;
#pragma unroll
  for (int i = 0; i < DC / 8; ++i) {
    const int col = cg * DC + 8 * i + cq;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + 8 * half, a = 4 * i + 2 * half;
      st_pair<D>(sKw, 64, r, col, dk[a] * scale, dk[a + 1] * scale);
      st_pair<D>(sVw, 64, r, col, dv[a], dv[a + 1]);
    }
  }
  fence_proxy_async();              // visible to the TMA
  named_barrier(1 + wg, 128);       // this warpgroup's writes
  if ((tid & 127) == 0) {
#pragma unroll
    for (int j = cg * (DC / EB); j < (cg + 1) * (DC / EB); ++j) {
      tma_store(&tm_dk, sKw + j * 64 * SW, j * EB, n, ka, b);
      tma_store(&tm_dv, sVw + j * 64 * SW, j * EB, n, ka, b);
    }
    bulk_commit();
    bulk_wait_read<0>();            // smem read before exit
  }
}

template <int D>
__global__ void __launch_bounds__(256, 1)
attn_bwd_dq(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
            const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
            const __grid_constant__ CUtensorMap tm_dq, const float* __restrict__ lse2,
            const float* __restrict__ delta, int S, int Sp, int T_len, int H, int KV, float scale,
            int causal, int window, float softcap, int q_offset) {
  using C = Bwd<D>;
  constexpr int BK = C::BK, ST = C::QST, SW = C::SW, EB = C::EB, NB = C::NB;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;   // [2] warpgroups' tiles
  const uint32_t sO = sQ + 2 * C::TILE;                       // dO, [2]
  const uint32_t sK = sO + 2 * C::TILE;                       // [ST]
  const uint32_t sV = sK + ST * C::KT;                        // [ST]
  const uint32_t bar_q = sV + ST * C::KT;                     // then K full [ST], V full [ST]
  auto bar_k = [&](int s) { return bar_q + 8u * (1 + s); };
  auto bar_v = [&](int s) { return bar_q + 8u * (1 + ST + s); };
  unsigned* done = reinterpret_cast<unsigned*>(smem_raw + (bar_q + 8 * (1 + 2 * ST) - smem_u32(smem_raw)));

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * 128;          // longest causal tiles first
  const int n = h / (H / KV);
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid & 127) >> 5, lane = tid & 31;

  // key tiles any query of this block sees
  int lo = 0, hi = T_len;
  if (causal) hi = min(hi, q_offset + min(q0 + 128, S));
  if (window > 0) lo = max(lo, q_offset + q0 - window + 1);
  const int t0 = lo / BK;
  const int n_tiles = hi > lo ? (hi + BK - 1) / BK - t0 : 0;

  auto load_kv = [&](int it) {   // tile it into stage it % ST (one thread)
    const int s = it % ST, k0 = (t0 + it) * BK;
    mbar_expect_tx(bar_k(s), C::KT);
#pragma unroll
    for (int j = 0; j < NB; ++j)
      tma_load(sK + s * C::KT + j * BK * SW, &tm_k, bar_k(s), j * EB, n, k0, b);
    mbar_expect_tx(bar_v(s), C::KT);
#pragma unroll
    for (int j = 0; j < NB; ++j)
      tma_load(sV + s * C::KT + j * BK * SW, &tm_v, bar_v(s), j * EB, n, k0, b);
  };

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(bar_k(s), 1);
      mbar_init(bar_v(s), 1);
      done[s] = 0;
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0 && n_tiles > 0) {
    mbar_expect_tx(bar_q, 4 * C::TILE);
    for (int w = 0; w < 2; ++w)
      for (int j = 0; j < NB; ++j) {
        tma_load(sQ + w * C::TILE + j * 64 * SW, &tm_q, bar_q, j * EB, h, q0 + 64 * w, b);
        tma_load(sO + w * C::TILE + j * 64 * SW, &tm_do, bar_q, j * EB, h, q0 + 64 * w, b);
      }
    for (int it = 0; it < min(ST, n_tiles); ++it) load_kv(it);
  }
  __syncwarp();

  // this thread's accumulator rows: r0 and r0 + 8 of the warpgroup's 64
  const int qw0 = q0 + 64 * wg;
  const int r0 = 16 * warp + (lane >> 2), cq = 2 * (lane & 3);
  const int qpos0 = q_offset + qw0 + r0, qpos1 = qpos0 + 8;
  const int qa = q_offset + qw0, qb = q_offset + min(qw0 + 64, S) - 1;   // valid rows' positions
  const uint32_t sQw = sQ + wg * C::TILE, sOw = sO + wg * C::TILE;
  // rows past S read the padding: lse2 +inf, delta 0 (Sp >= q0 + 128)
  const long long lrow = ((long long)b * H + h) * Sp + qw0 + r0;
  const float l2_0 = lse2[lrow], l2_1 = lse2[lrow + 8];
  const float dl_0 = delta[lrow], dl_1 = delta[lrow + 8];

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  if (n_tiles > 0) mbar_wait(bar_q, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % ST;
    const uint32_t parity = (it / ST) & 1;
    const int k0 = (t0 + it) * BK, k1 = k0 + BK - 1;
    const bool dead = qw0 >= S || (causal && k0 > qb) || (window > 0 && k1 <= qa - window);
    mbar_wait(bar_k(s), parity);    // dead or not, as in attn_bwd_dkdv
    mbar_wait(bar_v(s), parity);
    __syncwarp();
    if (!dead) {
      const bool need_mask =
          k1 >= T_len || (causal && k1 > qa) || (window > 0 && k0 <= qb - window);

      // S = Q K^T and dP = dO V^T over D, one group
      float sc[BK / 2], dp[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[i] = dp[i] = 0.f;
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(sc, desc_k<D>(sQw, 64, kk), desc_k<D>(sK + s * C::KT, BK, kk), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(dp, desc_k<D>(sOw, 64, kk), desc_k<D>(sV + s * C::KT, BK, kk), kk > 0);
      wgmma_commit();
      fence_regs(sc);
      fence_regs(dp);

      // ds on the fragments: sc[j] is row r0 + 8 * ((j >> 1) & 1), key
      // column 8 * (j >> 2) + cq + (j & 1)
      auto masked = [&](int j) {
        const int kpos = k0 + 8 * (j >> 2) + cq + (j & 1);
        return need_mask &&
               (kpos >= T_len || !visible(kpos, (j & 2) ? qpos1 : qpos0, causal, window));
      };
      if (softcap > 0.f) {   // ds needs the softcap's 1 - tanh^2 beside p: one pass
        wgmma_wait_all();
        fence_regs(sc);
        fence_regs(dp);
#pragma unroll
        for (int j = 0; j < BK / 2; ++j) {
          const float t = tanh_sfu(sc[j] * scale / softcap);
          float p = ex2(fmaf(t * softcap, LOG2E, -((j & 2) ? l2_1 : l2_0)));
          if (masked(j)) p = 0.f;
          sc[j] = p * (dp[j] - ((j & 2) ? dl_1 : dl_0)) * (1.f - t * t);
        }
      } else {   // p while dP is still on the tensor cores, then ds
        wgmma_wait<1>();
        fence_regs(sc);
#pragma unroll
        for (int j = 0; j < BK / 2; ++j) {
          const float p = ex2(fmaf(sc[j] * scale, LOG2E, -((j & 2) ? l2_1 : l2_0)));
          sc[j] = masked(j) ? 0.f : p;
        }
        wgmma_wait_all();
        fence_regs(dp);
#pragma unroll
        for (int j = 0; j < BK / 2; ++j) sc[j] *= dp[j] - ((j & 2) ? dl_1 : dl_0);
      }
      uint32_t da[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) da[kk][i] = pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);

      // dQ += dS K over the tile's keys; K is the MN-major B operand
      fence_regs(dq);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs(dq, da[kk], desc_mn<D>(sK + s * C::KT, BK, kk, 0));
      wgmma_commit();
      fence_regs(dq);
      wgmma_wait_all();
      fence_regs(dq);
    }
    named_barrier(1 + wg, 128);     // as in attn_bwd_dkdv: the second one out refills
    if ((tid & 127) == 0) {
      __threadfence_block();
      if ((atomicAdd(done + s, 1u) & 1u) && it + ST < n_tiles) load_kv(it + ST);
    }
    __syncwarp();
  }

  // epilogue: dQ * scale in bf16 into the warpgroup's q tile (its last
  // reader, the last S wgmma, has completed), one TMA store per box; rows
  // past S are not written
  if (qw0 >= S) return;
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int a = 4 * i + 2 * half;
      st_pair<D>(sQw, 64, r0 + 8 * half, 8 * i + cq, dq[a] * scale, dq[a + 1] * scale);
    }
  fence_proxy_async();
  named_barrier(1 + wg, 128);
  if ((tid & 127) == 0) {
#pragma unroll
    for (int j = 0; j < NB; ++j) tma_store(&tm_dq, sQw + j * 64 * SW, j * EB, h, qw0, b);
    bulk_commit();
    bulk_wait_read<0>();
  }
}

// 4-D map over a contiguous bf16 [B, L, heads, D], box {EB, 1, rows, 1}
template <int D>
int encode(CUtensorMap* map, const void* ptr, int B, int L, int heads, int rows) {
  using C = Bwd<D>;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)L * heads * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)C::EB, 1, (cuuint32_t)rows, 1};
  return encode_bf16(map, ptr, 4, dims, strides, box, C::SW);
}

// 2-D map over fp32 [rows, Sp], box {64, 1}, no swizzle
int encode_rows(CUtensorMap* map, const float* ptr, long long rows, int Sp) {
  const cuuint64_t dims[2] = {(cuuint64_t)Sp, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)Sp * 4};
  const cuuint32_t box[2] = {64, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, ptr, 2, dims, strides, box, 0);
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk,
                void* dv, const float* lse2, const float* delta, int B, int S, int Sp, int T_len,
                int H, int KV, int causal, int window, float softcap, float scale, int q_offset,
                cudaStream_t stream) {
  using C = Bwd<D>;
  CUtensorMap tq, tdo, tk, tv, tdk, tdv, tl, tdl, tkb, tvb, tdq;
  int rc = encode<D>(&tq, q, B, S, H, 64);
  if (rc == 0) rc = encode<D>(&tdo, dout, B, S, H, 64);
  if (rc == 0) rc = encode<D>(&tdq, dq, B, S, H, 64);
  if (rc == 0) rc = encode<D>(&tk, k, B, T_len, KV, 64);
  if (rc == 0) rc = encode<D>(&tv, v, B, T_len, KV, 64);
  if (rc == 0) rc = encode<D>(&tdk, dk, B, T_len, KV, 64);
  if (rc == 0) rc = encode<D>(&tdv, dv, B, T_len, KV, 64);
  if (rc == 0) rc = encode<D>(&tkb, k, B, T_len, KV, C::BK);
  if (rc == 0) rc = encode<D>(&tvb, v, B, T_len, KV, C::BK);
  if (rc == 0) rc = encode_rows(&tl, lse2, (long long)B * H, Sp);
  if (rc == 0) rc = encode_rows(&tdl, delta, (long long)B * H, Sp);
  if (rc != 0) return rc;
  cudaError_t e = cudaFuncSetAttribute(attn_bwd_dkdv<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, C::KV_SMEM);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(attn_bwd_dq<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::Q_SMEM);
  if (e != cudaSuccess) return (int)e;
  attn_bwd_dkdv<D><<<dim3(KV, B, (T_len + C::BN - 1) / C::BN), 256, C::KV_SMEM, stream>>>(
      tq, tdo, tk, tv, tdk, tdv, tl, tdl, S, T_len, H, KV, scale, causal, window, softcap,
      q_offset);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  attn_bwd_dq<D><<<dim3(H, B, (S + 127) / 128), 256, C::Q_SMEM, stream>>>(
      tq, tdo, tkb, tvb, tdq, lse2, delta, S, Sp, T_len, H, KV, scale, causal, window, softcap,
      q_offset);
  return (int)cudaGetLastError();
}

// ------------------------------------------------- fp32: the CUDA cores

constexpr int FR = 64;            // rows a block owns (keys for dK/dV, queries for dQ)
constexpr int FC = 32;            // rows of the streamed tile
constexpr int FT = 4 * FR;        // four threads per owned row

// `rows` rows of D floats into shared memory (row stride ld); rows at or
// past `valid` are zero-filled. 16-byte loads: D * 4 and the row starts are
// multiples of 16 bytes (checked by the Python wrapper).
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src, long long stride,
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
constexpr int fp32_smem() {   // owned rows x 2, streamed rows x 2, two [FR][FC + 1] tiles
  return (2 * FR * (D + 1) + 2 * FC * (D + 1) + 2 * FR * (FC + 1) + 2 * FC) * 4;
}

// One block per (64 keys, KV head, batch row); thread (r = tid / 4, j4 =
// tid % 4) owns key row r and the columns j4 + 4 i of dK and dV, and
// scores the queries j4 + 4 i of each 32-query tile.
template <int D>
__global__ void __launch_bounds__(FT)
attn_bwd_dkdv_fp32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dout,
                   float* __restrict__ dk, float* __restrict__ dv, const float* __restrict__ lse2,
                   const float* __restrict__ delta, int S, int Sp, int T_len, int H, int KV,
                   float scale, int causal, int window, float softcap, int q_offset) {
  extern __shared__ float smem[];
  constexpr int LD = D + 1, LP = FC + 1, NS = FC / 4, NA = D / 4;
  float* Ks = smem;
  float* Vs = Ks + FR * LD;
  float* Qs = Vs + FR * LD;
  float* Os = Qs + FC * LD;
  float* Ps = Os + FC * LD;
  float* Dss = Ps + FR * LP;
  float* Lq = Dss + FR * LP;
  float* Dq = Lq + FC;

  const int n = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * FR;
  const int G = H / KV;
  const int tid = threadIdx.x, r = tid >> 2, j4 = tid & 3;
  const int kpos = k0 + r;
  const long long q_row = (long long)H * D, kv_row = (long long)KV * D;
  const long long kv_base = ((long long)b * T_len + k0) * kv_row + (long long)n * D;
  load_rows(Ks, LD, k + kv_base, kv_row, T_len - k0, FR, D);
  load_rows(Vs, LD, v + kv_base, kv_row, T_len - k0, FR, D);

  int qlo = 0, qhi = S;
  if (causal) qlo = max(0, k0 - q_offset);
  if (window > 0) qhi = min(S, k0 + FR - 1 + window - q_offset);

  float ak[NA], av[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) ak[i] = av[i] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = n * G + g;
    for (int q0 = (qlo / FC) * FC; q0 < qhi; q0 += FC) {
      __syncthreads();
      const long long q_base = ((long long)b * S + q0) * q_row + (long long)h * D;
      load_rows(Qs, LD, q + q_base, q_row, S - q0, FC, D);
      load_rows(Os, LD, dout + q_base, q_row, S - q0, FC, D);
      if (tid < FC) {   // rows past S read the padding: lse2 +inf, delta 0
        const long long l = ((long long)b * H + h) * Sp + q0 + tid;
        Lq[tid] = lse2[l];
        Dq[tid] = delta[l];
      }
      __syncthreads();

      float s[NS], dp[NS];
#pragma unroll
      for (int i = 0; i < NS; ++i) s[i] = dp[i] = 0.f;
      const float* kr = Ks + r * LD;
      const float* vr = Vs + r * LD;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float kd = kr[d], vd = vr[d];
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          s[i] += kd * Qs[(j4 + 4 * i) * LD + d];
          dp[i] += vd * Os[(j4 + 4 * i) * LD + d];
        }
      }
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int c = j4 + 4 * i;
        float x = s[i] * scale, f = 1.f;
        if (softcap > 0.f) {
          const float t = tanhf(x / softcap);
          x = t * softcap;
          f = 1.f - t * t;
        }
        float p = exp2f(fmaf(x, LOG2E, -Lq[c]));
        if (!visible(kpos, q_offset + q0 + c, causal, window)) p = 0.f;
        Ps[r * LP + c] = p;
        Dss[r * LP + c] = p * (dp[i] - Dq[c]) * f;
      }
      __syncwarp();   // a row's P and dS are read only by the four threads that wrote them
      const float* pr = Ps + r * LP;
      const float* dr = Dss + r * LP;
      for (int c = 0; c < FC; ++c) {
        const float p = pr[c], ds = dr[c];
        const float* orow = Os + c * LD + j4;
        const float* qrow = Qs + c * LD + j4;
#pragma unroll
        for (int i = 0; i < NA; ++i) {
          av[i] += p * orow[4 * i];
          ak[i] += ds * qrow[4 * i];
        }
      }
    }
  }
  if (kpos < T_len) {
    const long long o = ((long long)b * T_len + kpos) * kv_row + (long long)n * D;
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      dk[o + j4 + 4 * i] = ak[i] * scale;
      dv[o + j4 + 4 * i] = av[i];
    }
  }
}

// One block per (64 queries, head, batch row); thread (r, j4) owns query row
// r and the columns j4 + 4 i of dQ, and scores the keys j4 + 4 i of each
// 32-key tile.
template <int D>
__global__ void __launch_bounds__(FT)
attn_bwd_dq_fp32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 float* __restrict__ dq, const float* __restrict__ lse2,
                 const float* __restrict__ delta, int S, int Sp, int T_len, int H, int KV,
                 float scale, int causal, int window, float softcap, int q_offset) {
  extern __shared__ float smem[];
  constexpr int LD = D + 1, LP = FC + 1, NS = FC / 4, NA = D / 4;
  float* Qs = smem;
  float* Os = Qs + FR * LD;
  float* Ks = Os + FR * LD;
  float* Vs = Ks + FC * LD;
  float* Dss = Vs + FC * LD;

  const int h = blockIdx.x, b = blockIdx.y, q0 = blockIdx.z * FR;
  const int n = h / (H / KV);
  const int tid = threadIdx.x, r = tid >> 2, j4 = tid & 3;
  const int qpos = q_offset + q0 + r;
  const long long q_row = (long long)H * D, kv_row = (long long)KV * D;
  const long long q_base = ((long long)b * S + q0) * q_row + (long long)h * D;
  load_rows(Qs, LD, q + q_base, q_row, S - q0, FR, D);
  load_rows(Os, LD, dout + q_base, q_row, S - q0, FR, D);
  const long long l = ((long long)b * H + h) * Sp + q0 + r;   // < Sp: padding past S
  const float l2 = lse2[l], dl = delta[l];
  const float* kb = k + (long long)b * T_len * kv_row + (long long)n * D;
  const float* vb = v + (long long)b * T_len * kv_row + (long long)n * D;

  int lo = 0, hi = T_len;
  if (causal) hi = min(hi, q_offset + min(q0 + FR, S));
  if (window > 0) lo = max(lo, q_offset + q0 - window + 1);

  float acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.f;

  for (int k0 = (lo / FC) * FC; k0 < hi; k0 += FC) {
    const int kval = min(FC, T_len - k0);
    __syncthreads();
    load_rows(Ks, LD, kb + k0 * kv_row, kv_row, kval, FC, D);
    load_rows(Vs, LD, vb + k0 * kv_row, kv_row, kval, FC, D);
    __syncthreads();

    float s[NS], dp[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = dp[i] = 0.f;
    const float* qr = Qs + r * LD;
    const float* orow = Os + r * LD;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qd = qr[d], od = orow[d];
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        s[i] += qd * Ks[(j4 + 4 * i) * LD + d];
        dp[i] += od * Vs[(j4 + 4 * i) * LD + d];
      }
    }
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int kpos = k0 + j4 + 4 * i;
      float x = s[i] * scale, f = 1.f;
      if (softcap > 0.f) {
        const float t = tanhf(x / softcap);
        x = t * softcap;
        f = 1.f - t * t;
      }
      float p = exp2f(fmaf(x, LOG2E, -l2));
      if (kpos >= T_len || !visible(kpos, qpos, causal, window)) p = 0.f;
      Dss[r * LP + j4 + 4 * i] = p * (dp[i] - dl) * f;
    }
    __syncwarp();
    const float* dr = Dss + r * LP;
    for (int c = 0; c < kval; ++c) {
      const float ds = dr[c];
      const float* kr = Ks + c * LD + j4;
#pragma unroll
      for (int i = 0; i < NA; ++i) acc[i] += ds * kr[4 * i];
    }
  }
  if (q0 + r < S) {
    float* o = dq + ((long long)b * S + q0 + r) * q_row + (long long)h * D;
#pragma unroll
    for (int i = 0; i < NA; ++i) o[j4 + 4 * i] = acc[i] * scale;
  }
}

template <int D>
int launch_fp32(const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk,
                void* dv, const float* lse2, const float* delta, int B, int S, int Sp, int T_len,
                int H, int KV, int causal, int window, float softcap, float scale, int q_offset,
                cudaStream_t stream) {
  const int bytes = fp32_smem<D>();
  cudaError_t e = cudaFuncSetAttribute(attn_bwd_dkdv_fp32<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(attn_bwd_dq_fp32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (e != cudaSuccess) return (int)e;
  const float *fq = static_cast<const float*>(q), *fk = static_cast<const float*>(k),
              *fv = static_cast<const float*>(v), *fo = static_cast<const float*>(dout);
  attn_bwd_dkdv_fp32<D><<<dim3(KV, B, (T_len + FR - 1) / FR), FT, bytes, stream>>>(
      fq, fk, fv, fo, static_cast<float*>(dk), static_cast<float*>(dv), lse2, delta, S, Sp,
      T_len, H, KV, scale, causal, window, softcap, q_offset);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  attn_bwd_dq_fp32<D><<<dim3(H, B, (S + FR - 1) / FR), FT, bytes, stream>>>(
      fq, fk, fv, fo, static_cast<float*>(dq), lse2, delta, S, Sp, T_len, H, KV, scale, causal,
      window, softcap, q_offset);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_prep(const void* out, const void* dout, const float* lse, float* lse2, float* delta,
                int B, int S, int Sp, int H, int D, cudaStream_t stream) {
  const long long n = (long long)B * Sp * H * (D / 8);
  const long long blocks = (n + 255) / 256;
  bwd_prep<T><<<(int)(blocks < 4096 ? blocks : 4096), 256, 0, stream>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout), lse, lse2, delta, S, Sp, H, D, n);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (wgmma + TMA); q, k, v, out,
// dout, dq, dk and dv all of it. lse: fp32 [B, S, H] (the forward's). lse2,
// delta: fp32 scratch [B, H, Sp], Sp = S rounded up to ROW_PAD. Returns 0,
// a cudaError_t, or ENCODE_ERROR + a CUresult; the Python wrapper raises on
// non-zero.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* out,
                                   const void* lse, const void* dout, void* dq, void* dk, void* dv,
                                   void* lse2, void* delta, int B, int S, int T_len, int H, int KV,
                                   int D, int dtype, int causal, int window, float softcap,
                                   float scale, int q_offset, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t es = dtype == 1 ? 2 : 4;
  if (S == 0 || T_len == 0) {   // no pair: every gradient is 0
    cudaError_t e = cudaMemsetAsync(dq, 0, (size_t)B * S * H * D * es, st);
    if (e == cudaSuccess) e = cudaMemsetAsync(dk, 0, (size_t)B * T_len * KV * D * es, st);
    if (e == cudaSuccess) e = cudaMemsetAsync(dv, 0, (size_t)B * T_len * KV * D * es, st);
    return (int)e;
  }
  const int Sp = (S + ROW_PAD - 1) / ROW_PAD * ROW_PAD;
  float* l2 = static_cast<float*>(lse2);
  float* dl = static_cast<float*>(delta);
  const float* ls = static_cast<const float*>(lse);
  int rc = dtype == 1 ? launch_prep<__nv_bfloat16>(out, dout, ls, l2, dl, B, S, Sp, H, D, st)
                      : launch_prep<float>(out, dout, ls, l2, dl, B, S, Sp, H, D, st);
  if (rc != 0) return rc;
#define BWD_ARGS q, k, v, dout, dq, dk, dv, l2, dl, B, S, Sp, T_len, H, KV, causal, window, softcap, scale, q_offset, st
  if (dtype == 0) switch (D) {
      case 16: return launch_fp32<16>(BWD_ARGS);
      case 32: return launch_fp32<32>(BWD_ARGS);
      case 64: return launch_fp32<64>(BWD_ARGS);
      case 128: return launch_fp32<128>(BWD_ARGS);
      case 256: return launch_fp32<256>(BWD_ARGS);
    }
  if (dtype == 1) switch (D) {
      case 16: return launch_bf16<16>(BWD_ARGS);
      case 32: return launch_bf16<32>(BWD_ARGS);
      case 64: return launch_bf16<64>(BWD_ARGS);
      case 128: return launch_bf16<128>(BWD_ARGS);
      case 256: return launch_bf16<256>(BWD_ARGS);
    }
#undef BWD_ARGS
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_bwd_error_string(int err) {
  return hopper_error_string(err);
}
