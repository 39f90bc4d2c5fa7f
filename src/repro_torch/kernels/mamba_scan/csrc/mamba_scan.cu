// Mamba-1 selective scan for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces: src/repro/kernels/mamba_scan/kernel.py:56 `mamba_scan_pallas`
// (Pallas body `_mamba_kernel`, :23): per (row, channel, state) the
// recurrence h <- exp(lda) h + dt B x with lda = clip(dt A, -5, -1e-8) where
// dt > 0 and 0 where it is not, y = sum_n h C + D x, a [channels, N] fp32
// state resident on chip across the sequence, the final state written once.
//
// Bound on the H100: bytes. x, dt and y are [Bt, S, DI] fp32, 12 bytes per
// (row, step, channel), against ~8 N = 128 FLOP there (N = 16, the exp
// counted as one): below the fp32 ridge of 67 TFLOP/s over 3.35 TB/s = 20
// FLOP per byte. Next comes the SFU: one exp per (row, step, channel,
// state), ~79M at jamba's B 1, S 601, DI 8192, N 16, at 16 a clock per SM.
// Mamba-1's decay is per (channel, state), so the recurrence has no
// [C, C] product (repro/kernels/mamba_scan/ops.py:6-8) and the tensor cores
// have no part here. What held the per-step kernel (below) at 0.28 ms
// (B 1) and 0.52 ms (B 2) was the work on the path of every step: measured
// on an H100 80GB HBM3 (700 W), its loads alone took 0.020-0.037 ms and its
// steps alone 0.26-0.48 ms. Each of a channel's 16 lanes held one state
// and ran the whole 4-shuffle tree for y, with dt x, the clamp and the
// guard repeated on every lane: 16x the work, each step waiting on the
// last.
//
// Two kernels, chosen by shape alone (`tma_tiles`):
//
// N in {4, 8, 16, 32}, DI a multiple of 4 and S >= 1 (`mamba_tile_kernel`,
// the served case): each channel's N states sit in the registers of L
// lanes (L in {1, 2, 4}: N / L states each; the host chooses L and the
// channels a block takes, kernel.py:plan). Per step and channel, dt x, the
// guard and x D are computed once per lane, exp is ex2 on dt (A log2 e)
// with A log2 e formed once per block, y is a register sum plus log2 L
// shuffles, and only the update of h is carried from step to step. The
// 16 steps of a tile run MB = 4 at a time: their exps, inputs and C first,
// then the chain of h updates, then their sums' shuffles together, and
// every lane of a channel stores y, so no branch keeps neighbouring steps
// from overlapping (with one step at a time and the store behind a branch
// the kernel took 0.074 ms at Bt 1, against 0.055). x and dt tiles [16
// steps, channels] and B and C tiles
// [16 steps, N] arrive by TMA from 3-D fp32 maps over [Bt, S, DI] and
// [Bt, S, N] into a 3-stage mbarrier ring that one thread keeps three
// tiles ahead, so the recurrence never waits on device memory inside the
// sequence; steps past S are zero-filled (dt = 0: no decay, no input) and
// y leaves through shared memory by a TMA store that the map clips at S
// and DI. Measured on an H100 80GB HBM3 (700 W) at S 601: 0.078 ms at Bt 2
// (2 lanes), 0.055 at Bt 1 (4 lanes); leaving out the exps moves it by
// 2-4% and the x and dt loads by 8-10%, and Bt 4 takes 1.8x Bt 2: each
// lane's instructions a step bound it, not the SFU or device memory.
//
// N = 2, DI not a multiple of 4 (the maps need 16-byte strides), or S = 0
// (`mamba_scan_kernel`): one thread per (channel, state), N
// neighbouring lanes per channel, y by a shuffle tree; 16-step tiles staged
// in shared memory by the threads; the loop stops at S.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"   // TMA, mbarrier helpers (kernels/csrc)

namespace {

// ------------------------------------------------------- per-step kernel

constexpr int NT = 256;       // threads per block: (channel, state) pairs
constexpr int TC = 16;        // time steps staged in shared memory at once
constexpr int MAX_N = 32;     // states per channel: lanes of one warp
constexpr int MAX_CH = NT / 2;
constexpr float LOG_DECAY_CLAMP = 5.0f;

// grid (ceil(DI / (NT / N)), Bt); block NT threads
__global__ void __launch_bounds__(NT)
mamba_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ A, const float* __restrict__ Bm,
                  const float* __restrict__ Cm, const float* __restrict__ Dp,
                  const float* __restrict__ h0, float* __restrict__ y, float* __restrict__ h_out,
                  int S, int DI, int N) {
  __shared__ float xs[TC][MAX_CH], dts[TC][MAX_CH], ys[TC][MAX_CH];
  __shared__ float bs[TC][MAX_N], cs[TC][MAX_N];
  const int CH = NT / N;                       // channels per block
  const int b = blockIdx.y, d0 = blockIdx.x * CH;
  const int tid = threadIdx.x, c = tid / N, n = tid - c * N, d = d0 + c;
  const bool valid = d < DI;
  const long long hidx = ((long long)b * DI + d) * N + n;
  const float a = valid ? A[(long long)d * N + n] : 0.f;
  const float dd = valid ? Dp[d] : 0.f;
  float h = (valid && h0) ? h0[hidx] : 0.f;

  const long long xb = (long long)b * S * DI, bb = (long long)b * S * N;
  for (int t0 = 0; t0 < S; t0 += TC) {
    const int tc = min(TC, S - t0);
    __syncthreads();                    // the previous tile's readers are done
    for (int e = tid; e < tc * CH; e += NT) {
      const int t = e / CH, cc = e - t * CH;
      const bool in = d0 + cc < DI;
      const long long g = xb + (long long)(t0 + t) * DI + d0 + cc;
      xs[t][cc] = in ? x[g] : 0.f;
      dts[t][cc] = in ? dt[g] : 0.f;
    }
    for (int e = tid; e < tc * N; e += NT) {
      const int t = e / N, nn = e - t * N;
      bs[t][nn] = Bm[bb + (long long)(t0 + t) * N + nn];
      cs[t][nn] = Cm[bb + (long long)(t0 + t) * N + nn];
    }
    __syncthreads();
    for (int t = 0; t < tc; ++t) {
      const float xv = xs[t][c], dtv = dts[t][c];
      const float lda = dtv > 0.f ? fminf(fmaxf(dtv * a, -LOG_DECAY_CLAMP), -1e-8f) : 0.f;
      h = fmaf(expf(lda), h, dtv * bs[t][n] * xv);
      float p = h * cs[t][n];
      for (int off = N >> 1; off > 0; off >>= 1) p += __shfl_xor_sync(0xffffffffu, p, off);
      if (n == 0) ys[t][c] = fmaf(dd, xv, p);
    }
    __syncthreads();
    for (int e = tid; e < tc * CH; e += NT) {
      const int t = e / CH, cc = e - t * CH;
      if (d0 + cc < DI) y[xb + (long long)(t0 + t) * DI + d0 + cc] = ys[t][cc];
    }
  }
  if (valid) h_out[hidx] = h;
}


// ------------------------------------------ TMA-fed kernel, states in registers

constexpr int MT = 16;        // steps per tile
constexpr int MST = 3;        // ring stages
constexpr int MNT = 128;      // threads per block
constexpr int MB = 4;         // steps whose exps and sums are issued together

template <int N, int L>
struct Mc {
  static constexpr int NS = N / L;                  // states per lane
  static constexpr int CH = MNT / L;                // channels per block
  static constexpr int XT = MT * CH * 4;            // x or dt tile
  static constexpr int BT = MT * N * 4;             // B or C tile
  static constexpr int STAGE = 2 * XT + 2 * BT;     // x, dt, B, C (each 128-byte aligned)
  static constexpr int W_Y = MST * STAGE;           // two y tiles [MT][CH]
  static constexpr int W_BAR = W_Y + 2 * XT;
  static constexpr int SMEM = W_BAR + 8 * MST + 128;   // + alignment slack
  static_assert(XT % 128 == 0 && BT % 128 == 0, "TMA destinations stay 128-byte aligned");
};

// grid (ceil(DI / CH), Bt); block MNT threads: channel c = tid / L of the
// block, states [sub NS, sub NS + NS), sub = tid % L
template <int N, int L>
__global__ void __launch_bounds__(MNT)
mamba_tile_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_dt,
                  const __grid_constant__ CUtensorMap tm_b, const __grid_constant__ CUtensorMap tm_c,
                  const __grid_constant__ CUtensorMap tm_y, const float* __restrict__ A,
                  const float* __restrict__ Dp, const float* __restrict__ h0,
                  float* __restrict__ h_out, int S, int DI) {
  using C = Mc<N, L>;
  constexpr int NS = C::NS, CH = C::CH;
  const int b = blockIdx.y, d0 = blockIdx.x * CH;
  const int tid = threadIdx.x, c = tid / L, sub = tid % L, d = d0 + c;
  const bool valid = d < DI;
  const int ntiles = (S + MT - 1) / MT;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((128u - (smem_u32(smem_raw) & 127u)) & 127u);
  const uint32_t sbase = smem_u32(base), bars = sbase + C::W_BAR;

  auto load = [&](int it) {         // tile it into stage it % MST (one thread)
    const int s = it % MST, t0 = it * MT;
    const uint32_t bar = bars + 8u * s, st = sbase + s * C::STAGE;
    mbar_expect_tx(bar, C::STAGE);
    tma_load(st, &tm_x, bar, d0, t0, b);
    tma_load(st + C::XT, &tm_dt, bar, d0, t0, b);
    tma_load(st + 2 * C::XT, &tm_b, bar, 0, t0, b);
    tma_load(st + 2 * C::XT + C::BT, &tm_c, bar, 0, t0, b);
  };
  if (tid == 0) {
    for (int s = 0; s < MST; ++s) mbar_init(bars + 8u * s, 1);
    mbar_fence_init();
    for (int it = 0; it < min(MST, ntiles); ++it) load(it);
  }

  const long long hb = ((long long)b * DI + d) * N + sub * NS;
  float h[NS], a2[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    a2[j] = valid ? A[(long long)d * N + sub * NS + j] * LOG2E : 0.f;
    h[j] = valid && h0 ? h0[hb + j] : 0.f;
  }
  const float dd = valid ? Dp[d] : 0.f;
  constexpr float LO = -LOG_DECAY_CLAMP * LOG2E, HI = -1e-8f * LOG2E;   // the clamp, in log2 units
  __syncthreads();                  // barriers initialised

  for (int it = 0; it < ntiles; ++it) {
    const int s = it % MST;
    const float* xs = reinterpret_cast<const float*>(base + s * C::STAGE);
    const float* dts = xs + MT * CH;
    const float* bs = dts + MT * CH;
    const float* cs = bs + MT * N;
    float* ys = reinterpret_cast<float*>(base + C::W_Y) + (it & 1) * MT * CH;
    mbar_wait(bars + 8u * s, (it / MST) & 1);
    // MB steps at a time: their exps, inputs and C first (independent),
    // then the chain of h updates, then the MB sums' shuffles together;
    // every lane of a channel stores the same y (no branch)
#pragma unroll
    for (int t0 = 0; t0 < MT; t0 += MB) {
      float e[MB][NS], in[MB][NS], cv[MB][NS], xv[MB], p[MB];
#pragma unroll
      for (int u = 0; u < MB; ++u) {
        const int t = t0 + u;
        xv[u] = xs[t * CH + c];
        const float dtv = dts[t * CH + c], dtx = dtv * xv[u];
        const bool pos = dtv > 0.f;
        float bt[NS];
        if constexpr (NS % 4 == 0) {
#pragma unroll
          for (int j = 0; j < NS; j += 4) {
            const float4 b4 = *reinterpret_cast<const float4*>(bs + t * N + sub * NS + j);
            const float4 c4 = *reinterpret_cast<const float4*>(cs + t * N + sub * NS + j);
            bt[j] = b4.x; bt[j + 1] = b4.y; bt[j + 2] = b4.z; bt[j + 3] = b4.w;
            cv[u][j] = c4.x; cv[u][j + 1] = c4.y; cv[u][j + 2] = c4.z; cv[u][j + 3] = c4.w;
          }
        } else {
#pragma unroll
          for (int j = 0; j < NS; ++j) {
            bt[j] = bs[t * N + sub * NS + j];
            cv[u][j] = cs[t * N + sub * NS + j];
          }
        }
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          e[u][j] = ex2(pos ? fminf(fmaxf(dtv * a2[j], LO), HI) : 0.f);
          in[u][j] = dtx * bt[j];
        }
      }
#pragma unroll
      for (int u = 0; u < MB; ++u) {
        p[u] = 0.f;
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          h[j] = fmaf(e[u][j], h[j], in[u][j]);
          p[u] = fmaf(h[j], cv[u][j], p[u]);
        }
      }
#pragma unroll
      for (int o = 1; o < L; o <<= 1)
#pragma unroll
        for (int u = 0; u < MB; ++u) p[u] += __shfl_xor_sync(0xffffffffu, p[u], o);
#pragma unroll
      for (int u = 0; u < MB; ++u) ys[(t0 + u) * CH + c] = fmaf(dd, xv[u], p[u]);
    }
    fence_proxy_async();
    if (tid == 0) bulk_wait_read<0>();   // the previous tile's store has read its y
    __syncthreads();                // stage s is free, this y tile complete
    if (tid == 0) {
      tma_store(&tm_y, smem_u32(ys), d0, it * MT, b);
      bulk_commit();
      if (it + MST < ntiles) load(it + MST);
    }
  }
  if (tid == 0) bulk_wait_read<0>();   // shared memory read before exit
  if (valid) {
#pragma unroll
    for (int j = 0; j < NS; ++j) h_out[hb + j] = h[j];
  }
}

// 3-D fp32 map over [Bt, S, W] (innermost first), box {box0, MT, 1}
int encode_seq(CUtensorMap* map, const void* ptr, int Bt, int S, int W, int box0) {
  const cuuint64_t dims[3] = {(cuuint64_t)W, (cuuint64_t)S, (cuuint64_t)Bt};
  const cuuint64_t strides[2] = {(cuuint64_t)W * 4, (cuuint64_t)S * W * 4};
  const cuuint32_t box[3] = {(cuuint32_t)box0, (cuuint32_t)MT, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, ptr, 3, dims, strides, box, 0);
}

template <int N, int L>
int launch_tiles(const float* x, const float* dt, const float* A, const float* B, const float* Cm,
                 const float* D, const float* h0, float* y, float* h_out, int Bt, int S, int DI,
                 cudaStream_t st) {
  using C = Mc<N, L>;
  CUtensorMap tx, tdt, tb, tc, ty;
  int rc = encode_seq(&tx, x, Bt, S, DI, C::CH);
  if (rc == 0) rc = encode_seq(&tdt, dt, Bt, S, DI, C::CH);
  if (rc == 0) rc = encode_seq(&tb, B, Bt, S, N, N);
  if (rc == 0) rc = encode_seq(&tc, Cm, Bt, S, N, N);
  if (rc == 0) rc = encode_seq(&ty, y, Bt, S, DI, C::CH);
  if (rc != 0) return rc;
  cudaError_t e = cudaFuncSetAttribute(mamba_tile_kernel<N, L>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  mamba_tile_kernel<N, L><<<dim3((DI + C::CH - 1) / C::CH, Bt), MNT, C::SMEM, st>>>(
      tx, tdt, tb, tc, ty, A, D, h0, h_out, S, DI);
  return (int)cudaGetLastError();
}

// The kernel, by shape alone: N in {4, 8, 16, 32}, DI a multiple of 4 and
// S >= 1 take the TMA-fed kernel, everything else the per-step kernel.
bool tma_tiles(int S, int DI, int N) {
  return S >= 1 && DI % 4 == 0 && (N == 4 || N == 8 || N == 16 || N == 32);
}

int per_step(const float* x, const float* dt, const float* A, const float* B, const float* C,
             const float* D, const float* h0, float* y, float* h_out, int Bt, int S, int DI, int N,
             cudaStream_t st) {
  const int ch = NT / N;
  mamba_scan_kernel<<<dim3((DI + ch - 1) / ch, Bt), NT, 0, st>>>(x, dt, A, B, C, D, h0, y, h_out,
                                                                S, DI, N);
  return (int)cudaGetLastError();
}

}  // namespace

// x, dt: [Bt, S, DI]; A: [DI, N]; B, C: [Bt, S, N]; D: [DI]; h0: [Bt, DI, N]
// or null for a zero state; y: [Bt, S, DI]; h_out: [Bt, DI, N]; all fp32,
// 16-byte aligned. N is a power of two in [2, 32]; `lanes` (1, 2 or 4) the
// lanes per channel of the TMA-fed kernel, which `tma_tiles` chooses (the
// per-step kernel ignores it). One launch. Returns 0, a cudaError_t or
// ENCODE_ERROR + a CUresult; the Python wrapper raises on non-zero.
extern "C" int mamba_scan_fwd(const float* x, const float* dt, const float* A, const float* B,
                              const float* C, const float* D, const float* h0, float* y,
                              float* h_out, int Bt, int S, int DI, int N, int lanes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N < 2 || N > MAX_N || (N & (N - 1))) return (int)cudaErrorInvalidValue;
  if (tma_tiles(S, DI, N)) {
#define MS_ARGS x, dt, A, B, C, D, h0, y, h_out, Bt, S, DI, st
    switch (N * 8 + lanes) {
      case 4 * 8 + 1: return launch_tiles<4, 1>(MS_ARGS);
      case 4 * 8 + 2: return launch_tiles<4, 2>(MS_ARGS);
      case 4 * 8 + 4: return launch_tiles<4, 4>(MS_ARGS);
      case 8 * 8 + 1: return launch_tiles<8, 1>(MS_ARGS);
      case 8 * 8 + 2: return launch_tiles<8, 2>(MS_ARGS);
      case 8 * 8 + 4: return launch_tiles<8, 4>(MS_ARGS);
      case 16 * 8 + 1: return launch_tiles<16, 1>(MS_ARGS);
      case 16 * 8 + 2: return launch_tiles<16, 2>(MS_ARGS);
      case 16 * 8 + 4: return launch_tiles<16, 4>(MS_ARGS);
      case 32 * 8 + 1: return launch_tiles<32, 1>(MS_ARGS);
      case 32 * 8 + 2: return launch_tiles<32, 2>(MS_ARGS);
      case 32 * 8 + 4: return launch_tiles<32, 4>(MS_ARGS);
      default: return (int)cudaErrorInvalidValue;
    }
#undef MS_ARGS
  }
  return per_step(x, dt, A, B, C, D, h0, y, h_out, Bt, S, DI, N, st);
}

// The per-step kernel at any shape it takes, whatever `tma_tiles`
// says (`lanes` is not read): chip_smoke.py times it beside the TMA-fed
// kernel. The wrapper never calls it.
extern "C" int mamba_scan_per_step_fwd(const float* x, const float* dt, const float* A,
                                       const float* B, const float* C, const float* D,
                                       const float* h0, float* y, float* h_out, int Bt, int S,
                                       int DI, int N, int lanes, void* stream) {
  if (N < 2 || N > MAX_N || (N & (N - 1))) return (int)cudaErrorInvalidValue;
  return per_step(x, dt, A, B, C, D, h0, y, h_out, Bt, S, DI, N,
                  static_cast<cudaStream_t>(stream));
}

// The kernel mamba_scan_fwd would launch: 1 the TMA-fed kernel, 0 the
// per-step kernel.
extern "C" int mamba_scan_variant(int S, int DI, int N) { return tma_tiles(S, DI, N); }

extern "C" const char* mamba_scan_error_string(int err) { return hopper_error_string(err); }
