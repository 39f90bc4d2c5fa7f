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
// counted as one): ~11 FLOP per byte, below the fp32 ridge of 67 TFLOP/s
// over 3.35 TB/s = 20 FLOP per byte. The least time is those three streams
// over 3.35 TB/s; what limits a simple kernel is the S dependent steps.
//
// Design: one thread per (channel, state), so the N states of a channel are
// N neighbouring lanes and y is their sum by a shuffle tree (log2 N
// shuffles). With jamba's DI = 8192 and N = 16 a block of 256 threads takes
// 16 channels: 512 blocks per row, enough warps in flight on 132 SMs to hide
// each step's latency even at B = 1, which the engine's exact-length buckets
// give. One thread per channel with N states in registers would leave 64
// blocks at B = 1. Time is walked in tiles of TC steps: the tile's x and dt
// (16 channels wide), B and C are staged in shared memory with coalesced
// loads, TC steps run from shared memory with no barrier, and the tile's y
// is written back coalesced. The loop stops at S: padded steps do not
// exist. This is the exact per-step recurrence in fp32, not the chunked
// exp(+-cumsum) form, whose exp(-cs) grows to exp(80) within a chunk.
#include <cuda_runtime.h>

namespace {

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

}  // namespace

// x, dt: [Bt, S, DI]; A: [DI, N]; B, C: [Bt, S, N]; D: [DI]; h0: [Bt, DI, N]
// or null for a zero state; y: [Bt, S, DI]; h_out: [Bt, DI, N]; all fp32.
// N is a power of two in [2, 32]. Returns the cudaError_t of the launch; the
// Python wrapper raises on non-zero.
extern "C" int mamba_scan_fwd(const float* x, const float* dt, const float* A, const float* B,
                              const float* C, const float* D, const float* h0, float* y,
                              float* h_out, int Bt, int S, int DI, int N, void* stream) {
  if (N < 2 || N > MAX_N || (N & (N - 1))) return (int)cudaErrorInvalidValue;
  const int ch = NT / N;
  mamba_scan_kernel<<<dim3((DI + ch - 1) / ch, Bt), NT, 0, static_cast<cudaStream_t>(stream)>>>(
      x, dt, A, B, C, D, h0, y, h_out, S, DI, N);
  return (int)cudaGetLastError();
}

extern "C" const char* mamba_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
