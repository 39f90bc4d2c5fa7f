// RWKV6 (Finch) wkv scan for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces: src/repro/kernels/rwkv6_scan/kernel.py:64 `rwkv6_scan_pallas`
// (Pallas body `_rwkv_kernel`, :23): per (row, head), a [D, D] fp32 state
// resident on chip across the whole sequence, log-decay clamped to
// [-5, -1e-6], bonus u on the diagonal, the final state written once.
//
// Bound on the H100: neither bytes nor operations at the serving shapes,
// but the sequential dependency along time. Each step does ~7 FLOP per
// state element (D * D per head) against 4 D inputs, so the work is small
// (~2 GFLOP for 2 x 601 tokens x 64 heads of 64) and bytes are read once;
// what limits it is the chain of S dependent steps per head.
//
// Design: one block per (head, row, slice of v columns). The state's v
// columns are independent, so a small batch (the engine's exact-length
// buckets give B = 1: 64 heads for 132 SMs) is split along v into up to
// D/8 blocks. Inside a block, four neighbouring lanes share one v column
// and hold D/4 rows of it each in registers (rows interleaved, k = 4i + q,
// so the four lanes read four neighbouring shared-memory words); the output
// of a step is reduced over those four lanes with two shuffles. Time is
// walked in tiles of TC steps: r, k, v and the decay of a tile are staged
// in shared memory with coalesced loads (the decay's log-clamp is applied
// there, once per element), then TC steps run from shared memory with no
// barrier, and the tile's output is written back coalesced. The loop stops
// at S: no padded step exists, so none can decay or add to the state. This
// is the exact per-step recurrence of rwkv6_scan/ref.py (fp32), not the
// chunked cumulative-decay form, so no exp(+cumsum) range is needed.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TC = 16;       // time steps staged in shared memory at once
constexpr int KSPLIT = 4;    // lanes sharing one v column
constexpr float LOG_DECAY_CLAMP = 5.0f;

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

}  // namespace

// r, k, v: [B, S, H, D] in `dtype` (0 = float32, 1 = bfloat16); w: [B, S, H,
// D] fp32; u: [H, D] fp32; s0: [B, H, D, D] fp32 (k-major) or null for a zero
// state; out: [B, S, H, D] in `dtype`; s_out: [B, H, D, D] fp32. `vsplit`
// blocks share one (row, head), each D / vsplit >= 8 v columns. Returns the
// cudaError_t of the launch; the Python wrapper raises on non-zero.
extern "C" int rwkv6_scan_fwd(const void* r, const void* k, const void* v, const float* w,
                              const float* u, const float* s0, void* out, float* s_out, int B,
                              int S, int H, int D, int dtype, int vsplit, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vsplit < 1 || D % vsplit || D / vsplit < 8) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return (int)dispatch<float>(r, k, v, w, u, s0, out, s_out, B, S, H, D, vsplit, st);
    case 1: return (int)dispatch<__nv_bfloat16>(r, k, v, w, u, s0, out, s_out, B, S, H, D, vsplit, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* rwkv6_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
