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
// cache over 3.35 TB/s.
//
// Design: each block reads its own row's length from device memory (this
// replaces the TPU's scalar prefetch) and stops at it instead of streaming
// the padded L. The cache is split along L into chunks of `split` positions,
// one block per (chunk, kv head, row), so a small batch still spreads over
// the 132 SMs; a second, tiny kernel combines the partial (acc, m, l) with
// the max-rescaled sum of flash_attention/ops.py:384-388. Inside a block,
// 32-position K/V tiles are loaded with 16-byte loads into fp32 shared
// memory; a G that is not a power of two (qwen2-7b: 28/4 = 7) is looped
// over, never padded. The cache is read in its own dtype (bf16 even when q
// is fp32), so no step ever copies or casts the whole cache.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// Partial softmax over cache positions [sp*split, (sp+1)*split) of one
// (row, kv head), clipped to the row's valid range.
template <typename TQ, typename TC>
__global__ void __launch_bounds__(DNT)
decode_partial_kernel(const TQ* __restrict__ q, const TC* __restrict__ kc,
                      const TC* __restrict__ vc, const int* __restrict__ lengths,
                      float* __restrict__ acc_out, float* __restrict__ m_out,
                      float* __restrict__ l_out, int L, int H, int KV, int D, int split,
                      float scale, int window, float softcap) {
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

  const int sp = blockIdx.x, n = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = min(lengths[b], L);
  const int lo = window > 0 ? max(0, len - window) : 0;
  const int start = max(sp * split, lo), end = min((sp + 1) * split, len);

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

// out[b, 0, n*G + g, :] = sum_s acc_s e^(m_s - M) / (sum_s l_s e^(m_s - M) + 1e-30)
template <typename TQ>
__global__ void __launch_bounds__(DNT)
decode_combine_kernel(const float* __restrict__ acc, const float* __restrict__ m,
                      const float* __restrict__ l, TQ* __restrict__ out, int H, int KV, int D,
                      int nsplit) {
  const int n = blockIdx.x, b = blockIdx.y, G = H / KV;
  const long long base = ((long long)b * KV + n) * nsplit;
  for (int e = threadIdx.x; e < G * D; e += blockDim.x) {
    const int g = e / D, d = e - g * D;
    float M = NEG_INF;
    for (int s = 0; s < nsplit; ++s) M = fmaxf(M, m[(base + s) * G + g]);
    float num = 0.f, den = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const long long i = (base + s) * G + g;
      const float w = expf(m[i] - M);
      num += acc[i * D + d] * w;
      den += l[i] * w;
    }
    out[((long long)b * H + (long long)n * G + g) * D + d] = from_f<TQ>(num / (den + 1e-30f));
  }
}

template <typename TQ, typename TC>
cudaError_t launch(const void* q, const void* kc, const void* vc, const int* lengths,
                   float* acc, float* m, float* l, void* out, int B, int L, int H, int KV, int D,
                   int split, int window, float softcap, float scale, cudaStream_t st) {
  const int G = H / KV;
  const int nsplit = (L + split - 1) / split;
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
      acc, m, l, L, H, KV, D, split, scale, window, softcap);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  decode_combine_kernel<TQ><<<dim3(KV, B), DNT, 0, st>>>(acc, m, l, static_cast<TQ*>(out), H, KV,
                                                          D, nsplit);
  return cudaGetLastError();
}

}  // namespace

// q_dtype / cache_dtype: 0 = float32, 1 = bfloat16. acc/m/l are fp32
// scratch of [B, KV, ceil(L/split), G(, D)] elements. Returns the
// cudaError_t of the launches; the Python wrapper raises on non-zero.
extern "C" int flash_decode_fwd(const void* q, const void* k_cache, const void* v_cache,
                                const int* lengths, float* acc, float* m, float* l, void* out,
                                int B, int L, int H, int KV, int D, int q_dtype, int cache_dtype,
                                int split, int window, float softcap, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int code = q_dtype * 2 + cache_dtype;
  switch (code) {
    case 0: return (int)launch<float, float>(q, k_cache, v_cache, lengths, acc, m, l, out, B, L, H, KV, D, split, window, softcap, scale, st);
    case 1: return (int)launch<float, __nv_bfloat16>(q, k_cache, v_cache, lengths, acc, m, l, out, B, L, H, KV, D, split, window, softcap, scale, st);
    case 2: return (int)launch<__nv_bfloat16, float>(q, k_cache, v_cache, lengths, acc, m, l, out, B, L, H, KV, D, split, window, softcap, scale, st);
    case 3: return (int)launch<__nv_bfloat16, __nv_bfloat16>(q, k_cache, v_cache, lengths, acc, m, l, out, B, L, H, KV, D, split, window, softcap, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
