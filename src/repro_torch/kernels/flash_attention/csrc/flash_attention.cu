// Prefill flash attention for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py:73 `flash_attention`
// (Pallas body `_attn_kernel`, :25): blocked online-softmax GQA attention,
// causal with q_offset, sliding window `kpos > qpos - window`, tanh
// softcap, ragged kv `kpos < T`, p multiplied by the mask explicitly so a
// fully masked tile adds exactly zero, out = acc / (l + 1e-30).
//
// Bound on the H100: operations for long prompts, bytes for short ones.
// A causal prefill does ~2*S*D FLOP per K/V element and reads q and writes
// o once; at qwen2-7b's heads (H 28, KV 4, D 128) the operations bound
// (989 TFLOP/s bf16) passes the bytes bound (3.35 TB/s) near S = 700; at
// B 4, S 512 they are 7.6 us and 10.0 us.
//
// Design: one block per (q tile of 64 rows, head, batch row); a loop over
// 32-row K/V tiles replaces the TPU's sequential 4th grid axis. Q, K, V and
// P tiles are staged in fp32 dynamic shared memory (74 KB at D 128, 140 KB
// at D 256; above the 48 KB static limit, so cudaFuncSetAttribute raises
// the cap). The fp32 running max m, sum l and the D/4-wide slice of acc
// live in registers: four threads own one q row. K/V tiles that the causal
// or window mask covers completely are skipped, so a causal prefill reads
// and multiplies about half of the T x S pairs. This first version uses the
// CUDA cores in fp32 (no tensor cores), so it sits far from the bound; the
// gap is recorded in PERF.md and closing it (mma/wgmma, TMA) is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;            // q rows per block
constexpr int BK = 32;            // kv rows per tile
constexpr int NT = 4 * BQ;        // four threads per q row
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// `rows` rows of D elements into fp32 shared memory (row stride ld); rows
// at or past `valid` are zero-filled. 16-byte loads: D * sizeof(T) and the
// row starts are multiples of 16 bytes (checked by the Python wrapper).
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

template <int D>
constexpr int smem_floats() {
  return BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                T* __restrict__ o, int S, int T_len, int H, int KV, float scale, int causal,
                int window, float softcap, int q_offset) {
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
  const T* kb = k + (long long)b * T_len * kv_row + (long long)n * D;
  const T* vb = v + (long long)b * T_len * kv_row + (long long)n * D;

  load_tile<T>(Qs, LDQ, q + ((long long)b * S + q0) * q_row + (long long)h * D, q_row,
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
    load_tile<T>(Ks, LDK, kb + k0 * kv_row, kv_row, kval, BK, D);
    load_tile<T>(Vs, LDV, vb + k0 * kv_row, kv_row, kval, BK, D);
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
      Ps[r * LDP + j4 + 4 * i] = to_f(from_f<T>(p));      // p in v's dtype for PV
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
    T* orow = o + ((long long)b * S + q0 + r) * q_row + (long long)h * D;
#pragma unroll
    for (int i = 0; i < NA; ++i) orow[j4 + 4 * i] = from_f<T>(acc[i] / (l + 1e-30f));
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int S, int T_len,
                   int H, int KV, int causal, int window, float softcap, float scale,
                   int q_offset, cudaStream_t stream) {
  const int bytes = smem_floats<D>() * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(attn_fwd_kernel<T, D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  attn_fwd_kernel<T, D><<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, T_len, H, KV, scale, causal, window, softcap, q_offset);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o, int B, int S,
                       int T_len, int H, int KV, int D, int causal, int window, float softcap,
                       float scale, int q_offset, cudaStream_t st) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, S, T_len, H, KV, causal, window, softcap, scale, q_offset, st);
    case 32: return launch<T, 32>(q, k, v, o, B, S, T_len, H, KV, causal, window, softcap, scale, q_offset, st);
    case 64: return launch<T, 64>(q, k, v, o, B, S, T_len, H, KV, causal, window, softcap, scale, q_offset, st);
    case 128: return launch<T, 128>(q, k, v, o, B, S, T_len, H, KV, causal, window, softcap, scale, q_offset, st);
    case 256: return launch<T, 256>(q, k, v, o, B, S, T_len, H, KV, causal, window, softcap, scale, q_offset, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o all of it). Returns the
// cudaError_t of the launch; the Python wrapper raises on non-zero.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int B,
                                   int S, int T_len, int H, int KV, int D, int dtype, int causal,
                                   int window, float softcap, float scale, int q_offset,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_d<float>(q, k, v, o, B, S, T_len, H, KV, D, causal, window, softcap,
                                  scale, q_offset, st);
  if (dtype == 1)
    return (int)dispatch_d<__nv_bfloat16>(q, k, v, o, B, S, T_len, H, KV, D, causal, window,
                                          softcap, scale, q_offset, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
