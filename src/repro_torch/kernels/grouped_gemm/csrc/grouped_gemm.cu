// Ragged grouped GEMM for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces: src/repro/kernels/grouped_gemm/kernel.py:29 `grouped_gemm_pallas`
// (Pallas body `_gg_kernel`, :21, reached through ops.py:17 `grouped_gemm`):
// out[t] = x[t] @ W[expert_of(t)] over rows sorted by expert, fp32
// accumulation, out in x's dtype. The TPU op pads every group to block_m
// rows, scatters the rows into an aligned copy and prefetches one expert id
// per row block; here the kernel reads the group sizes on the device and
// works on the rows where they lie, with no copy. Rows past
// sum(group_sizes) are written as zeros (as jax.lax.ragged_dot and the
// reference oracle give them).
//
// Bound on the H100: bytes at the registry's MoE widths. Each row meets one
// expert, so a product does 2 D F FLOP per row against x, W of every
// non-empty expert and out read or written once; olmoe's 9,616 rows
// (1,202 tokens x top 8) over 64 experts of 2048 x 1024 are 327 MB and
// 40 GFLOP: 0.098 ms at 3.35 TB/s against 0.041 ms at 989 TFLOP/s.
//
// Design: two launches on the caller's stream, no host sync.
// 1. `schedule_kernel` (one block): exclusive scans of the group sizes
//    (clamped to T) and of each group's row-tile count ceil(n / BM), with
//    the rows past the last group as one more group, the tail.
// 2. The GEMM grid is (ceil(T / BM) + E) x ceil(F / BN), a bound on the
//    row tiles: the E + 1 groups' partial tiles add at most E + 1 to
//    floor(T / BM), and when BM divides T their rows sum to a multiple of
//    BM, so they add at most E. A block finds its group by a binary search
//    over the tile scan and exits past the last tile; a tail tile writes zeros. Loads past a group's end, D or F
//    are zero-filled and stores are masked, so no shape needs padding.
//    Consecutive blocks take consecutive row tiles of one column block, so
//    a group's W tile is shared through L2 by its row tiles.
//    bf16: a 64 x 128 tile, 4 warps of 32 x 64, K in steps of 32 through a
//    3-stage cp.async ring (zero-fill past the edges), fragments by
//    ldmatrix (.trans for the row-major W), mma.sync m16n8k16 with fp32
//    accumulators. fp32: the CUDA cores in fp32 FMA (TF32 would miss the
//    reference's 1e-5), a 64 x 64 tile of 4 x 4 per thread.
// This first version re-reads W once per row tile of its group (about 3x
// at olmoe's ~150 rows an expert) and uses mma.sync, not wgmma/TMA.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;              // rows per tile, both dtypes
constexpr int SCHED_NT = 1024;      // threads of the schedule block

// ---------------------------------------------------------------- schedule

template <typename V>
__device__ __forceinline__ V block_inclusive_scan(V v, V* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const V y = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += y;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    V s = warp_sums[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const V y = __shfl_up_sync(0xffffffffu, s, off);
      if (lane >= off) s += y;
    }
    warp_sums[lane] = s;
  }
  __syncthreads();
  if (warp > 0) v += warp_sums[warp - 1];
  __syncthreads();                  // warp_sums is reused by the next scan
  return v;
}

// sched[0 .. E+1]: first row of groups 0..E (group E is the tail of rows
// past the last expert) and T; sched[E+2 .. 2E+3]: first tile of groups
// 0..E and the tile count. Negative sizes count as 0; ends clamp to T.
template <typename I>
__global__ void __launch_bounds__(SCHED_NT)
schedule_kernel(const I* __restrict__ sizes, int* __restrict__ sched, int E, int T) {
  __shared__ long long warp_rows[32];
  __shared__ int warp_tiles[32];
  __shared__ long long carry_rows;
  __shared__ int carry_tiles;
  int* rows = sched;
  int* tiles = sched + E + 2;
  const int tid = threadIdx.x;
  if (tid == 0) {
    carry_rows = 0;
    carry_tiles = 0;
  }
  __syncthreads();
  for (int base = 0; base < E; base += SCHED_NT) {
    const int e = base + tid;
    long long n = e < E ? (long long)sizes[e] : 0;
    n = n > 0 ? n : 0;
    const long long incl = block_inclusive_scan(n, warp_rows);
    const long long beg = min(carry_rows + incl - n, (long long)T);
    const long long end = min(carry_rows + incl, (long long)T);
    const int t = (int)((end - beg + BM - 1) / BM);
    const int tincl = block_inclusive_scan(t, warp_tiles);
    if (e < E) {
      rows[e] = (int)beg;
      tiles[e] = carry_tiles + tincl - t;
    }
    __syncthreads();                // every thread has read the carries
    if (tid == SCHED_NT - 1) {
      carry_rows += incl;
      carry_tiles += tincl;
    }
    __syncthreads();
  }
  if (tid == 0) {
    const int done = (int)min(carry_rows, (long long)T);
    rows[E] = done;
    rows[E + 1] = T;
    tiles[E] = carry_tiles;
    tiles[E + 1] = carry_tiles + (T - done + BM - 1) / BM;
  }
}

// This block's row tile: its group g (E for the tail) and rows [r0, r1).
// False past the last tile.
__device__ __forceinline__ bool find_tile(const int* __restrict__ sched, int E, int& g, int& r0,
                                          int& r1) {
  const int* rows = sched;
  const int* tiles = sched + E + 2;
  const int tile = blockIdx.x;
  if (tile >= tiles[E + 1]) return false;
  int lo = 0, hi = E;               // the last group whose first tile is <= tile
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (tiles[mid] <= tile) lo = mid;
    else hi = mid - 1;
  }
  g = lo;
  r0 = rows[g] + (tile - tiles[g]) * BM;
  r1 = min(r0 + BM, rows[g + 1]);
  return true;
}

template <typename T>
__device__ void zero_tile(T* out, int r0, int r1, int n0, int bn, int F) {
  const int cols = min(bn, F - n0);
  for (int i = threadIdx.x; i < (r1 - r0) * cols; i += blockDim.x) {
    const int r = i / cols, c = i - r * cols;
    out[(long long)(r0 + r) * F + n0 + c] = T(0.f);
  }
}

// ---------------------------------------------------------------- bf16

constexpr int BN16 = 128, BK16 = 32, STAGES = 3, NT16 = 128;
constexpr int A_LD = BK16 + 8;      // +16 bytes a row: ldmatrix rows fall on distinct banks
constexpr int B_LD = BN16 + 8;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned* r, const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned* r, const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// grid (tiles, ceil(F / BN16)); block NT16. `vec`: D and F are multiples of
// 8 and x, W 16-byte aligned, so tiles load as 16-byte cp.async; otherwise
// element by element (the ring and its barriers are the same).
__global__ void __launch_bounds__(NT16)
gg_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ W,
               __nv_bfloat16* __restrict__ out, const int* __restrict__ sched, int D, int F, int E,
               int vec) {
  __shared__ __align__(16) __nv_bfloat16 As[STAGES][BM][A_LD];
  __shared__ __align__(16) __nv_bfloat16 Bs[STAGES][BK16][B_LD];
  int g, r0, r1;
  if (!find_tile(sched, E, g, r0, r1)) return;
  const int n0 = blockIdx.y * BN16;
  if (g == E) {
    zero_tile(out, r0, r1, n0, BN16, F);
    return;
  }
  const __nv_bfloat16* Wg = W + (long long)g * D * F;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;  // warp tile: rows wm*32, cols wn*64
  const int nk = (D + BK16 - 1) / BK16;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  auto load = [&](int st, int kt) {
    const int k0 = kt * BK16;
    if (vec) {
      for (int v = tid; v < BM * BK16 / 8; v += NT16) {
        const int r = v / (BK16 / 8), c = (v % (BK16 / 8)) * 8;
        const int gr = r0 + r, gk = k0 + c;
        const bool ok = gr < r1 && gk < D;
        cp_async16(&As[st][r][c], ok ? x + (long long)gr * D + gk : x, ok);
      }
      for (int v = tid; v < BK16 * BN16 / 8; v += NT16) {
        const int r = v / (BN16 / 8), c = (v % (BN16 / 8)) * 8;
        const int gk = k0 + r, gn = n0 + c;
        const bool ok = gk < D && gn < F;
        cp_async16(&Bs[st][r][c], ok ? Wg + (long long)gk * F + gn : Wg, ok);
      }
    } else {
      for (int i = tid; i < BM * BK16; i += NT16) {
        const int r = i / BK16, c = i % BK16, gr = r0 + r, gk = k0 + c;
        As[st][r][c] = (gr < r1 && gk < D) ? x[(long long)gr * D + gk] : zero;
      }
      for (int i = tid; i < BK16 * BN16; i += NT16) {
        const int r = i / BN16, c = i % BN16, gk = k0 + r, gn = n0 + c;
        Bs[st][r][c] = (gk < D && gn < F) ? Wg[(long long)gk * F + gn] : zero;
      }
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();    // this thread's copies of tile kt are in
    __syncthreads();                // everyone's are, and tile kt-1 is consumed
    const int nxt = kt + STAGES - 1;
    if (nxt < nk) load(nxt % STAGES, nxt);
    cp_async_commit();
    const int st = kt % STAGES;
#pragma unroll
    for (int kk = 0; kk < BK16; kk += 16) {
      unsigned a[2][4], b[8][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldmatrix_x4(a[i], &As[st][wm * 32 + i * 16 + (lane & 15)][kk + (lane >> 4) * 8]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        unsigned r[4];
        ldmatrix_x4_trans(r, &Bs[st][kk + (lane & 15)][wn * 64 + j * 16 + (lane >> 4) * 8]);
        b[2 * j][0] = r[0];
        b[2 * j][1] = r[1];
        b[2 * j + 1][0] = r[2];
        b[2 * j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  }
  cp_async_wait<0>();

  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + wn * 64 + j * 8 + tig * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + wm * 32 + i * 16 + gid + h * 8;
        if (row >= r1) continue;
        __nv_bfloat16* o = out + (long long)row * F + col;
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (vec) {
          if (col < F) *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
        } else {
          if (col < F) o[0] = __float2bfloat16(v0);
          if (col + 1 < F) o[1] = __float2bfloat16(v1);
        }
      }
    }
}

// ---------------------------------------------------------------- fp32

constexpr int BN32 = 64, BK32 = 16, NT32 = 256;

// grid (tiles, ceil(F / BN32)); block NT32 = 16 x 16 threads, each owning
// rows ty + 16 i and columns tx + 16 j (i, j < 4) of the 64 x 64 tile.
__global__ void __launch_bounds__(NT32)
gg_f32_kernel(const float* __restrict__ x, const float* __restrict__ W, float* __restrict__ out,
              const int* __restrict__ sched, int D, int F, int E) {
  __shared__ float As[BK32][BM + 4];  // transposed: As[k][row]
  __shared__ float Bs[BK32][BN32 + 4];
  int g, r0, r1;
  if (!find_tile(sched, E, g, r0, r1)) return;
  const int n0 = blockIdx.y * BN32;
  if (g == E) {
    zero_tile(out, r0, r1, n0, BN32, F);
    return;
  }
  const float* Wg = W + (long long)g * D * F;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < D; k0 += BK32) {
    for (int i = tid; i < BM * BK32; i += NT32) {
      const int r = i / BK32, c = i % BK32, gr = r0 + r, gk = k0 + c;
      As[c][r] = (gr < r1 && gk < D) ? x[(long long)gr * D + gk] : 0.f;
    }
    for (int i = tid; i < BK32 * BN32; i += NT32) {
      const int r = i / BN32, c = i % BN32, gk = k0 + r, gn = n0 + c;
      Bs[r][c] = (gk < D && gn < F) ? Wg[(long long)gk * F + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK32; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row >= r1) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < F) out[(long long)row * F + col] = acc[i][j];
    }
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// x: [T, D]; sizes: [E] int32 (sizes_int64 = 0) or int64; W: [E, D, F];
// out: [T, F]; x, W and out all fp32 (dtype 0) or all bf16 (dtype 1), on one
// device, contiguous. sched: 2 (E + 2) int32 of scratch. Two launches on
// `stream`; returns the cudaError_t of the launches, which the Python
// wrapper raises on when non-zero.
extern "C" int grouped_gemm_fwd(const void* x, const void* sizes, int sizes_int64, const void* W,
                                void* out, int* sched, int T, int D, int F, int E, int dtype,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T <= 0 || F <= 0) return 0;
  if (E < 0 || D < 0 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  if (sizes_int64)
    schedule_kernel<long long><<<1, SCHED_NT, 0, st>>>(static_cast<const long long*>(sizes), sched,
                                                       E, T);
  else
    schedule_kernel<int><<<1, SCHED_NT, 0, st>>>(static_cast<const int*>(sizes), sched, E, T);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int tiles = (T + BM - 1) / BM + E;
  if (dtype == 1) {
    const int vec = D % 8 == 0 && F % 8 == 0 && aligned(x, 16) && aligned(W, 16) &&
                    aligned(out, 4);
    gg_bf16_kernel<<<dim3(tiles, (F + BN16 - 1) / BN16), NT16, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(W),
        static_cast<__nv_bfloat16*>(out), sched, D, F, E, vec);
  } else {
    gg_f32_kernel<<<dim3(tiles, (F + BN32 - 1) / BN32), NT32, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(W), static_cast<float*>(out),
        sched, D, F, E);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* grouped_gemm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
