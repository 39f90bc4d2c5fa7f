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
// 2. A GEMM grid over (row tile, column block) pairs, sized by a bound on
//    the row tiles, ceil(T / BM) + E: the E + 1 groups' partial tiles add
//    at most E + 1 to floor(T / BM), and when BM divides T their rows sum
//    to a multiple of BM, so they add at most E. A block finds its group by
//    a binary search over the tile scan and exits past the last tile; a
//    tail tile writes zeros. Loads past a group's end, D or F are
//    zero-filled and stores are masked, so no shape needs padding.
//
// Three GEMM kernels, chosen by dtype and shape alone (never after a
// failure; `choose` below):
// - bf16 with D and F multiples of 8 and x, W, out 16-byte aligned, which
//   TMA can map (every registry width): `gg_wgmma_kernel`, tiles of 128
//   rows by 256 columns, or 256 by 128 where groups average 128 rows or
//   more and D >= 8192 (one block then streams a group's long W column
//   block once, not once per row tile; measured faster only at jamba's w2,
//   D 14336). One producer thread keeps a ring of 4 stages of 48 KB full
//   by TMA: x in 64-row boxes from a 2-D map over x [T, D] (K-major; only
//   the boxes that hold the tile's rows are loaded, and rows past T come
//   zero-filled; rows of the next group inside a box are loaded and
//   dropped at the store), W from a 3-D map over W [E, D, F] (the MN-major
//   B operand, as V in flash_attention.cu), both 128-byte swizzled, with
//   full and empty mbarriers per stage. Two consumer warpgroups run SS
//   `wgmma` m64nNk16 on their 64 or 128 rows with fp32 accumulators, one
//   group in flight; `setmaxnreg` moves registers from the producer
//   warpgroup to them. The epilogue rounds to bf16 through shared memory
//   and stores 16 bytes a thread, row-masked so no row of another group is
//   written. Blocks run group by group, and within a group column block by
//   column block, its row tiles consecutive: a group's W tile is read from
//   device memory once and its second row tile finds it in L2 (50 MB), and
//   its x rows stay in L2 across its column blocks.
//   What bounds it (PERF.md): the x and W tiles that the blocks pull from
//   L2 into shared memory, 2.2-2.6x the bytes read from device memory at
//   olmoe's and jamba's widths (1.3x at qwen3-moe's); 72-85% of the bytes
//   bound at the registry widths. A persistent grid (no faster, and slower
//   at 128 x 256 where ptxas serialised the wgmma) and a 2-CTA cluster
//   sharing the W tile by TMA multicast (slower) were tried and not kept.
// - other bf16 shapes: `gg_bf16_kernel`, 64 x 128 tiles of mma.sync
//   m16n8k16 from a 3-stage cp.async ring (16-byte copies where D and F
//   are multiples of 8, else element by element).
// - fp32: `gg_f32_kernel` on the CUDA cores in fp32 FMA (TF32 would miss
//   the reference's 1e-5), a 64 x 64 tile of 4 x 4 per thread.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"   // TMA, mbarrier, wgmma and mma.sync helpers (kernels/csrc)

namespace {

constexpr int BM = 64;              // rows per tile of the mma.sync and fp32 kernels
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
template <int BM, typename I>
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

// Tile `id` of the (row tile, column block) pairs, taken group by group,
// within a group column block by column block, its row tiles consecutive:
// its group g (E for the tail), rows [r0, r1) and column block col of
// ncol. False past the last tile.
template <int BM>
__device__ __forceinline__ bool find_tile(const int* __restrict__ sched, int E, int ncol, int id,
                                          int& g, int& r0, int& r1, int& col) {
  const int* rows = sched;
  const int* tiles = sched + E + 2;
  if (id >= tiles[E + 1] * ncol) return false;
  int lo = 0, hi = E;               // the last group whose first tile is <= id
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (tiles[mid] * ncol <= id) lo = mid;
    else hi = mid - 1;
  }
  g = lo;
  const int nt = tiles[g + 1] - tiles[g];           // > 0: the last such group has tiles
  const int local = id - tiles[g] * ncol;
  col = local / nt;
  r0 = rows[g] + (local - col * nt) * BM;
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

// ------------------------------------------------- bf16: wgmma fed by TMA

// Tile shape of the wgmma kernel: BM rows (128 or 256) by BN columns (256
// or 128), K in steps of one 128-byte swizzle row (64 bf16). Each consumer
// warpgroup owns BM / 2 rows, MI m64 tiles of them.
template <int BM_, int BN_>
struct Wg {
  static constexpr int BM = BM_, BN = BN_, BK = 64;
  static constexpr int MI = BM / 128;                  // m64 tiles of one consumer warpgroup
  static constexpr int A_BYTES = BM * BK * 2;          // x tile: BM rows of 128 bytes
  static constexpr int B_BYTES = BK * BN * 2;          // W tile: BN / 64 boxes of 64 x 64
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int ST = 192 * 1024 / STAGE < 6 ? 192 * 1024 / STAGE : 6;   // ring stages
  static constexpr int OUT_LD = BN + 8;                // staged out row (+16 B: no bank conflicts)
  static constexpr int SMEM = ST * STAGE + 16 * ST + 1024;
  static_assert(BM * OUT_LD * 2 <= ST * STAGE, "the out tile reuses the ring");
};
constexpr int WG_NT = 384;          // the producer warpgroup and two consumer warpgroups

template <int BM, int BN>
__global__ void __launch_bounds__(WG_NT, 1)
gg_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
                __nv_bfloat16* __restrict__ out, const int* __restrict__ sched, int D, int F,
                int E) {
  using C = Wg<BM, BN>;
  int g, r0, r1, col;
  if (!find_tile<BM>(sched, E, (F + BN - 1) / BN, blockIdx.x, g, r0, r1, col)) return;
  const int n0 = col * BN;
  if (g == E) {
    zero_tile(out, r0, r1, n0, BN, F);
    return;
  }
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);   // swizzle atoms
  const uint32_t ring = smem_u32(base);
  const uint32_t bars = ring + C::ST * C::STAGE;      // full [ST], then empty [ST]
  auto sA = [&](int s) { return ring + s * C::STAGE; };
  auto sB = [&](int s) { return ring + s * C::STAGE + C::A_BYTES; };
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (C::ST + s); };
  const int tid = threadIdx.x, wg = tid >> 7;
  const int nk = (D + C::BK - 1) / C::BK;
  const int nbox = (r1 - r0 + 63) / 64;   // 64-row boxes of x that hold this tile's rows

  if (tid == 0) {
    for (int s = 0; s < C::ST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);       // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the ring full; the warpgroup gives its
    // registers to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % C::ST;
        if (kt >= C::ST) mbar_wait(empty(s), ((kt / C::ST) - 1) & 1);
        mbar_expect_tx(full(s), nbox * 64 * 128 + C::B_BYTES);
        for (int j = 0; j < nbox; ++j)
          tma_load(sA(s) + j * 64 * 128, &tm_x, full(s), kt * C::BK, r0 + 64 * j);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load(sB(s) + j * 64 * 128, &tm_w, full(s), n0 + 64 * j, kt * C::BK, g);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int cw = wg - 1, warp = (tid & 127) >> 5, lane = tid & 31;
  float acc[C::MI][BN / 2];
#pragma unroll
  for (int m = 0; m < C::MI; ++m)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[m][i] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % C::ST;
    mbar_wait(full(s), (kt / C::ST) & 1);
#pragma unroll
    for (int m = 0; m < C::MI; ++m) fence_regs(acc[m]);
    wgmma_fence();
#pragma unroll
    for (int m = 0; m < C::MI; ++m) {
      if (cw * C::MI + m >= nbox) continue;   // rows past the group: not loaded
#pragma unroll
      for (int kk = 0; kk < C::BK / 16; ++kk) {
        // x: K-major, rows of 128 bytes, a k step is 32 bytes inside the
        // swizzled row; W: MN-major, a k step is 16 rows, boxes of 64
        // columns 8 KB apart
        const uint32_t rows = (cw * C::MI + m) * 64;
        const uint64_t da = gmma_desc(sA(s) + rows * 128 + kk * 32, 16, 8 * 128, 1);
        const uint64_t db = gmma_desc(sB(s) + kk * 16 * 128, 64 * 128, 8 * 128, 1);
        wgmma_ss<1>(acc[m], da, db, 1);
      }
    }
    wgmma_commit();
#pragma unroll
    for (int m = 0; m < C::MI; ++m) fence_regs(acc[m]);
    wgmma_wait<1>();                // step kt - 1 has read its stage: release it
#pragma unroll
    for (int m = 0; m < C::MI; ++m) fence_regs(acc[m]);
    if (kt > 0 && lane == 0) mbar_arrive(empty((kt - 1) % C::ST));
  }
  wgmma_wait<0>();
#pragma unroll
  for (int m = 0; m < C::MI; ++m) fence_regs(acc[m]);

  // epilogue: bf16 through shared memory (the ring, which no copy or
  // product uses any more), then 16-byte stores of this group's rows
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(base);
#pragma unroll
  for (int m = 0; m < C::MI; ++m) {
    const int row = (cw * C::MI + m) * 64 + 16 * warp + (lane >> 2);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint32_t*>(tile + (row + 8 * h) * C::OUT_LD + 8 * j + 2 * (lane & 3)) =
            pack_bf16(acc[m][4 * j + 2 * h], acc[m][4 * j + 2 * h + 1]);
  }
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  for (int i = tid - 128; i < BM * (BN / 8); i += 256) {
    const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
    if (r0 + r < r1 && n0 + c < F)
      *reinterpret_cast<uint4*>(out + (long long)(r0 + r) * F + n0 + c) =
          *reinterpret_cast<const uint4*>(tile + r * C::OUT_LD + c);
  }
}

template <int BM, int BN>
int launch_wgmma(const void* x, const void* W, void* out, const int* sched, int T, int D, int F,
                 int E, cudaStream_t st) {
  using C = Wg<BM, BN>;
  CUtensorMap tx, tw;
  const cuuint64_t x_dims[2] = {(cuuint64_t)D, (cuuint64_t)T};
  const cuuint64_t x_strides[1] = {(cuuint64_t)D * 2};
  const cuuint32_t x_box[2] = {C::BK, 64};
  const cuuint64_t w_dims[3] = {(cuuint64_t)F, (cuuint64_t)D, (cuuint64_t)E};
  const cuuint64_t w_strides[2] = {(cuuint64_t)F * 2, (cuuint64_t)D * F * 2};
  const cuuint32_t w_box[3] = {64, C::BK, 1};
  int rc = encode_bf16(&tx, x, 2, x_dims, x_strides, x_box, 128);
  if (rc == 0) rc = encode_bf16(&tw, W, 3, w_dims, w_strides, w_box, 128);
  if (rc != 0) return rc;
  const cudaError_t e = cudaFuncSetAttribute(gg_wgmma_kernel<BM, BN>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const int blocks = ((T + BM - 1) / BM + E) * ((F + BN - 1) / BN);
  gg_wgmma_kernel<BM, BN><<<blocks, WG_NT, C::SMEM, st>>>(
      tx, tw, static_cast<__nv_bfloat16*>(out), sched, D, F, E);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- bf16: mma.sync

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

// grid: row tiles x ceil(F / BN16) column blocks; block NT16. `vec`: D and F are multiples of
// 8 and x, W 16-byte aligned, so tiles load as 16-byte cp.async; otherwise
// element by element (the ring and its barriers are the same).
__global__ void __launch_bounds__(NT16)
gg_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ W,
               __nv_bfloat16* __restrict__ out, const int* __restrict__ sched, int D, int F, int E,
               int vec) {
  __shared__ __align__(16) __nv_bfloat16 As[STAGES][BM][A_LD];
  __shared__ __align__(16) __nv_bfloat16 Bs[STAGES][BK16][B_LD];
  int g, r0, r1, col;
  if (!find_tile<BM>(sched, E, (F + BN16 - 1) / BN16, blockIdx.x, g, r0, r1, col)) return;
  const int n0 = col * BN16;
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
      uint32_t a[2][4], b[8][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldmatrix_x4(a[i], smem_u32(&As[st][wm * 32 + i * 16 + (lane & 15)][kk + (lane >> 4) * 8]));
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, smem_u32(&Bs[st][kk + (lane & 15)][wn * 64 + j * 16 + (lane >> 4) * 8]));
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

// grid: row tiles x ceil(F / BN32) column blocks; block NT32 = 16 x 16 threads, each owning
// rows ty + 16 i and columns tx + 16 j (i, j < 4) of the 64 x 64 tile.
__global__ void __launch_bounds__(NT32)
gg_f32_kernel(const float* __restrict__ x, const float* __restrict__ W, float* __restrict__ out,
              const int* __restrict__ sched, int D, int F, int E) {
  __shared__ float As[BK32][BM + 4];  // transposed: As[k][row]
  __shared__ float Bs[BK32][BN32 + 4];
  int g, r0, r1, col;
  if (!find_tile<BM>(sched, E, (F + BN32 - 1) / BN32, blockIdx.x, g, r0, r1, col)) return;
  const int n0 = col * BN32;
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

template <int BM, typename I>
cudaError_t schedule(const void* sizes, int* sched, int E, int T, cudaStream_t st) {
  schedule_kernel<BM, I><<<1, SCHED_NT, 0, st>>>(static_cast<const I*>(sizes), sched, E, T);
  return cudaGetLastError();
}

template <int BM>
cudaError_t schedule(const void* sizes, int sizes_int64, int* sched, int E, int T,
                     cudaStream_t st) {
  return sizes_int64 ? schedule<BM, long long>(sizes, sched, E, T, st)
                     : schedule<BM, int>(sizes, sched, E, T, st);
}

enum Variant { F32 = 0, MMA_SYNC = 1, WGMMA_128 = 2, WGMMA_256 = 3 };

// The GEMM kernel, by dtype and shape alone: bf16 that TMA can map (D, F
// multiples of 8, E > 0, x, W, out 16-byte aligned) takes the wgmma kernel,
// with 256 x 128 tiles where groups average 128 rows or more (T >= 128 E)
// and D >= 8192, else 128 x 256; other bf16 the mma.sync kernel; fp32 the
// CUDA-core kernel.
Variant choose(const void* x, const void* W, const void* out, int T, int D, int F, int E,
               int dtype) {
  if (dtype == 0) return F32;
  const bool tma = D > 0 && D % 8 == 0 && F % 8 == 0 && E > 0 && aligned(x, 16) &&
                   aligned(W, 16) && aligned(out, 16);
  if (!tma) return MMA_SYNC;
  return (long long)T >= 128LL * E && D >= 8192 ? WGMMA_256 : WGMMA_128;
}

}  // namespace

// x: [T, D]; sizes: [E] int32 (sizes_int64 = 0) or int64; W: [E, D, F];
// out: [T, F]; x, W and out all fp32 (dtype 0) or all bf16 (dtype 1), on one
// device, contiguous. sched: 2 (E + 2) int32 of scratch. Two launches on
// `stream`: the schedule, then the kernel `choose` names. Returns 0, a
// cudaError_t or ENCODE_ERROR + a CUresult, which the Python wrapper raises
// on.
extern "C" int grouped_gemm_fwd(const void* x, const void* sizes, int sizes_int64, const void* W,
                                void* out, int* sched, int T, int D, int F, int E, int dtype,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T <= 0 || F <= 0) return 0;
  if (E < 0 || D < 0 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  const Variant v = choose(x, W, out, T, D, F, E, dtype);
  if (v == WGMMA_128 || v == WGMMA_256) {
    const cudaError_t err = v == WGMMA_256 ? schedule<256>(sizes, sizes_int64, sched, E, T, st)
                                           : schedule<128>(sizes, sizes_int64, sched, E, T, st);
    if (err != cudaSuccess) return (int)err;
    return v == WGMMA_256 ? launch_wgmma<256, 128>(x, W, out, sched, T, D, F, E, st)
                          : launch_wgmma<128, 256>(x, W, out, sched, T, D, F, E, st);
  }
  const cudaError_t err = schedule<BM>(sizes, sizes_int64, sched, E, T, st);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (T + BM - 1) / BM + E;
  if (v == MMA_SYNC) {
    const int vec = D % 8 == 0 && F % 8 == 0 && aligned(x, 16) && aligned(W, 16) &&
                    aligned(out, 4);
    gg_bf16_kernel<<<tiles * ((F + BN16 - 1) / BN16), NT16, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(W),
        static_cast<__nv_bfloat16*>(out), sched, D, F, E, vec);
  } else {
    gg_f32_kernel<<<tiles * ((F + BN32 - 1) / BN32), NT32, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(W), static_cast<float*>(out),
        sched, D, F, E);
  }
  return (int)cudaGetLastError();
}

// The kernel grouped_gemm_fwd would launch for these arguments (out may be
// 0, aligned, before it exists): 0 fp32, 1 mma.sync, 2 wgmma 128 x 256, 3
// wgmma 256 x 128.
extern "C" int grouped_gemm_variant(const void* x, const void* W, const void* out, int T, int D,
                                    int F, int E, int dtype) {
  return (int)choose(x, W, out, T, D, F, E, dtype);
}

extern "C" const char* grouped_gemm_error_string(int err) {
  return hopper_error_string(err);
}
