// Exact cosine top-k for pools above the heap kernel's limit (256 < k <= 8192),
// for Hopper (sm_90a).
//
// Replaces the same TPU kernel as cosine_topk.cu, rag_uq_tpu/ops/pallas_topk.py::
// pallas_cosine_topk, for the k that the heap kernel cannot hold in shared
// memory: per query, the k corpus rows with the largest q . e, products of
// operands in the corpus dtype (bf16, fp16 or f32) summed in f32, rows at or
// past `size` masked, ties to the lowest row index, -1 and -inf in the slots
// past the live rows. The JAX package serves such k through its XLA
// cosine_topk (k <= block = 8192), which DenseIndex.search_batch calls with
// the user's top_k.
//
// Bound at the main path's width (B = 2048, 100000 live rows, D = 768, bf16)
// on an H100 SXM: 3.1e11 flop, which at the bf16 tensor rate of 989 TFLOP/s
// is 0.318 ms, against 0.15 GB of corpus reads (0.046 ms at 3.35 TB/s):
// bound by operations. The [B, live] f32 scores (0.82 GB) that this design
// writes and reads back are its own traffic, not the function's.
//
// What bound the earlier design (10.47 / 10.61 / 11.75 ms at k = 257 / 1000
// / 8192 on an H100 80GB HBM3 at 700 W, against 2.10 / 2.11 / 3.18 ms for
// torch.matmul + torch.topk):
//   1. The score pass multiplied with f32 FMAs on CUDA cores (no tensor
//      cores): at least 4.7 ms at the 67 TFLOP/s f32 rate.
//   2. The select read each query's score row six times: four 8-bit radix
//      passes (the first digit of an ordered f32 is the sign and the top of
//      the exponent, so one octave of scores falls into one bin and that
//      pass separated almost nothing), a compaction and a gather.
//   3. A bitonic sort of the k (value, row) keys in shared memory: 91
//      block-wide stages at k = 8192, each moving all 64 KB of keys.
// What this design does about each:
//   1. score_kernel runs on the heap kernel's building blocks
//      (hopper_tile.cuh): a TMA ring of 128B-swizzled boxes filled by one
//      producer thread, and two consumer warpgroups each running wgmma
//      m64n128k16 on 64 queries x 128 rows (bf16, fp16). An f32 corpus
//      takes f32 FMAs on CUDA cores over the same ring (no TF32), blocked
//      8 rows x 8 columns a thread; its sums run in the order of cuBLAS's
//      f32 product and match it bit for bit. Each warp stages its 16 rows
//      in shared memory, 8 at a time, and writes them as rows of 128
//      scores with 16-byte stores into the [B, ld] buffer (ld = live
//      rounded up to 32 floats, so every row starts 128-byte aligned);
//      columns at or past live are never written. Each thread folds its
//      rows' max and min into registers tile by tile; at the block's end a
//      reduction over the lanes that share a row and one integer
//      atomicMax/atomicMin a row put them, as order-preserving u32, into
//      `stats` for the select.
//   2. select_kernel, one block of 1024 threads a query, reads the row
//      twice on the common path: (a) a histogram of 4096 bins over
//      [min, max], bin = min(4095, floor((s - min) * (4096 / (max - min))))
//      in correctly rounded f32 (monotone in s), gives the bin b* that
//      holds the k-th value and the count of rows above it; (b) a
//      compaction in row order (block prefix sums) moves the rows above b*
//      to the output keys and those in b* to a candidate buffer in shared
//      memory, and a radix select among the candidates alone takes the
//      best k - above of them, the lowest rows among ties. (c) When b*
//      holds more candidates than the buffer (identical or heavily
//      clustered scores), the radix select and the compaction of b*'s rows
//      read the row instead: slower, and exact.
//   3. The k keys (value, row), which hold equal values in row order, go
//      through a stable LSD radix sort of the 32-bit ordered value: 8-bit
//      passes, none for a digit that every key shares; ranks inside a warp
//      by __match_any_sync, offsets by one block scan of the per-warp digit
//      counts (their table padded so that the lanes of a warp hit other
//      banks). A pass moves the keys twice, against 91 such moves for the
//      bitonic sort. The values come back from the keys, with no gather
//      from the score row.
// Nothing here is non-deterministic: the only atomics are integer max/min
// and histogram counts, whose results do not depend on their order.
//
// Measured (chip_smoke.py, H100 80GB HBM3 at 700 W, B = 2048, 100000 live
// rows, D = 768, bf16): 1.56 / 1.60 / 2.12 ms at k = 257 / 1000 / 8192, of
// which the score pass 0.64-0.65 ms and the select 0.88 / 0.93 / 1.43 ms,
// against 2.10 / 2.12 / 3.14 ms for torch.matmul + torch.topk; the f32
// corpus at k = 500 8.59 ms. PERF.md has the runs.
//
// Shared memory. score_kernel: 1024 (alignment) + S * (128 + 128) * 128
// (stages) + 8 warps * 8 * STAGE_LD * 4 (staging) + S * 16 (barriers), with
// S as many stages as fit in 232448 (5). select_kernel: (keys_cap +
// tmp_cap) * 8 + 256 * COUNT_LD * 4, with keys_cap = 1024 * ceil(min(k,
// live) / 1024) and tmp_cap = max(keys_cap, CAND_MIN).
//
// Interface: plain C, launched on the caller's stream, returns
// cudaGetLastError() (or the error of the tensor-map encoding).
// rag_cosine_topk_large runs both kernels; the two passes are also callable
// alone, for timing them apart.

#include <cstdint>

#include "hopper_tile.cuh"

namespace {

constexpr int LARGE_MAX_K = 8192;
constexpr int BN = 128;                 // corpus rows a score tile
constexpr int BQ = 128;                 // queries a score tile: two warpgroups of 64
constexpr int SCORE_THREADS = 3 * 128;  // two consumer warpgroups, one producer
constexpr int STAGE_LD = 136;  // floats a staging row: 128 + 8 against bank conflicts
constexpr size_t SMEM_LIMIT = 232448;
constexpr int SELECT_THREADS = 1024;
constexpr int NB = 4096;        // histogram bins of the select
constexpr int PER_THREAD = 8;   // consecutive scores a thread takes a step
constexpr int STEP = SELECT_THREADS * PER_THREAD;
constexpr int MAX_IPT = LARGE_MAX_K / SELECT_THREADS;  // keys a thread ranks in the sort
constexpr int CAND_MIN = 4096;  // candidate capacity at the least
constexpr int WARPS = SELECT_THREADS / 32;
// The sort's per-warp digit counts, a digit's row padded by one so that the
// lanes of a warp, ranking other digits, hit other banks; also the
// histogram.
constexpr int COUNT_LD = WARPS + 1;
constexpr int COUNTS = 256 * COUNT_LD;

static_assert(NB <= COUNTS, "the histogram lives in the counts");
static_assert(WARPS == 32, "a digit's counts are one column a warp, 8 a thread in the scan");
static_assert(NB == 4 * SELECT_THREADS, "four bins a thread when finding b*");

constexpr size_t score_smem(int stages) {
  return 1024 + static_cast<size_t>(stages) * (BQ + BN) * BOX_BYTES +
         static_cast<size_t>(8) * 8 * STAGE_LD * 4 + static_cast<size_t>(stages) * 16;
}

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

// Order-preserving map of an f32 to a u32 (larger value, larger key), and
// back.
__device__ __forceinline__ uint32_t ordered(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float from_ordered(uint32_t u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// ---- the score pass -------------------------------------------------------

// The products of one ring stage into a warpgroup's 64 x 128 accumulators,
// and half h of a warp's 16 rows (8 rows x 128 columns) out of them into its
// staging tile, whose row r is the warp's row row(h, r). bf16 and fp16 take
// wgmma (Product<T>, the fragment layout: d[4j + 2h + b] is row lane / 4 +
// 8h of the warp, column 8j + 2 (lane % 4) + b).
template <typename T>
struct ScoreTile {
  static constexpr int COLS = Product<T>::COLS;
  __device__ static void stage(float (&d)[64], const T* sq, const T* se, bool first, int wtid) {
    Product<T>::stage(d, sq, se, first, wtid);
  }
  __device__ static void retire_all() { Product<T>::retire_all(); }
  __device__ static void retire_but_last() { Product<T>::retire_but_last(); }
  __device__ static int row(int h, int r) { return 8 * h + r; }
  // The thread's rows of the warp, and the lanes that share them (xor of
  // the low LOG_SHARE lane bits).
  static constexpr int ROWS = 2, LOG_SHARE = 2;
  __device__ static int own_row(int i, int lane) { return (lane >> 2) + 8 * i; }
  // Fold the tile's scores in columns below `valid` into the running max
  // and min of the thread's rows.
  __device__ static void fold(const float (&d)[64], int valid, int lane, float (&hi)[ROWS],
                              float (&lo)[ROWS]) {
    const int sub = lane & 3;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int b = 0; b < 2; ++b)
          if (8 * j + 2 * sub + b < valid) {
            const float v = d[4 * j + 2 * i + b] + 0.f;
            hi[i] = fmaxf(hi[i], v);
            lo[i] = fminf(lo[i], v);
          }
  }
  __device__ static void stage_out(const float (&d)[64], float* st, int h, int lane) {
    const int ra = lane >> 2, sub = lane & 3;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<float2*>(st + ra * STAGE_LD + 8 * j + 2 * sub) =
          make_float2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
  }
};

// f32 takes f32 FMAs on CUDA cores (no TF32), blocked 8 rows x 8 columns a
// thread so that 16 vector loads from the swizzled tiles feed 256 FMAs:
// lane l of warp w of the warpgroup holds d[8i + j] = row 16w + 2i + h
// (h = l / 16) and column l % 16 + 16j. Lanes 16 apart read rows next to
// each other, which the swizzle puts in other banks.
template <>
struct ScoreTile<float> {
  static constexpr int COLS = BOX_BYTES / sizeof(float);  // 32
  __device__ static void stage(float (&d)[64], const float* sq, const float* se, bool first,
                               int wtid) {
    const int r0 = 16 * (wtid >> 5) + ((wtid >> 4) & 1), c0 = wtid & 15;
    if (first) {
#pragma unroll
      for (int i = 0; i < 64; ++i) d[i] = 0.f;
    }
#pragma unroll 1
    for (int chunk = 0; chunk < COLS / 4; ++chunk) {
      float4 qv[8], ev[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) qv[i] = sw128_f32x4(sq, r0 + 2 * i, chunk);
#pragma unroll
      for (int j = 0; j < 8; ++j) ev[j] = sw128_f32x4(se, c0 + 16 * j, chunk);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float& y = d[8 * i + j];
          y = fmaf(qv[i].x, ev[j].x, y);
          y = fmaf(qv[i].y, ev[j].y, y);
          y = fmaf(qv[i].z, ev[j].z, y);
          y = fmaf(qv[i].w, ev[j].w, y);
        }
    }
  }
  __device__ static void retire_all() {}
  __device__ static void retire_but_last() {}
  __device__ static int row(int h, int r) { return 2 * r + h; }
  static constexpr int ROWS = 8, LOG_SHARE = 4;
  __device__ static int own_row(int i, int lane) { return 2 * i + (lane >> 4); }
  __device__ static void fold(const float (&d)[64], int valid, int lane, float (&hi)[ROWS],
                              float (&lo)[ROWS]) {
    const int c0 = lane & 15;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (c0 + 16 * j < valid) {
          const float v = d[8 * i + j] + 0.f;
          hi[i] = fmaxf(hi[i], v);
          lo[i] = fminf(lo[i], v);
        }
  }
  __device__ static void stage_out(const float (&d)[64], float* st, int h, int lane) {
    if ((lane >> 4) != h) return;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) st[i * STAGE_LD + (lane & 15) + 16 * j] = d[8 * i + j];
  }
};

// scores[b * ld + n] = sum_d q[b, d] * emb[n, d] for b < B, n < live;
// stats[b] and stats[B + b] get the ordered max and min of query b's scores
// (they must hold 0 and 0xffffffff before the launch). Grid (query tiles,
// corpus chunks of chunk_rows rows); threads: two consumer warpgroups, then
// one producer warpgroup whose first thread issues every TMA load.
template <typename T>
__global__ void __launch_bounds__(SCORE_THREADS, 1)
score_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_e,
             int B, int D, int live, int stages, int chunk_rows, float* __restrict__ scores,
             int ld, uint32_t* __restrict__ stats) {
  constexpr int COLS = ScoreTile<T>::COLS;
  constexpr uint32_t STAGE_BYTES = (BQ + BN) * BOX_BYTES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  float* staging = reinterpret_cast<float*>(ring + static_cast<size_t>(stages) * STAGE_BYTES);
  uint64_t* bars = reinterpret_cast<uint64_t*>(staging + 8 * 8 * STAGE_LD);
  // bars[s]: stage s is full; bars[stages + s]: stage s is free.

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int r_begin = blockIdx.y * chunk_rows;
  const int r_end = min(r_begin + chunk_rows, live);
  const int n_tiles = r_end > r_begin ? (r_end - r_begin + BN - 1) / BN : 0;
  const int n_k = (D + COLS - 1) / COLS;
  const int total = n_tiles * n_k;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(smem_u32(&bars[s]), 1);
      mbar_init(smem_u32(&bars[stages + s]), 8);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (int step = 0; step < total; ++step) {
        const int tile = step / n_k;
        const int col = (step - tile * n_k) * COLS;
        mbar_wait(smem_u32(&bars[stages + stage]), phase ^ 1);
        const uint32_t full = smem_u32(&bars[stage]);
        mbar_expect_tx(full, STAGE_BYTES);
        const uint32_t dst = smem_u32(ring + static_cast<size_t>(stage) * STAGE_BYTES);
        tma_load_2d(dst, &tm_q, full, col, q0);
        tma_load_2d(dst + BQ * BOX_BYTES, &tm_e, full, col, r_begin + tile * BN);
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = tid >> 7, wtid = tid & 127;
  const int lane = tid & 31, warp = tid >> 5;  // warp w holds query rows 16w .. 16w + 15
  float* st = staging + warp * 8 * STAGE_LD;   // the warp's 8 x 128 staging tile
  // The running max and min of the thread's rows, over the block's tiles.
  constexpr int ROWS = ScoreTile<T>::ROWS;
  float hi[ROWS], lo[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    hi[i] = -pos_inf();
    lo[i] = pos_inf();
  }

  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;

  int stage = 0, prev = 0;
  uint32_t phase = 0;
  for (int tile = 0; tile < n_tiles; ++tile) {
    for (int kb = 0; kb < n_k; ++kb) {
      mbar_wait(smem_u32(&bars[stage]), phase);
      const unsigned char* base = ring + static_cast<size_t>(stage) * STAGE_BYTES;
      const T* sq = reinterpret_cast<const T*>(base + wg * 64 * BOX_BYTES);
      const T* se = reinterpret_cast<const T*>(base + BQ * BOX_BYTES);
      fence_acc(d);
      ScoreTile<T>::stage(d, sq, se, kb == 0, wtid);
      fence_acc(d);
      // Keep this stage's products in flight; the previous stage's are done.
      if (kb > 0) {
        ScoreTile<T>::retire_but_last();
        __syncwarp();
        if (lane == 0) mbar_arrive(smem_u32(&bars[stages + prev]));
      }
      prev = stage;
      if (++stage == stages) {
        stage = 0;
        phase ^= 1;
      }
    }
    ScoreTile<T>::retire_all();
    fence_acc(d);
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(&bars[stages + prev]));

    // ---- epilogue: the max and min folded in; through the staging tile,
    // 8 rows at a time, to rows of the buffer with 16-byte stores ----
    const int n0 = r_begin + tile * BN;
    ScoreTile<T>::fold(d, r_end - n0, lane, hi, lo);
    const int col = n0 + 4 * lane;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ScoreTile<T>::stage_out(d, st, h, lane);
      __syncwarp();
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        float4 v = *reinterpret_cast<const float4*>(st + r * STAGE_LD + 4 * lane);
        v.x += 0.f;  // -0 becomes +0: one key a value
        v.y += 0.f;
        v.z += 0.f;
        v.w += 0.f;
        const int qrow = q0 + warp * 16 + ScoreTile<T>::row(h, r);
        float* dst = scores + static_cast<int64_t>(qrow) * ld + col;
        if (qrow < B && col < r_end) {
          if (col + 4 <= r_end) {
            *reinterpret_cast<float4*>(dst) = v;
          } else {
            dst[0] = v.x;
            if (col + 1 < r_end) dst[1] = v.y;
            if (col + 2 < r_end) dst[2] = v.z;
          }
        }
      }
      __syncwarp();
    }
  }

  if (n_tiles == 0) return;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
#pragma unroll
    for (int bit = 0; bit < ScoreTile<T>::LOG_SHARE; ++bit) {
      hi[i] = fmaxf(hi[i], __shfl_xor_sync(0xffffffffu, hi[i], 1 << bit));
      lo[i] = fminf(lo[i], __shfl_xor_sync(0xffffffffu, lo[i], 1 << bit));
    }
    const int qrow = q0 + warp * 16 + ScoreTile<T>::own_row(i, lane);
    if ((lane & ((1 << ScoreTile<T>::LOG_SHARE) - 1)) == 0 && qrow < B) {
      atomicMax(&stats[qrow], ordered(hi[i]));
      atomicMin(&stats[B + qrow], ordered(lo[i]));
    }
  }
}

// ---- the select -------------------------------------------------------------

// Exclusive prefix sum over the block (SELECT_THREADS threads); *total gets
// the block's sum. `warp_sums` holds 33 ints of shared memory.
__device__ __forceinline__ int block_exclusive_scan(int x, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = warp_sums[lane];
    int wincl = w;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, wincl, off);
      if (lane >= off) wincl += y;
    }
    warp_sums[lane] = wincl - w;  // exclusive sums of the warps
    if (lane == 31) warp_sums[32] = wincl;
  }
  __syncthreads();
  const int out = warp_sums[warp] + incl - x;
  *total = warp_sums[32];
  __syncthreads();  // warp_sums is reused by the next call
  return out;
}

// A key ranks a row: the complemented ordered value above (so ascending keys
// are descending values), the row below.
__device__ __forceinline__ uint64_t make_key(float v, int row) {
  return (static_cast<uint64_t>(~ordered(v)) << 32) | static_cast<uint32_t>(row);
}
__device__ __forceinline__ uint32_t key_value(uint64_t key) {  // the ordered value
  return ~static_cast<uint32_t>(key >> 32);
}

// PER_THREAD consecutive scores from p (16-byte aligned; p + PER_THREAD
// stays inside the row's ld floats, a multiple of 32), as 16-byte loads
// issued together.
__device__ __forceinline__ void load_scores(const float* p, float (&v)[PER_THREAD]) {
  float4 w[PER_THREAD / 4];
#pragma unroll
  for (int j = 0; j < PER_THREAD / 4; ++j) w[j] = reinterpret_cast<const float4*>(p)[j];
#pragma unroll
  for (int j = 0; j < PER_THREAD / 4; ++j) {
    v[4 * j] = w[j].x;
    v[4 * j + 1] = w[j].y;
    v[4 * j + 2] = w[j].z;
    v[4 * j + 3] = w[j].w;
  }
}

// The bin of a score: monotone non-decreasing in s (each step is correctly
// rounded; a NaN product, 0 * inf, converts to bin 0).
__device__ __forceinline__ int bin_of(float s, float mn, float scale) {
  return min(NB - 1, __float2int_rz(__fmul_rn(__fsub_rn(s, mn), scale)));
}

// Radix select over the ordered values that get(i, &u) yields for i < n
// (get returns false where i is not a member): the need-th largest value T
// and how many members equal to T rank within the need best. hist: 256 ints
// of shared memory.
template <typename Get>
__device__ void radix_select(Get get, int n, int need, int* hist, uint32_t* s_prefix,
                             int* s_need, uint32_t* T, int* need_eq) {
  const int tid = threadIdx.x;
  uint32_t prefix = 0, mask = 0;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = tid; i < 256; i += SELECT_THREADS) hist[i] = 0;
    __syncthreads();
    for (int base = 0; base < n; base += SELECT_THREADS) {
      const int i = base + tid;
      int bin = -1;
      uint32_t u;
      if (i < n && get(i, &u) && (u & mask) == prefix) bin = static_cast<int>((u >> shift) & 255u);
      // Identical values share a bin: the lanes of a bin add once.
      const unsigned peers = __match_any_sync(0xffffffffu, bin);
      if (bin >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1)
        atomicAdd(&hist[bin], __popc(peers));
    }
    __syncthreads();
    if (tid < 32) {
      // Lane l holds digits 255 - 8l .. 248 - 8l; the lane whose digits
      // hold the need-th member finds it.
      int c[8], sum = 0;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        c[e] = hist[255 - 8 * tid - e];
        sum += c[e];
      }
      int incl = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += y;
      }
      if (incl - sum < need && incl >= need) {
        int acc = incl - sum, digit = -1, rest = 0;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          if (digit < 0) {
            if (acc + c[e] >= need) {
              digit = 255 - 8 * tid - e;
              rest = need - acc;
            } else {
              acc += c[e];
            }
          }
        }
        *s_prefix = prefix | (static_cast<uint32_t>(digit) << shift);
        *s_need = rest;
      }
    }
    __syncthreads();
    prefix = *s_prefix;
    need = *s_need;
    mask |= 255u << shift;
  }
  *T = prefix;
  *need_eq = need;
}

// Ordered compaction of the members (get) that rank within the need best:
// the n_gt members above T go to out[0, n_gt) and the first need_eq members
// equal to T to out[n_gt, n_gt + need_eq), each group in index order. Both
// counts ride one scan, packed in 16-bit halves (at most 1024 a step).
template <typename Get, typename Key>
__device__ void compact_selected(Get get, Key key_of, int n, uint32_t T, int n_gt, int need_eq,
                                 uint64_t* out, int* warp_sums) {
  int gt_base = 0, eq_base = 0;
  for (int base = 0; base < n; base += SELECT_THREADS) {
    const int i = base + threadIdx.x;
    uint32_t u = 0;
    int is_gt = 0, is_eq = 0;
    if (i < n && get(i, &u)) {
      is_gt = u > T;
      is_eq = u == T;
    }
    int total;
    const int excl = block_exclusive_scan(is_gt | (is_eq << 16), warp_sums, &total);
    if (is_gt) out[gt_base + (excl & 0xffff)] = key_of(i);
    const int eq_rank = eq_base + (excl >> 16);
    if (is_eq && eq_rank < need_eq) out[n_gt + eq_rank] = key_of(i);
    gt_base += total & 0xffff;
    eq_base += total >> 16;
  }
}

// Stable LSD radix sort of keys a[0, n) by their upper 32 bits, 8 bits a
// pass, with b[0, n) as the second buffer; returns the buffer that holds the
// result. A digit that is the same in every key takes no pass. Warp w ranks
// items [w * 32 * ipt, (w + 1) * 32 * ipt), item i * 32 + lane of them at
// step i; counts holds [256 digits][COUNT_LD] ints, warp w's at column w.
__device__ uint64_t* radix_sort(uint64_t* a, uint64_t* b, int n, int* counts, int* warp_sums,
                                uint32_t* s_bits) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ipt = (n + SELECT_THREADS - 1) / SELECT_THREADS;
  const int first = warp * 32 * ipt + lane;
  const unsigned lower = (1u << lane) - 1u;
  // The value bits that differ between keys: OR ^ AND over all of them.
  uint32_t any = 0, all = 0xffffffffu;
  for (int i = tid; i < n; i += SELECT_THREADS) {
    const uint32_t v = static_cast<uint32_t>(a[i] >> 32);
    any |= v;
    all &= v;
  }
  any = __reduce_or_sync(0xffffffffu, any);
  all = __reduce_and_sync(0xffffffffu, all);
  if (tid == 0) {
    s_bits[0] = 0;
    s_bits[1] = 0xffffffffu;
  }
  __syncthreads();
  if (lane == 0) {
    atomicOr(&s_bits[0], any);
    atomicAnd(&s_bits[1], all);
  }
  __syncthreads();
  const uint32_t varying = s_bits[0] ^ s_bits[1];
  for (int shift = 32; shift < 64; shift += 8) {
    if (((varying >> (shift - 32)) & 255u) == 0) continue;  // the pass would not move a key
    for (int i = tid; i < COUNTS; i += SELECT_THREADS) counts[i] = 0;
    __syncthreads();
    int rank[MAX_IPT];
#pragma unroll
    for (int s = 0; s < MAX_IPT; ++s) {
      if (s < ipt) {
        const int idx = first + 32 * s;
        const int dig = idx < n ? static_cast<int>((a[idx] >> shift) & 255u) : -1;
        const unsigned peers = __match_any_sync(0xffffffffu, dig);
        int before = 0;
        if (dig >= 0) before = counts[dig * COUNT_LD + warp];
        rank[s] = before + __popc(peers & lower);
        __syncwarp();
        if (dig >= 0 && (peers & lower) == 0)
          counts[dig * COUNT_LD + warp] = before + __popc(peers);
        __syncwarp();
      }
    }
    __syncthreads();
    // Offsets in (digit, warp) order: thread t holds the 8 counts of digit
    // t / 4, warps 8 (t % 4) .. + 7.
    int* mine = counts + (tid >> 2) * COUNT_LD + 8 * (tid & 3);
    int c[8], sum = 0;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      c[e] = mine[e];
      sum += c[e];
    }
    int total;
    int run = block_exclusive_scan(sum, warp_sums, &total);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      mine[e] = run;
      run += c[e];
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < MAX_IPT; ++s) {
      if (s < ipt) {
        const int idx = first + 32 * s;
        if (idx < n) {
          const uint64_t key = a[idx];
          b[counts[static_cast<int>((key >> shift) & 255u) * COUNT_LD + warp] + rank[s]] = key;
        }
      }
    }
    __syncthreads();
    uint64_t* t = a;
    a = b;
    b = t;
  }
  return a;
}

// One block a query: the k largest of scores[b, :live] in rank order (value
// descending, row ascending) into out_v/out_i [B, k]; slots past live are
// -inf and -1. stats as score_kernel leaves them. Dynamic shared memory:
// (keys_cap + tmp_cap) * 8 + COUNTS * 4 bytes.
__global__ void __launch_bounds__(SELECT_THREADS)
    select_kernel(const float* __restrict__ scores, int ld, const uint32_t* __restrict__ stats,
                  int B, int live, int k, int keys_cap, int tmp_cap, float* __restrict__ out_v,
                  int* __restrict__ out_i) {
  extern __shared__ uint64_t select_smem[];
  uint64_t* keys = select_smem;        // the selected keys
  uint64_t* tmp = keys + keys_cap;     // candidates, then the sort's second buffer
  int* counts = reinterpret_cast<int*>(tmp + tmp_cap);  // histogram, then digit counts
  __shared__ int warp_sums[33];
  __shared__ int s_bstar, s_above, s_cand, s_rest;
  __shared__ uint32_t s_prefix, s_bits[2];
  const int tid = threadIdx.x;
  const int query = blockIdx.x;
  const float* row = scores + static_cast<int64_t>(query) * ld;
  const int n_out = min(k, live);
  auto key_at = [row](int i) { return make_key(row[i], i); };

  if (live <= k) {
    // Every live row is taken.
    for (int i = tid; i < live; i += SELECT_THREADS) keys[i] = key_at(i);
    __syncthreads();
  } else {
    const float mx = from_ordered(stats[query]), mn = from_ordered(stats[B + query]);
    const float scale = mx > mn ? __fdiv_rn(static_cast<float>(NB), __fsub_rn(mx, mn)) : 0.f;
    int* hist = counts;

    // (a) The histogram: one read of the row.
    for (int i = tid; i < NB; i += SELECT_THREADS) hist[i] = 0;
    __syncthreads();
    for (int base = 0; base < live; base += STEP) {
      const int i0 = base + tid * PER_THREAD;
      if (i0 < live) {
        float v[PER_THREAD];
        load_scores(row + i0, v);
#pragma unroll
        for (int e = 0; e < PER_THREAD; ++e)
          if (i0 + e < live) atomicAdd(&hist[bin_of(v[e], mn, scale)], 1);
      }
    }
    __syncthreads();
    // b*: thread t holds bins NB-1-4t .. NB-4-4t, the highest first.
    int c[4], sum = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      c[e] = hist[NB - 1 - 4 * tid - e];
      sum += c[e];
    }
    int total;
    const int higher = block_exclusive_scan(sum, warp_sums, &total);
    if (higher < k && higher + sum >= k) {
      int acc = higher, found = -1;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (found < 0) {
          if (acc + c[e] >= k) {
            found = e;
            s_bstar = NB - 1 - 4 * tid - e;
            s_above = acc;
            s_cand = c[e];
          } else {
            acc += c[e];
          }
        }
      }
    }
    __syncthreads();
    const int bstar = s_bstar, above = s_above, n_cand = s_cand;
    const int need = k - above;  // rows of b* that the result takes
    const bool fits = n_cand <= tmp_cap;

    // (b) The compaction: the second read. Rows above b* to keys, rows in
    // b* to the candidates (when they fit), each in row order.
    int above_base = 0, cand_base = 0;
    for (int base = 0; base < live; base += STEP) {
      const int i0 = base + tid * PER_THREAD;
      float v[PER_THREAD];
      int n_a = 0, n_c = 0;
      if (i0 < live) load_scores(row + i0, v);
#pragma unroll
      for (int e = 0; e < PER_THREAD; ++e) {
        const int bin = i0 + e < live ? bin_of(v[e], mn, scale) : -1;
        n_a += bin > bstar;
        n_c += fits && bin == bstar;
      }
      const int excl = block_exclusive_scan(n_a | (n_c << 16), warp_sums, &total);
      int pa = above_base + (excl & 0xffff), pc = cand_base + (excl >> 16);
#pragma unroll
      for (int e = 0; e < PER_THREAD; ++e) {
        const int bin = i0 + e < live ? bin_of(v[e], mn, scale) : -1;
        if (bin > bstar) {
          keys[pa++] = make_key(v[e], i0 + e);
        } else if (fits && bin == bstar) {
          tmp[pc++] = make_key(v[e], i0 + e);
        }
      }
      above_base += total & 0xffff;
      cand_base += total >> 16;
    }
    __syncthreads();

    uint32_t T;
    int need_eq;
    if (fits) {
      // The best `need` of the candidates, from shared memory alone.
      auto get = [tmp](int i, uint32_t* u) {
        *u = key_value(tmp[i]);
        return true;
      };
      radix_select(get, n_cand, need, counts, &s_prefix, &s_rest, &T, &need_eq);
      compact_selected(get, [tmp](int i) { return tmp[i]; }, n_cand, T, need - need_eq,
                       need_eq, keys + above, warp_sums);
    } else {
      // (c) Too many candidates: select among b*'s rows in the row itself.
      auto get = [row, mn, scale, bstar](int i, uint32_t* u) {
        const float v = row[i];
        *u = ordered(v);
        return bin_of(v, mn, scale) == bstar;
      };
      radix_select(get, live, need, counts, &s_prefix, &s_rest, &T, &need_eq);
      compact_selected(get, key_at, live, T, need - need_eq, need_eq, keys + above, warp_sums);
    }
    __syncthreads();
  }

  // (d) Rank order, then the row's output.
  const uint64_t* sorted = radix_sort(keys, tmp, n_out, counts, warp_sums, s_bits);
  float* ov = out_v + static_cast<int64_t>(query) * k;
  int* oi = out_i + static_cast<int64_t>(query) * k;
  for (int j = tid; j < k; j += SELECT_THREADS) {
    if (j < n_out) {
      const uint64_t key = sorted[j];
      ov[j] = from_ordered(key_value(key));
      oi[j] = static_cast<int>(key & 0xffffffffu);
    } else {
      ov[j] = -pos_inf();
      oi[j] = -1;
    }
  }
}

// ---- host side ------------------------------------------------------------

struct SelectShape {
  int keys_cap, tmp_cap;
  size_t smem;
};

SelectShape select_shape(int live, int k) {
  const int n_out = live < k ? live : k;
  const int ipt = n_out > 0 ? (n_out + SELECT_THREADS - 1) / SELECT_THREADS : 1;
  SelectShape s;
  s.keys_cap = ipt * SELECT_THREADS;
  s.tmp_cap = s.keys_cap > CAND_MIN ? s.keys_cap : CAND_MIN;
  s.smem = static_cast<size_t>(s.keys_cap + s.tmp_cap) * 8 + COUNTS * 4;
  return s;
}

template <typename T>
cudaError_t launch_scores(CUtensorMapDataType type, const void* emb, const void* q, int B,
                          int D, int live, float* scores, int ld, uint32_t* stats,
                          cudaStream_t s) {
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // About one block an SM: the query tiles times corpus chunks of whole
  // row tiles.
  const int n_qtiles = (B + BQ - 1) / BQ;
  const int n_tiles = (live + BN - 1) / BN;
  int n_chunks = n_sm / n_qtiles;
  if (n_chunks > n_tiles) n_chunks = n_tiles;
  if (n_chunks < 1) n_chunks = 1;
  const int chunk_rows = (n_tiles + n_chunks - 1) / n_chunks * BN;
  n_chunks = (live + chunk_rows - 1) / chunk_rows;
  int stages = static_cast<int>((SMEM_LIMIT - score_smem(0)) / ((BQ + BN) * BOX_BYTES + 16));
  const size_t smem = score_smem(stages);

  CUtensorMap tm_q, tm_e;
  err = encode(&tm_q, type, sizeof(T), q, B, D, BQ);
  if (err != cudaSuccess) return err;
  err = encode(&tm_e, type, sizeof(T), emb, live, D, BN);
  if (err != cudaSuccess) return err;
  auto kernel = score_kernel<T>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(n_qtiles, n_chunks);
  kernel<<<grid, SCORE_THREADS, smem, s>>>(tm_q, tm_e, B, D, live, stages, chunk_rows, scores,
                                           ld, stats);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The score pass alone: scores [B, ld] f32 (ld % 32 == 0, ld >= live) and
// stats [2, B] u32 (the per-query ordered max, then min) from emb [cap, D]
// and q [B, D] in one dtype (0 bf16, 1 fp16, 2 f32), 16-byte aligned,
// D % 8 == 0, live <= cap.
int rag_cosine_topk_large_scores(const void* emb, const void* q, int B, int D, int live,
                                 int dtype, void* scores, int ld, void* stats, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || D % 8 != 0 || live < 0 || ld % 32 != 0 || ld < live) return cudaErrorInvalidValue;
  if (live == 0) return cudaSuccess;
  uint32_t* st = static_cast<uint32_t*>(stats);
  cudaError_t err = cudaMemsetAsync(st, 0, sizeof(uint32_t) * B, s);  // max: below every value
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(st + B, 0xff, sizeof(uint32_t) * B, s);  // min: above every value
  if (err != cudaSuccess) return err;
  float* sc = static_cast<float*>(scores);
  switch (dtype) {
    case 0:
      return launch_scores<__nv_bfloat16>(CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, emb, q, B, D, live,
                                          sc, ld, st, s);
    case 1:
      return launch_scores<__half>(CU_TENSOR_MAP_DATA_TYPE_FLOAT16, emb, q, B, D, live, sc, ld,
                                   st, s);
    case 2:
      return launch_scores<float>(CU_TENSOR_MAP_DATA_TYPE_FLOAT32, emb, q, B, D, live, sc, ld,
                                  st, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The select alone, over what the score pass left: out_v/out_i [B, k].
int rag_cosine_topk_large_select(const void* scores, int ld, const void* stats, int B, int live,
                                 int k, void* out_v, void* out_i, void* stream) {
  if (B < 1 || k < 1 || k > LARGE_MAX_K || live < 0 || ld % 32 != 0 || ld < live)
    return cudaErrorInvalidValue;
  const SelectShape shape = select_shape(live, k);
  cudaError_t err = cudaFuncSetAttribute(select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(shape.smem));
  if (err != cudaSuccess) return err;
  select_kernel<<<B, SELECT_THREADS, shape.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scores), ld, static_cast<const uint32_t*>(stats), B, live, k,
      shape.keys_cap, shape.tmp_cap, static_cast<float*>(out_v), static_cast<int*>(out_i));
  return cudaGetLastError();
}

// Both passes: emb [cap, D] and q [B, D] row-major in one dtype (0 bf16,
// 1 fp16, 2 f32), 16-byte aligned, D % 8 == 0; rows >= live are ignored.
// scores is a [B, ld] f32 scratch (ld % 32 == 0, ld >= live), stats a [2, B]
// u32 scratch; out_v/out_i [B, k]. Requires B >= 1 and 1 <= k <= 8192.
int rag_cosine_topk_large(const void* emb, const void* q, int B, int D, int live, int k,
                          int dtype, void* scores, int ld, void* stats, void* out_v, void* out_i,
                          void* stream) {
  if (k < 1 || k > LARGE_MAX_K) return cudaErrorInvalidValue;
  const int err = rag_cosine_topk_large_scores(emb, q, B, D, live, dtype, scores, ld, stats,
                                               stream);
  if (err != cudaSuccess) return err;
  return rag_cosine_topk_large_select(scores, ld, stats, B, live, k, out_v, out_i, stream);
}

}  // extern "C"
