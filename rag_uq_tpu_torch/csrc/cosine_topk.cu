// Exact cosine top-k over a corpus matrix, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel rag_uq_tpu/ops/pallas_topk.py::
// pallas_cosine_topk (body _kernel): for every query, the k corpus rows with
// the largest q . e, products of operands in the corpus dtype (bf16, fp16 or
// f32) summed in f32, rows at or past `size` masked, ties to the lowest row
// index, and -1 where the value is -inf. The [B, cap] score matrix never
// reaches device memory.
//
// Bound at the main path's shape (B = 2048 queries, 100000 live rows of a
// 131072-row index, D = 768, k = 50, bf16) on an H100 SXM: 2*2048*100000*768
// = 3.1e11 flop at 989 TFLOP/s is 0.318 ms; the live corpus is 154 MB, 0.046
// ms at 3.35 TB/s. The work is bound by operations.
//
// What bound the earlier design (5.02 ms on an H100 80GB HBM3 at 700 W):
//   1. 64 x 64 score tiles: each block re-streamed its query tile for every
//      64-row corpus tile, about 9.9 GB from L2 into shared memory a launch.
//   2. mma.sync fed by 32-bit shared loads behind a 2-stage cp.async
//      pipeline with two block barriers per 64-column step.
//   3. The top-k upkeep ran behind the products under block barriers (a
//      warp's score quadrant spanned queries other warps inserted), one
//      candidate at a time.
// What this design does about each:
//   1. 128 x 128 score tiles (two consumer warpgroups of 64 queries against
//      one 128-row corpus tile; 64 queries above k = 121, where the lists
//      take the room). L2 -> shared traffic (B/BQ)*live*D*2 + (live/BN)*B*D*2
//      is about 4.9 GB at the main shape instead of 9.9 GB.
//   2. TMA (2D tensor maps, 128B swizzle, 128-byte-wide boxes) into a ring
//      of 2-6 stages guarded by mbarriers, filled by one producer thread
//      (its warpgroup gives registers to the consumers with setmaxnreg);
//      the consumers multiply with wgmma m64n128k16 (bf16 or fp16, f32
//      accumulation) straight from the swizzled shared tiles, one batch in
//      flight while the next is issued. No block barrier after set-up.
//   3. In a wgmma fragment warp w of a warpgroup holds query rows
//      16w..16w+15 for all 128 columns, so the warp that filters a query's
//      scores also keeps its list, with __syncwarp only and no block
//      barrier. Each thread tests its 64 scores against its two queries'
//      k-th values, held in registers. A query's list is an 8-ary heap in
//      shared memory owned by one lane, which keeps its root (the k-th
//      value) in registers, so the warp's 16 queries take their survivors
//      in parallel: the quad that holds a query's scores queues them, the
//      owner offers them to its heap, and a sift-down is two levels at
//      k = 50. Measured on the card, the upkeep is bound by dependent
//      shared-memory round trips, which wait behind the products' and the
//      ring's traffic; a binary heap (about six levels) and sorted lists
//      shifted by the warp were slower (PERF.md).
// An f32 corpus takes a plain f32 FMA product core (CUDA cores, no TF32)
// reading the same swizzled tiles, with the same thread-to-score layout as
// the wgmma fragment, so the ring, the upkeep and the merge are shared.
//
// The small-batch regime: the served micro-batches (B = 1-256 over 20,000
// live D = 768 rows), the evaluation chunks (B = 72, 128 over 5,000 D = 256
// rows), the training, parity and shard shapes (B = 512-2048 over 1,696-
// 10,240 rows). There the work is bound by bytes: at B <= 256 over 20,000
// rows the live corpus is 30.7 MB, 0.0092 ms at 3.35 TB/s, while the
// products are at most 0.008 ms at 989 TFLOP/s. What held the earlier plan
// back there (1.17-1.30 ms a launch at B = 1-256 over 20,000 rows on an
// H100 80GB HBM3 at 700 W, 6-10x torch.matmul + torch.topk):
//   1. The merge: one warp per query, each candidate placed by a binary
//      search in every other chunk's sorted list from device memory, 53 x
//      50 candidates a query; at B = 1 one warp on the whole card.
//   2. The plan: a query tile of 128 whatever the batch, and up to 64
//      chunks for one or two query tiles; query rows past B still kept
//      lists, and all-zero rows tie at every score.
//   3. Per launch: the chunk pass sorted every list for the merge's binary
//      searches; the first tile sifted its 128 - k scores past the bulk one
//      by one; the host set the kernel's shared-memory limit every launch.
// What this design does about each:
//   1. merge_kernel takes a query a block and does not need sorted lists:
//      the candidates become order-preserving 64-bit keys in shared memory
//      (16-byte loads), a radix select by bytes finds the k-th key, and the
//      k keys at or above it are ranked by counting. It only selects, so it
//      equals the rank-rule merge of the same lists bit for bit.
//   2. The plan (ops/cosine_topk.py::plan) takes the batch: a query tile of
//      64 (one consumer warpgroup) where B <= 64; about one block per SM;
//      chunks of at least 2k rows, so a query's candidates are at most half
//      the live rows, and at most MAX_CANDIDATES of them. A warp whose
//      query rows all lie past B skips the upkeep and the write; a dead row
//      of a live warp has a root of +inf and marks nothing.
//   3. The lists are written in heap order (no sort). The first tile finds,
//      for each row, a cut with exactly k of its scores at or above it by a
//      bitwise search over order-preserving keys, counted across the quad
//      and stopped once every row of the warp has one; those k are stored
//      and made a heap, and no score is marked. A row whose ties straddle
//      its k-th score is taken in bulk as before (its first k scores stored,
//      the rest marked and offered in rounds). The limit is set once per
//      device and template instance.
// The later tiles' upkeep (the filter, the queues, the 8-ary heap) is the
// main shape's design above: at B = 2048 it is what wins, and at small B it
// is now the largest phase (cli/profile_cosine_topk.py).
//
// Work split. The TPU kernel walks the corpus in order on one core and
// carries a running top-k from block to block. Here blocks run in parallel:
//   1. chunk_topk_kernel, grid (query tiles, corpus chunks), query tile
//      fastest so the tiles that read one chunk share it through L2; about
//      one block per SM. Each block writes its k best per query, in heap
//      order, to a [B, n_chunks, k] scratch.
//   2. merge_kernel, one block of 256 threads per query, as above; the
//      positions below min(k, finite candidates) are written, the rest of
//      the row is dead.
//
// Shared memory of a chunk block (bytes), with BQ queries a block, BN = 128
// rows a corpus tile, S stages and 128-byte-wide boxes:
//   1024 (alignment of the swizzled tiles)
//   + S * (BQ + BN) * 128                  stages (query box, corpus box)
//   + BQ * (k | 1) * 8                     running lists (f32 value, i32 row)
//   + (BQ / 16) * 128 * 8                  a scratch of 128 candidates a warp
//   + S * 16                               full and empty mbarriers
// It must fit in 232448. ops/cosine_topk.py::kernel_config computes the
// same formula: BQ = 64 where B <= 64; else BQ = 128 where three stages fit
// beside the lists (k <= 121), else BQ = 64 (k <= 256 fits with three
// stages); S = as many as fit, at most 6. A merge block takes n_chunks * k *
// 8 bytes of keys (at most MAX_CANDIDATES * 8 = 131072) and 3088 static.
//
// Interface: plain C, launched on the caller's stream, returns
// cudaGetLastError() (or the error of the tensor-map encoding). The tensor
// maps are encoded at every launch: the corpus pointer moves when the index
// grows. No PyTorch header is included. cuTensorMapEncodeTiled lives in
// libcuda; it is looked up at run time through the CUDA runtime's
// entry-point query, so nothing links libcuda.

#include <atomic>
#include <climits>
#include <cstdint>

#include "hopper_tile.cuh"

namespace {

constexpr int BN = 128;         // corpus rows a tile
constexpr int MAX_STAGES = 6;
constexpr int MAX_K = 256;
constexpr int SCRATCH = 128;  // candidates in a warp's scratch
constexpr int QUEUE = SCRATCH / 16;  // of which each of its 16 queries' queue
constexpr size_t SMEM_LIMIT = 232448;
constexpr int MAX_CANDIDATES = 16384;  // n_chunks * k a query the merge stages
constexpr int MERGE_THREADS = 256;

__host__ __device__ constexpr size_t smem_bytes(int bq, int k, int stages) {
  return 1024 + static_cast<size_t>(stages) * (bq + BN) * BOX_BYTES +
         static_cast<size_t>(bq) * (k | 1) * 8 + static_cast<size_t>(bq / 16) * SCRATCH * 8 +
         static_cast<size_t>(stages) * 16;
}

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }
__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

// Order-preserving map of an f32 to a u32 (larger value, larger key; -0
// below +0), and its inverse.
__device__ __forceinline__ uint32_t ordered(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float from_ordered(uint32_t o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

// Profiling builds (-DCOSINE_TOPK_PROFILE, cli/profile_cosine_topk.py) sum
// the clock64 cycles each consumer warp spends in four phases: the products
// with their waits on the ring, the first tile's upkeep, the other tiles'
// upkeep, and the final sort and write; slot 4 counts the warps.
#ifdef COSINE_TOPK_PROFILE
__device__ unsigned long long g_profile[5];
#define PROFILE_NOW(t) const long long t = clock64()
#define PROFILE_ADD(slot, t0) prof[slot] += clock64() - (t0)
#else
#define PROFILE_NOW(t)
#define PROFILE_ADD(slot, t0)
#endif

// ---- the running lists ---------------------------------------------------

// (v, i) ranks before (x, r): value descending, then row ascending.
__device__ __forceinline__ bool before(float v, int i, float x, int r) {
  return v > x || (v == x && i < r);
}

// A list entry: a score and its corpus row.
struct Entry {
  float v;
  int i;
};

// A query's running top-k is an 8-ary heap of k entries in shared memory
// whose root ranks last (the current k-th best); empty slots hold
// (-inf, INT_MAX), which ranks after every row. Eight children a node keep
// the heap two levels deep at k = 50, so a sift-down waits on few
// shared-memory round trips; its eight child loads go out together.
constexpr int ARY = 8;

// Put (x, r) at slot i of the heap h[0, n) and sift it down: the child that
// ranks last moves up while it ranks after (x, r). Returns the entry that
// ends at slot i.
__device__ __forceinline__ Entry heap_sift(Entry* h, int n, int i, float x, int r) {
  Entry top{x, r};
  bool moved = false;
  for (;;) {
    const int c0 = ARY * i + 1;
    if (c0 >= n) break;
    Entry w = h[c0];
    int wi = c0;
#pragma unroll
    for (int t = 1; t < ARY; ++t) {
      if (c0 + t < n) {
        const Entry e = h[c0 + t];
        if (before(w.v, w.i, e.v, e.i)) {
          w = e;
          wi = c0 + t;
        }
      }
    }
    if (!before(x, r, w.v, w.i)) break;
    if (!moved) top = w;
    moved = true;
    h[i] = w;
    i = wi;
  }
  h[i] = Entry{x, r};
  return top;
}

// Make k entries in any order a heap (bottom-up, linear time).
__device__ __forceinline__ void heap_build(Entry* h, int k) {
  for (int i = (k - 2) / ARY; i >= 0; --i) heap_sift(h, k, i, h[i].v, h[i].i);
}

// ---- the products ---------------------------------------------------------

// An f32 corpus: a plain f32 FMA loop in which each thread computes the same
// 64 scores that a wgmma fragment would hand it, so the upkeep is shared.
template <>
struct Product<float> {
  static constexpr int COLS = BOX_BYTES / sizeof(float);  // 32

  __device__ static void stage(float (&d)[64], const float* sq, const float* se, bool first,
                               int wtid) {
    const int lane = wtid & 31;
    const int r0 = (wtid >> 5) * 16 + (lane >> 2);
    const int c0 = (lane & 3) * 2;
    if (first) {
#pragma unroll
      for (int i = 0; i < 64; ++i) d[i] = 0.f;
    }
#pragma unroll 1
    for (int chunk = 0; chunk < COLS / 4; ++chunk) {
      const float4 qa = sw128_f32x4(sq, r0, chunk);
      const float4 qb = sw128_f32x4(sq, r0 + 8, chunk);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const float4 e = sw128_f32x4(se, j * 8 + c0 + b, chunk);
          float& ya = d[4 * j + b];
          float& yb = d[4 * j + 2 + b];
          ya = fmaf(qa.x, e.x, ya);
          ya = fmaf(qa.y, e.y, ya);
          ya = fmaf(qa.z, e.z, ya);
          ya = fmaf(qa.w, e.w, ya);
          yb = fmaf(qb.x, e.x, yb);
          yb = fmaf(qb.y, e.y, yb);
          yb = fmaf(qb.z, e.z, yb);
          yb = fmaf(qb.w, e.w, yb);
        }
      }
    }
  }
  __device__ static void retire_all() {}
  __device__ static void retire_but_last() {}
};

// ---- the chunk kernel -----------------------------------------------------

// Threads: NWG consumer warpgroups, then one producer warpgroup whose first
// thread issues every TMA load.
template <typename T, int NWG>
__global__ void __launch_bounds__((NWG + 1) * 128, 1)
chunk_topk_kernel(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_e, int B, int D, int size, int k,
                  int stages, int chunk_rows, float* __restrict__ part_v,
                  int* __restrict__ part_i) {
  constexpr int BQ = 64 * NWG;
  constexpr int COLS = Product<T>::COLS;
  constexpr uint32_t STAGE_BYTES = (BQ + BN) * BOX_BYTES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* ring = smem;  // stage s: [BQ rows][128 B] then [BN rows][128 B]
  const int ks = k | 1;  // list stride: odd, so 16 lanes at one slot hit 16 banks
  Entry* sL = reinterpret_cast<Entry*>(ring + static_cast<size_t>(stages) * STAGE_BYTES);
  unsigned char* scratch = reinterpret_cast<unsigned char*>(sL + BQ * ks);
  uint64_t* bars = reinterpret_cast<uint64_t*>(scratch + (BQ / 16) * SCRATCH * 8);
  // bars[s]: stage s is full; bars[stages + s]: stage s is free.

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int chunk = blockIdx.y, n_chunks = gridDim.y;
  const int r_begin = chunk * chunk_rows;
  const int r_end = min(r_begin + chunk_rows, size);
  const int n_tiles = r_end > r_begin ? (r_end - r_begin + BN - 1) / BN : 0;
  const int n_k = (D + COLS - 1) / COLS;
  const int total = n_tiles * n_k;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(smem_u32(&bars[s]), 1);
      mbar_init(smem_u32(&bars[stages + s]), 4 * NWG);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= NWG * 128) {
    // ---- producer ----
    if constexpr (NWG == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == NWG * 128) {
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
  if constexpr (NWG == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = tid >> 7, wtid = tid & 127;
  const int lane = tid & 31, warp = tid >> 5;  // warp: 0 .. 4 * NWG - 1
  const int qw = warp * 16;                    // the warp's first query row in the block
  Entry* wL = sL + qw * ks;  // the warp's 16 lists
  Entry* cQ = reinterpret_cast<Entry*>(scratch) + warp * SCRATCH;  // its queues

  for (int i = lane; i < 16 * ks; i += 32) wL[i] = Entry{neg_inf(), INT_MAX};
  __syncwarp();
  const int ra = lane >> 2;  // the lane's two rows in the warp: ra, ra + 8
  const int sub = lane & 3;
  // Lane 4ra + h (sub < 2) owns the heap of row ra + 8h and keeps its root.
  Entry* own = wL + (ra + 8 * (sub & 1)) * ks;
  // Query rows at or past B (a batch smaller than the tile) keep no list. A
  // warp with none live skips the upkeep and the write; a dead row of a live
  // warp builds no heap, and its root of +inf marks none of its scores.
  Entry root{q0 + qw + ra + 8 * (sub & 1) < B ? neg_inf() : pos_inf(), INT_MAX};
  float thr[2] = {neg_inf(), neg_inf()};

  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
#ifdef COSINE_TOPK_PROFILE
  unsigned long long prof[4] = {0, 0, 0, 0};
#endif

  int stage = 0, prev = 0;
  uint32_t phase = 0;
  for (int tile = 0; tile < n_tiles; ++tile) {
    PROFILE_NOW(t_products);
    for (int kb = 0; kb < n_k; ++kb) {
      mbar_wait(smem_u32(&bars[stage]), phase);
      const unsigned char* base = ring + static_cast<size_t>(stage) * STAGE_BYTES;
      const T* sq = reinterpret_cast<const T*>(base + wg * 64 * BOX_BYTES);
      const T* se = reinterpret_cast<const T*>(base + BQ * BOX_BYTES);
      fence_acc(d);
      Product<T>::stage(d, sq, se, kb == 0, wtid);
      fence_acc(d);
      // Keep this stage's products in flight; the previous stage's are done.
      if (kb > 0) {
        Product<T>::retire_but_last();
        __syncwarp();
        if (lane == 0) mbar_arrive(smem_u32(&bars[stages + prev]));
      }
      prev = stage;
      if (++stage == stages) {
        stage = 0;
        phase ^= 1;
      }
    }
    Product<T>::retire_all();
    fence_acc(d);
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(&bars[stages + prev]));
    PROFILE_ADD(0, t_products);
    if (q0 + qw >= B) continue;
    PROFILE_NOW(t_upkeep);

    // ---- upkeep: the warp's 16 queries against this tile's 128 rows ----
    // d[4j + 2h + b] is query row ra + 8h of the warp and corpus row
    // row0 + 8j + b; bit 2j + b of pend[h] marks it as a candidate.
    const int row0 = r_begin + tile * BN + sub * 2;
    unsigned pend[2] = {0u, 0u};
    if (tile == 0) {
      // Every score is a candidate. A bitwise search over order-preserving
      // keys, counted across the quad, finds for each row a cut with
      // exactly k of its scores at or above it (rows past B need none);
      // those k are the row's heap, and no score is marked. A row whose
      // ties straddle its k-th score gets no such cut: it is taken in bulk,
      // the quad's lanes storing its first k scores (column order) in the
      // heap's slots and marking the rest. Then the owner makes its slots a
      // heap bottom-up.
      const int n_valid = min(BN, r_end - r_begin);
      if (n_valid < BN) {  // a short chunk: its missing rows never reach a cut
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int b = 0; b < 2; ++b)
            if (row0 + 8 * j + b >= r_end) d[4 * j + b] = d[4 * j + 2 + b] = neg_inf();
      }
      bool cut[2] = {q0 + qw + ra >= B, q0 + qw + ra + 8 >= B};  // a cut found (or not needed)
      uint32_t key[2] = {0u, 0u};
      if (n_valid > k) {
        for (int bit = 31; bit >= 0 && !__all_sync(0xffffffffu, cut[0] && cut[1]); --bit) {
          float t[2];
          int n[2] = {0, 0};
#pragma unroll
          for (int h = 0; h < 2; ++h) t[h] = from_ordered(key[h] | (1u << bit));
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int j = i >> 1, b = i & 1;
            n[0] += d[4 * j + b] >= t[0];
            n[1] += d[4 * j + 2 + b] >= t[1];
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            n[h] += __shfl_xor_sync(0xffffffffu, n[h], 1);
            n[h] += __shfl_xor_sync(0xffffffffu, n[h], 2);
            if (!cut[h] && n[h] >= k) {
              key[h] |= 1u << bit;
              cut[h] = n[h] == k;
            }
          }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        Entry* hl = wL + (ra + 8 * h) * ks;
        const bool live = q0 + qw + ra + 8 * h < B;
        const bool by_cut = n_valid > k && cut[h];
        const float t = from_ordered(key[h]);
        unsigned take = 0u;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const bool in = by_cut && live && d[4 * (i >> 1) + 2 * h + (i & 1)] >= t;
          take |= static_cast<unsigned>(in) << i;
        }
        const int c = __popc(take);
        const int c1 = __shfl_up_sync(0xffffffffu, c, 1, 4);
        const int c2 = __shfl_up_sync(0xffffffffu, c, 2, 4);
        const int c3 = __shfl_up_sync(0xffffffffu, c, 3, 4);
        int slot = (sub > 0 ? c1 : 0) + (sub > 1 ? c2 : 0) + (sub > 2 ? c3 : 0);
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            const int row = row0 + 8 * j + b;
            if (by_cut) {
              if (take & (1u << (2 * j + b))) hl[slot++] = Entry{d[4 * j + 2 * h + b], row};
            } else if (live) {
              const int bulk = 32 * sub + 2 * j + b;
              const bool ok = row < r_end;
              if (bulk < k) {
                hl[bulk] = ok ? Entry{d[4 * j + 2 * h + b], row} : Entry{neg_inf(), INT_MAX};
              } else if (ok) {
                pend[h] |= 1u << (2 * j + b);
              }
            }
          }
      }
      __syncwarp();
      if (sub < 2 && root.v != pos_inf()) {
        heap_build(own, k);
        root = own[0];
      }
      thr[0] = __shfl_sync(0xffffffffu, root.v, lane & ~3);
      thr[1] = __shfl_sync(0xffffffffu, root.v, (lane & ~3) | 1);
    } else {
      // Once the heaps are warm few scores reach the k-th values.
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const bool ok = row0 + 8 * j + b < r_end;
          pend[0] |= static_cast<unsigned>(ok && d[4 * j + b] >= thr[0]) << (2 * j + b);
          pend[1] |= static_cast<unsigned>(ok && d[4 * j + 2 + b] >= thr[1]) << (2 * j + b);
        }
    }
    // In rounds: the quad's lanes move up to QUEUE marked scores per row
    // into the row's queue, the owner offers them to its heap, and marks
    // left over are tested again against the raised k-th values.
    bool retest = tile == 0;  // the first tile's marks predate its heaps
    for (;;) {
      if (retest) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            const unsigned bit = 1u << (2 * j + b);
            if (d[4 * j + b] < thr[0]) pend[0] &= ~bit;
            if (d[4 * j + 2 + b] < thr[1]) pend[1] &= ~bit;
          }
      }
      if (!__any_sync(0xffffffffu, (pend[0] | pend[1]) != 0u)) break;
      int slot[2], total[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = __popc(pend[h]);
        const int c1 = __shfl_up_sync(0xffffffffu, c, 1, 4);
        const int c2 = __shfl_up_sync(0xffffffffu, c, 2, 4);
        const int c3 = __shfl_up_sync(0xffffffffu, c, 3, 4);
        slot[h] = (sub > 0 ? c1 : 0) + (sub > 1 ? c2 : 0) + (sub > 2 ? c3 : 0);
        total[h] = c + __shfl_xor_sync(0xffffffffu, c, 1);
        total[h] += __shfl_xor_sync(0xffffffffu, total[h], 2);
      }
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            const unsigned bit = 1u << (2 * j + b);
            if ((pend[h] & bit) && slot[h] < QUEUE) {
              cQ[(ra + 8 * h) * QUEUE + slot[h]] = Entry{d[4 * j + 2 * h + b], row0 + 8 * j + b};
              ++slot[h];
              pend[h] &= ~bit;
            }
          }
      __syncwarp();
      if (sub < 2) {
        const Entry* q = cQ + (ra + 8 * sub) * QUEUE;
        const int n = min(QUEUE, sub ? total[1] : total[0]);
        for (int e = 0; e < n; ++e) {
          const Entry c = q[e];
          if (before(c.v, c.i, root.v, root.i)) root = heap_sift(own, k, 0, c.v, c.i);
        }
      }
      __syncwarp();
      thr[0] = __shfl_sync(0xffffffffu, root.v, lane & ~3);
      thr[1] = __shfl_sync(0xffffffffu, root.v, (lane & ~3) | 1);
      retest = __any_sync(0xffffffffu, (pend[0] | pend[1]) != 0u);
      if (!retest) break;
    }
    if (tile == 0) {
      PROFILE_ADD(1, t_upkeep);
    } else {
      PROFILE_ADD(2, t_upkeep);
    }
  }

  // Write the warp's live rows: each list in heap order (the merge ranks
  // the candidates itself).
  if (q0 + qw >= B) return;
  PROFILE_NOW(t_final);
  const int qrow0 = q0 + qw;
  for (int i = lane; i < 16 * k; i += 32) {
    const int qq = i / k, j = i - qq * k;
    if (qrow0 + qq < B) {
      const size_t o = (static_cast<size_t>(qrow0 + qq) * n_chunks + chunk) * k + j;
      const Entry e = wL[qq * ks + j];
      part_v[o] = e.v;
      part_i[o] = e.v == neg_inf() ? -1 : e.i;
    }
  }
  PROFILE_ADD(3, t_final);
#ifdef COSINE_TOPK_PROFILE
  if (lane == 0) {
    for (int i = 0; i < 4; ++i) atomicAdd(&g_profile[i], prof[i]);
    atomicAdd(&g_profile[4], 1ull);
  }
#endif
}

// ---- the merge pass --------------------------------------------------------

// A candidate as one 64-bit key that ranks it: the larger key ranks first.
// Bits 63-32 hold the value as an order-preserving u32 (-0 read as +0, as
// `before` compares them); bits 31-1 hold 0x7fffffff - row, so the lower row
// of two equal values has the larger key; bit 0 marks a -0, so the value
// comes back bit for bit. Rows are below 2^31, so finite keys are distinct
// and nonzero; a dead candidate (-inf) is 0.
__device__ __forceinline__ uint64_t merge_key(float v, int r) {
  if (v == neg_inf()) return 0;
  const uint32_t u = __float_as_uint(v);
  const bool neg_zero = u == 0x80000000u;
  const uint32_t o = neg_zero ? 0x80000000u : ordered(v);
  const uint32_t low = ((0x7fffffffu - static_cast<uint32_t>(r)) << 1) | (neg_zero ? 1u : 0u);
  return (static_cast<uint64_t>(o) << 32) | low;
}

__device__ __forceinline__ Entry merge_entry(uint64_t key) {
  const uint32_t low = static_cast<uint32_t>(key);
  return Entry{(low & 1u) ? -0.f : from_ordered(static_cast<uint32_t>(key >> 32)),
               static_cast<int>(0x7fffffffu - (low >> 1))};
}

// The merge: one block of MERGE_THREADS per query. Its n_chunks * k
// candidates go to shared memory as keys (16-byte loads), a radix select
// over the keys' bytes, from the top, finds the smallest key of the k best
// (each pass counts the keys that share the bytes found so far into 256
// bins, one shared atomic per distinct bin a warp, and stops once the bin
// of the k-th key holds exactly the keys still needed), the keys at or
// above it (min(k, finite) of them) are gathered and each is ranked by
// counting the gathered keys above it. It only selects: every value and
// row comes from the lists unchanged. Shared memory: n_chunks * k * 8
// dynamic bytes, and 256 * 4 + MAX_K * 8 + 16 static.
__global__ void __launch_bounds__(MERGE_THREADS)
merge_kernel(const float* __restrict__ part_v, const int* __restrict__ part_i,
                   int n_cand, int k, float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ uint64_t mkeys[];
  __shared__ int hist[256];
  __shared__ uint64_t sel[MAX_K];
  __shared__ int s_bin, s_above, s_in_bin, s_count;
  const int tid = threadIdx.x, lane = tid & 31;
  const size_t query = blockIdx.x;
  const float* cv = part_v + query * n_cand;
  const int* ci = part_i + query * n_cand;

  // Stage the keys: scalar loads up to the first 16-byte boundary (part_v
  // and part_i rows share their offset from it), 16-byte loads, the tail.
  const int misaligned = static_cast<int>(reinterpret_cast<uintptr_t>(cv) & 15u) / 4;
  const int head = min(n_cand, (4 - misaligned) & 3);
  const int n4 = (n_cand - head) / 4;
  for (int i = tid; i < head; i += MERGE_THREADS) mkeys[i] = merge_key(cv[i], ci[i]);
  const float4* cv4 = reinterpret_cast<const float4*>(cv + head);
  const int4* ci4 = reinterpret_cast<const int4*>(ci + head);
  for (int i = tid; i < n4; i += MERGE_THREADS) {
    const float4 v = cv4[i];
    const int4 r = ci4[i];
    uint64_t* dst = mkeys + head + 4 * i;
    dst[0] = merge_key(v.x, r.x);
    dst[1] = merge_key(v.y, r.y);
    dst[2] = merge_key(v.z, r.z);
    dst[3] = merge_key(v.w, r.w);
  }
  for (int i = head + 4 * n4 + tid; i < n_cand; i += MERGE_THREADS)
    mkeys[i] = merge_key(cv[i], ci[i]);
  if (tid == 0) s_count = 0;

  // The radix select: `lowest` becomes the smallest key of the k best (1,
  // every finite key, where fewer than k are finite).
  uint64_t prefix = 0, lowest = 1;
  int need = k;
  for (int shift = 56; shift >= 0; shift -= 8) {
    const uint64_t above = shift == 56 ? 0 : ~0ull << (shift + 8);  // the bytes found so far
    for (int i = tid; i < 256; i += MERGE_THREADS) hist[i] = 0;
    __syncthreads();
    for (int base = 0; base < n_cand; base += MERGE_THREADS) {
      const int i = base + tid;
      int bin = 256;
      if (i < n_cand) {
        const uint64_t key = mkeys[i];
        if (key != 0 && (key & above) == prefix) bin = static_cast<int>((key >> shift) & 255u);
      }
      const unsigned peers = __match_any_sync(0xffffffffu, bin);
      if (bin < 256 && lane == __ffs(peers) - 1) atomicAdd(&hist[bin], __popc(peers));
    }
    __syncthreads();
    if (tid < 32) {
      // Lane l holds bins 255 - 8l down to 248 - 8l: a prefix sum over the
      // lanes counts the keys in the bins above each lane's.
      int c[8], sum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c[j] = hist[255 - 8 * lane - j];
        sum += c[j];
      }
      int incl = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += t;
      }
      int run = incl - sum;
      if (run < need && need <= incl) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (run < need && need <= run + c[j]) {
            s_bin = 255 - 8 * lane - j;
            s_above = run;
            s_in_bin = c[j];
          }
          run += c[j];
        }
      }
      if (lane == 31 && incl < need) s_bin = -1;  // fewer keys than needed: take them all
    }
    __syncthreads();
    const int bin = s_bin;
    if (bin < 0) break;
    need -= s_above;
    prefix |= static_cast<uint64_t>(bin) << shift;
    if (s_in_bin == need) {  // every key of this bin is in
      lowest = prefix > 1 ? prefix : 1;
      break;
    }
  }

  // Gather the keys at or above `lowest` (at most k: the keys are
  // distinct), then rank each by counting.
  for (int base = 0; base < n_cand; base += MERGE_THREADS) {
    const int i = base + tid;
    const bool in = i < n_cand && mkeys[i] >= lowest;
    const unsigned ballot = __ballot_sync(0xffffffffu, in);
    int slot = 0;
    if (lane == 0 && ballot) slot = atomicAdd(&s_count, __popc(ballot));
    slot = __shfl_sync(0xffffffffu, slot, 0) + __popc(ballot & ((1u << lane) - 1u));
    if (in && slot < k) sel[slot] = mkeys[i];
  }
  __syncthreads();
  const int count = min(s_count, k);
  float* ov = out_v + query * k;
  int* oi = out_i + query * k;
  for (int t = tid; t < count; t += MERGE_THREADS) {
    const uint64_t key = sel[t];
    int rank = 0;
    for (int j = 0; j < count; ++j) rank += sel[j] > key;
    const Entry e = merge_entry(key);
    ov[rank] = e.v;
    oi[rank] = e.i;
  }
  for (int j = count + tid; j < k; j += MERGE_THREADS) {
    ov[j] = neg_inf();
    oi[j] = -1;
  }
}

// ---- host side ------------------------------------------------------------

// Raise a kernel's dynamic shared-memory limit to `bytes` once per device
// (the attribute is per device): `done` is the kernel's own set of devices,
// bit d for device d, so the launches after the first skip the call.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, std::atomic<uint64_t>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? 1ull << dev : 0;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

cudaError_t launch_merge(const void* part_v, const void* part_i, int B, int n_chunks, int k,
                         void* out_v, void* out_i, cudaStream_t s) {
  const int n_cand = n_chunks * k;
  if (n_cand > MAX_CANDIDATES) return cudaErrorInvalidValue;
  static std::atomic<uint64_t> done{0};
  const cudaError_t err = allow_smem(merge_kernel, MAX_CANDIDATES * 8, done);
  if (err != cudaSuccess) return err;
  merge_kernel<<<B, MERGE_THREADS, static_cast<size_t>(n_cand) * 8, s>>>(
      static_cast<const float*>(part_v), static_cast<const int*>(part_i), n_cand, k,
      static_cast<float*>(out_v), static_cast<int*>(out_i));
  return cudaGetLastError();
}

template <typename T, int NWG>
cudaError_t launch_chunks(CUtensorMapDataType type, const void* emb, const void* q, int B,
                          int D, int size, int k, int stages, int n_chunks, int chunk_rows,
                          void* part_v, void* part_i, cudaStream_t s) {
  constexpr int BQ = 64 * NWG;
  const size_t smem = smem_bytes(BQ, k, stages);
  if (smem > SMEM_LIMIT || stages < 2 || stages > MAX_STAGES) return cudaErrorInvalidValue;
  CUtensorMap tm_q, tm_e;
  cudaError_t err = encode(&tm_q, type, sizeof(T), q, B, D, BQ);
  if (err != cudaSuccess) return err;
  err = encode(&tm_e, type, sizeof(T), emb, size, D, BN);
  if (err != cudaSuccess) return err;
  auto kernel = chunk_topk_kernel<T, NWG>;
  static std::atomic<uint64_t> done{0};  // one set of devices a template instance
  err = allow_smem(kernel, static_cast<int>(SMEM_LIMIT), done);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + BQ - 1) / BQ, n_chunks);
  kernel<<<grid, (NWG + 1) * 128, smem, s>>>(tm_q, tm_e, B, D, size, k, stages, chunk_rows,
                                             static_cast<float*>(part_v),
                                             static_cast<int*>(part_i));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(CUtensorMapDataType type, int bq, const void* emb, const void* q,
                         int B, int D, int size, int k, int stages, int n_chunks,
                         int chunk_rows, void* part_v, void* part_i, cudaStream_t s) {
  if (bq == 128)
    return launch_chunks<T, 2>(type, emb, q, B, D, size, k, stages, n_chunks, chunk_rows,
                               part_v, part_i, s);
  if (bq == 64)
    return launch_chunks<T, 1>(type, emb, q, B, D, size, k, stages, n_chunks, chunk_rows,
                               part_v, part_i, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The second pass alone: part_v/part_i [B, n_chunks, k] lists (any order
// within a list; -inf dead) into out_v/out_i [B, k]; n_chunks * k <= 16384.
int rag_cosine_topk_merge(const void* part_v, const void* part_i, int B, int n_chunks, int k,
                          void* out_v, void* out_i, void* stream) {
  if (B < 1 || k < 1 || k > MAX_K || n_chunks < 0) return cudaErrorInvalidValue;
  return launch_merge(part_v, part_i, B, n_chunks, k, out_v, out_i,
                      static_cast<cudaStream_t>(stream));
}

// emb [cap, D] and q [B, D] row-major in one dtype (dtype 0 bf16, 1 fp16,
// 2 f32), 16-byte aligned; rows >= size are ignored (size <= cap).
// part_v/part_i are [B, n_chunks, k] scratch, out_v/out_i [B, k]. Requires
// B >= 1, 1 <= k <= 256, D % 8 == 0, bq in {64, 128}, smem_bytes(bq, k,
// stages) <= 232448, chunk_rows % 128 == 0, n_chunks * chunk_rows >= size
// and n_chunks * k <= 16384.
int rag_cosine_topk(const void* emb, const void* q, int B, int D, int size, int k, int dtype,
                    int bq, int stages, int n_chunks, int chunk_rows, void* part_v,
                    void* part_i, void* out_v, void* out_i, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || k < 1 || k > MAX_K || D % 8 != 0 || chunk_rows % BN != 0 || n_chunks < 1 ||
      static_cast<int64_t>(n_chunks) * k > MAX_CANDIDATES)
    return cudaErrorInvalidValue;
  if (size <= 0)  // nothing live: every slot dead
    return launch_merge(part_v, part_i, B, 0, k, out_v, out_i, s);
  cudaError_t err;
  switch (dtype) {
    case 0:
      err = launch_typed<__nv_bfloat16>(CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, bq, emb, q, B, D,
                                        size, k, stages, n_chunks, chunk_rows, part_v,
                                        part_i, s);
      break;
    case 1:
      err = launch_typed<__half>(CU_TENSOR_MAP_DATA_TYPE_FLOAT16, bq, emb, q, B, D, size, k,
                                 stages, n_chunks, chunk_rows, part_v, part_i, s);
      break;
    case 2:
      err = launch_typed<float>(CU_TENSOR_MAP_DATA_TYPE_FLOAT32, bq, emb, q, B, D, size, k,
                                stages, n_chunks, chunk_rows, part_v, part_i, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  return launch_merge(part_v, part_i, B, n_chunks, k, out_v, out_i, s);
}

#ifdef COSINE_TOPK_PROFILE
// Copy the five profile counters to out (host memory) and zero them.
int rag_cosine_topk_profile(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_profile, sizeof(g_profile));
  if (err != cudaSuccess) return err;
  const unsigned long long zero[5] = {0, 0, 0, 0, 0};
  return cudaMemcpyToSymbol(g_profile, zero, sizeof(g_profile));
}
#endif

}  // extern "C"
