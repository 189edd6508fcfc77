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
//      k = 50. The first tile of a chunk, where every score survives, is
//      taken in bulk: the quad stores the query's first k scores straight
//      into the heap's slots and the owner makes them a heap bottom-up. At
//      the chunk's end each owner heap-sorts its list into rank order.
//      Measured on the card, the upkeep is bound by dependent shared-memory
//      round trips, which wait behind the products' and the ring's traffic;
//      a binary heap (about six levels) and sorted lists shifted by the
//      warp were slower (PERF.md).
// An f32 corpus takes a plain f32 FMA product core (CUDA cores, no TF32)
// reading the same swizzled tiles, with the same thread-to-score layout as
// the wgmma fragment, so the ring, the upkeep and the merge are shared.
//
// Work split. The TPU kernel walks the corpus in order on one core and
// carries a running top-k from block to block. Here blocks run in parallel:
//   1. chunk_topk_kernel, grid (query tiles, corpus chunks), query tile
//      fastest so the tiles that read one chunk share it through L2; about
//      one block per SM. Each block writes its k best per query to a
//      [B, n_chunks, k] scratch.
//   2. merge_kernel, one warp per query: every finite candidate's final
//      position is its position in its chunk's sorted list plus the number
//      of entries of the other chunks that rank before it (binary search);
//      positions below k are written, the rest of the row is dead.
//
// Shared memory of a block (bytes), with BQ queries a block, BN = 128 rows
// a corpus tile, S stages and 128-byte-wide boxes:
//   1024 (alignment of the swizzled tiles)
//   + S * (BQ + BN) * 128                  stages (query box, corpus box)
//   + BQ * (k | 1) * 8                     running lists (f32 value, i32 row)
//   + (BQ / 16) * 128 * 8                  a scratch of 128 candidates a warp
//   + S * 16                               full and empty mbarriers
// It must fit in 232448. ops/cosine_topk.py::kernel_config computes the
// same formula: BQ = 128 where three stages fit beside the lists (k <= 121),
// else BQ = 64 (k <= 256 fits with three stages); S = as many as fit, at
// most 6.
//
// Interface: plain C, launched on the caller's stream, returns
// cudaGetLastError() (or the error of the tensor-map encoding). The tensor
// maps are encoded at every launch: the corpus pointer moves when the index
// grows. No PyTorch header is included. cuTensorMapEncodeTiled lives in
// libcuda; it is looked up at run time through the CUDA runtime's
// entry-point query, so nothing links libcuda.

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

__host__ __device__ constexpr size_t smem_bytes(int bq, int k, int stages) {
  return 1024 + static_cast<size_t>(stages) * (bq + BN) * BOX_BYTES +
         static_cast<size_t>(bq) * (k | 1) * 8 + static_cast<size_t>(bq / 16) * SCRATCH * 8 +
         static_cast<size_t>(stages) * 16;
}

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

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

// Sort the heap in place into rank order (best first): the root, which
// ranks last, goes to the end of the shrinking heap.
__device__ __forceinline__ void heap_sort(Entry* h, int k) {
  for (int end = k - 1; end > 0; --end) {
    const Entry x = h[end];
    h[end] = h[0];
    heap_sift(h, end, 0, x.v, x.i);
  }
}

// Count of the first n entries of the sorted list (v, ix) that rank before
// (x, r) (a prefix of the list).
__device__ __forceinline__ int count_before(const float* v, const int* ix, int n, float x,
                                            int r) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (before(v[mid], ix[mid], x, r)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
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
  Entry root{neg_inf(), INT_MAX};
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
    PROFILE_NOW(t_upkeep);

    // ---- upkeep: the warp's 16 queries against this tile's 128 rows ----
    // d[4j + 2h + b] is query row ra + 8h of the warp and corpus row
    // row0 + 8j + b; bit 2j + b of pend[h] marks it as a candidate.
    const int row0 = r_begin + tile * BN + sub * 2;
    unsigned pend[2] = {0u, 0u};
    if (tile == 0) {
      // Every score is a candidate: taken in bulk. The quad's lanes store a
      // row's first k scores (column order) in its heap's slots, the owner
      // makes them a heap bottom-up, and the rest are marked.
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        Entry* hl = wL + (ra + 8 * h) * ks;
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            const int slot = 32 * sub + 2 * j + b, row = row0 + 8 * j + b;
            const bool ok = row < r_end;
            if (slot < k) {
              hl[slot] = ok ? Entry{d[4 * j + 2 * h + b], row} : Entry{neg_inf(), INT_MAX};
            } else if (ok) {
              pend[h] |= 1u << (2 * j + b);
            }
          }
      }
      __syncwarp();
      if (sub < 2) {
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

  // Sort each heap into rank order, then write the warp's rows.
  PROFILE_NOW(t_final);
  if (sub < 2) heap_sort(own, k);
  __syncwarp();
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

// ---- the merge pass -------------------------------------------------------

// One warp per query over its n_chunks sorted lists of k. Finite candidates
// are distinct rows, so their merged positions are distinct; the first
// min(k, finite) slots are written by them, the rest are dead.
__global__ void merge_kernel(const float* __restrict__ part_v, const int* __restrict__ part_i,
                             int B, int n_chunks, int k, float* __restrict__ out_v,
                             int* __restrict__ out_i) {
  const int query = static_cast<int>((static_cast<int64_t>(blockIdx.x) * blockDim.x +
                                      threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (query >= B) return;
  const int n_cand = n_chunks * k;
  const float* cv = part_v + static_cast<size_t>(query) * n_cand;
  const int* ci = part_i + static_cast<size_t>(query) * n_cand;
  float* ov = out_v + static_cast<size_t>(query) * k;
  int* oi = out_i + static_cast<size_t>(query) * k;

  int written = 0;
  for (int c = lane; c < n_cand; c += 32) {
    const float v = cv[c];
    if (v == neg_inf()) continue;
    const int r = ci[c];
    const int own = c / k;
    int pos = c - own * k;
    for (int other = 0; other < n_chunks && pos < k; ++other)
      if (other != own) pos += count_before(cv + other * k, ci + other * k, k, v, r);
    if (pos < k) {
      ov[pos] = v;
      oi[pos] = r;
      ++written;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) written += __shfl_xor_sync(0xffffffffu, written, off);
  for (int j = written + lane; j < k; j += 32) {
    ov[j] = neg_inf();
    oi[j] = -1;
  }
}

// ---- host side ------------------------------------------------------------

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
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
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

// The second pass alone: part_v/part_i [B, n_chunks, k] sorted lists into
// out_v/out_i [B, k].
int rag_cosine_topk_merge(const void* part_v, const void* part_i, int B, int n_chunks, int k,
                          void* out_v, void* out_i, void* stream) {
  const int threads = 256;
  const int blocks = static_cast<int>((static_cast<int64_t>(B) * 32 + threads - 1) / threads);
  merge_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part_v), static_cast<const int*>(part_i), B, n_chunks, k,
      static_cast<float*>(out_v), static_cast<int*>(out_i));
  return cudaGetLastError();
}

// emb [cap, D] and q [B, D] row-major in one dtype (dtype 0 bf16, 1 fp16,
// 2 f32), 16-byte aligned; rows >= size are ignored (size <= cap).
// part_v/part_i are [B, n_chunks, k] scratch, out_v/out_i [B, k]. Requires
// B >= 1, 1 <= k <= 256, D % 8 == 0, bq in {64, 128}, smem_bytes(bq, k,
// stages) <= 232448, chunk_rows % 128 == 0 and n_chunks * chunk_rows >= size.
int rag_cosine_topk(const void* emb, const void* q, int B, int D, int size, int k, int dtype,
                    int bq, int stages, int n_chunks, int chunk_rows, void* part_v,
                    void* part_i, void* out_v, void* out_i, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || k < 1 || k > MAX_K || D % 8 != 0 || chunk_rows % BN != 0)
    return cudaErrorInvalidValue;
  if (size <= 0)  // nothing live: every slot dead
    return rag_cosine_topk_merge(part_v, part_i, B, 0, k, out_v, out_i, stream);
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
  return rag_cosine_topk_merge(part_v, part_i, B, n_chunks, k, out_v, out_i, stream);
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
