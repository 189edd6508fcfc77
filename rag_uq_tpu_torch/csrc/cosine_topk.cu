// Exact cosine top-k over a bf16 corpus matrix, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel rag_uq_tpu/ops/pallas_topk.py::
// pallas_cosine_topk (body _kernel): for every query, the k corpus rows with
// the largest q . e, scores accumulated in f32 from bf16 operands, rows at or
// past `size` masked to -inf, ties to the lowest row index, and -1 where the
// value is -inf. The [B, cap] score matrix never reaches device memory.
//
// Bound at the slice's shape (B = 2048 queries, cap = 131072 rows, D = 768,
// k = 50) on an H100 SXM: 2*2048*131072*768 = 4.1e11 flop at 989 TFLOP/s
// bf16 is 0.42 ms; the corpus is 201 MB, 0.06 ms at 3.35 TB/s. So the work
// is bound by operations, not bytes. This design multiplies with mma.sync
// (m16n8k16, bf16 in, f32 accumulate) fed from shared memory by cp.async,
// which reaches only a part of the tensor cores' rate; a warpgroup (wgmma)
// pipeline fed by TMA is later work.
//
// Design. The TPU kernel walks the corpus in order on one core and carries a
// running top-k from block to block. Here blocks run in parallel, so the work
// is split in two passes:
//   1. chunk_topk_kernel, grid (query tiles, corpus chunks), query tile
//      fastest so the tiles that read one chunk run together and the chunk is
//      read from device memory about once and from L2 by the others. A block
//      computes 64 x 64 score tiles of its 64 queries against its chunk's
//      rows and keeps each query's sorted top-k in shared memory. Each
//      thread tests the scores it holds in registers against their query's
//      current k-th value (most fail once the list is warm) and appends the
//      rest to a per-query candidate list; each warp then inserts its
//      queries' candidates, all lanes together, in (value desc, row asc)
//      order. Each block writes its k best per query to a [B, n_chunks, k]
//      scratch.
//   2. merge_kernel, one warp per query, takes the k best of the
//      n_chunks * k candidates in (value desc, row asc) order.
// The Pallas constraints cap % block == 0 and 1 <= fan <= k do not apply.
//
// Interface: plain C, launched on the caller's stream, returns
// cudaGetLastError(). No PyTorch header is included.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int BQ = 64;        // queries per block
constexpr int BN = 64;        // corpus rows per score tile
constexpr int BK = 64;        // feature columns per pipeline step
constexpr int LDS = BK + 8;   // padded shared row: fragment loads hit 32 banks
constexpr int THREADS = 128;  // 4 warps; warp w owns a 32 x 32 score quadrant

__host__ __device__ constexpr size_t smem_bytes(int k) {
  return sizeof(__nv_bfloat16) * 2 * (BQ + BN) * LDS  // double-buffered Q, E
         + (sizeof(float) + sizeof(int)) * BQ * BN    // candidates of a tile
         + sizeof(int) * BQ                           // candidate counts
         + (sizeof(float) + sizeof(int)) * BQ * k;    // running top-k lists
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a * b for one 16 x 8 x 16 tile (row-major A, column-major B).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// (v, i) ranks before (x, r): value descending, then row ascending.
__device__ __forceinline__ bool before(float v, int i, float x, int r) {
  return v > x || (v == x && i < r);
}

// Insert (x, r) into the sorted list (v, ix) of length k <= 128, keeping the
// k best; all 32 lanes of the warp call it together. The list's entries
// that rank before (x, r) form a prefix, so its length is the insert
// position; each lane then moves its own slots down by one.
__device__ __forceinline__ void warp_insert(float* v, int* ix, int k, float x,
                                            int r, int lane) {
  if (!before(x, r, v[k - 1], ix[k - 1])) return;  // uniform: does not enter
  int pos = 0;
  for (int base = 0; base < k; base += 32) {
    const int p = base + lane;
    const bool ahead = p < k && before(v[p], ix[p], x, r);
    pos += __popc(__ballot_sync(0xffffffffu, ahead));
  }
  float nv[4];
  int ni[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int p = m * 32 + lane;
    if (p < k && p > pos) {
      nv[m] = v[p - 1];
      ni[m] = ix[p - 1];
    } else {
      nv[m] = x;
      ni[m] = r;
    }
  }
  __syncwarp();
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int p = m * 32 + lane;
    if (p < k && p >= pos) {
      v[p] = nv[m];
      ix[p] = ni[m];
    }
  }
  __syncwarp();
}

__global__ void __launch_bounds__(THREADS, 2)
chunk_topk_kernel(const __nv_bfloat16* __restrict__ emb,
                  const __nv_bfloat16* __restrict__ q, int B, int D, int size,
                  int k, int chunk_rows, float* __restrict__ part_v,
                  int* __restrict__ part_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][BQ][LDS]
  __nv_bfloat16* sE = sQ + 2 * BQ * LDS;                        // [2][BN][LDS]
  float* sCV = reinterpret_cast<float*>(sE + 2 * BN * LDS);     // [BQ][BN]
  int* sCI = reinterpret_cast<int*>(sCV + BQ * BN);             // [BQ][BN]
  int* sCnt = sCI + BQ * BN;                                    // [BQ]
  float* sV = reinterpret_cast<float*>(sCnt + BQ);              // [BQ][k]
  int* sI = reinterpret_cast<int*>(sV + BQ * k);                // [BQ][k]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates
  const int wq = (warp >> 1) * 32, wr = (warp & 1) * 32;
  const int q0 = blockIdx.x * BQ;
  const int chunk = blockIdx.y, n_chunks = gridDim.y;
  const int r_begin = chunk * chunk_rows;
  const int r_end = min(r_begin + chunk_rows, size);

  for (int i = tid; i < BQ * k; i += THREADS) {
    sV[i] = -inf();
    sI[i] = -1;
  }
  if (tid < BQ) sCnt[tid] = 0;
  __syncthreads();

  const int n_tiles = r_end > r_begin ? (r_end - r_begin + BN - 1) / BN : 0;
  const int n_k = (D + BK - 1) / BK;
  const int total = n_tiles * n_k;

  // Stage `step` = (tile, feature block) into buffer `buf`. Rows past the
  // batch or the live corpus are clamped to the last valid row (their scores
  // are never kept); feature columns past D are zero.
  auto load_stage = [&](int buf, int step) {
    const int tile = step / n_k;
    const int k0 = (step - tile * n_k) * BK;
    const int row0 = r_begin + tile * BN;
    for (int p = tid; p < (BQ + BN) * (BK / 8); p += THREADS) {
      const int r = p / (BK / 8), c = (p % (BK / 8)) * 8;
      __nv_bfloat16* dst;
      const __nv_bfloat16* src;
      if (r < BQ) {
        dst = sQ + (buf * BQ + r) * LDS + c;
        src = q + static_cast<size_t>(min(q0 + r, B - 1)) * D;
      } else {
        dst = sE + (buf * BN + (r - BQ)) * LDS + c;
        src = emb + static_cast<size_t>(min(row0 + r - BQ, size - 1)) * D;
      }
      if (k0 + c < D) {
        cp_async16(dst, src + k0 + c);
      } else {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      }
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  if (total > 0) {
    load_stage(0, 0);
    cp_async_commit();
  }
  for (int step = 0; step < total; ++step) {
    if (step + 1 < total) {
      load_stage((step + 1) & 1, step + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* tq = sQ + (step & 1) * BQ * LDS;
    const __nv_bfloat16* te = sE + (step & 1) * BN * LDS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const __nv_bfloat16* p = tq + (wq + mt * 16 + g) * LDS + kk + t * 2;
        a[mt][0] = ld32(p);
        a[mt][1] = ld32(p + 8 * LDS);
        a[mt][2] = ld32(p + 8);
        a[mt][3] = ld32(p + 8 * LDS + 8);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const __nv_bfloat16* p = te + (wr + nt * 8 + g) * LDS + kk + t * 2;
        b[nt][0] = ld32(p);
        b[nt][1] = ld32(p + 8);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt]);
    }
    __syncthreads();  // the next step's load overwrites the other buffer

    const int tile = step / n_k;
    if (step - tile * n_k != n_k - 1) continue;

    // Tile done. Each thread tests its 32 scores against its 4 queries'
    // current k-th values and appends those that beat them to the query's
    // candidate list; no score goes to shared memory otherwise.
    const int row0 = r_begin + tile * BN;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int qr = wq + mt * 16 + g + hi * 8;
        const float thr = sV[qr * k + k - 1];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int lo = 0; lo < 2; ++lo) {
            const int row = row0 + wr + nt * 8 + t * 2 + lo;
            const float x = acc[mt][nt][hi * 2 + lo];
            acc[mt][nt][hi * 2 + lo] = 0.f;
            if (x > thr && row < r_end) {
              const int slot = atomicAdd(&sCnt[qr], 1);
              sCV[qr * BN + slot] = x;
              sCI[qr * BN + slot] = row;
            }
          }
      }
    __syncthreads();
    // Warp w merges the candidates of queries [16w, 16w + 16), one
    // candidate at a time with all 32 lanes.
    for (int qq = warp * (BQ / 4); qq < (warp + 1) * (BQ / 4); ++qq) {
      const int n = sCnt[qq];
      for (int j = 0; j < n; ++j)
        warp_insert(sV + qq * k, sI + qq * k, k, sCV[qq * BN + j],
                    sCI[qq * BN + j], lane);
      __syncwarp();
      if (lane == 0) sCnt[qq] = 0;
    }
    __syncthreads();
  }

  for (int i = tid; i < BQ * k; i += THREADS) {
    const int qq = i / k, j = i - qq * k;
    if (q0 + qq < B) {
      const size_t o = (static_cast<size_t>(q0 + qq) * n_chunks + chunk) * k + j;
      part_v[o] = sV[i];
      part_i[o] = sI[i];
    }
  }
}

// One warp per query: repeatedly take the best candidate that ranks after the
// last one taken, in (value desc, row asc) order. Finite candidates are
// distinct rows, so the order is strict; once the best left is -inf, the
// remaining slots are dead.
__global__ void merge_kernel(const float* __restrict__ part_v,
                             const int* __restrict__ part_i, int B, int n_cand,
                             int k, float* __restrict__ out_v,
                             int* __restrict__ out_i) {
  const int query = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (query >= B) return;
  const float* cv = part_v + static_cast<size_t>(query) * n_cand;
  const int* ci = part_i + static_cast<size_t>(query) * n_cand;
  float* ov = out_v + static_cast<size_t>(query) * k;
  int* oi = out_i + static_cast<size_t>(query) * k;

  float last_v = inf();
  int last_i = -1;
  for (int j = 0; j < k; ++j) {
    float bv = -inf();
    int bi = INT_MAX;
    for (int c = lane; c < n_cand; c += 32) {
      const float v = cv[c];
      const int i = ci[c];
      const bool after = v < last_v || (v == last_v && i > last_i);
      const bool better = v > bv || (v == bv && i < bi);
      if (after && better) {
        bv = v;
        bi = i;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float v = __shfl_xor_sync(0xffffffffu, bv, off);
      const int i = __shfl_xor_sync(0xffffffffu, bi, off);
      if (v > bv || (v == bv && i < bi)) {
        bv = v;
        bi = i;
      }
    }
    if (bv == -inf()) {
      for (int jj = j + lane; jj < k; jj += 32) {
        ov[jj] = -inf();
        oi[jj] = -1;
      }
      return;
    }
    if (lane == 0) {
      ov[j] = bv;
      oi[j] = bi;
    }
    last_v = bv;
    last_i = bi;
  }
}

}  // namespace

extern "C" {

// emb [cap, D] and q [B, D] bf16, row-major; rows >= size are ignored
// (size <= cap). part_v/part_i are [B, n_chunks, k] scratch, out_v/out_i
// [B, k]. Requires 1 <= k <= 128, D % 8 == 0, 16-byte aligned rows,
// n_chunks * chunk_rows >= size and chunk_rows % 64 == 0.
int rag_cosine_topk(const void* emb, const void* q, int B, int D, int size,
                    int k, int n_chunks, int chunk_rows, void* part_v,
                    void* part_i, void* out_v, void* out_i, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = smem_bytes(k);
  cudaError_t err = cudaFuncSetAttribute(
      chunk_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid1((B + BQ - 1) / BQ, n_chunks);
  chunk_topk_kernel<<<grid1, THREADS, smem, s>>>(
      static_cast<const __nv_bfloat16*>(emb),
      static_cast<const __nv_bfloat16*>(q), B, D, size, k, chunk_rows,
      static_cast<float*>(part_v), static_cast<int*>(part_i));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int threads = 256;
  const int blocks = static_cast<int>((static_cast<int64_t>(B) * 32 + threads - 1) / threads);
  merge_kernel<<<blocks, threads, 0, s>>>(
      static_cast<const float*>(part_v), static_cast<const int*>(part_i), B,
      n_chunks * k, k, static_cast<float*>(out_v), static_cast<int*>(out_i));
  return cudaGetLastError();
}

}  // extern "C"
