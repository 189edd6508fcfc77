// Exact cosine top-k for pools above the heap kernel's limit (256 < k <= 8192).
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
// Design (simple first): two kernels a chunk of queries.
//   1. score_kernel writes the [Bc, live] f32 scores to device memory, one
//      128 x 128 tile a block, 8 x 8 scores a thread, depth steps of 16
//      loaded with 16-byte vector loads and widened to f32 in shared memory,
//      f32 FMAs on CUDA cores (no tensor cores, no TF32), so the sums are
//      those of the plain version up to their order.
//   2. select_kernel, one block of 1024 threads a query: a 4-pass radix
//      select (8 bits a pass, histograms in shared memory) finds the k-th
//      largest value T and how many rows equal to T the result takes; an
//      ordered compaction (block-wide prefix sums, row order) takes every row
//      above T and the lowest rows equal to T; a bitonic sort of 64-bit keys
//      (value descending, row ascending) in shared memory puts them in rank
//      order.
// The wrapper (ops/cosine_topk.py::cuda_cosine_topk) chunks the queries so
// the score buffer stays within SCORE_BUDGET bytes.
//
// Bound at the main path's width (B = 2048, 100000 live rows, D = 768) on an
// H100 SXM: 3.1e11 flop, which at the bf16 tensor rate of 989 TFLOP/s is
// 0.318 ms, against 0.15 GB of corpus reads (0.046 ms at 3.35 TB/s): bound by
// operations. This design is far from that: its products run at the f32
// CUDA-core rate (67 TFLOP/s at most) and its scores make a round trip
// through device memory (0.82 GB written, read five times by the select).
//
// Interface: plain C, launched on the caller's stream, returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LARGE_MAX_K = 8192;
constexpr int TILE = 128;  // queries and corpus rows of a score tile
constexpr int DEPTH = 16;  // feature columns a step
constexpr int SCORE_THREADS = 256;
constexpr int SELECT_THREADS = 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// Loads DEPTH consecutive elements of a row (16-byte aligned) as f32.
template <typename T>
__device__ __forceinline__ void load_depth(const T* p, float* out) {
  constexpr int PER_VEC = 16 / sizeof(T);
  const uint4* v = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int j = 0; j < DEPTH / PER_VEC; ++j) {
    const uint4 w = v[j];
    const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
    for (int t = 0; t < PER_VEC; ++t) out[j * PER_VEC + t] = to_f32(e[t]);
  }
}

// scores[b * live + n] = sum_d q[b, d] * emb[n, d] for b < B, n < live.
// Grid (ceil(live / TILE), ceil(B / TILE)); 256 threads, each 8 queries x 8
// rows: queries ty * 8 + i, rows tx + 16 * j (so a warp's stores of one
// query row are contiguous).
template <typename T>
__global__ void __launch_bounds__(SCORE_THREADS)
    score_kernel(const T* __restrict__ emb, const T* __restrict__ q, int B, int D, int live,
                 float* __restrict__ scores) {
  __shared__ __align__(16) float qs[DEPTH][TILE + 4];
  __shared__ float es[DEPTH][TILE + 1];
  const int n0 = blockIdx.x * TILE, b0 = blockIdx.y * TILE;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  // Loader role: threads 0-127 load query rows, 128-255 corpus rows.
  const bool loads_q = threadIdx.x < TILE;
  const int lr = threadIdx.x % TILE;
  const int grow = loads_q ? b0 + lr : n0 + lr;
  const bool row_ok = grow < (loads_q ? B : live);
  const T* src = (loads_q ? q : emb) + static_cast<int64_t>(row_ok ? grow : 0) * D;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int d0 = 0; d0 < D; d0 += DEPTH) {
    float vals[DEPTH];
    if (row_ok && d0 + DEPTH <= D) {
      load_depth<T>(src + d0, vals);
    } else {
#pragma unroll
      for (int t = 0; t < DEPTH; ++t)
        vals[t] = (row_ok && d0 + t < D) ? to_f32(src[d0 + t]) : 0.f;
    }
    if (loads_q) {
#pragma unroll
      for (int t = 0; t < DEPTH; ++t) qs[t][lr] = vals[t];
    } else {
#pragma unroll
      for (int t = 0; t < DEPTH; ++t) es[t][lr] = vals[t];
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < DEPTH; ++t) {
      const float4 qa = *reinterpret_cast<const float4*>(&qs[t][ty * 8]);
      const float4 qb = *reinterpret_cast<const float4*>(&qs[t][ty * 8 + 4]);
      const float a[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
      float e[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) e[j] = es[t][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], e[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int b = b0 + ty * 8 + i;
    if (b >= B) continue;
    float* out = scores + static_cast<int64_t>(b) * live;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < live) out[n] = acc[i][j];
    }
  }
}

// Order-preserving map of an f32 to a u32 (larger value, larger key).
__device__ __forceinline__ uint32_t ordered(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Exclusive prefix sum over the block (SELECT_THREADS threads); *total gets
// the block's sum. `warp_sums` holds 32 ints of shared memory.
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
    int w = warp_sums[lane];
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

// One block a query: the k largest of scores[b, :live] in rank order (value
// descending, row ascending) into out_v/out_i [B, k]; slots past live are
// -inf and -1. Dynamic shared memory: kp * 8 bytes, kp = the power of two
// at or above min(k, live).
__global__ void __launch_bounds__(SELECT_THREADS)
    select_kernel(const float* __restrict__ scores, int live, int k, int kp,
                  float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ unsigned long long keys[];
  __shared__ unsigned int hist[256];
  __shared__ int warp_sums[33];
  __shared__ uint32_t s_prefix;
  __shared__ int s_need;
  const int tid = threadIdx.x;
  const float* row = scores + static_cast<int64_t>(blockIdx.x) * live;
  const int n_out = min(k, live);

  // Radix select: after the passes `prefix` is the k-th largest key T and
  // `need` the number of rows equal to T that the result takes.
  uint32_t prefix = 0, mask = 0;
  int need = k;
  const bool select = live > k;
  if (select) {
    for (int shift = 24; shift >= 0; shift -= 8) {
      for (int i = tid; i < 256; i += SELECT_THREADS) hist[i] = 0;
      __syncthreads();
      // Scores cluster in a few bins, so a warp's lanes that share a bin add
      // once, through their leader.
      for (int base = 0; base < live; base += SELECT_THREADS) {
        const int i = base + tid;
        int bin = -1;
        if (i < live) {
          const uint32_t u = ordered(row[i]);
          if ((u & mask) == prefix) bin = static_cast<int>((u >> shift) & 255u);
        }
        const unsigned peers = __match_any_sync(0xffffffffu, bin);
        if (bin >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1)
          atomicAdd(&hist[bin], static_cast<unsigned>(__popc(peers)));
      }
      __syncthreads();
      if (tid == 0) {
        int above = 0, digit = 255;
        for (; digit > 0; --digit) {
          if (above + static_cast<int>(hist[digit]) >= need) break;
          above += hist[digit];
        }
        s_prefix = prefix | (static_cast<uint32_t>(digit) << shift);
        s_need = need - above;
      }
      __syncthreads();
      prefix = s_prefix;
      need = s_need;
      mask |= 255u << shift;
    }
  }
  const int n_above = select ? k - need : live;  // rows strictly above T (or all)

  // Ordered compaction: rows above T go to slots [0, n_above) and the first
  // `need` rows equal to T, in row order, to [n_above, n_out). Both counts
  // ride one scan, packed in 16-bit halves (at most 1024 a step).
  int above_base = 0, eq_base = 0;
  for (int start = 0; start < live; start += SELECT_THREADS) {
    const int i = start + tid;
    int is_above = 0, is_eq = 0;
    uint32_t u = 0;
    if (i < live) {
      u = ordered(row[i]);
      if (!select || u > prefix) is_above = 1;
      else if (u == prefix) is_eq = 1;
    }
    int total;
    const int excl = block_exclusive_scan(is_above | (is_eq << 16), warp_sums, &total);
    const unsigned long long key =
        (static_cast<unsigned long long>(~u) << 32) | static_cast<uint32_t>(i);
    if (is_above) keys[above_base + (excl & 0xffff)] = key;
    const int eq_rank = eq_base + (excl >> 16);
    if (is_eq && eq_rank < need) keys[n_above + eq_rank] = key;
    above_base += total & 0xffff;
    eq_base += total >> 16;
  }
  for (int i = n_out + tid; i < kp; i += SELECT_THREADS) keys[i] = ~0ull;
  __syncthreads();

  // Bitonic sort of kp keys, ascending: value descending, then row ascending.
  for (int size = 2; size <= kp; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = tid; t < kp / 2; t += SELECT_THREADS) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const unsigned long long a = keys[lo], c = keys[hi];
        const bool up = (lo & size) == 0;
        if ((a > c) == up) {
          keys[lo] = c;
          keys[hi] = a;
        }
      }
      __syncthreads();
    }
  }

  float* ov = out_v + static_cast<int64_t>(blockIdx.x) * k;
  int* oi = out_i + static_cast<int64_t>(blockIdx.x) * k;
  for (int j = tid; j < k; j += SELECT_THREADS) {
    if (j < n_out) {
      const int r = static_cast<int>(keys[j] & 0xffffffffu);
      ov[j] = row[r];
      oi[j] = r;
    } else {
      ov[j] = -__int_as_float(0x7f800000);
      oi[j] = -1;
    }
  }
}

int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

template <typename T>
cudaError_t launch_scores(const void* emb, const void* q, int B, int D, int live,
                          float* scores, cudaStream_t s) {
  const dim3 grid((live + TILE - 1) / TILE, (B + TILE - 1) / TILE);
  score_kernel<T><<<grid, SCORE_THREADS, 0, s>>>(static_cast<const T*>(emb),
                                                 static_cast<const T*>(q), B, D, live, scores);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// emb [cap, D] and q [B, D] row-major in one dtype (0 bf16, 1 fp16, 2 f32),
// 16-byte aligned, D % 8 == 0; rows >= live are ignored. scores is a
// [B, live] f32 scratch; out_v/out_i [B, k]. Requires B >= 1 and
// 1 <= k <= 8192.
int rag_cosine_topk_large(const void* emb, const void* q, int B, int D, int live, int k,
                          int dtype, void* scores, void* out_v, void* out_i, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || k < 1 || k > LARGE_MAX_K || D % 8 != 0 || live < 0)
    return cudaErrorInvalidValue;
  float* sc = static_cast<float*>(scores);
  if (live > 0) {
    cudaError_t err;
    switch (dtype) {
      case 0: err = launch_scores<__nv_bfloat16>(emb, q, B, D, live, sc, s); break;
      case 1: err = launch_scores<__half>(emb, q, B, D, live, sc, s); break;
      case 2: err = launch_scores<float>(emb, q, B, D, live, sc, s); break;
      default: return cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return err;
  }
  const int kp = next_pow2(live < k ? (live > 0 ? live : 1) : k);
  const int smem = kp * static_cast<int>(sizeof(unsigned long long));
  cudaError_t err = cudaFuncSetAttribute(select_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  select_kernel<<<B, SELECT_THREADS, smem, s>>>(sc, live, k, kp, static_cast<float*>(out_v),
                                                static_cast<int*>(out_i));
  return cudaGetLastError();
}

}  // extern "C"
