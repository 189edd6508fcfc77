// Kimi Delta Attention (KDA) prefill: the gated delta recurrence over whole
// prompts, each sequence's state held on chip, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no linear attention. It
// replaces the plain chunked form ops/kda.py::kda_chunked_plain, which
// the generator's prefill (llm/kimi_linear.py::KimiLinearModel._kda_prefill)
// runs at every KDA layer: per chunk of 32 tokens a [B, 32, 32, K] float32
// pairwise decay tensor in device memory, several passes over it, batched
// mat-vecs and a triangular solve.
//
// Function. Sequence b (a prompt's head; K = V = 128 channels) takes q, k,
// g [T, K], v [T, V] and beta [T], float32 (q and k normalised, q scaled,
// g <= 0 the log decay). From S = 0, token by token, in float32:
//   S = Diag(exp g_t) S;  u = S^T k_t;  w = beta_t (v_t - u);
//   S += k_t w^T;  o_t = S^T q_t
// and the end state S [K, V]. A position with g = 0 and beta = 0 leaves S
// as it is, so padding after a sequence does not move its end state.
//
// Bound. At the kimilinear.mc_answer prefill (32 prompts x 32 heads =
// 1,024 sequences of 1,398 positions), one launch reads q, k, v and g once
// (4 x 733 MB) and beta, and writes o once (733 MB) and the end states
// (67 MB): 3.7 GB, 1.1 ms at 3.35 TB/s. The recurrence is 7 K V float32
// operations a token (the decay, S^T k, the rank-one update, S^T q):
// 1.6e11, 2.4 ms at 67 TFLOP/s. So the arithmetic bounds it, in float32
// outside the tensor cores (the state stays float32; no TF32, no bf16).
//
// Design: the decode kernel's (csrc/kda_decode.cu), looped over the
// prompt, with the state tiled over the threads so that each value read
// from shared memory serves several columns. One block of 256 threads a
// sequence holds its state [K, V] in registers from the first token to the
// last: a thread holds 16 rows x 4 columns (value channels c0 .. c0 + 3,
// key channels in the float4 groups rg, rg + 8, rg + 16, rg + 24 of its
// row group rg), and the 8 threads of a column group are 8 neighbouring
// lanes of one warp. Per token a thread reads 16 decays, 16 keys and 16
// queries from shared memory (12 16-byte loads; the warp's 8 row groups
// read 128 contiguous bytes, so no two lanes' words share a bank), keeps
// the keys in registers for the update, decays its 64 values and sums its
// parts of S'^T k and S'^T q for its 4 columns; 3 shuffles a sum add the
// 8 row groups' parts. The output needs no second pass: o_t = S'^T q +
// w (q . k) with S' the decayed state before the update. There is no
// barrier between tokens. TILE tokens of q, k, g and v at a time are
// copied to shared memory by cp.async, double-buffered, so the next
// tile's loads overlap this tile's work; then exp(g) (once a channel and
// token) and q . k (a warp a token) are formed there. The state is written
// once at the end, 16 bytes a store. There is no chunk algebra and no
// exponent above 0: each decay is exp(g_t) <= 1.
//
// Interface: plain C, launched on the caller's stream, returns
// cudaGetLastError(). No PyTorch header.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int KD = 128;  // key and value channels of a head
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROW_GROUPS = 8;              // threads that share a column group
constexpr int COLS = 4;                    // value channels a thread
constexpr int GROUPS = KD / 4 / ROW_GROUPS;  // float4 groups of key channels a thread
constexpr int TILE = 16;                   // tokens a stage
constexpr int PIECES = KD * 4 / 16;        // 16-byte pieces of a row
static_assert(THREADS == ROW_GROUPS * KD / COLS, "a thread a (row group, column group)");

struct Stage {
  float q[TILE][KD];
  float k[TILE][KD];
  float e[TILE][KD];  // g as loaded, then exp(g) in place
  float v[TILE][KD];
  float beta[TILE];
  float qk[TILE];
};
constexpr int SMEM_BYTES = 2 * static_cast<int>(sizeof(Stage));

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start the copies of tile `tile` (tokens tile * TILE .. + n) into `st`.
__device__ __forceinline__ void load_tile(Stage& st, const float* q, const float* k,
                                          const float* v, const float* g, const float* beta,
                                          int tile, int tokens) {
  const int t0 = tile * TILE;
  const int n = min(TILE, tokens - t0);
  for (int p = threadIdx.x; p < n * PIECES; p += THREADS) {
    const int row = p / PIECES, col = (p % PIECES) * 4;
    const long long off = static_cast<long long>(t0 + row) * KD + col;
    cp_async16(&st.q[row][col], q + off);
    cp_async16(&st.k[row][col], k + off);
    cp_async16(&st.e[row][col], g + off);
    cp_async16(&st.v[row][col], v + off);
  }
  if (threadIdx.x < n) cp_async4(&st.beta[threadIdx.x], beta + t0 + threadIdx.x);
  cp_async_commit();
}

__global__ void __launch_bounds__(THREADS, 2) kda_prefill_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ g, const float* __restrict__ beta, float* __restrict__ out,
    float* __restrict__ state, int tokens) {
  extern __shared__ __align__(16) unsigned char smem[];
  Stage* stage = reinterpret_cast<Stage*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rg = lane & (ROW_GROUPS - 1);                          // row group
  const int c0 = COLS * (warp * (32 / ROW_GROUPS) + lane / ROW_GROUPS);  // first column
  const long long seq = blockIdx.x;
  const long long base = seq * tokens * KD;
  q += base, k += base, v += base, g += base, out += base;
  beta += seq * tokens;
  const int tiles = (tokens + TILE - 1) / TILE;

  // s[j][x][m]: the state's row 4 (rg + 8 j) + x, column c0 + m.
  float s[GROUPS][4][COLS];
#pragma unroll
  for (int j = 0; j < GROUPS; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int m = 0; m < COLS; ++m) s[j][x][m] = 0.f;

  if (tiles > 0) load_tile(stage[0], q, k, v, g, beta, 0, tokens);
  for (int t = 0; t < tiles; ++t) {
    Stage& st = stage[t & 1];
    // The other buffer was released by the barrier that ended tile t - 1.
    if (t + 1 < tiles) {
      load_tile(stage[(t + 1) & 1], q, k, v, g, beta, t + 1, tokens);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int t0 = t * TILE;
    const int n = min(TILE, tokens - t0);
    // The decays, and q . k of each token (a warp a token).
    for (int i = threadIdx.x; i < n * KD; i += THREADS) {
      float* e = &st.e[0][0] + i;
      *e = expf(*e);
    }
    for (int r = warp; r < n; r += WARPS) {
      const float4 a = reinterpret_cast<const float4*>(st.q[r])[lane];
      const float4 b = reinterpret_cast<const float4*>(st.k[r])[lane];
      float d = a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
      if (lane == 0) st.qk[r] = d;
    }
    __syncthreads();

    for (int r = 0; r < n; ++r) {
      const float4* e4 = reinterpret_cast<const float4*>(st.e[r]) + rg;
      const float4* k4 = reinterpret_cast<const float4*>(st.k[r]) + rg;
      const float4* q4 = reinterpret_cast<const float4*>(st.q[r]) + rg;
      // Decay the thread's values, then its parts of S'^T k and S'^T q.
      float kr[GROUPS][4];
      float u[COLS], p[COLS];
#pragma unroll
      for (int m = 0; m < COLS; ++m) u[m] = 0.f, p[m] = 0.f;
#pragma unroll
      for (int j = 0; j < GROUPS; ++j) {
        const float4 e4j = e4[ROW_GROUPS * j], k4j = k4[ROW_GROUPS * j],
                     q4j = q4[ROW_GROUPS * j];
        const float ej[4] = {e4j.x, e4j.y, e4j.z, e4j.w};
        const float qj[4] = {q4j.x, q4j.y, q4j.z, q4j.w};
        kr[j][0] = k4j.x, kr[j][1] = k4j.y, kr[j][2] = k4j.z, kr[j][3] = k4j.w;
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int m = 0; m < COLS; ++m) {
            s[j][x][m] *= ej[x];
            u[m] = fmaf(kr[j][x], s[j][x][m], u[m]);
            p[m] = fmaf(qj[x], s[j][x][m], p[m]);
          }
      }
      // The row groups' parts, summed in the same order on all 8 lanes.
#pragma unroll
      for (int o = 1; o < ROW_GROUPS; o <<= 1)
#pragma unroll
        for (int m = 0; m < COLS; ++m) {
          u[m] += __shfl_xor_sync(0xffffffffu, u[m], o);
          p[m] += __shfl_xor_sync(0xffffffffu, p[m], o);
        }
      const float4 v4 = *reinterpret_cast<const float4*>(&st.v[r][c0]);
      const float b = st.beta[r];
      const float w[COLS] = {b * (v4.x - u[0]), b * (v4.y - u[1]), b * (v4.z - u[2]),
                             b * (v4.w - u[3])};
      // The rank-one update; o = S^T q of the updated state, a lane a column.
#pragma unroll
      for (int j = 0; j < GROUPS; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int m = 0; m < COLS; ++m) s[j][x][m] = fmaf(kr[j][x], w[m], s[j][x][m]);
      if (rg < COLS) {
        const float qk = st.qk[r];
        const float o = rg == 0 ? fmaf(w[0], qk, p[0])
                        : rg == 1 ? fmaf(w[1], qk, p[1])
                        : rg == 2 ? fmaf(w[2], qk, p[2])
                                  : fmaf(w[3], qk, p[3]);
        out[static_cast<long long>(t0 + r) * KD + c0 + rg] = o;
      }
    }
    __syncthreads();  // every thread is done with this buffer
  }

  float* sp = state + seq * KD * KD + c0;
#pragma unroll
  for (int j = 0; j < GROUPS; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x)
      *reinterpret_cast<float4*>(sp + (4 * (rg + ROW_GROUPS * j) + x) * KD) =
          make_float4(s[j][x][0], s[j][x][1], s[j][x][2], s[j][x][3]);
}

}  // namespace

extern "C" int rag_kda_prefill(const void* q, const void* k, const void* v, const void* g,
                               const void* beta, void* out, void* state, int seqs, int tokens,
                               void* stream) {
  if (seqs <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      kda_prefill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  kda_prefill_kernel<<<seqs, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(g), static_cast<const float*>(beta), static_cast<float*>(out),
      static_cast<float*>(state), tokens);
  return static_cast<int>(cudaGetLastError());
}
