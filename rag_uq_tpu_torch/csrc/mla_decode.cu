// Absorbed latent-attention decode over a shared-prefix latent cache, for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no latent attention. It
// replaces the plain chain ops/mla_decode.py::mla_decode_plain (two score
// bmm's, a float32 mask, scale and softmax over a [slots, heads, prompt +
// own] score tensor, two value bmm's), which the generator's decode step
// (llm/deepseek_v2.py::DeepseekV2Model._attn_decode) ran at every layer.
//
// Function. Slot s (of S = P * group) and head h has the absorbed query
// q[s, h] (576 = 512 latent + 64 rope values, bf16). It attends over its
// prompt's latents prompt[p = s / group, 0 : lens[p]] and its own generated
// latents gen[s, 0 : t + 1] together, one softmax over both: scores
// q . latent in float32 times `scale`, the softmax in float32, the
// probabilities rounded to bf16 for the value product, values the latents'
// first 512 columns, sums in float32, the output o[s, h] [512] in bf16.
// The plain chain rounds the scores to bf16 before the softmax; here they
// stay float32. Nothing else differs but the order of the sums.
//
// Bound at the generator's shape (32 prompts of ~1,350 tokens, 10 slots a
// prompt, 16 heads, t up to 99) on an H100 SXM: each prompt's latents once
// (32 x 1,350 x 576 x 2 B = 50 MB), each slot's own (at most 37 MB), q and
// the output: 15-27 us at 3.35 TB/s. The products, 2 x 160 x (576 + 512)
// a prompt position, are about 15 GFLOP, 15 us at 989 TFLOP/s. So the
// kernel is bound by bytes only if each prompt is read once for all of its
// group x heads rows, and by products only if those run on the tensor cores.
//
// Design.
//   1. Rows. The 160 (slot, head) rows of one prompt are contiguous in q
//      ([S * heads, 576]); 64-row tiles of them are the M of the products,
//      so one read of a latent tile serves 64 queries (FlashMLA's trick).
//      The row tiles of one prompt are neighbouring blocks (row tile
//      fastest), so the siblings read the prompt through L2.
//   2. Latent tiles [64 positions, 576] arrive by TMA (3D tensor maps,
//      128B swizzle, 9 boxes of 64 columns) in a 2-stage ring under
//      mbarriers. Thread 0 issues the loads of tile j + 1 as the block
//      starts on tile j: a separate producer warp costs the consumers
//      registers (ptxas allots them as for 384 threads, 168 a thread, and
//      the output accumulators spilled). The query tile [64, 576] is loaded
//      once a block, 16 rows a box, only the live rows.
//   3. Scores: wgmma m64n32k16 from the swizzled shared tiles, float32
//      accumulators. The two warpgroups share the tile's 64 rows: each
//      scores 32 of its 64 positions, and keeps half of the [64, 512]
//      float32 output (128 registers a thread). The halves' row maxima and
//      probability fragments cross through shared memory under two named
//      barriers a tile; each warpgroup scoring all 64 positions would
//      spend twice the tensor time on the scores.
//   4. Softmax: online, in registers, float32, over a row's quad and the
//      two warpgroups; scores in log2 units (scale x log2 e folded in, so
//      exp2f, within 2 ulp as expf is); the output is rescaled only when a
//      row maximum of the warp moved. The length mask comes from lens
//      (prompt) or t (own), no mask tensor. Positions past a prompt's
//      length or past t + 1 are masked; the own part's tensor map ends at
//      t + 1, so nothing unwritten is read.
//   5. Values: the score accumulators of a warp's 16 rows are, in bf16,
//      the register A operand of the next wgmma (m64n256k16, one a
//      warpgroup for its 256 output columns); the value tile is the same
//      stage's first 512 columns, read from shared memory as an MN-major
//      (transposed) operand: no second read of the latents from device
//      memory, and each warpgroup reads its half once a tile.
//   6. Splits. A block is one work item: (prompt, position split, row tile)
//      or (slot, own split, head tile); prompt items first, row tile
//      fastest. A prompt is split only where its items would outlast the
//      launch's share of an SM (ops/mla_decode.py::plan): at the
//      generator's shape the 96 prompt items run unsplit beside the 320
//      own items (its heads as rows, a 64-row tile). Every item writes a
//      float32 partial (row max in log2 units, row sum, unnormalised [rows,
//      512]). A second pass, merge_kernel, combines a row's partials in
//      float32 and writes bf16.
//   7. Shapes. The split, the row and head tiles and the own splits come
//      from the shape the wrapper observes (ops/mla_decode.py::plan): rows
//      a prompt, the prompt length, t, the SM count. Any head count, group
//      or length runs the same code. The widths 512 + 64 are compile-time
//      constants (DeepSeek-V2, V2-Lite and V3 publish them).
//
// Shared memory (bytes): 1024 (alignment of the swizzled tiles) + 73,728
// (query tile) + 2 x 73,728 (ring) + 64 (5 mbarriers) + 512 (row maxima and
// sums) + 8,192 (fragment mailbox) = 230,976 of 232,448.
//
// Measured (PERF.md): the item pass is bound by its tensor work and the
// softmax between it, not by bytes: a tile's two products take about as
// long as the card's peak allows for them, and a tile's softmax and
// barriers as long again.
//
// Interface: plain C, launched on the caller's stream, returns
// cudaGetLastError() (or the tensor-map encoding's error). No PyTorch header.

#include <atomic>
#include <cstdint>

#include "hopper_tile.cuh"

namespace {

constexpr int LATENT = 576;  // kv_lora_rank + qk_rope_head_dim
constexpr int RANK = 512;    // kv_lora_rank: the value columns
constexpr int COLS = 64;     // bf16 columns a 128-byte box
constexpr int NBOX = LATENT / COLS;
constexpr int BM = 64;   // query rows a tile
constexpr int BN = 64;   // latent positions a tile
constexpr int QROWS = 16;  // query rows a TMA box
constexpr int BOX_TILE = BN * BOX_BYTES;               // one 64-row box: 8192
constexpr uint32_t TILE_BYTES = NBOX * BOX_TILE;       // 73,728
constexpr int STAGES = 2;
constexpr int THREADS = 256;  // two warpgroups
constexpr int HALF = RANK / 2;  // output columns a warpgroup
constexpr int NT = HALF / 8;    // n8 tiles a warp
constexpr int SPLIT = BN / 2;   // positions a warpgroup scores
// Beside the tiles: 5 mbarriers (64 B), the warpgroups' row maxima and sums
// [2][64] f32, and a mailbox of probability fragments [2 k16 steps][256
// threads] x 16 B.
constexpr size_t SMEM = 1024 + (1 + STAGES) * static_cast<size_t>(TILE_BYTES) + 64 +
                        2 * BM * 4 + 2 * THREADS * 16;
constexpr int MERGE_THREADS = RANK / 4;

static_assert(SMEM <= 232448, "shared memory");

// Profiling builds (-DMLA_DECODE_PROFILE, cli/profile_mla_decode.py --phases)
// sum the clock64 cycles thread 0 of each block spends issuing the next
// tile's loads, waiting for a tile, in the scores' wgmma, in the softmax,
// in the values' wgmma, and in the whole item; slot 6 counts tiles, slot 7
// blocks.
#ifdef MLA_DECODE_PROFILE
__device__ unsigned long long g_profile[8];
#define PROFILE_NOW(t) const long long t = clock64()
#define PROFILE_ADD(slot, t0) prof[slot] += clock64() - (t0)
#else
#define PROFILE_NOW(t)
#define PROFILE_ADD(slot, t0)
#endif

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

#define WG_D8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                 "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (+)= A[64 x 16] . B[32 x 16]^T, both K-major bf16 in shared memory.
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
      ", %16, %17, p, 1, 1, 0, 0;\n}\n"
      : WG_D8(0), WG_D8(8)
      : "l"(da), "l"(db), "r"(1));
}

#undef WG_D8

// Shared-memory descriptor of an MN-major operand with 128B swizzle: rows
// of 128 bytes (64 bf16 along N), 8-row groups along K 1024 bytes apart,
// 64-column blocks along N `block` bytes apart.
__device__ __forceinline__ uint64_t sw128_desc_mn(uint32_t addr, uint32_t block) {
  uint64_t d = 0;
  d |= static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>(block >> 4) << 16;  // leading offset: the next 64 columns
  d |= static_cast<uint64_t>(1024 >> 4) << 32;   // stride offset: the next 8 rows of K
  d |= static_cast<uint64_t>(1) << 62;           // 128B swizzle
  return d;
}

#define WG_D8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                 "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d += A[64 x 16] . B[16 x 256]: A bf16 in registers (the m16n8k16 A
// fragment of each warp's 16 rows), B bf16 MN-major in shared memory.
__device__ __forceinline__ void wgmma_m64n256k16_rs(float (&d)[128], const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %133, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
      "%124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32), WG_D8(40), WG_D8(48),
        WG_D8(56), WG_D8(64), WG_D8(72), WG_D8(80), WG_D8(88), WG_D8(96), WG_D8(104),
        WG_D8(112), WG_D8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef WG_D8

// Barrier 1 over the block's two warpgroups (barrier 0 is __syncthreads).
__device__ __forceinline__ void named_barrier() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS) : "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The work items of one launch: P * sp * row_tiles prompt items (row tile
// fastest, then the split), then S * gs * head_tiles own items.
struct Items {
  int P, group, heads, rows;  // rows = P * group * heads
  int t, row_tiles, sp, chunk, head_tiles, gs;  // chunk: positions a split
};

__global__ void __launch_bounds__(THREADS, 1)
mla_decode_kernel(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_prompt,
                  const __grid_constant__ CUtensorMap tm_gen, const int64_t* __restrict__ lens,
                  const Items it, float scale, float* __restrict__ part_acc,
                  float2* __restrict__ part_ml) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* sq = smem;               // [9 boxes][64 rows][128 B]
  unsigned char* ring = smem + TILE_BYTES;  // STAGES x [9 boxes][64 positions][128 B]
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + STAGES * TILE_BYTES);
  // bars[s]: stage s is full; bars[STAGES + s]: stage s is free; bars[4]: q.
  float* red = reinterpret_cast<float*>(ring + STAGES * TILE_BYTES + 64);  // [2][64]
  uint4* mail = reinterpret_cast<uint4*>(red + 2 * BM);  // [2][THREADS]

  // ---- the item ----
  int b = blockIdx.x, r0, live, lo, hi, split, z;
  const CUtensorMap* src;
  const int prompt_items = it.P * it.sp * it.row_tiles;
  if (b < prompt_items) {
    const int rt = b % it.row_tiles;
    b /= it.row_tiles;
    split = b % it.sp;
    z = b / it.sp;
    const int per = it.group * it.heads;
    r0 = z * per + rt * BM;
    live = min(BM, per - rt * BM);
    lo = split * it.chunk;
    hi = min(lo + it.chunk, static_cast<int>(lens[z]));
    src = &tm_prompt;
  } else {
    b -= prompt_items;
    const int ht = b % it.head_tiles;
    b /= it.head_tiles;
    const int gsplit = b % it.gs;
    z = b / it.gs;
    r0 = z * it.heads + ht * BM;
    live = min(BM, it.heads - ht * BM);
    lo = gsplit * it.chunk;
    hi = min(lo + it.chunk, it.t + 1);
    split = it.sp + gsplit;
    src = &tm_gen;
  }
  const int n_tiles = hi > lo ? (hi - lo + BN - 1) / BN : 0;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&bars[s]), 1);
      mbar_init(smem_u32(&bars[STAGES + s]), THREADS / 32);  // one arrival a warp
    }
    mbar_init(smem_u32(&bars[2 * STAGES]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Tile j's loads into stage j % STAGES, once every warp has freed it.
  auto issue = [&](int j) {
    const int s = j % STAGES;
    if (j >= STAGES) mbar_wait(smem_u32(&bars[STAGES + s]), ((j / STAGES) - 1) & 1);
    const uint32_t full = smem_u32(&bars[s]);
    mbar_expect_tx(full, TILE_BYTES);
    const uint32_t dst = smem_u32(ring + s * TILE_BYTES);
    for (int c = 0; c < NBOX; ++c)
      tma_load_3d(dst + c * BOX_TILE, src, full, c * COLS, lo + j * BN, z);
  };
  if (tid == 0 && n_tiles > 0) {
    const int groups = (live + QROWS - 1) / QROWS;
    const uint32_t qbar = smem_u32(&bars[2 * STAGES]);
    mbar_expect_tx(qbar, groups * NBOX * QROWS * BOX_BYTES);
    for (int g = 0; g < groups; ++g)
      for (int c = 0; c < NBOX; ++c)
        tma_load_2d(smem_u32(sq + c * BOX_TILE + g * QROWS * BOX_BYTES), &tm_q, qbar,
                    c * COLS, r0 + g * QROWS);
    issue(0);
  }

  const int wg = tid >> 7;  // which half of the 512 output columns
  const int lane = tid & 31;
  const int wrow = ((tid >> 5) & 3) * 16;  // the warp's first row in the tile
  const int ra = lane >> 2, sub = lane & 3;  // rows ra, ra + 8 of the warp; column pair sub
  const bool warp_live = wrow < live;

  // o[4 i + 2 h + e]: row ra + 8 h, column 8 i + 2 sub + e of the warpgroup's half.
  float o[4 * NT];
#pragma unroll
  for (int i = 0; i < 4 * NT; ++i) o[i] = 0.f;
  float m[2] = {neg_inf(), neg_inf()}, l[2] = {0.f, 0.f};

#ifdef MLA_DECODE_PROFILE
  unsigned long long prof[6] = {0, 0, 0, 0, 0, 0};
#endif
  PROFILE_NOW(t_item);
  if (n_tiles > 0) mbar_wait(smem_u32(&bars[2 * STAGES]), 0);
  const uint64_t dq = sw128_desc(smem_u32(sq));
  const float c2 = scale * 1.4426950408889634f;  // scores in log2 units: exp2(c2 s) = e^(scale s)
  const int partner = tid ^ 128;  // the thread of the other warpgroup with the same rows

  for (int j = 0; j < n_tiles; ++j) {
    PROFILE_NOW(t_issue);
    if (tid == 0 && j + 1 < n_tiles) issue(j + 1);
    __syncwarp();
    PROFILE_ADD(0, t_issue);
    PROFILE_NOW(t_wait);
    const int s = j % STAGES;
    mbar_wait(smem_u32(&bars[s]), (j / STAGES) & 1);
    PROFILE_ADD(1, t_wait);
    PROFILE_NOW(t_scores);
    const uint32_t tile = smem_u32(ring + s * TILE_BYTES);
    // This warpgroup's 32 positions: rows 32 wg .. of the tile's boxes.
    const uint64_t dk = sw128_desc(tile + wg * SPLIT * BOX_BYTES);

    float d[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) d[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < NBOX; ++c)
#pragma unroll
      for (int k = 0; k < COLS / 16; ++k) {
        const uint64_t step = c * (BOX_TILE >> 4) + 2 * k;  // descriptor units of 16 B
        wgmma_m64n32k16(d, dq + step, dk + step);
      }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(d);
    PROFILE_ADD(2, t_scores);
    PROFILE_NOW(t_softmax);

    // d[4 jj + 2 h + e]: row ra + 8 h, position 32 wg + 8 jj + 2 sub + e of
    // the tile. Dead rows (past `live`) compute on whatever the query tile
    // holds there and are never written.
    const int pos0 = lo + j * BN + wg * SPLIT + 2 * sub;
    float mx[2] = {neg_inf(), neg_inf()};
#pragma unroll
    for (int jj = 0; jj < SPLIT / 8; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& v = d[4 * jj + 2 * h + e];
          v = pos0 + 8 * jj + e < hi ? v * c2 : neg_inf();
          mx[h] = fmaxf(mx[h], v);
        }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      if (sub == 0) red[wg * BM + wrow + ra + 8 * h] = mx[h];
    }
    named_barrier();  // both halves' row maxima
    float alpha[2];
    bool moved = false;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float mn = fmaxf(m[h], fmaxf(mx[h], red[(wg ^ 1) * BM + wrow + ra + 8 * h]));
      const bool none = !(mn > neg_inf());  // nothing seen yet in this row
      alpha[h] = none ? 1.f : exp2f(m[h] - mn);
      moved |= mn != m[h];
      m[h] = mn;
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < SPLIT / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& v = d[4 * jj + 2 * h + e];
          v = none ? 0.f : exp2f(v - mn);
          sum += v;
        }
      l[h] = l[h] * alpha[h] + sum;
    }
    if (__any_sync(0xffffffffu, moved)) {
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        o[4 * i + 0] *= alpha[0];
        o[4 * i + 1] *= alpha[0];
        o[4 * i + 2] *= alpha[1];
        o[4 * i + 3] *= alpha[1];
      }
    }
    // The probabilities as bf16 A fragments, 16 positions each: this
    // warpgroup's two, and the partner's two through the mailbox.
    uint32_t own[2][4], other[2][4];  // [k16 step][register]
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      own[kk][0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
      own[kk][1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
      own[kk][2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
      own[kk][3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
      mail[kk * THREADS + tid] = make_uint4(own[kk][0], own[kk][1], own[kk][2], own[kk][3]);
    }
    named_barrier();  // both halves' fragments
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const uint4 v = mail[kk * THREADS + partner];
      other[kk][0] = v.x;
      other[kk][1] = v.y;
      other[kk][2] = v.z;
      other[kk][3] = v.w;
    }
    // The tile's four k16 steps: warpgroup 0 scored positions 0-31.
    uint32_t a[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        a[kk][r] = wg == 0 ? own[kk][r] : other[kk][r];
        a[kk + 2][r] = wg == 0 ? other[kk][r] : own[kk][r];
      }
    // Values: the tile's first 512 columns, this warpgroup's half (4 boxes),
    // read as an MN-major operand: 16 positions (2 KB of rows) a step.
    const uint32_t vbase = tile + wg * (HALF / COLS) * BOX_TILE;
    PROFILE_ADD(3, t_softmax);
    PROFILE_NOW(t_values);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_m64n256k16_rs(o, a[kk], sw128_desc_mn(vbase + kk * 16 * BOX_BYTES, BOX_TILE));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    PROFILE_ADD(4, t_values);
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(&bars[STAGES + s]));
  }

  // Each warpgroup summed its own positions: the row sums are the two halves'.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  named_barrier();  // every read of the last tile's maxima is done
  if (sub == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h) red[wg * BM + wrow + ra + 8 * h] = l[h];
  named_barrier();
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] += red[(wg ^ 1) * BM + wrow + ra + 8 * h];
  PROFILE_ADD(5, t_item);
#ifdef MLA_DECODE_PROFILE
  if (tid == 0) {
    for (int i = 0; i < 6; ++i) atomicAdd(&g_profile[i], prof[i]);
    atomicAdd(&g_profile[6], static_cast<unsigned long long>(n_tiles));
    atomicAdd(&g_profile[7], 1ull);
  }
#endif
  if (!warp_live) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = wrow + ra + 8 * h;
    if (row >= live) continue;
    const size_t grow = static_cast<size_t>(split) * it.rows + r0 + row;
    float* dst = part_acc + grow * RANK + wg * HALF + 2 * sub;
#pragma unroll
    for (int i = 0; i < NT; ++i)
      *reinterpret_cast<float2*>(dst + 8 * i) = make_float2(o[4 * i + 2 * h],
                                                            o[4 * i + 2 * h + 1]);
    if (wg == 0 && sub == 0) part_ml[grow] = make_float2(m[h], l[h]);
  }
}

// One row a block: the row's n_parts partials (max, sum, unnormalised
// values) combined in float32, written in bf16.
__global__ void __launch_bounds__(MERGE_THREADS)
merge_kernel(const float* __restrict__ part_acc, const float2* __restrict__ part_ml,
             int n_parts, int rows, __nv_bfloat16* __restrict__ out) {
  const int row = blockIdx.x;
  const int col = threadIdx.x * 4;
  float mx = neg_inf();
  for (int k = 0; k < n_parts; ++k) mx = fmaxf(mx, part_ml[static_cast<size_t>(k) * rows + row].x);
  float sum = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k = 0; k < n_parts; ++k) {
    const size_t g = static_cast<size_t>(k) * rows + row;
    const float2 ml = part_ml[g];
    if (ml.x == neg_inf()) continue;  // an item with no position
    const float w = exp2f(ml.x - mx);  // maxima in log2 units
    sum += w * ml.y;
    const float4 v = *reinterpret_cast<const float4*>(part_acc + g * RANK + col);
    acc.x += w * v.x;
    acc.y += w * v.y;
    acc.z += w * v.z;
    acc.w += w * v.w;
  }
  const float inv = 1.f / sum;
  uint2 packed;
  packed.x = pack_bf16(acc.x * inv, acc.y * inv);
  packed.y = pack_bf16(acc.z * inv, acc.w * inv);
  *reinterpret_cast<uint2*>(out + static_cast<size_t>(row) * RANK + col) = packed;
}

// [z, n, 576] bf16 with z's stride `zstride` rows, seen in boxes of
// box_rows x 64 columns x 1, 128B swizzle; reads past n return zeros.
cudaError_t encode_3d(CUtensorMap* map, const void* ptr, int z, int n, int zstride,
                      int box_rows) {
  EncodeTiled fn;
  cudaError_t err = encoder(&fn);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[3] = {LATENT, static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(z)};
  const cuuint64_t strides[2] = {LATENT * 2, static_cast<cuuint64_t>(zstride) * LATENT * 2};
  const cuuint32_t box[3] = {COLS, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q [S * heads, 576], prompt [P, Lp, 576], gen [S, T, 576], all bf16,
// contiguous and 16-byte aligned; lens [P] int64 on the device (1 <= lens
// <= Lp); S = P * group. prompt[p, lens[p]:] must be finite (the prefill
// leaves zeros): a masked position's value still enters the product, with
// probability 0. part_acc [sp + gs, S * heads, 512] and part_ml
// [sp + gs, S * heads, 2] f32 scratch; out [S * heads, 512] bf16. The plan
// (row_tiles = ceil(group * heads / 64), head_tiles = ceil(heads / 64),
// chunk a multiple of 64, sp * chunk >= Lp, gs * chunk >= t + 1) is
// ops/mla_decode.py::plan's.
int rag_mla_decode(const void* q, const void* prompt, const void* lens, const void* gen,
                   int P, int group, int heads, int Lp, int T, int t, float scale,
                   int row_tiles, int sp, int chunk, int head_tiles, int gs, void* part_acc,
                   void* part_ml, void* out, void* stream) {
  if (P < 1 || group < 1 || heads < 1 || Lp < 1 || t < 0 || t >= T || chunk % BN != 0 ||
      row_tiles * BM < group * heads || head_tiles * BM < heads ||
      static_cast<int64_t>(sp) * chunk < Lp || static_cast<int64_t>(gs) * chunk < t + 1)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int S = P * group;
  const Items it{P, group, heads, S * heads, t, row_tiles, sp, chunk, head_tiles, gs};
  CUtensorMap tm_q, tm_prompt, tm_gen;
  cudaError_t err = encode(&tm_q, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, q, S * heads, LATENT,
                           QROWS);
  if (err == cudaSuccess) err = encode_3d(&tm_prompt, prompt, P, Lp, Lp, BN);
  if (err == cudaSuccess) err = encode_3d(&tm_gen, gen, S, t + 1, T, BN);
  if (err != cudaSuccess) return err;
  // The shared-memory limit is set once a device (bit d for device d).
  static std::atomic<uint64_t> allowed{0};
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? 1ull << dev : 0;
  if (!(allowed.load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(mla_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(SMEM));
    if (err != cudaSuccess) return err;
    allowed.fetch_or(bit, std::memory_order_release);
  }
  const int items = P * sp * row_tiles + S * gs * head_tiles;
  mla_decode_kernel<<<items, THREADS, SMEM, s>>>(
      tm_q, tm_prompt, tm_gen, static_cast<const int64_t*>(lens), it, scale,
      static_cast<float*>(part_acc), static_cast<float2*>(part_ml));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  merge_kernel<<<S * heads, MERGE_THREADS, 0, s>>>(
      static_cast<const float*>(part_acc), static_cast<const float2*>(part_ml), sp + gs,
      S * heads, static_cast<__nv_bfloat16*>(out));
  return cudaGetLastError();
}

#ifdef MLA_DECODE_PROFILE
// Copy the eight profile counters to out (host memory) and zero them.
int rag_mla_decode_profile(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_profile, sizeof(g_profile));
  if (err != cudaSuccess) return err;
  const unsigned long long zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  return cudaMemcpyToSymbol(g_profile, zero, sizeof(g_profile));
}
#endif

}  // extern "C"
