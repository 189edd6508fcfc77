// Kimi Delta Attention (KDA) decode step over each slot's recurrent state,
// for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no linear attention. It
// replaces the plain chain ops/kda.py::kda_decode_plain (the short
// convolution, SiLU, the L2 norms, the gate, beta, the decay, the delta
// update, the readout and the gated RMSNorm, each an eager op), which the
// generator's decode step (llm/kimi_linear.py::KimiLinearModel._kda_decode)
// runs at every KDA layer.
//
// Function. Slot r and head h (K = V = 128 channels) take from the
// projections: x[r] (the q, k, v inputs of the head's channels, bf16),
// the slot's conv tail (its last 3 inputs of those channels), f[r] (the
// decay's low-rank projection), beta[r, h] and gate[r] (logits). Then, in
// float32:
//   q, k, v = SiLU(sum_i conv_w[c, i] window[i])      (window: tail, x)
//   q = q / sqrt(|q|^2 + 1e-6) / sqrt(K),  k = k / sqrt(|k|^2 + 1e-6)
//   g = -exp(A_log[h]) softplus(f + dt_bias),  b = sigmoid(beta)
//   S = Diag(exp g) S;  S += k (b (v - S^T k))^T;  o = S^T q
//   out = o / sqrt(mean(o^2) + eps) * norm_w * sigmoid(gate)   (bf16)
// The tail moves one input on and the state S [K, V] f32 is written back,
// both in place.
//
// Bound. The step is bound by the state's bytes: at the generator's shape
// (320 slots, 32 heads) each layer reads and writes 320 x 32 x 64 KiB =
// 671 MB twice, 0.40 ms at 3.35 TB/s; everything else a slot reads or
// writes (the projections, the tail, the output, about 100 KB) is under
// 4% of it, and the arithmetic (about 6 operations a state element) is
// under 0.3 ms of the card's float32 rate.
//
// Design. One block of 128 threads a (head, slot): thread t owns the
// state's column t (value channel t, 128 floats held in registers) and the
// head's key channel t for the per-channel work before it. So the state is
// read once and written once, coalesced (a warp's 32 columns of one row
// are 128 contiguous bytes), and the two reductions over the key channels
// (S^T k and S^T q) stay inside a thread: the only reductions across the
// block are the three sums of squares (q, k, o), by warp shuffles and four
// floats of shared memory. q, k and the decays reach every thread through
// shared memory. The state is float32 as the model keeps it; nothing is
// staged, since each state element is used by one thread only.
//
// Interface: plain C, launched on the caller's stream, returns
// cudaGetLastError(). No PyTorch header.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int KD = 128;  // key and value channels of a head
constexpr int TAPS = 4;  // the short convolution's width
constexpr int THREADS = KD;
constexpr int WARPS = THREADS / 32;
constexpr float L2_EPS = 1e-6f;

__device__ __forceinline__ float bf(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// The block's sum of x; red holds WARPS floats.
__device__ __forceinline__ float block_sum(float x, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  __syncthreads();  // an earlier sum's readers are done with red
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) s += red[w];
  return s;
}

__global__ void __launch_bounds__(THREADS) kda_decode_kernel(
    const __nv_bfloat16* __restrict__ x, long long x_ld, __nv_bfloat16* __restrict__ tail,
    const __nv_bfloat16* __restrict__ conv_w, const __nv_bfloat16* __restrict__ f,
    long long f_ld, const float* __restrict__ a_log, const float* __restrict__ dt_bias,
    const __nv_bfloat16* __restrict__ beta, long long beta_ld,
    const __nv_bfloat16* __restrict__ gate, long long gate_ld,
    const __nv_bfloat16* __restrict__ norm_w, float* __restrict__ state,
    __nv_bfloat16* __restrict__ out, int heads, float eps) {
  __shared__ float sq[KD], sk[KD], sdecay[KD];
  __shared__ float red[WARPS];
  const int h = blockIdx.x, t = threadIdx.x;
  const long long row = blockIdx.y;
  const long long width = 3LL * heads * KD;  // q, k and v channels of a slot

  // The short convolution of the head's channel t of q, k and v.
  const __nv_bfloat16* xr = x + row * x_ld;
  __nv_bfloat16* tr = tail + row * (TAPS - 1) * width;
  float c[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const long long ch = (j * heads + h) * static_cast<long long>(KD) + t;
    __nv_bfloat16 win[TAPS];
#pragma unroll
    for (int i = 0; i < TAPS - 1; ++i) win[i] = tr[i * width + ch];
    win[TAPS - 1] = xr[ch];
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < TAPS; ++i) acc += bf(win[i]) * bf(conv_w[ch * TAPS + i]);
    c[j] = acc * sigmoid(acc);
#pragma unroll
    for (int i = 0; i < TAPS - 1; ++i) tr[i * width + ch] = win[i + 1];
  }

  // The norms, the decay of key channel t, beta.
  const float qq = block_sum(c[0] * c[0], red);
  const float kk = block_sum(c[1] * c[1], red);
  const float fa = bf(f[row * f_ld + h * KD + t]) + dt_bias[h * KD + t];
  const float softplus = fa > 20.f ? fa : log1pf(expf(fa));  // torch's threshold
  sq[t] = c[0] * rsqrtf(qq + L2_EPS) * rsqrtf(static_cast<float>(KD));
  sk[t] = c[1] * rsqrtf(kk + L2_EPS);
  sdecay[t] = expf(-expf(a_log[h]) * softplus);
  const float b = sigmoid(bf(beta[row * beta_ld + h]));
  __syncthreads();

  // Column t of the state: decay and S^T k, then the update and S^T q.
  float* st = state + ((row * heads + h) * KD) * KD + t;
  float s[KD];
  float ks = 0.f;
#pragma unroll
  for (int i = 0; i < KD; ++i) {
    s[i] = st[i * KD] * sdecay[i];
    ks += sk[i] * s[i];
  }
  const float w = b * (c[2] - ks);
  float o = 0.f;
#pragma unroll
  for (int i = 0; i < KD; ++i) {
    s[i] += sk[i] * w;
    o += sq[i] * s[i];
    st[i * KD] = s[i];
  }

  // The gated RMSNorm over the head's value channels.
  const float oo = block_sum(o * o, red);
  const float y = o * rsqrtf(oo / KD + eps) * bf(norm_w[t]) *
                  sigmoid(bf(gate[row * gate_ld + h * KD + t]));
  out[(row * heads + h) * KD + t] = __float2bfloat16(y);
}

}  // namespace

extern "C" int rag_kda_decode(const void* x, long long x_ld, void* tail, const void* conv_w,
                              const void* f, long long f_ld, const void* a_log,
                              const void* dt_bias, const void* beta, long long beta_ld,
                              const void* gate, long long gate_ld, const void* norm_w,
                              void* state, void* out, int rows, int heads, float eps,
                              void* stream) {
  if (rows <= 0 || heads <= 0) return 0;
  const dim3 grid(heads, rows);
  kda_decode_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), x_ld, static_cast<__nv_bfloat16*>(tail),
      static_cast<const __nv_bfloat16*>(conv_w), static_cast<const __nv_bfloat16*>(f), f_ld,
      static_cast<const float*>(a_log), static_cast<const float*>(dt_bias),
      static_cast<const __nv_bfloat16*>(beta), beta_ld, static_cast<const __nv_bfloat16*>(gate),
      gate_ld, static_cast<const __nv_bfloat16*>(norm_w), static_cast<float*>(state),
      static_cast<__nv_bfloat16*>(out), heads, eps);
  return static_cast<int>(cudaGetLastError());
}
