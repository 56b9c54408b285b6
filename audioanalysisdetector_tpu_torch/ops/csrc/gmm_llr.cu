// The fused scorer's GMM arm in one launch, fp32, for Hopper (sm_90a): both
// diagonal GMMs' log-likelihoods of every frame, the padding mask and the
// per-utterance masked mean of their difference.
//
// Replaces no kernel of the JAX package (it has no Pallas GMM; XLA computes
// it). It replaces the port's plain arm, score/fused.py::padding_mask then
// models/gmm.py::masked_llr: per GMM two SGEMMs of K = 19 and some ten
// elementwise and reduction passes, each over a whole (N, 128) fp32 matrix
// (264 MB at the fused scorer's N = 8192 x 63 frames), ~4.8 ms a call.
//
// What it computes. Frames x (B, T, D) fp32, contiguous; two GMMs (weights
// (K), means and variances (K, D), fp32, contiguous), "spoof" (g = 0) and
// "genuine" (g = 1). For each utterance b:
//   m[t]    = (sum_d x[b,t,d] != 0), the sum taken in index order
//   LL_g(x) = logsumexp_k (log w_k - 0.5 (D log 2pi + sum_d log var_kd
//                                          + sum_d (x_d - mu_kd)^2 / var_kd))
//   llr[b]  = sum_t m[t] (LL_0 - LL_1)(x[b,t]) / max(sum_t m[t], 1)
//   empty[b] = (sum_t m[t] == 0)
// which is masked_llr(x, padding_mask(x), spoof, genuine) and the fused
// scorer's empty-row test.
//
// Bound. Both GMMs' log-densities take 2 T K 3 D operations an utterance
// (portbench's gmm_pair_ops: 0.919 MFLOP at T = 63, K = 128, D = 19; 7.53
// GFLOP at B = 8192, 0.112 ms at 67 TFLOP/s), and the frames are read once
// (39 MB, 0.012 ms at 3.35 TB/s): operations bound it. The kernel issues
// 2 T K 2 DP FFMA an utterance (DP = D rounded up to a multiple of 4), ~4/3
// of the count's operations, and about one exp2f a component and frame on
// the separate SFU pipe.
//
// Design:
//  1. Tables, built in each block's prologue from the raw GMMs, in double,
//     then rounded to float, in base 2 (log2 e folded in):
//       a_kd = -0.5 log2(e) / var_kd,   b_kd = log2(e) mu_kd / var_kd,
//       c_k  = log2(e) (log w_k - 0.5 (D log 2pi + sum_d log var_kd
//                                      + sum_d mu_kd^2 / var_kd)),
//     so that log2(w_k p_k(x)) = c_k + sum_d x_d fma(x_d, a_kd, b_kd): two
//     FFMA per (k, d), the quadratic expansion models/gmm.py uses. A row
//     holds DP/2 float4 (a_d, b_d, a_d+1, b_d+1), zeros past D; K is padded
//     to a multiple of the chunk C with rows of zeros and c = -inf. Both
//     GMMs' tables (2 Kp (2 DP + 1) floats: 41 KB at D = 19, K = 128)
//     stay in shared memory and are read as warp-wide broadcasts. Building
//     them costs no launch and, by count, ~1% of a block's work (the grid
//     is persistent, below), and nothing is cached between calls.
//  2. Frames in registers: a warp scores two utterances at a time, 16 lanes
//     each, and lane l of the 16 holds F = 4 frames (t = l + 16 f of a 64-frame
//     pass; T > 64 loops over passes). Each broadcast float4 of a table row
//     then feeds 4 F = 16 FFMA, so the FFMA pipe and not shared memory sets
//     the pace. A pass's frames are staged through a per-warp buffer by
//     coalesced loads, at an odd frame stride (D | 1), so the lanes' reads
//     of their frames fall in distinct banks.
//  3. Logsumexp online over chunks of C = 8 components: the chunk's max,
//     one rescale of the running sum, then C terms; about 9/8 exp2f a
//     component. exp2f and log2f are the accurate ones (no fast math): the
//     result is held to a float64 reference at 5e-5, and the final
//     difference is taken back to natural log by one multiply by ln 2.
//  4. The mask sums a frame's D registers in index order; an all-zero
//     padded frame sums to exactly 0 in any order.
//  5. Each utterance's masked sum and count are reduced over its 16 lanes
//     by xor shuffles in a fixed order: nothing crosses warps, there are no
//     atomics, and the result is the same bit for bit from run to run.
//  6. The grid is persistent: as many 256-thread blocks as fit the card at
//     once, each walking utterance pairs with a stride, so the tables are
//     built once a block.
//
// Limits: D <= 32 and K <= 256 per GMM (both tables: at most 133 KB of
// shared memory, plus 8 warps x 2 x 64 frames x 33 floats: 200 KB in all).
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; B = 8192, T = 63, D = 19, K = 128):
// 0.345 ms, 33% of the bound, in place of the plain arm's 4.80 ms; 181
// registers, one block an SM. Variants with 2 frames a lane, one utterance
// a warp or 16 warps an SM ran as fast (0.328-0.333 ms), so neither the
// broadcast table loads nor latency bound it: it issues FFMA at ~54% of the
// card's rate, with ~80% FFMA in its instruction mix.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int HALVES = 2;             // utterances a warp scores at once
constexpr int LANES = 32 / HALVES;    // lanes an utterance
constexpr int F = 4;                  // frames a lane holds
constexpr int SPAN = LANES * F;       // frames of an utterance a pass covers
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int C = 8;                  // components a chunk of the online logsumexp
constexpr int MAX_D = 32;
constexpr int MAX_K = 256;
constexpr unsigned FULL = 0xffffffffu;
constexpr double LOG2E = 1.4426950408889634074;
constexpr double LOG_2PI = 1.8378770664093454836;
constexpr float LN2 = 0.693147180559945309f;

struct Gmm {
  const float* w;
  const float* mu;
  const float* var;
  int k;
};

__host__ __device__ constexpr int round_up(int a, int b) { return (a + b - 1) / b * b; }

// Shared memory, in floats: both GMMs' rows (Kp_g x 2 DP), then both c
// vectors (Kp_g), then each warp's frame buffer (HALVES x SPAN frames of
// stride D | 1). Kp is a multiple of 8 and DP of 4, so every table offset
// is 16-byte aligned.
struct Layout {
  int kp0, kp1, rows1, c0, c1, frames, total;
  __host__ __device__ Layout(int dp, int d, int k0, int k1)
      : kp0(round_up(k0, C)), kp1(round_up(k1, C)), rows1(kp0 * 2 * dp), c0(rows1 + kp1 * 2 * dp),
        c1(c0 + kp0), frames(c1 + kp1), total(frames + WARPS * HALVES * SPAN * (d | 1)) {}
};

template <int DP>
__device__ void build_tables(float* smem, const Layout& L, const Gmm& g0, const Gmm& g1, int D) {
  for (int i = threadIdx.x; i < L.kp0 + L.kp1; i += THREADS) {
    const bool second = i >= L.kp0;
    const Gmm& g = second ? g1 : g0;
    const int k = second ? i - L.kp0 : i;
    float4* row = reinterpret_cast<float4*>(smem + (second ? L.rows1 : 0)) + k * (DP / 2);
    double logdet = 0.0, quad = 0.0;
    for (int j = 0; j < DP / 2; ++j) {
      double ab[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int d = 2 * j + h;
        if (k < g.k && d < D) {
          const double v = g.var[k * D + d], mu = g.mu[k * D + d];
          ab[2 * h] = -0.5 * LOG2E / v;
          ab[2 * h + 1] = LOG2E * mu / v;
          logdet += log(v);
          quad += mu * mu / v;
        }
      }
      row[j] = make_float4((float)ab[0], (float)ab[1], (float)ab[2], (float)ab[3]);
    }
    smem[(second ? L.c1 : L.c0) + k] =
        k < g.k ? (float)(LOG2E * (log((double)g.w[k]) - 0.5 * (D * LOG_2PI + logdet + quad))) : -CUDART_INF_F;
  }
}

// log2 of one GMM's likelihood of a lane's F frames.
template <int DP>
__device__ __forceinline__ void log2_likelihood(const float4* __restrict__ rows, const float* __restrict__ c, int kp,
                                                const float (&x)[F][DP], float (&ll)[F]) {
  float m[F], s[F];
#pragma unroll
  for (int f = 0; f < F; ++f) {
    m[f] = -CUDART_INF_F;
    s[f] = 0.0f;
  }
#pragma unroll 1
  for (int k0 = 0; k0 < kp; k0 += C) {
    float acc[C][F];
    const float4 ca = *reinterpret_cast<const float4*>(c + k0);
    const float4 cb = *reinterpret_cast<const float4*>(c + k0 + 4);
    const float cc[C] = {ca.x, ca.y, ca.z, ca.w, cb.x, cb.y, cb.z, cb.w};
#pragma unroll
    for (int i = 0; i < C; ++i)
#pragma unroll
      for (int f = 0; f < F; ++f) acc[i][f] = cc[i];
    const float4* r = rows + k0 * (DP / 2);
#pragma unroll
    for (int j = 0; j < DP / 2; ++j)
#pragma unroll
      for (int i = 0; i < C; ++i) {
        const float4 t = r[i * (DP / 2) + j];
#pragma unroll
        for (int f = 0; f < F; ++f) {
          acc[i][f] = fmaf(x[f][2 * j], fmaf(x[f][2 * j], t.x, t.y), acc[i][f]);
          acc[i][f] = fmaf(x[f][2 * j + 1], fmaf(x[f][2 * j + 1], t.z, t.w), acc[i][f]);
        }
      }
#pragma unroll
    for (int f = 0; f < F; ++f) {
      float mc = m[f];
#pragma unroll
      for (int i = 0; i < C; ++i) mc = fmaxf(mc, acc[i][f]);
      if (mc > -CUDART_INF_F) {  // else every term so far is 0
        float sum = s[f] * exp2f(m[f] - mc);
#pragma unroll
        for (int i = 0; i < C; ++i) sum += exp2f(acc[i][f] - mc);
        s[f] = sum;
        m[f] = mc;
      }
    }
  }
#pragma unroll
  for (int f = 0; f < F; ++f) ll[f] = m[f] + log2f(s[f]);
}

template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
    gmm_llr_kernel(const float* __restrict__ x, int n_rows, int T, int D, Gmm g0, Gmm g1,
                   float* __restrict__ llr, unsigned char* __restrict__ empty) {
  extern __shared__ __align__(16) float smem[];
  const Layout L(DP, D, g0.k, g1.k);
  build_tables<DP>(smem, L, g0, g1, D);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int half = lane / LANES, hl = lane % LANES;
  const int S = D | 1;
  float* buf = smem + L.frames + (warp * HALVES + half) * SPAN * S;
  const int pairs = (n_rows + HALVES - 1) / HALVES;

  for (int pair = blockIdx.x * WARPS + warp; pair < pairs; pair += gridDim.x * WARPS) {
    const int u = pair * HALVES + half;
    const bool live = u < n_rows;
    const float* xu = x + (size_t)(live ? u : 0) * T * D;
    float sum = 0.0f;
    int count = 0;
    for (int t0 = 0; t0 < T; t0 += SPAN) {
      const int n = live ? min(SPAN, T - t0) : 0;
      const float* src = xu + (size_t)t0 * D;
      __syncwarp();  // the last pass's reads of the buffer are done
      if (S == D) {
        for (int i = hl; i < n * D; i += LANES) buf[i] = src[i];
      } else {
        for (int i = hl; i < n * D; i += LANES) buf[i + i / D] = src[i];
      }
      __syncwarp();

      float xr[F][DP];
      bool valid[F];
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const int t = hl + LANES * f;
        float tot = 0.0f;
#pragma unroll
        for (int d = 0; d < DP; ++d) {
          xr[f][d] = (t < n && d < D) ? buf[t * S + d] : 0.0f;
          tot += xr[f][d];
        }
        valid[f] = tot != 0.0f;
      }
      float ll[F], diff[F];
#pragma unroll 1
      for (int g = 0; g < 2; ++g) {
        log2_likelihood<DP>(reinterpret_cast<const float4*>(smem + (g ? L.rows1 : 0)), smem + (g ? L.c1 : L.c0),
                            g ? L.kp1 : L.kp0, xr, ll);
#pragma unroll
        for (int f = 0; f < F; ++f) diff[f] = g ? diff[f] - ll[f] : ll[f];
      }
#pragma unroll
      for (int f = 0; f < F; ++f)
        if (valid[f]) {
          sum += diff[f];
          ++count;
        }
    }
#pragma unroll
    for (int o = LANES / 2; o; o /= 2) {
      sum += __shfl_xor_sync(FULL, sum, o);
      count += __shfl_xor_sync(FULL, count, o);
    }
    if (live && hl == 0) {
      llr[u] = LN2 * sum / fmaxf((float)count, 1.0f);
      empty[u] = count == 0;
    }
  }
}

template <int DP>
int launch(const float* x, int n_rows, int T, int D, const Gmm& g0, const Gmm& g1, float* llr,
           unsigned char* empty, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)Layout(DP, D, g0.k, g1.k).total;
  cudaError_t err = cudaFuncSetAttribute(gmm_llr_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(gmm_llr_kernel<DP>, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gmm_llr_kernel<DP>, THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int pairs = (n_rows + HALVES - 1) / HALVES;
  const int grid = min((pairs + WARPS - 1) / WARPS, per_sm * sms);
  gmm_llr_kernel<DP><<<grid, THREADS, smem, stream>>>(x, n_rows, T, D, g0, g1, llr, empty);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (n_rows, T, D) fp32 frames, contiguous, 1 <= D <= 32; per GMM (spoof
// first, then genuine): weights (k), means and variances (k, D), fp32,
// contiguous, 1 <= k <= 256; llr: (n_rows) fp32; empty: (n_rows) bytes, 1
// where an utterance has no valid frame. Returns a cudaError_t.
extern "C" int gmm_llr_launch(const void* x, int n_rows, int T, int D, const void* w0, const void* mu0,
                              const void* var0, int k0, const void* w1, const void* mu1, const void* var1, int k1,
                              void* llr, void* empty, void* stream) {
  if (n_rows < 0 || T < 0 || D < 1 || D > MAX_D || k0 < 1 || k0 > MAX_K || k1 < 1 || k1 > MAX_K)
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaSuccess;
  const Gmm g0 = {static_cast<const float*>(w0), static_cast<const float*>(mu0), static_cast<const float*>(var0), k0};
  const Gmm g1 = {static_cast<const float*>(w1), static_cast<const float*>(mu1), static_cast<const float*>(var1), k1};
  const float* xf = static_cast<const float*>(x);
  float* out = static_cast<float*>(llr);
  unsigned char* flags = static_cast<unsigned char*>(empty);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (round_up(D, 4)) {
    case 4: return launch<4>(xf, n_rows, T, D, g0, g1, out, flags, s);
    case 8: return launch<8>(xf, n_rows, T, D, g0, g1, out, flags, s);
    case 12: return launch<12>(xf, n_rows, T, D, g0, g1, out, flags, s);
    case 16: return launch<16>(xf, n_rows, T, D, g0, g1, out, flags, s);
    case 20: return launch<20>(xf, n_rows, T, D, g0, g1, out, flags, s);
    case 24: return launch<24>(xf, n_rows, T, D, g0, g1, out, flags, s);
    case 28: return launch<28>(xf, n_rows, T, D, g0, g1, out, flags, s);
    default: return launch<32>(xf, n_rows, T, D, g0, g1, out, flags, s);
  }
}
