// Inference LSTM recurrence for hidden 128, fp32, a layer's directions in one launch, for Hopper (sm_90a).
//
// Replaces no kernel of the JAX package (it has no Pallas LSTM; XLA runs its
// scan). It replaces a library call: cuDNN's persistent LSTM
// (RNN_blockPersist_fp_LSTM, under nn.LSTM and torch._VF.lstm), which at the
// fused scorer's B = 8192 runs a layer's two directions one after the other,
// ~8.6 ms a 63-step scan (~7.8 TFLOP/s, 12% of the fp32 peak).
//
// What it computes. Input gates xg (B, T, n_dirs * 512), xg = x W_ih^T + b_ih +
// b_hh, computed beforehand by one product for every direction; direction d
// reads columns [512 d, 512 d + 512) in the order [i, f, g, o] x 128 units.
// From h = c = 0, step t of direction d (d = 1 runs backward: position
// p = T-1-t, else p = t):
//   a = xg[b, p, 512 d :] + W_hh[d] h          (512 gates of row b)
//   c = sigmoid(a_f) c + sigmoid(a_i) tanh(a_g),  h = sigmoid(a_o) tanh(c)
// and h is written to out[b, p, 128 d : 128 d + 128] (full output), or, with
// last_only, only the last step's h to out[b, 128 d :] (B, n_dirs * 128).
// sigmoid(x) = 1 / (1 + expf(-x)) and tanhf, accurate (no fast math).
//
// Bound. A scan needs 2 * B * T * 512 * 128 operations of h W_hh^T (67.6
// GFLOP at B = 8192, T = 63: 1.01 ms at the card's 67 TFLOP/s of fp32) and
// reads its input gates once (1.06 GB, 0.32 ms at 3.35 TB/s); layer 1 also
// writes its output (264 MB a direction). Operations bound it, at 1.01 ms a
// scan. All of it is FFMA: the product stays fp32 (no TF32, no tensor cores).
//
// Design:
//  1. W_hh (512 x 128 fp32, 256 KB) is larger than an SM's shared memory, so
//     a 2-CTA thread-block cluster holds one direction's W_hh in registers:
//     CTA rank r owns units [64 r, 64 r + 64); its thread (u, s), u = tid / 4,
//     s = tid % 4, keeps the four gates of unit 64 r + u over k in
//     [32 s, 32 s + 32): 128 registers, loaded once per launch.
//  2. The grid is (2 x batch tiles, n_dirs): a cluster takes bt rows of one
//     direction for all T steps; rows are independent, so no cluster waits on
//     another. bt is chosen on the host so that the clusters fill the card's
//     resident clusters in as few waves as the rows allow (at most 160 rows).
//  3. Each CTA keeps the tile's whole h (bt x 128) in shared memory, twice
//     (step t reads one buffer and writes the other), and its c slice. A
//     step: for each group of 4 rows, every thread multiplies its weights by
//     the 4 rows' h slices (float4 loads that 8 lanes share), 16 sums of 32
//     products; the 4 threads of a unit then reduce-scatter them by 12
//     shuffles so that thread s holds the 4 full gates of row s, add its
//     input gates, and update c and h of (row s, unit). Thread s takes the
//     group's rows in the order j ^ s, so each exchange sends a fixed
//     register and keeps another (no selects), and the 4 slices of a load,
//     36 floats apart in a row and 144 from row to row, fall in distinct
//     banks. The new h goes to both CTAs' next buffer (the peer's through
//     distributed shared memory), and one cluster barrier a step makes it
//     visible and frees the buffer just read. c stays in shared memory, one
//     slot a thread and row group. The row-group loop is unrolled 4 times,
//     so one group's cell math overlaps another's products (224 registers,
//     no spills; the loop body is ~70% FFMA, the rest the accurate
//     sigmoid/tanh, the reduction and the loads).
//  4. Rows past the batch read the last row's input gates and write nothing.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int H = 128;           // hidden units
constexpr int G = 4 * H;         // gates a direction
constexpr int THREADS = 256;     // 64 units x 4 k-slices
constexpr int KS = 32;           // k per slice
constexpr int SS = KS + 4;       // slice stride of an h row in shared memory (floats)
constexpr int HS = 4 * SS;       // row stride of an h buffer (floats)
constexpr int BT_MAX = 160;      // rows a cluster: 2 h buffers + c fit 227 KB
constexpr unsigned FULL = 0xffffffffu;

constexpr size_t smem_bytes(int bt) { return (size_t)bt * (2 * HS + THREADS / 4) * sizeof(float); }

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(THREADS, 1)
    lstm_scan_kernel(const float* __restrict__ xg, long long sxb, long long sxt,
                     const float* __restrict__ w0, const float* __restrict__ w1,
                     float* __restrict__ out, long long sob, long long sot, int n_rows, int T,
                     int bt, int last_only) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int dir = blockIdx.y;
  const int tid = threadIdx.x;
  const int s = tid & 3;
  const int unit = rank * (H / 2) + (tid >> 2);

  float w[4][KS];  // W_hh[dir][g * H + unit][KS * s + k]
  {
    const float* wd = (dir ? w1 : w0) + (size_t)unit * H + KS * s;
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int q = 0; q < KS / 4; ++q) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(wd + (size_t)g * H * H) + q);
        w[g][4 * q] = v.x;
        w[g][4 * q + 1] = v.y;
        w[g][4 * q + 2] = v.z;
        w[g][4 * q + 3] = v.w;
      }
  }

  float* hbuf = smem;                 // 2 buffers of bt x HS
  float* cbuf = smem + 2 * bt * HS;   // [row group][thread]
  float* peer = cluster.map_shared_rank(smem, rank ^ 1);
  for (int i = tid; i < bt * HS; i += THREADS) hbuf[i] = 0.0f;
  for (int i = tid; i < bt * (THREADS / 4); i += THREADS) cbuf[i] = 0.0f;
  cluster.sync();  // zeros in place, and the peer is running before its memory is written

  const int row0 = (blockIdx.x >> 1) * bt;
  const float* xd = xg + (size_t)dir * G + unit;
  float* od = out + (size_t)dir * H + unit;
  const int slot = (unit >> 5) * SS + (unit & 31);  // the unit's place in an h row

  for (int t = 0; t < T; ++t) {
    const int p = dir ? T - 1 - t : t;
    const int cur = (t & 1) * bt * HS, nxt = bt * HS - cur;
    const float* hc = hbuf + cur + SS * s;  // this thread's k-slice
#pragma unroll 4
    for (int rg = 0; rg < bt / 4; ++rg) {
      const int b = row0 + 4 * rg + s;  // the row this thread updates
      const float* xp = xd + (long long)min(b, n_rows - 1) * sxb + (long long)p * sxt;
      const float xi = __ldg(xp), xf = __ldg(xp + H), xgg = __ldg(xp + 2 * H), xo = __ldg(xp + 3 * H);

      float acc[4][4];  // [row j ^ s of the group][gate]
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[j][g] = 0.0f;
      const float* hp = hc + 4 * rg * HS;
#pragma unroll
      for (int q = 0; q < KS / 4; ++q) {
        float4 hv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) hv[j] = *reinterpret_cast<const float4*>(hp + (j ^ s) * HS + 4 * q);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            float a = acc[j][g];
            a = fmaf(w[g][4 * q], hv[j].x, a);
            a = fmaf(w[g][4 * q + 1], hv[j].y, a);
            a = fmaf(w[g][4 * q + 2], hv[j].z, a);
            a = fmaf(w[g][4 * q + 3], hv[j].w, a);
            acc[j][g] = a;
          }
      }

      // reduce-scatter over the unit's 4 k-slices (lanes 4u .. 4u+3), acc[j]
      // holding row j ^ s: the xor-1 partner's acc[1] and acc[3] are rows s
      // and 2 ^ s, and after that exchange the xor-2 partner's second sum is
      // row s
      float a[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float r0 = acc[0][g] + __shfl_xor_sync(FULL, acc[1][g], 1);
        const float r2 = acc[2][g] + __shfl_xor_sync(FULL, acc[3][g], 1);
        a[g] = r0 + __shfl_xor_sync(FULL, r2, 2);
      }

      float* cp = cbuf + rg * THREADS + tid;
      const float c = sigmoid(a[1] + xf) * *cp + sigmoid(a[0] + xi) * tanhf(a[2] + xgg);
      *cp = c;
      const float h = sigmoid(a[3] + xo) * tanhf(c);
      const int at = nxt + (4 * rg + s) * HS + slot;
      hbuf[at] = h;
      peer[at] = h;
      if (b < n_rows && (!last_only || t == T - 1))
        od[(long long)b * sob + (long long)p * sot] = h;
    }
    cluster.sync();  // h of step t in both CTAs; the buffer read at step t is free
  }
}

// Resident 2-CTA clusters at the largest tile's shared memory, per device.
int max_clusters() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cached[dev]) return cached[dev];
  const size_t smem = smem_bytes(BT_MAX);
  if (cudaFuncSetAttribute(lstm_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) !=
      cudaSuccess)
    return 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, (void*)lstm_scan_kernel, &cfg) != cudaSuccess || n < 1) return 0;
  cached[dev] = n;
  return n;
}

}  // namespace

// xg: (B, T, n_dirs * 512) input gates, strides sxb and sxt (floats), unit
// stride 1; w0, w1: each direction's W_hh (512, 128), contiguous and 16-byte
// aligned (w1 unused when n_dirs is 1); out: strides sob and sot (sot unused
// with last_only). Returns a cudaError_t.
extern "C" int lstm_scan_launch(const void* xg, long long sxb, long long sxt, const void* w0,
                                const void* w1, void* out, long long sob, long long sot, int n_rows,
                                int T, int n_dirs, int last_only, void* stream) {
  if (n_rows < 0 || T < 1 || n_dirs < 1 || n_dirs > 2 || sxb < 0 || sxt < 0 || sob < 0 || sot < 0)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(w0) | reinterpret_cast<uintptr_t>(n_dirs == 2 ? w1 : w0)) % 16)
    return (int)cudaErrorMisalignedAddress;
  if (n_rows == 0) return (int)cudaSuccess;
  const int resident = max_clusters();
  if (resident < 1) {
    const cudaError_t err = cudaGetLastError();
    return (int)(err != cudaSuccess ? err : cudaErrorUnknown);
  }
  // the fewest waves of resident clusters whose tile fits shared memory, and
  // the smallest tile (a multiple of 4 rows) that covers the batch in them
  int bt = BT_MAX;
  for (long long waves = 1;; ++waves) {
    const long long per_dir = waves * resident / n_dirs;
    if (per_dir < 1) continue;
    const long long need = (n_rows + per_dir - 1) / per_dir;
    if (need <= BT_MAX) {
      bt = (int)((need + 3) / 4 * 4);
      break;
    }
  }
  const int tiles = (n_rows + bt - 1) / bt;
  lstm_scan_kernel<<<dim3(2 * tiles, n_dirs, 1), THREADS, smem_bytes(bt),
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xg), sxb, sxt, static_cast<const float*>(w0),
      static_cast<const float*>(n_dirs == 2 ? w1 : w0), static_cast<float*>(out), sob, sot, n_rows, T,
      bt, last_only);
  return (int)cudaGetLastError();
}
