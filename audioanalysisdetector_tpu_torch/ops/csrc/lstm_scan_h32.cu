// Inference LSTM recurrence for hidden 32, fp32, a layer's directions in one launch, for Hopper (sm_90a).
//
// Replaces no kernel of the JAX package (it has no Pallas LSTM; XLA runs its
// scan). It replaces a library call: cuDNN's persistent LSTM
// (RNN_blockPersist_fp_LSTM, under nn.LSTM) in the mel model's BiLSTM(64, 32),
// which at the mel scorer's B = 8192, T = 32 takes ~0.56 ms a call beside its
// own input product. The hidden-128 kernel (lstm_scan.cu) needs a 2-CTA
// cluster for its 256-KB W_hh; here a direction's W_hh is 16 KB, so the two
// share no design.
//
// What it computes (the contract of lstm_scan.cu at hidden 32). Input gates xg
// (B, T, n_dirs * 128), xg = x W_ih^T + b_ih + b_hh, computed beforehand by one
// product for every direction; direction d reads columns [128 d, 128 d + 128)
// in the order [i, f, g, o] x 32 units. From h = c = 0, step t of direction d
// (d = 1 runs backward: position p = T-1-t, else p = t):
//   a = xg[b, p, 128 d :] + W_hh[d] h          (128 gates of row b)
//   c = sigmoid(a_f) c + sigmoid(a_i) tanh(a_g),  h = sigmoid(a_o) tanh(c)
// and h is written to out[b, p, 32 d : 32 d + 32] (full output), or, with
// last_only, only the last step's h to out[b, 32 d :] (B, n_dirs * 32).
// sigmoid(x) = 1 / (1 + expf(-x)) and tanhf, accurate (no fast math).
//
// Bound. At the mel scorer's shape (B = 8192, T = 32, both directions) the
// h W_hh^T products are 2 * 2 * B * T * 128 * 32 = 4.29 GFLOP (0.064 ms at the
// card's 67 TFLOP/s of fp32), and the input gates read once (268 MB) and the
// output written once (67 MB) take 0.100 ms at 3.35 TB/s: bytes bound it.
// All of it is FFMA: no TF32, no tensor cores. Per (row, unit, step) the cell
// adds three accurate sigmoids and two tanhf to 128 FFMA, so instruction
// issue, not the FFMA pipe alone, sets the pace once the bytes stream.
//
// Design:
//  1. One warp owns `rows` rows of one direction for all T steps; lane u is
//     unit u. It keeps the four gates of its unit over all 32 k in registers
//     (W_hh[d][32 g + u][k], 128 registers, loaded once), so a step's gates of
//     a row are whole in their lane: no reduction, no exchange between lanes.
//  2. h of each of the warp's rows lives in shared memory, twice (step t reads
//     one buffer and writes the other). Every lane reads a row's 32 h as 8
//     float4 broadcasts, one shared load per 16 FFMA; the new h[u] is one
//     store. c stays in shared memory, one slot a lane and row. Warps share
//     nothing, so one __syncwarp a step is the only barrier.
//  3. The input gates stream through a two-stage ring in shared memory: at
//     the start of step t every lane issues cp.async (16 bytes a lane, 512
//     bytes a row, coalesced) for step t+1's rows, then computes step t from
//     the other stage, so the next step's loads are in flight during the
//     current step's products and cell. Lane u reads its 4 gates of a row as
//     consecutive words (no bank conflicts).
//  4. Rows go two at a time (8 independent FFMA chains a lane), so one row's
//     products overlap the other's; an odd last row goes alone.
//  5. Blocks of 4 warps, 3 resident an SM (launch bounds cap the registers at
//     168); the host takes the fewest waves of resident warps whose rows a
//     warp fit the shared memory (at B = 8192, two directions: one wave of
//     11 rows a warp). Rows past the batch belong to no warp.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int H = 32;                          // hidden units: one a lane
constexpr int G = 4 * H;                       // gates a direction
constexpr int WARPS = 4;                       // warps a block
constexpr int THREADS = 32 * WARPS;
constexpr int MIN_BLOCKS = 3;                  // resident blocks an SM
constexpr int ROW_FLOATS = 2 * G + 2 * H + H;  // a row's shared floats: 2 gate stages, 2 h buffers, c
constexpr int SMEM_SM = 232448;                // shared memory a block may use (227 KB)
// rows a warp: MIN_BLOCKS blocks of WARPS warps fit an SM's shared memory (1 KB reserved a block)
constexpr int ROWS_MAX = (SMEM_SM / MIN_BLOCKS - 1024) / (WARPS * ROW_FLOATS * (int)sizeof(float));

constexpr size_t smem_bytes(int rows) { return (size_t)WARPS * rows * ROW_FLOATS * sizeof(float); }

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// One step of NR consecutive rows: xs, hc, hn and cs point at the first row's
// gates, h (read), next h (written) and c; out at its output slot of this
// lane's unit (rows sob apart).
template <int NR>
__device__ __forceinline__ void step_rows(const float (&w)[4][H], const float* __restrict__ xs,
                                          const float* __restrict__ hc, float* __restrict__ hn,
                                          float* __restrict__ cs, float* __restrict__ out, long long sob,
                                          int lane, bool write) {
  float a[NR][4];
#pragma unroll
  for (int j = 0; j < NR; ++j)
#pragma unroll
    for (int g = 0; g < 4; ++g) a[j][g] = xs[j * G + g * H + lane];
#pragma unroll
  for (int q = 0; q < H / 4; ++q) {
    float4 hv[NR];
#pragma unroll
    for (int j = 0; j < NR; ++j) hv[j] = reinterpret_cast<const float4*>(hc + j * H)[q];
#pragma unroll
    for (int j = 0; j < NR; ++j)
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        float v = a[j][g];
        v = fmaf(w[g][4 * q], hv[j].x, v);
        v = fmaf(w[g][4 * q + 1], hv[j].y, v);
        v = fmaf(w[g][4 * q + 2], hv[j].z, v);
        v = fmaf(w[g][4 * q + 3], hv[j].w, v);
        a[j][g] = v;
      }
  }
#pragma unroll
  for (int j = 0; j < NR; ++j) {
    float* cp = cs + j * H + lane;
    const float c = sigmoid(a[j][1]) * *cp + sigmoid(a[j][0]) * tanhf(a[j][2]);
    *cp = c;
    const float h = sigmoid(a[j][3]) * tanhf(c);
    hn[j * H + lane] = h;
    if (write) out[j * sob] = h;
  }
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    lstm_scan_h32_kernel(const float* __restrict__ xg, long long sxb, long long sxt,
                         const float* __restrict__ w0, const float* __restrict__ w1,
                         float* __restrict__ out, long long sob, long long sot, int n_rows, int T,
                         int rows, int last_only) {
  extern __shared__ __align__(16) float smem[];
  const int dir = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row0 = ((long long)blockIdx.x * WARPS + warp) * rows;
  if (row0 >= n_rows) return;
  const int nr = (int)min((long long)rows, n_rows - row0);  // this warp's rows

  float w[4][H];  // W_hh[dir][g * H + lane][k]
  {
    const float4* wd = reinterpret_cast<const float4*>((dir ? w1 : w0) + (size_t)lane * H);
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int q = 0; q < H / 4; ++q) {
        const float4 v = __ldg(wd + g * H * H / 4 + q);
        w[g][4 * q] = v.x;
        w[g][4 * q + 1] = v.y;
        w[g][4 * q + 2] = v.z;
        w[g][4 * q + 3] = v.w;
      }
  }

  float* xs = smem + (size_t)warp * rows * ROW_FLOATS;  // [2 stages][rows][G]
  float* hb = xs + 2 * rows * G;                        // [2 buffers][rows][H]
  float* cs = hb + 2 * rows * H;                        // [rows][H]
  for (int r = 0; r < nr; ++r) {
    hb[r * H + lane] = 0.0f;
    cs[r * H + lane] = 0.0f;
  }

  // step t's gates of the warp's rows into stage s: lane u copies bytes [16 u, 16 u + 16) of each row
  const float* xd = xg + row0 * sxb + (size_t)dir * G + 4 * lane;
  auto fetch = [&](int t, int s) {
    const float* src = xd + (long long)(dir ? T - 1 - t : t) * sxt;
    float* dst = xs + s * rows * G + 4 * lane;
    for (int r = 0; r < nr; ++r) cp_async16(dst + r * G, src + r * sxb);
    cp_async_commit();
  };
  fetch(0, 0);
  cp_async_wait_all();
  __syncwarp();

  float* od = out + row0 * sob + (size_t)dir * H + lane;
  for (int t = 0; t < T; ++t) {
    if (t + 1 < T) fetch(t + 1, (t + 1) & 1);
    const int p = dir ? T - 1 - t : t;
    const float* xc = xs + (t & 1) * rows * G;
    const float* hc = hb + (t & 1) * rows * H;
    float* hn = hb + ((t + 1) & 1) * rows * H;
    float* op = od + (long long)p * sot;
    const bool write = !last_only || t == T - 1;
    int r = 0;
    for (; r + 2 <= nr; r += 2)
      step_rows<2>(w, xc + r * G, hc + r * H, hn + r * H, cs + r * H, op + r * sob, sob, lane, write);
    if (r < nr) step_rows<1>(w, xc + r * G, hc + r * H, hn + r * H, cs + r * H, op + r * sob, sob, lane, write);
    cp_async_wait_all();  // step t+1's gates have landed
    __syncwarp();         // ... for every lane, with step t's h; the buffers read at step t are free
  }
}

// Resident warps on the current device at the largest tile's shared memory.
long long resident_warps() {
  static long long cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cached[dev]) return cached[dev];
  const size_t smem = smem_bytes(ROWS_MAX);
  if (cudaFuncSetAttribute(lstm_scan_h32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) !=
      cudaSuccess)
    return 0;
  int blocks = 0, sms = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, lstm_scan_h32_kernel, THREADS, smem) !=
          cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || blocks < 1 || sms < 1)
    return 0;
  cached[dev] = (long long)blocks * WARPS * sms;
  return cached[dev];
}

}  // namespace

// xg: (B, T, n_dirs * 128) input gates, 16-byte aligned, strides sxb and sxt
// (floats, multiples of 4), unit stride 1; w0, w1: each direction's W_hh
// (128, 32), contiguous and 16-byte aligned (w1 unused when n_dirs is 1); out:
// strides sob and sot (sot unused with last_only). Returns a cudaError_t.
extern "C" int lstm_scan_h32_launch(const void* xg, long long sxb, long long sxt, const void* w0,
                                    const void* w1, void* out, long long sob, long long sot, int n_rows,
                                    int T, int n_dirs, int last_only, void* stream) {
  if (n_rows < 0 || T < 1 || n_dirs < 1 || n_dirs > 2 || sxb < 0 || sxt < 0 || sob < 0 || sot < 0)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(xg) | reinterpret_cast<uintptr_t>(w0) |
       reinterpret_cast<uintptr_t>(n_dirs == 2 ? w1 : w0)) % 16 ||
      sxb % 4 || sxt % 4)
    return (int)cudaErrorMisalignedAddress;
  if (n_rows == 0) return (int)cudaSuccess;
  const long long resident = resident_warps();
  if (resident < 1) {
    const cudaError_t err = cudaGetLastError();
    return (int)(err != cudaSuccess ? err : cudaErrorUnknown);
  }
  // the fewest waves of resident warps whose rows a warp fit shared memory,
  // and the fewest rows a warp that cover the batch in them
  int rows = ROWS_MAX;
  for (long long waves = 1;; ++waves) {
    const long long per_dir = waves * resident / n_dirs;
    if (per_dir < 1) continue;
    const long long need = (n_rows + per_dir - 1) / per_dir;
    if (need <= ROWS_MAX) {
      rows = (int)need;
      break;
    }
  }
  const long long warps = (n_rows + rows - 1) / rows;
  const unsigned blocks = (unsigned)((warps + WARPS - 1) / WARPS);
  lstm_scan_h32_kernel<<<dim3(blocks, n_dirs, 1), THREADS, smem_bytes(rows),
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xg), sxb, sxt, static_cast<const float*>(w0),
      static_cast<const float*>(n_dirs == 2 ? w1 : w0), static_cast<float*>(out), sob, sot, n_rows, T,
      rows, last_only);
  return (int)cudaGetLastError();
}
