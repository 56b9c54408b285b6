// Mel power through a packed real 2048-point FFT, one warp per frame row, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel ops/ct_mel.py (function
// _ct_mel_parts, pallas_call at line 246): center-padded waveforms
// (B, n_pad) -> mel power (B * n_frames, n_mels). Frame row r = u * T + f
// is x[n] = wav[u * n_pad + f * hop + n] * win[n], n = 0..2047, and
// out[r, m] = sum_k |X[k]|^2 mel[k, m] over bins k = 0..1024 of its DFT X.
//
// Bound. Per frame a real FFT needs 2.5 N log2 N + N (window) + 3 (N/2 + 1)
// (|X|^2) + 2 nnz(mel) operations: 65.4k at parity (1,994 nonzero mel
// weights). At B = 8192 two-second utterances (516,096 frames) that is 33.8
// GFLOP, 0.50 ms at the card's 67 TFLOP/s of fp32; the bytes (1.116 GB of
// padded waveform read once, 132 MB written) take 0.37 ms at 3.35 TB/s. So
// operations bound it, at 0.50 ms. This design does about 65k flops per frame
// (two passes of 32 x 32-point radix-2 FFTs 33.5k, twiddles 6.1k, the real
// split and |X|^2 19.5k, window and mel 6k), all fp32 outside the tensor
// cores: at this count the FFT is cheap, and fp32 keeps the dB check.
//
// Design (W_N = exp(-2 pi i / N)):
//  1. One warp per frame row; a block holds 8 warps on 8 consecutive rows,
//     so the 4x overlap of frames at hop 512 hits in L1 / L2. A warp past
//     the last row exits (there is no block barrier).
//  2. Pack: z[m] = x[2m] + i x[2m+1], m = 0..1023. Lane a loads z[a + 32 b],
//     b = 0..31, as a float2 at sample 2a + 64b (each b is one 256-byte warp
//     load) and multiplies by the window pair. float2 loads need 8-byte-
//     aligned rows: the launcher picks the 4-byte-load instance otherwise
//     (an odd n_pad, e.g. 32001 samples + 2048 of padding).
//  3. Pass 1: each lane runs a 32-point radix-2 decimation-in-frequency FFT
//     over b in registers (fully unrolled; register j ends up holding bin
//     c = brev5(j)), giving Y[a, c], then multiplies by W_1024^(a c) from a
//     host table.
//  4. Transpose through a per-warp shared tile [32][33] of float2 (padded
//     against bank conflicts), with __syncwarp only: lane c holds Y[a, c].
//  5. Pass 2: the same FFT over a gives Z[c + 32 d] = FFT_1024(z), register
//     j holding d = brev5(j).
//  6. Real split, k = c + 32 d: X[k] = (Z[k] + conj Z[1024-k]) / 2
//     - i W_2048^k (Z[k] - conj Z[1024-k]) / 2 (it also gives X[0]), and
//     X[1024] = Re Z[0] - Im Z[0]. The partner of k (c != 0) sits in lane
//     32 - c, register 31 - j (a shuffle); lane 0's partner is its own
//     register brev5((32 - d) mod 32). W_2048^k comes from a host table.
//  7. |X|^2 goes to a per-warp row of 1025 floats (the tile's space); lane l
//     sums filters m and n_mels-1-m for m = l, l+32, ... below ceil(n_mels/2)
//     over their nonzero spans [lo, hi) (the middle filter of an odd count
//     once). The host lays the weights out lane by lane: filter m's weight
//     for bin k at row row[m] + k - lo[m], column = the lane that sums it,
//     with one row base for the filters the lanes take together, so each
//     step's warp load is one 128-byte line.
// Every twiddle comes from float64 on the host or from the W_32 literals
// below; no sincos runs on the card.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NFFT = 2048;
constexpr int NH = NFFT / 2;       // 1024: the packed complex length
constexpr int R = 32;              // radix of both passes == lanes == registers
constexpr int WARPS = 8;           // frame rows per block
constexpr int THREADS = WARPS * 32;
constexpr int TS = R + 1;          // padded row stride of the transpose tile (float2)
constexpr unsigned FULL = 0xffffffffu;

// cos(pi e / 16) = sin(pi (8 - e) / 16), e = 0..8, float32 rounded from float64
// (tests/test_torch_ct_fft.py reads these literals and checks them bitwise)
__host__ __device__ constexpr float cos_q(int e) {
  return e == 0 ? 1.0f : e == 1 ? 0.98078525f : e == 2 ? 0.9238795f : e == 3 ? 0.8314696f
       : e == 4 ? 0.70710677f : e == 5 ? 0.55557024f : e == 6 ? 0.38268343f
       : e == 7 ? 0.19509032f : 0.0f;
}

// W_32^e = cos(2 pi e / 32) - i sin(2 pi e / 32), e = 0..15 (the exponents of the DIF stages)
__host__ __device__ constexpr float w32r(int e) { return e <= 8 ? cos_q(e) : -cos_q(16 - e); }
__host__ __device__ constexpr float w32i(int e) { return e <= 8 ? -cos_q(8 - e) : -cos_q(e - 8); }

__host__ __device__ constexpr int brev5(int j) {
  return ((j & 1) << 4) | ((j & 2) << 2) | (j & 4) | ((j & 8) >> 2) | ((j & 16) >> 4);
}

// One radix-2 DIF stage of span L over the 32 registers.
template <int L>
__device__ __forceinline__ void dif_stage(float (&re)[R], float (&im)[R]) {
#pragma unroll
  for (int base = 0; base < R; base += L)
#pragma unroll
    for (int j = 0; j < L / 2; ++j) {
      const int p = base + j, q = p + L / 2, e = j * (R / L);
      const float dr = re[p] - re[q], di = im[p] - im[q];
      re[p] += re[q];
      im[p] += im[q];
      if (e == 0) {
        re[q] = dr;
        im[q] = di;
      } else if (e == 8) {  // times -i
        re[q] = di;
        im[q] = -dr;
      } else {
        re[q] = dr * w32r(e) - di * w32i(e);
        im[q] = dr * w32i(e) + di * w32r(e);
      }
    }
}

// In-register 32-point FFT: natural order in, register j = bin brev5(j) out.
__device__ __forceinline__ void fft32(float (&re)[R], float (&im)[R]) {
  dif_stage<32>(re, im);
  dif_stage<16>(re, im);
  dif_stage<8>(re, im);
  dif_stage<4>(re, im);
  dif_stage<2>(re, im);
}

// Filter m's power, summed by `lane`: its weight for bin k in [lo, hi) sits at
// melw[(row + k - lo) * 32 + lane], so a warp's loads of one step share a line.
__device__ __forceinline__ float filter_sum(const float* pw, const float* __restrict__ melw,
                                            const int* __restrict__ spans, int m, int n_mels,
                                            int lane) {
  const int lo = __ldg(spans + m), hi = __ldg(spans + n_mels + m);
  const int base = (__ldg(spans + 2 * n_mels + m) - lo) * R + lane;
  float acc = 0.f;
  for (int k = lo; k < hi; ++k) acc = fmaf(pw[k], __ldg(melw + base + k * R), acc);
  return acc;
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
ct_mel_kernel(const float* __restrict__ wav, const float2* __restrict__ win,
              const float2* __restrict__ tw1, const float2* __restrict__ tw2,
              const float* __restrict__ melw, const int* __restrict__ spans,
              float* __restrict__ out, int n_rows, int n_frames, long long n_pad, int hop,
              int n_mels) {
  extern __shared__ float2 smem[];  // [WARPS][R * TS]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * WARPS + warp;
  if (r >= n_rows) return;
  float2* tile = smem + warp * (R * TS);

  // 2. pack and window: register b holds z[lane + 32 b]
  const float* src = wav + (long long)(r / n_frames) * n_pad + (long long)(r % n_frames) * hop + 2 * lane;
  float re[R], im[R];
#pragma unroll
  for (int b = 0; b < R; ++b) {
    float2 v;
    if constexpr (VEC) {
      v = __ldg(reinterpret_cast<const float2*>(src + 64 * b));
    } else {
      v = make_float2(__ldg(src + 64 * b), __ldg(src + 64 * b + 1));
    }
    const float2 w = __ldg(win + lane + 32 * b);
    re[b] = v.x * w.x;
    im[b] = v.y * w.y;
  }

  // 3. pass 1 over b, twiddle W_1024^(lane c) (table [c][a]), 4. transpose
  fft32(re, im);
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int c = brev5(j);
    const float2 t = __ldg(tw1 + c * R + lane);
    tile[c * TS + lane] = make_float2(re[j] * t.x - im[j] * t.y, re[j] * t.y + im[j] * t.x);
  }
  __syncwarp();
#pragma unroll
  for (int a = 0; a < R; ++a) {
    const float2 y = tile[lane * TS + a];
    re[a] = y.x;
    im[a] = y.y;
  }

  // 5. pass 2 over a: register j holds Z[lane + 32 brev5(j)]
  fft32(re, im);
  __syncwarp();  // every lane has read the tile: it becomes the power row

  // 6. real split and |X|^2
  float* pw = reinterpret_cast<float*>(tile);
  const int partner = (R - lane) & (R - 1);
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int d = brev5(j), j0 = brev5((R - d) & (R - 1));
    const float sr = __shfl_sync(FULL, re[R - 1 - j], partner);
    const float si = __shfl_sync(FULL, im[R - 1 - j], partner);
    const float pr = lane == 0 ? re[j0] : sr;
    const float pi = lane == 0 ? im[j0] : si;
    const int k = lane + R * d;
    const float2 w = __ldg(tw2 + k);
    const float ar = 0.5f * (re[j] + pr), ai = 0.5f * (im[j] - pi);
    const float br = 0.5f * (re[j] - pr), bi = 0.5f * (im[j] + pi);
    const float xr = ar + (w.x * bi + w.y * br);
    const float xi = ai - (w.x * br - w.y * bi);
    pw[k] = xr * xr + xi * xi;
  }
  if (lane == 0) {
    const float x = re[0] - im[0];  // X[1024]
    pw[NH] = x * x;
  }
  __syncwarp();

  // 7. mel: lane l takes the filter pairs (m, n_mels - 1 - m), m = l, l + 32, ...
  float* orow = out + (long long)r * n_mels;
  for (int m = lane; m < (n_mels + 1) / 2; m += R) {
    orow[m] = filter_sum(pw, melw, spans, m, n_mels, lane);
    const int m2 = n_mels - 1 - m;
    if (m2 != m) orow[m2] = filter_sum(pw, melw, spans, m2, n_mels, lane);
  }
}

template <bool VEC>
cudaError_t launch(const float* wav, const float2* win, const float2* tw1, const float2* tw2,
                   const float* melw, const int* spans, float* out, int n_rows, int n_frames,
                   long long n_pad, int hop, int n_mels, cudaStream_t s) {
  const size_t smem = sizeof(float2) * WARPS * R * TS;  // 67,584 bytes
  cudaError_t err =
      cudaFuncSetAttribute(ct_mel_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)(((long long)n_rows + WARPS - 1) / WARPS);
  ct_mel_kernel<VEC><<<blocks, THREADS, smem, s>>>(wav, win, tw1, tw2, melw, spans, out, n_rows,
                                                   n_frames, n_pad, hop, n_mels);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). Pointers are device pointers to
// contiguous arrays: wav (B, n_pad) f32; win (2048,) f32 (read as 1024
// float2 pairs); tw1 (32 c, 32 a, 2) f32 = W_1024^(a c); tw2 (1025, 2) f32 =
// W_2048^k; melw (rows, 32) f32 the mel weights lane by lane; spans (3,
// n_mels) int32 = each filter's first and last-plus-one nonzero bin and the
// row of its first weight in melw; out (n_rows, n_mels) f32 with n_rows = B *
// n_frames. win, tw1 and tw2 must be 8-byte aligned. Rows are read as float2
// when wav is 8-byte aligned and n_pad and hop are even, else as floats.
// Launches on `stream`; returns the first cudaError_t (0 on success).
extern "C" int ct_mel_launch(const void* wav, const void* win, const void* tw1, const void* tw2,
                             const void* melw, const void* spans, void* out, int n_rows,
                             int n_frames, long long n_pad, int hop, int n_mels, void* stream) {
  if (n_rows < 0 || n_frames < 1 || hop < 1 || n_mels < 1 || n_pad < NFFT)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(win) | reinterpret_cast<uintptr_t>(tw1) |
       reinterpret_cast<uintptr_t>(tw2)) % 8)
    return (int)cudaErrorMisalignedAddress;
  if (n_rows == 0) return (int)cudaSuccess;
  const bool vec = reinterpret_cast<uintptr_t>(wav) % 8 == 0 && n_pad % 2 == 0 && hop % 2 == 0;
  const auto go = vec ? &launch<true> : &launch<false>;
  return (int)go(static_cast<const float*>(wav), static_cast<const float2*>(win),
                 static_cast<const float2*>(tw1), static_cast<const float2*>(tw2),
                 static_cast<const float*>(melw), static_cast<const int*>(spans),
                 static_cast<float*>(out), n_rows, n_frames, n_pad, hop, n_mels,
                 static_cast<cudaStream_t>(stream));
}
