// Mel power through a Cooley-Tukey factored 2048-point DFT, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel ops/ct_mel.py (function
// _ct_mel_parts, body lines 195-244): center-padded waveforms
// (B, n_pad) -> mel power (B * n_frames, n_mels). Each frame row r =
// u * n_frames + f is read straight from the waveform at u * n_pad + f * hop
// and windowed; with n = n1 + 64 n2 and k = k2 + 32 k1 its DFT is
//
//   G[k2, n1] = sum_n2 E32[n2, k2] x[n1 + 64 n2]           (stage A, 32-point)
//   B[k2, n1] = G[k2, n1] t[n1, k2]                        (twiddle)
//   X[k2, k1] = sum_n1 B[k2, n1] E64[n1, k1]               (stage C, 64-point)
//
// and out[r, m] = sum_k |X[k]|^2 mel[k, m] over bins k = 0..1024.
//
// Design. A block walks groups of FB = 2 frame rows (a grid-stride loop, so
// the 17 KB E64 table is staged into shared memory once per block, not once
// per group). Per group:
//  1. the two windowed frames go to shared memory;
//  2. stage A: one thread per (frame, n1) computes G for k2 = 0..16 only
//     (the input is real, so G[32 - k2] = conj G[k2]) with fp32 FMAs whose
//     E32 operand is an immediate of constant memory (fully unrolled: no
//     load per FMA), applies the twiddle and writes B for all 32 k2;
//  3. stage C is a small complex GEMM, (64 rows = frame x k2) x 64 n1 x
//     (32 bins k1), each thread 4 rows x 4 bins in registers from shared
//     memory; bins k1 = 0..31 give k = 0..1023 and one warp per frame adds
//     the Nyquist bin 1024 with a shuffle reduction. Only half the spectrum
//     is computed (the other half is its mirror);
//  4. |X|^2 goes to shared memory and each (frame, mel) thread sums its
//     filter's nonzero span [lo, hi) of bins, read from the dense filterbank.
// The ragged last group is masked, so any batch size is taken.
//
// Bounds. Per frame: stage A 17 x 32 x 2 = 1,088 FMAs per n1 (70k), stage C
// 32 x 32 x 64 x 4 = 262k FMAs, the mel spans ~2k FMAs: about 0.34M FMAs, a
// fifth of the direct DFT's 2048 x 1025 x 2 = 4.2M (ops/csrc/wave_mel.cu).
// At 8192 two-second utterances (516,096 frames) that is ~0.35 TFLOP of fp32
// FMA work outside the tensor cores; stage C issues one 32-bit shared load
// per 4 FMAs, so the FMA pipe and shared-memory bandwidth bound it together.
// The waveform is read once per frame (4x per sample at hop 512, mostly from
// L2). Tensor-core stage C and an FFT-style split of the 64-point stage are
// left for later work.

#include <cuda_runtime.h>

namespace {

constexpr int N1 = 64;          // in-chunk offset, stage-C length
constexpr int N2 = 32;          // chunk index, stage-A length
constexpr int NFFT = N1 * N2;   // 2048
constexpr int KH = N2 / 2 + 1;  // stage-A bins computed (k2 = 0..16)
constexpr int K1C = 33;         // E64 columns staged (k1 = 0..32)
constexpr int FB = 2;           // frame rows per group
constexpr int THREADS = 128;    // == FB * N1 (stage A) == 16 x 8 (stage C)
constexpr int ROWS = FB * N2;   // stage-C rows (frame, k2)
constexpr int BS = N1 + 1;      // padded row stride of B
constexpr int PW = 36;          // power-tile stride per k1 (conflict-free stores)

__constant__ float c_e32[2][N2][KH];  // [cos|-sin][n2][k2]

__global__ void __launch_bounds__(THREADS, 3)
ct_mel_kernel(const float* __restrict__ wav, const float* __restrict__ e64,
              const float* __restrict__ tw, const float* __restrict__ win,
              const float* __restrict__ mel, const int* __restrict__ mel_lo,
              const int* __restrict__ mel_hi, float* __restrict__ out, int n_rows,
              int n_frames, long long n_pad, int hop, int n_mels) {
  extern __shared__ float smem[];
  float* xs = smem;               // [FB][NFFT] windowed frames, then |X|^2 at k1 * PW + k2
  float* br = xs + FB * NFFT;     // [ROWS][BS] B real
  float* bi = br + ROWS * BS;     // [ROWS][BS] B imaginary
  float* ec = bi + ROWS * BS;     // [N1][K1C]  E64 real
  float* es = ec + N1 * K1C;      // [N1][K1C]  E64 imaginary

  const int tid = threadIdx.x;
  for (int e = tid; e < N1 * K1C; e += THREADS) {
    ec[e] = e64[e];
    es[e] = e64[N1 * K1C + e];
  }

  const int n_groups = (n_rows + FB - 1) / FB;
  for (int g = blockIdx.x; g < n_groups; g += gridDim.x) {
    const long long r0 = (long long)g * FB;

    // 1. windowed frames (zeros past the last row)
#pragma unroll
    for (int f = 0; f < FB; ++f) {
      const long long r = r0 + f;
      const bool ok = r < n_rows;
      const float* src = wav + (ok ? (r / n_frames) * n_pad + (r % n_frames) * (long long)hop : 0);
      for (int n = tid; n < NFFT; n += THREADS) xs[f * NFFT + n] = ok ? src[n] * __ldg(win + n) : 0.f;
    }
    __syncthreads();

    // 2. stage A and twiddle: thread = (frame f, offset n1)
    {
      const int f = tid / N1, n1 = tid % N1;
      float gr[KH], gi[KH];
#pragma unroll
      for (int k2 = 0; k2 < KH; ++k2) gr[k2] = gi[k2] = 0.f;
#pragma unroll
      for (int n2 = 0; n2 < N2; ++n2) {
        const float v = xs[f * NFFT + n1 + N1 * n2];
#pragma unroll
        for (int k2 = 0; k2 < KH; ++k2) {
          gr[k2] = fmaf(c_e32[0][n2][k2], v, gr[k2]);
          gi[k2] = fmaf(c_e32[1][n2][k2], v, gi[k2]);
        }
      }
#pragma unroll
      for (int k2 = 0; k2 < N2; ++k2) {
        const float a = k2 < KH ? gr[k2] : gr[N2 - k2];
        const float b = k2 < KH ? gi[k2] : -gi[N2 - k2];
        const float t_r = __ldg(tw + k2 * N1 + n1);
        const float t_i = __ldg(tw + (N2 + k2) * N1 + n1);
        br[(f * N2 + k2) * BS + n1] = a * t_r - b * t_i;
        bi[(f * N2 + k2) * BS + n1] = a * t_i + b * t_r;
      }
    }
    __syncthreads();

    // 3a. the Nyquist bin k = 1024 (k2 = 0, k1 = 32): one warp per frame
    if (tid < 32 * FB) {
      const int f = tid >> 5, lane = tid & 31;
      float xr = 0.f, xi = 0.f;
      for (int n1 = lane; n1 < N1; n1 += 32) {
        const float a = br[f * N2 * BS + n1], b = bi[f * N2 * BS + n1];
        const float c = ec[n1 * K1C + 32], s = es[n1 * K1C + 32];
        xr += a * c - b * s;
        xi += a * s + b * c;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        xr += __shfl_xor_sync(0xffffffffu, xr, off);
        xi += __shfl_xor_sync(0xffffffffu, xi, off);
      }
      if (lane == 0) xs[f * NFFT + 32 * PW] = xr * xr + xi * xi;
    }

    // 3b. stage C: thread = rows ty + 16 i (i < 4) x bins k1 = tx + 8 j (j < 4)
    {
      const int tx = tid & 7, ty = tid >> 3;
      float xr[4][4], xi[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) xr[i][j] = xi[i][j] = 0.f;
#pragma unroll 4
      for (int n1 = 0; n1 < N1; ++n1) {
        float ar[4], ai[4], c[4], s[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ar[i] = br[(ty + 16 * i) * BS + n1];
          ai[i] = bi[(ty + 16 * i) * BS + n1];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          c[j] = ec[n1 * K1C + tx + 8 * j];
          s[j] = es[n1 * K1C + tx + 8 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            xr[i][j] = fmaf(ar[i], c[j], xr[i][j]);
            xr[i][j] = fmaf(-ai[i], s[j], xr[i][j]);
            xi[i][j] = fmaf(ar[i], s[j], xi[i][j]);
            xi[i][j] = fmaf(ai[i], c[j], xi[i][j]);
          }
      }
      // |X|^2 into the (now free) frame buffer: row = f * 32 + k2
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = ty + 16 * i, f = row / N2, k2 = row % N2;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          xs[f * NFFT + (tx + 8 * j) * PW + k2] = xr[i][j] * xr[i][j] + xi[i][j] * xi[i][j];
      }
    }
    __syncthreads();

    // 4. mel: thread = (frame, mel), over the filter's nonzero bins
    for (int t = tid; t < FB * n_mels; t += THREADS) {
      const int f = t / n_mels, m = t - f * n_mels;
      const long long r = r0 + f;
      if (r >= n_rows) continue;
      const float* p = xs + f * NFFT;
      const int hi = __ldg(mel_hi + m);
      float acc = 0.f;
      for (int k = __ldg(mel_lo + m); k < hi; ++k)
        acc = fmaf(p[(k >> 5) * PW + (k & 31)], __ldg(mel + (long long)k * n_mels + m), acc);
      out[r * n_mels + m] = acc;
    }
    __syncthreads();  // xs is rewritten by the next group
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). Pointers are device pointers to
// contiguous arrays: wav (B, n_pad) f32; e32 (2, 32, 17) f32 = [cos|-sin] of
// the 32-point DFT for k2 = 0..16; e64 (2, 64, 33) f32 = the 64-point DFT for
// k1 = 0..32; tw (2, 32, 64) f32 = the twiddle as [k2][n1]; win (2048,) f32;
// mel (1025, n_mels) f32; mel_lo, mel_hi (n_mels,) int32 = each filter's
// nonzero bin span; out (n_rows, n_mels) f32 with n_rows = B * n_frames.
// Copies e32 into constant memory and launches, both on `stream`; returns
// the first cudaError_t (0 on success).
extern "C" int ct_mel_launch(const void* wav, const void* e32, const void* e64, const void* tw,
                             const void* win, const void* mel, const void* mel_lo,
                             const void* mel_hi, void* out, int n_rows, int n_frames,
                             long long n_pad, int hop, int n_mels, void* stream) {
  if (n_rows < 0 || n_frames < 1 || hop < 1 || n_mels < 1 || n_pad < NFFT)
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaMemcpyToSymbolAsync(c_e32, e32, sizeof(c_e32), 0, cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(float) * (FB * NFFT + 2 * ROWS * BS + 2 * N1 * K1C);
  err = cudaFuncSetAttribute(ct_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ct_mel_kernel, THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  const long long groups = ((long long)n_rows + FB - 1) / FB;
  const long long cap = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const unsigned blocks = (unsigned)(groups < cap ? groups : cap);
  ct_mel_kernel<<<blocks, THREADS, smem, s>>>(
      static_cast<const float*>(wav), static_cast<const float*>(e64),
      static_cast<const float*>(tw), static_cast<const float*>(win),
      static_cast<const float*>(mel), static_cast<const int*>(mel_lo),
      static_cast<const int*>(mel_hi), static_cast<float*>(out), n_rows, n_frames, n_pad, hop,
      n_mels);
  return (int)cudaGetLastError();
}
