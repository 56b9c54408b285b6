// Mel power straight from raw waveforms or from gathered frames, for Hopper (sm_90a).
//
// Replaces two of the JAX package's Pallas TPU kernels with one core:
// ops/wave_mel.py (function wave_mel, body lines 91-142; entry
// wave_mel_launch, K1) and ops/fused_logmel.py (function
// fused_mel_from_frames, body _kernel lines 68-81; entry frames_mel_launch,
// K2). Center-padded waveforms (B, n_pad), or frames (N, n_fft) read as
// n_frames = 1 rows at stride n_fft, -> mel power (n_rows, n_mels), computing
//
//   out[r, m] = sum_k ((sum_n x_r[n] cos[n, k])^2 + (sum_n x_r[n] sin[n, k])^2) * mel[k, m]
//
// for every frame row r = u * n_frames + f, whose samples x_r are read
// straight from the waveform at u * n_pad + f * hop. No frame matrix ever
// exists in device memory.
//
// Design. One block owns ROWS frame rows of the flattened B * n_frames axis
// and walks the frequency axis in tiles of KT bins inside the block (the
// TPU kernel's sequential k grid axis; nothing carries between blocks). For
// each tile it stages NC-sample chunks of its frames and of the cos/sin
// bases through shared memory and accumulates re and im in registers with
// fp32 FMA (each of the 256 threads owns 4 rows x 4 bins), squares and adds
// them into a power tile in shared memory, and contracts that tile against
// the (KT, n_mels) mel tile into a (ROWS, n_mels) accumulator that stays in
// registers until the single store at the end. The ragged last row tile is
// masked, so any batch size is taken. The samples and bases are of element
// type T: float (K1, and K2 in float32) or __nv_bfloat16 (K2's bf16
// operands), widened to float as they are staged, so every product and sum
// is fp32 (a bf16 x bf16 product is exact in fp32). The mel matrix is fp32.
//
// Bounds. The DFT products dominate: 2 * 2 * n_fft * k_pad operations per
// frame row (about 4.6 TFLOP at n_fft 2048 for 8192 two-second
// utterances), on the fp32 FMA pipes, not the tensor cores, so the card's
// non-tensor fp32 rate bounds this version. The operands that every block
// re-reads are the padded bases: 17.8 MB at n_fft 2048. On the TPU they
// could not stay in VMEM next to a frame tile and re-streamed from HBM for
// every utterance tile (the reason that kernel lost); here they stay
// resident in the 50 MB L2 across all blocks, and the raw samples of a
// block's rows (overlapping frames) are re-read from L2/L1 per tile.
// K2 does the same work on a frame matrix; in bf16 it reads half the bytes
// but the fp32 FMA and shared-load work is unchanged, so it is no faster.
// Tensor-core (wgmma/TF32) products, TMA staging and skipping the zero bins
// of the sparse mel triangles are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 64;      // frame rows per block
constexpr int KT = 64;        // frequency bins per tile (K_TILE in ops/wave_mel.py)
constexpr int NC = 32;        // samples of the DFT sum staged per step
constexpr int THREADS = 256;  // 16 x 16 threads, each 4 rows x 4 columns
constexpr int FS = NC + 1;    // padded row stride of the staged frames
constexpr int PS = KT + 1;    // padded row stride of the power tile

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <int MJ, typename T>  // mel columns per thread (n_mels <= 16 * MJ); element type
__global__ void __launch_bounds__(THREADS)
wave_mel_kernel(const T* __restrict__ wav, const T* __restrict__ cosb,
                const T* __restrict__ sinb, const float* __restrict__ mel,
                float* __restrict__ out, int n_rows, int n_frames, long long n_pad,
                int n_fft, int hop, int k_pad, int n_mels) {
  constexpr int MP = 16 * MJ;
  extern __shared__ float smem[];
  float* fr_s = smem;                // [ROWS][FS]  frame samples n0 .. n0+NC
  float* cos_s = fr_s + ROWS * FS;   // [NC][KT]
  float* sin_s = cos_s + NC * KT;    // [NC][KT]
  float* pow_s = sin_s + NC * KT;    // [ROWS][PS]  |X|^2 of the current tile
  float* mel_s = pow_s + ROWS * PS;  // [KT][MP]    mel tile, zero past n_mels

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // owns bins / mels tx + 16 j
  const int ty = tid >> 4;  // owns rows ty + 16 i
  const long long row0 = (long long)blockIdx.x * ROWS;

  // Frame staging: element e = tid + THREADS * q of the [ROWS][NC] chunk is
  // row (tid >> 5) + 8 q, sample tid & 31. Each thread's 8 row starts are
  // fixed for the whole kernel; -1 marks a row past the end.
  const int sc = tid & (NC - 1);
  long long fr_off[ROWS * NC / THREADS];
#pragma unroll
  for (int q = 0; q < ROWS * NC / THREADS; ++q) {
    const long long r = row0 + (tid >> 5) + 8 * q;
    fr_off[q] = r < n_rows ? (r / n_frames) * n_pad + (r % n_frames) * (long long)hop : -1;
  }

  float macc[4][MJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < MJ; ++j) macc[i][j] = 0.f;

  for (int k0 = 0; k0 < k_pad; k0 += KT) {
    float re[4][4], im[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) re[i][j] = im[i][j] = 0.f;

    for (int n0 = 0; n0 < n_fft; n0 += NC) {
      const bool in_fft = n0 + sc < n_fft;
#pragma unroll
      for (int q = 0; q < ROWS * NC / THREADS; ++q) {
        const int r = (tid >> 5) + 8 * q;
        fr_s[r * FS + sc] = (fr_off[q] >= 0 && in_fft) ? to_f32(wav[fr_off[q] + n0 + sc]) : 0.f;
      }
      // Basis staging: element e = tid + THREADS * q of [NC][KT] is sample
      // (tid >> 6) + 4 q, bin tid & 63 (coalesced along the bins).
#pragma unroll
      for (int q = 0; q < NC * KT / THREADS; ++q) {
        const int n = (tid >> 6) + 4 * q;
        const int k = tid & (KT - 1);
        const bool ok = n0 + n < n_fft;
        const long long g = (long long)(n0 + n) * k_pad + k0 + k;
        cos_s[n * KT + k] = ok ? to_f32(cosb[g]) : 0.f;
        sin_s[n * KT + k] = ok ? to_f32(sinb[g]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int n = 0; n < NC; ++n) {
        float a[4], c[4], s[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = fr_s[(ty + 16 * i) * FS + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          c[j] = cos_s[n * KT + tx + 16 * j];
          s[j] = sin_s[n * KT + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            re[i][j] = fmaf(a[i], c[j], re[i][j]);
            im[i][j] = fmaf(a[i], s[j], im[i][j]);
          }
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        pow_s[(ty + 16 * i) * PS + tx + 16 * j] = re[i][j] * re[i][j] + im[i][j] * im[i][j];
    for (int e = tid; e < KT * MP; e += THREADS) {
      const int k = e / MP, m = e % MP;
      mel_s[e] = m < n_mels ? mel[(long long)(k0 + k) * n_mels + m] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < KT; ++k) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = pow_s[(ty + 16 * i) * PS + k];
#pragma unroll
      for (int j = 0; j < MJ; ++j) {
        const float w = mel_s[k * MP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) macc[i][j] = fmaf(p[i], w, macc[i][j]);
      }
    }
    __syncthreads();  // pow_s / mel_s are rewritten by the next tile
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long r = row0 + ty + 16 * i;
    if (r >= n_rows) continue;
#pragma unroll
    for (int j = 0; j < MJ; ++j) {
      const int m = tx + 16 * j;
      if (m < n_mels) out[r * n_mels + m] = macc[i][j];
    }
  }
}

template <int MJ, typename T>
cudaError_t launch(const T* wav, const T* cosb, const T* sinb, const float* mel,
                   float* out, int n_rows, int n_frames, long long n_pad, int n_fft, int hop,
                   int k_pad, int n_mels, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (ROWS * FS + 2 * NC * KT + ROWS * PS + KT * 16 * MJ);
  cudaError_t err = cudaFuncSetAttribute(
      wave_mel_kernel<MJ, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((n_rows + ROWS - 1) / ROWS);
  wave_mel_kernel<MJ, T><<<blocks, THREADS, smem, stream>>>(
      wav, cosb, sinb, mel, out, n_rows, n_frames, n_pad, n_fft, hop, k_pad, n_mels);
  return cudaGetLastError();
}

template <typename T>
int launch_any(const void* wav, const void* cosb, const void* sinb, const void* mel, void* out,
               int n_rows, int n_frames, long long n_pad, int n_fft, int hop, int k_pad,
               int n_mels, void* stream) {
  if (n_rows < 0 || n_frames < 1 || n_fft < 1 || hop < 1 || k_pad % KT != 0 || n_mels < 1 ||
      n_mels > 128)
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* w = static_cast<const T*>(wav);
  const T* c = static_cast<const T*>(cosb);
  const T* sn = static_cast<const T*>(sinb);
  const float* m = static_cast<const float*>(mel);
  float* o = static_cast<float*>(out);
  if (n_mels <= 64)
    return (int)launch<4, T>(w, c, sn, m, o, n_rows, n_frames, n_pad, n_fft, hop, k_pad, n_mels, s);
  return (int)launch<8, T>(w, c, sn, m, o, n_rows, n_frames, n_pad, n_fft, hop, k_pad, n_mels, s);
}

}  // namespace

// Plain C entry point (bound with ctypes). Pointers are device pointers to
// contiguous float32: wav (B, n_pad), cosb and sinb (n_fft, k_pad), mel
// (k_pad, n_mels), out (n_rows, n_mels) with n_rows = B * n_frames. Launches
// on `stream` and returns the launch's cudaError_t (0 on success).
extern "C" int wave_mel_launch(const void* wav, const void* cosb, const void* sinb,
                               const void* mel, void* out, int n_rows, int n_frames,
                               long long n_pad, int n_fft, int hop, int k_pad, int n_mels,
                               void* stream) {
  return launch_any<float>(wav, cosb, sinb, mel, out, n_rows, n_frames, n_pad, n_fft, hop, k_pad,
                           n_mels, stream);
}

// Second entry point (K2): frames (n_rows, n_fft) in place of the waveform,
// each row one frame (n_frames = 1, stride n_fft). frames, cosb and sinb are
// float32 when bf16 == 0 and bfloat16 otherwise; mel and out are float32.
extern "C" int frames_mel_launch(const void* frames, const void* cosb, const void* sinb,
                                 const void* mel, void* out, int n_rows, int n_fft, int k_pad,
                                 int n_mels, int bf16, void* stream) {
  if (bf16)
    return launch_any<__nv_bfloat16>(frames, cosb, sinb, mel, out, n_rows, 1, n_fft, n_fft, n_fft,
                                     k_pad, n_mels, stream);
  return launch_any<float>(frames, cosb, sinb, mel, out, n_rows, 1, n_fft, n_fft, n_fft, k_pad,
                           n_mels, stream);
}
