// Mel power through a packed real 2048-point FFT, one warp per frame row, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel ops/ct_mel.py (function
// _ct_mel_parts, pallas_call at line 246): waveforms (B, n_sig) -> mel power
// (B * n_frames, n_mels). Frame row r = u * T + f starts at sample
// s = f * hop - left of row u and is x[n] = wav[u * n_sig + reflect(s + n)] *
// win[n], n = 0..2047, where reflect mirrors an index off either end of the
// row as librosa's center reflect pad does (i < 0 -> -i, i >= n_sig ->
// 2 (n_sig - 1) - i). A raw waveform comes with left = n_fft / 2, a padded one
// with left = 0 (its frames never reach past the row); out[r, m] = sum_k
// |X[k]|^2 mel[k, m] over bins k = 0..1024 of the frame's DFT X.
//
// Bound. Per frame a real FFT needs 2.5 N log2 N + N (window) + 3 (N/2 + 1)
// (|X|^2) + 2 nnz(mel) operations: 65.4k at parity (1,994 nonzero mel
// weights). At B = 8192 two-second utterances (516,096 frames) that is 33.8
// GFLOP, 0.50 ms at the card's 67 TFLOP/s of fp32; the bytes (1.049 GB of raw
// waveform read once, 132 MB written) take 0.35 ms at 3.35 TB/s. So
// operations bound it, at 0.50 ms. This design does about 65k flops per frame
// (two passes of 32 x 32-point radix-2 FFTs 33.5k, twiddles 6.1k, the real
// split and |X|^2 19.5k, window and mel 6k), all fp32 outside the tensor
// cores: at this count the FFT is cheap, and fp32 keeps the dB check. Reading
// the raw waveform, with the reflection in the addressing, spares the
// separate pad's read and its 1.116-GB padded copy.
//
// Design (W_N = exp(-2 pi i / N)):
//  1. One warp per frame row; a block holds 8 warps on 8 consecutive rows,
//     so the 4x overlap of frames at hop 512 hits in L1 / L2. A warp past
//     the last row exits (there is no block barrier).
//  2. Pack: z[m] = x[2m] + i x[2m+1], m = 0..1023. Lane a loads z[a + 32 b],
//     b = 0..31, as a float2 at sample s + 2a + 64b (each b is one 256-byte
//     warp load) and multiplies by the window pair. float2 loads need 8-byte-
//     aligned frames: the launcher picks the 4-byte-load instance otherwise
//     (an odd n_sig, left or hop, e.g. 32001 samples). Only an edge frame,
//     one that reaches past either end of its row (at parity frames 0, 1,
//     T-2 and T-1 of a raw waveform, none of a padded one), reflects: its
//     lanes load each sample through reflect() with 4-byte loads, the
//     index math in 32-bit offsets from the frame's first sample inside
//     the row. One warp holds one frame, so the branch is warp-uniform
//     and the interior frames run the plain loads.
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
//  8. The dB instance (DB, entry ct_mel_db_launch) writes power_to_db(S, ref = max,
//     amin = 1e-10, top_db) of each utterance instead of its power S: one block per
//     utterance, warp w taking frames w, w + 8, ... through steps 2-6 unchanged and step 7's
//     sums unchanged, so each power is bitwise the power-only instance's. Step 7 stores
//     l = 10 log10(max(S, amin)) to the block's (T, n_mels) tile in shared memory, each
//     lane keeping its running max of S and of l. After one barrier the block has Smax and
//     lmax, ref = 10 log10(max(Smax, amin)), ls = l - ref, its peak exactly lmax - ref
//     (rounding is monotone, so the max commutes with subtracting ref) and
//     max(ls, peak - top_db). Each product and difference is rounded on its own
//     (__fmul_rn, __fsub_rn, accurate log10f), as torch's separate kernels round them, with
//     their NaN propagation; the result goes to out in the power's (B, T, n_mels) layout, so
//     no power tensor reaches device memory. The dB adds ~10 operations an output value,
//     under 0.1% of a frame's 65.4k: the bound is the same (the launch takes 2.56 ms against
//     the power-only 2.47 at B = 8192, parity; log10f is many instructions). The mel tile caps
//     T * n_mels where two blocks an SM still fit (the wrapper's refusal "tile"); the grain
//     is an utterance (B blocks), where the power-only instance's is 8 frame rows. Four
//     warps a block (four blocks an SM) and sixteen (one) were slower.
// Every twiddle comes from float64 on the host or from the W_32 literals
// below; no sincos runs on the card.

#include <cuda_runtime.h>
#include <math_constants.h>

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

// Index i of a signal of n, mirrored off either end as librosa's reflect pad (one bounce).
__device__ __forceinline__ int reflect(int i, int n) { return i < 0 ? -i : i >= n ? 2 * (n - 1) - i : i; }

// max(a, b) that returns NaN where either is NaN, as torch's clamp, amax and maximum do.
__device__ __forceinline__ float max_nan(float a, float b) { return (a != a || a > b) ? a : b; }

constexpr float AMIN = 1e-10f;  // the dB instance's amin

// Step 7's store of filter m's power S: S itself, or with DB l = 10 log10(max(S, amin)) (each
// product rounded on its own, accurate log10f), keeping the running maxima of S and of l.
template <bool DB>
__device__ __forceinline__ void put(float* orow, int m, float s, float& smax, float& lmax) {
  if constexpr (DB) {
    const float l = __fmul_rn(10.0f, log10f(max_nan(s, AMIN)));
    smax = max_nan(smax, s);
    lmax = max_nan(lmax, l);
    orow[m] = l;
  } else {
    orow[m] = s;
  }
}

// Steps 2-7 for the frame that starts at sample s of `row` (n_sig samples): its n_mels mel
// values (put<DB>) to orow (device or shared memory), through the warp's transpose tile, which
// holds the frame's power row on return.
template <bool VEC, bool DB>
__device__ __forceinline__ void frame_mel(const float* __restrict__ row, long long s, long long n_sig,
                                          const float2* __restrict__ win,
                                          const float2* __restrict__ tw1,
                                          const float2* __restrict__ tw2,
                                          const float* __restrict__ melw,
                                          const int* __restrict__ spans, float2* tile, float* orow,
                                          int n_mels, int lane, float& smax, float& lmax) {
  // 2. pack and window: register b holds z[lane + 32 b], samples s + 2 lane + 64 b and the next
  float re[R], im[R];
  if (s >= 0 && s + NFFT <= n_sig) {  // interior frame
    const float* src = row + s + 2 * lane;
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
  } else {  // edge frame: each sample index reflected, in int offsets from org
    // a left edge (s < 0) reflects about the row's start: org = row, k = s + j; a right edge
    // about its end: org = row + s, k = j, and m = n_sig - s < 2048 puts the end at the same
    // place. m = 2048 where the frame stays short of the end, so nothing reflects there.
    const long long at = s > 0 ? s : 0;
    const float* org = row + at;
    const int d = (int)(s - at), m = (int)min(n_sig - at, (long long)NFFT);
#pragma unroll
    for (int b = 0; b < R; ++b) {
      const int k = d + 2 * lane + 64 * b;
      const float2 w = __ldg(win + lane + 32 * b);
      re[b] = __ldg(org + reflect(k, m)) * w.x;
      im[b] = __ldg(org + reflect(k + 1, m)) * w.y;
    }
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
  for (int m = lane; m < (n_mels + 1) / 2; m += R) {
    put<DB>(orow, m, filter_sum(pw, melw, spans, m, n_mels, lane), smax, lmax);
    const int m2 = n_mels - 1 - m;
    if (m2 != m) put<DB>(orow, m2, filter_sum(pw, melw, spans, m2, n_mels, lane), smax, lmax);
  }
}

// The block's max_nan of every thread's a and of its b, for every thread, through red[2 WARPS].
// Max is exact, so the order of the reduction does not show. The barrier also makes every
// warp's stores to shared memory before it visible to the block.
__device__ __forceinline__ float2 block_max(float a, float b, float* red) {
#pragma unroll
  for (int o = R / 2; o; o >>= 1) {
    a = max_nan(a, __shfl_xor_sync(FULL, a, o));
    b = max_nan(b, __shfl_xor_sync(FULL, b, o));
  }
  if ((threadIdx.x & (R - 1)) == 0) {
    red[threadIdx.x / R] = a;
    red[WARPS + threadIdx.x / R] = b;
  }
  __syncthreads();
  a = red[0];
  b = red[WARPS];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) {
    a = max_nan(a, red[w]);
    b = max_nan(b, red[WARPS + w]);
  }
  return make_float2(a, b);
}

// 8. The rest of power_to_db(S, ref = max, amin, top_db) on one utterance's n values
// l = 10 log10(max(S, amin)) in shared memory, whose maxima over the thread are smax (of S) and
// lmax (of l), to out; top_db < 0 leaves the clip out. ls = l - ref, and its peak is exactly
// lmax - ref: rounding is monotone, so max(l - ref) = max(l) - ref, NaN and inf alike.
__device__ __forceinline__ void db_epilogue(const float* mel, int n, float smax, float lmax,
                                            float* __restrict__ out, float top_db, float* red) {
  const float2 mx = block_max(smax, lmax, red);
  const float ref = __fmul_rn(10.0f, log10f(max_nan(mx.x, AMIN)));
  const float clip = __fsub_rn(__fsub_rn(mx.y, ref), top_db);
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const float ls = __fsub_rn(mel[i], ref);
    out[i] = top_db < 0.0f ? ls : max_nan(ls, clip);
  }
}

template <bool VEC, bool DB>
__global__ void __launch_bounds__(THREADS, 2)
ct_mel_kernel(const float* __restrict__ wav, const float2* __restrict__ win,
              const float2* __restrict__ tw1, const float2* __restrict__ tw2,
              const float* __restrict__ melw, const int* __restrict__ spans,
              float* __restrict__ out, int n_rows, int n_frames, long long n_sig, int left,
              int hop, int n_mels, float top_db) {
  // [WARPS][R * TS] float2, then with DB the (n_frames, n_mels) mel tile and red[2 WARPS]
  extern __shared__ float2 smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float2* tile = smem + warp * (R * TS);
  float smax = -CUDART_INF_F, lmax = -CUDART_INF_F;
  if constexpr (!DB) {
    const int r = blockIdx.x * WARPS + warp;
    if (r >= n_rows) return;
    frame_mel<VEC, false>(wav + (long long)(r / n_frames) * n_sig, (long long)(r % n_frames) * hop - left,
                          n_sig, win, tw1, tw2, melw, spans, tile, out + (long long)r * n_mels, n_mels,
                          lane, smax, lmax);
  } else {  // 8. block u holds utterance u
    float* mel = reinterpret_cast<float*>(smem + WARPS * R * TS);
    const int n = n_frames * n_mels;
    const float* row = wav + (long long)blockIdx.x * n_sig;
    for (int f = warp; f < n_frames; f += WARPS) {
      frame_mel<VEC, true>(row, (long long)f * hop - left, n_sig, win, tw1, tw2, melw, spans, tile,
                           mel + f * n_mels, n_mels, lane, smax, lmax);
      __syncwarp();  // every lane has read the power row: the next frame may write the tile
    }
    db_epilogue(mel, n, smax, lmax, out + (long long)blockIdx.x * n, top_db, mel + n);
  }
}

// Dynamic shared memory of a block: the warps' transpose tiles, and with DB the mel tile and red.
constexpr size_t TILES_SMEM = sizeof(float2) * WARPS * R * TS;  // 67,584 bytes
size_t smem_bytes(bool db, int n_frames, int n_mels) {
  return TILES_SMEM + (db ? sizeof(float) * ((size_t)n_frames * n_mels + 2 * WARPS) : 0);
}
// The dB instance's cap: two blocks, each with the 1 KB the runtime reserves, in an SM's 228 KB
constexpr size_t DB_SMEM_MAX = (228 * 1024) / 2 - 1024;  // 115,712 bytes

template <bool VEC, bool DB>
cudaError_t launch(const float* wav, const float2* win, const float2* tw1, const float2* tw2,
                   const float* melw, const int* spans, float* out, int n_rows, int n_frames,
                   long long n_sig, int left, int hop, int n_mels, float top_db, cudaStream_t s) {
  const size_t smem = smem_bytes(DB, n_frames, n_mels);
  cudaError_t err = cudaFuncSetAttribute(ct_mel_kernel<VEC, DB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // power: 8 frame rows a block; dB: one utterance (n_frames rows) a block
  const unsigned blocks = (unsigned)(DB ? n_rows / n_frames : ((long long)n_rows + WARPS - 1) / WARPS);
  ct_mel_kernel<VEC, DB><<<blocks, THREADS, smem, s>>>(wav, win, tw1, tw2, melw, spans, out, n_rows,
                                                       n_frames, n_sig, left, hop, n_mels, top_db);
  return cudaGetLastError();
}

// Checks and launches either instance; db selects the dB epilogue (top_db < 0: no clip).
int launch_checked(bool db, const void* wav, const void* win, const void* tw1, const void* tw2,
                   const void* melw, const void* spans, void* out, int n_rows, int n_frames,
                   long long n_sig, int left, int hop, int n_mels, float top_db, void* stream) {
  // one bounce must bring every index a frame reaches into [0, n_sig)
  if (n_rows < 0 || n_frames < 1 || hop < 1 || n_mels < 1 || left < 0 || left >= n_sig ||
      (long long)(n_frames - 1) * hop - left + NFFT - 1 > 2 * (n_sig - 1))
    return (int)cudaErrorInvalidValue;
  if (db && (n_rows % n_frames || smem_bytes(true, n_frames, n_mels) > DB_SMEM_MAX || top_db != top_db))
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(win) | reinterpret_cast<uintptr_t>(tw1) |
       reinterpret_cast<uintptr_t>(tw2)) % 8)
    return (int)cudaErrorMisalignedAddress;
  if (n_rows == 0) return (int)cudaSuccess;
  const bool vec = reinterpret_cast<uintptr_t>(wav) % 8 == 0 && n_sig % 2 == 0 && left % 2 == 0 &&
                   hop % 2 == 0;
  const auto go = db ? (vec ? &launch<true, true> : &launch<false, true>)
                     : (vec ? &launch<true, false> : &launch<false, false>);
  return (int)go(static_cast<const float*>(wav), static_cast<const float2*>(win),
                 static_cast<const float2*>(tw1), static_cast<const float2*>(tw2),
                 static_cast<const float*>(melw), static_cast<const int*>(spans),
                 static_cast<float*>(out), n_rows, n_frames, n_sig, left, hop, n_mels, top_db,
                 static_cast<cudaStream_t>(stream));
}

}  // namespace

// Plain C entry points (bound with ctypes). Pointers are device pointers to
// contiguous arrays: wav (B, n_sig) f32, raw (left = 1024) or center-padded
// (left = 0), every frame's reach reflecting into its row; win (2048,) f32 (read as 1024
// float2 pairs); tw1 (32 c, 32 a, 2) f32 = W_1024^(a c); tw2 (1025, 2) f32 =
// W_2048^k; melw (rows, 32) f32 the mel weights lane by lane; spans (3,
// n_mels) int32 = each filter's first and last-plus-one nonzero bin and the
// row of its first weight in melw; out (n_rows, n_mels) f32 with n_rows = B *
// n_frames. win, tw1 and tw2 must be 8-byte aligned. Interior frames are read
// as float2 when wav is 8-byte aligned and n_sig, left and hop are even, else
// as floats. Launches on `stream`; returns the first cudaError_t (0 on success).
//
// ct_mel_launch writes the mel power.
extern "C" int ct_mel_launch(const void* wav, const void* win, const void* tw1, const void* tw2,
                             const void* melw, const void* spans, void* out, int n_rows,
                             int n_frames, long long n_sig, int left, int hop, int n_mels,
                             void* stream) {
  return launch_checked(false, wav, win, tw1, tw2, melw, spans, out, n_rows, n_frames, n_sig, left,
                        hop, n_mels, 0.0f, stream);
}

// ct_mel_db_launch writes power_to_db of each utterance's (n_frames, n_mels) power, ref = its
// max, amin 1e-10, clipped top_db below its peak (top_db < 0: no clip; NaN is refused); the
// mel tile must leave two blocks an SM (4 (n_frames n_mels + 16) + 67,584 <= 115,712 bytes).
extern "C" int ct_mel_db_launch(const void* wav, const void* win, const void* tw1, const void* tw2,
                                const void* melw, const void* spans, void* out, int n_rows,
                                int n_frames, long long n_sig, int left, int hop, int n_mels,
                                float top_db, void* stream) {
  return launch_checked(true, wav, win, tw1, tw2, melw, spans, out, n_rows, n_frames, n_sig, left,
                        hop, n_mels, top_db, stream);
}
