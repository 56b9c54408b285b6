// CQCC of raw fp32 waveforms in one launch, for Hopper (sm_90a): the 84-bin
// constant-Q transform and its cepstral tail, one block per utterance.
//
// Replaces no kernel of the JAX package (it has no Pallas CQT; XLA computes
// it). It replaces the port's plain chain on the card (frontend/cqt.py +
// cqcc.py + dct.py): per octave an SGEMM against a mostly-zero operator, a
// banded-Toeplitz SGEMM per decimation over a torch.cat copy of the signal,
// then eight elementwise passes over the (B, 84, T) map, every intermediate
// through device memory (19.1 ms a B = 8192 call of 2-s clips).
//
// What it computes, for sr 16000, hop 512, 84 bins from C1, 12 an octave,
// filter_scale 1, 19 cepstra (the one configuration it is built for; the
// tables come from the plain path's cached host operators):
//  - level 0 is the waveform; level j+1 is the 63-tap half-band FIR at stride
//    2 of level j, y[t] = sum_i h[i] x[2t + i - 31], zeros outside the level;
//  - octave j (counted from the top, 12 bins, level j, hop 512 / 2^j): bin
//    i's complex filter over its own support, frame m centred at m hop, zeros
//    past either end; |X|^2 = re^2 + im^2 (the plain path's sqrt is squared
//    again by amplitude_to_db, so it goes);
//  - dB = 10 log10(max(P, 1e-10)) - 10 log10(max(max P, 1e-10)) per
//    utterance, floored at its peak - 80; the linear regrid (two weights a
//    row); log(x^2 + 1e-12); the orthonormal DCT-II, rows 0..18 -> out
//    (B, 19, T), T = 1 + n / 512. The tail rounds as the plain path does
//    (no contraction into FMAs; accurate log10f and logf, no fast math).
//
// Bound. The benchmark's yardstick counts 6.24 MFLOP an utterance (each
// bin's filter over its support, the decimation at 2 FLOP a tap and output,
// the regrid and the DCT): 51.1 GFLOP at B = 8192, 0.76 ms at 67 TFLOP/s of
// fp32. The waveform read once is 1.05 GB, 0.31 ms at 3.35 TB/s. Operations
// bound it, at 0.76 ms. All of it is fp32 FFMA (no TF32, no tensor cores).
//
// Design (384 threads, 80 registers, two blocks an SM at n = 32,000: 112.8 KB
// of shared memory each):
//  1. Shared memory holds levels 1-6 in two ping-pong buffers, A (level 1,
//     then 3 and 5) and B (2, 4, 6), each level between 64-sample zero guards,
//     so no read past either end needs a test; the (84, T) power map (octaves
//     0-1 in their own rows, 2-6 in A's tail, free once level 1 is spent);
//     and the current octave's filters. Nothing but the waveform and the
//     tables is read from device memory, and only the (19, T) CQCC written.
//  2. Phase 0 streams the waveform in tiles of 3,072 samples (six octave-0
//     frames) and their 64-sample halos, double buffered in B by cp.async.
//     Of each tile, 256 threads compute the 1,536 level-1 samples and three
//     warps octave 0's 12 bins over the six frames. Phase j = 1..6 computes
//     octave j and level j+1 from level j, its tasks shared by all threads.
//  3. A decimation task is 6 consecutive outputs: a 76-sample window in 19
//     float4 registers and 378 FFMAs against the taps, which live in the
//     kernel's parameters (constant-bank operands). Neighbouring lanes' windows
//     are 12 floats apart, so a quarter-warp's float4 loads hit distinct banks.
//  4. A CQT task of octaves 1-6 is one bin over 4 frames (f0 + 16 r): per
//     4-tap chunk two float4 filter loads and four float4 signal loads for 32
//     FFMAs. Each bin's span is its support widened to whole aligned chunks
//     (at most 3 zero taps a side, 2.8% of the taps, which add exact zeros).
//     A lane starts at chunk f0 and wraps, so the 8 lanes of a quarter-warp,
//     whose frames lie a multiple of 8 floats apart, read distinct banks.
//     Octave 0 spreads a bin's chunks over 8 lanes (lane q sums chunks q,
//     q + 8, ...) for the tile's six frames, and adds them by shuffles.
//  5. The tail: two block maxima (the reference, the peak), the dB map in
//     place, regrid + log into B, and the DCT with lanes over frames, the
//     regrid rows and the DCT rows in the spent filters' shared memory.
//  The CQT tasks are bound by shared-memory loads, the decimation by FFMA
//  issue; on an H100 the launch runs at ~33% of the operations bound.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int OCTAVES = 7;
constexpr int BINS = 12;                   // bins an octave
constexpr int N_BINS = OCTAVES * BINS;     // 84
constexpr int N_CEPS = 19;
constexpr int HOP = 512;
constexpr int TAPS = 63;                   // half-band FIR
constexpr int THREADS = 384;
constexpr int WARPS = THREADS / 32;
constexpr int G = 64;                      // zero guard either side of a level (samples)
constexpr int TILE = 6 * HOP;              // level-0 samples a tile: six octave-0 frames
constexpr int TILE_BUF = TILE + 2 * G;
constexpr int R = 6;                       // decimated outputs a task
constexpr int TILE_TASKS = TILE / 2 / R;   // 256 threads decimate a tile; the next 96 take octave 0
constexpr int WIN = 76;                    // samples a decimation task loads: 2R + 62 in whole float4s
constexpr int PHASES = 16;                 // frame phases: a CQT task takes frames f0 + 16 r
constexpr int F = 4;                       // frames a CQT task
constexpr int CQT_TASKS = BINS * PHASES;   // 192, a multiple of 32: task kinds never share a warp
constexpr int T_MAX = PHASES * F;          // 64 frames
constexpr int MIN_N = HOP;
constexpr int MAX_N = (T_MAX - 1) * HOP + 448;  // 32,704: the largest multiple of 64 with T <= 64
constexpr int COEF_CAP = 2400;            // floats of one octave's filters, at most (2,320 used)
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  float fir[64];              // the half-band taps (63 used)
  int a_lo[OCTAVES][BINS];    // first tap of the bin's span from the frame centre, a multiple of 4
  int nc[OCTAVES][BINS];      // 4-tap chunks of the span
  int off[OCTAVES][BINS];     // the bin's real row in the octave's table; its imaginary row is half a table on
  int oct_off[OCTAVES];       // the octave's table in the packed filters
  int oct_len[OCTAVES];       // floats of the table: real rows, then imaginary rows
};

struct Layout {  // float offsets into dynamic shared memory
  int a, b, m0, coef, scratch, total;
  __host__ __device__ explicit Layout(int n) {
    const int t = 1 + n / HOP;
    a = 0;
    b = a + 2 * G + n / 2;
    const int b_len = 2 * G + n / 4 > 2 * TILE_BUF ? 2 * G + n / 4 : 2 * TILE_BUF;
    m0 = b + b_len;
    coef = m0 + 2 * BINS * t;
    scratch = coef + COEF_CAP;
    total = scratch + 32;
  }
};

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// Row of the power map for slot s = 12 j + i (octave j from the top, bin i
// within it): octaves 0-1 in their own rows, 2-6 in A past level 3.
__device__ __forceinline__ float* map_row(float* smem, const Layout& L, int n, int t, int s) {
  return s < 2 * BINS ? smem + L.m0 + s * t : smem + L.a + 2 * G + n / 8 + (s - 2 * BINS) * t;
}

// Slot of global bin r (lowest first): octave j = (83 - r) / 12, bin r - 72 + 12 j.
__device__ __forceinline__ int slot_of_bin(int r) {
  const int j = (N_BINS - 1 - r) / BINS;
  return r - (N_BINS - BINS) + 2 * BINS * j;
}

// 6 outputs of the half-band FIR at stride 2: win is level + 2 t0 - 32
// (16-byte aligned), dst is level' + t0; the first `valid` are stored.
__device__ __forceinline__ void decimate(const Params& p, const float* win, float* dst, int valid) {
  float w[WIN];
#pragma unroll
  for (int q = 0; q < WIN / 4; ++q) {
    const float4 v = ld4(win + 4 * q);
    w[4 * q] = v.x;
    w[4 * q + 1] = v.y;
    w[4 * q + 2] = v.z;
    w[4 * q + 3] = v.w;
  }
  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.0f;
#pragma unroll
  for (int i = 0; i < TAPS; ++i)
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = fmaf(p.fir[i], w[2 * r + i + 1], acc[r]);
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (r < valid) dst[r] = acc[r];
}

// One bin over NF frames: x[f] holds the frame's first span sample (centre +
// a_lo, 16-byte aligned); cre/cim the bin's nc chunks of filter taps. The
// chunks run from `rot` and wrap. Returns re^2 + im^2 of each frame.
template <int NF>
__device__ __forceinline__ void cqt_bin(const float* const (&x)[NF], const float* cre, const float* cim, int nc,
                                        int rot, float (&pw)[NF]) {
  float ar[NF], ai[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) ar[f] = ai[f] = 0.0f;
  int cc = rot;
  for (int c = 0; c < nc; ++c) {
    const float4 re = ld4(cre + 4 * cc), im = ld4(cim + 4 * cc);
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const float4 v = ld4(x[f] + 4 * cc);
      ar[f] = fmaf(re.x, v.x, ar[f]);
      ar[f] = fmaf(re.y, v.y, ar[f]);
      ar[f] = fmaf(re.z, v.z, ar[f]);
      ar[f] = fmaf(re.w, v.w, ar[f]);
      ai[f] = fmaf(im.x, v.x, ai[f]);
      ai[f] = fmaf(im.y, v.y, ai[f]);
      ai[f] = fmaf(im.z, v.z, ai[f]);
      ai[f] = fmaf(im.w, v.w, ai[f]);
    }
    cc = cc + 1 == nc ? 0 : cc + 1;
  }
#pragma unroll
  for (int f = 0; f < NF; ++f) pw[f] = __fadd_rn(__fmul_rn(ar[f], ar[f]), __fmul_rn(ai[f], ai[f]));
}

// One bin over NF frames with its chunks spread over the 8 lanes of a
// quarter-warp: lane q sums chunks q, q + 8, ..., so the 8 lanes read 8
// neighbouring chunks (distinct banks), and three shuffles add the partial
// sums. Every lane of the warp calls it. Returns re^2 + im^2 of each frame.
template <int NF>
__device__ __forceinline__ void cqt_bin_split(const float* const (&x)[NF], const float* cre, const float* cim, int nc,
                                              int q, float (&pw)[NF]) {
  float ar[NF], ai[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) ar[f] = ai[f] = 0.0f;
  for (int c = q; c < nc; c += 8) {
    const float4 re = ld4(cre + 4 * c), im = ld4(cim + 4 * c);
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const float4 v = ld4(x[f] + 4 * c);
      ar[f] = fmaf(re.x, v.x, ar[f]);
      ar[f] = fmaf(re.y, v.y, ar[f]);
      ar[f] = fmaf(re.z, v.z, ar[f]);
      ar[f] = fmaf(re.w, v.w, ar[f]);
      ai[f] = fmaf(im.x, v.x, ai[f]);
      ai[f] = fmaf(im.y, v.y, ai[f]);
      ai[f] = fmaf(im.z, v.z, ai[f]);
      ai[f] = fmaf(im.w, v.w, ai[f]);
    }
  }
#pragma unroll
  for (int o = 1; o < 8; o <<= 1)
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      ar[f] += __shfl_xor_sync(FULL, ar[f], o);
      ai[f] += __shfl_xor_sync(FULL, ai[f], o);
    }
#pragma unroll
  for (int f = 0; f < NF; ++f) pw[f] = __fadd_rn(__fmul_rn(ar[f], ar[f]), __fmul_rn(ai[f], ai[f]));
}

__device__ __forceinline__ void load_filters(const Params& p, const float* __restrict__ coefs, float* dst, int j) {
  const float* src = coefs + p.oct_off[j];
  for (int q = threadIdx.x; q < p.oct_len[j] / 4; q += THREADS)
    reinterpret_cast<float4*>(dst)[q] = __ldg(reinterpret_cast<const float4*>(src) + q);
}

__device__ __forceinline__ void zero(float* p, int len) {
  for (int i = threadIdx.x; i < len; i += THREADS) p[i] = 0.0f;
}

// buf[i] = row[s0 - G + i] for i < TILE_BUF, zeros outside [0, n): 16-byte
// cp.async copies (s0 - G and n are multiples of 4), then one commit.
__device__ __forceinline__ void load_tile(float* buf, const float* row, int n, int s0) {
  for (int c = threadIdx.x; c < TILE_BUF / 4; c += THREADS) {
    const int s = s0 - G + 4 * c;
    const bool in = s >= 0 && s < n;
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(buf + 4 * c));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(in ? row + s : row),
                 "r"(in ? 16 : 0));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ float block_max(float v, float* scratch) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  v = scratch[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) v = fmaxf(v, scratch[w]);
  __syncthreads();  // the scratch is free for the next reduction
  return v;
}

__global__ void __launch_bounds__(THREADS, 2)
    cqcc_kernel(const float* __restrict__ y, int n, const float* __restrict__ coefs,
                const float4* __restrict__ regrid, const float* __restrict__ dct, float* __restrict__ out,
                const __grid_constant__ Params p) {
  extern __shared__ __align__(16) float smem[];
  const Layout L(n);
  const int t = 1 + n / HOP;
  const int tid = threadIdx.x;
  const float* row = y + (size_t)blockIdx.x * n;
  float* filt = smem + L.coef;

  // ---- phase 0: the waveform in tiles -> level 1 (A) and octave 0 ----
  float* lev1 = smem + L.a + G;
  load_filters(p, coefs, filt, 0);
  zero(smem + L.a, G);
  zero(lev1 + n / 2, G);
  const int n_tiles = (t + 5) / 6;
  load_tile(smem + L.b, row, n, 0);  // tile k goes to B + (k & 1) TILE_BUF
  for (int k = 0; k < n_tiles; ++k) {
    if (k + 1 < n_tiles) {
      load_tile(smem + L.b + ((k + 1) & 1) * TILE_BUF, row, n, (k + 1) * TILE);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();  // tile k (and the filters) visible to every thread
    const float* tile = smem + L.b + (k & 1) * TILE_BUF;
    const int s0 = k * TILE;
    if (tid < TILE_TASKS) {  // 1,536 level-1 samples: task tid is t0 = s0 / 2 + 6 tid
      const int t0 = s0 / 2 + R * tid;
      if (t0 < n / 2) decimate(p, tile + 2 * t0 - 32 - s0 + G, lev1 + t0, min(R, n / 2 - t0));
    } else if (tid < TILE_TASKS + 8 * BINS) {  // octave 0: a bin over the tile's six frames, its chunks over 8 lanes
      const int bin = (tid - TILE_TASKS) >> 3, q = tid & 7;
      const float* x[6];
#pragma unroll
      for (int f = 0; f < 6; ++f) x[f] = tile + G + HOP * min(6 * k + f, t - 1) - s0 + p.a_lo[0][bin];
      float pw[6];
      cqt_bin_split<6>(x, filt + p.off[0][bin], filt + p.oct_len[0] / 2 + p.off[0][bin], p.nc[0][bin], q, pw);
      float* mrow = map_row(smem, L, n, t, bin);
#pragma unroll
      for (int f = 0; f < 6; ++f)
        if (q == f && 6 * k + f < t) mrow[6 * k + f] = pw[f];
    }
    __syncthreads();  // tile k read: its buffer takes tile k + 2
  }

  // ---- phases 1-6: octave j and level j + 1 from level j ----
  for (int j = 1; j < OCTAVES; ++j) {
    const int nj = n >> j, hop = HOP >> j;
    const float* src = smem + ((j & 1) ? L.a : L.b) + G;
    float* dst = smem + ((j & 1) ? L.b : L.a) + G;
    const int n_next = j + 1 < OCTAVES ? nj / 2 : 0;
    load_filters(p, coefs, filt, j);
    if (n_next) {
      zero(dst - G, G);
      zero(dst + n_next, G);
    }
    __syncthreads();
    const int tasks = CQT_TASKS + (n_next + R - 1) / R;
    for (int task = tid; task < tasks; task += THREADS) {
      if (task < CQT_TASKS) {
        const int bin = task / PHASES, f0 = task % PHASES;
        const float* x[F];
#pragma unroll
        for (int f = 0; f < F; ++f) x[f] = src + hop * min(f0 + PHASES * f, t - 1) + p.a_lo[j][bin];
        float pw[F];
        cqt_bin<F>(x, filt + p.off[j][bin], filt + p.oct_len[j] / 2 + p.off[j][bin], p.nc[j][bin], f0, pw);
        float* mrow = map_row(smem, L, n, t, BINS * j + bin);
#pragma unroll
        for (int f = 0; f < F; ++f)
          if (f0 + PHASES * f < t) mrow[f0 + PHASES * f] = pw[f];
      } else {
        const int t0 = R * (task - CQT_TASKS);
        decimate(p, src + 2 * t0 - 32, dst + t0, min(R, n_next - t0));
      }
    }
    __syncthreads();
  }

  // ---- the tail: dB per utterance, regrid, log, DCT ----
  float* scratch = smem + L.scratch;
  float* rg_s = smem + L.coef;  // the filters are spent: the regrid rows, then the DCT rows
  float* dct_s = rg_s + 4 * N_BINS;
  for (int i = tid; i < N_BINS; i += THREADS) reinterpret_cast<float4*>(rg_s)[i] = __ldg(regrid + i);
  for (int i = tid; i < N_CEPS * N_BINS / 4; i += THREADS)
    reinterpret_cast<float4*>(dct_s)[i] = __ldg(reinterpret_cast<const float4*>(dct) + i);
  float* mapA = smem + L.m0;                         // slots 0-23
  float* mapB = smem + L.a + 2 * G + n / 8;          // slots 24-83
  const int len_a = 2 * BINS * t, len_b = (N_BINS - 2 * BINS) * t;
  float mx = 0.0f;
  for (int e = tid; e < len_a; e += THREADS) mx = fmaxf(mx, mapA[e]);
  for (int e = tid; e < len_b; e += THREADS) mx = fmaxf(mx, mapB[e]);
  const float ref = __fmul_rn(10.0f, log10f(fmaxf(block_max(mx, scratch), 1e-10f)));
  float pk = __int_as_float(0xff800000);  // -inf
  for (int e = tid; e < len_a + len_b; e += THREADS) {
    float* q = e < len_a ? mapA + e : mapB + (e - len_a);
    const float db = __fsub_rn(__fmul_rn(10.0f, log10f(fmaxf(*q, 1e-10f))), ref);
    *q = db;
    pk = fmaxf(pk, db);
  }
  const float floor_db = __fsub_rn(block_max(pk, scratch), 80.0f);  // the barrier also orders the dB map
  float* lp = smem + L.b;  // log(interp^2 + 1e-12), (84, T)
  const int m = tid & (T_MAX - 1), kg = tid / T_MAX;  // lanes over frames: row i = kg + 4 r, or k = kg + 4 e
  if (m < t) {
    for (int i = kg; i < N_BINS; i += THREADS / T_MAX) {
      const float4 rg = ld4(rg_s + 4 * i);  // (idx, w0, w1, -)
      const int idx = static_cast<int>(rg.x);
      const float d0 = fmaxf(map_row(smem, L, n, t, slot_of_bin(idx))[m], floor_db);
      const float d1 = fmaxf(map_row(smem, L, n, t, slot_of_bin(idx + 1))[m], floor_db);
      const float v = __fadd_rn(__fmul_rn(rg.y, d0), __fmul_rn(rg.z, d1));
      lp[i * t + m] = logf(__fadd_rn(__fmul_rn(v, v), 1e-12f));
    }
  }
  __syncthreads();
  {  // out[k][m] = sum_i dct[k][i] lp[i][m], k = kg + 4 e, four i a step
    constexpr int KS = (N_CEPS + THREADS / T_MAX - 1) / (THREADS / T_MAX);
    if (m < t) {
      float acc[KS];
#pragma unroll
      for (int e = 0; e < KS; ++e) acc[e] = 0.0f;
      for (int i = 0; i < N_BINS; i += 4) {
        const float v0 = lp[i * t + m], v1 = lp[(i + 1) * t + m], v2 = lp[(i + 2) * t + m], v3 = lp[(i + 3) * t + m];
#pragma unroll
        for (int e = 0; e < KS; ++e) {
          const float4 d = ld4(dct_s + min(kg + THREADS / T_MAX * e, N_CEPS - 1) * N_BINS + i);
          acc[e] = fmaf(d.x, v0, acc[e]);
          acc[e] = fmaf(d.y, v1, acc[e]);
          acc[e] = fmaf(d.z, v2, acc[e]);
          acc[e] = fmaf(d.w, v3, acc[e]);
        }
      }
      float* o = out + (size_t)blockIdx.x * N_CEPS * t + m;
#pragma unroll
      for (int e = 0; e < KS; ++e)
        if (kg + THREADS / T_MAX * e < N_CEPS) o[(kg + THREADS / T_MAX * e) * t] = acc[e];
    }
  }
}

}  // namespace

// y: (n_rows, n) fp32 waveforms, contiguous, 16-byte aligned, n a multiple of
// 64 in [512, 32704]; coefs: the packed filters of the 7 octaves (16-byte
// aligned); regrid: (84, 4) (idx, w0, w1, 0); dct: (19, 84); out: (n_rows,
// 19, 1 + n / 512). fir (63 taps), meta (a_lo, nc, off: 3 x 7 x 12) and oct
// (offsets, lengths: 2 x 7) are host arrays. Returns a cudaError_t.
extern "C" int cqcc_launch(const void* y, int n_rows, int n, const void* coefs, const void* regrid,
                           const void* dct, const float* fir, const int* meta, const int* oct, void* out,
                           void* stream) {
  if (n_rows < 0 || n % 64 || n < MIN_N || n > MAX_N) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(coefs) | reinterpret_cast<uintptr_t>(regrid) |
       reinterpret_cast<uintptr_t>(dct)) % 16)
    return (int)cudaErrorMisalignedAddress;
  Params p = {};
  for (int i = 0; i < TAPS; ++i) p.fir[i] = fir[i];
  for (int j = 0; j < OCTAVES; ++j) {
    for (int b = 0; b < BINS; ++b) {
      p.a_lo[j][b] = meta[j * BINS + b];
      p.nc[j][b] = meta[OCTAVES * BINS + j * BINS + b];
      p.off[j][b] = meta[2 * OCTAVES * BINS + j * BINS + b];
    }
    p.oct_off[j] = oct[j];
    p.oct_len[j] = oct[OCTAVES + j];
    if (p.oct_len[j] > COEF_CAP || p.oct_len[j] % 8 || p.oct_off[j] % 4) return (int)cudaErrorInvalidValue;
  }
  if (n_rows == 0) return (int)cudaSuccess;
  const size_t smem = sizeof(float) * Layout(n).total;
  cudaError_t err = cudaFuncSetAttribute(cqcc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(cqcc_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  cqcc_kernel<<<n_rows, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), n, static_cast<const float*>(coefs), static_cast<const float4*>(regrid),
      static_cast<const float*>(dct), static_cast<float*>(out), p);
  return (int)cudaGetLastError();
}
