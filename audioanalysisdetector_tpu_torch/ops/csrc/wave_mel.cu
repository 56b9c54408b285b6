// Mel power straight from raw waveforms or from gathered frames, on Hopper's
// tensor cores (sm_90a).
//
// Replaces two of the JAX package's Pallas TPU kernels with one core:
// ops/wave_mel.py (function wave_mel, body lines 91-142; entry
// wave_mel_launch, K1) and ops/fused_logmel.py (function
// fused_mel_from_frames, body _kernel lines 68-81; entry frames_mel_launch,
// K2). Center-padded waveforms (B, n_pad), or frames (N, row_stride) read as
// n_frames = 1 rows, -> mel power (n_rows, n_mels), computing
//
//   out[r, m] = sum_k ((sum_n x_r[n] cos[n, k])^2 + (sum_n x_r[n] sin[n, k])^2) * mel[k, m]
//
// for every frame row r = u * n_frames + f, whose samples x_r are read
// straight from the waveform at u * n_pad + f * hop. No frame matrix ever
// exists in device memory.
//
// Bounds. The DFT products are 2 * 2 * n_fft * bins operations per frame
// row, 4.3 TFLOP over the live bins at n_fft 2048 for 8192 two-second
// utterances: past what the non-tensor fp32 pipes do (67 TFLOP/s peak; a
// direct fp32-FMA DFT reaches 28 on an H100), so they run on the tensor cores
// (wgmma, bf16 operands, fp32 accumulators). Precision sets their cost. The
// mel step is held to 1e-4 of each utterance's max power and its log to
// 1e-3 dB of the fp32 chain, down to -80 dB, where a near-empty bin takes
// the DFT's absolute error whole. So a float32 operand is split into three
// bf16 parts that sum to it exactly (bases on the host, frame samples in
// registers), and each product is the six part products of order 2^-16 and
// up (the rest are under 2^-24): six times the bf16 work, 26 TFLOP at n_fft
// 2048. And because the tensor cores round a product's sum toward zero, an
// error that grows with the chain, each 32-sample stage's products are
// summed there from zero and the stages in IEEE fp32. bf16 frames (K2's
// compute_dtype) take one product, exactly K2's semantics. What the
// tensor-core rate leaves is per-stage overhead (the block barrier, the
// fragment loads and splits) and L2: every block re-reads the 25 MB of
// three-part bases at n_fft 2048 (resident in the 50 MB L2) and its frames
// once per tile.
//
// Design. The host builds the operands once per (config, device, dtype)
// (ops/wave_mel.py::_kernel_operands): only the live bins [k_lo, k_hi)
// whose mel column is not all zero, in tiles of NB = 64 bins; per tile and
// chunk of KC = 32 samples one contiguous block holding the windowed cos
// and sin bases side by side (a 128-column B operand, so one wgmma yields re
// and im) in the wgmma K-major core-matrix layout, part after part; per tile
// the fp32 mel weights over the tile's bins and each filter's nonzero span
// within it. A block owns ROWS = 128 frame rows, one warpgroup per 64, and
// walks (tile, chunk) pairs through a ring of 4 shared-memory stages (3 for
// float frames with over 64 mels, where 4 do not fit) filled by cp.async (16-byte copies where the rows are aligned,
// 4-byte copies otherwise; the sample tail and the ragged row tile are
// zero-filled), the next stage's copies issued while the current stage's
// products run. Each thread loads its frame samples from the stage in the
// wgmma A-fragment layout, splits them in registers, and issues the
// products with A from registers. At a tile's last chunk |X|^2 = re^2 +
// im^2 is formed from the accumulators and contracted in fp32 over each
// filter's nonzero bins only (a Slaney bin feeds at most two filters: ~2
// FMAs per bin and row, against the DFT's 4 * n_fft) into a per-row mel
// accumulator that stays in registers until the single store.
//
// Any mel configuration. |X|^2 is raised to power / 2 per bin before the
// mel step (a kernel argument: unchanged at 2, sqrtf at 1, powf otherwise,
// as the JAX chain's stft.py). More than 128 filters are cut into groups of
// MC columns, one grid row (blockIdx.y) each: a group reads its own mel
// blocks and writes columns [MC g, MC g + MC) of each output row, and
// recomputes the DFT of its rows (simple; the cost is the group count).
// bf16 waveforms take the hi-only bases and one product, as bf16 frames do;
// bf16 rows off 16-byte alignment are staged by plain 2-byte loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int ROWS = 128;      // frame rows per block: two warpgroups of 64
constexpr int THREADS = 256;
constexpr int NB = 64;         // bins per tile (N_TILE in ops/wave_mel.py)
constexpr int BN = 2 * NB;     // B operand columns: cos of the tile's bins, then sin
constexpr int KC = 32;         // samples per stage (K_CHUNK in ops/wave_mel.py)
constexpr size_t SMEM_MAX = 232448;  // dynamic shared memory a block may have
constexpr int AS = KC + 8;     // staged frame row stride (elements): conflict-free fragment loads
constexpr int PS = NB + 1;     // power tile row stride (floats): conflict-free column reads

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  // copies `bytes` (0..16) and zero-fills the rest of the 16
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// cp.async writes are generic-proxy writes; wgmma reads shared memory
// through the async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// Shared-memory matrix descriptor of a K-major operand without swizzle:
// 8 x 8 core matrices of 128 contiguous bytes, the two of one k16 step 128
// bytes apart (leading byte offset), 8-row groups `sbo` bytes apart.
__device__ __forceinline__ uint64_t kmajor_desc(const void* p, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// D(64 x 128, f32) = A(64 x 16, bf16, registers) . B(16 x 128, bf16, K-major smem)
// + (keep ? D : 0)
__device__ __forceinline__ void wgmma_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                           int keep = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(keep));
}

// |X|^2 -> |X|^power (power is uniform across the grid: no divergence)
__device__ __forceinline__ float to_power(float mag2, float power) {
  if (power == 2.f) return mag2;
  return power == 1.f ? sqrtf(mag2) : powf(mag2, 0.5f * power);
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) { return *reinterpret_cast<uint32_t*>(&v); }

// (x0, x1) -> three packed bf16 pairs with x = p[0] + p[1] + p[2] exactly
// (8 significand bits each: all 24 of a float); x0 in the low halves
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& p0, uint32_t& p1, uint32_t& p2) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = x0 - hf.x, r1 = x1 - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  p0 = bits(h);
  p1 = bits(m);
  p2 = bits(__floats2bfloat162_rn(r0 - mf.x, r1 - mf.y));
}

template <typename T>
constexpr int PARTS = std::is_same<T, float>::value ? 3 : 1;  // bf16 parts of an operand

// A fragment of one k16 step for this thread (m64k16 layout: rows g and
// g + 8 of the warp's 16, columns k0 + 2t, +1 and k0 + 2t + 8, +9) from the
// staged rows `a` (row g first): fp32 samples split in three, or bf16 as
// they are.
__device__ __forceinline__ void a_fragment(const float* a, int k0, uint32_t (&p)[3][4]) {
  const float2 v0 = *reinterpret_cast<const float2*>(a + k0);
  const float2 v1 = *reinterpret_cast<const float2*>(a + 8 * AS + k0);
  const float2 v2 = *reinterpret_cast<const float2*>(a + k0 + 8);
  const float2 v3 = *reinterpret_cast<const float2*>(a + 8 * AS + k0 + 8);
  split3(v0.x, v0.y, p[0][0], p[1][0], p[2][0]);
  split3(v1.x, v1.y, p[0][1], p[1][1], p[2][1]);
  split3(v2.x, v2.y, p[0][2], p[1][2], p[2][2]);
  split3(v3.x, v3.y, p[0][3], p[1][3], p[2][3]);
}

__device__ __forceinline__ void a_fragment(const __nv_bfloat16* a, int k0, uint32_t (&p)[1][4]) {
  p[0][0] = *reinterpret_cast<const uint32_t*>(a + k0);
  p[0][1] = *reinterpret_cast<const uint32_t*>(a + 8 * AS + k0);
  p[0][2] = *reinterpret_cast<const uint32_t*>(a + k0 + 8);
  p[0][3] = *reinterpret_cast<const uint32_t*>(a + 8 * AS + k0 + 8);
}

template <typename T>
__host__ __device__ constexpr int stage_b_elems() {  // bf16 basis elements of one stage, all parts
  return PARTS<T> * KC * BN;
}

template <int MC>
__host__ __device__ constexpr int mel_block_floats() {  // one tile's mel block: weights [NB][MC], then MC spans
  return NB * MC + MC;
}

template <typename T, int MC>
__host__ __device__ constexpr size_t smem_bytes(int stages) {
  return sizeof(__nv_bfloat16) * stages * stage_b_elems<T>() +
         sizeof(float) * (mel_block_floats<MC>() + ROWS * PS) + sizeof(T) * stages * ROWS * AS +
         sizeof(long long) * ROWS;
}

// Ring depth: 4 stages where they fit (3 for float frames with 128 mels)
template <typename T, int MC>
constexpr int ring_depth = smem_bytes<T, MC>(4) <= SMEM_MAX ? 4 : 3;

// T: element type of the frames (float: 3-part split, 6 products; bf16: 1).
// MC: mel columns of the accumulator (64 or 128); grid row g computes
// filters [MC g, MC g + MC) of n_mels.
template <typename T, int MC>
__global__ void __launch_bounds__(THREADS, 1)
mel_core(const T* __restrict__ x, const __nv_bfloat16* __restrict__ bases,
         const float* __restrict__ mel, float* __restrict__ out, int n_rows, int n_frames,
         long long n_pad, int hop, int n_fft, int n_tiles, int n_mels, float power, int vec) {
  constexpr int P = PARTS<T>;
  constexpr int STAGES = ring_depth<T, MC>;
  constexpr int B_STAGE = stage_b_elems<T>();
  constexpr int M_BLOCK = mel_block_floats<MC>();
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* b_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [STAGES][P][BN x KC]
  float* m_s = reinterpret_cast<float*>(b_s + STAGES * B_STAGE);  // the tile's mel block
  float* p_s = m_s + M_BLOCK;                                     // [ROWS][PS] |X|^2 of the tile
  T* a_s = reinterpret_cast<T*>(p_s + ROWS * PS);                 // [STAGES][ROWS][AS]
  long long* row_off = reinterpret_cast<long long*>(a_s + STAGES * ROWS * AS);  // [ROWS]

  const int tid = threadIdx.x;
  const int n_chunks = (n_fft + KC - 1) / KC;
  const int total = n_tiles * n_chunks;
  const long long row0 = (long long)blockIdx.x * ROWS;
  const int col0 = blockIdx.y * MC;  // this group's first filter
  mel += (size_t)blockIdx.y * n_tiles * M_BLOCK;  // its (tile) mel blocks
  if (tid < ROWS) {
    const long long r = row0 + tid;
    row_off[tid] = r < n_rows ? (r / n_frames) * n_pad + (r % n_frames) * (long long)hop : -1;
  }
  __syncthreads();

  // Copy geometry, fixed per thread: 16-byte chunk tid + q * THREADS of a
  // stage's basis block, and of its frame samples row a_row + q * A_STEP,
  // samples a_col .. a_col + EPC of the chunk.
  constexpr int EPC = 16 / sizeof(T), CPR = KC / EPC;
  constexpr int A_STEP = THREADS / CPR, A_CP = ROWS / A_STEP, B_CP = B_STAGE * 2 / 16 / THREADS;
  static_assert(THREADS % CPR == 0 && ROWS % A_STEP == 0 && B_STAGE * 2 % (16 * THREADS) == 0);
  const int a_row = tid / CPR, a_col = (tid % CPR) * EPC;
  long long a_off[A_CP];
#pragma unroll
  for (int q = 0; q < A_CP; ++q) a_off[q] = row_off[a_row + q * A_STEP];

  // Stage (tile, chunk) pair i, whose chunk starts at sample n0, into ring
  // slot i % STAGES: its basis block (contiguous in `bases`) and the KC
  // samples of each of the ROWS rows.
  auto issue = [&](int i, int n0) {
    const int slot = i % STAGES;
    const char* bsrc = reinterpret_cast<const char*>(bases + (size_t)i * B_STAGE) + 16 * tid;
    char* bdst = reinterpret_cast<char*>(b_s + slot * B_STAGE) + 16 * tid;
#pragma unroll
    for (int q = 0; q < B_CP; ++q) cp_async16(bdst + 16 * THREADS * q, bsrc + 16 * THREADS * q, 16);
    T* adst = a_s + slot * ROWS * AS;
    if (vec) {
      const int bytes = max(0, min(EPC, n_fft - n0 - a_col)) * (int)sizeof(T);
#pragma unroll
      for (int q = 0; q < A_CP; ++q) {
        const int b = a_off[q] < 0 ? 0 : bytes;
        cp_async16(adst + (a_row + q * A_STEP) * AS + a_col, b ? x + a_off[q] + n0 + a_col : x, b);
      }
    } else if constexpr (sizeof(T) == 4) {  // rows not 16-byte aligned (launcher: f32 only)
      for (int e = tid; e < ROWS * KC; e += THREADS) {
        const int row = e / KC, n = n0 + e % KC;
        const long long off = row_off[row];
        const bool ok = off >= 0 && n < n_fft;
        cp_async4(adst + row * AS + (n - n0), ok ? x + off + n : x, ok ? 4 : 0);
      }
    } else {  // bf16 rows not 16-byte aligned: plain 2-byte loads, stored
      // straight into the slot (its last reader passed the barrier of pair i)
      const unsigned short* xs = reinterpret_cast<const unsigned short*>(x);
      unsigned short* ds = reinterpret_cast<unsigned short*>(adst);
      for (int e = tid; e < ROWS * KC; e += THREADS) {
        const int row = e / KC, n = n0 + e % KC;
        const long long off = row_off[row];
        ds[row * AS + (n - n0)] = off >= 0 && n < n_fft ? xs[off + n] : (unsigned short)0;
      }
    }
  };

  const int warp = (tid / 32) % 4, lane = tid % 32, g = lane / 4, tq = lane % 4;
  const int arow = (tid / 128) * 64 + warp * 16 + g;  // this thread's rows: arow, arow + 8
  const int prow = (tid / 128) * 64 + tid % 64;       // its mel row and mel half
  const int m0 = ((tid / 64) % 2) * (MC / 2);
  float acc[64];       // re (columns 0..63) and im (64..127) of the tile's bins
  float part[64];      // the same, this stage's products only
  float macc[MC / 2];  // mel power of row prow, mels m0 ..
#pragma unroll
  for (int j = 0; j < 64; ++j) acc[j] = 0.f;
#pragma unroll
  for (int j = 0; j < MC / 2; ++j) macc[j] = 0.f;

  int pc = 0;  // chunk of the next pair to stage
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < total) issue(i, pc * KC);
    pc = pc + 1 == n_chunks ? 0 : pc + 1;
    cp_async_commit();
  }

  for (int i = 0, t = 0, c = 0; i < total; ++i) {  // pair i is chunk c of tile t
    const int slot = i % STAGES;
    cp_async_wait<STAGES - 2>();  // this thread's copies of pair i have landed
    fence_proxy_async();
    __syncthreads();  // everyone's have; slot (i - 1) % STAGES is free again

    const T* a = a_s + slot * ROWS * AS + arow * AS;
    const __nv_bfloat16* b = b_s + slot * B_STAGE;
    uint32_t ap[KC / 16][P][4];
#pragma unroll
    for (int s = 0; s < KC / 16; ++s) a_fragment(a, 16 * s + 2 * tq, ap[s]);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < KC / 16; ++s) {
      // k16 step s: core matrices 2s, 2s + 1 of each 8-row group (256 bytes
      // in); part q of the basis KC * BN elements on
      uint64_t bq[P];
#pragma unroll
      for (int q = 0; q < P; ++q) bq[q] = kmajor_desc(b + q * KC * BN + 128 * s, KC / 8 * 128);
      if constexpr (P == 3) {  // every product of order 2^-16 and up, smallest first
        wgmma_n128(part, ap[s][1], bq[1], s > 0);  // the stage's first product starts from 0
        wgmma_n128(part, ap[s][0], bq[2]);
        wgmma_n128(part, ap[s][2], bq[0]);
        wgmma_n128(part, ap[s][0], bq[1]);
        wgmma_n128(part, ap[s][1], bq[0]);
        wgmma_n128(part, ap[s][0], bq[0]);
      } else {
        wgmma_n128(part, ap[s][0], bq[0], s > 0);
      }
    }
    wgmma_commit();

    // while the products run: stage pair i + STAGES - 1 into the slot pair
    // i - 1 used, and at a tile's first chunk its mel block (it has landed
    // by the tile's last chunk when n_chunks >= STAGES, else see below)
    if (i + STAGES - 1 < total) issue(i + STAGES - 1, pc * KC);
    pc = pc + 1 == n_chunks ? 0 : pc + 1;
    if (c == 0) {
      const char* msrc = reinterpret_cast<const char*>(mel + (size_t)t * M_BLOCK);
      for (int e = tid; e < M_BLOCK * 4 / 16; e += THREADS)
        cp_async16(reinterpret_cast<char*>(m_s) + 16 * e, msrc + 16 * e, 16);
    }
    cp_async_commit();
    wgmma_wait0();
    // The tensor cores round a product's sum toward zero, an error that
    // grows with the chain: each stage's products are summed there, the
    // stages here, in IEEE fp32.
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[j] += part[j];

    if (c == n_chunks - 1) {
      // |X|^2 of bins 8j + 2tq (+1) sits in acc[4j..4j+3] (rows arow,
      // arow + 8), im 32 registers on; the power tile goes through shared
      // memory to the mel layout: one row per thread, a warp on one filter
      const int prow_acc = arow - (tid / 128) * 64;
      float* pw = p_s + (tid / 128) * 64 * PS;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pw[(prow_acc + 8 * (e / 2)) * PS + 8 * j + 2 * tq + e % 2] = to_power(
              acc[4 * j + e] * acc[4 * j + e] + acc[4 * j + 32 + e] * acc[4 * j + 32 + e], power);
#pragma unroll
      for (int j = 0; j < 64; ++j) acc[j] = 0.f;  // the next tile's sums
      if (n_chunks < STAGES) cp_async_wait<0>();  // short n_fft: the mel block may be in flight
      __syncthreads();
      // fp32 contraction over each filter's nonzero bins in this tile only:
      // a Slaney bin feeds at most two filters
      const float* pr = p_s + prow * PS;
      const uint32_t* spans = reinterpret_cast<const uint32_t*>(m_s + NB * MC);
#pragma unroll
      for (int j = 0; j < MC / 2; ++j) {
        const uint32_t span = spans[m0 + j];  // [lo, hi) packed lo | hi << 16
#pragma unroll 1
        for (int k = span & 0xFFFF; k < (int)(span >> 16); ++k)
          macc[j] = fmaf(pr[k], m_s[k * MC + m0 + j], macc[j]);
      }
    }
    if (++c == n_chunks) c = 0, ++t;
  }
  cp_async_wait<0>();

  const long long r = row0 + prow;
  if (r < n_rows) {
#pragma unroll
    for (int j = 0; j < MC / 2; ++j)
      if (col0 + m0 + j < n_mels) out[r * n_mels + col0 + m0 + j] = macc[j];
  }
}

template <typename T, int MC>
cudaError_t launch(const T* x, const void* bases, const float* mel, float* out, int n_rows,
                   int n_frames, long long n_pad, int hop, int n_fft, int n_tiles, int n_mels,
                   float power, int vec, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, MC>(ring_depth<T, MC>);
  static_assert(smem <= SMEM_MAX);
  cudaError_t err = cudaFuncSetAttribute(mel_core<T, MC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((n_rows + ROWS - 1) / ROWS), (unsigned)((n_mels + MC - 1) / MC));
  mel_core<T, MC><<<grid, THREADS, smem, stream>>>(
      x, static_cast<const __nv_bfloat16*>(bases), mel, out,
      n_rows, n_frames, n_pad, hop, n_fft, n_tiles, n_mels, power, vec);
  return cudaGetLastError();
}

template <typename T>
int launch_any(const void* x, const void* bases, const void* mel, void* out, int n_rows,
               int n_frames, long long n_pad, int hop, int n_fft, int n_tiles, int n_mels,
               float power, void* stream) {
  if (n_rows < 0 || n_frames < 1 || n_pad < 1 || hop < 1 || n_fft < 1 || n_tiles < 1 ||
      n_mels < 1)
    return (int)cudaErrorInvalidValue;
  // 16-byte copies need 16-byte-aligned row starts (chunk starts then are too)
  const int vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && (n_pad * sizeof(T)) % 16 == 0 &&
                  (hop * sizeof(T)) % 16 == 0;
  if (n_rows == 0) return (int)cudaSuccess;
  const T* xt = static_cast<const T*>(x);
  const float* m = static_cast<const float*>(mel);
  float* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_mels <= 64)
    return (int)launch<T, 64>(xt, bases, m, o, n_rows, n_frames, n_pad, hop, n_fft, n_tiles,
                              n_mels, power, vec, s);
  return (int)launch<T, 128>(xt, bases, m, o, n_rows, n_frames, n_pad, hop, n_fft, n_tiles,
                             n_mels, power, vec, s);
}

}  // namespace

// Plain C entry point (bound with ctypes). Device pointers: wav (B, n_pad)
// float32 with the bases of ops/wave_mel.py::_kernel_operands at split =
// true when bf16 == 0, bfloat16 with the hi-only bases (split = false)
// otherwise (n_tiles tiles of 64 live bins); mel the fp32 mel blocks, one
// per (group, tile), columns padded to 64 when n_mels <= 64, else 128 per
// group; out (n_rows, n_mels) float32 with n_rows = B * n_frames; power the
// exponent of |X| (2: power, 1: magnitude). Launches on `stream` and returns
// the launch's cudaError_t (0 on success).
extern "C" int wave_mel_launch(const void* wav, const void* bases, const void* mel, void* out,
                               int n_rows, int n_frames, long long n_pad, int hop, int n_fft,
                               int n_tiles, int n_mels, float power, int bf16, void* stream) {
  if (bf16)
    return launch_any<__nv_bfloat16>(wav, bases, mel, out, n_rows, n_frames, n_pad, hop, n_fft,
                                     n_tiles, n_mels, power, stream);
  return launch_any<float>(wav, bases, mel, out, n_rows, n_frames, n_pad, hop, n_fft, n_tiles,
                           n_mels, power, stream);
}

// Second entry point (K2): frames (n_rows, row_stride >= n_fft) in place of
// the waveform, each row one frame. frames are float32 with split bases when
// bf16 == 0, and bfloat16 with hi-only bases otherwise; mel and out as
// above, power 2.
extern "C" int frames_mel_launch(const void* frames, const void* bases, const void* mel, void* out,
                                 int n_rows, int row_stride, int n_fft, int n_tiles, int n_mels,
                                 int bf16, void* stream) {
  if (bf16)
    return launch_any<__nv_bfloat16>(frames, bases, mel, out, n_rows, 1, row_stride, row_stride,
                                     n_fft, n_tiles, n_mels, 2.f, stream);
  return launch_any<float>(frames, bases, mel, out, n_rows, 1, row_stride, row_stride, n_fft,
                           n_tiles, n_mels, 2.f, stream);
}
