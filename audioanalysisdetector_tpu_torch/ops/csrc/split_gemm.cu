// Float32 matrix products y = x W^T on Hopper's tensor cores at float32
// accuracy (sm_90a): K7.
//
// Replaces no TPU kernel: the JAX package leaves its linear layers to XLA.
// It replaces cuBLAS's float32 SGEMM (sm80_xmma_gemm_f32f32_f32f32_f32,
// SIMT FFMA) under nn.Linear in the Voxtral decoder's seven projections
// (models/voxtral.py::DecoderLayer), float32 x (M, K) and float32 W (N, K)
// into float32 y (M, N).
//
// Bounds. The SIMT pipes peak at 67 TFLOP/s of fp32 FMA, and cuBLAS reaches
// ~50 there. The tensor cores take bf16 operands at 989 TFLOP/s, so a
// float32 operand is split into three bf16 parts that sum to it exactly
// (hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid): 8 significand
// bits each, all 24 of a float; K1's split3 in wave_mel.cu), and each
// product x w is the six part products of order 2^-16 and up: hi hi, hi mid,
// mid hi, hi lo, mid mid and lo hi (the three left out are under 2^-24 of
// |x w|). Six bf16 products at 989 TFLOP/s bound the kernel at ~165 TFLOP/s
// of float32 work: 6 * 2 M N K / 989e12 s. The bytes (the planes read once,
// y written once) are far below that at the decoder's shapes.
//
// Accuracy. The tensor cores round a product's sum toward zero, an error
// that grows with the chain. So each chunk of BK = 32 along K (two k16 steps
// of six products: the five smaller ones of both steps first, then hi hi of
// each, so that few roundings fall at the chunk's full size) is summed there
// from zero, and the chunks are added in IEEE fp32 in registers, in order,
// as K1 does. The error against a float64 product is then at most that of
// an fp32 SGEMM (measured on the card: tests/test_torch_split_gemm_card.py).
//
// Design. The operands are laid out before the product so that every
// stage is one contiguous block a bulk copy moves: split_planes_launch
// writes a float32 matrix (rows, K) as bf16 planes (ceil(rows / R), K / BK,
// 3, R * BK), each R x BK block in the wgmma K-major core-matrix layout
// (8 x 8 core matrices, K-fastest within an 8-row group, the groups one
// after another; rows past the matrix zero), R = BM for x and BN for W. The
// weights' planes are made once and cached by the caller; the activations'
// are made by that kernel before each product (~2-5% of the product's time
// at the decoder's shapes). A block owns a BM x BN = 128 x 192 tile of y: a
// producer thread keeps a ring of STAGES = 3 stages (24 KB of x planes and
// 36 KB of W planes each) filled with cp.async.bulk, completed on an
// mbarrier, while two consumer warpgroups, 64 rows each, run the products
// from shared memory (wgmma m64n96k16, both operands by descriptor). A
// consumer covers its 192 columns in two halves of 96: per stage and half,
// 12 wgmmas into one 48-register chunk sum, a wait, and the chunk added to
// that half's 48-register running sum. While one warpgroup waits and adds,
// the other's products keep the tensor cores busy. Registers set the tile:
// nine warps put three on one of the SM's four register files, which caps a
// thread at 168 registers whatever setmaxnreg asks (measured: ptxas spilled
// a 128 x 256 tile's 192 registers of sums there); 144 fit. Ragged M and N
// are masked at the store; K must be a multiple of BK.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;     // rows of y a block: two consumer warpgroups of 64 (BLOCK_M in ops/split_gemm.py)
constexpr int BN = 192;     // columns of y a block (BLOCK_N)
constexpr int HN = 96;      // columns of one wgmma: half a block
constexpr int BK = 32;      // K a stage, and the chunk summed on the tensor cores (CHUNK)
constexpr int PARTS = 3;    // bf16 parts of a float32 operand
constexpr int STAGES = 3;
constexpr int THREADS = 288;  // warpgroups 0 and 1 consume; warp 8's first thread produces
constexpr int A_PART = BM * BK;  // bf16 elements of one part of a stage's x block
constexpr int B_PART = BN * BK;
constexpr unsigned A_BYTES = PARTS * A_PART * 2;  // 24,576
constexpr unsigned B_BYTES = PARTS * B_PART * 2;  // 36,864
constexpr size_t SMEM = STAGES * (size_t)(A_BYTES + B_BYTES) + 2 * STAGES * sizeof(uint64_t);
static_assert(SMEM <= 232448, "a block may have 227 KB of shared memory");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// spin until the phase of parity `parity` of the barrier has completed; a
// phase that never completes (a fault in the pipeline) traps, and the
// launch fails, in place of a hung card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 30)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// `bytes` contiguous bytes from global to shared memory, counted on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// Shared-memory matrix descriptor of a K-major operand without swizzle:
// 8 x 8 core matrices of 128 contiguous bytes, the two of one k16 step 128
// bytes apart (leading byte offset), 8-row groups BK / 8 * 128 = 512 bytes
// apart (stride byte offset).
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)((BK / 8 * 128) >> 4) << 32);
}

// D(64 x 96, f32) = A(64 x 16, bf16, K-major smem) . B(16 x 96, bf16, K-major smem) + (keep ? D : 0)
__device__ __forceinline__ void wgmma_ss(float (&d)[48], uint64_t a, uint64_t b, int keep) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "%48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(a), "l"(b), "r"(keep));
}

__global__ void __launch_bounds__(THREADS, 1)
split_gemm(const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ b, float* __restrict__ y,
           int m, int n, int k_chunks) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [STAGES][PARTS][A_PART]
  __nv_bfloat16* b_s = a_s + STAGES * PARTS * A_PART;           // [STAGES][PARTS][B_PART]
  uint64_t* full = reinterpret_cast<uint64_t*>(b_s + STAGES * PARTS * B_PART);  // [STAGES]: landed
  uint64_t* empty = full + STAGES;                                              // [STAGES]: read
  const int tid = threadIdx.x, wg = tid / 128;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);   // the producer's expect_tx
      mbar_init(&empty[s], 2);  // one arrival a consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // the producer: one thread streams this tile's stages
    if (tid == 256) {
      const __nv_bfloat16* a_src = a + (size_t)blockIdx.x * k_chunks * PARTS * A_PART;
      const __nv_bfloat16* b_src = b + (size_t)blockIdx.y * k_chunks * PARTS * B_PART;
      for (int i = 0; i < k_chunks; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(&empty[s], (i / STAGES - 1) & 1);  // its last reader is done
        mbar_expect_tx(&full[s], A_BYTES + B_BYTES);
        bulk_load(a_s + s * PARTS * A_PART, a_src + (size_t)i * PARTS * A_PART, A_BYTES, &full[s]);
        bulk_load(b_s + s * PARTS * B_PART, b_src + (size_t)i * PARTS * B_PART, B_BYTES, &full[s]);
      }
    }
  } else {  // a consumer: rows 64 wg .. of the tile, all BN columns
    float sum[2][48];  // the running sums of the two halves
    float part[48];    // one chunk's products, summed on the tensor cores
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 48; ++j) sum[h][j] = 0.f;

    for (int i = 0; i < k_chunks; ++i) {
      const int s = i % STAGES;
      mbar_wait(&full[s], (i / STAGES) & 1);
      const uint64_t a_desc = kmajor_desc(smem_u32(a_s + s * PARTS * A_PART + wg * 64 * BK));
      const uint64_t b_desc = kmajor_desc(smem_u32(b_s + s * PARTS * B_PART));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // part p of k16 step st: core matrices 2 st, 2 st + 1 (256 bytes on)
        // of part p's block, a constant offset (in 16-byte units) from the
        // stage's descriptor, which keeps the descriptors out of registers
        auto da = [&](int p, int st) { return a_desc + (uint64_t)((p * A_PART * 2 + st * 256) >> 4); };
        auto db = [&](int p, int st) {
          return b_desc + (uint64_t)((p * B_PART * 2 + h * HN * BK * 2 + st * 256) >> 4);
        };
        wgmma_fence();
        // every product of order 2^-16 and up: the five smaller ones of both
        // k16 steps first, then hi hi of each, so that few of the roundings
        // toward zero fall at the chunk's full size; the first starts from 0
#pragma unroll
        for (int st = 0; st < BK / 16; ++st) {
          wgmma_ss(part, da(1, st), db(1, st), st > 0);
          wgmma_ss(part, da(0, st), db(2, st), 1);
          wgmma_ss(part, da(2, st), db(0, st), 1);
          wgmma_ss(part, da(0, st), db(1, st), 1);
          wgmma_ss(part, da(1, st), db(0, st), 1);
        }
#pragma unroll
        for (int st = 0; st < BK / 16; ++st) wgmma_ss(part, da(0, st), db(0, st), 1);
        wgmma_commit();
        wgmma_wait0();
        if (h == 1 && tid % 128 == 0) mbar_arrive(&empty[s]);  // both halves have read the stage
        // the chunk joins the running sum in IEEE fp32
#pragma unroll
        for (int j = 0; j < 48; ++j) sum[h][j] += part[j];
      }
    }

    // sum[h][4 j + e] is row 16 warp + g + 8 (e / 2), column 96 h + 8 j + 2 tq + e % 2 of the warpgroup's tile
    const int warp = (tid / 32) % 4, lane = tid % 32, g = lane / 4, tq = lane % 4;
    const long long row = (long long)blockIdx.x * BM + wg * 64 + warp * 16 + g;
    const int col0 = blockIdx.y * BN + 2 * tq;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 12; ++j) {
        const int col = col0 + h * HN + 8 * j;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const long long row_r = row + 8 * r;
          if (row_r >= m || col >= n) continue;
          float* dst = y + row_r * n + col;
          if ((n & 1) == 0) {
            *reinterpret_cast<float2*>(dst) = make_float2(sum[h][4 * j + 2 * r], sum[h][4 * j + 2 * r + 1]);
          } else {
            dst[0] = sum[h][4 * j + 2 * r];
            if (col + 1 < n) dst[1] = sum[h][4 * j + 2 * r + 1];
          }
        }
      }
  }
}

// Item i of the split: 8 consecutive K values (one core-matrix row) of one
// row of one R x BK block; blocks (tile, chunk) in order, row-major within.
template <int R>
__global__ void __launch_bounds__(256)
split_planes(const float* __restrict__ x, __nv_bfloat16* __restrict__ out, int rows, int k, long long items) {
  const int k_chunks = k / BK;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < items;
       i += (long long)gridDim.x * blockDim.x) {
    const long long blk = i / (R * 4);
    const int r = (int)(i % (R * 4)) / 4, q = (int)(i % 4);
    const long long tile = blk / k_chunks;
    const int c = (int)(blk % k_chunks);
    const long long row = tile * R + r;
    float v[8];
    if (row < rows) {
      const float4* src = reinterpret_cast<const float4*>(x + row * k + c * BK + q * 8);
      const float4 v0 = src[0], v1 = src[1];
      v[0] = v0.x, v[1] = v0.y, v[2] = v0.z, v[3] = v0.w, v[4] = v1.x, v[5] = v1.y, v[6] = v1.z, v[7] = v1.w;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = 0.f;
    }
    // hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), each difference exact in fp32
    __align__(16) __nv_bfloat16 parts[PARTS][8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const __nv_bfloat16 hi = __float2bfloat16_rn(v[e]);
      const float r1 = v[e] - __bfloat162float(hi);
      const __nv_bfloat16 mid = __float2bfloat16_rn(r1);
      parts[0][e] = hi;
      parts[1][e] = mid;
      parts[2][e] = __float2bfloat16_rn(r1 - __bfloat162float(mid));
    }
    __nv_bfloat16* dst = out + blk * PARTS * R * BK + ((r / 8) * (BK / 8) + q) * 64 + (r % 8) * 8;
#pragma unroll
    for (int p = 0; p < PARTS; ++p)
      *reinterpret_cast<uint4*>(dst + p * R * BK) = *reinterpret_cast<const uint4*>(parts[p]);
  }
}

}  // namespace

// Plain C entry points (bound with ctypes). Both launch on `stream` and
// return the launch's cudaError_t (0 on success).
//
// split_planes_launch: x (rows, k) float32, contiguous and 16-byte aligned,
// k a multiple of 32 -> out, ceil(rows / tile_rows) * (k / 32) * 3 *
// tile_rows * 32 bf16 (the planes above), tile_rows 128 for the x operand
// of split_gemm_launch and 192 for its W operand.
extern "C" int split_planes_launch(const void* x, void* out, int rows, int k, int tile_rows, void* stream) {
  if (rows < 0 || k < BK || k % BK || (tile_rows != BM && tile_rows != BN) ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  const long long tiles = (rows + tile_rows - 1) / tile_rows;
  const long long items = tiles * tile_rows * (k / 8);
  const unsigned blocks = (unsigned)((items + 255) / 256 < 132 * 16 ? (items + 255) / 256 : 132 * 16);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  if (tile_rows == BM)
    split_planes<BM><<<blocks, 256, 0, s>>>(xf, o, rows, k, items);
  else
    split_planes<BN><<<blocks, 256, 0, s>>>(xf, o, rows, k, items);
  return (int)cudaGetLastError();
}

// split_gemm_launch: a the planes of x (m, k) at tile_rows 128, b those of
// W (n, k) at tile_rows 192 -> y (m, n) float32, contiguous, = x W^T.
extern "C" int split_gemm_launch(const void* a, const void* b, void* y, int m, int n, int k, void* stream) {
  if (m < 0 || n < 1 || k < BK || k % BK) return (int)cudaErrorInvalidValue;
  if (m == 0) return (int)cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(split_gemm, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((m + BM - 1) / BM), (unsigned)((n + BN - 1) / BN));
  split_gemm<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b), static_cast<float*>(y), m, n,
      k / BK);
  return (int)cudaGetLastError();
}
