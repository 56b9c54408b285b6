// Causal grouped-query attention on Hopper's tensor cores at float32
// accuracy (sm_90a): K8.
//
// Replaces no TPU kernel: the JAX package has no Voxtral. It replaces the
// Voxtral decoder's attention (models/voxtral.py::lm_attend): K and V
// expanded from 8 to 32 heads (repeat_interleave), PyTorch's float32
// memory-efficient attention (fmha_cutlassF_f32_aligned_64x128_rf_sm80,
// mma.sync in 3xTF32) and the merge copy to (B, T, H d). Float32 q (B, H,
// T, 128), k and v (B, H_kv, T, 128), any strides with the head size
// contiguous, query head h reading KV head h / (H / H_kv); out (B, T, H
// 128) = softmax(q k^T / sqrt(128) + causal) v, written in place.
//
// Bound. Q K^T and P V over the causal pairs are 4 T (T + 1) / 2 * 128
// operations a head. Each float32 operand is split into three bf16 planes
// that sum to it exactly (hi, mid, lo: K1's and K7's split3), and each
// product is the six part products of order 2^-16 and up (hi hi, hi mid,
// mid hi, hi lo, mid mid, lo hi), so the kernel runs six bf16 products at
// 989 TFLOP/s: ~165 TFLOP/s of float32 work at most. The planes it reads
// (Q once, K and V once a query tile, mostly from L2) are far below that.
//
// Accuracy. The tensor cores round a product's sum toward zero, so each
// 32-deep chunk (two k16 steps of six products, the five smaller ones of
// both steps first, then hi hi) is summed there from zero and the chunks
// are added in IEEE fp32 in registers, as K7 does: S = Q K^T over the head
// size in four chunks, O = P V over a tile's 64 positions in two. The
// softmax runs in fp32 online (a running max and sum a row, the output
// rescaled when the max grows), its exponent exp2f(s c - m c) with c =
// log2(e) / sqrt(128), as the CUTLASS kernel takes it; P (in [0, 1]) is
// split in three in registers, exactly, and the row sums are P's own.
// Nothing is computed below float32's accuracy.
//
// Design. lm_planes_launch lays the operands out first, each block one
// contiguous run a bulk copy moves: Q as (B, H_kv, q tile, d chunk, part,
// 128 x 32) bf16 blocks in the wgmma K-major core-matrix layout (K7's),
// a q tile's 128 rows the group's H / H_kv heads at 128 H_kv / H positions
// each, so that one block computes every query head that reads one KV head;
// K and V as (B, H_kv, kv tile of 64, item, 24 KB): items 0 and 1 K's d
// chunks 0-1 and 2-3 (64 x 32 each), items 2 and 3 V's positions 0-31 and
// 32-63 transposed (128 d rows x 32 positions, K-major for the P V
// product). A block owns one q tile: a producer thread loads its Q planes
// (96 KB) once and streams the K/V items of the tiles at or below the
// diagonal through a ring of SLOTS = 5 slots with cp.async.bulk, completed
// on mbarriers; two consumer warpgroups, 64 query rows each, run S = Q K^T
// from shared memory (wgmma m64n64k16), mask the diagonal tile in
// registers, take the online softmax, split P into its planes in registers
// (the accumulator's layout is the A operand's) and run O += P V with P
// from registers and V^T from shared memory, the head size in two halves
// of 64 columns (wgmma m64n64k16). Each KV head's tile is read once for the
// group's query heads. Registers set the shape: nine warps put three on
// one of the SM's four register files, which caps a thread at 168
// registers, and ptxas held the kernel to that cap with setmaxnreg too
// (measured). O (64), its chunk sum, S and its chunk sum (32 each) and P's
// planes fit there only with P V in halves: one 64 x 128 chunk sum (64
// registers) spilled and ran 8% slower. Blocks start longest first (the q
// tiles from the end), so that the causal triangle's short tiles fill the
// last wave.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 128;       // head size
constexpr int ROWS = 128;    // query rows a block: two consumer warpgroups of 64 (ROWS in ops/lm_attention.py)
constexpr int BKV = 64;      // key/value positions a tile (BLOCK_KV)
constexpr int CHUNK = 32;    // depth summed on the tensor cores from zero
constexpr int PARTS = 3;     // bf16 parts of a float32 operand
constexpr int ITEM = PARTS * D * CHUNK;  // bf16 elements of one ring item: 2 K chunks of 64 rows, or 32 V positions
constexpr int Q_BLOCK = PARTS * ROWS * CHUNK;  // one d chunk of a q tile, all parts
constexpr int Q_ELEMS = (D / CHUNK) * Q_BLOCK;
constexpr int K_PART = BKV * CHUNK;      // one part of one K chunk
constexpr int V_PART = D * CHUNK;        // one part of one V item
constexpr int SLOTS = 5;
constexpr int PV_N = 64;  // output columns a P V wgmma: the head size in two halves
constexpr int THREADS = 288;  // warpgroups 0 and 1 consume; warp 8's first thread produces
constexpr unsigned ITEM_BYTES = ITEM * 2;  // 24,576
constexpr unsigned Q_BYTES = Q_ELEMS * 2;  // 98,304
constexpr size_t SMEM = Q_BYTES + (size_t)SLOTS * ITEM_BYTES + (2 * SLOTS + 1) * sizeof(uint64_t);
static_assert(SMEM <= 232448, "a block may have 227 KB of shared memory");
static_assert(2 * K_PART * PARTS == ITEM && V_PART * PARTS == ITEM, "an item is half a K or half a V tile");

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
// bytes apart (leading byte offset), 8-row groups CHUNK / 8 * 128 = 512
// bytes apart (stride byte offset).
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)((CHUNK / 8 * 128) >> 4) << 32);
}

// D(64 x 64, f32) = A(64 x 16, bf16, K-major smem) . B(16 x 64, bf16, K-major smem) + (keep ? D : 0)
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t a, uint64_t b, int keep) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(keep));
}

// D(64 x 64, f32) = A(64 x 16, bf16, registers) . B(16 x 64, bf16, K-major smem) + (keep ? D : 0)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int keep) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(keep));
}

// bf16 (hi, mid, lo) of a float32 pair, packed two to a register (the
// first value in the low half): hi = bf16(x), mid = bf16(x - hi), lo =
// bf16(x - hi - mid), each difference exact in fp32
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi, uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float r0 = x0 - __low2float(h), r1 = x1 - __high2float(h);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(r0 - __low2float(m), r1 - __high2float(m));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// One 32-deep chunk of S: both k16 steps' six part products into d, the
// first from zero; da(p, st) and db(p, st) are part p's descriptors at step st
template <typename DA, typename DB>
__device__ __forceinline__ void s_chunk(float (&d)[32], DA da, DB db) {
  wgmma_fence();
#pragma unroll
  for (int st = 0; st < CHUNK / 16; ++st) {
    wgmma_ss64(d, da(1, st), db(1, st), st > 0);
    wgmma_ss64(d, da(0, st), db(2, st), 1);
    wgmma_ss64(d, da(2, st), db(0, st), 1);
    wgmma_ss64(d, da(0, st), db(1, st), 1);
    wgmma_ss64(d, da(1, st), db(0, st), 1);
  }
#pragma unroll
  for (int st = 0; st < CHUNK / 16; ++st) wgmma_ss64(d, da(0, st), db(0, st), 1);
  wgmma_commit();
  wgmma_wait0();
}

__global__ void __launch_bounds__(THREADS, 1)
lm_attention(const __nv_bfloat16* __restrict__ qp, const __nv_bfloat16* __restrict__ kvp, float* __restrict__ out,
             int heads, int kv_heads, int t, int q_tiles, int kv_tiles, float c) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [D / CHUNK][PARTS][ROWS * CHUNK]
  __nv_bfloat16* ring = q_s + Q_ELEMS;                           // [SLOTS][ITEM]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + SLOTS * ITEM);  // [SLOTS]: landed
  uint64_t* empty = full + SLOTS;                                     // [SLOTS]: read by both consumers
  uint64_t* q_full = empty + SLOTS;
  const int tid = threadIdx.x, wg = tid / 128;
  // longest first: the last q tiles of every (batch, KV head) start the grid
  const int bg = blockIdx.x % (gridDim.x / q_tiles), qt = q_tiles - 1 - blockIdx.x / (gridDim.x / q_tiles);
  const int group = heads / kv_heads, pw = 64 / group;  // query heads a KV head; positions a warpgroup
  const int last = (qt + 1) * 2 * pw - 1;  // the block's last position
  const int tiles = min(last / BKV + 1, kv_tiles);
  if (tid == 0) {
    for (int s = 0; s < SLOTS; ++s) {
      mbar_init(&full[s], 1);   // the producer's expect_tx
      mbar_init(&empty[s], 2);  // one arrival a consumer warpgroup
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // the producer: one thread streams the tile's operands
    if (tid == 256) {
      const __nv_bfloat16* q_src = qp + ((size_t)bg * q_tiles + qt) * Q_ELEMS;
      mbar_expect_tx(q_full, Q_BYTES);
      for (int i = 0; i < D / CHUNK; ++i) bulk_load(q_s + i * Q_BLOCK, q_src + i * Q_BLOCK, Q_BLOCK * 2, q_full);
      const __nv_bfloat16* kv_src = kvp + (size_t)bg * kv_tiles * 4 * ITEM;
      for (int i = 0; i < 4 * tiles; ++i) {
        const int s = i % SLOTS;
        if (i >= SLOTS) mbar_wait(&empty[s], (i / SLOTS - 1) & 1);  // its last readers are done
        mbar_expect_tx(&full[s], ITEM_BYTES);
        bulk_load(ring + s * ITEM, kv_src + (size_t)i * ITEM, ITEM_BYTES, &full[s]);
      }
    }
    return;
  }

  // a consumer: rows 64 wg .. of the q tile. Accumulator entry 4 j + e is
  // row 16 warp + g + 8 (e / 2), column 8 j + 2 tq + e % 2 of the
  // warpgroup's tile; the thread's two rows are r0 and r0 + 8, and row r
  // is query head (bg % kv_heads) group + r / pw at position qt 2 pw + wg pw + r % pw
  const int warp = (tid / 32) % 4, lane = tid % 32, g = lane / 4, tq = lane % 4;
  const int r0 = 16 * warp + g, r1 = r0 + 8;
  const int base = qt * 2 * pw + wg * pw;
  const int pos0 = base + r0 % pw, pos1 = base + r1 % pw;
  const int lo_pos = min(pos0, pos1);

  float o[64];         // the running output, unnormalised
  float oc[PV_N / 2];  // one chunk of P V at PV_N of its columns, summed on the tensor cores
  float s[32];         // S of the tile, then P
  float cs[32];        // one chunk of S
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  float mc0 = -INFINITY, mc1 = -INFINITY;  // the rows' running max of S, times c
  float l0 = 0.f, l1 = 0.f;                // this thread's part of the rows' sums of P

  mbar_wait(q_full, 0);
  const uint64_t q_desc = kmajor_desc(smem_u32(q_s + wg * 64 * CHUNK));
  for (int j = 0; j < tiles; ++j) {
    // S = Q K^T: items 4 j and 4 j + 1, two d chunks each
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 4 * j + h, slot = i % SLOTS;
      mbar_wait(&full[slot], (i / SLOTS) & 1);
      const uint64_t k_desc = kmajor_desc(smem_u32(ring + slot * ITEM));
#pragma unroll
      for (int c2 = 0; c2 < 2; ++c2) {
        const int chunk = 2 * h + c2;
        auto da = [&](int p, int st) {
          return q_desc + (uint64_t)(((chunk * PARTS + p) * ROWS * CHUNK * 2 + st * 256) >> 4);
        };
        auto db = [&](int p, int st) { return k_desc + (uint64_t)(((c2 * PARTS + p) * K_PART * 2 + st * 256) >> 4); };
        if (chunk == 0) {
          s_chunk(s, da, db);
        } else {
          s_chunk(cs, da, db);
#pragma unroll
          for (int e = 0; e < 32; ++e) s[e] += cs[e];
        }
      }
      if (tid % 128 == 0) mbar_arrive(&empty[slot]);
    }

    // the diagonal tile: columns past a row's position are masked
    if (j * BKV + BKV - 1 > lo_pos) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int col = j * BKV + 8 * (e / 4) + 2 * tq + e % 2;
        if (col > ((e % 4) < 2 ? pos0 : pos1)) s[e] = -INFINITY;
      }
    }
    // the online softmax: new maxima, the rescale of what was summed, P
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int e = 0; e < 32; e += 4) {
      mx0 = fmaxf(mx0, fmaxf(s[e], s[e + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[e + 2], s[e + 3]));
    }
#pragma unroll
    for (int x = 1; x < 4; x *= 2) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
    }
    const float new0 = fmaxf(mc0, mx0 * c), new1 = fmaxf(mc1, mx1 * c);
    const float alpha0 = exp2f(mc0 - new0), alpha1 = exp2f(mc1 - new1);
    mc0 = new0;
    mc1 = new1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int e = 0; e < 32; e += 4) {
      s[e] = exp2f(fmaf(s[e], c, -new0));
      s[e + 1] = exp2f(fmaf(s[e + 1], c, -new0));
      s[e + 2] = exp2f(fmaf(s[e + 2], c, -new1));
      s[e + 3] = exp2f(fmaf(s[e + 3], c, -new1));
      sum0 += s[e] + s[e + 1];
      sum1 += s[e + 2] + s[e + 3];
    }
    l0 = fmaf(l0, alpha0, sum0);
    l1 = fmaf(l1, alpha1, sum1);
#pragma unroll
    for (int e = 0; e < 64; e += 4) {
      o[e] *= alpha0;
      o[e + 1] *= alpha0;
      o[e + 2] *= alpha1;
      o[e + 3] *= alpha1;
    }

    // O += P V: items 4 j + 2 and 4 j + 3, 32 positions each
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // P's parts at the half's two k16 steps: the accumulator entries of
      // columns 16 ks .. 16 ks + 15 are the A fragment of step ks
      uint32_t a[2][PARTS][4];
#pragma unroll
      for (int st = 0; st < 2; ++st)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int e = 8 * (2 * h + st) + 2 * r;
          split_pair(s[e], s[e + 1], a[st][0][r], a[st][1][r], a[st][2][r]);
        }
      const int i = 4 * j + 2 + h, slot = i % SLOTS;
      mbar_wait(&full[slot], (i / SLOTS) & 1);
      const uint64_t v_desc = kmajor_desc(smem_u32(ring + slot * ITEM));
#pragma unroll
      for (int dh = 0; dh < D / PV_N; ++dh) {
        // output columns PV_N dh ..: V^T's depth rows PV_N dh .., 8-row groups 512 bytes apart
        auto dv = [&](int p, int st) {
          return v_desc + (uint64_t)((p * V_PART * 2 + dh * PV_N * 64 + st * 256) >> 4);
        };
        wgmma_fence();
#pragma unroll
        for (int st = 0; st < 2; ++st) {
          wgmma_rs(oc, a[st][1], dv(1, st), st > 0);
          wgmma_rs(oc, a[st][0], dv(2, st), 1);
          wgmma_rs(oc, a[st][2], dv(0, st), 1);
          wgmma_rs(oc, a[st][0], dv(1, st), 1);
          wgmma_rs(oc, a[st][1], dv(0, st), 1);
        }
#pragma unroll
        for (int st = 0; st < 2; ++st) wgmma_rs(oc, a[st][0], dv(0, st), 1);
        wgmma_commit();
        wgmma_wait0();
        if (dh == D / PV_N - 1 && tid % 128 == 0) mbar_arrive(&empty[slot]);
#pragma unroll
        for (int e = 0; e < PV_N / 2; ++e) o[dh * PV_N / 2 + e] += oc[e];
      }
    }
  }

  // the rows' sums from the four threads that share them, then O / l into (B, T, H D)
#pragma unroll
  for (int x = 1; x < 4; x *= 2) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  const int b = bg / kv_heads, kvh = bg % kv_heads;
  const int head0 = kvh * group + r0 / pw, head1 = kvh * group + r1 / pw;
  float* row0 = out + ((size_t)b * t + pos0) * heads * D + head0 * D + 2 * tq;
  float* row1 = out + ((size_t)b * t + pos1) * heads * D + head1 * D + 2 * tq;
#pragma unroll
  for (int jj = 0; jj < 16; ++jj) {
    if (pos0 < t) *reinterpret_cast<float2*>(row0 + 8 * jj) = make_float2(o[4 * jj] / l0, o[4 * jj + 1] / l0);
    if (pos1 < t) *reinterpret_cast<float2*>(row1 + 8 * jj) = make_float2(o[4 * jj + 2] / l1, o[4 * jj + 3] / l1);
  }
}

// A float32 (B, heads, T, 128) tensor with the head size contiguous
struct Src {
  const float* p;
  long long sb, sh, st;  // strides in elements
};

// Item i of the split: 8 consecutive depth values (one core-matrix row)
// of one block row: Q's (batch, KV head, q tile, d chunk, row, k group),
// then K's (batch, KV head, kv tile, d chunk, row, k group), then V's
// (batch, KV head, kv tile, half, k group, d row), each written as its
// three parts; rows past T are zero.
__global__ void __launch_bounds__(256)
lm_planes(Src q, Src k, Src v, __nv_bfloat16* __restrict__ qp, __nv_bfloat16* __restrict__ kvp, int kv_heads,
          int group, int t, int q_tiles, int kv_tiles, long long q_items, long long k_items, long long items) {
  const int pw = 64 / group;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < items;
       i += (long long)gridDim.x * blockDim.x) {
    float x[8];
    __nv_bfloat16* dst;
    int part_stride;
    if (i < q_items) {
      const int kq = (int)(i % 4), r = (int)(i / 4 % ROWS), chunk = (int)(i / (4 * ROWS) % (D / CHUNK));
      const long long bq = i / (4 * ROWS * (D / CHUNK));  // (batch, KV head) tile
      const int qt = (int)(bq % q_tiles);
      const long long bg = bq / q_tiles;
      const int b = (int)(bg / kv_heads), kvh = (int)(bg % kv_heads);
      const int rr = r % 64, head = kvh * group + rr / pw, pos = qt * 2 * pw + (r / 64) * pw + rr % pw;
      const float* src = q.p + b * q.sb + head * q.sh + pos * q.st + chunk * CHUNK + kq * 8;
      if (pos < t) {
        const float4 v0 = reinterpret_cast<const float4*>(src)[0], v1 = reinterpret_cast<const float4*>(src)[1];
        x[0] = v0.x, x[1] = v0.y, x[2] = v0.z, x[3] = v0.w, x[4] = v1.x, x[5] = v1.y, x[6] = v1.z, x[7] = v1.w;
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) x[e] = 0.f;
      }
      dst = qp + (bq * (D / CHUNK) + chunk) * Q_BLOCK + ((r / 8) * 4 + kq) * 64 + (r % 8) * 8;
      part_stride = ROWS * CHUNK;
    } else if (i < q_items + k_items) {
      const long long n = i - q_items;
      const int kq = (int)(n % 4), r = (int)(n / 4 % BKV), chunk = (int)(n / (4 * BKV) % (D / CHUNK));
      const long long bj = n / (4 * BKV * (D / CHUNK));  // (batch, KV head, kv tile)
      const int j = (int)(bj % kv_tiles);
      const long long bg = bj / kv_tiles;
      const int b = (int)(bg / kv_heads), kvh = (int)(bg % kv_heads), pos = j * BKV + r;
      const float* src = k.p + b * k.sb + kvh * k.sh + pos * k.st + chunk * CHUNK + kq * 8;
      if (pos < t) {
        const float4 v0 = reinterpret_cast<const float4*>(src)[0], v1 = reinterpret_cast<const float4*>(src)[1];
        x[0] = v0.x, x[1] = v0.y, x[2] = v0.z, x[3] = v0.w, x[4] = v1.x, x[5] = v1.y, x[6] = v1.z, x[7] = v1.w;
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) x[e] = 0.f;
      }
      dst = kvp + (bj * 4 + chunk / 2) * ITEM + (chunk % 2) * PARTS * K_PART + ((r / 8) * 4 + kq) * 64 + (r % 8) * 8;
      part_stride = K_PART;
    } else {
      const long long n = i - q_items - k_items;
      const int r = (int)(n % D), kq = (int)(n / D % 4), half = (int)(n / (4 * D) % 2);
      const long long bj = n / (8 * D);
      const int j = (int)(bj % kv_tiles);
      const long long bg = bj / kv_tiles;
      const int b = (int)(bg / kv_heads), kvh = (int)(bg % kv_heads), pos = j * BKV + half * CHUNK + kq * 8;
      const float* src = v.p + b * v.sb + kvh * v.sh + r;
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = pos + e < t ? src[(pos + e) * v.st] : 0.f;
      dst = kvp + (bj * 4 + 2 + half) * ITEM + ((r / 8) * 4 + kq) * 64 + (r % 8) * 8;
      part_stride = V_PART;
    }
    __align__(16) __nv_bfloat16 parts[PARTS][8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const __nv_bfloat16 hi = __float2bfloat16_rn(x[e]);
      const float r1 = x[e] - __bfloat162float(hi);
      const __nv_bfloat16 mid = __float2bfloat16_rn(r1);
      parts[0][e] = hi;
      parts[1][e] = mid;
      parts[2][e] = __float2bfloat16_rn(r1 - __bfloat162float(mid));
    }
#pragma unroll
    for (int p = 0; p < PARTS; ++p)
      *reinterpret_cast<uint4*>(dst + p * part_stride) = *reinterpret_cast<const uint4*>(parts[p]);
  }
}

bool shape_ok(int batch, int heads, int kv_heads, int t) {
  if (batch < 1 || kv_heads < 1 || t < 1 || heads % kv_heads) return false;
  const int group = heads / kv_heads;
  return group == 1 || group == 2 || group == 4 || group == 8 || group == 16;
}

}  // namespace

// Plain C entry points (bound with ctypes). Both launch on `stream` and
// return the launch's cudaError_t (0 on success).
//
// lm_planes_launch: q (batch, heads, t, 128), k and v (batch, kv_heads, t,
// 128) float32, the last stride 1, the others in elements, every pointer
// and stride 16-byte aligned -> qp, batch * kv_heads * q_tiles * 49,152
// bf16, and kvp, batch * kv_heads * kv_tiles * 49,152 bf16 (the planes
// above), q_tiles = ceil(t / (128 kv_heads / heads)), kv_tiles = ceil(t / 64).
extern "C" int lm_planes_launch(const void* q, const void* k, const void* v, void* qp, void* kvp, int batch,
                                int heads, int kv_heads, int t, long long q_sb, long long q_sh, long long q_st,
                                long long k_sb, long long k_sh, long long k_st, long long v_sb, long long v_sh,
                                long long v_st, void* stream) {
  if (!shape_ok(batch, heads, kv_heads, t)) return (int)cudaErrorInvalidValue;
  const uintptr_t addresses = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                              reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(qp) |
                              reinterpret_cast<uintptr_t>(kvp);
  if (addresses % 16 || (q_sb | q_sh | q_st | k_sb | k_sh | k_st) % 4) return (int)cudaErrorInvalidValue;
  const int group = heads / kv_heads, q_tiles = (t + 128 / group - 1) / (128 / group), kv_tiles = (t + BKV - 1) / BKV;
  const long long bg = (long long)batch * kv_heads;
  const long long q_items = bg * q_tiles * (D / CHUNK) * ROWS * 4, k_items = bg * kv_tiles * (D / CHUNK) * BKV * 4;
  const long long items = q_items + k_items + bg * kv_tiles * 2 * 4 * D;
  const unsigned blocks = (unsigned)((items + 255) / 256 < 132 * 16 ? (items + 255) / 256 : 132 * 16);
  lm_planes<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      Src{static_cast<const float*>(q), q_sb, q_sh, q_st}, Src{static_cast<const float*>(k), k_sb, k_sh, k_st},
      Src{static_cast<const float*>(v), v_sb, v_sh, v_st}, static_cast<__nv_bfloat16*>(qp),
      static_cast<__nv_bfloat16*>(kvp), kv_heads, group, t, q_tiles, kv_tiles, q_items, k_items, items);
  return (int)cudaGetLastError();
}

// lm_attention_launch: the planes of lm_planes_launch -> out (batch, t,
// heads * 128) float32, contiguous, softmax(q k^T / sqrt(128) + causal) v.
extern "C" int lm_attention_launch(const void* qp, const void* kvp, void* out, int batch, int heads, int kv_heads,
                                   int t, void* stream) {
  if (!shape_ok(batch, heads, kv_heads, t)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(lm_attention, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  const int group = heads / kv_heads, q_tiles = (t + 128 / group - 1) / (128 / group), kv_tiles = (t + BKV - 1) / BKV;
  const float c = (float)(1.4426950408889634 / sqrt((double)D));  // log2(e) / sqrt(d)
  lm_attention<<<(unsigned)(batch * kv_heads * q_tiles), THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(qp), static_cast<const __nv_bfloat16*>(kvp), static_cast<float*>(out), heads,
      kv_heads, t, q_tiles, kv_tiles, c);
  return (int)cudaGetLastError();
}
