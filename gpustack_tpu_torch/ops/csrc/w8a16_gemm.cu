// Weight-only int8 matrix product for Hopper (sm_90a): bf16 activations,
// int8 weights with per-output-channel bf16 scales, bf16 out.
//
//   out[M, N] = bf16( (sum_k x[m, k] * q[k, n]) * s[n] )
//
// x is bf16 [M, K] (rows ldx elements apart), q is int8 [K, N] in the JAX
// package's [in, out] layout (rows ldq bytes apart, one layer's view of the
// stacked [L, K, N]), s is bf16 [N], out is bf16 [M, N] (rows ldo apart).
// The sum and the scale are fp32. The dequantized weight never reaches
// device memory: int8 values are widened in registers or shared memory.
//
// Replaces no Pallas kernel: in the JAX package this product is the int8
// branch of _mm (gpustack_tpu/models/transformer.py:46-47), einsum(x,
// q.astype(bf16)) * s, whose convert XLA fuses into the matrix unit's
// operand feed. Eager PyTorch cannot fuse it, and the same line there would
// write and read back a bf16 copy of every weight on every decode step.
//
// Two paths, chosen by M:
//   - M <= 16 (decode; the prefill's last position through lm_head): a
//     split-N / split-K GEMV on the tensor cores, bound by the bytes of q
//     (58.7 MB for w_gate at llama3-8b: ~17.5 us at 3.35 TB/s). At M = 8 the
//     same product on the fp32 FMA units would take ~14 us of issue alone
//     (470 M FMAs at ~33.5 T/s), so the weights go through mma.sync
//     m16n8k16 with q as the A operand (16 output columns) and x as B (8
//     tokens; two B tiles for M in 9..16). A CTA is 8 warps on one slice of
//     128 columns; warp w takes the 16-row k steps w, w + 8, ... Each lane
//     loads 16 columns (one 16-byte load) of four k rows, so the warp's 32
//     lanes read four full 128-byte lines per row group. The order of k
//     inside a step is free as long as A and B agree, so lane (g, t) gives
//     its rows 4t..4t+3 the mma's k slots 2t, 2t+1, 2t+8, 2t+9; its B
//     fragment is then the four bf16 x values at those k, one 8-byte load
//     (x is read straight from global memory: no CTA reads it twice). The
//     int8 bytes become bf16 pairs in registers (2^23 + v trick, one
//     byte-permute, one add and half a byte-permute each). The 8 warps'
//     sums reduce through shared memory. When the grid alone does not fill
//     the card, K is split over up to 8 CTAs of one thread-block cluster,
//     which add each other's sums through distributed shared memory: no
//     fp32 workspace and no second kernel.
//   - M > 16 (prefill, chunks, prefix-hit suffixes): bound by operations
//     above M ~ 150 (2M flops per weight byte against the card's ~295; at
//     w_gate, M = 2048: 240.5 GFLOP, ~0.243 ms at 989 TFLOP/s), by the bytes
//     of q below. Only wgmma reaches the tensor cores' full rate, and its
//     B operand must be bf16 in shared memory, so the int8 tile is widened
//     there once per CTA and stage, not once per warp in registers:
//       * a CTA is 128 x BN output (BN 128 or 256, the wrapper's plan) and
//         three warpgroups. One thread of the first consumer issues TMA
//         loads into a ring of 6 (BN 128) or 4 (BN 256) stages of 64 k: x
//         as a [128][64] bf16 box with 128-byte swizzle (K-major, wgmma's
//         A), q as an unswizzled int8 [64][BN] box into the first half of
//         the stage's bf16 weight slot. TMA's zero fill covers ragged M, N
//         and K;
//       * the first warpgroup widens each stage's int8 tile in place into
//         bf16 boxes of [64 k][64 n] with 128-byte swizzle (N-major: wgmma's
//         transposed B, the layout the flash kernel feeds V in): 16-byte
//         shared loads of the whole tile into registers, a named barrier,
//         the 2^23 + v trick (exact, no cvt per byte), 16-byte swizzled
//         stores free of bank conflicts, then fence.proxy.async and an
//         mbarrier arrive per warp. ~2.75 ALU ops
//         per weight byte, overlapped with the consumers' products on the
//         other stages; it gives its registers away (setmaxnreg.dec);
//       * two consumer warpgroups of 64 rows (setmaxnreg.inc) wait for x and
//         the widened tile, issue 4 wgmma m64nBNk16 with fp32 accumulators,
//         keep one stage's products in flight and release the stage before.
//         Barriers per stage: full (TMA bytes), wide (the widening warps),
//         empty (the consumer warps). The widening warps' waits trap after
//         4 s, so a wrong phase fails the launch instead of hanging;
//       * epilogue: scale by s[n] in fp32, round once to bf16, 4-byte
//         stores of column pairs straight from the accumulators, rows past M
//         and columns past N dropped;
//       * below M ~ 150 the product is bound by the bytes of q, and a grid
//         of 128-row tiles can leave SMs idle (w_down at M = 64: 32 CTAs).
//         The wrapper then splits K over up to 8 CTAs of one thread-block
//         cluster; each writes its fp32 sums into its drained ring, and each
//         adds up a share of the tile over the cluster's distributed shared
//         memory before the epilogue, as the GEMV does.
//     Not done yet: a persistent tile scheduler (one CTA per SM walking
//     tiles, so one tile's epilogue overlaps the next one's loads), and
//     the register-A variant (q^T as wgmma's A from registers), which
//     needs the weights repacked away from the JAX layout.
//
// Grouped over an MoE layer's experts (w8a16_grouped_bf16): the routed
// expert product. x holds the (token, expert) pairs of one token chunk
// sorted by expert, [P, K]; offsets [E + 1] (int32, on the card) bound each
// expert's segment of rows, and
//
//   out[r] = bf16( (x[r] @ q[e(r)]) * s[e(r)] ),  offsets[e] <= r < offsets[e+1]
//
// with q int8 [E, K, N] and s bf16 [E, N], the sums in fp32 rounded once.
// It stands for the expert products of the JAX _moe_mlp
// (gpustack_tpu/models/transformer.py:487-502: _mm at :38, its int8 branch
// at :46-47, or einsum, over the expert axis: every expert over every
// token, XLA products), not for a Pallas kernel: only the experts some
// token picked are read, with the same values up to summation order, no
// capacity and no dropped token. The host never reads the counts (the
// serving loop must not wait on the card):
//   - rows per expert <= 16 (decode): the GEMV's grid is column slices x K
//     split x E; a CTA reads its expert's offset and count and returns
//     before it reads a byte of weight when no token picked the expert;
//   - above (prefills, chunks, embeddings): grouped_wgmma, a persistent
//     kernel. At the 2048 bucket qwen3-30b-a3b's, deepseek-v2-lite's and
//     gpt-oss-20b's products are bound by bytes (each reached expert's
//     weight read once is most of them: 495 MB for qwen3's gate, 0.148 ms
//     at 3.35 TB/s), mixtral-8x7b's by operations (481 GFLOP, 0.486 ms at
//     989 TFLOP/s). What the design does about each:
//       * one CTA per SM, each walking units b, b + gridDim.x, ... of the
//         host's plan (ops/w8a16.py grouped_plan, from P, E and N alone):
//         a unit is BM rows of one expert's segment by BN columns. CTAs'
//         shares differ by one unit at most; there is no wave of short
//         CTAs and one prologue a CTA: it copies offsets into shared
//         memory (up to GR_TABLE_EXPERTS experts; its walk reads device
//         memory above) and one warp sums the experts' units;
//       * one ring across a CTA's units: the producer loads the next
//         unit's stages while the consumers finish the current one, the
//         barriers' phases carrying on, so the ring fills once a CTA and
//         the bytes-bound products stream their weights without a gap at
//         each tile;
//       * bf16 units of 64 rows below a mean of GROUPED_BM128_ROWS rows
//         an expert: the ragged last unit of each expert wastes at most 63
//         rows, and the two consumer warpgroups take units in turn
//         (ping-pong, passed on by a turn barrier), so one's epilogue
//         overlaps the other's products. Units of 128 rows (bf16 above
//         that mean, int8 always) keep both on one unit, 64 rows each, so
//         a widened int8 tile feeds 128 rows (at 64 the widening set the
//         pace of every int8 product); a warpgroup whose rows lie past the
//         segment skips its products;
//       * BN of 128, 192 or 256 (int8: 128 or 256, the widths widen_tile
//         maps), the one whose units load the fewest bytes of x and
//         weight tiles over N (each column tile reloads its x rows): 256
//         at every served width, with as many ring stages as fit in
//         227 KB;
//       * an expert's units run column strip by column strip: the row
//         units of one strip run together on neighbouring CTAs and share
//         its weights in L2 (row unit by row unit, sharing x rows, was
//         slower at every served product); experts follow in order;
//       * no K split: at every served prefill the units outnumber the SMs.
//     x is one 2-D tensor map over [P, K] in boxes of [BM rows][64 k], q
//     the 3-D {N, K, E} map at the unit's expert; rows of a unit past its
//     segment (the next expert's) are computed and not stored, rows past P
//     read as TMA's zeros.
// The 2-D entry (w8a16_gemm_bf16) runs w8a16_wgmma above, a CTA per 128 x
// BN tile.
//
// bf16 experts (bf16_grouped_bf16) are the same kernels with the weight
// type a template parameter (BF16W): the GEMV loads 32 bytes of a weight
// row per lane in place of 16 and builds the same mma fragments without
// widening; grouped_wgmma has no widening stage: the first thread of its
// first warpgroup issues the TMA loads, and q's map reads bf16 boxes of
// [64 k][64 n] with the 128-byte swizzle straight into the layout the
// widening warps write for int8 (N-major, wgmma's transposed B). No scale:
// out[r] = bf16(x[r] @ w[e(r)]).
//
// Requirements the wrapper checks: K % 8 == 0, N % 16 == 0, x rows, q rows
// and q's experts 16-byte aligned (TMA's global-stride rule too), out rows
// 4-byte aligned.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// Small M: the GEMV
// ---------------------------------------------------------------------------

constexpr int GEMV_MAX_M = 16;                  // rows per expert
constexpr int GV_WARPS = 8;
constexpr int GV_THREADS = 32 * GV_WARPS;
constexpr int GV_BN = 128;                       // columns per CTA
constexpr int GV_KSTEP = 16;                     // k rows per mma
constexpr int MAX_KSPLIT = 8;                    // portable cluster size
constexpr int GV_SUMS = 32 * 32;                 // one B tile's sums per warp

__device__ __forceinline__ float widen_byte(uint32_t biased, int i) {
  // biased holds four int8 values with the sign bit flipped (v + 128);
  // 0x4B000000 | u is the float 2^23 + u, exact
  const uint32_t bits = __byte_perm(biased, 0x4B000000u, 0x7440u | i);
  return __uint_as_float(bits) - 8388736.0f;     // 2^23 + 128
}

// bf16 pair {byte i of lo, byte i of hi}: v is an integer of at most 8
// significant bits, so its fp32 value's upper half is its bf16, exactly
__device__ __forceinline__ uint32_t bf16_pair(uint32_t lo, uint32_t hi,
                                              int i) {
  return __byte_perm(__float_as_uint(widen_byte(lo, i)),
                     __float_as_uint(widen_byte(hi, i)), 0x7632u);
}

// bf16 pair {low halves of a and b} or {high halves}: column 2j or 2j + 1
// of two k rows of bf16 weights, word j of each row
__device__ __forceinline__ uint32_t bf16_lo(uint32_t a, uint32_t b) {
  return __byte_perm(a, b, 0x5410u);
}
__device__ __forceinline__ uint32_t bf16_hi(uint32_t a, uint32_t b) {
  return __byte_perm(a, b, 0x7632u);
}

// Expert e's rows of a grouped call, [offsets[e], offsets[e + 1]); without
// offsets (the 2-D entry) every row of the single expert.
struct Segment {
  int begin, rows;
};

__device__ __forceinline__ Segment segment(const int* offsets, int e, int M) {
  if (offsets == nullptr) return {0, M};
  const int b = offsets[e];
  return {b, offsets[e + 1] - b};
}

// NT B tiles of 8 tokens; loads for U k steps in flight per warp. BF16W:
// bf16 weights (32 bytes of a row per lane, no scale) in place of int8.
// Grid: column slices x K split (one cluster along y) x experts.
template <int NT, bool BF16W>
__global__ void __launch_bounds__(GV_THREADS, 2) w8a16_gemv(
    const __nv_bfloat16* __restrict__ x, const void* __restrict__ wq,
    const __nv_bfloat16* __restrict__ s, __nv_bfloat16* __restrict__ out,
    const int* __restrict__ offsets, int M, int N, int K, long long ldx,
    long long ldq, long long ldo, int kchunk, long long qb, long long sb) {
  using W = typename std::conditional<BF16W, __nv_bfloat16, int8_t>::type;
  constexpr int U = NT == 1 ? 2 : 1;
  constexpr int WV = BF16W ? 2 : 1;              // 16-byte loads per row
  __shared__ __align__(16) float red[GV_WARPS * GV_SUMS];
  // this CTA's expert (grid z) and its rows; every CTA of a cluster has
  // the same expert, so a cluster returns whole
  const Segment seg = segment(offsets, blockIdx.z, M);
  if (seg.rows <= 0) return;                     // no weight byte read
  // a segment longer than the plan's B tiles is the caller's fault: a
  // token picks an expert at most once, so max_rows bounds every segment
  if (seg.rows > 8 * NT) __trap();
  M = seg.rows;
  x += seg.begin * ldx;
  out += seg.begin * ldo;
  const W* q = static_cast<const W*>(wq) + blockIdx.z * qb;
  if (!BF16W) s += blockIdx.z * sb;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int n = blockIdx.x * GV_BN + 16 * g;     // this lane's 16 columns
  const bool n_ok = n < N;
  const int k_begin = blockIdx.y * kchunk;
  const int k_end = min(K, k_begin + kchunk);
  const int steps = (k_end - k_begin + GV_KSTEP - 1) / GV_KSTEP;

  float acc[NT][8][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int st = warp; st < steps; st += GV_WARPS * U) {
    uint4 w[U][4][WV];
    uint2 b[U][NT];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      // rows k..k+3 lie all inside [k_begin, k_end) or all outside it:
      // k_end is a multiple of 8
      const int k = k_begin + (st + u * GV_WARPS) * GV_KSTEP + 4 * t;
      const bool k_ok = k < k_end;
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int v = 0; v < WV; ++v)
          w[u][r][v] = k_ok && n_ok
                           ? __ldg(reinterpret_cast<const uint4*>(
                                       q + (long long)(k + r) * ldq + n) +
                                   v)
                           : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        const int m = g + 8 * i;
        b[u][i] = k_ok && m < M
                      ? __ldg(reinterpret_cast<const uint2*>(
                            x + (long long)m * ldx + k))
                      : make_uint2(0u, 0u);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (st + u * GV_WARPS >= steps) break;     // the same in every lane
      // r[row][word]: int8 rows biased (v + 128) for the 2^23 trick; bf16
      // rows as they are, word j holding columns 2j and 2j + 1
      uint32_t r[4][4 * WV];
#pragma unroll
      for (int row = 0; row < 4; ++row)
#pragma unroll
        for (int v = 0; v < WV; ++v) {
          const uint32_t bias = BF16W ? 0u : 0x80808080u;
          r[row][4 * v + 0] = w[u][row][v].x ^ bias;
          r[row][4 * v + 1] = w[u][row][v].y ^ bias;
          r[row][4 * v + 2] = w[u][row][v].z ^ bias;
          r[row][4 * v + 3] = w[u][row][v].w ^ bias;
        }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // mma rows g and g + 8 are columns n + 2j and n + 2j + 1
        uint32_t a[4];
        if constexpr (BF16W) {
          a[0] = bf16_lo(r[0][j], r[1][j]);
          a[1] = bf16_hi(r[0][j], r[1][j]);
          a[2] = bf16_lo(r[2][j], r[3][j]);
          a[3] = bf16_hi(r[2][j], r[3][j]);
        } else {
          const int wd = j / 2, by = 2 * (j % 2);
          a[0] = bf16_pair(r[0][wd], r[1][wd], by);
          a[1] = bf16_pair(r[0][wd], r[1][wd], by + 1);
          a[2] = bf16_pair(r[2][wd], r[3][wd], by);
          a[3] = bf16_pair(r[2][wd], r[3][wd], by + 1);
        }
#pragma unroll
        for (int i = 0; i < NT; ++i)
          mma_bf16(acc[i][j], a, b[u][i].x, b[u][i].y);
      }
    }
  }

  // acc[i][j][c]: token 2t + (c & 1) + 8i, column n + 2j + (c >> 1)
  const bool split = gridDim.y > 1;
  const int ksplit = gridDim.y;
  const int rank = blockIdx.y;                   // the cluster spans grid.y
#pragma unroll
  for (int i = 0; i < NT; ++i) {
#pragma unroll
    for (int e = 0; e < 32; ++e)
      red[warp * GV_SUMS + e * 32 + lane] = acc[i][e / 4][e % 4];
    __syncthreads();
    // this CTA's sum over its warps, into warp 0's slots (each slot is read
    // and written by one thread only)
#pragma unroll
    for (int p = 0; p < GV_SUMS / GV_THREADS; ++p) {
      const int idx = threadIdx.x + p * GV_THREADS;
      float sum = 0.f;
#pragma unroll
      for (int v = 0; v < GV_WARPS; ++v) sum += red[v * GV_SUMS + idx];
      red[idx] = sum;
    }
    if (split)
      cg::this_cluster().sync();
    else
      __syncthreads();
    // each CTA of the cluster adds up its share of the slots over the
    // cluster (slot e * 32 + lane: j = e / 4, c = e % 4, g = lane / 4,
    // t = lane % 4)
    const int per = (GV_SUMS + ksplit - 1) / ksplit;
    const int last = min(GV_SUMS, (rank + 1) * per);
    for (int idx = rank * per + threadIdx.x; idx < last; idx += GV_THREADS) {
      const int e = idx / 32, ln = idx % 32;
      const int m = 2 * (ln % 4) + (e & 1) + 8 * i;
      const int col = blockIdx.x * GV_BN + 16 * (ln / 4) + 2 * (e / 4) +
                      ((e % 4) >> 1);
      if (m >= M || col >= N) continue;
      float sum = red[idx];
      if (split) {
        sum = 0.f;
        for (int r = 0; r < ksplit; ++r)
          sum += cg::this_cluster().map_shared_rank(red, r)[idx];
      }
      out[m * ldo + col] = __float2bfloat16(
          BF16W ? sum : sum * __bfloat162float(s[col]));
    }
    // no CTA reuses or frees its slots while another may still read them
    if (split)
      cg::this_cluster().sync();
    else
      __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// Large M: TMA, an mbarrier ring, int8 widened once per CTA, wgmma
// ---------------------------------------------------------------------------

constexpr int MM_BM = 128;            // rows per CTA: two consumer warpgroups
constexpr int MM_BK = 64;             // k per stage: one 128-byte bf16 box
constexpr int MM_THREADS = 384;       // widening warpgroup + two consumers
constexpr int MM_WIDEN_THREADS = 128;
constexpr int MM_CONSUMER_WARPS = 8;
constexpr int MM_WIDEN_REGS = 56;
constexpr int MM_CONSUMER_REGS = 224;   // 128 * 56 + 256 * 224 = 384 * 168
constexpr int MM_BOX_BYTES = MM_BK * 128;   // one [64 k][64 n] bf16 box

// Shared memory per stage, from a 1024-byte aligned base (the 128-byte
// swizzle repeats every 1024 bytes): the x tile [128 rows][64 k] as TMA
// wrote it (128-byte swizzle), then the weight tile: TMA writes the raw
// int8 [64 k rows][BN bytes] into the first half of its slot, and the
// widening warps overwrite the slot with BN / 64 bf16 boxes of [64 k rows]
// [64 n columns] (128-byte swizzle, N-major); then the barriers.
template <int BN>
struct MmSmem {
  static constexpr int stages = BN == 128 ? 6 : 4;
  static constexpr uint32_t x = MM_BM * MM_BK * 2;
  static constexpr uint32_t w = MM_BK * BN * 2;
  static constexpr uint32_t q = MM_BK * BN;
  static constexpr uint32_t stage = x + w;
  static constexpr uint32_t bars = stages * stage;
  static constexpr uint32_t total = bars + 8 * 3 * stages + 1024;  // + align
};

// d (m64nN, fp32) += A B: A [64 x 16] K-major, B [16 x N] N-major
// (transposed), both 128-byte swizzled in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_ss_tb(float (&d)[N / 2], uint64_t da,
                                            uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss_tb<128>(float (&d)[64], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss_tb<256>(float (&d)[128], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss_tb<192>(float (&d)[96], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(1));
}

// bf16 pair {byte i, byte i + 1} of four biased int8 values
__device__ __forceinline__ uint32_t bf16_adjacent(uint32_t biased, int i) {
  return __byte_perm(__float_as_uint(widen_byte(biased, i)),
                     __float_as_uint(widen_byte(biased, i + 1)), 0x7632u);
}

// Widen one stage's int8 tile [64 k][BN n] in place: the raw bytes at sw
// become bf16 boxes at sw. 16 bytes of one k row per item: one 16-byte
// shared load, two 16-byte swizzled stores. Thread wt takes items wt + 128
// i, which share one 16-byte column j and lie RSTEP rows apart, so every
// address is a base plus a constant. Eight neighbouring threads take eight
// rows and eight different columns: neither their loads (rows BN bytes
// apart) nor their stores (chunk c ^ row % 8) meet in a bank. Every thread
// loads all of its items, the warpgroup meets at a named barrier, and only
// then are the raw bytes overwritten.
template <int BN>
__device__ __forceinline__ void widen_tile(uint32_t sw, int wt) {
  constexpr int NJ = BN / 16;                    // 16-byte columns per row
  constexpr int PER = MM_BK * NJ / MM_WIDEN_THREADS;
  constexpr int RSTEP = NJ == 8 ? 16 : 8;
  const int l8 = wt & 7, d = (wt >> 3) & 7, half = wt >> 6;
  const int j = (NJ == 8 ? 0 : 8 * half) + ((l8 + d) & 7);
  const int r0 = (NJ == 8 ? 8 * half : 0) + l8;  // r0 % 8 == l8
  // columns 16j .. 16j + 15 are bf16 chunks c and c + 1 of box j / 4
  const int c = (j % 4) * 2;
  const uint32_t src = sw + r0 * BN + 16 * j;
  const uint32_t dst = sw + (j / 4) * MM_BOX_BYTES + r0 * 128;
  const uint32_t lo = (c ^ l8) * 16, hi = ((c + 1) ^ l8) * 16;
  uint32_t v[PER][4];
#pragma unroll
  for (int i = 0; i < PER; ++i)
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v[i][0]), "=r"(v[i][1]), "=r"(v[i][2]), "=r"(v[i][3])
                 : "r"(src + i * RSTEP * BN)
                 : "memory");
  asm volatile("bar.sync 1, %0;\n" ::"n"(MM_WIDEN_THREADS) : "memory");
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    // int8 v as v + 128: the 2^23 trick in widen_byte takes unsigned bytes
    uint32_t b[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) b[e] = v[i][e] ^ 0x80808080u;
    const uint32_t row = dst + i * RSTEP * 128;
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(row + lo),
                 "r"(bf16_adjacent(b[0], 0)), "r"(bf16_adjacent(b[0], 2)),
                 "r"(bf16_adjacent(b[1], 0)), "r"(bf16_adjacent(b[1], 2))
                 : "memory");
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(row + hi),
                 "r"(bf16_adjacent(b[2], 0)), "r"(bf16_adjacent(b[2], 2)),
                 "r"(bf16_adjacent(b[3], 0)), "r"(bf16_adjacent(b[3], 2))
                 : "memory");
  }
}

// The K split's reduction, run by the 256 consumer threads (thread `tid`)
// of the CTA of rank `rank` among `nsplit`: every CTA of the cluster holds
// its consumers' fp32 sums in shared memory at red, sum i of consumer
// thread ct at red[i * 256 + ct]. This CTA adds up its share of the
// column pairs over the cluster's CTAs, scales and stores.
template <int BN>
__device__ __forceinline__ void split_k_reduce(
    float* red, const __nv_bfloat16* __restrict__ s,
    __nv_bfloat16* __restrict__ out, int M, int N, long long ldo, int m0,
    int n0, int rank, int nsplit, int tid) {
  constexpr int PAIRS = 256 * BN / 4;            // (sum pair, thread)
  const int per = (PAIRS + nsplit - 1) / nsplit;
  const int last = min(PAIRS, (rank + 1) * per);
  cg::cluster_group cluster = cg::this_cluster();
  for (int p = rank * per + tid; p < last; p += 256) {
    // sums 2 pi and 2 pi + 1 of consumer thread ct: acc[4 nb + 2 h + e]
    // is row g + 8 h, column 8 nb + 2 t + e of its warp's 16 x BN
    const int pi = p / 256, ct = p % 256;
    const int lane = ct % 32, nb = pi / 2, h = pi % 2;
    const int m = m0 + (ct / 128) * 64 + ((ct / 32) % 4) * 16 + lane / 4 +
                  8 * h;
    const int n = n0 + nb * 8 + 2 * (lane % 4);
    if (m >= M || n >= N) continue;
    float s0 = 0.f, s1 = 0.f;
    for (int rk = 0; rk < nsplit; ++rk) {
      const float* r = cluster.map_shared_rank(red, rk);
      s0 += r[2 * pi * 256 + ct];
      s1 += r[(2 * pi + 1) * 256 + ct];
    }
    *reinterpret_cast<__nv_bfloat162*>(out + m * ldo + n) =
        __floats2bfloat162_rn(s0 * __bfloat162float(s[n]),
                              s1 * __bfloat162float(s[n + 1]));
  }
}

// One CTA computes rows m0 .. m0 + 127 (those below M) and columns n0 ..
// n0 + BN - 1 over the k-tiles [blockIdx.z * ktile_chunk, ...): with a K
// split the nsplit CTAs of one cluster (grid z) add their sums through
// distributed shared memory.
template <int BN>
__global__ void __launch_bounds__(MM_THREADS, 1) w8a16_wgmma(
    __grid_constant__ const CUtensorMap tx,
    __grid_constant__ const CUtensorMap tq,
    const __nv_bfloat16* __restrict__ s, __nv_bfloat16* __restrict__ out,
    int M, int N, int K, long long ldo, int ktile_chunk, int nsplit) {
  using L = MmSmem<BN>;
  constexpr int S = L::stages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  // barriers, 8 bytes each, one per stage: TMA bytes of x and q landed;
  // the widened tile written (one arrival per widening warp); the
  // consumers done with the stage (one per consumer warp)
  const uint32_t full = base + L::bars;
  const uint32_t wide = full + 8 * S;
  const uint32_t empty = wide + 8 * S;
  auto stage = [&](int kt) { return base + (kt % S) * L::stage; };
  auto bar = [](uint32_t b, int kt) { return b + 8 * (kt % S); };
  auto phase = [](int kt) { return uint32_t((kt / S) & 1); };
  // this CTA's k-tiles: kt0 + 0 .. kt0 + ktiles - 1 (at least one)
  const int kt0 = blockIdx.z * ktile_chunk;
  const int ktiles = min((K + MM_BK - 1) / MM_BK - kt0, ktile_chunk);

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(wide + 8 * i, MM_WIDEN_THREADS / 32);
      mbar_init(empty + 8 * i, MM_CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int m0 = blockIdx.x * MM_BM;       // x fastest: CTAs that run
  const int m_end = M;                     // together share weight columns
  const int n0 = blockIdx.y * BN;
  const uint32_t stage_bytes = L::x + L::q;
  auto issue = [&](int t) {
    mbar_expect_tx(bar(full, t), stage_bytes);
    tma_load_2d(stage(t), &tx, bar(full, t), (kt0 + t) * MM_BK, m0);
    tma_load_3d(stage(t) + L::x, &tq, bar(full, t), n0, (kt0 + t) * MM_BK,
                0);
  };

  if (threadIdx.x < 128) {
    // ---- widening warpgroup ----------------------------------------------
    setmaxnreg_dec<MM_WIDEN_REGS>();
    for (int kt = 0; kt < ktiles; ++kt) {
      const uint32_t st = stage(kt);
      mbar_wait_or_trap(bar(full, kt), phase(kt));
      widen_tile<BN>(st + L::x, threadIdx.x);
      // the generic-proxy stores become visible to wgmma (the async
      // proxy) before the consumers see the barrier
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if (threadIdx.x % 32 == 0) mbar_arrive(bar(wide, kt));
    }
    // the last stages' release: a consumer stuck on a barrier traps here
    // (or at a wait above) instead of hanging the card
    if (threadIdx.x == 0)
      for (int kt = max(0, ktiles - S); kt < ktiles; ++kt)
        mbar_wait_or_trap(bar(empty, kt), phase(kt));
    // the consumers' two cluster barriers around the K split's reduction
    if (nsplit > 1) {
      cg::this_cluster().sync();
      cg::this_cluster().sync();
    }
  } else {
    // ---- consumer warpgroups: 64 rows each -------------------------------
    setmaxnreg_inc<MM_CONSUMER_REGS>();
    const int ct = threadIdx.x - 128;
    const int cw = ct / 128;                 // consumer warpgroup
    const int warp = (ct / 32) % 4;          // its warp: 16 rows
    const int lane = ct % 32;
    // a warpgroup whose rows all lie past M runs no products, but keeps
    // releasing the stages
    const bool active = m0 + cw * 64 < m_end;
    // one thread of the first consumer issues the TMA loads
    const bool loader = ct == 0;
    if (loader)
      for (int t = 0; t < min(S, ktiles); ++t) {
        mbar_wait(bar(empty, t), phase(t) ^ 1);
        issue(t);
      }
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < ktiles; ++kt) {
      const uint32_t st = stage(kt);
      mbar_wait(bar(full, kt), phase(kt));
      mbar_wait(bar(wide, kt), phase(kt));
      if (active) {
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < MM_BK / 16; ++kk)
          wgmma_ss_tb<BN>(
              acc, smem_desc(st + cw * 64 * 128 + kk * 32, 16, 1024),
              smem_desc(st + L::x + kk * 16 * 128, MM_BOX_BYTES, 1024));
        wgmma_commit();
        // tile kt - 1's products are done: release its stage
        wgmma_wait<1>();
        fence_regs(acc);
      }
      if (kt > 0 && lane == 0) mbar_arrive(bar(empty, kt - 1));
      // refill tile kt - 1's stage with tile kt - 1 + S
      if (loader && kt > 0 && kt - 1 + S < ktiles) {
        mbar_wait(bar(empty, kt - 1 + S), phase(kt - 1 + S) ^ 1);
        issue(kt - 1 + S);
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(bar(empty, ktiles - 1));

    if (nsplit > 1) {
      // the sums into the ring, once both consumers' products are done
      // with it; the cluster adds them up, and no CTA leaves while another
      // still reads its shared memory
      asm volatile("bar.sync 2, 256;\n" ::: "memory");
      float* red =
          reinterpret_cast<float*>(smem_raw + (base - smem_u32(smem_raw)));
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) red[i * 256 + ct] = acc[i];
      cg::this_cluster().sync();
      split_k_reduce<BN>(red, s, out, m_end, N, ldo, m0, n0,
                         cg::this_cluster().block_rank(), nsplit, ct);
      cg::this_cluster().sync();
    } else if (active) {
      // epilogue: scale in fp32, round once to bf16, two columns per
      // store; acc[4 nb + e] is row g + 8 (e / 2), column 8 nb + 2t + e % 2
      const int g = lane / 4, t = lane % 4;
      const int row = m0 + cw * 64 + warp * 16 + g;
#pragma unroll
      for (int nb = 0; nb < BN / 8; ++nb) {
        const int n = n0 + nb * 8 + 2 * t;
        if (n >= N) continue;
        const float s0 = __bfloat162float(s[n]);
        const float s1 = __bfloat162float(s[n + 1]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = row + 8 * h;
          if (m < m_end)
            *reinterpret_cast<__nv_bfloat162*>(out + m * ldo + n) =
                __floats2bfloat162_rn(acc[4 * nb + 2 * h] * s0,
                                      acc[4 * nb + 2 * h + 1] * s1);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Grouped, large M: one persistent CTA per SM walking (expert, rows,
// columns) units
// ---------------------------------------------------------------------------

constexpr int GR_TABLE_EXPERTS = 1024;   // experts whose bounds a CTA copies
constexpr uint32_t GR_SMEM_BYTES = 232448;   // a CTA's most shared memory
constexpr int GR_MAX_STAGES = 8;

// Shared memory of one grouped CTA, from a 1024-byte aligned base: stages
// of the x tile [BM rows][64 k] (128-byte swizzle) and the weight tile (as
// MmSmem's: bf16 boxes of [64 k][64 n], int8 first written raw into the
// slot's first half), as many as fit beside the barriers (full, wide and
// empty per stage, two turn barriers) and the copy of offsets.
template <int BM, int BN>
struct GrSmem {
  static constexpr uint32_t x = BM * MM_BK * 2;
  static constexpr uint32_t w = MM_BK * BN * 2;
  static constexpr uint32_t stage = x + w;
  static constexpr uint32_t table_bytes = 4 * (GR_TABLE_EXPERTS + 1);
  static constexpr int fit =
      int((GR_SMEM_BYTES - 1024 - table_bytes - 16) / (stage + 24));
  static constexpr int stages = fit < GR_MAX_STAGES ? fit : GR_MAX_STAGES;
  static constexpr uint32_t bars = stages * stage;
  static constexpr uint32_t table = bars + 8 * (3 * stages + 2);
  static constexpr uint32_t total = table + table_bytes + 1024;  // + align
  static_assert(stages >= 4 && total <= GR_SMEM_BYTES, "grouped smem");
};

// A walk over the units of a grouped call in unit order. Expert e's rows
// [lo, hi) = [off[e], off[e + 1]) make R = ceil((hi - lo) / BM) row units
// in each of T column strips: units [ub, ue), strip by strip, so the R
// units of one strip run together on neighbouring CTAs and share its
// weights in L2. Each role of a CTA keeps its own walk and asks for its
// units in rising order, so the walk only steps forward through the
// experts.
template <int BM, int BN>
struct Walk {
  const int* off;
  int T, e, lo, hi, ub, ue;

  __device__ __forceinline__ static int row_units(int rows) {
    return (max(rows, 0) + BM - 1) / BM;
  }
  __device__ __forceinline__ Walk(const int* o, int t)
      : off(o), T(t), e(0), lo(o[0]), hi(o[1]), ub(0) {
    ue = row_units(hi - lo) * T;
  }
  // unit u (below the total): the expert is e, its first row m0, its first
  // column n0
  __device__ __forceinline__ void at(int u, int& m0, int& n0) {
    while (u >= ue) {
      ++e;
      lo = hi;
      hi = off[e + 1];
      ub = ue;
      ue += row_units(hi - lo) * T;
    }
    const int local = u - ub, R = row_units(hi - lo);
    const int c = local / R;
    m0 = lo + (local - c * R) * BM;
    n0 = c * BN;
  }
};

// The grouped product over the sorted pairs, out[r] = bf16((x[r] @ q[e])
// * s[e]) for offsets[e] <= r < offsets[e + 1]: gridDim.x CTAs (at most
// one per SM) take units b, b + gridDim.x, ... of the walk above. One ring
// of S stages runs across a CTA's units: stage t is k-tile t % ktiles of
// its (t / ktiles)-th unit, and the barriers' phases carry on from unit to
// unit.
//   BM 128: both consumer warpgroups take each unit, 64 rows each; one
//     whose rows all lie past the segment skips its products.
//   BM 64 (ping-pong): consumer c takes the CTA's units c, c + 2, ...; a
//     turn barrier passes the products from one to the other once a unit's
//     last stage has arrived, so one's epilogue overlaps the other's
//     products (and no consumer waits on a stage two rounds ahead).
// The first warpgroup feeds the ring: bf16, its first thread issues the
// TMA loads; int8, it widens every stage (widen_tile) and the first
// consumer's thread 0 issues the loads, refilling a stage once both
// consumers have released it. The first warpgroup's waits trap after
// WAIT_LIMIT_NS; the consumers' waits spin.
template <int BM, int BN, bool BF16W>
__global__ void __launch_bounds__(MM_THREADS, 1) grouped_wgmma(
    __grid_constant__ const CUtensorMap tx,
    __grid_constant__ const CUtensorMap tq,
    const __nv_bfloat16* __restrict__ s, __nv_bfloat16* __restrict__ out,
    const int* __restrict__ offsets, int E, int N, int K) {
  static_assert(BM == 64 || BM == 128, "unit rows");
  // int8: a widened tile feeds both consumers (128 rows) and widen_tile
  // maps 128 and 256 columns
  static_assert(BF16W || (BM == 128 && (BN == 128 || BN == 256)),
                "int8 units");
  using L = GrSmem<BM, BN>;
  constexpr int S = L::stages;
  constexpr bool PP = BM == 64;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ int units_total;
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = base + L::bars;
  const uint32_t wide = full + 8 * S;
  const uint32_t empty = wide + 8 * S;
  const uint32_t turn = empty + 8 * S;
  int* const table = reinterpret_cast<int*>(
      smem_raw + (base - smem_u32(smem_raw)) + L::table);
  auto stage = [&](int t) { return base + (t % S) * L::stage; };
  auto bar = [](uint32_t b, int t) { return b + 8 * (t % S); };
  auto phase = [](int t) { return uint32_t((t / S) & 1); };
  const int T = (N + BN - 1) / BN;
  const int ktiles = (K + MM_BK - 1) / MM_BK;
  // the segment bounds: a copy in shared memory up to GR_TABLE_EXPERTS
  // experts, offsets itself above
  const bool in_smem = E <= GR_TABLE_EXPERTS;
  const int* const off = in_smem ? table : offsets;

  if (in_smem)
    for (int i = threadIdx.x; i <= E; i += MM_THREADS) table[i] = offsets[i];
  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(wide + 8 * i, MM_WIDEN_THREADS / 32);
      mbar_init(empty + 8 * i, PP ? 4 : MM_CONSUMER_WARPS);
    }
    mbar_init(turn, 4);
    mbar_init(turn + 8, 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    // the units of every expert, summed over the warp
    int sum = 0;
    for (int e = threadIdx.x; e < E; e += 32)
      sum += Walk<BM, BN>::row_units(off[e + 1] - off[e]);
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, d);
    if (threadIdx.x == 0) units_total = sum * T;
  }
  __syncthreads();
  const int G = gridDim.x, b = blockIdx.x, U = units_total;
  const int mine = U > b ? (U - b - 1) / G + 1 : 0;   // this CTA's units
  if (mine == 0) return;
  const int stages = mine * ktiles;
  auto issue = [&](int t, int kt, int ex, int m0, int n0) {
    // bf16: the [64 k][64 n] boxes that hold columns below N
    const int qboxes = BF16W ? min(BN / 64, (N - n0 + 63) / 64) : 1;
    mbar_expect_tx(bar(full, t),
                   L::x + (BF16W ? qboxes * MM_BOX_BYTES : MM_BK * BN));
    tma_load_2d(stage(t), &tx, bar(full, t), kt * MM_BK, m0);
    for (int j = 0; j < qboxes; ++j)
      tma_load_3d(stage(t) + L::x + j * MM_BOX_BYTES, &tq, bar(full, t),
                  n0 + 64 * j, kt * MM_BK, ex);
  };

  if (threadIdx.x < 128) {
    // ---- first warpgroup: bf16, its first thread loads; int8 widens -----
    setmaxnreg_dec<MM_WIDEN_REGS>();
    if constexpr (BF16W) {
      if (threadIdx.x == 0) {
        Walk<BM, BN> walk(off, T);
        for (int i = 0, t = 0; i < mine; ++i) {
          int m0, n0;
          walk.at(b + i * G, m0, n0);
          // stage t once the consumers released stage t - S
          for (int kt = 0; kt < ktiles; ++kt, ++t) {
            mbar_wait_or_trap(bar(empty, t), phase(t) ^ 1);
            issue(t, kt, walk.e, m0, n0);
          }
        }
      }
    } else {
      for (int t = 0; t < stages; ++t) {
        mbar_wait_or_trap(bar(full, t), phase(t));
        widen_tile<BN>(stage(t) + L::x, threadIdx.x);
        // the generic-proxy stores become visible to wgmma (the async
        // proxy) before the consumers see the barrier
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncwarp();
        if (threadIdx.x % 32 == 0) mbar_arrive(bar(wide, t));
      }
    }
    // the last stages' release: a consumer stuck on a barrier traps here
    // (or at a wait above) instead of hanging the card
    if (threadIdx.x == 0)
      for (int t = max(0, stages - S); t < stages; ++t)
        mbar_wait_or_trap(bar(empty, t), phase(t));
  } else {
    // ---- consumer warpgroups ---------------------------------------------
    setmaxnreg_inc<MM_CONSUMER_REGS>();
    const int ct = threadIdx.x - 128;
    const int cw = ct / 128;                 // consumer warpgroup
    const int warp = (ct / 32) % 4;          // its warp: 16 rows
    const int lane = ct % 32;
    // x rows of this warpgroup in a stage's tile
    const uint32_t a_off = PP ? 0u : uint32_t(cw * 64 * 128);
    Walk<BM, BN> walk(off, T);
    // int8: one thread of the first consumer issues the TMA loads, its own
    // walk S stages ahead of the products; each stage it refills is one
    // both consumers have released
    const bool loader = !BF16W && ct == 0;
    Walk<BM, BN> ahead(off, T);
    int lm0 = 0, ln0 = 0;
    auto load = [&](int t) {
      const int kt = t % ktiles;
      if (kt == 0) ahead.at(b + (t / ktiles) * G, lm0, ln0);
      issue(t, kt, ahead.e, lm0, ln0);
    };
    auto release = [&](int t) {
      if (lane == 0) mbar_arrive(bar(empty, t));
      if (loader && t + S < stages) {
        mbar_wait(bar(empty, t + S), phase(t + S) ^ 1);
        load(t + S);
      }
    };
    if (loader)
      for (int t = 0; t < min(S, stages); ++t) load(t);
    float acc[BN / 2];
    for (int i = PP ? cw : 0, j = 0; i < mine; i += PP ? 2 : 1, ++j) {
      int m0, n0;
      walk.at(b + i * G, m0, n0);
      const int row0 = m0 + (PP ? 0 : cw * 64);
      const int m_end = walk.hi;
      // a warpgroup whose rows all lie past the segment runs no products,
      // but keeps releasing the stages
      const bool active = row0 < m_end;
      // ping-pong: the other consumer's previous unit has all its stages
      if (PP && (cw == 1 || j > 0))
        mbar_wait(turn + 8 * cw, uint32_t((cw == 0 ? j - 1 : j) & 1));
#pragma unroll
      for (int a = 0; a < BN / 2; ++a) acc[a] = 0.f;
      int t = i * ktiles;
      for (int kt = 0; kt < ktiles; ++kt, ++t) {
        const uint32_t st = stage(t);
        mbar_wait(bar(full, t), phase(t));
        if (!BF16W) mbar_wait(bar(wide, t), phase(t));
        if (active) {
          fence_regs(acc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < MM_BK / 16; ++kk)
            wgmma_ss_tb<BN>(
                acc, smem_desc(st + a_off + kk * 32, 16, 1024),
                smem_desc(st + L::x + kk * 16 * 128, MM_BOX_BYTES, 1024));
          wgmma_commit();
          // stage t - 1's products are done: release it
          wgmma_wait<1>();
          fence_regs(acc);
        }
        if (kt > 0) release(t - 1);
      }
      if (PP && lane == 0) mbar_arrive(turn + 8 * (1 - cw));
      wgmma_wait<0>();
      fence_regs(acc);
      release(t - 1);
      if (active) {
        // epilogue: scale in fp32, round once to bf16, two columns per
        // store; acc[4 nb + e] is row g + 8 (e / 2), column 8 nb + 2 tq +
        // e % 2
        const int g = lane / 4, tq = lane % 4;
        const int row = row0 + warp * 16 + g;
        const __nv_bfloat16* se = s + (BF16W ? 0 : (long long)walk.e * N);
#pragma unroll
        for (int nb = 0; nb < BN / 8; ++nb) {
          const int n = n0 + nb * 8 + 2 * tq;
          if (n >= N) continue;
          const float s0 = BF16W ? 1.f : __bfloat162float(se[n]);
          const float s1 = BF16W ? 1.f : __bfloat162float(se[n + 1]);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = row + 8 * h;
            if (m < m_end)
              *reinterpret_cast<__nv_bfloat162*>(out + (long long)m * N +
                                                 n) =
                  __floats2bfloat162_rn(acc[4 * nb + 2 * h] * s0,
                                        acc[4 * nb + 2 * h + 1] * s1);
          }
        }
      }
    }
  }
}

template <int NT, bool BF16W>
cudaError_t launch_gemv(const __nv_bfloat16* x, const void* q,
                        const __nv_bfloat16* s, __nv_bfloat16* out,
                        const int* offsets, int E, int M, int N, int K,
                        long long ldx, long long ldq, long long qb,
                        long long sb, long long ldo, int kchunk, int ksplit,
                        cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + GV_BN - 1) / GV_BN, ksplit, E);
  cfg.blockDim = dim3(GV_THREADS, 1, 1);
  cfg.stream = st;
  // the CTAs that split one column slice's K form one cluster
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = ksplit;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, w8a16_gemv<NT, BF16W>, x, q, s, out,
                            offsets, M, N, K, ldx, ldq, ldo, kchunk, qb, sb);
}

// x [M, K] bf16 (rows ldx elements apart) as a 2-D map in boxes of [bm
// rows][64 k], 128-byte swizzle; q [E, K, N] (rows ldq elements apart,
// experts qb apart) as a 3-D map {N, K, E}: int8 in unswizzled boxes of [64
// k rows][bn bytes], bf16 in boxes of [64 k][64 n] with the 128-byte
// swizzle. Past M, N or K a box reads zeros.
CUresult make_maps(EncodeTiled encode, CUtensorMap* tx, CUtensorMap* tq,
                   const void* x, const void* q, bool bf16w, int E, int M,
                   int N, int K, long long ldx, long long ldq, long long qb,
                   int bm, int bn) {
  const cuuint32_t elem[3] = {1, 1, 1};
  const cuuint64_t xdims[2] = {cuuint64_t(K), cuuint64_t(M)};
  const cuuint64_t xstride[1] = {cuuint64_t(ldx) * 2};
  const cuuint32_t xbox[2] = {cuuint32_t(MM_BK), cuuint32_t(bm)};
  CUresult r = encode(tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                      const_cast<void*>(x), xdims, xstride, xbox, elem,
                      CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return r;
  const cuuint64_t wb = bf16w ? 2 : 1;
  const cuuint64_t qdims[3] = {cuuint64_t(N), cuuint64_t(K), cuuint64_t(E)};
  const cuuint64_t qstride[2] = {cuuint64_t(ldq) * wb, cuuint64_t(qb) * wb};
  const cuuint32_t qbox[3] = {bf16w ? 64u : cuuint32_t(bn),
                              cuuint32_t(MM_BK), 1};
  return encode(tq,
                bf16w ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                      : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                3, const_cast<void*>(q), qdims, qstride, qbox, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                bf16w ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// The dynamic shared memory of `kernel`, set once per device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool (&done)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

template <int BN>
cudaError_t launch_wgmma(const CUtensorMap& tx, const CUtensorMap& tq,
                         const __nv_bfloat16* s, __nv_bfloat16* out, int M,
                         int N, int K, long long ldo, int kchunk, int ksplit,
                         cudaStream_t st) {
  static bool smem_set[64] = {};
  cudaError_t err =
      allow_smem(w8a16_wgmma<BN>, int(MmSmem<BN>::total), smem_set);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((M + MM_BM - 1) / MM_BM, (N + BN - 1) / BN, ksplit);
  cfg.blockDim = dim3(MM_THREADS, 1, 1);
  cfg.dynamicSmemBytes = MmSmem<BN>::total;
  cfg.stream = st;
  // the CTAs that split one output tile's K form one cluster (along z)
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = ksplit;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, w8a16_wgmma<BN>, tx, tq, s, out, M, N, K,
                           ldo, kchunk / MM_BK, ksplit);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int BM, int BN, bool BF16W>
cudaError_t launch_grouped(const CUtensorMap& tx, const CUtensorMap& tq,
                           const __nv_bfloat16* s, __nv_bfloat16* out,
                           const int* offsets, int E, int N, int K,
                           int grid, cudaStream_t st) {
  static bool smem_set[64] = {};
  constexpr int bytes = int(GrSmem<BM, BN>::total);
  cudaError_t err = allow_smem(grouped_wgmma<BM, BN, BF16W>, bytes, smem_set);
  if (err != cudaSuccess) return err;
  grouped_wgmma<BM, BN, BF16W><<<grid, MM_THREADS, bytes, st>>>(
      tx, tq, s, out, offsets, E, N, K);
  return cudaGetLastError();
}

template <int BM, bool BF16W>
cudaError_t launch_grouped_bn(int bn, const CUtensorMap& tx,
                              const CUtensorMap& tq, const __nv_bfloat16* s,
                              __nv_bfloat16* out, const int* offsets, int E,
                              int N, int K, int grid, cudaStream_t st) {
  if (bn == 128)
    return launch_grouped<BM, 128, BF16W>(tx, tq, s, out, offsets, E, N, K,
                                          grid, st);
  if (bn == 256)
    return launch_grouped<BM, 256, BF16W>(tx, tq, s, out, offsets, E, N, K,
                                          grid, st);
  if constexpr (BF16W)
    if (bn == 192)
      return launch_grouped<BM, 192, true>(tx, tq, s, out, offsets, E, N, K,
                                          grid, st);
  return cudaErrorInvalidValue;
}

// The GEMV of every entry (max_rows <= GEMV_MAX_M rows per expert): x [M,
// K] (rows ldx apart) against expert e's q + e * qb (rows ldq apart; s + e
// * sb its scales for int8) for the rows of its segment (offsets; all M
// rows of expert 0 without), out rows ldo apart; strides in elements.
template <bool BF16W>
int run_gemv(const void* x, const void* q, const void* s, const int* offsets,
             void* out, int E, int M, int N, int K, long long ldx,
             long long ldq, long long qb, long long sb, long long ldo,
             int max_rows, int kchunk, cudaStream_t st) {
  if (kchunk <= 0 || kchunk % GV_KSTEP) return int(cudaErrorInvalidValue);
  const int ksplit = (K + kchunk - 1) / kchunk;
  if (ksplit > MAX_KSPLIT) return int(cudaErrorInvalidValue);
  auto xb16 = static_cast<const __nv_bfloat16*>(x);
  auto sb16 = static_cast<const __nv_bfloat16*>(s);
  auto ob16 = static_cast<__nv_bfloat16*>(out);
  return int(max_rows <= 8
                 ? launch_gemv<1, BF16W>(xb16, q, sb16, ob16, offsets, E, M,
                                         N, K, ldx, ldq, qb, sb, ldo, kchunk,
                                         ksplit, st)
                 : launch_gemv<2, BF16W>(xb16, q, sb16, ob16, offsets, E, M,
                                         N, K, ldx, ldq, qb, sb, ldo, kchunk,
                                         ksplit, st));
}

bool shape_ok(int N, int K) { return K > 0 && K % 8 == 0 && N % 16 == 0; }

// The 2-D product: M <= GEMV_MAX_M the GEMV, above the wgmma kernel.
int run_2d(const void* x, const void* q, const void* s, void* out, int M,
           int N, int K, long long ldx, long long ldq, long long ldo, int bn,
           int kchunk, cudaStream_t st) {
  if (M <= 0 || N <= 0) return int(cudaSuccess);
  if (!shape_ok(N, K)) return int(cudaErrorInvalidValue);
  if (M <= GEMV_MAX_M)
    return run_gemv<false>(x, q, s, nullptr, out, 1, M, N, K, ldx, ldq,
                           (long long)K * ldq, 0, ldo, M, kchunk, st);
  if (kchunk <= 0 || kchunk % MM_BK) return int(cudaErrorInvalidValue);
  const int ksplit = (K + kchunk - 1) / kchunk;
  if (ksplit > MAX_KSPLIT || (bn != 128 && bn != 256))
    return int(cudaErrorInvalidValue);
  EncodeTiled encode = encode_fn();
  if (encode == nullptr) return -1;
  CUtensorMap tx, tq;
  const CUresult r = make_maps(encode, &tx, &tq, x, q, false, 1, M, N, K,
                               ldx, ldq, (long long)K * ldq, MM_BM, bn);
  if (r != CUDA_SUCCESS) return -(1000 + int(r));
  auto sb16 = static_cast<const __nv_bfloat16*>(s);
  auto ob16 = static_cast<__nv_bfloat16*>(out);
  return int(bn == 128 ? launch_wgmma<128>(tx, tq, sb16, ob16, M, N, K, ldo,
                                           kchunk, ksplit, st)
                       : launch_wgmma<256>(tx, tq, sb16, ob16, M, N, K, ldo,
                                           kchunk, ksplit, st));
}

// A grouped product: x [P, K] and out [P, N] contiguous, q [E, K, N] (s [E,
// N] for int8) contiguous, offsets [E + 1] on the card. max_rows <=
// GEMV_MAX_M the GEMV (kchunk its K slice), above the persistent kernel
// (bm, bn, grid: the host's plan).
template <bool BF16W>
int run_grouped(const void* x, const void* q, const void* s,
                const void* offsets, void* out, int E, int P, int N, int K,
                int max_rows, int kchunk, int bm, int bn, int grid,
                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (offsets == nullptr) return int(cudaErrorInvalidValue);
  if (P <= 0 || N <= 0 || E <= 0) return int(cudaSuccess);
  if (!shape_ok(N, K) || max_rows <= 0 || E > 65535)
    return int(cudaErrorInvalidValue);
  auto off = static_cast<const int*>(offsets);
  if (max_rows <= GEMV_MAX_M)
    return run_gemv<BF16W>(x, q, s, off, out, E, P, N, K, K, N,
                           (long long)K * N, N, N, max_rows, kchunk, st);
  if (grid <= 0) return int(cudaErrorInvalidValue);
  EncodeTiled encode = encode_fn();
  if (encode == nullptr) return -1;
  CUtensorMap tx, tq;
  const CUresult r = make_maps(encode, &tx, &tq, x, q, BF16W, E, P, N, K, K,
                               N, (long long)K * N, bm, bn);
  if (r != CUDA_SUCCESS) return -(1000 + int(r));
  auto sb16 = static_cast<const __nv_bfloat16*>(s);
  auto ob16 = static_cast<__nv_bfloat16*>(out);
  // 64-row units: bf16 only
  if constexpr (BF16W)
    if (bm == 64)
      return int(launch_grouped_bn<64, true>(bn, tx, tq, sb16, ob16, off, E,
                                             N, K, grid, st));
  if (bm != 128) return int(cudaErrorInvalidValue);
  return int(launch_grouped_bn<128, BF16W>(bn, tx, tq, sb16, ob16, off, E, N,
                                           K, grid, st));
}

}  // namespace

// Largest M (rows per expert) the GEMV path takes; above it, the wgmma path.
extern "C" int w8a16_gemv_max_m() { return GEMV_MAX_M; }

// Rows of one 2-D wgmma-path CTA.
extern "C" int w8a16_wgmma_tile_m() { return MM_BM; }

// Dynamic shared memory of one 2-D wgmma-path CTA of width bn (0: no such).
extern "C" int w8a16_wgmma_smem_bytes(int bn) {
  if (bn == 128) return int(MmSmem<128>::total);
  if (bn == 256) return int(MmSmem<256>::total);
  return 0;
}

// Ring stages of one grouped CTA of bm x bn units (0: no such).
extern "C" int w8a16_grouped_stages(int bm, int bn) {
  if (bm == 64 && bn == 128) return GrSmem<64, 128>::stages;
  if (bm == 64 && bn == 192) return GrSmem<64, 192>::stages;
  if (bm == 64 && bn == 256) return GrSmem<64, 256>::stages;
  if (bm == 128 && bn == 128) return GrSmem<128, 128>::stages;
  if (bm == 128 && bn == 192) return GrSmem<128, 192>::stages;
  if (bm == 128 && bn == 256) return GrSmem<128, 256>::stages;
  return 0;
}

// Most experts whose segment bounds a grouped CTA copies into shared
// memory; above, its walk reads offsets in device memory.
extern "C" int w8a16_grouped_table_experts() { return GR_TABLE_EXPERTS; }

// int8 GEMV CTAs one SM holds at once for this M (0 if the query fails).
extern "C" int w8a16_gemv_ctas_per_sm(int M) {
  int n = 0;
  const cudaError_t err =
      M <= 8 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   &n, w8a16_gemv<1, false>, GV_THREADS, 0)
             : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   &n, w8a16_gemv<2, false>, GV_THREADS, 0);
  return err == cudaSuccess ? n : 0;
}

// Most CTAs one output tile's K may be split over (one cluster).
extern "C" int w8a16_max_ksplit() { return MAX_KSPLIT; }

// Most experts one grouped call may take (the GEMV grid's z extent).
extern "C" int w8a16_max_experts() { return 65535; }

// Every entry returns 0 when launched, a cudaError_t (> 0) when the launch
// failed, -1 when the driver has no cuTensorMapEncodeTiled and -(1000 +
// CUresult) when a tensor map was refused. ``kchunk`` is the GEMV's K
// slice (a multiple of 16) and the 2-D wgmma path's (a multiple of 64),
// with ceil(K / kchunk) at most w8a16_max_ksplit().

// The 2-D product: x [M, K] (rows ldx apart), q [K, N] int8 (rows ldq
// bytes apart), s [N], out [M, N] (rows ldo apart); ``bn`` the wgmma
// path's tile width, 128 or 256.
extern "C" int w8a16_gemm_bf16(const void* x, const void* q, const void* s,
                               void* out, int M, int N, int K, long long ldx,
                               long long ldq, long long ldo, int bn,
                               int kchunk, void* stream) {
  return run_2d(x, q, s, out, M, N, K, ldx, ldq, ldo, bn, kchunk,
                static_cast<cudaStream_t>(stream));
}

// The grouped int8 product: x [P, K] and out [P, N] contiguous, the rows
// sorted by expert and bounded by offsets [E + 1] (int32, on the card), q
// [E, K, N] int8 and s [E, N] contiguous; no segment holds more than
// max_rows rows. Above GEMV_MAX_M rows the persistent kernel runs the
// host's plan: units of bm (128) rows by bn (128 or 256) columns, walked
// by ``grid`` CTAs.
extern "C" int w8a16_grouped_bf16(const void* x, const void* q,
                                  const void* s, const void* offsets,
                                  void* out, int E, int P, int N, int K,
                                  int max_rows, int kchunk, int bm, int bn,
                                  int grid, void* stream) {
  return run_grouped<false>(x, q, s, offsets, out, E, P, N, K, max_rows,
                            kchunk, bm, bn, grid, stream);
}

// The grouped bf16 product: as w8a16_grouped_bf16 with w [E, K, N] bf16,
// no scales, bm 64 or 128 and bn 128, 192 or 256.
extern "C" int bf16_grouped_bf16(const void* x, const void* w,
                                 const void* offsets, void* out, int E,
                                 int P, int N, int K, int max_rows,
                                 int kchunk, int bm, int bn, int grid,
                                 void* stream) {
  return run_grouped<true>(x, w, nullptr, offsets, out, E, P, N, K, max_rows,
                           kchunk, bm, bn, grid, stream);
}
