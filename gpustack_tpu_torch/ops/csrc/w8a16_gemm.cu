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
// Batched over experts (w8a16_bmm_bf16): out[e] = bf16((x_e @ q[e]) * s[e])
// for e < E, with q int8 [E, K, N], s bf16 [E, N], out [E, M, N], and x_e
// read through a batch stride: 0 for the MoE gate and up products (every
// expert reads the same token rows in place, never a copy of x), the
// expert's column block of h [tokens, E, Fm] for the down product (rows
// E*Fm apart, experts Fm apart). This is the dense-dispatch expert product
// of the JAX _moe_mlp's int8 branch (gpustack_tpu/models/transformer.py:
// 487-502, _mm over the expert axis), again an XLA fusion there. Both
// paths take the expert axis as one more grid axis: the GEMV's z, and the
// wgmma path's z beside the K split's cluster (z = expert * ksplit + rank,
// a cluster of ksplit CTAs along z). The tensor maps are 3-D: q as {N, K,
// E}, x as {K, E, M} or {K, M, E}, whichever keeps the strides growing,
// with an extent of 1 on the expert axis for batch stride 0 (a stride-0
// map is refused). The 2-D entry (w8a16_gemm_bf16) is the case E = 1.
//
// Requirements the wrapper checks: K % 8 == 0, N % 16 == 0, x rows, x
// batch strides and q rows 16-byte aligned (TMA's global-stride rule too),
// out rows 4-byte aligned.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// NT B tiles of 8 tokens; loads for U k steps in flight per warp
template <int NT>
__global__ void __launch_bounds__(GV_THREADS, 2) w8a16_gemv(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
    const __nv_bfloat16* __restrict__ s, __nv_bfloat16* __restrict__ out,
    int M, int N, int K, long long ldx, long long ldq, long long ldo,
    int kchunk, long long xb, long long qb, long long sb, long long ob) {
  constexpr int U = NT == 1 ? 2 : 1;
  __shared__ __align__(16) float red[GV_WARPS * GV_SUMS];
  // this CTA's expert (grid z)
  x += blockIdx.z * xb;
  q += blockIdx.z * qb;
  s += blockIdx.z * sb;
  out += blockIdx.z * ob;

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
    uint4 w[U][4];
    uint2 b[U][NT];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      // rows k..k+3 lie all inside [k_begin, k_end) or all outside it:
      // k_end is a multiple of 8
      const int k = k_begin + (st + u * GV_WARPS) * GV_KSTEP + 4 * t;
      const bool k_ok = k < k_end;
#pragma unroll
      for (int r = 0; r < 4; ++r)
        w[u][r] = k_ok && n_ok
                      ? __ldg(reinterpret_cast<const uint4*>(
                            q + (long long)(k + r) * ldq + n))
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
      uint32_t r0[4], r1[4], r2[4], r3[4];
      const uint32_t bias = 0x80808080u;
      r0[0] = w[u][0].x ^ bias; r0[1] = w[u][0].y ^ bias;
      r0[2] = w[u][0].z ^ bias; r0[3] = w[u][0].w ^ bias;
      r1[0] = w[u][1].x ^ bias; r1[1] = w[u][1].y ^ bias;
      r1[2] = w[u][1].z ^ bias; r1[3] = w[u][1].w ^ bias;
      r2[0] = w[u][2].x ^ bias; r2[1] = w[u][2].y ^ bias;
      r2[2] = w[u][2].z ^ bias; r2[3] = w[u][2].w ^ bias;
      r3[0] = w[u][3].x ^ bias; r3[1] = w[u][3].y ^ bias;
      r3[2] = w[u][3].z ^ bias; r3[3] = w[u][3].w ^ bias;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // mma rows g and g + 8 are columns n + 2j and n + 2j + 1
        const int wd = j / 2, by = 2 * (j % 2);
        uint32_t a[4];
        a[0] = bf16_pair(r0[wd], r1[wd], by);
        a[1] = bf16_pair(r0[wd], r1[wd], by + 1);
        a[2] = bf16_pair(r2[wd], r3[wd], by);
        a[3] = bf16_pair(r2[wd], r3[wd], by + 1);
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
      out[m * ldo + col] = __float2bfloat16(sum * __bfloat162float(s[col]));
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

// x's tensor map: whether it has an expert axis of its own (else every
// expert reads the same rows), and whether that axis is its outermost
constexpr int X_BATCHED = 1, X_EXPERT_OUTER = 2;

// One CTA computes rows m0 .. m0 + 127 and columns n0 .. n0 + BN - 1 of
// expert blockIdx.z / nsplit over the k-tiles [(blockIdx.z % nsplit) *
// ktile_chunk, ...): with a K split the nsplit CTAs of one cluster (grid z)
// add their sums through distributed shared memory.
template <int BN>
__global__ void __launch_bounds__(MM_THREADS, 1) w8a16_wgmma(
    __grid_constant__ const CUtensorMap tx,
    __grid_constant__ const CUtensorMap tq,
    const __nv_bfloat16* __restrict__ s, __nv_bfloat16* __restrict__ out,
    int M, int N, int K, long long ldo, int ktile_chunk, int nsplit,
    long long sb, long long ob, int xmode) {
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
  const int m0 = blockIdx.x * MM_BM;       // m fastest: CTAs that run
  const int n0 = blockIdx.y * BN;          // together share weight columns
  const int ex = blockIdx.z / nsplit;      // the expert
  s += ex * sb;
  out += ex * ob;
  // x's coordinates after k: (expert, m0) or (m0, expert)
  const int xe = xmode & X_BATCHED ? ex : 0;
  const int xc1 = xmode & X_EXPERT_OUTER ? m0 : xe;
  const int xc2 = xmode & X_EXPERT_OUTER ? xe : m0;
  // this CTA's k-tiles: kt0 + 0 .. kt0 + ktiles - 1 (at least one)
  const int kt0 = (blockIdx.z % nsplit) * ktile_chunk;
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

  if (threadIdx.x < 128) {
    // ---- widening warpgroup ---------------------------------------------
    setmaxnreg_dec<MM_WIDEN_REGS>();
    for (int kt = 0; kt < ktiles; ++kt) {
      const uint32_t st = stage(kt);
      mbar_wait_or_trap(bar(full, kt), phase(kt));
      widen_tile<BN>(st + L::x, threadIdx.x);
      // the generic-proxy stores become visible to wgmma (the async proxy)
      // before the consumers see the barrier
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if (threadIdx.x % 32 == 0) mbar_arrive(bar(wide, kt));
    }
    // the last stages' release: a consumer stuck on a barrier traps here
    // (or at the full-barrier wait above) instead of hanging the card
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
    const bool active = m0 + cw * 64 < M;
    // one thread of the first consumer issues the TMA loads: tile t into
    // its stage once the stage's previous tile t - S is released (the
    // first pass over the ring finds every stage empty)
    const bool loader = ct == 0;
    auto issue = [&](int t) {
      mbar_wait(bar(empty, t), phase(t) ^ 1);
      mbar_expect_tx(bar(full, t), L::x + L::q);
      tma_load_3d(stage(t), &tx, bar(full, t), (kt0 + t) * MM_BK, xc1, xc2);
      tma_load_3d(stage(t) + L::x, &tq, bar(full, t), n0, (kt0 + t) * MM_BK,
                  ex);
    };
    if (loader)
      for (int t = 0; t < min(S, ktiles); ++t) issue(t);
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
      if (loader && kt > 0 && kt - 1 + S < ktiles) issue(kt - 1 + S);
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
      split_k_reduce<BN>(red, s, out, M, N, ldo, m0, n0,
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
          if (m < M)
            *reinterpret_cast<__nv_bfloat162*>(out + m * ldo + n) =
                __floats2bfloat162_rn(acc[4 * nb + 2 * h] * s0,
                                      acc[4 * nb + 2 * h + 1] * s1);
        }
      }
    }
  }
}

template <int NT>
cudaError_t launch_gemv(const __nv_bfloat16* x, const int8_t* q,
                        const __nv_bfloat16* s, __nv_bfloat16* out, int E,
                        int M, int N, int K, long long ldx, long long xb,
                        long long ldq, long long qb, long long sb,
                        long long ldo, long long ob, int kchunk, int ksplit,
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
  return cudaLaunchKernelEx(&cfg, w8a16_gemv<NT>, x, q, s, out, M, N, K,
                            ldx, ldq, ldo, kchunk, xb, qb, sb, ob);
}

// x_e [M, K] bf16 (rows ldx elements apart, experts xb apart, xb 0 for
// one x shared by every expert) in boxes of [128 rows][64 k], 128-byte
// swizzle; q [E, K, N] int8 (rows ldq bytes apart, experts qb apart) in
// unswizzled boxes of [64 k rows][bn bytes]. Both maps are 3-D, their
// strides growing: x is {K, E, M} for xb <= ldx (1 expert for xb 0: a
// stride of 0 is refused) and {K, M, E} above; *xmode says which. Past M,
// N or K of an expert a box reads zeros.
CUresult make_maps(EncodeTiled encode, CUtensorMap* tx, CUtensorMap* tq,
                   const void* x, const void* q, int E, int M, int N, int K,
                   long long ldx, long long xb, long long ldq, long long qb,
                   int bn, int* xmode) {
  const cuuint32_t elem[3] = {1, 1, 1};
  const bool outer = xb > ldx;
  *xmode = (xb ? X_BATCHED : 0) | (outer ? X_EXPERT_OUTER : 0);
  const cuuint64_t xe = xb ? cuuint64_t(E) : 1;
  const cuuint64_t xdims[3] = {cuuint64_t(K), outer ? cuuint64_t(M) : xe,
                               outer ? xe : cuuint64_t(M)};
  // the expert axis of a shared x has one entry: any legal stride will do
  const cuuint64_t xes = xb ? cuuint64_t(xb) * 2 : cuuint64_t(K) * 2;
  const cuuint64_t xstride[2] = {outer ? cuuint64_t(ldx) * 2 : xes,
                                 outer ? xes : cuuint64_t(ldx) * 2};
  const cuuint32_t xbox[3] = {cuuint32_t(MM_BK), outer ? MM_BM : 1u,
                              outer ? 1u : MM_BM};
  CUresult r = encode(tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                      const_cast<void*>(x), xdims, xstride, xbox, elem,
                      CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return r;
  const cuuint64_t qdims[3] = {cuuint64_t(N), cuuint64_t(K), cuuint64_t(E)};
  const cuuint64_t qstride[2] = {cuuint64_t(ldq), cuuint64_t(qb)};
  const cuuint32_t qbox[3] = {cuuint32_t(bn), cuuint32_t(MM_BK), 1};
  return encode(tq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(q),
                qdims, qstride, qbox, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int BN>
cudaError_t launch_wgmma(const CUtensorMap& tx, const CUtensorMap& tq,
                         const __nv_bfloat16* s, __nv_bfloat16* out, int E,
                         int M, int N, int K, long long sb, long long ldo,
                         long long ob, int kchunk, int ksplit, int xmode,
                         cudaStream_t st) {
  constexpr int MAX_DEVICES = 64;
  static bool smem_set[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES || !smem_set[dev]) {
    err = cudaFuncSetAttribute(w8a16_wgmma<BN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(MmSmem<BN>::total));
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES) smem_set[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((M + MM_BM - 1) / MM_BM, (N + BN - 1) / BN, E * ksplit);
  cfg.blockDim = dim3(MM_THREADS, 1, 1);
  cfg.dynamicSmemBytes = MmSmem<BN>::total;
  cfg.stream = st;
  // the CTAs that split one output tile's K form one cluster (z is
  // expert * ksplit + rank)
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = ksplit;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, w8a16_wgmma<BN>, tx, tq, s, out, M, N, K,
                           ldo, kchunk / MM_BK, ksplit, sb, ob, xmode);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Largest M the GEMV path takes; above it, the wgmma path.
extern "C" int w8a16_gemv_max_m() { return 16; }

// Rows of one wgmma-path CTA.
extern "C" int w8a16_wgmma_tile_m() { return MM_BM; }

// Dynamic shared memory of one wgmma-path CTA of width bn (0: no such).
extern "C" int w8a16_wgmma_smem_bytes(int bn) {
  if (bn == 128) return int(MmSmem<128>::total);
  if (bn == 256) return int(MmSmem<256>::total);
  return 0;
}

// GEMV CTAs one SM holds at once for this M (0 if the query fails).
extern "C" int w8a16_gemv_ctas_per_sm(int M) {
  int n = 0;
  const cudaError_t err =
      M <= 8 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   &n, w8a16_gemv<1>, GV_THREADS, 0)
             : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   &n, w8a16_gemv<2>, GV_THREADS, 0);
  return err == cudaSuccess ? n : 0;
}

// Most CTAs one output tile's K may be split over (one cluster).
extern "C" int w8a16_max_ksplit() { return MAX_KSPLIT; }

// Most experts one batched call may take (the grid's z extent over the
// largest K split).
extern "C" int w8a16_max_experts() { return 65535 / MAX_KSPLIT; }

// Returns 0 when launched, a cudaError_t (> 0) when the launch failed, -1
// when the driver has no cuTensorMapEncodeTiled and -(1000 + CUresult) when
// a tensor map was refused. The plan: ``kchunk`` is the K slice of one CTA
// (a multiple of 16 for M <= 16, of 64 above), with ceil(K / kchunk) at
// most w8a16_max_ksplit(); for M > 16 ``bn`` is the wgmma path's tile
// width, 128 or 256 (not read for M <= 16). Expert e reads x + e * xb
// (rows ldx apart), q + e * qb (rows ldq apart), s + e * sb and writes out
// + e * ob (rows ldo apart); strides in elements.
extern "C" int w8a16_bmm_bf16(const void* x, const void* q, const void* s,
                              void* out, int E, int M, int N, int K,
                              long long ldx, long long xb, long long ldq,
                              long long qb, long long sb, long long ldo,
                              long long ob, int bn, int kchunk,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || E <= 0) return int(cudaSuccess);
  if (K % 8 || N % 16 || K <= 0 || xb % 8 || xb < 0 ||
      E > w8a16_max_experts())
    return int(cudaErrorInvalidValue);
  auto xb16 = static_cast<const __nv_bfloat16*>(x);
  auto qb8 = static_cast<const int8_t*>(q);
  auto sb16 = static_cast<const __nv_bfloat16*>(s);
  auto ob16 = static_cast<__nv_bfloat16*>(out);
  const int step = M > 16 ? MM_BK : GV_KSTEP;
  if (kchunk <= 0 || kchunk % step) return int(cudaErrorInvalidValue);
  const int ksplit = (K + kchunk - 1) / kchunk;
  if (ksplit > MAX_KSPLIT) return int(cudaErrorInvalidValue);
  if (M > 16) {
    if (bn != 128 && bn != 256) return int(cudaErrorInvalidValue);
    EncodeTiled encode = encode_fn();
    if (encode == nullptr) return -1;
    CUtensorMap tx, tq;
    int xmode = 0;
    const CUresult r = make_maps(encode, &tx, &tq, x, q, E, M, N, K, ldx, xb,
                                 ldq, qb, bn, &xmode);
    if (r != CUDA_SUCCESS) return -(1000 + int(r));
    return int(bn == 128
                   ? launch_wgmma<128>(tx, tq, sb16, ob16, E, M, N, K, sb,
                                       ldo, ob, kchunk, ksplit, xmode, st)
                   : launch_wgmma<256>(tx, tq, sb16, ob16, E, M, N, K, sb,
                                       ldo, ob, kchunk, ksplit, xmode, st));
  }
  return int(M <= 8 ? launch_gemv<1>(xb16, qb8, sb16, ob16, E, M, N, K, ldx,
                                     xb, ldq, qb, sb, ldo, ob, kchunk,
                                     ksplit, st)
                    : launch_gemv<2>(xb16, qb8, sb16, ob16, E, M, N, K, ldx,
                                     xb, ldq, qb, sb, ldo, ob, kchunk,
                                     ksplit, st));
}

// The 2-D product: w8a16_bmm_bf16 with one expert.
extern "C" int w8a16_gemm_bf16(const void* x, const void* q, const void* s,
                               void* out, int M, int N, int K, long long ldx,
                               long long ldq, long long ldo, int bn,
                               int kchunk, void* stream) {
  return w8a16_bmm_bf16(x, q, s, out, 1, M, N, K, ldx, 0, ldq,
                        (long long)K * ldq, 0, ldo, 0, bn, kchunk, stream);
}
