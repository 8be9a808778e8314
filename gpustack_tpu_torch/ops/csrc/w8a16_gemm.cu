// Weight-only int8 matrix product for Hopper (sm_90a): bf16 activations,
// int8 weights with per-output-channel bf16 scales, bf16 out.
//
//   out[M, N] = bf16( (sum_k x[m, k] * q[k, n]) * s[n] )
//
// x is bf16 [M, K] (rows ldx elements apart), q is int8 [K, N] in the JAX
// package's [in, out] layout (rows ldq bytes apart, one layer's view of the
// stacked [L, K, N]), s is bf16 [N], out is bf16 [M, N] (rows ldo apart).
// The sum and the scale are fp32. The dequantized weight never reaches
// device memory: int8 values are widened in registers.
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
//   - M > 16 (prefill, chunks): a tiled mma.sync m16n8k16 bf16 kernel,
//     128 x 128 x 32 tiles, 8 warps of 64 x 32, fed by a 3-stage cp.async
//     ring (x tile as bf16, q tile as int8: 4 KB instead of 8). The int8
//     B fragments are widened to bf16 between shared memory and the
//     registers. Bound by operations at prefill sizes (w_gate, M = 2048:
//     240.5 GFLOP, ~0.243 ms at 989 TFLOP/s).
// Not done yet: wgmma and TMA for the large-M path.
//
// Requirements the wrapper checks: K % 8 == 0, N % 16 == 0, x rows and q
// rows 16-byte aligned, out rows 4-byte aligned. Ragged M, N and K tiles
// are masked (zero-filled loads, guarded stores).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
constexpr int GV_MAX_KSPLIT = 8;                 // portable cluster size
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
    int kchunk) {
  constexpr int U = NT == 1 ? 2 : 1;
  __shared__ __align__(16) float red[GV_WARPS * GV_SUMS];

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
// Large M: tiled mma.sync
// ---------------------------------------------------------------------------

constexpr int MM_BM = 128;
constexpr int MM_BN = 128;
constexpr int MM_BK = 32;
constexpr int MM_THREADS = 256;                  // 8 warps: 2 along M, 4 along N
constexpr int MM_STAGES = 3;
constexpr int MM_WM = 64;                        // rows per warp
constexpr int MM_WN = 32;                        // columns per warp
constexpr int MM_MI = MM_WM / 16;                // m16 tiles per warp
constexpr int MM_NI = MM_WN / 8;                 // n8 tiles per warp
// padded rows: x rows of 40 bf16 (80 bytes), q rows of 144 bytes; both
// keep cp.async's 16-byte destinations aligned and the fragment reads free
// of bank conflicts
constexpr int A_STRIDE = MM_BK + 8;
constexpr int B_STRIDE = MM_BN + 16;
constexpr int A_STAGE = MM_BM * A_STRIDE;        // bf16 elements
constexpr int B_STAGE = MM_BK * B_STRIDE;        // bytes

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;              // 0: zero-fill, no read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t pack_bf16(int8_t lo, int8_t hi) {
  // int8 values are exact in bf16; the lower k index in the low half
  const __nv_bfloat162 v =
      __floats2bfloat162_rn(static_cast<float>(lo), static_cast<float>(hi));
  return *reinterpret_cast<const uint32_t*>(&v);
}

__global__ void __launch_bounds__(MM_THREADS) w8a16_mma(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
    const __nv_bfloat16* __restrict__ s, __nv_bfloat16* __restrict__ out,
    int M, int N, int K, long long ldx, long long ldq, long long ldo) {
  __shared__ __align__(16) __nv_bfloat16 As[MM_STAGES * A_STAGE];
  __shared__ __align__(16) int8_t Bs[MM_STAGES * B_STAGE];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = (warp / 4) * MM_WM;             // warp's rows in the tile
  const int wn = (warp % 4) * MM_WN;             // warp's columns
  const int bm = blockIdx.y * MM_BM;
  const int bn = blockIdx.x * MM_BN;
  const int ktiles = (K + MM_BK - 1) / MM_BK;

  auto load_tile = [&](int stage, int kt) {
    const int k0 = kt * MM_BK;
    // x: 128 rows x 4 chunks of 8 bf16; two chunks per thread
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * MM_THREADS;
      const int r = c / 4, kc = (c % 4) * 8;
      const int gm = bm + r, gk = k0 + kc;
      const bool ok = gm < M && gk < K;
      cp_async16(As + stage * A_STAGE + r * A_STRIDE + kc,
                 ok ? (const void*)(x + gm * ldx + gk) : (const void*)x, ok);
    }
    // q: 32 rows x 8 chunks of 16 bytes; one chunk per thread
    {
      const int r = tid / 8, nc = (tid % 8) * 16;
      const int gk = k0 + r, gn = bn + nc;
      const bool ok = gk < K && gn < N;
      cp_async16(Bs + stage * B_STAGE + r * B_STRIDE + nc,
                 ok ? (const void*)(q + gk * ldq + gn) : (const void*)q, ok);
    }
  };

  float acc[MM_MI][MM_NI][4];
#pragma unroll
  for (int i = 0; i < MM_MI; ++i)
#pragma unroll
    for (int j = 0; j < MM_NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int st = 0; st < MM_STAGES - 1; ++st) {
    if (st < ktiles) load_tile(st, st);
    cp_async_commit();
  }

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<MM_STAGES - 2>();
    __syncthreads();     // tile kt landed; everyone is done with kt - 1
    const int next = kt + MM_STAGES - 1;
    if (next < ktiles) load_tile(next % MM_STAGES, next);
    cp_async_commit();

    const __nv_bfloat16* A = As + (kt % MM_STAGES) * A_STAGE;
    const int8_t* B = Bs + (kt % MM_STAGES) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < MM_BK; kk += 16) {
      uint32_t a[MM_MI][4];
#pragma unroll
      for (int i = 0; i < MM_MI; ++i) {
        const __nv_bfloat16* ap = A + (wm + i * 16 + g) * A_STRIDE + kk + 2 * t;
        a[i][0] = *reinterpret_cast<const uint32_t*>(ap);
        a[i][1] = *reinterpret_cast<const uint32_t*>(ap + 8 * A_STRIDE);
        a[i][2] = *reinterpret_cast<const uint32_t*>(ap + 8);
        a[i][3] = *reinterpret_cast<const uint32_t*>(ap + 8 * A_STRIDE + 8);
      }
#pragma unroll
      for (int j = 0; j < MM_NI; ++j) {
        const int8_t* bp = B + (kk + 2 * t) * B_STRIDE + wn + j * 8 + g;
        const uint32_t b0 = pack_bf16(bp[0], bp[B_STRIDE]);
        const uint32_t b1 = pack_bf16(bp[8 * B_STRIDE], bp[9 * B_STRIDE]);
#pragma unroll
        for (int i = 0; i < MM_MI; ++i) mma_bf16(acc[i][j], a[i], b0, b1);
      }
    }
  }
  cp_async_wait<0>();

  // epilogue: scale in fp32, round to bf16, two columns per store
#pragma unroll
  for (int j = 0; j < MM_NI; ++j) {
    const int n = bn + wn + j * 8 + 2 * t;
    if (n >= N) continue;
    const float s0 = __bfloat162float(s[n]);
    const float s1 = __bfloat162float(s[n + 1]);
#pragma unroll
    for (int i = 0; i < MM_MI; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = bm + wm + i * 16 + g + h * 8;
        if (m < M) {
          *reinterpret_cast<__nv_bfloat162*>(out + m * ldo + n) =
              __floats2bfloat162_rn(acc[i][j][2 * h] * s0,
                                    acc[i][j][2 * h + 1] * s1);
        }
      }
    }
  }
}

template <int NT>
cudaError_t launch_gemv(const __nv_bfloat16* x, const int8_t* q,
                        const __nv_bfloat16* s, __nv_bfloat16* out, int M,
                        int N, int K, long long ldx, long long ldq,
                        long long ldo, int kchunk, int ksplit,
                        cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + GV_BN - 1) / GV_BN, ksplit, 1);
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
                            ldx, ldq, ldo, kchunk);
}

}  // namespace

// Largest M the GEMV path takes; above it, the mma.sync path.
extern "C" int w8a16_gemv_max_m() { return 16; }

// Most CTAs one GEMV column slice's K may be split over (one cluster).
extern "C" int w8a16_gemv_max_ksplit() { return GV_MAX_KSPLIT; }

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

// Returns 0 or a cudaError_t. For M <= 16, ``kchunk`` (a multiple of 16)
// is the K slice of one CTA, and ceil(K / kchunk) may be at most
// w8a16_gemv_max_ksplit(). For M > 16, ``kchunk`` is not read.
extern "C" int w8a16_gemm_bf16(const void* x, const void* q, const void* s,
                               void* out, int M, int N, int K, long long ldx,
                               long long ldq, long long ldo, int kchunk,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0) return int(cudaSuccess);
  if (K % 8 || N % 16 || K <= 0) return int(cudaErrorInvalidValue);
  auto xb = static_cast<const __nv_bfloat16*>(x);
  auto qb = static_cast<const int8_t*>(q);
  auto sb = static_cast<const __nv_bfloat16*>(s);
  auto ob = static_cast<__nv_bfloat16*>(out);
  if (M > 16) {
    const dim3 grid((N + MM_BN - 1) / MM_BN, (M + MM_BM - 1) / MM_BM);
    w8a16_mma<<<grid, MM_THREADS, 0, st>>>(xb, qb, sb, ob, M, N, K, ldx,
                                           ldq, ldo);
    return int(cudaGetLastError());
  }
  if (kchunk <= 0 || kchunk % GV_KSTEP) return int(cudaErrorInvalidValue);
  const int ksplit = (K + kchunk - 1) / kchunk;
  if (ksplit > GV_MAX_KSPLIT) return int(cudaErrorInvalidValue);
  return int(M <= 8 ? launch_gemv<1>(xb, qb, sb, ob, M, N, K, ldx, ldq, ldo,
                                     kchunk, ksplit, st)
                    : launch_gemv<2>(xb, qb, sb, ob, M, N, K, ldx, ldq, ldo,
                                     kchunk, ksplit, st));
}
