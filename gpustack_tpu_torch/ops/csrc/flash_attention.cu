// Causal GQA flash-attention prefill for Hopper (sm_90a), bf16 in/out.
//
// Replaces the Pallas TPU kernel gpustack_tpu/ops/flash_attention.py
// (_flash_kernel, launched by flash_attention_prefill): the same function,
// softmax(scale * q k^T + causal mask) v with an online softmax whose
// running max, sum and accumulator are fp32, the result acc / max(l, 1e-30),
// keys at index >= S masked, the causal diagonal shifted by a runtime
// q_offset, and kv head h / (Hq / Hkv).
//
// Bound on the card: two matrix products per visible (query, key) pair,
// 4 * d * Hq * pairs flops (34.4 GFLOP at llama3-8b widths, T = S = 2048:
// ~35 us at 989 TFLOP/s bf16) against ~42 MB of q/k/v/out traffic (~12.5 us
// at 3.35 TB/s). The call is compute-bound, so the design keeps everything
// between the two products in registers and feeds the tensor cores:
//   - one block of 8 warps per (128-row q-tile, q-head, batch row); each
//     warp owns 16 q rows. The TPU's sequential k grid axis becomes a loop
//     inside the block that stops at the causal edge of the tile's last
//     valid row; q-tiles are scheduled heaviest (longest key range) first;
//   - both products are mma.sync m16n8k16 bf16 with fp32 accumulators.
//     The score tile S = Q K^T, the softmax, the probabilities P (repacked
//     from S's accumulator layout straight into P.V's operand layout) and
//     the output accumulator O all stay in registers; Q's fragments are
//     loaded once per block;
//   - K and V tiles (64 keys) are double-buffered in shared memory with
//     cp.async, rows padded by 16 bytes so ldmatrix reads are free of bank
//     conflicts; V is read transposed by ldmatrix.trans;
//   - q/k/v are read in their [B, T, H, d] layout through strides; ragged
//     rows (T, S not multiples of the tile) are zero-filled by cp.async and
//     masked here, so the host does no transpose or pad.
// wgmma, TMA and warp specialisation would lift the tensor-core rate
// further.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;      // q rows per block
constexpr int BK = 64;       // keys per k-tile
constexpr int WARPS = 8;     // each warp owns BQ / WARPS = 16 q rows
constexpr int THREADS = WARPS * 32;
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Layout {
  static constexpr int LD = D + 8;                       // padded row
  static constexpr size_t q = size_t(BQ) * LD * 2;       // bf16 Q tile
  static constexpr size_t kv = size_t(BK) * LD * 2;      // one K or V tile
  static constexpr size_t total = q + 4 * kv;            // K, V x2 buffers
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  // src-size 0 zero-fills the 16 destination bytes without a read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a * b for one m16n8k16 tile (a: 16x16 row-major, b: 16x8 col-major)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x is the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// Stage `ROWS` rows of D bf16 values (row r at src + r * row_stride) into a
// padded shared tile; rows at or past `valid` are zero-filled.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long row_stride, int valid) {
  constexpr int PER_ROW = D / 8;                 // 16-byte chunks per row
  for (int i = threadIdx.x; i < ROWS * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW;
    const int c = (i % PER_ROW) * 8;
    const bool ok = r < valid;
    cp_async16(smem_addr(dst + r * Layout<D>::LD + c),
               ok ? src + r * row_stride + c : src, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_prefill_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ out,
                     int T, int S, int Hq, int Hkv,
                     long long qsb, long long qst, long long qsh,
                     long long ksb, long long kss, long long ksh,
                     long long vsb, long long vss, long long vsh,
                     int q_offset, float scale) {
  using L = Layout<D>;
  constexpr int LD = L::LD;
  constexpr int NT = BK / 8;      // 8-key score tiles per k-tile
  constexpr int DT = D / 8;       // 8-column output tiles
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks[2];
  __nv_bfloat16* Vs[2];
  for (int i = 0; i < 2; ++i) {
    Ks[i] = reinterpret_cast<__nv_bfloat16*>(smem + L::q + (2 * i) * L::kv);
    Vs[i] = reinterpret_cast<__nv_bfloat16*>(smem + L::q + (2 * i + 1) * L::kv);
  }

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // heaviest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;        // accumulator row within the 16-row slab
  const int t4 = lane & 3;        // accumulator column pair

  const __nv_bfloat16* qb = q + b * qsb + (long long)q0 * qst + h * qsh;
  const __nv_bfloat16* kb = k + b * ksb + hk * ksh;
  const __nv_bfloat16* vb = v + b * vsb + hk * vsh;

  const int q_rows = min(BQ, T - q0);
  // keys beyond the last valid q row's position are causally invisible
  const int kv_end = min(S, q_offset + q0 + q_rows);
  const int n_kt = kv_end > 0 ? (kv_end + BK - 1) / BK : 0;

  const int wr = warp * 16;                        // warp's first tile row
  const int row0 = q0 + wr + g;                    // sequence rows held
  const int row1 = row0 + 8;
  const int qpos0 = q_offset + row0;
  const int qpos1 = q_offset + row1;
  const bool warp_has_rows = q0 + wr < T;
  const int warp_last_qpos = q_offset + min(q0 + wr + 15, T - 1);
  const float sl2 = scale * LOG2E;                 // exp(x) = exp2(x log2e)

  float m0 = NEG, m1 = NEG;        // running max (log2 domain), rows g, g+8
  float l0 = 0.f, l1 = 0.f;        // this thread's partial row sums
  float o[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  uint32_t qf[D / 16][4];

  if (n_kt > 0) {
    load_tile<D, BQ>(Qs, qb, qst, q_rows);
    load_tile<D, BK>(Ks[0], kb, kss, min(BK, S));
    load_tile<D, BK>(Vs[0], vb, vss, min(BK, S));
    cp_async_commit();
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_kt) {
      const int k1 = (kt + 1) * BK;
      load_tile<D, BK>(Ks[buf ^ 1], kb + (long long)k1 * kss, kss,
                       min(BK, S - k1));
      load_tile<D, BK>(Vs[buf ^ 1], vb + (long long)k1 * vss, vss,
                       min(BK, S - k1));
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldmatrix_x4(qf[kk], smem_addr(Qs + (wr + (lane & 15)) * LD + kk * 16 +
                                      (lane >> 4) * 8));
    }

    const int k0 = kt * BK;
    if (warp_has_rows && k0 <= warp_last_qpos) {
      // S = Q K^T for this warp's 16 rows x 64 keys
      float s[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const __nv_bfloat16* Kt = Ks[buf];
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t kf[4];
          ldmatrix_x4(kf, smem_addr(Kt + (np * 16 + (lane & 7) +
                                           ((lane >> 4) << 3)) * LD +
                                    kk * 16 + ((lane >> 3) & 1) * 8));
          mma_bf16(s[2 * np], qf[kk], kf[0], kf[1]);
          mma_bf16(s[2 * np + 1], qf[kk], kf[2], kf[3]);
        }
      }

      // scale into the log2 domain; mask where a key can be invisible
      const bool need_mask =
          k0 + BK > S || k0 + BK - 1 > q_offset + q0 + wr;
      float mx0 = NEG, mx1 = NEG;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * sl2;
          if (need_mask) {
            const int col = k0 + n * 8 + t4 * 2 + (e & 1);
            const int qpos = e < 2 ? qpos0 : qpos1;
            if (col > qpos || col >= S) x = NEG;
          }
          s[n][e] = x;
        }
        mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
        mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
      }
      // a row's four owners are the lanes of one quad
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0);
      const float mn1 = fmaxf(m1, mx1);
      const float c0 = m0 <= NEG / 2 ? 0.f : exp2f(m0 - mn0);
      const float c1 = m1 <= NEG / 2 ? 0.f : exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        s[n][0] = s[n][0] <= NEG / 2 ? 0.f : exp2f(s[n][0] - mn0);
        s[n][1] = s[n][1] <= NEG / 2 ? 0.f : exp2f(s[n][1] - mn0);
        s[n][2] = s[n][2] <= NEG / 2 ? 0.f : exp2f(s[n][2] - mn1);
        s[n][3] = s[n][3] <= NEG / 2 ? 0.f : exp2f(s[n][3] - mn1);
        ps0 += s[n][0] + s[n][1];
        ps1 += s[n][2] + s[n][3];
      }
      l0 = l0 * c0 + ps0;
      l1 = l1 * c1 + ps1;
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        o[n][0] *= c0;
        o[n][1] *= c0;
        o[n][2] *= c1;
        o[n][3] *= c1;
      }

      // O += P V: S's accumulator layout is P's operand layout, per 16 keys
      const __nv_bfloat16* Vt = Vs[buf];
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
        const uint32_t pa[4] = {
            pack_bf16(s[2 * j][0], s[2 * j][1]),
            pack_bf16(s[2 * j][2], s[2 * j][3]),
            pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
            pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]),
        };
#pragma unroll
        for (int np = 0; np < DT / 2; ++np) {
          uint32_t vf[4];
          ldmatrix_x4_trans(
              vf, smem_addr(Vt + (j * 16 + (lane & 7) +
                                  ((lane >> 3) & 1) * 8) * LD +
                            np * 16 + (lane >> 4) * 8));
          mma_bf16(o[2 * np], pa, vf[0], vf[1]);
          mma_bf16(o[2 * np + 1], pa, vf[2], vf[3]);
        }
      }
    }
    // every warp is done with this buffer before it is refilled
    __syncthreads();
  }

  // out[b, row, h * D + c] = O / max(l, 1e-30), contiguous [B, T, Hq*D]
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  const long long row_stride = (long long)Hq * D;
  __nv_bfloat16* ob = out + (long long)b * T * row_stride + h * D + t4 * 2;
#pragma unroll
  for (int n = 0; n < DT; ++n) {
    if (row0 < T)
      *reinterpret_cast<__nv_bfloat162*>(ob + row0 * row_stride + n * 8) =
          __floats2bfloat162_rn(o[n][0] * inv0, o[n][1] * inv0);
    if (row1 < T)
      *reinterpret_cast<__nv_bfloat162*>(ob + row1 * row_stride + n * 8) =
          __floats2bfloat162_rn(o[n][2] * inv1, o[n][3] * inv1);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int T, int S, int Hq, int Hkv,
                   long long qsb, long long qst, long long qsh,
                   long long ksb, long long kss, long long ksh,
                   long long vsb, long long vss, long long vsh,
                   int q_offset, float scale, cudaStream_t stream) {
  const size_t smem = Layout<D>::total;
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((T + BQ - 1) / BQ, Hq, B);
  flash_prefill_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), T, S, Hq, Hkv,
      qsb, qst, qsh, ksb, kss, ksh, vsb, vss, vsh, q_offset, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). Strides are in elements; the
// last dimension of q, k and v must be contiguous and rows 16-byte aligned.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int flash_prefill_bf16(
    const void* q, const void* k, const void* v, void* out,
    int B, int T, int S, int Hq, int Hkv, int d,
    long long qsb, long long qst, long long qsh,
    long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh,
    int q_offset, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T == 0 || B == 0) return int(cudaSuccess);
  if (d == 128)
    return int(launch<128>(q, k, v, out, B, T, S, Hq, Hkv, qsb, qst, qsh,
                           ksb, kss, ksh, vsb, vss, vsh, q_offset, scale, st));
  if (d == 64)
    return int(launch<64>(q, k, v, out, B, T, S, Hq, Hkv, qsb, qst, qsh,
                          ksb, kss, ksh, vsb, vss, vsh, q_offset, scale, st));
  return int(cudaErrorInvalidValue);
}
