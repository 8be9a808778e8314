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
// at 3.35 TB/s). The call is compute-bound, and only wgmma reaches the
// tensor cores' full rate, so the design keeps wgmma fed and hides the
// softmax behind it:
//   - one CTA of three warpgroups per (128-row q-tile, q-head, batch row),
//     heaviest q-tiles (longest key range) first. Warpgroup 0 is the
//     producer: one thread issues every TMA load and the warpgroup gives
//     its registers away (setmaxnreg.dec). Warpgroups 1 and 2 are the
//     consumers, 64 q rows each (wgmma's M), with setmaxnreg.inc. The roles
//     split in one top-level if/else, as setmaxnreg requires;
//   - q, k and v are read in their [B, T, H, d] layout through TMA tensor
//     maps (dims d, H, T, B with the tensors' own strides), in 64-column
//     boxes with 128-byte swizzle. Rows past T or S arrive as zeros, and
//     the batch dimension keeps one row's keys out of another's tile. Q is
//     loaded once per CTA; 128-key K and V tiles flow through a 2-stage
//     ring with full (TMA bytes) and empty (consumer warps) mbarriers, K
//     and V on barriers of their own so a K stage is refilled as soon as
//     Q K^T is done with it;
//   - S = Q K^T is wgmma m64n128k16 with both operands in shared memory
//     (K-major). O += P V is wgmma m64n{d}k16 with A = P in registers,
//     repacked from S's accumulator layout, and B = V read MN-major
//     (transposed) from shared memory. Each consumer issues tile j's Q K^T
//     together with tile j-1's P V and runs tile j's softmax while P V is
//     still on the tensor cores; the two consumers take turns issuing
//     (named barriers), so one's softmax overlaps the other's products;
//   - the softmax works on S's accumulator registers: raw scores masked to
//     -inf only on tiles that cross the causal edge or S, the row max
//     scaled into the log2 domain, p = 2^(x * scale * log2e - max) as one
//     FFMA and one ex2.approx, the NEG (-1e30) guards once per row;
//   - the epilogue writes O / l as bf16 into the consumer's own rows of the
//     Q tile (128-byte swizzled, free of bank conflicts) and one TMA store
//     per box sends it to [B, T, Hq * d], rows past T dropped.
// Not done yet: a persistent tile scheduler (one CTA per SM walking the
// q-tiles, so one tile's epilogue overlaps the next one's loads), and
// splitting the diagonal tile so the first consumer skips keys its rows
// cannot see.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;          // q rows per CTA
constexpr int BK = 128;          // keys per k-tile
constexpr int WG_ROWS = 64;      // q rows per consumer warpgroup (wgmma M)
constexpr int THREADS = 384;     // producer warpgroup + two consumers
constexpr int CONSUMER_WARPS = 8;
constexpr int STAGES = 2;        // K/V ring depth
constexpr int BOX = 64;          // columns per TMA box: 128 bytes of bf16
constexpr int ROW_BYTES = BOX * 2;
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;   // 128 * 40 + 256 * 232 = 384 * 168
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
// the producer's barrier wait that outlasts this is a fault (a stage that
// is never released, so consumers are stuck too): trap, so the launch fails
// instead of hanging the card
constexpr unsigned long long WAIT_LIMIT_NS = 4000000000ull;

// Shared memory, from a 1024-byte aligned base (the 128-byte swizzle
// repeats every 1024 bytes): Q as D / 64 boxes of [BQ rows][64 cols], then
// per stage a K and a V tile as D / 64 boxes of [BK rows][64 cols], then
// the barriers.
template <int D>
struct Smem {
  static constexpr uint32_t q = BQ * D * 2;
  static constexpr uint32_t kv = BK * D * 2;           // one K or V tile
  static constexpr uint32_t bars = q + 2 * STAGES * kv;
  static constexpr uint32_t n_bars = 1 + 4 * STAGES;   // q; k, v full, empty
  static constexpr uint32_t total = bars + 8 * n_bars + 1024;  // + align
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait for the completion of the barrier phase of the given parity. The
// consumers' wait is a bare spin: a trap on their path makes ptxas
// serialize every wgmma (C7520).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// The producer's wait, with a watchdog.
__device__ __forceinline__ void mbar_wait_or_trap(uint32_t bar,
                                                  uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const unsigned long long t0 = global_ns();
  while (!mbar_try_wait(bar, parity)) {
    if (global_ns() - t0 > WAIT_LIMIT_NS) __trap();
  }
}

// ---- TMA ------------------------------------------------------------------

// One box of a 4-D tensor map (coordinates innermost first) into shared
// memory; the bytes are reported to `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// One box from shared memory to a 4-D tensor map; rows past the tensor's
// extent are not written.
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---- wgmma ----------------------------------------------------------------

// Shared-memory matrix descriptor for a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout B128.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Keep the compiler from moving accumulator reads or writes across an
// asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (m64nN, fp32) = A B (+ d when scale_d): A [64 x 16] and B [N x 16] both
// K-major in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d);

// d (m64nN, fp32) += A B: A [64 x 16] bf16 from registers, B [16 x N]
// MN-major (transposed) in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
}

__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
}

// 2^x in one MUFU op (exp2f adds a range fix-up around it); results below
// 2^-126 flush to 0, which a probability can afford.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x is the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Issue S = Q K^T for one warpgroup's 64 rows and a BK-key tile: D / 16
// steps of k16, each 32 bytes further along the swizzled 128-byte rows of
// a 64-column box.
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[BK / 2], uint32_t q_wg,
                                         uint32_t sK) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_ss<BK>(s, smem_desc(q_wg + (kk / 4) * BQ * ROW_BYTES + off, 16, 1024),
                 smem_desc(sK + (kk / 4) * BK * ROW_BYTES + off, 16, 1024),
                 kk > 0);
  }
}

// Issue O += P V: k16 steps advance 16 key rows of the V tile; V's two
// 64-column boxes (d = 128) are the descriptor's leading-byte-offset apart.
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&p)[BK / 16][4],
                                         uint32_t sV) {
#pragma unroll
  for (int j = 0; j < BK / 16; ++j)
    wgmma_rs<D>(o, p[j],
                smem_desc(sV + j * 16 * ROW_BYTES, BK * ROW_BYTES, 1024));
}

// A thread's online-softmax state for its two rows (g and g + 8).
struct RowState {
  float m0 = NEG, m1 = NEG;   // running max (log2 domain)
  float l0 = 0.f, l1 = 0.f;   // this thread's partial row sums
};

// Online softmax on one tile's raw scores, in S's accumulator registers
// (rows g and g + 8 of the warp's 16; the four lanes of a quad own a row):
// mask keys past the causal edge or S to -inf (only on tiles that can hold
// one), take each row's max, update the running max (log2 domain) and sum,
// exponentiate in place and return the factors that rescale O's rows.
__device__ __forceinline__ void online_softmax(float (&s)[BK / 2],
                                               RowState& r, bool need_mask,
                                               int k0, int S, int t4,
                                               int qpos0, int qpos1,
                                               float sl2, float& c0,
                                               float& c1) {
  constexpr int NT = BK / 8;
  float mx0 = NEG, mx1 = NEG;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (need_mask) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + t4 * 2 + (e & 1);
        if (col > (e < 2 ? qpos0 : qpos1) || col >= S)
          s[4 * n + e] = -INFINITY;
      }
    }
    mx0 = fmaxf(mx0, fmaxf(s[4 * n], s[4 * n + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  // the raw max into the log2 domain (scale > 0 keeps it the max); a row
  // with no visible key yet keeps NEG
  mx0 = mx0 <= NEG / 2 ? NEG : mx0 * sl2;
  mx1 = mx1 <= NEG / 2 ? NEG : mx1 * sl2;
  const float mn0 = fmaxf(r.m0, mx0);
  const float mn1 = fmaxf(r.m1, mx1);
  c0 = r.m0 <= NEG / 2 ? 0.f : fast_exp2(r.m0 - mn0);
  c1 = r.m1 <= NEG / 2 ? 0.f : fast_exp2(r.m1 - mn1);
  r.m0 = mn0;
  r.m1 = mn1;
  // p = 2^(x * scale * log2e - ref) in one FFMA: ref is the row's max, or
  // 0 while the row has seen no visible key (one guard per row, not per
  // score); a masked score is -inf and gives exactly 0
  const float ref0 = mn0 <= NEG / 2 ? 0.f : mn0;
  const float ref1 = mn1 <= NEG / 2 ? 0.f : mn1;
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[4 * n + e] =
          fast_exp2(fmaf(s[4 * n + e], sl2, -(e < 2 ? ref0 : ref1)));
    ps0 += s[4 * n] + s[4 * n + 1];
    ps1 += s[4 * n + 2] + s[4 * n + 3];
  }
  r.l0 = r.l0 * c0 + ps0;
  r.l1 = r.l1 * c1 + ps1;
}

// S's accumulator layout, per 16 keys, is wgmma's A-register layout.
__device__ __forceinline__ void pack_p(uint32_t (&p)[BK / 16][4],
                                       const float (&s)[BK / 2]) {
#pragma unroll
  for (int j = 0; j < BK / 16; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[j][i] = pack_bf16(s[8 * j + 2 * i], s[8 * j + 2 * i + 1]);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_prefill_kernel(__grid_constant__ const CUtensorMap tq,
                     __grid_constant__ const CUtensorMap tk,
                     __grid_constant__ const CUtensorMap tv,
                     __grid_constant__ const CUtensorMap to,
                     int T, int S, int Hq, int Hkv, int q_offset,
                     float scale) {
  using L = Smem<D>;
  constexpr int NB = D / BOX;        // 64-column boxes per row
  constexpr int DT = D / 8;          // 8-column blocks of O
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sKV = base + L::q;      // stage s: K at 2s, V at 2s + 1
  // barriers, 8 bytes each; the per-stage ones at + 8 * stage
  const uint32_t bar_q = base + L::bars;
  const uint32_t full_k = bar_q + 8;
  const uint32_t full_v = full_k + 8 * STAGES;
  const uint32_t empty_k = full_v + 8 * STAGES;
  const uint32_t empty_v = empty_k + 8 * STAGES;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // heaviest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q_rows = min(BQ, T - q0);
  // keys beyond the last valid q row's position are causally invisible
  const int kv_end = min(S, q_offset + q0 + q_rows);
  const int n_kt = kv_end > 0 ? (kv_end + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_k + 8 * s, CONSUMER_WARPS);
      mbar_init(empty_v + 8 * s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread keeps the ring full -------------
    setmaxnreg_dec();
    if (threadIdx.x == 0 && n_kt > 0) {
      mbar_expect_tx(bar_q, L::q);
#pragma unroll
      for (int c = 0; c < NB; ++c)
        tma_load(sQ + c * BQ * ROW_BYTES, &tq, bar_q, c * BOX, h, q0, b);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % STAGES;
        // the first pass over the ring finds every stage empty
        const uint32_t parity = ((kt / STAGES) & 1) ^ 1;
        const uint32_t sK = sKV + (2 * s) * L::kv;
        mbar_wait_or_trap(empty_k + 8 * s, parity);
        mbar_expect_tx(full_k + 8 * s, L::kv);
#pragma unroll
        for (int c = 0; c < NB; ++c)
          tma_load(sK + c * BK * ROW_BYTES, &tk, full_k + 8 * s, c * BOX, hk,
                   kt * BK, b);
        mbar_wait_or_trap(empty_v + 8 * s, parity);
        mbar_expect_tx(full_v + 8 * s, L::kv);
#pragma unroll
        for (int c = 0; c < NB; ++c)
          tma_load(sK + L::kv + c * BK * ROW_BYTES, &tv, full_v + 8 * s,
                   c * BOX, hk, kt * BK, b);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 q rows each ----------------------------
    setmaxnreg_inc();
    const int ct = threadIdx.x - 128;
    const int cw = ct / 128;            // consumer warpgroup
    const int warp = (ct / 32) % 4;     // warp within it: 16 rows
    const int lane = ct % 32;
    const int g = lane >> 2;            // accumulator row within 16 rows
    const int t4 = lane & 3;            // accumulator column pair
    const int wg_row = q0 + cw * WG_ROWS;
    const int row0 = wg_row + warp * 16 + g;
    const int row1 = row0 + 8;
    const int qpos0 = q_offset + row0;
    const int qpos1 = q_offset + row1;
    const int warp_qpos = q_offset + wg_row + warp * 16;
    // tiles this warpgroup computes: those holding a key one of its rows
    // can see (the rest of the CTA's tiles lie wholly above its causal
    // edge, or it holds no row)
    const int wg_last =
        wg_row < T ? q_offset + min(wg_row + WG_ROWS - 1, T - 1) : -1;
    const int n_wg = wg_last < 0 ? 0 : min(n_kt, wg_last / BK + 1);
    // the other consumer's tile count: when both run the same number of
    // tiles, they take turns issuing their GEMMs (named barriers 3 and 4),
    // so one's softmax overlaps the other's tensor-core work
    const int o_row = q0 + (1 - cw) * WG_ROWS;
    const int o_last =
        o_row < T ? q_offset + min(o_row + WG_ROWS - 1, T - 1) : -1;
    const bool pingpong =
        n_wg > 0 && n_wg == (o_last < 0 ? 0 : min(n_kt, o_last / BK + 1));
    // turn t of n_wg + 1: wait for it (warpgroup 0 starts without), then
    // hand the next to the other warpgroup (warpgroup 1's last turn has
    // no successor)
    auto turn_begin = [&](int t) {
      if (pingpong && (cw == 1 || t > 0))
        asm volatile("bar.sync %0, 256;\n" ::"r"(3 + cw) : "memory");
    };
    auto turn_end = [&](int t) {
      if (pingpong && (cw == 0 || t < n_wg))
        asm volatile("bar.arrive %0, 256;\n" ::"r"(4 - cw) : "memory");
    };
    const float sl2 = scale * LOG2E;                 // exp(x) = exp2(x log2e)
    const uint32_t q_wg = sQ + cw * WG_ROWS * ROW_BYTES;
    auto tile_k = [&](int kt) { return sKV + (2 * (kt % STAGES)) * L::kv; };
    auto phase = [](int kt) { return uint32_t((kt / STAGES) & 1); };
    auto mask_tile = [&](int k0) {
      return k0 + BK > S || k0 + BK - 1 > warp_qpos;
    };

    RowState rs;
    float o[D / 2];                  // O: [DT blocks][row g, g+8][2 cols]
    float s[BK / 2];                 // S, then P, in the same layout
    uint32_t p[BK / 16][4];          // P as bf16 A fragments
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;

    if (n_wg > 0) {
      float c0, c1;
      mbar_wait(bar_q, 0);
      // tile 0: S = Q K_0 and its softmax (O is still 0)
      mbar_wait(full_k, 0);
      fence_regs(s);
      turn_begin(0);
      wgmma_fence();
      issue_qk<D>(s, q_wg, tile_k(0));
      wgmma_commit();
      turn_end(0);
      wgmma_wait<0>();
      fence_regs(s);
      if (lane == 0) mbar_arrive(empty_k);
      online_softmax(s, rs, mask_tile(0), 0, S, t4, qpos0, qpos1, sl2, c0,
                     c1);
      pack_p(p, s);

      // steady state: S_kt = Q K_kt and O += P_{kt-1} V_{kt-1} in flight
      // together; tile kt's softmax runs while P V is still on the tensor
      // cores, and O is rescaled once P V has landed
      for (int kt = 1; kt < n_wg; ++kt) {
        const int st = kt % STAGES;
        const int pst = (kt - 1) % STAGES;
        mbar_wait(full_k + 8 * st, phase(kt));
        mbar_wait(full_v + 8 * pst, phase(kt - 1));
        fence_regs(s);
        fence_regs(o);
        turn_begin(kt);
        wgmma_fence();
        issue_qk<D>(s, q_wg, tile_k(kt));
        wgmma_commit();
        issue_pv<D>(o, p, tile_k(kt - 1) + L::kv);
        wgmma_commit();
        turn_end(kt);
        wgmma_wait<1>();
        fence_regs(s);
        if (lane == 0) mbar_arrive(empty_k + 8 * st);
        online_softmax(s, rs, mask_tile(kt * BK), kt * BK, S, t4, qpos0,
                       qpos1, sl2, c0, c1);
        wgmma_wait<0>();
        fence_regs(o);
        if (lane == 0) mbar_arrive(empty_v + 8 * pst);
#pragma unroll
        for (int n = 0; n < DT; ++n) {
          o[4 * n] *= c0;
          o[4 * n + 1] *= c0;
          o[4 * n + 2] *= c1;
          o[4 * n + 3] *= c1;
        }
        pack_p(p, s);
      }

      // the last tile's O += P V
      const int last = n_wg - 1;
      mbar_wait(full_v + 8 * (last % STAGES), phase(last));
      fence_regs(o);
      turn_begin(n_wg);
      wgmma_fence();
      issue_pv<D>(o, p, tile_k(last) + L::kv);
      wgmma_commit();
      turn_end(n_wg);
      wgmma_wait<0>();
      fence_regs(o);
      if (lane == 0) mbar_arrive(empty_v + 8 * (last % STAGES));
    }
    // tiles wholly above this warpgroup's causal edge: release them unread
    for (int kt = n_wg; kt < n_kt; ++kt) {
      mbar_wait(full_k + 8 * (kt % STAGES), phase(kt));
      if (lane == 0) mbar_arrive(empty_k + 8 * (kt % STAGES));
      mbar_wait(full_v + 8 * (kt % STAGES), phase(kt));
      if (lane == 0) mbar_arrive(empty_v + 8 * (kt % STAGES));
    }

    // O / max(l, 1e-30) as bf16 into this warpgroup's own rows of the Q
    // tile (its last Q K^T is done; the other warpgroup reads only its own
    // rows), in the same 128-byte-swizzled boxes, then one TMA store per
    // box to out [B, T, Hq, d]; rows past T are not written
    float l0 = rs.l0, l1 = rs.l1;
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.f / fmaxf(l0, 1e-30f);
    const float inv1 = 1.f / fmaxf(l1, 1e-30f);
    if (wg_row < T) {
      const int r0 = warp * 16 + g;         // row within the warpgroup's 64
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        // 16-byte chunk n % 8 of a 128-byte row sits at chunk ^ (row % 8)
        const uint32_t box = q_wg + (n / 8) * BQ * ROW_BYTES + t4 * 4;
        const uint32_t chunk = ((n % 8) ^ (r0 % 8)) * 16;   // rows r0, r0+8
        asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(
                         box + r0 * ROW_BYTES + chunk),
                     "r"(pack_bf16(o[4 * n] * inv0, o[4 * n + 1] * inv0))
                     : "memory");
        asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(
                         box + (r0 + 8) * ROW_BYTES + chunk),
                     "r"(pack_bf16(o[4 * n + 2] * inv1, o[4 * n + 3] * inv1))
                     : "memory");
      }
      // make the writes visible to TMA, then wait for the warpgroup
      // (named barrier 1 + cw, its 128 threads)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
      if (ct % 128 == 0) {
#pragma unroll
        for (int c = 0; c < NB; ++c)
          tma_store(&to, q_wg + c * BQ * ROW_BYTES, c * BOX, h, wg_row, b);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        // shared memory must outlive the store's reads of it
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      }
    }
  }
}

// ---- host side ------------------------------------------------------------

typedef CUresult (*EncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API call: reach it through the runtime
// (no link against libcuda).
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A [B, rows, H, D] bf16 tensor (element strides sb, sr, sh; d contiguous)
// as a 4-D tensor map with dims (D, H, rows, B), read in boxes of
// [box_rows][64 columns] with 128-byte swizzle; out-of-range rows read 0.
CUresult make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr,
                  int B, int rows, int H, int D, long long sb, long long sr,
                  long long sh, int box_rows) {
  cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(H),
                        cuuint64_t(rows > 0 ? rows : 1), cuuint64_t(B)};
  cuuint64_t strides[3] = {cuuint64_t(sh) * 2, cuuint64_t(sr) * 2,
                           cuuint64_t(sb) * 2};
  // a dimension of extent 1 is never stepped along: give it a packed stride
  if (H == 1) strides[0] = cuuint64_t(D) * 2;
  if (rows <= 1) strides[1] = strides[0] * H;
  if (B == 1) strides[2] = strides[1] * dims[2];
  cuuint32_t box[4] = {cuuint32_t(BOX), 1, cuuint32_t(box_rows), 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int D>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk,
                   const CUtensorMap& tv, const CUtensorMap& to, int B,
                   int T, int S, int Hq, int Hkv, int q_offset, float scale,
                   cudaStream_t stream) {
  constexpr int MAX_DEVICES = 64;
  static bool smem_set[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES || !smem_set[dev]) {
    err = cudaFuncSetAttribute(flash_prefill_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(Smem<D>::total));
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES) smem_set[dev] = true;
  }
  dim3 grid((T + BQ - 1) / BQ, Hq, B);
  flash_prefill_kernel<D><<<grid, THREADS, Smem<D>::total, stream>>>(
      tq, tk, tv, to, T, S, Hq, Hkv, q_offset, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). Strides are in elements; the
// last dimension of q, k and v must be contiguous, the base addresses
// 16-byte aligned and the other strides multiples of 8 elements (TMA's
// rules). Returns 0 when launched, a cudaError_t (> 0) when the launch
// failed, -1 when the driver has no cuTensorMapEncodeTiled, and
// -(1000 + CUresult) when a tensor map was refused.
extern "C" int flash_prefill_bf16(
    const void* q, const void* k, const void* v, void* out,
    int B, int T, int S, int Hq, int Hkv, int d,
    long long qsb, long long qst, long long qsh,
    long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh,
    int q_offset, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T == 0 || B == 0) return int(cudaSuccess);
  if (d != 64 && d != 128) return int(cudaErrorInvalidValue);
  EncodeTiled encode = encode_fn();
  if (encode == nullptr) return -1;
  CUtensorMap tq, tk, tv, to;
  CUresult r = make_map(encode, &tq, q, B, T, Hq, d, qsb, qst, qsh, BQ);
  if (r == CUDA_SUCCESS)
    r = make_map(encode, &tk, k, B, S, Hkv, d, ksb, kss, ksh, BK);
  if (r == CUDA_SUCCESS)
    r = make_map(encode, &tv, v, B, S, Hkv, d, vsb, vss, vsh, BK);
  // out is [B, T, Hq * d] contiguous: [B, T, Hq, d], stored 64 rows a box
  const long long ot = (long long)Hq * d;
  if (r == CUDA_SUCCESS)
    r = make_map(encode, &to, out, B, T, Hq, d, T * ot, ot, d, WG_ROWS);
  if (r != CUDA_SUCCESS) return -(1000 + int(r));
  if (d == 128)
    return int(launch<128>(tq, tk, tv, to, B, T, S, Hq, Hkv, q_offset,
                           scale, st));
  return int(launch<64>(tq, tk, tv, to, B, T, S, Hq, Hkv, q_offset, scale,
                        st));
}

// Dynamic shared memory of one CTA for head_dim d (0 if unsupported).
extern "C" int flash_prefill_smem_bytes(int d) {
  if (d == 128) return int(Smem<128>::total);
  if (d == 64) return int(Smem<64>::total);
  return 0;
}
