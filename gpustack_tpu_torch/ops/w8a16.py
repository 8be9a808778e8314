"""Weight-only int8 matrix product (W8A16): a hand-written Hopper kernel and
its plain PyTorch version.

``out[M, N] = (x[M, K] @ q[K, N]) * s[N]``: x in the compute dtype, q int8
in the JAX package's ``[in, out]`` layout, s the per-output-channel scale.
The kernel (``csrc/w8a16_gemm.cu``, CUDA C++ for ``sm_90a``, bound with
``ctypes``) sums and scales in fp32 and writes bf16; the int8 weight is
widened in registers (decode GEMV, M <= 16) or once per CTA in shared memory
(the TMA-fed ``wgmma`` path above), never written back dequantized.

There is no Pallas kernel behind it: in the JAX package this is the int8
branch of ``_mm`` (``gpustack_tpu/models/transformer.py:46-47``), which
XLA fuses. Bound on the card: bytes at decode (w_gate at M = 8: 58.7 MB,
~17.5 us at 3.35 TB/s), operations at prefill (M = 2048: 240.5 GFLOP,
~0.243 ms at 989 TFLOP/s bf16).

``w8a16_bmm`` is the same product batched over an MoE layer's experts,
``out[e] = (x[e] @ q[e]) * s[e]`` with q ``[E, K, N]`` and s ``[E, N]``,
in one launch: the dense-dispatch expert products of the JAX
``_moe_mlp``'s int8 branch (``gpustack_tpu/models/transformer.py:487-502``,
``_mm`` over the expert axis; again an XLA fusion). x is read through its
batch stride: 0 for the gate and up products (x expanded over the experts,
read in place), the expert's column block of h for the down product.

Each wrapper launches its kernel for CUDA tensors (or raises: no fallback
on the card) and takes its plain version only for CPU tensors. Its
``launches`` counts kernel calls, and ``launches_by_path`` splits them into
``gemv`` (M <= 16 rows per expert) and ``wgmma``.
"""

from __future__ import annotations

import ctypes

import torch

GEMV_MAX_M = 16            # csrc: w8a16_gemv_max_m()
GEMV_BN = 128              # columns per GEMV CTA
GEMV_KSTEP = 16            # k rows per mma step
GEMV_WARPS = 8             # warps per GEMV CTA, each on its own k steps
MAX_KSPLIT = 8             # csrc: w8a16_max_ksplit() (one cluster)
MAX_EXPERTS = 65535 // MAX_KSPLIT   # csrc: w8a16_max_experts() (grid z)
WGMMA_BM = 128             # csrc: w8a16_wgmma_tile_m(), rows per CTA
WGMMA_BK = 64              # k rows per stage of the wgmma path
WGMMA_MIN_KTILES = 8       # k stages a CTA of a split keeps at least

_lib = None


def _kernel_lib():
    """The compiled library (built on first call); besides the product it
    reports the GEMV's CTAs per SM (``w8a16_gemv_ctas_per_sm(M)``)."""
    from gpustack_tpu_torch.ops._build import load

    return load("w8a16_gemm")


def _kernel(batched: bool = False):
    """The compiled library's entry point, the 2-D ``w8a16_gemm_bf16`` or
    the batched ``w8a16_bmm_bf16``; the library's ABI checked once."""
    global _lib
    if _lib is None:
        lib = _kernel_lib()
        if (
            lib.w8a16_gemv_max_m() != GEMV_MAX_M
            or lib.w8a16_max_ksplit() != MAX_KSPLIT
            or lib.w8a16_wgmma_tile_m() != WGMMA_BM
            or lib.w8a16_max_experts() != MAX_EXPERTS
        ):
            raise RuntimeError("w8a16_gemm.cu and ops/w8a16.py disagree")
        gemm, bmm = lib.w8a16_gemm_bf16, lib.w8a16_bmm_bf16
        gemm.restype = bmm.restype = ctypes.c_int
        gemm.argtypes = (
            [ctypes.c_void_p] * 4
            + [ctypes.c_int] * 3
            + [ctypes.c_longlong] * 3
            + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        )
        bmm.argtypes = (
            [ctypes.c_void_p] * 4
            + [ctypes.c_int] * 4
            + [ctypes.c_longlong] * 7
            + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        )
        _lib = (gemm, bmm)
    return _lib[batched]


def w8a16_plain(
    x: torch.Tensor, q: torch.Tensor, s: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version: contract x against q widened to fp32, scale
    the fp32 result by s, return in x's dtype. In fp32 this is the JAX
    ``_mm`` int8 branch exactly (``x @ q.astype(f32) * s.astype(f32)``);
    in bf16 it is the kernel's arithmetic with one rounding at the end."""
    out = x.float() @ q.float()
    return (out * s.float()).to(x.dtype)


def gemv_plan(N: int, K: int, sms: int, E: int = 1) -> tuple:
    """(kchunk, ksplit) for the small-M path: K is split over ``ksplit``
    CTAs (one cluster, at most ``MAX_KSPLIT``, each warp with at least
    one 16-row step) only until the grid, ``E`` experts of column slices,
    has a CTA for every SM. A CTA's sums and its cluster's reduction cost
    the same however few rows it reads, so on the card fewer and longer
    CTAs stream closer to the memory rate than a grid cut finer to fill
    whole waves."""
    nb = -(-N // GEMV_BN) * E
    steps = -(-K // GEMV_KSTEP)
    cap = max(1, min(MAX_KSPLIT, steps // GEMV_WARPS))
    ksplit = min(cap, -(-sms // nb))
    kchunk = -(-steps // ksplit) * GEMV_KSTEP
    return kchunk, -(-K // kchunk)


def wgmma_plan(M: int, N: int, K: int, sms: int, E: int = 1) -> tuple:
    """(BN, grid_m, grid_n, kchunk, ksplit) for the large-M path: CTAs of
    ``WGMMA_BM`` x BN outputs for each of ``E`` experts, BN 256 (each x
    tile feeds twice the columns, so fewer shared-memory bytes per
    product) when that grid still gives every SM a CTA, else 128. A grid
    smaller than the card splits K over ``ksplit`` CTAs of one cluster
    (``kchunk`` rows each, at least ``WGMMA_MIN_KTILES`` stages), so the
    weights stream from every SM. The grid's x axis walks M, so CTAs that
    run together share weight columns."""
    grid_m = -(-M // WGMMA_BM)
    slices = E * -(-N // 256)       # 256-wide column tiles of every expert
    bn = 256 if grid_m * slices >= sms else 128
    grid_n = -(-N // bn)
    ktiles = -(-K // WGMMA_BK)
    cap = max(1, min(
        MAX_KSPLIT, sms // (E * grid_m * grid_n), ktiles // WGMMA_MIN_KTILES
    ))
    per = -(-ktiles // cap)
    return bn, grid_m, grid_n, per * WGMMA_BK, -(-ktiles // per)


_sms = {}


def _sm_count(dev: int) -> int:
    n = _sms.get(dev)
    if n is None:
        n = _sms[dev] = torch.cuda.get_device_properties(
            dev
        ).multi_processor_count
    return n


def shape_refusal(K: int, N: int) -> str:
    """Why the kernel cannot take a weight of ``K`` input and ``N`` output
    columns ("" when it can): its TMA maps read 16-byte rows of x (K % 8
    bf16) and of q (N % 16 int8). The engine asks this of every int8 leaf
    before it reads a weight."""
    if K % 8 or N % 16:
        return (
            "W8A16 kernel needs K % 8 == 0 and N % 16 == 0 (16-byte rows); "
            f"got K {K}, N {N}"
        )
    return ""


def _check_cuda_inputs(x, q, s) -> None:
    """Raise on what the kernel cannot take (x is already 2-D)."""
    M, K = x.shape
    if q.dim() != 2 or q.shape[0] != K or s.shape != (q.shape[1],):
        raise ValueError(
            f"x {tuple(x.shape)}, q {tuple(q.shape)}, s {tuple(s.shape)}: "
            "want x [M, K], q [K, N], s [N]"
        )
    if x.dtype != torch.bfloat16 or s.dtype != torch.bfloat16:
        raise TypeError(
            f"W8A16 kernel takes bf16 x and s; got {x.dtype}, {s.dtype}"
        )
    if q.dtype != torch.int8:
        raise TypeError(f"W8A16 kernel takes int8 q; got {q.dtype}")
    N = q.shape[1]
    refusal = shape_refusal(K, N)
    if refusal:
        raise ValueError(refusal)
    if q.device != x.device or s.device != x.device:
        raise ValueError(f"x, q, s on {x.device}, {q.device}, {s.device}")
    if (
        q.stride(1) != 1 or q.stride(0) % 16 or q.data_ptr() % 16
        or x.stride(0) % 8 or x.data_ptr() % 16 or not s.is_contiguous()
    ):
        raise ValueError(
            "W8A16 kernel needs 16-byte aligned rows with a contiguous last "
            f"dimension (x strides {x.stride()}, q strides {q.stride()})"
        )


def w8a16_matmul(
    x: torch.Tensor, q: torch.Tensor, s: torch.Tensor
) -> torch.Tensor:
    """``(x @ q) * s`` over x's last axis: x ``[..., K]``, q ``[K, N]``
    int8, s ``[N]``. Returns ``[..., N]`` in x's dtype."""
    lead, K = x.shape[:-1], x.shape[-1]
    if not x.is_cuda:
        if x.device.type == "cpu":
            return w8a16_plain(x, q, s)
        raise ValueError(f"unsupported device {x.device}")
    x2 = x.reshape(-1, K)
    if x2.stride(-1) != 1 or x2.stride(0) % 8 or x2.data_ptr() % 16:
        x2 = x2.contiguous()
    _check_cuda_inputs(x2, q, s)
    M, N = x2.shape[0], q.shape[1]
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    sms = _sm_count(x.device.index)
    if M <= GEMV_MAX_M:
        path, bn, kchunk = "gemv", 0, gemv_plan(N, K, sms)[0]
    else:
        path = "wgmma"
        bn, _, _, kchunk, _ = wgmma_plan(M, N, K, sms)
    err = _kernel()(
        x2.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(),
        M, N, K, x2.stride(0), q.stride(0), N, bn, kchunk,
        torch._C._cuda_getCurrentRawStream(x.device.index),
    )
    if err != 0:
        raise RuntimeError(
            f"w8a16_gemm_bf16 launch failed: {err} (> 0 a cudaError, -1 no "
            "tensor-map encoder, -(1000 + CUresult) a refused tensor map)"
        )
    w8a16_matmul.launches += 1
    w8a16_matmul.launches_by_path[path] += 1
    return out.reshape(*lead, N)


w8a16_matmul.launches = 0
w8a16_matmul.launches_by_path = {"gemv": 0, "wgmma": 0}


def w8a16_bmm_plain(
    x: torch.Tensor, q: torch.Tensor, s: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version of :func:`w8a16_bmm`: each expert's product
    against its weight widened to fp32, scaled in fp32, in x's dtype (one
    expert's fp32 weight at a time). In fp32 this is the JAX ``_mm``
    int8 branch over the expert axis exactly; in bf16 it is the kernel's
    arithmetic with one rounding at the end."""
    out = torch.empty(
        (q.shape[0], x.shape[1], q.shape[2]), dtype=x.dtype, device=x.device
    )
    for e in range(q.shape[0]):
        out[e] = w8a16_plain(x[e], q[e], s[e])
    return out


def _bmm_strides(x, q, s) -> tuple:
    """(ldx, xb, ldq, qb, sb) for the batched kernel; raises on what it
    cannot take (x is [E, M, K], its batch stride 0 or not)."""
    E, M, K = x.shape
    if (
        q.dim() != 3 or q.shape[:2] != (E, K)
        or s.shape != (E, q.shape[2])
    ):
        raise ValueError(
            f"x {tuple(x.shape)}, q {tuple(q.shape)}, s {tuple(s.shape)}: "
            "want x [E, M, K], q [E, K, N], s [E, N]"
        )
    if x.dtype != torch.bfloat16 or s.dtype != torch.bfloat16:
        raise TypeError(
            f"W8A16 kernel takes bf16 x and s; got {x.dtype}, {s.dtype}"
        )
    if q.dtype != torch.int8:
        raise TypeError(f"W8A16 kernel takes int8 q; got {q.dtype}")
    N = q.shape[2]
    refusal = shape_refusal(K, N)
    if refusal:
        raise ValueError(refusal)
    if E > MAX_EXPERTS:
        raise ValueError(f"W8A16 kernel takes at most {MAX_EXPERTS} experts")
    if q.device != x.device or s.device != x.device:
        raise ValueError(f"x, q, s on {x.device}, {q.device}, {s.device}")
    # a stride of a size-1 dimension is never stepped: take the packed one
    ldx = x.stride(1) if M > 1 else K
    xb = x.stride(0) if E > 1 else 0
    if (
        q.stride(2) != 1 or q.stride(1) % 16 or q.stride(0) % 16
        or q.data_ptr() % 16 or x.stride(2) != 1 or ldx % 8 or xb % 8
        or x.data_ptr() % 16 or s.stride(1) != 1
    ):
        raise ValueError(
            "W8A16 kernel needs 16-byte aligned rows and batch strides with "
            f"a contiguous last dimension (x strides {x.stride()}, q strides "
            f"{q.stride()}, s strides {s.stride()})"
        )
    return ldx, xb, q.stride(1), q.stride(0), s.stride(0)


def w8a16_bmm(
    x: torch.Tensor, q: torch.Tensor, s: torch.Tensor
) -> torch.Tensor:
    """``out[e] = (x[e] @ q[e]) * s[e]`` for every expert e, in one launch:
    x ``[E, M, K]`` (any batch stride, 0 included: ``xt.expand(E, M, K)``
    is read in place; rows 16-byte aligned), q ``[E, K, N]`` int8, s ``[E,
    N]``. Returns ``[E, M, N]`` in x's dtype."""
    if not x.is_cuda:
        if x.device.type == "cpu":
            return w8a16_bmm_plain(x, q, s)
        raise ValueError(f"unsupported device {x.device}")
    ldx, xb, ldq, qb, sb = _bmm_strides(x, q, s)
    E, M, K = x.shape
    N = q.shape[2]
    out = torch.empty((E, M, N), dtype=torch.bfloat16, device=x.device)
    sms = _sm_count(x.device.index)
    if M <= GEMV_MAX_M:
        path, bn, kchunk = "gemv", 0, gemv_plan(N, K, sms, E)[0]
    else:
        path = "wgmma"
        bn, _, _, kchunk, _ = wgmma_plan(M, N, K, sms, E)
    err = _kernel(batched=True)(
        x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(),
        E, M, N, K, ldx, xb, ldq, qb, sb, N, M * N, bn, kchunk,
        torch._C._cuda_getCurrentRawStream(x.device.index),
    )
    if err != 0:
        raise RuntimeError(
            f"w8a16_bmm_bf16 launch failed: {err} (> 0 a cudaError, -1 no "
            "tensor-map encoder, -(1000 + CUresult) a refused tensor map)"
        )
    w8a16_bmm.launches += 1
    w8a16_bmm.launches_by_path[path] += 1
    return out


w8a16_bmm.launches = 0
w8a16_bmm.launches_by_path = {"gemv": 0, "wgmma": 0}
