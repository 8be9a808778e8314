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

``w8a16_grouped`` is the routed expert product of an MoE layer: the
(token, expert) pairs of a token chunk sorted by expert, ``x [P, K]``, with
``offsets [E + 1]`` bounding each expert's segment, and
``out[r] = (x[r] @ q[e(r)]) * s[e(r)]`` for q ``[E, K, N]``, s ``[E, N]``:
only the experts some token picked are read. ``bf16_grouped`` is the same
kernel with bf16 expert weights and no scale. They stand for the JAX
``_moe_mlp``'s dense-dispatch expert products
(``gpustack_tpu/models/transformer.py:487-502``, ``_mm`` or ``einsum``
over the expert axis; XLA products there, no Pallas kernel) with the same
values up to summation order. The host never reads ``offsets``: above 16
rows an expert one persistent CTA per SM walks the units (BM rows x BN
columns of one expert) that the offsets make, each CTA building its table
on the card; :func:`grouped_plan` picks BM, BN and the grid from host
integers alone, so the serving loop never waits on the device.

Each wrapper launches its kernel for CUDA tensors (or raises: no fallback
on the card) and takes its plain version only for CPU tensors. Its
``launches`` counts kernel calls, and ``launches_by_path`` splits them into
``gemv`` (at most 16 rows per expert) and ``wgmma``.
"""

from __future__ import annotations

import ctypes

import torch

GEMV_MAX_M = 16            # csrc: w8a16_gemv_max_m()
GEMV_BN = 128              # columns per GEMV CTA
GEMV_KSTEP = 16            # k rows per mma step
GEMV_WARPS = 8             # warps per GEMV CTA, each on its own k steps
MAX_KSPLIT = 8             # csrc: w8a16_max_ksplit() (one cluster)
MAX_EXPERTS = 65535        # csrc: w8a16_max_experts() (the GEMV's grid z)
WGMMA_BM = 128             # csrc: w8a16_wgmma_tile_m(), rows per CTA
WGMMA_BK = 64              # k rows per stage of the wgmma path
WGMMA_MIN_KTILES = 8       # k stages a CTA of a split keeps at least
# the grouped kernel's plan (csrc: grouped_wgmma)
GROUPED_TABLE_EXPERTS = 1024   # csrc: w8a16_grouped_table_experts()
GROUPED_BN = {"bf16": (128, 192, 256), "int8": (128, 256)}
GROUPED_BM128_ROWS = 384   # bf16: mean rows an expert from which units
                           # hold 128 (gpt-oss-20b's 256 ran faster at 64,
                           # mixtral-8x7b's 512 at 128)

_lib = None


def _kernel_lib():
    """The compiled library (built on first call); besides the product it
    reports the GEMV's CTAs per SM (``w8a16_gemv_ctas_per_sm(M)``)."""
    from gpustack_tpu_torch.ops._build import load

    return load("w8a16_gemm")


def _kernel(entry: str = "gemm"):
    """The compiled library's entry point: the 2-D ``w8a16_gemm_bf16``,
    the grouped ``w8a16_grouped_bf16`` or ``bf16_grouped_bf16``; the
    library's ABI checked once."""
    global _lib
    if _lib is None:
        lib = _kernel_lib()
        if (
            lib.w8a16_gemv_max_m() != GEMV_MAX_M
            or lib.w8a16_max_ksplit() != MAX_KSPLIT
            or lib.w8a16_wgmma_tile_m() != WGMMA_BM
            or lib.w8a16_max_experts() != MAX_EXPERTS
            or lib.w8a16_grouped_table_experts() != GROUPED_TABLE_EXPERTS
        ):
            raise RuntimeError("w8a16_gemm.cu and ops/w8a16.py disagree")
        gemm = lib.w8a16_gemm_bf16
        gemm.argtypes = (
            [ctypes.c_void_p] * 4
            + [ctypes.c_int] * 3
            + [ctypes.c_longlong] * 3
            + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        )
        int8 = lib.w8a16_grouped_bf16
        int8.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [
            ctypes.c_void_p
        ]
        bf16 = lib.bf16_grouped_bf16
        bf16.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [
            ctypes.c_void_p
        ]
        _lib = {"gemm": gemm, "int8": int8, "bf16": bf16}
        for fn in _lib.values():
            fn.restype = ctypes.c_int
    return _lib[entry]


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
    one 16-row step) only until the grid's working CTAs, column slices of
    ``E`` experts (a grouped call passes the most experts its rows can
    reach, ``min(E, P)``), have one for every SM. A CTA's sums and its
    cluster's reduction cost the same however few rows it reads, so on the
    card fewer and longer CTAs stream closer to the memory rate than a
    grid cut finer to fill whole waves."""
    nb = -(-N // GEMV_BN) * E
    steps = -(-K // GEMV_KSTEP)
    cap = max(1, min(MAX_KSPLIT, steps // GEMV_WARPS))
    ksplit = min(cap, -(-sms // nb))
    kchunk = -(-steps // ksplit) * GEMV_KSTEP
    return kchunk, -(-K // kchunk)


def wgmma_plan(M: int, N: int, K: int, sms: int) -> tuple:
    """(BN, grid_m, grid_n, kchunk, ksplit) for the 2-D large-M path: CTAs
    of ``WGMMA_BM`` x BN outputs, ``grid_m`` row tiles, BN 256 (each x
    tile feeds twice the columns, so fewer shared-memory bytes per
    product) when that grid still gives every SM a CTA, else 128. A grid
    smaller than the card splits K over ``ksplit`` CTAs of one cluster
    (``kchunk`` rows each, at least ``WGMMA_MIN_KTILES`` stages), so the
    weights stream from every SM. The grid's x axis walks the rows, so
    CTAs that run together share weight columns."""
    grid_m = -(-M // WGMMA_BM)
    bn = 256 if grid_m * -(-N // 256) >= sms else 128
    grid_n = -(-N // bn)
    ktiles = -(-K // WGMMA_BK)
    cap = max(1, min(
        MAX_KSPLIT, sms // (grid_m * grid_n), ktiles // WGMMA_MIN_KTILES
    ))
    per = -(-ktiles // cap)
    return bn, grid_m, grid_n, per * WGMMA_BK, -(-ktiles // per)


def grouped_plan(P: int, E: int, N: int, sms: int, int8: bool) -> tuple:
    """(BM, BN, grid) of the grouped kernel over ``P`` sorted rows
    of ``E`` experts, from host integers alone (the counts stay on the
    card):

    - BM: int8, 128-row units always (a widened tile feeds both consumer
      warpgroups: at 64 rows the widening stage set the pace of every int8
      product on the card); bf16, 128 once the mean rows an expert ``P /
      E`` reach ``GROUPED_BM128_ROWS``, below 64-row units taken in turn
      by the two consumers, which cut the ragged last unit of each expert;
    - BN: of the widths the kernel takes (int8's widening stage maps 128
      and 256), the one whose units load the fewest bytes of x and weight
      tiles a k-stage, ``ceil(N / BN) * 64 * (2 BM + wb BN)``, then the
      fewest column tiles: each column tile reloads its x rows, so at
      every served width a 256-wide tile beats the narrower ones that
      pad fewer columns (192 at N = 2880, 128 at 1408 ran slower);
    - grid: one CTA per SM, fewer only where the worst case of units,
      ``(ceil(P / BM) + min(E, P)) * ceil(N / BN)``, is smaller."""
    bm = 128 if int8 or P >= GROUPED_BM128_ROWS * E else 64
    wb = 1 if int8 else 2

    def loaded(w):
        tiles = -(-N // w)
        return tiles * WGMMA_BK * (bm * 2 + w * wb), tiles

    bn = min(GROUPED_BN["int8" if int8 else "bf16"], key=loaded)
    units = (-(-P // bm) + min(E, P)) * -(-N // bn)
    return bm, bn, max(1, min(sms, units))


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
    # the library launches on the calling thread's current device
    with torch.cuda.device(x.device):
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


def w8a16_grouped_plain(
    x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, offsets: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version of :func:`w8a16_grouped`: a loop over the
    experts' segments (``offsets.tolist()``: the host reads the counts),
    each through :func:`w8a16_plain`. In fp32 this is the JAX ``_mm``
    int8 branch row for row; in bf16 the kernel's arithmetic with one
    rounding at the end."""
    out = torch.empty(
        (x.shape[0], q.shape[-1]), dtype=x.dtype, device=x.device
    )
    bounds = offsets.tolist()
    for e in range(q.shape[0]):
        a, b = bounds[e], bounds[e + 1]
        if b > a:
            out[a:b] = w8a16_plain(x[a:b], q[e], s[e])
    return out


def bf16_grouped_plain(
    x: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version of :func:`bf16_grouped`: each segment's rows
    times its expert's weight, both widened to fp32, rounded once to x's
    dtype (in fp32 JAX's ``einsum`` row for row)."""
    out = torch.empty(
        (x.shape[0], w.shape[-1]), dtype=x.dtype, device=x.device
    )
    bounds = offsets.tolist()
    for e in range(w.shape[0]):
        a, b = bounds[e], bounds[e + 1]
        if b > a:
            out[a:b] = (x[a:b].float() @ w[e].float()).to(x.dtype)
    return out


def _check_grouped(x, w, s, offsets) -> None:
    """Raise on what the grouped kernel cannot take: x ``[P, K]`` bf16,
    w ``[E, K, N]`` (int8 with s ``[E, N]`` bf16, or bf16 with no s),
    offsets ``[E + 1]`` int32, all contiguous on one card."""
    if (
        x.dim() != 2 or w.dim() != 3 or w.shape[1] != x.shape[1]
        or offsets.shape != (w.shape[0] + 1,)
        or (s is not None and s.shape != (w.shape[0], w.shape[2]))
    ):
        raise ValueError(
            f"x {tuple(x.shape)}, w {tuple(w.shape)}, offsets "
            f"{tuple(offsets.shape)}: want x [P, K], w [E, K, N], offsets "
            "[E + 1]" + ("" if s is None else f", s [E, N] (s {tuple(s.shape)})")
        )
    wtype = torch.int8 if s is not None else torch.bfloat16
    if (
        x.dtype != torch.bfloat16 or w.dtype != wtype
        or (s is not None and s.dtype != torch.bfloat16)
        or offsets.dtype != torch.int32
    ):
        raise TypeError(
            f"grouped kernel takes bf16 x, {wtype} w"
            + (", bf16 s" if s is not None else "")
            + f" and int32 offsets; got {x.dtype}, {w.dtype}, "
            + (f"{s.dtype}, " if s is not None else "") + f"{offsets.dtype}"
        )
    refusal = shape_refusal(x.shape[1], w.shape[2])
    if refusal:
        raise ValueError(refusal)
    if w.shape[0] > MAX_EXPERTS:
        raise ValueError(f"grouped kernel takes at most {MAX_EXPERTS} experts")
    tensors = (x, w, offsets) + (() if s is None else (s,))
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"tensors on {[str(t.device) for t in tensors]}")
    if any(not t.is_contiguous() or t.data_ptr() % 16 for t in tensors):
        raise ValueError(
            "grouped kernel needs contiguous, 16-byte aligned x, w, s and "
            "offsets"
        )


def _grouped_launch(entry, wrapper, x, w, s, offsets, max_rows):
    """Plan and launch one grouped product; count it on ``wrapper``."""
    _check_grouped(x, w, s, offsets)
    P, K = x.shape
    E, _, N = w.shape
    out = torch.empty((P, N), dtype=torch.bfloat16, device=x.device)
    sms = _sm_count(x.device.index)
    if max_rows <= GEMV_MAX_M:
        path, plan = "gemv", (0, 0, 0)
        kchunk = gemv_plan(N, K, sms, min(E, P))[0]
    else:
        path, kchunk = "wgmma", 0
        plan = grouped_plan(P, E, N, sms, s is not None)
    ptrs = [x.data_ptr(), w.data_ptr()] + (
        [] if s is None else [s.data_ptr()]
    ) + [offsets.data_ptr(), out.data_ptr()]
    with torch.cuda.device(x.device):
        err = _kernel(entry)(
            *ptrs, E, P, N, K, max_rows, kchunk, *plan,
            torch._C._cuda_getCurrentRawStream(x.device.index),
        )
    if err != 0:
        raise RuntimeError(
            f"{entry} grouped launch failed: {err} (> 0 a cudaError, -1 no "
            "tensor-map encoder, -(1000 + CUresult) a refused tensor map)"
        )
    wrapper.launches += 1
    wrapper.launches_by_path[path] += 1
    return out


def w8a16_grouped(
    x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
    offsets: torch.Tensor, max_rows: int,
) -> torch.Tensor:
    """``out[r] = (x[r] @ q[e]) * s[e]`` for the rows ``offsets[e] <= r <
    offsets[e + 1]`` of every expert e, in one launch: x ``[P, K]`` (the
    pairs sorted by expert), q ``[E, K, N]`` int8, s ``[E, N]``, offsets
    ``[E + 1]`` int32 on x's device, ``max_rows`` the most rows any one
    segment may hold (a token chunk's token count: a token picks an expert
    once), which picks the path. Returns ``[P, N]`` in x's dtype."""
    if not x.is_cuda:
        if x.device.type == "cpu":
            return w8a16_grouped_plain(x, q, s, offsets)
        raise ValueError(f"unsupported device {x.device}")
    return _grouped_launch("int8", w8a16_grouped, x, q, s, offsets, max_rows)


w8a16_grouped.launches = 0
w8a16_grouped.launches_by_path = {"gemv": 0, "wgmma": 0}


def bf16_grouped(
    x: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor, max_rows: int
) -> torch.Tensor:
    """``out[r] = x[r] @ w[e]`` for the rows of every expert's segment, as
    :func:`w8a16_grouped` with bf16 expert weights ``[E, K, N]`` and no
    scale. On the CPU the plain version takes any float dtype."""
    if not x.is_cuda:
        if x.device.type == "cpu":
            return bf16_grouped_plain(x, w, offsets)
        raise ValueError(f"unsupported device {x.device}")
    return _grouped_launch("bf16", bf16_grouped, x, w, None, offsets, max_rows)


bf16_grouped.launches = 0
bf16_grouped.launches_by_path = {"gemv": 0, "wgmma": 0}
