"""Causal GQA flash-attention prefill: a hand-written Hopper kernel and its
plain PyTorch version.

The kernel (``csrc/flash_attention.cu``, CUDA C++ for ``sm_90a``, bound
with ``ctypes``) replaces the Pallas TPU kernel
``gpustack_tpu/ops/flash_attention.py`` (``_flash_kernel``, launched by
``flash_attention_prefill``). Same function and public layout: q
``[B, T, Hq, d]`` at absolute positions ``q_offset .. q_offset+T-1``
against k, v ``[B, S, Hkv, d]``; returns ``[B, T, Hq*d]`` in q's dtype.
The kernel takes d of 64, 128, 192 (DeepSeek's MLA served decompressed:
K is qk_nope + qk_rope = 192 wide, V zero-padded to it) and 256 (Gemma).
The engine refuses at build a config that would take it at any other d
(``transformer.check_flash_head_dim``).

Bound on the card: compute. One causal call at llama3-8b widths
(T = S = 2048, Hq 32, d 128) is ~34.4 GFLOP (~35 us at 989 TFLOP/s bf16)
against ~42 MB of traffic (~12.5 us at 3.35 TB/s). The kernel keeps the
[T, S] scores out of device memory, runs both products on bf16 tensor
cores and stops each q-tile's key loop at its causal edge; see the CUDA
source's header for the block design.

``flash_attention_prefill`` launches the kernel for a CUDA tensor (or
raises: there is no fallback on the card) and takes the plain version only
for a CPU tensor. ``flash_attention_lse`` is the same kernel in its LSE
mode (the C entry ``flash_prefill_lse_f32``), one block of the ring
attention of a sequence-parallel prefill (``ops/ring_attention.py``): it
returns the normalised partial output and each row's log-sum-exp, both
fp32, and ``flash_attention_lse_ref`` is its plain version.
``flash_attention_prefill.launches`` counts the kernel's launches in both
modes, and ``flash_attention_prefill.launches_by_path`` splits them
(``"causal"``, ``"lse"``).
"""

from __future__ import annotations

import ctypes

import torch

_NEG = -1e30
SUPPORTED_HEAD_DIMS = (64, 128, 192, 256)

_entries = {}


def _kernel(entry: str = "flash_prefill_bf16"):
    """A C entry point of the compiled library (built on first call):
    ``flash_prefill_bf16`` (four pointers) or ``flash_prefill_lse_f32``
    (five)."""
    fn = _entries.get(entry)
    if fn is None:
        from gpustack_tpu_torch.ops._build import load

        fn = getattr(load("flash_attention"), entry)
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * (5 if entry == "flash_prefill_lse_f32" else 4)
            + [ctypes.c_int] * 6
            + [ctypes.c_longlong] * 9
            + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        )
        _entries[entry] = fn
    return fn


def flash_attention_prefill_ref(
    q: torch.Tensor,        # [B, T, Hq, d]
    k: torch.Tensor,        # [B, S, Hkv, d]
    v: torch.Tensor,        # [B, S, Hkv, d]
    scale: float,
    q_offset: int = 0,
) -> torch.Tensor:
    """Plain PyTorch version: fp32 scores and softmax, GQA without
    repeating KV, keys at index >= S and above the (offset) diagonal
    masked. Returns [B, T, Hq*d] in q's dtype."""
    B, T, Hq, d = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qf = q.float().reshape(B, T, Hkv, G, d) * scale
    scores = torch.einsum("bthgd,bshd->bhgts", qf, k.float())
    q_pos = q_offset + torch.arange(T, device=q.device)
    k_pos = torch.arange(S, device=q.device)
    mask = k_pos[None, :] <= q_pos[:, None]                     # [T, S]
    scores = scores.masked_fill(~mask, _NEG)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgts,bshd->bthgd", w, v.float())
    return out.reshape(B, T, Hq * d).to(q.dtype)


def flash_attention_lse_ref(
    q: torch.Tensor,        # [B, T, Hq, d]
    k: torch.Tensor,        # [B, S, Hkv, d]
    v: torch.Tensor,        # [B, S, Hkv, d]
    scale: float,
    q_offset: int = 0,
):
    """Plain version of the LSE mode, in fp32 math: ``(out [B, T, Hq*d],
    lse [B, Hq, T])``, ``out`` the causal attention of
    :func:`flash_attention_prefill_ref` before its downcast and ``lse``
    each row's natural log-sum-exp of its scaled visible scores. A row that
    sees no key gets 0 and an LSE of ``_NEG``, as the kernel gives."""
    B, T, Hq, d = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qf = q.float().reshape(B, T, Hkv, G, d) * scale
    scores = torch.einsum("bthgd,bshd->bhgts", qf, k.float())
    q_pos = q_offset + torch.arange(T, device=q.device)
    k_pos = torch.arange(S, device=q.device)
    mask = k_pos[None, :] <= q_pos[:, None]                     # [T, S]
    scores = scores.masked_fill(~mask, float("-inf"))
    lse = torch.logsumexp(scores, dim=-1)                       # [B,Hkv,G,T]
    seen = lse > _NEG / 2
    w = torch.where(seen[..., None], torch.exp(scores - lse[..., None]),
                    0.0)
    out = torch.einsum("bhgts,bshd->bthgd", w, v.float())
    lse = torch.where(seen, lse, _NEG)
    return out.reshape(B, T, Hq * d), lse.reshape(B, Hq, T)


def _check_cuda_inputs(q, k, v, scale) -> tuple:
    """Raise on what the kernel cannot take; return the nine element
    strides it reads q, k and v through ((batch, row, head) of each).
    ``scale`` must be positive and finite: the kernel takes each row's max
    of the raw scores and scales it after.

    The kernel reads each tensor through a TMA tensor map, whose rules
    these are: a contiguous last dimension, a 16-byte aligned base, strides
    that are multiples of 16 bytes and positive wherever the extent is
    above 1 (a broadcast dimension with stride 0 has no map). One quick
    test per tensor on the launch path; the reason is worked out only when
    it fails."""
    dev = q.get_device()
    strides = ()
    for t in (q, k, v):
        st = t.stride()
        if (
            t.dtype is not torch.bfloat16 or len(st) != 4 or st[3] != 1
            or st[0] % 8 or st[1] % 8 or st[2] % 8 or t.data_ptr() % 16
            or not (st[0] and st[1] and st[2]) or t.get_device() != dev
        ):
            _refuse(q, k, v)
        strides += st[:3]
    qs, ks = q.shape, k.shape
    if (
        ks != v.shape or qs[0] != ks[0] or qs[3] != ks[3]
        or qs[3] not in SUPPORTED_HEAD_DIMS
    ):
        _refuse(q, k, v)
    if not 0.0 < scale < float("inf"):
        raise ValueError(
            f"scale must be positive and finite, got {scale}: the kernel "
            "takes each row's max before scaling"
        )
    return strides


def _refuse(q, k, v) -> None:
    """Raise with the reason the kernel cannot take q, k, v (returns when
    the only oddity is a stride of 0 along an extent-1 dimension)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(
                f"flash kernel takes bfloat16; {name} is {t.dtype}"
            )
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D, got {tuple(t.shape)}")
        st = t.stride()
        if st[3] != 1:
            raise ValueError(f"{name}'s last dimension must be contiguous")
        if any(s % 8 for s in st[:3]) or t.data_ptr() % 16:
            raise ValueError(
                f"{name} rows must be 16-byte aligned (strides a multiple "
                "of 8 elements)"
            )
        if any(n > 1 and s <= 0 for n, s in zip(t.shape[:3], st[:3])):
            raise ValueError(
                f"{name} has a stride of 0 along a dimension of extent > 1 "
                f"(strides {st}): the kernel's TMA tensor maps need "
                "positive strides; pass a materialised tensor"
            )
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} != v {tuple(v.shape)}")
    if q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3]:
        raise ValueError(
            f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree on batch "
            "or head_dim"
        )
    if q.shape[3] not in SUPPORTED_HEAD_DIMS:
        raise ValueError(
            f"head_dim {q.shape[3]} unsupported (kernel takes "
            f"{SUPPORTED_HEAD_DIMS})"
        )


def _launch_error(err: int, entry: str = "flash_prefill_bf16") -> str:
    if err == -1:
        return (
            f"{entry}: the CUDA driver has no "
            "cuTensorMapEncodeTiled (TMA needs CUDA 12 on Hopper)"
        )
    if err <= -1000:
        return (
            f"{entry}: the driver refused a TMA tensor map "
            f"(CUresult {-1000 - err})"
        )
    return f"{entry} launch failed: cudaError {err}"


def flash_attention_prefill(
    q: torch.Tensor,        # [B, T, Hq, d]
    k: torch.Tensor,        # [B, S, Hkv, d]
    v: torch.Tensor,        # [B, S, Hkv, d]
    scale: float,
    q_offset: int = 0,
) -> torch.Tensor:
    """Causal GQA prefill attention; ``q_offset`` (a launch argument, never
    a rebuild) is the absolute position of q row 0, shared by every batch
    row. Returns [B, T, Hq*d] in q's dtype."""
    B, T, Hq, d = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if Hq % Hkv != 0:
        raise ValueError(
            f"q heads ({Hq}) must be a multiple of kv heads ({Hkv})"
        )
    q_offset = int(q_offset)
    if not q.is_cuda:
        if q.device.type == "cpu":
            return flash_attention_prefill_ref(q, k, v, scale, q_offset)
        raise ValueError(f"unsupported device {q.device}")
    strides = _check_cuda_inputs(q, k, v, scale)
    out = torch.empty((B, T, Hq * d), dtype=q.dtype, device=q.device)
    # the library launches on the calling thread's current device
    with torch.cuda.device(q.device):
        err = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, T, S, Hq, Hkv, d, *strides, q_offset, float(scale),
            torch._C._cuda_getCurrentRawStream(q.device.index),
        )
    if err != 0:
        raise RuntimeError(_launch_error(err))
    flash_attention_prefill.launches += 1
    flash_attention_prefill.launches_by_path["causal"] += 1
    return out


flash_attention_prefill.launches = 0
flash_attention_prefill.launches_by_path = {"causal": 0, "lse": 0}


def flash_attention_lse(
    q: torch.Tensor,        # [B, T, Hq, d]
    k: torch.Tensor,        # [B, S, Hkv, d]
    v: torch.Tensor,        # [B, S, Hkv, d]
    scale: float,
    q_offset: int = 0,
):
    """The kernel's LSE mode: ``(out [B, T, Hq*d], lse [B, Hq, T])``, both
    fp32: the causal attention of :func:`flash_attention_prefill`
    normalised but not downcast, and each row's natural log-sum-exp of its
    scaled visible scores. Counted in ``flash_attention_prefill.launches``
    (and its ``launches_by_path["lse"]``)."""
    B, T, Hq, d = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if Hq % Hkv != 0:
        raise ValueError(
            f"q heads ({Hq}) must be a multiple of kv heads ({Hkv})"
        )
    q_offset = int(q_offset)
    if not q.is_cuda:
        if q.device.type == "cpu":
            return flash_attention_lse_ref(q, k, v, scale, q_offset)
        raise ValueError(f"unsupported device {q.device}")
    strides = _check_cuda_inputs(q, k, v, scale)
    out = torch.empty((B, T, Hq * d), dtype=torch.float32, device=q.device)
    lse = torch.empty((B, Hq, T), dtype=torch.float32, device=q.device)
    entry = "flash_prefill_lse_f32"
    with torch.cuda.device(q.device):
        err = _kernel(entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, T, S, Hq, Hkv, d, *strides, q_offset,
            float(scale), torch._C._cuda_getCurrentRawStream(q.device.index),
        )
    if err != 0:
        raise RuntimeError(_launch_error(err, entry))
    flash_attention_prefill.launches += 1
    flash_attention_prefill.launches_by_path["lse"] += 1
    return out, lse
