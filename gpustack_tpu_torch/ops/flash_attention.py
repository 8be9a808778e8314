"""Causal GQA flash-attention prefill: a hand-written Hopper kernel and its
plain PyTorch version.

The kernel (``csrc/flash_attention.cu``, CUDA C++ for ``sm_90a``, bound
with ``ctypes``) replaces the Pallas TPU kernel
``gpustack_tpu/ops/flash_attention.py`` (``_flash_kernel``, launched by
``flash_attention_prefill``). Same function and public layout: q
``[B, T, Hq, d]`` at absolute positions ``q_offset .. q_offset+T-1``
against k, v ``[B, S, Hkv, d]``; returns ``[B, T, Hq*d]`` in q's dtype.

Bound on the card: compute. One causal call at llama3-8b widths
(T = S = 2048, Hq 32, d 128) is ~34.4 GFLOP (~35 us at 989 TFLOP/s bf16)
against ~42 MB of traffic (~12.5 us at 3.35 TB/s). The kernel keeps the
[T, S] scores out of device memory, runs both products on bf16 tensor
cores and stops each q-tile's key loop at its causal edge; see the CUDA
source's header for the block design.

``flash_attention_prefill`` launches the kernel for a CUDA tensor (or
raises: there is no fallback on the card) and takes the plain version only
for a CPU tensor. ``flash_attention_prefill.launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes

import torch

_NEG = -1e30
SUPPORTED_HEAD_DIMS = (64, 128)

_lib = None


def _kernel():
    """The compiled library's entry point (built on first call)."""
    global _lib
    if _lib is None:
        from gpustack_tpu_torch.ops._build import load

        lib = load("flash_attention")
        fn = lib.flash_prefill_bf16
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 4
            + [ctypes.c_int] * 6
            + [ctypes.c_longlong] * 9
            + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        )
        _lib = fn
    return _lib


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


def _check_cuda_inputs(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(
                f"flash kernel takes bfloat16; {name} is {t.dtype}"
            )
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D, got {tuple(t.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s last dimension must be contiguous")
        if any(s % 8 for s in t.stride()[:-1]) or t.data_ptr() % 16:
            raise ValueError(
                f"{name} rows must be 16-byte aligned (strides a multiple "
                "of 8 elements)"
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
    if q.device.type == "cpu":
        return flash_attention_prefill_ref(q, k, v, scale, q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_cuda_inputs(q, k, v)
    out = torch.empty((B, T, Hq * d), dtype=q.dtype, device=q.device)
    fn = _kernel()
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, T, S, Hq, Hkv, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        q_offset, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_prefill_bf16 launch failed: cudaError {err}")
    flash_attention_prefill.launches += 1
    return out


flash_attention_prefill.launches = 0
