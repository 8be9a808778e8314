"""bfloat16 on the host without a bfloat16 numpy dtype.

numpy has no bfloat16, and the port does not depend on a package that adds
one. Host copies of bf16 KV are therefore ``uint16`` arrays holding the
bf16 bit patterns (the same bytes, little-endian, that a bf16 array
holds), and a ``uint16`` KV array means bf16 throughout the host tiers
(``kv_host_cache``, ``kv_spill``, ``kv_transfer``). These helpers widen
such bits to float32 exactly and round float32 back to bf16 bits to
nearest even, as numpy's bfloat16 extension types do: NaN keeps its sign
and becomes the quiet NaN ``0x7FC0``/``0xFFC0``, infinities and signed
zeros stay, subnormals round like any other value.
"""

from __future__ import annotations

import numpy as np
import torch

BF16 = np.dtype(np.uint16)   # the host dtype of bf16 bit patterns


def is_bf16(dtype) -> bool:
    return np.dtype(dtype) == BF16


def bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """Exact widening: the bits become the upper half of a float32."""
    return (np.asarray(bits, np.uint16).astype(np.uint32) << 16).view(
        np.float32
    )


def f32_to_bf16_bits(x: np.ndarray) -> np.ndarray:
    """Round float32 to bf16 bits, to nearest, ties to even."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    rounded = (u + (0x7FFF + ((u >> 16) & 1))) >> 16
    nan = np.where(u >> 31, 0xFFC0, 0x7FC0)
    out = np.where(np.isnan(x), nan, rounded)
    return out.astype(np.uint16)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host tensor as numpy, sharing its memory; bf16 as bit patterns."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def from_numpy(a: np.ndarray) -> torch.Tensor:
    """The reverse of :func:`to_numpy`: ``uint16`` bits become bf16."""
    if is_bf16(a.dtype):
        return torch.from_numpy(
            np.ascontiguousarray(a).view(np.int16)
        ).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))
