"""Flash-attention prefill of the PyTorch port against the JAX kernel.

The port's plain version (what its wrapper takes for CPU tensors) is held
against the JAX Pallas kernel in interpret mode and against the JAX
reference ``_attend``, on the shapes and offsets of
tests/ops/test_flash_attention.py. Inputs are made with numpy from a seed
and handed to both sides. Tolerance: fp32 on both sides, rtol/atol 2e-4
(the JAX kernel test's own bound; the two differ only in summation order).

The hand-written CUDA kernel runs only on a card: see
test_torch_kernels_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpustack_tpu.models.transformer import _attend
from gpustack_tpu.ops.flash_attention import (
    flash_attention_prefill as jax_flash,
)
from gpustack_tpu_torch.ops import flash_attention as port  # analysis: ignore[metrics-drift]

RTOL = ATOL = 2e-4


def _inputs(seed, B, T, S, Hq, Hkv, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, Hq, d), dtype=np.float32)
    k = rng.standard_normal((B, S, Hkv, d), dtype=np.float32)
    v = rng.standard_normal((B, S, Hkv, d), dtype=np.float32)
    return q, k, v


def _jax_reference(q, k, v, off, scale):
    B, T, Hq, d = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    q_pos = off + np.arange(T)
    mask = np.broadcast_to(
        np.arange(S)[None, None, :] <= q_pos[None, :, None], (B, T, S)
    )
    return np.asarray(_attend(
        jnp.asarray(q).reshape(B, T, Hkv, Hq // Hkv, d),
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask), scale,
    ))


@pytest.mark.parametrize("B,T,S,off,Hq,Hkv,d", [
    (1, 256, 256, 0, 4, 2, 64),
    (2, 128, 128, 0, 2, 2, 64),      # MHA
    (1, 200, 200, 0, 4, 1, 64),      # MQA + non-block-multiple T
    (1, 128, 512, 256, 4, 2, 64),    # mid-cache chunk
    (1, 100, 512, 384, 2, 1, 64),    # non-block T, chunk ends mid-cache
    (1, 128, 128, 0, 2, 2, 64),      # offset 0 == original contract
])
def test_plain_matches_jax_kernel_and_reference(B, T, S, off, Hq, Hkv, d):
    q, k, v = _inputs(B * 1000 + T + off, B, T, S, Hq, Hkv, d)
    scale = 1.0 / np.sqrt(d)
    out = port.flash_attention_prefill(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        scale, q_offset=off,
    ).numpy()
    assert out.shape == (B, T, Hq * d)
    kern = np.asarray(jax_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
        interpret=True, q_offset=off,
    ))
    np.testing.assert_allclose(out, kern, rtol=RTOL, atol=ATOL)
    ref = _jax_reference(q, k, v, off, scale)
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def test_bf16_inputs_give_bf16_output():
    q, k, v = _inputs(1, 1, 128, 128, 2, 2, 64)
    out = port.flash_attention_prefill(
        torch.from_numpy(q).bfloat16(), torch.from_numpy(k).bfloat16(),
        torch.from_numpy(v).bfloat16(), 64 ** -0.5,
    )
    assert out.dtype == torch.bfloat16
    assert torch.isfinite(out.float()).all()


def test_q_offset_is_a_runtime_argument():
    """One wrapper serves every offset; a wider visible key range must
    change the output (offset 128 sees keys the offset-0 call masks)."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(3, 1, 128, 256, 2, 2, 64))
    o1 = port.flash_attention_prefill(q, k, v, 0.125, q_offset=0)
    o2 = port.flash_attention_prefill(q, k, v, 0.125, q_offset=128)
    assert not torch.allclose(o1, o2)


def test_wrapper_raises_on_bad_head_ratio():
    q, k, v = (torch.from_numpy(a) for a in _inputs(4, 1, 32, 32, 3, 2, 64))
    with pytest.raises(ValueError, match="multiple of kv heads"):
        port.flash_attention_prefill(q, k, v, 0.125)


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    before = port.flash_attention_prefill.launches
    q, k, v = (torch.from_numpy(a) for a in _inputs(5, 1, 64, 64, 2, 1, 64))
    out = port.flash_attention_prefill(q, k, v, 0.125)
    ref = port.flash_attention_prefill_ref(q, k, v, 0.125)
    assert torch.equal(out, ref)
    assert port.flash_attention_prefill.launches == before


@pytest.mark.parametrize("mutate,exc", [
    (lambda t: t.float(), TypeError),                    # dtype
    (lambda t: t[..., :48], ValueError),                 # head_dim 48
    (lambda t: t.transpose(1, 3).contiguous().transpose(1, 3), ValueError),
])
def test_card_input_checks(mutate, exc):
    """The checks a CUDA call runs before its launch (exercised here on
    CPU tensors: they test layout and type only)."""
    q, k, v = (
        torch.from_numpy(a).bfloat16()
        for a in _inputs(6, 1, 64, 64, 2, 1, 64)
    )
    with pytest.raises(exc):
        port._check_cuda_inputs(mutate(q), k, v, 0.125)


def _bf16_qkv(seed):
    return tuple(
        torch.from_numpy(a).bfloat16()
        for a in _inputs(seed, 1, 64, 64, 2, 1, 64)
    )


@pytest.mark.parametrize("name,broadcast", [
    ("q", lambda t: t.expand(2, -1, -1, -1)),             # batch
    ("k", lambda t: t[:, :1].expand(-1, 64, -1, -1)),     # rows
    ("v", lambda t: t.expand(-1, -1, 2, -1)),             # heads
])
def test_card_input_checks_refuse_broadcast_strides(name, broadcast):
    """A TMA tensor map needs a positive stride along every dimension of
    extent > 1: an expanded (stride 0) q, k or v is refused, by name."""
    qkv = dict(zip("qkv", _bf16_qkv(7)))
    qkv[name] = broadcast(qkv[name])
    with pytest.raises(ValueError, match=f"{name} has a stride of 0"):
        port._check_cuda_inputs(qkv["q"], qkv["k"], qkv["v"], 0.125)


def test_card_input_checks_accept_zero_stride_on_extent_one():
    """A dimension of extent 1 is never stepped along: its stride may be 0
    (the kernel gives the map a packed one)."""
    q, k, v = _bf16_qkv(7)
    q0 = q.as_strided(q.shape, (0,) + q.stride()[1:])
    assert port._check_cuda_inputs(q0, k, v, 0.125)[:3] == (0, 128, 64)


@pytest.mark.parametrize("scale", [0.0, -0.125, float("inf"), float("nan")])
def test_card_input_checks_refuse_non_positive_scale(scale):
    """The kernel takes each row's max of the raw scores and scales it
    after, which holds only for a positive, finite scale."""
    q, k, v = _bf16_qkv(8)
    with pytest.raises(ValueError, match="scale must be positive"):
        port._check_cuda_inputs(q, k, v, scale)


def test_card_input_checks_return_the_strides_the_kernel_reads():
    """One layer of the runner's [L, B, S, H, d] cache is read in place:
    the check hands the kernel its strides, (batch, row, head) of q, k, v."""
    cache = torch.zeros(3, 1, 256, 2, 64, dtype=torch.bfloat16)
    q = torch.zeros(1, 256, 4, 64, dtype=torch.bfloat16)
    assert port._check_cuda_inputs(q, cache[1], cache[2], 0.125) == (
        256 * 4 * 64, 4 * 64, 64,
        256 * 2 * 64, 2 * 64, 64,
        256 * 2 * 64, 2 * 64, 64,
    )
