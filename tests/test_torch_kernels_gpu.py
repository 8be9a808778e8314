"""The port's hand-written CUDA kernels against their plain versions, on a
card (marker ``gpu``; each test skips where there is no CUDA card).

This file imports neither JAX nor the JAX package, so on a machine without
JAX it runs alone: ``python -m pytest --noconftest -m gpu
tests/test_torch_kernels_gpu.py``.
"""

import pytest
import torch

from gpustack_tpu_torch.ops import flash_attention as fa  # analysis: ignore[metrics-drift]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the hand-written kernels run only there")


def _assert_rows_close(out, ref, Hq, d, row_rtol=1e-2):
    """Each output row (one q row of one head) within ``row_rtol`` of the
    reference row, in norm: long causal rows average v over many keys and
    are small, so an absolute bound alone would pass a wrong late tile."""
    rows = ref.reshape(*ref.shape[:2], Hq, d)
    rel = (
        (out.float().reshape(rows.shape) - rows).norm(dim=-1)
        / rows.norm(dim=-1).clamp_min(1e-30)
    )
    assert rel.max().item() <= row_rtol, (
        f"max row |err|/|ref| {rel.max().item()} > {row_rtol}"
    )


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,S,off,Hq,Hkv,d", [
    (1, 2048, 2048, 0, 32, 8, 128),     # llama3-8b, full 2048 bucket
    (1, 512, 2048, 1536, 32, 8, 128),   # chunk continuation
    (1, 1000, 1000, 0, 32, 8, 128),     # ragged T
    (2, 200, 200, 0, 4, 1, 64),         # MQA, d 64, batch 2
    (1, 100, 512, 384, 2, 1, 64),       # ragged chunk mid-cache
    (1, 1024, 1024, 0, 32, 8, 128),     # the other buckets the main path
    (1, 64, 64, 0, 32, 8, 128),         # fills at T = S
    (1, 32, 32, 0, 32, 8, 128),
    (1, 100, 100, 0, 32, 8, 128),       # T a multiple of neither 64 nor 128
    (2, 1000, 1000, 0, 8, 2, 64),       # GQA, d 64, batch 2, ragged
    (1, 100, 300, 200, 4, 2, 128),      # S not a multiple of the 128-key
    (1, 70, 333, 190, 4, 1, 64),        # tile, q_offset > 0: TMA's zero
    (2, 130, 250, 120, 4, 2, 128),      # fill meets the causal edge
])
def test_flash_kernel_matches_plain(B, T, S, off, Hq, Hkv, d):
    """bf16 kernel output against the fp32 plain version of the same bf16
    inputs: |err| <= 2e-2 + 2e-2 |ref| (bf16 output rounding plus the
    kernel's bf16 probabilities), and each row within 1e-2 of its norm."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(B * 7 + T + off)
    q, k, v = (
        torch.randn(*shape, generator=gen, device="cuda").bfloat16()
        for shape in ((B, T, Hq, d), (B, S, Hkv, d), (B, S, Hkv, d))
    )
    before = fa.flash_attention_prefill.launches
    out = fa.flash_attention_prefill(q, k, v, d ** -0.5, q_offset=off)
    torch.cuda.synchronize()
    assert fa.flash_attention_prefill.launches == before + 1
    ref = fa.flash_attention_prefill_ref(
        q.float(), k.float(), v.float(), d ** -0.5, off
    )
    torch.testing.assert_close(out.float(), ref, rtol=2e-2, atol=2e-2)
    _assert_rows_close(out, ref, Hq, d)


@pytest.mark.gpu
def test_flash_kernel_reads_strided_cache_views():
    """The runner hands the kernel one layer of the [L, B, S, H, d] cache:
    a strided view, read in place."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(1)
    cache = torch.randn(
        3, 1, 256, 2, 64, generator=gen, device="cuda"
    ).bfloat16()
    q = torch.randn(1, 256, 4, 64, generator=gen, device="cuda").bfloat16()
    out = fa.flash_attention_prefill(q, cache[1], cache[2], 0.125)
    ref = fa.flash_attention_prefill_ref(
        q.float(), cache[1].float(), cache[2].float(), 0.125
    )
    torch.testing.assert_close(out.float(), ref, rtol=2e-2, atol=2e-2)
    _assert_rows_close(out, ref, 4, 64)


@pytest.mark.gpu
@pytest.mark.parametrize("bad", ["float32", "head_dim", "cpu_k"])
def test_flash_kernel_refuses_what_it_cannot_run(bad):
    _need_card()
    q = torch.zeros(1, 64, 2, 64, device="cuda", dtype=torch.bfloat16)
    k = torch.zeros(1, 64, 1, 64, device="cuda", dtype=torch.bfloat16)
    if bad == "float32":
        q, k = q.float(), k.float()
    elif bad == "head_dim":
        q, k = q[..., :32].contiguous(), k[..., :32].contiguous()
    else:
        k = k.cpu()
    with pytest.raises((TypeError, ValueError)):
        fa.flash_attention_prefill(q, k, k, 0.125)
