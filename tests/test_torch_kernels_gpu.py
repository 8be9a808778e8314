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
    (1, 512, 2048, 1024, 32, 8, 128),   # continuations the engine serves:
    (1, 32, 2048, 1792, 32, 8, 128),    # a chunk, a suffix after a prefix
    (1, 64, 1024, 784, 32, 8, 128),     # hit, and offsets off the 128-row
    (1, 128, 2048, 1888, 32, 8, 128),   # and 128-key tiles
    (1, 2048, 2048, 0, 16, 16, 192),    # deepseek-v2-lite's MLA heads
    (1, 1024, 1024, 0, 16, 16, 192),    # (d 192: 64-key tiles, 3 stages)
    (1, 64, 64, 0, 16, 16, 192),        # at the buckets, a continuation,
    (1, 512, 2048, 1536, 16, 16, 192),  # ragged T and S off the 64-key
    (1, 100, 300, 200, 16, 16, 192),    # tile, and a cacheless batch
    (4, 2048, 2048, 0, 16, 16, 192),
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


# ---------------------------------------------------------------------------
# W8A16: int8 weights, bf16 activations
# ---------------------------------------------------------------------------

W8A16_ATOL = W8A16_RTOL = 2e-2
W8A16_ROW_RTOL = 1e-2


def _w8a16_inputs(M, K, N, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(M, K, generator=gen, device="cuda").bfloat16()
    q = torch.randint(
        -127, 128, (K, N), generator=gen, device="cuda", dtype=torch.int8
    )
    s = (torch.rand(N, generator=gen, device="cuda") * 3e-3 + 1e-4).bfloat16()
    return x, q, s


def _assert_w8a16_close(out, x, q, s):
    from gpustack_tpu_torch.ops import w8a16  # analysis: ignore[metrics-drift]

    ref = w8a16.w8a16_plain(x.float(), q, s)
    err = (out.float() - ref).abs()
    assert torch.isfinite(out.float()).all()
    assert (err <= W8A16_ATOL + W8A16_RTOL * ref.abs()).all(), err.max()
    row = err.norm(dim=-1) / ref.norm(dim=-1).clamp_min(1e-30)
    assert row.max().item() <= W8A16_ROW_RTOL, row.max().item()


_W8A16_SHAPES = [
    (8, 4096, 4096), (8, 4096, 1024), (8, 4096, 14336),   # decode: wq/wo,
    (8, 14336, 4096), (8, 4096, 128256),                  # wk/wv, gate/up,
    (1, 4096, 128256),                                    # down, lm_head
    (2048, 4096, 14336), (2048, 14336, 4096),             # prefill
    (512, 4096, 14336),                                   # a chunk
    (1, 4096, 4096), (3, 4096, 1024), (17, 4096, 1024),   # ragged M
    (100, 4096, 4096), (16, 4096, 4096),
    (8, 4104, 4112), (100, 4104, 4112), (5, 24, 16),      # ragged K and N
]
# the wgmma path (M > 16) at every llama3-8b layer weight, at the buckets,
# the chunk and ragged M
_W8A16_SHAPES += [
    (M, K, N)
    for M in (17, 32, 64, 100, 512, 2048)
    for K, N in ((4096, 14336), (14336, 4096), (4096, 4096), (4096, 1024))
    if (M, K, N) not in _W8A16_SHAPES
]
# gemma2-9b's int8 path (d 3584, q 16 x 256, kv 8 x 256, F 14336): every
# layer weight at a decode step's 8 slots, the 2048 bucket and a 64 one
_W8A16_SHAPES += [
    (M, K, N)
    for M in (8, 64, 2048)
    for K, N in ((3584, 4096), (3584, 2048), (4096, 3584), (3584, 14336),
                 (14336, 3584))
]
# N % 16 but not % 64 or % 128, K % 8 but not % 64, on both tile widths
_W8A16_SHAPES += [
    (2048, 4104, 4112), (512, 4104, 1040), (33, 4104, 4112),
    (64, 14336, 1040), (300, 136, 4112),
]


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", _W8A16_SHAPES)
def test_w8a16_kernel_matches_plain(M, K, N):
    """bf16 kernel output against the fp32 plain version of the same int8
    and bf16 inputs: |err| <= 2e-2 + 2e-2 |ref| (bf16 output rounding
    and the fp32 summation order), each row within 1e-2 of its norm. The
    launch is counted once, on the path M chooses."""
    _need_card()
    from gpustack_tpu_torch.ops import w8a16  # analysis: ignore[metrics-drift]

    x, q, s = _w8a16_inputs(M, K, N, M + K + N)
    path = "gemv" if M <= w8a16.GEMV_MAX_M else "wgmma"
    before = w8a16.w8a16_matmul.launches
    by_path = dict(w8a16.w8a16_matmul.launches_by_path)
    out = w8a16.w8a16_matmul(x, q, s)
    torch.cuda.synchronize()
    assert w8a16.w8a16_matmul.launches == before + 1
    by_path[path] += 1
    assert w8a16.w8a16_matmul.launches_by_path == by_path
    assert out.shape == (M, N) and out.dtype == torch.bfloat16
    _assert_w8a16_close(out, x, q, s)


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", [
    (8, 4096, 1040), (100, 4104, 4112), (2048, 4096, 4112),
])
def test_w8a16_kernel_reads_strided_views(M, K, N):
    """q as columns [0, N) of one layer of a stacked [L, K, N + 48] weight
    (rows ldq != N bytes apart), x as columns [0, K) of [M, K + 64]."""
    _need_card()
    from gpustack_tpu_torch.ops import w8a16  # analysis: ignore[metrics-drift]

    gen = torch.Generator(device="cuda").manual_seed(M + N)
    xw = torch.randn(M, K + 64, generator=gen, device="cuda").bfloat16()
    qw = torch.randint(-127, 128, (3, K, N + 48), generator=gen,
                       device="cuda", dtype=torch.int8)
    s = (torch.rand(N, generator=gen, device="cuda") * 3e-3 + 1e-4).bfloat16()
    x, q = xw[:, :K], qw[2][:, :N]
    assert q.stride(0) == N + 48 and x.stride(0) == K + 64
    out = w8a16.w8a16_matmul(x, q, s)
    torch.cuda.synchronize()
    _assert_w8a16_close(out, x, q, s)


@pytest.mark.gpu
def test_w8a16_kernel_reads_a_layer_view_and_3d_x():
    """The forward's shapes: x [B, T, K] and q one layer of [L, K, N]."""
    _need_card()
    from gpustack_tpu_torch.ops import w8a16  # analysis: ignore[metrics-drift]

    x, q, s = _w8a16_inputs(6, 512, 256 * 3, 5)
    stack = torch.stack([torch.zeros_like(q), q])
    out = w8a16.w8a16_matmul(x.reshape(2, 3, 512), stack[1], s)
    torch.cuda.synchronize()
    assert out.shape == (2, 3, 768)
    _assert_w8a16_close(out.reshape(6, 768), x, q, s)


@pytest.mark.gpu
@pytest.mark.parametrize("bad", ["k_odd", "n_odd", "x_fp32", "q_cpu"])
def test_w8a16_kernel_refuses_what_it_cannot_run(bad):
    _need_card()
    from gpustack_tpu_torch.ops import w8a16  # analysis: ignore[metrics-drift]

    x, q, s = _w8a16_inputs(4, 64, 64, 0)
    if bad == "k_odd":
        x, q = x[:, :60].contiguous(), q[:60]
    elif bad == "n_odd":
        q, s = q[:, :40].contiguous(), s[:40].contiguous()
    elif bad == "x_fp32":
        x = x.float()
    else:
        q = q.cpu()
    with pytest.raises((ValueError, TypeError)):
        w8a16.w8a16_matmul(x, q, s)
