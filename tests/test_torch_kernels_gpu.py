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
    (1, 2048, 2048, 0, 16, 16, 256),    # gemma-7b's heads (d 256: 64-key
    (1, 512, 2048, 1536, 16, 16, 256),  # tiles, 2 stages), a continuation,
    (1, 2048, 2048, 0, 8, 1, 256),      # gemma-2b's MQA heads, ragged T
    (1, 100, 300, 200, 8, 1, 256),      # and S off the tiles, a batch
    (2, 130, 250, 120, 4, 2, 256),
    (1, 64, 64, 0, 16, 16, 256),
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
@pytest.mark.parametrize("B,T,S,off,Hq,Hkv,d", [
    (1, 2048, 2048, 0, 32, 8, 128),     # a ring's diagonal block
    (1, 1024, 1024, 1024, 32, 8, 128),  # a block wholly below it
    (1, 100, 300, 200, 4, 2, 128),      # ragged, at the causal edge
    (2, 130, 250, 120, 16, 16, 192),    # d 192, batch 2
    (1, 64, 64, 0, 8, 1, 256),          # d 256, MQA
    (2, 200, 200, 0, 4, 1, 64),         # d 64
])
def test_flash_lse_mode_matches_plain(B, T, S, off, Hq, Hkv, d):
    """The LSE mode (a ring block): fp32 output to the kernel gate and each
    row's log-sum-exp within 1e-3 of the fp32 plain version; counted with
    the kernel, under its ``"lse"`` path."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(B * 5 + T + off)
    q, k, v = (
        torch.randn(*shape, generator=gen, device="cuda").bfloat16()
        for shape in ((B, T, Hq, d), (B, S, Hkv, d), (B, S, Hkv, d))
    )
    before = fa.flash_attention_prefill.launches_by_path["lse"]
    out, lse = fa.flash_attention_lse(q, k, v, d ** -0.5, q_offset=off)
    torch.cuda.synchronize()
    assert fa.flash_attention_prefill.launches_by_path["lse"] == before + 1
    ref, ref_lse = fa.flash_attention_lse_ref(
        q.float(), k.float(), v.float(), d ** -0.5, off
    )
    assert out.dtype == lse.dtype == torch.float32
    torch.testing.assert_close(out, ref, rtol=2e-2, atol=2e-2)
    _assert_rows_close(out, ref, Hq, d)
    assert (lse - ref_lse).abs().max().item() <= 1e-3


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


# the batched (over experts) entry: (E, M, K, N, x) with x "shared" (one
# [M, K] x expanded over the experts, batch stride 0: the gate and up
# products) or "h" (expert e's columns of an [M, E, K] tensor: the down
# product); M on both sides of 16, E, M, K and N off the tiles
# the grouped expert kernel (the routed MoE products): (E, tokens n, top-k,
# K, N, routing). Every MoE product of the main paths at a decode step's 8
# slots (the GEMV) and the 2048 bucket (the wgmma path), then the routings
# that stress the segments: an expert no token picks, every token on one
# expert, a segment ending mid-tile, one token, n = 16 and 17 (the path's
# edge), K off 64 and N off 64
_GROUPED_SHAPES = [
    (8, 8, 2, 4096, 14336, "random"),       # mixtral-8x7b gate/up
    (8, 8, 2, 14336, 4096, "random"),       # and down
    (8, 2048, 2, 4096, 14336, "random"),
    (8, 2048, 2, 14336, 4096, "random"),
    (128, 8, 8, 2048, 768, "random"),       # qwen3-30b-a3b
    (128, 8, 8, 768, 2048, "random"),
    (128, 2048, 8, 2048, 768, "random"),
    (128, 2048, 8, 768, 2048, "random"),
    (32, 8, 4, 2880, 2880, "random"),       # gpt-oss-20b (gate = up = down)
    (32, 2048, 4, 2880, 2880, "random"),
    (64, 8, 6, 2048, 1408, "random"),       # deepseek-v2-lite
    (64, 8, 6, 1408, 2048, "random"),
    (64, 2048, 6, 2048, 1408, "random"),
    (64, 2048, 6, 1408, 2048, "random"),
    (8, 300, 2, 4096, 1024, "empty"),       # expert 0 never picked
    (8, 12, 2, 4096, 1024, "empty"),
    (8, 300, 1, 1024, 512, "one"),          # every row on one expert
    (8, 16, 1, 1024, 512, "one"),
    (4, 500, 2, 1024, 512, "midtile"),      # 200 rows on expert 0
    (8, 1, 2, 4096, 1024, "random"),        # one token
    (16, 16, 4, 1024, 256, "random"),       # the GEMV's last n
    (16, 17, 4, 1024, 256, "random"),       # the wgmma path's first
    (5, 13, 2, 4104, 1040, "random"),       # K % 64, N % 64 != 0
    (5, 130, 2, 4104, 1040, "random"),
    (7, 33, 3, 264, 4112, "random"),
    # the persistent kernel's plans: N 2880 (BN 192 for bf16) and 1408
    # (BN 128) at a mean of at most 64 rows an expert (64-row units) and
    # of at least 256 (128-row units at 512); 129 experts (past four
    # warps of lanes) and 1100 (more than a CTA copies into shared
    # memory: its walk reads offsets in device memory)
    (32, 512, 4, 2880, 2880, "random"),
    (64, 512, 6, 2048, 1408, "random"),
    (32, 2048, 4, 2880, 1408, "random"),
    (8, 2048, 2, 1024, 2880, "random"),
    (8, 2048, 2, 2880, 1408, "random"),
    (129, 300, 8, 1024, 512, "random"),
    (1100, 300, 8, 256, 256, "random"),
    # the kernel's other unit shapes: BN 128 at 64 and 128 rows (int8 128
    # x 128), BN 192 at 128 rows
    (8, 300, 2, 1024, 128, "random"),
    (4, 2048, 1, 1024, 128, "random"),
    (4, 2048, 1, 1024, 320, "random"),
]


def _grouped_inputs(E, n, k, K, N, routing, bf16w, seed):
    """(xs [n·k, K], w, s or None, offsets, top) for one routing: x's rows
    gathered in the routed order, as ``_moe_mlp`` gives them."""
    from gpustack_tpu_torch.models import transformer as tf  # analysis: ignore[metrics-drift]

    gen = torch.Generator(device="cuda").manual_seed(seed)
    scores = torch.rand(n, E, generator=gen, device="cuda")
    if routing == "empty":
        scores[:, 0] = -1.0
    elif routing == "one":
        scores[:, E - 1] = 2.0
    elif routing == "midtile":
        scores[:200, 0] = 2.0
    top = scores.topk(k, dim=-1).indices
    perm, offsets, _ = tf.moe_dispatch(top, E)
    x = torch.randn(n, K, generator=gen, device="cuda").bfloat16()
    if bf16w:
        w = (torch.randn(E, K, N, generator=gen, device="cuda")
             / K ** 0.5).bfloat16()
        s = None
    else:
        w = torch.randint(-127, 128, (E, K, N), generator=gen, device="cuda",
                          dtype=torch.int8)
        s = (torch.rand(E, N, generator=gen, device="cuda") * 3e-3
             + 1e-4).bfloat16()
    return x[perm // k].contiguous(), w, s, offsets, top


def _assert_grouped_close(out, xs, w, s, offsets):
    """Each expert's segment against its fp32 plain product, with the 2-D
    kernel's bounds (|err| <= 2e-2 + 2e-2 |ref|, rows within 1e-2)."""
    bounds = offsets.tolist()
    assert bounds[-1] == out.shape[0]
    for e in range(w.shape[0]):
        a, b = bounds[e], bounds[e + 1]
        if b == a:
            continue
        if s is not None:
            _assert_w8a16_close(out[a:b], xs[a:b], w[e], s[e])
            continue
        ref = xs[a:b].float() @ w[e].float()
        err = (out[a:b].float() - ref).abs()
        assert torch.isfinite(out[a:b].float()).all()
        assert (err <= W8A16_ATOL + W8A16_RTOL * ref.abs()).all(), err.max()
        row = err.norm(dim=-1) / ref.norm(dim=-1).clamp_min(1e-30)
        assert row.max().item() <= W8A16_ROW_RTOL, row.max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("bf16w", [False, True], ids=["int8", "bf16"])
@pytest.mark.parametrize("E,n,k,K,N,routing", _GROUPED_SHAPES)
def test_grouped_kernel_matches_plain(E, n, k, K, N, routing, bf16w):
    """Each segment's bf16 output against the fp32 plain product of the
    same inputs; one launch, counted on the path the chunk's n rows choose
    (at most n rows on one expert)."""
    _need_card()
    from gpustack_tpu_torch.ops import w8a16  # analysis: ignore[metrics-drift]

    xs, w, s, offsets, _ = _grouped_inputs(E, n, k, K, N, routing, bf16w,
                                           E + n + K + N)
    wrapper = w8a16.bf16_grouped if bf16w else w8a16.w8a16_grouped
    path = "gemv" if n <= w8a16.GEMV_MAX_M else "wgmma"
    before = wrapper.launches
    by_path = dict(wrapper.launches_by_path)
    out = (w8a16.bf16_grouped(xs, w, offsets, n) if bf16w
           else w8a16.w8a16_grouped(xs, w, s, offsets, n))
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    by_path[path] += 1
    assert wrapper.launches_by_path == by_path
    assert out.shape == (n * k, N) and out.dtype == torch.bfloat16
    _assert_grouped_close(out, xs, w, s, offsets)
    plain = (w8a16.bf16_grouped_plain(xs, w, offsets) if bf16w
             else w8a16.w8a16_grouped_plain(xs, w, s, offsets))
    assert (out.float() - plain.float()).abs().max() <= 2e-2 * (
        1 + plain.float().abs().max()
    )


@pytest.mark.gpu
@pytest.mark.parametrize("bf16w", [False, True], ids=["int8", "bf16"])
@pytest.mark.parametrize("n,E,E_loc,e0,K,N", [
    (2048, 8, 4, 4, 4096, 7168),        # mixtral-8x7b ep2xtp2's gate
    (2048, 8, 4, 0, 7168, 4096),        # and down, at either rank
    (512, 32, 8, 16, 2880, 2880),       # gpt-oss-20b's widths
])
def test_grouped_kernel_takes_an_ep_slice(n, E, E_loc, e0, K, N, bf16w):
    """As an ``ep`` rank runs it: the pairs sorted over all E experts, the
    kernel given the E_loc local experts and ``offsets[e0:e0 + E_loc +
    1]`` (offsets[0] > 0 or offsets[E_loc] < P): each local segment held
    to its plain product."""
    _need_card()
    from gpustack_tpu_torch.ops import w8a16  # analysis: ignore[metrics-drift]

    k = 2
    xs, w, s, offsets, _ = _grouped_inputs(E, n, k, K, N, "random", bf16w,
                                           e0 + n + N)
    local = offsets[e0:e0 + E_loc + 1].clone()
    w, s = w[e0:e0 + E_loc].contiguous(), (
        None if s is None else s[e0:e0 + E_loc].contiguous())
    out = (w8a16.bf16_grouped(xs, w, local, n) if bf16w
           else w8a16.w8a16_grouped(xs, w, s, local, n))
    torch.cuda.synchronize()
    a, b = local[0].item(), local[-1].item()
    assert 0 < a or b < n * k
    shifted = local - a
    _assert_grouped_close(out[a:b].contiguous(), xs[a:b].contiguous(), w, s,
                          shifted)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16w", [False, True], ids=["int8", "bf16"])
def test_grouped_kernel_reads_a_layer_view(bf16w):
    """The forward's shapes: w (and s) one layer of stacked [L, E, K, N]
    (and [L, E, N]) leaves."""
    _need_card()
    from gpustack_tpu_torch.ops import w8a16  # analysis: ignore[metrics-drift]

    xs, w, s, offsets, _ = _grouped_inputs(4, 40, 2, 256, 512, "random",
                                           bf16w, 9)
    ws = torch.stack([torch.zeros_like(w), w])
    if bf16w:
        out = w8a16.bf16_grouped(xs, ws[1], offsets, 40)
    else:
        out = w8a16.w8a16_grouped(xs, ws[1], torch.stack([s, s])[1],
                                  offsets, 40)
    torch.cuda.synchronize()
    _assert_grouped_close(out, xs, w, s, offsets)


@pytest.mark.gpu
@pytest.mark.parametrize("bad", ["k_odd", "w_2d", "s_shape", "x_fp32",
                                 "offsets_int64", "w_strided"])
def test_grouped_kernel_refuses_what_it_cannot_run(bad):
    _need_card()
    from gpustack_tpu_torch.ops import w8a16  # analysis: ignore[metrics-drift]

    xs, q, s, offsets, _ = _grouped_inputs(2, 4, 1, 64, 64, "random", False,
                                           0)
    if bad == "k_odd":
        xs, q = xs[:, :60].contiguous(), q[:, :60].contiguous()
    elif bad == "w_2d":
        q = q[0]
    elif bad == "s_shape":
        s = s[0]
    elif bad == "x_fp32":
        xs = xs.float()
    elif bad == "offsets_int64":
        offsets = offsets.long()
    else:
        q = torch.zeros(2, 64, 128, device="cuda", dtype=torch.int8)[..., :64]
    with pytest.raises((ValueError, TypeError)):
        w8a16.w8a16_grouped(xs, q, s, offsets, 4)
