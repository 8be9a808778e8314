"""int8 MoE and MLA of the PyTorch port against the JAX package.

The grouped W8A16 expert product (``ops.w8a16_grouped``, here its plain
version: these tensors lie on the CPU) against the JAX ``_mm`` over the
expert axis, row for row; ``_moe_mlp`` with int8 experts against the JAX
``_moe_mlp`` on ``quantize_params`` of the same weights, per branch; int8
forwards of tiny Mixtral, Qwen3-MoE, DeepSeek (with and without
``q_lora_rank``, a ``first_k_dense`` layer) and GPT-OSS configurations
(prefill, continuation, decode, a verify block); the engine's greedy ids;
``init_quantized_params``' tree; quantizing a stacked leaf one layer at a
time. Inputs come from numpy with a seed, trees carried across with
``params_from_numpy``.

Tolerances (``PERF.md`` §6): quantized bits identical; fp32 within 1e-5
for one product or one ``_moe_mlp`` (summation order only), 1e-4 for a
forward (as the dense int8 forwards); bf16 ``_moe_mlp`` within 2% of the
output's largest magnitude (the port rounds each product once, JAX
rounds the product and then its scaled value), the selected experts
identical (the router is fp32 on both sides); greedy ids identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from gpustack_tpu.engine.engine import GenRequest as JaxGenRequest
from gpustack_tpu.engine.engine import LLMEngine as JaxLLMEngine
from gpustack_tpu.models import quant as jq
from gpustack_tpu.models import transformer as jt
from gpustack_tpu.models.config import PRESETS as JAX_PRESETS
from gpustack_tpu.models.config import config_from_hf as jax_config_from_hf
from gpustack_tpu_torch.engine.engine import GenRequest, LLMEngine  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.weights import params_from_numpy  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.models import quant as pq  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.models import transformer as pt  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.models.config import PRESETS, config_from_hf, get_config  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.ops import w8a16  # analysis: ignore[metrics-drift]

FP32_TOL = dict(rtol=1e-5, atol=1e-5)
FORWARD_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_REL = 2e-2
D, E, FM, FS = 16, 8, 12, 20


def _bits(t):
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else (
        t.numpy()
    )


def _jbits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


# ---------------------------------------------------------------------------
# the grouped product
# ---------------------------------------------------------------------------


def _expert_weights(rng, K, N):
    """An [E, K, N] weight quantized by the JAX package (as one layer of a
    stacked leaf), with its per-(expert, column) scales."""
    w = (rng.standard_normal((1, E, K, N)) / np.sqrt(K)).astype(np.float32)
    qw = jq._quantize_leaf("we_gate", jnp.asarray(w))
    return qw.q[0], qw.s[0]


@pytest.mark.parametrize("x_kind", ["shared", "h"])
def test_w8a16_bmm_plain_matches_jax_mm(x_kind):
    """The grouped product over a chunk's (token, expert) pairs sorted by
    expert: the gate and up products' rows of x (each token's row once
    per pick) or the down product's rows of h (each pair's own): every
    row against the JAX ``_mm`` over the expert axis at that (token,
    expert), fp32; each segment bit for bit the 2-D plain version."""
    rng = np.random.default_rng(0)
    n, K, N, k = 5, 24, 16, 3
    jqq, jqs = _expert_weights(rng, K, N)
    qw = _port_quant(jq.QuantW(q=jqq, s=jqs))
    q, s = qw.q, qw.s
    top = torch.from_numpy(np.stack([
        rng.choice(E, size=k, replace=False) for _ in range(n)
    ]))
    perm, offsets, _ = pt.moe_dispatch(top, E)
    tok, ex = perm // k, top.flatten()[perm]
    if x_kind == "shared":
        x = rng.standard_normal((1, n, K)).astype(np.float32)
        want = jt._mm("btd,edf->btef", jnp.asarray(x), jq.QuantW(jqq, jqs))
        xs = torch.from_numpy(x[0])[tok]
    else:
        h = rng.standard_normal((1, n, E, K)).astype(np.float32)
        want = jt._mm("btef,efd->bted", jnp.asarray(h), jq.QuantW(jqq, jqs))
        xs = torch.from_numpy(h[0])[tok, ex]
    before = w8a16.w8a16_grouped.launches
    got = w8a16.w8a16_grouped(xs, q, s, offsets, n)   # a CPU tensor: the
    assert w8a16.w8a16_grouped.launches == before     # plain version
    np.testing.assert_allclose(
        got.numpy(), np.asarray(want)[0][tok.numpy(), ex.numpy()],
        **FP32_TOL
    )
    bounds = offsets.tolist()
    for e in range(E):
        rows = slice(bounds[e], bounds[e + 1])
        np.testing.assert_array_equal(
            got[rows].numpy(), w8a16.w8a16_plain(xs[rows], q[e], s[e]).numpy()
        )


@pytest.mark.parametrize("E,M,N,K", [
    (8, 8, 14336, 4096), (8, 2048, 4096, 14336),     # mixtral-8x7b
    (128, 8, 768, 2048), (128, 2048, 2048, 768),     # qwen3-30b-a3b
    (64, 17, 1408, 2048), (2, 40, 16, 1024), (1, 64, 1024, 4096),
])
def test_batched_plans_count_every_expert_in_the_grid(E, M, N, K):
    """The grouped plans over M sorted rows of E experts see the grid the
    card runs, sized without the counts: the GEMV's column slices of the
    min(E, M) experts its rows can reach (K split over a cluster only
    while that grid has fewer CTAs than SMs, the splits covering K once);
    the persistent kernel's at most one CTA per SM, capped by the worst
    case of (ceil(M / BM) + min(E, M)) row units of ceil(N / BN) column
    tiles. The 2-D plan: its tile is 256 wide only when the grid still
    fills the card."""
    sms = 132
    kchunk, ksplit = w8a16.gemv_plan(N, K, sms, min(E, M))
    nb = min(E, M) * -(-N // w8a16.GEMV_BN)
    assert (ksplit - 1) * kchunk < K <= ksplit * kchunk
    assert ksplit == 1 or nb * (ksplit - 1) < sms
    for int8 in (True, False):
        bm, bn, grid = w8a16.grouped_plan(M, E, N, sms, int8)
        assert bm in (64, 128) and bn in (128, 256) + (() if int8 else (192,))
        units = (-(-M // bm) + min(E, M)) * -(-N // bn)
        assert grid == min(sms, units)
    bn, grid_m, grid_n, kchunk, ksplit = w8a16.wgmma_plan(M, N, K, sms)
    assert grid_m == -(-M // 128)
    assert (bn == 256) == (grid_m * -(-N // 256) >= sms)
    assert (ksplit - 1) * kchunk < K <= ksplit * kchunk
    assert ksplit == 1 or grid_m * grid_n * ksplit <= sms


def test_w8a16_bmm_raises_off_the_cpu_and_the_card():
    xs = torch.zeros(6, 8, device="meta")
    offsets = torch.zeros(3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        w8a16.w8a16_grouped(xs, torch.zeros(2, 8, 16, dtype=torch.int8),
                            torch.zeros(2, 16), offsets, 3)
    with pytest.raises(ValueError, match="unsupported device"):
        w8a16.bf16_grouped(xs, torch.zeros(2, 8, 16), offsets, 3)


# ---------------------------------------------------------------------------
# _moe_mlp with int8 experts, per branch
# ---------------------------------------------------------------------------

# (name, config fields, shared: None | "gated" | "ungated", GPT-OSS biases)
CASES = [
    ("softmax_norm_topk", dict(norm_topk_prob=True), None, False),
    ("sigmoid_correction_bias",
     dict(moe_scoring="sigmoid", norm_topk_prob=True), None, False),
    ("softmax_topk_gptoss",
     dict(moe_scoring="softmax_topk", moe_act="gptoss", moe_bias=True),
     None, True),
    ("shared_gated",
     dict(norm_topk_prob=False, shared_expert_intermediate_size=FS,
          shared_expert_gated=True), "gated", False),
    ("shared_ungated",
     dict(shared_expert_intermediate_size=FS, n_shared_experts=1),
     "ungated", False),
    ("routed_scaling",
     dict(moe_scoring="sigmoid", routed_scaling_factor=2.5), None, False),
]


def _cfgs(fields, dtype="float32"):
    base = dict(num_experts=E, num_experts_per_tok=3, moe_intermediate_size=FM,
                hidden_size=D, dtype=dtype, **fields)
    return (
        dataclasses.replace(get_config("tiny-moe"), **base),
        dataclasses.replace(JAX_PRESETS["tiny-moe"], **base),
    )


def _case(shared, biases, seed=0):
    """(plain leaves: x, the router and its bias, the shared gate and the
    GPT-OSS biases; {name: JAX QuantW of one layer}): the expert (and
    shared-expert) weights quantized by the JAX package as one layer of a
    stacked leaf, where the port's quantization of the same weights gives
    the same bits."""
    rng = np.random.default_rng(seed)

    def w(*shape, scale=None):
        scale = scale if scale is not None else 1.0 / np.sqrt(shape[-2])
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    weights = {"we_gate": w(E, D, FM), "we_up": w(E, D, FM),
               "we_down": w(E, FM, D)}
    plain = {"x": w(2, 5, D, scale=1.0), "router": w(D, E),
             "router_bias": w(E, scale=0.3)}
    if shared:
        weights.update(ws_gate=w(D, FS), ws_up=w(D, FS), ws_down=w(FS, D))
        if shared == "gated":
            plain["shared_gate"] = w(D, 1)
    if biases:
        plain.update(bg=w(E, FM, scale=0.1), bu=w(E, FM, scale=0.1),
                     bd=w(E, D, scale=0.1))
    quant = {}
    for name, a in weights.items():
        jw = jq._quantize_leaf(name, jnp.asarray(a[None]))
        tw = pq._quantize_leaf(name, torch.from_numpy(a[None]))
        np.testing.assert_array_equal(tw.q.numpy(), np.asarray(jw.q))
        np.testing.assert_array_equal(_bits(tw.s), _jbits(jw.s))
        quant[name] = jq.QuantW(q=jw.q[0], s=jw.s[0])
    return plain, quant


def _jax_moe(plain, quant, cfg, dtype):
    def j(name, dt=dtype):
        return jnp.asarray(plain[name]).astype(dt)

    shared = biases = None
    if "ws_gate" in quant:
        shared = (quant["ws_gate"], quant["ws_up"], quant["ws_down"],
                  j("shared_gate") if "shared_gate" in plain else None)
    if "bg" in plain:
        biases = (j("bg"), j("bu"), j("bd"))
    return jt._moe_mlp(
        j("x"), j("router"), quant["we_gate"], quant["we_up"],
        quant["we_down"], cfg, router_bias=j("router_bias", jnp.float32),
        shared=shared, biases=biases,
    )


def _port_quant(jw):
    return pq.QuantW(
        q=torch.from_numpy(np.array(jw.q)),
        s=torch.from_numpy(np.array(jw.s).view(np.int16)).view(
            torch.bfloat16
        ),
    )


def _port_moe(plain, quant, cfg, dtype, chunk_tokens=None):
    def t(name, dt=dtype):
        return torch.from_numpy(plain[name]).to(dt)

    qw = {k: _port_quant(v) for k, v in quant.items()}
    shared = biases = None
    if "ws_gate" in qw:
        shared = (qw["ws_gate"], qw["ws_up"], qw["ws_down"],
                  t("shared_gate") if "shared_gate" in plain else None)
    if "bg" in plain:
        biases = (t("bg"), t("bu"), t("bd"))
    out = pt._moe_mlp(
        t("x"), t("router"), qw["we_gate"], qw["we_up"], qw["we_down"], cfg,
        router_bias=t("router_bias", torch.float32), shared=shared,
        biases=biases, chunk_tokens=chunk_tokens,
    )
    idx, _ = pt.moe_route(t("x").reshape(-1, D), t("router"), cfg,
                          t("router_bias", torch.float32))
    return out, idx


class _TopKSpy:
    """``jax.lax`` with ``top_k`` recording the indices JAX selects."""

    def __init__(self):
        self.picks = []

    def __getattr__(self, name):
        return getattr(lax, name)

    def top_k(self, x, k):
        v, i = lax.top_k(x, k)
        self.picks.append(np.asarray(i))
        return v, i


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "case,fields,shared,biases", CASES, ids=[c[0] for c in CASES]
)
def test_int8_moe_mlp_matches_jax(monkeypatch, case, fields, shared, biases,
                                  dtype):
    cfg, jcfg = _cfgs(fields, dtype)
    plain, quant = _case(shared, biases)
    if fields.get("moe_scoring") == "sigmoid":
        # the selection must see the bias: it forces in token 0's lowest
        # expert
        plain["router_bias"][np.argmin(plain["x"][0, 0] @ plain["router"])] \
            += 5.0
    spy = _TopKSpy()
    monkeypatch.setattr(jt, "lax", spy)
    want = _jax_moe(plain, quant, jcfg, getattr(jnp, dtype))
    got, idx = _port_moe(plain, quant, cfg, getattr(torch, dtype))
    (picks,) = spy.picks
    np.testing.assert_array_equal(idx.numpy(), picks.reshape(-1, 3))
    want = np.asarray(want, dtype=np.float32)
    got = got.float().numpy()
    assert got.shape == want.shape == (2, 5, D)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **FP32_TOL)
    else:
        err = np.abs(got - want).max()
        assert err <= BF16_REL * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("chunk", [1, 3, 7])
def test_int8_token_chunks_change_no_value(chunk):
    """Up to fp32 summation order, as for bf16 experts."""
    cfg, _ = _cfgs(dict(shared_expert_intermediate_size=FS,
                        shared_expert_gated=True))
    plain, quant = _case("gated", False, seed=1)
    whole, _ = _port_moe(plain, quant, cfg, torch.float32)
    chunked, _ = _port_moe(plain, quant, cfg, torch.float32,
                           chunk_tokens=chunk)
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(),
                               rtol=1e-6, atol=1e-6)


def test_int8_expert_products_are_three_batched_calls(monkeypatch):
    """Three grouped calls per token chunk, one per product: gate and up
    read one gathered x (the chunk's n·k pairs sorted by expert, ``[n·k,
    D]``), the down product the ``[n·k, Fm]`` h, all three under the
    chunk's one ``offsets``, the chunk's rows the bound on a segment; no
    per-expert loop and no ``[E, tokens, ·]`` tensor."""
    cfg, _ = _cfgs({})
    k = cfg.num_experts_per_tok
    plain, quant = _case(None, False)
    x = torch.from_numpy(plain["x"])
    seen, grouped = [], w8a16.w8a16_grouped

    def spy(xs, q, s, offsets, rows):
        seen.append((xs, tuple(q.shape), offsets, rows))
        return grouped(xs, q, s, offsets, rows)

    monkeypatch.setattr(w8a16, "w8a16_grouped", spy)
    qw = {k: _port_quant(v) for k, v in quant.items()}
    pt._moe_mlp(x, torch.from_numpy(plain["router"]), qw["we_gate"],
                qw["we_up"], qw["we_down"], cfg, chunk_tokens=4)
    want = []
    for n in (4, 4, 2):
        want += [((n * k, D), (E, D, FM), n), ((n * k, D), (E, D, FM), n),
                 ((n * k, FM), (E, FM, D), n)]
    assert [(tuple(c[0].shape), c[1], c[3]) for c in seen] == want
    for c in range(0, len(seen), 3):
        assert seen[c][0] is seen[c + 1][0]
        assert seen[c][2] is seen[c + 1][2] is seen[c + 2][2]


def test_int8_chunk_budget_counts_the_expert_outputs():
    """A chunk holds the routed transients, x gathered, g, u, h and the
    outputs y: k·(3·Fm + 2·D) values a token, 100 KiB at qwen3-30b-a3b's
    widths (top-8, Fm 768, d 2048, bf16) against the dense dispatch's
    1088 KiB; 200 KiB at mixtral-8x7b's (top-2, Fm 14336, d 4096)."""
    tokens = pt.moe_chunk_tokens(8, 768, 2048, 2)
    assert tokens == pt.MOE_CHUNK_BYTES // (100 * 1024) >= 8 * 2048
    assert pt.moe_chunk_tokens(2, 14336, 4096, 2) == (
        pt.MOE_CHUNK_BYTES // (200 * 1024)
    )


# ---------------------------------------------------------------------------
# int8 forwards and the engine
# ---------------------------------------------------------------------------

YARN = {
    "type": "yarn", "factor": 40, "beta_fast": 32, "beta_slow": 1,
    "mscale": 0.707, "mscale_all_dim": 0.707,
    "original_max_position_embeddings": 64,
}


def _deepseek_hf(q_lora_rank, first_k_dense=1):
    """A small DeepSeek-V2 ``config.json``: head_dim 16 (nope 8 + rope
    8), V 12 wide, two shared experts, ``first_k_dense`` dense layers
    first."""
    return dict(
        architectures=["DeepseekV2ForCausalLM"], model_type="deepseek_v2",
        vocab_size=264, hidden_size=32, intermediate_size=64,
        moe_intermediate_size=16, num_hidden_layers=3,
        num_attention_heads=4, num_key_value_heads=4,
        n_shared_experts=2, n_routed_experts=4, routed_scaling_factor=1.0,
        kv_lora_rank=16, q_lora_rank=q_lora_rank, qk_rope_head_dim=8,
        qk_nope_head_dim=8, v_head_dim=12, num_experts_per_tok=2,
        first_k_dense_replace=first_k_dense, norm_topk_prob=False,
        max_position_embeddings=256, rope_theta=10000.0, rms_norm_eps=1e-6,
        tie_word_embeddings=False, rope_scaling=dict(YARN),
    )


GPTOSS = dict(
    sliding_window=16, layer_sliding=(True, False), qkv_bias=True,
    o_bias=True, attn_sinks=True, num_experts=4, num_experts_per_tok=2,
    moe_intermediate_size=32, moe_scoring="softmax_topk", moe_act="gptoss",
    moe_bias=True, rope_theta=150000.0,
    rope_scaling={"rope_type": "yarn", "factor": 4.0, "beta_fast": 32.0,
                  "beta_slow": 1.0, "truncate": False,
                  "original_max_position_embeddings": 32},
)
# leaves the JAX init draws as zeros: drawn at random, so a sign or a swap
# shows
ZERO_INIT = {"sinks": 1.0, "bq": 0.2, "bk": 0.2, "bv": 0.2, "bo": 0.2,
             "router_bias": 0.5, "we_gate_b": 0.2, "we_up_b": 0.2,
             "we_down_b": 0.2}


def _family_cfgs(family):
    """(port config, JAX config) of one tiny configuration, fp32."""
    if family.startswith("deepseek"):
        hf = _deepseek_hf(24 if family == "deepseek-q-lora" else None,
                          0 if family == "deepseek-all-moe" else 1)
        return (dataclasses.replace(config_from_hf(hf), dtype="float32"),
                dataclasses.replace(jax_config_from_hf(hf), dtype="float32"))
    fields = {
        "mixtral": dict(norm_topk_prob=True),
        "qwen3-moe": dict(qk_norm=True, norm_topk_prob=True),
        "gptoss": GPTOSS,
    }[family]
    fields = {**fields, "dtype": "float32"}
    return (dataclasses.replace(get_config("tiny-moe"), **fields),
            dataclasses.replace(JAX_PRESETS["tiny-moe"], **fields))


FAMILIES = ["mixtral", "qwen3-moe", "deepseek", "deepseek-q-lora", "gptoss"]


def _int8_pair(family, seed=0):
    """(cfg, jcfg, JAX int8 tree, port int8 tree): the JAX init in fp32
    (its zero-initialised leaves drawn at random), quantized by the JAX
    package, carried across."""
    cfg, jcfg = _family_cfgs(family)
    tree = jax.tree.map(np.asarray, jt.init_params(
        jcfg, jax.random.key(seed), dtype=jnp.float32
    ))
    rng = np.random.default_rng(seed + 100)
    for key, spread in ZERO_INIT.items():
        if key in tree["layers"]:
            leaf = tree["layers"][key]
            tree["layers"][key] = rng.uniform(
                -spread, spread, leaf.shape
            ).astype(np.float32)
    jtree = jq.quantize_params(jax.tree.map(jnp.asarray, tree))
    return cfg, jcfg, jtree, params_from_numpy(
        jax.tree.map(np.asarray, jtree), "cpu"
    )


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a)).long()


def _positions(B, T, start=0):
    return np.broadcast_to(
        np.arange(start, start + T, dtype=np.int32), (B, T)
    ).copy()


@pytest.mark.parametrize("family", FAMILIES)
def test_int8_forward_matches_jax(family):
    """Prefill of 10, a 6-token continuation, a decode step and a verify
    block of 4 positions at each row's own offset, over one cache, against
    the JAX ``forward`` on the same int8 tree."""
    cfg, jcfg, jtree, ttree = _int8_pair(family)
    assert isinstance(ttree["layers"]["we_gate"], pq.QuantW)
    B, S = 2, 32
    toks = np.random.default_rng(1).integers(1, 264, (B, 21)).astype(
        np.int32
    )
    jcache = jt.KVCache.create(jcfg, B, S)
    tcache = pt.KVCache.create(cfg, B, S, torch.device("cpu"))
    steps = [
        (toks[:, :10], _positions(B, 10), {}),
        (toks[:, 10:16], _positions(B, 6, 10), {}),
        (toks[:, 16:17], _positions(B, 1, 16), {}),
        (toks[:, 17:21],
         np.stack([np.arange(17, 21), np.arange(14, 18)]).astype(np.int32),
         {"clamp_writes": True}),
    ]
    for block, pos, kw in steps:
        want, jcache = jt.forward(jtree, jcfg, jnp.asarray(block),
                                  jnp.asarray(pos), jcache)
        got, tcache = pt.forward(ttree, cfg, _t(block), _t(pos), tcache,
                                 **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **FORWARD_TOL)
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k),
                               **FORWARD_TOL)


PROMPTS = [[3, 1, 4], list(range(5, 40)), [5, 8, 9, 7, 9, 5, 8, 9]]
MAX_TOKENS = 6


def _port_greedy(cfg, ttree):
    eng = LLMEngine(cfg, ttree, max_slots=4, max_seq_len=64, device="cpu")
    eng.start()
    try:
        reqs = [eng.submit(GenRequest(
            prompt_ids=p, max_tokens=MAX_TOKENS, temperature=0.0))
            for p in PROMPTS]
        for r in reqs:
            assert r.done.wait(300), r.request_id
        return [r.output_ids for r in reqs]
    finally:
        eng.stop()


# the JAX engine shards an int8 tree's "layers" only (its quant_pspecs),
# so a DeepSeek tree with a dense_layers stack is compared on the
# configuration without one here, and through the forwards above
@pytest.mark.parametrize("family", ["mixtral", "deepseek-all-moe", "gptoss"])
def test_int8_engine_greedy_ids_match_jax_engine(family):
    cfg, jcfg, jtree, ttree = _int8_pair(family, seed=2)
    jeng = JaxLLMEngine(jcfg, jtree, max_slots=4, max_seq_len=64,
                        pipeline_depth=0)
    jeng.start()
    try:
        reqs = [jeng.submit(JaxGenRequest(
            prompt_ids=p, max_tokens=MAX_TOKENS, temperature=0.0))
            for p in PROMPTS]
        for r in reqs:
            assert r.done.wait(300), r.request_id
        want = [r.output_ids for r in reqs]
    finally:
        jeng.stop()
    got = _port_greedy(cfg, ttree)
    assert got == want
    assert all(len(ids) == MAX_TOKENS for ids in got)


def test_int8_engine_with_a_dense_layer_matches_jax_forward():
    """DeepSeek with its first_k_dense layer and int8 MLA: the engine's
    greedy ids against greedy decoding through the JAX ``forward`` (no
    cache: the whole sequence each step) on the same int8 tree."""
    cfg, jcfg, jtree, ttree = _int8_pair("deepseek", seed=2)
    assert "dense_layers" in ttree
    want = []
    for prompt in PROMPTS:
        ids = list(prompt)
        for _ in range(MAX_TOKENS):
            toks = np.asarray([ids], np.int32)
            logits, _ = jt.forward(jtree, jcfg, jnp.asarray(toks),
                                   jnp.asarray(_positions(1, len(ids))))
            ids.append(int(np.asarray(logits)[0, -1].argmax()))
        want.append(ids[len(prompt):])
    assert _port_greedy(cfg, ttree) == want


# ---------------------------------------------------------------------------
# the int8 tree drawn directly, and quantizing a layer at a time
# ---------------------------------------------------------------------------


def _desc(tree, quant_cls, conv):
    out = {}
    for key, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{key}/{k}": d for k, d in
                        _desc(v, quant_cls, conv).items()})
        elif isinstance(v, quant_cls):
            out[key] = ("int8", conv(v.q), conv(v.s))
        else:
            out[key] = conv(v)
    return out


def _torch_desc(t):
    return tuple(t.shape), str(t.dtype).split(".")[-1]


def _jax_desc(a):
    return tuple(a.shape), str(a.dtype)


@pytest.mark.parametrize(
    "family", FAMILIES + ["deepseek-all-moe", "gemma-tied", "dense"]
)
def test_init_quantized_params_tree_matches_jax(family):
    """Every leaf, its shapes and dtypes, against
    ``jax.eval_shape(quantize_params ∘ init_params)`` (a tied embedding
    stays bf16), drawn on the CPU; the int8 draws' spread is that of an
    absmax-quantized normal (~127 / 3)."""
    if family == "gemma-tied":
        gemma = dict(hidden_act="gelu_tanh", norm_delta_gain=True,
                     embed_scale=True, tie_word_embeddings=True,
                     post_norms=True, qk_norm=True)
        cfg = dataclasses.replace(get_config("tiny"), **gemma)
        jcfg = dataclasses.replace(JAX_PRESETS["tiny"], **gemma)
    elif family == "dense":
        cfg, jcfg = get_config("tiny"), JAX_PRESETS["tiny"]
    else:
        cfg, jcfg = _family_cfgs(family)
        cfg = dataclasses.replace(cfg, dtype="bfloat16")
        jcfg = dataclasses.replace(jcfg, dtype="bfloat16")
    got = pq.init_quantized_params(cfg, seed=0, device="cpu")
    want = jax.eval_shape(
        lambda: jq.quantize_params(jt.init_params(jcfg, jax.random.key(0)))
    )
    assert _desc(got, pq.QuantW, _torch_desc) == _desc(
        want, jq.QuantW, _jax_desc
    )
    q = got["layers"]["wq" if "wq" in got["layers"] else "wq_b"].q.float()
    assert 30 < q.std().item() < 55


@pytest.mark.parametrize(
    "name", ["mixtral-8x7b", "qwen3-30b-a3b", "deepseek-v2-lite",
             "gpt-oss-20b"]
)
def test_init_quantized_params_full_size_structure(name):
    """The served presets' int8 trees, on the meta device (no memory):
    the leaves, shapes and dtypes of ``jax.eval_shape(quantize_params ∘
    init_params)``; mixtral-8x7b's is ~46.7 GB of int8."""
    got = pt.init_params(PRESETS[name], torch.Generator(), device="meta",
                         int8=True)
    want = jax.eval_shape(lambda: jq.quantize_params(
        jt.init_params(JAX_PRESETS[name], jax.random.key(0))
    ))
    assert _desc(got, pq.QuantW, _torch_desc) == _desc(
        want, jq.QuantW, _jax_desc
    )
    if name == "mixtral-8x7b":
        nbytes = sum(
            w.q.numel() + 2 * w.s.numel()
            for w in [got["embed"], got["lm_head"], *got["layers"].values()]
            if isinstance(w, pq.QuantW)
        )
        assert 46.5e9 < nbytes < 46.9e9


@pytest.mark.parametrize("name", ["we_gate", "we_down", "ws_up", "wkv_b",
                                  "lm_head"])
def test_quantize_leaf_one_layer_at_a_time_is_bit_identical(monkeypatch,
                                                             name):
    """A stacked leaf's fp32 copy is one layer's: every widening sees one
    layer's shape, and the bits equal the JAX package's over the whole
    leaf. A leaf without a layer axis is quantized whole."""
    rng = np.random.default_rng(3)
    shape = {"we_gate": (3, 4, 16, 24), "we_down": (3, 4, 24, 16),
             "ws_up": (3, 16, 40), "wkv_b": (2, 16, 48),
             "lm_head": (16, 264)}[name]
    w = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    w[0, 0] = 0.0              # an all-zero slice: the 1e-8 scale floor
    seen, one = [], pq._quantize_one

    def spy(t, axes):
        seen.append(tuple(t.shape))
        return one(t, axes)

    monkeypatch.setattr(pq, "_quantize_one", spy)
    for dtype in (torch.float32, torch.bfloat16):
        seen.clear()
        tw = torch.from_numpy(w).to(dtype)
        got = pq._quantize_leaf(name, tw)
        want = jq._quantize_leaf(
            name, jnp.asarray(tw.float().numpy()).astype(
                jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
            )
        )
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
        np.testing.assert_array_equal(_bits(got.s), _jbits(want.s))
        stacked = name != "lm_head"
        assert seen == ([shape[1:]] * shape[0] if stacked else [shape])
