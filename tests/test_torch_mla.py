"""DeepSeek's MLA path of the PyTorch port against the JAX package.

Small DeepSeek-V2/V3 configurations built by each package's own
``config_from_hf`` from the same ``config.json`` dict (no preset is
added): the interleaved rope, MLA's YaRN table and its mscale² softmax
scale, one MLA block with and without ``q_lora_rank``, forwards with the
``first_k_dense`` split with and without a cache (plain, and the port's
flash against the JAX ``flash_interpret`` kernel), sigmoid scoring with
the correction bias (the V3 branch), ``init_params`` shapes of
``deepseek-v2-lite`` on the meta device, and the engine's greedy ids
(chunked prefill with the host KV tier, n-gram speculation) and an
embedding against the JAX engine's.

Tolerances (``PERF.md`` §6): fp32 within 1e-5 (summation order only);
bf16 within 2% of the output's largest magnitude (the two frameworks
round bf16 at other places); greedy ids identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpustack_tpu.engine.engine import GenRequest as JaxGenRequest
from gpustack_tpu.engine.engine import LLMEngine as JaxLLMEngine
from gpustack_tpu.models import transformer as jt
from gpustack_tpu.models.config import PRESETS as JAX_PRESETS
from gpustack_tpu.models.config import config_from_hf as jax_config_from_hf
from gpustack_tpu_torch.engine.engine import GenRequest, LLMEngine  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.weights import params_from_numpy  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.models import quant as pq  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.models import transformer as pt  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.models.config import PRESETS, config_from_hf  # analysis: ignore[metrics-drift]

FP32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_REL = 2e-2

YARN = {
    "type": "yarn", "factor": 40, "beta_fast": 32, "beta_slow": 1,
    "mscale": 0.707, "mscale_all_dim": 0.707,
    "original_max_position_embeddings": 64,
}


def _hf(q_lora_rank=24, experts=4, layers=3, **extra):
    """A small DeepSeek-V2 ``config.json`` (V3 with ``v3=True`` fields in
    ``extra``): head_dim 16 (nope 8 + rope 8), V 12 wide, one dense layer
    first, YaRN as the shipped configs have it."""
    hf = dict(
        architectures=["DeepseekV2ForCausalLM"], model_type="deepseek_v2",
        vocab_size=264, hidden_size=32, intermediate_size=64,
        moe_intermediate_size=16, num_hidden_layers=layers,
        num_attention_heads=4, num_key_value_heads=4,
        n_shared_experts=2, n_routed_experts=experts,
        routed_scaling_factor=1.0, kv_lora_rank=16,
        q_lora_rank=q_lora_rank, qk_rope_head_dim=8, qk_nope_head_dim=8,
        v_head_dim=12, num_experts_per_tok=2, first_k_dense_replace=1,
        norm_topk_prob=False, max_position_embeddings=256,
        rope_theta=10000.0, rms_norm_eps=1e-6, tie_word_embeddings=False,
        rope_scaling=dict(YARN),
    )
    hf.update(extra)
    return hf


V3 = dict(
    architectures=["DeepseekV3ForCausalLM"], model_type="deepseek_v3",
    scoring_func="sigmoid", topk_method="noaux_tc", n_group=1,
    topk_group=1, norm_topk_prob=True, routed_scaling_factor=2.5,
)


def _cfgs(hf, dtype="float32"):
    return (
        dataclasses.replace(config_from_hf(hf), dtype=dtype),
        dataclasses.replace(jax_config_from_hf(hf), dtype=dtype),
    )


def _pair(hf, dtype="float32", seed=0, router_bias=False):
    """Both configs, the JAX tree (JAX init, in ``dtype``) and the same
    numbers as the port's tree. ``router_bias`` draws a nonzero
    correction bias (JAX inits it to zeros)."""
    cfg, jcfg = _cfgs(hf, dtype)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jparams = jt.init_params(jcfg, jax.random.key(seed), dtype=jdt)
    if router_bias:
        rng = np.random.default_rng(seed)
        shape = jparams["layers"]["router_bias"].shape
        jparams["layers"]["router_bias"] = jnp.asarray(
            rng.standard_normal(shape) * 0.3, jnp.float32
        )
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return cfg, jcfg, jparams, tparams


def _tokens(seed, B, T, vocab=264):
    return np.random.default_rng(seed).integers(1, vocab, (B, T)).astype(
        np.int32
    )


def _positions(B, T, start=0):
    return np.broadcast_to(
        np.arange(start, start + T, dtype=np.int32), (B, T)
    ).copy()


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


# ---------------------------------------------------------------------------
# rope and scale
# ---------------------------------------------------------------------------


def test_interleaved_rope_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 8)).astype(np.float32)
    ang = rng.standard_normal((2, 5, 4)).astype(np.float32)
    sin, cos = np.sin(ang), np.cos(ang)
    want = jt.apply_rope_interleaved(jnp.asarray(x), jnp.asarray(sin),
                                     jnp.asarray(cos))
    got = pt.apply_rope_interleaved(torch.from_numpy(x),
                                    torch.from_numpy(sin),
                                    torch.from_numpy(cos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32_TOL)
    # pairs (x[2i], x[2i+1]) rotate, not halves: a zero angle is identity
    # and a quarter turn maps (a, b) to (-b, a)
    quarter = pt.apply_rope_interleaved(
        torch.tensor([[[[1.0, 2.0, 3.0, 4.0]]]]),
        torch.ones(1, 1, 2), torch.zeros(1, 1, 2),
    )
    assert quarter.flatten().tolist() == [-2.0, 1.0, -4.0, 3.0]


@pytest.mark.parametrize("rope", ["yarn", "yarn_no_mscale_all", "plain"])
def test_mla_rope_table_and_scale_match_jax(rope):
    """MLA's frequency table (over ``qk_rope_head_dim``, YaRN's attention
    factor riding sin and cos) and softmax scale (``1/sqrt(head_dim)``
    times ``yarn_get_mscale(factor, mscale_all_dim)²``), against the JAX
    forward's expressions built from its own helpers."""
    rs = {
        "yarn": dict(YARN),
        "yarn_no_mscale_all": {"type": "yarn", "factor": 4,
                               "original_max_position_embeddings": 64},
        "plain": None,
    }[rope]
    cfg, jcfg = _cfgs(_hf(rope_scaling=rs))
    inv, att = pt.mla_rope_params(cfg)
    if rs is None:
        want_inv, want_att = jt._inv_freq(jcfg.rope_theta, 8), 1.0
    else:
        want_inv, want_att = jt.yarn_inv_freq(jcfg.rope_theta, 8, rs)
    np.testing.assert_allclose(inv.numpy(), np.asarray(want_inv), rtol=1e-6)
    assert att == pytest.approx(want_att, rel=1e-12)
    want_scale = 1.0 / np.sqrt(16)
    if rs is not None and rs.get("mscale_all_dim"):
        m = jt.yarn_get_mscale(float(rs["factor"]), rs["mscale_all_dim"])
        want_scale *= m * m
    assert pt.attn_scale(cfg) == pytest.approx(want_scale, rel=1e-12)


def test_deepseek_v2_lite_scale_carries_the_mscale():
    """At the preset's YaRN (factor 40, mscale = mscale_all_dim = 0.707)
    the sin/cos factor is 1 and the softmax scale carries ~1.59."""
    cfg = PRESETS["deepseek-v2-lite"]
    _, att = pt.mla_rope_params(cfg)
    assert att == pytest.approx(1.0)
    assert pt.attn_scale(cfg) * np.sqrt(192) == pytest.approx(
        (0.1 * 0.707 * np.log(40) + 1.0) ** 2, rel=1e-12
    )
    assert pt.attn_scale(cfg) * np.sqrt(192) == pytest.approx(1.59, abs=5e-3)


# ---------------------------------------------------------------------------
# one MLA block; forwards
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q_lora_rank", [0, 24])
def test_one_mla_block_matches_jax(q_lora_rank, dtype):
    """A one-layer dense MLA model (no experts): the block's query
    branch, latent K/V, interleaved rope, zero-padded V and its dropped
    tail, against the JAX forward."""
    hf = _hf(q_lora_rank=q_lora_rank, experts=0, layers=1)
    cfg, jcfg, jparams, tparams = _pair(hf, dtype)
    assert cfg.is_mla and not cfg.is_moe
    assert ("wq_a" in tparams["layers"]) == bool(q_lora_rank)
    toks, pos = _tokens(0, 2, 9), _positions(2, 9)
    want, _ = jt.forward(jparams, jcfg, jnp.asarray(toks), jnp.asarray(pos))
    got, _ = pt.forward(tparams, cfg, _t(toks), _t(pos))
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, **FP32_TOL)
    else:
        err = np.abs(got.numpy() - want).max()
        assert err <= BF16_REL * np.abs(want).max(), err


def test_mla_qkv_are_real_tensors():
    """K and V leave the block materialised: the kernel's TMA maps refuse
    a stride of 0, and K's rope part is one rotation shared by the heads,
    V's tail zeros."""
    cfg, _, _, tparams = _pair(_hf(experts=0, layers=1))
    h = torch.randn(2, 5, cfg.hidden_size)
    inv, _ = pt.mla_rope_params(cfg)
    sin, cos = pt.rope_sin_cos(_t(_positions(2, 5)), inv)
    q, k, v = pt._mla_qkv(h, tparams["layers"], 0, cfg, sin, cos)
    for t in (q, k, v):
        assert t.shape == (2, 5, 4, 16) and t.is_contiguous()
    assert torch.equal(k[:, :, 0, 8:], k[:, :, 3, 8:])
    assert not v[..., 12:].any()


FORWARD_CASES = {
    "v2_q_lora": dict(q_lora_rank=24),
    "v2_direct_q": dict(q_lora_rank=0),
    "v2_routed_scaling": dict(routed_scaling_factor=2.0),
    "v3_sigmoid_bias": dict(V3),
}


@pytest.mark.parametrize("name", sorted(FORWARD_CASES))
def test_forward_without_cache_matches_jax(name):
    """1 dense layer, then 2 MoE layers (``dense_layers`` then
    ``layers``), against the JAX forward; the V3 case routes with sigmoid
    scores and a nonzero correction bias."""
    cfg, jcfg, jparams, tparams = _pair(
        _hf(**FORWARD_CASES[name]), router_bias=name.startswith("v3")
    )
    assert cfg.first_k_dense == 1
    assert tparams["dense_layers"]["w_gate"].shape[0] == 1
    assert tparams["layers"]["we_gate"].shape[0] == 2
    toks, pos = _tokens(1, 2, 12), _positions(2, 12)
    want, _ = jt.forward(jparams, jcfg, jnp.asarray(toks), jnp.asarray(pos))
    got, _ = pt.forward(tparams, cfg, _t(toks), _t(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32_TOL)


@pytest.mark.parametrize("attn_impl", ["plain", "flash"])
@pytest.mark.parametrize("name", sorted(FORWARD_CASES))
def test_prefill_continuation_decode_with_cache_match_jax(name, attn_impl):
    """A prefill, a continuation at ``q_offset`` > 0 and a decode step
    through the cache (layer 0 of the cache is the dense stack's): the
    port's plain or flash (its plain version here) against JAX's XLA or
    ``flash_interpret`` kernel; logits and the whole cache."""
    cfg, jcfg, jparams, tparams = _pair(
        _hf(**FORWARD_CASES[name]), router_bias=name.startswith("v3")
    )
    jimpl = "flash_interpret" if attn_impl == "flash" else "xla"
    B, T1, T2, S = 1, 10, 6, 32
    toks = _tokens(2, B, T1 + T2 + 1)
    jcache = jt.KVCache.create(jcfg, B, S)
    tcache = pt.KVCache.create(cfg, B, S, torch.device("cpu"))
    for start, T in ((0, T1), (T1, T2), (T1 + T2, 1)):
        ids, pos = toks[:, start:start + T], _positions(B, T, start)
        want, jcache = jt.forward(
            jparams, jcfg, jnp.asarray(ids), jnp.asarray(pos), jcache,
            attn_impl=jimpl,
        )
        got, tcache = pt.forward(
            tparams, cfg, _t(ids), _t(pos), tcache, attn_impl=attn_impl,
            q_offset=start,
        )
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32_TOL)
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k),
                               **FP32_TOL)
    np.testing.assert_allclose(tcache.v.numpy(), np.asarray(jcache.v),
                               **FP32_TOL)


def test_bf16_forward_with_cache_matches_jax():
    cfg, jcfg, jparams, tparams = _pair(_hf(), "bfloat16")
    toks, pos = _tokens(3, 2, 12), _positions(2, 12)
    want, _ = jt.forward(jparams, jcfg, jnp.asarray(toks), jnp.asarray(pos),
                         jt.KVCache.create(jcfg, 2, 16))
    got, _ = pt.forward(tparams, cfg, _t(toks), _t(pos),
                        pt.KVCache.create(cfg, 2, 16, torch.device("cpu")),
                        attn_impl="flash")
    want = np.asarray(want, np.float32)
    err = np.abs(got.numpy() - want).max()
    assert err <= BF16_REL * np.abs(want).max(), err


def test_tree_depth_must_match_the_config():
    cfg, _, _, tparams = _pair(_hf())
    short = dataclasses.replace(cfg, num_layers=4)
    with pytest.raises(ValueError, match="3 layers"):
        pt.forward(tparams, short, _t(_tokens(0, 1, 4)), _t(_positions(1, 4)))


# ---------------------------------------------------------------------------
# init shapes; int8
# ---------------------------------------------------------------------------


def _shapes(tree, conv):
    return {
        k: _shapes(v, conv) if isinstance(v, dict) else conv(v)
        for k, v in tree.items()
    }


@pytest.mark.parametrize("hf", ["deepseek-v2-lite", "v2_q_lora", "v3"])
def test_init_params_shapes_match_jax(hf):
    """Shapes and dtypes of the whole tree, ``dense_layers`` included (on
    the meta device: no memory), against ``jax.eval_shape``."""
    if hf == "deepseek-v2-lite":
        cfg, jcfg = PRESETS[hf], JAX_PRESETS[hf]
    else:
        cfg, jcfg = _cfgs(_hf(**(V3 if hf == "v3" else {})), "bfloat16")
    tparams = pt.init_params(cfg, torch.Generator(), device="meta")
    jshapes = jax.eval_shape(lambda: jt.init_params(jcfg, jax.random.key(0)))
    assert _shapes(tparams, lambda t: (tuple(t.shape), str(t.dtype)[6:])) == (
        _shapes(jshapes, lambda a: (tuple(a.shape), str(a.dtype)))
    )
    assert set(tparams) >= {"dense_layers", "layers"}


def test_int8_with_mla_is_refused_before_any_weight_is_drawn():
    """int8 with MLA serves: a dense MLA config's int8 tree, drawn on the
    CPU (``wq_a``, ``wq_b``, ``wkv_a``, ``wkv_b`` and ``wo`` int8, the
    latent norms bf16), and deepseek-v2-lite's on the meta device, each
    with the leaves, shapes and dtypes of ``jax.eval_shape`` of the JAX
    ``quantize_params(init_params(cfg))``."""
    from gpustack_tpu.models import quant as jq

    def desc(tree, quant_cls, conv):
        return {
            k: desc(v, quant_cls, conv) if isinstance(v, dict)
            else (conv(v.q), conv(v.s)) if isinstance(v, quant_cls)
            else conv(v)
            for k, v in tree.items()
        }

    cfg, jcfg = _cfgs(_hf(experts=0, layers=1), "bfloat16")
    for got, jc in (
        (pq.init_quantized_params(cfg, device="cpu"), jcfg),
        (pt.init_params(PRESETS["deepseek-v2-lite"], torch.Generator(),
                        device="meta", int8=True),
         JAX_PRESETS["deepseek-v2-lite"]),
    ):
        want = jax.eval_shape(lambda: jq.quantize_params(
            jt.init_params(jc, jax.random.key(0))
        ))
        assert desc(got, pq.QuantW,
                    lambda t: (tuple(t.shape), str(t.dtype)[6:])) == desc(
            want, jq.QuantW, lambda a: (tuple(a.shape), str(a.dtype))
        )
        assert isinstance(got["layers"]["wkv_b"], pq.QuantW)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

MAX_TOKENS = 6
BASE = np.random.default_rng(13).integers(1, 264, 60).tolist()
PROMPTS = [[3, 1, 4], BASE, BASE + [7, 7, 9, 2], [5, 8, 9, 7, 9, 5, 8, 9]]
EMBED_IDS = [[5, 8, 9, 7, 9, 3]]
# chunked prefill with the host KV tier: the repeat of BASE reuses its
# cached blocks
ENGINE_KW = dict(prefill_chunk=32, host_kv_cache_mb=64, kv_block_tokens=16)


@pytest.fixture(scope="module")
def models():
    return _pair(_hf())


def _serve(eng, gen_cls):
    eng.start()
    try:
        outs = []
        for p in PROMPTS:
            req = eng.generate(gen_cls(prompt_ids=p, max_tokens=MAX_TOKENS,
                                       temperature=0.0), timeout=300)
            if eng._kv_copy_pool is not None:
                # the store lands before the next prompt probes the cache
                eng._kv_copy_pool.submit(lambda: None).result(timeout=60)
            outs.append(req.output_ids)
        return outs, eng.health(), np.asarray(eng.embed(EMBED_IDS))
    finally:
        eng.stop()


@pytest.fixture(scope="module")
def jax_run(models):
    _, jcfg, jparams, _ = models
    return _serve(JaxLLMEngine(jcfg, jparams, max_slots=2, max_seq_len=128,
                               pipeline_depth=0, **ENGINE_KW), JaxGenRequest)


@pytest.mark.parametrize("speculative", ["", "ngram"])
def test_engine_greedy_ids_identical_to_jax_engine(models, jax_run,
                                                   speculative):
    """Chunked prefill, the host KV tier and, with ``ngram``, speculative
    verify blocks on the MLA model: the JAX engine's greedy ids, reuse
    counts and embedding."""
    cfg, _, _, tparams = models
    got, health, vec = _serve(
        LLMEngine(cfg, tparams, max_slots=2, max_seq_len=128, device="cpu",
                  pipeline_depth=2, speculative=speculative, **ENGINE_KW),
        GenRequest,
    )
    want, jhealth, jvec = jax_run
    assert got == want
    for key in ("kv_cache_prefix_hits", "kv_cache_prefix_tokens_reused"):
        assert health[key] == jhealth[key] > 0
    if speculative:
        assert health["spec_steps"] > 0
    np.testing.assert_allclose(vec, jvec, **FP32_TOL)
