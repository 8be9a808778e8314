"""Transformer core of the PyTorch port against the JAX ``forward``.

The JAX tree from ``init_params`` (``tiny``, float32) is carried across
through numpy (``params_from_numpy``); tokens come from numpy with a seed.
Tolerance: float32 on both sides, rtol/atol 1e-4 on logits (two
frameworks' matmul and softmax summation orders; the logits are O(1)).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpustack_tpu.models import transformer as jt
from gpustack_tpu.models.config import PRESETS as JAX_PRESETS
from gpustack_tpu.models.config import ModelConfig as JaxModelConfig
from gpustack_tpu_torch.engine.runner import greedy_reference  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.weights import params_from_numpy  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.models import quant as pq  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.models import transformer as pt  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.models.config import PRESETS, get_config  # analysis: ignore[metrics-drift]

TOL = dict(rtol=1e-4, atol=1e-4)


def _pair(name="tiny"):
    """(cfg, JAX params, port params) in float32 from one JAX init."""
    cfg = dataclasses.replace(get_config(name), dtype="float32")
    jcfg = dataclasses.replace(JAX_PRESETS[name], dtype="float32")
    jparams = jt.init_params(jcfg, jax.random.key(0), dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, jparams)
    return cfg, jcfg, jparams, params_from_numpy(tree, "cpu")


def _tokens(seed, B, T, vocab):
    return np.random.default_rng(seed).integers(1, vocab, (B, T)).astype(
        np.int32
    )


@pytest.mark.parametrize("name", ["tiny", "tiny-qwen3"])
def test_logits_without_cache_match_jax(name):
    cfg, jcfg, jparams, tparams = _pair(name)
    toks = _tokens(0, 2, 12, cfg.vocab_size)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12))
    want, _ = jt.forward(jparams, jcfg, jnp.asarray(toks), jnp.asarray(pos))
    got, cache = pt.forward(
        tparams, cfg, torch.from_numpy(toks).long(),
        torch.from_numpy(pos.copy()).long(),
    )
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("attn_impl", ["plain", "flash"])
def test_prefill_then_decode_with_cache_match_jax(attn_impl):
    cfg, jcfg, jparams, tparams = _pair()
    B, T, S = 2, 10, 32
    toks = _tokens(1, B, T + 1, cfg.vocab_size)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T))

    jcache = jt.KVCache.create(jcfg, B, S)
    want1, jcache = jt.forward(
        jparams, jcfg, jnp.asarray(toks[:, :T]), jnp.asarray(pos), jcache
    )
    tcache = pt.KVCache.create(cfg, B, S, torch.device("cpu"))
    got1, tcache = pt.forward(
        tparams, cfg, torch.from_numpy(toks[:, :T]).long(),
        torch.from_numpy(pos.copy()).long(), tcache, attn_impl=attn_impl,
    )
    np.testing.assert_allclose(got1.numpy(), np.asarray(want1), **TOL)
    np.testing.assert_allclose(
        tcache.k.numpy(), np.asarray(jcache.k), **TOL
    )

    # one decode step at position T (the cache was updated in place)
    dpos = np.full((B, 1), T, np.int32)
    want2, jcache = jt.forward(
        jparams, jcfg, jnp.asarray(toks[:, T:]), jnp.asarray(dpos), jcache
    )
    got2, tcache = pt.forward(
        tparams, cfg, torch.from_numpy(toks[:, T:]).long(),
        torch.from_numpy(dpos).long(), tcache,
    )
    np.testing.assert_allclose(got2.numpy(), np.asarray(want2), **TOL)
    np.testing.assert_allclose(
        tcache.v.numpy(), np.asarray(jcache.v), **TOL
    )


def test_cache_write_past_the_end_raises():
    cfg, _, _, tparams = _pair()
    cache = pt.KVCache.create(cfg, 1, 8, torch.device("cpu"))
    with pytest.raises(IndexError):
        pt.forward(
            tparams, cfg, torch.ones(1, 4, dtype=torch.long),
            torch.arange(6, 10)[None, :], cache,
        )


def test_flash_prefill_must_start_at_position_zero():
    """Flash rows start at ``q_offset`` (0 unless the caller says): rows at
    2..5 are refused at the default offset and taken at ``q_offset=2``."""
    cfg, _, _, tparams = _pair()
    cache = pt.KVCache.create(cfg, 1, 16, torch.device("cpu"))
    with pytest.raises(ValueError, match="q_offset 0"):
        pt.forward(
            tparams, cfg, torch.ones(1, 4, dtype=torch.long),
            torch.arange(2, 6)[None, :], cache, attn_impl="flash",
        )
    pt.forward(
        tparams, cfg, torch.ones(1, 4, dtype=torch.long),
        torch.arange(2, 6)[None, :], cache, attn_impl="flash", q_offset=2,
    )


def test_return_hidden_and_tied_embeddings():
    cfg, jcfg, jparams, tparams = _pair()
    cfg = dataclasses.replace(cfg, tie_word_embeddings=True)
    jcfg = dataclasses.replace(jcfg, tie_word_embeddings=True)
    toks = _tokens(2, 1, 8, cfg.vocab_size)
    pos = np.arange(8, dtype=np.int32)[None, :]
    want, _ = jt.forward(jparams, jcfg, jnp.asarray(toks), jnp.asarray(pos))
    got, _ = pt.forward(
        tparams, cfg, torch.from_numpy(toks).long(),
        torch.from_numpy(pos).long(),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    jh, _ = jt.forward(
        jparams, jcfg, jnp.asarray(toks), jnp.asarray(pos),
        return_hidden=True,
    )
    th, _ = pt.forward(
        tparams, cfg, torch.from_numpy(toks).long(),
        torch.from_numpy(pos).long(), return_hidden=True,
    )
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)


def test_greedy_tokens_identical_to_jax():
    cfg, jcfg, jparams, tparams = _pair()
    prompt = [5, 17, 42, 99, 7]
    ids, want = list(prompt), []
    for _ in range(6):
        logits, _ = jt.forward(
            jparams, jcfg, jnp.asarray([ids], jnp.int32),
            jnp.arange(len(ids), dtype=jnp.int32)[None, :],
        )
        want.append(int(jnp.argmax(logits[0, -1])))
        ids.append(want[-1])
    got = greedy_reference(tparams, cfg, prompt, 6, torch.device("cpu"))
    assert got == want


@pytest.mark.parametrize("rope_scaling", [
    None,
    {"rope_type": "linear", "factor": 4.0},
    {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
     "high_freq_factor": 4.0, "original_max_position_embeddings": 8192},
    {"rope_type": "yarn", "factor": 32.0, "beta_fast": 32.0,
     "beta_slow": 1.0, "truncate": False,
     "original_max_position_embeddings": 4096},
    {"type": "yarn", "factor": 40, "beta_fast": 32, "beta_slow": 1,
     "mscale": 0.707, "mscale_all_dim": 0.707,
     "original_max_position_embeddings": 4096},
])
def test_rope_params_match_jax(rope_scaling):
    kw = dict(head_dim=128, rope_theta=500000.0, rope_scaling=rope_scaling)
    inv, att = pt.rope_params(dataclasses.replace(get_config("tiny"), **kw))
    jinv, jatt = jt.rope_params(JaxModelConfig(**kw))
    np.testing.assert_allclose(inv.numpy(), np.asarray(jinv), rtol=1e-6)
    assert att == pytest.approx(jatt)


def test_presets_match_jax_field_by_field():
    assert set(PRESETS) == set(JAX_PRESETS)
    for name, cfg in PRESETS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            JAX_PRESETS[name]
        ), name


def test_init_params_shapes_match_jax():
    cfg = get_config("tiny")
    gen = torch.Generator().manual_seed(0)
    tparams = pt.init_params(cfg, gen, device="cpu")
    jshapes = jax.tree.map(
        lambda a: tuple(a.shape),
        jt.init_params(JAX_PRESETS["tiny"], jax.random.key(0)),
    )
    tshapes = {
        k: ({kk: tuple(vv.shape) for kk, vv in v.items()}
            if isinstance(v, dict) else tuple(v.shape))
        for k, v in tparams.items()
    }
    assert tshapes == jshapes
    assert tparams["embed"].dtype == torch.bfloat16


@pytest.mark.parametrize(
    "name", ["gpt-oss-120b", "gemma2-9b", "gpt-oss-20b"]
)
def test_unported_families_raise(name):
    """The GPT-OSS and Gemma2 presets serve: ``init_params`` gives JAX's
    tree, shapes and dtypes (on the meta device: no memory). int8 stays
    refused for the MoE presets only (ROADMAP's int8 MoE item)."""
    cfg = get_config(name)
    tparams = pt.init_params(cfg, torch.Generator(), device="meta")
    jshapes = jax.eval_shape(
        lambda: jt.init_params(JAX_PRESETS[name], jax.random.key(0))
    )

    def shapes(tree, conv):
        return {
            k: shapes(v, conv) if isinstance(v, dict) else conv(v)
            for k, v in tree.items()
        }

    assert shapes(tparams, lambda t: (tuple(t.shape), str(t.dtype)[6:])) == (
        shapes(jshapes, lambda a: (tuple(a.shape), str(a.dtype)))
    )
    if cfg.is_moe:
        with pytest.raises(NotImplementedError, match="ROADMAP.*int8 MoE"):
            pq.check_quantizable(cfg)
    else:
        pq.check_quantizable(cfg)
