"""The Gemma family (1, 2 and 3) in the PyTorch port against the JAX
package: the delta-gain RMSNorm, and the whole forward of tiny Gemma1,
Gemma2 and Gemma3 configs (``(1 + w)`` norms, the scaled embedding, the
tanh GELU, tied embeddings; Gemma2/3's sandwich post-norms,
``query_pre_attn_scalar`` and alternating sliding/full layers; Gemma2's
attention and final softcaps; Gemma3's qk-norm and local rope table) in
every mode the runner uses, ``init_params``, int8 (the quantizer, the
direct int8 init, the int8 forward), the engine's greedy ids and the
loader on ``transformers`` checkpoints. Mirrors ``tests/models/test_gemma.py``.

Every gain the JAX init draws as zero (a unit gain under the delta
convention) is drawn at random first, so a sign or placement error shows.
The softcaps are small enough here (5 and 2) to bend the scores and
logits they cap.

Tolerances (``PERF.md`` §6): fp32 within 1e-5 (norms, forwards); int8
forwards 1e-4; bf16 within 2% of the output's scale; trees, quantized
bits and greedy ids identical; loaded checkpoints' logits within 5e-3 +
2e-2·|ref| of ``transformers``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpustack_tpu.engine import weights as jw
from gpustack_tpu.engine.engine import GenRequest as JaxGenRequest
from gpustack_tpu.engine.engine import LLMEngine as JaxLLMEngine
from gpustack_tpu.models import quant as jq
from gpustack_tpu.models import transformer as jt
from gpustack_tpu.models.config import PRESETS as JAX_PRESETS
from gpustack_tpu.models.config import load_hf_config as jax_load_hf_config
from gpustack_tpu_torch.engine import weights as pw  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.api_server import (  # analysis: ignore[metrics-drift]
    build_engine_from_args,
    build_parser,
)
from gpustack_tpu_torch.engine.engine import GenRequest, LLMEngine  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.models import quant as pq  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.models import transformer as pt  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.models.config import PRESETS, get_config, load_hf_config  # analysis: ignore[metrics-drift]

FP32_TOL = dict(rtol=1e-5, atol=1e-5)
INT8_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_REL = 2e-2
HF_TOL = dict(atol=5e-3, rtol=2e-2)
WINDOW = 16

GEMMA = dict(hidden_act="gelu_tanh", norm_delta_gain=True, embed_scale=True,
             tie_word_embeddings=True, rms_norm_eps=1e-6)
FAMILIES = {
    "gemma1": dict(GEMMA),
    "gemma2": dict(
        GEMMA, num_layers=4, post_norms=True, query_pre_attn_scalar=32.0,
        attn_logit_softcap=5.0, final_logit_softcap=2.0,
        sliding_window=WINDOW, layer_sliding=(True, False, True, False),
    ),
    "gemma3": dict(
        GEMMA, num_layers=6, post_norms=True, qk_norm=True,
        query_pre_attn_scalar=32.0, sliding_window=WINDOW,
        layer_sliding=(True,) * 5 + (False,), rope_theta=1000000.0,
        rope_local_theta=10000.0,
    ),
}
GAINS = ("attn_norm", "mlp_norm", "post_attn_norm", "post_mlp_norm",
         "q_norm", "k_norm")


def _cfgs(family, dtype="float32"):
    fields = dict(FAMILIES[family], dtype=dtype)
    return (dataclasses.replace(get_config("tiny"), **fields),
            dataclasses.replace(JAX_PRESETS["tiny"], **fields))


def _tree(jcfg, seed=0):
    """The JAX init as numpy, its zero (unit-delta) gains drawn at
    random."""
    tree = jax.tree.map(
        np.asarray, jt.init_params(jcfg, jax.random.key(seed),
                                   dtype=jnp.float32)
    )
    rng = np.random.default_rng(seed + 100)

    def draw(a):
        return rng.uniform(-0.5, 0.5, a.shape).astype(np.float32)

    for key in GAINS:
        if key in tree["layers"]:
            tree["layers"][key] = draw(tree["layers"][key])
    tree["final_norm"] = draw(tree["final_norm"])
    return tree


def _both(tree, cfg, dtype="float32"):
    """(JAX tree, port tree) from one numpy tree, in ``dtype``."""
    jtree = jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), tree)
    return jtree, pw.params_from_numpy(
        jax.tree.map(np.asarray, jtree), "cpu"
    )


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a)).long()


def _tokens(seed, B, T, vocab=264):
    return np.random.default_rng(seed).integers(1, vocab, (B, T)).astype(
        np.int32
    )


def _close(got, want, dtype):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **FP32_TOL)
    else:
        assert np.abs(got - want).max() <= BF16_REL * np.abs(want).max()


def _bits(t):
    t = t.detach().cpu()
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else (
        t.numpy()
    )


def _jbits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


# ---------------------------------------------------------------------------
# the norm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("delta", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(dtype, delta):
    """The delta gain multiplies ``1 + w`` in fp32 before the downcast,
    the plain gain after it: both give JAX's bits in bf16."""
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((3, 5, 64)) * 3).astype(dtype)
    w = jnp.asarray(rng.uniform(-0.5, 0.5, 64)).astype(dtype)
    want = jt.rms_norm(x, w, 1e-6, delta)
    got = pt.rms_norm(pw._to_tensor(np.asarray(x), "cpu"),
                      pw._to_tensor(np.asarray(w), "cpu"), 1e-6, delta)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32_TOL)
    else:
        np.testing.assert_array_equal(_bits(got), _jbits(want))


# ---------------------------------------------------------------------------
# the whole forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_forward_without_cache_matches_jax(family, dtype):
    cfg, jcfg = _cfgs(family, dtype)
    jtree, ttree = _both(_tree(jcfg), cfg, dtype)
    toks = _tokens(0, 2, 56)
    pos = np.broadcast_to(np.arange(56, dtype=np.int32), (2, 56))
    want, _ = jt.forward(jtree, jcfg, jnp.asarray(toks), jnp.asarray(pos))
    got, _ = pt.forward(ttree, cfg, _t(toks), _t(pos), attn_impl="flash")
    _close(got.numpy(), want, dtype)
    if cfg.final_logit_softcap:
        assert np.abs(np.asarray(want)).max() < cfg.final_logit_softcap


def _prefill(cfg, jcfg, jtree, ttree, toks, pos, S, attn_impl):
    jcache = jt.KVCache.create(jcfg, toks.shape[0], S)
    want, jcache = jt.forward(jtree, jcfg, jnp.asarray(toks),
                              jnp.asarray(pos), jcache)
    tcache = pt.KVCache.create(cfg, toks.shape[0], S, torch.device("cpu"))
    got, tcache = pt.forward(ttree, cfg, _t(toks), _t(pos), tcache,
                             attn_impl=attn_impl)
    return want, jcache, got, tcache


@pytest.mark.parametrize("attn_impl", ["plain", "flash"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_prefill_then_decode_matches_jax(family, dtype, attn_impl):
    """A 48-token prefill into a 64-row cache, then four decode steps:
    logits and the cache. ``"flash"`` is what the runner asks for on the
    card: Gemma1 takes the kernel (its plain version here), Gemma2 and 3
    the plain attention, as in JAX."""
    cfg, jcfg = _cfgs(family, dtype)
    jtree, ttree = _both(_tree(jcfg), cfg, dtype)
    toks = _tokens(1, 2, 52)
    pos = np.broadcast_to(np.arange(48, dtype=np.int32), (2, 48))
    want, jcache, got, tcache = _prefill(
        cfg, jcfg, jtree, ttree, toks[:, :48], pos, 64, attn_impl
    )
    _close(got.numpy(), want, dtype)
    for t in range(48, 52):
        dpos = np.full((2, 1), t, np.int32)
        want, jcache = jt.forward(jtree, jcfg, jnp.asarray(toks[:, t:t + 1]),
                                  jnp.asarray(dpos), jcache)
        got, tcache = pt.forward(ttree, cfg, _t(toks[:, t:t + 1]), _t(dpos),
                                 tcache)
        _close(got.numpy(), want, dtype)
    if dtype == "float32":
        # (in bf16 the cache of each deeper layer parts by about one more
        # rounding step of the residual stream: 3 steps at Gemma3's 6th)
        _close(tcache.k.numpy(), np.asarray(jcache.k), dtype)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_chunked_continuation_matches_jax(family):
    """A 32-token prefill, then a 24-token chunk at offset 32 over the
    same cache (the runner's continuation, ``q_offset`` 32)."""
    cfg, jcfg = _cfgs(family)
    jtree, ttree = _both(_tree(jcfg), cfg)
    toks = _tokens(2, 1, 56)
    pos = np.arange(56, dtype=np.int32)[None, :]
    _, jcache, _, tcache = _prefill(cfg, jcfg, jtree, ttree, toks[:, :32],
                                    pos[:, :32], 64, "flash")
    want, jcache = jt.forward(jtree, jcfg, jnp.asarray(toks[:, 32:]),
                              jnp.asarray(pos[:, 32:]), jcache)
    got, tcache = pt.forward(ttree, cfg, _t(toks[:, 32:]), _t(pos[:, 32:]),
                             tcache, attn_impl="flash", q_offset=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32_TOL)
    np.testing.assert_allclose(tcache.v.numpy(), np.asarray(jcache.v),
                               **FP32_TOL)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_verify_block_matches_jax(family):
    """A speculative verify block: two rows of 4 positions each at their
    own offsets (40 and 37) over a 48-token prefill's cache."""
    cfg, jcfg = _cfgs(family)
    jtree, ttree = _both(_tree(jcfg), cfg)
    toks = _tokens(3, 2, 52)
    pos = np.broadcast_to(np.arange(48, dtype=np.int32), (2, 48))
    _, jcache, _, tcache = _prefill(cfg, jcfg, jtree, ttree, toks[:, :48],
                                    pos, 64, "plain")
    bpos = np.stack([np.arange(40, 44), np.arange(37, 41)]).astype(np.int32)
    block = toks[:, 48:52]
    want, jcache = jt.forward(jtree, jcfg, jnp.asarray(block),
                              jnp.asarray(bpos), jcache)
    got, tcache = pt.forward(ttree, cfg, _t(block), _t(bpos), tcache,
                             clamp_writes=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32_TOL)
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k),
                               **FP32_TOL)


@pytest.mark.parametrize("name", ["gemma1", "gemma2", "gemma3", "gemma2-9b"])
def test_init_params_shapes_match_jax(name):
    """The post-norms and the zero (delta) gains with their shapes and
    dtypes, on the meta device; the gains are zeros as in JAX."""
    if name in FAMILIES:
        cfg, jcfg = _cfgs(name, "bfloat16")
    else:
        cfg, jcfg = PRESETS[name], JAX_PRESETS[name]
    tparams = pt.init_params(cfg, torch.Generator(), device="meta")
    jshapes = jax.eval_shape(lambda: jt.init_params(jcfg, jax.random.key(0)))

    def shapes(tree, conv):
        return {
            k: shapes(v, conv) if isinstance(v, dict) else conv(v)
            for k, v in tree.items()
        }

    assert shapes(tparams, lambda t: (tuple(t.shape), str(t.dtype)[6:])) == (
        shapes(jshapes, lambda a: (tuple(a.shape), str(a.dtype)))
    )
    if name in FAMILIES:
        small = pt.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
        gains = [small["final_norm"]] + [
            small["layers"][k] for k in GAINS if k in small["layers"]
        ]
        assert all(not g.any() for g in gains)


# ---------------------------------------------------------------------------
# int8
# ---------------------------------------------------------------------------


def _int8_trees(family="gemma2"):
    cfg, jcfg = _cfgs(family)
    tree = _tree(jcfg)
    jq_params = jq.quantize_params(jax.tree.map(jnp.asarray, tree))
    return cfg, jcfg, tree, jq_params


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_quantize_params_bits_match_jax(family):
    """The seven layer weights quantize to JAX's bits; the tied embedding,
    the gains and the post-norms stay as they are."""
    _, _, tree, jq_params = _int8_trees(family)
    got = pq.quantize_params(pw.params_from_numpy(tree, "cpu"))
    assert not isinstance(got["embed"], pq.QuantW)
    assert "lm_head" not in got
    n_quant = 0
    for key, w in jq_params["layers"].items():
        g = got["layers"][key]
        if isinstance(w, jq.QuantW):
            np.testing.assert_array_equal(g.q.numpy(), np.asarray(w.q))
            np.testing.assert_array_equal(_bits(g.s), _jbits(w.s))
            n_quant += 1
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert n_quant == 7
    np.testing.assert_array_equal(got["embed"].numpy(),
                                  np.asarray(jq_params["embed"]))


@pytest.mark.parametrize("family", ["gemma2", "gemma3"])
def test_init_quantized_params_matches_jax_structure(family):
    """Structure, shapes and dtypes of the direct int8 init, its zero
    gains and post-norms, and the bf16 tied embedding."""
    cfg, jcfg = _cfgs(family, "bfloat16")
    want = jq.init_quantized_params(jcfg, seed=0)
    got = pq.init_quantized_params(cfg, seed=0, device="cpu")

    def desc(tree, quant_cls):
        out = {}
        for key, v in tree.items():
            if isinstance(v, dict):
                out[key] = desc(v, quant_cls)
            elif isinstance(v, quant_cls):
                out[key] = (tuple(v.q.shape), str(v.q.dtype)[-4:],
                            tuple(v.s.shape), str(v.s.dtype)[-8:])
            else:
                out[key] = (tuple(v.shape), str(v.dtype).split(".")[-1])
        return out

    assert desc(got, pq.QuantW) == desc(want, jq.QuantW)
    for key in ("attn_norm", "mlp_norm", "post_attn_norm", "post_mlp_norm"):
        assert not got["layers"][key].any()
        assert not np.asarray(want["layers"][key]).any()
    logits, _ = pt.forward(got, cfg, torch.tensor([[1, 2, 3]]),
                           torch.arange(3)[None, :])
    assert torch.isfinite(logits).all()


def test_int8_forward_matches_jax():
    """The int8 Gemma2 tree through a cacheless forward and a prefill plus
    decode (the W8A16 plain version on the CPU against the JAX ``_mm``)."""
    cfg, jcfg, _, jq_params = _int8_trees()
    tq = pw.params_from_numpy(jax.tree.map(np.asarray, jq_params), "cpu")
    toks = _tokens(4, 2, 50)
    pos = np.broadcast_to(np.arange(48, dtype=np.int32), (2, 48))
    want, _ = jt.forward(jq_params, jcfg, jnp.asarray(toks[:, :48]),
                         jnp.asarray(pos))
    got, _ = pt.forward(tq, cfg, _t(toks[:, :48]), _t(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **INT8_TOL)
    want, jcache, got, tcache = _prefill(cfg, jcfg, jq_params, tq,
                                         toks[:, :48], pos, 64, "flash")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **INT8_TOL)
    for t in (48, 49):
        dpos = np.full((2, 1), t, np.int32)
        want, jcache = jt.forward(jq_params, jcfg,
                                  jnp.asarray(toks[:, t:t + 1]),
                                  jnp.asarray(dpos), jcache)
        got, tcache = pt.forward(tq, cfg, _t(toks[:, t:t + 1]), _t(dpos),
                                 tcache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **INT8_TOL)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

PROMPTS = [list(range(3, 33)), [15, 9, 2, 6] * 6, [5, 3] * 10,
           [7, 7, 7, 7, 9]]
MAX_TOKENS = 12


@pytest.mark.parametrize("family", ["gemma2", "gemma3"])
def test_engine_greedy_ids_identical_to_jax_engine(family):
    """Prefill, insert and decode past the sliding window (prompts of up
    to 30 tokens, 12 new ones, a window of 16), with an embedding: the
    JAX engine's greedy ids and vector."""
    cfg, jcfg = _cfgs(family)
    jtree, ttree = _both(_tree(jcfg), cfg)
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
        want_vec = np.asarray(jeng.embed([PROMPTS[0]]))
    finally:
        jeng.stop()
    eng = LLMEngine(cfg, ttree, max_slots=4, max_seq_len=64, device="cpu")
    eng.start()
    try:
        reqs = [eng.submit(GenRequest(
            prompt_ids=p, max_tokens=MAX_TOKENS, temperature=0.0))
            for p in PROMPTS]
        for r in reqs:
            assert r.done.wait(300), r.request_id
        got = [r.output_ids for r in reqs]
        vec = eng.embed([PROMPTS[0]])
    finally:
        eng.stop()
    assert got == want
    assert all(len(ids) == MAX_TOKENS for ids in got)
    np.testing.assert_allclose(np.asarray(vec), want_vec, **FP32_TOL)


# ---------------------------------------------------------------------------
# weights: transformers checkpoints
# ---------------------------------------------------------------------------

TOKENS = np.array([[3, 17, 92, 5, 44, 8, 120, 63]], dtype=np.int32)
HF = {
    "gemma1": ("GemmaConfig", "GemmaForCausalLM", dict(
        num_hidden_layers=3, hidden_act="gelu",
    )),
    "gemma2": ("Gemma2Config", "Gemma2ForCausalLM", dict(
        num_hidden_layers=4, query_pre_attn_scalar=8,
        attn_logit_softcapping=50.0, final_logit_softcapping=30.0,
        sliding_window=4,
    )),
    "gemma3": ("Gemma3TextConfig", "Gemma3ForCausalLM", dict(
        num_hidden_layers=6, query_pre_attn_scalar=8, sliding_window=4,
        rope_theta=1000000.0, rope_local_base_freq=10000.0,
    )),
}
_WRITTEN = {}


def _hf_dir(family, tmp_path_factory):
    """(model, dir): one family's tiny checkpoint, written once, its norm
    gains drawn nonzero."""
    if family not in _WRITTEN:
        tfm = pytest.importorskip("transformers")
        cfg_cls, model_cls, fields = HF[family]
        torch.manual_seed(0)
        model = getattr(tfm, model_cls)(getattr(tfm, cfg_cls)(**{
            **dict(vocab_size=128, hidden_size=32, intermediate_size=64,
                   num_attention_heads=4, num_key_value_heads=2, head_dim=8,
                   max_position_embeddings=128, rope_theta=10000.0,
                   attention_dropout=0.0),
            **fields,
        })).eval()
        with torch.no_grad():
            for name, p in model.named_parameters():
                if "norm" in name:
                    p.uniform_(-0.5, 0.5)
        d = tmp_path_factory.mktemp(family)
        model.save_pretrained(d, safe_serialization=True)
        _WRITTEN[family] = (model, str(d))
    return _WRITTEN[family]


@pytest.fixture(scope="module", params=sorted(HF))
def hf_checkpoint(request, tmp_path_factory):
    return (request.param, *_hf_dir(request.param, tmp_path_factory))


def _same_tree(got, want, prefix=""):
    assert sorted(got) == sorted(want), prefix
    for k, w in want.items():
        if isinstance(w, dict):
            _same_tree(got[k], w, f"{prefix}{k}/")
        else:
            np.testing.assert_array_equal(_bits(got[k]), _jbits(w),
                                          f"{prefix}{k}")


def _fp32(tree):
    return {k: _fp32(v) if isinstance(v, dict) else v.float()
            for k, v in tree.items()}


def test_hf_checkpoint_loads_like_jax_and_transformers(hf_checkpoint):
    """The sandwich-norm names (``post_attention_layernorm`` the post-
    attention norm, ``pre_feedforward_layernorm`` the pre-MLP one): the
    tree equals the JAX loader's, and the logits equal JAX's and are
    within the JAX suite's tolerance of ``transformers``. (``transformers``
    leaves its default ``tie_word_embeddings`` out of ``config.json``;
    both packages then read the config as untied, and with no
    ``lm_head.weight`` in the file both take the embedding's transpose.)"""
    family, model, model_dir = hf_checkpoint
    cfg, jcfg = load_hf_config(model_dir), jax_load_hf_config(model_dir)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.norm_delta_gain and cfg.embed_scale
    assert cfg.post_norms == (family != "gemma1")
    got = pw.load_hf_checkpoint(cfg, model_dir)
    want = jw.load_hf_checkpoint(jcfg, model_dir)
    _same_tree(got, want)
    if cfg.post_norms:
        hf_norm = model.model.layers[1].pre_feedforward_layernorm.weight
        assert torch.equal(got["layers"]["mlp_norm"][1],
                           hf_norm.detach().to(torch.bfloat16))
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    jcfg32 = dataclasses.replace(jcfg, dtype="float32")
    pos = np.arange(TOKENS.shape[1], dtype=np.int32)[None, :]
    ours, _ = pt.forward(_fp32(got), cfg32, _t(TOKENS), _t(pos))
    theirs, _ = jt.forward(
        jax.tree.map(lambda a: a.astype(jnp.float32), want), jcfg32,
        jnp.asarray(TOKENS), jnp.asarray(pos),
    )
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **FP32_TOL)
    with torch.no_grad():
        ref = model(_t(TOKENS)).logits.numpy()
    np.testing.assert_allclose(ours.numpy(), ref, **HF_TOL)


def test_model_dir_with_a_gemma2_checkpoint_serves(tmp_path_factory):
    """``--model-dir`` on the Gemma2 checkpoint, bf16 and
    ``--quantization int8``: the server's engine decodes four greedy
    tokens past the sliding window of 4."""
    _, model_dir = _hf_dir("gemma2", tmp_path_factory)
    for extra in ([], ["--quantization", "int8"]):
        args = build_parser().parse_args([
            "--model-dir", model_dir, "--device", "cpu", "--max-slots", "2",
            "--max-seq-len", "64", *extra,
        ])
        engine = build_engine_from_args(args)
        engine.start()
        try:
            out = engine.generate(GenRequest(
                prompt_ids=[3, 17, 92, 5, 44, 8], max_tokens=4,
                temperature=0.0,
            ), timeout=120)
        finally:
            engine.stop()
        assert engine.cfg.post_norms and len(out.output_ids) == 4
        assert isinstance(engine.runner.params["layers"]["wq"], pq.QuantW) == (
            bool(extra)
        )


def test_lora_merges_into_a_gemma_tree_like_jax(tmp_path_factory, tmp_path):
    """A PEFT adapter on q_proj and down_proj of two layers: the merged
    trees are identical (the sandwich norms need no change to the
    merge)."""
    from safetensors.torch import save_file

    _, model_dir = _hf_dir("gemma2", tmp_path_factory)
    rng = np.random.default_rng(9)
    tensors = {}
    for i in (0, 3):
        for mod, (out_f, in_f) in (("self_attn.q_proj", (32, 32)),
                                   ("mlp.down_proj", (32, 64))):
            base = f"base_model.model.model.layers.{i}.{mod}"
            tensors[base + ".lora_A.weight"] = torch.from_numpy(
                rng.standard_normal((4, in_f)).astype(np.float32) * 0.1)
            tensors[base + ".lora_B.weight"] = torch.from_numpy(
                rng.standard_normal((out_f, 4)).astype(np.float32) * 0.1)
    save_file(tensors, str(tmp_path / "adapter_model.safetensors"))
    (tmp_path / "adapter_config.json").write_text('{"r": 4, "lora_alpha": 8}')
    cfg, jcfg = load_hf_config(model_dir), jax_load_hf_config(model_dir)
    got = pw.merge_lora_adapters(cfg, pw.load_hf_checkpoint(cfg, model_dir),
                                 [str(tmp_path)])
    want = jw.merge_lora_adapters(jcfg, jw.load_hf_checkpoint(jcfg, model_dir),
                                  [str(tmp_path)])
    _same_tree(got, want)
