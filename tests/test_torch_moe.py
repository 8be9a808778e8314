"""MoE path of the PyTorch port against the JAX package.

``_moe_mlp`` per branch (scorings, shared experts, GPT-OSS's clamped GLU
and biases, ``routed_scaling_factor``), ``forward`` on MoE configs,
``init_params`` shapes, the engine's greedy ids (plain, n-gram
speculation, an embedding) and int8 serving (its tree, server and
forward; ``test_torch_int8_moe.py`` has the rest). Inputs and weights come
from numpy with a seed (trees carried across with ``params_from_numpy``).

Tolerances (``PERF.md`` §6): fp32, the selected experts identical and the
outputs within 1e-5 (summation order only: the port runs each token
through its own experts and sums their k outputs, JAX sums all E with
zeros off the picks); bf16, the selected experts identical and the output
within 2% of its largest magnitude (both round each expert's output to
bf16, but the two frameworks round silu at other places).
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
from gpustack_tpu.models import transformer as jt
from gpustack_tpu.models.config import PRESETS as JAX_PRESETS
from gpustack_tpu_torch.engine.engine import GenRequest, LLMEngine  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.weights import params_from_numpy  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.models import quant as pq  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.models import transformer as pt  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.models.config import PRESETS, get_config  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.ops import w8a16 as pt_ops  # analysis: ignore[metrics-drift]

FP32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_REL = 2e-2
D, E, FM, FS = 16, 8, 12, 20

# (name, config fields, shared: None | "gated" | "ungated", GPT-OSS biases)
CASES = [
    ("softmax_norm_topk", dict(norm_topk_prob=True), None, False),
    ("softmax_raw_topk", dict(norm_topk_prob=False), None, False),
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


def _case_arrays(shared, biases, seed=0):
    rng = np.random.default_rng(seed)

    def w(*shape, scale=None):
        scale = scale if scale is not None else 1.0 / np.sqrt(shape[-2])
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    arrays = {
        "x": w(2, 5, D, scale=1.0),
        "router": w(D, E),
        "we_gate": w(E, D, FM), "we_up": w(E, D, FM), "we_down": w(E, FM, D),
        "router_bias": w(E, scale=0.3),
    }
    if shared:
        arrays.update(ws_gate=w(D, FS), ws_up=w(D, FS), ws_down=w(FS, D))
        if shared == "gated":
            arrays["shared_gate"] = w(D, 1)
    if biases:
        arrays.update(bg=w(E, FM, scale=0.1), bu=w(E, FM, scale=0.1),
                      bd=w(E, D, scale=0.1))
    return arrays


def _jax_moe(a, cfg, dtype, spy):
    def j(name, dt=dtype):
        return jnp.asarray(a[name]).astype(dt)

    shared = biases = None
    if "ws_gate" in a:
        shared = (j("ws_gate"), j("ws_up"), j("ws_down"),
                  j("shared_gate") if "shared_gate" in a else None)
    if "bg" in a:
        biases = (j("bg"), j("bu"), j("bd"))
    return jt._moe_mlp(
        j("x"), j("router"), j("we_gate"), j("we_up"), j("we_down"), cfg,
        router_bias=j("router_bias", jnp.float32), shared=shared,
        biases=biases,
    )


def _port_moe(a, cfg, dtype, chunk_tokens=None):
    def t(name, dt=dtype):
        return torch.from_numpy(a[name]).to(dt)

    shared = biases = None
    if "ws_gate" in a:
        shared = (t("ws_gate"), t("ws_up"), t("ws_down"),
                  t("shared_gate") if "shared_gate" in a else None)
    if "bg" in a:
        biases = (t("bg"), t("bu"), t("bd"))
    out = pt._moe_mlp(
        t("x"), t("router"), t("we_gate"), t("we_up"), t("we_down"), cfg,
        router_bias=t("router_bias", torch.float32), shared=shared,
        biases=biases, chunk_tokens=chunk_tokens,
    )
    idx, _ = pt.moe_route(
        t("x").reshape(-1, D), t("router"), cfg,
        t("router_bias", torch.float32),
    )
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
def test_moe_mlp_matches_jax(monkeypatch, case, fields, shared, biases,
                             dtype):
    cfg, jcfg = _cfgs(fields, dtype)
    a = _case_arrays(shared, biases)
    if fields.get("moe_scoring") == "sigmoid":
        # the selection must see the bias: it forces in token 0's lowest
        # expert
        a["router_bias"][np.argmin(a["x"][0, 0] @ a["router"])] += 5.0
        unbiased, _ = pt.moe_route(
            torch.from_numpy(a["x"]).reshape(-1, D),
            torch.from_numpy(a["router"]), cfg,
        )
    spy = _TopKSpy()
    monkeypatch.setattr(jt, "lax", spy)
    want = _jax_moe(a, jcfg, getattr(jnp, dtype), spy)
    got, idx = _port_moe(a, cfg, getattr(torch, dtype))
    (picks,) = spy.picks
    np.testing.assert_array_equal(idx.numpy(), picks.reshape(-1, 3))
    if fields.get("moe_scoring") == "sigmoid":
        assert not torch.equal(idx, unbiased)
    want = np.asarray(want, dtype=np.float32)
    got = got.float().numpy()
    assert got.shape == want.shape == (2, 5, D)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **FP32_TOL)
    else:
        err = np.abs(got - want).max()
        assert err <= BF16_REL * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("chunk", [1, 3, 7])
def test_token_chunks_change_no_value(chunk):
    """Up to fp32 summation order: a product of other row counts may take
    another CPU kernel (a 1-row chunk differs in the last bit)."""
    cfg, _ = _cfgs(dict(shared_expert_intermediate_size=FS,
                        shared_expert_gated=True))
    a = _case_arrays("gated", False, seed=1)
    whole, _ = _port_moe(a, cfg, torch.float32)
    chunked, _ = _port_moe(a, cfg, torch.float32, chunk_tokens=chunk)
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(),
                               rtol=1e-6, atol=1e-6)


def test_expert_products_read_x_in_place(monkeypatch):
    """The gate and up products read one gathered x, the n·k (token,
    expert) pairs sorted by expert (``[n·k, D]``: x's rows, each once per
    pick), and the down product the ``[n·k, Fm]`` h; no tensor of the
    dense dispatch's ``[E, tokens, D]`` size ever reaches a product."""
    cfg, _ = _cfgs({})
    k = cfg.num_experts_per_tok
    a = _case_arrays(None, False)
    x = torch.from_numpy(a["x"])
    seen, grouped = [], pt_ops.bf16_grouped

    def spy(xs, w, offsets, rows):
        seen.append((xs, tuple(w.shape), offsets, rows))
        return grouped(xs, w, offsets, rows)

    monkeypatch.setattr(pt_ops, "bf16_grouped", spy)
    pt._moe_mlp(x, torch.from_numpy(a["router"]),
                *(torch.from_numpy(a[k]) for k in ("we_gate", "we_up",
                                                   "we_down")), cfg)
    n = x.shape[0] * x.shape[1]
    assert [(tuple(c[0].shape), c[1], c[3]) for c in seen] == [
        ((n * k, D), (E, D, FM), n), ((n * k, D), (E, D, FM), n),
        ((n * k, FM), (E, FM, D), n),
    ]
    assert seen[0][0] is seen[1][0]
    assert seen[0][2] is seen[1][2] is seen[2][2]
    idx, _ = pt.moe_route(x.reshape(n, D), torch.from_numpy(a["router"]),
                          cfg)
    perm, _, _ = pt.moe_dispatch(idx, E)
    assert torch.equal(seen[0][0], x.reshape(n, D)[perm // k])
    assert all(c[0].numel() < E * n * D for c in seen)


def test_sigmoid_selection_adds_bias_but_weights_use_raw_scores():
    cfg, _ = _cfgs(dict(moe_scoring="sigmoid", norm_topk_prob=False))
    x = torch.zeros(1, D)
    x[0, 0] = 1.0
    router = torch.zeros(D, E)
    router[0] = torch.linspace(-1.0, 1.0, E)
    bias = torch.zeros(E)
    bias[0] = 10.0                  # forces expert 0, the lowest score
    idx, combine = pt.moe_route(x, router, cfg, bias)
    assert 0 in idx[0].tolist()
    assert combine[0, 0].item() == pytest.approx(
        torch.sigmoid(torch.tensor(-1.0)).item()
    )


def _pair(name, **fields):
    cfg = dataclasses.replace(get_config(name), dtype="float32", **fields)
    jcfg = dataclasses.replace(JAX_PRESETS[name], dtype="float32", **fields)
    jparams = jt.init_params(jcfg, jax.random.key(0), dtype=jnp.float32)
    return cfg, jcfg, jparams, params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu"
    )


def _tokens(seed, B, T, vocab):
    return np.random.default_rng(seed).integers(1, vocab, (B, T)).astype(
        np.int32
    )


FORWARD_CONFIGS = {
    "tiny-moe": {},
    "tiny-moe-qk-norm": {"qk_norm": True},
    "tiny-moe-shared": {"shared_expert_intermediate_size": 48,
                        "shared_expert_gated": True, "qkv_bias": True},
}


@pytest.mark.parametrize("name", sorted(FORWARD_CONFIGS))
def test_forward_without_cache_matches_jax(name):
    cfg, jcfg, jparams, tparams = _pair("tiny-moe", **FORWARD_CONFIGS[name])
    toks = _tokens(0, 2, 12, cfg.vocab_size)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12))
    want, _ = jt.forward(jparams, jcfg, jnp.asarray(toks), jnp.asarray(pos))
    got, _ = pt.forward(
        tparams, cfg, torch.from_numpy(toks).long(),
        torch.from_numpy(pos.copy()).long(),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32_TOL)


@pytest.mark.parametrize("attn_impl", ["plain", "flash"])
@pytest.mark.parametrize("name", sorted(FORWARD_CONFIGS))
def test_prefill_then_decode_with_cache_matches_jax(name, attn_impl):
    cfg, jcfg, jparams, tparams = _pair("tiny-moe", **FORWARD_CONFIGS[name])
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
    np.testing.assert_allclose(got1.numpy(), np.asarray(want1), **FP32_TOL)
    dpos = np.full((B, 1), T, np.int32)
    want2, jcache = jt.forward(
        jparams, jcfg, jnp.asarray(toks[:, T:]), jnp.asarray(dpos), jcache
    )
    got2, tcache = pt.forward(
        tparams, cfg, torch.from_numpy(toks[:, T:]).long(),
        torch.from_numpy(dpos).long(), tcache,
    )
    np.testing.assert_allclose(got2.numpy(), np.asarray(want2), **FP32_TOL)
    np.testing.assert_allclose(tcache.v.numpy(), np.asarray(jcache.v),
                               **FP32_TOL)


@pytest.mark.parametrize("name", ["tiny-moe", "qwen3-30b-a3b", "mixtral-8x7b"])
def test_init_params_shapes_match_jax(name):
    """Shapes and dtypes of the whole tree (on the meta device: no
    memory), against ``jax.eval_shape`` of the JAX init."""
    tparams = pt.init_params(
        PRESETS[name], torch.Generator(), device="meta"
    )
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


def test_init_params_moe_extras_match_jax():
    """Router bias (fp32), shared experts and expert biases."""
    fields = dict(moe_scoring="softmax_topk", moe_bias=True,
                  shared_expert_intermediate_size=48, shared_expert_gated=True)
    cfg = dataclasses.replace(get_config("tiny-moe"), **fields)
    jcfg = dataclasses.replace(JAX_PRESETS["tiny-moe"], **fields)
    tparams = pt.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    jparams = jt.init_params(jcfg, jax.random.key(0))
    got = {k: (tuple(v.shape), str(v.dtype)[6:])
           for k, v in tparams["layers"].items()}
    want = {k: (tuple(v.shape), str(v.dtype))
            for k, v in jparams["layers"].items()}
    assert got == want
    assert tparams["layers"]["router_bias"].dtype == torch.float32


# ---------------------------------------------------------------------------
# the engine on tiny-moe
# ---------------------------------------------------------------------------

PROMPTS = [[3, 1, 4], [15, 9, 2, 6], [5, 3], [5, 8, 9, 7, 9], [7, 7, 7, 7]]
MAX_TOKENS = 8


@pytest.fixture(scope="module")
def models():
    return _pair("tiny-moe")


@pytest.fixture(scope="module")
def jax_engine_runs(models):
    _, jcfg, jparams, _ = models
    eng = JaxLLMEngine(
        jcfg, jparams, max_slots=4, max_seq_len=64, pipeline_depth=0
    )
    eng.start()
    try:
        reqs = [
            eng.submit(JaxGenRequest(
                prompt_ids=p, max_tokens=MAX_TOKENS, temperature=0.0
            ))
            for p in PROMPTS
        ]
        for r in reqs:
            assert r.done.wait(300), r.request_id
        vec = eng.embed([[5, 8, 9, 7, 9, 3]])
        return [r.output_ids for r in reqs], np.asarray(vec)
    finally:
        eng.stop()


def _port_engine(cfg, params, **kw):
    eng = LLMEngine(cfg, params, max_slots=4, max_seq_len=64, device="cpu",
                    **kw)
    eng.start()
    return eng


def _port_ids(eng):
    reqs = [
        eng.submit(GenRequest(prompt_ids=p, max_tokens=MAX_TOKENS,
                              temperature=0.0))
        for p in PROMPTS
    ]
    for r in reqs:
        assert r.done.wait(300), r.request_id
    return [r.output_ids for r in reqs]


@pytest.mark.parametrize("speculative", ["", "ngram", "draft"])
def test_engine_greedy_ids_identical_to_jax_engine(
    models, jax_engine_runs, speculative
):
    """Plain, n-gram and a perfect draft (the MoE model drafting for
    itself): the JAX engine's plain greedy ids."""
    cfg, _, _, tparams = models
    draft = (
        dict(draft_cfg=cfg, draft_params=tparams)
        if speculative == "draft" else {}
    )
    eng = _port_engine(cfg, tparams, pipeline_depth=2,
                       speculative=speculative, **draft)
    try:
        assert _port_ids(eng) == jax_engine_runs[0]
        if speculative:
            assert eng.health()["spec_steps"] > 0
    finally:
        eng.stop()


def test_engine_embedding_matches_jax_engine(models, jax_engine_runs):
    cfg, _, _, tparams = models
    eng = _port_engine(cfg, tparams)
    try:
        vec = eng.embed([[5, 8, 9, 7, 9, 3]])
    finally:
        eng.stop()
    np.testing.assert_allclose(np.asarray(vec), jax_engine_runs[1],
                               **FP32_TOL)


def test_profile_capture_on_an_moe_engine(models, tmp_path):
    """``capture_profile`` on tiny-moe: the trace holds the expert
    products (``bmm``) of the steps it captured."""
    import json
    import os
    import threading

    cfg, _, _, tparams = models
    eng = _port_engine(cfg, tparams)
    t = threading.Thread(target=_port_ids, args=(eng,))
    try:
        t.start()
        result = eng.capture_profile(4, out_dir=str(tmp_path), timeout_s=60)
        t.join(120)
    finally:
        eng.stop()
    assert result["profiler"] == "torch", result["error"]
    assert result["steps_captured"] >= 1
    with open(os.path.join(str(tmp_path), "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("bmm" in e.get("name", "") for e in events)


# ---------------------------------------------------------------------------
# int8 experts, and the fields that serve since GPT-OSS and Gemma
# ---------------------------------------------------------------------------


def _int8_desc(tree, quant_cls, conv):
    return {
        k: _int8_desc(v, quant_cls, conv) if isinstance(v, dict)
        else (conv(v.q), conv(v.s)) if isinstance(v, quant_cls)
        else conv(v)
        for k, v in tree.items()
    }


def _assert_int8_tree_like_jax(tree, jcfg):
    """The leaves, shapes and dtypes of ``jax.eval_shape`` of the JAX
    ``quantize_params(init_params(jcfg))``, int8 values and scales."""
    from gpustack_tpu.models import quant as jq

    want = jax.eval_shape(
        lambda: jq.quantize_params(jt.init_params(jcfg, jax.random.key(0)))
    )
    assert _int8_desc(
        tree, pq.QuantW, lambda t: (tuple(t.shape), str(t.dtype)[6:])
    ) == _int8_desc(
        want, jq.QuantW, lambda a: (tuple(a.shape), str(a.dtype))
    )


def test_int8_moe_is_refused_before_any_weight_is_drawn(monkeypatch):
    """int8 MoE serves: ``init_quantized_params`` draws the int8 tree of
    ``tiny-moe`` on the CPU, the int8 leaves from fp32 normal draws (no
    bf16 detour), the router in bf16, with the JAX tree's leaves, shapes
    and dtypes."""
    drawn, randn = [], torch.randn

    def spy(*a, **k):
        drawn.append(k.get("dtype"))
        return randn(*a, **k)

    monkeypatch.setattr(torch, "randn", spy)
    tree = pq.init_quantized_params(get_config("tiny-moe"), device="cpu")
    _assert_int8_tree_like_jax(tree, JAX_PRESETS["tiny-moe"])
    for key in ("we_gate", "we_up", "we_down"):
        assert tree["layers"][key].q.dtype == torch.int8
    assert set(drawn) == {torch.float32, torch.bfloat16}


def test_server_refuses_int8_moe_before_loading(monkeypatch):
    """``--preset tiny-moe --device cpu --quantization int8`` builds an
    engine over the int8 tree drawn directly (no bf16 tree is read or
    drawn) and answers a greedy request, the same ids twice; its first id
    is the argmax of ``forward`` on that tree (later ids may part from a
    cacheless bf16 forward at this model's exact bf16 ties)."""
    from gpustack_tpu_torch.engine import api_server, weights  # analysis: ignore[metrics-drift]

    def no_load(*a, **k):
        raise AssertionError("weights were read")

    monkeypatch.setattr(weights, "load_or_init_params", no_load)
    args = api_server.build_parser().parse_args(
        ["--preset", "tiny-moe", "--device", "cpu", "--quantization", "int8",
         "--max-seq-len", "64"]
    )
    eng = api_server.build_engine_from_args(args)
    params = eng.runner.params
    assert isinstance(params["layers"]["we_down"], pq.QuantW)
    prompt = [3, 1, 4, 1, 5]
    eng.start()
    try:
        got = [
            eng.generate(GenRequest(prompt_ids=prompt, max_tokens=4,
                                    temperature=0.0), timeout=120).output_ids
            for _ in range(2)
        ]
    finally:
        eng.stop()
    assert got[0] == got[1] and len(got[0]) == 4
    with torch.no_grad():
        logits, _ = pt.forward(params, eng.cfg, torch.tensor([prompt]),
                               torch.arange(len(prompt))[None, :])
    assert got[0][0] == int(logits[0, -1].argmax())


def test_int8_expert_weights_are_refused_in_the_forward():
    """int8 expert weights run in ``_moe_mlp``: the experts quantized by
    the JAX package, against the JAX ``_moe_mlp`` on the same QuantW
    leaves, fp32 within 1e-5."""
    from gpustack_tpu.models import quant as jq

    cfg, jcfg = _cfgs({})
    a = _case_arrays(None, False)
    names = ("we_gate", "we_up", "we_down")
    jw = {k: jq._quantize_leaf(k, jnp.asarray(a[k][None])) for k in names}
    want = jt._moe_mlp(
        jnp.asarray(a["x"]), jnp.asarray(a["router"]),
        *(jq.QuantW(q=jw[k].q[0], s=jw[k].s[0]) for k in names), jcfg,
    )
    tw = [pq.QuantW(q=torch.from_numpy(np.array(jw[k].q[0])),
                    s=torch.from_numpy(np.array(jw[k].s[0]).view(np.int16))
                    .view(torch.bfloat16))
          for k in names]
    got = pt._moe_mlp(torch.from_numpy(a["x"]),
                      torch.from_numpy(a["router"]), *tw, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32_TOL)


@pytest.mark.parametrize(
    "name,fields",
    [("gpt-oss-120b", {}), ("gpt-oss-20b", {}),
     ("tiny-moe", {"post_norms": True}),
     ("tiny-moe", {"sliding_window": 16}),
     ("tiny-moe", {"attn_logit_softcap": 30.0}),
     ("tiny-moe", {"attn_sinks": True})],
)
def test_moe_families_still_refused(name, fields):
    """Each field serves since the GPT-OSS and Gemma families were
    ported: a tiny MoE forward with it, 24 positions (past a window of
    16), matches JAX's, its sinks and post-norm gains drawn nonzero. The
    GPT-OSS presets serve as int8 too: their int8 trees (meta device)
    have JAX's leaves, shapes and dtypes."""
    cfg = dataclasses.replace(get_config(name), **fields)
    if not fields:
        _assert_int8_tree_like_jax(
            pt.init_params(cfg, torch.Generator(), device="meta", int8=True),
            JAX_PRESETS[name],
        )
        return
    cfg, jcfg, jparams, _ = _pair(name, **fields)
    rng = np.random.default_rng(5)
    tree = jax.tree.map(np.asarray, jparams)
    for key in ("sinks", "post_attn_norm", "post_mlp_norm"):
        if key in tree["layers"]:
            leaf = tree["layers"][key]
            tree["layers"][key] = (
                leaf + rng.uniform(-0.5, 0.5, leaf.shape)
            ).astype(leaf.dtype)
    toks = _tokens(2, 2, 24, cfg.vocab_size)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32), (2, 24))
    want, _ = jt.forward(jax.tree.map(jnp.asarray, tree), jcfg,
                         jnp.asarray(toks), jnp.asarray(pos))
    got, _ = pt.forward(
        params_from_numpy(tree, "cpu"), cfg,
        torch.from_numpy(toks).long(), torch.from_numpy(pos.copy()).long(),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32_TOL)
