"""The GPT-OSS family in the PyTorch port against the JAX package: the
attention's sinks and softcap under causal, sliding and per-layer masks
(and its query-row chunks), the whole forward of a tiny GPT-OSS config
(sinks, alternating sliding/full layers, q/k/v/o biases, YaRN with
``truncate: false``, the affine top-k router, clamped-GLU experts with
biases) in every mode the runner uses, ``init_params``, the engine's
greedy ids, the loader (plain and MXFP4 experts) and ``_mxfp4_dequant``.
Mirrors ``tests/models/test_gptoss.py``.

Every leaf the JAX init draws as zeros (sinks, biases, the router bias)
is filled with random values first, so a sign or placement error shows.

Tolerances (``PERF.md`` §6): fp32 within 1e-5 (``_attend``, forwards);
bf16 within 2% of the output's scale; chunked attention, trees,
``_mxfp4_dequant`` and greedy ids identical; loaded checkpoints' logits
within 5e-3 + 2e-2·|ref| of ``transformers``.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from gpustack_tpu.engine import weights as jw
from gpustack_tpu.engine.engine import GenRequest as JaxGenRequest
from gpustack_tpu.engine.engine import LLMEngine as JaxLLMEngine
from gpustack_tpu.models import transformer as jt
from gpustack_tpu.models.config import PRESETS as JAX_PRESETS
from gpustack_tpu.models.config import load_hf_config as jax_load_hf_config
from gpustack_tpu_torch.engine import weights as pw  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.api_server import (  # analysis: ignore[metrics-drift]
    build_engine_from_args,
    build_parser,
)
from gpustack_tpu_torch.engine.engine import GenRequest, LLMEngine  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.models import transformer as pt  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.models.config import PRESETS, get_config, load_hf_config  # analysis: ignore[metrics-drift]

FP32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_REL = 2e-2
HF_TOL = dict(atol=5e-3, rtol=2e-2)
WINDOW = 16

# tiny-moe at GPT-OSS's structure: every width a multiple of MXFP4's
# 32-value blocks
GPTOSS = dict(
    sliding_window=WINDOW, layer_sliding=(True, False), qkv_bias=True,
    o_bias=True, attn_sinks=True, num_experts=4, num_experts_per_tok=2,
    moe_intermediate_size=32, moe_scoring="softmax_topk", moe_act="gptoss",
    moe_bias=True, rope_theta=150000.0,
    rope_scaling={"rope_type": "yarn", "factor": 4.0, "beta_fast": 32.0,
                  "beta_slow": 1.0, "truncate": False,
                  "original_max_position_embeddings": 32},
)
# the leaves the JAX init leaves at zero, and the spread of their draws
ZERO_INIT = {"sinks": 1.0, "bq": 0.2, "bk": 0.2, "bv": 0.2, "bo": 0.2,
             "router_bias": 0.5, "we_gate_b": 0.2, "we_up_b": 0.2,
             "we_down_b": 0.2}


def _cfgs(dtype="float32", **fields):
    fields = {**GPTOSS, "dtype": dtype, **fields}
    return (dataclasses.replace(get_config("tiny-moe"), **fields),
            dataclasses.replace(JAX_PRESETS["tiny-moe"], **fields))


def _tree(jcfg, seed=0):
    """The JAX init as numpy, its zero leaves drawn at random."""
    tree = jax.tree.map(
        np.asarray, jt.init_params(jcfg, jax.random.key(seed),
                                   dtype=jnp.float32)
    )
    rng = np.random.default_rng(seed + 100)
    for key, spread in ZERO_INIT.items():
        leaf = tree["layers"][key]
        tree["layers"][key] = rng.uniform(
            -spread, spread, leaf.shape
        ).astype(np.float32)
    return tree


def _both(tree, cfg, dtype=torch.float32):
    """(JAX tree, port tree) from one numpy tree; bf16 leaves in bf16 on
    both sides (fp32 stays fp32: sinks, router bias)."""
    if dtype == torch.bfloat16:
        keep = {"sinks", "router_bias"}

        def cast(k, a):
            return a if k in keep else a.astype(jnp.bfloat16)

        jtree = {
            k: ({kk: cast(kk, jnp.asarray(vv)) for kk, vv in v.items()}
                if isinstance(v, dict) else cast(k, jnp.asarray(v)))
            for k, v in tree.items()
        }
        return jtree, pw.params_from_numpy(
            jax.tree.map(np.asarray, jtree), "cpu"
        )
    return (jax.tree.map(jnp.asarray, tree),
            pw.params_from_numpy(tree, "cpu"))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a)).long()


def _tokens(seed, B, T, vocab=264):
    return np.random.default_rng(seed).integers(1, vocab, (B, T)).astype(
        np.int32
    )


class _Replay:
    """Forwards on both sides; in bf16, JAX's top-k picks recorded op by
    op (``jax.disable_jit``: under the layer scan's trace they would be
    tracers) and replayed in the port's next forwards in order, the
    combine weights from the port's own router logits. The frameworks
    round bf16 activations at other places (XLA fuses), so a pick near a
    tie may flip, and one flip parts that token's output by ~30% of the
    scale."""

    def __init__(self, monkeypatch, dtype):
        self.mp, self.on, self.picks = monkeypatch, dtype == "bfloat16", []

    def jax(self, *args, **kw):
        if not self.on:
            return jt.forward(*args, **kw)
        picks = self.picks

        class Spy:
            def __getattr__(self, name):
                return getattr(lax, name)

            def top_k(self, x, k):
                v, i = lax.top_k(x, k)
                picks.append(torch.from_numpy(np.array(i)).reshape(-1, k))
                return v, i

        self.mp.setattr(jt, "lax", Spy())
        try:
            with jax.disable_jit():
                return jt.forward(*args, **kw)
        finally:
            self.mp.setattr(jt, "lax", lax)

    def port(self, *args, **kw):
        if not self.on:
            return pt.forward(*args, **kw)

        def route(x, router_w, cfg, router_bias=None):
            idx = self.picks.pop(0).long()
            logits = x.float() @ router_w.float() + router_bias.float()
            top_w = torch.softmax(torch.gather(logits, -1, idx), dim=-1)
            return idx, torch.zeros_like(logits).scatter_(-1, idx, top_w)

        own = pt.moe_route
        self.mp.setattr(pt, "moe_route", route)
        try:
            return pt.forward(*args, **kw)
        finally:
            self.mp.setattr(pt, "moe_route", own)


def _close(got, want, dtype):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **FP32_TOL)
    else:
        assert np.abs(got - want).max() <= BF16_REL * np.abs(want).max()


# ---------------------------------------------------------------------------
# _attend: softcap and sinks under every mask
# ---------------------------------------------------------------------------

B, T, HKV, G, HD = 2, 48, 2, 3, 8


def _attend_arrays(seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, HKV, G, HD)).astype(np.float32)
    k = rng.standard_normal((B, T, HKV, HD)).astype(np.float32)
    v = rng.standard_normal((B, T, HKV, HD)).astype(np.float32)
    sinks = rng.uniform(-1.0, 1.0, (HKV, G)).astype(np.float32)
    return q, k, v, sinks


def _masks(kind):
    """The masks a forward builds (positions 0..T-1, no cache): causal,
    the sliding window, or both, for a layer each (the hetero case)."""
    pos = np.arange(T)
    causal = np.broadcast_to(pos[None, :, None] >= pos[None, None, :],
                             (B, T, T))
    slide = causal & (pos[None, :, None] - pos[None, None, :] < WINDOW)
    return {"causal": [causal], "sliding": [slide],
            "hetero": [slide, causal]}[kind]


@pytest.mark.parametrize("mask_kind", ["causal", "sliding", "hetero"])
@pytest.mark.parametrize("variant", ["softcap", "sinks", "softcap_sinks"])
def test_attend_matches_jax(variant, mask_kind):
    q, k, v, sinks = _attend_arrays()
    softcap = 2.0 if "softcap" in variant else 0.0
    sk = sinks if "sinks" in variant else None
    for mask in _masks(mask_kind):
        want = jt._attend(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(mask), 0.35, softcap,
            sinks=None if sk is None else jnp.asarray(sk),
        )
        got = pt._attend(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(mask.copy()), 0.35, softcap,
            sinks=None if sk is None else torch.from_numpy(sk),
        )
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 7, 16])
def test_attend_chunks_are_bit_identical(monkeypatch, rows, dtype):
    """Query rows in chunks (a byte budget of ``rows`` rows' scores) give
    the unchunked call's bits: each row's softmax is its own."""
    q, k, v, sinks = (torch.from_numpy(a) for a in _attend_arrays(1))
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    mask = torch.from_numpy(_masks("sliding")[0].copy())
    args = (q, k, v, mask, 0.35, 2.0, sinks)
    whole = pt._attend(*args)
    monkeypatch.setattr(pt, "ATTN_CHUNK_BYTES", rows * B * HKV * G * T * 4)
    assert torch.equal(pt._attend(*args), whole)


def test_attend_default_chunks_follow_the_byte_budget(monkeypatch):
    """The chunks keep the fp32 scores within ``ATTN_CHUNK_BYTES``: a
    budget of 10 rows' scores runs 5 chunks over 48 rows, and the result
    keeps its bits."""
    q, k, v, sinks = (torch.from_numpy(a) for a in _attend_arrays(2))
    mask = torch.from_numpy(_masks("causal")[0].copy())
    whole = pt._attend(q, k, v, mask, 0.35, 0.0, sinks)
    calls = []
    rows_fn = pt._attend_rows

    def counted(q, *a):
        calls.append(q.shape[1])
        return rows_fn(q, *a)

    monkeypatch.setattr(pt, "ATTN_CHUNK_BYTES", 10 * B * HKV * G * T * 4)
    monkeypatch.setattr(pt, "_attend_rows", counted)
    assert torch.equal(pt._attend(q, k, v, mask, 0.35, 0.0, sinks), whole)
    assert calls == [10, 10, 10, 10, 8]


def test_gptoss_glu_holds_only_g_u_h():
    """The clamped GLU is built in h: an MoE token chunk holds at most
    three ``[n·k, Fm]`` transients at once (the routed pairs' gathered x,
    g and u, then g, u and h) and nothing of their size besides the
    layer's output, by the peak of the CPU allocator's live bytes in the
    profiler's memory events. (It once held two more: 1.90 GB against
    1.13 at gpt-oss-20b's 2048 bucket.)"""
    cfg, _ = _cfgs(num_experts=8, moe_intermediate_size=64)
    E, D, F, N = 8, cfg.hidden_size, 64, 512
    P = N * cfg.num_experts_per_tok
    gen = torch.Generator().manual_seed(0)

    def w(*shape):
        return torch.randn(*shape, generator=gen) * 0.1

    args = (w(1, N, D), w(D, E), w(E, D, F), w(E, D, F), w(E, F, D))
    biases = (w(E, F), w(E, F), w(E, D))
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU], profile_memory=True
    ) as prof:
        pt._moe_mlp(*args, cfg, biases=biases)
    live = peak = 0
    for e in sorted((e for e in prof.profiler.kineto_results.events()
                     if e.name() == "[memory]"), key=lambda e: e.start_ns()):
        live += e.nbytes()
        peak = max(peak, live)
    one, output = P * F * 4, N * D * 4
    assert 3 * one <= peak - output < 3.5 * one, (peak - output) / one


# ---------------------------------------------------------------------------
# the whole forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_without_cache_matches_jax(monkeypatch, dtype):
    cfg, jcfg = _cfgs(dtype)
    jtree, ttree = _both(_tree(jcfg), cfg, pt.torch_dtype(cfg))
    toks = _tokens(0, 2, 56)
    pos = np.broadcast_to(np.arange(56, dtype=np.int32), (2, 56))
    r = _Replay(monkeypatch, dtype)
    want, _ = r.jax(jtree, jcfg, jnp.asarray(toks), jnp.asarray(pos))
    got, _ = r.port(ttree, cfg, _t(toks), _t(pos), attn_impl="flash")
    _close(got.numpy(), want, dtype)


def _prefill(r, cfg, jcfg, jtree, ttree, toks, pos, S, attn_impl):
    jcache = jt.KVCache.create(jcfg, toks.shape[0], S)
    want, jcache = r.jax(jtree, jcfg, jnp.asarray(toks), jnp.asarray(pos),
                         jcache)
    tcache = pt.KVCache.create(cfg, toks.shape[0], S, torch.device("cpu"))
    got, tcache = r.port(ttree, cfg, _t(toks), _t(pos), tcache,
                         attn_impl=attn_impl)
    return want, jcache, got, tcache


@pytest.mark.parametrize("attn_impl", ["plain", "flash"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_matches_jax(monkeypatch, dtype, attn_impl):
    """A 48-token prefill (three windows) into a 64-row cache, then four
    decode steps: logits and the cache. ``"flash"`` is what the runner
    asks for on the card; a GPT-OSS prefill takes the plain attention
    there as in JAX."""
    cfg, jcfg = _cfgs(dtype)
    jtree, ttree = _both(_tree(jcfg), cfg, pt.torch_dtype(cfg))
    toks = _tokens(1, 2, 52)
    pos = np.broadcast_to(np.arange(48, dtype=np.int32), (2, 48))
    r = _Replay(monkeypatch, dtype)
    want, jcache, got, tcache = _prefill(
        r, cfg, jcfg, jtree, ttree, toks[:, :48], pos, 64, attn_impl
    )
    _close(got.numpy(), want, dtype)
    for t in range(48, 52):
        dpos = np.full((2, 1), t, np.int32)
        want, jcache = r.jax(jtree, jcfg, jnp.asarray(toks[:, t:t + 1]),
                             jnp.asarray(dpos), jcache)
        got, tcache = r.port(ttree, cfg, _t(toks[:, t:t + 1]), _t(dpos),
                             tcache)
        _close(got.numpy(), want, dtype)
    _close(tcache.k.float().numpy(), np.asarray(jcache.k, np.float32), dtype)


@pytest.mark.parametrize("attn_impl", ["plain", "flash"])
def test_chunked_continuation_matches_jax(attn_impl):
    """A 32-token prefill, then a 24-token chunk at offset 32 over the
    same cache (the runner's continuation, ``q_offset`` 32)."""
    cfg, jcfg = _cfgs()
    jtree, ttree = _both(_tree(jcfg), cfg)
    toks = _tokens(2, 1, 56)
    pos = np.arange(56, dtype=np.int32)[None, :]
    _, jcache, _, tcache = _prefill(_Replay(None, "float32"), cfg, jcfg,
                                    jtree, ttree, toks[:, :32], pos[:, :32],
                                    64, attn_impl)
    want, jcache = jt.forward(jtree, jcfg, jnp.asarray(toks[:, 32:]),
                              jnp.asarray(pos[:, 32:]), jcache)
    got, tcache = pt.forward(ttree, cfg, _t(toks[:, 32:]), _t(pos[:, 32:]),
                             tcache, attn_impl=attn_impl, q_offset=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32_TOL)
    np.testing.assert_allclose(tcache.v.numpy(), np.asarray(jcache.v),
                               **FP32_TOL)


def test_verify_block_matches_jax():
    """A speculative verify block: two rows of 4 positions each at their
    own offsets (40 and 37) over a 48-token prefill's cache."""
    cfg, jcfg = _cfgs()
    jtree, ttree = _both(_tree(jcfg), cfg)
    toks = _tokens(3, 2, 52)
    pos = np.broadcast_to(np.arange(48, dtype=np.int32), (2, 48))
    _, jcache, _, tcache = _prefill(_Replay(None, "float32"), cfg, jcfg,
                                    jtree, ttree, toks[:, :48], pos, 64,
                                    "plain")
    bpos = np.stack([np.arange(40, 44), np.arange(37, 41)]).astype(np.int32)
    block = toks[:, 48:52]
    want, jcache = jt.forward(jtree, jcfg, jnp.asarray(block),
                              jnp.asarray(bpos), jcache)
    got, tcache = pt.forward(ttree, cfg, _t(block), _t(bpos), tcache,
                             clamp_writes=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32_TOL)
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k),
                               **FP32_TOL)


@pytest.mark.parametrize("name", ["tiny", "gpt-oss-20b", "gpt-oss-120b"])
def test_init_params_shapes_match_jax(name):
    """Every leaf JAX draws (``bo``, fp32 ``sinks``, the expert biases
    and the router bias) with its shape and dtype, on the meta device."""
    if name == "tiny":
        cfg, jcfg = _cfgs("bfloat16")
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
    assert tparams["layers"]["sinks"].dtype == torch.float32


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

PROMPTS = [list(range(3, 33)), [15, 9, 2, 6] * 6, [5, 3] * 10,
           [7, 7, 7, 7, 9]]
MAX_TOKENS = 12


def test_engine_greedy_ids_identical_to_jax_engine():
    """Prefill, insert and decode past the sliding window (prompts of up
    to 30 tokens, 12 new ones, a window of 16), with an embedding: the
    JAX engine's greedy ids and vector."""
    cfg, jcfg = _cfgs()
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
# weights: a transformers checkpoint, plain and MXFP4
# ---------------------------------------------------------------------------

TOKENS = np.array([[3, 17, 92, 5, 44, 8, 120, 63, 7, 99]], dtype=np.int32)


@pytest.fixture(scope="module")
def hf_gptoss(tmp_path_factory):
    """(model, dir): a tiny ``GptOssForCausalLM`` from a seed, its sinks
    and biases drawn nonzero, saved as safetensors."""
    tfm = pytest.importorskip("transformers")
    torch.manual_seed(0)
    hf_cfg = tfm.GptOssConfig(
        vocab_size=128, hidden_size=32, intermediate_size=32,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=8, num_local_experts=4, num_experts_per_tok=2,
        sliding_window=4, layer_types=["sliding_attention", "full_attention"],
        max_position_embeddings=256, rope_theta=10000.0,
        rope_scaling={"rope_type": "yarn", "factor": 4.0, "beta_fast": 32.0,
                      "beta_slow": 1.0, "truncate": False,
                      "original_max_position_embeddings": 32},
        tie_word_embeddings=False, attention_bias=True, attention_dropout=0.0,
    )
    model = tfm.GptOssForCausalLM(hf_cfg).eval()
    with torch.no_grad():
        for layer in model.model.layers:
            layer.self_attn.sinks.uniform_(-1.0, 1.0)
            layer.self_attn.o_proj.bias.uniform_(-0.2, 0.2)
            layer.mlp.router.bias.uniform_(-0.5, 0.5)
            layer.mlp.experts.gate_up_proj_bias.uniform_(-0.2, 0.2)
            layer.mlp.experts.down_proj_bias.uniform_(-0.2, 0.2)
    d = tmp_path_factory.mktemp("gptoss")
    model.save_pretrained(d, safe_serialization=True)
    return model, str(d)


def _pack_mxfp4(w):
    """[E, in, out] float → MXFP4 (blocks [E, out, in/32, 16] uint8,
    scales [E, out, in/32] uint8) and the weight those decode to: each
    32-value block's shared power of two puts its largest magnitude at or
    under 6, and every value takes its nearest e2m1 step (the JAX suite's
    packer)."""
    t = w.transpose(1, 2).float().numpy()                    # [E, out, in]
    E, O, I = t.shape
    g = t.reshape(E, O, I // 32, 32)
    exp = np.ceil(np.log2(np.maximum(np.abs(g).max(-1, keepdims=True) / 6.0,
                                     1e-30)))
    exp = np.clip(exp, -127, 127)
    scaled = g / np.exp2(exp)
    steps = np.asarray([0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0], np.float32)
    idx = np.abs(np.abs(scaled)[..., None] - steps).argmin(-1).astype(
        np.uint8
    )
    nib = np.where(scaled < 0, idx | 0x8, idx).astype(np.uint8)
    blocks = (nib[..., 0::2] | (nib[..., 1::2] << 4)).astype(np.uint8)
    scales = (exp[..., 0] + 127).astype(np.uint8)
    decoded = (np.where(scaled < 0, -steps[idx], steps[idx]) * np.exp2(exp))
    decoded = decoded.reshape(E, O, I).transpose(0, 2, 1)    # [E, in, out]
    return (torch.from_numpy(blocks), torch.from_numpy(scales),
            torch.from_numpy(np.ascontiguousarray(decoded)))


@pytest.fixture(scope="module")
def hf_gptoss_mxfp4(hf_gptoss, tmp_path_factory):
    """(dir, {tensor name: the weight its MXFP4 decodes to}): the tiny
    checkpoint with its expert weights repacked as MXFP4."""
    from safetensors.torch import save_file

    _, model_dir = hf_gptoss
    q_dir = tmp_path_factory.mktemp("gptoss_mxfp4")
    with open(os.path.join(model_dir, "config.json")) as f:
        (q_dir / "config.json").write_text(f.read())
    tensors, decoded = {}, {}
    for name, t in pw._read_safetensors(model_dir).items():
        if name.endswith(("experts.gate_up_proj", "experts.down_proj")):
            blocks, scales, decoded[name] = _pack_mxfp4(t)
            tensors[name + "_blocks"] = blocks
            tensors[name + "_scales"] = scales
        else:
            tensors[name] = t
    save_file(tensors, str(q_dir / "model.safetensors"))
    return str(q_dir), decoded


def _bits(t):
    t = t.detach().cpu()
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else (
        t.numpy()
    )


def _jbits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


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


def _load_both(model_dir):
    cfg, jcfg = load_hf_config(model_dir), jax_load_hf_config(model_dir)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return cfg, jcfg, pw.load_hf_checkpoint(cfg, model_dir), (
        jw.load_hf_checkpoint(jcfg, model_dir)
    )


def _logits_both(cfg, jcfg, got, want, tokens, positions):
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    jcfg32 = dataclasses.replace(jcfg, dtype="float32")
    ours, _ = pt.forward(_fp32(got), cfg32, _t(tokens), _t(positions))
    theirs, _ = jt.forward(
        jax.tree.map(lambda a: a.astype(jnp.float32), want), jcfg32,
        jnp.asarray(tokens), jnp.asarray(positions),
    )
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **FP32_TOL)
    return ours.numpy()


def test_hf_checkpoint_loads_like_jax_and_transformers(hf_gptoss):
    """The tree equals the JAX loader's (fp32 sinks and router bias; the
    fused gate/up de-interleaved); the logits equal JAX's and are within
    the JAX suite's tolerance of ``transformers``, at positions 0..9 and
    past YaRN's original 32 (60..65)."""
    model, model_dir = hf_gptoss
    cfg, jcfg, got, want = _load_both(model_dir)
    assert cfg.attn_sinks and cfg.o_bias and cfg.layer_sliding == (True, False)
    _same_tree(got, want)
    assert got["layers"]["sinks"].dtype == torch.float32
    assert torch.equal(got["layers"]["sinks"][0],
                       model.model.layers[0].self_attn.sinks.detach())
    for tokens, positions in (
        (TOKENS, np.arange(10)[None, :]),
        (TOKENS[:, :6], np.arange(60, 66)[None, :]),
    ):
        ours = _logits_both(cfg, jcfg, got, want, tokens, positions)
        with torch.no_grad():
            ref = model(_t(tokens), position_ids=_t(positions)).logits
        np.testing.assert_allclose(ours, ref.numpy(), **HF_TOL)


def test_mxfp4_checkpoint_loads_like_jax_and_transformers(
    hf_gptoss, hf_gptoss_mxfp4
):
    """The MXFP4 checkpoint: both loaders give the same tree, whose expert
    leaves are the packer's own decoding of its blocks; the logits equal
    JAX's and are within tolerance of ``transformers`` running the same
    fp4-rounded experts."""
    model, _ = hf_gptoss
    q_dir, decoded = hf_gptoss_mxfp4
    cfg, jcfg, got, want = _load_both(q_dir)
    _same_tree(got, want)
    gu = decoded["model.layers.1.mlp.experts.gate_up_proj"].to(torch.bfloat16)
    assert torch.equal(got["layers"]["we_gate"][1], gu[..., 0::2])
    assert torch.equal(got["layers"]["we_up"][1], gu[..., 1::2])
    ours = _logits_both(cfg, jcfg, got, want, TOKENS, np.arange(10)[None, :])
    rounded = model.__class__(model.config).eval()
    rounded.load_state_dict(model.state_dict())
    with torch.no_grad():
        for i, layer in enumerate(rounded.model.layers):
            for name in ("gate_up_proj", "down_proj"):
                w = decoded[f"model.layers.{i}.mlp.experts.{name}"]
                getattr(layer.mlp.experts, name).copy_(w)
        ref = rounded(_t(TOKENS)).logits.numpy()
    np.testing.assert_allclose(ours, ref, **HF_TOL)


def test_mxfp4_dequant_matches_jax_bit_for_bit():
    """Every nibble and every finite e8m0 scale (0, the subnormal 2^-127,
    through 254): the port's dequantization gives the JAX loader's bf16
    bits, and ``transformers``' values."""
    rng = np.random.default_rng(0)
    E, X, G_, B_ = 3, 6, 4, 16
    blocks = rng.integers(0, 256, (E, X, G_, B_), dtype=np.uint8)
    scales = rng.integers(0, 255, (E, X, G_), dtype=np.uint8)
    scales[0, 0, :3] = (0, 1, 254)
    want = np.asarray(jw._mxfp4_dequant(blocks, scales))
    got = pw._mxfp4_dequant(torch.from_numpy(blocks),
                            torch.from_numpy(scales))
    assert got.shape == want.shape == (E, G_ * B_ * 2, X)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got.contiguous()), _jbits(want))
    mxfp4 = pytest.importorskip("transformers.integrations.mxfp4")
    near = rng.integers(120, 135, (E, X, G_), dtype=np.uint8)
    ref = mxfp4.convert_moe_packed_tensors(
        torch.from_numpy(blocks), torch.from_numpy(near), dtype=torch.float32,
    )
    got = pw._mxfp4_dequant(torch.from_numpy(blocks), torch.from_numpy(near))
    assert torch.equal(got.float(), ref)


def test_model_dir_with_an_mxfp4_checkpoint_serves(hf_gptoss_mxfp4):
    """``--model-dir`` on the MXFP4 checkpoint: the server's engine decodes
    four greedy tokens past the sliding window of 4."""
    q_dir, _ = hf_gptoss_mxfp4
    args = build_parser().parse_args([
        "--model-dir", q_dir, "--device", "cpu", "--max-slots", "2",
        "--max-seq-len", "64",
    ])
    engine = build_engine_from_args(args)
    engine.start()
    try:
        out = engine.generate(GenRequest(
            prompt_ids=[3, 17, 92, 5, 44, 8], max_tokens=4, temperature=0.0,
        ), timeout=120)
    finally:
        engine.stop()
    assert engine.cfg.attn_sinks and len(out.output_ids) == 4


def test_lora_merges_into_a_gptoss_tree_like_jax(hf_gptoss, tmp_path):
    """A PEFT adapter on q_proj and o_proj of both layers: the merged
    trees are identical (the GPT-OSS leaves need no change to the
    merge)."""
    from safetensors.torch import save_file

    _, model_dir = hf_gptoss
    rng = np.random.default_rng(9)
    tensors = {}
    for i in range(2):
        for mod, (out_f, in_f) in (("q_proj", (32, 32)), ("o_proj", (32, 32))):
            base = f"base_model.model.model.layers.{i}.self_attn.{mod}"
            tensors[base + ".lora_A.weight"] = torch.from_numpy(
                rng.standard_normal((4, in_f)).astype(np.float32) * 0.1)
            tensors[base + ".lora_B.weight"] = torch.from_numpy(
                rng.standard_normal((out_f, 4)).astype(np.float32) * 0.1)
    save_file(tensors, str(tmp_path / "adapter_model.safetensors"))
    (tmp_path / "adapter_config.json").write_text('{"r": 4, "lora_alpha": 8}')
    cfg, jcfg, got, want = _load_both(model_dir)
    got = pw.merge_lora_adapters(cfg, got, [str(tmp_path)])
    want = jw.merge_lora_adapters(jcfg, want, [str(tmp_path)])
    _same_tree(got, want)
