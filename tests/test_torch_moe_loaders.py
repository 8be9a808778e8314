"""The port's MoE loaders against the JAX package's: tiny HF checkpoints
(Qwen3-MoE, Qwen2-MoE with its gated shared expert, Mixtral) written by
``transformers`` from a seed, a fused-expert MoE GGUF written with the JAX
suite's writer, and the loud refusals. Mirrors
``tests/models/test_qwen3_moe.py``, ``tests/models/test_qwen2_moe.py`` and
the MoE cases of ``tests/engine/test_gguf.py``.

Tolerances: loaded trees identical bf16 bits (the fp32 correction bias
identical fp32); logits of the loaded tree (cast to fp32 on both sides)
within 1e-5 of JAX's, and within the JAX suite's 5e-3 + 2e-2·|ref| of
``transformers``' own forward.
"""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpustack_tpu.engine import gguf as jg
from gpustack_tpu.engine import weights as jw
from gpustack_tpu.models import transformer as jt
from gpustack_tpu.models.config import load_hf_config as jax_load_hf_config
from gpustack_tpu_torch.engine import gguf as pg  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine import weights as pw  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.api_server import (  # analysis: ignore[metrics-drift]
    build_engine_from_args,
    build_parser,
)
from gpustack_tpu_torch.engine.engine import GenRequest  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.models import transformer as pt  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.models.config import load_hf_config  # analysis: ignore[metrics-drift]

TOKENS = np.array([[3, 17, 92, 5, 44, 8, 120, 63]], dtype=np.int32)
COMMON = dict(
    vocab_size=128, hidden_size=32, intermediate_size=64,
    num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
    num_experts_per_tok=2, max_position_embeddings=128, rope_theta=10000.0,
    tie_word_embeddings=False, attention_dropout=0.0,
    router_aux_loss_coef=0.0,
)
FAMILIES = {
    "qwen3_moe": ("Qwen3MoeConfig", "Qwen3MoeForCausalLM", 0, dict(
        moe_intermediate_size=48, head_dim=8, num_experts=4,
        norm_topk_prob=True, decoder_sparse_step=1, mlp_only_layers=[],
    )),
    "qwen2_moe": ("Qwen2MoeConfig", "Qwen2MoeForCausalLM", 3, dict(
        moe_intermediate_size=16, shared_expert_intermediate_size=48,
        num_experts=4, norm_topk_prob=False, decoder_sparse_step=1,
        mlp_only_layers=[],
    )),
    "mixtral": ("MixtralConfig", "MixtralForCausalLM", 5, dict(
        num_local_experts=4,
    )),
}


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
            np.testing.assert_array_equal(
                _bits(got[k]), _jbits(w), f"{prefix}{k}"
            )


_WRITTEN = {}


def _hf_dir(family, tmp_path_factory):
    """(model, dir) of one family's tiny checkpoint, written once."""
    if family not in _WRITTEN:
        tfm = pytest.importorskip("transformers")
        cfg_cls, model_cls, seed, fields = FAMILIES[family]
        torch.manual_seed(seed)
        model = getattr(tfm, model_cls)(
            getattr(tfm, cfg_cls)(**COMMON, **fields)
        ).eval()
        d = tmp_path_factory.mktemp(family)
        model.save_pretrained(d, safe_serialization=True)
        _WRITTEN[family] = (model, str(d))
    return _WRITTEN[family]


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def hf_checkpoint(request, tmp_path_factory):
    return (request.param, *_hf_dir(request.param, tmp_path_factory))


def _fp32(tree):
    return {
        k: _fp32(v) if isinstance(v, dict) else v.float()
        for k, v in tree.items()
    }


def test_hf_moe_checkpoint_loads_like_jax(hf_checkpoint):
    family, model, model_dir = hf_checkpoint
    cfg = load_hf_config(model_dir)
    jcfg = jax_load_hf_config(model_dir)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.is_moe
    assert cfg.shared_expert_gated == (family == "qwen2_moe")
    got = pw.load_hf_checkpoint(cfg, model_dir)
    want = jw.load_hf_checkpoint(jcfg, model_dir)
    _same_tree(got, want)
    if family == "qwen2_moe":
        assert "shared_gate" in got["layers"]

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    jcfg32 = dataclasses.replace(jcfg, dtype="float32")
    pos = np.arange(TOKENS.shape[1], dtype=np.int32)[None, :]
    ours, _ = pt.forward(
        _fp32(got), cfg32, torch.from_numpy(TOKENS).long(),
        torch.from_numpy(pos).long(),
    )
    theirs, _ = jt.forward(
        jax.tree.map(lambda a: a.astype(jnp.float32), want), jcfg32,
        jnp.asarray(TOKENS), jnp.asarray(pos),
    )
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                               rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        ref = model(torch.from_numpy(TOKENS).long()).logits.numpy()
    np.testing.assert_allclose(ours.numpy(), ref, atol=5e-3, rtol=2e-2)


def test_model_dir_with_an_moe_checkpoint_serves(hf_checkpoint):
    _, _, model_dir = hf_checkpoint
    args = build_parser().parse_args([
        "--model-dir", model_dir, "--device", "cpu", "--max-slots", "2",
        "--max-seq-len", "64",
    ])
    engine = build_engine_from_args(args)
    engine.start()
    try:
        out = engine.generate(GenRequest(
            prompt_ids=[3, 17, 92, 5], max_tokens=4, temperature=0.0,
        ), timeout=120)
    finally:
        engine.stop()
    assert engine.cfg.is_moe and len(out.output_ids) == 4


def test_moe_tree_stacks_onto_the_requested_device(hf_checkpoint):
    _, _, model_dir = hf_checkpoint
    cfg = load_hf_config(model_dir)
    tree = pw.load_hf_checkpoint(cfg, model_dir, device="meta")
    leaves = [tree["embed"], tree["lm_head"], *tree["layers"].values()]
    assert all(t.device.type == "meta" for t in leaves)
    assert tree["layers"]["we_gate"].shape == (
        2, cfg.num_experts, cfg.hidden_size, cfg.moe_intermediate_size
    )


def test_shared_expert_tensors_without_a_width_raise(tmp_path_factory):
    """A Qwen3-MoE checkpoint (no shared expert in its config) with a
    shared-expert tensor added: both loaders refuse it."""
    _, model_dir = _hf_dir("qwen3_moe", tmp_path_factory)
    cfg = load_hf_config(model_dir)
    extra = "model.layers.0.mlp.shared_expert.gate_proj.weight"
    tensors = pw._read_safetensors(model_dir)
    tensors[extra] = torch.zeros(8, 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="shared expert width"):
        pw.build_lm_params(cfg, tensors)
    jtensors = jw._read_safetensors(model_dir)
    jtensors[extra] = torch.zeros(8, 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="shared expert width"):
        jw.build_lm_params(jax_load_hf_config(model_dir), jtensors)


def test_sigmoid_correction_bias_loads_as_fp32():
    """DeepSeek-V3-style routers ship an fp32 ``e_score_correction_bias``;
    it reaches the tree as fp32 (a selection tie-breaker)."""
    rng = np.random.default_rng(4)
    fields = dict(vocab_size=16, hidden_size=8, intermediate_size=8,
                  num_layers=1, num_heads=2, num_kv_heads=1, head_dim=4,
                  num_experts=2, num_experts_per_tok=1,
                  moe_intermediate_size=4, moe_scoring="sigmoid")
    cfg = dataclasses.replace(pt.ModelConfig(name="sig"), **fields)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    p = "model.layers.0."
    tensors = {
        "model.embed_tokens.weight": t(16, 8), "model.norm.weight": t(8),
        "lm_head.weight": t(16, 8), p + "input_layernorm.weight": t(8),
        p + "post_attention_layernorm.weight": t(8),
        p + "self_attn.q_proj.weight": t(8, 8),
        p + "self_attn.k_proj.weight": t(4, 8),
        p + "self_attn.v_proj.weight": t(4, 8),
        p + "self_attn.o_proj.weight": t(8, 8),
        p + "mlp.gate.weight": t(2, 8),
        p + "mlp.gate.e_score_correction_bias": t(2) * 1e-3,
    }
    for e in range(2):
        for w, shape in (("gate_proj", (4, 8)), ("up_proj", (4, 8)),
                         ("down_proj", (8, 4))):
            tensors[f"{p}mlp.experts.{e}.{w}.weight"] = t(*shape)
    bias = tensors[p + "mlp.gate.e_score_correction_bias"].clone()
    tree = pw.build_lm_params(cfg, dict(tensors))
    assert tree["layers"]["router_bias"].dtype == torch.float32
    assert torch.equal(tree["layers"]["router_bias"][0], bias)


# ---------------------------------------------------------------------------
# GGUF
# ---------------------------------------------------------------------------


def _jax_suite():
    """The JAX suite's GGUF writer (a test module, loaded by path)."""
    path = os.path.join(os.path.dirname(__file__), "engine", "test_gguf.py")
    spec = importlib.util.spec_from_file_location("_jax_gguf_suite_moe", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


G = _jax_suite()


def _write_moe_gguf(path, E=4, FM=32):
    """The JAX suite's fused-expert MoE GGUF (mixtral-class: 3-D
    ``ffn_*_exps`` tensors and the ``ffn_gate_inp`` router)."""
    rng = np.random.default_rng(11)

    def w(*shape):
        return rng.standard_normal(shape).astype(np.float32) * 0.05

    f32 = G.GGML_F32
    tensors = {
        "token_embd.weight": (w(G.V, G.D), f32),
        "output_norm.weight": (np.ones(G.D, np.float32), f32),
        "output.weight": (w(G.V, G.D), f32),
    }
    for i in range(G.L):
        wq, wk = w(G.H * G.HD, G.D), w(G.KV * G.HD, G.D)
        tensors.update({
            f"blk.{i}.attn_norm.weight": (np.ones(G.D, np.float32), f32),
            f"blk.{i}.attn_q.weight": (G._llama_permute(wq, G.H), f32),
            f"blk.{i}.attn_k.weight": (G._llama_permute(wk, G.KV), f32),
            f"blk.{i}.attn_v.weight": (w(G.KV * G.HD, G.D), f32),
            f"blk.{i}.attn_output.weight": (w(G.D, G.H * G.HD), f32),
            f"blk.{i}.ffn_norm.weight": (np.ones(G.D, np.float32), f32),
            f"blk.{i}.ffn_gate_inp.weight": (w(E, G.D), f32),
            f"blk.{i}.ffn_gate_exps.weight": (w(E, FM, G.D), f32),
            f"blk.{i}.ffn_up_exps.weight": (w(E, FM, G.D), f32),
            f"blk.{i}.ffn_down_exps.weight": (w(E, G.D, FM), f32),
        })
    G.write_gguf(path, {
        "general.architecture": "llama",
        "general.alignment": 32,
        "llama.block_count": G.L,
        "llama.embedding_length": G.D,
        "llama.feed_forward_length": G.I,
        "llama.expert_count": E,
        "llama.expert_used_count": 2,
        "llama.expert_feed_forward_length": FM,
        "llama.attention.head_count": G.H,
        "llama.attention.head_count_kv": G.KV,
        "llama.context_length": 256,
        "llama.rope.freq_base": 10000.0,
        "llama.attention.layer_norm_rms_epsilon": 1e-5,
        "llama.vocab_size": G.V,
        "tokenizer.ggml.tokens": ["<unk>", "<s>", "</s>"],
        "tokenizer.ggml.eos_token_id": 2,
    }, tensors)
    return tensors


def test_moe_gguf_loads_like_jax_and_matches_the_hf_names(tmp_path):
    path = str(tmp_path / "moe.gguf")
    tensors = _write_moe_gguf(path)
    cfg = pg.config_from_gguf(path, name="moe")
    jcfg = jg.config_from_gguf(path, name="moe")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.is_moe and cfg.num_experts == 4
    got = pw.load_gguf_checkpoint(cfg, path)
    _same_tree(got, jw.load_gguf_checkpoint(jcfg, path))
    # the fused experts split back into the per-expert HF layout
    want = np.stack([
        np.stack([tensors[f"blk.{i}.ffn_gate_exps.weight"][0][e].T
                  for e in range(4)])
        for i in range(G.L)
    ])
    np.testing.assert_allclose(got["layers"]["we_gate"].float().numpy(),
                               want, atol=2e-2, rtol=2e-2)
    logits, _ = pt.forward(
        got, cfg, torch.tensor([[1, 2, 1, 2]]),
        torch.arange(4)[None, :],
    )
    assert logits.shape == (1, 4, G.V) and torch.isfinite(logits).all()


def test_moe_gguf_serves_through_model_dir(tmp_path):
    _write_moe_gguf(str(tmp_path / "moe.gguf"))
    args = build_parser().parse_args([
        "--model-dir", str(tmp_path), "--device", "cpu", "--max-slots",
        "2", "--max-seq-len", "64",
    ])
    engine = build_engine_from_args(args)
    engine.start()
    try:
        out = engine.generate(GenRequest(
            prompt_ids=[1, 2, 1, 2], max_tokens=3, temperature=0.0,
        ), timeout=120)
    finally:
        engine.stop()
    assert engine.cfg.is_moe and len(out.output_ids) == 3


@pytest.mark.parametrize("case", ["legacy_per_expert", "shexp"])
def test_unsupported_moe_gguf_layouts_are_loud(tmp_path, case):
    path = str(tmp_path / f"{case}.gguf")
    rng = np.random.default_rng(2)
    name, match = {
        "legacy_per_expert": ("blk.0.ffn_gate.0.weight", "per-expert MoE"),
        "shexp": ("blk.0.ffn_gate_shexp.weight", "shexp"),
    }[case]
    G.write_gguf(path, {
        "general.architecture": "llama", "llama.expert_count": 8,
    }, {name: (rng.standard_normal((8, 16)).astype(np.float32),
               G.GGML_F32)})
    for mod in (pg, jg):
        with pytest.raises(ValueError, match=match):
            mod.load_gguf_tensors(path)
