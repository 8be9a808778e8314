"""The port's DeepSeek-V2 loader against the JAX package's: tiny HF
checkpoints written by ``transformers`` from a seed (as
``tests/models/test_deepseek.py`` writes them), with and without
``q_lora_rank``, one dense layer first (``first_k_dense_replace`` 1), and
a PEFT LoRA adapter on a dense and an MoE layer.

Tolerances: loaded trees identical bf16 bits, ``dense_layers`` included;
logits of the loaded tree (cast to fp32 on both sides) within 1e-5 of
JAX's, and within the JAX suite's 5e-3 + 2e-2·|ref| of ``transformers``'
own forward; merged LoRA leaves within 1e-6 of JAX's merge (fp32 trees).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpustack_tpu.engine import weights as jw
from gpustack_tpu.models import transformer as jt
from gpustack_tpu.models.config import load_hf_config as jax_load_hf_config
from gpustack_tpu_torch.engine import weights as pw  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.api_server import (  # analysis: ignore[metrics-drift]
    build_engine_from_args,
    build_parser,
)
from gpustack_tpu_torch.engine.engine import GenRequest  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.models import transformer as pt  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.models.config import load_hf_config  # analysis: ignore[metrics-drift]

TOKENS = np.array([[3, 17, 92, 5, 44, 8, 120, 63]], dtype=np.int32)
Q_LORA = {"q_lora": 24, "direct_q": None}


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


def _fp32(tree):
    return {
        k: _fp32(v) if isinstance(v, dict) else v.float()
        for k, v in tree.items()
    }


_WRITTEN = {}


def _hf_dir(variant, tmp_path_factory):
    """(model, dir) of one variant's tiny DeepSeek-V2 checkpoint, written
    once."""
    if variant not in _WRITTEN:
        tfm = pytest.importorskip("transformers")
        torch.manual_seed(0)
        hf_cfg = tfm.DeepseekV2Config(
            vocab_size=128, hidden_size=32, intermediate_size=64,
            moe_intermediate_size=16, num_hidden_layers=3,
            num_attention_heads=4, num_key_value_heads=4,
            n_shared_experts=2, n_routed_experts=4,
            routed_scaling_factor=2.0, kv_lora_rank=16,
            q_lora_rank=Q_LORA[variant], qk_rope_head_dim=8,
            qk_nope_head_dim=8, v_head_dim=12, num_experts_per_tok=2,
            first_k_dense_replace=1, norm_topk_prob=False,
            max_position_embeddings=128, rope_theta=10000.0,
            tie_word_embeddings=False, attention_dropout=0.0,
            attention_bias=False,
        )
        model = tfm.DeepseekV2ForCausalLM(hf_cfg).eval()
        d = tmp_path_factory.mktemp(variant)
        model.save_pretrained(d, safe_serialization=True)
        _WRITTEN[variant] = (model, str(d))
    return _WRITTEN[variant]


@pytest.fixture(scope="module", params=sorted(Q_LORA))
def hf_checkpoint(request, tmp_path_factory):
    return (request.param, *_hf_dir(request.param, tmp_path_factory))


def test_deepseek_v2_checkpoint_loads_like_jax(hf_checkpoint):
    variant, model, model_dir = hf_checkpoint
    cfg = load_hf_config(model_dir)
    jcfg = jax_load_hf_config(model_dir)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.is_mla and cfg.is_moe and cfg.first_k_dense == 1
    got = pw.load_hf_checkpoint(cfg, model_dir)
    want = jw.load_hf_checkpoint(jcfg, model_dir)
    _same_tree(got, want)
    assert ("wq_a" in got["layers"]) == (variant == "q_lora")
    assert "w_gate" in got["dense_layers"] and "we_gate" in got["layers"]

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


def test_deepseek_tree_stacks_onto_the_requested_device(hf_checkpoint):
    _, _, model_dir = hf_checkpoint
    cfg = load_hf_config(model_dir)
    tree = pw.load_hf_checkpoint(cfg, model_dir, device="meta")
    leaves = [tree["embed"], tree["lm_head"], *tree["layers"].values(),
              *tree["dense_layers"].values()]
    assert all(t.device.type == "meta" for t in leaves)
    assert tree["layers"]["wkv_b"].shape == (2, 16, 4 * (8 + 12))
    assert tree["dense_layers"]["w_gate"].shape == (1, 32, 64)


def test_model_dir_with_a_deepseek_checkpoint_serves(hf_checkpoint):
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
    assert engine.cfg.is_mla and len(out.output_ids) == 4


def _write_adapter(tmp_path, cfg, targets, r=4, alpha=8):
    """A PEFT adapter (lora_A [r, in], lora_B [out, r]) on ``targets``:
    (absolute layer, module, in, out)."""
    from safetensors.torch import save_file

    rng = np.random.default_rng(5)
    tensors = {}
    for i, mod, n_in, n_out in targets:
        p = f"base_model.model.model.layers.{i}.{mod}"
        tensors[f"{p}.lora_A.weight"] = torch.from_numpy(
            rng.standard_normal((r, n_in)).astype(np.float32) * 0.01
        )
        tensors[f"{p}.lora_B.weight"] = torch.from_numpy(
            rng.standard_normal((n_out, r)).astype(np.float32) * 0.01
        )
    adapter = tmp_path / "adapter"
    adapter.mkdir()
    save_file(tensors, str(adapter / "adapter_model.safetensors"))
    (adapter / "adapter_config.json").write_text(
        json.dumps({"r": r, "lora_alpha": alpha})
    )
    return str(adapter)


def test_lora_on_dense_and_moe_layers_merges_like_jax(hf_checkpoint,
                                                      tmp_path):
    """Layer 0 (the dense stack) takes o_proj and down_proj, layer 2 (the
    MoE stack's second layer) o_proj; its down_proj names experts, not a
    dense MLP, and both merges skip it. The merged leaves equal JAX's and
    land at the absolute layer's place."""
    _, _, model_dir = hf_checkpoint
    cfg = dataclasses.replace(load_hf_config(model_dir), dtype="float32")
    jcfg = dataclasses.replace(jax_load_hf_config(model_dir), dtype="float32")
    d, f, hv = cfg.hidden_size, cfg.intermediate_size, 4 * cfg.v_head_dim
    adapter = _write_adapter(tmp_path, cfg, [
        (0, "self_attn.o_proj", hv, d), (0, "mlp.down_proj", f, d),
        (2, "self_attn.o_proj", hv, d), (2, "mlp.down_proj", f, d),
    ])
    jparams = jax.tree.map(
        lambda a: a.astype(jnp.float32), jw.load_hf_checkpoint(jcfg, model_dir)
    )
    tparams = pw.params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu"
    )
    before = {k: v.clone() for k, v in (
        ("d_wo", tparams["dense_layers"]["wo"]),
        ("d_wdown", tparams["dense_layers"]["w_down"]),
        ("m_wo", tparams["layers"]["wo"]),
    )}
    pw.merge_lora_adapters(cfg, tparams, [adapter])
    jmerged = jw.merge_lora_adapters(jcfg, jparams, [adapter])
    for stack in ("dense_layers", "layers"):
        for key, want in jmerged[stack].items():
            np.testing.assert_allclose(
                tparams[stack][key].numpy(), np.asarray(want),
                rtol=1e-6, atol=1e-6, err_msg=f"{stack}/{key}",
            )
    assert not torch.equal(tparams["dense_layers"]["wo"], before["d_wo"])
    assert not torch.equal(tparams["dense_layers"]["w_down"],
                           before["d_wdown"])
    # absolute layer 2 is the MoE stack's index 1; index 0 is untouched
    assert torch.equal(tparams["layers"]["wo"][0], before["m_wo"][0])
    assert not torch.equal(tparams["layers"]["wo"][1], before["m_wo"][1])
