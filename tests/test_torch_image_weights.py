"""The PyTorch port's diffusers loader (``engine/image_weights.py``)
against the JAX package's on the same directory: ``tiny-diffusion`` and
the SDXL-style tree (``text_encoder_2`` with ``text_projection.weight``,
the additive embedding, per-level depth) written by this file's own
writer, in fp32 and in bf16, with 1x1-conv and linear projections. The two
loaded trees must be identical (keys, dtypes, values; conv weights OIHW
in the port, HWIO in JAX), and both ``unet_apply``s agree within 1e-4 of
the output's scale in fp32.
"""

import dataclasses
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.torch import save_file

from gpustack_tpu.engine.image_weights import (
    load_diffusion_params as jax_load_diffusion_params,
)
from gpustack_tpu_torch.engine.image_server import (  # analysis: ignore[metrics-drift]
    build_image_engine_from_args,
    build_parser,
)
from gpustack_tpu_torch.engine.image_weights import load_diffusion_params  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.weights import params_from_numpy  # analysis: ignore[metrics-drift]


def _load_parity_helpers():
    path = os.path.join(os.path.dirname(__file__), "test_torch_diffusion.py")
    spec = importlib.util.spec_from_file_location("_diffusion_parity", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


H = _load_parity_helpers()
jd, pd = H.jd, H.pd


def _write_diffusers(tree, cfg, root, dtype, proj_as_conv):
    """A JAX-layout numpy tree as a diffusers directory (torch layouts:
    linear ``[out, in]``, conv OIHW), every tensor in ``dtype``."""

    def t(a):
        return torch.from_numpy(np.array(a, np.float32)).to(dtype).contiguous()

    def lin(a):
        return t(np.asarray(a).T)

    def conv(a):
        return t(np.transpose(np.asarray(a), (3, 2, 0, 1)))

    def conv1x1(a):
        return t(np.asarray(a).T[:, :, None, None])

    proj = conv1x1 if proj_as_conv else lin

    def clip(p, projection):
        out = {
            "text_model.embeddings.token_embedding.weight": t(p["tok_emb"]),
            "text_model.embeddings.position_embedding.weight": t(p["pos_emb"]),
            "text_model.final_layer_norm.weight": t(p["lnf_g"]),
            "text_model.final_layer_norm.bias": t(p["lnf_b"]),
        }
        names = {
            "wq": "self_attn.q_proj.weight", "bq": "self_attn.q_proj.bias",
            "wk": "self_attn.k_proj.weight", "bk": "self_attn.k_proj.bias",
            "wv": "self_attn.v_proj.weight", "bv": "self_attn.v_proj.bias",
            "wo": "self_attn.out_proj.weight",
            "bo": "self_attn.out_proj.bias",
            "ln1_g": "layer_norm1.weight", "ln1_b": "layer_norm1.bias",
            "ln2_g": "layer_norm2.weight", "ln2_b": "layer_norm2.bias",
            "w1": "mlp.fc1.weight", "b1": "mlp.fc1.bias",
            "w2": "mlp.fc2.weight", "b2": "mlp.fc2.bias",
        }
        for ours, theirs in names.items():
            for i, v in enumerate(p["layers"][ours]):
                out[f"text_model.encoder.layers.{i}.{theirs}"] = (
                    lin(v) if v.ndim == 2 else t(v))
        if projection:
            out["text_projection.weight"] = lin(p["proj"])
        return out

    def res(p, pre):
        out = {f"{pre}.norm1.weight": t(p["norm1_g"]),
               f"{pre}.norm1.bias": t(p["norm1_b"]),
               f"{pre}.conv1.weight": conv(p["conv1_w"]),
               f"{pre}.conv1.bias": t(p["conv1_b"]),
               f"{pre}.norm2.weight": t(p["norm2_g"]),
               f"{pre}.norm2.bias": t(p["norm2_b"]),
               f"{pre}.conv2.weight": conv(p["conv2_w"]),
               f"{pre}.conv2.bias": t(p["conv2_b"])}
        if "temb_w" in p:
            out[f"{pre}.time_emb_proj.weight"] = lin(p["temb_w"])
            out[f"{pre}.time_emb_proj.bias"] = t(p["temb_b"])
        if "skip_w" in p:
            out[f"{pre}.conv_shortcut.weight"] = conv1x1(p["skip_w"])
            out[f"{pre}.conv_shortcut.bias"] = t(p["skip_b"])
        return out

    def spatial(p, pre):
        out = {f"{pre}.norm.weight": t(p["norm_g"]),
               f"{pre}.norm.bias": t(p["norm_b"]),
               f"{pre}.proj_in.weight": proj(p["proj_in_w"]),
               f"{pre}.proj_in.bias": t(p["proj_in_b"]),
               f"{pre}.proj_out.weight": proj(p["proj_out_w"]),
               f"{pre}.proj_out.bias": t(p["proj_out_b"])}
        for k, bp in enumerate(p["blocks"]):
            b = f"{pre}.transformer_blocks.{k}"
            for i in (1, 2, 3):
                out[f"{b}.norm{i}.weight"] = t(bp[f"ln{i}_g"])
                out[f"{b}.norm{i}.bias"] = t(bp[f"ln{i}_b"])
            for a in ("attn1", "attn2"):
                for x in "qkv":
                    out[f"{b}.{a}.to_{x}.weight"] = lin(bp[f"{a}_{x}"])
                out[f"{b}.{a}.to_out.0.weight"] = lin(bp[f"{a}_o"])
                out[f"{b}.{a}.to_out.0.bias"] = t(bp[f"{a}_ob"])
            out[f"{b}.ff.net.0.proj.weight"] = lin(bp["ff_w1"])
            out[f"{b}.ff.net.0.proj.bias"] = t(bp["ff_b1"])
            out[f"{b}.ff.net.2.weight"] = lin(bp["ff_w2"])
            out[f"{b}.ff.net.2.bias"] = t(bp["ff_b2"])
        return out

    def updown(p, pre):
        return {} if p is None else {f"{pre}.conv.weight": conv(p["w"]),
                                     f"{pre}.conv.bias": t(p["b"])}

    u = tree["unet"]
    unet = {"time_embedding.linear_1.weight": lin(u["time_w1"]),
            "time_embedding.linear_1.bias": t(u["time_b1"]),
            "time_embedding.linear_2.weight": lin(u["time_w2"]),
            "time_embedding.linear_2.bias": t(u["time_b2"]),
            "conv_in.weight": conv(u["conv_in_w"]),
            "conv_in.bias": t(u["conv_in_b"]),
            "conv_norm_out.weight": t(u["norm_out_g"]),
            "conv_norm_out.bias": t(u["norm_out_b"]),
            "conv_out.weight": conv(u["conv_out_w"]),
            "conv_out.bias": t(u["conv_out_b"])}
    if cfg.addition_embed:
        for i in (1, 2):
            unet[f"add_embedding.linear_{i}.weight"] = lin(u[f"add_w{i}"])
            unet[f"add_embedding.linear_{i}.bias"] = t(u[f"add_b{i}"])
    for side, key in (("down_blocks", "down"), ("up_blocks", "up")):
        for li, lv in enumerate(u[key]):
            for j, rp in enumerate(lv["res"]):
                unet.update(res(rp, f"{side}.{li}.resnets.{j}"))
                if lv["attn"] is not None:
                    unet.update(spatial(lv["attn"][j],
                                        f"{side}.{li}.attentions.{j}"))
            sampler = "downsamplers" if key == "down" else "upsamplers"
            unet.update(updown(lv[key], f"{side}.{li}.{sampler}.0"))
    unet.update(res(u["mid"]["res1"], "mid_block.resnets.0"))
    unet.update(spatial(u["mid"]["attn"], "mid_block.attentions.0"))
    unet.update(res(u["mid"]["res2"], "mid_block.resnets.1"))

    v = tree["vae"]
    at = "decoder.mid_block.attentions.0"
    vae = {"post_quant_conv.weight": conv1x1(v["post_quant_w"]),
           "post_quant_conv.bias": t(v["post_quant_b"]),
           "decoder.conv_in.weight": conv(v["conv_in_w"]),
           "decoder.conv_in.bias": t(v["conv_in_b"]),
           "decoder.conv_norm_out.weight": t(v["norm_out_g"]),
           "decoder.conv_norm_out.bias": t(v["norm_out_b"]),
           "decoder.conv_out.weight": conv(v["conv_out_w"]),
           "decoder.conv_out.bias": t(v["conv_out_b"]),
           f"{at}.group_norm.weight": t(v["mid"]["attn"]["norm_g"]),
           f"{at}.group_norm.bias": t(v["mid"]["attn"]["norm_b"])}
    for x, name in (("q", "to_q"), ("k", "to_k"), ("v", "to_v"),
                    ("o", "to_out.0")):
        vae[f"{at}.{name}.weight"] = proj(v["mid"]["attn"][f"{x}_w"])
        vae[f"{at}.{name}.bias"] = t(v["mid"]["attn"][f"{x}_b"])
    vae.update(res(v["mid"]["res1"], "decoder.mid_block.resnets.0"))
    vae.update(res(v["mid"]["res2"], "decoder.mid_block.resnets.1"))
    for ui, lv in enumerate(v["up"]):
        for j, rp in enumerate(lv["res"]):
            vae.update(res(rp, f"decoder.up_blocks.{ui}.resnets.{j}"))
        vae.update(updown(lv["up"], f"decoder.up_blocks.{ui}.upsamplers.0"))

    base = cfg.model_channels
    components = {
        "text_encoder": (clip(tree["text"], False), {
            "vocab_size": cfg.vocab_size, "hidden_size": cfg.text_dim,
            "num_hidden_layers": cfg.text_layers,
            "num_attention_heads": cfg.text_heads,
            "max_position_embeddings": cfg.max_text_len,
            "hidden_act": cfg.text_act}),
        "unet": (unet, {
            "in_channels": cfg.latent_channels,
            "sample_size": cfg.latent_size,
            "block_out_channels": [base * m for m in cfg.channel_mult],
            "layers_per_block": cfg.num_res_blocks,
            "down_block_types": [
                "CrossAttnDownBlock2D" if i in cfg.attn_levels
                else "DownBlock2D" for i in range(len(cfg.channel_mult))],
            "transformer_layers_per_block": list(cfg.transformer_depth),
            "attention_head_dim": list(cfg.num_heads),
            "cross_attention_dim": cfg.context_dim,
            **({"addition_embed_type": "text_time",
                "addition_time_embed_dim": cfg.addition_time_embed_dim}
               if cfg.addition_embed else {})}),
        "vae": (vae, {
            "block_out_channels": [cfg.vae_channels * m
                                   for m in cfg.vae_channel_mult],
            "layers_per_block": cfg.vae_res_blocks,
            "scaling_factor": cfg.scaling_factor}),
    }
    if cfg.text2_dim:
        components["text_encoder_2"] = (clip(tree["text2"], True), {
            "vocab_size": cfg.vocab_size, "hidden_size": cfg.text2_dim,
            "num_hidden_layers": cfg.text2_layers,
            "num_attention_heads": cfg.text2_heads,
            "max_position_embeddings": cfg.max_text_len,
            "hidden_act": cfg.text2_act,
            "projection_dim": cfg.text2_projection_dim})
    with open(os.path.join(root, "model_index.json"), "w") as f:
        json.dump({"_class_name": cfg.name}, f)
    for sub, (tensors, config) in components.items():
        os.makedirs(os.path.join(root, sub))
        save_file(tensors, os.path.join(
            root, sub, "diffusion_pytorch_model.safetensors"))
        with open(os.path.join(root, sub, "config.json"), "w") as f:
            json.dump(config, f)


_DT = {jnp.dtype(jnp.bfloat16): torch.bfloat16,
       jnp.dtype(jnp.float32): torch.float32}


@pytest.mark.parametrize("name,dtype,proj_as_conv", [
    ("tiny", torch.float32, True), ("tiny", torch.bfloat16, False),
    ("sdxl", torch.float32, False), ("sdxl", torch.bfloat16, True),
])
def test_loaded_trees_identical_to_jax(tmp_path, name, dtype, proj_as_conv):
    cfg = H._config(pd, name)
    tree = H.jax_tree(name)
    root = str(tmp_path / "ckpt")
    os.makedirs(root)
    _write_diffusers(tree, cfg, root, dtype, proj_as_conv)
    loaded_cfg = pd.config_from_diffusers(root)
    # a diffusers dir fixes the schedule at 1000 steps and serves bf16
    assert dataclasses.replace(
        loaded_cfg, name=cfg.name, train_timesteps=cfg.train_timesteps,
        dtype=cfg.dtype) == cfg
    assert dataclasses.asdict(jd.config_from_diffusers(root)) == (
        dataclasses.asdict(loaded_cfg))

    jtree = jax_load_diffusion_params(H._config(jd, name), root)
    got = H._paths(load_diffusion_params(loaded_cfg, root, "cpu"))
    want = H._paths(jtree)
    assert set(got) == set(want)
    for path, w in want.items():
        g = got[path]
        if w is None:
            assert g is None, path
            continue
        if w.ndim == 4:                                   # HWIO -> OIHW
            w = jnp.transpose(w, (3, 2, 0, 1))
            assert g.is_contiguous(memory_format=torch.channels_last), path
        assert g.dtype == _DT[w.dtype], (path, g.dtype, w.dtype)
        assert tuple(g.shape) == tuple(w.shape), path
        np.testing.assert_array_equal(
            g.float().numpy(), np.asarray(w.astype(jnp.float32)), err_msg=path)

    if dtype != torch.float32:
        return          # identical trees; one UNet call per config below
    lat, t, ctx, added = H._unet_inputs(cfg, 2, 8)
    want_out = H._junet(
        jtree, H._config(jd, name), jnp.asarray(lat), jnp.asarray(t),
        jnp.asarray(ctx), added_cond=None if added is None
        else {k: jnp.asarray(v) for k, v in added.items()})
    got_out = pd.unet_apply(
        load_diffusion_params(loaded_cfg, root, "cpu"),
        dataclasses.replace(loaded_cfg, dtype="float32"), H._nchw(lat),
        torch.from_numpy(t), torch.from_numpy(ctx),
        added_cond=None if added is None
        else {k: torch.from_numpy(v) for k, v in added.items()})
    H._close(H._nhwc(got_out), np.asarray(want_out), H.REL["model"]["float32"])


def test_server_builds_from_model_dir_and_falls_back_to_seed_0(tmp_path):
    cfg = H._config(pd, "tiny")
    root = str(tmp_path / "ckpt")
    os.makedirs(root)
    _write_diffusers(H.jax_tree("tiny"), cfg, root, torch.float32, True)
    engine = build_image_engine_from_args(build_parser().parse_args(
        ["--model-dir", root, "--device", "cpu"]))
    assert engine.cfg.name == "tiny-diffusion" and engine.model_dir == root
    direct = H._paths(load_diffusion_params(engine.cfg, root, "cpu"))
    assert all(v is None and direct[k] is None or torch.equal(v, direct[k])
               for k, v in H._paths(engine.params).items())
    # config.json without weights: the config's random weights, seed 0
    os.remove(os.path.join(root, "unet", "diffusion_pytorch_model.safetensors"))
    seeded = H._paths(pd.init_diffusion_params(
        cfg, torch.Generator().manual_seed(0), "cpu"))
    fallback = H._paths(load_diffusion_params(cfg, root, "cpu"))
    assert all(v is None and seeded[k] is None or torch.equal(v, seeded[k])
               for k, v in fallback.items())


@pytest.mark.parametrize("kind", ["tiny", "tiny-moe", "whisper", "tts"])
def test_params_from_numpy_keeps_other_trees(kind):
    """The LM (its MoE experts are 4-D), Whisper and TTS trees come out as
    they did before diffusion trees were carried: same keys, shapes, dtypes and
    values; only Whisper's two convs transposed to ``[Cout, Cin, K]``."""
    from gpustack_tpu.models import tts as jtts
    from gpustack_tpu.models import whisper as jwhisper
    from gpustack_tpu.models.config import PRESETS as JAX_PRESETS
    from gpustack_tpu.models.transformer import init_params

    key = jax.random.key(0)
    if kind == "whisper":
        init = lambda: jwhisper.init_whisper_params(  # noqa: E731
            jwhisper.WHISPER_PRESETS["tiny-whisper"], key, jnp.float32)
    elif kind == "tts":
        init = lambda: jtts.init_tts_params(  # noqa: E731
            jtts.TTS_PRESETS["tiny-tts"], key)
    else:
        init = lambda: init_params(  # noqa: E731
            JAX_PRESETS[kind], key, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    tree = jax.tree.map(
        lambda s: np.asarray(jnp.asarray(
            rng.standard_normal(s.shape), jnp.float32).astype(s.dtype)),
        jax.eval_shape(init))
    got = H._paths(params_from_numpy(tree, "cpu"))
    want = H._paths(tree)
    assert set(got) == set(want)
    assert kind != "tiny-moe" or any(w.ndim == 4 for w in want.values())
    for path, w in want.items():
        g = got[path]
        if kind == "whisper" and path in ("/conv1", "/conv2"):
            w = np.transpose(w, (2, 1, 0))
        assert g.dtype == (torch.bfloat16 if w.dtype.name == "bfloat16"
                           else torch.from_numpy(np.asarray(w)).dtype), path
        assert g.is_contiguous() and tuple(g.shape) == w.shape, path
        np.testing.assert_array_equal(
            g.float().numpy(), np.asarray(w, np.float32), err_msg=path)
