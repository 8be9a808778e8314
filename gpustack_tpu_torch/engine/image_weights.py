"""Diffusers-format checkpoint loading -> the diffusion param tree.

The port of ``gpustack_tpu/engine/image_weights.py``: a local diffusers
directory (``unet/``, ``vae/``, ``text_encoder/``, optionally
``text_encoder_2/``, each holding ``*.safetensors``) mapped onto the tree
of ``models/diffusion.py``, read by the port's own safetensors reader (the
card's machine has no ``safetensors`` package). Linear weights are
transposed to ``[in, out]``; a 1x1-conv projection (SD 1.x
``proj_in``/``proj_out``, ``conv_shortcut``, ``post_quant_conv``)
collapses to a linear. Conv kernels keep torch's OIHW as stored (JAX
transposes them to HWIO), in ``channels_last`` memory.

Dtypes are JAX's ``_to_jnp``: a bf16 tensor stays bf16; any other becomes
bf16 (weights, embeddings) or fp32 (biases, norms, and every CLIP layer
leaf); the time and additive MLP weights are rounded to bf16 and held in
fp32.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict

import torch

from gpustack_tpu_torch.device import resolve_device
from gpustack_tpu_torch.engine.weights import _read_safetensors
from gpustack_tpu_torch.models.diffusion import (
    DiffusionConfig,
    conv_layout,
    init_diffusion_params,
)

logger = logging.getLogger(__name__)

Params = Dict[str, Any]


def _cast(t: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """JAX's ``_to_jnp``: bf16 stays bf16, anything else becomes ``dtype``."""
    return t if t.dtype == torch.bfloat16 else t.to(dtype)


class _Taker:
    """Pops checkpoint tensors by name onto ``device`` in the tree's
    layouts and dtypes."""

    def __init__(self, tensors: Dict[str, torch.Tensor], device: torch.device):
        self.tensors = tensors
        self.device = device

    def __contains__(self, name: str) -> bool:
        return name in self.tensors

    def _put(self, t: torch.Tensor) -> torch.Tensor:
        return t.contiguous().to(self.device)

    def lin(self, name: str) -> torch.Tensor:
        """torch linear weight ``[out, in]`` -> ``[in, out]``."""
        return self._put(_cast(self.tensors.pop(name).T))

    def vec(self, name: str) -> torch.Tensor:
        return self._put(_cast(self.tensors.pop(name), torch.float32))

    def mlp(self, name: str) -> torch.Tensor:
        """A time/additive MLP weight: through bf16, held in fp32."""
        return self.lin(name).float()

    def convw(self, name: str) -> torch.Tensor:
        return conv_layout(self._put(_cast(self.tensors.pop(name))))

    def proj(self, name: str) -> torch.Tensor:
        """A linear ``[O, I]`` or 1x1 conv ``[O, I, 1, 1]`` -> ``[in, out]``."""
        t = self.tensors.pop(name)
        if t.dim() == 4:
            t = t[:, :, 0, 0]
        return self._put(_cast(t.T))

    def raw(self, name: str) -> torch.Tensor:
        return self._put(_cast(self.tensors.pop(name)))


def _load_clip(take: _Taker, layers: int, prefix: str = "text_model",
               projection: str = "") -> Params:
    def stack(leaf: str, linear: bool = True) -> torch.Tensor:
        parts = []
        for i in range(layers):
            t = take.tensors.pop(f"{prefix}.encoder.layers.{i}.{leaf}")
            parts.append(_cast(t.T if linear else t, torch.float32))
        return take._put(torch.stack(parts))

    p = {
        "tok_emb": take.raw(f"{prefix}.embeddings.token_embedding.weight"),
        "pos_emb": take.raw(f"{prefix}.embeddings.position_embedding.weight"),
        "layers": {
            "ln1_g": stack("layer_norm1.weight", False),
            "ln1_b": stack("layer_norm1.bias", False),
            "wq": stack("self_attn.q_proj.weight"),
            "bq": stack("self_attn.q_proj.bias", False),
            "wk": stack("self_attn.k_proj.weight"),
            "bk": stack("self_attn.k_proj.bias", False),
            "wv": stack("self_attn.v_proj.weight"),
            "bv": stack("self_attn.v_proj.bias", False),
            "wo": stack("self_attn.out_proj.weight"),
            "bo": stack("self_attn.out_proj.bias", False),
            "ln2_g": stack("layer_norm2.weight", False),
            "ln2_b": stack("layer_norm2.bias", False),
            "w1": stack("mlp.fc1.weight"),
            "b1": stack("mlp.fc1.bias", False),
            "w2": stack("mlp.fc2.weight"),
            "b2": stack("mlp.fc2.bias", False),
        },
        "lnf_g": take.vec(f"{prefix}.final_layer_norm.weight"),
        "lnf_b": take.vec(f"{prefix}.final_layer_norm.bias"),
    }
    if projection and projection in take:
        p["proj"] = take.lin(projection)
    return p


def _load_res(take: _Taker, prefix: str, has_temb: bool = True) -> Params:
    p = {
        "norm1_g": take.vec(f"{prefix}.norm1.weight"),
        "norm1_b": take.vec(f"{prefix}.norm1.bias"),
        "conv1_w": take.convw(f"{prefix}.conv1.weight"),
        "conv1_b": take.vec(f"{prefix}.conv1.bias"),
        "norm2_g": take.vec(f"{prefix}.norm2.weight"),
        "norm2_b": take.vec(f"{prefix}.norm2.bias"),
        "conv2_w": take.convw(f"{prefix}.conv2.weight"),
        "conv2_b": take.vec(f"{prefix}.conv2.bias"),
    }
    if has_temb and f"{prefix}.time_emb_proj.weight" in take:
        p["temb_w"] = take.lin(f"{prefix}.time_emb_proj.weight")
        p["temb_b"] = take.vec(f"{prefix}.time_emb_proj.bias")
    if f"{prefix}.conv_shortcut.weight" in take:
        p["skip_w"] = take.proj(f"{prefix}.conv_shortcut.weight")
        p["skip_b"] = take.vec(f"{prefix}.conv_shortcut.bias")
    return p


def _load_spatial(take: _Taker, prefix: str, depth: int) -> Params:
    blocks = []
    for k in range(depth):
        bp = f"{prefix}.transformer_blocks.{k}"
        blocks.append({
            "ln1_g": take.vec(f"{bp}.norm1.weight"),
            "ln1_b": take.vec(f"{bp}.norm1.bias"),
            "attn1_q": take.lin(f"{bp}.attn1.to_q.weight"),
            "attn1_k": take.lin(f"{bp}.attn1.to_k.weight"),
            "attn1_v": take.lin(f"{bp}.attn1.to_v.weight"),
            "attn1_o": take.lin(f"{bp}.attn1.to_out.0.weight"),
            "attn1_ob": take.vec(f"{bp}.attn1.to_out.0.bias"),
            "ln2_g": take.vec(f"{bp}.norm2.weight"),
            "ln2_b": take.vec(f"{bp}.norm2.bias"),
            "attn2_q": take.lin(f"{bp}.attn2.to_q.weight"),
            "attn2_k": take.lin(f"{bp}.attn2.to_k.weight"),
            "attn2_v": take.lin(f"{bp}.attn2.to_v.weight"),
            "attn2_o": take.lin(f"{bp}.attn2.to_out.0.weight"),
            "attn2_ob": take.vec(f"{bp}.attn2.to_out.0.bias"),
            "ln3_g": take.vec(f"{bp}.norm3.weight"),
            "ln3_b": take.vec(f"{bp}.norm3.bias"),
            "ff_w1": take.lin(f"{bp}.ff.net.0.proj.weight"),
            "ff_b1": take.vec(f"{bp}.ff.net.0.proj.bias"),
            "ff_w2": take.lin(f"{bp}.ff.net.2.weight"),
            "ff_b2": take.vec(f"{bp}.ff.net.2.bias"),
        })
    return {
        "norm_g": take.vec(f"{prefix}.norm.weight"),
        "norm_b": take.vec(f"{prefix}.norm.bias"),
        "proj_in_w": take.proj(f"{prefix}.proj_in.weight"),
        "proj_in_b": take.vec(f"{prefix}.proj_in.bias"),
        "blocks": blocks,
        "proj_out_w": take.proj(f"{prefix}.proj_out.weight"),
        "proj_out_b": take.vec(f"{prefix}.proj_out.bias"),
    }


def _updown(take: _Taker, prefix: str):
    if f"{prefix}.conv.weight" not in take:
        return None
    return {"w": take.convw(f"{prefix}.conv.weight"),
            "b": take.vec(f"{prefix}.conv.bias")}


def _load_unet(take: _Taker, cfg: DiffusionConfig) -> Params:
    unet: Params = {
        "time_w1": take.mlp("time_embedding.linear_1.weight"),
        "time_b1": take.vec("time_embedding.linear_1.bias"),
        "time_w2": take.mlp("time_embedding.linear_2.weight"),
        "time_b2": take.vec("time_embedding.linear_2.bias"),
        "conv_in_w": take.convw("conv_in.weight"),
        "conv_in_b": take.vec("conv_in.bias"),
    }
    if cfg.addition_embed:
        unet["add_w1"] = take.mlp("add_embedding.linear_1.weight")
        unet["add_b1"] = take.vec("add_embedding.linear_1.bias")
        unet["add_w2"] = take.mlp("add_embedding.linear_2.weight")
        unet["add_b2"] = take.vec("add_embedding.linear_2.bias")

    down = []
    for level in range(len(cfg.channel_mult)):
        has_attn = level in cfg.attn_levels
        lv: Params = {"res": [], "attn": [] if has_attn else None}
        for j in range(cfg.num_res_blocks):
            lv["res"].append(_load_res(take, f"down_blocks.{level}.resnets.{j}"))
            if has_attn:
                lv["attn"].append(_load_spatial(
                    take, f"down_blocks.{level}.attentions.{j}",
                    cfg.depth_for(level),
                ))
        lv["down"] = _updown(take, f"down_blocks.{level}.downsamplers.0")
        down.append(lv)
    unet["down"] = down

    unet["mid"] = {
        "res1": _load_res(take, "mid_block.resnets.0"),
        "attn": _load_spatial(take, "mid_block.attentions.0",
                              cfg.depth_for(len(cfg.channel_mult) - 1)),
        "res2": _load_res(take, "mid_block.resnets.1"),
    }

    up = []
    for ui in range(len(cfg.channel_mult)):
        level = len(cfg.channel_mult) - 1 - ui
        has_attn = level in cfg.attn_levels
        lv = {"res": [], "attn": [] if has_attn else None}
        for j in range(cfg.num_res_blocks + 1):
            lv["res"].append(_load_res(take, f"up_blocks.{ui}.resnets.{j}"))
            if has_attn:
                lv["attn"].append(_load_spatial(
                    take, f"up_blocks.{ui}.attentions.{j}",
                    cfg.depth_for(level),
                ))
        lv["up"] = _updown(take, f"up_blocks.{ui}.upsamplers.0")
        up.append(lv)
    unet["up"] = up
    unet["norm_out_g"] = take.vec("conv_norm_out.weight")
    unet["norm_out_b"] = take.vec("conv_norm_out.bias")
    unet["conv_out_w"] = take.convw("conv_out.weight")
    unet["conv_out_b"] = take.vec("conv_out.bias")
    return unet


def _load_vae(take: _Taker, cfg: DiffusionConfig) -> Params:
    at = "decoder.mid_block.attentions.0"
    vae: Params = {
        "post_quant_w": take.proj("post_quant_conv.weight"),
        "post_quant_b": take.vec("post_quant_conv.bias"),
        "conv_in_w": take.convw("decoder.conv_in.weight"),
        "conv_in_b": take.vec("decoder.conv_in.bias"),
        "mid": {
            "res1": _load_res(take, "decoder.mid_block.resnets.0",
                              has_temb=False),
            "attn": {
                "norm_g": take.vec(f"{at}.group_norm.weight"),
                "norm_b": take.vec(f"{at}.group_norm.bias"),
                **{f"{x}_{k}": (take.proj if k == "w" else take.vec)(
                    f"{at}.{name}.{'weight' if k == 'w' else 'bias'}")
                   for x, name in (("q", "to_q"), ("k", "to_k"),
                                   ("v", "to_v"), ("o", "to_out.0"))
                   for k in ("w", "b")},
            },
            "res2": _load_res(take, "decoder.mid_block.resnets.1",
                              has_temb=False),
        },
    }
    vup = []
    for ui in range(len(cfg.vae_channel_mult)):
        vup.append({
            "res": [
                _load_res(take, f"decoder.up_blocks.{ui}.resnets.{j}",
                          has_temb=False)
                for j in range(cfg.vae_res_blocks + 1)
            ],
            "up": _updown(take, f"decoder.up_blocks.{ui}.upsamplers.0"),
        })
    vae["up"] = vup
    vae["norm_out_g"] = take.vec("decoder.conv_norm_out.weight")
    vae["norm_out_b"] = take.vec("decoder.conv_norm_out.bias")
    vae["conv_out_w"] = take.convw("decoder.conv_out.weight")
    vae["conv_out_b"] = take.vec("decoder.conv_out.bias")
    return vae


def load_diffusion_params(cfg: DiffusionConfig, model_dir: str,
                          device=None) -> Params:
    """A diffusers-format local checkpoint dir as the diffusion tree on
    ``device`` (default: the card). Without weights under ``unet/``, the
    config's random weights from seed 0 (the ``load_whisper_params``
    contract)."""
    device = resolve_device(device)
    try:
        unet_tensors = _read_safetensors(os.path.join(model_dir, "unet"))
    except FileNotFoundError:
        logger.warning(
            "no diffusion checkpoint under %r — random init", model_dir
        )
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        return init_diffusion_params(cfg, gen, device)
    params: Params = {}
    take = _Taker(
        _read_safetensors(os.path.join(model_dir, "text_encoder")), device
    )
    params["text"] = _load_clip(take, cfg.text_layers)
    if cfg.text2_dim:
        take = _Taker(_read_safetensors(
            os.path.join(model_dir, "text_encoder_2")), device)
        params["text2"] = _load_clip(
            take, cfg.text2_layers, projection="text_projection.weight"
        )
    params["unet"] = _load_unet(_Taker(unet_tensors, device), cfg)
    params["vae"] = _load_vae(
        _Taker(_read_safetensors(os.path.join(model_dir, "vae")), device),
        cfg,
    )
    return params
