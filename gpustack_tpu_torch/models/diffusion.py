"""Functional latent-diffusion image generation (SD / SDXL class).

The port of ``gpustack_tpu/models/diffusion.py``: a CLIP-class text
encoder (two for SDXL), a UNet with cross-attention and a VAE decoder as
functions over a parameter tree, and DDIM sampling with classifier-free
guidance (uncond and cond rows as one batch of 2N).

Precision is JAX's: products and convolutions in the compute dtype (bf16
by default), normalisation statistics and softmax in fp32, the time and
additive-embedding MLPs in fp32. Every weight is cast to the compute dtype
where JAX casts it, so a tree stored in that dtype (``init_diffusion_params``)
and one carried across from JAX in fp32 compute the same values.

Layout: activations are NCHW in ``channels_last`` memory, conv weights
OIHW (JAX keeps NHWC and HWIO), so ``[B, C, H, W] -> [B, HW, C]`` for a
spatial transformer is a view. Linear weights are ``[in, out]`` as in JAX.

The whole path is plain torch, as it is XLA in JAX (convolutions, einsum
attention, GroupNorm, the DDIM update): no hand-written kernel serves it.
The denoising loop is a Python loop on the device with no host sync inside
a step; its alphas are host floats computed once. The noise comes from a
``torch.Generator`` on the device (or a ``noise`` tensor), so a seed gives
another image than JAX's ``jax.random.normal`` draw.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from gpustack_tpu_torch.device import resolve_device

Params = Dict[str, Any]

# the attention's query rows run in chunks of at most this many bytes of
# fp32 scores (as ``transformer.ATTN_CHUNK_BYTES``); each row's softmax is
# its own, so a chunk changes no value
ATTN_CHUNK_BYTES = 1 << 30


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    name: str = "stable-diffusion"
    # latent space
    image_size: int = 512
    latent_channels: int = 4
    vae_scale_factor: int = 8
    scaling_factor: float = 0.18215
    # text encoder (CLIP-class)
    vocab_size: int = 49408
    text_dim: int = 768
    text_layers: int = 12
    text_heads: int = 12
    max_text_len: int = 77
    text_act: str = "quick_gelu"
    # optional second text encoder (SDXL): penultimate hidden states are
    # concatenated onto the first encoder's context
    text2_dim: int = 0
    text2_layers: int = 0
    text2_heads: int = 0
    text2_act: str = "gelu"
    text2_projection_dim: int = 0
    # unet
    model_channels: int = 320
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attn_levels: Tuple[int, ...] = (0, 1, 2)
    transformer_depth: Tuple[int, ...] = (1, 1, 1, 1)  # per level
    # heads per level (diffusers' attention_head_dim is the head COUNT in
    # SD-family configs: SD1.5 -> 8 everywhere, SDXL -> [5, 10, 20])
    num_heads: Tuple[int, ...] = (8, 8, 8, 8)
    context_dim: int = 768
    addition_embed: bool = False       # SDXL pooled-text + time-ids
    addition_time_embed_dim: int = 256
    # vae decoder
    vae_channels: int = 128
    vae_channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    vae_res_blocks: int = 2
    # noise schedule (scaled-linear, SD convention)
    train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    prediction_type: str = "epsilon"   # or "v_prediction"
    dtype: str = "bfloat16"

    def heads_for(self, level: int) -> int:
        return self.num_heads[min(level, len(self.num_heads) - 1)]

    def depth_for(self, level: int) -> int:
        return self.transformer_depth[
            min(level, len(self.transformer_depth) - 1)
        ]

    @property
    def time_embed_dim(self) -> int:
        return 4 * self.model_channels

    @property
    def latent_size(self) -> int:
        return self.image_size // self.vae_scale_factor

    # calculator-facing surface, copied with the config (the JAX package's
    # scheduler/calculator.py reads these)
    @property
    def d_model(self) -> int:
        return self.model_channels * self.channel_mult[-1]

    @property
    def num_kv_heads(self) -> int:
        return 1      # pins the mesh planner to tp=1: one chip per sample

    @property
    def num_experts(self) -> int:
        return 0

    def kv_cache_bytes_per_token(self, bits: int = 16) -> int:
        return 0      # no autoregressive cache

    def param_count(self) -> int:
        c, td = self.model_channels, self.time_embed_dim
        total = td * td * 2 + self.latent_channels * c * 9 * 2
        for in_ch, out_ch, level in self._down_channels():
            total += self._res_params(in_ch, out_ch)
            if level in self.attn_levels:
                total += self._attn_params(out_ch, level)
        mid = c * self.channel_mult[-1]
        total += 2 * self._res_params(mid, mid) + self._attn_params(
            mid, len(self.channel_mult) - 1
        )
        for in_ch, out_ch, level in self._up_channels():
            total += self._res_params(in_ch, out_ch)
            if level in self.attn_levels:
                total += self._attn_params(out_ch, level)
        total += self.vocab_size * self.text_dim
        total += self.text_layers * 12 * self.text_dim * self.text_dim
        if self.text2_dim:
            total += self.vocab_size * self.text2_dim
            total += self.text2_layers * 12 * self.text2_dim * self.text2_dim
        v = self.vae_channels
        total += self.latent_channels * v * self.vae_channel_mult[-1] * 9
        for m in reversed(self.vae_channel_mult):
            total += (self.vae_res_blocks + 1) * self._res_params(
                v * m, v * m, vae=True
            )
        total += v * 3 * 9
        return int(total)

    def _res_params(self, in_ch: int, out_ch: int, vae: bool = False) -> int:
        p = in_ch * out_ch * 9 + out_ch * out_ch * 9
        if not vae:
            p += self.time_embed_dim * out_ch
        if in_ch != out_ch:
            p += in_ch * out_ch
        return p

    def _attn_params(self, ch: int, level: int) -> int:
        depth = self.depth_for(level)
        ctx = self.context_dim
        per_block = 4 * ch * ch + 2 * ch * ctx + 2 * ch * ch + 8 * ch * ch + 4 * ch * ch
        return 2 * ch * ch + depth * per_block

    def _down_channels(self):
        out = []
        in_ch = self.model_channels
        for level, m in enumerate(self.channel_mult):
            out_ch = self.model_channels * m
            for _ in range(self.num_res_blocks):
                out.append((in_ch, out_ch, level))
                in_ch = out_ch
        return out

    def _skip_channels(self):
        """The channels of each skip the down path pushes, in order."""
        outs = [self.model_channels]
        ch = self.model_channels
        for level, m in enumerate(self.channel_mult):
            for _ in range(self.num_res_blocks):
                ch = self.model_channels * m
                outs.append(ch)
            if level != len(self.channel_mult) - 1:
                outs.append(ch)
        return outs

    def _up_channels(self):
        out = []
        down_outs = self._skip_channels()
        in_ch = self.model_channels * self.channel_mult[-1]
        for rlevel, m in enumerate(reversed(self.channel_mult)):
            level = len(self.channel_mult) - 1 - rlevel
            out_ch = self.model_channels * m
            for _ in range(self.num_res_blocks + 1):
                skip = down_outs.pop()
                out.append((in_ch + skip, out_ch, level))
                in_ch = out_ch
        return out

    def weight_bytes(self, bits: int = 16) -> int:
        return self.param_count() * bits // 8


DIFFUSION_PRESETS: Dict[str, DiffusionConfig] = {
    "sd15-shaped": DiffusionConfig(name="sd15-shaped"),
    "sdxl-shaped": DiffusionConfig(
        name="sdxl-shaped",
        image_size=1024,
        scaling_factor=0.13025,
        channel_mult=(1, 2, 4),
        attn_levels=(1, 2),
        transformer_depth=(0, 2, 10),
        context_dim=2048,
        text2_dim=1280,
        text2_layers=32,
        text2_heads=20,
        text2_projection_dim=1280,
        addition_embed=True,
        num_heads=(5, 10, 20),
    ),
    "tiny-diffusion": DiffusionConfig(
        name="tiny-diffusion",
        image_size=32,
        vae_scale_factor=2,   # one VAE upsample (2 levels below)
        vocab_size=256,
        text_dim=16,
        text_layers=2,
        text_heads=2,
        max_text_len=16,
        model_channels=8,
        channel_mult=(1, 2),
        num_res_blocks=1,
        attn_levels=(0, 1),
        transformer_depth=(1, 1),
        num_heads=(2, 2),
        context_dim=16,
        vae_channels=8,
        vae_channel_mult=(1, 2),
        vae_res_blocks=1,
        train_timesteps=100,
    ),
}


def config_from_diffusers(model_dir: str, name: str = "") -> DiffusionConfig:
    """Build a DiffusionConfig from a local diffusers-format checkpoint
    (model_index.json + per-component config.json files)."""

    def read(*parts):
        try:
            with open(os.path.join(model_dir, *parts)) as f:
                return json.load(f)
        except OSError:
            return {}

    index = read("model_index.json")
    unet = read("unet", "config.json")
    vae = read("vae", "config.json")
    text = read("text_encoder", "config.json")
    text2 = read("text_encoder_2", "config.json")
    if not unet:
        raise ValueError(f"{model_dir} has no unet/config.json")

    block_types = unet.get("down_block_types", [])
    attn_levels = tuple(
        i for i, t in enumerate(block_types) if "CrossAttn" in t
    )
    block_out = unet.get("block_out_channels", [320, 640, 1280, 1280])
    base = block_out[0]
    depth = unet.get("transformer_layers_per_block", 1)
    if isinstance(depth, int):
        depth = [depth] * len(block_out)
    sample = unet.get("sample_size", 64)
    vae_scale = 2 ** (len(vae.get("block_out_channels", [0] * 4)) - 1)
    ahd = unet.get("attention_head_dim", 8)
    return DiffusionConfig(
        name=name or index.get("_class_name", "stable-diffusion"),
        image_size=sample * vae_scale,
        latent_channels=unet.get("in_channels", 4),
        vae_scale_factor=vae_scale,
        scaling_factor=vae.get("scaling_factor", 0.18215),
        vocab_size=text.get("vocab_size", 49408),
        text_dim=text.get("hidden_size", 768),
        text_layers=text.get("num_hidden_layers", 12),
        text_heads=text.get("num_attention_heads", 12),
        max_text_len=text.get("max_position_embeddings", 77),
        text_act=text.get("hidden_act", "quick_gelu"),
        text2_dim=text2.get("hidden_size", 0),
        text2_layers=text2.get("num_hidden_layers", 0),
        text2_heads=text2.get("num_attention_heads", 1) if text2 else 0,
        text2_act=text2.get("hidden_act", "gelu"),
        text2_projection_dim=text2.get("projection_dim", 0),
        model_channels=base,
        channel_mult=tuple(c // base for c in block_out),
        num_res_blocks=unet.get("layers_per_block", 2),
        attn_levels=attn_levels,
        transformer_depth=tuple(depth),
        num_heads=tuple(ahd) if isinstance(ahd, (list, tuple))
        else (ahd,) * len(block_out),
        context_dim=unet.get("cross_attention_dim", 768),
        addition_embed=unet.get("addition_embed_type") == "text_time",
        addition_time_embed_dim=unet.get("addition_time_embed_dim", 256)
        or 256,
        vae_channels=(vae.get("block_out_channels") or [128])[0],
        vae_channel_mult=tuple(
            c // (vae.get("block_out_channels") or [128])[0]
            for c in vae.get("block_out_channels", [128, 256, 512, 512])
        ),
        vae_res_blocks=vae.get("layers_per_block", 2),
        train_timesteps=1000,
        beta_start=0.00085,
        beta_end=0.012,
        prediction_type=unet.get("prediction_type", "epsilon"),
    )


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


def torch_dtype(cfg: DiffusionConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def conv_layout(w: torch.Tensor) -> torch.Tensor:
    """An OIHW conv weight in ``channels_last`` memory, the layout the
    activations have (so a conv reorders nothing per call)."""
    return w.contiguous(memory_format=torch.channels_last)


def group_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
               groups: int = 32) -> torch.Tensor:
    """GroupNorm over the channels of NCHW ``x``, computed in fp32 (eps
    1e-6) on its NHWC view, JAX's arithmetic; ``groups`` drops to the
    largest count at most ``min(groups, C)`` that divides C. The result
    has x's dtype, in ``channels_last`` memory."""
    B, C = x.shape[:2]
    groups = min(groups, C)
    while C % groups:
        groups -= 1
    xf = x.float().permute(0, 2, 3, 1)                     # [B, H, W, C]
    xg = xf.reshape(B, -1, groups, C // groups)
    var, mean = torch.var_mean(xg, dim=(1, 3), unbiased=False, keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + 1e-6)).reshape(xf.shape)
    y = y * g.float() + b.float()
    return y.to(x.dtype).permute(0, 3, 1, 2)


def layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the last axis in fp32 (eps 1e-5), the affine in fp32
    too, rounded once to x's dtype."""
    return F.layer_norm(
        x.float(), x.shape[-1:], g.float(), b.float(), 1e-5
    ).to(x.dtype)


def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           stride: int = 1, padding: int = 1) -> torch.Tensor:
    """NCHW conv, w OIHW; the bias is added after the rounded convolution,
    in the output dtype (JAX's order)."""
    out = F.conv2d(x, w.to(x.dtype), None, stride, padding)
    return out + b.to(out.dtype)[:, None, None]


def _linear_nchw(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A per-pixel ``[in, out]`` projection of NCHW ``x`` (JAX's
    ``einsum("bhwc,cd->bhwd")`` plus the bias), on its NHWC view."""
    dt = x.dtype
    y = x.permute(0, 2, 3, 1) @ w.to(dt) + b.to(dt)
    return y.permute(0, 3, 1, 2)


def _act(name: str):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    return _gelu


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")     # jax.nn.gelu's default


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding [B] -> [B, dim] (fp32), cos first."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=t.device) / half
    )
    args = t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               heads: int, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, Tq, C] x [B, Tk, C] multi-head attention: scores rounded to the
    compute dtype, then divided by sqrt(head_dim) and softmaxed in fp32
    (``mask`` [Tq, Tk] False -> -1e9 first), the probabilities cast back.
    Query rows run in chunks of at most ``ATTN_CHUNK_BYTES`` of fp32
    scores."""
    B, Tq, C = q.shape
    Tk = k.shape[1]
    hd = C // heads
    qh = q.reshape(B, Tq, heads, hd)
    kh = k.reshape(B, Tk, heads, hd)
    vh = v.reshape(B, Tk, heads, hd)

    def rows(lo: int, hi: int) -> torch.Tensor:
        s = torch.einsum("bqhd,bkhd->bhqk", qh[:, lo:hi], kh).float()
        s = s / math.sqrt(hd)
        if mask is not None:
            s = s.masked_fill(~mask[lo:hi], -1e9)
        p = torch.softmax(s, dim=-1).to(v.dtype)
        del s
        return torch.einsum("bhqk,bkhd->bqhd", p, vh)

    chunk = max(1, ATTN_CHUNK_BYTES // (B * heads * Tk * 4))
    if Tq <= chunk:
        out = rows(0, Tq)
    else:
        out = torch.cat(
            [rows(lo, min(lo + chunk, Tq)) for lo in range(0, Tq, chunk)],
            dim=1,
        )
    return out.reshape(B, Tq, C)


# ---------------------------------------------------------------------------
# text encoder (CLIP-class)
# ---------------------------------------------------------------------------


def encode_text(params: Params, cfg: DiffusionConfig, tokens: torch.Tensor,
                which: str = "text"
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """tokens [B, T] -> (last_hidden [B, T, D], penultimate [B, T, D],
    pooled [B, D]). Pooled = the final-LN hidden at each row's argmax token
    (CLIP: EOT has the highest id), projected by ``proj`` where the tree
    has one (SDXL's text2); penultimate = the last layer's input."""
    p = params[which]
    dim = cfg.text_dim if which == "text" else cfg.text2_dim
    heads = cfg.text_heads if which == "text" else cfg.text2_heads
    act = _act(cfg.text_act if which == "text" else cfg.text2_act)
    dt = torch_dtype(cfg)

    B, T = tokens.shape
    x = p["tok_emb"][tokens].to(dt) + p["pos_emb"][:T].to(dt)
    causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    layers = p["layers"]
    L = layers["wq"].shape[0]
    penultimate = x
    for i in range(L):
        lp = {k: v[i] for k, v in layers.items()}
        if i == L - 1:
            penultimate = x
        h = layer_norm(x, lp["ln1_g"], lp["ln1_b"])
        q = h @ lp["wq"].to(dt) + lp["bq"].to(dt)
        k = h @ lp["wk"].to(dt) + lp["bk"].to(dt)
        v = h @ lp["wv"].to(dt) + lp["bv"].to(dt)
        attn = _attention(q, k, v, heads, mask=causal)
        x = x + attn @ lp["wo"].to(dt) + lp["bo"].to(dt)
        h = layer_norm(x, lp["ln2_g"], lp["ln2_b"])
        h = act(h @ lp["w1"].to(dt) + lp["b1"].to(dt))
        x = x + h @ lp["w2"].to(dt) + lp["b2"].to(dt)
    if L < 2:
        penultimate = x
    last = layer_norm(x, p["lnf_g"], p["lnf_b"])
    eot = tokens.argmax(dim=-1)
    pooled = last[torch.arange(B, device=last.device), eot]
    if "proj" in p:
        pooled = pooled @ p["proj"].to(dt)
    return last, penultimate, pooled


# ---------------------------------------------------------------------------
# UNet
# ---------------------------------------------------------------------------


def _resblock(h: torch.Tensor, temb: Optional[torch.Tensor], p: Params) -> torch.Tensor:
    skip = h
    h = group_norm(h, p["norm1_g"], p["norm1_b"])
    h = conv2d(F.silu(h), p["conv1_w"], p["conv1_b"])
    if "temb_w" in p:
        dt = temb.dtype
        t = F.silu(temb) @ p["temb_w"].to(dt) + p["temb_b"].to(dt)
        h = h + t.to(h.dtype)[:, :, None, None]
    h = group_norm(h, p["norm2_g"], p["norm2_b"])
    h = conv2d(F.silu(h), p["conv2_w"], p["conv2_b"])
    if "skip_w" in p:
        skip = _linear_nchw(skip, p["skip_w"], p["skip_b"])
    return h + skip


def _transformer_block(x: torch.Tensor, context: torch.Tensor, p: Params,
                       heads: int) -> torch.Tensor:
    dt = x.dtype
    h = layer_norm(x, p["ln1_g"], p["ln1_b"])
    q = h @ p["attn1_q"].to(dt)
    k = h @ p["attn1_k"].to(dt)
    v = h @ p["attn1_v"].to(dt)
    x = x + _attention(q, k, v, heads) @ p["attn1_o"].to(dt) + p["attn1_ob"].to(dt)
    h = layer_norm(x, p["ln2_g"], p["ln2_b"])
    q = h @ p["attn2_q"].to(dt)
    k = context @ p["attn2_k"].to(dt)
    v = context @ p["attn2_v"].to(dt)
    x = x + _attention(q, k, v, heads) @ p["attn2_o"].to(dt) + p["attn2_ob"].to(dt)
    h = layer_norm(x, p["ln3_g"], p["ln3_b"])
    # GEGLU feed-forward
    a, gate = (h @ p["ff_w1"].to(dt) + p["ff_b1"].to(dt)).chunk(2, dim=-1)
    h = a * _gelu(gate)
    return x + h @ p["ff_w2"].to(dt) + p["ff_b2"].to(dt)


def _spatial_transformer(h: torch.Tensor, context: torch.Tensor, p: Params,
                         heads: int) -> torch.Tensor:
    B, C, H, W = h.shape
    x = group_norm(h, p["norm_g"], p["norm_b"])
    x = x.permute(0, 2, 3, 1).reshape(B, H * W, C)
    dt = x.dtype
    x = x @ p["proj_in_w"].to(dt) + p["proj_in_b"].to(dt)
    for bp in p["blocks"]:
        x = _transformer_block(x, context, bp, heads)
    x = x @ p["proj_out_w"].to(dt) + p["proj_out_b"].to(dt)
    return h + x.reshape(B, H, W, C).permute(0, 3, 1, 2)


def _upsample(h: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x (``jax.image.resize(..., "nearest")``)."""
    return F.interpolate(h, scale_factor=2, mode="nearest")


def unet_apply(params: Params, cfg: DiffusionConfig, latents: torch.Tensor,
               t: torch.Tensor, context: torch.Tensor,
               added_cond: Optional[Dict[str, torch.Tensor]] = None
               ) -> torch.Tensor:
    """latents [B, Cl, H, W], t [B], context [B, S, ctx] -> the noise
    prediction [B, Cl, H, W] in the compute dtype."""
    p = params["unet"]
    dt = torch_dtype(cfg)
    temb = timestep_embedding(t, cfg.model_channels)
    temb = temb @ p["time_w1"].float() + p["time_b1"].float()
    temb = F.silu(temb) @ p["time_w2"].float() + p["time_b2"].float()
    if cfg.addition_embed and added_cond is not None:
        # SDXL text_time conditioning: pooled text2 embedding + six
        # micro-conditioning scalars, each sinusoidally embedded
        ids = added_cond["time_ids"]                      # [B, 6]
        B = ids.shape[0]
        id_emb = timestep_embedding(
            ids.reshape(-1), cfg.addition_time_embed_dim
        ).reshape(B, -1)
        add = torch.cat([added_cond["pooled_text"].float(), id_emb], dim=-1)
        add = add @ p["add_w1"].float() + p["add_b1"].float()
        temb = temb + (F.silu(add) @ p["add_w2"].float() + p["add_b2"].float())
    temb = temb.to(dt)
    context = context.to(dt)

    x = latents.to(dt).contiguous(memory_format=torch.channels_last)
    h = conv2d(x, p["conv_in_w"], p["conv_in_b"])
    skips = [h]
    for level, lv in enumerate(p["down"]):
        for i, rp in enumerate(lv["res"]):
            h = _resblock(h, temb, rp)
            if lv["attn"] is not None:
                h = _spatial_transformer(
                    h, context, lv["attn"][i], cfg.heads_for(level)
                )
            skips.append(h)
        if lv["down"] is not None:
            h = conv2d(h, lv["down"]["w"], lv["down"]["b"], stride=2)
            skips.append(h)

    h = _resblock(h, temb, p["mid"]["res1"])
    h = _spatial_transformer(
        h, context, p["mid"]["attn"], cfg.heads_for(len(cfg.channel_mult) - 1)
    )
    h = _resblock(h, temb, p["mid"]["res2"])

    for ui, lv in enumerate(p["up"]):
        level = len(cfg.channel_mult) - 1 - ui
        for i, rp in enumerate(lv["res"]):
            h = torch.cat([h, skips.pop()], dim=1)
            h = _resblock(h, temb, rp)
            if lv["attn"] is not None:
                h = _spatial_transformer(
                    h, context, lv["attn"][i], cfg.heads_for(level)
                )
        if lv["up"] is not None:
            h = conv2d(_upsample(h), lv["up"]["w"], lv["up"]["b"])

    h = group_norm(h, p["norm_out_g"], p["norm_out_b"])
    return conv2d(F.silu(h), p["conv_out_w"], p["conv_out_b"])


# ---------------------------------------------------------------------------
# VAE decoder
# ---------------------------------------------------------------------------


def _vae_attn(h: torch.Tensor, p: Params) -> torch.Tensor:
    B, C, H, W = h.shape
    x = group_norm(h, p["norm_g"], p["norm_b"])
    x = x.permute(0, 2, 3, 1).reshape(B, H * W, C)
    dt = x.dtype
    q = x @ p["q_w"].to(dt) + p["q_b"].to(dt)
    k = x @ p["k_w"].to(dt) + p["k_b"].to(dt)
    v = x @ p["v_w"].to(dt) + p["v_b"].to(dt)
    out = _attention(q, k, v, heads=1)
    out = out @ p["o_w"].to(dt) + p["o_b"].to(dt)
    return h + out.reshape(B, H, W, C).permute(0, 3, 1, 2)


def vae_decode(params: Params, cfg: DiffusionConfig, z: torch.Tensor) -> torch.Tensor:
    """latents [B, Cl, h, w] -> images [B, 3, H, W] in [-1, 1] (fp32)."""
    p = params["vae"]
    dt = torch_dtype(cfg)
    z = z.to(dt).contiguous(memory_format=torch.channels_last)
    z = z / cfg.scaling_factor
    z = _linear_nchw(z, p["post_quant_w"], p["post_quant_b"])
    h = conv2d(z, p["conv_in_w"], p["conv_in_b"])
    h = _resblock(h, None, p["mid"]["res1"])
    h = _vae_attn(h, p["mid"]["attn"])
    h = _resblock(h, None, p["mid"]["res2"])
    for lv in p["up"]:
        for rp in lv["res"]:
            h = _resblock(h, None, rp)
        if lv["up"] is not None:
            h = conv2d(_upsample(h), lv["up"]["w"], lv["up"]["b"])
    h = group_norm(h, p["norm_out_g"], p["norm_out_b"])
    h = conv2d(F.silu(h), p["conv_out_w"], p["conv_out_b"])
    return h.float().clamp(-1.0, 1.0)


# ---------------------------------------------------------------------------
# sampling (DDIM, classifier-free guidance)
# ---------------------------------------------------------------------------


def _alphas_cumprod(cfg: DiffusionConfig) -> np.ndarray:
    betas = (
        np.linspace(
            cfg.beta_start ** 0.5, cfg.beta_end ** 0.5, cfg.train_timesteps,
            dtype=np.float64,
        )
        ** 2
    )
    return np.cumprod(1.0 - betas).astype(np.float32)


def ddim_schedule(cfg: DiffusionConfig, steps: int):
    """[(t, sqrt(a_t), sqrt(1 - a_t), sqrt(a_prev), sqrt(1 - a_prev))] per
    step: the timesteps from float64 ``linspace`` rounded to int32, the
    next one -1 (a_prev = 1) after the last, every root an fp32 value
    computed on the host (a Python float that holds it exactly)."""
    acp = _alphas_cumprod(cfg)
    ts = np.linspace(
        cfg.train_timesteps - 1, 0, steps, dtype=np.float64
    ).round().astype(np.int32)
    prev = np.concatenate([ts[1:], np.array([-1], np.int32)])
    one = np.float32(1.0)
    out = []
    for t, tp in zip(ts, prev):
        a_t = acp[t]
        a_prev = acp[tp] if tp >= 0 else one
        out.append((int(t), float(np.sqrt(a_t)), float(np.sqrt(one - a_t)),
                    float(np.sqrt(a_prev)), float(np.sqrt(one - a_prev))))
    return out


def encode_prompts(
    params: Params, cfg: DiffusionConfig, cond_tokens: torch.Tensor,
    uncond_tokens: torch.Tensor, height: int, width: int,
    cond_tokens2: Optional[torch.Tensor] = None,
    uncond_tokens2: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """The UNet's conditioning for one guided batch of 2N rows (uncond
    first): the context [2N, S, ctx] and, for SDXL, ``added_cond``. SD1.x
    conditions on encoder 1's final-LN output; SDXL on the penultimate
    states of both encoders, concatenated."""
    last_c, pen1_c, _ = encode_text(params, cfg, cond_tokens)
    last_u, pen1_u, _ = encode_text(params, cfg, uncond_tokens)
    context_c = pen1_c if cfg.text2_dim else last_c
    context_u = pen1_u if cfg.text2_dim else last_u
    added = None
    if cfg.text2_dim:
        ct2 = cond_tokens2 if cond_tokens2 is not None else cond_tokens
        ut2 = uncond_tokens2 if uncond_tokens2 is not None else uncond_tokens
        _, pen_c, pooled_c2 = encode_text(params, cfg, ct2, which="text2")
        _, pen_u, pooled_u2 = encode_text(params, cfg, ut2, which="text2")
        context_c = torch.cat([context_c, pen_c], dim=-1)
        context_u = torch.cat([context_u, pen_u], dim=-1)
        if cfg.addition_embed:
            B = cond_tokens.shape[0]
            time_ids = torch.tensor(
                [[height, width, 0, 0, height, width]], dtype=torch.float32,
                device=pen_c.device,
            ).repeat(2 * B, 1)
            added = {
                "pooled_text": torch.cat([pooled_u2, pooled_c2], dim=0),
                "time_ids": time_ids,
            }
    return torch.cat([context_u, context_c], dim=0), added


def ddim_step(
    params: Params, cfg: DiffusionConfig, lat: torch.Tensor,
    context: torch.Tensor, added: Optional[Dict[str, torch.Tensor]],
    step: Tuple[int, float, float, float, float], guidance: float,
) -> torch.Tensor:
    """One guided DDIM step from latents ``lat`` [B, Cl, h, w] (fp32) at
    one ``ddim_schedule`` entry: the next latents (fp32). v-prediction
    recovers eps; x0 is clipped to +-10."""
    t, sa, s1a, sp, s1p = step
    B = lat.shape[0]
    tb = torch.full((2 * B,), t, dtype=torch.int32, device=lat.device)
    out = unet_apply(
        params, cfg, torch.cat([lat, lat], dim=0), tb, context,
        added_cond=added,
    ).float()
    eps_u, eps_c = out[:B], out[B:]
    eps = eps_u + guidance * (eps_c - eps_u)
    if cfg.prediction_type == "v_prediction":
        # v = sqrt(a) eps - sqrt(1-a) x0  =>  recover eps
        eps = sa * eps + s1a * lat
    x0 = ((lat - s1a * eps) / sa).clamp(-10.0, 10.0)
    return sp * x0 + s1p * eps


def denoise(
    params: Params, cfg: DiffusionConfig, noise: torch.Tensor,
    context: torch.Tensor, added: Optional[Dict[str, torch.Tensor]],
    steps: int, guidance: float,
) -> torch.Tensor:
    """The DDIM loop from ``noise`` [B, Cl, h, w] over a guided
    conditioning of 2B rows: the final latents (fp32). No host sync
    inside a step."""
    lat = noise.float()
    for step in ddim_schedule(cfg, steps):
        lat = ddim_step(params, cfg, lat, context, added, step, guidance)
    return lat


def sample_images(
    params: Params,
    cfg: DiffusionConfig,
    generator: Optional[torch.Generator],
    cond_tokens: torch.Tensor,
    uncond_tokens: torch.Tensor,
    steps: int = 30,
    guidance: float = 7.5,
    height: int = 0,
    width: int = 0,
    cond_tokens2: Optional[torch.Tensor] = None,
    uncond_tokens2: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """DDIM sampling with classifier-free guidance: images [B, H, W, 3] in
    [0, 1] (fp32, on the device). The initial latents are ``noise``
    [B, Cl, h, w] when given, else a standard normal draw from
    ``generator`` on the tokens' device."""
    height = height or cfg.image_size
    width = width or cfg.image_size
    lh, lw = height // cfg.vae_scale_factor, width // cfg.vae_scale_factor
    B = cond_tokens.shape[0]
    if noise is None:
        noise = torch.randn(
            (B, cfg.latent_channels, lh, lw), generator=generator,
            dtype=torch.float32, device=cond_tokens.device,
        )
    context, added = encode_prompts(
        params, cfg, cond_tokens, uncond_tokens, height, width,
        cond_tokens2, uncond_tokens2,
    )
    latents = denoise(params, cfg, noise, context, added, steps, guidance)
    images = vae_decode(params, cfg, latents)
    return ((images + 1.0) / 2.0).permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# init (tests, presets, synthetic serving)
# ---------------------------------------------------------------------------


def init_diffusion_params(
    cfg: DiffusionConfig, generator: torch.Generator, device=None
) -> Params:
    """Random init of the whole pipeline on ``device`` (default: the card;
    ``generator`` must live there): JAX's shapes and scales (N(0, 1)·0.02
    for linears and convs, ones and zeros for norms and biases), not its
    numbers. Conv and linear weights, biases and embeddings are stored in
    the compute dtype (conv weights OIHW, ``channels_last``); norms and the
    time and additive MLPs in fp32, the MLP weights holding bf16 values,
    as a diffusers checkpoint read by ``load_diffusion_params`` does."""
    device = resolve_device(device)
    dt = torch_dtype(cfg)

    def normal(*shape):
        return torch.randn(
            shape, generator=generator, dtype=torch.float32, device=device
        ).mul_(0.02)

    def lin(din, dout):
        return normal(din, dout).to(dt)

    def mlp(din, dout):
        return normal(din, dout).to(torch.bfloat16).float()

    def conv(cin, cout):
        return conv_layout(normal(cout, cin, 3, 3).to(dt))

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=device)

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    def text(which: str) -> Params:
        dim = cfg.text_dim if which == "text" else cfg.text2_dim
        L = cfg.text_layers if which == "text" else cfg.text2_layers
        f32 = torch.float32
        p = {
            "tok_emb": lin(cfg.vocab_size, dim),
            "pos_emb": lin(cfg.max_text_len, dim),
            "layers": {
                "ln1_g": ones(L, dim), "ln1_b": zeros(L, dim, dtype=f32),
                "wq": normal(L, dim, dim).to(dt), "bq": zeros(L, dim),
                "wk": normal(L, dim, dim).to(dt), "bk": zeros(L, dim),
                "wv": normal(L, dim, dim).to(dt), "bv": zeros(L, dim),
                "wo": normal(L, dim, dim).to(dt), "bo": zeros(L, dim),
                "ln2_g": ones(L, dim), "ln2_b": zeros(L, dim, dtype=f32),
                "w1": normal(L, dim, 4 * dim).to(dt),
                "b1": zeros(L, 4 * dim),
                "w2": normal(L, 4 * dim, dim).to(dt),
                "b2": zeros(L, dim),
            },
            "lnf_g": ones(dim), "lnf_b": zeros(dim, dtype=torch.float32),
        }
        if which == "text2" and cfg.text2_projection_dim:
            p["proj"] = lin(dim, cfg.text2_projection_dim)
        return p

    def norm(prefix: str, ch: int) -> Params:
        return {f"{prefix}_g": ones(ch),
                f"{prefix}_b": zeros(ch, dtype=torch.float32)}

    def res(in_ch: int, out_ch: int, time_dim: int = 0) -> Params:
        p = {
            **norm("norm1", in_ch),
            "conv1_w": conv(in_ch, out_ch), "conv1_b": zeros(out_ch),
            **norm("norm2", out_ch),
            "conv2_w": conv(out_ch, out_ch), "conv2_b": zeros(out_ch),
        }
        if time_dim:
            p["temb_w"] = lin(time_dim, out_ch)
            p["temb_b"] = zeros(out_ch)
        if in_ch != out_ch:
            p["skip_w"] = lin(in_ch, out_ch)
            p["skip_b"] = zeros(out_ch)
        return p

    def spatial(ch: int, depth: int) -> Params:
        ctx = cfg.context_dim
        blocks = [{
            **norm("ln1", ch),
            "attn1_q": lin(ch, ch), "attn1_k": lin(ch, ch),
            "attn1_v": lin(ch, ch), "attn1_o": lin(ch, ch),
            "attn1_ob": zeros(ch),
            **norm("ln2", ch),
            "attn2_q": lin(ch, ch), "attn2_k": lin(ctx, ch),
            "attn2_v": lin(ctx, ch), "attn2_o": lin(ch, ch),
            "attn2_ob": zeros(ch),
            **norm("ln3", ch),
            "ff_w1": lin(ch, 8 * ch), "ff_b1": zeros(8 * ch),
            "ff_w2": lin(4 * ch, ch), "ff_b2": zeros(ch),
        } for _ in range(depth)]
        return {
            **norm("norm", ch),
            "proj_in_w": lin(ch, ch), "proj_in_b": zeros(ch),
            "blocks": blocks,
            "proj_out_w": lin(ch, ch), "proj_out_b": zeros(ch),
        }

    def updown(ch: int) -> Params:
        return {"w": conv(ch, ch), "b": zeros(ch)}

    params: Params = {"text": text("text")}
    if cfg.text2_dim:
        params["text2"] = text("text2")

    td, mc = cfg.time_embed_dim, cfg.model_channels
    f32 = torch.float32
    unet: Params = {
        "time_w1": mlp(mc, td), "time_b1": zeros(td, dtype=f32),
        "time_w2": mlp(td, td), "time_b2": zeros(td, dtype=f32),
        "conv_in_w": conv(cfg.latent_channels, mc), "conv_in_b": zeros(mc),
    }
    if cfg.addition_embed:
        add_in = cfg.text2_projection_dim + 6 * cfg.addition_time_embed_dim
        unet["add_w1"] = mlp(add_in, td)
        unet["add_b1"] = zeros(td, dtype=f32)
        unet["add_w2"] = mlp(td, td)
        unet["add_b2"] = zeros(td, dtype=f32)

    last = len(cfg.channel_mult) - 1
    down, in_ch = [], mc
    for level, m in enumerate(cfg.channel_mult):
        out_ch = mc * m
        has_attn = level in cfg.attn_levels
        lv: Params = {"res": [], "attn": [] if has_attn else None,
                      "down": None}
        for _ in range(cfg.num_res_blocks):
            lv["res"].append(res(in_ch, out_ch, td))
            if has_attn:
                lv["attn"].append(spatial(out_ch, cfg.depth_for(level)))
            in_ch = out_ch
        if level != last:
            lv["down"] = updown(out_ch)
        down.append(lv)
    unet["down"] = down

    mid_ch = mc * cfg.channel_mult[-1]
    unet["mid"] = {
        "res1": res(mid_ch, mid_ch, td),
        "attn": spatial(mid_ch, cfg.depth_for(last)),
        "res2": res(mid_ch, mid_ch, td),
    }

    skips = cfg._skip_channels()
    up, in_ch = [], mid_ch
    for rlevel, m in enumerate(reversed(cfg.channel_mult)):
        level = last - rlevel
        out_ch = mc * m
        has_attn = level in cfg.attn_levels
        lv = {"res": [], "attn": [] if has_attn else None, "up": None}
        for _ in range(cfg.num_res_blocks + 1):
            lv["res"].append(res(in_ch + skips.pop(), out_ch, td))
            if has_attn:
                lv["attn"].append(spatial(out_ch, cfg.depth_for(level)))
            in_ch = out_ch
        if rlevel != last:
            lv["up"] = updown(out_ch)
        up.append(lv)
    unet["up"] = up
    unet.update(norm("norm_out", mc))
    unet["conv_out_w"] = conv(mc, cfg.latent_channels)
    unet["conv_out_b"] = zeros(cfg.latent_channels)
    params["unet"] = unet

    vc = cfg.vae_channels
    top = vc * cfg.vae_channel_mult[-1]
    cl = cfg.latent_channels
    vae: Params = {
        "post_quant_w": lin(cl, cl), "post_quant_b": zeros(cl),
        "conv_in_w": conv(cl, top), "conv_in_b": zeros(top),
        "mid": {
            "res1": res(top, top),
            "attn": {
                **norm("norm", top),
                "q_w": lin(top, top), "q_b": zeros(top),
                "k_w": lin(top, top), "k_b": zeros(top),
                "v_w": lin(top, top), "v_b": zeros(top),
                "o_w": lin(top, top), "o_b": zeros(top),
            },
            "res2": res(top, top),
        },
    }
    vup, in_ch = [], top
    vlast = len(cfg.vae_channel_mult) - 1
    for rlevel, m in enumerate(reversed(cfg.vae_channel_mult)):
        out_ch = vc * m
        lv = {"res": [], "up": None}
        for _ in range(cfg.vae_res_blocks + 1):
            lv["res"].append(res(in_ch, out_ch))
            in_ch = out_ch
        if rlevel != vlast:
            lv["up"] = updown(out_ch)
        vup.append(lv)
    vae["up"] = vup
    vae.update(norm("norm_out", vc))
    vae["conv_out_w"] = conv(vc, 3)
    vae["conv_out_b"] = zeros(3)
    params["vae"] = vae
    return params
