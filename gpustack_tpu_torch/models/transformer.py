"""Transformer core, dense Llama/Qwen path, in PyTorch.

The port of ``gpustack_tpu/models/transformer.py``. Layout and semantics
follow the JAX module so its tests compare like with like:

- parameters are a plain dict with per-layer weights stacked on a leading
  ``[L, ...]`` axis (the JAX tree, tensor for array); the block loop is a
  Python loop over layer views;
- the KV cache is ``[L, B, S_max, H_kv, head_dim]``, preallocated. Unlike
  the JAX cache (an immutable value replaced by ``dynamic_update_slice``),
  this one is **updated in place** by ``forward``. JAX's update silently
  clamps an out-of-range start; here a write past ``S_max`` is an error
  (checked on the host where positions live there, and by the indexing
  itself on the card);
- GQA without repeated KV: queries reshape to ``[B, T, H_kv, G, hd]`` and
  contract against the unexpanded cache;
- bf16 matmuls, fp32 softmax and norm accumulation; every weight product
  goes through :func:`_mm`, so int8 ``QuantW`` weights (``models/quant.py``)
  run through the W8A16 kernel on the card.

Prefill attention on the card is the hand-written flash kernel
(``ops/flash_attention.py``), and so is the cacheless embedding forward's;
decode attention, and the speculative verify and draft ingest blocks,
stay plain torch ops over the full ``S_max`` mask, as in the JAX module
(XLA there, not Pallas).

Configurations outside the dense path (MoE, MLA, sliding windows,
softcaps, attention sinks, Gemma's norms and activations) raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from gpustack_tpu_torch.models.config import ModelConfig
from gpustack_tpu_torch.models.quant import QuantW

Params = Dict[str, Any]

_NEG = -1e30


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def check_supported(cfg: ModelConfig) -> None:
    """Raise for configurations the dense port does not cover yet."""
    unsupported = [
        ("MoE", cfg.is_moe),
        ("MLA", cfg.is_mla),
        ("sliding-window attention", bool(cfg.sliding_window)),
        ("per-layer sliding flags", cfg.layer_sliding is not None),
        ("attention logit softcap", bool(cfg.attn_logit_softcap)),
        ("final logit softcap", bool(cfg.final_logit_softcap)),
        ("attention sinks", cfg.attn_sinks),
        ("post-norms", cfg.post_norms),
        ("delta-gain norms", cfg.norm_delta_gain),
        ("embedding scale", cfg.embed_scale),
        ("local rope theta", bool(cfg.rope_local_theta)),
        ("attention output bias", cfg.o_bias),
        ("query_pre_attn_scalar", bool(cfg.query_pre_attn_scalar)),
        (f"hidden_act {cfg.hidden_act!r}", cfg.hidden_act != "silu"),
    ]
    missing = [name for name, present in unsupported if present]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet (ROADMAP "
            "'Modules to port': the other families — Qwen3, Gemma, MoE, "
            "MLA, GPT-OSS)"
        )


def _mm(x: torch.Tensor, w) -> torch.Tensor:
    """Weight product ``x @ w`` over x's last axis, for plain and int8
    ``QuantW`` weights (the JAX ``_mm``). A ``QuantW`` goes through
    ``ops.w8a16_matmul``: the Hopper kernel on the card, never a
    dequantized copy; on the CPU its plain version, the JAX semantics (x
    against q in x's dtype, then the per-output-channel scale). A plain
    weight of another float dtype (a bf16 checkpoint under an fp32 config)
    is promoted as ``jnp.einsum`` promotes."""
    if isinstance(w, QuantW):
        from gpustack_tpu_torch.ops.w8a16 import w8a16_matmul

        return w8a16_matmul(x, w.q, w.s)
    if w.dtype != x.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        return x.to(dt) @ w.to(dt)
    return x @ w


def _embed_lookup(embed, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """Embedding rows for ``tokens`` in ``dtype``; an int8 ``QuantW``
    table is gathered, widened and scaled per row (a gather, as in JAX)."""
    if isinstance(embed, QuantW):
        x = embed.q[tokens].to(dtype)
        return x * embed.s[tokens].to(dtype)[..., None]
    return embed[tokens].to(dtype)


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class KVCache:
    """Slot-based KV cache: ``k, v`` are ``[L, B, S_max, H_kv, head_dim]``,
    written in place by :func:`forward` at each row's absolute positions."""

    k: torch.Tensor
    v: torch.Tensor

    @property
    def max_len(self) -> int:
        return self.k.shape[2]

    @staticmethod
    def create(
        cfg: ModelConfig, batch: int, max_len: int, device: torch.device
    ) -> "KVCache":
        shape = (
            cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim
        )
        dtype = torch_dtype(cfg)
        return KVCache(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
        )


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_params(
    cfg: ModelConfig, generator: torch.Generator,
    dtype: torch.dtype = torch.bfloat16, device=None,
) -> Params:
    """Random init with layer weights stacked on a leading [L] axis, drawn
    on ``device`` (the generator's device) from ``generator``. Same
    shapes and scales as the JAX ``init_params``; not the same numbers."""
    check_supported(cfg)
    device = torch.device(device) if device is not None else generator.device
    d, f, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers

    def w(*shape, scale=None):
        scale = scale if scale is not None else 1.0 / math.sqrt(shape[-2])
        out = torch.randn(
            shape, generator=generator, dtype=dtype, device=device
        )
        return out.mul_(scale)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    layers: Dict[str, torch.Tensor] = {
        "attn_norm": ones(L, d),
        "wq": w(L, d, cfg.q_dim),
        "wk": w(L, d, cfg.kv_dim),
        "wv": w(L, d, cfg.kv_dim),
        "wo": w(L, cfg.q_dim, d),
        "mlp_norm": ones(L, d),
        "w_gate": w(L, d, f),
        "w_up": w(L, d, f),
        "w_down": w(L, f, d),
    }
    if cfg.qkv_bias:
        layers["bq"] = zeros(L, cfg.q_dim)
        layers["bk"] = zeros(L, cfg.kv_dim)
        layers["bv"] = zeros(L, cfg.kv_dim)
    if cfg.qk_norm:
        layers["q_norm"] = ones(L, cfg.head_dim)
        layers["k_norm"] = ones(L, cfg.head_dim)
    params: Params = {
        "embed": w(cfg.vocab_size, d, scale=0.02),
        "layers": layers,
        "final_norm": ones(d),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = w(d, cfg.vocab_size)
    return params


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    n = xf * torch.rsqrt(var + eps)
    return n.to(x.dtype) * w


def _inv_freq(theta: float, head_dim: int) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (
        theta ** (torch.arange(0, half, dtype=torch.float32) / half)
    )


def rope_params(cfg: ModelConfig) -> Tuple[torch.Tensor, float]:
    """(inv_freq [head_dim/2] fp32 on the CPU, attention_factor), with HF
    llama3/linear/yarn scaling and GGUF ``factors`` divisors — the JAX
    ``rope_params`` semantics."""
    rs = cfg.rope_scaling or {}
    rope_type = rs.get("rope_type") or rs.get("type")
    factors = rs.get("factors")
    inv = _inv_freq(cfg.rope_theta, cfg.head_dim)
    if rope_type == "yarn":
        yarn_inv, att = yarn_inv_freq(cfg.rope_theta, cfg.head_dim, rs)
        if factors is not None:
            return inv / torch.as_tensor(factors, dtype=torch.float32), att
        return yarn_inv, att
    if factors is not None:
        return inv / torch.as_tensor(factors, dtype=torch.float32), 1.0
    if rope_type == "linear":
        inv = inv / rs["factor"]
    elif rope_type == "llama3":
        factor = rs["factor"]
        low = rs.get("low_freq_factor", 1.0)
        high = rs.get("high_freq_factor", 4.0)
        orig = rs.get("original_max_position_embeddings", 8192)
        wavelen = 2 * math.pi / inv
        smooth = (orig / wavelen - low) / (high - low)
        interpolated = (1 - smooth) * inv / factor + smooth * inv
        inv = torch.where(
            wavelen > orig / low,
            inv / factor,
            torch.where(wavelen < orig / high, inv, interpolated),
        )
    elif rope_type not in (None, "default"):
        raise ValueError(
            f"unsupported rope_scaling type {rope_type!r} (supported: "
            "default/linear/llama3/yarn/gguf rope_freqs)"
        )
    return inv, 1.0


def yarn_get_mscale(scale: float, m: float = 1.0) -> float:
    if scale <= 1:
        return 1.0
    return 0.1 * m * math.log(scale) + 1.0


def yarn_inv_freq(
    theta: float, dim: int, rs: Dict[str, Any]
) -> Tuple[torch.Tensor, float]:
    """YaRN NTK scaling (HF _compute_yarn_parameters semantics); returns
    (inv_freq, attention_factor)."""
    factor = float(rs["factor"])
    beta_fast = float(rs.get("beta_fast") or 32)
    beta_slow = float(rs.get("beta_slow") or 1)
    orig = int(rs.get("original_max_position_embeddings") or 4096)
    mscale = rs.get("mscale")
    mscale_all = rs.get("mscale_all_dim")
    attention_factor = rs.get("attention_factor")
    if attention_factor is None:
        if mscale and mscale_all:
            attention_factor = yarn_get_mscale(
                factor, mscale
            ) / yarn_get_mscale(factor, mscale_all)
        else:
            attention_factor = yarn_get_mscale(factor)

    def correction_dim(n_rot):
        return (
            dim * math.log(orig / (n_rot * 2 * math.pi))
        ) / (2 * math.log(theta))

    low = correction_dim(beta_fast)
    high = correction_dim(beta_slow)
    if rs.get("truncate", True):
        low, high = math.floor(low), math.ceil(high)
    low = max(low, 0)
    high = min(high, dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp(
        (torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low),
        0.0, 1.0,
    )
    extrapolation_factor = 1.0 - ramp
    pos_freqs = theta ** (
        torch.arange(0, dim, 2, dtype=torch.float32) / dim
    )
    inv_extra = 1.0 / pos_freqs
    inv_interp = 1.0 / (factor * pos_freqs)
    inv = (
        inv_interp * (1 - extrapolation_factor)
        + inv_extra * extrapolation_factor
    )
    return inv, float(attention_factor)


def rope_sin_cos(
    positions: torch.Tensor, inv_freq: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [B, T] -> (sin, cos) each [B, T, head_dim/2], fp32."""
    angles = positions[..., None].float() * inv_freq.to(positions.device)
    return torch.sin(angles), torch.cos(angles)


def apply_rope(
    x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor
) -> torch.Tensor:
    """HF 'rotate_half' convention. x: [B, T, H, hd], sin/cos [B, T, hd/2]."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    sin = sin[:, :, None, :].to(x.dtype)
    cos = cos[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attend(
    q: torch.Tensor,       # [B, T, Hkv, G, hd]
    k: torch.Tensor,       # [B, S, Hkv, hd]
    v: torch.Tensor,       # [B, S, Hkv, hd]
    mask: torch.Tensor,    # [B, T, S] bool (True = attend)
    scale: float,
) -> torch.Tensor:
    """Grouped-query attention; fp32 softmax; returns [B, T, Hkv*G*hd]."""
    scores = torch.einsum("bthgd,bshd->bhgts", q, k).float() * scale
    scores = scores.masked_fill(~mask[:, None, None, :, :], _NEG)
    weights = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhgts,bshd->bthgd", weights, v)
    return out.reshape(out.shape[0], out.shape[1], -1)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def forward(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,              # [B, T] int
    positions: torch.Tensor,           # [B, T] int absolute positions
    cache: Optional[KVCache] = None,
    return_hidden: bool = False,
    attn_impl: str = "plain",
    q_offset: int = 0,
    clamp_writes: bool = False,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Run the model.

    Without ``cache``: plain causal forward. With ``cache``: writes K/V at
    ``positions`` into the cache (in place) and attends over the whole
    cache with an absolute-position causal mask; ``T > 1`` is a prefill
    step (or a speculative verify / draft ingest block), ``T == 1`` a
    decode step.

    ``attn_impl="flash"`` sends prefill attention (cache given, ``T > 1``)
    through ``ops.flash_attention_prefill`` — the Hopper kernel for CUDA
    tensors. Every row's positions must be ``q_offset .. q_offset+T-1``:
    ``0`` for a bucketed prefill, the prefix length (or chunk start) for a
    continuation. ``q_offset`` is a host int the caller already knows, so
    the kernel's causal diagonal is set without reading ``positions`` back
    from the card. Without a cache (an embedding forward), ``"flash"``
    runs the kernel on the layer's own K/V (``S = T``, ``q_offset`` 0).
    ``"plain"`` uses :func:`_attend`; decode always does.

    ``clamp_writes`` gives the cache write the JAX module's
    ``dynamic_update_slice`` semantics: each row's block of ``T`` (its
    positions must be contiguous) lands at ``min(positions[:, 0], S - T)``.
    The runner's verify and ingest blocks use it, as the JAX runner relies
    on it for rows it has deactivated (a frozen position near the end);
    everywhere else a write past the cache is an error.

    Returns ``(logits [B, T, vocab] fp32, cache or None)``, or the final
    normalized hidden states (fp32) with ``return_hidden``.
    """
    check_supported(cfg)
    if attn_impl not in ("plain", "flash"):
        raise ValueError(f"attn_impl must be 'plain' or 'flash': {attn_impl!r}")
    B, T = tokens.shape
    dtype = torch_dtype(cfg)
    device = tokens.device
    x = _embed_lookup(params["embed"], tokens, dtype)
    inv, att_factor = rope_params(cfg)
    sin, cos = rope_sin_cos(positions, inv)
    if att_factor != 1.0:
        sin = sin * att_factor
        cos = cos * att_factor
    scale = 1.0 / math.sqrt(cfg.head_dim)
    use_flash = attn_impl == "flash" and T > 1

    if cache is None:
        if not use_flash:
            mask = positions[:, :, None] >= positions[:, None, :]
        elif positions.device.type == "cpu" and bool(
            (positions != torch.arange(T, device=device)).any()
        ):
            raise ValueError("cacheless flash rows must be at 0 .. T-1")
    else:
        S = cache.max_len
        write_pos = positions
        if clamp_writes:
            write_pos = positions[:, :1].clamp(0, S - T) + torch.arange(
                T, device=device
            )
        if positions.device.type == "cpu" and int(write_pos.max()) >= S:
            raise IndexError(
                f"KV write at position {int(write_pos.max())} >= cache "
                f"length {S}"
            )
        if use_flash and positions.device.type == "cpu" and bool(
            (positions[:, 0] != q_offset).any()
        ):
            raise ValueError(
                f"flash prefill rows must start at q_offset {q_offset}"
            )
        cache_pos = torch.arange(S, device=device)
        mask = cache_pos[None, None, :] <= positions[:, :, None]
        rows = torch.arange(B, device=device)[:, None].expand(B, T)

    if use_flash:
        from gpustack_tpu_torch.ops.flash_attention import (
            flash_attention_prefill,
        )

    lp = params["layers"]
    for li in range(cfg.num_layers):
        h = rms_norm(x, lp["attn_norm"][li], cfg.rms_norm_eps)
        q = _mm(h, lp["wq"][li])
        k = _mm(h, lp["wk"][li])
        v = _mm(h, lp["wv"][li])
        if cfg.qkv_bias:
            q, k, v = q + lp["bq"][li], k + lp["bk"][li], v + lp["bv"][li]
        q = q.reshape(B, T, cfg.num_heads, cfg.head_dim)
        k = k.reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
        v = v.reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
        if cfg.qk_norm:
            q = rms_norm(q, lp["q_norm"][li], cfg.rms_norm_eps)
            k = rms_norm(k, lp["k_norm"][li], cfg.rms_norm_eps)
        q = apply_rope(q, sin, cos)
        k = apply_rope(k, sin, cos)
        qg = q.reshape(B, T, cfg.num_kv_heads, cfg.group_size, cfg.head_dim)
        if cache is None:
            if use_flash:
                attn = flash_attention_prefill(q, k, v, scale)
            else:
                attn = _attend(qg, k, v, mask, scale)
        else:
            k_l, v_l = cache.k[li], cache.v[li]
            # in-place write at each row's absolute positions
            k_l[rows, write_pos] = k.to(k_l.dtype)
            v_l[rows, write_pos] = v.to(v_l.dtype)
            if use_flash:
                attn = flash_attention_prefill(
                    q, k_l, v_l, scale, q_offset=q_offset
                )
            else:
                attn = _attend(qg, k_l, v_l, mask, scale)
        x = x + _mm(attn, lp["wo"][li])
        h2 = rms_norm(x, lp["mlp_norm"][li], cfg.rms_norm_eps)
        g = _mm(h2, lp["w_gate"][li])
        u = _mm(h2, lp["w_up"][li])
        x = x + _mm(torch.nn.functional.silu(g) * u, lp["w_down"][li])

    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    if return_hidden:
        return x.float(), cache
    return lm_head(params, cfg, x), cache


def lm_head(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Final-normed hidden states (compute dtype) → fp32 logits."""
    x = x.to(torch_dtype(cfg))
    if cfg.tie_word_embeddings:
        return _mm(x, params["embed"].T).float()
    return _mm(x, params["lm_head"]).float()
