"""Transformer core, dense and MoE Llama/Qwen paths and DeepSeek's MLA, in
PyTorch.

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
  run through the W8A16 kernel on the card;
- MoE layers (Mixtral, Qwen2/3-MoE; :func:`_moe_mlp`) keep the JAX
  module's dense dispatch: every expert runs over every token and the
  router's top-k weights combine the results. The expert products are
  batched torch products over the expert axis (XLA products in the JAX
  module, not Pallas), in token chunks that bound their transients;
- MLA (DeepSeek-V2/V3) is served decompressed, as in the JAX module: the
  latent projections are expanded to per-head K (``qk_nope + qk_rope``
  wide, the rope part rotated in interleaved pairs and shared by the
  heads) and V (zero-padded to the same width), so the cache layout and
  the flash kernel are every family's. DeepSeek's ``first_k_dense``
  layers are a stack of their own (``params["dense_layers"]``) that runs
  before the MoE stack over the cache's first layers.

Prefill attention on the card is the hand-written flash kernel
(``ops/flash_attention.py``), and so is the cacheless embedding forward's;
decode attention, and the speculative verify and draft ingest blocks,
stay plain torch ops over the full ``S_max`` mask, as in the JAX module
(XLA there, not Pallas).

Configurations outside these paths (sliding windows, softcaps, attention
sinks, post-norms, Gemma's norms and activations) raise
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
    """Raise for configurations the port does not cover yet."""
    unsupported = [
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
            "'Modules to port': the other families — Gemma, GPT-OSS)"
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
    shapes and scales as the JAX ``init_params``; not the same numbers.
    Expert weights are drawn one layer at a time, so the peak is the tree
    itself. With ``first_k_dense`` (DeepSeek) the first layers are a
    dense stack of their own, ``params["dense_layers"]``, and
    ``params["layers"]`` holds the MoE rest; each is drawn at its own
    depth (JAX draws every leaf at full depth and slices)."""
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

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    def w_layers(*shape, scale=None):
        """Like ``w``, drawn one layer at a time into the stacked tensor
        (qwen3-30b-a3b's ``we_gate`` alone is 19.3 GB)."""
        scale = scale if scale is not None else 1.0 / math.sqrt(shape[-2])
        out = torch.empty(shape, dtype=dtype, device=device)
        for layer in out:
            layer.normal_(generator=generator).mul_(scale)
        return out

    def stack(n: int, moe: bool) -> Dict[str, torch.Tensor]:
        """The leaves of ``n`` stacked layers, with the MoE MLP or the
        dense one."""
        if cfg.is_mla:
            H, r = cfg.num_heads, cfg.kv_lora_rank
            layers: Dict[str, torch.Tensor] = {
                "attn_norm": ones(n, d),
                "wkv_a": w(n, d, r + cfg.qk_rope_head_dim),
                "kv_a_norm": ones(n, r),
                "wkv_b": w(n, r, H * (cfg.qk_nope_head_dim + cfg.v_head_dim)),
                "wo": w(n, H * cfg.v_head_dim, d),
                "mlp_norm": ones(n, d),
            }
            if cfg.q_lora_rank:
                layers["wq_a"] = w(n, d, cfg.q_lora_rank)
                layers["q_a_norm"] = ones(n, cfg.q_lora_rank)
                layers["wq_b"] = w(n, cfg.q_lora_rank, H * cfg.head_dim)
            else:
                layers["wq"] = w(n, d, H * cfg.head_dim)
        else:
            layers = {
                "attn_norm": ones(n, d),
                "wq": w(n, d, cfg.q_dim),
                "wk": w(n, d, cfg.kv_dim),
                "wv": w(n, d, cfg.kv_dim),
                "wo": w(n, cfg.q_dim, d),
                "mlp_norm": ones(n, d),
            }
        if moe:
            fm, E = cfg.moe_intermediate_size, cfg.num_experts
            layers["router"] = w(n, d, E)
            layers["we_gate"] = w_layers(n, E, d, fm)
            layers["we_up"] = w_layers(n, E, d, fm)
            layers["we_down"] = w_layers(n, E, fm, d)
            if cfg.shared_expert_intermediate_size:
                fs = cfg.shared_expert_intermediate_size
                layers["ws_gate"] = w(n, d, fs)
                layers["ws_up"] = w(n, d, fs)
                layers["ws_down"] = w(n, fs, d)
                if cfg.shared_expert_gated:
                    layers["shared_gate"] = w(n, d, 1)
            if cfg.moe_scoring in ("sigmoid", "softmax_topk"):
                # DeepSeek-V3 correction bias / GPT-OSS affine router, fp32
                layers["router_bias"] = zeros(n, E, dt=torch.float32)
            if cfg.moe_bias:
                layers["we_gate_b"] = zeros(n, E, fm)
                layers["we_up_b"] = zeros(n, E, fm)
                layers["we_down_b"] = zeros(n, E, d)
        else:
            layers["w_gate"] = w(n, d, f)
            layers["w_up"] = w(n, d, f)
            layers["w_down"] = w(n, f, d)
        if cfg.qkv_bias:
            layers["bq"] = zeros(n, cfg.q_dim)
            layers["bk"] = zeros(n, cfg.kv_dim)
            layers["bv"] = zeros(n, cfg.kv_dim)
        if cfg.qk_norm:
            layers["q_norm"] = ones(n, cfg.head_dim)
            layers["k_norm"] = ones(n, cfg.head_dim)
        return layers

    kd = cfg.first_k_dense if cfg.is_moe else 0
    layers = stack(L - kd, cfg.is_moe)
    dense = stack(kd, False) if kd else None
    params: Params = {
        "embed": w(cfg.vocab_size, d, scale=0.02),
        "layers": layers,
        "final_norm": ones(d),
    }
    if dense is not None:
        params["dense_layers"] = dense
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


def apply_rope_interleaved(
    x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor
) -> torch.Tensor:
    """DeepSeek's decoupled rope: rotates (x[2i], x[2i+1]) pairs (HF
    modeling_deepseek_v2 through ``view_as_complex``), not rotate_half.
    x: [B, T, H, d], sin/cos [B, T, d/2]."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    sin = sin[:, :, None, :].to(x.dtype)
    cos = cos[:, :, None, :].to(x.dtype)
    return torch.stack(
        [x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1
    ).reshape(x.shape)


def mla_rope_params(cfg: ModelConfig) -> Tuple[torch.Tensor, float]:
    """(inv_freq [qk_rope_head_dim/2] fp32, attention_factor) of MLA's
    rope part: YaRN over ``qk_rope_head_dim`` when the config ships it
    (its factor rides sin and cos), else the plain table."""
    rs = cfg.rope_scaling or {}
    if (rs.get("rope_type") or rs.get("type")) == "yarn":
        return yarn_inv_freq(cfg.rope_theta, cfg.qk_rope_head_dim, rs)
    return _inv_freq(cfg.rope_theta, cfg.qk_rope_head_dim), 1.0


def attn_scale(cfg: ModelConfig) -> float:
    """The softmax scale: ``1/sqrt(head_dim)``, and for MLA under YaRN
    with ``mscale_all_dim`` times ``yarn_get_mscale(factor,
    mscale_all_dim)²`` (HF DeepseekV2Attention; ~1.59 at
    deepseek-v2-lite's config, whose sin/cos factor is 1)."""
    scale = 1.0 / math.sqrt(cfg.head_dim)
    rs = cfg.rope_scaling or {}
    if cfg.is_mla and (
        (rs.get("rope_type") or rs.get("type")) == "yarn"
        and rs.get("mscale_all_dim")
    ):
        m = yarn_get_mscale(float(rs["factor"]), float(rs["mscale_all_dim"]))
        scale = scale * m * m
    return scale


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


# Transients of one MoE token chunk: g, u and h, each [tokens, E, Fm] in
# the compute dtype. At qwen3-30b-a3b widths (E 128, Fm 768, bf16) that is
# 576 KiB a token: a 2048-token prefill is one chunk, an 8 x 2048
# embedding batch five.
MOE_CHUNK_BYTES = 2 << 30


def moe_route(
    x: torch.Tensor,            # [N, D]
    router_w: torch.Tensor,     # [D, E]
    cfg: ModelConfig,
    router_bias: Optional[torch.Tensor] = None,   # [E] fp32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The router of :func:`_moe_mlp`, in fp32 (a top-k pick must not flip
    on bf16 rounding): ``(top_idx [N, k], combine [N, E] fp32)``, the
    combine weights zero off each token's picks. Scorings as in JAX:
    ``softmax`` (then ``norm_topk_prob``), ``sigmoid`` (the selection adds
    ``router_bias``, the weights are the raw scores) and ``softmax_topk``
    (an affine router; softmax over the selected logits)."""
    k = cfg.num_experts_per_tok
    logits = x.float() @ router_w.float()
    if cfg.moe_scoring == "sigmoid":
        scores = torch.sigmoid(logits)
        sel = scores if router_bias is None else scores + router_bias
        top_idx = torch.topk(sel, k, dim=-1).indices
        top_w = torch.gather(scores, -1, top_idx)
    elif cfg.moe_scoring == "softmax_topk":
        if router_bias is not None:
            logits = logits + router_bias.float()
        top_v, top_idx = torch.topk(logits, k, dim=-1)
        top_w = torch.softmax(top_v, dim=-1)
    else:
        top_w, top_idx = torch.topk(torch.softmax(logits, dim=-1), k, dim=-1)
    if cfg.norm_topk_prob and cfg.moe_scoring != "softmax_topk":
        top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    return top_idx, torch.zeros_like(logits).scatter_(-1, top_idx, top_w)


def _moe_mlp(
    x: torch.Tensor,            # [B, T, D]
    router_w: torch.Tensor,     # [D, E]
    we_gate: torch.Tensor,      # [E, D, Fm]
    we_up: torch.Tensor,        # [E, D, Fm]
    we_down: torch.Tensor,      # [E, Fm, D]
    cfg: ModelConfig,
    router_bias: Optional[torch.Tensor] = None,
    shared=None,                # (ws_gate, ws_up, ws_down, gate_w | None)
    biases=None,                # (bg [E, Fm], bu [E, Fm], bd [E, D])
    chunk_tokens: Optional[int] = None,
) -> torch.Tensor:
    """Top-k MoE with the JAX module's dense dispatch: every expert runs
    over every token and the router's top-k weights (zero elsewhere)
    combine the results; then ``routed_scaling_factor``, then the shared
    experts, ungated (DeepSeek) or gated by ``sigmoid(x @ g)`` (Qwen2-MoE).
    ``moe_act="gptoss"`` is GPT-OSS's clamped GLU, with its expert biases.

    On the card:

    - the gate and up products are ``bmm`` over the expert axis with x
      expanded (batch stride 0), so x is read in place and never copied
      into an ``[E, tokens, D]`` tensor;
    - the combine weights fold into ``h`` before the down product, which
      becomes one ``[tokens, E·Fm] @ [E·Fm, D]`` product: the
      ``[tokens, E, D]`` expert outputs never exist. In bf16 this rounds
      ``h·c`` where JAX rounds each expert's output before the weighted
      sum (``PERF.md`` §6 states the tolerance); in fp32 the two differ
      only in summation order;
    - tokens run in chunks of ``chunk_tokens`` (default: as many as keep
      g, u and h within ``MOE_CHUNK_BYTES``). A chunk changes no value
      beyond the summation order of products with fewer rows.
    """
    if not isinstance(we_gate, torch.Tensor):
        raise NotImplementedError(
            "int8 expert weights are not ported yet (ROADMAP 'Modules to "
            "port': int8 MoE, a batched-over-experts W8A16 variant)"
        )
    B, T, D = x.shape
    E, _, Fm = we_gate.shape
    dtype = x.dtype
    xt = x.reshape(B * T, D)
    N = xt.shape[0]
    if chunk_tokens is None:
        chunk_tokens = max(1, MOE_CHUNK_BYTES // (3 * E * Fm * x.element_size()))
    w_down = we_down.reshape(E * Fm, D)
    out = torch.empty_like(xt)
    for s in range(0, N, chunk_tokens):
        xc = xt[s:s + chunk_tokens]
        n = xc.shape[0]
        _, combine = moe_route(xc, router_w, cfg, router_bias)
        combine = combine.to(dtype)
        xe = xc.expand(E, n, D)
        g = torch.bmm(xe, we_gate)                  # [E, n, Fm]
        u = torch.bmm(xe, we_up)
        if biases is not None:
            g += biases[0][:, None, :].to(dtype)
            u += biases[1][:, None, :].to(dtype)
        h = torch.empty((n, E, Fm), dtype=dtype, device=x.device)
        if cfg.moe_act == "gptoss":
            g.clamp_(max=7.0)
            u.clamp_(-7.0, 7.0).add_(1.0)
            torch.mul(u, g * torch.sigmoid(1.702 * g), out=h.transpose(0, 1))
        else:
            torch.mul(
                torch.nn.functional.silu(g, inplace=True), u,
                out=h.transpose(0, 1),
            )
        del g, u
        h *= combine[:, :, None]
        o = h.reshape(n, E * Fm) @ w_down
        if biases is not None:
            o += combine @ biases[2].to(dtype)
        out[s:s + n] = o
    if cfg.routed_scaling_factor != 1.0:
        # the factor in the compute dtype first, as JAX's asarray does
        out = out * torch.tensor(cfg.routed_scaling_factor, dtype=dtype).item()
    if shared is not None:
        ws_gate, ws_up, ws_down, gate_w = shared
        sh = _mm(
            torch.nn.functional.silu(_mm(xt, ws_gate)) * _mm(xt, ws_up),
            ws_down,
        )
        if gate_w is not None:
            sh = sh * torch.sigmoid(_mm(xt, gate_w))
        out = out + sh
    return out.reshape(B, T, D)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _mla_qkv(h, lp, i, cfg: ModelConfig, sin, cos):
    """MLA served decompressed (the JAX module's ``is_mla`` branch): q
    through ``wq`` or ``wq_a`` → ``q_a_norm`` → ``wq_b``; ``wkv_a`` splits
    into the latent ``c_kv`` (normed, then expanded per head by
    ``wkv_b`` into ``k_nope`` and ``v``) and ``k_pe``, rotated once and
    shared by every head. Returns q, k, v ``[B, T, H, head_dim]``: K is
    ``[k_nope, k_pe]`` and V zero-padded to ``head_dim``, both real
    tensors (the cache write and the kernel's TMA maps, which refuse a
    stride of 0, read them as they are)."""
    B, T, _ = h.shape
    H, hd, r = cfg.num_heads, cfg.head_dim, cfg.kv_lora_rank
    nope, vd = cfg.qk_nope_head_dim, cfg.v_head_dim
    if cfg.q_lora_rank:
        q_c = rms_norm(_mm(h, lp["wq_a"][i]), lp["q_a_norm"][i],
                       cfg.rms_norm_eps)
        q = _mm(q_c, lp["wq_b"][i])
    else:
        q = _mm(h, lp["wq"][i])
    q = q.reshape(B, T, H, hd)
    kv_a = _mm(h, lp["wkv_a"][i])
    c_kv = rms_norm(kv_a[..., :r], lp["kv_a_norm"][i], cfg.rms_norm_eps)
    kv = _mm(c_kv, lp["wkv_b"][i]).reshape(B, T, H, nope + vd)
    q_pe = apply_rope_interleaved(q[..., nope:], sin, cos)
    k_pe = apply_rope_interleaved(kv_a[:, :, None, r:], sin, cos)
    q = torch.cat([q[..., :nope], q_pe], dim=-1)
    k = torch.cat([kv[..., :nope], k_pe.expand(B, T, H, hd - nope)], dim=-1)
    v = torch.nn.functional.pad(kv[..., nope:], (0, hd - vd))
    return q, k, v


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
    # MLA rotates only its qk_rope part, with a table of its own
    inv, att_factor = mla_rope_params(cfg) if cfg.is_mla else rope_params(cfg)
    sin, cos = rope_sin_cos(positions, inv)
    if att_factor != 1.0:
        sin = sin * att_factor
        cos = cos * att_factor
    scale = attn_scale(cfg)
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

    # DeepSeek's first_k_dense layers are a stack of their own: the dense
    # stack runs first, then the MoE stack, over the cache's absolute
    # layer indices
    stacks = [(params["layers"], cfg.is_moe)]
    if "dense_layers" in params:
        stacks.insert(0, (params["dense_layers"], False))
    blocks = [
        (lp, i, moe) for lp, moe in stacks
        for i in range(lp["attn_norm"].shape[0])
    ]
    if len(blocks) != cfg.num_layers:
        raise ValueError(
            f"the tree holds {len(blocks)} layers, the config "
            f"{cfg.num_layers}"
        )
    for li, (lp, i, moe_layer) in enumerate(blocks):
        h = rms_norm(x, lp["attn_norm"][i], cfg.rms_norm_eps)
        if cfg.is_mla:
            q, k, v = _mla_qkv(h, lp, i, cfg, sin, cos)
        else:
            q = _mm(h, lp["wq"][i])
            k = _mm(h, lp["wk"][i])
            v = _mm(h, lp["wv"][i])
            if cfg.qkv_bias:
                q, k, v = q + lp["bq"][i], k + lp["bk"][i], v + lp["bv"][i]
            q = q.reshape(B, T, cfg.num_heads, cfg.head_dim)
            k = k.reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
            v = v.reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
            if cfg.qk_norm:
                q = rms_norm(q, lp["q_norm"][i], cfg.rms_norm_eps)
                k = rms_norm(k, lp["k_norm"][i], cfg.rms_norm_eps)
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
        if cfg.is_mla:
            # drop V's zero-padded tail before wo ([H * v_head_dim, d])
            attn = attn.reshape(B, T, cfg.num_heads, cfg.head_dim)[
                ..., :cfg.v_head_dim
            ].reshape(B, T, cfg.num_heads * cfg.v_head_dim)
        x = x + _mm(attn, lp["wo"][i])
        h2 = rms_norm(x, lp["mlp_norm"][i], cfg.rms_norm_eps)
        if moe_layer:
            x = x + _moe_mlp(
                h2, lp["router"][i], lp["we_gate"][i], lp["we_up"][i],
                lp["we_down"][i], cfg,
                router_bias=(
                    lp["router_bias"][i] if "router_bias" in lp else None
                ),
                shared=(
                    (
                        lp["ws_gate"][i], lp["ws_up"][i], lp["ws_down"][i],
                        lp["shared_gate"][i] if "shared_gate" in lp else None,
                    )
                    if "ws_gate" in lp else None
                ),
                biases=(
                    (lp["we_gate_b"][i], lp["we_up_b"][i],
                     lp["we_down_b"][i])
                    if cfg.moe_bias else None
                ),
            )
        else:
            g = _mm(h2, lp["w_gate"][i])
            u = _mm(h2, lp["w_up"][i])
            x = x + _mm(torch.nn.functional.silu(g) * u, lp["w_down"][i])

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
