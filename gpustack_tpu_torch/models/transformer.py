"""Transformer core, dense and MoE Llama/Qwen paths, DeepSeek's MLA and
the Gemma and GPT-OSS families, in PyTorch.

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
- MoE layers (Mixtral, Qwen2/3-MoE, GPT-OSS; :func:`_moe_mlp`) read only
  the experts their tokens picked: the (token, expert) pairs sorted by
  expert run through the grouped expert kernel (``ops.w8a16_grouped``
  for int8 experts, ``ops.bf16_grouped`` for bf16 ones), and the combine
  weights sum each token's k outputs. The values are the JAX module's
  dense dispatch (every expert over every token, zero weights off the
  picks) up to summation order: no capacity, no dropped token. Token
  chunks bound the transients;
- MLA (DeepSeek-V2/V3) is served decompressed, as in the JAX module: the
  latent projections are expanded to per-head K (``qk_nope + qk_rope``
  wide, the rope part rotated in interleaved pairs and shared by the
  heads) and V (zero-padded to the same width), so the cache layout and
  the flash kernel are every family's. DeepSeek's ``first_k_dense``
  layers are a stack of their own (``params["dense_layers"]``) that runs
  before the MoE stack over the cache's first layers;
- Gemma (1, 2, 3) and GPT-OSS: ``(1 + w)`` delta-gain norms, the scaled
  embedding, sandwich post-norms, the tanh GELU, ``query_pre_attn_scalar``,
  attention and final logit softcaps, learned attention sinks, sliding
  windows (every layer, or per layer by ``layer_sliding``, with Gemma3's
  local rope table on the sliding layers) and the attention output bias.

Prefill attention on the card is the hand-written flash kernel
(``ops/flash_attention.py``), and so is the cacheless embedding forward's,
for every configuration the JAX ``forward`` sends to its kernel: none with
a sliding window, an attention softcap or sinks (:func:`flash_eligible`).
Those, decode attention, and the speculative verify and draft ingest
blocks, are plain torch ops (:func:`_attend`, XLA in the JAX module, not
Pallas), in query-row chunks that bound the fp32 score tensor.
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


def flash_eligible(cfg: ModelConfig) -> bool:
    """Whether a prefill of ``cfg`` may run the flash kernel: the JAX
    ``forward``'s own condition (no sliding window, no attention softcap,
    no sinks). Every other prefill is :func:`_attend`, as in JAX."""
    return not (
        cfg.sliding_window or cfg.attn_logit_softcap or cfg.attn_sinks
    )


def local_heads(cfg: ModelConfig, tp: int = 1) -> Tuple[int, int]:
    """(query heads, KV heads) one ``tp`` rank holds: ``H / tp`` and
    ``Hkv / tp``, or one whole KV head where ``tp`` is above ``Hkv`` (its
    query heads all read it)."""
    return cfg.num_heads // tp, max(1, cfg.num_kv_heads // tp)


def check_plan(cfg: ModelConfig, plan) -> None:
    """Refuse a mesh plan the sharded forward cannot run on ``cfg``:
    query heads, vocab and FFN width must divide over ``tp``; KV heads
    must divide over it or it over them; experts must divide over ``ep``
    and their width over ``tp``. Under ``sp`` the attention is the ring
    (:mod:`ops.ring_attention`), which takes no sliding window, softcap
    or sinks, as JAX's ``attn_impl="ring"`` refuses them."""
    tp, ep = plan.tp, plan.ep
    if plan.sp > 1:
        for what, hit in (("a sliding window", cfg.sliding_window),
                          ("an attention softcap", cfg.attn_logit_softcap),
                          ("attention sinks", cfg.attn_sinks)):
            if hit:
                raise ValueError(
                    f"plan {plan}: {cfg.name} has {what}, which the ring "
                    "attention of sp > 1 does not take"
                )
    need = [("query heads", cfg.num_heads, tp), ("vocab", cfg.vocab_size, tp)]
    if cfg.num_kv_heads % tp and tp % cfg.num_kv_heads:
        raise ValueError(
            f"plan {plan}: {cfg.name}'s {cfg.num_kv_heads} KV heads neither "
            f"divide over tp={tp} nor it over them"
        )
    if cfg.is_moe:
        need += [("experts", cfg.num_experts, ep),
                 ("expert width", cfg.moe_intermediate_size, tp)]
        if cfg.shared_expert_intermediate_size:
            need.append(("shared expert width",
                         cfg.shared_expert_intermediate_size, tp))
    if not cfg.is_moe or cfg.first_k_dense:
        need.append(("FFN width", cfg.intermediate_size, tp))
    for what, n, k in need:
        if n % k:
            raise ValueError(
                f"plan {plan}: {cfg.name}'s {what} ({n}) does not divide "
                f"over {k}"
            )


def check_kernel_shapes(
    cfg: ModelConfig, device, int8: bool, mesh=None
) -> None:
    """Refuse, before any weight is read, a config the card's kernels
    cannot serve (on the card only; the CPU's plain versions take any
    shape). A prefill that takes the flash kernel (``flash_eligible``)
    needs its head_dim in ``SUPPORTED_HEAD_DIMS``: there is no plain
    fallback on the card, so without this the engine would load the
    weights and die at its first prefill. With ``int8``, every ``QuantW``
    leaf that goes through the W8A16 kernel (all but the embedding, a
    gather) must have the shapes the kernel takes; the leaves' shapes come
    from an init on the ``meta`` device, which allocates nothing. With a
    multi-rank ``mesh`` the shapes are the rank's shard's: the kernel sees
    the local heads (flash's group at ``Hq / tp`` on ``Hkv / tp``) and
    each weight after its split."""
    if torch.device(device).type != "cuda":
        return
    from gpustack_tpu_torch.ops.flash_attention import SUPPORTED_HEAD_DIMS
    from gpustack_tpu_torch.ops.w8a16 import shape_refusal

    if flash_eligible(cfg) and cfg.head_dim not in SUPPORTED_HEAD_DIMS:
        raise ValueError(
            f"{cfg.name}: head_dim {cfg.head_dim} is not one the flash "
            f"kernel takes {SUPPORTED_HEAD_DIMS}, and on the card every "
            "prefill of this config runs it"
        )
    if not int8:
        return
    leaves = {}
    for name, node in init_params(
        cfg, torch.Generator(), device="meta", int8=True, mesh=mesh
    ).items():
        if isinstance(node, dict):       # a layer stack
            leaves.update({f"{name}/{k}": v for k, v in node.items()})
        else:
            leaves[name] = node
    for path, leaf in leaves.items():
        if isinstance(leaf, QuantW) and path != "embed":
            K, N = leaf.q.shape[-2:]
            refusal = shape_refusal(K, N)
            if refusal:
                raise ValueError(
                    f"{cfg.name}: int8 leaf {path} of shape "
                    f"{tuple(leaf.q.shape)}: {refusal}"
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


def _embed_lookup(
    embed, tokens: torch.Tensor, dtype, mesh=None
) -> torch.Tensor:
    """Embedding rows for ``tokens`` in ``dtype``; an int8 ``QuantW``
    table is gathered, widened and scaled per row (a gather, as in JAX).
    A vocab-sharded table (``tp`` > 1, spec ``P(tp, None)``) looks up the
    ids in its rank's range, zeros the rest, and sums over ``tp``."""
    if mesh is None or mesh.tp == 1:
        return _rows(embed, tokens, dtype)
    rows = embed.shape[0]
    local = tokens - mesh.tp_rank * rows
    inside = (local >= 0) & (local < rows)
    x = _rows(embed, local.clamp(0, rows - 1), dtype)
    return mesh.all_reduce_tp(x.masked_fill_(~inside[..., None], 0))


def _rows(embed, tokens: torch.Tensor, dtype) -> torch.Tensor:
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
        cfg: ModelConfig, batch: int, max_len: int, device: torch.device,
        tp: int = 1,
    ) -> "KVCache":
        """Zeros for ``batch`` rows of ``max_len``; under ``tp`` a rank's
        cache holds its own KV heads (``local_heads``)."""
        shape = (
            cfg.num_layers, batch, max_len, local_heads(cfg, tp)[1],
            cfg.head_dim,
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
    dtype: torch.dtype = torch.bfloat16, device=None, int8: bool = False,
    mesh=None,
) -> Params:
    """Random init with layer weights stacked on a leading [L] axis, drawn
    on ``device`` (the generator's device) from ``generator``. Same
    shapes and scales as the JAX ``init_params``; not the same numbers.
    Every stacked leaf is drawn one layer at a time (qwen3-30b-a3b's
    ``we_gate`` alone is 19.3 GB), so the peak is the tree itself plus
    one layer. With ``first_k_dense`` (DeepSeek) the first layers are a
    dense stack of their own, ``params["dense_layers"]``, and
    ``params["layers"]`` holds the MoE rest; each is drawn at its own
    depth (JAX draws every leaf at full depth and slices). Biases, sinks
    (fp32) and delta gains (Gemma: ``1 + w``, so zero is the unit gain)
    are zeros, as in JAX. With ``int8`` every leaf ``quantize_params``
    would quantize is drawn as int8 directly (``quant.draw_int8``, for the
    leaf's init scale): the tree of ``quantize_params(init_params(cfg))``
    without its bf16 detour (``quant.init_quantized_params``).

    With a multi-rank ``mesh`` (``parallel.mesh.Mesh``) the tree is this
    rank's shard: each layer of each leaf is drawn whole, in the one-card
    order, and cut by ``parallel.sharding.shard_leaf``, so a rank's tree
    is the slice of the one-card tree from the same seed, bit for bit."""
    from gpustack_tpu_torch.models.quant import draw_int8, quantizable

    device = torch.device(device) if device is not None else generator.device
    d, f, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    if mesh is not None and mesh.world > 1:
        from gpustack_tpu_torch.parallel.sharding import shard_leaf

        def cut(name, leaf, stacked):
            return shard_leaf(name, leaf, mesh, stacked=stacked,
                              kv_heads=cfg.num_kv_heads)
    else:
        def cut(name, leaf, stacked):
            return leaf

    def draw(name, shape, scale, stacked):
        if int8 and quantizable(name, cfg):
            return draw_int8(name, shape, scale, generator, device,
                             stacked=stacked)
        out = torch.randn(
            shape, generator=generator, dtype=dtype, device=device
        )
        return out.mul_(scale)

    def layers_of(name, n, layer_fn):
        """The stacked leaf of ``n`` layers, each ``cut(layer_fn())``."""
        first = cut(name, layer_fn(), False)

        def alloc(t):
            return torch.empty((n, *t.shape), dtype=t.dtype, device=t.device)

        if isinstance(first, QuantW):
            out = QuantW(q=alloc(first.q), s=alloc(first.s))
        else:
            out = alloc(first)
        for i in range(n):
            layer = first if i == 0 else cut(name, layer_fn(), False)
            if isinstance(out, QuantW):
                out.q[i].copy_(layer.q)
                out.s[i].copy_(layer.s)
            else:
                out[i].copy_(layer)
        return out

    def w(name, *shape, scale=None):
        """Stacked leaf ``[n, ...]``, one layer drawn at a time."""
        scale = scale if scale is not None else 1.0 / math.sqrt(shape[-2])
        return layers_of(
            name, shape[0], lambda: draw(name, shape[1:], scale, False)
        )

    def const(name, fill, *shape, dt=dtype):
        return cut(name, torch.full(shape, fill, dtype=dt, device=device),
                   True)

    def ones(name, *shape):
        return const(name, 1.0, *shape)

    def zeros(name, *shape, dt=dtype):
        return const(name, 0.0, *shape, dt=dt)

    # a norm's unit gain: 1, or a zero delta under norm_delta_gain
    gain = zeros if cfg.norm_delta_gain else ones

    def stack(n: int, moe: bool) -> Dict[str, torch.Tensor]:
        """The leaves of ``n`` stacked layers, with the MoE MLP or the
        dense one."""
        if cfg.is_mla:
            H, r = cfg.num_heads, cfg.kv_lora_rank
            layers: Dict[str, torch.Tensor] = {
                "attn_norm": ones("attn_norm", n, d),
                "wkv_a": w("wkv_a", n, d, r + cfg.qk_rope_head_dim),
                "kv_a_norm": ones("kv_a_norm", n, r),
                "wkv_b": w("wkv_b", n, r,
                           H * (cfg.qk_nope_head_dim + cfg.v_head_dim)),
                "wo": w("wo", n, H * cfg.v_head_dim, d),
                "mlp_norm": ones("mlp_norm", n, d),
            }
            if cfg.q_lora_rank:
                layers["wq_a"] = w("wq_a", n, d, cfg.q_lora_rank)
                layers["q_a_norm"] = ones("q_a_norm", n, cfg.q_lora_rank)
                layers["wq_b"] = w("wq_b", n, cfg.q_lora_rank,
                                   H * cfg.head_dim)
            else:
                layers["wq"] = w("wq", n, d, H * cfg.head_dim)
        else:
            layers = {
                "attn_norm": ones("attn_norm", n, d),
                "wq": w("wq", n, d, cfg.q_dim),
                "wk": w("wk", n, d, cfg.kv_dim),
                "wv": w("wv", n, d, cfg.kv_dim),
                "wo": w("wo", n, cfg.q_dim, d),
                "mlp_norm": ones("mlp_norm", n, d),
            }
        if moe:
            fm, E = cfg.moe_intermediate_size, cfg.num_experts
            layers["router"] = w("router", n, d, E)
            layers["we_gate"] = w("we_gate", n, E, d, fm)
            layers["we_up"] = w("we_up", n, E, d, fm)
            layers["we_down"] = w("we_down", n, E, fm, d)
            if cfg.shared_expert_intermediate_size:
                fs = cfg.shared_expert_intermediate_size
                layers["ws_gate"] = w("ws_gate", n, d, fs)
                layers["ws_up"] = w("ws_up", n, d, fs)
                layers["ws_down"] = w("ws_down", n, fs, d)
                if cfg.shared_expert_gated:
                    layers["shared_gate"] = w("shared_gate", n, d, 1)
            if cfg.moe_scoring in ("sigmoid", "softmax_topk"):
                # DeepSeek-V3 correction bias / GPT-OSS affine router, fp32
                layers["router_bias"] = zeros("router_bias", n, E,
                                              dt=torch.float32)
            if cfg.moe_bias:
                layers["we_gate_b"] = zeros("we_gate_b", n, E, fm)
                layers["we_up_b"] = zeros("we_up_b", n, E, fm)
                layers["we_down_b"] = zeros("we_down_b", n, E, d)
        else:
            layers["w_gate"] = w("w_gate", n, d, f)
            layers["w_up"] = w("w_up", n, d, f)
            layers["w_down"] = w("w_down", n, f, d)
        if cfg.qkv_bias:
            layers["bq"] = zeros("bq", n, cfg.q_dim)
            layers["bk"] = zeros("bk", n, cfg.kv_dim)
            layers["bv"] = zeros("bv", n, cfg.kv_dim)
        if cfg.o_bias:
            layers["bo"] = zeros("bo", n, d)
        if cfg.attn_sinks:
            layers["sinks"] = zeros("sinks", n, cfg.num_heads,
                                    dt=torch.float32)
        if cfg.norm_delta_gain:
            layers["attn_norm"] = gain("attn_norm", n, d)
            layers["mlp_norm"] = gain("mlp_norm", n, d)
        if cfg.qk_norm:
            layers["q_norm"] = gain("q_norm", n, cfg.head_dim)
            layers["k_norm"] = gain("k_norm", n, cfg.head_dim)
        if cfg.post_norms:
            layers["post_attn_norm"] = gain("post_attn_norm", n, d)
            layers["post_mlp_norm"] = gain("post_mlp_norm", n, d)
        return layers

    def top(name, *shape, scale=None):
        scale = scale if scale is not None else 1.0 / math.sqrt(shape[-2])
        return cut(name, draw(name, shape, scale, False), False)

    kd = cfg.first_k_dense if cfg.is_moe else 0
    layers = stack(L - kd, cfg.is_moe)
    dense = stack(kd, False) if kd else None
    params: Params = {
        "embed": top("embed", cfg.vocab_size, d, scale=0.02),
        "layers": layers,
        "final_norm": gain("final_norm", d),
    }
    if dense is not None:
        params["dense_layers"] = dense
    if not cfg.tie_word_embeddings:
        params["lm_head"] = top("lm_head", d, cfg.vocab_size)
    return params


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


def rms_norm(
    x: torch.Tensor, w: torch.Tensor, eps: float, delta_gain: bool = False
) -> torch.Tensor:
    """RMSNorm in fp32. The gain ``w`` multiplies after the downcast, or,
    with ``delta_gain`` (Gemma's convention: the stored weight is a delta
    on a unit gain), ``1 + w`` multiplies in fp32 before it."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    n = xf * torch.rsqrt(var + eps)
    if delta_gain:
        return (n * (1.0 + w.float())).to(x.dtype)
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
    """The softmax scale: ``1/sqrt(query_pre_attn_scalar or head_dim)``
    (Gemma2/3 ship the scalar), and for MLA under YaRN with
    ``mscale_all_dim`` times ``yarn_get_mscale(factor, mscale_all_dim)²``
    (HF DeepseekV2Attention; ~1.59 at deepseek-v2-lite's config, whose
    sin/cos factor is 1)."""
    scale = 1.0 / math.sqrt(cfg.query_pre_attn_scalar or cfg.head_dim)
    rs = cfg.rope_scaling or {}
    if cfg.is_mla and (
        (rs.get("rope_type") or rs.get("type")) == "yarn"
        and rs.get("mscale_all_dim")
    ):
        m = yarn_get_mscale(float(rs["factor"]), float(rs["mscale_all_dim"]))
        scale = scale * m * m
    return scale


# The fp32 scores of one query-row chunk of :func:`_attend`, [B, Hkv, G,
# rows, S]; the masked copy, the probabilities and their downcast add
# about as much again. At gpt-oss-20b's heads (64) an 8 x 2048 embedding
# batch holds 8.6 GB of scores: eight chunks of 256 rows.
ATTN_CHUNK_BYTES = 1 << 30


def _attend(
    q: torch.Tensor,       # [B, T, Hkv, G, hd]
    k: torch.Tensor,       # [B, S, Hkv, hd]
    v: torch.Tensor,       # [B, S, Hkv, hd]
    mask: torch.Tensor,    # [B, T, S] bool (True = attend)
    scale: float,
    softcap: float = 0.0,
    sinks: Optional[torch.Tensor] = None,   # [Hkv, G] sink logits
) -> torch.Tensor:
    """Grouped-query attention; fp32 softmax; returns [B, T, Hkv*G*hd].

    ``softcap`` (Gemma2) is ``softcap * tanh(s / softcap)`` on the scaled
    scores, before the mask. ``sinks`` (GPT-OSS) are learned per-head
    logits that join the softmax's fp32 max and its denominator only: the
    mass they take has no value row. Both as in the JAX ``_attend``.

    Query rows run in chunks of as many as keep the fp32 scores within
    ``ATTN_CHUNK_BYTES``. Each row's softmax is its own, so a chunk
    changes no value."""
    B, T, Hkv, G, _ = q.shape
    S = k.shape[1]
    chunk_rows = max(1, ATTN_CHUNK_BYTES // (B * Hkv * G * S * 4))
    if T <= chunk_rows:
        return _attend_rows(q, k, v, mask, scale, softcap, sinks)
    return torch.cat([
        _attend_rows(q[:, t:t + chunk_rows], k, v, mask[:, t:t + chunk_rows],
                     scale, softcap, sinks)
        for t in range(0, T, chunk_rows)
    ], dim=1)


def _attend_rows(q, k, v, mask, scale, softcap, sinks):
    """:func:`_attend` over one chunk of query rows."""
    scores = torch.einsum("bthgd,bshd->bhgts", q, k).float() * scale
    if softcap:
        scores = scores.div_(softcap).tanh_().mul_(softcap)
    scores = scores.masked_fill_(~mask[:, None, None, :, :], _NEG)
    if sinks is not None:
        sink = sinks.float()[None, :, :, None]              # [1, Hkv, G, 1]
        m = torch.maximum(scores.amax(dim=-1), sink)        # [B, Hkv, G, T]
        p = scores.sub_(m[..., None]).exp_()
        denom = p.sum(dim=-1) + torch.exp(sink - m)
        weights = p.div_(denom[..., None]).to(q.dtype)
    else:
        weights = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhgts,bshd->bthgd", weights, v)
    return out.reshape(out.shape[0], out.shape[1], -1)


# Transients of one MoE token chunk of n tokens and P = n·k pairs: the
# gathered x [P, D], g, u and h [P, Fm] and the outputs y [P, D], in the
# compute dtype. At qwen3-30b-a3b widths (top-8, Fm 768, d 2048, bf16) that
# is 100 KiB a token: a 2048-token prefill and an 8 x 2048 embedding batch
# are one chunk each; at mixtral-8x7b's (top-2, Fm 14336, d 4096) 200 KiB.
MOE_CHUNK_BYTES = 2 << 30


def moe_chunk_tokens(k: int, Fm: int, D: int, itemsize: int) -> int:
    """Tokens in one :func:`_moe_mlp` chunk of top-``k`` routing over
    experts of width ``Fm`` on ``D``: as many as keep its routed
    transients, k·(3·Fm + 2·D) values a token, within ``MOE_CHUNK_BYTES``."""
    return max(1, MOE_CHUNK_BYTES // (k * (3 * Fm + 2 * D) * itemsize))


def moe_dispatch(
    top_idx: torch.Tensor, E: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The routed order of one chunk's picks ``top_idx [n, k]``: ``(perm,
    offsets, inv)`` with ``perm [P]`` the pair indices (``t·k + j``) sorted
    by expert (stable, so each expert's rows keep token order and a run
    repeats bit for bit), ``offsets [E + 1]`` int32 the segments' bounds,
    ``inv [P]`` each pair's sorted row. Plain index ops with no host read
    of a device value (no ``bincount``, ``nonzero``, ``unique`` or
    ``.item()``), so the engine's dispatch never waits on the card; the
    segments' bounds are a search of the sorted experts, the fewest
    launches (a decode step runs this once per MoE layer)."""
    pairs = top_idx.flatten()
    P, dev = pairs.numel(), pairs.device
    experts, perm = torch.sort(pairs, stable=True)
    offsets = torch.searchsorted(
        experts, torch.arange(E + 1, device=dev), out_int32=True
    )
    inv = torch.empty_like(perm).scatter_(
        0, perm, torch.arange(P, device=dev)
    )
    return perm, offsets, inv


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
    mesh=None,
) -> torch.Tensor:
    """Top-k MoE, routed: each token through its own k experts, weighted
    by the router's top-k weights; then ``routed_scaling_factor``, then
    the shared experts, ungated (DeepSeek) or gated by ``sigmoid(x @ g)``
    (Qwen2-MoE). ``moe_act="gptoss"`` is GPT-OSS's clamped GLU, with its
    expert biases. The values are those of the JAX module's dense
    dispatch up to summation order: no capacity, no dropped token.

    Per token chunk (``chunk_tokens``, default :func:`moe_chunk_tokens`;
    a chunk changes no value): :func:`moe_dispatch` sorts the n·k
    (token, expert) pairs by expert; x is gathered into that order,
    ``[n·k, D]``; the gate, up and down products are each one grouped
    launch (``ops.w8a16_grouped`` over int8 ``QuantW`` experts,
    ``ops.bf16_grouped`` over bf16 ones: the kernel on the card, the
    plain version on the CPU) that reads only the experts with rows. Each
    pair's output is rounded to the compute dtype, as JAX rounds each
    expert's, and each token's k outputs are summed with its combine
    weights in one small product per token (fp32 accumulation, rounded
    once, as JAX's ``einsum`` over the experts).

    Expert parallelism (a ``mesh`` whose ``ep x tp`` group has more than
    one rank): the expert leaves are the rank's shard, its ``E / ep``
    experts at its ``tp`` slice of the expert width; the router is whole.
    The pairs are sorted over all E experts as above, and the grouped
    launches run over the local experts' segments only (their offsets,
    which lie in one run of the sorted pairs); each token's k outputs are
    summed in fp32 with the other pairs zeroed, the routed scaling and
    (on ``ep`` rank 0, since its ``tp`` partial is the same on every
    ``ep`` rank) the shared experts' partial added, and the sum reduced
    over ``ep x tp`` in one all-reduce before the one rounding: the JAX
    module's "local experts, then one psum", over routed pairs.
    """
    from gpustack_tpu_torch.ops import w8a16

    B, T, D = x.shape
    E_loc, _, Fm = we_gate.shape
    sharded = mesh is not None and mesh.moe_size > 1
    E = cfg.num_experts if sharded else E_loc
    e0 = mesh.ep_rank * E_loc if sharded else 0
    k = cfg.num_experts_per_tok
    dtype = x.dtype
    xt = x.reshape(B * T, D)
    N = xt.shape[0]
    if chunk_tokens is None:
        chunk_tokens = moe_chunk_tokens(k, Fm, D, x.element_size())
    if isinstance(we_gate, QuantW):
        def expert_mm(xs, w, offsets, rows):        # [P, K] -> [P, N]
            return w8a16.w8a16_grouped(xs, w.q, w.s, offsets, rows)
    else:
        expert_mm = w8a16.bf16_grouped
    out = torch.empty(
        xt.shape, dtype=torch.float32 if sharded else dtype, device=x.device
    )
    for s in range(0, N, chunk_tokens):
        xc = xt[s:s + chunk_tokens]
        n = xc.shape[0]
        top_idx, combine = moe_route(xc, router_w, cfg, router_bias)
        perm, offsets, inv = moe_dispatch(top_idx, E)
        # the combine weight of each pick, in the compute dtype as JAX's
        c = combine.gather(1, top_idx).to(dtype)
        if sharded:
            # the local experts' segments, as a tensor of its own (the
            # kernel takes a 16-byte aligned offsets array)
            offsets = offsets[e0:e0 + E_loc + 1].clone()
        xs = xc.index_select(0, perm // k)          # [P, D]
        g = expert_mm(xs, we_gate, offsets, n)      # [P, Fm]
        u = expert_mm(xs, we_up, offsets, n)
        del xs
        if biases is not None:
            e_sorted = top_idx.flatten().index_select(0, perm)
            if sharded:
                e_sorted = (e_sorted - e0).clamp_(0, E_loc - 1)
            g += biases[0].to(dtype).index_select(0, e_sorted)
            u += biases[1].to(dtype).index_select(0, e_sorted)
        if cfg.moe_act == "gptoss":
            # (u + 1) * (g * sigmoid(1.702 g)), JAX's order of roundings:
            # g, u and h are the only transients
            g.clamp_(max=7.0)
            u.clamp_(-7.0, 7.0).add_(1.0)
            h = torch.mul(g, 1.702).sigmoid_().mul_(g).mul_(u)
        else:
            h = torch.nn.functional.silu(g, inplace=True).mul_(u)
        del g, u
        y = expert_mm(h, we_down, offsets, n)       # [P, D], rounded per pair
        del h
        if biases is not None and (not sharded or mesh.tp_rank == 0):
            # once per expert: on one tp rank of its ep rank
            y += biases[2].to(dtype).index_select(0, e_sorted)
        if sharded:
            # rows of other ranks' experts were never written: zero them
            rows = torch.arange(y.shape[0], device=y.device)
            y.masked_fill_(((rows < offsets[0]) | (rows >= offsets[-1]))
                           [:, None], 0)
            mine = y.index_select(0, inv).view(n, k, D)
            out[s:s + n] = torch.bmm(
                c.float()[:, None, :], mine.float()
            )[:, 0]
            continue
        # the token sum (not an expert product): [1, k] @ [k, D] a token
        mine = y.index_select(0, inv).view(n, k, D)
        out[s:s + n] = torch.bmm(c[:, None, :], mine)[:, 0]
    if sharded:
        if cfg.routed_scaling_factor != 1.0:
            out *= torch.tensor(cfg.routed_scaling_factor, dtype=dtype).item()
        if shared is not None and mesh.ep_rank == 0:
            out += _shared_experts(xt, shared).float()
        return mesh.all_reduce_moe(out).to(dtype).reshape(B, T, D)
    if cfg.routed_scaling_factor != 1.0:
        # the factor in the compute dtype first, as JAX's asarray does
        out = out * torch.tensor(cfg.routed_scaling_factor, dtype=dtype).item()
    if shared is not None:
        out = out + _shared_experts(xt, shared)
    return out.reshape(B, T, D)


def _shared_experts(xt: torch.Tensor, shared) -> torch.Tensor:
    """The shared experts' output (under ``tp``, the rank's partial sum):
    ungated (DeepSeek) or gated by ``sigmoid(x @ g)`` (Qwen2-MoE)."""
    ws_gate, ws_up, ws_down, gate_w = shared
    sh = _mm(
        torch.nn.functional.silu(_mm(xt, ws_gate)) * _mm(xt, ws_up),
        ws_down,
    )
    if gate_w is not None:
        sh = sh * torch.sigmoid(_mm(xt, gate_w))
    return sh


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _mla_qkv(h, lp, i, cfg: ModelConfig, sin, cos, H: Optional[int] = None):
    """MLA served decompressed (the JAX module's ``is_mla`` branch): q
    through ``wq`` or ``wq_a`` → ``q_a_norm`` → ``wq_b``; ``wkv_a`` splits
    into the latent ``c_kv`` (normed, then expanded per head by
    ``wkv_b`` into ``k_nope`` and ``v``) and ``k_pe``, rotated once and
    shared by every head. Returns q, k, v ``[B, T, H, head_dim]``: K is
    ``[k_nope, k_pe]`` and V zero-padded to ``head_dim``, both real
    tensors (the cache write and the kernel's TMA maps, which refuse a
    stride of 0, read them as they are). ``H``: the heads this rank holds
    (``wq``/``wq_b`` and ``wkv_b`` split their head axis over ``tp``;
    default all of them)."""
    B, T, _ = h.shape
    H = H or cfg.num_heads
    hd, r = cfg.head_dim, cfg.kv_lora_rank
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
    embeds_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    mesh=None,
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
    ``"plain"`` uses :func:`_attend`; decode always does, and so does
    every prefill of a configuration the kernel does not serve
    (:func:`flash_eligible`: sliding windows, softcaps, sinks).

    ``clamp_writes`` gives the cache write the JAX module's
    ``dynamic_update_slice`` semantics: each row's block of ``T`` (its
    positions must be contiguous) lands at ``min(positions[:, 0], S - T)``.
    The runner's verify and ingest blocks use it, as the JAX runner relies
    on it for rows it has deactivated (a frozen position near the end);
    everywhere else a write past the cache is an error.

    ``embeds_override`` ``(embeds [B, T, D], mask [B, T] bool)`` splices
    vision embeddings into the prompt (``models/vlm.py``): rows under the
    mask take ``embeds`` in the compute dtype instead of the vocab row,
    before Gemma's embedding scale, as in JAX. Over a mesh it is spliced
    after the vocab-split lookup's all-reduce, so every ``tp`` rank holds
    the same rows; under ``attn_impl="ring"`` it covers the rank's own
    ``T`` tokens, as ``tokens`` does.

    ``mesh`` (``parallel.mesh.Mesh``, one rank of a multi-GPU replica):
    the Megatron forward on the rank's shard (``parallel.sharding``).
    ``wq``/``wk``/``wv`` and their biases are column-split, so attention
    runs on the rank's heads (the cache holds its KV heads); ``wo`` is
    row-split and its partial sums all-reduced over ``tp``, and only then
    is GPT-OSS's ``bo`` added, once. Gate and up are column-split, down
    row-split, then all-reduced. Sinks are taken at the rank's heads; MLA
    splits ``wq``/``wq_b`` and ``wkv_b`` by head. The embedding and the
    LM head are vocab-split (:func:`_embed_lookup`, :func:`lm_head`); an
    MoE layer runs its local experts (:func:`_moe_mlp`). Every rank
    computes the same activations between layers, and the same logits.

    Under a mesh with ``sp > 1`` (a sequence-parallel replica, as JAX's
    ``attn_impl="ring"``) the cache is this rank's segment of the
    sequence (``S_loc`` positions from ``sp_rank * S_loc``) and the
    attention is one of two (:mod:`ops.ring_attention`):
    ``attn_impl="ring"`` is a prefill from zero whose ``T`` tokens are
    this rank's contiguous block (``cache.max_len == T``, positions
    ``sp_rank * T + t``; every other layer runs on these tokens alone),
    written at the cache's rows ``0 .. T-1``; ``attn_impl="sp_cache"`` is
    every other step (decode, a verify or ingest block, a continuation
    chunk): the tokens are whole on every ``sp`` rank, only the rank that
    owns a position writes its K/V (a decode step's write, and with
    ``clamp_writes`` a ``[B, T]`` block's, is masked on the device after
    the global clamp; a chunk of ``T > 1``, all rows at ``q_offset``, is
    cut on the host), before the attention merges over the group, so a
    query sees its own block's keys on the next rank. Neither takes a
    sliding window, softcap or sinks (:func:`check_plan`).

    Returns ``(logits [B, T, vocab] fp32, cache or None)``, or the final
    normalized hidden states (fp32) with ``return_hidden``.
    """
    if attn_impl not in ("plain", "flash", "ring", "sp_cache"):
        raise ValueError(
            "attn_impl must be 'plain', 'flash', 'ring' or 'sp_cache': "
            f"{attn_impl!r}"
        )
    B, T = tokens.shape
    sp_attn = attn_impl in ("ring", "sp_cache")
    if sp_attn and (
        mesh is None or mesh.sp == 1 or cache is None
        or not flash_eligible(cfg)
    ):
        raise ValueError(
            f"attn_impl={attn_impl!r} needs a cache, a mesh with sp > 1, "
            "no sliding window, no attention softcap and no attention sinks"
        )
    if attn_impl == "ring" and cache.max_len != T:
        raise ValueError(
            f"a ring prefill writes its {T} tokens into a cache of {T} "
            f"rows, not {cache.max_len}"
        )
    dtype = torch_dtype(cfg)
    device = tokens.device
    tp = mesh.tp if mesh is not None else 1
    Hq, Hkv = local_heads(cfg, tp)
    G = Hq // Hkv
    h0 = mesh.tp_rank * Hq if mesh is not None else 0
    x = _embed_lookup(params["embed"], tokens, dtype, mesh)
    if embeds_override is not None:
        ov, ov_mask = embeds_override
        x = torch.where(ov_mask[..., None], ov.to(dtype), x)
    if cfg.embed_scale:
        # Gemma: times sqrt(d), cast to the compute dtype first (as HF
        # and JAX do)
        x = x * torch.tensor(math.sqrt(cfg.hidden_size)).to(dtype)
    # MLA rotates only its qk_rope part, with a table of its own
    inv, att_factor = mla_rope_params(cfg) if cfg.is_mla else rope_params(cfg)
    sin, cos = rope_sin_cos(positions, inv)
    if att_factor != 1.0:
        sin = sin * att_factor
        cos = cos * att_factor
    hetero = cfg.layer_sliding is not None
    if hetero and cfg.rope_local_theta:
        # Gemma3: sliding layers rotate with their own, unscaled theta
        sin_loc, cos_loc = rope_sin_cos(
            positions, _inv_freq(cfg.rope_local_theta, cfg.head_dim)
        )
    else:
        sin_loc, cos_loc = sin, cos
    scale = attn_scale(cfg)
    use_flash = attn_impl == "flash" and T > 1 and flash_eligible(cfg)

    if cache is None:
        if use_flash and positions.device.type == "cpu" and bool(
            (positions != torch.arange(T, device=device)).any()
        ):
            raise ValueError("cacheless flash rows must be at 0 .. T-1")
        key_pos = positions[:, None, :]
    elif attn_impl == "sp_cache":
        S = cache.max_len
        base = mesh.sp_rank * S                 # this rank's first position
        masked = T == 1 or clamp_writes
        if masked:
            # a decode step, or a verify/ingest block of contiguous
            # positions per row: each element is written by the rank whose
            # segment owns its position, the row's start first clamped
            # into the whole cache (JAX's dynamic_update_slice over
            # S * sp positions). T <= S consecutive rows are distinct
            # modulo S, so a non-owner writes back what its row already
            # holds and never lands on an owner's row.
            if T > S:
                raise ValueError(f"a block of {T} positions overflows a "
                                 f"rank's segment of {S}")
            start = positions[:, :1]
            if clamp_writes:
                start = start.clamp(0, S * mesh.sp - T)
            local = start - base + torch.arange(T, device=device)
            own = ((local >= 0) & (local < S))[..., None, None]
            write_pos = local.remainder(S)
            rows = torch.arange(B, device=device)[:, None]
        else:
            # a block at q_offset (host int): this rank's part of it
            lo = max(q_offset, base)
            hi = min(q_offset + T, base + S)
    elif attn_impl != "ring":               # a ring block writes rows 0..T-1
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
        key_pos = torch.arange(S, device=device)[None, None, :]
        rows = torch.arange(B, device=device)[:, None].expand(B, T)
    if sp_attn:
        from gpustack_tpu_torch.ops.ring_attention import (
            ring_attention,
            sp_cache_attention,
        )
    elif not use_flash:
        # mask[b, t, s]: query t attends key s. A sliding window keeps
        # the keys less than ``sliding_window`` behind the query; with
        # per-layer flags both masks exist and each layer takes its own
        causal = key_pos <= positions[:, :, None]
        mask_full = mask_slide = causal
        if cfg.sliding_window:
            mask_slide = causal & (
                positions[:, :, None] - key_pos < cfg.sliding_window
            )
            if not hetero:
                mask_full = mask_slide
    else:
        from gpustack_tpu_torch.ops.flash_attention import (
            flash_attention_prefill,
        )

    act = (
        torch.nn.functional.silu if cfg.hidden_act == "silu"
        else lambda z: torch.nn.functional.gelu(z, approximate="tanh")
    )
    delta = cfg.norm_delta_gain

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
        sliding = hetero and cfg.layer_sliding[li]
        sin_l, cos_l = (sin_loc, cos_loc) if sliding else (sin, cos)
        h = rms_norm(x, lp["attn_norm"][i], cfg.rms_norm_eps, delta)
        if cfg.is_mla:
            q, k, v = _mla_qkv(h, lp, i, cfg, sin, cos, Hq)
        else:
            q = _mm(h, lp["wq"][i])
            k = _mm(h, lp["wk"][i])
            v = _mm(h, lp["wv"][i])
            if cfg.qkv_bias:
                q, k, v = q + lp["bq"][i], k + lp["bk"][i], v + lp["bv"][i]
            q = q.reshape(B, T, Hq, cfg.head_dim)
            k = k.reshape(B, T, Hkv, cfg.head_dim)
            v = v.reshape(B, T, Hkv, cfg.head_dim)
            if cfg.qk_norm:
                q = rms_norm(q, lp["q_norm"][i], cfg.rms_norm_eps, delta)
                k = rms_norm(k, lp["k_norm"][i], cfg.rms_norm_eps, delta)
            q = apply_rope(q, sin_l, cos_l)
            k = apply_rope(k, sin_l, cos_l)
        qg = q.reshape(B, T, Hkv, G, cfg.head_dim)
        if not (use_flash or sp_attn):
            plain = dict(
                mask=mask_slide if sliding else mask_full, scale=scale,
                softcap=cfg.attn_logit_softcap,
                sinks=(
                    lp["sinks"][i][h0:h0 + Hq].reshape(Hkv, G)
                    if cfg.attn_sinks else None
                ),
            )
        if cache is None:
            if use_flash:
                attn = flash_attention_prefill(q, k, v, scale)
            else:
                attn = _attend(qg, k, v, **plain)
        elif attn_impl == "ring":
            # the rank's own block of a prefill from zero
            cache.k[li][:, :T] = k
            cache.v[li][:, :T] = v
            attn = ring_attention(q, k.to(cache.k.dtype),
                                  v.to(cache.v.dtype), scale, mesh)
        elif sp_attn:
            k_l, v_l = cache.k[li], cache.v[li]
            k, v = k.to(k_l.dtype), v.to(v_l.dtype)
            if masked:
                k_l[rows, write_pos] = torch.where(own, k, k_l[rows, write_pos])
                v_l[rows, write_pos] = torch.where(own, v, v_l[rows, write_pos])
            elif lo < hi:
                k_l[:, lo - base:hi - base] = k[:, lo - q_offset:hi - q_offset]
                v_l[:, lo - base:hi - base] = v[:, lo - q_offset:hi - q_offset]
            attn = sp_cache_attention(q, k_l, v_l, positions, scale, mesh)
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
                attn = _attend(qg, k_l, v_l, **plain)
        if cfg.is_mla:
            # drop V's zero-padded tail before wo ([H * v_head_dim, d])
            attn = attn.reshape(B, T, Hq, cfg.head_dim)[
                ..., :cfg.v_head_dim
            ].reshape(B, T, Hq * cfg.v_head_dim)
        attn_out = _mm(attn, lp["wo"][i])
        if mesh is not None:
            attn_out = mesh.all_reduce_tp(attn_out)
        if cfg.o_bias:
            attn_out = attn_out + lp["bo"][i]
        if cfg.post_norms:
            attn_out = rms_norm(
                attn_out, lp["post_attn_norm"][i], cfg.rms_norm_eps, delta
            )
        x = x + attn_out
        h2 = rms_norm(x, lp["mlp_norm"][i], cfg.rms_norm_eps, delta)
        if moe_layer:
            mlp = _moe_mlp(
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
                mesh=mesh,
            )
        else:
            g = _mm(h2, lp["w_gate"][i])
            u = _mm(h2, lp["w_up"][i])
            mlp = _mm(act(g) * u, lp["w_down"][i])
            if mesh is not None:
                mlp = mesh.all_reduce_tp(mlp)
        if cfg.post_norms:
            mlp = rms_norm(
                mlp, lp["post_mlp_norm"][i], cfg.rms_norm_eps, delta
            )
        x = x + mlp

    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps, delta)
    if return_hidden:
        return x.float(), cache
    return lm_head(params, cfg, x, mesh), cache


def lm_head(
    params: Params, cfg: ModelConfig, x: torch.Tensor, mesh=None
) -> torch.Tensor:
    """Final-normed hidden states (compute dtype) → fp32 logits: the tied
    embedding's transpose or ``lm_head``, then Gemma2's final softcap
    ``cap * tanh(logits / cap)`` in fp32. Under ``tp`` both are
    vocab-split: each rank's logits are gathered over ``tp``."""
    x = x.to(torch_dtype(cfg))
    if cfg.tie_word_embeddings:
        logits = _mm(x, params["embed"].T).float()
    else:
        logits = _mm(x, params["lm_head"]).float()
    if mesh is not None:
        logits = mesh.all_gather_tp(logits)
    if cfg.final_logit_softcap:
        cap = cfg.final_logit_softcap
        logits = cap * torch.tanh(logits / cap)
    return logits
