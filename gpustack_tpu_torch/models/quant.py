"""Int8 weight-only quantization for the transformer.

The port of ``gpustack_tpu/models/quant.py``. Weights are stored as int8
with per-output-channel bf16 scales (``QuantW``), which halves the bytes a
decode step reads against bf16. The JAX package contracts ``x @
q.astype(bf16) * s`` and leaves the convert to XLA's fusion; eager PyTorch
cannot fuse it, so on the card every int8 weight product goes through the
hand-written W8A16 kernel (``ops/w8a16.py``), which widens the int8 values
in registers: the dequantized weight never reaches device memory.

Scale layout (as in JAX): for each weight the scales live on the *output*
(non-contracted) dims, so the rescale multiplies the product's result.

The trees, rounding (half to even), clip (±127) and bf16 scale bits are
the JAX package's: both give identical ``q`` and ``s`` on the same fp32
tree, and their npz checkpoints load in either package.

Sharded specs (``quant_pspecs``) wait for the multi-GPU slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch

from gpustack_tpu_torch.models.config import ModelConfig


@dataclasses.dataclass
class QuantW:
    """An int8-quantized weight: ``q`` int8, ``s`` bf16 per-output-channel
    scale."""

    q: torch.Tensor
    s: torch.Tensor

    @property
    def shape(self):
        return self.q.shape

    def __getitem__(self, i) -> "QuantW":
        """A view along the leading axis (one layer of a stacked weight,
        ``lp["wq"][li]``), so code indexes plain and quantized leaves
        alike."""
        return QuantW(q=self.q[i], s=self.s[i])

    def to(self, device) -> "QuantW":
        """Both tensors on ``device``, as they are (never widened)."""
        return QuantW(q=self.q.to(device), s=self.s.to(device))


# Which axes of each (per-layer-sliced) weight are contracted in its
# matmul. Scales span the remaining (output) axes. Leaves not listed stay
# unquantized (norm gains, biases, the router).
_CONTRACT_AXES: Dict[str, tuple] = {
    "embed": (1,),      # gather: scale per vocab row
    "lm_head": (0,),    # [d, v] contracts d
    "wq": (0,), "wk": (0,), "wv": (0,),   # [d, out] contract d
    "wo": (0,),                            # [q, d] contracts q
    "w_gate": (0,), "w_up": (0,),          # [d, f] contract d
    "w_down": (0,),                        # [f, d] contracts f
    "we_gate": (1,), "we_up": (1,),        # [E, d, f] contract d
    "we_down": (1,),                       # [E, f, d] contract f
    "wq_a": (0,), "wq_b": (0,),
    "wkv_a": (0,), "wkv_b": (0,),
    "ws_gate": (0,), "ws_up": (0,), "ws_down": (0,),
}
# Layer-stacked leaves carry a leading [L] axis not present at use time.
_STACKED = {
    "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
    "we_gate", "we_up", "we_down",
    "wq_a", "wq_b", "wkv_a", "wkv_b",
    "ws_gate", "ws_up", "ws_down",
}


def _axes(name: str, stacked: Optional[bool] = None) -> tuple:
    axes = _CONTRACT_AXES[name]
    if stacked if stacked is not None else name in _STACKED:
        axes = tuple(a + 1 for a in axes)
    return axes


def _quantize_leaf(name: str, w: torch.Tensor) -> QuantW:
    axes = _axes(name)
    wf = w.float()
    absmax = wf.abs().amax(dim=axes, keepdim=True)
    scale = absmax.clamp_min(1e-8) / 127.0
    q = torch.round(wf / scale).clamp(-127, 127).to(torch.int8)
    return QuantW(q=q, s=scale.squeeze(axes).to(torch.bfloat16))


def check_quantizable(cfg: ModelConfig) -> None:
    """Raise for a configuration int8 serving does not cover yet: an MoE
    model's expert products (GPT-OSS's among them) need a
    batched-over-experts W8A16 variant, and MLA's projections (``wq_a``,
    ``wq_b``, ``wkv_a``, ``wkv_b``) wait with them (DeepSeek is MoE).
    Called before any weight is drawn or read."""
    missing = []
    if cfg.is_moe:
        missing.append("MoE")
    if cfg.is_mla:
        missing.append("MLA's projections (wq_a, wq_b, wkv_a, wkv_b)")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: int8 with {' and '.join(missing)} is not ported "
            "yet (ROADMAP 'Modules to port': int8 MoE, a "
            "batched-over-experts W8A16 variant; MLA's int8 leaves wait "
            "with it)"
        )


def quantize_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """Quantize all large weights of a transformer param tree to int8.

    Tied-embedding models keep ``embed`` unquantized (the transpose reuse
    would need a second scale layout)."""
    out: Dict[str, Any] = {}
    tie = "lm_head" not in params
    for k, v in params.items():
        if k in ("layers", "dense_layers"):
            out[k] = {
                lk: _quantize_leaf(lk, lv) if lk in _CONTRACT_AXES else lv
                for lk, lv in v.items()
            }
        elif k in _CONTRACT_AXES and not (k == "embed" and tie):
            out[k] = _quantize_leaf(k, v)
        else:
            out[k] = v
    return out


def init_quantized_params(
    cfg: ModelConfig, seed: int = 0, device=None
) -> Dict[str, Any]:
    """Random int8 params drawn *directly* on ``device`` (default: the
    card) from a ``torch.Generator`` seeded with ``seed``: no bf16 detour
    (16 GB at llama3-8b). The tree, shapes, dtypes and scales (3 /
    sqrt(fan_in) / 127, bf16) are those of the JAX
    ``init_quantized_params``; the numbers are not.

    The int8 values are round(N(0, 1) * 127 / 3) clipped to ±127: the
    statistics of an absmax-quantized normal init (weight std 1 /
    sqrt(fan_in), as ``init_params``), which the JAX docstring names as
    its target. Its uniform draw over [-127, 127] gives weights 1.73x
    wider, and at llama3-8b's depth that model amplifies a change of fp32
    summation order past a 5% logit check (PERF.md, PR 4)."""
    from gpustack_tpu_torch.device import resolve_device

    check_quantizable(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    d, f, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    bf16 = torch.bfloat16

    def qw(shape, fan_in, name):
        q = torch.empty(shape, dtype=torch.int8, device=device)
        rows = q.view(-1, shape[-1])
        step = max(1, (1 << 26) // shape[-1])    # <= 256 MB of fp32 a draw
        for r in range(0, rows.shape[0], step):
            block = rows[r:r + step]
            draw = torch.randn(
                block.shape, generator=gen, dtype=torch.float32,
                device=device,
            )
            block.copy_(draw.mul_(127.0 / 3.0).round_().clamp_(-127, 127))
        axes = _axes(name)
        s_shape = tuple(n for i, n in enumerate(shape) if i not in axes)
        # fp32 first, then bf16: the JAX package's rounding of the scale
        s = torch.full(
            s_shape, 3.0 / math.sqrt(fan_in) / 127.0, dtype=torch.float32,
            device=device,
        ).to(bf16)
        return QuantW(q=q, s=s)

    def ones(*shape):
        return torch.ones(shape, dtype=bf16, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=bf16, device=device)

    gain = zeros if cfg.norm_delta_gain else ones    # Gemma: delta gains
    layers: Dict[str, Any] = {
        "attn_norm": gain(L, d),
        "mlp_norm": gain(L, d),
        "wq": qw((L, d, cfg.q_dim), d, "wq"),
        "wk": qw((L, d, cfg.kv_dim), d, "wk"),
        "wv": qw((L, d, cfg.kv_dim), d, "wv"),
        "wo": qw((L, cfg.q_dim, d), cfg.q_dim, "wo"),
    }
    if cfg.qkv_bias:
        layers["bq"] = zeros(L, cfg.q_dim)
        layers["bk"] = zeros(L, cfg.kv_dim)
        layers["bv"] = zeros(L, cfg.kv_dim)
    if cfg.qk_norm:
        layers["q_norm"] = gain(L, cfg.head_dim)
        layers["k_norm"] = gain(L, cfg.head_dim)
    if cfg.post_norms:
        layers["post_attn_norm"] = gain(L, d)
        layers["post_mlp_norm"] = gain(L, d)
    layers["w_gate"] = qw((L, d, f), d, "w_gate")
    layers["w_up"] = qw((L, d, f), d, "w_up")
    layers["w_down"] = qw((L, f, d), f, "w_down")

    params: Dict[str, Any] = {"layers": layers, "final_norm": gain(d)}
    if cfg.tie_word_embeddings:
        # the LM head contracts embed.T: embed stays bf16, as in
        # quantize_params' tied-embedding rule
        params["embed"] = (
            torch.randn(
                (cfg.vocab_size, d), generator=gen, dtype=torch.float32,
                device=device,
            ) * 0.02
        ).to(bf16)
    else:
        params["embed"] = qw((cfg.vocab_size, d), 2500, "embed")  # ~0.02
        params["lm_head"] = qw((d, cfg.vocab_size), d, "lm_head")
    return params


def dequantize(
    name: str, w, stacked: Optional[bool] = None
) -> torch.Tensor:
    """Reference dequantization (tests / debugging), in bf16 as in JAX.
    ``name`` identifies the weight's contraction layout; ``stacked``
    overrides the [L]-axis default (False for a per-layer slice)."""
    if not isinstance(w, QuantW):
        return w
    s = w.s
    for a in _axes(name, stacked):
        s = s.unsqueeze(a)
    return w.q.to(torch.bfloat16) * s
