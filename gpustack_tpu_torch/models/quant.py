"""Int8 weight-only quantization for the transformer.

The port of ``gpustack_tpu/models/quant.py``. Weights are stored as int8
with per-output-channel bf16 scales (``QuantW``), which halves the bytes a
decode step reads against bf16. The JAX package contracts ``x @
q.astype(bf16) * s`` and leaves the convert to XLA's fusion; eager PyTorch
cannot fuse it, so on the card every int8 weight product goes through the
hand-written W8A16 kernel (``ops/w8a16.py``; an MoE layer's expert
products grouped over the experts its tokens picked), which widens the int8 values in
registers or shared memory: the dequantized weight never reaches device
memory.

Scale layout (as in JAX): for each weight the scales live on the *output*
(non-contracted) dims, so the rescale multiplies the product's result.

The trees, rounding (half to even), clip (±127) and bf16 scale bits are
the JAX package's: both give identical ``q`` and ``s`` on the same fp32
tree, and their npz checkpoints load in either package.

Sharded specs (:func:`quant_spec`, :func:`quant_pspecs`): ``q`` splits
as its weight does, ``s`` only along the weight's output axes. Unlike the
JAX ``quant_pspecs``, which adapts ``layers`` only, they cover DeepSeek's
``dense_layers`` stack too.
"""

from __future__ import annotations

import dataclasses
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


def _quantize_one(w: torch.Tensor, axes: tuple):
    """(q, s) of one weight: absmax over the contracted ``axes`` in fp32,
    round half to even, clip to ±127, the scale to bf16 (JAX's steps)."""
    wf = w.float()
    absmax = wf.abs().amax(dim=axes, keepdim=True)
    scale = absmax.clamp_min(1e-8) / 127.0
    q = torch.round(wf / scale).clamp(-127, 127).to(torch.int8)
    return q, scale.squeeze(axes).to(torch.bfloat16)


def _quantize_leaf(name: str, w: torch.Tensor) -> QuantW:
    """A layer-stacked leaf is quantized one layer at a time into the int8
    and scale tensors, so the fp32 copy is one layer's: a loaded
    qwen3-30b-a3b's ``we_gate`` whole would be 38.6 GB of fp32. Each
    layer's scales span only its own values (the contracted axes never
    include the layer axis), so the bits are the whole leaf's."""
    if name not in _STACKED:
        q, s = _quantize_one(w, _axes(name))
        return QuantW(q=q, s=s)
    axes = _axes(name, stacked=False)
    s_shape = tuple(n for i, n in enumerate(w.shape[1:]) if i not in axes)
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    s = torch.empty((w.shape[0], *s_shape), dtype=torch.bfloat16,
                    device=w.device)
    for layer in range(w.shape[0]):
        q[layer], s[layer] = _quantize_one(w[layer], axes)
    return QuantW(q=q, s=s)


def quantizable(name: str, cfg: ModelConfig) -> bool:
    """Whether ``quantize_params`` turns leaf ``name`` into a ``QuantW``:
    every leaf with contracted axes, but a tied embedding (the LM head
    contracts its transpose, which would need a second scale layout)."""
    return name in _CONTRACT_AXES and not (
        name == "embed" and cfg.tie_word_embeddings
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


def quant_spec(name: str, spec, stacked: bool = True):
    """``(q_spec, s_spec)`` of int8 leaf ``name`` under the weight's spec
    (a ``parallel.sharding.PSpec``): ``q`` keeps it, ``s`` keeps the
    entries of the output (non-contracted) axes."""
    axes = _axes(name, stacked)
    return spec, type(spec)(*(a for i, a in enumerate(spec) if i not in axes))


def quant_pspecs(specs: Dict[str, Any], params: Dict[str, Any]):
    """Adapt a spec tree (``SpecLayout.params``) to a quantized param
    tree: each ``QuantW`` leaf's spec becomes ``QuantW(q=..., s=...)`` by
    :func:`quant_spec`, in ``layers`` and ``dense_layers`` alike."""

    def adapt(name, spec, leaf, stacked):
        if not isinstance(leaf, QuantW):
            return spec
        q, s = quant_spec(name, spec, stacked)
        return QuantW(q=q, s=s)

    out: Dict[str, Any] = {}
    for k, v in params.items():
        if k in ("layers", "dense_layers"):
            out[k] = {
                lk: adapt(lk, specs[k][lk], lv, True) for lk, lv in v.items()
            }
        else:
            out[k] = adapt(k, specs[k], v, False)
    return out


def draw_int8(
    name: str, shape: tuple, std: float, generator: torch.Generator, device,
    stacked: Optional[bool] = None,
) -> QuantW:
    """Random int8 leaf ``name`` of ``shape`` drawn on ``device``, for a
    weight of init ``std``: the int8 values round(N(0, 1) * 127 / 3)
    clipped to ±127 (the statistics of an absmax-quantized normal init;
    fp32 draws of <= 256 MB at a time), the scales 3 * std / 127 in bf16.
    ``stacked`` False: ``shape`` is one layer of a stacked leaf."""
    q = torch.empty(shape, dtype=torch.int8, device=device)
    rows = q.view(-1, shape[-1])
    step = max(1, (1 << 26) // shape[-1])
    for r in range(0, rows.shape[0], step):
        block = rows[r:r + step]
        draw = torch.randn(
            block.shape, generator=generator, dtype=torch.float32,
            device=device,
        )
        block.copy_(draw.mul_(127.0 / 3.0).round_().clamp_(-127, 127))
    axes = _axes(name, stacked)
    s_shape = tuple(n for i, n in enumerate(shape) if i not in axes)
    # fp32 first, then bf16: the JAX package's rounding of the scale
    s = torch.full(
        s_shape, 3.0 * std / 127.0, dtype=torch.float32, device=device
    ).to(torch.bfloat16)
    return QuantW(q=q, s=s)


def init_quantized_params(
    cfg: ModelConfig, seed: int = 0, device=None, mesh=None,
) -> Dict[str, Any]:
    """Random int8 params drawn *directly* on ``device`` (default: the
    card) from a ``torch.Generator`` seeded with ``seed``: no bf16 detour
    (16 GB at llama3-8b, 93 GB at mixtral-8x7b). Every family: the tree,
    shapes and dtypes are those of ``quantize_params(init_params(cfg))``
    (MoE experts, routers and biases, MLA's projections, shared experts,
    DeepSeek's ``dense_layers``), each leaf ``quantize_params`` would
    quantize drawn by :func:`draw_int8` (``transformer.init_params(...,
    int8=True)``), the rest as ``init_params`` draws them. The numbers are
    not JAX's.

    The int8 values are round(N(0, 1) * 127 / 3): the statistics of an
    absmax-quantized normal init (weight std 1 / sqrt(fan_in), as
    ``init_params``), which the JAX ``init_quantized_params`` docstring
    names as its target. Its uniform draw over [-127, 127] gives weights
    1.73x wider, and at llama3-8b's depth that model amplifies a change
    of fp32 summation order past a 5% logit check (PERF.md §6).

    With a multi-rank ``mesh`` (``parallel.mesh.Mesh``) the tree is this
    rank's shard: each leaf drawn whole, a layer at a time, and cut
    (``transformer.init_params``), so it equals the slice of the one-card
    tree from the same seed bit for bit."""
    from gpustack_tpu_torch.device import resolve_device
    from gpustack_tpu_torch.models.transformer import init_params

    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return init_params(cfg, gen, torch.bfloat16, device, int8=True,
                       mesh=mesh)


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
