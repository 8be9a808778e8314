"""Sharding rules for the transformer's params, KV cache and slot state.

The port of ``gpustack_tpu/parallel/sharding.py``: :class:`SpecLayout`
holds the same rule table (``layer_rules``), the same specs for the cache,
the slot state and the activations, and the same ``describe()``, which
the engine serves on ``/healthz`` as ``layout``. A spec (:class:`PSpec`)
is read as JAX's ``PartitionSpec``: entry d names the mesh axis that dim d
of the leaf splits over, or ``None`` for a whole dim. Inference mode:
Megatron tensor parallelism (heads and FFN width over ``tp``), experts
over ``ep``, weights whole over ``dp`` and ``sp``.

Where XLA places a sharded array and partitions the program, the port
cuts each leaf once, at load: :func:`shard_leaf` keeps this rank's slice
(``QuantW`` leaves too, ``q`` as its weight and ``s`` along the weight's
output axes, ``models.quant.quant_spec``), and ``models.transformer``
runs the Megatron forward on local heads and width with explicit
collectives. One departure, for ``tp`` above the KV-head count (the
planner never picks it, an explicit plan may): a rank keeps the whole KV
head its query heads read (``wk``, ``wv``, their biases and the cache),
where JAX's spec would cut inside the head.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from gpustack_tpu_torch.models.quant import QuantW, quant_spec
from gpustack_tpu_torch.parallel.mesh import (
    AXIS_DP,
    AXIS_EP,
    AXIS_SP,
    AXIS_TP,
    Mesh,
)


class PSpec(tuple):
    """A partition spec: per dim, the mesh axis it splits over or None.
    Prints as JAX's ``PartitionSpec`` does."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __str__(self) -> str:
        return "PartitionSpec" + tuple.__repr__(self)

    __repr__ = __str__


P = PSpec

# leaves whose split axis is KV heads: kept whole per head when tp > Hkv
KV_HEAD_LEAVES = ("wk", "wv", "bk", "bv")


@dataclasses.dataclass(frozen=True)
class SpecLayout:
    """Declarative dp/sp/ep/tp axis assignment for one model replica."""

    dp_axis: str = AXIS_DP
    sp_axis: str = AXIS_SP
    ep_axis: str = AXIS_EP
    tp_axis: str = AXIS_TP
    long_context: bool = False
    train: bool = False

    @property
    def fsdp_axis(self) -> Optional[str]:
        return self.dp_axis if self.train else None

    # ---- params ---------------------------------------------------------

    def layer_rules(self) -> Dict[str, PSpec]:
        fsdp, tp, ep = self.fsdp_axis, self.tp_axis, self.ep_axis
        return {
            "attn_norm": P(None, None),
            "mlp_norm": P(None, None),
            "wq": P(None, fsdp, tp),
            "wk": P(None, fsdp, tp),
            "wv": P(None, fsdp, tp),
            "wo": P(None, tp, fsdp),
            "bq": P(None, tp),
            "bk": P(None, tp),
            "bv": P(None, tp),
            "q_norm": P(None, None),
            "k_norm": P(None, None),
            "post_attn_norm": P(None, None),
            "post_mlp_norm": P(None, None),
            "w_gate": P(None, fsdp, tp),
            "w_up": P(None, fsdp, tp),
            "w_down": P(None, tp, fsdp),
            "router": P(None, fsdp, None),
            "we_gate": P(None, ep, fsdp, tp),
            "we_up": P(None, ep, fsdp, tp),
            "we_down": P(None, ep, tp, fsdp),
            "wq_a": P(None, fsdp, None),
            "q_a_norm": P(None, None),
            "wq_b": P(None, None, tp),
            "wkv_a": P(None, fsdp, None),
            "kv_a_norm": P(None, None),
            "wkv_b": P(None, None, tp),
            "ws_gate": P(None, fsdp, tp),
            "ws_up": P(None, fsdp, tp),
            "ws_down": P(None, tp, fsdp),
            "shared_gate": P(None, None, None),
            "router_bias": P(None, None),
            "bo": P(None, None),
            "sinks": P(None, None),
            "we_gate_b": P(None, ep, tp),
            "we_up_b": P(None, ep, tp),
            "we_down_b": P(None, ep, None),
        }

    def embed(self) -> PSpec:
        return P(self.tp_axis, self.fsdp_axis)

    def lm_head(self) -> PSpec:
        return P(self.fsdp_axis, self.tp_axis)

    def spec(self, name: str) -> PSpec:
        """The spec of top-level leaf or layer leaf ``name``."""
        if name == "embed":
            return self.embed()
        if name == "lm_head":
            return self.lm_head()
        if name == "final_norm":
            return P(None)
        return self.layer_rules()[name]

    def params(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """Spec tree matching the param tree (layer stacks included)."""
        specs: Dict[str, Any] = {
            "embed": self.embed(),
            "final_norm": P(None),
        }
        for stack in ("layers", "dense_layers"):
            if stack in params:
                specs[stack] = {k: self.spec(k) for k in params[stack]}
        if "lm_head" in params:
            specs["lm_head"] = self.lm_head()
        return specs

    # ---- activations / serving state ------------------------------------

    def activations(self, seq_sharded: bool = False) -> PSpec:
        return P(self.dp_axis, self.sp_axis if seq_sharded else None)

    def cache(self) -> PSpec:
        """KV cache [L, B, S, H_kv, hd]: rows over dp, heads over tp."""
        return P(
            None, self.dp_axis,
            self.sp_axis if self.long_context else None,
            self.tp_axis, None,
        )

    def slot_state(self) -> PSpec:
        """Per-slot decode vectors: whole on every rank."""
        return P(None)

    def replicated(self) -> PSpec:
        return P()

    def describe(self) -> Dict[str, Any]:
        """The layout as one dict (the engine's ``/healthz`` ``layout``)."""
        return {
            "axes": {
                "dp": self.dp_axis, "sp": self.sp_axis,
                "ep": self.ep_axis, "tp": self.tp_axis,
            },
            "train": self.train,
            "long_context": self.long_context,
            "cache": str(self.cache()),
            "slot_state": str(self.slot_state()),
            "activations": str(self.activations(self.long_context)),
            "embed": str(self.embed()),
            "host_read": str(self.replicated()),
        }


def _slice(x: torch.Tensor, spec, mesh: Mesh,
           kv_heads: Optional[int] = None) -> torch.Tensor:
    """This rank's block of ``x`` under ``spec``, as a compact tensor of
    its own (the full leaf can be freed). ``kv_heads``: ``x``'s split dim
    holds that many KV heads; with ``tp`` above it, the rank's whole head."""
    out = x
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n = mesh.plan.axis_sizes()[axis]
        i = mesh.coords[axis]
        if axis == AXIS_TP and kv_heads and n > kv_heads:
            if n % kv_heads:
                raise ValueError(
                    f"tp {n} neither divides nor is a multiple of the "
                    f"{kv_heads} KV heads"
                )
            i, n = i // (n // kv_heads), kv_heads
        if n == 1:
            continue
        size = out.shape[dim]
        if size % n:
            raise ValueError(
                f"dim {dim} of {tuple(x.shape)} ({size}) does not split "
                f"over {axis}={n}"
            )
        out = out.narrow(dim, i * (size // n), size // n)
    if out is x:
        return x
    return torch.empty(out.shape, dtype=out.dtype, device=out.device).copy_(out)


def shard_leaf(
    name: str, tensor, mesh: Mesh, stacked: bool = True,
    kv_heads: Optional[int] = None, layout: Optional[SpecLayout] = None,
):
    """This rank's shard of leaf ``name`` (a tensor or ``QuantW``).
    ``stacked`` False: a single layer's view (the spec without its
    leading layer axis). ``kv_heads``: the config's KV-head count, for
    ``wk``/``wv``/``bk``/``bv`` under ``tp`` above it."""
    layout = layout or SpecLayout()
    spec = layout.spec(name)
    top = name in ("embed", "lm_head", "final_norm")
    if not stacked and not top:
        spec = P(*spec[1:])
    heads = kv_heads if name in KV_HEAD_LEAVES else None
    if isinstance(tensor, QuantW):
        q_spec, s_spec = quant_spec(name, spec, stacked and not top)
        return QuantW(
            q=_slice(tensor.q, q_spec, mesh, heads),
            s=_slice(tensor.s, s_spec, mesh, heads),
        )
    return _slice(tensor, spec, mesh, heads)


def shard_params(
    params: Dict[str, Any], mesh: Mesh, kv_heads: Optional[int] = None,
) -> Dict[str, Any]:
    """This rank's shard of a whole param tree (a new tree)."""
    out: Dict[str, Any] = {}
    for k, v in params.items():
        if k in ("layers", "dense_layers"):
            out[k] = {
                lk: shard_leaf(lk, lv, mesh, kv_heads=kv_heads)
                for lk, lv in v.items()
            }
        else:
            out[k] = shard_leaf(k, v, mesh, kv_heads=kv_heads)
    return out
