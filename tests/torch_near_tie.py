"""Where two frameworks' bf16 greedy ids may part: a near tie.

The port's bf16 forward and the JAX package's round in other orders (the
sampler's reductions, an MoE layer's fp32 sum of its expert outputs,
``tp``'s all-reduce), so their greedy ids may part where two tokens' logits
lie closer than that rounding. :func:`parting` finds where ``got`` first
parts from ``want`` and checks it is such a place: the JAX fp32 forward of
the same tree over the prompt and ``want``'s tokens so far gives both
tokens logits within ``tol`` of the logit scale of its top one."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from gpustack_tpu.models import transformer as jt
from gpustack_tpu.models.config import PRESETS as JAX_PRESETS


def parting(preset, tree, prompt, got, want, tol):
    """The index where ``got`` first parts from ``want`` (``len(want)``:
    nowhere, and then ``got == want``); ``tree`` is the JAX tree of
    ``preset`` the ids came from."""
    i = next((i for i, (g, w) in enumerate(zip(got, want)) if g != w),
             len(want))
    if i == len(want):
        assert got == want
        return i
    cfg = dataclasses.replace(JAX_PRESETS[preset], dtype="float32")
    tree = jax.tree.map(lambda a: a.astype(jnp.float32), tree)
    ids = list(prompt) + list(want[:i])
    logits, _ = jt.forward(tree, cfg, jnp.asarray([ids]),
                           jnp.arange(len(ids))[None])
    last = np.asarray(logits[0, -1])
    top, scale = float(last.max()), float(np.abs(last).max())
    for tok in (got[i], want[i]):
        assert top - float(last[tok]) <= tol * scale, (
            f"ids part at {i} ({got[i]} against {want[i]}), no near tie: "
            f"{top - float(last[tok])} below the top of {scale}")
    return i
