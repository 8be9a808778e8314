"""Model weights for the port: random init on the device, and carrying a
parameter tree across from the JAX package (through numpy).

Checkpoint loading (safetensors, GGUF, LoRA merges — ``gpustack_tpu/
engine/weights.py``) is not ported yet; see ROADMAP.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional

import numpy as np
import torch

from gpustack_tpu_torch.device import resolve_device
from gpustack_tpu_torch.models.config import ModelConfig
from gpustack_tpu_torch.models.transformer import (
    check_supported,
    init_params,
    torch_dtype,
)

logger = logging.getLogger(__name__)


def load_or_init_params(
    cfg: ModelConfig, model_dir: Optional[str] = None, seed: int = 0,
    device: Optional[torch.device] = None,
) -> Dict[str, Any]:
    """Random weights drawn on ``device`` (default: the card) from a
    generator seeded with ``seed`` (the counterpart of the JAX
    ``load_or_init_params`` without a checkpoint). A ``model_dir`` raises
    until checkpoint loading is ported."""
    if model_dir:
        raise NotImplementedError(
            "checkpoint loading (safetensors/GGUF) is not ported yet "
            "(ROADMAP 'Modules to port': safetensors/GGUF loading); serve "
            "a preset with random weights"
        )
    device = resolve_device(device)
    logger.warning("initializing random weights for %s on %s", cfg.name, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return init_params(cfg, gen, dtype=torch_dtype(cfg), device=device)


def _to_tensor(arr, device: torch.device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        # numpy has no native bfloat16: reinterpret the 16-bit payload
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr).copy())
    return t.to(device)


def params_from_numpy(
    tree: Dict[str, Any], cfg: ModelConfig, device=None
) -> Dict[str, Any]:
    """Convert a parameter tree of numpy arrays (the JAX package's
    ``init_params`` layout, leaves passed through ``np.asarray``) into the
    port's tree of tensors on ``device`` (default: the card): same keys,
    same stacked shapes, same dtypes."""
    check_supported(cfg)
    device = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return _to_tensor(node, device)

    return walk(tree)
