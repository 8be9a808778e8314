"""Vision-language serving: ViT tower + projector + token splicing.

The port of ``gpustack_tpu/models/vlm.py``:

  image [S, S, 3] ── patchify (one reshape) ──► ViT (non-causal,
  plain torch: 64 patches) ──► projector (2-layer MLP into the language
  dim) ──► spliced into the prompt's embedding sequence at placeholder
  positions; the language model's prefill runs ONE forward with the
  override applied after the embedding lookup
  (``models/transformer.forward(embeds_override=...)``), through the
  flash kernel on the card.

Images arrive as ``data:`` URLs (base64) only; remote URLs are refused.
They are decoded and resized by ``models/png.py`` (PNG only, Pillow's
bicubic resize), since the card's machine has no PIL.
"""

from __future__ import annotations

import base64
import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from gpustack_tpu_torch.device import resolve_device
from gpustack_tpu_torch.models.config import ModelConfig, get_config
from gpustack_tpu_torch.models.png import decode_image, resize_bicubic

Params = Dict[str, Any]

# ByteTokenizer id 257 is BOS/reserved (engine/tokenizer.py), reused as
# the image-placeholder id so hermetic VLM configs need no vocab change.
IMAGE_PLACEHOLDER_ID = 257


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    image_size: int = 64
    patch_size: int = 8
    dim: int = 64
    layers: int = 2
    heads: int = 2

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    name: str
    language: ModelConfig
    vision: VisionConfig

    @property
    def n_image_tokens(self) -> int:
        return self.vision.n_patches


def _tiny_vlm() -> VLMConfig:
    return VLMConfig(
        name="tiny-vlm",
        language=get_config("tiny"),
        vision=VisionConfig(),
    )


VLM_PRESETS = {"tiny-vlm": _tiny_vlm}


def get_vlm_config(preset: str) -> VLMConfig:
    return VLM_PRESETS[preset]()


def init_vision_params(
    cfg: VLMConfig, generator: torch.Generator, device=None
) -> Params:
    """Vision tower + projector params (the language params live in the
    engine's own tree), drawn on ``device`` (the generator's device) from
    ``generator``: the JAX shapes and scales, fp32 draws rounded to bf16;
    not the same numbers."""
    device = torch.device(device) if device is not None else generator.device
    v = cfg.vision

    def w(*shape, scale=None):
        scale = scale or (1.0 / math.sqrt(shape[-1]))
        out = torch.randn(
            shape, generator=generator, dtype=torch.float32, device=device
        )
        return out.mul_(scale).to(torch.bfloat16)

    D = v.dim
    patch_dim = 3 * v.patch_size * v.patch_size
    lm_dim = cfg.language.hidden_size
    return {
        "patch_proj": w(patch_dim, D),
        "pos_emb": w(v.n_patches, D, scale=0.02),
        "blocks": {
            "wq": w(v.layers, D, D),
            "wk": w(v.layers, D, D),
            "wv": w(v.layers, D, D),
            "wo": w(v.layers, D, D),
            "w1": w(v.layers, D, 4 * D),
            "w2": w(v.layers, 4 * D, D),
            "ln1": torch.ones(v.layers, D, device=device),
            "ln2": torch.ones(v.layers, D, device=device),
        },
        "proj_w1": w(D, lm_dim),
        "proj_w2": w(lm_dim, lm_dim),
    }


def _rms(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-6):
    """Normalise and apply the fp32 gain in fp32, then round once."""
    n = x.float()
    n = n * torch.rsqrt((n * n).mean(-1, keepdim=True) + eps)
    return (n * g).to(x.dtype)


def encode_image(
    params: Params, cfg: VLMConfig, image: torch.Tensor
) -> torch.Tensor:
    """image [S, S, 3] float in [0, 1] → [n_patches, lm_dim] in the
    params' dtype. The pixels round to bf16 first, as in JAX; the scaling
    to [-1, 1] then runs in the params' dtype, as the jitted JAX encoder
    runs it (under fp32 params XLA keeps the scaling's excess precision,
    where an eager bf16 op would round it)."""
    v = cfg.vision
    p = v.patch_size
    g = v.image_size // p
    dt = params["patch_proj"].dtype
    # patchify without convs: [g, p, g, p, 3] -> [g*g, p*p*3]
    x = image.reshape(g, p, g, p, 3).permute(0, 2, 1, 3, 4)
    x = x.reshape(v.n_patches, p * p * 3).to(torch.bfloat16).to(dt)
    x = (x * 2.0 - 1.0) @ params["patch_proj"] + params["pos_emb"]

    nh, hd = v.heads, v.head_dim
    scale = 1.0 / math.sqrt(hd)
    blocks = params["blocks"]
    for i in range(v.layers):
        h = _rms(x, blocks["ln1"][i])
        q = (h @ blocks["wq"][i]).reshape(-1, nh, hd)
        k = (h @ blocks["wk"][i]).reshape(-1, nh, hd)
        val = (h @ blocks["wv"][i]).reshape(-1, nh, hd)
        att = torch.einsum("qhd,khd->hqk", q, k) * scale
        att = torch.softmax(att.float(), -1).to(x.dtype)
        o = torch.einsum("hqk,khd->qhd", att, val).reshape(-1, v.dim)
        x = x + o @ blocks["wo"][i]
        h = _rms(x, blocks["ln2"][i])
        x = x + F.gelu(h @ blocks["w1"][i], approximate="tanh") @ blocks[
            "w2"][i]
    # LLaVA-style 2-layer MLP projector into the language dim
    return F.gelu(x @ params["proj_w1"], approximate="tanh") @ params[
        "proj_w2"]


class VisionBundle:
    """What the API server needs to serve image content parts: the tower
    params on the device, the encoder and the preprocessing."""

    def __init__(self, cfg: VLMConfig, params: Params, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = params

    @property
    def n_image_tokens(self) -> int:
        return self.cfg.n_image_tokens

    def preprocess(self, image_bytes: bytes) -> np.ndarray:
        """Decode + resize to the tower's square input, float [0, 1]."""
        try:
            img = decode_image(image_bytes)
        except ValueError as e:
            raise ValueError(f"cannot decode image: {e}") from None
        s = self.cfg.vision.image_size
        img = resize_bicubic(img, s, s)
        return img.astype(np.float32) / 255.0

    def encode(self, image_bytes: bytes) -> np.ndarray:
        image = torch.from_numpy(self.preprocess(image_bytes)).to(self.device)
        with torch.no_grad():
            emb = encode_image(self.params, self.cfg, image)
        return emb.float().cpu().numpy()


def decode_data_url(url: str) -> bytes:
    """``data:image/...;base64,...`` → raw image bytes. Anything else is
    refused: the engine never dials out for remote images."""
    if not url.startswith("data:"):
        raise ValueError(
            "only data: image URLs are supported (zero-egress deployment "
            "— inline the image as base64)"
        )
    header, _, payload = url.partition(",")
    if not payload or "base64" not in header:
        raise ValueError("malformed data URL (expected ';base64,' payload)")
    try:
        return base64.b64decode(payload, validate=True)
    except ValueError as e:       # binascii.Error is one
        raise ValueError(f"invalid base64 image payload: {e}") from e


def build_mm_prompt(
    tokenizer,
    messages: List[dict],
    bundle: VisionBundle,
) -> Tuple[List[int], np.ndarray, np.ndarray]:
    """OpenAI messages with content parts → (prompt_ids, embeds [T, D]
    fp32, mask [T] bool).

    Text parts tokenize normally; each ``image_url`` part becomes a run
    of ``n_image_tokens`` placeholder ids whose embedding rows are
    overridden with the projected patch embeddings. The chat scaffolding
    mirrors the byte tokenizer's text-only template."""
    n_img = bundle.n_image_tokens
    ids: List[int] = []
    embeds: List[Optional[np.ndarray]] = []   # aligned per-token rows

    def add_text(text: str) -> None:
        toks = tokenizer.encode(text)
        ids.extend(toks)
        embeds.extend([None] * len(toks))

    for m in messages:
        role = m.get("role", "user")
        content = m.get("content", "")
        add_text(f"<{role}>")
        if isinstance(content, list):
            for part in content:
                if not isinstance(part, dict):
                    raise ValueError(
                        "content parts must be objects with a 'type'"
                    )
                ptype = part.get("type")
                if ptype == "text":
                    add_text(part.get("text", ""))
                elif ptype == "image_url":
                    url = (part.get("image_url") or {}).get("url", "")
                    img_embeds = bundle.encode(decode_data_url(url))
                    ids.extend([IMAGE_PLACEHOLDER_ID] * n_img)
                    embeds.extend(list(img_embeds))
                else:
                    raise ValueError(
                        f"unsupported content part type {ptype!r}"
                    )
        else:
            add_text(str(content or ""))
        add_text(f"</{role}>")
    add_text("<assistant>")

    lm_dim = bundle.cfg.language.hidden_size
    embed_arr = np.zeros((len(ids), lm_dim), np.float32)
    mask = np.zeros((len(ids),), bool)
    for i, row in enumerate(embeds):
        if row is not None:
            embed_arr[i] = row
            mask[i] = True
    return ids, embed_arr, mask
