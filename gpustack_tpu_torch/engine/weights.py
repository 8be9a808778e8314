"""Model weights for the port: HF safetensors and GGUF checkpoints, PEFT
LoRA merges, npz caching of (int8) trees, random init on the device, and
carrying a parameter tree across from the JAX package (through numpy).

The port of ``gpustack_tpu/engine/weights.py`` for the dense Llama family,
the MoE family (Mixtral, Qwen2/3-MoE), DeepSeek-V2/V3 (MLA, the
``first_k_dense`` split), Gemma (sandwich norms) and GPT-OSS (sinks, the
attention output bias, fused experts, MXFP4 expert blocks).
Torch stores linear weights as ``[out_features, in_features]``; the
functional matmuls contract ``x @ W`` with ``W[in, out]``, so every
projection transposes on load. Loaded leaves are bf16, as in JAX; router
biases and attention sinks are fp32.

The safetensors reader is the port's own (the card's machine has no
``safetensors`` package): an 8-byte little-endian header length, a JSON
header, then each tensor's bytes at its offsets.

The modalities: ``load_whisper_params`` (an HF Whisper safetensors dir
on the same reader) and ``load_npz_params`` (the in-repo TTS model's npz
tree); ``params_from_numpy`` also carries the vision, Whisper, TTS and
diffusion trees across, transposing the conv weights once (Whisper's HIO
``[K, Cin, Cout]`` to ``[Cout, Cin, K]``, a diffusion tree's HWIO to
OIHW). The diffusers loader is ``engine/image_weights.py``.
"""

from __future__ import annotations

import glob
import json
import logging
import os
import re
import struct
from typing import Any, Dict, Optional

import numpy as np
import torch

from gpustack_tpu_torch.device import resolve_device
from gpustack_tpu_torch.models.config import ModelConfig
from gpustack_tpu_torch.models.quant import QuantW
from gpustack_tpu_torch.models.transformer import init_params, torch_dtype

logger = logging.getLogger(__name__)

_ST_DTYPES = {
    "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I8": torch.int8, "U8": torch.uint8, "I32": torch.int32,
}


# MXFP4 e2m1 values, nibble-indexed (sign bit high): the packing of the
# GPT-OSS hub checkpoints' expert weights (transformers integrations/mxfp4
# FP4_VALUES). The port's own copy of the JAX loader's table.
_FP4_VALUES = (
    0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0,
    -0.0, -0.5, -1.0, -1.5, -2.0, -3.0, -4.0, -6.0,
)


def _mxfp4_dequant(blocks: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """MXFP4 ``blocks`` uint8 ``[..., G, B]`` (fp4 pairs, the low nibble
    the even element) and e8m0 ``scales`` uint8 ``[..., G]`` (biased by
    127) → the bf16 weight ``[..., G·2B, X]``: the block axes flattened
    and the last two swapped into the ``[E, in, out]`` layout, on the
    tensors' device. Bit for bit the JAX ``_mxfp4_dequant``: an e2m1 value
    times a power of two is exact in fp32 and in bf16, and the power is
    built from its exponent bits (``2^(e-127)``; e = 0 is the subnormal
    2^-127), with no rounding of its own."""
    lut = torch.tensor(_FP4_VALUES, dtype=torch.float32, device=blocks.device)
    b = blocks.int()
    out = torch.stack([lut[b & 0x0F], lut[b >> 4]], dim=-1).flatten(-2)
    e = scales.to(torch.int32)
    bits = torch.where(e > 0, e << 23, torch.full_like(e, 1 << 22))
    out *= bits.view(torch.float32)[..., None]
    out = out.reshape(*blocks.shape[:-2], -1)              # [..., X, in]
    return out.transpose(-1, -2).to(torch.bfloat16)


def _read_safetensors_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one ``.safetensors`` file (CPU tensors owning their
    bytes). A header that does not describe the file is a ValueError."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: shorter than a safetensors header")
        (n,) = struct.unpack("<Q", head)
        if n > size - 8:
            raise ValueError(
                f"{path}: header length {n} exceeds the file ({size} bytes)"
            )
        try:
            header = json.loads(f.read(n))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ValueError(f"{path}: header is not JSON ({e})") from None
        if not isinstance(header, dict):
            raise ValueError(f"{path}: header is not a JSON object")
        base, data_len = 8 + n, size - 8 - n
        tensors: Dict[str, torch.Tensor] = {}
        for name, info in header.items():
            if name == "__metadata__":
                continue
            try:
                dtype = _ST_DTYPES[info["dtype"]]
                shape = [int(d) for d in info["shape"]]
                begin, end = (int(o) for o in info["data_offsets"])
            except (KeyError, TypeError, ValueError):
                raise ValueError(
                    f"{path}: tensor {name!r} has a malformed or unsupported "
                    f"entry {info!r} (dtypes: {sorted(_ST_DTYPES)})"
                ) from None
            numel = int(np.prod(shape, dtype=np.int64))
            nbytes = numel * torch.empty((), dtype=dtype).element_size()
            if (
                any(d < 0 for d in shape) or not 0 <= begin <= end <= data_len
                or end - begin != nbytes
            ):
                raise ValueError(
                    f"{path}: tensor {name!r} offsets {begin}..{end} do not "
                    f"hold {shape} {info['dtype']} inside {data_len} bytes"
                )
            f.seek(base + begin)
            buf = bytearray(f.read(nbytes))
            t = (
                torch.frombuffer(buf, dtype=dtype)
                if nbytes else torch.empty(0, dtype=dtype)
            )
            tensors[name] = t.reshape(shape)
    return tensors


def _read_safetensors(model_dir: str) -> Dict[str, torch.Tensor]:
    """All tensors from a local HF model dir, keyed by checkpoint name."""
    files = sorted(glob.glob(os.path.join(model_dir, "*.safetensors")))
    if not files:
        raise FileNotFoundError(f"no .safetensors files in {model_dir}")
    tensors: Dict[str, torch.Tensor] = {}
    for f in files:
        tensors.update(_read_safetensors_file(f))
    return tensors


def _taker(tensors: Dict[str, torch.Tensor]):
    """take(name, transpose) popping from ``tensors``: bf16, contiguous."""

    def take(name: str, transpose: bool = False) -> torch.Tensor:
        t = tensors.pop(name)
        if transpose:
            t = t.T
        return t.to(torch.bfloat16).contiguous()

    return take


def build_lm_params(
    cfg: ModelConfig, tensors: Dict[str, torch.Tensor], device=None
) -> Dict[str, Any]:
    """HF-named tensors → the stacked param tree (bf16) on ``device``
    (default: the CPU), for the dense llama-family names, ``qkv_bias``,
    ``qk_norm``, Gemma's sandwich norms (``post_attention_layernorm`` is
    the post-attention norm there, ``pre_feedforward_layernorm`` the
    pre-MLP one), GPT-OSS's ``o_proj.bias`` and fp32 ``sinks``, DeepSeek's
    MLA projections (``q_proj`` or ``q_a_proj`` → ``q_a_layernorm`` →
    ``q_b_proj``, ``kv_a_proj_with_mqa``, ``kv_a_layernorm``,
    ``kv_b_proj``) and the MoE names: Mixtral (``block_sparse_moe``,
    ``w1|w2|w3``), Qwen-MoE/DeepSeek (``mlp.gate``,
    ``experts.{e}.gate_proj|up_proj|down_proj``, shared experts, the fp32
    ``e_score_correction_bias``) and GPT-OSS (fused, biased experts, plain
    or MXFP4). DeepSeek's ``first_k_dense`` layers go to
    ``params["dense_layers"]`` and the MoE rest to ``params["layers"]``,
    as in the JAX loader.

    Each stacked leaf is allocated on ``device`` and filled one layer at a
    time, each tensor popped from ``tensors`` as it is copied: a layer's
    experts are stacked on the host (one layer at a time), never the whole
    checkpoint."""
    device = torch.device(device or "cpu")
    take = _taker(tensors)
    kd = cfg.first_k_dense if cfg.is_moe else 0

    def build_range(rng: range, moe: bool) -> Dict[str, torch.Tensor]:
        def stacked(layer_fn, dtype=torch.bfloat16) -> torch.Tensor:
            first = layer_fn(rng[0])
            out = torch.empty(
                (len(rng), *first.shape), dtype=dtype, device=device
            )
            out[0].copy_(first)
            for j, i in enumerate(rng[1:], start=1):
                out[j].copy_(layer_fn(i))
            return out

        def stack(fmt: str, transpose: bool = False) -> torch.Tensor:
            return stacked(lambda i: take(fmt.format(i), transpose))

        attn = "model.layers.{}.self_attn."
        layers: Dict[str, torch.Tensor] = {
            "attn_norm": stack("model.layers.{}.input_layernorm.weight"),
        }
        if cfg.is_mla:
            # DeepSeek MLA projections (served decompressed)
            if cfg.q_lora_rank:
                layers["wq_a"] = stack(attn + "q_a_proj.weight", True)
                layers["q_a_norm"] = stack(attn + "q_a_layernorm.weight")
                layers["wq_b"] = stack(attn + "q_b_proj.weight", True)
            else:
                layers["wq"] = stack(attn + "q_proj.weight", True)
            layers["wkv_a"] = stack(attn + "kv_a_proj_with_mqa.weight", True)
            layers["kv_a_norm"] = stack(attn + "kv_a_layernorm.weight")
            layers["wkv_b"] = stack(attn + "kv_b_proj.weight", True)
        else:
            layers["wq"] = stack(attn + "q_proj.weight", True)
            layers["wk"] = stack(attn + "k_proj.weight", True)
            layers["wv"] = stack(attn + "v_proj.weight", True)
        layers["wo"] = stack(attn + "o_proj.weight", True)
        layer = "model.layers.{}."
        if cfg.post_norms:
            # Gemma's sandwich: post_attention_layernorm is the POST-
            # attention norm; the pre-MLP norm has a name of its own
            layers["post_attn_norm"] = stack(
                layer + "post_attention_layernorm.weight"
            )
            layers["mlp_norm"] = stack(
                layer + "pre_feedforward_layernorm.weight"
            )
            layers["post_mlp_norm"] = stack(
                layer + "post_feedforward_layernorm.weight"
            )
        else:
            # llama-family: post_attention_layernorm IS the pre-MLP norm
            layers["mlp_norm"] = stack(
                layer + "post_attention_layernorm.weight"
            )
        if cfg.qkv_bias:
            layers["bq"] = stack(attn + "q_proj.bias")
            layers["bk"] = stack(attn + "k_proj.bias")
            layers["bv"] = stack(attn + "v_proj.bias")
        if cfg.o_bias:
            layers["bo"] = stack(attn + "o_proj.bias")
        if cfg.attn_sinks:
            # fp32: sink logits join the softmax denominator directly
            layers["sinks"] = stacked(
                lambda i: tensors.pop(attn.format(i) + "sinks"),
                dtype=torch.float32,
            )
        if cfg.qk_norm:
            layers["q_norm"] = stack(attn + "q_norm.weight")
            layers["k_norm"] = stack(attn + "k_norm.weight")
        if moe and cfg.moe_act == "gptoss":
            layers.update(_gptoss_experts(cfg, rng, tensors, take, stack,
                                          stacked, device))
        elif moe:
            layers.update(_moe_layers(cfg, tensors, take, stack, stacked))
        else:
            mlp = "model.layers.{}.mlp."
            layers["w_gate"] = stack(mlp + "gate_proj.weight", True)
            layers["w_up"] = stack(mlp + "up_proj.weight", True)
            layers["w_down"] = stack(mlp + "down_proj.weight", True)
        return layers

    params: Dict[str, Any] = {
        "embed": take("model.embed_tokens.weight").to(device),
        "layers": build_range(range(kd, cfg.num_layers), cfg.is_moe),
        "final_norm": take("model.norm.weight").to(device),
    }
    if kd:
        params["dense_layers"] = build_range(range(kd), False)
    if not cfg.tie_word_embeddings:
        if "lm_head.weight" in tensors:
            params["lm_head"] = take("lm_head.weight", True).to(device)
        else:
            logger.warning("no lm_head.weight; tying to embeddings")
            params["lm_head"] = params["embed"].T.contiguous()
    if tensors:
        logger.warning("unused checkpoint tensors: %s", sorted(tensors)[:8])
    return params


def _moe_layers(cfg: ModelConfig, tensors, take, stack, stacked):
    """The MoE leaves of :func:`build_lm_params` for one range of layers
    (the JAX loader's Mixtral and Qwen-MoE/DeepSeek branches)."""
    if "model.layers.0.block_sparse_moe.gate.weight" in tensors:
        block, wg, wd, wu = "block_sparse_moe", "w1", "w2", "w3"
    else:
        block, wg, wd, wu = "mlp", "gate_proj", "down_proj", "up_proj"
        if not cfg.shared_expert_intermediate_size and any(
            "shared_expert" in name for name in tensors
        ):
            # shared-expert tensors with no config support would be
            # silently dropped -> wrong logits; fail loudly
            raise ValueError(
                "checkpoint has shared-expert weights but the config "
                "declares no shared expert width"
            )
    prefix = "model.layers.{}." + block
    out: Dict[str, torch.Tensor] = {
        "router": stack(prefix + ".gate.weight", True),
    }
    if cfg.moe_scoring == "sigmoid":
        # fp32: the correction bias tie-breaks expert SELECTION
        out["router_bias"] = stacked(
            lambda i: tensors.pop(
                prefix.format(i) + ".gate.e_score_correction_bias"
            ),
            dtype=torch.float32,
        )

    def experts(w: str):
        # one layer's experts, [E, in, out]: a bounded host temporary
        return lambda i: torch.stack([
            take(f"{prefix.format(i)}.experts.{e}.{w}.weight", True)
            for e in range(cfg.num_experts)
        ])

    out["we_gate"] = stacked(experts(wg))
    out["we_down"] = stacked(experts(wd))
    out["we_up"] = stacked(experts(wu))
    if cfg.shared_expert_intermediate_size:
        # DeepSeek: mlp.shared_experts.* (plural, ungated); Qwen2-MoE:
        # mlp.shared_expert.* + shared_expert_gate
        se = (
            "model.layers.{}.mlp."
            + ("shared_expert" if cfg.shared_expert_gated else "shared_experts")
        )
        out["ws_gate"] = stack(se + ".gate_proj.weight", True)
        out["ws_up"] = stack(se + ".up_proj.weight", True)
        out["ws_down"] = stack(se + ".down_proj.weight", True)
        if cfg.shared_expert_gated:
            out["shared_gate"] = stack(
                "model.layers.{}.mlp.shared_expert_gate.weight", True
            )
    return out


def _gptoss_experts(cfg, rng, tensors, take, stack, stacked, device):
    """GPT-OSS's MoE leaves for one range of layers (the JAX loader's
    GPT-OSS branch): the affine router (its bias fp32), the fused
    ``gate_up_proj [E, D, 2F]`` with gate and up INTERLEAVED on the last
    axis, ``down_proj [E, F, D]``, and their biases. An expert weight is
    the plain tensor or, as the hub checkpoints ship it, MXFP4
    ``{name}_blocks`` and ``{name}_scales``, dequantized on ``device``
    one layer at a time."""
    prefix = "model.layers.{}.mlp."
    out: Dict[str, torch.Tensor] = {
        "router": stack(prefix + "router.weight", True),
        "router_bias": stacked(
            lambda i: tensors.pop(prefix.format(i) + "router.bias"),
            dtype=torch.float32,
        ),
    }

    def expert(name: str, i: int) -> torch.Tensor:
        base = f"{prefix.format(i)}experts.{name}"
        if base in tensors:
            return take(base).to(device)
        return _mxfp4_dequant(
            tensors.pop(base + "_blocks").to(device),
            tensors.pop(base + "_scales").to(device),
        )

    E, D, F = cfg.num_experts, cfg.hidden_size, cfg.moe_intermediate_size
    for key in ("we_gate", "we_up"):
        out[key] = torch.empty(
            (len(rng), E, D, F), dtype=torch.bfloat16, device=device
        )
    for j, i in enumerate(rng):
        gu = expert("gate_up_proj", i)                       # [E, D, 2F]
        out["we_gate"][j].copy_(gu[..., 0::2])
        out["we_up"][j].copy_(gu[..., 1::2])
        del gu
    gub = stack(prefix + "experts.gate_up_proj_bias")        # [n, E, 2F]
    out["we_gate_b"] = gub[..., 0::2].contiguous()
    out["we_up_b"] = gub[..., 1::2].contiguous()
    del gub
    out["we_down"] = stacked(lambda i: expert("down_proj", i))
    out["we_down_b"] = stack(prefix + "experts.down_proj_bias")
    return out


def load_hf_checkpoint(
    cfg: ModelConfig, model_dir: str, device=None
) -> Dict[str, Any]:
    """Load *.safetensors from a local HF model dir into the param tree on
    ``device`` (default: the CPU)."""
    return build_lm_params(cfg, _read_safetensors(model_dir), device)


def load_gguf_checkpoint(
    cfg: ModelConfig, gguf_path: str, device=None
) -> Dict[str, Any]:
    """Load a GGUF checkpoint: dequantize to the HF tensor names
    (engine/gguf.py), then the same mapping as safetensors."""
    from gpustack_tpu_torch.engine.gguf import load_gguf_tensors

    return build_lm_params(cfg, load_gguf_tensors(gguf_path), device)


# HF PEFT module name -> the stacked layer param (torch Linear weights are
# [out, in]; ours are [in, out], so the merged delta is (B @ A).T == A.T @
# B.T)
_LORA_MODULES = {
    "q_proj": "wq",
    "k_proj": "wk",
    "v_proj": "wv",
    "o_proj": "wo",
    "gate_proj": "w_gate",
    "up_proj": "w_up",
    "down_proj": "w_down",
}


def merge_lora_adapters(cfg, params: Dict[str, Any], adapter_dirs):
    """Merge PEFT LoRA adapters into the base weights, W' = W + s·BA, in
    place (on the tensors' device). Must run BEFORE int8 quantization.
    Returns the param tree."""
    pat = re.compile(
        r"layers\.(\d+)\.(?:self_attn|mlp)\.(\w+)\.lora_A\.weight$"
    )
    for adapter_dir in adapter_dirs:
        scale = 1.0
        try:
            with open(os.path.join(adapter_dir, "adapter_config.json")) as f:
                acfg = json.load(f)
            r = int(acfg.get("r", 0)) or 1
            alpha = float(acfg.get("lora_alpha", r))
            if acfg.get("use_rslora"):
                scale = alpha / (r ** 0.5)   # rsLoRA: alpha / sqrt(r)
            else:
                scale = alpha / r
        except (OSError, ValueError):
            logger.warning(
                "no adapter_config.json in %s; using scale 1.0", adapter_dir
            )
        tensors = _read_safetensors(adapter_dir)
        merged = 0
        for name in sorted(tensors):
            m = pat.search(name)
            if m is None:
                continue
            layer_idx, module = int(m.group(1)), m.group(2)
            ours = _LORA_MODULES.get(module)
            if layer_idx >= cfg.num_layers:
                # a half-applied adapter must be an error, not a mystery
                raise ValueError(
                    f"adapter {adapter_dir} targets layer {layer_idx} "
                    f"but the model has {cfg.num_layers} layers"
                )
            # DeepSeek's first_k_dense layers are a stack of their own:
            # absolute layer i is dense_layers[i] below kd, else
            # layers[i - kd]
            kd = (
                params["dense_layers"]["attn_norm"].shape[0]
                if "dense_layers" in params else 0
            )
            if layer_idx < kd:
                stack_key, stack_idx = "dense_layers", layer_idx
            else:
                stack_key, stack_idx = "layers", layer_idx - kd
            if ours is None or ours not in params[stack_key]:
                logger.warning(
                    "skipping LoRA target %s (unsupported module)", name
                )
                continue
            b_name = name.replace("lora_A", "lora_B")
            if b_name not in tensors:
                raise ValueError(
                    f"adapter {adapter_dir} is missing {b_name} "
                    f"(truncated checkpoint?)"
                )
            base = params[stack_key][ours]
            # fp32 through the delta product: a bf16 detour would cost ~8
            # mantissa bits twice
            a = tensors[name].to(base.device, torch.float32)
            b = tensors[b_name].to(base.device, torch.float32)
            delta = (a.T @ b.T) * scale                 # [in, out]
            base[stack_idx] += delta.to(base.dtype)
            merged += 1
        logger.info(
            "merged %d LoRA deltas from %s (scale %.3f)",
            merged, adapter_dir, scale,
        )
        if merged == 0:
            raise ValueError(
                f"adapter {adapter_dir} matched no mergeable weights"
            )
    return params


def checkpoint_source(model_dir: Optional[str]):
    """(kind, path) for a model source: ("safetensors", dir), ("gguf",
    file) or ("none", None). The one place format precedence lives, so
    config resolution and weight loading pick the same checkpoint in a
    mixed directory."""
    if model_dir and glob.glob(os.path.join(model_dir, "*.safetensors")):
        return "safetensors", model_dir
    if model_dir:
        from gpustack_tpu_torch.engine.gguf import gguf_file_in

        gguf_path = gguf_file_in(model_dir)
        if gguf_path:
            return "gguf", gguf_path
    return "none", None


def params_to_device(tree: Dict[str, Any], device) -> Dict[str, Any]:
    """The same tree with every tensor on ``device``; ``QuantW`` leaves
    move as they are (int8 and bf16, never widened)."""
    device = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return node.to(device)

    return walk(tree)


def load_or_init_params(
    cfg: ModelConfig, model_dir: Optional[str] = None, seed: int = 0,
    device: Optional[torch.device] = None, mesh=None,
) -> Dict[str, Any]:
    """The checkpoint under ``model_dir`` (safetensors before GGUF) on
    ``device`` (default: the card); without one, random weights drawn on
    ``device`` from a generator seeded with ``seed``. With a multi-rank
    ``mesh`` (``parallel.mesh.Mesh``) the random tree is this rank's
    shard, drawn whole a layer at a time and cut: the one-card tree's
    slice bit for bit (``transformer.init_params``). A checkpoint is read
    whole and cut by the caller (``parallel.sharding.shard_params``,
    after any LoRA merge and quantization)."""
    device = resolve_device(device)
    kind, path = checkpoint_source(model_dir)
    if kind != "none" and mesh is not None and mesh.world > 1:
        raise ValueError(
            "a checkpoint is read whole: cut it with shard_params"
        )
    if kind == "safetensors":
        logger.info("loading checkpoint from %s", path)
        return load_hf_checkpoint(cfg, path, device)
    if kind == "gguf":
        logger.info("loading GGUF checkpoint from %s", path)
        return load_gguf_checkpoint(cfg, path, device)
    logger.warning(
        "no checkpoint at %r — initializing random weights for %s on %s",
        model_dir, cfg.name, device,
    )
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return init_params(cfg, gen, dtype=torch_dtype(cfg), device=device,
                       mesh=mesh)


# ---------------------------------------------------------------------------
# npz checkpoints (both packages read each other's) and numpy trees
# ---------------------------------------------------------------------------


def _to_numpy(t: torch.Tensor) -> tuple:
    """(array, tag): npz has no bfloat16, so bf16 goes as float32 (exact)
    with a ``#bf16`` tag."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.float().numpy(), "#bf16"
    return t.numpy(), ""


def save_checkpoint(params: Dict[str, Any], path: str) -> None:
    """Save params in the stacked layout as npz, the JAX package's format:
    '/'-joined keys, ``QuantW`` leaves as ``::q`` / ``::s`` pairs."""
    flat: Dict[str, np.ndarray] = {}

    def walk(node, prefix: str) -> None:
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}/{k}" if prefix else k)
        elif isinstance(node, QuantW):
            arr, tag = _to_numpy(node.q)
            flat[prefix + "::q" + tag] = arr
            arr, tag = _to_numpy(node.s)
            flat[prefix + "::s" + tag] = arr
        else:
            arr, tag = _to_numpy(node)
            flat[prefix + tag] = arr

    walk(params, "")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **flat)


def load_checkpoint(path: str, device=None) -> Dict[str, Any]:
    """Read a :func:`save_checkpoint` file (of either package) onto
    ``device`` (default: the card)."""
    device = resolve_device(device)
    tree: Dict[str, Any] = {}
    pending: Dict[str, Dict[str, torch.Tensor]] = {}

    def place(name: str, leaf) -> None:
        parts = name.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf

    with np.load(path) as data:
        for name in data.files:
            arr = data[name]
            if name.endswith("#bf16"):
                name = name[: -len("#bf16")]
                t = torch.from_numpy(arr).to(device, torch.bfloat16)
            else:
                t = torch.from_numpy(arr).to(device)
            base, _, qs = name.partition("::")
            if qs:
                pending.setdefault(base, {})[qs] = t
            else:
                place(name, t)
    for base, qs in pending.items():
        place(base, QuantW(q=qs["q"], s=qs["s"]))
    return tree


def _to_tensor(arr, device: torch.device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        # numpy has no native bfloat16: reinterpret the 16-bit payload
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr).copy())
    return t.to(device)


# Whisper's conv leaves: HIO [K, Cin, Cout] in JAX, [Cout, Cin, K] here
_WHISPER_CONVS = ("conv1", "conv2")


def params_from_numpy(
    tree: Dict[str, Any], device=None, mesh=None, kv_heads=None,
) -> Dict[str, Any]:
    """Convert a parameter tree of numpy arrays (a JAX package tree:
    ``init_params``, ``init_vision_params``, ``init_whisper_params``,
    ``init_tts_params`` or ``init_diffusion_params``, leaves passed through
    ``np.asarray``) into the port's tree of tensors on ``device`` (default:
    the card): same keys, lists and ``None`` nodes, same stacked shapes,
    same dtypes, except the conv weights, transposed here once: Whisper's
    two (JAX's HIO ``[K, Cin, Cout]`` to ``[Cout, Cin, K]``) and every 4-D
    leaf of a diffusion tree (one with ``unet`` and ``vae``: HWIO to OIHW,
    in ``channels_last`` memory). A JAX ``QuantW`` leaf (any node with
    ``q`` and ``s`` arrays) becomes the port's ``QuantW``. With a
    multi-rank ``mesh``, a transformer tree is cut to this rank's shard
    (``parallel.sharding.shard_params``; ``kv_heads`` the config's, for
    ``tp`` above it) on the host before it moves."""
    device = resolve_device(device)
    diffusion = "unet" in tree and "vae" in tree

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if node is None:
            return None
        if hasattr(node, "q") and hasattr(node, "s"):
            return QuantW(
                q=_to_tensor(node.q, device), s=_to_tensor(node.s, device)
            )
        t = _to_tensor(node, device)
        if diffusion and t.dim() == 4:
            t = t.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
        return t

    if mesh is not None and mesh.world > 1:
        from gpustack_tpu_torch.parallel.sharding import shard_params

        host = params_from_numpy(tree, "cpu")
        return params_to_device(shard_params(host, mesh, kv_heads), device)
    out = walk(tree)
    for key in _WHISPER_CONVS:
        if key in out and out[key].dim() == 3:
            out[key] = out[key].permute(2, 1, 0).contiguous()
    return out


def load_npz_params(path: str, init_fn, device=None) -> Dict[str, Any]:
    """A flat-or-nested param tree saved as .npz ('/'-joined keys, each
    array as stored) on ``device`` (default: the card), or ``init_fn()``
    when no file exists: the checkpoint format of in-repo models without an
    HF counterpart (the TTS model)."""
    device = resolve_device(device)
    try:
        z = np.load(path)
    except OSError:
        logger.warning("no checkpoint at %r — random init", path)
        return init_fn()
    tree: Dict[str, Any] = {}
    with z:
        for key in z.files:
            node = tree
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = _to_tensor(z[key], device)
    return tree


def load_whisper_params(
    cfg, model_dir: str, device=None
) -> Dict[str, Any]:
    """An HF Whisper safetensors checkpoint as the ``models/whisper.py``
    tree on ``device`` (default: the card): bf16 leaves, linear weights
    transposed to ``[in, out]``, the conv weights kept as HF's ``[Cout,
    Cin, K]``. Without a checkpoint, random weights from seed 0 (the
    ``load_or_init_params`` contract)."""
    from gpustack_tpu_torch.models.whisper import init_whisper_params

    device = resolve_device(device)
    try:
        tensors = _read_safetensors(model_dir)
    except FileNotFoundError:
        logger.warning(
            "no whisper checkpoint at %r — random init", model_dir
        )
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        return init_whisper_params(cfg, gen)
    take = _taker(tensors)

    def stack(side: str, L: int, fmt: str, transpose=False) -> torch.Tensor:
        return torch.stack([
            take(f"model.{side}.layers.{i}.{fmt}", transpose).to(device)
            for i in range(L)
        ])

    def attn_block(side: str, L: int, prefix: str, out: dict, tag: str):
        out[f"{tag}wq"] = stack(side, L, f"{prefix}.q_proj.weight", True)
        out[f"{tag}bq"] = stack(side, L, f"{prefix}.q_proj.bias")
        out[f"{tag}wk"] = stack(side, L, f"{prefix}.k_proj.weight", True)
        out[f"{tag}wv"] = stack(side, L, f"{prefix}.v_proj.weight", True)
        out[f"{tag}bv"] = stack(side, L, f"{prefix}.v_proj.bias")
        out[f"{tag}wo"] = stack(side, L, f"{prefix}.out_proj.weight", True)
        out[f"{tag}bo"] = stack(side, L, f"{prefix}.out_proj.bias")

    def layer_group(side: str, L: int) -> dict:
        out = {
            "ln1": stack(side, L, "self_attn_layer_norm.weight"),
            "ln1_b": stack(side, L, "self_attn_layer_norm.bias"),
            "ln2": stack(side, L, "final_layer_norm.weight"),
            "ln2_b": stack(side, L, "final_layer_norm.bias"),
            "w_up": stack(side, L, "fc1.weight", True),
            "b_up": stack(side, L, "fc1.bias"),
            "w_down": stack(side, L, "fc2.weight", True),
            "b_down": stack(side, L, "fc2.bias"),
        }
        attn_block(side, L, "self_attn", out, "")
        if side == "decoder":
            out["lnx"] = stack(side, L, "encoder_attn_layer_norm.weight")
            out["lnx_b"] = stack(side, L, "encoder_attn_layer_norm.bias")
            attn_block(side, L, "encoder_attn", out, "x")
        return out

    def one(name: str) -> torch.Tensor:
        return take(name).to(device)

    params = {
        "conv1": one("model.encoder.conv1.weight"),
        "conv1_b": one("model.encoder.conv1.bias"),
        "conv2": one("model.encoder.conv2.weight"),
        "conv2_b": one("model.encoder.conv2.bias"),
        "enc_layers": layer_group("encoder", cfg.encoder_layers),
        "enc_ln": one("model.encoder.layer_norm.weight"),
        "enc_ln_b": one("model.encoder.layer_norm.bias"),
        "tok_embed": one("model.decoder.embed_tokens.weight"),
        "pos_embed": one("model.decoder.embed_positions.weight"),
        "dec_layers": layer_group("decoder", cfg.decoder_layers),
        "dec_ln": one("model.decoder.layer_norm.weight"),
        "dec_ln_b": one("model.decoder.layer_norm.bias"),
    }
    # encoder position embeddings are fixed sinusoids (recomputed)
    tensors.pop("model.encoder.embed_positions.weight", None)
    tensors.pop("proj_out.weight", None)  # tied to tok_embed
    if tensors:
        logger.warning(
            "unused whisper tensors: %s", sorted(tensors)[:8]
        )
    return params
