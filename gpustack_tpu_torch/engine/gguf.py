"""GGUF checkpoint loading: parse + dequantize into the HF tensor names
the safetensors loader already maps.

The port's own copy of ``gpustack_tpu/engine/gguf.py`` (numpy only; the
port imports nothing of the JAX package). GGUF tensors are dequantized to
fp32 at load, handed to the same param-tree builder as safetensors
checkpoints (``engine/weights.py``), and optionally re-quantized to int8
weight-only for the W8A16 kernel. Keep the two copies in step: the port's
tests read the same files through both.

Format: GGUF v2/v3 (little-endian) — header, typed metadata KV section,
tensor info table, aligned data section. Quantizations supported:
F32/F16/BF16 passthrough, Q8_0, Q4_0/Q4_1, Q5_0/Q5_1, and the K-quant
super-block formats Q2_K/Q3_K/Q4_K/Q5_K/Q6_K (what real-world Q4_K_M /
Q5_K_M / Q6_K checkpoints ship). gguf-split multi-file checkpoints are
resolved via ``split.count`` metadata (gguf_shard_paths). MoE exports
(mixtral/qwen3moe-class fused ffn_*_exps tensors + ffn_gate_inp
router) load too; shared-expert (shexp) exports are rejected loudly.

Tokenizer: a ``tokenizer.json`` sidecar next to the .gguf wins (exact
HF tokenization). Without one, the GGUF's embedded vocab drives exact
DECODING (SentencePiece ``▁``/byte-token conventions) and greedy
longest-match ENCODING — a documented approximation: merges are not
replayed, so token boundaries can differ from the original BPE on rare
strings.
"""

from __future__ import annotations

import logging
import os
import re
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

GGUF_MAGIC = 0x46554747      # "GGUF" little-endian

# metadata value types
_T_U8, _T_I8, _T_U16, _T_I16, _T_U32, _T_I32, _T_F32, _T_BOOL = range(8)
_T_STRING, _T_ARRAY, _T_U64, _T_I64, _T_F64 = 8, 9, 10, 11, 12

_SCALAR_FMT = {
    _T_U8: "<B", _T_I8: "<b", _T_U16: "<H", _T_I16: "<h",
    _T_U32: "<I", _T_I32: "<i", _T_F32: "<f", _T_BOOL: "<?",
    _T_U64: "<Q", _T_I64: "<q", _T_F64: "<d",
}

# ggml tensor types (subset)
GGML_F32, GGML_F16 = 0, 1
GGML_Q4_0, GGML_Q4_1 = 2, 3
GGML_Q5_0, GGML_Q5_1 = 6, 7
GGML_Q8_0 = 8
GGML_Q2_K, GGML_Q3_K, GGML_Q4_K, GGML_Q5_K, GGML_Q6_K = 10, 11, 12, 13, 14
GGML_BF16 = 30

_TYPE_NAMES = {
    0: "F32", 1: "F16", 2: "Q4_0", 3: "Q4_1", 6: "Q5_0", 7: "Q5_1",
    8: "Q8_0", 9: "Q8_1", 10: "Q2_K", 11: "Q3_K", 12: "Q4_K",
    13: "Q5_K", 14: "Q6_K", 15: "Q8_K", 30: "BF16",
}

# bytes per block for each supported quantized type (block = 32 elements
# for the _0/_1 formats, 256 for K-quant super-blocks)
_BLOCK_BYTES = {
    GGML_Q4_0: (32, 18), GGML_Q4_1: (32, 20),
    GGML_Q5_0: (32, 22), GGML_Q5_1: (32, 24),
    GGML_Q8_0: (32, 34),
    GGML_Q2_K: (256, 84), GGML_Q3_K: (256, 110), GGML_Q4_K: (256, 144),
    GGML_Q5_K: (256, 176), GGML_Q6_K: (256, 210),
}


class _Reader:
    def __init__(self, data: memoryview):
        self.data = data
        self.pos = 0

    def scalar(self, vtype: int):
        fmt = _SCALAR_FMT[vtype]
        size = struct.calcsize(fmt)
        (value,) = struct.unpack_from(fmt, self.data, self.pos)
        self.pos += size
        return value

    def string(self) -> str:
        n = self.scalar(_T_U64)
        raw = bytes(self.data[self.pos: self.pos + n])
        self.pos += n
        return raw.decode("utf-8", errors="replace")

    def value(self, vtype: int):
        if vtype == _T_STRING:
            return self.string()
        if vtype == _T_ARRAY:
            etype = self.scalar(_T_U32)
            count = self.scalar(_T_U64)
            return [self.value(etype) for _ in range(count)]
        return self.scalar(vtype)


def read_gguf(
    path: str,
) -> Tuple[Dict[str, Any], List[Tuple[str, tuple, int, int]], int, Any]:
    """Parse a GGUF file → (metadata, tensor_infos, data_start, raw).

    tensor_infos entries are (name, numpy_shape, ggml_type, offset);
    GGUF stores dims fastest-varying-first, so the numpy shape is the
    reverse. ``raw`` is an mmap-backed buffer: metadata-only callers
    (config, tokenizer) touch header pages only, and weight loads page
    tensor data in lazily instead of slurping a multi-GB file three
    times at startup.
    """
    import mmap

    with open(path, "rb") as f:
        try:
            raw = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        except (ValueError, OSError):
            raw = f.read()           # empty/special files: plain read
    mv = memoryview(raw)
    try:
        magic, version = struct.unpack_from("<II", mv, 0)
        if magic != GGUF_MAGIC:
            raise ValueError(f"{path!r} is not a GGUF file")
        if version not in (2, 3):
            raise ValueError(f"unsupported GGUF version {version}")
        n_tensors, n_kv = struct.unpack_from("<QQ", mv, 8)
        r = _Reader(mv)
        r.pos = 24
        metadata: Dict[str, Any] = {}
        for _ in range(n_kv):
            key = r.string()
            vtype = r.scalar(_T_U32)
            metadata[key] = r.value(vtype)
        infos = []
        for _ in range(n_tensors):
            name = r.string()
            n_dims = r.scalar(_T_U32)
            dims = [r.scalar(_T_U64) for _ in range(n_dims)]
            ggml_type = r.scalar(_T_U32)
            offset = r.scalar(_T_U64)
            infos.append(
                (name, tuple(reversed(dims)), ggml_type, offset)
            )
    except struct.error as e:
        # truncated/corrupt file: surface as ValueError so every caller's
        # fallback path (ByteTokenizer, EvaluationError) engages
        raise ValueError(f"corrupt GGUF file {path!r}: {e}") from e
    align = int(metadata.get("general.alignment", 32))
    data_start = (r.pos + align - 1) // align * align
    return metadata, infos, data_start, raw


def _f16(blocks: np.ndarray, a: int) -> np.ndarray:
    """Column-pair [a:a+2] of a [N, bytes] uint8 block array as f32
    scales, shape [N, 1]."""
    return blocks[:, a: a + 2].copy().view(np.float16).astype(np.float32)


def _k_scale_min(scales: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Unpack the 12-byte 6-bit scale/min table shared by Q4_K/Q5_K
    (ggml get_scale_min_k4): 8 sub-block (scale, min) pairs, the high 2
    bits of entries 4..7 spilled into the top bits of bytes 0..7."""
    n = scales.shape[0]
    sc = np.empty((n, 8), np.float32)
    mn = np.empty((n, 8), np.float32)
    for j in range(4):
        sc[:, j] = scales[:, j] & 63
        mn[:, j] = scales[:, j + 4] & 63
    for j in range(4, 8):
        sc[:, j] = (scales[:, j + 4] & 0x0F) | ((scales[:, j - 4] >> 6) << 4)
        mn[:, j] = (scales[:, j + 4] >> 4) | ((scales[:, j] >> 6) << 4)
    return sc, mn


def _dequant_q2_k(blocks: np.ndarray) -> np.ndarray:
    n = blocks.shape[0]
    scales = blocks[:, 0:16]
    qs = blocks[:, 16:80]
    d, dmin = _f16(blocks, 80), _f16(blocks, 82)
    out = np.empty((n, 256), np.float32)
    for half in range(2):                       # 128-element halves
        q = qs[:, 32 * half: 32 * half + 32]
        for j in range(4):                      # 2-bit planes
            for sub in range(2):                # 16-element sub-blocks
                s = scales[:, 8 * half + 2 * j + sub: 8 * half + 2 * j + sub + 1]
                dl = d * (s & 0x0F)
                ml = dmin * (s >> 4)
                vals = (q[:, 16 * sub: 16 * sub + 16] >> (2 * j)) & 3
                out[:, 128 * half + 32 * j + 16 * sub:
                     128 * half + 32 * j + 16 * sub + 16] = dl * vals - ml
    return out


def _dequant_q3_k(blocks: np.ndarray) -> np.ndarray:
    n = blocks.shape[0]
    hmask = blocks[:, 0:32]
    qs = blocks[:, 32:96]
    raw_sc = blocks[:, 96:108]
    d = _f16(blocks, 108)
    # 6-bit scales: low 4 bits in bytes 0..7, high 2 bits packed in 8..11
    sc = np.empty((n, 16), np.float32)
    for j in range(16):
        if j < 8:
            lo = raw_sc[:, j] & 0x0F
        else:
            lo = raw_sc[:, j - 8] >> 4
        hi = (raw_sc[:, 8 + j % 4] >> (2 * (j // 4))) & 3
        sc[:, j] = (lo | (hi << 4)).astype(np.int8) - 32
    out = np.empty((n, 256), np.float32)
    is_ = 0
    for half in range(2):
        q = qs[:, 32 * half: 32 * half + 32]
        for j in range(4):
            m = 1 << (4 * half + j)
            for sub in range(2):
                dl = d[:, 0] * sc[:, is_]
                is_ += 1
                qsub = ((q[:, 16 * sub: 16 * sub + 16] >> (2 * j)) & 3
                        ).astype(np.int8)
                hm = hmask[:, 16 * sub: 16 * sub + 16]
                qsub = qsub - np.where((hm & m) != 0, 0, 4).astype(np.int8)
                out[:, 128 * half + 32 * j + 16 * sub:
                     128 * half + 32 * j + 16 * sub + 16] = (
                    dl[:, None] * qsub
                )
    return out


def _dequant_q4_k(blocks: np.ndarray) -> np.ndarray:
    d, dmin = _f16(blocks, 0), _f16(blocks, 2)
    sc, mn = _k_scale_min(blocks[:, 4:16])
    qs = blocks[:, 16:144]
    out = np.empty((blocks.shape[0], 256), np.float32)
    for c in range(4):                          # 64-element chunks
        q = qs[:, 32 * c: 32 * c + 32]
        out[:, 64 * c: 64 * c + 32] = (
            d * sc[:, [2 * c]] * (q & 0x0F) - dmin * mn[:, [2 * c]]
        )
        out[:, 64 * c + 32: 64 * c + 64] = (
            d * sc[:, [2 * c + 1]] * (q >> 4) - dmin * mn[:, [2 * c + 1]]
        )
    return out


def _dequant_q5_k(blocks: np.ndarray) -> np.ndarray:
    d, dmin = _f16(blocks, 0), _f16(blocks, 2)
    sc, mn = _k_scale_min(blocks[:, 4:16])
    qh = blocks[:, 16:48]
    qs = blocks[:, 48:176]
    out = np.empty((blocks.shape[0], 256), np.float32)
    for c in range(4):
        ql = qs[:, 32 * c: 32 * c + 32]
        h1 = ((qh >> (2 * c)) & 1) * 16
        h2 = ((qh >> (2 * c + 1)) & 1) * 16
        out[:, 64 * c: 64 * c + 32] = (
            d * sc[:, [2 * c]] * ((ql & 0x0F) + h1)
            - dmin * mn[:, [2 * c]]
        )
        out[:, 64 * c + 32: 64 * c + 64] = (
            d * sc[:, [2 * c + 1]] * ((ql >> 4) + h2)
            - dmin * mn[:, [2 * c + 1]]
        )
    return out


def _dequant_q6_k(blocks: np.ndarray) -> np.ndarray:
    n = blocks.shape[0]
    ql = blocks[:, 0:128]
    qh = blocks[:, 128:192]
    sc = blocks[:, 192:208].view(np.int8).astype(np.float32)
    d = _f16(blocks, 208)
    out = np.empty((n, 256), np.float32)

    def rep(s, i0):
        return np.repeat(s[:, i0: i0 + 2], 16, axis=1)   # sc[l//16 + i0]

    for half in range(2):                       # 128-element halves
        qlh = ql[:, 64 * half: 64 * half + 64]
        qhh = qh[:, 32 * half: 32 * half + 32]
        s = sc[:, 8 * half: 8 * half + 8]
        q1 = ((qlh[:, :32] & 0x0F) | (((qhh >> 0) & 3) << 4)).astype(
            np.int8
        ) - 32
        q2 = ((qlh[:, 32:] & 0x0F) | (((qhh >> 2) & 3) << 4)).astype(
            np.int8
        ) - 32
        q3 = ((qlh[:, :32] >> 4) | (((qhh >> 4) & 3) << 4)).astype(
            np.int8
        ) - 32
        q4 = ((qlh[:, 32:] >> 4) | (((qhh >> 6) & 3) << 4)).astype(
            np.int8
        ) - 32
        base = 128 * half
        out[:, base: base + 32] = d * rep(s, 0) * q1
        out[:, base + 32: base + 64] = d * rep(s, 2) * q2
        out[:, base + 64: base + 96] = d * rep(s, 4) * q3
        out[:, base + 96: base + 128] = d * rep(s, 6) * q4
    return out


def _dequantize(
    name: str, blob: np.ndarray, shape: tuple, ggml_type: int
) -> np.ndarray:
    """Dequantize one tensor's raw bytes → f32 array of ``shape``.

    K-quant super-block layouts follow ggml-quants.c (dequantize_row_*):
    256-element super-blocks with 6-bit (Q4_K/Q5_K), 4+2-bit packed
    (Q3_K), 4-bit (Q2_K), or int8 (Q6_K) sub-block scales. These are the
    formats real-world GGUF checkpoints actually ship (Q4_K_M et al.) —
    reference role: llama-box serves them via ggml, here they load into
    the same jitted TPU transformer as safetensors."""
    n = int(np.prod(shape))
    if ggml_type == GGML_F32:
        return blob.view(np.float32)[:n].reshape(shape)
    if ggml_type == GGML_F16:
        return blob.view(np.float16)[:n].astype(np.float32).reshape(shape)
    if ggml_type == GGML_BF16:
        u32 = blob.view(np.uint16)[:n].astype(np.uint32) << 16
        return u32.view(np.float32).reshape(shape)
    if ggml_type == GGML_Q8_0:
        # blocks of 32: f16 scale + 32×int8
        blocks = blob.reshape(-1, 34)
        d = _f16(blocks, 0)
        q = blocks[:, 2:].view(np.int8).astype(np.float32)
        return (q * d).reshape(-1)[:n].reshape(shape)
    if ggml_type in (GGML_Q4_0, GGML_Q4_1):
        bs = 18 if ggml_type == GGML_Q4_0 else 20
        blocks = blob.reshape(-1, bs)
        d = _f16(blocks, 0)
        qs = blocks[:, bs - 16:]
        lo = (qs & 0x0F).astype(np.float32)
        hi = (qs >> 4).astype(np.float32)
        q = np.concatenate([lo, hi], axis=1)          # [blocks, 32]
        if ggml_type == GGML_Q4_0:
            vals = (q - 8.0) * d
        else:
            m = _f16(blocks, 2)
            vals = q * d + m
        return vals.reshape(-1)[:n].reshape(shape)
    if ggml_type in (GGML_Q5_0, GGML_Q5_1):
        bs = 22 if ggml_type == GGML_Q5_0 else 24
        blocks = blob.reshape(-1, bs)
        d = _f16(blocks, 0)
        qh = (
            blocks[:, bs - 20: bs - 16].copy().view(np.uint32)
            .astype(np.uint64)
        )
        qs = blocks[:, bs - 16:]
        bits = (qh[:, 0:1] >> np.arange(32, dtype=np.uint64)) & 1
        lo = (qs & 0x0F) | (bits[:, :16] << 4).astype(np.uint8)
        hi = (qs >> 4) | (bits[:, 16:] << 4).astype(np.uint8)
        q = np.concatenate([lo, hi], axis=1).astype(np.float32)
        if ggml_type == GGML_Q5_0:
            vals = (q - 16.0) * d
        else:
            vals = q * d + _f16(blocks, 2)
        return vals.reshape(-1)[:n].reshape(shape)
    kdeq = {
        GGML_Q2_K: _dequant_q2_k,
        GGML_Q3_K: _dequant_q3_k,
        GGML_Q4_K: _dequant_q4_k,
        GGML_Q5_K: _dequant_q5_k,
        GGML_Q6_K: _dequant_q6_k,
    }.get(ggml_type)
    if kdeq is not None:
        _, bs = _BLOCK_BYTES[ggml_type]
        vals = kdeq(blob.reshape(-1, bs))
        return vals.reshape(-1)[:n].reshape(shape)
    raise ValueError(
        f"GGUF tensor {name!r} uses unsupported quantization "
        f"{_TYPE_NAMES.get(ggml_type, ggml_type)}; supported: F32/F16/"
        "BF16/Q8_0/Q4_0/Q4_1/Q5_0/Q5_1/Q2_K/Q3_K/Q4_K/Q5_K/Q6_K"
    )


def _type_bytes(shape: tuple, ggml_type: int) -> int:
    n = int(np.prod(shape))
    if ggml_type == GGML_F32:
        return n * 4
    if ggml_type in (GGML_F16, GGML_BF16):
        return n * 2
    if ggml_type in _BLOCK_BYTES:
        elems, nbytes = _BLOCK_BYTES[ggml_type]
        return (n + elems - 1) // elems * nbytes
    raise ValueError(f"unsupported ggml type {ggml_type}")


# llama.cpp tensor names → the HF names the existing loader maps
# (engine/weights.py load_hf_checkpoint)
_NAME_MAP = {
    "token_embd.weight": "model.embed_tokens.weight",
    "output_norm.weight": "model.norm.weight",
    "output.weight": "lm_head.weight",
}
_BLK_MAP = {
    "attn_norm.weight": "input_layernorm.weight",
    "attn_q.weight": "self_attn.q_proj.weight",
    "attn_k.weight": "self_attn.k_proj.weight",
    "attn_v.weight": "self_attn.v_proj.weight",
    "attn_output.weight": "self_attn.o_proj.weight",
    "attn_q.bias": "self_attn.q_proj.bias",
    "attn_k.bias": "self_attn.k_proj.bias",
    "attn_v.bias": "self_attn.v_proj.bias",
    "attn_q_norm.weight": "self_attn.q_norm.weight",
    "attn_k_norm.weight": "self_attn.k_norm.weight",
    "ffn_norm.weight": "post_attention_layernorm.weight",
    "ffn_gate.weight": "mlp.gate_proj.weight",
    "ffn_up.weight": "mlp.up_proj.weight",
    "ffn_down.weight": "mlp.down_proj.weight",
}
_SKIP = ("rope_freqs.weight", "rope_factors.weight")


def _map_name(name: str) -> Optional[str]:
    if name in _NAME_MAP:
        return _NAME_MAP[name]
    if name in _SKIP:
        return None
    if name.startswith("blk."):
        _, layer, rest = name.split(".", 2)
        if rest in _BLK_MAP:
            return f"model.layers.{layer}.{_BLK_MAP[rest]}"
        if "shexp" in rest:
            # Qwen2-MoE-class shared experts: fused shexp tensors are
            # not mapped yet — loud, not silently dropped
            raise ValueError(
                "GGUF shared-expert (shexp) checkpoints are not "
                f"supported yet (tensor {name!r}); use the safetensors "
                "export"
            )
        if re.match(r"ffn_(gate|up|down)\.\d+\.weight$", rest):
            # legacy per-expert MoE layout (pre-fused llama.cpp
            # exports, e.g. early Mixtral GGUFs): silently warn-dropping
            # these would surface as a cryptic KeyError after minutes
            # of dequantizing a multi-GB file
            raise ValueError(
                "legacy per-expert MoE GGUF layout is not supported "
                f"(tensor {name!r}); re-export with a current "
                "llama.cpp (fused ffn_*_exps tensors) or use the "
                "safetensors checkpoint"
            )
        if rest == "ffn_gate_inp.weight":
            return f"model.layers.{layer}.mlp.gate.weight"
    logger.warning("ignoring unrecognized GGUF tensor %r", name)
    return None


# fused MoE expert tensors (llama.cpp exports one 3-D tensor per
# projection, experts stacked on the slowest axis after dim reversal:
# gate/up [E, F, D], down [E, D, F]) → the per-expert HF names
# build_lm_params already maps
_EXPS_MAP = {
    "ffn_gate_exps.weight": "gate_proj",
    "ffn_up_exps.weight": "up_proj",
    "ffn_down_exps.weight": "down_proj",
}


def _reverse_llama_permute(w: np.ndarray, n_head: int) -> np.ndarray:
    """Undo convert_hf_to_gguf's rotary permutation of q/k weights.

    llama-arch exports interleave head rows for GGML's rotary layout;
    this engine applies HF rotate_half RoPE, so the permutation must be
    reversed on load (the same fix transformers' own GGUF loader
    applies) — without it every real llama/mistral .gguf serves
    garbage attention."""
    out = w.shape[0]
    dim = out // n_head // 2
    return (
        w.reshape(n_head, dim, 2, *w.shape[1:])
        .swapaxes(1, 2)
        .reshape(w.shape)
    )


def gguf_shard_paths(
    path: str, first_parse=None
) -> List[str]:
    """All files of a (possibly split) GGUF checkpoint, first shard
    first.

    gguf-split writes ``split.count``/``split.no`` metadata and names
    shards ``<base>-00001-of-0000N.gguf``; every shard must be present
    (reference role: gguf-parser resolves splits the same way for
    sizing). A checkpoint without split metadata is its own single
    shard. ``first_parse`` lets callers that already read ``path``
    (read_gguf result tuple) avoid a second full metadata parse — the
    KV section can embed a 100k+-entry tokenizer vocab."""
    metadata = (first_parse or read_gguf(path))[0]
    count = int(metadata.get("split.count", 1) or 1)
    if count <= 1:
        return [path]
    m = re.search(r"-(\d{5})-of-(\d{5})\.gguf$", path)
    if not m:
        raise ValueError(
            f"{path!r} declares split.count={count} but is not named "
            "like gguf-split output (<base>-00001-of-0000N.gguf)"
        )
    base = path[: m.start()]
    total = int(m.group(2))
    if total != count:
        raise ValueError(
            f"{path!r}: filename says {total} shards, metadata says "
            f"{count}"
        )
    shards = [
        f"{base}-{i + 1:05d}-of-{total:05d}.gguf" for i in range(total)
    ]
    missing = [s for s in shards if not os.path.exists(s)]
    if missing:
        raise ValueError(
            f"split GGUF is missing shard(s): {missing}"
        )
    return shards


def _tensor_data(
    name: str, shape: tuple, ggml_type: int, offset: int,
    data_start: int, raw,
) -> np.ndarray:
    """One tensor's dequantized f32 data from a parsed shard."""
    buf = np.frombuffer(raw, np.uint8)
    start = data_start + offset
    blob = buf[start: start + _type_bytes(shape, ggml_type)]
    return _dequantize(name, blob, shape, ggml_type)


def load_gguf_tensors(path: str) -> Dict[str, Any]:
    """GGUF file (or first shard of a split checkpoint) → {hf_name:
    torch tensor} for load_hf_checkpoint's mapping machinery. llama.cpp
    2-D weights are [out, in] after dim reversal — the same layout as
    torch linear weights, so the existing transpose-on-load convention
    applies unchanged.

    Model metadata (arch, head counts) comes from shard 1 ONLY:
    gguf-split writes the model KV section just there, so per-shard
    metadata reads would silently skip the llama q/k un-permute for
    tensors living in later shards."""
    import torch

    first = read_gguf(path)
    shards = gguf_shard_paths(path, first_parse=first)
    metadata = first[0]
    arch = metadata.get("general.architecture", "llama")
    n_head = int(metadata.get(f"{arch}.attention.head_count", 0))
    n_kv = int(
        metadata.get(f"{arch}.attention.head_count_kv", n_head)
    )
    tensors: Dict[str, Any] = {}
    for shard in shards:
        _, infos, data_start, raw = (
            first if shard == path else read_gguf(shard)
        )
        for name, shape, ggml_type, offset in infos:
            # single parse point: fused-exps dispatch and _map_name see
            # the same (layer, rest) split
            layer = rest = ""
            if name.startswith("blk."):
                _, layer, rest = name.split(".", 2)
            if rest in _EXPS_MAP:
                fused = _tensor_data(
                    name, shape, ggml_type, offset, data_start, raw
                )
                proj = _EXPS_MAP[rest]
                for e in range(fused.shape[0]):
                    tensors[
                        f"model.layers.{layer}.mlp.experts.{e}"
                        f".{proj}.weight"
                    ] = torch.from_numpy(fused[e].copy())
                continue
            hf_name = _map_name(name)
            if hf_name is None:
                continue
            arr = _tensor_data(
                name, shape, ggml_type, offset, data_start, raw
            ).copy()
            if arch == "llama" and n_head:
                # only llama-arch exports permute q/k (qwen2/gemma don't)
                if name.endswith("attn_q.weight"):
                    arr = _reverse_llama_permute(arr, n_head)
                elif name.endswith("attn_k.weight"):
                    arr = _reverse_llama_permute(arr, n_kv)
            tensors[hf_name] = torch.from_numpy(arr)
    return tensors


def gguf_file_in(model_dir: str) -> Optional[str]:
    """The .gguf file for a model source: the path itself, or the first
    .gguf in the directory (for gguf-split checkpoints the sorted order
    puts the -00001-of-N shard first; gguf_shard_paths resolves the
    rest)."""
    if model_dir and model_dir.endswith(".gguf"):
        return model_dir if os.path.exists(model_dir) else None
    if model_dir and os.path.isdir(model_dir):
        files = sorted(
            f for f in os.listdir(model_dir) if f.endswith(".gguf")
        )
        if files:
            return os.path.join(model_dir, files[0])
    return None


def config_from_gguf(path: str, name: str = ""):
    """GGUF metadata → ModelConfig (reference role: gguf-parser's
    architecture extraction feeding the scheduler).

    Rope scaling is carried two ways by llama.cpp exports and both are
    honored: ``{arch}.rope.scaling.*`` metadata (linear/yarn), and the
    ``rope_freqs.weight`` tensor (Llama-3.1-class llama3 scaling, shipped
    as precomputed per-frequency divisors instead of metadata). Ignoring
    either would serve long prompts with unscaled RoPE — silently wrong
    beyond the original context window — while advertising the scaled
    ``context_length``."""
    from gpustack_tpu_torch.models.config import ModelConfig

    first = read_gguf(path)
    shards = gguf_shard_paths(path, first_parse=first)
    metadata, infos, data_start, raw = first
    # tensor presence checks (tied embeddings, bias, rope_freqs) must see
    # the WHOLE checkpoint; gguf-split puts full metadata in shard 1 but
    # spreads tensors across every shard
    shard_infos = {shards[0]: (infos, data_start, raw)}
    for extra in shards[1:]:
        m2, i2, ds2, raw2 = read_gguf(extra)
        shard_infos[extra] = (i2, ds2, raw2)
        infos = infos + i2
    arch = metadata.get("general.architecture", "llama")
    if arch.startswith("deepseek"):
        # llama.cpp's deepseek2 export uses MLA-specific tensor names
        # and its own cache layout; the mapping here doesn't cover it
        raise ValueError(
            f"GGUF arch {arch!r} is not supported; serve DeepSeek from "
            "the safetensors checkpoint (MLA is natively supported "
            "there)"
        )

    def md(key: str, default=None):
        return metadata.get(f"{arch}.{key}", default)

    hidden = int(md("embedding_length", 0))
    heads = int(md("attention.head_count", 0))
    if not hidden or not heads:
        raise ValueError(
            f"GGUF {path!r} lacks {arch}.embedding_length/"
            "attention.head_count metadata"
        )
    kv_heads = int(md("attention.head_count_kv", heads))
    vocab = int(md("vocab_size", 0)) or len(
        metadata.get("tokenizer.ggml.tokens", [])
    )
    if not vocab:
        vocab = next(
            (
                int(shape[0]) for tname, shape, _t, _o in infos
                if tname == "token_embd.weight"
            ),
            32000,
        )
    tensor_names = {t[0] for t in infos}

    # MoE metadata (mixtral exports under arch "llama" with
    # expert_count set; qwen3moe under its own arch). Weight routing:
    # softmax over the selected experts with renormalization — the
    # semantics both mixtral and qwen3moe use.
    num_experts = int(md("expert_count", 0) or 0)
    num_experts_per_tok = int(md("expert_used_count", 0) or 0)
    moe_inter = int(
        md("expert_feed_forward_length", 0)
        or md("feed_forward_length", 0)
    )

    rope_scaling = None
    rs_type = md("rope.scaling.type")
    if rs_type == "linear":
        rope_scaling = {
            "rope_type": "linear",
            "factor": float(md("rope.scaling.factor", 1.0)),
        }
    elif rs_type == "yarn":
        rope_scaling = {
            "rope_type": "yarn",
            "factor": float(md("rope.scaling.factor", 1.0)),
            "original_max_position_embeddings": int(
                md("rope.scaling.original_context_length", 0)
                or md("context_length", 4096)
            ),
        }
    elif rs_type not in (None, "none"):
        raise ValueError(
            f"GGUF {path!r} declares unsupported rope scaling type "
            f"{rs_type!r}"
        )
    if "rope_freqs.weight" in tensor_names:
        # Llama-3.1-style exports: the blended llama3 divisors ship as a
        # tensor; load them now (always F32, head_dim/2 floats) so the
        # rope tables divide by them (transformer.rope_params)
        for spath, (s_infos, s_start, s_raw) in shard_infos.items():
            hit = next(
                (t for t in s_infos if t[0] == "rope_freqs.weight"), None
            )
            if hit is None:
                continue
            tname, shape, ggml_type, offset = hit
            factors = _tensor_data(
                tname, shape, ggml_type, offset, s_start, s_raw
            )
            rope_scaling = dict(rope_scaling or {})
            rope_scaling.setdefault("rope_type", "llama3")
            rope_scaling["factors"] = [
                float(x) for x in np.asarray(factors).reshape(-1)
            ]
            break

    return ModelConfig(
        name=name or os.path.basename(path),
        vocab_size=vocab,
        hidden_size=hidden,
        intermediate_size=int(md("feed_forward_length", 4 * hidden)),
        num_layers=int(md("block_count", 1)),
        num_heads=heads,
        num_kv_heads=kv_heads,
        head_dim=int(md("attention.key_length", hidden // heads)),
        rope_theta=float(md("rope.freq_base", 10000.0)),
        rope_scaling=rope_scaling,
        rms_norm_eps=float(md("attention.layer_norm_rms_epsilon", 1e-5)),
        max_position_embeddings=int(md("context_length", 8192)),
        tie_word_embeddings="output.weight" not in tensor_names,
        qkv_bias="blk.0.attn_q.bias" in tensor_names,
        qk_norm="blk.0.attn_q_norm.weight" in tensor_names,
        num_experts=num_experts,
        num_experts_per_tok=num_experts_per_tok,
        moe_intermediate_size=moe_inter if num_experts else 0,
        norm_topk_prob=True,
    )


def _gpt2_byte_tables():
    """OpenAI's bytes↔unicode bijection (gpt2 BPE vocab encoding)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(0xA1, 0xAD))
        + list(range(0xAE, 0x100))
    )
    cs = list(bs)
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    byte_to_uni = {b: chr(c) for b, c in zip(bs, cs)}
    uni_to_byte = {chr(c): b for b, c in zip(bs, cs)}
    return byte_to_uni, uni_to_byte


class GGUFVocabTokenizer:
    """Tokenizer from the GGUF's embedded vocab.

    Two vocab conventions are handled per ``tokenizer.ggml.model``:
    SentencePiece (``llama``: ``▁`` word boundary, ``<0xNN>`` byte
    tokens) and gpt2-style BPE (``gpt2``: byte↔unicode mapped pieces,
    ``Ġ`` spaces — Llama-3/Qwen exports). Decoding is exact for both.
    Encoding is greedy longest-match over the vocab — NOT a merge-order
    BPE replay, so boundaries can differ from the original tokenizer on
    rare strings (a tokenizer.json sidecar gives exact encoding;
    engine/tokenizer.py prefers it)."""

    def __init__(self, metadata: Dict[str, Any]):
        self.tokens: List[str] = metadata["tokenizer.ggml.tokens"]
        self.model = metadata.get("tokenizer.ggml.model", "llama")
        self.vocab_size = len(self.tokens)
        eos = int(metadata.get("tokenizer.ggml.eos_token_id", 2))
        bos = metadata.get("tokenizer.ggml.bos_token_id")
        self.bos_id = int(bos) if bos is not None else None
        self.eos_ids = (eos,)
        self._index = {t: i for i, t in enumerate(self.tokens)}
        self._max_len = max((len(t) for t in self.tokens), default=1)
        self._b2u, self._u2b = _gpt2_byte_tables()

    @classmethod
    def from_file(cls, path: str) -> "GGUFVocabTokenizer":
        metadata, _, _, _ = read_gguf(path)
        if "tokenizer.ggml.tokens" not in metadata:
            raise ValueError(f"GGUF {path!r} embeds no tokenizer vocab")
        return cls(metadata)

    def encode(self, text: str) -> List[int]:
        if self.model == "gpt2":
            # gpt2 vocabs store pieces in the byte→unicode mapping;
            # transform the text the same way, then longest-match
            piece_text = "".join(
                self._b2u[b] for b in text.encode("utf-8")
            )
        else:
            piece_text = "▁" + text.replace(" ", "▁")
        ids: List[int] = []
        if self.bos_id is not None:
            ids.append(self.bos_id)
        i = 0
        while i < len(piece_text):
            match = None
            for ln in range(
                min(self._max_len, len(piece_text) - i), 0, -1
            ):
                cand = piece_text[i: i + ln]
                tid = self._index.get(cand)
                if tid is not None:
                    match = (tid, ln)
                    break
            if match is None:
                # fall back to byte tokens for unknown chars; the word
                # boundary marker is OUR insertion — as bytes it must be
                # the space it stands for, not literal '▁'
                ch = " " if piece_text[i] == "▁" else piece_text[i]
                for b in ch.encode("utf-8"):
                    tid = self._index.get(f"<0x{b:02X}>")
                    if tid is not None:
                        ids.append(tid)
                i += 1
                continue
            ids.append(match[0])
            i += match[1]
        return ids

    def apply_chat_template(
        self, messages: List[dict], tools: Optional[List[dict]] = None,
    ) -> List[int]:
        """Generic role-tag template (same shape as the hermetic byte
        tokenizer's): a GGUF file carries no jinja chat template, so
        serving uses the neutral format rather than guessing a family's."""
        from gpustack_tpu_torch.engine.tokenizer import (
            _content_text,
            _inject_tools_fallback,
        )

        messages = _inject_tools_fallback(messages, tools)
        text = "".join(
            f"<{m['role']}>{_content_text(m)}</{m['role']}>"
            for m in messages
        ) + "<assistant>"
        return self.encode(text)

    def decode(self, ids) -> str:
        if self.model == "gpt2":
            # reverse the byte↔unicode bijection over concatenated pieces
            byte_out = bytearray()
            for tid in ids:
                if not 0 <= int(tid) < self.vocab_size:
                    continue
                tok = self.tokens[int(tid)]
                if tok.startswith("<|") and tok.endswith("|>"):
                    continue         # control tokens render as nothing
                for ch in tok:
                    b = self._u2b.get(ch)
                    if b is None:
                        byte_out.extend(ch.encode("utf-8"))
                    else:
                        byte_out.append(b)
            return byte_out.decode("utf-8", errors="replace")
        out: List[str] = []
        byte_buf: List[int] = []

        def flush_bytes():
            if byte_buf:
                out.append(
                    bytes(byte_buf).decode("utf-8", errors="replace")
                )
                byte_buf.clear()

        for tid in ids:
            if not 0 <= int(tid) < self.vocab_size:
                continue
            tok = self.tokens[int(tid)]
            if (
                len(tok) == 6
                and tok.startswith("<0x")
                and tok.endswith(">")
            ):
                byte_buf.append(int(tok[3:5], 16))
                continue
            flush_bytes()
            if tok.startswith("<") and tok.endswith(">"):
                continue             # control tokens render as nothing
            out.append(tok.replace("▁", " "))
        flush_bytes()
        text = "".join(out)
        return text[1:] if text.startswith(" ") else text
