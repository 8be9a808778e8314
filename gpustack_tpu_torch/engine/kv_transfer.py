"""Content-addressed KV block frames: the wire and spill-file codec.

The port's copy of ``gpustack_tpu/engine/kv_transfer.py``: the frame
codec, cache export/import, tier conversion and the handoff accounting
(``SecondsHist``, ``HandoffStats``). The server's ``/kv/*`` routes stream
these frames between engines (a prefill-role replica hands a prompt's
blocks to a decode-role one), the disk spill tier (``kv_spill.py``) stores
one frame per file, and the host cache's fault-back converts frames back
into its storage tier.

Wire format — a stream of self-describing frames, no stream trailer (the
decoder yields every frame whose bytes fully arrived, so a peer dying
mid-stream loses only the tail):

    magic   b"GKVX1\\n"                     (once, start of stream)
    frame   u32 meta_len | meta JSON | k bytes | v bytes
            | k_scale bytes | v_scale bytes

``meta`` carries the block's chain key (hex — advisory; the importer
recomputes keys from tokens), its tokens, dtype/shape info, explicit
payload byte lengths, and a crc32 of the payload. int8 blocks travel as
stored (int8 + float32 scales). A frame may be ``skipped`` (tokens only,
no payload).

bf16 blocks are ``uint16`` bit patterns on the host (``host_bf16``) and
are named ``"bfloat16"`` in the meta, so a frame this module encodes is
byte for byte the frame the JAX package encodes for the same K/V, and
each decodes the other's.

A multi-GPU replica's ranks each hold their part of every block: their
KV heads (axis 2 of ``[L, T, H, hd]``, and of the int8 scales ``[L, 1,
H, 1]``) and, under ``sp``, their stripe of its tokens (axis 1; the
scales stay the whole block's). :func:`join_parts` makes one whole
exported block of the ranks' parts, :func:`slice_part` cuts a prepared
block to a rank's part, and :func:`pack_arrays` / :func:`unpack_arrays`
lay a run of blocks out as one byte buffer for the move between ranks.
The frames stay whole blocks, as one process writes them.
"""

from __future__ import annotations

import binascii
import dataclasses
import json
import struct
import threading
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from gpustack_tpu_torch.engine.host_bf16 import BF16, is_bf16

MAGIC = b"GKVX1\n"
_U32 = struct.Struct("<I")

# one frame's meta must stay far under this; a larger announced meta is
# a corrupt or hostile stream, not a big block
MAX_META_BYTES = 1 << 20


def _dtype_name(dtype) -> str:
    return "bfloat16" if is_bf16(dtype) else np.dtype(dtype).name


def _dtype_from_name(name: str) -> np.dtype:
    return BF16 if name == "bfloat16" else np.dtype(name)


@dataclasses.dataclass
class Frame:
    """One decoded wire frame (``skipped`` frames carry no arrays)."""

    key: str                      # hex chain key (advisory)
    tokens: Tuple[int, ...]
    skipped: bool = False
    k: Optional[np.ndarray] = None
    v: Optional[np.ndarray] = None
    k_scale: Optional[np.ndarray] = None
    v_scale: Optional[np.ndarray] = None
    dtype: str = ""               # logical (dequantized) dtype name
    nbytes: int = 0               # payload bytes on the wire


def _array_bytes(arr: Optional[np.ndarray]) -> bytes:
    if arr is None:
        return b""
    return np.ascontiguousarray(arr).tobytes()


def encode_stream(frames: Iterable[bytes]) -> Iterator[bytes]:
    """Prepend the magic; yield each encoded frame."""
    yield MAGIC
    yield from frames


def encode_frame(
    key_hex: str,
    tokens,
    *,
    k: Optional[np.ndarray] = None,
    v: Optional[np.ndarray] = None,
    k_scale: Optional[np.ndarray] = None,
    v_scale: Optional[np.ndarray] = None,
    dtype: str = "",
) -> bytes:
    """One block → one wire frame. ``k is None`` encodes a skipped
    (dedup) frame."""
    kb, vb = _array_bytes(k), _array_bytes(v)
    ksb, vsb = _array_bytes(k_scale), _array_bytes(v_scale)
    payload = kb + vb + ksb + vsb
    meta: Dict[str, Any] = {
        "key": key_hex,
        "tokens": [int(t) for t in tokens],
    }
    if k is None:
        meta["skipped"] = True
    else:
        meta.update(
            dtype=dtype or _dtype_name(k.dtype),
            stored_dtype=_dtype_name(k.dtype),
            k_shape=list(k.shape),
            v_shape=list(v.shape),
            k_len=len(kb),
            v_len=len(vb),
            ks_len=len(ksb),
            vs_len=len(vsb),
            crc=binascii.crc32(payload) & 0xFFFFFFFF,
        )
        if k_scale is not None:
            meta["ks_shape"] = list(k_scale.shape)
            meta["vs_shape"] = list(v_scale.shape)
    mb = json.dumps(meta, separators=(",", ":")).encode()
    return _U32.pack(len(mb)) + mb + payload


class FrameDecoder:
    """Incremental decoder: ``feed(chunk)`` yields every frame whose
    bytes fully arrived. A truncated tail is simply never yielded; a
    corrupt frame (bad magic, oversized meta, crc mismatch) raises
    ``ValueError``."""

    def __init__(self) -> None:
        self._buf = bytearray()
        self._magic_seen = False

    def feed(self, chunk: bytes) -> List[Frame]:
        self._buf.extend(chunk)
        out: List[Frame] = []
        if not self._magic_seen:
            if len(self._buf) < len(MAGIC):
                return out
            if bytes(self._buf[: len(MAGIC)]) != MAGIC:
                raise ValueError("kv-transfer: bad stream magic")
            del self._buf[: len(MAGIC)]
            self._magic_seen = True
        while True:
            frame = self._try_frame()
            if frame is None:
                return out
            out.append(frame)

    def _try_frame(self) -> Optional[Frame]:
        if len(self._buf) < _U32.size:
            return None
        (meta_len,) = _U32.unpack(bytes(self._buf[: _U32.size]))
        if meta_len > MAX_META_BYTES:
            raise ValueError(
                f"kv-transfer: frame meta of {meta_len} bytes exceeds "
                f"the {MAX_META_BYTES} cap"
            )
        if len(self._buf) < _U32.size + meta_len:
            return None
        meta = json.loads(
            bytes(self._buf[_U32.size : _U32.size + meta_len])
        )
        if meta.get("skipped"):
            del self._buf[: _U32.size + meta_len]
            return Frame(
                key=str(meta.get("key", "")),
                tokens=tuple(int(t) for t in meta["tokens"]),
                skipped=True,
            )
        payload_len = (
            meta["k_len"] + meta["v_len"]
            + meta.get("ks_len", 0) + meta.get("vs_len", 0)
        )
        total = _U32.size + meta_len + payload_len
        if len(self._buf) < total:
            return None
        payload = bytes(self._buf[_U32.size + meta_len : total])
        del self._buf[:total]
        if (binascii.crc32(payload) & 0xFFFFFFFF) != meta.get("crc"):
            raise ValueError("kv-transfer: frame crc mismatch")
        off = 0

        def take(n: int, shape, dtype) -> Optional[np.ndarray]:
            nonlocal off
            if n == 0:
                return None
            raw = payload[off : off + n]
            off += n
            return np.frombuffer(raw, dtype=dtype).reshape(shape)

        stored = _dtype_from_name(
            meta.get("stored_dtype") or meta["dtype"]
        )
        k = take(meta["k_len"], meta["k_shape"], stored)
        v = take(meta["v_len"], meta["v_shape"], stored)
        ks = take(
            meta.get("ks_len", 0), meta.get("ks_shape"), np.float32
        )
        vs = take(
            meta.get("vs_len", 0), meta.get("vs_shape"), np.float32
        )
        return Frame(
            key=str(meta.get("key", "")),
            tokens=tuple(int(t) for t in meta["tokens"]),
            k=k, v=v, k_scale=ks, v_scale=vs,
            dtype=meta["dtype"],
            nbytes=payload_len,
        )


def decode_stream(data: bytes) -> List[Frame]:
    """Whole-buffer convenience over :class:`FrameDecoder`."""
    return FrameDecoder().feed(data)


# ---------------------------------------------------------------------------
# Cache-facing export / import
# ---------------------------------------------------------------------------


def encode_block(blk: Dict[str, Any], have_set) -> Tuple[bytes, bool]:
    """One exported cache block → ``(wire frame, carried_payload)``: a
    block the requester already holds travels as a token-only dedup frame
    (payload False)."""
    if blk["key"] in have_set:
        return encode_frame(blk["key"], blk["tokens"]), False
    return (
        encode_frame(
            blk["key"], blk["tokens"],
            k=blk["k"], v=blk["v"],
            k_scale=blk["k_scale"], v_scale=blk["v_scale"],
            dtype=blk["dtype"],
        ),
        True,
    )


def export_frames(
    cache,
    prompt_ids,
    have: Optional[Iterable[str]] = None,
    max_blocks: int = 0,
) -> Iterator[bytes]:
    """Encode ``cache``'s matched block run for ``prompt_ids`` as wire
    frames AS STORED, eliding payloads for blocks whose chain key the
    requester declared in ``have``."""
    have_set = frozenset(have or ())
    blocks = cache.export_blocks(prompt_ids, max_blocks=max_blocks)
    yield from encode_stream(encode_block(b, have_set)[0] for b in blocks)


def prepare_import(
    cache, frames: List[Frame]
) -> Tuple[List[int], Dict[int, Tuple], int]:
    """Decoded frames in the receiving cache's storage tier: ``(token_chain,
    prepared_blocks, wire_bytes)`` for ``cache.import_blocks`` or the
    engine's stager-backed ``kv_import_prepared``. CPU work only. Every
    frame must carry the cache's block granularity: ``import_blocks``
    re-slices the token chain by its own ``block_tokens``, so a peer with
    another block size would attach K/V to the wrong token runs; it is
    refused here instead (callers fall back to a cold prefill)."""
    tokens: List[int] = []
    prepared: Dict[int, Tuple] = {}
    bytes_in = 0
    for i, fr in enumerate(frames):
        if len(fr.tokens) != cache.block_tokens:
            raise ValueError(
                f"kv-transfer: frame of {len(fr.tokens)} tokens does "
                f"not match the cache's block_tokens="
                f"{cache.block_tokens} (peer block-size mismatch)"
            )
        tokens.extend(fr.tokens)
        if fr.skipped:
            continue
        bytes_in += fr.nbytes
        prepared[i] = _to_cache_tier(cache, fr)
    return tokens, prepared, bytes_in


def import_frames(cache, frames: List[Frame]) -> Tuple[int, int, int]:
    """Land decoded frames in ``cache``: rebuild the token chain (keys are
    recomputed from tokens), convert payloads to the cache's tier, attach.
    Returns ``(blocks_attached, tokens, bytes_in)``. A skipped frame for a
    block the cache does not hold ends the run."""
    if not frames:
        return 0, 0, 0
    tokens, prepared, bytes_in = prepare_import(cache, frames)
    attached = cache.import_blocks(tokens, prepared)
    return attached, len(tokens), bytes_in


def _to_cache_tier(cache, fr: Frame) -> Tuple:
    """(k, v, scales|None, dtype, nbytes) in the receiving cache's
    storage tier."""
    from gpustack_tpu_torch.engine.kv_host_cache import (
        _dequantize_block,
        _quantize_block,
    )

    logical = _dtype_from_name(fr.dtype)
    is_int8 = fr.k_scale is not None
    if cache.int8:
        if is_int8:
            k, v, scales = fr.k, fr.v, (fr.k_scale, fr.v_scale)
        else:
            qk, sk = _quantize_block(fr.k)
            qv, sv = _quantize_block(fr.v)
            k, v, scales = qk, qv, (sk, sv)
        nbytes = (
            k.nbytes + v.nbytes
            + scales[0].nbytes + scales[1].nbytes
        )
        return k, v, scales, logical, nbytes
    if is_int8:
        k = _dequantize_block(fr.k, fr.k_scale, logical)
        v = _dequantize_block(fr.v, fr.v_scale, logical)
    else:
        k, v = fr.k, fr.v
    k = np.ascontiguousarray(k)
    v = np.ascontiguousarray(v)
    return k, v, None, logical, k.nbytes + v.nbytes


# ---------------------------------------------------------------------------
# Blocks split and joined over KV heads and sp stripes (a replica's ranks)
# ---------------------------------------------------------------------------

_TOKEN_AXIS = 1               # [L, T, H, hd]; the scales' [L, 1, H, 1]
_HEAD_AXIS = 2


def block_arrays(k, v, scales) -> List[np.ndarray]:
    """A block's arrays in wire order: k, v and any int8 scales."""
    return [k, v] + ([] if scales is None else list(scales))


def slice_part(prep: Tuple, heads: Tuple[int, int],
               rows: Optional[Tuple[int, int]] = None) -> Tuple:
    """A prepared block ``(k, v, scales|None, dtype, nbytes)`` at KV heads
    ``heads`` ``[lo, hi)`` and token rows ``rows`` ``[a, b)`` (an ``sp``
    stripe; None: all), each array a contiguous copy, its bytes
    recounted. The int8 scales are per layer x head of the whole block,
    so they are cut at the heads alone, and the part is bit for bit what
    one process stores for those heads and rows."""
    k, v, scales, dtype, _ = prep
    (lo, hi), (a, b) = heads, rows or (0, k.shape[_TOKEN_AXIS])
    if (lo, hi, a, b) == (0, k.shape[_HEAD_AXIS], 0, k.shape[_TOKEN_AXIS]):
        return prep

    def cut(x):
        return np.ascontiguousarray(x[:, a:b, lo:hi])

    k, v = cut(k), cut(v)
    if scales is not None:
        scales = tuple(np.ascontiguousarray(x[:, :, lo:hi]) for x in scales)
    return (k, v, scales, dtype,
            sum(x.nbytes for x in block_arrays(k, v, scales)))


def join_parts(parts: List[Dict[str, Any]], heads: int) -> Dict[str, Any]:
    """One exported block (``HostKVCache.export_blocks``' dicts) from its
    parts, stripe by stripe and ``heads`` head parts a stripe, in head
    order (``Mesh.part_holders``' order): K and V joined over the heads
    within a stripe, then the stripes over the tokens; the int8 scales
    (the whole block's on every stripe) over the heads of the first
    stripe; the bytes recounted. Key, tokens and dtype are the first
    part's."""
    out = dict(parts[0])
    stripes = [parts[i:i + heads] for i in range(0, len(parts), heads)]
    for name in ("k", "v"):
        out[name] = np.concatenate([
            np.concatenate([p[name] for p in s], axis=_HEAD_AXIS)
            for s in stripes], axis=_TOKEN_AXIS)
    for name in ("k_scale", "v_scale"):
        if out[name] is not None:
            out[name] = np.concatenate([p[name] for p in stripes[0]],
                                       axis=_HEAD_AXIS)
    out["nbytes"] = sum(out[n].nbytes for n in ("k", "v", "k_scale",
                                                "v_scale")
                        if out[n] is not None)
    return out


def pack_arrays(arrays: List[np.ndarray],
                out: Optional[np.ndarray] = None) -> np.ndarray:
    """The arrays' bytes one after another (uint8), into ``out`` when
    given (a pinned buffer's view: one copy on the host)."""
    if out is None:
        out = np.empty(sum(a.nbytes for a in arrays), np.uint8)
    at = 0
    for a in arrays:
        out[at:at + a.nbytes] = np.ascontiguousarray(a).view(
            np.uint8).ravel()
        at += a.nbytes
    return out


def unpack_arrays(flat: np.ndarray, like) -> List[np.ndarray]:
    """:func:`pack_arrays` undone: ``like`` gives each array's
    ``(dtype, shape)``, in order; the arrays view ``flat``."""
    out, at = [], 0
    for dtype, shape in like:
        n = int(np.prod(shape)) * np.dtype(dtype).itemsize
        out.append(flat[at:at + n].view(dtype).reshape(shape))
        at += n
    if at != flat.size:
        raise ValueError(f"{flat.size} bytes for arrays of {at}")
    return out


# ---------------------------------------------------------------------------
# Handoff accounting (rendered by the server's /metrics)
# ---------------------------------------------------------------------------

HANDOFF_BUCKETS_S = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


class SecondsHist:
    """Fixed-bucket histogram with the engine's ``LatencyHistogram``
    ``snapshot()`` contract (the exporter renders both through one loop).
    Observed from request handler threads, so it takes a lock."""

    def __init__(self, buckets=HANDOFF_BUCKETS_S):
        self.buckets = tuple(buckets)
        self.counts = [0] * (len(self.buckets) + 1)
        self.total = 0.0
        self.count = 0
        self._mu = threading.Lock()

    def observe(self, value: float) -> None:
        with self._mu:
            self.total += value
            for i, ub in enumerate(self.buckets):
                if value <= ub:
                    self.counts[i] += 1
                    break
            else:
                self.counts[-1] += 1
            self.count += 1

    def snapshot(self):
        with self._mu:
            counts = list(self.counts)
            total, count = self.total, self.count
        cum, out = 0, []
        for ub, c in zip(self.buckets, counts):
            cum += c
            out.append((ub, cum))
        inf = cum + counts[-1]
        out.append((float("inf"), inf))
        return out, total, min(count, inf)


class HandoffStats:
    """Engine-side handoff accounting: wire bytes and blocks in either
    direction, failures, pulls and end-to-end pull seconds. Counter writes
    are single int adds from handler and kv-copy threads (atomic under the
    GIL); the histogram locks itself."""

    def __init__(self) -> None:
        self.bytes_in = 0
        self.bytes_out = 0
        self.blocks_in = 0
        self.blocks_out = 0
        self.failures = 0
        self.pulls = 0
        self.seconds = SecondsHist()

    def snapshot(self) -> Dict[str, Any]:
        return {
            "bytes_in": self.bytes_in,
            "bytes_out": self.bytes_out,
            "blocks_in": self.blocks_in,
            "blocks_out": self.blocks_out,
            "failures": self.failures,
            "pulls": self.pulls,
        }
