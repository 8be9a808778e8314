"""Images without PIL: a PNG decoder and a bicubic resize that reproduces
Pillow's ``Image.resize`` default (the vision path's input), and a PNG
encoder (the image server's output).

The JAX ``VisionBundle.preprocess`` calls
``PIL.Image.open(...).convert("RGB").resize((s, s))``. The card's machine
has no PIL, so the port decodes PNG itself (``zlib`` and ``struct``): bit
depth 8, colour types gray, RGB, RGBA and palette, no interlace, all five
row filters, every chunk's CRC checked. Alpha is dropped, as
``convert("RGB")`` drops it. Any other format is a ``ValueError`` that
names it (the API layer's 400).

:func:`resize_bicubic` is Pillow's separable resample (``libImaging/
Resample.c``) for 8-bit images: the bicubic kernel with a = -0.5, its
support widened by the downscale factor, coefficients normalised and
rounded to 22-bit fixed point, the horizontal pass first, each pass
rounded and clipped to uint8.
"""

from __future__ import annotations

import math
import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"

# leading bytes of the formats a client is likely to send instead
_OTHER_FORMATS = (
    (b"\xff\xd8\xff", "JPEG"),
    (b"GIF87a", "GIF"),
    (b"GIF89a", "GIF"),
    (b"BM", "BMP"),
    (b"II*\x00", "TIFF"),
    (b"MM\x00*", "TIFF"),
)

# colour type -> channels (bit depth 8); 3 is palette indices
_CHANNELS = {0: 1, 2: 3, 3: 1, 6: 4}
_COLOUR_NAMES = {0: "gray", 2: "RGB", 3: "palette", 4: "gray+alpha",
                 6: "RGBA"}

PRECISION_BITS = 32 - 8 - 2       # Pillow's fixed-point coefficients


def _image_format(data: bytes) -> str:
    """The format ``data`` starts with: ``"PNG"``, a named other format,
    or ``"unknown"``."""
    if data.startswith(PNG_SIGNATURE):
        return "PNG"
    if data[8:12] == b"WEBP" and data.startswith(b"RIFF"):
        return "WEBP"
    for magic, name in _OTHER_FORMATS:
        if data.startswith(magic):
            return name
    return "unknown"


def _chunks(data: bytes):
    """(type, body) of each chunk after the signature, CRC checked."""
    at = len(PNG_SIGNATURE)
    while at < len(data):
        if at + 8 > len(data):
            raise ValueError("truncated PNG chunk header")
        length, ctype = struct.unpack(">I4s", data[at:at + 8])
        end = at + 8 + length
        if end + 4 > len(data):
            raise ValueError(f"truncated PNG chunk {ctype!r}")
        body = data[at + 8:end]
        (crc,) = struct.unpack(">I", data[end:end + 4])
        if zlib.crc32(ctype + body) != crc:
            raise ValueError(f"PNG chunk {ctype!r} fails its CRC")
        yield ctype, body
        if ctype == b"IEND":
            return
        at = end + 4
    raise ValueError("PNG has no IEND chunk")


def _unfilter(raw: bytes, width: int, height: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters: uint8 ``[height, width * bpp]``."""
    stride = width * bpp
    if len(raw) < height * (stride + 1):
        raise ValueError("PNG image data is shorter than its size")
    rows = np.frombuffer(raw, np.uint8, height * (stride + 1)).reshape(
        height, stride + 1
    )
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        ftype, line = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:      # Sub: a running sum per channel, mod 256
            cur = np.cumsum(
                line.reshape(width, bpp), axis=0, dtype=np.uint8
            ).reshape(stride)
        elif ftype == 2:      # Up
            cur = line + prev
        elif ftype in (3, 4):  # Average, Paeth: sequential along the row
            cur = bytearray(line.tobytes())
            up = prev.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c
                    )
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"unknown PNG row filter {ftype}")
        out[y] = cur
        prev = out[y]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes → uint8 RGB ``[height, width, 3]``."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError("not a PNG image")
    header = palette = None
    idat = []
    for ctype, body in _chunks(data):
        if ctype == b"IHDR":
            if len(body) != 13:
                raise ValueError("malformed PNG IHDR")
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            if len(body) % 3:
                raise ValueError("malformed PNG palette")
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG has no IHDR chunk")
    width, height, depth, colour, _comp, _filt, interlace = header
    if width == 0 or height == 0:
        raise ValueError("PNG has an empty image")
    if depth != 8:
        raise ValueError(f"PNG bit depth {depth} is not supported (8 only)")
    if colour not in _CHANNELS:
        raise ValueError(
            f"PNG colour type {_COLOUR_NAMES.get(colour, colour)} is not "
            "supported (gray, RGB, RGBA, palette)"
        )
    if interlace:
        raise ValueError("interlaced PNG is not supported")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"corrupt PNG image data: {e}") from None
    bpp = _CHANNELS[colour]
    px = _unfilter(raw, width, height, bpp).reshape(height, width, bpp)
    if colour == 3:
        if palette is None:
            raise ValueError("palette PNG has no PLTE chunk")
        idx = px[..., 0]
        if int(idx.max()) >= len(palette):
            raise ValueError("PNG palette index out of range")
        return palette[idx]
    if colour == 0:
        return np.repeat(px, 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body)))


def encode_png(rgb: np.ndarray) -> bytes:
    """uint8 RGB ``[height, width, 3]`` -> PNG bytes: bit depth 8, colour
    type RGB, no interlace, filter 0 on every row, one zlib stream in one
    IDAT chunk, each chunk with its CRC."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(
            f"encode_png takes uint8 [H, W, 3], not {rgb.dtype} {rgb.shape}"
        )
    height, width = rgb.shape[:2]
    if width == 0 or height == 0:
        raise ValueError("cannot encode an empty image")
    rows = np.zeros((height, 1 + 3 * width), np.uint8)    # filter byte 0
    rows[:, 1:] = rgb.reshape(height, 3 * width)
    return (PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, 2,
                                          0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + _chunk(b"IEND", b""))


def decode_image(data: bytes) -> np.ndarray:
    """Image bytes → uint8 RGB ``[height, width, 3]``: PNG only; any other
    format is a ``ValueError`` that names it."""
    fmt = _image_format(data)
    if fmt != "PNG":
        raise ValueError(
            f"{fmt} images are not supported; send PNG"
            if fmt != "unknown" else "unrecognised image format; send PNG"
        )
    return decode_png(data)


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Pillow's ``bicubic_filter`` (a = -0.5), elementwise, in float64."""
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _coeffs(in_size: int, out_size: int):
    """Pillow's ``precompute_coeffs`` then ``normalize_coeffs_8bpc``:
    (first input index ``[out]``, fixed-point weights ``[out, ksize]``
    int64, zero past each output's window)."""
    scale = filterscale = in_size / out_size
    filterscale = max(filterscale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    ss = 1.0 / filterscale
    xmins = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = _bicubic((np.arange(xmax) + xmin - center + 0.5) * ss)
        ww = 0.0
        for v in w:           # Pillow's summation order, not pairwise
            ww += v
        if ww != 0.0:
            w = w / ww
        fixed = np.where(
            w < 0, -0.5 + w * (1 << PRECISION_BITS),
            0.5 + w * (1 << PRECISION_BITS),
        )
        kk[xx, :xmax] = np.trunc(fixed).astype(np.int64)
        xmins[xx] = xmin
    return xmins, kk


def _pass(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One resample pass of uint8 ``img`` along ``axis`` (0 rows, 1
    columns), rounded and clipped to uint8 as Pillow's ``clip8``."""
    xmins, kk = _coeffs(img.shape[axis], out_size)
    src = np.moveaxis(img, axis, 0).astype(np.int64)
    # pad so every window of ksize rows exists; the zero weights past a
    # window's end meet the padding
    ksize = kk.shape[1]
    src = np.concatenate(
        [src, np.zeros((ksize,) + src.shape[1:], np.int64)], axis=0
    )
    idx = xmins[:, None] + np.arange(ksize)[None, :]         # [out, ksize]
    acc = np.einsum("ok,ok...->o...", kk, src[idx])
    acc += 1 << (PRECISION_BITS - 1)
    out = np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_bicubic(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """uint8 ``[H, W, C]`` → ``[height, width, C]`` as Pillow's
    ``Image.resize((width, height))`` (BICUBIC) gives it; the same size is
    a copy, as in Pillow."""
    h, w = img.shape[:2]
    out = img
    if width != w:
        out = _pass(out, width, 1)
    if height != h:
        out = _pass(out, height, 0)
    return np.array(out, copy=True)
