"""The vision path of the PyTorch port (``models/vlm.py``, ``models/png.py``,
``forward(embeds_override)``, ``prefill_with_embeds``, the engine's and
the server's image chat) against the JAX package on ``tiny-vlm``.

Weights come from one JAX init carried across with ``params_from_numpy``;
fp32 parity is held to 1e-5, bf16 to 2% of the output's scale. Images are
decoded by the port's own PNG decoder and resize (no PIL on the card's
machine), held against Pillow here.
"""

import base64
import dataclasses
import http.client
import io
import json
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from gpustack_tpu.engine.engine import GenRequest as JaxGenRequest
from gpustack_tpu.engine.engine import LLMEngine as JaxLLMEngine
from gpustack_tpu.engine.runner import ModelRunner as JaxModelRunner
from gpustack_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from gpustack_tpu.models import init_params as jax_init_params
from gpustack_tpu.models import vlm as jvlm
from gpustack_tpu.models.transformer import forward as jax_forward
from gpustack_tpu_torch.engine.api_server import OpenAIServer  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.engine import GenRequest, LLMEngine  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.runner import ModelRunner  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.tokenizer import ByteTokenizer  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.weights import params_from_numpy  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.models import png, vlm  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.models.transformer import forward  # analysis: ignore[metrics-drift]

MAX_TOKENS = 8


def _png_bytes(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _data_url(data: bytes, mime: str = "image/png") -> str:
    return f"data:{mime};base64,{base64.b64encode(data).decode()}"


def _image(seed: int, w: int, h: int) -> np.ndarray:
    """A smooth gradient plus noise: resize rounding shows on both."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255 / max(w - 1, 1), yy * 255 / max(h - 1, 1),
                     (xx + yy) * 127 / max(w + h - 2, 1)], -1)
    noise = rng.integers(-40, 41, (h, w, 3))
    return np.clip(base + noise, 0, 255).astype(np.uint8)


def _fp32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(scope="module")
def vision():
    cfg = jvlm.get_vlm_config("tiny-vlm")
    jparams = jvlm.init_vision_params(cfg, jax.random.key(1))
    return cfg, jparams


# ---------------------------------------------------------------------------
# the tower
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_image_matches_jax(vision, dtype):
    jcfg, jparams = vision
    cfg = vlm.get_vlm_config("tiny-vlm")
    np_params = (
        _fp32(jparams) if dtype == "float32"
        else jax.tree.map(np.asarray, jparams)
    )
    image = np.random.default_rng(0).random((64, 64, 3), np.float32)
    # jitted, as the JAX server runs it (VisionBundle)
    want = np.asarray(
        jax.jit(jvlm.encode_image, static_argnums=1)(
            jax.tree.map(jnp.asarray, np_params), jcfg, jnp.asarray(image)
        ), np.float32,
    )
    got = vlm.encode_image(
        params_from_numpy(np_params, "cpu"), cfg, torch.from_numpy(image)
    ).float().numpy()
    assert got.shape == (cfg.n_image_tokens, cfg.language.hidden_size)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= 0.02 * scale


# ---------------------------------------------------------------------------
# PNG decode and resize against Pillow
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", [(64, 64), (97, 53), (200, 30), (8, 8)])
@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "P"])
def test_preprocess_matches_pillow(vision, size, mode):
    jcfg, jparams = vision
    w, h = size
    img = Image.fromarray(_image(w * 7 + h, w, h))
    if mode == "RGBA":
        rgba = np.dstack([np.asarray(img), _image(3, w, h)[..., :1]])
        img = Image.fromarray(rgba, "RGBA")
    elif mode != "RGB":
        img = img.convert(mode)
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    data = buf.getvalue()
    want = jvlm.VisionBundle(jcfg, jparams).preprocess(data)
    bundle = vlm.VisionBundle(vlm.get_vlm_config("tiny-vlm"), {}, "cpu")
    got = bundle.preprocess(data)
    assert got.shape == want.shape == (64, 64, 3)
    assert got.dtype == np.float32
    if size == (64, 64):
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got - want).max() <= 1 / 255 + 1e-7


def _png_with_filters(arr: np.ndarray, colour: int, filters) -> bytes:
    """A PNG whose rows use the given filter types in turn (the test's own
    encoder: Pillow picks its filters itself)."""
    h, w = arr.shape[:2]
    bpp = arr.shape[2] if arr.ndim == 3 else 1
    raw = arr.reshape(h, w * bpp).astype(np.int64)
    out = bytearray()
    prev = np.zeros(w * bpp, np.int64)
    for y in range(h):
        ftype = filters[y % len(filters)]
        cur = raw[y]
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if ftype == 0:
            pred = np.zeros_like(cur)
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prev
        elif ftype == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        out.append(ftype)
        out.extend(((cur - pred) % 256).astype(np.uint8).tobytes())
        prev = cur

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0)
    return (png.PNG_SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(bytes(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,),
                                     (0, 1, 2, 3, 4)])
@pytest.mark.parametrize("colour", [0, 2, 6])
def test_png_row_filters_decode_as_pillow(filters, colour):
    channels = {0: 1, 2: 3, 6: 4}[colour]
    arr = np.random.default_rng(colour).integers(
        0, 256, (9, 13, channels), dtype=np.uint8
    )
    data = _png_with_filters(arr if channels > 1 else arr[..., 0], colour,
                             filters)
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_equal(png.decode_image(data), want)


@pytest.mark.parametrize("fmt,data", [
    ("JPEG", b"\xff\xd8\xff\xe0" + b"\0" * 16),
    ("GIF", b"GIF89a" + b"\0" * 16),
    ("unrecognised", b"not an image at all"),
])
def test_non_png_formats_are_named(fmt, data):
    with pytest.raises(ValueError, match=fmt):
        png.decode_image(data)


def test_png_bad_crc_and_16_bit_refused():
    data = bytearray(_png_bytes(_image(1, 8, 8)))
    data[20] ^= 0xFF                         # inside IHDR
    with pytest.raises(ValueError, match="CRC"):
        png.decode_image(bytes(data))
    buf = io.BytesIO()
    Image.fromarray(np.zeros((4, 4), np.uint16) + 300).save(buf, "PNG")
    with pytest.raises(ValueError, match="bit depth 16"):
        png.decode_image(buf.getvalue())


# ---------------------------------------------------------------------------
# prompt building, the forward's splice, the runner
# ---------------------------------------------------------------------------


def _messages(data: bytes, text="what is "):
    return [{
        "role": "user",
        "content": [
            {"type": "text", "text": text},
            {"type": "image_url", "image_url": {"url": _data_url(data)}},
            {"type": "text", "text": "?"},
        ],
    }]


@pytest.fixture(scope="module")
def fp32_models(vision):
    jcfg, jparams = vision
    jlang = dataclasses.replace(jcfg.language, dtype="float32")
    jlm = jax_init_params(jlang, jax.random.key(0), dtype=jnp.float32)
    jv32 = jax.tree.map(jnp.asarray, _fp32(jparams))
    jcfg32 = dataclasses.replace(jcfg, language=jlang)
    cfg = vlm.get_vlm_config("tiny-vlm")
    cfg32 = dataclasses.replace(
        cfg, language=dataclasses.replace(cfg.language, dtype="float32")
    )
    lm = params_from_numpy(jax.tree.map(np.asarray, jlm), "cpu")
    tower = params_from_numpy(_fp32(jparams), "cpu")
    return (
        (jcfg32, jlm, jvlm.VisionBundle(jcfg32, jv32)),
        (cfg32, lm, vlm.VisionBundle(cfg32, tower, "cpu")),
    )


def test_build_mm_prompt_matches_jax(fp32_models):
    (_, _, jbundle), (_, _, bundle) = fp32_models
    msgs = _messages(_png_bytes(_image(5, 97, 53)))
    jids, jemb, jmask = jvlm.build_mm_prompt(JaxByteTokenizer(), msgs, jbundle)
    ids, emb, mask = vlm.build_mm_prompt(ByteTokenizer(), msgs, bundle)
    assert ids == jids
    assert ids.count(vlm.IMAGE_PLACEHOLDER_ID) == bundle.n_image_tokens
    np.testing.assert_array_equal(mask, jmask)
    assert emb.dtype == np.float32
    np.testing.assert_allclose(emb, jemb, rtol=1e-5, atol=1e-5)


def test_forward_and_prefill_with_embeds_match_jax(fp32_models):
    (jcfg, jlm, jbundle), (cfg, lm, bundle) = fp32_models
    msgs = _messages(_png_bytes(_image(6, 64, 64)))
    ids, emb, mask = jvlm.build_mm_prompt(JaxByteTokenizer(), msgs, jbundle)
    n = len(ids)
    # the forward's splice alone, no cache
    jlogits, _ = jax_forward(
        jlm, jcfg.language, jnp.asarray([ids]), jnp.arange(n)[None],
        embeds_override=(jnp.asarray(emb)[None], jnp.asarray(mask)[None]),
    )
    logits, _ = forward(
        lm, cfg.language, torch.tensor([ids]), torch.arange(n)[None],
        embeds_override=(torch.from_numpy(emb)[None],
                         torch.from_numpy(mask)[None]),
    )
    np.testing.assert_allclose(
        logits.numpy(), np.asarray(jlogits), rtol=1e-5, atol=1e-5
    )
    plain, _ = forward(
        lm, cfg.language, torch.tensor([ids]), torch.arange(n)[None]
    )
    assert not torch.allclose(plain, logits)      # the splice took effect
    # the runner: one fused prefill at the bucket
    jrun = JaxModelRunner(jcfg.language, jlm, max_slots=2, max_seq_len=256)
    run = ModelRunner(cfg.language, lm, "cpu", max_slots=2, max_seq_len=256)
    bucket = run.bucket_for(n)
    padded = ids + [0] * (bucket - n)
    pe = np.pad(emb, ((0, bucket - n), (0, 0)))
    pm = np.pad(mask, (0, bucket - n))
    jlast, jk, jv = jrun.prefill_with_embeds(padded, n, pe, pm)
    last, k, v = run.prefill_with_embeds(padded, n, pe, pm)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(ValueError, match="do not match"):
        run.prefill_with_embeds(padded, n, pe[:-1], pm)


# ---------------------------------------------------------------------------
# the engine and the server
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def served(fp32_models):
    (jcfg, jlm, jbundle), (cfg, lm, bundle) = fp32_models
    jeng = JaxLLMEngine(jcfg.language, jlm, max_slots=2, max_seq_len=256,
                        pipeline_depth=0)
    jeng.vision = jbundle
    eng = LLMEngine(cfg.language, lm, max_slots=2, max_seq_len=256,
                    device="cpu", host_kv_cache_mb=8, kv_block_tokens=16)
    eng.vision = bundle
    plain = LLMEngine(cfg.language, lm, max_slots=1, max_seq_len=256,
                      device="cpu")
    spec = LLMEngine(cfg.language, lm, max_slots=1, max_seq_len=256,
                     device="cpu", speculative="ngram")
    spec.vision = bundle
    servers = {}
    jeng.start()
    for name, e in (("vlm", eng), ("plain", plain), ("spec", spec)):
        e.start()
        servers[name] = OpenAIServer(e, model_name=f"tiny-{name}")
    ports = {name: s.start("127.0.0.1", 0) for name, s in servers.items()}
    yield jeng, eng, ports
    for s in servers.values():
        s.shutdown()
    for e in (eng, plain, spec, jeng):
        e.stop()


def _post(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", "/v1/chat/completions", body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def test_image_chat_greedy_ids_match_jax_engine(served):
    jeng, eng, ports = served
    for seed, (w, h) in ((7, (64, 64)), (8, (97, 53))):
        msgs = _messages(_png_bytes(_image(seed, w, h)), text="look ")
        ids, emb, mask = jvlm.build_mm_prompt(
            jeng.tokenizer, msgs, jeng.vision
        )
        jreq = jeng.generate(JaxGenRequest(
            prompt_ids=ids, max_tokens=MAX_TOKENS, temperature=0.0,
            embeds_override=(emb, mask),
        ), timeout=300)
        req = eng.generate(GenRequest(
            prompt_ids=ids, max_tokens=MAX_TOKENS, temperature=0.0,
            embeds_override=(emb, mask),
        ), timeout=300)
        assert req.output_ids == jreq.output_ids
        status, raw = _post(ports["vlm"], {
            "messages": msgs, "max_tokens": MAX_TOKENS, "temperature": 0,
        })
        assert status == 200, raw
        data = json.loads(raw)
        assert data["choices"][0]["message"]["content"] == jreq.output_text
        assert data["usage"]["prompt_tokens"] == len(ids)
    # a VLM prompt never enters the token-keyed host cache
    assert eng.host_kv_cache.match_prefix_len(ids) == 0


def test_image_chat_refusals(served):
    _, _, ports = served
    good = _png_bytes(_image(9, 64, 64))

    def chat(port, *parts):
        return _post(port, {
            "messages": [{"role": "user", "content": [
                {"type": "text", "text": "x"}, *parts]}],
            "max_tokens": 2, "temperature": 0,
        })

    def image_part(url):
        return {"type": "image_url", "image_url": {"url": url}}

    cases = [
        (ports["vlm"], image_part("https://example.com/cat.png"),
         "zero-egress"),
        (ports["vlm"], image_part("data:image/png;base64,!!notb64!!"),
         "invalid base64"),
        # an unknown part beside an image (a text-only message takes the
        # text template, which skips it, as in JAX)
        (ports["vlm"], [image_part(_data_url(good)),
                        {"type": "audio", "audio": {}}],
         "unsupported content part type"),
        (ports["vlm"], image_part(_data_url(
            b"\xff\xd8\xff\xe0" + b"\0" * 32, "image/jpeg")), "JPEG"),
        (ports["plain"], image_part(_data_url(good)),
         "does not accept image input"),
        (ports["spec"], image_part(_data_url(good)), "speculative"),
    ]
    for port, part, words in cases:
        status, raw = chat(port, *(part if isinstance(part, list) else [part]))
        assert status == 400, (words, raw)
        assert words in json.loads(raw)["error"]["message"], raw
