"""The PyTorch port's image server (stdlib, port 0, ``tiny-diffusion`` on
the CPU) against the JAX image server (aiohttp's test client, as
``tests/engine/test_image_server.py`` drives it), and the port's PNG
encoder against Pillow: generations decode to RGB images of the asked
size in Pillow and in the port's decoder alike; a seed fixes the bytes;
every refused request gets JAX's status and body; ``/healthz`` and
``/metrics`` read as JAX's after the same requests.
"""

import asyncio
import base64
import http.client
import importlib.util
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from gpustack_tpu.engine.image_server import ImageEngine as JaxImageEngine
from gpustack_tpu.engine.image_server import ImageServer as JaxImageServer
from gpustack_tpu.engine.image_server import _png_bytes as jax_png_bytes
from gpustack_tpu_torch.engine.image_server import (  # analysis: ignore[metrics-drift]
    ImageEngine,
    ImageServer,
    _png_bytes,
    build_image_engine_from_args,
    build_parser,
)
from gpustack_tpu_torch.engine.weights import params_from_numpy  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.models import diffusion  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.models.png import decode_png, encode_png  # analysis: ignore[metrics-drift]


def _load_parity_helpers():
    path = os.path.join(os.path.dirname(__file__), "test_torch_diffusion.py")
    spec = importlib.util.spec_from_file_location("_diffusion_parity", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


H = _load_parity_helpers()
NAME = "tiny-image"
GEN = "/v1/images/generations"


@pytest.fixture(scope="module")
def tree():
    return H.jax_tree("tiny")


@pytest.fixture(scope="module")
def port(tree):
    cfg = diffusion.DIFFUSION_PRESETS["tiny-diffusion"]
    server = ImageServer(ImageEngine(cfg, params_from_numpy(tree, "cpu")),
                         model_name=NAME)
    yield server, server.start("127.0.0.1", 0)
    server.shutdown()


def _call(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request(method, path, body=body,
                     headers={"Content-Type": "application/json"}
                     if body is not None else {})
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read()
    finally:
        conn.close()


def _jax_calls(tree, calls):
    """[(method, path, raw body)] against a fresh JAX server; returns
    [(status, content type, body)]."""
    from aiohttp.test_utils import TestClient, TestServer

    from gpustack_tpu.models.diffusion import DIFFUSION_PRESETS

    params = jax.tree.map(jnp.asarray, tree)

    async def run():
        server = JaxImageServer(
            JaxImageEngine(DIFFUSION_PRESETS["tiny-diffusion"], params),
            model_name=NAME)
        client = TestClient(TestServer(server.app))
        await client.start_server()
        out = []
        try:
            for method, path, body in calls:
                if method == "GET":
                    r = await client.get(path)
                else:
                    r = await client.post(
                        path, data=body,
                        headers={"Content-Type": "application/json"})
                out.append((r.status, r.headers["Content-Type"],
                            await r.read()))
        finally:
            await client.close()
        return out

    return asyncio.run(run())


def _pngs(raw):
    body = json.loads(raw)
    assert body["id"].startswith("img-") and isinstance(body["created"], int)
    return [base64.b64decode(d["b64_json"]) for d in body["data"]]


def test_generation_decodes_in_pillow_and_the_port(port):
    _, p = port
    status, ctype, raw = _call(p, "POST", GEN, json.dumps(
        {"prompt": "a lighthouse at dusk", "n": 2, "steps": 2,
         "seed": 7}).encode())
    assert status == 200 and ctype == "application/json; charset=utf-8"
    pngs = _pngs(raw)
    assert len(pngs) == 2
    for png in pngs:
        img = Image.open(io.BytesIO(png))
        assert img.format == "PNG" and img.mode == "RGB"
        assert img.size == (32, 32)
        np.testing.assert_array_equal(np.asarray(img), decode_png(png))
    assert pngs[0] != pngs[1]                 # two draws from one seed


def test_seed_fixes_the_bytes(port):
    _, p = port
    out = []
    for seed in (123, 123, 124):
        status, _, raw = _call(p, "POST", GEN, json.dumps(
            {"prompt": "determinism", "steps": 2, "seed": seed,
             "negative_prompt": "blur", "guidance_scale": 3.0}).encode())
        assert status == 200
        out.append(_pngs(raw)[0])
    assert out[0] == out[1] and out[0] != out[2]


REFUSED = [
    b"{not json",
    b"",
    b"[1, 2]",
    json.dumps({}).encode(),
    json.dumps({"prompt": ""}).encode(),
    json.dumps({"prompt": "x", "size": "123x123"}).encode(),
    json.dumps({"prompt": "x", "size": "256x128"}).encode(),
    json.dumps({"prompt": "x", "size": "axb"}).encode(),
    json.dumps({"prompt": "x", "size": "256x256"}).encode(),
    json.dumps({"prompt": "x", "n": "abc"}).encode(),
    json.dumps({"prompt": "x", "steps": [1]}).encode(),
    json.dumps({"prompt": "x", "guidance_scale": "high"}).encode(),
    json.dumps({"prompt": "x", "seed": "s"}).encode(),
]


def test_refusals_match_jax(port, tree):
    _, p = port
    calls = [("POST", GEN, body) for body in REFUSED]
    want = _jax_calls(tree, calls)
    # a JSON body that is not an object: JAX's handler fails with a 500
    # (``list.get``); the port refuses it as invalid JSON
    assert want[2][0] == 500
    want[2] = (400, "application/json; charset=utf-8",
               json.dumps({"error": "invalid JSON"}).encode())
    got = [_call(p, m, path, body) for m, path, body in calls]
    for body, g, w in zip(REFUSED, got, want):
        assert g[0] == w[0] == 400, body
        assert g[1] == w[1], body
        assert json.loads(g[2]) == json.loads(w[2]), body


def test_refusals_jax_cannot_answer(port):
    """Bodies the JAX server fails on (a 500 or a numpy message): the port
    refuses each with a 400 that names the field."""
    _, p = port
    for body, error in (({"prompt": 5}, "'prompt' must be a string"),
                        ({"prompt": "x", "n": -2}, "'n' must be at least 1"),
                        ({"prompt": "x", "negative_prompt": 3},
                         "'negative_prompt' must be a string")):
        status, _, raw = _call(p, "POST", GEN, json.dumps(body).encode())
        assert (status, json.loads(raw)) == (400, {"error": error})
    status, _, raw = _call(p, "GET", "/v1/nothing")
    assert status == 404


def test_healthz_and_metrics_match_jax(tree):
    cfg = diffusion.DIFFUSION_PRESETS["tiny-diffusion"]
    server = ImageServer(ImageEngine(cfg, params_from_numpy(tree, "cpu")),
                         model_name=NAME)
    p = server.start("127.0.0.1", 0)
    calls = [("POST", GEN, json.dumps({"prompt": "x", "steps": 1, "seed": 1,
                                       "n": 2, "size": "32x32"}).encode()),
             ("POST", GEN, json.dumps({"prompt": ""}).encode()),
             ("POST", GEN, json.dumps({"prompt": "y", "steps": -5,
                                       "n": 9}).encode()),
             ("GET", "/healthz", None), ("GET", "/metrics", None)]
    try:
        got = [_call(p, m, path, body) for m, path, body in calls]
    finally:
        server.shutdown()
    want = _jax_calls(tree, calls)
    assert [g[0] for g in got] == [w[0] for w in want] == [
        400, 400, 200, 200, 200]
    assert len(_pngs(got[2][2])) == 4         # n clamped to 4
    assert json.loads(got[3][2]) == json.loads(want[3][2]) == {
        "status": "ok", "model": NAME, "modality": "image", "requests": 1,
        "images": 4}
    assert got[3][1] == want[3][1]
    assert got[4][2] == want[4][2]
    assert got[4][1] == want[4][1]
    assert b"gpustack_tpu_images_generated_total 4\n" in got[4][2]


def test_entry_points_refuse_the_cpu_unless_asked():
    if torch.cuda.is_available():
        return
    args = build_parser().parse_args(["--preset", "tiny-diffusion"])
    assert args.device is None and args.port == 9000
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_image_engine_from_args(args)
    engine = build_image_engine_from_args(build_parser().parse_args(
        ["--preset", "tiny-diffusion", "--device", "cpu", "--max-slots",
         "4", "--mesh-plan", "tp=1", "--quantization", "int8"]))
    assert engine.device == torch.device("cpu")


@pytest.mark.parametrize("h,w", [(1, 1), (7, 13), (32, 32), (64, 3)])
def test_encode_png_round_trips_through_pillow(h, w):
    rgb = np.random.default_rng(h * w).integers(
        0, 256, (h, w, 3), dtype=np.uint8)
    png = encode_png(rgb)
    img = Image.open(io.BytesIO(png))
    assert img.mode == "RGB" and img.size == (w, h)
    np.testing.assert_array_equal(np.asarray(img), rgb)
    np.testing.assert_array_equal(decode_png(png), rgb)


def test_encode_png_refuses_other_arrays():
    for bad in (np.zeros((4, 4), np.uint8), np.zeros((4, 4, 4), np.uint8),
                np.zeros((4, 4, 3), np.float32), np.zeros((0, 4, 3), np.uint8)):
        with pytest.raises(ValueError):
            encode_png(bad)


def test_png_bytes_are_jax_pixels():
    rng = np.random.default_rng(0)
    arr = rng.random((9, 11, 3), dtype=np.float32)
    # the rounding's edges: 0, 1, and values k/255 +- half a step
    arr[0, :3] = [0.0, 1.0, 0.5]
    arr[1, :3] = np.float32([0.5 / 255, 1.5 / 255, 254.5 / 255])
    arr[2, :3] = np.nextafter(arr[1, :3], np.float32(0))
    got = decode_png(_png_bytes(arr))
    want = np.asarray(Image.open(io.BytesIO(jax_png_bytes(arr))))
    np.testing.assert_array_equal(got, want)
