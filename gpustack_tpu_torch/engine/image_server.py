"""Image generation server: OpenAI ``/v1/images/generations`` (standard
library).

The port of ``gpustack_tpu/engine/image_server.py`` on
``http.server.ThreadingHTTPServer``, as the port's ``api_server.py`` and
``audio_server.py`` are (the card's machine has no ``aiohttp``). One
process serves one latent-diffusion pipeline (``models/diffusion.py``);
one lock serialises sampling (the card is busy for the whole denoising
loop), and concurrency comes from replicas. Routes, validation, status
codes, error words, body fields and metric names are JAX's:
``POST /v1/images/generations``, ``GET /healthz``, ``GET /metrics``
(``gpustack_tpu_image_requests_total``,
``gpustack_tpu_images_generated_total``). Images are PNG, written by the
port's own encoder (``models/png.py``; the card's machine has no PIL).

Run: ``python -m gpustack_tpu_torch.engine.image_server --preset
sd15-shaped`` (on the card; ``--device cpu`` for a CPU run, ``--model-dir``
for a diffusers checkpoint).
"""

from __future__ import annotations

import argparse
import base64
import json
import logging
import os
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Tuple
from urllib.parse import urlsplit

import numpy as np
import torch

from gpustack_tpu_torch.engine.tokenizer import load_tokenizer_or_bytes
from gpustack_tpu_torch.models.png import encode_png

logger = logging.getLogger(__name__)

SIZE_CHOICES = (256, 512, 768, 1024)


def _png_bytes(arr) -> bytes:
    """[H, W, 3] float in [0, 1] -> PNG bytes, rounded as JAX's server
    rounds before PIL: ``(x * 255 + 0.5).astype(uint8)``."""
    u8 = (np.asarray(arr) * 255.0 + 0.5).astype("uint8")
    return encode_png(u8)


class ImageEngine:
    """Owns the pipeline params and a serialised sampling executor (one
    lock). The tokenizers are ``<model_dir>/tokenizer`` and
    ``tokenizer_2`` through ``load_tokenizer_or_bytes``: the byte
    tokenizer when none is there or none can be built."""

    def __init__(self, cfg, params, model_dir: str = ""):
        self.cfg = cfg
        self.params = params
        self.model_dir = model_dir
        self.device = params["unet"]["conv_in_w"].device
        self.tokenizer = self._load_tokenizer(model_dir)
        self.tokenizer2 = self._load_tokenizer(model_dir, "tokenizer_2") \
            if cfg.text2_dim else None
        self._lock = threading.Lock()
        self.requests = 0
        self.images = 0

    @staticmethod
    def _load_tokenizer(model_dir: str, sub: str = "tokenizer"):
        """The directory's tokenizer, or the byte tokenizer when none can
        be built from it (no ``transformers``, or unreadable files), with
        a warning, as the JAX server does."""
        return load_tokenizer_or_bytes(
            os.path.join(model_dir, sub) if model_dir else None
        )

    def _tokens(self, prompt: str, tokenizer) -> np.ndarray:
        """[1, max_text_len] int32 ids: an HF tokenizer pads and truncates
        itself; any other is truncated and padded with 0."""
        T = self.cfg.max_text_len
        hf = getattr(tokenizer, "_tok", None)
        if hf is not None:
            ids = hf(prompt, truncation=True, max_length=T,
                     padding="max_length")["input_ids"]
        else:
            ids = tokenizer.encode(prompt)[:T]
            ids = ids + [0] * (T - len(ids))
        return np.asarray([ids], dtype=np.int32)

    def _on_device(self, prompt: str, tokenizer, n: int) -> torch.Tensor:
        ids = np.repeat(self._tokens(prompt, tokenizer), n, axis=0)
        return torch.from_numpy(ids).long().to(self.device)

    def generate_images(self, prompt: str, negative: str, n: int, size: int,
                        steps: int, guidance: float, seed: int) -> np.ndarray:
        """n images [n, size, size, 3] in [0, 1] (fp32, on the host),
        sampled from a generator on the device seeded with ``seed``."""
        from gpustack_tpu_torch.models.diffusion import sample_images

        cond = self._on_device(prompt, self.tokenizer, n)
        uncond = self._on_device(negative, self.tokenizer, n)
        kwargs = {}
        if self.cfg.text2_dim:
            kwargs["cond_tokens2"] = self._on_device(prompt, self.tokenizer2, n)
            kwargs["uncond_tokens2"] = self._on_device(
                negative, self.tokenizer2, n)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        with torch.no_grad():
            imgs = sample_images(
                self.params, self.cfg, gen, cond, uncond, steps=steps,
                guidance=guidance, height=size, width=size, **kwargs,
            )
        return imgs.cpu().numpy()

    def generate(self, prompt: str, negative: str = "", n: int = 1,
                 size: int = 0, steps: int = 30, guidance: float = 7.5,
                 seed: Optional[int] = None) -> List[bytes]:
        size = size or self.cfg.image_size
        if seed is None:
            seed = int.from_bytes(os.urandom(4), "little")
        start = time.monotonic()
        with self._lock:
            imgs = self.generate_images(
                prompt, negative, n, size, steps, guidance, seed
            )
            self.requests += 1
            self.images += len(imgs)
        logger.info(
            "generated %d image(s) %dx%d steps=%d in %.1fs",
            len(imgs), size, size, steps, time.monotonic() - start,
        )
        return [_png_bytes(img) for img in imgs]


class ImageServer:
    """Serves one :class:`ImageEngine` over HTTP. The route logic returns
    (status, content type, body) apart from the socket plumbing of
    ``make_handler``."""

    def __init__(self, engine: ImageEngine, model_name: Optional[str] = None):
        self.engine = engine
        self.model_name = model_name or engine.cfg.name
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    @staticmethod
    def _json(status: int, payload) -> Tuple[int, str, bytes]:
        return status, "application/json; charset=utf-8", json.dumps(
            payload).encode()

    def healthz(self) -> Tuple[int, str, bytes]:
        return self._json(200, {
            "status": "ok",
            "model": self.model_name,
            "modality": "image",
            "requests": self.engine.requests,
            "images": self.engine.images,
        })

    def metrics(self) -> Tuple[int, str, bytes]:
        text = (
            "# TYPE gpustack_tpu_image_requests_total counter\n"
            f"gpustack_tpu_image_requests_total {self.engine.requests}\n"
            "# TYPE gpustack_tpu_images_generated_total counter\n"
            f"gpustack_tpu_images_generated_total {self.engine.images}\n"
        )
        return 200, "text/plain; charset=utf-8", text.encode()

    def generations(self, raw: bytes) -> Tuple[int, str, bytes]:
        try:
            body = json.loads(raw)
        except (ValueError, UnicodeDecodeError):
            return self._json(400, {"error": "invalid JSON"})
        if not isinstance(body, dict):
            return self._json(400, {"error": "invalid JSON"})
        prompt = body.get("prompt") or ""
        if not prompt:
            return self._json(400, {"error": "'prompt' is required"})
        if not isinstance(prompt, str):
            return self._json(400, {"error": "'prompt' must be a string"})
        try:
            n = min(int(body.get("n", 1) or 1), 4)
            steps = max(1, min(int(body.get("steps", 30) or 30), 100))
            guidance = float(body.get("guidance_scale", 7.5) or 7.5)
            seed = body.get("seed")
            seed = int(seed) if seed is not None else None
        except (TypeError, ValueError) as e:
            return self._json(400, {"error": f"bad numeric parameter: {e}"})
        if n < 1:
            return self._json(400, {"error": "'n' must be at least 1"})
        size_str = body.get("size") or ""
        size = 0
        if size_str:
            parts = str(size_str).lower().split("x")
            try:
                dims = [int(p) for p in parts]
            except ValueError:
                return self._json(400, {"error": f"bad size {size_str!r}"})
            if len(set(dims)) != 1:
                return self._json(
                    400, {"error": "only square sizes are supported"})
            size = dims[0]
            if size not in SIZE_CHOICES:
                return self._json(400, {
                    "error": f"size must be one of "
                    f"{['%dx%d' % (s, s) for s in SIZE_CHOICES]}"})
            if size > self.engine.cfg.image_size:
                return self._json(400, {
                    "error": f"size {size} exceeds this model's native "
                    f"{self.engine.cfg.image_size}"})
        negative = body.get("negative_prompt") or ""
        if not isinstance(negative, str):
            return self._json(
                400, {"error": "'negative_prompt' must be a string"})
        try:
            pngs = self.engine.generate(
                prompt, negative=negative, n=n, size=size, steps=steps,
                guidance=guidance, seed=seed,
            )
        except ValueError as e:
            return self._json(400, {"error": str(e)})
        return self._json(200, {
            "created": int(time.time()),
            "id": f"img-{uuid.uuid4().hex[:12]}",
            "data": [{"b64_json": base64.b64encode(p).decode()}
                     for p in pngs],
        })

    # ---- HTTP plumbing --------------------------------------------------

    def make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # route to logging
                logger.debug("%s " + fmt, self.address_string(), *args)

            def _send(self, status: int, ctype: str, data: bytes) -> None:
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                path = urlsplit(self.path).path
                if path == "/healthz":
                    self._send(*server.healthz())
                elif path == "/metrics":
                    self._send(*server.metrics())
                else:
                    self._send(*server._json(404, {"error": "not found"}))

            def do_POST(self):
                path = urlsplit(self.path).path
                length = int(self.headers.get("Content-Length") or 0)
                raw = self.rfile.read(length)
                if path == "/v1/images/generations":
                    self._send(*server.generations(raw))
                else:
                    self._send(*server._json(404, {"error": "not found"}))

        return Handler

    def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Serve in a background thread; returns the bound port."""
        self._httpd = ThreadingHTTPServer((host, port), self.make_handler())
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="image-http", daemon=True
        )
        self._thread.start()
        return self._httpd.server_address[1]

    def shutdown(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)


def build_image_engine_from_args(args) -> ImageEngine:
    """A ``--model-dir`` diffusers checkpoint, else a preset's random
    weights from seed 0, on ``--device`` (default: the card)."""
    from gpustack_tpu_torch.device import resolve_device
    from gpustack_tpu_torch.engine.image_weights import load_diffusion_params
    from gpustack_tpu_torch.models.diffusion import (
        DIFFUSION_PRESETS,
        config_from_diffusers,
        init_diffusion_params,
    )

    device = resolve_device(args.device)
    if args.model_dir:
        cfg = config_from_diffusers(args.model_dir)
        params = load_diffusion_params(cfg, args.model_dir, device)
    else:
        cfg = DIFFUSION_PRESETS[args.preset]
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        params = init_diffusion_params(cfg, gen, device)
    return ImageEngine(cfg, params, model_dir=args.model_dir)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("gpustack-tpu-torch image server")
    p.add_argument("--model-dir", default="")
    p.add_argument("--preset", default="sd15-shaped")
    p.add_argument("--served-name", default="")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=9000)
    # accepted for launcher compatibility; unused by the image engine
    p.add_argument("--max-slots", type=int, default=1)
    p.add_argument("--max-seq-len", type=int, default=77)
    p.add_argument("--quantization", default="")
    p.add_argument("--mesh-plan", default="")
    p.add_argument(
        "--device", default=None,
        help="torch device (default: the CUDA card; 'cpu' to run on the "
        "CPU — never chosen implicitly)",
    )
    return p


def main(argv=None) -> None:
    args, _ = build_parser().parse_known_args(argv)
    logging.basicConfig(level=logging.INFO)
    engine = build_image_engine_from_args(args)
    server = ImageServer(engine, model_name=args.served_name or None)
    port = server.start(args.host, args.port)
    logger.info("serving %s on %s:%d", server.model_name, args.host, port)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()


if __name__ == "__main__":
    main()
