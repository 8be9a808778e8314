"""Audio server: OpenAI ``/v1/audio/transcriptions``, ``/translations``
and ``/speech`` (standard library).

The port of ``gpustack_tpu/engine/audio_server.py`` on
``http.server.ThreadingHTTPServer``, as the port's ``api_server.py`` is
(the card's machine has no ``aiohttp``). One process serves one audio
model: STT (Whisper-class, ``models/whisper.py``) or TTS (FastSpeech-class,
``models/tts.py``). Requests carry WAV audio as multipart form data (parsed
here, no ``cgi``); one lock serialises the work, and concurrency comes
from replicas. Routes, bodies, status codes and error words are JAX's:
``POST /v1/audio/transcriptions``, ``POST /v1/audio/translations``,
``POST /v1/audio/speech``, ``GET /healthz``, ``GET /metrics``
(``gpustack_tpu_audio_requests_total``,
``gpustack_tpu_audio_seconds_total``).

Run: ``python -m gpustack_tpu_torch.engine.audio_server --preset
whisper-large-v3`` (on the card; ``--device cpu`` for a CPU run,
``--preset tts-base`` for speech, ``--model-dir`` for a checkpoint).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import threading
import time
import uuid
import wave
from email.message import Message
from email.parser import BytesHeaderParser
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple
from urllib.parse import urlsplit

from gpustack_tpu_torch.engine.tokenizer import load_tokenizer_or_bytes

logger = logging.getLogger(__name__)


class AudioEngine:
    """Owns the model params and a serialised transcription/synthesis
    executor (one lock). ``modality`` is ``"stt"`` or ``"tts"``."""

    def __init__(self, cfg, params, model_dir: str = "", modality: str = "stt"):
        self.cfg = cfg
        self.params = params
        self.model_dir = model_dir
        self.modality = modality
        self.tokenizer = load_tokenizer_or_bytes(model_dir or None)
        self._lock = threading.Lock()
        self.requests = 0
        self.audio_seconds = 0.0

    def _task_prompt_ids(self, task: str, language: str = "") -> tuple:
        """Whisper task/language conditioning: force ``<|xx|>`` (the
        OpenAI ``language`` form field, ISO 639-1) and ``<|translate|>``
        after start-of-transcript. A tokenizer without Whisper's task
        tokens (the byte fallback) conditions nothing, and refuses a
        language hint it cannot honour."""
        convert = getattr(
            getattr(self.tokenizer, "_tok", None),
            "convert_tokens_to_ids", None,
        )
        if convert is None:
            if language:
                raise ValueError(
                    f"this model's tokenizer has no language tokens; "
                    f"cannot honor language={language!r}"
                )
            return ()
        unk = getattr(self.tokenizer._tok, "unk_token_id", None)

        def tid_of(token: str):
            tid = convert(token)
            return tid if tid is not None and tid != unk else None

        ids = []
        if language:
            lang_tid = tid_of(f"<|{language.lower()}|>")
            if lang_tid is None:
                # an unhonorable hint must not be silently dropped
                raise ValueError(
                    f"unsupported language {language!r} (ISO 639-1 "
                    "code the model's tokenizer knows, e.g. 'en')"
                )
            ids.append(lang_tid)
        if task == "translate":
            tr = tid_of("<|translate|>")
            if tr is not None:
                ids.append(tr)
        elif ids:
            # whisper's conditioning is sot→language→task: with a forced
            # language the task token is forced too
            tr = tid_of("<|transcribe|>")
            if tr is not None:
                ids.append(tr)
        return tuple(ids)

    def transcribe(
        self, wav_bytes: bytes, task: str = "transcribe",
        language: str = "",
    ) -> dict:
        from gpustack_tpu_torch.models.audio import (
            decode_wav,
            features_for_model,
        )
        from gpustack_tpu_torch.models.whisper import greedy_transcribe

        audio = decode_wav(wav_bytes)
        mel = features_for_model(audio, self.cfg)
        prompt_ids = self._task_prompt_ids(task, language)
        start = time.monotonic()
        with self._lock:
            ids = greedy_transcribe(
                self.params, self.cfg, mel, prompt_ids=prompt_ids
            )
            self.requests += 1
            self.audio_seconds += len(audio) / 16000.0
        text = self.tokenizer.decode(ids)
        return {
            "text": text,
            "duration_s": round(len(audio) / 16000.0, 2),
            "latency_ms": round((time.monotonic() - start) * 1e3, 1),
        }

    def speak(self, text: str, voice: str = "", speed: float = 1.0) -> bytes:
        """Text → WAV bytes: the synthesis on the device, then the host
        Griffin-Lim."""
        from gpustack_tpu_torch.models.tts import (
            pcm_to_wav_bytes,
            synthesize,
            voice_index,
        )

        ids = self.tokenizer.encode(text)
        if not ids:
            raise ValueError("input text is empty")
        with self._lock:
            audio = synthesize(
                self.params, self.cfg, ids,
                voice=voice_index(voice, self.cfg), speed=speed,
            )
            self.requests += 1
            self.audio_seconds += len(audio) / self.cfg.sample_rate
        return pcm_to_wav_bytes(audio, self.cfg.sample_rate)


def parse_multipart(body: bytes, content_type: str) -> Dict[str, bytes]:
    """A ``multipart/form-data`` body → {field name: raw bytes}. Raises
    ValueError when the boundary is missing."""
    header = Message()
    header["content-type"] = content_type
    boundary = header.get_param("boundary")
    if not boundary:
        raise ValueError("multipart body without a boundary")
    fields: Dict[str, bytes] = {}
    for part in body.split(b"--" + boundary.encode("latin-1"))[1:]:
        if part.startswith(b"--"):
            break                                  # the closing delimiter
        head, _, content = part.partition(b"\r\n\r\n")
        if content.endswith(b"\r\n"):
            content = content[:-2]
        headers = BytesHeaderParser().parsebytes(head.lstrip(b"\r\n"))
        name = headers.get_param("name", header="content-disposition")
        if name is not None:
            fields[str(name)] = content
    return fields


class AudioServer:
    """Serves one :class:`AudioEngine` over HTTP. The route logic
    (``speech``, ``transcriptions``) returns (status, content type, body)
    apart from the socket plumbing of ``make_handler``."""

    def __init__(self, engine: AudioEngine, model_name: Optional[str] = None):
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
            "modality": f"audio/{self.engine.modality}",
            "requests": self.engine.requests,
        })

    def metrics(self) -> Tuple[int, str, bytes]:
        text = (
            "# TYPE gpustack_tpu_audio_requests_total counter\n"
            f"gpustack_tpu_audio_requests_total {self.engine.requests}\n"
            "# TYPE gpustack_tpu_audio_seconds_total counter\n"
            f"gpustack_tpu_audio_seconds_total "
            f"{self.engine.audio_seconds:.2f}\n"
        )
        return 200, "text/plain; charset=utf-8", text.encode()

    def speech(self, raw: bytes) -> Tuple[int, str, bytes]:
        """JSON {input, voice, speed, response_format} → WAV (or raw
        16-bit PCM) bytes."""
        if self.engine.modality != "tts":
            return self._json(
                400, {"error": f"model {self.model_name} is not a TTS model"}
            )
        try:
            body = json.loads(raw)
        except (json.JSONDecodeError, UnicodeDecodeError):
            return self._json(400, {"error": "invalid JSON body"})
        if not isinstance(body, dict):
            return self._json(400, {"error": "invalid JSON body"})
        text = body.get("input")
        if not isinstance(text, str) or not text.strip():
            return self._json(400, {"error": "missing 'input'"})
        fmt = body.get("response_format") or "wav"
        if fmt not in ("wav", "pcm"):
            return self._json(400, {
                "error": f"unsupported response_format {fmt!r}; this "
                "engine produces wav/pcm"
            })
        speed = body.get("speed")
        if speed is None:
            speed = 1.0
        if isinstance(speed, bool) or not isinstance(speed, (int, float)):
            return self._json(400, {"error": "'speed' must be a number"})
        if not 0.25 <= speed <= 4.0:
            return self._json(
                400, {"error": "'speed' must be between 0.25 and 4.0"}
            )
        try:
            wav = self.engine.speak(
                text, voice=str(body.get("voice") or ""), speed=speed
            )
        except ValueError as e:
            return self._json(400, {"error": str(e)})
        if fmt == "pcm":
            # the 44-byte RIFF header off: raw 16-bit mono PCM
            return 200, "application/octet-stream", wav[44:]
        return 200, "audio/wav", wav

    def transcriptions(
        self, path: str, raw: bytes, content_type: str
    ) -> Tuple[int, str, bytes]:
        if self.engine.modality != "stt":
            return self._json(
                400,
                {"error": f"model {self.model_name} is not an STT model"},
            )
        if not content_type.startswith("multipart/"):
            return self._json(400, {
                "error": "multipart/form-data with a 'file' part required"
            })
        try:
            fields = parse_multipart(raw, content_type)
        except ValueError as e:
            return self._json(400, {"error": str(e)})
        wav = fields.get("file")
        fmt = fields.get("response_format", b"").decode(
            "utf-8", "replace").strip() or "json"
        language = fields.get("language", b"").decode(
            "utf-8", "replace").strip()
        if not wav:
            return self._json(400, {"error": "missing 'file' part"})
        task = (
            "translate" if path.endswith("/translations") else "transcribe"
        )
        try:
            result = self.engine.transcribe(
                wav, task=task, language=language
            )
        except ValueError as e:
            # undecodable audio AND unhonorable language hints: the
            # message says which
            return self._json(400, {"error": str(e)})
        except (wave.Error, EOFError) as e:
            return self._json(400, {"error": f"invalid audio: {e}"})
        if fmt == "text":
            return 200, "text/plain; charset=utf-8", result["text"].encode()
        return self._json(200, {
            "id": f"transcr-{uuid.uuid4().hex[:12]}",
            "object": (
                "audio.translation" if task == "translate"
                else "audio.transcription"
            ),
            "model": self.model_name,
            **result,
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
                if path == "/v1/audio/speech":
                    self._send(*server.speech(raw))
                elif path in ("/v1/audio/transcriptions",
                              "/v1/audio/translations"):
                    self._send(*server.transcriptions(
                        path, raw, self.headers.get("Content-Type", "")
                    ))
                else:
                    self._send(*server._json(404, {"error": "not found"}))

        return Handler

    def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Serve in a background thread; returns the bound port."""
        self._httpd = ThreadingHTTPServer((host, port), self.make_handler())
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="audio-http", daemon=True
        )
        self._thread.start()
        return self._httpd.server_address[1]

    def shutdown(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)


def build_audio_engine_from_args(args) -> AudioEngine:
    """A ``--model-dir`` whose ``config.json`` names a TTS model loads its
    ``params.npz``; any other is an HF Whisper checkpoint; without one, a
    preset's random weights from seed 0, on ``--device`` (default: the
    card)."""
    import torch

    from gpustack_tpu_torch.device import resolve_device
    from gpustack_tpu_torch.engine.weights import (
        load_npz_params,
        load_whisper_params,
    )
    from gpustack_tpu_torch.models.tts import TTS_PRESETS, init_tts_params
    from gpustack_tpu_torch.models.whisper import (
        WHISPER_PRESETS,
        config_from_hf_whisper,
        init_whisper_params,
    )

    device = resolve_device(args.device)

    def seeded():
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        return gen

    if args.model_dir:
        with open(os.path.join(args.model_dir, "config.json")) as f:
            hf_cfg = json.load(f)
        if hf_cfg.get("model_type") in ("tts", "fastspeech"):
            # the in-repo TTS's own format: config.json names a preset,
            # the params are a .npz beside it
            cfg = TTS_PRESETS[hf_cfg.get("preset", "tts-base")]
            params = load_npz_params(
                os.path.join(args.model_dir, "params.npz"),
                lambda: init_tts_params(cfg, seeded()), device,
            )
            return AudioEngine(
                cfg, params, model_dir=args.model_dir, modality="tts"
            )
        cfg = config_from_hf_whisper(hf_cfg)
        params = load_whisper_params(cfg, args.model_dir, device)
        return AudioEngine(cfg, params, model_dir=args.model_dir)
    if args.preset in TTS_PRESETS:
        cfg = TTS_PRESETS[args.preset]
        return AudioEngine(cfg, init_tts_params(cfg, seeded()), modality="tts")
    cfg = WHISPER_PRESETS[args.preset]
    return AudioEngine(cfg, init_whisper_params(cfg, seeded()))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("gpustack-tpu-torch audio server")
    p.add_argument("--model-dir", default="")
    p.add_argument("--preset", default="whisper-large-v3")
    p.add_argument("--served-name", default="")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=9000)
    # accepted for launcher compatibility; unused by the audio engine
    p.add_argument("--max-slots", type=int, default=1)
    p.add_argument("--max-seq-len", type=int, default=448)
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
    engine = build_audio_engine_from_args(args)
    server = AudioServer(engine, model_name=args.served_name or None)
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
