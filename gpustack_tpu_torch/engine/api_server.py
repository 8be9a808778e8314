"""OpenAI-compatible HTTP front for the PyTorch engine (standard library).

The port of ``gpustack_tpu/engine/api_server.py``'s serving surface:
``GET /healthz``, ``GET /v1/models``, ``POST /v1/completions`` and
``POST /v1/chat/completions`` (streaming and not), with the same JSON
shapes. It runs on ``http.server.ThreadingHTTPServer`` (one thread per
connection; each handler blocks on its request's ``done`` event or token
queue) and streams Server-Sent Events as HTTP/1.1 chunked transfer.

Run: ``python -m gpustack_tpu_torch.engine.api_server --preset llama3-8b``
(on the card; ``--device cpu`` for a CPU run).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import queue
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

from gpustack_tpu_torch.engine.engine import GenRequest, LLMEngine
from gpustack_tpu_torch.engine.openai_tools import (
    JSON_MODE_INSTRUCTION,
    ToolCallHoldback,
    forced_function,
    parse_tool_calls,
)

logger = logging.getLogger(__name__)

SYSTEM_FINGERPRINT = "fp_gpustack_tpu_torch"
MAX_N = 8          # parallel choices per request (each takes a slot)
MAX_TOP_LOGPROBS = 20
GENERATION_TIMEOUT_S = 600.0


class HTTPError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


def _error_body(message: str) -> Dict[str, Any]:
    return {"error": {"message": message, "type": "invalid_request_error"}}


def _usage(reqs: List[GenRequest]) -> Dict[str, int]:
    # n>1 choices share one prompt: bill prompt tokens once
    pt = len(reqs[0].prompt_ids) if reqs else 0
    ct = sum(len(r.output_ids) for r in reqs)
    return {
        "prompt_tokens": pt,
        "completion_tokens": ct,
        "total_tokens": pt + ct,
    }


def _token_entry(tokenizer, tid: int, lp: float) -> Dict[str, Any]:
    text = tokenizer.decode([tid])
    return {"token": text, "logprob": lp, "bytes": list(text.encode("utf-8"))}


def _chat_logprobs(req: GenRequest, tokenizer) -> Dict[str, Any]:
    """OpenAI chat logprobs shape: choices[].logprobs.content[]."""
    content = []
    for tid, lp, tops in zip(
        req.output_ids, req.output_logprobs, req.output_top_logprobs
    ):
        entry = _token_entry(tokenizer, tid, lp)
        entry["top_logprobs"] = [
            _token_entry(tokenizer, i, p) for i, p in tops[: req.top_logprobs]
        ]
        content.append(entry)
    return {"content": content}


def _completion_logprobs(req: GenRequest, tokenizer) -> Dict[str, Any]:
    """Legacy completions logprobs shape."""
    tokens, offsets = [], []
    off = 0
    for tid in req.output_ids:
        text = tokenizer.decode([tid])
        tokens.append(text)
        offsets.append(off)
        off += len(text)
    k = req.top_logprobs
    return {
        "tokens": tokens,
        "token_logprobs": list(req.output_logprobs),
        "top_logprobs": [
            {tokenizer.decode([i]): p for i, p in tops[:k]}
            for tops in req.output_top_logprobs
        ],
        "text_offset": offsets,
    }


class OpenAIServer:
    """Serves one LLMEngine over HTTP. The request logic (``prepare``,
    ``complete``, ``stream_events``) is kept apart from the socket
    plumbing of ``make_handler``."""

    def __init__(self, engine: LLMEngine, model_name: Optional[str] = None):
        self.engine = engine
        self.model_name = model_name or engine.cfg.name
        self._started = time.time()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # ---- request parsing ------------------------------------------------

    def _gen_request(self, body: Dict[str, Any], prompt_ids, *, chat: bool,
                     json_mode: bool) -> GenRequest:
        stop = body.get("stop") or []
        if isinstance(stop, str):
            stop = [stop]
        max_tokens = int(
            body.get("max_tokens") or body.get("max_completion_tokens") or 128
        )
        if max_tokens < 1:
            raise ValueError(f"max_tokens must be >= 1, got {max_tokens}")
        seed = body.get("seed")
        logit_bias = body.get("logit_bias")
        if logit_bias is not None:
            if not isinstance(logit_bias, dict):
                raise ValueError("logit_bias must be {token_id: bias}")
            logit_bias = {int(k): float(v) for k, v in logit_bias.items()}
        if chat:
            want_logprobs = bool(body.get("logprobs"))
            top_lp = int(body.get("top_logprobs") or 0)
        else:
            raw = body.get("logprobs")
            want_logprobs = raw is not None and raw is not False
            top_lp = int(raw or 0) if not isinstance(raw, bool) else 0
        if top_lp < 0 or top_lp > MAX_TOP_LOGPROBS:
            raise ValueError(
                f"top_logprobs must be 0..{MAX_TOP_LOGPROBS}, got {top_lp}"
            )
        temperature = body.get("temperature")
        return GenRequest(
            prompt_ids=list(prompt_ids),
            max_tokens=max_tokens,
            temperature=1.0 if temperature is None else float(temperature),
            top_k=int(body.get("top_k") or 0),
            top_p=float(body.get("top_p") or 1.0),
            seed=None if seed is None else int(seed),
            logit_bias=logit_bias,
            stop_texts=tuple(str(s) for s in stop if s),
            logprobs=want_logprobs,
            top_logprobs=top_lp,
            json_mode=json_mode,
            request_id=str(uuid.uuid4()),
        )

    def _make_gens(self, body, prompt_ids, chat: bool, json_mode: bool):
        n = int(body.get("n") or 1)
        if n < 1 or n > MAX_N:
            raise ValueError(f"n must be 1..{MAX_N}, got {n}")
        gens = []
        for i in range(n):
            gen = self._gen_request(
                body, prompt_ids, chat=chat, json_mode=json_mode
            )
            if gen.seed is not None and i > 0:
                # per-choice seeds must differ or every choice is the same
                gen.seed = gen.seed + i
            gens.append(gen)
        return gens

    def _chat_prompt(self, body) -> Tuple[List[int], bool, bool]:
        """(prompt ids, tools_active, json_mode) for a chat body."""
        messages = body.get("messages")
        if not isinstance(messages, list) or not messages:
            raise HTTPError(400, "missing 'messages'")
        for m in messages:
            content = m.get("content") if isinstance(m, dict) else None
            if isinstance(content, list) and any(
                isinstance(p, dict) and p.get("type") == "image_url"
                for p in content
            ):
                raise HTTPError(
                    400,
                    f"model {self.model_name!r} does not accept image input",
                )
        tools = body.get("tools") or []
        tool_choice = body.get("tool_choice", "auto")
        tools_active = bool(tools) and tool_choice != "none"
        msgs = list(messages)
        if tools_active:
            forced = forced_function(tool_choice)
            if forced:
                msgs.append({
                    "role": "system",
                    "content": f'You MUST call the function "{forced}".',
                })
            elif tool_choice == "required":
                msgs.append({
                    "role": "system",
                    "content": "You MUST call one of the available functions.",
                })
        rf = body.get("response_format") or {}
        json_mode = False
        if isinstance(rf, dict) and rf.get("type") == "json_schema":
            raise HTTPError(
                400, "response_format json_schema is not supported by "
                "this engine yet; use json_object"
            )
        if isinstance(rf, dict) and rf.get("type") == "json_object":
            json_mode = True
            msgs.append({"role": "system", "content": JSON_MODE_INSTRUCTION})
        try:
            prompt_ids = self.engine.tokenizer.apply_chat_template(
                msgs, tools=tools if tools_active else None
            )
        except Exception as e:  # tokenizer/template errors: client's
            raise HTTPError(400, f"chat template failed: {e}") from e
        return prompt_ids, tools_active, json_mode

    # ---- responses ------------------------------------------------------

    def healthz(self) -> Tuple[int, Dict[str, Any]]:
        health = self.engine.health()
        return (200 if health["status"] == "ok" else 503), health

    def models(self) -> Dict[str, Any]:
        return {
            "object": "list",
            "data": [{
                "id": self.model_name,
                "object": "model",
                "created": int(self._started),
                "owned_by": "gpustack_tpu_torch",
            }],
        }

    def prepare(self, path: str, body: Dict[str, Any]):
        """Parse a completion body into (gens, chat, tools_active)."""
        chat = path == "/v1/chat/completions"
        tools_active = json_mode = False
        if chat:
            prompt_ids, tools_active, json_mode = self._chat_prompt(body)
        else:
            prompt = body.get("prompt")
            if prompt is None:
                raise HTTPError(400, "missing 'prompt'")
            if isinstance(prompt, list):
                prompt = prompt[0] if prompt else ""
            prompt_ids = self.engine.tokenizer.encode(str(prompt))
        try:
            gens = self._make_gens(body, prompt_ids, chat, json_mode)
        except (TypeError, ValueError) as e:
            raise HTTPError(400, f"bad sampling params: {e}") from e
        return gens, chat, tools_active

    def submit_all(self, gens: List[GenRequest]) -> None:
        try:
            for gen in gens:
                self.engine.submit(gen)
        except ValueError as e:
            for gen in gens:
                gen.abort()
            raise HTTPError(400, str(e)) from e

    def complete(self, gens, chat: bool, tools_active: bool) -> Dict[str, Any]:
        """Non-streaming response body (after the gens were submitted)."""
        deadline = time.monotonic() + GENERATION_TIMEOUT_S
        for gen in gens:
            if not gen.done.wait(max(0.1, deadline - time.monotonic())):
                for g in gens:
                    g.abort()
                raise HTTPError(504, "generation timed out")
        tok = self.engine.tokenizer
        choices = []
        for i, gen in enumerate(gens):
            if chat:
                content: Optional[str] = gen.output_text
                tool_calls: List[Dict[str, Any]] = []
                if tools_active:
                    content, tool_calls = parse_tool_calls(gen.output_text)
                    content = content or None
                message: Dict[str, Any] = {
                    "role": "assistant", "content": content,
                }
                if tool_calls:
                    message["tool_calls"] = tool_calls
                choice = {
                    "index": i,
                    "message": message,
                    "finish_reason": (
                        "tool_calls" if tool_calls else gen.finish_reason
                    ),
                }
                if gen.logprobs:
                    choice["logprobs"] = _chat_logprobs(gen, tok)
            else:
                choice = {
                    "index": i,
                    "text": gen.output_text,
                    "finish_reason": gen.finish_reason,
                }
                if gen.logprobs:
                    choice["logprobs"] = _completion_logprobs(gen, tok)
            choices.append(choice)
        payload = {
            "id": f"{'chatcmpl' if chat else 'cmpl'}-{gens[0].request_id}",
            "object": "chat.completion" if chat else "text_completion",
            "created": int(time.time()),
            "model": self.model_name,
            "choices": choices,
            "usage": _usage(gens),
        }
        if gens[0].seed is not None:
            payload["system_fingerprint"] = SYSTEM_FINGERPRINT
        return payload

    def stream_events(self, gens, chat: bool, tools_active: bool):
        """Yield the SSE payload dicts of a streaming response (after the
        gens were submitted with stream queues); the caller writes them."""
        rid = f"{'chatcmpl' if chat else 'cmpl'}-{gens[0].request_id}"
        obj = "chat.completion.chunk" if chat else "text_completion"

        def chunk_for(index: int, delta_or_text, finish=None) -> dict:
            body_ = (
                {"delta": delta_or_text} if chat
                else {"text": delta_or_text}
            )
            payload = {
                "id": rid, "object": obj, "created": int(time.time()),
                "model": self.model_name,
                "choices": [{"index": index, **body_,
                             "finish_reason": finish}],
            }
            if gens[0].seed is not None:
                payload["system_fingerprint"] = SYSTEM_FINGERPRINT
            return payload

        if chat:
            for i in range(len(gens)):
                yield chunk_for(i, {"role": "assistant", "content": ""})
        holdbacks = [
            ToolCallHoldback() if (chat and tools_active) else None
            for _ in gens
        ]
        deadline = time.monotonic() + GENERATION_TIMEOUT_S
        for i, gen in enumerate(gens):
            # choices stream one after another (each queue is complete by
            # its None sentinel); tokens of later choices wait in order
            while True:
                try:
                    item = gen.stream.get(
                        timeout=max(0.1, deadline - time.monotonic())
                    )
                except queue.Empty:
                    raise HTTPError(504, "generation timed out") from None
                if item is None:
                    break
                _tok, piece = item
                hb = holdbacks[i]
                if hb is not None:
                    piece = hb.filter(piece)
                if piece:
                    yield chunk_for(i, {"content": piece} if chat else piece)
        for i, gen in enumerate(gens):
            gen.done.wait(max(0.1, deadline - time.monotonic()))
            had_calls = False
            hb = holdbacks[i]
            if hb is not None:
                if hb.in_call:
                    held_content, calls = parse_tool_calls(hb.pending)
                    if calls:
                        had_calls = True
                        yield chunk_for(i, {"tool_calls": [
                            {"index": ci, "id": c["id"], "type": "function",
                             "function": c["function"]}
                            for ci, c in enumerate(calls)
                        ]})
                    if held_content:
                        yield chunk_for(i, {"content": held_content})
                else:
                    tail = hb.flush()
                    if tail:
                        yield chunk_for(i, {"content": tail})
            final = chunk_for(
                i, {} if chat else "",
                "tool_calls" if had_calls else gen.finish_reason,
            )
            if gen.logprobs:
                final["choices"][0]["logprobs"] = (
                    _chat_logprobs(gen, self.engine.tokenizer) if chat
                    else _completion_logprobs(gen, self.engine.tokenizer)
                )
            if i == len(gens) - 1:
                final["usage"] = _usage(gens)
            yield final

    # ---- HTTP plumbing --------------------------------------------------

    def make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # route to logging
                logger.debug("%s " + fmt, self.address_string(), *args)

            def _send_json(self, status: int, payload) -> None:
                data = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path == "/healthz":
                    self._send_json(*server.healthz())
                elif self.path == "/v1/models":
                    self._send_json(200, server.models())
                else:
                    self._send_json(404, _error_body("not found"))

            def do_POST(self):
                if self.path not in ("/v1/completions", "/v1/chat/completions"):
                    self._send_json(404, _error_body("not found"))
                    return
                try:
                    length = int(self.headers.get("Content-Length") or 0)
                    body = json.loads(self.rfile.read(length) or b"{}")
                    if not isinstance(body, dict):
                        raise HTTPError(400, "body must be a JSON object")
                    gens, chat, tools_active = server.prepare(self.path, body)
                    stream = bool(body.get("stream"))
                    if stream:
                        for gen in gens:
                            gen.stream = queue.Queue()
                    server.submit_all(gens)
                except json.JSONDecodeError:
                    self._send_json(400, _error_body("invalid JSON body"))
                    return
                except HTTPError as e:
                    self._send_json(e.status, _error_body(e.message))
                    return
                if not stream:
                    try:
                        payload = server.complete(gens, chat, tools_active)
                    except HTTPError as e:
                        self._send_json(e.status, _error_body(e.message))
                        return
                    self._send_json(200, payload)
                    return
                self._stream(gens, chat, tools_active)

            def _chunk(self, data: bytes) -> None:
                self.wfile.write(b"%x\r\n%s\r\n" % (len(data), data))
                self.wfile.flush()

            def _stream(self, gens, chat, tools_active) -> None:
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                try:
                    for payload in server.stream_events(
                        gens, chat, tools_active
                    ):
                        self._chunk(
                            f"data: {json.dumps(payload)}\n\n".encode()
                        )
                    self._chunk(b"data: [DONE]\n\n")
                    self.wfile.write(b"0\r\n\r\n")
                except (HTTPError, OSError):
                    # client gone or timed out: the headers are out, so
                    # end the connection; the engine frees the slots
                    self.close_connection = True
                finally:
                    for gen in gens:
                        gen.abort()

        return Handler

    def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Serve in a background thread; returns the bound port."""
        self._httpd = ThreadingHTTPServer((host, port), self.make_handler())
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="openai-http", daemon=True
        )
        self._thread.start()
        return self._httpd.server_address[1]

    def shutdown(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)


# ---------------------------------------------------------------------------
# Process entry point
# ---------------------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("gpustack-tpu-torch engine API server")
    p.add_argument("--model-dir", default="")
    p.add_argument("--preset", default="llama3-8b")
    p.add_argument("--served-name", default="")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=9000)
    p.add_argument("--max-slots", type=int, default=8)
    p.add_argument("--max-seq-len", type=int, default=2048)
    p.add_argument(
        "--pipeline-depth", type=int, default=2,
        help="decode-fetch pipeline depth (dispatch-ahead overlap): "
        "0 = serial reference mode",
    )
    p.add_argument(
        "--device", default=None,
        help="torch device (default: the CUDA card; 'cpu' to run on the "
        "CPU — never chosen implicitly)",
    )
    return p


def build_engine_from_args(args) -> LLMEngine:
    from gpustack_tpu_torch.device import resolve_device
    from gpustack_tpu_torch.engine.weights import load_or_init_params
    from gpustack_tpu_torch.models.config import get_config, load_hf_config

    device = resolve_device(args.device)
    cfg = load_hf_config(args.model_dir) if args.model_dir else get_config(
        args.preset
    )
    params = load_or_init_params(cfg, args.model_dir or None, device=device)
    return LLMEngine(
        cfg, params,
        model_dir=args.model_dir or None,
        max_slots=args.max_slots,
        max_seq_len=args.max_seq_len,
        pipeline_depth=args.pipeline_depth,
        device=device,
    )


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    engine = build_engine_from_args(args)
    engine.start()
    server = OpenAIServer(engine, model_name=args.served_name or None)
    port = server.start(args.host, args.port)
    logger.info("serving %s on %s:%d", engine.cfg.name, args.host, port)
    try:
        # a dead scheduling loop is terminal for this process
        while not engine._fatal:
            time.sleep(2.0)
        logger.error("terminating: %s", engine._fatal)
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        engine.stop()
    if engine._fatal:
        os._exit(13)


if __name__ == "__main__":
    main()
