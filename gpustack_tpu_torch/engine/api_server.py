"""OpenAI-compatible HTTP front for the PyTorch engine (standard library).

The port of ``gpustack_tpu/engine/api_server.py``'s serving surface:
``GET /healthz``, ``GET /v1/models``, ``GET /metrics`` (Prometheus text:
engine gauges, host KV cache, spill tier, flight recorder, TTFT/TPOT/e2e
histograms), ``GET /debug/flight`` (raw flight records and aggregates),
``POST /debug/profile`` (a ``torch.profiler`` capture of the next steps),
``POST /v1/completions`` and ``POST /v1/chat/completions`` (streaming and
not), ``POST /v1/embeddings`` and ``POST /v1/rerank``, with the same JSON
shapes. ``--speculative ngram|draft`` serves greedy speculative decoding
(requests that leave temperature unset default to 0 there). It runs on ``http.server.ThreadingHTTPServer`` (one thread per
connection; each handler blocks on its request's ``done`` event or token
queue) and streams Server-Sent Events as HTTP/1.1 chunked transfer.

Run: ``python -m gpustack_tpu_torch.engine.api_server --preset llama3-8b``
(on the card; ``--device cpu`` for a CPU run).
"""

from __future__ import annotations

import argparse
import base64
import json
import logging
import math
import os
import queue
import struct
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlsplit

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
PROFILE_MAX_TIMEOUT_S = 120.0


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


def _shrink(vec: List[float], dimensions: int) -> List[float]:
    """Matryoshka truncation: the first ``dimensions`` values,
    renormalised (OpenAI's ``dimensions``)."""
    cut = vec[:dimensions]
    norm = math.sqrt(sum(x * x for x in cut)) or 1.0
    return [x / norm for x in cut]


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
        if temperature is None:
            # a speculative deployment is greedy-only: the OpenAI default
            # of 1.0 would refuse every request that leaves it unset (an
            # explicit temperature still meets the engine's refusal)
            temperature = 0.0 if self.engine.speculative else 1.0
        return GenRequest(
            prompt_ids=list(prompt_ids),
            max_tokens=max_tokens,
            temperature=float(temperature),
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

    def metrics(self) -> str:
        """Prometheus exposition text: the family names and shapes the JAX
        engine's exporter emits, less the KV handoff and prefetch families
        (their routes are not ported yet)."""
        from gpustack_tpu_torch.observability.metrics import type_line

        h = self.engine.health()
        lines = [
            "# TYPE gpustack_engine_slots_used gauge",
            f"gpustack_engine_slots_used {h['slots_used']}",
            "# TYPE gpustack_engine_slots_total gauge",
            f"gpustack_engine_slots_total {h['slots_total']}",
            "# TYPE gpustack_engine_waiting gauge",
            f"gpustack_engine_waiting {h['waiting']}",
            "# TYPE gpustack_engine_decode_steps_total counter",
            f"gpustack_engine_decode_steps_total {h['steps']}",
            "# TYPE gpustack_engine_tokens_generated_total counter",
            f"gpustack_engine_tokens_generated_total {h['tokens_generated']}",
        ]
        for family, value in (
            ("gpustack_kv_cache_hits", h["kv_cache_hits"]),
            ("gpustack_kv_cache_misses", h["kv_cache_misses"]),
            (
                "gpustack_kv_cache_prefix_tokens_reused",
                h["kv_cache_prefix_tokens_reused"],
            ),
            ("gpustack_kv_cache_bytes", h["kv_cache_host_bytes"]),
        ):
            lines += [type_line(family), f"{family} {value}"]
        s = h["kv_spill"]
        if s:
            for family, out_, in_ in (
                ("gpustack_kv_spill_bytes_total",
                 s["bytes_spilled"], s["bytes_loaded"]),
                ("gpustack_kv_spill_blocks_total",
                 s["blocks_spilled"], s["blocks_loaded"]),
            ):
                lines += [
                    type_line(family),
                    f'{family}{{direction="out"}} {out_}',
                    f'{family}{{direction="in"}} {in_}',
                ]
            for family, value in (
                ("gpustack_kv_spill_resident_bytes", s["bytes"]),
                ("gpustack_kv_spill_corrupt_total", s["corrupt"]),
                ("gpustack_kv_spill_evictions_total", s["evictions"]),
                ("gpustack_kv_spill_faultbacks_total", h["kv_faultbacks"]),
            ):
                lines += [type_line(family), f"{family} {value}"]
        lines += self.engine.flight.metrics_lines()
        for name, hist in (
            ("gpustack_engine_ttft_seconds", self.engine.ttft_hist),
            ("gpustack_engine_tpot_seconds", self.engine.tpot_hist),
            ("gpustack_engine_e2e_seconds", self.engine.e2e_hist),
        ):
            cum, total, count = hist.snapshot()
            lines.append(f"# TYPE {name} histogram")
            for ub, c in cum:
                le = "+Inf" if ub == float("inf") else repr(ub)
                lines.append(f'{name}_bucket{{le="{le}"}} {c}')
            lines.append(f"{name}_sum {total:.6f}")
            lines.append(f"{name}_count {count}")
        return "\n".join(lines) + "\n"

    def debug_flight(self, query: str) -> Tuple[int, Dict[str, Any]]:
        """The most recent flight records plus windowed aggregates
        (``limit=`` caps the records, ``window_s=`` bounds the
        aggregate)."""
        q = parse_qs(query)
        try:
            limit = min(2048, int(q.get("limit", ["100"])[0]))
            window = q.get("window_s")
            window_s = float(window[0]) if window else None
        except ValueError:
            return 400, _error_body("limit/window_s must be numbers")
        flight = self.engine.flight
        return 200, {
            "model": self.model_name,
            "records": flight.snapshot(limit=limit),
            "aggregate": flight.aggregate(window_s=window_s),
            "overhead_ratio": round(flight.overhead_ratio(), 6),
        }

    def debug_profile(self, query: str) -> Tuple[int, Dict[str, Any]]:
        """On-demand profiler capture: wrap the next ``steps`` busy
        scheduler steps in ``torch.profiler``, writing a Chrome trace
        under ``out_dir`` (flight records only without one). Blocks until
        the steps elapse or ``timeout_s`` (at most 120) passes; 409 while
        another capture runs."""
        q = parse_qs(query)
        try:
            steps = int(q.get("steps", ["20"])[0])
            timeout_s = min(
                PROFILE_MAX_TIMEOUT_S, float(q.get("timeout_s", ["30"])[0])
            )
        except ValueError:
            return 400, _error_body("steps/timeout_s must be numbers")
        if steps < 1:
            return 400, _error_body("steps must be >= 1")
        out_dir = q.get("out_dir", [""])[0]
        try:
            return 200, self.engine.capture_profile(
                steps, out_dir=out_dir, timeout_s=timeout_s
            )
        except ValueError as e:
            return 409, _error_body(str(e))

    def _embed(self, batch):
        """(vectors, None), or (None, (status, error body))."""
        try:
            return self.engine.embed(batch, timeout=GENERATION_TIMEOUT_S), None
        except ValueError as e:
            return None, (400, _error_body(str(e)))
        except TimeoutError:
            return None, (504, _error_body("embedding timed out"))
        except RuntimeError as e:
            return None, (503, _error_body(f"engine unavailable: {e}"))

    def embeddings(self, body: Dict[str, Any]) -> Tuple[int, Dict[str, Any]]:
        """OpenAI embeddings: mean-pooled, l2-normalised hidden states of
        strings or token-id arrays; ``dimensions`` truncates and
        renormalises, ``encoding_format`` is ``float`` or ``base64``
        (little-endian float32)."""
        inputs = body.get("input")
        if inputs is None:
            return 400, _error_body("missing 'input'")
        if isinstance(inputs, str):
            inputs = [inputs]
        # a bare token array is one input
        if inputs and isinstance(inputs, list) and all(
            isinstance(x, int) for x in inputs
        ):
            inputs = [inputs]
        if not isinstance(inputs, list) or not inputs:
            return 400, _error_body("'input' must be a string or list")
        batch_ids = []
        for item in inputs:
            if isinstance(item, str):
                ids = self.engine.tokenizer.encode(item)
            elif isinstance(item, list) and all(
                isinstance(t, int) for t in item
            ):
                ids = list(item)
            else:
                return 400, _error_body(
                    "'input' items must be strings or token-id arrays"
                )
            if not ids:
                return 400, _error_body("'input' items must be non-empty")
            batch_ids.append(ids)
        dimensions = body.get("dimensions")
        if dimensions is not None and (
            isinstance(dimensions, bool) or not isinstance(dimensions, int)
        ):
            return 400, _error_body("'dimensions' must be an integer")
        if dimensions is not None and dimensions < 1:
            return 400, _error_body("'dimensions' must be positive")
        encoding_format = body.get("encoding_format", "float")
        if encoding_format not in ("float", "base64"):
            return 400, _error_body(
                "'encoding_format' must be float or base64"
            )
        vecs, err = self._embed(batch_ids)
        if err:
            return err
        if dimensions is not None:
            if dimensions > len(vecs[0]):
                return 400, _error_body(
                    f"'dimensions' {dimensions} exceeds the model's "
                    f"embedding size {len(vecs[0])}"
                )
            vecs = [_shrink(v, dimensions) for v in vecs]
        total = sum(len(ids) for ids in batch_ids)
        return 200, {
            "object": "list",
            "data": [
                {"object": "embedding", "index": i,
                 "embedding": (
                     base64.b64encode(
                         struct.pack(f"<{len(v)}f", *v)
                     ).decode() if encoding_format == "base64" else v
                 )}
                for i, v in enumerate(vecs)
            ],
            "model": self.model_name,
            "usage": {"prompt_tokens": total, "total_tokens": total},
        }

    def rerank(self, body: Dict[str, Any]) -> Tuple[int, Dict[str, Any]]:
        """Jina/Cohere-style rerank: documents ranked by the cosine of
        their embedding with the query's (one batched ``embed``)."""
        query = body.get("query")
        documents = body.get("documents")
        if not isinstance(query, str) or not query:
            return 400, _error_body("missing 'query'")
        if not isinstance(documents, list) or not documents or not all(
            isinstance(d, str) for d in documents
        ):
            return 400, _error_body("'documents' must be non-empty strings")
        try:
            top_n = int(body.get("top_n") or len(documents))
        except (TypeError, ValueError):
            return 400, _error_body("'top_n' must be an integer")
        if top_n <= 0:
            return 400, _error_body("'top_n' must be positive")
        tok = self.engine.tokenizer
        batch = [tok.encode(query)] + [tok.encode(d) for d in documents]
        if any(not ids for ids in batch):
            return 400, _error_body("query/documents must tokenize non-empty")
        vecs, err = self._embed(batch)
        if err:
            return err
        q = vecs[0]
        # embed() l2-normalises, so the dot product is the cosine
        scores = [sum(a * b for a, b in zip(d, q)) for d in vecs[1:]]
        order = sorted(range(len(scores)), key=lambda i: -scores[i])
        return 200, {
            "model": self.model_name,
            "object": "rerank",
            "results": [
                {"index": i, "relevance_score": scores[i],
                 "document": {"text": documents[i]}}
                for i in order[:top_n]
            ],
            "usage": {"total_tokens": sum(len(ids) for ids in batch)},
        }

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
                url = urlsplit(self.path)
                if url.path == "/healthz":
                    self._send_json(*server.healthz())
                elif url.path == "/v1/models":
                    self._send_json(200, server.models())
                elif url.path == "/metrics":
                    data = server.metrics().encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type", "text/plain; version=0.0.4"
                    )
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                elif url.path == "/debug/flight":
                    self._send_json(*server.debug_flight(url.query))
                else:
                    self._send_json(404, _error_body("not found"))

            def do_POST(self):
                url = urlsplit(self.path)
                length = int(self.headers.get("Content-Length") or 0)
                raw = self.rfile.read(length)
                if url.path == "/debug/profile":
                    self._send_json(*server.debug_profile(url.query))
                    return
                route = {
                    "/v1/embeddings": server.embeddings,
                    "/v1/rerank": server.rerank,
                }.get(url.path)
                if route is None and url.path not in (
                    "/v1/completions", "/v1/chat/completions"
                ):
                    self._send_json(404, _error_body("not found"))
                    return
                try:
                    body = json.loads(raw or b"{}")
                    if not isinstance(body, dict):
                        raise HTTPError(400, "body must be a JSON object")
                    if route is not None:
                        self._send_json(*route(body))
                        return
                    gens, chat, tools_active = server.prepare(url.path, body)
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
        "--prefill-chunk", type=int, default=0,
        help="chunked prefill: prompts longer than this many tokens are "
        "prefilled one chunk per scheduler step (0 = off)",
    )
    p.add_argument(
        "--host-kv-cache-mb", type=int, default=0,
        help="host-RAM block KV cache for prefix reuse, in MiB (0 = off)",
    )
    p.add_argument(
        "--kv-block-tokens", type=int, default=0,
        help="host KV cache block granularity in tokens (0 = 256)",
    )
    p.add_argument(
        "--kv-cache-int8", action="store_true",
        help="store host KV cache blocks as int8 with per-block scales",
    )
    p.add_argument(
        "--kv-spill-mb", type=int, default=0,
        help="disk spill tier under the host KV cache, in MiB (0 = off)",
    )
    p.add_argument(
        "--kv-spill-dir", default="",
        help="spill directory (default: a per-process temp directory)",
    )
    p.add_argument(
        "--quantization", choices=["", "int8"], default="",
        help="int8: weight-only int8 with per-channel scales, every weight "
        "product through the W8A16 kernel on the card",
    )
    p.add_argument(
        "--lora", action="append", default=[],
        help="PEFT LoRA adapter directory merged into the weights at load, "
        "before quantization (repeatable)",
    )
    p.add_argument(
        "--speculative", choices=["", "ngram", "draft"], default="",
        help="greedy speculative decoding: proposals from an n-gram index "
        "of each context, or from a draft model (--draft-source)",
    )
    p.add_argument(
        "--spec-tokens", type=int, default=4,
        help="positions verified per speculative step",
    )
    p.add_argument(
        "--draft-source", default="",
        help="draft model for --speculative draft: a preset name or a "
        "local checkpoint directory (never quantized)",
    )
    p.add_argument(
        "--device", default=None,
        help="torch device (default: the CUDA card; 'cpu' to run on the "
        "CPU — never chosen implicitly)",
    )
    return p


def build_engine_from_args(args) -> LLMEngine:
    """Config, then weights, then the LoRA merge, then int8: the JAX
    package's order. Config and weights come from the same checkpoint
    (``checkpoint_source``: safetensors before GGUF); without one,
    ``--quantization int8`` draws the int8 tree directly on the device."""
    from gpustack_tpu_torch.device import resolve_device
    from gpustack_tpu_torch.engine.gguf import config_from_gguf
    from gpustack_tpu_torch.engine.weights import (
        checkpoint_source,
        load_or_init_params,
        merge_lora_adapters,
    )
    from gpustack_tpu_torch.models.config import get_config, load_hf_config
    from gpustack_tpu_torch.models.quant import (
        init_quantized_params,
        quantize_params,
    )

    device = resolve_device(args.device)
    kind, path = checkpoint_source(args.model_dir or None)
    if kind == "gguf":
        cfg = config_from_gguf(path, name=args.served_name or "")
    elif args.model_dir:
        cfg = load_hf_config(args.model_dir)
    else:
        cfg = get_config(args.preset)
    if kind == "none" and args.quantization == "int8" and not args.lora:
        params = init_quantized_params(cfg, seed=0, device=device)
    else:
        params = load_or_init_params(
            cfg, args.model_dir or None, seed=0, device=device
        )
        if args.lora:
            params = merge_lora_adapters(cfg, params, args.lora)
        if args.quantization == "int8":
            params = quantize_params(params)
    draft_cfg = draft_params = None
    if args.speculative == "draft":
        # the draft is never quantized, as in the JAX server; a preset
        # draws its weights from the target's seed
        source = args.draft_source
        if not source:
            raise ValueError("--speculative draft needs --draft-source")
        if os.path.isdir(source):
            draft_cfg = load_hf_config(source)
            draft_params = load_or_init_params(
                draft_cfg, source, seed=0, device=device
            )
        else:
            draft_cfg = get_config(source)
            draft_params = load_or_init_params(
                draft_cfg, None, seed=0, device=device
            )
    return LLMEngine(
        cfg, params,
        model_dir=args.model_dir or None,
        max_slots=args.max_slots,
        max_seq_len=args.max_seq_len,
        pipeline_depth=args.pipeline_depth,
        device=device,
        prefill_chunk=args.prefill_chunk,
        host_kv_cache_mb=args.host_kv_cache_mb,
        kv_block_tokens=args.kv_block_tokens,
        kv_cache_int8=args.kv_cache_int8,
        kv_spill_mb=args.kv_spill_mb,
        kv_spill_dir=args.kv_spill_dir,
        speculative=args.speculative,
        spec_tokens=args.spec_tokens,
        draft_cfg=draft_cfg,
        draft_params=draft_params,
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
