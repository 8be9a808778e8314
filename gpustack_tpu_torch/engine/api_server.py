"""OpenAI-compatible HTTP front for the PyTorch engine (standard library).

The port of ``gpustack_tpu/engine/api_server.py``'s serving surface:
``GET /healthz``, ``GET /v1/models``, ``GET /metrics`` (Prometheus text:
engine gauges, host KV cache, spill tier, flight recorder, TTFT/TPOT/e2e
histograms), ``GET /debug/flight`` (raw flight records and aggregates),
``POST /debug/profile`` (a ``torch.profiler`` capture of the next steps),
``POST /v1/completions`` and ``POST /v1/chat/completions`` (streaming and
not; streamed choices interleave; ``response_format`` ``json_object`` or
``json_schema``, a schema validated with one guided retry), ``POST
/v1/embeddings`` and ``POST /v1/rerank``, with the same JSON shapes.
``--speculative ngram|draft`` serves greedy speculative decoding
(requests that leave temperature unset default to 0 there). Chat
messages may carry ``image_url`` parts (``data:`` PNG URLs) when the
engine has a vision bundle (``engine.vision``; ``--preset tiny-vlm``
builds one, on rank 0 of a multi-GPU replica): the prompt is built on
the handler thread (``models/vlm.build_mm_prompt``) and its image
embeddings ride the request to one fused prefill. The audio routes are
``engine/audio_server.py``'s.

Disaggregated prefill/decode serving (with a host KV cache): ``POST
/kv/export`` (a prompt's cached blocks as ``kv_transfer`` frames,
prefilling on a miss), ``POST /kv/import``, ``GET``/``POST /kv/summary``
(the cluster KV directory's scrape) and ``POST /kv/pull`` (202, then a
background pull). A completion whose request carries
``X-GPUStack-KV-Source: <peer>/kv/export`` first pulls its prompt's blocks
from that peer, so it prefills only the tail; ``--kv-role`` tags the
replica. Peers are reached with ``http.client`` on the handler's thread.
On a multi-GPU replica (each rank holds its own KV heads of every
block) ``/kv/summary`` serves rank 0's tier (the replica's keys), an
export gathers the ranks' heads into whole-head frames and an import
scatters each rank its heads, so the frames are a one-process tier's;
under ``sp`` the routes answer 400 naming the plan.

It runs on ``http.server.ThreadingHTTPServer`` (one thread per
connection; each handler blocks on its request's ``done`` event or token
queue) and streams Server-Sent Events as HTTP/1.1 chunked transfer.

Run: ``python -m gpustack_tpu_torch.engine.api_server --preset llama3-8b``
(on the card; ``--device cpu`` for a CPU run).
"""

from __future__ import annotations

import argparse
import base64
import concurrent.futures
import dataclasses
import http.client
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
from gpustack_tpu_torch.engine.json_schema import (
    SchemaError,
    ValidationError,
    check_schema,
    validate,
)
from gpustack_tpu_torch.engine.kv_fabric import (
    DEFAULT_SUMMARY_KEYS,
    conversation_chain,
)
from gpustack_tpu_torch.engine.kv_transfer import (
    MAGIC,
    FrameDecoder,
    decode_stream,
    encode_block,
    prepare_import,
)
from gpustack_tpu_torch.engine.openai_tools import (
    JSON_MODE_INSTRUCTION,
    ToolCallHoldback,
    forced_function,
    parse_tool_calls,
)
from gpustack_tpu_torch.observability.tracing import trace_middleware

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


@dataclasses.dataclass
class _Call:
    """One parsed completion request."""

    body: Dict[str, Any]
    gens: List[GenRequest]
    chat: bool
    tools_active: bool = False
    json_mode: bool = False
    schema: Any = None                  # a json_schema's schema, else None
    msgs: Optional[List[Dict[str, Any]]] = None   # the templated messages
    conv_chain: Optional[List[str]] = None        # for the KV directory
    # an image chat's (embeds [T, D], mask [T]) for the engine
    embeds_override: Optional[Tuple[Any, Any]] = None


def _post_stream(url: str, payload, auth: str, deadline: float):
    """POST ``payload`` as JSON to a peer's ``url`` and yield the response
    body as it arrives (``http.client``; ``deadline`` on the monotonic
    clock bounds the whole exchange). Raises on a status other than 200,
    a cut stream or the deadline; the chunks already yielded stand."""
    u = urlsplit(url)
    if u.scheme not in ("http", "https") or not u.hostname:
        raise ValueError(f"kv source {url!r} is not an http(s) URL")

    def remaining() -> float:
        left = deadline - time.monotonic()
        if left <= 0:
            raise TimeoutError("kv transfer exceeded its timeout")
        return left

    cls = (http.client.HTTPSConnection if u.scheme == "https"
           else http.client.HTTPConnection)
    conn = cls(u.hostname, u.port, timeout=remaining())
    try:
        headers = {"Content-Type": "application/json"}
        if auth:
            headers["Authorization"] = auth
        conn.request(
            "POST", (u.path or "/") + (f"?{u.query}" if u.query else ""),
            body=json.dumps(payload), headers=headers,
        )
        # the socket itself: a response that closes the connection takes
        # it over from ``conn``
        sock = conn.sock
        resp = conn.getresponse()
        if resp.status != 200:
            raise RuntimeError(f"peer answered HTTP {resp.status}")
        while True:
            sock.settimeout(remaining())
            chunk = resp.read1(1 << 20)
            if not chunk:
                break
            yield chunk
        if resp.length:
            # the peer closed before its Content-Length (a cut chunked
            # body raises inside read1)
            raise http.client.IncompleteRead(b"", resp.length)
    finally:
        conn.close()


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
        # background prefetch pulls (POST /kv/pull) by outcome, for the
        # gpustack_kv_prefetch_total family
        self.prefetch_ok = 0
        self.prefetch_failed = 0

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

    def _make_gens(self, body, prompt_ids, chat: bool, json_mode: bool,
                   embeds_override=None):
        n = int(body.get("n") or 1)
        if n < 1 or n > MAX_N:
            raise ValueError(f"n must be 1..{MAX_N}, got {n}")
        gens = []
        for i in range(n):
            gen = self._gen_request(
                body, prompt_ids, chat=chat, json_mode=json_mode
            )
            gen.embeds_override = embeds_override
            if gen.seed is not None and i > 0:
                # per-choice seeds must differ or every choice is the same
                gen.seed = gen.seed + i
            gens.append(gen)
        return gens

    def _chat_prompt(self, body) -> Tuple[List[int], _Call]:
        """(prompt ids, the call's chat fields) for a chat body. A
        ``response_format`` of ``json_object`` or ``json_schema`` is JSON
        mode; a ``json_schema`` that carries a schema is checked here (400
        before any generation) and rides the system instruction. Image
        parts need the engine's vision bundle: the prompt is then built by
        ``build_mm_prompt`` here, on the request's handler thread (decode,
        resize and the tower's forward), never on the scheduler thread."""
        messages = body.get("messages")
        if not isinstance(messages, list) or not messages:
            raise HTTPError(400, "missing 'messages'")
        has_images = any(
            isinstance(m, dict) and isinstance(m.get("content"), list)
            and any(
                isinstance(p, dict) and p.get("type") == "image_url"
                for p in m["content"]
            )
            for m in messages
        )
        vision = getattr(self.engine, "vision", None)   # as JAX reads it
        if has_images and vision is None:
            raise HTTPError(
                400, f"model {self.model_name!r} does not accept image input",
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
        json_mode = isinstance(rf, dict) and rf.get("type") in (
            "json_object", "json_schema"
        )
        schema = None
        if json_mode:
            instruction = JSON_MODE_INSTRUCTION
            spec = rf.get("json_schema") or {}
            if not isinstance(spec, dict):
                raise HTTPError(400, "json_schema must be an object")
            schema = spec.get("schema")
            if schema:
                # a broken schema is the client's: refuse it now instead of
                # spending two generations that can only fail
                if not isinstance(schema, (dict, bool)):
                    raise HTTPError(
                        400, "json_schema.schema must be an object"
                    )
                try:
                    check_schema(schema)
                except SchemaError as e:
                    raise HTTPError(
                        400, f"invalid json_schema: {e.message}"
                    ) from None
                instruction += (
                    " The object must conform to this JSON schema: "
                    + json.dumps(schema)
                )
            elif not isinstance(schema, (dict, bool)):
                schema = None        # no schema: JSON mode alone
            msgs.append({"role": "system", "content": instruction})
        embeds_override = None
        if has_images:
            from gpustack_tpu_torch.engine.tokenizer import (
                _inject_tools_fallback,
            )
            from gpustack_tpu_torch.models.vlm import build_mm_prompt

            # the multimodal prompt takes no tools= kwarg: the function
            # schemas ride the system-block fallback
            if tools_active:
                msgs = _inject_tools_fallback(msgs, tools)
            try:
                prompt_ids, embeds, mask = build_mm_prompt(
                    self.engine.tokenizer, msgs, vision
                )
            except ValueError as e:
                raise HTTPError(400, str(e)) from None
            embeds_override = (embeds, mask)
        else:
            try:
                prompt_ids = self.engine.tokenizer.apply_chat_template(
                    msgs, tools=tools if tools_active else None
                )
            except Exception as e:  # tokenizer/template errors: client's
                raise HTTPError(400, f"chat template failed: {e}") from e
        call = _Call(
            body=body, gens=[], chat=True, tools_active=tools_active,
            json_mode=json_mode, schema=schema, msgs=msgs,
            embeds_override=embeds_override,
        )
        if self.engine.kv_conv is not None:
            # the message-prefix hashes the proxy's affinity map and the
            # cluster KV directory key on; recorded at finish
            call.conv_chain = conversation_chain(self.model_name, messages)
        return prompt_ids, call

    # ---- responses ------------------------------------------------------

    def healthz(self) -> Tuple[int, Dict[str, Any]]:
        health = self.engine.health()
        return (200 if health["status"] == "ok" else 503), health

    def metrics(self) -> str:
        """Prometheus exposition text: the family names and shapes the JAX
        engine's exporter emits."""
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
        # disaggregated KV handoff: wire bytes and blocks per direction,
        # pull failures (the seconds histogram rides the loop below)
        ho = self.engine.kv_handoff
        for family, in_, out_ in (
            ("gpustack_kv_handoff_bytes_total", ho.bytes_in, ho.bytes_out),
            ("gpustack_kv_handoff_blocks_total", ho.blocks_in,
             ho.blocks_out),
        ):
            lines += [
                type_line(family),
                f'{family}{{direction="in"}} {in_}',
                f'{family}{{direction="out"}} {out_}',
            ]
        family = "gpustack_kv_handoff_failures_total"
        lines += [type_line(family), f"{family} {ho.failures}"]
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
        if self.engine.host_kv_cache is not None:
            family = "gpustack_kv_prefetch_total"
            lines += [
                type_line(family),
                f'{family}{{result="ok"}} {self.prefetch_ok}',
                f'{family}{{result="failed"}} {self.prefetch_failed}',
            ]
        lines += self.engine.flight.metrics_lines()
        for name, hist in (
            ("gpustack_engine_ttft_seconds", self.engine.ttft_hist),
            ("gpustack_engine_tpot_seconds", self.engine.tpot_hist),
            ("gpustack_engine_e2e_seconds", self.engine.e2e_hist),
            ("gpustack_kv_handoff_seconds", ho.seconds),
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

    def prepare(self, path: str, body: Dict[str, Any]) -> _Call:
        """Parse a completion body into its :class:`_Call`."""
        if path == "/v1/chat/completions":
            prompt_ids, call = self._chat_prompt(body)
        else:
            prompt = body.get("prompt")
            if prompt is None:
                raise HTTPError(400, "missing 'prompt'")
            if isinstance(prompt, list):
                prompt = prompt[0] if prompt else ""
            prompt_ids = self.engine.tokenizer.encode(str(prompt))
            call = _Call(body=body, gens=[], chat=False)
        try:
            call.gens = self._make_gens(
                body, prompt_ids, call.chat, call.json_mode,
                call.embeds_override,
            )
        except (TypeError, ValueError) as e:
            raise HTTPError(400, f"bad sampling params: {e}") from e
        return call

    def submit_all(self, gens: List[GenRequest]) -> None:
        try:
            for gen in gens:
                self.engine.submit(gen)
        except ValueError as e:
            for gen in gens:
                gen.abort()
            raise HTTPError(400, str(e)) from e

    def _validate_schema(self, call: _Call, gen: GenRequest,
                         remaining_s: float, allow_retry: bool):
        """Validate a finished generation against the request's schema,
        with one guided retry on failure (the failed attempt and the
        validator's message re-enter the prompt). Returns (the winning
        request, ``passed`` or ``failed: ...``, the retry or None; the
        retry comes back for usage). Schemas are validated, not enforced
        by a grammar, so the verdict always rides the choice."""
        schema = call.schema

        def verdict_of(text):
            try:
                validate(json.loads(text), schema)
                return "passed"
            except json.JSONDecodeError as e:
                return f"failed: not valid JSON ({e})"
            except ValidationError as e:
                return f"failed: {e.message}"

        verdict = verdict_of(gen.output_text)
        if verdict == "passed" or not allow_retry or remaining_s < 30:
            return gen, verdict, None
        try:
            # a family template may refuse assistant-then-system turns: a
            # retry that cannot be rendered keeps the first verdict
            retry_ids = self.engine.tokenizer.apply_chat_template(
                call.msgs + [
                    {"role": "assistant", "content": gen.output_text},
                    {"role": "system", "content": (
                        "Your JSON failed schema validation: "
                        f"{verdict[:400]}. Respond again with ONLY a "
                        "corrected JSON object."
                    )},
                ]
            )
            retry = self._gen_request(
                call.body, retry_ids, chat=True, json_mode=True
            )
            self.engine.submit(retry)
        except Exception as e:
            logger.warning("schema retry not possible: %s", e)
            return gen, verdict, None
        if not retry.done.wait(remaining_s):
            # the orphan ends at its max_tokens on its own
            logger.warning("schema retry timed out; keeping original")
            return gen, verdict, retry
        return retry, verdict_of(retry.output_text), retry

    def complete(self, call: _Call) -> Dict[str, Any]:
        """Non-streaming response body (after the gens were submitted)."""
        gens, chat, tools_active = call.gens, call.chat, call.tools_active
        deadline = time.monotonic() + GENERATION_TIMEOUT_S
        for gen in gens:
            if not gen.done.wait(max(0.1, deadline - time.monotonic())):
                for g in gens:
                    g.abort()
                raise HTTPError(504, "generation timed out")
        self._record_conv(call)
        # usage bills the client's prompt once and everything generated,
        # a discarded schema attempt included
        usage = _usage(gens)
        verdicts: List[Optional[str]] = [None] * len(gens)
        if call.schema is not None:
            for i in range(len(gens)):
                # a tool-call turn is no schema violation: the contract
                # holds for the final content answer
                if tools_active and parse_tool_calls(
                    gens[i].output_text
                )[1]:
                    continue
                # a length-cut attempt would only be cut again, and a
                # retry re-templates without the images: validate only
                allow_retry = (
                    len(gens) == 1 and gens[i].finish_reason != "length"
                    and call.embeds_override is None
                )
                gens[i], verdicts[i], retry = self._validate_schema(
                    call, gens[i], max(0.0, deadline - time.monotonic()),
                    allow_retry,
                )
                if retry is not None:
                    usage["completion_tokens"] += len(retry.output_ids)
                    usage["total_tokens"] += len(retry.output_ids)
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
                if verdicts[i] is not None:
                    choice["x_schema_validation"] = verdicts[i]
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
            "usage": usage,
        }
        if gens[0].seed is not None:
            payload["system_fingerprint"] = SYSTEM_FINGERPRINT
        return payload

    def stream_events(self, call: _Call):
        """Yield the SSE payload dicts of a streaming response (after the
        gens were submitted with stream queues); the caller writes them.
        Choices interleave as their tokens arrive: one reader thread per
        choice feeds a merged queue."""
        gens, chat, tools_active = call.gens, call.chat, call.tools_active
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
        merged: "queue.Queue" = queue.Queue()

        def pump(i: int, gen: GenRequest) -> None:
            # a bounded get, so a reader notices an aborted request (the
            # client gone) instead of waiting on its queue for good
            while True:
                try:
                    item = gen.stream.get(timeout=0.5)
                except queue.Empty:
                    if gen.aborted.is_set():
                        return
                    continue
                merged.put((i, item))
                if item is None:
                    return

        for i, gen in enumerate(gens):
            threading.Thread(
                target=pump, args=(i, gen), name=f"sse-choice-{i}",
                daemon=True,
            ).start()
        deadline = time.monotonic() + GENERATION_TIMEOUT_S
        open_streams = len(gens)
        while open_streams:
            try:
                i, item = merged.get(
                    timeout=max(0.1, deadline - time.monotonic())
                )
            except queue.Empty:
                raise HTTPError(504, "generation timed out") from None
            if item is None:
                open_streams -= 1
                continue
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
            if call.schema is not None:
                # a stream cannot be validated after the fact: say so
                final["choices"][0]["x_schema_validation"] = (
                    "skipped (stream)"
                )
            if gen.logprobs:
                final["choices"][0]["logprobs"] = (
                    _chat_logprobs(gen, self.engine.tokenizer) if chat
                    else _completion_logprobs(gen, self.engine.tokenizer)
                )
            if i == len(gens) - 1:
                final["usage"] = _usage(gens)
            yield final
        self._record_conv(call)

    def _record_conv(self, call: _Call) -> None:
        """Feed the conversation index at chat finish: the message-prefix
        hash chain and the token sequence whose KV blocks the cache now
        holds (prompt + generated: what the next turn prefix-matches)."""
        conv = self.engine.kv_conv
        if not call.conv_chain or conv is None:
            return
        g = call.gens[0]
        try:
            conv.record(call.conv_chain, list(g.prompt_ids) + list(g.output_ids))
        except Exception:  # accounting never fails a request
            logger.exception("conversation-index record failed")

    # ---- disaggregated KV handoff ---------------------------------------

    @staticmethod
    def _handoff_timeout() -> float:
        return float(
            os.environ.get("GPUSTACK_TPU_KV_HANDOFF_TIMEOUT") or 10.0
        )

    def _kv_cache(self):
        cache = self.engine.host_kv_cache
        if cache is None:
            raise HTTPError(404, "engine has no host KV cache")
        return cache

    def kv_export(self, body: Dict[str, Any]) -> Tuple[List[bytes], int]:
        """The host cache's matched block run for a prompt as wire frames
        (``kv_transfer``): ``(chunks, payload blocks)``.

        Body: ``{"prompt_ids": [...], "have": [hex...], "prefill": bool}``
        or ``{"tail_key": hex}``. ``have`` keys travel as token-only dedup
        frames. ``prefill`` on a miss first runs a one-token generation,
        so a prefill-role replica can hand over a prompt it has never
        seen: the disaggregated hop (the prefill compute happens here; the
        decode replica imports the blocks and prefills only the tail).
        ``tail_key`` (fleet prefetch: the puller has only the directory's
        chain key) walks the chain back from that block."""
        cache = self._kv_cache()
        try:
            prompt_ids = [int(t) for t in body.get("prompt_ids") or []]
        except (TypeError, ValueError):
            raise HTTPError(400, "'prompt_ids' must be integers") from None
        tail_key = str(body.get("tail_key") or "")
        if not prompt_ids and not tail_key:
            raise HTTPError(400, "missing 'prompt_ids' or 'tail_key'")
        have = frozenset(str(k) for k in body.get("have") or [])
        want = (
            (len(prompt_ids) - 1) // cache.block_tokens * cache.block_tokens
            if prompt_ids else 0
        )
        if body.get("prefill") and want > 0 and (
            cache.peek_prefix_len(prompt_ids) < want
        ):
            err = self._prefill_for_export(prompt_ids, want)
            if err:
                raise HTTPError(503, err)
        # one trie walk: encode straight off the export and count payload
        # frames as they are made (a second walk could disagree under a
        # concurrent eviction)
        try:
            blocks = self.engine.kv_export_blocks(
                prompt_ids, tail_key, have, timeout=self._handoff_timeout())
        except concurrent.futures.TimeoutError:
            raise HTTPError(503, "kv export did not run within "
                            f"{self._handoff_timeout()}s; retry") from None
        chunks, payload_blocks = [MAGIC], 0
        for blk in blocks:
            frame, carried = encode_block(blk, have)
            chunks.append(frame)
            payload_blocks += int(carried)
        return chunks, payload_blocks

    def _prefill_for_export(self, prompt_ids, want_tokens: int) -> str:
        """Run a one-token generation so the prompt's KV lands in the host
        cache (the prefill's own store), then wait, bounded, until it can
        be matched. Returns an error message, or "" on success."""
        timeout = self._handoff_timeout()
        try:
            self.engine.generate(GenRequest(
                prompt_ids=list(prompt_ids), max_tokens=1, temperature=0.0,
            ), timeout=timeout)
        except (TimeoutError, ValueError) as e:
            return f"prefill for export failed: {e}"
        cache = self.engine.host_kv_cache
        deadline = time.monotonic() + timeout
        while (
            cache.peek_prefix_len(prompt_ids) < want_tokens
            and time.monotonic() < deadline
        ):
            time.sleep(0.01)
        return ""

    def kv_import(self, raw: bytes) -> Tuple[int, Dict[str, Any]]:
        """Land wire frames (a prefill replica's push, or a relay) in the
        host cache through the engine's stager: decoding slots never wait
        on the insert."""
        eng = self.engine
        cache = self._kv_cache()
        try:
            tokens, prepared, bytes_in = prepare_import(
                cache, decode_stream(raw)
            )
        except ValueError as e:
            eng.kv_handoff.failures += 1
            return 400, _error_body(str(e))
        timeout = self._handoff_timeout()
        try:
            attached = eng.kv_import_prepared(tokens, prepared).result(
                timeout
            )
        except concurrent.futures.TimeoutError:
            eng.kv_handoff.failures += 1
            return 503, _error_body(
                f"kv import did not land within {timeout}s (stager busy); "
                "retry"
            )
        eng.kv_handoff.bytes_in += bytes_in
        return 200, {
            "blocks_attached": attached,
            "tokens": len(tokens),
            "bytes": bytes_in,
        }

    def kv_summary(self, body: Dict[str, Any]) -> Tuple[int, Dict[str, Any]]:
        """The cluster KV directory's scrape: fold the fleet's sharing
        counts into the local eviction score, then return this replica's
        bounded prefix-key summary, re-checked against both cache tiers
        now. Body (all optional): ``{"sharing": {hash: replicas},
        "max_keys": n}``."""
        cache = self._kv_cache()
        conv = self.engine.kv_conv
        sharing = body.get("sharing") or {}
        if not isinstance(sharing, dict):
            return 400, _error_body("'sharing' must be an object")
        try:
            max_keys = int(body.get("max_keys") or DEFAULT_SUMMARY_KEYS)
        except (TypeError, ValueError):
            return 400, _error_body("'max_keys' must be an integer")
        boosted = conv.apply_sharing(cache, sharing)
        summary = conv.summary(cache, max_keys=max(1, max_keys))
        summary["sharing_boosted"] = boosted
        return 200, summary

    def kv_pull(self, body: Dict[str, Any]) -> Tuple[int, Dict[str, Any]]:
        """Background prefetch (the fleet fabric's warm-ahead): pull a
        conversation's block chain from a peer by its directory-advertised
        tail chain key. Answers 202 at once; the pull runs on a thread of
        its own, and a dead or slow source leaves this replica cold, with
        the failure counted."""
        self._kv_cache()
        source = str(body.get("source") or "")
        tail_key = str(body.get("tail_key") or "")
        if not source or not tail_key:
            return 400, _error_body("missing 'source' or 'tail_key'")
        auth = str(body.get("auth") or "")
        threading.Thread(
            target=self._kv_pull_chain, args=(source, auth, tail_key),
            name="kv-pull", daemon=True,
        ).start()
        return 202, {"accepted": True}

    def _pull_frames(self, source: str, payload, auth: str,
                     deadline: float):
        """The frames a peer streams for ``payload``, and the fault that
        ended the stream ("" when none): frames complete before a fault
        stand."""
        decoder, frames = FrameDecoder(), []
        try:
            for chunk in _post_stream(source, payload, auth, deadline):
                frames.extend(decoder.feed(chunk))
        except Exception as e:  # any peer fault ends the stream
            return frames, str(e) or type(e).__name__
        return frames, ""

    def _land(self, frames, deadline: float) -> Tuple[int, int]:
        """Import frames through the engine's stager: (blocks attached,
        wire bytes)."""
        eng = self.engine
        tokens, prepared, bytes_in = prepare_import(eng.host_kv_cache, frames)
        blocks = eng.kv_import_prepared(tokens, prepared).result(
            max(0.5, deadline - time.monotonic())
        )
        eng.kv_handoff.bytes_in += bytes_in
        return blocks, bytes_in

    def _kv_pull_chain(self, source: str, auth: str, tail_key: str) -> None:
        """The prefetch pull: stream the peer's chain export and land it
        through the stager. Failures are counted and logged, never raised:
        prefetch is advisory."""
        deadline = time.monotonic() + self._handoff_timeout()
        frames, failed = self._pull_frames(
            source, {"tail_key": tail_key}, auth, deadline
        )
        try:
            if failed or not frames:
                raise RuntimeError(failed or "peer exported no blocks")
            blocks, bytes_in = self._land(frames, deadline)
        except Exception as e:  # advisory: the replica stays cold
            self.prefetch_failed += 1
            logger.warning(
                "kv prefetch from %s failed (replica stays cold): %s",
                source, str(e) or type(e).__name__,
            )
            return
        self.prefetch_ok += 1
        logger.info("kv prefetch from %s landed %d block(s) (%d bytes)",
                    source, blocks, bytes_in)

    def kv_prefetch(self, source: str, prompt_ids, auth: str = "",
                    trace=None):
        """Pull the prompt's prefix blocks from a peer before the
        generation is submitted: the decode half of the disaggregated
        handoff (``X-GPUStack-KV-Source``). Never fails the request: a
        dead peer, a cut stream or a slow transfer leaves a cold (or
        partly warm) prefill, with the failure counted, logged and traced
        (the hop's ``kv_handoff`` phase and event on ``trace``); the
        complete frames that arrived before a failure are imported.
        Returns what happened (``None`` when nothing was pulled)."""
        cache = self.engine.host_kv_cache
        stats = self.engine.kv_handoff
        bt = cache.block_tokens
        want_tokens = (len(prompt_ids) - 1) // bt * bt
        if want_tokens <= 0:
            return None
        have = cache.prefix_keys(prompt_ids)
        if len(have) * bt >= want_tokens:
            return None          # the whole run is already here
        t0 = time.monotonic()
        deadline = t0 + self._handoff_timeout()
        stats.pulls += 1
        frames, failed = self._pull_frames(
            source,
            {"prompt_ids": [int(t) for t in prompt_ids], "have": have,
             "prefill": True},
            auth, deadline,
        )
        imported = bytes_in = 0
        if frames:
            try:
                imported, bytes_in = self._land(frames, deadline)
            except Exception as e:
                failed = failed or (str(e) or type(e).__name__)
        dur = time.monotonic() - t0
        stats.seconds.observe(dur)
        if failed:
            stats.failures += 1
            logger.warning(
                "kv handoff from %s failed after %.3fs (%d block(s) landed; "
                "continuing cold): %s", source, dur, imported, failed,
            )
        if trace is not None:
            # the engine hop's kv_handoff phase: transfer + import wait
            trace.add_phase("kv_handoff", dur)
            attrs = dict(source=source, blocks=imported, bytes=bytes_in)
            if failed:
                attrs["failed"] = failed
            trace.event("kv_handoff", **attrs)
        return {"source": source, "blocks": imported, "bytes": bytes_in,
                "seconds": dur, "failed": failed}

    @staticmethod
    def _trace_kv(trace, gens: List[GenRequest]) -> None:
        """Attach the host KV tier's phases to this hop's trace: the
        ``kv_upload`` span (the host→device upload of matched prefix
        blocks, measured by the engine) and a ``kv_prefix_hit`` event with
        the reused-token count."""
        if trace is None:
            return
        upload_s = sum(g.kv_upload_s for g in gens)
        if upload_s > 0:
            trace.add_phase("kv_upload", upload_s)
        reused = sum(g.prefix_tokens_reused for g in gens)
        if reused:
            trace.event("kv_prefix_hit", tokens_reused=reused)

    # ---- HTTP plumbing --------------------------------------------------

    def make_handler(self):
        server = self

        # the engine is the last hop of the trace: the middleware adopts
        # the worker proxy's traceparent and logs this hop's trace=… line
        @trace_middleware("engine")
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
                elif url.path == "/kv/summary":
                    self._json_route(server.kv_summary, b"")
                else:
                    self._send_json(404, _error_body("not found"))

            def _json_route(self, route, raw: bytes) -> None:
                try:
                    body = json.loads(raw or b"{}")
                    if not isinstance(body, dict):
                        raise HTTPError(400, "body must be a JSON object")
                    self._send_json(*route(body))
                except json.JSONDecodeError:
                    self._send_json(400, _error_body("invalid JSON body"))
                except HTTPError as e:
                    self._send_json(e.status, _error_body(e.message))

            def do_POST(self):
                url = urlsplit(self.path)
                length = int(self.headers.get("Content-Length") or 0)
                raw = self.rfile.read(length)
                if url.path == "/debug/profile":
                    self._send_json(*server.debug_profile(url.query))
                    return
                if url.path == "/kv/import":
                    try:
                        self._send_json(*server.kv_import(raw))
                    except HTTPError as e:
                        self._send_json(e.status, _error_body(e.message))
                    return
                if url.path == "/kv/export":
                    self._kv_export(raw)
                    return
                route = {
                    "/v1/embeddings": server.embeddings,
                    "/v1/rerank": server.rerank,
                    "/kv/summary": server.kv_summary,
                    "/kv/pull": server.kv_pull,
                }.get(url.path)
                if route is not None:
                    self._json_route(route, raw)
                    return
                if url.path not in ("/v1/completions", "/v1/chat/completions"):
                    self._send_json(404, _error_body("not found"))
                    return
                try:
                    body = json.loads(raw or b"{}")
                    if not isinstance(body, dict):
                        raise HTTPError(400, "body must be a JSON object")
                    call = server.prepare(url.path, body)
                    # disaggregated handoff: the peer named in the header
                    # holds (or prefills) this prompt's prefix; pull its
                    # blocks before admission so the start prefix-hits
                    source = self.headers.get("X-GPUStack-KV-Source", "")
                    if source and server.engine.host_kv_cache is not None and (
                        call.embeds_override is None
                    ):
                        server._kv_cache()
                        server.kv_prefetch(
                            source, call.gens[0].prompt_ids,
                            self.headers.get("X-GPUStack-KV-Source-Auth", ""),
                            self.trace,
                        )
                    stream = bool(body.get("stream"))
                    if stream:
                        for gen in call.gens:
                            gen.stream = queue.Queue()
                    server.submit_all(call.gens)
                except json.JSONDecodeError:
                    self._send_json(400, _error_body("invalid JSON body"))
                    return
                except HTTPError as e:
                    self._send_json(e.status, _error_body(e.message))
                    return
                if not stream:
                    try:
                        payload = server.complete(call)
                    except HTTPError as e:
                        self._send_json(e.status, _error_body(e.message))
                        return
                    server._trace_kv(self.trace, call.gens)
                    self._send_json(200, payload)
                    return
                self._stream(call)

            def _kv_export(self, raw: bytes) -> None:
                try:
                    body = json.loads(raw or b"{}")
                    if not isinstance(body, dict):
                        raise HTTPError(400, "body must be a JSON object")
                    chunks, payload_blocks = server.kv_export(body)
                except json.JSONDecodeError:
                    self._send_json(400, _error_body("invalid JSON body"))
                    return
                except HTTPError as e:
                    self._send_json(e.status, _error_body(e.message))
                    return
                stats = server.engine.kv_handoff
                self.send_response(200)
                self.send_header("Content-Type", "application/x-gpustack-kv")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                try:
                    for chunk in chunks:
                        self._chunk(chunk)
                        stats.bytes_out += len(chunk)
                    # counted before the last chunk: a puller that has
                    # read the whole stream sees the count
                    stats.blocks_out += payload_blocks
                    self.wfile.write(b"0\r\n\r\n")
                except OSError:
                    self.close_connection = True

            def _chunk(self, data: bytes) -> None:
                self.wfile.write(b"%x\r\n%s\r\n" % (len(data), data))
                self.wfile.flush()

            def _stream(self, call) -> None:
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                try:
                    for payload in server.stream_events(call):
                        self._chunk(
                            f"data: {json.dumps(payload)}\n\n".encode()
                        )
                    self._chunk(b"data: [DONE]\n\n")
                    self.wfile.write(b"0\r\n\r\n")
                    server._trace_kv(self.trace, call.gens)
                except (HTTPError, OSError):
                    # client gone or timed out: the headers are out, so
                    # end the connection; the engine frees the slots
                    self.close_connection = True
                finally:
                    for gen in call.gens:
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
        "--kv-role", choices=["", "prefill", "decode"], default="",
        help="disaggregated serving role tag: a prefill replica hands its "
        "prompts' KV blocks over /kv/export, a decode replica pulls them "
        "for requests naming X-GPUStack-KV-Source (needs "
        "--host-kv-cache-mb)",
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
    p.add_argument(
        "--mesh-plan", default="",
        help="explicit parallelism plan, e.g. 'tp4' or 'ep2xtp2' (default: "
        "planned from --num-devices, the model's KV heads and experts)",
    )
    p.add_argument(
        "--num-devices", type=int, default=None,
        help="GPUs of one replica (default 1): with N > 1 this process is "
        "rank 0, serves HTTP and starts N - 1 follower processes, one per "
        "GPU (under --device cpu, processes on the CPU over gloo)",
    )
    return p


# The replica's environment contract (the JAX server's): set from outside,
# these make this process one rank; a rank-0 server with --num-devices > 1
# sets them for the followers it starts.
ENV_COORDINATOR = "GPUSTACK_TPU_COORDINATOR"
ENV_NUM_PROCESSES = "GPUSTACK_TPU_NUM_PROCESSES"
ENV_PROCESS_ID = "GPUSTACK_TPU_PROCESS_ID"
ENV_CMD_ADDRESS = "GPUSTACK_TPU_CMD_ADDRESS"
ENV_CMD_TOKEN = "GPUSTACK_TPU_CMD_TOKEN"
# a follower started by a rank-0 server exits when that server is gone
ENV_PARENT_PID = "GPUSTACK_TPU_PARENT_PID"


def _argv_of(args) -> List[str]:
    """The command line that parses to ``args`` (the flags that differ
    from their defaults), for the followers a rank-0 server starts."""
    argv: List[str] = []
    for action in build_parser()._actions:
        if not action.option_strings or action.dest == "help":
            continue
        value = getattr(args, action.dest, action.default)
        if value == action.default:
            continue
        flag = action.option_strings[0]
        if isinstance(action, argparse._StoreTrueAction):
            argv.append(flag)
        elif isinstance(action, argparse._AppendAction):
            for v in value:
                argv += [flag, str(v)]
        else:
            argv += [flag, str(value)]
    return argv


def _refuse_multi_gpu(args, cfg, plan) -> None:
    """What a multi-GPU replica cannot serve, refused before any weight
    is read, naming the plan: what the JAX runner refuses under ``sp``
    (``dp > 1``, a ``max_seq_len`` that does not divide) and what the
    plan cannot cut (``check_plan``)."""
    from gpustack_tpu_torch.models.transformer import check_plan

    if plan.sp > 1 and plan.dp != 1:
        # the JAX runner's refusal, in its words
        raise ValueError(
            "sp>1 serving requires dp=1 (one sequence-sharded replica); "
            f"got plan {plan}"
        )
    if plan.sp > 1 and args.max_seq_len % plan.sp:
        raise ValueError(
            f"plan {plan}: max_seq_len {args.max_seq_len} must divide "
            f"evenly over sp={plan.sp}"
        )
    check_plan(cfg, plan)


def _start_followers(args, plan) -> Tuple[Dict[str, str], list]:
    """Rank 0 of a replica started by hand: free ports for the rendezvous
    and the command channel, a fresh token, and one follower process per
    other rank (this module, the same flags, the environment contract,
    the package importable whatever the working directory). Returns
    (this process's environment view, the follower processes)."""
    import secrets
    import subprocess
    import sys

    from gpustack_tpu_torch.parallel.mesh import free_port

    env = {
        ENV_COORDINATOR: f"127.0.0.1:{free_port()}",
        ENV_NUM_PROCESSES: str(plan.chips),
        ENV_CMD_ADDRESS: f"127.0.0.1:{free_port()}",
        ENV_CMD_TOKEN: secrets.token_hex(16),
    }
    argv = _argv_of(args)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    path = os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH", "")) if p)
    procs = []
    for rank in range(1, plan.chips):
        child = dict(os.environ, **env, **{
            ENV_PROCESS_ID: str(rank), ENV_PARENT_PID: str(os.getpid()),
            "PYTHONPATH": path,
        })
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "gpustack_tpu_torch.engine.api_server",
             *argv], env=child,
        ))
    return dict(env, **{ENV_PROCESS_ID: "0"}), procs


def _watch_followers(procs, joined: threading.Event) -> None:
    """Until ``joined`` is set: a follower that exits means the
    rendezvous can never complete, and this rank would wait in it for its
    whole timeout. End the process, naming the follower."""
    def watch():
        while not joined.wait(0.5):
            for rank, proc in enumerate(procs, start=1):
                code = proc.poll()
                if code is not None:
                    logger.error(
                        "follower rank %d exited (code %d) before the "
                        "replica's rendezvous; exiting", rank, code,
                    )
                    for other in procs:
                        if other.poll() is None:
                            other.kill()
                    os._exit(13)

    threading.Thread(target=watch, name="follower-watch", daemon=True).start()


def _placement(args, cfg):
    """This process's place in its replica: ``(plan, rank, env, procs)``.
    The plan is chosen as the JAX server chooses it: ``--mesh-plan``, else
    ``plan_mesh`` over ``--num-devices`` (default 1). ``env`` is the
    replica's environment contract (empty on one GPU), ``procs`` the
    followers this process started."""
    from gpustack_tpu_torch.parallel.mesh import MeshPlan, plan_mesh

    if args.mesh_plan:
        plan = MeshPlan.parse(args.mesh_plan)
    else:
        plan = plan_mesh(args.num_devices or 1, cfg.num_kv_heads,
                         cfg.num_experts)
    n_env = int(os.environ.get(ENV_NUM_PROCESSES) or 0)
    if n_env and n_env != plan.chips:
        raise ValueError(
            f"plan {plan} needs {plan.chips} processes, "
            f"{ENV_NUM_PROCESSES}={n_env}"
        )
    if plan.chips == 1:
        return plan, 0, {}, []
    _refuse_multi_gpu(args, cfg, plan)
    if os.environ.get(ENV_COORDINATOR):
        env = {k: os.environ[k] for k in (
            ENV_COORDINATOR, ENV_NUM_PROCESSES, ENV_PROCESS_ID,
            ENV_CMD_ADDRESS,
        )}
        env[ENV_CMD_TOKEN] = os.environ.get(ENV_CMD_TOKEN, "")
        return plan, int(env[ENV_PROCESS_ID]), env, []
    env, procs = _start_followers(args, plan)
    return plan, 0, env, procs


def _watch_parent(pid: int) -> None:
    """Exit when the rank-0 process that started this follower is gone
    (it may die before the command channel would tell)."""
    def watch():
        while os.getppid() == pid:
            time.sleep(1.0)
        logger.error("the rank-0 server (pid %d) is gone; exiting", pid)
        os._exit(14)

    threading.Thread(target=watch, name="parent-watch", daemon=True).start()


def shutdown_replica(engine, timeout: float = 60.0) -> None:
    """Stop a replica's rank 0 (its engine already stopped): close the
    command channel, which ends every follower, reap the followers it
    started (killing any that outlive ``timeout``), leave the process
    group."""
    import subprocess

    from gpustack_tpu_torch.parallel.mesh import close_mesh

    if hasattr(engine.runner, "close"):
        engine.runner.close()
    for proc in engine.follower_procs:
        try:
            proc.wait(timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    close_mesh(engine.mesh)


def build_engine_from_args(args) -> LLMEngine:
    """Config, then weights, then the LoRA merge, then int8: the JAX
    package's order, for every family (dense, MoE, MLA). Config and
    weights come from the same checkpoint (``checkpoint_source``:
    safetensors before GGUF); without one, ``--quantization int8`` draws
    the int8 tree of any family directly on the device. Before any weight
    is read, a config the card's kernels cannot serve is refused
    (``check_kernel_shapes``; on the card that refuses ``tiny-vlm``, whose
    language half has head_dim 16). A VLM preset serves its language half
    in the engine and attaches the vision tower as ``engine.vision`` (on
    a multi-GPU replica, rank 0's alone).

    Multi-GPU (``--num-devices`` or ``--mesh-plan`` over more than one
    GPU, or the environment contract set from outside): this process is
    one rank. It joins the replica's process group (NCCL on the card,
    gloo under ``--device cpu``), builds only its shard of the weights
    (random ones drawn whole a layer at a time and cut, so they equal the
    one-card tree's slice; a checkpoint read on the host and cut), and
    wires the command channel: rank 0's runner broadcasts each op
    (``engine/multihost.py``), another rank's engine gets a
    ``follower_loop`` to run instead of a server. Rank 0 started without
    the environment starts the followers itself (``engine.follower_procs``;
    :func:`shutdown_replica` reaps them)."""
    import torch

    from gpustack_tpu_torch.device import rank_device, resolve_device
    from gpustack_tpu_torch.engine.gguf import config_from_gguf
    from gpustack_tpu_torch.engine.weights import (
        checkpoint_source,
        load_or_init_params,
        merge_lora_adapters,
        params_to_device,
    )
    from gpustack_tpu_torch.models.config import get_config, load_hf_config
    from gpustack_tpu_torch.models.quant import (
        init_quantized_params,
        quantize_params,
    )
    from gpustack_tpu_torch.models.transformer import check_kernel_shapes
    from gpustack_tpu_torch.models.vlm import (
        VLM_PRESETS,
        VisionBundle,
        get_vlm_config,
        init_vision_params,
    )

    from gpustack_tpu_torch.parallel.mesh import init_mesh
    from gpustack_tpu_torch.parallel.sharding import shard_params

    device = resolve_device(args.device)
    kind, path = checkpoint_source(args.model_dir or None)
    vlm_cfg = None
    if kind == "gguf":
        cfg = config_from_gguf(path, name=args.served_name or "")
    elif args.model_dir:
        cfg = load_hf_config(args.model_dir)
    elif args.preset in VLM_PRESETS:
        vlm_cfg = get_vlm_config(args.preset)
        cfg = vlm_cfg.language
    else:
        cfg = get_config(args.preset)
    plan, rank, env, procs = _placement(args, cfg)
    mesh = None
    if plan.chips > 1:
        if rank and os.environ.get(ENV_PARENT_PID):
            _watch_parent(int(os.environ[ENV_PARENT_PID]))
        device = rank_device(device, rank)
        joined = threading.Event()
        if procs:
            _watch_followers(procs, joined)
        mesh = init_mesh(plan, rank, env[ENV_COORDINATOR], device)
        joined.set()
    int8 = args.quantization == "int8"
    check_kernel_shapes(cfg, device, int8=int8, mesh=mesh)
    # a multi-GPU rank draws its shard alone
    shard = {} if mesh is None else {"mesh": mesh}
    if kind == "none" and int8 and not args.lora:
        params = init_quantized_params(cfg, seed=0, device=device, **shard)
    elif kind == "none" and not args.lora:
        params = load_or_init_params(cfg, None, seed=0, device=device,
                                     **shard)
    else:
        # a checkpoint (or LoRA) is read and merged whole, on the host
        # for a multi-GPU rank, then quantized and cut to the rank's shard
        params = load_or_init_params(
            cfg, args.model_dir or None, seed=0,
            device=device if mesh is None else "cpu",
        )
        if args.lora:
            params = merge_lora_adapters(cfg, params, args.lora)
        if int8:
            params = quantize_params(params)
        if mesh is not None:
            params = params_to_device(
                shard_params(params, mesh, kv_heads=cfg.num_kv_heads), device
            )
    draft_cfg = draft_params = None
    # the draft lives on rank 0's card alone (a follower never proposes)
    if args.speculative == "draft" and rank == 0:
        # the draft is never quantized, as in the JAX server; a preset
        # draws its weights from the target's seed
        source = args.draft_source
        if not source:
            raise ValueError("--speculative draft needs --draft-source")
        if os.path.isdir(source):
            draft_cfg = load_hf_config(source)
            check_kernel_shapes(draft_cfg, device, int8=False)
            draft_params = load_or_init_params(
                draft_cfg, source, seed=0, device=device
            )
        else:
            draft_cfg = get_config(source)
            check_kernel_shapes(draft_cfg, device, int8=False)
            draft_params = load_or_init_params(
                draft_cfg, None, seed=0, device=device
            )
    # the decode batch is dp-sharded: round the slots up to a multiple of
    # dp, as the JAX server does
    max_slots = args.max_slots
    if max_slots % plan.dp:
        rounded = (max_slots // plan.dp + 1) * plan.dp
        logger.warning(
            "max_slots=%d not divisible by mesh dp=%d; rounding up to %d",
            max_slots, plan.dp, rounded,
        )
        max_slots = rounded
    engine = LLMEngine(
        cfg, params,
        model_dir=args.model_dir or None,
        max_slots=max_slots,
        max_seq_len=args.max_seq_len,
        pipeline_depth=args.pipeline_depth,
        device=device,
        prefill_chunk=args.prefill_chunk,
        host_kv_cache_mb=args.host_kv_cache_mb,
        kv_block_tokens=args.kv_block_tokens,
        kv_cache_int8=args.kv_cache_int8,
        kv_spill_mb=args.kv_spill_mb,
        kv_spill_dir=args.kv_spill_dir,
        kv_role=args.kv_role,
        speculative=args.speculative if rank == 0 else "",
        spec_tokens=args.spec_tokens,
        draft_cfg=draft_cfg,
        draft_params=draft_params,
        plan=plan,
        mesh=mesh,
    )
    if mesh is not None:
        engine.follower_procs = procs
        from gpustack_tpu_torch.engine.multihost import (
            BroadcastingRunner,
            CommandLeader,
            FollowerLoop,
            FollowerTier,
        )

        cmd, token = env[ENV_CMD_ADDRESS], env[ENV_CMD_TOKEN]
        tier = engine.host_kv_cache
        if rank == 0:
            leader = CommandLeader(
                int(cmd.rsplit(":", 1)[1]), plan.chips - 1, token=token
            )
            engine.runner = BroadcastingRunner(engine.runner, leader)
            if tier is not None:
                tier.lead()         # rank 0's tier names what it changes
        else:
            engine.follower_loop = FollowerLoop(
                engine.runner, cmd, state=engine._state, token=token,
                tier=None if tier is None else FollowerTier(engine),
            )
    if vlm_cfg is not None and rank == 0:
        # the language tree takes the server's seed 0; the tower seed 1,
        # as the JAX server's key(1). On a multi-GPU replica the tower is
        # rank 0's alone: its server builds every image prompt, and the
        # rows reach the followers on the device (multihost.py)
        gen = torch.Generator(device=device)
        gen.manual_seed(1)
        engine.vision = VisionBundle(
            vlm_cfg, init_vision_params(vlm_cfg, gen), device
        )
    return engine


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    engine = build_engine_from_args(args)
    if engine.follower_loop is not None:
        # a follower rank serves no HTTP: it replays the leader's ops
        # until the leader closes the channel
        engine.follower_loop.start()
        engine.follower_loop.join()
        if engine.follower_loop.error:
            logger.error("follower: %s", engine.follower_loop.error)
            os._exit(13)
        os._exit(0)
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
        if engine.mesh is not None:
            shutdown_replica(engine, timeout=10.0)
    if engine._fatal:
        os._exit(13)


if __name__ == "__main__":
    main()
