"""OpenAI HTTP server of the PyTorch port, on the CPU.

The port's server runs in a thread over real sockets (``tiny``, float32,
weights carried across from one JAX init, byte tokenizer); the chat
answer must equal the JAX engine's greedy output for the same templated
prompt.
"""

import dataclasses
import http.client
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpustack_tpu.engine.engine import GenRequest as JaxGenRequest
from gpustack_tpu.engine.engine import LLMEngine as JaxLLMEngine
from gpustack_tpu.engine.tokenizer import ByteTokenizer
from gpustack_tpu.models import init_params
from gpustack_tpu.models.config import get_config as jax_get_config
from gpustack_tpu_torch.engine.api_server import OpenAIServer  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.engine import LLMEngine  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.weights import params_from_numpy  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.models.config import get_config  # analysis: ignore[metrics-drift]

MESSAGES = [{"role": "user", "content": "hi there"}]
MAX_TOKENS = 6


@pytest.fixture(scope="module")
def served():
    jcfg = dataclasses.replace(jax_get_config("tiny"), dtype="float32")
    jparams = init_params(jcfg, jax.random.key(0), dtype=jnp.float32)
    cfg = dataclasses.replace(get_config("tiny"), dtype="float32")
    eng = LLMEngine(
        cfg, params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu"),
        max_slots=2, max_seq_len=128, device="cpu",
    )
    eng.start()
    server = OpenAIServer(eng, model_name="tiny-test")
    port = server.start("127.0.0.1", 0)
    yield port, (jcfg, jparams)
    server.shutdown()
    eng.stop()


def _request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request(
            method, path,
            body=None if body is None else json.dumps(body),
            headers={"Content-Type": "application/json"},
        )
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read()
    finally:
        conn.close()


def _sse(raw: bytes):
    events = [
        line[len("data: "):] for line in raw.decode().split("\n")
        if line.startswith("data: ")
    ]
    assert events[-1] == "[DONE]"
    return [json.loads(e) for e in events[:-1]]


def test_healthz_and_models(served):
    port, _ = served
    status, _, body = _request(port, "GET", "/healthz")
    assert status == 200 and json.loads(body)["status"] == "ok"
    status, _, body = _request(port, "GET", "/v1/models")
    assert status == 200
    assert json.loads(body)["data"][0]["id"] == "tiny-test"
    assert _request(port, "GET", "/nope")[0] == 404


def test_chat_equals_jax_engine_greedy(served):
    port, (jcfg, jparams) = served
    status, _, body = _request(port, "POST", "/v1/chat/completions", {
        "messages": MESSAGES, "max_tokens": MAX_TOKENS, "temperature": 0,
    })
    assert status == 200
    data = json.loads(body)
    assert data["object"] == "chat.completion"
    text = data["choices"][0]["message"]["content"]

    jeng = JaxLLMEngine(jcfg, jparams, max_slots=1, max_seq_len=128)
    jeng.start()
    try:
        want = jeng.generate(JaxGenRequest(
            prompt_ids=ByteTokenizer().apply_chat_template(MESSAGES),
            max_tokens=MAX_TOKENS, temperature=0.0,
        ), timeout=300)
    finally:
        jeng.stop()
    assert text == want.output_text
    assert data["usage"]["completion_tokens"] == len(want.output_ids)
    assert data["usage"]["prompt_tokens"] == len(want.prompt_ids)


def test_streaming_chat_matches_non_streaming(served):
    port, _ = served
    body = {"messages": MESSAGES, "max_tokens": MAX_TOKENS, "temperature": 0}
    _, _, plain = _request(port, "POST", "/v1/chat/completions", body)
    status, ctype, raw = _request(
        port, "POST", "/v1/chat/completions", {**body, "stream": True}
    )
    assert status == 200 and ctype == "text/event-stream"
    chunks = _sse(raw)
    assert chunks[0]["choices"][0]["delta"]["role"] == "assistant"
    streamed = "".join(
        c["choices"][0]["delta"].get("content", "") for c in chunks
    )
    assert streamed == json.loads(plain)["choices"][0]["message"]["content"]
    assert chunks[-1]["choices"][0]["finish_reason"] in ("stop", "length")
    assert chunks[-1]["usage"]["completion_tokens"] >= 1


def test_completions_and_streaming_completions(served):
    port, _ = served
    body = {"prompt": "hello", "max_tokens": 4, "temperature": 0}
    status, _, raw = _request(port, "POST", "/v1/completions", body)
    assert status == 200
    data = json.loads(raw)
    assert data["object"] == "text_completion"
    assert data["usage"]["completion_tokens"] >= 1
    status, _, raw = _request(
        port, "POST", "/v1/completions", {**body, "stream": True}
    )
    chunks = _sse(raw)
    assert "".join(c["choices"][0]["text"] for c in chunks) == (
        data["choices"][0]["text"]
    )


def test_logprobs_and_seed_fields(served):
    port, _ = served
    _, _, raw = _request(port, "POST", "/v1/chat/completions", {
        "messages": MESSAGES, "max_tokens": 3, "temperature": 0.7,
        "seed": 5, "logprobs": True, "top_logprobs": 2,
    })
    data = json.loads(raw)
    content = data["choices"][0]["logprobs"]["content"]
    assert len(content) == data["usage"]["completion_tokens"]
    assert all(len(e["top_logprobs"]) == 2 for e in content)
    assert data["system_fingerprint"]


@pytest.mark.parametrize("path,body,status", [
    ("/v1/chat/completions", {"max_tokens": 2}, 400),
    ("/v1/completions", {"max_tokens": 2}, 400),
    ("/v1/completions", {"prompt": "x", "max_tokens": -1}, 400),
    ("/v1/completions", {"prompt": "x" * 200}, 400),   # >= max_seq_len
    ("/v1/chat/completions", {     # a schema the server cannot check
        "messages": MESSAGES,
        "response_format": {"type": "json_schema", "json_schema": {
            "schema": {"type": "not-a-real-type"},
        }},
    }, 400),
])
def test_bad_requests_are_client_errors(served, path, body, status):
    port, _ = served
    got, _, raw = _request(port, "POST", path, body)
    assert got == status
    assert "message" in json.loads(raw)["error"]
