"""The port's OpenAI surface against the JAX server's: ``response_format``
``json_schema`` (with and without a schema) and streamed choices that
interleave.

- The port's own JSON Schema validator (``engine/json_schema.py``) is held
  to ``jsonschema`` (which the port never imports) on a seeded corpus of
  schemas and instances of the subset it serves: the same verdict for
  every pair, and ``check_schema`` refusing what ``jsonschema`` refuses.
- The four ``json_schema`` tests of ``tests/engine/test_openai_surface.py``
  (validated, retry and flag, bad schema, stream skipped) are mirrored
  over a scripted engine.
- A schema-less ``json_schema`` is JSON mode, as in JAX: the port's greedy
  answer (``tiny``, float32, weights carried from one JAX init) equals the
  JAX engine's JSON-mode answer for the same templated prompt.
- ``n`` = 2 streamed: choice 1's first chunk comes before choice 0's last.
"""

import dataclasses
import http.client
import json
import threading
import time

import jax
import jax.numpy as jnp
import jsonschema
import numpy as np
import pytest

from gpustack_tpu.engine.engine import GenRequest as JaxGenRequest
from gpustack_tpu.engine.engine import LLMEngine as JaxLLMEngine
from gpustack_tpu.engine.openai_tools import (
    JSON_MODE_INSTRUCTION as JAX_JSON_MODE_INSTRUCTION,
)
from gpustack_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from gpustack_tpu.models import init_params
from gpustack_tpu.models.config import get_config as jax_get_config
from gpustack_tpu_torch.engine import json_schema as js  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.api_server import OpenAIServer  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.engine import LLMEngine  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.tokenizer import ByteTokenizer  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.weights import params_from_numpy  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.models.config import get_config  # analysis: ignore[metrics-drift]

# ---------------------------------------------------------------------------
# the validator against jsonschema
# ---------------------------------------------------------------------------

TYPES = list(js.TYPES)


def _schema(rng, depth=0):
    """A random schema of the served subset."""
    s = {}
    if rng.random() < 0.8:
        if rng.random() < 0.2:
            s["type"] = list(rng.choice(TYPES, size=2, replace=False))
        else:
            s["type"] = str(rng.choice(TYPES))
    if rng.random() < 0.2:
        s["enum"] = [_instance(rng, 1) for _ in range(rng.integers(1, 4))]
    if depth < 2 and rng.random() < 0.5:
        names = [f"k{i}" for i in range(rng.integers(1, 4))]
        s["properties"] = {n: _schema(rng, depth + 1) for n in names}
        if rng.random() < 0.6:
            s["required"] = names[: rng.integers(1, len(names) + 1)]
    if depth < 2 and rng.random() < 0.3:
        s["items"] = _schema(rng, depth + 1)
    if rng.random() < 0.1:
        s["description"] = "annotated"
    if rng.random() < 0.05:
        return bool(rng.integers(0, 2))
    return s


def _instance(rng, depth=0):
    kind = rng.integers(0, 9 if depth < 2 else 7)
    return [
        lambda: None, lambda: True, lambda: False,
        lambda: int(rng.integers(-3, 4)),
        lambda: float(rng.integers(-3, 4)),
        lambda: float(rng.normal()),
        lambda: str(rng.choice(["a", "b", "k0"])),
        lambda: [_instance(rng, depth + 1)
                 for _ in range(rng.integers(0, 3))],
        lambda: {f"k{i}": _instance(rng, depth + 1)
                 for i in range(rng.integers(0, 4))},
    ][kind]()


def _jsonschema_verdict(instance, schema):
    try:
        jsonschema.validate(instance, schema)
        return True
    except jsonschema.ValidationError:
        return False


def _port_verdict(instance, schema):
    try:
        js.validate(instance, schema)
        return True
    except js.ValidationError:
        return False


@pytest.mark.parametrize("seed", range(4))
def test_validator_agrees_with_jsonschema(seed):
    """200 seeded schemas of the subset, 10 instances each: the same
    verdict as ``jsonschema``, and every schema accepted by both."""
    rng = np.random.default_rng(seed)
    agreed = failed = 0
    for _ in range(200):
        schema = _schema(rng)
        js.check_schema(schema)
        jsonschema.validators.validator_for(schema).check_schema(schema)
        for _ in range(10):
            inst = _instance(rng)
            want = _jsonschema_verdict(inst, schema)
            assert _port_verdict(inst, schema) == want, (schema, inst)
            agreed += 1
            failed += not want
    assert failed > agreed // 10      # the corpus holds both verdicts


@pytest.mark.parametrize("schema,needle", [
    ({"type": "not-a-real-type"}, "not-a-real-type"),
    ({"type": []}, "type"),
    ({"required": "name"}, "required"),
    ({"properties": {"a": {"type": "strin"}}}, "strin"),
    ({"items": [{"type": "string"}]}, "items"),
    ({"enum": "a"}, "enum"),
    ("object", "object or a boolean"),
])
def test_check_schema_refuses_what_jsonschema_refuses(schema, needle):
    with pytest.raises(jsonschema.SchemaError):
        jsonschema.validators.validator_for(schema).check_schema(schema)
    with pytest.raises(js.SchemaError) as e:
        js.check_schema(schema)
    assert needle in e.value.message


@pytest.mark.parametrize("keyword,value", [
    ("additionalProperties", False),
    ("minimum", 0),
    ("pattern", "^a"),
    ("anyOf", [{"type": "string"}]),
    ("$ref", "#/definitions/x"),
])
def test_unsupported_keyword_is_refused_by_name(keyword, value):
    """A keyword outside the subset is never accepted and left unchecked:
    ``check_schema`` names it (``jsonschema`` would enforce it)."""
    schema = {"type": "object", "properties": {"a": {keyword: value}}}
    with pytest.raises(js.SchemaError) as e:
        js.check_schema(schema)
    assert repr(keyword) in e.value.message


# ---------------------------------------------------------------------------
# the server over a scripted engine
# ---------------------------------------------------------------------------


class ScriptedEngine:
    """Engine stand-in: every request emits ``script_text`` (streamed as
    ``pieces``, each ``pace_s`` after the last)."""

    speculative = ""
    kv_conv = None
    host_kv_cache = None

    def __init__(self, script_text, pieces=None, pace_s=0.0):
        self.tokenizer = ByteTokenizer()
        self.script_text = script_text
        self.pieces = pieces or [script_text]
        self.pace_s = pace_s
        self.submitted = []

        class _Cfg:
            name = "scripted"

        self.cfg = _Cfg()

    def health(self):
        return {"status": "ok"}

    def submit(self, gen):
        self.submitted.append(gen)

        def run():
            gen.output_ids = self.tokenizer.encode(self.script_text)
            gen.output_text = self.script_text
            gen.finish_reason = "stop"
            if gen.stream is not None:
                for p in self.pieces:
                    time.sleep(self.pace_s)
                    gen.stream.put((0, p))
                gen.stream.put(None)
            gen.done.set()

        threading.Thread(target=run, daemon=True).start()
        return gen


@pytest.fixture
def scripted():
    servers = []

    def serve(text, pieces=None, pace_s=0.0):
        engine = ScriptedEngine(text, pieces, pace_s)
        server = OpenAIServer(engine, model_name="scripted")
        servers.append(server)
        return server.start("127.0.0.1", 0), engine

    yield serve
    for s in servers:
        s.shutdown()


def _request(port, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", path, body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _sse(raw: bytes):
    events = [line[len("data: "):] for line in raw.decode().split("\n")
              if line.startswith("data: ")]
    assert events[-1] == "[DONE]"
    return [json.loads(e) for e in events[:-1]]


def _schema_body(schema, **extra):
    return {
        "model": "scripted",
        "messages": [{"role": "user", "content": "weather json"}],
        "response_format": {
            "type": "json_schema",
            "json_schema": {"name": "w", "schema": schema},
        },
        **extra,
    }


def test_json_schema_validated_and_reported(scripted):
    port, engine = scripted('{"name": "SF", "temp": 18}')
    schema = {
        "type": "object",
        "properties": {
            "name": {"type": "string"}, "temp": {"type": "number"},
        },
        "required": ["name", "temp"],
    }
    status, raw = _request(port, "/v1/chat/completions", _schema_body(schema))
    assert status == 200, raw
    data = json.loads(raw)
    assert data["choices"][0]["x_schema_validation"] == "passed"
    # the schema rides the JSON-mode instruction, as in JAX
    prompt = engine.tokenizer.decode(engine.submitted[0].prompt_ids)
    assert json.dumps(schema) in prompt
    assert engine.submitted[0].json_mode


def test_json_schema_failure_retries_and_flags(scripted):
    """Invalid output gets ONE guided retry; a still-invalid result is
    flagged, and the retry's tokens are billed."""
    port, engine = scripted('{"name": "SF"}')            # missing 'temp'
    status, raw = _request(port, "/v1/chat/completions", _schema_body(
        {"type": "object", "required": ["name", "temp"]}
    ))
    assert status == 200
    data = json.loads(raw)
    assert len(engine.submitted) == 2                  # original + 1 retry
    verdict = data["choices"][0]["x_schema_validation"]
    assert verdict.startswith("failed:")
    assert "temp" in verdict
    one_attempt = len(engine.tokenizer.encode('{"name": "SF"}'))
    assert data["usage"]["completion_tokens"] == 2 * one_attempt
    # the retry's prompt carries the failed attempt and the error
    retry_prompt = engine.tokenizer.decode(engine.submitted[1].prompt_ids)
    assert '{"name": "SF"}' in retry_prompt
    assert "failed schema validation" in retry_prompt


def test_json_schema_bad_schema_rejected_without_generating(scripted):
    port, engine = scripted("anything")
    status, raw = _request(port, "/v1/chat/completions", _schema_body(
        {"type": "not-a-real-type"}
    ))
    assert status == 400
    assert "invalid json_schema" in json.loads(raw)["error"]["message"]
    assert not engine.submitted


def test_json_schema_stream_marks_skipped(scripted):
    port, _ = scripted('{"a": 1}', ['{"a": 1}'])
    status, raw = _request(port, "/v1/chat/completions", _schema_body(
        {"type": "object"}, stream=True
    ))
    assert status == 200
    finals = [c for c in _sse(raw)
              if c["choices"][0]["finish_reason"] is not None]
    assert finals[-1]["choices"][0]["x_schema_validation"] == (
        "skipped (stream)"
    )


def test_streamed_choices_interleave(scripted):
    """n = 2 streamed: the choices' chunks interleave as they arrive (one
    reader per choice into one queue), as the JAX server's do; each
    choice's content is its whole text."""
    pieces = ["one ", "two ", "three ", "four ", "five ", "six"]
    port, _ = scripted("".join(pieces), pieces, pace_s=0.1)
    status, raw = _request(port, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "count"}], "n": 2,
        "stream": True,
    })
    assert status == 200
    chunks = _sse(raw)
    content = [(i, c["choices"][0]["index"])
               for i, c in enumerate(chunks)
               if c["choices"][0]["delta"].get("content")]
    first_of_1 = min(i for i, idx in content if idx == 1)
    last_of_0 = max(i for i, idx in content if idx == 0)
    assert first_of_1 < last_of_0
    for idx in (0, 1):
        assert "".join(
            c["choices"][0]["delta"].get("content", "") for c in chunks
            if c["choices"][0]["index"] == idx
        ) == "".join(pieces)


# ---------------------------------------------------------------------------
# a schema-less json_schema is JSON mode (the real engine against JAX's)
# ---------------------------------------------------------------------------

MESSAGES = [{"role": "user", "content": "hi"}]


def test_schemaless_json_schema_is_json_mode_as_in_jax():
    jcfg = dataclasses.replace(jax_get_config("tiny"), dtype="float32")
    jparams = init_params(jcfg, jax.random.key(0), dtype=jnp.float32)
    cfg = dataclasses.replace(get_config("tiny"), dtype="float32")
    eng = LLMEngine(
        cfg, params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu"),
        max_slots=2, max_seq_len=256, device="cpu",
    )
    eng.start()
    server = OpenAIServer(eng, model_name="tiny-test")
    port = server.start("127.0.0.1", 0)
    try:
        status, raw = _request(port, "/v1/chat/completions", {
            "messages": MESSAGES, "max_tokens": 6, "temperature": 0,
            "response_format": {"type": "json_schema"},
        })
    finally:
        server.shutdown()
        eng.stop()
    assert status == 200, raw
    data = json.loads(raw)
    assert "x_schema_validation" not in data["choices"][0]

    jeng = JaxLLMEngine(jcfg, jparams, max_slots=1, max_seq_len=256)
    jeng.start()
    try:
        want = jeng.generate(JaxGenRequest(
            prompt_ids=JaxByteTokenizer().apply_chat_template(
                MESSAGES + [{"role": "system",
                             "content": JAX_JSON_MODE_INSTRUCTION}]
            ),
            max_tokens=6, temperature=0.0, json_mode=True,
        ), timeout=300)
    finally:
        jeng.stop()
    assert data["choices"][0]["message"]["content"] == want.output_text
    assert data["usage"]["prompt_tokens"] == len(want.prompt_ids)
