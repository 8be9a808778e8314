"""Embeddings of the PyTorch port against the JAX package.

``ModelRunner.embed`` (one cacheless forward, mean-pooled and
l2-normalised fp32 hidden states, the batch padded to a power of two) and
the engine's ``embed`` against the JAX runner's and engine's on the same
inputs, within rtol = atol = 1e-5 (float32 on both sides; unit vectors).
The port's cacheless forward runs once through the plain attention and
once through the flash wrapper (its plain version on the CPU; the kernel
on the card), within the same 1e-5 of JAX.

``/v1/embeddings`` and ``/v1/rerank`` answer as the JAX server does
(``tests/engine/test_api_server.py::test_embeddings``,
``::test_rerank_endpoint``, ``test_openai_surface.py::
test_embeddings_dimensions_and_base64``).
"""

import base64
import dataclasses
import http.client
import json
import math
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpustack_tpu.engine.engine import LLMEngine as JaxLLMEngine
from gpustack_tpu.engine.runner import ModelRunner as JaxRunner
from gpustack_tpu.models import init_params
from gpustack_tpu.models.config import get_config as jax_get_config
from gpustack_tpu.models.transformer import forward as jax_forward
from gpustack_tpu_torch.engine.api_server import OpenAIServer  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.engine import LLMEngine  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.runner import ModelRunner  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.weights import params_from_numpy  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.models import transformer as pt  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.models.config import get_config  # analysis: ignore[metrics-drift]

TOL = dict(rtol=1e-5, atol=1e-5)
MAX_SEQ = 64


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jax_get_config("tiny"), dtype="float32")
    jparams = init_params(jcfg, jax.random.key(0), dtype=jnp.float32)
    cfg = dataclasses.replace(get_config("tiny"), dtype="float32")
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, cfg, tparams


def _batch(n, bucket, seed):
    rng = np.random.default_rng(seed)
    lens = [int(x) for x in rng.integers(1, bucket + 1, n)]
    lens[0] = bucket                      # one row fills the bucket
    rows = [
        rng.integers(1, 256, length).tolist() + [0] * (bucket - length)
        for length in lens
    ]
    return rows, lens


@pytest.mark.parametrize("attn", ["plain", "flash"])
def test_cacheless_forward_matches_jax(models, monkeypatch, attn):
    """The embedding forward's hidden states, through each attention."""
    jcfg, jparams, cfg, tparams = models
    rows, _ = _batch(3, 32, seed=1)
    tokens = np.asarray(rows)
    positions = np.broadcast_to(np.arange(32)[None, :], tokens.shape)
    want, _ = jax_forward(
        jparams, jcfg, jnp.asarray(tokens), jnp.asarray(positions),
        return_hidden=True,
    )
    got, cache = pt.forward(
        tparams, cfg, torch.from_numpy(tokens).long(),
        torch.from_numpy(np.ascontiguousarray(positions)).long(),
        return_hidden=True, attn_impl=attn,
    )
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cacheless_flash_rows_must_start_at_zero(models):
    _, _, cfg, tparams = models
    with pytest.raises(ValueError, match="0 .. T-1"):
        pt.forward(
            tparams, cfg, torch.ones(1, 4, dtype=torch.long),
            torch.arange(2, 6)[None, :], attn_impl="flash",
        )


@pytest.mark.parametrize("n,bucket", [(1, 32), (3, 32), (5, 64)])
def test_runner_embed_matches_jax(models, n, bucket):
    jcfg, jparams, cfg, tparams = models
    jr = JaxRunner(jcfg, jparams, max_slots=2, max_seq_len=MAX_SEQ)
    tr = ModelRunner(cfg, tparams, torch.device("cpu"), max_slots=2,
                     max_seq_len=MAX_SEQ)
    rows, lens = _batch(n, bucket, seed=n)
    want = np.asarray(jr.embed(rows, lens))
    with torch.no_grad():
        got = tr.embed(rows, lens)
    assert got.shape == (n, cfg.hidden_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(np.linalg.norm(want, axis=-1), 1.0, rtol=1e-5)


@pytest.fixture(scope="module")
def served(models):
    _, _, cfg, tparams = models
    eng = LLMEngine(cfg, tparams, max_slots=2, max_seq_len=MAX_SEQ,
                    device="cpu")
    eng.start()
    server = OpenAIServer(eng, model_name="tiny-test")
    port = server.start("127.0.0.1", 0)
    yield eng, port
    server.shutdown()
    eng.stop()


def _post(port, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", path, body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def test_engine_embed_matches_jax_engine(models, served):
    """Token-id inputs of different lengths, one batch, both engines."""
    jcfg, jparams, _, _ = models
    eng, _ = served
    batch = [[5, 6, 7], list(range(1, 40)), [9] * 12]
    jeng = JaxLLMEngine(jcfg, jparams, max_slots=2, max_seq_len=MAX_SEQ)
    want = np.asarray(jeng.embed(batch))
    got = np.asarray(eng.embed(batch))
    np.testing.assert_allclose(got, want, **TOL)
    records = eng.flight.snapshot(limit=50)
    embeds = [r for r in records if r["mode"] == "embed"]
    assert embeds and embeds[-1]["tokens_real"] == sum(map(len, batch))
    assert embeds[-1]["tokens_padded"] == 4 * 64


def test_embed_needs_a_started_engine(models):
    _, _, cfg, tparams = models
    eng = LLMEngine(cfg, tparams, max_slots=1, max_seq_len=MAX_SEQ,
                    device="cpu")
    with pytest.raises(RuntimeError, match="started"):
        eng.embed([[1, 2]])


def test_embeddings(served):
    eng, port = served
    status, data = _post(port, "/v1/embeddings", {"input": ["hello", "world"]})
    assert status == 200, data
    assert data["object"] == "list" and len(data["data"]) == 2
    v0 = np.asarray(data["data"][0]["embedding"])
    v1 = np.asarray(data["data"][1]["embedding"])
    assert v0.shape == (64,)           # tiny hidden size
    assert abs(np.linalg.norm(v0) - 1.0) < 1e-3
    assert not np.allclose(v0, v1)
    assert data["usage"] == {"prompt_tokens": 10, "total_tokens": 10}
    status, again = _post(port, "/v1/embeddings", {"input": "hello"})
    np.testing.assert_allclose(
        v0, np.asarray(again["data"][0]["embedding"]), rtol=1e-5
    )
    # a bare token array is one input; token arrays match their text
    ids = eng.tokenizer.encode("hello")
    status, tok = _post(port, "/v1/embeddings", {"input": ids})
    assert status == 200 and len(tok["data"]) == 1
    np.testing.assert_allclose(
        v0, np.asarray(tok["data"][0]["embedding"]), rtol=1e-5, atol=1e-6
    )
    assert _post(port, "/v1/embeddings", {})[0] == 400
    assert _post(port, "/v1/embeddings", {"input": "x" * 600})[0] == 400
    assert _post(port, "/v1/embeddings", {"input": [[]]})[0] == 400
    assert _post(port, "/v1/embeddings", {"input": [1.5]})[0] == 400


def test_embeddings_dimensions_and_base64(served):
    _, port = served
    status, full = _post(port, "/v1/embeddings", {"input": "hello"})
    assert status == 200, full
    full_vec = full["data"][0]["embedding"]
    status, cut = _post(
        port, "/v1/embeddings", {"input": "hello", "dimensions": 8}
    )
    vec = cut["data"][0]["embedding"]
    assert len(vec) == 8
    assert abs(math.sqrt(sum(x * x for x in vec)) - 1.0) < 1e-5
    norm = math.sqrt(sum(x * x for x in full_vec[:8]))
    for a, b in zip(vec, full_vec[:8]):
        assert abs(a - b / norm) < 1e-5
    status, b64 = _post(
        port, "/v1/embeddings", {"input": "hello", "encoding_format": "base64"}
    )
    raw = base64.b64decode(b64["data"][0]["embedding"])
    decoded = struct.unpack(f"<{len(raw) // 4}f", raw)
    assert len(decoded) == len(full_vec)
    for a, b in zip(decoded, full_vec):
        assert abs(a - b) < 1e-6
    assert _post(port, "/v1/embeddings",
                 {"input": "x", "dimensions": 10_000})[0] == 400
    assert _post(port, "/v1/embeddings",
                 {"input": "x", "dimensions": True})[0] == 400
    assert _post(port, "/v1/embeddings",
                 {"input": "x", "encoding_format": "int8"})[0] == 400


def test_rerank_endpoint(served):
    eng, port = served
    docs = [
        "hello world greetings",
        "completely different text about turtles",
        "hello world again",
    ]
    status, data = _post(port, "/v1/rerank", {
        "query": "hello world", "documents": docs, "top_n": 2,
    })
    assert status == 200, data
    assert data["object"] == "rerank"
    assert len(data["results"]) == 2
    scores = [x["relevance_score"] for x in data["results"]]
    assert scores == sorted(scores, reverse=True)
    assert all(-1.01 <= s <= 1.01 for s in scores)
    # the scores are the cosines of the engine's embeddings
    vecs = np.asarray(eng.embed(
        [eng.tokenizer.encode("hello world")]
        + [eng.tokenizer.encode(d) for d in docs]
    ))
    cos = vecs[1:] @ vecs[0]
    for r in data["results"]:
        assert abs(r["relevance_score"] - cos[r["index"]]) < 1e-5
        assert r["document"]["text"] == docs[r["index"]]
    assert data["results"][0]["index"] == int(np.argmax(cos))
    assert _post(port, "/v1/rerank", {"query": "x"})[0] == 400
    assert _post(port, "/v1/rerank", {"query": "", "documents": ["a"]})[0] == 400
    assert _post(port, "/v1/rerank",
                 {"query": "x", "documents": ["a"], "top_n": -1})[0] == 400
