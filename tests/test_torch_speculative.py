"""Speculative decoding of the PyTorch port against the JAX package.

Runner level: ``verify_step`` and ``ingest_step`` on one decode state built
the same way in both runners (``tiny``, float32, weights carried across
from one JAX init): the tokens and accepted counts must be equal, and the
positions, last tokens, active mask and the whole KV cache within
rtol = atol = 1e-5 (float32 on both sides). The state holds an inactive
row frozen at the cache's last position, whose block both runners clamp
inside the cache.

Engine level: the port's engine with the n-gram proposer, with a random
draft (other weights) and with a perfect draft (the target's own weights)
must give greedy ids identical to the JAX engine's plain greedy ids; the
perfect draft accepts more than half its proposals, as in
``tests/engine/test_speculative.py``.
"""

import dataclasses
import http.client
import json
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpustack_tpu.engine.engine import GenRequest as JaxGenRequest
from gpustack_tpu.engine.engine import LLMEngine as JaxLLMEngine
from gpustack_tpu.engine.engine import _ngram_propose as jax_ngram_propose
from gpustack_tpu.engine.engine import _NgramIndex as JaxNgramIndex
from gpustack_tpu.engine.runner import ModelRunner as JaxRunner
from gpustack_tpu.models import init_params
from gpustack_tpu.models.config import get_config as jax_get_config
from gpustack_tpu_torch.engine.api_server import OpenAIServer  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.engine import (  # analysis: ignore[metrics-drift]
    GenRequest,
    LLMEngine,
    _ngram_propose,
    _NgramIndex,
)
from gpustack_tpu_torch.engine.runner import ModelRunner  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.runner import greedy_reference  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.weights import params_from_numpy  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.models.config import get_config  # analysis: ignore[metrics-drift]

TOL = dict(rtol=1e-5, atol=1e-5)
MAX_SEQ = 128
SLOTS = 4
P = 4
PROMPTS = [
    [5, 6, 7, 5, 6, 7, 5, 6],
    [9, 9, 9, 9, 9, 9],
    [1, 2, 3, 4, 5, 6],
    [8, 3, 8, 3, 8, 3, 8],
]
MAX_TOKENS = 24


def _pair(key):
    jcfg = dataclasses.replace(jax_get_config("tiny"), dtype="float32")
    jparams = init_params(jcfg, jax.random.key(key), dtype=jnp.float32)
    cfg = dataclasses.replace(get_config("tiny"), dtype="float32")
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, cfg, tparams


@pytest.fixture(scope="module")
def models():
    return _pair(0)


@pytest.fixture(scope="module")
def jax_plain_ids(models):
    jcfg, jparams, _, _ = models
    eng = JaxLLMEngine(
        jcfg, jparams, max_slots=SLOTS, max_seq_len=256, pipeline_depth=0
    )
    eng.start()
    try:
        reqs = [
            eng.submit(JaxGenRequest(
                prompt_ids=p, max_tokens=MAX_TOKENS, temperature=0.0
            ))
            for p in PROMPTS
        ]
        for r in reqs:
            assert r.done.wait(300), r.request_id
        return [r.output_ids for r in reqs]
    finally:
        eng.stop()


# ---- proposers ------------------------------------------------------------


def test_ngram_index_matches_jax_as_tokens_stream_in():
    rng = random.Random(0)
    ctx = [rng.randrange(6) for _ in range(12)]
    got, want = _NgramIndex(ctx), JaxNgramIndex(ctx)
    for step in range(80):
        for k in (1, 3, 5):
            ref = jax_ngram_propose(list(want.ctx), k)
            assert got.propose(k) == want.propose(k) == ref, (step, k)
            assert _ngram_propose(list(got.ctx), k) == ref
        tok = rng.randrange(6)
        got.append(tok)
        want.append(tok)


@pytest.mark.parametrize("ctx,k,want", [
    ([5, 6, 7, 8, 9, 5, 6], 3, [7, 8, 9]),
    ([5, 6, 7, 8, 9, 5, 6], 2, [7, 8]),
    ([1, 2, 3], 3, []),
    ([], 3, []),
    ([4, 4, 4, 4], 2, [4]),
])
def test_ngram_propose_cases(ctx, k, want):
    assert _ngram_propose(ctx, k) == jax_ngram_propose(ctx, k) == want


# ---- runner: verify and ingest against JAX --------------------------------


@pytest.fixture(scope="module")
def runners(models):
    jcfg, jparams, cfg, tparams = models
    jr = JaxRunner(jcfg, jparams, max_slots=SLOTS, max_seq_len=MAX_SEQ)
    tr = ModelRunner(
        cfg, tparams, torch.device("cpu"), max_slots=SLOTS,
        max_seq_len=MAX_SEQ,
    )
    return jr, tr, cfg, tparams


def _states(jr, tr):
    """The same decode state in both runners: slots 0-2 hold prompts 0-2
    (greedy first token inserted), slot 3 is inactive at the last cache
    position. Returns (jax state, port state, greedy chains)."""
    js, ts = jr.new_state(), tr.new_state()
    chains = []
    for slot, ids in enumerate(PROMPTS[:3]):
        b = tr.bucket_for(len(ids))
        padded = list(ids) + [0] * (b - len(ids))
        with torch.no_grad():
            _, k, v = tr.prefill(padded, len(ids))
        chain = greedy_reference(tr.params, tr.cfg, ids, 2 * P, "cpu")
        chains.append(chain)
        _, jk, jv = jr.prefill(padded, len(ids))
        js = jr.insert(js, jk, jv, slot, len(ids), chain[0], 0.0, 0, 1.0)
        ts = tr.insert(ts, k, v, slot, len(ids), chain[0], 0.0, 0, 1.0)
    js = dataclasses.replace(
        js, positions=js.positions.at[3].set(MAX_SEQ - 1),
        last_tokens=js.last_tokens.at[3].set(7),
    )
    ts.positions[3] = MAX_SEQ - 1
    ts.last_tokens[3] = 7
    return js, ts, chains


def _assert_states_close(js, ts):
    np.testing.assert_array_equal(ts.positions.numpy(), np.asarray(js.positions))
    np.testing.assert_array_equal(
        ts.last_tokens.numpy(), np.asarray(js.last_tokens)
    )
    np.testing.assert_array_equal(ts.active.numpy(), np.asarray(js.active))
    np.testing.assert_allclose(ts.cache.k.numpy(), np.asarray(js.cache.k), **TOL)
    np.testing.assert_allclose(ts.cache.v.numpy(), np.asarray(js.cache.v), **TOL)


def test_verify_step_matches_jax(runners):
    """Row 0 proposes its true greedy continuation (all accepted), row 1
    its first token then a wrong one, row 2 nothing useful, row 3 is
    inactive at the cache end."""
    jr, tr, _, _ = runners
    js, ts, chains = _states(jr, tr)
    proposals = np.zeros((SLOTS, P), np.int32)
    proposals[0, : P - 1] = chains[0][1:P]
    proposals[1, :2] = [chains[1][1], (chains[1][2] + 1) % 256]
    proposals[2, : P - 1] = 3
    js, jtok, jprod = jr.verify_step(js, proposals)
    with torch.no_grad():
        ts, ttok, tprod = tr.verify_step(ts, proposals)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(tprod.numpy(), np.asarray(jprod))
    assert tprod.tolist()[0] == P and tprod.tolist()[3] == 0
    assert tprod.tolist()[1] == 2
    assert ttok[0, :P].tolist() == chains[0][1 : P + 1]
    _assert_states_close(js, ts)
    # a second verify continues from the accepted prefix, as JAX does
    js, jtok, jprod = jr.verify_step(js, proposals)
    with torch.no_grad():
        ts, ttok, tprod = tr.verify_step(ts, proposals)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(tprod.numpy(), np.asarray(jprod))
    _assert_states_close(js, ts)


def test_verify_at_capacity_deactivates_like_jax(runners):
    """A row whose accepted block reaches the last position deactivates
    on the device, in both runners."""
    jr, tr, _, _ = runners
    js, ts, _ = _states(jr, tr)
    js = dataclasses.replace(js, positions=js.positions.at[0].set(MAX_SEQ - 3))
    ts.positions[0] = MAX_SEQ - 3
    proposals = np.zeros((SLOTS, P), np.int32)
    js, jtok, jprod = jr.verify_step(js, proposals)
    with torch.no_grad():
        ts, ttok, tprod = tr.verify_step(ts, proposals)
    np.testing.assert_array_equal(tprod.numpy(), np.asarray(jprod))
    _assert_states_close(js, ts)


@pytest.mark.parametrize("counts", [[4, 1, 0, 0], [2, 3, 4, 1]])
def test_ingest_step_matches_jax(runners, counts):
    jr, tr, _, _ = runners
    js, ts, chains = _states(jr, tr)
    block = np.zeros((SLOTS, P), np.int32)
    for slot in range(3):
        block[slot] = chains[slot][1 : P + 1]
    block[3] = [11, 12, 13, 14]
    js = jr.ingest_step(js, block, np.asarray(counts, np.int32))
    with torch.no_grad():
        ts = tr.ingest_step(ts, block, counts)
    _assert_states_close(js, ts)


def test_snapshot_and_restore_rewind_the_sequence(runners):
    jr, tr, _, _ = runners
    _, ts, _ = _states(jr, tr)
    snap = tr.snapshot_sequence(ts)
    before = (ts.positions.clone(), ts.last_tokens.clone())
    with torch.no_grad():
        ts, _ = tr.decode_step(ts, 0)
    assert not torch.equal(ts.positions, before[0])
    ts = tr.restore_sequence(ts, snap)
    assert torch.equal(ts.positions, before[0])
    assert torch.equal(ts.last_tokens, before[1])


# ---- engine: greedy ids identical to the JAX engine's plain greedy ---------


def _run_port(cfg, params, depth=2, **kw):
    eng = LLMEngine(
        cfg, params, max_slots=SLOTS, max_seq_len=256, device="cpu",
        pipeline_depth=depth, spec_tokens=P, **kw,
    )
    eng.start()
    try:
        reqs = [
            eng.submit(GenRequest(
                prompt_ids=p, max_tokens=MAX_TOKENS, temperature=0.0
            ))
            for p in PROMPTS
        ]
        for r in reqs:
            assert r.done.wait(300), r.request_id
        return [r.output_ids for r in reqs], eng
    finally:
        eng.stop()


@pytest.mark.parametrize("depth", [0, 2])
def test_ngram_engine_matches_jax_plain_greedy(models, jax_plain_ids, depth):
    _, _, cfg, tparams = models
    ids, eng = _run_port(cfg, tparams, depth, speculative="ngram")
    assert ids == jax_plain_ids
    health = eng.health()
    assert health["speculative"] == "ngram"
    assert health["spec_steps"] > 0
    assert health["spec_extra_tokens"] > 0
    records = eng.flight.snapshot(limit=2048)
    verify = [r for r in records if r["mode"] == "spec_verify"]
    assert verify
    for r in verify:
        assert r["tokens_padded"] == SLOTS * P
        assert r["tokens_real"] % P == 0 and 0 < r["tokens_real"] <= SLOTS * P
        assert r["spec_proposed"] == r["tokens_real"] // P * (P - 1)
    assert sum(r["spec_accepted"] for r in records) == (
        health["spec_extra_tokens"]
    )


def test_random_draft_matches_jax_plain_greedy(models, jax_plain_ids):
    """A draft with other weights: proposals mostly rejected, output
    still the target's greedy ids."""
    _, _, cfg, tparams = models
    _, _, dcfg, dparams = _pair(42)
    ids, eng = _run_port(
        cfg, tparams, speculative="draft", draft_cfg=dcfg,
        draft_params=dparams,
    )
    assert ids == jax_plain_ids
    health = eng.health()
    assert health["spec_steps"] > 0
    assert health["draft_model"] == dcfg.name
    assert 0.0 <= health["spec_acceptance_rate"] <= 1.0


def test_perfect_draft_matches_jax_and_accepts(models, jax_plain_ids):
    _, _, cfg, tparams = models
    ids, eng = _run_port(
        cfg, tparams, speculative="draft", draft_cfg=cfg, draft_params=tparams,
    )
    assert ids == jax_plain_ids
    assert eng.health()["spec_acceptance_rate"] > 0.5, eng.health()


@pytest.mark.parametrize("kw,match", [
    ({"temperature": 0.7}, "greedy-only"),
    ({"logprobs": True}, "logprobs"),
    ({"logit_bias": {5: 1.0}}, "logit_bias"),
])
def test_speculative_engine_refuses_what_it_cannot_honour(models, kw, match):
    _, _, cfg, tparams = models
    eng = LLMEngine(
        cfg, tparams, max_slots=1, max_seq_len=64, device="cpu",
        speculative="ngram",
    )
    req = GenRequest(prompt_ids=[1, 2, 3], **{"temperature": 0.0, **kw})
    with pytest.raises(ValueError, match=match):
        eng.submit(req)


def test_speculative_server_defaults_to_greedy(models, jax_plain_ids):
    """Unset temperature is 0 on a speculative server (else every request
    would be refused); an explicit one meets the engine's 400."""
    _, _, cfg, tparams = models
    eng = LLMEngine(
        cfg, tparams, max_slots=2, max_seq_len=256, device="cpu",
        speculative="ngram",
    )
    eng.start()
    server = OpenAIServer(eng, model_name="tiny-spec")
    port = server.start("127.0.0.1", 0)

    def post(body):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        try:
            conn.request("POST", "/v1/completions", body=json.dumps(body),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read())
        finally:
            conn.close()

    try:
        prompt = bytes(t - 1 for t in PROMPTS[2]).decode("latin-1")
        assert eng.tokenizer.encode(prompt) == PROMPTS[2]
        status, data = post({"prompt": prompt, "max_tokens": MAX_TOKENS})
        assert status == 200, data
        assert data["usage"]["completion_tokens"] == len(jax_plain_ids[2])
        status, data = post({"prompt": prompt, "temperature": 0.7})
        assert status == 400 and "greedy-only" in data["error"]["message"]
    finally:
        server.shutdown()
        eng.stop()
