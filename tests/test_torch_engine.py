"""Engine of the PyTorch port against the JAX ``LLMEngine``.

Both engines serve ``tiny`` in float32 from one JAX init (carried across
through numpy) with the byte tokenizer. Greedy ``output_ids`` must be
identical: float32 logits agree to ~1e-5 (test_torch_transformer.py), far
inside the gap between the top two logits of these prompts.
"""

import dataclasses
import queue

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpustack_tpu.engine.engine import GenRequest as JaxGenRequest
from gpustack_tpu.engine.engine import LLMEngine as JaxLLMEngine
from gpustack_tpu.models import init_params
from gpustack_tpu.models.config import get_config as jax_get_config
from gpustack_tpu_torch.engine.engine import GenRequest, LLMEngine  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.runner import greedy_reference  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.weights import params_from_numpy  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.models.config import get_config  # analysis: ignore[metrics-drift]

PROMPTS = [
    [3, 1, 4], [15, 9, 2, 6], [5, 3], [5, 8, 9, 7, 9], [31, 41], [2, 7],
]
MAX_TOKENS = 6


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jax_get_config("tiny"), dtype="float32")
    jparams = init_params(jcfg, jax.random.key(0), dtype=jnp.float32)
    cfg = dataclasses.replace(get_config("tiny"), dtype="float32")
    tparams = params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu"
    )
    return jcfg, jparams, cfg, tparams


@pytest.fixture(scope="module")
def jax_outputs(models):
    jcfg, jparams, _, _ = models
    eng = JaxLLMEngine(
        jcfg, jparams, max_slots=4, max_seq_len=64, pipeline_depth=0
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


def _run_port(cfg, params, depth, prompts=PROMPTS, **kw):
    eng = LLMEngine(
        cfg, params, max_slots=4, max_seq_len=64, pipeline_depth=depth,
        device="cpu",
    )
    eng.start()
    try:
        reqs = [
            eng.submit(GenRequest(
                prompt_ids=p, max_tokens=MAX_TOKENS, temperature=0.0, **kw
            ))
            for p in prompts
        ]
        for r in reqs:
            assert r.done.wait(300), r.request_id
        return eng, reqs
    finally:
        eng.stop()


@pytest.mark.parametrize("depth", [0, 2])
def test_greedy_outputs_identical_to_jax_engine(models, jax_outputs, depth):
    """More requests than slots, at both pipeline depths."""
    _, _, cfg, tparams = models
    eng, reqs = _run_port(cfg, tparams, depth)
    assert [r.output_ids for r in reqs] == jax_outputs
    assert all(r.finish_reason in ("stop", "length") for r in reqs)
    assert eng.health()["tokens_generated"] == sum(map(len, jax_outputs))


def test_engine_matches_full_forward_oracle(models):
    _, _, cfg, tparams = models
    _, reqs = _run_port(cfg, tparams, 2, prompts=PROMPTS[:2])
    for p, r in zip(PROMPTS[:2], reqs):
        oracle = greedy_reference(
            tparams, cfg, p, MAX_TOKENS, torch.device("cpu")
        )
        assert r.output_ids == oracle[: len(r.output_ids)]


def test_streaming_pieces_concatenate_to_output_text(models):
    _, _, cfg, tparams = models
    eng = LLMEngine(cfg, tparams, max_slots=2, max_seq_len=64, device="cpu")
    eng.start()
    try:
        q = queue.Queue()
        req = eng.generate(
            GenRequest(prompt_ids=[72, 105], max_tokens=8, stream=q),
            timeout=120,
        )
    finally:
        eng.stop()
    pieces = []
    while (item := q.get(timeout=5)) is not None:
        pieces.append(item[1])
    assert "".join(pieces) == req.output_text


def test_logprobs_match_jax_engine(models):
    """Greedy logprobs (the synchronous first-token path plus lagged
    decode fetches) equal the JAX engine's to 1e-4."""
    jcfg, jparams, cfg, tparams = models
    jeng = JaxLLMEngine(jcfg, jparams, max_slots=2, max_seq_len=64)
    jeng.start()
    try:
        want = jeng.generate(JaxGenRequest(
            prompt_ids=PROMPTS[3], max_tokens=MAX_TOKENS, temperature=0.0,
            logprobs=True, top_logprobs=3,
        ), timeout=300)
    finally:
        jeng.stop()
    _, (got,) = _run_port(
        cfg, tparams, 2, prompts=[PROMPTS[3]], logprobs=True,
        top_logprobs=3,
    )
    assert got.output_ids == want.output_ids
    n = len(got.output_ids)
    np.testing.assert_allclose(
        got.output_logprobs, want.output_logprobs[:n], atol=1e-4
    )
    assert [[i for i, _ in t] for t in got.output_top_logprobs] == [
        [i for i, _ in t] for t in want.output_top_logprobs[:n]
    ]


@pytest.mark.parametrize("kw,match", [
    pytest.param(*case, id=f"kw{i}") for i, case in enumerate([
        ({"speculative": "medusa"}, "speculative must be"),
        ({"speculative": "draft"}, "needs draft_cfg"),
        ({"draft_params": {}}, "needs speculative='draft'"),
        ({"kv_role": "prefill"}, "not ported"),
        ({"kv_role": "decode"}, "not ported"),
    ])
])
def test_unported_features_raise(models, kw, match):
    """kv roles are not ported yet (the KV tiers and chunked prefill are:
    test_torch_engine_kv.py; speculation is: test_torch_speculative.py),
    and a speculative mode the engine does not know, a draft mode without
    a draft or a draft without its mode are refused."""
    _, _, cfg, tparams = models
    with pytest.raises(ValueError, match=match):
        LLMEngine(cfg, tparams, device="cpu", **kw)


def test_submit_validates(models):
    _, _, cfg, tparams = models
    eng = LLMEngine(cfg, tparams, max_slots=1, max_seq_len=16, device="cpu")
    with pytest.raises(ValueError, match="max_seq_len"):
        eng.submit(GenRequest(prompt_ids=list(range(1, 17))))
    with pytest.raises(ValueError, match="out of range"):
        eng.submit(GenRequest(prompt_ids=[1], logit_bias={10**6: 1.0}))
