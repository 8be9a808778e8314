"""The port's server across processes on the CPU: ``build_engine_from_args``
with ``--preset tiny --device cpu --num-devices 2`` (what the port's
``engine.api_server`` module runs) is rank 0 of a ``tp2``
replica; it starts one follower process over gloo on free ports, and
serves HTTP here. Greedy ids, through the engine and through a chat,
equal the JAX engine's at plan ``tp2`` on the same tree (the one-card
tree from seed 0, of which each rank holds its slice); ``/healthz``
carries ``layout``, JAX's ``describe()``; the followers' slot state
equals the leader's; a VLM preset over 2 processes, and a ``tp`` the
heads do not divide over, are refused at build, naming the plan (the
``sp`` features: ``tests/test_torch_sp_features.py``); killing the
follower makes ``/healthz`` report
the engine dead; the follower process is reaped. Then two ranks set up
from outside through the environment contract, over an int8-quantized
safetensors checkpoint: each rank's tree is the slice of the whole
quantized tree, and rank 0 serves the greedy ids of a one-process
engine over the same checkpoint."""

import http.client
import importlib.util
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpustack_tpu.engine.engine import GenRequest as JaxGenRequest
from gpustack_tpu.engine.engine import LLMEngine as JaxLLMEngine
from gpustack_tpu.models.config import PRESETS as JAX_PRESETS
from gpustack_tpu.parallel.mesh import MeshPlan as JaxPlan
from gpustack_tpu.parallel.sharding import SpecLayout as JaxLayout
from gpustack_tpu_torch.engine.api_server import (  # analysis: ignore[metrics-drift]
    OpenAIServer,
    build_engine_from_args,
    build_parser,
    shutdown_replica,
)
from gpustack_tpu_torch.engine.engine import GenRequest  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.weights import load_or_init_params  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.models.config import get_config  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.parallel.launch import run_ranks  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.parallel.mesh import free_port  # analysis: ignore[metrics-drift]

import torch_tp_workers as workers

ARGV = ["--preset", "tiny", "--device", "cpu", "--max-seq-len", "256",
        "--port", "0"]
PROMPTS = [[3, 1, 4, 1, 5], [9, 2, 6, 5, 3, 5, 8, 9], [27, 18, 28]]
MAX_TOKENS = 8


def _call(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request(method, path,
                     body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


@pytest.fixture(scope="module")
def replica():
    engine = build_engine_from_args(
        build_parser().parse_args(ARGV + ["--num-devices", "2"]))
    assert len(engine.follower_procs) == 1
    engine.start()
    server = OpenAIServer(engine)
    port = server.start("127.0.0.1", 0)
    yield engine, port
    server.shutdown()
    engine.stop()
    shutdown_replica(engine, timeout=30)
    assert all(p.poll() is not None for p in engine.follower_procs)


@pytest.fixture(scope="module")
def jax_engine():
    """The JAX engine at plan tp2 on the port's one-card seed-0 tree."""
    tree = load_or_init_params(get_config("tiny"), None, seed=0,
                               device="cpu")

    def to_jax(t):
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)

    jparams = {k: ({kk: to_jax(vv) for kk, vv in v.items()}
                   if isinstance(v, dict) else to_jax(v))
               for k, v in tree.items()}
    eng = JaxLLMEngine(JAX_PRESETS["tiny"], jparams, plan=JaxPlan(tp=2),
                       max_slots=8, max_seq_len=256)
    eng.start()
    yield eng
    eng.stop()


def test_greedy_ids_match_jax_at_tp2(replica, jax_engine):
    engine, _ = replica
    for ids in PROMPTS:
        got = engine.generate(GenRequest(
            prompt_ids=ids, max_tokens=MAX_TOKENS, temperature=0.0,
            stop_ids=()), timeout=300)
        want = jax_engine.generate(JaxGenRequest(
            prompt_ids=ids, max_tokens=MAX_TOKENS, temperature=0.0,
            stop_ids=()), timeout=300)
        assert got.output_ids == want.output_ids, ids


def test_chat_matches_jax_and_followers_agree(replica, jax_engine):
    engine, port = replica
    msgs = [{"role": "user", "content": "hello there"}]
    status, body = _call(port, "POST", "/v1/chat/completions", {
        "messages": msgs, "max_tokens": MAX_TOKENS, "temperature": 0})
    assert status == 200
    ids = engine.tokenizer.apply_chat_template(msgs)
    want = jax_engine.generate(JaxGenRequest(
        prompt_ids=ids, max_tokens=MAX_TOKENS, temperature=0.0,
        stop_ids=tuple(engine.tokenizer.eos_ids)), timeout=300)
    assert body["choices"][0]["message"]["content"] == \
        engine.tokenizer.decode(want.output_ids)
    # the engine is idle now: every rank's slot state, gathered
    states = engine.runner.probe(engine._state, "slot_state")
    assert len(states) == 2 and torch.equal(states[0], states[1])


def test_healthz_layout_is_jax_describe(replica):
    _, port = replica
    status, health = _call(port, "GET", "/healthz")
    assert status == 200 and health["status"] == "ok"
    assert health["layout"] == JaxLayout().describe()


@pytest.mark.parametrize("extra,what", [
    (["--mesh-plan", "tp8"], "query heads (4) does not divide over 8"),
    (["--mesh-plan", "tp3"], "KV heads neither divide"),
])
def test_multi_process_refusals_name_the_plan(extra, what):
    with pytest.raises(ValueError) as err:
        build_engine_from_args(build_parser().parse_args(ARGV + extra))
    assert what in str(err.value) and "plan dp" in str(err.value)


def test_killed_follower_makes_healthz_report_dead(replica):
    """Last in the module: it ends the replica."""
    engine, port = replica
    proc = engine.follower_procs[0]
    proc.kill()
    proc.wait(30)
    deadline = time.time() + 20
    health = {}
    while time.time() < deadline:
        _, health = _call(port, "GET", "/healthz")
        if health["status"] != "ok":
            break
        time.sleep(0.1)
    assert health["status"] == "error"
    assert "disconnected" in health["error"]


def test_ranks_from_the_environment_over_a_checkpoint(tmp_path):
    path = os.path.join(os.path.dirname(__file__), "test_torch_weights.py")
    spec = importlib.util.spec_from_file_location("_tp_weights", path)
    weights_tests = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(weights_tests)
    model_dir = weights_tests._write_checkpoint(
        tmp_path / "ckpt", get_config("tiny"), seed=3)
    prompt = [7, 3, 9, 27, 81]
    single = build_engine_from_args(build_parser().parse_args([
        "--model-dir", model_dir, "--device", "cpu", "--quantization",
        "int8", "--max-seq-len", "128"]))
    single.start()
    try:
        want = single.generate(GenRequest(
            prompt_ids=prompt, max_tokens=6, temperature=0.0,
            stop_ids=()), timeout=120).output_ids
    finally:
        single.stop()
    ranks = run_ranks(workers.checkpoint_rank, 2, model_dir, free_port(),
                      prompt, timeout=180, threads=1)
    assert ranks[0][0] and ranks[1][0]
    assert ranks[0][1] == want
    assert ranks[1][1] > 0
