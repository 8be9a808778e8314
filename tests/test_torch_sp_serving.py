"""Sequence-parallel serving in the PyTorch port (the runner's ``sp_mode``),
after ``tests/engine/test_sp_serving.py``.

- The port's runner under ``sp2``, ``sp4`` and ``sp2xtp2`` (one gloo
  process a rank, ``tests/torch_sp_workers.py``) against the JAX runner
  under the same plans on the 8-device CPU mesh, ``tiny`` in fp32: two
  prompts prefilled (the ring), inserted into two slots (the K/V moved to
  the ranks that own their positions: a 40-token prompt crosses the
  blocks' edges), then decode steps over the sequence-sharded cache. The
  greedy ids are identical; the first tokens' logits are within 1e-5 of
  their scale and each step's token logprobs within 1e-5; every rank ends
  with the same slot state.
- A chunked prefill (``prefill_chunk``, then continuations against the
  sharded scratch cache) against the JAX runner's ``prefill`` and
  ``prefill_with_prefix`` under ``sp4``.
- The mesh's ``sp`` groups hold the ranks JAX's ``make_mesh`` puts along
  its ``sp`` axis.
- ``--mesh-plan sp2`` through the port's server (rank 0 here, one
  follower process) against the JAX engine under ``sp2``, ``/healthz``
  carrying JAX's long-context layout.
- Each refusal names the plan: ``sp`` with ``dp > 1`` (JAX's reason),
  a sliding window, a softcap or sinks, ``max_seq_len % sp`` and no bucket
  left.
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
from gpustack_tpu.engine.runner import ModelRunner as JaxRunner
from gpustack_tpu.models import transformer as jt
from gpustack_tpu.models.config import PRESETS as JAX_PRESETS
from gpustack_tpu.parallel.mesh import MeshPlan as JaxPlan
from gpustack_tpu.parallel.mesh import make_mesh
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
from gpustack_tpu_torch.models.transformer import check_plan  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.parallel import mesh as pm  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.parallel.launch import run_ranks  # analysis: ignore[metrics-drift]

import torch_sp_workers as workers

REL = 1e-5
PROMPTS = [list(range(5, 45)), [9, 4, 33, 7, 100, 3]]
STEPS = 6
MAX_SEQ = 128
SPAWN_TIMEOUT_S = 240


@pytest.fixture(scope="module")
def tiny():
    cfg = dataclasses.replace(get_config("tiny"), dtype="float32")
    jcfg = dataclasses.replace(JAX_PRESETS["tiny"], dtype="float32")
    jparams = jt.init_params(jcfg, jax.random.key(5), dtype=jnp.float32)
    return cfg, jcfg, jparams, jax.tree.map(np.asarray, jparams)


def _jax_prefill(runner, prompt, chunk):
    if not chunk:
        bucket = runner.bucket_for(len(prompt))
        return runner.prefill(
            list(prompt) + [0] * (bucket - len(prompt)), len(prompt))
    done, k, v = 0, None, None
    while done < len(prompt):
        part = prompt[done:done + chunk]
        sb = runner.bucket_for(len(part))
        padded = list(part) + [0] * (sb - len(part))
        if done == 0:
            last, k, v = runner.prefill(padded, len(part))
        else:
            last, k, v = runner.prefill_with_prefix(
                k, v, done, padded, len(part), runner.bucket_for(done + sb))
        done += len(part)
    return last, k, v


def _jax_greedy(jcfg, jparams, plan, chunk):
    """The JAX runner under ``plan``: what ``workers.greedy_sp`` returns."""
    jplan = JaxPlan.parse(plan)
    runner = JaxRunner(jcfg, jparams, plan=jplan, mesh=make_mesh(jplan),
                       max_slots=2, max_seq_len=MAX_SEQ)
    assert runner.sp_mode
    state = runner.new_state()
    key = jax.random.key(0)
    firsts = []
    for slot, prompt in enumerate(PROMPTS):
        last, k, v = _jax_prefill(runner, prompt, chunk)
        first = int(np.asarray(runner.sample_first(
            last, 0.0, 0, 1.0, 0, False, len(prompt) - 1, key)[0])[0])
        state = runner.insert(state, k, v, slot, len(prompt), first, 0.0,
                              0, 1.0)
        firsts.append(np.asarray(last, np.float32))
    steps = []
    for _ in range(STEPS):
        state, out = runner.decode_step(state, key)
        steps.append((np.asarray(out[0]), np.asarray(out[1])))
    return firsts, steps


CASES = [("sp2", 2, 0), ("sp4", 4, 0), ("sp2xtp2", 4, 0), ("sp4", 4, 16)]


@pytest.fixture(scope="module")
def runs(tiny):
    cfg, jcfg, jparams, tree = tiny
    out = {}
    for plan, world, chunk in CASES:
        ranks = run_ranks(workers.greedy_sp, world, cfg, tree, plan, PROMPTS,
                          STEPS, chunk, MAX_SEQ, timeout=SPAWN_TIMEOUT_S,
                          threads=1)
        out[(plan, chunk)] = ranks, _jax_greedy(jcfg, jparams, plan, chunk)
    return out


def _case_id(case):
    plan, _, chunk = case
    return f"{plan}-chunk{chunk}" if chunk else plan


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_sp_runner_matches_jax(runs, case):
    plan, _, chunk = case
    ranks, (firsts, steps) = runs[(plan, chunk)]
    got_firsts, got_steps = ranks[0][0], ranks[0][1]
    for g, w in zip(got_firsts, firsts):
        assert float(np.abs(g - w).max()) <= REL * float(np.abs(w).max())
        assert int(np.argmax(g)) == int(np.argmax(w))
    for (gt, glp), (wt, wlp) in zip(got_steps, steps):
        np.testing.assert_array_equal(gt, wt)
        assert float(np.abs(glp - wlp).max()) <= REL


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_sp_ranks_end_with_the_same_slot_state(runs, case):
    plan, _, chunk = case
    ranks, _ = runs[(plan, chunk)]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[2], ranks[0][2])
        np.testing.assert_array_equal(r[3], ranks[0][3])
        for (gt, glp), (wt, wlp) in zip(r[1], ranks[0][1]):
            np.testing.assert_array_equal(gt, wt)
            np.testing.assert_array_equal(glp, wlp)


@pytest.mark.parametrize("plan", ["sp2", "sp4", "sp2xtp2", "dp2xsp2",
                                  "sp2xep2xtp2"])
def test_sp_groups_are_jax_mesh_sp_axes(plan):
    """The ranks of each ``sp`` group (``Mesh.sp_peer``) are the devices
    JAX's ``make_mesh`` lays along its ``sp`` axis."""
    jplan = JaxPlan.parse(plan)
    ids = np.vectorize(lambda d: d.id)(make_mesh(jplan).devices)
    along = np.moveaxis(ids, 1, -1).reshape(-1, jplan.sp)
    want = {tuple(int(r) for r in row) for row in along}
    got = set()
    for rank in range(jplan.chips):
        mesh = pm.Mesh.__new__(pm.Mesh)
        mesh.plan = pm.MeshPlan.parse(plan)
        mesh.rank, mesh.coords = rank, pm.rank_coords(mesh.plan, rank)
        assert mesh.sp_peer(mesh.sp_rank) == rank
        got.add(tuple(mesh.sp_peer(i) for i in range(mesh.sp)))
    assert got == want


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------

ARGV = ["--preset", "tiny", "--device", "cpu", "--max-seq-len", "256",
        "--port", "0"]


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
        build_parser().parse_args(ARGV + ["--mesh-plan", "sp2"]))
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
    """The JAX engine at plan sp2 on the port's one-card seed-0 tree."""
    tree = load_or_init_params(get_config("tiny"), None, seed=0,
                               device="cpu")

    def to_jax(t):
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)

    jparams = {k: ({kk: to_jax(vv) for kk, vv in v.items()}
                   if isinstance(v, dict) else to_jax(v))
               for k, v in tree.items()}
    eng = JaxLLMEngine(JAX_PRESETS["tiny"], jparams, plan=JaxPlan(sp=2),
                       max_slots=8, max_seq_len=256)
    eng.start()
    yield eng
    eng.stop()


def test_server_sp2_chat_matches_jax(replica, jax_engine):
    engine, port = replica
    msgs = [{"role": "user", "content": "hello there, " * 6}]
    status, body = _call(port, "POST", "/v1/chat/completions", {
        "messages": msgs, "max_tokens": 8, "temperature": 0})
    assert status == 200
    ids = engine.tokenizer.apply_chat_template(msgs)
    want = jax_engine.generate(JaxGenRequest(
        prompt_ids=ids, max_tokens=8, temperature=0.0,
        stop_ids=tuple(engine.tokenizer.eos_ids)), timeout=300)
    assert body["choices"][0]["message"]["content"] == \
        engine.tokenizer.decode(want.output_ids)
    states = engine.runner.probe(engine._state, "slot_state")
    assert len(states) == 2 and (states[0] == states[1]).all()


def test_server_sp2_greedy_ids_match_jax(replica, jax_engine):
    engine, _ = replica
    for ids in ([3, 1, 4, 1, 5], list(range(40, 110))):
        got = engine.generate(GenRequest(
            prompt_ids=ids, max_tokens=8, temperature=0.0, stop_ids=()),
            timeout=300)
        want = jax_engine.generate(JaxGenRequest(
            prompt_ids=ids, max_tokens=8, temperature=0.0, stop_ids=()),
            timeout=300)
        assert got.output_ids == want.output_ids, ids


def test_server_sp2_healthz_layout_is_jax_describe(replica):
    _, port = replica
    status, health = _call(port, "GET", "/healthz")
    assert status == 200 and health["status"] == "ok"
    assert health["layout"] == JaxLayout(long_context=True).describe()


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("extra,what", [
    (["--mesh-plan", "dp2xsp2"], "dp=1"),
    (["--mesh-plan", "sp4", "--max-seq-len", "258"], "divide evenly"),
])
def test_server_refusals_name_the_plan(extra, what):
    with pytest.raises(ValueError) as err:
        build_engine_from_args(build_parser().parse_args(ARGV + extra))
    assert what in str(err.value) and "plan dp" in str(err.value)


@pytest.mark.parametrize("field,value,what", [
    ("sliding_window", 8, "a sliding window"),
    ("attn_logit_softcap", 50.0, "an attention softcap"),
    ("attn_sinks", True, "attention sinks"),
])
def test_check_plan_refuses_what_the_ring_cannot_take(field, value, what):
    cfg = dataclasses.replace(get_config("tiny"), **{field: value})
    plan = pm.MeshPlan.parse("sp2")
    with pytest.raises(ValueError) as err:
        check_plan(cfg, plan)
    assert what in str(err.value) and str(plan) in str(err.value)
    assert cfg.name in str(err.value)
    check_plan(cfg, pm.MeshPlan.parse("tp2"))      # fine without sp


@pytest.mark.parametrize("plan,max_seq,buckets,what", [
    ("dp2xsp2", 64, (), "dp=1"),
    ("sp4", 66, (), "divide evenly"),
    ("sp2", 64, (33, 63), "no prefill bucket divides"),
])
def test_runner_refusals_name_the_plan(tiny, plan, max_seq, buckets, what):
    cfg, _, _, tree = tiny
    world = pm.MeshPlan.parse(plan).chips
    said = run_ranks(workers.refusal, world, cfg, tree, plan, max_seq,
                     buckets, timeout=SPAWN_TIMEOUT_S, threads=1)
    for s in said:
        assert what in s and str(pm.MeshPlan.parse(plan)) in s
