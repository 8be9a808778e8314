"""Sequence parallelism beside expert parallelism (``sp2xep2``) in the
PyTorch port, against the JAX runner and engine under the same plan.

- The port's runner under ``sp2xep2`` on ``tiny-moe`` in fp32 (one gloo
  process a rank, ``tests/torch_sp_workers.py``) against the JAX runner
  under ``sp2xep2`` on the 8-device CPU mesh: two prompts prefilled from
  zero through the ring (every layer but attention on the rank's own
  tokens, the MoE layer over its ``ep`` group), or as a chunk and
  continuations against the sequence-sharded scratch cache, inserted
  (the K/V moved over each ``sp`` group), then decode steps over the
  sharded cache; once more with an ungated shared expert (DeepSeek's
  kind), which each ``(dp, sp)`` block adds once, on its ``ep`` rank 0.
  The greedy ids are identical; the first tokens' logits and each step's
  logprobs are within 1e-5 of their scale; every rank ends with the same
  slot state.
- Every ``ep x tp`` group (the MoE layer's one all-reduce) holds ranks
  of one ``sp`` index, and of one ``dp`` index: the ranks of a group hold
  the same block of tokens.
- ``--mesh-plan sp2xep2`` through the port's server (rank 0 here, three
  follower processes) against the JAX engine at ``sp2xep2``: greedy ids
  and a chat, JAX's long-context layout on ``/healthz``, every rank's
  slot state equal.
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
from gpustack_tpu_torch.parallel.launch import run_ranks  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.parallel.mesh import rank_coords  # analysis: ignore[metrics-drift]

import torch_dp_workers
import torch_sp_workers as workers

REL = 1e-5
PROMPTS = [list(range(5, 45)), [9, 4, 33, 7, 100, 3]]
STEPS = 6
MAX_SEQ = 128
SPAWN_TIMEOUT_S = 240
PLAN = "sp2xep2"


# a shared expert as DeepSeek's: ungated, beside the routed ones
SHARED = dict(n_shared_experts=1, shared_expert_intermediate_size=64)


def _tiny_moe(shared):
    extra = dict(dtype="float32", **(SHARED if shared else {}))
    cfg = dataclasses.replace(get_config("tiny-moe"), **extra)
    jcfg = dataclasses.replace(JAX_PRESETS["tiny-moe"], **extra)
    jparams = jt.init_params(jcfg, jax.random.key(5), dtype=jnp.float32)
    return cfg, jcfg, jparams, jax.tree.map(np.asarray, jparams)


def _jax_greedy(jcfg, jparams, chunk):
    """The JAX runner under ``sp2xep2``: what ``workers.greedy_sp``
    returns."""
    jplan = JaxPlan.parse(PLAN)
    runner = JaxRunner(jcfg, jparams, plan=jplan, mesh=make_mesh(jplan),
                       max_slots=2, max_seq_len=MAX_SEQ)
    assert runner.sp_mode
    state = runner.new_state()
    key = jax.random.key(0)
    firsts = []
    for slot, prompt in enumerate(PROMPTS):
        done, k, v = 0, None, None
        step = chunk or len(prompt)
        while done < len(prompt):
            part = prompt[done:done + step]
            sb = runner.bucket_for(len(part))
            padded = list(part) + [0] * (sb - len(part))
            if done == 0:
                last, k, v = runner.prefill(padded, len(part))
            else:
                last, k, v = runner.prefill_with_prefix(
                    k, v, done, padded, len(part),
                    runner.bucket_for(done + sb))
            done += len(part)
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


# (chunk tokens, shared expert)
CASES = [(0, False), (16, False), (0, True)]
IDS = ["ring", "chunk16", "ring-shared-expert"]


@pytest.fixture(scope="module")
def runs():
    out = {}
    for chunk, shared in CASES:
        cfg, jcfg, jparams, tree = _tiny_moe(shared)
        out[(chunk, shared)] = (
            run_ranks(workers.greedy_sp, 4, cfg, tree, PLAN, PROMPTS,
                      STEPS, chunk, MAX_SEQ, timeout=SPAWN_TIMEOUT_S,
                      threads=1),
            _jax_greedy(jcfg, jparams, chunk))
    return out


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_sp_ep_runner_matches_jax(runs, case):
    ranks, (firsts, steps) = runs[case]
    got_firsts, got_steps = ranks[0][0], ranks[0][1]
    for g, w in zip(got_firsts, firsts):
        assert float(np.abs(g - w).max()) <= REL * float(np.abs(w).max())
        assert int(np.argmax(g)) == int(np.argmax(w))
    for (gt, glp), (wt, wlp) in zip(got_steps, steps):
        np.testing.assert_array_equal(gt, wt)
        scale = max(1.0, float(np.abs(wlp).max()))
        assert float(np.abs(glp - wlp).max()) <= REL * scale


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_sp_ep_ranks_end_with_the_same_slot_state(runs, case):
    ranks, _ = runs[case]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[2], ranks[0][2])
        np.testing.assert_array_equal(r[3], ranks[0][3])
        for (gt, glp), (wt, wlp) in zip(r[1], ranks[0][1]):
            np.testing.assert_array_equal(gt, wt)
            np.testing.assert_array_equal(glp, wlp)


def test_each_moe_group_holds_one_sp_index():
    """The MoE layer's all-reduce over ``ep x tp`` stays inside one block
    of tokens: each group's members share the ``dp`` and ``sp`` indices,
    and summing the ranks' ``sp`` index over the group gives ``sp`` times
    the group's size."""
    got = run_ranks(torch_dp_workers.moe_groups, 4, PLAN,
                    timeout=SPAWN_TIMEOUT_S, threads=1)
    plan = JaxPlan.parse(PLAN)
    for rank, r in enumerate(got):
        assert r["moe_size"] == 2 and len(r["members"]) == 2
        assert rank in r["members"]
        for m in r["members"]:
            c = rank_coords(plan, m)
            assert (c["dp"], c["sp"]) == (r["coords"]["dp"],
                                          r["coords"]["sp"])
        assert r["sum"] == r["coords"]["sp"] * 2
    assert {tuple(r["members"]) for r in got} == {(0, 1), (2, 3)}


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------

ARGV = ["--preset", "tiny-moe", "--device", "cpu", "--max-seq-len", "256",
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
        build_parser().parse_args(ARGV + ["--mesh-plan", PLAN]))
    assert len(engine.follower_procs) == 3
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
    """The JAX engine at plan sp2xep2 on the port's one-card seed-0
    tree."""
    tree = load_or_init_params(get_config("tiny-moe"), None, seed=0,
                               device="cpu")

    def to_jax(t):
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)

    jparams = {k: ({kk: to_jax(vv) for kk, vv in v.items()}
                   if isinstance(v, dict) else to_jax(v))
               for k, v in tree.items()}
    eng = JaxLLMEngine(JAX_PRESETS["tiny-moe"], jparams,
                       plan=JaxPlan.parse(PLAN), max_slots=8,
                       max_seq_len=256)
    eng.start()
    yield eng
    eng.stop()


def test_server_sp2xep2_greedy_ids_match_jax(replica, jax_engine):
    engine, _ = replica
    for ids in ([3, 1, 4, 1, 5], list(range(40, 110))):
        got = engine.generate(GenRequest(
            prompt_ids=ids, max_tokens=8, temperature=0.0, stop_ids=()),
            timeout=300)
        want = jax_engine.generate(JaxGenRequest(
            prompt_ids=ids, max_tokens=8, temperature=0.0, stop_ids=()),
            timeout=300)
        assert got.output_ids == want.output_ids, ids


def test_server_sp2xep2_chat_matches_jax(replica, jax_engine):
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
    assert len(states) == 4 and all((s == states[0]).all() for s in states)


def test_server_sp2xep2_healthz_layout_is_jax_describe(replica):
    _, port = replica
    status, health = _call(port, "GET", "/healthz")
    assert status == 200 and health["status"] == "ok"
    assert health["layout"] == JaxLayout(long_context=True).describe()
