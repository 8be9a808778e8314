"""Data-parallel serving in the PyTorch port (``dp > 1``), against the JAX
runner and engine under the same plans.

- The port's runner under ``dp2`` and ``dp2xtp2`` (``tiny``) and
  ``dp2xep2`` (``tiny-moe``), one gloo process a rank
  (``tests/torch_dp_workers.py``), fp32, against the JAX runner under
  the same plans on the 8-device CPU mesh: prompts prefilled for slots of
  both ``dp`` groups (one prompt in a slot of each group; chunked under
  ``dp2xtp2``), then decode steps. The greedy ids are identical; the
  first tokens' logits and each step's logprobs are within 1e-5 of their
  scale; every rank ends with the same slot vectors; each group's cache
  rows (its heads under ``tp``) match JAX's rows of those slots, and a
  group ran the prefills of its own slots only.
- The runner refuses ``max_slots`` that does not divide over ``dp``; a
  group's rows of the sampler draw the noise those slots draw in the
  whole batch.
- ``--mesh-plan dp2 --max-slots 3`` through the port's server (rank 0
  here, one follower process): the slots round up to 4 as the JAX
  server's do, four chats at once (both groups' slots) give the port's
  one-card engine's greedy ids bit for bit and the JAX engine's at
  ``dp2`` (bf16; ``[27, 18, 28]``'s second token is a near-tie where the
  one-card engines of the two frameworks already part, so that prompt is
  held to the one-card port only), a chat over HTTP too, every rank
  holds the same slot state, and ``/healthz`` carries JAX's
  ``describe()``.
"""

import dataclasses
import http.client
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from gpustack_tpu_torch.engine.engine import GenRequest, LLMEngine  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.sampling import SamplingState, sample  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.weights import load_or_init_params  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.models.config import get_config  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.parallel.launch import run_ranks  # analysis: ignore[metrics-drift]

import torch_dp_workers as workers

REL = 1e-5
# slots 0, 1 are group 0's and 2, 3 group 1's; slots 0 and 2 hold the
# same prompt
PROMPTS = [list(range(5, 45)), [9, 4, 33, 7, 100, 3], list(range(5, 45)),
           [17, 250, 3, 3, 90, 41, 8]]
SLOTS = [0, 3, 2, 1]
MAX_SLOTS = 4
STEPS = 6
MAX_SEQ = 128
SPAWN_TIMEOUT_S = 240


def _tiny(name):
    cfg = dataclasses.replace(get_config(name), dtype="float32")
    jcfg = dataclasses.replace(JAX_PRESETS[name], dtype="float32")
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
    """The JAX runner under ``plan``: what ``workers.greedy_dp`` returns,
    its cache whole."""
    jplan = JaxPlan.parse(plan)
    runner = JaxRunner(jcfg, jparams, plan=jplan, mesh=make_mesh(jplan),
                       max_slots=MAX_SLOTS, max_seq_len=MAX_SEQ)
    state = runner.new_state()
    key = jax.random.key(0)
    firsts = []
    for prompt, slot in zip(PROMPTS, SLOTS):
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
    return {"firsts": firsts, "steps": steps,
            "positions": np.asarray(state.positions),
            "cache": (np.asarray(state.cache.k, np.float32),
                      np.asarray(state.cache.v, np.float32))}


CASES = [("dp2", "tiny", 2, 0), ("dp2xtp2", "tiny", 4, 16),
         ("dp2xep2", "tiny-moe", 4, 0)]


def _case_id(case):
    plan, preset, _, chunk = case
    return f"{plan}-{preset}" + (f"-chunk{chunk}" if chunk else "")


@pytest.fixture(scope="module")
def runs():
    out = {}
    trees = {}
    for plan, preset, world, chunk in CASES:
        if preset not in trees:
            trees[preset] = _tiny(preset)
        cfg, jcfg, jparams, tree = trees[preset]
        ranks = run_ranks(workers.greedy_dp, world, cfg, tree, plan,
                          PROMPTS, SLOTS, STEPS, chunk, MAX_SEQ, MAX_SLOTS,
                          timeout=SPAWN_TIMEOUT_S, threads=1)
        out[plan] = ranks, _jax_greedy(jcfg, jparams, plan, chunk)
    return out


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_dp_runner_matches_jax(runs, case):
    ranks, want = runs[case[0]]
    for g, w in zip(ranks[0]["firsts"], want["firsts"]):
        assert float(np.abs(g - w).max()) <= REL * float(np.abs(w).max())
        assert int(np.argmax(g)) == int(np.argmax(w))
    for (gt, glp), (wt, wlp) in zip(ranks[0]["steps"], want["steps"]):
        np.testing.assert_array_equal(gt, wt)
        scale = max(1.0, float(np.abs(wlp).max()))
        assert float(np.abs(glp - wlp).max()) <= REL * scale
    # the same prompt in a slot of each group: the same tokens
    for gt, _ in ranks[0]["steps"]:
        assert gt[SLOTS[0]] == gt[SLOTS[2]]


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_dp_ranks_end_with_the_same_slot_state(runs, case):
    ranks, _ = runs[case[0]]
    for r in ranks[1:]:
        for key in ("last_tokens", "positions", "active"):
            np.testing.assert_array_equal(r[key], ranks[0][key])
        for (gt, glp), (wt, wlp) in zip(r["steps"], ranks[0]["steps"]):
            np.testing.assert_array_equal(gt, wt)
            np.testing.assert_array_equal(glp, wlp)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_dp_groups_hold_jax_cache_rows(runs, case):
    ranks, want = runs[case[0]]
    rows = MAX_SLOTS // 2
    for r in ranks:
        g, t = r["coords"]["dp"], r["coords"]["tp"]
        assert r["ran"] == [s // rows == g for s in SLOTS]
        for got, whole in zip(r["cache"], want["cache"]):
            H = got.shape[3]
            mine = whole[:, g * rows:(g + 1) * rows, :, t * H:(t + 1) * H]
            assert got.shape == mine.shape
            for i in range(rows):
                n = int(want["positions"][g * rows + i])
                scale = float(np.abs(mine[:, i, :n]).max())
                err = float(np.abs(got[:, i, :n] - mine[:, i, :n]).max())
                assert err <= REL * scale, (r["coords"], i, err, scale)
    # slots 0 and 2 (one in each group) hold the same prompt's rows
    same = [r["cache"][0] for r in ranks
            if r["coords"]["tp"] == 0 and r["coords"]["ep"] == 0]
    n = len(PROMPTS[0])
    np.testing.assert_allclose(same[0][:, 0, :n], same[1][:, 0, :n],
                               rtol=0, atol=REL)


def test_runner_refuses_slots_that_do_not_divide_over_dp():
    cfg, _, _, tree = _tiny("tiny")
    got = run_ranks(workers.runner_refusal, 2, cfg, tree, "dp2", 3,
                    timeout=SPAWN_TIMEOUT_S, threads=1)
    for msg in got:
        assert "max_slots 3 must divide evenly over dp=2" in msg
        assert "plan dp2" in msg


def test_sampler_rows_of_a_group_draw_the_whole_batch_noise():
    gen = torch.Generator().manual_seed(3)
    logits = torch.randn(8, 264, generator=gen)
    state = SamplingState.create(8, "cpu")
    for s in range(8):
        state.set_slot(s, 0.9, 0, 1.0, seed=s, seeded=s % 2 == 0)
    positions = torch.arange(8) + 5
    whole = sample(logits, state, 11, positions)
    for g in range(2):
        rows = slice(4 * g, 4 * g + 4)
        part = sample(logits[rows], state.rows(4 * g, 4), 11,
                      positions[rows], row0=4 * g)
        for got, want in zip(part, whole):
            assert torch.equal(got, want[rows])


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------

ARGV = ["--preset", "tiny", "--device", "cpu", "--max-seq-len", "256",
        "--port", "0"]
SERVER_PROMPTS = [[3, 1, 4, 1, 5], [9, 2, 6, 5, 3, 5, 8, 9], [27, 18, 28],
                  list(range(40, 110))]
# bf16: the one-card engines of the port and of JAX part at its 2nd token
JAX_TIE = [27, 18, 28]
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
    engine = build_engine_from_args(build_parser().parse_args(
        ARGV + ["--mesh-plan", "dp2", "--max-slots", "3"]))
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
def one_card():
    """The port's one-card engine on the same seed-0 tree."""
    cfg = get_config("tiny")
    eng = LLMEngine(cfg, load_or_init_params(cfg, None, seed=0,
                                             device="cpu"),
                    max_slots=4, max_seq_len=256, device="cpu")
    eng.start()
    yield eng
    eng.stop()


@pytest.fixture(scope="module")
def jax_engine():
    """The JAX engine at plan dp2 on the port's one-card seed-0 tree."""
    tree = load_or_init_params(get_config("tiny"), None, seed=0,
                               device="cpu")

    def to_jax(t):
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)

    jparams = {k: ({kk: to_jax(vv) for kk, vv in v.items()}
                   if isinstance(v, dict) else to_jax(v))
               for k, v in tree.items()}
    eng = JaxLLMEngine(JAX_PRESETS["tiny"], jparams, plan=JaxPlan(dp=2),
                       max_slots=4, max_seq_len=256)
    eng.start()
    yield eng
    eng.stop()


def test_server_dp2_rounds_slots_up_to_a_multiple_of_dp(replica):
    engine, _ = replica
    assert engine.max_slots == 4
    assert engine.runner.rows == 2 and engine.runner.row0 == 0


def test_server_dp2_concurrent_chats_match_jax(replica, one_card,
                                               jax_engine):
    """Four requests at once take slots of both groups."""
    engine, _ = replica
    reqs = [engine.submit(GenRequest(
        prompt_ids=ids, max_tokens=MAX_TOKENS, temperature=0.0,
        stop_ids=())) for ids in SERVER_PROMPTS]
    for req in reqs:
        assert req.done.wait(300)
    for ids, req in zip(SERVER_PROMPTS, reqs):
        mine = one_card.generate(GenRequest(
            prompt_ids=ids, max_tokens=MAX_TOKENS, temperature=0.0,
            stop_ids=()), timeout=300)
        assert req.output_ids == mine.output_ids, ids
        if ids == JAX_TIE:
            continue
        want = jax_engine.generate(JaxGenRequest(
            prompt_ids=ids, max_tokens=MAX_TOKENS, temperature=0.0,
            stop_ids=()), timeout=300)
        assert req.output_ids == want.output_ids, ids
    states = engine.runner.probe(engine._state, "slot_state")
    assert len(states) == 2 and torch.equal(states[0], states[1])


def test_server_dp2_chat_matches_jax(replica, jax_engine):
    engine, port = replica
    msgs = [{"role": "user", "content": "hello there, " * 6}]
    status, body = _call(port, "POST", "/v1/chat/completions", {
        "messages": msgs, "max_tokens": MAX_TOKENS, "temperature": 0})
    assert status == 200
    ids = engine.tokenizer.apply_chat_template(msgs)
    want = jax_engine.generate(JaxGenRequest(
        prompt_ids=ids, max_tokens=MAX_TOKENS, temperature=0.0,
        stop_ids=tuple(engine.tokenizer.eos_ids)), timeout=300)
    assert body["choices"][0]["message"]["content"] == \
        engine.tokenizer.decode(want.output_ids)


def test_server_dp2_healthz_layout_is_jax_describe(replica):
    _, port = replica
    status, health = _call(port, "GET", "/healthz")
    assert status == 200 and health["status"] == "ok"
    assert health["layout"] == JaxLayout().describe()
