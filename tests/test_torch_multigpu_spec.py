"""Speculative decoding on a multi-GPU replica of the port, against the JAX
engine under the same plan.

The port's server (``build_engine_from_args``, ``--device cpu``: rank 0
here, one follower process per other rank over gloo) serves ``tiny``
(bf16) under ``tp2`` and ``dp2xtp2`` with ``--speculative ngram`` and
with ``--speculative draft --draft-source tiny`` (the draft drawn from
the target's seed: a draft that proposes the target's own greedy tokens,
on rank 0 alone), and without speculation. The JAX engine serves the same
tree under the same plan with the same proposer (its draft on one
device). Both run at pipeline depth 0, one request at a time (under
``dp2xtp2`` the requests take slots of both groups).

- Greedy ids equal the port's without speculation, and JAX's but at a
  near tie (``tests/torch_near_tie.py``): under both plans the port's
  ``tp2`` decode parts from JAX's at the first prompt's 15th token,
  with speculation and without it (JAX's pick is within 0.3% of the
  logit scale of the fp32 top; the port's is the fp32 top).
- The spec counters of each request (verify steps, proposals made and
  accepted) equal JAX's wherever its ids do; the draft accepts
  proposals; every rank ran the same verify steps and accepted the same
  proposals.
- Both features are still refused under ``sp2``, naming the plan.
"""

import os

import jax.numpy as jnp
import pytest
import torch

import torch_near_tie as near_tie

from gpustack_tpu.engine.engine import GenRequest as JaxGenRequest
from gpustack_tpu.engine.engine import LLMEngine as JaxLLMEngine
from gpustack_tpu.models.config import PRESETS as JAX_PRESETS
from gpustack_tpu.parallel.mesh import MeshPlan as JaxPlan
from gpustack_tpu_torch.engine.api_server import (  # analysis: ignore[metrics-drift]
    build_engine_from_args,
    build_parser,
    shutdown_replica,
)
from gpustack_tpu_torch.engine.engine import GenRequest  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.weights import load_or_init_params  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.models.config import get_config  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.parallel.mesh import MeshPlan  # analysis: ignore[metrics-drift]

ARGV = ["--preset", "tiny", "--device", "cpu", "--max-seq-len", "256",
        "--max-slots", "4", "--port", "0", "--pipeline-depth", "0",
        "--spec-tokens", "4"]
PROMPTS = [[5, 6, 7] * 6, [9, 4] * 5, list(range(30, 50)) * 2]
MAX_TOKENS = 16
MODES = {
    "ngram": ["--speculative", "ngram"],
    "draft": ["--speculative", "draft", "--draft-source", "tiny"],
}
# the engines' counters of verify steps, proposals made and accepted
SPEC = ("_spec_steps", "_spec_proposed", "_spec_hits")
# bf16 through two frameworks: a parting within 4% of the logit scale of
# the fp32 top is a near tie (as the KV tier's test holds it)
NEAR_TIE = 4e-2


@pytest.fixture(scope="module", autouse=True)
def _one_thread_a_rank():
    """Every rank of this module's replicas on one CPU thread (the
    follower processes inherit the environment), so a replica's processes
    do not crowd the suite's other workers."""
    env, threads = os.environ.get("OMP_NUM_THREADS"), torch.get_num_threads()
    os.environ["OMP_NUM_THREADS"] = "1"
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    if env is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = env


def _jax_tree():
    tree = load_or_init_params(get_config("tiny"), None, seed=0,
                               device="cpu")

    def to_jax(t):
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)

    return {k: ({kk: to_jax(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else to_jax(v))
            for k, v in tree.items()}


def _greedy(eng, cls):
    """Each prompt's ids, and the engine's spec counters each request
    added."""
    ids, counts = [], []
    for p in PROMPTS:
        before = [getattr(eng, k, 0) for k in SPEC]
        ids.append(eng.generate(cls(prompt_ids=p, max_tokens=MAX_TOKENS,
                                    temperature=0.0, stop_ids=()),
                                timeout=300).output_ids)
        counts.append([getattr(eng, k, 0) - b for k, b in zip(SPEC, before)])
    return ids, counts


def _port(plan, extra):
    eng = build_engine_from_args(build_parser().parse_args(
        ARGV + ["--mesh-plan", plan, *extra]))
    eng.start()
    try:
        ids, counts = _greedy(eng, GenRequest)
        probe = eng.runner.probe(eng._state, "spec")
        return ids, counts, eng.health(), probe
    finally:
        eng.stop()
        shutdown_replica(eng, timeout=30)


def _jax(plan, mode, tree):
    kw = dict(speculative=mode, spec_tokens=4)
    if mode == "draft":
        kw.update(draft_cfg=JAX_PRESETS["tiny"], draft_params=tree)
    eng = JaxLLMEngine(JAX_PRESETS["tiny"], tree, plan=JaxPlan.parse(plan),
                       max_slots=4, max_seq_len=256, pipeline_depth=0, **kw)
    eng.start()
    try:
        return _greedy(eng, JaxGenRequest)
    finally:
        eng.stop()


@pytest.fixture(scope="module", params=["tp2", "dp2xtp2"])
def runs(request):
    """Per plan: the port without speculation, then with each proposer,
    one replica at a time; the JAX engine with each proposer."""
    plan, tree = request.param, _jax_tree()
    out = {"plain": _port(plan, [])}
    for mode, extra in MODES.items():
        out[mode] = _port(plan, extra), _jax(plan, mode, tree)
    return plan, tree, out


def _agree(tree, ids, jax_ids):
    """Per prompt: whether the port's ids are JAX's (a parting is checked
    to be a near tie)."""
    return [near_tie.parting("tiny", tree, p, got, want, NEAR_TIE)
            == MAX_TOKENS for p, got, want in zip(PROMPTS, ids, jax_ids)]


@pytest.mark.parametrize("mode", list(MODES))
def test_greedy_ids_match_jax_and_plain(runs, mode):
    _, tree, out = runs
    (ids, _, _, _), (jax_ids, _) = out[mode]
    assert ids == out["plain"][0]
    assert sum(_agree(tree, ids, jax_ids)) >= 2


@pytest.mark.parametrize("mode", list(MODES))
def test_spec_counters_match_jax_on_every_rank(runs, mode):
    plan, tree, out = runs
    (ids, counts, health, probe), (jax_ids, jax_counts) = out[mode]
    assert health["speculative"] == mode
    for agree, got, want in zip(_agree(tree, ids, jax_ids), counts,
                                jax_counts):
        if agree:
            assert got == want
    steps, proposed, accepted = (sum(c[i] for c in counts)
                                 for i in range(3))
    assert steps > 0 and proposed > 0
    assert health["spec_steps"] == steps
    assert health["spec_extra_tokens"] == accepted
    assert len(probe) == MeshPlan.parse(plan).chips
    # every rank ran each verify step and took rank 0's accepted tokens
    assert all(p == probe[0] for p in probe)
    assert probe[0][0] == steps
    if mode == "draft":
        assert accepted > 0
