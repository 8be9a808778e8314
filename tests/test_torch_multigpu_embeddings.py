"""Embeddings and rerank on a multi-GPU replica of the port, against the
JAX engine.

Each replica is the port's chat server over gloo ranks, one process a
rank (``tests/torch_replica_workers.py``), in fp32 on the JAX package's
own tree: ``tiny`` under ``tp2`` and ``dp2``, ``tiny-moe`` under ``ep2``
and ``ep2xtp2``. The batch rides the leader's ``embed`` op and runs on
every rank of the first ``dp`` group; rank 0 pools and normalises.

- ``/v1/embeddings`` of token-id and text inputs (``float`` and
  ``base64``) is within 1e-5 of the JAX engine's ``embed`` of the same
  ids (fp32 unit vectors);
- ``/v1/rerank`` scores are the cosines of the JAX engine's vectors
  within 1e-5, in their order;
- every rank's slot state is the same before and after (under ``dp`` the
  other group's, after requests left it non-zero, is untouched).

Embeddings under ``sp`` are ``tests/test_torch_sp_features.py``'s.
"""

import base64
import dataclasses
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpustack_tpu.engine.engine import LLMEngine as JaxLLMEngine
from gpustack_tpu.models import init_params
from gpustack_tpu.models.config import get_config as jax_get_config
from gpustack_tpu_torch.models.config import get_config  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.parallel.launch import run_ranks  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.parallel.mesh import MeshPlan, free_port  # analysis: ignore[metrics-drift]

import torch_replica_workers as workers

TOL = dict(rtol=1e-5, atol=1e-5)
MAX_SEQ = 128
_rng = np.random.default_rng(5)
BATCH = [_rng.integers(1, 250, n).tolist() for n in (40, 7, 23, 64, 1)]
TEXTS = ["a multi-GPU replica embeds this", "and this one too"]
QUERY = "the cat sat on the mat"
DOCUMENTS = ["the cat sat on a mat", "stock markets fell sharply",
             "a dog slept on the rug", "cats like mats"]
# prompts served first, so the slots' state is not all zeros (under dp2
# with 4 slots the third lands in group 1)
WARM = [_rng.integers(1, 250, n).tolist() for n in (12, 20, 9)]
PLANS = [("tp2", "tiny"), ("ep2", "tiny-moe"), ("ep2xtp2", "tiny-moe"),
         ("dp2", "tiny")]


@pytest.fixture(scope="module", autouse=True)
def _one_thread_a_rank():
    env = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    if env is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = env


def _trees(preset):
    jcfg = dataclasses.replace(jax_get_config(preset), dtype="float32")
    jparams = init_params(jcfg, jax.random.key(0), dtype=jnp.float32)
    cfg = dataclasses.replace(get_config(preset), dtype="float32")
    return jcfg, jparams, cfg, jax.tree.map(np.asarray, jparams)


def _run(plan, cfg, tree, script, args):
    return run_ranks(workers.replica, MeshPlan.parse(plan).chips, cfg, tree,
                     plan, {"max_slots": 4, "max_seq_len": MAX_SEQ},
                     free_port(), 0, script, args, timeout=300,
                     threads=1)[0]


@pytest.fixture(scope="module", params=PLANS, ids=[p for p, _ in PLANS])
def embedded(request):
    plan, preset = request.param
    jcfg, jparams, cfg, tree = _trees(preset)
    out = _run(plan, cfg, tree, workers.embed_checks,
               (BATCH, TEXTS, QUERY, DOCUMENTS, WARM))
    jeng = JaxLLMEngine(jcfg, jparams, max_slots=1, max_seq_len=MAX_SEQ)
    try:
        want = {
            "ids": np.asarray(jeng.embed(BATCH), np.float32),
            "text": np.asarray(jeng.embed(out["text_ids"]), np.float32),
            "rerank": np.asarray(jeng.embed(out["rerank_ids"]), np.float32),
        }
    finally:
        jeng.stop()
    return dict(out, plan=plan, want=want)


def test_embeddings_match_the_jax_engine(embedded):
    for name in ("ids", "text"):
        status, reply = embedded[name]
        assert status == 200, reply
        got = workers.vectors(reply)
        assert got.shape == embedded["want"][name].shape
        np.testing.assert_allclose(got, embedded["want"][name], **TOL)
        np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0,
                                   rtol=1e-5)
    assert embedded["ids"][1]["usage"]["prompt_tokens"] == sum(
        len(ids) for ids in BATCH)


def test_base64_embeddings_match_the_jax_engine(embedded):
    status, reply = embedded["base64"]
    assert status == 200
    for d in reply["data"]:
        raw = base64.b64decode(d["embedding"])
        vec = np.float32(struct.unpack(f"<{len(raw) // 4}f", raw))
        np.testing.assert_allclose(vec, embedded["want"]["ids"][d["index"]],
                                   **TOL)


def test_rerank_is_the_jax_cosines_in_their_order(embedded):
    status, reply = embedded["rerank"]
    assert status == 200, reply
    vecs = embedded["want"]["rerank"]
    want = vecs[1:] @ vecs[0]
    order = [r["index"] for r in reply["results"]]
    assert order == sorted(range(len(DOCUMENTS)), key=lambda i: -want[i])
    np.testing.assert_allclose(
        [r["relevance_score"] for r in reply["results"]], want[order],
        **TOL)


def test_every_ranks_slot_state_is_untouched(embedded):
    before, after = (embedded["slot_state_before"],
                     embedded["slot_state_after"])
    assert len(before) == MeshPlan.parse(embedded["plan"]).chips
    for b, a in zip(before, after):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(b, before[0])
    # the warm prompts left positions on three slots (one of group 1's
    # under dp2)
    assert (before[0][1] > 0).sum() == len(WARM)
    assert embedded["status"] == "ok"
