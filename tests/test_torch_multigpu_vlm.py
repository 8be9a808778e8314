"""Image chats on a multi-GPU replica of the port, against the JAX package.

Each replica is the port's chat server over gloo ranks, one process a
rank (``tests/torch_replica_workers.py``), in fp32 on the JAX package's
own trees: ``tiny-vlm``'s tower on rank 0 alone and its language tree
under ``tp2``, ``dp2`` and ``sp2``, or a ``tiny-moe`` language under
``ep2``, each with a host KV tier. The image rows leave rank 0's card in
one broadcast and every rank splices its own (``ModelRunner.
prefill_with_embeds``).

- the first-token logits of each image prompt, from the replica's runner
  on the slot its chat is served on, are within 1e-5 of JAX's one-process
  ``ModelRunner.prefill_with_embeds`` on the same ids, embeds and mask
  (under ``dp2`` one chat lands in group 1's slots, one in group 0's;
  under ``sp2`` the second image's rows straddle the segments);
- the served greedy ids and reply are the JAX engine's;
- every rank's slot state is the leader's;
- no rank's host tier gains a key from an image chat;
- under ``--speculative ngram`` an image chat gets JAX's refusal, word
  for word;
- ``--preset tiny-vlm`` over two processes (``tp2``, ``ep2``, ``dp2``,
  ``sp2``) builds a replica whose leader holds the tower and answers an
  image chat.
"""

import base64
import dataclasses
import http.client
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from gpustack_tpu.engine.engine import GenRequest as JaxGenRequest
from gpustack_tpu.engine.engine import LLMEngine as JaxLLMEngine
from gpustack_tpu.engine.runner import ModelRunner as JaxModelRunner
from gpustack_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from gpustack_tpu.models import init_params
from gpustack_tpu.models import vlm as jvlm
from gpustack_tpu.models.config import get_config as jax_get_config
from gpustack_tpu_torch.engine import multihost as mh  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.api_server import (  # analysis: ignore[metrics-drift]
    build_engine_from_args,
    build_parser,
    shutdown_replica,
)
from gpustack_tpu_torch.models import vlm  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.models.config import get_config  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.parallel.launch import run_ranks  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.parallel.mesh import MeshPlan, free_port  # analysis: ignore[metrics-drift]

import torch_replica_workers as workers

TOL = dict(rtol=1e-5, atol=1e-5)
MAX_SEQ = 256
N_NEW = 8
PLANS = [("tp2", "tiny"), ("ep2", "tiny-moe"), ("dp2", "tiny"),
         ("sp2", "tiny")]
# two text prompts first: with 4 slots the chats then take slots 2, 3
# (group 1 under dp2), 0 and 1
FILLERS = [[7, 3, 9, 27, 81, 11, 40, 2, 5, 6, 8, 13, 21, 34, 55, 89, 5] * 2,
           [12, 14, 16, 18, 20]]


def _image(seed, w, h):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255 / max(w - 1, 1), yy * 255 / max(h - 1, 1),
                     (xx + yy) * 127 / max(w + h - 2, 1)], -1)
    return np.clip(base + rng.integers(-40, 41, (h, w, 3)), 0,
                   255).astype(np.uint8)


def _url(seed, w, h):
    buf = io.BytesIO()
    Image.fromarray(_image(seed, w, h)).save(buf, format="PNG")
    return "data:image/png;base64," + base64.b64encode(
        buf.getvalue()).decode()


def _part(seed, w, h):
    return {"type": "image_url", "image_url": {"url": _url(seed, w, h)}}


# one image at 64 x 64; two (one resized), the second after enough text
# that its rows straddle sp2's segments of the 256 bucket
CHATS = [
    [{"role": "user", "content": [{"type": "text", "text": "look "},
                                  _part(1, 64, 64),
                                  {"type": "text", "text": "?"}]}],
    [{"role": "user", "content": [{"type": "text", "text": "one "},
                                  _part(2, 64, 64),
                                  {"type": "text", "text": "and " * 8},
                                  _part(3, 97, 53),
                                  {"type": "text", "text": "?"}]}],
]


@pytest.fixture(scope="module", autouse=True)
def _one_thread_a_rank():
    env = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    if env is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = env


@pytest.fixture(scope="module")
def tower():
    """The JAX tower of ``tiny-vlm`` and its fp32 numpy tree."""
    jcfg = jvlm.get_vlm_config("tiny-vlm")
    jparams = jvlm.init_vision_params(jcfg, jax.random.key(1))
    return jax.tree.map(lambda a: np.asarray(a, np.float32), jparams)


def _models(preset, tree32):
    """The JAX language config, tree and vision bundle of ``preset`` in
    fp32 with the tower projected into it, and the port's VLM config."""
    jlang = dataclasses.replace(jax_get_config(preset), dtype="float32")
    jlm = init_params(jlang, jax.random.key(0), dtype=jnp.float32)
    jcfg = jvlm.VLMConfig(name=f"{preset}-vision", language=jlang,
                          vision=jvlm.VisionConfig())
    jbundle = jvlm.VisionBundle(jcfg, jax.tree.map(jnp.asarray, tree32))
    lang = dataclasses.replace(get_config(preset), dtype="float32")
    vcfg = vlm.VLMConfig(name=f"{preset}-vision", language=lang,
                         vision=vlm.VisionConfig())
    return jlang, jlm, jbundle, lang, vcfg


def _replica(plan, cfg, tree, engine_kw, script, args):
    return run_ranks(workers.replica, MeshPlan.parse(plan).chips, cfg, tree,
                     plan, {"max_slots": 4, "max_seq_len": MAX_SEQ,
                            **engine_kw},
                     free_port(), 0, script, args, timeout=300,
                     threads=1)[0]


@pytest.fixture(scope="module", params=PLANS, ids=[p for p, _ in PLANS])
def served(request, tower):
    plan, preset = request.param
    jlang, jlm, jbundle, lang, vcfg = _models(preset, tower)
    prompts = [jvlm.build_mm_prompt(JaxByteTokenizer(), msgs, jbundle)
               for msgs in CHATS]
    out = _replica(plan, lang, jax.tree.map(np.asarray, jlm),
                   {"host_kv_cache_mb": 8, "kv_block_tokens": 16},
                   workers.vision_checks,
                   ((vcfg, tower), CHATS, prompts, FILLERS, N_NEW))
    jrun = JaxModelRunner(jlang, jlm, max_slots=1, max_seq_len=MAX_SEQ)
    jeng = JaxLLMEngine(jlang, jlm, max_slots=1, max_seq_len=MAX_SEQ,
                        pipeline_depth=0)
    jeng.vision = jbundle
    jeng.start()
    want = []
    try:
        for ids, emb, mask in prompts:
            bucket = jrun.bucket_for(len(ids))
            pad = bucket - len(ids)
            last, _, _ = jrun.prefill_with_embeds(
                ids + [0] * pad, len(ids), np.pad(emb, ((0, pad), (0, 0))),
                np.pad(mask, (0, pad)))
            req = jeng.generate(JaxGenRequest(
                prompt_ids=ids, max_tokens=N_NEW, temperature=0.0,
                stop_ids=(), embeds_override=(emb, mask)), timeout=300)
            # as the chat route asks: stopping at the tokenizer's EOS
            chat = jeng.generate(JaxGenRequest(
                prompt_ids=ids, max_tokens=N_NEW, temperature=0.0,
                embeds_override=(emb, mask)), timeout=300)
            want.append({"logits": np.asarray(last), "ids": req.output_ids,
                         "text": chat.output_text,
                         "prompt": (ids, emb, mask)})
    finally:
        jeng.stop()
    return dict(out, plan=plan, want=want)


def test_first_token_logits_match_the_jax_runner(served):
    for got, want in zip(served["chats"], served["want"]):
        assert got["logits"].shape == want["logits"].shape
        np.testing.assert_allclose(got["logits"], want["logits"], **TOL)
    slots = [c["slot"] for c in served["chats"]]
    if served["plan"] == "dp2":
        # one chat on each group's slots (group 1: slots 2 and 3)
        assert slots[0] // 2 == 1 and slots[1] // 2 == 0, slots


def test_served_greedy_ids_match_the_jax_engine(served):
    for got, want in zip(served["chats"], served["want"]):
        ids, emb, mask = want["prompt"]
        assert got["built"][0] == ids
        np.testing.assert_array_equal(got["built"][2], mask)
        np.testing.assert_allclose(got["built"][1], emb, **TOL)
        assert got["ids"] == want["ids"]
        assert got["status"] == 200, got["reply"]
        reply = got["reply"]
        assert reply["usage"]["prompt_tokens"] == len(ids)
        assert reply["choices"][0]["message"]["content"] == want["text"]
    assert served["status"] == "ok"


def test_every_ranks_slot_state_is_the_leaders(served):
    states = served["slot_state"]
    assert len(states) == MeshPlan.parse(served["plan"]).chips
    for st in states[1:]:
        np.testing.assert_array_equal(st, states[0])
    # the fillers' and the chats' slots all ran (positions past 0)
    assert (states[0][1] > 0).sum() == 4


def test_no_ranks_tier_gains_a_key_from_an_image_chat(served):
    before, after = served["tiers_before"], served["tiers_after"]
    assert len(after) == MeshPlan.parse(served["plan"]).chips
    # the text fillers stored blocks on every rank ...
    assert all(t["entries"] > 0 for t in before)
    # ... and the image chats none, on any rank
    assert before == after
    assert all(c["matched"] == 0 for c in served["chats"])


def test_speculative_replica_gives_the_jax_refusal(tower):
    jlang, jlm, jbundle, lang, vcfg = _models("tiny", tower)
    status, reply = _replica("tp2", lang, jax.tree.map(np.asarray, jlm),
                             {"speculative": "ngram"},
                             workers.vision_refusal, ((vcfg, tower),
                                                      CHATS[0]))
    ids, emb, mask = jvlm.build_mm_prompt(JaxByteTokenizer(), CHATS[0],
                                          jbundle)
    jeng = JaxLLMEngine(jlang, jlm, max_slots=1, max_seq_len=MAX_SEQ,
                        speculative="ngram")
    try:
        with pytest.raises(ValueError) as err:
            jeng.submit(JaxGenRequest(prompt_ids=ids, max_tokens=2,
                                      embeds_override=(emb, mask)))
    finally:
        jeng.stop()
    assert status == 400
    assert reply["error"]["message"] == str(err.value)


@pytest.mark.parametrize("mask", [
    [], [1], [0, 0], [1, 1, 0, 1], [0, 1, 1, 1, 0, 0, 1, 1],
    [1] * 64 + [0] * 7 + [1] * 64,
])
def test_mask_runs_round_trip(mask):
    mask = np.asarray(mask, bool)
    runs = mh.mask_runs(mask)
    assert all(n > 0 for _, n in runs)
    assert sum(n for _, n in runs) == int(mask.sum())
    np.testing.assert_array_equal(mh.mask_of(runs, len(mask)), mask)
    json.dumps(runs)                       # host ints for the wire


@pytest.mark.parametrize("plan", ["tp2", "ep2", "dp2", "sp2"])
def test_vlm_preset_builds_a_replica_that_answers_an_image_chat(plan):
    args = build_parser().parse_args([
        "--preset", "tiny-vlm", "--mesh-plan", plan, "--device", "cpu",
        "--max-seq-len", "256", "--max-slots", "2"])
    engine = build_engine_from_args(args)
    from gpustack_tpu_torch.engine.api_server import OpenAIServer  # analysis: ignore[metrics-drift]

    engine.start()
    server = OpenAIServer(engine)
    port = server.start("127.0.0.1", 0)
    try:
        assert engine.vision is not None
        assert isinstance(engine.runner, mh.BroadcastingRunner)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        conn.request("POST", "/v1/chat/completions", body=json.dumps({
            "messages": CHATS[0], "max_tokens": 4, "temperature": 0}),
            headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        body = json.loads(resp.read())
        assert resp.status == 200, body
        assert body["usage"]["prompt_tokens"] > vlm.get_vlm_config(
            "tiny-vlm").n_image_tokens
        assert engine.health()["status"] == "ok"
    finally:
        server.shutdown()
        engine.stop()
        shutdown_replica(engine, timeout=60)
