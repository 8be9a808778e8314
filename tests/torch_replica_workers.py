"""Rank bodies for the multi-GPU handoff, embedding, vision and ``sp``
feature tests (``test_torch_multigpu_kv_role.py``,
``test_torch_multigpu_embeddings.py``, ``test_torch_multigpu_vlm.py``,
``test_torch_sp_features.py``):
one fp32 replica of the port's server, each rank in a process of its own
over gloo (``parallel.launch.run_ranks``), importing no JAX.

:func:`replica` builds a rank as ``api_server.build_engine_from_args``
does (the rank's shard of a numpy tree, rank 0's ``BroadcastingRunner``
and ``CommandLeader``, a follower's ``FollowerLoop`` and ``FollowerTier``)
but from a given tree and config, so the replica runs in fp32 on the JAX
package's own weights. Rank 0 serves HTTP and runs one of the scripts
below against its own server; it returns what the script returns, and a
follower returns once the leader closes the channel. With
``engine_kw["draft"]`` rank 0's engine speculates with a draft of the
target's own tree, on rank 0 alone, as ``--speculative draft`` builds
it."""

import http.client
import json
import os
import time

import numpy as np
import torch

from gpustack_tpu_torch.engine import diagnostics  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine import multihost as mh  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.api_server import OpenAIServer  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.engine import GenRequest, LLMEngine  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.weights import params_from_numpy  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.models import vlm  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.parallel.mesh import MeshPlan, close_mesh, init_mesh  # analysis: ignore[metrics-drift]

CPU = torch.device("cpu")
TOKEN = "replica-test"


def replica(rank, world, coordinator, cfg, tree, plan, engine_kw, cmd_port,
            http_port, script, args):
    """One rank of an fp32 replica of ``cfg`` over ``tree`` under
    ``plan``; rank 0 serves on ``http_port`` (0: any) and returns
    ``script(engine, port, *args)``."""
    mesh = init_mesh(MeshPlan.parse(plan), rank, coordinator, CPU)
    params = params_from_numpy(tree, CPU, mesh if world > 1 else None,
                               cfg.num_kv_heads)
    kw = dict(engine_kw)
    if kw.pop("draft", False) and not rank:
        # a draft of the target's own tree, on rank 0 alone (as the
        # server builds it): it proposes the target's greedy tokens
        kw.update(draft_cfg=cfg, draft_params=params_from_numpy(
            tree, CPU, None, cfg.num_kv_heads))
    elif rank:
        kw.pop("speculative", None)     # a follower never proposes
    engine = LLMEngine(cfg, params, device="cpu", plan=mesh.plan,
                       mesh=mesh, pipeline_depth=0, **kw)
    tier = engine.host_kv_cache
    if world > 1 and rank:
        engine.follower_loop = mh.FollowerLoop(
            engine.runner, f"127.0.0.1:{cmd_port}", state=engine._state,
            token=TOKEN, tier=None if tier is None else mh.FollowerTier(
                engine))
        engine.follower_loop.start()
        engine.follower_loop.join()
        close_mesh(mesh)
        return engine.follower_loop.error
    if world > 1:
        engine.runner = mh.BroadcastingRunner(
            engine.runner, mh.CommandLeader(cmd_port, world - 1,
                                            token=TOKEN))
        if tier is not None:
            tier.lead()
    engine.start()
    server = OpenAIServer(engine, model_name=cfg.name)
    port = server.start("127.0.0.1", http_port)
    try:
        return script(engine, port, *args)
    finally:
        server.shutdown()
        engine.stop()
        if world > 1:
            engine.runner.close()
        close_mesh(mesh)


def _post(port, path, body=None, raw=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", path,
                     body=raw if raw is not None else json.dumps(body),
                     headers={"Content-Type": "application/json",
                              **(headers or {})})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _drain(engine):
    """The leader's queued tier work has landed (and been named)."""
    if engine._kv_copy_pool is not None:
        engine._kv_copy_pool.submit(lambda: None).result(timeout=120)


def _probe(engine, what, ids=None):
    """``diagnostics.probe`` on every rank (through the leader's runner;
    one process: its own runner)."""
    if hasattr(engine.runner, "probe"):
        return engine.runner.probe(engine._state, what, ids=ids)
    return diagnostics.probe(engine.runner, engine._state, what, ids)


def _blocks(engine, ids, n):
    """Every rank's stored arrays of each of ``ids``' first ``n`` blocks
    (``probe("kv_block")``)."""
    bt = engine.host_kv_cache.block_tokens
    return [_probe(engine, "kv_block", ids[:(b + 1) * bt])
            for b in range(n)]


def _greedy(engine, ids, n):
    req = engine.generate(GenRequest(prompt_ids=list(ids), max_tokens=n,
                                     temperature=0.0, stop_ids=()),
                          timeout=120)
    _drain(engine)
    return list(req.output_ids), req.prefix_tokens_reused


def kv_checks(engine, port, frames, a, b, tail, n_new):
    """The handoff routes of one replica: the JAX engine's ``frames`` of
    prompt ``a`` through ``/kv/import``, every rank's blocks and tier
    after it; ``a`` exported again by prompt ids, with its first block in
    ``have``, and by its tail key; ``b`` exported with prefill on a miss
    and every rank's blocks of it; greedy ids of ``a + tail`` (a hit on
    the imported blocks)."""
    cache = engine.host_kv_cache
    out = {}
    status, body = _post(port, "/kv/import", raw=frames)
    out["import"] = (status, json.loads(body))
    keys = [k.hex() for k in cache.chain_keys(a)]
    out["a_blocks"] = _blocks(engine, a, len(keys))
    out["tiers"] = _probe(engine, "kv_tier")
    out["leader_keys"] = cache.keys()
    for name, req in (("a_export", {"prompt_ids": a}),
                      ("a_export_have", {"prompt_ids": a,
                                         "have": keys[:1]}),
                      ("a_chain", {"tail_key": keys[-1]}),
                      ("b_export", {"prompt_ids": b, "prefill": True})):
        out[name] = _post(port, "/kv/export", req)
    _drain(engine)
    out["b_blocks"] = _blocks(engine, b, (len(b) - 1) // cache.block_tokens)
    out["ids"], out["reused"] = _greedy(engine, a + tail, n_new)
    out["handoff"] = engine.kv_handoff.snapshot()
    out["status"] = engine.health()["status"]
    return out


def serve_until(engine, port, sentinel, chat, prompt):
    """A prefill-role source on its fixed port: ``chat`` served first (a
    conversation for ``/kv/pull`` by tail key), then serving until
    ``sentinel`` exists; every rank's blocks of ``prompt`` and ``chat``
    and the handoff counters."""
    _greedy(engine, chat, 2)
    deadline = time.time() + 300
    while not os.path.exists(sentinel) and time.time() < deadline:
        time.sleep(0.05)
    bt = engine.host_kv_cache.block_tokens
    return {"prompt_blocks": _blocks(engine, prompt, (len(prompt) - 1)
                                     // bt),
            "handoff": engine.kv_handoff.snapshot(),
            "role": engine.health()["kv_role"],
            "status": engine.health()["status"]}


def pull_from(engine, port, src_port, sentinel, text, chat, n_new):
    """A decode-role replica against the source on ``src_port``: a
    completion of ``text`` naming the source in ``X-GPUStack-KV-Source``;
    the same prompt's greedy ids (a hit on the pulled blocks); a
    ``/kv/pull`` of ``chat``'s chain by its tail key; every rank's blocks
    of both and every rank's tier. Creates ``sentinel`` when done."""
    try:
        deadline = time.time() + 120
        while time.time() < deadline:
            try:
                conn = http.client.HTTPConnection("127.0.0.1", src_port,
                                                  timeout=5)
                conn.request("GET", "/healthz")
                if conn.getresponse().status == 200:
                    break
            except OSError:
                time.sleep(0.1)
        cache = engine.host_kv_cache
        ids = engine.tokenizer.encode(text)
        source = f"http://127.0.0.1:{src_port}/kv/export"
        status, body = _post(port, "/v1/completions", {
            "prompt": text, "max_tokens": n_new, "temperature": 0},
            headers={"X-GPUStack-KV-Source": source})
        out = {"completion": (status, json.loads(body)), "prompt_ids": ids}
        _drain(engine)
        out["handoff"] = engine.kv_handoff.snapshot()
        out["reused_by_completion"] = engine.health()[
            "kv_cache_prefix_tokens_reused"]
        out["ids"], out["reused"] = _greedy(engine, ids, n_new)
        tail = cache.chain_keys(chat)[-1]
        out["pull"] = _post(port, "/kv/pull", {"source": source,
                                               "tail_key": tail.hex()})
        deadline = time.time() + 60
        while cache.block(tail) is None and time.time() < deadline:
            time.sleep(0.05)
        bt = cache.block_tokens
        out["prompt_blocks"] = _blocks(engine, ids, (len(ids) - 1) // bt)
        out["chat_blocks"] = _blocks(engine, chat, len(chat) // bt)
        out["tiers"] = _probe(engine, "kv_tier")
        out["leader_keys"] = cache.keys()
        out["role"] = engine.health()["kv_role"]
        out["status"] = engine.health()["status"]
        return out
    finally:
        open(sentinel, "w").close()


def embed_checks(engine, port, batch, text_batch, query, documents,
                 warm):
    """``/v1/embeddings`` of token-id and text inputs and ``/v1/rerank``;
    the slot state of every rank around them, after ``warm`` prompts were
    served (their slots keep their last tokens and positions)."""
    for ids in warm:
        _greedy(engine, ids, 3)
    state = _probe(engine, "slot_state")
    out = {"slot_state_before": [s.numpy() for s in state]}
    for name, body in (("ids", {"input": batch}),
                       ("text", {"input": text_batch}),
                       ("base64", {"input": batch,
                                   "encoding_format": "base64"})):
        status, raw = _post(port, "/v1/embeddings", body)
        out[name] = (status, json.loads(raw))
    status, raw = _post(port, "/v1/rerank", {"query": query,
                                             "documents": documents})
    out["rerank"] = (status, json.loads(raw))
    out["text_ids"] = [engine.tokenizer.encode(t) for t in text_batch]
    out["rerank_ids"] = [engine.tokenizer.encode(t)
                         for t in [query] + documents]
    state = _probe(engine, "slot_state")
    out["slot_state_after"] = [s.numpy() for s in state]
    out["status"] = engine.health()["status"]
    return out


def refused_embedding(engine, port):
    """An embedding request a replica must refuse: its status and
    message."""
    status, raw = _post(port, "/v1/embeddings", {"input": [[5, 6, 7]]})
    return status, json.loads(raw)


def vectors(reply):
    """The float vectors of an ``/v1/embeddings`` reply, by index."""
    return np.asarray([d["embedding"] for d in sorted(
        reply["data"], key=lambda d: d["index"])], np.float32)


def sequence(engine, port, steps):
    """Several scripts of this module on one replica, in turn: ``steps``
    ``[(name, args)]``; their results, in order."""
    return [globals()[name](engine, port, *args) for name, args in steps]


def chat_checks(engine, port, turns, short, n_new):
    """A chat: turn ``t``'s prompt is the one before, its reply and
    ``turns[t]`` (each hitting the one before), then each prompt of
    ``short`` (each hitting the one before it); every request's greedy
    ids and reused tokens, every rank's tier and the leader's keys."""
    outs, reused, prompt = [], [], []
    for t, extra in enumerate(turns):
        prompt = prompt + (outs[-1] if t else []) + list(extra)
        ids, n = _greedy(engine, prompt, n_new)
        outs.append(ids)
        reused.append(n)
    for p in short:
        ids, n = _greedy(engine, p, n_new)
        outs.append(ids)
        reused.append(n)
    return {"ids": outs, "reused": reused,
            "tiers": _probe(engine, "kv_tier"),
            "leader_keys": engine.host_kv_cache.keys(),
            "health": engine.health()}


def block_checks(engine, port, prompt, n):
    """One greedy token of ``prompt`` (its blocks stored), then every
    rank's stored arrays of its first ``n`` blocks."""
    _greedy(engine, prompt, 1)
    return _blocks(engine, prompt, n)


def spill_checks(engine, port, budget, fills, again):
    """The leader's RAM budget cut to ``budget`` bytes, then one greedy
    token of each of ``fills`` (pushing blocks out to disk) and of
    ``again`` (a hit restored from disk): each request's reused tokens,
    every rank's tier after each, the leader's RAM and spilled keys."""
    cache = engine.host_kv_cache
    cache.max_bytes = budget
    reused, tiers = [], []
    for p in list(fills) + [again]:
        reused.append(_greedy(engine, p, 1)[1])
        tiers.append(_probe(engine, "kv_tier"))
    return {"reused": reused, "tiers": tiers, "leader_keys": cache.keys(),
            "leader_spill": cache.spill.keys(), "health": engine.health()}


def spec_checks(engine, port, prompts, n_new):
    """Greedy ids of each prompt (one request at a time), the engine's
    verify steps, proposals made and accepted each added, and every
    rank's verify steps and accepted proposals (``probe("spec")``)."""
    ids, counts = [], []
    names = ("_spec_steps", "_spec_proposed", "_spec_hits")
    for p in prompts:
        before = [getattr(engine, k) for k in names]
        ids.append(_greedy(engine, p, n_new)[0])
        counts.append([getattr(engine, k) - b
                       for k, b in zip(names, before)])
    return {"ids": ids, "counts": counts, "spec": _probe(engine, "spec"),
            "health": engine.health()}


def _wait_health(port, deadline_s=120):
    deadline = time.time() + deadline_s
    while time.time() < deadline:
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
            conn.request("GET", "/healthz")
            if conn.getresponse().status == 200:
                return
        except OSError:
            pass
        time.sleep(0.1)
    raise TimeoutError(f"no server on port {port}")


def _wait_file(path, deadline_s=300):
    deadline = time.time() + deadline_s
    while not os.path.exists(path) and time.time() < deadline:
        time.sleep(0.05)


def handoff_peer(engine, port, peer_port, text, served, wait_first,
                 wait_for, signal, n_new):
    """One of two live replicas that hand prompts to each other, each the
    other's source: (with ``wait_first``, after ``wait_for`` exists) a
    completion of ``text`` naming the peer's ``/kv/export`` in
    ``X-GPUStack-KV-Source`` (the peer prefills it on a miss and hands
    its blocks over), then the prompt's greedy ids (a hit on the handed
    blocks), every rank's blocks of it and tier, and this replica's
    ``/kv/export`` of it (raw frames); creates ``signal``. Last, once the
    peer has pulled ``served`` from it (``wait_for`` exists, without
    ``wait_first``), its ``/kv/export`` of ``served``."""
    out = {}
    try:
        _wait_health(peer_port)
        if wait_first:
            _wait_file(wait_for)
        ids = engine.tokenizer.encode(text)
        status, body = _post(port, "/v1/completions", {
            "prompt": text, "max_tokens": n_new, "temperature": 0},
            headers={"X-GPUStack-KV-Source":
                     f"http://127.0.0.1:{peer_port}/kv/export"})
        out.update(completion=(status, json.loads(body)), prompt_ids=ids)
        _drain(engine)
        out["handoff"] = engine.kv_handoff.snapshot()
        out["ids"], out["reused"] = _greedy(engine, ids, n_new)
        bt = engine.host_kv_cache.block_tokens
        out["blocks"] = _blocks(engine, ids, (len(ids) - 1) // bt)
        out["tiers"] = _probe(engine, "kv_tier")
        out["leader_keys"] = engine.host_kv_cache.keys()
        out["export"] = _post(port, "/kv/export", {"prompt_ids": ids})
    finally:
        open(signal, "w").close()
        if not wait_first:
            _wait_file(wait_for)
    out["served_export"] = _post(port, "/kv/export", {
        "prompt_ids": engine.tokenizer.encode(served)})
    out["status"] = engine.health()["status"]
    return out


def _attach_tower(engine, vision):
    """Rank 0's vision bundle (``vision``: the port's ``VLMConfig`` and a
    numpy tower tree), as the server attaches it to the leader alone."""
    vcfg, tower = vision
    engine.vision = vlm.VisionBundle(vcfg, params_from_numpy(tower, CPU),
                                     "cpu")


def vision_checks(engine, port, vision, chats, prompts, fillers, n_new):
    """Image chats on a replica whose leader holds the tower: ``fillers``
    (text prompts, one greedy token each) first, so the slots that follow
    are those the test expects; then for each chat of ``chats`` (message
    lists) with its prompt ``prompts[i]`` as the JAX package builds it
    (``(ids, embeds, mask)``): that prompt's first-token logits from the
    runner called directly on the slot the chat is then served on, the
    served chat's reply and the same prompt's greedy ids through
    ``engine.generate``. Every rank's tier and slot state around them."""
    _attach_tower(engine, vision)
    for ids in fillers:
        _greedy(engine, ids, 1)
    tiers_before = (_probe(engine, "kv_tier")
                    if engine.host_kv_cache is not None else None)
    out = {"chats": []}
    for msgs, (ids, embeds, mask) in zip(chats, prompts):
        runner = engine.runner
        bucket = runner.bucket_for(len(ids))
        pad = bucket - len(ids)
        slot = engine._free[0]
        with torch.no_grad():
            last, _, _ = runner.prefill_with_embeds(
                list(ids) + [0] * pad, len(ids),
                np.pad(embeds, ((0, pad), (0, 0))), np.pad(mask, (0, pad)),
                slot=slot)
        status, raw = _post(port, "/v1/chat/completions", {
            "messages": msgs, "max_tokens": n_new, "temperature": 0})
        built = vlm.build_mm_prompt(engine.tokenizer, msgs, engine.vision)
        req = engine.generate(GenRequest(
            prompt_ids=built[0], max_tokens=n_new, temperature=0.0,
            stop_ids=(), embeds_override=built[1:]), timeout=120)
        _drain(engine)
        out["chats"].append({
            "slot": slot, "logits": last.numpy(), "status": status,
            "reply": json.loads(raw), "built": built,
            "ids": list(req.output_ids),
            "matched": (engine.host_kv_cache.match_prefix_len(built[0])
                        if engine.host_kv_cache is not None else 0)})
    out["tiers_before"] = tiers_before
    out["tiers_after"] = (_probe(engine, "kv_tier")
                          if engine.host_kv_cache is not None else None)
    out["slot_state"] = [s.numpy() for s in _probe(engine, "slot_state")]
    out["status"] = engine.health()["status"]
    return out


def vision_refusal(engine, port, vision, msgs):
    """An image chat a replica must refuse: its status and message."""
    _attach_tower(engine, vision)
    status, raw = _post(port, "/v1/chat/completions", {
        "messages": msgs, "max_tokens": 2, "temperature": 0})
    return status, json.loads(raw)
