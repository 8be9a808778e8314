"""The host KV tier on a multi-GPU replica of the port, against the JAX
engine under the same plan.

The port's server (``build_engine_from_args``, ``--device cpu``: rank 0
here, one follower process per other rank over gloo) serves ``tiny``
under ``tp2`` and ``dp2xtp2`` and ``tiny-moe`` under ``ep2xtp2``, bf16,
with ``--host-kv-cache-mb``, 16-token blocks and 32-token chunks; the JAX
engine serves the same tree (the port's seed-0 one-card tree) under the
same plan on the 8-device CPU mesh with the same tier. Both run at
pipeline depth 0, and each tier's copies are drained between requests.

- A three-turn chat (each turn hitting the one before, every turn a
  chunked prefill seeded from a hit) and a short prompt whose hit seeds a
  one-shot prefill: greedy ids, each request's reused tokens and the tier
  counters equal JAX's. A turn's ids may part from JAX's only at a near
  tie (``tests/torch_near_tie.py``: both tokens within ``NEAR_TIE`` of
  the logit scale of JAX's fp32 top): ``tiny-moe`` under ``ep2xtp2``
  parts so at turn 3's second token (0.5% of the scale), with the tier
  and without it, since the port sums an MoE layer's expert outputs in
  fp32 (ROADMAP §3).
- Every rank's tier holds the leader's keys, which are JAX's (but the
  blocks of a turn's stored reply past such a parting), at equal bytes:
  JAX's one-process bytes divided by ``tp``.
- Each rank's block is bit for bit the slice at its heads of the block
  JAX's ``HostKVCache`` stores for the replica's whole-head K/V (the
  ranks' blocks side by side), and within bf16's rounding of the JAX
  engine's own block.
- A prefix stored from slot 0 and hit for slots 0 and 2 gives logits
  bitwise equal on both: under ``dp2xtp2`` slot 2 is group 1's, whose
  ranks hold the block because the store sent group 0's rows to them.
- ``tp2`` with the int8 tier and a disk spill under a small RAM budget:
  each rank's int8 block is bit for bit the slice of JAX's int8 block of
  the same whole-head K/V; after evictions, spills and a restore from
  disk, every rank's RAM and spill keys equal the leader's and JAX's.
- ``/kv/export`` gives the ranks' blocks joined over the KV heads,
  ``/kv/import`` and ``/kv/pull`` serve; ``/kv/summary`` gives the
  leader's keys.
- A follower that lost a block the leader names ends the replica with an
  error naming the key and the rank (last: it ends that replica).
"""

import hashlib
import http.client
import json
import os
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpustack_tpu.engine.engine import GenRequest as JaxGenRequest
from gpustack_tpu.engine.engine import LLMEngine as JaxLLMEngine
from gpustack_tpu.engine.kv_host_cache import HostKVCache as JaxHostKVCache
from gpustack_tpu.models.config import PRESETS as JAX_PRESETS
from gpustack_tpu.parallel.mesh import MeshPlan as JaxPlan
from gpustack_tpu_torch.engine.api_server import (  # analysis: ignore[metrics-drift]
    OpenAIServer,
    build_engine_from_args,
    build_parser,
    shutdown_replica,
)
from gpustack_tpu_torch.engine.engine import GenRequest  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.kv_host_cache import HostKVCache  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.weights import load_or_init_params  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.models.config import get_config  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.parallel.mesh import MeshPlan, rank_coords  # analysis: ignore[metrics-drift]

import torch_near_tie as near_tie

BLOCK = 16
ARGV = ["--device", "cpu", "--max-seq-len", "256", "--max-slots", "4",
        "--port", "0", "--pipeline-depth", "0", "--host-kv-cache-mb", "64",
        "--kv-block-tokens", str(BLOCK), "--prefill-chunk", "32"]
MAX_TOKENS = 6
COUNTERS = ("kv_cache_hits", "kv_cache_misses", "kv_cache_prefix_hits",
            "kv_cache_prefix_tokens_reused", "kv_cache_blocks",
            "kv_faultbacks")
# bf16 values of one tree through two frameworks: the JAX engine's block
# against a rank's, relative to the block's scale
BF16_REL = 2e-2
# a bf16 parting of the two frameworks' greedy ids is a near tie when both
# tokens' JAX fp32 logits lie within twice that rounding of the top one
NEAR_TIE = 2 * BF16_REL
PLANS = [("tp2", "tiny"), ("ep2xtp2", "tiny-moe"), ("dp2xtp2", "tiny")]


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


def _ids(n, seed):
    return np.random.default_rng(seed).integers(1, 264, n).tolist()


# chain keys of token blocks (the port's, which the checks hold to JAX's)
_CHAIN = HostKVCache(0, block_tokens=BLOCK)
SHORT = _ids(20, 7)
# each entry builds a prompt from the outputs so far: three turns, each
# extending the last (chunked, seeded from a hit), then a one-shot hit
SCRIPT = [
    lambda outs: _ids(40, 0),
    lambda outs: _ids(40, 0) + outs[0] + _ids(20, 1),
    lambda outs: _ids(40, 0) + outs[0] + _ids(20, 1) + outs[1]
    + _ids(20, 2),
    lambda outs: SHORT,
    lambda outs: SHORT + _ids(10, 8),
]


def _jax_tree(preset):
    tree = load_or_init_params(get_config(preset), None, seed=0,
                               device="cpu")

    def to_jax(t):
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)

    return {k: ({kk: to_jax(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else to_jax(v))
            for k, v in tree.items()}


def _drain(eng):
    """Every store queued on the engine's kv-copy thread has landed (and,
    on a replica's leader, has been named to the followers)."""
    eng._kv_copy_pool.submit(lambda: None).result(timeout=120)


def _serve(eng, gen_cls, script, between=None):
    """``script``'s requests in turn (an entry is a prompt builder, or
    ``(builder, max_tokens)``); ``between(i)`` after request ``i``
    landed."""
    outs, reused = [], []
    for entry in script:
        build, n = entry if isinstance(entry, tuple) else (entry, MAX_TOKENS)
        req = eng.generate(gen_cls(
            prompt_ids=build(outs), max_tokens=n, temperature=0.0,
            stop_ids=()), timeout=300)
        _drain(eng)
        outs.append(list(req.output_ids))
        reused.append(req.prefix_tokens_reused)
        if between is not None:
            between(len(outs) - 1)
    return outs, reused


def _serve_pair(eng, jeng, script, between):
    """The port's replica and the JAX engine in lockstep, one request of
    ``script`` each, then ``between(i)``."""
    got, want = ([], []), ([], [])
    for i in range(len(script)):
        for e, cls, acc in ((eng, GenRequest, got), (jeng, JaxGenRequest,
                                                     want)):
            outs, reused = _serve(e, cls, [
                (lambda o, i=i: script[i][0](acc[0]), script[i][1])])
            acc[0].append(outs[0])
            acc[1].append(reused[0])
        between(i)
    return got, want


def _digest(keys):
    h = hashlib.sha256()
    for k in keys:
        h.update(k.encode())
    return h.hexdigest()


def _jax_keys(jeng):
    cache = jeng.host_kv_cache
    return sorted(k.hex() for k in cache._blocks)


def _jax_spill_keys(jeng):
    spill = jeng.host_kv_cache.spill
    return sorted(spill._index) if spill is not None else []


def _replica(plan, preset, extra=()):
    eng = build_engine_from_args(build_parser().parse_args(
        ARGV + ["--preset", preset, "--mesh-plan", plan, *extra]))
    eng.start()
    return eng


def _close(eng):
    eng.stop()
    shutdown_replica(eng, timeout=30)


def _jax_engine(plan, preset, **kw):
    eng = JaxLLMEngine(
        JAX_PRESETS[preset], _jax_tree(preset), plan=JaxPlan.parse(plan),
        max_slots=4, max_seq_len=256, pipeline_depth=0,
        host_kv_cache_mb=64, kv_block_tokens=BLOCK, prefill_chunk=32, **kw)
    eng.start()
    return eng


def _cross_group_hit(eng):
    """A prefix stored from slot 0 (group 0 under ``dp``), then hit for
    slot 0 and for slot 2 (group 1 under ``dp2xtp2``; the same group
    elsewhere) through the engine's own gather, adoption and prefix
    prefill, from this thread on the idle replica: the two hits' logits."""
    runner = eng.runner
    prefix = _ids(48, 31)
    padded = prefix + [0] * (runner.bucket_for(48) - 48)
    _, k, v = runner.prefill(padded, 48, slot=0)
    eng._submit_kv_copy(prefix, k, v, 48, 0)
    _drain(eng)
    prompt = prefix + _ids(9, 32)
    plen = eng.host_kv_cache.match_prefix_len(prompt)
    assert plen == 48
    suffix = prompt[plen:]
    sb = runner.bucket_for(len(suffix))
    lasts = []
    for slot in (0, 2):
        got = eng._gather_and_upload(GenRequest(prompt_ids=prompt), prompt,
                                     plen, eng.host_kv_cache, slot)
        job = types.SimpleNamespace()
        eng._adopt_prefix(job, got, slot)
        last, _, _ = runner.prefill_with_prefix(
            job.k, job.v, plen, suffix + [0] * (sb - len(suffix)),
            len(suffix), runner.bucket_for(plen + sb), slot=slot)
        lasts.append(last.float().numpy())
    return lasts


@pytest.fixture(scope="module", params=PLANS, ids=[p for p, _ in PLANS])
def served(request):
    """The script through the port's replica and the JAX engine, and what
    the checks read from both; the replica is closed before the tests
    (one replica at a time: rank 0 of each is this process)."""
    plan, preset = request.param
    eng = _replica(plan, preset)
    jeng = _jax_engine(plan, preset)
    run = types.SimpleNamespace(plan=plan, preset=preset)
    try:
        run.outs, run.reused = _serve(eng, GenRequest, SCRIPT)
        run.jouts, run.jreused = _serve(jeng, JaxGenRequest, SCRIPT)
        run.health, run.jhealth = eng.health(), jeng.health()
        run.tiers = eng.runner.probe(eng._state, "kv_tier")
        run.keys, run.jkeys = eng.host_kv_cache.keys(), _jax_keys(jeng)
        run.jbytes = jeng.host_kv_cache.bytes_used
        tokens = _ids(40, 0)[:2 * BLOCK]          # turn 1's two blocks
        run.blocks = eng.runner.probe(eng._state, "kv_block", ids=tokens)
        run.whole = _whole(eng, tokens, plan)
        jblk = jeng.host_kv_cache._blocks[_chain(tokens)[-1]]
        run.jblock = np.asarray(jblk.k), np.asarray(jblk.v)
        run.hit = _cross_group_hit(eng)
        run.status = eng.health()["status"]
    finally:
        jeng.stop()
        _close(eng)
    return run


def _chain(tokens):
    return _CHAIN.chain_keys(tokens)


def _parting(preset, prompt, got, want):
    return near_tie.parting(preset, _jax_tree(preset), prompt, got, want,
                            NEAR_TIE)


def _partings(run):
    return [_parting(run.preset, SCRIPT[t](run.outs), run.outs[t],
                     run.jouts[t]) for t in range(len(SCRIPT))]


def test_three_turn_chat_matches_jax(served):
    run = served
    partings = _partings(run)
    # a parted turn's reply extends no later prompt here
    assert all(p == MAX_TOKENS for p in partings[:2])
    assert run.reused == run.jreused
    r = run.reused
    assert r[1] > 0 and r[2] > r[1] and r[4] == BLOCK
    assert {c: run.health[c] for c in COUNTERS} == {
        c: run.jhealth[c] for c in COUNTERS}


def test_every_rank_holds_the_leaders_keys(served):
    run = served
    tp = MeshPlan.parse(run.plan).tp
    assert len(run.tiers) == MeshPlan.parse(run.plan).chips
    for t in run.tiers:
        assert t["keys_digest"] == _digest(run.keys)
        assert t["entries"] == len(run.keys)
        assert t["bytes"] * tp == run.jbytes
    # JAX's keys, but the blocks of a stored reply past a parting
    apart = set()
    for t, at in enumerate(_partings(run)):
        if at == MAX_TOKENS:
            continue
        prompt = SCRIPT[t](run.outs)
        for out in (run.outs[t], run.jouts[t]):
            keys = _chain(prompt + out[:-1])
            apart |= {k.hex() for k in keys[(len(prompt) + at) // BLOCK:]}
    assert set(run.keys) ^ set(run.jkeys) <= apart
    assert len(run.keys) == len(run.jkeys)


def _whole(eng, tokens, plan):
    """The bf16 K/V of ``tokens``' blocks as the replica's ranks store
    them: each block's ranks side by side over the KV heads (one rank per
    ``tp`` index), the blocks one after another."""
    parts = []
    for b in range(1, len(tokens) // BLOCK + 1):
        by_tp = {}
        blocks = eng.runner.probe(eng._state, "kv_block",
                                  ids=tokens[:b * BLOCK])
        for r, blk in enumerate(blocks):
            by_tp.setdefault(rank_coords(MeshPlan.parse(plan), r)["tp"], blk)
        parts.append([np.concatenate([by_tp[t][name] for t in sorted(by_tp)],
                                     axis=2) for name in ("k", "v")])
    return [np.concatenate([p[i] for p in parts], axis=1) for i in (0, 1)]


def _check_slices(blocks, plan, jblock):
    """Each rank's stored arrays equal ``jblock``'s (a JAX ``_Block``) at
    the rank's heads, bit for bit."""
    mp = MeshPlan.parse(plan)
    for r, blk in enumerate(blocks):
        t = rank_coords(mp, r)["tp"]
        H = blk["k"].shape[2]
        for name in ("k", "v", "k_scale", "v_scale"):
            want = getattr(jblock, name)
            if want is None:
                assert name not in blk
                continue
            want = np.asarray(want)[:, :, t * H:(t + 1) * H]
            got = blk[name]
            assert got.shape == want.shape, (r, name)
            assert got.tobytes() == np.ascontiguousarray(want).tobytes(), (
                r, name)


def test_rank_blocks_are_slices_of_the_one_process_block(served):
    run = served
    tokens = _ids(40, 0)[:2 * BLOCK]
    k, v = run.whole
    one = JaxHostKVCache(1 << 30, block_tokens=BLOCK)
    one.insert_sequence(tokens, k.view(jnp.bfloat16), v.view(jnp.bfloat16))
    _check_slices(run.blocks, run.plan, one._blocks[_chain(tokens)[-1]])
    # and near the JAX engine's own block (bf16 through two frameworks)
    for got, want in ((k[:, BLOCK:], run.jblock[0]),
                      (v[:, BLOCK:], run.jblock[1])):
        g = got.view(jnp.bfloat16).astype(np.float32)
        w = want.astype(np.float32)
        assert np.abs(g - w).max() <= BF16_REL * np.abs(w).max()


def test_hit_across_dp_groups_is_bitwise_the_storing_groups(served):
    np.testing.assert_array_equal(served.hit[0], served.hit[1])
    assert served.status == "ok"


# ---------------------------------------------------------------------------
# tp2: the int8 tier; a disk spill under a small RAM budget
# ---------------------------------------------------------------------------

# RAM for six blocks of the leader's (one rank's heads); JAX's budget is
# the same six blocks at whole heads
SPILL_BLOCKS = 6
BLOCK_BYTES = 2 * BLOCK * 2 * 1 * 16 * 2    # k+v, L 2, H 1 a rank, d 16, bf16
# the three turns, three prompts that push the first of them out to disk,
# then that prompt again, restored from disk (the last four one token
# each: their replies store nothing)
SPILL_SCRIPT = [(f, MAX_TOKENS) for f in SCRIPT[:3]] + [
    (lambda outs: _ids(60, 40), 1),
    (lambda outs: _ids(70, 41), 1),
    (lambda outs: _ids(70, 42), 1),
    (lambda outs: _ids(60, 40) + [5], 1),
]


@pytest.fixture(scope="module")
def spilled(tmp_path_factory):
    """One replica at a time (rank 0 of each is this process): the int8
    tier's blocks of turn 1's first block; then the bf16 tier over a
    spill, with the JAX engine in lockstep, every rank's tier probed after
    each request."""
    plan, preset = "tp2", "tiny"
    tokens = _ids(40, 0)[:BLOCK]
    d = tmp_path_factory.mktemp("spill")
    q8 = _replica(plan, preset, ["--kv-cache-int8"])
    try:
        _serve(q8, GenRequest, SCRIPT[:1])
        int8 = q8.runner.probe(q8._state, "kv_block", ids=tokens)
    finally:
        _close(q8)
    eng = _replica(plan, preset, ["--kv-spill-mb", "8", "--kv-spill-dir",
                                  str(d / "port")])
    jeng = _jax_engine(plan, preset, kv_spill_mb=8,
                       kv_spill_dir=str(d / "jax"))
    try:
        eng.host_kv_cache.max_bytes = SPILL_BLOCKS * BLOCK_BYTES
        jeng.host_kv_cache.max_bytes = SPILL_BLOCKS * BLOCK_BYTES * 2
        tiers, bf16 = [], []

        def probe(i):
            if i == 0:          # the same block, whole heads, from bf16
                bf16.extend(_whole(eng, tokens, plan))
            tiers.append((eng.runner.probe(eng._state, "kv_tier"),
                          _jax_keys(jeng), _jax_spill_keys(jeng)))

        got, want = _serve_pair(eng, jeng, SPILL_SCRIPT, probe)
        yield eng, jeng, (int8, bf16), got, want, tiers
    finally:
        jeng.stop()
        _close(eng)


def test_spill_script_matches_jax(spilled):
    eng, jeng, _, (outs, reused), (jouts, jreused), _ = spilled
    for t, entry in enumerate(SPILL_SCRIPT):
        _parting("tiny", entry[0](outs), outs[t], jouts[t])
    assert reused == jreused and reused[-1] > 0
    health, jhealth = eng.health(), jeng.health()
    assert health["kv_faultbacks"] > 0
    assert health["kv_spill"]["blocks_spilled"] > 0
    assert {c: health[c] for c in COUNTERS} == {
        c: jhealth[c] for c in COUNTERS}


def test_every_rank_keeps_the_leaders_keys_through_spill_and_restore(
        spilled):
    eng, jeng, _, _, _, tiers = spilled
    evicted = False
    for per_rank, jkeys, jspill in tiers:
        for t in per_rank:
            assert t["keys_digest"] == per_rank[0]["keys_digest"]
            assert t["spill_digest"] == per_rank[0]["spill_digest"]
            assert t["bytes"] == per_rank[0]["bytes"]
        assert per_rank[0]["keys_digest"] == _digest(jkeys)
        assert per_rank[0]["spill_digest"] == _digest(jspill)
        evicted |= per_rank[0]["spill_entries"] > 0
        assert per_rank[0]["entries"] <= SPILL_BLOCKS
    assert evicted
    assert eng.host_kv_cache.keys() == _jax_keys(jeng)


def test_int8_rank_blocks_are_slices_of_the_one_process_block(spilled):
    """The int8 replica's blocks of turn 1's first block against JAX's
    int8 cache over the bf16 replica's whole-head K/V of the same block
    (the same plan, tree and prefill: the same bf16 values)."""
    eng, _, (blocks, (k, v)), _, _, _ = spilled
    tokens = _ids(40, 0)[:BLOCK]
    one = JaxHostKVCache(1 << 30, block_tokens=BLOCK, int8=True)
    one.insert_sequence(tokens, k.view(jnp.bfloat16), v.view(jnp.bfloat16))
    key = eng.host_kv_cache.chain_keys(tokens)[-1]
    assert "k_scale" in blocks[0]
    _check_slices(blocks, "tp2", one._blocks[key])


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


def _call_raw(port, path, body=None, raw=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", path,
                     body=raw if raw is not None else json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def test_kv_wire_routes_refuse_and_summary_is_the_leaders(spilled):
    """The routes that move blocks over the wire serve on the replica
    (they answered 400 until a replica moved whole-head blocks):
    ``/kv/export`` of a served chat's prompt gives frames whose payload is
    the ranks' blocks joined over the KV heads; the same frames through
    ``/kv/import`` attach nothing (the tier holds them); ``/kv/pull`` by
    the chain's tail key from the replica itself lands; ``/kv/summary``
    gives the leader's keys."""
    from gpustack_tpu_torch.engine.kv_transfer import decode_stream  # analysis: ignore[metrics-drift]

    eng, _, _, _, _, _ = spilled
    server = OpenAIServer(eng)
    port = server.start("127.0.0.1", 0)
    try:
        msgs = [{"role": "user", "content": "hello there, " * 4}]
        status, _ = _call(port, "POST", "/v1/chat/completions", {
            "messages": msgs, "max_tokens": 4, "temperature": 0})
        assert status == 200
        _drain(eng)
        ids = eng.tokenizer.apply_chat_template(msgs)
        n = (len(ids) - 1) // BLOCK
        status, raw = _call_raw(port, "/kv/export", {"prompt_ids": ids})
        frames = decode_stream(raw)
        assert status == 200 and len(frames) == n >= 1
        ranks = eng.runner.probe(eng._state, "kv_block",
                                 ids=ids[:n * BLOCK])
        for name in ("k", "v"):
            whole = np.concatenate([r[name] for r in ranks], axis=2)
            assert getattr(frames[-1], name).tobytes() == whole.tobytes()
        status, reply = _call_raw(port, "/kv/import", raw=raw)
        assert status == 200
        assert json.loads(reply)["blocks_attached"] == 0
        status, _ = _call(port, "POST", "/kv/pull", {
            "source": f"http://127.0.0.1:{port}/kv/export",
            "tail_key": frames[-1].key})
        assert status == 202
        deadline = time.time() + 60
        while server.prefetch_ok < 1 and time.time() < deadline:
            time.sleep(0.05)
        assert server.prefetch_ok == 1 and server.prefetch_failed == 0
        status, summary = _call(port, "POST", "/kv/summary", {})
        assert status == 200 and summary["keys"]
        leader = set(eng.host_kv_cache.keys())
        for entry in summary["keys"].values():
            assert entry["tail"] in leader
        assert eng.health()["status"] == "ok"
    finally:
        server.shutdown()


def test_follower_lacking_a_named_block_ends_the_replica(spilled):
    """Last in the module: it ends the int8 replica."""
    eng, _, _, _, _, _ = spilled
    prefix = _ids(48, 50)
    eng.generate(GenRequest(prompt_ids=prefix, max_tokens=2,
                            temperature=0.0, stop_ids=()), timeout=300)
    _drain(eng)
    # rank 1 loses the prefix's last full block (a leaf of the trie)
    eng.runner.probe(eng._state, "kv_forget", ids=prefix)
    key = eng.host_kv_cache.chain_keys(prefix)[-1].hex()
    req = eng.submit(GenRequest(prompt_ids=prefix + [7, 8], max_tokens=2,
                                temperature=0.0, stop_ids=()))
    req.done.wait(120)
    deadline = time.time() + 60
    while not eng._fatal and time.time() < deadline:
        time.sleep(0.1)
    health = eng.health()
    assert health["status"] == "error"
    assert f"rank 1 lacks KV block {key}" in health["error"]


def test_concurrent_tier_changes_replay_to_the_leaders_tier(tmp_path):
    """The leader's tier changed from eight threads at once (stores and
    gathers that fault back from disk, as the scheduler and the kv-copy
    thread change it), each change named under
    ``BroadcastingRunner.tier_op``, with a small RAM budget over a spill:
    the ops, replayed on a follower's tier in the order they left, give
    the leader's RAM and spilled keys and its blocks."""
    import sys
    import threading

    from gpustack_tpu_torch.engine import multihost as mh  # analysis: ignore[metrics-drift]
    from gpustack_tpu_torch.engine.kv_spill import DiskKVSpill  # analysis: ignore[metrics-drift]

    bt, ops, mu = 4, [], threading.Lock()

    class Channel:
        error = ""

        def broadcast(self, op):
            with mu:
                ops.append(json.loads(json.dumps(op)))

    def kv(seq):
        x = np.asarray(seq, np.float32)[None, :, None, None]
        return np.repeat(x, 2, axis=3), -np.repeat(x, 2, axis=3)

    block_bytes = 2 * bt * 2 * 4
    caches = []
    for name in ("leader", "follower"):
        cache = HostKVCache(12 * block_bytes, block_tokens=bt)
        cache.spill = DiskKVSpill(str(tmp_path / name), 1 << 20)
        caches.append(cache)
    leader, follower = caches
    leader.lead()
    follower.follow()
    runner = mh.BroadcastingRunner(None, Channel())
    rng = np.random.default_rng(0)
    # short sequences over a small vocabulary: shared prefixes, evictions
    work = [[int(t) for t in rng.integers(1, 4, int(rng.integers(4, 17)))]
            for _ in range(400)]
    ids = iter(range(10 ** 6))

    def run(part):
        for seq in part:
            i = next(ids)
            if i % 3:
                k, v = kv(seq)
                runner.tier_op(
                    leader, lambda: leader.insert_sequence(seq, k, v),
                    lambda _: {"op": "kv_commit", "id": i, "ids": seq})
            else:
                n = leader.peek_prefix_len(seq)
                runner.tier_op(
                    leader, lambda: leader.gather_prefix(seq, n),
                    lambda got: {"op": "kv_gather", "id": i, "ids": seq[:n],
                                 "len": n, "ok": got is not None})

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(work[j::8],))
                   for j in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    for op in ops:
        if op["op"] == "kv_commit":
            lost = follower.replay(op["events"], op["ids"], *kv(op["ids"]))
        else:
            lost = follower.replay(op["events"], op["ids"])
        assert lost == [], (json.dumps(op), lost)
    assert leader.blocks_evicted > 0 and leader.faultbacks > 0
    assert follower.keys() == leader.keys()
    assert follower.spill.keys() == leader.spill.keys()
    assert follower.bytes_used == leader.bytes_used
    for key in leader.keys():
        a, b = leader.block(bytes.fromhex(key)), follower.block(
            bytes.fromhex(key))
        assert a.k.tobytes() == b.k.tobytes() and a.tokens == b.tokens
