"""The host KV tier, speculation, ``--kv-role`` handoffs and embeddings on a
sequence-parallel replica of the port, against the JAX engine under the
same plan.

Each replica is the port's chat server over gloo ranks, one process a
rank (``tests/torch_replica_workers.py``), in fp32 on the JAX package's
own ``tiny`` (or ``tiny-moe``) tree, with 16-token host-tier blocks; the
JAX engine (one process, the 8-device CPU mesh) serves the same tree
under the same plan with the same tier. Every port replica runs in a
thread of its own while the JAX engine runs here.

- ``sp2``, a 64 MiB tier a rank and 32-token chunks: a three-turn chat
  (each turn chunked from a hit on the one before) and a one-shot hit
  give JAX's greedy ids, reused tokens and tier counters; every rank
  holds the leader's keys (JAX's) at equal bytes, half JAX's; each rank's
  block is bit for bit its stripe (``kv_stripe``) of the block JAX's
  ``HostKVCache`` stores for the ranks' stripes joined; under a small RAM
  budget, spills and a hit restored from disk as JAX's, every rank's RAM
  and spilled keys the leader's. ``/v1/embeddings`` within 1e-5 of JAX's
  ``embed``, ``/v1/rerank`` in its order.
- ``sp2`` at ``--max-seq-len 64`` with 29-token prompts, so a 4-token
  verify block crosses the segment end at 32: n-gram speculation over an
  int8 tier (each rank's int8 block, ``q`` and scales, bit for bit its
  stripe of JAX's int8 block of the same K/V) and a draft of the target's
  own tree: greedy ids and spec counters equal JAX's, every rank ran the
  same verify steps and accepted the same proposals. The runner's
  ``verify_step`` and ``ingest_step`` across the segment end equal JAX's.
- An ``sp2`` and a ``tp2`` replica live at once, each the other's
  ``X-GPUStack-KV-Source``: the blocks handed over land on each rank as
  its part of the source's joined blocks, the greedy ids of the handed
  prompts are JAX's cold ones, and both replicas' ``/kv/export`` are the
  frames JAX's one-process cache writes for those blocks, byte for byte.
- ``tiny-moe`` under ``sp2xep2`` with the tier and n-gram speculation:
  a chat's greedy ids, reused tokens and keys equal JAX's.
"""

import dataclasses
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpustack_tpu.engine import kv_transfer as jax_kt
from gpustack_tpu.engine.engine import GenRequest as JaxGenRequest
from gpustack_tpu.engine.engine import LLMEngine as JaxLLMEngine
from gpustack_tpu.engine.kv_host_cache import HostKVCache as JaxHostKVCache
from gpustack_tpu.engine.runner import ModelRunner as JaxRunner
from gpustack_tpu.models import init_params
from gpustack_tpu.models.config import get_config as jax_get_config
from gpustack_tpu.parallel.mesh import MeshPlan as JaxPlan
from gpustack_tpu.parallel.mesh import make_mesh
from gpustack_tpu_torch.engine.kv_host_cache import HostKVCache  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.tokenizer import load_tokenizer  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.models.config import get_config  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.parallel.launch import run_ranks  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.parallel.mesh import (  # analysis: ignore[metrics-drift]
    MeshPlan,
    free_port,
    kv_head_range,
    kv_stripe,
)

import torch_replica_workers as workers
import torch_sp_workers as sp_workers

BT = 16
NEW = 6
MAX_SEQ = 128
SPEC_SEQ = 64
TIER = dict(max_slots=4, host_kv_cache_mb=64, kv_block_tokens=BT)
ARRAYS = ("k", "v", "k_scale", "v_scale")
TOL = dict(rtol=1e-5, atol=1e-5)
COUNTERS = ("kv_cache_hits", "kv_cache_misses", "kv_cache_prefix_hits",
            "kv_cache_prefix_tokens_reused", "kv_cache_blocks",
            "kv_faultbacks")


def _ids(n, seed):
    return np.random.default_rng(seed).integers(1, 250, n).tolist()


# the chat's turns (each after the one before and its reply), then a
# short prompt and its extension (a one-shot hit)
TURNS = [_ids(40, 0), _ids(20, 1), _ids(20, 2)]
SHORT = [_ids(20, 7), _ids(20, 7) + _ids(10, 8)]
# a 29-token prompt: its first block, stored by the fp32 tier and by the
# int8 one, and a verify block at 29 .. 32 across the segment end
Q8 = _ids(29, 9)
SPEC_PROMPTS = [Q8, [5, 6, 7] * 9 + [5, 6], _ids(29, 10)]
# prompts under 16 tokens with replies too short to store a block
WARM = [_ids(n, 20 + n) for n in (12, 9, 5)]
BATCH = [_ids(n, 30 + n) for n in (40, 7, 23, 64, 1)]
TEXTS = ["an sp replica embeds this", "and this one too"]
QUERY = "the cat sat on the mat"
DOCUMENTS = ["the cat sat on a mat", "stock markets fell sharply",
             "a dog slept on the rug", "cats like mats"]
# RAM for six of the leader's blocks; pushing out the chat's, then the
# first fill restored from disk
SPILL_BLOCKS = 6
FILLS = [_ids(60, 40), _ids(70, 41), _ids(70, 42)]
AGAIN = _ids(60, 40) + [5]
# the handoffs: the sp2 replica's prompt pulled by the tp2 one, and back
X_TEXT = "the quick brown fox jumps over the lazy dog, " * 2
Y_TEXT = "a slow green turtle walks under the busy bridge, " * 2
_CHAIN = HostKVCache(0, block_tokens=BT)


@pytest.fixture(scope="module", autouse=True)
def _one_thread_a_rank():
    env = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    if env is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = env


_TREES = {}


def _tree(preset):
    """(JAX config, JAX tree, port config, numpy tree), all fp32."""
    if preset not in _TREES:
        jcfg = dataclasses.replace(jax_get_config(preset), dtype="float32")
        jparams = init_params(jcfg, jax.random.key(0), dtype=jnp.float32)
        cfg = dataclasses.replace(get_config(preset), dtype="float32")
        _TREES[preset] = (jcfg, jparams, cfg,
                          jax.tree.map(np.asarray, jparams))
    return _TREES[preset]


class _Ranks(threading.Thread):
    """One port replica's script (``workers.replica`` on every rank) in a
    thread: ``result()`` is rank 0's return."""

    def __init__(self, plan, preset, script, args, engine_kw,
                 http_port=0):
        super().__init__(daemon=True)
        self.call = (plan, preset, script, args, engine_kw, http_port)
        self.out = self.err = None
        self.start()

    def run(self):
        plan, preset, script, args, kw, http_port = self.call
        _, _, cfg, tree = _tree(preset)
        try:
            self.out = run_ranks(
                workers.replica, MeshPlan.parse(plan).chips, cfg, tree,
                plan, kw, free_port(), http_port, script, args,
                timeout=300, threads=1)[0]
        except Exception as e:          # raised in the test's thread
            self.err = e

    def result(self):
        self.join(330)
        if self.err is not None:
            raise self.err
        assert self.out is not None, "the replica did not finish"
        return self.out


def _jax_engine(preset, plan, max_seq_len, **kw):
    jcfg, jparams, _, _ = _tree(preset)
    eng = JaxLLMEngine(jcfg, jparams, plan=JaxPlan.parse(plan),
                       max_seq_len=max_seq_len, pipeline_depth=0,
                       **dict(TIER, **kw))
    eng.start()
    return eng


def _jgreedy(eng, ids, n=NEW):
    req = eng.generate(JaxGenRequest(prompt_ids=list(ids), max_tokens=n,
                                     temperature=0.0, stop_ids=()),
                       timeout=300)
    if eng.host_kv_cache is not None:
        eng._kv_copy_pool.submit(lambda: None).result(timeout=120)
    return list(req.output_ids), req.prefix_tokens_reused


def _jchat(eng):
    """``workers.chat_checks`` on the JAX engine."""
    outs, reused, prompt = [], [], []
    for t, extra in enumerate(TURNS):
        prompt = prompt + (outs[-1] if t else []) + list(extra)
        ids, n = _jgreedy(eng, prompt)
        outs.append(ids)
        reused.append(n)
    for p in SHORT:
        ids, n = _jgreedy(eng, p)
        outs.append(ids)
        reused.append(n)
    return {"ids": outs, "reused": reused, "health": eng.health(),
            "keys": sorted(k.hex() for k in eng.host_kv_cache._blocks)}


def _jspill(eng, budget):
    eng.host_kv_cache.max_bytes = budget
    reused = [_jgreedy(eng, p, 1)[1] for p in FILLS + [AGAIN]]
    return {"reused": reused, "health": eng.health(),
            "keys": sorted(k.hex() for k in eng.host_kv_cache._blocks),
            "spill": sorted(eng.host_kv_cache.spill._index)}


def _digest(keys):
    import hashlib

    return hashlib.sha256("".join(keys).encode()).hexdigest()


def _leader_block_bytes(cfg):
    """One fp32 block's bytes on an ``sp2`` rank: its 8-row stripe."""
    return 2 * cfg.num_layers * (BT // 2) * cfg.num_kv_heads * \
        cfg.head_dim * 4


def _joined(per_rank, plan, kv_heads):
    """One block's arrays whole from every rank's ``probe("kv_block")``
    arrays: one rank per distinct part, heads joined within a stripe,
    then the stripes over the tokens (the scales from the first stripe)."""
    mp = MeshPlan.parse(plan)
    by_part = {}
    for r, arrays in enumerate(per_rank):
        by_part.setdefault((kv_stripe(mp, r, BT),
                            kv_head_range(mp, r, kv_heads)), arrays)
    stripes = sorted({s for s, _ in by_part})
    out = {}
    for name in by_part[next(iter(by_part))]:
        rows = [np.concatenate([by_part[(s, h)][name] for h in sorted(
            h for t, h in by_part if t == s)], axis=2) for s in stripes]
        out[name] = (np.concatenate(rows, axis=1)
                     if name in ("k", "v") else rows[0])
    return out


def _check_parts(per_rank, plan, kv_heads, want):
    """Each rank's arrays are ``want``'s (name -> whole array) at its KV
    heads and its stripe of the tokens (the scales at its heads), bit for
    bit."""
    mp = MeshPlan.parse(plan)
    for r, arrays in enumerate(per_rank):
        h0, h1 = kv_head_range(mp, r, kv_heads)
        r0, r1 = kv_stripe(mp, r, BT)
        assert sorted(arrays) == sorted(n for n in ARRAYS
                                        if want.get(n) is not None), r
        for name, got in arrays.items():
            w = np.asarray(want[name])[:, :, h0:h1]
            if name in ("k", "v"):
                w = w[:, r0:r1]
            w = np.ascontiguousarray(w)
            assert got.shape == w.shape, (r, name)
            assert got.tobytes() == w.tobytes(), (r, name)


def _one_process_block(tokens, whole, int8=False):
    """JAX's one-process ``HostKVCache`` block of ``tokens``' last full
    block, stored from the whole K/V ``whole`` of its blocks."""
    one = JaxHostKVCache(1 << 30, block_tokens=BT, int8=int8)
    one.insert_sequence(tokens, whole["k"], whole["v"])
    blk = one._blocks[_CHAIN.chain_keys(tokens)[-1]]
    return {n: None if getattr(blk, n) is None else np.asarray(
        getattr(blk, n)) for n in ARRAYS}


# ---------------------------------------------------------------------------
# layouts: the tier's stripes and the runner's moves between layouts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sp", [2, 3, 4])
def test_stripes_tile_every_block_size(sp):
    """``kv_stripe`` gives the ``sp`` ranks disjoint rows that tile a
    block of any size, even when ``sp`` does not divide it."""
    plan = MeshPlan(sp=sp)
    for bt in (1, 3, 10, 16, 256):
        rows = [kv_stripe(plan, r, bt) for r in range(sp)]
        assert rows[0][0] == 0 and rows[-1][1] == bt
        assert all(a[1] == b[0] for a, b in zip(rows, rows[1:]))


@pytest.mark.parametrize("sp", [2, 3, 4])
def test_layout_runs_place_each_position_once(sp):
    """Between any two of a bucket's blocks, the decode cache's segments
    and the tier's stripes, ``_sp_move``'s runs carry every position from
    its row in one layout to its row in the other, once."""
    from gpustack_tpu_torch.engine.runner import KVLayout, _layout_runs  # analysis: ignore[metrics-drift]

    def place(layout, n):
        at = {}
        for lo, hi, i, row in layout.pieces(n, sp):
            for p in range(lo, hi):
                assert p not in at
                at[p] = (i, row + p - lo)
        assert sorted(at) == list(range(n))
        return at

    layouts = [KVLayout(24 * sp), KVLayout(48 * sp), KVLayout(block=16),
               KVLayout(block=10), KVLayout(block=3)]
    for src in layouts:
        for dst in layouts:
            for n in (0, 1, 17, 24 * sp):
                a, b = place(src, n), place(dst, n)
                seen = []
                for p0, m, si, sr, di, dr in _layout_runs(src, dst, n, sp):
                    for t in range(m):
                        assert a[p0 + t] == (si, sr + t)
                        assert b[p0 + t] == (di, dr + t)
                        seen.append(p0 + t)
                assert seen == list(range(n))


# ---------------------------------------------------------------------------
# the runner: verify and ingest blocks across the segment end
# ---------------------------------------------------------------------------


def test_verify_and_ingest_across_the_segment_end_match_jax():
    """Slot 0's 29-token prompt takes a verify block of its own greedy
    continuation at 29 .. 32 (all accepted, across the segment end at
    32), slot 1's random proposals; then an ingest block and another
    verify step: the port's runner under ``sp2`` (two gloo ranks)
    against JAX's under ``sp2``, each followed by a decode step."""
    jcfg, jparams, cfg, tree = _tree("tiny")
    prompts = [Q8, _ids(30, 11)]
    jplan = JaxPlan.parse("sp2")
    runner = JaxRunner(jcfg, jparams, plan=jplan, mesh=make_mesh(jplan),
                       max_slots=2, max_seq_len=SPEC_SEQ)
    key = jax.random.key(0)

    def fresh():
        st = runner.new_state()
        for slot, p in enumerate(prompts):
            b = runner.bucket_for(len(p))
            last, k, v = runner.prefill(p + [0] * (b - len(p)), len(p))
            st = runner.insert(st, k, v, slot, len(p),
                               int(np.argmax(np.asarray(last))), 0.0, 0, 1.0)
        return st

    st, chain = fresh(), []
    for _ in range(3):
        st, out = runner.decode_step(st, key)
        chain.append(int(np.asarray(out[0])[0]))
    rng = np.random.default_rng(12)
    first = np.stack([chain + [0], rng.integers(1, 250, 4)]).astype(np.int64)
    blocks = [("verify", first, None),
              ("ingest", rng.integers(1, 250, (2, 4)).astype(np.int64),
               np.array([3, 1], np.int64)),
              ("verify", rng.integers(1, 250, (2, 4)).astype(np.int64),
               None)]
    ranks = run_ranks(sp_workers.verify_ingest, 2, cfg, tree, "sp2",
                      prompts, blocks, SPEC_SEQ, timeout=240, threads=1)
    st = fresh()
    for i, (kind, tokens, counts) in enumerate(blocks):
        if kind == "verify":
            st, greedy, produced = runner.verify_step(
                st, tokens.astype(np.int32))
            want = (np.asarray(greedy), np.asarray(produced))
        else:
            st = runner.ingest_step(st, tokens.astype(np.int32),
                                    counts.astype(np.int32))
            want = None
        after = (np.asarray(st.last_tokens), np.asarray(st.positions))
        st, out = runner.decode_step(st, key)
        got = ranks[0][i]
        if want is not None:
            np.testing.assert_array_equal(got[0][0], want[0])
            np.testing.assert_array_equal(got[0][1], want[1])
        np.testing.assert_array_equal(got[1], after[0])
        np.testing.assert_array_equal(got[2], after[1])
        np.testing.assert_array_equal(got[3], np.asarray(out[0]))
        assert float(np.abs(got[4] - np.asarray(out[1])).max()) <= 1e-5
        for other in ranks[1:]:
            for a, b in zip(other[i][1:], got[1:]):
                np.testing.assert_array_equal(a, b)
    # the first block's three proposals were the model's own
    assert ranks[0][0][0][1][0] == 4 and ranks[0][0][2][0] == 33


# ---------------------------------------------------------------------------
# sp2: the tier, a spill, embeddings
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tier(tmp_path_factory):
    d = tmp_path_factory.mktemp("spill")
    _, _, cfg, _ = _tree("tiny")
    budget = SPILL_BLOCKS * _leader_block_bytes(cfg)
    x_ids = load_tokenizer(None).encode(X_TEXT)
    y_ids = load_tokenizer(None).encode(Y_TEXT)
    port = _Ranks("sp2", "tiny", workers.sequence, ([
        ("chat_checks", (TURNS, SHORT, NEW)),
        ("block_checks", (TURNS[0], 2)),
        ("block_checks", (Q8, 1)),
        ("embed_checks", (BATCH, TEXTS, QUERY, DOCUMENTS, WARM)),
        ("spill_checks", (budget, FILLS, AGAIN)),
    ],), dict(TIER, max_seq_len=MAX_SEQ, prefill_chunk=32, kv_spill_mb=8,
              kv_spill_dir=str(d / "port")))
    jeng = _jax_engine("tiny", "sp2", MAX_SEQ, prefill_chunk=32,
                       kv_spill_mb=8, kv_spill_dir=str(d / "jax"))
    try:
        want = {"chat": _jchat(jeng)}
        _jgreedy(jeng, TURNS[0], 1)
        _jgreedy(jeng, Q8, 1)
        for ids in WARM:
            _jgreedy(jeng, ids, 3)
        want["embed"] = {
            "ids": np.asarray(jeng.embed(BATCH), np.float32),
            "text": np.asarray(jeng.embed(
                [jeng.tokenizer.encode(t) for t in TEXTS]), np.float32),
            "rerank": np.asarray(jeng.embed(
                [jeng.tokenizer.encode(t) for t in [QUERY] + DOCUMENTS]),
                np.float32),
        }
        want["spill"] = _jspill(jeng, 2 * budget)
        # the handoffs' prompts, cold (their blocks are not in the tier)
        want["x_ids"] = _jgreedy(jeng, x_ids)[0]
        want["y_ids"] = _jgreedy(jeng, y_ids)[0]
    finally:
        jeng.stop()
    chat, turn1, q8, embed, spill = port.result()
    return {"chat": chat, "turn1": turn1, "q8": q8, "embed": embed,
            "spill": spill, "want": want, "cfg": cfg}


def test_sp2_chat_over_the_tier_matches_jax(tier):
    chat, want = tier["chat"], tier["want"]["chat"]
    assert chat["ids"] == want["ids"]
    assert chat["reused"] == want["reused"]
    r = chat["reused"]
    assert r[1] > 0 and r[2] > r[1] and r[4] == BT
    assert {c: chat["health"][c] for c in COUNTERS} == {
        c: want["health"][c] for c in COUNTERS}
    assert chat["health"]["status"] == "ok"


def test_every_rank_holds_the_leaders_keys_at_half_the_bytes(tier):
    chat, want = tier["chat"], tier["want"]["chat"]
    assert chat["leader_keys"] == want["keys"]
    assert len(chat["tiers"]) == 2
    for t in chat["tiers"]:
        assert t["keys_digest"] == _digest(chat["leader_keys"])
        assert t["entries"] == len(want["keys"])
        assert t["bytes"] == len(want["keys"]) * _leader_block_bytes(
            tier["cfg"])


def test_rank_blocks_are_stripes_of_the_one_process_block(tier):
    """Turn 1's two blocks: each rank's stored arrays are its stripe of
    JAX's one-process block over the ranks' stripes joined."""
    tokens = TURNS[0][:2 * BT]
    heads = tier["cfg"].num_kv_heads
    whole = {n: np.concatenate([_joined(b, "sp2", heads)[n]
                                for b in tier["turn1"]], axis=1)
             for n in ("k", "v")}
    for b in range(2):
        want = _one_process_block(tokens[:(b + 1) * BT], {
            n: whole[n][:, :(b + 1) * BT] for n in whole})
        _check_parts(tier["turn1"][b], "sp2", heads, want)


def test_spill_and_a_hit_from_disk_match_jax(tier):
    spill, want = tier["spill"], tier["want"]["spill"]
    assert spill["reused"] == want["reused"] and spill["reused"][-1] > 0
    assert spill["leader_keys"] == want["keys"]
    assert spill["leader_spill"] == want["spill"]
    health = spill["health"]
    assert health["kv_faultbacks"] > 0
    assert health["kv_spill"]["blocks_spilled"] > 0
    assert {c: health[c] for c in COUNTERS} == {
        c: want["health"][c] for c in COUNTERS}
    for per_rank in spill["tiers"]:
        for t in per_rank:
            assert t["keys_digest"] == per_rank[0]["keys_digest"]
            assert t["spill_digest"] == per_rank[0]["spill_digest"]
            assert t["bytes"] == per_rank[0]["bytes"]
    assert spill["tiers"][-1][0]["spill_digest"] == _digest(want["spill"])


def test_sp2_embeddings_match_jax(tier):
    embed, want = tier["embed"], tier["want"]["embed"]
    for name in ("ids", "text"):
        status, reply = embed[name]
        assert status == 200, reply
        got = workers.vectors(reply)
        np.testing.assert_allclose(got, want[name], **TOL)
    status, reply = embed["base64"]
    assert status == 200
    before, after = embed["slot_state_before"], embed["slot_state_after"]
    for b, a in zip(before, after):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(b, before[0])
    assert embed["status"] == "ok"


def test_sp2_rerank_is_the_jax_cosines_in_their_order(tier):
    status, reply = tier["embed"]["rerank"]
    assert status == 200, reply
    vecs = tier["want"]["embed"]["rerank"]
    want = vecs[1:] @ vecs[0]
    order = [r["index"] for r in reply["results"]]
    assert order == sorted(range(len(DOCUMENTS)), key=lambda i: -want[i])
    np.testing.assert_allclose(
        [r["relevance_score"] for r in reply["results"]], want[order],
        **TOL)


# ---------------------------------------------------------------------------
# sp2 at 64 positions: speculation across the segment end, the int8 tier
# ---------------------------------------------------------------------------

SPEC_KW = {"ngram": dict(TIER, max_seq_len=SPEC_SEQ, kv_cache_int8=True,
                         speculative="ngram"),
           "draft": dict(max_slots=4, max_seq_len=SPEC_SEQ,
                         speculative="draft", draft=True)}


_SPEC = {}


def _spec_run(mode):
    """The port's ``sp2`` replica in ``mode`` and the JAX engine: the
    speculative prompts (and under n-gram, over the int8 tier, Q8's
    first block on every rank). Run once a mode."""
    if mode in _SPEC:
        return _SPEC[mode]
    kw = SPEC_KW[mode]
    steps = [("spec_checks", (SPEC_PROMPTS, 16))]
    if mode == "ngram":
        steps.append(("block_checks", (Q8, 1)))
    port = _Ranks("sp2", "tiny", workers.sequence, (steps,), kw)
    jcfg, jparams, _, _ = _tree("tiny")
    jkw = {k: v for k, v in kw.items() if k not in ("draft", "max_slots")}
    if mode == "draft":
        jkw.update(draft_cfg=jcfg, draft_params=jparams,
                   host_kv_cache_mb=0)
    jeng = _jax_engine("tiny", "sp2", **jkw)
    try:
        names = ("_spec_steps", "_spec_proposed", "_spec_hits")
        ids, counts = [], []
        for p in SPEC_PROMPTS:
            before = [getattr(jeng, k) for k in names]
            ids.append(_jgreedy(jeng, p, 16)[0])
            counts.append([getattr(jeng, k) - b
                           for k, b in zip(names, before)])
    finally:
        jeng.stop()
    _SPEC[mode] = (mode, port.result(), (ids, counts))
    return _SPEC[mode]


@pytest.fixture(scope="module", params=list(SPEC_KW))
def spec(request):
    return _spec_run(request.param)


def test_speculation_across_the_segment_end_matches_jax(spec):
    mode, (out, *_), (ids, counts) = spec
    assert out["ids"] == ids
    assert out["counts"] == counts
    steps, proposed, accepted = (sum(c[i] for c in counts)
                                 for i in range(3))
    assert steps > 0 and proposed > 0
    assert out["health"]["speculative"] == mode
    # every rank ran each verify step and took rank 0's accepted tokens
    assert len(out["spec"]) == 2 and out["spec"][1] == out["spec"][0]
    assert out["spec"][0] == [steps, accepted]
    if mode == "draft":
        assert accepted >= 0.9 * proposed


def test_int8_rank_blocks_are_stripes_of_the_one_process_block(tier):
    """The int8 replica's blocks of Q8's first block against JAX's int8
    cache over the fp32 replica's stripes of the same block joined (the
    same plan, tree and prefill: the same values): ``q`` and the whole
    block's scales, bit for bit."""
    _, out, _ = _spec_run("ngram")
    heads = tier["cfg"].num_kv_heads
    whole = _joined(tier["q8"][0], "sp2", heads)
    want = _one_process_block(Q8[:BT], whole, int8=True)
    assert want["k_scale"] is not None
    _check_parts(out[1][0], "sp2", heads, want)


# ---------------------------------------------------------------------------
# handoffs: sp2 -> tp2 and tp2 -> sp2, two live replicas
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def handoff(tmp_path_factory, tier):
    """An ``sp2`` replica (``--kv-role prefill``) and a ``tp2`` one
    (``decode``), live at once: the ``tp2`` one pulls :data:`X_TEXT`
    from the ``sp2`` one, which then pulls :data:`Y_TEXT` back."""
    d = tmp_path_factory.mktemp("handoff")
    ports = {"sp2": free_port(), "tp2": free_port()}
    signals = {p: str(d / p) for p in ports}
    kw = dict(TIER, max_seq_len=MAX_SEQ)
    runs = {
        "tp2": _Ranks("tp2", "tiny", workers.handoff_peer, (
            ports["sp2"], X_TEXT, Y_TEXT, False, signals["sp2"],
            signals["tp2"], NEW), dict(kw, kv_role="decode"),
            http_port=ports["tp2"]),
        "sp2": _Ranks("sp2", "tiny", workers.handoff_peer, (
            ports["tp2"], Y_TEXT, X_TEXT, True, signals["tp2"],
            signals["sp2"], NEW), dict(kw, kv_role="prefill"),
            http_port=ports["sp2"]),
    }
    try:
        out = {p: r.result() for p, r in runs.items()}
    finally:
        for path in signals.values():
            open(path, "a").close()
    return out, tier["want"], tier["cfg"].num_kv_heads


def _frames_of(reply):
    status, raw = reply
    assert status == 200
    return raw


@pytest.mark.parametrize("src,dst,want", [("sp2", "tp2", "x_ids"),
                                          ("tp2", "sp2", "y_ids")])
def test_handoff_gives_the_jax_cold_ids(handoff, src, dst, want):
    out, jax_want, _ = handoff
    dec = out[dst]
    n = (len(dec["prompt_ids"]) - 1) // BT
    status, reply = dec["completion"]
    assert status == 200, reply
    assert dec["handoff"]["pulls"] == 1 and not dec["handoff"]["failures"]
    assert dec["handoff"]["blocks_in"] == n >= 3
    assert dec["reused"] == n * BT
    assert dec["ids"] == jax_want[want]
    assert dec["status"] == out[src]["status"] == "ok"
    digest = _digest(dec["leader_keys"])
    assert all(t["keys_digest"] == digest for t in dec["tiers"])


@pytest.mark.parametrize("src,dst", [("sp2", "tp2"), ("tp2", "sp2")])
def test_handed_blocks_are_each_ranks_part_of_the_source_frames(
        handoff, src, dst):
    """The source's ``/kv/export`` of the prompt it handed over is JAX's
    one-process frames of those blocks byte for byte (JAX decodes and
    lands them, and its own export is the same bytes), the receiver's
    export is the same bytes, and each of the receiver's ranks holds its
    part (heads, stripe) of each frame's block, bit for bit."""
    out, _, heads = handoff
    raw = _frames_of(out[src]["served_export"])
    frames = jax_kt.decode_stream(raw)
    one = JaxHostKVCache(1 << 30, block_tokens=BT)
    jax_kt.import_frames(one, frames)
    ids = out[dst]["prompt_ids"]
    assert b"".join(jax_kt.export_frames(one, ids)) == raw
    assert _frames_of(out[dst]["export"]) == raw
    assert len(frames) == len(out[dst]["blocks"]) >= 3
    for fr, per_rank in zip(frames, out[dst]["blocks"]):
        _check_parts(per_rank, dst, heads, {n: getattr(fr, n)
                                            for n in ARRAYS})


# ---------------------------------------------------------------------------
# tiny-moe under sp2xep2: the tier and n-gram speculation
# ---------------------------------------------------------------------------


def test_moe_sp2xep2_tier_and_ngram_match_jax():
    kw = dict(TIER, max_seq_len=MAX_SEQ, prefill_chunk=32,
              speculative="ngram")
    port = _Ranks("sp2xep2", "tiny-moe", workers.sequence, ([
        ("chat_checks", (TURNS, SHORT, NEW)),
        ("spec_checks", (SPEC_PROMPTS[1:], 16)),
    ],), kw)
    jeng = _jax_engine("tiny-moe", "sp2xep2", MAX_SEQ, prefill_chunk=32,
                       speculative="ngram")
    try:
        chat = _jchat(jeng)
        ids = [_jgreedy(jeng, p, 16)[0] for p in SPEC_PROMPTS[1:]]
    finally:
        jeng.stop()
    got_chat, got_spec = port.result()
    assert got_chat["ids"] == chat["ids"]
    assert got_chat["reused"] == chat["reused"]
    assert got_chat["reused"][2] > got_chat["reused"][1] > 0
    assert got_chat["leader_keys"] == chat["keys"]
    assert len(got_chat["tiers"]) == 4
    for t in got_chat["tiers"]:
        assert t["keys_digest"] == _digest(chat["keys"])
        assert t["bytes"] == got_chat["tiers"][0]["bytes"]
    assert got_spec["ids"] == ids
    assert got_spec["health"]["spec_steps"] > 0
    assert all(s == got_spec["spec"][0] for s in got_spec["spec"])
