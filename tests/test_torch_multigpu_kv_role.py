"""Disaggregated prefill/decode on a multi-GPU replica of the port, against
the JAX package.

Each replica is the port's chat server over gloo ranks, one process a
rank (``tests/torch_replica_workers.py``), in fp32 on the JAX package's
own ``tiny`` or ``tiny-moe`` tree, with a 64 MiB host tier of 16-token
blocks a rank. The JAX engine (one process, the same tree and tier)
serves the same prompts.

- The JAX engine's export of a prompt, through a replica's
  ``/kv/import`` under ``tp2``, ``ep2`` (``tiny-moe``), ``dp2`` and
  ``tp4`` (``tiny`` has 2 KV heads: two ranks share each), leaves each
  rank's blocks at exactly JAX's blocks at the rank's heads, and every
  rank's tier holds the leader's keys; the same for the int8 tier, scales
  included (``tp2``, ``tp4``).
- The replica's ``/kv/export`` (by prompt ids, with ``have``, by tail key,
  and with prefill on a miss) writes the JAX one-process frames: JAX's
  ``decode_stream`` and ``prepare_import`` land them in a JAX
  ``HostKVCache`` whose blocks are the ranks' blocks joined over the KV
  heads, each head once, and whose own export is the same bytes.
- A hit on the imported blocks gives the JAX engine's greedy ids.
- Live handoffs between two replicas of different plans (``tp2`` to one
  process, ``ep2`` to ``tp2``), ``--kv-role prefill`` to ``decode``: the
  ``X-GPUStack-KV-Source`` prefetch and a ``/kv/pull`` by tail key land
  the source ranks' blocks joined over heads at each decode rank's
  heads, and the decode replica's greedy ids are the JAX engine's.

Handoffs out of and into an ``sp`` replica are
``tests/test_torch_sp_features.py``'s.
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
from gpustack_tpu.models import init_params
from gpustack_tpu.models.config import get_config as jax_get_config
from gpustack_tpu_torch.engine.kv_host_cache import HostKVCache  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.tokenizer import load_tokenizer  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.models.config import get_config  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.parallel.launch import run_ranks  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.parallel.mesh import (  # analysis: ignore[metrics-drift]
    MeshPlan,
    free_port,
    kv_head_range,
    rank_coords,
)

import torch_replica_workers as workers

BT = 16
MAX_SEQ = 128
NEW = 6
TIER = dict(max_slots=4, max_seq_len=MAX_SEQ, host_kv_cache_mb=64,
            kv_block_tokens=BT)
A = np.random.default_rng(0).integers(1, 250, 40).tolist()   # 2 blocks
B = np.random.default_rng(1).integers(1, 250, 52).tolist()   # 3 blocks
TAIL = np.random.default_rng(2).integers(1, 250, 9).tolist()
# (plan, preset, int8 tier)
PLANS = [("tp2", "tiny", False), ("ep2", "tiny-moe", False),
         ("dp2", "tiny", False), ("tp4", "tiny", False),
         ("tp2", "tiny", True), ("tp4", "tiny", True)]
ARRAYS = ("k", "v", "k_scale", "v_scale")
# chain keys of token blocks (the port's; the JAX cache's are the same)
_CHAIN = HostKVCache(0, block_tokens=BT)


def _trees(preset):
    """(JAX config, JAX tree, port config, numpy tree), all fp32."""
    jcfg = dataclasses.replace(jax_get_config(preset), dtype="float32")
    jparams = init_params(jcfg, jax.random.key(0), dtype=jnp.float32)
    cfg = dataclasses.replace(get_config(preset), dtype="float32")
    return jcfg, jparams, cfg, jax.tree.map(np.asarray, jparams)


_TREES = {}


def _tree(preset):
    if preset not in _TREES:
        _TREES[preset] = _trees(preset)
    return _TREES[preset]


def _jax_engine(preset, int8=False):
    jcfg, jparams, _, _ = _tree(preset)
    eng = JaxLLMEngine(jcfg, jparams, pipeline_depth=0, kv_cache_int8=int8,
                       **TIER)
    eng.start()
    return eng


def _jax_greedy(eng, ids):
    """Greedy ids; the request's store has landed in the tier."""
    out = list(eng.generate(JaxGenRequest(
        prompt_ids=list(ids), max_tokens=NEW, temperature=0.0),
        timeout=300).output_ids)
    eng._kv_copy_pool.submit(lambda: None).result(timeout=120)
    return out


def _run(plan, preset, script, args, engine_kw=None, http_port=0):
    _, _, cfg, tree = _tree(preset)
    kw = dict(TIER, **(engine_kw or {}))
    return run_ranks(workers.replica, MeshPlan.parse(plan).chips, cfg, tree,
                     plan, kw, free_port(), http_port, script, args,
                     timeout=300, threads=1)[0]


def _frames(raw):
    return jax_kt.decode_stream(raw)


def _joined(per_rank, plan, kv_heads):
    """One block's arrays whole-head from every rank's ``probe`` arrays:
    one rank per distinct head range, in head order."""
    mp = MeshPlan.parse(plan)
    by_span = {}
    for r, arrays in enumerate(per_rank):
        by_span.setdefault(kv_head_range(mp, r, kv_heads), arrays)
    spans = sorted(by_span)
    return {name: np.concatenate([by_span[s][name] for s in spans], axis=2)
            for name in by_span[spans[0]]}


def _check_slices(per_rank, plan, kv_heads, want):
    """Each rank's arrays are ``want``'s (name -> whole-head array) at its
    heads, bit for bit."""
    mp = MeshPlan.parse(plan)
    for r, arrays in enumerate(per_rank):
        lo, hi = kv_head_range(mp, r, kv_heads)
        assert sorted(arrays) == sorted(n for n in ARRAYS
                                        if want.get(n) is not None), r
        for name, got in arrays.items():
            w = np.ascontiguousarray(np.asarray(want[name])[:, :, lo:hi])
            assert got.shape == w.shape, (r, name)
            assert got.tobytes() == w.tobytes(), (r, name)


def _jax_block(blk):
    return {n: None if getattr(blk, n) is None else np.asarray(getattr(blk, n))
            for n in ARRAYS}


@pytest.fixture(scope="module", autouse=True)
def _one_thread_a_rank():
    env = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    if env is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = env


@pytest.fixture(scope="module", params=PLANS,
                ids=[f"{p}-{m}{'-int8' if q else ''}" for p, m, q in PLANS])
def handled(request):
    """The JAX engine's export of ``A`` and its ids for ``A + TAIL``, then
    one replica's :func:`workers.kv_checks`."""
    plan, preset, int8 = request.param
    jeng = _jax_engine(preset, int8)
    try:
        _jax_greedy(jeng, A)
        frames = b"".join(jax_kt.export_frames(jeng.host_kv_cache, A))
        jblocks = [_jax_block(jeng.host_kv_cache._blocks[k])
                   for k in _CHAIN.chain_keys(A)]
        jids = _jax_greedy(jeng, A + TAIL)
    finally:
        jeng.stop()
    out = _run(plan, preset, workers.kv_checks, (frames, A, B, TAIL, NEW),
               {"kv_cache_int8": int8, "kv_role": "decode"})
    heads = _tree(preset)[2].num_kv_heads
    return dict(out, plan=plan, preset=preset, int8=int8, frames=frames,
                jblocks=jblocks, jids=jids, heads=heads)


def test_jax_export_lands_at_each_ranks_heads(handled):
    h = handled
    status, reply = h["import"]
    assert status == 200, reply
    assert reply["blocks_attached"] == len(A) // BT
    assert reply["bytes"] == sum(f.nbytes for f in _frames(h["frames"]))
    for per_rank, jblk in zip(h["a_blocks"], h["jblocks"]):
        _check_slices(per_rank, h["plan"], h["heads"], jblk)
    assert ("k_scale" in h["a_blocks"][0][0]) == h["int8"]


def test_every_rank_holds_the_leaders_keys_after_an_import(handled):
    import hashlib

    digest = hashlib.sha256(
        "".join(handled["leader_keys"]).encode()).hexdigest()
    assert len(handled["tiers"]) == MeshPlan.parse(handled["plan"]).chips
    for t in handled["tiers"]:
        assert t["keys_digest"] == digest
        assert t["entries"] == len(handled["leader_keys"])


def test_reexport_is_the_jax_frames_byte_for_byte(handled):
    """The imported blocks exported again, by prompt ids and by tail key:
    JAX's own frames, byte for byte; with the first block in ``have``,
    its frame carries tokens only."""
    h = handled
    for name in ("a_export", "a_chain"):
        status, raw = h[name]
        assert status == 200
        assert raw == h["frames"], name
    status, raw = h["a_export_have"]
    frames = _frames(raw)
    assert status == 200 and frames[0].skipped and not frames[1].skipped
    assert frames[1].k.tobytes() == _frames(h["frames"])[1].k.tobytes()


def test_export_is_the_one_process_frames_of_the_joined_heads(handled):
    """``B`` exported with prefill on a miss: decoded by the JAX package
    into a JAX ``HostKVCache`` of the replica's tier, each block is the
    ranks' blocks joined over the KV heads, bit for bit, and that cache's
    export is the replica's bytes."""
    h = handled
    status, raw = h["b_export"]
    assert status == 200
    frames = _frames(raw)
    n = (len(B) - 1) // BT
    assert len(frames) == n and not any(f.skipped for f in frames)
    cache = JaxHostKVCache(1 << 30, block_tokens=BT, int8=h["int8"])
    tokens, prepared, _ = jax_kt.prepare_import(cache, frames)
    assert cache.import_blocks(tokens, prepared) == n
    for b, per_rank in enumerate(h["b_blocks"]):
        whole = _joined(per_rank, h["plan"], h["heads"])
        blk = _jax_block(cache._blocks[_CHAIN.chain_keys(B)[b]])
        for name, arr in whole.items():
            assert arr.tobytes() == np.ascontiguousarray(
                blk[name]).tobytes(), (b, name)
        assert all(blk[name] is None for name in ARRAYS if name not in whole)
    assert b"".join(jax_kt.export_frames(cache, B)) == raw


def test_a_hit_on_imported_blocks_gives_the_jax_ids(handled):
    assert handled["reused"] == len(A) // BT * BT
    assert handled["ids"] == handled["jids"]
    assert handled["handoff"]["blocks_out"] >= len(A) // BT
    assert handled["status"] == "ok"


# ---------------------------------------------------------------------------
# live handoffs between replicas of different plans
# ---------------------------------------------------------------------------

TEXT = "the quick brown fox jumps over the lazy dog, " * 2   # 5 blocks
CHAT = np.random.default_rng(3).integers(1, 250, 2 * BT).tolist()
PAIRS = [("tp2", "tp1", "tiny"), ("ep2", "tp2", "tiny-moe")]


@pytest.fixture(scope="module", params=PAIRS,
                ids=[f"{s}-to-{d}-{m}" for s, d, m in PAIRS])
def pair(request, tmp_path_factory):
    """A ``--kv-role prefill`` replica under the source plan and a
    ``decode`` one under the other, both live (four processes at most):
    the decode replica pulls :data:`TEXT`'s blocks through
    ``X-GPUStack-KV-Source`` and :data:`CHAT`'s chain through
    ``/kv/pull``."""
    src, dst, preset = request.param
    sentinel = str(tmp_path_factory.mktemp("pair") / "done")
    src_port = free_port()
    ids = load_tokenizer(None).encode(TEXT)
    got = {}

    def source():
        got["source"] = _run(src, preset, workers.serve_until,
                             (sentinel, CHAT, ids), {"kv_role": "prefill"},
                             http_port=src_port)

    thread = threading.Thread(target=source)
    thread.start()
    try:
        got["decode"] = _run(dst, preset, workers.pull_from,
                             (src_port, sentinel, TEXT, CHAT, NEW),
                             {"kv_role": "decode"})
    finally:
        if not os.path.exists(sentinel):
            open(sentinel, "w").close()
        thread.join(300)
    jeng = _jax_engine(preset)
    try:
        jids = _jax_greedy(jeng, ids)
    finally:
        jeng.stop()
    return dict(got, src=src, dst=dst, preset=preset, ids=ids, jids=jids,
                heads=_tree(preset)[2].num_kv_heads)


def test_handoff_across_plans_gives_the_jax_ids(pair):
    dec, srcd = pair["decode"], pair["source"]
    n = (len(pair["ids"]) - 1) // BT
    status, reply = dec["completion"]
    assert status == 200, reply
    assert dec["prompt_ids"] == pair["ids"]
    assert dec["handoff"]["pulls"] == 1 and not dec["handoff"]["failures"]
    assert dec["handoff"]["blocks_in"] >= n
    assert dec["reused_by_completion"] == n * BT
    assert dec["reused"] == n * BT
    assert dec["ids"] == pair["jids"]
    assert srcd["handoff"]["blocks_out"] >= n
    assert (srcd["role"], dec["role"]) == ("prefill", "decode")
    assert srcd["status"] == dec["status"] == "ok"


def test_handed_off_blocks_are_the_sources_at_each_decode_ranks_heads(
        pair):
    """The source ranks' blocks joined over heads, at each decode rank's
    heads, bit for bit (the prefetched prompt's blocks)."""
    dec, srcd = pair["decode"], pair["source"]
    for src_ranks, dec_ranks in zip(srcd["prompt_blocks"],
                                    dec["prompt_blocks"]):
        whole = _joined(src_ranks, pair["src"], pair["heads"])
        _check_slices(dec_ranks, pair["dst"], pair["heads"], whole)


def test_pull_by_tail_key_lands_on_every_rank(pair):
    import hashlib

    dec = pair["decode"]
    assert dec["pull"][0] == 202
    assert len(dec["chat_blocks"]) == len(CHAT) // BT
    digest = hashlib.sha256("".join(dec["leader_keys"]).encode()).hexdigest()
    for t in dec["tiers"]:
        assert t["keys_digest"] == digest
    coords = [rank_coords(MeshPlan.parse(pair["dst"]), r)
              for r in range(len(dec["tiers"]))]
    assert len(coords) == MeshPlan.parse(pair["dst"]).chips
