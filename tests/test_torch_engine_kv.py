"""The PyTorch engine's prompt path against the JAX ``LLMEngine``: chunked
prefill, prefix reuse through the host KV cache (fp and int8 tiers) and
the disk spill tier.

Both engines serve ``tiny`` in float32 from one JAX init (weights carried
across through numpy) with the byte tokenizer, and the same script of
requests: a prompt, an extension of it (a prefix hit), the extension
again, and a second conversation turn that repeats the first turn's
prompt and reply (a hit on the blocks the first turn decoded). Between
requests each engine's kv-copy thread is drained, so the stores have
landed before the next probe. Greedy ``output_ids``, each request's
``prefix_tokens_reused`` and the cache counters in ``health()`` must be
identical (the JAX engine at pipeline depth 0, the port at 0 and 2).

The tests after the parity ones mirror ``tests/engine/
test_chunked_prefill.py`` and the engine tests of
``tests/engine/test_kv_host_cache.py`` on the port, against its own
cacheless greedy oracle (``greedy_reference``, itself held to the JAX
``forward`` in test_torch_transformer.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpustack_tpu.engine.engine import GenRequest as JaxGenRequest
from gpustack_tpu.engine.engine import LLMEngine as JaxLLMEngine
from gpustack_tpu.models import init_params
from gpustack_tpu.models.config import get_config as jax_get_config
from gpustack_tpu_torch.engine.engine import GenRequest, LLMEngine  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.runner import greedy_reference  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.weights import params_from_numpy  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.models.config import get_config  # analysis: ignore[metrics-drift]

MAX_TOKENS = 5
BLOCK = 16
BLOCK_BYTES = 2 * 2 * BLOCK * 2 * 16 * 4   # k+v, L 2, Hkv 2, d 16, fp32
COUNTERS = (
    "kv_cache_hits", "kv_cache_misses", "kv_cache_prefix_hits",
    "kv_cache_prefix_tokens_reused", "kv_cache_blocks", "kv_faultbacks",
)


def _ids(n, seed):
    return np.random.default_rng(seed).integers(1, 264, n).tolist()


BASE = _ids(60, 13)
EXT = BASE + _ids(50, 14)
TURN1 = _ids(44, 0)
USER2 = _ids(10, 1)
# each entry builds a prompt from the outputs so far
SCRIPT = [
    lambda outs: BASE,
    lambda outs: EXT,
    lambda outs: EXT,
    lambda outs: TURN1,
    lambda outs: TURN1 + outs[3] + USER2,
    lambda outs: _ids(100, 2),
    lambda outs: EXT + [5],      # its tail blocks spilled by now
]

CONFIGS = {
    "chunk": dict(prefill_chunk=32),
    "cache": dict(host_kv_cache_mb=64, kv_block_tokens=BLOCK),
    "chunk+cache": dict(
        prefill_chunk=32, host_kv_cache_mb=64, kv_block_tokens=BLOCK
    ),
    "int8": dict(
        prefill_chunk=32, host_kv_cache_mb=64, kv_block_tokens=BLOCK,
        kv_cache_int8=True,
    ),
    # RAM for 6 blocks, the rest spills to disk and faults back
    "spill": dict(
        host_kv_cache_mb=64, kv_block_tokens=BLOCK, kv_spill_mb=8,
    ),
}


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jax_get_config("tiny"), dtype="float32")
    jparams = init_params(jcfg, jax.random.key(0), dtype=jnp.float32)
    cfg = dataclasses.replace(get_config("tiny"), dtype="float32")
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, cfg, tparams


def _drain_copies(eng):
    """Block until every store queued on the kv-copy thread landed (the
    thread runs its queue in order)."""
    if eng._kv_copy_pool is not None:
        eng._kv_copy_pool.submit(lambda: None).result(timeout=60)


def _serve(eng, gen_cls, tmp_dir=None):
    if tmp_dir is not None:
        eng.host_kv_cache.max_bytes = 6 * BLOCK_BYTES
    eng.start()
    try:
        outs, reused = [], []
        for build in SCRIPT:
            req = eng.generate(gen_cls(
                prompt_ids=build(outs), max_tokens=MAX_TOKENS,
                temperature=0.0,
            ), timeout=300)
            _drain_copies(eng)
            outs.append(req.output_ids)
            reused.append(req.prefix_tokens_reused)
        h = eng.health()
        return outs, reused, {c: h[c] for c in COUNTERS}
    finally:
        eng.stop()


def _kw(name, tmp_path, side):
    kw = dict(CONFIGS[name])
    if "kv_spill_mb" in kw:
        kw["kv_spill_dir"] = str(tmp_path / f"spill-{side}")
    return kw


@pytest.fixture(scope="module")
def jax_runs(models, tmp_path_factory):
    jcfg, jparams, _, _ = models
    runs = {}
    for name in CONFIGS:
        tmp = tmp_path_factory.mktemp(name.replace("+", "_"))
        eng = JaxLLMEngine(
            jcfg, jparams, max_slots=2, max_seq_len=256, pipeline_depth=0,
            **_kw(name, tmp, "jax"),
        )
        runs[name] = _serve(
            eng, JaxGenRequest, tmp if "kv_spill_mb" in CONFIGS[name] else None
        )
    return runs


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_prompt_path_matches_jax_engine(models, jax_runs, tmp_path, name,
                                        depth):
    _, _, cfg, tparams = models
    eng = LLMEngine(
        cfg, tparams, max_slots=2, max_seq_len=256, pipeline_depth=depth,
        device="cpu", **_kw(name, tmp_path, "port"),
    )
    got = _serve(
        eng, GenRequest, tmp_path if "kv_spill_mb" in CONFIGS[name] else None
    )
    want = jax_runs[name]
    assert got[0] == want[0]            # greedy output_ids
    assert got[1] == want[1]            # prefix tokens reused per request
    assert got[2] == want[2]            # cache counters
    if "host_kv_cache_mb" in CONFIGS[name]:
        # the script hits: the extension, its repeat, and turn 2
        assert got[1][1] >= 48 and got[1][2] >= 96
        assert got[1][4] > len(TURN1)
    if name == "spill":
        assert got[2]["kv_faultbacks"] > 0


def test_flags_once_refused_are_accepted(models, tmp_path):
    _, _, cfg, tparams = models
    eng = LLMEngine(
        cfg, tparams, device="cpu", max_seq_len=256, prefill_chunk=40,
        host_kv_cache_mb=8, kv_block_tokens=32, kv_cache_int8=True,
        kv_spill_mb=4, kv_spill_dir=str(tmp_path / "s"),
    )
    try:
        assert eng.prefill_chunk == 64          # snapped up to a bucket
        assert eng.host_kv_cache.block_tokens == 32
        assert eng.host_kv_cache.int8
        assert eng.host_kv_cache.spill.directory == str(tmp_path / "s")
    finally:
        eng.stop()


# ---------------------------------------------------------------------------
# chunked prefill (mirrors tests/engine/test_chunked_prefill.py)
# ---------------------------------------------------------------------------


def _oracle(tparams, cfg, prompt, n):
    return greedy_reference(tparams, cfg, prompt, n, torch.device("cpu"))


def _gen(eng, prompt, n=4):
    return eng.generate(
        GenRequest(prompt_ids=list(prompt), max_tokens=n, temperature=0.0),
        timeout=120,
    )


def test_chunked_prefill_interleaves_decode(models):
    """While a long prompt prefills chunk by chunk, a running request keeps
    producing tokens between chunks; the flight recorder logs one
    ``prefill_chunk`` step per chunk."""
    _, _, cfg, tparams = models
    eng = LLMEngine(
        cfg, tparams, max_slots=2, max_seq_len=256, prefill_chunk=32,
        device="cpu",
    )
    short = GenRequest(prompt_ids=_ids(8, 1), max_tokens=64,
                       temperature=0.0)
    eng.submit(short)
    for _ in range(4):
        eng.step()
    assert eng._slots
    long = GenRequest(prompt_ids=_ids(180, 2), max_tokens=4,
                      temperature=0.0)
    eng.submit(long)
    eng.step()
    assert eng._chunk_jobs
    before = len(short.output_ids)
    steps = 0
    while eng._chunk_jobs:
        eng.step()
        steps += 1
        assert steps < 50
    assert steps >= 3
    eng._drain_pending()
    assert len(short.output_ids) > before
    while not long.done.is_set():
        if not eng.step():
            eng._drain_pending()
    assert long.output_ids == _oracle(tparams, cfg, long.prompt_ids, 4)
    modes = [r["mode"] for r in eng.flight.snapshot(limit=2048)]
    assert modes.count("prefill_chunk") == 6        # ceil(180 / 32)
    real = [
        r["tokens_real"] for r in eng.flight.snapshot(limit=2048)
        if r["mode"] == "prefill_chunk"
    ]
    assert sum(real) >= 180 - 32   # the admitting step also decodes


def test_chunk_overflow_falls_back_to_one_shot(models):
    """Buckets 32..128,150: a 140-token prompt in 64-token chunks would
    write its last continuation at 128 + 32 > 150, so it runs one-shot."""
    _, _, cfg, tparams = models
    eng = LLMEngine(cfg, tparams, max_slots=1, max_seq_len=150,
                    prefill_chunk=64, device="cpu")
    prompt = _ids(140, 11)
    eng.start()
    try:
        req = _gen(eng, prompt)
    finally:
        eng.stop()
    assert not eng._chunk_jobs
    assert req.output_ids == _oracle(tparams, cfg, prompt, 4)
    assert [r["mode"] for r in eng.flight.snapshot()][0] == "prefill"


def test_prefill_chunk_clamped_to_top_bucket(models):
    _, _, cfg, tparams = models
    eng = LLMEngine(cfg, tparams, max_slots=1, max_seq_len=128,
                    prefill_chunk=4096, device="cpu")
    assert eng.prefill_chunk == 128
    prompt = _ids(60, 9)
    eng.start()
    try:
        assert _gen(eng, prompt, 3).output_ids == _oracle(
            tparams, cfg, prompt, 3
        )
    finally:
        eng.stop()


def test_chunk_overflow_fallback_with_warm_cache(models):
    """A warm match whose chunked continuation cannot fit is trimmed block
    by block (or dropped); the output stays the cold run's."""
    _, _, cfg, tparams = models
    eng = LLMEngine(cfg, tparams, max_slots=1, max_seq_len=150,
                    prefill_chunk=64, host_kv_cache_mb=64,
                    kv_block_tokens=BLOCK, device="cpu")
    prompt = _ids(140, 23)
    eng.start()
    try:
        r1 = _gen(eng, prompt)
        _drain_copies(eng)
        r2 = _gen(eng, prompt)
    finally:
        eng.stop()
    assert not eng._chunk_jobs
    oracle = _oracle(tparams, cfg, prompt, 4)
    assert r1.output_ids == oracle and r2.output_ids == oracle


def test_prefix_hit_skips_matched_prefill_tokens(models):
    """With the cache warm, the engine prefills at most the unmatched tail
    and reports the upload."""
    _, _, cfg, tparams = models
    eng = LLMEngine(cfg, tparams, max_slots=1, max_seq_len=256,
                    host_kv_cache_mb=64, kv_block_tokens=BLOCK,
                    device="cpu")
    calls = []
    orig_full, orig_prefix = eng.runner.prefill, eng.runner.prefill_with_prefix

    def spy_full(ids, true_len):
        calls.append(("full", true_len))
        return orig_full(ids, true_len)

    def spy_prefix(pk, pv, plen, ids, true_len, tb):
        calls.append(("prefix", true_len))
        return orig_prefix(pk, pv, plen, ids, true_len, tb)

    eng.runner.prefill = spy_full
    eng.runner.prefill_with_prefix = spy_prefix
    prompt = _ids(80, 3)
    extended = prompt + _ids(20, 4)
    eng.start()
    try:
        _gen(eng, prompt)
        _drain_copies(eng)
        calls.clear()
        r = _gen(eng, extended)
    finally:
        eng.stop()
    assert r.prefix_tokens_reused == 80 and r.kv_upload_s > 0
    assert calls == [("prefix", 20)]
    assert r.output_ids == _oracle(tparams, cfg, extended, 4)


def test_chunked_prefix_hit_skips_matched_chunk_steps(models):
    _, _, cfg, tparams = models
    base = _ids(96, 5)
    extended = base + _ids(32, 6)
    eng = LLMEngine(cfg, tparams, max_slots=1, max_seq_len=256,
                    prefill_chunk=32, host_kv_cache_mb=64,
                    kv_block_tokens=BLOCK, device="cpu")

    def chunk_steps(prompt):
        req = GenRequest(prompt_ids=list(prompt), max_tokens=4,
                         temperature=0.0)
        eng.submit(req)
        eng.step()
        steps = 1
        while eng._chunk_jobs:
            eng.step()
            steps += 1
            assert steps < 50
        while not req.done.is_set():
            if not eng.step():
                eng._drain_pending()
        _drain_copies(eng)
        return steps, req

    cold, r_cold = chunk_steps(extended)
    chunk_steps(base)
    hot, r_hot = chunk_steps(extended)
    eng.stop()
    # the cold run stored the extension's own blocks too
    matched = r_hot.prefix_tokens_reused
    assert matched >= 96
    assert hot <= cold - matched // 32
    assert r_hot.output_ids == r_cold.output_ids


def test_aborted_chunk_job_frees_its_slot(models):
    _, _, cfg, tparams = models
    eng = LLMEngine(cfg, tparams, max_slots=1, max_seq_len=256,
                    prefill_chunk=32, device="cpu")
    req = GenRequest(prompt_ids=_ids(150, 8), max_tokens=4)
    eng.submit(req)
    eng.step()
    assert eng._chunk_jobs
    req.abort()
    eng.step()
    assert not eng._chunk_jobs and eng._free == [0]
    assert req.done.is_set() and req.finish_reason == "abort"


# ---------------------------------------------------------------------------
# errors stay visible; an evicted run cold-starts
# ---------------------------------------------------------------------------


def _cache_engine(models, **kw):
    _, _, cfg, tparams = models
    return LLMEngine(cfg, tparams, max_slots=1, max_seq_len=256,
                     host_kv_cache_mb=64, kv_block_tokens=BLOCK,
                     device="cpu", **kw)


def test_failed_kv_store_ends_the_engine(models):
    eng = _cache_engine(models)

    def broken(*a, **k):
        raise RuntimeError("device copy failed")

    eng.host_kv_cache.insert_sequence = broken
    eng.start()
    try:
        req = eng.submit(GenRequest(prompt_ids=_ids(40, 1), max_tokens=64))
        assert req.done.wait(30)
        eng._thread.join(timeout=30)
        assert not eng._thread.is_alive()       # the loop ended
        with pytest.raises(ValueError, match="engine is down"):
            eng.submit(GenRequest(prompt_ids=[1, 2], max_tokens=4))
    finally:
        eng.stop()
    h = eng.health()
    assert h["status"] == "error" and "device copy failed" in h["error"]


def test_failed_prefix_stage_ends_the_engine(models):
    eng = _cache_engine(models)
    prompt = _ids(40, 3)
    eng.start()
    try:
        _gen(eng, prompt)
        _drain_copies(eng)

        def broken(*a, **k):
            raise RuntimeError("upload failed")

        eng.host_kv_cache.gather_prefix = broken
        req = eng.generate(GenRequest(prompt_ids=prompt + [7, 8],
                                      max_tokens=4), timeout=60)
    finally:
        eng.stop()
    assert req.finish_reason == "error"
    assert "upload failed" in eng.health()["error"]


def test_evicted_prefix_cold_starts(models):
    _, _, cfg, tparams = models
    eng = _cache_engine(models)
    prompt = _ids(40, 4)
    eng.start()
    try:
        _gen(eng, prompt)
        _drain_copies(eng)
        eng.host_kv_cache.gather_prefix = lambda ids, n: None
        r = _gen(eng, prompt + [9, 10, 11])
    finally:
        eng.stop()
    h = eng.health()
    assert h["status"] == "ok" and h["kv_cache_hits"] == 1
    assert h["kv_cache_prefix_hits"] == 0 and r.prefix_tokens_reused == 0
    assert r.output_ids == _oracle(tparams, cfg, prompt + [9, 10, 11], 4)
