"""The engine's host KV tier on a card (marker ``gpu``; each test skips where
there is no CUDA card): the side-stream device→host store into pinned
buffers, the staged upload on a second stream, and a continuation prefill
from the uploaded prefix.

JAX-free like ``test_torch_kernels_gpu.py``: ``python -m pytest
--noconftest -m gpu tests/test_torch_engine_gpu.py``. The model is
``tiny`` widened to head_dim 64 (the flash kernel takes 64 and 128),
bf16, random weights on the card.
"""

import dataclasses

import pytest
import torch

from gpustack_tpu_torch.engine.engine import LLMEngine, _ChunkJob  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.models.config import get_config  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.models.transformer import init_params  # analysis: ignore[metrics-drift]


def _engine():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the engine's stream paths run only there")
    cfg = dataclasses.replace(
        get_config("tiny"), head_dim=64, dtype="bfloat16",
        max_position_embeddings=512,
    )
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, gen, dtype=torch.bfloat16, device="cuda")
    return LLMEngine(
        cfg, params, max_slots=2, max_seq_len=512, device="cuda",
        prefill_chunk=64, host_kv_cache_mb=64, kv_block_tokens=32,
    )


def _drain(eng):
    eng._kv_copy_pool.submit(lambda: None).result(timeout=60)
    eng._check_kv_copies()


@pytest.mark.gpu
def test_store_gather_upload_keep_the_bits():
    """A prefill's K/V stored through the copy stream, gathered from host
    RAM and uploaded through the upload stream come back bit for bit."""
    eng = _engine()
    try:
        ids = list(range(1, 201))
        with torch.no_grad():
            _, k, v = eng.runner.prefill(ids + [0] * 56, 200)
        eng._submit_kv_copy(ids, k, v, 200)
        _drain(eng)
        assert eng.host_kv_cache.entries == 200 // 32
        pk, pv = eng.host_kv_cache.gather_prefix(ids, 192)
        uk, uv, event = eng._upload_prefix(pk, pv, 192)
        torch.cuda.current_stream().wait_event(event)
        assert uk.shape[1] == eng.runner.bucket_for(192)
        assert torch.equal(uk[:, :192], k[:, :192])
        assert torch.equal(uv[:, :192], v[:, :192])
        assert not uk[:, 192:].any()
    finally:
        eng.stop()


@pytest.mark.gpu
def test_continuation_from_uploaded_prefix_matches_one_prefill():
    """The served continuation path on the card: a prefix that went
    device→host→device, then the suffix at ``q_offset`` = 192 through the
    flash kernel; its last logits against one prefill of the prompt (the
    smoke's bound: 5% of the logit scale, cosine 0.999)."""
    eng = _engine()
    try:
        r = eng.runner
        ids = [1 + (7 * i) % 250 for i in range(230)]
        with torch.no_grad():
            full, k, v = r.prefill(ids + [0] * 26, 230)
            eng._submit_kv_copy(ids, k, v, 230)
            _drain(eng)
            pk, pv = eng.host_kv_cache.gather_prefix(ids, 192)
            uk, uv, event = eng._upload_prefix(pk, pv, 192)
            job = _ChunkJob(req=None, ids=ids)
            eng._adopt_prefix(job, (uk, uv, 192, event))
            suffix = ids[192:] + [0] * (64 - 38)
            last, _, _ = r.prefill_with_prefix(
                job.k, job.v, 192, suffix, 38, r.bucket_for(192 + 64)
            )
        scale = full.abs().max().item()
        err = (last - full).abs().max().item()
        cos = torch.nn.functional.cosine_similarity(last, full, dim=0).item()
        assert err <= 5e-2 * scale and cos >= 0.999, (err, scale, cos)
    finally:
        eng.stop()
