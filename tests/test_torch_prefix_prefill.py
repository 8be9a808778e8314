"""Continuation prefill of the PyTorch port against the JAX runner.

``ModelRunner.prefill_with_prefix`` seeds a scratch cache with a prefix's
K/V and runs the suffix at positions ``prefix_len + j``; on the card its
attention is the flash kernel at ``q_offset = prefix_len``. Here both
runners serve ``tiny`` in float32 from one JAX init (weights carried
across through numpy); the port runs each case through the plain
attention and through the flash wrapper (its plain version on the CPU,
with the same ``q_offset`` the kernel gets on the card).

Tolerance: last-position logits and the K/V rows of the true token range
within rtol = atol = 1e-4 (float32 on both sides; two frameworks'
summation orders on O(1) values).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpustack_tpu.engine.runner import ModelRunner as JaxRunner
from gpustack_tpu.models import init_params
from gpustack_tpu.models.config import get_config as jax_get_config
from gpustack_tpu_torch.engine.runner import ModelRunner  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.weights import params_from_numpy  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.models.config import get_config  # analysis: ignore[metrics-drift]

TOL = dict(rtol=1e-4, atol=1e-4)
MAX_SEQ = 256


@pytest.fixture(scope="module")
def runners():
    jcfg = dataclasses.replace(jax_get_config("tiny"), dtype="float32")
    jparams = init_params(jcfg, jax.random.key(0), dtype=jnp.float32)
    cfg = dataclasses.replace(get_config("tiny"), dtype="float32")
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    jr = JaxRunner(jcfg, jparams, max_slots=2, max_seq_len=MAX_SEQ)
    tr = ModelRunner(
        cfg, tparams, torch.device("cpu"), max_slots=2, max_seq_len=MAX_SEQ
    )
    assert tr.prefill_buckets == jr.prefill_buckets
    return jr, tr


def _ids(n, seed):
    return np.random.default_rng(seed).integers(1, 256, n).tolist()


def _padded(runner, ids):
    b = runner.bucket_for(len(ids))
    return list(ids) + [0] * (b - len(ids))


@pytest.fixture(params=["plain", "flash"])
def port_runner(request, runners, monkeypatch):
    jr, tr = runners
    monkeypatch.setattr(tr, "attn_impl_for", lambda bucket: request.param)
    return jr, tr


# (prefix tokens, suffix tokens): a bucket-aligned prefix, a ragged one
# (pad rows inside the prefix width), a suffix bucket that reaches past the
# prefix bucket, and the longest that fits the top bucket
CASES = [(64, 20), (48, 7), (80, 40), (192, 50)]


@pytest.mark.parametrize("plen,slen", CASES)
def test_prefill_with_prefix_matches_jax_and_full_prefill(
    port_runner, plen, slen
):
    jr, tr = port_runner
    ids = _ids(plen + slen, seed=plen)
    prefix, suffix = ids[:plen], ids[plen:]
    sb = tr.bucket_for(len(suffix))
    total = tr.bucket_for(plen + sb)
    # the prefix's own K/V from the port's prefill (bucket-wide, pad rows
    # above plen included, as the engine's chunk jobs carry them)
    _, pk, pv = tr.prefill(_padded(tr, prefix), plen)
    suffix_padded = list(suffix) + [0] * (sb - len(suffix))
    last, k, v = tr.prefill_with_prefix(
        pk, pv, plen, suffix_padded, len(suffix), total
    )
    assert k.shape[1] == total
    jlast, jk, jv = jr.prefill_with_prefix(
        pk.numpy(), pv.numpy(), plen, suffix_padded, len(suffix), total
    )
    n = plen + slen
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), **TOL)
    np.testing.assert_allclose(k[:, :n].numpy(), np.asarray(jk)[:, :n], **TOL)
    np.testing.assert_allclose(v[:, :n].numpy(), np.asarray(jv)[:, :n], **TOL)
    # and against one prefill of the whole prompt
    flast, fk, fv = tr.prefill(_padded(tr, ids), n)
    np.testing.assert_allclose(last.numpy(), flast.numpy(), **TOL)
    np.testing.assert_allclose(k[:, :n].numpy(), fk[:, :n].numpy(), **TOL)
    np.testing.assert_allclose(v[:, :n].numpy(), fv[:, :n].numpy(), **TOL)


def test_chained_chunks_match_one_prefill(port_runner):
    """Four chunks of 32 (the last partial), each a continuation of the
    ones before at ``q_offset`` = its start, as the engine's chunk jobs
    run them: the last chunk's logits and the whole K/V equal one
    prefill's."""
    _, tr = port_runner
    ids = _ids(110, seed=5)
    chunk = 32
    last = k = v = None
    for start in range(0, len(ids), chunk):
        part = ids[start : start + chunk]
        sb = tr.bucket_for(len(part))
        padded = list(part) + [0] * (sb - len(part))
        if start == 0:
            last, k, v = tr.prefill(padded, len(part))
        else:
            last, k, v = tr.prefill_with_prefix(
                k, v, start, padded, len(part), tr.bucket_for(start + sb)
            )
    flast, fk, fv = tr.prefill(_padded(tr, ids), len(ids))
    np.testing.assert_allclose(last.numpy(), flast.numpy(), **TOL)
    n = len(ids)
    np.testing.assert_allclose(k[:, :n].numpy(), fk[:, :n].numpy(), **TOL)
    np.testing.assert_allclose(v[:, :n].numpy(), fv[:, :n].numpy(), **TOL)


@pytest.mark.parametrize("plen,sb,total", [
    (64, 64, 64),     # suffix block past the total width
    (0, 32, 64),      # no prefix
    (128, 32, 64),    # prefix wider than the total
])
def test_prefill_with_prefix_refuses_what_does_not_fit(runners, plen, sb,
                                                      total):
    """The engine trims a match until the suffix block fits; a call that
    still overflows raises instead of writing past the scratch cache."""
    _, tr = runners
    width = max(plen, 32)
    pk = torch.zeros(2, width, 2, 16)
    with pytest.raises(ValueError):
        tr.prefill_with_prefix(pk, pk, plen, [1] * sb, 1, total)


def test_insert_takes_a_continuation_wide_prefill(runners):
    """A continuation's K/V are ``total_bucket`` wide; insert copies them
    into the slot's rows and activates the slot at the true length."""
    _, tr = runners
    ids = _ids(70, seed=9)
    _, pk, pv = tr.prefill(_padded(tr, ids[:64]), 64)
    last, k, v = tr.prefill_with_prefix(
        pk, pv, 64, list(ids[64:]) + [0] * 26, 6, 128
    )
    state = tr.new_state()
    state = tr.insert(state, k, v, 1, len(ids), 5, 0.0, 0, 1.0)
    torch.testing.assert_close(state.cache.k[:, 1, :128], k)
    assert int(state.positions[1]) == len(ids)
    assert bool(state.active[1]) and not bool(state.active[0])
