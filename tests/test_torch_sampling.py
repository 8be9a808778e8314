"""Sampler of the PyTorch port against the JAX ``sample``.

Logits come from numpy with a seed and go to both sides. Greedy tokens,
``token_logprob``, ``top_ids`` and ``top_logprobs`` must agree (logprobs
to 1e-5: fp32 logsumexp in two summation orders). The Gumbel noise for
temperature > 0 differs by design (counter hash on the port, threefry in
JAX), so sampled tokens are checked for seeded self-determinism, the
top-k/top-p support and the distribution instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpustack_tpu.engine import sampling as js
from gpustack_tpu.engine.runner import bias_arrays
from gpustack_tpu_torch.engine import sampling as ts  # analysis: ignore[metrics-drift]

B, V = 4, 300


def _logits(seed=0, b=B, v=V):
    return np.random.default_rng(seed).standard_normal((b, v)).astype(
        np.float32
    ) * 3.0


def _states(temperature=0.0, top_k=0, top_p=1.0, bias=None, seeds=None):
    jst = js.SamplingState.create(B)
    tst = ts.SamplingState.create(B, "cpu")
    for row in range(B):
        seed = 0 if seeds is None else seeds[row]
        ids, vals = bias_arrays((bias or {}).get(row))
        jst = jst.set_slot(
            row, temperature, top_k, top_p, seed, seeds is not None,
            ids, vals,
        )
        tst.set_slot(
            row, temperature, top_k, top_p, seed, seeds is not None,
            (bias or {}).get(row),
        )
    return jst, tst


def _compare(logits, jst, tst):
    jt_out = js.sample(jnp.asarray(logits), jst, jax.random.key(0),
                       jnp.zeros((B,), jnp.int32))
    tt_out = ts.sample(torch.from_numpy(logits), tst, key=0)
    np.testing.assert_array_equal(tt_out[0].numpy(), np.asarray(jt_out[0]))
    np.testing.assert_allclose(
        tt_out[1].numpy(), np.asarray(jt_out[1]), rtol=1e-5, atol=1e-5
    )
    np.testing.assert_array_equal(tt_out[2].numpy(), np.asarray(jt_out[2]))
    np.testing.assert_allclose(
        tt_out[3].numpy(), np.asarray(jt_out[3]), rtol=1e-5, atol=1e-5
    )
    return tt_out


def test_greedy_and_logprobs_match_jax():
    jst, tst = _states()
    tokens, _, top_ids, _ = _compare(_logits(), jst, tst)
    assert top_ids.shape == (B, ts.TOPLP)
    assert tokens.tolist() == np.argmax(_logits(), axis=-1).tolist()


def test_logit_bias_matches_jax():
    """A +100 bias promotes a token from outside the top-64 window; a -100
    bias bans the argmax: both applied before ranking, as in JAX."""
    logits = _logits(1)
    low = int(np.argmin(logits[0]))
    top = int(np.argmax(logits[1]))
    jst, tst = _states(bias={0: {low: 100.0}, 1: {top: -100.0}})
    tokens, *_ = _compare(logits, jst, tst)
    assert tokens[0] == low
    assert tokens[1] != top


def test_seeded_rows_replay_and_unseeded_rows_diverge():
    logits = torch.from_numpy(np.tile(_logits(2, 1, V), (B, 1)))
    _, seeded = _states(temperature=1.0, seeds=[7, 7, 7, 7])
    pos = torch.full((B,), 5)
    a = ts.sample(logits, seeded, key=1, positions=pos)[0]
    b = ts.sample(logits, seeded, key=2, positions=pos)[0]
    assert torch.equal(a, b)                     # seed, not step key
    assert len(set(a.tolist())) == 1             # same seed, same stream
    _, unseeded = _states(temperature=1.0)
    draws = [
        tuple(ts.sample(logits, unseeded, key=k)[0].tolist())
        for k in range(8)
    ]
    assert len(set(draws)) > 1                   # step keys matter
    assert any(len(set(d)) > 1 for d in draws)   # rows of one step differ


@pytest.mark.parametrize("top_k,top_p", [(1, 1.0), (0, 1e-6)])
def test_top1_filters_equal_greedy(top_k, top_p):
    logits = _logits(3)
    _, tst = _states(temperature=0.9, top_k=top_k, top_p=top_p)
    for key in range(5):
        got = ts.sample(torch.from_numpy(logits), tst, key=key)[0]
        assert got.tolist() == np.argmax(logits, axis=-1).tolist()


def test_top_k_support():
    logits = _logits(4)
    _, tst = _states(temperature=2.0, top_k=5)
    allowed = np.argsort(-logits, axis=-1)[:, :5]
    for key in range(20):
        got = ts.sample(torch.from_numpy(logits), tst, key=key)[0].numpy()
        for row in range(B):
            assert got[row] in allowed[row]


def test_sampled_distribution_matches_softmax():
    """4096 unseeded rows over one 8-way distribution: empirical
    frequencies within 0.03 of softmax (about 4 standard errors)."""
    n, v = 4096, 8
    logits = torch.tensor(
        [[1.0, 0.5, 0.0, -0.5, -1.0, 0.2, 0.8, -2.0]]
    ).repeat(n, 1)
    st = ts.SamplingState.create(n, "cpu")
    st.temperature.fill_(1.0)
    toks = ts.sample(logits, st, key=11)[0]
    freq = torch.bincount(toks, minlength=v).float() / n
    probs = torch.softmax(logits[0], dim=0)
    assert torch.max(torch.abs(freq - probs)) < 0.03


def test_gumbel_noise_is_deterministic_and_standard():
    streams = torch.arange(64, dtype=torch.int64)
    pos = torch.zeros(64, dtype=torch.int64)
    a = ts.gumbel_noise(streams, pos, 64)
    assert torch.equal(a, ts.gumbel_noise(streams, pos, 64))
    # standard Gumbel: mean = Euler-Mascheroni 0.5772, var = pi^2/6
    assert abs(a.mean().item() - 0.5772) < 0.05
    assert abs(a.var().item() - 1.6449) < 0.1
