"""The DDIM sampler of the PyTorch port (``models/diffusion.sample_images``)
against the JAX package's jitted ``sample_images``: 3 steps, guidance 2.0,
B = 2, JAX's own noise draw injected, on ``tiny-diffusion``, the SDXL-style
config (two encoders, the additive embedding, the penultimate context)
and v-prediction; fp32 within 1e-4 of the images' scale, bf16 within 2%.
The schedule's timesteps and roots are JAX's arithmetic, bit for bit.
Shares its trees and helpers with ``test_torch_diffusion.py``.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch


def _load_parity_helpers():
    path = os.path.join(os.path.dirname(__file__), "test_torch_diffusion.py")
    spec = importlib.util.spec_from_file_location("_diffusion_parity", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


H = _load_parity_helpers()
jd, pd, model = H.jd, H.pd, H.model


@pytest.mark.parametrize("model", ["tiny", "sdxl", "vpred"], indirect=True)
@pytest.mark.parametrize("dtype", H.DTYPES)
def test_sample_images_with_jax_noise(model, dtype):
    name, jparams, params = model
    cfg, jcfg = H._config(pd, name, dtype), H._config(jd, name, dtype)
    B = 2
    cond, uncond = H._tokens(cfg, B, 10), H._tokens(cfg, B, 11)
    kw, tkw = {}, {}
    if cfg.text2_dim:
        c2, u2 = H._tokens(cfg, B, 12), H._tokens(cfg, B, 13)
        kw = {"cond_tokens2": jnp.asarray(c2),
              "uncond_tokens2": jnp.asarray(u2)}
        tkw = {"cond_tokens2": torch.from_numpy(c2).long(),
               "uncond_tokens2": torch.from_numpy(u2).long()}
    key = jax.random.key(3)
    want = jd.sample_images(jparams, jcfg, key, jnp.asarray(cond),
                            jnp.asarray(uncond), steps=3, guidance=2.0, **kw)
    s = cfg.latent_size
    noise = np.asarray(jax.random.normal(
        key, (B, s, s, cfg.latent_channels), jnp.float32))
    got = pd.sample_images(
        params, cfg, None, torch.from_numpy(cond).long(),
        torch.from_numpy(uncond).long(), steps=3, guidance=2.0,
        noise=H._nchw(noise), **tkw)
    assert got.shape == (B, cfg.image_size, cfg.image_size, 3)
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0
    H._close(got.numpy(), np.asarray(want), H.REL["model"][dtype])


def test_sample_images_draws_from_the_generator():
    cfg = pd.DIFFUSION_PRESETS["tiny-diffusion"]
    params = pd.init_diffusion_params(
        cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(H._tokens(cfg, 1, 14)).long()

    def sample(seed):
        return pd.sample_images(params, cfg, torch.Generator().manual_seed(
            seed), toks, torch.zeros_like(toks), steps=2)

    a, b, c = sample(7), sample(7), sample(8)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.dtype == torch.float32 and a.shape == (1, 32, 32, 3)


def test_ddim_schedule_is_jax_arithmetic():
    cfg = pd.DIFFUSION_PRESETS["sd15-shaped"]
    sched = pd.ddim_schedule(cfg, 30)
    acp = jnp.asarray(jd._alphas_cumprod(jd.DIFFUSION_PRESETS["sd15-shaped"]))
    ts = np.linspace(999, 0, 30, dtype=np.float64).round().astype(np.int32)
    assert [s[0] for s in sched] == ts.tolist()
    for i, (t, sa, s1a, sp, s1p) in enumerate(sched):
        assert sa == float(jnp.sqrt(acp[t]))
        assert s1a == float(jnp.sqrt(1.0 - acp[t]))
        a_prev = acp[ts[i + 1]] if i + 1 < len(ts) else jnp.float32(1.0)
        assert sp == float(jnp.sqrt(a_prev))
        assert s1p == float(jnp.sqrt(1.0 - a_prev))
    np.testing.assert_array_equal(pd._alphas_cumprod(cfg), np.asarray(acp))
