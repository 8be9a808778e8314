"""The port's sharding rules (``parallel/sharding.py``, ``quant_spec`` /
``quant_pspecs`` in ``models/quant.py``) against the JAX package's
``SpecLayout``: the rule table, every spec and ``describe()`` (inference
and train, long-context or not), the spec trees of dense, MoE and MLA
trees, the int8 adaptation, and each rank's shard of every leaf, bf16 and
``QuantW``, against the matching ``addressable_shards`` entry of JAX's
placement on the 8-device CPU mesh (``shard_params``; ``QuantW`` leaves
as the JAX runner places them). ``tiny`` at ``tp4`` has 2 KV heads: there
the port keeps each rank's whole KV head (``wk``, ``wv``), where JAX's
spec cuts inside it, and every other leaf matches. JAX's ``quant_pspecs``
adapts ``layers`` only (its gap: an int8 DeepSeek tree cannot be placed);
the port's covers ``dense_layers``, held here to JAX's adaptation of the
same leaves under the ``layers`` key."""

import dataclasses
import importlib.util
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from gpustack_tpu.models import quant as jq
from gpustack_tpu.models import transformer as jt
from gpustack_tpu.models.config import PRESETS as JAX_PRESETS
from gpustack_tpu.parallel import mesh as jm
from gpustack_tpu.parallel import sharding as js
from gpustack_tpu_torch.engine.weights import params_from_numpy  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.models import quant as pq  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.models.quant import QuantW  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.parallel import mesh as pm  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.parallel import sharding as ps  # analysis: ignore[metrics-drift]

LAYOUTS = [dict(), dict(train=True), dict(long_context=True),
           dict(train=True, long_context=True)]


@pytest.mark.parametrize("kw", LAYOUTS)
def test_rules_and_specs_match_jax(kw):
    got, want = ps.SpecLayout(**kw), js.SpecLayout(**kw)
    assert got.fsdp_axis == want.fsdp_axis
    g_rules, w_rules = got.layer_rules(), want.layer_rules()
    assert list(g_rules) == list(w_rules)
    for name in w_rules:
        assert str(g_rules[name]) == str(w_rules[name]), name
        assert tuple(g_rules[name]) == tuple(w_rules[name]), name
    for fn in ("embed", "lm_head", "cache", "slot_state", "replicated"):
        assert str(getattr(got, fn)()) == str(getattr(want, fn)()), fn
    for seq in (False, True):
        assert str(got.activations(seq)) == str(want.activations(seq))
    assert got.describe() == want.describe()


def _load(name):
    path = os.path.join(os.path.dirname(__file__), f"test_torch_{name}.py")
    spec = importlib.util.spec_from_file_location(f"_sh_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MLA = _load("mla")


def _tree(name):
    """(port cfg, JAX cfg, JAX tree in fp32) of a tiny config."""
    if name == "mla":
        cfg, jcfg = MLA._cfgs(MLA._hf())
    else:
        from gpustack_tpu_torch.models.config import get_config  # analysis: ignore[metrics-drift]

        cfg = dataclasses.replace(get_config(name), dtype="float32")
        jcfg = dataclasses.replace(JAX_PRESETS[name], dtype="float32")
    jparams = jt.init_params(jcfg, jax.random.key(0), dtype=jnp.float32)
    return cfg, jcfg, jparams


@pytest.mark.parametrize("name", ["tiny", "tiny-moe", "mla"])
def test_param_spec_trees_match_jax(name):
    _, _, jparams = _tree(name)
    got = ps.SpecLayout().params(jparams)
    want = js.SpecLayout().params(jparams)
    assert jax.tree.map(str, got, is_leaf=lambda x: isinstance(x, tuple)) \
        == jax.tree.map(str, want, is_leaf=lambda x: isinstance(
            x, js.P))


def _view(plan, rank):
    """A rank's place in a plan, for ``shard_leaf`` (no process group)."""
    return types.SimpleNamespace(plan=plan, coords=pm.rank_coords(plan, rank),
                                 world=plan.chips)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _np(t):
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _jax_place(jparams, mesh):
    """JAX's placement of a (possibly int8) tree: ``shard_params`` specs,
    ``QuantW`` leaves adapted as the JAX runner adapts them; a
    ``dense_layers`` stack's int8 leaves adapted under the ``layers`` key,
    which is all JAX's ``quant_pspecs`` reads."""
    specs = js.param_pspecs(jparams)
    if any(isinstance(x, jq.QuantW) for x in jax.tree.leaves(
            jparams, is_leaf=lambda x: isinstance(x, jq.QuantW))):
        adapted = jq.quant_pspecs(specs, jparams)
        if "dense_layers" in jparams:
            adapted["dense_layers"] = jq.quant_pspecs(
                {"layers": specs["dense_layers"]},
                {"layers": jparams["dense_layers"]})["layers"]
        specs = adapted

    def put(x, spec):
        if isinstance(x, jq.QuantW):
            return jq.QuantW(
                q=jax.device_put(x.q, NamedSharding(mesh, spec.q)),
                s=jax.device_put(x.s, NamedSharding(mesh, spec.s)))
        return jax.device_put(x, NamedSharding(mesh, spec))

    return jax.tree.map(put, jparams, specs,
                        is_leaf=lambda x: isinstance(x, (jq.QuantW, js.P)))


def _shard_on(arr, device_id):
    for sh in arr.addressable_shards:
        if sh.device.id == device_id:
            return np.asarray(sh.data, np.float32)
    raise AssertionError(f"no shard on device {device_id}")


SHARD_CASES = [
    ("tiny", "tp2"), ("tiny", "tp4"), ("tiny-moe", "ep2xtp2"),
    ("tiny-moe", "ep4"), ("tiny-moe", "tp2"), ("mla", "tp2"),
]


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("name,plan", SHARD_CASES)
def test_every_shard_matches_jax_addressable_shard(name, plan, int8):
    cfg, _, jparams = _tree(name)
    jparams = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jparams)
    if int8:
        jparams = jq.quantize_params(jparams)
    jplan = jm.MeshPlan.parse(plan)
    placed = _jax_place(jparams, jm.make_mesh(jplan))
    host = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    whole_head = jplan.tp > cfg.num_kv_heads
    pplan = pm.MeshPlan.parse(plan)
    checked = 0
    for rank in range(jplan.chips):
        mine = dict(_leaves(ps.shard_params(
            host, _view(pplan, rank), kv_heads=cfg.num_kv_heads)))
        for path, leaf in _leaves(jax.tree.map(
                lambda x: x, placed,
                is_leaf=lambda x: isinstance(x, jq.QuantW))):
            got = mine[path]
            if isinstance(leaf, jq.QuantW):
                assert isinstance(got, QuantW), path
                pairs = [(got.q, leaf.q), (got.s, leaf.s)]
            else:
                pairs = [(got, leaf)]
            if whole_head and path.split("/")[-1] in ps.KV_HEAD_LEAVES:
                continue
            for g, w in pairs:
                np.testing.assert_array_equal(_np(g), _shard_on(w, rank),
                                              err_msg=path)
                checked += 1
    assert checked


def test_whole_kv_head_above_the_kv_head_count():
    """``tp4`` over 2 KV heads: ranks 0, 1 keep head 0, ranks 2, 3 head 1,
    whole; a query head's rank holds the KV head it reads."""
    cfg, _, jparams = _tree("tiny")
    host = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    wk = host["layers"]["wk"]
    hd = cfg.head_dim
    plan = pm.MeshPlan(tp=4)
    for rank in range(4):
        got = ps.shard_leaf("wk", wk, _view(plan, rank), kv_heads=2)
        head = rank // 2
        torch.testing.assert_close(got, wk[..., head * hd:(head + 1) * hd],
                                   rtol=0, atol=0)


def test_quant_pspecs_cover_dense_layers():
    cfg, _, jparams = _tree("mla")
    jparams = jq.quantize_params(jax.tree.map(
        lambda a: a.astype(jnp.bfloat16), jparams))
    host = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    specs = pq.quant_pspecs(ps.SpecLayout().params(host), host)
    want = jq.quant_pspecs(js.param_pspecs(jparams), jparams)
    for k in host["layers"]:
        g, w = specs["layers"][k], want["layers"][k]
        if isinstance(g, QuantW):
            assert (str(g.q), str(g.s)) == (str(w.q), str(w.s)), k
        else:
            assert str(g) == str(w), k
    dense = specs["dense_layers"]
    assert str(dense["wo"].q) == "PartitionSpec(None, 'tp', None)"
    assert str(dense["wo"].s) == "PartitionSpec(None, None)"
    assert str(dense["w_gate"].s) == "PartitionSpec(None, 'tp')"
    assert str(want["dense_layers"]["wo"]) == "PartitionSpec(None, 'tp', None)"
