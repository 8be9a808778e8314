"""The port's mesh plans (``parallel/mesh.py``) against the JAX
package's: ``MeshPlan.parse``/``str``/``chips``/``axis_sizes`` and
``plan_mesh`` over a grid of device counts, KV heads, experts and
``long_context``, the refusals, and each rank's (dp, sp, ep, tp)
coordinates against the device's place in JAX's ``make_mesh``."""

import itertools

import numpy as np
import pytest

from gpustack_tpu.parallel import mesh as jm
from gpustack_tpu_torch.parallel import mesh as pm  # analysis: ignore[metrics-drift]

GRID = list(itertools.product(
    (1, 2, 4, 8), (1, 2, 4, 8, 16), (0, 4, 8, 64), (False, True)))


@pytest.mark.parametrize("n,kv,experts,long_context", GRID)
def test_plan_mesh_matches_jax(n, kv, experts, long_context):
    want = jm.plan_mesh(n, kv, experts, long_context)
    got = pm.plan_mesh(n, kv, experts, long_context)
    assert _sizes(got) == _sizes(want)
    assert str(got) == str(want)
    assert got.chips == want.chips == n
    assert got.axis_sizes() == want.axis_sizes()


def _sizes(plan):
    return (plan.dp, plan.sp, plan.ep, plan.tp)


@pytest.mark.parametrize("text", [
    "dp2xsp1xep1xtp4", "tp4", "tp4xdp2", "ep2xtp2", "EP4", "sp2xtp2",
])
def test_parse_and_str_match_jax(text):
    got, want = pm.MeshPlan.parse(text), jm.MeshPlan.parse(text)
    assert _sizes(got) == _sizes(want)
    assert str(got) == str(want)
    assert pm.MeshPlan.parse(str(got)) == got


@pytest.mark.parametrize("bad", ["tp", "xx2", "tp2xq4"])
def test_parse_refusals_match_jax(bad):
    for mod in (pm, jm):
        with pytest.raises(ValueError):
            mod.MeshPlan.parse(bad)


@pytest.mark.parametrize("n", [0, 3, 6, -2])
def test_plan_mesh_refusals_match_jax(n):
    for mod in (pm, jm):
        with pytest.raises(ValueError, match="power of two"):
            mod.plan_mesh(n, 8)


@pytest.mark.parametrize("plan", [
    "tp4", "ep2xtp2", "ep4", "dp2xtp2", "dp2xsp2xep2", "sp2xep2xtp2",
])
def test_rank_coordinates_match_jax_make_mesh(plan):
    """Rank r sits where JAX's ``make_mesh`` puts device r."""
    jplan = jm.MeshPlan.parse(plan)
    mesh = jm.make_mesh(jplan)
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    for rank in range(jplan.chips):
        where = dict(zip(jm.MESH_AXES,
                         (int(i[0]) for i in np.nonzero(ids == rank))))
        assert pm.rank_coords(pm.MeshPlan.parse(plan), rank) == where


def test_single_rank_mesh_needs_no_process_group():
    mesh = pm.Mesh(pm.MeshPlan())
    assert mesh.world == mesh.tp == mesh.moe_size == 1
    assert mesh.coords == {"dp": 0, "sp": 0, "ep": 0, "tp": 0}
    import torch

    x = torch.ones(3)
    assert mesh.all_reduce_tp(x) is x and mesh.all_gather_tp(x) is x
    with pytest.raises(RuntimeError, match="process group"):
        pm.Mesh(pm.MeshPlan(tp=2))
