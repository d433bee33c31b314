"""The port's logical-axis specs (``repro_torch.sharding``,
``models.model.logical_axes``, ``core.sharded``) against the
reference's on both production meshes, for every arch: the parameter
specs, the replica-stacked specs of the federated trainer and
``serve_specs``' cache specs, compared as axis names. The reference's
``resolve_specs`` reads only a mesh's ``axis_names`` and ``shape``, so
an abstract mesh serves both sides."""
import types

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import sharding as rsh
from repro.configs import get_model_config as rcfg
from repro.core import sharded as rsd
from repro_torch import sharding as tsh
from repro_torch import tree as tr
from repro_torch.configs import ARCHS
from repro_torch.configs import get_model_config as tcfg
from repro_torch.core import sharded as tsd
from repro_torch.launch import mesh as lm
from repro_torch.models import model as tm

MESHES = {"single_pod": False, "multi_pod": True}


def _ref_mesh(multi_pod: bool):
    m = lm.make_production_mesh(multi_pod=multi_pod)
    return types.SimpleNamespace(axis_names=m.axis_names, shape=m.shape)


def _names(spec, ndim: int) -> tuple:
    """A reference PartitionSpec as the port writes specs: one entry a
    dimension, ``"?"`` for unconstrained."""
    out = [tsh.UNCONSTRAINED if e is P.UNCONSTRAINED else e for e in spec]
    return tuple(out + [None] * (ndim - len(out)))


def _ref_specs(specs, shapes) -> list:
    leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
    return [_names(p, len(s.shape))
            for p, s in zip(leaves, jax.tree.leaves(shapes))]


@pytest.mark.parametrize("where", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_match_reference(arch, where):
    multi = MESHES[where]
    rshapes, rlogical = rsd.abstract_model(rcfg(arch))
    want = _ref_specs(rsh.resolve_specs(rshapes, rlogical,
                                        _ref_mesh(multi)), rshapes)
    cfg = tcfg(arch)
    got = tsh.spec_leaves(tsh.resolve_specs(
        tsd.abstract_model(cfg), tm.logical_axes(cfg),
        lm.make_production_mesh(multi_pod=multi)))
    assert got == want
    # the logical names themselves, leaf for leaf
    assert tsh.spec_leaves(tm.logical_axes(cfg)) == [
        tuple(x) for x in jax.tree.leaves(
            rlogical, is_leaf=lambda x: isinstance(x, tuple) and all(
                isinstance(e, (str, type(None))) for e in x))]


@pytest.mark.parametrize("where", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_stacked_specs_match_reference(arch, where):
    """The federated trainer's replica-stacked specs (16 or 32
    replicas on the replica axes, the model axis within)."""
    multi = MESHES[where]
    R = 32 if multi else 16
    rshapes, rlogical = rsd.stacked_abstract(rcfg(arch), R)
    want = _ref_specs(rsh.resolve_specs(rshapes, rlogical,
                                        _ref_mesh(multi)), rshapes)
    cfg = tcfg(arch)
    got = tsh.spec_leaves(tsh.resolve_specs(
        tsd.stacked_abstract(cfg, R), tsd.stacked_logical(cfg),
        lm.make_production_mesh(multi_pod=multi)))
    assert got == want
    replica = ("pod", "data") if multi else "data"
    assert all(s[0] == replica for s in got)


@pytest.mark.parametrize("batch", [32, 4])
@pytest.mark.parametrize("where", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_serve_specs_match_reference(arch, where, batch):
    """Param and decode-cache specs of ``serve_specs``; batch 4 does not
    divide the data axis, so the cache's kv sequence goes there."""
    multi = MESHES[where]
    rshapes, rp, rcshapes, rc = rsd.serve_specs(
        rcfg(arch), _ref_mesh(multi), batch, 64)
    shapes, pspecs, cshapes, cspecs = tsd.serve_specs(
        tcfg(arch), lm.make_production_mesh(multi_pod=multi), batch, 64)
    assert tsh.spec_leaves(pspecs) == _ref_specs(rp, rshapes)
    assert tsh.spec_leaves(cspecs) == _ref_specs(rc, rcshapes)
    assert [tuple(t.shape) for t in tr.tree_leaves(cshapes)] == \
        [s.shape for s in jax.tree.leaves(rcshapes)]


def test_resolution_rules():
    """Replication where a size does not divide, one use of an axis a
    spec, the replica axes, and unconstrained dimensions."""
    mesh = lm.make_mesh((2, 4), ("data", "model"))
    t = torch.empty((8, 6, 12), device="meta")
    specs = tsh.resolve_specs(
        {"a": t, "b": t, "c": t},
        {"a": ("replica", "heads", "ff"), "b": ("?", "ff", "kv_heads"),
         "c": ("batch", None, "vocab")}, mesh)
    assert specs == {"a": ("data", None, "model"),
                     "b": ("?", None, "model"),
                     "c": ("data", None, "model")}
    # the rules can be overridden
    assert tsh.resolve_specs({"a": t}, {"a": ("batch", None, None)}, mesh,
                             {"batch": None}) == {"a": (None, None, None)}
    assert tsh.prepend_axis({"x": ("ff",)}, "layers") == \
        {"x": ("layers", "ff")}
    assert tsh.constrain(t, "heads") is t
