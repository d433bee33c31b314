"""The port's streamed engine over an enumerated, faulted scenario against
``repro.FLSimulator``.

The MLP 16-32-4 over 4 clusters of 4 on a ring (τ=2, q=2, π=3, batch 16,
lr 0.1) under ``sampled`` with ``outage`` faults (scenario seed 7, fault
seed 0) streams 4 rounds through the f32 client store: each round's
working set is its cohort plus the first cold device of each cluster,
and a fault-dark cluster keeps a stale reference at page-out. The fault
trace of these rounds holds dark clusters (asserted). The port's serial
and pipelined runs are held against the reference's serial run: models,
cluster references and stored momentum within 1e-5 (f32 sums in another
order), keyed quantities (page labels, paging, slab sizes, wall times)
exactly. Inside the port the pipelined run equals the serial one bit
for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import FLConfig
from repro.core.cefedavg import FLSimulator
from repro.core.clock import run_wall_clock
from repro.core.runtime import paper_runtime_model
from repro.core.scenario import get_faults, get_scenario
from repro.data.federated import (build_fl_data, dirichlet_partition,
                                  make_synthetic_classification)
from repro.models.cnn import apply_mlp_classifier, init_mlp_classifier
from repro_torch import tree as tr
from repro_torch.config import FLConfig as TFLConfig
from repro_torch.convert import tree_from_numpy
from repro_torch.core import clock as tclock
from repro_torch.core import scenario as tsc
from repro_torch.core.cefedavg import FLSimulator as TSim
from repro_torch.core.runtime import paper_runtime_model as t_runtime
from repro_torch.models.cnn import apply_mlp_classifier as t_apply

FL_KW = dict(algorithm="ce_fedavg", num_clusters=4, devices_per_cluster=4,
             tau=2, q=2, pi=3, topology="ring")
ROUNDS = 4
ATOL = 1e-5


def _data():
    x, y = make_synthetic_classification(800, 16, 4, seed=3)
    tx, ty = make_synthetic_classification(400, 16, 4, seed=4)
    return build_fl_data(x, y, dirichlet_partition(y, 16, 0.5, seed=5),
                         tx, ty, 64)


def _port(pipeline):
    sc = dataclasses.replace(tsc.get_scenario("sampled"), seed=7,
                             faults=tsc.get_faults("outage"))
    init = jax.device_get(init_mlp_classifier(jax.random.PRNGKey(0),
                                              16, 32, 4))
    return TSim(lambda g: tree_from_numpy(init), t_apply, TFLConfig(**FL_KW),
                _data(), lr=0.1, batch_size=16, scenario=sc, streaming=True,
                pipeline=pipeline, device="cpu")


def _leaves(tree):
    return [leaf.numpy() if isinstance(leaf, torch.Tensor)
            else np.asarray(leaf) for leaf in tr.tree_leaves(tree)]


@pytest.fixture(scope="module")
def ran():
    sc = dataclasses.replace(get_scenario("sampled"), seed=7,
                             faults=get_faults("outage"))
    ref = FLSimulator(lambda k: init_mlp_classifier(k, 16, 32, 4),
                      apply_mlp_classifier, FLConfig(**FL_KW),
                      {k: jnp.asarray(v) for k, v in _data().items()},
                      lr=0.1, batch_size=16, scenario=sc, streaming=True)
    rh = run_wall_clock(ref, paper_runtime_model(), ROUNDS)
    out = {"ref": (ref, rh)}
    for name, pipeline in (("serial", False), ("pipelined", True)):
        port = _port(pipeline)
        out[name] = (port, tclock.run_wall_clock(port, t_runtime(), ROUNDS))
    return out


def test_fault_trace_holds_dark_clusters():
    """The parity below covers page-outs that skip dark clusters."""
    port = _port(False)
    down = [port.engine.step().fault.cluster_down.sum()
            for _ in range(ROUNDS)]
    assert sum(down) >= 1, down


@pytest.mark.parametrize("driver", ["serial", "pipelined"])
def test_streamed_scenario_matches_reference(ran, driver):
    ref, rh = ran["ref"]
    port, th = ran[driver]
    for t_tree, r_tree in ((port.global_model(), ref.global_model()),
                           (port.edge_models(), ref.edge_models())):
        for a, b in zip(_leaves(t_tree), _leaves(r_tree)):
            np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)
    ts, rs = port.store.snapshot(), ref.store.snapshot()
    np.testing.assert_array_equal(ts["ids"], rs["ids"])
    np.testing.assert_allclose(ts["cluster"], rs["cluster"], atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(port.store.fetch(ts["ids"]),
                               ref.store.fetch(rs["ids"]), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(port._page_labels, ref._page_labels)
    np.testing.assert_array_equal(port.labels, ref.labels)
    assert port.last_paging == ref.last_paging
    assert port.last_bucket == ref.last_bucket
    assert port.peak_slab_bytes == ref.peak_slab_bytes
    assert th["wall_time"] == rh["wall_time"]
    assert th["participants"] == rh["participants"]
    np.testing.assert_allclose(th["loss"], rh["loss"], atol=ATOL, rtol=0)


def test_pipelined_equals_serial_bitwise(ran):
    ser, _ = ran["serial"]
    pip, _ = ran["pipelined"]
    for a, b in zip(_leaves(ser.global_model()), _leaves(pip.global_model())):
        np.testing.assert_array_equal(a, b)
    sa, sb = ser.store.snapshot(), pip.store.snapshot()
    for k in sa:
        np.testing.assert_array_equal(sa[k], sb[k])
    np.testing.assert_array_equal(ser._page_labels, pip._page_labels)
