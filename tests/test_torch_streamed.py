"""The port's streamed engine against ``repro.FLSimulator``.

The configuration of ``tests/test_clientstore.py`` (MLP 16-32-4, m=4
clusters of 4 on a ring, τ=2, q=2, π=2, batch 16, lr 0.1, seed 1) under
its MOBILE population of 400 virtual clients (cohort 3 a cluster,
sampling 0.5, dropout 0.1, visit mobility 0.25) runs 4 rounds in both
packages from the same init and data, through the serial and the
pipelined drivers. On the CPU the port's cold codec is its plain
version.

Tolerances: global and edge models to 1e-5 at f32 (f32 sums in
different orders over 8 SGD steps a round); 5e-3 at int8, the
reference's own bound between its pipelined and serial int8 runs
(a requantized momentum row may round the other way after a 1e-7
difference); inside the port, pipelined equals serial bit for bit at
f32, the property the reference pins. Keyed quantities (page labels,
paging counts, slab sizes, simulated wall times, participants) are
exactly equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import FLConfig, PopulationConfig, ScenarioConfig
from repro.core.cefedavg import FLSimulator
from repro.core.clock import run_wall_clock
from repro.core.runtime import paper_runtime_model
from repro.data.federated import (build_fl_data, dirichlet_partition,
                                  make_synthetic_classification)
from repro.models.cnn import apply_mlp_classifier, init_mlp_classifier
from repro_torch import tree as tr
from repro_torch.config import FLConfig as TFLConfig
from repro_torch.config import PopulationConfig as TPopulationConfig
from repro_torch.config import ScenarioConfig as TScenarioConfig
from repro_torch.convert import tree_from_numpy
from repro_torch.core import clock as tclock
from repro_torch.core.cefedavg import FLSimulator as TSim
from repro_torch.core.program import TierMix
from repro_torch.core.runtime import paper_runtime_model as t_runtime
from repro_torch.kernels import cold_codec as tcc
from repro_torch.models.cnn import apply_mlp_classifier as t_apply

FL_KW = dict(algorithm="ce_fedavg", num_clusters=4, devices_per_cluster=4,
             tau=2, q=2, pi=2, topology="ring")
MOBILE_KW = dict(name="mobile", sample_fraction=0.5, dropout_prob=0.1,
                 move_prob=0.25, seed=7)
ROUNDS = 4
ATOL = {"f32": 1e-5, "int8": 5e-3}


def _data():
    x, y = make_synthetic_classification(800, 16, 4, seed=3)
    tx, ty = make_synthetic_classification(400, 16, 4, seed=4)
    parts = dirichlet_partition(y, 16, alpha=0.5, seed=5)
    return build_fl_data(x, y, parts, tx, ty, samples_per_device=64)


def _scenarios(codec):
    """(reference, port) population scenarios, or (None, None)."""
    if codec is None:
        return None, None
    pop = dict(clients_per_cluster=100, cohort_per_cluster=3, codec=codec)
    return (dataclasses.replace(ScenarioConfig(**MOBILE_KW),
                                population=PopulationConfig(**pop)),
            dataclasses.replace(TScenarioConfig(**MOBILE_KW),
                                population=TPopulationConfig(**pop)))


def _init():
    return jax.device_get(init_mlp_classifier(jax.random.PRNGKey(1), 16,
                                              32, 4))


def _port(codec=None, pipeline=False, streaming=False, **fl):
    """The port's simulator: over the population under ``codec``, or
    without a scenario when ``codec`` is None."""
    _, tsc = _scenarios(codec)
    init = _init()
    return TSim(lambda g: tree_from_numpy(init), t_apply,
                TFLConfig(**FL_KW, **fl), _data(), lr=0.1, batch_size=16,
                seed=1, scenario=tsc, streaming=streaming,
                pipeline=pipeline, device="cpu")


def _ref(codec=None, pipeline=False, streaming=False, **fl):
    rsc, _ = _scenarios(codec)
    data = {k: jnp.asarray(v) for k, v in _data().items()}
    return FLSimulator(lambda k: init_mlp_classifier(k, 16, 32, 4),
                       apply_mlp_classifier, FLConfig(**FL_KW, **fl), data,
                       lr=0.1, batch_size=16, seed=1, scenario=rsc,
                       streaming=streaming, pipeline=pipeline)


def _np_leaves(tree):
    """Leaves of a port or reference tree as numpy arrays (both in
    ``jax.tree.flatten`` order)."""
    return [leaf.numpy() if isinstance(leaf, torch.Tensor)
            else np.asarray(leaf) for leaf in tr.tree_leaves(tree)]


@pytest.fixture(scope="module", params=[("f32", False), ("f32", True),
                                        ("int8", False), ("int8", True)],
                ids=lambda p: f"{p[0]}-{'pipelined' if p[1] else 'serial'}")
def ran(request):
    """At int8 the port's pipelined run is held against the reference's
    serial run: the reference's pipelined int8 stage hands a reused host
    buffer of int8 codes to ``jnp.asarray``, which on XLA's CPU backend
    may alias it, so a later stage can overwrite codes not yet consumed
    and its losses vary from run to run (ROADMAP.md C1). Its serial run
    is deterministic, and pipelined equals serial inside the port (the
    tests below pin both codecs)."""
    codec, pipeline = request.param
    ref = _ref(codec, pipeline and codec == "f32")
    port = _port(codec, pipeline)
    rh = run_wall_clock(ref, paper_runtime_model(), ROUNDS)
    th = tclock.run_wall_clock(port, t_runtime(), ROUNDS)
    return codec, ref, port, rh, th


def test_models_match_reference(ran):
    codec, ref, port, _, _ = ran
    for t_tree, r_tree in ((port.global_model(), ref.global_model()),
                           (port.edge_models(), ref.edge_models())):
        for a, b in zip(_np_leaves(t_tree), _np_leaves(r_tree)):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, atol=ATOL[codec], rtol=0)


def test_store_matches_reference(ran):
    """The same clients hold stored rows; at f32 their momentum and the
    references agree to 1e-5. At int8 every decoded row lies within one
    quantization step of the reference's (half a step of rounding on
    each side) plus the 1e-5 by which the unquantized momenta may differ
    (f32 sums in another order: a step is as small as 4e-7 on the bias
    segments, below that gap)."""
    codec, ref, port, _, _ = ran
    ts, rs = port.store.snapshot(), ref.store.snapshot()
    np.testing.assert_array_equal(ts["ids"], rs["ids"])
    np.testing.assert_allclose(ts["cluster"], rs["cluster"],
                               atol=ATOL[codec], rtol=0)
    segs = port.layout.segments
    tdec = port.store.fetch(ts["ids"])
    rdec = ref.store.fetch(rs["ids"])
    if codec == "f32":
        np.testing.assert_allclose(tdec, rdec, atol=ATOL[codec], rtol=0)
        return
    for j, (o, s) in enumerate(segs):
        step = np.maximum(ts["mom_scale"][:, j], rs["mom_scale"][:, j])
        diff = np.abs(tdec[:, o:o + s] - rdec[:, o:o + s]).max(1)
        assert (diff <= step + ATOL["f32"]).all(), (j, diff.max())


def test_paging_and_clock_match_reference(ran):
    _, ref, port, rh, th = ran
    np.testing.assert_array_equal(port._page_labels, ref._page_labels)
    assert port.last_paging == ref.last_paging
    assert port.peak_slab_bytes == ref.peak_slab_bytes
    assert port.last_bucket == ref.last_bucket
    assert port.round_index == ref.round_index == ROUNDS
    np.testing.assert_array_equal(port.key, np.asarray(ref.key))
    assert th["round"] == rh["round"]
    assert th["wall_time"] == rh["wall_time"]
    assert th["participants"] == rh["participants"]
    np.testing.assert_allclose(th["loss"], rh["loss"], atol=ATOL[ran[0]],
                               rtol=0)
    assert all(p > 0.0 for p in th["page_s"])
    assert len(th["eval_s"]) == len(th["round"]) == ROUNDS


def test_pipelined_equals_serial_bitwise_f32():
    """Inside the port the overlapped driver — device codec, cross-round
    forwarding, one-round-late commits — runs the serial driver's round
    function on the same input bits, so at f32 the two are identical:
    global model, store bytes and page labels."""
    ser, pip = _port("f32", False), _port("f32", True)
    for _ in range(6):
        ser.step_round()
        pip.step_round()
    for a, b in zip(_np_leaves(ser.global_model()),
                    _np_leaves(pip.global_model())):
        np.testing.assert_array_equal(a, b)
    sa, sb = ser.store.snapshot(), pip.store.snapshot()
    for k in sa:
        np.testing.assert_array_equal(sa[k], sb[k])
    np.testing.assert_array_equal(ser._page_labels, pip._page_labels)
    assert pip._page_seconds > 0.0
    # on the CPU the codec takes its plain version: nothing launched
    assert tcc.encode_launches == tcc.decode_launches == 0


def test_pipelined_equals_serial_bitwise_int8():
    """The int8 twin: the pipelined driver encodes and decodes the same
    rows as the serial one, so global and edge models, every stored
    byte (codes and scales), the page labels and the loss history are
    identical. This is the property the int8-pipelined cases above lean
    on when they hold the port's pipelined run against the reference's
    serial run."""
    ser, pip = _port("int8", False), _port("int8", True)
    hs = tclock.run_wall_clock(ser, t_runtime(), ROUNDS)
    hp = tclock.run_wall_clock(pip, t_runtime(), ROUNDS)
    for t_s, t_p in ((ser.global_model(), pip.global_model()),
                     (ser.edge_models(), pip.edge_models())):
        for a, b in zip(_np_leaves(t_s), _np_leaves(t_p)):
            np.testing.assert_array_equal(a, b)
    sa, sb = ser.store.snapshot(), pip.store.snapshot()
    assert sa.keys() == sb.keys()
    for k in sa:
        np.testing.assert_array_equal(sa[k], sb[k])
    np.testing.assert_array_equal(ser._page_labels, pip._page_labels)
    assert hs["loss"] == hp["loss"]
    assert hs["wall_time"] == hp["wall_time"]
    assert tcc.encode_launches == tcc.decode_launches == 0


@pytest.mark.parametrize("pipeline", [False, True],
                         ids=["serial", "pipelined"])
def test_streaming_without_scenario_matches_resident(pipeline):
    """``streaming=True`` at enumerated n=16 with no scenario pages every
    device through the store each round and reproduces the port's
    resident engine (1e-5: the slab's operator is the same matrix, the
    batches the same draws)."""
    res = _port(streaming=False)
    st = _port(streaming=True, pipeline=pipeline)
    assert st.bank is None and st.store is not None
    for _ in range(3):
        res.step_round()
        st.step_round()
    for a, b in zip(_np_leaves(res.global_model()),
                    _np_leaves(st.global_model())):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
    for a, b in zip(_np_leaves(res.edge_models()),
                    _np_leaves(st.edge_models())):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
    assert st.peak_slab_bytes == 2 * 4 * 16 * st.layout.total


@pytest.mark.parametrize("pipeline", [False, True],
                         ids=["serial", "pipelined"])
def test_hierarchical_population_matches_reference(pipeline):
    """A depth-3 hierarchy (2 regions x 2 edges x 4): the round's last
    boundary adds a tier-2 mix, resolved from the working set's labels
    lifted to regions."""
    ref = _ref("f32", pipeline, hierarchy=(2, 2, 4))
    port = _port("f32", pipeline, hierarchy=(2, 2, 4))
    for _ in range(3):
        ref.step_round()
        port.step_round()
    assert any(isinstance(op, TierMix) and op.level == 2
               for op in port.last_program.ops)
    for a, b in zip(_np_leaves(port.global_model()),
                    _np_leaves(ref.global_model())):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


def test_streaming_without_scenario_matches_reference():
    ref, port = _ref(streaming=True), _port(streaming=True)
    for _ in range(2):
        ref.step_round()
        port.step_round()
    for a, b in zip(_np_leaves(port.global_model()),
                    _np_leaves(ref.global_model())):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(port._page_labels, ref._page_labels)


def test_streamed_options_are_checked():
    with pytest.raises(ValueError, match="streamed engine"):
        TSim(lambda g: tree_from_numpy(_init()), t_apply, TFLConfig(**FL_KW),
             _data(), pipeline=True, device="cpu")
    # an enumerated scenario builds its ScenarioEngine; a round schedule
    # needs enumerated devices, and async rounds a resident bank
    from repro_torch.core.scenario import ScenarioEngine
    sim = TSim(lambda g: tree_from_numpy(_init()), t_apply,
               TFLConfig(**FL_KW), _data(),
               scenario=TScenarioConfig(**MOBILE_KW), device="cpu")
    assert isinstance(sim.engine, ScenarioEngine) and sim.bank is not None
    _, port_sc = _scenarios("f32")
    with pytest.raises(ValueError, match="virtual population"):
        TSim(lambda g: tree_from_numpy(_init()), t_apply,
             TFLConfig(**FL_KW), _data(), scenario=port_sc,
             schedule="adaptive_tau", device="cpu")
    with pytest.raises(ValueError, match="resident rows"):
        _port("f32").step_round_async(0, t_runtime())
    with pytest.raises(AttributeError, match="streamed engine"):
        _port("f32").params  # noqa: B018


def test_population_launcher_on_cpu(capsys, tmp_path):
    from repro_torch.launch import train
    base = ["--device", "cpu", "--population", "2000", "--cohort", "3",
            "--pipeline", "--codec", "int8"]
    full = train.main(base + ["--rounds", "3"])
    out = capsys.readouterr().out
    assert "N=2000 virtual clients" in out and "round 1:" in out
    # killed after round 2 (its checkpoint), resumed for round 3: the
    # global model and the store equal the uninterrupted run's bit for bit
    ck = ["--ckpt-dir", str(tmp_path)]
    train.main(base + ck + ["--rounds", "2"])
    resumed = train.main(base + ck + ["--rounds", "3", "--resume"])
    out = capsys.readouterr().out
    assert "at round 2" in out and "round 2:" in out
    assert torch.equal(full.layout.flatten_one(full.global_model()),
                       resumed.layout.flatten_one(resumed.global_model()))
    a, b = full.store.snapshot(), resumed.store.snapshot()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(NotImplementedError, match="ROADMAP A14"):
        train.main(["--device", "cpu", "--population", "100",
                    "--data-parallel", "2"])
