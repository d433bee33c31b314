"""The port's simulator and event clock against ``repro.FLSimulator``.

The quickstart configuration (16 devices, 4 clusters on a ring, τ=2,
q=4, π=10, MLP 16-32-8, batch 16, lr 0.1) runs each of the four
algorithms for 2 rounds in both packages from the same init weights and
data: the banks, the eval history and the simulated wall times must
agree. Tolerance 1e-5 on the banks and losses (f32 sums in different
orders, compounded over 16 SGD steps; the runs agree to 3e-7..8e-7 on
params and 1e-6..3e-6 on momentum, so 1e-5 leaves a margin of about 3x
and still catches a mis-scaled gradient slice); wall times are exactly
equal (same numpy pricing); accuracies to one test sample.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import FLConfig
from repro.core import program as rprg
from repro.core.cefedavg import FLSimulator
from repro.core.clock import run_wall_clock, summarize, time_to_accuracy
from repro.core.runtime import paper_runtime_model
from repro.data.federated import (build_fl_data, dirichlet_partition,
                                  make_synthetic_classification)
from repro.models.cnn import apply_mlp_classifier, init_mlp_classifier
from repro_torch import tree as tr
from repro_torch.config import FLConfig as TFLConfig
from repro_torch.convert import tree_from_numpy
from repro_torch.core import clock as tclock
from repro_torch.core import program as tprg
from repro_torch.core.cefedavg import FLSimulator as TSim
from repro_torch.core.runtime import paper_runtime_model as t_runtime
from repro_torch.models.cnn import apply_mlp_classifier as t_apply

ATOL = 1e-5
QUICKSTART = [("ce_fedavg", 4, 4), ("hier_favg", 4, 4), ("fedavg", 1, 16),
              ("local_edge", 4, 4)]
ROUNDS = 2


def _kw(algo, m, dpc):
    return dict(algorithm=algo, num_clusters=m, devices_per_cluster=dpc,
                tau=2, q=4, pi=10, topology="ring")


def _data(n):
    x, y = make_synthetic_classification(1600, 16, 8, seed=0)
    tx, ty = make_synthetic_classification(400, 16, 8, seed=1)
    return build_fl_data(x, y, dirichlet_partition(y, n, 0.5, seed=2),
                         tx, ty, 64)


def _pair(algo, m, dpc):
    """(reference sim, port sim) from the same init and data."""
    kw = _kw(algo, m, dpc)
    data = _data(m * dpc)
    ref = FLSimulator(lambda k: init_mlp_classifier(k, 16, 32, 8),
                      apply_mlp_classifier, FLConfig(**kw),
                      {k: jnp.asarray(v) for k, v in data.items()},
                      lr=0.1, batch_size=16)
    init = jax.device_get(init_mlp_classifier(jax.random.PRNGKey(0),
                                              16, 32, 8))
    port = TSim(lambda g: tree_from_numpy(init), t_apply, TFLConfig(**kw),
                data, lr=0.1, batch_size=16, device="cpu")
    return ref, port


@pytest.fixture(scope="module", params=QUICKSTART, ids=lambda a: a[0])
def ran(request):
    ref, port = _pair(*request.param)
    rh = run_wall_clock(ref, paper_runtime_model(), ROUNDS)
    th = tclock.run_wall_clock(port, t_runtime(), ROUNDS)
    return ref, port, rh, th


def test_banks_match_after_two_rounds(ran):
    ref, port, _, _ = ran
    np.testing.assert_allclose(port.bank.params.numpy(),
                               np.asarray(ref.bank.params), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(port.bank.mom.numpy(),
                               np.asarray(ref.bank.mom), atol=ATOL, rtol=0)
    assert port.round_index == ROUNDS
    np.testing.assert_array_equal(port.key, np.asarray(ref.key))


def test_history_and_wall_clock_match(ran):
    _, port, rh, th = ran
    assert th["round"] == rh["round"]
    assert th["wall_time"] == rh["wall_time"]
    assert th["participants"] == rh["participants"]
    np.testing.assert_allclose(th["loss"], rh["loss"], atol=ATOL, rtol=0)
    np.testing.assert_allclose(th["acc"], rh["acc"], atol=1 / 400 + 1e-6,
                               rtol=0)
    for target in (0.5, 0.9, 0.999):
        tt = tclock.time_to_accuracy(th, target)
        rt = time_to_accuracy(rh, target)
        assert (tt is None) == (rt is None)
        if tt is not None:
            assert tt == rt
    assert tclock.summarize(th, 0.999).split()[1:] \
        == summarize(rh, 0.999).split()[1:]


def test_edge_and_global_models_match(ran):
    ref, port, _, _ = ran
    for t_tree, r_tree in ((port.edge_models(), ref.edge_models()),
                           (port.global_model(), ref.global_model()),
                           (port.params, ref.params), (port.mom, ref.mom)):
        tl, rl = tr.tree_leaves(t_tree), jax.tree.leaves(r_tree)
        assert len(tl) == len(rl)
        for a, b in zip(tl, rl):
            assert tuple(a.shape) == b.shape
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                       rtol=0)
    assert tprg.edge_disagreement(port) == pytest.approx(
        rprg.edge_disagreement(ref), abs=ATOL)


def test_run_matches_reference():
    ref, port = _pair("ce_fedavg", 4, 4)
    rh = ref.run(2, eval_every=2, eval_batch=100)
    th = port.run(2, eval_every=2, eval_batch=100)
    assert th["round"] == rh["round"] == [2]
    np.testing.assert_allclose(th["loss"], rh["loss"], atol=ATOL, rtol=0)
    np.testing.assert_allclose(th["acc"], rh["acc"], atol=1 / 100 + 1e-6,
                               rtol=0)


def test_mixing_launch_count_per_round(monkeypatch):
    """One mixing pass per MixGroup of the canonical program (q a round
    with the fused τ∘qτ boundary), plus one projection per evaluation —
    the count ``chip_smoke.py`` reads off the kernel's counter."""
    from repro_torch.core import cefedavg as tcef
    from repro_torch.core import modelbank as tmb
    calls = []

    def counting(W, Y, _real=tcef.gossip_mix_rows):
        calls.append(tuple(np.shape(W)))
        return _real(W, Y)
    monkeypatch.setattr(tcef, "gossip_mix_rows", counting)
    monkeypatch.setattr(tmb, "gossip_mix_rows", counting)
    _, port = _pair("ce_fedavg", 4, 4)
    tclock.run_wall_clock(port, t_runtime(), 2)
    q, n, m = 4, 16, 4
    assert calls.count((n, n)) == 2 * q
    assert calls.count((m, n)) == 2


def test_round_leaves_no_tensor_in_a_cycle():
    """A round's gradients and temporaries die by reference counting: with
    the cyclic collector off, a warm round adds no live tensor (a cycle
    would hold a step's bank-sized gradients until the collector ran)."""
    import gc

    def live_tensors():
        return sum(isinstance(o, torch.Tensor) for o in gc.get_objects())
    _, port = _pair("ce_fedavg", 4, 4)
    port.step_round()
    gc.collect()
    gc.disable()
    try:
        before = live_tensors()
        port.step_round()
        port.step_round()
        assert live_tensors() == before
    finally:
        gc.enable()


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default is taken")
    kw = _kw("ce_fedavg", 4, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TSim(lambda g: {"w": torch.zeros(2)}, t_apply, TFLConfig(**kw),
             _data(16))


def test_quickstart_example_runs_on_cpu(capsys):
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "quickstart_torch.py")
    spec = importlib.util.spec_from_file_location("quickstart_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(rounds=1, target=0.2, device="cpu")
    out = capsys.readouterr().out
    assert "CFEL quickstart (PyTorch)" in out and "local_edge" in out


def test_time_to_accuracy_cli_on_cpu(capsys):
    from repro_torch.launch import time_to_accuracy as cli
    res = cli.main(["--device", "cpu", "--rounds", "1", "--algorithms",
                    "ce_fedavg", "fedavg", "--target", "0.1"])
    assert set(res) == {(s, a) for s in ("homogeneous", "lognormal",
                                          "mobility")
                        for a in ("ce_fedavg", "fedavg")}
    assert "ce_fedavg" in capsys.readouterr().out


def test_femnist_cnn_round_on_cpu():
    """One round of the FEMNIST CNN at full width (6,603,710 params) on
    four devices: finite loss and cluster-synced rows after the fused
    boundary."""
    from repro_torch.data.federated import (build_fl_data as bfd,
                                            dirichlet_partition as dp,
                                            make_synthetic_images)
    from repro_torch.models.cnn import apply_femnist_cnn, init_femnist_cnn
    fl = TFLConfig(algorithm="ce_fedavg", num_clusters=2,
                   devices_per_cluster=2, tau=1, q=2, pi=10)
    x, y = make_synthetic_images(128, 28, 1, 62, seed=0)
    tx, ty = make_synthetic_images(32, 28, 1, 62, seed=1)
    sim = TSim(init_femnist_cnn, apply_femnist_cnn, fl,
               bfd(x, y, dp(y, fl.n, 0.3, 0), tx, ty, 16), lr=0.1,
               batch_size=8, device="cpu")
    assert sim.layout.total == 6_603_710
    hist = sim.run(1)
    acc, loss = hist["acc"][0], hist["loss"][0]
    assert np.isfinite(loss) and 0.0 <= acc <= 1.0
    Y = sim.bank.params.view(2, 2, -1)
    assert float((Y - Y[:, :1]).abs().max()) == 0.0
