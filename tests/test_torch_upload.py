"""The port's upload path (``FLSimulator(compression=, dp=)``) against
``repro.FLSimulator``.

Three rounds of CE-FedAvg (8 devices, 4 clusters on a ring, τ=2, q=2,
π=4, MLP 16-32-4) from the same init weights, data and keys in both
packages, through the flat lowering's upload branch: each block's deltas
are privatized (keys ``split(k, n)``), compressed with error feedback
(keys ``split(fold_in(k, 1), n)``) and mixed as Y0 + W·delta. The banks
and losses agree within 1e-5 for the exact and the DP uplinks (f32 sums
in another order; the DP noise within two ulp); within 5e-3 for int8 and
top-k, where a floor or a top-k threshold may flip on a last-ulp
difference of its input (the streamed-int8 tolerance). The same under a
``mobile_sampled`` scenario mask, which the reference runs on its flat
path (frozen rows still take DP noise), and so does the port."""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.config import FLConfig
from repro.core.cefedavg import FLSimulator
from repro.core.compress import CompressionConfig
from repro.core.privacy import DPConfig
from repro.core.scenario import get_scenario
from repro.data.federated import (build_fl_data, dirichlet_partition,
                                  make_synthetic_classification)
from repro.models.cnn import apply_mlp_classifier, init_mlp_classifier
from repro_torch.config import FLConfig as TFLConfig
from repro_torch.configs import femnist_cnn
from repro_torch.convert import tree_from_numpy
from repro_torch.core import program as tprg
from repro_torch.core.cefedavg import FLSimulator as TSim
from repro_torch.core.compress import CompressionConfig as TCompression
from repro_torch.core.privacy import DPConfig as TDP
from repro_torch.core.runtime import paper_runtime_model as t_runtime
from repro_torch.core.scenario import get_scenario as t_get_scenario
from repro_torch.models.cnn import apply_mlp_classifier as t_apply

EXACT_ATOL = 1e-5
QUANT_ATOL = 5e-3
ROUNDS = 3
KW = dict(num_clusters=4, devices_per_cluster=2, tau=2, q=2, pi=4,
          topology="ring")
#: name -> (compression kwargs or None, DP kwargs or None, tolerance)
UPLOADS = {
    "none": (dict(kind="none"), None, EXACT_ATOL),
    "dp": (None, dict(clip_norm=1.0, noise_multiplier=0.3), EXACT_ATOL),
    "int8_ef": (dict(kind="int8"), None, QUANT_ATOL),
    "topk_ef": (dict(kind="topk", topk_frac=0.25), None, QUANT_ATOL),
    "dp_int8_ef": (dict(kind="int8"),
                   dict(clip_norm=1.0, noise_multiplier=0.3), QUANT_ATOL),
}


def _data(n):
    x, y = make_synthetic_classification(800, 16, 4, seed=3)
    tx, ty = make_synthetic_classification(400, 16, 4, seed=4)
    return build_fl_data(x, y, dirichlet_partition(y, n, 0.5, 5), tx, ty,
                         64)


def _pair(name, scenario=None, **geometry):
    comp, dp, _ = UPLOADS[name]
    kw = dict(KW, **geometry)
    data = _data(kw["num_clusters"] * kw["devices_per_cluster"])
    ref = FLSimulator(
        lambda k: init_mlp_classifier(k, 16, 32, 4), apply_mlp_classifier,
        FLConfig(**kw), {k: jnp.asarray(v) for k, v in data.items()},
        lr=0.1, batch_size=16,
        compression=None if comp is None else CompressionConfig(**comp),
        dp=None if dp is None else DPConfig(**dp),
        scenario=None if scenario is None else get_scenario(scenario))
    init = jax.device_get(init_mlp_classifier(jax.random.PRNGKey(0),
                                              16, 32, 4))
    port = TSim(
        lambda g: tree_from_numpy(init), t_apply, TFLConfig(**kw), data,
        lr=0.1, batch_size=16, device="cpu",
        compression=None if comp is None else TCompression(**comp),
        dp=None if dp is None else TDP(**dp),
        scenario=None if scenario is None else t_get_scenario(scenario))
    return ref, port


@pytest.fixture(scope="module", params=sorted(UPLOADS))
def ran(request):
    ref, port = _pair(request.param)
    return request.param, ref, port, ref.run(ROUNDS), port.run(ROUNDS)


def test_banks_match_after_three_rounds(ran):
    name, ref, port, _, _ = ran
    tol = UPLOADS[name][2]
    np.testing.assert_allclose(port.bank.params.numpy(),
                               np.asarray(ref.bank.params), atol=tol,
                               rtol=0)
    np.testing.assert_allclose(port.bank.mom.numpy(),
                               np.asarray(ref.bank.mom), atol=tol, rtol=0)


def test_residuals_match(ran):
    name, ref, port, _, _ = ran
    if ref.bank.residual is None:
        assert port.bank.residual is None and port.residual is None
        return
    if UPLOADS[name][0]["kind"] != "none":
        assert float(port.bank.residual.abs().max()) > 0
    np.testing.assert_allclose(port.bank.residual.numpy(),
                               np.asarray(ref.bank.residual),
                               atol=UPLOADS[name][2], rtol=0)
    leaves = jax.tree.leaves(ref.residual)
    got = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), port.residual))
    assert [a.shape for a in got] == [np.shape(b) for b in leaves]


def test_losses_match(ran):
    name, _, _, rh, th = ran
    np.testing.assert_allclose(th["loss"], rh["loss"],
                               atol=UPLOADS[name][2], rtol=0)
    assert th["round"] == rh["round"]


@pytest.mark.parametrize("name", ["dp", "int8_ef"])
def test_scenario_mask_runs_the_flat_path(name):
    """A partial cohort of an upload program is not compacted: the flat
    masked round runs, in both packages, and the banks agree. Four
    devices a cluster, so that sampling 80% leaves one out."""
    ref, port = _pair(name, scenario="mobile_sampled", devices_per_cluster=4)
    cohorts = []
    for _ in range(ROUNDS):
        plan = ref.step_round()
        port.step_round()
        cohorts.append(int(plan.mask.sum()))
        assert port.last_bucket == port.bank.n
    assert any(0 < k < port.bank.n for k in cohorts), cohorts
    np.testing.assert_allclose(port.bank.params.numpy(),
                               np.asarray(ref.bank.params),
                               atol=UPLOADS[name][2], rtol=0)
    np.testing.assert_array_equal(port.labels, ref.labels)


def test_upload_plan_mixes_once_more_a_round():
    """The upload plan keeps each block's first mix its own group, so the
    FEMNIST configuration's round is 9 gossip passes, not 8."""
    fl = femnist_cnn.FL
    for privatize, compress, want in ((False, False, fl.q),
                                      (True, False, fl.q + 1),
                                      (False, True, fl.q + 1),
                                      (True, True, fl.q + 1)):
        prog = tprg.canonical_program(fl, privatize=privatize,
                                      compress=compress)
        plans = tprg.lowering_plan(prog, fuse=True)
        assert sum(len(bp.groups) for bp in plans) == want
        assert prog.has_upload == (privatize or compress)


def test_other_engines_reject_upload_programs():
    """Compacted, streamed and async rounds run plain programs only."""
    init = jax.device_get(init_mlp_classifier(jax.random.PRNGKey(0),
                                              16, 32, 4))
    fl = TFLConfig(**KW)
    upload = tprg.canonical_program(fl, compress=True)
    sim = TSim(lambda g: tree_from_numpy(init), t_apply, fl, _data(8),
               lr=0.1, batch_size=16, device="cpu")
    with pytest.raises(NotImplementedError, match="plain programs"):
        sim._lower_compact(upload)
    with pytest.raises(NotImplementedError, match="plain programs"):
        sim._lower_streamed(upload)
    with pytest.raises(NotImplementedError, match="plain programs"):
        TSim(lambda g: tree_from_numpy(init), t_apply, fl, _data(8),
             lr=0.1, batch_size=16, schedule=upload,
             device="cpu").step_round_async(1, t_runtime())
    streamed = TSim(lambda g: tree_from_numpy(init), t_apply, fl, _data(8),
                    lr=0.1, batch_size=16, streaming=True, schedule=upload,
                    device="cpu")
    with pytest.raises(NotImplementedError, match="upload programs"):
        streamed.step_round()
    with pytest.raises(ValueError, match="upload transforms"):
        TSim(lambda g: tree_from_numpy(init), t_apply, fl, _data(8),
             streaming=True, compression=TCompression("int8"),
             device="cpu")


def test_compressed_example_runs_on_cpu(capsys):
    path = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "compressed_federated_torch.py")
    spec = importlib.util.spec_from_file_location("compressed_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(rounds=1, device="cpu")
    out = capsys.readouterr().out
    for row in ("exact (f32 uplink)", "int8 uplink (4x)",
                "topk 5% + err-feedback", "local DP (sigma=0.5)"):
        assert row in out
