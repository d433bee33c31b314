"""Tensor parallelism within a replica: the SSM (mamba2) and hybrid
(zamba2) families. At mp 2 each rank holds half the SSD heads (4 of the
reduced configs' 8) and its slice of ``wz``, ``wx``, ``wdt``, ``D``,
``norm_scale`` and ``wo``; B, C and the convolution stay replicated, and
the gated RMSNorm's mean square is summed over the model group. As
``tests/test_torch_tensor_parallel.py``: dp 2 x mp 2 within 1e-5 of dp 2
x mp 1 and within 2e-4 of the reference's (2, 2) mesh after 2 rounds
with momentum, ``lm_loss``'s gradients at mp 2 within 1e-5 of
``jax.grad``."""
import pytest

import tp_reference as ref

FAMILIES = ["ssm", "hybrid"]


@pytest.fixture(scope="module")
def res(tmp_path_factory):
    inits = {f: ref.ref_init(f, 2) for f in FAMILIES}
    w4, w2 = ref.world_jobs(FAMILIES, inits)
    return ref.run_worlds(w4, w2, FAMILIES, inits,
                          str(tmp_path_factory.mktemp("tp")))


@pytest.mark.parametrize("family", FAMILIES)
def test_dp2_mp2_matches_mp1(res, family):
    ref.check_mp1(res, FAMILIES, family)


@pytest.mark.parametrize("family", FAMILIES)
def test_dp2_mp2_matches_reference_mesh(res, family):
    ref.check_reference(res, FAMILIES, family)


@pytest.mark.parametrize("family", FAMILIES)
def test_lm_loss_grads_at_mp2_match_jax(res, family):
    ref.check_grads(res, FAMILIES, family)
