"""The port's classifier models against the reference on the same weights:
logits, loss and per-row gradients (``vmap(grad)`` over flat rows). The
simulator takes its gradients per leaf view of the bank instead; that
path is held to the reference by the bank parity tests of
``test_torch_cefedavg.py``. Tolerance 1e-5 (f32; the two frameworks sum
convolutions and products in different orders)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from repro.kernels.gossip_mix import FlatLayout as RLayout
from repro.models import cnn as rcnn
from repro_torch.convert import row_from_numpy, tree_from_numpy
from repro_torch.kernels.gossip_mix import FlatLayout as TLayout
from repro_torch.models import cnn as tcnn

TOL = dict(rtol=1e-5, atol=1e-5)

CASES = {
    # name: (reference init, reference apply, port apply, input shape,
    #        classes)
    "mlp": (lambda k: rcnn.init_mlp_classifier(k, 16, 32, 8),
            rcnn.apply_mlp_classifier, tcnn.apply_mlp_classifier, (16,), 8),
    "femnist_cnn": (lambda k: rcnn.init_femnist_cnn(k, num_classes=10,
                                                    image_size=8),
                    rcnn.apply_femnist_cnn, tcnn.apply_femnist_cnn,
                    (8, 8, 1), 10),
    "vgg11": (rcnn.init_vgg11, rcnn.apply_vgg11, tcnn.apply_vgg11,
              (32, 32, 3), 10),
}


def _inputs(name, rows, batch):
    _, _, _, shape, classes = CASES[name]
    rng = np.random.default_rng(len(name))
    x = rng.standard_normal((rows, batch) + shape).astype(np.float32)
    y = rng.integers(0, classes, (rows, batch)).astype(np.int32)
    return x, y


@pytest.mark.parametrize("name", list(CASES))
def test_logits_match(name):
    init, r_apply, t_apply, _, _ = CASES[name]
    params = jax.device_get(init(jax.random.PRNGKey(1)))
    x, y = _inputs(name, 1, 2)
    exp = np.asarray(r_apply(params, jnp.asarray(x[0])))
    got = t_apply(tree_from_numpy(params), torch.from_numpy(x[0]))
    np.testing.assert_allclose(got.detach().numpy(), exp, **TOL)
    np.testing.assert_allclose(
        tcnn.softmax_xent(got, torch.from_numpy(y[0]).long()).item(),
        float(rcnn.softmax_xent(jnp.asarray(exp), jnp.asarray(y[0]))),
        **TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_per_row_gradients_match(name):
    """Two device rows, batch 2 each: the simulator's vmap(grad) over
    flat rows, on converted weights."""
    init, r_apply, t_apply, _, _ = CASES[name]
    one = jax.device_get(init(jax.random.PRNGKey(2)))
    params = [one, jax.tree.map(lambda a: 0.5 * a, one)]
    rlay = RLayout.for_tree(params[0])
    tlay = TLayout.for_tree(tree_from_numpy(params[0]))
    rows_np = np.stack([np.asarray(rlay.flatten_one(p)) for p in params])
    x, y = _inputs(name, 2, 2)

    def r_loss(row, xb, yb):
        return rcnn.softmax_xent(r_apply(rlay.unflatten_one(row), xb), yb)

    def t_loss(row, xb, yb):
        return tcnn.softmax_xent(t_apply(tlay.unflatten_one(row), xb), yb)

    exp = np.asarray(jax.vmap(jax.grad(r_loss))(
        jnp.asarray(rows_np), jnp.asarray(x), jnp.asarray(y)))
    rows = torch.stack([row_from_numpy(p) for p in params])
    got = vmap(grad(t_loss))(rows, torch.from_numpy(x),
                             torch.from_numpy(y).long())
    assert got.shape == rows.shape
    np.testing.assert_allclose(got.numpy(), exp, **TOL)


def test_accuracy_and_registry():
    logits = torch.tensor([[0.1, 0.9], [0.8, 0.2], [0.3, 0.7]])
    labels = torch.tensor([1, 1, 1])
    assert abs(tcnn.accuracy(logits, labels).item() - 2 / 3) < 1e-7
    assert float(rcnn.accuracy(jnp.asarray(logits.numpy()),
                               jnp.asarray(labels.numpy()))) \
        == pytest.approx(tcnn.accuracy(logits, labels).item())
    assert set(tcnn.MODEL_REGISTRY) == set(rcnn.MODEL_REGISTRY)
