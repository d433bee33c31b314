"""mfu.round: the whole round's share of the card's peak, in %: the
model FLOPs of a round over the window's seconds a round, against the
peak of the precision the configuration states (``peak``).

Frozen counts, for the LEAF-style CNN of the configuration (two k x k
SAME convolutions, each followed by a 2x2 pool, then two dense layers),
2 FLOPs a multiply-add: the forward F of one image; a training image
costs F + 2F for its backward, less the first convolution's gradient
with respect to its input, which no one needs; the evaluation is the
forward of the m edge models on ``eval_batch`` images. Bias adds, the
activations, the pools, the loss, the optimizer and the mixing are not
counted.
"""
from perfbench.metrics import _shared


def cnn_layer_flops(cfg):
    """[conv1, conv2, dense1, dense2] forward FLOPs of one image."""
    h, w, c = cfg["image"]
    k = cfg["kernel"]
    c1, c2 = cfg["conv_channels"]
    d = cfg["dense_width"]
    conv1 = 2 * h * w * c1 * k * k * c
    conv2 = 2 * (h // 2) * (w // 2) * c2 * k * k * c1
    feat = (h // 4) * (w // 4) * c2
    return [conv1, conv2, 2 * feat * d, 2 * d * cfg["num_classes"]]


def round_flops(cfg):
    layers = cnn_layer_flops(cfg)
    fwd = sum(layers)
    train = 3 * fwd - layers[0]
    a = cfg["assumed"]
    n = cfg["num_clusters"] * cfg["devices_per_cluster"]
    images = n * a["batch"] * cfg["tau"] * cfg["q"]
    return images * train + cfg["num_clusters"] * a["eval_batch"] * fwd


def read(ctx):
    rate = _shared.window_rate(ctx, "rounds")
    if rate is None:
        return None
    return 100.0 * round_flops(ctx.cfg) * rate / _shared.peak_flops(
        ctx.cfg["peak"])
