"""The paper's experiment models in PyTorch (port of ``repro.models.cnn``).

- FEMNIST CNN: the LEAF CNN (5x5 conv 32 -> 5x5 conv 64, each + 2x2
  maxpool, FC-2048, softmax-62) = 6,603,710 params, the count the paper
  cites.
- VGG-11 (modified, CIFAR-10): 9,750,922 params, classifier
  512 -> 512 -> 512 -> 10.
- A small MLP for fast tests of the FL optimizer algebra.

Parameters are nested dicts (and VGG's list of convs) in the reference's
layout: conv weights HWIO, dense weights (fan_in, fan_out), images NHWC.
Inside, convolutions run in PyTorch's NCHW/OIHW with SAME padding and a
2x2 VALID max pool, and activations return to NHWC order before the
flatten, so the same weights give the same logits as the reference.
Apply functions are pure in their parameters, so ``torch.func.vmap``
batches them over the device axis of the bank.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


def _conv_init(gen: torch.Generator, kh, kw, cin, cout) -> torch.Tensor:
    scale = 1.0 / (kh * kw * cin) ** 0.5
    return torch.randn((kh, kw, cin, cout), generator=gen) * scale


def _fc_init(gen: torch.Generator, fin, fout) -> torch.Tensor:
    return torch.randn((fin, fout), generator=gen) * (1.0 / fin ** 0.5)


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """SAME, stride-1 convolution of NCHW ``x`` with an HWIO ``w``."""
    kh, kw = w.shape[0], w.shape[1]
    assert kh % 2 and kw % 2, "SAME padding is symmetric for odd kernels"
    return F.conv2d(x, w.permute(3, 2, 0, 1), b, padding=(kh // 2, kw // 2))


def _maxpool(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 2, 2)


def _flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW activations -> (B, H*W*C), the reference's flatten order."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


# ---------------------------------------------------------------------------
# FEMNIST CNN
# ---------------------------------------------------------------------------

def init_femnist_cnn(gen: torch.Generator, num_classes: int = 62,
                     image_size: int = 28) -> Params:
    """Random FEMNIST-CNN weights from ``gen`` (CPU tensors)."""
    feat = (image_size // 4) ** 2 * 64
    return {
        "c1": {"w": _conv_init(gen, 5, 5, 1, 32), "b": torch.zeros(32)},
        "c2": {"w": _conv_init(gen, 5, 5, 32, 64), "b": torch.zeros(64)},
        "f1": {"w": _fc_init(gen, feat, 2048), "b": torch.zeros(2048)},
        "f2": {"w": _fc_init(gen, 2048, num_classes),
               "b": torch.zeros(num_classes)},
    }


def apply_femnist_cnn(params: Params, images: torch.Tensor) -> torch.Tensor:
    """Logits of NHWC ``images`` (B, H, W, 1)."""
    x = images.permute(0, 3, 1, 2)
    x = _maxpool(F.relu(_conv(x, params["c1"]["w"], params["c1"]["b"])))
    x = _maxpool(F.relu(_conv(x, params["c2"]["w"], params["c2"]["b"])))
    x = _flatten_nhwc(x)
    x = F.relu(x @ params["f1"]["w"] + params["f1"]["b"])
    return x @ params["f2"]["w"] + params["f2"]["b"]


# ---------------------------------------------------------------------------
# VGG-11 (CIFAR-10, modified — paper reports 9,750,922 params)
# ---------------------------------------------------------------------------

_VGG11 = [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"]


def init_vgg11(gen: torch.Generator, num_classes: int = 10,
               in_ch: int = 3) -> Params:
    """Random VGG-11 weights from ``gen`` (CPU tensors)."""
    params: Params = {"convs": []}
    cin = in_ch
    for v in _VGG11:
        if v == "M":
            continue
        params["convs"].append(
            {"w": _conv_init(gen, 3, 3, cin, v), "b": torch.zeros(v)})
        cin = v
    params["f1"] = {"w": _fc_init(gen, 512, 512), "b": torch.zeros(512)}
    params["f1b"] = {"w": _fc_init(gen, 512, 512), "b": torch.zeros(512)}
    params["f2"] = {"w": _fc_init(gen, 512, num_classes),
                    "b": torch.zeros(num_classes)}
    return params


def apply_vgg11(params: Params, images: torch.Tensor) -> torch.Tensor:
    """Logits of NHWC ``images`` (B, 32, 32, 3)."""
    x = images.permute(0, 3, 1, 2)
    ci = 0
    for v in _VGG11:
        if v == "M":
            x = _maxpool(x)
        else:
            c = params["convs"][ci]
            x = F.relu(_conv(x, c["w"], c["b"]))
            ci += 1
    x = _flatten_nhwc(x)
    x = F.relu(x @ params["f1"]["w"] + params["f1"]["b"])
    x = F.relu(x @ params["f1b"]["w"] + params["f1b"]["b"])
    return x @ params["f2"]["w"] + params["f2"]["b"]


# ---------------------------------------------------------------------------
# tiny MLP (tests)
# ---------------------------------------------------------------------------

def init_mlp_classifier(gen: torch.Generator, d_in: int, d_hidden: int,
                        num_classes: int) -> Params:
    """Random two-layer MLP weights from ``gen`` (CPU tensors)."""
    return {
        "f1": {"w": _fc_init(gen, d_in, d_hidden),
               "b": torch.zeros(d_hidden)},
        "f2": {"w": _fc_init(gen, d_hidden, num_classes),
               "b": torch.zeros(num_classes)},
    }


def apply_mlp_classifier(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Logits of feature rows ``x`` (B, d_in)."""
    h = F.relu(x @ params["f1"]["w"] + params["f1"]["b"])
    return h @ params["f2"]["w"] + params["f2"]["b"]


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy of integer ``labels``."""
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels[:, None].long())[:, 0]
    return (lse - picked).mean()


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Fraction of rows whose argmax is the label."""
    return (logits.argmax(-1) == labels).to(torch.float32).mean()


MODEL_REGISTRY = {
    "femnist_cnn": (init_femnist_cnn, apply_femnist_cnn),
    "vgg11": (init_vgg11, apply_vgg11),
    "mlp": (init_mlp_classifier, apply_mlp_classifier),
}
