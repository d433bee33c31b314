"""The plain reference of a CE-FedAvg round over n device models of a
LEAF-style CNN (two 5x5 SAME convolutions, each with ReLU and a 2x2 max
pool, then two dense layers), in plain torch.

Written from the paper (arXiv:2205.13054, Algorithm 1 and eq. 10/11)
and the configuration file alone; it imports nothing of the program.
Its state is the (n, T) matrix of device models in the configuration's
leaf order, with momentum and, with error feedback, a residual:

- a local step: every device's gradient of its mean cross entropy on its
  own batch (n models at once by grouped convolutions and batched
  products), M <- mu M + G, Y <- Y - lr M;
- a block: tau local steps, then the intra-cluster average V; the q-th
  block also the inter-cluster gossip W = B^T diag(1/c) H^pi B over the
  Metropolis matrix H of the backhaul ring;
- with an upload, the block sends delta = Y - Y0 per device: per leaf an
  absmax int8 scale, stochastic rounding floor(x / s + u) with uniforms
  from the key stream, clipped to [-127, 127]; what is not sent stays in
  the residual; Y <- Y0 + V sent;
- the round ends with the evaluation of the m edge models (cluster
  averages) on the common test set.

The batch indices and the uniforms come from the frozen key stream in
``keys.py``, keyed as the program keys its rounds. ``dtype`` runs the
model's arithmetic in a lower precision and ``precision`` "tf32" lets
the products and convolutions round their inputs to TF32 (the
controls); ``fault`` plants one of the faults the comparison has to
catch. The state is f32, and in float32 TF32 is off.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from perfbench import gen
from perfbench.reference import keys as K

#: faults a calibration can plant: a round that leaves the state as it
#: was, half of each batch left out (the mean over the rest), the mixing
#: between devices left out
FAULTS = ("frozen", "half_batch", "no_mix")


#: the precisions the reference computes in: float32 (TF32 off), and the
#: controls below it
PRECISIONS = {"f32": (torch.float32, False), "tf32": (torch.float32, True),
              "bfloat16": (torch.bfloat16, False)}


@contextlib.contextmanager
def tf32(on: bool):
    """PyTorch's TF32 switches for products and convolutions set to
    ``on``, restored after."""
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def operators(cfg: Dict) -> Dict[str, np.ndarray]:
    """V (n, n), W (n, n) and the edge projection P (m, n), float64."""
    m, d = cfg["num_clusters"], cfg["devices_per_cluster"]
    if cfg["topology"] != "ring" or cfg["mixing"] != "metropolis":
        raise ValueError("the reference builds the Metropolis ring only")
    adj = np.zeros((m, m), bool)
    for i in range(m):
        adj[i, (i + 1) % m] = adj[(i + 1) % m, i] = True
    if m == 1:
        adj[0, 0] = False
    deg = adj.sum(1)
    H = np.zeros((m, m))
    for i in range(m):
        for j in np.nonzero(adj[i])[0]:
            H[i, j] = 1.0 / (max(deg[i], deg[j]) + 1.0)
    np.fill_diagonal(H, 1.0 - H.sum(1))
    if m == 1:
        H = np.ones((1, 1))
    B = np.kron(np.eye(m), np.ones((1, d)))          # (m, n)
    P = B / d
    V = B.T @ P
    W = B.T @ (np.linalg.matrix_power(H, cfg["pi"]) @ P)
    return {"V": V, "W": W, "P": P}


def _leaves(cfg: Dict, Y: torch.Tensor) -> Dict[str, torch.Tensor]:
    """(k, *shape) views of the k rows of Y, by leaf name."""
    return {name: Y[:, off:off + size].view((Y.shape[0],) + shape)
            for name, shape, off, size in gen.leaf_layout(cfg["leaves"])}


def logits(cfg: Dict, Y: torch.Tensor, x: torch.Tensor,
           dtype: torch.dtype) -> torch.Tensor:
    """(k, B, classes) logits of k models (the rows of Y) on their own
    images x (k, B, H, W, C), in ``dtype``."""
    p = {k: v.to(dtype) for k, v in _leaves(cfg, Y).items()}
    k, B = x.shape[:2]
    h = x.to(dtype).permute(1, 0, 4, 2, 3).reshape(
        B, k * x.shape[-1], x.shape[2], x.shape[3])
    for c in ("c1", "c2"):
        w = p[f"{c}.w"]                                # (k, kh, kw, i, o)
        _, kh, kw, ci, co = w.shape
        w = w.permute(0, 4, 3, 1, 2).reshape(k * co, ci, kh, kw)
        h = F.conv2d(h, w, p[f"{c}.b"].reshape(-1), padding=kh // 2,
                     groups=k)
        h = F.max_pool2d(F.relu(h), 2, 2)
    ch = h.shape[1] // k
    h = h.view(B, k, ch, h.shape[2], h.shape[3]).permute(1, 0, 3, 4, 2)
    h = h.reshape(k, B, -1)
    h = F.relu(torch.bmm(h, p["f1.w"]) + p["f1.b"][:, None])
    return torch.bmm(h, p["f2.w"]) + p["f2.b"][:, None]


def xent(z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(k,) mean cross entropy of each model's (B, classes) logits."""
    z = z.float()
    lse = torch.logsumexp(z, dim=-1)
    return (lse - z.gather(-1, y[..., None])[..., 0]).mean(-1)


class CNNRounds:
    """The reference's run: ``round()`` advances one global round and
    returns its evaluated (loss, accuracy)."""

    def __init__(self, cfg: Dict, mix: Dict, seed: int, data: Dict,
                 row: torch.Tensor, *, dtype: torch.dtype = torch.float32,
                 fault: Optional[str] = None):
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"fault {fault!r} not in {FAULTS}")
        self.cfg, self.dtype, self.fault = cfg, dtype, fault
        a = cfg["assumed"]
        self.lr, self.mu = a["lr"], cfg["momentum"]
        self.batch, self.eval_batch = a["batch"], a["eval_batch"]
        self.tau, self.q = cfg["tau"], cfg["q"]
        dev = row.device
        self.dev = dev
        self.n = cfg["num_clusters"] * cfg["devices_per_cluster"]
        self.xs = torch.as_tensor(data["xs"]).to(dev)
        self.ys = torch.as_tensor(data["ys"]).to(dev).long()
        self.tx = torch.as_tensor(data["test_x"][:self.eval_batch]).to(dev)
        self.ty = torch.as_tensor(data["test_y"][:self.eval_batch]
                                  ).to(dev).long()
        ops = operators(cfg)
        self.V = torch.as_tensor(ops["V"], dtype=torch.float32, device=dev)
        self.WV = torch.as_tensor(ops["W"] @ ops["V"], dtype=torch.float32,
                                  device=dev)
        self.W = torch.as_tensor(ops["W"], dtype=torch.float32, device=dev)
        self.P = torch.as_tensor(ops["P"], dtype=torch.float32, device=dev)
        self.Y = row[None].repeat(self.n, 1)
        self.M = torch.zeros_like(self.Y)
        comp = mix.get("compression")
        self.comp = comp
        self.R = (torch.zeros_like(self.Y)
                  if comp and comp.get("error_feedback") else None)
        self.key = K.prng_key(seed + 1)
        #: leaf norms of the momentum after the first local step (the
        #: first gradient) and of the residual after the first upload
        self.first: Dict[str, List[float]] = {}
        self.segments = [(off, size) for _, _, off, size in
                         gen.leaf_layout(cfg["leaves"])]

    # -- one local step of all n devices -------------------------------
    def _grad(self, idx: torch.Tensor) -> torch.Tensor:
        rows = torch.arange(self.n, device=self.dev)[:, None]
        if self.fault == "half_batch":
            idx = idx[:, :idx.shape[1] // 2]
        x, y = self.xs[rows, idx], self.ys[rows, idx]
        Yg = self.Y.detach().requires_grad_(True)
        loss = xent(logits(self.cfg, Yg, x, self.dtype), y).sum()
        (g,) = torch.autograd.grad(loss, Yg)
        return g

    def _local_step(self, idx: torch.Tensor) -> None:
        g = self._grad(idx)
        self.M.mul_(self.mu).add_(g)
        self.Y.sub_(self.M, alpha=self.lr)
        if "grad" not in self.first:
            self.first["grad"] = leaf_norms(self.cfg, self.M)

    def _mix(self, W: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
        if self.fault == "no_mix":
            return X
        return W @ X

    # -- the upload --------------------------------------------------------
    def _int8(self, delta: torch.Tensor, key: np.ndarray) -> torch.Tensor:
        """What every device sends of its ``delta`` (n, T); the residual is
        updated in place."""
        row_keys = K.split(K.fold_in(key, 1), self.n)        # (n, 2)
        seg_keys = K.split(row_keys, len(self.segments))      # (n, s, 2)
        sent = torch.empty_like(delta)
        stochastic = self.comp.get("stochastic", True)
        for j, (off, size) in enumerate(self.segments):
            for lo in range(0, self.n, _ROW_CHUNK):
                hi = min(lo + _ROW_CHUNK, self.n)
                src = delta[lo:hi, off:off + size]
                if self.R is not None:
                    src = src + self.R[lo:hi, off:off + size]
                scale = src.abs().amax(-1, keepdim=True).clamp_min(
                    1e-12) / 127.0
                y = src / scale
                if stochastic:
                    y = torch.floor(y + K.device_uniform(
                        seg_keys[lo:hi, j], size, self.dev))
                else:
                    y = torch.round(y)
                out = y.clamp(-127, 127) * scale
                sent[lo:hi, off:off + size] = out
                if self.R is not None:
                    self.R[lo:hi, off:off + size] = src - out
        if self.R is not None and "residual" not in self.first:
            self.first["residual"] = leaf_norms(self.cfg, self.R)
        return sent

    # -- one round ---------------------------------------------------------
    def round(self):
        if self.comp and self.comp.get("kind") != "int8":
            raise ValueError("the reference uploads int8 only")
        keys = K.split(self.key)
        self.key, rkey = keys[0], keys[1]
        bkeys = K.split(rkey, self.q)
        steps = np.concatenate([K.split(bk, self.tau) for bk in bkeys])
        N = self.xs.shape[1]
        idx = torch.from_numpy(K.randint(steps, (self.n, self.batch), 0, N)
                               ).to(self.dev)
        if self.fault != "frozen":
            for b in range(self.q):
                Y0 = self.Y.clone() if self.comp else None
                for s in range(self.tau):
                    self._local_step(idx[b * self.tau + s])
                last = b == self.q - 1
                if self.comp:
                    sent = self._int8(self.Y - Y0, K.fold_in(bkeys[b], 7))
                    self.Y = Y0 + self._mix(self.V, sent)
                    del sent, Y0
                    if last:
                        self.Y = self._mix(self.W, self.Y)
                else:
                    self.Y = self._mix(self.WV if last else self.V, self.Y)
        return self.evaluate()

    @torch.no_grad()
    def evaluate(self):
        edge = self.P @ self.Y
        m = edge.shape[0]
        x = self.tx[None].expand((m,) + tuple(self.tx.shape))
        z = logits(self.cfg, edge, x, self.dtype).float()
        y = self.ty[None].expand(m, -1)
        acc = (z.argmax(-1) == y).float().mean()
        return float(xent(z, y).mean()), float(acc)


#: device rows an upload step encodes at once (bounds its temporaries)
_ROW_CHUNK = 16


def leaf_norms(cfg: Dict, X: torch.Tensor,
               minus: Optional[torch.Tensor] = None) -> List[float]:
    """The norm of each leaf of the (n, T) state X over all n rows (of X
    minus the row ``minus``, where given), in f64 on the host."""
    out = []
    for _, _, off, size in gen.leaf_layout(cfg["leaves"]):
        sq = 0.0
        for lo in range(0, X.shape[0], 8):
            blk = X[lo:lo + 8, off:off + size]
            if minus is not None:
                blk = blk - minus[off:off + size]
            sq += float(torch.linalg.vector_norm(blk, dim=1).double()
                        .square().sum())
        out.append(sq ** 0.5)
    return out


def run(cfg: Dict, mix: Dict, seed: int, data: Dict, row: torch.Tensor,
        rounds: int, *, precision: str = "f32",
        fault: Optional[str] = None) -> Dict:
    """The readings the comparison takes of ``rounds`` rounds: each
    round's evaluated loss; every leaf's norm of the first gradient (the
    momentum after the first local step), of the residual after the
    first upload (with error feedback), and of the change of the device
    models after the last round."""
    dtype, on = PRECISIONS[precision]
    with tf32(on):
        r = CNNRounds(cfg, mix, seed, data, row, dtype=dtype, fault=fault)
        out: Dict = {"loss": [], "acc": []}
        for _ in range(rounds):
            loss, acc = r.round()
            out["loss"].append(loss)
            out["acc"].append(acc)
        out.update(r.first)
        out["change"] = leaf_norms(cfg, r.Y, minus=row)
    return out
