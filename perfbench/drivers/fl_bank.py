"""Driver of the FL simulator on its resident bank: the paper's
CE-FedAvg round over n device models (``FLSimulator`` with a flat
``(n, T)`` ModelBank, one round a call of ``run_wall_clock(sim, rt, 1)``,
evaluation included), optionally with compressed uploads.

Set-up builds the simulator once from the seed's data and weights and
drives it through its first rounds, which the reference follows; the
window then continues on that same simulator.
"""
from __future__ import annotations

import contextlib
import gc
import math
import time
from typing import Dict, Optional

import torch

from perfbench import compare as C
from perfbench import gen
from perfbench.reference import fl_cnn


def _tree(cfg: Dict, row: torch.Tensor) -> Dict:
    """The model's parameter tree ({"c1": {"w": .., "b": ..}, ..}) on
    the leaves of the flat row."""
    tree: Dict = {}
    for name, leaf in gen.split_leaves(cfg["leaves"], row).items():
        outer, inner = name.split(".")
        tree.setdefault(outer, {})[inner] = leaf
    return tree


@contextlib.contextmanager
def _nothing():
    yield


@contextlib.contextmanager
def _first_states(cfg: Dict, sim, prog: Dict):
    """Spans around the first round's calls into the local step and the
    upload's compression: every leaf's norm of the momentum after the
    first local step (the first gradient, as the optimizer holds it)
    and of the residual the first upload leaves."""
    from repro_torch.core import compress as cmp
    sgd, compress = sim._sgd_step, cmp.compress_flat

    def first_step(Y, M, *args):
        sgd(Y, M, *args)
        if "grad" not in prog:
            prog["grad"] = fl_cnn.leaf_norms(cfg, M)

    def first_upload(*args, **kw):
        sent, res = compress(*args, **kw)
        if res is not None and "residual" not in prog:
            prog["residual"] = fl_cnn.leaf_norms(cfg, res)
        return sent, res
    sim._sgd_step, cmp.compress_flat = first_step, first_upload
    try:
        yield
    finally:
        del sim._sgd_step
        cmp.compress_flat = compress


def setup(cfg: Dict, mix: Dict, seed: int, device: torch.device,
          first_steps: int) -> Dict:
    t0 = time.perf_counter()
    from repro_torch.config import FLConfig
    from repro_torch.core.cefedavg import FLSimulator
    from repro_torch.core.clock import run_wall_clock
    from repro_torch.core.compress import CompressionConfig
    from repro_torch.core.runtime import paper_runtime_model
    from repro_torch.models.cnn import MODEL_REGISTRY

    a = cfg["assumed"]
    # the program runs in the precision the configuration states
    torch.backends.cudnn.allow_tf32 = cfg["tf32"]
    torch.backends.cuda.matmul.allow_tf32 = cfg["tf32"]
    data = gen.fl_images(cfg, mix, seed)
    row = gen.flat_weights(cfg["leaves"], seed, device)
    tree = _tree(cfg, row)
    fl = FLConfig(algorithm="ce_fedavg", num_clusters=cfg["num_clusters"],
                  devices_per_cluster=cfg["devices_per_cluster"],
                  tau=cfg["tau"], q=cfg["q"], pi=cfg["pi"],
                  topology=cfg["topology"], mixing=cfg["mixing"])
    comp = mix.get("compression")
    sim = FLSimulator(
        lambda _gen: tree, MODEL_REGISTRY[cfg["model"]][1], fl, data,
        lr=a["lr"], momentum=cfg["momentum"], batch_size=a["batch"],
        seed=seed, device=device,
        compression=None if comp is None else CompressionConfig(**comp))
    want = [(off, size) for _, _, off, size in
            gen.leaf_layout(cfg["leaves"])]
    if [tuple(s) for s in sim.layout.segments] != want:
        raise RuntimeError(f"the program's layout {sim.layout.segments} is "
                           f"not the configuration's {want}")
    st = {"cfg": cfg, "mix": mix, "seed": seed, "device": device,
          "sim": sim, "rt": paper_runtime_model(), "row": row,
          "first_steps": first_steps, "run": run_wall_clock}
    t1 = time.perf_counter()
    prog: Dict = {"loss": [], "acc": []}
    for i in range(first_steps):
        with _first_states(cfg, sim, prog) if i == 0 else _nothing():
            hist = run_wall_clock(sim, st["rt"], 1)
        prog["loss"].append(float(hist["loss"][-1]))
        prog["acc"].append(float(hist["acc"][-1]))
    t2 = time.perf_counter()
    prog["change"] = fl_cnn.leaf_norms(cfg, sim.bank.params, minus=row)
    st["prog"] = prog
    st["setup_parts"] = {"imports_data_weights_simulator": t1 - t0,
                         "first_rounds": t2 - t1,
                         "norms": time.perf_counter() - t2}
    return st


def step(st: Dict) -> Dict:
    """One round with its evaluation, ended in a synchronize."""
    hist = st["run"](st["sim"], st["rt"], 1)
    if st["device"].type == "cuda":
        torch.cuda.synchronize(st["device"])
    loss = float(hist["loss"][-1])
    return {"rounds": 1, "ok": math.isfinite(loss), "loss": loss,
            "eval_s": float(hist["eval_s"][-1])}


def counters(st: Dict) -> Dict[str, int]:
    """The program's own counters (cumulative)."""
    from repro_torch.kernels import gossip_mix
    return {"b1_launches": gossip_mix.launches}


def release(st: Dict) -> None:
    st.pop("sim", None)
    st.pop("row", None)
    gc.collect()
    if st["device"].type == "cuda":
        torch.cuda.synchronize(st["device"])
        torch.cuda.empty_cache()


def reference(cfg: Dict, mix: Dict, seed: int, device: torch.device,
              rounds: int, precision: str = "f32",
              fault: Optional[str] = None) -> Dict:
    """The plain reference's readings of the first ``rounds`` rounds, on
    the same data and weights, made again from the seed, in float32 or
    in a control's ``precision``."""
    data = gen.fl_images(cfg, mix, seed)
    row = gen.flat_weights(cfg["leaves"], seed, device)
    return fl_cnn.run(cfg, mix, seed, data, row, rounds,
                      precision=precision, fault=fault)


def gaps(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers a comparison may take (its limits file says which):
    the first round's loss and every round's; by leaf, the first
    gradient (and the residual of the first upload) and the change of
    the device models after the last round."""
    leaves = C.counted(ref["grad"])
    out = {"loss1_gap": C.loss_gap(prog["loss"][:1], ref["loss"][:1]),
           "loss_gap": C.loss_gap(prog["loss"], ref["loss"]),
           "grad_gap": C.norm_gap(prog.get("grad", []), ref["grad"],
                                  leaves),
           "change_gap": C.norm_gap(prog["change"], ref["change"], leaves)}
    if "residual" in ref:
        out["residual_gap"] = C.norm_gap(prog.get("residual", []),
                                         ref["residual"], leaves)
    return out


def readings(st: Dict) -> Dict[str, float]:
    """The gaps between the program's first rounds and the reference's;
    the program's state has been released."""
    t0 = time.perf_counter()
    ref = reference(st["cfg"], st["mix"], st["seed"], st["device"],
                    st["first_steps"])
    st["reference_s"] = time.perf_counter() - t0
    return gaps(st["prog"], ref)
