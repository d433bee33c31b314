"""The JAX side of the tensor-parallel tests
(``tests/test_torch_tensor_parallel*.py``): the reference's replicas,
its ``ShardedCEFedAvg`` on a (2, 2) ``("data", "model")`` mesh in a
subprocess with 4 forced host devices (as ``tests/test_sharded.py`` runs
it), ``jax.grad`` of its ``lm_loss``, and the comparisons; the port's
side is ``torch_tp_cases``, run by gloo ranks meanwhile."""
import concurrent.futures
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np

import torch_tp_cases as cases
from repro.models import model as rm
from repro_torch.launch import mesh as lm

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
#: the port's dp 2 x mp 2 rounds against its dp 2 x mp 1 rounds, and
#: lm_loss's gradients at mp 2 against jax.grad
TOL = 1e-5
#: the port's dp 2 x mp 2 rounds against the reference's (2, 2) mesh
#: (the sharded engines' tolerance: GSPMD sums in other orders)
REF_TOL = 2e-4

_REFERENCE = """
import pickle, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
sys.path.insert(0, {here!r})
import torch_tp_cases as cases
from repro.core.sharded import ShardedCEFedAvg

jobs = pickle.load(open(sys.argv[1], "rb"))
mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
out = []
for family, init, batches in jobs:
    tr = ShardedCEFedAvg(cases.experiment("repro", family, 2), mesh)
    params = jax.tree.map(jnp.asarray, init)
    opt = jax.vmap(tr.opt_init)(params)
    shapes = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                          batches[0])
    losses = []
    with mesh:
        fn = jax.jit(tr.make_global_round(),
                     in_shardings=tr.in_shardings(shapes),
                     out_shardings=tr.out_shardings())
        step = jnp.zeros((), jnp.int32)
        for b in batches:
            params, opt, m, step = fn(
                params, opt, {{k: jnp.asarray(v) for k, v in b.items()}},
                step)
            losses.append(float(m["loss"]))
    out.append({{"params": jax.device_get(params),
                "mu": jax.device_get(opt["mu"]), "losses": losses}})
pickle.dump(out, open(sys.argv[2], "wb"))
"""


def ref_init(family: str, R: int):
    """The reference trainer's init: R replicas from split(key 0, R), a
    host tree with a leading replica axis."""
    model = cases.experiment("repro", family, R).model
    keys = jax.random.split(jax.random.PRNGKey(0), R)
    return jax.device_get(jax.vmap(lambda k: rm.init_model(k, model)[0])(
        keys))


def reference_rounds(families, inits, tmpdir: str) -> dict:
    """The reference's ``ShardedCEFedAvg`` on a (2, 2) mesh, ``cases.
    ROUNDS`` rounds of each family from ``inits``: final stacked params,
    ``mu`` and the round losses, by family."""
    src = os.path.join(tmpdir, "jobs.pkl")
    dst = os.path.join(tmpdir, "out.pkl")
    with open(src, "wb") as f:
        pickle.dump([(fam, inits[fam], cases.round_batches(fam, 2))
                     for fam in families], f)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    code = textwrap.dedent(_REFERENCE.format(here=HERE))
    run = subprocess.run([sys.executable, "-c", code, src, dst],
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert run.returncode == 0, run.stdout + "\n" + run.stderr
    with open(dst, "rb") as f:
        return dict(zip(families, pickle.load(f)))


def jax_grads(family: str, init):
    """``jax.value_and_grad`` of the reference's ``lm_loss`` on replica 0
    of ``init`` and ``torch_tp_cases.grad_job``'s batch."""
    model = cases.experiment("repro", family, 1).model
    params = jax.tree.map(lambda a: jnp.asarray(a[0]), init)
    b = {k: jnp.asarray(v) for k, v in
         cases.batch(family, (cases.B,), seed=11).items()}
    loss, g = jax.value_and_grad(lambda p: rm.lm_loss(model, p, b))(params)
    return float(loss), jax.device_get(g)


def run_worlds(world4: list, world2: list, families, inits,
               tmpdir: str) -> dict:
    """The gloo worlds of 4 and 2 ranks (``cases.tp_world`` on each job
    list) and the reference's rounds in their subprocess, all at once,
    with ``jax.grad`` of every family computed here meanwhile."""
    with concurrent.futures.ThreadPoolExecutor(3) as ex:
        w4 = ex.submit(lm.run_local_ranks, cases.tp_world, 4,
                       args=(world4,), device="cpu", timeout_s=600)
        w2 = ex.submit(lm.run_local_ranks, cases.tp_world, 2,
                       args=(world2,), device="cpu", timeout_s=600)
        ref = ex.submit(reference_rounds, families, inits, tmpdir)
        grads = {fam: jax_grads(fam, inits[fam]) for fam in families}
        return {"w4": w4.result(), "w2": w2.result(), "ref": ref.result(),
                "jax_grads": grads}


def gap(a, b) -> float:
    """Max abs difference over two trees' leaves (the port's nested
    dicts or the reference's), in f32."""
    la = jax.tree.leaves(a)
    lb = jax.tree.leaves(b)
    assert len(la) == len(lb)
    return max(float(np.abs(np.asarray(x, np.float32) -
                            np.asarray(y, np.float32)).max())
               for x, y in zip(la, lb))


def by_replica(ranks: list, job: int) -> dict:
    """Job ``job``'s results of each replica's model rank 0."""
    return {r[job]["replica"]: r[job] for r in ranks
            if r[job]["params"] is not None}


def stacked(results: dict, key: str):
    """The replicas' trees (``params`` or ``mu``) stacked on a leading
    replica axis."""
    reps = [results[r][key] for r in sorted(results)]
    return jax.tree.map(lambda *xs: np.stack(xs), *reps)


def world_jobs(families, inits) -> tuple:
    """(the 4-rank world's jobs, the 2-rank world's) for ``families``:
    dp 2 x mp 2 rounds; dp 2 x mp 1 rounds and lm_loss's gradients at
    mp 2."""
    w4 = [("round", f, 2, 2, inits[f]) for f in families]
    w2 = [("round", f, 2, 1, inits[f]) for f in families] + \
        [("grad", f, 2, inits[f]) for f in families]
    return w4, w2


def check_mp1(res, families, fam: str) -> None:
    """dp 2 x mp 2 against dp 2 x mp 1: params, ``mu`` and losses within
    TOL after the rounds, the model group's traffic counted."""
    i = families.index(fam)
    tp, dp = by_replica(res["w4"], i), by_replica(res["w2"], i)
    assert sorted(tp) == sorted(dp) == [0, 1]
    for r in (0, 1):
        g = gap(tp[r]["params"], dp[r]["params"])
        m = gap(tp[r]["mu"], dp[r]["mu"])
        print(f"{fam} replica {r}: mp 2 against mp 1 params {g:.3e}, mu "
              f"{m:.3e}, losses {tp[r]['losses']} / {dp[r]['losses']}")
        assert g < TOL and m < TOL, (g, m)
        np.testing.assert_allclose(tp[r]["losses"], dp[r]["losses"],
                                   atol=TOL, rtol=0)
    for rank in res["w4"]:
        t = rank[i]["traffic"]
        assert t["model"]["all_reduce"]["calls"] > 0
        assert "all_gather" in t["data"]   # the dense mixing
    for rank in res["w2"]:
        assert rank[i]["traffic"]["model"] == {}


def check_reference(res, families, fam: str) -> None:
    """dp 2 x mp 2 against the reference's (2, 2) mesh within REF_TOL."""
    i = families.index(fam)
    tp = by_replica(res["w4"], i)
    ref = res["ref"][fam]
    g = gap(stacked(tp, "params"), ref["params"])
    m = gap(stacked(tp, "mu"), ref["mu"])
    print(f"{fam}: mp 2 against the reference's (2, 2) mesh params {g:.3e},"
          f" mu {m:.3e}, losses {tp[0]['losses']} / {ref['losses']}")
    assert g < REF_TOL and m < REF_TOL, (g, m)
    np.testing.assert_allclose(tp[0]["losses"], ref["losses"],
                               atol=REF_TOL, rtol=0)


def check_grads(res, families, fam: str) -> None:
    """lm_loss and its gradients at mp 2 against jax.grad within TOL."""
    i = len(families) + families.index(fam)
    loss, grads = res["jax_grads"][fam]
    got = [r[i] for r in res["w2"] if r[i]["grads"] is not None]
    assert len(got) == 1
    g = gap(got[0]["grads"], grads)
    print(f"{fam}: lm_loss at mp 2 {got[0]['loss']:.6f} against "
          f"{loss:.6f}, gradients max abs gap {g:.3e}")
    assert abs(got[0]["loss"] - loss) < TOL and g < TOL, g
    assert all(abs(r[i]["loss"] - loss) < TOL for r in res["w2"])
