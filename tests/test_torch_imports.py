"""The port stands alone: ``repro_torch``, its examples and
``chip_smoke.py`` import neither JAX nor the JAX package (nor
``ml_dtypes``, which the GPU machine lacks), its entry points default to
the CUDA
card (raising without one instead of falling back to the CPU), and
``chip_smoke.py`` fails, printing no result, where there is no card or
no repository around it."""
import ast
import os
import pkgutil
import shutil
import subprocess
import sys

import pytest
import torch

import repro_torch

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PKG = os.path.join(REPO, "src", "repro_torch")
STANDALONE = [os.path.join(REPO, "chip_smoke.py"),
              os.path.join(REPO, "tp_depth_check.py"),
              os.path.join(REPO, "examples", "quickstart_torch.py"),
              os.path.join(REPO, "examples",
                           "compressed_federated_torch.py"),
              os.path.join(REPO, "examples", "serve_batched_torch.py"),
              os.path.join(REPO, "examples", "topology_study_torch.py"),
              os.path.join(REPO, "examples", "train_lm_federated_torch.py")]


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def _sources():
    out = list(STANDALONE)
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    return env


def test_every_module_imports_without_jax():
    mods = _modules()
    assert {"repro_torch.core.cefedavg", "repro_torch.kernels.gossip_mix",
            "repro_torch.random", "repro_torch.launch.time_to_accuracy",
            "repro_torch.core.compress", "repro_torch.core.privacy",
            "repro_torch.checkpoint", "repro_torch.checkpoint.ckpt",
            "repro_torch.checkpoint.runckpt",
            "repro_torch.core.collectives", "repro_torch.core.groups",
            "repro_torch.core.sharded", "repro_torch.launch.mesh",
            "repro_torch.optim", "repro_torch.optim.optimizers",
            "repro_torch.launch.train", "repro_torch.data.lm"} <= set(mods)
    code = ("import sys, importlib, runpy\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "sys.modules['ml_dtypes'] = None\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            f"sys.path.insert(0, {REPO!r})\n"
            "import chip_smoke\n"
            f"for p in {STANDALONE[1:]!r}:\n"
            "    runpy.run_path(p, run_name='example')\n"
            "assert not any(k in ('jax', 'ml_dtypes')\n"
            "               or k.startswith(('jax.', 'repro.'))\n"
            "               for k, v in sys.modules.items() if v)\n"
            "print('imported', len(sys.modules))\n")
    res = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "imported" in res.stdout


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                bad.append(name)
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_default_device_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default is taken")
    from repro_torch.core.modelbank import ModelBank
    from repro_torch.device import resolve_device
    from repro_torch.launch import time_to_accuracy as cli
    for call in (lambda: resolve_device(),
                 lambda: ModelBank.from_model({"w": torch.ones(3)}, 2),
                 lambda: cli.main(["--rounds", "1"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")


def test_lm_trainer_entry_points_raise_without_cuda():
    """``--engine pytree`` (the launcher's default), the LM example and
    the trainer's world default to the card; ``--device cpu`` runs."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default is taken")
    import runpy
    from repro_torch.launch import mesh as lm
    from repro_torch.launch import train
    for argv in (["--reduced", "--rounds", "1"],
                 ["--engine", "pytree", "--reduced", "--rounds", "1",
                  "--data-parallel", "2", "--dist-backend", "gloo"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            train.main(argv)
    example = runpy.run_path(STANDALONE[-1], run_name="example")
    with pytest.raises(RuntimeError, match="CUDA"):
        example["main"](["--smoke"])
    with pytest.raises(RuntimeError, match="CUDA"):
        with lm.single_rank_world("gloo"):
            pass
    out = train.main(["--reduced", "--rounds", "1", "--dist-backend",
                      "gloo", "--device", "cpu"])
    assert out["rank"] == 0 and len(out["hist"]["loss"]) == 1


def test_lm_example_smoke_on_cpu(capsys):
    import runpy
    example = runpy.run_path(STANDALONE[-1], run_name="example")
    losses = example["main"](["--smoke", "--device", "cpu"])
    assert len(losses) == 2 and losses[1] < losses[0]
    assert "done" in capsys.readouterr().out


def test_chip_smoke_fails_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    res = subprocess.run([sys.executable, os.path.join(REPO,
                                                       "chip_smoke.py")],
                         env=_env(), capture_output=True, text=True,
                         timeout=120, cwd=REPO)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """Copied into a directory that holds nothing else of the
    repository, the script cannot run the port and prints no result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "chip_smoke.py"], env=env,
                         capture_output=True, text=True, timeout=120,
                         cwd=tmp_path)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_kernel_build_is_lazy_and_keyed_by_source():
    """Importing the kernels builds nothing; the library name follows
    the source hash, inside the ignored build directory."""
    from repro_torch.kernels import _build
    path = _build.library_path("gossip_mix")
    assert path.parent == _build.BUILD
    assert path.name.startswith("libgossip_mix-") and path.suffix == ".so"
    assert path == _build.library_path("gossip_mix")
    ignored = open(os.path.join(REPO, ".gitignore")).read().split()
    assert "src/repro_torch/kernels/_build/" in ignored
    assert "-gencode" in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
