"""The port's flat-npz checkpoints (``repro_torch.checkpoint.ckpt``):
twins of ``tests/test_optim_ckpt.py``'s checkpoint tests, and archives
crossing between the packages both ways.

The port writes and reads bfloat16 (and float8) leaves without
``ml_dtypes``, which the GPU machine lacks: a torch bf16 tensor is stored
as its uint16 view tagged ``"bfloat16"`` in ``__dtypes__``, the
reference's own tag, and comes back as a torch bf16 tensor, bit for
bit."""
import os
import subprocess
import sys

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import load_checkpoint as ref_load
from repro.checkpoint.ckpt import save_checkpoint as ref_save
from repro_torch.checkpoint.ckpt import (CheckpointStructureError,
                                         load_checkpoint, save_checkpoint)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def test_checkpoint_roundtrip(tmp_path):
    tree = {"layer": {"w": np.random.randn(4, 3).astype(np.float32),
                      "b": np.zeros(3, np.float32)},
            "step": np.asarray(7),
            "stack": [np.arange(3), torch.arange(4, dtype=torch.float64)]}
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, tree, {"arch": "test"})
    loaded, meta = load_checkpoint(path, like=tree)
    assert meta["arch"] == "test"
    np.testing.assert_array_equal(loaded["layer"]["w"], tree["layer"]["w"])
    assert loaded["step"] == 7 and loaded["step"].dtype == tree["step"].dtype
    np.testing.assert_array_equal(loaded["stack"][0], tree["stack"][0])
    # a torch leaf of ``like`` comes back as a torch tensor
    assert isinstance(loaded["stack"][1], torch.Tensor)
    assert torch.equal(loaded["stack"][1], tree["stack"][1])
    flat, _ = load_checkpoint(path)
    assert sorted(flat) == ["/layer/b", "/layer/w", "/stack/#0",
                            "/stack/#1", "/step"]


def test_checkpoint_preserves_extension_dtypes(tmp_path):
    """bf16 and float8 tensors round-trip as themselves; exact integer
    dtypes survive too."""
    tree = {"w_bf16": torch.randn(3, 4).to(torch.bfloat16),
            "w_f8": torch.ones(5).to(torch.float8_e4m3fn),
            "step": np.asarray(7, np.int32),
            "mask": np.array([1, 0, 1], np.int64)}
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, tree)
    loaded, _ = load_checkpoint(path, like=tree)
    for k in ("w_bf16", "w_f8"):
        assert loaded[k].dtype == tree[k].dtype, k
        assert torch.equal(loaded[k].view(torch.uint8),
                           tree[k].view(torch.uint8)), k
    for k in ("step", "mask"):
        assert loaded[k].dtype == tree[k].dtype
        np.testing.assert_array_equal(loaded[k], tree[k])


def test_bf16_without_ml_dtypes(tmp_path):
    """In a process where ``ml_dtypes`` cannot be imported (as on the GPU
    machine), a bf16 leaf saves and loads bit for bit."""
    path = str(tmp_path / "ckpt.npz")
    code = (
        "import sys\n"
        "sys.modules['ml_dtypes'] = None\n"
        "import torch\n"
        "from repro_torch.checkpoint import load_checkpoint, "
        "save_checkpoint\n"
        "t = torch.randn(5, 7).to(torch.bfloat16)\n"
        f"save_checkpoint({path!r}, {{'w': t}})\n"
        f"got, _ = load_checkpoint({path!r}, like={{'w': t}})\n"
        "assert got['w'].dtype == torch.bfloat16\n"
        "assert torch.equal(got['w'].view(torch.int16), "
        "t.view(torch.int16))\n"
        "assert 'ml_dtypes' not in [k for k, v in sys.modules.items() "
        "if v]\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_checkpoint_structure_error_names_keys(tmp_path):
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, {"a": np.ones(3), "optim": {"mu": np.zeros(2)}})
    like = {"a": np.ones(3), "optim": {"nu": np.zeros(2)}}
    with pytest.raises(CheckpointStructureError) as ei:
        load_checkpoint(path, like=like)
    assert ei.value.missing == ("/optim/nu",)
    assert ei.value.extra == ("/optim/mu",)
    assert "/optim/nu" in str(ei.value) and "/optim/mu" in str(ei.value)
    assert isinstance(ei.value, ValueError)


def test_checkpoint_save_is_atomic(tmp_path, monkeypatch):
    """A save that dies mid-write leaves the previous checkpoint intact
    and no temp litter."""
    path = str(tmp_path / "ckpt.npz")
    old = {"w": np.full(4, 1.0, np.float32)}
    save_checkpoint(path, old, {"gen": 0})
    before = os.listdir(tmp_path)
    real_savez = np.savez

    def dying_savez(f, **kw):
        real_savez(f, **kw)   # bytes hit the temp file...
        raise OSError("disk died mid-save")

    monkeypatch.setattr(np, "savez", dying_savez)
    with pytest.raises(OSError, match="disk died"):
        save_checkpoint(path, {"w": np.full(4, 2.0, np.float32)},
                        {"gen": 1})
    monkeypatch.undo()
    assert sorted(os.listdir(tmp_path)) == sorted(before)
    loaded, meta = load_checkpoint(path, like=old)
    assert meta["gen"] == 0
    np.testing.assert_array_equal(loaded["w"], old["w"])


def test_reference_archive_loads_in_the_port(tmp_path):
    """An archive the reference wrote (bf16 as ml_dtypes) loads in the
    port: the bf16 leaf as a torch.bfloat16 tensor with the same bits."""
    w = np.random.randn(6, 5).astype(ml_dtypes.bfloat16)
    tree = {"w": w, "n": [np.arange(4, dtype=np.int64)],
            "x": np.linspace(0, 1, 9, dtype=np.float32)}
    path = str(tmp_path / "ref.npz")
    ref_save(path, tree, {"by": "reference"})
    like = {"w": torch.zeros(6, 5, dtype=torch.bfloat16),
            "n": [np.zeros(4, np.int64)], "x": np.zeros(9, np.float32)}
    got, meta = load_checkpoint(path, like=like)
    assert meta == {"by": "reference"}
    assert got["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["w"].view(torch.uint16).numpy(),
                                  w.view(np.uint16))
    np.testing.assert_array_equal(got["n"][0], tree["n"][0])
    np.testing.assert_array_equal(got["x"], tree["x"])


def test_port_archive_loads_in_the_reference(tmp_path):
    """An archive the port wrote (torch bf16 and f32 leaves) loads in the
    reference's ``load_checkpoint(like=...)``, bf16 as ml_dtypes."""
    t = torch.randn(3, 8).to(torch.bfloat16)
    tree = {"w": t, "b": torch.arange(8, dtype=torch.float32),
            "step": np.asarray(3, np.int64)}
    path = str(tmp_path / "port.npz")
    save_checkpoint(path, tree, {"by": "port"})
    like = {"w": np.zeros((3, 8), ml_dtypes.bfloat16),
            "b": np.zeros(8, np.float32), "step": np.asarray(0, np.int64)}
    got, meta = ref_load(path, like=like)
    assert meta == {"by": "port"}
    assert got["w"].dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(got["w"].view(np.uint16),
                                  t.view(torch.uint16).numpy())
    np.testing.assert_array_equal(got["b"], tree["b"].numpy())
    assert int(got["step"]) == 3
