"""The port's example twins against the reference's examples on the CPU:
``examples/topology_study_torch.py`` at one round prints the traffic
table of ``examples/topology_study.py`` (topology, π, ζ, the Ω terms and
the MB a round of each gossip lowering) row for row; the accuracy column
differs by construction (each package draws its own init weights)."""
import importlib.util
import os

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(EXAMPLES, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _table(out: str):
    """The table's rows without the accuracy column."""
    rows = []
    for line in out.splitlines():
        cols = line.split()
        if len(cols) == 9 and cols[1].isdigit():
            rows.append(cols[:5] + cols[6:])
    return rows


def test_topology_study_twin_prints_the_reference_traffic(capsys):
    _load("topology_study").main(rounds=1)
    ref = _table(capsys.readouterr().out)
    rows = _load("topology_study_torch").main(rounds=1, device="cpu")
    port = _table(capsys.readouterr().out)
    assert len(ref) == len(rows) == 4
    assert port == ref
    assert all(0.0 <= r["acc"] <= 1.0 for r in rows)


def test_serve_batched_twin_serves_on_the_cpu(capsys):
    """``examples/serve_batched_torch.py`` (twin of
    ``examples/serve_batched.py``) with ``--device cpu``: reduced
    qwen2-0.5b and mamba2-2.7b, 16 prompt and 8 decoded tokens a row,
    finite logits."""
    out = _load("serve_batched_torch").main(device="cpu")
    assert set(out) == {"qwen2-0.5b", "mamba2-2.7b"}
    for res in out.values():
        assert res["finite"] and tuple(res["tokens"].shape) == (2, 9)
    text = capsys.readouterr().out
    assert "serving mamba2-2.7b (reduced)" in text and "device=cpu" in text
