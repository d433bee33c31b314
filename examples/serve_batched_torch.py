"""Batched serving example of the PyTorch port: prefill + decode with
per-family caches for a reduced SSM (mamba2) and a reduced GQA (qwen2)
model, through the port's serve driver (``repro_torch.launch.serve``).
Twin of ``examples/serve_batched.py``; on the CUDA card unless
``--device`` says otherwise.

  PYTHONPATH=src python examples/serve_batched_torch.py
  PYTHONPATH=src python examples/serve_batched_torch.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch.serve import main as serve_main  # noqa: E402


def main(archs=("mamba2-2.7b", "qwen2-0.5b"), device="cuda"):
    """Serves each arch of ``archs``; returns the serve driver's result
    by arch."""
    out = {}
    for arch in archs:
        print(f"\n=== serving {arch} (reduced) ===")
        out[arch] = serve_main(["--arch", arch, "--reduced", "--batch", "2",
                                "--prompt-len", "16", "--decode-tokens", "8",
                                "--max-seq", "64", "--device", device])
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the CUDA card)")
    main(device=ap.parse_args().device)
