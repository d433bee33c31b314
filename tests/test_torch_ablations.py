"""``kernel_ablations.py`` cuts parts out of the committed kernel
sources by text substitution; each substitution must still match its
source (and the script must import without a card), or the ablation
run on the GPU stops."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import kernel_ablations as ka  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

CASES = [(source, name, cuts) for _, source, table, _ in ka.KERNELS
         for name, cuts in table.items()]


@pytest.mark.parametrize("source,name,cuts", CASES,
                         ids=[f"{s.split('.')[0]}-{n}" for s, n, _ in CASES])
def test_ablation_cuts_match_the_sources(source, name, cuts):
    text = (_build.CSRC / source).read_text()
    for old, new in cuts:
        assert text.count(old) == 1, (name, old[:60])
        assert old != new
