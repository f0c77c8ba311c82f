"""The control -- the reference in bfloat16, the precision below the
configuration's float32, put in the program's place -- fails the limits:
here at the tiny cells' size, and on the card (a marked test) at each
cell's own size on three seeds."""

import pytest
import torch

from splatbench import control, registry
from splatbench.tests import fixture

CELLS = ["bonsai-1.2m.pass8", "c3dgs-10m.pass8", "bonsai-1.2m.walk", "c3dgs-10m.close8",
         "c3dgs-10m.views4"]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_tiny(tmp_path, name):
    cell = fixture.build(tmp_path).cell("tiny-" + name)
    nums = control.control_numbers(cell, 31, "cpu")
    assert nums["correct"] is False
    assert nums["image_rmse"] > 3 * cell.check["limits"]["image_rmse"]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_full_size(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells' full size")
    cell = registry.Bench.load().cell(name)
    for seed in (41, 42, 43):
        assert control.control_numbers(cell, seed, "cuda")["correct"] is False
