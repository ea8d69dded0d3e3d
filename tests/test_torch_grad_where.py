"""`scripts/torch_grad_where.py` and the module pinning of `chip_smoke.py`'s
gradient phases, on the CPU at a tiny size: the script's fp64 window
backward follows the plain version, its kink test sees both sides of an
integer, and a run whose every module output is pinned to its own recorded
values gives its gradients bit for bit, while pinned to other values it
keeps its own gradient flow."""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lpi_tpu_torch.ops import deform_window_kernel as dk

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def where():
    sys.path.insert(0, str(REPO))
    spec = importlib.util.spec_from_file_location("torch_grad_where",
                                                  REPO / "scripts" / "torch_grad_where.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_fp64_window_backward_follows_the_plain_version(where):
    g = torch.Generator().manual_seed(0)
    B, H, W, K, C, m = 1, 6, 7, 9, 5, 3
    h = torch.randn(B, H, W, K * C, generator=g)
    oy, ox = (torch.randn(B, K, H, W, generator=g) for _ in range(2))
    gate, ct = torch.rand(B, K, H, W, generator=g), torch.randn(B, H, W, C, generator=g)
    want = dk.window_accumulate_taps_inpad_backward_reference(h, oy, ox, gate, ct, m, K, 3)
    got = where.window_backward_fp64(h, oy, ox, gate, ct, m, K, 3)
    for a, b in zip(got, want[1:]):
        assert a.dtype == torch.float64
        assert where.rel(b.double().numpy(), a.numpy()) < 1e-6


def test_kink_sides_marks_two_sides_of_an_integer(where):
    a = torch.tensor([0.0, 1e-9, -1e-9, 0.5, 2.0, 0.999])
    b = torch.tensor([1e-9, 1e-9, 1e-9, 0.6, 2.0, 1.001])
    assert where.kink_sides(a, b).tolist() == [True, False, True, False, False, True]


def _tiny_grounding():
    from lpi_tpu_torch import config as tc
    from tests.test_torch_baseline_grounding import _batch, _tiny

    return _tiny(tc, "sprompts"), {k: v[:1] for k, v in _batch().items()}


def test_pinning_each_module_to_its_own_outputs_changes_no_bit():
    import chip_smoke

    cfg, one = _tiny_grounding()
    outputs = []
    losses, grads = chip_smoke._grounding_grads(cfg, one, "cpu",
                                                chip_smoke.outputs_recorded(outputs))
    pin, worst = chip_smoke.outputs_pinned(outputs)
    again, pinned = chip_smoke._grounding_grads(cfg, one, "cpu", pin)
    assert len(worst) == len(outputs) > 100 and max(worst) == 0.0
    assert again == losses
    for n in grads:
        np.testing.assert_array_equal(pinned[n], grads[n])


def test_pinned_outputs_set_the_forward_and_keep_the_gradient_flow():
    """Outputs pinned to other values move the loss, and the pool leaves
    still get a gradient through every pinned module."""
    import chip_smoke

    cfg, one = _tiny_grounding()
    outputs = []
    losses, grads = chip_smoke._grounding_grads(cfg, one, "cpu",
                                                chip_smoke.outputs_recorded(outputs))
    pin, _ = chip_smoke.outputs_pinned([o * 1.01 for o in outputs])
    moved, pinned = chip_smoke._grounding_grads(cfg, one, "cpu", pin)
    assert moved["total"] != losses["total"]
    for n in grads:
        assert np.abs(pinned[n]).sum() > 0 and not np.array_equal(pinned[n], grads[n]), n
