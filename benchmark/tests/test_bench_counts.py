"""The operation counts that the `mfu` metrics divide by, against
`torch.utils.flop_counter.FlopCounterMode` over the plain reference at
small sizes."""

import pytest
import torch

from benchmark.counts import clip as clip_counts
from benchmark.tests import tiny


def _retrieval(width=128):
    m = tiny.manifest()
    c = m.cell("retr-train-b64")
    conf, traffic = c["conf"], {**c["traffic_params"], "batch": 8}
    conf["retrieval"]["clip"].update(vision_width=width, text_width=width, image_resolution=64,
                                     context_length=32)
    conf["retrieval"].update(visual_dim=width, textual_dim=width)
    return m, conf, traffic


def test_the_retrieval_count_matches_the_counter_over_the_reference():
    """The analytic count leaves out the projections, the loss and the
    prompts' own products: 0.24% of the step at width 128 (0.007% at the
    published widths, as the port's own check found)."""
    m, conf, traffic = _retrieval()
    fam = m.family("clip")
    weights = fam.make_weights(conf, 1, "cpu")
    batches = m.generator("pairs").batches(traffic, conf, 1, "cpu")
    counted = []
    fam.reference_steps(conf, weights, batches, 5, 1, "cpu", flops=counted)
    assert clip_counts.step_flops(conf, 8) == pytest.approx(counted[0], rel=0.01)
    assert fam.step_flops(conf, traffic, None) == clip_counts.step_flops(conf, 8)


def test_the_grounding_count_is_the_counter_over_the_reference_step():
    """The grounding step's count is the counter's reading of the reference's
    first step: the forward and the gradients of the activations that lead
    to the pools, so between one and three forwards."""
    from torch.utils.flop_counter import FlopCounterMode

    m = tiny.manifest()
    c = m.cell("ground-train-b16")
    conf, traffic = c["conf"], c["traffic_params"]
    fam = m.family("glip")
    weights = fam.make_weights(conf, 1, "cpu")
    batches = m.generator("refexp").batches(traffic, conf, 1, "cpu")
    counted = []
    fam.reference_steps(conf, weights, batches, 5, 1, "cpu", flops=counted)
    model = fam.reference_model(conf, "cpu")
    model.load_state_dict(weights, strict=False)
    b = batches[0]
    with torch.no_grad(), FlopCounterMode(display=False) as fwd:
        model(torch.as_tensor(b["images"]), torch.as_tensor(b["input_ids"]).long(),
              torch.as_tensor(b["attention_mask"]), 5)
    assert fam.step_flops(conf, traffic, counted[0]) == counted[0]
    assert 1.5 * fwd.get_total_flops() < counted[0] < 3.0 * fwd.get_total_flops()
