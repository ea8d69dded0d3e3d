"""Data parallelism of both learners on gloo ranks (the dry run's tiny
configs, `lpi_tpu_torch.dryrun`).

* Retrieval on 2 and 4 ranks against the JAX `RetrievalLearner` on a dp
  mesh of as many virtual devices, from its weights: one session's losses
  and every pool leaf within relative 1e-4 (the pools also at the repo's
  absolute cap). The JAX learner computes the global batch's InfoNCE
  under `shard_map` and differentiates it; the port's ranks each take their
  rows, gather both towers and average the pool gradients.
* Grounding on 2 ranks against the port's one process on the whole batch
  (which `tests/test_torch_train.py` holds to the JAX package): two steps'
  losses and every pool leaf within 1e-4. The ATSS normalisers are
  batch-wide; with the planted fault, each rank dividing by its own
  positives and centerness sum, the losses leave the bar, because the two
  halves of the batch hold different numbers of positives.
* The learners' other mesh paths on 2 ranks against one process: one
  `pretrain` step of each (losses within 1e-4, and each parameter's
  gradient as AdamW receives it at the repo's bar: every retrieval leaf,
  and each grounding leaf that a relative 1e-7 change of the images does
  not move past the bar in the one process), the grounding task keys
  (`cluster_task`), the detections that `evaluate` scores, its P@k and
  task-ID accuracy.
"""

import numpy as np
import pytest
import torch

from lpi_tpu_torch import dryrun
from tests import torch_dist_workers as workers
from tests.test_torch_mesh import hold_session, jax_session, leaf_close

torch.set_num_threads(1)
STEPS = 2


@pytest.mark.parametrize("n", [2, 4])
def test_retrieval_dp_matches_jax_dp_mesh(n, tmp_path):
    cfg = dryrun.tiny_retrieval_config(n)
    jax_run = jax_session(cfg, n)
    ranks = dryrun.run_world(dryrun.retrieval_leg, n, "cpu", (cfg, n, 1, jax_run[0]),
                             workdir=str(tmp_path))
    for out in ranks:
        hold_session(out, jax_run, rel=1e-4)
        assert out["layout"] == {}
    for out in ranks[1:]:  # every rank holds the same pools and task keys
        assert all(np.array_equal(out["pools"][k], ranks[0]["pools"][k]) for k in out["pools"])
        np.testing.assert_array_equal(out["keys"], ranks[0]["keys"])


@pytest.fixture(scope="module")
def grounding(tmp_path_factory):
    cfg = dryrun.tiny_grounding_config(4)
    ranks = dryrun.run_world(workers.grounding_dp, 2, "cpu", (cfg, STEPS),
                             workdir=str(tmp_path_factory.mktemp("world")))
    return ranks, dryrun.grounding_leg(cfg, None, device="cpu", steps=STEPS)


LOSSES = ("loss_reg", "loss_centerness", "loss_dot_product_token", "total")


def _largest_error(run, one, keys=None) -> float:
    """The largest relative error over every step's metrics (or `keys`)."""
    errs = [abs(m[k] - ref[k]) / max(abs(ref[k]), 1e-12)
            for m, ref in zip(run["metrics"], one["metrics"], strict=True)
            for k in (ref if keys is None else keys)]
    return max(errs)


def test_grounding_dp_matches_one_process(grounding):
    ranks, one = grounding
    for out in ranks:
        run = out["dp"]
        assert _largest_error(run, one) <= 1e-4
        for name, p in run["pools"].items():
            leaf_close(p, one["pools"][name], name)
    # the global count of positives is the one process's
    assert [m["num_pos"] for m in ranks[0]["dp"]["metrics"]] == [
        m["num_pos"] for m in one["metrics"]]


def test_the_planted_normaliser_fault_fails_the_check(grounding):
    ranks, one = grounding
    halves = [out["fault"]["local_pos"] for out in ranks]
    assert halves[0] != halves[1]  # the two halves hold different numbers of positives
    assert [a + b for a, b in zip(*halves)] == [m["num_pos"] for m in one["metrics"]]
    # the losses themselves leave the bar, not only the reported count
    assert _largest_error(ranks[0]["fault"], one, LOSSES) > 1e-4


def _stable(leaf, jittered, name) -> bool:
    try:
        leaf_close(jittered, leaf, name)
    except AssertionError:
        return False
    return True


def test_pretrain_cluster_and_evaluate_over_the_mesh_match_one_process(tmp_path):
    rcfg, gcfg = dryrun.tiny_retrieval_config(2), dryrun.tiny_grounding_config(4)
    one = workers.rest_of_the_learners(rcfg, gcfg, None)
    # the one process again with its images moved by a relative 1e-7: the
    # gradient leaves that this moves past the bar (the DyHead towers'
    # DyReLU and GroupNorm biases at this untrained size, about 20 of 340)
    # sit on a kink, so any other summation order moves them as much
    jittered = workers.grounding_pretrain(gcfg, None, jitter=1e-7)["grads"]
    held = {name for name, g in one["grounding"]["grads"].items()
            if _stable(g, jittered[name], name)}
    assert len(held) >= 0.9 * len(jittered)
    ranks = dryrun.run_world(workers.rest_of_the_learners, 2, "cpu", (rcfg, gcfg, 2),
                             workdir=str(tmp_path))
    for out in ranks:
        for kind in ("retrieval", "grounding"):
            ours, ref = out[kind], one[kind]
            assert ours["metrics"].keys() == ref["metrics"].keys()
            for k, v in ref["metrics"].items():
                assert ours["metrics"][k] == pytest.approx(v, rel=1e-4, abs=1e-7), (kind, k)
            for name, g in ours["grads"].items():
                if kind == "retrieval" or name in held:
                    leaf_close(g, ref["grads"][name], f"{kind} {name}")
        np.testing.assert_allclose(out["keys"], one["keys"], rtol=1e-4, atol=1e-6)
        assert out["eval"] == one["eval"]
        assert len(out["detections"]) == len(one["detections"]) == 8
        for ours, ref in zip(out["detections"], one["detections"]):
            assert ours["boxes"].shape == ref["boxes"].shape and len(ref["boxes"])
            np.testing.assert_allclose(ours["boxes"], ref["boxes"], rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(ours["scores"], ref["scores"], rtol=1e-4, atol=1e-7)
            assert ours["image_index"] == ref["image_index"]


def test_the_dry_run_passes_every_leg_on_four_ranks():
    """`dryrun_multichip(4, "cpu")`, the counterpart of
    `__graft_entry__.dryrun_multichip`: dp, tp on (2, 2), pp and grounding
    dp, each checked inside."""
    lines = dryrun.dryrun_multichip(4, "cpu")
    assert [line.split(": ")[1].split(",")[0].split(" [")[0] for line in lines] == [
        "retrieval ok", "retrieval tp (2x2 mesh) ok",
        "pipeline-parallel tower (4 stages x 4 microbatches) ok", "grounding ok"]
