"""`lpi_tpu_torch.core.dist` on the CPU: the single-process short cuts, and
the collectives on a 4-process gloo group arranged as a (2, 2) mesh, each
held to its definition worked out here in numpy. The gather with a
gradient runs on the `data` subgroup, where the backward of
`torch.distributed.nn.functional.all_gather` fails."""

import numpy as np
import pytest
import torch

from lpi_tpu_torch.core import dist as d
from lpi_tpu_torch.dryrun import run_world
from tests import torch_dist_workers as workers

torch.set_num_threads(1)
ROWS = 2


def test_single_process_short_cuts():
    assert not d.started()
    assert (d.get_world_size(), d.get_rank(), d.is_main_process()) == (1, 0, True)
    d.synchronize()
    assert d.all_gather_objects({"a": 1}) == [{"a": 1}]
    assert d.reduce_dict({"a": 2.5}) == {"a": 2.5}


def test_the_card_is_refused_without_one(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        d.init_from_env("gpu")
    assert not d.started()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_world(workers.helpers, 4, "cpu", (ROWS,),
                     workdir=str(tmp_path_factory.mktemp("world")))


def test_mesh_coordinates_and_host_helpers(ranks):
    for r, out in enumerate(ranks):
        assert out["rank"] == r and out["coords"] == (r // 2, r % 2)
        assert out["objects"] == [{"rank": q} for q in range(4)]
        assert out["reduced"] == {"a": 1.5, "b": 2.0}
        assert out["summed"] == {"a": 6.0}


def _data_peers(r):  # the ranks of r's `data` group: the same model coordinate
    return [q for q in range(4) if q % 2 == r % 2]


def _model_peers(r):
    return [q for q in range(4) if q // 2 == r // 2]


def test_gather_rows_forward_and_backward_on_the_data_subgroup(ranks):
    for r, out in enumerate(ranks):
        peers = _data_peers(r)
        np.testing.assert_array_equal(out["gathered"],
                                      np.concatenate([ranks[q]["x"] for q in peers]))
        # d(sum over the group's losses)/d x_r: every peer's weight at r's rows
        i = peers.index(r)
        want = sum(ranks[q]["w"][i * ROWS:(i + 1) * ROWS] for q in peers)
        np.testing.assert_allclose(out["grad"], want, rtol=1e-6)


def test_global_mean_all_sum_and_average_gradients(ranks):
    for r, out in enumerate(ranks):
        peers = _data_peers(r)
        assert out["mean"] == pytest.approx(np.mean([ranks[q]["local_sum"] for q in peers]))
        np.testing.assert_array_equal(out["mean_grad"], out["w"][:ROWS])  # its own loss's
        assert out["all_sum"] == float(sum(peers))
        np.testing.assert_allclose(out["averaged"][0],
                                   np.mean([2 * ranks[q]["x"] for q in peers], axis=0))
        assert out["averaged"][1] is None  # a leaf no loss reads
        assert out["averaged"][2].dtype == np.float64
        assert out["averaged"][2][0] == np.mean(peers)


def test_megatron_copy_and_reduce_on_the_model_subgroup(ranks):
    for r, out in enumerate(ranks):
        peers = _model_peers(r)
        np.testing.assert_array_equal(out["copy"], out["x"])
        np.testing.assert_allclose(out["copy_grad"],
                                   sum(ranks[q]["w"][:ROWS] for q in peers))
        np.testing.assert_allclose(out["reduced_x"], sum(ranks[q]["x"] for q in peers))
        np.testing.assert_array_equal(out["reduce_grad"], out["w"][:ROWS])


def test_a_failing_rank_raises_with_its_traceback(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        run_world(workers.failing, 2, "cpu", workdir=str(tmp_path))
