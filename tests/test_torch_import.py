"""The PyTorch port imports neither JAX nor the JAX package, PyYAML only
when `data.tsv.TSVDataset.from_yaml` reads a shard descriptor, and gradio
only when `serve.predictor.launch_webui` is called."""

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import lpi_tpu_torch
names = [m.name for m in pkgutil.walk_packages(lpi_tpu_torch.__path__, "lpi_tpu_torch.")]
for name in names:
    importlib.import_module(name)
runpy_ns = {"__name__": "chip_smoke_probe"}
exec(compile(open("chip_smoke.py").read(), "chip_smoke.py", "exec"), runpy_ns)
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "flax", "lpi_tpu", "yaml", "gradio"))
print(len(names), bad)
"""


def test_port_and_chip_smoke_import_without_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, check=True,
                         capture_output=True, text=True, timeout=300).stdout.split()
    n_modules, bad = int(out[0]), " ".join(out[1:])
    assert n_modules >= 90
    assert bad == "[]", bad


def test_the_distributed_modules_and_a_spawned_rank_import_without_jax(tmp_path):
    """`core.dist`, `core.mesh`, `core.pipeline` and `dryrun` are among the
    modules that the probe above imports; a rank that `dryrun.run_world`
    spawns (gloo) holds neither JAX nor the JAX package after importing
    them."""
    import pkgutil

    import lpi_tpu_torch
    from lpi_tpu_torch.dryrun import run_world
    from tests import torch_dist_workers as workers

    names = {m.name for m in pkgutil.walk_packages(lpi_tpu_torch.__path__, "lpi_tpu_torch.")}
    assert {"lpi_tpu_torch.core.dist", "lpi_tpu_torch.core.mesh", "lpi_tpu_torch.core.pipeline",
            "lpi_tpu_torch.dryrun"} <= names
    assert run_world(workers.modules_loaded, 1, "cpu", workdir=str(tmp_path)) == [
        {"jax": False, "lpi_tpu": False}]


def test_chip_smoke_refuses_without_card():
    """Without a card the script exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run for real")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
