"""What a run loads: no module whose top-level name is, whole, `jax`,
`jaxlib`, `flax` or `lpi_tpu`; the reference alone loads nothing of the
port either. Each probe runs in a fresh process."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
JAX = ("jax", "jaxlib", "flax", "lpi_tpu")

_RUN = """
import sys
from benchmark.tests import tiny
out = tiny.run("retr-train-b64", trace=1)
import benchmark.run as r
print(r.forbidden_modules())
"""

_REFERENCE = """
import importlib, pathlib, sys
for f in sorted(pathlib.Path("benchmark/reference").rglob("*.py")):
    importlib.import_module(".".join(f.with_suffix("").parts).replace(".__init__", ""))
from benchmark.tests import tiny
m = tiny.manifest()
for cell in ("ground-train-b16", "retr-train-b64"):
    c = m.cell(cell)
    fam = m.family(c["conf"]["family"])
    w = fam.make_weights(c["conf"], 1, "cpu")
    b = m.generator(c["traffic_params"]["generator"]).batches(c["traffic_params"], c["conf"], 1, "cpu")
    fam.reference_steps(c["conf"], w, b, 5, 1, "cpu")
c = m.cell("ground-serve-b1")
fam = m.family("glip")
keys = fam.make_keys(c["conf"], 1, "cpu")
req = m.generator("requests").requests(c["traffic_params"], c["conf"], 1, "cpu")[0]
model = fam.reference_server(c["conf"], fam.make_weights(c["conf"], 1, "cpu"), keys, "cpu")
fam.reference_request(model, c["conf"], keys, c["traffic_params"], *req, "cpu")
print(sorted({k.split(".")[0] for k in sys.modules} & {"jax", "jaxlib", "flax", "lpi_tpu", "lpi_tpu_torch"}))
"""


def _probe(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, capture_output=True,
                         text=True, timeout=600, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    return out.stdout.strip().splitlines()[-1]


def test_a_run_loads_no_jax_module():
    assert _probe(_RUN) == "[]"


def test_the_reference_loads_neither_jax_nor_the_port():
    assert _probe(_REFERENCE) == "[]"


def test_without_a_card_a_run_exits_non_zero_and_prints_no_result(tmp_path):
    """Here, and in a checkout that holds only BENCHMARK.json and the
    benchmark's folder (no program), the run exits non-zero and prints
    nothing on standard output."""
    import shutil

    import torch

    if torch.cuda.is_available():
        import pytest

        pytest.skip("a card is present")
    shutil.copytree(os.path.join(REPO, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    for cwd in (REPO, str(tmp_path)):
        r = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "retr-train-b64",
                            "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=cwd,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode != 0 and r.stdout == "", (cwd, r.stdout)
