"""The finished surface: every module of the JAX package has its
counterpart in the port, and every top-level public name of a JAX module
(functions, classes, module-level constants) is in its counterpart, but
for an explicit list of intended differences, each with its reason.

Both packages are read with `ast`; neither is imported.
"""

import ast
import os

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a JAX module whose counterpart sits elsewhere in the port
MOVED = {"core/config.py": "config.py"}  # the configs sit at the package's root
# (JAX module, name) -> why the port has no such name
INTENDED = {
    ("continual/common.py", "split_params"):
        "Flax param trees are split by path; the port's `freeze` splits named parameters",
    ("continual/common.py", "merge_params"):
        "the inverse of split_params; torch modules keep their parameters in place",
    ("ops/deform_conv.py", "deform_conv2d_fast"):
        "the routes 'fast', 'fast_scan' and 'pallas' share `deform_conv2d`",
    ("ops/deform_conv.py", "deform_conv2d_fast_scan"):
        "the routes 'fast', 'fast_scan' and 'pallas' share `deform_conv2d`",
    ("ops/deform_conv.py", "deform_conv2d_pallas"):
        "the routes 'fast', 'fast_scan' and 'pallas' share `deform_conv2d`",
    ("ops/deform_conv.py", "deform_conv2d_window"):
        "the window route is `deform_conv2d`, its kernels in `csrc/deform_window.cu`",
    ("ops/deform_window_kernel.py", "taps_kernel_supported"):
        "a Mosaic lowering check; the CUDA kernel takes every shape the model gives",
    ("core/mesh.py", "data_sharding"):
        "a jax.sharding layout; the port shards batches by rank (`shard_batch`)",
    ("core/mesh.py", "replicated"):
        "a jax.sharding layout; a torch tensor on every rank is replicated as it is",
    ("core/mesh.py", "force_host_devices"):
        "XLA's virtual CPU devices; the port runs gloo processes (`dryrun.run_world`)",
    ("models/clip/model.py", "PromptedBlock"):
        "a Flax scan body; the port's towers loop over their blocks",
    ("models/glip/fused.py", "FusedPair"):
        "a Flax scan body; the port's encoder loops over its block pairs",
}


def _public_names(path: str) -> set:
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
    return {n for n in names if not n.startswith("_")}


def _jax_modules() -> list:
    root = os.path.join(REPO, "lpi_tpu")
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files if f.endswith(".py"))


def _counterpart(rel: str) -> str:
    return os.path.join(REPO, "lpi_tpu_torch", MOVED.get(rel, rel))


def test_every_jax_module_has_its_counterpart():
    modules = _jax_modules()
    assert len(modules) >= 90
    assert [rel for rel in modules if not os.path.isfile(_counterpart(rel))] == []


def test_the_missing_public_names_are_the_intended_differences():
    missing = {(rel, name) for rel in _jax_modules()
               for name in _public_names(os.path.join(REPO, "lpi_tpu", rel))
               - _public_names(_counterpart(rel))}
    assert missing == set(INTENDED), (sorted(missing - set(INTENDED)),
                                      sorted(set(INTENDED) - missing))
