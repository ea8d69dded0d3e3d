"""Multi-process dry run of the port's parallel legs (counterpart of
`__graft_entry__.dryrun_multichip`), and the harness that starts a group
of ranks.

    python -m lpi_tpu_torch.dryrun 4 --platform cpu   # 4 gloo processes
    python -m lpi_tpu_torch.dryrun 2                  # 2 NCCL ranks, a card each

`run_world(fn, n, platform, args)` starts `n` fresh processes (spawn), each
a rank of a started group (`core.dist.init_from_env`: gloo on the CPU,
NCCL with one card a rank on "gpu"), runs `fn(*args)` in each and returns
their results by rank; a rank's failure raises with its traceback, and
every process it started is ended before it returns. The group meets
through a file under a fresh temporary directory, not a TCP port.

`dryrun_multichip(n, platform)` runs the JAX package's legs at its tiny
configs:

* dp: one retrieval session over an (n, 1) mesh, the loss finite;
* tp: the same session over an (n/2, 2) mesh (n >= 4, even), its loss
  within relative 2e-4 of dp's (`tests/test_mesh_tp.py`'s bar);
* pp: an 8-block CLIP tower as 4 stages x 4 microbatches on ranks 0-3,
  forward and backward, max |pp - sequential| < 1e-4 (n >= 4);
* grounding dp: one grounding task over the (n, 1) mesh, the loss finite.

Each leg is a function of one rank that returns its numbers, so the tests
hold the same legs to the JAX package.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch


# ---- the harness -----------------------------------------------------------
def _rank_main(rank: int, world: int, platform: str, init: str, work: str, conn) -> None:
    import pickle

    import torch.distributed as dist

    from lpi_tpu_torch.core.dist import init_from_env

    try:
        with open(work, "rb") as f:
            fn, args = pickle.load(f)
        torch.set_num_threads(1)
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
        # the group's own transports stay on the loopback interface
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        init_from_env(platform, init_method=init)
        conn.send(("ok", fn(*args)))
    except BaseException:
        conn.send(("error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        conn.close()


def run_world(fn: Callable, world: int, platform: str = "gpu", args: Sequence = (),
              timeout: float = 600.0, workdir: Optional[str] = None) -> List[Any]:
    """`fn(*args)` on each rank of a fresh `world`-rank group, NCCL ranks on
    as many cards unless `platform="cpu"` asks for gloo (`fn` must be
    importable by name, as spawn pickles it). -> the ranks' results, by
    rank. `fn` and `args` reach the ranks through a file (a large argument
    passed to a spawned process holds its start until it has imported the
    parent's main module, one rank after another)."""
    import multiprocessing
    import pickle
    from multiprocessing.connection import wait

    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="lpi_world_", dir=workdir)
    init = f"file://{os.path.join(tmp, 'store')}"
    work = os.path.join(tmp, "work.pkl")
    with open(work, "wb") as f:
        pickle.dump((fn, tuple(args)), f)
    procs, conns = [], {}
    try:
        for r in range(world):
            ours, theirs = ctx.Pipe(duplex=False)
            proc = ctx.Process(target=_rank_main, args=(r, world, platform, init, work, theirs),
                               daemon=True)
            proc.start()
            theirs.close()
            procs.append(proc)
            conns[ours] = r
        results = [None] * world
        deadline = time.monotonic() + timeout
        while conns:
            ready = wait(list(conns), timeout=max(0.0, deadline - time.monotonic()))
            if not ready:
                raise TimeoutError(f"ranks {sorted(conns.values())} gave no result in "
                                   f"{timeout} s")
            for c in ready:
                r = conns.pop(c)
                try:
                    status, value = c.recv()
                except EOFError:
                    procs[r].join(5)
                    raise RuntimeError(f"rank {r} ended with code {procs[r].exitcode} and no "
                                       f"result") from None
                if status != "ok":
                    raise RuntimeError(f"rank {r} failed:\n{value}")
                results[r] = value
        for proc in procs:
            proc.join(60)
        return results
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.terminate()
            proc.join()
        shutil.rmtree(tmp, ignore_errors=True)


# ---- the tiny configs of `__graft_entry__.dryrun_multichip` -----------------
def tiny_retrieval_config(n: int, total_sessions: int = 3):
    from lpi_tpu_torch.config import CLIPConfig, LPIPromptConfig, RetrievalConfig

    return RetrievalConfig(
        clip=CLIPConfig(image_resolution=32, patch_size=16, vision_width=64, vision_layers=2,
                        vision_heads=4, text_width=32, text_layers=2, text_heads=4,
                        vocab_size=512, context_length=16, embed_dim=32, n_ctx=4),
        lpi=LPIPromptConfig(prompt_length=4, prompt_depth=2, prompt_rank=2),
        total_sessions=total_sessions, epochs=1, batch_size=2 * n, visual_dim=64,
        textual_dim=32, num_key_clusters=2, dtype="float32")


def tiny_retrieval_set(cfg, task_index: int = 0):
    """The dry run's session: 2 batches of random images and ids (the
    JAX package's arrays: `RandomState(0)`, the last id 511)."""
    from lpi_tpu_torch.data.retrieval import RetrievalTrainSet

    n = 2 * cfg.batch_size
    rng = np.random.RandomState(0)
    ids = rng.randint(1, 500, size=(n, cfg.clip.context_length)).astype(np.int32)
    ids[:, -1] = 511
    return RetrievalTrainSet(images=rng.randn(n, 32, 32, 3).astype(np.float32),
                             token_ids=ids, task_index=task_index)


def tiny_grounding_config(n: int):
    from lpi_tpu_torch.config import (ATSSConfig, BertConfig, DyHeadConfig, GroundingConfig,
                                      LPIPromptConfig, SwinConfig)

    return GroundingConfig(
        swin=SwinConfig(patch_size=4, embed_dim=8, depths=(2, 2, 2, 2),
                        num_heads=(1, 2, 2, 2), window_size=4),
        bert=BertConfig(vocab_size=512, hidden_size=16, num_layers=8, num_heads=2,
                        intermediate_size=32, max_position_embeddings=32, max_query_len=16),
        dyhead=DyHeadConfig(num_convs=2, channels=16, max_tokens=16, deform_window=1),
        atss=ATSSConfig(anchor_sizes=(32, 64, 128, 256, 512), anchor_strides=(4, 8, 16, 32, 64),
                        pre_nms_top_n=20, fpn_post_nms_top_n=10),
        lpi=LPIPromptConfig(prompt_length=4, prompt_depth=4, prompt_rank=2, interact_rank=2,
                            interact_depth=4),
        total_tasks=2, epochs_per_task=1, batch_size=n, max_boxes=4, image_size=64,
        num_key_clusters=2, dtype="float32", fused_scan_unroll=1)


def tiny_grounding_set(cfg, task_index: int = 0):
    from lpi_tpu_torch.data.bert_tokenizer import BertTokenizer
    from lpi_tpu_torch.data.grounding import synthetic_grounding_task

    tok = BertTokenizer(max_len=cfg.bert.max_query_len, vocab_size=cfg.bert.vocab_size)
    return synthetic_grounding_task(task_index, 2 * cfg.batch_size, cfg.image_size, tok,
                                    cfg.max_boxes)


def _numpy(tensors) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in tensors.items()}


# ---- the legs: each runs on every rank of a started group -------------------
def _mesh(dp: Optional[int], mp: int):
    """A (dp, mp) mesh over the started group, or None (one process, no
    group) when dp is None."""
    from lpi_tpu_torch.config import MeshConfig
    from lpi_tpu_torch.core import mesh as mesh_lib

    return None if dp is None else mesh_lib.make_mesh(MeshConfig(data_parallel=dp,
                                                                 model_parallel=mp))


def _placed(dp: Optional[int], mp: int, device: Optional[str]):
    """-> (mesh, device): a mesh runs on its rank's device; a run without
    one (dp None) on the `device` its caller names."""
    mesh = _mesh(dp, mp)
    if mesh is not None:
        if device is not None:
            raise ValueError("a leg over a mesh runs on the mesh's device; pass no device")
        return mesh, mesh.device
    if device is None:
        raise ValueError("a leg without a mesh (dp None) needs its device")
    return None, device


def retrieval_leg(cfg, dp: Optional[int], mp: int = 1, init_params=None,
                  device: Optional[str] = None) -> dict:
    """One retrieval session (`train_session`: the steps, then the task
    keys) over a (dp, mp) mesh on its device, or (dp None) in one process
    on `device`. -> {"metrics", "pools", "keys", "layout" (the sharded
    parameters)}."""
    from lpi_tpu_torch.continual.learner import RetrievalLearner

    mesh, device = _placed(dp, mp, device)
    learner = RetrievalLearner(cfg, init_params=init_params, device=device, mesh=mesh)
    metrics = learner.train_session(tiny_retrieval_set(cfg), epochs=1)
    return {"metrics": metrics, "pools": _numpy(learner.pools),
            "keys": learner.visual_keys.centers.cpu().numpy(),
            "layout": {k: v for k, v in learner.tp_layout.items() if v is not None}}


def grounding_leg(cfg, dp: Optional[int], mp: int = 1, init_params=None,
                  device: Optional[str] = None, steps: int = 1) -> dict:
    """`steps` grounding steps at task 1 (the task loss live) on the dry
    run's set, over a (dp, mp) mesh on its device, or (dp None) in one
    process on `device`. -> {"metrics" (per step), "pools"}."""
    from lpi_tpu_torch.continual.grounding_learner import GroundingLearner

    mesh, device = _placed(dp, mp, device)
    learner = GroundingLearner(cfg, init_params=init_params, device=device, mesh=mesh)
    step = learner.make_step(1, steps_per_epoch=steps, epochs=1)
    batches = tiny_grounding_set(cfg, 1).batches(cfg.batch_size, seed=cfg.seed)
    metrics = [{k: float(v) for k, v in step(b).items()}
               for b, _ in zip(batches, range(steps))]
    return {"metrics": metrics, "pools": _numpy(learner.pools)}


def captured_leg(steps: int = 3) -> dict:
    """The one rank of a 1-rank NCCL group on a card: the dry run's
    retrieval step on the (1, 1) mesh captured (the collectives inside the
    graph) against a learner without a mesh run eagerly, from the same
    seeded start, under deterministic algorithms. -> whether every step's
    metrics and every pool leaf are equal in bits (over one rank a
    collective is a copy), the backend, and each learner's count of
    captured graphs. It lives in the package, not beside the CPU tests'
    rank functions in `tests/torch_dist_workers.py`, because the card's
    machine has a site package named `tests` that shadows the repo's, so
    a rank spawned there cannot import those; it goes there once nothing
    shadows them."""
    import torch.distributed as dist

    from lpi_tpu_torch.bench import deterministic
    from lpi_tpu_torch.continual.learner import RetrievalLearner

    mesh = _mesh(-1, 1)
    cfg = tiny_retrieval_config(mesh.dp)
    batches = list(tiny_retrieval_set(cfg).batches(cfg.batch_size))
    runs = []
    with deterministic():
        for m, eager in ((None, True), (mesh, False)):
            learner = RetrievalLearner(cfg, device=mesh.device, mesh=m)
            step = learner.make_train_step(1, steps_per_epoch=10, epochs=1, eager=eager)
            metrics = [{k: v.item() for k, v in step(batches[i % len(batches)]).items()}
                       for i in range(steps)]
            runs.append((metrics, _numpy(learner.pools), len(learner._graphs)))
    (m0, p0, g0), (m1, p1, g1) = runs
    return {"backend": dist.get_backend(), "graphs": (g0, g1), "metrics": m0 == m1,
            "pools": all(np.array_equal(p0[k], p1[k]) for k in p0)}


def pipeline_leg(params: dict, x: np.ndarray, prompts: np.ndarray, gates: np.ndarray,
                 width: int, heads: int, stages: int, microbatches: int, dp: int = 1) -> dict:
    """An L-block CLIP tower (`params`: its state_dict, blocks `{l}.*`) as a
    `stages`-stage pipeline on ranks [0, dp x stages) (a (dp, stages)
    grid: dp x pp), forward and backward of mean(out^2); the other ranks
    only join the groups. -> {"out", "loss", "grads" (this stage's blocks'
    and prompts', averaged over the data rows), "rank"}."""
    import torch.distributed as dist
    import torch.nn as nn

    from lpi_tpu_torch.core.dist import average_gradients
    from lpi_tpu_torch.core.pipeline import pipeline_tower
    from lpi_tpu_torch.models.clip.model import ResidualAttentionBlock

    L = len(gates)
    blocks = nn.ModuleList(ResidualAttentionBlock(width, heads, dtype=torch.float32)
                           for _ in range(L))
    blocks.load_state_dict({k: torch.as_tensor(v) for k, v in params.items()})
    rank = dist.get_rank()
    groups = {}
    for d in range(dp):  # every rank makes every group, in the same order
        groups[("pipe", d)] = dist.new_group(list(range(d * stages, (d + 1) * stages)))
    for s in range(stages):
        groups[("data", s)] = dist.new_group(list(range(s, dp * stages, stages)))
    if rank >= dp * stages:
        return {"rank": rank}
    d, s = divmod(rank, stages)
    prompts_t = torch.tensor(prompts, requires_grad=True)
    out = pipeline_tower(groups[("pipe", d)], blocks, torch.as_tensor(x), prompts_t,
                         torch.as_tensor(gates), microbatches=microbatches,
                         data_group=groups[("data", s)] if dp > 1 else None)
    loss = (out ** 2).mean()
    mine = range(s * (L // stages), (s + 1) * (L // stages))
    leaves = {f"{l}.{n}": p for l in mine for n, p in blocks[l].named_parameters()}
    grads = torch.autograd.grad(loss, [*leaves.values(), prompts_t])
    if dp > 1:
        grads = average_gradients(grads, groups[("data", s)])
    out_grads = {n: g.numpy() for n, g in zip(leaves, grads)}
    out_grads["prompts"] = grads[-1][list(mine)].numpy()
    return {"out": out.detach().numpy(), "loss": float(loss.detach()), "grads": out_grads,
            "rank": rank, "layers": list(mine)}


def sequential_tower(params: dict, x: np.ndarray, prompts: np.ndarray, gates: np.ndarray,
                     width: int, heads: int) -> np.ndarray:
    """The same tower run block after block in one process (the pipeline's
    reference)."""
    import torch.nn as nn

    from lpi_tpu_torch.models.clip.model import ResidualAttentionBlock

    L = len(gates)
    blocks = nn.ModuleList(ResidualAttentionBlock(width, heads, dtype=torch.float32)
                           for _ in range(L))
    blocks.load_state_dict({k: torch.as_tensor(v) for k, v in params.items()})
    h = torch.as_tensor(x)
    with torch.no_grad():
        for l, block in enumerate(blocks):
            P = prompts.shape[2]
            h = torch.cat([h[:, :1], h[:, 1:1 + P] + float(gates[l]) * torch.as_tensor(prompts[l]),
                           h[:, 1 + P:]], dim=1)
            h = block(h)
    return h.numpy()


def tiny_tower(seed: int = 0, L: int = 8, width: int = 32, heads: int = 2, tokens: int = 6,
               prompt_tokens: int = 2, batch: int = 8):
    """The dry run's pipeline inputs: seeded block weights (the port's
    initialisers), tokens, per-layer per-sample prompts, gates (layer 0
    off)."""
    import torch.nn as nn

    from lpi_tpu_torch.models.clip.model import ResidualAttentionBlock
    from lpi_tpu_torch.models.layers import lecun_normal_, normal_

    gen = torch.Generator().manual_seed(seed)
    blocks = nn.ModuleList(ResidualAttentionBlock(width, heads, dtype=torch.float32)
                           for _ in range(L))
    with torch.no_grad():
        for n, p in blocks.named_parameters():
            if p.dim() == 2:
                lecun_normal_(p, gen)
            else:  # biases near 0, LayerNorm scales near 1
                normal_(p, 0.02, gen)
                if ".ln_" in f".{n}" and n.endswith("weight"):
                    p += 1.0
    rng = np.random.RandomState(seed)
    x = rng.randn(batch, tokens, width).astype(np.float32)
    prompts = (rng.randn(L, batch, prompt_tokens, width) * 0.1).astype(np.float32)
    gates = np.ones(L, np.float32)
    gates[0] = 0.0
    return _numpy(blocks.state_dict()), x, prompts, gates


# ---- the dry run ----------------------------------------------------------
def _dryrun_rank(n: int) -> dict:
    import torch.distributed as dist

    rank = dist.get_rank()
    lines, t0 = [], time.perf_counter()

    def say(msg):
        lines.append(f"dryrun_multichip({n}): {msg} [t={time.perf_counter() - t0:.0f}s]")

    cfg = tiny_retrieval_config(n)
    dp = retrieval_leg(cfg, n)
    total = dp["metrics"]["total"]
    if not np.isfinite(total):
        raise AssertionError(f"dp retrieval: {dp['metrics']}")
    say(f"retrieval ok, metrics={dp['metrics']}")
    if n >= 4 and n % 2 == 0:
        tp = retrieval_leg(cfg, n // 2, 2)
        if not abs(tp["metrics"]["total"] - total) <= 2e-4 * max(1.0, abs(total)):
            raise AssertionError(f"tp {tp['metrics']} against dp {dp['metrics']}")
        say(f"retrieval tp ({n // 2}x2 mesh) ok, metrics={tp['metrics']}")
    if n >= 4:
        params, x, prompts, gates = tiny_tower()
        pp = pipeline_leg(params, x, prompts, gates, 32, 2, stages=4, microbatches=4)
        if rank < 4:
            seq = sequential_tower(params, x, prompts, gates, 32, 2)
            err = float(np.abs(pp["out"] - seq).max())
            finite = all(np.isfinite(g).all() for g in pp["grads"].values())
            if not (err < 1e-4 and finite):
                raise AssertionError(f"pipeline/sequential mismatch {err}, grads finite "
                                     f"{finite}")
            say(f"pipeline-parallel tower (4 stages x 4 microbatches) ok, "
                f"max|pp-seq|={err:.2e}")
    g = grounding_leg(tiny_grounding_config(n), n)
    if not all(np.isfinite(m["total"]) for m in g["metrics"]):
        raise AssertionError(f"grounding: {g['metrics']}")
    say(f"grounding ok, metrics={g['metrics'][-1]}")
    dist.barrier()
    return {"lines": lines}


def dryrun_multichip(n: int, platform: str = "gpu", timeout: float = 1800.0) -> List[str]:
    """The dry run on `n` ranks: NCCL ranks on `n` cards, or gloo processes
    on the CPU when `platform="cpu"` asks for them. -> rank 0's lines (also
    printed)."""
    lines = run_world(_dryrun_rank, n, platform, (n,), timeout=timeout)[0]["lines"]
    for line in lines:
        print(line, flush=True)
    return lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser("lpi_tpu_torch.dryrun")
    p.add_argument("n", type=int, help="ranks: CPU processes, or cards")
    p.add_argument("--platform", default="gpu", choices=["gpu", "cpu"])
    args = p.parse_args(argv)
    if args.platform == "gpu" and torch.cuda.device_count() < args.n:
        print(f"dryrun: {args.n} ranks need {args.n} cards, have "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 1
    dryrun_multichip(args.n, args.platform)
    return 0


if __name__ == "__main__":
    sys.exit(main())
