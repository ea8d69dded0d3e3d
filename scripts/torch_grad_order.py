"""How much the port's fp32 pool gradient depends on the order of its sums.

    python3 scripts/torch_grad_order.py [lpi|sprompts|maple ...]

Needs one CUDA card. At full width (GLIP-T, 448 px, batch 1, fp32, task 1,
seeded weights) it computes `GroundingLearner._losses` and the gradient of
the task-1 pool rows and compares, by relative Frobenius error of the
concatenated gradient and of each leaf:

* the card against itself (two identical runs);
* the CUDA kernels against their plain versions, both on the card;
* the card against the CPU;
* the CPU at half its threads and at a quarter against all of them.

"lpi" (the default) runs the LPI pool with the offset convs scaled as
`lpi_tpu_torch.bench.honest_offsets` scales them (kernel x30, bias N(0, 1))
and without (the CPU thread counts with the scaled ones only). "sprompts"
and "maple" run the grounding section of `configs/baselines/<name>.json`
at the seeded offsets, as `chip_smoke.py`'s phase 13d does.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from lpi_tpu_torch.config import GroundingConfig  # noqa: E402
from lpi_tpu_torch.bench import honest_offsets  # noqa: E402
from lpi_tpu_torch.continual.grounding_learner import GroundingLearner  # noqa: E402
from lpi_tpu_torch.continual.keys import exact_fp32  # noqa: E402
from lpi_tpu_torch.data.bert_tokenizer import BertTokenizer  # noqa: E402
from lpi_tpu_torch.data.grounding import synthetic_grounding_task  # noqa: E402
from lpi_tpu_torch.ops import cuda_build  # noqa: E402
from lpi_tpu_torch.ops import deform_window_kernel as dk  # noqa: E402

TASK = 1


def weights(cfg, scaled: bool) -> dict:
    learner = GroundingLearner(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    if scaled:
        honest_offsets(learner.model)
    return {k: v.detach().clone() for k, v in learner.model.state_dict().items()}


def grads(cfg, state, one, device) -> dict:
    learner = GroundingLearner(cfg, init_params=state, device=device)
    t = time.perf_counter()
    with exact_fp32():
        total, _ = learner._losses(learner.to_device(one), TASK)
        names = sorted(learner.pools)
        g = torch.autograd.grad(total, [learner.pools[n] for n in names])
    print(f"  {device} ({torch.get_num_threads()} cpu threads): {time.perf_counter() - t:.1f} s, "
          f"total {total.item():.8f}", flush=True)
    return {n: x[TASK].double().cpu().numpy() for n, x in zip(names, g)}


def compare(a, b, what, leaves=3):
    va = np.concatenate([a[n].ravel() for n in sorted(a)])
    vb = np.concatenate([b[n].ravel() for n in sorted(b)])
    worst = sorted(((np.linalg.norm(a[n] - b[n]) / max(np.linalg.norm(b[n]), 1e-30), n)
                    for n in b), reverse=True)[:leaves]
    print(f"{what}: {np.linalg.norm(va - vb) / np.linalg.norm(vb):.3e}; worst leaves "
          + ", ".join(f"{n} {e:.3e}" for e, n in worst), flush=True)


def cpu_threads(cfg, state, one, cpu, threads):
    """The CPU's gradient at half and a quarter of its threads against `cpu`
    (all of them): another order of the CPU's sums."""
    for n in sorted({max(1, threads // 2), max(1, threads // 4)} - {threads}, reverse=True):
        torch.set_num_threads(n)
        try:
            compare(grads(cfg, state, one, "cpu"), cpu, f"cpu {n} vs {threads} threads",
                    leaves=len(cpu))
        finally:
            torch.set_num_threads(threads)


def plain_on_card():
    """Route CUDA tensors through the plain versions (on the card)."""
    fwd = {1: dk.window_accumulate_taps_inpad_reference, 2: dk.window_accumulate_taps_s2_reference}
    bwd = {1: dk.window_accumulate_taps_inpad_backward_reference,
           2: dk.window_accumulate_taps_s2_backward_reference}
    dk._launch = lambda h, oy, ox, g, m, K, kw, s, padded: fwd[s](h, oy, ox, g, m, K, kw)
    dk._launch_backward = (lambda h, oy, ox, g, ct, m, K, kw, s, padded:
                           bwd[s](h, oy, ox, g, ct, m, K, kw))


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_grad_order: no CUDA device", file=sys.stderr)
        return 1
    print(f"card: {chip_smoke.card_line()}", flush=True)
    cuda_build.build()
    threads = torch.get_num_threads()
    kernels = dk._launch, dk._launch_backward
    for pool in sys.argv[1:] or ["lpi"]:
        cfg = (GroundingConfig(batch_size=1, dtype="float32") if pool == "lpi" else
               chip_smoke.baseline_config(pool, "grounding", batch_size=1, dtype="float32"))
        tok = BertTokenizer(max_len=cfg.bert.max_query_len, vocab_size=cfg.bert.vocab_size)
        batch = next(synthetic_grounding_task(TASK, 4, 448, tok,
                                              max_boxes=cfg.max_boxes).batches(4))
        one = {k: v[:1] for k, v in batch.items()}
        for scaled in ((True, False) if pool == "lpi" else (False,)):
            print(f"== pool {pool}, offset convs scaled: {scaled}", flush=True)
            state = weights(cfg, scaled)
            card = grads(cfg, state, one, "cuda")
            leaves = len(card)
            print("  leaf norms on the card: " + ", ".join(
                f"{n} {np.linalg.norm(card[n]):.3e}" for n in sorted(card)), flush=True)
            compare(card, grads(cfg, state, one, "cuda"), "card vs card", leaves)
            plain_on_card()
            try:
                compare(card, grads(cfg, state, one, "cuda"),
                        "card kernels vs card plain versions", leaves)
            finally:
                dk._launch, dk._launch_backward = kernels
            cpu = grads(cfg, state, one, "cpu")
            compare(card, cpu, "card vs cpu", leaves)
            if scaled or pool != "lpi":
                cpu_threads(cfg, state, one, cpu, threads)
    return 0


if __name__ == "__main__":
    sys.exit(main())
