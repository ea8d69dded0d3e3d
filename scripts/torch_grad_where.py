"""Where the card's fp32 gradient parts from the CPU's, module by module.

    python3 scripts/torch_grad_where.py [sprompts|maple|lpi ...]

Needs one CUDA card. At full width (GLIP-T, 448 px, batch 1, fp32, task 1,
seeded weights and offsets, the grounding section of
`configs/baselines/<name>.json`, or the default config for "lpi") it runs
`GroundingLearner._losses` on the card and on the CPU, keeps the output of
every module call, and takes the gradient of the total loss with respect
to each of them and to the pool leaves. It prints, in the order of the
forward, the relative Frobenius error between the card and the CPU of
each call's gradient (every call into build/grad_where_<name>.txt, the
calls whose error exceeds 1e-4 on the terminal).
The backward runs from the last call to the first, so the first call from
the end whose error is large is where the two part. For the head's offset
convs it counts the offsets that lie on two sides of an integer on the two
devices (the hat weights' derivative jumps there) and the gradient's error
without them; then it runs the CPU again with every module's output set to
the card's (`chip_smoke.outputs_pinned`) and compares once more.

Then, for the stride-1 window backward at P3 (56 x 56, one call a tower),
it recomputes d oy, d ox and d gate in fp64 from each device's own inputs
and compares: each device's fp32 result with its fp64 one (the backward's
own rounding) and the two fp64 results (how far the rounding differences
of its inputs carry). It reads each pool leaf with the product maps of
the deformable convs computed in fp64 (rounded to fp32 once) on either
device: on the CPU against its fp32 maps (how far one rounding of the maps
moves the leaf, on the CPU alone) and card against CPU. Last it moves the
input image by one part in 2^23 on the card and reads how far each leaf
moves.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from lpi_tpu_torch.ops import deform_conv  # noqa: E402
from lpi_tpu_torch.ops import deform_window_kernel as dk  # noqa: E402
from lpi_tpu_torch.config import GroundingConfig  # noqa: E402
from lpi_tpu_torch.continual.grounding_learner import GroundingLearner  # noqa: E402
from lpi_tpu_torch.continual.keys import exact_fp32  # noqa: E402
from lpi_tpu_torch.data.bert_tokenizer import BertTokenizer  # noqa: E402
from lpi_tpu_torch.data.grounding import synthetic_grounding_task  # noqa: E402
from lpi_tpu_torch.ops import cuda_build  # noqa: E402

TASK = 1


def rel(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def kink_sides(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Where offsets a and b lie on two sides of an integer, or one on it:
    a kink of the hat weights lies between them."""
    return (torch.floor(a) != torch.floor(b)) | ((a != b) & ((a == a.round())
                                                             | (b == b.round())))


def traced_grads(cfg, one, device, images=None, first=None):
    """-> ([(call name, output, gradient)] in forward order, {pool leaf:
    task row's gradient}), numpy fp64. `first` goes on every module before
    the hook that keeps the outputs."""
    learner = GroundingLearner(cfg, generator=torch.Generator().manual_seed(0), device=device)
    calls, seen = [], {}

    def keep(name):
        def hook(module, args, out):
            if isinstance(out, torch.Tensor) and out.requires_grad and out.is_floating_point():
                seen[name] = seen.get(name, -1) + 1
                calls.append((f"{name}#{seen[name]}", out))
        return hook

    handles = [m.register_forward_hook(first) for m in learner.model.modules()
               if first is not None]
    handles += [m.register_forward_hook(keep(n or "model"))
                for n, m in learner.model.named_modules()]
    batch = learner.to_device(one)
    if images is not None:
        batch["images"] = images.to(device)
    try:
        with exact_fp32():
            total, _ = learner._losses(batch, TASK)
            names = sorted(learner.pools)
            grads = torch.autograd.grad(
                total, [o for _, o in calls] + [learner.pools[n] for n in names],
                allow_unused=True)
    finally:
        for h in handles:
            h.remove()
    kept = [(n, o.detach().cpu(), g.double().cpu().numpy())
            for (n, o), g in zip(calls, grads) if g is not None]
    pools = {n: g[TASK].double().cpu().numpy() for n, g in zip(names, grads[len(calls):])}
    return kept, pools


def pool_grads(cfg, one, device):
    """{pool leaf: task row's gradient}, numpy fp64, as `_losses` gives it."""
    learner = GroundingLearner(cfg, generator=torch.Generator().manual_seed(0), device=device)
    with exact_fp32():
        total, _ = learner._losses(learner.to_device(one), TASK)
        names = sorted(learner.pools)
        grads = torch.autograd.grad(total, [learner.pools[n] for n in names])
    return {n: g[TASK].double().cpu().numpy() for n, g in zip(names, grads)}


class _Fp64Maps:
    """Stands in for `torch` inside `ops/deform_conv.py`: its product maps
    are computed in fp64 and rounded to their type once."""

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def matmul(a, b):
        return torch.matmul(a.double(), b.double()).to(a.dtype)


def with_fp64_maps(run):
    deform_conv.torch = _Fp64Maps()
    try:
        return run()
    finally:
        deform_conv.torch = torch


def recorded_window_backward(cfg, one, device):
    """The inputs and fp32 results of every stride-1 window backward at
    P3 (56 rows), in call order, on the host."""
    calls = []
    inner = dk.window_accumulate_taps_inpad_backward

    def record(h_all, oy, ox, gate, ct, m, K, kw=3):
        out = inner(h_all, oy, ox, gate, ct, m, K, kw)
        if h_all.shape[1] == 56:
            calls.append(([t.detach().cpu() for t in (h_all, oy, ox, gate, ct)],
                          [t.detach().cpu() for t in out[1:]], (m, K, kw)))
        return out

    record.launches = 0  # the wrapper counts its launches on the module's name
    dk.window_accumulate_taps_inpad_backward = record
    try:
        pool_grads(cfg, one, device)
    finally:
        dk.window_accumulate_taps_inpad_backward = inner
    return calls


def window_backward_fp64(h_all, oy, ox, gate, ct, m, K, kw):
    """d oy, d ox, d gate of the stride-1 window sum, the plain version's
    loops in fp64."""
    h_all, oy, ox, gate, ct = (t.double() for t in (h_all, oy, ox, gate, ct))
    B, H, W, KC = h_all.shape
    Cout = KC // K
    doy, dox, dg = (torch.zeros((B, K, H, W), dtype=torch.float64) for _ in range(3))
    for k in range(K):
        hp = dk._tap_padded(h_all, k, Cout, m, kw)
        for dy in range(-m, m + 2):
            wy, gy = dk._hat(oy[:, k], dy), dk._dhat(oy[:, k], dy)
            for dx in range(-m, m + 2):
                wx, gx = dk._hat(ox[:, k], dx), dk._dhat(ox[:, k], dx)
                s = (ct * hp[:, dy + m:dy + m + H, dx + m:dx + m + W]).sum(-1)
                doy[:, k] += gate[:, k] * gy * wx * s
                dox[:, k] += gate[:, k] * wy * gx * s
                dg[:, k] += wy * wx * s
    return doy, dox, dg


def compare_calls(card, card_pools, cpu, cpu_pools, path):
    """Print the pool leaves and the calls over 1e-4, card vs cpu; write
    every call to `path`."""
    for n in sorted(cpu_pools):
        print(f"  pool leaf {n}: norm {np.linalg.norm(card_pools[n]):.3e}, card vs cpu "
              f"{rel(card_pools[n], cpu_pools[n]):.3e}", flush=True)
    over = []
    theirs = {n: (out, g) for n, out, g in cpu}
    with open(path, "w") as f:
        for n, out_a, a in card:
            if n not in theirs:  # no gradient reached it on the cpu
                f.write(f"{n} {tuple(a.shape)} norm {np.linalg.norm(a):.3e}, none on the cpu\n")
                continue
            out_b, b = theirs[n]
            e = rel(a, b)
            line = f"{n} {tuple(a.shape)} norm {np.linalg.norm(a):.3e} err {e:.3e}"
            if ".offset#" in n:  # 18 offsets, then 9 gate logits
                flip = np.zeros(a.shape, bool)
                flip[..., :18] = kink_sides(out_a[..., :18], out_b[..., :18]).numpy()
                rest = np.where(flip, 0.0, a - b)
                for i in zip(*np.nonzero(flip)):
                    print(f"  {n}{list(i)}: offset {out_a[i].item():.9e} on the card, "
                          f"{out_b[i].item():.9e} on the cpu; gradient {a[i]:.6e} and "
                          f"{b[i]:.6e}", flush=True)
                line += (f"; {int(flip.sum())} offsets on two sides of an integer, the "
                         f"error without them {np.linalg.norm(rest) / np.linalg.norm(b):.3e}")
                if flip.any():
                    print(f"  {line}", flush=True)
            f.write(line + "\n")
            if e > 1e-4:
                over.append((n, np.linalg.norm(a), e))
    print(f"  every call: {path}", flush=True)
    print(f"  {len(over)} calls above 1e-4 (forward order; the last is nearest the loss):",
          flush=True)
    for n, norm, e in over[:20] + ([("...", 0.0, 0.0)] if len(over) > 40 else []) + \
            over[max(20, len(over) - 20):]:
        print(f"    {n}: norm {norm:.3e}, err {e:.3e}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_grad_where: no CUDA device", file=sys.stderr)
        return 1
    print(f"card: {chip_smoke.card_line()}", flush=True)
    cuda_build.build()
    out_dir = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build")
    os.makedirs(out_dir, exist_ok=True)
    for pool in sys.argv[1:] or ["sprompts"]:
        cfg = (GroundingConfig(batch_size=1, dtype="float32") if pool == "lpi" else
               chip_smoke.baseline_config(pool, "grounding", batch_size=1, dtype="float32"))
        tok = BertTokenizer(max_len=cfg.bert.max_query_len, vocab_size=cfg.bert.vocab_size)
        batch = next(synthetic_grounding_task(TASK, 4, 448, tok,
                                              max_boxes=cfg.max_boxes).batches(4))
        one = {k: v[:1] for k, v in batch.items()}
        outputs = []
        card, card_pools = traced_grads(cfg, one, "cuda",
                                        first=chip_smoke.outputs_recorded(outputs))
        cpu, cpu_pools = traced_grads(cfg, one, "cpu")
        print(f"== pool {pool}: {len(card)} module calls on the card, {len(cpu)} on the cpu",
              flush=True)
        compare_calls(card, card_pools, cpu, cpu_pools,
                      os.path.join(out_dir, f"grad_where_{pool}.txt"))
        pin, worst = chip_smoke.outputs_pinned(outputs)
        del cpu, outputs
        pinned, pinned_pools = traced_grads(cfg, one, "cpu", first=pin)
        print(f"== pool {pool}, every module output on the cpu set to the card's (largest "
              f"difference {max(worst):.3e} of the card's largest value)", flush=True)
        compare_calls(card, card_pools, pinned, pinned_pools,
                      os.path.join(out_dir, f"grad_where_{pool}_pinned.txt"))
        del card, pinned
        for i, ((a_in, a_out, taps), (b_in, b_out, _)) in enumerate(zip(
                recorded_window_backward(cfg, one, "cuda"),
                recorded_window_backward(cfg, one, "cpu"))):
            a64, b64 = window_backward_fp64(*a_in, *taps), window_backward_fp64(*b_in, *taps)
            print(f"  P3 window backward {i}: inputs card vs cpu h_all "
                  f"{rel(a_in[0].numpy(), b_in[0].numpy()):.3e}, ct "
                  f"{rel(a_in[4].numpy(), b_in[4].numpy()):.3e}", flush=True)
            for j, what in enumerate(("d oy", "d ox", "d gate")):
                a32, b32 = a_out[j].double().numpy(), b_out[j].double().numpy()
                print(f"    {what}: norm {np.linalg.norm(b32):.3e}; card vs cpu "
                      f"{rel(a32, b32):.3e}; cpu vs its fp64 {rel(b32, b64[j].numpy()):.3e}; "
                      f"card vs its fp64 {rel(a32, a64[j].numpy()):.3e}; fp64 from the card's "
                      f"inputs vs from the cpu's {rel(a64[j].numpy(), b64[j].numpy()):.3e}",
                      flush=True)
        cpu64 = with_fp64_maps(lambda: pool_grads(cfg, one, "cpu"))
        card64 = with_fp64_maps(lambda: pool_grads(cfg, one, "cuda"))
        for n in sorted(cpu64):
            print(f"  product maps in fp64: {n}: cpu vs cpu with fp32 maps "
                  f"{rel(cpu64[n], cpu_pools[n]):.3e}; card vs card with fp32 maps "
                  f"{rel(card64[n], card_pools[n]):.3e}; card vs cpu "
                  f"{rel(card64[n], cpu64[n]):.3e}", flush=True)
        images = torch.as_tensor(np.asarray(one["images"]), dtype=torch.float32)
        noise = torch.from_numpy(np.random.RandomState(0).choice([-1.0, 1.0], images.shape)
                                 .astype(np.float32))
        _, moved = traced_grads(cfg, one, "cuda", images * (1 + noise * 2.0 ** -23))
        for n in sorted(moved):
            print(f"  input moved by one rounding, on the card: {n} moves "
                  f"{rel(moved[n], card_pools[n]):.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
