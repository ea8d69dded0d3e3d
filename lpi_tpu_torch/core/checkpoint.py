"""Session checkpoints: the frozen base stored once, each session's pools
and task keys after it (counterpart of `lpi_tpu/core/checkpoint.py`, with
`torch.save` in place of orbax).

    <dir>/base/state.pt              frozen parameters, saved once
    <dir>/session_<k>/state.pt       {"pool_params", "visual_keys",
                                      "textual_keys"}, the keys as
                                      {"centers", "valid"}
    <dir>/session_<k>_results.json   the session's evaluation
    <dir>/latest                     the last session saved

Entries are keyed by the port's state-dict names and copied to the CPU
before the save, so a checkpoint written on the card loads on a machine
without one; loads use `torch.load(weights_only=True)`, which reads tensors
and plain containers only. Each file is written beside its place and
renamed into it, so a save that dies leaves the previous file whole. A JAX
checkpoint is carried over through `lpi_tpu_torch.bridge`.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Mapping, Optional

import torch

STATE = "state.pt"


def _to_cpu(tree):
    """Every tensor of a nested dict copied to the CPU, detached."""
    if isinstance(tree, Mapping):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.detach().to("cpu", copy=True)


def _keys_state(keys) -> Dict[str, torch.Tensor]:
    return {"centers": keys.centers, "valid": keys.valid}


class SessionCheckpointer:
    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def _save(self, name: str, state: Mapping) -> None:
        path = os.path.join(self.directory, name)
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, f"{STATE}.{os.getpid()}.tmp")
        torch.save(_to_cpu(state), tmp)
        os.replace(tmp, os.path.join(path, STATE))

    def _load(self, name: str) -> dict:
        return torch.load(os.path.join(self.directory, name, STATE), map_location="cpu",
                          weights_only=True)

    # -- the frozen base ---------------------------------------------------
    def save_base(self, frozen_params: Mapping[str, torch.Tensor]) -> None:
        self._save("base", frozen_params)

    def load_base(self) -> Dict[str, torch.Tensor]:
        return self._load("base")

    def has_base(self) -> bool:
        return os.path.exists(os.path.join(self.directory, "base", STATE))

    # -- per-session state -------------------------------------------------
    def save_session(self, session: int, pool_params: Mapping[str, torch.Tensor],
                     visual_keys=None, textual_keys=None,
                     results: Optional[dict] = None) -> None:
        state = {"pool_params": dict(pool_params)}
        if visual_keys is not None:
            state["visual_keys"] = _keys_state(visual_keys)
        if textual_keys is not None:
            state["textual_keys"] = _keys_state(textual_keys)
        self._save(f"session_{session}", state)
        if results is not None:
            with open(os.path.join(self.directory, f"session_{session}_results.json"), "w") as f:
                json.dump(results, f, default=float)
        with open(os.path.join(self.directory, "latest"), "w") as f:
            f.write(str(session))

    def load_session(self, session: int) -> dict:
        return self._load(f"session_{session}")

    def latest_session(self) -> Optional[int]:
        tag = os.path.join(self.directory, "latest")
        if not os.path.exists(tag):
            return None
        with open(tag) as f:
            return int(f.read().strip())
