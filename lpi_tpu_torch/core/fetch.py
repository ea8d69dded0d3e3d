"""Pretrained-weight fetch with sha256 verification, and conversion to the
port's names (counterpart of `lpi_tpu/core/fetch.py`).

    python -m lpi_tpu_torch.cli.main fetch-weights clip-vit-b-16
    python -m lpi_tpu_torch.cli.main fetch-weights glip-t-a --no-convert
    python -m lpi_tpu_torch.cli.main fetch-weights --list

Downloads cache under `--root` (default ~/.cache/lpi_tpu_torch): a cached
file whose sha256 matches is never fetched again; a mismatch downloads
once more and fails if still wrong (the reference's `clip.py:_download`
policy); a download goes to a temporary file that is renamed into place,
so nothing is cached half-written; a network error raises a RuntimeError
naming the URL. After the download the port's own converter runs
(`models/clip/convert.py:load_torch_clip`, `models/glip/convert.py:
convert_glip`) and the result is saved as `<name>.converted.npz`, keyed by
the port's dotted state-dict names, which `load_converted` reads back.
The JAX package keeps its own cache (~/.cache/lpi_tpu): its converted
files hold Flax paths, not these names.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
import urllib.request
from typing import Callable, Dict, Optional

import numpy as np
import torch

# name -> url, sha256 (None where the publisher ships none) and converter.
# OpenAI's CLIP URLs carry the checksum as their second-to-last segment;
# the GLIP zoo files publish none: those are checked for size only, and
# their digest is returned so that a user can pin it.
_OPENAI = "https://openaipublic.azureedge.net/clip/models"
_HF_GLIP = "https://huggingface.co/GLIPModel/GLIP/resolve/main"
_MSBLOB = "https://penzhanwu2bbs.blob.core.windows.net/data/GLIPv1_Open/models"

WEIGHTS: Dict[str, Dict] = {
    "clip-vit-b-16": {
        "url": f"{_OPENAI}/5806e77cd80f8b59890b7e101eabd078d9fb84e6937f9e85e4ecb61988df416f/ViT-B-16.pt",
        "sha256": "5806e77cd80f8b59890b7e101eabd078d9fb84e6937f9e85e4ecb61988df416f",
        "converter": "clip",
    },
    "clip-vit-b-32": {
        "url": f"{_OPENAI}/40d365715913c9da98579312b702a82c18be219cc2a73407c4526f58eba950af/ViT-B-32.pt",
        "sha256": "40d365715913c9da98579312b702a82c18be219cc2a73407c4526f58eba950af",
        "converter": "clip",
    },
    # GLIP-T(A): the frozen base model of the LPI grounding half
    "glip-t-a": {
        "url": f"{_HF_GLIP}/glip_a_tiny_o365.pth",
        "sha256": None,
        "converter": "glip",
    },
    "glip-t": {
        "url": f"{_HF_GLIP}/glip_tiny_model_o365_goldg_cc_sbu.pth",
        "sha256": None,
        "converter": "glip",
    },
    # Swin-T ImageNet initialisation
    "swin-t": {
        "url": f"{_MSBLOB}/swin_tiny_patch4_window7_224.pth",
        "sha256": None,
        "converter": None,
    },
}

DEFAULT_ROOT = os.path.expanduser("~/.cache/lpi_tpu_torch")


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def download(url: str, root: str = DEFAULT_ROOT, expected_sha256: Optional[str] = None,
             opener: Optional[Callable] = None, _retried: bool = False) -> str:
    """Fetch `url` into `root`, cached and checked against
    `expected_sha256`. `opener(url)` returns a readable file-like of the
    body (`urllib.request.urlopen` by default; tests pass their own). ->
    the cached file's path."""
    os.makedirs(root, exist_ok=True)
    target = os.path.join(root, os.path.basename(url))
    if os.path.exists(target) and not os.path.isfile(target):
        raise RuntimeError(f"{target} exists and is not a regular file")

    if os.path.isfile(target):
        if expected_sha256 is None or _sha256(target) == expected_sha256:
            return target
        os.remove(target)  # a stale or corrupt cache entry: fetch again

    opener = opener or urllib.request.urlopen
    try:
        source = opener(url)
    except Exception as e:  # any failure to open is reported with the URL
        raise RuntimeError(f"cannot download {url} ({e!r}); offline? fetch the file "
                           f"manually and place it at {target}") from e
    fd, tmp = tempfile.mkstemp(dir=root, suffix=".part")
    try:
        with os.fdopen(fd, "wb") as out, source:
            while True:
                buf = source.read(1 << 20)
                if not buf:
                    break
                out.write(buf)
        digest = _sha256(tmp)
        if expected_sha256 is not None and digest != expected_sha256:
            if not _retried:
                os.remove(tmp)
                return download(url, root, expected_sha256, opener, _retried=True)
            raise RuntimeError(f"sha256 mismatch for {url}: got {digest}, "
                               f"expected {expected_sha256}")
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return target


def _convert(name: str, ckpt_path: str, root: str) -> Optional[str]:
    """Run the registered converter and save its entries as a flat npz.
    The GLIP file is read with `weights_only=True` (no arbitrary objects
    unpickled): a checkpoint that holds more than tensors and plain
    containers is refused by `torch.load`, naming the type."""
    kind = WEIGHTS[name]["converter"]
    if kind is None:
        return None
    if kind == "clip":
        from lpi_tpu_torch.models.clip.convert import load_torch_clip

        state = load_torch_clip(ckpt_path)
    elif kind == "glip":
        from lpi_tpu_torch.models.glip.convert import convert_glip

        raw = torch.load(ckpt_path, map_location="cpu", weights_only=True)
        state, _unmapped = convert_glip(raw.get("model", raw))
    else:  # pragma: no cover - a registry invariant
        raise ValueError(f"unknown converter {kind!r}")
    out_path = os.path.join(root, f"{name}.converted.npz")
    np.savez(out_path, **{k: v.numpy() for k, v in state.items()})
    return out_path


def load_converted(path: str) -> Dict[str, torch.Tensor]:
    """A `<name>.converted.npz` -> {the port's state-dict name: tensor}."""
    with np.load(path) as z:
        return {k: torch.from_numpy(z[k]) for k in z.files}


def fetch_weights(name: str, root: str = DEFAULT_ROOT, convert: bool = True,
                  opener: Optional[Callable] = None) -> Dict[str, Optional[str]]:
    """Download, verify and (by default) convert one registry entry. ->
    {'checkpoint': path, 'converted': path or None, 'sha256': digest}."""
    if name not in WEIGHTS:
        raise KeyError(f"unknown weights {name!r}; available: {sorted(WEIGHTS)}")
    spec = WEIGHTS[name]
    ckpt = download(spec["url"], root, spec["sha256"], opener)
    converted = _convert(name, ckpt, root) if convert else None
    return {"checkpoint": ckpt, "converted": converted, "sha256": _sha256(ckpt)}
