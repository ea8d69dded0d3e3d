"""The port's weight fetch (`lpi_tpu_torch/core/fetch.py`, `fetch-weights`)
against the JAX package's, offline: every download goes through a stub
opener or a cache the test fills, and `urllib.request.urlopen` is replaced
by a function that fails the test, so that no case can reach a network.

The six cases of `tests/test_fetch.py` (cache and checksum policy, the
offline error, the CLIP pipeline end to end, `--list`, an unknown name),
with the converted npz held in bits to the port's converter and to the JAX
converter followed by `bridge` (`tests/test_torch_convert.py`'s route), and
the same for a GLIP checkpoint through the command line.
"""

import hashlib
import io
import os
import urllib.request

import numpy as np
import pytest
import torch
from flax import traverse_util

from lpi_tpu.core import config as jc
from lpi_tpu.core import fetch as jfetch
from lpi_tpu.models.clip import convert as jclip
from lpi_tpu.models.glip import convert as jglip
from lpi_tpu_torch import config as tc
from lpi_tpu_torch.bridge import params_from_jax, slinet_params_from_jax
from lpi_tpu_torch.cli import main as cli
from lpi_tpu_torch.core import fetch
from lpi_tpu_torch.models.clip import convert as tclip
from lpi_tpu_torch.models.glip import convert as tglip
from tests.test_glip_convert import TINY as J_GLIP_TINY
from tests.test_glip_convert import synthetic_glip_sd
from tests.test_torch_convert import _same, _with_pools

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def no_network(monkeypatch):
    def refuse(url, *args, **kwargs):
        raise AssertionError(f"a test tried to open {url}")

    monkeypatch.setattr(urllib.request, "urlopen", refuse)


def _serve(payload: bytes):
    """An opener that returns a fresh reader per call and counts the calls."""
    calls = []

    def opener(url):
        calls.append(url)
        return io.BytesIO(payload)

    return opener, calls


def test_the_registry_is_the_jax_packages():
    assert fetch.WEIGHTS == jfetch.WEIGHTS
    assert fetch.DEFAULT_ROOT == os.path.expanduser("~/.cache/lpi_tpu_torch") != jfetch.DEFAULT_ROOT


def test_download_verifies_and_caches(tmp_path):
    payload = b"weights-bytes"
    digest = hashlib.sha256(payload).hexdigest()
    opener, calls = _serve(payload)

    path = fetch.download("http://x/model.pt", str(tmp_path), digest, opener)
    assert open(path, "rb").read() == payload and len(calls) == 1
    # a cache hit: no second call
    assert fetch.download("http://x/model.pt", str(tmp_path), digest, opener) == path
    assert len(calls) == 1
    # a corrupt cache entry is fetched again
    with open(path, "wb") as f:
        f.write(b"corrupted")
    fetch.download("http://x/model.pt", str(tmp_path), digest, opener)
    assert open(path, "rb").read() == payload and len(calls) == 2
    assert os.listdir(tmp_path) == ["model.pt"]  # no temporary file left


def test_download_checksum_mismatch_raises(tmp_path):
    opener, calls = _serve(b"not-the-real-bytes")
    with pytest.raises(RuntimeError, match="sha256 mismatch"):
        fetch.download("http://x/model.pt", str(tmp_path), "0" * 64, opener)
    assert len(calls) == 2  # one retry, the reference's policy
    assert os.listdir(tmp_path) == []  # nothing half-cached


def test_download_offline_error_names_url(tmp_path):
    def opener(url):
        raise OSError("no route to host")

    for mod in (fetch, jfetch):
        with pytest.raises(RuntimeError, match="http://x/model.pt") as e:
            mod.download("http://x/model.pt", str(tmp_path / mod.__name__), None, opener)
        assert "offline?" in str(e.value)


def _clip_cfg(c):
    return c.CLIPConfig(image_resolution=32, patch_size=16, vision_width=64, vision_layers=2,
                        vision_heads=4, text_width=32, text_layers=2, text_heads=4,
                        vocab_size=128, context_length=16, embed_dim=32)


def test_fetch_weights_end_to_end_clip(tmp_path, monkeypatch):
    """A synthetic OpenAI-format checkpoint: download, verify, load,
    convert, npz, read back; equal in bits to the port's converter and to
    the JAX converter bridged."""
    sd = tclip.synthetic_state_dict(_clip_cfg(tc), 2)
    buf = io.BytesIO()
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, buf)
    payload = buf.getvalue()
    digest = hashlib.sha256(payload).hexdigest()
    opener, calls = _serve(payload)
    monkeypatch.setitem(fetch.WEIGHTS, "clip-vit-b-16",
                        dict(fetch.WEIGHTS["clip-vit-b-16"], sha256=digest))

    out = fetch.fetch_weights("clip-vit-b-16", root=str(tmp_path), opener=opener)
    assert out["sha256"] == digest and len(calls) == 1
    assert out["checkpoint"] == str(tmp_path / "ViT-B-16.pt")
    assert out["converted"] == str(tmp_path / "clip-vit-b-16.converted.npz")
    got = fetch.load_converted(out["converted"])
    _same(got, tclip.convert_openai_clip(sd))
    want = slinet_params_from_jax({"clip": jclip.convert_openai_clip(
        jclip.synthetic_state_dict(_clip_cfg(jc), 2))})
    want["clip.logit_scale"] = want["clip.logit_scale"].reshape(())
    _same(got, want)
    # no conversion: the checkpoint alone, from the cache
    again = fetch.fetch_weights("clip-vit-b-16", root=str(tmp_path), convert=False,
                                opener=opener)
    assert again["converted"] is None and len(calls) == 1


def test_cli_list(capsys):
    out = cli.main(["fetch-weights", "--list"])
    assert out == {"available": sorted(jfetch.WEIGHTS)}
    printed = capsys.readouterr().out
    assert "glip-t-a" in printed and "sha256" in printed and "unverified" in printed


def test_registry_unknown_name(tmp_path):
    with pytest.raises(KeyError, match="unknown weights"):
        fetch.fetch_weights("nope", root=str(tmp_path))
    assert not os.path.exists(tmp_path / "nope")


def test_cli_fetch_converts_a_cached_glip_checkpoint(tmp_path, capsys):
    """`fetch-weights glip-t-a --root R` with the checkpoint already in R
    (the registry has no checksum for it, so the cached file is taken):
    the port's GLIP converter runs, and the npz equals the JAX converter
    bridged."""
    sd = _with_pools(synthetic_glip_sd(J_GLIP_TINY, np.random.RandomState(0)),
                     np.random.RandomState(1))
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}, "iteration": 7},
               tmp_path / "glip_a_tiny_o365.pth")
    out = cli.main(["fetch-weights", "glip-t-a", "--root", str(tmp_path)])
    printed = capsys.readouterr().out
    assert f"converted:  {out['converted']}" in printed and out["sha256"] in printed
    got = fetch.load_converted(out["converted"])
    _same(got, tglip.convert_glip(sd)[0])
    jflat, _ = jglip.convert_glip(sd)
    _same(got, params_from_jax(traverse_util.unflatten_dict(jflat),
                               depths=J_GLIP_TINY.swin.depths))
    raw = cli.main(["fetch-weights", "glip-t-a", "--root", str(tmp_path), "--no-convert"])
    assert raw["converted"] is None and raw["sha256"] == out["sha256"]
