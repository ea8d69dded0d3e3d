"""The port's config copy loads every repo config exactly as the JAX one."""

import glob
import os

import pytest

from lpi_tpu.core import config as jax_config
from lpi_tpu_torch import config as torch_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "**", "*.json"), recursive=True))


def test_configs_found():
    assert len(CONFIGS) >= 10


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: os.path.relpath(p, REPO))
def test_config_to_dict_equal(path):
    assert (torch_config.to_dict(torch_config.load_config(path))
            == jax_config.to_dict(jax_config.load_config(path)))


def test_defaults_and_overrides_equal():
    over = {"grounding": {"dyhead": {"channels": 128}, "dtype": "float32"}}
    assert (torch_config.to_dict(torch_config.load_config(None, over))
            == jax_config.to_dict(jax_config.load_config(None, over)))
    with pytest.raises(KeyError):
        torch_config.load_config(None, {"grounding": {"no_such_key": 1}})
