"""The port's native host library (`lpi_tpu_torch/native.py`, built here
from `native/lpi_native.cpp` by g++) against its plain numpy versions (the
JAX module's fallbacks, kept in the port), against `lpi_tpu.native`
running those fallbacks (its own library is not built for the tests, and
`_load` is held to None so that it never is), and, for `roi_align_cpu`,
against both packages' `ops/roi_align.py` (the JAX module raises there
without its library, `lpi_tpu/native.py:169`). Also the build: once under
concurrent callers, and a failed build raises with the compiler's words.
"""

import threading

import numpy as np
import pytest
import torch

from lpi_tpu import native as jnative
from lpi_tpu.ops.roi_align import roi_align as j_roi_align
from lpi_tpu_torch import native
from lpi_tpu_torch.ops.roi_align import roi_align as t_roi_align

torch.set_num_threads(1)
MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)


@pytest.fixture(autouse=True)
def jax_fallbacks(monkeypatch):
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_load", lambda: None)


def boxes_scores(seed, n=60):
    rng = np.random.RandomState(seed)
    xy = rng.rand(n, 2) * 40
    boxes = np.concatenate([xy, xy + rng.rand(n, 2) * 40 + 1], 1).astype(np.float32)
    scores = rng.permutation(n).astype(np.float32) / n + 0.01  # no ties
    scores[[3, 11]] = -np.inf
    return boxes, scores, rng.randint(0, 4, n).astype(np.int32)


def test_the_library_builds_and_loads():
    assert native.is_available()
    path = native.build()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert path.name.startswith("liblpi_native.") and path.suffix == ".so"


@pytest.mark.parametrize("thr", [0.3, 0.6])
def test_nms_and_ml_nms_match_the_plain_versions_and_jax(thr):
    boxes, scores, labels = boxes_scores(int(thr * 10))
    keep = native.nms_cpu(boxes, scores, thr)
    np.testing.assert_array_equal(keep, native.nms_cpu_plain(boxes, scores, thr))
    np.testing.assert_array_equal(keep, jnative.nms_cpu(boxes, scores, thr))
    assert 3 not in keep and 11 not in keep and 0 < len(keep) < 58
    ml = native.ml_nms_cpu(boxes, scores, labels, thr)
    np.testing.assert_array_equal(ml, native.ml_nms_cpu_plain(boxes, scores, labels, thr))
    np.testing.assert_array_equal(ml, jnative.ml_nms_cpu(boxes, scores, labels, thr))
    assert len(ml) >= len(keep)


def test_soft_nms_matches_the_plain_version_and_jax():
    boxes, scores, _ = boxes_scores(5)
    scores = np.where(np.isfinite(scores), scores, 0.0).astype(np.float32)
    ours, kept = native.soft_nms_cpu(boxes, scores, 0.5, 0.001)
    plain, kept_plain = native.soft_nms_cpu_plain(boxes, scores, 0.5, 0.001)
    theirs, kept_jax = jnative.soft_nms_cpu(boxes, scores, 0.5, 0.001)
    assert kept == kept_plain == kept_jax > 0
    np.testing.assert_allclose(ours, plain, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("size", [(13, 17), (26, 34), (31, 45)])
def test_resize_normalize_matches_the_plain_version_on_upsamples(size):
    """Within one 8-bit step of the source (1 / 255 / std), which the plain
    version (PIL) takes by rounding its uint8 output and interpolating in
    fixed point."""
    image = np.random.RandomState(sum(size)).randint(0, 256, (13, 17, 3)).astype(np.uint8)
    ours = native.resize_normalize(image, *size, MEAN, STD)
    plain = native.resize_normalize_plain(image, *size, MEAN, STD)
    np.testing.assert_array_equal(plain, jnative.resize_normalize(image, *size, MEAN, STD))
    assert ours.shape == (*size, 3) and ours.dtype == np.float32
    assert (np.abs(ours - plain) * STD * 255).max() <= 1.0 + 1e-4


def test_resize_normalize_downsamples_a_ramp_bilinearly():
    """A downsample is the classic half-pixel bilinear (PIL's plain version
    antialiases there, so the two filters differ by design)."""
    ramp = np.tile(np.linspace(0, 255, 32, dtype=np.float32), (32, 1))
    image = np.repeat(ramp[..., None], 3, axis=2).astype(np.uint8)
    got = native.resize_normalize(image, 16, 16, np.zeros(3), np.ones(3))
    xs = (np.arange(16) + 0.5) * 2 - 0.5
    want = np.interp(xs, np.arange(32), image[0, :, 0].astype(np.float32)) / 255.0
    np.testing.assert_allclose(got[8, :, 0], want, atol=1e-6)


def test_center_crop_matches_the_plain_version_and_jax():
    image = np.random.RandomState(0).rand(11, 14, 3).astype(np.float32)
    ours = native.center_crop(image, 4, 7)
    np.testing.assert_array_equal(ours, native.center_crop_plain(image, 4, 7))
    np.testing.assert_array_equal(ours, jnative.center_crop(image, 4, 7))


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_roi_align_cpu_matches_both_packages_roi_align(scale):
    rng = np.random.RandomState(int(scale * 4))
    feats = rng.rand(15, 12, 5).astype(np.float32)
    for roi in ([2.0, 1.0, 10.0, 9.0], [-4.0, 3.0, 30.0, 28.0], [5.0, 5.0, 5.5, 5.2]):
        roi = np.asarray(roi, np.float32)
        ours = native.roi_align_cpu(feats, roi, scale, 4, 2)
        rois = np.asarray([[0.0, *roi]], np.float32)
        plain = t_roi_align(torch.from_numpy(feats[None]), torch.from_numpy(rois), 4, scale)[0]
        np.testing.assert_allclose(ours, plain.numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(ours, np.asarray(j_roi_align(feats[None], rois, 4, scale)[0]),
                                   rtol=1e-5, atol=1e-6)
    with pytest.raises(RuntimeError, match="not built"):
        jnative.roi_align_cpu(feats, roi)


def test_concurrent_callers_build_once(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    calls = []
    run = native.subprocess.run
    monkeypatch.setattr(native.subprocess, "run",
                        lambda cmd, **kw: calls.append(cmd) or run(cmd, **kw))
    paths = []
    threads = [threading.Thread(target=lambda: paths.append(native.build())) for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert len(calls) == 1 and calls[0][1:5] == ["-O3", "-fPIC", "-shared", "-std=c++17"]
    assert len(set(paths)) == 1 and paths[0].parent == tmp_path and paths[0].exists()
    assert not list(tmp_path.glob("*.tmp"))


def test_a_failed_build_raises_with_the_compilers_words(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("int f() { return undeclared_name; }\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="undeclared_name"):
        native.build()
    assert not native.library_path().exists()
    monkeypatch.setattr(native, "compiler", lambda: None)
    with pytest.raises(RuntimeError, match="C\\+\\+ compiler"):
        native.build()
