"""The port's C++ prefetching loader (``stereoslam_tpu_torch/native``): its
build at first use, bit-exact in-order decode against cv2 and the JAX
package's loader, and ``kitti.frames``' fallback when it cannot be built."""

import logging

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from stereoslam_tpu.utils import kitti as jax_kitti  # noqa: E402
from stereoslam_tpu_torch.native import dataloader  # noqa: E402
from stereoslam_tpu_torch.utils import kitti  # noqa: E402

N_PAIRS = 12


@pytest.fixture(scope="module")
def png_sequence(tmp_path_factory):
    rng = np.random.default_rng(0)
    d = tmp_path_factory.mktemp("seq")
    (d / "image_0").mkdir()
    (d / "image_1").mkdir()
    imgs = []
    for i in range(N_PAIRS):
        left = rng.integers(0, 255, (48, 64), dtype=np.uint8)
        right = rng.integers(0, 255, (48, 64), dtype=np.uint8)
        cv2.imwrite(str(d / "image_0" / f"{i:06d}.png"), left)
        cv2.imwrite(str(d / "image_1" / f"{i:06d}.png"), right)
        imgs.append((left, right))
    with open(d / "times.txt", "w") as f:
        for i in range(N_PAIRS):
            f.write(f"{i * 0.1:.6f}\n")
    return d, imgs


@pytest.fixture(scope="module")
def native_lib():
    """The built library; skips only where g++ or libpng is not installed."""
    try:
        return dataloader.build_library()
    except dataloader.ToolchainMissing as e:
        pytest.skip(f"native toolchain unavailable: {e}")


def assert_frames_equal(out, imgs):
    assert len(out) == len(imgs)
    for i, (left, right, t) in enumerate(out):
        assert left.dtype == right.dtype == np.uint8
        np.testing.assert_array_equal(left, imgs[i][0])
        np.testing.assert_array_equal(right, imgs[i][1])
        assert t == float(f"{i * 0.1:.6f}")


def test_native_loader_builds_into_the_build_dir(native_lib):
    assert native_lib.parent == dataloader._BUILD_DIR
    assert native_lib.parent.name == "_build" and native_lib.parent.parent.name == "stereoslam_tpu_torch"
    # A second build of the same source reuses the library.
    assert dataloader.build_library() == native_lib


@pytest.mark.parametrize("prefetch,n_threads", [(3, 2), (1, 4)])
def test_native_loader_decodes_in_order(png_sequence, native_lib, prefetch, n_threads):
    d, imgs = png_sequence
    lp, rp, ts = kitti.load_image_paths(str(d))
    out = list(dataloader.stream_pairs(lp, rp, ts, prefetch=prefetch, n_threads=n_threads))
    assert_frames_equal(out, imgs)


def test_frames_uses_the_native_loader_and_says_so(png_sequence, native_lib, caplog):
    d, imgs = png_sequence
    with caplog.at_level(logging.INFO, logger=kitti.__name__):
        out = list(kitti.frames(str(d)))
    assert_frames_equal(out, imgs)
    assert [r.getMessage() for r in caplog.records] == [
        f"decoding {d} with the native libpng loader"]


def test_frames_falls_back_when_the_native_loader_fails(png_sequence, monkeypatch, caplog):
    d, imgs = png_sequence

    def unavailable():
        raise dataloader.ToolchainMissing("libpng is not installed (test)")

    monkeypatch.setattr(dataloader, "library", unavailable)
    with caplog.at_level(logging.INFO, logger=kitti.__name__):
        out = list(kitti.frames(str(d), prefetch=2))
    assert_frames_equal(out, imgs)
    (msg,) = [r.getMessage() for r in caplog.records]
    assert "thread pool of read_gray (cv2)" in msg and "libpng is not installed (test)" in msg
    # The same frames as the JAX package's loader yields.
    ref = list(jax_kitti.frames(str(d)))
    assert_frames_equal(ref, imgs)


def test_build_without_gxx_raises_toolchain_missing(tmp_path, monkeypatch):
    monkeypatch.setattr(dataloader, "_BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(dataloader.shutil, "which", lambda name: None)
    with pytest.raises(dataloader.ToolchainMissing, match="g\\+\\+"):
        dataloader.build_library()
    assert not (tmp_path / "_build").exists()
