"""The port's native collision-matrix helper (umgen_tpu_torch/native/),
built with g++ at first use, against the numpy version — as
tests/test_native_collision.py holds the JAX package's — and its source
against the JAX package's copy.  Bit for bit: a collision matrix is
boolean."""

import filecmp
import os

import numpy as np
import pytest

from umgen_tpu.ops import collision as jcol
from umgen_tpu_torch import native
from umgen_tpu_torch.ops import collision as tcol


def _rand_boxes(seed, n):
    rng = np.random.default_rng(seed)
    boxes = np.zeros((n, 10), np.float32)
    boxes[:, 0:2] = rng.uniform(-20, 20, (n, 2))
    boxes[:, 3] = rng.uniform(2, 6, n)
    boxes[:, 4] = rng.uniform(1, 3, n)
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return boxes


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_matches_numpy(seed):
    boxes = _rand_boxes(seed, 40)
    got = native.collision_matrix(boxes)
    np.testing.assert_array_equal(got, tcol.collision_matrix_np(boxes))
    np.testing.assert_array_equal(got, jcol.collision_matrix_np(boxes))
    assert got.any() and not got.diagonal().any()
    # ops.collision's matrix is the helper's
    np.testing.assert_array_equal(tcol.collision_matrix(boxes), got)


def test_native_empty():
    out = native.collision_matrix(np.zeros((0, 10), np.float32))
    assert out.shape == (0, 0) and out.dtype == bool
    assert tcol.collision_matrix(np.zeros((0, 10), np.float32)).shape == \
        (0, 0)


def test_native_identical_boxes_no_self_collision():
    boxes = np.tile(_rand_boxes(3, 1), (2, 1))
    got = native.collision_matrix(boxes)
    # identical boxes: strict semantics → no proper crossing, no strict
    # containment
    assert not got.any()
    np.testing.assert_array_equal(got, tcol.collision_matrix_np(boxes))


def test_native_source_is_the_jax_packages():
    jax_source = os.path.join(os.path.dirname(jcol.__file__), os.pardir,
                              "native", "collision.cc")
    assert filecmp.cmp(native.SOURCE, jax_source, shallow=False)
    assert native.library_path().parent == native.BUILD_DIR


def test_failed_build_raises(monkeypatch, tmp_path):
    """A build that fails raises with g++'s message; nothing falls back to
    numpy."""
    bad = tmp_path / "collision.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tcol.collision_matrix(_rand_boxes(0, 4))
