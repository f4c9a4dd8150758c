"""The agent metrics the CLI prints, and the control-pkl normalizer, against
the JAX package's.

The collision rate (`BoxOverlap`, over `collision_matrix`), the convex-clip
3D IoU (`box_iou_3d`), the time-to-collision attribute
(`generate_collision_attribute`, 2d and 3d) and MMD (`MMDMetric`) are numpy
on the host in both packages: on the same seeded boxes they must agree
within 1e-6 (the collision matrices and attributes exactly).
`normalize_control_pkl` must give JAX's dict for every alias of every key.
"""

import numpy as np
import pytest

from umgen_tpu.ops import collision as jcol
from umgen_tpu.ops import metrics as jmet
from umgen_tpu.tools import load_control_tokens as jlct
from umgen_tpu_torch.ops import collision as tcol
from umgen_tpu_torch.ops import metrics as tmet
from umgen_tpu_torch.tools import load_control_tokens as tlct


def _boxes(n, seed, spread=12.0):
    """n metric boxes [x y z l w h yaw vx vy vz] packed into a
    `spread`-metre square, so that some overlap; every fourth one
    stopped."""
    rng = np.random.default_rng(seed)
    b = np.zeros((n, 10), np.float32)
    b[:, 0:2] = rng.uniform(-spread, spread, (n, 2))
    b[:, 2] = rng.uniform(-1, 1, n)
    b[:, 3] = rng.uniform(0.6, 6.0, n)
    b[:, 4] = rng.uniform(0.6, 2.5, n)
    b[:, 5] = rng.uniform(1.0, 3.0, n)
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    b[:, 7:9] = rng.uniform(-3, 3, (n, 2))
    b[::4, 7:9] = 0.0
    return b


def _frames(seed, T=6):
    rng = np.random.default_rng(seed)
    return [_boxes(int(rng.integers(0, 25)), seed * 100 + t)
            for t in range(T)]


@pytest.mark.parametrize("n", [0, 1, 30])
def test_collision_matrix_matches_jax(n):
    boxes = _boxes(n, seed=n)
    mat = tcol.collision_matrix(boxes)
    np.testing.assert_array_equal(mat, jcol.collision_matrix_np(boxes))
    np.testing.assert_array_equal(mat, jcol.collision_matrix(boxes))
    if n == 30:
        assert 0 < mat.sum() < n * n      # the case exercises both answers


def test_box_iou_3d_matches_jax():
    a, b = _boxes(12, seed=1, spread=4.0), _boxes(9, seed=2, spread=4.0)
    va = tcol.box_vertices(a[:, :3], a[:, 3:6], -a[:, 6])
    vb = tcol.box_vertices(b[:, :3], b[:, 3:6], -b[:, 6])
    np.testing.assert_allclose(
        va, jcol.box_vertices(a[:, :3], a[:, 3:6], -a[:, 6]), rtol=0,
        atol=1e-6)
    inter, iou = tcol.box_iou_3d(va, vb)
    jinter, jiou = jcol.box_iou_3d(va, vb)
    np.testing.assert_allclose(inter, jinter, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(iou, jiou, rtol=1e-6, atol=1e-6)
    assert (iou > 0).any() and (iou == 0).any()


@pytest.mark.parametrize("mode", ["2d", "3d"])
def test_collision_attribute_matches_jax(mode):
    frames = _frames(seed=3, T=3)
    kw = dict(time_steps=8, mode=mode)
    got = tcol.generate_collision_attribute(frames, **kw)
    ref = jcol.generate_collision_attribute(frames, **kw)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    assert any((g < 8).any() for g in got)


def test_box_overlap_matches_jax():
    """The collision rate of several scenes: per frame and per scenario,
    within 1e-6 of JAX's."""
    mine, ref = tcol.BoxOverlap(), jcol.BoxOverlap()
    for seed in range(4):
        frames = _frames(seed)
        mine.update(frames)
        ref.update(frames)
    np.testing.assert_allclose(mine.average(), ref.average(), rtol=0,
                               atol=1e-6)
    assert mine.average()[0] > 0


def test_mmd_matches_jax():
    """MMD over the five attribute groups of three scenes, generated boxes
    against a GT continuation: within 1e-6 of JAX's, score for score."""
    mine, ref = tmet.MMDMetric(), jmet.MMDMetric()
    rng = np.random.default_rng(5)
    for seed in range(3):
        pb, rb = _boxes(20, seed), _boxes(17, seed + 50)
        pc, rc = rng.integers(0, 4, 20), rng.integers(0, 4, 17)
        mine.update(pb, pc, rb, rc)
        ref.update(pb, pc, rb, rc)
    for a in ref.attributes:
        np.testing.assert_allclose(mine.scores[a], ref.scores[a], rtol=1e-6,
                                   atol=1e-6)
    got, want = mine.average(), ref.average()
    assert sorted(got) == sorted(want)
    for a in want:
        assert abs(got[a] - want[a]) <= 1e-6, a
    assert tmet.mmd_score(np.zeros((0, 3)), np.ones((2, 3))) == 0.0


def _alias_cases():
    """One pkl per (key, alias), each with the dataset tokens under some
    alias; plus a pkl with nothing but the tokens."""
    for canon, aliases in jlct.KEY_ALIASES.items():
        for alias in aliases:
            data = {"gt_tokens": {"pose": np.zeros((2, 3), np.int64)},
                    alias: f"value-of-{alias}"}
            if canon == "dataset_token":
                data = {alias: {"pose": np.ones((2, 3), np.int64)}}
            yield pytest.param(data, id=f"{canon}-{alias}")
    yield pytest.param({"dataset_tokens": {}}, id="defaults")


@pytest.mark.parametrize("data", list(_alias_cases()))
def test_normalize_control_pkl_matches_jax(data):
    got = tlct.normalize_control_pkl(dict(data))
    want = jlct.normalize_control_pkl(dict(data))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_equal(got[k], want[k])


def test_normalize_control_pkl_refuses_a_pkl_without_tokens():
    with pytest.raises(KeyError, match="no dataset tokens"):
        tlct.normalize_control_pkl({"control_dict": {}})


def test_load_control_tokens_main_normalizes_a_directory(tmp_path):
    """`python -m umgen_tpu_torch.tools.load_control_tokens SRC --dst_dir
    DST`: every pkl of SRC normalized into DST, as JAX's main writes it."""
    import pickle
    src = tmp_path / "src"
    src.mkdir()
    scene = {"dataset_tokens": {"pose": np.arange(6).reshape(2, 3)},
             "init_tokens": {"pose": np.zeros((1, 3), np.int64)},
             "name": "s0", "cond_frames": 1}
    with open(src / "s0.pkl", "wb") as f:
        pickle.dump(scene, f)
    for mod, dst in ((tlct, tmp_path / "port"), (jlct, tmp_path / "jax")):
        mod.main([str(src), "--dst_dir", str(dst)])
    with open(tmp_path / "port" / "s0.pkl", "rb") as f:
        got = pickle.load(f)
    with open(tmp_path / "jax" / "s0.pkl", "rb") as f:
        want = pickle.load(f)
    assert sorted(got) == sorted(want) == sorted(
        ["dataset_token", "control_dict", "scene_name", "input_cond_frame"])
    for k in want:
        np.testing.assert_equal(got[k], want[k])
