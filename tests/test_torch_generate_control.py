"""Trajectory replay, agent control and forced streams through the port's
`Generator.generate`, against the JAX package's, in recompute mode (this
file), cached mode (test_torch_generate_control_cached.py) and cached mode
with `tar_cache_refresh=1` (test_torch_generate_control_refresh.py).

Each case rolls one scene 3 frames past a 2-frame window (the window slides
from the second frame on; a refresh fires at frames 1 and 2), greedy, at
the tiny scale in float32 with plain attention (as tests/test_tar_cache.py
runs the JAX package's own window tests), the same parameters on both
sides.  JAX's Generator runs first with its sampler decisions recorded; the
port's replays them (tests/test_torch_slice.py), so every decision is held
by its logits: the port's logit for JAX's token within F32_ULPS of JAX's
top logit, and its argmax equal to JAX's token wherever JAX's top-2 gap is
wider.  The output streams must equal JAX's.  To keep each case to the
frame's 660 box positions, map and image are forced in every case; the
cases differ in what else steers the frames:

  * trajectory: `init_tokens` pose and bbox3d for 2 frames, no
    `control_test` — the pose stream runs out before the last frame, which
    samples its own ego action; recompute appends the init boxes to the
    stream and the window, the cached path its sampled ones (the
    reference's two loops differ, ROADMAP.md Queue 3);
  * agent: `control_test`, pose for all 3 frames, boxes for two agents
    (-1 elsewhere): the window's newest frame is overwritten before each
    frame, and the overwrite stays in the window as it slides;
  * forced: `forced_streams` map, image for 3 frames and pose for 2 (the
    pose rides trajectory control; the last frame samples its ego action).
"""

import jax
import numpy as np
import pytest
import torch

from test_torch_slice import _check_decisions, _decision_labels, _Recorder
from test_torch_slice import _Replay
from umgen_tpu.config import ModelConfig as JModelConfig
from umgen_tpu.data.synthetic import make_token_batch
from umgen_tpu.models.generate import Generator as JGenerator
from umgen_tpu.models.umgen import UMGen as JUMGen
from umgen_tpu_torch.config import ModelConfig
from umgen_tpu_torch.models.generate import Generator
from umgen_tpu_torch.models.umgen import UMGen
from umgen_tpu_torch.params import from_jax

W = 2              # the window: recompute's cond_frames, the rings' length
NEW = 3            # generated frames
# a float32 logit's drift from JAX's, in bf16 ulps of its scale (2^-15 of
# it): float32 summation orders, far below the bf16 rollouts' GAP_ULPS
F32_ULPS = 2.0 ** -8
CASES = ("trajectory", "agent", "forced")


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg_kw(mode):
    kw = dict(dtype="float32", param_dtype="float32", sample_method="greedy",
              use_pallas_attention=False, tar_cache_dtype="float32",
              oar_cache_dtype="float32", tar_cache_window=W)
    if mode == "recompute":
        return dict(kw, tar_mode="recompute")
    return dict(kw, tar_mode="temporal_cache",
                tar_cache_refresh=1 if mode == "refresh" else 0)


def _inputs(case, layout, cfg):
    """(cond, generate's keyword arguments, the modalities forced per
    frame, whether the ego action is forced per frame)."""
    cond = make_token_batch(layout, T=W, B=1, seed=0, config=cfg)
    data = {m: v.astype(np.int64) for m, v in
            make_token_batch(layout, T=NEW, B=1, seed=1,
                             config=cfg).items()}
    forced = {"map": data["map"], "image": data["image"]}
    if case == "trajectory":
        kw = dict(init_tokens={"pose": data["pose"][:, :2],
                               "bbox3d": data["bbox3d"][:, :2]},
                  forced_streams=forced)
        ego = [True, True, False]
    elif case == "agent":
        ctrl = np.full_like(data["bbox3d"], -1)
        ctrl[:, :, 11:33] = data["bbox3d"][:, :, 11:33]    # agents 1 and 2
        kw = dict(init_tokens={"pose": data["pose"], "bbox3d": ctrl},
                  control_test=True, forced_streams=forced)
        ego = [True] * NEW
    else:
        kw = dict(forced_streams=dict(forced, pose=data["pose"][:, :2]))
        ego = [True, True, False]
    return cond, kw, ego, data


def run_case(case, mode):
    """JAX's and the port's rollout of `case` in `mode`; holds every
    decision and the streams.  Returns (port out, JAX out, the port's
    Generator, the case's data)."""
    cfg = ModelConfig(**_cfg_kw(mode)).scaled("tiny")
    jmodel = JUMGen(JModelConfig(**_cfg_kw(mode)).scaled("tiny"))
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    cond, kw, ego, data = _inputs(case, jmodel.layout, cfg)
    gen_kw = dict(new_frames=NEW, cond_frames=W, input_cond_frames=W, **kw)
    jgen = JGenerator(jmodel, jparams, seed=0)
    rec = _Recorder(jgen.rollout)
    jout = jgen.generate(cond, **gen_kw)
    jax.effects_barrier()

    gen = Generator(UMGen(cfg), from_jax(jparams), device="cpu")
    replay = _Replay(gen.rollout, rec.calls)
    out = gen.generate(cond, **gen_kw)
    labels = [lab for forced_ego in ego for lab in _decision_labels(
        gen.model.layout, frame_ego=not forced_ego,
        forced=("map", "image"))]
    worst = _check_decisions(rec.calls, replay.seen, labels,
                             frame=f"1-{NEW}", ulps=F32_ULPS)
    assert len(gen.frame_seconds) == NEW
    for m in jout:
        assert out[m].shape == jout[m].shape == (1, W + NEW,
                                                 jout[m].shape[-1]), m
        np.testing.assert_array_equal(out[m], jout[m], err_msg=m)
    # what every mode shares: the forced rows and the replayed pose
    for m in ("map", "image"):
        np.testing.assert_array_equal(out[m][:, W:], data[m], err_msg=m)
    n_pose = NEW if case == "agent" else 2
    np.testing.assert_array_equal(out["pose"][:, W:W + n_pose],
                                  data["pose"][:, :n_pose])
    print(f"{case}, {mode}: decision logits within {worst:.3g} bf16 ulps "
          "of JAX's")
    return out, jout, gen, data


def check_trajectory_boxes(out, data, recompute):
    """The reference's two loops append different boxes under trajectory
    replay without control_test: recompute the init boxes, the cached
    path the sampled ones."""
    init_boxes = data["bbox3d"][:, :2]
    if recompute:
        np.testing.assert_array_equal(out["bbox3d"][:, W:W + 2], init_boxes)
    else:
        assert (out["bbox3d"][:, W:W + 2] != init_boxes).any()


@pytest.mark.parametrize("case", CASES)
def test_recompute_control_matches_jax(case):
    out, _, gen, data = run_case(case, "recompute")
    if case == "trajectory":
        check_trajectory_boxes(out, data, recompute=True)
    assert gen.refreshes == 0


def test_recompute_window_keeps_the_overwrite(monkeypatch):
    """Under agent control the frame step of frame 2 reads a window whose
    older frame carries frame 1's agent overwrite (the reference's
    persistent window mutation), not the sampled boxes of `out`."""
    from umgen_tpu_torch.models.rollout import FrameOutputs, Rollout
    cfg = ModelConfig(**_cfg_kw("recompute")).scaled("tiny")
    model = UMGen(cfg)
    cond, kw, _, data = _inputs("agent", model.layout, cfg)
    seen = []

    def step(self, params, inputs, generator, **k):
        seen.append(inputs["bbox3d"].numpy().copy())
        lo = self.layout
        tokens = torch.zeros(1, lo.seq_len, dtype=torch.long)
        tokens[:, lo.slices()["pose"]] = k["pose_override"]
        return FrameOutputs(tokens=tokens, pose_tokens=k["pose_override"],
                            prior_seq=torch.zeros(1, 1))

    monkeypatch.setattr(Rollout, "frame_step", step)
    out = Generator(model, {}, device="cpu").generate(
        cond, new_frames=NEW, cond_frames=W, input_cond_frames=W, **kw)
    ctrl = kw["init_tokens"]["bbox3d"]
    for idx, window in enumerate(seen):
        # the newest frame overwritten where the control is not -1
        valid = ctrl[:, idx] != -1
        np.testing.assert_array_equal(window[:, -1][valid],
                                      ctrl[:, idx][valid])
        if idx:       # the older frame kept the previous frame's overwrite
            prev = ctrl[:, idx - 1] != -1
            np.testing.assert_array_equal(window[:, -2][prev],
                                          ctrl[:, idx - 1][prev])
    # the output stream holds the sampled boxes (all zero here)
    assert (out["bbox3d"][:, W:] == 0).all()
