"""The harness end to end at a tiny scale on the CPU, below the entry
point that refuses a machine without a card: two cells written only as
data files (a configuration, a traffic mix, entries in BENCHMARK.json).
The program runs the kernels' plain versions here."""

import json

import pytest
import torch

from benchmark import harness
from benchmark.tests.cells import write_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(4)
    return write_root(tmp_path_factory.mktemp("checkout"))


@pytest.mark.parametrize("cell", ["tiny-cached", "tiny-recompute"])
def test_cell_written_as_data_runs_and_is_correct(root, cell):
    out = harness.run_cell(cell, 2 ** 31 + 17, 0.5, False, device="cpu",
                           root=root, log=lambda s: None)
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"frames_per_s", "peak_mem_gib",
                                   "setup_s"}
    assert list(out)[-1] == "checks"
    assert out["checks"]["rule_mismatch"]["value"] == 0
    json.dumps(out)


@pytest.mark.parametrize("cell,control,number", [
    ("tiny-cached", {"extra_flags": ["--tar_w4"]}, "prior_err"),
    ("tiny-recompute", {"control_act": "float8_e4m3fn"}, "prior_err"),
    ("tiny-prefill", {"extra_flags": ["--kv_dtype", "float8_e4m3fn"]},
     "ring_mismatch"),
    ("tiny-prefill", {"control_act": "float8_e4m3fn"}, "prior_err")])
def test_control_is_not_correct(root, cell, control, number):
    """Each configuration's control fails a compared number: the program on
    its int4 path for int8 TAR weights; the program's fp8 rings for the
    stated bf16 ones, caught by the rings' stored format (their priors
    read as the bf16 rings' do); the reference in fp8 activations in the
    program's place (both stander cells)."""
    out = harness.run_cell(cell, 4242, 0.5, False, device="cpu", root=root,
                           log=lambda s: None, **control)
    assert out["correct"] is False
    assert out["checks"][number]["value"] > out["checks"][number]["limit"]


def test_rings_below_their_stated_format_are_counted():
    """`ring_mismatch` on rings made by hand: sound bf16 rings count
    nothing; a stack whose rings are fp8, fp8 values held in bf16, all
    zeros, float32 or missing counts once."""
    conf = {"ring_check": {"format": "bfloat16",
                           "stacks": ["tar", "ego_tar", "map_tar"]}}
    g = torch.Generator().manual_seed(3)

    def ring(dtype=torch.bfloat16):
        return tuple(torch.randn(2, 6, 3, 4, 8, generator=g).to(dtype)
                     for _ in range(2))
    sound = {"frames": 5, "tar": ring(), "ego_tar": ring(), "map_tar": ring()}
    assert harness.ring_mismatch(conf, sound) == 0
    fp8_in_bf16 = tuple(t.to(torch.float8_e4m3fn).to(torch.bfloat16)
                        for t in ring())
    for bad in (ring(torch.float8_e4m3fn), fp8_in_bf16,
                tuple(torch.zeros_like(t) for t in ring()),
                ring(torch.float32), None):
        rings = dict(sound, ego_tar=bad)
        if bad is None:
            del rings["ego_tar"]
        assert harness.ring_mismatch(conf, rings) == 1
    assert harness.ring_mismatch(conf, None) == 3


def test_readers_on_a_traced_run():
    """Each per-layer reader on a traced run's data, and nothing where
    there is nothing to read."""
    m = {"n_oar_layer": 2, "n_embd": 768, "n_head": 16}
    ops = [("k1", 10.0, "bench.oar_step"), ("k2", 30.0, "bench.oar_step"),
           ("glue", 5.0, None), ("fl", 20.0, "bench.flash")]
    s = {"busy_s": 0.0005, "window_s": 2.0, "ops": ops, "gaps": {}}
    c = dict(s, busy_s=0.004, window_s=1.25)
    t = {"frames": 2, "scenes": 10, "window_s": 4.0,
         "spans_ms": {"ego": [1.0, 3.0], "tar": [4.0, 4.0],
                      "oar": [10.0, 12.0]},
         "sessions": [c, s], "cascade": c, "decode": s,
         "oar_calls": [(1, 1, 100)], "flash_calls": [(2, 8, 8, False, 16, 48)],
         "decode_steps": 2, "decode_calls": 20, "decode_work": {"name": "v5", "kv": "int8"},
         "model": m, "frame_flops": 1e12}
    from benchmark import work
    r = {n: harness.reader(n)(t) for n in (
        "ego_tar_ms_per_frame", "oar_ms_per_frame", "oar_launches_per_step",
        "decode_step_roofline", "flash_roofline", "mfu", "device_idle")}
    assert r["ego_tar_ms_per_frame"] == 6.0 and r["oar_ms_per_frame"] == 11.0
    assert r["oar_launches_per_step"] == 2.0
    b = work.bound(*work.decode_work("v5", 2, 768, 16, 1, 1, 100))
    assert r["decode_step_roofline"] == pytest.approx(
        100 * b["bound_ms"] / 0.04)
    fb = work.bound(*work.flash_work(2, 8, 8, False))
    assert r["flash_roofline"] == pytest.approx(100 * fb["bound_ms"] / 0.02)
    assert r["mfu"] == pytest.approx(100 * 2 * 10 * 1e12 / (4 * 989e12))
    # the 2 profiled decode steps stand for the frame's 20, over the
    # unprofiled spans' 34 ms of 2 frames
    assert r["device_idle"] == pytest.approx(
        100 * (1 - (0.004 + 10 * 0.0005) / 0.017))
    empty = dict(t, decode=None, cascade=None, sessions=[],
                 spans_ms={}, frames=0)
    assert all(harness.reader(n)(empty) is None for n in r)


def test_a_lower_stored_format_is_not_correct(root):
    """The program's own int8 path for weights the configuration states in
    bf16 (`--int8 all` on the recompute cell) is caught by the stored
    format of its TAR stacks."""
    out = harness.run_cell("tiny-recompute", 4243, 0.5, False, device="cpu",
                           root=root, log=lambda s: None,
                           extra_flags=["--int8", "all"])
    assert out["checks"]["stored_mismatch"]["value"] > 0
    assert out["correct"] is False


def test_draws_read_otherwise_fail_by_name():
    """A frame whose draws were reported otherwise than one of each judged
    role a content position (or one served segment covering it) stops the
    run with the hook named."""
    layout = [["pose", 3, 0, 1], ["map", 4, 2, 3], ["bbox3d", 2, 4, 5],
              ["image", 1, 6, 7]]
    assert harness.content_positions(layout) == {
        "pose": range(2, 5), "map": range(7, 11), "bbox3d": range(13, 15),
        "image": range(17, 18)}
    ego = torch.arange(6).view(2, 3)
    tok = torch.tensor([5, 6])
    calls = [("pose", "ego", 2, ego), ("map", "served", 7,
                                       torch.arange(8).view(2, 4))]
    for p in (13, 14):
        calls += [("bbox3d", r, p, tok + i)
                  for i, r in enumerate(("ar", "control", "tar"))]
    calls.append(("image", "ar", 17, tok))
    got = harness.frame_draws(harness.Draws(calls), [1], layout)
    assert got["pose"].tolist() == [[3, 4, 5]]
    assert got["map"].tolist() == [[4, 5, 6, 7]]
    assert got["bbox_ar"].tolist() == [[6, 6]]
    assert got["bbox_tar"].tolist() == [[8, 8]]
    assert got["image"].tolist() == [[6]]
    for bad in ([c for c in calls if c[:3] != ("bbox3d", "tar", 14)],
                calls + [("map", "ar", 9, tok)],
                calls[:1] + calls[2:]):
        with pytest.raises(RuntimeError, match="Rollout.draw_hook"):
            harness.frame_draws(harness.Draws(bad), [0], layout)
