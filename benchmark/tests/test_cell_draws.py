"""`correct` reads the program's draws through its public hook
`Rollout.draw_hook`: on every tiny twin the hook gives exactly the draws
that wrapping the rollout's samplers gave, a program that reports its draws
once a segment is judged as one that reports them once a position, and a
program that leaves a draw unreported fails by name."""

from typing import Dict, List

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.tests.cells import write_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(4)
    return write_root(tmp_path_factory.mktemp("checkout"))


class SamplerRecorder:
    """The benchmark's former reading of the draws, kept here only to hold
    the hook's reading to it: each of `Rollout._samplers` wrapped, its
    outputs in call order."""

    def __init__(self, rollout):
        self.calls: Dict[str, List[torch.Tensor]] = {}
        for mod, fn in list(rollout._samplers.items()):
            self.calls[mod] = []
            rollout._samplers[mod] = self._wrap(mod, fn)

    def _wrap(self, mod, fn):
        def draw(generator, logits):
            out = fn(generator, logits)
            self.calls[mod].append(out)
            return out
        return draw

    def take(self):
        out = self.calls
        self.calls = {m: [] for m in out}
        return out

    @staticmethod
    def frame_draws(calls, rows):
        """One call a map / image position, three an agent position (the
        OAR head, the control redraw, the TAR head), one ego action."""
        def st(xs):
            return torch.stack(xs, 1)[rows].cpu().numpy()
        bbox = calls["bbox3d"]
        return {"pose": calls["pose"][0][rows].cpu().numpy(),
                "map": st(calls["map"]), "image": st(calls["image"]),
                "bbox_ar": st(bbox[0::3]), "bbox_tar": st(bbox[2::3])}


@pytest.mark.parametrize("cell", ["tiny-cached", "tiny-recompute",
                                  "tiny-prefill"])
def test_hook_draws_equal_sampler_draws(root, cell, monkeypatch):
    """Frame by frame in the window, the hook's draws equal the wrapped
    samplers' on the same run."""
    old, pairs = [], []
    take = harness.Recorder.take

    def both(self):
        out = take(self)
        pairs.append((out, old[0].take()))
        return out
    monkeypatch.setattr(harness.Recorder, "take", both)
    out = harness.run_cell(cell, 2 ** 31 + 29, 0.5, False, device="cpu",
                           root=root, log=lambda s: None,
                           patch=lambda prog: old.append(
                               SamplerRecorder(prog.rollout)))
    assert out["correct"] is True, out["checks"]
    layout = harness.load_json(
        root / "benchmark" / "configs"
        / f"{cell.replace('-', '_')}.json")["model"]["layout"]
    B = harness.load_json(root / "benchmark" / "traffic"
                          / f"{cell.replace('-', '_')}.json")["scenes"]
    rows = np.arange(B)
    window = pairs[1:]              # the first take is set-up's
    assert len(window) == out["attempted"] // B >= 1
    for new, was in window:
        a = harness.frame_draws(new, rows, layout)
        b = SamplerRecorder.frame_draws(was, rows)
        assert set(a) == set(b)
        for k in a:
            assert a[k].shape == b[k].shape and np.array_equal(a[k], b[k]), k


def on_its_own(ro, hook):
    """The rollout's state on a plain `Rollout` whose draws hook is `hook`:
    a decode loop that does not go through the hook the rollout holds."""
    from umgen_tpu_torch.models.rollout import Rollout
    own = object.__new__(Rollout)
    own.__dict__.update(ro.__dict__)
    own.draw_hook = hook
    return own


def once_a_segment(prog):
    """A decode loop that reaches its samplers by another route and
    reports each map and image segment once, as a fused or captured loop
    would: the rollout's sampler table is replaced by a copy, the segment
    runs without the hook, and its tokens are one "served" report."""
    from umgen_tpu_torch.models.rollout import Rollout
    ro = prog.rollout
    ro._samplers = {m: (lambda f: lambda g, x: f(g, x))(f)
                    for m, f in ro._samplers.items()}

    def segment(params, mod, seg, *a, **k):
        state, tokens = Rollout._decode_plain_segment(
            on_its_own(ro, None), params, mod, seg, *a, **k)
        ro.draw_hook(mod, "served", seg.content_start, tokens)
        return state, tokens
    ro._decode_plain_segment = segment


def test_draws_reported_once_a_segment_are_correct(root):
    out = harness.run_cell("tiny-cached", 2 ** 31 + 31, 0.5, False,
                           device="cpu", root=root, log=lambda s: None,
                           patch=once_a_segment)
    assert out["correct"] is True, out["checks"]


def drops_a_draw(prog):
    """A decode loop that leaves one map position's draw unreported."""
    from umgen_tpu_torch.models.rollout import Rollout
    ro = prog.rollout
    fn = ro._decode_plain_segment

    def segment(params, mod, seg, *a, **k):
        if mod != "map":
            return fn(params, mod, seg, *a, **k)
        hook = ro.draw_hook
        return Rollout._decode_plain_segment(
            on_its_own(ro, lambda m, role, p, t: (
                None if p == seg.content_start + 5 else hook(m, role, p, t))),
            params, mod, seg, *a, **k)
    ro._decode_plain_segment = segment


def test_a_dropped_draw_fails_by_name(root):
    with pytest.raises(RuntimeError, match="Rollout.draw_hook"):
        harness.run_cell("tiny-recompute", 2 ** 31 + 37, 0.5, False,
                         device="cpu", root=root, log=lambda s: None,
                         patch=drops_a_draw)
