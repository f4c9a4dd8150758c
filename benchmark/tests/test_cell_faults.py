"""A run with the timed path broken underneath comes out not correct: the
faults a rollout on one card can have (no exchange between cards here)."""

import pytest
import torch

from benchmark import harness
from benchmark.tests.cells import write_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(4)
    return write_root(tmp_path_factory.mktemp("checkout"))


def altered_token(prog):
    """A token altered where it is produced: the map sampler's draw + 1."""
    ro = prog.rollout
    fn = ro._samplers["map"]
    ro._samplers["map"] = lambda g, logits: (fn(g, logits) + 1) % 8192


def rings_unchanged(prog):
    """A step that returns its state unchanged: the cached stacks' rings
    are restored after every frame's write."""
    model = prog.model
    fn = model._run_tar_stack_cached

    def frozen(params, name, ln, x, kv, slot, n_valid):
        before = [t.clone() for t in kv]
        out, kv = fn(params, name, ln, x, kv, slot, n_valid)
        for t, b in zip(kv, before):
            t.copy_(b)
        return out, kv
    model._run_tar_stack_cached = frozen


def half_batch(prog):
    """Half of the batch left out: the second half of the scenes take the
    first half's TAR priors."""
    model = prog.model
    fn = model.tar_priors_cached

    def half(*a, **k):
        out = fn(*a, **k)
        p = out["prior_seq"]
        h = p.shape[0] // 2
        p[h:2 * h] = p[:h]
        return out
    model.tar_priors_cached = half


@pytest.mark.parametrize("cell,fault", [
    ("tiny-cached", altered_token), ("tiny-cached", rings_unchanged),
    ("tiny-cached", half_batch), ("tiny-recompute", altered_token),
    ("tiny-prefill", altered_token), ("tiny-prefill", rings_unchanged)])
def test_fault_is_not_correct(root, cell, fault):
    """Every fault the cell can have: the recompute cell carries no state
    across frames, and it and the prefill cell run one scene."""
    out = harness.run_cell(cell, 777, 0.5, False, device="cpu", root=root,
                           patch=fault, log=lambda s: None)
    assert out["correct"] is False, out["checks"]
