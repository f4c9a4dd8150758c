"""Trajectory replay, agent control and forced streams through the port's
`Generator.generate` in temporal-cache mode with `tar_cache_refresh=1`
(2-frame float32 rings rebuilt from the window at frames 1 and 2), against
the JAX package's: the cases and bounds of test_torch_generate_control.py.
A refresh rebuilds the rings from the window the model reads, which under
agent control holds each earlier frame's overwrite (JAX's host mirror
`hist` / `pending_h`), not the output stream's sampled boxes: the priors
of the refreshed frames, hence every decision's logits, would move
otherwise."""

import pytest

from test_torch_generate_control import (CASES, check_trajectory_boxes,
                                         run_case, two_threads)  # noqa: F401


@pytest.mark.parametrize("case", CASES)
def test_refresh_control_matches_jax(case):
    out, _, gen, data = run_case(case, "refresh")
    if case == "trajectory":
        check_trajectory_boxes(out, data, recompute=False)
    assert gen.refreshes == 2
