"""Trajectory replay, agent control and forced streams through the port's
`Generator.generate` in temporal-cache mode (2-frame float32 rings, no
refresh), against the JAX package's: the cases and bounds of
test_torch_generate_control.py.  The agent-control overwrite of the
window's newest frame enters the rings in the frame step, before the frame
is ingested."""

import pytest

from test_torch_generate_control import (CASES, check_trajectory_boxes,
                                         run_case, two_threads)  # noqa: F401


@pytest.mark.parametrize("case", CASES)
def test_cached_control_matches_jax(case):
    out, _, gen, data = run_case(case, "cached")
    if case == "trajectory":
        check_trajectory_boxes(out, data, recompute=False)
    assert gen.refreshes == 0
