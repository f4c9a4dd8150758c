"""The CLI's `--dp 2` on the CPU, end to end from a fresh interpreter
(tests/test_torch_import.py's `_run_cli`): the two gloo ranks the CLI
starts itself stand alone — each rank's sys.modules holds neither JAX nor
the JAX package (tests/torch_dp_worker.py's `cli_rank` wraps the rank
`--dp` reaches) — and rank 0 writes the one-process run's token pickle bit
for bit and prints its metric lines.  One scene, `--batch_size 2`: the
harness pads it to two, one a rank.  (A file of its own: the CLI runs take
≈ 95 s, and tests/test_torch_import.py is the suite's longest file.)"""

import os
import pickle

import numpy as np

from test_torch_import import FUSED, _run_cli


def _metric_lines(stdout):
    return [ln for ln in stdout.splitlines()
            if ln.startswith(("collision rate:", "MMD ", "Sucess"))]


def test_dp_cli_ranks_stand_alone_and_write_the_one_process_pickles(
        tmp_path):
    one, dp = tmp_path / "one", tmp_path / "dp"
    want_out = _run_cli(one, *FUSED)
    out = _run_cli(dp, *FUSED, "--dp", "2", "--batch_size", "2", threads=4)
    assert "RANK_0_STANDS_ALONE_OK" in out and "RANK_1_STANDS_ALONE_OK" in out
    lines = _metric_lines(out)
    assert lines == _metric_lines(want_out) and len(lines) == 3, lines
    [name] = os.listdir(dp / "saved_token")
    with open(dp / "saved_token" / name, "rb") as f:
        got = pickle.load(f)
    with open(one / "saved_token" / name, "rb") as f:
        want = pickle.load(f)
    for m in want:
        np.testing.assert_array_equal(got[m], want[m], err_msg=m)
