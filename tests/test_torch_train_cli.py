"""The port's train CLI (umgen_tpu_torch/tools/train.py) on the CPU, against
the JAX CLI where the two can be compared without a training run on JAX's
side: the batch iterator's draws, train_meta.json, and the dtypes of the
saved state (`--param_dtype` is read by nothing in either package).  A
`--resume` from a saved step must continue exactly as the uninterrupted run
did, `--remat` must change no bit, and the multi-GPU flags are refused.

Both CLIs restart the batch iterator from `--seed` on `--resume` (the JAX
CLI's behaviour, kept): a resumed run's first batch is the run's first, not
the one the uninterrupted run took next.  So the resume test picks the
smallest seed whose first two batches are the same window (one synthetic
scene, B = 1: the window's start is the only draw) and checks that it is.
"""

import contextlib
import io
import json
import os

import jax
import numpy as np
import pytest
import torch

from umgen_tpu.tools import train as jtrain_cli
from umgen_tpu_torch.config import DataConfig
from umgen_tpu_torch.data.dataset import NuPlanTokenDataset
from umgen_tpu_torch.data.synthetic import write_synthetic_dataset
from umgen_tpu_torch.models.umgen import NotPortedError
from umgen_tpu_torch.parallel import optim
from umgen_tpu_torch.runtime import checkpoint as ckpt
from umgen_tpu_torch.tools import train as train_cli

# a run small enough for the CPU: one scene, B = 1, a 3-frame window
SMALL = ["--model_scale", "tiny", "--synthetic_data", "1",
         "--batch_size", "1", "--window", "3"]


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    # the suite runs several workers on the same cores
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _dataset(tmp_path, n, window, seed=0):
    root = str(tmp_path / "scenes")
    write_synthetic_dataset(root, n_scenes=n, seed=seed)
    return NuPlanTokenDataset(DataConfig(data_root=(root,),
                                         block_size=window + 2))


def test_batch_iterator_draws_as_jax(tmp_path):
    data = _dataset(tmp_path, 3, window=4)
    mine = train_cli.batch_iterator(data, 2, 4, seed=7)
    ref = jtrain_cli.batch_iterator(data, 2, 4, seed=7)
    for _ in range(5):
        a, b = next(mine), next(ref)
        assert sorted(a) == sorted(b)
        for m in a:
            assert a[m].dtype == np.int32
            np.testing.assert_array_equal(a[m], b[m], m)


def _port(tmp_path, name, *flags):
    d = tmp_path / name
    argv = [*SMALL, "--device", "cpu", "--ckpt_dir", str(d),
            "--data_root", str(tmp_path / "absent"), *flags]
    assert train_cli.main(argv) == 0
    return d


def test_train_meta_and_param_dtypes_match_the_jax_cli(tmp_path):
    """`--steps 0` (no step on either side): train_meta.json equal key for
    key, and the saved state's leaves of the same dtypes — bf16 but
    `tpe_rel` under `--param_dtype float32`, in both."""
    flags = ["--steps", "0", "--optimizer", "sgd", "--temporal_pe",
             "relative", "--oar_label_smooth", "0.1", "--oar_loss_weight",
             "0.5", "--param_dtype", "float32"]
    mine = _port(tmp_path, "port", *flags)
    ref = tmp_path / "jax"
    assert jtrain_cli.main([*SMALL, "--ckpt_dir", str(ref), "--data_root",
                            str(tmp_path / "absent"), *flags]) == 0
    with open(mine / "train_meta.json") as f, \
            open(ref / "train_meta.json") as g:
        assert json.load(f) == json.load(g)
    from umgen_tpu.runtime import checkpoint as jckpt
    want = jckpt.load_params(str(ref / "final"), host=True)["params"]
    got = ckpt.load_params(str(mine / "final"), host=True)["params"]
    n = 0
    for path, a in jax.tree_util.tree_leaves_with_path(want):
        t = got
        for k in path:
            t = t[k.key]
        assert str(t.dtype)[6:] == str(a.dtype), jax.tree_util.keystr(path)
        assert tuple(t.shape) == a.shape
        n += 1
    assert n > 100


def _seed_with_equal_first_batches(tmp_path):
    data = _dataset(tmp_path, 1, window=3)
    for seed in range(20):
        it = train_cli.batch_iterator(data, 1, 3, seed=seed)
        a, b = next(it), next(it)
        if all(np.array_equal(a[m], b[m]) for m in a):
            return seed
    raise AssertionError("no seed below 20 draws the same window twice")


@pytest.fixture(scope="module")
def run_a(tmp_path_factory):
    """Two steps, both saved, from a seed whose first two batches are the
    same window; the printed lines."""
    tmp = tmp_path_factory.mktemp("a")
    seed = str(_seed_with_equal_first_batches(tmp))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        a = _port(tmp, "a", "--steps", "2", "--save_every", "1",
                  "--log_every", "1", "--seed", seed)
    return {"dir": a, "seed": seed, "out": out.getvalue(), "tmp": tmp}


def _same_state(got_path, want_path):
    """Two saved train states equal leaf for leaf, bit for bit; → the
    step."""
    want = ckpt.load_params(str(want_path), host=True)
    got = ckpt.load_params(str(got_path), host=True)
    n = 0
    for x, y in zip(optim.tree_leaves(got), optim.tree_leaves(want)):
        assert x.dtype == y.dtype and torch.equal(x, y)
        n += 1
    assert n > 300
    return int(got["step"])


def test_resume_continues_as_the_uninterrupted_run(run_a, capsys):
    """Run A takes two steps and saves both; run B resumes from A's first
    and takes one: B's final state (params, optimizer state, step) equals
    A's bit for bit.  The JAX CLI's line is printed at each step."""
    a = run_a["dir"]
    for i in (1, 2):
        assert f"step {i}/2 loss=" in run_a["out"] and \
            f"saved {a}/step_000000{i}" in run_a["out"]
    b = _port(run_a["tmp"], "b", "--steps", "1", "--seed", run_a["seed"],
              "--resume", str(a / "step_0000001"))
    assert f"resumed from {a}/step_0000001 at step 1" in \
        capsys.readouterr().out
    assert _same_state(b / "final", a / "final") == 2


def test_remat_changes_no_bit(run_a):
    """`--remat` (every block recomputed in the backward pass under
    torch.utils.checkpoint): one step saves the state run A saved after
    its first, bit for bit — params, both Adam moments (the gradients),
    step."""
    r = _port(run_a["tmp"], "remat", "--steps", "1", "--remat", "--seed",
              run_a["seed"])
    assert _same_state(r / "final", run_a["dir"] / "step_0000001") == 1


def test_checkpoint_round_trip_restores_each_leaf(tmp_path):
    """save_params / load_params: `like` puts each leaf on its
    counterpart's device and refuses another structure or dtype."""
    tree = {"a": torch.randn(3, 2), "b": ({"c": torch.zeros(4,
                                                            dtype=torch.int32)},
                                          {})}
    path = ckpt.save_params(str(tmp_path / "t"), tree)
    back = ckpt.load_params(path, like=tree)
    assert torch.equal(back["a"], tree["a"])
    assert torch.equal(back["b"][0]["c"], tree["b"][0]["c"])
    with pytest.raises(ValueError):
        ckpt.load_params(path, like={"a": tree["a"]})
    with pytest.raises(ValueError):
        ckpt.load_params(path, like={"a": tree["a"].double(),
                                     "b": tree["b"]})


@pytest.mark.parametrize("flag", ["--dp", "--tp"])
def test_a_training_mesh_is_not_ported(tmp_path, flag):
    with pytest.raises(NotPortedError, match="Multi-GPU and runtime"):
        train_cli.main([*SMALL, "--device", "cpu", flag, "2",
                        "--ckpt_dir", str(tmp_path)])
    assert not os.listdir(tmp_path)


def test_the_two_stores_cannot_read_each_others_files(tmp_path):
    """The JAX package stores trees with orbax (a directory, which needs
    JAX to read), the port with torch.save (one file): neither loader
    reads the other's checkpoint (ROADMAP Queue 3)."""
    from umgen_tpu.runtime import checkpoint as jckpt
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3)}
    jpath = jckpt.save_params(str(tmp_path / "orbax"), tree)
    tpath = ckpt.save_params(str(tmp_path / "torch"),
                             {"a": torch.from_numpy(tree["a"])})
    with pytest.raises(Exception):
        ckpt.load_params(jpath)
    with pytest.raises(Exception):
        jckpt.load_params(tpath)
    # each reads its own
    np.testing.assert_array_equal(
        np.asarray(jckpt.load_params(jpath, host=True)["a"]), tree["a"])
    np.testing.assert_array_equal(ckpt.load_params(tpath)["a"].numpy(),
                                  tree["a"])
