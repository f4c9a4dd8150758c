"""Tensor-parallel training in the port against the JAX package, on the CPU:
gloo ranks of tests/torch_dp_worker.py's pool at tp = 2 (two ranks) and at
dp = 2 × tp = 2 (four ranks), JAX's side on conftest's virtual devices.

  * `UMGenTrainer.jit_train_step(mesh)` — one AdamW step at the tiny scale
    in float32 on a global batch of 2 (T = 3), from the JAX initializer's
    params, lr 3e-4 with no warmup — against JAX's GSPMD step
    `jit_train_step(make_mesh(dp, tp))` at the same (dp, tp);
  * tools/train.py at `--tp 2` (the tiny scale, the CLI's bf16 params): rank
    0 alone writes, the checkpoint holds the whole state and loads into a
    tp = 1 run.

Tolerances, stated before measuring (tests/test_torch_dp_train.py's and
chip_smoke.py's TRAIN_*): the loss terms and the grad norm within 1e-5
relative; each gradient leaf (read from the first moment, mu = 0.1·g)
within 1e-4 relative L2, a roundoff leaf (below 1e-7 of the global norm)
staying below that; the params within 1e-9 + 1e-3·lr where |g| > 100·eps,
elsewhere Adam's bound.  Across the ranks the replicated leaves and their
moments equal bit for bit (every rank's replicated gradient comes from the
same all-reduces).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_dp_train import TRAINER, _adam_close, _equal_trees, _leaves
from test_torch_train import F32_LOSS_RTOL, _cfgs
from torch_dp_worker import Pool
from umgen_tpu.data.synthetic import make_token_batch
from umgen_tpu.models.umgen import UMGen as JUMGen
from umgen_tpu.parallel import train as jtrain
from umgen_tpu.parallel.mesh import make_mesh
from umgen_tpu_torch.runtime import checkpoint as ckpt

GRAD_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two intra-op threads: the suite runs several workers on the same
    cores, and torch's default (one thread per core) oversubscribes
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_step(jcfg, params, raw, dp, tp):
    jt = jtrain.UMGenTrainer(JUMGen(jcfg), **TRAINER)
    mesh = make_mesh(dp=dp, tp=tp)
    step, place = jt.jit_train_step(mesh)
    with mesh:
        state, batch = place(jt.init_state(params),
                             {k: jnp.asarray(v, jnp.int32)
                              for k, v in raw.items()}, None)
        state, metrics = step(state, batch, jax.random.PRNGKey(0))
    return {"params": jax.tree.map(np.asarray, state.params),
            "mu": jax.tree.map(np.asarray, state.opt_state[1][0].mu),
            "metrics": {k: float(v) for k, v in metrics.items()}}


@pytest.fixture(scope="module")
def job():
    jcfg, _ = _cfgs(dtype="float32")
    jmodel = JUMGen(jcfg)
    params = jmodel.init_params(jax.random.PRNGKey(0))
    raw = make_token_batch(jmodel.layout, T=3, B=2, seed=0, config=jcfg)
    p0 = jax.tree.map(np.array, jtrain.split_params(params)[0])
    kw = dict(cfg_kw=dataclasses.asdict(jcfg), trainer_kw=TRAINER,
              params=jax.tree.map(np.asarray, params),
              batch={k: v.astype(np.int64) for k, v in raw.items()})
    return jcfg, params, raw, p0, kw


@pytest.fixture(scope="module")
def pool():
    p = Pool(2, tp=2)
    yield p
    p.close()


@pytest.fixture(scope="module")
def tp2(pool, job):
    """The port's tp = 2 ranks while JAX's GSPMD step compiles here."""
    jcfg, params, raw, p0, kw = job
    pool.submit("tp_train_step", **kw)
    return {"jax": _jax_step(jcfg, params, raw, 1, 2),
            "ranks": pool.collect(), "p0": p0}


@pytest.fixture(scope="module")
def dp2tp2(job):
    """Four ranks at dp = 2 × tp = 2 against JAX's step on the same mesh."""
    jcfg, params, raw, p0, kw = job
    four = Pool(4, tp=2)
    try:
        four.submit("tp_train_step", **kw)
        want = _jax_step(jcfg, params, raw, 2, 2)
        return {"jax": want, "ranks": four.collect(), "p0": p0}
    finally:
        four.close()


# slow: a second pool of four ranks and a second GSPMD compile (~40 s); the
# tp = 2 cases cover the split step in the fast tier, test_torch_dp_train.py
# the dp mean
MESHES = ["tp2", pytest.param("dp2tp2", marks=pytest.mark.slow)]


def _grad_errors(got_mu, want_mu):
    want = [np.asarray(v, np.float64) for _, v in _leaves(want_mu)]
    got = [np.asarray(v, np.float64) for _, v in _leaves(got_mu)]
    gnorm = np.sqrt(sum((w ** 2).sum() for w in want))
    worst, roundoff = 0.0, 0
    for a, b in zip(want, got):
        na = np.linalg.norm(a)
        if na <= 1e-7 * gnorm:
            roundoff += 1
            assert np.linalg.norm(b) <= 1e-7 * gnorm
        else:
            worst = max(worst, np.linalg.norm(b - a) / na)
    return worst, roundoff


@pytest.mark.parametrize("mesh", MESHES)
def test_tp_step_matches_jax_gspmd(request, mesh):
    """Every rank's whole tree after the step against JAX's GSPMD step at
    the same (dp, tp): the loss terms, the grad norm, the gradients and
    the params."""
    run = request.getfixturevalue(mesh)
    want = run["jax"]
    for r, res in enumerate(run["ranks"]):
        for k in ("loss", "ego_loss", "tar_loss", "oar_loss", "grad_norm"):
            a, b = res["metrics"][k], want["metrics"][k]
            assert abs(a - b) <= F32_LOSS_RTOL * abs(b), (mesh, r, k, a, b)
        worst, roundoff = _grad_errors(res["mu"], want["mu"])
        assert worst <= GRAD_RTOL, (mesh, r, worst)
        _adam_close(res["params"], want["params"], run["p0"], want["mu"],
                    mesh)
    print(f"{mesh}: gradients within {worst:.3g} rel L2 of JAX's "
          f"({roundoff} roundoff leaves)")


@pytest.mark.parametrize("mesh", MESHES)
def test_tp_step_keeps_the_replicated_state_equal(request, mesh):
    """The ranks' replicated leaves and moments equal bit for bit, and so
    do the whole trees every rank gathers; each rank held its blocks (a
    fused qkv's third of its heads' columns)."""
    ranks = request.getfixturevalue(mesh)["ranks"]
    for res in ranks[1:]:
        _equal_trees(res["local"], ranks[0]["local"])
        for k in ("params", "mu", "nu"):
            _equal_trees(res[k], ranks[0][k])
    d = 64
    for res in ranks:
        assert res["shapes"]["tar/sa1/qkv/w"] == (1, d, 3 * d // 2)
        assert res["shapes"]["head_ar_map/w"] == (d, 8192 // 2)
        assert res["shapes"]["axe"] == (8, d)


def test_train_cli_tp2_writes_a_whole_checkpoint(pool, tmp_path):
    """tools/train.py's rank at `--tp 2`: one step at the tiny scale; rank 0
    writes the synthetic scenes, train_meta.json and the final checkpoint,
    which holds the whole state (the ranks' gathered params) and loads into
    a one-process run's state."""
    from umgen_tpu_torch.config import ModelConfig
    from umgen_tpu_torch.models.umgen import UMGen
    from umgen_tpu_torch.params import init_params
    from umgen_tpu_torch.parallel.train import UMGenTrainer
    argv = ["--model_scale", "tiny", "--steps", "1", "--warmup", "0",
            "--batch_size", "2", "--window", "3", "--synthetic_data", "2",
            "--device", "cpu", "--tp", "2", "--ckpt_dir", str(tmp_path)]
    r0, r1 = pool.run("train_cli", argv=argv)
    assert r0["step"] == r1["step"] == 1
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "final", "synthetic", "train_meta.json"]
    cfg = ModelConfig(use_pallas_attention=False).scaled("tiny")
    like = UMGenTrainer(UMGen(cfg)).init_state(
        init_params(cfg, torch.Generator().manual_seed(0), "cpu"))
    state = ckpt.load_train_state(str(tmp_path / "final"), like)
    assert int(state.step) == 1
    np.testing.assert_array_equal(
        state.params["tar"]["sa1"]["qkv"]["w"].float().detach().numpy(),
        r0["whole"]["tar"]["sa1"]["qkv"]["w"])
    np.testing.assert_array_equal(
        state.opt_state[1][0]["mu"]["head_ar_map"]["w"].float().numpy(),
        r0["whole_mu"]["head_ar_map"]["w"])
    assert r0["params"]["tar"]["sa1"]["qkv"]["w"].shape == (1, 64, 96)
