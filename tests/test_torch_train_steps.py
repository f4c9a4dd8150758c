"""Full train steps of the port's trainer against the JAX package's, on the
CPU, under the JAX CLI's default model config (the absolute temporal PE, no
label smoothing) in float32 at the tiny scale, one synthetic batch (B = 1,
T = 3), both from the JAX initializer's parameters.

JAX's step is its jitted value_and_grad (one compile for the file), optax's
update and apply_updates — the body of its `train_step`; the port's is
`UMGenTrainer.train_step`.  AdamW behind the global-norm clip, lr 3e-4
warming up over one step, the same batch twice.

Tolerances, stated before measuring (tests/test_torch_train.py states the
loss's and the gradients'): the first step's loss terms (1e-5) and every
gradient leaf (1e-4 relative L2) as there; the first step is the warmup
no-op, so the params are unchanged bit for bit in both; after the second,
the params within 1e-9 + 1e-3·lr of JAX's wherever |g| > 100·eps.  Adam's
first moves are g / (|g| + eps), eps = 1e-8, which turns an error δg of
the gradient into δg·eps / (|g| + eps)² of the move: above 100·eps that is
below 1e-6 for the ~1e-10 roundoff of these gradients; closer to eps (the
key biases, whose gradient is zero in exact arithmetic, and small
elements) the roundoff steers the move, so those elements are held only to
Adam's bound, 2·lr·(1 + wd·|p|).  (remat, bit for bit:
tests/test_torch_train_cli.py.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from umgen_tpu.data.synthetic import make_token_batch
from umgen_tpu.models.umgen import UMGen as JUMGen
from umgen_tpu.parallel import train as jtrain
from umgen_tpu_torch.parallel import optim
from umgen_tpu_torch.params import from_jax

EPS = 1e-8          # Adam's

from test_torch_train import (F32_LOSS_RTOL, LR, _cfgs, _check_grads,
                              _check_terms, _f32, _get, _port_batch,
                              _trainers)


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    # the suite runs several workers on the same cores; module-scoped, so
    # that the module fixtures run with it too
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run():
    """Two steps on each side; copies of the params and first moments
    after each."""
    jcfg, _ = _cfgs(dtype="float32")
    params = JUMGen(jcfg).init_params(jax.random.PRNGKey(0))
    raw = make_token_batch(JUMGen(jcfg).layout, T=3, B=1, seed=0,
                           config=jcfg)
    batch = {k: jnp.asarray(v, jnp.int32) for k, v in raw.items()}
    jt, tt = _trainers(dtype="float32")
    trainable, buffers = jtrain.split_params(params)
    vg = jax.jit(jax.value_and_grad(jt.loss_fn, has_aux=True))
    opt = jt.tx.init(trainable)
    state = tt.init_state(from_jax(params))
    p0 = jax.tree.map(np.asarray, trainable)
    out = {"p0": p0, "jax": [], "port": []}
    for i in range(2):
        (_, jm), g = vg(trainable, buffers, batch, jax.random.PRNGKey(0))
        u, opt = jt.tx.update(g, opt, trainable)
        trainable = optax.apply_updates(trainable, u)
        state, tm = tt.train_step(state, _port_batch(raw))
        # copies: the port's step updates its tensors in place
        out["jax"].append({"metrics": jm, "grads": g, "mu": opt[1][0].mu,
                           "params": jax.tree.map(np.array, trainable)})
        out["port"].append({
            "metrics": tm,
            "params": optim.tree_map(lambda t: _f32(t).copy(), state.params),
            "mu": optim.tree_map(lambda t: _f32(t).copy(),
                                 state.opt_state[1][0]["mu"])})
    out["state"] = state
    return out


def test_first_step_loss_and_gradients_match_jax(run):
    """The absolute PE in float32: the loss terms and every gradient leaf
    (`tpe_rel` is the unused one here), read from the first moments after
    the first step, mu = (1 - b1)·g in both packages."""
    j, p = run["jax"][0], run["port"][0]
    print("loss terms, relative errors:",
          _check_terms(p["metrics"], j["metrics"], F32_LOSS_RTOL))
    mu = optim.tree_map(torch.from_numpy, p["mu"])
    zeros, roundoff, _ = _check_grads(mu, j["mu"])
    assert zeros == ["['head_ar_aux']['w']", "['head_tar_pose']['w']",
                     "['tpe_rel']"]
    assert roundoff == ["['ego_ca']['cross_attn']['k']['b']"]


def test_two_train_steps_match_jax(run):
    p0 = run["p0"]
    for i in range(2):
        j, p = run["jax"][i], run["port"][i]
        _check_terms(p["metrics"], j["metrics"], F32_LOSS_RTOL)
        gn = float(optax.global_norm(j["grads"]))
        assert abs(float(p["metrics"]["grad_norm"]) - gn) <= 1e-5 * gn
    assert int(run["state"].step) == 2
    # lr(0) = 0: the first step moves nothing
    for path, a in jax.tree_util.tree_leaves_with_path(run["jax"][0]
                                                        ["params"]):
        np.testing.assert_array_equal(a, _get(p0, path))
        np.testing.assert_array_equal(_get(run["port"][0]["params"], path),
                                      _get(p0, path))
    tight = loose = 0
    grads = run["jax"][0]["grads"]
    for path, a in jax.tree_util.tree_leaves_with_path(run["jax"][1]
                                                        ["params"]):
        name = jax.tree_util.keystr(path)
        d = np.abs(_get(run["port"][1]["params"], path) - a)
        g = np.abs(np.asarray(_get(grads, path)))
        big = g > 100 * EPS
        assert (d[big] <= 1e-9 + 1e-3 * LR).all(), (name, d[big].max())
        assert (d <= 2 * LR * (1 + 0.01 * np.abs(_get(p0, path)))).all(), \
            name
        tight += big.sum()
        loose += (~big).sum()
    print(f"after two steps: {tight} elements held to 1e-3 lr, {loose} "
          "(|g| <= 100 eps) to Adam's bound")
