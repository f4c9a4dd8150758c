"""VQ codec training in the port (models/quantize.py, tools/train_vq.py)
against the JAX package, on the CPU.

`norm_ema_quantize` (indices, z_q, the commitment loss, the new EMA state,
the straight-through gradient), `kmeans_cosine` from the same initial
means, `DiagonalGaussian`, and one step of the training CLI at `--res
32 --ch 32` against the JAX CLI's (`umgen_tpu.tools.train_vq.main`, the
reference itself, its one compile the file's cost) on the same initial
params (JAX's initializer's, through `params.from_jax`) and the same
rasters (numpy, seeded); then a saved run loading into MapDecoder.

Tolerances, stated before measuring: the quantizer's float32 values within
1e-6 (the same ops in another summation order) and its indices equal; the
CLI's step: loss, reconstruction loss and perplexity within 1e-5
relative, the EMA codebook within 1e-6; the params within 1e-9 + 1e-3·lr of
JAX's wherever the gradient |g| > max(100·eps, 1e-3 of its leaf's
largest) (read from the port's first Adam moment, mu = 0.1·g), elsewhere
within Adam's bound 2·lr: Adam's first move g / (|g| + eps) turns an error
δg into δg·eps / (|g| + eps)² of the move, so where |g| is near eps = 1e-8
or near the roundoff of its leaf's sums (a conv bias in front of a group
norm, an attention key bias: gradients zero in exact arithmetic) the
roundoff steers it (tests/test_torch_train_steps.py).
"""

import contextlib
import dataclasses
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umgen_tpu.models import quantize as jq
from umgen_tpu.models import vq as jvq
from umgen_tpu.runtime import checkpoint as jckpt
from umgen_tpu.tools import train_vq as jtrain_vq
from umgen_tpu_torch.models import quantize as tq
from umgen_tpu_torch.models import vq as tvq
from umgen_tpu_torch.models.umgen import NotPortedError
from umgen_tpu_torch.params import from_jax
from umgen_tpu_torch.runtime import checkpoint as ckpt
from umgen_tpu_torch.tools import train_vq

LR = 1e-4
EPS = 1e-8
# the CLI's run: two rasters of 32 x 32, base width 32
ARGS = ["--res", "32", "--ch", "32", "--batch_size", "2", "--log_every",
        "1", "--lr", str(LR)]


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    # the suite runs several workers on the same cores
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _ema(rng, K=32, D=16):
    emb = jq.l2norm(jnp.asarray(rng.normal(size=(K, D)), jnp.float32))
    size = jnp.asarray(rng.uniform(0, 3, K), jnp.float32)
    return (jq.EMAState(emb, size, jnp.asarray(True)),
            tq.EMAState(_t(emb), _t(size), torch.tensor(True)))


@pytest.mark.parametrize("train", [True, False])
def test_norm_ema_quantize_matches_jax(train):
    rng = np.random.default_rng(0)
    jstate, tstate = _ema(rng)
    z = rng.normal(size=(2, 4, 4, 16)).astype(np.float32)
    w = rng.normal(size=z.shape).astype(np.float32)

    def objective(z):
        zq, loss, idx, new = jq.norm_ema_quantize(jstate, z, train=train)
        return jnp.sum(zq * w) + loss, (zq, loss, idx, new)

    (_, (zq, loss, idx, new)), g = jax.value_and_grad(
        objective, has_aux=True)(jnp.asarray(z))
    zt = _t(z).requires_grad_(True)
    tzq, tloss, tidx, tnew = tq.norm_ema_quantize(tstate, zt, train=train)
    (tg,) = torch.autograd.grad((tzq * _t(w)).sum() + tloss, zt)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(idx))
    for a, b in ((tzq, zq), (tloss, loss), (tg, g),
                 (tnew.embedding, new.embedding),
                 (tnew.cluster_size, new.cluster_size)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=0, atol=1e-6)
    assert bool(tnew.initted)
    with pytest.raises(NotPortedError, match="Multi-GPU and runtime"):
        tq.norm_ema_quantize(tstate, zt, train=train, axis_name="dp")


def test_kmeans_cosine_from_the_same_means():
    """JAX draws the initial means with its key; the port takes those and
    must give JAX's codebook and cluster sizes (an empty cluster keeps its
    mean)."""
    rng = np.random.default_rng(1)
    data = jnp.asarray(rng.normal(size=(200, 8)), jnp.float32)
    key = jax.random.PRNGKey(3)
    means, counts = jq.kmeans_cosine(key, data, 24, iters=6)
    idx = jax.random.choice(key, 200, (24,), replace=False)
    start = jq.l2norm(data)[idx]
    tmeans, tcounts = tq.kmeans_cosine(None, _t(data), 24, iters=6,
                                       means=_t(start))
    np.testing.assert_allclose(tmeans.numpy(), np.asarray(means), atol=1e-6)
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(counts))
    # its own draw: K distinct samples, l2-normed
    own, _ = tq.kmeans_cosine(torch.Generator().manual_seed(0), _t(data),
                              24, iters=0)
    assert torch.allclose(own.norm(dim=-1), torch.ones(24))
    assert len({tuple(r) for r in own.numpy().round(6)}) == 24


def test_diagonal_gaussian_matches_jax():
    rng = np.random.default_rng(2)
    p, q = (rng.normal(size=(2, 3, 3, 8)).astype(np.float32)
            for _ in range(2))
    jp, jq_ = jq.DiagonalGaussian(jnp.asarray(p)), jq.DiagonalGaussian(
        jnp.asarray(q))
    tp, tq_ = tq.DiagonalGaussian(_t(p)), tq.DiagonalGaussian(_t(q))
    x = rng.normal(size=(2, 3, 3, 4)).astype(np.float32)
    for a, b in ((tp.kl(), jp.kl()), (tp.kl(tq_), jp.kl(jq_)),
                 (tp.nll(_t(x)), jp.nll(jnp.asarray(x))),
                 (tp.mode(), jp.mode())):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


@pytest.fixture(scope="module")
def one_step(tmp_path_factory):
    """One step of each CLI from the same params and rasters; the JAX
    CLI's printed line."""
    d = tmp_path_factory.mktemp("vq")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert jtrain_vq.main(ARGS + ["--steps", "1", "--ckpt_dir",
                                      str(d / "jax")]) == 0
    line = re.search(r"step 1/1 loss=(\S+) \(rec (\S+)\) perplexity=(\S+) ",
                     out.getvalue())
    cfg = dataclasses.replace(jvq.MAP_VQ, resolution=32, ch=32)
    init = jvq.init_normvq(jax.random.PRNGKey(0), cfg)
    tcfg = train_vq.vq_config(train_vq.build_parser().parse_args(ARGS))
    trainer = train_vq.VQTrainer(tcfg, from_jax(init), LR)
    x = train_vq.synthetic_rasters(np.random.default_rng(0), 2, 32, 5)
    metrics = trainer.step(torch.as_tensor(x))
    path = ckpt.save_params(str(d / "port" / "map_final"),
                            trainer.inference_params())
    return {"jax": jckpt.load_params(str(d / "jax" / "map_final"),
                                     host=True),
            "jax_line": [float(v) for v in line.groups()],
            "port": ckpt.load_params(path), "metrics": metrics,
            "init": init, "trainer": trainer, "cfg": tcfg}


def _at(tree, path):
    for k in path:
        tree = tree[k.key if hasattr(k, "key") else k.idx]
    return tree


def test_one_train_vq_step_matches_jax(one_step):
    """The step's loss, reconstruction loss and perplexity against the JAX
    CLI's printed ones (to their printed digits); the saved trees leaf
    by leaf (the bounds above): the EMA codebook, and every trained leaf,
    each of which moved."""
    m = one_step["metrics"]
    for v, (w, digits) in zip((m["loss"], m["rec"], m["perp"]),
                              zip(one_step["jax_line"], (4, 4, 1))):
        assert abs(float(v) - w) <= 0.5 * 10.0 ** -digits + 1e-5 * abs(w)
    want, got = one_step["jax"], one_step["port"]
    np.testing.assert_allclose(got["codebook"].numpy(), want["codebook"],
                               atol=1e-6)
    mu = one_step["trainer"].opt_state[0]["mu"]
    tight = loose = 0
    for path, a in jax.tree_util.tree_leaves_with_path(want):
        name = jax.tree_util.keystr(path)
        if name == "['codebook']":
            continue
        d = np.abs(_at(got, path).numpy() - a)
        g = np.abs(_at(mu, path).numpy()) / 0.1
        big = g > max(100 * EPS, 1e-3 * g.max())
        assert (d[big] <= 1e-9 + 1e-3 * LR).all(), (name, d[big].max())
        assert (d <= 2 * LR + 1e-7).all(), name
        assert not np.array_equal(a, np.asarray(_at(one_step["init"],
                                                    path))), name
        tight += big.sum()
        loose += (~big).sum()
    print(f"{tight} elements held to 1e-3 lr, {loose} to Adam's bound")


def test_cli_prints_the_jax_clis_line(one_step, tmp_path, capsys):
    """The CLI end to end on the CPU: three steps, the JAX CLI's line at
    each, the run saved in the inference layout."""
    assert train_vq.main(ARGS + ["--steps", "3", "--device", "cpu",
                                 "--ckpt_dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    for i in (1, 2, 3):
        assert f"step {i}/3 loss=" in out and "perplexity=" in out
    assert f"saved {tmp_path}/map_final" in out
    saved = ckpt.load_params(str(tmp_path / "map_final"))
    assert sorted(saved) == ["codebook", "decoder", "encoder",
                             "post_quant_conv", "quant_conv"]


def test_a_saved_run_loads_into_map_decoder(one_step, monkeypatch):
    """MapDecoder (built on MAP_VQ, here the run's --res 32 --ch 32 config)
    decodes tokens with the saved tree as `decode_code` + `to_rgb` does
    with the trained params and the EMA codebook."""
    monkeypatch.setattr(tvq, "MAP_VQ", one_step["cfg"])
    saved = one_step["port"]
    dec = tvq.MapDecoder(saved, device="cpu")
    grid = (4, 4)                       # 32 / 2^3
    dec.grid = grid
    tokens = np.random.default_rng(0).integers(0, 8192, (2, 16))
    got = dec.decode(tokens)
    with torch.no_grad():
        want = tvq.to_rgb(tvq.decode_code(
            tvq.oihw(saved), one_step["cfg"],
            torch.as_tensor(tokens.reshape(2, *grid)))).numpy()
    assert got.shape == (2, 32, 32, 3)
    np.testing.assert_array_equal(got, want)
    assert torch.equal(saved["codebook"],
                       one_step["trainer"].ema.embedding)


def test_data_parallel_codec_training_is_not_ported(tmp_path):
    with pytest.raises(NotPortedError, match="Multi-GPU and runtime"):
        train_vq.main(ARGS + ["--dp", "2", "--device", "cpu",
                              "--ckpt_dir", str(tmp_path)])
