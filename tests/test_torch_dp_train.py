"""Data-parallel training in the port against the JAX package, on the CPU:
two gloo ranks (tests/torch_dp_worker.py's pool, one for the file).

  * `UMGenTrainer.jit_train_step(mesh)` — one AdamW step at the tiny scale
    in float32 on a global batch of 2 (T = 3), from the JAX initializer's
    params, lr 3e-4 with no warmup (the first step moves the params) —
    against JAX's GSPMD step `jit_train_step(make_mesh(dp=2))` on
    conftest's virtual devices and against the port's one-process step on
    the whole batch;
  * tools/train.py's rank at `--dp 2` (the tiny scale, the CLI's bf16
    params): rank 0 alone writes, every rank ends with the same state;
  * tools/train_vq.py: one step of VQTrainer over the mesh with k-means on
    the global first batch (from JAX's draw of the initial means), against
    the JAX CLI's `--dp 2 --kmeans` shard_map step and the port's
    one-process step; the CLI's rank at
    `--dp 2`; `norm_ema_quantize` over the group against the one-process
    call on the concatenated batch.

Tolerances, stated before measuring (but for the k-means codebook against
JAX's, set from a measurement: see CODEBOOK_KMEANS_ATOL).  Across ranks: params, moments and
codebooks equal bit for bit (the optimizer runs replicated on the mean
gradient every rank receives from the same all-reduce).  Against JAX and
against the one-process step (float32, the mean gradient a sum in another
order): the loss terms within F32_LOSS_RTOL (1e-5) and the grad norm within
1e-5 relative, as tests/test_torch_train_steps.py holds one process; the
params within 1e-9 + 1e-3·lr where |g| > 100·eps, elsewhere Adam's bound
2·lr·(1 + wd·|p|) (Adam's first move g / (|g| + eps) follows the roundoff
of gradients near eps).  The VQ step: tests/test_torch_train_vq.py's
bounds (its metrics to the JAX CLI's printed digits, the codebook within
1e-6 — against JAX 1e-5 under k-means, which sets the codebook from the
encoder's latents: see the test —, the params by the same rule as
above).  The quantizer over the group:
indices and z_q equal, the new EMA state within 1e-6 (the embed sums a
matmul in another order), the counts equal.
"""

import contextlib
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_dp_worker import Pool
from umgen_tpu.data.synthetic import make_token_batch
from umgen_tpu.models import quantize as jq
from umgen_tpu.models import vq as jvq
from umgen_tpu.models.umgen import UMGen as JUMGen
from umgen_tpu.parallel import train as jtrain
from umgen_tpu.parallel.mesh import make_mesh
from umgen_tpu.runtime import checkpoint as jckpt
from umgen_tpu.tools import train_vq as jtrain_vq
from umgen_tpu_torch.runtime import checkpoint as ckpt
from umgen_tpu_torch.tools import train_vq

from test_torch_train import F32_LOSS_RTOL, _cfgs
from test_torch_train_vq import ARGS as VQ_ARGS

LR = 3e-4
EPS = 1e-8          # Adam's
WD = 0.01           # AdamW's default decay in both trainers
TRAINER = dict(learning_rate=LR, warmup_steps=0, total_steps=10)
# the k-means codebook against JAX's: the encoder's float32 error on its
# latents (the one-process port and JAX steps: 1.76e-6 apart)
CODEBOOK_KMEANS_ATOL = 1e-5


@pytest.fixture(scope="module")
def pool():
    p = Pool(2)
    yield p
    p.close()


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (i,))
    else:
        yield prefix, np.asarray(tree)


def _equal_trees(a, b):
    la, lb = list(_leaves(a)), list(_leaves(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        np.testing.assert_array_equal(x, y, err_msg=str(p))


def _adam_close(got, want, p0, mu, what):
    """Params after one Adam step: within 1e-9 + 1e-3·lr where |g| >
    100·eps (g read from the first moment, mu = 0.1·g), else Adam's
    bound."""
    tight = loose = 0
    for path, w in _leaves(want):
        g = np.abs(_get_path(mu, path)) / 0.1
        d = np.abs(_get_path(got, path) - w)
        big = g > 100 * EPS
        assert (d[big] <= 1e-9 + 1e-3 * LR).all(), (what, path,
                                                    d[big].max())
        assert (d <= 2 * LR * (1 + WD * np.abs(_get_path(p0, path)))
                + 1e-7).all(), (what, path)
        tight += big.sum()
        loose += (~big).sum()
    return tight, loose


def _get_path(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


@pytest.fixture(scope="module")
def umgen_step(pool):
    """The port's ranks (and its one-process step) while JAX's GSPMD step
    compiles here."""
    jcfg, _ = _cfgs(dtype="float32")
    jmodel = JUMGen(jcfg)
    params = jmodel.init_params(jax.random.PRNGKey(0))
    raw = make_token_batch(jmodel.layout, T=3, B=2, seed=0, config=jcfg)
    import dataclasses
    pool.submit("train_step", cfg_kw=dataclasses.asdict(jcfg),
                trainer_kw=TRAINER,
                params=jax.tree.map(np.asarray, params),
                batch={k: v.astype(np.int64) for k, v in raw.items()})
    jt = jtrain.UMGenTrainer(jmodel, **TRAINER)
    p0 = jax.tree.map(np.array, jtrain.split_params(params)[0])
    mesh = make_mesh(dp=2, tp=1)
    step, place = jt.jit_train_step(mesh)
    with mesh:
        state, batch = place(jt.init_state(params),
                             {k: jnp.asarray(v, jnp.int32)
                              for k, v in raw.items()}, None)
        state, metrics = step(state, batch, jax.random.PRNGKey(0))
    want = {"params": jax.tree.map(np.asarray, state.params),
            "mu": jax.tree.map(np.asarray, state.opt_state[1][0].mu),
            "metrics": {k: float(v) for k, v in metrics.items()}}
    return {"ranks": pool.collect(), "jax": want, "p0": p0}


def test_dp_step_keeps_the_ranks_equal(umgen_step):
    r0, r1 = (r["dp"] for r in umgen_step["ranks"])
    for k in ("params", "mu", "nu", "metrics"):
        _equal_trees(r0[k], r1[k])


@pytest.mark.parametrize("ref", ["jax_gspmd", "one_process"])
def test_dp_step_matches(umgen_step, ref):
    """The dp step against JAX's GSPMD step and against the port's
    one-process step on the global batch; the params moved."""
    got = umgen_step["ranks"][0]["dp"]
    want = umgen_step["jax"] if ref == "jax_gspmd" else \
        umgen_step["ranks"][0]["one"]
    for k in ("loss", "ego_loss", "tar_loss", "oar_loss", "grad_norm"):
        a, b = got["metrics"][k], want["metrics"][k]
        assert abs(a - b) <= F32_LOSS_RTOL * abs(b), (k, a, b)
    tight, loose = _adam_close(got["params"], want["params"],
                               umgen_step["p0"], want["mu"], ref)
    assert tight > loose
    moved = [not np.array_equal(_get_path(got["params"], p), v)
             for p, v in _leaves(umgen_step["p0"])]
    assert sum(moved) > 0.9 * len(moved)
    print(f"{ref}: {tight} elements held to 1e-3 lr, {loose} to Adam's "
          "bound")


def test_train_cli_rank_zero_writes_and_the_ranks_agree(pool, tmp_path):
    """tools/train.py at `--dp 2` (rank bodies on the pool): one step of a
    global batch of 2 at the tiny scale; rank 0 writes the synthetic
    scenes, train_meta.json and the final checkpoint, and every rank ends
    with the same params and moments."""
    argv = ["--model_scale", "tiny", "--steps", "1", "--warmup", "0",
            "--batch_size", "2",
            "--window", "3", "--synthetic_data", "2", "--device", "cpu",
            "--dp", "2", "--ckpt_dir", str(tmp_path)]
    r0, r1 = pool.run("train_cli", argv=argv)
    _equal_trees(r0, r1)
    assert r0["step"] == 1
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "final", "synthetic", "train_meta.json"]
    saved = ckpt.load_params(str(tmp_path / "final"))
    np.testing.assert_array_equal(
        saved["params"]["axe"].float().numpy(), r0["params"]["axe"])


@pytest.fixture(scope="module")
def vq_step(pool, tmp_path_factory):
    """One `--dp 2 --kmeans` step of the JAX CLI and of the port's
    VQTrainer over the pool, from the same params and rasters."""
    import dataclasses
    d = tmp_path_factory.mktemp("vq_dp")
    # 16 codes for the global batch's 2·4·4 latents: k-means then draws
    # distinct initial means (with 8192 codes it draws them with
    # replacement, and which of two equal means a latent joins is a tie
    # that 6e-8 of noise decides, in one process as in two)
    argv = VQ_ARGS + ["--steps", "1", "--dp", "2", "--kmeans",
                      "--n_embed", "16"]
    cfg = dataclasses.replace(jvq.MAP_VQ, resolution=32, ch=32, n_embed=16)
    init = jvq.init_normvq(jax.random.PRNGKey(0), cfg)
    x = train_vq.synthetic_rasters(np.random.default_rng(0), 2, 32, 5)
    # k-means' initial means: JAX's draw (maybe_kmeans_init's key)
    idx = np.asarray(jax.random.choice(jax.random.PRNGKey(0), 32, (16,),
                                       replace=False))
    pool.submit("vq_step", argv=argv + ["--device", "cpu"],
                init=jax.tree.map(np.asarray, init), x=x, kmeans_idx=idx)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert jtrain_vq.main(argv + ["--ckpt_dir", str(d)]) == 0
    line = re.search(r"step 1/1 loss=(\S+) \(rec (\S+)\) perplexity=(\S+) ",
                     out.getvalue())
    return {"ranks": pool.collect(),
            "jax": jckpt.load_params(str(d / "map_final"), host=True),
            "jax_line": [float(v) for v in line.groups()]}


@pytest.mark.parametrize("ref", ["jax_shard_map", "one_process"])
def test_vq_dp_step_matches(vq_step, ref):
    """The ranks equal; against JAX's shard_map step and the port's
    one-process step: the metrics, the codebook, the params.  Under k-means
    the codebook is the encoder's latents' means, so it carries the float32
    error of the encoder's convolutions at full weight (without k-means the
    EMA step passes 0.01 of it: tests/test_torch_train_vq.py's 1e-6):
    against JAX within CODEBOOK_KMEANS_ATOL, against the port's one process
    (the same encoder) within 1e-6."""
    r0, r1 = (r["dp"] for r in vq_step["ranks"])
    for k in ("params", "opt", "cluster_size", "metrics"):
        _equal_trees(r0[k], r1[k])
    m = r0["metrics"]
    if ref == "jax_shard_map":
        want, atol = vq_step["jax"], CODEBOOK_KMEANS_ATOL
        for v, (w, digits) in zip((m["loss"], m["rec"], m["perp"]),
                                  zip(vq_step["jax_line"], (4, 4, 1))):
            assert abs(v - w) <= 0.5 * 10.0 ** -digits + 1e-5 * abs(w)
    else:
        one = vq_step["ranks"][0]["one"]
        want, atol = one["params"], 1e-6
        for k in ("loss", "rec", "perp"):
            assert abs(m[k] - one["metrics"][k]) <= 1e-5 * abs(
                one["metrics"][k]), k
    np.testing.assert_allclose(r0["params"]["codebook"], want["codebook"],
                               rtol=0, atol=atol)
    mu = r0["opt"][0]["mu"]
    for path, w in _leaves(want):
        if path == ("codebook",):
            continue
        d = np.abs(_get_path(r0["params"], path) - w)
        g = np.abs(_get_path(mu, path)) / 0.1
        big = g > max(100 * EPS, 1e-3 * g.max())
        assert (d[big] <= 1e-9 + 1e-3 * 1e-4).all(), (path, d[big].max())
        assert (d <= 2 * 1e-4 + 1e-7).all(), path


def test_vq_cli_ranks_agree(pool, tmp_path):
    """tools/train_vq.py's rank at `--dp 2`: two steps; the ranks' trees
    and EMA counts equal; rank 0 saved the run."""
    r0, r1 = pool.run("vq_cli", argv=VQ_ARGS + [
        "--steps", "2", "--dp", "2", "--device", "cpu", "--ckpt_dir",
        str(tmp_path)])
    _equal_trees(r0, r1)
    saved = ckpt.load_params(str(tmp_path / "map_final"))
    np.testing.assert_array_equal(saved["codebook"].numpy(),
                                  r0["params"]["codebook"])


def test_norm_ema_quantize_over_the_group(pool):
    """Each rank quantizes its rows, the counts and embed sums summed over
    the group (`axis_name=mesh`): the new state is the one-process call's
    on the whole batch."""
    rng = np.random.default_rng(0)
    emb = np.asarray(jq.l2norm(jnp.asarray(rng.normal(size=(32, 16)),
                                           jnp.float32)))
    size = rng.uniform(0, 3, 32).astype(np.float32)
    z = rng.normal(size=(4, 4, 4, 16)).astype(np.float32)
    r0, r1 = pool.run("ema_quantize", embedding=emb, cluster_size=size, z=z)
    one = r0["one"]
    for res, rows in ((r0["dp"], slice(0, 2)), (r1["dp"], slice(2, 4))):
        np.testing.assert_array_equal(res["idx"], one["idx"][rows])
        np.testing.assert_array_equal(res["zq"], one["zq"][rows])
        np.testing.assert_array_equal(res["cluster_size"],
                                      one["cluster_size"])
        np.testing.assert_allclose(res["embedding"], one["embedding"],
                                   rtol=0, atol=1e-6)
    assert abs((r0["dp"]["loss"] + r1["dp"]["loss"]) / 2
               - one["loss"]) <= 1e-6
