"""The port's trainer against the JAX package's, on the CPU: the loss, its
gradients and the optimizers.

`parallel/train.py` (frame_stream, _ce, loss_fn, the gradients),
`parallel/optim.py` against optax, and the new model passes the loss runs
(`forward_ego_net`, `tar_cascade`, `oar_forward`, `oar_inputs_from_tokens`)
at the tiny scale, use_pallas_attention=False, one synthetic batch (B = 1, T
= 3).  Both packages start from the JAX initializer's parameters (PRNGKey
0), handed to the port through `params.from_jax`.  One jitted JAX
value_and_grad is built for the file (float32, the relative temporal PE with
a seeded nonzero `tpe_rel`, oar_label_smooth = 0.1): its compile is the
file's cost; the bf16 loss is a forward-only jit.  Full train steps, the
absolute PE in float32 and remat: tests/test_torch_train_steps.py.

Tolerances, stated before measuring:
  * float32 loss terms: 1e-5 relative (the same ops in another summation
    order; the first reading was ~1e-7);
  * bf16 loss terms: 2e-3 relative.  JAX's side is compiled with XLA's
    `xla_allow_excess_precision` off, so both round after every op; they
    still sum in other orders, and each bf16 rounding of an activation is
    2^-9 relative, through ~20 stacked blocks (the test prints the
    reading);
  * float32 gradients: every leaf within 1e-4 relative L2 of JAX's; where
    JAX gives exact zeros (a leaf the loss does not reach: head_tar_pose,
    head_ar_aux, and tpe under the relative PE) the port's are exact zeros
    too; the cross attention's key bias has a zero gradient in exact
    arithmetic (a key bias shifts every logit of a query alike) and both
    packages hold roundoff only: both below 1e-7 of the global gradient
    norm;
  * optimizers (three updates on seeded gradients): float32 params and
    state within 1e-6 of each leaf's scale (XLA may fuse a multiply-add the
    port rounds twice); bf16 leaves equal bit for bit (JAX's side compiled
    with excess precision off); the float32 `tpe_rel` leaf beside them
    within 1e-6;
  * the schedule within 2 float32 ulps (XLA's cos and torch's differ by an
    ulp at some counts).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from umgen_tpu.config import ModelConfig as JConfig
from umgen_tpu.data.synthetic import make_token_batch
from umgen_tpu.models.umgen import UMGen as JUMGen
from umgen_tpu.parallel import train as jtrain
from umgen_tpu_torch.config import ModelConfig
from umgen_tpu_torch.layout import SequenceLayout
from umgen_tpu_torch.models.umgen import NotPortedError, UMGen
from umgen_tpu_torch.ops import decode_kernel as tdk
from umgen_tpu_torch.ops import flash_attention as tfa
from umgen_tpu_torch.parallel import optim
from umgen_tpu_torch.parallel import train as ttrain
from umgen_tpu_torch.params import from_jax, init_params

EXACT = {"xla_allow_excess_precision": False}
LR = 3e-4
F32_LOSS_RTOL = 1e-5
BF16_LOSS_RTOL = 2e-3
GRAD_RTOL = 1e-4
OPT_RTOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    # the suite runs several workers on the same cores; module-scoped, so
    # that the module fixtures run with it too
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    j = JConfig(use_pallas_attention=False, **kw).scaled("tiny")
    return j, ModelConfig(**dataclasses.asdict(j))


def _trainers(ls=0.0, **kw):
    jcfg, tcfg = _cfgs(**kw)
    args = dict(learning_rate=LR, warmup_steps=1, total_steps=10,
                oar_label_smooth=ls)
    return (jtrain.UMGenTrainer(JUMGen(jcfg), **args),
            ttrain.UMGenTrainer(UMGen(tcfg), **args))


def _get(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.fixture(scope="module")
def setup():
    """JAX's float32 tiny params (tpe_rel seeded nonzero), one batch, and
    JAX's loss and gradients under the relative PE with label smoothing."""
    jcfg, _ = _cfgs(dtype="float32")
    params = JUMGen(jcfg).init_params(jax.random.PRNGKey(0))
    params["tpe_rel"] = jnp.asarray(np.random.default_rng(1).normal(
        0, 0.5, params["tpe_rel"].shape), jnp.float32)
    raw = make_token_batch(JUMGen(jcfg).layout, T=3, B=1, seed=0,
                           config=jcfg)
    batch = {k: jnp.asarray(v, jnp.int32) for k, v in raw.items()}
    jt, tt = _trainers(ls=0.1, dtype="float32", temporal_pe_mode="relative")
    trainable, buffers = jtrain.split_params(params)
    vg = jax.jit(jax.value_and_grad(jt.loss_fn, has_aux=True))
    (_, metrics), grads = vg(trainable, buffers, batch,
                             jax.random.PRNGKey(0))
    state = tt.init_state(from_jax(params))
    port_grads, port_metrics = tt.grads(state, _port_batch(raw))
    return {"params": params, "raw": raw, "batch": batch, "vg": vg,
            "jt": jt, "tt": tt, "metrics": metrics, "grads": grads,
            "port_grads": port_grads, "port_metrics": port_metrics}


def _port_batch(raw):
    return {k: torch.as_tensor(v, dtype=torch.long) for k, v in raw.items()}


def _check_terms(port, ref, rtol):
    errs = {}
    for k in ("loss", "ego_loss", "tar_loss", "oar_loss"):
        a, b = float(port[k]), float(ref[k])
        errs[k] = abs(a - b) / abs(b)
        assert errs[k] <= rtol, (k, a, b)
    return errs


# ---------------------------------------------------------------------------
# the loss's pieces
# ---------------------------------------------------------------------------
def test_frame_stream_matches_jax():
    jcfg, tcfg = _cfgs()
    raw = make_token_batch(JUMGen(jcfg).layout, T=1, B=2, seed=3,
                           config=jcfg)
    frame = {m: v[:, 0] for m, v in raw.items()}
    want = np.asarray(jtrain.frame_stream(
        JUMGen(jcfg).layout, {m: jnp.asarray(v) for m, v in frame.items()}))
    got = ttrain.frame_stream(SequenceLayout(tcfg.task),
                              {m: torch.as_tensor(v)
                               for m, v in frame.items()})
    assert got.shape == (2, 2207)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("ls", [0.0, 0.1])
def test_ce_matches_jax(ls):
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 3, (2, 5, 37)).astype(np.float32)
    tgt = rng.integers(0, 37, (2, 5))
    want = float(jtrain._ce(jnp.asarray(logits), jnp.asarray(tgt), ls))
    got = float(ttrain._ce(torch.as_tensor(logits), torch.as_tensor(tgt),
                           ls))
    assert abs(got - want) <= 1e-6 * abs(want)


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------
def test_schedule_matches_the_jax_trainers():
    """The learning rate at counts 0..N, read through each trainer's SGD
    chain (a gradient of norm 1 is left as it is by the clip: the update
    is -lr(count)), with the trainer's warmup clamp min(warmup, max(total
    // 10, 1)): warmup 1000 of 50 steps warms up over 5."""
    for warmup, total in ((1000, 50), (1, 10), (0, 10), (3, 3)):
        jcfg, tcfg = _cfgs()
        kw = dict(learning_rate=LR, warmup_steps=warmup, total_steps=total,
                  optimizer="sgd")
        jtx = jtrain.UMGenTrainer(JUMGen(jcfg), **kw).tx
        ttx = ttrain.UMGenTrainer(UMGen(tcfg), **kw).tx
        g = {"w": jnp.ones((1,), jnp.float32)}
        tg = {"w": torch.ones(1)}
        js, ts = jtx.init(g), ttx.init(tg)
        lrs = []
        for c in range(total + 3):
            ju, js = jtx.update(g, js, g)
            tu, ts = ttx.update(tg, ts, tg)
            a, b = -float(ju["w"][0]), -float(tu["w"][0])
            assert abs(a - b) <= 2 * np.spacing(np.float32(abs(a))), \
                (warmup, total, c, a, b)
            lrs.append(b)
        warm = min(warmup, max(total // 10, 1))
        assert abs(lrs[0] - (LR if warm == 0 else 0.0)) <= 1e-9
        assert abs(lrs[warm] - LR) <= 1e-9
        assert abs(lrs[-1] - 0.1 * LR) <= 1e-9


def _opt_tree(rng, scale, dtype):
    shapes = {"tar": {"w": (2, 6, 5), "b": (7,)}, "axe": (4, 3),
              "tpe_rel": (2, 9)}

    def make(s, name):
        a = rng.normal(0, scale, s).astype(np.float32)
        return a if name == "tpe_rel" else a.astype(dtype)

    return {k: ({n: make(s, n) for n, s in v.items()} if isinstance(v, dict)
                else make(v, k)) for k, v in shapes.items()}


def _to_torch(tree):
    return optim.tree_map(lambda a: torch.from_numpy(
        np.array(a, np.float32)).to(
            torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32),
        tree)


def _tree_close(port, ref, what):
    """Leaf by leaf: bf16 leaves equal, float32 ones within OPT_RTOL of
    the leaf's scale.  Returns the number of leaves compared."""
    ref_leaves = jax.tree.leaves(ref)
    port_leaves = list(optim.tree_leaves(port))
    assert len(ref_leaves) == len(port_leaves), what
    for a, b in zip(ref_leaves, port_leaves):
        a = np.asarray(a)
        assert a.shape == tuple(b.shape), what
        if a.dtype == jnp.bfloat16:
            assert b.dtype == torch.bfloat16, what
            np.testing.assert_array_equal(_f32(b), a.astype(np.float32),
                                          what)
        elif a.dtype == np.int32:
            np.testing.assert_array_equal(b.numpy(), a, what)
        else:
            scale = max(np.abs(a).max(), 1e-30)
            assert np.abs(_f32(b) - a).max() <= OPT_RTOL * scale, what
    return len(ref_leaves)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("optimizer", ["adamw", "sgd", "sign_sgd"])
def test_optimizers_match_optax(optimizer, dtype):
    """The trainers' chains (clip + AdamW / SGD, sign-SGD) over three
    updates on seeded gradients, one of them above the clip: params and
    optimizer state leaf by leaf against optax's."""
    jcfg, tcfg = _cfgs()
    kw = dict(learning_rate=LR, warmup_steps=1, total_steps=10,
              optimizer=optimizer)
    jtx = jtrain.UMGenTrainer(JUMGen(jcfg), **kw).tx
    ttx = ttrain.UMGenTrainer(UMGen(tcfg), **kw).tx
    dt = jnp.bfloat16 if dtype == "bfloat16" else np.float32
    rng = np.random.default_rng(0)
    jp = jax.tree.map(jnp.asarray, _opt_tree(rng, 0.02, dt))
    tp = _to_torch(jp)
    grads = [jax.tree.map(jnp.asarray, _opt_tree(rng, s, dt))
             for s in (0.05, 3.0, 0.01)]

    def step(g, s, p):
        u, s = jtx.update(g, s, p)
        return optax.apply_updates(p, u), s

    js, ts = jtx.init(jp), ttx.init(tp)
    jstep = jax.jit(step).lower(grads[0], js, jp).compile(EXACT)
    for g in grads:
        jp, js = jstep(g, js, jp)
        u, ts = ttx.update(_to_torch(g), ts, tp)
        tp = optim.apply_updates(tp, u)
        _tree_close(tp, jp, "params")
        n = _tree_close(ts, js, "state")
    assert n == {"adamw": 10, "sgd": 1, "sign_sgd": 1}[optimizer]


def test_global_norm_sums_in_each_leafs_dtype():
    """bf16 leaves' sums of squares are bf16, and the running total stays
    bf16 until a float32 leaf joins it, as in optax."""
    rng = np.random.default_rng(2)
    tree = {"a": rng.normal(0, 1, (300,)).astype(jnp.bfloat16),
            "b": rng.normal(0, 1, (77,)).astype(jnp.bfloat16),
            "c": rng.normal(0, 1, (5,)).astype(np.float32)}
    want = optax.global_norm(jax.tree.map(jnp.asarray, tree))
    got = optim.global_norm(_to_torch(tree))
    assert got.dtype == torch.float32
    assert abs(float(got) - float(want)) <= 1e-6 * float(want)


# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------
def test_loss_terms_match_jax_relative_pe_label_smoothing(setup):
    """float32, the relative temporal PE (seeded nonzero tpe_rel),
    oar_label_smooth 0.1."""
    print("float32 relative-PE loss terms, relative errors:",
          _check_terms(setup["port_metrics"], setup["metrics"],
                       F32_LOSS_RTOL))


def test_loss_terms_match_jax_bf16(setup):
    """bf16 (the config's default dtype) under the JAX CLI's default, the
    absolute PE: params of the config's dtypes (JAX's initializer's, cast),
    a forward-only jit on JAX's side, excess precision off.  (The absolute
    PE in float32: tests/test_torch_train_steps.py.)"""
    dtype = "bfloat16"
    jcfg, tcfg = _cfgs(dtype=dtype)
    jt = jtrain.UMGenTrainer(JUMGen(jcfg), learning_rate=LR)
    tt = ttrain.UMGenTrainer(UMGen(tcfg), learning_rate=LR)
    shapes = jax.eval_shape(JUMGen(jcfg).init_params, jax.random.PRNGKey(0))
    params = jax.tree.map(lambda a, s: jnp.asarray(a, s.dtype),
                          setup["params"], shapes)
    trainable, buffers = jtrain.split_params(params)
    args = (trainable, buffers, setup["batch"], jax.random.PRNGKey(0))
    _, want = jax.jit(jt.loss_fn).lower(*args).compile(EXACT)(*args)
    state = tt.init_state(from_jax(params))
    with torch.no_grad():
        _, got = tt.loss_fn(state.params, state.buffers,
                            _port_batch(setup["raw"]))
    print("bf16 loss terms, relative errors:",
          _check_terms(got, want, BF16_LOSS_RTOL))


def _check_grads(port, ref):
    """Every leaf of the port's gradients against JAX's (the bounds above);
    returns (JAX's zero leaves, its roundoff leaves, the worst relative
    L2)."""
    gnorm = float(optax.global_norm(ref))
    zeros, roundoff, worst = [], [], 0.0
    for path, a in jax.tree_util.tree_leaves_with_path(ref):
        name = jax.tree_util.keystr(path)
        a, b = np.asarray(a), _f32(_get(port, path))
        assert a.shape == b.shape, name
        na = np.linalg.norm(a)
        if na == 0:
            zeros.append(name)
            assert not b.any(), name
        elif na <= 1e-7 * gnorm:
            roundoff.append(name)
            assert np.linalg.norm(b) <= 1e-7 * gnorm, name
        else:
            err = np.linalg.norm(b - a) / na
            worst = max(worst, err)
            assert err <= GRAD_RTOL, (name, err)
    print("worst relative L2", worst, "zeros", zeros, "roundoff", roundoff)
    # the port's grad_norm is optax.global_norm of the raw gradients
    assert abs(float(optim.global_norm(port)) - gnorm) <= 1e-5 * gnorm
    return sorted(zeros), roundoff, worst


def test_gradients_match_jax(setup):
    """Every leaf in float32 (relative PE: `tpe` is unused, `tpe_rel`
    learns)."""
    zeros, roundoff, _ = _check_grads(setup["port_grads"], setup["grads"])
    assert zeros == ["['head_ar_aux']['w']", "['head_tar_pose']['w']",
                     "['tpe']"]
    assert roundoff == ["['ego_ca']['cross_attn']['k']['b']"]


def test_param_dtype_is_read_by_nothing():
    """ModelConfig.param_dtype ("master param dtype") is never read: JAX's
    init_params builds every leaf in config.dtype (bf16) but `tpe_rel`
    (float32), and so does the port's (ROADMAP Queue 3)."""
    jcfg, tcfg = _cfgs(param_dtype="float32")
    shapes = jax.eval_shape(JUMGen(jcfg).init_params, jax.random.PRNGKey(0))
    mine = init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    for path, s in jax.tree_util.tree_leaves_with_path(shapes):
        name = jax.tree_util.keystr(path)
        got = _get(mine, path)
        assert tuple(got.shape) == s.shape, name
        assert str(got.dtype)[6:] == str(s.dtype), name
        if "buffers" not in name:
            assert s.dtype == (jnp.float32 if name == "['tpe_rel']"
                               else jnp.bfloat16), name


def test_a_mesh_is_not_ported(setup):
    with pytest.raises(NotPortedError, match="Multi-GPU and runtime"):
        setup["tt"].jit_train_step(mesh=object())


# ---------------------------------------------------------------------------
# no kernel inside an autograd graph
# ---------------------------------------------------------------------------
def test_kernels_refuse_inputs_that_require_a_gradient():
    """flash_attention and the decode-step entries have no backward: an
    input that requires a gradient while autograd records raises, on the
    CPU (the plain versions) as on the card; under no_grad, or with no
    such input, they run."""
    q = torch.randn(1, 6, 2, 48, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        tfa.flash_attention(q, q, q, causal=True)
    with torch.no_grad():
        out = tfa.flash_attention(q, q, q, causal=True)
    assert out.shape == q.shape
    tfa.flash_attention(q.detach(), q.detach(), q.detach(), causal=True)

    x = torch.zeros(1, 1, 64, dtype=torch.bfloat16, requires_grad=True)
    kv = torch.zeros(1, 1, 8, 64, dtype=torch.int8)
    for name in ("fused_decode_step_v5", "fused_decode_step_v2"):
        with pytest.raises(RuntimeError, match="no backward"):
            getattr(tdk, name)({}, x, kv, kv, 0, 4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_gradient_is_erfcs_as_in_jax(dtype):
    """JAX differentiates gelu through lax.erfc's jvp rule, -2/√π·exp(-z²);
    the port's gelu carries that derivative (`modules._GeluFn`), not the
    derivative of the polynomial that evaluates erfc (ROADMAP Queue 3).
    float32: within 1e-6 of the largest; bf16: within 2^-6 of the largest
    (JAX rounds to bf16 after each of the chain rule's ~8 ops, the port
    once).  The polynomial's own derivative, by autograd, is NaN at 0 (a
    branch `torch.where` selects away has 1/|z| there): printed beside
    it."""
    from umgen_tpu.models import modules as jnn
    from umgen_tpu_torch.models import modules as tnn
    x = np.random.default_rng(0).normal(0, 2, 4096).astype(np.float32)
    x[:3] = (0.0, 1e-30, -9.5)                 # erfc's branch edges
    w = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jx = jnp.asarray(x, jdt)
    want = _f32(jax.jit(jax.grad(lambda v: jnp.sum(
        jnn.gelu(v).astype(jnp.float32) * w))).lower(jx).compile(EXACT)(jx))
    tx = torch.from_numpy(x).to(tdt).requires_grad_(True)
    (tnn.gelu(tx).float() * torch.from_numpy(w)).sum().backward()
    got = _f32(tx.grad)
    assert np.isfinite(got).all()
    if dtype == "float32":
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    else:
        err = np.abs(got - want).max() / np.abs(want).max()
        print(f"bf16: within {err:.3g} of the largest gradient")
        assert err <= 2.0 ** -6
    poly = torch.from_numpy(x).to(tdt).requires_grad_(True)
    (tnn._gelu(poly).float() * torch.from_numpy(w)).sum().backward()
    p = _f32(poly.grad)
    print(f"{dtype}: the port against JAX {np.abs(got - want).max():.3g}; "
          f"the polynomial's derivative against JAX "
          f"{np.abs(p - want)[3:].max():.3g} away from 0, at 0: {p[:2]}")
