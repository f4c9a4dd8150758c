"""The configuration no published checkpoint uses, in the port against the
JAX package, on the CPU at the tiny scale in float32:

  * the n-step bbox TAR head (n_step = 2): the initializer's tree; the
    step-0 slice of its logits (`UMGen.tar_bbox_logits`, JAX's
    `slice_linear_out`) on raw, int8 and W4 weights, and over a tp = 2
    split; a frame and the trainer's loss on a head whose step-0 columns
    are the one-step head's give the one-step run's tokens and loss;
  * bias=True (attention projections without biases, MLPs with them, on
    seeded nonzero biases): the initializer's tree, the recompute ego
    logits, TAR priors and the teacher-forced OAR pass against JAX's; the
    fused decode path's packers, which in the JAX package raise KeyError:
    'b', refused by name in the port (ROADMAP Queue 3);
  * `rms_norm` against JAX's;
  * the framework-free modules the port copied (registry, data/loading,
    data/token_transform): the port's registry builds the port's classes,
    the transforms give JAX's values.

Tolerances, stated before measuring: float32 logits, priors and
activations within 1e-5 of JAX's (XLA and PyTorch sum in other orders);
slices, losses and tokens of the self-consistency cases equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umgen_tpu.config import ModelConfig as JModelConfig
from umgen_tpu.data.synthetic import make_token_batch
from umgen_tpu.models import modules as jnn
from umgen_tpu.models.umgen import UMGen as JUMGen
from umgen_tpu.runtime import quantize as jquant
from umgen_tpu_torch.config import ModelConfig
from umgen_tpu_torch.models import modules as nn
from umgen_tpu_torch.models.umgen import UMGen
from umgen_tpu_torch.params import from_jax, init_params
from umgen_tpu_torch.parallel import mesh as mesh_lib
from umgen_tpu_torch.runtime import quantize as tquant

ATOL = 1e-5
KW = dict(dtype="float32", param_dtype="float32", sample_method="greedy",
          use_pallas_attention=False, tar_mode="recompute")


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two intra-op threads: the suite runs several workers on the same
    cores, and torch's default (one thread per core) oversubscribes
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    j = JModelConfig(**dict(KW, **kw)).scaled("tiny")
    return j, ModelConfig(**dataclasses.asdict(j))


def _shapes(tree, prefix=""):
    return {p: tuple(np.shape(v)) for p, v in mesh_lib.tree_paths(tree)
            if not p.startswith("buffers")}


@pytest.mark.parametrize("kw", [dict(n_step=2), dict(bias=True)])
def test_initializer_tree_equals_jax(kw):
    jcfg, tcfg = _cfgs(**kw)
    want = _shapes(jax.tree.map(np.asarray, JUMGen(jcfg).init_params(
        jax.random.PRNGKey(0))))
    got = _shapes(init_params(tcfg, torch.Generator().manual_seed(0),
                              "cpu"))
    assert got == want


# ---------------------------------------------------------------------------
# the n-step head
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def n_step():
    jcfg, tcfg = _cfgs(n_step=2)
    jparams = jax.tree.map(np.asarray,
                           JUMGen(jcfg).init_params(jax.random.PRNGKey(0)))
    x = np.random.default_rng(0).normal(0, 1, (2, 5, 64)).astype(np.float32)
    return jcfg, tcfg, jparams, x


@pytest.mark.parametrize("weights", ["raw", "int8", "w4"])
def test_n_step_logits_are_the_step0_slice(n_step, weights):
    """The head's step-0 logits against JAX's `slice_linear_out` product
    (the int8 and W4 leaves quantized bit for bit as JAX's)."""
    jcfg, tcfg, jparams, x = n_step
    name = "head_tar_n_step_bbox3d"
    if weights == "int8":
        jparams = jquant.quantize_params_int8(jparams,
                                              keys=jquant.ALL_STACK_KEYS)
    elif weights == "w4":
        jparams = jquant.quantize_params_w4(jparams, keys=(name,))
    jparams = jax.tree.map(np.asarray, jparams)
    want = jnn.linear(jnn.slice_linear_out(jparams[name],
                                           jcfg.bbox3d_vocab_size),
                      jnp.asarray(x))
    tparams = from_jax(jax.tree.map(np.asarray, JUMGen(jcfg).init_params(
        jax.random.PRNGKey(0))))
    if weights == "int8":
        tparams = tquant.quantize_params_int8(tparams,
                                              keys=tquant.ALL_STACK_KEYS)
    elif weights == "w4":
        tparams = tquant.quantize_params_w4(tparams, keys=(name,))
    for k, v in tparams[name].items():
        np.testing.assert_array_equal(v.numpy(), jparams[name][k], k)
    got = UMGen(tcfg).tar_bbox_logits(tparams, torch.as_tensor(x))
    assert got.shape == (2, 5, tcfg.bbox3d_vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_n_step_head_under_tp_is_the_gathered_slice(n_step):
    """At tp = 2 each rank holds a contiguous half of the 2·V columns (the
    JAX layout); its logits gathered and cut to V are the whole head's
    step-0 logits."""
    _, tcfg, jparams, x = n_step
    name = "head_tar_n_step_bbox3d"
    whole = from_jax(jparams)
    rule = mesh_lib.split_rule(f"{name}/w")
    parts = [nn.linear({"w": mesh_lib.shard_leaf(whole[name]["w"], rule, 2,
                                                 r)}, torch.as_tensor(x))
             for r in range(2)]
    got = torch.cat(parts, -1)[..., :tcfg.bbox3d_vocab_size]
    want = UMGen(tcfg).tar_bbox_logits(whole, torch.as_tensor(x))
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def _with_n_step_head(tparams, V):
    """The one-step tree with an n-step head whose step-0 columns are the
    one-step head's (step 1 random)."""
    p = dict(tparams)
    head = p.pop("head_tar_bbox3d")["w"]
    extra = torch.randn(head.shape, generator=torch.Generator().manual_seed(3))
    p["head_tar_n_step_bbox3d"] = {"w": torch.cat([head, 0.02 * extra], -1)}
    assert p["head_tar_n_step_bbox3d"]["w"].shape[-1] == 2 * V
    return p


def test_n_step_frame_and_loss_read_step0(n_step):
    """A recompute frame (the bbox segment's TAR logits) and the trainer's
    loss on the widened head equal the one-step model's on its own head,
    and the loss does not reach the step-1 columns."""
    from umgen_tpu_torch.models.rollout import Rollout
    from umgen_tpu_torch.parallel.train import UMGenTrainer
    jcfg, tcfg, _, _ = n_step
    one_cfg = dataclasses.replace(tcfg, n_step=1)
    one = init_params(one_cfg, torch.Generator().manual_seed(0), "cpu")
    two = _with_n_step_head(one, tcfg.bbox3d_vocab_size)
    raw = make_token_batch(UMGen(one_cfg).layout, T=3, B=1, seed=2,
                           config=jcfg)
    batch = {k: torch.as_tensor(v, dtype=torch.long) for k, v in raw.items()}
    frames = {m: v[:, :2] for m, v in batch.items()}
    toks = [Rollout(UMGen(c)).frame_step(p, frames, None).tokens
            for c, p in ((one_cfg, one), (tcfg, two))]
    torch.testing.assert_close(toks[1], toks[0], rtol=0, atol=0)
    losses = []
    for c, p in ((one_cfg, one), (tcfg, two)):
        tr = UMGenTrainer(UMGen(c))
        state = tr.init_state(p)
        grads, m = tr.grads(state, batch)
        losses.append(float(m["loss"]))
    assert losses[0] == losses[1]
    g = grads["head_tar_n_step_bbox3d"]["w"]
    assert not g[:, tcfg.bbox3d_vocab_size:].any() and g.any()


# ---------------------------------------------------------------------------
# bias=True
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def biased():
    """JAX's bias=True tiny params with every bias seeded nonzero, and a
    window."""
    jcfg, tcfg = _cfgs(bias=True)
    jmodel = JUMGen(jcfg)
    params = jmodel.init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(4)

    def seed_bias(path, leaf):
        if path[-1].key == "b":
            return jnp.asarray(rng.normal(0, 0.05, leaf.shape), leaf.dtype)
        return leaf

    params = jax.tree_util.tree_map_with_path(seed_bias, params)
    raw = make_token_batch(jmodel.layout, T=2, B=1, seed=1, config=jcfg)
    return jmodel, UMGen(tcfg), params, raw


def test_biased_forward_matches_jax(biased):
    """The recompute ego logits, TAR priors and the OAR's teacher-forced
    pass over the priors, bias=True, against JAX's."""
    jmodel, model, params, raw = biased
    assert "b" not in params["tar"]["sa1"]["qkv"]
    assert "b" in params["tar"]["mlp1"]["fc"]
    jin = {k: jnp.asarray(v) for k, v in raw.items()}
    tin = {k: torch.as_tensor(v, dtype=torch.long) for k, v in raw.items()}
    tparams = from_jax(jax.tree.map(np.asarray, params))
    np.testing.assert_allclose(
        model.ego_logits(tparams, tin).numpy(),
        np.asarray(jax.jit(jmodel.ego_logits)(params, jin)), atol=ATOL)
    jpri = jax.jit(jmodel.tar_priors)(params, jin)["prior_seq"]
    tpri = model.tar_priors(tparams, tin)["prior_seq"]
    np.testing.assert_allclose(tpri.numpy(), np.asarray(jpri), atol=ATOL)
    np.testing.assert_allclose(
        model.oar_forward(tparams, tpri).numpy(),
        np.asarray(jax.jit(jmodel.oar_forward)(params, jpri)), atol=ATOL)


def test_biased_fused_decode_is_refused_as_jax_fails(biased):
    """JAX's decode packers read the attention biases unconditionally and
    carry no MLP bias: under bias=True they raise KeyError: 'b'.  The
    port's refuse by name (pack_fused, the W4A8 packer, and v1's packing
    of the unpacked int8 stack)."""
    _, _, params, _ = biased
    q = jquant.quantize_params_int8(params)
    with pytest.raises(KeyError, match="'b'"):
        jquant.pack_fused(q)
    tq = from_jax(jax.tree.map(np.asarray, q))
    raw = from_jax(jax.tree.map(np.asarray, params))
    match = "bias=True: the fused decode kernels"
    with pytest.raises(ValueError, match=match):
        tquant.pack_fused(tq)
    with pytest.raises(ValueError, match=match):
        tquant.pack_fused_w4(tq, raw["oar"])
    with pytest.raises(ValueError, match=match):
        tquant.pack_decode_weights(tq["oar"])


# ---------------------------------------------------------------------------
# rms_norm and the copied modules
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(dtype):
    """Within a float32 ulp's worth (rsqrt and the mean's sum differ in
    their last bit), one bf16 ulp where the output is bf16."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    w = rng.normal(size=(64,)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jnn.rms_norm({"w": jnp.asarray(w, jdt)}, jnp.asarray(x, jdt))
    got = nn.rms_norm({"w": torch.as_tensor(w).to(tdt)},
                      torch.as_tensor(x).to(tdt))
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2.0 ** -8 if dtype == "bfloat16"
                               else 1e-6, atol=0)


def test_registry_builds_the_ports_classes():
    from umgen_tpu_torch.data.dataset import NuPlanTokenDataset
    from umgen_tpu_torch.registry import DATASETS, MODELS, register_builtins
    register_builtins()
    register_builtins()   # idempotent
    assert MODELS.get("UMGen") is UMGen
    assert DATASETS.get("NuPlanTokenDataset") is NuPlanTokenDataset
    m = MODELS.build({"type": "UMGen", "config": ModelConfig(
        use_pallas_attention=False).scaled("tiny")})
    assert isinstance(m, UMGen)


def test_token_transforms_equal_jax():
    from umgen_tpu.data import token_transform as jtt
    from umgen_tpu_torch.data import token_transform as ttt
    rng = np.random.default_rng(0)
    boxes = rng.normal(0, 10, (7, 10)).astype(np.float32)
    motion = [1.5, -0.3, 0.2]
    np.testing.assert_array_equal(
        ttt.transform_boxes_to_next_frame(boxes, motion),
        jtt.transform_boxes_to_next_frame(boxes, motion))
    pos = rng.normal(0, 5, (9, 2)).astype(np.float32)
    np.testing.assert_array_equal(ttt.generate_radius_mask(pos, 6.0),
                                  jtt.generate_radius_mask(pos, 6.0))
    x = rng.normal(size=(4, 3)).astype(np.float32)
    np.testing.assert_array_equal(ttt.fourier_encode(x, n_bands=6),
                                  jtt.fourier_encode(x, n_bands=6))
    np.testing.assert_array_equal(ttt.se2_matrix(*motion),
                                  jtt.se2_matrix(*motion))


def test_image_loading_transforms_equal_jax(tmp_path):
    cv2 = pytest.importorskip("cv2")
    from umgen_tpu.data import loading as jl
    from umgen_tpu_torch.data import loading as tl
    paths = []
    for i in range(2):
        p = str(tmp_path / f"cam{i}.png")
        cv2.imwrite(p, np.full((64, 128, 3), 40 * (i + 1), np.uint8))
        paths.append(p)
    outs = []
    for mod in (jl, tl):
        res = {"img_filename": paths,
               "intrinsics": [np.eye(4, dtype=np.float32) * 500.0] * 2}
        res = mod.LoadMultiViewImageFromFiles(to_float32=True)(res)
        res = mod.ResizeCropFlipRotImage({
            "final_dim": (32, 64), "resize_lim": (0.5, 0.5),
            "bot_pct_lim": (0.0, 0.0), "rand_flip": False,
            "rot_lim": (0.0, 0.0)})(res)
        outs.append(mod.ToTensorCollect(["img", "intrinsics"])(res))
    for k in ("img", "intrinsics"):
        np.testing.assert_array_equal(np.asarray(outs[1][k]),
                                      np.asarray(outs[0][k]), k)
