"""Tensor parallelism in the port's rollouts (parallel/mesh.py's Megatron
split, `UMGen.on_mesh`, `Generator(spmd="gspmd")`) against the JAX
package's GSPMD programs, on the CPU: two gloo ranks at tp = 2
(tests/torch_dp_worker.py's pool, one for the file), the tiny scale in
float32 with plain attention, greedy; JAX's side on conftest's virtual
devices under `make_mesh(dp=1, tp=2)`.

  * the split itself: every leaf's rule against JAX's `_spec_for`, path
    by path on the tiny tree (raw, int8 and W4), with the port's listed
    layouts where they differ; each rank's shapes; the round trip; the
    refusal of a tp that does not divide a head or a vocab;
  * one recompute frame (`Rollout.frame_step`) against `jax.jit(Rollout.
    frame_step)` on GSPMD-sharded params;
  * the cached rollout (dp = 1, tp = 2, 2-frame rings, the prefill frame and
    one cached frame) against JAX's gspmd `Generator`, the OAR split (the
    unfused decode); and on int8 decode packs, whose OAR stays whole,
    against the port's one-process run.

JAX's decisions are recorded on its one-device program (JAX's ordered
host callbacks refuse a multi-device program) and replayed in the ranks,
as tests/test_torch_dp.py replays them; JAX's GSPMD program must give the
same tokens as its one-device one.  Tolerances, stated before measuring:
the port's logit for JAX's token within LOGIT_ATOL = 1e-5 of JAX's (the
float32 all-reduce and XLA's sums add in other orders), its argmax JAX's
token wherever JAX's top-2 gap exceeds 2·LOGIT_ATOL, and its tokens equal
to JAX's GSPMD program's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_slice import _Recorder
from torch_dp_worker import Pool
from umgen_tpu.config import ModelConfig as JModelConfig
from umgen_tpu.data.synthetic import make_token_batch
from umgen_tpu.models.generate import Generator as JGenerator
from umgen_tpu.models.rollout import Rollout as JRollout
from umgen_tpu.models.umgen import UMGen as JUMGen
from umgen_tpu.parallel import mesh as jmesh
from umgen_tpu.runtime.quantize import quantize_params_int8 as jq_int8
from umgen_tpu.runtime.quantize import quantize_params_w4 as jq_w4
from umgen_tpu_torch.config import ModelConfig
from umgen_tpu_torch.params import from_jax
from umgen_tpu_torch.parallel import mesh as mesh_lib
from umgen_tpu_torch.parallel.mesh import Mesh

W = 2                # the rings' length and the window
NEW = 2              # the prefill frame and one cached frame
LOGIT_ATOL = 1e-5
KW = dict(dtype="float32", param_dtype="float32", sample_method="greedy",
          use_pallas_attention=False, tar_cache_dtype="float32",
          oar_cache_dtype="float32", tar_cache_window=W,
          tar_mode="temporal_cache")


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two intra-op threads: the suite runs several workers on the same
    cores, and torch's default (one thread per core) oversubscribes
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pool():
    p = Pool(2, tp=2)
    yield p
    p.close()


@pytest.fixture(scope="module")
def pool4():
    p = Pool(4, tp=2)
    yield p
    p.close()


@pytest.fixture(scope="module")
def jparams():
    jmodel = JUMGen(JModelConfig(**KW).scaled("tiny"))
    return jmodel, jmodel.init_params(jax.random.PRNGKey(0))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rank(r, tp=2):
    """Rank r's view of a one-group tp mesh (no process group: the pure
    sharding functions read only its tp index)."""
    return Mesh(1, r, torch.device("cpu"), None, tp)


# ---------------------------------------------------------------------------
# the split
# ---------------------------------------------------------------------------
# the port's layouts where they differ from GSPMD's: the fused qkv by heads
# (three parts), tpe_rel by heads, and the quantized leaves GSPMD keeps whole
PORT_ONLY = ("tpe_rel",)


def _jax_split_dim(spec):
    dims = [i for i, a in enumerate(spec) if a == "tp"]
    return dims[0] if dims else None


@pytest.mark.parametrize("tree", ["raw", "int8", "w4"])
def test_split_rules_follow_jax_spec_for(jparams, tree):
    """Every leaf of the tiny tree: where JAX's `_spec_for` puts tp on a
    dim, the port splits the same dim (a fused qkv in three parts); where
    JAX replicates, the port replicates but for tpe_rel (by heads) and the
    quantized leaves, which follow the float leaf they stand for."""
    _, params = jparams
    if tree == "int8":
        params = jq_int8(params)
    elif tree == "w4":
        params = jq_w4(params)
    flat = dict(jmesh._tree_paths(params))
    differ = []
    for path, leaf in flat.items():
        nd = np.ndim(leaf)
        want = _jax_split_dim(jmesh._spec_for(path, nd))
        rule = mesh_lib.split_rule(path)
        got = None if rule is None else rule[0] % nd
        if rule is not None and rule[1] != 1:
            assert path.endswith(("qkv/w", "qkv/b", "qkv/wq", "qkv/ws",
                                  "qkv/wq4", "qkv/ws4")), path
            assert rule[1] == 3
            differ.append(("qkv by heads", path))
        if got == want:
            continue
        leaf_name = path.rsplit("/", 1)[-1]
        assert want is None, (path, want, got)
        assert path in PORT_ONLY or leaf_name in ("wq", "ws", "wq4", "ws4"), \
            (path, got)
        differ.append(("port only", path))
    assert differ
    # the rules JAX's own test pins
    assert mesh_lib.split_rule("oar/attn/qkv/w") == (-1, 3)
    assert mesh_lib.split_rule("oar/attn/proj/w") == (-2, 1)
    assert mesh_lib.split_rule("head_ar_map/w") == (-1, 1)
    assert mesh_lib.split_rule("oar/attn/proj/b") is None
    assert mesh_lib.split_rule("oar/attn/proj/ws") is None
    assert mesh_lib.split_rule("be") is None
    assert mesh_lib.split_rule("buffers/map_codebook") is None


def test_shards_per_rank_and_the_round_trip(jparams):
    """tp = 2 on the tiny tree: the shapes of each rank's blocks; rank r's
    fused qkv holds columns r of q, k and v (its heads); the row-parallel
    proj holds input rows r; the blocks reassemble to the whole tree."""
    _, params = jparams
    whole = from_jax(params)
    ranks = [_rank(r).shard_params(whole) for r in range(2)]
    d = 64
    for r, sp in enumerate(ranks):
        qkv = sp["tar"]["sa1"]["qkv"]
        assert tuple(qkv["w"].shape) == (1, d, 3 * d // 2)
        assert tuple(qkv["b"].shape) == (1, 3 * d // 2)
        full = whole["tar"]["sa1"]["qkv"]["w"].reshape(1, d, 3, d)
        np.testing.assert_array_equal(
            qkv["w"].reshape(1, d, 3, d // 2).numpy(),
            full[..., r * d // 2:(r + 1) * d // 2].numpy())
        assert tuple(sp["tar"]["sa1"]["proj"]["w"].shape) == (1, d // 2, d)
        assert tuple(sp["tar"]["sa1"]["proj"]["b"].shape) == (1, d)
        assert tuple(sp["tar"]["mlp1"]["fc"]["w"].shape) == (1, d, 2 * d)
        assert tuple(sp["tar"]["mlp1"]["proj"]["w"].shape) == (1, 2 * d, d)
        assert tuple(sp["ego_ca"]["cross_attn"]["k"]["w"].shape) == \
            (1, d, d // 2)
        assert tuple(sp["head_ar_map"]["w"].shape) == (d, 8192 // 2)
        assert tuple(sp["head_tar_bbox3d"]["w"].shape) == (d, 1028 // 2)
        assert tuple(sp["tpe_rel"].shape) == (2, 100)
        assert sp["be"] is whole["be"]
    for path, t in mesh_lib.tree_paths(whole):
        parts = [dict(mesh_lib.tree_paths(sp))[path] for sp in ranks]
        np.testing.assert_array_equal(
            mesh_lib.unshard_leaf(parts, mesh_lib.split_rule(path)).numpy(),
            t.numpy(), err_msg=path)


def test_decode_packs_keep_the_oar_whole(jparams):
    """A tree with decode packs keeps its OAR stack (and the packs) whole
    on every rank; the TAR family is still split."""
    from umgen_tpu_torch.runtime.quantize import (pack_fused,
                                                  quantize_params_int8)
    _, params = jparams
    packed = pack_fused(quantize_params_int8(from_jax(params)))
    sp = _rank(1).shard_params(packed)
    assert sp["oar"]["attn"]["qkv"]["wq"] is packed["oar"]["attn"]["qkv"]["wq"]
    assert sp["oar_packed"]["wqkv"] is packed["oar_packed"]["wqkv"]
    assert sp["tar"]["ta"]["qkv"]["w"].shape[-1] == 96


def test_tp_that_does_not_divide_is_refused(jparams):
    """tp = 3 divides neither the 4 heads nor the vocabs (JAX's
    `test_param_specs_divide_shapes` demands it divides every split)."""
    from umgen_tpu_torch.models.umgen import UMGen
    _, params = jparams
    with pytest.raises(ValueError, match="tp=3 does not divide"):
        _rank(0, tp=3).shard_params(from_jax(params))
    with pytest.raises(ValueError, match="tp=3 does not divide n_head 4"):
        UMGen(ModelConfig(**KW).scaled("tiny")).on_mesh(_rank(0, tp=3))


# ---------------------------------------------------------------------------
# the rollouts against JAX's GSPMD programs
# ---------------------------------------------------------------------------
def _check(res, calls, what):
    """The ranks' readings of the replayed decisions against JAX's."""
    top1 = np.concatenate([c[1][..., 0].reshape(-1) for c in calls])
    top2 = np.concatenate([c[1][..., 1].reshape(-1) for c in calls])
    tok = np.concatenate([c[0].reshape(-1) for c in calls])
    for r in res:
        np.testing.assert_array_equal(r["ptok"], res[0]["ptok"])
        drift = np.abs(r["ptok"] - top1)
        assert drift.max() <= LOGIT_ATOL, (what, drift.max())
        wide = top1 - top2 > 2 * LOGIT_ATOL
        assert (r["parg"][wide] == tok[wide]).all(), what
        assert (r["pmax"] - r["ptok"] <= 2 * LOGIT_ATOL).all(), what
    print(f"{what}: {len(calls)} decisions, logits within "
          f"{drift.max():.3g} of JAX's")


def test_frame_step_matches_jax_gspmd(pool, jparams):
    """One recompute frame at tp = 2, B = 2 against JAX's jitted frame step
    on GSPMD-sharded params."""
    cfg = JModelConfig(**dict(KW, tar_mode="recompute")).scaled("tiny")
    jmodel, params = JUMGen(cfg), jparams[1]
    raw = make_token_batch(jmodel.layout, T=2, B=2, seed=0, config=cfg)
    inputs = {k: jnp.asarray(v) for k, v in raw.items()}
    jro = JRollout(jmodel)
    rec = _Recorder(jro)
    ref = jax.jit(jro.frame_step)(params, inputs, jax.random.PRNGKey(5))
    jax.effects_barrier()
    pool.submit("tp_frame", cfg_kw=dataclasses.asdict(cfg),
                params=_np(params),
                inputs={k: v.astype(np.int64) for k, v in raw.items()},
                calls=rec.calls)
    mesh = jmesh.make_mesh(dp=1, tp=2)
    with mesh:
        got = jax.jit(JRollout(jmodel).frame_step)(
            jmesh.shard_params(params, mesh), inputs, jax.random.PRNGKey(5))
        gspmd = np.asarray(got.tokens)
    res = pool.collect()
    np.testing.assert_array_equal(gspmd, np.asarray(ref.tokens))
    _check(res, rec.calls, "frame step")
    for r in res:
        np.testing.assert_array_equal(r["tokens"], gspmd)


def test_v1_runs_the_whole_oar_under_tp(pool, jparams):
    """The v1 case at tp = 2 (`fused_oar_kernel`, int8 OAR weights without
    packs, a bfloat16 OAR cache): GSPMD replicates JAX's custom call, so
    the gspmd Generator gathers the split OAR whole and every Q = 1 push
    goes to v1 on all four heads, its outputs the one-process run's bit
    for bit; a Rollout handed the split OAR refuses the push by name
    instead of leaving the kernel."""
    kw = dict(KW, oar_cache_dtype="bfloat16", fused_oar_kernel=True)
    rng = np.random.default_rng(4)
    pushes = rng.normal(size=(3, 1, 1, 64)).astype(np.float32)
    assert ModelConfig(**kw).scaled("tiny").n_embd == pushes.shape[-1]
    for r in pool.run("tp_v1", cfg_kw=kw, params=_np(jparams[1]),
                      pushes=pushes):
        assert r["split_heads"] == 2 and r["oar_heads"] == 4
        assert "split int8 OAR" in r["refused"], r["refused"]
        # the tp run's three pushes, then the one-process run's
        assert r["calls"] == [4] * 6, r["calls"]
        for a, b in zip(r["tp"], r["one"]):
            np.testing.assert_array_equal(a, b)


# teacher-forced in the sampled rollouts over dp: the pose and the image
# segment are sampled (513 decisions a frame, each gathered over the mesh)
FORCED = ("map", "bbox3d")


def test_gspmd_rollout_samples_the_unsharded_noise(pool4, jparams):
    """spmd="gspmd" over dp = 2 × tp = 2 (four ranks), top-k sampling
    (FORCED teacher-forced), B = 4, the prefill frame: every rank samples
    the whole batch's logits, gathered over tp and then dp, with the run's
    seed and keeps its rows, so its tokens are the one-process run's with
    the same seed (tests/test_torch_dp.py holds dp = 2 alone).  The
    float32 all-reduce moves a logit by an ulp or so, which changes a
    draw only where the noise falls that close to a boundary: none does
    here, so the tokens are held equal.  Speculative sampling is refused
    there by name."""
    from umgen_tpu_torch.models.generate import Generator
    from umgen_tpu_torch.models.umgen import UMGen
    kw = dict(KW, sample_method="topk")
    cfg = ModelConfig(**kw).scaled("tiny")
    scenes = make_token_batch(UMGen(cfg).layout, T=W + 1, B=4, seed=6,
                              config=cfg)
    cond = {m: v[:, :W].astype(np.int64) for m, v in scenes.items()}
    forced = {m: scenes[m][:, W:].astype(np.int64) for m in FORCED}
    params = _np(jparams[1])
    pool4.submit("gspmd_sampled", cfg_kw=kw, params=params, cond=cond,
                 window=W, new_frames=1, forced=forced)
    ref = Generator(UMGen(cfg), from_jax(params), seed=0,
                    device="cpu").generate(cond, new_frames=1,
                                           cond_frames=W, input_cond_frames=W,
                                           forced_streams=forced)
    for r in pool4.collect():
        assert "sample_method='greedy'" in r["refused"], r["refused"]
        for m in ref:
            np.testing.assert_array_equal(r["tokens"][m], ref[m], err_msg=m)


# slow: two JAX rollout programs compile (~50 s alone, ~200 s among the
# suite's workers); the fast tier keeps the frame step against JAX's GSPMD
# program, and chip_smoke.py phase tp runs the cached frame on every call
@pytest.mark.slow
def test_cached_rollout_matches_jax_gspmd(pool, jparams):
    """The cached rollout at dp = 1, tp = 2, B = 2, the prefill frame and
    one cached frame, against JAX's gspmd Generator: the OAR split, the
    unfused body on each rank's two heads and a cache of them."""
    jmodel, params = jparams
    cond = make_token_batch(jmodel.layout, T=W, B=2, seed=3,
                            config=jmodel.config)
    jgen = JGenerator(jmodel, params, seed=0)
    rec = _Recorder(jgen.rollout)
    ref = jgen.generate(cond, new_frames=NEW, cond_frames=W,
                        input_cond_frames=W)
    jax.effects_barrier()
    pool.submit("tp_rollout", cfg_kw=KW, params=_np(params),
                cond={m: v.astype(np.int64) for m, v in cond.items()},
                window=W, new_frames=NEW, calls=rec.calls)
    mesh = jmesh.make_mesh(dp=1, tp=2)
    with mesh:
        gspmd = JGenerator(jmodel, jmesh.shard_params(params, mesh), seed=0,
                           mesh=mesh).generate(cond, new_frames=NEW,
                                               cond_frames=W,
                                               input_cond_frames=W)
    res = pool.collect()
    for m in ref:
        np.testing.assert_array_equal(np.asarray(gspmd[m]),
                                      np.asarray(ref[m]), err_msg=m)
    _check(res, rec.calls, "cached rollout")
    for r in res:
        assert r["oar_heads"] == 2
        for m in ref:
            np.testing.assert_array_equal(r["tokens"][m],
                                          np.asarray(gspmd[m]), err_msg=m)


# slow: the plain v5 / v5mq steps take ~75 s on the CPU; chip_smoke.py
# phase tp1 drives this path on the card on every call
@pytest.mark.slow
def test_cached_rollout_on_decode_packs_keeps_the_oar_whole(pool, jparams):
    """The prefill frame of one scene on int8 decode packs (`--fused_oar`:
    the plain versions of v5 and v5mq here) at tp = 2: the TAR family
    split, the OAR whole on both ranks, its tokens the port's one-process
    run's on the same packed params.  JAX's fused kernels have no GSPMD
    program to hold this against (GSPMD replicates a custom call, which is
    what the whole OAR is)."""
    from umgen_tpu_torch.models.generate import Generator
    from umgen_tpu_torch.models.umgen import UMGen
    from umgen_tpu_torch.runtime.quantize import (pack_fused,
                                                  quantize_params_int8)
    jmodel, params = jparams
    kw = dict(KW, oar_cache_dtype="int8", fused_oar_kernel=True)
    cond = make_token_batch(jmodel.layout, T=W, B=1, seed=3,
                            config=jmodel.config)
    cond = {m: v.astype(np.int64) for m, v in cond.items()}
    pool.submit("tp_rollout", cfg_kw=kw, params=_np(params), cond=cond,
                window=W, new_frames=1, oar_packed=True)
    gen = Generator(UMGen(ModelConfig(**kw).scaled("tiny")),
                    pack_fused(quantize_params_int8(from_jax(_np(params)))),
                    seed=0, device="cpu")
    ref = gen.generate(cond, new_frames=1, cond_frames=W,
                       input_cond_frames=W)
    for r in pool.collect():
        assert r["oar_heads"] == 4
        for m in ref:
            np.testing.assert_array_equal(r["tokens"][m], ref[m], err_msg=m)
