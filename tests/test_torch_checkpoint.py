"""The reference checkpoint importer of the port against the JAX package's.

A reference-format state dict (the names of ref:UMGen.py:176-245, torch's
[out, in] linear layout, biases on the attention projections only) is
written by the test itself at the tiny scale, seeded; no trained weights
are in the tree.  The port's `import_umgen` must equal the JAX package's
`import_umgen` followed by `params.from_jax` leaf for leaf — the same
names, shapes, dtypes and values (exact: the conversion transposes and
stacks, it does not compute) — and so must `load_umgen_checkpoint` from a
`torch.save`d DeepSpeed container, with and without codebook files.
And the loaded weights roll out as JAX's do: the loaders cast every
floating leaf to the config's dtype, the box and pose decode tables too,
and in bf16 those tables feed the rule constraint's kill decisions and the
pose decode — so a bf16 rollout on each package's loaded checkpoint is held
against the other, JAX's decisions replayed (tests/test_torch_slice.py).
"""

import jax
import numpy as np
import pytest
import torch

from test_torch_slice import (GAP_ULPS, _check_decisions, _decision_labels,
                              _exact_jit, _Recorder, _Replay)
from umgen_tpu.config import ModelConfig as JModelConfig
from umgen_tpu.data.pipeline import ScenePipeline as JScenePipeline
from umgen_tpu.data.synthetic import make_token_batch
from umgen_tpu.models.generate import Generator as JGenerator
from umgen_tpu.models.umgen import UMGen as JUMGen
from umgen_tpu.runtime import torch_import as jti
from umgen_tpu.runtime.quantize import quantize_params_int8 as j_quantize
from umgen_tpu_torch.config import ModelConfig
from umgen_tpu_torch.data.pipeline import ScenePipeline
from umgen_tpu_torch.layout import SequenceLayout
from umgen_tpu_torch.models import rollout as trollout
from umgen_tpu_torch.models.generate import Generator
from umgen_tpu_torch.models.umgen import UMGen
from umgen_tpu_torch.params import from_jax
from umgen_tpu_torch.runtime import torch_import as tti
from umgen_tpu_torch.runtime.quantize import quantize_params_int8

TR = "transformer"


def reference_state_dict(cfg, seed: int = 0, dtype=torch.float32):
    """A seeded state dict in the reference's names and layout for `cfg`
    (as tests/test_checkpoint.py writes one, sized by the config)."""
    g = torch.Generator().manual_seed(seed)
    d = cfg.n_embd
    sd = {}

    def rand(*shape):
        return (0.02 * torch.randn(*shape, generator=g)).to(dtype)

    def lin(name, i, o, bias):
        sd[f"{name}.weight"] = rand(o, i)
        if bias:
            sd[f"{name}.bias"] = rand(o)

    def ln(name):
        sd[f"{name}.weight"] = (1.0 + rand(d)).to(dtype)

    def attn(name):
        lin(f"{name}.c_attn", d, 3 * d, True)
        lin(f"{name}.c_proj", d, d, True)

    def mlp(name, d_in=d):
        lin(f"{name}.c_fc", d_in, 4 * d, False)
        lin(f"{name}.c_proj", 4 * d, d, False)

    def block_tar(name):
        for i in range(1, 7):
            ln(f"{name}.ln_{i}")
        for a in ("spatial_attn_1", "temporal_attn", "spatial_attn_2"):
            attn(f"{name}.{a}")
        for m in ("mlp1", "mlp2", "mlp3"):
            mlp(f"{name}.{m}")

    def block_oar(name):
        ln(f"{name}.ln_1")
        ln(f"{name}.ln_2")
        attn(f"{name}.temporal_attn")
        mlp(f"{name}.mlp")

    def dec(name):
        for i in range(1, 5):
            ln(f"{name}.ln_{i}")
        attn(f"{name}.self_attn")
        for p in ("q_attn", "k_attn", "v_attn", "c_proj"):
            lin(f"{name}.cross_attn.{p}", d, d, True)
        mlp(f"{name}.mlp1")

    seq_len = SequenceLayout(cfg.task).seq_len
    for n, e in [("egoe", 3), ("axe", cfg.aux_vocab_size),
                 ("be", cfg.bbox3d_vocab_size), ("tpe", cfg.max_frame_len),
                 ("spe", seq_len), ("tske", 7)]:
        sd[f"{TR}.{n}.weight"] = rand(e, d)
    mlp("map_mlp_pre", cfg.n_map_embd)
    mlp("img_mlp_pre", cfg.n_img_embd)
    for n in ("ln_tar", "ln_oar", "ln_ego_tar", "ln_ego", "ln_map_tar",
              "ln_box_tar"):
        ln(f"{TR}.{n}")
    for stack, n, fn in (("TAR", cfg.n_tar_layer, block_tar),
                         ("OAR", cfg.n_oar_layer, block_oar),
                         ("ego_tar", cfg.n_ego_tar_layer, block_tar),
                         ("ego_cross_attn", cfg.n_ego_ca_layer, dec),
                         ("map_tar", cfg.n_map_tar_layer, block_tar),
                         ("box_tar", cfg.n_box_tar_layer, block_tar)):
        for i in range(n):
            fn(f"{TR}.{stack}.{i}")
    for h, o in [("head_tar_aux", cfg.aux_vocab_size),
                 ("head_tar_pose", cfg.pose_vocab_size),
                 ("head_tar_map", cfg.map_vocab_size),
                 ("head_tar_bbox3d", cfg.bbox3d_vocab_size),
                 ("head_ar_aux", cfg.aux_vocab_size),
                 ("head_ar_pose", cfg.pose_vocab_size),
                 ("head_ar_map", cfg.map_vocab_size),
                 ("head_ar_bbox3d", cfg.bbox3d_vocab_size),
                 ("head_ego", cfg.pose_vocab_size),
                 ("head_tar_img", cfg.img_vocab_size),
                 ("head_ar_img", cfg.img_vocab_size)]:
        lin(f"{TR}.{h}", d, o, False)
    return sd


def _cfg(**kw):
    return ModelConfig(**kw).scaled("tiny")


def _jcfg(**kw):
    return JModelConfig(**kw).scaled("tiny")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def assert_same_tree(port, ref):
    """Leaf for leaf: the same names, shapes, dtypes and values."""
    a, b = dict(_leaves(port)), dict(_leaves(ref))
    assert sorted(a) == sorted(b), sorted(set(a) ^ set(b))
    for k in a:
        assert a[k].dtype == b[k].dtype, (k, a[k].dtype, b[k].dtype)
        assert a[k].shape == b[k].shape, (k, a[k].shape, b[k].shape)
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32-dict", "bf16-dict"])
def test_import_umgen_matches_jax(dtype):
    """`import_umgen` on a float32 and on a bf16 state dict: float32 leaves
    (JAX's `_t` casts every tensor to float32), equal to JAX's import
    bridged by `from_jax`; the attention projections keep their biases,
    the MLPs have none."""
    sd = reference_state_dict(_cfg(), seed=1, dtype=dtype)
    port = tti.import_umgen(sd, _cfg(), device="cpu")
    assert_same_tree(port, from_jax(jti.import_umgen(sd, _jcfg())))
    assert "b" in port["oar"]["attn"]["qkv"]
    assert "b" not in port["oar"]["mlp"]["fc"]
    torch.testing.assert_close(
        port["head_ar_map"]["w"], sd[f"{TR}.head_ar_map.weight"].float().t(),
        rtol=0, atol=0)


@pytest.mark.parametrize("codebooks", [True, False],
                         ids=["codebooks", "no-codebooks"])
def test_load_umgen_checkpoint_matches_jax(tmp_path, codebooks):
    """A `torch.save`d DeepSpeed container ({"model_state": {"module":
    state dict}}) through both packages' `load_umgen_checkpoint`: every
    floating leaf in the config's dtype (bf16), the buffers attached (the
    VQ codebooks from their files where given, seeded ones otherwise), the
    two trees equal leaf for leaf."""
    cfg = _cfg()
    sd = reference_state_dict(cfg, seed=2)
    path = str(tmp_path / "UMGen.pt")
    torch.save({"model_state": {"module": sd}}, path)
    paths = {}
    if codebooks:
        g = torch.Generator().manual_seed(3)
        for what, shape in (("map", (cfg.map_vocab_size, cfg.n_map_embd)),
                            ("img", (cfg.img_vocab_size, cfg.n_img_embd))):
            paths[f"{what}_codebook_path"] = str(tmp_path / f"{what}.pth")
            torch.save(torch.randn(*shape, generator=g),
                       paths[f"{what}_codebook_path"])
    port = tti.load_umgen_checkpoint(path, cfg, pipeline=ScenePipeline(),
                                     device="cpu", **paths)
    ref = from_jax(jti.load_umgen_checkpoint(path, _jcfg(),
                                             pipeline=JScenePipeline(),
                                             **paths))
    assert_same_tree(port, ref)
    assert port["tar"]["sa1"]["qkv"]["w"].dtype == torch.bfloat16
    if codebooks:
        cb = torch.load(paths["map_codebook_path"])
        torch.testing.assert_close(port["buffers"]["map_codebook"],
                                   cb.to(torch.bfloat16), rtol=0, atol=0)


def test_extract_state_dict_unwraps_both_containers():
    sd = {f"{TR}.egoe.weight": torch.zeros(3, 4)}
    for ckpt in ({"model_state": {"module": sd}}, {"module": sd}, sd):
        assert tti.extract_state_dict(ckpt) is sd


def test_n_step_head_is_refused():
    """The widened n-step bbox TAR head: a state dict with it imports under
    n_step = 2 into head_tar_n_step_bbox3d [d, 2·V], leaf for leaf as the
    JAX package's importer; one without it is refused by the head's name,
    as is a config that does not ask for it (the reference's own load
    fails the same way, on the missing or unexpected weight)."""
    cfg = _cfg()
    sd = reference_state_dict(cfg)
    del sd[f"{TR}.head_tar_bbox3d.weight"]
    sd[f"{TR}.head_tar_n_step_bbox3d.weight"] = 0.02 * torch.randn(
        2 * cfg.bbox3d_vocab_size, cfg.n_embd,
        generator=torch.Generator().manual_seed(1))
    port = tti.import_umgen(sd, cfg.replace(n_step=2))
    assert "head_tar_bbox3d" not in port
    assert tuple(port["head_tar_n_step_bbox3d"]["w"].shape) == \
        (cfg.n_embd, 2 * cfg.bbox3d_vocab_size)
    assert_same_tree(port, from_jax(jti.import_umgen(sd, _jcfg(n_step=2))))
    with pytest.raises(KeyError, match="head_tar_n_step_bbox3d"):
        tti.import_umgen(reference_state_dict(cfg), cfg.replace(n_step=2))
    with pytest.raises(KeyError, match="head_tar_bbox3d"):
        tti.import_umgen(sd, cfg)


def test_imported_leaves_match_the_initializers_tree():
    """The imported tree has `init_params`'s names and shapes, so every
    module of the port takes it as it takes random weights."""
    from umgen_tpu_torch.params import init_params
    cfg = _cfg()
    port = tti.import_umgen(reference_state_dict(cfg), cfg)
    init = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    init.pop("buffers")
    a, b = dict(_leaves(port)), dict(_leaves(init))
    assert sorted(a) == sorted(b)
    assert all(a[k].shape == b[k].shape for k in a)
    assert np.all([a[k].dtype == torch.float32 for k in a])


def test_loaded_checkpoint_rollout_matches_jax(tmp_path, monkeypatch):
    """`Generator.generate` on each package's `load_umgen_checkpoint` of
    the same `torch.save`d state dict, in bf16 (the decode tables cast with
    the weights), int8 over the decode keys as the CLI's `--int8 decode`
    leaves them: the reference CLI's default decode (recompute mode, the
    unfused body on an fp8 OAR cache), the rule constraint on, greedy, 3
    new frames under a 2-frame window.  JAX's Generator runs first with its
    decisions recorded; the port's replays them.  Every decision's logit
    within GAP_ULPS bf16 ulps of JAX's, the port's argmax JAX's token
    wherever JAX's top-2 gap is wider, and the token streams equal — the
    rule constraint's kills and the pose decode included.  The window holds
    ten live agents, so that newborn boxes are kept or killed by their
    collisions, not by the 30-box cap; the rule constraint must have tested
    real boxes (x < 63 on both sides) decoded from the bf16 tables, and
    found collisions among them."""
    kw = dict(sample_method="greedy", tar_mode="recompute",
              tar_cache_dtype="float8_e4m3fn",
              oar_cache_dtype="float8_e4m3fn", fused_oar_kernel=False,
              tar_cache_window=20)
    cfg = ModelConfig(**kw).scaled("tiny")
    jcfg = JModelConfig(**kw).scaled("tiny")
    assert cfg.dtype == "bfloat16" and cfg.rule_constrain
    path = str(tmp_path / "UMGen.pt")
    torch.save({"module": reference_state_dict(cfg, seed=4)}, path)
    jparams = j_quantize(jti.load_umgen_checkpoint(
        path, jcfg, pipeline=JScenePipeline()))
    params = quantize_params_int8(tti.load_umgen_checkpoint(
        path, cfg, pipeline=ScenePipeline(), device="cpu"))
    for name in ("agent_bin_mid", "agent_span", "agent_lo", "ego_bin_mid"):
        assert params["buffers"][name].dtype == torch.bfloat16, name

    jmodel = JUMGen(jcfg)
    cond = make_token_batch(jmodel.layout, T=2, B=1, seed=5, config=jcfg)
    # ten agents alive in the window: a newborn box is then kept or killed
    # by its collisions, not by the 30-box cap
    boxes = cond["bbox3d"].reshape(1, 2, -1, 11).copy()
    boxes[:, :, 10:] = cfg.bbox3d_vocab_size - 1
    cond["bbox3d"] = boxes.reshape(1, 2, -1)
    jgen = JGenerator(jmodel, jparams, seed=0)
    rec = _Recorder(jgen.rollout)
    jgen._step_cache["plain"] = _exact_jit(
        lambda p, inp, rng, fd: jgen.rollout.frame_step(
            p, inp, rng, forced_tokens=fd))
    gen_kw = dict(new_frames=3, cond_frames=2, input_cond_frames=2)
    jout = jgen.generate(cond, **gen_kw)
    jax.effects_barrier()

    tested = {"boxes": 0, "collisions": 0}
    real = trollout.candidate_collides

    def counted(cand, boxes, valid):
        assert cand.dtype == torch.bfloat16
        hit = real(cand, boxes, valid)
        ok = (cand[:, 0] < 63) & (valid & (boxes[..., 0] < 63)).any(-1)
        tested["boxes"] += int(ok.sum())
        tested["collisions"] += int(hit.sum())
        return hit

    monkeypatch.setattr(trollout, "candidate_collides", counted)
    torch.set_num_threads(2)
    gen = Generator(UMGen(cfg), params, device="cpu")
    replay = _Replay(gen.rollout, rec.calls)
    out = gen.generate(cond, **gen_kw)
    worst = _check_decisions(rec.calls, replay.seen,
                             _decision_labels(gen.model.layout) * 3,
                             frame="1-3", ulps=GAP_ULPS)
    for m in jout:
        assert out[m].shape == (1, 5, jout[m].shape[-1])
        np.testing.assert_array_equal(out[m], jout[m], err_msg=m)
    print(f"loaded bf16 checkpoint: decision logits within {worst:.3g} bf16 "
          f"ulps of JAX's; the rule constraint tested {tested['boxes']} "
          f"real boxes, {tested['collisions']} collisions")
    assert tested["boxes"] > 0 and tested["collisions"] > 0
