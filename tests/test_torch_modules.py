"""The port's modules against the JAX package's, at small sizes on the CPU.

Inputs are made with numpy from a seed and fed to both.  Single ops round
at the same points in both frameworks, so a bf16 output differs only where
a float32 summation-order difference straddles a rounding boundary: one
ulp, rarely.  Whole blocks are held to a few ulps of the output's scale
instead: XLA fuses a jitted block and then keeps some intermediates in
float32 where the op-by-op reference rounds them (JAX's own fused and
op-by-op results for one TAR block differ in ~25% of the outputs by an
ulp).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umgen_tpu.config import ModelConfig
from umgen_tpu.models import modules as jnn
from umgen_tpu.models.umgen import UMGen as JUMGen
from umgen_tpu.models.umgen import build_buffers as j_build_buffers
from umgen_tpu.ops import collision as jcol
from umgen_tpu.ops import warp as jwarp
from umgen_tpu.runtime.quantize import quantize_params_int8 as j_quantize
from umgen_tpu_torch import params as tparams
from umgen_tpu_torch.models import modules as tnn
from umgen_tpu_torch.models import sampling as tsamp
from umgen_tpu_torch.models.umgen import NotPortedError, build_buffers
from umgen_tpu_torch.ops import collision as tcol
from umgen_tpu_torch.ops import warp as twarp
from umgen_tpu_torch.runtime.quantize import (pack_decode_weights,
                                              quantize_params_int8)
from umgen_tpu_torch.tools import evaluate

D, H = 64, 4
# bf16 outputs: at most one ulp apart, and only rarely
MAX_MISMATCH = 0.01


def _t(a, dtype=None):
    t = torch.tensor(np.asarray(jnp.asarray(a, jnp.float32)))
    return t.to(dtype) if dtype is not None else t


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _bf16_close(port, ref, what):
    """One bf16 ulp per element (values far below the tensor's scale may
    differ by one ulp of scale/1024: they come out of cancellations), in
    at most MAX_MISMATCH of the elements."""
    a, b = _f32(ref), _f32(port)
    floor = np.abs(a).max() / 1024
    ulp = 2.0 ** -7 * np.maximum(np.abs(a), floor)
    assert (np.abs(a - b) <= ulp).all(), what
    assert np.mean(a != b) <= MAX_MISMATCH, (what, np.mean(a != b))


def _block_close(port, ref, what, ulps=4):
    """Within `ulps` bf16 ulps (2^-8 each) of the output's scale."""
    a, b = _f32(ref), _f32(port)
    assert np.abs(a - b).max() <= ulps * 2.0 ** -8 * np.abs(a).max(), what


def _tree_map2(f, a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _tree_map2(f, a[k], b[k], f"{path}/{k}")
    else:
        f(a, b, path)


@pytest.fixture(scope="module")
def block():
    p = jnn.init_block_tar(jax.random.PRNGKey(0), D, False, jnp.bfloat16)
    rng = np.random.default_rng(0)
    # non-trivial norms and biases
    p = jax.tree.map(lambda a: jnp.asarray(
        np.asarray(a, np.float32) + 0.05 * rng.normal(size=a.shape),
        a.dtype), p)
    return p, tparams.from_jax(p)


def test_primitives_match_jax(block):
    jp, tp = block
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.normal(0, 1, (3, 50, D)), jnp.bfloat16)
    xt = _t(x, torch.bfloat16)
    _bf16_close(tnn.layer_norm(tp["ln1"], xt),
                jax.jit(jnn.layer_norm)(jp["ln1"], x), "layer_norm")
    _bf16_close(tnn.linear(tp["sa1"]["qkv"], xt),
                jax.jit(jnn.linear)(jp["sa1"]["qkv"], x), "linear + bias")
    jq = j_quantize({"head_x": jp["sa1"]["qkv"]}, keys=("head_x",))
    tq = quantize_params_int8({"head_x": tp["sa1"]["qkv"]}, keys=("head_x",))
    _bf16_close(tnn.linear(tq["head_x"], xt),
                jax.jit(jnn.linear)(jq["head_x"], x), "int8 linear")
    h = jax.jit(jnn.linear)(jp["mlp1"]["fc"], x)
    _bf16_close(tnn.gelu(_t(h, torch.bfloat16)), jax.jit(jnn.gelu)(h),
                "gelu")
    _bf16_close(tnn.mlp(tp["mlp1"], xt), jax.jit(jnn.mlp)(jp["mlp1"], x),
                "mlp")


@pytest.mark.parametrize("causal,Sq,Sk", [(False, 7, 7), (True, 7, 7),
                                          (True, 3, 9)])
def test_sdpa_matches_jax(causal, Sq, Sk):
    # float32: summation order only
    rng = np.random.default_rng(2)
    q, k, v = (rng.normal(0, 1, (2, S, H, 16)).astype(np.float32)
               for S in (Sq, Sk, Sk))
    ref = jnn.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal)
    out = tnn.sdpa(torch.tensor(q), torch.tensor(k), torch.tensor(v), causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-6)


def test_block_tar_collect_kv_matches_jax(block):
    jp, tp = block
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.normal(0, 1, (2, 3, 10, D)), jnp.bfloat16)
    y_j, (k_j, v_j) = jax.jit(lambda p, x: jnn.block_tar_collect_kv(
        p, x, H))(jp, x)
    y_t, (k_t, v_t) = tnn.block_tar(tp, _t(x, torch.bfloat16), H,
                                    collect_kv=True)
    for port, ref, what in ((y_t, y_j, "y"), (k_t, k_j, "k"),
                            (v_t, v_j, "v")):
        _block_close(port, ref, what)


def test_block_tar_decode_deferred_bf16_matches_jax(block):
    jp, tp = block
    rng = np.random.default_rng(4)
    B, S, T = 2, 10, 5
    x = jnp.asarray(rng.normal(0, 1, (B, S, D)), jnp.bfloat16)
    rk, rv = (jnp.asarray(rng.normal(0, 0.5, (B * S, T, H, D // H)),
                          jnp.bfloat16) for _ in range(2))
    for slot, n_valid in ((2, 3), (4, 5), (0, 5)):
        y_j, k_j, v_j = jax.jit(lambda p, x, a, b: jnn.
                                block_tar_decode_deferred(
                                    p, x, H, a, b, slot, n_valid))(
            jp, x, rk, rv)
        y_t, k_t, v_t = tnn.block_tar_decode_deferred(
            tp, _t(x, torch.bfloat16), H, _t(rk, torch.bfloat16),
            _t(rv, torch.bfloat16), slot, n_valid)
        for port, ref, what in ((y_t, y_j, "y"), (k_t, k_j, "k"),
                                (v_t, v_j, "v")):
            _block_close(port, ref, (what, slot))


def test_param_bridge_and_init_match_jax_tree():
    """from_jax keeps names, shapes, dtypes and values; init_params builds
    the JAX initializer's names, shapes and dtypes; build_buffers equals
    the JAX tables."""
    cfg = ModelConfig().scaled("tiny")
    jp = JUMGen(cfg).init_params(jax.random.PRNGKey(0))
    tp = tparams.from_jax(jp)
    dt = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "int8": torch.int8}

    def same(a, b, path):
        assert tuple(a.shape) == tuple(b.shape), path
        assert dt[jnp.asarray(a).dtype.name] == b.dtype, path
        np.testing.assert_array_equal(_f32(a), _f32(b), err_msg=path)

    _tree_map2(same, jp, tp)
    g = torch.Generator().manual_seed(0)
    ip = tparams.init_params(cfg, g, "cpu")

    def shaped(a, b, path):
        assert tuple(a.shape) == tuple(b.shape), path
        assert dt[jnp.asarray(a).dtype.name] == b.dtype, path

    _tree_map2(shaped, jp, ip)
    _tree_map2(same, jax.tree.map(np.asarray, j_build_buffers(cfg)),
               build_buffers(cfg))
    q = tparams.from_jax(j_quantize(jp))
    _tree_map2(same, j_quantize(jp)["oar"], q["oar"])


def test_quantize_and_pack_match_jax():
    from umgen_tpu.ops.decode_kernel import pack_fused_oar
    cfg = ModelConfig().scaled("tiny").replace(n_oar_layer=2)
    jp = {"oar": jnn.init_stack(jax.random.PRNGKey(2), 2, jnn.init_block_oar,
                                cfg.n_embd, False, jnp.bfloat16)}
    jq = j_quantize(jp)
    tq = quantize_params_int8(tparams.from_jax(jp))
    _tree_map2(lambda a, b, p: np.testing.assert_array_equal(
        _f32(a), _f32(b), err_msg=p), jq, tq)
    jpk = pack_fused_oar(jq["oar"])
    tpk = pack_decode_weights(tq["oar"])
    np.testing.assert_array_equal(np.asarray(jpk["vec"])[:, 0],
                                  tpk["vec"].numpy())
    d = cfg.n_embd
    wqp = np.asarray(jpk["wqp"])
    np.testing.assert_array_equal(wqp[..., :3 * d],
                                  tpk["wqkv"].transpose(1, 2).numpy())
    np.testing.assert_array_equal(wqp[..., 3 * d:],
                                  tpk["wproj"].transpose(1, 2).numpy())
    np.testing.assert_array_equal(np.asarray(jpk["wfc"]),
                                  tpk["wfc"].transpose(1, 2).numpy())
    np.testing.assert_array_equal(np.asarray(jpk["wpj"]),
                                  tpk["wpj"].transpose(1, 2).numpy())


def test_warp_matches_jax():
    rng = np.random.default_rng(5)
    feat = jnp.asarray(rng.normal(0, 1, (2, 3, 32 * 32, 8)), jnp.bfloat16)
    pose = rng.uniform(-3, 3, (2, 3, 3)).astype(np.float32)
    pose[..., 2] *= 0.1
    ref = jax.jit(jwarp.affine_warp_map)(feat, jnp.asarray(pose))
    out = twarp.affine_warp_map(_t(feat, torch.bfloat16), torch.tensor(pose))
    _bf16_close(out, ref, "warp")


def test_collision_matches_jax():
    rng = np.random.default_rng(6)
    B, N = 64, 12
    buf = np.zeros((B, N, 10), np.float32)
    buf[..., 0:2] = rng.uniform(-20, 20, (B, N, 2))
    buf[..., 3:5] = rng.uniform(1, 8, (B, N, 2))
    buf[..., 6] = rng.uniform(-3, 3, (B, N))
    buf[:, -1, 0] = 64.0                       # a decoded <pad> row
    cand = buf[:, 0].copy()
    cand[:, 0:2] += rng.uniform(-6, 6, (B, 2))
    valid = rng.uniform(size=(B, N)) < 0.8
    ref = np.asarray(jcol.candidate_collides(jnp.asarray(cand),
                                             jnp.asarray(buf),
                                             jnp.asarray(valid)))
    out = tcol.candidate_collides(torch.tensor(cand), torch.tensor(buf),
                                  torch.tensor(valid)).numpy()
    np.testing.assert_array_equal(out, ref)
    assert 0 < ref.sum() < B                  # both outcomes exercised


def test_collision_on_bf16_boxes_matches_jax():
    """The rule constraint on bf16 boxes, as a checkpoint's decode tables
    (cast to the config's dtype by both loaders) decode them: each box
    attribute a table entry times the span plus the offset, all bf16.  The
    corners promote to float32 on both sides (a float32 base times bf16
    dims) and agree within float32 rounding; the collision decisions are
    equal."""
    cfg = ModelConfig().scaled("tiny")
    bf = jnp.bfloat16
    jbuf = j_build_buffers(cfg)
    tbuf = build_buffers(cfg)
    rng = np.random.default_rng(7)
    B, N = 64, 12
    # attribute bins: x, y near the middle of their range so boxes meet
    bins = rng.integers(0, 1024, (B, N + 1, 10))
    bins[..., 0:2] = rng.integers(480, 545, (B, N + 1, 2))
    bins[:, -2, 0] = 1023                      # a far-away (x >= 63) row

    def decode(mid, span, lo, idx):
        return mid[idx] * span + lo

    jbox = decode(jnp.asarray(jbuf["agent_bin_mid"], bf),
                  jnp.asarray(jbuf["agent_span"], bf),
                  jnp.asarray(jbuf["agent_lo"], bf), jnp.asarray(bins))
    tbox = decode(tbuf["agent_bin_mid"].to(torch.bfloat16),
                  tbuf["agent_span"].to(torch.bfloat16),
                  tbuf["agent_lo"].to(torch.bfloat16), torch.as_tensor(bins))
    assert tbox.dtype == torch.bfloat16 and jbox.dtype == bf
    np.testing.assert_array_equal(tbox.float().numpy(),
                                  np.asarray(jbox, np.float32))
    jc = jcol.boxes_to_corners(jbox, negate_yaw=True)
    tc = tcol.boxes_to_corners(tbox, negate_yaw=True)
    assert tc.dtype == torch.float32 and jc.dtype == jnp.float32
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6,
                               atol=1e-5)
    valid = rng.uniform(size=(B, N)) < 0.8
    ref = np.asarray(jcol.candidate_collides(jbox[:, -1], jbox[:, :N],
                                             jnp.asarray(valid)))
    out = tcol.candidate_collides(tbox[:, -1], tbox[:, :N],
                                  torch.tensor(valid)).numpy()
    np.testing.assert_array_equal(out, ref)
    assert 0 < ref.sum() < B                  # both outcomes exercised


def test_samplers():
    logits = torch.tensor([[0.1, 0.5, 0.5, -1.0], [2.0, 0.0, 1.9, 1.8]])
    assert tsamp.greedy_sample(None, logits).tolist() == [1, 0]
    g = torch.Generator().manual_seed(0)
    draws = torch.stack([tsamp.top_k_sample(g, logits, k=2)
                         for _ in range(200)])
    assert set(draws[:, 0].tolist()) == {1, 2}
    assert set(draws[:, 1].tolist()) == {0, 2}
    # top-p keeps entries while the mass BEFORE them is <= p: the top token
    # always survives, p = 0 leaves only it
    draws = torch.stack([tsamp.top_p_sample(g, logits, p=0.0)
                         for _ in range(50)])
    assert (draws == tsamp.greedy_sample(None, logits)).all()
    probs = torch.softmax(logits[1], -1)
    sp, order = torch.sort(probs, descending=True)
    keep = ((torch.cumsum(sp, 0) - sp) <= 0.6)
    allowed = set(order[keep].tolist())
    draws = {int(tsamp.top_p_sample(g, logits[1:], p=0.6)[0])
             for _ in range(200)}
    assert draws == allowed


@pytest.mark.parametrize("flags,item", [
    (["--oar_kv_dtype", "float16"], "as if it were fp8"),
    (["--dp", "2", "--batch_size", "3"], "must be a multiple of --dp"),
    (["--launcher", "torch", "--tar_mode", "recompute"],
     "requires tar_mode='temporal_cache'"),
    (["--oar_batch_block", "5"], "VMEM-driven blockings"),
    (["--oar_kv_dtype", "float32"], "served are int8, int4, bfloat16"),
    (["--dp", "2", "--infer_task", "control"], "control mode runs"),
])
def test_cli_rejects_flags_outside_the_port(flags, item):
    """What the port refuses, each with its reason: NotPortedError naming
    its ROADMAP item or decision; under --dp what the JAX CLI refuses
    (its SystemExit, or its Generator's ValueError)."""
    base = ["--fused_oar", "--kv_dtype", "bfloat16", "--debug"]
    args = evaluate.build_parser().parse_args(base + flags)
    with pytest.raises((NotPortedError, SystemExit, ValueError), match=item):
        evaluate.check_args(args)
    evaluate.check_args(evaluate.build_parser().parse_args(base))


@pytest.mark.parametrize("flags", [
    ["--fused_oar", "--kv_dtype", "bfloat16", "--int8", "decode"],
    ["--fused_oar", "--kv_dtype", "int4"],
    ["--fused_oar", "--kv_dtype", "int4", "--int8", "all",
     "--chunked_prefill", "--tar_cache_window", "8", "--batch_size", "10"],
    ["--fused_oar", "--kv_dtype", "bfloat16", "--int8", "all",
     "--batch_size", "3", "--sample_method", "greedy", "--model_scale",
     "tiny"],
    ["--fused_oar", "--kv_dtype", "int4", "--oar_kv_dtype", "int8",
     "--chunked_prefill", "--tar_cache_window", "2", "--model_scale",
     "debug"],
    ["--fused_oar", "--kv_dtype", "bfloat16", "--int8", "decode",
     "--oar_kv_dtype", "int4"],
    ["--fused_oar", "--kv_dtype", "int4", "--int8", "all",
     "--chunked_prefill", "--tar_cache_window", "8", "--batch_size", "10",
     "--oar_kv_dtype", "int4"],
    ["--fused_oar", "--kv_dtype", "bfloat16", "--int8", "decode",
     "--oar_kv_dtype", "bfloat16"],
    ["--fused_oar", "--kv_dtype", "bfloat16", "--oar_kv_dtype",
     "float8_e4m3fn"],
    ["--fused_oar", "--kv_dtype", "bfloat16", "--batch_size", "2",
     "--oar_kernel", "7"],
    # the reference CLI's default run: fp8 rings, the unfused decode on an
    # fp8 OAR cache, int8 decode weights
    [],
    ["--fused_oar", "--kv_dtype", "bfloat16", "--tar_mode", "recompute"],
    ["--fused_oar", "--kv_dtype", "float8_e4m3fn"],
    ["--fused_oar", "--kv_dtype", "bfloat16", "--int8", "off"],
    ["--fused_oar", "--kv_dtype", "bfloat16", "--tar_cache_refresh", "2"],
    # speculative decoding, W4 TAR weights, int2 rings, the relative PE
    ["--fused_oar", "--kv_dtype", "bfloat16", "--speculative_k", "8"],
    ["--speculative_k", "4", "--no_spec_bbox"],
    ["--fused_oar", "--kv_dtype", "int2", "--tar_w4", "--int8", "all"],
    ["--kv_dtype", "int2", "--temporal_pe", "relative", "--tpe_clamp", "9"],
])
def test_cli_serves_flag_sets_as_jax_maps_them(flags):
    """The served flag sets (the reference CLI's default run, recompute
    mode, fp8 / int4 / int2 rings, ring refresh, --int8 off, int8 on every
    stack, chunked prefill, a ring window, any batch, the int4 / bfloat16 /
    fp8 OAR cache, --oar_kernel 7, speculative decoding, W4 TAR weights, the
    relative temporal PE) pass check_args and give the ModelConfig the JAX
    CLI gives them, field for field (the port's own ModelConfig class, so
    compared by fields; with --fused_oar or --kv_dtype int4 the OAR cache
    is int8 unless --oar_kv_dtype asks, without them the rings' type)."""
    import dataclasses

    from umgen_tpu.tools import evaluate as jevaluate
    argv = ["--debug"] + flags
    args = evaluate.build_parser().parse_args(argv)
    evaluate.check_args(args)
    got = evaluate.config_from_args(args)
    want = jevaluate.config_from_args(jevaluate.build_parser().parse_args(
        argv))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.oar_cache_dtype == (
        flags[flags.index("--oar_kv_dtype") + 1] if "--oar_kv_dtype" in flags
        else "int8" if "--fused_oar" in flags or "int2" in flags
        else "float8_e4m3fn")
    assert got.oar_kernel_version == (7 if "--oar_kernel" in flags else 5)
    assert got.tar_mode == ("recompute" if "--tar_mode" in flags
                            else "temporal_cache")


def test_cli_still_refuses_multi_gpu_profiling_and_the_videos():
    """Since the multi-GPU and runtime slice the CLI serves `--dp`,
    `--launcher` and `--profile_dir`; under `--dp` it still refuses what
    the JAX CLI refuses there (control, recompute), each with JAX's
    reason.  The VQ pictures and videos are served (`--save_video` on by
    default, as in the JAX CLI), so the run no longer says that they are
    not written."""
    for flags in (["--dp", "2"], ["--launcher", "mpi"],
                  ["--profile_dir", "p"], ["--dp", "4", "--batch_size",
                                           "8", "--launcher", "torch"]):
        evaluate.check_args(evaluate.build_parser().parse_args(
            ["--debug", "--batch_size", "2"] + flags))
    for flags, err, words in (
            (["--infer_task", "control"], SystemExit, "per-scene"),
            (["--tar_mode", "recompute"], ValueError, "temporal_cache")):
        args = evaluate.build_parser().parse_args(
            ["--debug", "--dp", "2", "--batch_size", "2"] + flags)
        with pytest.raises(err, match=words):
            evaluate.check_args(args)
    assert not hasattr(evaluate, "NOT_PORTED_OUTPUTS")
    assert evaluate.build_parser().parse_args([]).save_video
    args = evaluate.build_parser().parse_args(
        ["--speculative_k", "8", "--no_spec_bbox", "--tar_w4", "--kv_dtype",
         "int2", "--temporal_pe", "relative"])
    evaluate.check_args(args)


def test_cli_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    """Without --device the CLI takes the card, and where there is none it
    raises before it builds anything: it never carries on on the CPU
    unasked (`--device cpu` is how the tests ask)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = evaluate.build_parser().parse_args(
        ["--fused_oar", "--kv_dtype", "bfloat16", "--debug"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate.run(args)
