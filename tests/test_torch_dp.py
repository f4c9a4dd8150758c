"""Data parallelism over scenes in the port (parallel/mesh.py,
`Generator(mesh=...)`, `SceneRunner.run_scenes(pad_to)`) against the JAX
package, on the CPU: two gloo ranks (tests/torch_dp_worker.py's pool, one
for the file) at the tiny scale in float32 with plain attention, greedy,
the cached video rollout (2-frame rings), the prefill frame and one cached
frame, from the JAX initializer's parameters.

Cases:
  * b2: B = 2, one scene a rank;
  * b3_map: B = 3 padded to 4 by the harness (the last scene repeated, its
    outputs dropped), `--init_token_mod map` (map forced to the GT
    continuation);
  * spec: B = 2, `--speculative_k 4`, map and image forced (the bbox
    segment speculated), free-running.

Rank 0's tokens are held against JAX's single-device Generator on the same
(unpadded) batch — the stand-in for JAX's `shard_map` program, which is
held itself in the slow case at the end — with JAX's decisions replayed as
tests/test_torch_generate_control.py replays them: at every decision the
port's argmax is JAX's token wherever JAX's top-2 gap is wider than
F32_ULPS bf16 ulps (2^-16 of the logit), and its logit for JAX's token
within that of JAX's; the streams must equal JAX's.  Each rank's tokens
(and, replaying, every decision's logits) must equal bit for bit the
port's one-process run of that rank's own shard: the same rows through the
same ops.  Under speculation the ranks' telemetry is summed: every rank
reports the sum of the one-process runs' chunks and accepted drafts.
The refusals, the launchers' environments and the collectives are held
here too; the CLI's `--dp 2` in tests/test_torch_dp_cli.py.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from test_torch_slice import _Recorder
from torch_dp_worker import Pool
from umgen_tpu.config import ModelConfig as JModelConfig
from umgen_tpu.data.synthetic import make_token_batch
from umgen_tpu.models.generate import Generator as JGenerator
from umgen_tpu.models.umgen import UMGen as JUMGen
from umgen_tpu_torch.config import ModelConfig
from umgen_tpu_torch.models.generate import Generator, rank_seed
from umgen_tpu_torch.models.umgen import UMGen
from umgen_tpu_torch.parallel import mesh as mesh_lib
from umgen_tpu_torch.tools import evaluate

W = 2              # the rings' length and the window
NEW = 2            # the prefill frame and one cached frame
# a float32 logit's drift from JAX's, in bf16 ulps (2^-15 of it): float32
# summation orders (tests/test_torch_generate_control.py)
F32_ULPS = 2.0 ** -8
KW = dict(dtype="float32", param_dtype="float32", sample_method="greedy",
          use_pallas_attention=False, tar_cache_dtype="float32",
          oar_cache_dtype="float32", tar_cache_window=W,
          tar_mode="temporal_cache")
CASES = {"b2": dict(B=2, forced=()),
         "b3_map": dict(B=3, forced=("map",)),
         "spec": dict(B=2, forced=("map", "image"), speculative_k=4)}


@pytest.fixture(scope="module")
def pool():
    p = Pool(2)
    yield p
    p.close()


def _jax_rollout(jmodel, jparams, scenes, forced):
    """JAX's single-device Generator on `scenes`, decisions recorded."""
    jgen = JGenerator(jmodel, jparams, seed=0)
    rec = _Recorder(jgen.rollout)
    out = jgen.generate({m: v[:, :W] for m, v in scenes.items()},
                        new_frames=NEW, cond_frames=W, input_cond_frames=W,
                        forced_streams={m: scenes[m][:, W:W + NEW]
                                        for m in forced} or None)
    jax.effects_barrier()
    return out, rec.calls


@pytest.fixture(scope="module")
def runs(pool):
    """Every case's ranks and JAX's runs; the pool rolls one case while
    this process runs JAX's next."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    jmodel = JUMGen(JModelConfig(**KW).scaled("tiny"))
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, jparams)
    scenes = make_token_batch(jmodel.layout, T=W + NEW, B=3, seed=0,
                              config=jmodel.config)
    scenes = {m: v.astype(np.int64) for m, v in scenes.items()}

    def submit(case, calls=None):
        c = CASES[case]
        kw = dict(KW, speculative_k=c.get("speculative_k", 0))
        pool.submit("rollout", cfg_kw=kw, params=params,
                    scenes={m: v[:c["B"]] for m, v in scenes.items()},
                    window=W, new_frames=NEW, init_token_mod=c["forced"],
                    calls=calls, ulps=F32_ULPS)

    out, jax_runs = {}, {}
    prev = "spec"
    submit(prev)
    for case in ("b3_map", "b2"):
        c = CASES[case]
        jax_runs[case] = _jax_rollout(
            jmodel, jparams, {m: v[:c["B"]] for m, v in scenes.items()},
            c["forced"])
        out[prev] = pool.collect()
        submit(case, jax_runs[case][1])
        prev = case
    out[prev] = pool.collect()
    out["collectives"] = pool.run("collectives")
    torch.set_num_threads(n)
    return {"ranks": out, "jax": {k: v[0] for k, v in jax_runs.items()},
            "scenes": scenes}


@pytest.mark.parametrize("case", ["b2", "b3_map"])
def test_dp_rollout_matches_jax(runs, case):
    ranks, jout = runs["ranks"][case], runs["jax"][case]
    B = CASES[case]["B"]
    toks = ranks[0]["tokens"]
    assert len(toks) == B
    for m in jout:
        got = np.concatenate([t[m] for t in toks])
        assert got.shape == jout[m].shape == (B, W + NEW, got.shape[-1])
        np.testing.assert_array_equal(got, jout[m], err_msg=m)
    for m in CASES[case]["forced"]:
        np.testing.assert_array_equal(
            np.concatenate([t[m] for t in toks])[:, W:],
            runs["scenes"][m][:B, W:W + NEW])
    print(f"{case}: decision logits within "
          f"{max(r['drift'] for r in ranks):.3g} bf16 ulps of JAX's")


@pytest.mark.parametrize("case", list(CASES))
def test_each_rank_equals_its_one_process_run(runs, case):
    """Rank r's rows of the gathered tokens equal the one-process run of
    its shard (the replaying cases also checked every decision's logits
    bit for bit inside the ranks)."""
    ranks = runs["ranks"][case]
    B = CASES[case]["B"]
    toks = ranks[0]["tokens"]
    per = -(-B // 2)
    for r, res in enumerate(ranks):
        for i in range(per):
            scene = r * per + i
            if scene >= B:           # the pad
                continue
            for m, v in toks[scene].items():
                np.testing.assert_array_equal(v[0], res["shard"][m][i],
                                              err_msg=(case, r, m))


def test_pad_to_drops_the_padding(runs):
    """B = 3 over two ranks: the harness pads the batch to 4 with a copy of
    the last scene; rank 0 writes the three scenes' pickles, rank 1
    nothing, and the timing counts three scenes; the agent metrics are
    finite."""
    r0, r1 = runs["ranks"]["b3_map"]
    assert r0["files"] == [f"scene_{i}_tokens.pkl" for i in range(3)]
    assert r1["files"] == []
    assert r0["timings"] == r1["timings"] == [(3, NEW)]
    assert all(np.isfinite(r0["collision"]))
    assert all(np.isfinite(v) for v in r0["mmd"].values())


def test_speculative_telemetry_is_summed(runs):
    r0, r1 = runs["ranks"]["spec"]
    total = tuple(np.add(r0["spec1"], r1["spec1"]))
    assert r0["spec"] == r1["spec"] == total
    assert r0["spec1"][0] > 0 and r1["spec1"][0] > 0


def test_mesh_collectives(runs):
    r0, r1 = runs["ranks"]["collectives"]
    assert (r0["rows"], r1["rows"]) == (slice(0, 3), slice(3, 6))
    np.testing.assert_array_equal(r1["shard"], [3, 4, 5])
    for r in (r0, r1):
        np.testing.assert_array_equal(r["tree"]["a"], np.full((2, 3), 1.5))
        np.testing.assert_array_equal(r["tree"]["b0"], np.arange(4) * 1.5)
        assert r["tree"]["b1"] == 5.0
        assert r["sum"] == [1, 2]
        np.testing.assert_array_equal(r["gather"], [[0, 0], [1, 1]])
        np.testing.assert_array_equal(r["broadcast"], [0, 7])


def test_rank_seeds_differ_and_repeat():
    seeds = [rank_seed(0, r) for r in range(4)] + [rank_seed(1, 0)]
    assert len(set(seeds)) == 5
    assert rank_seed(0, 1) == rank_seed(0, 1)
    assert all(0 <= s < 2 ** 63 for s in seeds)


# ---------------------------------------------------------------------------
# launchers and refusals
# ---------------------------------------------------------------------------
def test_launchers_read_their_environment():
    torchrun = {"RANK": "3", "WORLD_SIZE": "4", "LOCAL_RANK": "1",
                "MASTER_ADDR": "node0", "MASTER_PORT": "29500"}
    assert mesh_lib.launcher_env("torch", torchrun) == {
        "rank": 3, "world": 4, "local_rank": 1, "addr": "node0",
        "port": 29500}
    ompi = {"OMPI_COMM_WORLD_RANK": "5", "OMPI_COMM_WORLD_SIZE": "8",
            "OMPI_COMM_WORLD_LOCAL_RANK": "1", "MASTER_ADDR": "10.0.0.1",
            "MASTER_PORT": "1234"}
    assert mesh_lib.launcher_env("mpi", ompi) == {
        "rank": 5, "world": 8, "local_rank": 1, "addr": "10.0.0.1",
        "port": 1234}
    with pytest.raises(ValueError, match="MASTER_ADDR, MASTER_PORT not set"):
        mesh_lib.launcher_env("mpi", {k: v for k, v in ompi.items()
                                      if not k.startswith("MASTER")})
    with pytest.raises(ValueError, match="torch or mpi"):
        mesh_lib.launcher_env("slurm", torchrun)


def test_backends_and_devices():
    assert mesh_lib.backend_for(["cuda:0", "cuda:1"]) == "nccl"
    assert mesh_lib.backend_for(["cuda:0", "cuda:0"]) == "gloo"
    assert mesh_lib.backend_for(["cpu", "cpu"]) == "gloo"
    assert mesh_lib.host_devices("cpu", 3) == [torch.device("cpu")] * 3
    one = mesh_lib.make_mesh(1, devices=["cpu"])
    assert (one.dp, one.rank, one.backend) == (1, 0, None)
    assert one.gather_rows(np.arange(3)).tolist() == [0, 1, 2]
    with pytest.raises(RuntimeError, match="process group up"):
        mesh_lib.make_mesh(2, devices=["cpu", "cpu"])


@pytest.mark.parametrize("flags,err,match", [
    (["--batch_size", "3", "--dp", "2"], SystemExit,
     "--batch_size 3 must be a multiple of --dp 2"),
    (["--infer_task", "control", "--dp", "2"], SystemExit,
     "control mode runs per-scene"),
    (["--tar_mode", "recompute", "--dp", "2", "--batch_size", "2"],
     ValueError, "requires tar_mode='temporal_cache'"),
    (["--tar_mode", "recompute", "--launcher", "torch"], ValueError,
     "requires tar_mode='temporal_cache'"),
])
def test_cli_refuses_what_jax_refuses_under_dp(flags, err, match):
    args = evaluate.build_parser().parse_args(["--debug"] + flags)
    with pytest.raises(err, match=match):
        evaluate.check_args(args)


def test_more_ranks_than_devices_are_refused(monkeypatch):
    """`--dp 2` wants two cards (none here; one where the card is
    monkeypatched in), JAX's make_mesh message; an explicit device list
    too, dp·tp ranks under tp; a mesh above one rank wants the process
    group up."""
    with pytest.raises(ValueError, match="need 2 devices, have 0"):
        evaluate.main(["--debug", "--dp", "2", "--batch_size", "2"])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        evaluate.main(["--debug", "--dp", "2", "--batch_size", "2"])
    with pytest.raises(ValueError, match="need 3 devices, have 2"):
        mesh_lib.launch(print, 3, ["cpu", "cpu"])
    with pytest.raises(ValueError, match="need 4 devices, have 2"):
        mesh_lib.launch(print, 2, ["cpu", "cpu"], tp=2)
    with pytest.raises(RuntimeError, match="tp=2 needs the process group"):
        mesh_lib.make_mesh(1, tp=2, devices=["cpu"])


def test_generator_refuses_recompute_and_tp_under_a_mesh():
    """spmd="shard_map" refuses tp and recompute as JAX's does
    (umgen_tpu/models/generate.py:57-66), and a mesh-less shard_map;
    spmd="gspmd", JAX's default, takes both (tests/test_torch_tp.py runs
    it)."""
    cfg = ModelConfig(**dict(KW, tar_mode="recompute")).scaled("tiny")
    one = mesh_lib.make_mesh(1, devices=["cpu"])
    tp2 = dataclasses.replace(one, tp=2)
    with pytest.raises(ValueError, match="requires tar_mode='temporal_cache'"):
        Generator(UMGen(cfg), {}, device="cpu", mesh=one, spmd="shard_map")
    cached = UMGen(dataclasses.replace(cfg, tar_mode="temporal_cache"))
    with pytest.raises(ValueError, match="use tp=1"):
        Generator(cached, {}, device="cpu", mesh=tp2, spmd="shard_map")
    with pytest.raises(ValueError, match="requires a mesh"):
        Generator(cached, {}, device="cpu", spmd="shard_map")
    with pytest.raises(ValueError, match="gspmd|shard_map"):
        Generator(cached, {}, device="cpu", mesh=one, spmd="pmap")
    for model in (UMGen(cfg), cached):
        gen = Generator(model, {}, device="cpu", mesh=tp2)
        assert gen.spmd == "gspmd" and gen.model.tp is tp2
        assert gen.model.heads == cfg.n_head // 2


# teacher-forced in the sampled rollouts over dp: the pose and the image
# segment are sampled (513 decisions a frame, each gathered over the mesh)
FORCED = ("map", "bbox3d")


def test_gspmd_rollout_samples_the_unsharded_noise(pool):
    """spmd="gspmd" over dp = 2, top-k sampling (FORCED teacher-forced),
    B = 4, the prefill frame: every rank samples the whole batch's gathered
    logits with the run's seed and keeps its rows, so its tokens are the
    one-process run's with the same seed, bit for bit
    (tests/test_torch_tp.py holds dp = 2 × tp = 2).  Speculative sampling,
    which draws its own noise, is refused there by name."""
    from umgen_tpu_torch.params import from_jax
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    kw = dict(KW, sample_method="topk")
    jmodel = JUMGen(JModelConfig(**kw).scaled("tiny"))
    params = jax.tree.map(np.asarray,
                          jmodel.init_params(jax.random.PRNGKey(0)))
    scenes = make_token_batch(jmodel.layout, T=W + 1, B=4, seed=6,
                              config=jmodel.config)
    cond = {m: v[:, :W].astype(np.int64) for m, v in scenes.items()}
    forced = {m: scenes[m][:, W:].astype(np.int64) for m in FORCED}
    pool.submit("gspmd_sampled", cfg_kw=kw, params=params, cond=cond,
                window=W, new_frames=1, forced=forced)
    ref = Generator(UMGen(ModelConfig(**kw).scaled("tiny")),
                    from_jax(params), seed=0, device="cpu").generate(
        cond, new_frames=1, cond_frames=W, input_cond_frames=W,
        forced_streams=forced)
    res = pool.collect()
    torch.set_num_threads(n)
    for r in res:
        assert "sample_method='greedy'" in r["refused"], r["refused"]
        for m in ref:
            np.testing.assert_array_equal(r["tokens"][m], ref[m], err_msg=m)


# ---------------------------------------------------------------------------
# JAX's shard_map program itself
# ---------------------------------------------------------------------------
@pytest.mark.slow
def test_dp_rollout_matches_jax_shard_map(pool):
    """The port's two ranks against JAX's `spmd="shard_map"` Generator on
    conftest's virtual devices (dp = 2), B = 2, free-running greedy: the
    streams must agree as JAX's own test holds shard_map against one
    device (tests/test_sharding.py, >= 99.5% of each modality's tokens).
    slow: JAX's shard_map program compiles for minutes on the CPU."""
    from umgen_tpu.parallel.mesh import make_mesh
    jmodel = JUMGen(JModelConfig(**KW).scaled("tiny"))
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    cond = make_token_batch(jmodel.layout, T=W, B=2, seed=4,
                            config=jmodel.config)
    jmesh = make_mesh(dp=2, tp=1)
    with jmesh:
        jout = JGenerator(jmodel, jparams, seed=0, mesh=jmesh,
                          spmd="shard_map").generate(
            cond, new_frames=NEW, cond_frames=W, input_cond_frames=W)
    out = pool.run("generate", cfg_kw=KW,
                   params=jax.tree.map(np.asarray, jparams),
                   cond={m: v.astype(np.int64) for m, v in cond.items()},
                   window=W, new_frames=NEW)[0]
    for m in jout:
        agree = (out[m][:, W:] == np.asarray(jout[m])[:, W:]).mean()
        assert agree >= 0.995, (m, agree)
