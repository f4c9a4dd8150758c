"""Rank processes for the port's data- and tensor-parallel tests
(tests/test_torch_dp.py, tests/test_torch_dp_train.py,
tests/test_torch_dp_cli.py, tests/test_torch_tp.py,
tests/test_torch_tp_train.py).

`Pool(world, tp)` starts `world` processes with `torch.multiprocessing`
(spawn), each one rank of a gloo process group on a free localhost port
with its parallel.mesh.Mesh on the CPU (dp = world / tp), and runs tasks —
the functions of this module, by name — in every rank at once; each
returns what its rank returns, or raises with a rank's traceback.  A file
keeps one pool for all its cases.  This module imports neither JAX nor the
JAX package: the ranks run the port alone, as a user's `--dp` / `--tp`
ranks do.

The rollout tasks replay the JAX package's greedy decisions (as tests/
test_torch_slice.py's `_Replay` does) on the rank's rows and hold the
port's logits at every decision (`check_replayed`), and run the port's
one-process Generator on the rank's own shard beside the data-parallel
one: same logits and tokens, bit for bit.
"""

import datetime
import os
import sys
import tempfile
import traceback

import numpy as np
import torch
import torch.distributed as dist

# the test's CPU cores are shared with the suite's other workers
THREADS = 2
TIMEOUT_S = 600


class Pool:
    def __init__(self, world: int = 2, tp: int = 1):
        from umgen_tpu_torch.parallel.mesh import free_port
        ctx = torch.multiprocessing.get_context("spawn")
        self.world = world
        self.tasks = [ctx.Queue() for _ in range(world)]
        self.results = ctx.Queue()
        port = free_port()
        self.procs = [ctx.Process(target=_serve, daemon=True, args=(
            r, world, tp, port, self.tasks[r], self.results))
            for r in range(world)]
        for p in self.procs:
            p.start()

    def submit(self, task: str, **kw) -> None:
        for q in self.tasks:
            q.put((task, kw))

    def collect(self) -> list:
        """Every rank's result of the task submitted last, in rank
        order."""
        out = {}
        for _ in range(self.world):
            rank, ok, res = self.results.get(timeout=TIMEOUT_S)
            if not ok:
                raise AssertionError(f"rank {rank} failed:\n{res}")
            out[rank] = res
        return [out[r] for r in range(self.world)]

    def run(self, task: str, **kw) -> list:
        self.submit(task, **kw)
        return self.collect()

    def close(self) -> None:
        for q in self.tasks:
            q.put(None)
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()


def _serve(rank, world, tp, port, tasks, results):
    torch.set_num_threads(THREADS)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    from umgen_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(world // tp, tp, devices=["cpu"] * world)
    try:
        while True:
            item = tasks.get()
            if item is None:
                return
            task, kw = item
            try:
                res = globals()[task](mesh, **kw)
                results.put((rank, True, res))
            except Exception:       # noqa: BLE001 — reported to the test
                results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the mesh's collectives
# ---------------------------------------------------------------------------
def collectives(mesh):
    """A rank's rows, the tree mean (two dtypes), a sum, the gathered
    rows and rank 0's broadcast."""
    r = mesh.rank
    tree = {"a": torch.full((2, 3), float(r + 1)),
            "b": [torch.arange(4, dtype=torch.float64) * (r + 1),
                  torch.tensor(float(10 * r), dtype=torch.bfloat16)]}
    mesh.tree_mean(tree)
    s = mesh.all_sum(torch.tensor([r, 1]))
    return {"rows": mesh.rows(6), "shard": mesh.shard(np.arange(6)),
            "tree": {"a": tree["a"].numpy(), "b0": tree["b"][0].numpy(),
                     "b1": float(tree["b"][1])},
            "sum": s.tolist(),
            "gather": mesh.gather_rows(np.full((1, 2), r)),
            "broadcast": mesh.broadcast(np.array([r, 7]))}


# ---------------------------------------------------------------------------
# the rollout
# ---------------------------------------------------------------------------
def _tie_bound(top1, ulps):
    return ulps * 2.0 ** -8 * np.maximum(np.abs(top1), 1e-3)


def check_replayed(calls, seen, ulps):
    """tests/test_torch_slice.py's `_check_decisions` without JAX: at every
    replayed decision (JAX's token, JAX's top-2 logits) the port's argmax
    is JAX's token where JAX's top-2 gap is above `ulps` bf16 ulps, else
    the port's logit for it within that bound of its maximum; and that
    logit within `ulps` bf16 ulps of JAX's.  Returns the largest drift in
    those ulps."""
    assert len(calls) == len(seen), (len(calls), len(seen))
    worst = 0.0
    for i, ((tok, top2), port) in enumerate(zip(calls, seen)):
        port = port.numpy()
        pmax = port.max(-1)
        ptok = np.take_along_axis(port, tok[..., None], -1)[..., 0]
        gap = top2[..., 0] - top2[..., 1]
        bound = _tie_bound(top2[..., 0], ulps)
        ok = np.where(gap > bound, port.argmax(-1) == tok,
                      pmax - ptok <= bound)
        assert ok.all(), (f"decision {i}: JAX chose {tok}, gap {gap}; the "
                          f"port's argmax {port.argmax(-1)}")
        drift = np.abs(ptok - top2[..., 0])
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(top2[..., 0]),
                                                  2.0 ** -3))) - 7)
        assert (drift <= ulps * ulp).all(), (f"decision {i}: logit "
                                             f"{ptok}, JAX's {top2[..., 0]}")
        worst = max(worst, float((drift / ulp).max()))
    return worst


class _Replay:
    """The port's samplers return the recorded decisions of the rows and
    keep the port's own logits."""

    def __init__(self, ro, calls):
        self.calls, self.i, self.seen = calls, 0, []
        for mod in list(ro._samplers):
            ro._samplers[mod] = self.sample

    def sample(self, generator, logits):
        tok, _ = self.calls[self.i]
        self.i += 1
        self.seen.append(logits.float())
        return torch.tensor(tok, dtype=torch.long)


def _model(cfg_kw):
    from umgen_tpu_torch.config import ModelConfig
    from umgen_tpu_torch.models.umgen import UMGen
    return UMGen(ModelConfig(**cfg_kw).scaled("tiny"))


def rollout(mesh, cfg_kw, params, scenes, window, new_frames,
            init_token_mod=(), calls=None, ulps=None):
    """The data-parallel rollout of `scenes` ({mod: [B, T, len]}, the
    conditioning window and its continuation) through SceneRunner.
    run_scenes with pad_to = dp, JAX's decisions `calls` (recorded on the
    unpadded batch) replayed where given; then this rank's shard through
    the one-process Generator.  Returns rank 0's scenes' tokens, each
    rank's telemetry and the largest replayed drift."""
    import pickle

    from umgen_tpu_torch.config import InferConfig
    from umgen_tpu_torch.models.generate import Generator
    from umgen_tpu_torch.params import from_jax
    from umgen_tpu_torch.tools.harness import SceneRunner

    model = _model(cfg_kw)
    tparams = from_jax(params)
    B = scenes["pose"].shape[0]
    batches = [{"file_name": f"scene_{i}.pkl",
                **{m: v[i] for m, v in scenes.items()}} for i in range(B)]
    n_pad = (-B) % mesh.dp
    padded = {m: np.concatenate([v] + [v[-1:]] * n_pad)
              for m, v in scenes.items()}
    rows = mesh.rows(B + n_pad)
    mine = None
    if calls is not None:       # the rows of the padded batch this rank has
        mine = [tuple(np.concatenate([a] + [a[-1:]] * n_pad)[rows]
                      for a in c) for c in calls]
    infer = InferConfig(num_new_frames=new_frames, cond_frames=window,
                        input_cond_frames=window)
    gen = Generator(model, tparams, seed=0, device="cpu", mesh=mesh,
                    spmd="shard_map")
    rep = _Replay(gen.rollout, mine) if mine is not None else None
    res = {"spec": (gen.spec_chunks, gen.spec_accepted)}
    with tempfile.TemporaryDirectory() as d:
        runner = SceneRunner(gen, infer, output_path=d, save_video=False,
                             init_token_mod=init_token_mod)
        runner.run_scenes(batches, pad_to=mesh.dp)
        res["spec"] = (gen.spec_chunks, gen.spec_accepted)
        res["timings"] = [(t["scenes"], len(t["frame_seconds"]))
                          for t in runner.timings]
        if mesh.rank == 0:
            tok_dir = os.path.join(d, "saved_token")
            res["files"] = sorted(os.listdir(tok_dir))
            res["tokens"] = []
            for i in range(B):
                with open(os.path.join(tok_dir, f"scene_{i}_tokens.pkl"),
                          "rb") as f:
                    res["tokens"].append(pickle.load(f))
            res["collision"] = runner.box_overlap.average()
            res["mmd"] = runner.mmd.average()
        else:
            res["files"] = sorted(os.listdir(d))
    if rep is not None:
        res["drift"] = check_replayed(mine, rep.seen, ulps)
    # this rank's shard, one process: the same logits and tokens
    gen1 = Generator(model, tparams, seed=0, device="cpu")
    rep1 = _Replay(gen1.rollout, mine) if mine is not None else None
    shard = {m: v[rows] for m, v in padded.items()}
    forced = {m: shard[m][:, window:window + new_frames]
              for m in init_token_mod} or None
    out1 = gen1.generate({m: v[:, :window] for m, v in shard.items()},
                         new_frames=new_frames, cond_frames=window,
                         input_cond_frames=window, forced_streams=forced)
    if rep is not None:
        assert len(rep.seen) == len(rep1.seen)
        for a, b in zip(rep.seen, rep1.seen):
            assert torch.equal(a, b), "a replayed decision's logits differ"
    res["shard"] = out1
    res["spec1"] = (gen1.spec_chunks, gen1.spec_accepted)
    return res


def generate(mesh, cfg_kw, params, cond, window, new_frames):
    """`Generator.generate` under the mesh, free-running (greedy): the whole
    batch's tokens (rank 0's)."""
    from umgen_tpu_torch.models.generate import Generator
    from umgen_tpu_torch.params import from_jax
    gen = Generator(_model(cfg_kw), from_jax(params), seed=0, device="cpu",
                    mesh=mesh, spmd="shard_map")
    out = gen.generate(cond, new_frames=new_frames, cond_frames=window,
                       input_cond_frames=window)
    return out if mesh.rank == 0 else None


# ---------------------------------------------------------------------------
# tensor parallelism (spmd="gspmd")
# ---------------------------------------------------------------------------
def _decisions(calls, seen):
    """Each replayed decision's port logit for JAX's token, the port's
    maximum and argmax (rows of the rank), concatenated over decisions."""
    ptok, pmax, parg = [], [], []
    for (tok, _), port in zip(calls, seen):
        port = port.numpy()
        ptok.append(np.take_along_axis(port, tok[..., None], -1)[..., 0]
                    .reshape(-1))
        pmax.append(port.max(-1).reshape(-1))
        parg.append(port.argmax(-1).reshape(-1))
    return {k: np.concatenate(v) for k, v in
            (("ptok", ptok), ("pmax", pmax), ("parg", parg))}


def _mine(mesh, calls):
    """The rows of every recorded decision this rank's dp index holds."""
    return [tuple(mesh.shard(a) for a in c) for c in calls]


def tp_frame(mesh, cfg_kw, params, inputs, calls):
    """One recompute frame (`Rollout.frame_step`) on the mesh from the
    rank's blocks of `params`, JAX's decisions `calls` replayed on the
    rank's rows; returns the decisions' readings and the tokens."""
    from umgen_tpu_torch.models.rollout import Rollout
    from umgen_tpu_torch.params import from_jax
    ro = Rollout(_model(cfg_kw).on_mesh(mesh))
    mine = _mine(mesh, calls)
    rep = _Replay(ro, mine)
    out = ro.frame_step(mesh.shard_params(from_jax(params)),
                        {m: torch.as_tensor(mesh.shard(v))
                         for m, v in inputs.items()}, None)
    assert rep.i == len(mine), (rep.i, len(mine))
    return {"tokens": out.tokens.numpy(), **_decisions(mine, rep.seen)}


def tp_rollout(mesh, cfg_kw, params, cond, window, new_frames, calls=None,
               oar_packed=False):
    """`Generator.generate` in spmd="gspmd" on the mesh from the rank's
    blocks of `params` (with `oar_packed`, int8 decode packs whose OAR
    stack stays whole), JAX's decisions replayed where given; every rank
    returns the whole batch's tokens and the OAR heads it ran."""
    from umgen_tpu_torch.models.generate import Generator
    from umgen_tpu_torch.params import from_jax
    tparams = from_jax(params)
    if oar_packed:
        from umgen_tpu_torch.runtime.quantize import (pack_fused,
                                                      quantize_params_int8)
        tparams = pack_fused(quantize_params_int8(tparams))
    gen = Generator(_model(cfg_kw), mesh.shard_params(tparams), seed=0,
                    device="cpu", mesh=mesh)
    res = {}
    if calls is not None:
        mine = _mine(mesh, calls)
        rep = _Replay(gen.rollout, mine)
    out = gen.generate(cond, new_frames=new_frames, cond_frames=window,
                       input_cond_frames=window)
    if calls is not None:
        assert rep.i == len(mine), (rep.i, len(mine))
        res.update(_decisions(mine, rep.seen))
    res["tokens"] = out
    res["oar_heads"] = gen.rollout.oar_heads(gen.params)
    return res


def gspmd_sampled(mesh, cfg_kw, params, cond, window, new_frames, forced):
    """`Generator.generate` in spmd="gspmd" with the config's sampler over
    the (dp, tp) mesh from the rank's blocks of `params`, the `forced`
    streams teacher-forced; returns the whole batch's tokens and the
    refusal of speculative sampling over dp."""
    import dataclasses
    from umgen_tpu_torch.models.generate import Generator
    from umgen_tpu_torch.params import from_jax
    model = _model(cfg_kw)
    gen = Generator(model, mesh.shard_params(from_jax(params)), seed=0,
                    device="cpu", mesh=mesh)
    out = gen.generate(cond, new_frames=new_frames, cond_frames=window,
                       input_cond_frames=window, forced_streams=forced)
    try:
        Generator(type(model)(dataclasses.replace(
            model.config, speculative_k=4)), gen.params, device="cpu",
            mesh=mesh)
        refused = None
    except ValueError as e:
        refused = str(e)
    return {"tokens": out, "refused": refused}


def tp_v1(mesh, cfg_kw, params, pushes):
    """The v1 case under tp (`fused_oar_kernel`, int8 OAR weights without
    packs, a bfloat16 OAR cache): a Rollout on the rank's split OAR refuses
    a Q = 1 push by name; the gspmd Generator gathers the OAR whole and
    sends each Q = 1 push of `pushes` [n, B, 1, D] to v1 (the plain
    version here, its calls counted); returns its heads, the calls and the
    pushes' outputs beside the one-process Rollout's on the whole
    params."""
    from umgen_tpu_torch.models.generate import Generator
    from umgen_tpu_torch.models.rollout import Rollout
    from umgen_tpu_torch.ops import decode_kernel as dk
    from umgen_tpu_torch.params import from_jax
    from umgen_tpu_torch.runtime.quantize import quantize_params_int8
    whole = quantize_params_int8(from_jax(params))
    split = mesh.shard_params(whole)
    model = _model(cfg_kw)
    ro = Rollout(model.on_mesh(mesh))
    B = pushes.shape[1]
    refused = None
    try:
        ro.oar_step(split, torch.as_tensor(pushes[0]),
                    *ro.init_kv(B, n_head=ro.oar_heads(split)), 0)
    except ValueError as e:
        refused = str(e)
    gen = Generator(model, split, seed=0, device="cpu", mesh=mesh)
    calls = []
    v1 = dk.fused_decode_step

    def counted(*a, **kw):
        calls.append(kw.get("n_head"))
        return v1(*a, **kw)

    dk.fused_decode_step = counted
    try:
        outs = {}
        for name, r, p in (("tp", gen.rollout, gen.params),
                           ("one", Rollout(model), whole)):
            kv = r.init_kv(B, n_head=r.oar_heads(p))
            outs[name] = [r.oar_step(p, torch.as_tensor(x), *kv, i)[0]
                          .float().numpy() for i, x in enumerate(pushes)]
    finally:
        dk.fused_decode_step = v1
    return {"refused": refused, "split_heads": ro.oar_heads(split),
            "oar_heads": gen.rollout.oar_heads(gen.params), "calls": calls,
            **outs}


def _shapes(tree):
    from umgen_tpu_torch.parallel.mesh import tree_paths
    return {p: tuple(t.shape) for p, t in tree_paths(tree)}


def tp_train_step(mesh, cfg_kw, trainer_kw, params, batch):
    """One step of UMGenTrainer over the (dp, tp) mesh on the global
    `batch` from the rank's blocks of the state: the whole params and
    moments after it (gathered over tp), the metrics, and the rank's own
    replicated leaves."""
    from umgen_tpu_torch.params import from_jax
    from umgen_tpu_torch.parallel.mesh import split_rule, tree_paths
    from umgen_tpu_torch.parallel.train import (UMGenTrainer, shard_state,
                                                whole_state)
    tt = UMGenTrainer(_model(cfg_kw), mesh=mesh, **trainer_kw)
    tb = {k: torch.as_tensor(v, dtype=torch.long) for k, v in batch.items()}
    state = shard_state(mesh, tt.init_state(from_jax(params)))
    shapes = _shapes(state.params)
    state, m = tt.jit_train_step(mesh)(state, tb)
    local = {p: t.detach().numpy().copy()
             for p, t in tree_paths({"params": state.params,
                                     "opt": state.opt_state})
             if split_rule(p) is None}
    res = _train_result(whole_state(mesh, state), m)
    res.update(local=local, shapes=shapes)
    return res


# ---------------------------------------------------------------------------
# the CLI's ranks
# ---------------------------------------------------------------------------
FOREIGN = ("jax", "jaxlib", "umgen_tpu", "optax", "orbax")


def train_rank_alone(mesh, args):
    """tools/train.py's rank — the rank `--dp` / `--tp` starts — then this
    rank's sys.modules must hold neither JAX nor the JAX package."""
    from umgen_tpu_torch.tools import train
    train.train(args, mesh)
    foreign = sorted(m for m in sys.modules if m.split(".")[0] in FOREIGN)
    assert not foreign, (mesh.rank, foreign[:5])
    print(f"RANK_{mesh.rank}_STANDS_ALONE_OK", flush=True)


def cli_rank(mesh, args):
    """evaluate.rank_main — the rank `--dp` starts — then this rank's
    sys.modules must hold neither JAX nor the JAX package."""
    from umgen_tpu_torch.tools import evaluate
    evaluate.rank_main(mesh, args)
    foreign = sorted(m for m in sys.modules if m.split(".")[0] in FOREIGN)
    assert not foreign, (mesh.rank, foreign[:5])
    print(f"RANK_{mesh.rank}_STANDS_ALONE_OK", flush=True)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
def _numpy_tree(tree):
    from umgen_tpu_torch.parallel import optim
    return optim.tree_map(lambda t: t.detach().float().numpy().copy(), tree)


def _train_result(state, metrics):
    return {"params": _numpy_tree(state.params),
            "mu": _numpy_tree(state.opt_state[1][0]["mu"]),
            "nu": _numpy_tree(state.opt_state[1][0]["nu"]),
            "metrics": {k: float(v) for k, v in metrics.items()}}


def train_step(mesh, cfg_kw, trainer_kw, params, batch):
    """One data-parallel step of UMGenTrainer on the global `batch`; rank 0
    also steps the one-process trainer on the whole batch."""
    from umgen_tpu_torch.params import from_jax
    from umgen_tpu_torch.parallel.train import UMGenTrainer
    tt = UMGenTrainer(_model(cfg_kw), **trainer_kw)
    tb = {k: torch.as_tensor(v, dtype=torch.long) for k, v in batch.items()}
    state, m = tt.jit_train_step(mesh)(tt.init_state(from_jax(params)), tb)
    res = {"dp": _train_result(state, m)}
    if mesh.rank == 0:
        state, m = tt.train_step(tt.init_state(from_jax(params)), tb)
        res["one"] = _train_result(state, m)
    return res


def train_cli(mesh, argv):
    """tools/train.py's rank (`train(args, mesh)`) on `argv`: the final
    params and Adam moments (the rank's blocks; under tp also the whole
    params and first moments)."""
    from umgen_tpu_torch.tools import train as train_cli_mod
    state = train_cli_mod.train(train_cli_mod.build_parser().parse_args(
        argv), mesh)
    res = {"params": _numpy_tree(state.params),
           "opt": _numpy_tree(state.opt_state[1][0]),
           "step": int(state.step)}
    if mesh.tp > 1:             # the whole state, gathered over tp
        from umgen_tpu_torch.parallel.train import whole_state
        whole = whole_state(mesh, state)
        res.update(whole=_numpy_tree(whole.params),
                   whole_mu=_numpy_tree(whole.opt_state[1][0]["mu"]))
    return res


def vq_step(mesh, argv, init, x, kmeans_idx):
    """One data-parallel step of tools/train_vq.py's VQTrainer from the
    tree `init` on the global rasters `x`, k-means from the initial means
    at `kmeans_idx` (JAX's draw)."""
    from umgen_tpu_torch.models import quantize as tq
    from umgen_tpu_torch.params import from_jax
    from umgen_tpu_torch.tools import train_vq

    kmeans = tq.kmeans_cosine

    def from_idx(generator, data, n_codes, iters=10):
        return kmeans(None, data, n_codes, iters,
                      means=tq.l2norm(data)[torch.as_tensor(kmeans_idx)])

    def step(mesh):
        args = train_vq.build_parser().parse_args(argv)
        trainer = train_vq.VQTrainer(train_vq.vq_config(args),
                                     from_jax(init), args.lr,
                                     kmeans=args.kmeans, mesh=mesh)
        m = trainer.step(torch.as_tensor(x))
        return {"params": _numpy_tree(trainer.inference_params()),
                "opt": _numpy_tree(trainer.opt_state),
                "cluster_size": trainer.ema.cluster_size.numpy(),
                "metrics": {k: float(v) for k, v in m.items()}}

    tq.kmeans_cosine = from_idx
    try:
        res = {"dp": step(mesh)}
        if mesh.rank == 0:          # the one-process step on the batch
            res["one"] = step(None)
    finally:
        tq.kmeans_cosine = kmeans
    return res


def vq_cli(mesh, argv):
    """tools/train_vq.py's rank (`train(args, cfg, mesh)`): the trained
    tree and the EMA state."""
    from umgen_tpu_torch.tools import train_vq
    args = train_vq.build_parser().parse_args(argv)
    trainer = train_vq.train(args, train_vq.vq_config(args), mesh)
    return {"params": _numpy_tree(trainer.inference_params()),
            "cluster_size": trainer.ema.cluster_size.numpy()}


def ema_quantize(mesh, embedding, cluster_size, z):
    """norm_ema_quantize on this rank's rows of `z` with the group, and on
    rank 0 the one-process call on the whole batch."""
    from umgen_tpu_torch.models import quantize as tq
    state = tq.EMAState(torch.as_tensor(embedding),
                        torch.as_tensor(cluster_size), torch.tensor(True))

    def run(zz, axis):
        zq, loss, idx, new = tq.norm_ema_quantize(
            state, torch.as_tensor(zz), train=True, axis_name=axis)
        return {"zq": zq.numpy(), "loss": float(loss), "idx": idx.numpy(),
                "embedding": new.embedding.numpy(),
                "cluster_size": new.cluster_size.numpy()}

    res = {"dp": run(mesh.shard(z), mesh)}
    if mesh.rank == 0:
        res["one"] = run(z, None)
    return res
