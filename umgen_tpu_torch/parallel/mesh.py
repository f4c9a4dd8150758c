"""Data and tensor parallelism over processes (port of
umgen_tpu/parallel/mesh.py).

The JAX package runs one process over a (dp, tp) mesh of devices.  Here a
run is one process per rank, and the mesh is this process's view of the
run: its rank, its card and its process groups.  A run of dp·tp ranks is
laid out as JAX's `devices.reshape(dp, tp)`: rank r is dp index r // tp
and tp index r % tp, so a tp group is tp consecutive ranks and a dp group
the ranks of one tp index, tp apart.

  * `launch(fn, dp, devices, tp=)` starts dp·tp ranks on this host, rank r
    on `devices[r]` (the cards cuda:0 ..., after checking that there are
    enough: "need N devices, have M", as JAX's `make_mesh`).
  * `--launcher torch`: the process is one rank of `torchrun`'s world
    (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT);
    `--launcher mpi`: the same from Open MPI's OMPI_COMM_WORLD_RANK /
    _SIZE / _LOCAL_RANK, the master's address and port from MASTER_ADDR /
    MASTER_PORT (`launcher_env`).  Under a launcher dp·tp must equal the
    world size.

The backend is NCCL on cards and gloo on the CPU.  NCCL refuses two ranks
on one card, so a device list that names a card twice (the tests' and
chip_smoke.py's ranks sharing one card) runs on gloo.  The mesh hands gloo
host copies of the tensors (`_host`): gloo's all_reduce, broadcast and
all_gather also take CUDA tensors on the card machine's build
(chip_smoke.py phase z), but not every build has them.

Data parallelism's collectives run over the dp group: a rank's rows of a
global batch (`shard`), the mean of a tree (`tree_mean`, one flat buffer
per dtype), a sum (`all_sum`: the speculative telemetry, the EMA
codebook's counts) and the rows of every dp rank gathered (`gather_rows`,
`gather_rows_t`).

Tensor parallelism (tp > 1) is JAX's Megatron split, `_spec_for`, with the
port's layouts (`split_rule`): column-parallel `qkv`, `mlp*/fc` and
`cross_attn/[qkv]` (weights, biases and their quantized leaves),
row-parallel `*/proj` weights (their biases and per-column scales stay
whole), vocab-parallel `head_*`, and the rest replicated.  Where the port
differs from GSPMD's contiguous blocks: the fused qkv [d, 3d] is split by
heads (q, k and v each by columns, so a rank holds whole heads of all
three), `tpe_rel` [H, T] by heads, and the quantized leaves (`wq`, `ws`,
`wq4`, `ws4`), which GSPMD keeps whole, like the float leaves they stand
for.  A tree that carries decode packs (`oar_packed`) keeps its OAR stack
whole: the decode kernels run the whole head set on every rank (GSPMD
cannot partition a custom call either).  The blocks reach the group
through `reduce` (the all-reduce after a row-parallel product), `copy`
(before a column-parallel one) and `gather` (a vocab-parallel head's
logits): under autograd Megatron's conjugate pairs, so a replicated
activation's gradient is whole on every rank.
"""

from __future__ import annotations

import dataclasses
import os
import re
import socket
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from umgen_tpu_torch.parallel import optim

# where each launcher puts (rank, world size, local rank)
LAUNCHER_VARS = {
    "torch": ("RANK", "WORLD_SIZE", "LOCAL_RANK"),
    "mpi": ("OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE",
            "OMPI_COMM_WORLD_LOCAL_RANK"),
}


def host_devices(device_type: str, ranks: int = 1) -> List[torch.device]:
    """The devices data parallelism spreads over on this host: every card,
    or for the CPU one entry for each of the `ranks` (the CPU takes any
    number of them)."""
    if device_type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(device_type)] * ranks


def check_devices(n: int, devices: Sequence) -> None:
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")


def backend_for(devices: Sequence) -> str:
    """NCCL where every rank has a card of its own, gloo otherwise."""
    devices = [torch.device(d) for d in devices]
    if all(d.type == "cuda" for d in devices) \
            and len(set(devices)) == len(devices):
        return "nccl"
    return "gloo"


# ---------------------------------------------------------------------------
# tensor-parallel sharding rules
# ---------------------------------------------------------------------------
_COLUMN = re.compile(r"(qkv|mlp\w*/fc|cross_attn/[qkv])/(w|wq|wq4|b|ws|ws4)$")
_ROW = re.compile(r"proj/(w|wq|wq4|ws4)$")
_VOCAB = re.compile(r"head_\w+/(w|wq|wq4|b|ws|ws4)$")


def split_rule(path: str) -> Optional[tuple]:
    """(dim, groups) of the leaf at `path` (a "/"-joined tree path) under
    tensor parallelism, or None where it is replicated.  The leaf's dim
    `dim` is cut into `groups` equal parts and each part into tp blocks;
    a rank keeps its block of every part.  Paths match at their end, so
    the optimizer state's moments (".../mu/tar/sa1/qkv/w") follow their
    params."""
    if _COLUMN.search(path):
        return (-1, 3 if "qkv/" in path else 1)
    if _ROW.search(path):
        return (-2, 1)
    if _VOCAB.search(path):
        return (-1, 1)
    if path == "tpe_rel" or path.endswith("/tpe_rel"):
        return (0, 1)
    return None


def tree_paths(tree, prefix=""):
    """(path, leaf) of every leaf of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_paths(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_paths(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def map_paths(fn: Callable, tree, prefix=""):
    """The tree with every leaf replaced by fn(path, leaf)."""
    if isinstance(tree, dict):
        return {k: map_paths(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_paths(fn, v, f"{prefix}/{i}")
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def _whole_oar(path: str, tree) -> bool:
    """An OAR leaf of a tree with decode packs: kept whole."""
    return (path == "oar" or path.startswith("oar/")) and \
        isinstance(tree, dict) and "oar_packed" in tree


def param_sharding(params, tp: int) -> Dict[str, Optional[tuple]]:
    """{path: split_rule or None} of every leaf of `params` at tp ranks,
    refusing a leaf a split does not divide (JAX's
    `test_param_specs_divide_shapes` demands the same)."""
    out = {}
    for path, leaf in tree_paths(params):
        rule = None if _whole_oar(path, params) else split_rule(path)
        if rule is not None and tp > 1:
            dim, groups = rule
            n = leaf.shape[dim]
            if n % (groups * tp):
                raise ValueError(f"tp={tp} does not divide {path} "
                                 f"{tuple(leaf.shape)} (dim {dim}"
                                 + (f", {groups} parts" if groups > 1
                                    else "") + ")")
        out[path] = rule
    return out


def shard_leaf(t: torch.Tensor, rule, tp: int, index: int) -> torch.Tensor:
    """Block `index` of `tp` of the leaf `t` under `rule` (a copy)."""
    if rule is None or tp == 1:
        return t
    dim, groups = rule
    dim %= t.ndim
    n = t.shape[dim]
    c = n // (groups * tp)
    parts = t.reshape(*t.shape[:dim], groups, tp, c, *t.shape[dim + 1:])
    return parts.select(dim + 1, index).reshape(
        *t.shape[:dim], groups * c, *t.shape[dim + 1:]).clone()


def unshard_leaf(parts: Sequence[torch.Tensor], rule) -> torch.Tensor:
    """The whole leaf from its blocks, in tp order (shard_leaf's
    inverse)."""
    if rule is None or len(parts) == 1:
        return parts[0]
    dim, groups = rule
    t = parts[0]
    dim %= t.ndim
    c = t.shape[dim] // groups
    blocks = [p.reshape(*p.shape[:dim], groups, c, *p.shape[dim + 1:])
              for p in parts]
    whole = torch.stack(blocks, dim=dim + 1)
    return whole.reshape(*t.shape[:dim], groups * len(parts) * c,
                         *t.shape[dim + 1:])


# ---------------------------------------------------------------------------
# Megatron's conjugate collectives
# ---------------------------------------------------------------------------
class _Reduce(torch.autograd.Function):
    """All-reduce over the tp group forward, identity backward (after a
    row-parallel product)."""

    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.tp_sum(x.clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Copy(torch.autograd.Function):
    """Identity forward, all-reduce over the tp group backward (before a
    column-parallel product: each rank's columns give part of the input's
    gradient)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.tp_sum(g.contiguous().clone()), None


class _Gather(torch.autograd.Function):
    """All-gather along the last dim over the tp group forward, this rank's
    block of the gradient backward (a vocab-parallel head's logits)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.n = mesh, x.shape[-1]
        return mesh.tp_gather_last(x)

    @staticmethod
    def backward(ctx, g):
        i = ctx.mesh.tp_rank
        return g[..., i * ctx.n:(i + 1) * ctx.n], None


def _grad_on(t: torch.Tensor) -> bool:
    return t.requires_grad and torch.is_grad_enabled()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a (dp, tp) run."""
    dp: int
    rank: int
    device: torch.device
    backend: Optional[str]       # None: one process, no process group
    tp: int = 1
    dp_group: Any = None         # this rank's dp peers (None: the world)
    tp_group: Any = None         # this rank's tp peers

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.dp, "tp": self.tp}

    @property
    def dp_rank(self) -> int:
        return self.rank // self.tp

    @property
    def tp_rank(self) -> int:
        return self.rank % self.tp

    @property
    def comm_device(self) -> torch.device:
        """Where a collective's tensors live: the card under NCCL, the
        host under gloo."""
        return self.device if self.backend == "nccl" else torch.device("cpu")

    def rows(self, n: int) -> slice:
        """This rank's contiguous rows of a global batch of `n`."""
        if n % self.dp:
            raise ValueError(f"batch {n} must divide dp={self.dp}")
        per = n // self.dp
        return slice(self.dp_rank * per, (self.dp_rank + 1) * per)

    def shard(self, x):
        """This rank's rows of `x` (numpy array or tensor)."""
        return x[self.rows(x.shape[0])]

    def _host(self, t: torch.Tensor, op: Callable[[torch.Tensor], Any]
              ) -> torch.Tensor:
        """Run the collective `op` on `t` in place, through a copy on
        the communication device where `t` lies elsewhere."""
        if t.device == self.comm_device:
            op(t)
            return t
        c = t.to(self.comm_device)
        op(c)
        t.copy_(c)
        return t

    def _gather(self, t: torch.Tensor, n: int, group, dim: int
                ) -> torch.Tensor:
        """Every rank's `t` of the group (n ranks), concatenated along
        `dim` in rank order, on t's device."""
        c = t.detach().to(self.comm_device).contiguous()
        parts = [torch.empty_like(c) for _ in range(n)]
        dist.all_gather(parts, c, group=group)
        return torch.cat(parts, dim=dim).to(t.device)

    # -- data parallelism: the dp group ----------------------------------
    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over the dp ranks, in place; returns it."""
        if self.dp == 1:
            return t
        return self._host(t, lambda c: dist.all_reduce(c,
                                                       group=self.dp_group))

    def tree_mean(self, tree):
        """The mean over the dp ranks of every leaf of `tree`, in place:
        the leaves of each dtype go through one flat buffer and one
        all-reduce."""
        if self.dp == 1:
            return tree
        groups: Dict[torch.dtype, List[torch.Tensor]] = {}
        for t in optim.tree_leaves(tree):
            groups.setdefault(t.dtype, []).append(t)
        for leaves in groups.values():
            flat = torch.cat([t.reshape(-1) for t in leaves])
            self.all_sum(flat)
            flat.div_(self.dp)
            i = 0
            for t in leaves:
                t.copy_(flat[i:i + t.numel()].view_as(t))
                i += t.numel()
        return tree

    def gather_rows_t(self, t: torch.Tensor) -> torch.Tensor:
        """Every dp rank's rows of a tensor (the same shape on each),
        concatenated in rank order."""
        if self.dp == 1:
            return t
        return self._gather(t, self.dp, self.dp_group, 0)

    def gather_rows(self, a: np.ndarray) -> np.ndarray:
        """`gather_rows_t` of a host array."""
        if self.dp == 1:
            return a
        return self.gather_rows_t(
            torch.from_numpy(np.ascontiguousarray(a))).numpy()

    def broadcast(self, a: np.ndarray) -> np.ndarray:
        """Rank 0's host array, on every rank."""
        if self.backend is None:       # one process, no group
            return a
        t = torch.from_numpy(np.ascontiguousarray(a)).to(self.comm_device)
        dist.broadcast(t, 0)
        return t.cpu().numpy()

    # -- tensor parallelism: the tp group --------------------------------
    def tp_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over the tp ranks, in place; returns it."""
        if self.tp == 1:
            return t
        return self._host(t, lambda c: dist.all_reduce(c,
                                                       group=self.tp_group))

    def tp_gather_last(self, t: torch.Tensor) -> torch.Tensor:
        """Every tp rank's `t` concatenated along the last dim."""
        if self.tp == 1:
            return t
        return self._gather(t, self.tp, self.tp_group, t.ndim - 1)

    def reduce(self, t: torch.Tensor) -> torch.Tensor:
        """A row-parallel product's partial sums, summed over tp."""
        if self.tp == 1:
            return t
        if _grad_on(t):
            return _Reduce.apply(t, self)
        return self.tp_sum(t)

    def copy(self, t: torch.Tensor) -> torch.Tensor:
        """A column-parallel product's input (its gradient summed over tp
        in the backward pass)."""
        if self.tp == 1 or not _grad_on(t):
            return t
        return _Copy.apply(t, self)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """A vocab-parallel head's logits, gathered over tp."""
        if self.tp == 1:
            return t
        if _grad_on(t):
            return _Gather.apply(t, self)
        return self.tp_gather_last(t)

    # -- trees --------------------------------------------------------------
    def shard_params(self, params):
        """This rank's blocks of a whole tree (params, or a TrainState's
        trees: each path under its rule)."""
        if self.tp == 1:
            return params
        rules = param_sharding(params, self.tp)
        return map_paths(lambda p, t: shard_leaf(t, rules[p], self.tp,
                                                 self.tp_rank), params)

    def unshard_params(self, params):
        """The whole tree from every tp rank's blocks (a collective: every
        rank of the group calls it and gets the whole tree)."""
        if self.tp == 1:
            return params

        def whole(path, t):
            rule = None if _whole_oar(path, params) else split_rule(path)
            if rule is None:
                return t
            dim = rule[0] % t.ndim
            parts = list(self._gather(t, self.tp, self.tp_group, dim
                                      ).chunk(self.tp, dim=dim))
            return unshard_leaf(parts, rule)

        return map_paths(whole, params)

    def global_norm(self, tree) -> torch.Tensor:
        """optax.global_norm of the whole tree this rank holds blocks of:
        each split leaf's squares summed over tp, each replicated leaf
        counted once (each leaf's sum in its dtype)."""
        if self.tp == 1:
            return optim.global_norm(tree)
        split, whole = 0, 0
        for path, leaf in tree_paths(tree):
            s = leaf.square().sum()
            if split_rule(path) is None:
                whole = whole + s
            else:
                split = split + s
        if not isinstance(split, torch.Tensor):
            return torch.sqrt(whole)
        split = self.tp_sum(split.float().reshape(1))[0]
        return torch.sqrt(whole + split)


def make_mesh(dp: int = 1, tp: int = 1, devices=None,
              local_rank: Optional[int] = None) -> Mesh:
    """This process's mesh of a run of dp·tp ranks.  Above one rank the
    process group must be up (`launch`, or `init` under a launcher) and
    hold dp·tp ranks; every rank creates the dp and tp groups together.
    `devices`: the host's devices, one a local rank (default: every card,
    or the CPU); a list that names one card twice puts two ranks on it.
    `local_rank`: this process's index into `devices` (default: its
    rank)."""
    if dp < 1 or tp < 1:
        raise ValueError(f"dp={dp}, tp={tp}: at least 1 each")
    devices = [torch.device(d) for d in (devices if devices is not None
                                         else host_devices("cuda"))]
    n = dp * tp
    if n == 1 and not dist.is_initialized():
        check_devices(1, devices)
        return Mesh(1, 0, devices[0], None)
    if not dist.is_initialized():
        raise RuntimeError(f"dp={dp}, tp={tp} needs the process group up: "
                           "start the ranks with parallel.mesh.launch, or "
                           "under a launcher call parallel.mesh.init first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != n:
        raise ValueError(f"dp={dp} x tp={tp}, but the run has {world} "
                         "ranks: under a launcher --dp x --tp must equal "
                         "the world size")
    local = rank if local_rank is None else local_rank
    check_devices(local + 1 if local_rank is not None else n, devices)
    dp_group = tp_group = None
    if tp > 1:
        # every rank creates every group, in the same order
        for i in range(dp):
            g = dist.new_group([i * tp + j for j in range(tp)])
            if rank // tp == i:
                tp_group = g
        if dp > 1:
            for j in range(tp):
                g = dist.new_group([i * tp + j for i in range(dp)])
                if rank % tp == j:
                    dp_group = g
    return Mesh(dp, rank, devices[local], dist.get_backend(), tp,
                dp_group, tp_group)


def launcher_env(launcher: str, environ=None) -> Dict[str, Any]:
    """(rank, world, local_rank, addr, port) of this process under
    `torchrun` (`launcher="torch"`) or Open MPI's `mpirun` ("mpi"), read
    from the environment `environ` (default os.environ)."""
    env = os.environ if environ is None else environ
    if launcher not in LAUNCHER_VARS:
        raise ValueError(f"unknown launcher {launcher!r}: torch or mpi")
    names = LAUNCHER_VARS[launcher] + ("MASTER_ADDR", "MASTER_PORT")
    missing = [n for n in names if n not in env]
    if missing:
        raise ValueError(f"--launcher {launcher} reads {', '.join(names)} "
                         f"from the environment; {', '.join(missing)} "
                         "not set")
    rank, world, local = (int(env[n]) for n in LAUNCHER_VARS[launcher])
    return {"rank": rank, "world": world, "local_rank": local,
            "addr": env["MASTER_ADDR"], "port": int(env["MASTER_PORT"])}


def init(rank: int, world: int, addr: str, port: int, backend: str) -> None:
    """Join the process group of `world` ranks at tcp://addr:port."""
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}",
                            world_size=world, rank=rank)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_entry(rank: int, fn, dp: int, tp: int, port: int, backend: str,
                devices, args) -> None:
    init(rank, dp * tp, "localhost", port, backend)
    try:
        device = torch.device(devices[rank])
        if device.type == "cuda":
            torch.cuda.set_device(device)
        else:       # the ranks share the host's cores
            torch.set_num_threads(max(1, torch.get_num_threads()
                                      // (dp * tp)))
        fn(make_mesh(dp, tp, devices=devices), *args)
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, dp: int, devices: Sequence, *args, tp: int = 1
           ) -> None:
    """Run `fn(mesh, *args)` in dp·tp new processes, rank r on
    `devices[r]`, over a process group on a free localhost port (NCCL on
    distinct cards, gloo otherwise).  `fn` must be importable (a module's
    function).  Returns when every rank has; a rank that fails ends the
    others and raises here."""
    n = dp * tp
    devices = [str(torch.device(d)) for d in devices]
    check_devices(n, devices)
    devices = devices[:n]
    torch.multiprocessing.start_processes(
        _rank_entry, args=(fn, dp, tp, free_port(), backend_for(devices),
                           devices, args),
        nprocs=n, start_method="spawn")
