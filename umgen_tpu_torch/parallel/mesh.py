"""Data parallelism over processes (port of umgen_tpu/parallel/mesh.py,
its data-parallel half).

The JAX package runs one process over a (dp, tp) mesh of devices.  Here a
data-parallel run is one process per card, and the mesh is this process's
view of the run: its rank, its card and its process group.

  * `--dp N` alone: `launch` starts N ranks on this host, rank r on
    `devices[r]` (the cards cuda:0 ... N-1), after checking that there are
    N devices ("need N devices, have M", as JAX's `make_mesh`).
  * `--launcher torch`: the process is one rank of `torchrun`'s world
    (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT);
    `--launcher mpi`: the same from Open MPI's OMPI_COMM_WORLD_RANK /
    _SIZE / _LOCAL_RANK, the master's address and port from MASTER_ADDR /
    MASTER_PORT (`launcher_env`).  Under a launcher `--dp` must equal the
    world size.

The backend is NCCL on cards and gloo on the CPU.  NCCL refuses two ranks
on one card, so a device list that names a card twice (the tests' and
chip_smoke.py's two ranks sharing one card) runs on gloo.  The mesh
hands gloo host copies of the tensors (`_host`): gloo's all_reduce,
broadcast and all_gather also take CUDA tensors on the card machine's
build (chip_smoke.py phase z), but not every build has them.

The collectives the data-parallel paths share are the mesh's methods: a
rank's rows of a global batch (`shard`), the mean of a tree over ranks
(`tree_mean`, one flat buffer per dtype), a sum (`all_sum`: the
speculative telemetry, the EMA codebook's counts), and the rows of every
rank gathered (`gather_rows`: a rollout's host-side tokens).

Tensor parallelism (JAX's `_spec_for` / `param_sharding`, tp > 1) is not
ported: `make_mesh(tp > 1)` raises NotPortedError naming its ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import os
import socket
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from umgen_tpu_torch.models.umgen import NotPortedError
from umgen_tpu_torch.parallel import optim

TP_ITEM = "Tensor parallel and the remaining configuration"

# where each launcher puts (rank, world size, local rank)
LAUNCHER_VARS = {
    "torch": ("RANK", "WORLD_SIZE", "LOCAL_RANK"),
    "mpi": ("OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE",
            "OMPI_COMM_WORLD_LOCAL_RANK"),
}


def refuse_tp(tp: int) -> None:
    if tp != 1:
        raise NotPortedError(
            f"tp={tp}: tensor parallelism is not ported yet (ROADMAP.md: "
            f"{TP_ITEM!r})")


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


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a data-parallel run."""
    dp: int
    rank: int
    device: torch.device
    backend: Optional[str]       # None: one process, no process group
    tp: int = 1

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.dp, "tp": self.tp}

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
        return slice(self.rank * per, (self.rank + 1) * per)

    def shard(self, x):
        """This rank's rows of `x` (numpy array or tensor)."""
        return x[self.rows(x.shape[0])]

    def _host(self, t: torch.Tensor, op: Callable[[torch.Tensor], Any]
              ) -> torch.Tensor:
        """Run the collective `op` on `t` in place, through a copy on
        the communication device where `t` lies elsewhere."""
        if self.backend is None:       # one process, no group
            return t
        if t.device == self.comm_device:
            op(t)
            return t
        c = t.to(self.comm_device)
        op(c)
        t.copy_(c)
        return t

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over the ranks, in place; returns it."""
        return self._host(t, dist.all_reduce)

    def tree_mean(self, tree):
        """The mean over the ranks of every leaf of `tree`, in place: the
        leaves of each dtype go through one flat buffer and one
        all-reduce."""
        if self.backend is None:       # one process, no group
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

    def gather_rows(self, a: np.ndarray) -> np.ndarray:
        """Every rank's rows of a host array (the same shape on each),
        concatenated in rank order."""
        if self.backend is None:       # one process, no group
            return a
        t = torch.from_numpy(np.ascontiguousarray(a)).to(self.comm_device)
        parts = [torch.empty_like(t) for _ in range(self.dp)]
        dist.all_gather(parts, t)
        return np.concatenate([p.cpu().numpy() for p in parts])

    def broadcast(self, a: np.ndarray) -> np.ndarray:
        """Rank 0's host array, on every rank."""
        if self.backend is None:       # one process, no group
            return a
        t = torch.from_numpy(np.ascontiguousarray(a)).to(self.comm_device)
        dist.broadcast(t, 0)
        return t.cpu().numpy()


def make_mesh(dp: int = 1, tp: int = 1, devices=None,
              local_rank: Optional[int] = None) -> Mesh:
    """This process's mesh of a data-parallel run of `dp` ranks.  With dp
    > 1 the process group must be up (`launch`, or `init` under a
    launcher) and hold dp ranks.  `devices`: the host's devices, one a
    local rank (default: every card, or the CPU); a list that names one
    card twice puts two ranks on it.  `local_rank`: this process's index
    into `devices` (default: its rank)."""
    refuse_tp(tp)
    devices = [torch.device(d) for d in (devices if devices is not None
                                         else host_devices("cuda"))]
    if dp == 1 and not dist.is_initialized():
        check_devices(1, devices)
        return Mesh(1, 0, devices[0], None)
    if not dist.is_initialized():
        raise RuntimeError(f"dp={dp} needs the process group up: start the "
                           "ranks with parallel.mesh.launch, or under a "
                           "launcher call parallel.mesh.init first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != dp:
        raise ValueError(f"dp={dp}, but the run has {world} ranks: under a "
                         "launcher --dp must equal the world size")
    local = rank if local_rank is None else local_rank
    check_devices(local + 1 if local_rank is not None else dp, devices)
    return Mesh(dp, rank, devices[local], dist.get_backend())


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


def _rank_entry(rank: int, fn, dp: int, port: int, backend: str,
                devices, args) -> None:
    init(rank, dp, "localhost", port, backend)
    try:
        device = torch.device(devices[rank])
        if device.type == "cuda":
            torch.cuda.set_device(device)
        else:       # the ranks share the host's cores
            torch.set_num_threads(max(1, torch.get_num_threads() // dp))
        fn(make_mesh(dp, devices=devices), *args)
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, dp: int, devices: Sequence, *args) -> None:
    """Run `fn(mesh, *args)` in `dp` new processes, rank r on
    `devices[r]`, over a process group on a free localhost port (NCCL on
    distinct cards, gloo otherwise).  `fn` must be importable (a module's
    function).  Returns when every rank has; a rank that fails ends the
    others and raises here."""
    devices = [str(torch.device(d)) for d in devices]
    check_devices(dp, devices)
    devices = devices[:dp]
    torch.multiprocessing.start_processes(
        _rank_entry, args=(fn, dp, free_port(), backend_for(devices),
                           devices, args),
        nprocs=dp, start_method="spawn")
