"""Replica meshes over ``torch.distributed`` (port of
``repro.launch.mesh``).

The reference is single-controller: one process sees every device and a
``jax.sharding.Mesh`` names them. The port is one process per bank row:
each rank joins a default process group and builds a
:class:`ReplicaMesh` that names its place on the replica axes (``pod`` ×
``data``, flat replica id ``pod_idx * data + data_idx``, which is the
rank), its device and the backend that carries its collectives.

Backends:

- ``nccl`` (the default): one card per rank, ``cuda:LOCAL_RANK``;
  collectives move CUDA tensors directly. NCCL refuses two ranks of one
  communicator on one card, so more ranks than cards raises before any
  rank starts.
- ``gloo``: several ranks may share a card, or run on the CPU. Gloo's
  point-to-point ops carry host memory only, so a CUDA tensor is staged
  through a pinned host buffer (``core/collectives.py``).

:func:`initialize_multihost` joins the world from torchrun's environment
(``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``); :func:`run_local_ranks` spawns R local ranks on one
host, joined through a file store, and returns what each one's function
returned; :func:`single_rank_world` makes this process a world of one
(a replica mesh of one rank, as the reference's 1 x 1 mesh).

Tensor parallelism within a replica (the LM trainer): a world of
``pods × data × model`` ranks (:func:`make_replica_mesh` with
``model`` > 1), rank ``replica * model + model_index``, so the
``model`` ranks of one replica are consecutive. The mesh holds two partitions of the world as process
groups: the *model group* (the ranks of the rank's replica, over which
the split layers reduce; ``core/collectives.py`` ``ModelParallel``) and
the *data group* (the ranks holding the same model index, one a
replica, over which the replica-axis collectives run: mixing is
elementwise, so mixing each shard is mixing the whole tree).
The bank engines keep the model axis at 1.
:func:`make_mesh` and :func:`make_production_mesh` give abstract meshes
(axis names and sizes, no processes), on which ``repro_torch.sharding``
resolves specs; :func:`fake_world` gives the rank mesh of such a mesh's
world in one process, on ``meta`` tensors (the dry-run's).
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import queue
import shutil
import tempfile
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes, no processes: what ``repro_torch.sharding``
    resolves specs on (the reference's ``Mesh`` reads no more)."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def make_mesh(shape, axes) -> AbstractMesh:
    """An abstract mesh of ``shape`` over ``axes`` (the reference's
    test-sized ``make_mesh``, without devices)."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} against axes {axes}")
    return AbstractMesh(axes, shape)


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The production mesh, abstract: (16, 16) over ("data", "model"), or
    (2, 16, 16) over ("pod", "data", "model")."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_mesh((16, 16), ("data", "model"))


@dataclasses.dataclass(frozen=True, eq=False)
class ReplicaMesh:
    """This rank's place on the mesh axes of an initialised world.

    ``pods`` × ``data`` replicas of ``model`` ranks each: a bank row a
    rank (the bank engines, ``model`` 1) or a replica's tensor-parallel
    slice a rank (the LM trainer). Compared and hashed by identity: the
    mesh owns the process subgroups made for it (``groups``, and the
    ``model_group`` / ``data_group`` partitions when ``model`` > 1), the
    staging buffers of a gloo world on a card (``staging``), the
    per-(FLConfig) group registries (``registries``) and the traffic
    counters of every collective issued on it: ``traffic`` over the
    replica axes (the data group), ``model_traffic`` over the model
    group."""
    world_size: int
    rank: int
    pods: int
    data: int
    device: torch.device
    backend: str
    model: int = 1
    model_group: Any = dataclasses.field(default=None, repr=False)
    data_group: Any = dataclasses.field(default=None, repr=False)
    groups: Dict = dataclasses.field(default_factory=dict, repr=False)
    staging: Dict = dataclasses.field(default_factory=dict, repr=False)
    registries: Dict = dataclasses.field(default_factory=dict, repr=False)
    traffic: Dict = dataclasses.field(default_factory=dict, repr=False)
    model_traffic: Dict = dataclasses.field(default_factory=dict,
                                            repr=False)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return (("pod", "data", "model") if self.pods > 1
                else ("data", "model"))

    @property
    def shape(self) -> Dict[str, int]:
        if self.pods > 1:
            return {"pod": self.pods, "data": self.data, "model": self.model}
        return {"data": self.data, "model": self.model}

    @property
    def replica(self) -> int:
        """Flat replica id ``pod_idx * data + data_idx``."""
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        """This rank's place in its replica's model group."""
        return self.rank % self.model

    @property
    def pod_index(self) -> int:
        return self.replica // self.data

    @property
    def data_index(self) -> int:
        return self.replica % self.data

    def rank_of(self, replica: int, model_index: Optional[int] = None
                ) -> int:
        """The world rank of ``replica``'s slice ``model_index`` (this
        rank's by default)."""
        m = self.model_index if model_index is None else model_index
        return int(replica) * self.model + m

    @property
    def staged(self) -> bool:
        """True where a CUDA tensor crosses through host memory: gloo on
        a card."""
        return self.backend == "gloo" and self.device.type == "cuda"

    @property
    def transport(self) -> str:
        """How rows travel between ranks, for round reports."""
        if self.staged:
            return "gloo, host-staged"
        return self.backend

    def reset_traffic(self) -> None:
        self.traffic.clear()
        self.model_traffic.clear()

    def traffic_by_group(self) -> Dict[str, Dict]:
        """``{"data": ..., "model": ...}``: each group's ``{op: {calls,
        sent, recv}}`` (copies)."""
        return {"data": {k: dict(v) for k, v in self.traffic.items()},
                "model": {k: dict(v) for k, v in self.model_traffic.items()}}


def rank_device(backend: str,
                device: Optional[Union[str, torch.device]] = None
                ) -> torch.device:
    """The device of this rank under ``backend``: ``device`` if given
    (an index-less ``cuda`` becomes ``cuda:LOCAL_RANK`` under NCCL and
    ``cuda:LOCAL_RANK % cards`` under gloo), else the card; raises
    without one (pass ``device="cpu"`` with gloo to run there) and when
    NCCL would put a second rank on a card."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type != "cuda":
        if backend == "nccl":
            raise ValueError("NCCL moves CUDA tensors: give each rank a card "
                             f"(device {dev}), or use the gloo backend")
        return dev
    cards = torch.cuda.device_count()
    if cards == 0:
        raise RuntimeError(
            "repro_torch runs its ranks on CUDA devices by default and none "
            "is visible; pass device='cpu' with the gloo backend to run on "
            "the CPU")
    if dev.index is not None:
        return dev
    if backend == "nccl" and local >= cards:
        raise RuntimeError(
            f"NCCL puts one rank on each card: local rank {local} has no "
            f"card of its own ({cards} visible); share cards over gloo")
    return torch.device("cuda", local % cards)


def make_replica_mesh(num_replicas: int, *, model: int = 1, pods: int = 1,
                      device: Optional[Union[str, torch.device]] = None
                      ) -> ReplicaMesh:
    """Mesh of ``num_replicas`` replicas (``pods > 1`` adds a leading
    ``pod`` axis so multi-pod edge crossings are exercised; replica id =
    ``pod_idx * data + data_idx``) of ``model`` ranks each, over the
    initialised default process group of ``num_replicas * model`` ranks.
    The sharded ModelBank engines take ``model`` 1: one bank row a rank.
    The LM trainer's ``model`` > 1 splits each replica over that many
    tensor-parallel ranks, and every rank makes the model groups
    (``num_replicas`` groups of ``model`` consecutive ranks) and the data
    groups (``model`` groups of ``num_replicas`` ranks, one a replica) in
    the same order. ``device`` as :func:`rank_device`."""
    if model < 1:
        raise ValueError(f"model axis of size {model}")
    if not dist.is_initialized():
        raise RuntimeError(
            "make_replica_mesh needs an initialised default process group: "
            "call initialize_multihost (torchrun) or run under "
            "run_local_ranks")
    world = dist.get_world_size()
    if model == 1 and world != num_replicas:
        raise RuntimeError(
            f"need {num_replicas} devices for {num_replicas} bank rows, "
            f"have {world}; run under torchrun --nproc-per-node "
            f"{num_replicas} or run_local_ranks({num_replicas}, ...)")
    if world != num_replicas * model:
        raise RuntimeError(
            f"need {num_replicas} x {model} = {num_replicas * model} ranks "
            f"for {num_replicas} replicas of {model} model ranks, have "
            f"{world}")
    if pods < 1 or num_replicas % pods:
        raise ValueError(f"{num_replicas} replicas do not split into {pods} "
                         "pods")
    backend = str(dist.get_backend())
    return ReplicaMesh(world_size=world, rank=dist.get_rank(), pods=pods,
                       data=num_replicas // pods,
                       device=rank_device(backend, device), backend=backend,
                       model=model, **_model_groups(num_replicas, model,
                                                    backend))


def _model_groups(num_replicas: int, model: int, backend: str) -> dict:
    """The model groups (``num_replicas`` groups of ``model`` consecutive
    ranks) and the data groups (``model`` groups of ``num_replicas``
    ranks, one a replica) of the initialised world, this rank's of each;
    none without a model axis."""
    if model == 1:
        return {}
    world = num_replicas * model
    model_group, _ = dist.new_subgroups_by_enumeration(
        [list(range(r * model, (r + 1) * model))
         for r in range(num_replicas)], backend=backend)
    data_group, _ = dist.new_subgroups_by_enumeration(
        [list(range(m, world, model)) for m in range(model)],
        backend=backend)
    return {"model_group": model_group, "data_group": data_group}


@contextlib.contextmanager
def fake_world(mesh, rank: int = 0):
    """This process as rank ``rank`` of a world of ``mesh``'s size over
    the ``"fake"`` backend, for the block: yields the
    :class:`ReplicaMesh` that :func:`make_replica_mesh` would give that
    rank of a ``pod`` x ``data`` x ``model`` world (the sizes of an
    abstract mesh, :func:`make_production_mesh` or :func:`make_mesh`),
    on the ``meta`` device. One process, no store and no peer: the
    backend's collectives return at once and move nothing, and ``meta``
    tensors allocate nothing, so the port's code runs a rank's program
    of a world of any size (``launch.dryrun``) while its collectives
    count their traffic on the mesh as usual. Refuses to start inside
    another world; always leaves the fake one."""
    if dist.is_initialized():
        raise RuntimeError("fake_world: this process is already in a world")
    # a private module of torch's (the fake backend registers itself on
    # import), imported here only
    from torch.testing._internal.distributed.fake_pg import FakeStore
    shape = dict(mesh.shape)
    pods, data, model = shape.get("pod", 1), shape["data"], \
        shape.get("model", 1)
    world = pods * data * model
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} of a world of {world}")
    dist.init_process_group("fake", rank=rank, world_size=world,
                            store=FakeStore())
    try:
        yield ReplicaMesh(world_size=world, rank=rank, pods=pods, data=data,
                          device=torch.device("meta"), backend="fake",
                          model=model,
                          **_model_groups(pods * data, model, "fake"))
    finally:
        dist.destroy_process_group()


def make_tier_mesh(hierarchy, *, pods: int = 1,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> ReplicaMesh:
    """Mesh for a depth-L hierarchy preset (branching factors root→leaf,
    e.g. ``(2, 2, 2)`` = 2 regions × 2 edges × 2 devices): one bank row
    per leaf device. The tier structure lives in ``FLConfig.hierarchy``
    and the group registry, not in extra mesh axes."""
    n = int(np.prod(tuple(hierarchy)))
    return make_replica_mesh(n, pods=pods, device=device)


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, *,
                         backend: str = "nccl",
                         device: Optional[Union[str, torch.device]] = None,
                         init_method: Optional[str] = None,
                         timeout_s: float = 1800.0) -> torch.device:
    """Join the default process group: the reference's
    ``JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID``
    become torchrun's ``MASTER_ADDR:MASTER_PORT``, ``WORLD_SIZE`` and
    ``RANK`` (arguments win over the environment); ``init_method`` (a
    ``file://`` store, say) replaces the TCP address. Returns this
    rank's device (:func:`rank_device`), made current when it is a
    card."""
    dev = rank_device(backend, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if init_method is None:
        init_method = "tcp://" + (
            coordinator_address or (f"{os.environ['MASTER_ADDR']}:"
                                    f"{os.environ['MASTER_PORT']}"))
    world = (num_processes if num_processes is not None
             else int(os.environ["WORLD_SIZE"]))
    rank = process_id if process_id is not None else int(os.environ["RANK"])
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    if backend == "gloo":
        # gloo connects the full mesh inside init, and a rank may return
        # from it while a peer is still reading its side of a pair: were
        # that rank to finish and close its pairs (a short ``fn``), the
        # peer's init fails ("Connection closed by peer"). No rank leaves
        # before every rank has joined.
        dist.barrier()
    return dev


def under_torchrun() -> bool:
    """True when torchrun's environment names this process's rank."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def _rank_main(fn, args, rank: int, world: int, store: str, backend: str,
               device, threads: int, timeout_s: float, results) -> None:
    """One spawned rank: join the world, run ``fn(*args)``, report."""
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(threads)
    try:
        initialize_multihost(backend=backend, device=device,
                             init_method=f"file://{store}",
                             timeout_s=timeout_s)
        out = (rank, True, fn(*args))
    except Exception:   # reported to the parent, which raises
        out = (rank, False, traceback.format_exc())
    results.put(out)
    if dist.is_initialized():
        dist.destroy_process_group()


def run_local_ranks(fn: Callable, nprocs: int, *, args: Sequence = (),
                    backend: str = "gloo",
                    device: Optional[Union[str, torch.device]] = None,
                    threads: int = 1, timeout_s: float = 600.0
                    ) -> List[Any]:
    """Run ``fn(*args)`` on ``nprocs`` local ranks of a fresh world and
    return each rank's result, by rank.

    The ranks are processes of the ``spawn`` start method (``fn`` and
    ``args`` are pickled, so ``fn`` is a module-level function), joined
    through a file store in a fresh temporary directory (no port, so
    concurrent worlds on one host cannot take each other's rendezvous),
    with ``threads`` intra-op threads each; ``device`` is each rank's
    (:func:`rank_device`; the card by default). NCCL with more ranks than cards raises here,
    before any rank starts. A rank that raises, or dies, fails the run:
    the others are stopped and the error carries the rank's
    traceback."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if backend == "nccl" and nprocs > torch.cuda.device_count():
        raise RuntimeError(
            f"NCCL puts one rank on each card: {nprocs} ranks need {nprocs} "
            f"cards, {torch.cuda.device_count()} visible; share cards over "
            "the gloo backend")
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="ranks-")
    store = os.path.join(tmp, "store")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, tuple(args), r, nprocs, store, backend,
                               device, threads, timeout_s, results))
             for r in range(nprocs)]
    for p in procs:
        p.start()
    got: Dict[int, Any] = {}
    failed: List[str] = []
    waited = 0.0
    try:
        # drain the queue before joining (a writer blocks on a full pipe)
        while len(got) + len(failed) < nprocs:
            try:
                rank, ok, val = results.get(timeout=1.0)
            except queue.Empty:
                waited += 1.0
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead or waited > timeout_s:
                    failed.append(
                        f"ranks exited with codes "
                        f"{[p.exitcode for p in procs]} after "
                        f"{waited:.0f} s without reporting")
                    break
                continue
            if ok:
                got[rank] = val
            else:
                failed.append(f"rank {rank}:\n{val}")
                break
    finally:
        for p in procs:
            if failed:
                p.terminate()
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    if failed:
        raise RuntimeError("a rank failed:\n" + "\n".join(failed))
    return [got[r] for r in range(nprocs)]


@contextlib.contextmanager
def single_rank_world(backend: str = "gloo",
                      device: Optional[Union[str, torch.device]] = None):
    """This process as a world of one rank, joined through a file store in
    a fresh temporary directory, for the block; yields its
    :class:`ReplicaMesh` (one replica) and leaves the world at exit.
    ``device`` as :func:`rank_device`."""
    if dist.is_initialized():
        raise RuntimeError("single_rank_world: this process is already in "
                           "a world")
    dev = rank_device(backend, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    tmp = tempfile.mkdtemp(prefix="rank-")
    try:
        dist.init_process_group(backend, init_method="file://" + os.path.join(
            tmp, "store"), world_size=1, rank=0)
        try:
            yield make_replica_mesh(1, device=dev)
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
