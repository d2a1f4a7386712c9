"""Device meshes, partition specs and the world of ranks (counterpart:
``ray_tpu/parallel/mesh.py``).

The JAX package runs one controller over every device: arrays are global,
a ``NamedSharding`` says how each is laid out, and GSPMD inserts the
collectives. PyTorch has no such controller, so the port runs SPMD in
processes: one process a rank under ``torch.distributed``, each holding
its own shard of every parameter and batch, and explicit collectives
(``collectives.py``) where the JAX package's manual-SPMD code has them.

- ``make_mesh`` builds a ``Mesh`` over the initialized world: a
  ``torch.distributed.device_mesh.DeviceMesh`` whose dims are named from
  ``AXIS_ORDER`` (size-1 dims kept), with a ``shape`` mapping as JAX's
  (``mesh.shape["tp"]``) and this rank's compute device. A mesh may name a
  subset of the axes (``make_mesh({"dp": 2, "sp": 2, "tp": 2})``); an axis
  it does not name has size 1.
- ``P`` is the partition spec (JAX's ``PartitionSpec``): one entry a
  leading dim, None, an axis name or a tuple of names. ``shard`` is
  ``jax.device_put`` for a tree: each rank keeps its block. ``gather`` is
  ``jax.device_get``: every rank gets the whole tensor back.
- ``launch`` (over ``World``) starts the ranks as processes on this host,
  runs a function in each and returns each rank's result: the port's
  counterpart of the single controller over ``jax.devices()``. A rank keeps
  objects between a world's calls in ``rank_state()``. Under
  ``torchrun``, call ``make_mesh`` in each process instead; it initializes
  the world from torchrun's environment.

Transport: the world is gloo, whose collectives run on host tensors; a
CUDA tensor is copied to pinned host memory and back in one place
(``collectives.py``), so the computation stays on the card. Several ranks
may share one card (NCCL refuses that). NCCL, one card a rank, is in
ROADMAP.md.

``resolve_shard_map``, ``axis_size_compat`` and ``shard_map_compat`` are
shims over jax versions and have no counterpart: the port has no
``shard_map``; its per-rank bodies (``*_sharded``) take the mesh.

Axes:
    dp  data parallel (gradients averaged)
    pp  pipeline stages (activations hop to the next stage)
    sp  sequence parallel (ring or Ulysses attention)
    tp  tensor parallel (Megatron's column then row parallel products)
"""

from __future__ import annotations

import datetime
import os
import pickle
import secrets
import socket
import subprocess
import sys
import traceback
from dataclasses import dataclass
from multiprocessing.connection import Listener, wait
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from .. import Device, default_device

AXIS_ORDER = ("dp", "pp", "sp", "tp")  # outermost -> innermost
AxisName = Union[str, Tuple[str, ...]]
# Every world's collective timeout: a rank whose collectives do not match
# its peers' fails instead of hanging.
TIMEOUT_S = 60.0


@dataclass(frozen=True)
class MeshSpec:
    dp: int = 1
    pp: int = 1
    sp: int = 1
    tp: int = 1

    @property
    def size(self) -> int:
        return self.dp * self.pp * self.sp * self.tp

    def axis_sizes(self) -> Tuple[int, ...]:
        return (self.dp, self.pp, self.sp, self.tp)

    @classmethod
    def auto(cls, n_devices: int, *, want_tp: int = 0, want_sp: int = 0,
             want_pp: int = 1) -> "MeshSpec":
        """Factorize n_devices into a sensible (dp, pp, sp, tp) layout.

        Preference order: give tp what it asks for (bounded by n), then sp,
        then pp, and put the remainder in dp.
        """
        remaining = n_devices
        pp = want_pp if remaining % max(want_pp, 1) == 0 else 1
        remaining //= pp
        tp = want_tp or _largest_divisor(remaining, cap=min(remaining, 8))
        if remaining % tp != 0:
            tp = _largest_divisor(remaining, cap=tp)
        remaining //= tp
        sp = want_sp or _largest_divisor(remaining, cap=min(remaining, 4))
        if remaining % sp != 0:
            sp = _largest_divisor(remaining, cap=sp)
        remaining //= sp
        dp = remaining
        return cls(dp=dp, pp=pp, sp=sp, tp=tp)


def _largest_divisor(n: int, cap: int) -> int:
    for d in range(min(cap, n), 0, -1):
        if n % d == 0:
            return d
    return 1


class P(tuple):
    """A partition spec: entry i says how dim i is split, None (whole), an
    axis name, or a tuple of axis names (split over their product, the
    first outermost). Dims past the last entry are whole."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        return tuple(self)   # pickle rebuilds P(*entries), not P(entries)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


@dataclass(frozen=True)
class NamedSharding:
    """A spec bound to its mesh (JAX's ``NamedSharding``)."""
    mesh: "Mesh"
    spec: P


def named(mesh: "Mesh", *spec) -> NamedSharding:
    return NamedSharding(mesh, P(*spec))


def replicated(mesh: "Mesh") -> NamedSharding:
    return NamedSharding(mesh, P())


class Mesh:
    """This rank's view of a device mesh: the ``DeviceMesh``
    (``device_mesh``), the axes' sizes (``shape``, in mesh order), this
    rank's place on each axis (``index``) and its compute ``device``."""

    def __init__(self, device_mesh, device: torch.device):
        self.device_mesh = device_mesh
        self.axis_names: Tuple[str, ...] = tuple(device_mesh.mesh_dim_names)
        self.shape: Dict[str, int] = dict(
            zip(self.axis_names, device_mesh.mesh.shape))
        self.device = device
        self.rank = dist.get_rank()
        self._coords = dict(zip(self.axis_names,
                                device_mesh.get_coordinate()))

    def size(self, axis: AxisName) -> int:
        """Ranks along ``axis`` (a name or a tuple of names); 1 for an axis
        the mesh does not have."""
        if isinstance(axis, str):
            return self.shape.get(axis, 1)
        out = 1
        for a in axis:
            out *= self.size(a)
        return out

    def index(self, axis: AxisName) -> int:
        """This rank's place along ``axis``; for a tuple, row-major over
        its names (the first outermost)."""
        if isinstance(axis, str):
            return self._coords.get(axis, 0)
        out = 0
        for a in axis:
            out = out * self.size(a) + self.index(a)
        return out

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``."""
        return self.device_mesh.get_group(axis)

    def ranks(self, axis: str) -> List[int]:
        """The global ranks of this rank's line along ``axis``, by place."""
        return dist.get_process_group_ranks(self.group(axis))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank {self.rank}, {self.device})"


# DeviceMeshes built in this process, by their axes and sizes: a world that
# runs many functions builds each layout's groups once.
_MESHES: Dict[Tuple, Any] = {}
# The compute device ``launch`` gave this rank.
_RANK_DEVICE: Optional[torch.device] = None


def rank_device(device: Device = None) -> torch.device:
    """This rank's compute device: ``device`` if given, else the one
    ``launch`` chose, else the card ``LOCAL_RANK`` (torchrun) or the rank
    picks among the visible cards."""
    if device is not None:
        return default_device(device)
    if _RANK_DEVICE is not None:
        return _RANK_DEVICE
    default_device(None)  # raises without a card
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


def _init_world_from_env() -> None:
    if not dist.is_initialized():
        dist.init_process_group(
            "gloo", timeout=datetime.timedelta(seconds=TIMEOUT_S))


def make_mesh(spec: Union[MeshSpec, Mapping[str, int], None] = None, *,
              device: Device = None) -> Mesh:
    """A ``Mesh`` over every rank of the world: ``spec`` is a ``MeshSpec``
    (the four axes of ``AXIS_ORDER``), a mapping of some of those axes to
    their sizes, in ``AXIS_ORDER``'s order, or None for
    ``MeshSpec.auto(world size)``. Every rank calls it (collectively), in
    the same order. The world must be gloo; one not yet initialized is
    initialized from torchrun's environment."""
    _init_world_from_env()
    if dist.get_backend() != "gloo":
        raise ValueError(
            f"ray_tpu_torch meshes run over gloo, not "
            f"{dist.get_backend()}; NCCL is in ROADMAP.md")
    world = dist.get_world_size()
    if spec is None:
        spec = MeshSpec.auto(world)
    if isinstance(spec, MeshSpec):
        names, sizes = AXIS_ORDER, spec.axis_sizes()
    else:
        names, sizes = tuple(spec), tuple(int(v) for v in spec.values())
        order = [AXIS_ORDER.index(n) for n in names if n in AXIS_ORDER]
        if len(order) != len(names) or order != sorted(order):
            raise ValueError(f"mesh axes {names} must be some of "
                             f"{AXIS_ORDER}, in that order")
    total = 1
    for s in sizes:
        total *= s
    if total != world:
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs {total} "
                         f"ranks, the world has {world}")
    key = (names, sizes)
    if key not in _MESHES:
        from torch.distributed.device_mesh import init_device_mesh
        _MESHES[key] = init_device_mesh("cpu", sizes, mesh_dim_names=names)
    return Mesh(_MESHES[key], rank_device(device))


# ------------------------------------------------------ shard and gather


def _spec_of(node) -> Optional[P]:
    if node is None:
        return P()
    if isinstance(node, NamedSharding):
        return node.spec
    if isinstance(node, P):
        return node
    return None


def map_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over ``tree``; ``specs`` is a tree of the same
    structure, or a prefix of it whose leaves (a ``P``, a
    ``NamedSharding`` or None for replicated) apply to whole subtrees."""
    spec = _spec_of(specs)
    if spec is not None:
        if isinstance(tree, dict):
            return {k: map_specs(fn, v, specs) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(map_specs(fn, v, specs) for v in tree)
        return fn(tree, spec)
    if isinstance(tree, dict):
        return {k: map_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_specs(fn, v, s) for v, s in zip(tree, specs))
    raise TypeError(f"no spec for leaf of type {type(tree).__name__}")


def _block(x, spec: P, mesh: Mesh):
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        n = mesh.size(entry)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of size {x.shape[dim]} does not "
                             f"split over {entry} ({n} ranks)")
        c = x.shape[dim] // n
        i = mesh.index(entry)
        x = x[(slice(None),) * dim + (slice(i * c, (i + 1) * c),)]
    return x.contiguous() if isinstance(x, torch.Tensor) else x


def shard(tree, specs, mesh: Mesh):
    """This rank's block of every leaf (tensors or numpy arrays) by its
    spec: ``jax.device_put(tree, shardings)``, each rank keeping its own
    part. A leaf that is not split comes back as it is."""
    return map_specs(lambda x, spec: _block(x, spec, mesh), tree, specs)


def gather(tree, specs, mesh: Mesh):
    """Every leaf whole on every rank (``jax.device_get``): the blocks of
    ``shard`` all-gathered along each split dim. Collective (every rank
    calls it) and not differentiable; the result is detached."""
    from .collectives import _gather_raw

    def whole(x, spec):
        x = x.detach()
        for dim, entry in enumerate(spec):
            if entry is not None:
                x = _gather_raw(x, mesh, entry, dim)
        return x

    return map_specs(whole, tree, specs)


# ---------------------------------------------------------- the world

# Objects a rank keeps between ``World.run`` calls, by key (a serving
# engine that the world steps once a call).
_RANK_STATE: Dict[str, Any] = {}


def rank_state() -> Dict[str, Any]:
    """This process's registry of objects kept between ``World.run`` calls:
    a function the world runs stores an object under a key, and a later
    one finds it there, in the same rank process."""
    return _RANK_STATE



class RankError(RuntimeError):
    """A function raised on a rank; the message holds its traceback."""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class World:
    """``world_size`` rank processes on this host in one gloo world, each
    on ``device`` (None: the card, ``cuda:{rank % cards}``; "cpu"), with
    ``threads`` torch threads (None: torch's default). ``run(fn, *args)``
    calls ``fn(*args)`` in every rank and returns the results by rank.

    Functions and arguments travel by cloudpickle: a function of a
    ``__main__`` script goes by value, one of an importable module by
    reference (``cloudpickle.register_pickle_by_value`` sends a module's
    by value). Results come back by pickle; return host tensors or numbers.
    If a rank raises, the world is stopped (its peers would wait in a
    collective until the timeout) and ``run`` raises ``RankError``; the
    next ``run`` starts a new world."""

    def __init__(self, world_size: int, *, backend: str = "gloo",
                 device: Device = None, threads: Optional[int] = None):
        if backend != "gloo":
            raise ValueError(f"launch runs gloo worlds, not {backend}; "
                             "NCCL is in ROADMAP.md")
        self.world_size = world_size
        self.device = "cuda" if device is None else str(
            default_device(device))
        if self.device == "cuda":
            default_device(None)  # raises without a card
        self.threads = threads
        self._procs: List[subprocess.Popen] = []
        self._conns: list = []

    def __enter__(self) -> "World":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _start(self) -> None:
        authkey = secrets.token_bytes(16)
        listener = Listener(("127.0.0.1", 0), authkey=authkey)
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [pkg_root] + [p for p in sys.path if p and os.path.isdir(p)])
        env.setdefault("GLOO_SOCKET_IFNAME", "lo")
        env.setdefault("TORCH_CPP_LOG_LEVEL", "ERROR")
        if self.threads:
            env["OMP_NUM_THREADS"] = str(self.threads)
        env["RAY_TPU_TORCH_RANK_AUTHKEY"] = authkey.hex()
        host, port = listener.address
        conf = {"address": f"{host}:{port}", "world_size": self.world_size,
                "init": f"tcp://127.0.0.1:{_free_port()}",
                "device": self.device, "threads": self.threads}
        try:
            for rank in range(self.world_size):
                env["RAY_TPU_TORCH_RANK_CONF"] = repr({**conf, "rank": rank})
                self._procs.append(subprocess.Popen(
                    [sys.executable, "-m", "ray_tpu_torch.parallel._rank"],
                    env=env, stdin=subprocess.DEVNULL))
            by_rank = {}
            for _ in range(self.world_size):
                conn = listener.accept()
                by_rank[conn.recv()] = conn
            self._conns = [by_rank[r] for r in range(self.world_size)]
            self._collect()  # every rank has joined the world
        except BaseException:
            self.close()
            raise
        finally:
            listener.close()

    def _collect(self) -> list:
        """Each rank's next reply, in rank order; stops the world and
        raises RankError on the first failure."""
        results: Dict[int, Any] = {}
        pending = dict(enumerate(self._conns))
        while pending:
            for conn in wait(list(pending.values())):
                rank = next(r for r, c in pending.items() if c is conn)
                try:
                    status, value = pickle.loads(conn.recv_bytes())
                except (EOFError, OSError):
                    status, value = "err", "the rank's process ended"
                if status != "ok":
                    self.close()
                    raise RankError(f"rank {rank}: {value}")
                results[rank] = value
                del pending[rank]
        return [results[r] for r in range(self.world_size)]

    def run(self, fn, *args) -> list:
        import cloudpickle

        if not self._procs:
            self._start()
        blob = cloudpickle.dumps((fn, args))
        for conn in self._conns:
            conn.send_bytes(blob)
        return self._collect()

    def close(self) -> None:
        """Stop every rank: a polite stop, then a kill after 10 s."""
        for conn in self._conns:
            try:
                conn.send_bytes(b"stop")
            except OSError:
                pass
        for proc in self._procs:
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        for conn in self._conns:
            conn.close()
        self._procs, self._conns = [], []


def launch(fn, world_size: int, *args, backend: str = "gloo",
           device: Device = None, threads: Optional[int] = None) -> list:
    """Start ``world_size`` ranks, run ``fn(*args)`` in each, stop them and
    return the results by rank (``World`` for many calls)."""
    with World(world_size, backend=backend, device=device,
               threads=threads) as world:
        return world.run(fn, *args)


def _rank_main() -> None:
    """A rank process (``python -m ray_tpu_torch.parallel._rank``)."""
    from multiprocessing.connection import Client

    global _RANK_DEVICE
    import ast

    conf = ast.literal_eval(os.environ.pop("RAY_TPU_TORCH_RANK_CONF"))
    authkey = bytes.fromhex(os.environ.pop("RAY_TPU_TORCH_RANK_AUTHKEY"))
    host, port = conf["address"].rsplit(":", 1)
    conn = Client((host, int(port)), authkey=authkey)
    rank = conf["rank"]
    conn.send(rank)

    def reply(status, value):
        try:
            blob = pickle.dumps((status, value))
        except Exception as exc:  # an unpicklable result
            blob = pickle.dumps(("err", f"result not picklable: {exc!r}"))
        conn.send_bytes(blob)

    try:
        if conf["threads"]:
            torch.set_num_threads(conf["threads"])
        if conf["device"] == "cuda":
            idx = rank % torch.cuda.device_count()
            torch.cuda.set_device(idx)
            _RANK_DEVICE = torch.device("cuda", idx)
        else:
            _RANK_DEVICE = torch.device(conf["device"])
        dist.init_process_group(
            "gloo", init_method=conf["init"], rank=rank,
            world_size=conf["world_size"],
            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    except BaseException:
        reply("err", traceback.format_exc())
        return
    reply("ok", None)
    while True:
        try:
            blob = conn.recv_bytes()
        except (EOFError, OSError):
            break
        if blob == b"stop":
            break
        try:
            fn, args = pickle.loads(blob)
            reply("ok", fn(*args))
        except BaseException:
            reply("err", traceback.format_exc())
    dist.destroy_process_group()
    conn.close()

