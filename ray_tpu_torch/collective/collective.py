"""Host-level collective API — parity with ``ray.util.collective`` (twin of
``ray_tpu/collective/collective.py``).

Reference surface: ``python/ray/util/collective/collective.py``
(``init_collective_group :120``, ``create_collective_group :151``,
``allreduce :258``, ``barrier :298``, ``reduce :311``, ``broadcast :373``,
``allgather :423``, ``reducescatter :472``, ``send :531``, ``recv :594``).

Three backends (see :mod:`ray_tpu_torch.collective.types`), named as in the
JAX package so that calls carry over:

- STORE — works between any processes/actors; reductions run through a
  named coordinator actor + the shared-memory object store. This is the
  gloo-analog control path. Torch tensors in, each result on its input's
  device.
- XLA (:class:`XlaGroup`) — for tensors on the cards a single process
  owns, one entry a card (the reference's ``*_multigpu`` lists): the
  reductions, gathers and broadcasts are ``torch.cuda.nccl`` calls, the
  single-process many-card NCCL collectives; ``permute``, ``send`` and
  ``alltoall`` are copies between the cards. On CPU tensors each verb runs
  its plain version over the list (any number of entries): the CPU path,
  and the oracle the tests and the card's check hold the NCCL path to.
- XLA_DISTRIBUTED (:class:`XlaDistributedGroup`) — one group across member
  processes, a ``torch.distributed`` process group (NCCL on the card, gloo
  on the CPU) whose rendezvous runs through the coordinator actor; each
  process passes its local entries and the verbs run over all of them.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from ray_tpu_torch.collective.types import Backend, ReduceOp

_groups: Dict[str, "BaseGroup"] = {}
_lock = threading.Lock()

_COORD_PREFIX = "rtpu_collective_coord:"

#: ``torch.cuda.nccl``'s reduction codes (``ncclRedOp_t``); MEAN is a sum
#: divided by the number of entries, as ``lax.pmean`` is
_NCCL_OPS = {"sum": 0, "mean": 0, "product": 1, "max": 2, "min": 3}


def _routable_host() -> str:
    """The rendezvous address of a distributed group. The port runs on one
    node (``cluster/`` is ROADMAP.md queue 1 item 4), so it is the loopback
    unless ``RTPU_COORDINATOR_HOST`` names another."""
    import os

    return os.environ.get("RTPU_COORDINATOR_HOST") or "127.0.0.1"


def _free_port() -> int:
    """A free TCP port on the loopback (the reference takes its
    ``cluster/rpc.py`` ``free_port``; ``cluster/`` is not ported)."""
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _get_or_create_coordinator(group_name: str, world_size: int):
    """Get or create the named coordinator actor. Returns (handle, created)."""
    import ray_tpu_torch
    from ray_tpu_torch.collective.coordinator import CollectiveCoordinator

    name = _COORD_PREFIX + group_name
    try:
        return ray_tpu_torch.get_actor(name), False
    except ValueError:
        try:
            handle = (
                ray_tpu_torch.remote(CollectiveCoordinator)
                .options(name=name, max_concurrency=max(4, world_size))
                .remote(world_size)
            )
            return handle, True
        except Exception:
            return ray_tpu_torch.get_actor(name), False


def _to_numpy(x):
    """A STORE contribution: numpy, whatever it came as."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _like(result, ref):
    """A STORE result as its input came: a torch tensor on the input's
    device for a tensor, else as the reference returns it."""
    import torch

    if isinstance(ref, torch.Tensor):
        return torch.as_tensor(np.asarray(result)).to(ref.device)
    return result


class BaseGroup:
    def __init__(self, world_size: int, rank: int, group_name: str):
        self.world_size = world_size
        self.rank = rank
        self.group_name = group_name

    def destroy(self):
        pass


class StoreGroup(BaseGroup):
    """Collectives through the coordinator actor (CPU / control plane)."""

    def __init__(self, world_size: int, rank: int, group_name: str):
        super().__init__(world_size, rank, group_name)
        self._coord, self._created_coord = _get_or_create_coordinator(
            group_name, world_size)
        self._seq: Dict[str, int] = {}
        self._p2p_seq: Dict[tuple, int] = {}

    def destroy(self):
        if self._created_coord:
            import ray_tpu_torch
            try:
                ray_tpu_torch.kill(self._coord)
            except Exception:
                pass

    def _run(self, kind: str, part: Any, op: str = "sum", root: int = 0,
             timeout_s: float = 60.0):
        import ray_tpu_torch

        # Commit the sequence number only on success so a timed-out op can be
        # retried with the same seq (the late contribution still pairs up).
        seq = self._seq.get(kind, 0)
        out = ray_tpu_torch.get(
            self._coord.contribute.remote(kind, seq, self.rank, part, op, root)
        )
        if out is not None:
            self._seq[kind] = seq + 1
            return out
        deadline = time.monotonic() + timeout_s
        delay = 0.0005
        while time.monotonic() < deadline:
            done, res = ray_tpu_torch.get(
                self._coord.fetch.remote(kind, seq, self.rank))
            if done:
                self._seq[kind] = seq + 1
                return res
            time.sleep(delay)
            delay = min(delay * 2, 0.05)
        raise TimeoutError(
            f"collective {kind}#{seq} timed out in group {self.group_name} "
            f"(rank {self.rank}/{self.world_size})"
        )

    def allreduce(self, tensor, op: ReduceOp = ReduceOp.SUM):
        return _like(self._run("allreduce", _to_numpy(tensor), op=op.value),
                     tensor)

    def barrier(self):
        self._run("barrier", None)

    def reduce(self, tensor, root_rank: int = 0, op: ReduceOp = ReduceOp.SUM):
        out = self._run("reduce", _to_numpy(tensor), op=op.value,
                        root=root_rank)
        return _like(out, tensor) if self.rank == root_rank else tensor

    def broadcast(self, tensor, root_rank: int = 0):
        return _like(self._run("broadcast", _to_numpy(tensor),
                               root=root_rank), tensor)

    def allgather(self, tensor):
        return [_like(p, tensor)
                for p in self._run("allgather", _to_numpy(tensor))]

    def reducescatter(self, tensor, op: ReduceOp = ReduceOp.SUM):
        return _like(self._run("reducescatter", _to_numpy(tensor),
                               op=op.value), tensor)

    def alltoall(self, chunks: List[Any]):
        if len(chunks) != self.world_size:
            raise ValueError("alltoall needs world_size chunks")
        out = self._run("alltoall", [_to_numpy(c) for c in chunks])
        return [_like(p, c) for p, c in zip(out, chunks)]

    def send(self, tensor, dst_rank: int):
        import torch

        import ray_tpu_torch

        key = (self.rank, dst_rank)
        seq = self._p2p_seq.get(key, 0)
        # the receiver gets a (CPU) tensor for a tensor, numpy for numpy
        value = (_to_numpy(tensor), isinstance(tensor, torch.Tensor))
        ray_tpu_torch.get(self._coord.send.remote(self.rank, dst_rank, seq,
                                                  value))
        self._p2p_seq[key] = seq + 1

    def recv(self, src_rank: int, timeout_s: float = 60.0):
        import torch

        import ray_tpu_torch

        key = (src_rank, self.rank)
        seq = self._p2p_seq.get(key, 0)
        deadline = time.monotonic() + timeout_s
        delay = 0.0005
        while time.monotonic() < deadline:
            done, val = ray_tpu_torch.get(
                self._coord.recv.remote(src_rank, self.rank, seq))
            if done:
                self._p2p_seq[key] = seq + 1
                arr, was_tensor = val
                return torch.as_tensor(arr) if was_tensor else arr
            time.sleep(delay)
            delay = min(delay * 2, 0.05)
        raise TimeoutError(f"recv from rank {src_rank} timed out")


# -- the plain verbs: one list of CPU tensors, one entry a device -------------

def _plain_reduce(ts: List[Any], op: str):
    import torch

    stacked = torch.stack(list(ts))
    if op in ("sum", "mean"):
        out = stacked.sum(0)
        return out / len(ts) if op == "mean" else out
    if op == "product":
        return stacked.prod(0)
    if op == "max":
        return stacked.amax(0)
    if op == "min":
        return stacked.amin(0)
    raise ValueError(f"unknown reduce op {op}")


def plain_allreduce(ts, op: str = "sum"):
    out = _plain_reduce(ts, op)
    return [out.clone() for _ in ts]


def plain_allgather(ts):
    """Each entry gets every entry's tensor concatenated on dim 0 (the
    reference's ``all_gather(..., tiled=True)``)."""
    import torch

    out = torch.cat(list(ts), dim=0)
    return [out.clone() for _ in ts]


def plain_reducescatter(ts, op: str = "sum"):
    """Entry i gets the i-th of ``len(ts)`` equal dim-0 pieces of the
    reduction (``psum_scatter(..., tiled=True)``)."""
    out = _plain_reduce(ts, op)
    n = len(ts)
    if out.shape[0] % n:
        raise ValueError(f"reducescatter: dim 0 ({out.shape[0]}) is not a "
                         f"multiple of the {n} entries")
    return [p.clone() for p in out.split(out.shape[0] // n, dim=0)]


def plain_reduce(ts, root: int = 0, op: str = "sum"):
    """Only the root holds the reduction; the others keep their input."""
    out = [t.clone() for t in ts]
    out[root] = _plain_reduce(ts, op)
    return out


def plain_broadcast(ts, root: int = 0):
    return [ts[root].clone() for _ in ts]


def plain_permute(ts, pairs):
    """Each (src, dst) pair ships src's tensor to dst; entries not named as
    a destination keep their input (``lax.ppermute``)."""
    out = [t.clone() for t in ts]
    for s, d in pairs:
        out[int(d)] = ts[int(s)].clone()
    return out


def plain_alltoall(chunk_lists):
    """Entry i ends with every entry's chunk i."""
    n = len(chunk_lists)
    return [[chunk_lists[j][i].clone() for j in range(n)] for i in range(n)]


def _as_tensors(xs) -> List[Any]:
    import torch

    return [x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x)) for x in xs]


class XlaGroup(BaseGroup):
    """Device collectives over the cards this process owns, one entry a
    card (``device="cuda"``, the default; ``world_size`` at most
    ``torch.cuda.device_count()``), or over ``world_size`` entries of CPU
    tensors (``device="cpu"``).

    ``tensors`` arguments are per-device lists (the reference's
    ``*_multigpu`` variants, ``collective.py:340`` etc.): on CUDA tensors,
    entry i on card i, a verb is one ``torch.cuda.nccl`` call (or copies
    between the cards); on CPU tensors it is the verb's plain version. Each
    result lies on its entry's device.
    """

    def __init__(self, world_size: int, rank: int, group_name: str,
                 device=None):
        super().__init__(world_size, rank, group_name)
        from ray_tpu_torch._device import resolve_device

        self.device = resolve_device(device)
        if self.device.type == "cuda":
            import torch

            n = torch.cuda.device_count()
            if world_size > n:
                raise ValueError(
                    f"XLA group world_size {world_size} > local devices {n}")

    # -- dispatch ---------------------------------------------------------

    def _entries(self, tensors) -> tuple:
        """(tensors, on_cards): CPU tensors run the plain verb; CUDA ones,
        entry i on its own card, the NCCL one."""
        ts = _as_tensors(tensors)
        if len(ts) != self.world_size:
            raise ValueError(f"group {self.group_name!r} has "
                             f"{self.world_size} entries, got {len(ts)}")
        cuda = [t.is_cuda for t in ts]
        if not any(cuda):
            return ts, False
        import torch.cuda.nccl as nccl

        if not all(cuda) or len({t.get_device() for t in ts}) != len(ts):
            raise ValueError("XlaGroup: CUDA entries must each lie on a card "
                             "of their own (or pass CPU tensors)")
        ts = [t.contiguous() for t in ts]
        if not nccl.is_available(ts):
            raise RuntimeError("XlaGroup: torch.cuda.nccl is not available "
                               "for these tensors")
        return ts, True

    def _nccl_reduced(self, ts, op: str, outs):
        import torch.cuda.nccl as nccl

        if op not in _NCCL_OPS:
            raise ValueError(f"unknown reduce op {op}")
        nccl.all_reduce(ts, outs, op=_NCCL_OPS[op])
        return [o / len(ts) for o in outs] if op == "mean" else outs

    # -- verbs ------------------------------------------------------------

    def allreduce(self, tensors: List[Any], op: ReduceOp = ReduceOp.SUM):
        ts, cards = self._entries(tensors)
        if not cards:
            return plain_allreduce(ts, op.value)
        return self._nccl_reduced(ts, op.value, [t.clone() for t in ts])

    def allgather(self, tensors: List[Any]):
        ts, cards = self._entries(tensors)
        if not cards:
            return plain_allgather(ts)
        import torch
        import torch.cuda.nccl as nccl

        n = len(ts)
        outs = [torch.empty((n * t.shape[0],) + tuple(t.shape[1:]),
                            dtype=t.dtype, device=t.device) for t in ts]
        nccl.all_gather(ts, outs)
        return outs

    def reducescatter(self, tensors: List[Any], op: ReduceOp = ReduceOp.SUM):
        ts, cards = self._entries(tensors)
        if not cards:
            return plain_reducescatter(ts, op.value)
        import torch
        import torch.cuda.nccl as nccl

        n = len(ts)
        if ts[0].shape[0] % n:
            raise ValueError(f"reducescatter: dim 0 ({ts[0].shape[0]}) is "
                             f"not a multiple of the {n} entries")
        outs = [torch.empty((t.shape[0] // n,) + tuple(t.shape[1:]),
                            dtype=t.dtype, device=t.device) for t in ts]
        nccl.reduce_scatter(ts, outs, op=_NCCL_OPS[op.value])
        return [o / n for o in outs] if op.value == "mean" else outs

    def reduce(self, tensors: List[Any], root_rank: int = 0,
               op: ReduceOp = ReduceOp.SUM):
        ts, cards = self._entries(tensors)
        if not cards:
            return plain_reduce(ts, root_rank, op.value)
        import torch.cuda.nccl as nccl

        outs = [t.clone() for t in ts]
        nccl.reduce(outs, root=root_rank, op=_NCCL_OPS[op.value])
        if op.value == "mean":
            outs[root_rank] = outs[root_rank] / len(ts)
        return outs

    def broadcast(self, tensors: List[Any], root_rank: int = 0):
        ts, cards = self._entries(tensors)
        if not cards:
            return plain_broadcast(ts, root_rank)
        import torch.cuda.nccl as nccl

        outs = [t.clone() for t in ts]
        nccl.broadcast(outs, root=root_rank)
        return outs

    def permute(self, tensors: List[Any], pairs: List[tuple]):
        """Device-level send/recv: each (src, dst) pair ships src's tensor
        to dst (a copy between the cards)."""
        ts, cards = self._entries(tensors)
        if not cards:
            return plain_permute(ts, pairs)
        out = [t.clone() for t in ts]
        for s, d in pairs:
            out[int(d)] = ts[int(s)].to(ts[int(d)].device, copy=True)
        return out

    def send(self, tensors: List[Any], dst_rank: int, src_rank: int = 0):
        """Reference send_multigpu analog: src device's tensor lands on
        dst; returns the updated per-device list."""
        return self.permute(tensors, [(src_rank, dst_rank)])

    def alltoall(self, chunk_lists: List[Any]):
        """``chunk_lists[i]`` = device i's world_size chunks; returns per-
        device transposed chunk lists (device i gets everyone's chunk i)."""
        lists = [_as_tensors(chunks) for chunks in chunk_lists]
        firsts, cards = self._entries([chunks[0] for chunks in lists])
        if not cards:
            return plain_alltoall(lists)
        n = len(lists)
        return [[lists[j][i].to(firsts[i].device, copy=True)
                 for j in range(n)] for i in range(n)]

    def barrier(self):
        import torch

        devs = ([torch.device("cuda", i) for i in range(self.world_size)]
                if self.device.type == "cuda"
                else [self.device] * self.world_size)
        self.allreduce([torch.zeros((8, 128), dtype=torch.float32, device=d)
                        for d in devs])


class XlaDistributedGroup(XlaGroup):
    """Collectives ACROSS MEMBER PROCESSES over one ``torch.distributed``
    process group.

    Role analog: the reference NCCLGroup
    (``collective_group/nccl_collective_group.py:128``): the named
    coordinator actor fills the NCCL-unique-id rendezvous role (it carries
    the group's ``tcp://`` address), the communicator is the default
    process group (NCCL on the card, gloo on the CPU), and every verb is
    executed collectively by all member processes. ``world_size``/``rank``
    are PROCESS world/rank (one actor per process, the reference model);
    tensor arguments are per-LOCAL-entry lists like :class:`XlaGroup`, the
    same length in every process, and a verb runs over all
    ``world_size * len(tensors)`` entries in rank order.

    All members must call each verb in the same order (the NCCL contract).
    """

    def __init__(self, world_size: int, rank: int, group_name: str,
                 device=None):
        BaseGroup.__init__(self, world_size, rank, group_name)
        from ray_tpu_torch._device import resolve_device

        self.device = resolve_device(device)
        self._owns_process_group = False
        self._ensure_distributed()
        import torch.distributed as dist

        if dist.get_world_size() != world_size:
            raise ValueError(
                f"torch.distributed world has {dist.get_world_size()} "
                f"processes; group declared {world_size}")

    def _ensure_distributed(self) -> None:
        """Join the group's process group (idempotent: a process already in
        one — e.g. a Train worker — reuses it)."""
        import datetime

        import torch
        import torch.distributed as dist

        import ray_tpu_torch

        if self.device.type == "cuda":
            if self.device.index is None:
                self.device = torch.device("cuda",
                                           torch.cuda.current_device())
            torch.cuda.set_device(self.device)
        if dist.is_initialized():
            return
        coord, _ = _get_or_create_coordinator(self.group_name,
                                              self.world_size)
        key = "torch_distributed_init"
        if self.rank == 0:
            addr = f"tcp://{_routable_host()}:{_free_port()}"
            ray_tpu_torch.get(coord.set_meta.remote(key, addr))
        else:
            # freshness gate (coordinator's OWN clock, no cross-host
            # skew): a stale address left by a crashed previous
            # incarnation of this group must not be trusted
            addr = None
            deadline = time.monotonic() + 120
            while addr is None and time.monotonic() < deadline:
                addr = ray_tpu_torch.get(
                    coord.get_meta_fresh.remote(key, 120.0))
                if addr is None:
                    time.sleep(0.2)
            if addr is None:
                raise TimeoutError(
                    "rank 0 never published the process group's address")
        backend = "nccl" if self.device.type == "cuda" else "gloo"
        dist.init_process_group(backend, init_method=addr,
                                world_size=self.world_size, rank=self.rank,
                                timeout=datetime.timedelta(seconds=120))
        self._owns_process_group = True

    def destroy(self):
        # clear the rendezvous address so a future incarnation of this
        # group name cannot latch onto a dead coordinator
        try:
            import ray_tpu_torch

            coord, _ = _get_or_create_coordinator(self.group_name,
                                                  self.world_size)
            ray_tpu_torch.get(coord.set_meta.remote("torch_distributed_init",
                                                    None))
        except Exception:
            pass
        if self._owns_process_group:
            import torch.distributed as dist

            if dist.is_initialized():
                dist.destroy_process_group()
            self._owns_process_group = False

    # -- helpers ------------------------------------------------------------

    def _local(self, tensors) -> List[Any]:
        ts = _as_tensors(tensors)
        if not ts:
            raise ValueError("a distributed verb needs at least one local "
                             "entry")
        return ts

    def _gathered(self, stacked):
        """Every process's ``stacked`` ([L, ...] on the group's device),
        concatenated in rank order: [world * L, ...]."""
        import torch
        import torch.distributed as dist

        parts = [torch.empty_like(stacked) for _ in range(self.world_size)]
        dist.all_gather(parts, stacked)
        return torch.cat(parts, dim=0)

    def _reduced(self, ts, op: str):
        """The reduction over every entry of every process, on the group's
        device."""
        import torch.distributed as dist

        dist_ops = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM,
                    "product": dist.ReduceOp.PRODUCT,
                    "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}
        if op not in dist_ops:
            raise ValueError(f"unknown reduce op {op}")
        local = _plain_reduce([t.to(self.device) for t in ts],
                              "sum" if op == "mean" else op)
        local = local.contiguous()
        dist.all_reduce(local, op=dist_ops[op])
        if op == "mean":
            local = local / (self.world_size * len(ts))
        return local

    def _stack(self, ts):
        import torch

        return torch.stack([t.to(self.device) for t in ts]).contiguous()

    # -- verbs ------------------------------------------------------------

    def allreduce(self, tensors: List[Any], op: ReduceOp = ReduceOp.SUM):
        ts = self._local(tensors)
        out = self._reduced(ts, op.value)
        return [out.to(t.device, copy=True) for t in ts]

    def allgather(self, tensors: List[Any]):
        ts = self._local(tensors)
        full = self._gathered(self._stack(ts)).flatten(0, 1)
        return [full.to(t.device, copy=True) for t in ts]

    def reducescatter(self, tensors: List[Any], op: ReduceOp = ReduceOp.SUM):
        ts = self._local(tensors)
        out = self._reduced(ts, op.value)
        n = self.world_size * len(ts)
        if out.shape[0] % n:
            raise ValueError(f"reducescatter: dim 0 ({out.shape[0]}) is "
                             f"not a multiple of the {n} entries")
        pieces = out.split(out.shape[0] // n, dim=0)
        base = self.rank * len(ts)
        return [pieces[base + i].to(t.device, copy=True)
                for i, t in enumerate(ts)]

    def reduce(self, tensors: List[Any], root_rank: int = 0,
               op: ReduceOp = ReduceOp.SUM):
        ts = self._local(tensors)
        out = self._reduced(ts, op.value)
        base = self.rank * len(ts)
        return [out.to(t.device, copy=True) if base + i == root_rank
                else t.clone() for i, t in enumerate(ts)]

    def broadcast(self, tensors: List[Any], root_rank: int = 0):
        import torch.distributed as dist

        ts = self._local(tensors)
        owner, idx = divmod(root_rank, len(ts))
        buf = ts[idx].to(self.device, copy=True).contiguous()
        dist.broadcast(buf, src=owner)
        return [buf.to(t.device, copy=True) for t in ts]

    def permute(self, tensors: List[Any], pairs: List[tuple]):
        ts = self._local(tensors)
        full = list(self._gathered(self._stack(ts)))
        out = plain_permute(full, pairs)
        base = self.rank * len(ts)
        return [out[base + i].to(t.device) for i, t in enumerate(ts)]

    def alltoall(self, chunk_lists: List[Any]):
        import torch

        lists = [_as_tensors(chunks) for chunks in chunk_lists]
        n = self.world_size * len(lists)
        if any(len(chunks) != n for chunks in lists):
            raise ValueError(f"alltoall needs {n} chunks an entry")
        stacked = torch.stack([torch.stack([c.to(self.device)
                                            for c in chunks])
                               for chunks in lists]).contiguous()
        full = self._gathered(stacked)            # [n, n, ...]
        base = self.rank * len(lists)
        return [[full[s, base + i].to(lists[i][0].device, copy=True)
                 for s in range(n)] for i in range(len(lists))]

    def barrier(self):
        import torch

        self.allreduce([torch.zeros((8, 128), dtype=torch.float32,
                                    device=self.device)])


def init_collective_group(world_size: int, rank: int,
                          backend=Backend.STORE,
                          group_name: str = "default",
                          device=None) -> BaseGroup:
    """Declare membership of this process/actor in a named group.
    ``device`` (XLA backends only): ``cuda`` (default) or ``cpu``."""
    backend = Backend.parse(backend)
    with _lock:
        if group_name in _groups:
            raise RuntimeError(f"collective group {group_name!r} already initialized")
        if backend == Backend.STORE:
            g = StoreGroup(world_size, rank, group_name)
        elif backend == Backend.XLA_DISTRIBUTED:
            g = XlaDistributedGroup(world_size, rank, group_name, device)
        else:
            g = XlaGroup(world_size, rank, group_name, device)
        _groups[group_name] = g
        return g


def create_collective_group(actors, world_size: int, ranks: List[int],
                            backend=Backend.STORE,
                            group_name: str = "default"):
    """Driver-side declarative setup (reference ``collective.py:151``).

    Pre-creates the named coordinator so member actors can lazily
    ``init_collective_group`` on first verb without racing on actor
    creation (the reference spawns a named ``Info`` store actor the same
    way). ``actors``/``ranks`` are accepted for API parity; membership is
    claimed by each actor's own init call.
    """
    import ray_tpu_torch

    Backend.parse(backend)
    coord, created = _get_or_create_coordinator(group_name, world_size)
    if created:
        ray_tpu_torch.get(coord.world.remote())  # barrier on creation


def is_group_initialized(group_name: str = "default") -> bool:
    return group_name in _groups


def get_collective_group(group_name: str = "default") -> BaseGroup:
    if group_name not in _groups:
        raise RuntimeError(
            f"collective group {group_name!r} is not initialized in this process"
        )
    return _groups[group_name]


def destroy_collective_group(group_name: str = "default") -> None:
    with _lock:
        g = _groups.pop(group_name, None)
        if g:
            g.destroy()


def get_rank(group_name: str = "default") -> int:
    return get_collective_group(group_name).rank


def get_collective_group_size(group_name: str = "default") -> int:
    return get_collective_group(group_name).world_size


# module-level verbs (reference API shape)

def allreduce(tensor, group_name: str = "default", op: ReduceOp = ReduceOp.SUM):
    return get_collective_group(group_name).allreduce(tensor, op)


def barrier(group_name: str = "default"):
    get_collective_group(group_name).barrier()


def reduce(tensor, dst_rank: int = 0, group_name: str = "default",
           op: ReduceOp = ReduceOp.SUM):
    return get_collective_group(group_name).reduce(tensor, dst_rank, op)


def broadcast(tensor, src_rank: int = 0, group_name: str = "default"):
    return get_collective_group(group_name).broadcast(tensor, src_rank)


def allgather(tensor, group_name: str = "default"):
    return get_collective_group(group_name).allgather(tensor)


def reducescatter(tensor, group_name: str = "default",
                  op: ReduceOp = ReduceOp.SUM):
    return get_collective_group(group_name).reducescatter(tensor, op)


def alltoall(chunks, group_name: str = "default"):
    return get_collective_group(group_name).alltoall(chunks)


def send(tensor, dst_rank: int, group_name: str = "default"):
    get_collective_group(group_name).send(tensor, dst_rank)


def recv(src_rank: int, group_name: str = "default"):
    return get_collective_group(group_name).recv(src_rank)
