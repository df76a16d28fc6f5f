"""The port's collectives (``ray_tpu_torch.collective``) on the CPU.

- ``XlaGroup``'s plain path (CPU tensors, 8 entries) against the JAX
  package's ``XlaGroup`` on its 8-device CPU mesh, in this process, for the
  verb matrix of ``tests/test_collective.py`` (allreduce with each op,
  allgather, reducescatter, reduce, broadcast, permute, send, alltoall,
  barrier): values equal (tolerance 0 for float32 sums of small integers,
  1e-6 relative for the mean).
- ``Backend.parse``: the reference's table of names.
- With the port's runtime (one for the module, a 64 MB store with 16 MB
  prefaulted): ``StoreGroup`` between two actors on torch tensors, and an
  ``XlaDistributedGroup`` over gloo in the same two actor processes with 4
  local entries each, held to the expected values of
  ``tests/test_collective.py:128-204``. Every wait has a 60 s timeout and
  every actor and group is torn down in ``finally``.
"""

import os
import sys

import cloudpickle
import jax
import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu.collective import collective as jcol
from ray_tpu.collective import types as jtypes
from ray_tpu_torch.collective import collective as tcol
from ray_tpu_torch.collective import types as ttypes

STORE_ENV = {"RTPU_STORE_CAPACITY": str(64 << 20),
             "RTPU_STORE_PREFAULT_BYTES": str(16 << 20),
             "RTPU_POOL_PRESTART": "1"}
GET_S = 60
cloudpickle.register_pickle_by_value(sys.modules[__name__])

N = 8


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(-8, 9, (4, 3)).astype(np.float32) for _ in range(N)]


def _verb(g, name, torch_in):
    """One verb of the matrix on group ``g``: numpy inputs for the
    reference, CPU tensors for the port."""
    conv = (lambda a: torch.from_numpy(a)) if torch_in else (lambda a: a)
    ROp = (ttypes if torch_in else jtypes).ReduceOp
    xs = [conv(a) for a in _inputs(0)]
    if name.startswith("allreduce_"):
        return g.allreduce(xs, op=ROp(name.split("_", 1)[1]))
    if name == "allgather":
        return g.allgather(xs)
    if name == "reducescatter":
        return g.reducescatter([conv(np.arange(16, dtype=np.float32)
                                     .reshape(8, 2) + i) for i in range(N)])
    if name == "reduce_sum_root2":
        return g.reduce(xs, root_rank=2, op=ROp.SUM)
    if name == "reduce_max_root0":
        return g.reduce(xs, root_rank=0, op=ROp.MAX)
    if name == "broadcast_root3":
        return g.broadcast(xs, root_rank=3)
    if name == "permute":
        return g.permute(xs, [(1, 6), (0, 7)])
    if name == "send":
        return g.send(xs, dst_rank=4, src_rank=2)
    if name == "alltoall":
        return g.alltoall([[conv(np.full((2,), 10 * i + j, np.float32))
                            for j in range(N)] for i in range(N)])
    if name == "barrier":
        g.barrier()
        return [np.zeros(())]
    raise ValueError(name)


VERBS = ["allreduce_sum", "allreduce_mean", "allreduce_max", "allreduce_min",
         "allreduce_product", "allgather", "reducescatter", "reduce_sum_root2",
         "reduce_max_root0", "broadcast_root3", "permute", "send", "alltoall",
         "barrier"]


@pytest.fixture(scope="module")
def groups():
    assert jax.device_count() == N
    yield (jcol.XlaGroup(N, 0, "matrix"),
           tcol.XlaGroup(N, 0, "matrix", device="cpu"))
    jax.clear_caches()


def _flat(out):
    return [np.asarray(x) for x in out] if not isinstance(out[0], list) \
        else [np.asarray(x) for xs in out for x in xs]


@pytest.mark.parametrize("verb", VERBS)
def test_xla_group_plain_path_matches_reference(groups, verb):
    ref, port = groups
    want = _flat(_verb(ref, verb, torch_in=False))
    got_raw = _verb(port, verb, torch_in=True)
    if verb != "barrier":
        flat = (got_raw if not isinstance(got_raw[0], list)
                else [x for xs in got_raw for x in xs])
        assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu"
                   for t in flat)
    got = _flat(got_raw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape, verb
        np.testing.assert_allclose(g, w, rtol=1e-6 if "mean" in verb else 0,
                                   atol=0, err_msg=verb)


def test_xla_group_holds_the_reference_test_values(groups):
    """``tests/test_collective.py::test_xla_group_full_verb_matrix``'s
    expected values, on the port."""
    _, g = groups
    ts = [torch.full((4,), float(i + 1)) for i in range(N)]
    out = g.reduce(ts, root_rank=2)
    assert torch.equal(out[2], torch.full((4,), float(sum(range(1, N + 1)))))
    for i in (0, 1, 3, 7):
        assert torch.equal(out[i], ts[i])
    assert torch.equal(g.reduce(ts, root_rank=0, op=ttypes.ReduceOp.MAX)[0],
                       torch.full((4,), float(N)))
    assert all(torch.equal(o, ts[3]) for o in g.broadcast(ts, root_rank=3))
    out = g.permute(ts, [(1, 6), (0, 7)])
    assert torch.equal(out[6], ts[1]) and torch.equal(out[7], ts[0])
    assert torch.equal(out[0], ts[0]) and torch.equal(out[5], ts[5])
    assert torch.equal(g.send(ts, dst_rank=4, src_rank=2)[4], ts[2])
    chunks = [[torch.full((2,), float(10 * i + j)) for j in range(N)]
              for i in range(N)]
    out = g.alltoall(chunks)
    assert all(torch.equal(out[i][j], chunks[j][i])
               for i in range(N) for j in range(N))
    np.testing.assert_allclose(g.allreduce(ts, op=ttypes.ReduceOp.MEAN)[0],
                               np.full((4,), (N + 1) / 2))
    gathered = g.allgather([torch.full((1, 128), float(i)) for i in range(N)])
    assert gathered[0].shape == (N, 128)


def test_xla_group_checks_its_entries():
    g = tcol.XlaGroup(2, 0, "entries", device="cpu")
    with pytest.raises(ValueError, match="2 entries, got 3"):
        g.allreduce([torch.zeros(2)] * 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcol.XlaGroup(1, 0, "card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcol.XlaDistributedGroup(1, 0, "card")


@pytest.mark.parametrize("name", ["xla", "tpu", "ici", "xla_distributed",
                                  "jax_distributed", "distributed",
                                  "multiprocess", "store", "cpu", "gloo",
                                  "nccl", "mpi", "bogus"])
def test_backend_parse_keeps_the_reference_table(name):
    def parse(mod):
        try:
            return mod.Backend.parse(name).value
        except ValueError as e:
            return type(e).__name__
    assert parse(ttypes) == parse(jtypes)


# -- between actors ------------------------------------------------------------

@pytest.fixture(scope="module")
def runtime():
    saved = {k: os.environ.get(k) for k in STORE_ENV}
    os.environ.update(STORE_ENV)
    rt.init(num_cpus=4)
    yield
    rt.shutdown()
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


class Member:
    """One rank of both groups: ``g_store`` (STORE) and ``g_dist``
    (XLA_DISTRIBUTED over gloo, 4 local entries)."""

    def __init__(self, rank, world):
        self.rank, self.world = rank, world

    def setup_store(self):
        from ray_tpu_torch import collective as col

        col.init_collective_group(self.world, self.rank, "store", "g_store")
        return True

    def store_verbs(self):
        import torch

        from ray_tpu_torch import collective as col

        out = {"allreduce": col.allreduce(
            torch.full((4,), float(self.rank + 1)), "g_store")}
        out["bcast"] = col.broadcast(torch.full((2,), float(self.rank)), 1,
                                     "g_store")
        out["gather"] = col.allgather(torch.tensor([self.rank]), "g_store")
        if self.rank == 0:
            col.send(torch.tensor([42.0]), 1, "g_store")
        else:
            out["recv"] = col.recv(0, "g_store")
        out["numpy"] = col.allreduce(np.full((2,), 1.5), "g_store")
        col.barrier("g_store")
        return out

    def setup_dist(self):
        import torch.distributed as dist

        from ray_tpu_torch.collective.collective import init_collective_group

        init_collective_group(self.world, self.rank, "xla_distributed",
                              "g_dist", device="cpu")
        return dist.get_world_size(), dist.get_rank(), dist.get_backend()

    def dist_verbs(self):
        import numpy as np
        import torch

        from ray_tpu_torch.collective.collective import get_collective_group

        g = get_collective_group("g_dist")
        nloc = 4
        base = self.rank * nloc
        mine = [torch.full((2,), float(base + i)) for i in range(nloc)]
        out = {"allreduce": g.allreduce(mine),
               "allgather": g.allgather(mine),
               "bcast": g.broadcast(mine, root_rank=5),
               "reduce": g.reduce(mine, root_rank=2),
               "rscatter": g.reducescatter(
                   [torch.arange(8, dtype=torch.float64)
                    for _ in range(nloc)])}
        chunks = [[torch.full((1,), float(base + i) * 10 + j)
                   for j in range(8)] for i in range(nloc)]
        out["alltoall"] = g.alltoall(chunks)
        out["permute"] = g.permute(mine, [(1, 6), (6, 0)])
        g.barrier()
        return {k: [[np.asarray(x) for x in v] if isinstance(v, list)
                    else np.asarray(v) for v in vs] for k, vs in out.items()}

    def teardown(self):
        from ray_tpu_torch import collective as col

        for name in ("g_dist", "g_store"):
            col.destroy_collective_group(name)
        return True


def test_store_and_distributed_groups_between_actors(runtime):
    from ray_tpu_torch.collective import create_collective_group

    world = 2
    members = []
    try:
        create_collective_group([], world, [0, 1], "store", "g_store")
        create_collective_group([], world, [0, 1], "xla_distributed",
                                "g_dist")
        members = [rt.remote(Member).options(runtime_env={"env_vars": {
            "OMP_NUM_THREADS": "1"}}).remote(r, world) for r in range(world)]
        assert all(rt.get([m.setup_store.remote() for m in members],
                          timeout=GET_S))

        outs = rt.get([m.store_verbs.remote() for m in members],
                      timeout=GET_S)
        for out in outs:
            assert isinstance(out["allreduce"], torch.Tensor)
            assert torch.equal(out["allreduce"], torch.full((4,), 3.0))
            assert torch.equal(out["bcast"], torch.full((2,), 1.0))
            assert torch.equal(torch.cat(out["gather"]), torch.tensor([0, 1]))
            # a numpy input comes back as the reference returns it
            assert isinstance(out["numpy"], np.ndarray)
            np.testing.assert_allclose(out["numpy"], np.full((2,), 3.0))
        assert torch.equal(outs[1]["recv"], torch.tensor([42.0]))

        infos = rt.get([m.setup_dist.remote() for m in members],
                       timeout=GET_S)
        assert infos == [(2, 0, "gloo"), (2, 1, "gloo")]
        outs = rt.get([m.dist_verbs.remote() for m in members],
                      timeout=GET_S)
        total = sum(range(8))  # entry d holds value d
        for rank, out in enumerate(outs):
            base = rank * 4
            for arr in out["allreduce"]:
                np.testing.assert_allclose(arr, np.full((2,), float(total)))
            for arr in out["allgather"]:
                np.testing.assert_allclose(
                    arr, np.repeat(np.arange(8.0), 2).reshape(-1))
            for arr in out["bcast"]:
                np.testing.assert_allclose(arr, np.full((2,), 5.0))
            for i, arr in enumerate(out["reduce"]):
                want = float(total) if base + i == 2 else float(base + i)
                np.testing.assert_allclose(arr, np.full((2,), want))
            for i, arr in enumerate(out["rscatter"]):
                np.testing.assert_allclose(arr, [float(base + i) * 8])
            for i, got_chunks in enumerate(out["alltoall"]):
                want = [float(s) * 10 + (base + i) for s in range(8)]
                np.testing.assert_allclose(np.concatenate(got_chunks), want)
            # entry 6 takes entry 1's tensor, entry 0 entry 6's
            want = {0: 6.0, 6: 1.0}
            for i, arr in enumerate(out["permute"]):
                np.testing.assert_allclose(
                    arr, np.full((2,), want.get(base + i, float(base + i))))
    finally:
        if members:
            try:
                rt.get([m.teardown.remote() for m in members], timeout=GET_S)
            finally:
                for m in members:
                    rt.kill(m)
