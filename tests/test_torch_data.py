"""The port's data library (``ray_tpu_torch.data``) on the CPU, against the
JAX package's ``ray_tpu.data``.

- Without a runtime: the block, plan, optimizer, partition, reduce and
  exchange functions of both packages on the same seeded numpy inputs,
  results equal (tolerance 0, dtypes too); a streaming exchange's reducers
  driven in process with the store stubbed, both packages giving the same
  rows in the same order; ``iter_torch_batches(device="cpu")`` against the
  reference's ``iter_torch_batches`` and ``iter_jax_batches``; the default
  device raising with no card.
- With the port's runtime (one for the module, a 64 MB store with 16 MB
  prefaulted and one prestarted worker): the runtime cases of
  ``tests/test_data.py`` and ``tests/test_data_streaming.py``, held to
  those tests' expected values, and a seeded ``random_shuffle``'s row order
  equal to the reference's (its reducers run in process, no second
  runtime). Left out: the 2 M-row driver-RSS case (128 MB of blocks, past
  this store) and the out-of-core case (``slow`` in the reference).
"""

import os
import sys
import threading
import time

import cloudpickle
import jax
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch as rt
from ray_tpu import data as jdata
from ray_tpu.data import execution as jex
from ray_tpu.data import grouped as jgrouped
from ray_tpu.data import iterator as jiter
from ray_tpu.data import streaming as jstream
from ray_tpu_torch import data as tdata
from ray_tpu_torch.data import execution as tex
from ray_tpu_torch.data import grouped as tgrouped
from ray_tpu_torch.data import iterator as titer
from ray_tpu_torch.data import streaming as tstream

STORE_ENV = {"RTPU_STORE_CAPACITY": str(64 << 20),
             "RTPU_STORE_PREFAULT_BYTES": str(16 << 20),
             "RTPU_POOL_PRESTART": "1"}
# the classes and functions below travel to the workers by value (a test
# module is not importable there)
cloudpickle.register_pickle_by_value(sys.modules[__name__])

PKGS = {"ref": (jdata, jex, jgrouped, jstream, jiter),
        "port": (tdata, tex, tgrouped, tstream, titer)}


def _same(a, b, path="out"):
    """Equal values, types and dtypes, recursively."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), (path, a, b)
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, (path, a, b)
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif type(a).__name__ == "BlockMetadata":
        assert (a.num_rows, a.size_bytes, a.schema) == (
            b.num_rows, b.size_bytes, b.schema), path
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def _blocks(seed=0, n_blocks=5, rows=13):
    rng = np.random.default_rng(seed)
    return [{"key": rng.integers(0, 50, rows),
             "val": rng.standard_normal(rows).astype(np.float32),
             "name": np.asarray([f"n{int(k) % 7}" for k in
                                 rng.integers(0, 100, rows)])}
            for _ in range(n_blocks)]


# -- pure functions, both packages on the same inputs -------------------------

def _block_cases(pkg):
    data, ex, grouped, stream, it = pkg
    from importlib import import_module

    blk = import_module(data.__name__ + ".block")
    b = _blocks()
    rows = [{"a": i, "b": float(i) / 2} for i in range(7)]
    return {
        "from_rows": blk.block_from_rows(rows),
        "from_scalars": blk.block_from_rows([3, 1, 2]),
        "to_rows": blk.block_to_rows(b[0])[:3],
        "num_rows": [blk.block_num_rows(x) for x in b + [{}]],
        "size_bytes": blk.block_size_bytes(b[1]),
        "metadata": blk.block_metadata(b[2]),
        "slice": blk.block_slice(b[0], 2, 9),
        "take": blk.block_take(b[0], np.array([5, 0, 5, 12])),
        "concat": blk.concat_blocks([b[0], {}, b[1]]),
        "batch_to_block": blk.batch_to_block({"x": [1, 2, 3]}),
        "pandas": blk.batch_to_block(blk.block_to_batch(b[3], "pandas")),
    }


def _plan_cases(pkg):
    data, ex, grouped, stream, it = pkg

    def m(name):
        return ex.MapOp(name=name, fn=lambda blk: [blk])

    plans = {
        "golden": [m("a"), ex.ShuffleOp("s1", "random_shuffle"),
                   ex.ShuffleOp("s2", "repartition", {"n": 4}), m("b"),
                   m("c"), ex.LimitOp("l1", 100), ex.LimitOp("l2", 10)],
        "rep_rep": [ex.ShuffleOp("r1", "repartition", {"n": 8}),
                    ex.ShuffleOp("r2", "repartition", {"n": 2})],
        "seeded": [ex.ShuffleOp("s1", "random_shuffle"),
                   ex.ShuffleOp("s2", "random_shuffle", {"seed": 7})],
        "composed": [m("x"), ex.ShuffleOp("s", "random_shuffle"),
                     ex.ShuffleOp("s2", "random_shuffle")],
        "collapse": [ex.ShuffleOp("repartition", "repartition",
                                  {"num_blocks": 6}),
                     ex.ShuffleOp("random_shuffle", "random_shuffle",
                                  {"seed": None})],
        "collapse_seeded": [ex.ShuffleOp("repartition", "repartition",
                                         {"num_blocks": 6}),
                            ex.ShuffleOp("random_shuffle", "random_shuffle",
                                         {"seed": 3})],
    }
    out = {}
    for name, plan in plans.items():
        opt = data.Optimizer().optimize(plan)
        out[name] = (data.plan_summary(opt),
                     [getattr(op, "args", None) for op in opt],
                     data.plan_summary(data.Optimizer(
                         rules=[data.FuseLimits()]).optimize(plan)),
                     data.plan_summary(data.Optimizer(rules=[]).optimize(
                         plan)),
                     [op.name for op in ex.fuse_ops(plan)])
    return out


def _exchange_fn_cases(pkg):
    data, ex, grouped, stream, it = pkg
    b = _blocks(seed=1)
    out = {}
    for kind, args in (("random_shuffle", {"seed": 5}),
                       ("sort", {"key": "key",
                                 "boundaries": np.array([10, 25, 40])}),
                       ("sort", {"key": "key", "descending": True,
                                 "boundaries": np.array([10, 25, 40])}),
                       ("repartition", {"global_start": 6,
                                        "target_size": 9})):
        tag = f"{kind}{'_desc' if args.get('descending') else ''}"
        parts = [ex._shuffle_partition(blk, 4, kind, args, i)
                 for i, blk in enumerate(b)]
        out[f"partition_{tag}"] = parts
        out[f"exchange_partition_{tag}"] = stream._exchange_partition(
            b[0], 4, kind, args, 3)
    out["partition_rows"] = ex._partition_rows(b[0], np.arange(13) % 3, 3)
    out["hash_int"] = grouped._hash_assign(b[0]["key"], 5)
    out["hash_str"] = grouped._hash_assign(b[0]["name"], 5)
    out["group_block"] = grouped._group_block(b[1], "name")
    out["partition_by_key"] = grouped._partition_by_key(b[2], "key", 3)
    out["exchange_partition_groupby"] = stream._exchange_partition(
        b[2], 3, "groupby_agg", {"key": "name"}, 0)
    out["chunk_rows"] = list(stream._chunk_rows(b, 17))
    runs = []
    for blk in b:
        order = np.argsort(blk["key"], kind="stable")
        runs.append({k: v[order] for k, v in blk.items()})
    out["merge_sorted"] = list(stream._merge_sorted_blocks(runs, "key",
                                                           window=4))
    accs = {}
    for op in ("count", "sum", "min", "max", "mean", "std"):
        cur = None
        for blk in b:
            cur = stream._acc_update(op, cur, blk, "val")
        accs[op] = stream._acc_finalize(op, cur)
    out["accumulators"] = accs
    return out


def _batching_cases(pkg):
    data, ex, grouped, stream, it = pkg
    b = _blocks(seed=2, n_blocks=4, rows=11)
    out = {}
    for size, drop in ((4, False), (4, True), (11, False), (30, False)):
        for prefetch in (0, 1):
            out[f"{size}_{drop}_{prefetch}"] = list(
                it.iter_batches_from_blocks(iter(b), batch_size=size,
                                            drop_last=drop,
                                            prefetch_batches=prefetch))
    return out


def _case_table():
    cases = {}
    for group in (_block_cases, _plan_cases, _exchange_fn_cases,
                  _batching_cases):
        for name in group(PKGS["ref"]):
            cases[f"{group.__name__[1:-6]}.{name}"] = (group, name)
    return cases


CASES = _case_table()


@pytest.mark.parametrize("case", sorted(CASES))
def test_pure_functions_match_reference(case):
    group, name = CASES[case]
    _same(group(PKGS["ref"])[name], group(PKGS["port"])[name])


def test_optimizer_golden_plans_hold_the_reference_values():
    """The expected values of ``test_data.py::test_optimizer_golden_plans``
    and ``test_data_streaming.py::test_optimizer_collapses_repartition_into
    _shuffle``, on the port."""
    out = _plan_cases(PKGS["port"])
    assert out["golden"][0] == ["map:a", "shuffle:random_shuffle",
                                "shuffle:repartition", "map:b->c",
                                "limit:10"]
    assert out["rep_rep"][0] == ["shuffle:repartition"]
    assert len(out["seeded"][0]) == 2
    assert out["composed"][0] == ["map:x", "shuffle:random_shuffle"]
    assert out["golden"][2][-1] == "limit:10" and "map:b" in out["golden"][2]
    assert out["golden"][3] == [
        "map:a", "shuffle:random_shuffle", "shuffle:repartition", "map:b",
        "map:c", "limit:100", "limit:10"]
    assert out["collapse"][0] == ["shuffle:random_shuffle"]
    assert out["collapse"][1][0]["num_blocks"] == 6
    assert len(out["collapse_seeded"][0]) == 2
    assert (tdata.EliminateRedundantShuffles().name
            == "EliminateRedundantShuffles")


# -- a streaming exchange's reducers, in process ------------------------------

def _stub_store(monkeypatch, pkg):
    """The package's put / get / free over a dict: a reducer can stage and
    assemble its blocks with no runtime."""
    store, ids = {}, iter(range(1 << 30))

    def put(x):
        key = ("ref", next(ids))
        store[key] = x
        return key

    def free(refs):
        for r in (refs if isinstance(refs, list) else [refs]):
            store.pop(r, None)

    monkeypatch.setattr(pkg, "put", put)
    monkeypatch.setattr(pkg, "get", lambda r: store[r])
    monkeypatch.setattr(pkg, "free", free)


def exchange_in_process(stream, kind, args, blocks, reducers=4):
    """The scheduler's routing (``_ExchangeScheduler.run``): input block i
    is partition task i, partition j goes to reducer j % R with order key
    i, and the output is each partition's ``finish`` in partition order.
    The partition function and the reducer are the package's own."""
    n_red = int(args.get("num_blocks") or reducers)
    reds = [stream._ExchangeReducer(kind, cloudpickle.dumps(args))
            for _ in range(min(reducers, n_red))]
    for i, blk in enumerate(blocks):
        for j, part in enumerate(stream._exchange_partition(
                blk, n_red, kind, dict(args), i)):
            reds[j % len(reds)].add_block(j, i, part)
    out = []
    for j in range(n_red):
        out.extend(reds[j % len(reds)].finish(j))
    return out


def reference_shuffle_ids(monkeypatch, n, parallelism, seed, num_blocks=None):
    """The JAX package's seeded ``range(n).random_shuffle`` row order, by its
    own partition function and reducers (store stubbed, no runtime)."""
    size = (n + parallelism - 1) // parallelism
    blocks = [{"id": np.arange(i, min(i + size, n), dtype=np.int64)}
              for i in range(0, n, size)]
    with monkeypatch.context() as m:
        _stub_store(m, ray_tpu)
        out = exchange_in_process(jstream, "random_shuffle",
                                  {"seed": seed, "num_blocks": num_blocks},
                                  blocks)
    return [int(x) for blk in out for x in blk["id"]]


@pytest.mark.parametrize("kind,args", [
    ("random_shuffle", {"seed": 11, "num_blocks": None}),
    ("random_shuffle", {"seed": 3, "num_blocks": 3}),
    ("sort", {"key": "key", "boundaries": np.array([12, 30]),
              "num_blocks": 3}),
    ("sort", {"key": "name", "descending": True,
              "boundaries": np.array(["n2", "n4"]), "num_blocks": 3}),
    ("groupby_agg", {"key": "name", "specs": [("count", None, "count()"),
                                              ("mean", "val", "mean(val)"),
                                              ("std", "val", "std(val)")]}),
], ids=["shuffle", "shuffle_3", "sort", "sort_str_desc", "groupby_agg"])
def test_exchange_reducers_match_reference(monkeypatch, kind, args):
    blocks = _blocks(seed=4, n_blocks=6, rows=17)
    outs = []
    for pkg, stream in ((ray_tpu, jstream), (rt, tstream)):
        with monkeypatch.context() as m:
            _stub_store(m, pkg)
            outs.append(exchange_in_process(stream, kind, dict(args),
                                            blocks))
    _same(outs[0], outs[1])


# -- iter_torch_batches on the CPU --------------------------------------------

class _BlockList:
    """A stand-in dataset whose refs are the blocks themselves (``get`` is
    stubbed to the identity)."""

    def __init__(self, blocks):
        self.blocks = blocks

    def iter_block_refs(self):
        return iter(self.blocks)


def _token_blocks():
    rng = np.random.default_rng(7)
    return [{"tokens": rng.integers(0, 60000, (n, 9)).astype(np.uint16),
             "w": rng.standard_normal(n).astype(np.float32)}
            for n in (5, 8, 3, 9)]


@pytest.mark.parametrize("batch_size,drop_last", [(4, False), (4, True),
                                                  (7, False), (32, False)])
def test_cpu_batches_equal_reference_iter_torch_batches(
        monkeypatch, batch_size, drop_last):
    monkeypatch.setattr(ray_tpu, "get", lambda r: r)
    monkeypatch.setattr(rt, "get", lambda r: r)
    blocks = [{"id": np.arange(i, i + 6, dtype=np.int64),
               "x": np.full((6, 3), float(i), np.float32)}
              for i in range(0, 30, 6)]
    want = list(jiter.DataIterator(_BlockList(blocks)).iter_torch_batches(
        batch_size=batch_size, drop_last=drop_last))
    got = list(titer.DataIterator(_BlockList(blocks)).iter_torch_batches(
        batch_size=batch_size, drop_last=drop_last, device="cpu"))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in g:
            assert g[k].dtype == w[k].dtype and g[k].device.type == "cpu"
            assert torch.equal(g[k], w[k]), k


@pytest.mark.parametrize("dtype", [torch.int32, np.int32],
                         ids=["torch_dtype", "numpy_dtype"])
def test_cpu_batches_with_dtypes_equal_reference_jax_batches(monkeypatch,
                                                              dtype):
    """``dtypes`` casts as the reference's ``iter_jax_batches`` does: uint16
    tokens to int32, float32 kept."""
    monkeypatch.setattr(ray_tpu, "get", lambda r: r)
    monkeypatch.setattr(rt, "get", lambda r: r)
    blocks = _token_blocks()
    want = list(jiter.DataIterator(_BlockList(blocks)).iter_jax_batches(
        batch_size=4, drop_last=True, dtypes={"tokens": np.int32}))
    got = list(titer.DataIterator(_BlockList(blocks)).iter_torch_batches(
        batch_size=4, drop_last=True, device="cpu",
        dtypes={"tokens": dtype}))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g["tokens"].dtype == torch.int32
        np.testing.assert_array_equal(g["tokens"].numpy(),
                                      np.asarray(w["tokens"]))
        np.testing.assert_array_equal(g["w"].numpy(), np.asarray(w["w"]))
    jax.clear_caches()


def test_default_device_raises_without_a_card():
    it = titer.DataIterator(_BlockList(_token_blocks()))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        it.iter_torch_batches(batch_size=4)


def test_mesh_with_sharded_axes_raises(monkeypatch):
    from ray_tpu_torch.parallel import make_mesh

    monkeypatch.setattr(rt, "get", lambda r: r)
    it = titer.DataIterator(_BlockList(_token_blocks()))
    # the one-rank mesh: this process's batches, as without one
    assert len(list(it.iter_torch_batches(batch_size=4, device="cpu",
                                          mesh=make_mesh()))) == 7

    class TwoCardTp:
        mesh_dim_names = ("dp", "fsdp", "tp")
        shape = (1, 1, 2)

    with pytest.raises(NotImplementedError, match="queue 1 item 5"):
        it.iter_torch_batches(batch_size=4, device="cpu", mesh=TwoCardTp())


def test_iterator_pickles_with_its_split(monkeypatch):
    monkeypatch.setattr(rt, "get", lambda r: r)
    it = titer.DataIterator(_BlockList(_token_blocks()), 1, 2)
    back = cloudpickle.loads(cloudpickle.dumps(it))
    assert (back._split, back._num_splits) == (1, 2)
    assert [b["tokens"].tolist() for b in back.iter_batches(batch_size=3)] \
        == [b["tokens"].tolist() for b in it.iter_batches(batch_size=3)]


def test_knobs_match_reference():
    """The port's ``data_*`` knobs are the reference's, names and defaults,
    less ``data_streaming_exchange``: the port keeps only the streaming
    exchange."""
    from ray_tpu import config as jcfg
    from ray_tpu_torch import config as tcfg

    ref = [r["name"] for r in jcfg.describe() if r["name"].startswith(
        "data_")]
    names = [r["name"] for r in tcfg.describe() if r["name"].startswith(
        "data_")]
    assert sorted(set(ref) - set(names)) == ["data_streaming_exchange"]
    assert len(names) == 5 and set(names) < set(ref)
    for name in names:
        assert tcfg.env_name(name) == jcfg.env_name(name)
        assert tcfg.get(name) == jcfg.get(name)


# -- the runtime cases of tests/test_data.py and test_data_streaming.py ------

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


def case_range_count_take(ctx):
    ds = tdata.range(100, parallelism=4)
    assert ds.count() == 100
    assert [r["id"] for r in ds.take(5)] == [0, 1, 2, 3, 4]


def case_map_batches_and_fusion(ctx):
    ds = (tdata.range(64, parallelism=4)
          .map_batches(lambda b: {"id": b["id"] * 2})
          .map_batches(lambda b: {"id": b["id"] + 1}))
    assert [r["id"] for r in ds.take_all()] == [2 * i + 1 for i in range(64)]
    assert len(tex.fuse_ops(ds._ops)) == 1


def case_map_filter_flat_map(ctx):
    ds = tdata.range(10, parallelism=2).map(lambda r: {"x": int(r["id"]) * 10})
    ds = ds.filter(lambda r: r["x"] >= 50)
    ds = ds.flat_map(lambda r: [{"x": r["x"]}, {"x": r["x"] + 1}])
    assert [r["x"] for r in ds.take_all()] == [50, 51, 60, 61, 70, 71, 80,
                                               81, 90, 91]


def case_shuffle_sort_repartition(ctx):
    ds = tdata.range(50, parallelism=5).random_shuffle(seed=7)
    shuffled = [int(r["id"]) for r in ds.take_all()]
    assert sorted(shuffled) == list(range(50))
    assert shuffled != list(range(50))
    # the reference's rows, in the reference's order
    assert shuffled == reference_shuffle_ids(ctx["monkeypatch"], 50, 5, 7)
    assert [r["id"] for r in ds.sort("id", descending=True).take(3)] == [
        49, 48, 47]
    assert ds.repartition(3).num_blocks() == 3


def case_seeded_shuffle_order_matches_reference(ctx):
    for n, par, seed, nb in ((1000, 10, 7, None), (333, 7, 2, 5)):
        got = [int(r["id"]) for r in tdata.range(n, parallelism=par)
               .random_shuffle(seed=seed, num_blocks=nb).take_all()]
        assert got == reference_shuffle_ids(ctx["monkeypatch"], n, par,
                                            seed, nb), (n, seed)


def case_limit_and_union_zip(ctx):
    a = tdata.range(10, parallelism=2).limit(4)
    assert a.count() == 4
    z = a.zip(tdata.from_items([{"y": i} for i in range(4)]))
    assert set(z.take_all()[0]) == {"id", "y"}
    assert a.union(a).count() == 8


def case_groupby_aggregates(ctx):
    items = [{"k": i % 3, "v": float(i)} for i in range(12)]
    ds = tdata.from_items(items, parallelism=3)
    counts = {r["k"]: r["count()"] for r in ds.groupby("k").count().take_all()}
    assert counts == {0: 4, 1: 4, 2: 4}
    means = {r["k"]: r["mean(v)"] for r in ds.groupby("k").mean("v").take_all()}
    assert means[0] == pytest.approx(np.mean([0, 3, 6, 9]))


def case_iter_batches_exact_sizes(ctx):
    ds = tdata.range(100, parallelism=7)
    assert [len(b["id"]) for b in ds.iter_batches(batch_size=32)] == [
        32, 32, 32, 4]
    assert [len(b["id"]) for b in ds.iter_batches(
        batch_size=32, drop_last=True)] == [32, 32, 32]


def case_streaming_split_covers_all(ctx):
    ds = tdata.range(40, parallelism=4).materialize()
    seen = [r["id"] for it in ds.streaming_split(2) for r in it.iter_rows()]
    assert sorted(seen) == list(range(40))


def case_iter_torch_batches_from_the_runtime(ctx):
    it = tdata.range(64, parallelism=4).iterator()
    batches = list(it.iter_torch_batches(batch_size=16, device="cpu",
                                         dtypes={"id": torch.int32}))
    assert len(batches) == 4
    assert batches[0]["id"].dtype == torch.int32
    assert torch.equal(torch.cat([b["id"] for b in batches]),
                       torch.arange(64, dtype=torch.int32))


def case_write_read_roundtrip(ctx):
    tmp = ctx["tmp"]
    ds = tdata.from_items([{"a": i, "b": float(i) / 2} for i in range(20)],
                          parallelism=2)
    ds.write_parquet(os.path.join(tmp, "pq"))
    back = tdata.read_parquet(os.path.join(tmp, "pq"))
    assert back.count() == 20
    assert back.sum("a") == sum(range(20))
    ds.write_csv(os.path.join(tmp, "csv"))
    assert tdata.read_csv(os.path.join(tmp, "csv")).count() == 20
    ds.write_json(os.path.join(tmp, "js"))
    assert tdata.read_json(os.path.join(tmp, "js")).count() == 20


def case_read_numpy_shards(ctx):
    d = os.path.join(ctx["tmp"], "npy")
    os.makedirs(d)
    rng = np.random.default_rng(0)
    shards = [rng.integers(0, 32000, (6, 5)).astype(np.uint16)
              for _ in range(3)]
    for i, s in enumerate(shards):
        np.save(os.path.join(d, f"shard_{i:03d}.npy"), s)
    ds = tdata.read_numpy(d).map_batches(lambda b: {"tokens": b["data"]})
    got = np.concatenate([b["tokens"] for b in ds.iter_batches(
        batch_size=4)])
    np.testing.assert_array_equal(got, np.concatenate(shards))
    assert got.dtype == np.uint16


def case_columns_schema_stats(ctx):
    ds = tdata.from_items([{"a": 1, "b": 2.0}])
    assert set(ds.columns()) == {"a", "b"}
    assert ds.mean("b") == 2.0
    assert ds.min("a") == 1


def case_iteration_overlaps_producer(ctx):
    @rt.remote
    def warm():
        return None

    rt.get([warm.remote() for _ in range(4)], timeout=60)

    def slow_identity(batch):
        time.sleep(0.4)
        return batch

    ds = tdata.range(8, parallelism=8).map_batches(slow_identity)
    t0 = time.monotonic()
    it = iter(ds.iter_batches(batch_size=1))
    next(it)
    first_latency = time.monotonic() - t0
    total = sum(1 for _ in it) + 1
    wall = time.monotonic() - t0
    assert total == 8
    assert first_latency < wall * 0.75, (first_latency, wall)


def case_arrow_roundtrip(ctx):
    import pyarrow as pa

    table = pa.table({"x": [1, 2, 3, 4], "y": [0.5, 1.5, 2.5, 3.5]})
    out = tdata.from_arrow(table).map_batches(
        lambda b: {"x": b["x"] * 2, "y": b["y"]}).to_arrow()
    assert out.column("x").to_pylist() == [2, 4, 6, 8]
    assert out.column("y").to_pylist() == [0.5, 1.5, 2.5, 3.5]


def case_arrow_tensor_columns(ctx):
    import pyarrow as pa

    ds = tdata.from_items([{"vec": np.arange(3, dtype=np.float32) + i}
                           for i in range(4)])
    table = ds.to_arrow()
    assert isinstance(table, pa.Table)
    assert table.column("vec").to_pylist()[0] == [0.0, 1.0, 2.0]


class AddPid:
    def __init__(self):
        self._pid = os.getpid()

    def __call__(self, batch):
        batch["pid"] = np.full(len(batch["id"]), self._pid)
        return batch


def case_actor_pool_map_operator(ctx):
    ds = tdata.range(64, parallelism=8).map_batches(
        AddPid, compute=tdata.ActorPoolStrategy(min_size=1, max_size=2))
    out = ds.take_all()
    assert sorted(r["id"] for r in out) == list(range(64))
    assert 1 <= len({r["pid"] for r in out}) <= 2


def case_distributed_shuffle_and_sort(ctx):
    shuffled = tdata.range(1000, parallelism=10).random_shuffle(
        seed=7).take_all()
    assert sorted(r["id"] for r in shuffled) == list(range(1000))
    assert [r["id"] for r in shuffled] != list(range(1000))
    ds2 = tdata.from_items([{"k": int(v)} for v in
                            np.random.default_rng(0).permutation(500)])
    assert [r["k"] for r in ds2.sort("k").take_all()] == list(range(500))
    assert [r["k"] for r in ds2.sort("k", descending=True).take_all()] == \
        list(range(499, -1, -1))


def case_repartition_balances_rows(ctx):
    blocks = list(tdata.range(100, parallelism=7).repartition(4)
                  .iter_blocks())
    sizes = [len(b["id"]) for b in blocks if len(b["id"])]
    assert sum(sizes) == 100
    assert max(sizes) - min(sizes) <= 1 or len(sizes) == 4


def case_groupby_string_keys_stable_across_workers(ctx):
    names = ["alpha", "beta", "gamma", "delta", "epsilon"]
    rows = [{"name": names[i % 5], "v": float(i)} for i in range(500)]
    out = tdata.from_items(rows).groupby("name").count().take_all()
    assert sorted(r["name"] for r in out) == sorted(names)
    assert all(r["count()"] == 100 for r in out)


def case_backpressure_policies_bound_concurrency(ctx):
    ds = tdata.range(40, parallelism=8).map(lambda r: {"v": r["id"] * 2})
    ds._options = tdata.ExecutionOptions(
        max_in_flight=8,
        backpressure_policies=(tdata.ConcurrencyCapBackpressurePolicy(2),))
    assert sorted(r["v"] for r in ds.iter_rows()) == [i * 2 for i in
                                                      range(40)]


def case_redundant_shuffle_dropped_end_to_end(ctx):
    ds = tdata.range(30, parallelism=4).random_shuffle().random_shuffle()
    assert sorted(r["id"] for r in ds.iter_rows()) == list(range(30))


def case_read_images_tensor_column(ctx):
    from PIL import Image

    d = os.path.join(ctx["tmp"], "img")
    os.makedirs(d)
    for i in range(3):
        Image.new("RGB", (10 + i, 8 + i), (i * 40, 0, 0)).save(
            os.path.join(d, f"img{i}.png"))
    ds = tdata.read_images(d, size=(16, 12))
    assert len(ds.take_all()) == 3
    batch = next(iter(ds.iter_batches(batch_size=3)))
    assert batch["image"].shape == (3, 16, 12, 3)
    assert batch["image"].dtype == np.uint8
    assert tdata.read_images(d).take_all()[0]["image"].shape[-1] == 3


class _NoopOptimizer:
    def optimize(self, ops):
        return ops


def _fast(block):
    t0 = time.monotonic()
    time.sleep(0.05)
    return [{**block, "fast_iv": np.array([t0, time.monotonic()])}]


def _slow(block):
    t0 = time.monotonic()
    time.sleep(0.2)
    return [{**block, "slow_iv": np.array([t0, time.monotonic()])}]


def case_topology_overlaps_fast_and_slow_stages(ctx):
    blocks = [{"i": np.array([i])} for i in range(8)]

    def make_ops():
        return [tex.MapOp("fast_decode", _fast),
                tex.MapOp("slow_ingest", _slow,
                          compute=tex.ActorPoolStrategy(
                              min_size=2, max_size=2,
                              max_tasks_in_flight_per_actor=2))]

    opts = tex.ExecutionOptions(max_in_flight=2, optimizer=_NoopOptimizer())
    list(tex.execute_streaming(iter(blocks[:2]), make_ops(), opts))
    out = [rt.get(r, timeout=60) for r in
           tex.execute_streaming(iter(blocks), make_ops(), opts)]
    assert sorted(int(b["i"][0]) for b in out) == list(range(8))
    overlap = any(f[0] < s[1] and s[0] < f[1]
                  for f in (b["fast_iv"] for b in out)
                  for s in (b["slow_iv"] for b in out))
    assert overlap
    stats = tex._LAST_TOPOLOGY_STATS
    assert stats["max_inq"]["slow_ingest"] <= max(2, 2 * opts.max_in_flight)
    assert stats["dispatches"] == {"fast_decode": 8, "slow_ingest": 8}


# -- tests/test_data_streaming.py ---------------------------------------------

def case_exchange_bounded_blocks_in_flight(ctx):
    ctx["monkeypatch"].setenv("RTPU_DATA_EXCHANGE_INFLIGHT", "8")
    ds = tdata.range(2000, parallelism=20).random_shuffle(num_blocks=4)
    assert sorted(r["id"] for r in ds.take_all()) == list(range(2000))
    stats = tstream._LAST_EXCHANGE_STATS
    assert stats["kind"] == "random_shuffle" and stats["parts"] == 20
    assert stats["max_in_flight_seen"] <= 8 + stats["partitions"], stats
    assert stats["blocks"] == 20 * stats["partitions"]
    ctx["monkeypatch"].delenv("RTPU_DATA_EXCHANGE_INFLIGHT")


def case_exchange_frees_consumed_intermediates(ctx):
    before = rt.object_store_memory()["used_bytes"]
    n = 200_000
    refs = list(tdata.range(n, parallelism=8, lazy=True).random_shuffle(
        num_blocks=4).iter_block_refs())
    used = rt.object_store_memory()["used_bytes"] - before
    ids = []
    for r in refs:
        ids.extend(rt.get(r, timeout=60)["id"].tolist())
    assert sorted(ids) == list(range(n))
    assert used < 2 * n * 8, (used, n * 8)
    rt.free(refs)


def case_lazy_range_reexecutes(ctx):
    ds = tdata.range(100, parallelism=4, lazy=True)
    assert ds.count() == 100
    assert ds.count() == 100
    assert sorted(r["id"] for r in ds.random_shuffle().take_all()) == \
        list(range(100))
    assert "lazy source" in repr(ds)


def case_sort_string_keys_streaming(ctx):
    names = [f"name-{i:04d}" for i in np.random.default_rng(3).permutation(
        200)]
    ds = tdata.from_items([{"s": s} for s in names], parallelism=5)
    assert [r["s"] for r in ds.sort("s").take_all()] == sorted(names)
    assert [r["s"] for r in ds.sort("s", descending=True).take_all()] == \
        sorted(names, reverse=True)


def case_groupby_custom_aggregate_streaming(ctx):
    ds = tdata.from_items([{"k": i % 4, "v": float(i)} for i in range(40)],
                          parallelism=4)
    out = ds.groupby("k").aggregate("span", lambda b: float(
        b["v"].max() - b["v"].min())).take_all()
    assert len(out) == 4 and all(r["span"] == 36.0 for r in out), out


RUNTIME_CASES = sorted(name for name in globals() if name.startswith("case_"))


def test_runtime_cases(runtime, monkeypatch, tmp_path):
    """Every runtime case in one test: under xdist each test that takes the
    module fixture would start a runtime of its own. Afterwards every CPU
    is free again: the scheduler once handed a worker it had just claimed
    to a second task, and each such overwrite lost a CPU until the
    exchanges starved."""
    for name in RUNTIME_CASES:
        d = tmp_path / name
        d.mkdir()
        try:
            globals()[name]({"monkeypatch": monkeypatch, "tmp": str(d)})
        except BaseException as e:
            raise AssertionError(f"{name} failed: {e!r}") from e
    deadline = time.monotonic() + 30
    while (rt.available_resources().get("CPU") != 4.0
           and time.monotonic() < deadline):
        time.sleep(0.2)
    assert rt.available_resources() == {"CPU": 4.0}
