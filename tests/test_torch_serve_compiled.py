"""The port's compiled deployments, gRPC ingress and declarative config on
the CPU, against ``tests/test_serve.py``'s cases and the JAX package:

- ``compiled=True`` with 2 replicas: steady-state requests and a method
  clone ride the per-replica compiled DAGs; a replica killed, the
  broken-DAG fallback gives the caller no error and the controller
  reconciles a replacement
  (``test_compiled_deployment_steady_state_and_replica_death``);
- a compiled deployment of float32 llama-debug (weights carried from the
  JAX package with ``models.params_from_jax``, handed over through the
  object store) through the handle, concurrently and through the HTTP
  proxy: each request's top-5 ids and logits equal the JAX package's
  ``forward`` (atol 1e-5);
- a compiled ``LLMDeployment``: its ``__call__`` returns a generator,
  which a ring cannot carry, so the caller gets ``DAGExecutionError`` as
  in the reference;
- ``GrpcProxy`` unary, stream, health, listing and NOT_FOUND
  (``test_grpc_proxy_unary_and_stream``);
- ``config_api``: a YAML file deployed, then the REST payloads
  (``test_serve_config_deploy_and_rest``; the port has no dashboard, so
  its functions are called directly).

One runtime for the module, with a small store (``RTPU_STORE_CAPACITY`` and
``RTPU_STORE_PREFAULT_BYTES`` at most 64 MB) and one prestarted worker; its
workers keep torch to one thread. The cases run in two tests. Every result,
get and poll has a finite timeout.
"""

import http.client
import json
import os
import textwrap
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ray_tpu_torch as rt
from conftest import poll_until
from ray_tpu import models as JM
from ray_tpu.serve import config_api as ref_config_api
from ray_tpu_torch import models as TM
from ray_tpu_torch import serve
from ray_tpu_torch.dag import DAGExecutionError
from ray_tpu_torch.serve import config_api
from ray_tpu_torch.serve.handle import CompiledDeploymentResponse

STORE_ENV = {"RTPU_STORE_CAPACITY": str(64 << 20),
             "RTPU_STORE_PREFAULT_BYTES": str(16 << 20),
             "RTPU_POOL_PRESTART": "1"}
RESULT_S = 60.0   # every result / get: a hang fails the test
LENS = (3, 9, 17, 6)
LOGIT_ATOL = 1e-5


@pytest.fixture(scope="module")
def runtime():
    saved = {k: os.environ.get(k) for k in STORE_ENV}
    os.environ.update(STORE_ENV)
    rt.init(num_cpus=8, runtime_env={"env_vars": {"OMP_NUM_THREADS": "1"}})
    session = rt.core.runtime._get_runtime().session
    yield session
    serve.shutdown()
    rt.shutdown()
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def _replicas(name):
    ctrl = rt.get_actor("SERVE_CONTROLLER")
    return rt.get(ctrl.list_deployments.remote(),
                  timeout=RESULT_S)[name]["num_replicas"]


def case_compiled_deployment_steady_state_and_replica_death():
    @serve.deployment(num_replicas=2, compiled=True)
    class Echo:
        def __init__(self, base):
            self.base = base

        def __call__(self, x):
            return self.base + x

        def describe(self):
            return "echo"

    handle = serve.run(Echo.bind(100), name="echo")
    try:
        ctrl = rt.get_actor("SERVE_CONTROLLER")
        info = rt.get(ctrl.get_routing_info.remote("Echo"),
                      timeout=RESULT_S)
        assert info["compiled"] is True
        results = [handle.remote(i) for i in range(30)]
        assert all(isinstance(r, CompiledDeploymentResponse)
                   for r in results)
        assert [r.result(timeout_s=RESULT_S) for r in results] == [
            100 + i for i in range(30)]
        assert handle._dags, "compiled path built no DAGs"
        # a method clone stays on the compiled plane
        resp = handle.describe.remote()
        assert isinstance(resp, CompiledDeploymentResponse), type(resp)
        assert resp.result(timeout_s=RESULT_S) == "echo"
        # replica death: requests keep succeeding (the broken-DAG fallback
        # re-routes and reports), the controller replaces the replica
        victim = handle._replicas[0]
        rt.kill(victim)
        vals = [handle.remote(i).result(timeout_s=RESULT_S)
                for i in range(20)]
        assert vals == [100 + i for i in range(20)]
        poll_until(lambda: _replicas("Echo") == 2, timeout=RESULT_S,
                   desc="controller reconciled a replacement replica")
    finally:
        serve.delete("Echo")


def _cfg(mod):
    return mod.get_config("llama-debug").replace(dtype="float32",
                                                 param_dtype="float32")


def _top5(logits):
    """The last position's top-5 ids and logits of a [1, L, V] array."""
    last = np.asarray(logits)[0, -1]
    ids = np.argsort(-last, kind="stable")[:5]
    return ids.tolist(), last[ids].tolist()


@pytest.fixture(scope="module")
def reference():
    """Prompts, the JAX package's params as numpy, and its forward's top-5
    for each prompt."""
    cfg = _cfg(JM)
    params = JM.init_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in LENS]
    want = [_top5(JM.forward(params, jnp.asarray([p], jnp.int32), cfg)[0])
            for p in prompts]
    yield prompts, jax.device_get(params), want
    jax.clear_caches()


def _post(port, route, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=RESULT_S)
    try:
        conn.request("POST", f"/{route}", body=json.dumps(body))
        resp = conn.getresponse()
        assert resp.status == 200, resp.read()
        return json.loads(resp.read())["result"]
    finally:
        conn.close()


def _close(got, want):
    return (got["ids"] == want[0]
            and np.allclose(got["logits"], want[1], rtol=0, atol=LOGIT_ATOL))


def case_compiled_llama_matches_jax_forward(reference):
    prompts, np_params, want = reference

    @serve.deployment(compiled=True, max_ongoing_requests=4,
                      ray_actor_options={"num_cpus": 0})
    class Score:
        def __init__(self, cfg, params):
            self.cfg, self.params = cfg, params

        def __call__(self, prompt_tokens):
            import torch

            from ray_tpu_torch import models

            with torch.inference_mode():
                logits, _ = models.forward(
                    self.params, torch.tensor([prompt_tokens]), self.cfg)
                top = torch.topk(logits[0, -1], 5)
            return {"ids": top.indices.tolist(),
                    "logits": top.values.tolist()}

        def describe(self):
            return None

    params = rt.put(TM.params_from_jax(np_params, device="cpu"))
    handle = serve.run(Score.bind(_cfg(TM), params), name="score",
                       route_prefix="/score")
    proxy = serve.start_http_proxy(port=0)
    try:
        one = [handle.remote(p) for p in prompts]
        assert all(isinstance(r, CompiledDeploymentResponse) for r in one)
        got = [r.result(timeout_s=RESULT_S) for r in one]
        assert [_close(g, w) for g, w in zip(got, want)] == [True] * len(
            prompts), (got, want)
        # concurrent callers, then the HTTP proxy's non-stream POST: the
        # same answers (the replica's exec loop runs them one at a time)
        many = [None] * (2 * len(prompts))

        def call(i):
            many[i] = handle.remote(prompts[i % len(prompts)]).result(
                timeout_s=RESULT_S)

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(many))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=RESULT_S)
        assert many == got + got
        assert [_post(proxy.port, "score", p) for p in prompts] == got
        assert handle.describe.remote().result(timeout_s=RESULT_S) is None
        dags = [d for dep, d in handle._dags.values() if dep == "Score"]
        assert len(dags) == 1 and dags[0]._max_in_flight == 4
    finally:
        proxy.stop()
        serve.delete("Score")


def case_compiled_llm_deployment_call_fails_like_the_reference(reference):
    """``LLMDeployment.__call__`` returns a token generator; the exec loop
    cannot write one into a ring, so the stage's error reaches the caller
    as ``DAGExecutionError`` (the reference's behaviour: its ``out.write``
    fails alike). Streams keep the ordinary path."""
    prompts, np_params, _ = reference
    params = rt.put(TM.params_from_jax(np_params, device="cpu"))
    handle = serve.run(serve.deployment(
        serve.LLMDeployment, name="llm_compiled", compiled=True,
        ray_actor_options={"max_concurrency": 4, "num_cpus": 0}).bind(
            _cfg(TM), params=params, device="cpu", max_slots=2, max_len=64,
            block_size=8, prefill_chunk=8), name="llm_compiled")
    try:
        resp = handle.remote(prompts[0], 4)
        assert isinstance(resp, CompiledDeploymentResponse)
        with pytest.raises(DAGExecutionError) as err:
            resp.result(timeout_s=RESULT_S)
        assert "generator" in repr(err.value.__cause__)
        toks = list(handle.options(stream=True).remote(prompts[0], 4))
        assert len(toks) == 4
    finally:
        serve.delete("llm_compiled")


def case_grpc_proxy_unary_and_stream():
    import grpc

    @serve.deployment
    def g_unary(n=None):
        return {"pong": True}

    @serve.deployment
    class GStream:
        def __call__(self, n):
            for i in range(int(n)):
                yield {"i": i}

    handle = serve.run(g_unary.bind(), name="grpc_app")
    shandle = serve.run(GStream.bind(), name="grpc_stream_app")
    gp = serve.GrpcProxy(port=0)
    gp.register("g", handle)
    gp.register("gs", shandle)
    gp.start()
    svc = "/ray_tpu_torch.serve.ServeAPI"
    try:
        ch = grpc.insecure_channel(f"127.0.0.1:{gp.port}")
        predict = ch.unary_unary(f"{svc}/Predict")
        stream = ch.unary_stream(f"{svc}/PredictStream")
        healthz = ch.unary_unary(f"{svc}/Healthz")
        listdep = ch.unary_unary(f"{svc}/ListDeployments")

        assert json.loads(healthz(b"{}", timeout=RESULT_S)) == {
            "status": "ok"}
        assert json.loads(listdep(b"{}", timeout=RESULT_S))[
            "deployments"] == ["g", "gs"]
        out = json.loads(predict(json.dumps({"deployment": "g"}).encode(),
                                 timeout=RESULT_S))
        assert out["result"] == {"pong": True}
        items = [json.loads(b)["result"] for b in stream(
            json.dumps({"deployment": "gs", "arg": 3}).encode(),
            timeout=RESULT_S)]
        assert items == [{"i": 0}, {"i": 1}, {"i": 2}]
        with pytest.raises(grpc.RpcError) as err:
            predict(json.dumps({"deployment": "nope"}).encode(),
                    timeout=RESULT_S)
        assert err.value.code() == grpc.StatusCode.NOT_FOUND
        with pytest.raises(grpc.RpcError) as err:
            predict(b"not json", timeout=RESULT_S)
        assert err.value.code() == grpc.StatusCode.INVALID_ARGUMENT
        ch.close()
    finally:
        gp.stop()
        serve.delete("g_unary")
        serve.delete("GStream")


APP_MODULE = """
    from ray_tpu_torch import serve

    @serve.deployment
    class Hello:
        def __call__(self, payload=None):
            return {"hello": payload}

    app = Hello.bind()
"""
CONFIG = """
    applications:
      - name: hello
        import_path: demo_torch_serve_app:app
        route_prefix: /hello
        deployments:
          - name: Hello
            num_replicas: 2
"""


def case_serve_config_deploy_and_rest(tmp_path, monkeypatch):
    (tmp_path / "demo_torch_serve_app.py").write_text(
        textwrap.dedent(APP_MODULE))
    monkeypatch.syspath_prepend(str(tmp_path))
    cfg_path = tmp_path / "serve.yaml"
    cfg_path.write_text(textwrap.dedent(CONFIG))

    cfg = config_api.load_config(str(cfg_path))
    # the schema is the reference's: both packages load the same mapping
    assert cfg == ref_config_api.load_config(str(cfg_path))
    assert config_api.deploy_config(cfg) == ["hello"]
    h = serve.get_deployment_handle("Hello")
    assert h.remote(payload=1).result(timeout_s=RESULT_S) == {"hello": 1}
    poll_until(lambda: _replicas("Hello") == 2, timeout=RESULT_S,
               desc="the config's 2 replicas")

    got = config_api.serve_rest_get()
    assert "Hello" in got["applications"]
    assert got["applications"]["Hello"]["num_replicas"] == 2
    assert "deployments" in config_api.serve_models_get()
    put_cfg = json.loads(json.dumps({"applications": [
        {"name": "hello2", "import_path": "demo_torch_serve_app:app",
         "route_prefix": "/hello2"}]}))
    assert config_api.serve_rest_put(put_cfg) == {"deployed": ["hello2"]}
    assert h.remote(payload=2).result(timeout_s=RESULT_S) == {"hello": 2}

    with pytest.raises(ValueError, match="module:attr"):
        config_api.import_attr("demo_torch_serve_app.app")
    with pytest.raises(TypeError, match="expected an Application"):
        config_api.deploy_config({"applications": [
            {"import_path": "demo_torch_serve_app:serve"}]})
    bad = tmp_path / "bad.yaml"
    bad.write_text("- just a list\n")
    with pytest.raises(ValueError, match="applications"):
        config_api.load_config(str(bad))
    assert config_api.serve_rest_delete() == {"shutdown": True}
    assert config_api.serve_rest_get()["applications"] == {}


# the cases in two tests: under xdist each test of this module may start the
# module's runtime in another worker, so few tests start few runtimes
def _run(*cases):
    for case, args in cases:
        try:
            case(*args)
        except BaseException as e:
            raise AssertionError(f"{case.__name__} failed: {e!r}") from e


def test_compiled_deployments(runtime, reference):
    _run((case_compiled_deployment_steady_state_and_replica_death, ()),
         (case_compiled_llama_matches_jax_forward, (reference,)),
         (case_compiled_llm_deployment_call_fails_like_the_reference,
          (reference,)))


def test_grpc_proxy_and_serve_config(runtime, tmp_path, monkeypatch):
    _run((case_grpc_proxy_unary_and_stream, ()),
         (case_serve_config_deploy_and_rest, (tmp_path, monkeypatch)))
