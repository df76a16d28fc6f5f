"""The port's Serve control plane on the CPU: a function deployment through
the handle and the HTTP proxy, and ``LLMDeployment`` (float32 llama-debug,
``device="cpu"``, paged and dense) streaming 8 concurrent prompts through
the handle and through the proxy's ``?stream=1``, token-exact against the
JAX package's greedy ``generate`` on the same weights (carried across with
``models.params_from_jax``, handed to the replica through the object store).

One runtime per module, with a small store (``RTPU_STORE_CAPACITY`` and
``RTPU_STORE_PREFAULT_BYTES`` at most 64 MB) and one prestarted worker;
its workers keep torch to one thread.
"""

import http.client
import json
import os
import threading
import time

import jax
import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu import models as JM
from ray_tpu.models import transformer as JT
from ray_tpu_torch import models as TM
from ray_tpu_torch import serve
from ray_tpu_torch.util import state

STORE_ENV = {"RTPU_STORE_CAPACITY": str(64 << 20),
             "RTPU_STORE_PREFAULT_BYTES": str(16 << 20),
             "RTPU_POOL_PRESTART": "1"}
LENS = (3, 5, 7, 9, 4, 6, 8, 10)
NEW_TOKENS = 8


@pytest.fixture(scope="module")
def runtime():
    saved = {k: os.environ.get(k) for k in STORE_ENV}
    os.environ.update(STORE_ENV)
    rt.init(num_cpus=8, runtime_env={"env_vars": {"OMP_NUM_THREADS": "1"}})
    proxy = serve.start_http_proxy(port=0)
    yield proxy
    proxy.stop()
    serve.shutdown()
    rt.shutdown()
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def _http(proxy, route, body, stream=False):
    """POST ``body`` as JSON; the decoded reply, or a streamed reply's
    ``result`` items."""
    conn = http.client.HTTPConnection("127.0.0.1", proxy.port, timeout=120)
    try:
        conn.request("POST", f"/{route}" + ("?stream=1" if stream else ""),
                     body=json.dumps(body))
        resp = conn.getresponse()
        assert resp.status == 200, resp.read()
        raw = resp.read().decode()
    finally:
        conn.close()
    if not stream:
        return json.loads(raw)
    return [json.loads(line)["result"] for line in raw.splitlines() if line]


def _cfg(mod):
    return mod.get_config("llama-debug").replace(dtype="float32",
                                                 param_dtype="float32")


@pytest.fixture(scope="module")
def reference():
    """The prompts, the params as numpy, and the JAX package's greedy
    ``generate`` tokens for each prompt."""
    cfg = _cfg(JM)
    params = JM.init_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in LENS]
    want = []
    for p in prompts:
        g = JT.generate(params, jax.numpy.asarray(np.asarray(p, np.int32)[None]),
                        cfg, max_new_tokens=NEW_TOKENS)
        want.append([int(x) for x in np.asarray(g[0, len(p):])])
    yield prompts, jax.device_get(params), want
    jax.clear_caches()


def test_function_deployment_through_handle_and_http(runtime):
    @serve.deployment
    def doubler(x):
        return x * 2

    @serve.deployment
    def counter(n):
        for i in range(int(n)):
            yield {"i": i}

    handle = serve.run(doubler.bind(), name="doubler")
    assert handle.remote(21).result() == 42
    serve.run(counter.bind(), name="counter")
    runtime.register("doubler", serve.get_deployment_handle("doubler"))
    runtime.register("counter", serve.get_deployment_handle("counter"))
    assert _http(runtime, "doubler", 4) == {"result": 8}
    assert _http(runtime, "counter", 3, stream=True) == [
        {"i": 0}, {"i": 1}, {"i": 2}]
    serve.delete("doubler")
    serve.delete("counter")


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_llm_deployment_streams_match_jax_generate(runtime, reference,
                                                   paged):
    prompts, np_params, want = reference
    cfg = _cfg(TM)
    params_ref = rt.put(TM.params_from_jax(np_params, device="cpu"))
    name = f"llm_{'paged' if paged else 'dense'}"
    app = serve.deployment(
        serve.LLMDeployment, name=name,
        ray_actor_options={"max_concurrency": 16, "num_cpus": 0},
    ).bind(cfg, params=params_ref, max_slots=8, max_len=64, paged=paged,
           device="cpu")
    handle = serve.run(app, name=name)
    runtime.register(name, handle)

    by_handle = [None] * len(prompts)
    by_http = [None] * len(prompts)

    def via_handle(i):
        by_handle[i] = list(handle.options(stream=True).remote(
            prompts[i], NEW_TOKENS))

    def via_http(i):
        by_http[i] = _http(runtime, name, {"prompt_tokens": prompts[i],
                                           "max_new_tokens": NEW_TOKENS},
                           stream=True)

    threads = [threading.Thread(target=fn, args=(i,))
               for i in range(len(prompts)) for fn in (via_handle, via_http)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert by_handle == want
    assert by_http == want
    stats = handle.options(method_name="stats", stream=False).remote()\
        .result()
    assert stats["tokens_generated"] == 2 * len(prompts) * NEW_TOKENS
    assert stats["max_concurrent"] >= 4, stats
    if paged:
        assert stats["kv_free"] + stats["prefix"]["nodes"] == \
            stats["kv_total"]
        # the device plane's receiver side: the replica's registry
        # snapshot reaches the driver's DeviceStore on a worker push (this
        # process's own rows, from in-process engines, carry no worker_id)
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            rows = [r for r in state.device_report()["programs"]
                    if r.get("program") == "serve::decode_step_paged"
                    and "worker_id" in r]
            if rows:
                break
            time.sleep(0.5)
        assert rows and rows[0]["calls"] >= 1
    serve.delete(name)

