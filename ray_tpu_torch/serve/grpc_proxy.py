"""gRPC ingress: the second data-plane protocol next to HTTP (twin of
``ray_tpu/serve/grpc_proxy.py``, under the service name
``ray_tpu_torch.serve.ServeAPI``). ``grpc`` is imported inside the methods:
the package imports without ``grpcio``.

Role analog: ``python/ray/serve/_private/proxy.py:534`` (``gRPCProxy``) +
the reference's ``serve.proto`` service. Implementation differs: instead
of protoc-generated stubs, one generic service with JSON-bytes payloads —
callable from any gRPC client without codegen::

    ch = grpc.insecure_channel(addr)
    predict = ch.unary_unary("/ray_tpu_torch.serve.ServeAPI/Predict")
    resp = json.loads(predict(json.dumps(
        {"deployment": "echo", "arg": {"x": 1}}).encode()))

Methods (all payloads are UTF-8 JSON bytes):

- ``Predict``        unary-unary  {"deployment", "arg"?} -> {"result"}
- ``PredictStream``  unary-stream same request, one {"result"} per yield
- ``Healthz``        unary-unary  {} -> {"status": "ok"}
- ``ListDeployments`` unary-unary {} -> {"deployments": [...]}

Routing table and handle semantics are shared with ``HTTPProxy``: both
ingresses front the same ``DeploymentHandle`` router (pow-2 replica
choice, streaming, multiplex).
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional

from ray_tpu_torch.serve.handle import DeploymentHandle

SERVICE = "ray_tpu_torch.serve.ServeAPI"


def _ident(b):
    return b


class GrpcProxy:
    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 max_workers: int = 16):
        self.host = host
        self.port = port
        self.max_workers = max_workers
        self._handles: Dict[str, DeploymentHandle] = {}
        self._server = None

    def register(self, route: str, handle: DeploymentHandle) -> None:
        self._handles[route.strip("/")] = handle

    # -- handlers ---------------------------------------------------------

    def _parse(self, request: bytes, context):
        import grpc

        try:
            req = json.loads(request or b"{}")
        except json.JSONDecodeError:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                          "request payload is not JSON")
        return req

    def _resolve(self, req: dict, context) -> DeploymentHandle:
        import grpc

        name = str(req.get("deployment") or "").strip("/")
        handle = self._handles.get(name)
        if handle is None:
            context.abort(grpc.StatusCode.NOT_FOUND,
                          f"no deployment {name!r}")
        return handle

    def _predict(self, request: bytes, context) -> bytes:
        import grpc

        req = self._parse(request, context)
        handle = self._resolve(req, context)
        arg: Any = req.get("arg")
        try:
            resp = handle.remote(arg) if arg is not None else handle.remote()
            return json.dumps({"result": resp.result()}).encode()
        except Exception as e:  # noqa: BLE001
            context.abort(grpc.StatusCode.INTERNAL, str(e))

    def _predict_stream(self, request: bytes, context):
        import grpc

        req = self._parse(request, context)
        handle = self._resolve(req, context)
        arg: Any = req.get("arg")
        try:
            gen = (handle.options(stream=True).remote(arg)
                   if arg is not None
                   else handle.options(stream=True).remote())
            for item in gen:
                yield json.dumps({"result": item}).encode()
        except Exception as e:  # noqa: BLE001
            context.abort(grpc.StatusCode.INTERNAL, str(e))

    def _healthz(self, request: bytes, context) -> bytes:
        return json.dumps({"status": "ok"}).encode()

    def _list(self, request: bytes, context) -> bytes:
        return json.dumps({"deployments": sorted(self._handles)}).encode()

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        import grpc
        from concurrent import futures

        handler = grpc.method_handlers_generic_handler(SERVICE, {
            "Predict": grpc.unary_unary_rpc_method_handler(
                self._predict, request_deserializer=_ident,
                response_serializer=_ident),
            "PredictStream": grpc.unary_stream_rpc_method_handler(
                self._predict_stream, request_deserializer=_ident,
                response_serializer=_ident),
            "Healthz": grpc.unary_unary_rpc_method_handler(
                self._healthz, request_deserializer=_ident,
                response_serializer=_ident),
            "ListDeployments": grpc.unary_unary_rpc_method_handler(
                self._list, request_deserializer=_ident,
                response_serializer=_ident),
        })
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=self.max_workers,
                                       thread_name_prefix="serve-grpc"))
        self._server.add_generic_rpc_handlers((handler,))
        self.port = self._server.add_insecure_port(
            f"{self.host}:{self.port}")
        self._server.start()

    def stop(self) -> None:
        if self._server is not None:
            self._server.stop(grace=0.5)
            self._server = None
