"""ray_tpu_torch.serve — online serving over replica actors.

Role analog: ``python/ray/serve`` (SURVEY §2.5, §3.6). Control plane =
named controller actor reconciling replica actors; data plane = handle →
power-of-two-choices routing → replica actor call; plus dynamic batching,
model composition, autoscaling, and an HTTP proxy. LLM serving on PyTorch:
``LLMDeployment`` runs the paged continuous-batching engine on a replica,
on the card or the CPU; ``deploy_disagg`` splits it into a prefill pool and
a decode pool that ship KV blocks between them (``kv_transfer.py``) behind
a ``DisaggHandle``, which also drains live sessions from one decode replica
to another; ``SpeculativeLLMDeployment`` decodes speculatively over the
same engine, and ``MultiplexedLLMDeployment`` serves many models (full
weight sets and LoRA-style deltas) from one replica through a
``ModelRegistry``.
A deployment with ``compiled=True`` routes its steady-state requests
through one compiled DAG per replica (``ray_tpu_torch.dag``); ``GrpcProxy``
is the gRPC ingress beside ``HTTPProxy``, and ``config_api`` deploys a
declarative config.
"""

from ray_tpu_torch.serve.admission import (AdmissionController,
                                           DeadlineExceededError,
                                           RequestShedError, SLOConfig)
from ray_tpu_torch.serve.api import (
    delete,
    get_deployment_handle,
    get_multiplexed_model_id,
    multiplexed,
    run,
    shutdown,
    start_http_proxy,
    status,
)
from ray_tpu_torch.serve.batching import batch
from ray_tpu_torch.serve.deployment import (
    Application,
    AutoscalingConfig,
    Deployment,
    DeploymentConfig,
    deployment,
)
from ray_tpu_torch.serve.disagg import DisaggHandle, deploy_disagg
from ray_tpu_torch.serve.grpc_proxy import GrpcProxy
from ray_tpu_torch.serve.handle import DeploymentHandle, DeploymentResponse
from ray_tpu_torch.serve.kv_cache import BlockPool, KVCacheError, PrefixCache
from ray_tpu_torch.serve.kv_transfer import KVTransferError
from ray_tpu_torch.serve.llm import KVExport, LLMDeployment, LLMEngine
from ray_tpu_torch.serve.multiplex import (ModelRegistry,
                                           MultiplexedLLMDeployment,
                                           SpeculativeLLMDeployment,
                                           SpeculativeLLMEngine)
from ray_tpu_torch.serve.proxy import HTTPProxy

__all__ = [
    "run",
    "start_http_proxy",
    "shutdown",
    "delete",
    "status",
    "deployment",
    "Deployment",
    "DeploymentConfig",
    "AutoscalingConfig",
    "Application",
    "DeploymentHandle",
    "DeploymentResponse",
    "GrpcProxy",
    "HTTPProxy",
    "batch",
    "LLMDeployment",
    "LLMEngine",
    "KVExport",
    "ModelRegistry",
    "MultiplexedLLMDeployment",
    "SpeculativeLLMDeployment",
    "SpeculativeLLMEngine",
    "DisaggHandle",
    "deploy_disagg",
    "KVTransferError",
    "BlockPool",
    "KVCacheError",
    "PrefixCache",
    "SLOConfig",
    "AdmissionController",
    "RequestShedError",
    "DeadlineExceededError",
    "multiplexed",
    "get_multiplexed_model_id",
    "get_deployment_handle",
]
