"""Runtime context: who am I, where am I running.

Role analog: reference ``python/ray/runtime_context.py``.
"""

from __future__ import annotations

from typing import Optional


class RuntimeContext:
    def __init__(self, rt):
        self._rt = rt

    @property
    def was_current_actor_reconstructed(self) -> bool:
        return False

    def get_node_id(self) -> str:
        if self._rt.is_driver:
            return self._rt.node_id.hex()
        # workers inherit their spawning node runtime's id via env (set
        # at spawn) — the disaggregated-serving transfer plane keys
        # channel-vs-store on node identity (ISSUE 13)
        import os

        return os.environ.get("RTPU_NODE_ID", "node")

    def get_job_id(self) -> str:
        return "job"

    def get_session_id(self) -> str:
        """The runtime session id (shared by the driver and its workers;
        a remote node's workers carry their daemon's session). Public
        surface: shm artifacts named ``rtpu-chan-<session>-*`` are swept
        by that session's runtime shutdown, so anything creating
        channels outside dag/ (e.g. the serve KV-transfer plane) must
        embed it."""
        return self._rt.session

    def get_worker_id(self) -> str:
        if self._rt.is_driver:
            return "driver"
        return self._rt.worker_id.hex()

    def get_task_id(self) -> Optional[str]:
        if self._rt.is_driver:
            return None
        tid = self._rt.current_task_id
        return tid.hex() if tid else None

    def get_actor_id(self) -> Optional[str]:
        if self._rt.is_driver:
            return None
        aid = self._rt.current_actor_id
        return aid.hex() if aid else None

    def get_actor_name(self) -> Optional[str]:
        return None

    def get_assigned_resources(self):
        return {}


def get_runtime_context() -> RuntimeContext:
    from ray_tpu_torch.core.runtime import _get_runtime

    return RuntimeContext(_get_runtime())
