"""Exception types surfaced by the runtime.

Role analog: reference ``python/ray/exceptions.py``.
"""

from __future__ import annotations

import traceback


class RayTpuError(Exception):
    pass


class TaskError(RayTpuError):
    """A task raised; re-raised at ``get`` with the remote traceback.

    Carries a machine-readable ``error_type`` (taken from the cause's
    own ``error_type`` attribute when it declares one — e.g. admission
    ``RequestShedError("shed")`` / ``DeadlineExceededError("deadline")``
    — else the cause's class name) so callers classify failures without
    parsing ``str()``; the custom ``__reduce__`` ships the cause and the
    classification across process boundaries, with a representation
    fallback for unpicklable causes (the default Exception reduce would
    silently collapse ``cause`` to its message string)."""

    def __init__(self, cause: BaseException, remote_tb: str = "",
                 task_desc: str = "", error_type: str = None):
        self.cause = cause
        self.remote_tb = remote_tb
        self.task_desc = task_desc
        self.error_type = (error_type if error_type is not None
                           else getattr(cause, "error_type", None)
                           or type(cause).__name__)
        super().__init__(str(cause))

    def __str__(self):
        return (
            f"{type(self.cause).__name__}: {self.cause}\n"
            f"--- remote traceback ({self.task_desc}) ---\n{self.remote_tb}"
        )

    def __reduce__(self):
        try:
            import cloudpickle

            blob = cloudpickle.dumps(self.cause)
        except Exception:
            blob = None
        return (_rebuild_task_error,
                (blob, type(self.cause).__name__, str(self.cause),
                 self.remote_tb, self.task_desc, self.error_type))


def _rebuild_task_error(blob, cause_type: str, cause_str: str,
                        remote_tb: str, task_desc: str,
                        error_type) -> TaskError:
    cause = None
    if blob is not None:
        try:
            import pickle

            cause = pickle.loads(blob)
        except Exception:
            cause = None
    if cause is None:  # unpicklable either way: keep the repr + type
        cause = RuntimeError(f"{cause_type}: {cause_str}")
    return TaskError(cause, remote_tb, task_desc, error_type)


def wrap_current_exception(task_desc: str = "") -> TaskError:
    import sys

    et, ev, tb = sys.exc_info()
    return TaskError(ev, "".join(traceback.format_exception(et, ev, tb)), task_desc)


class WorkerCrashedError(RayTpuError):
    pass


class ActorDiedError(RayTpuError):
    pass


class ActorUnavailableError(RayTpuError):
    pass


class GetTimeoutError(RayTpuError, TimeoutError):
    pass


class ObjectLostError(RayTpuError):
    pass


class RuntimeEnvSetupError(RayTpuError):
    pass


class TaskCancelledError(RayTpuError):
    pass


class PlacementGroupUnavailableError(RayTpuError):
    pass
