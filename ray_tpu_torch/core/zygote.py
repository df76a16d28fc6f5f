"""Zygote worker spawner: pre-warmed fork server for worker processes.

Role analog: the reference raylet's ``WorkerPool`` (``worker_pool.h:159``)
keeps worker *processes* warm (prestart); on a 64-core box a cold
``python`` exec is cheap enough that Ray doesn't need more. On this box the
interpreter + worker imports cost ~0.15s of CPU per worker, capping cold
actor/task bursts at ~13 spawns/s on 2 vCPUs. The zygote amortizes that
cost once: ONE clean process is exec'd at init (``python -S``, skipping
any sitecustomize), pre-imports ``ray_tpu_torch.core.worker``, and then
forks a child per spawn request (~5 ms).

Safety properties that make the fork clean (unlike forking the driver,
which is forbidden — it is threaded and may hold a CUDA context):

- the zygote is SINGLE-THREADED at every fork (requests are served from a
  select() loop; child reaping is WNOHANG polling, not a reaper thread);
  this includes the observability planes: the zygote never arms the
  tracing or profiling modules (a sampler thread here would make every
  fork unsafe), and ``util/profiling.py``'s at-fork hook resets the
  child's sampler handle so an armed worker restarts its own sampler
  from its main loop after the fork;
- it never imports torch or user code, so no locks and no CUDA state: a
  CUDA context does not survive a fork, and a child forked from a parent
  that initialised CUDA cannot use the card at all;
- each child closes the zygote's control fds, redirects stdio to its own
  log file, and then runs the exact same ``worker.main`` that an exec'd
  worker runs — it still dials back over the unix socket, so the
  worker-transport architecture is unchanged (workers are NOT
  multiprocessing children of the driver; driver scripts without a
  ``__main__`` guard keep working).

Protocol (json lines): driver -> zygote stdin ``{"wid", "addr",
"session", "log"}``; zygote -> driver stdout ``{"event": "spawned",
"wid", "pid"}`` and ``{"event": "exit", "wid", "pid", "status"}``.
"""

from __future__ import annotations

import json
import os
import select
import signal
import sys


def zygote_main() -> None:
    # Pre-import the worker module (and transitively the runtime/store
    # client machinery) BEFORE serving: every forked child inherits the
    # warm module cache.
    import ray_tpu_torch.core.worker as worker_mod

    signal.signal(signal.SIGUSR1, signal.SIG_IGN)
    # our children must not become zombies of init if we die first; but
    # while we live, WE are their parent and must reap them
    children = {}  # pid -> wid
    stdin_fd = sys.stdin.fileno()
    out = sys.stdout
    buf = b""

    def emit(obj) -> None:
        out.write(json.dumps(obj) + "\n")
        out.flush()

    emit({"event": "ready", "pid": os.getpid()})
    while True:
        try:
            ready, _, _ = select.select([stdin_fd], [], [], 0.2)
        except InterruptedError:
            ready = []
        # reap exited children (WNOHANG poll keeps us single-threaded)
        while children:
            try:
                pid, status = os.waitpid(-1, os.WNOHANG)
            except ChildProcessError:
                break
            if pid == 0:
                break
            wid = children.pop(pid, None)
            code = (os.waitstatus_to_exitcode(status)
                    if hasattr(os, "waitstatus_to_exitcode") else status)
            emit({"event": "exit", "wid": wid, "pid": pid, "status": code})
        if not ready:
            continue
        chunk = os.read(stdin_fd, 65536)
        if not chunk:
            # driver closed our stdin: its runtime shut down (or died)
            # after stopping every worker it knew of; a child forked for a
            # spawn that raced the shutdown would reopen, and so re-create,
            # the session's arena: kill and reap what is left
            _kill_children(children)
            return
        buf += chunk
        while b"\n" in buf:
            line, buf = buf.split(b"\n", 1)
            if not line.strip():
                continue
            try:
                req = json.loads(line)
            except json.JSONDecodeError:
                continue
            pid = os.fork()
            if pid == 0:
                _child_exec(worker_mod, req)  # never returns
            children[pid] = req["wid"]
            emit({"event": "spawned", "wid": req["wid"], "pid": pid})


def _kill_children(children: dict) -> None:
    for pid in list(children):
        try:
            os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    for pid in list(children):
        try:
            os.waitpid(pid, 0)
        except ChildProcessError:
            pass
        children.pop(pid, None)


def _child_exec(worker_mod, req: dict) -> None:
    """Forked child: detach from the zygote's fds and run the worker."""
    try:
        os.setpgid(0, 0)  # own process group: driver kill signals are exact
    except OSError:
        pass
    signal.signal(signal.SIGUSR1, signal.SIG_IGN)  # until worker registers
    try:
        log_fd = os.open(req["log"],
                         os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        devnull = os.open(os.devnull, os.O_RDONLY)
        os.dup2(devnull, 0)
        os.dup2(log_fd, 1)
        os.dup2(log_fd, 2)
        if log_fd > 2:
            os.close(log_fd)
        if devnull > 2:
            os.close(devnull)
        sys.argv = ["ray_tpu_torch.core.worker",
                    "--addr", req["addr"],
                    "--session", req["session"],
                    "--worker-id", req["wid"]]
        worker_mod._main()
        os._exit(0)
    except SystemExit as e:
        os._exit(int(e.code or 0))
    except BaseException:
        import traceback

        traceback.print_exc()
        os._exit(1)


if __name__ == "__main__":
    zygote_main()
