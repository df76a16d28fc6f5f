"""TrainState, the train step and the loop helper (twin of
``ray_tpu/train/train_state.py``).

- State is ``{"step", "params", "opt_state"}``: ``params`` is the model's
  parameter dict of master tensors (float32 for the presets), the leaves
  requiring grad; ``opt_state`` is the ``torch.optim.AdamW`` that holds the
  moments (the JAX state keeps optax's moment pytree there). The step
  updates it in place: torch tensors are mutable, so nothing is donated.
- A step computes the loss with autograd, the global L2 norm of the grads
  (``optax.global_norm``) and the optimizer update.
- :func:`adamw` takes ``optax.adamw``'s arguments and defaults: in
  particular ``weight_decay=1e-4``, where ``torch.optim.AdamW`` defaults to
  0.01. The two apply the same update.
- Data parallel over a ``torch.distributed`` process group (the mesh's
  ``dp`` and ``dcn`` axes): every rank is handed the global batch and
  takes its own rows, as the reference's ``device_put`` to a global batch
  sharding does; the step all-reduces the grads before their norm and the
  update, each rank weighted by its share of the global tokens, so the step
  is the reference's step on the global batch. Parameters are replicated:
  ``fsdp`` and ``tp`` (``param_axes``, ``state_shardings``) come with
  ``parallel/sharding.py``.
"""

from __future__ import annotations

import functools
import math
import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch

from ray_tpu_torch._device import Device, resolve_device
from ray_tpu_torch.parallel.mesh import (DATA_AXES, MeshConfig, make_mesh,
                                         mesh_sizes)

TrainState = Dict[str, Any]   # {"step", "params", "opt_state"}
Metrics = Dict[str, torch.Tensor]
LossFn = Callable[[Any, Dict[str, Any]], Tuple[torch.Tensor, Metrics]]
Optimizer = Callable[[List[torch.Tensor]], torch.optim.Optimizer]


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4) -> Optimizer:
    """AdamW with ``optax.adamw``'s arguments and defaults (decoupled weight
    decay on every parameter): a function that builds the
    ``torch.optim.AdamW`` over a list of parameter tensors."""
    return functools.partial(torch.optim.AdamW, lr=learning_rate,
                             betas=(b1, b2), eps=eps,
                             weight_decay=weight_decay)


def _leaves(tree: Any) -> Iterator[torch.Tensor]:
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key])
    else:
        yield tree


def create_train_state(params: Any, optimizer: Optimizer) -> TrainState:
    """Make every parameter a leaf that requires grad and build the
    optimizer over them."""
    leaves = list(_leaves(params))
    for t in leaves:
        t.requires_grad_(True)
    return {
        "step": torch.zeros((), dtype=torch.int64, device=leaves[0].device),
        "params": params,
        "opt_state": optimizer(leaves),
    }


def make_train_step(loss_fn: LossFn, *, group: Any = None
                    ) -> Callable[[TrainState, Dict[str, Any]],
                                  Tuple[TrainState, Metrics]]:
    """Build ``(state, batch) -> (state, metrics)``: loss and grads, the
    grads' global norm (``metrics["grad_norm"]``), the AdamW update. The
    state is updated in place and returned; metrics are detached 0-d
    tensors on the device (nothing synchronizes).

    With a process ``group`` (data parallel, each rank on its own rows) the
    grads and metrics are all-reduced over it first: see
    :func:`_all_reduce`."""

    def step(state: TrainState, batch: Dict[str, Any]):
        params, opt = state["params"], state["opt_state"]
        leaves = list(_leaves(params))
        opt.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(params, batch)
        loss.backward()
        for t in leaves:  # optax sees a zero grad (and still decays)
            if t.grad is None:
                t.grad = torch.zeros_like(t)
        metrics = {k: v.detach() for k, v in metrics.items()}
        if group is not None:
            metrics = _all_reduce([t.grad for t in leaves], metrics, group)
        grad_norm = torch.nn.utils.get_total_norm([t.grad for t in leaves])
        opt.step()
        state["step"] += 1
        metrics["grad_norm"] = grad_norm
        return state, metrics

    return step


def _all_reduce(grads: List[torch.Tensor], metrics: Metrics,
                group: Any) -> Metrics:
    """Make each rank's grads and metrics the global batch's.

    A loss that is a mean over the rank's own ``ntokens`` (masked tokens
    excluded, ``models.loss_and_metrics``) has grads ``g_r = grad(S_r) /
    n_r``, while the reference's loss is the global mean ``sum(S_r) / N``.
    So each rank scales by ``n_r / N`` before the sum: a plain average of
    per-rank means is wrong when masks differ between ranks. Without an
    ``ntokens`` metric the ranks weigh the same. Metrics are the same
    weighted sums; ``ntokens`` becomes ``N`` and ``perplexity`` is taken
    again from the global loss, as the reference computes it."""
    import torch.distributed as dist

    n = metrics.get("ntokens")
    weight = (n.to(torch.float32) if n is not None
              else torch.ones((), device=grads[0].device))
    total = weight.clone()
    dist.all_reduce(total, group=group)
    scale = weight / total.clamp(min=1.0)
    waits = []
    for g in grads:
        g.mul_(scale.to(g.dtype))
        waits.append(dist.all_reduce(g, group=group, async_op=True))
    keys = [k for k in metrics if k not in ("ntokens", "perplexity")]
    packed = torch.stack([metrics[k].to(torch.float32) * scale
                          for k in keys])
    waits.append(dist.all_reduce(packed, group=group, async_op=True))
    for w in waits:
        w.wait()
    out = {k: packed[i].to(metrics[k].dtype) for i, k in enumerate(keys)}
    if n is not None:
        out["ntokens"] = total.to(n.dtype)
    if "perplexity" in metrics and "loss" in out:
        out["perplexity"] = torch.exp(out["loss"].clamp(max=20.0))
    return {k: out[k] for k in metrics}


@dataclass
class TrainLoopHelper:
    """Mesh + state + step: what a train loop needs. ``create`` builds the
    mesh from a :class:`MeshConfig` (a one-rank mesh without a process
    group), places the parameters on the device (``cuda`` unless the caller
    passes ``device="cpu"``; raises without a GPU), makes every rank's the
    same (rank 0's), and builds the optimizer and the step."""

    state: TrainState
    step_fn: Callable
    device: torch.device
    mesh: Any = None

    @classmethod
    def create(cls, init_params_fn: Callable[[], Any], loss_fn: LossFn,
               optimizer: Optimizer, *,
               device: Optional[Device] = None,
               mesh_config: Optional[MeshConfig] = None,
               mesh: Any = None) -> "TrainLoopHelper":
        dev = resolve_device(device)
        if mesh is None:
            mesh = make_mesh(mesh_config or MeshConfig(),
                             device_type=dev.type)
        ways = _data_ways(mesh)
        params = _to_device(init_params_fn(), dev)
        group = None
        if ways > 1:
            import torch.distributed as dist

            group = dist.group.WORLD
            for t in _leaves(params):
                dist.broadcast(t, src=0, group=group)
        return cls(state=create_train_state(params, optimizer),
                   step_fn=make_train_step(loss_fn, group=group),
                   device=dev, mesh=mesh)

    def _check_batch(self, batch: Dict[str, Any]) -> None:
        ways = _data_ways(self.mesh)
        for k, v in batch.items():
            shape = getattr(v, "shape", None)
            if shape and shape[0] % ways:
                raise ValueError(
                    f"batch[{k!r}] leading dim {shape[0]} does not divide "
                    f"by the data-parallel ways dcn*dp*fsdp={ways} of mesh "
                    f"{mesh_sizes(self.mesh)}; pad the batch or change the "
                    f"mesh")

    def _batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """This rank's rows of the global ``batch``, on the device."""
        self._check_batch(batch)
        ways = _data_ways(self.mesh)
        rank = 0
        if ways > 1:
            import torch.distributed as dist

            rank = dist.get_rank()
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(v)
            if ways > 1 and t.ndim:
                rows = t.shape[0] // ways
                t = t[rank * rows:(rank + 1) * rows]
            out[k] = t.to(self.device)
        return out

    def run_step(self, batch: Dict[str, Any]) -> Metrics:
        self.state, metrics = self.step_fn(self.state, self._batch(batch))
        return metrics

    def run_steps(self, batch: Dict[str, Any], n: int) -> Metrics:
        """Run ``n`` optimizer steps on the same batch and return the last
        step's metrics, synchronizing with the device once, at the end."""
        batch = self._batch(batch)
        metrics: Metrics = {}
        for _ in range(n):
            self.state, metrics = self.step_fn(self.state, batch)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return metrics

    def checkpoint_tree(self) -> Dict[str, Any]:
        """The state as a tree of tensors: ``{"step", "params",
        "opt_state"}`` with the optimizer's ``state_dict()`` (the moments
        and each parameter's AdamW ``step``)."""
        return {"step": self.state["step"], "params": self.state["params"],
                "opt_state": self.state["opt_state"].state_dict()}

    def restore(self, tree: Dict[str, Any]) -> None:
        """Load a :meth:`checkpoint_tree` (as ``load_pytree`` returns it)
        into this helper's state: the parameters are copied in place, so
        the optimizer keeps holding them, and the optimizer loads its
        moments and steps. The counterpart of assigning a loaded state to
        the reference helper's ``state``."""
        with torch.no_grad():
            for t, src in zip(_leaves(self.state["params"]),
                              _leaves(tree["params"])):
                t.copy_(src)
            self.state["step"].copy_(torch.as_tensor(tree["step"]))
        self.state["opt_state"].load_state_dict(tree["opt_state"])

    def save_checkpoint_async(self, path: str, *, name: str = "state"):
        """Snapshot the CURRENT train state and write it in the background
        (orbax async-checkpoint role). The device→host pull — a copy of
        every tensor — completes before this returns, so the next step may
        update the state in place at once; only the disk write overlaps
        training. Call ``.wait()`` on the returned handle before relying on
        the files."""
        from ray_tpu_torch.train.checkpoint import save_pytree_async

        return save_pytree_async(self.checkpoint_tree(), path, name=name)

    def profile_steps(self, batch: Dict[str, Any], n: int, logdir: str):
        """Capture a ``torch.profiler`` trace of ``n`` steps into
        ``logdir`` as a Chrome trace (``trace-<pid>-<ns>.json``; open it in
        Perfetto or ``chrome://tracing``), host and, on the card, device
        activity. Returns the last step's metrics. The steps run exactly
        once: a trace that cannot be captured is a warning, and the steps
        run unprofiled only if they had not run yet."""
        import warnings

        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        metrics = None
        try:
            os.makedirs(logdir, exist_ok=True)
            with torch.profiler.profile(activities=acts) as prof:
                metrics = self.run_steps(batch, n)
            prof.export_chrome_trace(os.path.join(
                logdir, f"trace-{os.getpid()}-{time.time_ns()}.json"))
        except Exception as e:
            warnings.warn(f"profiler trace failed ({e})"
                          + ("; ran unprofiled" if metrics is None else
                             "; steps DID run, capture incomplete"))
            if metrics is None:  # never double-apply optimizer steps
                metrics = self.run_steps(batch, n)
        return metrics


def _data_ways(mesh: Any) -> int:
    """How many ranks split the batch: the product of the data axes."""
    sizes = mesh_sizes(mesh)
    return math.prod(sizes.get(a, 1) for a in DATA_AXES)


def _to_device(tree: Any, dev: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    return tree.to(dev)
