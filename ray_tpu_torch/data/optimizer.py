"""Rule-based logical-plan optimizer for Data pipelines (a copy of
``ray_tpu/data/optimizer.py``).

Role analog: the reference optimizer framework under
``python/ray/data/_internal/logical/`` — ``Rule``/``Optimizer`` interfaces
(``interfaces/optimizer.py``) with rules like
``rules/operator_fusion.py``. Each rule is a pure
``List[LogicalOp] -> List[LogicalOp]`` rewrite; the optimizer applies the
rule list to a fixpoint (bounded), so rules compose — e.g. eliminating a
redundant shuffle can expose two maps to the fusion rule.

Built-in rules:

- :class:`EliminateRedundantShuffles` — SAME-KIND back-to-back exchanges
  keep only the last: random_shuffle followed by an UNSEEDED
  random_shuffle, or repartition followed by repartition. Mixed kinds
  never collapse (a repartition is order-preserving and cannot stand in
  for a shuffle; block counts differ the other way);
- :class:`CollapseRepartitionIntoShuffle` — repartition followed by an
  UNSEEDED random_shuffle becomes one shuffle carrying the repartition's
  block count (the shuffle redistributes every row anyway);
- :class:`FuseLimits` — consecutive limits collapse to the minimum;
- :class:`OperatorFusionRule` — consecutive task-compute MapOps fuse into
  one stage (``fuse_ops``).

``ExecutionOptions.optimizer`` overrides the default; tests pin
golden plans against rule output (reference golden-plan optimizer tests).
"""

from __future__ import annotations

from typing import List

from ray_tpu_torch.data.execution import (LimitOp, LogicalOp, MapOp, ShuffleOp,
                                    fuse_ops)


class Rule:
    """A pure logical-plan rewrite (reference ``Rule`` interface role)."""

    def apply(self, plan: List[LogicalOp]) -> List[LogicalOp]:
        raise NotImplementedError

    @property
    def name(self) -> str:
        return type(self).__name__


class OperatorFusionRule(Rule):
    def apply(self, plan: List[LogicalOp]) -> List[LogicalOp]:
        return fuse_ops(plan)


class EliminateRedundantShuffles(Rule):
    """Drop a full-data exchange whose effect the NEXT op reproduces:

    - ``random_shuffle`` followed by an UNSEEDED ``random_shuffle`` — the
      output distribution is identical either way;
    - ``repartition`` followed by ``repartition`` — the row set is
      unchanged and the last call decides the block count.

    Deliberately NOT collapsed: mixed kinds (a repartition is
    order-preserving, so it cannot stand in for a shuffle and vice versa
    — block counts differ), and any case where the surviving shuffle is
    SEEDED (dropping the predecessor would change the deterministic
    output the seed promises)."""

    def apply(self, plan: List[LogicalOp]) -> List[LogicalOp]:
        out: List[LogicalOp] = []
        for op in plan:
            prev = out[-1] if out else None
            if (isinstance(op, ShuffleOp) and isinstance(prev, ShuffleOp)
                    and ((op.kind == "random_shuffle"
                          and prev.kind == "random_shuffle"
                          and op.args.get("seed") is None)
                         or (op.kind == "repartition"
                             and prev.kind == "repartition"))):
                out[-1] = op  # later exchange wins
            else:
                out.append(op)
        return out


class CollapseRepartitionIntoShuffle(Rule):
    """``repartition(n)`` immediately followed by an UNSEEDED
    ``random_shuffle`` collapses to ``random_shuffle(num_blocks=n)``: the
    shuffle redistributes every row anyway, so the order-preserving
    repartition pass is pure wasted work — one full-data exchange instead
    of two. The repartition's block count survives as the shuffle's
    ``num_blocks`` (unless the shuffle already pins its own). SEEDED
    shuffles never collapse: their deterministic output depends on the
    exact input block boundaries the repartition would have produced."""

    def apply(self, plan: List[LogicalOp]) -> List[LogicalOp]:
        out: List[LogicalOp] = []
        for op in plan:
            prev = out[-1] if out else None
            if (isinstance(op, ShuffleOp) and op.kind == "random_shuffle"
                    and op.args.get("seed") is None
                    and isinstance(prev, ShuffleOp)
                    and prev.kind == "repartition"):
                args = dict(op.args)
                if not args.get("num_blocks"):
                    args["num_blocks"] = prev.args.get("num_blocks")
                out[-1] = ShuffleOp(op.name, "random_shuffle", args)
            else:
                out.append(op)
        return out


class FuseLimits(Rule):
    def apply(self, plan: List[LogicalOp]) -> List[LogicalOp]:
        out: List[LogicalOp] = []
        for op in plan:
            if (isinstance(op, LimitOp) and out
                    and isinstance(out[-1], LimitOp)):
                out[-1] = LimitOp(name="limit",
                                  limit=min(out[-1].limit, op.limit))
            else:
                out.append(op)
        return out


DEFAULT_RULES: List[Rule] = [
    EliminateRedundantShuffles(),
    CollapseRepartitionIntoShuffle(),
    FuseLimits(),
    OperatorFusionRule(),
]


class Optimizer:
    """Applies rules to a fixpoint (bounded passes), reference
    ``LogicalOptimizer`` role."""

    def __init__(self, rules: List[Rule] = None, max_passes: int = 5):
        self.rules = list(DEFAULT_RULES if rules is None else rules)
        self.max_passes = max_passes

    def optimize(self, plan: List[LogicalOp]) -> List[LogicalOp]:
        for _ in range(self.max_passes):
            before = _plan_signature(plan)
            for rule in self.rules:
                plan = rule.apply(plan)
            if _plan_signature(plan) == before:
                break
        return plan


def _plan_signature(plan: List[LogicalOp]) -> tuple:
    sig = []
    for op in plan:
        if isinstance(op, MapOp):
            sig.append(("map", op.name, id(op.fn), id(op.compute)))
        elif isinstance(op, ShuffleOp):
            sig.append(("shuffle", op.kind, tuple(sorted(op.args))))
        elif isinstance(op, LimitOp):
            sig.append(("limit", op.limit))
        else:
            sig.append((type(op).__name__,))
    return tuple(sig)


def plan_summary(plan: List[LogicalOp]) -> List[str]:
    """Human/golden-test readable plan: ['map:a->b', 'shuffle:sort', ...]"""
    out = []
    for op in plan:
        if isinstance(op, MapOp):
            kind = "actor_map" if op.compute is not None else "map"
            out.append(f"{kind}:{op.name}")
        elif isinstance(op, ShuffleOp):
            out.append(f"shuffle:{op.kind}")
        elif isinstance(op, LimitOp):
            out.append(f"limit:{op.limit}")
        else:
            out.append(type(op).__name__)
    return out
