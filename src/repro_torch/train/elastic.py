"""Elastic re-meshing and straggler detection (the port of
``repro/train/elastic.py``).

Elastic: on host failure, the largest usable (data, model) mesh is planned
from the surviving device count, the model axis intact (the tensor-parallel
degree is fixed by the sharded weights; data parallelism absorbs the loss).
Straggler mitigation: a step longer than ``threshold`` x the rolling median
marks a straggler; the policy says what to do ("flag", "rebalance",
"evict").

``build_mesh_from_plan`` returns a ``torch.distributed`` ``DeviceMesh`` over
the whole process group (``distributed.query_shard.make_mesh``), so the
plan's device count must be the world size; the re-mesh of a sharded
training job waits for ROADMAP Queue 1 item 16.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    mesh_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    n_devices: int
    note: str


def plan_remesh(n_surviving: int, model_parallel: int,
                axis_names: Tuple[str, ...] = ("data", "model")) -> ElasticPlan:
    """Largest (data, model) mesh with the model axis preserved, e.g. 256 ->
    240 devices with model=16 gives data=15."""
    if n_surviving < model_parallel:
        raise RuntimeError(
            f"cannot keep model_parallel={model_parallel} with {n_surviving} devices")
    data = n_surviving // model_parallel
    used = data * model_parallel
    return ElasticPlan(
        mesh_shape=(data, model_parallel),
        axis_names=axis_names,
        n_devices=used,
        note=f"{n_surviving} surviving -> mesh {data}x{model_parallel} ({used} used)",
    )


def build_mesh_from_plan(plan: ElasticPlan, device=None):
    """The plan's mesh over the process group (its size must be the plan's
    device count); ``device`` picks the mesh's device type."""
    from repro_torch.distributed.query_shard import make_mesh

    return make_mesh(plan.mesh_shape, plan.axis_names, device=device)


class StragglerMonitor:
    def __init__(self, threshold: float = 2.0, window: int = 32, policy: str = "flag"):
        self.threshold = threshold
        self.window: Deque[float] = deque(maxlen=window)
        self.policy = policy
        self.flagged: List[Tuple[int, float, float]] = []  # (step, dur, median)
        self._t0: Optional[float] = None
        self._step = 0

    def step_start(self):
        self._t0 = time.perf_counter()

    def step_end(self) -> Optional[str]:
        """Returns an action string when a straggler is detected."""
        dur = time.perf_counter() - self._t0
        self._step += 1
        med = float(np.median(self.window)) if len(self.window) >= 8 else None
        self.window.append(dur)
        if med is not None and dur > self.threshold * med:
            self.flagged.append((self._step, dur, med))
            if self.policy == "evict":
                return "evict"
            if self.policy == "rebalance":
                return "rebalance"
            return "flag"
        return None

    @property
    def median(self) -> float:
        return float(np.median(self.window)) if self.window else 0.0


__all__ = ["ElasticPlan", "plan_remesh", "build_mesh_from_plan", "StragglerMonitor"]
