"""Environment base contract (port of ``mbd_tpu/envs/base.py``).

Every env exposes ``reset(generator) -> State``, ``step(State, action) ->
State``, ``action_size`` and, for physics envs, ``sys`` / ``dt``.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Dict

import torch


@dataclass
class State:
    """Planner-facing environment state. ``pipeline_state`` is whatever
    the dynamics carries (a ``PipelineState`` for physics envs)."""

    pipeline_state: Any
    obs: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    metrics: Dict[str, torch.Tensor] = field(default_factory=dict)

    def replace(self, **changes) -> "State":
        return replace(self, **changes)


class Env:
    """Base class: subclasses implement reset/step and size properties."""

    def reset(self, generator: torch.Generator) -> State:
        raise NotImplementedError

    def step(self, state: State, action: torch.Tensor) -> State:
        raise NotImplementedError

    @property
    def action_size(self) -> int:
        raise NotImplementedError
