"""Elastic / fault-tolerant training loop.

Counterpart of the reference's ``train/elastic.py``.  The recoverable loop
wraps a train step with:
- periodic (async) checkpointing via :class:`CheckpointManager`;
- crash recovery: on any step failure, restore the latest checkpoint and
  continue (the failure hook is injectable so tests can simulate dying
  nodes).
``LoopConfig`` and ``recoverable_train_loop`` are the reference's code.
Where the reference re-meshes a state onto other shardings, the port has
one device: ``reshard_state`` moves a state tree to a device.

Straggler mitigation lives in repro_torch/train/data.py (prefetch +
deadline skip-and-backfill).
"""
from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch
from torch import nn

from repro_torch.train.checkpoint import CheckpointManager

log = logging.getLogger(__name__)


@dataclass
class LoopConfig:
    total_steps: int
    checkpoint_every: int = 50
    checkpoint_async: bool = True
    max_restarts: int = 3


def reshard_state(state: Any, device) -> Any:
    """The state tree on ``device``: tensors copied there, modules moved
    there in place, tuples and lists kept."""
    if isinstance(state, nn.Module):
        return state.to(device)
    if isinstance(state, (list, tuple)):
        return type(state)(reshard_state(x, device) for x in state)
    if isinstance(state, dict):
        return {k: reshard_state(v, device) for k, v in state.items()}
    return state.to(device) if isinstance(state, torch.Tensor) else state


def recoverable_train_loop(state, batch_iter, step_fn: Callable, *,
                           ckpt: CheckpointManager, cfg: LoopConfig,
                           start_step: int = 0,
                           fault_hook: Optional[Callable[[int], None]] = None,
                           on_metrics: Optional[Callable] = None):
    """Runs step_fn(state, batch) -> (state, metrics) with checkpoint/restart.

    Returns (final_state, steps_run, restarts)."""
    step = start_step
    restarts = 0
    while step < cfg.total_steps:
        try:
            if fault_hook is not None:
                fault_hook(step)  # tests raise here to simulate node loss
            batch = next(batch_iter)
            state, metrics = step_fn(state, batch)
            step += 1
            if on_metrics is not None:
                on_metrics(step, metrics)
            if step % cfg.checkpoint_every == 0 or step == cfg.total_steps:
                if cfg.checkpoint_async:
                    ckpt.save_async(step, state, extra={"step": step})
                else:
                    ckpt.save(step, state, extra={"step": step})
        except (StopIteration,):
            break
        except Exception as e:  # noqa: BLE001 - the recovery path
            restarts += 1
            log.warning("step %d failed (%s); restart %d", step, e, restarts)
            if restarts > cfg.max_restarts:
                raise
            ckpt.wait()
            latest = ckpt.latest_step()
            if latest is not None:
                state, extra = ckpt.restore(state)
                step = extra.get("step", latest)
            # else: restart from the initial state
    ckpt.wait()
    return state, step, restarts
