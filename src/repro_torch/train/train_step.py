"""Train-step factory: loss + grad + AdamW, with optional microbatch
gradient accumulation (f32 accumulators).

Counterpart of the reference's ``train/train_step.py``.  The reference's
step is a pure function of (params, opt_state, batch); the port's takes
the model, computes the gradients of its parameters with
``torch.autograd.grad`` and updates the model and the optimizer state in
place (``train/optimizer.py``), returning them.  The microbatch loop is a
Python loop where the reference scans.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import zoo
from repro_torch.train.optimizer import (AdamWConfig, adamw_update,
                                         init_opt_state)


def _on(batch: dict, device: torch.device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def make_train_step(cfg: ArchConfig, opt_cfg: Optional[AdamWConfig] = None,
                    *, microbatches: int = 1, remat: bool = True):
    """Returns train_step(model, opt_state, batch) -> (model, opt, metrics).
    ``batch`` holds "tokens" and "targets" ([B, S], numpy or tensors), and
    the encoder-decoder's "frames" or the VLM's "patch_embeds" (f32); they
    go to the model's device."""
    opt_cfg = opt_cfg or AdamWConfig()

    def grad_fn(model, params: dict, batch: dict):
        loss, metrics = zoo.loss_fn(model, cfg, batch, remat=remat)
        grads = torch.autograd.grad(loss, list(params.values()))
        return loss.detach(), metrics, dict(zip(params, grads))

    def single(model, params, batch):
        loss, metrics, grads = grad_fn(model, params, batch)
        return loss, {k: v.detach() for k, v in metrics.items()}, grads

    def accumulated(model, params, batch):
        mb = next(iter(batch.values())).shape[0] // microbatches
        acc = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for n, p in params.items()}
        loss_acc = torch.zeros((), dtype=torch.float32,
                               device=next(iter(acc.values())).device)
        for i in range(microbatches):
            micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            loss, _, grads = grad_fn(model, params, micro)
            for n, g in grads.items():
                acc[n] = acc[n] + g.to(torch.float32) / microbatches
            loss_acc = loss_acc + loss / microbatches
        return loss_acc, {"loss": loss_acc}, acc

    def train_step(model, opt_state: dict, batch: dict):
        params = dict(model.named_parameters())
        batch = _on(batch, model.device)
        for p in params.values():
            p.requires_grad_(True)
        try:
            with torch.enable_grad():
                if microbatches > 1:
                    loss, metrics, grads = accumulated(model, params, batch)
                else:
                    loss, metrics, grads = single(model, params, batch)
        finally:
            for p in params.values():
                p.requires_grad_(False)
        _, opt_state, opt_metrics = adamw_update(grads, opt_state, params,
                                                 opt_cfg)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        return model, opt_state, metrics

    return train_step


def make_eval_step(cfg: ArchConfig, *, remat: bool = False):
    @torch.no_grad()
    def eval_step(model, batch):
        loss, metrics = zoo.loss_fn(model, cfg, _on(batch, model.device),
                                    remat=remat)
        return metrics

    return eval_step


__all__ = ["make_train_step", "make_eval_step", "init_opt_state",
           "AdamWConfig"]
