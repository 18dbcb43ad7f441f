"""The one-device train step (twin of the single-device step of
``repro/train/step.py``): gradient accumulation over microbatches in fp32,
global-norm clipping, the cosine learning rate, skip-on-nonfinite, AdamW
on fp32 master weights.

``train_step(state, batch)``:
  state = {"params": fp32 master params, "opt": AdamState, "step": int}
  batch = {"tokens", "labels", "resets"}: numpy or tensors, (A, B/A, S)
Returns ``(new_state, metrics)``. The params and moments are updated in
place (``repro_torch.optim.adamw``); the returned state holds the same
tensors. The forward runs in ``cfg.dtype`` (bf16 on the card): every
matrix is cast at its use, and the gradients land on the fp32 masters.

The step runs on the params' device: on the card every linear layer
launches the chunk kernels (K1 forward, K2a and K2b backward) through
``ops.linear_attention_op``.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core.tree import leaves_with_paths, tree_map
from repro_torch.models import model as M
from repro_torch.optim import adamw


def state_from_params(params):
    """A fresh train state around ``params`` (fp32 masters): they are made
    to require gradients, the moments start at zero, step 0."""
    for _, p in leaves_with_paths(params):
        p.requires_grad_(True)
    return {"params": params, "opt": adamw.init(params), "step": 0}


def init_state(generator: torch.Generator, cfg: ModelConfig, *, device=None):
    """Random fp32 master params (``cfg.param_dtype``) on ``device`` (the
    card unless another device is named) and a fresh train state."""
    params = M.init_params(generator, cfg, device=device,
                           param_dtype=cfg.param_dtype)
    return state_from_params(params)


def make_loss_fn(cfg: ModelConfig, run: RunConfig):
    def loss_fn(params, micro):
        logits = M.forward(params, micro["tokens"], cfg, remat=run.remat,
                           resets=micro.get("resets"))
        return M.lm_loss(logits, micro["labels"])
    return loss_fn


def _accum_grads(loss_fn, params, batch):
    """Loop over the leading microbatch dim, summing gradients in fp32,
    then average. Returns ``(grads tree, mean loss)``."""
    leaves = [p for _, p in leaves_with_paths(params)]
    n_micro = batch["tokens"].shape[0]
    acc, losses = None, []
    for i in range(n_micro):
        loss = loss_fn(params, {k: v[i] for k, v in batch.items()})
        grads = torch.autograd.grad(loss, leaves)
        if acc is None:
            acc = [g.float() for g in grads]
        else:
            for a, g in zip(acc, grads):
                a.add_(g.float())
        losses.append(loss.detach())
        del loss, grads
    for a in acc:
        a.div_(n_micro)
    it = iter(acc)
    return tree_map(lambda _: next(it), params), torch.stack(losses).mean()


def make_train_step(cfg: ModelConfig, run: RunConfig):
    loss_fn = make_loss_fn(cfg, run)

    def train_step(state, batch):
        params = state["params"]
        device = leaves_with_paths(params)[0][1].device
        batch = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        grads, loss = _accum_grads(loss_fn, params, batch)
        grads, gnorm = adamw.clip_by_global_norm(grads, run.grad_clip)
        # Fault tolerance: a non-finite step is skipped, not applied:
        # params, moments and the Adam count stay, the step advances.
        finite = bool(torch.isfinite(gnorm))
        lr = adamw.cosine_schedule(
            state["step"], base_lr=run.learning_rate,
            warmup_steps=run.warmup_steps, total_steps=run.total_steps,
            min_lr=run.min_lr)
        opt = state["opt"]
        if finite:
            opt = adamw.update(grads, opt, params, lr=lr, b1=run.adam_b1,
                               b2=run.adam_b2,
                               weight_decay=run.weight_decay)
        new_state = {"params": params, "opt": opt, "step": state["step"] + 1}
        metrics = {"loss": float(loss), "grad_norm": float(gnorm), "lr": lr,
                   "skipped": 0.0 if finite else 1.0}
        return new_state, metrics

    return train_step
