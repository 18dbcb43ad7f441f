"""The train steps (twin of ``repro/train/step.py``): gradient
accumulation over microbatches in fp32, global-norm clipping, the cosine
learning rate, skip-on-nonfinite, AdamW on fp32 master weights; on one
device, or across the ranks of a DP×SP(×TP) layout
(:class:`ShardedStep`).

With ``run.guard`` the numerical health guard
(``repro_torch.resilience.guard``) replaces the plain clip in both steps:
a skip verdict on a non-finite loss or gradient, rolling-median spike
clipping, and the ``GUARD_METRICS`` in the metrics; ``state["guard"]``
carries its window and counters. ``run.chaos_nan_steps`` fills the
gradients with NaN at those steps, guard on or off; ``run.chaos_skip_steps``
forces a skip verdict at those steps under the guard (the reference's
steps read it in the guard's verdict only). A skipped step leaves params,
moments and Adam's count bit for bit as they were, and the step advances.

``train_step(state, batch)``:
  state = {"params": fp32 master params, "opt": AdamState, "step": int,
           ["guard": guard state]}
  batch = {"tokens", "labels", "resets"}: numpy or tensors, (A, B/A, S);
          for the cross family also ``"frames"`` (A, B/A, n_frames, d),
          the encoder's input, or ``"img"`` (A, B/A, n_img, d), the image
          embeddings
Returns ``(new_state, metrics)``. The params and moments are updated in
place (``repro_torch.optim.adamw``); the returned state holds the same
tensors. The forward runs in ``cfg.dtype`` (bf16 on the card): every
matrix is cast at its use, and the gradients land on the fp32 masters.

Two ``RunConfig`` fields change the precision of the params, as in the
reference: under ``run.cast_params_once`` each step makes one copy in
``cfg.dtype`` of every fp32 param of 2 or more dims in the reference's
stacked layout before the microbatch loop (:func:`cast_matrices`),
differentiates with respect to the copies and sums their gradients in
fp32 for AdamW to apply to the masters; under ``run.bf16_params`` those
params are stored in bf16 (:func:`state_from_params`), the Adam moments
stay fp32, each microbatch's bf16 gradients are summed in fp32, and
AdamW rounds its fp32 result into each bf16 leaf. Both steps'
collectives stay as they are: the one gradient reduction and ZeRO-1's
param gather carry fp32.

The step runs on the params' device: on the card every linear layer
launches the chunk kernels (K1 forward, K2a and K2b backward) through
``ops.linear_attention_op``.

MoE layers add their router loss to the one-device objective
(``MOE_AUX_COEF`` times the summed aux); the reported ``loss`` stays the
cross-entropy alone, as the reference's. The DP×SP step refuses MoE
layers: the reference's manual step cannot run them either (its
``moe_apply`` opens a ``shard_map`` of its own inside the step's), and
it refuses the cross family's frames and images, as the reference's.
"""

from __future__ import annotations

import torch

from repro_torch.comm import primitives
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core.device import torch_dtype
from repro_torch.core.lasp2 import SPConfig
from repro_torch.core.lasp2h import check_ulysses_heads
from repro_torch.core.tree import leaves_with_paths, tree_map
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.resilience import guard as health

MOE_AUX_COEF = 0.01


def zero1_degree(run: RunConfig, layout=None) -> int:
    """Ranks the optimizer state is sharded over under ZeRO-1
    (``run.zero1``): the zero group's dp·tp, over the (data, model) axes
    whose size is above 1, as the reference's plan; 1 without ZeRO-1 or
    when that product is 1 (so at (1, sp, 2) the moments shard over the
    model axis though dp is 1)."""
    if layout is not None and run.zero1 and layout.zero_degree > 1:
        return layout.zero_degree
    return 1


def check_layout_strategy(strategy: str, tp: int) -> None:
    """Refuse an exchange that a 3D layout (tp > 1) cannot run: the ring
    and pipelined exchanges span one sequence group, and the 3D layout's
    tokens split over (sequence, model). The reference's plan refuses
    them with this message."""
    if tp > 1 and strategy not in ("allgather", "ulysses"):
        raise ValueError(
            f"comm strategy {strategy!r} does not support the 3D DP×SP×TP "
            f"mesh (the ring/pipelined exchanges are wired for a single "
            f"sequence axis); use 'allgather' or 'ulysses'")


def cast_matrices(params, dtype: torch.dtype):
    """The reference's ``_cast_tree``: each fp32 leaf of 2 or more dims in
    the reference's layout as a new tensor in ``dtype``, detached from
    the param; every other leaf as it is (every leaf, when ``dtype`` is
    fp32). The reference stacks each pattern position's layers over a
    leading group axis, so a layer's 1-d leaves (norm scales, biases, the
    SSD heads' ``dt_bias``, ``a_log`` and ``d_skip``) have 2 dims there
    and are cast with the matrices; its 0-d ``gate``, the final norms'
    scales and every leaf outside ``layers`` of fewer than 2 dims stay
    fp32."""
    def cast(path, p):
        dims = p.dim() + ("layers" in path)
        if p.dtype == torch.float32 and dims >= 2 and \
                dtype != torch.float32:
            return p.detach().to(dtype)
        return p
    it = iter([cast(path, p) for path, p in leaves_with_paths(params)])
    return tree_map(lambda _: next(it), params)


def _compute_params(cfg: ModelConfig, run: RunConfig, params):
    """The params the forward reads: under ``run.cast_params_once`` this
    step's copies in ``cfg.dtype`` (:func:`cast_matrices`), leaves that
    require gradients; else ``params``."""
    if not run.cast_params_once:
        return params
    return tree_map(lambda p: p.requires_grad_(True),
                    cast_matrices(params, torch_dtype(cfg.dtype)))


def state_from_params(params, zero1: int = 1, run: RunConfig = None):
    """A fresh train state around ``params`` (fp32 masters; under
    ``run.bf16_params`` the matrices stored in bf16 as the reference's
    ``init_state`` stores them, :func:`cast_matrices`): they are made to
    require gradients, the fp32 moments start at zero (one rank's flat
    slice of ``zero1`` when above 1), step 0; with ``run.guard`` also the
    guard's state."""
    if run is not None and run.bf16_params:
        params = cast_matrices(params, torch.bfloat16)
    for _, p in leaves_with_paths(params):
        p.requires_grad_(True)
    opt = adamw.zero1_init(params, zero1) if zero1 > 1 \
        else adamw.init(params)
    state = {"params": params, "opt": opt, "step": 0}
    if run is not None and run.guard:
        device = leaves_with_paths(params)[0][1].device
        state["guard"] = health.guard_init(run.guard_window, device)
    return state


def init_state(generator: torch.Generator, cfg: ModelConfig, *, device=None,
               zero1: int = 1, run: RunConfig = None):
    """Random fp32 master params (``cfg.param_dtype``) on ``device`` (the
    card unless another device is named) and a fresh train state
    (:func:`state_from_params`: the matrices in bf16 under
    ``run.bf16_params``)."""
    params = M.init_params(generator, cfg, device=device,
                           param_dtype=cfg.param_dtype)
    return state_from_params(params, zero1, run)


def make_loss_fn(cfg: ModelConfig, run: RunConfig):
    """``loss_fn(params, micro) → (objective, cross-entropy)``: the
    objective adds ``MOE_AUX_COEF`` times the MoE layers' router loss. A
    microbatch's ``"frames"`` go to the encoder, its ``"img"`` to the
    cross layers."""
    def loss_fn(params, micro):
        logits, aux = M.forward_with_aux(params, micro["tokens"], cfg,
                                         remat=run.remat,
                                         resets=micro.get("resets"),
                                         enc_frames=micro.get("frames"),
                                         img_emb=micro.get("img"))
        loss = M.lm_loss(logits, micro["labels"])
        return loss + MOE_AUX_COEF * aux, loss
    return loss_fn


def _accum_grads(loss_fn, params, batch):
    """Loop over the leading microbatch dim, summing the objective's
    gradients with respect to ``params`` in fp32 (a bf16 leaf's too), then
    average. Returns ``(fp32 grads tree, mean cross-entropy)``."""
    leaves = [p for _, p in leaves_with_paths(params)]
    n_micro = batch["tokens"].shape[0]
    acc, losses = None, []
    for i in range(n_micro):
        total, loss = loss_fn(params, {k: v[i] for k, v in batch.items()})
        grads = torch.autograd.grad(total, leaves)
        if acc is None:
            acc = [g.float() for g in grads]
        else:
            for a, g in zip(acc, grads):
                a.add_(g.float())
        losses.append(loss.detach())
        del total, loss, grads
    for a in acc:
        a.div_(n_micro)
    it = iter(acc)
    return tree_map(lambda _: next(it), params), torch.stack(losses).mean()


@torch.no_grad()
def _clip(run: RunConfig, state, grads, loss_bad):
    """Scale the gradients (a tree, or the flat vector) in place: the plain
    global-norm clip, or with ``run.guard`` by the guard's verdict,
    ``loss_bad`` (a 0-d bool tensor) joining its non-finite test. Returns
    ``(norm before clipping, ok, new guard state or None, guard
    metrics)``, all 0-d tensors on the device; ``ok`` is False for a step
    to skip. Nothing waits for the device: the skip is a select in the
    update (``adamw.update(ok=)``), as the reference's ``jnp.where``."""
    if not run.guard:
        _, gnorm = adamw.clip_by_global_norm(grads, run.grad_clip)
        return gnorm, torch.isfinite(gnorm), None, {}
    gnorm = adamw.global_norm(grads)
    nonfinite = torch.logical_not(torch.isfinite(gnorm)) | loss_bad
    if health.chaos_hit(state["step"], run.chaos_skip_steps):
        nonfinite = torch.ones_like(nonfinite)
    scale, ok, new_guard, info = health.guard_verdict(
        state["guard"], gnorm, nonfinite, grad_clip=run.grad_clip,
        spike_factor=run.guard_spike_factor)
    for _, g in leaves_with_paths(grads):
        g.mul_(scale)
    return gnorm, ok, new_guard, info


def _finish_step(run: RunConfig, state, gnorm, update, ok, new_guard):
    """The tail both steps share, after the gradients are clipped: the
    cosine learning rate and the skip. ``update(lr, ok)`` applies AdamW
    where ``ok`` holds and returns the new optimizer state; where it does
    not, params, moments and the Adam count keep their bits, and the step
    advances. Returns ``(new_state, metrics without the loss)``: the
    metrics are 0-d tensors on the device (``lr`` a host float), for the
    caller to read after its fence (``obs.metrics.to_host``)."""
    lr = adamw.cosine_schedule(
        state["step"], base_lr=run.learning_rate,
        warmup_steps=run.warmup_steps, total_steps=run.total_steps,
        min_lr=run.min_lr)
    opt = update(lr, ok)
    new_state = {"params": state["params"], "opt": opt,
                 "step": state["step"] + 1}
    if new_guard is not None:
        new_state["guard"] = new_guard
    return new_state, {"grad_norm": gnorm, "lr": lr,
                       "skipped": torch.logical_not(ok).float()}


def make_train_step(cfg: ModelConfig, run: RunConfig, layout=None):
    """The one-device step, or with a ``layout``
    (``launch.mesh.TrainingGroups``) the DP×SP step of this rank."""
    if layout is not None:
        return ShardedStep(cfg, run, layout)
    loss_fn = make_loss_fn(cfg, run)

    def train_step(state, batch):
        params = state["params"]
        device = leaves_with_paths(params)[0][1].device
        batch = {k: torch.as_tensor(v).to(device, non_blocking=True)
                 for k, v in batch.items()}
        # under cast_params_once the gradients of the copies are those of
        # the masters, summed in fp32 (the reference's cast back)
        grads, loss = _accum_grads(loss_fn,
                                   _compute_params(cfg, run, params), batch)
        for _, g in leaves_with_paths(grads):
            health.chaos_poison_nan(g, state["step"], run.chaos_nan_steps)
        gnorm, ok, new_guard, ginfo = _clip(
            run, state, grads, torch.logical_not(torch.isfinite(loss)))
        new_state, metrics = _finish_step(
            run, state, gnorm,
            lambda lr, ok: adamw.update(grads, state["opt"], params, lr=lr,
                                        b1=run.adam_b1, b2=run.adam_b2,
                                        weight_decay=run.weight_decay,
                                        ok=ok),
            ok, new_guard)
        return new_state, {"loss": loss, **metrics, **ginfo}

    return train_step


# ---------------------------------------------------------------------------
# The DP×SP step (data × sequence ranks).
# ---------------------------------------------------------------------------

def shard_batch(batch, layout):
    """This rank's rows and sequence chunk of a global (A, B/A, S) batch:
    rows ``[d·R, (d+1)·R)`` and positions ``[t·C, (t+1)·C)`` for data index
    d and token chunk index t (``s·tp + m`` on a 3D layout: the sequence
    splits over sp·tp chunks, sequence-major). Labels were shifted over
    the whole row, so a chunk's last label is the next chunk's first
    token; a chunk's resets start False unless a document starts
    there."""
    rows, seq = batch["tokens"].shape[1], batch["tokens"].shape[2]
    if rows % layout.dp or seq % layout.tokens:
        raise ValueError(
            f"DP×SP step needs microbatch rows ({rows}) divisible by dp "
            f"({layout.dp}) and seq len ({seq}) by sp×tp ({layout.sp}×"
            f"{layout.tp})")
    r, c = rows // layout.dp, seq // layout.tokens
    d, t = layout.data_index, layout.chunk_index
    return {k: v[:, d * r:(d + 1) * r, t * c:(t + 1) * c]
            for k, v in batch.items()}


class ShardedStep:
    """The DP×SP(×TP) step of one rank (``repro/train/step.py``'s manual
    step) on a ``launch.mesh.TrainingGroups`` layout:

    - the unnormalised local objective (the CE sum of this rank's rows and
      chunk), its gradients accumulated by autograd over the microbatches
      into per-leaf views of ONE flat fp32 buffer (a second full-width
      copy is what a full-width step on one card could not hold); a bf16
      leaf's gradient (``run.bf16_params``, or the step's copy under
      ``run.cast_params_once``) is added to its view in fp32 after each
      microbatch;
    - every collective of the model on its SP group (the sp·tp token
      group), by ``run.comm_strategy``: per linear layer one state
      all-gather forward (``lasp2.states``) or the ring's hops
      (``lasp2.ring``, ``lasp2.pipelined[i]``; 2D layouts only), per
      softmax layer the K/V all-gathers (``lasp2h.k``, ``lasp2h.v``) or
      Ulysses' two all-to-alls (``ulysses.in``, ``ulysses.out``; on a 3D
      layout over the tp group, with the K/V all-gathers ``ulysses.k``,
      ``ulysses.v`` over the sequence group when sp > 1), their
      backwards;
    - exactly ONE gradient reduction: the flat gradients ‖ [ce_sum, n]
      all-reduced over every rank (``train.grads``), then normalised by
      the global token count; with ``run.guard`` a third tail scalar, this
      rank's loss-health indicator, rides in the same buffer (4 bytes, no
      collective), so every rank reaches the guard's verdict from the
      same reduced values;
    - clipping (or the guard), the learning rate and skip-on-nonfinite as
      the one-device step (``_clip``, ``_finish_step``); only the loss
      differs: the global token mean here, the mean of the microbatch
      means there (the reference's two steps differ the same way);
    - ZeRO-1 over the zero group, the dp·tp ranks of this sequence index
      (``zero1_degree`` > 1): each rank Adam-updates its slice of the
      raveled params (slice ``d·tp + m``) and ONE all-gather
      (``zero1.param_gather``) re-forms them. Params stay replicated:
      the "model" axis does not shard weights.

    ``run.grad_compression`` raises, as the reference's manual step.

    Every rank must issue the same collectives in the same order, so a
    rank whose rows are all masked still joins the reduction
    (``n_tot = max(n, 1)``).
    """

    def __init__(self, cfg: ModelConfig, run: RunConfig, layout):
        if any(spec.mlp == "moe" for spec in cfg.pattern):
            raise NotImplementedError(
                f"{cfg.name}: MoE layers do not run under the DP×SP step; "
                f"the reference's manual step refuses them too (its "
                f"moe_apply opens its own shard_map inside the step's "
                f"manual one). Train MoE configs on one device.")
        if cfg.encoder is not None or cfg.n_image_tokens:
            raise NotImplementedError(
                f"{cfg.name}: encoder/VLM aux inputs are not supported on "
                f"the 2D DP×SP training plan yet (as in the reference); "
                f"train the cross family on one device")
        if run.grad_compression:
            raise NotImplementedError(
                "grad_compression targets pod meshes; not supported on the "
                "2D DP×SP plan")
        check_layout_strategy(run.comm_strategy, layout.tp)
        self.cfg, self.run, self.layout = cfg, run, layout
        self.sp = None
        if layout.tokens > 1:
            self.sp = SPConfig(layout.sp_group, comm=run.comm_spec(),
                               tp_group=layout.tp_group,
                               seq_group=layout.seq_group)
            if run.comm_strategy == "ulysses":
                check_ulysses_heads(cfg.n_heads, cfg.n_kv_heads,
                                    *((layout.sp, "sp") if layout.tp == 1
                                      else (layout.tp, "tp")))
        self.zero1 = zero1_degree(run, layout)
        self._buf = None
        self._decay = None

    def _buffer(self, params):
        """The flat fp32 buffer (gradients ‖ [ce, n] ‖ [loss health] under
        the guard) and the number of gradient entries."""
        n = sum(p.numel() for _, p in leaves_with_paths(params))
        size = n + (3 if self.run.guard else 2)
        if self._buf is None or self._buf.numel() != size:
            device = leaves_with_paths(params)[0][1].device
            self._buf = torch.empty((size,), dtype=torch.float32,
                                    device=device)
        return self._buf, n

    def grads(self, params, batch, step: int = 0):
        """Gradients of the global mean CE over this step's global batch,
        reduced over every rank: ``(flat grads (a view of the buffer),
        ce_tot, n_tot)``, both 0-d fp32 tensors. ``step`` is the train
        step's index (``run.chaos_nan_steps`` poisons this rank's
        gradients before the reduction). Under the guard the reduced
        loss-health sum is ``self.loss_bad`` (> 0: a rank saw a non-finite
        loss)."""
        if "frames" in batch or "img" in batch:
            raise NotImplementedError(
                "encoder/VLM aux inputs are not supported on the 2D DP×SP "
                "training plan yet")
        compute = _compute_params(self.cfg, self.run, params)
        leaves = [p for _, p in leaves_with_paths(compute)]
        device = leaves[0].device
        buf, n = self._buffer(params)
        buf.zero_()
        # an fp32 leaf's gradient accumulates in its view of the buffer; a
        # bf16 leaf's (bf16_params, or this step's copy) is added to its
        # view in fp32 after each microbatch, the reference's
        # acc + g.astype(f32)
        low, off = [], 0
        for p in leaves:
            view = buf[off:off + p.numel()].view_as(p)
            if p.dtype == torch.float32:
                p.grad = view
            else:
                low.append((p, view))
            off += p.numel()
        batch = shard_batch({k: torch.as_tensor(v) for k, v in
                             batch.items()}, self.layout)
        ce = torch.zeros((), dtype=torch.float32, device=device)
        cnt = torch.zeros((), dtype=torch.float32, device=device)
        bad = torch.zeros((), dtype=torch.bool, device=device)
        try:
            for i in range(batch["tokens"].shape[0]):
                micro = {k: v[i].to(device) for k, v in batch.items()}
                logits = M.forward(compute, micro["tokens"], self.cfg,
                                   remat=self.run.remat,
                                   resets=micro.get("resets"), sp=self.sp)
                ce_sum, n_valid, _ = M.lm_loss_sum(logits, micro["labels"])
                del logits
                ce_sum.backward()
                with torch.no_grad():
                    for p, view in low:
                        if p.grad is not None:
                            view.add_(p.grad)
                            p.grad = None
                ce += ce_sum.detach()
                cnt += n_valid
                bad |= torch.logical_not(torch.isfinite(ce_sum.detach()))
        finally:
            for p in leaves:
                p.grad = None
        health.chaos_poison_nan(buf[:n], step, self.run.chaos_nan_steps)
        buf[n] = ce
        buf[n + 1] = cnt
        if self.run.guard:
            buf[n + 2] = bad.float()
        primitives.psum_packed(buf, self.layout.world_group,
                               tag="train.grads")
        if self.run.guard:
            self.loss_bad = buf[n + 2] > 0
        n_tot = torch.clamp(buf[n + 1], min=1.0)   # all masked → loss 0
        gflat = buf[:n]
        gflat.div_(n_tot)
        return gflat, buf[n].clone(), n_tot

    @torch.no_grad()
    def _zero1_update(self, params, opt, gflat, n, lr, ok):
        run, layout = self.run, self.layout
        padded = adamw.zero1_padded_size(params, self.zero1)
        shard = padded // self.zero1
        lo = layout.zero_index * shard
        if self._decay is None:
            self._decay = adamw.decay_mask(params, lo, lo + shard)
        count = opt.count + 1
        g_sh = torch.zeros((shard,), dtype=torch.float32,
                           device=gflat.device)
        g_sh[:max(min(n - lo, shard), 0)] = gflat[lo:lo + shard]
        new_p = adamw.zero1_update_shard(
            g_sh, opt.m, opt.v, adamw.flat_slice(params, lo, lo + shard),
            self._decay, count, lr=lr, b1=run.adam_b1, b2=run.adam_b2,
            weight_decay=run.weight_decay, ok=ok)
        # ZeRO-1's all-gather-on-update
        gathered = primitives.allgather_states(
            new_p, layout.zero_group, gather_axis=0, tiled=True,
            tag="zero1.param_gather")
        off = 0
        for _, p in leaves_with_paths(params):
            p.copy_(gathered[off:off + p.numel()].view_as(p))
            off += p.numel()
        return adamw.Zero1AdamState(opt.m, opt.v,
                                    torch.where(ok, count, opt.count))

    def _update(self, params, opt, gflat, lr, ok):
        """AdamW on the clipped flat gradients where ``ok`` holds: this
        rank's ZeRO-1 slice, or every param (replicated)."""
        run = self.run
        if self.zero1 > 1:
            return self._zero1_update(params, opt, gflat, gflat.numel(), lr,
                                      ok)
        it = iter(torch.split(gflat, [p.numel() for _, p in
                                      leaves_with_paths(params)]))
        grads = tree_map(lambda p: next(it).view_as(p), params)
        return adamw.update(grads, opt, params, lr=lr, b1=run.adam_b1,
                            b2=run.adam_b2, weight_decay=run.weight_decay,
                            ok=ok)

    def __call__(self, state, batch):
        params = state["params"]
        gflat, ce_tot, n_tot = self.grads(params, batch, state["step"])
        # the norm, the loss and the health sum are the same on every rank
        # after the one reduction, so every rank reaches the same verdict
        loss_bad = torch.logical_not(torch.isfinite(ce_tot))
        if self.run.guard:
            loss_bad = loss_bad | self.loss_bad
        gnorm, ok, new_guard, ginfo = _clip(self.run, state, gflat, loss_bad)
        new_state, metrics = _finish_step(
            self.run, state, gnorm,
            lambda lr, ok: self._update(params, state["opt"], gflat, lr, ok),
            ok, new_guard)
        return new_state, {"loss": ce_tot / n_tot, **metrics, **ginfo}
