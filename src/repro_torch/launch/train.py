"""The train step at world size 1.

The port of ``repro.launch.train``'s ``make_train_step`` and
``pick_microbatches`` for one device: the batch is split into
microbatches whose gradients accumulate in float32, then the global
gradient norm is taken, the gradients are clipped and AdamW applies
them.  ``with_optimizer=False`` returns the loss and gradients instead.
The step changes none of the tensors it is given (the reference's jit
donates them); it returns new ones.

The gradient of every coded boundary is the reference's custom VJP
(``core.boundary``): on the card, the ``roundtrip_bwd`` kernel at each
coded collective and, under the faithful ``spike`` codec, the
``lif_encode`` backward kernel at each boundary's penalty.
"""
from __future__ import annotations

import dataclasses

import torch

from ..configs.base import ModelConfig, ShapeCell
from ..models import model as M
from ..models.context import make_context
from ..models.params import init_params
from ..optim import adamw

F32 = torch.float32


def pick_microbatches(cfg: ModelConfig, cell: ShapeCell,
                      dp_size: int = 1) -> int:
    """Gradient-accumulation factor: keep a microbatch's activations
    (tokens x d_model) bounded so one block's forward and backward fit
    the card's memory (the reference's rule)."""
    B_loc = max(1, cell.global_batch // dp_size)
    if cell.kind != "train":
        return 1
    tokens = B_loc * cell.seq_len
    target = 8192 * max(1, 4096 // max(cfg.d_model, 1024)) ** 1
    mb = max(1, tokens // max(target, 1))
    while B_loc % mb != 0:
        mb -= 1
    return max(1, min(mb, B_loc))


def init_train_params(cfg: ModelConfig, seed: int = 0, *, device=None):
    """The port's seeded init of ``cfg`` on ``device`` (None -> cuda)."""
    device = torch.device("cuda" if device is None else device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return init_params(M.model_defs(cfg), gen, cfg.dtype, device=device)


def _unflatten(like, leaves):
    """Nested dicts shaped as ``like`` holding ``leaves`` in the order of
    ``adamw.tree_leaves``."""
    it = iter(leaves)

    def rec(node):
        if isinstance(node, dict):
            return {k: rec(node[k]) for k in sorted(node)}
        return next(it)
    return rec(like)


def _as_batch(batch, device):
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, *, microbatches: int = 1,
                    with_optimizer: bool = True,
                    opt_cfg: adamw.AdamWConfig | None = None,
                    device=None, sparsity: dict | None = None):
    """Returns ``step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, or with ``with_optimizer=False`` ``step(params, batch)
    -> (loss, grads, metrics)``.

    ``batch``: ``tokens`` / ``labels`` [B, S] (numpy arrays or tensors;
    moved to ``device``, None -> cuda), B a multiple of
    ``microbatches``.  Microbatch i takes rows ``i*B/n .. (i+1)*B/n``;
    its gradients add into float32 accumulators, and the sums are scaled
    by ``1/n``.  ``metrics``: ``loss`` (the NLL), ``penalty``,
    ``occupancy`` and, with the optimizer, ``grad_norm``, each a 0-d
    float32 tensor.  ``sparsity``: ``SpikeConfig`` fields (``lam``,
    ``target_rate``) that replace the codec's, for the eq-10 penalty."""
    device = torch.device("cuda" if device is None else device)
    ctx = make_context(cfg, "train")
    if sparsity:
        codec = ctx.codec
        ctx = ctx.with_(codec=dataclasses.replace(
            codec, cfg=dataclasses.replace(codec.cfg, **sparsity)))
    n_micro = microbatches
    opt_cfg = opt_cfg or adamw.AdamWConfig()

    def micro_grads(params, batch):
        train = [p.detach().requires_grad_()
                 for p in adamw.tree_leaves(params)]
        tparams = _unflatten(params, train)
        B = batch["tokens"].shape[0]
        if B % n_micro:
            raise ValueError(f"batch of {B} rows does not split into "
                             f"{n_micro} microbatches")
        bm = B // n_micro
        gacc = loss_acc = macc = None
        for i in range(n_micro):
            mb = {k: v[i * bm:(i + 1) * bm] for k, v in batch.items()}
            loss, metrics = M.forward_loss(tparams, mb, ctx)
            grads = torch.autograd.grad(loss, train, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(train, grads)]
            if n_micro == 1:
                return loss.detach(), _unflatten(params, grads), {
                    k: v.detach() for k, v in metrics.items()}
            if gacc is None:
                gacc = [torch.zeros(p.shape, dtype=F32, device=p.device)
                        for p in train]
                loss_acc = torch.zeros((), dtype=F32, device=device)
                macc = {k: torch.zeros((), dtype=F32, device=device)
                        for k in metrics}
            gacc = [a + g.to(F32) for a, g in zip(gacc, grads)]
            loss_acc = loss_acc + loss.detach()
            macc = {k: macc[k] + v.detach() for k, v in metrics.items()}
        inv = 1.0 / n_micro
        return (loss_acc * inv, _unflatten(params, [g * inv for g in gacc]),
                {k: v * inv for k, v in macc.items()})

    if not with_optimizer:
        def grad_step(params, batch):
            return micro_grads(params, _as_batch(batch, device))
        return grad_step

    def step(params, opt_state, batch):
        _, grads, metrics = micro_grads(params, _as_batch(batch, device))
        gnorm = global_grad_norm(grads)
        params, opt_state = adamw.apply_updates(
            params, grads, opt_state, gnorm=gnorm, cfg=opt_cfg)
        metrics = dict(metrics, grad_norm=gnorm)
        return params, opt_state, metrics

    return step


def global_grad_norm(grads):
    """sqrt of the sum of every leaf's squares, in float32."""
    total = None
    for g in adamw.tree_leaves(grads):
        s = torch.sum(torch.square(g.to(F32)))
        total = s if total is None else total + s
    return torch.sqrt(total)
