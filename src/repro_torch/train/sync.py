"""Microbatch gradient accumulation on one device.

Port of the non-overlapped branch of ``src/repro/train/sync.py::
accumulate_grads`` (``:68-131``). On one device with ``grad_compress=
"none"`` finalising the grads is the identity (``XlaSync.finalize_grads``,
``:228-242``), so no sync strategy is ported; multi-device sync is queued in
ROADMAP.md.
"""
from __future__ import annotations

from repro_torch.optim.adam import tree_map


def accumulate_grads(micro_grad, batch: dict, microbatch: int):
    """``micro_grad(mb_batch) -> (grads, loss)`` on one microbatch; ``loss``
    is a tensor (the step builder's ``[loss, ce]``).

    With ``microbatch == 1`` the grads come back as they are (the params'
    dtype). Otherwise each microbatch's grads are added into fp32
    accumulators, which are divided by ``microbatch`` at the end, and the
    losses are averaged. Returns ``(grads, loss)``. (The reference returns
    the averaged total as its ``ce`` too when it accumulates, ``:131``; the
    port averages each.)"""
    if microbatch == 1:
        return micro_grad(batch)

    def split(x):
        return x.reshape(microbatch, x.shape[0] // microbatch, *x.shape[1:]).unbind(0)

    micro = {k: split(v) for k, v in batch.items()}
    grads = loss = None
    for i in range(microbatch):
        g, mb_loss = micro_grad({k: v[i] for k, v in micro.items()})
        if grads is None:  # fp32 grads are fresh tensors of ours: accumulate in them
            grads, loss = tree_map(lambda t: t.float(), g), mb_loss
        else:
            tree_map(lambda a, b: a.add_(b), grads, g)
            loss = loss + mb_loss
        del g
    grads = tree_map(lambda t: t.div_(microbatch), grads)
    return grads, loss / microbatch
