"""The VO training step in plain PyTorch: the twin expansion, each
expert on its own rows with its whitening merged from them, dropout from
keep masks drawn in a fixed order, the summed per-(action, data type)
weighted MSE, the geometric-invariance inverse loss over (primary,
swapped) twins, backward, and Adam written out."""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from benchmark.reference.features import pack_frame

FORWARD = 1


def packed_pairs(batch: Dict[str, torch.Tensor], twins: bool, dd: int = 10) -> torch.Tensor:
    """The stem input ``[B, H, W, 2C]``: a twin-packed batch expands each
    entry into (prev, cur) and (cur, prev)."""
    fp = pack_frame(batch["prev_rgb"], batch["prev_depth"], dd)
    fc = pack_frame(batch["cur_rgb"], batch["cur_depth"], dd)
    a, b = torch.cat([fp, fc], -1), torch.cat([fc, fp], -1)
    if not twins:
        return a
    return torch.stack([a, b], 1).reshape((a.shape[0] * 2,) + tuple(a.shape[1:]))


def _mmean(x, mask, dim=None):
    if dim is None:
        return (x * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return (x * mask).sum(dim) / torch.clamp(mask.sum(dim), min=1.0)


def vo_loss(pred, gt, actions, data_types, expert_actions, joint: bool):
    """Sum over (expert action, data type) groups of the per-delta MSE mean
    (fixed unit weights), plus with ``joint`` the inverse loss of twins."""
    total = pred.new_zeros(())
    sq = (gt - pred) ** 2
    for act in expert_actions:
        for dt in ((0, 1) if joint else (0,)):
            g = ((actions == act) & (data_types == dt)).float()
            if g.sum() > 0:
                total = total + ((sq * g[:, None]).sum(0) / torch.clamp(g.sum(), min=1.0)).sum()
    if joint:
        fwd, bwd = pred[0::2], pred[1::2]
        act = actions[0::2]
        ok = ((data_types[0::2] == 0) & (data_types[1::2] == 1)).float()
        rot = _mmean((fwd[:, 2] + bwd[:, 2]) ** 2, ok)
        cy, sy = torch.cos(bwd[:, 2]), torch.sin(bwd[:, 2])
        fx = cy * fwd[:, 0] + sy * fwd[:, 1]
        fz = -sy * fwd[:, 0] + cy * fwd[:, 1]
        dz_on = (act != FORWARD).float()
        pos = torch.stack([(bwd[:, 0] + fx) ** 2, (bwd[:, 1] + fz) ** 2 * dz_on], -1)
        total = total + rot + _mmean(pos, ok[:, None].expand_as(pos))
    return total


def expert_buckets(actions: torch.Tensor, expert_actions: Sequence[int]) -> List[torch.Tensor]:
    """Rows of each expert: those of its action (the first expert takes rows
    of no expert's action)."""
    out = []
    claimed = torch.zeros_like(actions, dtype=torch.bool)
    for a in expert_actions:
        m = actions == a
        out.append(m)
        claimed |= m
    out[0] = out[0] | ~claimed
    return [torch.nonzero(m).flatten() for m in out]


class Adam:
    def __init__(self, params, lr, betas=(0.9, 0.999), eps=1e-8):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps = lr, betas[0], betas[1], eps
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads):
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(self.lr / c1 * m / (v.sqrt() / c2 ** 0.5 + self.eps))


def train_step(experts, opt: Adam, batch: Dict[str, torch.Tensor], expert_actions, joint: bool,
               generator: torch.Generator, dd: int = 10):
    """One step; returns (loss, per-parameter gradients).  Keep masks are
    drawn per expert in order, the features' then the hidden layer's, each
    ``rand < 1 - p`` over the expert's rows."""
    obs = packed_pairs(batch, joint, dd)
    actions, gt, dts = batch["actions"], batch["gt_delta"], batch["data_types"]
    pred = obs.new_zeros((obs.shape[0], 3))
    for e, (m, rows) in enumerate(zip(experts, expert_buckets(actions, expert_actions))):
        if rows.numel() == 0:
            continue
        n = rows.numel()
        keep = tuple(torch.rand(n, w, generator=generator, device=obs.device) < 1.0 - m.p
                     for w in (m.flat, m.hidden))
        own = (actions.index_select(0, rows) == expert_actions[e]).float()
        out = m(obs.index_select(0, rows), own, keep)
        pred = pred.index_copy(0, rows, out)
    loss = vo_loss(pred, gt, actions, dts, expert_actions, joint)
    params = opt.params
    grads = torch.autograd.grad(loss, params)
    opt.step(grads)
    return loss.detach(), grads
