"""Faults planted under a cell's timed path, to show that its comparison
catches each: the eval step's (``fault(out, state)`` on the fused step's
outputs) and VO training's (``fault(engine)`` on the engine)."""

from __future__ import annotations

import dataclasses

import torch


def state_unchanged(out, st):
    """The recurrent state handed back as it came in."""
    out = list(out)
    out[7] = st["hidden"]
    return tuple(out)


def half_left_out(out, st):
    """The deltas of the second half of the envs never computed."""
    out = list(out)
    n = out[2].shape[0]
    out[2] = torch.cat([out[2][: n // 2], torch.zeros_like(out[2][n // 2:])])
    return tuple(out)


def answer_altered(out, st):
    """One env's yaw delta off by about a degree where it is produced."""
    out = list(out)
    out[2] = out[2].clone()
    out[2][0, 2] += 0.01
    return tuple(out)


def no_update(engine):
    """The train step returns the parameters unchanged."""
    engine.opt.step = lambda: None


def norm_biases_unchanged(engine):
    """The optimizer leaves every GroupNorm bias as it was: small 1-d
    leaves, fewer than half of all, so the median leaf still moves."""
    step = engine.opt.step
    biases = [m.bias for e in engine.experts for m in e.modules()
              if isinstance(m, torch.nn.GroupNorm)]

    def frozen(*a, **k):
        keep = [b.detach().clone() for b in biases]
        out = step(*a, **k)
        with torch.no_grad():
            for b, q in zip(biases, keep):
                b.copy_(q)
        return out
    engine.opt.step = frozen


_ROWS = {"actions", "gt_delta", "data_types", "dz_regress_mask", "chunk_idx", "entry_idx"}


def half_batch(engine):
    """Each step trains on the first half of its batch: the loss is the
    mean over the rest."""
    step = engine.train_step

    def half(batch):
        b = batch.actions.shape[0]
        e = b // 4 if batch.twins_packed else b // 2
        return step(dataclasses.replace(batch, **{
            f.name: getattr(batch, f.name)[: b // 2 if f.name in _ROWS else e]
            for f in dataclasses.fields(batch) if f.name != "twins_packed"}))
    engine.train_step = half


EVAL = {"state_unchanged": state_unchanged, "half_left_out": half_left_out,
        "answer_altered": answer_altered}
TRAIN = {"no_update": no_update, "half_batch": half_batch,
         "norm_biases_unchanged": norm_biases_unchanged}
