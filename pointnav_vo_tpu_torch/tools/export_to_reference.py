"""Export a port checkpoint to a ``.pth`` that the reference loads
(counterpart of ``tools/export_to_reference.py``).

A VO model trained with the port deploys into the reference's own torch
stack (its eval sweep, its challenge-submission harness) through this:
the port's modules carry the reference's key names already, so exporting
is re-wrapping the state dicts in the reference's containers.

- ``--kind vo`` reads a port VO training checkpoint (``experts`` in its
  ``train_config["action_type"]`` order) and writes the per-action
  ``{"model_states": {act: state_dict}, "epoch": e}`` (one action, or the
  joint turn stage's 2 and 3), or ``{"model_state": state_dict, "epoch":
  e}`` for the act-embed model trained with ``action_type: -1``.
- ``--kind policy`` reads a port RL checkpoint (``state_dict`` with the
  ``actor_critic.`` prefix, beside the optimizer, generators and host RNG)
  and writes ``{"state_dict": ..., "update": n}`` with nothing else.

Host only; no device.  Usage::

    python -m pointnav_vo_tpu_torch.tools.export_to_reference CKPT OUT [--kind vo|policy]
"""

from __future__ import annotations

import argparse
from typing import Sequence

import torch

from pointnav_vo_tpu_torch.common import TURN_LEFT, TURN_RIGHT, UNIFIED
from pointnav_vo_tpu_torch.io.checkpoint import load_checkpoint
from pointnav_vo_tpu_torch.io.weights import POLICY_PREFIX, policy_state_dict_from_container


def _expert_actions(action_type) -> tuple:
    """The actions of a VO checkpoint's experts, in its order."""
    if isinstance(action_type, (tuple, list)):
        if set(action_type) != {TURN_LEFT, TURN_RIGHT}:
            raise ValueError(f"a joint VO stage trains the turns {TURN_LEFT} and "
                             f"{TURN_RIGHT}, not {action_type}")
        return (TURN_LEFT, TURN_RIGHT)
    return (int(action_type),)


def export(ckpt_path: str, out_path: str, kind: str = "vo") -> dict:
    """Write ``out_path`` from the port checkpoint ``ckpt_path`` (loaded
    onto the CPU); returns what was written."""
    ckpt = load_checkpoint(ckpt_path)
    if kind == "policy":
        sd = policy_state_dict_from_container(ckpt)
        update = int(ckpt.get("update", ckpt.get("update_idx", 0)))
        torch.save({"state_dict": {POLICY_PREFIX + k: v for k, v in sd.items()},
                    "update": update}, out_path)
        return {"kind": "policy", "update": update, "out": out_path}
    if kind != "vo":
        raise ValueError(f"kind must be 'vo' or 'policy', got {kind!r}")
    experts: Sequence = ckpt["experts"]
    acts = _expert_actions(ckpt["train_config"]["action_type"])
    if len(experts) != len(acts):
        raise ValueError(f"{len(experts)} experts for actions {acts}")
    epoch = int(ckpt.get("epoch", 0))
    if acts == (UNIFIED,):
        out = {"model_state": dict(experts[0])}
    else:
        out = {"model_states": {act: dict(sd) for act, sd in zip(acts, experts)}}
    out["epoch"] = epoch
    torch.save(out, out_path)
    return {"kind": "vo", "actions": list(acts), "epoch": epoch, "out": out_path}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("ckpt", help="port checkpoint (.pth)")
    ap.add_argument("out", help="output .pth path")
    ap.add_argument("--kind", choices=("vo", "policy"), default="vo")
    args = ap.parse_args(argv)
    print(f"exported {export(args.ckpt, args.out, args.kind)}")


if __name__ == "__main__":
    main()
