"""Verify that the reference's published checkpoints load into the port and
give the reference's outputs (counterpart of
``tools/verify_reference_ckpts.py``).

The reference ships three files:

- ``pretrained_ckpts/vo/act_forward.pth`` (``model_states[1]``);
- ``pretrained_ckpts/vo/act_left_right_inv_joint.pth`` (``model_states[2]``
  and ``[3]``);
- ``pretrained_ckpts/rl/tune_vo/rl_tune_vo.pth`` (``state_dict``).

For each file that exists the tool reads it through ``io/weights.py``
(``load_vo_checkpoint``, ``load_policy_checkpoint``), runs fixed seeded
inputs at 341x192 through the port's ``vo_cnn_rgb_d_dd_top_down`` and
depth ``PointNavActorCritic`` on ``--device`` (the card by default; fp32,
TF32 off), and, where a clone of the reference is at ``--reference-root``
(default ``$POINTNAV_VO_REFERENCE_ROOT``, else ``reference`` beside the
repository), loads the same weights into reference-shaped torch modules
built from the clone's files (``tools/reference_oracle.py``, on the CPU)
and requires every output within ``ATOL``.  A missing file is a ``SKIP``.
``--self-test`` writes random reference-shaped files in both container
layouts and checks them; it needs the clone.

The JSON report (``--report``) has the JAX tool's keys: ``mode``,
``atol``, ``files`` (each with ``status`` and ``experts`` /
``delta_sample0``, or ``logits_sample0``, and ``torch_max_abs_diff`` /
``torch_match`` where the oracle ran) and ``overall``.  Exit 1 on a
``FAIL``.  Usage::

    python -m pointnav_vo_tpu_torch.tools.verify_reference_ckpts \\
        --act-forward pretrained_ckpts/vo/act_forward.pth \\
        --act-left-right pretrained_ckpts/vo/act_left_right_inv_joint.pth \\
        --rl-tune-vo pretrained_ckpts/rl/tune_vo/rl_tune_vo.pth [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

from pointnav_vo_tpu_torch.common import resolve_device
from pointnav_vo_tpu_torch.io.weights import load_policy_checkpoint, load_vo_checkpoint
from pointnav_vo_tpu_torch.models.policy import PointNavActorCritic
from pointnav_vo_tpu_torch.models.vo_cnn import make_vo_model
from pointnav_vo_tpu_torch.tools import reference_oracle
from pointnav_vo_tpu_torch.vo.ensemble import VOInferenceConfig, pack_frame_features

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
VO_OBS_SPACE = ("rgb", "depth", "discretized_depth", "top_down_view")
W, H = 341, 192
ATOL = 5e-4  # float32 conv stacks at full width, the port against the reference's modules


def _fixed_vo_obs(batch=2, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "rgb": rng.uniform(0, 255, (batch, H, W, 6)).astype(np.float32),
        "depth": rng.uniform(0, 1, (batch, H, W, 2)).astype(np.float32),
        "discretized_depth": rng.integers(0, 2, (batch, H, W, 20)).astype(np.float32),
        "top_down_view": rng.uniform(0, 1, (batch, H, W, 2)).astype(np.float32),
    }


def _fixed_policy_obs(batch=2, seed=1):
    rng = np.random.default_rng(seed)
    return {
        "depth": rng.uniform(0, 1, (batch, H, W, 1)).astype(np.float32),
        "pointgoal_with_gps_compass": rng.normal(size=(batch, 2)).astype(np.float32),
    }


def _packed(obs, device):
    """The observation dict (each key's two frames on the channel axis) as
    the encoder's packed stem input ``cat(prev_pack, cur_pack)``."""
    cfg = VOInferenceConfig()
    halves = [{k: torch.from_numpy(v[..., i * (v.shape[-1] // 2):(i + 1) * (v.shape[-1] // 2)])
               .to(device) for k, v in obs.items()} for i in (0, 1)]
    return torch.cat([pack_frame_features(h, cfg) for h in halves], dim=-1)


def _vo_forward(sd, obs, device):
    model = make_vo_model("vo_cnn_rgb_d_dd_top_down", observation_space=VO_OBS_SPACE,
                          observation_size=(W, H), discretized_depth_channels=10)
    model.load_state_dict(sd, strict=True)
    model.to(device).eval()
    with torch.no_grad():
        return model(_packed(obs, device)).cpu().numpy()


def verify_vo(path, act_indices, oracle, results, device):
    """``act_indices``: ``{expert name: model_states index}`` of the file."""
    name = os.path.basename(path)
    if not os.path.isfile(path):
        results[name] = {"status": "SKIP", "reason": "file not found"}
        print(f"SKIP {name}: not found")
        return
    obs = _fixed_vo_obs()
    entry = {"status": "PASS", "experts": {}}
    for expert, idx in act_indices.items():
        sd = load_vo_checkpoint(path, act_idx=idx)
        ours = _vo_forward(sd, obs, device)
        rec = {"delta_sample0": ours[0].tolist()}
        if oracle is not None:
            tm = reference_oracle.ReferenceVOModel(oracle, VO_OBS_SPACE, (W, H), dd_channels=10)
            tm.load_state_dict(sd)
            tm.eval()
            with torch.no_grad():
                want = tm({k: torch.from_numpy(v) for k, v in obs.items()}).numpy()
            diff = float(np.abs(ours - want).max())
            rec["torch_max_abs_diff"] = diff
            rec["torch_match"] = bool(diff < ATOL)
            if diff >= ATOL:
                entry["status"] = "FAIL"
        entry["experts"][expert] = rec
    results[name] = entry
    print(f"{entry['status']} {name}: " + ", ".join(
        f"{e}[{r.get('torch_max_abs_diff', 'no-oracle')}]"
        for e, r in entry["experts"].items()))


def verify_policy(path, oracle, results, device):
    name = os.path.basename(path)
    if not os.path.isfile(path):
        results[name] = {"status": "SKIP", "reason": "file not found"}
        print(f"SKIP {name}: not found")
        return
    sd = load_policy_checkpoint(path)
    model = PointNavActorCritic(image_size=(H, W))
    model.load_state_dict(sd, strict=True)
    model.to(device).eval()
    obs = _fixed_policy_obs()
    n = obs["depth"].shape[0]
    hidden = np.random.default_rng(2).normal(size=(4, n, 512)).astype(np.float32)
    prev = np.zeros((n, 1), np.int64)
    masks = np.ones((n, 1), np.float32)
    with torch.no_grad():
        logits, value, new_h = (t.cpu().numpy() for t in model(
            {k: torch.from_numpy(v).to(device) for k, v in obs.items()},
            torch.from_numpy(hidden).to(device), torch.from_numpy(prev).to(device),
            torch.from_numpy(masks).to(device)))
    entry = {"status": "PASS", "logits_sample0": logits[0].tolist()}
    if oracle is not None:
        tm = reference_oracle.ReferenceActorCritic(oracle, (H, W))
        tm.load_state_dict(sd, strict=False)
        tm.eval()
        with torch.no_grad():
            want_l, want_v, want_h = tm({k: torch.from_numpy(v) for k, v in obs.items()},
                                        torch.from_numpy(hidden), torch.from_numpy(prev),
                                        torch.from_numpy(masks))
        diff = max(float(np.abs(logits - want_l.numpy()).max()),
                   float(np.abs(value - want_v.numpy()).max()),
                   float(np.abs(new_h - want_h.numpy()).max()))
        entry["torch_max_abs_diff"] = diff
        entry["torch_match"] = bool(diff < ATOL)
        if diff >= ATOL:
            entry["status"] = "FAIL"
    results[name] = entry
    print(f"{entry['status']} {name}: {entry.get('torch_max_abs_diff', 'no-oracle')}")


def make_self_test_files(oracle, outdir):
    """Random reference-shaped weights saved in the published containers
    (``model_states`` by action id for VO, ``state_dict`` for RL)."""
    os.makedirs(outdir, exist_ok=True)
    torch.manual_seed(0)
    models = {i: reference_oracle.ReferenceVOModel(oracle, VO_OBS_SPACE, (W, H), dd_channels=10)
              for i in (1, 2, 3)}
    paths = {"act_forward": os.path.join(outdir, "act_forward.pth"),
             "act_left_right": os.path.join(outdir, "act_left_right_inv_joint.pth"),
             "rl_tune_vo": os.path.join(outdir, "rl_tune_vo.pth")}
    torch.save({"model_states": {1: models[1].state_dict()}}, paths["act_forward"])
    torch.save({"model_states": {2: models[2].state_dict(), 3: models[3].state_dict()}},
               paths["act_left_right"])
    pol = reference_oracle.ReferenceActorCritic(oracle, (H, W))
    torch.save({"state_dict": {f"actor_critic.{k}": v for k, v in pol.state_dict().items()}},
               paths["rl_tune_vo"])
    return paths


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--act-forward", default="pretrained_ckpts/vo/act_forward.pth")
    ap.add_argument("--act-left-right",
                    default="pretrained_ckpts/vo/act_left_right_inv_joint.pth")
    ap.add_argument("--rl-tune-vo", default="pretrained_ckpts/rl/tune_vo/rl_tune_vo.pth")
    ap.add_argument("--reference-root", default=os.environ.get(
        "POINTNAV_VO_REFERENCE_ROOT", os.path.join(os.path.dirname(_REPO), "reference")))
    ap.add_argument("--report", default=os.path.join(_REPO, "PARITY_CKPTS_torch.json"))
    ap.add_argument("--self-test", action="store_true")
    ap.add_argument("--device", default=None,
                    help="where the port's forwards run: cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    oracle = reference_oracle.load_reference(args.reference_root)
    if oracle is None:
        print(f"note: no reference clone at {args.reference_root}: converting and "
              "forward-checking only, no comparison with the reference's modules")
    if args.self_test:
        if oracle is None:
            raise SystemExit("--self-test needs a reference clone at --reference-root")
        paths = make_self_test_files(oracle, tempfile.mkdtemp("ckpt_st"))
        args.act_forward = paths["act_forward"]
        args.act_left_right = paths["act_left_right"]
        args.rl_tune_vo = paths["rl_tune_vo"]

    results = {"mode": "self-test" if args.self_test else "published", "atol": ATOL,
               "files": {}}
    verify_vo(args.act_forward, {"forward": 1}, oracle, results["files"], device)
    verify_vo(args.act_left_right, {"left": 2, "right": 3}, oracle, results["files"], device)
    verify_policy(args.rl_tune_vo, oracle, results["files"], device)
    statuses = [v["status"] for v in results["files"].values()]
    results["overall"] = ("FAIL" if "FAIL" in statuses
                          else "PASS" if "PASS" in statuses else "SKIP")
    with open(args.report, "w") as f:
        json.dump(results, f, indent=2)
    print(f"overall: {results['overall']} -> {args.report}")
    return 1 if results["overall"] == "FAIL" else 0


if __name__ == "__main__":
    sys.exit(main())
