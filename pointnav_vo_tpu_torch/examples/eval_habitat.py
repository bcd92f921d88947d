"""One command from a habitat install to the reference's 994-episode eval
(counterpart of ``examples/eval_habitat.py``).

    python -m pointnav_vo_tpu_torch.examples.eval_habitat                 # rl_tune_vo.pth
    python -m pointnav_vo_tpu_torch.examples.eval_habitat --no-tune       # rl_no_tune.pth
    python -m pointnav_vo_tpu_torch.examples.eval_habitat --episodes 50 --envs 4   # smoke
    python -m pointnav_vo_tpu_torch.examples.eval_habitat --preflight-only

The reference's Reproduce section evaluates its published checkpoints on
the 994 Gibson-val episodes.  This is that run on the port: habitat-sim
process workers (the port's ``HabitatNavEnv`` behind ``ENV_BACKEND
habitat``) feed the shm rings, and the policy and the three VO experts run
as one fused step per env batch on ``--device`` (default: the card), with
the exact-episode-set protocol.

The preflight fails fast, in this order, with a message naming the step of
``docs/HABITAT_RUNBOOK.md`` to follow: habitat imports; the Gibson
PointNav v2 split and the scene directory exist; the published RL and VO
checkpoints exist and load into the port's modules
(``io/weights.py::load_policy_checkpoint`` and ``load_vo_checkpoint``, each
VO expert by its action id), with their parameter counts; the device
answers.  habitat-sim is on neither the development box nor the card's
machine, so the eval itself has run only over ``tests/fake_habitat.py``.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict

import torch

from pointnav_vo_tpu_torch.common import MOVE_FORWARD, TURN_LEFT, TURN_RIGHT, resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
REFERENCE_EVAL_MIN = 4.5 * 60  # the reference's 994 episodes (its README)
NO_TUNE_CKPT = "pretrained_ckpts/rl/no_tune/rl_no_tune.pth"


def _count(state_dict) -> int:
    """Parameters of a state dict: the whitening statistics are buffers."""
    return sum(v.numel() for k, v in state_dict.items() if "running_mean_and_var" not in k)


def preflight(args) -> Dict:
    """Check every external dependency of the run; return a report."""
    report = {}

    # 1. habitat imports (the adapter reads get_config / Env / make_dataset)
    try:
        import habitat  # noqa: F401

        report["habitat"] = getattr(habitat, "__version__", "unknown")
    except ImportError as e:
        raise SystemExit(
            f"habitat-lab is not importable ({e}).\n"
            "Install habitat-sim + habitat-lab per docs/HABITAT_RUNBOOK.md "
            "step 1 (the reference pins habitat-lab 0.1.5 / "
            "habitat-sim 0.1.5 with the noise models built in).")

    # 2. Gibson PointNav v2 val split where the DATASET config points
    data_path = args.data_path.format(split=args.split)
    if not os.path.isfile(data_path):
        raise SystemExit(
            f"dataset file missing: {data_path}\n"
            "Expected the Gibson PointNav v2 layout of reference "
            "README.md:44-66 (dataset/pointnav/gibson/v2/val/val.json.gz). "
            "See docs/HABITAT_RUNBOOK.md step 2.")
    report["dataset"] = data_path
    scene_dir = args.scene_dir
    if scene_dir and not os.path.isdir(scene_dir):
        raise SystemExit(
            f"scene directory missing: {scene_dir} (Gibson .glb scenes; "
            "HABITAT_RUNBOOK.md step 2)")

    # 3. published checkpoints: present, and loadable into the port's modules
    from pointnav_vo_tpu_torch.io.weights import load_policy_checkpoint, load_vo_checkpoint

    rl_ckpt = args.rl_ckpt
    if not os.path.isfile(rl_ckpt):
        raise SystemExit(
            f"RL checkpoint missing: {rl_ckpt}\n"
            "Download pretrained_ckpts from the reference README.md:70 "
            "drive link (HABITAT_RUNBOOK.md step 3).")
    report["rl_ckpt"] = {"path": rl_ckpt, "params": _count(load_policy_checkpoint(rl_ckpt))}
    # the published containers key model_states by action id:
    # act_forward.pth -> {1}, act_left_right_inv_joint.pth -> {2, 3}
    for name, path, indices in (("forward", args.vo_forward_ckpt, (MOVE_FORWARD,)),
                                ("left_right", args.vo_turn_ckpt, (TURN_LEFT, TURN_RIGHT))):
        if not os.path.isfile(path):
            raise SystemExit(f"VO checkpoint missing: {path} (HABITAT_RUNBOOK.md step 3)")
        for idx in indices:
            report.setdefault("vo_ckpts", {})[f"{name}[{idx}]"] = {
                "path": path, "params": _count(load_vo_checkpoint(path, act_idx=idx))}

    # 4. the device answers
    dev = resolve_device(getattr(args, "device", None))
    report["devices"] = ([torch.cuda.get_device_name(dev)] if dev.type == "cuda"
                         else [str(dev)])
    return report


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--episodes", type=int, default=994,
                    help="994 = the full Gibson-val set (reference README:84)")
    ap.add_argument("--envs", type=int, default=16,
                    help="habitat-sim process workers (each ~1.5 GB RSS; size to the host)")
    ap.add_argument("--split", default="val")
    ap.add_argument("--data-path", default=(
        "dataset/habitat_datasets/pointnav/gibson/v2/{split}/{split}.json.gz"))
    ap.add_argument("--scene-dir", default="dataset/Gibson",
                    help="SCENES_DIR: episode scene_ids (gibson/<Scene>.glb) resolve "
                         "relative to this")
    ap.add_argument("--rl-ckpt", default="pretrained_ckpts/rl/tune_vo/rl_tune_vo.pth")
    ap.add_argument("--no-tune", action="store_true",
                    help="evaluate rl_no_tune.pth instead (the reference table's untuned row)")
    ap.add_argument("--vo-forward-ckpt", default="pretrained_ckpts/vo/act_forward.pth")
    ap.add_argument("--vo-turn-ckpt",
                    default="pretrained_ckpts/vo/act_left_right_inv_joint.pth")
    ap.add_argument("--mode", choices=("det", "rnd"), default="det",
                    help="rnd = the reference's rnd_mode_n=10 dropout uncertainty ensemble "
                         "(ddppo_pointnav.yaml:119)")
    ap.add_argument("--noise", type=int, default=1,
                    help="Challenge-2020 actuation/RGB/depth noise (the reference's --noise 1)")
    ap.add_argument("--video", action="store_true")
    ap.add_argument("--preflight-only", action="store_true")
    ap.add_argument("--out", default="EVAL_HABITAT_torch.json")
    ap.add_argument("--device", default=None, help="default: the card")
    return ap


def eval_config(args):
    """The stock RL eval config with the habitat backend and this run's
    paths; every other knob (the Challenge-2020 noise, the 341x192
    sensors, the VO settings) already carries the reference's values."""
    from pointnav_vo_tpu_torch.config.defaults import get_rl_config

    key = "VO.REGRESS_MODEL.all_pretrained_ckpt.rgb_d_dd_top_down_inv_joint"
    return get_rl_config(
        [os.path.join(REPO, "configs/rl/ddppo_pointnav.yaml")],
        ["ENV_BACKEND", "habitat",
         "NUM_PROCESSES", str(args.envs),
         "EVAL.TEST_EPISODE_COUNT", str(args.episodes),
         "EVAL.EVAL_CKPT_PATH", args.rl_ckpt,
         "VO.REGRESS_MODEL.mode", args.mode,
         f"{key}.forward", args.vo_forward_ckpt,
         f"{key}.left", args.vo_turn_ckpt,
         f"{key}.right", args.vo_turn_ckpt,
         "TASK_CONFIG.DATASET.DATA_PATH", args.data_path,
         "TASK_CONFIG.DATASET.SPLIT", args.split,
         "TASK_CONFIG.DATASET.SCENES_DIR", args.scene_dir]
        + (["VIDEO_OPTION", "['disk']"] if args.video else []))


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.no_tune:
        args.rl_ckpt = NO_TUNE_CKPT
    report = preflight(args)
    print("preflight ok:", json.dumps(report, indent=2, default=str), flush=True)
    if args.preflight_only:
        return report

    import pointnav_vo_tpu_torch.engines  # noqa: F401  populates the registry
    from pointnav_vo_tpu_torch.utils import registry

    cfg = eval_config(args)
    engine = registry.get_trainer(cfg.ENGINE_NAME)(cfg, run_type="eval",
                                                   noisy=bool(args.noise), device=args.device)
    t0 = time.perf_counter()
    metrics = engine.eval(ckpt_path=args.rl_ckpt, num_episodes=args.episodes)
    wall_min = (time.perf_counter() - t0) / 60
    out = {
        "protocol": "reference Reproduce run (README.md:69-100): published checkpoints, "
                    "Gibson-val, Challenge-2020 noise",
        "episodes": args.episodes,
        "envs": args.envs,
        "rl_ckpt": args.rl_ckpt,
        "vo_mode": args.mode,
        "noise": bool(args.noise),
        "wall_clock_min": wall_min,
        "vs_reference_min": REFERENCE_EVAL_MIN,
        "metrics": {k: float(v) for k, v in metrics.items()},
        "preflight": report,
    }
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2, default=str)
    print(f"\n{args.episodes} episodes in {wall_min:.1f} min "
          f"({REFERENCE_EVAL_MIN / max(wall_min, 1e-9):.1f}x vs reference)")
    print(f"success {metrics.get('success', float('nan')):.3f} | "
          f"spl {metrics.get('spl', float('nan')):.3f} | "
          f"softspl {metrics.get('softspl', float('nan')):.3f}")
    print(f"wrote {args.out}")
    return out


if __name__ == "__main__":
    main()
