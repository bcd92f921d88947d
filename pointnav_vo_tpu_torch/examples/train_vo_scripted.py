"""VO training demo on the scripted world (counterpart of
``examples/train_vo_scripted.py``): frame pairs -> stage 1 -> per-delta
errors.

    python -m pointnav_vo_tpu_torch.examples.train_vo_scripted [--pairs 3000] [--epochs 8]
    python -m pointnav_vo_tpu_torch.examples.train_vo_scripted --device cpu --pairs 64 \\
        --eval-pairs 32 --epochs 1 --batch 16 --size 32 --out /tmp/vo      # smoke size

Runs TRAIN.md's stage 1 (the forward expert) without habitat: the oracle
goal follower's frame pairs (``examples/eval_994.py::scripted_pairs``, the
JAX package's HDF5 entries held in memory; the eval pairs from seed
10000), the full-size ``vo_cnn_rgb_d_dd_top_down`` trained in bf16 mixed
precision, and the eval's mean absolute (dx, dz, dyaw) error before
training and after each epoch.  The dz error should fall well below the
0.25 m step: the model learns egomotion from pixels.  ``--out`` is a
directory for the run's record, ``train_vo_scripted.json`` (the JAX script
keeps its HDF5 files there).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict

from pointnav_vo_tpu_torch.common import MOVE_FORWARD, resolve_device
from pointnav_vo_tpu_torch.examples.eval_994 import scripted_pairs
from pointnav_vo_tpu_torch.rl.envs import EnvConfig
from pointnav_vo_tpu_torch.vo.engine import VORegressionEngine, VOTrainConfig
from pointnav_vo_tpu_torch.vo.ensemble import VOInferenceConfig

ERRORS = ("abs_diff_dz", "abs_diff_dx", "abs_diff_dyaw")


def run(pairs: int = 3000, eval_pairs: int = 512, epochs: int = 8, batch: int = 128,
        size: int = 96, device=None, log=print) -> Dict:
    """Stage 1 from scratch; returns the record (the untrained, per-epoch
    and final errors, the losses and frame-pairs/s)."""
    dev = resolve_device(device)
    env_cfg = EnvConfig(image_h=size, image_w=size, max_episode_steps=80,
                        actuation_noise_multiplier=0.5)
    log(f"generating {pairs}+{eval_pairs} pairs in memory ...")
    train = scripted_pairs(pairs, env_cfg, seed=0).subset((MOVE_FORWARD,))
    evalset = scripted_pairs(eval_pairs, env_cfg, seed=10_000).subset((MOVE_FORWARD,))
    icfg = VOInferenceConfig(vis_size_w=size, vis_size_h=size, precision="bf16")
    tcfg = VOTrainConfig(batch_size=batch, epochs=epochs, action_type=MOVE_FORWARD, lr=2.5e-4,
                         log_interval=5)
    log(f"train pairs (forward only): {len(train)}, eval: {len(evalset)}")
    engine = VORegressionEngine(icfg, tcfg, train, evalset, device=dev)

    def errors(ev):
        return {k: float(ev[k]) for k in ERRORS}

    base = errors(engine.evaluate())
    log(f"untrained: abs_dz {base['abs_diff_dz']:.4f} m | abs_dx {base['abs_diff_dx']:.4f} m | "
        f"abs_dyaw {base['abs_diff_dyaw']:.4f} rad")
    history = []
    for _ in range(epochs):
        stats = engine.train_epoch()
        ev = errors(engine.evaluate())
        history.append({"epoch": engine.epoch, "train_loss": float(stats["mean_total_loss"]),
                        "frame_pairs_per_s": float(stats["frame_pairs_per_s"]), **ev})
        log(f"epoch {engine.epoch}: train_loss {stats['mean_total_loss']:.5f} "
            f"({stats['frame_pairs_per_s']:.0f} pairs/s) | eval abs_dz {ev['abs_diff_dz']:.4f} "
            f"abs_dx {ev['abs_diff_dx']:.4f} abs_dyaw {ev['abs_diff_dyaw']:.4f}")
    final = errors(engine.evaluate())
    improved = final["abs_diff_dz"] < 0.5 * base["abs_diff_dz"]
    log(f"dz error {base['abs_diff_dz']:.4f} -> {final['abs_diff_dz']:.4f} m "
        f"({'LEARNED' if improved else 'no clear learning'})")
    return {"pairs": pairs, "eval_pairs": eval_pairs, "train_samples": len(train),
            "eval_samples": len(evalset), "epochs": epochs, "batch": batch,
            "resolution": [size, size], "precision": "bf16", "device": str(dev),
            "untrained": base, "epochs_history": history, "final": final,
            "learned": bool(improved)}


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=3000)
    ap.add_argument("--eval-pairs", type=int, default=512)
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--size", type=int, default=96, help="square obs size")
    ap.add_argument("--out", default=None, help="directory for train_vo_scripted.json")
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    out = run(args.pairs, args.eval_pairs, args.epochs, args.batch, args.size, args.device,
              log=lambda m: print(m, flush=True))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "train_vo_scripted.json"), "w") as f:
            json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    main()
