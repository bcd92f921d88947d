#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pointnav_vo_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, each printing a line; any failure exits non-zero:

1. build: every kernel under ``pointnav_vo_tpu_torch/csrc/`` with nvcc
   (all started together), its ptxas register/shared-memory report, and the
   card's name and power limit;
2. kernel check: ``bin_counts`` on random bins and on ``pixel_bins`` of
   scripted-env depth at batch 1, 32 and 512, each ``torch.equal`` to its
   plain version on the card; CUDA-event times of the kernel, the plain
   version and ``torch.bincount`` (a yardstick only) beside the memory bound;
3. main path: ``Evaluator.run`` of the det VO-in-the-loop eval at full
   width (three ``vo_cnn_rgb_d_dd_top_down`` experts and the ResNet18 +
   2-layer LSTM-512 policy at 341x192, seeded random weights, fp32, TF32
   off) over 32 scripted envs, an exact set of 32 episodes; the kernel's
   launch count must rise by exactly steps + 1.  Then the per-step time of
   ``fused_vo_act_step`` and one step held against the same step on the CPU;
4. steady-state VO: ``VOEnsemble.predict_step_cached`` at batch 512 with a
   70/15/15 forward/left/right action mix, frame-pairs/s.

The second-to-last lines are the kernels' JSON record and the card's
``nvidia-smi`` name/power line; the last line is the run's JSON verdict.
Exits non-zero, printing no verdict, where no CUDA card is present.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time

import numpy as np

H, W = 192, 341  # full width of the deployed models
BAND = min(100, H)  # 2 * rows_around_center rows of candidate points
KERNEL_BATCHES = (1, 32, 512)
N_ENVS = 32
STEADY_BATCH = 512
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
SEED = 0


def _log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def _card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]


def _time_ms(fn, iters, warmup=3):
    """Mean CUDA-event time of ``fn()`` over ``iters`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _profile(label, fn, iters=3):
    """Device kernel time per call from torch.profiler over ``iters`` calls,
    beside the host wall time (profiler on); prints the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / iters
    if busy_ms <= 0:
        _log("profile", f"{label}: device time not measured (profiler saw no kernels)")
        return
    _log("profile", f"{label}: device busy {busy_ms:.4f} ms of {wall_ms:.4f} ms wall "
                    f"per call ({100 * (1 - busy_ms / wall_ms):.1f} % idle, profiler on), "
                    f"{sum(e.count for e in kernels) // iters} kernel launches per call")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        _log("profile", f"  {e.self_device_time_total / 1e3 / iters:9.4f} ms "
                        f"x{e.count // iters:<4d} {e.key[:90]}")


def phase_build():
    from pointnav_vo_tpu_torch import kernels

    t0 = time.perf_counter()
    reports = kernels.build()
    for name, log in reports.items():
        lines = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "smem" in ln or "spill" in ln]
        _log("build", f"{name}: {' | '.join(lines) or 'already built'}")
    _log("build", f"built {len(reports)} kernel(s) in {time.perf_counter() - t0:.1f} s")
    card = _card_line()
    _log("build", f"card: {card}")
    return card


def _scripted_depth(n, seed):
    from pointnav_vo_tpu_torch.rl.envs import EnvConfig, make_scripted_vector_env

    env_cfg = EnvConfig(image_h=H, image_w=W)
    return make_scripted_vector_env(env_cfg, n, seed=seed).reset()["depth"][..., 0]


def phase_kernel(dev):
    import torch

    from pointnav_vo_tpu_torch.ops import topdown_kernels as tk
    from pointnav_vo_tpu_torch.ops.topdown import TopDownParams, pixel_bins

    rng = np.random.default_rng(SEED)
    depths = torch.from_numpy(_scripted_depth(max(KERNEL_BATCHES), seed=1000)).to(dev)
    params = TopDownParams(vis_size_h=H, vis_size_w=W)
    max_err = 0.0
    timings = {}
    for b in KERNEL_BATCHES:
        random_bins = (
            torch.from_numpy(rng.integers(-3, H + 3, (b, BAND, W)).astype(np.int32)).to(dev),
            torch.from_numpy(rng.integers(-3, W + 3, (b, BAND, W)).astype(np.int32)).to(dev),
            torch.from_numpy(rng.uniform(size=(b, BAND, W)) < 0.8).to(dev))
        depth_bins = pixel_bins(depths[:b].contiguous(), params)
        for kind, bins in (("random", random_bins), ("scripted-depth", depth_bins)):
            got = tk.bin_counts(*bins, H, W)
            want = tk.bin_counts_reference(*bins, H, W)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            max_err = max(max_err, err)
            if not torch.equal(got, want):
                raise AssertionError(f"bin_counts != plain at B={b} ({kind}): "
                                     f"max abs err {err}")
            _log("kernel", f"B={b} {kind}: equal to plain version "
                           f"({int(want.sum())} points binned)")
        # time on the main path's data: bins of scripted-env depth
        pix_r, pix_c, keep = depth_bins
        kept = int(keep.sum())
        nbytes = keep.numel() * 1 + kept * 8 + b * H * W * 4
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ok = keep & (pix_r >= 0) & (pix_r < H) & (pix_c >= 0) & (pix_c < W)
        img = torch.arange(b, device=dev).view(b, 1, 1)
        flat = torch.where(ok, (img * H + pix_r.long()) * W + pix_c.long(),
                           b * H * W).reshape(-1)
        iters = 200 if b < 512 else 50
        t = {
            "ms": _time_ms(lambda: tk.bin_counts(pix_r, pix_c, keep, H, W), iters),
            "plain_ms": _time_ms(
                lambda: tk.bin_counts_reference(pix_r, pix_c, keep, H, W), iters),
            "library_ms": _time_ms(
                lambda: torch.bincount(flat, minlength=b * H * W + 1), iters),
            "bound_ms": bound_ms,
            "bytes": nbytes,
        }
        timings[b] = t
        _log("kernel", f"B={b}: kernel_ms={t['ms']:.5f} plain_ms={t['plain_ms']:.5f} "
                       f"library_ms(torch.bincount)={t['library_ms']:.5f} "
                       f"bound_ms={bound_ms:.5f} ({nbytes} B over 3.35 TB/s)")
    return max_err, timings


def _build_models(cfg, dev, seed):
    """Three VO experts and the policy with seeded random weights; returns
    (card ensemble, card policy, CPU copies of both)."""
    import torch

    from pointnav_vo_tpu_torch.io.weights import seeded_init_
    from pointnav_vo_tpu_torch.models.policy import PointNavActorCritic
    from pointnav_vo_tpu_torch.vo.ensemble import VOEnsemble

    g = torch.Generator().manual_seed(seed)
    experts = [seeded_init_(cfg.make_model(), g) for _ in range(3)]
    policy = seeded_init_(PointNavActorCritic(image_size=(H, W)), g).eval()
    cpu_vo = VOEnsemble(cfg, experts=[copy.deepcopy(m) for m in experts], device="cpu")
    cpu_policy = copy.deepcopy(policy)
    return (VOEnsemble(cfg, experts=experts, device=dev), policy.to(dev),
            cpu_vo, cpu_policy)


def _fused_inputs(obs0, obs1, actions, dev, vo_cfg, policy):
    """Arguments of one fused step on ``dev`` from two consecutive obs."""
    import torch

    from pointnav_vo_tpu_torch.ops.geometry import pointgoal_polar2cartesian
    from pointnav_vo_tpu_torch.vo.ensemble import frame_features_packed

    n = actions.shape[0]

    def t(a, dtype=None):
        return torch.as_tensor(np.asarray(a, dtype), device=dev)

    sensor0 = t(obs0["pointgoal_with_gps_compass"])
    reset = t(np.zeros((n, 1)), np.float32)
    gen = torch.Generator().manual_seed(SEED)
    hidden = torch.randn(policy.num_packed_hidden, n, policy.hidden_size,
                         generator=gen).to(dev)
    return dict(
        prev_feats=frame_features_packed(t(obs0["rgb"], np.uint8), t(obs0["depth"]), vo_cfg),
        cur_rgb=t(obs1["rgb"], np.uint8), cur_depth=t(obs1["depth"]),
        actions_np=actions, goal_cart=pointgoal_polar2cartesian(sensor0),
        reset_mask=reset, sensor_polar=t(obs1["pointgoal_with_gps_compass"]),
        hidden=hidden, prev_actions=t(actions[:, None], np.int64), masks=1.0 - reset,
        est_rot=t(np.tile([0.0, 0.0, 0.0, 1.0], (n, 1)), np.float32),
        est_pos=t(np.zeros((n, 3)), np.float32),
        est_seed_rot=t(np.tile([0.0, 0.0, 0.0, 1.0], (n, 1)), np.float32),
        est_seed_pos=t(np.zeros((n, 3)), np.float32))


def phase_main_path(dev):
    import torch

    from pointnav_vo_tpu_torch.ops import topdown_kernels as tk
    from pointnav_vo_tpu_torch.rl.envs import EnvConfig, make_scripted_vector_env
    from pointnav_vo_tpu_torch.rl.eval import Evaluator, fused_vo_act_step
    from pointnav_vo_tpu_torch.vo.ensemble import VOInferenceConfig

    n_envs = n_episodes = N_ENVS  # one episode per env
    cap = 20
    cfg = VOInferenceConfig(vis_size_h=H, vis_size_w=W)
    vo, policy, cpu_vo, cpu_policy = _build_models(cfg, dev, SEED)
    env_cfg = EnvConfig(image_h=H, image_w=W, max_episode_steps=cap)
    envs = make_scripted_vector_env(env_cfg, n_envs, seed=SEED)
    ev = Evaluator(model=policy, envs=envs, vo_ensemble=vo, device=dev)

    tk.reset_launch_counts()
    t0 = time.perf_counter()
    agg = ev.run(n_episodes)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(tk.launch_counts)
    loop_steps = max(r.steps for r in ev.results)
    _log("main", "Evaluator.run: " + json.dumps(agg, sort_keys=True))
    if agg["episodes"] != n_episodes or len(ev.results) != n_episodes:
        raise AssertionError(f"expected exactly {n_episodes} episodes, got {agg['episodes']}")
    bad = [k for k, v in agg.items() if not np.isfinite(v)]
    if bad:
        raise AssertionError(f"non-finite aggregates: {bad}")
    if launches["bin_counts"] != loop_steps + 1:
        raise AssertionError(f"bin_counts launched {launches['bin_counts']} times over "
                             f"{loop_steps} steps; expected steps + 1")
    _log("main", f"{loop_steps} steps, {int(agg['total_env_steps'])} env steps, "
                 f"wall {wall:.3f} s, bin_counts launches {launches['bin_counts']}")

    # per-step time of the fused step on the card (CUDA events), on real frames
    probe = make_scripted_vector_env(env_cfg, n_envs, seed=SEED + 1)
    obs0 = probe.reset()
    rng = np.random.default_rng(SEED)
    actions = np.where(rng.uniform(size=n_envs) < 0.7, 1,
                       rng.integers(2, 4, n_envs)).astype(np.int64)
    obs1 = probe.step(actions)[0]
    args = _fused_inputs(obs0, obs1, actions, dev, cfg, policy)
    step_ms = _time_ms(lambda: fused_vo_act_step(policy, vo, **args), iters=20)
    _log("main", f"fused_vo_act_step at {n_envs} envs: {step_ms:.4f} ms/step "
                 "(CUDA events, host gaps included)")
    _profile(f"fused_vo_act_step at {n_envs} envs",
             lambda: fused_vo_act_step(policy, vo, **args))

    # one step on the card against the same step on the CPU
    got = fused_vo_act_step(policy, vo, **args)
    cpu_args = _fused_inputs(obs0, obs1, actions, torch.device("cpu"), cfg, cpu_policy)
    want = fused_vo_act_step(cpu_policy, cpu_vo, **cpu_args)
    names = ("goal_cart", "polar", "delta", "value", "action", "logp", "hidden",
             "cur_feats", "est_rot", "est_pos")
    errs = {}
    for name, g, w in zip(names, got, want):
        g = g.cpu()
        errs[name] = float((g.double() - w.double()).abs().max())
        if name == "action":
            if not torch.equal(g, w):
                raise AssertionError("card and CPU actions differ")
        # fp32 with TF32 off: cuDNN and the CPU sum in other orders
        elif not torch.allclose(g, w, rtol=1e-3, atol=1e-4):
            raise AssertionError(f"card vs CPU {name}: max abs err {errs[name]}")
    _log("main", "card vs CPU fused step (rtol 1e-3, atol 1e-4; actions equal): "
                 + json.dumps(errs, sort_keys=True))
    return launches, step_ms, wall, loop_steps


def phase_steady_vo(dev, card):
    import torch

    from pointnav_vo_tpu_torch.io.weights import seeded_init_
    from pointnav_vo_tpu_torch.vo.ensemble import (
        VOEnsemble,
        VOInferenceConfig,
        frame_features_packed,
    )

    batch, iters = STEADY_BATCH, 10
    cfg = VOInferenceConfig(vis_size_h=H, vis_size_w=W)
    g = torch.Generator().manual_seed(SEED + 2)
    vo = VOEnsemble(cfg, experts=[seeded_init_(cfg.make_model(), g) for _ in range(3)],
                    device=dev)
    rng = np.random.default_rng(SEED)
    frames = [(torch.from_numpy(rng.uniform(0, 255, (batch, H, W, 3)).astype(np.float32)).to(dev),
               torch.from_numpy(rng.uniform(0, 1, (batch, H, W, 1)).astype(np.float32)).to(dev))
              for _ in range(2)]
    actions = np.where(rng.uniform(size=batch) < 0.7, 1,
                       rng.integers(2, 4, batch)).astype(np.int64)
    state = {"feats": frame_features_packed(*frames[0], cfg), "i": 0}

    def step():
        rgb, depth = frames[state["i"] % 2]
        state["i"] += 1
        delta, state["feats"] = vo.predict_step_cached(state["feats"], rgb, depth, actions)
        return delta

    torch.cuda.reset_peak_memory_stats(dev)
    ms = _time_ms(step, iters, warmup=2)
    _profile(f"predict_step_cached at B={batch}", step, iters=2)
    delta = step()
    torch.cuda.synchronize()
    if not bool(torch.isfinite(delta).all()) or delta.shape != (batch, 3):
        raise AssertionError("steady-state VO delta is not finite [512, 3]")
    pairs = batch / (ms / 1e3)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    _log("steady", f"predict_step_cached B={batch} fp32 70/15/15: {ms:.3f} ms/step, "
                   f"{pairs:.2f} frame-pairs/s, peak {peak:.2f} GiB on {card}")
    return ms, pairs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _log("env", f"python {sys.version.split()[0]}, torch {torch.__version__}, "
                f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    card = phase_build()
    max_err, timings = phase_kernel(dev)
    launches, step_ms, wall, loop_steps = phase_main_path(dev)
    phase_steady_vo(dev, card)

    t32 = timings[N_ENVS]  # the main path's batch
    record = {"kernels": [{
        "name": "bin_counts",
        "route": "cuda",
        "source": "pointnav_vo_tpu_torch/csrc/bin_counts.cu",
        "replaces": "pointnav_vo_tpu/ops/topdown_pallas.py:81",
        "launches": launches["bin_counts"],
        "max_abs_err": max_err,
        "ms": t32["ms"],
        "plain_ms": t32["plain_ms"],
        "bound_ms": t32["bound_ms"],
        "bound_by": "bytes",
        "library_ms": t32["library_ms"],
    }]}
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
