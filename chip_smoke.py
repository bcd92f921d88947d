#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pointnav_vo_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, each printing a line; any failure exits non-zero:

1. build: every kernel under ``pointnav_vo_tpu_torch/csrc/`` with nvcc
   (all started together), its ptxas register/shared-memory report, and the
   card's name and power limit;
2. kernel check: ``bin_counts`` on random bins and on ``pixel_bins`` of
   scripted-env depth at batch 1, 2, 32, 64, 128 and 512 (2: the policy
   training rollout's; 64 and 128: the VO training batches), and on a
   190-row grid, a grid
   cut into bands of rows, more points per image than a 16-bit count holds,
   one hot cell, all points dropped and batch 0, each ``torch.equal`` to its
   plain version on the card.  Times, on scripted-env depth, in two turns:
   ``device_ms``, the kernel's own device time (torch.profiler, L2 flushed
   before each launch by writing 256 MiB), also unflushed; ``call_ms``, the
   wrapper's time per call back to back (CUDA events); the plain version's
   and ``torch.bincount``'s device time (a yardstick only), beside the
   memory bound, and the cluster plan the wrapper chose;
3. main path: ``Evaluator.run`` of the det VO-in-the-loop eval at full
   width (three ``vo_cnn_rgb_d_dd_top_down`` experts and the ResNet18 +
   2-layer LSTM-512 policy at 341x192, seeded random weights, fp32, TF32
   off) over 32 scripted envs, an exact set of 32 episodes; the kernel's
   launch count must rise by exactly steps + 1.  Then the per-step time of
   ``fused_vo_act_step`` and one step held against the same step on the CPU.
   Then the same in bf16 (``precision="bf16"``, the JAX package's deployed
   mode): ``Evaluator.run`` (steps + 1 launches), the step's time and device
   time, and one bf16 step held against the CPU's bf16 step and against the
   card's fp32 step (deltas within a stated relative distance, actions equal
   wherever the fp32 logit margin exceeds a stated bound);
4. rnd eval: ``Evaluator.run`` again with the experts in rnd mode (10
   dropout passes, mean and std) and sampled actions, an exact set of 32
   episodes: finite aggregates, ``vo_pred_std_mean > 0``, steps + 1
   launches.  Then the rnd step's time, a profiler breakdown, and one rnd
   step held against the CPU on the same dropout masks (mode actions);
5. steady-state VO: ``VOEnsemble.predict_step_cached`` at batch 512 with a
   70/15/15 forward/left/right action mix in fp32, bf16, fp32 with the int8
   feature cache and bf16 with it: ms/step, device ms, frame-pairs/s, peak
   memory and the cache's bytes per frame; the int8 deltas within 0.05 of
   the native ones, and the fp32+int8 pack ``torch.equal`` to the CPU's;
6. VO training (``VORegressionEngine``, full width, seeded experts, frame
   pairs from the scripted env held in memory: the card has no h5py):
   (a) the forward stage at batch 128: ``train_epoch`` over 8 steps, 8 steps
   on one fixed batch with fixed dropout masks (its loss must fall),
   ``evaluate`` over a ragged
   eval set; (b) the joint turn stage, 64 twin-packed entries a batch with
   the inverse loss: the same, ``debug_geo/*`` under 1e-4; each with
   ``bin_counts`` launched exactly twice a step (prev and cur frames) and
   twice an eval batch, frame-pairs/s, peak memory and a profiler
   breakdown; (c) one train step of each stage at batch 8 (dropout off)
   held against the same step on the CPU: loss, every gradient (beside
   both devices' distance from a float64 step) and the whitening
   statistics; (d) both stages again in bf16 mixed precision at batch 128:
   the fixed batch's loss over 8 steps (it must fall), step ms and
   frame-pairs/s, parameters and Adam moments still float32, and one bf16
   step at batch 8 held against the CPU's bf16 step, both sides' gradients
   beside the float64 step of (c);
7. policy training (``DDPPOTrainer``, the config of
   ``configs/rl/ddppo_pointnav.yaml``: the ResNet18 + 2-layer LSTM-512
   policy and three det VO experts in the loop at 341x192, 2 envs, 128
   steps a rollout, 2 minibatches, lr 1e-4, seeded weights): ``train`` of 2
   updates with ``bin_counts`` launched exactly updates x 128 + 1 times,
   rollout-step and update times, env-steps/s, device idle share and
   launches per step and per update (torch.profiler), peak memory; the
   loss of one fixed rollout must fall over 4 updates on it; one rollout
   step (mode action, VO delta, goal) and one ``ppo_loss`` gradient on a
   16-step rollout held against the CPU (gradients beside a float64 step);
8. the CLI (``python -m pointnav_vo_tpu_torch.run``, called as
   ``run.main``) on ``configs/rl/ddppo_pointnav.yaml`` at full width in a
   temporary log root, seeded experts (``VO.REGRESS_MODEL.pretrained
   False``), a checkpoint every update: train 2 updates (exactly 2 x 128 + 1
   launches, two checkpoints); eval the checkpoint folder as a sweep (2
   episodes each under a 20-step cap, exactly steps + 1 launches per
   checkpoint); resume from the last checkpoint to update 3 (it restarts
   at the stored update with ``count_steps`` restored); a run with the
   preemption flag set (the interrupted state at update 0, then return).
   Wall time of each run, env-steps/s, checkpoint bytes, sync and async
   save times, the eval metrics;
9. the deployment agent: one episode of ``PointNavVOAgent`` (det, seeded
   weights, STOP logit lowered and a planned act's logit raised before each
   act, so the forward, left and right experts each run, 24-step cap) on a
   scripted env at full width, every act held against the same agent on
   the CPU (actions equal, goal within rtol 1e-3 / atol 1e-4), each expert
   run at least once, one launch an act after the first and one more on the
   first VO step, the per-act time (host clock, synchronized), and the
   goal's drift at the episode's end (card against CPU, and against the
   true goal);
10. the 994-episode protocol at a smoke size
   (``pointnav_vo_tpu_torch/examples/eval_994.py``): three bf16 experts
   trained for one epoch on 600 oracle-follower pairs held in memory,
   then ``Evaluator.run`` of 32 distinct episodes over 32 envs with the
   greedy goal policy (a 30-step cap), ``bin_counts`` launched exactly
   once per step plus one.

Each phase's wall time is printed after it (``[time]``).

The second-to-last lines are the kernels' JSON record and the card's
``nvidia-smi`` name/power line; the last line is the run's JSON verdict.
Exits non-zero, printing no verdict, where no CUDA card is present.
"""

from __future__ import annotations

import copy
import dataclasses
import glob
import json
import os
import subprocess
import sys
import time

import numpy as np

H, W = 192, 341  # full width of the deployed models
BAND = min(100, H)  # 2 * rows_around_center rows of candidate points
KERNEL_BATCHES = (1, 2, 32, 64, 128, 512)
N_ENVS = 32
STEADY_BATCH = 512
RND_PASSES = 10  # VO.REGRESS_MODEL rnd_mode_n
TRAIN_BATCH = 128  # configs/vo/vo_pointnav.yaml VO.TRAIN.batch_size
TRAIN_STEPS = 8
EVAL_PAIRS = 300  # three eval batches, the last one padded
PARITY_BATCH = 8
RL_ENVS = 2  # configs/rl/ddppo_pointnav.yaml NUM_PROCESSES
RL_STEPS = 128  # RL.PPO.num_steps
RL_UPDATES = 2
RL_FIXED_UPDATES = 4
RL_PARITY_STEPS = 16
CLI_UPDATES = 2  # phase 8: NUM_UPDATES of the train run
CLI_RESUME_UPDATES = 3
CLI_EVAL_EPISODES = 2  # EVAL.TEST_EPISODE_COUNT per checkpoint
CLI_EVAL_CAP = 20  # TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS of the eval sweep
AGENT_CAP = 24  # phase 9: the episode's step cap
# phase 9: the action logits' bias before each act: STOP lowered, and the
# act of AGENT_PLAN (cycled; forward, left, right) raised by AGENT_FAVOUR, so
# that every expert runs
AGENT_STOP_BIAS = -4.0
AGENT_PLAN = (1, 1, 2, 1, 3)
AGENT_FAVOUR = 8.0
STEADY_CONFIGS = (("fp32", "native"), ("bf16", "native"), ("fp32", "int8"), ("bf16", "int8"))
INT8_DELTA_ABS = 0.05  # int8 vs native deltas: tests/test_vo_ensemble.py's bound
INT8_PACK_ROWS = 64  # phase 5: frames of the int8 pack held card vs CPU
LOGIT_MARGIN = 0.05  # bf16 and fp32 actions agree where the fp32 top-two logit gap exceeds this
BF16_DELTA_REL = 5e-2  # bf16 deltas: relative L2 distance over the fp32 deltas' norm
# phase 6's bf16 gradient gates (see _train_step_bf16_vs_cpu)
BF16_SIDE_RATIO = 1.5
BF16_GRAD_REL = 0.27
BF16_TENSOR_RATIO = 2.0
BF16_TENSOR_FLOOR = 5e-2
E994_PAIRS, E994_EVAL_PAIRS, E994_EPOCHS = 600, 64, 1  # phase 10
E994_EPISODES, E994_CAP = 32, 30
BF16_EVAL_CAP = 10  # phase 3 in bf16: the episode cap of its Evaluator.run
RL_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "configs", "rl", "ddppo_pointnav.yaml")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
_FLUSH_KERNEL = "bitwise_not"  # the L2 flush's kernel, left out of device times
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
        return None
    launches = sum(e.count for e in kernels) / iters
    _log("profile", f"{label}: device busy {busy_ms:.4f} ms of {wall_ms:.4f} ms wall "
                    f"per call ({100 * (1 - busy_ms / wall_ms):.1f} % idle, profiler on), "
                    f"{launches:.0f} kernel launches per call")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        _log("profile", f"  {e.self_device_time_total / 1e3 / iters:9.4f} ms "
                        f"x{e.count // iters:<4d} {e.key[:90]}")
    return {"busy_ms": busy_ms, "wall_ms": wall_ms, "idle": 1 - busy_ms / wall_ms,
            "launches": launches}


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


def _device_ms(fn, iters, flush=None):
    """Device time per call of ``fn()`` in ms from torch.profiler: the sum
    of the kernels it launches, over ``iters`` calls, each after ``flush``
    (an L2 flush) when one is given."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            if flush is not None:
                flush()
            fn()
        torch.cuda.synchronize()
    per = [e.self_device_time_total / 1e3 / iters for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and e.self_device_time_total > 0 and _FLUSH_KERNEL not in e.key]
    if not per:
        raise AssertionError("device time not measured: the profiler saw no kernels")
    return sum(per)


def _check_equal(got, want, what):
    import torch

    torch.cuda.synchronize()
    err = float((got - want).abs().max()) if want.numel() else 0.0
    if not torch.equal(got, want):
        raise AssertionError(f"bin_counts != plain ({what}): max abs err {err}")
    return err


def _edge_cases(dev):
    """Another grid height, a grid in two bands of rows, twice the points a
    16-bit count holds per image, one hot cell holding every point, every
    point dropped (output from torch.empty over freed garbage) and batch 0;
    each equal to the plain version."""
    import torch

    from pointnav_vo_tpu_torch.ops import topdown_kernels as tk

    rng = np.random.default_rng(SEED + 3)
    b, n = N_ENVS, BAND * W
    cases = {}
    h2 = 190
    cases["190 rows"] = (
        torch.from_numpy(rng.integers(-3, h2 + 3, (b, BAND, W)).astype(np.int32)),
        torch.from_numpy(rng.integers(-3, W + 3, (b, BAND, W)).astype(np.int32)),
        torch.from_numpy(rng.uniform(size=(b, BAND, W)) < 0.8), h2)
    hot_r = torch.from_numpy(rng.integers(0, H, (b, 1, 1)).astype(np.int32))
    hot_c = torch.from_numpy(rng.integers(0, W, (b, 1, 1)).astype(np.int32))
    h3 = 400  # two bands of rows
    cases["400 rows in bands"] = (
        torch.from_numpy(rng.integers(-3, h3 + 3, (2, BAND, W)).astype(np.int32)),
        torch.from_numpy(rng.integers(-3, W + 3, (2, BAND, W)).astype(np.int32)),
        torch.from_numpy(rng.uniform(size=(2, BAND, W)) < 0.8), h3)
    cases["68,200 points per image"] = (
        torch.from_numpy(rng.integers(0, H, (2, 2 * BAND, W)).astype(np.int32)),
        torch.from_numpy(rng.integers(0, W, (2, 2 * BAND, W)).astype(np.int32)),
        torch.ones((2, 2 * BAND, W), dtype=torch.bool), H)
    cases["hot cell"] = (hot_r.expand(b, BAND, W).contiguous(),
                         hot_c.expand(b, BAND, W).contiguous(),
                         torch.ones((b, BAND, W), dtype=torch.bool), H)
    cases["all dropped"] = (torch.zeros((b, BAND, W), dtype=torch.int32),
                            torch.zeros((b, BAND, W), dtype=torch.int32),
                            torch.zeros((b, BAND, W), dtype=torch.bool), H)
    cases["batch 0"] = (torch.zeros((0, BAND, W), dtype=torch.int32),
                        torch.zeros((0, BAND, W), dtype=torch.int32),
                        torch.zeros((0, BAND, W), dtype=torch.bool), H)
    err = 0.0
    for what, (pix_r, pix_c, keep, h) in cases.items():
        pix_r, pix_c, keep = pix_r.to(dev), pix_c.to(dev), keep.to(dev)
        want = tk.bin_counts_reference(pix_r, pix_c, keep, h, W)
        garbage = torch.full((pix_r.shape[0], h, W), float("nan"), device=dev)
        del garbage  # the allocator hands its block to the kernel's output
        before = tk.launch_counts["bin_counts"]
        got = tk.bin_counts(pix_r, pix_c, keep, h, W)
        err = max(err, _check_equal(got, want, what))
        if tk.launch_counts["bin_counts"] - before != int(pix_r.shape[0] > 0):
            raise AssertionError(f"{what}: wrong number of launches")
        if what == "hot cell" and int(want.amax()) != n:
            raise AssertionError(f"hot cell holds {int(want.amax())} of {n} points")
        _log("kernel", f"{what}: equal to plain version ({int(want.sum())} points binned)")
    return err


def phase_kernel(dev):
    import torch

    from pointnav_vo_tpu_torch.ops import topdown_kernels as tk
    from pointnav_vo_tpu_torch.ops.topdown import TopDownParams, pixel_bins

    rng = np.random.default_rng(SEED)
    depths = torch.from_numpy(_scripted_depth(max(KERNEL_BATCHES), seed=1000)).to(dev)
    params = TopDownParams(vis_size_h=H, vis_size_w=W)
    # writing 256 MiB evicts the 50 MB L2, so each timed launch reads from HBM
    scratch = torch.zeros(64 << 20, dtype=torch.int32, device=dev)
    flush = scratch.bitwise_not_
    max_err = _edge_cases(dev)
    timings = {}
    for b in KERNEL_BATCHES:
        random_bins = (
            torch.from_numpy(rng.integers(-3, H + 3, (b, BAND, W)).astype(np.int32)).to(dev),
            torch.from_numpy(rng.integers(-3, W + 3, (b, BAND, W)).astype(np.int32)).to(dev),
            torch.from_numpy(rng.uniform(size=(b, BAND, W)) < 0.8).to(dev))
        depth_bins = pixel_bins(depths[:b].contiguous(), params)
        for kind, bins in (("random", random_bins), ("scripted-depth", depth_bins)):
            want = tk.bin_counts_reference(*bins, H, W)
            got = tk.bin_counts(*bins, H, W)
            max_err = max(max_err, _check_equal(got, want, f"B={b} {kind}"))
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
        kernel = lambda: tk.bin_counts(pix_r, pix_c, keep, H, W)  # noqa: E731
        dev_iters, call_iters = 20, (200 if b < 512 else 50)
        turns = {"device_ms": [], "call_ms": []}
        for _ in range(2):
            turns["device_ms"].append(_device_ms(kernel, dev_iters, flush))
            turns["call_ms"].append(_time_ms(kernel, call_iters))
        plan = tk.card_plan(b, BAND * W, H, W, dev)
        t = {
            "device_ms": float(np.mean(turns["device_ms"])),
            "call_ms": float(np.mean(turns["call_ms"])),
            "device_ms_l2_warm": _device_ms(kernel, dev_iters),
            "plain_ms": _device_ms(
                lambda: tk.bin_counts_reference(pix_r, pix_c, keep, H, W), dev_iters, flush),
            "library_ms": _device_ms(
                lambda: torch.bincount(flat, minlength=b * H * W + 1), dev_iters, flush),
            "bound_ms": bound_ms,
            "bytes": nbytes,
            "cluster": plan.cluster,
            "turns": turns,
        }
        timings[b] = t
        _log("kernel", f"B={b}: device_ms={t['device_ms']:.5f} (L2 flushed; "
                       f"{t['device_ms_l2_warm']:.5f} unflushed) call_ms={t['call_ms']:.5f} "
                       f"plain_ms={t['plain_ms']:.5f} library_ms(torch.bincount)="
                       f"{t['library_ms']:.5f} bound_ms={bound_ms:.5f} "
                       f"({nbytes} B over 3.35 TB/s, {100 * bound_ms / t['device_ms']:.1f} % "
                       f"of bound), cluster of {plan.cluster}; turns " + json.dumps(turns))
    del scratch
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
    errs = _compare_step(got, want)
    _log("main", "card vs CPU fused step (rtol 1e-3, atol 1e-4; actions equal): "
                 + json.dumps(errs, sort_keys=True))
    return launches, step_ms, wall, loop_steps


def _compare_step(got, want):
    """Card outputs of ``fused_vo_act_step`` against the CPU's: actions
    equal, the rest within rtol 1e-3 / atol 1e-4 (fp32 with TF32 off: cuDNN
    and the CPU sum in other orders).  Returns the max abs errors."""
    import torch

    names = ("goal_cart", "polar", "delta", "std", "value", "action", "logp", "hidden",
             "cur_feats", "est_rot", "est_pos")
    errs = {}
    for name, g, w in zip(names, got, want, strict=True):
        g = g.cpu()
        errs[name] = float((g.double() - w.double()).abs().max())
        if name == "action":
            if not torch.equal(g, w):
                raise AssertionError("card and CPU actions differ")
        elif not torch.allclose(g, w, rtol=1e-3, atol=1e-4):
            raise AssertionError(f"card vs CPU {name}: max abs err {errs[name]}")
    return errs


def _logits(policy, args, polar):
    """The policy's logits on a fused step's inputs with ``polar`` as goal."""
    import torch

    with torch.no_grad():
        obs = {"rgb": args["cur_rgb"], "depth": args["cur_depth"],
               "pointgoal_with_gps_compass": polar}
        return policy(obs, args["hidden"], args["prev_actions"], args["masks"])[0]


def _bf16_vs(got, want, margin, what):
    """A bf16 fused step against a reference step (the CPU's bf16 or the
    card's fp32): the delta within BF16_DELTA_REL of the reference's norm,
    the actions equal where ``margin`` (the fp32 step's top-two logit gap)
    exceeds LOGIT_MARGIN.  Returns the measured distances."""
    import torch

    g_delta, w_delta = got[2].cpu().double(), want[2].cpu().double()
    rel = float((g_delta - w_delta).norm() / w_delta.norm().clamp(min=1e-30))
    firm = margin.cpu() > LOGIT_MARGIN
    differ = (got[5].cpu() != want[5].cpu())[:, 0]
    out = {"delta_rel_l2": rel, "delta_max_abs": float((g_delta - w_delta).abs().max()),
           "goal_max_abs": float((got[0].cpu() - want[0].cpu()).abs().max()),
           "actions_differ": int(differ.sum()), "rows_within_margin": int((~firm).sum())}
    if rel > BF16_DELTA_REL:
        raise AssertionError(f"bf16 step vs {what}: delta relative L2 {rel} > {BF16_DELTA_REL}")
    if bool((differ & firm).any()):
        raise AssertionError(f"bf16 step vs {what}: actions differ where the fp32 logit margin "
                             f"exceeds {LOGIT_MARGIN}")
    if got[8].dtype != torch.bfloat16:
        raise AssertionError(f"the bf16 step's feature cache is {got[8].dtype}")
    return out


def phase_main_path_bf16(dev, card):
    """Phase 3 in bf16: the eval loop, the step's times, and one step against
    the CPU's bf16 step and the card's fp32 step."""
    import torch

    from pointnav_vo_tpu_torch.ops import topdown_kernels as tk
    from pointnav_vo_tpu_torch.rl.envs import EnvConfig, make_scripted_vector_env
    from pointnav_vo_tpu_torch.rl.eval import Evaluator, fused_vo_act_step
    from pointnav_vo_tpu_torch.vo.ensemble import VOInferenceConfig

    n_envs = n_episodes = N_ENVS
    cfg = VOInferenceConfig(vis_size_h=H, vis_size_w=W, precision="bf16")
    cfg32 = VOInferenceConfig(vis_size_h=H, vis_size_w=W)
    vo, policy, cpu_vo, cpu_policy = _build_models(cfg, dev, SEED)
    vo32, _policy32, _cpu_vo32, _cpu_policy32 = _build_models(cfg32, dev, SEED)
    env_cfg = EnvConfig(image_h=H, image_w=W, max_episode_steps=BF16_EVAL_CAP)
    ev = Evaluator(model=policy, envs=make_scripted_vector_env(env_cfg, n_envs, seed=SEED),
                   vo_ensemble=vo, device=dev)
    tk.reset_launch_counts()
    t0 = time.perf_counter()
    agg = ev.run(n_episodes)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = tk.launch_counts["bin_counts"]
    loop_steps = max(r.steps for r in ev.results)
    _log("main-bf16", "Evaluator.run: " + json.dumps(agg, sort_keys=True))
    if agg["episodes"] != n_episodes or not all(np.isfinite(v) for v in agg.values()):
        raise AssertionError(f"bf16 eval: {agg}")
    if launches != loop_steps + 1:
        raise AssertionError(f"bf16 eval: bin_counts launched {launches} times over "
                             f"{loop_steps} steps; expected steps + 1")
    _log("main-bf16", f"{loop_steps} steps, {int(agg['total_env_steps'])} env steps, wall "
                      f"{wall:.3f} s, bin_counts launches {launches}")

    probe = make_scripted_vector_env(env_cfg, n_envs, seed=SEED + 1)
    obs0 = probe.reset()
    rng = np.random.default_rng(SEED)
    actions = np.where(rng.uniform(size=n_envs) < 0.7, 1,
                       rng.integers(2, 4, n_envs)).astype(np.int64)
    obs1 = probe.step(actions)[0]
    args = _fused_inputs(obs0, obs1, actions, dev, cfg, policy)
    args32 = _fused_inputs(obs0, obs1, actions, dev, cfg32, policy)
    step_ms = _time_ms(lambda: fused_vo_act_step(policy, vo, **args), iters=20)
    step32_ms = _time_ms(lambda: fused_vo_act_step(policy, vo32, **args32), iters=20)
    prof = _profile(f"bf16 fused_vo_act_step at {n_envs} envs",
                    lambda: fused_vo_act_step(policy, vo, **args))
    prof32 = _profile(f"fp32 fused_vo_act_step at {n_envs} envs (beside it)",
                      lambda: fused_vo_act_step(policy, vo32, **args32))
    _log("main-bf16", f"fused_vo_act_step at {n_envs} envs: bf16 {step_ms:.4f} ms/step, fp32 "
                      f"{step32_ms:.4f} ms/step in the same call (CUDA events); device "
                      f"{prof['busy_ms'] if prof else 'not measured'} ms bf16, "
                      f"{prof32['busy_ms'] if prof32 else 'not measured'} ms fp32 on {card}")

    got = fused_vo_act_step(policy, vo, **args)
    want32 = fused_vo_act_step(policy, vo32, **args32)
    top2 = torch.topk(_logits(policy, args32, want32[1]), 2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    cpu_args = _fused_inputs(obs0, obs1, actions, torch.device("cpu"), cfg, cpu_policy)
    want_cpu = fused_vo_act_step(cpu_policy, cpu_vo, **cpu_args)
    vs_cpu = _bf16_vs(got, want_cpu, margin, "the CPU's bf16 step")
    vs_fp32 = _bf16_vs(got, want32, margin, "the card's fp32 step")
    _log("main-bf16", f"card bf16 step vs CPU bf16 step (delta relative L2 bound "
                      f"{BF16_DELTA_REL}, actions equal where the fp32 logit margin > "
                      f"{LOGIT_MARGIN}): " + json.dumps(vs_cpu, sort_keys=True))
    _log("main-bf16", "card bf16 step vs card fp32 step (the same bounds): "
                      + json.dumps(vs_fp32, sort_keys=True))
    return {"launches": launches, "loop_steps": loop_steps, "wall_s": wall, "step_ms": step_ms,
            "fp32_step_ms": step32_ms, "device_ms": prof["busy_ms"] if prof else None,
            "fp32_device_ms": prof32["busy_ms"] if prof32 else None, "vs_cpu_bf16": vs_cpu,
            "vs_card_fp32": vs_fp32, "metrics": agg}


def phase_rnd_eval(dev):
    """The eval loop with the VO in rnd mode and sampled actions."""
    import torch

    from pointnav_vo_tpu_torch.ops import topdown_kernels as tk
    from pointnav_vo_tpu_torch.rl.envs import EnvConfig, make_scripted_vector_env
    from pointnav_vo_tpu_torch.rl.eval import Evaluator, fused_vo_act_step
    from pointnav_vo_tpu_torch.vo.ensemble import VOInferenceConfig

    n_envs = n_episodes = N_ENVS
    cfg = VOInferenceConfig(vis_size_h=H, vis_size_w=W, mode="rnd", rnd_mode_n=RND_PASSES)
    vo, policy, cpu_vo, cpu_policy = _build_models(cfg, dev, SEED)
    env_cfg = EnvConfig(image_h=H, image_w=W, max_episode_steps=20)
    ev = Evaluator(model=policy, envs=make_scripted_vector_env(env_cfg, n_envs, seed=SEED + 5),
                   vo_ensemble=vo, device=dev, deterministic=False,
                   generator=torch.Generator(device=dev).manual_seed(SEED))

    tk.reset_launch_counts()
    t0 = time.perf_counter()
    agg = ev.run(n_episodes)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = tk.launch_counts["bin_counts"]
    loop_steps = max(r.steps for r in ev.results)
    _log("rnd", "Evaluator.run: " + json.dumps(agg, sort_keys=True))
    if agg["episodes"] != n_episodes or len(ev.results) != n_episodes:
        raise AssertionError(f"expected exactly {n_episodes} episodes, got {agg['episodes']}")
    bad = [k for k, v in agg.items() if not np.isfinite(v)]
    if bad:
        raise AssertionError(f"non-finite aggregates: {bad}")
    if not agg["vo_pred_std_mean"] > 0:
        raise AssertionError(f"rnd mode reports vo_pred_std_mean {agg['vo_pred_std_mean']}")
    if launches != loop_steps + 1:
        raise AssertionError(f"bin_counts launched {launches} times over {loop_steps} "
                             "steps; expected steps + 1")
    _log("rnd", f"{loop_steps} steps, {int(agg['total_env_steps'])} env steps, wall "
                f"{wall:.3f} s, bin_counts launches {launches}")

    probe = make_scripted_vector_env(env_cfg, n_envs, seed=SEED + 1)
    obs0 = probe.reset()
    rng = np.random.default_rng(SEED)
    actions = np.where(rng.uniform(size=n_envs) < 0.7, 1,
                       rng.integers(2, 4, n_envs)).astype(np.int64)
    obs1 = probe.step(actions)[0]
    args = _fused_inputs(obs0, obs1, actions, dev, cfg, policy)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def step():
        return fused_vo_act_step(policy, vo, **args, deterministic=False, generator=gen)

    step_ms = _time_ms(step, iters=20)
    _log("rnd", f"rnd fused_vo_act_step at {n_envs} envs, {RND_PASSES} passes: "
                f"{step_ms:.4f} ms/step (CUDA events, host gaps included)")
    _profile(f"rnd fused_vo_act_step at {n_envs} envs", step)

    # the same masks on both, drawn once on the host; mode actions
    masks = cpu_vo.draw_masks(torch.Generator().manual_seed(SEED + 7), n_envs)
    got = fused_vo_act_step(policy, vo, **args, vo_masks=tuple(m.to(dev) for m in masks))
    cpu_args = _fused_inputs(obs0, obs1, actions, torch.device("cpu"), cfg, cpu_policy)
    want = fused_vo_act_step(cpu_policy, cpu_vo, **cpu_args, vo_masks=masks)
    if not float(want[3].min()) > 0:
        raise AssertionError("the CPU's rnd step gave a zero std")
    errs = _compare_step(got, want)
    _log("rnd", "card vs CPU rnd step on the same masks (rtol 1e-3, atol 1e-4; actions "
                "equal): " + json.dumps(errs, sort_keys=True))
    return launches, step_ms


def phase_steady_vo(dev, card):
    """The B=512 steady-state VO step in each of STEADY_CONFIGS, the same
    experts and frames in each."""
    import torch

    from pointnav_vo_tpu_torch.io.weights import seeded_init_
    from pointnav_vo_tpu_torch.vo.ensemble import (
        VOEnsemble,
        VOInferenceConfig,
        frame_features_packed,
    )

    batch, iters = STEADY_BATCH, 10
    rng = np.random.default_rng(SEED)
    frames = [(torch.from_numpy(rng.uniform(0, 255, (batch, H, W, 3)).astype(np.float32)).to(dev),
               torch.from_numpy(rng.uniform(0, 1, (batch, H, W, 1)).astype(np.float32)).to(dev))
              for _ in range(2)]
    actions = np.where(rng.uniform(size=batch) < 0.7, 1,
                       rng.integers(2, 4, batch)).astype(np.int64)
    out, fixed = {}, {}
    for precision, cache_dtype in STEADY_CONFIGS:
        cfg = VOInferenceConfig(vis_size_h=H, vis_size_w=W, precision=precision,
                                cache_dtype=cache_dtype)
        g = torch.Generator().manual_seed(SEED + 2)
        vo = VOEnsemble(cfg, experts=[seeded_init_(cfg.make_model(), g) for _ in range(3)],
                        device=dev)
        state = {"feats": frame_features_packed(*frames[0], cfg), "i": 0}

        def step():
            rgb, depth = frames[state["i"] % 2]
            state["i"] += 1
            delta, state["feats"] = vo.predict_step_cached(state["feats"], rgb, depth, actions)
            return delta

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        ms = _time_ms(step, iters, warmup=2)
        name = f"{precision}+{cache_dtype}"
        prof = _profile(f"predict_step_cached at B={batch} {name}", step, iters=2)
        delta = step()
        torch.cuda.synchronize()
        feats = state["feats"]
        want = torch.int8 if cache_dtype == "int8" else cfg.dtype
        if not bool(torch.isfinite(delta).all()) or delta.shape != (batch, 3):
            raise AssertionError(f"steady-state VO {name}: delta is not finite [512, 3]")
        if feats.dtype != want:
            raise AssertionError(f"steady-state VO {name}: the cache is {feats.dtype}")
        rec = {"ms": ms, "device_ms": prof["busy_ms"] if prof else None,
               "frame_pairs_per_s": batch / (ms / 1e3),
               "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
               "cache_bytes_per_frame": feats[0].numel() * feats.element_size()}
        out[name] = rec
        _log("steady", f"predict_step_cached B={batch} {name} 70/15/15: {ms:.3f} ms/step "
                       f"(device {rec['device_ms']} ms), {rec['frame_pairs_per_s']:.2f} "
                       f"frame-pairs/s, peak {rec['peak_gib']:.2f} GiB, cache "
                       f"{rec['cache_bytes_per_frame']} B a frame on {card}")
        # one fixed step, frames[0] cached -> frames[1], for the int8 checks
        # (kept small and off the card: the next configs' peaks stay their own)
        delta, pack = vo.predict_step_cached(frame_features_packed(*frames[0], cfg),
                                             *frames[1], actions)
        fixed[name] = (delta, pack[:INT8_PACK_ROWS].cpu())
        del vo, state, feats, delta, pack

    # int8 against native at full width: JAX's bound (tests/test_vo_ensemble.py)
    for precision in ("fp32", "bf16"):
        err = float((fixed[f"{precision}+int8"][0] - fixed[f"{precision}+native"][0])
                    .abs().max())
        out[f"{precision}+int8"]["delta_vs_native_max_abs"] = err
        _log("steady", f"B={batch} {precision}: int8 deltas vs native max abs {err:.3e} "
                       f"(bound {INT8_DELTA_ABS})")
        if not err < INT8_DELTA_ABS:
            raise AssertionError(f"steady-state VO {precision}: int8 deltas {err} from native")
    # the card's fp32+int8 pack against (a) the plain quantization, on the
    # CPU, of the card's own fp32 pack of the same frames: equal; (b) the
    # CPU's fp32+int8 pack: equal wherever the two fp32 packs are (these
    # may differ in at most 0.1 % of cells: pixel_bins floors float32
    # expressions, the standing deviation of tests/test_torch_port_ops.py)
    got, got32 = fixed["fp32+int8"][1], fixed["fp32+native"][1]
    plain = torch.clamp(torch.round(got32 * 127.0), 0, 127).to(torch.int8)
    cpu_frames = [t[:INT8_PACK_ROWS].cpu() for t in frames[1]]
    want = frame_features_packed(*cpu_frames, VOInferenceConfig(
        vis_size_h=H, vis_size_w=W, cache_dtype="int8"))
    want32 = frame_features_packed(*cpu_frames, VOInferenceConfig(vis_size_h=H, vis_size_w=W))
    same32 = got32 == want32
    rec = {"cells": want.numel(), "vs_plain_quantization": int((got != plain).sum()),
           "fp32_pack_vs_cpu": int((~same32).sum()),
           "vs_cpu_where_fp32_equal": int(((got != want) & same32).sum())}
    out["fp32+int8"]["pack_cells_differing"] = rec
    _log("steady", f"fp32+int8 pack of {INT8_PACK_ROWS} frames, int8 cells differing (card vs "
                   f"the plain quantization of its fp32 pack, and vs the CPU's pack where "
                   f"the fp32 packs agree: both must be 0): " + json.dumps(rec))
    if (got.dtype != torch.int8 or rec["vs_plain_quantization"] or rec["vs_cpu_where_fp32_equal"]
            or rec["fp32_pack_vs_cpu"] > 1e-3 * rec["cells"]):
        raise AssertionError(f"the card's fp32+int8 pack: {rec}")
    return out


def _train_stage(dev, card, stage, engine, data, eval_data):
    """train_epoch, fixed-batch steps, and (where ``eval_data``) evaluate,
    each with its exact launch count; returns the stage's record."""
    import torch

    from pointnav_vo_tpu_torch.ops import topdown_kernels as tk

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    tk.reset_launch_counts()
    stats = engine.train_epoch()
    launches = tk.launch_counts["bin_counts"]
    if launches != 2 * TRAIN_STEPS:
        raise AssertionError(f"{stage}: bin_counts launched {launches} times over "
                             f"{TRAIN_STEPS} steps; expected 2 a step")
    if not np.isfinite(stats["mean_total_loss"]):
        raise AssertionError(f"{stage}: epoch loss {stats['mean_total_loss']}")
    _log("train", f"{stage} train_epoch: {TRAIN_STEPS} steps of {TRAIN_BATCH}, mean loss "
                  f"{stats['mean_total_loss']:.6f}, {stats['frame_pairs_per_s']:.2f} "
                  f"frame-pairs/s over the epoch (host batches included), bin_counts "
                  f"launches {launches}")

    # the loss of one fixed batch under one fixed set of dropout masks (the
    # generator restarted before each step): a fixed objective, which 8
    # steps on it must lower
    batch = next(data.iter_batches(TRAIN_BATCH))
    gen_state = engine.generator.get_state()
    losses, debug_geo = [], []
    for _ in range(TRAIN_STEPS + 1):  # the last step's loss is after 8 updates
        engine.generator.set_state(gen_state)
        m = engine.train_step(batch)
        losses.append(float(m["total_loss"]))
        if "debug_geo/abs_diff_rot" in m:
            debug_geo.append(max(float(m["debug_geo/abs_diff_rot"]),
                                 float(m["debug_geo/abs_diff_pos"].max())))
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"{stage}: the fixed batch's loss did not fall: {losses}")
    if debug_geo and max(debug_geo) >= 1e-4:
        raise AssertionError(f"{stage}: debug_geo {max(debug_geo)} (ground truth not invariant)")
    _log("train", f"{stage} fixed batch and dropout masks, loss before each of "
                  f"{TRAIN_STEPS + 1} steps: " + " ".join(f"{x:.6f}" for x in losses)
                  + (f"; debug_geo max {max(debug_geo):.3e}" if debug_geo else ""))

    step_ms = _time_ms(lambda: engine.train_step(batch), iters=5, warmup=1)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    pairs = TRAIN_BATCH / (step_ms / 1e3)
    _log("train", f"{stage} train_step B={TRAIN_BATCH}: {step_ms:.3f} ms/step, "
                  f"{pairs:.2f} frame-pairs/s (CUDA events, batch upload included), "
                  f"peak {peak:.2f} GiB on {card}")
    _profile(f"{stage} train_step B={TRAIN_BATCH}", lambda: engine.train_step(batch), iters=2)
    record = {"steps": TRAIN_STEPS, "launches": launches, "epoch_loss": stats["mean_total_loss"],
              "fixed_batch_losses": losses, "epoch_frame_pairs_per_s": stats["frame_pairs_per_s"],
              "step_ms": step_ms, "frame_pairs_per_s": pairs, "peak_gib": peak}
    if debug_geo:
        record["debug_geo_max"] = max(debug_geo)
    if eval_data is not None:
        engine.eval_reader = eval_data
        tk.reset_launch_counts()
        ev = engine.evaluate()
        eval_launches = tk.launch_counts["bin_counts"]
        n_batches = -(-eval_data.num_samples() // TRAIN_BATCH)
        if eval_launches != 2 * n_batches:
            raise AssertionError(f"{stage} evaluate: {eval_launches} launches over "
                                 f"{n_batches} batches; expected 2 a batch")
        bad = [k for k, v in ev.items() if not np.isfinite(v)]
        if bad or ev["eval_samples"] != eval_data.num_samples():
            raise AssertionError(f"{stage} evaluate: {ev}")
        _log("train", f"{stage} evaluate: {int(ev['eval_samples'])} samples in {n_batches} "
                      f"batches, bin_counts launches {eval_launches}: "
                      + json.dumps(ev, sort_keys=True))
        record["launches"] += eval_launches
        record["eval_launches"] = eval_launches
    return record


def _train_step_vs_cpu(dev, stage, tcfg, batch, experts):
    """One train step at full width, dropout off, from the same weights: on
    the card and on the CPU in float32, and on the CPU in float64 as the
    reference.  Loss: card vs CPU rtol 1e-4.  Whitening statistics: rtol
    1e-4, atol 1e-6, counts equal.  Gradients: each tensor's relative L2
    error, card vs CPU, at most 5e-2.  At full width float32 itself is far
    from float64 on some tensors: a gradient sums 10^4-10^5 terms that
    largely cancel (the GroupNorm and conv-weight reductions), and the
    card's float32 gradients stray from the float64 ones by up to about 2 %
    of a tensor's max abs (relative L2 about 1 %), the CPU's by a few
    times less; the per-element bound of the CPU tests (1e-3 of the max)
    would fail float32 itself here.  Both distances from float64 are
    printed beside the check."""
    import torch

    from pointnav_vo_tpu_torch.vo.engine import VORegressionEngine
    from pointnav_vo_tpu_torch.vo.ensemble import VOInferenceConfig

    icfg = VOInferenceConfig(vis_size_h=H, vis_size_w=W, dropout_p=0.0)
    runs = {}
    for name, device, dtype in (("card", dev, torch.float32),
                                ("cpu", torch.device("cpu"), torch.float32),
                                ("cpu64", torch.device("cpu"), torch.float64)):
        engine = VORegressionEngine(icfg, tcfg, device=device,
                                    experts=[copy.deepcopy(m).to(dtype) for m in experts])
        loss = float(engine.train_step(batch)["total_loss"])
        runs[name] = (loss, engine.experts)
    (loss_card, card), (loss_cpu, cpu), (loss_64, cpu64) = runs.values()
    if abs(loss_card - loss_cpu) > 1e-4 * abs(loss_cpu):
        raise AssertionError(f"{stage}: card loss {loss_card} vs CPU {loss_cpu}")

    def errs(a, b):
        a, b = a.detach().cpu().double(), b.detach().cpu().double()
        return (float((a - b).norm() / b.norm().clamp(min=1e-30)),
                float((a - b).abs().max() / b.abs().max().clamp(min=1e-30)))

    worst = {"card_vs_cpu": [0.0, 0.0], "card_vs_fp64": [0.0, 0.0], "cpu_vs_fp64": [0.0, 0.0]}
    for mc, mh, m64 in zip(card, cpu, cpu64):
        for (name, pc), (_, ph), (_, p64) in zip(mc.named_parameters(), mh.named_parameters(),
                                                 m64.named_parameters()):
            for key, (a, b) in (("card_vs_cpu", (pc.grad, ph.grad)),
                                ("card_vs_fp64", (pc.grad, p64.grad)),
                                ("cpu_vs_fp64", (ph.grad, p64.grad))):
                e = errs(a, b)
                worst[key] = [max(w, x) for w, x in zip(worst[key], e)]
                if key == "card_vs_cpu" and e[0] > 5e-2:
                    raise AssertionError(f"{stage}: gradient of {name}: relative L2 error "
                                         f"{e[0]} card vs CPU")
        rc = mc.visual_encoder.running_mean_and_var
        rh = mh.visual_encoder.running_mean_and_var
        if not (torch.equal(rc._count.cpu(), rh._count)
                and torch.allclose(rc._mean.cpu(), rh._mean, rtol=1e-4, atol=1e-6)
                and torch.allclose(rc._var.cpu(), rh._var, rtol=1e-4, atol=1e-6)):
            raise AssertionError(f"{stage}: card and CPU whitening statistics differ")
    _log("train", f"{stage} card vs CPU train step, B={PARITY_BATCH}: loss {loss_card:.8f} "
                  f"(CPU {loss_cpu:.8f}, float64 {loss_64:.8f}); worst gradient error over "
                  "tensors [relative L2, max abs / max abs]: "
                  + json.dumps(worst) + "; whitening statistics agree")
    grads64 = [p.grad for m in cpu64 for p in m.parameters()]
    return {"loss": [loss_card, loss_cpu, loss_64], "worst_gradient_error": worst}, grads64


def _rel_l2(a, b):
    a, b = a.detach().cpu().double(), b.detach().cpu().double()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def _train_stage_bf16(dev, card, stage, engine, data):
    """bf16 mixed precision on one fixed batch: the loss over 8 steps under
    fixed dropout masks (it must fall), exactly 2 launches a step, the step's
    time, and every parameter and Adam moment still float32."""
    import torch

    from pointnav_vo_tpu_torch.ops import topdown_kernels as tk

    batch = next(data.iter_batches(TRAIN_BATCH))
    gen_state = engine.generator.get_state()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    tk.reset_launch_counts()
    losses = []
    for _ in range(TRAIN_STEPS + 1):
        engine.generator.set_state(gen_state)
        losses.append(float(engine.train_step(batch)["total_loss"]))
    launches = tk.launch_counts["bin_counts"]
    if launches != 2 * (TRAIN_STEPS + 1):
        raise AssertionError(f"{stage} bf16: {launches} bin_counts launches over "
                             f"{TRAIN_STEPS + 1} steps; expected 2 a step")
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"{stage} bf16: the fixed batch's loss did not fall: {losses}")
    params = [p for m in engine.experts for p in m.parameters()]
    moments = [t for st in engine.opt.state.values() for t in (st["exp_avg"], st["exp_avg_sq"])]
    if not (all(p.dtype == p.grad.dtype == torch.float32 for p in params)
            and len(moments) == 2 * len(params)
            and all(t.dtype == torch.float32 for t in moments)):
        raise AssertionError(f"{stage} bf16: parameters, gradients or Adam moments left float32")
    step_ms = _time_ms(lambda: engine.train_step(batch), iters=5, warmup=1)
    prof = _profile(f"{stage} bf16 train_step B={TRAIN_BATCH}", lambda: engine.train_step(batch),
                    iters=2)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    pairs = TRAIN_BATCH / (step_ms / 1e3)
    _log("train-bf16", f"{stage} fixed batch, loss before each of {TRAIN_STEPS + 1} steps: "
                       + " ".join(f"{x:.6f}" for x in losses) + f"; train_step B={TRAIN_BATCH} "
                       f"{step_ms:.3f} ms/step, {pairs:.2f} frame-pairs/s (CUDA events, batch "
                       f"upload included), peak {peak:.2f} GiB, bin_counts launches {launches}; "
                       f"{len(params)} parameters and {len(moments)} Adam moments float32 on "
                       f"{card}")
    return {"launches": launches, "fixed_batch_losses": losses, "step_ms": step_ms,
            "frame_pairs_per_s": pairs, "device_ms": prof["busy_ms"] if prof else None,
            "peak_gib": peak}


def _as_precision(experts, icfg):
    """Copies of ``experts`` built for ``icfg``'s precision."""
    out = [copy.deepcopy(m) for m in experts]
    for m in out:
        m.compute_dtype = icfg.model_dtype
    return out


def _train_step_bf16_vs_cpu(dev, stage, tcfg, batch, experts, grads64):
    """One bf16 train step at full width, dropout off, from the same weights
    and batch on the card and on the CPU, each side's gradients held against
    ``grads64``, the float64 step of :func:`_train_step_vs_cpu`.

    Each side's bf16 gradients stray from float64 by bf16's own rounding:
    cuDNN/cuBLAS and the CPU each accumulate a bf16 conv or product in
    float32 in their own order and round its output to bf16 once, so the
    two sides round apart, and the roundings compound through the backward
    of ResNet18.  A fault on one side (a wrong kernel, a scaled gradient)
    moves that side's distance from float64 and not the other's.  So the
    gates: loss card vs CPU rtol 2e-2; over all tensors together, the card's
    distance from float64 at most BF16_SIDE_RATIO x the CPU's (the two
    stray by the same amount), and card vs CPU at most BF16_GRAD_REL, about
    twice the reading of this step on the H100 (PERF.md); each tensor's
    card distance from float64 at most BF16_TENSOR_RATIO x the CPU's (a
    small tensor's distance is noisier than the sum's), or at most
    BF16_TENSOR_FLOOR."""
    import torch

    from pointnav_vo_tpu_torch.vo.engine import VORegressionEngine
    from pointnav_vo_tpu_torch.vo.ensemble import VOInferenceConfig

    icfg = VOInferenceConfig(vis_size_h=H, vis_size_w=W, dropout_p=0.0, precision="bf16")
    runs = {}
    for name, device in (("card", dev), ("cpu", "cpu")):
        engine = VORegressionEngine(icfg, tcfg, device=device,
                                    experts=_as_precision(experts, icfg))
        loss = float(engine.train_step(batch)["total_loss"])
        runs[name] = (loss, [p.grad for m in engine.experts for p in m.parameters()])
    (loss_card, card), (loss_cpu, cpu) = runs.values()

    def flat(grads):
        return torch.cat([g.flatten().cpu().double() for g in grads])

    ref = flat(grads64)
    total = {"card_vs_cpu": _rel_l2(flat(card), flat(cpu)),
             "card_vs_fp64": _rel_l2(flat(card), ref), "cpu_vs_fp64": _rel_l2(flat(cpu), ref)}
    tensors = [(_rel_l2(gc, g64), _rel_l2(gh, g64), _rel_l2(gc, gh))
               for gc, gh, g64 in zip(card, cpu, grads64, strict=True)]
    bad = [i for i, (dc, dh, _) in enumerate(tensors)
           if dc > max(BF16_TENSOR_RATIO * dh, BF16_TENSOR_FLOOR)]
    out = {"loss": [loss_card, loss_cpu], "gradients_rel_l2": total,
           "side_ratio": total["card_vs_fp64"] / max(total["cpu_vs_fp64"], 1e-30),
           "worst_tensor_side_ratio": max(dc / max(dh, 1e-30) for dc, dh, _ in tensors),
           "worst_tensor_card_vs_fp64": max(t[0] for t in tensors),
           "worst_tensor_cpu_vs_fp64": max(t[1] for t in tensors),
           "worst_tensor_card_vs_cpu": max(t[2] for t in tensors),
           "tensors_over_gate": len(bad)}
    _log("train-bf16", f"{stage} card vs CPU bf16 train step, B={PARITY_BATCH}, each beside "
                       f"the float64 step: loss {loss_card:.8f} (CPU {loss_cpu:.8f}; rtol "
                       f"2e-2); gradients relative L2 (gates: side ratio {BF16_SIDE_RATIO}, "
                       f"card vs CPU {BF16_GRAD_REL}, each tensor's side ratio "
                       f"{BF16_TENSOR_RATIO} or {BF16_TENSOR_FLOOR}): " + json.dumps(out))
    if abs(loss_card - loss_cpu) > 2e-2 * abs(loss_cpu):
        raise AssertionError(f"{stage} bf16: card loss {loss_card} vs CPU {loss_cpu}")
    if out["side_ratio"] > BF16_SIDE_RATIO or total["card_vs_cpu"] > BF16_GRAD_REL:
        raise AssertionError(f"{stage} bf16: gradients {total}")
    if bad:
        raise AssertionError(f"{stage} bf16: {len(bad)} gradients stray from float64 more on "
                             f"the card than {BF16_TENSOR_RATIO}x the CPU's: "
                             f"{[tensors[i] for i in bad]}")
    return out


def phase_train(dev, card):
    """VO training: the forward stage and the joint turn stage at full width."""
    import torch

    from pointnav_vo_tpu_torch.common import TURN_LEFT, TURN_RIGHT
    from pointnav_vo_tpu_torch.io.weights import seeded_init_
    from pointnav_vo_tpu_torch.rl.envs import EnvConfig
    from pointnav_vo_tpu_torch.vo.dataset import MemoryFramePairs
    from pointnav_vo_tpu_torch.vo.engine import VORegressionEngine, VOTrainConfig
    from pointnav_vo_tpu_torch.vo.ensemble import VOInferenceConfig

    t0 = time.perf_counter()
    env_cfg = EnvConfig(image_h=H, image_w=W)
    forward = MemoryFramePairs.scripted(TRAIN_STEPS * TRAIN_BATCH, lambda *_: 1, SEED + 10,
                                        env_cfg=env_cfg)
    fwd_eval = MemoryFramePairs.scripted(EVAL_PAIRS, lambda *_: 1, SEED + 11, env_cfg=env_cfg)
    turns = MemoryFramePairs.scripted(TRAIN_STEPS * TRAIN_BATCH // 2,
                                      lambda _env, _obs, r: r.integers(TURN_LEFT, TURN_RIGHT + 1),
                                      SEED + 12, twins=True, env_cfg=env_cfg)
    _log("train", f"scripted frame pairs at {W}x{H}: {forward.num_samples()} forward, "
                  f"{fwd_eval.num_samples()} forward to evaluate, {len(turns.entries)} turn "
                  f"entries as {turns.num_samples()} twin samples, in "
                  f"{time.perf_counter() - t0:.1f} s")

    icfg = VOInferenceConfig(vis_size_h=H, vis_size_w=W)
    g = torch.Generator().manual_seed(SEED + 3)
    experts = [seeded_init_(icfg.make_model(), g) for _ in range(3)]  # forward, left, right
    fwd_cfg = VOTrainConfig(batch_size=TRAIN_BATCH, action_type=1, lr=2.5e-4, seed=SEED)
    joint_cfg = VOTrainConfig(batch_size=TRAIN_BATCH, action_type=(TURN_LEFT, TURN_RIGHT),
                              geo_invariance_types=("inverse_joint_train",), lr=1.5e-4,
                              seed=SEED)
    records = {
        "forward": _train_stage(dev, card, "forward", VORegressionEngine(
            icfg, fwd_cfg, forward, device=dev,
            experts=[copy.deepcopy(experts[0])]), forward, fwd_eval),
        "joint": _train_stage(dev, card, "joint", VORegressionEngine(
            icfg, joint_cfg, turns, device=dev,
            experts=[copy.deepcopy(m) for m in experts[1:]]), turns, None),
    }
    if not next(turns.iter_batches(TRAIN_BATCH)).twins_packed:
        raise AssertionError("the joint stage's batches are not twin-packed")

    # bf16 mixed precision: the same stages, weights and data
    icfg16 = VOInferenceConfig(vis_size_h=H, vis_size_w=W, precision="bf16")
    for stage, tcfg, data, ex in (("forward", fwd_cfg, forward, experts[:1]),
                                  ("joint", joint_cfg, turns, experts[1:])):
        parity_cfg = dataclasses.replace(tcfg, batch_size=PARITY_BATCH)
        parity_batch = next(data.iter_batches(PARITY_BATCH))
        records[stage]["vs_cpu"], grads64 = _train_step_vs_cpu(dev, stage, parity_cfg,
                                                                parity_batch, ex)
        engine = VORegressionEngine(icfg16, tcfg, data, device=dev,
                                    experts=_as_precision(ex, icfg16))
        records[stage + "_bf16"] = _train_stage_bf16(dev, card, stage, engine, data)
        records[stage + "_bf16"]["vs_cpu"] = _train_step_bf16_vs_cpu(
            dev, stage, parity_cfg, parity_batch, ex, grads64)
    return records


def _rl_trainer(dev, num_steps, seed):
    """The RL config at full width with seeded weights: the depth policy,
    three det VO experts in the loop, 2 scripted envs."""
    import torch

    from pointnav_vo_tpu_torch.io.weights import seeded_init_
    from pointnav_vo_tpu_torch.models.policy import PointNavActorCritic
    from pointnav_vo_tpu_torch.rl.envs import EnvConfig, make_scripted_vector_env
    from pointnav_vo_tpu_torch.rl.ppo import PPOConfig
    from pointnav_vo_tpu_torch.rl.trainer import DDPPOTrainer
    from pointnav_vo_tpu_torch.vo.ensemble import VOEnsemble, VOInferenceConfig

    # configs/rl/ddppo_pointnav.yaml RL.PPO
    cfg = PPOConfig(clip_param=0.2, ppo_epoch=1, num_mini_batch=2, value_loss_coef=0.5,
                    entropy_coef=0.01, lr=1e-4, eps=1e-5, max_grad_norm=0.2,
                    num_steps=num_steps, use_gae=True, gamma=0.99, tau=0.95,
                    use_clipped_value_loss=True, use_normalized_advantage=False,
                    hidden_size=512)
    vo_cfg = VOInferenceConfig(vis_size_h=H, vis_size_w=W)
    g = torch.Generator().manual_seed(seed)
    vo = VOEnsemble(vo_cfg, experts=[seeded_init_(vo_cfg.make_model(), g) for _ in range(3)],
                    device=dev)
    envs = make_scripted_vector_env(EnvConfig(image_h=H, image_w=W), RL_ENVS, seed=seed)
    return DDPPOTrainer(model=PointNavActorCritic(image_size=(H, W)), ppo_cfg=cfg, envs=envs,
                        device=dev, init_generator=g,
                        generator=torch.Generator(device=dev).manual_seed(seed),
                        vo_ensemble=vo)


def _storage_bytes(rollouts):
    tensors = list(rollouts.observations.values()) + [
        getattr(rollouts, f) for f in ("hidden_states", "rewards", "value_preds", "returns",
                                       "action_log_probs", "actions", "prev_actions", "masks")]
    return sum(t.numel() * t.element_size() for t in tensors)


def _full_minibatch(rollouts, model):
    """All envs of a rollout with their advantages: one ppo_loss minibatch."""
    import torch

    from pointnav_vo_tpu_torch.rl.ppo import gather_env_slice

    idx = torch.arange(rollouts.num_envs, device=rollouts.masks.device)
    adv = rollouts.returns[:-1] - rollouts.value_preds[:-1]
    return gather_env_slice(rollouts, idx, model.observation_keys) + (adv[:, idx],)


def _with_returns(trainer):
    """The trainer's rollout with its GAE returns, as update_agent takes it."""
    from pointnav_vo_tpu_torch.rl.trainer import act_step

    next_value = act_step(trainer.model, trainer._last_obs, trainer.hidden,
                          trainer.prev_actions, trainer.masks)[0]
    cfg = trainer.cfg
    return trainer.rollouts.compute_returns(next_value, cfg.use_gae, cfg.gamma, cfg.tau)


def _rl_step_vs_cpu(dev, trainer):
    """One rollout step's pieces on the card and the CPU from the same
    inputs (step 0 -> 1 of the trainer's stored rollout): the mode action
    of the policy, the det VO delta of the cached step and the
    dead-reckoned goal.  Actions equal, the rest within rtol 1e-3 / atol
    1e-4."""
    import torch

    from pointnav_vo_tpu_torch.ops.geometry import pointgoal_polar2cartesian
    from pointnav_vo_tpu_torch.rl.trainer import act_step, propagate_goal
    from pointnav_vo_tpu_torch.vo.ensemble import VOEnsemble, frame_features_packed

    r = trainer.rollouts
    cpu = torch.device("cpu")
    actions_np = r.actions[0, :, 0].cpu().numpy()
    runs = {}
    for name, device, model, vo in (
            ("card", dev, trainer.model, trainer.vo),
            ("cpu", cpu, copy.deepcopy(trainer.model).to(cpu),
             VOEnsemble(trainer.vo.cfg, experts=[copy.deepcopy(m).to(cpu)
                                                 for m in trainer.vo.experts], device=cpu))):
        obs0 = {k: v[0].to(device) for k, v in r.observations.items()}
        obs1 = {k: v[1].to(device) for k, v in r.observations.items()}
        value, action, logp, hidden = act_step(model, obs0, r.hidden_states[0].to(device),
                                               r.prev_actions[0].to(device),
                                               r.masks[0].to(device))
        feats = frame_features_packed(obs0["rgb"], obs0["depth"], vo.cfg)
        delta, _ = vo.predict_step_cached(feats, obs1["rgb"], obs1["depth"], actions_np)
        goal, polar = propagate_goal(pointgoal_polar2cartesian(obs0["pointgoal_with_gps_compass"]),
                                     delta, 1.0 - r.masks[1].to(device),
                                     obs1["pointgoal_with_gps_compass"])
        runs[name] = {"value": value, "action": action, "logp": logp, "hidden": hidden,
                      "delta": delta, "goal_cart": goal, "polar": polar}
    errs = {}
    for k, w in runs["cpu"].items():
        g = runs["card"][k].cpu()
        errs[k] = float((g.double() - w.double()).abs().max())
        if k == "action":
            if not torch.equal(g, w):
                raise AssertionError("card and CPU rollout actions differ")
        elif not torch.allclose(g, w, rtol=1e-3, atol=1e-4):
            raise AssertionError(f"card vs CPU rollout step {k}: max abs err {errs[k]}")
    _log("rl", "card vs CPU rollout step (rtol 1e-3, atol 1e-4; actions equal): "
               + json.dumps(errs, sort_keys=True))
    return errs


def _rl_grad_vs_cpu(dev, trainer):
    """``ppo_loss`` and its gradients on the trainer's whole rollout (one
    minibatch of every env) on the card, on the CPU in float32 and on the
    CPU in float64 as the reference.  Loss: card vs CPU rtol 1e-4.  Each
    gradient's relative L2 error, card vs CPU, at most 5e-2, both devices'
    distance from float64 printed beside it (the gate of phase 6)."""
    import torch

    from pointnav_vo_tpu_torch.rl.ppo import ppo_loss

    rollouts = _with_returns(trainer)
    cfg = trainer.cfg
    runs = {}
    for name, device, dtype in (("card", dev, torch.float32),
                                ("cpu", torch.device("cpu"), torch.float32),
                                ("cpu64", torch.device("cpu"), torch.float64)):
        model = copy.deepcopy(trainer.model).to(device=device, dtype=dtype).train()
        model.zero_grad(set_to_none=True)
        total, _ = ppo_loss(model, cfg, _full_minibatch(rollouts.to(device, dtype), model),
                            cfg.clip_param)
        total.backward()
        runs[name] = (float(total.detach()), {k: p.grad for k, p in model.named_parameters()})
    (loss_card, card), (loss_cpu, cpu), (loss_64, cpu64) = runs.values()
    if abs(loss_card - loss_cpu) > 1e-4 * abs(loss_cpu):
        raise AssertionError(f"rl: card ppo_loss {loss_card} vs CPU {loss_cpu}")

    def errs(a, b):
        a, b = a.detach().cpu().double(), b.detach().cpu().double()
        return (float((a - b).norm() / b.norm().clamp(min=1e-30)),
                float((a - b).abs().max() / b.abs().max().clamp(min=1e-30)))

    worst = {"card_vs_cpu": [0.0, 0.0], "card_vs_fp64": [0.0, 0.0], "cpu_vs_fp64": [0.0, 0.0]}
    for name in card:
        for key, (a, b) in (("card_vs_cpu", (card[name], cpu[name])),
                            ("card_vs_fp64", (card[name], cpu64[name])),
                            ("cpu_vs_fp64", (cpu[name], cpu64[name]))):
            e = errs(a, b)
            worst[key] = [max(w, x) for w, x in zip(worst[key], e)]
            if key == "card_vs_cpu" and e[0] > 5e-2:
                raise AssertionError(f"rl: gradient of {name}: relative L2 error {e[0]} "
                                     "card vs CPU")
    _log("rl", f"card vs CPU ppo_loss gradient, T={rollouts.num_steps} N={rollouts.num_envs}: "
               f"loss {loss_card:.8f} (CPU {loss_cpu:.8f}, float64 {loss_64:.8f}); worst "
               "gradient error over tensors [relative L2, max abs / max abs]: "
               + json.dumps(worst))
    return {"loss": [loss_card, loss_cpu, loss_64], "worst_gradient_error": worst}


def phase_train_rl(dev, card):
    """Policy training with VO in the loop at full width."""
    import torch

    from pointnav_vo_tpu_torch.ops import topdown_kernels as tk
    from pointnav_vo_tpu_torch.rl.ppo import make_optimizer, ppo_loss, ppo_update

    trainer = _rl_trainer(dev, RL_STEPS, SEED + 20)
    storage_gib = _storage_bytes(trainer.rollouts) / 2**30
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    tk.reset_launch_counts()
    t0 = time.perf_counter()
    history = trainer.train(RL_UPDATES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = tk.launch_counts["bin_counts"]
    expected = RL_UPDATES * RL_STEPS + 1
    if launches != expected:
        raise AssertionError(f"rl: bin_counts launched {launches} times over {RL_UPDATES} "
                             f"updates of {RL_STEPS} steps; expected {expected}")
    bad = [h for h in history if not all(np.isfinite(v) for v in h.values())]
    if bad or trainer.count_steps != RL_UPDATES * RL_STEPS * RL_ENVS:
        raise AssertionError(f"rl: train gave {history}, {trainer.count_steps} env steps")
    timing = dict(trainer.timing)
    fps = trainer.count_steps / sum(timing.values())
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    _log("rl", f"train({RL_UPDATES}) over {RL_ENVS} envs, {RL_STEPS} steps a rollout: "
               f"wall {wall:.3f} s, {trainer.count_steps} env steps, {fps:.2f} env-steps/s "
               f"(count_steps / sum(timing)), timing {json.dumps(timing)}, bin_counts "
               f"launches {launches}, peak {peak:.2f} GiB (rollout storage {storage_gib:.3f} "
               f"GiB) on {card}; " + json.dumps(history))

    # steady state: one more rollout and update, each timed to its end
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.collect_rollout()
    torch.cuda.synchronize()
    rollout_step_ms = (time.perf_counter() - t0) * 1e3 / RL_STEPS
    t0 = time.perf_counter()
    trainer.update_agent()
    torch.cuda.synchronize()
    update_ms = (time.perf_counter() - t0) * 1e3
    _log("rl", f"rollout step {rollout_step_ms:.3f} ms (host clock over {RL_STEPS} steps, "
               f"env step and upload included), update_agent {update_ms:.3f} ms "
               f"({RL_STEPS * RL_ENVS} frames in {trainer.cfg.num_mini_batch} minibatches)")

    # the loss of one fixed rollout over successive updates on it
    trainer.collect_rollout()
    rollouts = _with_returns(trainer)
    model = copy.deepcopy(trainer.model).to(dev)  # .to: cuDNN's flat LSTM weights
    opt = make_optimizer(model.parameters(), trainer.cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def fixed_loss():
        with torch.no_grad():
            return float(ppo_loss(model, trainer.cfg, _full_minibatch(rollouts, model),
                                  trainer.cfg.clip_param)[0])

    losses = [fixed_loss()]
    for _ in range(RL_FIXED_UPDATES):
        ppo_update(model, trainer.cfg, opt, rollouts, generator=gen)
        losses.append(fixed_loss())
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"rl: the fixed rollout's loss did not fall: {losses}")
    _log("rl", f"fixed rollout, loss before and after each of {RL_FIXED_UPDATES} updates: "
               + " ".join(f"{x:.6f}" for x in losses))

    # card vs CPU on a short rollout, then the per-step profile on it
    short = _rl_trainer(dev, RL_PARITY_STEPS, SEED + 21)
    short.collect_rollout()
    step_errs = _rl_step_vs_cpu(dev, short)
    grad = _rl_grad_vs_cpu(dev, short)
    prof_rollout = _profile(f"collect_rollout of {RL_PARITY_STEPS} steps at {RL_ENVS} envs",
                            short.collect_rollout, iters=1)
    prof_update = _profile(f"update_agent, {RL_STEPS} steps x {RL_ENVS} envs",
                           trainer.update_agent, iters=1)
    per_step = ({"busy_ms": prof_rollout["busy_ms"] / RL_PARITY_STEPS,
                 "wall_ms": prof_rollout["wall_ms"] / RL_PARITY_STEPS,
                 "idle": prof_rollout["idle"],
                 "launches": prof_rollout["launches"] / RL_PARITY_STEPS}
                if prof_rollout else None)
    return {"updates": RL_UPDATES, "steps": RL_STEPS, "envs": RL_ENVS, "launches": launches,
            "expected_launches": expected, "history": history, "timing": timing,
            "env_steps_per_s": fps, "wall_s": wall, "rollout_step_ms": rollout_step_ms,
            "update_ms": update_ms, "peak_gib": peak, "storage_gib": storage_gib,
            "fixed_rollout_losses": losses, "step_vs_cpu": step_errs, "grad_vs_cpu": grad,
            "profile_rollout_step": per_step, "profile_update": prof_update}


def _cli(argv):
    """One run of the port's CLI on the card, its wall time and its
    bin_counts launches."""
    import torch

    from pointnav_vo_tpu_torch import run
    from pointnav_vo_tpu_torch.ops import topdown_kernels as tk

    torch.cuda.synchronize()
    tk.reset_launch_counts()
    t0 = time.perf_counter()
    out = run.main(argv)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, tk.launch_counts["bin_counts"]


def _save_times(trainer, root):
    """Seconds to write the trainer's checkpoint state (device tensors,
    copied to the host in the call): synchronously, and through the async
    writer (the train loop's call, then until it is on disk)."""
    from pointnav_vo_tpu_torch.io.checkpoint import AsyncCheckpointWriter, save_checkpoint

    t0 = time.perf_counter()
    save_checkpoint(os.path.join(root, "sync.pth"), trainer.checkpoint_state())
    sync_s = time.perf_counter() - t0
    with AsyncCheckpointWriter() as w:
        t0 = time.perf_counter()
        w.save(os.path.join(root, "async.pth"), trainer.checkpoint_state())
        call_s = time.perf_counter() - t0
        w.wait()
        async_s = time.perf_counter() - t0
    return {"sync_s": sync_s, "async_call_s": call_s, "async_durable_s": async_s}


def phase_cli(dev, card):
    """The port's CLI on configs/rl/ddppo_pointnav.yaml at full width:
    train with a checkpoint every update, sweep-eval the checkpoint folder,
    resume from the last checkpoint, and a preempted run."""
    import shutil
    import tempfile

    from pointnav_vo_tpu_torch.io.checkpoint import load_checkpoint
    from pointnav_vo_tpu_torch.ops import topdown_kernels as tk
    from pointnav_vo_tpu_torch.rl.envs import VectorEnv
    from pointnav_vo_tpu_torch.rl.eval import Evaluator
    from pointnav_vo_tpu_torch.utils import preemption

    root = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    base = ["--task-type", "rl", "--exp-config", RL_CONFIG, "--log-root", root,
            "--device", str(dev)]
    # seeded experts: the published .pth files are not in the repo
    opts = ["VO.REGRESS_MODEL.pretrained", "False", "CHECKPOINT_INTERVAL", "1",
            "LOG_INTERVAL", "1"]
    try:
        # 1. train
        trainer, wall, launches = _cli(["--run-type", "train", *base, *opts,
                                        "NUM_UPDATES", str(CLI_UPDATES)])
        expected = CLI_UPDATES * RL_STEPS + 1
        ckpt_dir = os.path.join(glob.glob(os.path.join(root, "rl-train-*"))[0], "checkpoints")
        ckpts = sorted(os.listdir(ckpt_dir))
        if launches != expected or len(ckpts) != CLI_UPDATES:
            raise AssertionError(f"cli train: {launches} bin_counts launches (expected "
                                 f"{expected}), checkpoints {ckpts}")
        steps = trainer.count_steps
        train = {"wall_s": wall, "launches": launches, "env_steps": steps,
                 "env_steps_per_s": steps / sum(trainer.timing.values()),
                 "env_steps_per_wall_s": steps / wall, "checkpoints": ckpts,
                 "checkpoint_bytes": os.path.getsize(os.path.join(ckpt_dir, ckpts[-1])),
                 "save": _save_times(trainer, root)}
        _log("cli", f"train {CLI_UPDATES} updates x {RL_STEPS} steps x {RL_ENVS} envs: wall "
                    f"{wall:.3f} s (engine, envs and models built inside), "
                    f"{train['env_steps_per_s']:.2f} env-steps/s (count_steps / sum(timing)), "
                    f"{train['env_steps_per_wall_s']:.2f} by wall, bin_counts launches "
                    f"{launches}; checkpoints {ckpts}, {train['checkpoint_bytes']} B each; "
                    f"save {json.dumps(train['save'])} on {card}")

        # 2. eval the folder as a sweep: per checkpoint, exactly steps + 1 launches
        runs = []
        real_run, real_step = Evaluator.run, VectorEnv.step
        step_calls = [0]

        def counted_step(self, actions):
            step_calls[0] += 1
            return real_step(self, actions)

        def counted_run(self, num_episodes):
            before, calls = tk.launch_counts["bin_counts"], step_calls[0]
            out = real_run(self, num_episodes)
            runs.append((tk.launch_counts["bin_counts"] - before, step_calls[0] - calls, out))
            return out

        Evaluator.run, VectorEnv.step = counted_run, counted_step
        try:
            results, wall, launches = _cli(
                ["--run-type", "eval", *base, *opts, "EVAL.EVAL_CKPT_PATH", ckpt_dir,
                 "EVAL.TEST_EPISODE_COUNT", str(CLI_EVAL_EPISODES),
                 "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", str(CLI_EVAL_CAP)])
        finally:
            Evaluator.run, VectorEnv.step = real_run, real_step
        if sorted(results) != ckpts or len(runs) != len(ckpts):
            raise AssertionError(f"cli eval: evaluated {sorted(results)} of {ckpts}")
        for n_launch, n_steps, metrics in runs:
            if n_launch != n_steps + 1 or metrics["episodes"] != CLI_EVAL_EPISODES:
                raise AssertionError(f"cli eval: {n_launch} launches over {n_steps} steps "
                                     f"(expected steps + 1), {metrics['episodes']} episodes")
            bad = [k for k, v in metrics.items() if not np.isfinite(v)]
            if bad:
                raise AssertionError(f"cli eval: non-finite metrics {bad}")
        evaluation = {"wall_s": wall, "launches": launches,
                      "steps": [r[1] for r in runs], "metrics": results}
        _log("cli", f"eval sweep over {len(ckpts)} checkpoints, {CLI_EVAL_EPISODES} episodes "
                    f"each, cap {CLI_EVAL_CAP} steps: wall {wall:.3f} s, loop steps "
                    f"{evaluation['steps']}, bin_counts launches {launches}; "
                    + json.dumps(results, sort_keys=True))

        # 3. resume from the last checkpoint: restart at its stored update
        last = os.path.join(ckpt_dir, ckpts[-1])
        saved = load_checkpoint(last)
        resumed, wall, launches = _cli(
            ["--run-type", "train", *base, *opts, "NUM_UPDATES", str(CLI_RESUME_UPDATES),
             "RESUME_TRAIN", "True", "RESUME_STATE_FILE", last])
        runs_again = CLI_RESUME_UPDATES - saved["update"]
        want_steps = saved["count_steps"] + runs_again * RL_STEPS * RL_ENVS
        if (resumed.update_idx != CLI_RESUME_UPDATES or resumed.count_steps != want_steps
                or launches != runs_again * RL_STEPS + 1):
            raise AssertionError(f"cli resume: update {resumed.update_idx}, "
                                 f"{resumed.count_steps} env steps (expected {want_steps}), "
                                 f"{launches} launches")
        resume = {"wall_s": wall, "launches": launches, "from_update": saved["update"],
                  "count_steps": resumed.count_steps}
        _log("cli", f"resume from {ckpts[-1]} (update {saved['update']}, {saved['count_steps']} "
                    f"env steps) to update {CLI_RESUME_UPDATES}: wall {wall:.3f} s, "
                    f"{resumed.count_steps} env steps, bin_counts launches {launches}")

        # 4. preempted before its first update: the interrupted state, then return
        preemption.INTERRUPTED_STATE_DIR = os.path.join(root, "interrupted")
        preemption.EXIT.set()
        try:
            stopped, wall, launches = _cli(["--run-type", "train", *base, *opts,
                                            "NUM_UPDATES", str(CLI_UPDATES)])
        finally:
            preemption.reset_for_tests()
        state = load_checkpoint(preemption.interrupted_state_path())
        if state["update"] != 0 or stopped.update_idx != 0 or launches != 0:
            raise AssertionError(f"cli preemption: state at update {state['update']}, "
                                 f"trainer at {stopped.update_idx}, {launches} launches")
        _log("cli", f"preempted run: interrupted state at update 0 written, returned in "
                    f"{wall:.3f} s")
        return {"train": train, "eval": evaluation, "resume": resume,
                "preempt_wall_s": wall}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_agent(dev, card):
    """One full-width episode of PointNavVOAgent (det, seeded weights, the
    STOP logit lowered so the episode runs to its cap and the logit of the
    act AGENT_PLAN names raised before each act, so all three experts run)
    on a scripted env, held step by step against the same agent on the CPU."""
    import torch

    from pointnav_vo_tpu_torch.deploy.challenge_agent import PointNavVOAgent
    from pointnav_vo_tpu_torch.ops import geometry as geo
    from pointnav_vo_tpu_torch.ops import topdown_kernels as tk
    from pointnav_vo_tpu_torch.rl.envs import EnvConfig, ScriptedPointNavEnv
    from pointnav_vo_tpu_torch.vo.ensemble import VOInferenceConfig

    cfg = VOInferenceConfig(vis_size_h=H, vis_size_w=W)
    vo, policy, cpu_vo, cpu_policy = _build_models(cfg, dev, SEED + 30)

    def plan_bias(i):
        bias = torch.tensor([AGENT_STOP_BIAS, 0.0, 0.0, 0.0])
        bias[AGENT_PLAN[i % len(AGENT_PLAN)]] += AGENT_FAVOUR
        for p in (policy, cpu_policy):
            with torch.no_grad():
                p.action_distribution.linear.bias.copy_(bias)

    goal = "pointgoal_with_gps_compass"
    card_agent = PointNavVOAgent(policy_model=policy, vo_ensemble=vo, goal_sensor=goal,
                                 device=dev)
    cpu_agent = PointNavVOAgent(policy_model=cpu_policy, vo_ensemble=cpu_vo, goal_sensor=goal,
                                device="cpu")
    env = ScriptedPointNavEnv(EnvConfig(image_h=H, image_w=W, max_episode_steps=AGENT_CAP),
                              seed=SEED + 30)
    obs, done, info = env.reset(), False, {}
    actions, act_ms, goal_err, launches = [], [], 0.0, 0
    tk.reset_launch_counts()
    while not done:
        plan_bias(len(actions))
        before = tk.launch_counts["bin_counts"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a = card_agent.act(obs)["action"]
        torch.cuda.synchronize()
        act_ms.append((time.perf_counter() - t0) * 1e3)
        launches += tk.launch_counts["bin_counts"] - before  # the card agent's acts only
        want = cpu_agent.act(obs)["action"]
        if a != want:
            raise AssertionError(f"agent step {len(actions)}: card action {a}, CPU {want}")
        got_goal, want_goal = card_agent.goal_cartesian, cpu_agent.goal_cartesian
        if not np.allclose(got_goal, want_goal, rtol=1e-3, atol=1e-4):
            raise AssertionError(f"agent step {len(actions)}: card goal {got_goal}, "
                                 f"CPU {want_goal}")
        goal_err = max(goal_err, float(np.abs(got_goal - want_goal).max()))
        # the true egocentric goal of the frame the agent acted on
        true_goal = geo.pointgoal_polar2cartesian(torch.as_tensor(
            obs["pointgoal_with_gps_compass"][None], dtype=torch.float32))[0].numpy()
        actions.append(a)
        obs, _r, done, info = env.step(a)
    n = len(actions)
    if n < 3 or launches != n:
        raise AssertionError(f"agent: {launches} bin_counts launches over {n} acts "
                             "(expected one an act after the first, one more on the first "
                             "VO step)")
    # the expert of an act runs on the next one: every act but the last
    ran = {name: actions[:-1].count(a) for name, a in (("forward", 1), ("left", 2),
                                                       ("right", 3))}
    if min(ran.values()) == 0:
        raise AssertionError(f"agent: an expert never ran ({ran}); actions {actions}")
    end_drift = {"card_vs_cpu": float(np.abs(got_goal - want_goal).max()),
                 "card_vs_true_goal": float(np.linalg.norm(got_goal - true_goal)),
                 "cpu_vs_true_goal": float(np.linalg.norm(want_goal - true_goal))}
    steady = act_ms[2:]
    out = {"acts": n, "launches": launches, "actions": actions, "experts_ran": ran,
           "act_ms_mean": float(np.mean(steady)), "act_ms_median": float(np.median(steady)),
           "first_act_ms": act_ms[:2], "goal_max_abs_err": goal_err, "end_drift": end_drift,
           "success": info.get("success"), "spl": info.get("spl")}
    _log("agent", f"{n} acts at {W}x{H}: per act {out['act_ms_mean']:.3f} ms mean, "
                  f"{out['act_ms_median']:.3f} ms median (host clock, synchronized, acts 3 on; "
                  f"first two {act_ms[0]:.3f}, {act_ms[1]:.3f} ms), bin_counts launches "
                  f"{launches}, actions equal to the CPU agent's, goal max abs err "
                  f"{goal_err:.3g} (rtol 1e-3, atol 1e-4) on {card}; experts run "
                  f"{json.dumps(ran)}; goal drift at the episode's end (m) "
                  f"{json.dumps(end_drift)}; actions {actions}")
    return out


def phase_eval_994(dev, card):
    """The 994-episode protocol's script at a smoke size: bf16 experts
    trained in memory, then an exact set of distinct episodes with
    ``bin_counts`` launched exactly once per step plus one (checked by
    ``run_protocol``)."""
    import torch

    from pointnav_vo_tpu_torch.examples import eval_994
    from pointnav_vo_tpu_torch.ops import topdown_kernels as tk
    from pointnav_vo_tpu_torch.rl.envs import EnvConfig
    from pointnav_vo_tpu_torch.vo.ensemble import VOEnsemble, VOInferenceConfig

    env_cfg = EnvConfig(image_h=H, image_w=W, max_episode_steps=E994_CAP,
                        actuation_noise_multiplier=0.5)
    icfg = VOInferenceConfig(vis_size_h=H, vis_size_w=W, precision="bf16")
    torch.cuda.synchronize()
    tk.reset_launch_counts()
    t0 = time.perf_counter()
    experts, train = eval_994.train_experts(icfg, env_cfg, E994_PAIRS, E994_EVAL_PAIRS,
                                            E994_EPOCHS, TRAIN_BATCH, dev,
                                            log=lambda m: _log("994", m))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = tk.launch_counts["bin_counts"]
    run = eval_994.run_protocol(VOEnsemble(icfg, experts=experts, device=dev), env_cfg,
                                E994_EPISODES, N_ENVS, dev)
    agg = run["metrics"]
    if not all(np.isfinite(v) for v in agg.values()):
        raise AssertionError(f"994 smoke: non-finite metrics {agg}")
    _log("994", f"trained 3 bf16 experts in {train_s:.1f} s (bin_counts launches "
                f"{train_launches}); Evaluator.run of {E994_EPISODES} episodes over {N_ENVS} "
                f"envs (cap {E994_CAP}): wall {run['wall_s']:.3f} s, {run['loop_steps']} loop "
                f"steps, {run['distinct_episodes']} distinct episodes, bin_counts launches "
                f"{run['bin_counts_launches']} (steps + 1), success {agg['success']:.3f}, spl "
                f"{agg['spl']:.3f}, vo_l2 {agg.get('vo_l2_mean', float('nan')):.4f}, "
                f"time_env_s {agg['time_env_s']:.3f}, time_device_s "
                f"{agg['time_device_s']:.3f} on {card}")
    return {"train_s": train_s, "train_launches": train_launches, "train": train,
            **{k: v for k, v in run.items()}}


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

    phase_s = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t0
        _log("time", f"{name}: {phase_s[name]:.1f} s")
        return out

    card = timed("build", phase_build)
    max_err, timings = timed("kernel", phase_kernel, dev)
    launches, step_ms, wall, loop_steps = timed("main", phase_main_path, dev)
    main_bf16 = timed("main_bf16", phase_main_path_bf16, dev, card)
    rnd_launches, _rnd_ms = timed("rnd", phase_rnd_eval, dev)
    steady = timed("steady", phase_steady_vo, dev, card)
    train = timed("train", phase_train, dev, card)
    rl = timed("train_rl", phase_train_rl, dev, card)
    cli = timed("cli", phase_cli, dev, card)
    agent = timed("agent", phase_agent, dev, card)
    e994 = timed("eval_994", phase_eval_994, dev, card)
    by_path = {"det_eval": launches["bin_counts"], "det_eval_bf16": main_bf16["launches"],
               "rnd_eval": rnd_launches,
               "train_forward": train["forward"]["launches"],
               "train_joint": train["joint"]["launches"],
               "train_forward_bf16": train["forward_bf16"]["launches"],
               "train_joint_bf16": train["joint_bf16"]["launches"], "train_rl": rl["launches"],
               "cli_train_rl": cli["train"]["launches"], "cli_eval": cli["eval"]["launches"],
               "cli_resume": cli["resume"]["launches"], "agent": agent["launches"],
               "eval_994_train": e994["train_launches"],
               "eval_994": e994["bin_counts_launches"]}

    t32 = timings[N_ENVS]  # the main path's batch
    record = {"kernels": [{
        "name": "bin_counts",
        "route": "cuda",
        "source": "pointnav_vo_tpu_torch/csrc/bin_counts.cu",
        "replaces": "pointnav_vo_tpu/ops/topdown_pallas.py:81",
        "launches": sum(by_path.values()),
        "launches_by_path": by_path,
        "max_abs_err": max_err,
        "ms": t32["device_ms"],
        "plain_ms": t32["plain_ms"],
        "bound_ms": t32["bound_ms"],
        "bound_by": "bytes",
        "library_ms": t32["library_ms"],
        "device_ms": t32["device_ms"],
        "call_ms": t32["call_ms"],
        "batches": {str(b): {k: v for k, v in t.items() if k != "turns"}
                    for b, t in timings.items()},
        "turns": {str(b): t["turns"] for b, t in timings.items()},
        "main_bf16": main_bf16,
        "steady": steady,
        "train": train,
        "train_rl": rl,
        "cli": cli,
        "agent": agent,
        "eval_994": e994,
        "phase_s": phase_s,
    }]}
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
