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
5. steady-state VO: ``VOEnsemble.step`` at batch 512 with a
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
   False``), a checkpoint every update: train 1 update (exactly 128 + 1
   launches, one checkpoint); eval the checkpoint folder as a sweep (2
   episodes each under a 20-step cap, exactly steps + 1 launches per
   checkpoint); resume from the last checkpoint to update 1 (it restarts
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
   then ``Evaluator.run`` of 32 distinct episodes over the shm env farm
   (32 worker processes) with the greedy goal policy (a 30-step cap),
   ``bin_counts`` launched exactly once per step plus one;
11. the evaluator's host side at full width (phase 3's seeded fp32 models,
   32 envs, a 10-step cap): the host's CPU count and affinity, its
   ``/dev/shm`` size and the rings' bytes; (a) ``Evaluator.run`` in
   process, over ``ShmVectorEnv`` (32 forked workers, made after the card
   is in use) and over it with ``PNVO_EVAL_ASYNC=1``: the farm runs'
   aggregates and per-episode results equal the in-process run's (bit for
   bit but the payload's float32 ``spl``/``softspl``/``distance_to_goal``,
   equal after rounding, and the episode id it does not carry), steps + 1
   launches each, every worker exits 0, none of the farm's own
   ``/dev/shm`` segments left, ``time_env_s`` of the three side by side,
   and the in-process run again beside an idle 32-worker farm (its workers
   polling their rings), equal results, its ``time_device_s`` beside the
   others; (b) GPS-only (``vo_ensemble=None``): finite metrics, no launch; (c) unfused
   (``fused=False``): the fused run's trajectories, exactly 2 launches a
   step, one unfused step within rtol 1e-3 / atol 1e-4 of the fused step
   and of the CPU's (actions equal); (d) eval videos and ranked images
   composed on the card's run, written with ``cv2`` where the machine has
   it (else a line says the writers are held on the CPU only);
12. the VO model zoo at full width (fp32, TF32 off, seeded weights):
   (a) each of the seven backbones in the paper model's encoder: one det
   forward at B=8 on scripted frames held against the CPU (rtol 1e-3,
   atol 1e-4), exactly 2 ``bin_counts`` launches (the two frame batches),
   the device time of a no-grad B=128 forward and its peak memory; (b)
   every name of ``VO_MODEL_NAMES`` with its own observation space, the
   act-embed ones with the action ids: the same check, 2 launches for
   each of the five top-down variants and none for the other seven; (c)
   ``vo_cnn_act_embed`` with ``action_type: -1`` at batch 128 over a
   70/15/15 action mix: a fixed batch's loss over 8 steps (it must fall),
   the step's time, and one B=8 step against the CPU under phase 6's
   gates, beside a float64 step; (d) ``vo_cnn_deeper`` (ResNet-101) in the
   forward stage at batch 128: the same, with the float64 distances of
   both sides; (e) phase 3's fused det eval built through ``engines.py``
   from a config with ResNet-50 VO experts, a ResNet-50 policy and
   ``VO.OBS_TRANSFORM resize_crop`` over 256x256 renders: steps + 1
   launches, one step held against the CPU (actions equal);
13. the policy family and the classical VO backend at full width (fp32,
   TF32 off, seeded weights): (a) the rgb-d ResNet18 + 2-layer LSTM
   policy with whitening through the train CLI (2 updates of 128 steps
   over 2 envs, det VO in the loop): exactly 257 launches, the whitening
   buffers' count exactly envs x steps x updates, one rollout step (the
   buffers folded) held against the CPU, a fixed rollout's loss over 4
   updates (it must fall); (b) the depth ResNet18 policy with a 2-layer
   GRU in phase 3's det eval (steps + 1 launches, one fused step against
   the CPU) and one ``ppo_loss`` gradient against the CPU (phase 7's
   gate); (c) the SimpleCNN + GRU baseline through the CLI: train (257
   launches, a rollout step against the CPU), eval from its checkpoint
   (steps + 1), its fused step against the CPU, and phase 9's agent
   episode with it; (d) phase 3's eval with ``VO.VO_TYPE CLASSICAL``
   through ``engines.py``: no launch, the share of env steps whose ORB
   match was accepted, host ms a step, and the batched weighted Kabsch
   over 32 envs of 8-500 synthetic matched points held against the CPU
   (rtol 1e-4, atol 1e-5) and timed. Each path's step or update ms (CUDA
   events) and peak memory;
14. data-parallel on the one card: 2 ranks spawned by
   ``parallel/dist.py::spawn`` (the spawn start method: this process holds
   a CUDA context) share it over gloo, each checked in its own process and
   reported back: (a) the RL train CLI (``run.run_exp`` as one rank of the
   group) on ``configs/rl/ddppo_pointnav.yaml`` at full width with 4 envs
   (2 a rank, one a minibatch) for 2 updates: exactly 2 x 128 + 1
   launches a rank, the parameters bit-equal to rank 0's after each
   update, two checkpoints written once (by rank 0), the rollout-step and
   update ms of each rank and the all-reduce ms of each update with its
   share (synchronized before and after each call); (b) the first update
   again on one rank over both ranks' stored rollouts in the union of
   their minibatch orders (global env indices): each minibatch's mean
   gradients within relative L2 1e-3, the parameters within 2 lr a step
   (within 1e-6 where every step's gradient exceeds 1e-2 of its tensor's
   max), the loss terms rtol 1e-4; the ranks run with deterministic cuDNN,
   and the one-rank replay runs twice more with it (bit-equal) and twice
   with cuDNN's default algorithms (the gradient tensors that change are
   printed); (c) the VO joint stage at a global batch
   of 128 (64 a rank) for 8 steps on in-memory turn pairs: 2 launches a
   step a rank, parameters, Adam moments and whitening bit-equal across
   ranks, frame-pairs/s of the whole, and one step (dropout off) against
   one rank's step on a batch whose halves hold every loss group equally
   (loss rtol 1e-4, gradients relative L2 1e-3, whitening rtol 1e-5, the
   parameters as (b)); (d) phase 3's det eval over 16 envs a rank: the
   one-rank run's exact episode set in its order, per-episode records and
   aggregates within rtol 1e-4 / atol 1e-5, steps + 1 launches a rank;
15. the VO training diagnostics and dataset generation (full width,
   seeded experts, TF32 off): (a) the joint stage at batch 128 for 8 steps
   with ``log_grad`` and ``debug`` off and 8 with both on, on the same
   batches: step ms of each (CUDA events), every ``grad/*`` metric present
   and finite, exactly 2 launches a step either way, 2 more for
   ``grad_snapshot`` and 2 for ``obs_snapshot``; one step at batch 8 on
   the card and on the CPU: each ``grad/*`` norm within rtol 1e-3, the
   snapshot's tensors within phase 6's relative L2 of 5e-2, and each
   top-level module's (and backbone stage's) relative L2 from the float64
   step printed for both sides; then the card's float32 gradient fault run
   down (``_grad_fault_by_op``, TF32 off): the B=8 step's stem, layer1 and
   layer2 gradients from float64 on the same device, on the card under
   cuDNN's default algorithms, ``deterministic``, ``benchmark`` and
   cuDNN off, and on the CPU; each op of those stages (conv, GroupNorm,
   ReLU, max-pool, residual add) alone, forward and backward, float32
   against float64 on the same rounded inputs and upstream gradient, under
   each setting and on the CPU; and the B=128 joint step's ms under each
   setting; (b) ``debug``: a batch with one NaN
   ``gt_delta`` raises, and the parameters, whitening statistics and Adam
   moments stay ``torch.equal`` to before; (c) 256 entries of the
   generator's rollout (``iter_rollout_entries``, no ``h5py``) from
   640x360 renders with ``resize_crop`` to 341x192 on the card: entries/s
   and what it means for the reference's 1M train pairs, each image within
   the CPU tests' bounds of the CPU transform of the same observation;
   (d) 500 oracle steps' deltas with VO-sized noise dead-reckoned through
   ``propagate_goal`` in float32 on the card and on the CPU and in numpy
   float64: the final goal error of each, card against CPU within 1e-4 m;
16. the paper's pipelines (``pointnav_vo_tpu_torch/examples/``): (a) the
   ResNet18 + 2-layer LSTM-512 policy with ``compute_dtype=torch.bfloat16``
   at full width (TF32 off) beside the same weights in fp32: at the
   ladder's training shape (16 envs, 64 steps, 2 epochs of 2 minibatches,
   the VO in the loop) the rollout step's and the update's ms in each
   precision (CUDA events); over 2 envs and 8 steps, one act step and the
   ``ppo_loss`` gradient over a stored rollout, card bf16 against CPU bf16
   and against card fp32 (logits, value and hidden within phase 3's
   relative L2 of 5e-2, actions equal where the fp32 logit margin exceeds
   0.05; all the gradients within relative L2 6.5e-2 of the CPU's bf16,
   from the card's fp32 at most 1.5x the CPU's own bf16-to-fp32 distance
   and farther from it than the card's fp32 is from the CPU's), and one
   whole update leaving the parameters and Adam moments float32; the whole
   phase runs with deterministic cuDNN; (b) the
   994-episode ladder (``eval_994_ladder.py``) at a smoke size over the shm
   farm: every row with exactly its episode count of distinct episodes and
   exactly steps + 1 launches (none for ``oracle_gps``), the tune stage's
   updates x steps + 1, then a run stopped in the tune stage and relaunched
   from its ``.part`` (the GPS stage skipped) ending on the uninterrupted
   run's parameters bit for bit, under deterministic cuDNN; (c)
   ``rl_tune_with_vo`` at 64x64, ``end_to_end_scripted``,
   ``train_rl_scripted``, ``train_vo_scripted`` and ``vis_trajectory`` (2
   episodes through a 3-expert checkpoint the phase writes) at smoke sizes:
   records and PNGs written, metrics finite.  Every run of (a)-(c) launches
   ``bin_counts`` exactly as often as its work needs (2 a VO train or eval
   step or two-frame call, loop steps + 1 an eval with VO, rollout steps +
   1 a trainer with VO);
17. the measurement scripts and the checkpoint tools: (a)
   ``examples/full_eval_benchmark.py`` at 32 envs (bf16, every weight
   0.01), FEB_STEPS loop steps and the chained step, its lines printed,
   ``bin_counts`` launched exactly 1 + steps + 8 x chained calls; and one
   loop step with seeded bf16 weights on the card and on the CPU: deltas
   and logits within phase 3's relative L2 of 5e-2, the policy's actions
   equal where the fp32 top-two logit gap exceeds 0.05, env actions equal,
   goals within rtol 1e-5; (b) ``examples/profile_vo_step.py`` at B=512
   (bf16, 8 iterations): each stage's ms (CUDA events) and device ms
   (torch.profiler), every output finite, the kernel's top-down view
   ``torch.equal`` to the plain version's, launches exact; (c)
   ``tools/export_to_reference.py``: a forward-stage and a joint-stage VO
   checkpoint and an RL checkpoint written on the card, exported, read
   back by ``VOEnsemble.from_torch_checkpoints`` and
   ``load_policy_checkpoint``, forwards bit-equal to the originals'; (d)
   ``tools/verify_reference_ckpts.py`` on those files with ``--device
   cuda`` and on the CPU: both PASS, ``delta_sample0``/``logits_sample0``
   within rtol 1e-3 / atol 1e-4.

Each phase's wall time is printed after it (``[time]``).

The second-to-last lines are the kernels' JSON record and the card's
``nvidia-smi`` name/power line; the last line is the run's JSON verdict.
Exits non-zero, printing no verdict, where no CUDA card is present.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import glob
import json
import os
import subprocess
import sys
import tempfile
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
CLI_UPDATES = 1  # phase 8: NUM_UPDATES of the train run (2 before phase 14 took the time)
CLI_RESUME_UPDATES = 1
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
FARM_CAP = 10  # phase 11: the episode cap (half phase 3's: the script's time)
FARM_SLOTS = 4  # payloads a worker's ring holds (ShmVectorEnv's default)
ZOO_PARITY_BATCH = 8  # phase 12: card-vs-CPU forwards and the train steps held against float64
ZOO_TIME_BATCH = 128  # phase 12 (a): the timed no-grad forward
ZOO_SENSOR = 256  # phase 12 (e): the envs' render size, resized by VO.OBS_TRANSFORM
POLICY_UPDATES = 2  # phase 13 (a), (c): NUM_UPDATES of the train runs
KABSCH_ENVS = 32  # phase 13 (d): the batched Kabsch's envs, 8-500 matched points each
KABSCH_POINTS = (8, 500)
DIST_RANKS = 2  # phase 14: ranks sharing the one card
DIST_RL_ENVS = 4  # phase 14 (a): NUM_PROCESSES, 2 envs a rank, one a minibatch
DIST_VO_ENTRIES = 128  # phase 14 (c): turn entries, 2 twin-packed batches an epoch
DIST_VO_EPOCHS = 4  # phase 14 (c): 8 steps
DIAG_ENTRIES = 256  # phase 15 (a): turn entries, 4 twin-packed batches of 64 (128 samples)
DIAG_STEPS = 8  # phase 15 (a): steps with the diagnostics on, and with them off
DIAG_NORM_RTOL = 1e-3  # phase 15 (a): each grad/* norm, card against CPU
# phase 15 (a): the cuDNN settings the float32 gradient fault is run down under
CUDNN_SETTINGS = (("default", {}), ("deterministic", {"deterministic": True}),
                  ("benchmark", {"benchmark": True}), ("cudnn_off", {"enabled": False}))
GEN_ENTRIES = 256  # phase 15 (c): entries of the generator's rollout
GEN_SENSOR = (360, 640)  # phase 15 (c): the renders (h, w), resize_crop to W x H
GEN_RGB_OFF_BY_ONE = 1e-5  # phase 15 (c): the CPU tests' resize_crop bounds: rgb 1 off
GEN_DEPTH_OFF_BY_ULP = 5e-4  # and depth 1 float16 ulp off, on at most these shares
REF_PAIRS = 1_000_000  # phase 15 (c): the reference's train set (TRAIN.md)
FORK_WORKERS = 2  # phase 15 (c): forked writers, each transforming on the card
FORK_ENTRIES = 64  # phase 15 (c): entries a forked writer rolls
DR_STEPS = 500  # phase 15 (d): oracle steps dead-reckoned
DR_NOISE = (0.01, 0.01, 0.0035)  # phase 15 (d): VO-sized error std of (dx m, dz m, dyaw rad)
DR_TOL_M = 1e-4  # phase 15 (d): final goal, card vs CPU float32 (the CPU test's bound)
PIPE_RL_STEPS = 8  # phase 16 (a): rollout steps of the trainer whose rollout is compared
# phase 16 (a): the card's bf16 policy gradients against the CPU's, relative L2
# (read 4.59e-2; an fp32 path would read about 8.8e-2, the CPU's bf16-to-fp32)
PIPE_BF16_GRAD_REL = 6.5e-2
# phase 16 (a): the ladder's training shape (eval_994_ladder.py's defaults)
LADDER_TRAIN_ENVS, LADDER_STEPS = 16, 64
# phase 16 (b): the ladder at a smoke size (every row, the farm, the .part)
LADDER_ARGS = ["--episodes", "16", "--rnd-episodes", "8", "--envs", "8", "--pairs", "256",
               "--eval-pairs", "64", "--epochs", "1", "--gps-updates", "2",
               "--tune-updates", "2", "--train-envs", "4", "--num-steps", "16",
               "--max-episode-steps", "30"]
# phase 16 (c): the other drivers at smoke sizes
PIPE_TUNE_ARGS = ["--pairs", "256", "--epochs", "1", "--size", "64", "--gps-updates", "1",
                  "--tune-updates", "1", "--episodes", "4", "--envs", "4"]
PIPE_E2E_ARGS = ["--pairs", "256", "--eval-pairs", "64", "--epochs", "1", "--size", "96",
                 "--episodes", "8", "--envs", "4"]
PIPE_RL_ARGS = ["--updates", "2", "--envs", "4", "--size", "64", "--steps", "16"]
PIPE_VO_ARGS = ["--pairs", "256", "--eval-pairs", "64", "--epochs", "1", "--size", "96"]
VIS_SIZE = 96  # phase 16 (c): vis_trajectory's square frames and its checkpoint's experts
FEB_STEPS = 30  # phase 17 (a): full_eval_benchmark's loop steps (the script's default: 200)
PROFILE_ITERS = 8  # phase 17 (b): profile_vo_step's BENCH_ITERS
FARM_VIDEOS, FARM_RANK_TOP_K = 2, 5  # phase 11 (d)
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


def _build_models(cfg, dev, seed, **policy_kw):
    """Three VO experts and the policy (``PointNavActorCritic`` with
    ``policy_kw``) with seeded random weights; returns (card ensemble, card
    policy, CPU copies of both)."""
    import torch

    from pointnav_vo_tpu_torch.io.weights import seeded_init_
    from pointnav_vo_tpu_torch.models.policy import PointNavActorCritic
    from pointnav_vo_tpu_torch.vo.ensemble import VOEnsemble

    g = torch.Generator().manual_seed(seed)
    experts = [seeded_init_(cfg.make_model(), g) for _ in range(3)]
    policy = seeded_init_(PointNavActorCritic(image_size=(H, W), **policy_kw), g).eval()
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
    episodes = (agg, [dataclasses.asdict(r) for r in ev.results], ev.episode_keys)
    return launches, step_ms, wall, loop_steps, episodes


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
            delta, _std, state["feats"] = vo.step(state["feats"], rgb, depth, actions)
            return delta

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        ms = _time_ms(step, iters, warmup=2)
        name = f"{precision}+{cache_dtype}"
        prof = _profile(f"VOEnsemble.step at B={batch} {name}", step, iters=2)
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
        _log("steady", f"VOEnsemble.step B={batch} {name} 70/15/15: {ms:.3f} ms/step "
                       f"(device {rec['device_ms']} ms), {rec['frame_pairs_per_s']:.2f} "
                       f"frame-pairs/s, peak {rec['peak_gib']:.2f} GiB, cache "
                       f"{rec['cache_bytes_per_frame']} B a frame on {card}")
        # one fixed step, frames[0] cached -> frames[1], for the int8 checks
        # (kept small and off the card: the next configs' peaks stay their own)
        delta, _std, pack = vo.step(frame_features_packed(*frames[0], cfg), *frames[1],
                                    actions)
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


def _train_step_vs_cpu(dev, stage, tcfg, batch, experts, icfg=None):
    """One train step at full width, dropout off, from the same weights
    (the experts of ``icfg``, the paper model's config where None): on
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

    icfg = icfg or VOInferenceConfig(vis_size_h=H, vis_size_w=W, dropout_p=0.0)
    runs, step_s = {}, {}
    for name, device, dtype in (("card", dev, torch.float32),
                                ("cpu", torch.device("cpu"), torch.float32),
                                ("cpu64", torch.device("cpu"), torch.float64)):
        engine = VORegressionEngine(icfg, tcfg, device=device,
                                    experts=[copy.deepcopy(m).to(dtype) for m in experts])
        t0 = time.perf_counter()
        loss = float(engine.train_step(batch)["total_loss"])
        step_s[name] = time.perf_counter() - t0
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
    _log("train", f"{stage} card vs CPU train step, B={batch.actions.shape[0]}: loss "
                  f"{loss_card:.8f} (CPU {loss_cpu:.8f}, float64 {loss_64:.8f}); worst gradient "
                  "error over tensors [relative L2, max abs / max abs]: "
                  + json.dumps(worst) + "; whitening statistics agree; step s "
                  + json.dumps(step_s))
    grads64 = [p.grad for m in cpu64 for p in m.parameters()]
    return {"loss": [loss_card, loss_cpu, loss_64], "worst_gradient_error": worst,
            "step_s": step_s}, grads64


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


def _rl_trainer(dev, num_steps, seed, policy=None):
    """The RL config at full width with seeded weights: ``policy`` (the
    depth policy where None), three det VO experts in the loop, 2 scripted
    envs."""
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
    policy = PointNavActorCritic(image_size=(H, W)) if policy is None else policy
    return DDPPOTrainer(model=policy, ppo_cfg=cfg, envs=envs,
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


def _rl_step_vs_cpu(dev, trainer, tag="rl"):
    """One rollout step's pieces on the card and the CPU from the same
    inputs (step 0 -> 1 of the trainer's stored rollout, copies of its
    policy): the mode action of the policy (folding the frames into the
    whitening buffers where the trainer's rollout does), the det VO delta
    of the cached step and the dead-reckoned goal.  Actions equal, the rest
    (the updated buffers too) within rtol 1e-3 / atol 1e-4."""
    import torch

    from pointnav_vo_tpu_torch.ops.geometry import pointgoal_polar2cartesian
    from pointnav_vo_tpu_torch.rl.trainer import act_step, propagate_goal
    from pointnav_vo_tpu_torch.vo.ensemble import VOEnsemble, frame_features_packed

    r = trainer.rollouts
    cpu = torch.device("cpu")
    actions_np = r.actions[0, :, 0].cpu().numpy()
    runs = {}
    for name, device, model, vo in (
            # .to: cuDNN's flat RNN weights
            ("card", dev, copy.deepcopy(trainer.model).to(dev), trainer.vo),
            ("cpu", cpu, copy.deepcopy(trainer.model).to(cpu),
             VOEnsemble(trainer.vo.cfg, experts=[copy.deepcopy(m).to(cpu)
                                                 for m in trainer.vo.experts], device=cpu))):
        obs0 = {k: v[0].to(device) for k, v in r.observations.items()}
        obs1 = {k: v[1].to(device) for k, v in r.observations.items()}
        value, action, logp, hidden = act_step(model, obs0, r.hidden_states[0].to(device),
                                               r.prev_actions[0].to(device),
                                               r.masks[0].to(device),
                                               update_stats=trainer.update_stats)
        feats = frame_features_packed(obs0["rgb"], obs0["depth"], vo.cfg)
        delta, _std, _ = vo.step(feats, obs1["rgb"], obs1["depth"], actions_np)
        goal, polar = propagate_goal(pointgoal_polar2cartesian(obs0["pointgoal_with_gps_compass"]),
                                     delta, 1.0 - r.masks[1].to(device),
                                     obs1["pointgoal_with_gps_compass"])
        runs[name] = {"value": value, "action": action, "logp": logp, "hidden": hidden,
                      "delta": delta, "goal_cart": goal, "polar": polar}
        runs[name].update({k.rsplit(".", 1)[-1]: v for k, v in model.state_dict().items()
                           if "running_mean_and_var" in k})
    errs = {}
    for k, w in runs["cpu"].items():
        g = runs["card"][k].cpu()
        errs[k] = float((g.double() - w.double()).abs().max())
        if k == "action":
            if not torch.equal(g, w):
                raise AssertionError("card and CPU rollout actions differ")
        elif not torch.allclose(g, w, rtol=1e-3, atol=1e-4):
            raise AssertionError(f"{tag}: card vs CPU rollout step {k}: max abs err {errs[k]}")
    _log(tag, "card vs CPU rollout step (rtol 1e-3, atol 1e-4; actions equal): "
              + json.dumps(errs, sort_keys=True))
    return errs


def _rl_grad_vs_cpu(dev, trainer, tag="rl"):
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
        raise AssertionError(f"{tag}: card ppo_loss {loss_card} vs CPU {loss_cpu}")

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
                raise AssertionError(f"{tag}: gradient of {name}: relative L2 error {e[0]} "
                                     "card vs CPU")
    _log(tag, f"card vs CPU ppo_loss gradient, T={rollouts.num_steps} N={rollouts.num_envs}: "
              f"loss {loss_card:.8f} (CPU {loss_cpu:.8f}, float64 {loss_64:.8f}); worst "
              "gradient error over tensors [relative L2, max abs / max abs]: "
              + json.dumps(worst))
    return {"loss": [loss_card, loss_cpu, loss_64], "worst_gradient_error": worst}


def _fixed_rollout_losses(dev, trainer, tag="rl"):
    """The loss of one fresh rollout over RL_FIXED_UPDATES successive
    updates on it, by a copy of the trainer's policy; it must fall."""
    import torch

    from pointnav_vo_tpu_torch.rl.ppo import make_optimizer, ppo_loss, ppo_update

    trainer.collect_rollout()
    rollouts = _with_returns(trainer)
    model = copy.deepcopy(trainer.model).to(dev)  # .to: cuDNN's flat RNN weights
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
        raise AssertionError(f"{tag}: the fixed rollout's loss did not fall: {losses}")
    _log(tag, f"fixed rollout, loss before and after each of {RL_FIXED_UPDATES} updates: "
              + " ".join(f"{x:.6f}" for x in losses))
    return losses


def phase_train_rl(dev, card):
    """Policy training with VO in the loop at full width."""
    import torch

    from pointnav_vo_tpu_torch.ops import topdown_kernels as tk

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

    losses = _fixed_rollout_losses(dev, trainer)

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

        def counted_run(self, num_episodes, **kw):
            before, calls = tk.launch_counts["bin_counts"], step_calls[0]
            out = real_run(self, num_episodes, **kw)
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

    from pointnav_vo_tpu_torch.vo.ensemble import VOInferenceConfig

    cfg = VOInferenceConfig(vis_size_h=H, vis_size_w=W)
    vo, policy, cpu_vo, cpu_policy = _build_models(cfg, dev, SEED + 30)
    return _agent_episode(dev, card, vo, policy, cpu_vo, cpu_policy, SEED + 30, "agent")


def _agent_episode(dev, card, vo, policy, cpu_vo, cpu_policy, seed, tag):
    """Phase 9's episode with the given models (card and CPU copies)."""
    import torch

    from pointnav_vo_tpu_torch.deploy.challenge_agent import PointNavVOAgent
    from pointnav_vo_tpu_torch.ops import geometry as geo
    from pointnav_vo_tpu_torch.ops import topdown_kernels as tk
    from pointnav_vo_tpu_torch.rl.envs import EnvConfig, ScriptedPointNavEnv

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
                              seed=seed)
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
            raise AssertionError(f"{tag} step {len(actions)}: card action {a}, CPU {want}")
        got_goal, want_goal = card_agent.goal_cartesian, cpu_agent.goal_cartesian
        if not np.allclose(got_goal, want_goal, rtol=1e-3, atol=1e-4):
            raise AssertionError(f"{tag} step {len(actions)}: card goal {got_goal}, "
                                 f"CPU {want_goal}")
        goal_err = max(goal_err, float(np.abs(got_goal - want_goal).max()))
        # the true egocentric goal of the frame the agent acted on
        true_goal = geo.pointgoal_polar2cartesian(torch.as_tensor(
            obs["pointgoal_with_gps_compass"][None], dtype=torch.float32))[0].numpy()
        actions.append(a)
        obs, _r, done, info = env.step(a)
    n = len(actions)
    if n < 3 or launches != n:
        raise AssertionError(f"{tag}: {launches} bin_counts launches over {n} acts "
                             "(expected one an act after the first, one more on the first "
                             "VO step)")
    # the expert of an act runs on the next one: every act but the last
    ran = {name: actions[:-1].count(a) for name, a in (("forward", 1), ("left", 2),
                                                       ("right", 3))}
    if min(ran.values()) == 0:
        raise AssertionError(f"{tag}: an expert never ran ({ran}); actions {actions}")
    end_drift = {"card_vs_cpu": float(np.abs(got_goal - want_goal).max()),
                 "card_vs_true_goal": float(np.linalg.norm(got_goal - true_goal)),
                 "cpu_vs_true_goal": float(np.linalg.norm(want_goal - true_goal))}
    steady = act_ms[2:]
    out = {"acts": n, "launches": launches, "actions": actions, "experts_ran": ran,
           "act_ms_mean": float(np.mean(steady)), "act_ms_median": float(np.median(steady)),
           "first_act_ms": act_ms[:2], "goal_max_abs_err": goal_err, "end_drift": end_drift,
           "success": info.get("success"), "spl": info.get("spl")}
    _log(tag, f"{n} acts at {W}x{H}: per act {out['act_ms_mean']:.3f} ms mean, "
              f"{out['act_ms_median']:.3f} ms median (host clock, synchronized, acts 3 on; "
              f"first two {act_ms[0]:.3f}, {act_ms[1]:.3f} ms), bin_counts launches "
              f"{launches}, actions equal to the CPU agent's, goal max abs err "
              f"{goal_err:.3g} (rtol 1e-3, atol 1e-4) on {card}; experts run "
              f"{json.dumps(ran)}; goal drift at the episode's end (m) "
              f"{json.dumps(end_drift)}; actions {actions}")
    return out


def phase_eval_994(dev, card):
    """The 994-episode protocol's script at a smoke size: bf16 experts
    trained in memory, then an exact set of distinct episodes on the shm
    env farm with ``bin_counts`` launched exactly once per step plus one
    (checked by ``run_protocol``)."""
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
                f"envs ({eval_994.BACKENDS['shm']}, cap {E994_CAP}): wall {run['wall_s']:.3f} s, {run['loop_steps']} loop "
                f"steps, {run['distinct_episodes']} distinct episodes, bin_counts launches "
                f"{run['bin_counts_launches']} (steps + 1), success {agg['success']:.3f}, spl "
                f"{agg['spl']:.3f}, vo_l2 {agg.get('vo_l2_mean', float('nan')):.4f}, "
                f"time_env_s {agg['time_env_s']:.3f}, time_device_s "
                f"{agg['time_device_s']:.3f} on {card}")
    return {"train_s": train_s, "train_launches": train_launches, "train": train,
            **{k: v for k, v in run.items()}}


def _host_lines(env_cfg, slots):
    """The host's CPUs, its /dev/shm and the farm's ring bytes."""
    from pointnav_vo_tpu_torch.native.shm_env import ring_bytes

    st = os.statvfs("/dev/shm")
    host = {"cpu_count": os.cpu_count(), "affinity": len(os.sched_getaffinity(0)),
            "dev_shm_bytes": st.f_blocks * st.f_frsize, "dev_shm_free_bytes":
            st.f_bavail * st.f_frsize, "ring_bytes": ring_bytes(env_cfg, N_ENVS, slots)}
    _log("farm", f"host: os.cpu_count() {host['cpu_count']}, affinity {host['affinity']} "
                 f"CPUs; /dev/shm {host['dev_shm_bytes']} B ({host['dev_shm_free_bytes']} B "
                 f"free); {N_ENVS} workers x {slots} slots of rings: {host['ring_bytes']} B")
    return host


def _farm_run(dev, envs, vo, policy, n_episodes, **kw):
    """One ``Evaluator.run`` with the launch counts set to 0 just before it;
    closes ``envs`` and, for a farm, checks that its workers exited 0 and
    that none of its own ``/dev/shm`` segments is left (other processes on
    the machine may hold farms of their own)."""
    import torch

    from pointnav_vo_tpu_torch.examples.eval_994 import CountedSteps
    from pointnav_vo_tpu_torch.ops import topdown_kernels as tk
    from pointnav_vo_tpu_torch.rl.eval import Evaluator

    run = {k: kw.pop(k) for k in ("video_dir", "video_episodes", "ranked_img_dir",
                                  "rank_top_k", "tb_writer") if k in kw}
    counted = CountedSteps(envs)  # counts the loop steps
    ev = Evaluator(model=policy, envs=counted, vo_ensemble=vo, device=dev, **kw)
    procs = list(getattr(envs, "_procs", []))
    prefix = getattr(envs, "_prefix", None)
    try:
        tk.reset_launch_counts()
        t0 = time.perf_counter()
        agg = ev.run(n_episodes, **run)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = tk.launch_counts["bin_counts"]
    finally:
        t0 = time.perf_counter()
        envs.close()
        close_s = time.perf_counter() - t0
    if [p.exitcode for p in procs] != [0] * len(procs):
        raise AssertionError(f"farm workers exited {[p.exitcode for p in procs]}")
    left = glob.glob(f"/dev/shm{prefix}_*") if prefix else []
    if left:
        raise AssertionError(f"shm segments left after close: {left}")
    if agg["episodes"] != n_episodes or len(ev.results) != n_episodes:
        raise AssertionError(f"expected exactly {n_episodes} episodes, got {agg['episodes']}")
    bad = [k for k, v in agg.items() if not np.isfinite(v)]
    if bad:
        raise AssertionError(f"non-finite aggregates: {bad}")
    return {"agg": agg, "results": [dataclasses.asdict(r) for r in ev.results],
            "launches": launches, "loop_steps": counted.calls, "wall_s": wall,
            "close_s": close_s}


# the float64 metrics of the in-process env that the farm's float32 payload rounds
_FARM_ROUNDED = ("spl", "softspl", "distance_to_goal")


def _farm_vs_sync(got, want, what, exact=False):
    """A farm run against the in-process run: every aggregate and
    per-episode field equal, except the payload's float32 metrics (equal
    after rounding the in-process value to float32; their means within rtol
    1e-6) and the episode id (the payload carries none: -1).  ``exact``:
    two in-process runs, every field equal."""
    for k, v in want["agg"].items():
        g = got["agg"][k]
        if k.startswith("time_"):
            continue
        if k in _FARM_ROUNDED and not exact:
            if not np.isclose(g, v, rtol=1e-6, atol=0):
                raise AssertionError(f"{what}: {k} {g} against {v}")
        elif g != v:
            raise AssertionError(f"{what}: {k} {g} against {v} (expected bit-equal)")
    for i, (a, b) in enumerate(zip(got["results"], want["results"], strict=True)):
        for k, v in b.items():
            if k == "episode_id" and not exact:
                ok = a[k] == -1
            elif k in _FARM_ROUNDED and not exact:
                ok = np.float32(a[k]) == np.float32(v)
            else:
                ok = a[k] == v or (np.isnan(a[k]) and np.isnan(v))
            if not ok:
                raise AssertionError(f"{what}: episode {i} {k} {a[k]} against {v}")


class _FrameSink:
    """A TensorBoard writer that keeps the eval videos' frames."""

    def __init__(self):
        self.videos = []

    def add_video_from_np_images(self, name, step, images, fps=10):
        self.videos.append((name, np.stack(images)))


def phase_farm(dev, card):
    """Phase 11: the evaluator's host side at full width over the shm env
    farm (32 forked workers, made after the card is in use): (a) phase 3's
    det fp32 eval in process, on the farm and on the farm with the overlap,
    equal results, steps + 1 launches each; (b) GPS-only, no launch; (c)
    unfused, 2 launches a step, its step held against the fused step and
    the CPU; (d) eval videos and ranked images composed on the card's run,
    written with cv2 where the machine has it."""
    import importlib.util
    import tempfile

    import torch

    from pointnav_vo_tpu_torch.native.shm_env import ShmVectorEnv
    from pointnav_vo_tpu_torch.rl.envs import EnvConfig, make_scripted_vector_env
    from pointnav_vo_tpu_torch.rl.eval import fused_vo_act_step
    from pointnav_vo_tpu_torch.rl.trainer import act_step, propagate_goal
    from pointnav_vo_tpu_torch.vis import maps
    from pointnav_vo_tpu_torch.vo.ensemble import VOInferenceConfig

    n = N_ENVS
    cfg = VOInferenceConfig(vis_size_h=H, vis_size_w=W)
    vo, policy, cpu_vo, cpu_policy = _build_models(cfg, dev, SEED)  # phase 3's models
    env_cfg = EnvConfig(image_h=H, image_w=W, max_episode_steps=FARM_CAP)
    host = _host_lines(env_cfg, FARM_SLOTS)

    def farm():
        t0 = time.perf_counter()
        envs = ShmVectorEnv(env_cfg, n, seed=SEED, slots=FARM_SLOTS)
        return envs, time.perf_counter() - t0

    # (a) in process, the farm, the farm with the overlap
    runs = {"sync": _farm_run(dev, make_scripted_vector_env(env_cfg, n, seed=SEED), vo,
                              policy, n)}
    starts = {}
    for name, overlap in (("shm", "0"), ("shm_async", "1")):
        old = os.environ.get("PNVO_EVAL_ASYNC")
        os.environ["PNVO_EVAL_ASYNC"] = overlap
        try:
            envs, starts[name] = farm()
            runs[name] = _farm_run(dev, envs, vo, policy, n)
        finally:
            if old is None:
                os.environ.pop("PNVO_EVAL_ASYNC")
            else:
                os.environ["PNVO_EVAL_ASYNC"] = old
    # the in-process run again beside an idle farm, its 32 workers polling
    # their action rings: how much of the farm's extra time_device_s their
    # polling costs the evaluator's process
    idle, _ = farm()
    idle_procs, idle_prefix = list(idle._procs), idle._prefix
    try:
        idle.reset()
        runs["sync_idle"] = _farm_run(dev, make_scripted_vector_env(env_cfg, n, seed=SEED),
                                      vo, policy, n)
    finally:
        idle.close()
    if [p.exitcode for p in idle_procs] != [0] * n or glob.glob(f"/dev/shm{idle_prefix}_*"):
        raise AssertionError("the idle farm did not close cleanly")
    for name, r in runs.items():
        if r["launches"] != r["loop_steps"] + 1:
            raise AssertionError(f"{name}: bin_counts launched {r['launches']} times over "
                                 f"{r['loop_steps']} steps; expected steps + 1")
        if name != "sync":
            _farm_vs_sync(r, runs["sync"], name, exact=name == "sync_idle")
            if r["loop_steps"] != runs["sync"]["loop_steps"]:
                raise AssertionError(f"{name}: {r['loop_steps']} loop steps against "
                                     f"{runs['sync']['loop_steps']}")
    timing = {name: {k: r["agg"][k] for k in ("time_env_s", "time_device_s",
                                                "time_transfer_s")}
              | {"wall_s": r["wall_s"], "loop_steps": r["loop_steps"],
                 "env_ms_per_step": 1e3 * r["agg"]["time_env_s"] / r["loop_steps"]}
              for name, r in runs.items()}
    _log("farm", f"(a) det fp32 Evaluator.run, {n} episodes, cap "
                 f"{FARM_CAP}: the farm's and the overlap's aggregates and per-episode results "
                 "equal the in-process run's (spl/softspl/distance_to_goal after float32 "
                 f"rounding, the payload's); launches {runs['sync']['launches']} / "
                 f"{runs['shm']['launches']} / {runs['shm_async']['launches']} (steps + 1); "
                 f"farm start {starts['shm']:.3f} / {starts['shm_async']:.3f} s, close "
                 f"{runs['shm']['close_s']:.3f} / {runs['shm_async']['close_s']:.3f} s, workers "
                 "exited 0, none of their /dev/shm segments left; sync_idle: the in-process "
                 f"run beside an idle {n}-worker farm, results equal to sync")
    for name in runs:
        t = timing[name]
        _log("farm", f"  {name:9s}: time_env_s {t['time_env_s']:.4f} ({t['env_ms_per_step']:.3f} "
                     f"ms a step), time_device_s {t['time_device_s']:.4f}, time_transfer_s "
                     f"{t['time_transfer_s']:.4f}, wall {t['wall_s']:.4f} s over "
                     f"{t['loop_steps']} steps on {card}")

    # (b) GPS-only
    envs, _ = farm()
    gps = _farm_run(dev, envs, None, policy, n)
    if gps["launches"] != 0 or "vo_l2_mean" in gps["agg"]:
        raise AssertionError(f"GPS-only eval: {gps['launches']} launches, {gps['agg']}")
    _log("farm", f"(b) GPS-only: {gps['loop_steps']} steps, 0 bin_counts launches, success "
                 f"{gps['agg']['success']:.3f}, time_act_s {gps['agg']['time_act_s']:.4f}, "
                 f"time_env_s {gps['agg']['time_env_s']:.4f}")

    # (c) unfused: the run, then one step against the fused step and the CPU
    envs, _ = farm()
    unfused = _farm_run(dev, envs, vo, policy, n, fused=False)
    if unfused["launches"] != 2 * unfused["loop_steps"]:
        raise AssertionError(f"unfused: bin_counts launched {unfused['launches']} times over "
                             f"{unfused['loop_steps']} steps; expected 2 a step")
    same = [r["steps"] for r in unfused["results"]] == [r["steps"] for r in runs["shm"]["results"]]
    if not same:
        raise AssertionError("unfused and fused runs took other trajectories")
    for k in ("vo_l2_mean", "global_drift_mean", "success", "spl"):
        if not np.isclose(unfused["agg"][k], runs["shm"]["agg"][k], rtol=1e-3, atol=1e-4):
            raise AssertionError(f"unfused {k} {unfused['agg'][k]} against fused "
                                 f"{runs['shm']['agg'][k]}")

    probe = make_scripted_vector_env(env_cfg, n, seed=SEED + 1)
    obs0 = probe.reset()
    rng = np.random.default_rng(SEED)
    actions = np.where(rng.uniform(size=n) < 0.7, 1, rng.integers(2, 4, n)).astype(np.int64)
    obs1 = probe.step(actions)[0]

    def unfused_step(d, ens, pol):
        a = _fused_inputs(obs0, obs1, actions, d, cfg, pol)
        prev_rgb = torch.as_tensor(np.asarray(obs0["rgb"], np.uint8), device=d)
        prev_depth = torch.as_tensor(obs0["depth"], device=d)
        delta, std, _ = ens.compute_local_delta_states_from_vo(
            prev_rgb, prev_depth, a["cur_rgb"], a["cur_depth"], actions)
        goal, polar = propagate_goal(a["goal_cart"], delta, a["reset_mask"], a["sensor_polar"])
        obs = {"rgb": a["cur_rgb"], "depth": a["cur_depth"], "pointgoal_with_gps_compass": polar}
        _v, action, _lp, hidden = act_step(pol, obs, a["hidden"], a["prev_actions"], a["masks"])
        return {"delta": delta, "std": std, "goal_cart": goal, "polar": polar,
                "action": action, "hidden": hidden}

    def vs(got, want, what):
        errs = {}
        for k, w in want.items():
            g = got[k].cpu()
            w = w.cpu()
            errs[k] = float((g.double() - w.double()).abs().max())
            if k == "action":
                if not torch.equal(g, w):
                    raise AssertionError(f"{what}: actions differ")
            elif not torch.allclose(g, w, rtol=1e-3, atol=1e-4):
                raise AssertionError(f"{what}: {k} max abs err {errs[k]}")
        return errs

    with torch.no_grad():
        got = unfused_step(dev, vo, policy)
        fused = fused_vo_act_step(policy, vo, **_fused_inputs(obs0, obs1, actions, dev, cfg,
                                                              policy))
        fused_out = dict(zip(("goal_cart", "polar", "delta", "std", "value", "action", "logp",
                              "hidden"), fused))
        vs_fused = vs(got, {k: fused_out[k] for k in got}, "unfused vs fused step")
        vs_cpu = vs(got, unfused_step(torch.device("cpu"), cpu_vo, cpu_policy),
                    "unfused step, card vs CPU")
        step_ms = _time_ms(lambda: unfused_step(dev, vo, policy), iters=10)
    _log("farm", f"(c) unfused: {unfused['loop_steps']} steps, {unfused['launches']} "
                 "bin_counts launches (2 a step), the fused run's trajectories; one step "
                 f"{step_ms:.4f} ms (CUDA events, inputs built inside) vs the fused step "
                 "(rtol 1e-3, atol 1e-4, actions equal): " + json.dumps(vs_fused, sort_keys=True)
                 + "; vs the CPU (the same bounds): " + json.dumps(vs_cpu, sort_keys=True))

    # (d) videos and ranked images composed on the card's run
    has_cv2 = importlib.util.find_spec("cv2") is not None
    sink, ranked = _FrameSink(), []
    save_ranked = maps.save_ranked_error_images
    with tempfile.TemporaryDirectory() as tmp:
        run_kw = dict(video_episodes=FARM_VIDEOS, rank_top_k=FARM_RANK_TOP_K, tb_writer=sink,
                      ranked_img_dir=os.path.join(tmp, "ranked"))
        if has_cv2:
            run_kw["video_dir"] = os.path.join(tmp, "videos")
        else:  # keep the records the writer would have written
            maps.save_ranked_error_images = lambda recs, *a, **k: ranked.extend(recs)
        try:
            envs, _ = farm()
            # two episodes an env: env 0 ends at least FARM_VIDEOS of its own
            vid = _farm_run(dev, envs, vo, policy, FARM_VIDEOS * n, **run_kw)
        finally:
            maps.save_ranked_error_images = save_ranked
        written = {}
        if has_cv2:
            written = {d: sorted(os.listdir(os.path.join(tmp, d)))
                       for d in ("videos", "ranked")}
            ranked = written["ranked"]
    if len(sink.videos) != FARM_VIDEOS or not ranked:
        raise AssertionError(f"(d): {len(sink.videos)} videos, {len(ranked)} ranked records")
    if vid["launches"] != vid["loop_steps"] + 1:
        raise AssertionError(f"(d): {vid['launches']} launches over {vid['loop_steps']} steps")
    shapes = sorted({v.shape for _, v in sink.videos})
    _log("farm", f"(d) {len(sink.videos)} eval videos composed ([rgb | map] frames "
                 f"{shapes}), {vid['launches']} launches (steps + 1); "
                 + (f"cv2 wrote {written}" if has_cv2 else
                    f"{len(ranked)} ranked records composed; cv2 is missing on this machine: "
                    "the mp4 and PNG writers are held on the CPU only "
                    "(tests/test_torch_port_vis.py)"))
    return {"host": host, "timing": timing, "farm_start_s": starts,
            "launches": {name: r["launches"] for name, r in runs.items()}
            | {"gps_only": gps["launches"], "unfused": unfused["launches"],
               "video_ranked": vid["launches"]},
            "loop_steps": {name: r["loop_steps"] for name, r in runs.items()}
            | {"unfused": unfused["loop_steps"]},
            "unfused_vs_fused": vs_fused, "unfused_vs_cpu": vs_cpu, "unfused_step_ms": step_ms,
            "gps_only": {k: gps["agg"][k] for k in ("success", "spl", "time_act_s",
                                                     "time_env_s")},
            "cv2": has_cv2, "metrics": runs["shm"]["agg"]}



_PAPER_OBS = ("rgb", "depth", "discretized_depth", "top_down_view")


def _zoo_frames(n, seed, make_envs=None):
    """Two consecutive observations of ``n`` envs (``make_envs(n, seed)``;
    scripted at full width by default), the second after a 70/15/15
    forward/left/right step, and the actions."""
    from pointnav_vo_tpu_torch.rl.envs import EnvConfig, make_scripted_vector_env

    if make_envs is None:
        make_envs = functools.partial(make_scripted_vector_env, EnvConfig(image_h=H, image_w=W))
    envs = make_envs(n, seed=seed)
    obs0 = envs.reset()
    rng = np.random.default_rng(seed)
    actions = np.where(rng.uniform(size=n) < 0.7, 1, rng.integers(2, 4, n)).astype(np.int64)
    obs1 = envs.step(actions)[0]
    envs.close()
    return obs0, obs1, actions


def _zoo_pairs(cfg, frames, dev):
    """The packed pairs of ``frames`` under ``cfg`` on ``dev``: one feature
    pass (one ``bin_counts`` launch where the space has the top-down view)
    per frame batch."""
    import torch

    from pointnav_vo_tpu_torch.vo.ensemble import frame_features_packed

    obs0, obs1, actions = frames
    packs = [frame_features_packed(torch.as_tensor(o["rgb"], device=dev),
                                   torch.as_tensor(o["depth"], device=dev), cfg)
             for o in (obs0, obs1)]
    return torch.cat(packs, dim=-1), torch.as_tensor(actions, device=dev)


def _zoo_forward(model, pairs, actions):
    import torch

    from pointnav_vo_tpu_torch.vo.engine import apply_vo_model

    with torch.no_grad():
        return apply_vo_model(model, pairs, actions)


def _zoo_vs_cpu(what, model, cfg, frames, dev):
    """One det forward of ``model`` on the card against its CPU copy on
    the same frames (each side computes its features): rtol 1e-3 / atol
    1e-4 on the delta (fp32, TF32 off).  Returns (max abs err, launches)."""
    import torch

    from pointnav_vo_tpu_torch.ops import topdown_kernels as tk

    cpu = copy.deepcopy(model).eval()
    card = model.to(dev).eval()
    torch.cuda.synchronize()
    tk.reset_launch_counts()
    got = _zoo_forward(card, *_zoo_pairs(cfg, frames, dev))
    torch.cuda.synchronize()
    launches = tk.launch_counts["bin_counts"]
    want = _zoo_forward(cpu, *_zoo_pairs(cfg, frames, torch.device("cpu")))
    err = float((got.cpu().double() - want.double()).abs().max())
    if not (torch.isfinite(got).all() and torch.allclose(got.cpu(), want, rtol=1e-3,
                                                          atol=1e-4)):
        raise AssertionError(f"{what}: card vs CPU delta, max abs err {err}")
    return err, launches


def _zoo_backbones(dev, card):
    """(a) Each backbone in the paper model's encoder: card vs CPU at B=8,
    the device time of a no-grad B=128 forward, its peak memory."""
    import torch

    from pointnav_vo_tpu_torch.io.weights import seeded_init_
    from pointnav_vo_tpu_torch.models import resnet as resnet_lib
    from pointnav_vo_tpu_torch.vo.ensemble import VOInferenceConfig

    frames = _zoo_frames(ZOO_PARITY_BATCH, SEED + 40)
    rng = np.random.default_rng(SEED + 41)
    big = torch.from_numpy(rng.uniform(0, 1, (ZOO_TIME_BATCH, H, W, 30)).astype(np.float32))
    big_acts = torch.ones(ZOO_TIME_BATCH, dtype=torch.int64, device=dev)
    big = big.to(dev)
    out = {}
    for name in resnet_lib.BACKBONES:
        cfg = VOInferenceConfig(vis_size_h=H, vis_size_w=W, backbone=name)
        model = seeded_init_(cfg.make_model(), torch.Generator().manual_seed(SEED + 42))
        params = sum(p.numel() for p in model.parameters())
        err, launches = _zoo_vs_cpu(f"backbone {name}", model, cfg, frames, dev)
        if launches != 2:
            raise AssertionError(f"backbone {name}: {launches} bin_counts launches, expected 2")
        fwd = lambda: _zoo_forward(model, big, big_acts)  # noqa: E731
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        fwd()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        ms = _time_ms(fwd, iters=3, warmup=1)
        dev_ms = _device_ms(fwd, 3)
        out[name] = {"params": params, "max_abs_err": err, "launches": launches, "ms": ms,
                     "frame_pairs_per_s": ZOO_TIME_BATCH / (ms / 1e3), "device_ms": dev_ms,
                     "device_frame_pairs_per_s": ZOO_TIME_BATCH / (dev_ms / 1e3),
                     "peak_gib": peak}
        _log("zoo", f"(a) {name}: {params} parameters; card vs CPU B={ZOO_PARITY_BATCH} max abs "
                    f"err {err:.3e} (rtol 1e-3, atol 1e-4); no-grad B={ZOO_TIME_BATCH} forward "
                    f"{ms:.4f} ms CUDA events, {out[name]['frame_pairs_per_s']:.1f} frame-pairs/s; "
                    f"profiler device sum {dev_ms:.4f} ms "
                    f"({out[name]['device_frame_pairs_per_s']:.1f} frame-pairs/s); peak "
                    f"{peak:.3f} GiB on {card}")
        model.cpu()
        del model
    del big
    return out


def _zoo_variants(dev):
    """(b) Every VO variant with its own observation space: card vs CPU at
    B=8 (the act-embed ones with the action ids), and one ``bin_counts``
    launch per frame batch exactly where the space has the top-down view."""
    import torch

    from pointnav_vo_tpu_torch.io.weights import seeded_init_
    from pointnav_vo_tpu_torch.models import vo_cnn
    from pointnav_vo_tpu_torch.vo.ensemble import VOInferenceConfig

    frames = _zoo_frames(ZOO_PARITY_BATCH, SEED + 43)
    out, total = {}, 0
    for name in vo_cnn.VO_MODEL_NAMES:
        obs = vo_cnn._VARIANTS[name]["requires"]
        cfg = VOInferenceConfig(model_name=name, observation_space=obs, vis_size_h=H,
                                vis_size_w=W)
        model = seeded_init_(cfg.make_model(), torch.Generator().manual_seed(SEED + 44))
        err, launches = _zoo_vs_cpu(f"variant {name}", model, cfg, frames, dev)
        want = 2 if "top_down_view" in obs else 0
        if launches != want:
            raise AssertionError(f"variant {name}: {launches} bin_counts launches over 2 frame "
                                 f"batches, expected {want}")
        total += launches
        out[name] = {"max_abs_err": err, "launches": launches,
                     "model": type(model).__name__,
                     "backbone": type(model.visual_encoder.backbone.layer1[0]).__name__,
                     "blocks": sum(len(getattr(model.visual_encoder.backbone, f"layer{i}"))
                                   for i in range(1, 5)),
                     "input_channels": model.visual_encoder.input_channels}
        _log("zoo", f"(b) {name} {obs}: {out[name]['model']}, "
                    f"{out[name]['blocks']} {out[name]['backbone']}s, "
                    f"{out[name]['input_channels']} input channels; card vs CPU B="
                    f"{ZOO_PARITY_BATCH} max abs err {err:.3e}; bin_counts launches {launches}")
        model.cpu()
        del model
    return out, total


def _zoo_fixed_batch_losses(engine, batch, what):
    """The loss of one fixed batch under one fixed set of dropout masks
    before each of TRAIN_STEPS + 1 steps: it must fall."""
    gen_state = engine.generator.get_state()
    losses = []
    for _ in range(TRAIN_STEPS + 1):
        engine.generator.set_state(gen_state)
        losses.append(float(engine.train_step(batch)["total_loss"]))
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"{what}: the fixed batch's loss did not fall: {losses}")
    return losses


def _zoo_train(dev, card, name, tcfg, action_fn, seed):
    """A train stage of variant ``name`` at batch 128 on scripted pairs:
    the fixed batch's loss, step ms, frame-pairs/s and peak memory, then one
    step of ``ZOO_PARITY_BATCH`` rows held against the CPU, both sides beside
    a float64 step (phase 6's gates)."""
    import torch

    from pointnav_vo_tpu_torch.io.weights import seeded_init_
    from pointnav_vo_tpu_torch.models import vo_cnn
    from pointnav_vo_tpu_torch.rl.envs import EnvConfig
    from pointnav_vo_tpu_torch.vo.dataset import MemoryFramePairs
    from pointnav_vo_tpu_torch.vo.engine import VORegressionEngine
    from pointnav_vo_tpu_torch.vo.ensemble import VOInferenceConfig

    t0 = time.perf_counter()
    data = MemoryFramePairs.scripted(TRAIN_BATCH, action_fn, seed,
                                     env_cfg=EnvConfig(image_h=H, image_w=W))
    data_s = time.perf_counter() - t0
    obs = vo_cnn._VARIANTS[name]["requires"]
    icfg = VOInferenceConfig(model_name=name, observation_space=obs, vis_size_h=H, vis_size_w=W)
    expert = seeded_init_(icfg.make_model(), torch.Generator().manual_seed(seed))
    engine = VORegressionEngine(icfg, tcfg, data, device=dev, experts=[copy.deepcopy(expert)])
    batch = next(data.iter_batches(TRAIN_BATCH))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    losses = _zoo_fixed_batch_losses(engine, batch, name)
    step_ms = _time_ms(lambda: engine.train_step(batch), iters=3, warmup=1)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    pairs = TRAIN_BATCH / (step_ms / 1e3)
    acts = {int(a): int((batch.actions == a).sum()) for a in np.unique(batch.actions)}
    _log("zoo", f"{name}, action_type {tcfg.action_type!r}, B={TRAIN_BATCH} (actions {acts}; "
                f"pairs made in {data_s:.1f} s): fixed batch and dropout masks, loss before "
                f"each of {TRAIN_STEPS + 1} steps: " + " ".join(f"{x:.6f}" for x in losses)
                + f"; train_step {step_ms:.3f} ms, {pairs:.2f} frame-pairs/s (CUDA events, "
                f"batch upload included), peak {peak:.3f} GiB on {card}")
    del engine
    parity_cfg = dataclasses.replace(tcfg, batch_size=ZOO_PARITY_BATCH)
    parity = next(data.iter_batches(ZOO_PARITY_BATCH))
    vs_cpu, _ = _train_step_vs_cpu(dev, name, parity_cfg, parity, [expert],
                                   dataclasses.replace(icfg, dropout_p=0.0))
    return {"actions": acts, "fixed_batch_losses": losses, "step_ms": step_ms,
            "frame_pairs_per_s": pairs, "peak_gib": peak, "parity_batch": ZOO_PARITY_BATCH,
            "vs_cpu": vs_cpu}


def _zoo_nav_eval(dev, card):
    """(e) Phase 3's fused det eval built through ``engines.py`` from a
    config: ResNet-50 VO experts and a ResNet-50 policy, ``VO.OBS_TRANSFORM
    resize_crop`` over 256x256 renders (the shortest edge to 341, then the
    341x192 center), 32 scripted envs, a 20-step cap, 32 episodes; one
    fused step held against the CPU."""
    import torch

    from pointnav_vo_tpu_torch import engines
    from pointnav_vo_tpu_torch.config.defaults import get_rl_config
    from pointnav_vo_tpu_torch.io.weights import seeded_init_
    from pointnav_vo_tpu_torch.ops import topdown_kernels as tk
    from pointnav_vo_tpu_torch.rl.eval import Evaluator, fused_vo_act_step
    from pointnav_vo_tpu_torch.utils import registry
    from pointnav_vo_tpu_torch.vo.ensemble import VOEnsemble

    cap = 20
    sensors = [f"TASK_CONFIG.SIMULATOR.{s}_SENSOR.{side}" for s in ("DEPTH", "RGB")
               for side in ("HEIGHT", "WIDTH")]
    config = get_rl_config([RL_CONFIG], [
        "NUM_PROCESSES", str(N_ENVS), "SEED", str(SEED),
        "VO.USE_VO_MODEL", "True", "VO.REGRESS_MODEL.pretrained", "False",
        "VO.REGRESS_MODEL.visual_backbone", "resnet50", "RL.Policy.visual_backbone", "resnet50",
        "VO.OBS_TRANSFORM", "resize_crop", "VO.VIS_SIZE_W", str(W), "VO.VIS_SIZE_H", str(H),
        "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", str(cap),
        *[x for key in sensors for x in (key, str(ZOO_SENSOR))]])
    policy = registry.get_policy(config.RL.Policy.name)(config)
    seeded_init_(policy, torch.Generator().manual_seed(SEED + 50))
    cpu_policy = copy.deepcopy(policy).eval()
    policy = policy.to(dev).eval()
    vo = engines._build_vo_ensemble(config, dev)
    cpu_vo = VOEnsemble(vo.cfg, experts=[copy.deepcopy(m).cpu() for m in vo.experts],
                        device="cpu")
    envs = registry.get_env(config.ENV_NAME)(config, N_ENVS, seed=SEED + 50)
    ev = Evaluator(model=policy, envs=envs, vo_ensemble=vo, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    tk.reset_launch_counts()
    t0 = time.perf_counter()
    agg = ev.run(N_ENVS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = tk.launch_counts["bin_counts"]
    loop_steps = max(r.steps for r in ev.results)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    envs.close()
    if agg["episodes"] != N_ENVS or not all(np.isfinite(v) for v in agg.values()):
        raise AssertionError(f"zoo nav eval: {agg}")
    if launches != loop_steps + 1:
        raise AssertionError(f"zoo nav eval: bin_counts launched {launches} times over "
                             f"{loop_steps} steps; expected steps + 1")
    _log("zoo", f"(e) Evaluator.run, ResNet-50 VO and policy, {ZOO_SENSOR}x{ZOO_SENSOR} renders "
                f"through resize_crop to {W}x{H}: " + json.dumps(agg, sort_keys=True))
    _log("zoo", f"(e) {loop_steps} steps, {int(agg['total_env_steps'])} env steps, wall "
                f"{wall:.3f} s, bin_counts launches {launches}, peak {peak:.3f} GiB on {card}")

    obs0, obs1, actions = _zoo_frames(N_ENVS, SEED + 51, functools.partial(
        registry.get_env(config.ENV_NAME), config))
    if obs1["depth"].shape[1:3] != (ZOO_SENSOR, ZOO_SENSOR):
        raise AssertionError(f"the envs render {obs1['depth'].shape}, not {ZOO_SENSOR}^2")
    args = _fused_inputs(obs0, obs1, actions, dev, vo.cfg, policy)
    if tuple(args["prev_feats"].shape[1:3]) != (H, W):
        raise AssertionError(f"resize_crop gave features of {tuple(args['prev_feats'].shape)}")
    step_ms = _time_ms(lambda: fused_vo_act_step(policy, vo, **args), iters=10)
    got = fused_vo_act_step(policy, vo, **args)
    cpu_args = _fused_inputs(obs0, obs1, actions, torch.device("cpu"), cpu_vo.cfg, cpu_policy)
    want = fused_vo_act_step(cpu_policy, cpu_vo, **cpu_args)
    errs = _compare_step(got, want)
    _log("zoo", f"(e) fused_vo_act_step at {N_ENVS} envs: {step_ms:.4f} ms/step (CUDA events); "
                "card vs CPU (rtol 1e-3, atol 1e-4; actions equal): "
                + json.dumps(errs, sort_keys=True))
    return {"launches": launches, "loop_steps": loop_steps, "wall_s": wall, "metrics": agg,
            "step_ms": step_ms, "peak_gib": peak, "vs_cpu": errs}


def _zoo_tcfg(action_type):
    from pointnav_vo_tpu_torch.vo.engine import VOTrainConfig

    return VOTrainConfig(batch_size=TRAIN_BATCH, action_type=action_type, lr=2.5e-4, seed=SEED)


def phase_zoo(dev, card):
    """Phase 12: the VO model zoo at full width, fp32, TF32 off."""
    from pointnav_vo_tpu_torch.common import UNIFIED

    backbones = _zoo_backbones(dev, card)
    variants, variant_launches = _zoo_variants(dev)
    unified = _zoo_train(
        dev, card, "vo_cnn_act_embed", _zoo_tcfg(UNIFIED),
        lambda _env, _obs, r: 1 if r.uniform() < 0.7 else r.integers(2, 4),
        SEED + 45)
    deep = _zoo_train(dev, card, "vo_cnn_deeper", _zoo_tcfg(1), lambda *_: 1, SEED + 46)
    nav = _zoo_nav_eval(dev, card)
    return {"backbones": backbones, "variants": variants, "variant_launches": variant_launches,
            "unified": unified, "deep": deep, "nav_eval": nav}

# ---------------------------------------------------------------- phase 13


def _peak_gib(dev):
    import torch

    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated(dev) / 2**30


def _reset_peak(dev):
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)


def _rollout_and_update_ms(trainer):
    """One more rollout (ms a step) and one update (ms), each timed by CUDA
    events around the call (host work inside included)."""
    rollout_ms = _time_ms(trainer.collect_rollout, 1, warmup=0) / trainer.cfg.num_steps
    return rollout_ms, _time_ms(trainer.update_agent, 1, warmup=0)


def _policies_rgbd(dev, card, base):
    """(a) The rgb-d ResNet18 + 2-layer LSTM policy with whitening through
    the train CLI, det VO in the loop; the buffers' count, a rollout step
    against the CPU, a fixed rollout's loss."""
    _reset_peak(dev)
    trainer, wall, launches = _cli(["--run-type", "train", *base, "RL.Policy.visual_types",
                                    "[rgb, depth]", "NUM_UPDATES", str(POLICY_UPDATES)])
    peak = _peak_gib(dev)
    expected = POLICY_UPDATES * RL_STEPS + 1
    buffers = trainer.model.net.visual_encoder.running_mean_and_var
    count = float(buffers._count)
    want_count = RL_ENVS * RL_STEPS * POLICY_UPDATES
    if launches != expected or count != want_count or not trainer.update_stats:
        raise AssertionError(f"policies (a): {launches} bin_counts launches (expected "
                             f"{expected}), whitening count {count} (expected {want_count})")
    _log("policies", f"(a) rgb-d ResNet18 + LSTM, whitening: train {POLICY_UPDATES} updates x "
                     f"{RL_STEPS} steps x {RL_ENVS} envs through the CLI in {wall:.3f} s, "
                     f"bin_counts launches {launches}, whitening count {count:.0f} = N x T x "
                     f"updates, mean {buffers._mean.flatten().tolist()}, var "
                     f"{buffers._var.flatten().tolist()}, peak {peak:.3f} GiB on {card}")
    rollout_ms = _time_ms(trainer.collect_rollout, 1, warmup=0) / RL_STEPS
    step_errs = _rl_step_vs_cpu(dev, trainer, "policies")
    update_ms = _time_ms(trainer.update_agent, 1, warmup=0)
    _log("policies", f"(a) rollout step {rollout_ms:.4f} ms, update_agent {update_ms:.4f} ms "
                     "(CUDA events around the calls)")
    losses = _fixed_rollout_losses(dev, trainer, "policies")
    return {"launches": launches, "wall_s": wall, "whitening_count": count,
            "rollout_step_ms": rollout_ms, "update_ms": update_ms, "peak_gib": peak,
            "step_vs_cpu": step_errs, "fixed_rollout_losses": losses}


def _policies_gru(dev, card):
    """(b) The depth ResNet18 policy with a 2-layer GRU: phase 3's det eval,
    one fused step against the CPU, one PPO gradient against the CPU."""
    import torch

    from pointnav_vo_tpu_torch.models.policy import PointNavActorCritic
    from pointnav_vo_tpu_torch.ops import topdown_kernels as tk
    from pointnav_vo_tpu_torch.rl.envs import EnvConfig, make_scripted_vector_env
    from pointnav_vo_tpu_torch.rl.eval import Evaluator, fused_vo_act_step
    from pointnav_vo_tpu_torch.vo.ensemble import VOInferenceConfig

    cfg = VOInferenceConfig(vis_size_h=H, vis_size_w=W)
    vo, policy, cpu_vo, cpu_policy = _build_models(cfg, dev, SEED + 60, rnn_type="GRU")
    envs = make_scripted_vector_env(EnvConfig(image_h=H, image_w=W, max_episode_steps=20),
                                    N_ENVS, seed=SEED + 60)
    ev = Evaluator(model=policy, envs=envs, vo_ensemble=vo, device=dev)
    _reset_peak(dev)
    tk.reset_launch_counts()
    t0 = time.perf_counter()
    agg = ev.run(N_ENVS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = tk.launch_counts["bin_counts"]
    peak = _peak_gib(dev)
    loop_steps = max(r.steps for r in ev.results)
    if (agg["episodes"] != N_ENVS or not all(np.isfinite(v) for v in agg.values())
            or launches != loop_steps + 1 or policy.num_packed_hidden != 2):
        raise AssertionError(f"policies (b): {launches} launches over {loop_steps} steps "
                             f"(expected steps + 1); {agg}")
    obs0, obs1, actions = _zoo_frames(N_ENVS, SEED + 61)
    args = _fused_inputs(obs0, obs1, actions, dev, cfg, policy)
    step_ms = _time_ms(lambda: fused_vo_act_step(policy, vo, **args), iters=10)
    errs = _compare_step(fused_vo_act_step(policy, vo, **args), fused_vo_act_step(
        cpu_policy, cpu_vo, **_fused_inputs(obs0, obs1, actions, torch.device("cpu"), cfg,
                                            cpu_policy)))
    _log("policies", f"(b) depth ResNet18 + 2-layer GRU, det eval of {N_ENVS} envs: "
                     f"{loop_steps} steps in {wall:.3f} s, bin_counts launches {launches}, "
                     f"fused step {step_ms:.4f} ms (CUDA events), peak {peak:.3f} GiB on {card}; "
                     "card vs CPU (rtol 1e-3, atol 1e-4; actions equal): "
                     + json.dumps(errs, sort_keys=True))
    trainer = _rl_trainer(dev, RL_PARITY_STEPS, SEED + 62,
                          policy=PointNavActorCritic(image_size=(H, W), rnn_type="GRU"))
    trainer.collect_rollout()
    grad = _rl_grad_vs_cpu(dev, trainer, "policies")
    update_ms = _time_ms(trainer.update_agent, 1, warmup=0)
    _log("policies", f"(b) update_agent {update_ms:.4f} ms ({RL_PARITY_STEPS} steps x "
                     f"{RL_ENVS} envs, CUDA events)")
    return {"launches": launches, "loop_steps": loop_steps, "wall_s": wall, "metrics": agg,
            "step_ms": step_ms, "peak_gib": peak, "vs_cpu": errs, "grad_vs_cpu": grad,
            "update_ms": update_ms}


def _policies_baseline(dev, card, base):
    """(c) The SimpleCNN + GRU baseline through the CLI: train, a rollout
    step against the CPU, eval from its checkpoint, its step against the
    CPU, and an agent episode."""
    import torch

    from pointnav_vo_tpu_torch import engines
    from pointnav_vo_tpu_torch.config.defaults import get_rl_config
    from pointnav_vo_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
    from pointnav_vo_tpu_torch.io.weights import POLICY_PREFIX, load_policy_checkpoint
    from pointnav_vo_tpu_torch.ops import topdown_kernels as tk
    from pointnav_vo_tpu_torch.rl.eval import Evaluator, fused_vo_act_step
    from pointnav_vo_tpu_torch.utils import registry
    from pointnav_vo_tpu_torch.vo.ensemble import VOEnsemble

    opts = ["RL.Policy.name", "pointnav_baseline_policy"]
    _reset_peak(dev)
    trainer, wall, launches = _cli(["--run-type", "train", *base, *opts,
                                    "NUM_UPDATES", str(POLICY_UPDATES)])
    peak = _peak_gib(dev)
    expected = POLICY_UPDATES * RL_STEPS + 1
    if launches != expected or trainer.model.num_packed_hidden != 1:
        raise AssertionError(f"policies (c): {launches} bin_counts launches in training "
                             f"(expected {expected})")
    rollout_ms = _time_ms(trainer.collect_rollout, 1, warmup=0) / RL_STEPS
    train_errs = _rl_step_vs_cpu(dev, trainer, "policies")
    update_ms = _time_ms(trainer.update_agent, 1, warmup=0)
    _log("policies", f"(c) SimpleCNN + GRU baseline: train {POLICY_UPDATES} updates through "
                     f"the CLI in {wall:.3f} s, bin_counts launches {launches}, rollout step "
                     f"{rollout_ms:.4f} ms, update_agent {update_ms:.4f} ms (CUDA events), "
                     f"peak {peak:.3f} GiB on {card}")

    root = base[base.index("--log-root") + 1]
    ckpt_dir = os.path.join(glob.glob(os.path.join(root, "rl-train-*"))[0], "checkpoints")
    ckpt = os.path.join(ckpt_dir, sorted(os.listdir(ckpt_dir))[-1])
    # the STOP logit lowered, so the eval's episodes run (a port checkpoint still)
    state = load_checkpoint(ckpt)
    state["state_dict"][POLICY_PREFIX + "action_distribution.linear.bias"][0] = AGENT_STOP_BIAS
    save_checkpoint(ckpt, state)
    runs = []
    real_run = Evaluator.run

    def counted_run(self, num_episodes, **kw):
        before = tk.launch_counts["bin_counts"]
        out = real_run(self, num_episodes, **kw)
        runs.append((tk.launch_counts["bin_counts"] - before,
                     max(r.steps for r in self.results)))
        return out

    Evaluator.run = counted_run
    try:
        metrics, eval_wall, eval_launches = _cli(
            ["--run-type", "eval", *base, *opts, "EVAL.EVAL_CKPT_PATH", ckpt,
             "EVAL.TEST_EPISODE_COUNT", str(CLI_EVAL_EPISODES),
             "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", str(CLI_EVAL_CAP)])
    finally:
        Evaluator.run = real_run
    if (len(runs) != 1 or eval_launches != runs[0][1] + 1
            or metrics["episodes"] != CLI_EVAL_EPISODES
            or not all(np.isfinite(v) for v in metrics.values())):
        raise AssertionError(f"policies (c) eval: {eval_launches} launches over {runs} "
                             f"(expected steps + 1); {metrics}")
    _log("policies", f"(c) eval from {os.path.basename(ckpt)}: {runs[0][1]} steps in "
                     f"{eval_wall:.3f} s, bin_counts launches {eval_launches}; "
                     + json.dumps(metrics, sort_keys=True))

    # the checkpoint's policy and the engine's experts, card against CPU
    config = get_rl_config([RL_CONFIG], [*opts, "VO.REGRESS_MODEL.pretrained", "False"])
    policy = registry.get_policy(config.RL.Policy.name)(config)
    policy.load_state_dict(load_policy_checkpoint(ckpt), strict=True)
    cpu_policy = copy.deepcopy(policy).eval()
    policy = policy.to(dev).eval()
    vo = engines._build_vo_ensemble(config, dev)
    cpu_vo = VOEnsemble(vo.cfg, experts=[copy.deepcopy(m).cpu() for m in vo.experts],
                        device="cpu")
    obs0, obs1, actions = _zoo_frames(N_ENVS, SEED + 63)
    args = _fused_inputs(obs0, obs1, actions, dev, vo.cfg, policy)
    step_ms = _time_ms(lambda: fused_vo_act_step(policy, vo, **args), iters=10)
    eval_errs = _compare_step(fused_vo_act_step(policy, vo, **args), fused_vo_act_step(
        cpu_policy, cpu_vo, **_fused_inputs(obs0, obs1, actions, torch.device("cpu"), vo.cfg,
                                            cpu_policy)))
    _log("policies", f"(c) fused step at {N_ENVS} envs from the checkpoint {step_ms:.4f} ms "
                     "(CUDA events); card vs CPU (rtol 1e-3, atol 1e-4; actions equal): "
                     + json.dumps(eval_errs, sort_keys=True))
    agent = _agent_episode(dev, card, vo, policy, cpu_vo, cpu_policy, SEED + 64, "policies")
    return {"launches": launches, "eval_launches": eval_launches,
            "agent_launches": agent["launches"], "wall_s": wall, "eval_wall_s": eval_wall,
            "rollout_step_ms": rollout_ms, "update_ms": update_ms, "peak_gib": peak,
            "step_vs_cpu": train_errs, "eval_metrics": metrics, "eval_step_ms": step_ms,
            "eval_vs_cpu": eval_errs, "agent": agent}


def _synthetic_matches(n, seed):
    """Packed matched point sets as ``ClassicalVO.match`` packs them: ``n``
    envs of 8-500 points each, a known motion, 1 mm of noise, padded with
    garbage at weight 0; the actions and the motions."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(KABSCH_POINTS[0], KABSCH_POINTS[1] + 1, n)
    counts[:2] = KABSCH_POINTS
    k = int(counts.max())
    packed = rng.normal(0, 5, (n, 7, k)).astype(np.float32)
    packed[:, 6] = 0.0
    motions = np.stack([rng.uniform(-0.05, 0.05, n), rng.uniform(-0.3, 0.0, n),
                        rng.uniform(-0.6, 0.6, n)], axis=1)
    for i, c in enumerate(counts):
        dx, dz, dyaw = motions[i]
        co, si = np.cos(dyaw), np.sin(dyaw)
        r = np.asarray([[co, 0, si], [0, 1, 0], [-si, 0, co]])
        prev = rng.uniform(-2, 2, (3, c))
        prev[2] -= 3.0
        packed[i, 0:3, :c] = prev
        packed[i, 3:6, :c] = r.T @ (prev - np.asarray([[dx], [0.0], [dz]])) + rng.normal(
            0, 1e-3, (3, c))
        packed[i, 6, :c] = 1.0
    return packed, rng.integers(1, 4, n), motions


def _policies_classical(dev, card):
    """(d) Phase 3's eval with ``VO.VO_TYPE CLASSICAL`` through
    ``engines.py``: no ``bin_counts``, the accepted share, host and device
    ms a step; the batched Kabsch card against CPU on synthetic sets."""
    import torch

    from pointnav_vo_tpu_torch import engines
    from pointnav_vo_tpu_torch.config.defaults import get_rl_config
    from pointnav_vo_tpu_torch.io.weights import seeded_init_
    from pointnav_vo_tpu_torch.ops import topdown_kernels as tk
    from pointnav_vo_tpu_torch.rl.eval import Evaluator
    from pointnav_vo_tpu_torch.utils import registry

    config = get_rl_config([RL_CONFIG], [
        "NUM_PROCESSES", str(N_ENVS), "SEED", str(SEED), "VO.USE_VO_MODEL", "True",
        "VO.VO_TYPE", "CLASSICAL", "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", "20"])
    policy = registry.get_policy(config.RL.Policy.name)(config)
    seeded_init_(policy, torch.Generator().manual_seed(SEED + 70))
    with torch.no_grad():  # STOP disfavoured: the episodes run to the cap
        policy.action_distribution.linear.bias[0] = AGENT_STOP_BIAS
    if engines._build_vo_ensemble(config, dev) is not None:
        raise AssertionError("policies (d): VO_TYPE CLASSICAL built a VO ensemble")
    vo_fn = engines._build_classical_vo_fn(config, dev)
    envs = registry.get_env(config.ENV_NAME)(config, N_ENVS, seed=SEED + 70)
    ev = Evaluator(model=policy.to(dev).eval(), envs=envs, vo_fn=vo_fn, device=dev)
    _reset_peak(dev)
    tk.reset_launch_counts()
    t0 = time.perf_counter()
    agg = ev.run(N_ENVS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = tk.launch_counts["bin_counts"]
    peak = _peak_gib(dev)
    envs.close()
    loop_steps = max(r.steps for r in ev.results)
    accepted = int(vo_fn.accepted)
    if (launches != 0 or agg["episodes"] != N_ENVS
            or not all(np.isfinite(v) for v in agg.values())
            or vo_fn.env_steps != loop_steps * N_ENVS):
        raise AssertionError(f"policies (d): {launches} bin_counts launches (expected 0), "
                             f"{vo_fn.env_steps} env steps matched; {agg}")
    host_ms = vo_fn.host_s * 1e3 / loop_steps
    _log("policies", f"(d) classical VO eval of {N_ENVS} envs: {loop_steps} steps in "
                     f"{wall:.3f} s, bin_counts launches {launches}; env-steps matched "
                     f"{vo_fn.matched} and accepted {accepted} of {vo_fn.env_steps} (share "
                     f"accepted {accepted / vo_fn.env_steps:.4f}, the rest the action prior); "
                     f"host ORB + matching {host_ms:.4f} ms a step (host clock), peak "
                     f"{peak:.3f} GiB on {card}; " + json.dumps(agg, sort_keys=True))

    from pointnav_vo_tpu_torch.vo.classical import make_classical_vo_fn

    packed, acts, motions = _synthetic_matches(KABSCH_ENVS, SEED + 71)
    got = vo_fn.solve(packed, acts)
    want = make_classical_vo_fn(device="cpu", max_residual=vo_fn.max_residual).solve(
        packed, acts)
    errs = {}
    for name, g, w in zip(("delta", "std", "accepted"), got, want):
        g = g.cpu()
        errs[name] = float((g.double() - w.double()).abs().max())
        ok = torch.equal(g, w) if name == "accepted" else torch.allclose(g, w, rtol=1e-4,
                                                                         atol=1e-5)
        if not ok:
            raise AssertionError(f"policies (d): batched Kabsch {name}, card vs CPU: max abs "
                                 f"err {errs[name]}")
    truth_err = float(np.abs(got[0].cpu().numpy() - motions).max())
    if not bool(got[2].all()) or truth_err > 1e-2:
        raise AssertionError(f"policies (d): synthetic sets not all accepted, or the deltas "
                             f"{truth_err} from the known motions")
    device_ms = _time_ms(lambda: vo_fn.solve(packed, acts), iters=20)
    _log("policies", f"(d) batched weighted Kabsch, {KABSCH_ENVS} envs of "
                     f"{KABSCH_POINTS[0]}-{KABSCH_POINTS[1]} points: card vs CPU (rtol 1e-4, "
                     f"atol 1e-5; acceptance equal) {json.dumps(errs)}, max abs err from the "
                     f"known motions {truth_err:.3g}; solve {device_ms:.4f} ms a step (upload, "
                     "SVD, gate; CUDA events)")
    return {"launches": launches, "loop_steps": loop_steps, "wall_s": wall, "metrics": agg,
            "env_steps": vo_fn.env_steps, "matched": vo_fn.matched, "accepted": accepted,
            "host_ms": host_ms, "device_ms": device_ms, "peak_gib": peak,
            "kabsch_vs_cpu": errs, "kabsch_vs_truth": truth_err}


def phase_policies(dev, card):
    """Phase 13: the policy family and the classical backend at full width,
    fp32, TF32 off, seeded weights."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="chip_smoke_policies_")

    def base(sub):
        # seeded experts: the published .pth files are not in the repo
        return ["--task-type", "rl", "--exp-config", RL_CONFIG, "--log-root",
                os.path.join(root, sub), "--device", str(dev),
                "VO.REGRESS_MODEL.pretrained", "False"]

    try:
        rgbd = _policies_rgbd(dev, card, base("rgbd"))
        gru = _policies_gru(dev, card)
        baseline = _policies_baseline(dev, card, base("baseline"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    classical = _policies_classical(dev, card)
    return {"rgbd": rgbd, "gru": gru, "baseline": baseline, "classical": classical}


def _flat(tensors):
    import torch

    return torch.cat([t.detach().reshape(-1).float() for t in tensors])


def _equal_to_rank_0(tensors):
    """Whether this rank's ``tensors`` are bit-equal to rank 0's (rank 0's
    broadcast: gloo moves CUDA tensors by broadcast and all-reduce only)."""
    import torch
    import torch.distributed as td

    mine = torch.cat([t.detach().reshape(-1).view(torch.uint8) for t in tensors])
    ref = mine.clone()
    td.broadcast(ref, 0)
    return bool(torch.equal(mine, ref))


def _storage_fields(rollouts):
    return ([rollouts.observations[k] for k in sorted(rollouts.observations)]
            + [getattr(rollouts, f) for f in ("hidden_states", "rewards", "value_preds",
                                              "returns", "action_log_probs", "actions",
                                              "prev_actions", "masks")])


def _concat_storage(parts):
    """Ranks' rollout storages as one over all their envs, in rank order."""
    import torch

    from pointnav_vo_tpu_torch.rl.rollout import RolloutStorage

    first = parts[0]
    fields = {f.name: getattr(first, f.name) for f in dataclasses.fields(first)}
    out = {}
    for name, v in fields.items():
        if name == "observations":
            out[name] = {k: torch.cat([p.observations[k] for p in parts], 1) for k in v}
        else:
            axis = 2 if name == "hidden_states" else 1
            out[name] = torch.cat([getattr(p, name) for p in parts], axis)
    return RolloutStorage(**out)


def _grads_close(got, want):
    """The largest error of each gradient over its tensor's max abs."""
    return max(float((g - w).abs().max()) / (float(w.abs().max()) + 1e-12)
               for g, w in zip(got, want))


def _params_gate(got, want, grads, lr, steps):
    """Adam's first steps move a weight by about lr sign(g) each: (the
    largest error, the largest error where every step's gradient exceeds
    1e-2 of its tensor's max abs, so its sign is certain); gates 2 lr a
    step and 1e-6."""
    import torch

    worst = strong_worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        err = (g.detach() - w.detach()).abs()
        strong = torch.ones_like(err, dtype=torch.bool)
        for step in grads:
            strong &= step[i].abs() > 1e-2 * step[i].abs().max()
        worst = max(worst, float(err.max()))
        if strong.any():
            strong_worst = max(strong_worst, float(err[strong].max()))
    ok = worst <= 2 * lr * steps and strong_worst <= 1e-6
    return ok, worst, strong_worst


def _dist_rl(group, root):
    """Phase 14 (a) and (b) in one rank: the train CLI over the ranks, then
    the first update again on one rank."""
    import torch
    import torch.distributed as td

    from pointnav_vo_tpu_torch import run
    from pointnav_vo_tpu_torch.io.checkpoint import AsyncCheckpointWriter
    from pointnav_vo_tpu_torch.models.running_mean_var import set_stats_group
    from pointnav_vo_tpu_torch.ops import topdown_kernels as tk
    from pointnav_vo_tpu_torch.rl import ppo
    from pointnav_vo_tpu_torch.rl import trainer as tr

    dev = group.device
    first, equal, reduce_s, update_s, saves, in_update = {}, [], [], [], [0], [False]
    real_update, real_reduce, real_save = tr.ppo_update, group.all_reduce_, \
        AsyncCheckpointWriter.save

    def timed_reduce(tensors, op="sum"):
        if not in_update[0]:
            return real_reduce(tensors, op)
        tensors = list(tensors)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = real_reduce(tensors, op)
        torch.cuda.synchronize(dev)
        reduce_s[-1] += time.perf_counter() - t0
        if not first.get("done") and len(tensors) == first["n_params"]:
            first["grads"].append([t.clone() for t in tensors])  # a minibatch's mean gradients
        return out

    def update(model, cfg, optimizer, rollouts, order=None, generator=None, clip_param=None):
        order = ppo.minibatch_order(cfg, rollouts.num_envs, generator)
        if not first:
            first.update(rollouts=_concat_storage([rollouts]), order=order.clone(),
                         state={k: v.clone() for k, v in model.state_dict().items()},
                         opt=copy.deepcopy(optimizer.state_dict()), grads=[],
                         n_params=len(optimizer.params), clip=clip_param, cfg=cfg,
                         total_updates=optimizer.decay_steps)
        reduce_s.append(0.0)
        in_update[0] = True
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        stats = real_update(model, cfg, optimizer, rollouts, order=order, clip_param=clip_param)
        torch.cuda.synchronize(dev)
        update_s.append(time.perf_counter() - t0)
        in_update[0] = False
        first["done"] = True
        first.setdefault("stats", {k: float(v) for k, v in stats.items()})
        first.setdefault("params", [p.detach().clone() for p in optimizer.params])
        equal.append(_equal_to_rank_0(list(model.parameters())))
        return stats

    def counted_save(self, path, state):
        saves[0] += 1
        return real_save(self, path, state)

    args = run.build_parser().parse_args([
        "--task-type", "rl", "--run-type", "train", "--exp-config", RL_CONFIG,
        "--log-root", root, "--n-devices", str(group.world),
        "VO.REGRESS_MODEL.pretrained", "False", "NUM_PROCESSES", str(DIST_RL_ENVS),
        "NUM_UPDATES", str(RL_UPDATES), "CHECKPOINT_INTERVAL", "1", "LOG_INTERVAL", "1"])
    tr.ppo_update, group.all_reduce_, AsyncCheckpointWriter.save = \
        update, timed_reduce, counted_save
    try:
        tk.reset_launch_counts()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        trainer = run.run_exp(args, group)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        launches = tk.launch_counts["bin_counts"]
    finally:
        tr.ppo_update, AsyncCheckpointWriter.save = real_update, real_save
        group.all_reduce_ = real_reduce
    t = trainer.timing
    out = {"launches": launches, "saves": saves[0], "params_equal": equal,
           "count_steps": trainer.count_steps, "wall_s": wall, "timing": dict(t),
           "rollout_step_ms": (t["act"] + t["env"] + t["vo"]) * 1e3 / (RL_UPDATES * RL_STEPS),
           "ppo_update_ms": [x * 1e3 for x in update_s],
           "allreduce_ms": [x * 1e3 for x in reduce_s],
           "allreduce_share": [r / u for r, u in zip(reduce_s, update_s)]}

    # (b) the first update on one rank: every rank's stored rollout, in rank order
    mine = _storage_fields(first["rollouts"])
    parts = [first["rollouts"]]
    for src in range(1, group.world):
        bufs = [x.clone() for x in mine]
        for x in bufs:
            td.broadcast(x, src)
        if group.rank == 0:
            other = _concat_storage([first["rollouts"]])
            for dst, x in zip(_storage_fields(other), bufs):
                dst.copy_(x)
            parts.append(other)
    orders = group.all_gather_object(first["order"].cpu())
    if group.rank == 0:
        n_loc = first["rollouts"].num_envs
        union = torch.cat([o + r * n_loc for r, o in enumerate(orders)], dim=-1).to(dev)
        set_stats_group(trainer.model, None)
        rollouts = _concat_storage(parts)

        def replay():
            one = copy.deepcopy(trainer.model)
            one.load_state_dict(first["state"])
            opt = ppo.make_optimizer(one.parameters(), first["cfg"], first["total_updates"])
            opt.load_state_dict(first["opt"])
            grads, real_step = [], opt.step

            def step():
                grads.append([p.grad.clone() if p.grad is not None else torch.zeros_like(p)
                              for p in opt.params])
                real_step()

            opt.step = step
            stats = ppo.ppo_update(one, first["cfg"], opt, rollouts, order=union,
                                   clip_param=first["clip"])
            return grads, [p.detach().clone() for p in opt.params], stats

        grads, params, stats = replay()
        ok, worst, strong_worst = _params_gate(first["params"], params, first["grads"],
                                               first["cfg"].lr, len(grads))
        out["vs_one_rank"] = {
            "grad_rel_l2": max(_rel_l2(_flat(g), _flat(w)) for g, w in zip(first["grads"], grads)),
            "grad_err": max(_grads_close(g, w) for g, w in zip(first["grads"], grads)),
            "param_max_abs": worst, "param_max_abs_strong": strong_worst, "params_ok": ok,
            "stats": first["stats"], "stats_one_rank": {k: float(v) for k, v in stats.items()},
            "minibatches": len(grads)}
        # the replay again, with the deterministic cuDNN the run used and with
        # cuDNN's default algorithms: the gradient tensors that change
        grads2, params2, _ = replay()
        out["replay_bit_equal"] = (_tensors_differ(grads, grads2) == [0] * len(grads)
                                   and torch.equal(_flat(params), _flat(params2)))
        torch.backends.cudnn.deterministic = False
        try:
            runs = [replay()[0] for _ in range(2)]
        finally:
            torch.backends.cudnn.deterministic = True
        out["replay_nondeterministic_cudnn_grads_differ"] = _tensors_differ(*runs)
    return out


def _tensors_differ(a, b):
    """For each minibatch, the number of gradient tensors not bit-equal
    between two replays."""
    import torch

    return [sum(not torch.equal(x, y) for x, y in zip(ga, gb)) for ga, gb in zip(a, b)]


def _dist_vo(group):
    """Phase 14 (c) in one rank: the joint stage over the ranks, then one
    step against one rank's step on the same global batch."""
    import itertools

    import torch

    from pointnav_vo_tpu_torch.common import TURN_LEFT, TURN_RIGHT
    from pointnav_vo_tpu_torch.io.weights import seeded_init_
    from pointnav_vo_tpu_torch.ops import topdown_kernels as tk
    from pointnav_vo_tpu_torch.rl.envs import EnvConfig
    from pointnav_vo_tpu_torch.vo.dataset import MemoryFramePairs
    from pointnav_vo_tpu_torch.vo.engine import VORegressionEngine, VOTrainConfig
    from pointnav_vo_tpu_torch.vo.ensemble import VOInferenceConfig

    dev = group.device
    # turns alternate, so a batch in entry order gives each rank's block as
    # many samples of every loss group: the mean of the ranks' losses is
    # then the one-rank loss
    turns = itertools.cycle((TURN_LEFT, TURN_RIGHT))
    data = MemoryFramePairs.scripted(DIST_VO_ENTRIES, lambda *_: next(turns), SEED + 40,
                                     twins=True, env_cfg=EnvConfig(image_h=H, image_w=W))
    icfg = VOInferenceConfig(vis_size_h=H, vis_size_w=W)
    g = torch.Generator().manual_seed(SEED + 41)
    experts = [seeded_init_(icfg.make_model(), g) for _ in range(2)]
    tcfg = VOTrainConfig(batch_size=TRAIN_BATCH, action_type=(TURN_LEFT, TURN_RIGHT),
                         geo_invariance_types=("inverse_joint_train",), lr=1.5e-4, seed=SEED)
    engine = VORegressionEngine(icfg, tcfg, data, device=dev,
                                experts=[copy.deepcopy(m) for m in experts], group=group)
    tk.reset_launch_counts()
    epochs = [engine.train_epoch() for _ in range(DIST_VO_EPOCHS)]
    launches = tk.launch_counts["bin_counts"]
    params = [p for m in engine.experts for p in m.parameters()]
    moments = [engine.opt.state[p][k] for p in params for k in ("exp_avg", "exp_avg_sq")]
    buffers = [b for m in engine.experts for b in m.buffers()]
    steps = DIST_VO_EPOCHS * data.num_samples() // TRAIN_BATCH
    out = {"launches": launches, "steps": steps,
           "losses": [e["mean_total_loss"] for e in epochs],
           "frame_pairs_per_s": steps * TRAIN_BATCH / sum(e["epoch_time_s"] for e in epochs),
           "params_equal": _equal_to_rank_0(params), "moments_equal": _equal_to_rank_0(moments),
           "whitening_equal": _equal_to_rank_0(buffers)}

    icfg0 = dataclasses.replace(icfg, dropout_p=0.0)
    batch = next(data.iter_batches(TRAIN_BATCH))
    many = VORegressionEngine(icfg0, tcfg, device=dev, group=group,
                              experts=[copy.deepcopy(m) for m in experts])
    got = many.train_step(batch)
    if group.rank == 0:
        one = VORegressionEngine(icfg0, tcfg, device=dev,
                                 experts=[copy.deepcopy(m) for m in experts])
        want = one.train_step(batch)
        p_many = [p for m in many.experts for p in m.parameters()]
        p_one = [p for m in one.experts for p in m.parameters()]
        g_many = [p.grad for p in p_many]
        ok, worst, strong_worst = _params_gate(p_many, p_one, [g_many], tcfg.lr, 1)
        stats = [(b1, b2) for m1, m2 in zip(many.experts, one.experts)
                 for b1, b2 in zip(m1.buffers(), m2.buffers())]
        g_one = [p.grad for p in p_one]
        out["vs_one_rank"] = {
            "loss": float(got["total_loss"]), "loss_one_rank": float(want["total_loss"]),
            "grad_rel_l2": _rel_l2(_flat(g_many), _flat(g_one)),
            "grad_err": _grads_close(g_many, g_one),
            "whitening_max_abs": max(float((a - b).abs().max()) for a, b in stats),
            "whitening_ok": all(torch.allclose(a, b, rtol=1e-5, atol=1e-7) for a, b in stats),
            "param_max_abs": worst, "param_max_abs_strong": strong_worst, "params_ok": ok}
    return out


def _dist_eval(group):
    """Phase 14 (d) in one rank: phase 3's det eval over the rank's block of
    the envs."""
    import torch

    from pointnav_vo_tpu_torch.ops import topdown_kernels as tk
    from pointnav_vo_tpu_torch.rl.envs import EnvConfig, make_scripted_vector_env
    from pointnav_vo_tpu_torch.rl.eval import Evaluator
    from pointnav_vo_tpu_torch.vo.ensemble import VOInferenceConfig

    dev = group.device
    n_loc = N_ENVS // group.world
    vo, policy, _, _ = _build_models(VOInferenceConfig(vis_size_h=H, vis_size_w=W), dev, SEED)
    envs = make_scripted_vector_env(EnvConfig(image_h=H, image_w=W, max_episode_steps=20),
                                    n_loc, seed=SEED + group.rank * n_loc)
    ev = Evaluator(model=policy, envs=envs, vo_ensemble=vo, device=dev, group=group)
    tk.reset_launch_counts()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    agg = ev.run(N_ENVS)
    wall = time.perf_counter() - t0
    mine = range(group.rank * n_loc, (group.rank + 1) * n_loc)
    # the rank's loop runs until its own envs' episodes have ended
    loop_steps = max(r.steps for r, k in zip(ev.results, ev.episode_keys) if k[0] in mine)
    return {"launches": tk.launch_counts["bin_counts"], "loop_steps": loop_steps, "wall_s": wall,
            "agg": agg, "episodes": [dataclasses.asdict(r) for r in ev.results],
            "keys": ev.episode_keys}


def _dist_rank(group, root):
    """One rank of phase 14; rank 0 returns every rank's record."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # (b) holds the ranks' update against a replay on one rank: cuDNN's
    # default conv algorithms sum the gradients in an order that changes
    # from run to run, which Adam's sign-like first steps amplify
    torch.backends.cudnn.deterministic = True
    t0 = time.perf_counter()
    rec = {"rank": group.rank, "backend": group.backend, "device": str(group.device),
           "rl": _dist_rl(group, root)}
    rec["vo"] = _dist_vo(group)
    rec["eval"] = _dist_eval(group)
    rec["wall_s"] = time.perf_counter() - t0
    return group.all_gather_object(rec)


def phase_dist(dev, card, eval_ref):
    """Data-parallel on one card: DIST_RANKS spawned ranks sharing ``dev``
    (gloo), the RL train CLI, one update against one rank, the VO joint
    stage and phase 3's eval, each checked across the ranks."""
    import shutil
    import tempfile

    from pointnav_vo_tpu_torch.parallel import dist

    root = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    try:
        t0 = time.perf_counter()
        ranks = dist.spawn(_dist_rank, DIST_RANKS, dev, root)
        wall = time.perf_counter() - t0
        ckpts = sorted(os.listdir(os.path.join(
            glob.glob(os.path.join(root, "rl-train-*"))[0], "checkpoints")))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    r0 = ranks[0]
    _log("dist", f"{DIST_RANKS} ranks on {r0['device']}, backend "
                 f"{sorted({r['backend'] for r in ranks})}, wall {wall:.3f} s (spawn included; "
                 f"ranks' own {[round(r['wall_s'], 3) for r in ranks]} s) on {card}")

    # (a) RL train through the CLI
    want = RL_UPDATES * RL_STEPS + 1
    for r in ranks:
        rl = r["rl"]
        if (rl["launches"] != want or not all(rl["params_equal"])
                or len(rl["params_equal"]) != RL_UPDATES
                or rl["saves"] != (RL_UPDATES if r["rank"] == 0 else 0)
                or rl["count_steps"] != RL_UPDATES * RL_STEPS * DIST_RL_ENVS):
            raise AssertionError(f"dist rl, rank {r['rank']}: {json.dumps(rl)}")
    if len(ckpts) != RL_UPDATES:
        raise AssertionError(f"dist rl: checkpoints {ckpts}")
    for r in ranks:
        rl = r["rl"]
        _log("dist", f"(a) rank {r['rank']}: train {RL_UPDATES} updates x {RL_STEPS} steps x "
                     f"{DIST_RL_ENVS // DIST_RANKS} envs, bin_counts launches {rl['launches']}, "
                     f"parameters equal to rank 0's after each update {rl['params_equal']}, "
                     f"checkpoint saves {rl['saves']}; rollout step {rl['rollout_step_ms']:.3f} "
                     f"ms (host clock), each update's ppo_update "
                     f"{[round(x, 3) for x in rl['ppo_update_ms']]} ms and its all-reduces "
                     f"{[round(x, 3) for x in rl['allreduce_ms']]} ms, "
                     f"{[round(100 * x, 2) for x in rl['allreduce_share']]} % (host clock, "
                     f"synchronized before and after each)")
    _log("dist", f"(a) checkpoints {ckpts}")

    # (b) the first update against one rank's on the concatenated rollouts
    b = r0["rl"]["vs_one_rank"]
    stats_ok = all(abs(b["stats"][k] - v) <= 1e-4 * abs(v) + 1e-6
                   for k, v in b["stats_one_rank"].items())
    if not (b["params_ok"] and b["grad_rel_l2"] <= 1e-3 and stats_ok):
        raise AssertionError(f"dist rl vs one rank: {json.dumps(b)}")
    if not r0["rl"]["replay_bit_equal"]:
        raise AssertionError("dist rl: two replays of the first update on one rank with "
                             "deterministic cuDNN differ")
    _log("dist", "(b) the one-rank replay twice with torch.backends.cudnn.deterministic "
                 "(the ranks' setting): gradients and parameters bit-equal; twice with cuDNN's "
                 "default algorithms, gradient tensors that differ per minibatch: "
                 f"{r0['rl']['replay_nondeterministic_cudnn_grads_differ']}")
    _log("dist", "(b) the first update on one rank (both ranks' rollouts, their minibatch "
                 "orders as global env indices) vs the ranks': each minibatch's mean "
                 "gradients within relative L2 1e-3, parameters within 2 lr a step (within 1e-6 "
                 "where every step's gradient exceeds 1e-2 of its max), loss terms rtol 1e-4: "
                 + json.dumps(b, sort_keys=True))

    # (c) the VO joint stage
    steps = r0["vo"]["steps"]
    for r in ranks:
        v = r["vo"]
        if (v["launches"] != 2 * steps or not (v["params_equal"] and v["moments_equal"]
                                               and v["whitening_equal"])
                or not np.all(np.isfinite(v["losses"]))):
            raise AssertionError(f"dist vo, rank {r['rank']}: {json.dumps(v)}")
    c = r0["vo"]["vs_one_rank"]
    if not (c["params_ok"] and c["grad_rel_l2"] <= 1e-3 and c["whitening_ok"]
            and abs(c["loss"] - c["loss_one_rank"]) <= 1e-4 * abs(c["loss_one_rank"])):
        raise AssertionError(f"dist vo vs one rank: {json.dumps(c)}")
    _log("dist", f"(c) joint stage, global batch {TRAIN_BATCH} ({TRAIN_BATCH // DIST_RANKS} a "
                 f"rank), {steps} steps: epoch losses {r0['vo']['losses']}, "
                 f"{r0['vo']['frame_pairs_per_s']:.2f} frame-pairs/s of the whole (host "
                 f"batches included), bin_counts launches per rank "
                 f"{[r['vo']['launches'] for r in ranks]}, parameters, Adam moments and "
                 f"whitening bit-equal across ranks; one step vs one rank (dropout off, loss "
                 f"rtol 1e-4, all gradients within relative L2 1e-3 (the same function summed "
                 f"in another float32 order), whitening rtol 1e-5 / atol 1e-7, "
                 f"parameters as (b)): "
                 + json.dumps(c, sort_keys=True))

    # (d) phase 3's eval against phase 3's one-rank run
    agg, episodes, keys = eval_ref
    e0 = r0["eval"]
    if e0["keys"] != keys:
        raise AssertionError(f"dist eval: episode set {e0['keys']} != one rank's {keys}")
    for r in ranks:
        if r["eval"]["launches"] != r["eval"]["loop_steps"] + 1:
            raise AssertionError(f"dist eval, rank {r['rank']}: {r['eval']['launches']} "
                                 f"launches over {r['eval']['loop_steps']} steps")
    for got, ref in zip(e0["episodes"], episodes, strict=True):
        for k, v in ref.items():
            if isinstance(v, float) and np.isnan(v):
                bad = not np.isnan(got[k])
            elif isinstance(v, float):
                bad = abs(got[k] - v) > 1e-4 * abs(v) + 1e-5
            else:
                bad = got[k] != v
            if bad:
                raise AssertionError(f"dist eval: episode {got} != one rank's {ref}")
    for k, v in agg.items():
        if not k.startswith("time_") and abs(e0["agg"][k] - v) > 1e-4 * abs(v) + 1e-5:
            raise AssertionError(f"dist eval: {k} {e0['agg'][k]} != one rank's {v}")
    _log("dist", f"(d) det eval over {N_ENVS} envs ({N_ENVS // DIST_RANKS} a rank): the "
                 f"one-rank run's {len(keys)} episodes exactly, per-episode records and "
                 f"aggregates within rtol 1e-4 / atol 1e-5; per rank loop steps "
                 f"{[r['eval']['loop_steps'] for r in ranks]}, bin_counts launches "
                 f"{[r['eval']['launches'] for r in ranks]}, wall "
                 f"{[round(r['eval']['wall_s'], 3) for r in ranks]} s")
    return {"ranks": DIST_RANKS, "backend": r0["backend"], "wall_s": wall,
            "checkpoints": ckpts,
            "rl": [{k: v for k, v in r["rl"].items()} for r in ranks],
            "vo": [r["vo"] for r in ranks],
            "eval": [{k: r["eval"][k] for k in ("launches", "loop_steps", "wall_s")}
                     for r in ranks],
            "eval_agg": e0["agg"],
            "launches": {"train_rl": sum(r["rl"]["launches"] for r in ranks),
                         "train_vo": sum(r["vo"]["launches"] for r in ranks),
                         "eval": sum(r["eval"]["launches"] for r in ranks)}}


def _grad_groups(experts):
    """``{group: [grad, ...]}``: each top-level module, and each stage of
    the encoder's backbone and its compression (``visual_encoder.backbone.
    layer1``, ...)."""
    out = {}
    for m in experts:
        for name, p in m.named_parameters():
            parts = name.split(".")
            for key in {parts[0], ".".join(parts[:3]) if parts[0] == "visual_encoder" else None}:
                if key:
                    out.setdefault(key, []).append(p.grad)
    return out


def _diag_parity(dev, icfg, tcfg, batch, reader, experts):
    """From the same weights on the card, the CPU and the CPU in float64:
    ``grad_snapshot`` card vs CPU (relative L2 5e-2 a tensor), then one
    step at batch 8 with ``log_grad``: its norms card vs CPU (rtol
    DIAG_NORM_RTOL) and each group's gradient distance from float64 on
    both sides (printed, not gated)."""
    import torch

    from pointnav_vo_tpu_torch.vo.engine import VORegressionEngine

    runs = {}
    for name, device, dtype in (("card", dev, torch.float32),
                                ("cpu", torch.device("cpu"), torch.float32),
                                ("cpu64", torch.device("cpu"), torch.float64)):
        engine = VORegressionEngine(icfg, tcfg, reader, device=device,
                                    experts=[copy.deepcopy(m).to(dtype) for m in experts])
        # the snapshot first, on the weights both sides share: after a step,
        # Adam's first update (about lr sign(g)) flips where |g| is rounding
        snap = engine.grad_snapshot() if dtype == torch.float32 else None
        metrics = engine.train_step(batch)
        runs[name] = ({k: float(v) for k, v in metrics.items() if k.startswith("grad/")},
                      _grad_groups(engine.experts), snap)
    (n_card, g_card, s_card), (n_cpu, g_cpu, s_cpu), (_, g64, _) = runs.values()
    norm_err = {k: abs(n_card[k] - v) / abs(v) for k, v in n_cpu.items()}
    if set(n_card) != set(n_cpu) or len(n_cpu) != 4 or max(norm_err.values()) > DIAG_NORM_RTOL:
        raise AssertionError(f"grad/* norms card vs CPU: {n_card} vs {n_cpu}")
    snap_err = {k: _rel_l2(torch.from_numpy(v), torch.from_numpy(s_cpu[k]))
                for k, v in s_card.items()}
    if set(s_card) != set(s_cpu) or max(snap_err.values()) > 5e-2:
        raise AssertionError(f"grad_snapshot card vs CPU: {snap_err}")

    def flat(grads):
        return torch.cat([g.detach().flatten().cpu().double() for g in grads])

    fp64 = {k: {"card": _rel_l2(flat(g_card[k]), flat(v)), "cpu": _rel_l2(flat(g_cpu[k]), flat(v))}
            for k, v in sorted(g64.items())}
    _log("diag", f"B={batch.actions.shape[0]} log_grad step, card vs CPU: grad/* norms "
                 f"{json.dumps(n_card)} (worst relative error {max(norm_err.values()):.3e}, gate "
                 f"{DIAG_NORM_RTOL}); grad_snapshot worst tensor relative L2 "
                 f"{max(snap_err.values()):.3e} over {len(snap_err)} tensors (gate 5e-2)")
    _log("diag", "gradient relative L2 from the float64 step, by module (card, CPU; not gated): "
                 + json.dumps({k: [float(f"{v['card']:.3e}"), float(f"{v['cpu']:.3e}")]
                               for k, v in fp64.items()}))
    return {"norms_card": n_card, "norms_cpu": n_cpu, "norm_rel_err": norm_err,
            "snapshot_worst_rel_l2": max(snap_err.values()), "fp64_rel_l2": fp64}


def _high_res_ops(backbone, x, rec):
    """The stem, its max-pool, layer1 and layer2 of a basic-block GN ResNet
    op by op, each op applied through ``rec(kind, name, module, *inputs)``;
    returns layer2's output."""
    x = rec("conv", "stem.conv", backbone.conv1[0], x)
    x = rec("gn", "stem.gn", backbone.conv1[1], x)
    x = rec("relu", "stem.relu", None, x)
    x = rec("maxpool", "stem.maxpool", backbone.maxpool, x)
    for stage in ("layer1", "layer2"):
        for i, blk in enumerate(getattr(backbone, stage)):
            p = f"{stage}.{i}"
            y = rec("conv", f"{p}.conv1", blk.convs[0], x)
            y = rec("gn", f"{p}.gn1", blk.convs[1], y)
            y = rec("relu", f"{p}.relu1", None, y)
            y = rec("conv", f"{p}.conv2", blk.convs[3], y)
            y = rec("gn", f"{p}.gn2", blk.convs[4], y)
            r = x
            if blk.downsample is not None:
                r = rec("conv", f"{p}.down_conv", blk.downsample[0], x)
                r = rec("gn", f"{p}.down_gn", blk.downsample[1], r)
            x = rec("relu", f"{p}.relu2", None, rec("add", f"{p}.add", None, y, r))
    return x


def _apply_op(kind, m, inputs, params):
    import torch.nn.functional as F

    if kind == "conv":
        return F.conv2d(inputs[0], params[0], None, m.stride, m.padding, m.dilation, m.groups)
    if kind == "gn":
        return F.group_norm(inputs[0], m.num_groups, params[0], params[1], m.eps)
    if kind == "maxpool":
        return F.max_pool2d(inputs[0], m.kernel_size, m.stride, m.padding)
    if kind == "relu":
        return F.relu(inputs[0])
    return inputs[0] + inputs[1]


def _op_params(kind, m):
    return [] if m is None or kind == "maxpool" else list(m.parameters())


def _op_grads(kind, m, inputs, g, device, dtype, flags):
    """The op alone: its output (``out``) and the gradients of its inputs
    and parameters given the upstream gradient ``g``, on ``device`` in
    ``dtype`` under the cuDNN ``flags``."""
    import torch

    ins = [t.to(device, dtype).requires_grad_() for t in inputs]
    params = [p.detach().to(device, dtype).requires_grad_() for p in _op_params(kind, m)]
    with torch.backends.cudnn.flags(**flags):
        out = _apply_op(kind, m, ins, params)
        grads = torch.autograd.grad(out, ins + params, g.to(device, dtype))
    names = [f"d{k}" for k in ("x", "y")[:len(ins)]] + ["dw", "db"][:len(params)]
    return {"out": out.detach(), **dict(zip(names, grads))}


def _grad_fault_by_op(dev, card, icfg, tcfg, batch, reader, experts, step_batches):
    """The card's float32 VO-gradient fault run down (phase 15 (a)).

    1. End to end: one joint-stage train step at batch ``batch`` (dropout
       off) in float32 on the card under each of :data:`CUDNN_SETTINGS`, on
       the CPU, and in float64 on the card and on the CPU; each of the
       stem's, layer1's and layer2's gradients (all their parameters, both
       experts) as a relative L2 distance from float64 on the same device.
    2. By operation: the float64 card step's tape through the stem, the
       max-pool, layer1 and layer2 of the first expert (each op's inputs
       and upstream gradient, rounded to float32), then each op's backward
       alone in float32, on the card under each setting and on the CPU,
       against the same op in float64 on the same rounded inputs and
       device: its forward output, the conv's input and weight gradients,
       GroupNorm's input, weight and bias gradients, ReLU's, the max-pool's
       and the residual add's.  The op's own rounding is all that differs.
    3. Cost: the float32 joint step at TRAIN_BATCH under each setting, CUDA
       events over DIAG_STEPS steps.

    TF32 is off throughout.  Returns the record and the setting that
    brings all three stages within 1.5x of the CPU's own float32 distance
    from float64 at under 10 % of the default step's time (None where none
    does)."""
    import torch

    from pointnav_vo_tpu_torch.vo.engine import (VORegressionEngine, batch_to_device,
                                                 obs_pairs_from_batch)

    stages = ("conv1", "layer1", "layer2")

    def stage_grads(engine):
        out = {s: [] for s in stages}
        for m in engine.experts:
            for name, p in m.named_parameters():
                parts = name.split(".")
                if parts[:2] == ["visual_encoder", "backbone"] and parts[2] in out:
                    out[parts[2]].append(p.grad.detach().flatten().cpu().double())
        return {s: torch.cat(v) for s, v in out.items()}

    def step(device, dtype, flags):
        engine = VORegressionEngine(icfg, tcfg, reader, device=device,
                                    experts=[copy.deepcopy(m).to(dtype) for m in experts])
        with torch.backends.cudnn.flags(**flags):
            engine.train_step(batch)
        return stage_grads(engine)

    base = dict(enabled=True, benchmark=False, deterministic=False, allow_tf32=False)
    g64 = {"card": step(dev, torch.float64, base), "cpu": step(torch.device("cpu"),
                                                               torch.float64, base)}
    e2e = {"cpu": {s: _rel_l2(v, g64["cpu"][s])
                   for s, v in step(torch.device("cpu"), torch.float32, base).items()}}
    for name, flags in CUDNN_SETTINGS:
        got = step(dev, torch.float32, {**base, **flags})
        e2e[name] = {s: {"vs_card64": _rel_l2(v, g64["card"][s]),
                         "vs_cpu64": _rel_l2(v, g64["cpu"][s])} for s, v in got.items()}
    e2e["card64_vs_cpu64"] = {s: _rel_l2(g64["card"][s], g64["cpu"][s]) for s in stages}

    # the tape: the first expert's float64 step on the card, op by op
    model = copy.deepcopy(experts[0]).double().to(dev)
    tape = []

    def rec(kind, name, m, *inputs):
        out = _apply_op(kind, m, inputs, _op_params(kind, m))
        out.retain_grad()
        tape.append((kind, name, m, [t.detach().float().double() for t in inputs], out))
        return out

    arrs = batch_to_device(batch, dev)
    enc = model.visual_encoder
    with torch.backends.cudnn.flags(**base):
        x0 = enc.running_mean_and_var(obs_pairs_from_batch(arrs, icfg).permute(0, 3, 1, 2),
                                      True, dtype=torch.float64)
        x = _high_res_ops(enc.backbone, x0, rec)
        feats = enc.compression(enc.backbone.layer4(enc.backbone.layer3(x))).flatten(1)
        pred = model.trunk(feats)
        gt = torch.as_tensor(batch.gt_delta, device=dev, dtype=torch.float64)
        (0.5 * (pred - gt).square().sum(-1).mean()).backward()
    # per op: {output or gradient: [relative L2 under each of CUDNN_SETTINGS
    # on the card, then on the CPU]}
    by_op = {}
    for kind, name, m, inputs, out in tape:
        g = out.grad.float().double()
        row = {}
        for device, settings in ((dev, CUDNN_SETTINGS), (torch.device("cpu"), (("cpu", {}),))):
            ref = _op_grads(kind, m, inputs, g, device, torch.float64, base)
            for _sname, flags in settings:
                got = _op_grads(kind, m, inputs, g, device, torch.float32, {**base, **flags})
                for k, v in got.items():
                    row.setdefault(k, []).append(float(f"{_rel_l2(v, ref[k]):.4g}"))
        by_op[name] = row
    del tape

    # the cost: the joint step at TRAIN_BATCH under each setting
    step_ms = {}
    tc = dataclasses.replace(tcfg, batch_size=TRAIN_BATCH, log_grad=False)
    for sname, flags in CUDNN_SETTINGS:
        eng = VORegressionEngine(icfg, tc, reader, device=dev,
                                 experts=[copy.deepcopy(m) for m in experts])
        with torch.backends.cudnn.flags(**{**base, **flags}):
            eng.train_step(step_batches[-1])  # warm-up (benchmark: the search)
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
            for i in range(DIAG_STEPS):
                eng.train_step(step_batches[i % len(step_batches)])
            end.record()
            torch.cuda.synchronize()
        step_ms[sname] = start.elapsed_time(end) / DIAG_STEPS

    repaired = next((s for s, _ in CUDNN_SETTINGS
                     if step_ms[s] < 1.1 * step_ms["default"]
                     and all(e2e[s][t]["vs_card64"] <= 1.5 * e2e["cpu"][t] for t in stages)),
                    None)
    cpu = [float(f"{e2e['cpu'][t]:.3e}") for t in stages]
    _log("diag", f"float32 VO gradients, B={batch.actions.shape[0]} joint step, relative L2 "
                 f"from float64 on the same device (stem, layer1, layer2): CPU {cpu}; "
                 + "; ".join(
                     f"card {s} " + json.dumps([float(f"{e2e[s][t]['vs_card64']:.3e}")
                                                for t in stages])
                     for s, _ in CUDNN_SETTINGS)
                 + f"; card float64 vs CPU float64 {json.dumps(e2e['card64_vs_cpu64'])}")
    _log("diag", "each op alone, float32 against float64 on the same rounded inputs, relative "
                 "L2 of its output and gradients, [card " + ", ".join(
                     s for s, _ in CUDNN_SETTINGS) + ", CPU]:")
    for name, row in by_op.items():
        _log("diag", f"  {name:18s} " + "; ".join(
            f"{k} " + " ".join(f"{x:.2e}" for x in v) for k, v in row.items()))
    # the op whose own float32 rounding on the card (default algorithms)
    # most exceeds the CPU's
    ratio, worst = max((v[0] / v[-1], f"{name} {k}") for name, row in by_op.items()
                       for k, v in row.items() if v[-1] > 0)
    _log("diag", f"the card's default rounding most exceeds the CPU's at {worst}: "
                 f"{ratio:.2f}x")
    _log("diag", f"joint step B={TRAIN_BATCH} float32 ms by cuDNN setting (CUDA events, "
                 f"{DIAG_STEPS} steps): {json.dumps(step_ms)}; the setting that repairs the "
                 f"three stages within 1.5x of the CPU at under +10 %: {repaired} on {card}")
    return {"end_to_end": e2e, "by_op": by_op, "worst_op": [worst, ratio], "step_ms": step_ms,
            "repaired_by": repaired}


def _diag_run(engine, batches, on):
    """DIAG_STEPS steps cycling over ``batches``, each timed with CUDA
    events; with ``on`` every step's ``grad/*`` metrics present and finite,
    then both snapshots.  Launch counts are exact."""
    import torch

    from pointnav_vo_tpu_torch.ops import topdown_kernels as tk

    engine.train_step(batches[-1])  # warm-up, not counted
    torch.cuda.synchronize()
    tk.reset_launch_counts()
    step_ms, norms = [], []
    for i in range(DIAG_STEPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = engine.train_step(batches[i % len(batches)])
        end.record()
        norms.append({k: v for k, v in metrics.items() if k.startswith("grad/")})
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
    launches = {"steps": tk.launch_counts["bin_counts"]}
    if launches["steps"] != 2 * DIAG_STEPS:
        raise AssertionError(f"diag on={on}: {launches['steps']} launches over {DIAG_STEPS} "
                             "steps; expected 2 a step")
    want = {"grad/global_norm", "grad/visual_encoder_norm", "grad/visual_fc_norm",
            "grad/output_head_norm"} if on else set()
    bad = [i for i, n in enumerate(norms) if set(n) != want
           or not all(bool(torch.isfinite(v)) and float(v) > 0 for v in n.values())]
    if bad:
        raise AssertionError(f"diag on={on}: grad/* metrics of steps {bad}: {norms[bad[0]]}")
    if on:
        for name in ("grad_snapshot", "obs_snapshot"):
            tk.reset_launch_counts()
            snap = getattr(engine, name)()
            launches[name] = tk.launch_counts["bin_counts"]
            if launches[name] != 2 or not all(np.isfinite(v).all() for v in snap.values()):
                raise AssertionError(f"{name}: {launches[name]} launches; expected 2")
    return {"step_ms": float(np.mean(step_ms)), "step_ms_each": step_ms, "launches": launches,
            "last_norms": {k: float(v) for k, v in norms[-1].items()}}


def _image_shares(pairs):
    """(is_rgb, card, CPU) images of one transform, each cast as the
    generator casts it: rgb within 1, depth within 1 float16 ulp; returns
    the shares off, checked against phase 15 (c)'s bounds."""
    rgb_off = depth_off = n_rgb = n_depth = 0
    for is_rgb, a, b in pairs:
        if is_rgb:
            d = np.abs(a.astype(np.uint8).astype(np.int16) - b.astype(np.uint8).astype(np.int16))
            if d.max() > 1:
                raise AssertionError(f"rollout rgb {d.max()} off card vs CPU")
            rgb_off, n_rgb = rgb_off + int((d > 0).sum()), n_rgb + d.size
        else:
            a16, b16 = a.astype(np.float16), b.astype(np.float16)
            d = np.abs(a16.astype(np.float32) - b16.astype(np.float32))
            if (d > np.spacing(np.abs(b16)).astype(np.float32)).any():
                raise AssertionError("rollout depth more than 1 float16 ulp off card vs CPU")
            depth_off, n_depth = depth_off + int((d > 0).sum()), n_depth + d.size
    shares = {"rgb_off_by_one": rgb_off / n_rgb, "depth_off_by_ulp": depth_off / n_depth}
    if (shares["rgb_off_by_one"] > GEN_RGB_OFF_BY_ONE
            or shares["depth_off_by_ulp"] > GEN_DEPTH_OFF_BY_ULP):
        raise AssertionError(f"rollout card vs CPU transform: {shares}")
    return shares


def forked_rollout(out_dir):
    """Phase 15 (c)'s forked writers, in a process that has not touched
    CUDA: the generation CLI's card check for ``--workers``, then
    FORK_WORKERS forked writers rolling FORK_ENTRIES entries each with
    ``resize_crop`` on the card, as ``generate_dataset_parallel`` forks
    them.  The card's machine has no h5py, so each writer saves its
    entries to ``out_dir/w{i}.npz``; prints one JSON line."""
    import torch

    from pointnav_vo_tpu_torch.rl.envs import EnvConfig
    from pointnav_vo_tpu_torch.vo.dataset import fork_workers, iter_rollout_entries
    from pointnav_vo_tpu_torch.vo.generate_datasets import make_obs_transform, transform_device

    device = transform_device("cuda", FORK_WORKERS)
    tf = make_obs_transform("resize_crop", W, H, device)
    env_cfg = EnvConfig(image_h=GEN_SENSOR[0], image_w=GEN_SENSOR[1])

    def run(i):
        entries = list(iter_rollout_entries(FORK_ENTRIES, env_cfg=env_cfg,
                                            seed=SEED + 45 + 1000 * i, obs_transform=tf))
        np.savez(os.path.join(out_dir, f"w{i}.npz"),
                 child_used_card=np.asarray(torch.cuda.is_initialized()),
                 **{k: np.stack([e[k] for e in entries]) for k in entries[0]})

    t0 = time.perf_counter()
    fork_workers(run, FORK_WORKERS)
    print(json.dumps({"s": time.perf_counter() - t0,
                      "parent_initialised_cuda": torch.cuda.is_initialized()}))


def _forked_rollout_vs_cpu(out_dir):
    """Runs :func:`forked_rollout` in a fresh interpreter and holds each
    writer's entries against the same seed's rollout with the CPU
    transform: images within the bounds, every other array equal."""
    from pointnav_vo_tpu_torch.rl.envs import EnvConfig
    from pointnav_vo_tpu_torch.vo.dataset import iter_rollout_entries
    from pointnav_vo_tpu_torch.vo.generate_datasets import make_obs_transform

    here = os.path.dirname(os.path.abspath(__file__))
    out = subprocess.run(
        [sys.executable, "-c", "import sys, chip_smoke; chip_smoke.forked_rollout(sys.argv[1])",
         out_dir], cwd=here, capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise AssertionError(f"the forked writers failed ({out.returncode}): "
                             f"{out.stderr[-3000:]}")
    info = json.loads(out.stdout.strip().splitlines()[-1])
    if info["parent_initialised_cuda"]:
        raise AssertionError("the forking parent initialised CUDA")
    tf_cpu = make_obs_transform("resize_crop", W, H, "cpu")
    env_cfg = EnvConfig(image_h=GEN_SENSOR[0], image_w=GEN_SENSOR[1])
    pairs = []
    for i in range(FORK_WORKERS):
        got = np.load(os.path.join(out_dir, f"w{i}.npz"))
        if not bool(got["child_used_card"]):
            raise AssertionError(f"forked writer {i} did not run its transform on the card")
        want = list(iter_rollout_entries(FORK_ENTRIES, env_cfg=env_cfg,
                                         seed=SEED + 45 + 1000 * i, obs_transform=tf_cpu))
        for k in want[0]:
            w = np.stack([e[k] for e in want])
            if got[k].shape != w.shape or got[k].dtype != w.dtype:
                raise AssertionError(f"forked writer {i}: {k} {got[k].shape} {got[k].dtype}")
            if k.endswith(("rgbs", "depths")):
                pairs += [(k.endswith("rgbs"), a, b) for a, b in zip(got[k], w)]
            elif not np.array_equal(got[k], w):
                raise AssertionError(f"forked writer {i}: {k} differs from the CPU rollout")
    info.update(_image_shares(pairs), workers=FORK_WORKERS, entries_each=FORK_ENTRIES,
                entries_per_s=FORK_WORKERS * FORK_ENTRIES / info["s"])
    return info


def _dead_reckon_np(goal, deltas):
    """``compute_goal_pos`` composed in numpy float64: g' = R_y(-dyaw) (g -
    [dx, 0, dz])."""
    g = np.asarray(goal, np.float64)
    for dx, dz, dyaw in np.asarray(deltas, np.float64):
        x, y, z = g[0] - dx, g[1], g[2] - dz
        c, s = np.cos(dyaw), np.sin(dyaw)
        g = np.asarray([c * x - s * z, y, s * x + c * z])
    return g


def phase_diag(dev, card):
    """The VO training diagnostics on the card, the generator's rollout
    with its transform on the card, and the 500-step dead reckoning."""
    import torch

    from pointnav_vo_tpu_torch.common import TURN_LEFT, TURN_RIGHT
    from pointnav_vo_tpu_torch.io.weights import seeded_init_
    from pointnav_vo_tpu_torch.ops import geometry as geo
    from pointnav_vo_tpu_torch.ops import topdown_kernels as tk
    from pointnav_vo_tpu_torch.rl.envs import EnvConfig
    from pointnav_vo_tpu_torch.rl.trainer import propagate_goal
    from pointnav_vo_tpu_torch.vo.dataset import MemoryFramePairs, iter_rollout_entries
    from pointnav_vo_tpu_torch.vo.engine import VORegressionEngine, VOTrainConfig
    from pointnav_vo_tpu_torch.vo.ensemble import VOInferenceConfig
    from pointnav_vo_tpu_torch.vo.generate_datasets import make_obs_transform

    rec = {}
    # (a) log_grad and debug in the joint stage at batch 128
    t0 = time.perf_counter()
    turns = MemoryFramePairs.scripted(
        DIAG_ENTRIES, lambda _env, _obs, r: r.integers(TURN_LEFT, TURN_RIGHT + 1), SEED + 40,
        twins=True, env_cfg=EnvConfig(image_h=H, image_w=W))
    batches = list(turns.iter_batches(TRAIN_BATCH))
    icfg = VOInferenceConfig(vis_size_h=H, vis_size_w=W)
    g = torch.Generator().manual_seed(SEED + 41)
    experts = [seeded_init_(icfg.make_model(), g) for _ in range(2)]
    _log("diag", f"{len(turns.entries)} turn entries at {W}x{H} as {len(batches)} twin-packed "
                 f"batches of {TRAIN_BATCH} in {time.perf_counter() - t0:.1f} s")
    runs = {}
    for on in (False, True):
        tcfg = VOTrainConfig(batch_size=TRAIN_BATCH, action_type=(TURN_LEFT, TURN_RIGHT),
                             geo_invariance_types=("inverse_joint_train",), lr=1.5e-4,
                             seed=SEED, log_grad=on, debug=int(on))
        engine = VORegressionEngine(icfg, tcfg, turns, device=dev,
                                    experts=[copy.deepcopy(m) for m in experts])
        runs["on" if on else "off"] = (_diag_run(engine, batches, on), engine)
    off, on = runs["off"][0], runs["on"][0]
    rec["train"] = {"off": off, "on": on, "cost": on["step_ms"] / off["step_ms"] - 1}
    _log("diag", f"joint stage B={TRAIN_BATCH}, {DIAG_STEPS} steps on the same batches: "
                 f"{off['step_ms']:.3f} ms/step with the diagnostics off, {on['step_ms']:.3f} "
                 f"with log_grad and debug on ({100 * rec['train']['cost']:+.1f} %; CUDA events "
                 f"around each step, its batch upload included); last norms "
                 f"{json.dumps(on['last_norms'])}; bin_counts launches off {off['launches']}, "
                 f"on {on['launches']} on {card}")
    parity_cfg = VOTrainConfig(batch_size=PARITY_BATCH, action_type=(TURN_LEFT, TURN_RIGHT),
                               geo_invariance_types=("inverse_joint_train",), lr=1.5e-4,
                               seed=SEED, log_grad=True)
    parity_icfg = VOInferenceConfig(vis_size_h=H, vis_size_w=W, dropout_p=0.0)
    parity_batch = next(turns.iter_batches(PARITY_BATCH))
    rec["vs_cpu"] = _diag_parity(dev, parity_icfg, parity_cfg, parity_batch, turns, experts)
    rec["fp32_fault"] = _grad_fault_by_op(dev, card, parity_icfg, parity_cfg, parity_batch,
                                          turns, experts, batches)

    # (b) debug: a NaN target raises before anything changes
    engine = runs["on"][1]
    state = [t.clone() for m in engine.experts for t in m.state_dict().values()]
    moments = [t.clone() for st in engine.opt.state.values()
               for t in (st["exp_avg"], st["exp_avg_sq"])]
    gt = batches[0].gt_delta.copy()
    gt[3, 1] = np.nan
    try:
        engine.train_step(dataclasses.replace(batches[0], gt_delta=gt))
    except FloatingPointError as e:
        raised = str(e)
    else:
        raise AssertionError("VO.debug: a NaN gt_delta did not raise")
    after = [t for m in engine.experts for t in m.state_dict().values()]
    after_moments = [t for st in engine.opt.state.values()
                     for t in (st["exp_avg"], st["exp_avg_sq"])]
    if not (len(moments) == 2 * sum(1 for m in engine.experts for _ in m.parameters())
            and all(torch.equal(a, b) for a, b in zip(after, state, strict=True))
            and all(torch.equal(a, b) for a, b in zip(after_moments, moments, strict=True))):
        raise AssertionError("VO.debug: the raise changed parameters, statistics or moments")
    _log("diag", f"debug: a NaN gt_delta raised FloatingPointError ({raised}); "
                 f"{len(state)} parameter and statistic tensors and {len(moments)} Adam moments "
                 "unchanged")
    rec["debug_raised"] = raised

    # (c) the generator's rollout with resize_crop on the card
    raw, card_out = [], []
    tf_card = make_obs_transform("resize_crop", W, H, dev)

    def recording(img):
        raw.append(img.copy())
        card_out.append(tf_card(img))
        return card_out[-1]

    env_cfg = EnvConfig(image_h=GEN_SENSOR[0], image_w=GEN_SENSOR[1])
    tk.reset_launch_counts()
    t0 = time.perf_counter()
    entries = list(iter_rollout_entries(GEN_ENTRIES, env_cfg=env_cfg, seed=SEED + 42,
                                        obs_transform=recording))
    gen_s = time.perf_counter() - t0
    if tk.launch_counts["bin_counts"] or len(entries) != GEN_ENTRIES:
        raise AssertionError(f"the rollout: {len(entries)} entries, "
                             f"{tk.launch_counts['bin_counts']} launches")
    tf_cpu = make_obs_transform("resize_crop", W, H, "cpu")
    t0 = time.perf_counter()
    cpu_out = [tf_cpu(img) for img in raw]
    cpu_tf_s = time.perf_counter() - t0
    shares = _image_shares((img.dtype == np.uint8 or img.shape[-1] == 3, a, b)
                           for img, a, b in zip(raw, card_out, cpu_out, strict=True))
    if entries[0]["prev_rgbs"].size != H * W * 3 or entries[0]["cur_depths"].dtype != np.float16:
        raise AssertionError("the rollout's entries are not at 341x192")
    rate = GEN_ENTRIES / gen_s
    rec["rollout"] = {"entries": GEN_ENTRIES, "sensor": list(GEN_SENSOR), "s": gen_s,
                      "entries_per_s": rate, "images": len(raw), "cpu_transform_s": cpu_tf_s,
                      "scripted_ref_pairs_hours_one_process": REF_PAIRS / rate / 3600, **shares}
    _log("diag", f"rollout: {GEN_ENTRIES} entries from {GEN_SENSOR[1]}x{GEN_SENSOR[0]} renders, "
                 f"resize_crop to {W}x{H} on the card, {gen_s:.3f} s = {rate:.2f} entries/s on "
                 f"the card's host (the scripted env in one process: {REF_PAIRS} pairs, the "
                 f"reference's train set, would take {REF_PAIRS / rate / 3600:.2f} h, or that "
                 f"over --workers; TRAIN.md's habitat renders untransformed at 341x192, at "
                 f"another rate); the CPU transform of "
                 f"the same {len(raw)} images took {cpu_tf_s:.3f} s; card vs CPU: "
                 f"{json.dumps(shares)} (bounds {GEN_RGB_OFF_BY_ONE}, {GEN_DEPTH_OFF_BY_ULP})")
    with tempfile.TemporaryDirectory() as out_dir:
        rec["forked"] = _forked_rollout_vs_cpu(out_dir)
    _log("diag", f"forked writers: {FORK_WORKERS} forked from a fresh process after the "
                 f"CLI's card check, {FORK_ENTRIES} entries each with resize_crop on the card "
                 f"in {rec['forked']['s']:.3f} s ({rec['forked']['entries_per_s']:.2f} entries/s, "
                 f"each child's CUDA start included); every non-image array equal to the CPU "
                 f"rollout's, images {json.dumps({k: rec['forked'][k] for k in shares})}")

    # (d) DR_STEPS oracle steps dead-reckoned in float32 and float64
    steps = list(iter_rollout_entries(DR_STEPS, env_cfg=EnvConfig(image_h=32, image_w=32),
                                      seed=SEED + 43))
    rot = np.stack([e["delta_rotations"] for e in steps]).astype(np.float64)
    pos = np.stack([e["delta_positions"] for e in steps]).astype(np.float64)
    true = np.stack([pos[:, 0], pos[:, 2], 2 * np.arctan2(rot[:, 1], rot[:, 3])], -1)
    deltas = (true + np.random.default_rng(SEED + 44).normal(0, DR_NOISE, true.shape)
              ).astype(np.float32)
    goal0 = geo.pointgoal_polar2cartesian(torch.from_numpy(
        steps[0]["prev_point_goal_vecs"].astype(np.float32))[None])[0].numpy()
    finals = {}
    for name, device in (("card", dev), ("cpu", torch.device("cpu"))):
        g32 = torch.from_numpy(goal0)[None].to(device)
        zero = torch.zeros(1, 1, device=device)
        polar = torch.zeros(1, 2, device=device)
        d32 = torch.from_numpy(deltas).to(device)
        for t in range(DR_STEPS):
            g32, _ = propagate_goal(g32, d32[t:t + 1], zero, polar)
        finals[name] = g32[0].cpu().double().numpy()
    finals["float64"] = _dead_reckon_np(goal0, deltas)
    finals["noise_free"] = _dead_reckon_np(goal0, true)
    err = {"card_vs_float64_m": float(np.linalg.norm(finals["card"] - finals["float64"])),
           "cpu_vs_float64_m": float(np.linalg.norm(finals["cpu"] - finals["float64"])),
           "card_vs_cpu_m": float(np.linalg.norm(finals["card"] - finals["cpu"])),
           "vo_noise_m": float(np.linalg.norm(finals["float64"] - finals["noise_free"])),
           "goal_distance_m": float(np.linalg.norm(finals["float64"]))}
    _log("diag", f"dead reckoning over {DR_STEPS} oracle steps with VO noise std {DR_NOISE}: "
                 f"final goal error card float32 vs float64 {err['card_vs_float64_m']:.3e} m, "
                 f"CPU float32 vs float64 {err['cpu_vs_float64_m']:.3e} m, card vs CPU "
                 f"{err['card_vs_cpu_m']:.3e} m (gate {DR_TOL_M}); the noise itself moved the "
                 f"goal {err['vo_noise_m']:.3f} m, {err['goal_distance_m']:.3f} m away")
    if not all(np.isfinite(v) for v in err.values()) or err["card_vs_cpu_m"] > DR_TOL_M:
        raise AssertionError(f"dead reckoning: {err}")
    rec["dead_reckoning"] = err
    rec["launches"] = {"train_off": off["launches"]["steps"],
                       "train_on": sum(on["launches"].values())}
    return rec


# -- phase 16: the bf16 policy and the paper's pipelines ---------------------------


class _LaunchLedger:
    """What ``bin_counts`` must launch over a driver's run, from the work
    it did: 2 a VO train or eval step (both frames), 2 a two-frame VO call
    (the unfused ``compute_local_delta_states_from_vo``), loop steps + 1 an
    ``Evaluator.run`` with VO, rollout steps + 1 a trainer with VO.  Counts
    ``Evaluator.run``, ``DDPPOTrainer.collect_rollout`` and the VO engine's
    steps while it is entered."""

    def __enter__(self):
        from pointnav_vo_tpu_torch.examples.eval_994 import CountedSteps
        from pointnav_vo_tpu_torch.rl.eval import Evaluator
        from pointnav_vo_tpu_torch.rl.trainer import DDPPOTrainer
        from pointnav_vo_tpu_torch.vo.engine import VORegressionEngine
        from pointnav_vo_tpu_torch.vo.ensemble import VOEnsemble

        self.vo_steps = self.pair_calls = 0
        self.evals, self.rollout_steps = [], {}
        ledger = self
        self._saved = [(Evaluator, "run", Evaluator.run),
                       (DDPPOTrainer, "collect_rollout", DDPPOTrainer.collect_rollout),
                       (VORegressionEngine, "train_step", VORegressionEngine.train_step),
                       (VORegressionEngine, "eval_step", VORegressionEngine.eval_step),
                       (VOEnsemble, "compute_local_delta_states_from_vo",
                        VOEnsemble.compute_local_delta_states_from_vo)]
        run, collect, train_step, eval_step, pair = (f for _c, _n, f in self._saved)

        def counted_run(ev, *a, **kw):
            counted = ev.envs = CountedSteps(ev.envs)
            try:
                return run(ev, *a, **kw)
            finally:
                ev.envs = counted.envs
                ledger.evals.append((counted.calls, ev.vo is not None))

        def counted_collect(tr):
            if tr.vo is not None:
                ledger.rollout_steps[id(tr)] = (ledger.rollout_steps.get(id(tr), 0)
                                                + tr.cfg.num_steps)
            return collect(tr)

        def step(fn):
            def counted(*a, **kw):
                ledger.vo_steps += 1
                return fn(*a, **kw)
            return counted

        def counted_pair(*a, **kw):
            ledger.pair_calls += 1
            return pair(*a, **kw)

        for (cls, name, _f), f in zip(self._saved, (counted_run, counted_collect,
                                                   step(train_step), step(eval_step),
                                                   counted_pair)):
            setattr(cls, name, f)
        return self

    def __exit__(self, *exc):
        for cls, name, f in self._saved:
            setattr(cls, name, f)

    def expected(self):
        return (2 * self.vo_steps + 2 * self.pair_calls
                + sum(calls + 1 for calls, vo in self.evals if vo)
                + sum(n + 1 for n in self.rollout_steps.values()))


def _driver_run(name, fn, card):
    """One driver's run with its launches counted and checked against
    :class:`_LaunchLedger`; returns (its output, its launch count, wall s)."""
    import torch

    from pointnav_vo_tpu_torch.ops import topdown_kernels as tk

    torch.cuda.synchronize()
    tk.reset_launch_counts()
    t0 = time.perf_counter()
    with _LaunchLedger() as ledger:
        out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = tk.launch_counts["bin_counts"]
    if launches != ledger.expected():
        raise AssertionError(f"{name}: bin_counts launched {launches} times; its work "
                             f"needs {ledger.expected()} ({ledger.vo_steps} VO steps, "
                             f"{ledger.pair_calls} two-frame calls, evals {ledger.evals}, "
                             f"rollout steps {list(ledger.rollout_steps.values())})")
    _log("pipelines", f"{name}: wall {wall:.2f} s, bin_counts launches {launches} (exact: "
                      f"{ledger.vo_steps} VO steps, {ledger.pair_calls} two-frame calls, "
                      f"{len(ledger.evals)} evals, {len(ledger.rollout_steps)} VO rollouts) "
                      f"on {card}")
    return out, launches, wall


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm().clamp(min=1e-30))


def _ladder_shape_ms(dev, card):
    """(a) The rollout step's and the update's ms in bf16 and fp32 at the
    ladder's training shape: its tune stage's trainer (LADDER_TRAIN_ENVS
    envs, LADDER_STEPS steps, 2 epochs of 2 minibatches, bf16 det VO in the
    loop), the same seeded weights in each precision.  A first rollout and
    update warm, a second is timed (CUDA events, host work included)."""
    import torch

    from pointnav_vo_tpu_torch.examples import eval_994_ladder as ladder
    from pointnav_vo_tpu_torch.io.weights import seeded_init_
    from pointnav_vo_tpu_torch.models.policy import PointNavActorCritic
    from pointnav_vo_tpu_torch.rl.envs import EnvConfig, make_scripted_vector_env
    from pointnav_vo_tpu_torch.rl.trainer import DDPPOTrainer
    from pointnav_vo_tpu_torch.vo.ensemble import VOEnsemble

    env_cfg = EnvConfig(image_h=H, image_w=W, actuation_noise_multiplier=0.5)
    pcfg, train_cfg = ladder.training_configs(LADDER_STEPS, env_cfg)
    icfg = ladder.make_icfg(env_cfg)
    g = torch.Generator().manual_seed(SEED + 62)
    vo = VOEnsemble(icfg, experts=[seeded_init_(icfg.make_model(), g) for _ in range(3)],
                    device=dev)
    times = {}
    for name, dtype in (("bf16", torch.bfloat16), ("fp32", None)):
        tr = DDPPOTrainer(model=PointNavActorCritic(image_size=(H, W), compute_dtype=dtype),
                          ppo_cfg=pcfg, device=dev, vo_ensemble=vo,
                          envs=make_scripted_vector_env(train_cfg, LADDER_TRAIN_ENVS, seed=100),
                          init_generator=torch.Generator().manual_seed(SEED + 63),
                          generator=torch.Generator(device=dev).manual_seed(1))
        try:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
            for k in range(2):
                ev[3 * k].record()
                tr.collect_rollout()
                ev[3 * k + 1].record()
                tr.update_agent()
                ev[3 * k + 2].record()
            torch.cuda.synchronize()
        finally:
            tr.envs.close()
        times[name] = {"rollout_step_ms": ev[3].elapsed_time(ev[4]) / LADDER_STEPS,
                       "update_ms": ev[4].elapsed_time(ev[5]),
                       "warm_rollout_step_ms": ev[0].elapsed_time(ev[1]) / LADDER_STEPS,
                       "warm_update_ms": ev[1].elapsed_time(ev[2])}
        del tr
    _log("pipelines", f"(a) the ladder's training shape ({LADDER_TRAIN_ENVS} envs x "
                      f"{LADDER_STEPS} steps, ppo_epoch {pcfg.ppo_epoch}, num_mini_batch "
                      f"{pcfg.num_mini_batch}, bf16 det VO in the loop): rollout step and update "
                      f"ms, the second of two (CUDA events, host work included) "
                      f"{json.dumps(times)} on {card}")
    return times


def _pipelines_bf16(dev, card):
    """(a) The bf16 policy at full width: the times of
    :func:`_ladder_shape_ms`; one act step and one PPO update over a small
    rollout, card bf16 against CPU bf16 and card fp32, and float32 state
    after the update."""
    import torch

    from pointnav_vo_tpu_torch.models.policy import PointNavActorCritic
    from pointnav_vo_tpu_torch.rl.ppo import make_optimizer, ppo_loss, ppo_update

    times = _ladder_shape_ms(dev, card)
    tr = _rl_trainer(dev, PIPE_RL_STEPS, SEED + 60,
                     policy=PointNavActorCritic(image_size=(H, W), compute_dtype=torch.bfloat16))
    for _ in range(2):  # the compared rollout starts from a carried hidden state
        tr.collect_rollout()
        tr.update_agent()

    # one act step and one update from the bf16 trainer's stored rollout
    tr.collect_rollout()
    rollouts = _with_returns(tr)
    base = copy.deepcopy(tr.model).cpu()
    models = {"card_bf16": copy.deepcopy(base).to(dev), "cpu_bf16": copy.deepcopy(base),
              "card_fp32": copy.deepcopy(base).to(dev), "cpu_fp32": copy.deepcopy(base)}
    models["card_fp32"].compute_dtype = models["cpu_fp32"].compute_dtype = None
    cpu = torch.device("cpu")
    devs = {"card_bf16": dev, "cpu_bf16": cpu, "card_fp32": dev, "cpu_fp32": cpu}
    step, grads, losses = {}, {}, {}
    for name, model in models.items():
        d = devs[name]
        obs = {k: v[0].to(d) for k, v in rollouts.observations.items()}
        with torch.no_grad():
            logits, value, hidden = model.eval()(obs, rollouts.hidden_states[0].to(d),
                                                 rollouts.prev_actions[0].to(d),
                                                 rollouts.masks[0].to(d))
        step[name] = [x.float().cpu() for x in (logits, value, hidden)]
        model.train().zero_grad(set_to_none=True)
        r = rollouts.to(d)
        total, terms = ppo_loss(model, tr.cfg, _full_minibatch(r, model), tr.cfg.clip_param)
        total.backward()
        losses[name] = float(total.detach())
        grads[name] = torch.cat([p.grad.detach().float().cpu().reshape(-1)
                                 for p in model.parameters()])
    top2 = torch.topk(step["card_fp32"][0], 2, dim=-1).values
    firm = (top2[:, 0] - top2[:, 1]) > LOGIT_MARGIN
    act = {k: v[0].argmax(-1) for k, v in step.items()}
    # bf16's own gradient distance from fp32 (the CPU's, beside the card's)
    own = _rel(grads["cpu_bf16"], grads["cpu_fp32"])
    out = {"times": times, "cpu_bf16_vs_cpu_fp32_gradients": own,
           "card_fp32_vs_cpu_fp32_gradients": _rel(grads["card_fp32"], grads["cpu_fp32"])}
    for ref in ("cpu_bf16", "card_fp32"):
        dist = {what: _rel(step["card_bf16"][i], step[ref][i])
                for i, what in enumerate(("logits", "value", "hidden"))}
        dist["gradients"] = _rel(grads["card_bf16"], grads[ref])
        dist["loss"] = [losses["card_bf16"], losses[ref]]
        differ = act["card_bf16"] != act[ref]
        dist["actions_differ"] = int(differ.sum())
        dist["rows_within_margin"] = int((~firm).sum())
        out[f"vs_{ref}"] = dist
    _log("pipelines", "(a) distances: " + json.dumps(out))
    for ref, dist in ((r, out[f"vs_{r}"]) for r in ("cpu_bf16", "card_fp32")):
        # the gradients: card vs CPU bf16 within PIPE_BF16_GRAD_REL, and from
        # fp32 at most BF16_SIDE_RATIO x the CPU's own distance
        grad_bound = PIPE_BF16_GRAD_REL if ref == "cpu_bf16" else BF16_SIDE_RATIO * own
        if (max(dist[k] for k in ("logits", "value", "hidden")) > BF16_DELTA_REL
                or dist["gradients"] > grad_bound):
            raise AssertionError(f"(a) card bf16 vs {ref}: {json.dumps(dist)}")
        if bool(((act["card_bf16"] != act[ref]) & firm).any()):
            raise AssertionError(f"(a) card bf16 vs {ref}: actions differ where the fp32 "
                                 f"logit margin exceeds {LOGIT_MARGIN}")
    # a card path that computed in fp32 would stand as close to the card's
    # fp32 gradients as those stand to the CPU's
    if out["vs_card_fp32"]["gradients"] <= out["card_fp32_vs_cpu_fp32_gradients"]:
        raise AssertionError("(a) the card's bf16 gradients are no farther from its fp32 "
                             "ones than those are from the CPU's: the bf16 path ran in fp32")
    if step["card_bf16"][2].dtype != torch.float32 or tr.hidden.dtype != torch.float32:
        raise AssertionError("(a) the bf16 policy's hidden state is not float32")

    # one whole update (2 minibatches) of the card's bf16 policy: float32 state after it
    model = copy.deepcopy(base).to(dev)
    opt = make_optimizer(model.parameters(), tr.cfg)
    stats = {k: float(v) for k, v in ppo_update(
        model, tr.cfg, opt, rollouts, generator=torch.Generator(device=dev).manual_seed(SEED)
    ).items()}
    moments = [t for s in opt.adam.state.values() for t in (s["exp_avg"], s["exp_avg_sq"])]
    if not (all(p.dtype == torch.float32 for p in model.parameters())
            and all(t.dtype == torch.float32 for t in moments) and moments
            and all(np.isfinite(v) for v in stats.values())):
        raise AssertionError(f"(a) bf16 update: {stats}, parameter or moment dtypes "
                             f"{sorted({str(p.dtype) for p in model.parameters()})}")
    out["update_stats"] = stats
    _log("pipelines", f"(a) bf16 policy, one act step (rollout step 0) and the ppo_loss "
                      f"gradient over {PIPE_RL_STEPS} x {RL_ENVS} frames, card bf16 against CPU "
                      f"bf16 and card fp32: logits, value, hidden within relative L2 "
                      f"{BF16_DELTA_REL}, gradients within {PIPE_BF16_GRAD_REL} of the CPU's "
                      f"bf16, within {BF16_SIDE_RATIO} x the CPU's own bf16-to-fp32 distance "
                      f"({own:.4g}) of the card's fp32 and farther from it than the card's fp32 "
                      f"from the CPU's, actions equal where the fp32 logit "
                      f"margin > {LOGIT_MARGIN}; one update "
                      f"{json.dumps(stats)}, parameters and Adam moments float32")
    return out


def _pipelines_ladder(dev, card, root):
    """(b) The ladder at a smoke size over the farm (its rows check their
    episode counts and launches), then a relaunch from the ``.part`` a run
    stopped after the GPS stage leaves: the uninterrupted run's parameters,
    bit for bit (deterministic cuDNN)."""
    import torch

    from pointnav_vo_tpu_torch.examples import eval_994_ladder as ladder
    from pointnav_vo_tpu_torch.io.checkpoint import load_checkpoint
    from pointnav_vo_tpu_torch.ops import topdown_kernels as tk
    from pointnav_vo_tpu_torch.rl.envs import EnvConfig

    cache = lambda name: os.path.join(root, name)  # noqa: E731
    argv = LADDER_ARGS + ["--vo-cache", cache("vo.pt"), "--policy-cache", cache("pol.pt"),
                          "--out", cache("ladder.json"), "--watchdog", "0"]
    launches = {}
    real_vo, real_policy = ladder.train_vo, ladder.train_policy

    def counted(name, fn):
        def run(*a, **kw):
            out, launches[name], _wall = _driver_run(f"(b) ladder {name}", lambda: fn(*a, **kw),
                                                     card)
            return out
        return run

    ladder.train_vo, ladder.train_policy = counted("vo_train", real_vo), counted(
        "policy_train", real_policy)
    try:
        t0 = time.perf_counter()
        rec = ladder.main(argv)
        wall = time.perf_counter() - t0
    finally:
        ladder.train_vo, ladder.train_policy = real_vo, real_policy
    args = ladder.build_parser().parse_args(argv)
    rows = rec["rows"]
    want_eps = {"policy_vo": args.episodes, "oracle_gps": args.episodes,
                "greedy_vo": args.episodes, "policy_vo_rnd": args.rnd_episodes}
    for name, n in want_eps.items():
        row = rows[name]
        want = 0 if name == "oracle_gps" else row["loop_steps"] + 1
        if (row["distinct_episodes"] != n or row["metrics"]["episodes"] != n
                or row["bin_counts_launches"] != want
                or not all(np.isfinite(v) for v in row["metrics"].values())):
            raise AssertionError(f"(b) ladder row {name}: {json.dumps(row)}")
        launches[name] = row["bin_counts_launches"]
    if launches["policy_train"] != args.tune_updates * args.num_steps + 1:
        raise AssertionError(f"(b) ladder policy training: {launches['policy_train']} launches")
    _log("pipelines", f"(b) ladder {' '.join(LADDER_ARGS)}: wall {wall:.2f} s; rows "
                      + json.dumps({k: {"episodes": v["distinct_episodes"],
                                        "loop_steps": v["loop_steps"],
                                        "launches": v["bin_counts_launches"],
                                        "wall_min": v["wall_clock_min"],
                                        "success": v["metrics"]["success"]}
                                    for k, v in rows.items()})
                      + f"; train_cost_s {json.dumps(rec['train_cost_s'])} on {card}")

    # the relaunch: a run stopped in the tune stage, then resumed from its .part
    env_cfg = EnvConfig(max_episode_steps=args.max_episode_steps,
                        actuation_noise_multiplier=0.5)
    vo_states, _t = ladder.train_vo(args, env_cfg, dev)  # from the cache
    ensemble = ladder.make_ensemble(ladder.make_icfg(env_cfg), vo_states, dev)
    rerun = ladder.build_parser().parse_args(LADDER_ARGS + ["--policy-cache",
                                                            cache("pol_cut.pt")])

    class Stop(Exception):
        pass

    real_stage, stages = ladder.train_stage, []

    def stop_in_tune(stage, *a, **kw):
        if stage == "tune_vo":
            raise Stop
        return real_stage(stage, *a, **kw)

    def logged(stage, *a, **kw):
        stages.append((stage, a[2]))  # (stage, start update)
        return real_stage(stage, *a, **kw)

    try:
        ladder.train_stage = stop_in_tune
        try:
            ladder.train_policy(rerun, env_cfg, ensemble, dev)
        except Stop:
            pass
        part = load_checkpoint(cache("pol_cut.pt.part"))
        ladder.train_stage = logged
        tk.reset_launch_counts()
        state, _t, _trend = ladder.train_policy(rerun, env_cfg, ensemble, dev)
        torch.cuda.synchronize()
        resume_launches = tk.launch_counts["bin_counts"]
    finally:
        ladder.train_stage = real_stage
    whole = load_checkpoint(cache("pol.pt"))["state_dict"]
    equal = sorted(whole) == sorted(state) and all(torch.equal(whole[k], state[k])
                                                   for k in whole)
    if (part["stage"], part["update"]) != ("gps_done", 0) or stages != [("tune_vo", 0)] \
            or not equal or resume_launches != args.tune_updates * args.num_steps + 1:
        raise AssertionError(f"(b) ladder relaunch: part ({part['stage']}, {part['update']}), "
                             f"stages {stages}, parameters equal {equal}, launches "
                             f"{resume_launches}")
    launches["relaunch_tune"] = resume_launches
    _log("pipelines", "(b) relaunch from the .part written after the GPS stage (stage "
                      "gps_done, update 0): the tune stage alone from update 0, "
                      f"{resume_launches} launches, parameters bit-equal to the uninterrupted "
                      "run's")
    return {"wall_s": wall, "rows": rows, "train_cost_s": rec["train_cost_s"],
            "launches": launches}


def _pipelines_drivers(dev, card, root):
    """(c) The other drivers at smoke sizes, each run's launches exact:
    their records (and vis_trajectory's PNGs) exist and hold finite
    metrics."""
    import torch

    from pointnav_vo_tpu_torch.examples import (
        end_to_end_scripted,
        rl_tune_with_vo,
        train_rl_scripted,
        train_vo_scripted,
        vis_trajectory,
    )
    from pointnav_vo_tpu_torch.io.checkpoint import save_checkpoint
    from pointnav_vo_tpu_torch.io.weights import seeded_init_
    from pointnav_vo_tpu_torch.vo.ensemble import VOInferenceConfig

    out, launches, walls = {}, {}, {}

    def finite(tree):
        if isinstance(tree, dict):
            return all(finite(v) for v in tree.values())
        if isinstance(tree, list):
            return all(finite(v) for v in tree)
        return not isinstance(tree, float) or np.isfinite(tree)

    def run(name, fn, path, check):
        _rec, launches[name], walls[name] = _driver_run(f"(c) {name}", fn, card)
        with open(path) as f:
            rec = json.load(f)
        if not check(rec):
            raise AssertionError(f"(c) {name}: record {json.dumps(rec)[:2000]}")
        out[name] = rec
        return rec

    p = lambda name: os.path.join(root, name)  # noqa: E731
    run("rl_tune_with_vo", lambda: rl_tune_with_vo.main(PIPE_TUNE_ARGS + ["--out", p("tune.json")]),
        p("tune.json"), lambda r: all(np.isfinite(r[k][m]) for k in ("gps_oracle", "no_tune",
                                                                      "tune_vo")
                                     for m in ("success", "spl", "softspl", "distance_to_goal")))
    run("end_to_end_scripted", lambda: end_to_end_scripted.main(
        PIPE_E2E_ARGS + ["--out", p("e2e.json")]), p("e2e.json"),
        lambda r: finite(r["metrics"]) and r["metrics"]["episodes"] > 0)
    run("train_rl_scripted", lambda: train_rl_scripted.main(
        PIPE_RL_ARGS + ["--out", p("rl.json")]), p("rl.json"),
        lambda r: np.isfinite(r["final_mean_ep_reward"]) and finite(r["reward_trend"]))
    run("train_vo_scripted", lambda: train_vo_scripted.main(
        PIPE_VO_ARGS + ["--out", p("vo")]), p("vo/train_vo_scripted.json"),
        lambda r: finite(r["final"]) and finite(r["epochs_history"]))
    # vis_trajectory from a checkpoint this phase writes: three seeded experts
    icfg = VOInferenceConfig(vis_size_w=VIS_SIZE, vis_size_h=VIS_SIZE)
    g = torch.Generator().manual_seed(SEED + 61)
    save_checkpoint(p("vis_vo.pt"), {
        "experts": [seeded_init_(icfg.make_model(), g).state_dict() for _ in range(3)],
        "inference_config": dataclasses.asdict(icfg)})
    rec = run("vis_trajectory", lambda: vis_trajectory.main(
        ["--episodes", "0", "1", "--size", str(VIS_SIZE), "--out", p("vis"), "--vo-ckpt",
         p("vis_vo.pt")]), p("vis/trajectories.json"),
        lambda r: all(os.path.isfile(e["image"]) and np.isfinite(e["drift_m"])
                      for e in r["episodes"].values()) and len(r["episodes"]) == 2)
    images = sorted(os.path.basename(e["image"]) for e in rec["episodes"].values())
    _log("pipelines", f"(c) records written and finite; vis_trajectory images {images}; "
                      f"launches {json.dumps(launches)}; wall s {json.dumps(walls)}")
    out = {name: {k: v for k, v in rec.items() if k in (
        "gps_oracle", "no_tune", "tune_vo", "metrics", "final", "final_mean_ep_reward")}
        for name, rec in out.items()}
    return {"records": out, "launches": launches, "wall_s": walls, "vis_images": images}


def phase_pipelines(dev, card):
    """Phase 16: the bf16 policy, the ladder, the other drivers."""
    import shutil
    import tempfile

    import torch

    root = tempfile.mkdtemp(prefix="chip_smoke_pipelines_")
    deterministic = torch.backends.cudnn.deterministic
    # the same numbers every run; (b)'s relaunch is held bit for bit
    torch.backends.cudnn.deterministic = True
    try:
        bf16, launches, _wall = _driver_run("(a) bf16 policy",
                                            lambda: _pipelines_bf16(dev, card), card)
        return {"bf16_policy": {**bf16, "launches": launches},
                "ladder": _pipelines_ladder(dev, card, root),
                "drivers": _pipelines_drivers(dev, card, root)}
    finally:
        torch.backends.cudnn.deterministic = deterministic
        shutil.rmtree(root, ignore_errors=True)


# -- phase 17: the measurement scripts and the checkpoint tools --------------------


def _feb_vs_cpu(dev, card):
    """One ``full_eval_benchmark.eval_loop`` step over N_ENVS envs with
    seeded bf16 weights on the card and on the CPU: the deltas within
    BF16_DELTA_REL, the logits within it too, the policy's actions equal
    where the card's fp32 policy's top-two logit gap exceeds LOGIT_MARGIN,
    the env actions equal and the goals within rtol 1e-5 / atol 1e-6;
    exactly 2 launches (the first frame and the step)."""
    import torch

    from pointnav_vo_tpu_torch.examples import full_eval_benchmark as feb
    from pointnav_vo_tpu_torch.io.weights import seeded_init_
    from pointnav_vo_tpu_torch.models.policy import PointNavActorCritic
    from pointnav_vo_tpu_torch.ops import topdown_kernels as tk
    from pointnav_vo_tpu_torch.rl.envs import EnvConfig, make_scripted_vector_env
    from pointnav_vo_tpu_torch.vo.ensemble import VOEnsemble, VOInferenceConfig

    env_cfg = EnvConfig(image_h=H, image_w=W)
    vo_cfg = VOInferenceConfig(precision="bf16", vis_size_h=H, vis_size_w=W)
    g = torch.Generator().manual_seed(SEED + 50)
    experts = [seeded_init_(vo_cfg.make_model(), g) for _ in range(3)]
    policy = seeded_init_(PointNavActorCritic(image_size=(H, W), compute_dtype=torch.bfloat16),
                          g)
    traces = {}
    for name, device in (("card", dev), ("cpu", torch.device("cpu"))):
        ens = VOEnsemble(vo_cfg, experts=[copy.deepcopy(m) for m in experts], device=device)
        envs = make_scripted_vector_env(env_cfg, N_ENVS, seed=0)
        tk.reset_launch_counts()
        traces[name] = []
        feb.eval_loop(envs, env_cfg, ens, copy.deepcopy(policy).to(device), 1, device,
                      traces[name])
        if device.type == "cuda" and tk.launch_counts["bin_counts"] != 2:
            raise AssertionError(f"eval_loop: {tk.launch_counts['bin_counts']} launches over "
                                 "one step; expected 2")
    got, want = traces["card"][0], traces["cpu"][0]
    # the first step's policy inputs, for the fp32 policy's logit margin
    obs = make_scripted_vector_env(env_cfg, N_ENVS, seed=0).reset()
    rgb, depth = feb.ship(obs, dev)
    fp32 = copy.deepcopy(policy).to(dev)
    fp32.compute_dtype = None
    with torch.no_grad():
        logits32 = fp32({"depth": depth, "pointgoal_with_gps_compass":
                         torch.from_numpy(obs["pointgoal_with_gps_compass"]).to(dev)},
                        fp32.initial_hidden(N_ENVS, dev),
                        torch.zeros((N_ENVS, 1), dtype=torch.long, device=dev),
                        torch.zeros((N_ENVS, 1), device=dev))[0].float().cpu()
    top2 = logits32.topk(2, dim=-1).values
    firm = (top2[:, 0] - top2[:, 1]).numpy() > LOGIT_MARGIN
    out = {"delta_rel_l2": _rel_l2(torch.from_numpy(got["delta"]), torch.from_numpy(want["delta"])),
           "logits_rel_l2": _rel_l2(torch.from_numpy(got["logits"]),
                                    torch.from_numpy(want["logits"])),
           "goal_max_abs": float(np.abs(got["goal_polar"] - want["goal_polar"]).max()),
           "policy_actions_differ": int((got["policy_action"] != want["policy_action"]).sum()),
           "rows_within_margin": int((~firm).sum())}
    if (out["delta_rel_l2"] > BF16_DELTA_REL or out["logits_rel_l2"] > BF16_DELTA_REL
            or not np.array_equal(got["actions"], want["actions"])
            or not np.allclose(got["goal_polar"], want["goal_polar"], rtol=1e-5, atol=1e-6)
            or bool(((got["policy_action"] != want["policy_action"]) & firm).any())):
        raise AssertionError(f"full_eval_benchmark's first step, card vs CPU: {out}")
    return out


def _export_roundtrip(dev, root):
    """(c): a forward-stage and a joint-stage VO checkpoint and an RL
    checkpoint written on the card, exported, read back through
    ``from_torch_checkpoints`` / ``load_policy_checkpoint``; the forwards
    bit-equal to the originals'.  Returns the exported paths."""
    import torch

    from pointnav_vo_tpu_torch.common import TURN_LEFT, TURN_RIGHT
    from pointnav_vo_tpu_torch.io.checkpoint import save_checkpoint
    from pointnav_vo_tpu_torch.io.weights import (POLICY_PREFIX, load_policy_checkpoint,
                                                  seeded_init_)
    from pointnav_vo_tpu_torch.models.policy import PointNavActorCritic
    from pointnav_vo_tpu_torch.tools.export_to_reference import export
    from pointnav_vo_tpu_torch.vo.engine import VORegressionEngine, VOTrainConfig
    from pointnav_vo_tpu_torch.vo.ensemble import VOEnsemble, VOInferenceConfig

    icfg = VOInferenceConfig(vis_size_h=H, vis_size_w=W)
    g = torch.Generator().manual_seed(SEED + 51)
    experts = [seeded_init_(icfg.make_model(), g) for _ in range(3)]
    paths = {}
    for stage, act, mods in (("act_forward", 1, experts[:1]),
                             ("act_left_right", [TURN_LEFT, TURN_RIGHT], experts[1:])):
        engine = VORegressionEngine(icfg, VOTrainConfig(batch_size=8, action_type=act),
                                    device=dev, experts=[copy.deepcopy(m) for m in mods])
        engine.save_ckpt(os.path.join(root, f"{stage}_port.pth"))
        paths[stage] = os.path.join(root, f"{stage}.pth")
        export(os.path.join(root, f"{stage}_port.pth"), paths[stage], "vo")
    ens = VOEnsemble.from_torch_checkpoints(
        icfg, {"forward": paths["act_forward"], "left": paths["act_left_right"],
               "right": paths["act_left_right"]}, device=dev)
    rng = np.random.default_rng(SEED + 52)
    packed = torch.from_numpy(rng.uniform(0, 1, (6, H, W, 30)).astype(np.float32)).to(dev)
    actions = np.array([1, 2, 3, 3, 1, 2])
    got = ens.predict_packed(packed, actions)
    vo_equal = True
    with torch.no_grad():
        for e, m in enumerate(experts):
            rows = torch.from_numpy(np.nonzero(actions == e + 1)[0]).to(dev)
            vo_equal &= torch.equal(got[rows], m.to(dev).eval()(packed[rows]))
    policy = seeded_init_(PointNavActorCritic(image_size=(H, W)), g).to(dev)
    opt = torch.optim.Adam(policy.parameters(), lr=1e-4)
    obs = {"depth": torch.from_numpy(rng.uniform(0, 1, (2, H, W, 1)).astype(np.float32)).to(dev),
           "pointgoal_with_gps_compass": torch.from_numpy(
               rng.normal(size=(2, 2)).astype(np.float32)).to(dev)}
    args = (obs, torch.from_numpy(rng.normal(size=(4, 2, 512)).astype(np.float32)).to(dev),
            torch.zeros((2, 1), dtype=torch.long, device=dev), torch.ones((2, 1), device=dev))
    policy(*args)[0].sum().backward()
    opt.step()
    port = os.path.join(root, "rl_port.pth")
    save_checkpoint(port, {"state_dict": {POLICY_PREFIX + k: v
                                          for k, v in policy.state_dict().items()},
                           "optimizer": opt.state_dict(), "update": 1, "update_idx": 1,
                           "count_steps": 256})
    paths["rl_tune_vo"] = os.path.join(root, "rl_tune_vo.pth")
    info = export(port, paths["rl_tune_vo"], "policy")
    back = PointNavActorCritic(image_size=(H, W))
    back.load_state_dict(load_policy_checkpoint(paths["rl_tune_vo"]), strict=True)
    back.to(dev)
    with torch.no_grad():
        pol_equal = all(torch.equal(a, b) for a, b in zip(back(*args), policy(*args)))
    if not (vo_equal and pol_equal and info["update"] == 1):
        raise AssertionError(f"export round trip: VO forwards equal {vo_equal}, policy "
                             f"forwards equal {pol_equal}, {info}")
    _log("tools", f"export: forward and joint VO checkpoints and an RL checkpoint written on "
                  f"the card, exported ({', '.join(os.path.basename(p) for p in paths.values())}"
                  "), read back through from_torch_checkpoints and load_policy_checkpoint: the "
                  "three experts' det deltas and the policy's logits, value and hidden bit-equal "
                  "to the originals'")
    return paths


def _verify_card_vs_cpu(paths, root):
    """(d): ``verify_reference_ckpts`` on the exported files on the card and
    on the CPU (fp32, TF32 off, no reference clone): both PASS, the card's
    ``delta_sample0``/``logits_sample0`` within rtol 1e-3 / atol 1e-4 of
    the CPU's."""
    from pointnav_vo_tpu_torch.tools import verify_reference_ckpts as verify

    reports = {}
    for device in ("cuda", "cpu"):
        report = os.path.join(root, f"verify_{device}.json")
        rc = verify.main(["--act-forward", paths["act_forward"], "--act-left-right",
                          paths["act_left_right"], "--rl-tune-vo", paths["rl_tune_vo"],
                          "--reference-root", os.path.join(root, "no_clone"),
                          "--report", report, "--device", device])
        with open(report) as f:
            reports[device] = json.load(f)
        if rc != 0 or reports[device]["overall"] != "PASS":
            raise AssertionError(f"verify_reference_ckpts --device {device}: rc {rc}, "
                                 f"{reports[device]['overall']}")
    card, cpu = (reports[d]["files"] for d in ("cuda", "cpu"))
    pairs = [(card[f]["experts"][e]["delta_sample0"], cpu[f]["experts"][e]["delta_sample0"])
             for f in card if "experts" in card[f] for e in card[f]["experts"]]
    pairs.append((card["rl_tune_vo.pth"]["logits_sample0"], cpu["rl_tune_vo.pth"]["logits_sample0"]))
    err = max(float(np.abs(np.subtract(a, b)).max()) for a, b in pairs)
    if len(pairs) != 4 or not all(np.allclose(a, b, rtol=1e-3, atol=1e-4) for a, b in pairs):
        raise AssertionError(f"verify_reference_ckpts card vs CPU: max abs err {err}")
    _log("tools", f"verify_reference_ckpts on the exported files: PASS on the card and on the "
                  f"CPU; delta_sample0 of 3 experts and logits_sample0, card vs CPU max abs err "
                  f"{err:.3e} (rtol 1e-3, atol 1e-4)")
    return {"overall": {d: r["overall"] for d, r in reports.items()}, "card_vs_cpu_max_abs": err}


def phase_measure(dev, card):
    """Phase 17: full_eval_benchmark, profile_vo_step, the export and the
    verify tools."""
    import shutil

    from pointnav_vo_tpu_torch.examples import full_eval_benchmark as feb
    from pointnav_vo_tpu_torch.examples import profile_vo_step as prof
    from pointnav_vo_tpu_torch.ops import topdown_kernels as tk

    rec = {}
    # (a) the eval step at N_ENVS envs, FEB_STEPS loop steps, then the chain
    envs, env_cfg, ens, policy = feb.build(N_ENVS, dev)
    tk.reset_launch_counts()
    try:
        run = feb.run(ens, policy, envs, env_cfg, FEB_STEPS, dev)
    finally:
        envs.close()
    feb_launches = tk.launch_counts["bin_counts"]
    if feb_launches != run["expected_launches"]:
        raise AssertionError(f"full_eval_benchmark: {feb_launches} launches; expected "
                             f"{run['expected_launches']}")
    lines = feb.report(run, 1)
    for line in lines:
        _log("measure", line)
    rec["full_eval_benchmark"] = {**run, "lines": lines, "card": card}
    rec["full_eval_benchmark_vs_cpu"] = _feb_vs_cpu(dev, card)
    _log("measure", f"(a) {FEB_STEPS} loop steps and {run['chained_calls']} chained calls at "
                    f"{N_ENVS} envs: bin_counts launched {feb_launches} times "
                    f"(1 + steps + {feb.CHAIN} x calls); first step card vs CPU (seeded bf16 "
                    f"weights): {json.dumps(rec['full_eval_benchmark_vs_cpu'])} on {card}")
    # (b) the VO step's stages at STEADY_BATCH
    tk.reset_launch_counts()
    stages = prof.profile(STEADY_BATCH, PROFILE_ITERS, dev)
    bad = [k for k, v in stages.items() if isinstance(v, dict) and "finite" in v and not v["finite"]]
    if bad or not stages["topdown_equal"]:
        raise AssertionError(f"profile_vo_step: non-finite stages {bad}, top-down equal "
                             f"{stages['topdown_equal']}")
    rec["profile_vo_step"] = {**stages, "card": card}
    _log("measure", f"(b) profile_vo_step at B={STEADY_BATCH}, {PROFILE_ITERS} iterations: "
                    f"every stage finite, the kernel's top-down view torch.equal to the plain "
                    f"version's, {stages['bin_counts_launches']} launches; ms (CUDA events) / "
                    "device ms (null: not measured): " + json.dumps(
                        {k: [round(v["ms"], 4), v["device_ms"] and round(v["device_ms"], 4)]
                         for k, v in stages.items() if isinstance(v, dict) and "ms" in v})
                    + f" on {card}")
    # (c), (d) the checkpoint tools
    root = tempfile.mkdtemp(prefix="chip_smoke_tools_")
    try:
        rec["verify"] = _verify_card_vs_cpu(_export_roundtrip(dev, root), root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    # and the 2 of the card-vs-CPU step, checked in _feb_vs_cpu
    rec["launches"] = {"full_eval_benchmark": feb_launches + 2,
                       "profile_vo_step": stages["bin_counts_launches"]}
    return rec


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
    launches, step_ms, wall, loop_steps, episodes = timed("main", phase_main_path, dev)
    main_bf16 = timed("main_bf16", phase_main_path_bf16, dev, card)
    rnd_launches, _rnd_ms = timed("rnd", phase_rnd_eval, dev)
    steady = timed("steady", phase_steady_vo, dev, card)
    train = timed("train", phase_train, dev, card)
    rl = timed("train_rl", phase_train_rl, dev, card)
    cli = timed("cli", phase_cli, dev, card)
    agent = timed("agent", phase_agent, dev, card)
    e994 = timed("eval_994", phase_eval_994, dev, card)
    farm = timed("farm", phase_farm, dev, card)
    zoo = timed("zoo", phase_zoo, dev, card)
    pol = timed("policies", phase_policies, dev, card)
    dist_rec = timed("dist", phase_dist, dev, card, episodes)
    diag = timed("diag", phase_diag, dev, card)
    pipes = timed("pipelines", phase_pipelines, dev, card)
    measure = timed("measure", phase_measure, dev, card)
    by_path = {"det_eval": launches["bin_counts"], "det_eval_bf16": main_bf16["launches"],
               "rnd_eval": rnd_launches,
               "train_forward": train["forward"]["launches"],
               "train_joint": train["joint"]["launches"],
               "train_forward_bf16": train["forward_bf16"]["launches"],
               "train_joint_bf16": train["joint_bf16"]["launches"], "train_rl": rl["launches"],
               "cli_train_rl": cli["train"]["launches"], "cli_eval": cli["eval"]["launches"],
               "cli_resume": cli["resume"]["launches"], "agent": agent["launches"],
               "eval_994_train": e994["train_launches"],
               "eval_994": e994["bin_counts_launches"],
               "farm_det_eval_sync": farm["launches"]["sync"],
               "farm_det_eval_shm": farm["launches"]["shm"],
               "farm_det_eval_shm_async": farm["launches"]["shm_async"],
               "farm_gps_only_eval": farm["launches"]["gps_only"],
               "farm_unfused_eval": farm["launches"]["unfused"],
               "farm_video_ranked_eval": farm["launches"]["video_ranked"],
               "zoo_backbones": sum(b["launches"] for b in zoo["backbones"].values()),
               "zoo_variants": zoo["variant_launches"],
               "zoo_nav_eval": zoo["nav_eval"]["launches"],
               "policies_rgbd_train": pol["rgbd"]["launches"],
               "policies_gru_eval": pol["gru"]["launches"],
               "policies_baseline_train": pol["baseline"]["launches"],
               "policies_baseline_eval": pol["baseline"]["eval_launches"],
               "policies_baseline_agent": pol["baseline"]["agent_launches"],
               "policies_classical_eval": pol["classical"]["launches"],
               "dist_train_rl": dist_rec["launches"]["train_rl"],
               "dist_train_vo": dist_rec["launches"]["train_vo"],
               "dist_eval": dist_rec["launches"]["eval"],
               "diag_train_off": diag["launches"]["train_off"],
               "diag_train_on": diag["launches"]["train_on"],
               "pipelines_bf16_policy": pipes["bf16_policy"]["launches"],
               **{f"ladder_{k}": v for k, v in pipes["ladder"]["launches"].items()},
               **pipes["drivers"]["launches"],
               **measure["launches"]}

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
        "farm": farm,
        "zoo": zoo,
        "policies": pol,
        "dist": dist_rec,
        "diag": diag,
        "pipelines": pipes,
        "measure": measure,
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
