"""The steady-state det VO step split into its stages on the card
(counterpart of ``examples/profile_vo_step.py``).

    python -m pointnav_vo_tpu_torch.examples.profile_vo_step [--device cpu]

At the bench configuration (``BENCH_BATCH`` 512, 341x192, bf16, a 70 %
forward mix, ``default_rng(0)`` inputs, every weight 0.01) each stage of
``VOEnsemble.predict_step_cached`` runs alone:

1. ``frame_features_packed`` (cast, discretized depth, top-down, pack);
2. ``top_down_view_batch`` with the ``bin_counts`` kernel, and with its
   plain version (``bin_counts_reference``; the JAX script's pallas/matmul
   pair); the two views must be ``torch.equal``;
3. each expert's row selection (``index_select``, the port's form of the
   one-hot einsums) on the packed pair;
4. the expert forwards on pre-sliced contiguous rows (no selection);
5. the full ``predict_step_cached``.

Each stage is ``BENCH_ITERS`` back-to-back calls timed by CUDA events with
one synchronize at the end; on the line before, the device time of the
same calls from ``torch.profiler`` (the sum of their kernels; "not
measured" where the profiler saw none).  On the CPU
the times are the host clock's and no device time is measured.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from pointnav_vo_tpu_torch.common import resolve_device
from pointnav_vo_tpu_torch.examples.full_eval_benchmark import constant_weights_
from pointnav_vo_tpu_torch.ops.topdown import normalize_counts, pixel_bins, top_down_view_batch
from pointnav_vo_tpu_torch.ops import topdown_kernels
from pointnav_vo_tpu_torch.ops.topdown_kernels import bin_counts_reference
from pointnav_vo_tpu_torch.vo.ensemble import (VOEnsemble, VOInferenceConfig, dequantize_rows,
                                               expert_rows, frame_features_packed)

BATCH = int(os.environ.get("BENCH_BATCH", 512))
ITERS = int(os.environ.get("BENCH_ITERS", 8))


def inputs(batch: int, h: int, w: int, seed: int = 0):
    """rgb ``[B, h, w, 3]`` and depth ``[B, h, w, 1]`` float32 and the
    host actions, 70 % forward, the rest turns, from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    rgb = rng.uniform(0, 255, (batch, h, w, 3)).astype(np.float32)
    depth = rng.uniform(0, 1, (batch, h, w, 1)).astype(np.float32)
    actions = np.where(rng.uniform(size=batch) < 0.7, 1,
                       rng.integers(2, 4, batch)).astype(np.int32)
    return rgb, depth, actions


def top_down_plain(depth: torch.Tensor, cfg: VOInferenceConfig) -> torch.Tensor:
    """``top_down_view_batch`` with ``bin_counts``' plain version."""
    p = cfg.topdown_params
    pix_r, pix_c, keep = pixel_bins(depth, p)
    return normalize_counts(bin_counts_reference(pix_r, pix_c, keep, p.vis_size_h,
                                                 p.vis_size_w))


def select_rows(pair: torch.Tensor, actions_np) -> List[torch.Tensor]:
    """Each non-empty expert's rows of the packed pair, as
    ``predict_packed`` gathers them."""
    return [pair.index_select(0, torch.from_numpy(rows).to(pair.device))
            for rows in expert_rows(actions_np) if rows.size]


def expert_forwards(ensemble: VOEnsemble, subs: List[torch.Tensor],
                    actions_np) -> List[torch.Tensor]:
    """Each non-empty expert's deltas (float32) of its rows ``subs``."""
    experts = [m for m, rows in zip(ensemble.experts, expert_rows(actions_np)) if rows.size]
    return [m(dequantize_rows(sub, ensemble.cfg)).float() for m, sub in zip(experts, subs)]


def _device_ms(fn: Callable, iters: int) -> Optional[float]:
    """The kernels' device time a call, or None where the profiler saw
    none (not measured)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    return total / 1e3 / iters if total > 0 else None


def timed(name: str, fn: Callable, batch: int, iters: int, device, unit: str) -> Dict:
    """Warm up, then ``iters`` calls back to back: ms a call (CUDA events,
    one synchronize; the host clock on the CPU) and, on the card, the
    profiler's device ms of the same calls, printed on the line before."""
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
        device_ms = _device_ms(fn, iters)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / iters
        print(f"{'  device (torch.profiler, same calls)':45s} " + (
            f"{device_ms:8.2f} ms/step" if device_ms is not None
            else "not measured (the profiler saw no kernels)"))
    else:
        device_ms = None
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        ms = (time.perf_counter() - t0) * 1e3 / iters
        print(f"{'  device':45s} not measured (CPU run; host clock below)")
    print(f"{name:45s} {ms:8.2f} ms/step  ({batch / ms * 1e3:8.0f} {unit}/s)", flush=True)
    flat = out if isinstance(out, (list, tuple)) else [out]
    finite = all(bool(torch.isfinite(t.float()).all()) for t in flat)
    return {"ms": ms, "device_ms": device_ms, "per_s": batch / ms * 1e3, "finite": finite}


@torch.no_grad()
def profile(batch: int, iters: int, device, h: int = 192, w: int = 341) -> Dict:
    """The five stages at ``batch`` on ``h`` x ``w`` frames; returns each
    stage's times and whether its output is finite, and stage 2's
    kernel-vs-plain check."""
    cfg = VOInferenceConfig(precision="bf16", vis_size_h=h, vis_size_w=w)
    before = topdown_kernels.launch_counts["bin_counts"]
    rgb_np, depth_np, actions = inputs(batch, h, w)
    rgb = torch.from_numpy(rgb_np).to(device)
    depth = torch.from_numpy(depth_np).to(device)
    ensemble = VOEnsemble(cfg, experts=[constant_weights_(cfg.make_model()) for _ in range(3)],
                          device=device)
    feats = frame_features_packed(rgb, depth, cfg)
    pair = torch.cat([feats, feats], dim=-1)
    rec = {"batch": batch, "iters": iters,
           "mix": {str(a): int((actions == a).sum()) for a in (1, 2, 3)}}
    rec["features"] = timed("frame_features_packed (full preprocess)",
                            lambda: frame_features_packed(rgb, depth, cfg), batch, iters,
                            device, "img")
    d2 = depth[..., 0]
    kernel_view = top_down_view_batch(d2, cfg.topdown_params)
    plain_view = top_down_plain(d2, cfg)
    rec["topdown_equal"] = bool(torch.equal(kernel_view, plain_view))
    if not rec["topdown_equal"]:
        raise AssertionError("top_down_view_batch: the kernel's view != the plain version's")
    rec["topdown_kernel"] = timed("top_down_view_batch[kernel]",
                                  lambda: top_down_view_batch(d2, cfg.topdown_params), batch,
                                  iters, device, "img")
    rec["topdown_plain"] = timed("top_down_view_batch[plain]", lambda: top_down_plain(d2, cfg),
                                 batch, iters, device, "img")
    rec["select"] = timed("expert row selection (index_select)",
                          lambda: select_rows(pair, actions), batch, iters, device, "pairs")
    subs = [pair[:rows.size] for rows in expert_rows(actions) if rows.size]
    rec["forwards"] = timed("expert forwards (pre-sliced rows)",
                            lambda: expert_forwards(ensemble, subs, actions), batch, iters,
                            device, "pairs")
    rec["full"] = timed("FULL fused step (predict_step_cached)",
                        lambda: ensemble.predict_step_cached(feats, rgb, depth, actions)[0],
                        batch, iters, device, "pairs")
    rec["bin_counts_launches"] = None
    if device.type == "cuda":
        # the cache and the check once each; three stages, each warmed up,
        # profiled and timed
        expected = 2 + 3 * (1 + 2 * iters)
        rec["bin_counts_launches"] = topdown_kernels.launch_counts["bin_counts"] - before
        if rec["bin_counts_launches"] != expected:
            raise AssertionError(f"bin_counts launched {rec['bin_counts_launches']} times; "
                                 f"expected {expected}")
    return rec


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    return profile(BATCH, ITERS, resolve_device(args.device))


if __name__ == "__main__":
    main()
