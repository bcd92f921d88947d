"""Top-down binning: the CUDA kernel ``csrc/bin_counts.cu`` and its plain
version (counterpart of ``ops/topdown_pallas.py::bin_counts_pallas``).

:func:`bin_counts` launches the kernel for CUDA tensors and runs
:func:`bin_counts_reference` for CPU tensors.  The kernel is a cluster-wide
shared-memory histogram: per image, a cluster of CTAs each bin a share of
the points into their own 16-bit counts and sum them through distributed
shared memory; :func:`cluster_plan` sizes it.  Nothing falls back: a CUDA
tensor, a grid or a point count that the kernel cannot take raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Mapping, NamedTuple

import torch

from pointnav_vo_tpu_torch.utils.logging import TRACER

# launches of each kernel wrapper, among the tracer's counters; a run resets
# and reads them to show that its path went through the kernel
launch_counts = TRACER.counters
launch_counts.setdefault("bin_counts", 0)

SMEM_LIMIT = 232_448  # bytes of shared memory one Hopper CTA can opt in to
MAX_CTA_POINTS = 2**16 - 1  # the most points one CTA adds: a 16-bit count holds them
SPLIT_SLACK = 10  # most points a CTA of a cluster adds beyond points / cluster
CLUSTER_SIZES = (1, 2, 3, 4, 8)  # the launcher's instantiations (8: the portable limit)
MAX_BANDS = 65_535  # the launch grid's y limit
CHUNK_CELLS = 64  # cells a touched flag covers


def smem_bytes(cells: int, cluster: int) -> int:
    """Shared memory of one CTA for a band of ``cells`` cells: the 16-bit
    counts, and in a cluster a touched flag a chunk of :data:`CHUNK_CELLS`
    cells plus a copy of every peer's flags; each part rounded up to 16 B
    (``smem_needed`` in ``csrc/bin_counts.cu``)."""
    grid = -(-cells // 8) * 16
    flags = -(-(-(-cells // CHUNK_CELLS)) // 16) * 16
    return grid + ((1 + cluster) * flags if cluster > 1 else 0)


# the most cells a band may hold: the largest cluster's plan fits one CTA
MAX_BAND_CELLS = next(c for c in range(SMEM_LIMIT // 2, 0, -1)
                      if smem_bytes(c, CLUSTER_SIZES[-1]) <= SMEM_LIMIT)


def reset_launch_counts() -> None:
    """Zero the launch counts and every other counter of the tracer, and
    clear its spans: the start of a measured window."""
    TRACER.reset()


def _check(pix_r, pix_c, keep):
    if pix_r.dim() != 3:
        raise ValueError(f"expected [B, band, W] bins, got {tuple(pix_r.shape)}")
    if pix_r.shape != pix_c.shape or pix_r.shape != keep.shape:
        raise ValueError(f"shape mismatch: {tuple(pix_r.shape)}, "
                         f"{tuple(pix_c.shape)}, {tuple(keep.shape)}")
    if pix_r.dtype != torch.int32 or pix_c.dtype != torch.int32:
        raise TypeError(f"bins must be int32, got {pix_r.dtype}, {pix_c.dtype}")
    if keep.dtype != torch.bool:
        raise TypeError(f"keep must be bool, got {keep.dtype}")
    if not (pix_r.device == pix_c.device == keep.device):
        raise ValueError("pix_r, pix_c and keep must lie on one device")


def bin_counts_reference(pix_r: torch.Tensor, pix_c: torch.Tensor,
                         keep: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Plain version: scatter-add of ones on the flat cell index.  Points
    that are not kept or fall outside the grid go to a dropped extra cell."""
    _check(pix_r, pix_c, keep)
    b = pix_r.shape[0]
    ok = keep & (pix_r >= 0) & (pix_r < h) & (pix_c >= 0) & (pix_c < w)
    img = torch.arange(b, device=pix_r.device).view(b, 1, 1)
    flat = (img * h + pix_r.long()) * w + pix_c.long()
    flat = torch.where(ok, flat, b * h * w).reshape(-1)
    out = torch.zeros(b * h * w + 1, dtype=torch.float32, device=pix_r.device)
    out.scatter_add_(0, flat, torch.ones(flat.shape, dtype=torch.float32,
                                         device=pix_r.device))
    return out[:-1].view(b, h, w)


class ClusterPlan(NamedTuple):
    cluster: int  # CTAs per image and band; they split the image's points
    rows_per_band: int  # grid rows one CTA's shared memory holds
    bands: int  # bands of rows, each binned by its own clusters
    smem_bytes: int  # shared memory a CTA: the band's 16-bit counts


def cluster_plan(h: int, w: int, points_per_image: int, n_images: int = 1,
                 active_clusters: Mapping[int, int] | None = None) -> ClusterPlan:
    """How the kernel covers ``n_images`` grids of ``h x w`` cells.

    A CTA holds a band of rows as 16-bit counts, two cells to a 32-bit word,
    in at most :data:`SMEM_LIMIT` bytes (:func:`smem_bytes`); a grid too
    tall for one CTA is cut into equal bands.  A cluster of CTAs splits each
    image's points: at least so many that no CTA adds more than a 16-bit
    count holds, and, given ``active_clusters`` (cluster size -> clusters
    the card holds at once), the largest size whose clusters for the whole
    batch run in one wave, so a small batch spreads over the SMs.

    Raises ``ValueError`` for an empty grid, a row wider than one CTA's
    shared memory, or more points per image than the largest cluster's
    16-bit counts hold.
    """
    if h < 1 or w < 1:
        raise ValueError(f"empty grid {h}x{w}")
    if points_per_image < 0 or n_images < 0:
        raise ValueError(f"negative sizes: {points_per_image} points, {n_images} images")
    if w > MAX_BAND_CELLS:
        raise ValueError(f"a row of {w} 16-bit counts is more than one CTA's "
                         f"{SMEM_LIMIT} B of shared memory holds")
    bands = -(-h // (MAX_BAND_CELLS // w))
    rows = -(-h // bands)
    if bands > MAX_BANDS:
        raise ValueError(f"a {h}x{w} grid needs {bands} bands, more than {MAX_BANDS}")
    fits = [s for s in CLUSTER_SIZES
            if -(-points_per_image // s) + SPLIT_SLACK <= MAX_CTA_POINTS]
    if not fits:
        raise ValueError(f"{points_per_image} points per image: a cluster of "
                         f"{CLUSTER_SIZES[-1]} CTAs with 16-bit counts holds at most "
                         f"{CLUSTER_SIZES[-1] * (MAX_CTA_POINTS - SPLIT_SLACK)}")
    cluster = fits[0]
    if active_clusters is not None:
        one_wave = [s for s in fits if n_images * bands <= active_clusters.get(s, 0)]
        cluster = max(one_wave, default=cluster)
    return ClusterPlan(cluster, rows, bands, smem_bytes(rows * w, cluster))


def card_plan(n_images: int, points_per_image: int, h: int, w: int,
              device: torch.device) -> ClusterPlan:
    """The plan :func:`bin_counts` launches on the CUDA ``device``: spread
    by the card's own cluster occupancy (nothing is queried for no images)."""
    plan = cluster_plan(h, w, points_per_image)
    if n_images == 0:
        return plan
    return cluster_plan(h, w, points_per_image, n_images,
                        _active_clusters(device, plan.rows_per_band * w))


@functools.lru_cache(maxsize=None)
def _active_clusters(device: torch.device, band_cells: int) -> dict:
    """Cluster size -> clusters of the kernel the card holds at once."""
    fn = _library().bin_counts_active_clusters
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        counts = {s: fn(s, smem_bytes(band_cells, s)) for s in CLUSTER_SIZES}
    bad = {s: n for s, n in counts.items() if n < 0}
    if bad:
        raise RuntimeError(f"bin_counts occupancy query failed: CUDA errors {bad}")
    return counts


@functools.lru_cache(maxsize=1)
def _library():
    from pointnav_vo_tpu_torch import kernels

    return kernels.load("bin_counts")


@functools.lru_cache(maxsize=1)
def _launcher():
    fn = _library().bin_counts_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_int64] + \
        [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def bin_counts(pix_r: torch.Tensor, pix_c: torch.Tensor, keep: torch.Tensor,
               h: int, w: int) -> torch.Tensor:
    """Per image, the count of kept in-range points in each (row, col) cell.

    pix_r, pix_c: int32 ``[B, band, W_in]``; keep: bool, same shape.
    Returns float32 ``[B, h, w]`` (exact integer counts).
    """
    _check(pix_r, pix_c, keep)
    if pix_r.device.type == "cpu":
        return bin_counts_reference(pix_r, pix_c, keep, h, w)
    if pix_r.device.type != "cuda":
        raise ValueError(f"bin_counts runs on CUDA or CPU, got {pix_r.device}")
    if not (pix_r.is_contiguous() and pix_c.is_contiguous() and keep.is_contiguous()):
        raise ValueError("bin_counts needs contiguous inputs")
    b, band, w_in = pix_r.shape
    plan = card_plan(b, band * w_in, h, w, pix_r.device)
    # the kernel writes every cell: no memset
    out = torch.empty((b, h, w), dtype=torch.float32, device=pix_r.device)
    if b == 0:
        return out
    with torch.cuda.device(pix_r.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launcher()(pix_r.data_ptr(), pix_c.data_ptr(), keep.data_ptr(),
                          out.data_ptr(), b, band * w_in, h, w, plan.cluster,
                          plan.rows_per_band, plan.smem_bytes, stream)
    if err != 0:
        raise RuntimeError(f"bin_counts kernel launch failed: CUDA error {err}")
    TRACER.count("bin_counts")
    return out
