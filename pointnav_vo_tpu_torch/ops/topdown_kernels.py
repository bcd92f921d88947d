"""Top-down binning: the CUDA kernel ``csrc/bin_counts.cu`` and its plain
version (counterpart of ``ops/topdown_pallas.py::bin_counts_pallas``).

:func:`bin_counts` launches the kernel for CUDA tensors and runs
:func:`bin_counts_reference` for CPU tensors.  Nothing falls back: a CUDA
tensor that the kernel cannot take raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

# launches of each kernel wrapper; a run resets and reads them to show that
# its path went through the kernel
launch_counts = {"bin_counts": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


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


@functools.lru_cache(maxsize=1)
def _launcher():
    from pointnav_vo_tpu_torch import kernels

    fn = kernels.load("bin_counts").bin_counts_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_int64,
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
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
    out = torch.zeros((b, h, w), dtype=torch.float32, device=pix_r.device)
    with torch.cuda.device(pix_r.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launcher()(pix_r.data_ptr(), pix_c.data_ptr(), keep.data_ptr(),
                          out.data_ptr(), b, band * w_in, h, w, stream)
    if err != 0:
        raise RuntimeError(f"bin_counts kernel launch failed: CUDA error {err}")
    launch_counts["bin_counts"] += 1
    return out
