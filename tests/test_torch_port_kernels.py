"""The bin_counts kernel wrapper: its plain version against the JAX Pallas
kernel (interpret mode) and matmul binning on shared integer bins (CPU),
its input checks, and the CUDA kernel against the plain version on the
card (``-m cuda``; skipped where there is no card).

The JAX package is imported inside the CPU parity tests only: the card's
machine runs ``pytest -m cuda --noconftest`` on this file without JAX.
"""

import numpy as np
import pytest
import torch

from pointnav_vo_tpu_torch.ops import topdown as ttd
from pointnav_vo_tpu_torch.ops import topdown_kernels as tk


def _random_bins(rng, b, band, w_in, h, w):
    """Bins that include out-of-range rows/cols and dropped points."""
    pix_r = rng.integers(-3, h + 3, (b, band, w_in)).astype(np.int32)
    pix_c = rng.integers(-3, w + 3, (b, band, w_in)).astype(np.int32)
    keep = rng.uniform(size=(b, band, w_in)) < 0.8
    keep[0] = False
    return pix_r, pix_c, keep


def _torch(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("b,band,w_in,h,w", [(3, 20, 48, 32, 48), (2, 40, 96, 64, 96)])
def test_bin_counts_matches_pallas_random_bins(b, band, w_in, h, w):
    import jax.numpy as jnp

    from pointnav_vo_tpu.ops.topdown_pallas import bin_counts_pallas

    rng = np.random.default_rng(b + h)
    pix_r, pix_c, keep = _random_bins(rng, b, band, w_in, h, w)
    want = np.asarray(bin_counts_pallas(jnp.asarray(pix_r), jnp.asarray(pix_c),
                                        jnp.asarray(keep), h, w, interpret=True))
    got = tk.bin_counts(*_torch(pix_r, pix_c, keep), h, w).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32 and not got[0].any()


def test_bin_counts_matches_pallas_and_matmul_on_depth_bins():
    """Bins of real depth maps from the JAX pixel_bins: the plain version
    equals the Pallas kernel and the matmul binning of top_down_counts."""
    import jax
    import jax.numpy as jnp

    from pointnav_vo_tpu.ops import topdown as jtd
    from pointnav_vo_tpu.ops.topdown_pallas import bin_counts_pallas

    p = jtd.TopDownParams(vis_size_h=64, vis_size_w=96)
    rng = np.random.default_rng(0)
    depth = rng.uniform(0, 1, (3, 64, 96)).astype(np.float32)
    depth[1, :4] = 0.0
    pix_r, pix_c, keep = (np.asarray(a) for a in
                          jax.vmap(lambda d: jtd.pixel_bins(d, p))(jnp.asarray(depth)))
    got = tk.bin_counts(*_torch(pix_r, pix_c, keep), 64, 96).numpy()
    pallas = np.asarray(bin_counts_pallas(jnp.asarray(pix_r), jnp.asarray(pix_c),
                                          jnp.asarray(keep), 64, 96, interpret=True))
    matmul = np.stack([np.asarray(jtd.top_down_counts(jnp.asarray(d), p, impl="matmul"))
                       for d in depth])
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, matmul)
    assert got.sum() > 0


def test_bin_counts_cpu_path_launches_nothing():
    tk.reset_launch_counts()
    pix_r, pix_c, keep = _random_bins(np.random.default_rng(1), 2, 4, 8, 8, 8)
    tk.bin_counts(*_torch(pix_r, pix_c, keep), 8, 8)
    assert tk.launch_counts["bin_counts"] == 0


@pytest.mark.parametrize("bad", ["dtype", "keep_dtype", "shape", "rank"])
def test_bin_counts_rejects_bad_inputs(bad):
    pix_r, pix_c, keep = _torch(*_random_bins(np.random.default_rng(2), 2, 4, 8, 8, 8))
    if bad == "dtype":
        pix_r = pix_r.long()
    elif bad == "keep_dtype":
        keep = keep.to(torch.uint8)
    elif bad == "shape":
        pix_c = pix_c[:, :2]
    else:
        pix_r, pix_c, keep = pix_r[0], pix_c[0], keep[0]
    with pytest.raises((TypeError, ValueError)):
        tk.bin_counts(pix_r, pix_c, keep, 8, 8)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 32, 512])
def test_bin_counts_kernel_equals_plain_on_card(cuda, b):
    h, w = 192, 341
    rng = np.random.default_rng(b)
    bins = [t.to(cuda) for t in _torch(*_random_bins(rng, b, 100, w, h, w))]
    tk.reset_launch_counts()
    got = tk.bin_counts(*bins, h, w)
    torch.cuda.synchronize()
    assert tk.launch_counts["bin_counts"] == 1
    assert torch.equal(got, tk.bin_counts_reference(*bins, h, w))


@pytest.mark.cuda
def test_bin_counts_kernel_on_depth_bins_on_card(cuda):
    p = ttd.TopDownParams()
    depth = torch.from_numpy(
        np.random.default_rng(3).uniform(0, 1, (32, 192, 341)).astype(np.float32)).to(cuda)
    bins = ttd.pixel_bins(depth, p)
    got = tk.bin_counts(*bins, 192, 341)
    assert torch.equal(got, tk.bin_counts_reference(*bins, 192, 341))
    with pytest.raises(ValueError):  # non-contiguous CUDA input raises
        tk.bin_counts(bins[0].transpose(1, 2), bins[1].transpose(1, 2),
                      bins[2].transpose(1, 2), 192, 341)
