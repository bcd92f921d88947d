"""The bin_counts kernel wrapper: its plain version against the JAX Pallas
kernel (interpret mode) and matmul binning on shared integer bins (CPU),
its input checks and cluster plan, and the CUDA kernel against the plain
version on the card (``-m cuda``; skipped where there is no card).

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


PLAN_GRIDS = [(192, 341), (64, 96), (32, 48), (190, 341), (1, 1)]
H100_CLUSTERS = {1: 132, 2: 66, 3: 39, 4: 30, 8: 15}  # measured at 192x341 (PERF.md)


@pytest.mark.parametrize("h,w", PLAN_GRIDS)
def test_histogram_smem_gives_every_cell_one_half_word(h, w):
    """A CTA's shared memory holds a 16-bit count for every cell of its band
    (half a word a cell, rounded up to 16 B), and in a cluster one touched
    flag per 64 cells and a copy of every peer's flags; it stays within the
    227 KB a Hopper CTA can hold."""
    for cluster in tk.CLUSTER_SIZES:
        plan = tk.cluster_plan(h, w, 100 * w)
        smem = tk.smem_bytes(plan.rows_per_band * w, cluster)
        grid = -(-(plan.rows_per_band * w) // 2) * 4
        assert smem % 16 == 0 and grid <= smem <= tk.SMEM_LIMIT == 227 * 1024
        if cluster == 1:
            assert smem - 16 < grid
        else:
            flags = smem - -(-grid // 16) * 16
            assert flags % (cluster + 1) == 0
            assert flags // (cluster + 1) >= -(-(plan.rows_per_band * w) // tk.CHUNK_CELLS)


def test_histogram_smem_at_the_main_path_shape():
    assert tk.smem_bytes(192 * 341, 1) == 130_944  # 192 * 341 cells * 2 B
    assert tk.smem_bytes(192 * 341, 3) == 130_944 + 4 * 1_024  # 1,023 chunk flags
    assert tk.cluster_plan(192, 341, 100 * 341).smem_bytes == 130_944


@pytest.mark.parametrize("h,w,points", [(0, 341, 10), (192, 0, 10), (192, 341, -1),
                                        (192, 341, 8 * 65_525 + 1), (1, 120_000, 10),
                                        (192, 341, 10**7)])
def test_histogram_smem_rejects_what_16_bit_counts_cannot_hold(h, w, points):
    """Empty grids, a row wider than one CTA's shared memory, and images with
    more points than a cluster of 8 CTAs with 16-bit counts holds."""
    with pytest.raises(ValueError):
        tk.cluster_plan(h, w, points)


@pytest.mark.parametrize("h,w", PLAN_GRIDS + [(400, 341), (1000, 1000), (480, 640)])
@pytest.mark.parametrize("b", [1, 32, 512])
def test_cluster_plan_gives_every_row_one_owner(h, w, b):
    """Bands of rows_per_band rows cover the grid: every row lies in exactly
    one band, the bands together hold at least h rows, and each CTA's shared
    memory fits; grids too large for one CTA are cut, not refused."""
    plan = tk.cluster_plan(h, w, 100 * w, b, H100_CLUSTERS)
    owners = np.arange(h) // plan.rows_per_band
    assert np.array_equal(np.bincount(owners, minlength=plan.bands),
                          [min(plan.rows_per_band, h - k * plan.rows_per_band)
                           for k in range(plan.bands)])
    assert plan.rows_per_band * plan.bands >= h > plan.rows_per_band * (plan.bands - 1)
    assert plan.smem_bytes == tk.smem_bytes(plan.rows_per_band * w, plan.cluster)
    assert plan.smem_bytes <= tk.SMEM_LIMIT
    assert plan.cluster in tk.CLUSTER_SIZES


@pytest.mark.parametrize("b,cluster", [(1, 8), (15, 8), (16, 4), (30, 4), (32, 3), (39, 3),
                                       (64, 2), (66, 2), (128, 1), (512, 1), (0, 8)])
def test_cluster_plan_spreads_a_small_batch_over_one_wave(b, cluster):
    """The largest cluster whose clusters for the batch the card holds at
    once: at 32 envs, 3 CTAs an image (32 clusters of 4 would take two
    waves on the 30 an H100 holds)."""
    assert tk.cluster_plan(192, 341, 100 * 341, b, H100_CLUSTERS).cluster == cluster


@pytest.mark.parametrize("points,cluster", [(34_100, 1), (65_525, 1), (65_526, 2),
                                            (131_050, 2), (131_051, 3), (4 * 65_525, 4),
                                            (4 * 65_525 + 1, 8)])
def test_cluster_plan_splits_points_a_16_bit_count_cannot_hold(points, cluster):
    """Without the card's occupancy the plan takes the smallest cluster in
    which no CTA adds more than 65,535 points (P / S plus the scalar head and
    tail of the split)."""
    plan = tk.cluster_plan(192, 341, points)
    assert plan.cluster == cluster
    assert -(-points // plan.cluster) + tk.SPLIT_SLACK <= tk.MAX_CTA_POINTS


@pytest.mark.parametrize("h,w", PLAN_GRIDS)
def test_packed_16_bit_histogram_model_equals_plain(h, w):
    """A numpy model of the kernel's arithmetic, not the kernel: each of S
    ranks adds 1 << 16 * (i & 1) into word i >> 1 of its own grid for its
    contiguous share of the points, and the halves summed over the S grids
    equal the plain version.  The card's tests check the kernel itself."""
    rng = np.random.default_rng(h * w)
    pix_r, pix_c, keep = _random_bins(rng, 3, 10, 48, h, w)
    ok = keep & (pix_r >= 0) & (pix_r < h) & (pix_c >= 0) & (pix_c < w)
    want = tk.bin_counts(*_torch(pix_r, pix_c, keep), h, w).numpy()
    n = 10 * 48
    for s in tk.CLUSTER_SIZES:
        got = np.zeros((3, h * w), np.float32)
        for b in range(3):
            cell = (pix_r[b] * w + pix_c[b]).reshape(-1)
            kept = ok[b].reshape(-1)
            for rank in range(s):
                share = slice(n * rank // s, n * (rank + 1) // s)
                c = cell[share][kept[share]]
                words = np.zeros(-(-h * w // 2), np.uint32)
                np.add.at(words, c >> 1, (1 << (16 * (c & 1))).astype(np.uint32))
                got[b] += np.stack([words & 0xFFFF, words >> 16], axis=1).reshape(-1)[:h * w]
        np.testing.assert_array_equal(got.reshape(3, h, w), want)


def test_bin_counts_cpu_batch_zero():
    pix = torch.zeros((0, 4, 8), dtype=torch.int32)
    out = tk.bin_counts(pix, pix, torch.zeros((0, 4, 8), dtype=torch.bool), 8, 8)
    assert out.shape == (0, 8, 8) and out.dtype == torch.float32


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _garbage_then(fn, shape, device):
    """Run ``fn`` right after freeing a NaN-filled block of ``shape``, so an
    output allocated with ``torch.empty`` starts as garbage."""
    garbage = torch.full(shape, float("nan"), device=device)
    del garbage
    return fn()


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 32, 512])
def test_bin_counts_kernel_equals_plain_on_card(cuda, b):
    h, w = 192, 341
    rng = np.random.default_rng(b)
    bins = [t.to(cuda) for t in _torch(*_random_bins(rng, b, 100, w, h, w))]
    tk.reset_launch_counts()
    got = _garbage_then(lambda: tk.bin_counts(*bins, h, w), (b, h, w), cuda)
    torch.cuda.synchronize()
    assert tk.launch_counts["bin_counts"] == 1
    assert torch.equal(got, tk.bin_counts_reference(*bins, h, w))


@pytest.mark.cuda
@pytest.mark.parametrize("b,band,w_in,h,w", [(32, 100, 341, 190, 341), (5, 40, 96, 64, 96),
                                             (3, 7, 13, 37, 29)])
def test_bin_counts_kernel_other_grids(cuda, b, band, w_in, h, w):
    """A height off the main path's; the last shape has an odd cell count
    (a word with one cell, outputs not 16-byte aligned) and a point count
    per image that is no multiple of 4 (the scalar loads)."""
    rng = np.random.default_rng(h)
    bins = [t.to(cuda) for t in _torch(*_random_bins(rng, b, band, w_in, h, w))]
    got = _garbage_then(lambda: tk.bin_counts(*bins, h, w), (b, h, w), cuda)
    assert torch.equal(got, tk.bin_counts_reference(*bins, h, w))


@pytest.mark.cuda
def test_bin_counts_kernel_hot_cell_exact(cuda):
    """Every one of an image's 34,100 points in one cell: the count is exact
    and does not carry into the cell that shares its word."""
    b, band, h, w = 4, 100, 192, 341
    rng = np.random.default_rng(7)
    pix_r = torch.from_numpy(rng.integers(0, h, (b, 1, 1)).astype(np.int32))
    pix_c = torch.from_numpy(rng.integers(0, w, (b, 1, 1)).astype(np.int32))
    bins = [pix_r.expand(b, band, w).contiguous().to(cuda),
            pix_c.expand(b, band, w).contiguous().to(cuda),
            torch.ones((b, band, w), dtype=torch.bool, device=cuda)]
    got = tk.bin_counts(*bins, h, w)
    assert torch.equal(got, tk.bin_counts_reference(*bins, h, w))
    assert got.amax(dim=(1, 2)).tolist() == [band * w] * b
    assert int(got.sum()) == b * band * w


@pytest.mark.cuda
def test_bin_counts_kernel_all_dropped_writes_zeros(cuda):
    """No point kept: every cell of the torch.empty output is written 0."""
    b, band, h, w = 32, 100, 192, 341
    pix = torch.zeros((b, band, w), dtype=torch.int32, device=cuda)
    keep = torch.zeros((b, band, w), dtype=torch.bool, device=cuda)
    got = _garbage_then(lambda: tk.bin_counts(pix, pix, keep, h, w), (b, h, w), cuda)
    assert torch.equal(got, torch.zeros((b, h, w), device=cuda))


@pytest.mark.cuda
def test_bin_counts_kernel_batch_zero_launches_nothing(cuda):
    pix = torch.zeros((0, 100, 341), dtype=torch.int32, device=cuda)
    tk.reset_launch_counts()
    out = tk.bin_counts(pix, pix, torch.zeros((0, 100, 341), dtype=torch.bool, device=cuda),
                        192, 341)
    assert out.shape == (0, 192, 341) and out.is_cuda
    assert tk.launch_counts["bin_counts"] == 0


@pytest.mark.cuda
def test_bin_counts_kernel_refuses_what_it_cannot_hold(cuda):
    """The wrapper raises before a launch; the launcher refuses too little
    shared memory, too many points for the cluster and a cluster size it has
    no kernel for."""
    pix = torch.zeros((1, 1, 120_000), dtype=torch.int32, device=cuda)
    keep = torch.ones((1, 1, 120_000), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):  # a row wider than one CTA's shared memory
        tk.bin_counts(pix, pix, keep, 1, 120_000)
    out = torch.empty((1, 192, 341), device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    args = (pix.data_ptr(), pix.data_ptr(), keep.data_ptr(), out.data_ptr(), 1)
    assert tk._launcher()(*args, 100 * 341, 192, 341, 1, 192, 64, stream) != 0
    assert tk._launcher()(*args, 2**16, 192, 341, 1, 192, 130_944, stream) != 0
    assert tk._launcher()(*args, 100 * 341, 192, 341, 5, 192, 2**17, stream) != 0
    assert tk._launcher()(*args, 100 * 341, 192, 341, 3, 192, 130_944, stream) != 0


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [1, 2, 3, 4, 8])
def test_bin_counts_kernel_every_cluster_size_equals_plain(cuda, cluster):
    """The launcher at each cluster size, on a batch of 5 images whose
    point count per image (33,999) is no multiple of 4."""
    b, band, w_in, h, w = 5, 99, 343, 192, 341
    rng = np.random.default_rng(cluster)
    bins = [t.to(cuda) for t in _torch(*_random_bins(rng, b, band, w_in, h, w))]
    rows = tk.cluster_plan(h, w, band * w_in).rows_per_band
    out = _garbage_then(lambda: torch.empty((b, h, w), device=cuda), (b, h, w), cuda)
    err = tk._launcher()(bins[0].data_ptr(), bins[1].data_ptr(), bins[2].data_ptr(),
                         out.data_ptr(), b, band * w_in, h, w, cluster, rows,
                         tk.smem_bytes(rows * w, cluster),
                         torch.cuda.current_stream().cuda_stream)
    assert err == 0
    assert torch.equal(out, tk.bin_counts_reference(*bins, h, w))


@pytest.mark.cuda
def test_bin_counts_kernel_after_a_smaller_plan(cuda):
    """A small grid's plan, queried and launched first, does not shrink the
    shared memory the main path's launch may use."""
    rng = np.random.default_rng(11)
    for b, band, w_in, h, w in [(3, 7, 13, 37, 29), (5, 100, 341, 192, 341),
                                (1, 7, 13, 37, 29), (1, 100, 341, 192, 341)]:
        bins = [t.to(cuda) for t in _torch(*_random_bins(rng, b, band, w_in, h, w))]
        assert torch.equal(tk.bin_counts(*bins, h, w), tk.bin_counts_reference(*bins, h, w))


@pytest.mark.cuda
@pytest.mark.parametrize("b,band,w_in,h,w", [(2, 100, 341, 400, 341), (2, 200, 700, 192, 341),
                                             (3, 50, 640, 480, 640)])
def test_bin_counts_kernel_beyond_one_cta(cuda, b, band, w_in, h, w):
    """Grids taller than one CTA's shared memory (bands of rows) and more
    points per image than a 16-bit count holds (a cluster splits them)."""
    rng = np.random.default_rng(band)
    bins = [t.to(cuda) for t in _torch(*_random_bins(rng, b, band, w_in, h, w))]
    got = _garbage_then(lambda: tk.bin_counts(*bins, h, w), (b, h, w), cuda)
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
