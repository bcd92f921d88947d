// Top-down point binning for Hopper (sm_90a): a cluster-wide shared-memory
// histogram.
//
// Replaces pointnav_vo_tpu/ops/topdown_pallas.py::bin_counts_pallas, which
// counts each image's kept candidate points per (row, col) cell of the
// top-down grid as an int8 one-hot matmul on the TPU's matrix unit.  On the
// GPU the same function is a histogram with data-dependent addresses, so
// this kernel scatters instead of multiplying.
//
// Inputs, per image: P = band * W_in candidate points (100 * 341 = 34,100
// at 341x192), each with an int32 row bin, an int32 column bin and a 1-byte
// keep flag.  Output: float32 [B, h, w] counts; every cell is written by the
// kernel, so the caller allocates it uninitialised.
//
// Bound: memory.  The kernel reads the keep byte of every point and the two
// int32 bins of the kept ones (at most 9 B/point), and writes 4 B per output
// cell once; it does no arithmetic worth counting.  All kept: at batch 512,
// 17,459,200 * 9 B + 33,521,664 * 4 B = 291 MB, 87 us at 3.35 TB/s; at 32
// envs 18.2 MB, 5.4 us.
//
// Design: a cluster of S CTAs (S = 1, 2, 3, 4 or 8) per image and band of
// rows, planned by ops/topdown_kernels.py::cluster_plan.  Every CTA holds
// the band's whole grid in its own shared memory as 16-bit counts, two
// cells to a 32-bit word (130,944 B for 192x341; 32-bit counts would not
// fit a CTA), and bins 1/S of the image's points into it.  The cluster then
// sums its S grids through distributed shared memory (DSMEM): CTA k reads
// the k-th slice of every peer's grid, adds, widens to float32 and stores
// the slice once.  Phases:
//   1. zero the CTA's grid and its touched flags (one byte per 64 cells);
//   2. read the CTA's share of the points as int4 / uchar4 (four points a
//      thread) and add each kept point of the band to its half-word with a
//      shared-memory atomic, and mark the cell's chunk touched;
//   3. cluster barrier; copy every peer's flags; sum the CTA's slice over
//      the S grids (ld.shared::cluster, only chunks the peer touched), one
//      float4 (four cells) a thread, and store it;
//   4. cluster barrier, so no CTA exits while a peer reads its grid.
// A CTA adds at most P / S + 10 points, which the launcher requires to be
// below 2^16, so no count carries into its neighbour; the sums are 32-bit.
// Device memory sees each input byte read once per band and each output
// cell written once: no memset and no read-modify-write.  Integer adds are
// exact and independent of order, so the result equals the plain version
// bit for bit.
//
// Measured on the H100 (PERF.md):
// - Adds into a peer's shared memory (atomicAdd on a map_shared_rank
//   pointer, or red.shared::cluster) compile to generic GPU-scope atomics
//   (ATOM.E.ADD), not ATOMS, so a cluster that splits the grid by rows and
//   adds into its peers' bands lost to global atomics.  The adds stay local.
// - DSMEM reads run at about 26 GB/s per SM, so the reduction skips the
//   chunks a peer never touched: scripted depth fills 12-27 % of chunks.
// - One CTA streams 307 KB in and 262 KB out per image at a few tens of
//   GB/s, so a small batch needs S > 1 to use more SMs; with 135 KB of
//   shared memory a CTA fills its SM, and the card holds 132 / 66 / 39 /
//   30 / 15 clusters of 1 / 2 / 3 / 4 / 8.  The plan takes the largest S
//   whose clusters run in one wave: S = 3 at batch 32, S = 1 from 128 on.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kUnroll = 2;  // four-point groups a thread loads before it adds
constexpr int64_t kMaxCtaPoints = 65535;  // largest count a 16-bit cell holds
constexpr int64_t kSplitSlack = 10;  // most points a CTA adds beyond P / S
constexpr int kSmemLimit = 232448;  // the most shared memory a CTA can opt in to
constexpr int kChunkShift = 6;  // a touched flag covers 64 cells (16 word pairs)

// Shared memory of a CTA for `cells` cells in clusters of S: the 16-bit
// counts; for S > 1 also a byte a chunk that says whether the CTA added into
// it, and a copy of every peer's flags.  Each part rounded up to 16 bytes.
__host__ __device__ __forceinline__ int64_t grid_bytes(int64_t cells) {
  return (cells + 7) / 8 * 16;
}
__host__ __device__ __forceinline__ int64_t flag_bytes(int64_t cells) {
  return (((cells + (1 << kChunkShift) - 1) >> kChunkShift) + 15) / 16 * 16;
}
__host__ __device__ __forceinline__ int64_t smem_needed(int64_t cells, int cluster) {
  return grid_bytes(cells) + (cluster > 1 ? (1 + cluster) * flag_bytes(cells) : 0);
}

template <int S>
__device__ __forceinline__ void add_point(uint32_t* grid, uint8_t* flags, bool kept, int r,
                                          int c, int rows, int w) {
  if (kept && (unsigned)r < (unsigned)rows && (unsigned)c < (unsigned)w) {
    const int i = r * w + c;
    atomicAdd(grid + (i >> 1), 1u << ((i & 1) * 16));
    if (S > 1) flags[i >> kChunkShift] = 1;  // every writer stores the same 1
  }
}

// The shared::cluster address of `local` in the shared memory of cluster
// rank `rank`.
__device__ __forceinline__ uint32_t peer_address(const void* local, unsigned rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out)
               : "r"((uint32_t)__cvta_generic_to_shared(local)), "r"(rank));
  return out;
}

__device__ __forceinline__ uint2 load_peer2(uint32_t addr) {
  uint2 v;
  asm volatile("ld.shared::cluster.v2.u32 {%0, %1}, [%2];"
               : "=r"(v.x), "=r"(v.y)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ uint32_t load_peer(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared::cluster.u32 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

template <int S>
__device__ __forceinline__ void cluster_barrier(cg::cluster_group& cluster) {
  if (S > 1) {
    cluster.sync();
  } else {
    __syncthreads();
  }
}

template <int S>
__global__ void __launch_bounds__(kThreads)
bin_counts_kernel(const int32_t* __restrict__ pix_r, const int32_t* __restrict__ pix_c,
                  const uint8_t* __restrict__ keep, float* __restrict__ out,
                  int64_t points_per_image, int h, int w, int rows_per_band, int vec_in) {
  extern __shared__ uint4 smem[];
  uint32_t* grid = reinterpret_cast<uint32_t*>(smem);
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = S > 1 ? cluster.block_rank() : 0;
  const int64_t img = blockIdx.x / S;
  const int row0 = blockIdx.y * rows_per_band;
  const int rows = min(rows_per_band, h - row0);
  const int cells = rows * w;  // of this band
  const int tid = threadIdx.x;
  uint8_t* flags = reinterpret_cast<uint8_t*>(smem) + grid_bytes(cells);
  const int fbytes = (int)flag_bytes(cells);
  uint8_t* peer_flags = flags + fbytes;  // [S][fbytes], filled in phase 3

  // This CTA's share of the image's points: rank 0 takes the scalar head
  // [s, head), rank S - 1 the scalar tail [body, e), and the ranks split the
  // four-point groups of [head, body) into S contiguous runs.  Without
  // aligned inputs every point is scalar and the ranks split them.
  const int64_t s = img * points_per_image;
  const int64_t e = s + points_per_image;
  int64_t lo, hi, body = e, g0 = 0, g1 = 0;  // scalar [lo, hi), groups [g0, g1)
  if (vec_in) {
    const int64_t up = (s + 3) & ~int64_t(3), down = e & ~int64_t(3);
    const int64_t head = up < e ? up : e;
    body = down > head ? down : head;
    const int64_t groups = (body - head) / 4;
    g0 = head / 4 + groups * rank / S;
    g1 = head / 4 + groups * (rank + 1) / S;
    lo = s;
    hi = rank == 0 ? head : s;
  } else {
    lo = s + points_per_image * rank / S;
    hi = s + points_per_image * (rank + 1) / S;
  }
  // 1. zero the grid and the flags
  const int zero16 = (int)((grid_bytes(cells) + (S > 1 ? fbytes : 0)) / 16);
  for (int i = tid; i < zero16; i += kThreads) smem[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  // 2. add the kept points of the band
  for (int64_t i = lo + tid; i < hi; i += kThreads) {
    add_point<S>(grid, flags, keep[i], pix_r[i] - row0, pix_c[i], rows, w);
  }
  {
    const uchar4* keep4 = reinterpret_cast<const uchar4*>(keep);
    const int4* r4 = reinterpret_cast<const int4*>(pix_r);
    const int4* c4 = reinterpret_cast<const int4*>(pix_c);
    for (int64_t g = g0 + tid; g < g1; g += kUnroll * kThreads) {
      uchar4 k[kUnroll];
      int4 r[kUnroll], c[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t gu = g + u * kThreads;
        if (gu < g1) {
          k[u] = __ldg(keep4 + gu);
          r[u] = __ldg(r4 + gu);
          c[u] = __ldg(c4 + gu);
        } else {
          k[u] = make_uchar4(0, 0, 0, 0);
          r[u] = c[u] = make_int4(0, 0, 0, 0);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        add_point<S>(grid, flags, k[u].x, r[u].x - row0, c[u].x, rows, w);
        add_point<S>(grid, flags, k[u].y, r[u].y - row0, c[u].y, rows, w);
        add_point<S>(grid, flags, k[u].z, r[u].z - row0, c[u].z, rows, w);
        add_point<S>(grid, flags, k[u].w, r[u].w - row0, c[u].w, rows, w);
      }
    }
  }
  if (vec_in && rank == S - 1) {
    for (int64_t i = body + tid; i < e; i += kThreads) {
      add_point<S>(grid, flags, keep[i], pix_r[i] - row0, pix_c[i], rows, w);
    }
  }
  cluster_barrier<S>(cluster);

  // 3. this CTA's slice of the band, summed over the cluster's grids and
  // widened to float32: one word pair (four cells) to one float4 a thread
  // where the band's output is 16-byte aligned.  A peer's word pair is read
  // only where that peer added into the pair's chunk: first every peer's
  // flags are copied here, then the sums read the chunks they mark.
  uint32_t peer[S], peer_flag[S];
#pragma unroll
  for (int p = 0; p < S; ++p) {
    peer[p] = S > 1 ? peer_address(grid, p) : 0;
    peer_flag[p] = S > 1 ? peer_address(flags, p) : 0;
  }
  if (S > 1) {
    const int fwords = fbytes / 4;
    uint32_t* copy = reinterpret_cast<uint32_t*>(peer_flags);
    for (int i = tid; i < S * fwords; i += kThreads) {
      const int p = i / fwords, j = i - p * fwords;
      copy[i] = p == (int)rank ? reinterpret_cast<const uint32_t*>(flags)[j]
                               : load_peer(peer_flag[p] + 4 * j);
    }
    __syncthreads();
  }
  float* dst = out + img * h * w + (int64_t)row0 * w;
  int first_scalar = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const int quads = cells / 4;
    float4* dst4 = reinterpret_cast<float4*>(dst);
    const uint2* pairs = reinterpret_cast<const uint2*>(grid);
    for (int q = quads * rank / S + tid; q < quads * (rank + 1) / S; q += kThreads) {
      const int chunk = q >> (kChunkShift - 2);
      uint2 v[S];
#pragma unroll
      for (int p = 0; p < S; ++p) {
        v[p] = S == 1 || p == (int)rank ? pairs[q]
               : peer_flags[p * fbytes + chunk] ? load_peer2(peer[p] + 8 * q)
                                                : make_uint2(0, 0);
      }
      uint32_t a0 = 0, a1 = 0, a2 = 0, a3 = 0;
#pragma unroll
      for (int p = 0; p < S; ++p) {
        a0 += v[p].x & 0xffffu;
        a1 += v[p].x >> 16;
        a2 += v[p].y & 0xffffu;
        a3 += v[p].y >> 16;
      }
      dst4[q] = make_float4((float)a0, (float)a1, (float)a2, (float)a3);
    }
    first_scalar = quads * 4;
  }
  for (int i = first_scalar + rank * kThreads + tid; i < cells; i += S * kThreads) {
    uint32_t a = 0;
#pragma unroll
    for (int p = 0; p < S; ++p) {
      const uint32_t word = S == 1 || p == (int)rank ? grid[i >> 1]
                            : peer_flags[p * fbytes + (i >> kChunkShift)]
                                ? load_peer(peer[p] + 4 * (i >> 1))
                                : 0u;
      a += (word >> ((i & 1) * 16)) & 0xffffu;
    }
    dst[i] = (float)a;
  }

  // 4. keep this grid alive until every peer has read it
  if (S > 1) cluster.sync();
}

// The most clusters of S CTAs with `smem` bytes each that the card holds
// at once, or a CUDA error code as a negative number.  Opts the kernel in to
// all the shared memory a CTA can have first: the attribute is the kernel's
// own, so a smaller value set for one plan would refuse another's launch.
template <int S>
int active_clusters(int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      bin_counts_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(S, 1, 1);
  config.blockDim = dim3(kThreads, 1, 1);
  config.dynamicSmemBytes = (size_t)smem;
  config.attrs = attr;
  config.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, bin_counts_kernel<S>, &config);
  return err == cudaSuccess ? clusters : -(int)err;
}

// Checked once per (device, cluster size, shared-memory size): that one
// cluster of the plan fits the card at all.  Returns 0 or a CUDA error code.
template <int S>
int check_plan(int smem) {
  constexpr int kDevices = 64;
  static int checked_smem[kDevices] = {};  // smem bytes + 1 once checked
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device < kDevices && checked_smem[device] == smem + 1) return 0;
  const int clusters = active_clusters<S>(smem);
  if (clusters < 0) return -clusters;
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  if (device < kDevices) checked_smem[device] = smem + 1;
  return 0;
}

template <int S>
int launch(const int32_t* pix_r, const int32_t* pix_c, const uint8_t* keep, float* out,
           int64_t n_images, int64_t points_per_image, int h, int w, int rows_per_band,
           int smem_bytes, cudaStream_t stream) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)(n_images * S), (unsigned)((h + rows_per_band - 1) / rows_per_band), 1);
  config.blockDim = dim3(kThreads, 1, 1);
  config.dynamicSmemBytes = (size_t)smem_bytes;
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = 1;
  const int err = check_plan<S>(smem_bytes);
  if (err != 0) return err;
  const int vec_in = (reinterpret_cast<uintptr_t>(pix_r) & 15) == 0 &&
                     (reinterpret_cast<uintptr_t>(pix_c) & 15) == 0 &&
                     (reinterpret_cast<uintptr_t>(keep) & 3) == 0;
  cudaError_t e = cudaLaunchKernelEx(&config, bin_counts_kernel<S>, pix_r, pix_c, keep, out,
                                     points_per_image, h, w, rows_per_band, vec_in);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` with the plan of ops/topdown_kernels.py::cluster_plan:
// `cluster` CTAs per image and band, bands of `rows_per_band` rows, and
// `smem_bytes` of shared memory a CTA.  Returns 0 on success, else a CUDA
// error code: cudaErrorInvalidValue for a plan that does not hold the grid
// or the point count, a launch or occupancy error where it does not fit the
// card.
extern "C" int bin_counts_launch(const void* pix_r, const void* pix_c, const void* keep,
                                 void* out, int64_t n_images, int64_t points_per_image,
                                 int h, int w, int cluster, int rows_per_band,
                                 int smem_bytes, void* stream) {
  const int64_t band_cells = (int64_t)rows_per_band * w;
  const int64_t bands = rows_per_band > 0 ? (h + rows_per_band - 1) / rows_per_band : 0;
  if (h < 1 || w < 1 || rows_per_band < 1 || rows_per_band > h || bands > 65535 ||
      n_images < 0 || points_per_image < 0 || n_images * cluster > INT32_MAX ||
      smem_bytes < smem_needed(band_cells, cluster) || smem_bytes > kSmemLimit ||
      (int64_t)h * w > INT32_MAX ||
      (points_per_image + cluster - 1) / (cluster > 0 ? cluster : 1) + kSplitSlack >
          kMaxCtaPoints) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_images == 0) return 0;
  const int32_t* r = (const int32_t*)pix_r;
  const int32_t* c = (const int32_t*)pix_c;
  const uint8_t* k = (const uint8_t*)keep;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (cluster) {
    case 1: return launch<1>(r, c, k, o, n_images, points_per_image, h, w, rows_per_band, smem_bytes, st);
    case 2: return launch<2>(r, c, k, o, n_images, points_per_image, h, w, rows_per_band, smem_bytes, st);
    case 3: return launch<3>(r, c, k, o, n_images, points_per_image, h, w, rows_per_band, smem_bytes, st);
    case 4: return launch<4>(r, c, k, o, n_images, points_per_image, h, w, rows_per_band, smem_bytes, st);
    case 8: return launch<8>(r, c, k, o, n_images, points_per_image, h, w, rows_per_band, smem_bytes, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The most clusters of `cluster` CTAs with `smem_bytes` of shared memory
// each that the current device holds at once, or a negative CUDA error code.
extern "C" int bin_counts_active_clusters(int cluster, int smem_bytes) {
  switch (cluster) {
    case 1: return active_clusters<1>(smem_bytes);
    case 2: return active_clusters<2>(smem_bytes);
    case 3: return active_clusters<3>(smem_bytes);
    case 4: return active_clusters<4>(smem_bytes);
    case 8: return active_clusters<8>(smem_bytes);
    default: return -(int)cudaErrorInvalidValue;
  }
}
