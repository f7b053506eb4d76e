// Connected-components labelling of a chunk of tall range images (kernel K2).
//
// Replaces the TPU kernel lins_tpu/ops/pallas_label.py::label_components_blocked
// (16-row blocks through K1 with the seam e_down edges masked, labels offset
// by the block's first flat id, then an exact union of the components that
// cross a seam by min-hooking + pointer doubling in a while_loop).  Same
// contract as K1 (label_components.cu) and label_from_edges, for L a
// multiple of 16: 64x1800 (HDL-64) and 64x1024 (OS1-64), whose scans do not
// fit one block's shared memory (460,800 B of labels and flags at 64x1800).
//
// Design.  One launch; one thread-block cluster per scan, of L / rows
// blocks (the launcher's `rows`: 16, or 8 where a scan of 8-row pieces
// still fits a portable cluster of 8), each block one piece of `rows` x S
// cells; no parent table in device memory and no second launch.
//   1. Each block runs the shared-memory body of label_grid.cuh on its
//      piece (inside the block the down edges of its last row lead
//      nowhere, which masks the seams), then makes its labels global flat
//      ids (+ b * rows * S) and marks its pieces' roots.  The labels of the
//      whole scan now lie in the cluster's distributed shared memory: id g
//      in block g / (rows*S) at g % (rows*S).
//   2. Rounds over the seams, each closed by cluster.sync(): every seam
//      pair (the last row of block b and the first of block b+1, joined by
//      an e_down edge, both eligible) whose roots differ hooks the larger
//      root under the smaller with atomicMin on the peer block's label
//      (map_shared_rank); a cluster-wide flag in block 0 says whether any
//      pair hooked; if one did, every marked root jumps to its root.
//      Roots only ever hook under smaller members of their own set, so the
//      root of a joined set is its least piece label, the component's least
//      flat id: the unique fixpoint of label_from_edges.
//   3. Every cell takes its root from its own block (a piece's root has
//      jumped to its final root in the last round with a hook), written to
//      out; a last cluster.sync() keeps each block's shared memory alive
//      while its peers read it.
// rows = 16 takes 144,000 B of shared memory a block at S = 1800 (one block
// an SM); rows = 8 takes 72,000 B and 512 threads, so more clusters are
// resident at once (cudaOccupancyMaxActiveClusters, logged by chip_smoke).
//
// Bound.  Each input byte read once and each label written once: 7 B per
// cell, 25.8 MB at K=32, 64x1800 (7.7 us at 3.35 TB/s).  Like K1 the
// blocks are latency-bound on shared-memory rounds; the seam rounds are a
// few cluster barriers over S pairs a seam.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "label_grid.cuh"

namespace cg = cooperative_groups;

namespace {

using lins_label::kBig;

constexpr int kMaxBlocks = 8;      // the portable cluster size
constexpr uint8_t kRoot = 8;       // flag bit: the cell is a piece's root

// The cluster's labels: id g lives in block g / piece at g % piece.
struct Labels {
  volatile int32_t* lab[kMaxBlocks];
  int piece;
  __device__ __forceinline__ volatile int32_t* at(int g) const {
    const int r = g / piece;
    return lab[r] + (g - r * piece);
  }
  __device__ __forceinline__ int root(int g) const {
    int r = g;
    int nxt = *at(r);
    while (nxt < r) {
      r = nxt;
      nxt = *at(r);
    }
    return r;
  }
};

__global__ void __launch_bounds__(lins_label::kThreads)
label_cluster(const uint8_t* __restrict__ e_right,
              const uint8_t* __restrict__ e_down,
              const uint8_t* __restrict__ eligible,
              int32_t* __restrict__ out, int L, int S, int rows) {
  extern __shared__ int32_t smem[];
  __shared__ int any_hook[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int b = static_cast<int>(cluster.block_rank());
  const int nblk = L / rows;
  const int piece = rows * S;
  const int first = b * piece;
  const size_t base = static_cast<size_t>(blockIdx.y) * L * S + first;
  int32_t* lab = smem;
  uint8_t* flags = reinterpret_cast<uint8_t*>(smem + piece);

  // 1. the piece alone, then global ids and the roots marked
  lins_label::label_grid_shared(e_right + base, e_down + base,
                                eligible + base, rows, S, smem);
  for (int x = threadIdx.x; x < piece; x += blockDim.x) {
    const int l = lab[x];
    if (l < kBig) {
      lab[x] = l + first;
      if (l == x) flags[x] |= kRoot;
    }
  }
  if (threadIdx.x == 0) any_hook[0] = any_hook[1] = 0;
  Labels labs;                  // its own labels through the local window
  labs.piece = piece;
  for (int r = 0; r < nblk; ++r)
    labs.lab[r] = r == b ? lab : cluster.map_shared_rank(lab, r);
  volatile int32_t* vlab = lab;
  int* hook_flag = cluster.map_shared_rank(&any_hook[0], 0);
  cluster.sync();

  // 2. join the pieces across the seams
  for (int round = 0;; ++round) {
    int hooked = 0;
    if (b + 1 < nblk) {
      const volatile int32_t* below = labs.lab[b + 1];
      for (int j = threadIdx.x; j < S; j += blockDim.x) {
        const int c = (rows - 1) * S + j;
        if (!(flags[c] & 2)) continue;             // no e_down edge
        const int la = vlab[c];
        const int lb = below[j];
        if (la >= kBig || lb >= kBig) continue;
        const int ra = labs.root(la);
        const int rb = labs.root(lb);
        if (ra != rb) {
          atomicMin(const_cast<int32_t*>(labs.at(max(ra, rb))), min(ra, rb));
          hooked = 1;
        }
      }
    }
    if (__syncthreads_or(hooked) && threadIdx.x == 0)
      atomicOr(hook_flag + (round & 1), 1);
    cluster.sync();
    if (!*reinterpret_cast<volatile int*>(hook_flag + (round & 1))) break;
    for (int x = threadIdx.x; x < piece; x += blockDim.x) {
      if (!(flags[x] & kRoot)) continue;
      const int p0 = vlab[x];
      const int r = labs.root(p0);
      if (r < p0) atomicMin(lab + x, r);
    }
    if (b == 0 && threadIdx.x == 0) any_hook[(round + 1) & 1] = 0;
    cluster.sync();
  }

  // 3. every cell takes its root: a cell that is not a piece's root still
  // holds its piece's root (only roots hook or jump), and after the last
  // round with a hook every root jumped to its final root, so two reads
  // of this block's labels suffice
  for (int x = threadIdx.x; x < piece; x += blockDim.x) {
    const int l = vlab[x];
    out[base + x] = l >= kBig ? kBig : (flags[x] & kRoot) ? l : vlab[l - first];
  }
  cluster.sync();
}

// Dynamic shared memory and threads of one K2 block of `rows` x S cells.
void block_shape(int rows, int S, int* smem, int* threads) {
  *smem = lins_label::grid_smem_bytes(rows, S);
  *threads = rows >= 16 ? lins_label::kThreads : lins_label::kThreads / 2;
}

}  // namespace

extern "C" {

// How many clusters of L / rows such blocks the card holds at once
// (cudaOccupancyMaxActiveClusters), or -1 with the error returned.
int label_blocked_clusters(int L, int S, int rows, int* n_clusters) {
  int smem = 0, threads = 0;
  block_shape(rows, S, &smem, &threads);
  cudaError_t err = cudaFuncSetAttribute(
      label_cluster, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = L / rows;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(L / rows, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  *n_clusters = -1;
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(n_clusters, label_cluster, &cfg));
}

// Launch K2 on `stream` (a cudaStream_t passed as a pointer): K scans of
// L x S cells, a cluster of L / rows blocks each (rows divides L, at most 8
// blocks).  Returns the cudaError_t of the launch (0 on success).  Does not
// synchronise.
int label_blocked_launch(const void* e_right, const void* e_down,
                         const void* eligible, void* out, int K, int L, int S,
                         int rows, void* stream) {
  if (rows <= 0 || L % rows != 0 || L / rows > kMaxBlocks)
    return static_cast<int>(cudaErrorInvalidValue);
  int smem = 0, threads = 0;
  block_shape(rows, S, &smem, &threads);
  cudaError_t err = cudaFuncSetAttribute(
      label_cluster, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = L / rows;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(L / rows, K, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, label_cluster,
                           static_cast<const uint8_t*>(e_right),
                           static_cast<const uint8_t*>(e_down),
                           static_cast<const uint8_t*>(eligible),
                           static_cast<int32_t*>(out), L, S, rows);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
