// Connected-components labelling of a chunk of range images (kernel K1).
//
// Replaces the TPU kernel lins_tpu/ops/pallas_label.py::label_components_pallas
// (_label_kernel, n_alt alternating row/column log-shift min-closures).  Same
// contract as lins_tpu/frontend/segmentation.py::label_from_edges:
//   inputs  e_right (K, L, S) uint8  edge (i,j)-(i,j+1 mod S), wraps at the seam
//           e_down  (K, L, S) uint8  edge (i,j)-(i+1,j), no wrap
//           eligible(K, L, S) uint8  cell takes part
//   output  labels  (K, L, S) int32  smallest flat id i*S+j of the cell's
//           4-connected component; 2^30 for an ineligible cell.
//
// Design.  One block per scan runs the shared-memory body of label_grid.cuh
// (hook + pointer-jump rounds to the fixpoint) on the whole scan: 144,000 B
// of labels and flags at 16x1800.  Grids larger than a block's shared memory
// are K2's (label_blocked.cu).
//
// Bound.  Each input byte is read once and each label written once:
// 3*K*L*S + 4*K*L*S bytes (6.45 MB at K=32, 16x1800), 1.9 us at 3.35 TB/s.
// The work is a handful of shared-memory rounds per scan, so the kernel is
// latency-bound on one SM per scan; 32 blocks use 32 of 132 SMs.  Filling
// the card (several blocks per scan, or a cluster per scan) is later work.

#include <cuda_runtime.h>

#include "label_grid.cuh"

namespace {

using lins_label::kThreads;

__global__ void __launch_bounds__(kThreads)
label_kernel(const uint8_t* __restrict__ e_right,
             const uint8_t* __restrict__ e_down,
             const uint8_t* __restrict__ eligible,
             int32_t* __restrict__ out, int L, int S) {
  extern __shared__ int32_t smem[];
  const size_t base = static_cast<size_t>(blockIdx.x) * L * S;
  lins_label::label_grid(e_right + base, e_down + base, eligible + base,
                         out + base, L, S, 0, smem);
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t passed as a pointer); returns the
// cudaError_t of the launch (0 on success).  Does not synchronise.
int label_components_launch(const void* e_right, const void* e_down,
                            const void* eligible, void* out, int K, int L,
                            int S, void* stream) {
  const int smem = lins_label::grid_smem_bytes(L, S);
  cudaError_t err = cudaFuncSetAttribute(
      label_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  label_kernel<<<K, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(e_right), static_cast<const uint8_t*>(e_down),
      static_cast<const uint8_t*>(eligible), static_cast<int32_t*>(out), L, S);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
