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
// Design.  Two launches on the caller's stream, no host read between or
// after them:
//   1. block_kernel, one block per (16-row block, scan): 4*K blocks at
//      L=64 (128 of 132 SMs at K=32, where K1 fills 32).  Each runs the
//      shared-memory body of label_grid.cuh on its 16 x S rows (144,000 B
//      at S=1800); inside the block the down edges of its last row lead
//      nowhere, which masks the seams.  Labels are written already offset
//      by b*16*S, so each is the least global flat id of its block piece.
//   2. merge_kernel, one block per scan: a parent table of L*S+1 int32 in
//      device memory (scratch from the wrapper, initialised here to the
//      identity) joins the pieces across the (L/16 - 1)*S seam pairs:
//      every pair whose roots differ hooks the larger root under the
//      smaller (atomicMin), then every entry jumps to its root; rounds
//      repeat until a block-wide __syncthreads_or finds no pair to hook.
//      Roots only ever hook under smaller members of their own set, so the
//      root of a joined set is its least piece label, the component's least
//      flat id.  Last, every cell takes its piece's root.
//
// Bound.  Each input byte read once and each label written once: 7 B per
// cell, 25.8 MB at K=32, 64x1800 (7.7 us at 3.35 TB/s).  The scratch table
// (14.7 MB at K=32) is the design's, not the function's.  Like K1 the
// blocks are latency-bound on shared-memory rounds; the merge is one block
// per scan over a few thousand seam pairs.  A 4-block cluster per scan with
// the pieces' labels in distributed shared memory would keep the merge on
// chip (later work).

#include <cuda_runtime.h>

#include "label_grid.cuh"

namespace {

using lins_label::kBig;
using lins_label::kThreads;

constexpr int kRows = 16;

__global__ void __launch_bounds__(kThreads)
block_kernel(const uint8_t* __restrict__ e_right,
             const uint8_t* __restrict__ e_down,
             const uint8_t* __restrict__ eligible,
             int32_t* __restrict__ out, int L, int S) {
  extern __shared__ int32_t smem[];
  const int b = blockIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.y) * L * S
                      + static_cast<size_t>(b) * kRows * S;
  lins_label::label_grid(e_right + base, e_down + base, eligible + base,
                         out + base, kRows, S, b * kRows * S, smem);
}

__device__ __forceinline__ int find_root(volatile int32_t* parent, int x) {
  int r = x;
  int nxt = parent[r];
  while (nxt < r) {
    r = nxt;
    nxt = parent[r];
  }
  return r;
}

__global__ void __launch_bounds__(kThreads)
merge_kernel(const uint8_t* __restrict__ e_down, int32_t* __restrict__ out,
             int32_t* __restrict__ parent_all, int L, int S) {
  const int n = L * S;
  const size_t base = static_cast<size_t>(blockIdx.x) * n;
  int32_t* lab = out + base;
  const uint8_t* ed = e_down + base;
  int32_t* parent = parent_all + static_cast<size_t>(blockIdx.x) * (n + 1);
  volatile int32_t* vpar = parent;

  for (int x = threadIdx.x; x <= n; x += blockDim.x) parent[x] = x;
  __syncthreads();

  const int n_pairs = (L / kRows - 1) * S;
  int changed = n_pairs > 0;
  while (changed) {
    int local = 0;
    // hook the roots of every seam pair that disagree
    for (int p = threadIdx.x; p < n_pairs; p += blockDim.x) {
      const int c = ((p / S + 1) * kRows - 1) * S + p % S;
      if (!ed[c]) continue;
      const int a = lab[c];
      const int b = lab[c + S];
      if (a >= kBig || b >= kBig) continue;
      const int ra = find_root(vpar, a);
      const int rb = find_root(vpar, b);
      if (ra != rb) {
        atomicMin(&parent[max(ra, rb)], min(ra, rb));
        local = 1;
      }
    }
    __syncthreads();
    // every entry jumps to its root (each entry written by one thread)
    for (int x = threadIdx.x; x < n; x += blockDim.x) {
      const int p0 = vpar[x];
      if (p0 == x) continue;
      const int r = find_root(vpar, p0);
      if (r < p0) parent[x] = r;
    }
    changed = __syncthreads_or(local);
  }

  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    const int l = lab[c];
    if (l < kBig) lab[c] = find_root(vpar, l);
  }
}

}  // namespace

extern "C" {

// Launch both kernels on `stream` (a cudaStream_t passed as a pointer).
// `parent` is scratch of K*(L*S+1) int32.  Returns the cudaError_t of the
// launches (0 on success).  Does not synchronise.
int label_blocked_launch(const void* e_right, const void* e_down,
                         const void* eligible, void* out, void* parent, int K,
                         int L, int S, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem = lins_label::grid_smem_bytes(kRows, S);
  cudaError_t err = cudaFuncSetAttribute(
      block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* ed = static_cast<const uint8_t*>(e_down);
  auto* lab = static_cast<int32_t*>(out);
  block_kernel<<<dim3(L / kRows, K), kThreads, smem, st>>>(
      static_cast<const uint8_t*>(e_right), ed,
      static_cast<const uint8_t*>(eligible), lab, L, S);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_kernel<<<K, kThreads, 0, st>>>(ed, lab,
                                       static_cast<int32_t*>(parent), L, S);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
