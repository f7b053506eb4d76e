// Block body of the labelling kernel K2 (label_blocked.cu): the connected
// components of one L x S grid, computed by one block in shared memory by
// hook + pointer-jump rounds (K2 runs it on each 8- or 16-row piece of a
// scan and joins the pieces across its cluster).  K1
// (label_components.cu) has its own body: one union-find pass, no rounds.
//
// Contract (lins_tpu/frontend/segmentation.py::label_from_edges):
//   e_right[i, j]  edge (i,j)-(i,j+1 mod S), wraps at the seam
//   e_down [i, j]  edge (i,j)-(i+1,j), no wrap (row L-1's edges are unused)
//   eligible[i, j] cell takes part
// out[i*S+j] = offset + the smallest flat id of the cell's 4-connected
// component, or 2^30 for an ineligible cell.
//
// The grid's labels (L*S int32) live in dynamic shared memory with one flag
// byte per cell (e_right | e_down << 1 | eligible << 2) beside them, so the
// iteration never touches device memory.  Each round:
//   1. hook: every eligible cell takes the least label over its connected
//      neighbours; when that is below its own label l it lowers both itself
//      and the cell l (its current representative) with atomicMin, so a
//      smaller label entering a converged region reaches every member
//      through that representative;
//   2. jump: every eligible cell follows lab[lab[c]] down to a root.
// Rounds repeat until one changes nothing (__syncthreads_or).  Invariants:
// lab[c] <= c, and lab[c] is always the id of a member of c's component;
// at the fixpoint connected cells agree, so every label is the component's
// least id: the fixpoint of label_from_edges, exactly.
#pragma once

#include <cstdint>

namespace lins_label {

constexpr int kBig = 1 << 30;
constexpr int kThreads = 1024;

// Dynamic shared memory one block needs for an L x S grid.
inline int grid_smem_bytes(int L, int S) {
  return L * S * (static_cast<int>(sizeof(int32_t)) + 1);
}

// Label the L x S grid whose masks start at e_right/e_down/eligible (all
// row-major, S columns) in shared memory: on return (after a block-wide
// barrier) smem holds the n = L*S labels, each the least id in [0, n) of
// the cell's component or kBig, and the n flag bytes after them.  Called
// by every thread of a block, with grid_smem_bytes(L, S) of dynamic shared
// memory at smem.
__device__ __forceinline__ void label_grid_shared(
    const uint8_t* __restrict__ e_right, const uint8_t* __restrict__ e_down,
    const uint8_t* __restrict__ eligible, int L, int S, int32_t* smem) {
  const int n = L * S;
  int32_t* lab = smem;                                    // n labels
  uint8_t* flags = reinterpret_cast<uint8_t*>(smem + n);  // n flag bytes

  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    const uint8_t el = eligible[c] != 0;
    flags[c] = (e_right[c] != 0) | ((e_down[c] != 0) << 1) | (el << 2);
    lab[c] = el ? c : kBig;
  }
  __syncthreads();

  volatile int32_t* vlab = lab;
  int changed = 1;
  while (changed) {
    int local = 0;
    // 1. hook
    for (int c = threadIdx.x; c < n; c += blockDim.x) {
      const uint8_t f = flags[c];
      if (!(f & 4)) continue;
      const int i = c / S;
      const int j = c - i * S;
      const int l = vlab[c];
      int m = l;
      if (f & 1) {                                         // right, wraps
        const int r = (j + 1 == S) ? c + 1 - S : c + 1;
        m = min(m, vlab[r]);
      }
      {                                                    // left, wraps
        const int lf = (j == 0) ? c + S - 1 : c - 1;
        if (flags[lf] & 1) m = min(m, vlab[lf]);
      }
      if ((f & 2) && i + 1 < L) m = min(m, vlab[c + S]);   // down
      if (i > 0 && (flags[c - S] & 2)) m = min(m, vlab[c - S]);  // up
      if (m < l) {
        atomicMin(&lab[l], m);
        atomicMin(&lab[c], m);
        local = 1;
      }
    }
    __syncthreads();
    // 2. jump to the root
    for (int c = threadIdx.x; c < n; c += blockDim.x) {
      if (!(flags[c] & 4)) continue;
      const int l = vlab[c];
      int r = l;
      int nxt = vlab[r];
      while (nxt < r) {
        r = nxt;
        nxt = vlab[r];
      }
      if (r < l) {
        atomicMin(&lab[c], r);
        local = 1;
      }
    }
    changed = __syncthreads_or(local);
  }
}

// label_grid_shared, then out[c] = offset + the label, or kBig.
__device__ __forceinline__ void label_grid(
    const uint8_t* __restrict__ e_right, const uint8_t* __restrict__ e_down,
    const uint8_t* __restrict__ eligible, int32_t* __restrict__ out, int L,
    int S, int offset, int32_t* smem) {
  label_grid_shared(e_right, e_down, eligible, L, S, smem);
  for (int c = threadIdx.x; c < L * S; c += blockDim.x) {
    const int l = smem[c];
    out[c] = l < kBig ? l + offset : kBig;
  }
}

}  // namespace lins_label
