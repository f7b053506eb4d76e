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
// Design.  One launch; one thread-block cluster per scan, of P blocks (the
// launcher's layout: P = min(kPieces, L)), each block one piece of
// ceil(L / P) whole rows (the last piece may be shorter) whose int32 labels
// live in its shared memory, with a bit a cell marking the piece roots.
// The labels are one union-find forest with no rounds to a fixpoint
// (Playne & Hawick, IEEE TPDS 2018; Allegretti et al., 2019).  A warp takes
// a window of 32 segments of one row, a segment being kCells cells (one
// 4-byte word of each mask where S is a multiple of 4):
//   1. init: each eligible cell's parent is the first cell of its run of
//      right-joined cells inside the window (a warp max-scan of the run
//      breaks); an ineligible cell holds kBig.
//   2. union inside the piece: the right edge out of each window's last
//      cell (the wrap included) and each down edge to the next row of the
//      piece, except one whose left neighbours form the same link (both
//      rows' cells right-joined, the left pair joined down);
//      unite_local() finds both roots (halving the paths it walks) and links
//      the larger root under the smaller with atomicMin, retrying from the
//      returned value until the roots agree.  Then every cell points at its
//      piece root.  Cluster barrier.
//   3. seams: the down edges out of a piece's last row are united the same
//      way across the cluster, on the next block's labels in distributed
//      shared memory (map_shared_rank), once per distinct pair of piece
//      roots in a warp (__match_any_sync).  Cluster barrier.
//   4. each piece root takes its root across the cluster, then every cell
//      its piece root's, written to out.  The last barrier (which keeps a
//      block's shared memory alive while its peers read it) and the first
//      are split in arrive and wait around work that reads no peer.
// Threads: a warp a window, up to 1024 a block, halved while the card
// cannot hold the K clusters in one wave (cudaOccupancyMaxActiveClusters).
// Ids.  Inside the kernel a cell's id is (block << shift) | offset, with
// 2^shift >= the cells of a piece: pieces are runs of whole rows in order,
// so these ids order as the flat ids do, and an id names its block without
// a division.  The output is the flat id block * rows * S + offset.
// Invariants, which make the labels exact whatever order the atomics run
// in:
//   * a label only decreases (atomicMin; a compression writes a root
//     reached from the label), and lab[x] <= x;
//   * a label always names a member of x's component: init joins only
//     right-joined cells, a link puts a root under a root of the other end
//     of an edge (or of a cell already in its set), a halving step points a
//     cell at its grandparent, and a retry joins the old parent and the new
//     one before the edge's unite returns;
//   * so once every edge's unite has returned, each component is one tree,
//     and since every parent is smaller than its child, its root is its
//     least id: the unique labels of label_from_edges.  Labels that another
//     thread may lower are read volatile or by the atomics themselves; a
//     stale read is a larger ancestor, which the atomic's returned value
//     corrects.
//
// Bound.  Each input byte is read once and each label written once:
// 3*K*L*S + 4*K*L*S bytes (6.45 MB at K=32, 16x1800), 1.9 us at 3.35 TB/s.
// The kernel is latency-bound: each phase is a chain of dependent loads,
// shared-memory reads and atomics, and the cluster barriers wait for the
// slowest block of the scan.  P blocks a scan put a 32-scan chunk on
// 8 x 32 blocks and one scan on 8 SMs, where one block a scan used 32 SMs
// and 1.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kBig = 1 << 30;
constexpr int kPieces = 8;          // blocks a scan (chosen by measurement;
                                    // at most the portable cluster size)
constexpr int kMaxThreads = 1024;
constexpr int kMinThreads = 256;
constexpr int kCells = 4;           // cells of one segment: a word of a mask
constexpr unsigned kFull = 0xffffffffu;

// A cluster barrier in two halves: every thread of the cluster arrives
// (release: its writes so far become visible to the peers), and waits
// (acquire) before it reads what the peers wrote.  Between the two a block
// may do work that reads no peer's labels.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// Byte k of w is the mask of cell k of a segment.
__device__ __forceinline__ bool bit(uint32_t w, int k) {
  return (w >> (8 * k)) & 0xffu;
}

// The n <= kCells mask bytes of a segment starting at cell c, packed in a
// word (zero past n); kWords: one aligned 4-byte load.
template <bool kWords>
__device__ __forceinline__ uint32_t load_segment(const uint8_t* p, size_t c,
                                                 int n) {
  if (kWords) return n ? __ldg(reinterpret_cast<const uint32_t*>(p + c)) : 0;
  uint32_t w = 0;
  for (int k = 0; k < n; ++k)
    w |= static_cast<uint32_t>(__ldg(p + c + k) != 0) << (8 * k);
  return w;
}

// The root of id in this block's forest (every label of the block names a
// cell of the block until the seams are united), halving the path.
__device__ __forceinline__ int find_local(int32_t* lab, int id, int mask) {
  volatile int32_t* v = lab;
  for (;;) {
    const int p = v[id & mask];
    if (p == id) return id;
    const int gp = v[p & mask];
    if (gp == p) return p;
    atomicMin(lab + (id & mask), gp);
    id = gp;
  }
}

// Join the trees of a and b (cells of this block): link the larger root
// under the smaller.  If the larger was no root any more (atomicMin returns
// its parent `old`), its subtree may have moved from `old` to `lo`; join
// those two instead.
__device__ __forceinline__ void unite_local(int32_t* lab, int a, int b,
                                            int mask) {
  for (;;) {
    a = find_local(lab, a, mask);
    b = find_local(lab, b, mask);
    if (a == b) return;
    const int lo = min(a, b);
    const int hi = max(a, b);
    const int old = atomicMin(lab + (hi & mask), lo);
    if (old == hi) return;
    a = old;
    b = lo;
  }
}

// The scan's labels across the cluster: id (r << shift) | x is cell x of
// block r.
struct Labels {
  cg::cluster_group cluster;
  int32_t* lab;
  int rank, shift, mask;

  __device__ __forceinline__ int32_t* at(int id) const {
    const int r = id >> shift;
    int32_t* p = lab + (id & mask);
    return r == rank ? p : cluster.map_shared_rank(p, r);
  }
  __device__ __forceinline__ int get(int id) const {
    return *const_cast<volatile int32_t*>(at(id));
  }
  // The root of id once no label changes any more (no halving).
  __device__ __forceinline__ int root(int id) const {
    int p = get(id);
    while (p != id) {
      id = p;
      p = get(id);
    }
    return id;
  }
  __device__ __forceinline__ int find(int id) const {
    for (;;) {
      const int p = get(id);
      if (p == id) return id;
      const int gp = get(p);
      if (gp == p) return p;
      atomicMin(at(id), gp);
      id = gp;
    }
  }
  __device__ __forceinline__ void unite(int a, int b) const {
    for (;;) {
      a = find(a);
      b = find(b);
      if (a == b) return;
      const int lo = min(a, b);
      const int hi = max(a, b);
      const int old = atomicMin(at(hi), lo);
      if (old == hi) return;
      a = old;
      b = lo;
    }
  }
};

// One lane's segment of a window: row i of the piece, cells j0 .. j0+n-1
// (n = 0 past the row's end), flat offset x0 in the piece.
struct Segment {
  int i, j0, n, x0;
  bool last;  // the window's last segment with cells
};

__device__ __forceinline__ Segment segment_of(int w, int wpr, int spr,
                                              int S, int lane) {
  Segment g;
  g.i = w / wpr;
  const int q = (w - g.i * wpr) * 32 + lane;
  g.j0 = q * kCells;
  g.n = q < spr ? min(kCells, S - g.j0) : 0;
  g.x0 = g.i * S + g.j0;
  g.last = q < spr && (lane == 31 || q == spr - 1);
  return g;
}

// Down edges from segment g (masks el, ed) to the row below (masks el_b,
// er_b) that need a union: a cell with an eligible cell below, except where
// its left neighbour is right-joined to it and has the same link below.
// Bit k of the result is cell k.  conn: bit k set when cell k is joined to
// cell k-1 (for k = 0, to the previous lane's last cell).
__device__ __forceinline__ unsigned down_links(uint32_t el, uint32_t ed,
                                               uint32_t el_b, uint32_t er_b,
                                               unsigned conn, int n) {
  unsigned link = 0;
#pragma unroll
  for (int k = 0; k < kCells; ++k)
    if (k < n && bit(el, k) && bit(ed, k) && bit(el_b, k)) link |= 1u << k;
  // the previous lane's last cell: linked down, its below right-joined
  const unsigned prev = __shfl_up_sync(
      kFull, (link >> (kCells - 1)) & (bit(er_b, kCells - 1) ? 1u : 0u), 1);
  const int lane = static_cast<int>(threadIdx.x) & 31;
  unsigned need = link;
#pragma unroll
  for (int k = 0; k < kCells; ++k) {
    const bool same =
        k == 0 ? (lane > 0 && prev)
               : ((link >> (k - 1)) & 1u) && bit(er_b, k - 1);
    if (((conn >> k) & 1u) && same) need &= ~(1u << k);
  }
  return need;
}

// The masks a seam's down links need: a segment of the piece's last row
// and the same columns of the next piece's first row.
struct SeamMasks {
  uint32_t el, er, ed, el_b, er_b;
};

template <bool kWords>
__device__ __forceinline__ SeamMasks seam_masks(
    const uint8_t* e_right, const uint8_t* e_down, const uint8_t* eligible,
    size_t base, size_t below, const Segment& g) {
  SeamMasks m;
  m.el = load_segment<kWords>(eligible, base + g.x0, g.n);
  m.er = load_segment<kWords>(e_right, base + g.x0, g.n);
  m.ed = load_segment<kWords>(e_down, base + g.x0, g.n);
  m.el_b = load_segment<kWords>(eligible, below + g.j0, g.n);
  m.er_b = load_segment<kWords>(e_right, below + g.j0, g.n);
  return m;
}

template <bool kWords>
__global__ void __launch_bounds__(kMaxThreads)
label_union_find(const uint8_t* __restrict__ e_right,
              const uint8_t* __restrict__ e_down,
              const uint8_t* __restrict__ eligible,
              int32_t* __restrict__ out, int L, int S, int rows, int shift) {
  extern __shared__ int32_t lab[];
  cg::cluster_group cluster = cg::this_cluster();
  const int b = static_cast<int>(cluster.block_rank());
  const int nblk = static_cast<int>(cluster.num_blocks());
  const int scan = static_cast<int>(blockIdx.x) / nblk;
  const int row0 = b * rows;
  const int nrows = min(rows, L - row0);
  const int spr = (S + kCells - 1) / kCells;      // segments a row
  const int wpr = (spr + 31) / 32;                // windows a row
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int warp = static_cast<int>(threadIdx.x) >> 5;
  const int nwarps = static_cast<int>(blockDim.x) >> 5;
  const size_t base = (static_cast<size_t>(scan) * L + row0) * S;
  const int own = b << shift;
  const int mask = (1 << shift) - 1;
  const bool last_piece = row0 + nrows == L;
  unsigned* roots = reinterpret_cast<unsigned*>(lab + rows * S);
  for (int x = threadIdx.x; x < (nrows * S + 31) / 32; x += blockDim.x)
    roots[x] = 0;

  // 1. init: each eligible cell under the first cell of its run in the
  // window
  for (int w = warp; w < nrows * wpr; w += nwarps) {
    const Segment g = segment_of(w, wpr, spr, S, lane);
    const uint32_t el = load_segment<kWords>(eligible, base + g.x0, g.n);
    const uint32_t er = load_segment<kWords>(e_right, base + g.x0, g.n);
    // run breaks: a cell not joined to its left neighbour in the window
    const unsigned prev = __shfl_up_sync(
        kFull, bit(el, kCells - 1) && bit(er, kCells - 1) ? 1u : 0u, 1);
    int brk_last = -1;                 // this lane's last break, or -1
#pragma unroll
    for (int k = 0; k < kCells; ++k) {
      const bool joined = bit(el, k) &&
          (k == 0 ? lane > 0 && prev : bit(el, k - 1) && bit(er, k - 1));
      if (k < g.n && !joined) brk_last = kCells * lane + k;
    }
    int scanned = brk_last;            // the last break at or before lane
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(kFull, scanned, d);
      if (lane >= d) scanned = max(scanned, o);
    }
    int start = __shfl_up_sync(kFull, scanned, 1);
    const int wx0 = g.x0 - kCells * lane;          // the window's first cell
#pragma unroll
    for (int k = 0; k < kCells; ++k) {
      if (k < g.n) {
        const bool joined = bit(el, k) &&
            (k == 0 ? lane > 0 && prev : bit(el, k - 1) && bit(er, k - 1));
        if (!joined) start = kCells * lane + k;
        lab[g.x0 + k] = bit(el, k) ? own | (wx0 + start) : kBig;
      }
    }
  }
  __syncthreads();

  // 2. union inside the piece
  for (int w = warp; w < nrows * wpr; w += nwarps) {
    const Segment g = segment_of(w, wpr, spr, S, lane);
    const uint32_t er = load_segment<kWords>(e_right, base + g.x0, g.n);
    if (g.last && bit(er, g.n - 1)) {
      const int xl = g.x0 + g.n - 1;               // the window's last cell
      const int xr = g.j0 + g.n == S ? g.i * S : xl + 1;  // wraps
      if (lab[xl] < kBig && lab[xr] < kBig)
        unite_local(lab, own | xl, own | xr, mask);
    }
    if (g.i + 1 < nrows) {
      const uint32_t el = load_segment<kWords>(eligible, base + g.x0, g.n);
      const uint32_t ed = load_segment<kWords>(e_down, base + g.x0, g.n);
      const uint32_t el_b =
          load_segment<kWords>(eligible, base + g.x0 + S, g.n);
      const uint32_t er_b =
          load_segment<kWords>(e_right, base + g.x0 + S, g.n);
      const unsigned prev = __shfl_up_sync(
          kFull, bit(el, kCells - 1) && bit(er, kCells - 1) ? 1u : 0u, 1);
      unsigned conn = 0;
#pragma unroll
      for (int k = 0; k < kCells; ++k)
        if (bit(el, k) &&
            (k == 0 ? lane > 0 && prev : bit(el, k - 1) && bit(er, k - 1)))
          conn |= 1u << k;
      const unsigned need = down_links(el, ed, el_b, er_b, conn, g.n);
#pragma unroll
      for (int k = 0; k < kCells; ++k)
        if ((need >> k) & 1u)
          unite_local(lab, own | (g.x0 + k), own | (g.x0 + S + k), mask);
    }
  }
  __syncthreads();
  // every cell under its piece root; the piece roots marked
  for (int x = threadIdx.x; x < nrows * S; x += blockDim.x) {
    const int v = lab[x];
    if (v < kBig) {
      const int r = find_local(lab, v, mask);
      lab[x] = r;
      if (r == (own | x)) atomicOr(roots + (x >> 5), 1u << (x & 31));
    }
  }

  // 3. the seams: down edges out of the piece's last row, one unite per
  // distinct pair of piece roots in a warp; a warp's first window of masks
  // is read while the cluster's barrier completes
  cluster_arrive();
  Labels labs{cluster, lab, b, shift, mask};
  const size_t below = base + static_cast<size_t>(nrows) * S;
  const int next = (b + 1) << shift;
  SeamMasks m{};
  if (!last_piece && warp < wpr)
    m = seam_masks<kWords>(e_right, e_down, eligible, base, below,
                           segment_of((nrows - 1) * wpr + warp, wpr, spr, S,
                                      lane));
  cluster_wait();
  if (!last_piece) {
    for (int w = warp; w < wpr; w += nwarps) {
      const Segment g = segment_of((nrows - 1) * wpr + w, wpr, spr, S, lane);
      if (w != warp)
        m = seam_masks<kWords>(e_right, e_down, eligible, base, below, g);
      const unsigned prev = __shfl_up_sync(
          kFull, bit(m.el, kCells - 1) && bit(m.er, kCells - 1) ? 1u : 0u,
          1);
      unsigned conn = 0;
#pragma unroll
      for (int k = 0; k < kCells; ++k)
        if (bit(m.el, k) && (k == 0 ? lane > 0 && prev
                                    : bit(m.el, k - 1) && bit(m.er, k - 1)))
          conn |= 1u << k;
      const unsigned need =
          down_links(m.el, m.ed, m.el_b, m.er_b, conn, g.n);
#pragma unroll
      for (int k = 0; k < kCells; ++k) {
        const bool link = (need >> k) & 1u;
        // the two cells' ancestors: this cell's piece root, and the label
        // of the cell below (its piece root, or an ancestor of it)
        const int ra = link ? lab[g.x0 + k] : -1;
        const int rb = link ? labs.get(next | (g.j0 + k)) : -1;
        const unsigned same = __match_any_sync(
            kFull, static_cast<unsigned long long>(static_cast<unsigned>(ra))
                           << 32 |
                       static_cast<unsigned>(rb));
        if (link && __ffs(same) - 1 == lane) labs.unite(ra, rb);
      }
    }
  }
  cluster_arrive();
  cluster_wait();

  // 4. the piece roots take their roots across the cluster (the forest no
  // longer changes), then every cell its piece root's, as a flat id
  for (int x = threadIdx.x; x < nrows * S; x += blockDim.x)
    if ((roots[x >> 5] >> (x & 31)) & 1u) lab[x] = labs.root(own | x);
  // no peer's labels are read after this: the exit barrier completes
  // while the block writes its labels out
  cluster_arrive();
  __syncthreads();
  const int piece = rows * S;
  for (int w = warp; w < nrows * wpr; w += nwarps) {
    const Segment g = segment_of(w, wpr, spr, S, lane);
    int flat[kCells];
#pragma unroll
    for (int k = 0; k < kCells; ++k) {
      flat[k] = kBig;
      if (k < g.n) {
        const int x = g.x0 + k;
        const int v = lab[x];
        if (v < kBig) {
          const int r =
              (roots[x >> 5] >> (x & 31)) & 1u ? v : lab[v & mask];
          flat[k] = (r >> shift) * piece + (r & mask);
        }
      }
    }
    if (kWords) {
      if (g.n)
        *reinterpret_cast<int4*>(out + base + g.x0) =
            make_int4(flat[0], flat[1], flat[2], flat[3]);
    } else {
      for (int k = 0; k < g.n; ++k) out[base + g.x0 + k] = flat[k];
    }
  }
  cluster_wait();
}

// K1's layout: `pieces` blocks a scan (the cluster) of `rows` rows each,
// the last one possibly shorter; `threads` a block (a warp a window of 32
// segments); and how many such clusters the card holds at once.
struct Layout {
  int pieces, rows, threads, smem, shift, clusters;
};

Layout shape(int L, int S) {
  Layout g;
  const int p = min(kPieces, L);
  g.rows = (L + p - 1) / p;
  g.pieces = (L + g.rows - 1) / g.rows;
  const int windows = g.rows * ((S + 32 * kCells - 1) / (32 * kCells));
  g.threads = min(kMaxThreads, 32 * windows);
  g.smem = (g.rows * S + (g.rows * S + 31) / 32) *
           static_cast<int>(sizeof(int32_t));
  g.shift = 0;
  while ((1 << g.shift) < g.rows * S) ++g.shift;
  g.clusters = -1;
  return g;
}

bool aligned(const void* p, uintptr_t to) {
  return reinterpret_cast<uintptr_t>(p) % to == 0;
}

// The launch configuration of layout g over K scans.
void config(const Layout& g, int K, cudaLaunchAttribute* attr,
            cudaLaunchConfig_t* cfg) {
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = g.pieces;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(g.pieces * K, 1, 1);
  cfg->blockDim = dim3(g.threads, 1, 1);
  cfg->dynamicSmemBytes = g.smem;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// Checks g against the current card and sets the kernel's shared memory;
// -1 if a piece does not fit a block, else a cudaError_t.
template <bool kWords>
int prepare(const Layout& g) {
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (g.smem > limit) return -1;
  return static_cast<int>(cudaFuncSetAttribute(
      label_union_find<kWords>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      g.smem));
}

// g.clusters for a prepared g: how many clusters of it the card holds at
// once (cudaOccupancyMaxActiveClusters).
template <bool kWords>
int count_clusters(Layout* g) {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  config(*g, 1, attr, &cfg);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      &g->clusters, label_union_find<kWords>, &cfg));
}

// The layout for K scans: kPieces blocks a scan, and a warp a window up to
// kMaxThreads a block, halved (not below kMinThreads) while the card
// cannot hold all K clusters in one wave.
template <bool kWords>
int layout_for(int K, int L, int S, Layout* g) {
  *g = shape(L, S);
  int err = prepare<kWords>(*g);
  while (err == 0) {
    err = count_clusters<kWords>(g);
    if (err != 0 || g->clusters >= K || g->threads <= kMinThreads) break;
    g->threads = max(kMinThreads, g->threads / 64 * 32);
  }
  return err;
}

// Launch layout g (prepared) over K scans on `stream`.
template <bool kWords>
int launch(const void* e_right, const void* e_down, const void* eligible,
           void* out, int K, int L, int S, const Layout& g, void* stream) {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  config(g, K, attr, &cfg);
  cfg.stream = static_cast<cudaStream_t>(stream);
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, label_union_find<kWords>, static_cast<const uint8_t*>(e_right),
      static_cast<const uint8_t*>(e_down),
      static_cast<const uint8_t*>(eligible), static_cast<int32_t*>(out), L,
      S, g.rows, g.shift);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <bool kWords>
int layout_and_launch(const void* e_right, const void* e_down,
                      const void* eligible, void* out, int K, int L, int S,
                      void* stream) {
  Layout g;
  const int err = layout_for<kWords>(K, L, S, &g);
  if (err != 0) return err;
  return launch<kWords>(e_right, e_down, eligible, out, K, L, S, g, stream);
}

}  // namespace

extern "C" {

// K1's layout for K scans of L x S cells (masks read as words): blocks a
// scan, rows a block, threads a block, shared memory bytes a block, and how
// many such clusters the current card holds at once.  Returns -1 if a piece
// does not fit a block, else the cudaError_t (0 on success).
int label_components_layout(int K, int L, int S, int* pieces, int* rows,
                            int* threads, int* smem, int* clusters) {
  Layout g;
  const int err = layout_for<true>(K, L, S, &g);
  *pieces = g.pieces;
  *rows = g.rows;
  *threads = g.threads;
  *smem = g.smem;
  *clusters = g.clusters;
  return err;
}

// Launch K1 on `stream` (a cudaStream_t passed as a pointer): K scans of
// L x S cells, one cluster a scan; the masks are read as 4-byte words where
// S is a multiple of 4 and the pointers allow it, else byte by byte.
// Returns -1, and launches nothing, when the grid is empty or a piece does
// not fit one block's shared memory; else the cudaError_t of the launch (0
// on success).  Does not synchronise.
int label_components_launch(const void* e_right, const void* e_down,
                            const void* eligible, void* out, int K, int L,
                            int S, void* stream) {
  if (K < 1 || L < 1 || S < 1 || K > 0x7fffffff / kPieces) return -1;
  const bool words = S % kCells == 0 && aligned(e_right, 4) &&
                     aligned(e_down, 4) && aligned(eligible, 4) &&
                     aligned(out, 16);
  return words ? layout_and_launch<true>(e_right, e_down, eligible, out, K,
                                         L, S, stream)
               : layout_and_launch<false>(e_right, e_down, eligible, out, K,
                                          L, S, stream);
}

}  // extern "C"
