// Nearest-C candidate gather and selection of the scan-to-map backend
// (kernel K3), with the bucket gather and the finishing ops fused in.
//
// K3 replaces the TPU kernel lins_tpu/ops/pallas_select.py::select_candidates
// (body _select_kernel) together with the gather around it
// (lins_tpu/ops/grid_nn.py::gather_candidates: the neighbourhood block
// cells[bb], its duplicate-bucket and slot masks, and the finishing ops).
// Per query row q, over the row's nb neighbour buckets bb[q, n]:
//   a bucket equal to an earlier bb[q, m] (m < n) of the same row is masked
//   (two neighbour cells hashed together would give the same points twice);
//   slot s of bucket b takes part when s < cnt[b] and the query is valid;
//   d2 = ((dx*dx + dy*dy) + dz*dz), each operation rounded on its own (no
//   FMA contraction), is a candidate when d2 < 1e17 (a tombstone parked at
//   the voxel map's SENTINEL is not);
//   the C+1 nearest are kept in ascending order, ties to the lowest
//   cell-major flat index n*cap + s (the order of the reference's
//   cand.transpose(0,2,1,3).reshape(Q,3,B)).
// Outputs, finished as the reference finishes them: cand (Q,C,3) the kept
// points, the query point in an empty slot; cand_ok (Q,C); d2k (Q,C), +inf
// in an empty slot; d2C (Q,) the first DROPPED distance (first_dropped, the
// reference's kernel path) or the C-th KEPT one (its sort path), +inf where
// that slot is empty.
//   inputs  query (Q,3) f32, q_valid (Q) u8, bb (Q,nb) i32 (nb <= 32),
//           cells (table,3,cap) f32, cnt (table) i32
//   outputs cand (Q,C,3) f32, cand_ok (Q,C) u8, d2k (Q,C) f32, d2C (Q) f32
//
// Design.  One warp per query row, kWarps rows per block; no block-wide
// barrier, so a warp runs its row at its own pace and the warps of a block
// that share buckets meet in L1.
//   1. Lane n reads bucket bb[q, n] and its count; a shuffle loop masks the
//      duplicates; a warp scan lays the row's slots out as one list of
//      len = sum of min(cnt, cap) positions, cell after cell, so a position
//      p maps back to (cell, slot) by a binary search of the cells' starts,
//      and position order is flat-index order.
//   2. Each lane computes the distances of positions lane, lane+32, ...
//      (kUnroll positions' loads in flight) and writes their order keys to
//      the warp's slice of shared memory.  Distances are >= +0, so a key is
//      the float's bits (1e17 and over: the bits of 3e38, above every
//      candidate).
//   3. When len exceeds the sort buffer (P words, P >= C+1), a radix select
//      narrows the keys, one bit a pass counted with __reduce_add_sync, to
//      a bound under which at most P keys lie and at least C+1; if all 32
//      bits leave more than P keys (exact ties), the keys below the
//      (C+1)-th key and the lowest-positioned ties at it are taken.
//   4. The taken (key << 32 | position) words are sorted bitonically in
//      shared memory (P of them) and the first C+1 give the outputs; a kept
//      point's coordinates are read again from the grid.
// Shared memory per warp: 8P + 256 + 4*nb*cap bytes (23,840 B for the
// corner gather, nb = 27, cap = 216, P = 64); above 48 KB a block the
// launcher opts in, and it refuses a block over the card's opt-in limit
// or a sort buffer over kMaxSort words (the layout has no other owner).
//
// Bound.  Each query, flag and bucket id read once, each output written
// once, and of each distinct bucket that a valid row reaches, its count and
// its counted slots, min(cnt, cap) * 12 + 4 B (the kernel reads no slot at
// or above a count and no bucket of an invalid row); the operations are
// about 8 per slot a row takes.  The kernel is bound by bytes; what it does
// beyond that is latency: the loads of a row's buckets and the select
// passes over its keys.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kUnroll = 4;
constexpr int kMaxSort = 256;
constexpr uint32_t kFull = 0xFFFFFFFFu;
constexpr float kBig = 3.0e38f;
constexpr float kFar2 = 1.0e17f;

struct Args {
  const float* query;
  const uint8_t* q_valid;
  const int32_t* bb;
  const float* cells;
  const int32_t* cnt;
  int Q, nb, cap, C, P, first_dropped, warp_bytes;
  float* cand;
  uint8_t* cand_ok;
  float* d2k;
  float* d2C;
};

// the largest n with start[n] <= p (start[0] = 0, nondecreasing, 32 long):
// the cell of list position p (a cell of no slots shares its start with
// the next cell, so the largest such n has slots)
__device__ __forceinline__ int cell_of(const int* start, int p) {
  int n = 0;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    if (start[n + s] <= p) n += s;
  return n;
}

__device__ __forceinline__ const float* point_at(const Args& a,
                                                 const int* start,
                                                 const int* bucket, int p) {
  const int n = cell_of(start, p);
  return a.cells + static_cast<size_t>(bucket[n]) * 3 * a.cap + (p - start[n]);
}

__global__ void __launch_bounds__(kWarps * 32)
select_rows(const Args a) {
  extern __shared__ unsigned long long smem_words[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= a.Q) return;                     // the whole warp leaves
  unsigned long long* buf = reinterpret_cast<unsigned long long*>(
      reinterpret_cast<char*>(smem_words) + warp * a.warp_bytes);
  int* start = reinterpret_cast<int*>(buf + a.P);
  int* bucket = start + 32;
  uint32_t* keys = reinterpret_cast<uint32_t*>(bucket + 32);
  const uint32_t lt = (1u << lane) - 1u;

  const float qx = a.query[3 * row];
  const float qy = a.query[3 * row + 1];
  const float qz = a.query[3 * row + 2];
  const bool qv = a.q_valid[row] != 0;

  // 1. the row's buckets, duplicates masked, laid out as one slot list
  int b = 0, c = 0;
  if (lane < a.nb) {
    b = a.bb[static_cast<size_t>(row) * a.nb + lane];
    c = qv ? min(max(a.cnt[b], 0), a.cap) : 0;
  }
  for (int m = 0; m < a.nb; ++m) {
    const int bm = __shfl_sync(kFull, b, m);
    if (m < lane && bm == b) c = 0;
  }
  int incl = c;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += v;
  }
  const int len = __shfl_sync(kFull, incl, 31);
  start[lane] = lane < a.nb ? incl - c : len;
  bucket[lane] = b;
  __syncwarp();

  // 2. the order key of every listed slot
  const uint32_t big_key = __float_as_uint(kBig);
  for (int p0 = 0; p0 < len; p0 += 32 * kUnroll) {
    float x[kUnroll], y[kUnroll], z[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = p0 + 32 * u + lane;
      if (p < len) {
        const float* pt = point_at(a, start, bucket, p);
        x[u] = __ldg(pt);
        y[u] = __ldg(pt + a.cap);
        z[u] = __ldg(pt + 2 * a.cap);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = p0 + 32 * u + lane;
      if (p < len) {
        const float dx = __fsub_rn(x[u], qx);
        const float dy = __fsub_rn(y[u], qy);
        const float dz = __fsub_rn(z[u], qz);
        const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                             __fmul_rn(dy, dy)),
                                   __fmul_rn(dz, dz));
        keys[p] = d2 < kFar2 ? __float_as_uint(d2) : big_key;
      }
    }
  }
  __syncwarp();

  // 3. the keys to take: those <= bound, or those < tie and the first
  //    need_ties at tie
  const int R = a.C + 1;
  uint32_t bound = 0xFFFFFFFFu, tie = 0;
  int need_ties = -1;
  if (len > a.P) {
    // every key has bit 31 clear (a distance is >= +0): start below it
    uint32_t prefix = 0, mask = 0x80000000u;
    int below = 0, inset = len;
    for (int bit = 30; bit >= 0 && below + inset > a.P; --bit) {
      const uint32_t m2 = mask | (1u << bit);
      int c0 = 0;
#pragma unroll 4
      for (int p = lane; p < len; p += 32) c0 += (keys[p] & m2) == prefix;
      c0 = static_cast<int>(__reduce_add_sync(kFull, static_cast<unsigned>(c0)));
      if (below + c0 >= R) {
        inset = c0;
      } else {
        below += c0;
        inset -= c0;
        prefix |= 1u << bit;
      }
      mask = m2;
    }
    if (below + inset <= a.P) {
      bound = prefix | ~mask;
    } else {                 // all bits set and more than P at the key
      tie = prefix;
      need_ties = R - below;
    }
  }

  // 4. gather the taken words, sort them, write the outputs
  int taken = 0, ties_seen = 0;
  for (int p0 = 0; p0 < len; p0 += 32) {
    const int p = p0 + lane;
    const bool in = p < len;
    const uint32_t k = in ? keys[p] : 0xFFFFFFFFu;
    bool take;
    if (need_ties < 0) {
      take = in && k <= bound;
    } else {
      const bool is_tie = in && k == tie;
      const unsigned tb = __ballot_sync(kFull, is_tie);
      take = (in && k < tie)
             || (is_tie && ties_seen + __popc(tb & lt) < need_ties);
      ties_seen += __popc(tb);
    }
    const unsigned tk = __ballot_sync(kFull, take);
    if (take)
      buf[taken + __popc(tk & lt)] =
          (static_cast<unsigned long long>(k) << 32) | static_cast<uint32_t>(p);
    taken += __popc(tk);
  }
  for (int i = taken + lane; i < a.P; i += 32) buf[i] = ~0ull;
  __syncwarp();
  for (int size = 2; size <= a.P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = lane; t < a.P / 2; t += 32) {
        const int i = ((t & ~(stride - 1)) << 1) | (t & (stride - 1));
        const int j = i | stride;
        const unsigned long long u = buf[i], v = buf[j];
        if ((u > v) == ((i & size) == 0)) {
          buf[i] = v;
          buf[j] = u;
        }
      }
      __syncwarp();
    }
  }

  const size_t o = static_cast<size_t>(row) * a.C;
  for (int r = lane; r < a.C; r += 32) {
    const unsigned long long w = buf[r];
    const uint32_t k = static_cast<uint32_t>(w >> 32);
    const bool ok = r < taken && k < big_key;
    float px = qx, py = qy, pz = qz, d = __int_as_float(0x7F800000);
    if (ok) {
      const float* pt = point_at(a, start, bucket, static_cast<int>(w & 0xFFFFFFFFu));
      px = pt[0];
      py = pt[a.cap];
      pz = pt[2 * a.cap];
      d = __uint_as_float(k);
    }
    a.cand[3 * (o + r)] = px;
    a.cand[3 * (o + r) + 1] = py;
    a.cand[3 * (o + r) + 2] = pz;
    a.cand_ok[o + r] = ok;
    a.d2k[o + r] = d;
  }
  if (lane == 0) {
    const int r = a.first_dropped ? a.C : a.C - 1;
    const uint32_t k = static_cast<uint32_t>(buf[r] >> 32);
    a.d2C[row] = (r < taken && k < big_key) ? __uint_as_float(k)
                                             : __int_as_float(0x7F800000);
  }
}

// The sort buffer for C: a power of two, at least 64 and above C.
int sort_width(int C) {
  int P = 64;
  while (P <= C && P <= kMaxSort) P <<= 1;
  return P;
}

// Shared memory one warp of K3 takes: the sort buffer (P words), the
// cells' starts and buckets, and a row's keys.
long long row_smem_bytes(int nb, int cap, int P) {
  return 8LL * P + 2 * 32 * 4 + ((4LL * nb * cap + 7) & ~7LL);
}

}  // namespace

extern "C" {

// K3 on `stream` (a cudaStream_t passed as a pointer).  Returns -1, and
// launches nothing, when C needs a sort buffer over kMaxSort words or a
// block's shared memory would exceed the current card's opt-in limit;
// else the cudaError_t of the launch (0 on success).  Does not synchronise.
int select_candidates_launch(const void* query, const void* q_valid,
                             const void* bb, const void* cells,
                             const void* cnt, int Q, int nb, int cap, int C,
                             int first_dropped, void* cand, void* cand_ok,
                             void* d2k, void* d2C, void* stream) {
  const int P = sort_width(C);
  const long long smem = kWarps * row_smem_bytes(nb, cap, P);
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (P > kMaxSort || smem > limit) return -1;
  Args a;
  a.query = static_cast<const float*>(query);
  a.q_valid = static_cast<const uint8_t*>(q_valid);
  a.bb = static_cast<const int32_t*>(bb);
  a.cells = static_cast<const float*>(cells);
  a.cnt = static_cast<const int32_t*>(cnt);
  a.Q = Q;
  a.nb = nb;
  a.cap = cap;
  a.C = C;
  a.P = P;
  a.first_dropped = first_dropped;
  a.warp_bytes = static_cast<int>(row_smem_bytes(nb, cap, P));
  a.cand = static_cast<float*>(cand);
  a.cand_ok = static_cast<uint8_t*>(cand_ok);
  a.d2k = static_cast<float*>(d2k);
  a.d2C = static_cast<float*>(d2C);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(select_rows,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  select_rows<<<(Q + kWarps - 1) / kWarps, kWarps * 32,
                static_cast<int>(smem),
                static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
