// Nearest-C candidate selection of the scan-to-map gather (kernel K3).
//
// K3 replaces the TPU kernel lins_tpu/ops/pallas_select.py::select_candidates
// (body _select_kernel).  Per query row q:
//   d2[j] = ((dx*dx + dy*dy) + dz*dz) to every gathered candidate j, each
//           operation rounded on its own (no FMA contraction), set to
//           kBig = 3e38 where the candidate is not ok, the query is not
//           valid, or d2 >= 1e17 (tombstones parked at the voxel map's
//           SENTINEL);
//   then R = C+1 rounds, each taking the row minimum at its lowest flat
//   index j and writing (d2, x, y, z) of that candidate to column r.
// Flat index order is cell-major, j = n*cap + slot, which is the order of
// the reference's cand.transpose(0,2,1,3).reshape(Q,3,B), so ties resolve
// as there.  The gathered block (Q, nb, 3, cap) is read in place.
//   inputs  query (Q,3) f32, q_valid (Q) u8, cand (Q,nb,3,cap) f32,
//           ok (Q,nb*cap) u8
//   outputs out_d2 (Q,R) f32, out_xyz (Q,R,3) f32
//
// Design.  One block of 256 threads per row.  Floats are mapped to uint32
// keys that order as the floats do (sign bit flipped, negatives inverted),
// so (key << 32 | index) is one 64-bit word whose minimum is the row
// minimum at its lowest index: one warp-shuffle min and one pass over the
// eight warp results per round.  The row's keys live in dynamic shared
// memory (B*4 bytes: 23,328 B at the corner shape B = 27*216).  Thread t
// owns indices t, t+256, ...; it keeps the least key of its own indices in
// a register, and after a round only the owner of the taken index marks it
// (key 0xFFFFFFFF, above every float) and rescans its own indices (7 at
// B = 1728, 23 at B = 5832), so a round costs two barriers and two
// reductions, not a pass over the row.
//
// Bound.  Each input byte is read once and each output written once:
// 13 B per candidate (3 f32 coordinates and the ok byte) plus 16 B per
// output column.  At the surf shape (Q=4096, B=1728, R=33) that is 94.2 MB,
// 28 us at 3.35 TB/s; the selection is about Q*B*R = 0.23 G compares,
// 3.5 us at 67 TFLOP/s.  So the kernel is bound by bytes; the rounds are
// latency on one SM per row until enough rows are in flight.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr uint32_t kTaken = 0xFFFFFFFFu;
constexpr float kBig = 3.0e38f;
constexpr float kFar2 = 1.0e17f;

__device__ __forceinline__ uint32_t order_key(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

__device__ __forceinline__ unsigned long long pack(uint32_t key, int j) {
  return (static_cast<unsigned long long>(key) << 32) |
         static_cast<uint32_t>(j);
}

__device__ __forceinline__ unsigned long long warp_min(unsigned long long v) {
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_down_sync(0xFFFFFFFFu, v, off);
    v = o < v ? o : v;
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
select_rows(const float* __restrict__ query,
            const uint8_t* __restrict__ q_valid,
            const float* __restrict__ vals, const uint8_t* __restrict__ ok,
            int nb, int cap, int R, float* __restrict__ out_val,
            float* __restrict__ out_xyz) {
  extern __shared__ uint32_t keys[];
  __shared__ unsigned long long red[kWarps];
  __shared__ unsigned long long winner;
  const int B = nb * cap;
  const int q = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t row = static_cast<size_t>(q) * B;

  const float qx = query[3 * q];
  const float qy = query[3 * q + 1];
  const float qz = query[3 * q + 2];
  const bool qv = q_valid[q] != 0;

  unsigned long long best = ~0ull;
  for (int j = tid; j < B; j += kThreads) {
    const int n = j / cap;
    const float* c = vals + (row * 3 + static_cast<size_t>(n) * 2 * cap) + j;
    const float dx = __fsub_rn(c[0], qx);
    const float dy = __fsub_rn(c[cap], qy);
    const float dz = __fsub_rn(c[2 * cap], qz);
    const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                         __fmul_rn(dy, dy)),
                               __fmul_rn(dz, dz));
    const float v = (qv && ok[row + j] && d2 < kFar2) ? d2 : kBig;
    const uint32_t k = order_key(v);
    keys[j] = k;
    const unsigned long long p = pack(k, j);
    best = p < best ? p : best;
  }

  for (int r = 0; r < R; ++r) {
    const unsigned long long w = warp_min(best);
    if (lane == 0) red[warp] = w;
    __syncthreads();
    if (warp == 0) {
      unsigned long long v = lane < kWarps ? red[lane] : ~0ull;
      v = warp_min(v);
      if (lane == 0) winner = v;
    }
    __syncthreads();
    const unsigned long long win = winner;
    const int j = static_cast<int>(win & 0xFFFFFFFFull);
    if (tid == 0) {
      const size_t o = static_cast<size_t>(q) * R + r;
      out_val[o] = key_value(static_cast<uint32_t>(win >> 32));
      const int n = j / cap;
      const float* c =
          vals + (row * 3 + static_cast<size_t>(n) * 2 * cap) + j;
      out_xyz[3 * o] = c[0];
      out_xyz[3 * o + 1] = c[cap];
      out_xyz[3 * o + 2] = c[2 * cap];
    }
    if (j % kThreads == tid) {
      keys[j] = kTaken;
      best = ~0ull;
      for (int jj = tid; jj < B; jj += kThreads) {
        const unsigned long long p = pack(keys[jj], jj);
        best = p < best ? p : best;
      }
    }
  }
}

}  // namespace

extern "C" {

// K3 on `stream` (a cudaStream_t passed as a pointer); returns the
// cudaError_t of the launch (0 on success).  Does not synchronise.
int select_candidates_launch(const void* query, const void* q_valid,
                             const void* cand, const void* ok, int Q, int nb,
                             int cap, int R, void* out_d2, void* out_xyz,
                             void* stream) {
  // the wrapper keeps smem within the 48 KB a block may use without
  // opting in (ops/select.py _SMEM_LIMIT)
  const int smem = nb * cap * static_cast<int>(sizeof(uint32_t));
  select_rows<<<Q, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(query), static_cast<const uint8_t*>(q_valid),
      static_cast<const float*>(cand), static_cast<const uint8_t*>(ok), nb,
      cap, R, static_cast<float*>(out_d2), static_cast<float*>(out_xyz));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
