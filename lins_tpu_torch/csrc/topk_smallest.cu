// The C smallest values of each row, ascending (kernel K6).
//
// K6 replaces the TPU kernel tools/r4_mosaic_canary.py::kernel_probe (body
// topk_kernel): per row of a (Q, B) f32 block, the C smallest values in
// ascending order, as torch.sort(stable=True).values[:, :C] gives them.
//   inputs  vals (Q,B) f32
//   outputs out (Q,C) f32
// Floats are compared through uint32 keys that order as the floats do
// (sign bit flipped, negatives inverted), with -0.0 given +0.0's key and
// every NaN the largest key, so equal keys are exactly what the stable
// sort holds equal; among them the lower index comes first, and the value
// written is the element itself (a -0.0 stays -0.0).
//
// Design.  One warp per row, up to kMaxWarps rows a block.  The row is
// read once with coalesced loads (16 bytes a lane where the rows are
// 16-byte aligned) and its keys are kept in the warp's slice of dynamic
// shared memory (B*4 bytes: 6,912 B at the canary's largest shape), so
// registers stay few and many warps share an SM.  The C-th key is found by radix selection one bit at a
// time: with [lo, hi) bracketing it (count(key < lo) < C <=
// count(key < hi)), each pass counts the keys below the midpoint with one
// warp reduction (__reduce_add_sync) and halves the bracket.  The first
// bracket is the row's least and greatest key, and the passes stop as soon
// as count(key < hi) fits the warp's sort buffer (N words in shared
// memory: C rounded up to a power of two, doubled and at least 64 while
// C <= 1024), or the bracket is one key wide (then every key < lo and the
// first C - count(key < lo) keys equal to lo, in index order, are the ones
// taken).  One more pass gathers the taken (key << 32 | index) words in
// index order with __ballot_sync/__popc, a bitonic sort over the buffer
// orders them, and the warp writes the first C elements.  On the canary's
// rows (uniform in [0, 100), C = 64, N = 128) three counting passes bring
// count(key < hi) under 128.
//
// Why not 8-bit digits with a histogram per warp: the top digit of such
// keys falls in one or two bins (the exponent byte), so the shared-memory
// atomics of the first pass would serialise on one address; a count per
// bit costs two instructions a key and one reduction a pass.
//
// Bound.  Each input read once and each output written once: (Q*B + Q*C)
// * 4 bytes, 42.9 MB at (6144, 1728), C = 64, 12.8 us at 3.35 TB/s; the
// least a selection does is a key and a compare per value, 21 M operations
// there, 0.3 us at 67 TFLOP/s.  So the kernel is bound by bytes
// (chip_smoke.py counts the same).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxWarps = 8;      // rows a block
constexpr int kSmemBudget = 32 * 1024;
constexpr uint32_t kLast = 0xFFFFFFFFu;  // NaN and padding
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t order_key(float f) {
  if (f != f) return kLast;
  uint32_t u = __float_as_uint(f);
  if (u == 0x80000000u) u = 0u;  // -0.0 sorts as +0.0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Shared memory of a block of W warps: W sort buffers of N words, then W
// key arrays of B keys.
__global__ void __launch_bounds__(32 * kMaxWarps)
topk_rows(const float* __restrict__ vals, int Q, int B, int C, int N,
          float* __restrict__ out) {
  extern __shared__ unsigned long long smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int q = blockIdx.x * warps + warp;
  if (q >= Q) return;  // whole warps; the block never synchronises
  const float* row = vals + static_cast<size_t>(q) * B;
  unsigned long long* buf = smem + static_cast<size_t>(warp) * N;
  uint32_t* keys = reinterpret_cast<uint32_t*>(smem + warps * N) +
                   static_cast<size_t>(warp) * B;
  const unsigned lanes_below = (1u << lane) - 1u;

  // the keys, and the first bracket: the least key and one past the
  // greatest; 16-byte loads and stores where the rows allow them
  uint32_t lo_key = kLast, hi_key = 0u;
  if ((B & 3) == 0 && (reinterpret_cast<uintptr_t>(vals) & 15) == 0) {
    const float4* row4 = reinterpret_cast<const float4*>(row);
    uint4* keys4 = reinterpret_cast<uint4*>(keys);
#pragma unroll 4
    for (int j = lane; j < B / 4; j += 32) {
      const float4 v = __ldg(row4 + j);
      const uint4 k = make_uint4(order_key(v.x), order_key(v.y),
                                 order_key(v.z), order_key(v.w));
      keys4[j] = k;
      lo_key = min(lo_key, min(min(k.x, k.y), min(k.z, k.w)));
      hi_key = max(hi_key, max(max(k.x, k.y), max(k.z, k.w)));
    }
  } else {
#pragma unroll 4
    for (int j = lane; j < B; j += 32) {
      const uint32_t k = order_key(__ldg(row + j));
      keys[j] = k;
      lo_key = min(lo_key, k);
      hi_key = max(hi_key, k);
    }
  }
  __syncwarp();
  uint64_t lo = __reduce_min_sync(kFull, lo_key);
  uint64_t hi = static_cast<uint64_t>(__reduce_max_sync(kFull, hi_key)) + 1;
  int n_lo = 0, n_hi = B;  // count(key < lo), count(key < hi)

  // one bit a pass until count(key < hi) fits the buffer or lo is the
  // C-th key itself
  while (n_hi > N && hi - lo > 1) {
    const uint32_t mid = static_cast<uint32_t>(lo + ((hi - lo) >> 1));
    unsigned c = 0;
#pragma unroll 4
    for (int j = lane; j < B; j += 32) c += keys[j] < mid;
    const int n = static_cast<int>(__reduce_add_sync(kFull, c));
    if (n >= C) {
      hi = mid;
      n_hi = n;
    } else {
      lo = mid;
      n_lo = n;
    }
  }

  // gather in index order: every key < hi, or every key < lo and the
  // first C - n_lo keys equal to lo
  const bool all_below = n_hi <= N;
  const uint64_t below_of = all_below ? hi : lo;
  const int need = all_below ? 0 : C - n_lo;
  const int M = all_below ? n_hi : C;
  int n_below = 0, n_tie = 0;
  for (int base = 0; base < B; base += 32) {
    const int j = base + lane;
    const uint32_t k = j < B ? keys[j] : kLast;
    const bool below = j < B && k < below_of;
    const unsigned bb = __ballot_sync(kFull, below);
    if (below) {
      buf[n_below + __popc(bb & lanes_below)] =
          (static_cast<unsigned long long>(k) << 32) | static_cast<uint32_t>(j);
    }
    n_below += __popc(bb);
    if (!all_below) {
      const bool tie = j < B && k == lo;
      const unsigned tb = __ballot_sync(kFull, tie);
      const int r = n_tie + __popc(tb & lanes_below);
      if (tie && r < need) {
        buf[n_lo + r] = (static_cast<unsigned long long>(k) << 32) |
                        static_cast<uint32_t>(j);
      }
      n_tie += __popc(tb);
    }
  }

  // bitonic sort of the M gathered words, padded to a power of two
  int P = 1;
  while (P < M) P <<= 1;
  for (int i = M + lane; i < P; i += 32) buf[i] = ~0ull;
  __syncwarp();
  for (int k = 2; k <= P; k <<= 1) {
    for (int s = k >> 1; s > 0; s >>= 1) {
      for (int p = lane; p < (P >> 1); p += 32) {
        const int a = ((p & ~(s - 1)) << 1) | (p & (s - 1));
        const int b = a | s;
        const unsigned long long x = buf[a], y = buf[b];
        if ((x > y) == ((a & k) == 0)) {
          buf[a] = y;
          buf[b] = x;
        }
      }
      __syncwarp();
    }
  }

  float* o = out + static_cast<size_t>(q) * C;
  for (int r = lane; r < C; r += 32) {
    o[r] = __ldg(row + static_cast<uint32_t>(buf[r] & 0xFFFFFFFFull));
  }
}

int launch(const float* vals, int Q, int B, int C, int N, float* out,
           cudaStream_t stream) {
  const int per_warp = N * static_cast<int>(sizeof(unsigned long long)) +
                       B * static_cast<int>(sizeof(uint32_t));
  int warps = kSmemBudget / per_warp;
  warps = warps < 1 ? 1 : (warps > kMaxWarps ? kMaxWarps : warps);
  const int smem = warps * per_warp;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        topk_rows, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (Q + warps - 1) / warps;
  topk_rows<<<blocks, 32 * warps, smem, stream>>>(vals, Q, B, C, N, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K6 on `stream` (a cudaStream_t passed as a pointer): the C smallest
// values of each row of a (Q, B) f32 block, 1 <= C <= B.  Returns the
// cudaError_t of the launch (0 on success).  Does not synchronise.
int topk_smallest_launch(const void* vals, int Q, int B, int C, void* out,
                         void* stream) {
  // the sort buffer: C rounded up to a power of two, doubled (and at
  // least 64) while small, so that the counting passes may stop early
  int N = 1;
  while (N < C) N <<= 1;
  if (N <= 1024) N = 2 * N < 64 ? 64 : 2 * N;
  const auto* v = static_cast<const float*>(vals);
  auto* o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  return launch(v, Q, B, C, N, o, s);
}

}  // extern "C"
