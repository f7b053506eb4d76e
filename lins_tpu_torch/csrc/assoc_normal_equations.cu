// Fused scan-to-scan association and normal equations (kernels K4 and K5).
//
// K4 replaces the TPU kernel attic/pallas_assoc.py::surf_normal_equations
// (body _surf_kernel), K5 corner_normal_equations (body _corner_kernel).
// The contract is in lins_tpu_torch/ops/assoc.py: per query point, the
// de-skew exp(rel*phi) (x) p + rel*rn; the tripod among the previous scan's
// reference set (i1 the nearest valid reference; K4: i2 the nearest on
// ring[i1] other than i1, i3 the nearest on another ring within +-2; K5: i2
// the nearest on another ring within +-2), ties to the lowest index; the
// point-to-plane (K4) or point-to-line (K5) row of
// odometry/association.py; summed over the kept rows into
// (J6'J6 (6,6), J6'r (6), sum r^2, n).  Row forms: 0 "ieskf",
// H_att = ((-R'c) x p) Rinv with the trip's R and Rinv; 1 "gn",
// H_att = (-R_s'c) x p with each point's de-skew rotation R_s.
//   inputs  per set: q_xyz (Q,3) f32, q_rel (Q) f32, q_valid (Q) u8,
//           ref (R,4) f32 and offsets (kRings+1) i32: the reference set
//           laid out by ops/assoc.py ring_layout, once per scan: its valid
//           rows with finite coordinates first, in ring order and, within
//           a ring, in ascending original index; each row x, y, z and
//           (index << 8 | ring) as uint32 bits; offsets[r] the first row
//           of ring r, offsets[kRings] the number of such rows
//           pose (19) f32: rn, phi, qbn (w, x, y, z), Rinv row-major (the
//           "gn" form reads the first 6), read by pointer
//   outputs out (2,44) f32 per set: JtJ (36, row-major), Jtr (6), sum r^2,
//           one spare; out_n (2) int32 per set: n_matched
//
// Everything the row's `ok` depends on (de-skew, d2, the tripod's
// distances, the residual, the weight and the degeneracy norm) is computed
// with each operation rounded on its own (__fmul_rn, __fadd_rn, __fdiv_rn,
// __fsqrt_rn: no FMA contraction) in the order of the plain version, so the
// neighbour picks and counts equal it on the card.  d2 is
// ((dx*dx + dy*dy) + dz*dz) of direct differences; NaN counts as no
// candidate.  A minimum is kept as (d2 bits << 32 | index << 8 | ring): d2
// is never negative, so its bits order as the value, and the original
// index decides a tie whatever order the rows are visited in.
//
// Design.  One block of kThreads threads per query; one launch covers both
// sets (the first Qs blocks are surf, the rest corner): 704 blocks at the
// odometry's shapes, all resident at once on 132 SMs.  Every thread loads
// and de-skews the block's query while the set's ring offsets are staged
// in shared memory.  Pass 1 strides the threads over the valid rows only
// (the layout's first offsets[kRings]), kBatch rows' loads in flight a
// thread, each thread keeping its least key and the row it came from; two
// warp reductions (__reduce_min_sync on the d2 bits, then on the low word)
// and a pass over the kWarps warp results in shared memory give i1.
// Pass 2 reads only the rows of rings ring[i1]-2 .. ring[i1]+2, a
// contiguous range of the layout found through the offsets, and finds the
// same-ring (K4, other than i1) and the other-ring minima together; a
// query that is invalid or has no reference within max_d2 reads nothing.
// Thread 0 forms the row [H_att, c, r, ok] (zeros when not kept:
// selection, never a product with the flag) and writes it to the block's
// slot of `rows`; the last block to finish (a threadfence and a ticket
// counter, which it resets) sums the rows, each half of its threads one
// set: each thread the 29 products (21 of J6'J6, 6 of J6'r, r^2, ok) of
// its rows in order, kInFlight rows' loads at once, then a halving
// butterfly over each warp and the half's warps in order.  So the result
// is deterministic and no float atomics are used.  (Several queries a
// block, each row's distance taken to all of them, ran slower in a trial
// on the card.)  What remains is latency: the launch, a block's chain of
// loads, reductions and row, the fence and ticket, and the last block's
// sum.
//
// Bound.  The pair-distance work the data needs: 9 operations (3
// differences, 3 products, 2 sums, a compare) per (query, reference) pair
// whose distance is formed, pass 1 every valid query against every valid
// reference, pass 2 each matched query against the rows of its ring
// window (chip_smoke._k45_work counts them on the real trip).  On a
// RUNNING VLP-16 trip that is about 0.79 M pairs, 7.1 M operations, about
// 0.1 us at 67 TFLOP/s of float32 outside the tensor cores; its bytes
// (each input read once, 137 KB) take 0.04 us at 3.35 TB/s.  So the
// kernel is bound by operations, far below a launch's own few us.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // a block: one query
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 8;  // rows a thread loads at once in each pass
constexpr int kRings = 256;
constexpr int kRow = 8;
constexpr int kSums = 29;
constexpr int kOut = 44;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr unsigned long long kNone = ~0ull;

struct Set {
  const float* q_xyz;
  const float* q_rel;
  const uint8_t* q_valid;
  const float4* ref;
  const int* offsets;
  int Q;
};

// a running minimum: its key and the layout row it came from
struct Best {
  unsigned long long key;
  int row;
};

// (a, b) of the 8x8 Gram entry that sum k of 29 holds: J6'J6's upper
// triangle row-major (row a starts at 6a - a(a-1)/2), then J6'r (column
// 6), sum r^2 (6, 6) and the count (7, 7)
__device__ __forceinline__ void gram_entry(int k, int& a, int& b) {
  if (k < 21) {
    a = k < 6 ? 0 : k < 11 ? 1 : k < 15 ? 2 : k < 18 ? 3 : k < 20 ? 4 : 5;
    b = a + k - (6 * a - a * (a - 1) / 2);
  } else {
    a = k - 21;
    b = k < 27 ? 6 : a;
  }
}

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// a x b, component k, each operation rounded alone
__device__ __forceinline__ void cross(float ax, float ay, float az, float bx,
                                      float by, float bz, float& cx,
                                      float& cy, float& cz) {
  cx = sub(mul(ay, bz), mul(az, by));
  cy = sub(mul(az, bx), mul(ax, bz));
  cz = sub(mul(ax, by), mul(ay, bx));
}

__device__ __forceinline__ float norm3(float x, float y, float z) {
  return __fsqrt_rn(add(add(mul(x, x), mul(y, y)), mul(z, z)));
}

__device__ __forceinline__ float dist2(float px, float py, float pz,
                                       float4 r) {
  const float dx = sub(px, r.x);
  const float dy = sub(py, r.y);
  const float dz = sub(pz, r.z);
  return add(add(mul(dx, dx), mul(dy, dy)), mul(dz, dz));
}

__device__ __forceinline__ float value(unsigned long long k) {
  return k == kNone ? __int_as_float(0x7F800000)
                    : __uint_as_float(static_cast<uint32_t>(k >> 32));
}

__device__ __forceinline__ void keep_min(Best& b, float d2, uint32_t word,
                                         int row) {
  if (d2 != d2) return;  // NaN: no candidate
  const unsigned long long k =
      (static_cast<unsigned long long>(__float_as_uint(d2)) << 32) | word;
  if (k < b.key) {
    b.key = k;
    b.row = row;
  }
}

// The least key of the warp, with its row, in every lane: the least d2
// bits, then the least low word among the lanes holding them (two warp
// reductions), and the row of the lane holding both.
__device__ __forceinline__ Best warp_min(Best b) {
  const uint32_t d = static_cast<uint32_t>(b.key >> 32);
  const uint32_t w = static_cast<uint32_t>(b.key);
  const uint32_t dm = __reduce_min_sync(kFull, d);
  const uint32_t wm = __reduce_min_sync(kFull, d == dm ? w : 0xFFFFFFFFu);
  const unsigned who = __ballot_sync(kFull, d == dm && w == wm);
  return Best{(static_cast<unsigned long long>(dm) << 32) | wm,
              __shfl_sync(kFull, b.row, __ffs(who) - 1)};
}

// the least of the kWarps warp minima, in warp order
__device__ __forceinline__ Best of_warps(const Best* red) {
  Best b = red[0];
  for (int w = 1; w < kWarps; ++w) {
    if (red[w].key < b.key) b = red[w];
  }
  return b;
}

// A query point: its coordinates, relative time and validity.
struct Point {
  float x, y, z, rel;
  bool valid;
};

__device__ __forceinline__ Point load_query(const Set& s, int q) {
  return Point{s.q_xyz[3 * q], s.q_xyz[3 * q + 1], s.q_xyz[3 * q + 2],
               s.q_rel[q], s.q_valid[q] != 0};
}

// de-skew: exp(rel*phi) (x) p + rel*rn (ops/assoc.py deskew), and the
// point's rotation quaternion (qw, qx, qy, qz)
struct Deskewed {
  float x, y, z, qw, qx, qy, qz;
};

__device__ __forceinline__ Deskewed deskew(const Point& p,
                                           const float* __restrict__ pose) {
  const float rel = p.rel;
  const float vx = mul(rel, pose[3]);
  const float vy = mul(rel, pose[4]);
  const float vz = mul(rel, pose[5]);
  const float theta = norm3(vx, vy, vz);
  const bool small = theta < 1e-10f;
  const float safe = small ? 1.f : theta;
  const float half = mul(theta, 0.5f);
  const float sh = sinf(half);
  const float ch = cosf(half);
  const float qw = small ? 1.f : ch;
  const float qx = small ? 0.f : mul(dvd(vx, safe), sh);
  const float qy = small ? 0.f : mul(dvd(vy, safe), sh);
  const float qz = small ? 0.f : mul(dvd(vz, safe), sh);
  float uvx, uvy, uvz, cx, cy, cz;
  cross(qx, qy, qz, p.x, p.y, p.z, uvx, uvy, uvz);
  cross(qx, qy, qz, uvx, uvy, uvz, cx, cy, cz);
  return Deskewed{add(add(p.x, mul(2.f, add(mul(qw, uvx), cx))),
                      mul(rel, pose[0])),
                  add(add(p.y, mul(2.f, add(mul(qw, uvy), cy))),
                      mul(rel, pose[1])),
                  add(add(p.z, mul(2.f, add(mul(qw, uvz), cz))),
                      mul(rel, pose[2])),
                  qw, qx, qy, qz};
}

// The row [h0 h1 h2 c0 c1 c2 r ok] of a query p (de-skewed d) with the
// tripod minima b1, b2 (K4's same-ring) and b3 (the other rings), zeros
// when the row is not kept.
__device__ __forceinline__ void form_row(const Set& s, bool corner,
                                         const Point& p, const Deskewed& d,
                                         Best b1, Best b2, Best b3,
                                         const float* __restrict__ pose,
                                         int form, bool weighted,
                                         float max_d2, float res_scale,
                                         float row[kRow]) {
  for (int k = 0; k < kRow; ++k) row[k] = 0.f;
  if (!p.valid || !(value(b1.key) < max_d2)) return;
  // K5's one support point is the other-ring one
  const Best bsup = corner ? b3 : b2;
  if (!(value(bsup.key) < max_d2)) return;
  if (!corner && !(value(b3.key) < max_d2)) return;
  const float px = p.x, py = p.y, pz = p.z;
  const float p0x = d.x, p0y = d.y, p0z = d.z;
  const float qw = d.qw, qx = d.qx, qy = d.qy, qz = d.qz;

  const float4 P1 = __ldg(s.ref + b1.row);
  const float4 P2 = __ldg(s.ref + bsup.row);
  float res, jx, jy, jz, w, degenerate;
  if (!corner) {
    const float4 P3 = __ldg(s.ref + b3.row);
    float Mx, My, Mz;
    cross(sub(P1.x, P2.x), sub(P1.y, P2.y), sub(P1.z, P2.z),
          sub(P1.x, P3.x), sub(P1.y, P3.y), sub(P1.z, P3.z), Mx, My, Mz);
    const float m = norm3(Mx, My, Mz);
    const float m_safe = fmaxf(m, 1e-12f);
    res = dvd(add(add(mul(sub(p0x, P1.x), Mx), mul(sub(p0y, P1.y), My)),
                  mul(sub(p0z, P1.z), Mz)),
              m_safe);
    jx = dvd(Mx, m_safe);
    jy = dvd(My, m_safe);
    jz = dvd(Mz, m_safe);
    const float pn = norm3(p0x, p0y, p0z);
    w = sub(1.f, dvd(mul(1.8f, fabsf(res)),
                     __fsqrt_rn(__fsqrt_rn(fmaxf(pn, 1e-12f)))));
    degenerate = m;
  } else {
    float Pcx, Pcy, Pcz;
    cross(sub(p0x, P1.x), sub(p0y, P1.y), sub(p0z, P1.z), sub(p0x, P2.x),
          sub(p0y, P2.y), sub(p0z, P2.z), Pcx, Pcy, Pcz);
    const float rr = norm3(Pcx, Pcy, Pcz);
    const float d12 = norm3(sub(P1.x, P2.x), sub(P1.y, P2.y), sub(P1.z, P2.z));
    const float denom = fmaxf(mul(d12, rr), 1e-12f);
    res = dvd(rr, fmaxf(d12, 1e-12f));
    float ex, ey, ez;
    cross(Pcx, Pcy, Pcz, sub(P2.x, P1.x), sub(P2.y, P1.y), sub(P2.z, P1.z),
          ex, ey, ez);
    jx = dvd(ex, denom);
    jy = dvd(ey, denom);
    jz = dvd(ez, denom);
    w = sub(1.f, mul(1.8f, fabsf(res)));
    degenerate = rr;
  }
  const float sw = weighted ? w : 1.f;
  if (!(sw > 0.1f) || res == 0.f || !(degenerate > 1e-12f)) return;

  // the kept row: c = s*jac, r = res_scale * (s*res); t = R'c ("ieskf",
  // R = R(qbn)) or R_s'c ("gn"): c rotated by the conjugate quaternion
  const float c0 = mul(sw, jx), c1 = mul(sw, jy), c2 = mul(sw, jz);
  float rw = qw, rx = qx, ry = qy, rz = qz;
  if (form == 0) {  // the "gn" form's pose holds 6 scalars only
    rw = pose[6];
    rx = pose[7];
    ry = pose[8];
    rz = pose[9];
  }
  float ax, ay, az, bx, by, bz;
  cross(-rx, -ry, -rz, c0, c1, c2, ax, ay, az);
  cross(-rx, -ry, -rz, ax, ay, az, bx, by, bz);
  const float tx = c0 + 2.f * (rw * ax + bx);
  const float ty = c1 + 2.f * (rw * ay + by);
  const float tz = c2 + 2.f * (rw * az + bz);
  // g = (-t) x p
  const float gx = -ty * pz + tz * py;
  const float gy = -tz * px + tx * pz;
  const float gz = -tx * py + ty * px;
  if (form == 0) {
    const float* V = pose + 10;
    row[0] = gx * V[0] + gy * V[3] + gz * V[6];
    row[1] = gx * V[1] + gy * V[4] + gz * V[7];
    row[2] = gx * V[2] + gy * V[5] + gz * V[8];
  } else {
    row[0] = gx;
    row[1] = gy;
    row[2] = gz;
  }
  row[3] = c0;
  row[4] = c1;
  row[5] = c2;
  row[6] = res_scale * mul(sw, res);
  row[7] = 1.f;
}

// One step of `warp_sums`: each lane keeps the half of v[0, 2*kHalf) named
// by its lane bit kHalf and adds the partner lane's values of that half.
template <int kHalf>
__device__ __forceinline__ void butterfly(float (&v)[32], int lane) {
  const bool upper = (lane & kHalf) != 0;
#pragma unroll
  for (int k = 0; k < kHalf; ++k) {
    const float keep = upper ? v[k + kHalf] : v[k];
    const float give = upper ? v[k] : v[k + kHalf];
    v[k] = keep + __shfl_xor_sync(kFull, give, kHalf);
  }
}

// The sum over the warp of each of the 32 values of `v` (29 sums and 3
// zeros), lane l ending with the sum of value l: five butterfly steps (31
// shuffles in all).  Every sum's tree is fixed, so the result is
// deterministic.
__device__ __forceinline__ float warp_sums(float (&v)[32], int lane) {
  butterfly<16>(v, lane);
  butterfly<8>(v, lane);
  butterfly<4>(v, lane);
  butterfly<2>(v, lane);
  butterfly<1>(v, lane);
  return v[0];
}

// acc[k] += the product of sum k of the row v (a constant entry after
// unrolling, so acc stays in registers)
__device__ __forceinline__ void add_products(float (&acc)[32],
                                             const float (&v)[kRow]) {
#pragma unroll
  for (int k = 0; k < kSums; ++k) {
    int a, b;
    gram_entry(k, a, b);
    acc[k] += v[a] * v[b];
  }
}

// The last block: the 29 sums of each set's rows into `out` and `out_n`.
// Each half of the block takes one set: its threads the rows t, t + 64,
// ... in order (up to kInFlight rows' loads in flight at once), then a
// butterfly over each warp and the half's two warps in order; so the sums
// are deterministic.
__device__ __forceinline__ void sum_rows(const float* __restrict__ rows,
                                         int n_surf, int n_all,
                                         float (*part)[32],
                                         float* __restrict__ out,
                                         int* __restrict__ out_n) {
  constexpr int kHalf = kThreads / 2;
  constexpr int kInFlight = 4;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int set = t / kHalf;
  const int b0 = set == 0 ? 0 : n_surf;
  const int b1 = set == 0 ? n_surf : n_all;
  const float4* rows4 = reinterpret_cast<const float4*>(rows);
  float acc[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) acc[k] = 0.f;
  for (int i0 = b0 + t % kHalf; i0 < b1; i0 += kInFlight * kHalf) {
    float4 r[2 * kInFlight];
#pragma unroll
    for (int m = 0; m < kInFlight; ++m) {
      const int i = i0 + m * kHalf;
      const bool in = i < b1;
      r[2 * m] = in ? __ldcg(rows4 + 2 * i) : make_float4(0.f, 0.f, 0.f, 0.f);
      r[2 * m + 1] =
          in ? __ldcg(rows4 + 2 * i + 1) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int m = 0; m < kInFlight; ++m) {
      const float v[kRow] = {r[2 * m].x,     r[2 * m].y,     r[2 * m].z,
                             r[2 * m].w,     r[2 * m + 1].x, r[2 * m + 1].y,
                             r[2 * m + 1].z, r[2 * m + 1].w};
      add_products(acc, v);
    }
  }
  part[warp][lane] = warp_sums(acc, lane);
  __syncthreads();
  if (t % kHalf < kSums) {
    const int k = t % kHalf;
    const int w0 = set * (kWarps / 2);
    float sum = part[w0][k];
    for (int w = w0 + 1; w < w0 + kWarps / 2; ++w) sum += part[w][k];
    int a, c;
    gram_entry(k, a, c);
    float* o = out + set * kOut;
    if (k < 21) {
      o[a * 6 + c] = sum;
      o[c * 6 + a] = sum;
    } else if (k < 27) {
      o[36 + a] = sum;
    } else if (k == 27) {
      o[42] = sum;
      o[43] = 0.f;
    } else {
      out_n[set] = static_cast<int>(sum + 0.5f);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
assoc_normal_equations(Set surf, Set corner, const float* __restrict__ pose,
                       int form, int weighted, float max_d2, float res_scale,
                       float* __restrict__ rows,
                       unsigned int* __restrict__ counter,
                       float* __restrict__ out, int* __restrict__ out_n) {
  __shared__ Best red[3][kWarps];
  __shared__ int offs[kRings + 1];
  __shared__ float part[kWarps][32];
  __shared__ bool last;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const bool is_corner = static_cast<int>(blockIdx.x) >= surf.Q;
  const Set s = is_corner ? corner : surf;

  // the set's ring offsets (read after pass 1's barrier), and the block's
  // query, loaded and de-skewed by every thread
  for (int r = t; r <= kRings; r += kThreads) offs[r] = __ldg(s.offsets + r);
  const int n = __ldg(s.offsets + kRings);
  const Point p = load_query(s, is_corner ? blockIdx.x - surf.Q : blockIdx.x);
  const Deskewed d = deskew(p, pose);

  // pass 1: the nearest of the valid rows, kBatch rows' loads in flight
  // at once
  Best b1{kNone, 0};
  for (int j0 = t; p.valid && j0 < n; j0 += kBatch * kThreads) {
    float4 r[kBatch];
#pragma unroll
    for (int m = 0; m < kBatch; ++m) {
      const int j = j0 + m * kThreads;
      r[m] = __ldg(s.ref + (j < n ? j : j0));
    }
#pragma unroll
    for (int m = 0; m < kBatch; ++m) {
      const int j = j0 + m * kThreads;
      if (j < n) {
        keep_min(b1, dist2(d.x, d.y, d.z, r[m]), __float_as_uint(r[m].w), j);
      }
    }
  }
  b1 = warp_min(b1);
  if (lane == 0) red[0][warp] = b1;
  __syncthreads();
  b1 = of_warps(red[0]);

  // pass 2: the rows of rings ring1-2 .. ring1+2 (none when the query is
  // not matched); the same ring other than i1 (surf), the other rings
  const bool matched = p.valid && value(b1.key) < max_d2;
  const int ring1 = static_cast<int>(b1.key & 0xFFull);
  const int lo = matched ? offs[ring1 < 2 ? 0 : ring1 - 2] : 0;
  const int hi = matched ? offs[ring1 + 3 > kRings ? kRings : ring1 + 3] : 0;
  Best b2{kNone, 0}, b3{kNone, 0};
  for (int j0 = lo + t; j0 < hi; j0 += kBatch * kThreads) {
    float4 r[kBatch];
#pragma unroll
    for (int m = 0; m < kBatch; ++m) {
      const int j = j0 + m * kThreads;
      r[m] = __ldg(s.ref + (j < hi ? j : j0));
    }
#pragma unroll
    for (int m = 0; m < kBatch; ++m) {
      const int j = j0 + m * kThreads;
      const uint32_t word = __float_as_uint(r[m].w);
      const bool same = static_cast<int>(word & 0xFFu) == ring1;
      if (j >= hi || (same && (is_corner || j == b1.row))) continue;
      const float d2 = dist2(d.x, d.y, d.z, r[m]);
      if (same) keep_min(b2, d2, word, j);
      else keep_min(b3, d2, word, j);
    }
  }
  b2 = warp_min(b2);
  b3 = warp_min(b3);
  if (lane == 0) {
    red[1][warp] = b2;
    red[2][warp] = b3;
  }
  __syncthreads();

  // thread 0 forms the row and writes it to the block's slot of `rows`
  if (t == 0) {
    float row[kRow];
    form_row(s, is_corner, p, d, b1, of_warps(red[1]), of_warps(red[2]),
             pose, form, weighted != 0, max_d2, res_scale, row);
    float4* dst = reinterpret_cast<float4*>(rows) + 2 * blockIdx.x;
    dst[0] = make_float4(row[0], row[1], row[2], row[3]);
    dst[1] = make_float4(row[4], row[5], row[6], row[7]);
    __threadfence();
    last = atomicAdd(counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;

  // the last block: both sets' rows summed
  sum_rows(rows, surf.Q, gridDim.x, part, out, out_n);
  if (t == 0) *counter = 0u;
}

}  // namespace

extern "C" {

// K4 on (s_*) and K5 on (c_*) in one launch on `stream` (a cudaStream_t
// passed as a pointer); a set with Q = 0 gives zeros.  `rows` holds
// 8 floats per query of both sets (16-byte aligned), `counter` one zeroed
// uint32 that the kernel leaves at 0; two launches that may overlap must
// not share it.  Returns the cudaError_t of the launch (0 on success).
// Does not synchronise.
int assoc_normal_equations_launch(
    const void* s_q_xyz, const void* s_q_rel, const void* s_q_valid,
    const void* s_ref, const void* s_offsets, int s_Q, const void* c_q_xyz,
    const void* c_q_rel, const void* c_q_valid, const void* c_ref,
    const void* c_offsets, int c_Q, const void* pose, int form, int weighted,
    float max_d2, float res_scale, void* rows, void* counter, void* out,
    void* out_n, void* stream) {
  const Set surf{static_cast<const float*>(s_q_xyz),
                 static_cast<const float*>(s_q_rel),
                 static_cast<const uint8_t*>(s_q_valid),
                 static_cast<const float4*>(s_ref),
                 static_cast<const int*>(s_offsets), s_Q};
  const Set corner{static_cast<const float*>(c_q_xyz),
                   static_cast<const float*>(c_q_rel),
                   static_cast<const uint8_t*>(c_q_valid),
                   static_cast<const float4*>(c_ref),
                   static_cast<const int*>(c_offsets), c_Q};
  assoc_normal_equations<<<s_Q + c_Q, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      surf, corner, static_cast<const float*>(pose), form, weighted, max_d2,
      res_scale, static_cast<float*>(rows),
      static_cast<unsigned int*>(counter), static_cast<float*>(out),
      static_cast<int*>(out_n));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
