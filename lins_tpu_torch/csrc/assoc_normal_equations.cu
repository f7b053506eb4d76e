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
//           ref (R,4) f32: x, y, z, ring as int32 bits (kNoRing: invalid)
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
// candidate.
//
// Design.  One warp per query, kWarps queries per block; one launch covers
// both sets (the first ceil(Qs/kWarps) blocks are surf, the rest corner).
// Each lane strides over the reference set with 16-byte loads (98 KB at
// R = 6144 stays in L1/L2) and keeps its least (d2 bits << 32 | index); d2
// is never negative, so its bits order as the value, and a butterfly
// shuffle min over the warp gives the first lowest index to every lane.
// Pass 1 finds i1; pass 2, with ring[i1] known, finds the same-ring and the
// other-ring minima together.  A query that is invalid or has no reference
// within max_d2 skips pass 2.  Lane 0 forms the row [H_att, c, r, ok]
// (zeros when not kept: selection, never a product with the flag).  The
// block sums its rows' 29 products (21 of J6'J6, 6 of J6'r, r^2, ok) in a
// fixed order into its partial; the last block to finish (a threadfence
// and a ticket counter, which it resets) sums the partials of each set in
// block order.  So the result is deterministic and no float atomics are
// used.
//
// Bound.  The pair-distance work of the two passes: 8 operations (3
// differences, 3 products, 2 sums) and a compare per (query, reference)
// pair and pass, Q*R*2 pairs: 512*6144 + 192*2048 pairs a pass at the
// main path's shapes, 3.54 M pairs, 63.7 M operations, about 1 us at
// 67 TFLOP/s of float32 outside the tensor cores.  Its bytes (the sets
// read once, 137 KB) take 0.04 us at 3.35 TB/s.  So the kernel is bound
// by operations; with 704 warps on 132 SMs each warp's two passes are a
// latency chain of R/32 loads and compares.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kSums = 29;
constexpr int kPartial = 32;
constexpr int kOut = 44;
constexpr int kNoRing = INT_MIN;
constexpr unsigned long long kNone = ~0ull;

struct Set {
  const float* q_xyz;
  const float* q_rel;
  const uint8_t* q_valid;
  const float4* ref;
  int Q;
  int R;
};

// (a, b) of the 8x8 Gram entry each of the 29 sums holds: J6'J6's upper
// triangle, then J6'r (column 6), sum r^2 (6, 6) and the count (7, 7)
__constant__ int8_t kA[kSums] = {0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 2, 2, 2, 2,
                                 3, 3, 3, 4, 4, 5, 0, 1, 2, 3, 4, 5, 6, 7};
__constant__ int8_t kB[kSums] = {0, 1, 2, 3, 4, 5, 1, 2, 3, 4, 5, 2, 3, 4, 5,
                                 3, 4, 5, 4, 5, 5, 6, 6, 6, 6, 6, 6, 6, 7};

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

__device__ __forceinline__ unsigned long long pack(float d2, int j) {
  return (static_cast<unsigned long long>(__float_as_uint(d2)) << 32) |
         static_cast<uint32_t>(j);
}

__device__ __forceinline__ float value(unsigned long long k) {
  return k == kNone ? __int_as_float(0x7F800000)
                    : __uint_as_float(static_cast<uint32_t>(k >> 32));
}

__device__ __forceinline__ unsigned long long warp_min(unsigned long long v) {
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(0xFFFFFFFFu, v, off);
    v = o < v ? o : v;
  }
  return v;
}

__device__ __forceinline__ unsigned long long keep_min(unsigned long long b,
                                                       float d2, int j) {
  if (d2 != d2) return b;  // NaN: no candidate
  const unsigned long long k = pack(d2, j);
  return k < b ? k : b;
}

// The row [h0 h1 h2 c0 c1 c2 r ok] of query q of set `s` (the caller's
// warp), zeros when the row is not kept.  Every lane computes the same
// tripod; the caller keeps lane 0's row.
__device__ void query_row(const Set& s, bool corner, int q,
                          const float* __restrict__ pose, int form,
                          bool weighted, float max_d2, float res_scale,
                          int lane, float row[8]) {
  for (int k = 0; k < 8; ++k) row[k] = 0.f;
  if (q >= s.Q || !s.q_valid[q]) return;
  const float px = s.q_xyz[3 * q];
  const float py = s.q_xyz[3 * q + 1];
  const float pz = s.q_xyz[3 * q + 2];
  const float rel = s.q_rel[q];

  // de-skew: exp(rel*phi) (x) p + rel*rn (ops/assoc.py deskew)
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
  cross(qx, qy, qz, px, py, pz, uvx, uvy, uvz);
  cross(qx, qy, qz, uvx, uvy, uvz, cx, cy, cz);
  const float p0x = add(add(px, mul(2.f, add(mul(qw, uvx), cx))),
                        mul(rel, pose[0]));
  const float p0y = add(add(py, mul(2.f, add(mul(qw, uvy), cy))),
                        mul(rel, pose[1]));
  const float p0z = add(add(pz, mul(2.f, add(mul(qw, uvz), cz))),
                        mul(rel, pose[2]));

  // pass 1: the nearest valid reference
  unsigned long long b1 = kNone;
  for (int j = lane; j < s.R; j += 32) {
    const float4 r = s.ref[j];
    if (__float_as_int(r.w) == kNoRing) continue;
    b1 = keep_min(b1, dist2(p0x, p0y, p0z, r), j);
  }
  b1 = warp_min(b1);
  if (!(value(b1) < max_d2)) return;
  const int i1 = static_cast<int>(b1 & 0xFFFFFFFFull);
  const int ring1 = __float_as_int(s.ref[i1].w);

  // pass 2: same ring other than i1 (surf), other ring within +-2
  unsigned long long b2 = kNone, b3 = kNone;
  for (int j = lane; j < s.R; j += 32) {
    const float4 r = s.ref[j];
    const int ring = __float_as_int(r.w);
    if (ring == kNoRing) continue;
    const bool same = ring == ring1;
    const int gap = ring > ring1 ? ring - ring1 : ring1 - ring;
    if (same ? (corner || j == i1) : gap > 2) continue;
    const float d2 = dist2(p0x, p0y, p0z, r);
    if (same) b2 = keep_min(b2, d2, j);
    else b3 = keep_min(b3, d2, j);
  }
  b2 = warp_min(b2);
  b3 = warp_min(b3);
  if (lane != 0) return;
  // K5's one support point is the other-ring one
  const unsigned long long bsup = corner ? b3 : b2;
  if (!(value(bsup) < max_d2)) return;
  if (!corner && !(value(b3) < max_d2)) return;

  const float4 P1 = s.ref[i1];
  const float4 P2 = s.ref[static_cast<int>(bsup & 0xFFFFFFFFull)];
  float res, jx, jy, jz, w, degenerate;
  if (!corner) {
    const float4 P3 = s.ref[static_cast<int>(b3 & 0xFFFFFFFFull)];
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

__global__ void __launch_bounds__(kThreads)
assoc_normal_equations(Set surf, Set corner, int surf_blocks,
                       const float* __restrict__ pose, int form,
                       int weighted, float max_d2, float res_scale,
                       float* __restrict__ partials,
                       unsigned int* __restrict__ counter,
                       float* __restrict__ out, int* __restrict__ out_n) {
  __shared__ float rows[kWarps][8];
  __shared__ bool last;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool is_corner = static_cast<int>(blockIdx.x) >= surf_blocks;
  const Set s = is_corner ? corner : surf;
  const int b = is_corner ? blockIdx.x - surf_blocks : blockIdx.x;

  float row[8];
  query_row(s, is_corner, b * kWarps + warp, pose, form, weighted != 0,
            max_d2, res_scale, lane, row);
  if (lane == 0) {
    for (int k = 0; k < 8; ++k) rows[warp][k] = row[k];
  }
  __syncthreads();

  const int t = threadIdx.x;
  if (t < kSums) {
    const int a = kA[t], c = kB[t];
    float acc = 0.f;
    for (int w = 0; w < kWarps; ++w) acc += rows[w][a] * rows[w][c];
    partials[blockIdx.x * kPartial + t] = acc;
    __threadfence();
  }
  __syncthreads();
  if (t == 0) last = atomicAdd(counter, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;

  // the last block: each set's partials summed in block order
  if (t < kSums) {
    const int a = kA[t], c = kB[t];
    for (int set = 0; set < 2; ++set) {
      const int b0 = set == 0 ? 0 : surf_blocks;
      const int b1 = set == 0 ? surf_blocks : gridDim.x;
      float acc = 0.f;
      for (int k = b0; k < b1; ++k) acc += __ldcg(partials + k * kPartial + t);
      float* o = out + set * kOut;
      if (t < 21) {
        o[a * 6 + c] = acc;
        o[c * 6 + a] = acc;
      } else if (t < 27) {
        o[36 + a] = acc;
      } else if (t == 27) {
        o[42] = acc;
        o[43] = 0.f;
      } else {
        out_n[set] = static_cast<int>(acc + 0.5f);
      }
    }
  }
  if (t == 0) *counter = 0u;
}

}  // namespace

extern "C" {

// K4 on (s_*) and K5 on (c_*) in one launch on `stream` (a cudaStream_t
// passed as a pointer); a set with Q = 0 gives zeros.  `partials` holds
// kPartial floats per block, `counter` one zeroed uint32 that the kernel
// leaves at 0; two launches that may overlap must not share it.  Returns
// the cudaError_t of the launch (0 on success).  Does not synchronise.
int assoc_normal_equations_launch(
    const void* s_q_xyz, const void* s_q_rel, const void* s_q_valid,
    const void* s_ref, int s_Q, int s_R, const void* c_q_xyz,
    const void* c_q_rel, const void* c_q_valid, const void* c_ref, int c_Q,
    int c_R, const void* pose, int form, int weighted, float max_d2,
    float res_scale, void* partials, void* counter, void* out, void* out_n,
    void* stream) {
  const Set surf{static_cast<const float*>(s_q_xyz),
                 static_cast<const float*>(s_q_rel),
                 static_cast<const uint8_t*>(s_q_valid),
                 static_cast<const float4*>(s_ref), s_Q, s_R};
  const Set corner{static_cast<const float*>(c_q_xyz),
                   static_cast<const float*>(c_q_rel),
                   static_cast<const uint8_t*>(c_q_valid),
                   static_cast<const float4*>(c_ref), c_Q, c_R};
  const int surf_blocks = (s_Q + kWarps - 1) / kWarps;
  const int blocks = surf_blocks + (c_Q + kWarps - 1) / kWarps;
  assoc_normal_equations<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      surf, corner, surf_blocks, static_cast<const float*>(pose), form,
      weighted, max_d2, res_scale, static_cast<float*>(partials),
      static_cast<unsigned int*>(counter), static_cast<float*>(out),
      static_cast<int*>(out_n));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
