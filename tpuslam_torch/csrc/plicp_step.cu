// PL-ICP's pass after the correspondence search, for N scan pairs: the
// point-to-line residual and the trim (plicp_trim_kernel), then the
// Gauss-Newton normal system, its 3x3 solve and the pose update
// (plicp_system_kernel).
//
// Replaces no TPU kernel: the JAX package computes these steps in jnp
// (tpuslam/match/plicp.py: _point_line_residual, _kth_smallest and the
// iteration's trim and Gauss-Newton step).  The port ran them as plain
// PyTorch over [N, B] and [N, B, 3, 3] tensors (ops/plicp_step.py keeps
// that chain for the CPU): ~90 ops a pass, each writing its intermediate
// to device memory, and a sort of every pair's B distances to read two
// order statistics.
//
// Contract, per pair n and source row i (cur, q1, q2 [N,B,2], ok [N,B]):
//   trim:   t = q2 - q1, tn = max(sqrt(tx*tx + ty*ty), 1e-9),
//           nrm = (-ty, tx) / tn, r = (cx-q1x)*nx + (cy-q1y)*ny;
//           n_ok = sum ok, k0 = clamp(int(f32(n_ok) * max_perc), 0, B-1),
//           k1 the same with adaptive_order; kth_q = the k_q-th smallest
//           (from 0) of where(ok, |r|, BIG); cut = max(min(kth0, mult *
//           kth1), 1e-9); ok_out = ok & (|r| <= cut).
//           Every f32 op rounds alone (the library is built with
//           --fmad=false; IEEE sqrt and division) in the plain version's
//           order, and the select is exact, so r, nrm and ok_out equal
//           the plain version bit for bit.
//   system: w = ok & sv, ws = w * factor (w where no factor is given);
//           c, s = cos, sin of the heading; drot = (-s*px - c*py,
//           c*px - s*py); J = (nx, ny, nx*drot_x + ny*drot_y);
//           H = sum (J_a J_b) ws, g = sum J_a (r ws), n_w = sum w,
//           err = sum |r| w / max(n_w, 1); delta = -(H + 1e-9 I)^-1 g by
//           LU with partial pivoting in f64; pose' = pose + delta, its
//           heading wrapped as atan2(sin, cos); conv = max(|dx|, |dy|) <
//           eps_xy & |dtheta| < eps_theta; pose' = pose where done.
//           Each row's terms are the plain version's f32 ops; the sums
//           take the fixed tree below, not PyTorch's order, so H, g, n_w
//           and err lie within f32 summation error of the plain chain
//           and repeat bit for bit from call to call (no atomics).
// Coordinates are finite.
//
// What bounds it on this card: bytes.  The trim reads cur, q1, q2 and ok
// (25 B a row) and writes r, nrm and the cut mask (13 B); the system reads
// r, nrm, ok, src and sv (22 B).  At 16,384 pairs of 1,081 beams that is
// 1.06 GB, 0.32 ms a pass at 3.35 TB/s; the plain chain took ~6.5 ms.
//
// Design: one block a pair, the pairs on the grid's x (no 65,535
// ceiling); nothing but the outputs goes to device memory.
// Trim: thread t takes rows t, t + T, ..., at most kRows of them (T from
// the wrapper; no choice changes a result), computes their residuals,
// writes r and nrm once and keeps each row's key, the bits of
// where(ok, |r|, BIG), in a register: non-negative floats order as their
// bits.  Both order statistics are then selected together by a radix-2
// select over the key bits, most significant first (the JAX package's
// search): at bit p, count the keys below prefix | 1 << p and set the
// bit where the count is <= k.  A count is exact (both counts packed in
// one int, each warp's by redux, the warps' in shared memory, one
// barrier a bit), so no order shows; nothing is sorted.  Keys in shared
// memory with two counts a bit took 473 us a pass at 16,384 pairs of
// 1,081 beams on an H100 (700 W), 354 us this way, against a 201 us
// bound.  Past 8,192 rows (the wrapper's wide form) a thread reads its
// rows' keys again from its own r and ok in global memory (L2) at every
// bit.
// System: kSysThreads threads a block whatever B (the tree's lanes):
// thread l sums rows l, l + 256, ... in order from 0; each warp folds its
// lanes by shuffles at offsets 16, 8, 4, 2, 1 (lane j adds lane j + off),
// lane 0 of each writes its 11 sums to shared memory, and warp 0 folds
// the 8 warps' sums at offsets 4, 2, 1.  Thread 0 then solves and writes
// the pair's outputs.  ops/plicp_step.py::system_lanes writes this order
// out in PyTorch.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kBig = 1e9f;
constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
// the trim's register form: rows a thread, so at most 8,192 rows a pair
constexpr int kRows = 8;
constexpr int kSysThreads = 256;
constexpr int kSysWarps = kSysThreads / 32;
constexpr int kSums = 11;  // H's 6 distinct entries, g's 3, n_w, sum |r| w

// torch.clamp(x, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}

// torch.minimum: NaN wins
__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

// the row's residual (contract above): writes r and nrm, returns r
__device__ __forceinline__ float residual(const float2* __restrict__ cur,
                                          const float2* __restrict__ q1,
                                          const float2* __restrict__ q2,
                                          size_t o, float* __restrict__ r_out,
                                          float2* __restrict__ n_out) {
  const float2 c = cur[o];
  const float2 a = q1[o];
  const float2 e = q2[o];
  const float tx = __fsub_rn(e.x, a.x);
  const float ty = __fsub_rn(e.y, a.y);
  const float tn = clamp_min(
      __fsqrt_rn(__fadd_rn(__fmul_rn(tx, tx), __fmul_rn(ty, ty))), 1e-9f);
  const float nx = __fdiv_rn(-ty, tn);
  const float ny = __fdiv_rn(tx, tn);
  const float r = __fadd_rn(__fmul_rn(__fsub_rn(c.x, a.x), nx),
                            __fmul_rn(__fsub_rn(c.y, a.y), ny));
  r_out[o] = r;
  n_out[o] = make_float2(nx, ny);
  return r;
}

// The block's sum of v, in every thread: each warp's by redux, then the
// warps' from s[warp]; one barrier (the caller alternates two s buffers).
__device__ __forceinline__ int block_sum(int v, int* s, int lane, int warp,
                                         int nwarps) {
  v = __reduce_add_sync(kFull, v);
  if (lane == 0) s[warp] = v;
  __syncthreads();
  return __reduce_add_sync(kFull, lane < nwarps ? s[lane] : 0);
}

template <bool kWide>
__global__ void __launch_bounds__(kMaxThreads)
plicp_trim_kernel(const float2* __restrict__ cur,
                  const float2* __restrict__ q1,
                  const float2* __restrict__ q2,
                  const uint8_t* __restrict__ ok, int b, float max_perc,
                  float adaptive_order, float adaptive_mult,
                  float* __restrict__ r_out, float2* __restrict__ n_out,
                  uint8_t* __restrict__ ok_out) {
  // the warps' counts: two buffers a count, so that one barrier a bit
  // keeps the next bit's writes off the sums still being read
  __shared__ int s_cnt[2][2][kMaxWarps];

  const size_t pair = static_cast<size_t>(blockIdx.x) * b;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int nwarps = nthreads / 32;
  const unsigned big = __float_as_uint(kBig);

  // the register form's keys (rows tid + u * nthreads) and ok bits; a key
  // past the rows is above every key
  unsigned kv[kRows];
  unsigned okbits = 0;
  int n_ok = 0;
  if constexpr (kWide) {
    for (int i = tid; i < b; i += nthreads) {
      residual(cur, q1, q2, pair + i, r_out, n_out);
      n_ok += ok[pair + i] != 0;
    }
  } else {
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int i = tid + u * nthreads;
      kv[u] = ~0u;
      if (i < b) {
        const float r = residual(cur, q1, q2, pair + i, r_out, n_out);
        const bool k = ok[pair + i] != 0;
        okbits |= static_cast<unsigned>(k) << u;
        n_ok += k;
        kv[u] = k ? __float_as_uint(fabsf(r)) : big;
      }
    }
  }
  // the wide form reads each key again from the thread's own r and ok
  auto wide_key = [&](int i) -> unsigned {
    const size_t o = pair + i;
    return ok[o] ? __float_as_uint(fabsf(r_out[o])) : big;
  };
  n_ok = block_sum(n_ok, s_cnt[1][0], lane, warp, nwarps);
  // k = int(f32(n_ok) * perc), truncated as .to(int32), then clamped
  const float nf = __int2float_rn(n_ok);
  const int k0 = min(max(__float2int_rz(__fmul_rn(nf, max_perc)), 0), b - 1);
  const int k1 =
      min(max(__float2int_rz(__fmul_rn(nf, adaptive_order)), 0), b - 1);

  // the largest v with count(key < v) <= k is the k-th smallest key
  unsigned res0 = 0;
  unsigned res1 = 0;
  for (int p = 30; p >= 0; --p) {
    const unsigned c0 = res0 | (1u << p);
    const unsigned c1 = res1 | (1u << p);
    int n0 = 0;
    int n1 = 0;
    if constexpr (kWide) {
      for (int i = tid; i < b; i += nthreads) {
        const unsigned k = wide_key(i);
        n0 += k < c0;
        n1 += k < c1;
      }
      n0 = block_sum(n0, s_cnt[p & 1][0], lane, warp, nwarps);
      n1 = block_sum(n1, s_cnt[p & 1][1], lane, warp, nwarps);
    } else {
      // both counts in one int: a block's are <= b <= 8,192 < 2^16
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        n0 += kv[u] < c0;
        n1 += kv[u] < c1;
      }
      const int both =
          block_sum(n0 | n1 << 16, s_cnt[p & 1][0], lane, warp, nwarps);
      n0 = both & 0xffff;
      n1 = both >> 16;
    }
    if (n0 <= k0) res0 = c0;
    if (n1 <= k1) res1 = c1;
  }
  const float cut = clamp_min(
      nan_min(__uint_as_float(res0),
              __fmul_rn(adaptive_mult, __uint_as_float(res1))),
      1e-9f);
  // an ok row's key holds the bits of its |r|
  if constexpr (kWide) {
    for (int i = tid; i < b; i += nthreads)
      ok_out[pair + i] = ok[pair + i] && __uint_as_float(wide_key(i)) <= cut;
  } else {
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int i = tid + u * nthreads;
      if (i < b)
        ok_out[pair + i] = (okbits >> u & 1u) && __uint_as_float(kv[u]) <= cut;
    }
  }
}

// x <- a^-1 x by LU with partial pivoting (the first largest |a| of a
// column; LAPACK's getrf, as torch.linalg.solve_ex), in f64
__device__ void lu_solve3(double (&a)[3][3], double (&x)[3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    int p = c;
#pragma unroll
    for (int r = c + 1; r < 3; ++r)
      if (fabs(a[r][c]) > fabs(a[p][c])) p = r;
    if (p != c) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const double t = a[c][k];
        a[c][k] = a[p][k];
        a[p][k] = t;
      }
      const double t = x[c];
      x[c] = x[p];
      x[p] = t;
    }
#pragma unroll
    for (int r = c + 1; r < 3; ++r) {
      const double f = a[r][c] / a[c][c];
#pragma unroll
      for (int k = c + 1; k < 3; ++k) a[r][k] = a[r][k] - f * a[c][k];
      x[r] = x[r] - f * x[c];
    }
  }
#pragma unroll
  for (int c = 2; c >= 0; --c) {
    double s = x[c];
#pragma unroll
    for (int k = c + 1; k < 3; ++k) s = s - a[c][k] * x[k];
    x[c] = s / a[c][c];
  }
}

__global__ void __launch_bounds__(kSysThreads)
plicp_system_kernel(const float* __restrict__ pose,
                    const uint8_t* __restrict__ done,
                    const float2* __restrict__ src,
                    const uint8_t* __restrict__ sv,
                    const float* __restrict__ r,
                    const float2* __restrict__ nrm,
                    const uint8_t* __restrict__ ok,
                    const float* __restrict__ factor, int b, float eps_xy,
                    float eps_theta, float* __restrict__ pose_out,
                    uint8_t* __restrict__ conv_out, float* __restrict__ h_out,
                    float* __restrict__ nw_out, float* __restrict__ err_out) {
  __shared__ float s_part[kSysWarps][kSums];
  const int n = blockIdx.x;
  const size_t pair = static_cast<size_t>(n) * b;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const float* pn = pose + 3 * static_cast<size_t>(n);
  const float c = cosf(pn[2]);
  const float s = sinf(pn[2]);
  const float ms = -s;

  float acc[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) acc[k] = 0.f;
  for (int i = tid; i < b; i += kSysThreads) {
    const size_t o = pair + i;
    const float w = (ok[o] && sv[o]) ? 1.f : 0.f;
    const float ws = factor ? __fmul_rn(w, factor[o]) : w;
    const float2 p = src[o];
    const float2 nv = nrm[o];
    const float ri = r[o];
    const float dx = __fsub_rn(__fmul_rn(ms, p.x), __fmul_rn(c, p.y));
    const float dy = __fsub_rn(__fmul_rn(c, p.x), __fmul_rn(s, p.y));
    const float j[3] = {nv.x, nv.y,
                        __fadd_rn(__fmul_rn(nv.x, dx), __fmul_rn(nv.y, dy))};
    const float rw = __fmul_rn(ri, ws);
    const float term[kSums] = {
        __fmul_rn(__fmul_rn(j[0], j[0]), ws),
        __fmul_rn(__fmul_rn(j[0], j[1]), ws),
        __fmul_rn(__fmul_rn(j[0], j[2]), ws),
        __fmul_rn(__fmul_rn(j[1], j[1]), ws),
        __fmul_rn(__fmul_rn(j[1], j[2]), ws),
        __fmul_rn(__fmul_rn(j[2], j[2]), ws),
        __fmul_rn(j[0], rw),
        __fmul_rn(j[1], rw),
        __fmul_rn(j[2], rw),
        w,
        __fmul_rn(fabsf(ri), w)};
#pragma unroll
    for (int k = 0; k < kSums; ++k) acc[k] = __fadd_rn(acc[k], term[k]);
  }
#pragma unroll
  for (int k = 0; k < kSums; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[k] = __fadd_rn(acc[k], __shfl_down_sync(kFull, acc[k], off));
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kSums; ++k) s_part[warp][k] = acc[k];
  }
  __syncthreads();
  if (warp != 0) return;
#pragma unroll
  for (int k = 0; k < kSums; ++k) {
    acc[k] = lane < kSysWarps ? s_part[lane][k] : 0.f;
#pragma unroll
    for (int off = kSysWarps / 2; off > 0; off >>= 1)
      acc[k] = __fadd_rn(acc[k], __shfl_down_sync(kFull, acc[k], off));
  }
  if (lane != 0) return;

  const float h00 = acc[0], h01 = acc[1], h02 = acc[2];
  const float h11 = acc[3], h12 = acc[4], h22 = acc[5];
  // h + 1e-9 I in f32, then the solve in f64
  double a[3][3] = {{__fadd_rn(h00, 1e-9f), h01, h02},
                    {h01, __fadd_rn(h11, 1e-9f), h12},
                    {h02, h12, __fadd_rn(h22, 1e-9f)}};
  double x[3] = {acc[6], acc[7], acc[8]};
  lu_solve3(a, x);
  const float d0 = -__double2float_rn(x[0]);
  const float d1 = -__double2float_rn(x[1]);
  const float d2 = -__double2float_rn(x[2]);
  const float th = __fadd_rn(pn[2], d2);
  const bool frozen = done[n] != 0;
  float* po = pose_out + 3 * static_cast<size_t>(n);
  po[0] = frozen ? pn[0] : __fadd_rn(pn[0], d0);
  po[1] = frozen ? pn[1] : __fadd_rn(pn[1], d1);
  po[2] = frozen ? pn[2] : atan2f(sinf(th), cosf(th));
  // max(|dx|, |dy|) < eps as two tests: a NaN fails both ways
  conv_out[n] = fabsf(d0) < eps_xy && fabsf(d1) < eps_xy &&
                fabsf(d2) < eps_theta;
  float* h = h_out + 9 * static_cast<size_t>(n);
  h[0] = h00;
  h[1] = h01;
  h[2] = h02;
  h[3] = h01;
  h[4] = h11;
  h[5] = h12;
  h[6] = h02;
  h[7] = h12;
  h[8] = h22;
  nw_out[n] = acc[9];
  err_out[n] = __fdiv_rn(acc[10], fmaxf(acc[9], 1.f));
}

}  // namespace

extern "C" {

// r [n, b] f32, nrm [n, b, 2] f32, ok_out [n, b] uint8 <- the residual and
// the trim of cur, q1, q2 [n, b, 2] f32 and ok [n, b] uint8 (contract
// above), one block of `threads` (a multiple of 32, at most 1,024) a pair.
// Without `wide` each thread keeps its rows' keys in registers (b <= 8 *
// threads); with it they are read again from r and ok at every bit.
// Returns cudaGetLastError() after the launch.
int tpuslam_plicp_trim(const void* cur, const void* q1, const void* q2,
                       const void* ok, int n, int b, float max_perc,
                       float adaptive_order, float adaptive_mult, int threads,
                       int wide, void* r, void* nrm, void* ok_out,
                       void* stream) {
  cudaGetLastError();  // clear a stale error so the return value is ours
  if (n <= 0 || b <= 0) return static_cast<int>(cudaGetLastError());
  if (threads < 32 || threads > kMaxThreads || threads % 32 ||
      (!wide && b > kRows * threads))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto c = static_cast<const float2*>(cur);
  const auto a = static_cast<const float2*>(q1);
  const auto e = static_cast<const float2*>(q2);
  const auto k = static_cast<const uint8_t*>(ok);
  const auto ro = static_cast<float*>(r);
  const auto no = static_cast<float2*>(nrm);
  const auto oo = static_cast<uint8_t*>(ok_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide)
    plicp_trim_kernel<true><<<n, threads, 0, s>>>(
        c, a, e, k, b, max_perc, adaptive_order, adaptive_mult, ro, no, oo);
  else
    plicp_trim_kernel<false><<<n, threads, 0, s>>>(
        c, a, e, k, b, max_perc, adaptive_order, adaptive_mult, ro, no, oo);
  return static_cast<int>(cudaGetLastError());
}

// pose_out [n, 3] f32, conv [n] uint8, h [n, 3, 3] f32, n_w [n] f32 and
// err [n] f32 <- the Gauss-Newton step of pose [n, 3] f32 (done [n] uint8)
// from src [n, b, 2] f32, sv [n, b] uint8, r [n, b] f32, nrm [n, b, 2] f32,
// ok [n, b] uint8 and factor [n, b] f32 or null (contract above), one
// block of 256 threads a pair.  Returns cudaGetLastError() after the
// launch.
int tpuslam_plicp_system(const void* pose, const void* done, const void* src,
                         const void* sv, const void* r, const void* nrm,
                         const void* ok, const void* factor, int n, int b,
                         float eps_xy, float eps_theta, void* pose_out,
                         void* conv, void* h, void* n_w, void* err,
                         void* stream) {
  cudaGetLastError();  // clear a stale error so the return value is ours
  if (n <= 0 || b < 0) return static_cast<int>(cudaGetLastError());
  plicp_system_kernel<<<n, kSysThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pose), static_cast<const uint8_t*>(done),
      static_cast<const float2*>(src), static_cast<const uint8_t*>(sv),
      static_cast<const float*>(r), static_cast<const float2*>(nrm),
      static_cast<const uint8_t*>(ok), static_cast<const float*>(factor), b,
      eps_xy, eps_theta, static_cast<float*>(pose_out),
      static_cast<uint8_t*>(conv), static_cast<float*>(h),
      static_cast<float*>(n_w), static_cast<float*>(err));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
