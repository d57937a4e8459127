// One Hector pyramid level: num_iters Gauss-Newton steps for S scans.
//
// Replaces the TPU kernel of tpuslam/ops/pallas_hector.py:
//   _kernel / _one_scan (the pallas_call at :237), reached by
//   match_level_pallas (:220).
//
// Contract, per scan (pallas_hector.py:71-214):
//   crop origin from the INITIAL pose: ox = clip(floor(x0) - window/2, 0,
//   max(W - window, 0)) aligned down to 128, oy likewise with H, aligned
//   down to 8 (the TPU's DMA tile, kept for parity);
//   per beam at the current pose (c, s of its yaw):
//     tx = c*px - s*py + x - ox, ty = s*px + c*py + y - oy; ix, iy = floor;
//     inb = ix >= 0 & ix+1 < window & iy >= 0 & iy+1 < window & valid;
//     with C the grid rounded to bf16, at the columns ix and ix+1:
//     dg = bf16(C[iy+1] - C[iy]), yg = C[iy] + fy*dg (f32),
//     tent weights w = 1 - |col - tx|;
//     val = yg0*w0 + yg1*w1, gx = yg1 - yg0, gy = dg0*w0 + dg1*w1,
//     rot = (-s*px - c*py)*gx + (c*px - s*py)*gy, r = 1 - val;
//   H = sum J^T J, d = sum J^T r over the beams inside the gate, score =
//   sum val; adjugate solve when |det| > 1e-12, the yaw step clamped to
//   +-yaw_clamp, the pose unchanged when the system is singular.
//   Outputs the pose, the H of the last iteration (taken at the pose
//   before its update), score / max(sum valid, 1) and the count of beams
//   inside the gate at the last iteration; eye(3), 0, 0 with no iteration.
// The library is built with --fmad=false and every f32 expression is
// written in the order above, so each beam's terms equal the plain
// PyTorch version's; the sums take another order (below), fixed, with no
// atomics, so a run repeats itself bit for bit.
//
// What bounds it on this card: per iteration, each beam reads four bf16
// cells (two rows of two) from the grid (2 MB at 1024^2, 8 MB at 2048^2:
// resident in the 50 MB L2 after the first touch) and issues ~100
// instructions; then a scan reduces ten f32 sums and solves a 3x3 system
// before its next iteration can start.  Issue and gather latency bind,
// not bytes or flops: conversions (floor, int <-> float: ~7 a beam as
// the contract writes it) issue at an eighth of the f32 rate, and a lone
// scan's iteration is a chain of gathers, a reduction and a solve.  The
// crop is only a gate here: an 896^2 or 1152^2 bf16 crop cannot sit in
// 227 KB of shared memory as it sat in the TPU's VMEM.
//
// Design: a scan is a group of `ws` warps (1, 2, 4 or 8, the wrapper's choice
// from S and B), a block of 256 threads holds 8 / ws scans. Thread t of a group
// owns the beams t, t + 32 ws, ... (kBeams of them, the fewest of 1-6, 8, 12,
// 16 that cover B, so that every slot works), whose points it reads once into
// registers; each iteration it issues the grid reads of all of them before the
// arithmetic that uses them (a lone scan's iteration waits on one gather
// latency, not on one a beam), each row pair of cells as one 8-byte load of the
// four bf16 at the aligned index (plus one 2-byte load when the pair straddles
// it, a quarter of the beams), and adds each in-gate beam's terms to its sums
// in beam order.  Floors come from f32 adds (floor_small), whose floats serve
// fy and the tent weights as float(iy) and float(ix) would; both row
// differences round to bf16 in one instruction.  The warp's sums: a transposed
// butterfly (16 shuffles for the 10 sums, the same pairing tree as a 5-round
// __shfl_down_sync tree, so the same bits) and __reduce_add_sync for the count;
// with ws > 1 one __syncthreads and the warps' totals added in warp order
// (scan_sum).  Every lane then holds the same sums and solves alike: no pose
// broadcast.  sincosf once a lane an iteration.
//
// Wide scans (kWide, past 16 beams a thread at 8 warps: B > 4096): the
// thread's first 16 beams stay in registers and each iteration reads the
// rest from global memory (L2) 16 at a time, beams t + 16 m g, ... in
// order, adding their terms to the same running sums after the first 16.
// So the thread still adds its beams t, t + g, t + 2g, ... in order and
// the sums are those that match_level_lanes writes out for ws warps.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // a block: 8 / ws scans
constexpr int kMaxWarps = 8;   // warps a scan
constexpr int kSums = 10;  // h00 h01 h02 h11 h12 h22 d0 d1 d2 score
constexpr unsigned kFull = 0xffffffffu;

// One level of the transposed butterfly over the first M slots: the lane
// with `off` set keeps the upper half, its partner the lower.
template <int M>
__device__ __forceinline__ void halve(float (&v)[16], int lane, int off) {
  const bool up = lane & off;
#pragma unroll
  for (int q = 0; q < M / 2; ++q) {
    const float send = up ? v[q] : v[q + M / 2];
    const float keep = up ? v[q + M / 2] : v[q];
    v[q] = keep + __shfl_xor_sync(kFull, send, off);
  }
}

// The scan's sums of acc[kSums] and cnt, in every lane.  Within a warp,
// a transposed butterfly: at offset 16, 8, 4, 2 each lane keeps half of
// its values and adds the partner lane's copy of them, the other half
// going to the partner (8 + 4 + 2 + 1 shuffles for 16 slots, the six past
// kSums zero), then offset 1; the total of value k ends in lanes 2k and
// 2k + 1.  Every total pairs the same lanes at every level as the
// __shfl_down_sync tree (lane l += lane l + off, off = 16 .. 1) does for
// lane 0, and an f32 add commutes, so the totals are that tree's bit for
// bit.  Then 10 broadcasts.  The count is exact in any order
// (__reduce_add_sync).  With ws > 1 the warps' lanes 2k write total k to
// shared memory (double-buffered by iteration), one __syncthreads, lane k
// of every warp adds sum k over the group's warps in warp order, and 10
// more broadcasts.
__device__ __forceinline__ void scan_sum(float (&acc)[kSums], int& cnt,
                                         int ws, int warp, int lane,
                                         float (*part)[kSums + 1]) {
  constexpr int kSlots = 16;
  float v[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) v[k] = k < kSums ? acc[k] : 0.f;
  halve<16>(v, lane, 16);
  halve<8>(v, lane, 8);
  halve<4>(v, lane, 4);
  halve<2>(v, lane, 2);
  v[0] += __shfl_xor_sync(kFull, v[0], 1);
  cnt = __reduce_add_sync(kFull, cnt);
  if (ws > 1) {
    if ((lane & 1) == 0 && lane < 2 * kSums) part[warp][lane / 2] = v[0];
    if (lane == 0) part[warp][kSums] = __int_as_float(cnt);
    __syncthreads();
    const int w0 = warp - warp % ws;  // the group's first warp
    if (lane <= kSums) {  // lane k: sum k in warp order, lane 10 the count
      float t[8];  // 8 reads in flight, then the adds in order
      float tot = 0.f;
      int n = 0;
      for (int wb = 0; wb < ws; wb += 8) {
#pragma unroll
        for (int q = 0; q < 8; ++q)
          t[q] = wb + q < ws ? part[w0 + wb + q][lane] : 0.f;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          if (wb + q >= ws) break;
          if (lane == kSums) n += __float_as_int(t[q]);
          else tot = wb + q == 0 ? t[q] : tot + t[q];
        }
      }
      v[0] = lane == kSums ? __int_as_float(n) : tot;
    }
    cnt = __float_as_int(__shfl_sync(kFull, v[0], kSums));
  }
  const int stride = ws > 1 ? 1 : 2;  // where total k sits: lane k or 2k
#pragma unroll
  for (int k = 0; k < kSums; ++k)
    acc[k] = __shfl_sync(kFull, v[0], k * stride);
}

// The adjugate solve and the clamped update of (x, y, th).
__device__ __forceinline__ void solve(const float (&acc)[kSums], float& x,
                                      float& y, float& th, float yaw_clamp) {
  const float a = acc[0], bb = acc[1], cc = acc[2];
  const float d = acc[3], e = acc[4], f = acc[5];
  const float d0 = acc[6], d1 = acc[7], d2 = acc[8];
  const float det =
      a * (d * f - e * e) - bb * (bb * f - e * cc) + cc * (bb * e - d * cc);
  if (!(fabsf(det) > 1e-12f)) return;
  const float i00 = (d * f - e * e) / det;
  const float i01 = (cc * e - bb * f) / det;
  const float i02 = (bb * e - cc * d) / det;
  const float i11 = (a * f - cc * cc) / det;
  const float i12 = (bb * cc - a * e) / det;
  const float i22 = (a * d - bb * bb) / det;
  const float dx = i00 * d0 + i01 * d1 + i02 * d2;
  const float dy = i01 * d0 + i11 * d1 + i12 * d2;
  const float dth =
      fminf(fmaxf(i02 * d0 + i12 * d1 + i22 * d2, -yaw_clamp), yaw_clamp);
  x = x + dx;
  y = y + dy;
  th = th + dth;
}

// The bf16 cells g[at] and g[at + 1] as floats, with e = at & 3, from w,
// the four bf16 at the aligned index at - e, and hi, whose low half is
// g[at + 1] when e == 3 (the pair straddles the 8 bytes).
__device__ __forceinline__ void cell_pair(uint2 w, uint32_t hi, int e,
                                          float& c0, float& c1) {
  const uint32_t lo = e < 2 ? w.x : w.y;
  const uint32_t up = e < 2 ? w.y : hi;
  const uint32_t sh = 16u * (e & 1);
  c0 = __uint_as_float(__funnelshift_r(lo, up, sh) << 16);
  c1 = __uint_as_float(__funnelshift_rc(lo, up, sh + 16) << 16);
}

// floor(x) for |x| < 2^22 in f32 adds, and the same as an int: adding
// 1.5 * 2^23 rounds x to an integer, which sits in the low bits of the
// sum (no conversion instruction: those issue at an eighth of the f32
// rate on this card).
__device__ __forceinline__ float floor_small(float x, int& i) {
  constexpr float kMagic = 12582912.f;  // 1.5 * 2^23, bits 0x4b400000
  const float r = __fsub_rn(__fadd_rn(x, kMagic), kMagic);
  const float f = r > x ? __fsub_rn(r, 1.f) : r;
  i = __float_as_int(__fadd_rn(f, kMagic)) - 0x4b400000;
  return f;
}

// One iteration's terms of K beams of the thread (points px, py, valid
// vb) at the pose (c, s, x, y), added to acc in beam order; cnt counts the
// beams inside the gate.
template <int K>
__device__ __forceinline__ void add_beams(
    const float (&px)[K], const float (&py)[K], const bool (&vb)[K],
    float c, float s, float x, float y, float oxf, float oyf, int ox,
    int oy, int gw, int window, const uint16_t* __restrict__ grid,
    float (&acc)[kSums], int& cnt) {
  float tx[K], fx[K], fy[K];
  int e0[K], e1[K];
  bool in[K];
  uint2 w0[K], w1[K];
  uint32_t h0[K], h1[K];
#pragma unroll
  for (int u = 0; u < K; ++u) {
    tx[u] = c * px[u] - s * py[u] + x - oxf;
    const float ty = s * px[u] + c * py[u] + y - oyf;
    int ix, iy;
    fx[u] = floor_small(tx[u], ix);  // == float(ix)
    const float fly = floor_small(ty, iy);
    // one unsigned compare a side; where |t| >= 2^22 (or t is not
    // finite) floor_small's int lies outside [0, 2^22) > window
    in[u] = vb[u] && static_cast<unsigned>(ix) < window - 1u &&
            static_cast<unsigned>(iy) < window - 1u;
    fy[u] = ty - fly;
    // every read before any use: the cells ix, ix + 1 of rows iy and
    // iy + 1, each pair from the 4-aligned 8 bytes around it (the host
    // keeps h * w < 2^31); a beam outside the gate reads zeros
    const int at0 = in[u] ? (oy + iy) * gw + ox + ix : 0;
    const int at1 = at0 + gw;
    e0[u] = at0 & 3;
    e1[u] = at1 & 3;
    w0[u] = in[u] ? *reinterpret_cast<const uint2*>(grid + (at0 - e0[u]))
                  : make_uint2(0u, 0u);
    w1[u] = in[u] ? *reinterpret_cast<const uint2*>(grid + (at1 - e1[u]))
                  : make_uint2(0u, 0u);
    h0[u] = in[u] && e0[u] == 3 ? grid[at0 + 1] : 0u;
    h1[u] = in[u] && e1[u] == 3 ? grid[at1 + 1] : 0u;
  }
  // no branch a beam: a beam outside the gate has its val and J set to
  // zero, so every term it adds is an exact zero (x + 0 == x), whatever
  // its point
#pragma unroll
  for (int u = 0; u < K; ++u) {
    float c00, c01, c10, c11;
    cell_pair(w0[u], h0[u], e0[u], c00, c01);
    cell_pair(w1[u], h1[u], e1[u], c10, c11);
    // both row differences rounded to bf16 in one instruction
    const __nv_bfloat162 dg = __floats2bfloat162_rn(c10 - c00, c11 - c01);
    const float dg0 = __low2float(dg);
    const float dg1 = __high2float(dg);
    const float yg0 = c00 + fy[u] * dg0;
    const float yg1 = c01 + fy[u] * dg1;
    // float(ix) == fx and float(ix + 1) == fx + 1 exactly
    const float w0f = 1.f - fabsf(fx[u] - tx[u]);
    const float w1f = 1.f - fabsf((fx[u] + 1.f) - tx[u]);
    const float val = in[u] ? yg0 * w0f + yg1 * w1f : 0.f;
    const float gx = in[u] ? yg1 - yg0 : 0.f;
    const float gy = in[u] ? dg0 * w0f + dg1 * w1f : 0.f;
    const float rot =
        in[u] ? (-s * px[u] - c * py[u]) * gx + (c * px[u] - s * py[u]) * gy
              : 0.f;
    const float r = 1.f - val;
    acc[0] += gx * gx;
    acc[1] += gx * gy;
    acc[2] += gx * rot;
    acc[3] += gy * gy;
    acc[4] += gy * rot;
    acc[5] += rot * rot;
    acc[6] += gx * r;
    acc[7] += gy * r;
    acc[8] += rot * r;
    acc[9] += val;
    cnt += in[u];
  }
}

// Tile m of the thread's beams, t + (m kBeams + u) g for u < kBeams
// (tile 0 the beams that every form holds in registers).
template <int kBeams>
__device__ __forceinline__ void load_tile(const float2* __restrict__ p,
                                          const uint8_t* __restrict__ v,
                                          int t, int g, int m, int nb,
                                          float (&px)[kBeams],
                                          float (&py)[kBeams],
                                          bool (&vb)[kBeams]) {
#pragma unroll
  for (int u = 0; u < kBeams; ++u) {
    const int i = t + (m * kBeams + u) * g;
    vb[u] = i < nb && v[i];
    const float2 q = vb[u] ? p[i] : make_float2(0.f, 0.f);
    px[u] = q.x;
    py[u] = q.y;
  }
}

template <int kBeams, bool kWide>
__global__ void __launch_bounds__(kThreads)
hector_gn_kernel(const uint16_t* __restrict__ grid, int gh, int gw,
                 const float2* __restrict__ pts,
                 const uint8_t* __restrict__ valid,
                 const float* __restrict__ pose0, int n_scans, int b,
                 int window, int num_iters, float yaw_clamp, int ws,
                 float* __restrict__ out_pose, float* __restrict__ out_h,
                 float* __restrict__ out_score, int* __restrict__ out_inb) {
  __shared__ float part[2][kThreads / 32][kSums + 1];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int scan = blockIdx.x * (kThreads / 32 / ws) + warp / ws;
  // a group past the last scan runs with no beams: with ws > 1 its
  // threads still meet every __syncthreads
  const bool live = scan < n_scans;
  if (!live && ws == 1) return;
  const int sc = live ? scan : 0;
  const int nb = live ? b : 0;
  const int t = (warp % ws) * 32 + lane;  // the thread in its group
  const int g = ws * 32;                  // the group's beam stride
  const float2* p = pts + static_cast<size_t>(sc) * b;
  const uint8_t* v = valid + static_cast<size_t>(sc) * b;
  const float* q0 = pose0 + static_cast<size_t>(sc) * 3;

  int ox = static_cast<int>(floorf(q0[0])) - window / 2;
  int oy = static_cast<int>(floorf(q0[1])) - window / 2;
  ox = min(max(ox, 0), max(gw - window, 0)) / 128 * 128;
  oy = min(max(oy, 0), max(gh - window, 0)) / 8 * 8;
  const float oxf = static_cast<float>(ox);
  const float oyf = static_cast<float>(oy);

  // the thread's beams t, t + g, ... (at most kBeams: the host's choice
  // of ws sees to it; the wide form's first kBeams), held in registers
  // through every iteration
  float px[kBeams], py[kBeams];
  bool vb[kBeams];
  int cnt = 0;
  load_tile<kBeams>(p, v, t, g, 0, nb, px, py, vb);
#pragma unroll
  for (int u = 0; u < kBeams; ++u) cnt += vb[u];
  // the wide form's further tiles of kBeams beams a thread
  const int tiles = kWide ? (b + g * kBeams - 1) / (g * kBeams) : 1;
  for (int m = 1; m < tiles; ++m) {
    float qx[kBeams], qy[kBeams];
    bool qv[kBeams];
    load_tile<kBeams>(p, v, t, g, m, nb, qx, qy, qv);
#pragma unroll
    for (int u = 0; u < kBeams; ++u) cnt += qv[u];
  }
  float acc[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) acc[k] = 0.f;
  int parity = 0;
  scan_sum(acc, cnt, ws, warp, lane, part[parity]);
  const int n_valid = cnt;
  float x = q0[0], y = q0[1], th = q0[2];
  float hm[6] = {1.f, 0.f, 0.f, 1.f, 0.f, 1.f};  // eye(3), upper triangle
  float score = 0.f;
  int n_inb = 0;

  for (int it = 0; it < num_iters; ++it) {
    float s, c;
    sincosf(th, &s, &c);
#pragma unroll
    for (int k = 0; k < kSums; ++k) acc[k] = 0.f;
    cnt = 0;
    add_beams<kBeams>(px, py, vb, c, s, x, y, oxf, oyf, ox, oy, gw, window,
                      grid, acc, cnt);
    for (int m = 1; m < tiles; ++m) {  // the wide form: in beam order
      float qx[kBeams], qy[kBeams];
      bool qv[kBeams];
      load_tile<kBeams>(p, v, t, g, m, nb, qx, qy, qv);
      add_beams<kBeams>(qx, qy, qv, c, s, x, y, oxf, oyf, ox, oy, gw,
                        window, grid, acc, cnt);
    }
    parity ^= 1;
    scan_sum(acc, cnt, ws, warp, lane, part[parity]);
    // every lane holds the same sums: every lane solves alike
    solve(acc, x, y, th, yaw_clamp);
#pragma unroll
    for (int k = 0; k < 6; ++k) hm[k] = acc[k];
    score = acc[9];
    n_inb = cnt;
  }

  if (!live || t != 0) return;
  float* po = out_pose + static_cast<size_t>(scan) * 3;
  po[0] = x;
  po[1] = y;
  po[2] = th;
  float* ho = out_h + static_cast<size_t>(scan) * 9;
  const int sym[9] = {0, 1, 2, 1, 3, 4, 2, 4, 5};
#pragma unroll
  for (int k = 0; k < 9; ++k) ho[k] = hm[sym[k]];
  out_score[scan] = score / static_cast<float>(max(n_valid, 1));
  out_inb[scan] = n_inb;
}

// One launch at kBeams beams a thread (kWide: a multiple of them).
template <int kBeams, bool kWide = false>
cudaError_t launch(const void* grid, int h, int w, const void* pts,
                   const void* valid, const void* pose0, int s, int b,
                   int window, int num_iters, float yaw_clamp, int ws,
                   void* out_pose, void* out_h, void* out_score,
                   void* out_inb, cudaStream_t stream) {
  const int per_block = kThreads / 32 / ws;
  hector_gn_kernel<kBeams, kWide>
      <<<(s + per_block - 1) / per_block, kThreads, 0, stream>>>(
          static_cast<const uint16_t*>(grid), h, w,
          static_cast<const float2*>(pts),
          static_cast<const uint8_t*>(valid),
          static_cast<const float*>(pose0), s, b, window, num_iters,
          yaw_clamp, ws, static_cast<float*>(out_pose),
          static_cast<float*>(out_h), static_cast<float*>(out_score),
          static_cast<int*>(out_inb));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out_pose [s, 3] f32, out_h [s, 3, 3] f32, out_score [s] f32, out_inb
// [s] int32 <- num_iters GN steps of each scan of pts [s, b, 2] f32 /
// valid [s, b] uint8 from pose0 [s, 3] f32 against grid [h, w] bf16, 8-byte
// aligned and readable to a multiple of 4 cells (contract above); window
// <= min(h, w), >= 2; ws warps a scan (1, 2, 4 or 8) with ceil(b / (32
// ws)) <= 16 beams a thread, or ws = 8 and any b (the wide form).  Returns
// cudaGetLastError() after the launch.
int tpuslam_hector_gn(const void* grid, int h, int w, const void* pts,
                      const void* valid, const void* pose0, int s, int b,
                      int window, int num_iters, float yaw_clamp, int ws,
                      void* out_pose, void* out_h, void* out_score,
                      void* out_inb, void* stream) {
  cudaGetLastError();  // clear a stale error so the return value is ours
  if (ws < 1 || ws > kMaxWarps || (ws & (ws - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (s <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the fewest beams a thread that cover b: every slot does work
  const int per_thread = (b + 32 * ws - 1) / (32 * ws);
#define TPUSLAM_HECTOR_ARGS                                                 \
  grid, h, w, pts, valid, pose0, s, b, window, num_iters, yaw_clamp, ws,   \
      out_pose, out_h, out_score, out_inb, st
  cudaError_t e = cudaErrorInvalidValue;
  switch (per_thread) {
    case 1: e = launch<1>(TPUSLAM_HECTOR_ARGS); break;
    case 2: e = launch<2>(TPUSLAM_HECTOR_ARGS); break;
    case 3: e = launch<3>(TPUSLAM_HECTOR_ARGS); break;
    case 4: e = launch<4>(TPUSLAM_HECTOR_ARGS); break;
    case 5: e = launch<5>(TPUSLAM_HECTOR_ARGS); break;
    case 6: e = launch<6>(TPUSLAM_HECTOR_ARGS); break;
    case 7: case 8: e = launch<8>(TPUSLAM_HECTOR_ARGS); break;
    case 9: case 10: case 11: case 12:
      e = launch<12>(TPUSLAM_HECTOR_ARGS);
      break;
    case 13: case 14: case 15: case 16:
      e = launch<16>(TPUSLAM_HECTOR_ARGS);
      break;
    default:
      if (per_thread > 16 && ws == kMaxWarps)
        e = launch<16, true>(TPUSLAM_HECTOR_ARGS);
  }
#undef TPUSLAM_HECTOR_ARGS
  return static_cast<int>(e);
}

}  // extern "C"
