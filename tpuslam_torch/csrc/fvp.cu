// FindValidPoints visibility walk for S scans at once.
//
// Replaces the TPU kernel of tpuslam/ops/pallas_fvp.py:
//   find_valid_points_batch (_fvp_pallas_jit, the pallas_call at :96)
// which reproduces the reference's trailing-anchor walk (Mapper.cpp:758-817).
//
// Contract, per scan (one column of the [B, S] planes):
//   forward: the anchor seeds on the first valid point without deciding;
//     point i "decides" when it is valid and (ax-x)^2 + (ay-y)^2 > 0.01
//     against the current anchor, and then becomes the anchor; every point
//     records keep = x*a + y*b + c >= 0 with a = vpy-ay, b = ax-vpx,
//     c = ay*vpx - ax*vpy of the current anchor;
//   backward: point i takes the keep verdict of the first decision strictly
//     after i (false if none).  The caller ANDs the result with `valid`.
// Every f32 expression is evaluated in exactly that order with explicit
// round-to-nearest intrinsics (and the library is built with
// --fmad=false): a fused multiply-add would change mask bits.
//
// What bounds it on this card: the walk is serial in B (up to 1081 steps),
// so one scan is latency-bound on its dependent loads and compares; the
// card is filled only across scans, and S is at most a few hundred.
//
// Design: one thread per scan, points laid out [B, S] so that neighbouring
// threads read neighbouring scans (the TPU kernel's scans-in-lanes layout):
// every step of the walk is one coalesced load per plane for a warp.  The
// forward walk writes its decide and keep bytes to scratch that the
// wrapper allocates; the backward pass reads them in reverse.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr float kMinSq = 0.01f;  // points closer than 0.1 m never decide

__global__ void __launch_bounds__(kThreads)
fvp_kernel(const float* __restrict__ px, const float* __restrict__ py,
           const uint8_t* __restrict__ pv, const float* __restrict__ vp,
           int s, int b, uint8_t* __restrict__ dec, uint8_t* __restrict__ keep,
           uint8_t* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= s) return;
  const float vpx = vp[0];
  const float vpy = vp[1];

  float ax = 0.0f;
  float ay = 0.0f;
  bool anchored = false;
  for (int i = 0; i < b; ++i) {
    const size_t o = static_cast<size_t>(i) * s + j;
    const float x = px[o];
    const float y = py[o];
    const bool v = pv[o] != 0;
    const float dx = __fsub_rn(ax, x);
    const float dy = __fsub_rn(ay, y);
    const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
    const bool decide = (d2 > kMinSq) && anchored && v;
    const float la = __fsub_rn(vpy, ay);
    const float lb = __fsub_rn(ax, vpx);
    const float lc = __fsub_rn(__fmul_rn(ay, vpx), __fmul_rn(ax, vpy));
    const float side =
        __fadd_rn(__fadd_rn(__fmul_rn(x, la), __fmul_rn(y, lb)), lc);
    dec[o] = decide;
    keep[o] = side >= 0.0f;
    if (decide || (!anchored && v)) {  // advance, or seed without deciding
      ax = x;
      ay = y;
    }
    anchored = anchored || v;
  }

  uint8_t verdict = 0;  // the keep of the next decision after i
  for (int i = b - 1; i >= 0; --i) {
    const size_t o = static_cast<size_t>(i) * s + j;
    out[o] = verdict;
    if (dec[o]) verdict = keep[o];
  }
}

}  // namespace

extern "C" {

// out [b, s] uint8 <- the walk's verdicts (before the caller's & valid).
// px, py [b, s] f32, pv [b, s] uint8/bool, vp [2] f32 on the device;
// dec, keep [b, s] uint8 scratch.  Returns cudaGetLastError().
int tpuslam_fvp(const void* px, const void* py, const void* pv,
                const void* vp, int s, int b, void* dec, void* keep, void* out,
                void* stream) {
  cudaGetLastError();  // clear a stale error so the return value is ours
  if (s <= 0 || b <= 0) return static_cast<int>(cudaGetLastError());
  const int blocks = (s + kThreads - 1) / kThreads;
  fvp_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(px), static_cast<const float*>(py),
      static_cast<const uint8_t*>(pv), static_cast<const float*>(vp), s, b,
      static_cast<uint8_t*>(dec), static_cast<uint8_t*>(keep),
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
