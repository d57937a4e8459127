// FindValidPoints visibility filter for S scans at once.
//
// Replaces the TPU kernel of tpuslam/ops/pallas_fvp.py:
//   find_valid_points_batch (_fvp_pallas_jit, the pallas_call at :96)
// which reproduces the reference's trailing-anchor walk (Mapper.cpp:758-817).
//
// Contract, per scan (one row of the [S, B] planes):
//   forward: the anchor seeds on the first valid point without deciding;
//     point i "decides" when it is valid and (ax-x)^2 + (ay-y)^2 > 0.01
//     against the current anchor, and then becomes the anchor; a decision
//     records keep = x*a + y*b + c >= 0 with a = vpy-ay, b = ax-vpx,
//     c = ay*vpx - ax*vpy of the anchor it was measured against;
//   backward: point i takes the keep verdict of the first decision strictly
//     after i (false if none), ANDed with its own valid bit.
// Every f32 expression is evaluated in exactly that order with explicit
// round-to-nearest intrinsics (and the library is built with
// --fmad=false): a fused multiply-add would change mask bits.
//
// What bounds it on this card: the bytes are tiny (9 bytes a point in, 1
// out: 1.2 MB at S=110, B=1081, about 0.36 us at 3.35 TB/s), so the bound
// is latency.  Walked as written, one scan is B dependent steps, and the
// card holds only a few hundred scans at once: the design below takes
// O(log B) dependent steps a scan instead.
//
// Design: the walk's parallel form (the JAX package's parallel=True,
// tpuslam/match/correlative.py:236-292, bit-identical to the walk).  If a
// decision fires at i, making p_i the anchor, the next decision fires at
// next[i] = the first valid j > i with |p_i - p_j|^2 > 0.01.  So, one block
// per scan (up to 1024 threads, about one a point), the scan's points
// staged in shared memory:
//   1. next[i] for every valid i, a forward search four candidates a step
//      that usually ends within a few points (it runs long only inside
//      clusters closer than 0.1 m: ~150 points on a 0.12 m ring);
//   2. the decisions = the orbit of the first valid point i0 under next,
//      marked by pointer doubling: ceil(log2 B) rounds, each a scatter of
//      the marks through the pointers and a pointer jump, then a barrier;
//   3. each decision's anchor is its chain predecessor (next is strictly
//      increasing, so the predecessor is unique) and its keep the walk's
//      side-of-line expression against that anchor;
//   4. every point takes the keep of the first decision strictly after it:
//      a block-wide reverse min-scan over decision indices (each thread a
//      contiguous run, warps by shuffles, warps across shared memory).
// Inputs are read in the caller's [S, B, 2] / [S, B] layout: no transposes.
//
// Wide scans: a scan's arrays take 23 bytes a point, so past about 10,000
// points they do not fit a block's 227 KB of shared memory.  There the
// same kernel (kWide) keeps them in a global scratch the wrapper
// allocates, one 16-byte aligned slice a scan (377 KB at 16,384 points;
// S slices stay in the 50 MB L2 for the batches the matcher makes), with
// the same one block a scan, the same four stages and the same block
// barriers (__syncthreads orders a block's global accesses as it orders
// its shared ones), so the masks are those of the shared form bit for
// bit.  A cluster of blocks holding the arrays in distributed shared
// memory would serve such scans faster; that is left for later.

#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;  // a block: about one thread a point
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr float kMinSq = 0.01f;  // points closer than 0.1 m never decide

// a scan's arrays, in a block's dynamic shared memory or (kWide) in its
// slice of the global scratch: see fvp_smem_bytes
struct Smem {
  float* x;
  float* y;
  int* nxt;      // [b + 1], nxt[b] = b (the chain's terminator)
  int* ptr;      // [b + 1] pointer-doubling buffers; ptr later holds anchors
  int* ptr2;     // [b + 1]
  uint8_t* v;    // [b] valid
  uint8_t* r;    // [b + 1] on the orbit (a decision)
  uint8_t* keep; // [b] keep verdict of a decision
};

__host__ __device__ size_t fvp_smem_bytes(int b) {
  const size_t n = static_cast<size_t>(b) + 1;
  return n * (2 * sizeof(float) + 3 * sizeof(int)) + 3 * n;
}

// one scan's slice of the wide form's scratch: 16-byte aligned
__host__ __device__ size_t fvp_slice_bytes(int b) {
  return (fvp_smem_bytes(b) + 15) / 16 * 16;
}

__device__ Smem carve(unsigned char* base, int b) {
  const size_t n = static_cast<size_t>(b) + 1;
  Smem s;
  s.x = reinterpret_cast<float*>(base);
  s.y = s.x + n;
  s.nxt = reinterpret_cast<int*>(s.y + n);
  s.ptr = s.nxt + n;
  s.ptr2 = s.ptr + n;
  s.v = reinterpret_cast<uint8_t*>(s.ptr2 + n);
  s.r = s.v + n;
  s.keep = s.r + n;
  return s;
}

// the walk's distance test, operands in its order (anchor minus point)
__device__ __forceinline__ bool far_apart(float ax, float ay, float x,
                                          float y) {
  const float dx = __fsub_rn(ax, x);
  const float dy = __fsub_rn(ay, y);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) > kMinSq;
}

template <bool kWide>
__global__ void __launch_bounds__(kMaxThreads)
fvp_kernel(const float* __restrict__ pts, const uint8_t* __restrict__ valid,
           const float* __restrict__ vp, int b,
           unsigned char* __restrict__ scratch, uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_i0;
  __shared__ int s_warp_min[kMaxWarps];
  const Smem sm = carve(
      kWide ? scratch + blockIdx.x * fvp_slice_bytes(b) : smem_raw, b);
  const int t = threadIdx.x;
  const int nt = blockDim.x;  // a multiple of 32
  const size_t row = static_cast<size_t>(blockIdx.x) * b;
  const float2* p2 = reinterpret_cast<const float2*>(pts) + row;

  // stage the scan; i0 = the first valid point (b if none)
  if (t == 0) s_i0 = b;
  __syncthreads();
  int first = b;
  for (int i = t; i < b; i += nt) {
    const float2 p = p2[i];
    const uint8_t v = valid[row + i] != 0;
    sm.x[i] = p.x;
    sm.y[i] = p.y;
    sm.v[i] = v;
    sm.r[i] = 0;
    if (v && i < first) first = i;
  }
  if (t == 0) {
    sm.r[b] = 0;
    sm.nxt[b] = b;
  }
  if (first < b) atomicMin(&s_i0, first);
  __syncthreads();

  // 1. next[i]: the first valid j > i farther than 0.1 m from p_i, four
  // candidates a step so that their loads overlap
  for (int i = t; i < b; i += nt) {
    int j = b;
    if (sm.v[i]) {
      const float xi = sm.x[i];
      const float yi = sm.y[i];
      j = i + 1;
      int hit = -1;
      for (; hit < 0 && j + 3 < b; j += 4) {
        bool h[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          h[k] = sm.v[j + k] & far_apart(xi, yi, sm.x[j + k], sm.y[j + k]);
        }
        hit = h[0] ? j : h[1] ? j + 1 : h[2] ? j + 2 : h[3] ? j + 3 : -1;
      }
      for (; hit < 0 && j < b; ++j) {
        if (sm.v[j] && far_apart(xi, yi, sm.x[j], sm.y[j])) hit = j;
      }
      j = hit < 0 ? b : hit;
    }
    sm.nxt[i] = j;
    sm.ptr[i] = j;
  }
  if (t == 0) sm.ptr[b] = b;
  __syncthreads();
  const int i0 = s_i0;

  // 2. the orbit of i0: after k rounds r marks next^m(i0) for 1 <= m <= 2^k
  // (marks only ever land on orbit points, so in-place marking is safe;
  // the pointers are double-buffered so every jump is exactly 2^k)
  if (t == 0 && i0 < b) sm.r[sm.nxt[i0]] = 1;
  __syncthreads();
  int* cur = sm.ptr;
  int* nxt_buf = sm.ptr2;
  for (int span = 1; span < b; span <<= 1) {
    for (int i = t; i <= b; i += nt) {
      const int p = cur[i];
      if (sm.r[i]) sm.r[p] = 1;
      nxt_buf[i] = cur[p];
    }
    __syncthreads();
    int* tmp = cur;
    cur = nxt_buf;
    nxt_buf = tmp;
  }

  // 3. anchors: each chain point (i0 or a decision) anchors next[i]
  int* anchor = nxt_buf;  // free again
  for (int i = t; i < b; i += nt) {
    if ((sm.r[i] || i == i0) && i0 < b) {
      const int j = sm.nxt[i];
      if (j < b) anchor[j] = i;
    }
  }
  __syncthreads();
  const float vpx = vp[0];
  const float vpy = vp[1];
  for (int i = t; i < b; i += nt) {
    uint8_t k = 0;
    if (sm.r[i]) {
      const int a = anchor[i];
      const float ax = sm.x[a];
      const float ay = sm.y[a];
      const float la = __fsub_rn(vpy, ay);
      const float lb = __fsub_rn(ax, vpx);
      const float lc = __fsub_rn(__fmul_rn(ay, vpx), __fmul_rn(ax, vpy));
      const float side = __fadd_rn(
          __fadd_rn(__fmul_rn(sm.x[i], la), __fmul_rn(sm.y[i], lb)), lc);
      k = side >= 0.0f;
    }
    sm.keep[i] = k;
  }
  __syncthreads();

  // 4. reverse min-scan of decision indices: thread t owns [lo, hi)
  const int per = (b + nt - 1) / nt;
  const int lo = min(b, t * per);
  const int hi = min(b, lo + per);
  int m = b;  // first decision in [lo, hi)
  for (int i = hi - 1; i >= lo; --i) {
    if (sm.r[i]) m = i;
  }
  const int lane = t & 31;
  const int warp = t >> 5;
  int suffix = m;  // min over this warp's lanes >= lane
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_down_sync(0xffffffffu, suffix, off);
    if (lane + off < 32) suffix = min(suffix, o);
  }
  if (lane == 0) s_warp_min[warp] = suffix;
  __syncthreads();
  int after = __shfl_down_sync(0xffffffffu, suffix, 1);  // lanes > lane
  if (lane == 31) after = b;
  for (int w = warp + 1; w < nt / 32; ++w) after = min(after, s_warp_min[w]);
  int nd = after;  // the first decision after the point being written
  for (int i = hi - 1; i >= lo; --i) {
    out[row + i] = (nd < b && sm.v[i]) ? sm.keep[nd] : 0;
    if (sm.r[i]) nd = i;
  }
}

}  // namespace

extern "C" {

// out [s, b] uint8 (0/1) <- the mask, already ANDed with valid.
// pts [s, b, 2] f32, valid [s, b] uint8/bool, vp [2] f32, all contiguous
// on the device.  With scratch null, one scan (23 bytes a point) sits in a
// block's shared memory and the launch is refused where it does not fit;
// else scratch holds s * fvp_slice_bytes(b) bytes (the wide form).
// Returns cudaGetLastError().
int tpuslam_fvp(const void* pts, const void* valid, const void* vp, int s,
                int b, void* scratch, void* out, void* stream) {
  cudaGetLastError();  // clear a stale error so the return value is ours
  if (s <= 0 || b <= 0) return static_cast<int>(cudaGetLastError());
  const int threads = std::min(kMaxThreads, std::max(64, (b + 31) / 32 * 32));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(pts);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  const float* q = static_cast<const float*>(vp);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (scratch != nullptr) {
    fvp_kernel<true><<<s, threads, 0, st>>>(
        p, v, q, b, static_cast<unsigned char*>(scratch), o);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = fvp_smem_bytes(b);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(fvp_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  fvp_kernel<false><<<s, threads, smem, st>>>(p, v, q, b, nullptr, o);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
