// Correlative response surfaces: summed patches of the quantized grid.
//
// Replaces the two TPU kernels of tpuslam/ops/pallas_correlative.py:
//   - patch_sums_pallas  (_patch_sums_pallas_jit, the pallas_call at :158)
//   - patch_sums_stride2 (_patch_sums_stride2_jit, the pallas_call at :294)
// One kernel serves both; stride=2 is exactly the stride-2 contract.
//
// Contract, for every angle a and output cell (k, l) < (s, s):
//   out[a, k, l] = sum over points p with ok[a, p] of
//                  q[ay[a, p] + stride*k, ax[a, p] + stride*l]
// where q = round(grid * 100) is the uint8 [G, G] byte grid (values <= 100)
// that the caller quantizes once per correlation grid, and a cell outside
// [0, G)^2 reads zero.  Every addend is an integer <= 100 and every total
// is below 2^24, so the f32 result is exact in any summation order: the
// output is bit-identical to the TPU kernels and deterministic even though
// blocks meet through atomics.
//
// What bounds it on this card: one byte load and one add per (point, cell),
// 1.8 M of each at the sequential coarse pass (G = 2007, S = 9, 21 angles,
// 1081 points) and 131 M at the stride-2 loop pass (s2 = 76).  The bytes
// that must move are few (the points and the output; the grid, 1.3-4 MB,
// stays in the 50 MB L2), so the roofline bound is the adds, ~2 us at the
// f32 rate; in practice the load instructions and their latency bound it,
// so the design keeps many independent loads in flight and enough blocks
// to fill the card.
//
// Design: a block owns (angle, a run of output cells, a chunk of at most
// kChunk points).  The chunk's kept points are staged in shared memory as
// flat grid offsets, split into those whose whole patch lies on the grid
// (the main path's only kind: its callers drop the others) and those
// that need per-cell bounds checks.  A thread owns R cells (R = 4 once the
// patch has enough cells, 1 below) and walks its point lane's points
// kUnroll at a time, so R x kUnroll independent loads are in flight; the 32
// threads of a warp own 32 consecutive cells, so one load instruction reads
// neighbouring bytes of a grid row, and consecutive beams land in
// neighbouring cells, so L1 serves most of them.  Small patches (S = 3, 5,
// 9) give the spare threads of a block their own point lanes.  Chunks and
// lanes meet in the output through atomicAdd of exact integer-valued
// floats.  Flat offsets are int, or 64-bit (Off) where G^2 >= 2^31 (G >=
// 46,341: a 2.1 GB byte grid), so a grid that large sums the same cells.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 128;  // most points one block walks
constexpr int kUnroll = 8;   // points walked together by a thread

template <int R, typename Off>
__global__ void __launch_bounds__(kThreads)
patch_sums_kernel(const uint8_t* __restrict__ q, int g,
                  const int* __restrict__ ay, const int* __restrict__ ax,
                  const uint8_t* __restrict__ ok, int b, int s, int stride,
                  int cells_blk, int per_lane, int lanes, int chunk,
                  float* __restrict__ out) {
  __shared__ Off s_in[kChunk];     // flat offsets of whole-patch points
  __shared__ int s_ey[kChunk];     // rows / cols of points off the edge
  __shared__ int s_ex[kChunk];
  __shared__ int s_n_in;
  __shared__ int s_n_edge;

  const int a = blockIdx.y;
  const int t = threadIdx.x;
  const int p0 = blockIdx.z * chunk;
  const int n = min(chunk, b - p0);
  const int span = stride * (s - 1);  // a patch covers [y, y + span]
  if (t == 0) {
    s_n_in = 0;
    s_n_edge = 0;
  }
  __syncthreads();
  if (t < n) {
    const size_t p = static_cast<size_t>(a) * b + p0 + t;
    if (ok[p]) {
      const int y = ay[p];
      const int x = ax[p];
      if (y >= 0 && x >= 0 && y < g - span && x < g - span) {
        s_in[atomicAdd(&s_n_in, 1)] = static_cast<Off>(y) * g + x;
      } else {
        const int e = atomicAdd(&s_n_edge, 1);
        s_ey[e] = y;
        s_ex[e] = x;
      }
    }
  }
  __syncthreads();
  const int n_in = s_n_in;
  const int n_edge = s_n_edge;

  const int lane = t / per_lane;  // point lane of this thread
  const int u = t - lane * per_lane;
  const int cell0 = blockIdx.x * cells_blk;
  const int cell_end = min(s * s, cell0 + cells_blk);
  if (lane >= lanes) return;  // no barrier follows
  Off off[R];
  int ky[R];
  int kx[R];
  bool live[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int c = cell0 + u + r * per_lane;
    live[r] = c < cell_end;
    const int k = live[r] ? c / s : 0;
    const int l = live[r] ? c - k * s : 0;
    ky[r] = stride * k;
    kx[r] = stride * l;
    off[r] = static_cast<Off>(ky[r]) * g + kx[r];
  }

  int acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0;
  int i = lane;
  for (; i + (kUnroll - 1) * lanes < n_in; i += kUnroll * lanes) {
    Off base[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) base[j] = s_in[i + j * lanes];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] += q[base[j] + off[r]];
    }
  }
  for (; i < n_in; i += lanes) {
    const Off base = s_in[i];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] += q[base + off[r]];
  }
  for (int e = lane; e < n_edge; e += lanes) {  // per-cell bounds checks
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int y = s_ey[e] + ky[r];
      const int x = s_ex[e] + kx[r];
      if (static_cast<unsigned>(y) < static_cast<unsigned>(g) &&
          static_cast<unsigned>(x) < static_cast<unsigned>(g)) {
        acc[r] += q[static_cast<size_t>(y) * g + x];
      }
    }
  }

  float* out_a = out + static_cast<size_t>(a) * s * s;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    // integer-valued partial sums below 2^24: exact in any order
    if (live[r] && acc[r] != 0) {
      atomicAdd(out_a + cell0 + u + r * per_lane, static_cast<float>(acc[r]));
    }
  }
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

template <int R, typename Off>
void launch(dim3 grid, cudaStream_t st, const uint8_t* q, int g,
            const int* ay, const int* ax, const uint8_t* ok, int b, int s,
            int stride, int cells_blk, int per_lane, int lanes, int chunk,
            float* out) {
  patch_sums_kernel<R, Off><<<grid, kThreads, 0, st>>>(
      q, g, ay, ax, ok, b, s, stride, cells_blk, per_lane, lanes, chunk,
      out);
}

}  // namespace

extern "C" {

// out [n_a, s, s] f32 <- summed (strided) patches; see the contract above.
// Pointers: q [g, g] uint8, ay/ax [n_a, b] int32, ok [n_a, b] uint8/bool,
// all contiguous on the current device.  Returns cudaGetLastError().
int tpuslam_patch_sums(const void* q, int g, const void* ay, const void* ax,
                       const void* ok, int n_a, int b, int s, int stride,
                       void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaGetLastError();  // clear a stale error so the return value is ours
  if (n_a <= 0 || s <= 0) return static_cast<int>(cudaGetLastError());
  cudaMemsetAsync(out, 0, sizeof(float) * static_cast<size_t>(n_a) * s * s,
                  st);
  if (b <= 0) return static_cast<int>(cudaGetLastError());
  const int cells = s * s;
  // R = 4 cells a thread once a block's threads are all busy at R = 1
  const bool wide = cells > kThreads;
  const int r = wide ? 4 : 1;
  const int cells_blk = wide ? kThreads * r : cells;
  const int per_lane = wide ? kThreads : cells;  // threads of a point lane
  const int lanes = kThreads / per_lane;
  const int chunk = ceil_div(b, ceil_div(b, kChunk));
  const dim3 grid(ceil_div(cells, cells_blk), n_a, ceil_div(b, chunk));
  const uint8_t* q8 = static_cast<const uint8_t*>(q);
  const int* ay32 = static_cast<const int*>(ay);
  const int* ax32 = static_cast<const int*>(ax);
  const uint8_t* ok8 = static_cast<const uint8_t*>(ok);
  float* o = static_cast<float*>(out);
  // 64-bit flat offsets only where an int cannot hold y * g + x
  const bool big = static_cast<long long>(g) * g >= (1LL << 31);
#define TPUSLAM_PATCH_ARGS                                                \
  grid, st, q8, g, ay32, ax32, ok8, b, s, stride, cells_blk, per_lane,     \
      lanes, chunk, o
  if (wide) {
    if (big) launch<4, long long>(TPUSLAM_PATCH_ARGS);
    else launch<4, int>(TPUSLAM_PATCH_ARGS);
  } else {
    if (big) launch<1, long long>(TPUSLAM_PATCH_ARGS);
    else launch<1, int>(TPUSLAM_PATCH_ARGS);
  }
#undef TPUSLAM_PATCH_ARGS
  return static_cast<int>(cudaGetLastError());
}

const char* tpuslam_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
