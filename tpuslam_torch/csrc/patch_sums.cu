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
// where q = round(grid * 100) is a uint8 [G, G] grid (values <= 100) and a
// cell outside [0, G)^2 reads zero.  Every addend is an integer <= 100 and
// every total is below 2^24, so the f32 result is exact in any summation
// order: the output is bit-identical to the TPU kernels and deterministic
// even though blocks meet through atomics.
//
// What bounds it on this card: at the sequential sizes (S = 3, 5, 9, 33)
// the work is a few million byte loads, so launch latency and the serial
// walk over B points dominate; at loop scale (S = 153, or s2 = 76 at
// stride 2) it is L2-to-SM traffic, about one 32-byte sector per point
// per 8x32 output tile.  The grid is read from L2: at G = 2431 the uint8
// grid is 5.9 MB and stays resident in the 50 MB L2 (the TPU held a bf16
// copy in VMEM; no on-chip store that large exists here).
//
// Design: a block owns (angle, output tile of up to 8x32 cells) and loops
// over that angle's points, staging (ay, ax, ok) through shared memory in
// chunks of 256.  Each thread owns one output cell and keeps an int32
// sum; the 32 threads of a warp own 32 consecutive cells of one output row,
// so for each point they read consecutive bytes of one grid row.  When the
// tile is small (S = 3, 5, 9) the spare threads of the block form extra
// point lanes, reduced in shared memory, and a third grid dimension splits
// the points into chunks so the card has enough blocks; chunks meet in the
// output through atomicAdd of exact integer-valued floats.  No padding of
// the grid, no landing strip: dropped points are masked by `ok`.

#include <algorithm>
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStage = 256;      // points staged in shared memory at a time
constexpr int kMinChunk = 64;    // fewest points a chunk of the point split holds
constexpr int kTargetBlocks = 4 * 132;  // about four blocks per H100 SM
constexpr int kDropped = INT_MIN / 2;   // row of a dropped point: off-grid

__global__ void __launch_bounds__(kThreads)
patch_sums_kernel(const uint8_t* __restrict__ q, int g,
                  const int* __restrict__ ay, const int* __restrict__ ax,
                  const uint8_t* __restrict__ ok, int b, int s, int stride,
                  int tw, int th, int tiles_x, int groups, int chunk,
                  float* __restrict__ out) {
  __shared__ int s_y[kStage];
  __shared__ int s_x[kStage];
  __shared__ int s_acc[kThreads];

  const int a = blockIdx.y;
  const int t = threadIdx.x;
  const int cells = tw * th;
  const int grp = t / cells;  // point lane of this thread
  const int cell = t - grp * cells;
  const int k = (blockIdx.x / tiles_x) * th + cell / tw;  // output row
  const int l = (blockIdx.x % tiles_x) * tw + cell % tw;  // output col
  const bool active = grp < groups && k < s && l < s;
  const int dy = stride * k;
  const int dx = stride * l;

  const int* ay_a = ay + static_cast<size_t>(a) * b;
  const int* ax_a = ax + static_cast<size_t>(a) * b;
  const uint8_t* ok_a = ok + static_cast<size_t>(a) * b;
  const int p_begin = blockIdx.z * chunk;
  const int p_end = min(b, p_begin + chunk);

  int acc = 0;
  for (int p0 = p_begin; p0 < p_end; p0 += kStage) {
    const int n = min(kStage, p_end - p0);
    __syncthreads();  // the previous stage is consumed
    if (t < n) {
      const int p = p0 + t;
      const bool keep = ok_a[p] != 0;
      s_y[t] = keep ? ay_a[p] : kDropped;
      s_x[t] = keep ? ax_a[p] : 0;
    }
    __syncthreads();
    if (active) {
      for (int i = grp; i < n; i += groups) {
        const int y = s_y[i] + dy;
        const int x = s_x[i] + dx;
        if (static_cast<unsigned>(y) < static_cast<unsigned>(g) &&
            static_cast<unsigned>(x) < static_cast<unsigned>(g)) {
          acc += q[static_cast<size_t>(y) * g + x];
        }
      }
    }
  }

  if (groups > 1) {  // fold the point lanes onto lane 0
    s_acc[t] = active ? acc : 0;
    __syncthreads();
    if (grp == 0 && active) {
      for (int r = 1; r < groups; ++r) acc += s_acc[r * cells + cell];
    }
  }
  if (grp == 0 && active && acc != 0) {
    // integer-valued partial sums below 2^24: exact in any order
    atomicAdd(out + (static_cast<size_t>(a) * s + k) * s + l,
              static_cast<float>(acc));
  }
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

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
  const int tw = std::min(s, 32);
  const int th = std::min(s, kThreads / tw);
  const int groups = kThreads / (tw * th);
  const int tiles_x = ceil_div(s, tw);
  const int tiles = tiles_x * ceil_div(s, th);
  const int chunks = std::max(1, std::min(ceil_div(b, kMinChunk),
                                          ceil_div(kTargetBlocks, tiles * n_a)));
  const int chunk = ceil_div(b, chunks);
  const dim3 grid(tiles, n_a, ceil_div(b, chunk));
  patch_sums_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const uint8_t*>(q), g, static_cast<const int*>(ay),
      static_cast<const int*>(ax), static_cast<const uint8_t*>(ok), b, s,
      stride, tw, th, tiles_x, groups, chunk, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* tpuslam_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
