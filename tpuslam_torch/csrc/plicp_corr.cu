// PL-ICP / ICP correspondence search for N scan pairs.
//
// Replaces the TPU kernel of tpuslam/ops/pallas_plicp.py:
//   _corr_kernel / _corr_batched (the pallas_call at :179), reached by
//   correspondences_pallas (:244, line=True) and nearest_pallas (:260,
//   line=False).
//
// Contract, per pair n and source row i (cur [N,B,2], ref [N,B',2]):
//   d2[j]  = (cx-rx[j])^2 + (cy-ry[j])^2 where ref j and source i are
//            valid, else BIG = 1e9;
//   d1     = min_j d2[j], j1 = the LOWEST j with d2[j] == d1, q1 = ref[j1];
//   line:  d_r = d2[j1+1] (BIG past the end), d_l = d2[j1-1] (BIG before
//          the start); j2 = j1+1 if d_r < d_l else j1-1, clamped to the
//          scan; q2 = ref[j2]; ok = d1 < BIG & min(d_r, d_l) < BIG &
//          d1 < max_d2;
//   nearest (line=0): q2 = q1; ok = d1 < BIG & d1 < max_d2;
//   doubles: ok &= d1 <= best[n, j1] + 1e-12f (an f32 add), best[n, j] =
//          the least d1 over the ok rows with j1 == j.
// Every d2 is __fadd_rn(__fmul_rn(dx,dx), __fmul_rn(dy,dy)) and the
// library is built with --fmad=false, so d1, q1, q2 and ok equal the plain
// PyTorch version (separate ops, no contraction) bit for bit.
//
// What bounds it on this card: N*B*B' d2 evaluations (1.2 M per pair at
// 1081 beams, 67 M for 256 pairs of 512), a few flops each and all from
// shared memory.  At N = 1, the odometry's shape, the work is ~40 blocks
// and the kernel is bound by latency: the staging of ref into shared
// memory, a 34-step strided loop per lane and a 5-step shuffle reduction.
//
// Design: pass 1 runs a (source tiles, N) grid; a block stages pair n's
// ref x, y and valid bytes in shared memory (9 bytes a point: 9.7 KB at
// B' = 1081) and each warp takes one source row at a time.  Lanes stride
// over j keeping (d2, j) with a strict less-than, so each lane holds its
// lowest-index minimum; a butterfly shuffle then takes the lexicographic
// minimum, so the lowest index wins a tie.  Lane 0 reads j1 +- 1 from
// shared memory and writes the row.  With doubles it atomicMin's the int
// bits of d1 into best[n, j1]: for non-negative floats the bits order as
// the values, so the minimum is exact in any order.  Pass 2 re-reads
// best and gates ok.  The TPU kernel held a whole [B, B'] matrix in VMEM
// and took the doubles column-min in the same program; here the matrix
// is never stored.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerBlock = 32;  // source rows a block takes
constexpr float kBig = 1e9f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float sq_dist(float cx, float cy, float rx,
                                         float ry) {
  const float dx = __fsub_rn(cx, rx);
  const float dy = __fsub_rn(cy, ry);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

__global__ void __launch_bounds__(kThreads)
corr_rows_kernel(const float* __restrict__ cur, const uint8_t* __restrict__ sv,
                 const float* __restrict__ ref,
                 const uint8_t* __restrict__ rv, int b, int nr, float max_d2,
                 int line, int doubles, float* __restrict__ q1,
                 float* __restrict__ q2, float* __restrict__ d1,
                 uint8_t* __restrict__ ok, int* __restrict__ j1_out,
                 int* __restrict__ best) {
  extern __shared__ float smem[];
  float* rx = smem;
  float* ry = smem + nr;
  uint8_t* rvs = reinterpret_cast<uint8_t*>(smem + 2 * nr);

  const int n = blockIdx.y;
  const float* refn = ref + static_cast<size_t>(n) * nr * 2;
  const uint8_t* rvn = rv + static_cast<size_t>(n) * nr;
  for (int j = threadIdx.x; j < nr; j += kThreads) {
    rx[j] = refn[2 * j];
    ry[j] = refn[2 * j + 1];
    rvs[j] = rvn[j];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = warp; r < kRowsPerBlock; r += kWarps) {
    const int i = blockIdx.x * kRowsPerBlock + r;
    if (i >= b) break;  // uniform across the warp
    const size_t o = static_cast<size_t>(n) * b + i;
    const float cx = cur[2 * o];
    const float cy = cur[2 * o + 1];
    const bool s_ok = sv[o] != 0;

    float bd = __int_as_float(0x7f800000);  // +inf: above every d2
    int bj = INT_MAX;
    for (int j = lane; j < nr; j += 32) {
      const float d = (s_ok && rvs[j]) ? sq_dist(cx, cy, rx[j], ry[j]) : kBig;
      if (d < bd) {  // strict: the lane keeps its lowest index
        bd = d;
        bj = j;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(kFull, bd, off);
      const int oj = __shfl_xor_sync(kFull, bj, off);
      if (od < bd || (od == bd && oj < bj)) {
        bd = od;
        bj = oj;
      }
    }
    if (lane != 0) continue;

    const int j1 = bj;
    const float q1x = rx[j1];
    const float q1y = ry[j1];
    float q2x = q1x;
    float q2y = q1y;
    bool keep;
    if (line) {
      float d_r = kBig;
      float d_l = kBig;
      if (j1 + 1 < nr && s_ok && rvs[j1 + 1])
        d_r = sq_dist(cx, cy, rx[j1 + 1], ry[j1 + 1]);
      if (j1 >= 1 && s_ok && rvs[j1 - 1])
        d_l = sq_dist(cx, cy, rx[j1 - 1], ry[j1 - 1]);
      int j2 = d_r < d_l ? j1 + 1 : j1 - 1;
      j2 = min(max(j2, 0), nr - 1);
      q2x = rx[j2];
      q2y = ry[j2];
      keep = bd < kBig && fminf(d_r, d_l) < kBig && bd < max_d2;
    } else {
      keep = bd < kBig && bd < max_d2;
    }
    q1[2 * o] = q1x;
    q1[2 * o + 1] = q1y;
    q2[2 * o] = q2x;
    q2[2 * o + 1] = q2y;
    d1[o] = bd;
    ok[o] = keep;
    j1_out[o] = j1;
    if (doubles && keep)
      atomicMin(best + static_cast<size_t>(n) * nr + j1, __float_as_int(bd));
  }
}

__global__ void __launch_bounds__(kThreads)
doubles_kernel(const float* __restrict__ d1, const int* __restrict__ j1,
               const int* __restrict__ best, int total, int b, int nr,
               uint8_t* __restrict__ ok) {
  const int o = blockIdx.x * kThreads + threadIdx.x;
  if (o >= total || !ok[o]) return;
  const int n = o / b;
  const float bst = __int_as_float(best[static_cast<size_t>(n) * nr + j1[o]]);
  ok[o] = d1[o] <= __fadd_rn(bst, 1e-12f);
}

}  // namespace

extern "C" {

// q1, q2 [n, b, 2] f32, d1 [n, b] f32, ok [n, b] uint8 <- the
// correspondences of cur [n, b, 2] f32 / sv [n, b] uint8 against
// ref [n, nr, 2] f32 / rv [n, nr] uint8 (contract above).  j1 [n, b] int32
// is scratch; with doubles, best [n, nr] int32 must hold the bits of 1e9f.
// Returns cudaGetLastError() after the launches.
int tpuslam_plicp_corr(const void* cur, const void* sv, const void* ref,
                       const void* rv, int n, int b, int nr, float max_d2,
                       int line, int doubles, void* q1, void* q2, void* d1,
                       void* ok, void* j1, void* best, void* stream) {
  cudaGetLastError();  // clear a stale error so the return value is ours
  if (n <= 0 || b <= 0 || nr <= 0) return static_cast<int>(cudaGetLastError());
  // ref x, y and valid bytes: 9 bytes a point (the wrapper caps nr)
  const int smem = static_cast<int>(2 * nr * sizeof(float) + nr);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        corr_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((b + kRowsPerBlock - 1) / kRowsPerBlock, n);
  corr_rows_kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(cur), static_cast<const uint8_t*>(sv),
      static_cast<const float*>(ref), static_cast<const uint8_t*>(rv), b, nr,
      max_d2, line, doubles, static_cast<float*>(q1), static_cast<float*>(q2),
      static_cast<float*>(d1), static_cast<uint8_t*>(ok),
      static_cast<int*>(j1), static_cast<int*>(best));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !doubles) return static_cast<int>(e);
  const int total = n * b;
  doubles_kernel<<<(total + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const float*>(d1), static_cast<const int*>(j1),
      static_cast<const int*>(best), total, b, nr, static_cast<uint8_t*>(ok));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
