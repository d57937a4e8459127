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
// PyTorch version (separate ops, no contraction) bit for bit.  Coordinates
// are finite.
//
// What bounds it on this card: N*B*B' d2 evaluations, each 5 f32 ops
// (two differences, two squares, a sum) and the running minimum's share.
// At N = 1, the odometry's shape (1.2 M pairs at 1081 beams), a call is
// bound by latency: staging the ref, one pass over it, the doubles' column
// minimum and the gate.  Where the pairs alone fill the card (the
// benchmark's 16,384 pairs of 1081 beams, 1.9e11 d2 a call of 10 passes)
// it is bound by issue, one warp instruction a clock on each of an SM's
// four schedulers.  Two forms, the wrapper's choice by shape (no choice
// changes a result):
//
// The warp form (kWarp; where a pair needs several blocks to fill the
// card): G blocks a pair.  Each block stages the pair's ref in shared
// memory as float2, an invalid point as NaN (its d2 is NaN, which no
// strict less-than takes), and the lowest invalid index j_inv.  Block g
// takes the source rows [g*rows, (g+1)*rows); each warp holds R of them
// in registers (R = 1, 2 or 4: 1 where latency binds, 4 where issue
// does), so one shared load of a ref point serves R distances.  Lanes
// stride over j keeping (d2, j) with a strict less-than, each lane its
// lowest-index minimum of the valid points; a butterfly takes the
// lexicographic minimum, so the lowest index wins a tie.  About 9 issue
// slots a pair in the walk (5 for d2, a compare and two selects for the
// running (d, j) minimum, a shared load and the loop), and at 16,384
// pairs of 1081 beams 14.2 in all (PR 29's cell: the butterfly and the
// lane-select chain after every R rows, a ninth round of 128 rows in
// which 15 of 32 warps work, and a 1024-thread block alone on its SM,
// whose staging and gate nothing hides).
//
// The rows form (kRows; where launch_shape gives one block a pair): one
// block a pair, sized to its rows, and one source row a lane.  Lane l of
// warp w holds rows w*32R + 32k + l (k < R, R = 2) in registers; the warp
// walks the whole ref with j the same in every lane, reading two points
// a 16-byte shared load as a broadcast that serves 32R rows.  A lane
// keeps its rows' whole minimum, so there is no butterfly: per row, d2
// is fminf'ed into the minimum of a block of kRowsBlock consecutive j
// (fminf drops NaN, so an invalid point is never the minimum and a block
// of invalid points reads NaN), and each block's minimum takes the row's
// best by a strict less-than, which keeps the earliest block that
// reaches the least d2.  After the walk the lane recomputes that block's
// d2 (the same bits) and takes its lowest j equal to the best: the
// lowest-index minimum, as the warp form's.  The loop issues about 6.7
// slots a pair (5 for d2, one fminf, a shared load a 2R pairs, the
// block's compare and selects over kRowsBlock = 8, the loop); at 16,384
// pairs of 1081 beams the kernel spends 8.5 (4.87 ms a pass in line
// mode against the warp form's 8.09, on an H100 at 1,980 MHz: PERF.md).
// 17 warps of 64 rows cover 1081 rows with 99.4 % of the lanes working,
// and at 40 registers three such blocks share an SM, so one pair's
// staging and gate overlap another's walk.  (Blocks of 16 and 32 points
// ran 13 % and 12 % slower, of 4 and 2 points 20 % and 29 %; four rows a
// lane, at 79 registers, 1 %.)
//
// Both forms then bring the invalid points back as BIG: j_inv wins where
// the valid minimum is above BIG, or equal to it at a higher index.  An
// invalid source row reads BIG everywhere: (BIG, j = 0).  The lane that
// holds a row (the warp form: lane k of the warp, R rows at once)
// finishes it.
// Doubles: each block writes its rows with ok before the gate and j1 (-1
// where not ok) in a scratch array, fences, and takes a ticket from the
// pair's counter; the block that takes the last ticket (G - 1) reads the
// pair's rows from L2 (8 a thread at once), takes best[] as an atomicMin
// of d1's int bits in its shared memory (for non-negative floats the bits
// order as the values, so the minimum is exact in any order), gates every
// row and sets the counter back to 0.  A pair of one block (the rows
// form) takes no ticket.
// The counters' rule: they are 0 between launches on a stream, because
// each launch's last blocks reset them and launches on a stream run in
// order; the wrapper keeps one counter array a stream, zeroed once.
//
// Large references (kTiled, the wrapper's choice past 17,801 points, where
// a pair's ref and best[] no longer fit 227 KB of shared memory): the ref
// goes through shared memory in tiles of kTile points, and each warp keeps
// exactly one group of R rows (the wrapper's blocks see to it), whose
// per-lane (d2, j) minima run on across the tiles.  kTile is a multiple of
// 32, so lane l still meets j = l, l + 32, ... in order: the lanes' minima,
// the butterfly and so every result are those of the warp form.  The
// lowest invalid index is the least over the tiles; q1, q2 and the line
// mode's neighbours are read from global memory (L2), and the doubles'
// best[] is a global [N, B'] scratch that the pair's last block fills with
// BIG before its atomicMin.  Pairs past the grid's 65,535 go to further
// launches on the same stream (the wrapper's chunks), each on its own
// slice of every array.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

// the kernel's forms: the wrapper's `form` argument
enum Form : int { kWarp = 0, kTiled = 1, kRows = 2 };

constexpr int kMaxThreads = 1024;
// a Hopper block's shared memory (232,448 bytes) less 1 KB for the static
// variables and what the system reserves
constexpr int kMaxSmem = 232448 - 1024;
constexpr float kBig = 1e9f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTile = 4096;  // ref points a tile (kTiled): 36 KB staged
// the rows form: consecutive j a block of the running minimum (even: two
// points a shared load), the most warps a block, and the blocks an SM
// that its registers must allow
constexpr int kRowsBlock = 8;
constexpr int kRowsWarps = 24;
constexpr int kRowsMinBlocks = 2;

__device__ __forceinline__ float sq_dist(float cx, float cy, float rx,
                                         float ry) {
  const float dx = __fsub_rn(cx, rx);
  const float dy = __fsub_rn(cy, ry);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

// Shared memory a block: ref as float2, best[] (doubles: used by a pair's
// last block only), the ref's valid bytes.
inline int smem_bytes(int nr, int doubles) {
  return nr * 8 + (doubles ? nr * 4 : 0) + nr;
}

// Shared memory a block of the tiled form: one tile of ref as float2 and
// its valid bytes.
inline int tiled_smem_bytes() { return kTile * 8 + kTile; }

// R source rows against the ref points [0, tn) of shared memory (a tile
// whose first point is j0): each lane's lowest-index minimum over its j.
template <int R>
__device__ __forceinline__ void lane_min(const float2* rxy, int tn, int j0,
                                         int lane, const float (&cx)[R],
                                         const float (&cy)[R], float (&bd)[R],
                                         int (&bj)[R]) {
  for (int j = lane; j < tn; j += 32) {
    const float2 r = rxy[j];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const float d = sq_dist(cx[k], cy[k], r.x, r.y);
      if (d < bd[k]) {  // strict: the lane keeps its lowest index
        bd[k] = d;
        bj[k] = j0 + j;
      }
    }
  }
}

// The lexicographic (d, j) minimum over the warp's lanes, in every lane.
template <int R>
__device__ __forceinline__ void butterfly(float (&bd)[R], int (&bj)[R]) {
#pragma unroll
  for (int k = 0; k < R; ++k) {
    for (int off = 16; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(kFull, bd[k], off);
      const int oj = __shfl_xor_sync(kFull, bj[k], off);
      if (od < bd[k] || (od == bd[k] && oj < bj[k])) {
        bd[k] = od;
        bj[k] = oj;
      }
    }
  }
}

// The rows form's walk: the lane's R rows against all nr ref points of
// shared memory (rxy 16-byte aligned), the same j in every lane.  Each
// row's (bd, bj) leaves as the warp form's lanes and butterfly leave it:
// the least d2 of the valid points and its lowest j, or (+inf, INT_MAX)
// where no valid d2 is below +inf.
template <int R>
__device__ __forceinline__ void rows_min(const float2* rxy, int nr,
                                         const float (&cx)[R],
                                         const float (&cy)[R],
                                         float (&bd)[R], int (&bj)[R]) {
  constexpr int J = kRowsBlock;
  const float4* r4 = reinterpret_cast<const float4*>(rxy);
  int bb[R];  // the first j of the block that holds the row's best
#pragma unroll
  for (int k = 0; k < R; ++k) bb[k] = -1;
  const int full = nr - nr % J;
  for (int j0 = 0; j0 < full; j0 += J) {
    float m[R];
#pragma unroll
    for (int u = 0; u < J; u += 2) {
      const float4 p = r4[(j0 + u) >> 1];  // points j0 + u and j0 + u + 1
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const float d = fminf(sq_dist(cx[k], cy[k], p.x, p.y),
                              sq_dist(cx[k], cy[k], p.z, p.w));
        m[k] = u == 0 ? d : fminf(m[k], d);
      }
    }
#pragma unroll
    for (int k = 0; k < R; ++k) {
      if (m[k] < bd[k]) {  // strict: the earliest block keeps the best
        bd[k] = m[k];
        bb[k] = j0;
      }
    }
  }
  if (full < nr) {  // the last nr % J points: a block of their own
    float m[R];
#pragma unroll
    for (int k = 0; k < R; ++k) m[k] = __int_as_float(0x7fc00000);
    for (int j = full; j < nr; ++j) {
      const float2 p = rxy[j];
#pragma unroll
      for (int k = 0; k < R; ++k)
        m[k] = fminf(m[k], sq_dist(cx[k], cy[k], p.x, p.y));
    }
#pragma unroll
    for (int k = 0; k < R; ++k) {
      if (m[k] < bd[k]) {
        bd[k] = m[k];
        bb[k] = full;
      }
    }
  }
  // the lowest j of the winning block whose d2 (the same bits) is the best
#pragma unroll
  for (int k = 0; k < R; ++k) {
    int j1 = INT_MAX;
    if (bb[k] >= 0) {
#pragma unroll
      for (int u = J - 1; u >= 0; --u) {
        const int j = bb[k] + u;
        if (j < nr) {
          const float2 p = rxy[j];
          if (sq_dist(cx[k], cy[k], p.x, p.y) == bd[k]) j1 = j;
        }
      }
    }
    bj[k] = j1;
  }
}

// The pair's ref as the row's finish reads it: from shared memory, where
// an invalid point is NaN (the warp and rows forms), or from global
// memory.
template <bool kGlobal>
struct RefView {
  const float2* rxy;    // shared: the whole ref
  const uint8_t* rvs;
  const float2* refn;   // global: the pair's ref and its valid bytes
  const uint8_t* rvn;
  __device__ bool valid(int j) const { return kGlobal ? rvn[j] : rvs[j]; }
  // the stored point, valid or not
  __device__ float2 point(int j) const {
    return kGlobal ? refn[j] : (rvs[j] ? rxy[j] : refn[j]);
  }
  // a point known to be valid
  __device__ float2 valid_point(int j) const {
    return kGlobal ? refn[j] : rxy[j];
  }
};

// Row i's finish from its least valid d2 `dk` at `j1` (source point (x, y),
// valid `src`): the invalid points as BIG, q1, q2 (line mode), d1, ok
// before the doubles' gate.
template <bool kGlobal>
__device__ __forceinline__ void finish_row(
    const RefView<kGlobal>& ref, int i, size_t pair, int nr, int jinv,
    float max_d2, int line, int doubles, float dk, int j1, float x, float y,
    bool src, float2* __restrict__ q1, float2* __restrict__ q2,
    float* __restrict__ d1, uint8_t* __restrict__ ok,
    int* __restrict__ j1s) {
  // the invalid ref points read BIG: the lowest of them wins unless a
  // valid d2 is below BIG, or equals it at a lower index
  if (jinv < nr && (dk > kBig || (dk == kBig && jinv < j1))) {
    dk = kBig;
    j1 = jinv;
  }
  if (!src) {  // every pair reads BIG: the lowest index
    dk = kBig;
    j1 = 0;
  }
  j1 = min(j1, nr - 1);  // in bounds even for non-finite input
  const size_t o = pair + i;
  const float2 p1 = ref.point(j1);
  float2 p2 = p1;
  bool keep;
  if (line) {
    float d_r = kBig;
    float d_l = kBig;
    if (src && j1 + 1 < nr && ref.valid(j1 + 1)) {
      const float2 r = ref.valid_point(j1 + 1);
      d_r = sq_dist(x, y, r.x, r.y);
    }
    if (src && j1 >= 1 && ref.valid(j1 - 1)) {
      const float2 l = ref.valid_point(j1 - 1);
      d_l = sq_dist(x, y, l.x, l.y);
    }
    int j2 = d_r < d_l ? j1 + 1 : j1 - 1;
    j2 = min(max(j2, 0), nr - 1);
    p2 = ref.point(j2);
    keep = dk < kBig && fminf(d_r, d_l) < kBig && dk < max_d2;
  } else {
    keep = dk < kBig && dk < max_d2;
  }
  q1[o] = p1;
  q2[o] = p2;
  d1[o] = dk;
  ok[o] = keep;  // before the doubles' gate
  if (doubles) j1s[o] = keep ? j1 : -1;
}

// Lane `lane` (< R) of a warp form's warp finishes row i, the warp's row
// `lane`: its values picked from the warp's R minima by a select chain
// (registers take no dynamic index).
template <int R, bool kGlobal>
__device__ __forceinline__ void finish_warp_row(
    const RefView<kGlobal>& ref, int lane, int i, size_t pair, int nr,
    int jinv, float max_d2, int line, int doubles, const float (&bd)[R],
    const int (&bj)[R], const float (&cx)[R], const float (&cy)[R],
    const bool (&s_ok)[R], float2* __restrict__ q1,
    float2* __restrict__ q2, float* __restrict__ d1,
    uint8_t* __restrict__ ok, int* __restrict__ j1s) {
  float dk = bd[0], x = cx[0], y = cy[0];
  int j1 = bj[0];
  bool src = s_ok[0];
#pragma unroll
  for (int k = 1; k < R; ++k) {
    if (lane == k) {
      dk = bd[k];
      j1 = bj[k];
      x = cx[k];
      y = cy[k];
      src = s_ok[k];
    }
  }
  finish_row<kGlobal>(ref, i, pair, nr, jinv, max_d2, line, doubles, dk, j1,
                      x, y, src, q1, q2, d1, ok, j1s);
}

template <int R, int kForm>
__global__ void __launch_bounds__(kForm == kRows ? 32 * kRowsWarps
                                                 : kMaxThreads,
                                  kForm == kRows ? kRowsMinBlocks : 1)
plicp_corr_kernel(const float2* __restrict__ cur,
                  const uint8_t* __restrict__ sv,
                  const float2* __restrict__ ref,
                  const uint8_t* __restrict__ rv, int b, int nr, int rows,
                  float max_d2, int line, int doubles,
                  float2* __restrict__ q1, float2* __restrict__ q2,
                  float* __restrict__ d1, uint8_t* __restrict__ ok,
                  int* __restrict__ j1s, unsigned* __restrict__ tickets,
                  int* __restrict__ best_g) {
  constexpr bool kTiledForm = kForm == kTiled;
  extern __shared__ __align__(16) float2 smem[];
  float2* rxy = smem;
  // warp and rows forms: best[] after the ref (the tiled form's is best_g)
  int* best = reinterpret_cast<int*>(rxy + (kTiledForm ? kTile : nr));
  uint8_t* rvs = reinterpret_cast<uint8_t*>(
      best + (!kTiledForm && doubles ? nr : 0));
  __shared__ int s_jinv;
  __shared__ bool s_last;

  const int n = blockIdx.y;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const float2* refn = ref + static_cast<size_t>(n) * nr;
  const uint8_t* rvn = rv + static_cast<size_t>(n) * nr;

  if (tid == 0) s_jinv = nr;  // nr: every ref point valid
  if (!kTiledForm && doubles)  // read by the pair's last block only
    for (int j = tid; j < nr; j += nthreads) best[j] = __float_as_int(kBig);
  __syncthreads();
  int jinv = nr;
  // stage the ref points [j_lo, j_lo + tn) at rxy[0, tn), an invalid one as
  // NaN; jinv keeps this thread's lowest invalid index
  auto stage = [&](int j_lo, int tn) {
    constexpr int kStage = 4;  // points a thread loads at once
    for (int j0 = tid; j0 < tn; j0 += kStage * nthreads) {
      float2 p[kStage];
      bool v[kStage];
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        const int j = j0 + u * nthreads;
        v[u] = j < tn && rvn[j_lo + j];
        p[u] = j < tn ? refn[j_lo + j] : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        const int j = j0 + u * nthreads;
        if (j >= tn) break;
        rvs[j] = v[u];
        rxy[j] = v[u] ? p[u] : make_float2(__int_as_float(0x7fc00000),
                                           __int_as_float(0x7fc00000));
        if (!v[u] && jinv == nr) jinv = j_lo + j;  // this thread's lowest
      }
    }
  };

  const int warp = tid / 32;
  const int lane = tid % 32;
  const int r0 = blockIdx.x * rows;
  const int r1 = min(b, r0 + rows);
  const size_t pair = static_cast<size_t>(n) * b;
  // R rows base, base + step, ... into registers (a row past r1 repeats
  // the last)
  auto load_rows = [&](int base, int step, float (&cx)[R], float (&cy)[R],
                       bool (&s_ok)[R], float (&bd)[R], int (&bj)[R]) {
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const size_t o = pair + min(base + k * step, r1 - 1);
      const float2 c = cur[o];
      cx[k] = c.x;
      cy[k] = c.y;
      s_ok[k] = sv[o] != 0;
      bd[k] = __int_as_float(0x7f800000);  // +inf: above every finite d2
      bj[k] = INT_MAX;
    }
  };

  if constexpr (kForm == kWarp) {
    stage(0, nr);
    if (jinv < nr) atomicMin(&s_jinv, jinv);
    __syncthreads();
    jinv = s_jinv;
    const RefView<false> view{rxy, rvs, refn, rvn};
    for (int base = r0 + warp * R; base < r1; base += (nthreads / 32) * R) {
      float cx[R], cy[R], bd[R];
      int bj[R];
      bool s_ok[R];
      load_rows(base, 1, cx, cy, s_ok, bd, bj);
      lane_min<R>(rxy, nr, 0, lane, cx, cy, bd, bj);
      butterfly<R>(bd, bj);
      const int i = base + lane;
      if (lane >= R || i >= r1) continue;
      finish_warp_row<R, false>(view, lane, i, pair, nr, jinv, max_d2, line,
                                doubles, bd, bj, cx, cy, s_ok, q1, q2, d1,
                                ok, j1s);
    }
  } else if constexpr (kForm == kRows) {
    // one block a pair (r0 = 0, r1 = b): lane l of warp w holds the rows
    // base + 32k + l, base = w * 32R, then on by the block's 32R rows a
    // warp
    stage(0, nr);
    if (jinv < nr) atomicMin(&s_jinv, jinv);
    __syncthreads();
    jinv = s_jinv;
    const RefView<false> view{rxy, rvs, refn, rvn};
    for (int base = warp * 32 * R; base < r1;
         base += (nthreads / 32) * 32 * R) {
      float cx[R], cy[R], bd[R];
      int bj[R];
      bool s_ok[R];
      load_rows(base + lane, 32, cx, cy, s_ok, bd, bj);
      rows_min<R>(rxy, nr, cx, cy, bd, bj);
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const int i = base + 32 * k + lane;
        if (i < r1)
          finish_row<false>(view, i, pair, nr, jinv, max_d2, line, doubles,
                            bd[k], bj[k], cx[k], cy[k], s_ok[k], q1, q2, d1,
                            ok, j1s);
      }
    }
  } else {
    // one group of R rows a warp; a warp without rows still stages tiles
    // and meets every barrier
    const int base = r0 + warp * R;
    float cx[R], cy[R], bd[R];
    int bj[R];
    bool s_ok[R];
    load_rows(base, 1, cx, cy, s_ok, bd, bj);
    for (int t0 = 0; t0 < nr; t0 += kTile) {
      const int tn = min(kTile, nr - t0);
      __syncthreads();  // the previous tile is consumed
      stage(t0, tn);
      __syncthreads();
      if (base < r1) lane_min<R>(rxy, tn, t0, lane, cx, cy, bd, bj);
    }
    if (jinv < nr) atomicMin(&s_jinv, jinv);
    __syncthreads();
    jinv = s_jinv;
    butterfly<R>(bd, bj);
    const int i = base + lane;
    if (base < r1 && lane < R && i < r1) {
      const RefView<true> view{rxy, rvs, refn, rvn};
      finish_warp_row<R, true>(view, lane, i, pair, nr, jinv, max_d2, line,
                               doubles, bd, bj, cx, cy, s_ok, q1, q2, d1, ok,
                               j1s);
    }
  }
  if (!doubles) return;

  // the pair's last block gates its rows (a pair of one block: no ticket)
  const bool solo = gridDim.x == 1;
  if (!solo) __threadfence();  // this thread's rows reach L2 first
  __syncthreads();
  if (!solo) {
    if (tid == 0) {
      __threadfence();
      s_last = atomicAdd(tickets + n, 1u) == gridDim.x - 1;
    }
    __syncthreads();
    if (!s_last) return;
    __threadfence();
  }
  if constexpr (kTiledForm) {  // the pair's best[] in global memory
    best = best_g + static_cast<size_t>(n) * nr;
    for (int j = tid; j < nr; j += nthreads) best[j] = __float_as_int(kBig);
    __syncthreads();
  }
  // each thread reads kGate rows at once (from L2 where other blocks
  // wrote them), j1 = -1 where a row is not ok; with the pair's rows in
  // one round (b <= kGate * threads, the wrapper's shapes) the gate reuses
  // the registers, else it reads them again
  constexpr int kGate = 8;
  int jg[kGate];
  float dg[kGate];
  const bool one_round = b <= kGate * nthreads;
  auto read = [&](int i0) {
#pragma unroll
    for (int u = 0; u < kGate; ++u) {
      const int i = i0 + u * nthreads;
      const size_t o = pair + min(i, b - 1);
      const int j = solo ? j1s[o] : __ldcg(j1s + o);
      const float d = solo ? d1[o] : __ldcg(d1 + o);
      jg[u] = i < b ? j : -1;
      dg[u] = d;
    }
  };
  for (int i0 = tid; i0 < b; i0 += kGate * nthreads) {
    read(i0);
#pragma unroll
    for (int u = 0; u < kGate; ++u)
      if (jg[u] >= 0) atomicMin(best + jg[u], __float_as_int(dg[u]));
  }
  __syncthreads();
  for (int i0 = tid; i0 < b; i0 += kGate * nthreads) {
    if (!one_round) read(i0);
#pragma unroll
    for (int u = 0; u < kGate; ++u)
      if (jg[u] >= 0)
        ok[pair + i0 + u * nthreads] =
            dg[u] <= __fadd_rn(__int_as_float(kTiledForm
                                                  ? __ldcg(best + jg[u])
                                                  : best[jg[u]]),
                               1e-12f);
  }
  if (tid == 0 && !solo) tickets[n] = 0;  // the next launch finds 0
}

template <int R, int kForm>
cudaError_t launch(dim3 grid, int threads, int smem, cudaStream_t s,
                   const float2* cur, const uint8_t* sv, const float2* ref,
                   const uint8_t* rv, int b, int nr, int rows, float max_d2,
                   int line, int doubles, float2* q1, float2* q2, float* d1,
                   uint8_t* ok, int* j1s, unsigned* tickets, int* best) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        plicp_corr_kernel<R, kForm>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  plicp_corr_kernel<R, kForm><<<grid, threads, smem, s>>>(
      cur, sv, ref, rv, b, nr, rows, max_d2, line, doubles, q1, q2, d1, ok,
      j1s, tickets, best);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q1, q2 [n, b, 2] f32, d1 [n, b] f32, ok [n, b] uint8 <- the
// correspondences of cur [n, b, 2] f32 / sv [n, b] uint8 against
// ref [n, nr, 2] f32 / rv [n, nr] uint8 (contract above), in one launch
// of `form` (kWarp, kTiled or kRows above) with `blocks` blocks a pair
// holding `rows_per_warp` source rows a warp: 1, 2 or 4 (kWarp, kTiled),
// 64 (kRows, one block a pair: two rows a lane); n <= 65,535 (the grid's
// y).  With doubles: j1s [n, b] int32 is scratch and, where blocks > 1,
// tickets [n] uint32 must hold 0 (the launch leaves it so).  kTiled: the
// ref goes through shared memory in tiles, a warp must hold all its
// block's rows (rows <= 32 * rows_per_warp) and, with doubles, best [n,
// nr] int32 is scratch; else the pair's ref (and best[]) must fit a
// block's shared memory.  Returns cudaGetLastError() after the launch.
int tpuslam_plicp_corr(const void* cur, const void* sv, const void* ref,
                       const void* rv, int n, int b, int nr, float max_d2,
                       int line, int doubles, int blocks, int rows_per_warp,
                       int form, void* q1, void* q2, void* d1, void* ok,
                       void* j1s, void* tickets, void* best, void* stream) {
  cudaGetLastError();  // clear a stale error so the return value is ours
  if (n <= 0 || b <= 0 || nr <= 0) return static_cast<int>(cudaGetLastError());
  const int r = rows_per_warp;
  const bool rows_form = form == kRows;
  if (form < kWarp || form > kRows || n > 65535 ||
      (rows_form ? blocks != 1 || r != 64
                 : blocks < 1 || (r != 1 && r != 2 && r != 4)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = (b + blocks - 1) / blocks;
  const int g = (b + rows - 1) / rows;  // no block without rows
  const int warps = min((rows + r - 1) / r,
                        rows_form ? kRowsWarps : kMaxThreads / 32);
  const bool tiled = form == kTiled;
  const int smem = tiled ? tiled_smem_bytes() : smem_bytes(nr, doubles);
  if (smem > kMaxSmem || (tiled && rows > 32 * r))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(g, n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto args = [&](auto launch_r) {
    return launch_r(grid, 32 * warps, smem, s,
                    static_cast<const float2*>(cur),
                    static_cast<const uint8_t*>(sv),
                    static_cast<const float2*>(ref),
                    static_cast<const uint8_t*>(rv), b, nr, rows, max_d2,
                    line, doubles, static_cast<float2*>(q1),
                    static_cast<float2*>(q2), static_cast<float*>(d1),
                    static_cast<uint8_t*>(ok), static_cast<int*>(j1s),
                    static_cast<unsigned*>(tickets), static_cast<int*>(best));
  };
  cudaError_t e;
  if (rows_form) {
    e = args(launch<2, kRows>);
  } else if (tiled) {
    e = r == 1   ? args(launch<1, kTiled>)
        : r == 2 ? args(launch<2, kTiled>)
                 : args(launch<4, kTiled>);
  } else {
    e = r == 1   ? args(launch<1, kWarp>)
        : r == 2 ? args(launch<2, kWarp>)
                 : args(launch<4, kWarp>);
  }
  return static_cast<int>(e);
}

}  // extern "C"
