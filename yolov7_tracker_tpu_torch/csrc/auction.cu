// Private-dummy rectangular auction (K2) for Hopper, sm_90a, and its XLA
// twin's form (K4, at the end of the file).
//
// Replaces the Pallas TPU kernel _auction_phase_kernel_v2 /
// masked_assignment_pallas_v2 (yolov7_tracker_tpu/ops/pallas_auction.py,
// pallas_call at :412). Same function: for each problem, the max-weight
// free-disposal matching of w(i,j) = thresh - cost(i,j) (+ the
// deterministic 1e-6 jitter), each row i owning a private weight-0 dummy
// column m+i, solved by an eps-scaled Jacobi auction whose every sweep is
// a clamp-and-release step fused with one bid round, gated on output by
// cost <= thresh. The plain PyTorch version beside it
// (ops/auction.py: masked_assignment_auction_torch) computes the same
// bits: every step is a max, a min, a compare or one rounded add, and the
// adds are written with __fadd_rn/__fsub_rn/__fmul_rn (plus -fmad=false)
// so no multiply-add is contracted. r2c, c2r and the number of sweeps of
// every problem are the plain version's.
//
// What bounds it on the card: not bytes (one 150 KB cost matrix in at the
// tracker's 128 x 300, two index vectors out) and not arithmetic, but
// latency: the chain of dependent sweeps -- each must see the prices and
// the matching the one before it left, and inside a sweep a row's scan,
// reduce and bid are a chain of about a thousand cycles that nothing
// overlaps -- and then, for the solves of two sweeps (ByteTrack's stages 2
// and 3), the launch and the staging of the weights, which one SM pulls
// from L2 no faster than it does. The TPU kernel's sweep is dense: every
// row scans all m + n columns twice, once for the release test and once
// for its bid, and the matching is rebuilt and compared by block-wide
// passes. The design shortens the chain and does not carry the dense sweep
// over:
//   * a row scans its m real columns and its own dummy, not m + n. The
//     other rows' dummies hold -1e9 - price <= -1e9 (prices never fall
//     under 0), so they are never a row's best (its own dummy is worth
//     -price > -1e9) and enter its second-best value only through
//     fmaxf(v2, -1e9), which the plain version applies as well. The own
//     dummy is merged last: it is the highest column, so on a tie the real
//     column stays the first maximum. The TPU kernel's padding to 128
//     rows and lanes is dropped: a padding row takes its own dummy in the
//     first sweep and keeps it;
//   * only what a sweep can change is looked at. Rounded subtraction is
//     monotone, so the release test cur >= max_j(v_j) - eps holds exactly
//     when cur >= v_j - eps holds for every column j. A row that kept its
//     column and passed in the sweep before can only fail on a column
//     whose price fell since, and the only prices that fall are those of
//     the columns that sweep's release freed (a won column's price rises).
//     So the rows that kept their column test the freed columns alone, a
//     lane a row (mostly there is one such column, or none). A row that
//     won its column in the sweep before keeps the second-best value b2
//     of its bid: prices have only risen since, so it passes without a
//     scan if cur >= b2 - eps, and is scanned whole otherwise; so is every
//     assigned row in a phase's first sweep (new eps). A masked-out row is
//     never staged or scanned: it bids once, for its own dummy against
//     -1e9, and keeps it (ByteTrack's stages 2 and 3 mask out every track
//     that stage 1 matched). The first clamp of a sweep is a no-op (a
//     column is unowned only from a release, which zeroes its price at
//     once) and is not run;
//   * the bidders are never searched for: those of sweep k + 1 are the
//     losers of sweep k, the rows it evicted and the rows the release of
//     sweep k + 1 frees, handed on in a list;
//   * while a sweep scans few rows a whole warp scans one (the shortest
//     chain); while it scans many (the first sweeps of a phase), 8 lanes
//     scan a row, four rows a warp side by side, because a warp cannot
//     overlap one row's chain with the next one's. The weights are staged
//     in shared memory when they fit (128 x 300 f32 = 150 KB does), with
//     16-byte loads of the cost rows and the jitter from a 5 KB table, and
//     a lane then takes four columns a 16-byte load, two loads in flight;
//     otherwise (256 x 300) they are recomputed from the cost matrix and
//     the masks, read through L2, a column a load. A lane keeps its top
//     two without a branch; a warp's come from three redux.sync on the
//     floats' order-preserving integer images, 8 lanes' from a butterfly
//     of shuffles: both exact, since (value, lowest column) is a total
//     order;
//   * a column's winner -- highest bid, lowest row on a tie -- is one
//     64-bit atomicMax in shared memory on (bid, ~row); the winner evicts
//     the owner and keeps c2r and r2c up to date (no rebuild). No pass
//     clears the keys: a winner's is cleared one sweep late, in the other
//     of two key arrays taken in turn, when no bidder reads it any more;
//   * a phase ends at the first sweep that leaves (r2c, c2r, prices)
//     bit-identical, told from what the sweep touched: every winner took
//     back the column it was released from in this sweep at the same
//     price bits, and as many rows won as were released. (The fused
//     release re-frees a row whose eps-CS test fails by one rounding and
//     its rebid restores the same state, so the TPU kernel repeats that
//     sweep unchanged up to max_iters times; stopping gives the same
//     result without the repeats.)
//   * all phases and sweeps of a problem run in ONE launch, one thread
//     block per problem, B problems per launch (ByteTrack's stage-2/3
//     pair is B = 2, a serving tick of S streams B = 2 S); one kernel for
//     each way of holding the weights, so that each has the registers it
//     needs and none spills.
// A sweep is: release tests, barrier, free the released (and a barrier, if
// any), bids, barrier, awards, barrier.

#include <cuda_runtime.h>
#include <climits>
#include <math.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr float NEG_F = -1e9f;
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
// the incremental release test: groups of 32 rows tested side by side, each
// by WARPS / ROW_GROUPS warps
constexpr int ROW_GROUPS = 4;
constexpr unsigned FULL = 0xffffffffu;
// f32 constants rounded from double, as the JAX weak-typed ones are
constexpr float JIT_UNIT = (float)(1e-6 / 17.0);
constexpr float EPS_FLOOR = (float)2e-4;
constexpr int MAX_PHASES = 8;
// a block's shared memory, less room for the static counters
constexpr size_t SMEM_LIMIT = 232448 - 256;

// Parts of a solve whose clock cycles the profiling build (-DAUCTION_PROFILE)
// sums on lane 0 of every warp, into (B, PROFILE_WARPS, P_SLOTS); the names
// are PROFILE_PARTS below, in this order. The last two are counts of row
// scans by this warp, not cycles.
enum {
  P_STAGE, P_RELEASE, P_BAR_RELEASE, P_FREE, P_BID, P_BAR_BID, P_AWARD,
  P_BAR_AWARD, P_GATE, P_N_RELEASE_SCANS, P_N_BID_SCANS, P_SLOTS
};
constexpr int PROFILE_WARPS = 32;
const char* const PROFILE_PARTS =
    "stage,release tests,release barrier,free + barrier,bid scans,"
    "bid barrier,award,award barrier,gate,release scan count,"
    "bid scan count";

#ifdef AUCTION_PROFILE
#define PROF(slot)                                  \
  do {                                              \
    if (lane == 0) {                                \
      const unsigned prof_t = (unsigned)clock64();  \
      prof[slot] += prof_t - prof_last;             \
      prof_last = prof_t;                           \
    }                                               \
  } while (0)
#define PROF_COUNT(slot, n) \
  do {                      \
    prof[slot] += (n);      \
  } while (0)
#else
#define PROF(slot) \
  do {             \
  } while (0)
#define PROF_COUNT(slot, n) \
  do {                      \
  } while (0)
#endif

// phase_factor ** (1 .. n_phases) in float32, computed by the wrapper
struct Powers {
  float v[MAX_PHASES];
};

// How a block holds the real weights w(i, j < m): recomputed from the cost
// matrix through L2, staged in shared memory, or staged with every row
// 16-byte aligned (m a multiple of 4, the cost matrix 16-byte aligned), so
// that a lane scans four columns a load.
enum { MODE_GLOBAL = 0, MODE_STAGED = 1, MODE_VEC = 2 };

// The jitter table of MODE_VEC. jitter(i, j) = J((131 i + 7 j) mod 17)
// = U(j + s_i) with U(x) = J(7 x mod 17) and s_i = 5 (131 i mod 17) mod 17
// (7 * 5 = 1 mod 17): a row's jitter is a window of U. The table holds the
// four shifts U(x + c), c < 4, so that every window starts 16-byte aligned.
__host__ __device__ inline int jit_len(int m) { return m + 16; }

// Byte offsets of a block's arrays in dynamic shared memory, each a
// multiple of 16.
struct Layout {
  size_t ws, jit, cmask, rmask, prices, key0, key1, c2r, r2c, bids, won,
      list0, list1, rel_row, rel_col0, rel_col1, won_at, rel_at, old_col,
      old_price, failed, total;
};

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~(size_t)15;
}

__host__ __device__ inline Layout smem_layout(int n, int m, int mode) {
  const size_t mt = (size_t)n + m;
  const size_t rows = align16((size_t)n * 4);
  Layout l;
  l.ws = 0;
  l.jit = align16(mode != MODE_GLOBAL ? (size_t)n * m * 4 : 0);
  l.cmask = align16(l.jit +
                    (mode == MODE_VEC ? (size_t)jit_len(m) * 16 : 0));
  l.rmask = align16(l.cmask + (mode == MODE_VEC ? (size_t)m : 0));
  l.prices = align16(l.rmask + (size_t)n);
  l.key0 = align16(l.prices + mt * 4);
  l.key1 = align16(l.key0 + mt * 8);
  l.c2r = align16(l.key1 + mt * 8);
  l.r2c = align16(l.c2r + mt * 4);
  l.bids = l.r2c + rows;
  l.won = l.bids + 4 * rows;
  l.list0 = l.won + 4 * rows;
  l.list1 = l.list0 + rows;
  l.rel_row = l.list1 + rows;
  l.rel_col0 = l.rel_row + rows;
  l.rel_col1 = l.rel_col0 + rows;
  l.won_at = l.rel_col1 + rows;
  l.rel_at = l.won_at + rows;
  l.old_col = l.rel_at + rows;
  l.old_price = l.old_col + rows;
  l.failed = l.old_price + rows;
  l.total = l.failed + rows;
  return l;
}

struct Problem {
  const float* cost;              // (N, M) row-major
  const unsigned char* row_mask;  // (N,)
  const unsigned char* col_mask;  // (M,)
  const float* ws;                // (N, M) staged weights, or null
  float thresh;
  int n, m;
};

// J(k), k = (131 i + 7 j) mod 17, which is exact in f32 as in the TPU form;
// the product is one rounded multiply
__device__ __forceinline__ float jitter(int k) {
  return __fmul_rn((float)k, JIT_UNIT);
}

// real weight w(i, j < m), from the cost matrix
__device__ __forceinline__ float real_weight(const Problem& p, int i, int j) {
  if (!(p.row_mask[i] && p.col_mask[j])) return NEG_F;
  return __fadd_rn(__fsub_rn(p.thresh, p.cost[(int64_t)i * p.m + j]),
                   jitter((i * 131 + j * 7) % 17));
}

template <int MODE>
__device__ __forceinline__ float weight(const Problem& p, int i, int j) {
  return MODE == MODE_GLOBAL ? real_weight(p, i, j) : p.ws[i * p.m + j];
}

// What row i gets from the column rc it holds, a real column or its own
// dummy m + i (weight 0), as the release test sees it.
template <int MODE>
__device__ __forceinline__ float held_value(const Problem& p,
                                            const float* prices, int i,
                                            int rc) {
  const float w = rc < p.m ? weight<MODE>(p, i, rc) : 0.0f;
  return fmaxf(__fsub_rn(w, prices[rc]), NEG_F);
}

// Order-preserving image of a float (no NaN) in the signed integers; the
// same function maps it back. -0.0 and +0.0 have different images: callers
// add +0.0 first.
__device__ __forceinline__ int float_image(float f) {
  const int u = __float_as_int(f);
  return u ^ ((u >> 31) & 0x7fffffff);
}

__device__ __forceinline__ float image_float(int i) {
  return __int_as_float(i ^ ((i >> 31) & 0x7fffffff));
}

// A lane's running top two, without a branch. Every lane meets its columns
// in rising order, so a later column never displaces an equal earlier one:
// the first maximal column stays the best, and a duplicate of the best
// value becomes the second-best value (min(b1, v) is the loser of the two).
__device__ __forceinline__ void consider(float v, int col, float& b1,
                                         int& bi, float& b2) {
  b2 = fmaxf(b2, fminf(b1, v));
  bi = v > b1 ? col : bi;
  b1 = fmaxf(b1, v);
}

// four neighbouring columns, weights w at prices pr
__device__ __forceinline__ void consider4(const float4& w, const float4& pr,
                                          int col, float& b1, int& bi,
                                          float& b2) {
  consider(__fsub_rn(w.x, pr.x), col, b1, bi, b2);
  consider(__fsub_rn(w.y, pr.y), col + 1, b1, bi, b2);
  consider(__fsub_rn(w.z, pr.z), col + 2, b1, bi, b2);
  consider(__fsub_rn(w.w, pr.w), col + 3, b1, bi, b2);
}

__device__ __forceinline__ float max4(const float4& w, const float4& pr) {
  return fmaxf(fmaxf(__fsub_rn(w.x, pr.x), __fsub_rn(w.y, pr.y)),
               fmaxf(__fsub_rn(w.z, pr.z), __fsub_rn(w.w, pr.w)));
}

// A row is scanned by L lanes that share out its m real columns: the whole
// warp while a sweep scans few rows (the shortest chain for one row), 8
// lanes while it scans many, four rows a warp side by side (a scan is a
// chain of loads, a running top two, reduces and a bid, about a thousand
// cycles that a warp cannot overlap with its next row's). The scalar scans
// (weights not staged, or odd widths) are always a warp's: with both kinds
// they would spill registers.
constexpr int FEW = 32, MANY = 8;

// (best value, its first column, second-best value) of a row from its
// lanes': three hardware reduces on the floats' integer images over the
// warp, or a butterfly of (value, lowest column) merges over 8 lanes. Both
// are exact: (value, lowest column) is a total order and a duplicate of the
// best value counts as second best in any grouping.
template <int L>
__device__ __forceinline__ void merge_top2(float& b1, int& bi, float& b2) {
  if (L == 32) {
    // the best value, the lowest column among the lanes that hold it, and
    // the best of what is left (the winning lane's second value, every
    // other lane's first)
    const int i1 = float_image(__fadd_rn(b1, 0.0f));
    const int m1 = __reduce_max_sync(FULL, i1);
    const int first = __reduce_min_sync(FULL, i1 == m1 ? bi : INT_MAX);
    const int m2 = __reduce_max_sync(
        FULL, bi == first ? float_image(__fadd_rn(b2, 0.0f)) : i1);
    b1 = image_float(m1);
    bi = first;
    b2 = image_float(m2);
  } else {
#pragma unroll
    for (int off = L / 2; off > 0; off >>= 1) {
      const float o1 = __shfl_xor_sync(FULL, b1, off);
      const int oi = __shfl_xor_sync(FULL, bi, off);
      const float o2 = __shfl_xor_sync(FULL, b2, off);
      if (o1 > b1 || (o1 == b1 && oi < bi)) {
        b2 = fmaxf(o2, b1);
        b1 = o1;
        bi = oi;
      } else {
        b2 = fmaxf(b2, o1);
      }
    }
  }
}

template <int L>
__device__ __forceinline__ float merge_max(float b1) {
  if (L == 32)
    return image_float(
        __reduce_max_sync(FULL, float_image(__fadd_rn(b1, 0.0f))));
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)
    b1 = fmaxf(b1, __shfl_xor_sync(FULL, b1, off));
  return b1;
}

// L lanes (l = 0 .. L-1) scan row i at the given prices: b1 = best value,
// bi = its first column, b2 = second-best value (a duplicate of the best
// value counts as second best; the caller clamps it to -1e9, which stands
// for the other rows' dummies). Valid in all L lanes. The row's own dummy
// m + i is merged last. Every lane of the warp calls it; a group with no row
// to scan passes scan = false, reads nothing and gets nothing.
template <int MODE, int L>
__device__ __forceinline__ void row_top2(const Problem& p,
                                         const float* prices, int i, int l,
                                         bool scan, float& b1, int& bi,
                                         float& b2) {
  b1 = -INFINITY;
  b2 = -INFINITY;
  bi = INT_MAX;
  if (scan) {
    if (MODE == MODE_VEC) {
      const float4* w4 = reinterpret_cast<const float4*>(p.ws + i * p.m);
      const float4* p4 = reinterpret_cast<const float4*>(prices);
      const int quads = p.m >> 2;
      int col = l << 2;
      // two loads a lane in flight (three cost registers that the kernel
      // does not have: it spilled, and ran 8% slower)
#pragma unroll 1
      for (int q = l; q < quads; q += 2 * L, col += 8 * L) {
        const bool more1 = q + L < quads;
        const float4 wa = w4[q], pa = p4[q];
        float4 wb, pb;
        if (more1) {
          wb = w4[q + L];
          pb = p4[q + L];
        }
        consider4(wa, pa, col, b1, bi, b2);
        if (more1) consider4(wb, pb, col + 4 * L, b1, bi, b2);
      }
    } else {
#pragma unroll 1
      for (int c = l; c < p.m; c += L)
        consider(__fsub_rn(weight<MODE>(p, i, c), prices[c]), c, b1, bi,
                 b2);
    }
  }
  merge_top2<L>(b1, bi, b2);
  if (!scan) return;
  // the own dummy is the highest column: only a greater value displaces
  const int own = p.m + i;
  const float own_v = __fsub_rn(0.0f, prices[own]);
  if (own_v > b1) {
    b2 = b1;
    b1 = own_v;
    bi = own;
  } else {
    b2 = fmaxf(b2, own_v);
  }
}

// The best value alone of row i, for the release test; as row_top2.
template <int MODE, int L>
__device__ __forceinline__ float row_max(const Problem& p,
                                         const float* prices, int i, int l,
                                         bool scan) {
  float b1 = -INFINITY;
  if (scan) {
    if (l == 0) b1 = __fsub_rn(0.0f, prices[p.m + i]);
    if (MODE == MODE_VEC) {
      const float4* w4 = reinterpret_cast<const float4*>(p.ws + i * p.m);
      const float4* p4 = reinterpret_cast<const float4*>(prices);
      const int quads = p.m >> 2;
#pragma unroll 1
      for (int q = l; q < quads; q += 2 * L) {
        const bool more1 = q + L < quads;
        const float4 wa = w4[q], pa = p4[q];
        float4 wb, pb;
        if (more1) {
          wb = w4[q + L];
          pb = p4[q + L];
        }
        b1 = fmaxf(b1, max4(wa, pa));
        if (more1) b1 = fmaxf(b1, max4(wb, pb));
      }
    } else {
#pragma unroll 1
      for (int c = l; c < p.m; c += L)
        b1 = fmaxf(b1, __fsub_rn(weight<MODE>(p, i, c), prices[c]));
    }
  }
  return merge_max<L>(b1);
}

// (bid, row) as one key whose unsigned order is: higher bid first, then
// lower row. No key of a bid is 0.
__device__ __forceinline__ unsigned long long bid_key(float bid, int row) {
  return ((unsigned long long)((unsigned)float_image(bid) ^ 0x80000000u)
          << 32) |
         (unsigned)(0x7fffffff - row);
}

__device__ __forceinline__ int key_row(unsigned long long key) {
  return 0x7fffffff - (int)(unsigned)(key & 0xffffffffull);
}

// Stage the real weights of MODE_VEC's masked-in rows: 16-byte loads of the
// cost rows, the jitter from its table, the masks from shared memory. A
// warp takes two rows at a time and has all their loads in flight (three a
// lane and row) before it uses the first.
__device__ __forceinline__ void stage_rows_vec(const Problem& p, float* ws,
                                               const float* jit,
                                               const unsigned char* cmask,
                                               const unsigned char* rmask,
                                               int warp, int lane) {
  constexpr int ROWS = 2, LOADS = 3;
  const int quads = p.m >> 2;
  const int len = jit_len(p.m);
  const uchar4* m4 = reinterpret_cast<const uchar4*>(cmask);
  for (int i0 = warp; i0 < p.n; i0 += ROWS * WARPS) {
    for (int q0 = lane; q0 < quads; q0 += 32 * LOADS) {
      float4 c[ROWS][LOADS];
      bool on[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int i = i0 + r * WARPS;
        on[r] = i < p.n && rmask[i];  // masked-out rows are never read
        const float4* c4 =
            reinterpret_cast<const float4*>(p.cost + (int64_t)i * p.m);
#pragma unroll
        for (int t = 0; t < LOADS; ++t)
          if (on[r] && q0 + 32 * t < quads) c[r][t] = c4[q0 + 32 * t];
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (!on[r]) continue;
        const int i = i0 + r * WARPS;
        const int s = (((i * 131) % 17) * 5) % 17;
        const float4* j4 =
            reinterpret_cast<const float4*>(jit + (s & 3) * len + (s & ~3));
        float4* w4 = reinterpret_cast<float4*>(ws + i * p.m);
#pragma unroll
        for (int t = 0; t < LOADS; ++t) {
          const int q = q0 + 32 * t;
          if (q >= quads) continue;
          const float4 j = j4[q];
          const uchar4 k = m4[q];
          float4 w;
          w.x = k.x ? __fadd_rn(__fsub_rn(p.thresh, c[r][t].x), j.x) : NEG_F;
          w.y = k.y ? __fadd_rn(__fsub_rn(p.thresh, c[r][t].y), j.y) : NEG_F;
          w.z = k.z ? __fadd_rn(__fsub_rn(p.thresh, c[r][t].z), j.z) : NEG_F;
          w.w = k.w ? __fadd_rn(__fsub_rn(p.thresh, c[r][t].w), j.w) : NEG_F;
          w4[q] = w;
        }
      }
    }
  }
}

// All phases of problem b, by one thread block; once for each way of holding
// the weights.
template <int MODE>
__device__ __forceinline__ void solve_problem(
    int b, const float* __restrict__ cost, long long cost_bstride,
    const unsigned char* __restrict__ row_mask,
    const unsigned char* __restrict__ col_mask,
    const float* __restrict__ thresh, const Powers& powers, int n, int m,
    int n_phases, int max_iters, int* __restrict__ r2c_out,
    int* __restrict__ c2r_out, int* __restrict__ sweeps_out,
    long long* __restrict__ prof_out) {
  constexpr bool VEC = MODE == MODE_VEC;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int mt = m + n;
#ifdef AUCTION_PROFILE
  // 32-bit sums (a solve is far under 2^32 cycles): half the registers
  unsigned prof[P_SLOTS] = {};
  unsigned prof_last = (unsigned)clock64();
#endif

  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay = smem_layout(n, m, MODE);
  float* ws = reinterpret_cast<float*>(smem + lay.ws);          // (n*m,)
  float* jit = reinterpret_cast<float*>(smem + lay.jit);        // (4, len)
  unsigned char* cmask = smem + lay.cmask;                      // (m,)
  unsigned char* rmask = smem + lay.rmask;                      // (n,)
  float* prices = reinterpret_cast<float*>(smem + lay.prices);  // (mt,)
  // a column's best bid of a sweep, in two arrays taken in turn: a winner's
  // key is cleared a sweep late, when no bidder reads it any more
  unsigned long long* key0 =
      reinterpret_cast<unsigned long long*>(smem + lay.key0);   // (mt,)
  unsigned long long* key1 =
      reinterpret_cast<unsigned long long*>(smem + lay.key1);   // (mt,)
  int* c2r = reinterpret_cast<int*>(smem + lay.c2r);            // (mt,)
  int* r2c = reinterpret_cast<int*>(smem + lay.r2c);            // (n,)
  // a sweep's bids by list slot: (row, column, bid, the row's second-best
  // value clamped to -1e9)
  int4* bids = reinterpret_cast<int4*>(smem + lay.bids);        // (n,)
  // the winners of the sweep before: (row, column, what the row gets from
  // it at the price it bid, its bid's second-best value)
  int4* won = reinterpret_cast<int4*>(smem + lay.won);          // (n,)
  // the unassigned rows: this sweep's bidders and the next one's
  int* list0 = reinterpret_cast<int*>(smem + lay.list0);        // (n,)
  int* list1 = reinterpret_cast<int*>(smem + lay.list1);        // (n,)
  // the rows this sweep's release frees, and the columns they held: this
  // sweep's and the one's before
  int* rel_row = reinterpret_cast<int*>(smem + lay.rel_row);    // (n,)
  int* rel_col0 = reinterpret_cast<int*>(smem + lay.rel_col0);  // (n,)
  int* rel_col1 = reinterpret_cast<int*>(smem + lay.rel_col1);  // (n,)
  // by row: the sweep in which it last won, the sweep in which it was last
  // released, and the column and price it then gave up
  int* won_at = reinterpret_cast<int*>(smem + lay.won_at);
  int* rel_at = reinterpret_cast<int*>(smem + lay.rel_at);
  int* old_col = reinterpret_cast<int*>(smem + lay.old_col);
  float* old_price = reinterpret_cast<float*>(smem + lay.old_price);
  // by row: set by the first of the warps that fail it in a release test
  int* failed = reinterpret_cast<int*>(smem + lay.failed);
  __shared__ int n_listed[2], n_winners, n_released[2], changed;

  Problem p;
  p.cost = cost + (int64_t)b * cost_bstride;
  p.row_mask = row_mask + (int64_t)b * n;
  p.col_mask = col_mask + (int64_t)b * m;
  p.ws = nullptr;
  p.thresh = thresh[b];
  p.n = n;
  p.m = m;
  // eps schedule and bid cap in the float32 arithmetic of
  // pallas_auction.py:402-410
  const float scale = __fadd_rn(p.thresh, 1.0f);
  const float cap = __fmul_rn(2.0f, scale);

  // nothing assigned, every price 0, every row a bidder
  for (int j = tid; j < mt; j += THREADS) {
    prices[j] = 0.0f;
    c2r[j] = -1;
    key0[j] = key1[j] = 0ull;
  }
  for (int i = tid; i < n; i += THREADS) {
    r2c[i] = -1;
    list0[i] = i;
    won_at[i] = -2;   // no sweep
    rel_at[i] = -1;
    failed[i] = 0;
    rmask[i] = p.row_mask[i];
  }
  if (tid == 0) {
    n_listed[0] = n;
    n_listed[1] = 0;
    n_winners = 0;
    n_released[0] = n_released[1] = 0;
    changed = 0;
  }
  if (VEC) {
    const int len = jit_len(m);
    for (int c = 0; c < 4; ++c)
      for (int x = tid; x < len; x += THREADS)
        jit[c * len + x] = jitter((7 * (x + c)) % 17);
    for (int j = tid; j < m; j += THREADS) cmask[j] = p.col_mask[j];
    __syncthreads();
    stage_rows_vec(p, ws, jit, cmask, rmask, warp, lane);
  } else if (MODE == MODE_STAGED) {
    for (int i = warp; i < n; i += WARPS) {
      if (!p.row_mask[i]) continue;
      for (int j = lane; j < m; j += 32) ws[i * m + j] = real_weight(p, i, j);
    }
  }
  if (MODE != MODE_GLOBAL) p.ws = ws;
  __syncthreads();
  PROF(P_STAGE);

  int sweeps = 0;
  int cur = 0;       // which list holds this sweep's bidders
  int rp = 0;        // which rel_col array this sweep's release fills
  int n_bid = n;     // bidders listed at the start of the sweep
  int n_won = 0;     // rows that won in the sweep before
  int n_freed = 0;   // columns freed by the release of the sweep before
  for (int ph = 0; ph < n_phases; ++ph) {
    const float eps = fmaxf(__fdiv_rn(scale, powers.v[ph]), EPS_FLOOR);
    int it = 0;
    int n_open = 1;     // the release step always runs for a new eps
    bool first = true;  // a new eps: every assigned row is tested whole
    while (it < max_iters && n_open > 0) {
      int* list = cur ? list1 : list0;
      int* next = cur ? list0 : list1;
      int* rel_col = rp ? rel_col1 : rel_col0;
      const int* freed = rp ? rel_col0 : rel_col1;
      unsigned long long* key = (sweeps & 1) ? key1 : key0;
      unsigned long long* key_before = (sweeps & 1) ? key0 : key1;

      // ---- release test, at the prices the sweep before left: row i
      // keeps its column rc iff cur >= (best value of the row) - eps. A
      // row that fails is only listed here; nothing it holds changes
      // before every test has read the prices.
      //   A masked-out row holds its own dummy and passes: nothing else
      // is worth more than -1e9 to it. A row that won its column in the
      // sweep before bid with a second-best value b2 at prices that have
      // only risen since, so no other column is worth more than b2 to it
      // now: if cur >= b2 - eps it passes, and only otherwise is it scanned
      // (a masked-out row's b2 is -1e9). In a phase's first sweep every
      // assigned row is tested, else the winners of the sweep before, whose
      // keys of that sweep are cleared here.
      auto test_rows = [&](auto lanes, bool winners, int count) {
        constexpr int L = decltype(lanes)::value;
        constexpr int G = 32 / L;   // rows a warp tests side by side
        const int g = lane / L, l = lane % L;
        for (int k0 = warp * G; k0 < count; k0 += WARPS * G) {
          const int k = k0 + g;
          int i = -1, rc = -1;
          float held = 0.0f;
          bool scan = false;
          if (k < count) {
            if (winners) {
              const int4 w = won[k];
              i = w.x;
              rc = w.y;
              held = __int_as_float(w.z);
              scan = !(held >= __fsub_rn(__int_as_float(w.w), eps));
              if (l == 0) key_before[rc] = 0ull;
            } else {
              i = k;
              rc = r2c[i];
              scan = rc >= 0 && rmask[i];
              if (scan) held = held_value<MODE>(p, prices, i, rc);
            }
          }
          const unsigned scans = __ballot_sync(FULL, scan && l == 0);
          if (scans == 0u) continue;
          PROF_COUNT(P_N_RELEASE_SCANS, __popc(scans));
          const float v1 = row_max<MODE, L>(p, prices, i, l, scan);
          if (scan && l == 0 && !(held >= __fsub_rn(v1, eps))) {
            const int slot = atomicAdd(&n_released[rp], 1);
            rel_row[slot] = i;
            rel_col[slot] = rc;
          }
        }
      };
      auto test_list = [&](bool winners, int count) {
        if (VEC && count > WARPS)
          test_rows(std::integral_constant<int, MANY>{}, winners, count);
        else
          test_rows(std::integral_constant<int, FEW>{}, winners, count);
      };
      if (first) {
        for (int k = tid; k < n_won; k += THREADS) key_before[won[k].y] = 0ull;
        test_list(false, n);
      } else {
        test_list(true, n_won);
        if (warp / ROW_GROUPS < n_freed) {
          // rows that kept their column: the freed real columns alone. A
          // lane takes a row, the warps of a row's group share out the
          // columns (one freed column is the rule, a hundred after a
          // phase's first sweep).
          for (int i = (warp % ROW_GROUPS) * 32 + lane; i < n;
               i += ROW_GROUPS * 32) {
            const int rc = r2c[i];
            if (rc < 0 || won_at[i] == sweeps - 1 || !rmask[i]) continue;
            const float held = held_value<MODE>(p, prices, i, rc);
            bool keep = true;
#pragma unroll 4
            for (int f = warp / ROW_GROUPS; f < n_freed;
                 f += WARPS / ROW_GROUPS) {
              // a freed dummy matters to no other row: test column 0 in
              // its place, without a branch, and ignore the answer
              const int j = freed[f];
              const int jr = j < m ? j : 0;
              const bool ok = held >= __fsub_rn(
                  __fsub_rn(weight<MODE>(p, i, jr), prices[jr]), eps);
              keep = keep && (ok || j >= m);
            }
            // several warps may fail the row: the first lists it
            if (!keep && atomicExch(&failed[i], 1) == 0) {
              const int k = atomicAdd(&n_released[rp], 1);
              rel_row[k] = i;
              rel_col[k] = rc;
            }
          }
        }
      }
      PROF(P_RELEASE);
      __syncthreads();
      PROF(P_BAR_RELEASE);

      // ---- free what the released rows held (price 0), list them as
      // bidders; the counters of the lists filled later in the sweep are
      // reset here, their last readers being past the barrier above
      const int n_rel = n_released[rp];
      if (tid == 0) {
        n_winners = 0;
        n_listed[cur ^ 1] = 0;
        n_released[rp ^ 1] = 0;
        changed = 0;
      }
      if (n_rel > 0) {
        for (int k = tid; k < n_rel; k += THREADS) {
          const int i = rel_row[k];
          const int rc = rel_col[k];
          rel_at[i] = sweeps;
          failed[i] = 0;
          old_col[i] = rc;
          old_price[i] = prices[rc];
          r2c[i] = -1;
          c2r[rc] = -1;
          prices[rc] = 0.0f;
          list[n_bid + k] = i;
        }
        __syncthreads();
      }
      PROF(P_FREE);

      // ---- one Jacobi bid round: every unassigned row bids for its
      // first best column, raising it by min(v1 - v2, cap) + eps; a
      // column keeps its best bid in its key
      const int n_all = n_bid + n_rel;
      auto place_bid = [&](int k, int i, float b1, int bi, float b2) {
        b2 = fmaxf(b2, NEG_F);
        const float bv = __fadd_rn(
            __fadd_rn(prices[bi], fminf(__fsub_rn(b1, b2), cap)), eps);
        bids[k] = make_int4(i, bi, __float_as_int(bv), __float_as_int(b2));
        atomicMax(&key[bi], bid_key(bv, i));
      };
      // a masked-out row, a thread each: its own dummy against -1e9
      // everywhere else. It wins and is never freed, so it only ever bids
      // in the very first sweep. Then the others, scanned by a warp or by 8
      // lanes each.
      if (sweeps == 0) {
        for (int k = tid; k < n_all; k += THREADS) {
          const int i = list[k];
          if (!rmask[i])
            place_bid(k, i, __fsub_rn(0.0f, prices[m + i]), m + i, NEG_F);
        }
      }
      auto bid_rows = [&](auto lanes) {
        constexpr int L = decltype(lanes)::value;
        constexpr int G = 32 / L;   // rows a warp scans side by side
        const int g = lane / L, l = lane % L;
        for (int k0 = warp * G; k0 < n_all; k0 += WARPS * G) {
          const int k = k0 + g;
          const int i = k < n_all ? list[k] : -1;
          const bool scan = i >= 0 && (sweeps > 0 || rmask[i]);
          PROF_COUNT(P_N_BID_SCANS,
                     __popc(__ballot_sync(FULL, scan && l == 0)));
          float b1, b2;
          int bi;
          row_top2<MODE, L>(p, prices, i, l, scan, b1, bi, b2);
          if (scan && l == 0) place_bid(k, i, b1, bi, b2);
        }
      };
      if (VEC && n_all > WARPS)
        bid_rows(std::integral_constant<int, MANY>{});
      else
        bid_rows(std::integral_constant<int, FEW>{});
      PROF(P_BID);
      __syncthreads();
      PROF(P_BAR_BID);

      // ---- each bid-on column goes to its highest bidder, ties to the
      // lowest row. The winner's key stays until the next sweep, whose
      // bids go to the other array.
      for (int k = tid; k < n_all; k += THREADS) {
        const int4 mine = bids[k];
        const int i = mine.x, j = mine.y;
        if (key_row(key[j]) != i) {
          next[atomicAdd(&n_listed[cur ^ 1], 1)] = i;
          continue;
        }
        // the previous owner is evicted and bids in the next sweep; it
        // held a column, so it was no bidder in this one
        const int prev = c2r[j];
        if (prev >= 0) {
          r2c[prev] = -1;
          next[atomicAdd(&n_listed[cur ^ 1], 1)] = prev;
        }
        const float bv = __int_as_float(mine.z);
        const float w = j < m ? weight<MODE>(p, i, j) : 0.0f;
        c2r[j] = i;
        r2c[i] = j;
        prices[j] = bv;
        won_at[i] = sweeps;
        won[atomicAdd(&n_winners, 1)] = make_int4(
            i, j, __float_as_int(fmaxf(__fsub_rn(w, bv), NEG_F)), mine.w);
        // the state changes unless i takes back, at the same price, the
        // column this sweep's release took from it
        if (!(rel_at[i] == sweeps && old_col[i] == j &&
              __float_as_int(old_price[i]) == __float_as_int(bv)))
          changed = 1;
      }
      PROF(P_AWARD);
      __syncthreads();
      PROF(P_BAR_AWARD);
      n_bid = n_listed[cur ^ 1];
      n_won = n_winners;
      n_freed = n_rel;
      n_open = n_bid + n_rel;   // unassigned + released, as the TPU form
      // A sweep that left (r2c, c2r, prices) bit-identical would be
      // repeated unchanged until max_iters: every released row won its
      // column back at the same price and nothing else moved. Stop the
      // phase here, with the same result.
      const bool repeat = changed == 0 && n_won == n_rel;
      cur ^= 1;
      rp ^= 1;
      first = false;
      ++it;
      ++sweeps;
      if (repeat) break;
    }
  }
  if (sweeps_out != nullptr && tid == 0) sweeps_out[b] = sweeps;

  // ---- gate: keep real pairs with cost <= thresh; rebuild c2r
  int* out_r = r2c_out + (int64_t)b * n;
  int* out_c = c2r_out + (int64_t)b * m;
  for (int j = tid; j < m; j += THREADS) out_c[j] = -1;
  __syncthreads();
  for (int i = tid; i < n; i += THREADS) {
    const int j = r2c[i];
    const bool keep = j >= 0 && j < m && p.row_mask[i] &&
                      p.cost[(int64_t)i * m + j] <= p.thresh;
    out_r[i] = keep ? j : -1;
    if (keep) out_c[j] = i;
  }
#ifdef AUCTION_PROFILE
  __syncthreads();
  PROF(P_GATE);
  if (lane == 0 && prof_out != nullptr)
    for (int k = 0; k < P_SLOTS; ++k)
      prof_out[((int64_t)b * PROFILE_WARPS + warp) * P_SLOTS + k] = prof[k];
#endif
}

// B problems in one launch, one thread block per problem; one kernel for
// each way of holding the weights, so that each has its own register
// allocation.
template <int MODE>
__global__ void __launch_bounds__(THREADS, 1)
auction_kernel(const float* __restrict__ cost, long long cost_bstride,
               const unsigned char* __restrict__ row_mask,
               const unsigned char* __restrict__ col_mask,
               const float* __restrict__ thresh, Powers powers, int n,
               int m, int n_phases, int max_iters,
               int* __restrict__ r2c_out, int* __restrict__ c2r_out,
               int* __restrict__ sweeps_out,
               long long* __restrict__ prof_out) {
  solve_problem<MODE>(blockIdx.x, cost, cost_bstride, row_mask, col_mask,
                      thresh, powers, n, m, n_phases, max_iters, r2c_out,
                      c2r_out, sweeps_out, prof_out);
}

// ---------------------------------------------------------------------------
// K4: the XLA twin (masked_assignment_v2, yolov7_tracker_tpu/ops/
// assignment.py:311), the solver the JAX package runs on its chip. Same
// weights, jitter, private dummies and eps schedule as K2, and the same
// output gate; what differs is the control flow of a phase. The twin runs
// the clamp-and-release step as a fixpoint of its own (at most n + 1
// iterations, until none is released) and only then Jacobi bid rounds,
// with no release inside them, until no row is unassigned or max_iters
// rounds have run; masked-out rows start on their own dummies. Fusing the
// release into every bid sweep (K2) lets (release, re-bid) cycles leave
// weight on the table on dense costs; this form does not. The plain
// version (ops/auction.py: _solve_one_twin) computes the same bits: r2c,
// c2r and each problem's sweeps (release iterations plus bid rounds).
//
// Two entries share the solve: auction_twin_launch (B problems, one block
// each) and auction_twin_cascade_launch, which replaces the JAX package's
// matching_cascade (yolov7_tracker_tpu/trackers/appearance.py:66, a
// lax.scan over max_time_lost levels of masked_assignment) with one block
// a problem that runs every level: level l solves the twin on the rows
// row_mask & (time_since_update == 1 + l) against the columns no level
// before took, gates, and merges into r2c. The weights are staged once: a
// column that a level takes leaves det_avail for good, so writing -1e9 into
// its staged weights gives the bits of where(valid, ..., -1e9). A problem
// or a level with no row (most of deepsort's 30 levels, and the stages 2
// and 3 of a frame whose tracks stage 1 all matched) is one barrier: the
// twin solves it to nothing in one release iteration a phase, so its
// sweeps are n_phases.
//
// What bounds it on the card: neither bytes (one 150 KB cost in, two index
// vectors out) nor arithmetic (a few hundred thousand subtractions and
// compares a solve), but the latency of dependent sweeps: each release
// iteration and bid round must see the prices and the matching the one
// before left, and a row's scan, reduce and bid is a chain that a warp
// cannot overlap with its next row's. There is no product in an auction,
// so the tensor cores (wgmma) have no part in it. The design shortens the
// chain and scans only what a sweep can change; each step is held against
// the plain version by a numpy model after every sweep
// (tests/test_torch_auction.py, _twin_model):
//   * the release fixpoint tests every assigned, masked-in row in full only
//     in a phase's first iteration (a new eps, and the bid rounds moved the
//     prices). From the second iteration on, a row that kept its column
//     passed the iteration before, and the only prices that moved since are
//     those of the columns that iteration freed, which fell to 0. Rounded
//     subtraction is monotone, so cur >= max_j(v_j) - eps holds exactly
//     when cur >= v_j - eps holds for every column j: those rows test the
//     freed real columns alone, a lane a row (a freed dummy is worth -1e9 to
//     every other row and can fail none). The first clamp of a phase is a
//     no-op (a column is unowned only after a release, which zeroes its
//     price at once) and is not run. K2's second-best shortcut (a row that
//     won since the last price fall passes if cur >= b2 - eps) is sound
//     here too, but every whole-row test comes with a smaller eps than the
//     bid's, under which the model finds it never passes: it is not carried;
//   * the bidders of a round are never searched for: the first round's are
//     the rows the fixpoint released plus those no round has placed (every
//     masked-in row in phase 0), a later round's are the losers and the
//     evicted rows of the round before, handed on in a list; the awards
//     pass walks that list, not all n rows;
//   * a column's winner -- highest bid, lowest row on a tie -- is one 64-bit
//     atomicMax in shared memory on (bid, ~row); the keys of a round are
//     cleared in the next one, in the other of two key arrays, by the list
//     of that round's won columns;
//   * while a sweep scans many rows (a phase's first bid round and its
//     first release iteration: about a hundred of the tracker's 128), 8
//     lanes scan a row, four rows a warp side by side; while it scans few,
//     a whole warp scans each row (the shortest chain). Both merge the top
//     two exactly (row_top2 / row_max above; a row's other dummies are left
//     out exactly as in K2);
//   * the cost rows are staged as K2 stages them (stage_rows_vec): 16-byte
//     loads, a warp two rows at a time with all their loads in flight,
//     turned into weights in registers, (thresh - c) + jit in two rounded
//     ops. Staging with cp.async, all copies in flight while the block sets
//     up prices, keys, c2r, r2c and the bidder list, then turning the
//     copies into weights in place, took 12,130 cycles against these
//     loads' 11,161 on the tracker's stage-1 problem (H100, the profiling
//     build, one run of each): the setup it hides is short, and the
//     in-place pass reads and writes the weights once more. Shapes whose weights do not fit a
//     block's shared memory recompute them from the cost matrix through L2
//     (MODE_GLOBAL), and odd widths stage with scalar loads;
//   * a list is filled with one shared atomicAdd a warp (warp_slot), not
//     one a row: a hundred rows on one counter serialise.
// A release iteration is: tests, barrier, free the released (and a
// barrier, if any). A bid round is: key clears and bids, barrier, awards,
// barrier.
// ---------------------------------------------------------------------------

struct TwinLayout {
  size_t ws, jit, cmask, rmask, prices, key0, key1, c2r, r2c, bids, list0,
      list1, rel_row, rel_col0, rel_col1, failed, won, taken, total;
};

__host__ __device__ inline TwinLayout twin_layout(int n, int m, int mode) {
  const size_t mt = (size_t)n + m;
  const size_t rows = align16((size_t)n * 4);
  TwinLayout l;
  l.ws = 0;
  l.jit = align16(mode != MODE_GLOBAL ? (size_t)n * m * 4 : 0);
  l.cmask = align16(l.jit +
                    (mode == MODE_VEC ? (size_t)jit_len(m) * 16 : 0));
  l.rmask = align16(l.cmask + (size_t)m);
  l.prices = align16(l.rmask + (size_t)n);
  l.key0 = align16(l.prices + mt * 4);
  l.key1 = align16(l.key0 + mt * 8);
  l.c2r = align16(l.key1 + mt * 8);
  l.r2c = align16(l.c2r + mt * 4);
  l.bids = l.r2c + rows;
  l.list0 = l.bids + 4 * rows;
  l.list1 = l.list0 + rows;
  l.rel_row = l.list1 + rows;
  l.rel_col0 = l.rel_row + rows;
  l.rel_col1 = l.rel_col0 + rows;
  l.failed = l.rel_col1 + rows;
  l.won = l.failed + rows;
  l.taken = l.won + rows;
  l.total = l.taken + align16((size_t)m * 4);
  return l;
}

// A block's arrays in dynamic shared memory.
struct Twin {
  float* ws;                 // (n * m,) staged weights (not MODE_GLOBAL)
  float* jit;                // (4, jit_len(m)) MODE_VEC's jitter table
  unsigned char* cmask;      // (m,) the columns still to match
  unsigned char* rmask;      // (n,) the rows of this solve
  float* prices;             // (mt,)
  unsigned long long* key0;  // (mt,) a round's best (bid, ~row) by column,
  unsigned long long* key1;  //   in two arrays taken in turn
  int* c2r;                  // (mt,)
  int* r2c;                  // (n,)
  int4* bids;                // (n,) by list slot: (row, column, bid, -)
  int* list0;                // (n,) the unassigned rows: this round's
  int* list1;                //   bidders and the next one's
  int* rel_row;              // (n,) the rows this iteration releases
  int* rel_col0;             // (n,) the columns they held: this
  int* rel_col1;             //   iteration's and the one's before
  int* failed;               // (n,) set by the first warp that fails a row
  int* won;                  // (n,) the columns won in the last round
  int* taken;                // (m,) the columns a cascade level took
};

__device__ __forceinline__ Twin twin_arrays(unsigned char* smem,
                                            const TwinLayout& l) {
  Twin t;
  t.ws = reinterpret_cast<float*>(smem + l.ws);
  t.jit = reinterpret_cast<float*>(smem + l.jit);
  t.cmask = smem + l.cmask;
  t.rmask = smem + l.rmask;
  t.prices = reinterpret_cast<float*>(smem + l.prices);
  t.key0 = reinterpret_cast<unsigned long long*>(smem + l.key0);
  t.key1 = reinterpret_cast<unsigned long long*>(smem + l.key1);
  t.c2r = reinterpret_cast<int*>(smem + l.c2r);
  t.r2c = reinterpret_cast<int*>(smem + l.r2c);
  t.bids = reinterpret_cast<int4*>(smem + l.bids);
  t.list0 = reinterpret_cast<int*>(smem + l.list0);
  t.list1 = reinterpret_cast<int*>(smem + l.list1);
  t.rel_row = reinterpret_cast<int*>(smem + l.rel_row);
  t.rel_col0 = reinterpret_cast<int*>(smem + l.rel_col0);
  t.rel_col1 = reinterpret_cast<int*>(smem + l.rel_col1);
  t.failed = reinterpret_cast<int*>(smem + l.failed);
  t.won = reinterpret_cast<int*>(smem + l.won);
  t.taken = reinterpret_cast<int*>(smem + l.taken);
  return t;
}

// A block's counters, each in two copies taken in turn: a copy is reset
// only where a barrier separates its last reader from its next writer.
struct TwinCounters {
  int listed[2];     // by list: rows handed on by a round's awards
  int winners[2];    // by round parity: columns won
  int released[2];   // by release iteration parity: rows released
  int taken[2];      // by cascade level parity: columns a level took
};

// The profiling build's per-warp sums, carried across the levels of a
// cascade.
struct Prof {
#ifdef AUCTION_PROFILE
  unsigned v[P_SLOTS];
  unsigned last;
#endif
};

// Slots for the lanes of a warp that take one each in a shared list whose
// length is *counter: one atomicAdd for the warp, in lane order. Every lane
// of the warp calls it.
__device__ __forceinline__ int warp_slot(int* counter, bool take, int lane) {
  const unsigned ballot = __ballot_sync(FULL, take);
  int base = 0;
  if (lane == 0 && ballot != 0u) base = atomicAdd(counter, __popc(ballot));
  base = __shfl_sync(FULL, base, 0);
  return base + __popc(ballot & ((1u << lane) - 1u));
}

// A solve's counters to 0, by thread 0; the caller puts a barrier between
// this and their next writers, and their last readers before it.
__device__ __forceinline__ void twin_zero_counters(TwinCounters& cnt) {
  if (threadIdx.x == 0) {
    cnt.listed[0] = cnt.listed[1] = 0;
    cnt.winners[0] = cnt.winners[1] = 0;
    cnt.released[0] = cnt.released[1] = 0;
  }
}

// The state a solve starts from, on the rows of t.rmask (written before a
// barrier): every price 0 and no key; a masked-out row holds its own
// dummy, the others nothing and stand in list0 to bid.
__device__ __forceinline__ void twin_init(const Twin& t, TwinCounters& cnt,
                                          int n, int m) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int j = tid; j < m + n; j += THREADS) {
    t.prices[j] = 0.0f;
    t.key0[j] = t.key1[j] = 0ull;
    t.c2r[j] = (j >= m && !t.rmask[j - m]) ? j - m : -1;
  }
  for (int i0 = warp * 32; i0 < n; i0 += THREADS) {
    const int i = i0 + lane;
    const bool on = i < n && t.rmask[i];
    if (i < n) {
      t.r2c[i] = on ? -1 : m + i;
      t.failed[i] = 0;
    }
    const int slot = warp_slot(&cnt.listed[0], on, lane);
    if (on) t.list0[slot] = i;
  }
}

// The real weights of the rows of p.row_mask, (thresh - c) + jit in two
// rounded ops or -1e9 for a masked column: MODE_VEC's by K2's 16-byte
// loads (stage_rows_vec), MODE_STAGED's a column a load. Reads the jitter
// table and cmask.
template <int MODE>
__device__ __forceinline__ void twin_weights(const Problem& p, const Twin& t,
                                             int warp, int lane) {
  if (MODE == MODE_VEC) {
    stage_rows_vec(p, t.ws, t.jit, t.cmask, p.row_mask, warp, lane);
  } else if (MODE == MODE_STAGED) {
    for (int i = warp; i < p.n; i += WARPS) {
      if (!p.row_mask[i]) continue;
      for (int j = lane; j < p.m; j += 32)
        t.ws[i * p.m + j] = real_weight(p, i, j);
    }
  }
}

// The block's setup before its staging: the jitter table (MODE_VEC) and
// cmask from p.col_mask.
template <int MODE>
__device__ __forceinline__ void twin_tables(const Problem& p, const Twin& t) {
  const int tid = threadIdx.x;
  if (MODE == MODE_VEC) {
    const int len = jit_len(p.m);
    for (int c = 0; c < 4; ++c)
      for (int x = tid; x < len; x += THREADS)
        t.jit[c * len + x] = jitter((7 * (x + c)) % 17);
  }
  for (int j = tid; j < p.m; j += THREADS) t.cmask[j] = p.col_mask[j];
}

// One solve of the twin, every phase, by the whole block, on the rows of
// t.rmask against the columns of t.cmask; p.row_mask and p.col_mask point
// at them (MODE_GLOBAL's weights read them). Starts from twin_init's state
// (a barrier after it), leaves the ungated matching in t.r2c and returns
// the sweeps (release iterations plus bid rounds).
template <int MODE>
__device__ __forceinline__ int twin_solve(const Problem& p, const Twin& t,
                                          TwinCounters& cnt,
                                          const Powers& powers, int n_phases,
                                          int max_iters, Prof& pr) {
  constexpr bool VEC = MODE == MODE_VEC;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n = p.n, m = p.m;
#ifdef AUCTION_PROFILE
  unsigned* prof = pr.v;
  unsigned& prof_last = pr.last;
#endif
  // the twin's float32 schedule and bid cap (assignment.py:338-345)
  const float scale = __fadd_rn(p.thresh, 1.0f);
  const float cap = __fmul_rn(2.0f, scale);

  int sweeps = 0;
  int n_bid = cnt.listed[0];   // rows in the current list
  int cur = 0;                 // which list holds them
  int rounds = 0;              // bid rounds so far: which key array
  int n_won = 0;               // columns won in the last round
  int rel_it = 0;              // release iterations so far: which counter
  for (int ph = 0; ph < n_phases; ++ph) {
    const float eps = fmaxf(__fdiv_rn(scale, powers.v[ph]), EPS_FLOOR);

    // ---- the release fixpoint. A row keeps its column rc iff cur >=
    // (best value of the row) - eps at the prices the iteration before
    // left; a row that fails is only listed here, nothing it holds changes
    // before every test has read the prices. A masked-out row holds its
    // own dummy and passes: nothing else is worth more than -1e9 to it.
    int n_freed = 0;
    for (int it = 0; it < n + 1; ++it, ++rel_it) {
      int* const rel_col = (it & 1) ? t.rel_col1 : t.rel_col0;
      const int* const freed = (it & 1) ? t.rel_col0 : t.rel_col1;
      int* const list = cur ? t.list1 : t.list0;
      int* const n_rel_at = &cnt.released[rel_it & 1];
      if (it == 0) {
        // every assigned row, in full: L lanes a row, 32 / L rows a warp
        auto test_rows = [&](auto lanes) {
          constexpr int L = decltype(lanes)::value;
          constexpr int G = 32 / L;
          const int g = lane / L, l = lane % L;
          for (int i0 = warp * G; i0 < n; i0 += WARPS * G) {
            const int i = i0 + g;
            const int rc = i < n ? t.r2c[i] : -1;
            const bool scan = rc >= 0 && t.rmask[i];
            const unsigned scans = __ballot_sync(FULL, scan && l == 0);
            if (scans == 0u) continue;
            PROF_COUNT(P_N_RELEASE_SCANS, __popc(scans));
            const float v1 = row_max<MODE, L>(p, t.prices, i, l, scan);
            if (scan && l == 0) {
              const float held = __fsub_rn(
                  rc < m ? weight<MODE>(p, i, rc) : 0.0f, t.prices[rc]);
              if (!(held >= __fsub_rn(v1, eps))) {
                const int k = atomicAdd(n_rel_at, 1);
                t.rel_row[k] = i;
                rel_col[k] = rc;
              }
            }
          }
        };
        if (VEC && n > WARPS)
          test_rows(std::integral_constant<int, MANY>{});
        else
          test_rows(std::integral_constant<int, FEW>{});
      } else if (warp / ROW_GROUPS < n_freed) {
        // every assigned row passed the iteration before: the freed real
        // columns alone, now at price 0. A lane takes a row, the warps of
        // a row's group share out the columns.
        for (int i = (warp % ROW_GROUPS) * 32 + lane; i < n;
             i += ROW_GROUPS * 32) {
          const int rc = t.r2c[i];
          if (rc < 0 || !t.rmask[i]) continue;
          const float held = __fsub_rn(
              rc < m ? weight<MODE>(p, i, rc) : 0.0f, t.prices[rc]);
          bool keep = true;
#pragma unroll 4
          for (int f = warp / ROW_GROUPS; f < n_freed;
               f += WARPS / ROW_GROUPS) {
            // a freed dummy fails no other row: test column 0 in its
            // place, without a branch, and ignore the answer
            const int j = freed[f];
            const int jr = j < m ? j : 0;
            const bool ok = held >= __fsub_rn(
                __fsub_rn(weight<MODE>(p, i, jr), t.prices[jr]), eps);
            keep = keep && (ok || j >= m);
          }
          // several warps may fail the row: the first lists it
          if (!keep && atomicExch(&t.failed[i], 1) == 0) {
            const int k = atomicAdd(n_rel_at, 1);
            t.rel_row[k] = i;
            rel_col[k] = rc;
          }
        }
      }
      PROF(P_RELEASE);
      __syncthreads();
      PROF(P_BAR_RELEASE);
      // free what the released rows held (price 0: the next iteration's
      // clamp) and list them as bidders. The other counter's last reader
      // is past the barrier above, its next writer past the next one.
      const int n_rel = *n_rel_at;
      if (tid == 0) cnt.released[(rel_it + 1) & 1] = 0;
      for (int k = tid; k < n_rel; k += THREADS) {
        const int i = t.rel_row[k];
        const int rc = rel_col[k];
        t.r2c[i] = -1;
        t.c2r[rc] = -1;
        t.prices[rc] = 0.0f;
        t.failed[i] = 0;
        list[n_bid + k] = i;
      }
      ++sweeps;
      n_bid += n_rel;
      n_freed = n_rel;
      if (n_rel == 0) break;
      __syncthreads();
      PROF(P_FREE);
    }

    // ---- Jacobi bid rounds until every row is assigned: the listed rows
    // bid for their first best column, raising it by min(v1 - v2, cap) +
    // eps; a column keeps its best bid in its key
    int it = 0;
    for (; it < max_iters && n_bid > 0; ++it) {
      int* const list = cur ? t.list1 : t.list0;
      int* const next = cur ? t.list0 : t.list1;
      unsigned long long* const key = (rounds & 1) ? t.key1 : t.key0;
      unsigned long long* const key_before = (rounds & 1) ? t.key0 : t.key1;
      // the last round's keys: the columns it awarded
      for (int k = tid; k < n_won; k += THREADS) key_before[t.won[k]] = 0ull;
      auto bid_rows = [&](auto lanes) {
        constexpr int L = decltype(lanes)::value;
        constexpr int G = 32 / L;   // rows a warp scans side by side
        const int g = lane / L, l = lane % L;
        for (int k0 = warp * G; k0 < n_bid; k0 += WARPS * G) {
          const int k = k0 + g;
          const bool scan = k < n_bid;
          const int i = scan ? list[k] : 0;
          PROF_COUNT(P_N_BID_SCANS,
                     __popc(__ballot_sync(FULL, scan && l == 0)));
          float b1, b2;
          int bi;
          row_top2<MODE, L>(p, t.prices, i, l, scan, b1, bi, b2);
          if (scan && l == 0) {
            // the other rows' dummies and the masked best: -1e9
            b2 = fmaxf(b2, NEG_F);
            const float bv = __fadd_rn(
                __fadd_rn(t.prices[bi], fminf(__fsub_rn(b1, b2), cap)), eps);
            t.bids[k] = make_int4(i, bi, __float_as_int(bv), 0);
            atomicMax(&key[bi], bid_key(bv, i));
          }
        }
      };
      if (VEC && n_bid > WARPS)
        bid_rows(std::integral_constant<int, MANY>{});
      else
        bid_rows(std::integral_constant<int, FEW>{});
      PROF(P_BID);
      __syncthreads();
      PROF(P_BAR_BID);
      // each bid-on column goes to its highest bidder, ties to the lowest
      // row; the previous owner is evicted (it held a column, so it made no
      // bid in this round). The counters the next round fills were last
      // read before the barrier above.
      if (tid == 0) {
        cnt.listed[cur] = 0;
        cnt.winners[(rounds + 1) & 1] = 0;
      }
      int* const n_next = &cnt.listed[cur ^ 1];
      int* const n_winners = &cnt.winners[rounds & 1];
      for (int k0 = warp * 32; k0 < n_bid; k0 += THREADS) {
        const int k = k0 + lane;
        int4 mine = make_int4(-1, 0, 0, 0);
        bool win = false;
        int prev = -1;
        if (k < n_bid) {
          mine = t.bids[k];
          win = key_row(key[mine.y]) == mine.x;
          if (win) prev = t.c2r[mine.y];
        }
        // handed on: a loser itself, or the owner its winner evicts
        const bool hand = k < n_bid && (!win || prev >= 0);
        const int slot = warp_slot(n_next, hand, lane);
        const int won_slot = warp_slot(n_winners, win, lane);
        if (hand) next[slot] = win ? prev : mine.x;
        if (win) {
          const int i = mine.x, j = mine.y;
          if (prev >= 0) t.r2c[prev] = -1;
          t.c2r[j] = i;
          t.r2c[i] = j;
          t.prices[j] = __int_as_float(mine.z);
          t.won[won_slot] = j;
        }
      }
      PROF(P_AWARD);
      __syncthreads();
      PROF(P_BAR_AWARD);
      n_bid = *n_next;
      n_won = *n_winners;
      cur ^= 1;
      ++rounds;
      ++sweeps;
    }
    // with no round, nothing stands between the release counter reset
    // above and the next phase's first tests
    if (it == 0) __syncthreads();
  }
  return sweeps;
}

// Gate a solve's matching: keep real pairs of the solve's rows with
// cost <= thresh.
__device__ __forceinline__ int twin_gated(const Problem& p, const Twin& t,
                                          int i) {
  const int j = t.r2c[i];
  const bool keep = j >= 0 && j < p.m && t.rmask[i] &&
                    p.cost[(int64_t)i * p.m + j] <= p.thresh;
  return keep ? j : -1;
}

template <int MODE>
__global__ void __launch_bounds__(THREADS, 1)
twin_kernel(const float* __restrict__ cost, long long cost_bstride,
            const unsigned char* __restrict__ row_mask,
            const unsigned char* __restrict__ col_mask,
            const float* __restrict__ thresh, Powers powers, int n, int m,
            int n_phases, int max_iters, int* __restrict__ r2c_out,
            int* __restrict__ c2r_out, int* __restrict__ sweeps_out,
            long long* __restrict__ prof_out) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  extern __shared__ __align__(16) unsigned char smem[];
  const Twin t = twin_arrays(smem, twin_layout(n, m, MODE));
  __shared__ TwinCounters cnt;
  Prof pr;
#ifdef AUCTION_PROFILE
  for (int k = 0; k < P_SLOTS; ++k) pr.v[k] = 0;
  pr.last = (unsigned)clock64();
  unsigned* prof = pr.v;
  unsigned& prof_last = pr.last;
#endif

  Problem p;
  p.cost = cost + (int64_t)b * cost_bstride;
  p.row_mask = row_mask + (int64_t)b * n;
  p.col_mask = col_mask + (int64_t)b * m;
  p.ws = nullptr;
  p.thresh = thresh[b];
  p.n = n;
  p.m = m;
  int* out_r = r2c_out + (int64_t)b * n;
  int* out_c = c2r_out + (int64_t)b * m;
  // the masks and the jitter table, then the solve's state and weights
  twin_zero_counters(cnt);
  bool any = false;
  for (int i = tid; i < n; i += THREADS) {
    const bool on = p.row_mask[i];
    t.rmask[i] = on;
    any = any || on;
  }
  twin_tables<MODE>(p, t);
  for (int j = tid; j < m; j += THREADS) out_c[j] = -1;
  if (!__syncthreads_or(any)) {
    // no row: the twin solves it to nothing in one release iteration a
    // phase (nothing is assigned, so nothing is released, and no row
    // bids), as a cascade's empty level
    if (sweeps_out != nullptr && tid == 0) sweeps_out[b] = n_phases;
    for (int i = tid; i < n; i += THREADS) out_r[i] = -1;
  } else {
    p.row_mask = t.rmask;
    p.col_mask = t.cmask;
    twin_init(t, cnt, n, m);
    twin_weights<MODE>(p, t, warp, lane);
    if (MODE != MODE_GLOBAL) p.ws = t.ws;
    __syncthreads();
    PROF(P_STAGE);
    const int sweeps =
        twin_solve<MODE>(p, t, cnt, powers, n_phases, max_iters, pr);
    if (sweeps_out != nullptr && tid == 0) sweeps_out[b] = sweeps;
    // ---- gate: keep real pairs with cost <= thresh; c2r was set to -1
    // above, before the barriers of the solve
    for (int i = tid; i < n; i += THREADS) {
      const int j = twin_gated(p, t, i);
      out_r[i] = j;
      if (j >= 0) out_c[j] = i;
    }
  }
#ifdef AUCTION_PROFILE
  __syncthreads();
  PROF(P_GATE);
  if (lane == 0 && prof_out != nullptr)
    for (int k = 0; k < P_SLOTS; ++k)
      prof_out[((int64_t)b * PROFILE_WARPS + warp) * P_SLOTS + k] = pr.v[k];
#else
  (void)prof_out;
#endif
}

// matching_cascade in one block a problem: `depth` levels of the twin. A
// level with no row is not run (its sweeps are n_phases, as twin_kernel's
// problem with no row).
template <int MODE>
__global__ void __launch_bounds__(THREADS, 1)
twin_cascade_kernel(const float* __restrict__ cost, long long cost_bstride,
                    const unsigned char* __restrict__ row_mask,
                    const unsigned char* __restrict__ col_mask,
                    const int* __restrict__ tsu,
                    const float* __restrict__ thresh, Powers powers, int n,
                    int m, int depth, int n_phases, int max_iters,
                    int* __restrict__ r2c_out, int* __restrict__ c2r_out,
                    int* __restrict__ sweeps_out) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  extern __shared__ __align__(16) unsigned char smem[];
  const Twin t = twin_arrays(smem, twin_layout(n, m, MODE));
  __shared__ TwinCounters cnt;
  Prof pr;   // the profiling build's sums, which this entry does not write
#ifdef AUCTION_PROFILE
  for (int k = 0; k < P_SLOTS; ++k) pr.v[k] = 0;
  pr.last = (unsigned)clock64();
  unsigned* prof = pr.v;
  unsigned& prof_last = pr.last;
#endif

  const unsigned char* rm = row_mask + (int64_t)b * n;
  const int* ts = tsu + (int64_t)b * n;
  int* out_r = r2c_out + (int64_t)b * n;
  int* out_c = c2r_out + (int64_t)b * m;
  Problem p;
  p.cost = cost + (int64_t)b * cost_bstride;
  p.row_mask = rm;             // staged: every row some level may solve
  p.col_mask = col_mask + (int64_t)b * m;
  p.ws = nullptr;
  p.thresh = thresh[b];
  p.n = n;
  p.m = m;
  // each level's rows are t.rmask: rm & (tsu == 1 + level)
  auto level_rows = [&](int lvl) {
    bool any = false;
    for (int i = tid; i < n; i += THREADS) {
      const bool on = rm[i] && ts[i] == 1 + lvl;
      t.rmask[i] = on;
      any = any || on;
    }
    return any;
  };
  twin_zero_counters(cnt);
  if (tid == 0) cnt.taken[0] = cnt.taken[1] = 0;
  for (int i = tid; i < n; i += THREADS) out_r[i] = -1;
  for (int j = tid; j < m; j += THREADS) out_c[j] = -1;
  const bool any0 = depth > 0 && level_rows(0);
  twin_tables<MODE>(p, t);                // cmask: det_avail
  bool any = __syncthreads_or(any0) != 0;
  // level 0's state, and the weights of every row some level solves
  twin_init(t, cnt, n, m);
  twin_weights<MODE>(p, t, warp, lane);
  if (MODE != MODE_GLOBAL) p.ws = t.ws;
  p.row_mask = t.rmask;
  p.col_mask = t.cmask;
  __syncthreads();
  PROF(P_STAGE);

  int tk = 0;   // levels run: which taken counter
  for (int lvl = 0; lvl < depth; ++lvl) {
    if (lvl > 0) {
      // the counters' last readers are past the last level's gate barrier
      twin_zero_counters(cnt);
      any = __syncthreads_or(level_rows(lvl)) != 0;
      if (any) {
        twin_init(t, cnt, n, m);
        __syncthreads();
      }
      PROF(P_STAGE);
    }
    if (!any) {
      if (sweeps_out != nullptr && tid == 0)
        sweeps_out[(int64_t)b * depth + lvl] = n_phases;
      continue;
    }
    const int sweeps =
        twin_solve<MODE>(p, t, cnt, powers, n_phases, max_iters, pr);
    if (sweeps_out != nullptr && tid == 0)
      sweeps_out[(int64_t)b * depth + lvl] = sweeps;
    // gate, merge into r2c, and take the matched columns out of det_avail
    for (int i = tid; i < n; i += THREADS) {
      const int j = twin_gated(p, t, i);
      if (j >= 0) {
        out_r[i] = j;
        out_c[j] = i;
        t.taken[atomicAdd(&cnt.taken[tk & 1], 1)] = j;
      }
    }
    __syncthreads();
    // the other counter's last reader is a level back, its next writer a
    // level on, past the next run's barriers
    const int n_taken = cnt.taken[tk & 1];
    if (tid == 0) cnt.taken[(tk + 1) & 1] = 0;
    ++tk;
    for (int k = tid; k < n_taken; k += THREADS) t.cmask[t.taken[k]] = 0;
    if (MODE != MODE_GLOBAL) {
      for (int x = tid; x < n_taken * n; x += THREADS)
        t.ws[(x % n) * m + t.taken[x / n]] = NEG_F;
    }
    PROF(P_GATE);
    // the next level starts with a barrier: the masks and weights are
    // written before its solve reads them
  }
}

}  // namespace

// The names of the profiling build's parts, comma-separated, in the order
// of prof_out's last axis.
extern "C" const char* auction_profile_parts() { return PROFILE_PARTS; }

// prof_out: (B, 32, parts) cycle sums of the profiling build, by warp and
// part; the build without -DAUCTION_PROFILE ignores it (pass null).
extern "C" int auction_launch(const float* cost, long long cost_bstride,
                              const unsigned char* row_mask,
                              const unsigned char* col_mask,
                              const float* thresh, const float* powers,
                              int B, int N, int M, int n_phases,
                              int max_iters, int* r2c_out, int* c2r_out,
                              int* sweeps_out, long long* prof_out,
                              void* stream) {
  if (B <= 0 || N <= 0 || M <= 0 || n_phases <= 0 || n_phases > MAX_PHASES)
    return (int)cudaErrorInvalidValue;
  Powers pw = {};
  for (int k = 0; k < n_phases; ++k) pw.v[k] = powers[k];
  // the widest mode whose total fits a block's shared memory
  int mode = MODE_GLOBAL;
  if (smem_layout(N, M, MODE_STAGED).total <= SMEM_LIMIT) mode = MODE_STAGED;
  if (M % 4 == 0 && (uintptr_t)cost % 16 == 0 &&
      smem_layout(N, M, MODE_VEC).total <= SMEM_LIMIT)
    mode = MODE_VEC;
  const size_t smem = smem_layout(N, M, mode).total;
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const auto kernel = mode == MODE_VEC      ? auction_kernel<MODE_VEC>
                      : mode == MODE_STAGED ? auction_kernel<MODE_STAGED>
                                            : auction_kernel<MODE_GLOBAL>;
  // raised once for each kernel and size: the call costs more host time
  // than a short solve takes on the card
  static size_t allowed[3] = {48 * 1024, 48 * 1024, 48 * 1024};
  if (smem > allowed[mode]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    allowed[mode] = smem;
  }
  kernel<<<B, THREADS, smem, (cudaStream_t)stream>>>(
      cost, cost_bstride, row_mask, col_mask, thresh, pw, N, M, n_phases,
      max_iters, r2c_out, c2r_out, sweeps_out, prof_out);
  return (int)cudaGetLastError();
}

// The widest way of holding K4's weights whose layout fits a block's
// shared memory; -1 if none does.
static int twin_mode(int N, int M, const float* cost) {
  int mode = -1;
  if (twin_layout(N, M, MODE_GLOBAL).total <= SMEM_LIMIT) mode = MODE_GLOBAL;
  if (twin_layout(N, M, MODE_STAGED).total <= SMEM_LIMIT) mode = MODE_STAGED;
  if (M % 4 == 0 && (uintptr_t)cost % 16 == 0 &&
      twin_layout(N, M, MODE_VEC).total <= SMEM_LIMIT)
    mode = MODE_VEC;
  return mode;
}

// Raise a kernel's dynamic shared memory limit once for each size: the
// call costs more host time than a short solve takes on the card.
template <typename Kernel>
static int allow_smem(Kernel kernel, size_t smem, size_t* allowed) {
  if (smem <= *allowed) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  *allowed = smem;
  return 0;
}

// K4, the twin: B problems, one block each, all phases in one launch. The
// arguments are auction_launch's; sweeps_out (nullable) receives each
// problem's release iterations plus bid rounds, prof_out (nullable) the
// profiling build's cycles as auction_launch's does.
extern "C" int auction_twin_launch(const float* cost, long long cost_bstride,
                                   const unsigned char* row_mask,
                                   const unsigned char* col_mask,
                                   const float* thresh, const float* powers,
                                   int B, int N, int M, int n_phases,
                                   int max_iters, int* r2c_out, int* c2r_out,
                                   int* sweeps_out, long long* prof_out,
                                   void* stream) {
  if (B <= 0 || N <= 0 || M <= 0 || n_phases <= 0 || n_phases > MAX_PHASES)
    return (int)cudaErrorInvalidValue;
  Powers pw = {};
  for (int k = 0; k < n_phases; ++k) pw.v[k] = powers[k];
  const int mode = twin_mode(N, M, cost);
  if (mode < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = twin_layout(N, M, mode).total;
  const auto kernel = mode == MODE_VEC      ? twin_kernel<MODE_VEC>
                      : mode == MODE_STAGED ? twin_kernel<MODE_STAGED>
                                            : twin_kernel<MODE_GLOBAL>;
  static size_t allowed[3] = {48 * 1024, 48 * 1024, 48 * 1024};
  const int e = allow_smem(kernel, smem, &allowed[mode]);
  if (e != 0) return e;
  kernel<<<B, THREADS, smem, (cudaStream_t)stream>>>(
      cost, cost_bstride, row_mask, col_mask, thresh, pw, N, M, n_phases,
      max_iters, r2c_out, c2r_out, sweeps_out, prof_out);
  return (int)cudaGetLastError();
}

// K4's cascade: matching_cascade of B problems, one block each, all
// `depth` levels in one launch. tsu: (B, N) int32 time_since_update; level
// l solves the rows row_mask & (tsu == 1 + l). r2c_out (B, N) and c2r_out
// (B, M) receive the merged matching, sweeps_out (nullable) each level's
// sweeps (B, depth); the other arguments are auction_twin_launch's (no
// profile).
extern "C" int auction_twin_cascade_launch(
    const float* cost, long long cost_bstride, const unsigned char* row_mask,
    const unsigned char* col_mask, const int* tsu, const float* thresh,
    const float* powers, int B, int N, int M, int depth, int n_phases,
    int max_iters, int* r2c_out, int* c2r_out, int* sweeps_out,
    void* stream) {
  if (B <= 0 || N <= 0 || M <= 0 || depth < 0 || n_phases <= 0 ||
      n_phases > MAX_PHASES)
    return (int)cudaErrorInvalidValue;
  Powers pw = {};
  for (int k = 0; k < n_phases; ++k) pw.v[k] = powers[k];
  const int mode = twin_mode(N, M, cost);
  if (mode < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = twin_layout(N, M, mode).total;
  const auto kernel = mode == MODE_VEC ? twin_cascade_kernel<MODE_VEC>
                      : mode == MODE_STAGED
                          ? twin_cascade_kernel<MODE_STAGED>
                          : twin_cascade_kernel<MODE_GLOBAL>;
  static size_t allowed[3] = {48 * 1024, 48 * 1024, 48 * 1024};
  const int e = allow_smem(kernel, smem, &allowed[mode]);
  if (e != 0) return e;
  kernel<<<B, THREADS, smem, (cudaStream_t)stream>>>(
      cost, cost_bstride, row_mask, col_mask, tsu, thresh, pw, N, M, depth,
      n_phases, max_iters, r2c_out, c2r_out, sweeps_out);
  return (int)cudaGetLastError();
}
