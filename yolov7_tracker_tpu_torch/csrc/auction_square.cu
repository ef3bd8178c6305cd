// Square lapjv-extended auction (K1: one problem, K3: B problems) for
// Hopper, sm_90a.
//
// Replaces the Pallas TPU kernels _auction_kernel / masked_assignment_pallas
// (pallas_call at yolov7_tracker_tpu/ops/pallas_auction.py:196) and
// _auction_kernel_batched / masked_assignment_pallas_batched (:631). Same
// function: the (n, m) cost problem with cost limit t becomes a max-weight
// perfect matching on the S x S matrix, S = n + m, with
//   real row i < n:  w(i, j < m) = -c(i, j),  c = min(cost, t + 1) on a
//                    masked-in pair and t + 1 otherwise;  w(i, m + i) = -t/2
//   dummy row n + j: w(n + j, j) = -t/2;  w(n + j, m + k) = -jitter(j, k),
//                    jitter = ((37 j + k) mod 97) * 1e-6 / 97
//   everything else -1e9,
// solved by an eps-scaled Jacobi auction that starts from the all-dummies
// matching (real row i holds column m + i, dummy row n + j holds column j),
// releases at the start of each phase the pairs that violate
// eps-complementary-slackness, then runs bid sweeps until no row is
// unassigned; pairs are gated by cost <= t on output. The plain PyTorch
// version beside it (ops/auction_square.py: masked_assignment_square_torch)
// computes the same bits: every step is a max, a min, a compare or one
// rounded add, written with __fadd_rn/__fsub_rn/__fmul_rn (plus
// -fmad=false) so that no multiply-add is contracted.
//
// What bounds it on the card: not bytes (one 150 KB cost matrix in, two
// index vectors out) and not arithmetic, but latency. The dummy-dummy
// block lets free dummies fight eps price wars, so a solve is a chain of
// hundreds to a few thousand sweeps, each of which must see the prices the
// one before it left, and in most of them one to four rows bid. A sweep is
// therefore a few hundred dependent operations of one warp, at four to
// five cycles each with nothing to hide them behind; the block barriers
// between them cost tens of cycles. The design shortens that chain and
// does not carry the TPU kernel over:
//   * the S x S matrix (733 KB at 128 x 300) is never built. A row's
//     finite entries have a closed form -- a real row has its m real
//     columns and its own dummy column, a dummy row its own real column
//     and the n jittered dummy columns -- and the -1e9 entries only ever
//     enter a row's second-best value through the masked-out best column
//     itself, which fmaxf(v2, -1e9) reproduces. The TPU kernel's padding
//     of S to 128 lanes is dropped too: a padding row holds its own
//     padding column at weight 1.0 from start to end and never bids;
//   * only the UNASSIGNED rows bid (assigned rows bid -1e9 in the TPU form
//     and change nothing), and they are never searched for: the bidders of
//     sweep k + 1 are the losers of sweep k and the rows it evicted, at
//     most one for each bidder, so their number never grows. A warp
//     carries one bidder in a register from sweep to sweep, and a sweep is
//     scan and bid, barrier, award, barrier. While more rows bid than the
//     block has warps (the first sweeps after a release) they stand in a
//     list that the winners hand on; when one bidder is left its warp
//     finishes the phase alone, with no barrier at all;
//   * one warp scans a row. The real block -c is staged in shared memory
//     when it fits (128 x 300 f32 = 150 KB does) beside a 3.5 KB table of
//     the jitter, so that a lane takes four columns a 16-byte load, three
//     loads in flight for a real row and one for a dummy row; otherwise
//     (256 x 300) -c is recomputed from the cost matrix and the masks,
//     read through L2, a column a load. A lane keeps its top two without a
//     branch, and the warp's come from three redux.sync on the floats'
//     order-preserving integer images; all are exact, since (value, lowest
//     column) is a total order and a merge in any grouping gives the same
//     top two;
//   * a column's winner -- highest bid, lowest row on a tie -- is one
//     64-bit atomicMax in shared memory on (bid, ~row). No key is cleared
//     by a pass: the winner clears its own, one sweep late, in the other of
//     two key arrays taken in turn, so that no bidder still reads it;
//   * all phases and sweeps of a problem run in ONE launch, one thread
//     block per problem. K3 gives each problem of the batch its own block,
//     and a block leaves its loop when ITS problem has no unassigned row.
//     That computes what the lockstep TPU kernel computes: there a problem
//     with no unassigned row bids -1e9 everywhere, so its candidate set is
//     empty and a sweep leaves it unchanged, while the max_iters cap counts
//     the same sweeps for a problem that never settles.
// Tried on the card and left out: 256 and 1024 threads a block (slower:
// see THREADS), and a row's cached top two, which a count on the CPU
// (tools/square_top2_cache_count.py) finds valid at one bid in thirteen.

#include <cuda_runtime.h>
#include <climits>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_F = -1e9f;
// 16 warps: 256 threads were 7 to 21% slower on the paths' problems (more
// sweeps with more bidders than warps) and 1024 leave 64 registers a thread,
// which spills
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
// f32 constants rounded from double, as the JAX weak-typed ones are
constexpr float JIT_UNIT = (float)(1e-6 / 97.0);
constexpr float EPS_FLOOR = (float)2e-4;
constexpr int MAX_PHASES = 8;
// a block's shared memory, less room for the static counters
constexpr size_t SMEM_LIMIT = 232448 - 256;

// Parts of a solve whose clock cycles the profiling build (-DAUCTION_PROFILE)
// sums on lane 0 of every warp, into (B, PROFILE_WARPS, P_SLOTS). P_LONG is
// all of the long-list sweeps and P_LONG_SWEEPS their number (no cycles);
// P_SOLO the sweeps this warp ran alone for the last bidder, P_SOLO_SWEEPS
// their number and P_SOLO_WAIT the wait for another warp's; the slots from
// P_TOP (loop control, the deferred key clear) to P_BAR_AWARD are the parts
// of a shared-out sweep, in which a warp without a bidder waits in the two
// barriers.
enum {
  P_STAGE, P_RELEASE, P_LONG, P_TOP, P_SCAN, P_BID, P_BAR_BID, P_AWARD,
  P_BAR_AWARD, P_SOLO, P_SOLO_WAIT, P_GATE, P_LONG_SWEEPS, P_SOLO_SWEEPS,
  P_SLOTS
};
constexpr int PROFILE_WARPS = 32;

#ifdef AUCTION_PROFILE
#define PROF(slot)                        \
  do {                                    \
    if (lane == 0) {                      \
      const long long prof_t = clock64(); \
      prof[slot] += prof_t - prof_last;   \
      prof_last = prof_t;                 \
    }                                     \
  } while (0)
#else
#define PROF(slot) \
  do {             \
  } while (0)
#endif

// phase_factor ** (1 .. n_phases) in float32, computed by the wrapper
struct Powers {
  float v[MAX_PHASES];
};

// How a block holds the weights: read from the cost matrix through L2,
// staged in shared memory, or staged with every row 16-byte aligned (n and
// m multiples of 4) beside a table of the dummy block's jitter, so that a
// lane scans four columns a load.
enum { MODE_GLOBAL = 0, MODE_STAGED = 1, MODE_VEC = 2 };

// the jitter table: 4 shifted copies of this many floats
__host__ __device__ inline int jit_len(int n) { return n + 96; }

// Byte offsets of a block's arrays in dynamic shared memory, each a
// multiple of 16.
struct Layout {
  size_t ws, jit, prices, key0, key1, r2c, c2r, list0, list1, best, bid,
      total;
};

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~(size_t)15;
}

__host__ __device__ inline Layout smem_layout(int n, int m, int mode) {
  const size_t s = (size_t)n + m;
  Layout l;
  l.ws = 0;
  l.jit = align16(mode != MODE_GLOBAL ? (size_t)n * m * 4 : 0);
  l.prices = align16(l.jit +
                     (mode == MODE_VEC ? (size_t)jit_len(n) * 16 : 0));
  l.key0 = align16(l.prices + s * 4);
  l.key1 = align16(l.key0 + s * 8);
  l.r2c = align16(l.key1 + s * 8);
  l.c2r = align16(l.r2c + s * 4);
  l.list0 = align16(l.c2r + s * 4);
  l.list1 = align16(l.list0 + s * 4);
  l.best = align16(l.list1 + s * 4);
  l.bid = align16(l.best + s * 4);
  l.total = align16(l.bid + s * 4);
  return l;
}

struct Problem {
  const float* cost;              // (N, M) row-major
  const unsigned char* row_mask;  // (N,)
  const unsigned char* col_mask;  // (M,)
  const float* ws;                // (N, M) staged -c, or null
  const float* jit;               // (4, jit_len) jitter table, MODE_VEC
  float thresh;
  float lim;   // thresh + 1: the clamp of over-limit and masked costs
  float half;  // -thresh / 2: a row's or column's reserved dummy
  int n, m;
};

// -c(i, j) of the real block, from the cost matrix. (x > lim ? lim : x)
// keeps a NaN cost a NaN, as the plain version's minimum does.
__device__ __forceinline__ float real_weight(const Problem& p, int i, int j) {
  float c = p.lim;
  if (p.row_mask[i] && p.col_mask[j]) {
    const float x = p.cost[(int64_t)i * p.m + j];
    c = x > p.lim ? p.lim : x;
  }
  return -c;
}

__device__ __forceinline__ float staged_weight(const Problem& p, int i,
                                               int j) {
  return p.ws ? p.ws[i * p.m + j] : real_weight(p, i, j);
}

// -jitter of the dummy-dummy block for t = (37 j + k) mod 97, which is
// exact in f32 as in the TPU form; the product is one rounded multiply
__device__ __forceinline__ float jitter_weight(int t) {
  return -__fmul_rn((float)t, JIT_UNIT);
}

__device__ __forceinline__ float dummy_weight(int j, int k) {
  return jitter_weight((j * 37 + k) % 97);
}

// w(r, col) of the extended matrix
__device__ __forceinline__ float ext_weight(const Problem& p, int r,
                                            int col) {
  if (r < p.n) {
    if (col < p.m) return staged_weight(p, r, col);
    return (col - p.m == r) ? p.half : NEG_F;
  }
  const int j = r - p.n;
  if (col < p.m) return (col == j) ? p.half : NEG_F;
  return dummy_weight(j, col - p.m);
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

// One warp scans the finite entries of extended row r at the given prices:
// b1 = best value, bi = its first column, b2 = second-best value (a
// duplicate of the best value counts as second best). Valid in all lanes.
// The lanes share out the row's real columns (a real row) or its dummy
// columns (a dummy row); the row's one reserved column is merged last.
template <bool VEC>
__device__ __forceinline__ void row_top2(const Problem& p,
                                         const float* prices, int r,
                                         int lane, float& b1, int& bi,
                                         float& b2) {
  b1 = -INFINITY;
  b2 = -INFINITY;
  bi = INT_MAX;
  const bool real = r < p.n;
  const int j = r - p.n;
  const int own = real ? p.m + r : j;
  const float own_v = __fsub_rn(p.half, prices[own]);
  if (VEC) {
    // four columns a load. A real row of ws is m * 4 bytes, a multiple of
    // 16. Dummy row j's weights are jitter((37 j + k) mod 97), k < n: with
    // (37 j) mod 97 = 4 a + c they are the n entries from 4 a on of the
    // table's copy c, which holds jitter((x + c) mod 97) at x.
    const float4* w4;
    const float4* p4;
    int col, quads;
    if (real) {
      w4 = reinterpret_cast<const float4*>(p.ws + r * p.m);
      p4 = reinterpret_cast<const float4*>(prices);
      col = 0;
      quads = p.m >> 2;
    } else {
      const int t = (j * 37) % 97;
      w4 = reinterpret_cast<const float4*>(p.jit + (t & 3) * jit_len(p.n) +
                                           (t & ~3));
      p4 = reinterpret_cast<const float4*>(prices + p.m);
      col = p.m;
      quads = p.n >> 2;
    }
    col += lane << 2;
    // three loads a lane in flight (a real row of 300 columns is 75 quads:
    // one pass); a dummy row of 128 columns is one quad a lane
#pragma unroll 1
    for (int q = lane; q < quads; q += 96, col += 384) {
      const bool more1 = q + 32 < quads, more2 = q + 64 < quads;
      const float4 wa = w4[q], pa = p4[q];
      float4 wb, pb, wc, pc;
      if (more1) {
        wb = w4[q + 32];
        pb = p4[q + 32];
      }
      if (more2) {
        wc = w4[q + 64];
        pc = p4[q + 64];
      }
      consider4(wa, pa, col, b1, bi, b2);
      if (more1) consider4(wb, pb, col + 128, b1, bi, b2);
      if (more2) consider4(wc, pc, col + 256, b1, bi, b2);
    }
  } else if (real) {
#pragma unroll 1
    for (int c = lane; c < p.m; c += 32)
      consider(__fsub_rn(staged_weight(p, r, c), prices[c]), c, b1, bi, b2);
  } else {
#pragma unroll 1
    for (int k = lane; k < p.n; k += 32)
      consider(__fsub_rn(dummy_weight(j, k), prices[p.m + k]), p.m + k, b1,
               bi, b2);
  }
  // Three hardware reduces on integer images: the best value, the lowest
  // column among the lanes that hold it, and the best of what is left (the
  // winning lane's second value, every other lane's first).
  const int i1 = float_image(__fadd_rn(b1, 0.0f));
  const int m1 = __reduce_max_sync(FULL, i1);
  const int first = __reduce_min_sync(FULL, i1 == m1 ? bi : INT_MAX);
  const int m2 = __reduce_max_sync(
      FULL, bi == first ? float_image(__fadd_rn(b2, 0.0f)) : i1);
  b1 = image_float(m1);
  bi = first;
  b2 = image_float(m2);
  // the reserved column, by the same order: value, then lowest column
  if (own_v > b1 || (own_v == b1 && own < bi)) {
    b2 = b1;
    b1 = own_v;
    bi = own;
  } else {
    b2 = fmaxf(b2, own_v);
  }
}

// The best value alone of extended row r, for the release. Valid in all
// lanes.
template <bool VEC>
__device__ __forceinline__ float row_max(const Problem& p,
                                         const float* prices, int r,
                                         int lane) {
  const bool real = r < p.n;
  const int j = r - p.n;
  float b1 = lane == 0 ? __fsub_rn(p.half, prices[real ? p.m + r : j])
                       : -INFINITY;
  if (VEC) {
    const float4* w4;
    const float4* p4;
    int quads;
    if (real) {
      w4 = reinterpret_cast<const float4*>(p.ws + r * p.m);
      p4 = reinterpret_cast<const float4*>(prices);
      quads = p.m >> 2;
    } else {
      const int t = (j * 37) % 97;
      w4 = reinterpret_cast<const float4*>(p.jit + (t & 3) * jit_len(p.n) +
                                           (t & ~3));
      p4 = reinterpret_cast<const float4*>(prices + p.m);
      quads = p.n >> 2;
    }
    for (int q = lane; q < quads; q += 32) {
      const float4 w = w4[q];
      const float4 pr = p4[q];
      b1 = fmaxf(fmaxf(b1, fmaxf(__fsub_rn(w.x, pr.x), __fsub_rn(w.y, pr.y))),
                 fmaxf(__fsub_rn(w.z, pr.z), __fsub_rn(w.w, pr.w)));
    }
  } else if (real) {
    for (int c = lane; c < p.m; c += 32)
      b1 = fmaxf(b1, __fsub_rn(staged_weight(p, r, c), prices[c]));
  } else {
    for (int k = lane; k < p.n; k += 32)
      b1 = fmaxf(b1, __fsub_rn(dummy_weight(j, k), prices[p.m + k]));
  }
  return image_float(
      __reduce_max_sync(FULL, float_image(__fadd_rn(b1, 0.0f))));
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

// The bid of a row whose top two are (b1 at column bi, b2): the column's
// price raised by min(b1 - b2, cap) + eps.
__device__ __forceinline__ float bid_value(const float* prices, float b1,
                                           int bi, float b2, float cap,
                                           float eps) {
  return __fadd_rn(
      __fadd_rn(prices[bi], fminf(__fsub_rn(b1, fmaxf(b2, NEG_F)), cap)),
      eps);
}

// All phases of problem b, by one thread block. Inlined into both kernels,
// once for each kind of scan (VEC: four columns a load).
template <bool VEC>
__device__ __forceinline__ void solve_problem(
    int b, const float* __restrict__ cost,
    const unsigned char* __restrict__ row_mask,
    const unsigned char* __restrict__ col_mask,
    const float* __restrict__ thresh, const Powers& powers, int n, int m,
    int n_phases, int max_iters, int mode, int* __restrict__ r2c_out,
    int* __restrict__ c2r_out, int* __restrict__ sweeps_out,
    long long* __restrict__ cells_out, long long* __restrict__ prof_out) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int s = n + m;
  const bool count = cells_out != nullptr;
#ifdef AUCTION_PROFILE
  long long prof[P_SLOTS] = {};
  long long prof_last = clock64();
#endif

  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay = smem_layout(n, m, mode);
  float* ws = reinterpret_cast<float*>(smem + lay.ws);       // (n*m,) staged
  float* jit = reinterpret_cast<float*>(smem + lay.jit);     // (4, jit_len)
  float* prices = reinterpret_cast<float*>(smem + lay.prices);  // (s,)
  // a column's best bid of this sweep, in two arrays taken in turn
  unsigned long long* key0 =
      reinterpret_cast<unsigned long long*>(smem + lay.key0);   // (s,)
  unsigned long long* key1 =
      reinterpret_cast<unsigned long long*>(smem + lay.key1);   // (s,)
  int* r2c = reinterpret_cast<int*>(smem + lay.r2c);         // (s,)
  int* c2r = reinterpret_cast<int*>(smem + lay.c2r);         // (s,)
  // long lists of unassigned rows: this sweep's and the next one's
  int* list0 = reinterpret_cast<int*>(smem + lay.list0);     // (s,)
  int* list1 = reinterpret_cast<int*>(smem + lay.list1);     // (s,)
  int* best = reinterpret_cast<int*>(smem + lay.best);       // by list slot
  float* bid = reinterpret_cast<float*>(smem + lay.bid);     // by list slot
  __shared__ int n_listed[2];
  __shared__ int solo_sweeps;   // a phase's sweeps, from the last bidder
  // debug count (cells_out): the finite cells of the reference sweep --
  // each phase's release scans every row, each sweep the unassigned rows
  __shared__ unsigned long long cells;
  const int real_len = m + 1, dummy_len = n + 1;

  Problem p;
  p.cost = cost + (int64_t)b * n * m;
  p.row_mask = row_mask + (int64_t)b * n;
  p.col_mask = col_mask + (int64_t)b * m;
  p.ws = mode != MODE_GLOBAL ? ws : nullptr;
  p.jit = jit;
  p.thresh = thresh[b];
  p.lim = __fadd_rn(p.thresh, 1.0f);
  p.half = __fdiv_rn(-p.thresh, 2.0f);
  p.n = n;
  p.m = m;
  // eps schedule and bid cap in the float32 arithmetic of
  // pallas_auction.py:185-194
  const float scale = p.lim;
  const float cap = __fmul_rn(2.0f, scale);

  // initial matching through the reserved dummies
  for (int r = tid; r < s; r += THREADS) {
    prices[r] = 0.0f;
    key0[r] = key1[r] = 0ull;
    r2c[r] = r < n ? r + m : r - n;
    c2r[r] = r < m ? r + n : r - m;
  }
  if (tid == 0) cells = 0ull;
  if (mode != MODE_GLOBAL) {
    // p.ws stays null while the weights are read from the cost matrix
    Problem q = p;
    q.ws = nullptr;
    for (int i = warp; i < n; i += WARPS)
      for (int j = lane; j < m; j += 32) ws[i * m + j] = real_weight(q, i, j);
  }
  if (VEC) {
    const int len = jit_len(n);
    for (int c = warp; c < 4; c += WARPS)
      for (int x = lane; x < len; x += 32)
        jit[c * len + x] = jitter_weight((x + c) % 97);
  }
  __syncthreads();
  PROF(P_STAGE);

  for (int ph = 0; ph < n_phases; ++ph) {
    const float eps = fmaxf(__fdiv_rn(scale, powers.v[ph]), EPS_FLOOR);

    // ---- warm-start release: a pair stays iff it satisfies eps-CS at
    // the current prices; c2r and the list of unassigned rows are rebuilt
    for (int r = warp; r < s; r += WARPS) {
      const float v1 = row_max<VEC>(p, prices, r, lane);
      if (lane == 0) {
        const int rc = r2c[r];
        if (rc >= 0) {
          const float cur =
              fmaxf(__fsub_rn(ext_weight(p, r, rc), prices[rc]), NEG_F);
          if (!(cur >= __fsub_rn(v1, eps))) r2c[r] = -1;
        }
      }
    }
    for (int j = tid; j < s; j += THREADS) c2r[j] = -1;
    if (tid == 0) n_listed[0] = 0;
    __syncthreads();
    for (int r = tid; r < s; r += THREADS) {
      const int rc = r2c[r];
      if (rc >= 0)
        c2r[rc] = r;
      else
        list0[atomicAdd(&n_listed[0], 1)] = r;
    }
    __syncthreads();
    if (tid == 0 && count)
      cells += (unsigned long long)n * real_len +
               (unsigned long long)m * dummy_len;
    PROF(P_RELEASE);

    // ---- bid sweeps until no row is unassigned. In a sweep every
    // unassigned row bids for its first best column at the prices the
    // sweep before left; a column keeps its best bid in a key; then each
    // bid-on column goes to its highest bidder (lowest row on a tie), whose
    // bid is its new price, and its previous owner is evicted. An evicted
    // row owned a column, so it was no bidder: the next sweep's bidders are
    // this sweep's losers and its evicted rows, one for each bidder at
    // most, and their number never grows.
    int it = 0;
    int cur = 0;
    int n_un = n_listed[0];

    // Long lists (the first sweeps after a release): the bidders stand in
    // a list, the warps take them round by round, and the winners hand the
    // evicted rows on to the next list.
    while (it < max_iters && n_un > WARPS) {
      const int* list = cur ? list1 : list0;
      int* next = cur ? list0 : list1;
      if (tid == 0) n_listed[cur ^ 1] = 0;
      // A scan leaves its row's top two in every lane: lane i keeps those
      // of the warp's i-th bidder, and the lanes then bid side by side.
      float my_b1 = 0.0f, my_b2 = 0.0f;
      int my_bi = 0, my_row = -1, my_k = 0;
      auto bid_kept = [&]() {
        if (my_row >= 0) {
          const float bv = bid_value(prices, my_b1, my_bi, my_b2, cap, eps);
          best[my_k] = my_bi;
          bid[my_k] = bv;
          atomicMax(&key0[my_bi], bid_key(bv, my_row));
          if (count)
            atomicAdd(&cells,
                      (unsigned long long)(my_row < n ? real_len : dummy_len));
        }
        my_row = -1;
      };
      int turn = 0;
      for (int k = warp; k < n_un; k += WARPS) {
        const int r = list[k];
        float b1, b2;
        int bi;
        row_top2<VEC>(p, prices, r, lane, b1, bi, b2);
        if (lane == turn) {
          my_b1 = b1;
          my_bi = bi;
          my_b2 = b2;
          my_row = r;
          my_k = k;
        }
        if (++turn == 32) {
          bid_kept();
          turn = 0;
        }
      }
      bid_kept();
      __syncthreads();
      // mark the losers; then, once every bidder has read its column's
      // key, the winners award and clear the key
      for (int k = tid; k < n_un; k += THREADS) {
        const int j = best[k];
        if (key_row(key0[j]) != list[k]) best[k] = ~j;
      }
      __syncthreads();
      for (int k = tid; k < n_un; k += THREADS) {
        const int r = list[k];
        const int j = best[k];
        int hand_on = r;
        if (j >= 0) {
          hand_on = c2r[j];
          if (hand_on >= 0) r2c[hand_on] = -1;
          c2r[j] = r;
          r2c[r] = j;
          prices[j] = bid[k];
          key0[j] = 0ull;
        }
        if (hand_on >= 0) next[atomicAdd(&n_listed[cur ^ 1], 1)] = hand_on;
      }
      __syncthreads();
      PROF(P_LONG);
#ifdef AUCTION_PROFILE
      ++prof[P_LONG_SWEEPS];
#endif
      cur ^= 1;
      n_un = n_listed[cur];
      ++it;
    }

    // Short lists, nearly every sweep: each warp carries one bidder in a
    // register from sweep to sweep (a loser bids again, a winner takes
    // over the row it evicted), so that a sweep is: scan and bid, barrier,
    // award, barrier, with no list and nothing to clear in between. The
    // keys of successive sweeps stand in two arrays taken in turn; a winner
    // clears its key after the sweep's second barrier, when every bidder
    // has read it, and that array is next bid on after the following
    // sweep's second barrier.
    int row = warp < n_un ? (cur ? list1 : list0)[warp] : -1;
    int clear = -1;
    unsigned long long* key = key0;
    unsigned long long* key_before = key1;
    while (it < max_iters && n_un > 1) {
      if (lane == 0 && clear >= 0) key_before[clear] = 0ull;
      clear = -1;
      PROF(P_TOP);
      float bv = 0.0f;
      int bi = 0, prev = -1;
      if (row >= 0) {
        float b1, b2;
        row_top2<VEC>(p, prices, row, lane, b1, bi, b2);
        PROF(P_SCAN);
        bv = bid_value(prices, b1, bi, b2, cap, eps);
        prev = c2r[bi];   // the owner until this sweep's awards
        if (lane == 0) {
          atomicMax(&key[bi], bid_key(bv, row));
          if (count)
            atomicAdd(&cells,
                      (unsigned long long)(row < n ? real_len : dummy_len));
        }
        PROF(P_BID);
      }
      __syncthreads();
      PROF(P_BAR_BID);
      if (row >= 0 && key_row(key[bi]) == row) {
        // one warp wins each bid-on column and writes it
        if (lane == 0) {
          if (prev >= 0) r2c[prev] = -1;
          c2r[bi] = row;
          r2c[row] = bi;
          prices[bi] = bv;
        }
        clear = bi;
        row = prev;
      }
      PROF(P_AWARD);
      n_un = __syncthreads_count(row >= 0) >> 5;
      PROF(P_BAR_AWARD);
      unsigned long long* const swap = key;
      key = key_before;
      key_before = swap;
      ++it;
    }
    if (lane == 0 && clear >= 0) key_before[clear] = 0ull;

    // One bidder left, and alone until the phase ends, since the number of
    // bidders never grows: its warp runs the remaining sweeps by itself,
    // each won at once, with no key and no block barrier, while the other
    // warps wait at the barrier below.
    if (n_un == 1 && it < max_iters) {
      const bool mine = row >= 0;
      while (it < max_iters && row >= 0) {
        float b1, b2;
        int bi;
        row_top2<VEC>(p, prices, row, lane, b1, bi, b2);
        const float bv = bid_value(prices, b1, bi, b2, cap, eps);
        const int prev = c2r[bi];
        __syncwarp();
        if (lane == 0) {
          if (prev >= 0) r2c[prev] = -1;
          c2r[bi] = row;
          r2c[row] = bi;
          prices[bi] = bv;
          if (count) cells += row < n ? real_len : dummy_len;
        }
        __syncwarp();
        row = prev;
        ++it;
        PROF(P_SOLO);
#ifdef AUCTION_PROFILE
        if (lane == 0) ++prof[P_SOLO_SWEEPS];
#endif
      }
      if (mine && lane == 0) solo_sweeps = it;
      __syncthreads();
      it = solo_sweeps;
      PROF(P_SOLO_WAIT);
    }
    if (sweeps_out != nullptr && tid == 0)
      sweeps_out[(int64_t)b * n_phases + ph] = it;
  }

  // ---- gate: keep real pairs with c <= thresh, i.e. masked-in pairs with
  // cost <= thresh; rebuild c2r from them
  int* out_r = r2c_out + (int64_t)b * n;
  int* out_c = c2r_out + (int64_t)b * m;
  for (int j = tid; j < m; j += THREADS) out_c[j] = -1;
  __syncthreads();
  if (count && tid == 0) cells_out[b] = (long long)cells;
  for (int i = tid; i < n; i += THREADS) {
    const int j = r2c[i];
    const bool keep = j >= 0 && j < m && p.row_mask[i] && p.col_mask[j] &&
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

#define SOLVE(problem)                                                       \
  do {                                                                       \
    if (mode == MODE_VEC)                                                    \
      solve_problem<true>(problem, cost, row_mask, col_mask, thresh, powers, \
                          n, m, n_phases, max_iters, mode, r2c_out, c2r_out, \
                          sweeps_out, cells_out, prof_out);                  \
    else                                                                     \
      solve_problem<false>(problem, cost, row_mask, col_mask, thresh,        \
                           powers, n, m, n_phases, max_iters, mode, r2c_out, \
                           c2r_out, sweeps_out, cells_out, prof_out);        \
  } while (0)

// K1: one problem, one thread block.
__global__ void __launch_bounds__(THREADS, 1)
auction_square_kernel(const float* __restrict__ cost,
                      const unsigned char* __restrict__ row_mask,
                      const unsigned char* __restrict__ col_mask,
                      const float* __restrict__ thresh, Powers powers, int n,
                      int m, int n_phases, int max_iters, int mode,
                      int* __restrict__ r2c_out, int* __restrict__ c2r_out,
                      int* __restrict__ sweeps_out,
                      long long* __restrict__ cells_out,
                      long long* __restrict__ prof_out) {
  SOLVE(0);
}

// K3: B problems in one launch, one thread block per problem.
__global__ void __launch_bounds__(THREADS, 1)
auction_square_batched_kernel(const float* __restrict__ cost,
                              const unsigned char* __restrict__ row_mask,
                              const unsigned char* __restrict__ col_mask,
                              const float* __restrict__ thresh, Powers powers,
                              int n, int m, int n_phases, int max_iters,
                              int mode, int* __restrict__ r2c_out,
                              int* __restrict__ c2r_out,
                              int* __restrict__ sweeps_out,
                              long long* __restrict__ cells_out,
                              long long* __restrict__ prof_out) {
  SOLVE(blockIdx.x);
}

template <typename Kernel>
int launch(Kernel kernel, const float* cost, const unsigned char* row_mask,
           const unsigned char* col_mask, const float* thresh,
           const float* powers, int B, int N, int M, int n_phases,
           int max_iters, int* r2c_out, int* c2r_out, int* sweeps_out,
           long long* cells_out, long long* prof_out, void* stream) {
  if (B <= 0 || N <= 0 || M <= 0 || n_phases <= 0 || n_phases > MAX_PHASES)
    return (int)cudaErrorInvalidValue;
  Powers pw = {};
  for (int k = 0; k < n_phases; ++k) pw.v[k] = powers[k];
  // the widest mode whose real total fits a block's shared memory
  int mode = MODE_GLOBAL;
  if (smem_layout(N, M, MODE_STAGED).total <= SMEM_LIMIT) mode = MODE_STAGED;
  if (N % 4 == 0 && M % 4 == 0 &&
      smem_layout(N, M, MODE_VEC).total <= SMEM_LIMIT)
    mode = MODE_VEC;
  const size_t smem = smem_layout(N, M, mode).total;
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<B, THREADS, smem, (cudaStream_t)stream>>>(
      cost, row_mask, col_mask, thresh, pw, N, M, n_phases, max_iters, mode,
      r2c_out, c2r_out, sweeps_out, cells_out, prof_out);
  return (int)cudaGetLastError();
}

}  // namespace

// prof_out: (B, 32, 14) cycle sums of the profiling build, by warp and
// part; the build without -DAUCTION_PROFILE ignores it (pass null).
extern "C" int auction_square_launch(
    const float* cost, const unsigned char* row_mask,
    const unsigned char* col_mask, const float* thresh, const float* powers,
    int B, int N, int M, int n_phases, int max_iters, int* r2c_out,
    int* c2r_out, int* sweeps_out, long long* cells_out, long long* prof_out,
    void* stream) {
  if (B != 1) return (int)cudaErrorInvalidValue;
  return launch(auction_square_kernel, cost, row_mask, col_mask, thresh,
                powers, B, N, M, n_phases, max_iters, r2c_out, c2r_out,
                sweeps_out, cells_out, prof_out, stream);
}

extern "C" int auction_square_batched_launch(
    const float* cost, const unsigned char* row_mask,
    const unsigned char* col_mask, const float* thresh, const float* powers,
    int B, int N, int M, int n_phases, int max_iters, int* r2c_out,
    int* c2r_out, int* sweeps_out, long long* cells_out, long long* prof_out,
    void* stream) {
  return launch(auction_square_batched_kernel, cost, row_mask, col_mask,
                thresh, powers, B, N, M, n_phases, max_iters, r2c_out,
                c2r_out, sweeps_out, cells_out, prof_out, stream);
}
