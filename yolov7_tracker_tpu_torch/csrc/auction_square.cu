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
// index vectors out) and not arithmetic, but the chain of dependent
// sweeps: the dummy-dummy block lets free dummies fight eps price wars, so
// a solve takes hundreds to a few thousand sweeps, each of which must see
// the prices the one before it left. The design therefore makes a sweep
// as short as it can be instead of carrying the TPU kernel over:
//   * the S x S matrix (733 KB at 128 x 300) is never built. A row's
//     finite entries have a closed form -- a real row has its m real
//     columns and its own dummy column, a dummy row its own real column
//     and the n jittered dummy columns -- and the -1e9 entries only ever
//     enter a row's second-best value through the masked-out best column
//     itself, which fmaxf(v2, -1e9) reproduces. The TPU kernel's padding
//     of S to 128 lanes is dropped too: a padding row holds its own
//     padding column at weight 1.0 from start to end and never bids;
//   * the real block -c is staged in shared memory when it fits (128 x 300
//     f32 = 150 KB does), with prices, r2c, c2r, bids and the per-column
//     winner keys (14 KB at S = 428); otherwise (256 x 300) -c is
//     recomputed from the cost matrix and the masks, read through L2;
//   * a sweep touches only the UNASSIGNED rows (assigned rows bid -1e9 in
//     the TPU form and change nothing): they are compacted into a list,
//     one warp scans each listed row for its best column, second-best
//     value and bid, and the column's winner -- highest bid, lowest row on
//     a tie -- is one 64-bit atomicMax in shared memory on (bid, ~row);
//   * all phases and sweeps of a problem run in ONE launch, one thread
//     block per problem. K3 gives each problem of the batch its own block,
//     and a block leaves its loop when ITS problem has no unassigned row.
//     That computes what the lockstep TPU kernel computes: there a problem
//     with no unassigned row bids -1e9 everywhere, so its candidate set is
//     empty and a sweep leaves it unchanged, while the max_iters cap counts
//     the same sweeps for a problem that never settles.

#include <cuda_runtime.h>
#include <climits>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_F = -1e9f;
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
// f32 constants rounded from double, as the JAX weak-typed ones are
constexpr float JIT_UNIT = (float)(1e-6 / 97.0);
constexpr float EPS_FLOOR = (float)2e-4;
constexpr int MAX_PHASES = 8;
// a block's shared memory, less room for the static counter
constexpr size_t SMEM_LIMIT = 232448 - 256;
// bytes of per-row/column state per unit of S: key (8) + prices, bid,
// r2c, c2r, best, list (4 each)
constexpr size_t STATE_BYTES = 8 + 6 * 4;

// phase_factor ** (1 .. n_phases) in float32, computed by the wrapper
struct Powers {
  float v[MAX_PHASES];
};

struct Problem {
  const float* cost;              // (N, M) row-major
  const unsigned char* row_mask;  // (N,)
  const unsigned char* col_mask;  // (M,)
  const float* ws;                // (N, M) staged -c, or null
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

// -jitter(j, k) of the dummy-dummy block; (37 j + k) mod 97 is exact in
// f32 as in the TPU form, the product is one rounded multiply
__device__ __forceinline__ float dummy_weight(int j, int k) {
  return -__fmul_rn((float)((j * 37 + k) % 97), JIT_UNIT);
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

// One warp scans the finite entries of extended row r at the given prices:
// b1 = best value, bi = its first column, b2 = second-best value (a
// duplicate of the best value counts as second best). Valid in all lanes.
__device__ __forceinline__ void row_top2(const Problem& p,
                                         const float* prices, int r,
                                         int lane, float& b1, int& bi,
                                         float& b2) {
  b1 = -INFINITY;
  b2 = -INFINITY;
  bi = INT_MAX;
  auto consider = [&](float w, int col) {
    const float v = __fsub_rn(w, prices[col]);
    if (v > b1 || (v == b1 && col < bi)) {
      b2 = b1;
      b1 = v;
      bi = col;
    } else {
      b2 = fmaxf(b2, v);
    }
  };
  if (r < p.n) {
    for (int j = lane; j < p.m; j += 32) consider(staged_weight(p, r, j), j);
    if (lane == 0) consider(p.half, p.m + r);
  } else {
    const int j = r - p.n;
    if (lane == 0) consider(p.half, j);
    for (int k = lane; k < p.n; k += 32)
      consider(dummy_weight(j, k), p.m + k);
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float o1 = __shfl_xor_sync(0xffffffffu, b1, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    const float o2 = __shfl_xor_sync(0xffffffffu, b2, off);
    if (o1 > b1 || (o1 == b1 && oi < bi)) {
      b2 = fmaxf(o2, b1);
      b1 = o1;
      bi = oi;
    } else {
      b2 = fmaxf(b2, o1);
    }
  }
}

// (bid, row) as one key whose unsigned order is: higher bid first, then
// lower row
__device__ __forceinline__ unsigned long long bid_key(float bid, int row) {
  unsigned u = __float_as_uint(bid);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (unsigned)(0x7fffffff - row);
}

__device__ __forceinline__ int key_row(unsigned long long key) {
  return 0x7fffffff - (int)(unsigned)(key & 0xffffffffull);
}

// All phases of problem b, by one thread block.
__device__ void solve_problem(int b, const float* __restrict__ cost,
                              const unsigned char* __restrict__ row_mask,
                              const unsigned char* __restrict__ col_mask,
                              const float* __restrict__ thresh,
                              const Powers& powers, int n, int m,
                              int n_phases, int max_iters, int staged,
                              int* __restrict__ r2c_out,
                              int* __restrict__ c2r_out,
                              int* __restrict__ sweeps_out,
                              long long* __restrict__ cells_out) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int s = n + m;

  Problem p;
  p.cost = cost + (int64_t)b * n * m;
  p.row_mask = row_mask + (int64_t)b * n;
  p.col_mask = col_mask + (int64_t)b * m;
  p.ws = nullptr;
  p.thresh = thresh[b];
  p.lim = __fadd_rn(p.thresh, 1.0f);
  p.half = __fdiv_rn(-p.thresh, 2.0f);
  p.n = n;
  p.m = m;
  // eps schedule and bid cap in the float32 arithmetic of
  // pallas_auction.py:185-194
  const float scale = p.lim;
  const float cap = __fmul_rn(2.0f, scale);

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* key =
      reinterpret_cast<unsigned long long*>(smem);     // (s,) column winner
  float* prices = reinterpret_cast<float*>(key + s);   // (s,)
  float* bid = prices + s;                             // (s,) by row
  int* r2c = reinterpret_cast<int*>(bid + s);          // (s,)
  int* c2r = r2c + s;                                  // (s,)
  int* best = c2r + s;                                 // (s,) by row
  int* list = best + s;                                // (s,) unassigned rows
  float* ws = reinterpret_cast<float*>(list + s);      // (n*m,) if staged
  __shared__ int n_listed;
  // debug count (cells_out): the finite cells this solve had to read --
  // each phase's release scans every row, each sweep the unassigned rows
  // (kept in shared memory, updated by thread 0 alone, so that the count
  // costs the threads no registers)
  __shared__ int n_listed_real;
  __shared__ long long cells;
  const int real_len = m + 1, dummy_len = n + 1;

  // initial matching through the reserved dummies
  for (int r = tid; r < s; r += THREADS) {
    prices[r] = 0.0f;
    r2c[r] = r < n ? r + m : r - n;
    c2r[r] = r < m ? r + n : r - m;
  }
  if (tid == 0) {
    n_listed = n_listed_real = 0;
    cells = 0;
  }
  if (staged) {
    for (int k = tid; k < n * m; k += THREADS)
      ws[k] = real_weight(p, k / m, k % m);
    p.ws = ws;
  }
  __syncthreads();

  for (int ph = 0; ph < n_phases; ++ph) {
    const float eps = fmaxf(__fdiv_rn(scale, powers.v[ph]), EPS_FLOOR);

    // ---- warm-start release: a pair stays iff it satisfies eps-CS at
    // the current prices; c2r is rebuilt from the pairs that stay
    for (int r = warp; r < s; r += WARPS) {
      float v1, v2;
      int bi;
      row_top2(p, prices, r, lane, v1, bi, v2);
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
    __syncthreads();
    for (int r = tid; r < s; r += THREADS)
      if (r2c[r] >= 0) c2r[r2c[r]] = r;
    __syncthreads();
    if (tid == 0 && cells_out != nullptr)
      cells += (long long)n * real_len + (long long)m * dummy_len;

    // ---- bid sweeps until no row is unassigned
    int it = 0;
    while (it < max_iters) {
      // list the unassigned rows, clear the column keys
      for (int r = tid; r < s; r += THREADS) {
        key[r] = 0ull;
        if (r2c[r] < 0) {
          list[atomicAdd(&n_listed, 1)] = r;
          if (cells_out != nullptr && r < n) atomicAdd(&n_listed_real, 1);
        }
      }
      __syncthreads();
      const int n_un = n_listed;
      if (n_un == 0) break;
      if (tid == 0 && cells_out != nullptr)
        cells += (long long)n_listed_real * real_len +
                 (long long)(n_un - n_listed_real) * dummy_len;

      // every unassigned row bids for its first best column, raising its
      // price by min(v1 - v2, cap) + eps
      for (int k = warp; k < n_un; k += WARPS) {
        const int r = list[k];
        float b1, b2;
        int bi;
        row_top2(p, prices, r, lane, b1, bi, b2);
        if (lane == 0) {
          const float v2 = fmaxf(b2, NEG_F);
          const float bv = __fadd_rn(
              __fadd_rn(prices[bi], fminf(__fsub_rn(b1, v2), cap)), eps);
          best[r] = bi;
          bid[r] = bv;
          atomicMax(&key[bi], bid_key(bv, r));
        }
      }
      __syncthreads();
      if (tid == 0) n_listed = n_listed_real = 0;

      // each bid-on column goes to its highest bidder (lowest row on a
      // tie) and its previous owner is evicted. One thread writes each
      // such column; an evicted row owned a column, so it is no bidder.
      for (int k = tid; k < n_un; k += THREADS) {
        const int r = list[k];
        const int j = best[r];
        if (key_row(key[j]) == r) {
          const int prev = c2r[j];
          if (prev >= 0) r2c[prev] = -1;
          c2r[j] = r;
          r2c[r] = j;
          prices[j] = bid[r];
        }
      }
      __syncthreads();
      ++it;
    }
    if (sweeps_out != nullptr && tid == 0)
      sweeps_out[(int64_t)b * n_phases + ph] = it;
  }

  if (cells_out != nullptr && tid == 0) cells_out[b] = cells;

  // ---- gate: keep real pairs with c <= thresh, i.e. masked-in pairs with
  // cost <= thresh; rebuild c2r from them
  int* out_r = r2c_out + (int64_t)b * n;
  int* out_c = c2r_out + (int64_t)b * m;
  for (int j = tid; j < m; j += THREADS) out_c[j] = -1;
  __syncthreads();
  for (int i = tid; i < n; i += THREADS) {
    const int j = r2c[i];
    const bool keep = j >= 0 && j < m && p.row_mask[i] && p.col_mask[j] &&
                      p.cost[(int64_t)i * m + j] <= p.thresh;
    out_r[i] = keep ? j : -1;
    if (keep) out_c[j] = i;
  }
}

// K1: one problem, one thread block.
__global__ void __launch_bounds__(THREADS)
auction_square_kernel(const float* __restrict__ cost,
                      const unsigned char* __restrict__ row_mask,
                      const unsigned char* __restrict__ col_mask,
                      const float* __restrict__ thresh, Powers powers, int n,
                      int m, int n_phases, int max_iters, int staged,
                      int* __restrict__ r2c_out, int* __restrict__ c2r_out,
                      int* __restrict__ sweeps_out,
                      long long* __restrict__ cells_out) {
  solve_problem(0, cost, row_mask, col_mask, thresh, powers, n, m, n_phases,
                max_iters, staged, r2c_out, c2r_out, sweeps_out, cells_out);
}

// K3: B problems in one launch, one thread block per problem.
__global__ void __launch_bounds__(THREADS)
auction_square_batched_kernel(const float* __restrict__ cost,
                              const unsigned char* __restrict__ row_mask,
                              const unsigned char* __restrict__ col_mask,
                              const float* __restrict__ thresh, Powers powers,
                              int n, int m, int n_phases, int max_iters,
                              int staged, int* __restrict__ r2c_out,
                              int* __restrict__ c2r_out,
                              int* __restrict__ sweeps_out,
                              long long* __restrict__ cells_out) {
  solve_problem(blockIdx.x, cost, row_mask, col_mask, thresh, powers, n, m,
                n_phases, max_iters, staged, r2c_out, c2r_out, sweeps_out,
                cells_out);
}

template <typename Kernel>
int launch(Kernel kernel, const float* cost, const unsigned char* row_mask,
           const unsigned char* col_mask, const float* thresh,
           const float* powers, int B, int N, int M, int n_phases,
           int max_iters, int* r2c_out, int* c2r_out, int* sweeps_out,
           long long* cells_out, void* stream) {
  if (B <= 0 || N <= 0 || M <= 0 || n_phases <= 0 || n_phases > MAX_PHASES)
    return (int)cudaErrorInvalidValue;
  Powers pw = {};
  for (int k = 0; k < n_phases; ++k) pw.v[k] = powers[k];
  const size_t state = (size_t)(N + M) * STATE_BYTES;
  const size_t with_w = state + (size_t)N * M * 4;
  const int staged = with_w <= SMEM_LIMIT;
  const size_t smem = staged ? with_w : state;
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<B, THREADS, smem, (cudaStream_t)stream>>>(
      cost, row_mask, col_mask, thresh, pw, N, M, n_phases, max_iters,
      staged, r2c_out, c2r_out, sweeps_out, cells_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int auction_square_launch(
    const float* cost, const unsigned char* row_mask,
    const unsigned char* col_mask, const float* thresh, const float* powers,
    int B, int N, int M, int n_phases, int max_iters, int* r2c_out,
    int* c2r_out, int* sweeps_out, long long* cells_out, void* stream) {
  if (B != 1) return (int)cudaErrorInvalidValue;
  return launch(auction_square_kernel, cost, row_mask, col_mask, thresh,
                powers, B, N, M, n_phases, max_iters, r2c_out, c2r_out,
                sweeps_out, cells_out, stream);
}

extern "C" int auction_square_batched_launch(
    const float* cost, const unsigned char* row_mask,
    const unsigned char* col_mask, const float* thresh, const float* powers,
    int B, int N, int M, int n_phases, int max_iters, int* r2c_out,
    int* c2r_out, int* sweeps_out, long long* cells_out, void* stream) {
  return launch(auction_square_batched_kernel, cost, row_mask, col_mask,
                thresh, powers, B, N, M, n_phases, max_iters, r2c_out,
                c2r_out, sweeps_out, cells_out, stream);
}
