// Private-dummy rectangular auction (K2) for Hopper, sm_90a.
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
// so no multiply-add is contracted.
//
// What bounds it on the card: not bytes (the cost matrix is 150 KB at the
// tracker's 128 x 300 and is read from L2 on every sweep) and not
// arithmetic (a few hundred thousand compares per sweep), but the chain
// of dependent sweeps -- tens per solve, each two block-wide passes with
// a handful of __syncthreads -- and launch latency. The design therefore:
//   * runs all eps phases and all sweeps of a problem inside ONE launch
//     (the TPU kernel took one launch per phase only to keep Mosaic
//     compiles tractable), one thread block per problem, B problems per
//     launch (ByteTrack's stage-2/3 pair is B = 2);
//   * keeps prices, c2r, r2c and each row's best column and bid in shared
//     memory, and stages the real weights w(i, j < m) there too when they
//     fit (128 x 300 f32 = 150 KB does); otherwise (the CLI's 256 x 300)
//     w is recomputed on the fly from the cost matrix, the masks and the
//     jitter formula. Staging turns each sweep's two passes from chains
//     of L2 loads into shared-memory reads;
//   * works on the compact n x (m + n) problem: the Pallas kernel's
//     128-row/lane padding only adds rows and columns of weight -1e9 that
//     never change a real row's best, second best or bid;
//   * gives each row's max/argmax/second-max to one warp (shuffles), and
//     resolves the per-column winners (highest bid, lowest row on ties)
//     with one thread per bidding row;
//   * ends a phase at the first sweep that leaves (r2c, c2r, prices)
//     bit-identical. The fused release re-frees a row whose eps-CS test
//     fails by one rounding and its rebid restores the same state, so
//     the TPU kernel would repeat that sweep unchanged up to max_iters
//     (4096) times; stopping gives the same result without the repeats.

#include <cuda_runtime.h>
#include <climits>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_F = -1e9f;
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
// f32 constants rounded from double, as the JAX weak-typed ones are
constexpr float JIT_UNIT = (float)(1e-6 / 17.0);
constexpr float EPS_FLOOR = (float)2e-4;
constexpr int MAX_PHASES = 8;
// a block's shared memory, less room for the static counters
constexpr size_t SMEM_LIMIT = 232448 - 256;

// phase_factor ** (1 .. n_phases) in float32, computed by the wrapper
struct Powers {
  float v[MAX_PHASES];
};

struct Problem {
  const float* cost;              // (N, M) row-major
  const unsigned char* row_mask;  // (N,)
  const unsigned char* col_mask;  // (M,)
  const float* ws;                // (N, M) staged weights, or null
  float thresh;
  int n, m;
};

// real weight w(i, j < m), from the cost matrix
__device__ __forceinline__ float real_weight(const Problem& p, int i, int j) {
  if (!(p.row_mask[i] && p.col_mask[j])) return NEG_F;
  const int k = (i * 131 + j * 7) % 17;  // exact in f32 as in the TPU form
  const float jit = __fmul_rn((float)k, JIT_UNIT);
  return __fadd_rn(__fsub_rn(p.thresh, p.cost[(int64_t)i * p.m + j]), jit);
}

// w(i, j) of the compact problem: real columns j < m, then the private
// dummies m .. m+n-1.
__device__ __forceinline__ float weight(const Problem& p, int i, int j) {
  if (j < p.m) return p.ws ? p.ws[i * p.m + j] : real_weight(p, i, j);
  return (j - p.m == i) ? 0.0f : NEG_F;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// (best value, its first column, second-best value) of one row, reduced
// across the warp. Ties keep the lowest column; a duplicate of the best
// value counts as the second best.
__device__ __forceinline__ void warp_top2(float& b1, int& bi, float& b2) {
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

__global__ void __launch_bounds__(THREADS)
auction_kernel(const float* __restrict__ cost, long long cost_bstride,
               const unsigned char* __restrict__ row_mask,
               const unsigned char* __restrict__ col_mask,
               const float* __restrict__ thresh, Powers powers, int n,
               int m, int n_phases, int max_iters, int staged,
               int* __restrict__ r2c_out, int* __restrict__ c2r_out,
               int* __restrict__ sweeps_out) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int mt = m + n;

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

  extern __shared__ __align__(16) unsigned char smem[];
  float* ws = reinterpret_cast<float*>(smem);        // (n*m,) if staged
  float* prices = ws + (staged ? n * m : 0);         // (mt,)
  float* prices0 = prices + mt;                      // (mt,) sweep start
  int* c2r = reinterpret_cast<int*>(prices0 + mt);   // (mt,)
  int* c2r0 = c2r + mt;                              // (mt,) sweep start
  int* r2c = c2r0 + mt;                              // (n,)
  int* r2c0 = r2c + n;                               // (n,) sweep start
  int* best = r2c0 + n;                              // (n,) -1 = no bid
  float* bid = reinterpret_cast<float*>(best + n);   // (n,)
  __shared__ int n_released, n_unassigned, changed;
  int sweeps = 0;

  for (int j = tid; j < mt; j += THREADS) {
    prices[j] = 0.0f;
    c2r[j] = -1;
  }
  for (int i = tid; i < n; i += THREADS) r2c[i] = -1;
  if (staged) {
    // the real weights fit: compute them once into shared memory
    for (int k = tid; k < n * m; k += THREADS)
      ws[k] = real_weight(p, k / m, k % m);
    p.ws = ws;
  }
  __syncthreads();

  for (int ph = 0; ph < n_phases; ++ph) {
    const float eps = fmaxf(__fdiv_rn(scale, powers.v[ph]), EPS_FLOOR);
    int it = 0;
    int n_open = 1;  // the release step always runs for a new eps
    while (it < max_iters && n_open > 0) {
      // ---- snapshot the state, clamp unowned columns to price 0
      for (int j = tid; j < mt; j += THREADS) {
        prices0[j] = prices[j];
        c2r0[j] = c2r[j];
        if (c2r[j] < 0) prices[j] = 0.0f;
      }
      for (int i = tid; i < n; i += THREADS) r2c0[i] = r2c[i];
      if (tid == 0) {
        n_released = 0;
        n_unassigned = 0;
        changed = 0;
      }
      __syncthreads();

      // ---- release rows that violate eps-CS at these prices
      for (int i = warp; i < n; i += WARPS) {
        float v1 = -INFINITY;
        for (int j = lane; j < mt; j += 32)
          v1 = fmaxf(v1, __fsub_rn(weight(p, i, j), prices[j]));
        v1 = warp_max(v1);
        if (lane == 0) {
          const int rc = r2c[i];
          if (rc >= 0) {
            const float cur =
                fmaxf(__fsub_rn(weight(p, i, rc), prices[rc]), NEG_F);
            if (!(cur >= __fsub_rn(v1, eps))) {
              r2c[i] = -1;
              atomicAdd(&n_released, 1);
            }
          }
        }
      }
      __syncthreads();
      // rebuild c2r from the kept rows, clamp newly freed columns
      for (int j = tid; j < mt; j += THREADS) c2r[j] = -1;
      __syncthreads();
      for (int i = tid; i < n; i += THREADS)
        if (r2c[i] >= 0) c2r[r2c[i]] = i;
      __syncthreads();
      for (int j = tid; j < mt; j += THREADS)
        if (c2r[j] < 0) prices[j] = 0.0f;
      __syncthreads();

      // ---- one Jacobi bid round: every unassigned row bids for its
      // first best column, raising it by min(v1 - v2, cap) + eps
      for (int i = warp; i < n; i += WARPS) {
        if (r2c[i] >= 0) {
          if (lane == 0) best[i] = -1;
          continue;
        }
        float b1 = -INFINITY, b2 = -INFINITY;
        int bi = INT_MAX;
        for (int j = lane; j < mt; j += 32) {
          const float v = __fsub_rn(weight(p, i, j), prices[j]);
          if (v > b1) {
            b2 = b1;
            b1 = v;
            bi = j;
          } else {
            b2 = fmaxf(b2, v);
          }
        }
        warp_top2(b1, bi, b2);
        if (lane == 0) {
          const float v2 = fmaxf(b2, NEG_F);
          best[i] = bi;
          bid[i] = __fadd_rn(
              __fadd_rn(prices[bi], fminf(__fsub_rn(b1, v2), cap)), eps);
        }
      }
      __syncthreads();

      // ---- each column goes to its highest bidder, ties to the lowest
      // row; the previous owner is evicted. Exactly one thread writes
      // each contested column, and evicted rows are never bidders.
      for (int i = tid; i < n; i += THREADS) {
        const int j = best[i];
        if (j < 0) continue;
        const float bv = bid[i];
        bool wins = true;
        for (int k = 0; k < n; ++k) {
          if (k == i || best[k] != j) continue;
          const float bk = bid[k];
          if (bk > bv || (bk == bv && k < i)) {
            wins = false;
            break;
          }
        }
        if (wins) {
          const int prev = c2r[j];
          if (prev >= 0) r2c[prev] = -1;
          c2r[j] = i;
          r2c[i] = j;
          prices[j] = bv;
        }
      }
      __syncthreads();
      for (int i = tid; i < n; i += THREADS) {
        if (r2c[i] < 0) atomicAdd(&n_unassigned, 1);
        if (r2c[i] != r2c0[i]) changed = 1;
      }
      for (int j = tid; j < mt; j += THREADS)
        if (c2r[j] != c2r0[j] ||
            __float_as_int(prices[j]) != __float_as_int(prices0[j]))
          changed = 1;
      __syncthreads();
      n_open = n_unassigned + n_released;
      const bool repeat = changed == 0;
      ++it;
      ++sweeps;
      __syncthreads();  // everyone has read the counters before reset
      // A sweep that left the state bit-identical would be repeated
      // unchanged until max_iters (the fused release can re-free a row
      // whose eps-CS test fails by one rounding, and its rebid restores
      // the same state): stop the phase here, with the same result.
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
}

}  // namespace

extern "C" int auction_launch(const float* cost, long long cost_bstride,
                              const unsigned char* row_mask,
                              const unsigned char* col_mask,
                              const float* thresh, const float* powers,
                              int B, int N, int M, int n_phases,
                              int max_iters, int* r2c_out, int* c2r_out,
                              int* sweeps_out, void* stream) {
  if (B <= 0 || N <= 0 || M <= 0 || n_phases <= 0 || n_phases > MAX_PHASES)
    return (int)cudaErrorInvalidValue;
  Powers pw = {};
  for (int k = 0; k < n_phases; ++k) pw.v[k] = powers[k];
  const size_t state = (size_t)(4 * (M + N) + 4 * N) * 4;
  const size_t with_w = state + (size_t)N * M * 4;
  const int staged = with_w <= SMEM_LIMIT;
  const size_t smem = staged ? with_w : state;
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        auction_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  auction_kernel<<<B, THREADS, smem, (cudaStream_t)stream>>>(
      cost, cost_bstride, row_mask, col_mask, thresh, pw, N, M, n_phases,
      max_iters, staged, r2c_out, c2r_out, sweeps_out);
  return (int)cudaGetLastError();
}
