// The greedy keep set of class-offset NMS (K6) for Hopper, sm_90a, float32:
// every image of a batch in one launch, one block an image.
//
// Replaces no TPU kernel: the JAX package's greedy_suppress is a
// lax.while_loop that XLA compiles (yolov7_tracker_tpu/ops/nms.py:34-115).
// Its eager PyTorch form (ops/nms.py: greedy_suppress, the plain version
// beside this kernel) reads the device on every pass of its outer loop and
// of its fixpoint loop, one image at a time: some 7 host reads a frame, each
// draining the stream before the host launches the next few small ops.
//
// Same function as the plain version, bit for bit: the candidates of an
// image are visited by float32 score, descending, ties by their position in
// the top-K list (the wrapper's stable sort hands the order in); a
// candidate is dropped when its IoU with a box kept before it is above
// iou_thres; the walk stops at max_det kept or at the first score <= 0. The
// IoU is boxops.iou_matrix_xyxy's float32 formula in its order of
// operations, eps 1e-7, IEEE division, with PyTorch's NaN propagation in
// the min, max and clamp; -fmad=false keeps every product and sum rounded
// on its own. The rows [sel_box, score, cls] are written in keep order,
// zeros after them, and the count.
//
// What bounds it on the card: latency. At the benchmark's shapes it reads
// 8 x 2048 candidates (a score, an index, two boxes and a class: 48 B each)
// and writes 8 x 300 rows, about 0.8 MB, 0.25 us at 3.35 TB/s, and its
// IoUs are microseconds of arithmetic. What costs is the chain: each
// candidate's fate waits on the keep set of every candidate before it. The
// design keeps the host out of the chain and shortens it:
//   * one launch for the batch and no read back to the host anywhere;
//   * the kept boxes (max_det x 16 B) stay in shared memory; the candidates
//     are read from device memory a chunk of 128 at a time, so any K fits,
//     and the next chunk's boxes are gathered while this one is tested;
//   * 1,024 threads test a chunk, a thread a candidate and each of 8 groups
//     an eighth of the list: first against the kept boxes, then the
//     survivors against the chunk's earlier survivors, which gives each a
//     128-bit suppression mask (an IoU's division only where two boxes
//     intersect);
//   * one warp resolves the chunk's own greedy order from the masks by
//     ballots: the keep set is the one fixpoint of kept[i] = alive[i] &
//     !any(j < i: kept[j] & sup[j][i]), reached from the alive set in as
//     many sweeps as the longest chain of suppressions (about 3 a chunk on
//     yolov7-w6's candidates, 128 at most), each sweep four ballots.
// On an H100 (700 W) a batch of the video cell's candidates takes 24 us,
// 46 us with the wrapper's sort.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 128;                   // candidates a chunk
constexpr int kGroups = 8;                    // groups splitting the tests
constexpr int kThreads = kChunk * kGroups;    // 1024: the SM is the image's

// torch.minimum / torch.maximum / torch.clamp(min=0): a NaN operand gives NaN
// (fminf and fmaxf would drop it), so a box with a coordinate that is not
// finite gets the plain version's IoU too
__device__ __forceinline__ float tmin(float a, float b) {
  return (a != a || a < b) ? a : b;
}

__device__ __forceinline__ float tmax(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// IoU(a, b) > t by boxops.iou_matrix_xyxy: a the earlier (kept) box, b the
// candidate. Where the overlap in x, or then the intersection, is 0 or NaN,
// the IoU is +-0 or NaN, above no t >= 0: most pairs end at the first test
__device__ __forceinline__ bool suppresses(float4 a, float4 b, float t,
                                           bool t_nonneg) {
  const float iw = tmax(tmin(a.z, b.z) - tmax(a.x, b.x), 0.f);
  if (t_nonneg && !(iw > 0.f)) return false;
  const float ih = tmax(tmin(a.w, b.w) - tmax(a.y, b.y), 0.f);
  const float inter = iw * ih;
  if (t_nonneg && !(inter > 0.f)) return false;
  const float area_a = (a.z - a.x) * (a.w - a.y);
  const float area_b = (b.z - b.x) * (b.w - b.y);
  return inter / (area_a + area_b - inter + 1e-7f) > t;
}

// candidate c of the chunk against the kept boxes that fall to group g
__device__ __forceinline__ void test_kept(const float4* kept, int n_kept,
                                          const float4* cbox, int c, int g,
                                          float t, bool t_nonneg, int* csup) {
  const float4 bc = cbox[c];
  for (int j = g; j < n_kept; j += kGroups)
    if (suppresses(kept[j], bc, t, t_nonneg)) {
      csup[c] = 1;
      return;
    }
}

// candidate c, alive after the kept boxes, against the chunk's earlier
// alive candidates that fall to group g: its bits of the suppression mask
__device__ __forceinline__ void test_chunk(const float4* cbox,
                                           const int* csup, int c, int g,
                                           float t, bool t_nonneg,
                                           unsigned long long* cmask) {
  const float4 bc = cbox[c];
  unsigned long long lo = 0ull, hi = 0ull;
  for (int j = g; j < c; j += kGroups)
    if (!csup[j] && suppresses(cbox[j], bc, t, t_nonneg)) {
      if (j < 64)
        lo |= 1ull << j;
      else
        hi |= 1ull << (j - 64);
    }
  if (lo) atomicOr(&cmask[2 * c], lo);
  if (hi) atomicOr(&cmask[2 * c + 1], hi);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return make_float4(p[0], p[1], p[2], p[3]);
}

__global__ void __launch_bounds__(kThreads)
k6_kernel(const float* __restrict__ sel_box, const float* __restrict__ off_box,
          const float* __restrict__ cls, const float* __restrict__ score,
          const int64_t* __restrict__ order, int K, int max_det, float t,
          float* __restrict__ out, int64_t* __restrict__ counts) {
  extern __shared__ float4 kept[];        // the kept off boxes, keep order
  __shared__ float4 cbox[kChunk];         // the chunk's off boxes
  __shared__ float cscore[kChunk];
  __shared__ unsigned long long cmask[2 * kChunk];  // earlier suppressors
  __shared__ int csup[kChunk];            // suppressed by a kept box
  __shared__ unsigned long long keep_bits[2];

  const int tid = threadIdx.x;
  const int c = tid % kChunk, g = tid / kChunk;
  const size_t row0 = (size_t)blockIdx.x * K;
  sel_box += row0 * 4;
  off_box += row0 * 4;
  cls += row0;
  score += row0;
  order += row0;
  out += (size_t)blockIdx.x * max_det * 6;
  const bool t_nonneg = t >= 0.f;

  // a thread < kChunk carries its candidate of this chunk (s .. cl), of
  // the next (gathered while this one is tested) and the score and index
  // of the one after: the loads run under the work of a chunk
  float s = -1.f, cl = 0.f, s1 = -1.f, cl1 = 0.f, s2 = -1.f;
  float4 box = make_float4(0.f, 0.f, 0.f, 0.f), sbox = box, box1 = box,
         sbox1 = box;
  int64_t i2 = 0;
  if (tid < kChunk) {
    if (tid < K) {
      s = score[tid];
      const int64_t i = order[tid];
      if (s > 0.f) {
        box = load4(off_box + i * 4);
        sbox = load4(sel_box + i * 4);
        cl = cls[i];
      }
    }
    if (kChunk + tid < K) {
      s1 = score[kChunk + tid];
      i2 = order[kChunk + tid];       // gathered at the first chunk
    }
  }
  // the sort puts a NaN score first; the plain version's loop then ends
  // before its first pass (the scores' max is NaN)
  bool more = K > 0 && max_det > 0 && !(score[0] != score[0]);
  int n_kept = 0;
  for (int p = 0; more; p += kChunk) {
    if (tid < kChunk) {
      cbox[tid] = box;
      cscore[tid] = s;
      cmask[2 * tid] = 0ull;
      cmask[2 * tid + 1] = 0ull;
      csup[tid] = 0;
      // the next chunk's gathers, the one after's score and index
      if (s1 > 0.f) {
        box1 = load4(off_box + i2 * 4);
        sbox1 = load4(sel_box + i2 * 4);
        cl1 = cls[i2];
      }
      const int q = p + 2 * kChunk + tid;
      s2 = q < K ? score[q] : -1.f;
      i2 = q < K ? order[q] : 0;
    }
    __syncthreads();

    // each candidate against the kept boxes, then the survivors against
    // the chunk's earlier survivors, group g taking every kGroups-th
    if (cscore[c] > 0.f)
      test_kept(kept, n_kept, cbox, c, g, t, t_nonneg, csup);
    __syncthreads();
    if (cscore[c] > 0.f && !csup[c])
      test_chunk(cbox, csup, c, g, t, t_nonneg, cmask);
    __syncthreads();

    // the chunk's greedy keep set, by one warp: lane l holds candidates l,
    // l + 32, l + 64 and l + 96; sweep n settles the first n candidates
    if (tid < 32) {
      bool a[4];
      unsigned long long mlo[4], mhi[4];
      for (int q = 0; q < 4; ++q) {
        const int cq = tid + 32 * q;
        a[q] = cscore[cq] > 0.f && !csup[cq];
        mlo[q] = cmask[2 * cq];
        mhi[q] = cmask[2 * cq + 1];
      }
      unsigned long long klo =
          (unsigned long long)__ballot_sync(0xffffffffu, a[0]) |
          ((unsigned long long)__ballot_sync(0xffffffffu, a[1]) << 32);
      unsigned long long khi =
          (unsigned long long)__ballot_sync(0xffffffffu, a[2]) |
          ((unsigned long long)__ballot_sync(0xffffffffu, a[3]) << 32);
      for (;;) {
        bool n[4];
        for (int q = 0; q < 4; ++q)
          n[q] = a[q] && !((mlo[q] & klo) | (mhi[q] & khi));
        const unsigned long long nlo =
            (unsigned long long)__ballot_sync(0xffffffffu, n[0]) |
            ((unsigned long long)__ballot_sync(0xffffffffu, n[1]) << 32);
        const unsigned long long nhi =
            (unsigned long long)__ballot_sync(0xffffffffu, n[2]) |
            ((unsigned long long)__ballot_sync(0xffffffffu, n[3]) << 32);
        if (nlo == klo && nhi == khi) break;
        klo = nlo;
        khi = nhi;
      }
      if (tid == 0) {
        keep_bits[0] = klo;
        keep_bits[1] = khi;
      }
    }
    __syncthreads();

    // append the kept in order, up to max_det
    const unsigned long long klo = keep_bits[0], khi = keep_bits[1];
    const int room = max_det - n_kept;
    if (tid < kChunk) {
      const bool mine = tid < 64 ? (klo >> tid) & 1ull
                                 : (khi >> (tid - 64)) & 1ull;
      const int r = tid < 64 ? __popcll(klo & ((1ull << tid) - 1ull))
                             : __popcll(klo) +
                                   __popcll(khi & ((1ull << (tid - 64)) - 1ull));
      if (mine && r < room) {
        float* o = out + (size_t)(n_kept + r) * 6;
        o[0] = sbox.x;
        o[1] = sbox.y;
        o[2] = sbox.z;
        o[3] = sbox.w;
        o[4] = s;
        o[5] = cl;
        kept[n_kept + r] = box;
      }
      s = s1;
      box = box1;
      sbox = sbox1;
      cl = cl1;
      s1 = s2;
    }
    n_kept += min(__popcll(klo) + __popcll(khi), room);
    // sorted: a chunk that ends in a score <= 0 (or past K) was the last
    more = n_kept < max_det && cscore[kChunk - 1] > 0.f && p + kChunk < K;
    __syncthreads();
  }
  for (int i = n_kept * 6 + tid; i < max_det * 6; i += kThreads) out[i] = 0.f;
  if (tid == 0) counts[blockIdx.x] = n_kept;
}

}  // namespace

// sel_box, off_box (B, K, 4), cls, score (B, K) float32 and order (B, K)
// int64, contiguous; score holds each row's scores sorted descending and
// order their positions in the top-K list. Writes out (B, max_det, 6) and
// counts (B,). Returns the launch's CUDA error (0 on success).
extern "C" int k6_nms_launch(const float* sel_box, const float* off_box,
                             const float* cls, const float* score,
                             const int64_t* order, int B, int K, int max_det,
                             float iou_thres, float* out, int64_t* counts,
                             void* stream) {
  if (B <= 0 || K < 0 || max_det < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(max_det > 0 ? max_det : 1) * sizeof(float4);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        k6_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  k6_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      sel_box, off_box, cls, score, order, K, max_det, iou_thres, out,
      counts);
  return (int)cudaGetLastError();
}
