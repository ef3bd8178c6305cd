// The DeepSORT CNN's forward (K5) for Hopper, sm_90a, float32, with the
// BatchNorms folded into the convolutions' weights and biases.
//
// Replaces no TPU kernel: the JAX package runs this network as plain XLA
// (yolov7_tracker_tpu/reid/deepsort_cnn.py). It was added because, eager on
// the card, the network was the largest part of a DeepSORT frame: cuDNN ran
// its float32 3x3 convolutions as FFT tiles and complex GEMMs, some 300
// launches a convolution at 300 crops, with an NHWC -> NCHW transpose
// before each. The plain PyTorch version beside it (ops/deepsort_cnn.py:
// forward_plain) runs the same folded arithmetic with F.conv2d.
//
// What bounds it on the card: arithmetic. A 128 x 64 crop is 2.243 GFLOP
// (conv0 0.028, layer1 0.604, layers 2-4 0.537 each), 673 GFLOP over the
// 300 slots of a frame, 10.0 ms at the H100's 67 TFLOP/s of float32 FFMA.
// Every convolution is far above the float32 ridge (a layer1 conv is about
// 145 FLOP a byte of its activations), so the design is about keeping the
// FFMA pipes fed, not about bytes. The precision is the configuration's:
// float32 in and out, float32 products and sums (__fmaf_rn), no TF32 and no
// tensor core.
//
// Three kernels, 18 launches a forward whatever the number of crops N:
//   * stem_kernel: conv0 (3 -> 64, 3x3, folded bias) + ReLU + the 3/2 max
//     pool, one launch. K = 27 is too small for a GEMM tile; a block stages
//     a band of the crop's pixels in shared memory, computes 9 conv rows of
//     16 channels into shared memory (a thread keeps its 4 channels' 27
//     weights in registers and computes 4 neighbouring pixels, so that 6
//     reads of shared memory feed 48 FFMAs) and pools 4 output rows from
//     them, so the 128 x 64 x 64 activation never reaches device memory.
//   * conv_kernel: each of the 16 convolutions of the four stages as an
//     implicit GEMM over NHWC activations: M = crops x output pixels, N =
//     output channels, K = 3 x 3 x C_in taps. A block computes a BM x BN
//     output tile; A (BM pixels x 16 channels of one tap, zero-filled where
//     the tap falls in the padding or past the last crop) and B (16 rows x
//     BN of the weights, laid out (c_in / 16, kh, kw, 16) x c_out when
//     folded, the order of the K steps) are
//     staged in shared memory by cp.async in a ring of three stages, and
//     each thread accumulates an 8 x 8 tile by FFMA outer products, reading
//     A as float4 along K and B as float4 along N. The epilogue adds the
//     folded bias and, for the second conv of an identity block, the block's
//     input, then applies the ReLU. The second conv of a downsampling block
//     takes the block's 1x1 stride-2 projection as extra K rows (its folded
//     weights stacked under the 3x3's, its input read at twice the output
//     pixel), so relu(W2 * y + Wd * x + b2 + bd) is one GEMM.
//   * head_kernel: the mean over layer4's 8 x 4 pixels and the L2
//     normalisation (x / (|x| + 1e-12), as the module does), one block a
//     crop.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// the implicit-GEMM convolution
// ---------------------------------------------------------------------------

// One tile shape for every layer: 128 output pixels x 64 output channels,
// 128 threads of 8 x 8 outputs each (about 168 registers: three blocks an
// SM). On the H100 a 128 x 128 tile of 256 threads, one block an SM at that
// register count, ran layers 2-4 10-20% slower, and capping the registers
// at 128 for a fourth block spilled and ran 8-15% slower (PERF.md, K5).
constexpr int BM = 128;       // output pixels a block
constexpr int BN = 64;        // output channels a block
constexpr int BK = 16;        // K step: 16 channels of one tap
constexpr int APAD = 4;       // A rows padded to 20 floats: no bank conflict
constexpr int STAGES = 3;     // cp.async ring
constexpr int TM = BM / 8;    // threads along M
constexpr int TN = BN / 8;    // threads along N
constexpr int THREADS = TM * TN;
constexpr int CPR = BK / 4;   // A float4 chunks a row
constexpr int AS = BK + APAD; // A row stride (floats)
constexpr int A_STAGE = BM * AS;
constexpr int B_STAGE = BK * BN;
constexpr int A_ROWS = BM * CPR / THREADS;          // A rows a thread
constexpr int ROW_STEP = THREADS / CPR;
constexpr int B_CHUNKS = BK * (BN / 4) / THREADS;   // B float4s a thread
constexpr size_t CONV_SMEM = (size_t)STAGES * (A_STAGE + B_STAGE) * 4;
static_assert(BM * CPR % THREADS == 0 && BK * (BN / 4) % THREADS == 0,
              "every thread stages the same number of chunks");
static_assert(CONV_SMEM <= 48 * 1024, "static launch: no opt-in needed");

struct ConvArgs {
  const float* x;             // (N, H, W, C) NHWC, the 3x3 conv's input
  const float* xs;            // (N, 2 Ho, 2 Wo, Cs): projection input or null
  const float* res;           // (N, Ho, Wo, Cout): identity shortcut or null
  const float* w;             // (9 C + Cs, Cout), rows in K step order
  const float* b;             // (Cout,)
  float* out;                 // (N, Ho, Wo, Cout)
  int H, W, C, stride, Cs, Ho, Wo, Cout, M, nk1, nk;
};

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  // src-size 0 fills the 16 bytes with zeros and reads nothing
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async16_cg(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// One output tile of BM pixels x BN channels. Thread (tm, tn) owns the rows
// tm + TM i (i < 8) and the columns tn 4 + j and BN / 2 + tn 4 + j (j < 4):
// in a warp the float4 reads of A are broadcast or fall in distinct banks,
// those of B are contiguous, and so are the epilogue's stores.
__global__ void __launch_bounds__(THREADS) conv_kernel(const ConvArgs a) {
  extern __shared__ float4 smem4[];
  float* const As = reinterpret_cast<float*>(smem4);
  float* const Bs = As + STAGES * A_STAGE;

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // this thread's A chunks: rows tid / CPR + (THREADS / CPR) r, channels
  // (tid % CPR) 4 .. + 3 of the K step
  const int kc = (tid % CPR) * 4;
  const int row0 = tid / CPR;
  int pix[A_ROWS];         // input pixel under the tap centre
  int ihc[A_ROWS], iwc[A_ROWS];
#pragma unroll
  for (int r = 0; r < A_ROWS; ++r) {
    const int m = m0 + row0 + r * ROW_STEP;
    if (m < a.M) {
      const int hw = a.Ho * a.Wo;
      const int n = m / hw;
      const int rem = m - n * hw;
      const int oh = rem / a.Wo;
      const int ow = rem - oh * a.Wo;
      ihc[r] = oh * a.stride;
      iwc[r] = ow * a.stride;
      pix[r] = (n * a.H + ihc[r]) * a.W + iwc[r];
    } else {
      ihc[r] = iwc[r] = -(1 << 20);   // every tap falls outside
      pix[r] = 0;
    }
  }

  auto load_stage = [&](int slot, int kt) {
    float* const as = As + slot * A_STAGE;
    float* const bs = Bs + slot * B_STAGE;
    const int k0 = kt * BK;
    if (kt < a.nk1) {
      // K runs over 16-channel chunks, and within a chunk over the 9 taps:
      // the 9 steps of a chunk read overlapping windows of the same
      // channels, which the L1 keeps (3% faster than taps outside)
      const int chunk = kt / 9, tap = kt - chunk * 9;
      const int ci = chunk * BK + kc;
      const int dh = tap / 3 - 1, dw = tap % 3 - 1;
      const int dpix = dh * a.W + dw;
#pragma unroll
      for (int r = 0; r < A_ROWS; ++r) {
        const int ih = ihc[r] + dh, iw = iwc[r] + dw;
        const bool ok = (unsigned)ih < (unsigned)a.H &&
                        (unsigned)iw < (unsigned)a.W;
        const float* src =
            ok ? a.x + (size_t)(pix[r] + dpix) * a.C + ci : a.x;
        cp_async16(as + (row0 + r * ROW_STEP) * AS + kc, src, ok);
      }
    } else {
      // the projection: 1x1, stride 2, over the block's input; the output
      // pixel (n, oh, ow) reads x's (n, 2 oh, 2 ow): index 4 m - 2 ow
      const int ci = k0 - a.nk1 * BK + kc;
#pragma unroll
      for (int r = 0; r < A_ROWS; ++r) {
        const int row = row0 + r * ROW_STEP;
        const int m = m0 + row;
        const bool ok = m < a.M;
        const float* src =
            ok ? a.xs + (size_t)(4 * m - 2 * iwc[r]) * a.Cs + ci : a.xs;
        cp_async16(as + row * AS + kc, src, ok);
      }
    }
#pragma unroll
    for (int c = 0; c < B_CHUNKS; ++c) {
      const int q = tid + c * THREADS;
      const int kr = q / (BN / 4), col = (q % (BN / 4)) * 4;
      cp_async16_cg(bs + kr * BN + col,
                    a.w + (size_t)(k0 + kr) * a.Cout + n0 + col);
    }
  };

  const int tn = tid % TN, tm = tid / TN;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < a.nk) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < a.nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    // the slot of step kt - 1, which every thread has finished reading
    const int pf = kt + STAGES - 1;
    if (pf < a.nk) load_stage(pf % STAGES, pf);
    cp_async_commit();

    const int slot = kt % STAGES;
    const float* const as = As + slot * A_STAGE + tm * AS;
    const float* const bs = Bs + slot * B_STAGE + tn * 4;
#pragma unroll
    for (int kq = 0; kq < BK; kq += 4) {
      float4 av[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        av[i] = *reinterpret_cast<const float4*>(as + i * TM * AS + kq);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 b0 =
            *reinterpret_cast<const float4*>(bs + (kq + kk) * BN);
        const float4 b1 =
            *reinterpret_cast<const float4*>(bs + (kq + kk) * BN + BN / 2);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float x = lane(av[i], kk);
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(x, bv[j], acc[i][j]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // epilogue: + bias (+ the identity shortcut), ReLU, float4 stores
  float4 bias[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    bias[h] = *reinterpret_cast<const float4*>(a.b + n0 + h * (BN / 2) +
                                               tn * 4);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + tm + i * TM;
    if (m >= a.M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t o = (size_t)m * a.Cout + n0 + h * (BN / 2) + tn * 4;
      float4 v = make_float4(__fadd_rn(acc[i][h * 4 + 0], bias[h].x),
                             __fadd_rn(acc[i][h * 4 + 1], bias[h].y),
                             __fadd_rn(acc[i][h * 4 + 2], bias[h].z),
                             __fadd_rn(acc[i][h * 4 + 3], bias[h].w));
      if (a.res != nullptr) {
        const float4 r = *reinterpret_cast<const float4*>(a.res + o);
        v.x = __fadd_rn(v.x, r.x);
        v.y = __fadd_rn(v.y, r.y);
        v.z = __fadd_rn(v.z, r.z);
        v.w = __fadd_rn(v.w, r.w);
      }
      v.x = fmaxf(v.x, 0.0f);
      v.y = fmaxf(v.y, 0.0f);
      v.z = fmaxf(v.z, 0.0f);
      v.w = fmaxf(v.w, 0.0f);
      *reinterpret_cast<float4*>(a.out + o) = v;
    }
  }
}

// ---------------------------------------------------------------------------
// conv0 + ReLU + max pool 3/2 (pad 1)
// ---------------------------------------------------------------------------

constexpr int STEM_W = 64;          // crop width (DeepSORT's 128 x 64)
constexpr int STEM_C = 64;          // conv0's output channels
constexpr int STEM_BAND = 4;        // pooled rows a block
constexpr int STEM_CG = 16;         // channels a block
constexpr int STEM_THREADS = 128;
constexpr int STEM_ROWS = 2 * STEM_BAND + 1;      // conv rows a block
constexpr int STEM_IN_ROWS = STEM_ROWS + 2;       // input rows a block
// the input band, padded to a float4 boundary for the conv tile after it
constexpr int STEM_PATCH = (STEM_IN_ROWS * (STEM_W + 2) * 3 + 3) / 4 * 4;
constexpr int STEM_TILE = STEM_ROWS * STEM_W * STEM_CG;
constexpr size_t STEM_SMEM = (size_t)(STEM_PATCH + STEM_TILE) * 4;
static_assert(STEM_PATCH % 4 == 0, "the conv tile is float4-aligned");
static_assert(STEM_SMEM <= 48 * 1024, "static launch: no opt-in needed");

// Block (crop n, band of 4 pooled rows, group of 16 channels). Conv row r
// of the band is the crop's row 8 band - 1 + r (r < 9), computed from the
// zero-padded input rows 8 band - 2 .. 8 band + 8; pooled row p reads conv
// rows 2 p .. 2 p + 2 of the band, the max pool's padding (row or column
// -1) left out, as -inf padding would be after a ReLU. A band of 4 (not
// 8) keeps a block's shared memory at 45 KB, so that three blocks share an
// SM (as many as its registers allow), at 12% of conv rows computed twice.
__global__ void __launch_bounds__(STEM_THREADS)
    stem_kernel(const float* __restrict__ x, int H, const float* __restrict__ w,
                const float* __restrict__ b, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* const patch = reinterpret_cast<float*>(smem4);
  float* const tile = patch + STEM_PATCH;
  const int PH = H / 2, PW = STEM_W / 2;
  const int bands = PH / STEM_BAND, groups = STEM_C / STEM_CG;
  int bid = blockIdx.x;
  const int g = bid % groups;
  bid /= groups;
  const int band = bid % bands;
  const int n = bid / bands;
  const int tid = threadIdx.x;

  const int r0 = 2 * STEM_BAND * band - 2;
  const float* const xn = x + (size_t)n * H * STEM_W * 3;
  for (int i = tid; i < STEM_IN_ROWS * (STEM_W + 2) * 3; i += STEM_THREADS) {
    const int t = i / 3;
    const int col = t % (STEM_W + 2) - 1;
    const int row = t / (STEM_W + 2) + r0;
    float v = 0.0f;
    if (row >= 0 && row < H && col >= 0 && col < STEM_W)
      v = xn[((size_t)row * STEM_W + col) * 3 + i % 3];
    patch[i] = v;
  }
  const int q = tid & 3;
  const int co = g * STEM_CG + q * 4;
  float wr[27][4];
#pragma unroll
  for (int k = 0; k < 27; ++k) {
    const float4 v = *reinterpret_cast<const float4*>(w + k * STEM_C + co);
    wr[k][0] = v.x;
    wr[k][1] = v.y;
    wr[k][2] = v.z;
    wr[k][3] = v.w;
  }
  const float4 bias = *reinterpret_cast<const float4*>(b + co);
  __syncthreads();

  for (int p = tid >> 2; p < STEM_ROWS * (STEM_W / 4); p += STEM_THREADS / 4) {
    const int lr = p / (STEM_W / 4), c = (p % (STEM_W / 4)) * 4;
    float s[4][4];
#pragma unroll
    for (int px = 0; px < 4; ++px)
#pragma unroll
      for (int o = 0; o < 4; ++o) s[px][o] = 0.0f;
#pragma unroll
    for (int kh = 0; kh < 3; ++kh)
#pragma unroll
      for (int ci = 0; ci < 3; ++ci) {
        float v[6];
#pragma unroll
        for (int j = 0; j < 6; ++j)
          v[j] = patch[((lr + kh) * (STEM_W + 2) + c + j) * 3 + ci];
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          const int k = (kh * 3 + kw) * 3 + ci;
#pragma unroll
          for (int px = 0; px < 4; ++px)
#pragma unroll
            for (int o = 0; o < 4; ++o)
              s[px][o] = __fmaf_rn(v[px + kw], wr[k][o], s[px][o]);
        }
      }
    const float bb[4] = {bias.x, bias.y, bias.z, bias.w};
#pragma unroll
    for (int px = 0; px < 4; ++px)
      *reinterpret_cast<float4*>(tile + (lr * STEM_W + c + px) * STEM_CG +
                                 q * 4) =
          make_float4(fmaxf(__fadd_rn(s[px][0], bb[0]), 0.0f),
                      fmaxf(__fadd_rn(s[px][1], bb[1]), 0.0f),
                      fmaxf(__fadd_rn(s[px][2], bb[2]), 0.0f),
                      fmaxf(__fadd_rn(s[px][3], bb[3]), 0.0f));
  }
  __syncthreads();

  for (int i = tid; i < STEM_BAND * PW * (STEM_CG / 4); i += STEM_THREADS) {
    const int qq = i % (STEM_CG / 4);
    const int pc = (i / (STEM_CG / 4)) % PW;
    const int pr = i / (STEM_CG / 4) / PW;
    const float ninf = __int_as_float(0xff800000);
    float4 mx = make_float4(ninf, ninf, ninf, ninf);
#pragma unroll
    for (int dr = 0; dr < 3; ++dr) {
      const int lr = 2 * pr + dr;
      if (band == 0 && lr == 0) continue;      // the crop's row -1
#pragma unroll
      for (int dc = 0; dc < 3; ++dc) {
        const int c = 2 * pc - 1 + dc;
        if (c < 0) continue;
        const float4 v = *reinterpret_cast<const float4*>(
            tile + (lr * STEM_W + c) * STEM_CG + qq * 4);
        mx.x = fmaxf(mx.x, v.x);
        mx.y = fmaxf(mx.y, v.y);
        mx.z = fmaxf(mx.z, v.z);
        mx.w = fmaxf(mx.w, v.w);
      }
    }
    const int prow = band * STEM_BAND + pr;
    *reinterpret_cast<float4*>(
        out + (((size_t)n * PH + prow) * PW + pc) * STEM_C + g * STEM_CG +
        qq * 4) = mx;
  }
}

// ---------------------------------------------------------------------------
// mean over the pixels + L2 normalisation
// ---------------------------------------------------------------------------

constexpr int HEAD_THREADS = 128;   // 4 channels each: 512 channels

__global__ void __launch_bounds__(HEAD_THREADS)
    head_kernel(const float* __restrict__ x, int P,
                float* __restrict__ out) {
  constexpr int C = HEAD_THREADS * 4;
  const int n = blockIdx.x, tid = threadIdx.x;
  const float* xn = x + (size_t)n * P * C + tid * 4;
  float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int p = 0; p < P; ++p) {
    const float4 v = *reinterpret_cast<const float4*>(xn + (size_t)p * C);
    s.x = __fadd_rn(s.x, v.x);
    s.y = __fadd_rn(s.y, v.y);
    s.z = __fadd_rn(s.z, v.z);
    s.w = __fadd_rn(s.w, v.w);
  }
  const float fp = (float)P;
  s.x = __fdiv_rn(s.x, fp);
  s.y = __fdiv_rn(s.y, fp);
  s.z = __fdiv_rn(s.z, fp);
  s.w = __fdiv_rn(s.w, fp);
  float sq = __fmaf_rn(s.x, s.x, __fmaf_rn(s.y, s.y,
             __fmaf_rn(s.z, s.z, __fmul_rn(s.w, s.w))));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    sq = __fadd_rn(sq, __shfl_xor_sync(0xffffffffu, sq, o));
  __shared__ float part[HEAD_THREADS / 32];
  if ((tid & 31) == 0) part[tid >> 5] = sq;
  __syncthreads();
  float tot = 0.0f;
#pragma unroll
  for (int k = 0; k < HEAD_THREADS / 32; ++k) tot = __fadd_rn(tot, part[k]);
  const float den = __fadd_rn(__fsqrt_rn(tot), 1e-12f);
  *reinterpret_cast<float4*>(out + (size_t)n * C + tid * 4) =
      make_float4(__fdiv_rn(s.x, den), __fdiv_rn(s.y, den),
                  __fdiv_rn(s.z, den), __fdiv_rn(s.w, den));
}

bool aligned(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// conv0 + ReLU + max pool: x (N, H, 64, 3) NHWC crops, H a multiple of 16;
// w (27, 64) folded, rows (kh, kw, c_in); b (64,); out (N, H/2, 32, 64).
extern "C" int k5_stem_launch(const float* x, int N, int H, const float* w,
                              const float* b, float* out, void* stream) {
  if (N <= 0 || H <= 0 || H % (2 * STEM_BAND) != 0 || !aligned(w) ||
      !aligned(b) || !aligned(out))
    return (int)cudaErrorInvalidValue;
  const long long blocks =
      (long long)N * (H / 2 / STEM_BAND) * (STEM_C / STEM_CG);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  stem_kernel<<<(unsigned)blocks, STEM_THREADS, STEM_SMEM,
                (cudaStream_t)stream>>>(x, H, w, b, out);
  return (int)cudaGetLastError();
}

// One convolution of a BasicBlock, folded: out = relu(conv3x3(x, stride) +
// b [+ res] [+ conv1x1(xs, stride 2)]). x (N, H, W, C); xs (N, 2 Ho, 2 Wo,
// Cs) or null (Cs = 0); res (N, Ho, Wo, Cout) or null; w (9 C + Cs, Cout),
// the 3x3's rows ordered (C / 16, kh, kw, 16), then the projection's; out
// (N, Ho, Wo, Cout). C and Cs multiples of 16, Cout of 64.
extern "C" int k5_conv_launch(const float* x, int N, int H, int W, int C,
                              int stride, const float* xs, int Cs,
                              const float* res, const float* w,
                              const float* b, int Cout, float* out,
                              void* stream) {
  // the projection rides only on a stride-1 conv (its input index 4 m -
  // 2 ow assumes the 3x3's output grid) and never beside an identity
  // shortcut
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || C % BK != 0 || Cs < 0 ||
      Cs % BK != 0 || (Cs > 0) != (xs != nullptr) || Cout <= 0 ||
      Cout % 64 != 0 || (stride != 1 && stride != 2) ||
      (Cs > 0 && stride != 1) || (Cs > 0 && res != nullptr))
    return (int)cudaErrorInvalidValue;
  if (!aligned(x) || !aligned(xs) || !aligned(res) || !aligned(w) ||
      !aligned(b) || !aligned(out))
    return (int)cudaErrorInvalidValue;
  ConvArgs a;
  a.x = x;
  a.xs = xs;
  a.res = res;
  a.w = w;
  a.b = b;
  a.out = out;
  a.H = H;
  a.W = W;
  a.C = C;
  a.stride = stride;
  a.Cs = Cs;
  a.Ho = (H - 1) / stride + 1;
  a.Wo = (W - 1) / stride + 1;
  a.Cout = Cout;
  const long long M = (long long)N * a.Ho * a.Wo;
  if (M * Cout > 0x7fffffffLL || (long long)N * H * W > 0x7fffffffLL / 4)
    return (int)cudaErrorInvalidValue;
  a.M = (int)M;
  a.nk1 = 9 * C / BK;
  a.nk = a.nk1 + Cs / BK;
  const dim3 grid((a.M + BM - 1) / BM, a.Cout / BN);
  conv_kernel<<<grid, THREADS, CONV_SMEM, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Mean over the P pixels of each crop's (P, 512) NHWC map and L2
// normalisation: x (N, P, 512) -> out (N, 512).
extern "C" int k5_head_launch(const float* x, int N, int P, float* out,
                              void* stream) {
  if (N <= 0 || P <= 0 || !aligned(x) || !aligned(out))
    return (int)cudaErrorInvalidValue;
  head_kernel<<<N, HEAD_THREADS, 0, (cudaStream_t)stream>>>(x, P, out);
  return (int)cudaGetLastError();
}
