// Per-sample 3x3 depthwise cross-correlation, zero padding 1, NHWC, in
// float32 (kernel 1) or bfloat16 (kernel 1b):
//   out[b, y, x, c] = sum_{dy, dx in 0..2} xpad[b, y + dy, x + dx, c] * k[b, dy, dx, c]
//
// Replaces: ossid_code_tpu/ops/pallas_kernels.py::dw_corr3x3_pallas (body
// _dw_corr_kernel), reached through ossid_code_tpu/ops/conv.py::depthwise_corr.
// On DTOID's detect path it runs twice per frame: the correlation head,
// x (T, 29, 39, 640) with one image feature broadcast over the T templates,
// and the image-encoder stem, x (1, 240, 320, 64) with a broadcast kernel.
// The serving farm's detect of F frames runs it twice a round whatever F is:
// the head as F * T samples, sample i frame i / T against template i % T,
// and the stem as F samples with the kernel broadcast.
//
// What bounds it on an H100: memory. It does 18 flops per output element
// against 4 bytes written (2 in bf16, and at best as many read), so the least
// time is the bytes over the HBM rate: one read of x and k, one write of out.
//
// What the design does about it:
//  * a thread owns one channel vector cv (16 bytes: 4 float32 or 8 bf16
//    channels) of R consecutive outputs of one row (b, y): it keeps the k
//    taps of its vector in registers and slides a 3-column window of x
//    along the row, so each new output costs 3 vector loads of x (one per
//    kernel row) where one thread per output made 9 of x and 9 of k: at
//    R = 4, 27 loads for 4 outputs in place of 72;
//  * where x is broadcast over a frame's templates (the correlation head:
//    one image feature, T templates), the float32 instance covers 2
//    templates of the same frame and pixels per thread, so each x load
//    serves both, and runs of R = 8; a block never spans two frames (a
//    frame's last block holds one template where T is odd);
//  * neighbouring threads hold neighbouring channel vectors of the same run,
//    so every load and store is coalesced along C: at C = 640 (160 float32
//    vectors) a warp spans 32 vectors of one pixel, at C = 64 (16 vectors)
//    two runs; a ragged last run (W % R != 0) is masked at its loads and
//    stores;
//  * the grid is (row segments, H, blocks of samples): ceil(B / samples
//    per thread) for a batch, F * ceil(T / samples per thread) for frames;
//    a thread finds its first sample (frame and template) and y in
//    blockIdx and its (run, cv) with one 32-bit division;
//  * the zero padding is a bounds check, so no padded copy of x is made (the
//    Pallas wrapper padded x in HBM);
//  * x and k come with a frame stride and a template stride each: a
//    stride of 0 reads the broadcast image feature (correlation head) or the
//    broadcast global kernel (stem) in place, without materialising the
//    broadcast.
// No tensor cores: there is no reduction over channels to feed them.
//
// bf16 (kernel 1b): the taps and x are widened to float32 in registers, the
// 9 products of an output are accumulated in float32 (in the same dy-major,
// dx-minor order) and the sum is rounded once to bf16 at the store. That is
// what the JAX package computes in bf16: its default lowering is XLA's
// grouped convolution (Pallas is opt-in), whose bf16 result equals the
// float32 result rounded once; the Pallas body would round every product
// and partial sum to bf16 instead.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// One 16-byte channel vector: its raw type, element type and width, widened
// to and narrowed from float32 registers.
struct F32x4 {
  using T = float;
  using raw = float4;
  static constexpr int N = 4;
  static __device__ __forceinline__ void widen(const raw& r, float (&v)[N]) {
    v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
  }
  static __device__ __forceinline__ raw narrow(const float (&v)[N]) {
    return make_float4(v[0], v[1], v[2], v[3]);
  }
  static __device__ __forceinline__ raw zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
};

struct BF16x8 {
  using T = __nv_bfloat16;
  using raw = uint4;
  static constexpr int N = 8;
  static __device__ __forceinline__ void widen(const raw& r, float (&v)[N]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);              // low half: channel 2i
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);  // high half: 2i + 1
    }
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // round to nearest even
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  static __device__ __forceinline__ raw narrow(const float (&v)[N]) {
    return make_uint4(pack(v[0], v[1]), pack(v[2], v[3]), pack(v[4], v[5]), pack(v[6], v[7]));
  }
  static __device__ __forceinline__ raw zero() { return make_uint4(0, 0, 0, 0); }
};

// A guarded vector load as a select (ok ? load : 0), then widened.
template <class V>
__device__ __forceinline__ void load(const typename V::raw* p, bool ok, float (&v)[V::N]) {
  V::widen(ok ? __ldg(p) : V::zero(), v);
}

// R outputs along a row and NB samples per thread. FRAMES = false: a batch
// of B samples, sample b at b * stride of each operand (x_fstride,
// k_fstride; the t strides unused), block z samples z * NB .. + NB - 1.
// FRAMES = true: sample i is the pair (frame f, template t) = (i / T, i % T)
// of F = B / T frames of T templates, an operand's sample at f * fstride +
// t * tstride; block z covers templates t0 .. t0 + NB - 1 of one frame (z =
// f * ceil(T / NB) + t0 / NB), so its samples never straddle two frames: a
// frame's last block holds T % NB samples where NB does not divide T. The
// two are separate instances: the frame indexing costs the (8, 2) instance
// 13 registers (84 -> 97) and 19-35% of its time at the one-frame head
// (on an H100 80GB HBM3 at 700 W), so a per-sample batch keeps its own.
// NB > 1 only where a block's samples read one x (x's stride 0 over the
// batch, or over a frame's templates), so that every x load serves NB
// outputs. CV: channel vectors per pixel.
template <class V, int R, int NB, bool FRAMES>
__global__ void __launch_bounds__(THREADS)
dw_corr3x3_kernel(const typename V::T* __restrict__ x, const typename V::T* __restrict__ k,
                  typename V::T* __restrict__ out, int B, int T, int H, int W, int CV, int nruns,
                  long long x_fstride, long long x_tstride, long long k_fstride,
                  long long k_tstride) {
  constexpr int N = V::N;
  using raw = typename V::raw;
  const int t = blockIdx.x * THREADS + threadIdx.x;  // run * CV + cv
  if (t >= nruns * CV) return;
  const int py = blockIdx.y;
  const int run = t / CV;
  const int cv = t - run * CV;
  const int x0 = run * R;
  const int row = W * CV;                            // vectors in one image row
  int b0, nb;                                        // the block's first sample, its samples
  const raw* xb;
  const raw* kb;
  long long kstep;                                   // vectors between the block's samples' taps
  if (FRAMES) {
    const int tblocks = (T + NB - 1) / NB;
    const int f = blockIdx.z / tblocks;
    const int t0 = (blockIdx.z - f * tblocks) * NB;
    b0 = f * T + t0;
    nb = T - t0 < NB ? T - t0 : NB;
    xb = reinterpret_cast<const raw*>(x + f * x_fstride + t0 * x_tstride) + cv;
    kb = reinterpret_cast<const raw*>(k + f * k_fstride + t0 * k_tstride) + cv;
    kstep = k_tstride / N;
  } else {
    b0 = blockIdx.z * NB;
    nb = B - b0 < NB ? B - b0 : NB;
    xb = reinterpret_cast<const raw*>(x + b0 * x_fstride) + cv;
    kb = reinterpret_cast<const raw*>(k + b0 * k_fstride) + cv;
    kstep = k_fstride / N;
  }
  float acc[NB][R][N];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int e = 0; e < N; ++e) acc[j][i][e] = 0.f;
  // Sum order per output is dy-major, dx-minor, as in a direct 3x3 loop.
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const int yy = py + dy - 1;
    if (yy < 0 || yy >= H) continue;
    float w[NB][3][N];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        load<V>(kb + j * kstep + (dy * 3 + dx) * CV, j < nb, w[j][dx]);
    const raw* xr = xb + yy * row;
    float left[N], mid[N], right[N];
    load<V>(xr + (x0 - 1) * CV, x0 > 0, left);
    load<V>(xr + x0 * CV, true, mid);                // x0 < W
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int xx = x0 + i + 1;
      load<V>(xr + xx * CV, xx < W, right);
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < N; ++e) {
          acc[j][i][e] = fmaf(left[e], w[j][0][e], acc[j][i][e]);
          acc[j][i][e] = fmaf(mid[e], w[j][1][e], acc[j][i][e]);
          acc[j][i][e] = fmaf(right[e], w[j][2][e], acc[j][i][e]);
        }
#pragma unroll
      for (int e = 0; e < N; ++e) {
        left[e] = mid[e];
        mid[e] = right[e];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    if (j >= nb) break;
    raw* o = reinterpret_cast<raw*>(out) + ((long long)(b0 + j) * H + py) * row + cv;
#pragma unroll
    for (int i = 0; i < R; ++i)
      if (x0 + i < W) o[(x0 + i) * CV] = V::narrow(acc[j][i]);
  }
}

// Run length and samples per thread. float32, as timed at the two main-path
// calls on an H100 80GB HBM3 (700 W): (8, 2) at the correlation head, where x
// is broadcast over the templates, (4, 1) at the stem (C = 64, B = 1). bf16
// holds twice the channels per vector: (4, 1) everywhere (130 registers; at
// the head (4, 2) took 164 and timed 0.0203 ms against 0.0193, in two calls
// on an H100 80GB HBM3 at 700 W).
template <class V, int R, int NB, bool FRAMES>
int launch(const void* x, const void* k, void* out, int B, int T, int H, int W, int C,
           long long x_fstride, long long x_tstride, long long k_fstride, long long k_tstride,
           void* stream) {
  const int CV = C / V::N;
  const int nruns = (W + R - 1) / R;
  const long long zblocks = FRAMES ? (long long)(B / T) * ((T + NB - 1) / NB) : (B + NB - 1) / NB;
  if (zblocks > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((nruns * CV + THREADS - 1) / THREADS), (unsigned)H, (unsigned)zblocks);
  using T_ = typename V::T;
  dw_corr3x3_kernel<V, R, NB, FRAMES><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const T_*>(x), static_cast<const T_*>(k), static_cast<T_*>(out), B, T, H, W, CV,
      nruns, x_fstride, x_tstride, k_fstride, k_tstride);
  return (int)cudaGetLastError();
}

// The instance for the call: a per-sample batch (T = 1) or F frames x T
// templates; 2 samples a thread where they read one x.
template <class V, int R, int NB, int R1>
int dispatch(const void* x, const void* k, void* out, int B, int T, int H, int W, int C,
             long long x_fstride, long long x_tstride, long long k_fstride, long long k_tstride,
             void* stream) {
  if (T == 1 && x_fstride == 0 && B > 1)
    return launch<V, R, NB, false>(x, k, out, B, 1, H, W, C, 0, 0, k_fstride, 0, stream);
  if (T == 1)
    return launch<V, R1, 1, false>(x, k, out, B, 1, H, W, C, x_fstride, 0, k_fstride, 0, stream);
  if (x_tstride == 0)
    return launch<V, R, NB, true>(x, k, out, B, T, H, W, C, x_fstride, 0, k_fstride, k_tstride, stream);
  return launch<V, R1, 1, true>(x, k, out, B, T, H, W, C, x_fstride, x_tstride, k_fstride, k_tstride,
                                stream);
}

int check_shape(int B, int T, int H, int W, int C) {
  if ((long long)H * W * C > 0x7fffffffLL || H > 65535 || T < 1 || B % T)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// B = F * T samples, sample i the pair (frame i / T, template i % T). x:
// (H, W, C) contiguous per sample, sample (f, t) at f * x_fstride + t *
// x_tstride elements (either stride may be 0: x_tstride = 0 is one frame's
// x broadcast over its T templates); k: (3, 3, C) contiguous per sample,
// likewise with k_fstride and k_tstride (k_fstride = 0: the same T taps for
// every frame; T = 1 and k_fstride = 0: one tap set broadcast over B); out:
// contiguous (B, H, W, C). A per-sample batch, as autograd's dx takes it, is
// T = 1 with the batch strides as the frame strides. All pointers 16-byte
// aligned; C and the strides multiples of one vector (4 float32 or 8 bf16
// channels; the wrapper checks). One image, H * W * C, must fit an int; H
// and F * ceil(T / NB) at most 65535, T at least 1 and a divisor of B.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// shape out of those bounds).
extern "C" int dw_corr3x3_f32(const float* x, const float* k, float* out,
                              int B, int T, int H, int W, int C,
                              long long x_fstride, long long x_tstride,
                              long long k_fstride, long long k_tstride, void* stream) {
  if (B == 0 || H == 0 || W == 0 || C == 0) return 0;
  if (int err = check_shape(B, T, H, W, C)) return err;
  return dispatch<F32x4, 8, 2, 4>(x, k, out, B, T, H, W, C, x_fstride, x_tstride, k_fstride, k_tstride,
                                  stream);
}

extern "C" int dw_corr3x3_bf16(const void* x, const void* k, void* out,
                               int B, int T, int H, int W, int C,
                               long long x_fstride, long long x_tstride,
                               long long k_fstride, long long k_tstride, void* stream) {
  if (B == 0 || H == 0 || W == 0 || C == 0) return 0;
  if (int err = check_shape(B, T, H, W, C)) return err;
  // (4, 1) everywhere: the instance that shares x is never picked
  return dispatch<BF16x8, 4, 1, 4>(x, k, out, B, T, H, W, C, x_fstride, x_tstride, k_fstride, k_tstride,
                                   stream);
}
