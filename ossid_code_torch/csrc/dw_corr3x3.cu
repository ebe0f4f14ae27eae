// Per-sample 3x3 depthwise cross-correlation, zero padding 1, NHWC, in
// float32 (kernel 1) or bfloat16 (kernel 1b):
//   out[b, y, x, c] = sum_{dy, dx in 0..2} xpad[b, y + dy, x + dx, c] * k[b, dy, dx, c]
//
// Replaces: ossid_code_tpu/ops/pallas_kernels.py::dw_corr3x3_pallas (body
// _dw_corr_kernel), reached through ossid_code_tpu/ops/conv.py::depthwise_corr.
// On DTOID's detect path it runs twice per frame: the correlation head,
// x (T, 29, 39, 640) with one image feature broadcast over the T templates,
// and the image-encoder stem, x (1, 240, 320, 64) with a broadcast kernel.
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
//  * where x is broadcast over B (the correlation head: one image feature,
//    T templates), the float32 instance covers 2 samples of the same pixels
//    per thread, so each x load serves both, and runs of R = 8;
//  * neighbouring threads hold neighbouring channel vectors of the same run,
//    so every load and store is coalesced along C: at C = 640 (160 float32
//    vectors) a warp spans 32 vectors of one pixel, at C = 64 (16 vectors)
//    two runs; a ragged last run (W % R != 0) is masked at its loads and
//    stores;
//  * the grid is (row segments, H, B / samples per thread): a thread finds
//    its (b, y) in blockIdx and its (run, cv) with one 32-bit division;
//  * the zero padding is a bounds check, so no padded copy of x is made (the
//    Pallas wrapper padded x in HBM);
//  * x and k come with their batch strides as arguments: a stride of 0
//    reads the broadcast image feature (correlation head) or the broadcast
//    global kernel (stem) in place, without materialising the broadcast.
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

// R outputs along a row and NB samples b0 .. b0 + NB - 1 per thread (NB > 1
// only with x broadcast, so that every x load serves NB outputs). CV: channel
// vectors per pixel; strides in elements.
template <class V, int R, int NB>
__global__ void __launch_bounds__(THREADS)
dw_corr3x3_kernel(const typename V::T* __restrict__ x, const typename V::T* __restrict__ k,
                  typename V::T* __restrict__ out, int B, int H, int W, int CV, int nruns,
                  long long x_bstride, long long k_bstride) {
  constexpr int N = V::N;
  using raw = typename V::raw;
  const int t = blockIdx.x * THREADS + threadIdx.x;  // run * CV + cv
  if (t >= nruns * CV) return;
  const int py = blockIdx.y;
  const int b0 = blockIdx.z * NB;
  const int run = t / CV;
  const int cv = t - run * CV;
  const int x0 = run * R;
  const int row = W * CV;                            // vectors in one image row
  const int nb = B - b0 < NB ? B - b0 : NB;

  const raw* xb = reinterpret_cast<const raw*>(x + b0 * x_bstride) + cv;
  const raw* kb = reinterpret_cast<const raw*>(k + b0 * k_bstride) + cv;
  const long long kstep = k_bstride / N;             // vectors between samples' taps
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
template <class V, int R, int NB>
int launch(const void* x, const void* k, void* out, int B, int H, int W, int C,
           long long x_bstride, long long k_bstride, void* stream) {
  const int CV = C / V::N;
  const int nruns = (W + R - 1) / R;
  const dim3 grid((unsigned)((nruns * CV + THREADS - 1) / THREADS), (unsigned)H,
                  (unsigned)((B + NB - 1) / NB));
  using T = typename V::T;
  dw_corr3x3_kernel<V, R, NB><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(k), static_cast<T*>(out), B, H, W, CV,
      nruns, x_bstride, k_bstride);
  return (int)cudaGetLastError();
}

int check_shape(int B, int H, int W, int C) {
  if ((long long)H * W * C > 0x7fffffffLL || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// x: (B, H, W, C) with (H, W, C) contiguous and batch stride x_bstride
// (elements, may be 0); k: (B, 3, 3, C) with (3, 3, C) contiguous and batch
// stride k_bstride (may be 0); out: contiguous (B, H, W, C). All pointers
// 16-byte aligned; C and the batch strides multiples of one vector (4
// float32 or 8 bf16 channels; the wrapper checks). One image, H * W * C,
// must fit an int; H and B at most 65535. Returns cudaGetLastError() after
// the launch (cudaErrorInvalidValue for a shape out of those bounds).
extern "C" int dw_corr3x3_f32(const float* x, const float* k, float* out,
                              int B, int H, int W, int C,
                              long long x_bstride, long long k_bstride,
                              void* stream) {
  if (B == 0 || H == 0 || W == 0 || C == 0) return 0;
  if (int err = check_shape(B, H, W, C)) return err;
  if (x_bstride == 0 && B > 1)
    return launch<F32x4, 8, 2>(x, k, out, B, H, W, C, x_bstride, k_bstride, stream);
  return launch<F32x4, 4, 1>(x, k, out, B, H, W, C, x_bstride, k_bstride, stream);
}

extern "C" int dw_corr3x3_bf16(const void* x, const void* k, void* out,
                               int B, int H, int W, int C,
                               long long x_bstride, long long k_bstride,
                               void* stream) {
  if (B == 0 || H == 0 || W == 0 || C == 0) return 0;
  if (int err = check_shape(B, H, W, C)) return err;
  return launch<BF16x8, 4, 1>(x, k, out, B, H, W, C, x_bstride, k_bstride, stream);
}
