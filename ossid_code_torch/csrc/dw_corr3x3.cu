// Per-sample 3x3 depthwise cross-correlation, zero padding 1, float32, NHWC:
//   out[b, y, x, c] = sum_{dy, dx in 0..2} xpad[b, y + dy, x + dx, c] * k[b, dy, dx, c]
//
// Replaces: ossid_code_tpu/ops/pallas_kernels.py::dw_corr3x3_pallas (body
// _dw_corr_kernel), reached through ossid_code_tpu/ops/conv.py::depthwise_corr.
// On DTOID's detect path it runs twice per frame: the correlation head,
// x (T, 29, 39, 640) with one image feature broadcast over the T templates,
// and the image-encoder stem, x (1, 240, 320, 64) with a broadcast kernel.
//
// What bounds it on an H100: memory. It does 18 flops per output element
// against 4 bytes written (and, at best, 4 read), so the least time is the
// bytes over the HBM rate: one read of x and k, one write of out.
//
// What the design does about it:
//  * a thread owns one 4-channel vector c4 of R consecutive outputs of
//    one row (b, y): it keeps the k taps of its vector in registers and
//    slides a 3-column window of x along the row, so each new output costs
//    3 float4 loads of x (one per kernel row) where one thread per output
//    made 9 of x and 9 of k: at R = 4, 27 loads for 4 outputs in place of 72;
//  * where x is broadcast over B (the correlation head: one image feature,
//    T templates), a thread covers 2 samples of the same pixels, so each x
//    load serves both, and runs of R = 8;
//  * neighbouring threads hold neighbouring channel vectors of the same run,
//    so every load and store is coalesced along C: at C = 640 (160 vectors)
//    a warp spans 32 vectors of one pixel, at C = 64 (16 vectors) two runs;
//    a ragged last run (W % R != 0) is masked at its loads and stores;
//  * the grid is (row segments, H, B / samples per thread): a thread finds
//    its (b, y) in blockIdx and its (run, c4) with one 32-bit division;
//  * the zero padding is a bounds check, so no padded copy of x is made (the
//    Pallas wrapper padded x in HBM);
//  * x and k come with their batch strides as arguments: a stride of 0
//    reads the broadcast image feature (correlation head) or the broadcast
//    global kernel (stem) in place, without materialising the broadcast.
// No tensor cores: there is no reduction over channels to feed them.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ void fma4(float4& acc, const float4& v, const float4& w) {
  acc.x = fmaf(v.x, w.x, acc.x);
  acc.y = fmaf(v.y, w.y, acc.y);
  acc.z = fmaf(v.z, w.z, acc.z);
  acc.w = fmaf(v.w, w.w, acc.w);
}

// R outputs along a row and NB samples b0 .. b0 + NB - 1 per thread (NB > 1
// only with x broadcast, so that every x load serves NB outputs).
template <int R, int NB>
__global__ void __launch_bounds__(THREADS)
dw_corr3x3_kernel(const float* __restrict__ x, const float* __restrict__ k,
                  float* __restrict__ out, int B, int H, int W, int C4, int nruns,
                  long long x_bstride, long long k_bstride) {
  const int t = blockIdx.x * THREADS + threadIdx.x;  // run * C4 + c4
  if (t >= nruns * C4) return;
  const int py = blockIdx.y;
  const int b0 = blockIdx.z * NB;
  const int run = t / C4;
  const int c4 = t - run * C4;
  const int x0 = run * R;
  const int row = W * C4;                            // float4s in one image row
  const int nb = B - b0 < NB ? B - b0 : NB;

  const float4* xb = reinterpret_cast<const float4*>(x + b0 * x_bstride) + c4;
  const float4* kb = reinterpret_cast<const float4*>(k + b0 * k_bstride) + c4;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 acc[NB][R];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int i = 0; i < R; ++i) acc[j][i] = zero;
  // Sum order per output is dy-major, dx-minor, as in a direct 3x3 loop.
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const int yy = py + dy - 1;
    if (yy < 0 || yy >= H) continue;
    float4 w[NB][3];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        w[j][dx] = j < nb ? __ldg(kb + j * (k_bstride >> 2) + (dy * 3 + dx) * C4) : zero;
    const float4* xr = xb + yy * row;
    float4 left = x0 > 0 ? __ldg(xr + (x0 - 1) * C4) : zero;
    float4 mid = __ldg(xr + x0 * C4);                // x0 < W
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int xx = x0 + i + 1;
      const float4 right = xx < W ? __ldg(xr + xx * C4) : zero;
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        fma4(acc[j][i], left, w[j][0]);
        fma4(acc[j][i], mid, w[j][1]);
        fma4(acc[j][i], right, w[j][2]);
      }
      left = mid;
      mid = right;
    }
  }
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    if (j >= nb) break;
    float4* o = reinterpret_cast<float4*>(out) + ((long long)(b0 + j) * H + py) * row + c4;
#pragma unroll
    for (int i = 0; i < R; ++i)
      if (x0 + i < W) o[(x0 + i) * C4] = acc[j][i];
  }
}

// Run length and samples per thread, as timed at the two main-path calls
// on an H100 80GB HBM3 (700 W): (8, 2) at the correlation head, where x is
// broadcast over the templates, (4, 1) at the stem (C = 64, B = 1).
template <int R, int NB>
int launch(const float* x, const float* k, float* out, int B, int H, int W, int C4,
           long long x_bstride, long long k_bstride, void* stream) {
  const int nruns = (W + R - 1) / R;
  const dim3 grid((unsigned)((nruns * C4 + THREADS - 1) / THREADS), (unsigned)H,
                  (unsigned)((B + NB - 1) / NB));
  dw_corr3x3_kernel<R, NB><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      x, k, out, B, H, W, C4, nruns, x_bstride, k_bstride);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (B, H, W, C) with (H, W, C) contiguous and batch stride x_bstride
// (elements, may be 0); k: (B, 3, 3, C) with (3, 3, C) contiguous and batch
// stride k_bstride (may be 0); out: contiguous (B, H, W, C). C % 4 == 0, all
// pointers 16-byte aligned, batch strides multiples of 4 (the wrapper checks).
// One image, H * W * C, must fit an int; H and B at most 65535.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// shape out of those bounds).
extern "C" int dw_corr3x3_f32(const float* x, const float* k, float* out,
                              int B, int H, int W, int C,
                              long long x_bstride, long long k_bstride,
                              void* stream) {
  if (B == 0 || H == 0 || W == 0 || C == 0) return 0;
  if ((long long)H * W * C > 0x7fffffffLL || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const int C4 = C / 4;
  if (x_bstride == 0 && B > 1) return launch<8, 2>(x, k, out, B, H, W, C4, x_bstride, k_bstride, stream);
  return launch<4, 1>(x, k, out, B, H, W, C4, x_bstride, k_bstride, stream);
}
