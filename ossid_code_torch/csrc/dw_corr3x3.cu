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
//  * one thread per output (b, y, x, 4-channel vector): float4 loads and
//    stores along C, neighbouring threads on neighbouring addresses. The
//    grid is (row segments, H, B), so a thread finds its (b, y) in blockIdx
//    and its (x, c4) with one 32-bit division: no 64-bit index arithmetic;
//  * the 9 taps are applied with the zero padding as a bounds check, so no
//    padded copy of x is made (the Pallas wrapper padded x in HBM);
//  * x and k come with their batch strides as arguments: a stride of 0
//    reads the broadcast image feature (correlation head) or the broadcast
//    global kernel (stem) once, without materialising the broadcast; the
//    other 8 taps of a neighbour are L1/L2 hits.
// No tensor cores: there is no reduction over channels to feed them.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
dw_corr3x3_kernel(const float* __restrict__ x, const float* __restrict__ k,
                  float* __restrict__ out, int H, int W, int C4,
                  long long x_bstride, long long k_bstride) {
  const int row = W * C4;                            // float4s in one image row
  const int t = blockIdx.x * THREADS + threadIdx.x;  // px * C4 + c4
  if (t >= row) return;
  const int py = blockIdx.y;
  const int b = blockIdx.z;
  const int px = t / C4;
  const int c4 = t - px * C4;

  const float4* xb = reinterpret_cast<const float4*>(x + b * x_bstride) + t;
  const float4* kb = reinterpret_cast<const float4*>(k + b * k_bstride) + c4;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const int yy = py + dy - 1;
    if (yy < 0 || yy >= H) continue;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int xx = px + dx - 1;
      if (xx < 0 || xx >= W) continue;
      const float4 v = __ldg(xb + yy * row + (dx - 1) * C4);
      const float4 w = __ldg(kb + (dy * 3 + dx) * C4);
      acc.x = fmaf(v.x, w.x, acc.x);
      acc.y = fmaf(v.y, w.y, acc.y);
      acc.z = fmaf(v.z, w.z, acc.z);
      acc.w = fmaf(v.w, w.w, acc.w);
    }
  }
  reinterpret_cast<float4*>(out)[((long long)b * H + py) * row + t] = acc;
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
  const dim3 grid((unsigned)((W * C4 + THREADS - 1) / THREADS), (unsigned)H, (unsigned)B);
  dw_corr3x3_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      x, k, out, H, W, C4, x_bstride, k_bstride);
  return (int)cudaGetLastError();
}
