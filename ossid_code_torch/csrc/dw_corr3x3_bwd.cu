// Kernel gradient of the per-sample 3x3 depthwise cross-correlation (zero
// padding 1, NHWC), in float32 (kernel 3) or bfloat16 (kernel 3b). The
// forward is
//   out[b, y, x, c] = sum_{i, j in 0..2} xpad[b, y + i, x + j, c] * k[b, i, j, c]
// and this file computes
//   dk[b, i, j, c] = sum_{y, x} xpad[b, y + i, x + j, c] * dout[b, y, x, c],
// a reduction over H * W for each (b, tap, c). The input gradient dx is the
// forward kernel (dw_corr3x3.cu) run on dout with the taps turned by 180
// degrees, so it needs no kernel of its own.
//
// Replaces: the gradient that JAX takes of ossid_code_tpu/ops/conv.py::
// depthwise_corr through XLA's grouped convolution (the Pallas kernel
// ossid_code_tpu/ops/pallas_kernels.py::dw_corr3x3_pallas is forward-only).
// The DTOID finetune step runs it at the image-encoder stem, x (8, 240, 320,
// 64), and at the correlation head, x (8, 29, 39, 640), once each per step.
//
// What bounds it on an H100: memory. It reads x and dout once (18 flops per
// element pair) and writes B * 9 * C sums, so the least time is the two
// inputs' bytes over the HBM rate.
//
// What the design does about it:
//  * a thread owns one 4-channel vector c4 and walks runs of R outputs along
//    a row, sliding a 3 x 3 window of x vectors (3 new loads per output, one
//    per kernel row) against one load of dout, with the 9 tap sums in
//    registers: each x value is read once for all 9 taps;
//  * neighbouring threads hold neighbouring channel vectors of the same
//    pixel, so every load is coalesced along C (TX = min(C / 4, 32) lanes
//    along C, TY = 256 / TX runs in flight per block);
//  * the reduction has two stages and no atomics, so repeated runs are
//    bitwise equal: each block sums its threads' registers in a fixed order
//    through shared memory into one partial row per (b, chunk, tap, c), and
//    a second kernel sums the chunks of each (b, tap, c) in order;
//  * the zero padding is a bounds check; x comes with its batch stride, so a
//    stride-0 broadcast is read in place (dout is always per sample).
//
// bf16 (kernel 3b): x and dout are read as 8-byte vectors of 4 bf16 channels
// and widened to float32 in registers; the products, both stages of the
// reduction and the partial rows stay float32, and dk is rounded once to
// bf16 when the second stage stores it. The order of every sum is the
// float32 instance's, so 3b is bitwise repeatable too.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int R = 8;          // outputs per run along a row
constexpr int MAX_CHUNKS = 64;

// One 4-channel vector of the element type: float4 (16 bytes) or 4 bf16
// (8 bytes), read and written as float4 registers.
struct F32 {
  using T = float;
  using raw = float4;
  static __device__ __forceinline__ float4 widen(const raw& r) { return r; }
  static __device__ __forceinline__ raw narrow(const float4& v) { return v; }
};

struct BF16 {
  using T = __nv_bfloat16;
  using raw = uint2;
  static __device__ __forceinline__ float4 widen(const raw& r) {
    return make_float4(__uint_as_float(r.x << 16), __uint_as_float(r.x & 0xffff0000u),
                       __uint_as_float(r.y << 16), __uint_as_float(r.y & 0xffff0000u));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // round to nearest even
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  static __device__ __forceinline__ raw narrow(const float4& v) {
    return make_uint2(pack(v.x, v.y), pack(v.z, v.w));
  }
};

__device__ __forceinline__ void fma4(float4& acc, const float4& v, const float4& w) {
  acc.x = fmaf(v.x, w.x, acc.x);
  acc.y = fmaf(v.y, w.y, acc.y);
  acc.z = fmaf(v.z, w.z, acc.z);
  acc.w = fmaf(v.w, w.w, acc.w);
}

__device__ __forceinline__ void add4(float4& acc, const float4& v) {
  acc.x += v.x;
  acc.y += v.y;
  acc.z += v.z;
  acc.w += v.w;
}

int lanes_along_c(int C4) { return C4 < 32 ? C4 : 32; }

int n_chunks(int H, int W, int C4) {
  const int ty = THREADS / lanes_along_c(C4);
  const long long items = (long long)H * ((W + R - 1) / R);
  const long long groups = (items + ty - 1) / ty;
  return (int)(groups < MAX_CHUNKS ? groups : MAX_CHUNKS);
}

// grid (ceil(C4 / TX), nchunks, B). Thread (tx, ty) of chunk `chunk` takes
// the runs chunk * TY + ty, then every nchunks * TY-th after it.
template <class V>
__global__ void __launch_bounds__(THREADS)
dk_partial_kernel(const typename V::T* __restrict__ x, const typename V::T* __restrict__ dout,
                  float* __restrict__ partial, int H, int W, int C4, int TX, int nruns,
                  int nchunks, long long x_bstride) {
  using raw = typename V::raw;
  __shared__ float4 red[9][THREADS];
  const int TY = THREADS / TX;
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const int c4 = blockIdx.x * TX + tx;
  const int chunk = blockIdx.y;
  const int b = blockIdx.z;
  const bool active = ty < TY && c4 < C4;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  float4 acc[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) acc[t] = zero;
  if (active) {
    const int row = W * C4;  // vectors in one image row
    const raw* xb = reinterpret_cast<const raw*>(x + b * x_bstride) + c4;
    const raw* gb = reinterpret_cast<const raw*>(dout) + (long long)b * H * row + c4;
    const int items = H * nruns;
    for (int item = chunk * TY + ty; item < items; item += nchunks * TY) {
      const int y = item / nruns;
      const int x0 = (item - y * nruns) * R;
      // win[i][j] = x[y + i - 1, xx + j - 1] for the current output column xx
      float4 win[3][3];
      const raw* xr[3];
      bool rok[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const int yy = y + i - 1;
        rok[i] = yy >= 0 && yy < H;
        xr[i] = xb + (long long)(rok[i] ? yy : 0) * row;
        win[i][0] = rok[i] && x0 > 0 ? V::widen(__ldg(xr[i] + (x0 - 1) * C4)) : zero;
        win[i][1] = rok[i] ? V::widen(__ldg(xr[i] + x0 * C4)) : zero;  // x0 < W
      }
      const raw* gr = gb + (long long)y * row;
#pragma unroll
      for (int s = 0; s < R; ++s) {
        const int xx = x0 + s;
        if (xx >= W) break;
#pragma unroll
        for (int i = 0; i < 3; ++i)
          win[i][2] = rok[i] && xx + 1 < W ? V::widen(__ldg(xr[i] + (xx + 1) * C4)) : zero;
        const float4 g = V::widen(__ldg(gr + xx * C4));
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
          for (int j = 0; j < 3; ++j) fma4(acc[i * 3 + j], win[i][j], g);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          win[i][0] = win[i][1];
          win[i][1] = win[i][2];
        }
      }
    }
  }
#pragma unroll
  for (int t = 0; t < 9; ++t) red[t][threadIdx.x] = acc[t];
  __syncthreads();
  if (ty >= TY || c4 >= C4) return;
  // lane tx of row ty sums taps ty, ty + TY, ... over the block's TY rows, in order
  for (int tap = ty; tap < 9; tap += TY) {
    float4 s = zero;
    for (int q = 0; q < TY; ++q) add4(s, red[tap][q * TX + tx]);
    reinterpret_cast<float4*>(partial)[(((long long)b * nchunks + chunk) * 9 + tap) * C4 + c4] = s;
  }
}

// one thread per (b, tap, c4): the chunks' partial sums, in chunk order
template <class V>
__global__ void __launch_bounds__(THREADS)
dk_reduce_kernel(const float* __restrict__ partial, typename V::T* __restrict__ dk, int B, int C4,
                 int nchunks) {
  const int t = blockIdx.x * THREADS + threadIdx.x;
  if (t >= B * 9 * C4) return;
  const int b = t / (9 * C4);
  const int r = t - b * 9 * C4;
  const float4* p = reinterpret_cast<const float4*>(partial) + (long long)b * nchunks * 9 * C4 + r;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int ch = 0; ch < nchunks; ++ch) add4(s, p[(long long)ch * 9 * C4]);
  reinterpret_cast<typename V::raw*>(dk)[t] = V::narrow(s);
}

template <class V>
int launch(const void* x, const void* dout, float* partial, void* dk, int B, int H, int W, int C,
           long long x_bstride, void* stream) {
  using T = typename V::T;
  if (B == 0 || C == 0) return 0;
  if ((long long)H * W * C > 0x7fffffffLL || B > 65535) return (int)cudaErrorInvalidValue;
  const int C4 = C / 4;
  cudaStream_t s = (cudaStream_t)stream;
  if (H == 0 || W == 0) {
    cudaMemsetAsync(dk, 0, (size_t)B * 9 * C * sizeof(T), s);
    return (int)cudaGetLastError();
  }
  const int tx = lanes_along_c(C4);
  const int nchunks = n_chunks(H, W, C4);
  const dim3 grid((unsigned)((C4 + tx - 1) / tx), (unsigned)nchunks, (unsigned)B);
  dk_partial_kernel<V><<<grid, THREADS, 0, s>>>(static_cast<const T*>(x), static_cast<const T*>(dout),
                                                partial, H, W, C4, tx, (W + R - 1) / R, nchunks,
                                                x_bstride);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  dk_reduce_kernel<V><<<(unsigned)((B * 9 * C4 + THREADS - 1) / THREADS), THREADS, 0, s>>>(
      partial, static_cast<T*>(dk), B, C4, nchunks);
  return (int)cudaGetLastError();
}

}  // namespace

// Number of chunks, the partial buffer's second dimension, for a shape: the
// wrapper allocates partial (B, chunks, 9, C) float32 (for either dtype).
extern "C" int dw_corr3x3_dk_chunks(int H, int W, int C) {
  return n_chunks(H, W, C / 4);
}

// x: (B, H, W, C) with (H, W, C) contiguous and batch stride x_bstride
// (elements, may be 0); dout: contiguous (B, H, W, C); partial: float32
// scratch (B, chunks, 9, C); dk: contiguous (B, 3, 3, C); x, dout and dk of
// one dtype, float32 (_f32) or bf16 (_bf16). C % 4 == 0, pointers aligned to
// one 4-channel vector (16 bytes in float32, 8 in bf16), x_bstride a
// multiple of 4 (the wrapper checks). One image, H * W * C, must fit an int;
// B at most 65535. Returns cudaGetLastError() after the two launches.
extern "C" int dw_corr3x3_dk_f32(const float* x, const float* dout, float* partial, float* dk,
                                 int B, int H, int W, int C, long long x_bstride, void* stream) {
  return launch<F32>(x, dout, partial, dk, B, H, W, C, x_bstride, stream);
}

extern "C" int dw_corr3x3_dk_bf16(const void* x, const void* dout, float* partial, void* dk,
                                  int B, int H, int W, int C, long long x_bstride, void* stream) {
  return launch<BF16>(x, dout, partial, dk, B, H, W, C, x_bstride, stream);
}
