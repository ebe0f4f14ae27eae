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
// Kernel 1 (float32), what the design does about it:
//  * a thread owns one channel vector cv (16 bytes: 4 float32 channels) of R
//    consecutive outputs of one row (b, y): it keeps the k taps of its
//    vector in registers and slides a 3-column window of x along the row, so
//    each new output costs 3 vector loads of x (one per kernel row) where one
//    thread per output made 9 of x and 9 of k: at R = 4, 27 loads for 4
//    outputs in place of 72;
//  * where x is broadcast over a frame's templates (the correlation head:
//    one image feature, T templates), a thread covers 2 templates of the
//    same frame and pixels, so each x load serves both, and runs of R = 8; a
//    block never spans two frames (a frame's last block holds one template
//    where T is odd);
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
// Kernel 1b (bf16) computes what kernel 1 computes on the widened operands:
// the taps and x widened to float32 (exact), the 9 products of an output
// accumulated in float32 with fmaf in the same dy-major, dx-minor order,
// rows outside the image skipped and columns outside it multiplied as zeros,
// and the sum rounded once to bf16 (round to nearest even) at the store. So
// its result is bit for bit bf16(kernel 1(x.float(), k.float())). That is
// what the JAX package computes in bf16: its default lowering is XLA's
// grouped convolution (Pallas is opt-in), whose bf16 result equals the
// float32 result rounded once; the Pallas body would round every product
// and partial sum to bf16 instead.
//
// What held the first 1b (kernel 1's template on 8-channel vectors, PR 4)
// below half of its bound: 130 registers, so one 256-thread block an SM (8
// warps: too few loads in flight), every template re-reading x's three rows
// from L2 (4.5 vector loads an output against one store), row segments of
// 800 threads in 4 blocks at C = 640 with the last 1/8 busy, and a turned
// copy of the taps before each dx. Widening is not free in bf16: each x and
// tap value costs an instruction before its fmaf, so 1b issues more
// instructions an output than kernel 1 and moves half the bytes; its design
// spends few instructions an output and keeps many warps in flight. Two
// kernels, chosen per call (`choose`):
//  * the row walk (per-sample calls: the stem, the step's forward and dx at
//    batch 8; and, with 2 templates a thread, x shared over few samples:
//    one-frame serving's head, the farm's 2 x 10): a thread owns 2 channels
//    (one bf16x2 word) of 4 columns and walks 2-16 output rows down. Each x
//    row (6 words with the halo) is loaded and widened once and feeds the 3
//    output rows it touches (and both templates): 9 fmaf a channel, column
//    and template for one widening, against 3 in kernel 1's scheme. An
//    output row's sum starts at the row above and ends at the row below, so
//    it runs dy-major, dx-minor as kernel 1's. Loads run two rows ahead of
//    the sums; 72-80 registers with one template, 110-118 with two; no
//    shared memory, no barrier. dx reads the taps turned (tap 8 - d) in
//    place;
//  * the tile (x shared over 32 or more samples, or 16 with T odd: the
//    farm's 3 x 7, configuration 1's T = 160): a thread owns 4 channels (8
//    bytes) of 5 columns; a block takes a slice of up to 128 channels, a
//    row segment, 1-2 output rows and up to 16 templates of one frame. It
//    copies its x tile (its rows and columns with the halo) and its
//    templates' taps once into shared memory with 16-byte cp.async copies
//    that fill zeros outside the image, then walks the templates: x comes
//    from L2 once a block, not once a template, and 8-byte stores that a
//    warp writes as 256 contiguous bytes. 70 registers, 3 blocks an SM.
// Neither uses TMA: the tile's rows are 256-byte runs at a 1280-byte pitch
// that 16-byte cp.async copies with zero fill cover without a tensor map.

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

// Run length and samples per thread, as timed at the two main-path calls on
// an H100 80GB HBM3 (700 W): (8, 2) at the correlation head, where x is
// broadcast over the templates, (4, 1) at the stem (C = 64, B = 1).
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

// ---------------------------------------------------------------------------
// Kernel 1b (bf16): two kernels and the choice between them (see the head
// of the file).
namespace bf16 {

constexpr int THREADS = 256;

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Phase counters, when built with -DDW16_PHASES (tools/kernel_phases.py
// reads them): cycles of each warp (the tile: of each block's first warp)
// in 0 its prologue (the tile's copies and barrier; the row walk's taps) and
// 1 the rest, summed; then the warps counted, the first and the last warp's
// start and the last warp's end on the global timer (ns).
#ifdef DW16_PHASES
__device__ unsigned long long g_dw16_phases[6];
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define PHASE_START() \
  const unsigned long long ph_ns0 = global_ns(); long long ph_last = clock64(); unsigned long long ph[2] = {}
#define PHASE(i) do { const long long t_now = clock64(); ph[i] += t_now - ph_last; ph_last = t_now; } while (0)
#define PHASE_END(leader) do { if (leader) { \
    atomicAdd(&g_dw16_phases[0], ph[0]); atomicAdd(&g_dw16_phases[1], ph[1]); \
    atomicAdd(&g_dw16_phases[2], 1ull); atomicMin(&g_dw16_phases[3], ph_ns0); \
    atomicMax(&g_dw16_phases[4], ph_ns0); atomicMax(&g_dw16_phases[5], global_ns()); } } while (0)
#else
#define PHASE_START() do {} while (0)
#define PHASE(i) do {} while (0)
#define PHASE_END(leader) do {} while (0)
#endif

// ---- the tile kernel (x shared over many templates) ------------------------
constexpr int R = 5;              // outputs along a row a thread
constexpr int MAX_SLICE = 32;     // 4-channel vectors in a block's channel slice
constexpr int MAX_TEMPLATES = 16; // templates a block

// A tile: cs vectors of 4 channels, runs runs of R columns, ry output rows,
// tg templates of one frame.
struct Tile {
  int cs, runs, ry, tg;
};

__device__ __forceinline__ void widen(uint2 r, float (&v)[4]) {
  v[0] = __uint_as_float(r.x << 16);  // low half: channel 0
  v[1] = __uint_as_float(r.x & 0xffff0000u);
  v[2] = __uint_as_float(r.y << 16);
  v[3] = __uint_as_float(r.y & 0xffff0000u);
}

// 16 bytes global -> shared, asynchronously; zeros where !ok (src unread).
__device__ __forceinline__ void copy16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// Block (blockIdx.x = segment * slices + slice, blockIdx.y = row group,
// blockIdx.z = f * tgroups + template group). x, k, out in 8-byte vectors
// (4 bf16 channels), NV vectors a pixel; strides in vectors. Shared memory:
// the x tile [ry + 2][runs * R + 2][cs], then the taps [tg][9][cs].
__global__ void __launch_bounds__(THREADS, 3)
dw_corr3x3_kernel_bf16_tile(const uint2* __restrict__ x, const uint2* __restrict__ k, uint2* __restrict__ out,
                            int T, int H, int W, int NV, Tile p, int slices, long long x_fstride,
                            long long x_tstride, long long k_fstride, long long k_tstride) {
  extern __shared__ __align__(16) uint2 sm[];
  PHASE_START();
  const int cs = p.cs;
  const int tgroups = (T + p.tg - 1) / p.tg;
  const int f = blockIdx.z / tgroups;
  const int t0 = (blockIdx.z - f * tgroups) * p.tg;
  const int nt = min(p.tg, T - t0);
  const int seg = blockIdx.x / slices;
  const int v0 = (blockIdx.x - seg * slices) * cs;
  const int c0 = seg * p.runs * R;
  const int y0 = blockIdx.y * p.ry;
  const int trows = p.ry + 2, tcols = p.runs * R + 2;
  uint2* xs = sm;
  uint2* ks = sm + trows * tcols * cs;
  const uint2* xb = x + f * x_fstride + t0 * x_tstride;
  const uint2* kb = k + f * k_fstride + t0 * k_tstride;
  const int pairs = cs / 2;  // 16-byte copies a pixel's slice (cs even)
  const uint32_t xs_s = (uint32_t)__cvta_generic_to_shared(xs);
  for (int i = threadIdx.x; i < trows * tcols * pairs; i += THREADS) {
    const int q = i / pairs, v = v0 + 2 * (i - q * pairs);
    const int r = q / tcols, col = q - r * tcols;
    const int gy = y0 - 1 + r, gx = c0 - 1 + col;
    const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W && v < NV;
    copy16(xs_s + (uint32_t)(q * cs + v - v0) * 8u, ok ? xb + ((long long)gy * W + gx) * NV + v : xb, ok);
  }
  const uint32_t ks_s = (uint32_t)__cvta_generic_to_shared(ks);
  for (int i = threadIdx.x; i < p.tg * 9 * pairs; i += THREADS) {
    const int q = i / pairs, v = v0 + 2 * (i - q * pairs);
    const int t = q / 9;
    const bool ok = t < nt && v < NV;
    copy16(ks_s + (uint32_t)(q * cs + v - v0) * 8u, ok ? kb + t * k_tstride + (q - t * 9) * NV + v : kb, ok);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  PHASE(0);

  const int run = threadIdx.x / cs;
  const int cv = threadIdx.x - run * cs;
  const int v = v0 + cv;
  const int lx = run * R;  // tile column of the run's left neighbour
  const int gx0 = c0 + lx;
  if (run >= p.runs || v >= NV || gx0 >= W) return;  // thread 0 never returns: v0 < NV, c0 < W
  const int nry = min(p.ry, H - y0);
  for (int t = 0; t < nt; ++t) {
    const uint2* kt = ks + t * 9 * cs + cv;
    const long long b = (long long)f * T + t0 + t;
    for (int r = 0; r < nry; ++r) {
      const int y = y0 + r;
      float acc[R][4];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
      // dy-major, dx-minor, as kernel 1
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const int yy = y + dy - 1;
        if (yy < 0 || yy >= H) continue;
        float w0[4], w1[4], w2[4];
        widen(kt[(dy * 3) * cs], w0);
        widen(kt[(dy * 3 + 1) * cs], w1);
        widen(kt[(dy * 3 + 2) * cs], w2);
        const uint2* xr = xs + ((r + dy) * tcols + lx) * cs + cv;
        float left[4], mid[4], right[4];
        widen(xr[0], left);
        widen(xr[cs], mid);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          widen(xr[(i + 2) * cs], right);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[i][e] = fmaf(left[e], w0[e], acc[i][e]);
            acc[i][e] = fmaf(mid[e], w1[e], acc[i][e]);
            acc[i][e] = fmaf(right[e], w2[e], acc[i][e]);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            left[e] = mid[e];
            mid[e] = right[e];
          }
        }
      }
      uint2* o = out + ((b * H + y) * W + gx0) * NV + v;
#pragma unroll
      for (int i = 0; i < R; ++i)
        if (gx0 + i < W) o[(long long)i * NV] = make_uint2(pack(acc[i][0], acc[i][1]), pack(acc[i][2], acc[i][3]));
    }
  }
  PHASE(1);
  PHASE_END(threadIdx.x == 0);
}

int tile_smem(const Tile& p) {
  return ((p.ry + 2) * (p.runs * R + 2) * p.cs + p.tg * 9 * p.cs) * (int)sizeof(uint2);
}

// ---- the row-walking kernel ---------------------------------------------
constexpr int RR = 4;  // outputs along a row a thread

// A block of 32 lanes over channel pairs x tw templates of one frame x rw
// runs of RR columns; ry output rows a thread.
struct Rows {
  int tw, rw, ry, nb;  // nb: templates a thread (1, or 2 where x is shared)
};

__device__ __forceinline__ void widen2(uint32_t r, float (&v)[2]) {
  v[0] = __uint_as_float(r << 16);  // low half: channel 0
  v[1] = __uint_as_float(r & 0xffff0000u);
}

// x, k, out in bf16x2 words, NP words a pixel; strides in words. A thread
// walks x rows y0 - 1 .. y0 + RY (loads run two rows ahead of the sums);
// with flip, it reads the taps turned by 180 degrees (tap d as 8 - d): dx.
template <int RY, int NB>
__global__ void __launch_bounds__(THREADS, NB == 1 ? 3 : 2)
dw_corr3x3_kernel_bf16_rows(const uint32_t* __restrict__ x, const uint32_t* __restrict__ k,
                            uint32_t* __restrict__ out, int T, int H, int W, int NP, int tw, int rw, int cvgroups,
                            int flip, long long x_fstride, long long x_tstride, long long k_fstride,
                            long long k_tstride) {
  const int rg = blockIdx.x / cvgroups;
  const int cv = (blockIdx.x - rg * cvgroups) * 32 + threadIdx.x;
  const int x0 = (rg * rw + threadIdx.y / tw) * RR;
  const int tgroups = (T + tw * NB - 1) / (tw * NB);
  const int f = blockIdx.z / tgroups;
  const int t = ((blockIdx.z - f * tgroups) * tw + threadIdx.y % tw) * NB;
  if (cv >= NP || x0 >= W || t >= T) return;
  const int nb = T - t < NB ? T - t : NB;  // the thread's templates
  PHASE_START();
  const int y0 = blockIdx.y * RY;
  const uint32_t* xb = x + f * x_fstride + t * x_tstride + cv;
  const uint32_t* kb = k + f * k_fstride + t * k_tstride + cv;
  uint32_t* ob = out + ((long long)(f * T + t) * H * W) * NP + cv;
  float w[NB][9][2];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int d = 0; d < 9; ++d) widen2(__ldg(kb + (b < nb ? b : 0) * k_tstride + (flip ? 8 - d : d) * NP), w[b][d]);
  PHASE(0);
  bool colok[RR + 2];
#pragma unroll
  for (int i = 0; i < RR + 2; ++i) colok[i] = x0 - 1 + i >= 0 && x0 - 1 + i < W;
  float acc[NB][3][RR][2];  // template b's output row l in acc[b][l % 3]
  uint32_t buf[3][RR + 2];  // x row j in buf[j % 3]
  auto load_row = [&](int yy, uint32_t (&v)[RR + 2]) {
    const bool rowok = yy >= 0 && yy < H;
    const uint32_t* xr = xb + ((long long)yy * W + x0 - 1) * NP;
#pragma unroll
    for (int i = 0; i < RR + 2; ++i) v[i] = rowok && colok[i] ? __ldg(xr + i * NP) : 0u;
  };
  load_row(y0 - 1, buf[0]);
  load_row(y0, buf[1]);
#pragma unroll
  for (int j = 0; j < RY + 2; ++j) {  // x row yy = y0 - 1 + j
    const int yy = y0 - 1 + j;
    if (j + 2 < RY + 2) load_row(yy + 2, buf[(j + 2) % 3]);
    if (j < RY) {
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int i = 0; i < RR; ++i) acc[b][j % 3][i][0] = acc[b][j % 3][i][1] = 0.f;
    }
    if (yy >= 0 && yy < H) {  // rows outside the image are skipped, as kernel 1 skips them
      const uint32_t(&cur)[RR + 2] = buf[j % 3];
      float left[2], mid[2], right[2];
      widen2(cur[0], left);
      widen2(cur[1], mid);
#pragma unroll
      for (int i = 0; i < RR; ++i) {
        widen2(cur[i + 2], right);
#pragma unroll
        for (int b = 0; b < NB; ++b)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (j < RY) {  // the output row below starts: dy = 0
              float& a = acc[b][j % 3][i][e];
              a = fmaf(left[e], w[b][0][e], a);
              a = fmaf(mid[e], w[b][1][e], a);
              a = fmaf(right[e], w[b][2][e], a);
            }
            if (j >= 1 && j <= RY) {  // its own output row: dy = 1
              float& a = acc[b][(j + 2) % 3][i][e];
              a = fmaf(left[e], w[b][3][e], a);
              a = fmaf(mid[e], w[b][4][e], a);
              a = fmaf(right[e], w[b][5][e], a);
            }
            if (j >= 2) {  // the output row above completes: dy = 2
              float& a = acc[b][(j + 1) % 3][i][e];
              a = fmaf(left[e], w[b][6][e], a);
              a = fmaf(mid[e], w[b][7][e], a);
              a = fmaf(right[e], w[b][8][e], a);
            }
          }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          left[e] = mid[e];
          mid[e] = right[e];
        }
      }
    }
    if (j >= 2 && yy - 1 < H) {  // output row yy - 1 is complete
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        if (b >= nb) break;
        uint32_t* o = ob + ((long long)b * H * W + (long long)(yy - 1) * W + x0) * NP;
#pragma unroll
        for (int i = 0; i < RR; ++i)
          if (x0 + i < W) o[i * NP] = pack(acc[b][(j + 1) % 3][i][0], acc[b][(j + 1) % 3][i][1]);
      }
    }
  }
  PHASE(1);
  PHASE_END(threadIdx.x == 0);
}

// ---- the choice -------------------------------------------------------------
// The card's SMs (cached per device; 132 on an H100 SXM).
int sm_count() {
  static int counts[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (counts[dev] == 0) {
    int n = 0;
    counts[dev] = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) == cudaSuccess && n > 0 ? n : 132;
  }
  return counts[dev];
}

// Grants the tile kernel `bytes` of dynamic shared memory on the current
// device where that is over the default 48 KB and over what it was granted.
int allow_smem(int bytes) {
  static int allowed[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (bytes > 48 * 1024 && bytes > allowed[dev]) {
    const cudaError_t err =
        cudaFuncSetAttribute(dw_corr3x3_kernel_bf16_tile, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    allowed[dev] = bytes;
  }
  return 0;
}

// The call's frames, templates and strides (in elements): a per-sample batch
// with x broadcast (T = 1, x_fstride = 0) is one frame of B templates
// sharing x; a per-sample batch otherwise is B frames of one template.
struct Call {
  int F, T;
  bool shared_x;
  long long xf, xt, kf, kt;
};

Call call_of(int B, int T, long long x_fstride, long long x_tstride, long long k_fstride, long long k_tstride) {
  if (T == 1 && x_fstride == 0 && B > 1) return {1, B, true, 0, 0, 0, k_fstride};
  return {B / T, T, T > 1 && x_tstride == 0, x_fstride, x_tstride, k_fstride, k_tstride};
}

enum Kernel { TILE = 1, ROWS = 2, ROWS2 = 3 };  // ROWS2: the row walk with 2 templates a thread
// frames x templates sharing x from which the tile kernel runs; with T odd
// (the row walk's pairs leave a lone template a frame) from TILE_MIN_ODD
constexpr int TILE_MIN_SAMPLES = 32;
constexpr int TILE_MIN_ODD = 16;

// The kernel and its shape for a call; `kernel` 1-3 forces one, and each of
// (a, b, c) > 0 overrides the choice's (cs, ry, tg) of a tile or (tw, rw,
// ry) of rows. Per-sample calls take the row walk; where x is shared, the
// tile from TILE_MIN_SAMPLES samples (TILE_MIN_ODD with T odd), else the row
// walk with 2 templates a thread. Tile: the widest slice (up to 32
// vectors), runs to cover W in 256 threads, templates a block up to 16
// evened out over the frame's T, and two rows a block where the grid then
// still holds 1.5 to 4 blocks an SM, else one. Rows: blocks of 32 lanes x 2
// templates (1 template pair with 2 a thread; 1 where x is not shared) x 2
// runs where the row's runs pair up (else 1), and the most rows a thread
// (16, 8, 4, 2) that leave at least 14 warps an SM in the grid. (Timed at
// every main-path shape on an H100 80GB HBM3 at 700 W:
// tools/dw_bf16_plans.py.)
struct Choice {
  int kernel;
  Tile tile;
  Rows rows;
};

Choice choose(const Call& c, int H, int W, int C, int kernel, int a, int b, int cc) {
  const long long sms = sm_count();
  Choice ch{};
  const long long samples = (long long)c.F * c.T;
  ch.kernel = kernel > 0 ? kernel
              : !c.shared_x ? ROWS
              : samples >= TILE_MIN_SAMPLES || (c.T % 2 && samples >= TILE_MIN_ODD) ? TILE
                                                                                    : ROWS2;
  if (ch.kernel == ROWS2 && !c.shared_x) ch.kernel = ROWS;
  if (ch.kernel == TILE) {
    const int NV = C / 4;
    Tile& p = ch.tile;
    p.cs = a > 0 ? a : (NV < MAX_SLICE ? NV : MAX_SLICE);
    const int runs_w = (W + R - 1) / R;
    p.runs = THREADS / p.cs < runs_w ? THREADS / p.cs : runs_w;
    const int groups = (c.T + MAX_TEMPLATES - 1) / MAX_TEMPLATES;
    p.tg = cc > 0 ? cc : (c.shared_x ? (c.T + groups - 1) / groups : 1);
    if (!c.shared_x) p.tg = 1;
    const long long per_row = (long long)((NV + p.cs - 1) / p.cs) * ((W + p.runs * R - 1) / (p.runs * R)) * c.F *
                              ((c.T + p.tg - 1) / p.tg);
    const long long blocks2 = per_row * ((H + 1) / 2);
    p.ry = b > 0 ? b : (2 * blocks2 >= 3 * sms && blocks2 <= 4 * sms ? 2 : 1);
  } else {
    Rows& p = ch.rows;
    p.nb = ch.kernel == ROWS2 && c.shared_x ? 2 : 1;
    p.tw = a > 0 ? a : (c.shared_x && p.nb == 1 && c.T > 1 ? 2 : 1);
    if (!c.shared_x) p.tw = 1;
    const int nruns = (W + RR - 1) / RR;
    p.rw = b > 0 ? b : (nruns % 2 ? 1 : 2);
    const long long lanes = (long long)((C / 2 + 31) / 32) * nruns * c.F * ((c.T + p.nb - 1) / p.nb);
    p.ry = 2;
    const int rys[] = {16, 8, 4};
    for (int ry : rys)
      if (lanes * ((H + ry - 1) / ry) >= 14 * sms) {
        p.ry = ry;
        break;
      }
    if (cc > 0) p.ry = cc;
  }
  return ch;
}

// Launches the choice; returns cudaGetLastError() (cudaErrorInvalidValue for
// a choice out of the kernels' bounds).
int launch(const void* x, const void* k, void* out, int B, int T, int H, int W, int C, long long x_fstride,
           long long x_tstride, long long k_fstride, long long k_tstride, int kernel, int a, int b, int cc, int flip,
           void* stream) {
  const Call c = call_of(B, T, x_fstride, x_tstride, k_fstride, k_tstride);
  const Choice ch = choose(c, H, W, C, flip ? ROWS : kernel, a, b, cc);
  const cudaStream_t s = (cudaStream_t)stream;
  if (ch.kernel == TILE) {
    const Tile& p = ch.tile;
    const int NV = C / 4;
    if (p.cs < 2 || p.cs % 2 || p.cs > MAX_SLICE || p.cs * p.runs > THREADS || p.ry < 1 || p.tg < 1)
      return (int)cudaErrorInvalidValue;
    const int slices = (NV + p.cs - 1) / p.cs;
    const long long zblocks = (long long)c.F * ((c.T + p.tg - 1) / p.tg);
    if (zblocks > 65535) return (int)cudaErrorInvalidValue;
    const int bytes = tile_smem(p);
    if (int err = allow_smem(bytes)) return err;
    const dim3 grid((unsigned)(slices * ((W + p.runs * R - 1) / (p.runs * R))), (unsigned)((H + p.ry - 1) / p.ry),
                    (unsigned)zblocks);
    dw_corr3x3_kernel_bf16_tile<<<grid, THREADS, bytes, s>>>(
        static_cast<const uint2*>(x), static_cast<const uint2*>(k), static_cast<uint2*>(out), c.T, H, W, NV, p,
        slices, c.xf / 4, c.xt / 4, c.kf / 4, c.kt / 4);
    return (int)cudaGetLastError();
  }
  if (ch.kernel != ROWS && ch.kernel != ROWS2) return (int)cudaErrorInvalidValue;
  const Rows& p = ch.rows;
  const int NP = C / 2;
  if (p.tw < 1 || p.rw < 1 || p.tw * p.rw > 8 || p.nb < 1 || p.nb > 2) return (int)cudaErrorInvalidValue;
  const int cvgroups = (NP + 31) / 32;
  const int rungroups = ((W + RR - 1) / RR + p.rw - 1) / p.rw;
  const long long zblocks = (long long)c.F * ((c.T + p.tw * p.nb - 1) / (p.tw * p.nb));
  if (zblocks > 65535) return (int)cudaErrorInvalidValue;
  const dim3 block(32, p.tw * p.rw);
  const dim3 grid((unsigned)(cvgroups * rungroups), (unsigned)((H + p.ry - 1) / p.ry), (unsigned)zblocks);
  auto kx = static_cast<const uint32_t*>(x);
  auto kk = static_cast<const uint32_t*>(k);
  auto ko = static_cast<uint32_t*>(out);
  const long long xf = c.xf / 2, xt = c.xt / 2, kf = c.kf / 2, kt = c.kt / 2;
#define ROWS_CASE(RY, NB)                                                                                         \
  case RY * 4 + NB:                                                                                               \
    dw_corr3x3_kernel_bf16_rows<RY, NB><<<grid, block, 0, s>>>(kx, kk, ko, c.T, H, W, NP, p.tw, p.rw, cvgroups,   \
                                                               flip, xf, xt, kf, kt);                             \
    break;
  switch (p.ry * 4 + p.nb) {
    ROWS_CASE(2, 1)
    ROWS_CASE(4, 1)
    ROWS_CASE(8, 1)
    ROWS_CASE(16, 1)
    ROWS_CASE(2, 2)
    ROWS_CASE(4, 2)
    ROWS_CASE(8, 2)
    ROWS_CASE(16, 2)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef ROWS_CASE
  return (int)cudaGetLastError();
}

}  // namespace bf16

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
// and the blocks over frames and templates (F * ceil(T / NB) in float32; in
// bf16 F * ceil(T / templates a block)) at most 65535, T at least 1 and a
// divisor of B.
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
  return bf16::launch(x, k, out, B, T, H, W, C, x_fstride, x_tstride, k_fstride, k_tstride, 0, 0, 0, 0, 0, stream);
}

// dw_corr3x3_bf16 with the taps turned by 180 degrees (read as tap 8 - d; the
// row-walking kernel): dx of 1b on dout, without a turned copy of the taps.
extern "C" int dw_corr3x3_bf16_flipped(const void* x, const void* k, void* out, int B, int T, int H, int W, int C,
                                       long long x_fstride, long long x_tstride, long long k_fstride,
                                       long long k_tstride, void* stream) {
  if (B == 0 || H == 0 || W == 0 || C == 0) return 0;
  if (int err = check_shape(B, T, H, W, C)) return err;
  return bf16::launch(x, k, out, B, T, H, W, C, x_fstride, x_tstride, k_fstride, k_tstride, 0, 0, 0, 0, 1, stream);
}

// dw_corr3x3_bf16 with the kernel (1: tile, 2: rows; 0: the choice's) and
// its shape fixed where > 0: (a, b, c) = (slice vectors, rows, templates) of
// a tile, (templates, runs, rows a thread: 2, 4, 8 or 16) of rows. For tools
// that time other shapes.
extern "C" int dw_corr3x3_bf16_planned(const void* x, const void* k, void* out, int B, int T, int H, int W, int C,
                                       long long x_fstride, long long x_tstride, long long k_fstride,
                                       long long k_tstride, int kernel, int a, int b, int c, void* stream) {
  if (B == 0 || H == 0 || W == 0 || C == 0) return 0;
  if (int err = check_shape(B, T, H, W, C)) return err;
  return bf16::launch(x, k, out, B, T, H, W, C, x_fstride, x_tstride, k_fstride, k_tstride, kernel, a, b, c, 0,
                      stream);
}

// The choice dw_corr3x3_bf16 (flip: dw_corr3x3_bf16_flipped; kernel, a, b, c
// as dw_corr3x3_bf16_planned) takes for a call, into out[9]: the kernel (1
// tile, 2 rows), its shape (a, b, c as above), shared memory a block, blocks
// in the grid, threads a block, blocks an SM holds at once (the occupancy
// calculator) and the kernel's registers a thread.
extern "C" int dw_corr3x3_bf16_plan(int B, int T, int H, int W, int C, long long x_fstride, long long x_tstride,
                                    int kernel, int a, int b, int c, int flip, int* out) {
  if (int err = check_shape(B, T, H, W, C)) return err;
  const bf16::Call call = bf16::call_of(B, T, x_fstride, x_tstride, 0, 0);
  const bf16::Choice ch = bf16::choose(call, H, W, C, flip ? bf16::ROWS : kernel, a, b, c);
  int per_sm = 0, bytes = 0, threads = 0;
  long long blocks = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaSuccess;
  if (ch.kernel == bf16::TILE) {
    const bf16::Tile& p = ch.tile;
    bytes = bf16::tile_smem(p);
    threads = bf16::THREADS;
    blocks = (long long)((C / 4 + p.cs - 1) / p.cs) * ((W + p.runs * bf16::R - 1) / (p.runs * bf16::R)) *
             ((H + p.ry - 1) / p.ry) * call.F * ((call.T + p.tg - 1) / p.tg);
    out[1] = p.cs, out[2] = p.ry, out[3] = p.tg;
    err = (cudaError_t)bf16::allow_smem(bytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bf16::dw_corr3x3_kernel_bf16_tile, threads, bytes);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, bf16::dw_corr3x3_kernel_bf16_tile);
  } else {
    const bf16::Rows& p = ch.rows;
    threads = 32 * p.tw * p.rw;
    blocks = (long long)((C / 2 + 31) / 32) * (((W + bf16::RR - 1) / bf16::RR + p.rw - 1) / p.rw) *
             ((H + p.ry - 1) / p.ry) * call.F * ((call.T + p.tw * p.nb - 1) / (p.tw * p.nb));
    out[1] = p.tw, out[2] = p.rw, out[3] = p.ry;
    const void* fns[2][4] = {
        {(const void*)bf16::dw_corr3x3_kernel_bf16_rows<2, 1>, (const void*)bf16::dw_corr3x3_kernel_bf16_rows<4, 1>,
         (const void*)bf16::dw_corr3x3_kernel_bf16_rows<8, 1>, (const void*)bf16::dw_corr3x3_kernel_bf16_rows<16, 1>},
        {(const void*)bf16::dw_corr3x3_kernel_bf16_rows<2, 2>, (const void*)bf16::dw_corr3x3_kernel_bf16_rows<4, 2>,
         (const void*)bf16::dw_corr3x3_kernel_bf16_rows<8, 2>, (const void*)bf16::dw_corr3x3_kernel_bf16_rows<16, 2>}};
    const void* fn = fns[p.nb - 1][p.ry == 2 ? 0 : p.ry == 4 ? 1 : p.ry == 8 ? 2 : 3];
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, 0);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn);
  }
  if (err != cudaSuccess) return (int)err;
  out[0] = ch.kernel;
  out[4] = bytes;
  out[5] = (int)blocks;
  out[6] = threads;
  out[7] = per_sm;
  out[8] = attr.numRegs;
  return 0;
}

#ifdef DW16_PHASES
// 1b's phase counters since the last call (then reset), into out[6].
extern "C" int dw_corr3x3_bf16_phases(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, bf16::g_dw16_phases, sizeof(bf16::g_dw16_phases));
  const unsigned long long reset[6] = {0, 0, 0, ~0ull, 0, 0};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(bf16::g_dw16_phases, reset, sizeof(reset));
  return (int)err;
}
#endif
