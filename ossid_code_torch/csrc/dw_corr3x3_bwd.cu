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
// inputs' bytes over the HBM rate. The design before this one (two
// launches) loaded each x vector three times, once per window row, through
// L1, kept a 3.5 MB float32 partial buffer between its launches at the
// correlation head, and read 8-byte vectors in bf16. At the finetune's
// sizes this design is bound by the instructions of its sums more than by
// memory: on an H100, a block at the head spends most of its cycles
// issuing copies and sums, few waiting on the ring, and the rest in the
// two reductions (tools/kernel_phases.py prints the split).
// So the sums' loop carries nothing but the window and the tile's column
// check: a step's slots lie in a row in the ring, and the window moves
// unconditionally.
//
// What the design does about it:
//  * one launch: a block owns a band of BH rows x a channel slice of CS
//    16-byte vectors (4 float32 or 8 bf16 channels) of one sample, in
//    column tiles; the bands of one (sample, slice) are one thread-block
//    cluster of at most 8 blocks, and the wrapper's plan
//    (ops/conv.py::dw_corr3x3_dk_plan) sizes slices and bands so that the
//    grid holds about two blocks for each SM at every shape;
//  * the band's x rows (with the 1-pixel halo) and dout rows stream into a
//    ring of shared-memory row slots by 16-byte cp.async, ROWS rows a step
//    and AHEAD steps ahead of the step being summed, so a block meets at one
//    barrier per ROWS rows. The zero padding is the copy's zero fill
//    (src-size 0). Each x and dout byte of the band crosses from L2 into the
//    SM once (halo rows and columns once more, from L2, for the neighbouring
//    band or tile). Each thread's copy addresses are set once per tile; a
//    row adds its row offset;
//  * a thread owns one column of the tile and 4 channels (one float32
//    vector, or half a bf16 one) and walks down the rows holding the last
//    two x rows of its 3 x 3 window in registers: an output costs 3 shared
//    loads of x and 1 of dout, and 9 vector FMAs into the 9 tap sums,
//    float32 in registers. Two columns a thread (4 x loads for 2 outputs)
//    spilled in float32 and, in bf16, gained at the head what it lost at
//    the stem, whose 320 columns its 128-column tiles do not divide;
//  * the reduction takes one fixed order and no atomics, so repeated runs
//    are bitwise equal: a thread's rows in order, the columns of a warp by a
//    shuffle tree, the warps of the block in order through shared memory,
//    then the cluster's bands in rank order through distributed shared
//    memory (no partial buffer in device memory, no second launch);
//  * x comes with its batch stride, so a stride-0 broadcast is read in
//    place (dout is always per sample).
//
// bf16 (kernel 3b): x and dout move as 16-byte vectors of 8 bf16 channels;
// a thread widens its 4 of them to float32 in registers; the products and
// every stage of the reduction stay float32, and dk is rounded once to bf16
// when it is stored. Both instances are one template (F32, BF16).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// The launch geometry; ops/conv.py plans launches with the same numbers
// (_DK_THREADS, _DK_SLICE_CHANNELS, _DK_MAX_BANDS, and Tile<V>::cols as the
// plan's tile_cols), and tests/test_torch_cuda.py launches every plan that
// its CPU test walks.
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SLICE_CHANNELS = 128;  // channels of one block's slice, at most
constexpr int MAX_BANDS = 8;         // blocks of one cluster (the portable limit)

// A thread's 4 channels: a float32 vector, or half of a bf16 one (Q, 8
// bytes), widened to float32. The instance's ring: ROWS row slots a step (one
// barrier; a multiple of 3, the window's rows), AHEAD steps in flight ahead
// of the one summed, so a step's slots are refilled AHEAD + 1 steps later.
struct F32 {
  using T = float;
  using Q = float4;
  static constexpr int VEC = 4;  // channels in 16 bytes
  static constexpr int ROWS = 3, AHEAD = 1, SLOTS = (AHEAD + 1) * ROWS;
  static __device__ __forceinline__ float4 widen(const float4& q) { return q; }
  static __device__ __forceinline__ void store4(T* p, const float4& v) { *reinterpret_cast<float4*>(p) = v; }
};

struct BF16 {
  using T = __nv_bfloat16;
  using Q = uint2;
  static constexpr int VEC = 8;
  static constexpr int ROWS = 3, AHEAD = 2, SLOTS = (AHEAD + 1) * ROWS;
  static __device__ __forceinline__ float4 widen(const uint2& q) {
    return make_float4(__uint_as_float(q.x << 16), __uint_as_float(q.x & 0xffff0000u),
                       __uint_as_float(q.y << 16), __uint_as_float(q.y & 0xffff0000u));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // round to nearest even
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  static __device__ __forceinline__ void store4(T* p, const float4& v) {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack(v.x, v.y), pack(v.z, v.w));
  }
};

__device__ __forceinline__ void add4(float4& acc, const float4& v) {
  acc.x += v.x;
  acc.y += v.y;
  acc.z += v.z;
  acc.w += v.w;
}

__device__ __forceinline__ void fma4(float4& acc, const float4& a, const float4& b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.y = fmaf(a.y, b.y, acc.y);
  acc.z = fmaf(a.z, b.z, acc.z);
  acc.w = fmaf(a.w, b.w, acc.w);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes where !ok (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory"); }

// Cycles of a block's phases, summed over blocks (thread 0 of each), and
// the launch's span on the global timer, when built with -DDK_PHASES
// (tools/kernel_phases.py reads them): 0 the prologue's copies, 1 waits for
// the ring (cp.async and the step's barrier), 2 the steps' copies and sums,
// 3 the block's reduction, 4 the cluster's; then blocks, the first and the
// last block's start and the last block's end (ns).
#ifdef DK_PHASES
__device__ unsigned long long g_dk_phases[9];
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define PHASE_START() \
  const unsigned long long ph_ns0 = global_ns(); long long ph_last = clock64(); unsigned long long ph[5] = {}
#define PHASE(i) do { const long long t_now = clock64(); ph[i] += t_now - ph_last; ph_last = t_now; } while (0)
#define PHASE_END() do { if (threadIdx.x == 0) { \
    for (int i = 0; i < 5; ++i) atomicAdd(&g_dk_phases[i], ph[i]); \
    atomicAdd(&g_dk_phases[5], 1ull); atomicMin(&g_dk_phases[6], ph_ns0); \
    atomicMax(&g_dk_phases[7], ph_ns0); atomicMax(&g_dk_phases[8], global_ns()); } } while (0)
#else
#define PHASE_START() do {} while (0)
#define PHASE(i) do {} while (0)
#define PHASE_END() do {} while (0)
#endif

// A tile of a block: L = CS * VEC / 4 lanes of 4 channels a column and
// THREADS / L columns. Row slot j of a tile holds x row y0 - 1 + j over the
// tile's columns and its two halo columns ((TW + 2) * CS vectors), then dout
// row y0 - 2 + j over the tile's columns (TW * CS vectors), 16-byte vectors
// with the channel vector fastest; j runs over 0 .. rows + 1, and once slot
// j has landed the output row y0 - 2 + j (j >= 2) is summed from x slots
// j - 2, j - 1 (in registers) and j.
template <class V>
struct Tile {
  static constexpr int LPV = V::VEC / 4;  // lanes of 4 channels in a vector
  __host__ __device__ static constexpr int lanes(int cs) { return cs * LPV; }
  __host__ __device__ static constexpr int cols(int cs) { return THREADS / lanes(cs); }
  __host__ __device__ static constexpr int xvec(int cs) { return (cols(cs) + 2) * cs; }
  __host__ __device__ static constexpr int slot(int cs) { return xvec(cs) + cols(cs) * cs; }  // vectors
};

// grid (bands, slices, B), cluster (bands, 1, 1): block (band, slice, b)
// sums rows [band * BH, band * BH + BH) of channel vectors [slice * CS,
// slice * CS + CS) of sample b, over column tiles in order. The block's
// slots run through its tiles in order (tile t's slot j is the block's
// slot t * (rows + 2) + j) and into the ring in that order, ROWS a step.
// Thread t owns column t / L of each tile and lane t % L (vector (t % L) /
// LPV, 4 channels from 4 * (t % LPV)).
template <class V>
__global__ void __launch_bounds__(THREADS, 2)
dk_kernel(const uint4* __restrict__ x, const uint4* __restrict__ dout, typename V::T* __restrict__ dk,
          int H, int W, int CV, int CS, int BH, long long x_bstride) {
  using Q = typename V::Q;
  using TL = Tile<V>;
  constexpr int ROWS = V::ROWS, AHEAD = V::AHEAD, SLOTS = V::SLOTS;
  extern __shared__ __align__(16) uint4 ring[];
  PHASE_START();
  const int L = TL::lanes(CS), TW = TL::cols(CS), XV = TL::xvec(CS), SV = TL::slot(CS);
  // the block's partial sums, past the ring and the warps' sums (which reuse it)
  float4* part = reinterpret_cast<float4*>(ring + max(SLOTS * SV, WARPS * 9 * L));
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = tid / L, lq = tid - c * L;  // this thread's column of a tile, and lane
  const int band = blockIdx.x, b = blockIdx.z, v0 = blockIdx.y * CS;
  const int y0 = band * BH, rows = min(H, y0 + BH) - y0, per_tile = rows + 2;
  const int tiles = (W + TW - 1) / TW, nslots = tiles * per_tile, steps = (nslots + ROWS - 1) / ROWS;
  const long long rowv = (long long)W * CV;  // vectors in one image row
  const uint4* xb = x + b * x_bstride;
  const uint4* gb = dout + (long long)b * H * rowv;

  // The copy side: this thread's x vectors p = tid, tid + THREADS (< XV)
  // and dout vector tid (< TW * CS) of a slot, their offsets in a row of
  // the image for the tile being issued, and whether they are inside it;
  // the slot being issued walks the ring and the image rows by increments.
  int it = -1, ij = per_tile, iy = 0;  // tile, slot j and x row y0 - 1 + j being issued
  int xoff[2], doff;
  bool xok[2], dok;
  uint4* islot = ring;                  // its ring slot
  int islot_i = 0;
  const uint4* xrow = xb;               // x row iy of sample b, dout row iy - 1
  const uint4* grow = gb;
  auto next_tile = [&]() {
    ++it;
    ij = 0;
    iy = y0 - 1;
    xrow = xb + iy * rowv;
    grow = gb + (iy - 1) * rowv;
    const int x0 = it * TW;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int p = tid + m * THREADS, pc = p / CS, q = p - pc * CS, col = x0 - 1 + pc;
      xok[m] = p < XV && col >= 0 && col < W && v0 + q < CV;
      xoff[m] = xok[m] ? col * CV + v0 + q : 0;
    }
    const int pc = tid / CS, q = tid - pc * CS;
    dok = tid < TW * CS && x0 + pc < W && v0 + q < CV;
    doff = dok ? (x0 + pc) * CV + v0 + q : 0;
  };
  // the copies of the next block slot
  auto issue_slot = [&]() {
    if (ij == per_tile) next_tile();
    const bool yok = iy >= 0 && iy < H;
#pragma unroll
    for (int m = 0; m < 2; ++m)
      if (tid + m * THREADS < XV) cp_async16(islot + tid + m * THREADS, yok && xok[m] ? xrow + xoff[m] : xb, yok && xok[m]);
    if (ij >= 2 && tid < TW * CS) cp_async16(islot + XV + tid, dok ? grow + doff : gb, dok);
    ++ij;
    ++iy;
    xrow += rowv;
    grow += rowv;
    if (++islot_i == SLOTS) {
      islot_i = 0;
      islot = ring;
    } else {
      islot += SV;
    }
  };
  // step s's ROWS slots, one commit group (empty past the last slot)
  auto issue_step = [&](int s) {
#pragma unroll 1
    for (int k = s * ROWS; k < min(nslots, s * ROWS + ROWS); ++k) issue_slot();
    cp_async_commit();
  };

  float4 acc[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) acc[t] = make_float4(0.f, 0.f, 0.f, 0.f);
  // x rows j - 2 and j - 1 of the window, slot columns c .. c + 2, widened once
  float4 w0[3] = {}, w1[3] = {};
  const Q* rq = reinterpret_cast<const Q*>(ring);
  const int SVQ = SV * TL::LPV;  // a slot, in Q
  int cj = 0, ct = 0;            // the slot being summed: its tile's slot j, its tile
  bool active = c < min(TW, W);  // this thread's column lies in the tile
  // One slot: the window's new x row is loaded and the window moves down
  // whether or not this thread's column lies in the tile (the loads stay in
  // the slot), so that with ROWS a multiple of 3 an unrolled step can
  // rename the window's registers rather than move them; only the sums are
  // guarded.
  auto sum_slot = [&](const Q* slot) {
    float4 w2[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) w2[i] = V::widen(slot[(c + i) * L + lq]);
    if (active && cj >= 2) {
      const float4 g = V::widen(slot[XV * TL::LPV + c * L + lq]);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        fma4(acc[i], w0[i], g);
        fma4(acc[3 + i], w1[i], g);
        fma4(acc[6 + i], w2[i], g);
      }
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      w0[i] = w1[i];
      w1[i] = w2[i];
    }
    if (++cj == per_tile) {
      cj = 0;
      ++ct;
      active = c < min(TW, W - ct * TW);
    }
  };

#pragma unroll 1
  for (int s = 0; s < AHEAD; ++s) issue_step(s);
  PHASE(0);
#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<AHEAD - 1>();  // this thread's copies of step s have landed
    __syncthreads();             // everyone's have, and step s - 1's slots are summed
    PHASE(1);
    issue_step(s + AHEAD);       // into the slots of step s - 1
    const Q* base = rq + s % (AHEAD + 1) * ROWS * SVQ;  // step s's ROWS slots, in a row in the ring
    if ((s + 1) * ROWS <= nslots) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) sum_slot(base + r * SVQ);
    } else {
#pragma unroll 1
      for (int r = 0; r < nslots - s * ROWS; ++r) sum_slot(base + r * SVQ);
    }
    PHASE(2);
  }

  // 1. the columns of a warp (lanes xor L, 2 L, ... hold the same channels),
  //    by a shuffle tree; then the warps' sums, through the ring (every
  //    copy has landed: the last groups are empty)
  for (int off = 16; off >= L; off >>= 1)
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      acc[t].x += __shfl_xor_sync(0xffffffffu, acc[t].x, off);
      acc[t].y += __shfl_xor_sync(0xffffffffu, acc[t].y, off);
      acc[t].z += __shfl_xor_sync(0xffffffffu, acc[t].z, off);
      acc[t].w += __shfl_xor_sync(0xffffffffu, acc[t].w, off);
    }
  __syncthreads();  // the ring's last slots are read
  float4* red = reinterpret_cast<float4*>(ring);  // [WARPS][9][L]
  const int items = 9 * L;
  if (lane < L) {
#pragma unroll
    for (int t = 0; t < 9; ++t) red[(warp * 9 + t) * L + lq] = acc[t];
  }
  __syncthreads();
  // 2. the warps of the block, in order
  for (int i = tid; i < items; i += THREADS) {
    float4 sum = red[i];
    for (int w = 1; w < WARPS; ++w) add4(sum, red[w * items + i]);
    part[i] = sum;
  }
  PHASE(3);
  // 3. the cluster's bands, in rank order: block `band` stores items band,
  //    band + bands, ... once every block's partial is in place
  cluster.sync();
  const int bands = gridDim.x;
  const int C = CV * V::VEC;
  for (int i = band + bands * tid; i < items; i += bands * THREADS) {
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < bands; ++r) add4(sum, cluster.map_shared_rank(part, r)[i]);
    const int t = i / L, ch = v0 * V::VEC + 4 * (i - t * L);
    if (ch < C) V::store4(dk + ((long long)b * 9 + t) * C + ch, sum);
  }
  cluster.sync();  // every block has read the others' partials
  PHASE(4);
  PHASE_END();
}

// Dynamic shared memory of one block for slices of cs vectors: the ring (or
// the warps' sums, when they take more) and the partial sums.
template <class V>
size_t smem_bytes(int cs) {
  using TL = Tile<V>;
  const size_t ring = (size_t)V::SLOTS * TL::slot(cs) * 16;
  const size_t red = (size_t)WARPS * 9 * TL::lanes(cs) * 16;
  return (ring > red ? ring : red) + (size_t)9 * TL::lanes(cs) * 16;
}

constexpr int MAX_DEVICES = 64;

// The shared-memory opt-in, once per device and instance, for the largest
// slice (the ring grows with cs through the halo columns).
template <class V>
cudaError_t opt_in() {
  static bool opted[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!opted[dev]) {
    err = cudaFuncSetAttribute(dk_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes<V>(SLICE_CHANNELS / V::VEC));
    if (err != cudaSuccess) return err;
    opted[dev] = true;
  }
  return cudaSuccess;
}

// The launch of `slices` x B clusters of `bands` blocks with slices of cs
// vectors; attr holds its cluster dimension.
template <class V>
cudaLaunchConfig_t plan_config(int B, int slices, int cs, int bands, cudaLaunchAttribute* attr, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)bands, (unsigned)slices, (unsigned)B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem_bytes<V>(cs);
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)bands;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <class V>
int launch(const void* x, const void* dout, void* dk, int B, int H, int W, int C, long long x_bstride,
           int cs, int bh, int bands, void* stream) {
  using T = typename V::T;
  if (B == 0 || C == 0) return 0;
  if (C % V::VEC || x_bstride % V::VEC || (long long)H * W * C > 0x7fffffffLL || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (H == 0 || W == 0) {
    cudaMemsetAsync(dk, 0, (size_t)B * 9 * C * sizeof(T), s);
    return (int)cudaGetLastError();
  }
  const int CV = C / V::VEC;
  const int slices = (CV + cs - 1) / cs;
  if (cs < 1 || (cs & (cs - 1)) || cs * V::VEC > SLICE_CHANNELS || bands < 1 || bands > MAX_BANDS ||
      bh < 1 || (long long)bh * bands < H || (long long)bh * (bands - 1) >= H || slices > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = opt_in<V>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = plan_config<V>(B, slices, cs, bands, &attr, s);
  err = cudaLaunchKernelEx(&cfg, dk_kernel<V>, static_cast<const uint4*>(x), static_cast<const uint4*>(dout),
                           static_cast<T*>(dk), H, W, CV, cs, bh, x_bstride / V::VEC);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <class V>
int clusters(int cs, int bands, int* n) {
  cudaError_t err = opt_in<V>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = plan_config<V>(1, 1, cs, bands, &attr, nullptr);
  return (int)cudaOccupancyMaxActiveClusters(n, dk_kernel<V>, &cfg);
}

}  // namespace

// x: (B, H, W, C) with (H, W, C) contiguous and batch stride x_bstride
// (elements, may be 0); dout: contiguous (B, H, W, C); dk: contiguous (B,
// 3, 3, C); x, dout and dk of one dtype, float32 (_f32) or bf16 (_bf16).
// C and x_bstride multiples of one 16-byte vector (4 float32, 8 bf16
// channels), x and dout 16-byte aligned. The launch plan (cs vectors a
// channel slice, a power of two of at most 128 channels; bh rows a band;
// `bands` bands a cluster, at most 8, covering H with none empty) comes
// from ops/conv.py::dw_corr3x3_dk_plan. One image, H * W * C, must fit an
// int; B at most 65535. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a shape or plan it does not take).
extern "C" int dw_corr3x3_dk_f32(const float* x, const float* dout, float* dk, int B, int H, int W, int C,
                                 long long x_bstride, int cs, int bh, int bands, void* stream) {
  return launch<F32>(x, dout, dk, B, H, W, C, x_bstride, cs, bh, bands, stream);
}

extern "C" int dw_corr3x3_dk_bf16(const void* x, const void* dout, void* dk, int B, int H, int W, int C,
                                  long long x_bstride, int cs, int bh, int bands, void* stream) {
  return launch<BF16>(x, dout, dk, B, H, W, C, x_bstride, cs, bh, bands, stream);
}

#ifdef DK_PHASES
// The phase counters since the last call (then reset), into out[9].
extern "C" int dw_corr3x3_dk_phases(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_dk_phases, sizeof(g_dk_phases));
  const unsigned long long reset[9] = {0, 0, 0, 0, 0, 0, ~0ull, 0, 0};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_dk_phases, reset, sizeof(reset));
  return (int)err;
}
#endif

// How many clusters of `bands` blocks with slices of cs vectors the device
// holds at once (cudaOccupancyMaxActiveClusters), into *n; bf16 != 0 for
// kernel 3b.
extern "C" int dw_corr3x3_dk_clusters(int bf16, int cs, int bands, int* n) {
  return bf16 ? clusters<BF16>(cs, bands, n) : clusters<F32>(cs, bands, n);
}
