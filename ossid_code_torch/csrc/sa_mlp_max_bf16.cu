// PointNet++ SetAbstraction stage with the inference BatchNorm folded in,
// gather included, in bfloat16 (kernel 2b; kernel 2, sa_mlp_max.cu, is the
// float32 instance):
//   row r of group (m, s):  x_r = [xyz[m, g[s,r]] - xyz[m, c[s]],  feats[m, g[s,r]]]
//   h1 = bf16(relu(x_r W1 + b1)), h2 = bf16(relu(h1 W2 + b2)), h3 = relu(h2 W3 + b3)
//   out[m, s, :] = bf16(max over r < K of h3)
// with bf16 points, features and weights, float32 biases, float32 sums.
//
// Replaces: ossid_code_tpu/ops/sa_fused.py::mlp_max (body _mlp_max_kernel)
// run in bf16, as pointnet2_fused_apply runs it under the bf16 scorer
// (OSSID_BF16_SCORER): the grouped input, the folded weights (fold_bn(...,
// bf16): folded in float32, then cast) and each layer's activations are
// bf16; every product is summed in float32, the float32 bias is added to
// the sum, relu is applied and only then is the result rounded to bf16
// (_mlp_max_ref, sa_fused.py:59-67). The xyz offsets x_g - x_c are bf16
// differences, rounded once, as JAX's bf16 subtraction gives them.
//
// What bounds it on an H100: arithmetic. At M = 128 hypotheses, SA1 (512
// centres, k 64, 11 -> 64 -> 64 -> 128) is ~109 GFLOP and SA2 (128 centres,
// 131 -> 128 -> 128 -> 256) ~138 GFLOP against a few MB of points, indices,
// weights and output: 0.11 / 0.14 ms on the tensor cores at the dense bf16
// rate of 989 TFLOP/s. A group's MMAs take an SM ~0.22 µs (SA1) / ~1.1 µs
// (SA2) at that rate, so what a group waits on besides them (the gather's
// dependent loads, each layer's wgmma round trip, the epilogues and the
// max) has to hide behind other groups' MMAs. The first instance (one
// group at a time, gathered by plain loads, 3 warpgroups on SA1) spent
// 4.3 µs (SA1) and 8 µs (SA2) of a warpgroup's time on a group.
//
// What the design does about it:
//  * wgmma.mma_async m64nNk16 .f32.bf16.bf16 (sm_90a), one pass (no hi/lo
//    split: the operands are bf16 already). One group per warpgroup: its
//    k <= 64 rows are one 64-row tile, so the max over the group is a
//    reduction of that warpgroup's accumulator rows (halving shuffle
//    exchanges, then the 4 warps through shared memory; rows r >= K
//    masked; no atomics);
//  * A (activations) comes from registers, B = W^T (Cout, Cin) from shared
//    memory, K-major. Layers chain in registers with no reordering: the f32
//    accumulator fragment of one layer (bias, relu, rounded to bf16 pairs)
//    is exactly the bf16 A fragment of the next (columns 2 tig, 2 tig + 1
//    of 8-column block 2t are k 2 tig, 2 tig + 1 of k-step t, block 2t + 1
//    its k + 8);
//  * all three layers' weights and biases stay resident in shared memory
//    for the block's lifetime (bf16 halves the weights: SA1 27 KB, SA2 135
//    KB), copied in once per block from the layout that
//    pack_sa_weights_bf16 writes;
//  * the gather runs a group ahead: each warpgroup has two tiles and two
//    index buffers. Once layer 1 has its A fragments from tile i, the
//    warpgroup issues group i + 1's feature rows into the other tile with
//    16-byte cp.async (feature rows 16-byte aligned, `vec8`), its xyz rows
//    (and features that are not 16-byte aligned) as plain loads into
//    registers, and group i + 2's indices with cp.async; all of it lands
//    while layers 1-3 of group i run, and the registers are stored into the
//    tile (xyz as the bf16 offset from the centre) after layer 3. A group
//    then waits on no load at all: one barrier at its start;
//  * a group's per-thread work has no division (group, hypothesis and
//    centre indices and the 16-byte chunks of a row advance by sums) and no
//    local memory (the max's exchanges select with selp); the max keeps two
//    reduction buffers, so each layer-3 part costs one warpgroup barrier;
//  * persistent blocks, one per SM, each warpgroup looping over its own
//    groups and meeting the others only at the start: SA1 runs 4
//    warpgroups a block (its weights leave room), SA2 2 (135 KB of weights
//    and 4 tiles fill 219 KB).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int ROWS = 64;   // rows of one group's tile (k <= ROWS)
constexpr int NMAX = 128;  // widest wgmma N used (SA2's layer 3 runs in two parts)
constexpr int IDXN = ROWS + 4;  // ints of one index buffer: k member indices, the centre's at [ROWS]
constexpr int XPF = (3 * ROWS + 127) / 128;  // xyz values a thread prefetches for a group
constexpr int FPF = 4;     // unaligned feature values a thread prefetches (more are loaded late)

// Width set, layer-1 depth (3 + cf padded to a multiple of 16), groups
// (warpgroups) per block.
template <int C1_, int C2_, int C3_, int K1_, int GROUPS_>
struct Cfg {
  static constexpr int C1 = C1_, C2 = C2_, C3 = C3_, K1 = K1_;
  static constexpr int GROUPS = GROUPS_, THREADS = 128 * GROUPS;
  static constexpr int NP3 = C3 < NMAX ? C3 : NMAX;  // layer-3 columns per part
  static constexpr int W1 = C1 * K1, W2 = C2 * C1, W3 = C3 * C2;  // bf16 elements
  static constexpr int WELEMS = W1 + W2 + W3;
  // Row stride of the gathered tile in bf16: K1 / 2 + 4 = 4 mod 8 words, so
  // the A fragment loads (8 rows x 4 words per warp) hit 32 distinct banks.
  static constexpr int LDA = K1 + 8;
  static constexpr int TILE = ROWS * LDA;
  // weights | tiles [GROUPS][2] | index buffers [GROUPS][2] | max buffers [GROUPS][2][4 warps][NMAX] | biases
  static constexpr size_t OFF_BUF = 2 * (size_t)WELEMS;
  static constexpr size_t OFF_IDX = OFF_BUF + 2 * (size_t)GROUPS * 2 * TILE;
  static constexpr size_t OFF_RED = OFF_IDX + sizeof(int) * GROUPS * 2 * IDXN;
  static constexpr size_t OFF_BIAS = OFF_RED + sizeof(float) * GROUPS * 2 * 4 * NMAX;
  static constexpr size_t SMEM = OFF_BIAS + sizeof(float) * (C1 + C2 + C3);
  static_assert(K1 % 16 == 0 && C1 % 16 == 0 && C2 % 16 == 0, "k16 steps");
  static_assert(C1 <= NMAX && C2 <= NMAX && C3 % NP3 == 0 && (LDA / 2) % 8 == 4, "widths");
  static_assert(WELEMS % 8 == 0 && TILE % 8 == 0 && IDXN % 4 == 0, "16-byte regions");
  static_assert(SMEM <= 232448, "shared memory of one block");
};

// ---- PTX wrappers -----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// Shared-memory matrix descriptor, no swizzle (layout type 0), K-major:
// core matrices of 8 rows x 16 bytes (8 bf16 along K) stored as 128
// contiguous bytes; LBO = byte distance of core matrices adjacent in K
// (128), SBO = byte distance of core matrices adjacent in N (kc / 8 * 128
// for a layer kc deep). A k16 step spans 2 core matrices in K, so it
// advances the start address by 256 bytes. The same convention as the
// float32 instance's descriptor (sa_mlp_max.cu); pack_sa_weights_bf16
// (ops/sa_fused.py) writes this layout and tests/test_torch_bf16.py reads
// it back the same way.
__device__ __forceinline__ uint64_t make_desc(const bf16* p, uint32_t sbo_bytes) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)((sbo_bytes >> 4) & 0x3FFF) << 32);
}

// D (64 x N, f32) += A (64 x 16, bf16 in registers) * B (16 x N, bf16 in
// shared memory, K-major: trans-b 0). Accumulator fragment of a thread (warp
// w, lane = 4 * gid + tig): d[4j + e] is row 16w + gid + 8 (e >> 1), column
// 8j + 2 tig + (e & 1). A fragment (pairs of bf16, the lower k in the low
// half): a0 (row 16w + gid, k 2 tig, 2 tig + 1), a1 (row + 8, same k),
// a2 (row, k 2 tig + 8, + 9), a3 (row + 8, k 2 tig + 8, + 9).
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc) {
  if constexpr (N == 64) wgmma_n64(d, a, desc);
  else wgmma_n128(d, a, desc);
}

// acc (64 x N) = A (64 x 16 * STEPS, fragments in registers) * W^T of one
// layer (N rows, kc = 16 * STEPS deep, resident in shared memory).
template <int N, int STEPS>
__device__ __forceinline__ void layer_mma(float (&acc)[N / 2], const uint32_t (&a)[STEPS][4], const bf16* w) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  // wgmma.fence orders the register writes above (zeroed accumulator, A
  // fragments) before the asynchronous MMAs; commit + wait_group 0 complete
  // them before the accumulator is read; fence_regs keeps the compiler from
  // moving accumulator accesses across either point.
  fence_regs(acc);
  wgmma_fence();
  const uint32_t sbo = 16 * STEPS * 16;  // (kc / 8) core matrices of 128 B
#pragma unroll
  for (int t = 0; t < STEPS; ++t) wgmma<N>(acc, a[t], make_desc(w + 128 * t, sbo));
  wgmma_commit();
  wgmma_wait0();
  fence_regs(acc);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<const uint32_t*>(&h);
}

// bf16(relu(acc + b)) as the A fragments of the next layer (see wgmma_n64).
template <int N>
__device__ __forceinline__ void epilogue(const float (&acc)[N / 2], const float* b, int tig,
                                         uint32_t (&h)[N / 16][4]) {
#pragma unroll
  for (int t = 0; t < N / 16; ++t)
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int j = 2 * t + jj;
      const float2 bv = *reinterpret_cast<const float2*>(b + 8 * j + 2 * tig);
      h[t][2 * jj] = pack_bf16(fmaxf(acc[4 * j] + bv.x, 0.f), fmaxf(acc[4 * j + 1] + bv.y, 0.f));
      h[t][2 * jj + 1] = pack_bf16(fmaxf(acc[4 * j + 2] + bv.x, 0.f), fmaxf(acc[4 * j + 3] + bv.y, 0.f));
    }
}

// Barrier of one warpgroup's 128 threads (ids 1..GROUPS; 0 is __syncthreads).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

__device__ __forceinline__ float bf16_bits_to_float(uint16_t v) { return __uint_as_float((uint32_t)v << 16); }

// c ? a : b as one selp. A plain ?: between two elements of a register
// array may be compiled as a select of their addresses, which moves the
// array to local memory (a 128-byte stack frame in max_columns<128>).
__device__ __forceinline__ float select(bool c, float a, float b) {
  float r;
  asm("{\n.reg .pred p;\nsetp.ne.u32 p, %3, 0;\nselp.f32 %0, %1, %2, p;\n}\n"
      : "=f"(r) : "f"(a), "f"(b), "r"((uint32_t)c));
  return r;
}

// Max over the 64 rows of a warpgroup's accumulator (N columns), masked to
// rows < K, into this warp's N entries of red: first the thread's two rows,
// then the warp's 8 row groups (lanes xor 16, 8, 4) by halving exchanges, so
// each lane ends with N / 32 of the N / 4 column maxima it started with (the
// columns 8 (o >> 1) + 2 tig + (o & 1) for o = N / 8 b16 + N / 16 b8 +
// N / 32 b4 + i, b16 b8 b4 the bits of gid).
// One halving exchange of max_columns: lanes whose `mask` bit is set keep
// the upper HALF of m, the others the lower, each taking the max with its
// partner's copy of the half it keeps.
template <int HALF, int MASK, int NV>
__device__ __forceinline__ void max_exchange(float (&m)[NV]) {
  const bool upper = (threadIdx.x & MASK) != 0;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = select(upper, m[i], m[i + HALF]);
    const float keep = select(upper, m[i + HALF], m[i]);
    m[i] = fmaxf(keep, __shfl_xor_sync(0xffffffffu, send, MASK));
  }
}

template <int N>
__device__ __forceinline__ void max_columns(const float (&acc)[N / 2], bool v0, bool v1, int gid, int tig,
                                            float* red) {
  constexpr int NV = N / 4;
  const float NEG_INF = __int_as_float(0xff800000);
  float m[NV];
  if (v1) {  // both rows real (every thread at K = 64, the main path)
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) m[2 * j + e] = fmaxf(acc[4 * j + e], acc[4 * j + 2 + e]);
  } else {
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) m[2 * j + e] = select(v0, acc[4 * j + e], NEG_INF);
  }
  max_exchange<NV / 2, 16>(m);
  max_exchange<NV / 4, 8>(m);
  max_exchange<NV / 8, 4>(m);
  const int base = NV / 2 * ((gid >> 2) & 1) + NV / 4 * ((gid >> 1) & 1) + NV / 8 * (gid & 1);
#pragma unroll
  for (int i = 0; i < NV / 8; ++i) {
    const int o = base + i;
    red[8 * (o >> 1) + 2 * tig + (o & 1)] = m[i];
  }
}

// Cycle counts of a group's phases, summed over warpgroups (thread 0 of
// each), when built with -DSA_PHASES (tools/kernel_phases.py reads them):
// 0 wait for the tile, 1 fragments and the next gather's issue, 2 layer 1,
// 3 layer 2, 4 layer 3's MMAs, 5 the max, 6 the prefetched rows' stores
// (and the loop's own cost).
#ifdef SA_PHASES
__device__ unsigned long long g_phases[8];
#define PHASE_START() long long t_last = clock64(); unsigned long long t_ph[8] = {}
#define PHASE(i) do { const long long t_now = clock64(); t_ph[i] += t_now - t_last; t_last = t_now; } while (0)
#define PHASE_END() do { if (t128 == 0) for (int i = 0; i < 8; ++i) atomicAdd(&g_phases[i], t_ph[i]); } while (0)
#else
#define PHASE_START() do {} while (0)
#define PHASE(i) do {} while (0)
#define PHASE_END() do {} while (0)
#endif

template <class P>
__global__ void __launch_bounds__(P::THREADS, 1)
sa_mlp_max_bf16_kernel(const bf16* __restrict__ xyz, long long xyz_ms, long long xyz_rs,
                       const bf16* __restrict__ feats, long long f_ms, long long f_rs, int cf, int vec8,
                       const int* __restrict__ cidx, const int* __restrict__ gidx,
                       int G, int S, int K, const uint4* __restrict__ packed,
                       const float* b1, const float* b2, const float* b3, bf16* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, wg = tid >> 7, t128 = tid & 127;
  const int warp = t128 >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const bf16* w1 = reinterpret_cast<const bf16*>(smem);
  const bf16* w2 = w1 + P::W1;
  const bf16* w3 = w2 + P::W2;
  bf16* tiles = reinterpret_cast<bf16*>(smem + P::OFF_BUF) + wg * 2 * P::TILE;
  int* idxs = reinterpret_cast<int*>(smem + P::OFF_IDX) + wg * 2 * IDXN;
  float* reds = reinterpret_cast<float*>(smem + P::OFF_RED) + wg * 2 * 4 * NMAX;

  for (int i = tid; i < P::WELEMS / 8; i += P::THREADS) reinterpret_cast<uint4*>(smem)[i] = __ldg(packed + i);
  // Cin = 3 + cf is padded to K1 and rows r >= K are padding. Both stay zero
  // for the kernel's lifetime in both tiles: the gather writes only columns
  // < cf + 3 of rows < K, and K is fixed per launch. The packed weights' pad
  // rows are zero as well.
  for (int i = tid; i < P::GROUPS * 2 * P::TILE / 8; i += P::THREADS)
    reinterpret_cast<uint4*>(smem + P::OFF_BUF)[i] = make_uint4(0, 0, 0, 0);
  // the biases, read by every epilogue: shared memory, not the L1 path
  // (SA2 0.34 -> 0.30 ms at M = 128 on an H100)
  float* bs = reinterpret_cast<float*>(smem + P::OFF_BIAS);
  for (int i = tid; i < P::C1 + P::C2 + P::C3; i += P::THREADS)
    bs[i] = i < P::C1 ? b1[i] : i < P::C1 + P::C2 ? b2[i - P::C1] : b3[i - P::C1 - P::C2];
  __syncthreads();
  b1 = bs;
  b2 = bs + P::C1;
  b3 = bs + P::C1 + P::C2;

  // The tile elements this thread gathers through registers, the same for
  // every group: xyz value c = t128 + 128 j is (row c / 3, coordinate c % 3);
  // an unaligned feature value c is (row c / cf, feature c % cf).
  int xr[XPF], xd[XPF], fr[FPF], ff[FPF];
  bool xv[XPF], fv[FPF];
#pragma unroll
  for (int j = 0; j < XPF; ++j) {
    const int c = t128 + 128 * j;
    xv[j] = c < 3 * K;
    xr[j] = c / 3;
    xd[j] = c - 3 * xr[j];
  }
#pragma unroll
  for (int j = 0; j < FPF; ++j) {
    const int c = t128 + 128 * j;
    fv[j] = !vec8 && c < K * cf;
    fr[j] = cf ? c / cf : 0;
    ff[j] = c - fr[j] * cf;
  }
  uint16_t px[XPF], pc[XPF], pf[FPF];  // raw bf16 in flight: member xyz, centre xyz, features
  // 16-byte feature chunks: this thread copies chunk c = t128 + 128 j, (row
  // c / nch, chunk c % nch), stepped without a division per copy
  const int nch = vec8 ? cf >> 3 : 0, nch1 = nch > 0 ? nch : 1;
  const int r8 = t128 / nch1, q8 = t128 - r8 * nch1, dr8 = 128 / nch1, dq8 = 128 - dr8 * nch1;

  // Group g = m * S + s of this warpgroup, advanced by gstep groups with no
  // division in the loop.
  struct At { int g, m, s; };
  const int gstep = gridDim.x * P::GROUPS, dm = gstep / S, ds = gstep - dm * S;
  auto advance = [&](At a) {
    a.g += gstep;
    a.m += dm;
    a.s += ds;
    if (a.s >= S) { a.s -= S; ++a.m; }
    return a;
  };

  // group a's member and centre indices into ib, by cp.async
  auto issue_idx = [&](At a, int* ib) {
    if (a.g >= G) return;
    if (t128 < K) cp_async4(ib + t128, gidx + a.s * K + t128);
    if (t128 == 127) cp_async4(ib + ROWS, cidx + a.s);
  };
  // group a's rows (indices in ib): 16-byte feature rows straight into tile
  // tb by cp.async, xyz and unaligned features into registers
  // x_r = [feats, xyz - centre, 0 ...]: pack_sa_weights_bf16 orders W1's rows the same way
  auto issue_rows = [&](At a, const int* ib, bf16* tb) {
    if (a.g >= G) return;
    const bf16* xm = xyz + a.m * xyz_ms;
    const bf16* fm = feats + a.m * f_ms;
    if (nch > 0) {
      for (int r = r8, q = q8; r < K;) {
        cp_async16(tb + r * P::LDA + 8 * q, fm + (long long)ib[r] * f_rs + 8 * q);
        r += dr8;
        q += dq8;
        if (q >= nch) { q -= nch; ++r; }
      }
    }
    const long long cen = ib[ROWS];
#pragma unroll
    for (int j = 0; j < XPF; ++j) {
      if (xv[j]) {
        px[j] = __ldg(reinterpret_cast<const unsigned short*>(xm + (long long)ib[xr[j]] * xyz_rs + xd[j]));
        pc[j] = __ldg(reinterpret_cast<const unsigned short*>(xm + cen * xyz_rs + xd[j]));
      }
    }
#pragma unroll
    for (int j = 0; j < FPF; ++j)
      if (fv[j]) pf[j] = __ldg(reinterpret_cast<const unsigned short*>(fm + (long long)ib[fr[j]] * f_rs + ff[j]));
  };
  // the registers of issue_rows into tile tb, and the unaligned features
  // beyond FPF a thread (loaded here, late: off the main path's shapes)
  auto store_rows = [&](At a, const int* ib, bf16* tb) {
    if (a.g >= G) return;
    unsigned short* t16 = reinterpret_cast<unsigned short*>(tb);
#pragma unroll
    for (int j = 0; j < XPF; ++j)
      if (xv[j])
        tb[xr[j] * P::LDA + cf + xd[j]] = __float2bfloat16_rn(bf16_bits_to_float(px[j]) - bf16_bits_to_float(pc[j]));
#pragma unroll
    for (int j = 0; j < FPF; ++j)
      if (fv[j]) t16[fr[j] * P::LDA + ff[j]] = pf[j];
    if (!vec8) {
      const bf16* fm = feats + a.m * f_ms;
      for (int c = t128 + 128 * FPF; c < K * cf; c += 128) {
        const int r = c / cf, f = c - r * cf;
        tb[r * P::LDA + f] = fm[(long long)ib[r] * f_rs + f];
      }
    }
  };

  // this group, the next (its rows in flight) and the one after (its indices in flight)
  const int g0 = blockIdx.x * P::GROUPS + wg, m0 = g0 / S;
  At at = {g0, m0, g0 - m0 * S};
  At at1 = advance(at);
  issue_idx(at, idxs);
  cp_async_commit();
  cp_async_wait_all();
  wg_sync(wg);
  issue_rows(at, idxs, tiles);
  issue_idx(at1, idxs + IDXN);
  cp_async_commit();
  store_rows(at, idxs, tiles);

  const int row = warp * 16 + gid;  // this thread's two rows of the tile: row, row + 8
  const bool v0 = row < K, v1 = row + 8 < K;
  int cur = 0, q = 0;  // q: layer-3 parts reduced so far (red's double buffer)
  PHASE_START();
  for (; at.g < G; cur ^= 1) {
    const At at2 = advance(at1);
    const bf16* tb = tiles + cur * P::TILE;
    bf16* tn = tiles + (cur ^ 1) * P::TILE;
    const int* in = idxs + (cur ^ 1) * IDXN;
    // this group's tile complete (every thread's copies and stores), the
    // next group's indices landed; the other tile was read last iteration
    cp_async_wait_all();
    wg_sync(wg);
    PHASE(0);
    uint32_t a1[P::K1 / 16][4];
    {
      const bf16* r0 = tb + row * P::LDA;
      const bf16* r1 = tb + (row + 8) * P::LDA;
#pragma unroll
      for (int t = 0; t < P::K1 / 16; ++t) {
        const int k = 16 * t + 2 * tig;
        a1[t][0] = *reinterpret_cast<const uint32_t*>(r0 + k);
        a1[t][1] = *reinterpret_cast<const uint32_t*>(r1 + k);
        a1[t][2] = *reinterpret_cast<const uint32_t*>(r0 + k + 8);
        a1[t][3] = *reinterpret_cast<const uint32_t*>(r1 + k + 8);
      }
    }
    // the next group's gather and the one after's indices, in flight
    // while this group's layers run
    issue_rows(at1, in, tn);
    issue_idx(at2, idxs + cur * IDXN);
    cp_async_commit();
    PHASE(1);

    uint32_t h1[P::C1 / 16][4];
    {
      float acc[P::C1 / 2];
      layer_mma<P::C1>(acc, a1, w1);
      epilogue<P::C1>(acc, b1, tig, h1);
    }
    PHASE(2);
    uint32_t h2[P::C2 / 16][4];
    {
      float acc[P::C2 / 2];
      layer_mma<P::C2>(acc, h1, w2);
      epilogue<P::C2>(acc, b2, tig, h2);
    }
    PHASE(3);
    // The max over the group's rows of relu(acc + b3) is relu(max(acc) + b3)
    // (adding b3 and relu are monotone, and float rounding keeps them so),
    // so the bias and relu come after the max, once a column. Rows r >= K
    // are padding (-inf); K >= 1 leaves every column a real row. Part q
    // reduces through red buffer q & 1: its next writer, part q + 2, comes
    // after part q + 1's barrier, which every reader of part q has passed.
    auto reduce_part = [&](const float (&acc)[P::NP3 / 2], int p) {
      float* red = reds + (q & 1) * 4 * NMAX;
      max_columns<P::NP3>(acc, v0, v1, gid, tig, red + warp * NMAX);
      wg_sync(wg);
      if (t128 < P::NP3) {
        const float v = fmaxf(fmaxf(red[t128], red[NMAX + t128]), fmaxf(red[2 * NMAX + t128], red[3 * NMAX + t128]));
        out[(long long)at.g * P::C3 + p * P::NP3 + t128] = __float2bfloat16_rn(fmaxf(v + b3[p * P::NP3 + t128], 0.f));
      }
      ++q;
    };
#pragma unroll
    for (int p = 0; p < P::C3 / P::NP3; ++p) {
      float acc[P::NP3 / 2];
      layer_mma<P::NP3>(acc, h2, w3 + p * P::NP3 * P::C2);
      PHASE(4);
      reduce_part(acc, p);
      PHASE(5);
    }
    store_rows(at1, in, tn);
    PHASE(6);
    at = at1;
    at1 = at2;
  }
  PHASE_END();
}

constexpr int MAX_DEVICES = 64;

template <class P>
int launch(const bf16* xyz, long long xyz_ms, long long xyz_rs, const bf16* feats, long long f_ms,
           long long f_rs, int cf, int vec8, const int* cidx, const int* gidx, int M, int S, int K,
           const void* packed, const float* b1, const float* b2, const float* b3, bf16* out,
           cudaStream_t stream) {
  // The shared-memory opt-in and the SM count are per device; both are
  // looked up once per device and instance.
  static int sms[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    err = cudaFuncSetAttribute(sa_mlp_max_bf16_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)P::SMEM);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  const int G = M * S;  // the caller checked that G + 3 grids of groups fit an int
  const int ntiles = (G + P::GROUPS - 1) / P::GROUPS;
  const int grid = ntiles < sms[dev] ? ntiles : sms[dev];
  sa_mlp_max_bf16_kernel<P><<<grid, P::THREADS, P::SMEM, stream>>>(
      xyz, xyz_ms, xyz_rs, feats, f_ms, f_rs, cf, vec8, cidx, gidx, G, S, K,
      static_cast<const uint4*>(packed), b1, b2, b3, out);
  return (int)cudaGetLastError();
}

// SA1: 4 warpgroups a block (27 KB of weights, 68 KB in all); SA2: 2
// warpgroups (135 KB of weights and 4 gather tiles, 217 KB of shared memory).
using SA1 = Cfg<64, 64, 128, 16, 4>;
using SA2 = Cfg<128, 128, 256, 144, 2>;

}  // namespace

#ifdef SA_PHASES
// The phase counters since the last call (then zeroed), into out[8].
extern "C" int sa_mlp_max_bf16_phases(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_phases, sizeof(g_phases));
  const unsigned long long zero[8] = {};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_phases, zero, sizeof(zero));
  return (int)err;
}
#endif

// The packed-weight layout of the instance for widths (c1, c2, c3): layer-1
// depth K1 (3 + cf padded to a multiple of 16; cf <= K1 - 3), which must
// equal SA_LAYOUT_BF16 in ops/sa_fused.py, the depth that
// pack_sa_weights_bf16 pads to (the wrapper checks before it launches).
// Returns cudaErrorInvalidValue for widths without an instance.
extern "C" int sa_mlp_max_bf16_layout(int c1, int c2, int c3, int* k1) {
  if (c1 == SA1::C1 && c2 == SA1::C2 && c3 == SA1::C3) { *k1 = SA1::K1; return 0; }
  if (c1 == SA2::C1 && c2 == SA2::C2 && c3 == SA2::C3) { *k1 = SA2::K1; return 0; }
  return (int)cudaErrorInvalidValue;
}

// xyz: (M, N, 3) bf16, element (m, n, d) at m * xyz_ms + n * xyz_rs + d;
// feats: (M, N, cf) bf16, element (m, n, f) at m * f_ms + n * f_rs + f;
// vec8 != 0 promises 16-byte aligned feats rows (pointer, f_ms, f_rs, cf all
// multiples of 8 elements); center_idx (S,) and group_idx (S, K) int32 into
// N; packed: the folded bf16 weights as pack_sa_weights_bf16 lays them out
// for sa_mlp_max_bf16_layout's K1, 16-byte aligned; b_i (C_i,) float32,
// contiguous, 8-byte aligned; out contiguous (M, S, C3) bf16. Widths
// (64, 64, 128) with cf <= 13 or (128, 128, 256) with cf <= 141; 1 <= K <= 64;
// M * S <= 2^30.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for an
// unsupported shape).
extern "C" int sa_mlp_max_bf16(const void* xyz, long long xyz_ms, long long xyz_rs,
                               const void* feats, long long f_ms, long long f_rs, int cf, int vec8,
                               const int* cidx, const int* gidx, int M, int S, int K,
                               int c1, int c2, int c3, const void* packed,
                               const float* b1, const float* b2, const float* b3,
                               void* out, void* stream) {
  if (K < 1 || K > ROWS || cf < 0) return (int)cudaErrorInvalidValue;
  if ((long long)M * S == 0) return 0;
  if ((long long)M * S > (1LL << 30)) return (int)cudaErrorInvalidValue;  // group indices in an int
  cudaStream_t st = (cudaStream_t)stream;
  const bf16* x = static_cast<const bf16*>(xyz);
  const bf16* f = static_cast<const bf16*>(feats);
  bf16* o = static_cast<bf16*>(out);
  if (c1 == SA1::C1 && c2 == SA1::C2 && c3 == SA1::C3 && cf + 3 <= SA1::K1)
    return launch<SA1>(x, xyz_ms, xyz_rs, f, f_ms, f_rs, cf, vec8, cidx, gidx, M, S, K, packed,
                       b1, b2, b3, o, st);
  if (c1 == SA2::C1 && c2 == SA2::C2 && c3 == SA2::C3 && cf + 3 <= SA2::K1)
    return launch<SA2>(x, xyz_ms, xyz_rs, f, f_ms, f_rs, cf, vec8, cidx, gidx, M, S, K, packed,
                       b1, b2, b3, o, st);
  return (int)cudaErrorInvalidValue;
}
