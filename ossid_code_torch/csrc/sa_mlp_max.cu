// PointNet++ SetAbstraction stage with the inference BatchNorm folded in,
// gather included, float32 in and out:
//   row r of group (m, s):  x_r = [xyz[m, g[s,r]] - xyz[m, c[s]],  feats[m, g[s,r]]]
//   h1 = relu(x_r W1 + b1), h2 = relu(h1 W2 + b2), h3 = relu(h2 W3 + b3)
//   out[m, s, :] = max over r < K of h3
//
// Replaces: ossid_code_tpu/ops/sa_fused.py::mlp_max (body _mlp_max_kernel,
// BatchNorm folding in fold_bn / _fold_stage), called per stage by
// pointnet2_fused_apply. On the scorer's path (M = 128 hypotheses, 512 model
// points) it runs twice per score call: SA1 (M, 512 centres, k 64, 11 -> 64 ->
// 64 -> 128) and SA2 (M, 128, 64, 131 -> 128 -> 128 -> 256).
//
// What bounds it on an H100 SXM (700 W): arithmetic. SA1 is ~109 GFLOP and
// SA2 ~138 GFLOP at M = 128 against a few MB of points, indices, weights and
// output. On the tensor cores in TF32 (495 TFLOP/s) that is 0.22 / 0.28 ms;
// the three passes below make the floor 0.66 / 0.84 ms; the FP32 pipes
// (67 TFLOP/s) could not go below 1.63 / 2.06 ms.
//
// What the design does about it:
//  * 3xTF32 on the tensor cores, float32 accumulation: every operand a is
//    split into hi = rna_tf32(a) and lo = rna_tf32(a - hi), and each product
//    is a_hi b_hi + a_hi b_lo + a_lo b_hi (error ~2^-21 relative, so the
//    float32 contract holds; one pass of TF32 would not);
//  * wgmma.mma_async m64nNk8 .tf32 (sm_90a). One group per warpgroup: its
//    k <= 64 rows are one 64-row tile, so the max over the group is a
//    reduction of that warpgroup's accumulator rows (shuffles, then the 4
//    warps through shared memory; no atomics). A block holds 3 (SA1) or 2
//    (SA2) warpgroups, so every weight slice in shared memory serves 192 or
//    128 rows;
//  * A (activations) comes from registers, B = W^T (Cout, Cin) from shared
//    memory, K-major as tf32 wgmma requires. Layers chain in registers: the
//    accumulator fragment of layer l (bias added, relu applied) is the A
//    fragment of layer l + 1 once the K order of W_{l+1} is permuted within
//    each group of 8 (PERM below; the wrapper packs the weights that way);
//  * weights pre-split into hi and lo, pre-transposed, padded and laid out in
//    the core-matrix order of the wgmma descriptor by the wrapper, as one
//    packed buffer of K-slices. SA1's 104 KB (hi + lo) stay resident in
//    shared memory for the block's lifetime; SA2's 520 KB stream in 32-deep
//    slices through a ring of 4 slots filled by bulk copies (cp.async.bulk)
//    that complete on mbarriers, two slices ahead of the MMAs;
//  * persistent blocks, one per SM, each looping over tiles of one group per
//    warpgroup. Each warpgroup gathers its group's rows with cp.async
//    straight from xyz and feats (the grouped (M, S, k, Cin) tensor, 549 MB
//    at SA2, never exists) and issues the next tile's gather once layer 1
//    has read the current one, so it lands while layers 2 and 3 run;
//  * the warpgroups of a block never wait for each other (named barriers per
//    warpgroup, per-slot empty barriers in the ring), so one warpgroup's
//    epilogue and operand splitting overlap another's MMAs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 64;         // rows of one group's tile (k <= ROWS)
constexpr int NMAX = 128;        // widest wgmma N used (layer 3 runs in parts)
constexpr int LAG = 2;           // a ring slot is refilled 2 slices after it was read

// Width set, padded layer-1 depth, K-slice depth, ring slots (0: resident),
// groups (warpgroups) per block.
template <int C1_, int C2_, int C3_, int K1_, int KS_, int NST_, int GROUPS_>
struct Cfg {
  static constexpr int C1 = C1_, C2 = C2_, C3 = C3_, K1 = K1_, KS = KS_;
  static constexpr int GROUPS = GROUPS_, THREADS = 128 * GROUPS;
  static constexpr int NP3 = C3 < NMAX ? C3 : NMAX;  // layer-3 columns per part
  static constexpr int NS1 = (K1 + KS - 1) / KS;
  static constexpr int NSL = NS1 + C1 / KS + (C3 / NP3) * (C2 / KS);  // slices per tile
  static constexpr bool RESIDENT = NST_ == 0;
  static constexpr int NST = RESIDENT ? NSL : NST_;
  static constexpr int WFLOATS = 2 * (C1 * K1 + C2 * C1 + C3 * C2);
  static constexpr int SLOT = 2 * NMAX * KS;             // floats of the largest slice
  static constexpr int WBUF = RESIDENT ? WFLOATS : NST * SLOT;
  // Row stride of the gathered input: K1 + 4 = 4 mod 8 words, so the A
  // fragment loads (8 rows x 4 columns per warp) hit 32 distinct banks.
  static constexpr int LDA = K1 + 4;
  static constexpr size_t OFF_BUF = sizeof(float) * WBUF;
  static constexpr size_t OFF_IDX = OFF_BUF + sizeof(float) * GROUPS * ROWS * LDA;
  static constexpr size_t OFF_CEN = OFF_IDX + sizeof(int) * GROUPS * ROWS;   // cidx + centre xyz
  static constexpr size_t OFF_RED = OFF_CEN + sizeof(float) * GROUPS * 8;
  static constexpr size_t OFF_BAR = OFF_RED + sizeof(float) * GROUPS * 4 * NMAX;
  static constexpr size_t OFF_TAB = OFF_BAR + 8 * 2 * NST;  // full and empty barriers
  static constexpr size_t SMEM = OFF_TAB + sizeof(int) * 2 * NSL;  // slices' offsets, sizes
  static_assert(K1 % 8 == 0 && KS % 8 == 0 && C1 % KS == 0 && C2 % KS == 0, "slicing");
  static_assert(C1 <= NMAX && C2 <= NMAX && C3 % NP3 == 0 && (LDA % 8) == 4, "widths");
  static_assert(RESIDENT || (LAG < NST && NST <= NSL), "ring");
};

// ---- PTX wrappers -----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// 3xTF32 operand split of 4 A-fragment values.
__device__ __forceinline__ void split4(const float (&x)[4], uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = tf32_rna(x[i]);
    lo[i] = tf32_rna(x[i] - __uint_as_float(hi[i]));
  }
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}
// One bulk copy global -> shared that completes `bytes` on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// Trouble spot 3: the descriptor. Shared-memory matrix descriptor, no
// swizzle (layout type 0), K-major as tf32 requires: core matrices of 8 rows
// x 16 bytes (4 tf32) stored as 128 contiguous bytes; LBO = byte distance of
// core matrices adjacent in K (128 here), SBO = byte distance of core
// matrices adjacent in N (kc / 4 * 128 for a slice kc deep); a k8 step
// advances the start address by 2 core matrices (LBO and SBO read the other
// way round give wrong products). The wrapper's pack_sa_weights writes this
// layout and tests/test_torch_sa_tf32.py reads it back the same way.
__device__ __forceinline__ uint64_t make_desc(const float* p, uint32_t sbo_bytes) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)((sbo_bytes >> 4) & 0x3FFF) << 32);
}

// D (64 x N) += A (64 x 8, tf32 in registers) * B (8 x N, tf32 in shared
// memory). Accumulator fragment of a thread (warp w, lane = 4 * gid + tig):
// d[4j + e] is row 16w + gid + 8 (e >> 1), column 8j + 2 tig + (e & 1). A
// fragment: a0 (row 16w + gid, k tig), a1 (row + 8, k tig), a2 (row, k
// tig + 4), a3 (row + 8, k tig + 4).
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
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
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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

// ---- A-fragment sources -----------------------------------------------------

// Layer 1: the gathered rows in shared memory, natural K order.
struct SmemA {
  const float* r0;  // row 16 w + gid of the group's tile
  const float* r1;  // row + 8
  int tig;
  __device__ __forceinline__ void load(int j, float (&x)[4]) const {
    const int k = 8 * j + tig;
    x[0] = r0[k]; x[1] = r1[k]; x[2] = r0[k + 4]; x[3] = r1[k + 4];
  }
};

// Layers 2 and 3: the previous layer's accumulator fragment. Logical k = tig
// of step j is column 8j + 2 tig, k = tig + 4 is 8j + 2 tig + 1: the wrapper
// packs W_{l+1}'s rows in that order (PERM = 0 2 4 6 1 3 5 7 within each 8).
template <int N>
struct RegA {
  const float (&h)[N];
  __device__ __forceinline__ void load(int j, float (&x)[4]) const {
    x[0] = h[4 * j]; x[1] = h[4 * j + 2]; x[2] = h[4 * j + 1]; x[3] = h[4 * j + 3];
  }
};

// ---- the weight ring ----------------------------------------------------------

template <class P>
struct Ring {
  float* base;              // shared memory
  uint64_t* full;           // per slot: its slice has landed (bulk copy bytes)
  uint64_t* empty;          // per slot: every warp has read it (4 * GROUPS arrivals)
  const float* packed;      // global, the slices of one tile in order
  const int* tab;           // shared memory: offset, size (floats) of each slice
  int u;                    // slices consumed so far by this thread's warpgroup
  int total;                // slices each warpgroup consumes

  // Packed offset and size (floats) of slice s of a tile; the wrapper's
  // pack_sa_weights lays them out in this order.
  static __device__ __forceinline__ void info(int s, int& off, int& n) {
    int o = 0;
    for (int k0 = 0; k0 < P::K1; k0 += P::KS) {
      const int f = 2 * P::C1 * (P::K1 - k0 < P::KS ? P::K1 - k0 : P::KS);
      if (s-- == 0) { off = o; n = f; return; }
      o += f;
    }
    for (int k0 = 0; k0 < P::C1; k0 += P::KS) {
      if (s-- == 0) { off = o; n = 2 * P::C2 * P::KS; return; }
      o += 2 * P::C2 * P::KS;
    }
    off = o + s * 2 * P::NP3 * P::KS;
    n = 2 * P::NP3 * P::KS;
  }
  __device__ float* slot_of(int s, int uu) const {
    if constexpr (P::RESIDENT) {
      int off, n;
      info(s, off, n);
      return base + off;
    } else {
      return base + (uu % P::NST) * P::SLOT;
    }
  }
  // Thread 0: start the copy of slice number uu of the block's sequence.
  __device__ void issue(int uu) {
    const int s = uu % P::NSL;
    const int slot = P::RESIDENT ? s : uu % P::NST;
    bulk_load(P::RESIDENT ? base + tab[2 * s] : base + slot * P::SLOT, packed + tab[2 * s],
              (uint32_t)(tab[2 * s + 1] * sizeof(float)), full + slot);
  }
  __device__ void prefill() {
    const int n = P::RESIDENT ? P::NSL : (total < P::NST ? total : P::NST);
    for (int i = 0; i < n; ++i) issue(i);
  }
  // Wait for the current slice (s = its index in the tile) to land.
  __device__ __forceinline__ const float* wait(int s) {
    if constexpr (P::RESIDENT) {
      mbar_wait(full + s, 0);
    } else {
      mbar_wait(full + u % P::NST, (u / P::NST) & 1);
    }
    return slot_of(s, u);
  }
  // This warp is done with the current slice (its wgmma reads completed).
  // Trouble spot 4: the ring's phases. Use number k of a slot completes
  // phase k of its full barrier (bytes landed) and of its empty barrier
  // (all warps read it), so both are waited on with parity k & 1. Thread 0
  // refills the slot of slice u - LAG once every warp has released it: the
  // warpgroups never wait for each other unless one runs LAG slices ahead.
  __device__ __forceinline__ void release() {
    if constexpr (!P::RESIDENT) {
      if ((threadIdx.x & 31) == 0) mbar_arrive(empty + u % P::NST);
      const int v = u - LAG;
      if (threadIdx.x == 0 && v >= 0 && v + P::NST < total) {
        mbar_wait(empty + v % P::NST, (v / P::NST) & 1);
        issue(v + P::NST);
      }
      __syncwarp();
    }
    ++u;
  }
};

// acc (64 x N, fragment) += A (64 x K) * packed W^T slices s0 .. s0 + K/KS - 1.
// `kdepth` is K; every slice is KS deep except a ragged last one.
template <class P, int N, int K, class A>
__device__ __forceinline__ void gemm(float (&acc)[N / 2], const A& a, Ring<P>& ring, int s0) {
  constexpr int STEPS = P::KS / 8;
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += P::KS) {
    const int kc = K - k0 < P::KS ? K - k0 : P::KS;
    const float* w = ring.wait(s0 + k0 / P::KS);
    uint32_t ahi[STEPS][4], alo[STEPS][4];
#pragma unroll
    for (int t = 0; t < STEPS; ++t) {
      if (8 * t < kc) {
        float x[4];
        a.load(k0 / 8 + t, x);
        split4(x, ahi[t], alo[t]);
      }
    }
    // Trouble spot 4: wgmma.fence orders the register writes above (bias,
    // previous epilogue, split operands) before the asynchronous MMAs;
    // commit + wait_group 0 complete them before the accumulator is read or
    // the slot released; fence_regs keeps the compiler from moving
    // accumulator accesses across either point.
    fence_regs(acc);
    wgmma_fence();
    const uint32_t sbo = (uint32_t)kc * 32;  // kc / 4 core matrices of 128 B
#pragma unroll
    for (int t = 0; t < STEPS; ++t) {
      if (8 * t < kc) {
        const uint64_t dhi = make_desc(w + 64 * t, sbo);           // +2 core matrices in K
        const uint64_t dlo = make_desc(w + N * kc + 64 * t, sbo);  // lo block after hi
        wgmma<N>(acc, ahi[t], dlo);
        wgmma<N>(acc, alo[t], dhi);
        wgmma<N>(acc, ahi[t], dhi);
      }
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);
    ring.release();
  }
}

// Accumulator fragment := bias (the sum is added onto it).
template <int N>
__device__ __forceinline__ void init_bias(float (&acc)[N / 2], const float* __restrict__ b, int tig) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(b + 8 * j + 2 * tig));
    acc[4 * j] = v.x; acc[4 * j + 1] = v.y; acc[4 * j + 2] = v.x; acc[4 * j + 3] = v.y;
  }
}

template <int N>
__device__ __forceinline__ void relu(float (&acc)[N / 2]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = fmaxf(acc[i], 0.f);
}

// ---- the kernel ---------------------------------------------------------------

// Barrier of one warpgroup's 128 threads (ids 1..GROUPS; 0 is __syncthreads).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
}

template <class P>
__global__ void __launch_bounds__(P::THREADS, 1)
sa_mlp_max_kernel(const float* __restrict__ xyz, long long xyz_ms, long long xyz_rs,
                  const float* __restrict__ feats, long long f_ms, long long f_rs, int cf, int vec4,
                  const int* __restrict__ cidx, const int* __restrict__ gidx,
                  long long G, int S, int K, const float* __restrict__ packed,
                  const float* __restrict__ b1, const float* __restrict__ b2,
                  const float* __restrict__ b3, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, wg = tid >> 7, t128 = tid & 127;
  const int warp = t128 >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  float* buf = reinterpret_cast<float*>(smem + P::OFF_BUF) + wg * ROWS * P::LDA;
  int* idx = reinterpret_cast<int*>(smem + P::OFF_IDX) + wg * ROWS;
  float* cen = reinterpret_cast<float*>(smem + P::OFF_CEN) + wg * 8;  // [0..2] xyz, [4] cidx
  float* red = reinterpret_cast<float*>(smem + P::OFF_RED) + wg * 4 * NMAX;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + P::OFF_BAR);

  const long long ntiles = (G + P::GROUPS - 1) / P::GROUPS;
  const int my_tiles = (int)((ntiles - 1 - blockIdx.x) / gridDim.x + 1);  // grid <= ntiles

  // Trouble spot 1: Cin = 3 + cf is padded to K1 (a multiple of 8) and rows
  // r >= K are padding. Both stay zero for the kernel's lifetime: the gather
  // below writes only columns < cf + 3 of rows < K, and K is fixed per launch.
  // The packed weights' pad rows are zero as well, so no pad term is ever
  // anything but 0 * 0.
  for (int i = tid; i < P::GROUPS * ROWS * P::LDA; i += P::THREADS)
    reinterpret_cast<float*>(smem + P::OFF_BUF)[i] = 0.f;
  int* tab = reinterpret_cast<int*>(smem + P::OFF_TAB);
  if (tid == 0) {
    for (int i = 0; i < P::NST; ++i) {
      mbar_init(bars + i, 1);
      mbar_init(bars + P::NST + i, 4 * P::GROUPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < P::NSL; ++s) Ring<P>::info(s, tab[2 * s], tab[2 * s + 1]);
  }
  __syncthreads();
  Ring<P> ring{reinterpret_cast<float*>(smem), bars, bars + P::NST, packed, tab, 0,
               my_tiles * P::NSL};
  if (tid == 0) ring.prefill();

  // Each warpgroup gathers its own group in two steps, the indices, then the
  // rows; from here on the warpgroups meet only at the weight ring.
  auto issue_idx = [&](long long tile) {
    const long long grp = tile * P::GROUPS + wg;
    if (grp >= G) return;
    const int s = (int)(grp % S);
    if (t128 < K) cp_async4(idx + t128, gidx + (long long)s * K + t128);
    if (t128 == 127) cp_async4(cen + 4, cidx + s);
    cp_async_commit();
  };
  // A thread copies chunks q0, q0 + qstep, ... of rows r0, r0 + rstep, ...
  // of the feats (chunks of 16 B with vec4, else 4 B): the divisions by the
  // runtime chunk count happen once, here.
  const int nch = vec4 ? cf >> 2 : cf;
  const int rstep = nch >= 128 || nch == 0 ? 1 : 128 / nch;
  const int r0 = nch >= 128 || nch == 0 ? 0 : (t128 < rstep * nch ? t128 / nch : ROWS);
  const int q0 = nch >= 128 || nch == 0 ? t128 : t128 % nch, qstep = nch >= 128 ? 128 : nch;
  auto issue_rows = [&](long long tile) {
    const long long grp = tile * P::GROUPS + wg;
    if (grp >= G) return;
    const long long m = grp / S;
    const float* xm = xyz + m * xyz_ms;
    const float* fm = feats + m * f_ms;
    for (int r = r0; r < K; r += rstep) {
      const float* src = fm + idx[r] * f_rs;
      float* dst = buf + r * P::LDA;
      for (int q = q0; q < nch; q += qstep) {
        if (vec4) cp_async16(dst + 4 * q, src + 4 * q);
        else cp_async4(dst + q, src + q);
      }
    }
    for (int c = t128; c < K * 3; c += 128) {
      const int r = c / 3, d = c - r * 3;
      cp_async4(buf + r * P::LDA + cf + d, xm + idx[r] * xyz_rs + d);
    }
    if (t128 < 3) cp_async4(cen + t128, xm + (long long)__float_as_int(cen[4]) * xyz_rs + t128);
    cp_async_commit();
  };

  long long tile = blockIdx.x;
  issue_idx(tile);
  cp_async_wait_all();
  wg_sync(wg);
  issue_rows(tile);

  const int row = warp * 16 + gid;  // this thread's two rows of the tile
  const SmemA a1{buf + row * P::LDA, buf + (row + 8) * P::LDA, tig};
  for (int it = 0; it < my_tiles; ++it, tile += gridDim.x) {
    const long long grp = tile * P::GROUPS + wg;
    const bool valid = grp < G;
    cp_async_wait_all();
    wg_sync(wg);
    // x_r = [feats, xyz - centre, 0 ...]: the wrapper packs W1's rows in this order
    if (valid) {
      for (int c = t128; c < K * 3; c += 128) {
        const int r = c / 3, d = c - r * 3;
        buf[r * P::LDA + cf + d] -= cen[d];
      }
    }
    wg_sync(wg);
    if (it + 1 < my_tiles) issue_idx(tile + gridDim.x);

    float h1[P::C1 / 2];
    init_bias<P::C1>(h1, b1, tig);
    gemm<P, P::C1, P::K1>(h1, a1, ring, 0);
    relu<P::C1>(h1);

    // Layer 1 has read the rows: gather the next tile's while layers 2-3 run.
    cp_async_wait_all();
    wg_sync(wg);
    if (it + 1 < my_tiles) issue_rows(tile + gridDim.x);

    float h2[P::C2 / 2];
    init_bias<P::C2>(h2, b2, tig);
    gemm<P, P::C2, P::C1>(h2, RegA<P::C1 / 2>{h1}, ring, P::NS1);
    relu<P::C2>(h2);

    // Trouble spot 2: ragged groups. Rows r >= K compute relu(b) (> 0 for
    // some columns), so they are masked out of the max; relu >= 0 and K >= 1
    // make 0 a neutral start.
    const bool v0 = row < K, v1 = row + 8 < K;
#pragma unroll
    for (int p = 0; p < P::C3 / P::NP3; ++p) {
      float h3[P::NP3 / 2];
      init_bias<P::NP3>(h3, b3 + p * P::NP3, tig);
      gemm<P, P::NP3, P::C2>(h3, RegA<P::C2 / 2>{h2}, ring, P::NS1 + P::C1 / P::KS + p * (P::C2 / P::KS));
#pragma unroll
      for (int j = 0; j < P::NP3 / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = fmaxf(v0 ? h3[4 * j + e] : 0.f, v1 ? h3[4 * j + 2 + e] : 0.f);
          v = fmaxf(v, 0.f);
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 8));
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 16));
          if (gid == 0) red[warp * NMAX + 8 * j + 2 * tig + e] = v;
        }
      }
      wg_sync(wg);
      if (valid && t128 < P::NP3) {
        const float v = fmaxf(fmaxf(red[t128], red[NMAX + t128]),
                              fmaxf(red[2 * NMAX + t128], red[3 * NMAX + t128]));
        out[grp * P::C3 + p * P::NP3 + t128] = v;
      }
      wg_sync(wg);
    }
  }
}

constexpr int MAX_DEVICES = 64;

template <class P>
int launch(const float* xyz, long long xyz_ms, long long xyz_rs,
           const float* feats, long long f_ms, long long f_rs, int cf, int vec4,
           const int* cidx, const int* gidx, int M, int S, int K, const float* packed,
           const float* b1, const float* b2, const float* b3, float* out, cudaStream_t stream) {
  // The shared-memory opt-in and the SM count are per device; both are
  // looked up once per device and instance.
  static int sms[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    err = cudaFuncSetAttribute(sa_mlp_max_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)P::SMEM);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  const long long G = (long long)M * S;
  const long long ntiles = (G + P::GROUPS - 1) / P::GROUPS;
  const int grid = (int)(ntiles < sms[dev] ? ntiles : sms[dev]);
  sa_mlp_max_kernel<P><<<grid, P::THREADS, P::SMEM, stream>>>(
      xyz, xyz_ms, xyz_rs, feats, f_ms, f_rs, cf, vec4, cidx, gidx, G, S, K, packed,
      b1, b2, b3, out);
  return (int)cudaGetLastError();
}

// SA1: all weights resident, 3 warpgroups a block. SA2: 32-deep K-slices
// through 4 ring slots, 2 warpgroups. Trouble spot 5 (registers): the widest
// accumulator is a 64 x 128 part (64 registers a thread); SA2's layer 3
// (N = 256) runs as two such parts over the same h2 fragment. chip_smoke.py
// prints ptxas's registers and spills for both instances (PERF.md §6 keeps
// them; no spills). The split operands of one 32-deep slice take 32
// registers a thread, so deeper slices or a third SA2 warpgroup (168
// registers at most) would spill. The slice depths and warpgroup counts were
// chosen by timing the alternatives on an H100 80GB HBM3 (700 W), PERF.md §6.
using SA1 = Cfg<64, 64, 128, 16, 32, 0, 3>;
using SA2 = Cfg<128, 128, 256, 136, 32, 4, 2>;

}  // namespace

// The packed-weight layout of the instance for widths (c1, c2, c3): layer-1
// depth K1 (3 + cf padded to a multiple of 8; cf <= K1 - 3) and K-slice depth
// KS, which must equal SA_LAYOUT in ops/sa_fused.py, the layout that
// pack_sa_weights writes (the wrapper checks before it launches). Returns
// cudaErrorInvalidValue for widths without an instance.
extern "C" int sa_mlp_max_layout(int c1, int c2, int c3, int* k1, int* ks) {
  if (c1 == SA1::C1 && c2 == SA1::C2 && c3 == SA1::C3) { *k1 = SA1::K1; *ks = SA1::KS; return 0; }
  if (c1 == SA2::C1 && c2 == SA2::C2 && c3 == SA2::C3) { *k1 = SA2::K1; *ks = SA2::KS; return 0; }
  return (int)cudaErrorInvalidValue;
}

// xyz: (M, N, 3) floats, element (m, n, d) at m * xyz_ms + n * xyz_rs + d;
// feats: (M, N, cf) floats, element (m, n, f) at m * f_ms + n * f_rs + f;
// vec4 != 0 promises 16-byte aligned feats rows (pointer, f_ms, f_rs, cf all
// multiples of 4 floats); center_idx (S,) and group_idx (S, K) int32 into N;
// packed: the folded weights as pack_sa_weights (ops/sa_fused.py) lays them
// out for sa_mlp_max_layout's K1 and KS, 16-byte aligned; b_i (C_i,)
// contiguous; out contiguous (M, S, C3). Widths (64, 64, 128) with cf <= 13
// or (128, 128, 256) with cf <= 133; 1 <= K <= 64. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for an unsupported shape).
extern "C" int sa_mlp_max_tf32(const float* xyz, long long xyz_ms, long long xyz_rs,
                               const float* feats, long long f_ms, long long f_rs, int cf, int vec4,
                               const int* cidx, const int* gidx, int M, int S, int K,
                               int c1, int c2, int c3, const float* packed,
                               const float* b1, const float* b2, const float* b3,
                               float* out, void* stream) {
  if (K < 1 || K > ROWS || cf < 0) return (int)cudaErrorInvalidValue;
  if ((long long)M * S == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (c1 == SA1::C1 && c2 == SA1::C2 && c3 == SA1::C3 && cf + 3 <= SA1::K1)
    return launch<SA1>(xyz, xyz_ms, xyz_rs, feats, f_ms, f_rs, cf, vec4, cidx, gidx,
                       M, S, K, packed, b1, b2, b3, out, st);
  if (c1 == SA2::C1 && c2 == SA2::C2 && c3 == SA2::C3 && cf + 3 <= SA2::K1)
    return launch<SA2>(xyz, xyz_ms, xyz_rs, feats, f_ms, f_rs, cf, vec4, cidx, gidx,
                       M, S, K, packed, b1, b2, b3, out, st);
  return (int)cudaErrorInvalidValue;
}
