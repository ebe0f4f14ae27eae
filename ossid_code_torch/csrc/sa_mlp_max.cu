// PointNet++ SetAbstraction stage with the inference BatchNorm folded in,
// gather included, float32:
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
// What bounds it on an H100: arithmetic. SA1 is ~109 GFLOP and SA2 ~138 GFLOP
// at M = 128, against a few MB of input (the points, the indices, the
// weights) and output; at the 67 TFLOP/s of FP32 outside the tensor cores the
// least times are ~1.6 ms and ~2.1 ms.
//
// What the design does about it:
//  * one block of 256 threads per (hypothesis, centre) group. The block
//    gathers its k <= 64 rows by group_idx / center_idx straight from xyz and
//    feats into shared memory, so the grouped (M, S, k, Cin) tensor (549 MB at
//    SA2, M = 128) is never written to HBM; the Pallas kernel had to be given
//    it pre-gathered;
//  * the three layers run with the activations in shared memory (two
//    ping-pong buffers, rows padded to an odd stride against bank
//    conflicts); each thread owns a tile of rows x 4 output columns and
//    streams its weight rows as float4 loads through L1/L2, one layer at a
//    time (SA2's 263 KB of weights do not fit a block's shared memory);
//  * the max over k is the epilogue of layer 3: relu output is >= 0, so the
//    per-column max is a shared-memory atomicMax on the float bit patterns;
//  * ragged edges are masked (rows r >= K never reach the max); there is no
//    divisibility condition on M * S (the Pallas path fell back to XLA
//    whenever M * S % 64 != 0).
// This first version stays on the FP32 pipes; the TF32/bf16 tensor cores
// (wgmma) are the later step, with 495/989 TFLOP/s of headroom.

#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 64;      // group members per block (k <= ROWS)
constexpr int THREADS = 256;

template <int COUT>
struct Tile {
  static constexpr int NCG = COUT / 4;        // column groups of 4
  static constexpr int NRG = THREADS / NCG;   // row groups
  static constexpr int RPT = ROWS / NRG;      // rows per thread
  static_assert(COUT % 16 == 0 && NRG >= 1 && RPT >= 1, "unsupported width");
};

// acc[j][q] = b[col] + sum_i in[row_j][i] * W[i][col], row_j = rg + j * NRG,
// col = 4 * cg + q.
template <int COUT>
__device__ __forceinline__ void mlp_layer(const float* in, int in_stride, int cin,
                                          const float* __restrict__ W,
                                          const float* __restrict__ bias,
                                          float (&acc)[Tile<COUT>::RPT][4]) {
  constexpr int NCG = Tile<COUT>::NCG, NRG = Tile<COUT>::NRG, RPT = Tile<COUT>::RPT;
  const int cg = threadIdx.x % NCG;
  const int rg = threadIdx.x / NCG;
  const float4 bv = __ldg(reinterpret_cast<const float4*>(bias) + cg);
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    acc[j][0] = bv.x; acc[j][1] = bv.y; acc[j][2] = bv.z; acc[j][3] = bv.w;
  }
  const float4* W4 = reinterpret_cast<const float4*>(W);
  for (int i = 0; i < cin; ++i) {
    const float4 w = __ldg(W4 + (long long)i * NCG + cg);
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const float a = in[(rg + j * NRG) * in_stride + i];
      acc[j][0] = fmaf(a, w.x, acc[j][0]);
      acc[j][1] = fmaf(a, w.y, acc[j][1]);
      acc[j][2] = fmaf(a, w.z, acc[j][2]);
      acc[j][3] = fmaf(a, w.w, acc[j][3]);
    }
  }
}

template <int COUT>
__device__ __forceinline__ void store_relu(const float (&acc)[Tile<COUT>::RPT][4],
                                           float* out, int out_stride) {
  constexpr int NCG = Tile<COUT>::NCG, NRG = Tile<COUT>::NRG, RPT = Tile<COUT>::RPT;
  const int cg = threadIdx.x % NCG;
  const int rg = threadIdx.x / NCG;
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    float* o = out + (rg + j * NRG) * out_stride + 4 * cg;
#pragma unroll
    for (int q = 0; q < 4; ++q) o[q] = fmaxf(acc[j][q], 0.f);
  }
}

template <int C1, int C2, int C3>
__global__ void __launch_bounds__(THREADS)
sa_mlp_max_kernel(const float* __restrict__ xyz, long long xyz_ms, long long xyz_rs,
                  const float* __restrict__ feats, long long f_ms, long long f_rs, int cf,
                  const int* __restrict__ cidx, const int* __restrict__ gidx,
                  int S, int K,
                  const float* __restrict__ W1, const float* __restrict__ b1,
                  const float* __restrict__ W2, const float* __restrict__ b2,
                  const float* __restrict__ W3, const float* __restrict__ b3,
                  float* __restrict__ out) {
  extern __shared__ float smem[];
  const int cin = 3 + cf;
  const int sa = (cin > C2 ? cin : C2) | 1;  // odd row strides
  const int sb = C1 | 1;
  float* bufA = smem;                 // input rows, then layer-2 output
  float* bufB = bufA + ROWS * sa;     // layer-1 output
  float* colmax = bufB + ROWS * sb;   // (C3,) running max of layer 3

  const long long grp = blockIdx.x;   // m * S + s
  const long long m = grp / S;
  const int s = (int)(grp % S);
  const float* xm = xyz + m * xyz_ms;
  const float* fm = feats + m * f_ms;
  const long long c = cidx[s];

  for (int e = threadIdx.x; e < ROWS * cin; e += THREADS) {
    const int r = e / cin, ch = e % cin;
    float v = 0.f;
    if (r < K) {
      const long long g = gidx[(long long)s * K + r];
      v = ch < 3 ? xm[g * xyz_rs + ch] - xm[c * xyz_rs + ch]
                 : fm[g * f_rs + (ch - 3)];
    }
    bufA[r * sa + ch] = v;
  }
  for (int o = threadIdx.x; o < C3; o += THREADS) colmax[o] = 0.f;
  __syncthreads();

  {
    float acc[Tile<C1>::RPT][4];
    mlp_layer<C1>(bufA, sa, cin, W1, b1, acc);
    store_relu<C1>(acc, bufB, sb);
  }
  __syncthreads();
  {
    float acc[Tile<C2>::RPT][4];
    mlp_layer<C2>(bufB, sb, C1, W2, b2, acc);
    store_relu<C2>(acc, bufA, sa);
  }
  __syncthreads();
  {
    constexpr int NCG = Tile<C3>::NCG, NRG = Tile<C3>::NRG, RPT = Tile<C3>::RPT;
    float acc[RPT][4];
    mlp_layer<C3>(bufA, sa, C2, W3, b3, acc);
    const int cg = threadIdx.x % NCG;
    const int rg = threadIdx.x / NCG;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float mx = 0.f;
#pragma unroll
      for (int j = 0; j < RPT; ++j)
        if (rg + j * NRG < K) mx = fmaxf(mx, acc[j][q]);
      // non-negative floats order like their bit patterns as ints
      atomicMax(reinterpret_cast<int*>(colmax) + 4 * cg + q, __float_as_int(mx));
    }
  }
  __syncthreads();
  for (int o = threadIdx.x; o < C3; o += THREADS) out[grp * C3 + o] = colmax[o];
}

template <int C1, int C2, int C3>
int launch(const float* xyz, long long xyz_ms, long long xyz_rs,
           const float* feats, long long f_ms, long long f_rs, int cf,
           const int* cidx, const int* gidx, int M, int S, int K,
           const float* W1, const float* b1, const float* W2, const float* b2,
           const float* W3, const float* b3, float* out, cudaStream_t stream) {
  const int cin = 3 + cf;
  const int sa = (cin > C2 ? cin : C2) | 1;
  const int sb = C1 | 1;
  const size_t smem = sizeof(float) * ((size_t)ROWS * sa + (size_t)ROWS * sb + C3);
  cudaError_t err = cudaFuncSetAttribute(sa_mlp_max_kernel<C1, C2, C3>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  sa_mlp_max_kernel<C1, C2, C3><<<(unsigned)((long long)M * S), THREADS, smem, stream>>>(
      xyz, xyz_ms, xyz_rs, feats, f_ms, f_rs, cf, cidx, gidx, S, K,
      W1, b1, W2, b2, W3, b3, out);
  return (int)cudaGetLastError();
}

}  // namespace

// xyz: (M, N, 3) floats, element (m, n, d) at m * xyz_ms + n * xyz_rs + d;
// feats: (M, N, cf) floats, element (m, n, f) at m * f_ms + n * f_rs + f;
// center_idx (S,) and group_idx (S, K) int32 into N; W_i (Cin_i, C_i) and
// b_i (C_i,) contiguous, 16-byte aligned; out contiguous (M, S, C3).
// Widths (C1, C2, C3) in {(64, 64, 128), (128, 128, 256)}, 1 <= K <= 64.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for an
// unsupported shape).
extern "C" int sa_mlp_max_f32(const float* xyz, long long xyz_ms, long long xyz_rs,
                              const float* feats, long long f_ms, long long f_rs, int cf,
                              const int* cidx, const int* gidx, int M, int S, int K,
                              int c1, int c2, int c3,
                              const float* W1, const float* b1,
                              const float* W2, const float* b2,
                              const float* W3, const float* b3,
                              float* out, void* stream) {
  if (K < 1 || K > ROWS || cf < 0) return (int)cudaErrorInvalidValue;
  if ((long long)M * S == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (c1 == 64 && c2 == 64 && c3 == 128)
    return launch<64, 64, 128>(xyz, xyz_ms, xyz_rs, feats, f_ms, f_rs, cf, cidx, gidx,
                               M, S, K, W1, b1, W2, b2, W3, b3, out, st);
  if (c1 == 128 && c2 == 128 && c3 == 256)
    return launch<128, 128, 256>(xyz, xyz_ms, xyz_rs, feats, f_ms, f_rs, cf, cidx, gidx,
                                 M, S, K, W1, b1, W2, b2, W3, b3, out, st);
  return (int)cudaErrorInvalidValue;
}
