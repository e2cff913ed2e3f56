// Depth-guided AdaIN channel gate: the Hopper port of the TPU kernel
// dasa_tpu/ops/adain.py:_kernel (reached through _pallas_forward /
// adain_channel_gate).
//
// What it computes, for rows n of the panorama (B*36) or the candidates
// (B*K) at C = 2048 channels:
//   out[n, c] = sigmoid(sum_k d[n, k] W[k, c] + b[c]) * f[n, c] * noise[c]
// with the product accumulated in f32 and the epilogue in f32, rounded to
// bf16 once on the store.  W arrives as W^T (C x K, the torch Linear
// layout), so a transposed view of the module's weight needs no copy.
//
// What bounds it on an H100: 2 n C K flops (6.0 GFLOP for 720 rows) over
// ~17 MB of traffic: ~6 us at the bf16 tensor-core peak, so at these
// shapes it is a small GEMM near the ridge point, not a pure stream.
//
// Design: a tiled GEMM with the gate fused into its epilogue, so the
// (n x C) pre-activation never reaches device memory (the TPU kernel's
// point as well).  64 x 64 output tiles, a K loop in steps of 32 through
// shared memory, four warps each owning a 32 x 32 quarter as 2 x 2 WMMA
// bf16 fragments with f32 accumulators.  The epilogue stages the tile in
// shared memory and applies sigmoid, the f multiply and the noise multiply
// with coalesced loads and stores.  Rows past n (720 and 320 are not
// multiples of 64) load as zeros and are not stored.

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;
using dasa::bf16;

namespace {

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int kThreads = 128;
constexpr int LDS = BK + 8;   // bf16 row stride of the operand tiles
constexpr int LDC = BN + 4;   // f32 row stride of the epilogue tile

__global__ void __launch_bounds__(kThreads)
adain_gate_kernel(const bf16* __restrict__ d,      // (n, K)
                  const bf16* __restrict__ f,      // (n, C)
                  const bf16* __restrict__ wt,     // (C, K) = W^T
                  const bf16* __restrict__ bias,   // (C,)
                  const bf16* __restrict__ noise,  // (C,) or null
                  bf16* __restrict__ out,          // (n, C)
                  int n, int C, int K) {
  __shared__ __align__(128) bf16 as[BM * LDS];
  __shared__ __align__(128) bf16 bs[BN * LDS];
  __shared__ __align__(128) float cs[BM * LDC];

  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;
  const int n0 = blockIdx.y * BM, c0 = blockIdx.x * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  constexpr int kVec = BK / 8;  // uint4 per tile row
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int idx = tid; idx < BM * kVec; idx += kThreads) {
      const int r = idx / kVec, v = idx % kVec;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (n0 + r < n)
        val = *reinterpret_cast<const uint4*>(d + (size_t)(n0 + r) * K + k0 +
                                              v * 8);
      *reinterpret_cast<uint4*>(as + r * LDS + v * 8) = val;
    }
    for (int idx = tid; idx < BN * kVec; idx += kThreads) {
      const int r = idx / kVec, v = idx % kVec;
      *reinterpret_cast<uint4*>(bs + r * LDS + v * 8) =
          *reinterpret_cast<const uint4*>(wt + (size_t)(c0 + r) * K + k0 +
                                          v * 8);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], as + (wm * 32 + i * 16) * LDS + kk, LDS);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], bs + (wn * 32 + j * 16) * LDS + kk, LDS);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();

  for (int idx = tid; idx < BM * BN; idx += kThreads) {
    const int r = idx / BN, c = idx % BN;
    const int row = n0 + r, col = c0 + c;
    if (row >= n) continue;
    const float gate = dasa::sigmoid(cs[r * LDC + c] + dasa::to_f(bias[col]));
    float o = gate * dasa::to_f(f[(size_t)row * C + col]);
    if (noise != nullptr) o *= dasa::to_f(noise[col]);
    out[(size_t)row * C + col] = dasa::to_bf(o);
  }
}

}  // namespace

extern "C" int dasa_adain_gate(const void* d, const void* f, const void* wt,
                               const void* bias, const void* noise, void* out,
                               int n, int C, int K, void* stream) {
  const dim3 grid(C / BN, (n + BM - 1) / BM);
  adain_gate_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(d), static_cast<const bf16*>(f),
      static_cast<const bf16*>(wt), static_cast<const bf16*>(bias),
      static_cast<const bf16*>(noise), static_cast<bf16*>(out), n, C, K);
  return cudaGetLastError();
}
