// Masked LSTM recurrence, forward: the Hopper port of the TPU kernel
// dasa_tpu/ops/lstm.py:_fwd_kernel (reached through _fwd_call / lstm_scan).
//
// What it computes (per direction of the DicEncoder's top BiLSTM):
//   gates_t = xw_t + bf16(h_{t-1}) . Wh   (f32 accumulate; order i,f,g,o)
//   c' = sig(f) c + sig(i) tanh(g);  h' = sig(o) tanh(c')
//   (h, c) = m_t (h', c') + (1 - m_t) (h, c)        carry in f32
//   h_seq[t], c_seq[t] = bf16(h), bf16(c)          (post-mask carry)
//   acts[t] = bf16(sig(i), sig(f), tanh(g), sig(o))  (optional)
// The gate activations are the TPU kernel's act_out: the backward kernel
// (lstm_bwd.cu) consumes them.  A null acts pointer (evaluation) skips
// them.
//
// What bounds it on an H100: the 80 tokens are strictly sequential, and
// every token needs all of Wh (H x 4H bf16 = 8 MiB at H = 1024), which no
// single SM's shared memory holds.  At the headline shape the whole call
// needs 13.4 GFLOP and ~28 MB, a bound of ~14 us; in practice the chain
// of 80 dependent steps decides the time.
//
// Design: one cooperative launch holds the whole token loop.  The grid is
// persistent: CTA k owns U hidden units (U = 8 at H = 1024, 128 CTAs) and
// keeps the 4U matching gate rows of Wh^T resident in shared memory for all
// tokens, so the weights are read from device memory once per call.  Every
// token each CTA copies h_{t-1} (B x H bf16; the previous token's h_seq row,
// which is bf16(h) exactly) into shared memory, runs the (B x H) . (H x 4U)
// product on the tensor cores (WMMA bf16, f32 accumulate, split over K
// across the 8 warps), applies the cell update for its own units, writes
// its slice of h_t and c_t, and meets the other CTAs at a grid barrier.
// The cell update stays local because a CTA holds all four gates of its
// units.  cudaLaunchCooperativeKernel refuses a grid that cannot be
// resident at once instead of letting the barrier deadlock.

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;
using dasa::bf16;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPad = 8;  // bf16 elements of row padding in shared memory

struct Layout {
  size_t ws, ha, acc, hs, cs, total;
};

__host__ __device__ inline Layout lstm_layout(int B, int H, int U, int ks) {
  const size_t ld = H + kPad;
  const size_t mp = (B + 15) / 16 * 16;
  const size_t n = 4 * U;
  Layout l;
  l.ws = 0;
  l.ha = dasa::align_up(l.ws + n * ld * sizeof(bf16), 128);
  l.acc = dasa::align_up(l.ha + mp * ld * sizeof(bf16), 128);
  l.hs = dasa::align_up(l.acc + ks * mp * n * sizeof(float), 128);
  l.cs = dasa::align_up(l.hs + B * U * sizeof(float), 128);
  l.total = dasa::align_up(l.cs + B * U * sizeof(float), 128);
  return l;
}

__global__ void __launch_bounds__(kThreads, 1)
lstm_fwd_kernel(const bf16* __restrict__ xw,    // (T, B, 4H)
                const bf16* __restrict__ mask,  // (T, B)
                const bf16* __restrict__ h0,    // (B, H)
                const bf16* __restrict__ c0,    // (B, H)
                const bf16* __restrict__ wt,    // (4H, H) = Wh^T
                bf16* h_seq,                    // (T, B, H)
                bf16* c_seq,                    // (T, B, H)
                bf16* acts,                     // (T, B, 4H) or null
                unsigned int* barrier, int T, int B, int H, int U, int ks) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout l = lstm_layout(B, H, U, ks);
  bf16* ws = reinterpret_cast<bf16*>(smem + l.ws);      // [4U][ld]
  bf16* ha = reinterpret_cast<bf16*>(smem + l.ha);      // [Mp][ld]
  float* acc = reinterpret_cast<float*>(smem + l.acc);  // [ks][Mp][4U]
  float* hs = reinterpret_cast<float*>(smem + l.hs);    // [B][U]
  float* cs = reinterpret_cast<float*>(smem + l.cs);    // [B][U]

  const int tid = threadIdx.x, warp = tid / 32;
  const int ld = H + kPad;
  const int mp = (B + 15) / 16 * 16;
  const int n = 4 * U;
  const int u0 = blockIdx.x * U;
  const int vrow = H / 8;  // uint4 per row

  // resident weights: row j = gate j / U of unit u0 + j % U
  for (int idx = tid; idx < n * vrow; idx += kThreads) {
    const int j = idx / vrow, v = idx % vrow;
    const size_t src = (size_t)((j / U) * H + u0 + j % U) * H;
    reinterpret_cast<uint4*>(ws + (size_t)j * ld)[v] =
        reinterpret_cast<const uint4*>(wt + src)[v];
  }
  for (int idx = tid; idx < (mp - B) * ld; idx += kThreads)
    ha[(size_t)B * ld + idx] = dasa::to_bf(0.0f);
  for (int idx = tid; idx < B * U; idx += kThreads) {
    const int b = idx / U, u = idx % U;
    hs[idx] = dasa::to_f(h0[(size_t)b * H + u0 + u]);
    cs[idx] = dasa::to_f(c0[(size_t)b * H + u0 + u]);
  }

  const int tiles_n = n / 16;
  const int tiles = (mp / 16) * tiles_n;
  const int ksteps = H / 16;
  const int kchunk = (ksteps + ks - 1) / ks;

  for (int t = 0; t < T; ++t) {
    // h_{t-1} in the weights' dtype: h0, or the previous token's output
    // row written by every CTA (read past L1, which is not coherent)
    for (int idx = tid; idx < B * vrow; idx += kThreads) {
      const int b = idx / vrow, v = idx % vrow;
      uint4 val;
      if (t == 0) {
        val = reinterpret_cast<const uint4*>(h0 + (size_t)b * H)[v];
      } else {
        val = __ldcg(reinterpret_cast<const uint4*>(
                         h_seq + ((size_t)(t - 1) * B + b) * H) + v);
      }
      reinterpret_cast<uint4*>(ha + (size_t)b * ld)[v] = val;
    }
    __syncthreads();

    for (int p = warp; p < tiles * ks; p += kWarps) {
      const int tile = p % tiles, part = p / tiles;
      const int mt = tile / tiles_n, nt = tile % tiles_n;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::fill_fragment(c, 0.0f);
      const int k_lo = part * kchunk;
      const int k_hi = min(ksteps, k_lo + kchunk);
      for (int kk = k_lo; kk < k_hi; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> w;
        wmma::load_matrix_sync(a, ha + (size_t)mt * 16 * ld + kk * 16, ld);
        wmma::load_matrix_sync(w, ws + (size_t)nt * 16 * ld + kk * 16, ld);
        wmma::mma_sync(c, a, w, c);
      }
      wmma::store_matrix_sync(acc + ((size_t)part * mp + mt * 16) * n + nt * 16,
                              c, n, wmma::mem_row_major);
    }
    __syncthreads();

    const bf16* xw_t = xw + (size_t)t * B * 4 * H;
    for (int idx = tid; idx < B * U; idx += kThreads) {
      const int b = idx / U, u = idx % U;
      float g[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float s = dasa::to_f(xw_t[(size_t)b * 4 * H + q * H + u0 + u]);
        for (int part = 0; part < ks; ++part)
          s += acc[((size_t)part * mp + b) * n + q * U + u];
        g[q] = s;
      }
      const float ig = dasa::sigmoid(g[0]);
      const float fg = dasa::sigmoid(g[1]);
      const float gg = tanhf(g[2]);
      const float og = dasa::sigmoid(g[3]);
      const float c_new = fg * cs[idx] + ig * gg;
      const float h_new = og * tanhf(c_new);
      const float m = dasa::to_f(mask[(size_t)t * B + b]);
      const float h = m * h_new + (1.0f - m) * hs[idx];
      const float cc = m * c_new + (1.0f - m) * cs[idx];
      hs[idx] = h;
      cs[idx] = cc;
      const size_t o = ((size_t)t * B + b) * H + u0 + u;
      h_seq[o] = dasa::to_bf(h);
      c_seq[o] = dasa::to_bf(cc);
      if (acts != nullptr) {
        bf16* a = acts + ((size_t)t * B + b) * 4 * H + u0 + u;
        a[0] = dasa::to_bf(ig);
        a[H] = dasa::to_bf(fg);
        a[2 * H] = dasa::to_bf(gg);
        a[3 * H] = dasa::to_bf(og);
      }
    }
    if (t + 1 < T)
      dasa::grid_barrier(barrier, (unsigned int)(t + 1) * gridDim.x);
  }
}

}  // namespace

extern "C" int dasa_lstm_fwd(const void* xw, const void* mask, const void* h0,
                             const void* c0, const void* wt, void* h_seq,
                             void* c_seq, void* acts, void* barrier, int T,
                             int B, int H,
                             int U, int ks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = lstm_layout(B, H, U, ks).total;
  cudaError_t e = cudaFuncSetAttribute(
      lstm_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  e = cudaMemsetAsync(barrier, 0, sizeof(unsigned int), s);
  if (e != cudaSuccess) return e;
  const bf16* a_xw = static_cast<const bf16*>(xw);
  const bf16* a_mask = static_cast<const bf16*>(mask);
  const bf16* a_h0 = static_cast<const bf16*>(h0);
  const bf16* a_c0 = static_cast<const bf16*>(c0);
  const bf16* a_wt = static_cast<const bf16*>(wt);
  bf16* a_h = static_cast<bf16*>(h_seq);
  bf16* a_c = static_cast<bf16*>(c_seq);
  bf16* a_acts = static_cast<bf16*>(acts);
  unsigned int* a_bar = static_cast<unsigned int*>(barrier);
  void* args[] = {&a_xw, &a_mask, &a_h0, &a_c0, &a_wt, &a_h,
                  &a_c,  &a_acts, &a_bar, &T, &B, &H, &U, &ks};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(lstm_fwd_kernel),
                                  dim3(H / U), dim3(kThreads), args, smem, s);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}
