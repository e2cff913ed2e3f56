// Masked LSTM recurrence, backward: the Hopper port of the TPU kernel
// dasa_tpu/ops/lstm.py:_bwd_kernel (reached through _bwd_call from the
// custom VJP _lstm_bwd).
//
// What it computes, tokens in reverse (t = T-1 .. 0), f32 inside:
//   dh = dh_s + g_h[t];  dc = dc_s + g_c[t]
//   dh' = m_t dh;  dc' = m_t dc           (only the taken branch of the mask)
//   c' = f c_prev + i g;  tc = tanh(c')   (i, f, g, o = acts[t]; c_prev is
//                                          the bf16 c_seq[t-1], or c0)
//   dcn = dc' + dh' o (1 - tc^2)
//   dgates = [dcn g i(1-i), dcn c_prev f(1-f), dcn i(1-g^2), dh' tc o(1-o)]
//   dxw[t] = bf16(dgates)
//   dh_s = (1 - m_t) dh + bf16(dgates) . Wh^T        (f32 accumulate)
//   dc_s = (1 - m_t) dc + dcn f
// and dh0, dc0 = dh_s, dc_s (f32) after token 0.  dWh is one large product
// outside the kernel (ops/lstm.py), as in the TPU package.
//
// What bounds it on an H100: like the forward, a chain of T dependent
// tokens, each needing all of Wh (H x 4H bf16 = 8 MiB at H = 1024).  At the
// headline shape (T 80, B 20, H 1024) the call needs 13.4 GFLOP and moves
// ~45 MB, a bound of ~14 us; the 80 dependent steps decide the time.
//
// Design: one cooperative persistent launch.  CTA k owns U hidden units
// (U = 8 at H = 1024: 128 CTAs) and keeps their U rows of Wh (U x 4H bf16,
// 64 KiB) resident in shared memory for all tokens.  Per token it first
// computes the dgates of its own units' four gate columns from their f32
// (dh_s, dc_s), writes them to dxw[t], and meets the other CTAs at a grid
// barrier.  Then it reads the whole bf16 row dxw[t] (B x 4H: the operand
// the TPU kernel feeds its dot) back from L2 in K chunks, double-buffered
// with cp.async.cg, and forms dh_prev for its units on the tensor cores
// (WMMA m32n8k16 bf16, f32 accumulate, the K steps of each chunk split over
// the 8 warps and summed in shared memory).  The dc carry never leaves the
// CTA.  The row does not fit beside the weights at B = 20 (160 KiB), hence
// the chunks.  cudaLaunchCooperativeKernel refuses a grid that cannot be
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
  size_t ws, buf, acc, dh, dc, dhm, total;
};

// U units per CTA, kc gate columns per chunk of the dxw row
__host__ __device__ inline Layout bwd_layout(int B, int H, int U, int kc) {
  const size_t ldw = 4 * (size_t)H + kPad;
  const size_t lda = kc + kPad;
  const size_t mp = (B + 31) / 32 * 32;
  Layout l;
  l.ws = 0;
  l.buf = dasa::align_up(l.ws + U * ldw * sizeof(bf16), 128);
  l.acc = dasa::align_up(l.buf + 2 * mp * lda * sizeof(bf16), 128);
  l.dh = dasa::align_up(l.acc + kWarps * mp * U * sizeof(float), 128);
  l.dc = dasa::align_up(l.dh + B * U * sizeof(float), 128);
  l.dhm = dasa::align_up(l.dc + B * U * sizeof(float), 128);
  l.total = dasa::align_up(l.dhm + B * U * sizeof(float), 128);
  return l;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__global__ void __launch_bounds__(kThreads, 1)
lstm_bwd_kernel(const bf16* __restrict__ acts,    // (T, B, 4H)
                const bf16* __restrict__ c_prev,  // (T, B, H)
                const bf16* __restrict__ g_h,     // (T, B, H)
                const bf16* __restrict__ g_c,     // (T, B, H)
                const bf16* __restrict__ mask,    // (T, B)
                const bf16* __restrict__ wt,      // (4H, H) = Wh^T
                bf16* dxw,                        // (T, B, 4H)
                float* dh0, float* dc0,           // (B, H)
                unsigned int* barrier, int T, int B, int H, int U, int kc) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout l = bwd_layout(B, H, U, kc);
  bf16* ws = reinterpret_cast<bf16*>(smem + l.ws);      // [U][ldw]
  bf16* buf = reinterpret_cast<bf16*>(smem + l.buf);    // [2][Mp][lda]
  float* acc = reinterpret_cast<float*>(smem + l.acc);  // [ks][Mp][U]
  float* dh_s = reinterpret_cast<float*>(smem + l.dh);  // [B][U]
  float* dc_s = reinterpret_cast<float*>(smem + l.dc);  // [B][U]
  float* dhm = reinterpret_cast<float*>(smem + l.dhm);  // [B][U]

  const int tid = threadIdx.x, warp = tid / 32;
  const int G = 4 * H;
  const int ldw = G + kPad;
  const int lda = kc + kPad;
  const int mp = (B + 31) / 32 * 32;
  const int u0 = blockIdx.x * U;

  // resident weights: ws[u][j] = Wh[u0 + u][j] = wt[j][u0 + u]; the U
  // units of one gate column j are U / 8 contiguous 16-byte vectors
  const int uvec = U / 8;
  for (int idx = tid; idx < G * uvec; idx += kThreads) {
    const int j = idx / uvec, v = idx % uvec;
    const uint4 val =
        reinterpret_cast<const uint4*>(wt + (size_t)j * H + u0)[v];
    const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
    for (int q = 0; q < 8; ++q) ws[(size_t)(v * 8 + q) * ldw + j] = e[q];
  }
  // the padding rows of both chunk buffers stay zero (never loaded)
  const int pad_elems = (mp - B) * lda;
  for (int idx = tid; idx < 2 * pad_elems; idx += kThreads) {
    const int half = idx / pad_elems, r = idx % pad_elems;
    buf[((size_t)half * mp + B) * lda + r] = dasa::to_bf(0.0f);
  }
  for (int idx = tid; idx < B * U; idx += kThreads) {
    dh_s[idx] = 0.0f;
    dc_s[idx] = 0.0f;
  }
  __syncthreads();

  // warp -> (32-row tile, 8-column tile, K part); the host guarantees
  // tiles <= kWarps
  const int tiles_n = U / 8;
  const int tiles = (mp / 32) * tiles_n;
  const int ks = kWarps / tiles;
  const bool has_item = warp < tiles * ks;
  const int tile = warp % tiles, part = warp / tiles;
  const int mt = tile / tiles_n, nt = tile % tiles_n;
  const int nchunks = G / kc;
  const int ksteps = kc / 16;
  const int vrow = kc / 8;  // uint4 per chunk row

  for (int s = 0; s < T; ++s) {
    const int t = T - 1 - s;
    const size_t tb = (size_t)t * B;

    // 1. the dgates of this CTA's units, from the f32 carries
    for (int idx = tid; idx < B * U; idx += kThreads) {
      const int b = idx / U, u = idx % U;
      const size_t hoff = (tb + b) * H + u0 + u;
      const bf16* a = acts + (tb + b) * G + u0 + u;
      const float ig = dasa::to_f(a[0]);
      const float fg = dasa::to_f(a[H]);
      const float gg = dasa::to_f(a[2 * H]);
      const float og = dasa::to_f(a[3 * H]);
      const float cp = dasa::to_f(c_prev[hoff]);
      const float m = dasa::to_f(mask[tb + b]);
      const float dh = dh_s[idx] + dasa::to_f(g_h[hoff]);
      const float dc = dc_s[idx] + dasa::to_f(g_c[hoff]);
      const float dh_new = m * dh;
      const float tc = tanhf(fg * cp + ig * gg);
      const float dcn = m * dc + dh_new * og * (1.0f - tc * tc);
      bf16* d = dxw + (tb + b) * G + u0 + u;
      d[0] = dasa::to_bf(dcn * gg * ig * (1.0f - ig));
      d[H] = dasa::to_bf(dcn * cp * fg * (1.0f - fg));
      d[2 * H] = dasa::to_bf(dcn * ig * (1.0f - gg * gg));
      d[3 * H] = dasa::to_bf(dh_new * tc * og * (1.0f - og));
      dhm[idx] = (1.0f - m) * dh;
      dc_s[idx] = (1.0f - m) * dc + dcn * fg;
    }
    dasa::grid_barrier(barrier, (unsigned int)(s + 1) * gridDim.x);

    // 2. dh_prev = dxw[t] . Wh[units]^T, the row streamed in K chunks
    const bf16* row = dxw + tb * G;
    auto load_chunk = [&](int c) {
      bf16* dst = buf + (size_t)(c & 1) * mp * lda;
      for (int idx = tid; idx < B * vrow; idx += kThreads) {
        const int b = idx / vrow, v = idx % vrow;
        cp_async16(dst + (size_t)b * lda + v * 8,
                   row + (size_t)b * G + (size_t)c * kc + v * 8);
      }
      cp_async_commit();
    };
    wmma::fragment<wmma::accumulator, 32, 8, 16, float> frag;
    wmma::fill_fragment(frag, 0.0f);
    load_chunk(0);
    for (int c = 0; c < nchunks; ++c) {
      if (c + 1 < nchunks) {
        load_chunk(c + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (has_item) {
        const bf16* a_base = buf + ((size_t)(c & 1) * mp + mt * 32) * lda;
        const bf16* w_base = ws + (size_t)nt * 8 * ldw + (size_t)c * kc;
        for (int kk = part; kk < ksteps; kk += ks) {
          wmma::fragment<wmma::matrix_a, 32, 8, 16, bf16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 32, 8, 16, bf16, wmma::col_major> fb;
          wmma::load_matrix_sync(fa, a_base + kk * 16, lda);
          wmma::load_matrix_sync(fb, w_base + kk * 16, ldw);
          wmma::mma_sync(frag, fa, fb, frag);
        }
      }
      __syncthreads();  // the buffer is refilled two chunks later
    }
    if (has_item)
      wmma::store_matrix_sync(acc + ((size_t)part * mp + mt * 32) * U + nt * 8,
                              frag, U, wmma::mem_row_major);
    __syncthreads();
    // each thread keeps the (b, u) entries it owns in step 1
    for (int idx = tid; idx < B * U; idx += kThreads) {
      const int b = idx / U, u = idx % U;
      float sum = 0.0f;
      for (int p = 0; p < ks; ++p) sum += acc[((size_t)p * mp + b) * U + u];
      dh_s[idx] = dhm[idx] + sum;
    }
  }

  for (int idx = tid; idx < B * U; idx += kThreads) {
    const int b = idx / U, u = idx % U;
    dh0[(size_t)b * H + u0 + u] = dh_s[idx];
    dc0[(size_t)b * H + u0 + u] = dc_s[idx];
  }
}

}  // namespace

extern "C" int dasa_lstm_bwd(const void* acts, const void* c_prev,
                             const void* g_h, const void* g_c,
                             const void* mask, const void* wt, void* dxw,
                             void* dh0, void* dc0, void* barrier, int T, int B,
                             int H, int U, int kc, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = bwd_layout(B, H, U, kc).total;
  cudaError_t e = cudaFuncSetAttribute(
      lstm_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  e = cudaMemsetAsync(barrier, 0, sizeof(unsigned int), s);
  if (e != cudaSuccess) return e;
  const bf16* a_acts = static_cast<const bf16*>(acts);
  const bf16* a_cp = static_cast<const bf16*>(c_prev);
  const bf16* a_gh = static_cast<const bf16*>(g_h);
  const bf16* a_gc = static_cast<const bf16*>(g_c);
  const bf16* a_mask = static_cast<const bf16*>(mask);
  const bf16* a_wt = static_cast<const bf16*>(wt);
  bf16* a_dxw = static_cast<bf16*>(dxw);
  float* a_dh0 = static_cast<float*>(dh0);
  float* a_dc0 = static_cast<float*>(dc0);
  unsigned int* a_bar = static_cast<unsigned int*>(barrier);
  void* args[] = {&a_acts, &a_cp,  &a_gh,  &a_gc, &a_mask, &a_wt,
                  &a_dxw,  &a_dh0, &a_dc0, &a_bar, &T,     &B,
                  &H,      &U,     &kc};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(lstm_bwd_kernel),
                                  dim3(H / U), dim3(kThreads), args, smem, s);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}
