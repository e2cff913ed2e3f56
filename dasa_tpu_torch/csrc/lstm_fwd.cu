// Masked LSTM recurrence, forward: the Hopper port of the TPU kernel
// dasa_tpu/ops/lstm.py:_fwd_kernel (reached through _fwd_call / lstm_scan).
//
// What it computes, per direction d of one or two independent recurrences:
//   gates_t = xw_t + bf16(h_{t-1}) . Wh   (f32 accumulate; order i,f,g,o)
//   c' = sig(f) c + sig(i) tanh(g);  h' = sig(o) tanh(c')
//   (h, c) = m_t (h', c') + (1 - m_t) (h, c)        carry in f32
//   h_seq[t], c_seq[t] = bf16(h), bf16(c)          (post-mask carry)
//   acts[t] = bf16(sig(i), sig(f), tanh(g), sig(o))  (optional)
// The gate activations are the TPU kernel's act_out: the backward kernel
// (lstm_bwd.cu) consumes them.  A null acts pointer (evaluation) skips
// them.  The two directions of the DicEncoder's top BiLSTM are two such
// recurrences; the TPU package runs them as two calls only because both
// directions' weights would not fit its VMEM (dasa_tpu/models/layers.py:
// 170-172).  Here one launch runs both, each direction on its own CTAs.
//
// What bounds it on an H100: the T tokens are strictly sequential, and
// every token needs all of Wh (H x 4H bf16 = 8 MiB at H = 1024), which no
// single SM's shared memory holds.  At the headline shape (T 80, B 20,
// H 1024) one direction needs 13.4 GFLOP and ~28 MB, a bound of ~14 us
// (0.17 us a token); what decides the time is the per-token exchange:
// every CTA's slice of h_t must reach every other CTA of its direction
// before token t + 1 can start, and then the product on that row.
//
// Design: one cooperative persistent launch.  CTA k of direction d owns U
// hidden units (U = 8, or 16 when both directions share the card: 128
// CTAs either way) and keeps their 4U gate rows of Wh^T in shared memory
// for all tokens.  Per token:
//   1. Each CTA writes its slice of bf16(h_t) to an exchange copy (xr),
//      whose rows have their 16-byte groups swizzled for ldmatrix, and
//      announces it: one fence.acq_rel.gpu and one red.relaxed.gpu on its
//      direction's counter.
//   2. A producer warp waits for the counter to reach every CTA of the
//      direction, then brings the whole B x H row into shared memory with
//      ONE cp.async.bulk (40 KiB at B = 20) on a full / empty mbarrier
//      pair.
//   3. Eight consumer warps form the gates on the tensor cores
//      (mma.sync.m16n8k16 from fixed per-lane ldmatrix offsets, the batch
//      on M in two m16 tiles, 16 gate rows per warp on N, the k range
//      split over the warps), sum the k ranges in shared memory and run
//      the cell update for the CTA's units with the fast exp.
//   4. xw[t + 1]'s B x 4U slice is prefetched by cp.async while the next
//      row is awaited, and the whole mask sits in shared memory, so the
//      cell update reads shared memory only; h_seq, c_seq and acts are
//      stored after the announcement, off the chain.
// Measured on the H100 (chip_smoke.py phase 2, intermediate versions;
// PERF.md): fetching the row as 8 chunks of 128 columns, each one bulk
// copy behind its own readiness counter and consumed as it landed (K2's
// exchange), spent ~950 SM cycles a chunk one after another (6.2 us a
// token); one counter and ONE copy of the row take ~900 cycles in all.
// The batch on M (B padded to 32) beat the gate rows on M with the batch
// on N (25% fewer MACs, more ldmatrix) by 4-8%, and Wh fragments held in
// registers spilled and lost.
//
// Batches of 33-64 rows (the stream regime's 2B slots): the h row grows
// to the batch's m16 tiles, which leaves no room for both directions'
// weights, so each direction takes its own launch of 128 CTAs of 8 units,
// one after the other on the stream (dasa_lstm_fwd loops over them).  At
// B = 49-64 the k groups' partial sums do not fit beside the row and go
// inside it: the row is dead between the product and the announcement
// (the next row lands only after this CTA has announced), so the sums
// take it after one more barrier, and a proxy fence orders them before
// the next bulk copy.  Batches of at most 32 rows run as above.
//
// Every CTA must be resident at once, or the exchange deadlocks: the
// launch is cooperative, which the driver refuses for a grid that cannot
// be resident (ops/lstm.py:fwd_plan first checks the CTAs against the SMs
// and the shared memory against a block's limit).  A wait that never ends
// traps (hopper.cuh: spin_guard) instead of hanging the card.

#include "common.cuh"
#include "hopper.cuh"

using dasa::bf16;

namespace {

constexpr int kConsumerWarps = 8;
constexpr int kConsumers = kConsumerWarps * 32;
constexpr int kThreads = kConsumers + 32;  // + one producer warp
constexpr int kPad = 8;                    // bf16 elements of row padding
constexpr int kMaxB = 64;                  // four m16 tiles of batch rows
constexpr int kPairMaxB = 32;              // both directions in one launch
constexpr int kMaxItems = 2;               // (b, u) per thread: B U <= 512
constexpr int kMaxSmem = 232448;           // dynamic shared memory a block
constexpr int kCounterStride = 32;         // u32 between the counters

struct Layout {
  size_t ws, hb, xwp, mask, red, bars, total;
  bool alias;  // the partial sums inside the h row
};

// U units per CTA; the h row holds 32 batch rows, or the batch's m16 tiles
__host__ __device__ inline Layout fwd_layout(int T, int B, int H, int U) {
  const size_t ldw = H + kPad;
  const size_t kg = 32 / U;  // k groups: 8 warps over U / 4 gate blocks
  const size_t rows = B <= kPairMaxB ? kPairMaxB : (B + 15) / 16 * 16;
  const size_t red = kg * B * (4 * U + 4) * sizeof(float);
  Layout l;
  l.ws = 0;
  l.hb = dasa::align_up(l.ws + 4 * U * ldw * sizeof(bf16), 128);
  l.xwp = dasa::align_up(l.hb + rows * H * sizeof(bf16), 128);
  l.mask = dasa::align_up(l.xwp + 2 * B * 4 * U * sizeof(bf16), 128);
  l.red = dasa::align_up(l.mask + (size_t)T * B * sizeof(bf16), 128);
  l.bars = dasa::align_up(l.red + red, 128);
  l.total = dasa::align_up(l.bars + 2 * sizeof(uint64_t), 128);
  l.alias = l.total > (size_t)kMaxSmem && red <= rows * H * sizeof(bf16);
  if (l.alias) {
    l.bars = l.red;
    l.red = l.hb;
    l.total = dasa::align_up(l.bars + 2 * sizeof(uint64_t), 128);
  }
  return l;
}

struct FwdArgs {
  const bf16* xw;    // (dirs, T, B, 4H)
  const bf16* mask;  // (dirs, T, B)
  const bf16* h0;    // (dirs, B, H)
  const bf16* c0;    // (dirs, B, H)
  const bf16* wt0;   // (4H, H) = Wh^T of direction 0
  const bf16* wt1;   // of direction 1 (two-direction launches)
  bf16* h_seq;       // (dirs, T, B, H)
  bf16* c_seq;       // (dirs, T, B, H)
  bf16* acts;        // (dirs, T, B, 4H) or null
  bf16* xr;          // (dirs, T + 1, B, H): the exchange copy, swizzled
  uint32_t* ready;   // (dirs) counters, kCounterStride apart
  int T, B, H;
  int d0;            // the launch's first direction
};

// sigmoid and tanh from the fast exp: bf16 outputs, f32 carry
__device__ __forceinline__ float fsig(float x) {
  return __fdividef(1.0f, 1.0f + __expf(-x));
}
__device__ __forceinline__ float ftanh(float x) {
  return 2.0f * fsig(2.0f * x) - 1.0f;
}

// MT blocks of 16 gate rows (U = 4 MT units), at most MB m16 tiles of
// batch rows
template <int MT, int MB>
__global__ void __launch_bounds__(kThreads, 1) lstm_fwd_kernel(FwdArgs a) {
  constexpr int U = 4 * MT;
  constexpr int KG = kConsumerWarps / MT;
  constexpr int NJ = 4 * U + 4;  // row stride of the partial sums
  extern __shared__ __align__(128) unsigned char smem[];
  const int T = a.T, B = a.B, H = a.H;
  const Layout l = fwd_layout(T, B, H, U);
  bf16* ws = reinterpret_cast<bf16*>(smem + l.ws);      // [4U][ldw]
  bf16* hb = reinterpret_cast<bf16*>(smem + l.hb);      // [rows][H]
  bf16* xwp = reinterpret_cast<bf16*>(smem + l.xwp);    // [2][B][4U]
  bf16* msk = reinterpret_cast<bf16*>(smem + l.mask);   // [T][B]
  float* red = reinterpret_cast<float*>(smem + l.red);  // [KG][B][NJ]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + l.bars);
  uint64_t* empty = full + 1;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = 4 * H;
  const int ldw = H + kPad;
  const int ctas_dir = H / U;
  const int d = a.d0 + blockIdx.x / ctas_dir;
  const int u0 = (blockIdx.x % ctas_dir) * U;
  const uint32_t row_bytes = B * H * sizeof(bf16);
  const bf16* wt = d == 0 ? a.wt0 : a.wt1;
  const bf16* xw = a.xw + (size_t)d * T * B * G;
  const bf16* mask = a.mask + (size_t)d * T * B;
  bf16* xr = a.xr + (size_t)d * (T + 1) * B * H;
  uint32_t* ready = a.ready + d * kCounterStride;

  // resident weights: row j = gate j / U of unit u0 + j % U
  const int vrow = H / 8;
  for (int idx = tid; idx < 4 * U * vrow; idx += kThreads) {
    const int j = idx / vrow, v = idx % vrow;
    const size_t src = (size_t)((j / U) * H + u0 + j % U) * H;
    reinterpret_cast<uint4*>(ws + (size_t)j * ldw)[v] =
        reinterpret_cast<const uint4*>(wt + src)[v];
  }
  for (int i = tid; i < T * B; i += kThreads) msk[i] = mask[i];
  if (tid == 0) {
    dasa::mbar_init(full, 1);
    dasa::mbar_init(empty, kConsumerWarps);
    dasa::fence_barrier_init();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // ---------------------------------------------------------- producer
    // slot t of xr (h_{t-1}, or h0) feeds token t: once every CTA of the
    // direction has written its slice, ONE bulk copy brings the row
    if (lane == 0) {
      for (int t = 0; t < T; ++t) {
        const uint32_t target = (uint32_t)ctas_dir * (t + 1);
        const long long start = clock64();
        while (dasa::ld_acquire_gpu(ready) < target) dasa::spin_guard(start);
        dasa::fence_proxy_async_global();  // the copy reads what we acquired
        if (t > 0) dasa::mbar_wait(empty, (t - 1) & 1);
        dasa::mbar_expect_tx(full, row_bytes);
        dasa::bulk_load(hb, xr + (size_t)t * B * H, row_bytes, full);
      }
    }
    return;
  }

  // ----------------------------------------------------------- consumers
  // the exchange copy: slot s, row b, column k of h; the 16-byte groups of
  // row b swizzled by b % 8 so that ldmatrix reads them without bank
  // conflicts
  auto xr_at = [&](int s, int b, int k) -> bf16* {
    return xr + ((size_t)s * B + b) * H +
           ((((k >> 3) ^ (b & 7)) << 3) | (k & 7));
  };
  auto announce = [&]() {
    dasa::fence_proxy_async_global();  // xr is read back by bulk copies
    dasa::named_barrier(1, kConsumers);
    if (tid == 0) {
      dasa::fence_acq_rel_gpu();
      dasa::red_relaxed_gpu(ready, 1);
    }
  };
  // xw[t]'s slice of this CTA: per batch row the 4 gates' U units
  auto prefetch = [&](int t, int buf) {
    constexpr int per_row = 4 * U / 8;  // 16-byte vectors
    for (int i = tid; i < B * per_row; i += kConsumers) {
      const int b = i / per_row, q = (i % per_row) / (U / 8),
                p = i % (U / 8);
      dasa::cp_async16(xwp + ((size_t)buf * B + b) * 4 * U + q * U + p * 8,
                       xw + ((size_t)t * B + b) * G + q * H + u0 + p * 8);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  float hs[kMaxItems], cs[kMaxItems];
#pragma unroll
  for (int it = 0; it < kMaxItems; ++it) {
    const int i = tid + it * kConsumers;
    if (i >= B * U) break;
    const int b = i / U, u = i % U;
    const bf16 h0 = a.h0[((size_t)d * B + b) * H + u0 + u];
    hs[it] = dasa::to_f(h0);
    cs[it] = dasa::to_f(a.c0[((size_t)d * B + b) * H + u0 + u]);
    *xr_at(0, b, u0 + u) = h0;
  }
  announce();
  prefetch(0, 0);

  // Warp w: gate block mw (16 gate rows, two n8 tiles), k group kg (the
  // kg-th of KG equal ranges of k16 steps).  Fixed per-lane ldmatrix
  // addresses: B = two n8 tiles of Wh rows; A = h rows b = lane % 16 (+ 16 m),
  // whose 16-byte group 2 k + hi sits at (2 k + hi) ^ (b % 8)
  const int mw = warp % MT, kg = warp / MT;
  const int ksteps = H / 16 / KG;
  const int k0 = kg * ksteps;
  const int mtb = (B + 15) / 16;
  const uint32_t w_lane = dasa::smem_u32(ws) +
                          (mw * 16 + lane % 8 + 8 * (lane / 16)) * ldw * 2 +
                          ((lane / 8) % 2) * 16 + k0 * 32;
  const uint32_t h_lane = dasa::smem_u32(hb) + (lane % 16) * H * 2;
  const int hi = lane / 16, r8 = lane % 8;

  for (int t = 0; t < T; ++t) {
    const int buf = t & 1;
    // gates[b, j] = h[b, :] . Wh^T[j, :] for this warp's k range
    float acc[MB][2][4];
#pragma unroll
    for (int m = 0; m < MB; ++m)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.0f;
    dasa::mbar_wait(full, t & 1);
#pragma unroll 4
    for (int k = k0; k < k0 + ksteps; ++k) {
      uint32_t wb[4], ha[MB][4];
      dasa::ldmatrix_x4(wb, w_lane + (k - k0) * 32);
#pragma unroll
      for (int m = 0; m < MB; ++m)
        if (m < mtb)
          dasa::ldmatrix_x4(ha[m], h_lane + m * 16 * H * 2 +
                                       (((2 * k + hi) ^ r8) << 4));
#pragma unroll
      for (int m = 0; m < MB; ++m) {
        if (m < mtb) {
          dasa::mma_16816(acc[m][0], ha[m], wb);
          dasa::mma_16816(acc[m][1], ha[m], wb + 2);
        }
      }
    }
    __syncwarp();
    if (lane == 0) dasa::mbar_arrive(empty);
    // the sums overwrite the row: every warp's product must be done
    if (l.alias) dasa::named_barrier(1, kConsumers);

    // the k groups' partial sums: red[kg][b][j], j = gate row q U + u;
    // acc[m][n]: batch rows 16 m + lane / 4 (+ 8), gate rows of n8 tile n
    float* rw = red + (size_t)kg * B * NJ;
#pragma unroll
    for (int m = 0; m < MB; ++m) {
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int b = 16 * m + lane / 4 + 8 * (e / 2);
          const int j = mw * 16 + 8 * n + 2 * (lane % 4) + (e % 2);
          if (b < B) rw[b * NJ + j] = acc[m][n][e];
        }
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    dasa::named_barrier(1, kConsumers);

    // the cell update of this CTA's (b, u) items
    const bf16* xp = xwp + (size_t)buf * B * 4 * U;
    float gv[kMaxItems][4];
#pragma unroll
    for (int it = 0; it < kMaxItems; ++it) {
      const int i = tid + it * kConsumers;
      if (i >= B * U) break;
      const int b = i / U, u = i % U;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float s = dasa::to_f(xp[b * 4 * U + q * U + u]);
#pragma unroll
        for (int k = 0; k < KG; ++k)
          s += red[((size_t)k * B + b) * NJ + q * U + u];
        gv[it][q] = s;
      }
      const float ig = fsig(gv[it][0]);
      const float fg = fsig(gv[it][1]);
      const float gg = ftanh(gv[it][2]);
      const float og = fsig(gv[it][3]);
      const float c_new = fg * cs[it] + ig * gg;
      const float h_new = og * ftanh(c_new);
      const float m = dasa::to_f(msk[t * B + b]);
      hs[it] = m * h_new + (1.0f - m) * hs[it];
      cs[it] = m * c_new + (1.0f - m) * cs[it];
      gv[it][0] = ig;
      gv[it][1] = fg;
      gv[it][2] = gg;
      gv[it][3] = og;
      if (t + 1 < T) *xr_at(t + 1, b, u0 + u) = dasa::to_bf(hs[it]);
    }
    // the next bulk copy rewrites the row the sums were read from
    if (l.alias) dasa::fence_proxy_async_shared();
    if (t + 1 < T) announce();

    // outputs, off the chain
#pragma unroll
    for (int it = 0; it < kMaxItems; ++it) {
      const int i = tid + it * kConsumers;
      if (i >= B * U) break;
      const int b = i / U, u = i % U;
      const size_t o = (((size_t)d * T + t) * B + b) * H + u0 + u;
      a.h_seq[o] = dasa::to_bf(hs[it]);
      a.c_seq[o] = dasa::to_bf(cs[it]);
      if (a.acts != nullptr) {
        bf16* ap = a.acts + (((size_t)d * T + t) * B + b) * G + u0 + u;
#pragma unroll
        for (int q = 0; q < 4; ++q) ap[q * H] = dasa::to_bf(gv[it][q]);
      }
    }
    if (t + 1 < T) prefetch(t + 1, buf ^ 1);
  }
}

template <int MT, int MB>
cudaError_t launch(const FwdArgs& a, int ctas, size_t smem, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      lstm_fwd_kernel<MT, MB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, lstm_fwd_kernel<MT, MB>, a);
}

}  // namespace

// Shared memory of one CTA; ops/lstm.py:fwd_plan mirrors it.
extern "C" int dasa_lstm_fwd_smem(int T, int B, int H, int U) {
  return static_cast<int>(fwd_layout(T, B, H, U).total);
}

extern "C" int dasa_lstm_fwd(const void* xw, const void* mask, const void* h0,
                             const void* c0, const void* wt0, const void* wt1,
                             void* h_seq, void* c_seq, void* acts, void* xr,
                             void* ready, int T, int B, int H, int U,
                             int dirs, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || B > kMaxB || (U != 8 && U != 16) || H % 64 || dirs < 1 ||
      dirs > 2 || (B > kPairMaxB && U != 8))
    return cudaErrorInvalidValue;
  const size_t smem = fwd_layout(T, B, H, U).total;
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t e =
      cudaMemsetAsync(ready, 0, dirs * kCounterStride * sizeof(uint32_t), s);
  if (e != cudaSuccess) return e;
  FwdArgs a;
  a.xw = static_cast<const bf16*>(xw);
  a.mask = static_cast<const bf16*>(mask);
  a.h0 = static_cast<const bf16*>(h0);
  a.c0 = static_cast<const bf16*>(c0);
  a.wt0 = static_cast<const bf16*>(wt0);
  a.wt1 = static_cast<const bf16*>(dirs == 2 ? wt1 : wt0);
  a.h_seq = static_cast<bf16*>(h_seq);
  a.c_seq = static_cast<bf16*>(c_seq);
  a.acts = static_cast<bf16*>(acts);
  a.xr = static_cast<bf16*>(xr);
  a.ready = static_cast<uint32_t*>(ready);
  a.T = T;
  a.B = B;
  a.H = H;
  // both directions in one launch, or (B > kPairMaxB) one launch each
  const int per_launch = B <= kPairMaxB ? dirs : 1;
  const int ctas = per_launch * H / U;
  for (a.d0 = 0; a.d0 < dirs; a.d0 += per_launch) {
    if (B > kPairMaxB)
      e = launch<2, 4>(a, ctas, smem, s);
    else
      e = U == 8 ? launch<2, 2>(a, ctas, smem, s)
                 : launch<4, 2>(a, ctas, smem, s);
    if (e != cudaSuccess) return e;
  }
  return cudaGetLastError();
}
