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
// What bounds it on an H100: a chain of T dependent tokens.  At the
// headline shape (T 80, B 20, H 1024) the call needs 13.4 GFLOP and moves
// ~45 MB, a bound of ~14 us (0.17 us a token); what decides the time is
// the per-token exchange: every token, each CTA's dgates (B x 4U) must
// reach every other CTA (the whole B x 4H row, 160 KiB at B = 20) before
// the next token can start, and the product on that row.
//
// Design: one cooperative persistent launch; CTA k owns U = 8 hidden units
// (128 CTAs at H = 1024), keeps their rows of Wh (8 x 4H bf16, 64 KiB) in
// shared memory for all tokens, and keeps the dh / dc carries of its
// units.  Per token eight consumer warps compute the CTA's dgates (step
// 1), write them to dxw[t] and to an exchange copy of the row (xr), and
// announce them; a producer warp brings the row back in 512-column chunks
// through a ring of shared-memory stages (full / empty mbarriers), and the
// consumers form dh_prev for their units on the tensor cores as the chunks
// land.  xr is laid out chunk by chunk, each chunk one contiguous B x kc
// block whose 16-byte groups are already swizzled for ldmatrix, so a chunk
// is ONE cp.async.bulk (fetching 128-byte rows of dxw itself, 160 copies a
// chunk at ~40 ns each, was 4x slower).  Against a grid-barrier design:
//   1. Prefetch: step 1's chain-independent inputs (acts, c_prev, g_h, g_c
//      of this CTA's units: 7 B 16-byte vectors) for token t-1 go out by
//      cp.async while token t's product runs, and every token's mask sits
//      in shared memory; step 1 reads shared memory only.
//   2. Per-chunk readiness instead of a grid barrier: a chunk is written
//      by kc / U (CTA, gate) pieces; each CTA adds one to the counter of
//      each chunk it wrote (one fence.acq_rel.gpu, then four
//      red.relaxed.gpu); lane c of the producer warp watches chunk c's
//      counter (ld.acquire.gpu, all lanes in one round trip), and a chunk
//      is fetched as soon as its writers are done.  (A flag per CTA, read
//      by every poller, measured slower.)
// On the H100 (chip_smoke.py phase 2 of intermediate versions, PERF.md)
// prefetch took ~0.75 us off a token of ~8.7 us and per-chunk readiness
// 0.07-0.13 us.  Measured and dropped: thread-block clusters of 2 (the
// most cudaOccupancyMaxActiveClusters placed for 128 CTAs of this shared
// memory) multicasting each chunk, 0.01-0.09 us a token, within the spread
// between runs: the L2 re-read of the row is not what bounds a token.
// The product stays in the batch-as-M layout, as mma.sync.m16n8k16 with
// ldmatrix from fixed per-lane offsets (fragments of a chunk loaded first,
// then the products): with U = 8 units as N = 8, B = 20 pads to 32 rows
// (two m16 tiles), 256 MACs per k.  Putting the batch on N (3 n8 tiles, 4
// rows of waste) would need the units on M = 16, half of it padding: 384
// MACs per k, 1.5x the work.  Each warp takes every 8th k16 step of a
// chunk; the eight partial sums meet in shared memory once per token.
//
// Every CTA must be resident at once, or the exchange deadlocks: the
// launch is cooperative, which the driver refuses for a grid that cannot
// be resident (ops/lstm.py:bwd_plan first checks the CTAs against the SMs
// and the shared memory against a block's limit).  A wait that never ends
// traps (hopper.cuh: spin_guard) instead of hanging the card.

#include "common.cuh"
#include "hopper.cuh"

using dasa::bf16;

namespace {

constexpr int kUnits = 8;            // hidden units per CTA
constexpr int kConsumerWarps = 8;
constexpr int kConsumers = kConsumerWarps * 32;
constexpr int kThreads = kConsumers + 32;  // + one producer warp
constexpr int kPad = 8;              // bf16 elements of row padding
constexpr int kMaxMTiles = 4;        // B <= 64
constexpr int kItems = kMaxMTiles * 16 * kUnits / kConsumers;  // (b, u) each
constexpr int kMaxJ = 512 / 16 / kConsumerWarps;  // k16 steps a warp, kc<=512
constexpr int kCounterStride = 32;   // u32 between chunk counters (128 B)

struct Layout {
  size_t ws, ring, pre, mask, dh, dc, dhm, red, bars, total;
};

// kc gate columns per chunk, `stages` chunks in the ring
__host__ __device__ inline Layout bwd_layout(int T, int B, int H, int kc,
                                             int stages) {
  const size_t ldw = 4 * (size_t)H + kPad;
  const size_t mt = (B + 15) / 16;
  Layout l;
  l.ws = 0;
  l.ring = dasa::align_up(l.ws + kUnits * ldw * sizeof(bf16), 128);
  l.pre = dasa::align_up(l.ring + (size_t)stages * B * kc * sizeof(bf16),
                         128);
  l.mask = dasa::align_up(l.pre + 2 * 7 * B * sizeof(uint4), 128);
  l.dh = dasa::align_up(l.mask + (size_t)T * B * sizeof(bf16), 128);
  l.dc = dasa::align_up(l.dh + B * kUnits * sizeof(float), 128);
  l.dhm = dasa::align_up(l.dc + B * kUnits * sizeof(float), 128);
  l.red = dasa::align_up(l.dhm + B * kUnits * sizeof(float), 128);
  l.bars = dasa::align_up(
      l.red + kConsumerWarps * mt * 16 * kUnits * sizeof(float), 128);
  l.total = dasa::align_up(l.bars + 2 * stages * sizeof(uint64_t), 128);
  return l;
}

__global__ void __launch_bounds__(kThreads, 1)
lstm_bwd_kernel(const bf16* __restrict__ acts,    // (T, B, 4H)
                const bf16* __restrict__ c_prev,  // (T, B, H)
                const bf16* __restrict__ g_h,     // (T, B, H)
                const bf16* __restrict__ g_c,     // (T, B, H)
                const bf16* __restrict__ mask,    // (T, B)
                const bf16* __restrict__ wt,      // (4H, H) = Wh^T
                bf16* dxw,                        // (T, B, 4H)
                bf16* xr,                         // (T, 4H / kc, B, kc)
                float* dh0, float* dc0,           // (B, H)
                uint32_t* ready,                  // a counter per chunk
                int T, int B, int H, int kc, int stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout l = bwd_layout(T, B, H, kc, stages);
  bf16* ws = reinterpret_cast<bf16*>(smem + l.ws);      // [U][ldw]
  bf16* ring = reinterpret_cast<bf16*>(smem + l.ring);  // [stages][B][kc]
  uint4* pre = reinterpret_cast<uint4*>(smem + l.pre);  // [2][7 B]
  bf16* msk = reinterpret_cast<bf16*>(smem + l.mask);   // [T][B]
  float* dh_s = reinterpret_cast<float*>(smem + l.dh);  // [B][U]
  float* dc_s = reinterpret_cast<float*>(smem + l.dc);  // [B][U]
  float* dhm = reinterpret_cast<float*>(smem + l.dhm);  // [B][U]
  float* red = reinterpret_cast<float*>(smem + l.red);  // [warps][mt 16][U]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + l.bars);
  uint64_t* empty = full + stages;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = 4 * H;
  const int ldw = G + kPad;
  const int mt = (B + 15) / 16;
  const int u0 = blockIdx.x * kUnits;
  const int nchunks = G / kc;
  const uint32_t need = kc / kUnits;  // (CTA, gate) pieces of a chunk

  // resident weights: ws[u][j] = Wh[u0 + u][j] = wt[j][u0 + u]; the 8
  // units of one gate column are one 16-byte vector
  for (int j = tid; j < G; j += kThreads) {
    const uint4 v = *reinterpret_cast<const uint4*>(wt + (size_t)j * H + u0);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int u = 0; u < kUnits; ++u) ws[(size_t)u * ldw + j] = e[u];
  }
  for (int i = tid; i < T * B; i += kThreads) msk[i] = mask[i];
  for (int i = tid; i < B * kUnits; i += kThreads) {
    dh_s[i] = 0.0f;
    dc_s[i] = 0.0f;
  }
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      dasa::mbar_init(&full[s], 1);
      dasa::mbar_init(&empty[s], kConsumerWarps);  // each consumer warp
    }
    dasa::fence_barrier_init();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // ---------------------------------------------------------- producer
    // chunk c of token t is one contiguous block of xr: one bulk copy
    for (int s = 0; s < T; ++s) {
      const int t = T - 1 - s;
      const uint32_t target = need * (s + 1);
      // lane c watches chunk c's counter: one poll round costs one L2
      // round trip whatever the number of chunks
      uint32_t seen = 0, fenced = 0;
      const long long start = clock64();
      auto poll = [&]() {
        const bool ok =
            lane < nchunks &&
            (((seen >> lane) & 1) ||
             dasa::ld_acquire_gpu(ready + lane * kCounterStride) >= target);
        seen = __ballot_sync(~0u, ok);
        __syncwarp();  // lane c's acquire before lane 0's copy of chunk c
        dasa::spin_guard(start);
      };
      for (int c = 0; c < nchunks; ++c) {
        while (!((seen >> c) & 1)) poll();
        if (lane == 0) {
          // the copies read what the poll rounds so far acquired
          if (!((fenced >> c) & 1)) dasa::fence_proxy_async_global();
          const int gidx = s * nchunks + c;
          const int st = gidx % stages;
          const int round = gidx / stages;
          if (round > 0) dasa::mbar_wait(&empty[st], (round - 1) & 1);
          dasa::mbar_expect_tx(&full[st], B * kc * sizeof(bf16));
          dasa::bulk_load(ring + (size_t)st * B * kc,
                          xr + ((size_t)t * nchunks + c) * B * kc,
                          B * kc * sizeof(bf16), &full[st]);
        }
        fenced = seen;
        __syncwarp();
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    // step 1's inputs of token t into prefetch buffer `buf`: per batch row
    // the 4 gates' 8 units of acts, then c_prev, g_h and g_c (16 B each)
    auto prefetch = [&](int t, int buf) {
      uint4* dst = pre + buf * 7 * B;
      for (int i = tid; i < 7 * B; i += kConsumers) {
        const bf16* src;
        if (i < 4 * B) {
          src = acts + ((size_t)t * B + i / 4) * G + (i % 4) * H + u0;
        } else {
          const int kind = i / B - 4, b = i % B;
          const bf16* base = kind == 0 ? c_prev : kind == 1 ? g_h : g_c;
          src = base + ((size_t)t * B + b) * H + u0;
        }
        dasa::cp_async16(dst + i, src);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    };
    prefetch(T - 1, 0);
    // ldmatrix row addresses.  Warp w takes the k16 steps w + 8 j of a
    // chunk, so the 16-byte group of its A rows is (2 w + 16 j + lane / 16)
    // ^ (row % 8) = 16 j + ((2 w + lane / 16) ^ (row % 8)) (the xor only
    // reaches the low 3 bits): a fixed lane offset plus 256 j bytes.  Rows
    // past B read row B - 1; their products are never used.
    const uint32_t stage_bytes = B * kc * 2;
    const uint32_t ring_u32 = dasa::smem_u32(ring);
    uint32_t a_lane[kMaxMTiles];
#pragma unroll
    for (int m = 0; m < kMaxMTiles; ++m) {
      const int row = min(m * 16 + lane % 16, B - 1);
      const int grp = (2 * warp + lane / 16) ^ (row & 7);
      a_lane[m] = row * kc * 2 + grp * 16;
    }
    // B (Wh) rows: unit lane % 8, k half (lane / 8) % 2
    const uint32_t ws_lane = dasa::smem_u32(ws) + (lane % 8) * ldw * 2 +
                             (16 * warp + 8 * ((lane / 8) % 2)) * 2;
    int st = 0;          // ring stage of the next chunk
    uint32_t parity = 0;  // its full barrier's phase parity

    for (int s = 0; s < T; ++s) {
      const int t = T - 1 - s;
      const int buf = s & 1;
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      dasa::named_barrier(1, kConsumers);

      // 1. the dgates of this CTA's units, from the f32 carries
      const bf16* pb = reinterpret_cast<const bf16*>(pre + buf * 7 * B);
      bf16 dgs[kItems][4];  // this thread's dgates, stored to dxw later
#pragma unroll
      for (int it = 0; it < kItems; ++it) {
        const int i = tid + it * kConsumers;
        if (i >= B * kUnits) break;
        const int b = i / kUnits, u = i % kUnits;
        const bf16* a = pb + b * 4 * kUnits + u;
        const float ig = dasa::to_f(a[0]);
        const float fg = dasa::to_f(a[kUnits]);
        const float gg = dasa::to_f(a[2 * kUnits]);
        const float og = dasa::to_f(a[3 * kUnits]);
        const float cp = dasa::to_f(pb[(4 * B + b) * kUnits + u]);
        const float m = dasa::to_f(msk[t * B + b]);
        const float dh = dh_s[i] + dasa::to_f(pb[(5 * B + b) * kUnits + u]);
        const float dc = dc_s[i] + dasa::to_f(pb[(6 * B + b) * kUnits + u]);
        const float dh_new = m * dh;
        const float tc = tanhf(fg * cp + ig * gg);
        const float dcn = m * dc + dh_new * og * (1.0f - tc * tc);
        bf16* dg = dgs[it];
        dg[0] = dasa::to_bf(dcn * gg * ig * (1.0f - ig));
        dg[1] = dasa::to_bf(dcn * cp * fg * (1.0f - fg));
        dg[2] = dasa::to_bf(dcn * ig * (1.0f - gg * gg));
        dg[3] = dasa::to_bf(dh_new * tc * og * (1.0f - og));
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          // the exchange copy: chunk-contiguous, with the 16-byte groups
          // of row b swizzled by b % 8 so that ldmatrix reads them without
          // bank conflicts
          const int col = q * H + u0 + u;
          const int cc = col % kc;
          xr[(((size_t)t * nchunks + col / kc) * B + b) * kc +
             ((((cc >> 3) ^ (b & 7)) << 3) | (cc & 7))] = dg[q];
        }
        dhm[i] = (1.0f - m) * dh;
        dc_s[i] = (1.0f - m) * dc + dcn * fg;
      }
      // the exchange copy is read back by bulk copies (the async proxy)
      dasa::fence_proxy_async_global();
      dasa::named_barrier(1, kConsumers);
      if (tid == 0) {
        dasa::fence_acq_rel_gpu();  // one fence for the four counters
        for (int q = 0; q < 4; ++q)
          dasa::red_relaxed_gpu(ready + ((q * H + u0) / kc) * kCounterStride,
                                1);
      }
      // dxw itself is only output: stored after the announcement, off the
      // chain
#pragma unroll
      for (int it = 0; it < kItems; ++it) {
        const int i = tid + it * kConsumers;
        if (i >= B * kUnits) break;
        bf16* d = dxw + ((size_t)t * B + i / kUnits) * G + u0 + i % kUnits;
#pragma unroll
        for (int q = 0; q < 4; ++q) d[q * H] = dgs[it][q];
      }
      if (s + 1 < T) prefetch(t - 1, buf ^ 1);

      // 2. dh_prev = dxw[t] . Wh[units]^T, chunk by chunk as they arrive
      float acc[kMaxMTiles][4];
#pragma unroll
      for (int m = 0; m < kMaxMTiles; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][e] = 0.0f;
      for (int c = 0; c < nchunks; ++c) {
        dasa::mbar_wait(&full[st], parity);
        const uint32_t a_base = ring_u32 + st * stage_bytes;
        const uint32_t b_base = ws_lane + c * kc * 2;
        // every fragment of the chunk first, so that the loads are in
        // flight together, then the products
        uint32_t bfrag[kMaxJ][2], afrag[kMaxJ][kMaxMTiles][4];
#pragma unroll
        for (int j = 0; j < kMaxJ; ++j) {
          if (warp + kConsumerWarps * j < kc / 16) {
            dasa::ldmatrix_x2(bfrag[j], b_base + 256 * j);
#pragma unroll
            for (int m = 0; m < kMaxMTiles; ++m)
              if (m < mt)
                dasa::ldmatrix_x4(afrag[j][m], a_base + a_lane[m] + 256 * j);
          }
        }
#pragma unroll
        for (int j = 0; j < kMaxJ; ++j) {
          if (warp + kConsumerWarps * j < kc / 16) {
#pragma unroll
            for (int m = 0; m < kMaxMTiles; ++m)
              if (m < mt) dasa::mma_16816(acc[m], afrag[j][m], bfrag[j]);
          }
        }
        __syncwarp();
        if (lane == 0) dasa::mbar_arrive(&empty[st]);
        if (++st == stages) {
          st = 0;
          parity ^= 1;
        }
      }
      // the eight warps' partial sums: acc[m][2 h + e] is row
      // 16 m + lane / 4 + 8 h, unit 2 (lane % 4) + e
      float* rw = red + (size_t)warp * mt * 16 * kUnits;
#pragma unroll
      for (int m = 0; m < kMaxMTiles; ++m) {
        if (m < mt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = 16 * m + lane / 4 + 8 * h;
            rw[row * kUnits + 2 * (lane % 4)] = acc[m][2 * h];
            rw[row * kUnits + 2 * (lane % 4) + 1] = acc[m][2 * h + 1];
          }
        }
      }
      dasa::named_barrier(1, kConsumers);
      // each thread keeps the (b, u) entries it owns in step 1
      for (int i = tid; i < B * kUnits; i += kConsumers) {
        float sum = 0.0f;
        for (int w = 0; w < kConsumerWarps; ++w)
          sum += red[(size_t)w * mt * 16 * kUnits + i];
        dh_s[i] = dhm[i] + sum;
      }
    }
    for (int i = tid; i < B * kUnits; i += kConsumers) {
      const int b = i / kUnits, u = i % kUnits;
      dh0[(size_t)b * H + u0 + u] = dh_s[i];
      dc0[(size_t)b * H + u0 + u] = dc_s[i];
    }
  }
}

}  // namespace

// Shared memory of one CTA; ops/lstm.py:bwd_plan mirrors it.
extern "C" int dasa_lstm_bwd_smem(int T, int B, int H, int kc, int stages) {
  return static_cast<int>(bwd_layout(T, B, H, kc, stages).total);
}

extern "C" int dasa_lstm_bwd(const void* acts, const void* c_prev,
                             const void* g_h, const void* g_c,
                             const void* mask, const void* wt, void* dxw,
                             void* xr, void* dh0, void* dc0, void* ready,
                             int T, int B, int H, int kc, int stages,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = bwd_layout(T, B, H, kc, stages).total;
  cudaError_t e = cudaFuncSetAttribute(
      lstm_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  e = cudaMemsetAsync(ready, 0,
                      (size_t)(4 * H / kc) * kCounterStride * sizeof(uint32_t),
                      s);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(H / kUnits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(
      &cfg, lstm_bwd_kernel, static_cast<const bf16*>(acts),
      static_cast<const bf16*>(c_prev), static_cast<const bf16*>(g_h),
      static_cast<const bf16*>(g_c), static_cast<const bf16*>(mask),
      static_cast<const bf16*>(wt), static_cast<bf16*>(dxw),
      static_cast<bf16*>(xr), static_cast<float*>(dh0), static_cast<float*>(dc0),
      static_cast<uint32_t*>(ready), T, B, H, kc, stages);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}
