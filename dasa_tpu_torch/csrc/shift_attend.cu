// Shift attention over the 36-view panorama: the Hopper port of the TPU
// kernel dasa_tpu/ops/shift_attention.py:_kernel_body (reached through
// shift_attend).
//
// What it computes, per batch row b (h: B x H, ctx: B x T x C, T = 3 * 12):
//   target = h W_in                      (f32 accumulate)
//   logit[t] = ctx[t] . target           (f32, returned raw)
//   attn = softmax(logit);  kern = softmax(h W_shift + b_shift)
//   sm[e*12 + p] = sum_k attn[e*12 + (p + k - ks/2) mod 12] kern[k]
//   out = bf16(sm) . ctx                 (f32 accumulate, bf16 store)
// The circular cross-correlation along each elevation row's 12-heading
// ring is indexed directly; the TPU kernel's permutation matrices
// (_shift_perm_matrix) only worked around Mosaic's lowering limits.
//
// What bounds it on an H100: bytes.  W_in (H x C bf16, 4.5 MB at the
// headline shape) and ctx (B x 36 x C bf16, 3.1 MB) must each be read once:
// ~2.3 us at 3.35 TB/s, against ~0.2 GFLOP.  Reading them fast takes most
// of the SMs at once, but every output needs the whole of target's row, so
// the CTAs must exchange the logits.
//
// Design: one cooperative launch that spreads C over the card.  CTA s owns
// the columns [s sw, (s + 1) sw) of C for ALL batch rows (sw = 24 at the
// headline shape: 91 CTAs), so W_in is read once:
//   1. It brings h (B x H), its W_in^T rows and the W_shift^T rows into
//      shared memory by 16-byte cp.async, and once they are in, its
//      ctx[:, :, slice], which streams in during the product.
//   2. [target | shift logits] for all B on the tensor cores
//      (mma.sync.m16n8k16: the weight rows on M, the batch on N, f32
//      accumulate), K split over the warps, the parts summed in shared
//      memory.  target stays f32, as in the TPU kernel: the logits below
//      are f32 FMAs.
//   3. Partial logits ctx[b, t, slice] . target[b, slice] for all B x T,
//      written to a scratch row of its own.
//   4. Two grid-wide exchanges through readiness counters (release /
//      acquire at GPU scope): every CTA announces its partials (and runs
//      the shift taps' softmax meanwhile); CTA s sums its share of the
//      B x T logits over all slices (a warp per logit, every load in
//      flight at once) into the logit output; every CTA announces again,
//      then reads the B x T logits back (2.9 KB).
//   5. The softmax over the views and the ring smoothing (a half warp per
//      batch row), and the weighted sum of its slice from the ctx still in
//      shared memory.
// The counters live across calls (ops/_build.py:counters): the last CTA
// past both exchanges clears them, so a call needs no memset.  Measured on
// the H100 (chip_smoke.py phase 2, intermediate versions; PERF.md): every
// CTA summing all the partials itself instead of the second exchange was
// slower (0.0241 vs 0.0199 ms), as were slices of 32 columns (68 CTAs) and
// CTAs that each owned a batch row's softmax (0.0162 vs 0.0154 ms).
// Every CTA must be resident at once: the launch is cooperative, which
// the driver refuses for a grid that cannot be (ops/shift_attention.py:
// shift_plan keeps it within the SMs).  A wait that never ends traps
// (hopper.cuh: spin_guard).

#include "common.cuh"
#include "hopper.cuh"

using dasa::bf16;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kWidth = 12;   // headings per elevation row
constexpr int kPad = 8;      // bf16 elements of row padding
constexpr int kMaxNT = 8;    // n8 tiles of batch rows: B <= 64
constexpr int kCounterStride = 32;
constexpr int kMaxSlices = 160;  // CTAs (one per SM at most)

struct Layout {
  size_t hs, ws, cx, tg, lg, total;
  int mt, kg, ldt, ldr;
};

// The weight rows (the slice's W_in^T rows, then W_shift^T's) are M, in mt
// m16 tiles; the batch is N.  The warps split the product into mt x kg
// (m tile, k group) items, at most one each; their partial products take
// h's place once every warp has read h.
__host__ __device__ inline Layout shift_layout(int B, int T, int H, int ks,
                                               int sw) {
  Layout l;
  l.mt = (sw + ks + 15) / 16;
  l.kg = kWarps / l.mt;
  l.ldt = l.mt * 16;  // row stride of target | shift logits
  // partial-product rows (one per weight row, B columns): padded so that
  // a warp's 64-bit stores of an accumulator tile take two wavefronts
  l.ldr = ((B + 7) / 8 * 8 + 31) / 32 * 32 + 8;
  const size_t ld = H + kPad;
  const size_t h_bytes = (size_t)B * ld * sizeof(bf16);
  const size_t red_bytes = (size_t)l.kg * l.ldt * l.ldr * sizeof(float);
  l.hs = 0;
  l.ws = dasa::align_up(h_bytes > red_bytes ? h_bytes : red_bytes, 128);
  l.cx = dasa::align_up(l.ws + (size_t)(sw + ks) * ld * sizeof(bf16), 128);
  l.tg = dasa::align_up(l.cx + (size_t)B * T * sw * sizeof(bf16), 128);
  l.lg = dasa::align_up(l.tg + (size_t)B * l.ldt * sizeof(float), 128);
  l.total = dasa::align_up(l.lg + 2 * (size_t)B * T * sizeof(float), 128);
  return l;
}

struct ShiftArgs {
  const bf16* h;       // (B, H)
  const bf16* ctx;     // (B, T, C)
  const bf16* wint;    // (C, H) = W_in^T
  const bf16* wst;     // (ks, H) = W_shift^T
  const bf16* bshift;  // (ks,)
  bf16* out;           // (B, C)
  float* logit;        // (B, T)
  float* part;         // (slices, B T): partial logits
  uint32_t* ready;     // 3 counters, kCounterStride apart, zero at launch
  int B, T, C, H, ks, sw;
};

// max / sum over the 16 lanes of a half warp
__device__ __forceinline__ float half_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(~0u, v, o));
  return v;
}
__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  return v;
}

// grid-wide exchange in two halves, each called by all threads of the
// CTA: announce this CTA's writes to global memory ...
__device__ __forceinline__ void announce(uint32_t* counter) {
  __syncthreads();
  if (threadIdx.x == 0) {
    dasa::fence_acq_rel_gpu();
    dasa::red_relaxed_gpu(counter, 1);
  }
}

// ... and wait until all `n` CTAs have announced theirs
__device__ __forceinline__ void await_all(uint32_t* counter, uint32_t n) {
  if (threadIdx.x == 0) {
    const long long start = clock64();
    while (dasa::ld_acquire_gpu(counter) < n) dasa::spin_guard(start);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 1)
shift_attend_kernel(ShiftArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int B = a.B, T = a.T, C = a.C, H = a.H, ks = a.ks, sw = a.sw;
  const Layout l = shift_layout(B, T, H, ks, sw);
  bf16* hs = reinterpret_cast<bf16*>(smem + l.hs);      // [B][ld]
  bf16* ws = reinterpret_cast<bf16*>(smem + l.ws);      // [sw + ks][ld]
  bf16* cx = reinterpret_cast<bf16*>(smem + l.cx);      // [B T][sw]
  float* red = reinterpret_cast<float*>(smem + l.hs);   // [kg][ldt][ldr]
  float* tg = reinterpret_cast<float*>(smem + l.tg);    // [B][ldt]
  float* lg = reinterpret_cast<float*>(smem + l.lg);    // [B][T]
  float* sm = lg + B * T;                               // [B][T]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ld = H + kPad;
  const int nsl = gridDim.x;
  const int c0 = blockIdx.x * sw;
  const int sv = min(sw, C - c0);  // valid columns of this slice
  const int vrow = H / 8;          // 16-byte vectors of a row of H
  const int BT = B * T;

  float* bsh = sm;  // the shift bias, until the smoothing
  if (tid < ks) bsh[tid] = dasa::to_f(a.bshift[tid]);

  // 1. h and the weight rows; once they are in, ctx's slice, which streams
  // in during the product (W_in first has the memory to itself)
  for (int i = tid; i < B * vrow; i += kThreads)
    dasa::cp_async16(hs + (size_t)(i / vrow) * ld + (i % vrow) * 8,
                     a.h + (size_t)i * 8);
  for (int i = tid; i < (sv + ks) * vrow; i += kThreads) {
    const int r = i / vrow, v = i % vrow;
    const bf16* src = r < sv ? a.wint + (size_t)(c0 + r) * H
                             : a.wst + (size_t)(r - sv) * H;
    const int row = r < sv ? r : sw + r - sv;
    dasa::cp_async16(ws + (size_t)row * ld + v * 8, src + v * 8);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  const int vs = sv / 8;
  for (int i = tid; i < BT * vs; i += kThreads) {
    const int e = i / vs, v = i % vs;
    dasa::cp_async16(cx + (size_t)e * sw + v * 8,
                     a.ctx + (size_t)e * C + c0 + v * 8);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // 2. [target | shift logits]^T = [W_in slice | W_shift]^T h^T on the
  // tensor cores: warp w takes m tile w % mt and the (w / mt)-th of kg
  // ranges of k16 steps.  Weight rows past the last read the last and
  // batch rows past B read row B - 1; their products are never used.
  const int ksteps = H / 16;
  const int kper = (ksteps + l.kg - 1) / l.kg;
  const int nt = (B + 7) / 8;
  const int nrows = sw + ks;
  const bool busy = warp < l.mt * l.kg;
  const int mw = warp % l.mt, kw = warp / l.mt;
  float acc[kMaxNT][4];
#pragma unroll
  for (int n = 0; n < kMaxNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  if (busy) {
    const int k_lo = kw * kper, k_hi = min(ksteps, k_lo + kper);
    const uint32_t a_lane = dasa::smem_u32(ws) +
                            min(mw * 16 + lane % 16, nrows - 1) * ld * 2 +
                            (lane / 16) * 16;
    uint32_t b_lane[kMaxNT];
#pragma unroll
    for (int n = 0; n < kMaxNT; ++n)
      b_lane[n] = dasa::smem_u32(hs) + min(n * 8 + lane % 8, B - 1) * ld * 2 +
                  ((lane / 8) % 2) * 16;
#pragma unroll 2
    for (int k = k_lo; k < k_hi; ++k) {
      uint32_t af[4], bf[kMaxNT][2];
      dasa::ldmatrix_x4(af, a_lane + k * 32);
#pragma unroll
      for (int n = 0; n < kMaxNT; ++n)
        if (n < nt) dasa::ldmatrix_x2(bf[n], b_lane[n] + k * 32);
#pragma unroll
      for (int n = 0; n < kMaxNT; ++n)
        if (n < nt) dasa::mma_16816(acc[n], af, bf[n]);
    }
  }
  __syncthreads();  // every warp is done with h: red takes its place
  if (busy) {
    // acc[n]: weight rows mw 16 + lane / 4 (+ 8), batch 8 n + 2 (lane % 4)
    float* rp = red + (size_t)kw * l.ldt * l.ldr;
#pragma unroll
    for (int n = 0; n < kMaxNT; ++n) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = mw * 16 + lane / 4 + 8 * h;
        if (n < nt)
          *reinterpret_cast<float2*>(rp + j * l.ldr + 8 * n +
                                     2 * (lane % 4)) =
              make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
      }
    }
  }
  __syncthreads();
  // a warp per weight row j, lanes over the batch
  for (int j = warp; j < nrows; j += kWarps) {
    const float bias = j >= sw ? bsh[j - sw] : 0.0f;  // a shift logit's
    for (int b = lane; b < B; b += 32) {
      const float* rp = red + (size_t)j * l.ldr + b;
      float s = bias;
#pragma unroll 4
      for (int w = 0; w < l.kg; ++w) s += rp[(size_t)w * l.ldt * l.ldr];
      tg[b * l.ldt + j] = s;
    }
  }
  __syncthreads();
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // 3. partial logits of this slice
  for (int e = tid; e < BT; e += kThreads) {
    const bf16* xr = cx + (size_t)e * sw;
    const float* tr = tg + (e / T) * l.ldt;
    float s0 = 0.0f, s1 = 0.0f;
    for (int c = 0; c < sv; c += 8) {
      float x8[8];
      dasa::unpack8(*reinterpret_cast<const uint4*>(xr + c), x8);
      const float4 t0 = *reinterpret_cast<const float4*>(tr + c);
      const float4 t1 = *reinterpret_cast<const float4*>(tr + c + 4);
      s0 += x8[0] * t0.x + x8[1] * t0.y + x8[2] * t0.z + x8[3] * t0.w;
      s1 += x8[4] * t1.x + x8[5] * t1.y + x8[6] * t1.z + x8[7] * t1.w;
    }
    a.part[(size_t)blockIdx.x * BT + e] = s0 + s1;
  }

  // 4. the B x T logits: sums over the slices
  announce(a.ready);
  // the shift taps' softmax (local data only), a warp per batch row; the
  // taps replace their logits in tg
  for (int b = warp; b < B; b += kWarps) {
    float* kern = tg + b * l.ldt + sw;
    const float z = lane < ks ? kern[lane] : -INFINITY;
    const float zm = dasa::warp_max(z);
    const float ez = lane < ks ? __expf(z - zm) : 0.0f;
    const float kz = __fdividef(ez, dasa::warp_sum(ez));
    if (lane < ks) kern[lane] = kz;
  }
  await_all(a.ready, nsl);
  // CTA s sums its share of the B x T logits over all slices: a warp per
  // logit, lanes over the slices, every load in flight at once
  {
    const int per = (BT + nsl - 1) / nsl;
    const int e_hi = min(BT, (int)(blockIdx.x + 1) * per);
    for (int e = blockIdx.x * per + warp; e < e_hi; e += kWarps) {
      float v[kMaxSlices / 32];
#pragma unroll
      for (int i = 0; i < kMaxSlices / 32; ++i) {
        const int q = lane + 32 * i;
        v[i] = q < nsl ? __ldcg(a.part + (size_t)q * BT + e) : 0.0f;
      }
      float s = 0.0f;
#pragma unroll
      for (int i = 0; i < kMaxSlices / 32; ++i) s += v[i];
      s = dasa::warp_sum(s);
      if (lane == 0) a.logit[e] = s;
    }
  }
  announce(a.ready + kCounterStride);
  await_all(a.ready + kCounterStride, nsl);
  // the counters are left at zero for the next launch: the last CTA past
  // both exchanges (no CTA polls them any more) clears them at its end
  uint32_t* done = a.ready + 2 * kCounterStride;
  const uint32_t passed = tid == 0 ? atomicAdd(done, 1u) : 0;
  for (int e = tid; e < BT; e += kThreads) lg[e] = __ldcg(a.logit + e);
  __syncthreads();

  // 5. a half warp per batch row: softmax over the T <= 64 views (four
  // per lane), then the ring smoothing, rounded as the weighted sum's bf16
  // input.  A warp's two halves take rows 2 w and 2 w + 1.
  for (int b0 = 2 * warp; b0 < B; b0 += 2 * kWarps) {
    const int b = b0 + lane / 16, hl = lane % 16;
    const bool row = b < B;
    float* lrow = lg + (row ? b : 0) * T;
    const float* kern = tg + (row ? b : 0) * l.ldt + sw;
    float x[4], mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = hl + 16 * i;
      x[i] = row && t < T ? lrow[t] : -INFINITY;
      mx = fmaxf(mx, x[i]);
    }
    mx = half_max(mx);
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[i] = row && hl + 16 * i < T ? __expf(x[i] - mx) : 0.0f;
      sum += x[i];
    }
    const float inv = __fdividef(1.0f, half_sum(sum));
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (row && hl + 16 * i < T) lrow[hl + 16 * i] = x[i] * inv;
    __syncwarp();
    for (int t = hl; row && t < T; t += 16) {
      const int e = t / kWidth, p = t % kWidth;
      const float* ring = lrow + e * kWidth;
      int q = ((p - ks / 2) % kWidth + kWidth) % kWidth;  // the first tap
      float s = 0.0f;
      for (int k = 0; k < ks; ++k) {
        s += ring[q] * kern[k];
        q = q + 1 == kWidth ? 0 : q + 1;
      }
      sm[b * T + t] = dasa::to_f(dasa::to_bf(s));
    }
  }
  __syncthreads();
  // the weighted sum of this slice
  for (int i = tid; i < B * sv; i += kThreads) {
    const int b = i / sv, c = i % sv;
    const bf16* xc = cx + (size_t)b * T * sw + c;
    const float* sr = sm + b * T;
    float s0 = 0.0f, s1 = 0.0f;
#pragma unroll 4
    for (int t = 0; t + 1 < T; t += 2) {
      s0 += sr[t] * dasa::to_f(xc[(size_t)t * sw]);
      s1 += sr[t + 1] * dasa::to_f(xc[(size_t)(t + 1) * sw]);
    }
    a.out[(size_t)b * C + c0 + c] = dasa::to_bf(s0 + s1);
  }
  if (tid == 0 && passed == (uint32_t)nsl - 1) {
    a.ready[0] = 0;
    a.ready[kCounterStride] = 0;
    *done = 0;
  }
  __syncthreads();
}

}  // namespace

// Shared memory of one CTA; ops/shift_attention.py:shift_plan mirrors it.
extern "C" int dasa_shift_attend_smem(int B, int T, int H, int ks, int sw) {
  return static_cast<int>(shift_layout(B, T, H, ks, sw).total);
}

extern "C" int dasa_shift_attend(const void* h, const void* ctx,
                                 const void* wint, const void* wst,
                                 const void* bshift, void* out, void* logit,
                                 void* part, void* ready, int B, int T, int C,
                                 int H, int ks, int sw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || B > kMaxNT * 8 || T > 64 || T % kWidth || ks < 1 ||
      ks > 32 || C % 8 || H % 16 || sw % 8 || sw < 8 || sw + ks > 256 ||
      (C + sw - 1) / sw > kMaxSlices)
    return cudaErrorInvalidValue;
  const size_t smem = shift_layout(B, T, H, ks, sw).total;
  ShiftArgs a;
  a.h = static_cast<const bf16*>(h);
  a.ctx = static_cast<const bf16*>(ctx);
  a.wint = static_cast<const bf16*>(wint);
  a.wst = static_cast<const bf16*>(wst);
  a.bshift = static_cast<const bf16*>(bshift);
  a.out = static_cast<bf16*>(out);
  a.logit = static_cast<float*>(logit);
  a.part = static_cast<float*>(part);
  a.ready = static_cast<uint32_t*>(ready);
  a.B = B;
  a.T = T;
  a.C = C;
  a.H = H;
  a.ks = ks;
  a.sw = sw;
  cudaError_t e = cudaFuncSetAttribute(
      shift_attend_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((C + sw - 1) / sw);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, shift_attend_kernel, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}
