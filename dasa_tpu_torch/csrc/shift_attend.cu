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
// ~2.3 us at 3.35 TB/s, against ~0.2 GFLOP.
//
// Design: two launches inside one call.
//  (a) shift_proj_kernel: the column product h [W_in | W_shift] for all B
//      rows at once, so W_in streams from device memory exactly once.  The
//      weights arrive transposed (C x H, the torch Linear layout); each warp
//      owns one output column at a time, its lanes walk H in 16-byte
//      vectors, h sits in shared memory, and a warp reduction finishes
//      each of the B dot products.  Output: f32 (B x ldt) scratch holding
//      target in columns [0, C) and the shift logits in [C, C + ks).
//  (b) shift_attend_kernel: one CTA per batch row stages that row's ctx
//      (36 x 2176 bf16 = 153 KiB) in shared memory once, then computes the
//      36 logits (a warp per view), both softmaxes, the ring smoothing and
//      the weighted sum from shared memory.

#include "common.cuh"

using dasa::bf16;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWidth = 12;  // headings per elevation row
constexpr int kMaxB = 32;   // batch rows per register block in (a)

__global__ void __launch_bounds__(kThreads)
shift_proj_kernel(const bf16* __restrict__ h,     // (B, H)
                  const bf16* __restrict__ wint,  // (C, H) = W_in^T
                  const bf16* __restrict__ wst,   // (ks, H) = W_shift^T
                  float* __restrict__ tk,         // (B, ldt)
                  int B, int H, int C, int ks, int ldt) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* hs = reinterpret_cast<bf16*>(smem);  // [B][H]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int vrow = H / 8;
  for (int idx = tid; idx < B * vrow; idx += kThreads)
    reinterpret_cast<uint4*>(hs)[idx] = reinterpret_cast<const uint4*>(h)[idx];
  __syncthreads();

  const int ncols = C + ks;
  for (int j = blockIdx.x * kWarps + warp; j < ncols; j += gridDim.x * kWarps) {
    const bf16* wrow = j < C ? wint + (size_t)j * H : wst + (size_t)(j - C) * H;
    for (int b0 = 0; b0 < B; b0 += kMaxB) {
      float acc[kMaxB];
#pragma unroll
      for (int i = 0; i < kMaxB; ++i) acc[i] = 0.0f;
      for (int k = lane * 8; k < H; k += 32 * 8) {
        float w8[8];
        dasa::unpack8(*reinterpret_cast<const uint4*>(wrow + k), w8);
#pragma unroll
        for (int i = 0; i < kMaxB; ++i) {
          if (b0 + i < B) {
            float h8[8];
            dasa::unpack8(
                *reinterpret_cast<const uint4*>(hs + (size_t)(b0 + i) * H + k), h8);
#pragma unroll
            for (int q = 0; q < 8; ++q) acc[i] += h8[q] * w8[q];
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kMaxB; ++i) {
        if (b0 + i < B) {
          const float s = dasa::warp_sum(acc[i]);
          if (lane == 0) tk[(size_t)(b0 + i) * ldt + j] = s;
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
shift_attend_kernel(const bf16* __restrict__ ctx,     // (B, T, C)
                    const float* __restrict__ tk,     // (B, ldt)
                    const bf16* __restrict__ bshift,  // (ks,)
                    bf16* __restrict__ out,           // (B, C)
                    float* __restrict__ logit,        // (B, T)
                    int T, int C, int ks, int ldt) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* cx = reinterpret_cast<bf16*>(smem);  // [T][C]
  float* lg = reinterpret_cast<float*>(smem + dasa::align_up(
                                                  (size_t)T * C * sizeof(bf16), 128));
  float* sm = lg + 64;    // smoothed attention, rounded to bf16
  float* kern = sm + 64;  // shift kernel taps
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const bf16* row = ctx + (size_t)b * T * C;
  const float* target = tk + (size_t)b * ldt;

  for (int idx = tid; idx < T * C / 8; idx += kThreads)
    reinterpret_cast<uint4*>(cx)[idx] = reinterpret_cast<const uint4*>(row)[idx];
  __syncthreads();

  for (int t = warp; t < T; t += kWarps) {
    float s = 0.0f;
    for (int c = lane * 8; c < C; c += 32 * 8) {
      float x8[8];
      dasa::unpack8(*reinterpret_cast<const uint4*>(cx + (size_t)t * C + c), x8);
      const float4 t0 = *reinterpret_cast<const float4*>(target + c);
      const float4 t1 = *reinterpret_cast<const float4*>(target + c + 4);
      s += x8[0] * t0.x + x8[1] * t0.y + x8[2] * t0.z + x8[3] * t0.w +
           x8[4] * t1.x + x8[5] * t1.y + x8[6] * t1.z + x8[7] * t1.w;
    }
    s = dasa::warp_sum(s);
    if (lane == 0) {
      lg[t] = s;
      logit[(size_t)b * T + t] = s;
    }
  }
  __syncthreads();

  if (warp == 0) {
    // softmax over the T <= 64 views: two per lane
    const float x0 = lane < T ? lg[lane] : -INFINITY;
    const float x1 = lane + 32 < T ? lg[lane + 32] : -INFINITY;
    const float mx = dasa::warp_max(fmaxf(x0, x1));
    const float e0 = lane < T ? expf(x0 - mx) : 0.0f;
    const float e1 = lane + 32 < T ? expf(x1 - mx) : 0.0f;
    const float inv = 1.0f / dasa::warp_sum(e0 + e1);
    if (lane < T) lg[lane] = e0 * inv;
    if (lane + 32 < T) lg[lane + 32] = e1 * inv;
    // softmax over the ks <= 32 shift taps
    const float z = lane < ks ? target[C + lane] + dasa::to_f(bshift[lane])
                              : -INFINITY;
    const float zm = dasa::warp_max(z);
    const float ez = lane < ks ? expf(z - zm) : 0.0f;
    const float zs = dasa::warp_sum(ez);
    if (lane < ks) kern[lane] = ez / zs;
  }
  __syncthreads();

  if (tid < T) {
    const int e = tid / kWidth, p = tid % kWidth;
    float s = 0.0f;
    for (int k = 0; k < ks; ++k) {
      const int src = e * kWidth + ((p + k - ks / 2) % kWidth + kWidth) % kWidth;
      s += lg[src] * kern[k];
    }
    sm[tid] = dasa::to_f(dasa::to_bf(s));
  }
  __syncthreads();

  for (int c = tid; c < C; c += kThreads) {
    float s = 0.0f;
    for (int t = 0; t < T; ++t) s += sm[t] * dasa::to_f(cx[(size_t)t * C + c]);
    out[(size_t)b * C + c] = dasa::to_bf(s);
  }
}

}  // namespace

extern "C" int dasa_shift_attend(const void* h, const void* ctx,
                                 const void* wint, const void* wst,
                                 const void* bshift, void* tk, void* out,
                                 void* logit, int B, int T, int C, int H,
                                 int ks, int ldt, int n_sm, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem_a = (size_t)B * H * sizeof(bf16);
  cudaError_t e = cudaFuncSetAttribute(
      shift_proj_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_a));
  if (e != cudaSuccess) return e;
  const int cols_per_cta = kWarps * 2;
  int grid_a = (C + ks + cols_per_cta - 1) / cols_per_cta;
  if (grid_a > 2 * n_sm) grid_a = 2 * n_sm;
  shift_proj_kernel<<<grid_a, kThreads, smem_a, s>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(wint),
      static_cast<const bf16*>(wst), static_cast<float*>(tk), B, H, C, ks, ldt);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  const size_t smem_b =
      dasa::align_up((size_t)T * C * sizeof(bf16), 128) + 160 * sizeof(float);
  e = cudaFuncSetAttribute(shift_attend_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem_b));
  if (e != cudaSuccess) return e;
  shift_attend_kernel<<<B, kThreads, smem_b, s>>>(
      static_cast<const bf16*>(ctx), static_cast<const float*>(tk),
      static_cast<const bf16*>(bshift), static_cast<bf16*>(out),
      static_cast<float*>(logit), T, C, ks, ldt);
  return cudaGetLastError();
}
