// Depth-guided AdaIN channel gate: the Hopper port of the TPU kernel
// dasa_tpu/ops/adain.py:_kernel (reached through _pallas_forward /
// adain_channel_gate).
//
// What it computes, for rows n of the panorama (B*36) or the candidates
// (B*K) at C = K = 2048 channels:
//   out[n, c] = sigmoid(sum_k d[n, k] W[k, c] + b[c]) * f[n, c] * noise[c]
// with the product accumulated in f32 and the epilogue in f32, rounded to
// bf16 once on the store.  W arrives as W^T (C x K, the torch Linear
// layout), so both operands are K-major and neither is transposed.
//
// What bounds it on an H100: 2 n C K flops (6.0 GFLOP at 720 rows, 2.7 at
// 320) over ~17 / ~12 MB: ~6 / ~3 us at the bf16 tensor-core peak, a small
// GEMM near the ridge point.  With 128-row tiles the grid has few CTAs (96
// or 48 at 128 x 128; 192 or 96 at 128 x 64), so each SM feeds its own
// tensor cores, with both wgmma operands read from shared memory: per k16
// step each warpgroup reads (2 + BN / 32) KiB and TMA writes (4 + BN / 32)
// KiB.  At 128 B a clock that is 160 clocks against 128 of tensor-core
// work at BN = 128, 112 against 64 at BN = 64: shared-memory bandwidth,
// not the tensor cores, bounds either width.
//
// Design: warp specialisation around a TMA ring.  One producer warp issues
// TMA loads of 128 x 128 slabs of d and BN x 128 slabs of W^T (each two
// 64-element boxes: 128-byte rows, 128-byte swizzle) into a ring of
// stages, each with a "full" mbarrier (expect_tx) and an "empty" one (a
// 128-deep stage halves the barrier round trips per byte of a 64-deep
// one; the two measured about even).
// Two consumer warpgroups (64 rows each) issue wgmma.mma_async m64nBNk16
// (f32 accumulators in registers) on each stage as it arrives, keep one
// stage's products in flight, and hand the stage before it back to the
// producer.  Once the operand loads are queued, the producer also fetches
// the f tile by TMA, so the epilogue finds it in shared memory.  The
// epilogue stays fused: sigmoid(acc + b) * f * noise in f32 from the
// accumulator registers, rounded to bf16 once, written over the f tile in
// place and stored by TMA.  Rows past n (720 and 320 are not multiples of
// 128) load as zeros through TMA's out-of-bounds fill and are not stored.
//
// Output tile: 128 x 128 (3 stages, 225 KiB) or 128 x 64 (4 stages, 209
// KiB), one CTA per SM.  ops/adain.py:adain_plan takes 128 x 64 when the
// 128 x 128 grid would fill at most half the SMs (measured on the H100:
// 128 x 64 faster at 320 rows, 128 x 128 at 720).  Measured and dropped:
// clusters of 2-4 CTAs sharing the d / W^T tiles by TMA multicast (2-11%
// slower at every shape: the L2 reads they save are not the bound).

#include "common.cuh"
#include "hopper.cuh"

using dasa::bf16;

namespace {

constexpr int kBM = 128;            // output rows per CTA (two warpgroups)
constexpr int kBK = 64;             // K elements of a box: 128-byte rows
constexpr int kSK = 2 * kBK;        // K elements of a stage: two boxes
constexpr int kThreads = 288;       // 2 consumer warpgroups + 1 producer warp
constexpr int kConsumers = 256;
constexpr int kBoxBytes = kBM * 128;  // one 128 x 64 bf16 box

template <int BN>
struct Tile {
  static constexpr int kStages = BN == 128 ? 3 : 4;
  static constexpr int kABox = kBM * kBK * 2;   // one 64-wide box of d
  static constexpr int kBBox = BN * kBK * 2;    // one of W^T
  static constexpr int kABytes = 2 * kABox;
  static constexpr int kStageBytes = 2 * (kABox + kBBox);
  static constexpr int kFBytes = kBM * BN * 2;
  // stages, f / out tile, barriers, and slack to align the base to 1024
  static constexpr int kSmem =
      kStages * kStageBytes + kFBytes + 256 + 1024;
};

// wgmma descriptor of a K-major tile with 128-byte rows, 128-byte swizzle:
// 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  const uint64_t addr = dasa::smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

template <int N>
__device__ __forceinline__ void wgmma_m64k16(float* d, uint64_t da,
                                             uint64_t db);

template <>
__device__ __forceinline__ void wgmma_m64k16<64>(float* d, uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_m64k16<128>(float* d, uint64_t da,
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
adain_gate_kernel(const __grid_constant__ CUtensorMap map_d,    // (n, K)
                  const __grid_constant__ CUtensorMap map_wt,   // (C, K)
                  const __grid_constant__ CUtensorMap map_f,    // (n, C)
                  const __grid_constant__ CUtensorMap map_out,  // (n, C)
                  const bf16* __restrict__ bias,   // (C,)
                  const bf16* __restrict__ noise,  // (C,) or null
                  int K) {
  using T = Tile<BN>;
  constexpr int S = T::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (dasa::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ftile = smem + S * T::kStageBytes;  // BN / 64 boxes
  uint64_t* full = reinterpret_cast<uint64_t*>(ftile + T::kFBytes);
  uint64_t* empty = full + S;
  uint64_t* fbar = empty + S;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * BN;
  const int nk = (K + kSK - 1) / kSK;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      dasa::mbar_init(&full[s], 1);
      dasa::mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    dasa::mbar_init(fbar, 1);
    dasa::fence_barrier_init();
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // producer: one thread keeps the ring full
    if (lane == 0) {
      const int primed = nk < S ? nk : S;
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % S;
        if (kt >= S) dasa::mbar_wait(&empty[s], ((kt / S) - 1) & 1);
        unsigned char* a = smem + s * T::kStageBytes;
        unsigned char* b = a + T::kABytes;
        dasa::mbar_expect_tx(&full[s], T::kStageBytes);
        for (int h = 0; h < 2; ++h) {
          dasa::tma_load_2d(a + h * T::kABox, &map_d, &full[s],
                            kt * kSK + h * kBK, m0);
          dasa::tma_load_2d(b + h * T::kBBox, &map_wt, &full[s],
                            kt * kSK + h * kBK, n0);
        }
        if (kt == primed - 1) {  // the epilogue's f tile, behind the first
          dasa::mbar_expect_tx(fbar, T::kFBytes);  // operand stages
          for (int j = 0; j < BN / 64; ++j)
            dasa::tma_load_2d(ftile + j * kBoxBytes, &map_f, fbar,
                              n0 + j * 64, m0);
        }
      }
    }
    return;
  }

  // consumers: warpgroup g owns rows [64 g, 64 g + 64) of the tile.
  // This thread's columns' bias and noise go to registers first: loaded
  // inside the epilogue, after its shared-memory stores, each load would
  // wait its full latency in turn.
  const int g = warp / 4;
  float2 bv[BN / 8], nv[BN / 8];
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const int col = n0 + 8 * i + 2 * (lane % 4);
    bv[i] = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(bias + col));
    nv[i] = noise == nullptr
                ? make_float2(1.0f, 1.0f)
                : __bfloat1622float2(
                      *reinterpret_cast<const __nv_bfloat162*>(noise + col));
  }
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % S;
    dasa::mbar_wait(&full[s], (kt / S) & 1);
    const unsigned char* a = smem + s * T::kStageBytes + g * 64 * 128;
    const unsigned char* b = smem + s * T::kStageBytes + T::kABytes;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) asm volatile("" : "+f"(acc[i])::"memory");
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint64_t da = desc_sw128(a + h * T::kABox);
      const uint64_t db = desc_sw128(b + h * T::kBBox);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)  // 32 bytes per k16 step
        wgmma_m64k16<BN>(acc, da + 2 * kk, db + 2 * kk);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // keep this stage's products in flight; the previous one is done
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) asm volatile("" : "+f"(acc[i])::"memory");
    if (kt > 0 && tid % 128 == 0) dasa::mbar_arrive(&empty[(kt - 1) % S]);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) asm volatile("" : "+f"(acc[i])::"memory");

  // epilogue: acc[4 i + 2 j + e] is row 16 w + lane / 4 + 8 j, column
  // 8 i + 2 (lane % 4) + e of this warpgroup's 64 x BN block
  dasa::mbar_wait(fbar, 0);
  const int wq = warp % 4;
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const int col = 8 * i + 2 * (lane % 4);
    const int box = col / 64, cc = col % 64;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int row = g * 64 + 16 * wq + lane / 4 + 8 * j;
      // the 128-byte swizzle TMA used: 16-byte chunk index ^ (row % 8)
      __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(
          ftile + box * kBoxBytes + row * 128 +
          ((((cc >> 3) ^ (row & 7)) << 4) | ((cc & 7) * 2)));
      const float2 fv = __bfloat1622float2(*p);
      // f * noise * sigmoid(acc + b) in f32 (noise 1 if none), with the
      // fast exp and divide: the accurate ones cost tens of instructions a
      // value, 64 values a thread, and differ by a few f32 ulps, far below
      // the one bf16 rounding that follows
      const float z0 = acc[4 * i + 2 * j] + bv[i].x;
      const float z1 = acc[4 * i + 2 * j + 1] + bv[i].y;
      const float o0 = __fdividef(fv.x * nv[i].x, 1.0f + __expf(-z0));
      const float o1 = __fdividef(fv.y * nv[i].y, 1.0f + __expf(-z1));
      *p = __floats2bfloat162_rn(o0, o1);
    }
  }
  dasa::fence_proxy_async_shared();
  dasa::named_barrier(1, kConsumers);
  if (tid == 0) {
    for (int j = 0; j < BN / 64; ++j)
      dasa::tma_store_2d(&map_out, ftile + j * kBoxBytes, n0 + j * 64, m0);
    dasa::tma_store_commit_and_wait();
  }
}

template <int BN>
int launch(const void* d, const void* f, const void* wt, const void* bias,
           const void* noise, void* out, int n, int C, int K,
           cudaStream_t stream) {
  CUtensorMap map_d, map_wt, map_f, map_out;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  cudaError_t e = dasa::make_map_bf16(&map_d, d, n, K, K, kBM, kBK, sw);
  if (e == cudaSuccess)
    e = dasa::make_map_bf16(&map_wt, wt, C, K, K, BN, kBK, sw);
  if (e == cudaSuccess)
    e = dasa::make_map_bf16(&map_f, f, n, C, C, kBM, 64, sw);
  if (e == cudaSuccess)
    e = dasa::make_map_bf16(&map_out, out, n, C, C, kBM, 64, sw);
  if (e != cudaSuccess) return e;
  // the shared-memory limit once per device, not on every call
  static unsigned long long smem_set = 0;  // bit d: set on device d
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (!((smem_set >> dev) & 1)) {
    e = cudaFuncSetAttribute(adain_gate_kernel<BN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Tile<BN>::kSmem);
    if (e != cudaSuccess) return e;
    smem_set |= 1ull << dev;
  }
  const dim3 grid(C / BN, (n + kBM - 1) / kBM);
  adain_gate_kernel<BN><<<grid, kThreads, Tile<BN>::kSmem, stream>>>(
      map_d, map_wt, map_f, map_out, static_cast<const bf16*>(bias),
      static_cast<const bf16*>(noise), K);
  return cudaGetLastError();
}

}  // namespace

// Shared memory of one CTA for output tiles of `bn` columns (0 if the tile
// does not exist); ops/adain.py:adain_plan mirrors it.
extern "C" int dasa_adain_gate_smem(int bn) {
  return bn == 128 ? Tile<128>::kSmem : bn == 64 ? Tile<64>::kSmem : 0;
}

// The wrapper (ops/adain.py:adain_plan) has checked the shapes: C % bn ==
// 0, K % 8 == 0 (16-byte TMA row strides), 16-byte aligned pointers.
extern "C" int dasa_adain_gate(const void* d, const void* f, const void* wt,
                               const void* bias, const void* noise, void* out,
                               int n, int C, int K, int bn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn == 128) return launch<128>(d, f, wt, bias, noise, out, n, C, K, s);
  if (bn == 64) return launch<64>(d, f, wt, bias, noise, out, n, C, K, s);
  return cudaErrorInvalidValue;
}
