// ELIC residual block on Hopper: out = x + 1x1(relu(3x3_SAME(relu(1x1 x)))),
// C -> C/2 -> C/2 -> C, fused into one kernel. A chain of N blocks is N
// launches (ops/rb_chain.py); one block is ops/resblock.py.
//
// Replaces the TPU kernels shallow_ntc_tpu/ops/pallas/rb_chain.py
// (fused_rb_chain: _make_kernel, _make_multi_ref_kernel) and
// shallow_ntc_tpu/ops/pallas/resblock.py (fused_resblock: _make_kernel),
// porting their contract and none of their TPU tactics (R-row cells with a
// 2N halo, pltpu.roll width taps, the 128-lane layout). Any B, H and W.
//
// Layouts (NHWC, C innermost):
//   x, out [B, H, W, C]     float32 or bfloat16
//   w1 [C, Ch], w2 [3, 3, Ch, Ch], w3 [Ch, C], b1 [Ch], b2 [Ch], b3 [C]
//                           float32 (the wrapper rounds the weights, not the
//                           biases, to x's type first)
//
// Rounding, as the Pallas kernels: float32 products and sums, float32 biases;
// in the bfloat16 instantiation h1 and h2 are rounded to bfloat16 after bias
// and relu (stored as float), and h3 after its bias, before the residual add.
//
// Design: one CTA per 8x8 output tile, 256 threads (8 warps). The three
// convolutions are GEMMs on the tensor cores:
//   1. h1 = relu(x @ w1 + b1) over the 10x10 halo tile (M = 100, padded to
//      112), into shared memory; x comes through a 32-channel staging slab.
//      h1 is 0 at pixels outside the image: SAME zero padding of the 3x3
//      applies to h1, and relu(b1) != 0 there, so x must not simply be
//      zero-padded.
//   2. h2 = relu(3x3(h1) + b2) over the 8x8 tile (M = 64, K = 9 Ch, the
//      A rows gathered from h1 per tap), into shared memory.
//   3. out = x + h2 @ w3 + b3 (M = 64, N = C), written once.
// Each warp owns 16 rows by 16 RN columns of a GEMM (mma.sync m16n8k8).
// Float32 accuracy with TF32 tensor cores: every operand is split into a
// TF32 head and a TF32 tail, and a*b = ah*bh + ah*bl + al*bh (3xTF32; the
// dropped al*bl is below float32 rounding). Shared-memory rows are padded to
// 4 mod 8 floats, so a fragment's 32 loads hit 32 banks. B fragments come
// from the float32 weights through L1/L2. Accumulation is in float32.
//
// Bound on the H100: operations. A block does 2 (C Ch + 9 Ch^2 + Ch C) FLOP
// per pixel (239,616 at C=192) against 2 C element moves. 3xTF32 issues
// three TF32 MMAs per product, so its ceiling is a third of the 495 TFLOP/s
// TF32 peak. bfloat16 x, its weights and the rounded h1 and h2 are exact in
// TF32, so for bf16 every GEMM takes one MMA per product. The whole-chain
// single-launch kernel on wgmma is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kTile = 8;
constexpr int kHalo = kTile + 2;
constexpr int kHaloPix = kHalo * kHalo;                         // 100
constexpr int kHaloRows = 112;                                  // 7 m-tiles of 16
constexpr int kTilePix = kTile * kTile;                         // 64
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kStageK = 32;                                     // x channels per slab
constexpr int kStageLd = kStageK + 4;                           // 4 mod 8: no bank conflicts
constexpr int kMaxRN = 5;                                       // Ch <= 160

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
// v rounded to T and back: the identity for float, one bfloat16 rounding for bfloat16.
template <typename T> __device__ __forceinline__ float round_to(float v) { return v; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// Row stride of h1 and h2: Ch rounded up to 8 (a k-step), plus 4 (banks).
__host__ __device__ inline int h_ld(int ch) { return ((ch + 7) & ~7) + 4; }

__host__ __device__ inline int smem_floats(int ch) {
  const int h2 = kTilePix * h_ld(ch);
  const int stage = kHaloRows * kStageLd;
  return kHaloPix * h_ld(ch) + (h2 > stage ? h2 : stage);
}

// x = hi + lo with hi rounded to TF32 (10 mantissa bits, nearest, ties away)
// by integer ops, and lo = x - hi exact in float32; the tensor core reads
// only lo's top 10 mantissa bits, which leaves an error below 2^-21 |x|.
// (cvt.rna.tf32.f32 would round the same, at a quarter of the issue rate.)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One k-step of 8 for a warp's 16 x (8 NT) tile: acc += A[16, 8] @ W[8, 8 NT].
// a0/a8 point at the A rows of this lane's groups (m = gid and gid + 8) at
// the k-step's first column; W is row-major with leading dimension ldw,
// its rows k .. k+7 and columns n0 .. n0 + 8 NT - 1 (0 past k_end / n_end).
// kTailA / kTailB: whether A / W can have a nonzero TF32 tail (bfloat16
// values and weights rounded to bfloat16 are exact in TF32). The MMAs are
// issued tile after tile, so that no MMA waits on the one before it.
template <int NT, bool kTailA, bool kTailB>
__device__ __forceinline__ void mma_k8(float (&acc)[NT][4], const float* a0, const float* a8,
                                       const float* __restrict__ w, int ldw, int k, int k_end,
                                       int n0, int n_end, int lane) {
  const int gid = lane >> 2, tig = lane & 3;
  uint32_t ah[4], al[4];
  split_tf32(a0[tig], ah[0], al[0]);
  split_tf32(a8[tig], ah[1], al[1]);
  split_tf32(a0[tig + 4], ah[2], al[2]);
  split_tf32(a8[tig + 4], ah[3], al[3]);
  const bool k_lo = k + tig < k_end, k_hi = k + tig + 4 < k_end;
  const float* w_lo = w + (long long)(k + tig) * ldw;
  const float* w_hi = w_lo + 4LL * ldw;
  uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int n = n0 + 8 * t + gid;
    const bool n_ok = n < n_end;
    split_tf32(k_lo && n_ok ? __ldg(w_lo + n) : 0.f, bh[t][0], bl[t][0]);
    split_tf32(k_hi && n_ok ? __ldg(w_hi + n) : 0.f, bh[t][1], bl[t][1]);
  }
  // The tensor core rounds its sums toward zero; summing the k-step into a
  // fresh tile and adding that to acc in float32 (round to nearest) keeps
  // the bias of that rounding from growing with K.
  float d[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t) d[t][0] = d[t][1] = d[t][2] = d[t][3] = 0.f;
  if (kTailA) {
#pragma unroll
    for (int t = 0; t < NT; ++t) mma_tf32(d[t], al, bh[t][0], bh[t][1]);
  }
  if (kTailB) {
#pragma unroll
    for (int t = 0; t < NT; ++t) mma_tf32(d[t], ah, bl[t][0], bl[t][1]);
  }
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    mma_tf32(d[t], ah, bh[t][0], bh[t][1]);
    acc[t][0] += d[t][0];
    acc[t][1] += d[t][1];
    acc[t][2] += d[t][2];
    acc[t][3] += d[t][3];
  }
}

// acc = bias at this lane's accumulator columns (n0 + 8 t + 2 tig + {0, 1}).
template <int NT>
__device__ __forceinline__ void init_bias(float (&acc)[NT][4], const float* __restrict__ bias,
                                          int n0, int n_end, int lane) {
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int n = n0 + 8 * t + 2 * (lane & 3);
    const float v0 = n < n_end ? __ldg(bias + n) : 0.f;
    const float v1 = n + 1 < n_end ? __ldg(bias + n + 1) : 0.f;
    acc[t][0] = v0;
    acc[t][1] = v1;
    acc[t][2] = v0;
    acc[t][3] = v1;
  }
}

// Write relu(acc), rounded to T, of rows m0 + gid (+ 8) to dst[row * ld + n]
// for n < n_pad: 0 at columns n >= n_end and at rows where keep(row) is false.
template <typename T, int NT, typename Keep>
__device__ __forceinline__ void store_relu(const float (&acc)[NT][4], float* dst, int ld,
                                           int m0, int n0, int n_end, int n_pad, int lane,
                                           Keep keep) {
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = m0 + gid + 8 * half;
    if (!keep.valid(row)) continue;
    const bool inside = keep(row);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = n0 + 8 * t + 2 * tig + j;
        if (n < n_pad)
          dst[row * ld + n] =
              (inside && n < n_end) ? round_to<T>(fmaxf(acc[t][2 * half + j], 0.f)) : 0.f;
      }
    }
  }
}

struct HaloRows {  // rows of the 10x10 halo tile: stored if < 100, nonzero if in the image
  int y0, x0, H, W;
  __device__ bool valid(int r) const { return r < kHaloPix; }
  __device__ bool operator()(int r) const {
    const int gy = y0 - 1 + r / kHalo, gx = x0 - 1 + r % kHalo;
    return gy >= 0 && gy < H && gx >= 0 && gx < W;
  }
};

struct TileRows {  // rows of the 8x8 output tile: all stored
  __device__ bool valid(int) const { return true; }
  __device__ bool operator()(int) const { return true; }
};

template <typename T, int RN>
__global__ void __launch_bounds__(kThreads, RN <= 3 ? 2 : 1)
resblock_kernel(const T* __restrict__ x, const float* __restrict__ w1,
                const float* __restrict__ b1, const float* __restrict__ w2,
                const float* __restrict__ b2, const float* __restrict__ w3,
                const float* __restrict__ b3, T* __restrict__ out, int H, int W,
                int C, int Ch, int tiles_w, int tiles_h) {
  constexpr int NT = 2 * RN;  // n-tiles of 8 per warp: half of Ch <= 32 RN
  constexpr bool kF32 = sizeof(T) == sizeof(float);  // else bf16: x, w, h1, h2 exact in TF32
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ld = h_ld(Ch);
  const int ch8 = (Ch + 7) & ~7;
  float* h1 = smem;                   // [kHaloPix][ld]
  float* h2 = smem + kHaloPix * ld;   // [kTilePix][ld]; x staging in phase 1
  float* stage = h2;                  // [kHaloRows][kStageLd]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gid = lane >> 2;
  int t = blockIdx.x;
  const int tx = t % tiles_w;
  t /= tiles_w;
  const int ty = t % tiles_h;
  const int b = t / tiles_h;
  const int y0 = ty * kTile, x0 = tx * kTile;
  const T* xb = x + (long long)b * H * W * C;
  const int n_half = 16 * RN;  // columns per warp in phases 1 and 2

  // ---- 1. h1 over the halo tile: 7 m-tiles x 2 column halves = 14 units --
  {
    // Unit u: m-tile u >> 1, column half u & 1. Warp w runs units w and w + 8.
    const int u0 = warp, u1 = warp + 8;
    const bool two = u1 < 14;
    float acc0[NT][4], acc1[NT][4];
    init_bias<NT>(acc0, b1, (u0 & 1) * n_half, Ch, lane);
    init_bias<NT>(acc1, b1, (u1 & 1) * n_half, Ch, lane);
    for (int k0 = 0; k0 < C; k0 += kStageK) {
      __syncthreads();  // the previous slab is consumed
      for (int e = threadIdx.x; e < kHaloRows * kStageK; e += kThreads) {
        const int p = e / kStageK, kk = e % kStageK;
        const int gy = y0 - 1 + p / kHalo, gx = x0 - 1 + p % kHalo;
        float v = 0.f;
        if (p < kHaloPix && gy >= 0 && gy < H && gx >= 0 && gx < W && k0 + kk < C)
          v = to_f32(xb[((long long)gy * W + gx) * C + k0 + kk]);
        stage[p * kStageLd + kk] = v;
      }
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < kStageK; ks += 8) {
        if (k0 + ks >= C) break;
        const float* r0 = stage + ((u0 >> 1) * 16 + gid) * kStageLd + ks;
        mma_k8<NT, kF32, kF32>(acc0, r0, r0 + 8 * kStageLd, w1, Ch, k0 + ks, C,
                               (u0 & 1) * n_half, Ch, lane);
        if (two) {
          const float* s0 = stage + ((u1 >> 1) * 16 + gid) * kStageLd + ks;
          mma_k8<NT, kF32, kF32>(acc1, s0, s0 + 8 * kStageLd, w1, Ch, k0 + ks, C,
                                 (u1 & 1) * n_half, Ch, lane);
        }
      }
    }
    __syncthreads();  // staging (aliasing h2) is done
    const HaloRows rows{y0, x0, H, W};
    store_relu<T, NT>(acc0, h1, ld, (u0 >> 1) * 16, (u0 & 1) * n_half, Ch, ch8, lane, rows);
    if (two)
      store_relu<T, NT>(acc1, h1, ld, (u1 >> 1) * 16, (u1 & 1) * n_half, Ch, ch8, lane, rows);
  }
  __syncthreads();

  // ---- 2. h2 = relu(3x3(h1) + b2): 4 m-tiles x 2 column halves ------------
  {
    const int m0 = (warp & 3) * 16, n0 = (warp >> 2) * n_half;
    float acc[NT][4];
    init_bias<NT>(acc, b2, n0, Ch, lane);
    // This lane's A rows: output pixels m0 + gid and m0 + gid + 8.
    const int p0 = m0 + gid, p8 = p0 + 8;
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      const float* a0 = h1 + ((p0 / kTile + dy) * kHalo + p0 % kTile + dx) * ld;
      const float* a8 = h1 + ((p8 / kTile + dy) * kHalo + p8 % kTile + dx) * ld;
      const float* wt = w2 + (long long)tap * Ch * Ch;
      for (int c0 = 0; c0 < ch8; c0 += 8)
        mma_k8<NT, kF32, kF32>(acc, a0 + c0, a8 + c0, wt, Ch, c0, Ch, n0, Ch, lane);
    }
    store_relu<T, NT>(acc, h2, ld, m0, n0, Ch, ch8, lane, TileRows{});
  }
  __syncthreads();

  // ---- 3. out = x + h2 @ w3 + b3: 4 m-tiles, column passes of 8 NT ---------
  {
    const int m0 = (warp & 3) * 16;
    const int tig = lane & 3;
    const float* a0 = h2 + (m0 + gid) * ld;
    const float* a8 = a0 + 8 * ld;
    for (int n0 = (warp >> 2) * 8 * NT; n0 < C; n0 += 16 * NT) {
      float acc[NT][4];
      init_bias<NT>(acc, b3, n0, C, lane);
      for (int c0 = 0; c0 < ch8; c0 += 8)
        mma_k8<NT, kF32, kF32>(acc, a0 + c0, a8 + c0, w3, C, c0, Ch, n0, C, lane);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = m0 + gid + 8 * half;
        const int gy = y0 + p / kTile, gx = x0 + p % kTile;
        if (gy >= H || gx >= W) continue;
        const long long base = ((long long)gy * W + gx) * C;
#pragma unroll
        for (int tt = 0; tt < NT; ++tt) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int n = n0 + 8 * tt + 2 * tig + j;
            if (n < C)
              store(out + (long long)b * H * W * C + base + n,
                    to_f32(xb[base + n]) + round_to<T>(acc[tt][2 * half + j]));
          }
        }
      }
    }
  }
}

template <typename T, int RN>
int launch_rn(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
              const void* w3, const void* b3, void* out, int B, int H, int W, int C, int Ch,
              cudaStream_t stream) {
  const int tiles_h = (H + kTile - 1) / kTile, tiles_w = (W + kTile - 1) / kTile;
  const long long blocks = (long long)B * tiles_h * tiles_w;
  const size_t bytes = sizeof(float) * (size_t)smem_floats(Ch);
  cudaError_t err = cudaFuncSetAttribute(resblock_kernel<T, RN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  resblock_kernel<T, RN><<<(unsigned)blocks, kThreads, bytes, stream>>>(
      (const T*)x, (const float*)w1, (const float*)b1, (const float*)w2, (const float*)b2,
      (const float*)w3, (const float*)b3, (T*)out, H, W, C, Ch, tiles_w, tiles_h);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
           const void* w3, const void* b3, void* out, int B, int H, int W, int C, int Ch,
           void* stream_ptr) {
  if ((long long)B * H * W == 0) return 0;
  if (Ch < 1 || Ch > 32 * kMaxRN || C < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  // RN = ceil(Ch / 32): a warp's columns in phases 1-2 are 16 RN >= Ch / 2.
  switch ((Ch + 31) / 32) {
    case 1: return launch_rn<T, 1>(x, w1, b1, w2, b2, w3, b3, out, B, H, W, C, Ch, stream);
    case 2: return launch_rn<T, 2>(x, w1, b1, w2, b2, w3, b3, out, B, H, W, C, Ch, stream);
    case 3: return launch_rn<T, 3>(x, w1, b1, w2, b2, w3, b3, out, B, H, W, C, Ch, stream);
    case 4: return launch_rn<T, 4>(x, w1, b1, w2, b2, w3, b3, out, B, H, W, C, Ch, stream);
    default: return launch_rn<T, 5>(x, w1, b1, w2, b2, w3, b3, out, B, H, W, C, Ch, stream);
  }
}

}  // namespace

extern "C" int rb_block_f32(const void* x, const void* w1, const void* b1, const void* w2,
                            const void* b2, const void* w3, const void* b3, void* out, int B,
                            int H, int W, int C, int Ch, void* stream) {
  return launch<float>(x, w1, b1, w2, b2, w3, b3, out, B, H, W, C, Ch, stream);
}

extern "C" int rb_block_bf16(const void* x, const void* w1, const void* b1, const void* w2,
                             const void* b2, const void* w3, const void* b3, void* out, int B,
                             int H, int W, int C, int Ch, void* stream) {
  return launch<__nv_bfloat16>(x, w1, b1, w2, b2, w3, b3, out, B, H, W, C, Ch, stream);
}
