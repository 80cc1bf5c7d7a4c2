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
//   x [B, H, W, C]          float32 or bfloat16
//   out [B, H, P, C]        x's type; pixel (y, x) at column x + off of a
//                           row of P >= W + off pixels (P = W, off = 0: the
//                           dense [B, H, W, C]; the chain's keep_pad output
//                           is P = W + 2N, off = N). Other columns untouched.
//   wp                      float32: w1 [C, Ch], w2 [3, 3, Ch, Ch] and
//                           w3 [Ch, C], rounded to x's type, packed by the
//                           wrapper into slabs (below)
//   b1 [Ch], b2 [Ch], b3 [C] float32 (never rounded)
//
// Rounding, as the Pallas kernels: float32 products and sums, float32 biases;
// in the bfloat16 instantiation h1 and h2 are rounded to bfloat16 after bias
// and relu (stored as float), and h3 after its bias, before the residual add.
//
// Bound on the H100: operations. A block does 2 (C Ch + 9 Ch^2 + Ch C) FLOP
// per pixel (239,616 at C=192) against 2 C element moves. Float32 takes
// 3xTF32 (below): three TF32 MMAs per product, so its ceiling is a third of
// the 495 TFLOP/s TF32 peak; bfloat16 x, its weights and the rounded h1 and
// h2 are exact in TF32, so bf16 takes one MMA per product (989 TFLOP/s is
// the bf16 MMAs' peak, which this kernel does not use yet). At B=8 128x128
// C=192 N=3 that is 0.567 ms (f32) and 0.095 ms (bf16).
//
// Design: one CTA per 8x8 output tile, 256 threads (8 warps), 2 CTAs per
// SM up to Ch = 96. The three convolutions are GEMMs on the tensor cores
// (mma.sync m16n8k8 TF32):
//   1. h1 = relu(x @ w1 + b1) over the 10x10 halo tile (M = 100, padded to
//      112), into shared memory. h1 is 0 at pixels outside the image: SAME
//      zero padding of the 3x3 applies to h1, and relu(b1) != 0 there, so x
//      must not simply be zero-padded. Each warp runs 3-4 units of 16 rows
//      by 8 RN columns in one column quarter, so one B fragment feeds them.
//   2. h2 = relu(3x3(h1) + b2) over the 8x8 tile (M = 64, K = 9 Ch, the A
//      rows gathered from h1 per tap), into shared memory.
//   3. out = x + h2 @ w3 + b3, written once, in column passes of 32 RN.
// In phases 2 and 3 each warp owns 16 rows by 16 RN columns.
//
// What held the first version of this kernel back was its B operand: every
// warp read its weight fragments from L2 with scalar loads, so each weight
// crossed into the SM once per warp using it (4-7 times per tile), and x
// was staged with plain loads between two barriers. Here:
//   - Weights come once per CTA through shared memory. The wrapper packs the
//     three matrices into one stream of slabs of 32 k-rows, each row padded
//     to ldn = 32 RN + 8 floats (8 mod 32: a B fragment's 4 k-rows x 8
//     columns hit 32 banks) and zero past the matrix, so a slab is one
//     contiguous copy and no fragment needs a bounds check.
//     Phase 3's w3 is stored per column pass. A ring of kStages slabs is
//     filled by 16-byte cp.async.cg: two slabs are in flight while the warps
//     multiply a third, across phase boundaries too; cp.async.wait_group and
//     one barrier per slab guard each stage.
//   - x comes the same way: each 32-channel slab of the halo tile rides in
//     its weight slab's cp.async group into a ring of its own, in x's type,
//     laid over h1 and h2 (phase 1 writes h1 only after its last x slab).
//     Pixels outside the image are zero-filled (src-size 0). Where C *
//     sizeof(T) is not a multiple of 16 bytes, x slabs are loaded with plain
//     loads instead, two slabs ahead.
//   - A fragments come by scalar loads from rows padded to 4 mod 8 floats
//     (h1, h2: Ch rounded to 8, plus 4; x: 36 floats or 40 bfloat16), so
//     they are free of bank conflicts. Loading A and B by ldmatrix measured
//     slower in float32 at the flagship's shapes and was left out.
//   - The TF32 hi/lo split of a weight happens at fragment load, from shared
//     memory, as it did from L2. Weights split once by the wrapper would
//     double the ring's bytes, and the ring would no longer leave room for 2
//     CTAs per SM.
//   - A 16x8 output tile (half the weight bytes per pixel, 1 CTA of 16 warps
//     per SM) measured slower at the flagship's shapes and was left out.
// Float32 accuracy with TF32 tensor cores: every operand is split into a
// TF32 head and a TF32 tail, and a*b = ah*bh + ah*bl + al*bh (3xTF32; the
// dropped al*bl is below float32 rounding), summed per k-step into a fresh
// tile that is added to the float32 accumulator. What bounds it now is that
// fragment work (the splits and adds, not the MMAs: with the MMAs replaced
// by adds the kernel still takes 80% of its time). The whole chain in one
// launch, bf16 MMAs (m16n8k16) and wgmma are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kSlabK = 32;  // rows of a weight slab; channels of an x slab
constexpr int kStages = 3;  // slabs in each ring: two in flight while one is used

constexpr int kTile = 8;                                // output tile: 8 x 8 pixels
constexpr int kHalo = kTile + 2;
constexpr int kHaloPix = kHalo * kHalo;                 // 100
constexpr int kHaloMt = (kHaloPix + 15) / 16;           // 7 m-tiles of 16
constexpr int kHaloRows = 16 * kHaloMt;                 // 112
constexpr int kPix = kTile * kTile;                     // 64
constexpr int kMt = kPix / 16;                          // 4
constexpr int kWarps = 2 * kMt;                         // 8
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
// v rounded to T and back: the identity for float, one bfloat16 rounding for bfloat16.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// Row stride of h1 and h2: Ch rounded up to 8 (a k-step), plus 4 (banks).
__host__ __device__ inline int h_ld(int ch) { return ((ch + 7) & ~7) + 4; }
// Row stride of the x ring, in elements of T (16-byte rows, conflict-free A loads).
template <typename T> __host__ __device__ constexpr int x_ld() {
  return sizeof(T) == 4 ? 36 : 40;
}

struct Slabs {  // the packed weight stream: phase 1, phase 2, then phase 3 pass by pass
  int s1, s2, s3, passes, total;
  __host__ __device__ Slabs(int c, int ch, int rn) {
    const int ch8 = (ch + 7) & ~7;
    s1 = (c + kSlabK - 1) / kSlabK;
    s2 = (9 * ch8 + kSlabK - 1) / kSlabK;
    s3 = (ch8 + kSlabK - 1) / kSlabK;
    passes = (c + 32 * rn - 1) / (32 * rn);
    total = s1 + s2 + passes * s3;
  }
};

// Shared memory: h1 and h2, with the x ring over them (phase 1 writes h1
// only after its last x slab), then the weight ring.
template <typename T>
__host__ __device__ inline int h_x_floats(int ch) {
  const int h = (kHaloPix + kPix) * h_ld(ch);
  const int xr = kStages * kHaloRows * x_ld<T>() * (int)sizeof(T) / 4;
  return h > xr ? h : xr;
}

template <typename T, int RN>
__host__ __device__ inline int smem_floats(int ch) {
  return h_x_floats<T>(ch) + kStages * kSlabK * (32 * RN + 8);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// 16 bytes global -> shared, bypassing L1; src_bytes < 16 zero-fills the rest.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;"); }
// Wait until at most kStages - 2 of this thread's groups are pending.
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kStages - 2) : "memory");
}

// x = hi + lo with hi rounded to TF32 (10 mantissa bits, nearest, ties away)
// by integer ops, and lo = x - hi exact in float32; the tensor core reads
// only lo's top 10 mantissa bits, which leaves an error below 2^-21 |x|.
// (cvt.rna.tf32.f32 would round the same, at a quarter of the issue rate.)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// Head (and, with kTail, tail) of v; without kTail v is exact in TF32.
template <bool kTail>
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  if (kTail) {
    split_tf32(v, hi, lo);
  } else {
    hi = __float_as_uint(v);
  }
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of one k-step: rows gid and gid + 8 (a0, a8 at the k-step's
// first column), columns tig and tig + 4.
template <bool kTail, typename TA>
struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ FragA(const TA* a0, const TA* a8, int tig) {
    split<kTail>(to_f32(a0[tig]), hi[0], lo[0]);
    split<kTail>(to_f32(a8[tig]), hi[1], lo[1]);
    split<kTail>(to_f32(a0[tig + 4]), hi[2], lo[2]);
    split<kTail>(to_f32(a8[tig + 4]), hi[3], lo[3]);
  }
};

// B fragments of one k-step for NT n-tiles of 8, from a ring slab: w points
// at the k-step's first row and the warp's first column; rows LDN apart.
template <int NT, int LDN, bool kTail>
struct FragB {
  uint32_t hi[NT][2], lo[NT][2];
  __device__ __forceinline__ FragB(const float* w, int lane) {
    const float* p = w + (lane & 3) * LDN + (lane >> 2);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      split<kTail>(p[8 * t], hi[t][0], lo[t][0]);
      split<kTail>(p[4 * LDN + 8 * t], hi[t][1], lo[t][1]);
    }
  }
};

// d = A @ B with C = 0 (one zero register, not a zeroed tile).
__device__ __forceinline__ void mma_tf32_fresh(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%10,%10,%10,%10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// acc += A[16, 8] @ W[8, 8 NT] for one k-step. Float32 (kTail): 3xTF32,
// summed into a fresh tile that is added to acc in float32. The tensor core
// rounds its sums toward zero, and the float32 add (round to nearest) keeps
// the bias of that rounding from growing with K (without it the float32 error
// was 14x larger). bfloat16: every product is exact in one TF32 MMA, which
// accumulates into acc directly: the truncation's bias over K <= 9 Ch (below
// 2^-15 of the sum of |terms| at Ch = 160) is far under the bfloat16 rounding
// of h1, h2 and h3. The MMAs go out tile after tile, so that no MMA waits
// on the one before it.
template <int NT, bool kTail, typename TA, int LDN>
__device__ __forceinline__ void mma_k8(float (&acc)[NT][4], const FragA<kTail, TA>& a,
                                       const FragB<NT, LDN, kTail>& b) {
  if (kTail) {
    float d[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t) mma_tf32_fresh(d[t], a.lo, b.hi[t][0], b.hi[t][1]);
#pragma unroll
    for (int t = 0; t < NT; ++t) mma_tf32(d[t], a.hi, b.lo[t][0], b.lo[t][1]);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      mma_tf32(d[t], a.hi, b.hi[t][0], b.hi[t][1]);
      acc[t][0] += d[t][0];
      acc[t][1] += d[t][1];
      acc[t][2] += d[t][2];
      acc[t][3] += d[t][3];
    }
  } else {
#pragma unroll
    for (int t = 0; t < NT; ++t) mma_tf32(acc[t], a.hi, b.hi[t][0], b.hi[t][1]);
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

struct TileRows {  // rows of the output tile: all stored
  __device__ bool valid(int) const { return true; }
  __device__ bool operator()(int) const { return true; }
};

template <typename T, int RN>
__global__ void __launch_bounds__(kThreads, RN <= 3 ? 2 : 1)
resblock_kernel(const T* __restrict__ x, const float* __restrict__ wp,
                const float* __restrict__ b1, const float* __restrict__ b2,
                const float* __restrict__ b3, T* __restrict__ out, int H, int W, int C,
                int Ch, int out_pitch, int out_off, int tiles_w, int tiles_h, bool x_async) {
  constexpr int NT = 2 * RN;            // n-tiles of 8 per warp: 16 RN >= Ch / 2
  constexpr int kLdn = 32 * RN + 8;     // weight slab row: 32 RN columns + 8 (banks)
  constexpr int kWSlab = kSlabK * kLdn;  // floats
  constexpr int kXLd = x_ld<T>();
  constexpr int kXSlab = kHaloRows * kXLd;  // elements of T
  constexpr bool kF32 = sizeof(T) == sizeof(float);  // else bf16: x, w, h1, h2 exact in TF32
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ld = h_ld(Ch);
  const int ch8 = (Ch + 7) & ~7;
  float* h1 = smem;                        // [kHaloPix][ld]
  float* h2 = smem + kHaloPix * ld;        // [kPix][ld]
  T* xring = reinterpret_cast<T*>(smem);   // [kStages][kHaloRows][kXLd], phase 1 only
  float* wring = smem + h_x_floats<T>(Ch);  // [kStages][kSlabK][kLdn]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  int t = blockIdx.x;
  const int tx = t % tiles_w;
  t /= tiles_w;
  const int ty = t % tiles_h;
  const int b = t / tiles_h;
  const int y0 = ty * kTile, x0 = tx * kTile;
  const T* xb = x + (long long)b * H * W * C;
  const Slabs slabs(C, Ch, RN);

  // Slab s of x: channels 32 s .. 32 s + 31 of the halo tile, 0 outside.
  auto load_x = [&](int s) {
    T* dst = xring + (s % kStages) * kXSlab;
    const int c0 = s * kSlabK;
    if (x_async) {
      constexpr int kVec = 16 / sizeof(T), kChunks = kSlabK / kVec;
      for (int e = threadIdx.x; e < kHaloRows * kChunks; e += kThreads) {
        const int p = e / kChunks, c = c0 + (e % kChunks) * kVec;
        const int gy = y0 - 1 + p / kHalo, gx = x0 - 1 + p % kHalo;
        const bool in = p < kHaloPix && gy >= 0 && gy < H && gx >= 0 && gx < W && c < C;
        cp_async16(dst + p * kXLd + c - c0, in ? xb + ((long long)gy * W + gx) * C + c : xb,
                   in ? 16 : 0);
      }
    } else {
      for (int e = threadIdx.x; e < kHaloRows * kSlabK; e += kThreads) {
        const int p = e / kSlabK, c = c0 + e % kSlabK;
        const int gy = y0 - 1 + p / kHalo, gx = x0 - 1 + p % kHalo;
        const bool in = p < kHaloPix && gy >= 0 && gy < H && gx >= 0 && gx < W && c < C;
        dst[p * kXLd + c - c0] = in ? xb[((long long)gy * W + gx) * C + c] : from_f32<T>(0.f);
      }
    }
  };
  // Start copying slab s of the stream (and of x in phase 1) into ring stage
  // s % kStages, as one cp.async group (empty past the stream's end, so that
  // every thread counts the same groups).
  auto fetch = [&](int s) {
    if (s < slabs.total) {
      float* dst = wring + (s % kStages) * kWSlab;
      const float* src = wp + (long long)s * kWSlab;
      for (int i = threadIdx.x; i < kWSlab / 4; i += kThreads)
        cp_async16(dst + 4 * i, src + 4 * i);
      if (s < slabs.s1) load_x(s);
    }
    cp_async_commit();
  };
  // Wait for slab g, then start slab g + kStages - 1 into the stage slab
  // g - 1 used (the barrier shows every warp is done with it); return slab
  // g's stage.
  int g = 0;
  auto next_slab = [&]() -> const float* {
    cp_async_wait_ring();
    __syncthreads();
    fetch(g + kStages - 1);
    return wring + (g % kStages) * kWSlab;
  };
  for (int s = 0; s < kStages - 1; ++s) fetch(s);

  const int n_half = 16 * RN;  // columns per warp in phases 2 and 3

  // ---- 1. h1 over the halo tile: kHaloMt m-tiles x 4 column quarters -----
  {
    // Unit u: m-tile u >> 2, column quarter u & 3 (8 RN columns). Warp w runs
    // units w + i kWarps, all in quarter w & 3 (kWarps is a multiple of 4),
    // so one B fragment feeds every unit of the warp.
    constexpr int kUnits = 4 * kHaloMt;
    constexpr int kU = (kUnits + kWarps - 1) / kWarps;  // 4
    const int n0 = (warp & 3) * 8 * RN;
    float acc[kU][RN][4];
#pragma unroll
    for (int i = 0; i < kU; ++i) init_bias<RN>(acc[i], b1, n0, Ch, lane);
    for (int s = 0; s < slabs.s1; ++s, ++g) {
      const float* w = next_slab() + n0;
      const T* xs = xring + (s % kStages) * kXSlab + gid * kXLd;
#pragma unroll
      for (int ks = 0; ks < kSlabK; ks += 8) {  // channels past C are 0 in x and w1
        const FragB<RN, kLdn, kF32> fb(w + ks * kLdn, lane);
#pragma unroll
        for (int i = 0; i < kU; ++i) {
          const int u = warp + i * kWarps;
          if (u >= kUnits) break;
          const T* r = xs + (u >> 2) * 16 * kXLd + ks;
          mma_k8(acc[i], FragA<kF32, T>(r, r + 8 * kXLd, tig), fb);
        }
      }
    }
    __syncthreads();  // every warp is done with the x ring, which h1 overlays
    const HaloRows rows{y0, x0, H, W};
#pragma unroll
    for (int i = 0; i < kU; ++i) {
      const int u = warp + i * kWarps;
      if (u < kUnits) store_relu<T, RN>(acc[i], h1, ld, (u >> 2) * 16, n0, Ch, ch8, lane, rows);
    }
  }

  // ---- 2. h2 = relu(3x3(h1) + b2): kMt m-tiles x 2 column halves ----------
  // K runs over (tap, channel) as the packed w2 rows do: tap * ch8 + c. Every
  // slab takes 4 k-steps: those past 9 ch8 repeat the last A columns against
  // zero rows of w2, so that no k-step needs a branch.
  const int m0 = (warp % kMt) * 16, col_half = warp / kMt;
  {
    const int n0 = col_half * n_half;
    float acc[NT][4];
    init_bias<NT>(acc, b2, n0, Ch, lane);
    // This lane's A rows: output pixels m0 + gid and m0 + gid + 8.
    const int p0 = m0 + gid, p8 = p0 + 8;
    const float* a0 = h1 + ((p0 / 8) * kHalo + p0 % 8) * ld;
    const float* a8 = h1 + ((p8 / 8) * kHalo + p8 % 8) * ld;
    const int ksteps = 9 * ch8 / 8;
    int kstep = 0, tap = 0, c = 0, tap_off = 0;  // the next k-step's tap and channel
    for (int s = 0; s < slabs.s2; ++s, ++g) {
      const float* w = next_slab() + n0;
#pragma unroll
      for (int ks = 0; ks < kSlabK; ks += 8) {
        const int off = tap_off + c;
        mma_k8(acc, FragA<kF32, float>(a0 + off, a8 + off, tig),
               FragB<NT, kLdn, kF32>(w + ks * kLdn, lane));
        if (++kstep < ksteps && (c += 8) == ch8) {
          c = 0;
          ++tap;
          tap_off = ((tap / 3) * kHalo + tap % 3) * ld;
        }
      }
    }
    store_relu<T, NT>(acc, h2, ld, m0, n0, Ch, ch8, lane, TileRows{});
  }

  // ---- 3. out = x + h2 @ w3 + b3: column passes of 32 RN ------------------
  {
    const float* a0 = h2 + (m0 + gid) * ld;
    const float* a8 = a0 + 8 * ld;
    for (int pass = 0; pass < slabs.passes; ++pass) {
      const int n0 = pass * 32 * RN + col_half * n_half;
      float acc[NT][4];
      init_bias<NT>(acc, b3, n0, C, lane);
      for (int s = 0; s < slabs.s3; ++s, ++g) {
        const float* w = next_slab() + col_half * n_half;
#pragma unroll
        for (int ks = 0; ks < kSlabK; ks += 8) {
          // Past ch8: the last A columns again, against zero rows of w3.
          const int c = min(s * kSlabK + ks, ch8 - 8);
          mma_k8(acc, FragA<kF32, float>(a0 + c, a8 + c, tig),
                 FragB<NT, kLdn, kF32>(w + ks * kLdn, lane));
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = m0 + gid + 8 * half;
        const int gy = y0 + p / 8, gx = x0 + p % 8;
        if (gy >= H || gx >= W) continue;
        // The residual is read from dense x; only the store takes the pitch.
        const long long base = ((long long)gy * W + gx) * C;
        const long long obase = (((long long)b * H + gy) * out_pitch + out_off + gx) * C;
#pragma unroll
        for (int tt = 0; tt < NT; ++tt) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int n = n0 + 8 * tt + 2 * tig + j;
            if (n < C)
              out[obase + n] =
                  from_f32<T>(to_f32(xb[base + n]) + round_to<T>(acc[tt][2 * half + j]));
          }
        }
      }
    }
  }
}

template <typename T, int RN>
int launch_rn(const void* x, const void* wp, const void* b1, const void* b2, const void* b3,
              void* out, int B, int H, int W, int C, int Ch, int out_pitch, int out_off,
              cudaStream_t stream) {
  const int tiles_h = (H + kTile - 1) / kTile, tiles_w = (W + kTile - 1) / kTile;
  const long long blocks = (long long)B * tiles_h * tiles_w;
  const size_t bytes = sizeof(float) * (size_t)smem_floats<T, RN>(Ch);
  cudaError_t err = cudaFuncSetAttribute(resblock_kernel<T, RN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const bool x_async = (C * sizeof(T)) % 16 == 0 && (uintptr_t)x % 16 == 0;
  resblock_kernel<T, RN><<<(unsigned)blocks, kThreads, bytes, stream>>>(
      (const T*)x, (const float*)wp, (const float*)b1, (const float*)b2, (const float*)b3,
      (T*)out, H, W, C, Ch, out_pitch, out_off, tiles_w, tiles_h, x_async);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* wp, const void* b1, const void* b2, const void* b3,
           void* out, int B, int H, int W, int C, int Ch, int out_pitch, int out_off,
           void* stream_ptr) {
  if (out_off < 0 || (long long)out_pitch < (long long)W + out_off)
    return (int)cudaErrorInvalidValue;  // refused, never clamped
  if ((long long)B * H * W == 0) return 0;
  if (Ch < 1 || Ch > 160 || C < 1 || (uintptr_t)wp % 16 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  // RN = ceil(Ch / 32): a warp's columns in phases 2 and 3 are 16 RN >= Ch / 2.
  switch ((Ch + 31) / 32) {
    case 1: return launch_rn<T, 1>(x, wp, b1, b2, b3, out, B, H, W, C, Ch, out_pitch,
                                   out_off, stream);
    case 2: return launch_rn<T, 2>(x, wp, b1, b2, b3, out, B, H, W, C, Ch, out_pitch,
                                   out_off, stream);
    case 3: return launch_rn<T, 3>(x, wp, b1, b2, b3, out, B, H, W, C, Ch, out_pitch,
                                   out_off, stream);
    case 4: return launch_rn<T, 4>(x, wp, b1, b2, b3, out, B, H, W, C, Ch, out_pitch,
                                   out_off, stream);
    default: return launch_rn<T, 5>(x, wp, b1, b2, b3, out, B, H, W, C, Ch, out_pitch,
                                    out_off, stream);
  }
}

}  // namespace

extern "C" int rb_block_f32(const void* x, const void* wp, const void* b1, const void* b2,
                            const void* b3, void* out, int B, int H, int W, int C, int Ch,
                            int out_pitch, int out_off, void* stream) {
  return launch<float>(x, wp, b1, b2, b3, out, B, H, W, C, Ch, out_pitch, out_off, stream);
}

extern "C" int rb_block_bf16(const void* x, const void* wp, const void* b1, const void* b2,
                             const void* b3, void* out, int B, int H, int W, int C, int Ch,
                             int out_pitch, int out_off, void* stream) {
  return launch<__nv_bfloat16>(x, wp, b1, b2, b3, out, B, H, W, C, Ch, out_pitch, out_off,
                               stream);
}
