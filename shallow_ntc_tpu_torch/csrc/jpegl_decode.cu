// JPEG-like decode at kernel_size == strides on Hopper: every latent vector
// maps to its own k x k x c_out patch of the image,
//
//   out[b, h_l k + r, w_l k + rc, co] = bias[co] + sum_c z[b, h_l, w_l, c] Wt[n, c],
//   n = (r k + rc) c_out + co,  Wt[n, c] = kernel[k-1-r, k-1-rc, c, co].
//
// Replaces the TPU kernel shallow_ntc_tpu/ops/pallas/jpegl_decode.py
// (jpegl_synthesize, _kernel), porting its contract and none of its grid:
// any B, H_l, W_l, C (odd with the offset channel), c_out and k.
//
// Layouts: z [M, C] with M = B H_l W_l (NHWC, C innermost), in T; w
// [k, k, c_out, C], the flax kernel with its last two axes swapped (the
// wrapper's one copy, which also rounds it to T), so Wt's row n is the
// contiguous row w_row(n) of w and the double flip is index arithmetic;
// bias [c_out] float32 or null; out [B, H_l k, W_l k, c_out] in T. As the
// Pallas kernel notes, row h_l k + r of the image is [W_l, k c_out]
// contiguous, so output (m, n) lies at
//   ((m / W_l) k + r) W_l k c_out + (m % W_l) k c_out + (n % (k c_out)),  r = n / (k c_out).
//
// So the op is one GEMM out[m, n] = z[m, :] . Wt[n, :] (both operands
// K-contiguous) with a patch-scattered store. Tiles of 64 latents x 96
// columns, staged through shared memory 16 (f32) or 32 (bf16) channels at a
// time; rows past M and channels past C read as zero, columns past N are
// not stored. The grid's x axis walks M, its y axis N, so B=1 at 32x48
// latents is 24 x 8 = 192 blocks on 132 SMs.
//
//   float32: true float32 products and sums on the CUDA cores (no TF32), a
//            4 x 6 register tile per thread, 256 threads.
//   bfloat16: mma.sync m16n8k16 bf16 x bf16 -> float32 on the tensor cores
//            (products exact, float32 accumulation), a 32 x 48 warp tile, 4
//            warps. Where C % 8 == 0 (the model's C = 320) the tiles come in
//            16-byte loads, the next one fetched into registers while the
//            tensor cores work on this one; odd C (the offset channel) takes
//            2-byte loads. Pairs of outputs go out as one 4-byte store.
// Bias in float32, one rounding to T at the store.
//
// Bound on the H100 (each input read once, the output written once):
// B=8 512x768 bf16 decode moves 27.2 MB (8.1 us at 3.35 TB/s) for 6.04
// GFLOP (6.1 us at 989 TFLOP/s): bytes. B=1 f32 eval does 0.755 GFLOP
// (11.3 us at 67 TFLOP/s off the tensor cores) for 7.67 MB (2.3 us):
// operations. Neither version pipelines through shared memory (one stage,
// two barriers per tile) or gathers its stores into full lines.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;   // latents per block
constexpr int kBN = 96;   // output columns per block

struct Geometry {
  int M, N, C, Wl, k, kc, c_out;  // kc = k c_out: one patch row of one latent
};

// Offset of output (m, n) in the image.
__device__ __forceinline__ long long out_offset(const Geometry& g, int m, int n) {
  const int row = m / g.Wl, wl = m - row * g.Wl;
  const int r = n / g.kc, j = n - r * g.kc;
  return ((long long)row * g.k + r) * g.Wl * g.kc + (long long)wl * g.kc + j;
}

// Row of w [k k c_out, C] that holds Wt's row n: kernel[k-1-r, k-1-rc, :, co].
__device__ __forceinline__ int w_row(const Geometry& g, int n) {
  const int r = n / g.kc, j = n - r * g.kc;
  const int rc = j / g.c_out, co = j - rc * g.c_out;
  return ((g.k - 1 - r) * g.k + (g.k - 1 - rc)) * g.c_out + co;
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// ---- float32: CUDA cores ---------------------------------------------------

constexpr int kF32Threads = 256;
constexpr int kF32K = 16;          // channels per stage
constexpr int kTM = 4, kTN = 6;    // outputs per thread: rows ty + 16 i, columns tx + 16 j

__global__ void __launch_bounds__(kF32Threads)
jpegl_f32_kernel(const float* __restrict__ z, const float* __restrict__ w,
                 const float* __restrict__ bias, float* __restrict__ out, Geometry g) {
  constexpr int kAq = kBM * kF32K / kF32Threads, kBq = kBN * kF32K / kF32Threads;
  __shared__ float As[kF32K][kBM + 1];   // [channel][latent]
  __shared__ float Bs[kF32K][kBN + 1];   // [channel][column]
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;

  // This thread stages channel tx of latent rows ty + 16 q and of columns
  // ty + 16 q (coalesced along each row); -1 marks a row past the end.
  long long a_off[kAq];
  int b_off[kBq];
#pragma unroll
  for (int q = 0; q < kAq; ++q) {
    const int m = m0 + ty + 16 * q;
    a_off[q] = m < g.M ? (long long)m * g.C : -1;
  }
#pragma unroll
  for (int q = 0; q < kBq; ++q) {
    const int n = n0 + ty + 16 * q;
    b_off[q] = n < g.N ? w_row(g, n) * g.C : -1;
  }

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < g.C; k0 += kF32K) {
    const int c = k0 + tx;
#pragma unroll
    for (int q = 0; q < kAq; ++q)
      As[tx][ty + 16 * q] = (a_off[q] >= 0 && c < g.C) ? __ldg(z + a_off[q] + c) : 0.f;
#pragma unroll
    for (int q = 0; q < kBq; ++q)
      Bs[tx][ty + 16 * q] = (b_off[q] >= 0 && c < g.C) ? __ldg(w + b_off[q] + c) : 0.f;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kF32K; ++kk) {
      float a[kTM], b[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    const int n = n0 + tx + 16 * j;
    if (n >= g.N) continue;
    const float bv = bias ? __ldg(bias + n % g.c_out) : 0.f;
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int m = m0 + ty + 16 * i;
      if (m < g.M) out[out_offset(g, m, n)] = acc[i][j] + bv;
    }
  }
}

// ---- bfloat16: tensor cores ----------------------------------------------

constexpr int kBf16Threads = 128;
constexpr int kBf16K = 32;              // channels per stage: two k16 steps
constexpr int kLd = kBf16K + 8;         // 20 words a row: fragment loads hit 32 banks

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <bool kVec>
__global__ void __launch_bounds__(kBf16Threads)
jpegl_bf16_kernel(const __nv_bfloat16* __restrict__ z, const __nv_bfloat16* __restrict__ w,
                  const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, Geometry g) {
  constexpr int kAq = kBM * kBf16K / 8 / kBf16Threads;  // 16-byte chunks per thread: 2
  constexpr int kBq = kBN * kBf16K / 8 / kBf16Threads;  // 3
  __shared__ __align__(16) __nv_bfloat16 As[kBM][kLd];   // [latent][channel]
  __shared__ __align__(16) __nv_bfloat16 Bs[kBN][kLd];   // [column][channel]
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = (warp & 1) * 32, wn = (warp >> 1) * 48;  // the warp's 32 x 48 tile
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  // Vector path: this thread stages channels vch .. vch+7 of latent rows and
  // columns vrow + 32 q; null marks a row past the end.
  const int vrow = tid >> 2, vch = (tid & 3) * 8;
  const __nv_bfloat16* a_src[kAq];
  const __nv_bfloat16* b_src[kBq];
  uint4 a_reg[kAq], b_reg[kBq];
  auto fetch = [&](int k0) {
    const bool in_c = k0 + vch < g.C;
#pragma unroll
    for (int q = 0; q < kAq; ++q)
      a_reg[q] = (a_src[q] && in_c) ? __ldg(reinterpret_cast<const uint4*>(a_src[q] + k0))
                                    : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int q = 0; q < kBq; ++q)
      b_reg[q] = (b_src[q] && in_c) ? __ldg(reinterpret_cast<const uint4*>(b_src[q] + k0))
                                    : make_uint4(0, 0, 0, 0);
  };
  if constexpr (kVec) {
#pragma unroll
    for (int q = 0; q < kAq; ++q) {
      const int m = m0 + vrow + 32 * q;
      a_src[q] = m < g.M ? z + (long long)m * g.C + vch : nullptr;
    }
#pragma unroll
    for (int q = 0; q < kBq; ++q) {
      const int n = n0 + vrow + 32 * q;
      b_src[q] = n < g.N ? w + (long long)w_row(g, n) * g.C + vch : nullptr;
    }
    fetch(0);
  }

  float acc[2][6][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int t = 0; t < 6; ++t) acc[i][t][0] = acc[i][t][1] = acc[i][t][2] = acc[i][t][3] = 0.f;

  for (int k0 = 0; k0 < g.C; k0 += kBf16K) {
    if constexpr (kVec) {
#pragma unroll
      for (int q = 0; q < kAq; ++q)
        *reinterpret_cast<uint4*>(&As[vrow + 32 * q][vch]) = a_reg[q];
#pragma unroll
      for (int q = 0; q < kBq; ++q)
        *reinterpret_cast<uint4*>(&Bs[vrow + 32 * q][vch]) = b_reg[q];
    } else {
      const int kk = tid & 31, c = k0 + kk;
#pragma unroll 4
      for (int mm = tid >> 5; mm < kBM; mm += 4) {
        const int m = m0 + mm;
        As[mm][kk] = (m < g.M && c < g.C) ? z[(long long)m * g.C + c] : zero;
      }
#pragma unroll 4
      for (int nn = tid >> 5; nn < kBN; nn += 4) {
        const int n = n0 + nn;
        Bs[nn][kk] = (n < g.N && c < g.C) ? w[(long long)w_row(g, n) * g.C + c] : zero;
      }
    }
    __syncthreads();
    if constexpr (kVec) {
      if (k0 + kBf16K < g.C) fetch(k0 + kBf16K);  // in flight while the MMAs run
    }
#pragma unroll
    for (int ks = 0; ks < kBf16K; ks += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const __nv_bfloat16* r0 = &As[wm + 16 * i + gid][ks + 2 * tig];
        const __nv_bfloat16* r8 = &As[wm + 16 * i + gid + 8][ks + 2 * tig];
        a[i][0] = ld32(r0);
        a[i][1] = ld32(r8);
        a[i][2] = ld32(r0 + 8);
        a[i][3] = ld32(r8 + 8);
      }
#pragma unroll
      for (int t = 0; t < 6; ++t) {
        const __nv_bfloat16* col = &Bs[wn + 8 * t + gid][ks + 2 * tig];
        const uint32_t b0 = ld32(col), b1 = ld32(col + 8);
        mma_bf16(acc[0][t], a[0], b0, b1);
        mma_bf16(acc[1][t], a[1], b0, b1);
      }
    }
    __syncthreads();
  }

  // This lane holds columns n, n+1 (n even) of rows gid and gid + 8 of each
  // m16 tile. With k c_out even, n and n+1 lie side by side in one patch
  // row at an even offset: one 4-byte store.
  const bool pairs = (g.kc & 1) == 0;
#pragma unroll
  for (int t = 0; t < 6; ++t) {
    const int n = n0 + wn + 8 * t + 2 * tig;
    if (n >= g.N) continue;
    const float bv0 = bias ? __ldg(bias + n % g.c_out) : 0.f;
    const float bv1 = bias && n + 1 < g.N ? __ldg(bias + (n + 1) % g.c_out) : 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + wm + 16 * i + gid + 8 * half;
        if (m >= g.M) continue;
        const float v0 = acc[i][t][2 * half] + bv0, v1 = acc[i][t][2 * half + 1] + bv1;
        if (pairs) {
          *reinterpret_cast<__nv_bfloat162*>(out + out_offset(g, m, n)) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          store(out + out_offset(g, m, n), v0);
          if (n + 1 < g.N) store(out + out_offset(g, m, n + 1), v1);
        }
      }
    }
  }
}

template <typename T>
int launch(const void* z, const void* w, const void* bias, void* out, int B, int Hl, int Wl,
           int C, int c_out, int k, void* stream_ptr) {
  const long long M = (long long)B * Hl * Wl;
  const long long N = (long long)k * k * c_out;
  if (M == 0) return 0;
  if (C < 1 || c_out < 1 || k < 1 || M > (1LL << 31) - kBM || N > 65535LL * kBN)
    return (int)cudaErrorInvalidValue;
  const Geometry g{(int)M, (int)N, C, Wl, k, k * c_out, c_out};
  const dim3 grid((unsigned)((M + kBM - 1) / kBM), (unsigned)((N + kBN - 1) / kBN));
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const bool vec = C % 8 == 0 && (uintptr_t)z % 16 == 0 && (uintptr_t)w % 16 == 0;
  if (sizeof(T) == sizeof(float))
    jpegl_f32_kernel<<<grid, kF32Threads, 0, stream>>>(
        (const float*)z, (const float*)w, (const float*)bias, (float*)out, g);
  else if (vec)
    jpegl_bf16_kernel<true><<<grid, kBf16Threads, 0, stream>>>(
        (const __nv_bfloat16*)z, (const __nv_bfloat16*)w, (const float*)bias,
        (__nv_bfloat16*)out, g);
  else
    jpegl_bf16_kernel<false><<<grid, kBf16Threads, 0, stream>>>(
        (const __nv_bfloat16*)z, (const __nv_bfloat16*)w, (const float*)bias,
        (__nv_bfloat16*)out, g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int jpegl_synthesize_f32(const void* z, const void* w, const void* bias, void* out,
                                    int B, int Hl, int Wl, int C, int c_out, int k,
                                    void* stream) {
  return launch<float>(z, w, bias, out, B, Hl, Wl, C, c_out, k, stream);
}

extern "C" int jpegl_synthesize_bf16(const void* z, const void* w, const void* bias, void* out,
                                     int B, int Hl, int Wl, int C, int c_out, int k,
                                     void* stream) {
  return launch<__nv_bfloat16>(z, w, bias, out, B, Hl, Wl, C, c_out, k, stream);
}
