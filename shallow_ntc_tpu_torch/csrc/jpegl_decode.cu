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
// Layouts: z [M, C] with M = B H_l W_l (NHWC, C innermost), in T; kernel
// the flax kernel [k, k, C, c_out] as it is, in T (the double flip and the
// transpose are index arithmetic); bias [c_out] in float32 or bfloat16
// (bias_bf16), widened to float32, or null; out [B, H_l k, W_l k, c_out] in
// T. As the Pallas kernel notes, row h_l k + r of the image is [W_l, k c_out]
// contiguous, so output (m, n) lies at
//   ((m / W_l) k + r) W_l k c_out + (m % W_l) k c_out + (n % (k c_out)),  r = n / (k c_out):
// a latent's patch row r is k c_out contiguous values, and the latents of
// one latent row follow each other. So the op is one GEMM
// out[m, n] = z[m, :] . Wt[n, :] (K = C) with a patch-scattered store.
// Float32 products and sums, the bias added in float32, one rounding to T.
//
// Bound on the H100 (each input read once, the output written once): the
// B=8 512x768 bf16 decode (z 32x48x320, k = 16, c_out = 3) moves 27.2 MB,
// 8.1 us at 3.35 TB/s, for 6.04 GFLOP, 6.1 us at 989 TFLOP/s: bytes. The
// B=1 float32 eval does 0.755 GFLOP, 4.6 us at 495/3 TFLOP/s (3xTF32, the
// fastest float32-accurate rate of the card; 11.3 us at the CUDA cores' 67),
// for 7.7 MB, 2.3 us: operations.
//
// Two kernels:
//   jpegl_k16_bf16_kernel, bfloat16 at JPEGL_K16's geometry (C = 320,
//     k = 16, c_out = 3; N = 768), the decode's. Persistent CTAs, one per SM:
//     CTA i owns slice i % 4 of N (4 patch rows, 192 columns) and keeps its
//     weights resident in shared memory (120 KB, gathered from the flax
//     layout once: coalesced loads of the slice's contiguous run, 48-byte
//     units of 8 channels x 3 outputs deinterleaved into 16-byte pieces of
//     rows), then walks the latent tiles i / 4, i / 4 + P, ... (64 latents,
//     P = SMs / 4). z crosses L2 4 times, the weights once per CTA. A tile
//     (40 KB) arrives by 16-byte cp.async into one of two stages while the
//     tensor cores work on the other; rows past M are zero-filled. Rows of
//     640 bytes are XOR-swizzled in 16-byte units by row, so ldmatrix reads
//     free of bank conflicts. mma.sync m16n8k16, 8 warps of 32 latents x 48
//     columns (one patch row), one barrier a tile. Each warp rounds its
//     tile to bf16 into a shared-memory buffer of its own and writes whole
//     patch rows (96 bytes a latent, contiguous across a latent row) by
//     asynchronous bulk copies (cp.async.bulk), so it goes on to the next
//     tile while they drain.
//   jpegl_tiled_kernel<T>, every other case and all of float32: 64 latents x
//     48 columns per CTA, 4 warps of 32 x 24, K in chunks of 32 channels. z
//     and the weights come through one 3-stage ring, two chunks in flight:
//     z by cp.async in 16-byte pieces where a row of z is 16-byte aligned,
//     else 4-byte (float32) or plain loads (bfloat16); the weights gathered
//     by index from the flax layout, element by element (4-byte cp.async in
//     float32). float32 runs as 3xTF32 on the tensor cores (m16n8k8; a*b =
//     ah*bh + ah*bl + al*bh with TF32 heads and tails split from each
//     fragment, float32-accurate: 2.8e-5 at K = 320 against the 9e-4
//     tolerance, so no per-chunk flush), bfloat16 as m16n8k16. Where a
//     tile's 48 columns lie in one patch row (k c_out a multiple of 48, as at
//     K16), the tile is gathered in shared memory and written as 16-byte
//     stores of whole patch rows; else each output goes out alone. At B=1
//     K16 the grid is 24 x 16 = 384 CTAs, about 3 per SM, all resident.
// Measured (scripts/torch_jpegl_bench.py, NVIDIA H100 80GB HBM3, 700 W):
// 0.025 ms at the decode (3.0x its bound), 0.022 ms at B=1 f32 (4.9x).
// In the decode, launch, weight staging and the first tile take 0.005 ms;
// the MMA loop alone would take ~0.011 ms, and ldmatrix, the z copies and
// the bulk stores each add ~0.003 ms that does not overlap it (not through
// the copies' waits: without them it is no faster). Measured no faster and
// left out: 4 warps of 64 x 48 and 16 of 16 x 48; the weights staged in two
// halves of K, the second under the first tile's MMAs; z rows by TMA bulk
// copies into padded rows on an mbarrier; a 4-stage float32 ring; the
// float32 MMAs ordered by product class.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

namespace {

struct Geometry {
  int M, N, C, Wl, k, kc, c_out;  // kc = k c_out: one patch row of one latent
  int rows;                       // tiled kernel: gather each tile into whole patch rows
};

// Offset of output (m, n) in the image.
__device__ __forceinline__ long long out_offset(const Geometry& g, int m, int n) {
  const int row = m / g.Wl, wl = m - row * g.Wl;
  const int r = n / g.kc, j = n - r * g.kc;
  return ((long long)row * g.k + r) * g.Wl * g.kc + (long long)wl * g.kc + j;
}

// Index of Wt[n, 0] = kernel[k-1-r, k-1-rc, 0, co] in the flax kernel;
// channel c is c_out further on per channel.
__device__ __forceinline__ int w_base(const Geometry& g, int n) {
  const int r = n / g.kc, j = n - r * g.kc;
  const int rc = j / g.c_out, co = j - rc * g.c_out;
  return ((g.k - 1 - r) * g.k + (g.k - 1 - rc)) * g.C * g.c_out + co;
}

__device__ __forceinline__ float load_bias(const void* bias, int bias_bf16, int co) {
  if (!bias) return 0.f;
  return bias_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[co])
                   : static_cast<const float*>(bias)[co];
}

template <typename T> __device__ __forceinline__ T from_f32(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Two adjacent outputs, rounded once, as one store.
__device__ __forceinline__ void store_pair(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// P bytes global -> shared; with valid false the destination is zero-filled.
template <int P> __device__ __forceinline__ void copy_piece(void* dst, const void* src,
                                                            bool valid) {
  if constexpr (P == 2) {
    *static_cast<unsigned short*>(dst) =
        valid ? __ldg(static_cast<const unsigned short*>(src)) : (unsigned short)0;
  } else if constexpr (P == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(valid ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(smem_addr(dst)),
                 "l"(src), "n"(P), "r"(valid ? P : 0));
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;"); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Bulk copies shared -> global (cp.async.bulk, Hopper's TMA): 16-byte
// aligned, a multiple of 16 bytes; per-thread groups.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;"); }
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo with hi = x cut to TF32 (its top 10 mantissa bits) and lo = x -
// hi exact in float32, |lo| < 2^-10 |x|; the tensor core reads only lo's top
// 10 mantissa bits, which leaves an error below 2^-20 |x|. (Rounding hi to
// nearest halves that bound and measured 4% slower at the eval shape.)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// ---- the tiled kernel: float32, and bfloat16 off K16 ------------------------

constexpr int kTM = 64;            // latents per CTA
constexpr int kTN = 48;            // columns per CTA
constexpr int kChunk = 32;         // channels per stage
constexpr int kStages = 3;         // z ring
constexpr int kTiledThreads = 128;

template <typename T> struct Tiled {
  // A shared-memory row holds one chunk of a latent (or a column) plus 16
  // bytes: 9 (float32) or 5 (bfloat16) 16-byte units, odd, so the 8 rows of
  // an ldmatrix hit 8 different bank quads.
  static constexpr int kRow = kChunk * (int)sizeof(T) + 16;
  static constexpr int kABytes = kTM * kRow;
  static constexpr int kBBytes = kTN * kRow;
  static constexpr int kSmem = kStages * (kABytes + kBBytes);
  static constexpr int kSteps = kChunk * (int)sizeof(T) / 32;  // MMA k-steps of 32 bytes per chunk
  static constexpr int kOutLd = kTN + 16 / (int)sizeof(T);     // gathered tile row, elements
  static_assert(kTM * kOutLd * (int)sizeof(T) <= kStages * kABytes, "the tile fits the z ring");
};

template <typename T, int P>
__global__ void __launch_bounds__(kTiledThreads)
jpegl_tiled_kernel(const T* __restrict__ z, const T* __restrict__ w,
                   const void* __restrict__ bias, int bias_bf16, T* __restrict__ out,
                   Geometry g) {
  using L = Tiled<T>;
  constexpr bool kF32 = sizeof(T) == 4;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* a_sm = smem;                          // [kStages][kTM][kRow]
  unsigned char* b_sm = smem + kStages * L::kABytes;   // [kStages][kTN][kRow]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int m0 = blockIdx.x * kTM, n0 = blockIdx.y * kTN;
  const int wm = (warp & 1) * 32, wn = (warp >> 1) * 24;  // the warp's 32 x 24 tile
  const int n_chunks = (g.C + kChunk - 1) / kChunk;

  // z: chunk q (channels 32 q ..) into stage s, pieces of P bytes.
  auto load_z = [&](int q, int s) {
    constexpr int kPieces = kChunk * (int)sizeof(T) / P;  // per row
    unsigned char* dst = a_sm + s * L::kABytes;
#pragma unroll
    for (int it = 0; it < kTM * kPieces / kTiledThreads; ++it) {
      const int p = tid + it * kTiledThreads;
      const int row = p / kPieces, piece = p - row * kPieces;
      const int m = m0 + row, c = q * kChunk + piece * P / (int)sizeof(T);
      const bool ok = m < g.M && c < g.C;
      copy_piece<P>(dst + row * L::kRow + piece * P, ok ? z + (long long)m * g.C + c : z, ok);
    }
  };

  // Weights: chunk q into stage s as Wt rows [48][32 channels], gathered
  // from the flax layout element by element (4-byte cp.async in float32,
  // plain loads in bfloat16). This thread takes channel `lane` of columns
  // n0 + warp + 4 j; a warp reads 32 channels of one column, c_out apart.
  constexpr int kBj = kTN * kChunk / kTiledThreads;
  int b_off[kBj];
#pragma unroll
  for (int j = 0; j < kBj; ++j) {
    const int n = n0 + warp + 4 * j;
    b_off[j] = n < g.N ? w_base(g, n) : -1;
  }
  auto load_w = [&](int q, int s) {
    const int c = q * kChunk + lane;
    unsigned char* dst = b_sm + s * L::kBBytes + lane * (int)sizeof(T);
#pragma unroll
    for (int j = 0; j < kBj; ++j) {
      const bool ok = b_off[j] >= 0 && c < g.C;
      copy_piece<(int)sizeof(T)>(dst + (warp + 4 * j) * L::kRow,
                                 ok ? w + b_off[j] + c * g.c_out : w, ok);
    }
  };

  float acc[2][3][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int t = 0; t < 3; ++t) acc[i][t][0] = acc[i][t][1] = acc[i][t][2] = acc[i][t][3] = 0.f;

  // ldmatrix lanes: A rows wm + arow (+16), 16-byte unit lane / 16 of each
  // 32-byte k-step; B rows wn + (lane & 7) + 8 (lane / 16) (n-tiles 0 and 1)
  // and wn + 16 + (lane & 7) (n-tile 2), unit (lane / 8) & 1.
  const int arow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const uint32_t a_lane = smem_addr(a_sm) + (wm + arow) * L::kRow + (lane >> 4) * 16;
  const uint32_t b_lane = smem_addr(b_sm) + ((lane >> 3) & 1) * 16;
  const uint32_t b01 = b_lane + (wn + (lane & 7) + 8 * (lane >> 4)) * L::kRow;
  const uint32_t b2 = b_lane + (wn + 16 + (lane & 7)) * L::kRow;

  // A ring of kStages chunks of z and the weights, two in flight while the
  // tensor cores work on a third; one barrier a chunk.
  load_z(0, 0);
  load_w(0, 0);
  cp_async_commit();
  if (n_chunks > 1) {
    load_z(1, 1);
    load_w(1, 1);
  }
  cp_async_commit();
  for (int q = 0; q < n_chunks; ++q) {
    cp_async_wait<1>();  // this thread's copies of chunk q have landed
    __syncthreads();     // everyone's; and every warp is done with chunk q - 1
    if (q + 2 < n_chunks) {
      load_z(q + 2, (q + 2) % kStages);
      load_w(q + 2, (q + 2) % kStages);
    }
    cp_async_commit();
    const uint32_t a_s = a_lane + (q % kStages) * L::kABytes;
    const uint32_t b_s = (q % kStages) * L::kBBytes;
#pragma unroll
    for (int ks = 0; ks < L::kSteps; ++ks) {
      uint32_t a[2][4], b[3][2];  // b[n-tile][word]
      ldmatrix_x4(a[0], a_s + 32 * ks);
      ldmatrix_x4(a[1], a_s + 16 * L::kRow + 32 * ks);
      {
        uint32_t x4[4], x2[2];
        ldmatrix_x4(x4, b01 + b_s + 32 * ks);
        ldmatrix_x2(x2, b2 + b_s + 32 * ks);
        b[0][0] = x4[0], b[0][1] = x4[1];
        b[1][0] = x4[2], b[1][1] = x4[3];
        b[2][0] = x2[0], b[2][1] = x2[1];
      }
      if constexpr (kF32) {
        uint32_t bh[3][2], bl[3][2];
#pragma unroll
        for (int t = 0; t < 3; ++t)
#pragma unroll
          for (int v = 0; v < 2; ++v) split_tf32(__uint_as_float(b[t][v]), bh[t][v], bl[t][v]);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          uint32_t ah[4], al[4];
#pragma unroll
          for (int v = 0; v < 4; ++v) split_tf32(__uint_as_float(a[i][v]), ah[v], al[v]);
#pragma unroll
          for (int t = 0; t < 3; ++t) {
            mma_tf32(acc[i][t], al, bh[t][0], bh[t][1]);
            mma_tf32(acc[i][t], ah, bl[t][0], bl[t][1]);
            mma_tf32(acc[i][t], ah, bh[t][0], bh[t][1]);
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int t = 0; t < 3; ++t) mma_bf16(acc[i][t], a[i], b[t][0], b[t][1]);
      }
    }
  }

  // This lane holds columns n, n + 1 (n = n0 + wn + 8 t + 2 tig) of rows
  // gid and gid + 8 of each m16 tile.
  float bv[3][2];
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n0 + wn + 8 * t + 2 * tig + e;
      bv[t][e] = n < g.N ? load_bias(bias, bias_bf16, n % g.c_out) : 0.f;
    }
  if (g.rows) {
    // The tile's 48 columns lie in one patch row: gather [64][48] in the z
    // ring (free once every warp is past its last chunk) and write each
    // latent's 48 values as 16-byte stores.
    __syncthreads();
    T* st = reinterpret_cast<T*>(a_sm);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int t = 0; t < 3; ++t)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          store_pair(st + (wm + 16 * i + gid + 8 * half) * L::kOutLd + wn + 8 * t + 2 * tig,
                     acc[i][t][2 * half] + bv[t][0], acc[i][t][2 * half + 1] + bv[t][1]);
    __syncthreads();
    constexpr int kU = kTN * (int)sizeof(T) / 16;  // 16-byte units per latent
    constexpr int kE = 16 / (int)sizeof(T);
#pragma unroll
    for (int it = 0; it < kTM * kU / kTiledThreads; ++it) {
      const int v = tid + it * kTiledThreads;
      const int ml = v / kU, u = v - ml * kU;
      if (m0 + ml < g.M)
        *reinterpret_cast<uint4*>(out + out_offset(g, m0 + ml, n0) + u * kE) =
            *reinterpret_cast<const uint4*>(st + ml * L::kOutLd + u * kE);
    }
  } else {
#pragma unroll
    for (int t = 0; t < 3; ++t)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n0 + wn + 8 * t + 2 * tig + e;
        if (n >= g.N) continue;
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int m = m0 + wm + 16 * i + gid + 8 * half;
            if (m < g.M) out[out_offset(g, m, n)] = from_f32<T>(acc[i][t][2 * half + e] + bv[t][e]);
          }
      }
  }
}

// ---- the K16 bfloat16 kernel: resident weight slice, persistent CTAs --------

namespace k16 {
constexpr int kC = 320, kK = 16, kCo = 3, kKc = kK * kCo;  // kKc = 48
constexpr int kSliceRows = 4;                   // patch rows per slice
constexpr int kSlices = kK / kSliceRows;        // 4
constexpr int kSliceN = kSliceRows * kKc;       // 192 columns
constexpr int kTile = 64;                       // latents per tile
constexpr int kRow = kC * 2;                    // 640 bytes: 40 16-byte units
constexpr int kUnits = kRow / 16;
constexpr int kWarpsM = 2;                      // warps per patch row
constexpr int kWarps = kSliceRows * kWarpsM;    // warp w: patch row w % 4, latents kWM (w / 4) ..
constexpr int kThreads = 32 * kWarps;
constexpr int kWM = kTile / kWarpsM;
constexpr int kMi = kWM / 16;
constexpr int kWBytes = kSliceN * kRow;         // 122,880
constexpr int kZBytes = kTile * kRow;           // 40,960 a stage
constexpr int kOutBytes = kTile * kSliceN * 2;
constexpr int kSmem = kWBytes + 2 * kZBytes + kOutBytes;  // 230,144
static_assert(kUnits % 8 == 0, "the swizzle stays inside a row");
static_assert(kSmem <= 232448, "one CTA per SM");
}  // namespace k16

// Physical 16-byte unit of logical unit u in row `row`.
__device__ __forceinline__ int swz(int u, int row) { return u ^ (row & 7); }

__global__ void __launch_bounds__(k16::kThreads, 1)
jpegl_k16_bf16_kernel(const __nv_bfloat16* __restrict__ z, const __nv_bfloat16* __restrict__ w,
                      const void* __restrict__ bias, int bias_bf16,
                      __nv_bfloat16* __restrict__ out, int M, int Wl, int walkers) {
  using namespace k16;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* w_sm = smem;                              // [192][640 B]
  unsigned char* z_sm = smem + kWBytes;                    // [2][64][640 B]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int slice = blockIdx.x % kSlices, walker = blockIdx.x / kSlices;
  const int n_tiles = (M + kTile - 1) / kTile;
  __nv_bfloat16* o_warp = reinterpret_cast<__nv_bfloat16*>(z_sm + 2 * kZBytes) + warp * kWM * kKc;

  auto load_z = [&](int tile, int s) {
    unsigned char* dst = z_sm + s * kZBytes;
    const int m0 = tile * kTile;
#pragma unroll 4
    for (int it = 0; it < kTile * kUnits / kThreads; ++it) {
      const int u = tid + it * kThreads;
      const int row = u / kUnits, cu = u - row * kUnits;
      const bool ok = m0 + row < M;
      copy_piece<16>(dst + row * kRow + swz(cu, row) * 16,
                     ok ? z + (long long)(m0 + row) * kC + 8 * cu : z, ok);
    }
  };

  if (walker < n_tiles) load_z(walker, 0);
  cp_async_commit();

  // The slice's weights, patch rows r = 4 slice + rl: kernel[15 - r] is
  // [16 (k-1-rc)][320 (c)][3 (co)] contiguous, and the slice's 4 are one
  // contiguous 120 KB run, kernel[12 - 4 slice ..]. A unit is 8 channels x
  // 3 outputs (48 bytes), deinterleaved into 16-byte pieces of Wt rows
  // n = 48 rl + 3 rc + co, channels 8 c8 .. 8 c8 + 7. A warp reads blocks
  // of 32 units (1536 bytes) in 3 coalesced loads, all of a thread's loads
  // before the first store (the whole slice in flight), and hands each lane
  // its unit through a staging buffer in the output buffers.
  {
    constexpr int kPer = kSliceRows * kK * kUnits / kThreads;  // blocks of 32 units a warp
    static_assert(96 * 16 * kWarps <= kOutBytes, "the staging fits the output buffers");
    const uint4* src = reinterpret_cast<const uint4*>(
        w + (kK - kSliceRows * (slice + 1)) * kK * kC * kCo);
    uint4 v[kPer][3];
#pragma unroll
    for (int it = 0; it < kPer; ++it)
#pragma unroll
      for (int q = 0; q < 3; ++q) v[it][q] = __ldg(src + 96 * (it * kWarps + warp) + 32 * q + lane);
    uint4* stage = reinterpret_cast<uint4*>(z_sm + 2 * kZBytes) + 96 * warp;
#pragma unroll
    for (int it = 0; it < kPer; ++it) {
#pragma unroll
      for (int q = 0; q < 3; ++q) stage[32 * q + lane] = v[it][q];
      __syncwarp();
      const uint4 u0 = stage[3 * lane], u1 = stage[3 * lane + 1], u2 = stage[3 * lane + 2];
      __syncwarp();
      // Unit u of the run holds kernel[12 - 4 slice + a, kcol, 8 c8 ..], a = 3 - rl.
      const int u = 32 * (it * kWarps + warp) + lane;
      const int a = u / (kK * kUnits), rem = u - a * (kK * kUnits);
      const int kcol = rem / kUnits, c8 = rem - kcol * kUnits;  // kcol = k-1-rc
      const uint32_t wd[12] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w,
                               u2.x, u2.y, u2.z, u2.w};
      auto e = [&](int i) { return (wd[i >> 1] >> (16 * (i & 1))) & 0xffffu; };  // value 3 cc + co
#pragma unroll
      for (int co = 0; co < kCo; ++co) {
        const int n = (kSliceRows - 1 - a) * kKc + (kK - 1 - kcol) * kCo + co;
        uint4 p;
        p.x = e(co) | (e(co + 3) << 16);
        p.y = e(co + 6) | (e(co + 9) << 16);
        p.z = e(co + 12) | (e(co + 15) << 16);
        p.w = e(co + 18) | (e(co + 21) << 16);
        *reinterpret_cast<uint4*>(w_sm + n * kRow + swz(c8, n) * 16) = p;
      }
    }
  }

  // Warp `warp` computes patch row r = 4 slice + wr, wr = warp % 4 (columns
  // 48 wr .. 48 wr + 47 of the slice), latents wm .. wm + 31 of a tile. This
  // lane holds columns 8 t + 2 tig (+1) of rows gid (+8) of each m16 tile;
  // output channel (8 t + 2 tig + e) % 3.
  float bv[6][2];
#pragma unroll
  for (int t = 0; t < 6; ++t)
#pragma unroll
    for (int e = 0; e < 2; ++e) bv[t][e] = load_bias(bias, bias_bf16, (8 * t + 2 * tig + e) % kCo);
  const int wr = warp % kSliceRows, wm = warp / kSliceRows * kWM;
  const int r = slice * kSliceRows + wr;
  // ldmatrix lanes: A row wm + (lane & 7) + 8 ((lane / 8) & 1) of each m16
  // tile, unit lane / 16 of the k-step; B rows 48 wr + 16 p + (lane & 7) +
  // 8 (lane / 16), unit (lane / 8) & 1. Every row is congruent to lane & 7
  // modulo 8, so the swizzle is lane & 7.
  const int x = lane & 7, a_hi = lane >> 4, b_hi = (lane >> 3) & 1;
  const uint32_t a_lane = (wm + (lane & 7) + ((lane >> 3) & 1) * 8) * kRow;
  const uint32_t b_lane = smem_addr(w_sm) + (kKc * wr + (lane & 7) + 8 * (lane >> 4)) * kRow;

  for (int i = 0;; ++i) {
    const int tile = walker + i * walkers;
    if (tile >= n_tiles) break;
    cp_async_wait<0>();  // tile i has landed in stage i & 1
    __syncthreads();     // for every thread; stage (i + 1) & 1 is free (tile i - 1 done)
    if (tile + walkers < n_tiles) load_z(tile + walkers, (i + 1) & 1);
    cp_async_commit();

    float acc[kMi][6][4];
#pragma unroll
    for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
      for (int t = 0; t < 6; ++t)
        acc[mi][t][0] = acc[mi][t][1] = acc[mi][t][2] = acc[mi][t][3] = 0.f;
    const uint32_t z_s = smem_addr(z_sm + (i & 1) * kZBytes) + a_lane;
#pragma unroll
    for (int ks = 0; ks < kC / 16; ++ks) {
      uint32_t a[kMi][4], b[3][4];
#pragma unroll
      for (int mi = 0; mi < kMi; ++mi)
        ldmatrix_x4(a[mi], z_s + mi * 16 * kRow + (((2 * ks + a_hi) ^ x) << 4));
#pragma unroll
      for (int p = 0; p < 3; ++p)
        ldmatrix_x4(b[p], b_lane + p * 16 * kRow + (((2 * ks + b_hi) ^ x) << 4));
#pragma unroll
      for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
        for (int t = 0; t < 6; ++t)
          mma_bf16(acc[mi][t], a[mi], b[t >> 1][2 * (t & 1)], b[t >> 1][2 * (t & 1) + 1]);
    }

    // The warp's kWM latents x 48 values, rounded once, gathered in its own
    // buffer, then written as whole patch rows by bulk copies (the TMA's,
    // asynchronous: the warp goes on to the next tile): one per run of
    // latents in one latent row, 96 bytes a latent, issued by the lane of
    // the run's first latent.
    bulk_wait_read();  // this lane's copies of the last tile have read the buffer
    __syncwarp();
#pragma unroll
    for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
      for (int t = 0; t < 6; ++t)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          store_pair(o_warp + (16 * mi + gid + 8 * half) * kKc + 8 * t + 2 * tig,
                     acc[mi][t][2 * half] + bv[t][0], acc[mi][t][2 * half + 1] + bv[t][1]);
    fence_proxy_async();  // the buffer's writes, before the async proxy reads them
    __syncwarp();
    const int m0 = tile * kTile + wm, m_end = min(m0 + kWM, M);
#pragma unroll
    for (int ml = lane; ml < kWM; ml += 32) {
      const int m = m0 + ml;
      if (m >= m_end) break;
      const int row = m / Wl, wl = m - row * Wl;
      if (ml == 0 || wl == 0) {
        const int n = min(m_end - m, Wl - wl);
        bulk_store(out + (((long long)row * kK + r) * Wl + wl) * kKc, o_warp + ml * kKc,
                   n * kKc * 2);
      }
    }
    bulk_commit();
  }
  cp_async_wait<0>();
  bulk_wait();  // the last copies are done before the CTA's shared memory goes
}

// ---- launch ------------------------------------------------------------------

int sm_count() {
  static int cache[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < 64 && cache[dev]) return cache[dev];
  int n = 0;
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  if (dev < 64) cache[dev] = n;
  return n;
}

template <typename K> cudaError_t allow_smem(K kernel, int bytes) {
  return bytes > 48 * 1024
             ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)
             : cudaSuccess;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <typename T, int P>
int launch_tiled(const void* z, const void* w, const void* bias, int bias_bf16, void* out,
                 const Geometry& g, cudaStream_t stream) {
  constexpr int kSmem = Tiled<T>::kSmem;
  const cudaError_t err = allow_smem(jpegl_tiled_kernel<T, P>, kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((g.M + kTM - 1) / kTM), (unsigned)((g.N + kTN - 1) / kTN));
  jpegl_tiled_kernel<T, P><<<grid, kTiledThreads, kSmem, stream>>>(
      (const T*)z, (const T*)w, bias, bias_bf16, (T*)out, g);
  return (int)cudaGetLastError();
}

int launch_k16(const void* z, const void* w, const void* bias, int bias_bf16, void* out,
               const Geometry& g, cudaStream_t stream) {
  using namespace k16;
  const cudaError_t err = allow_smem(jpegl_k16_bf16_kernel, kSmem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (g.M + kTile - 1) / kTile;
  const int walkers = std::max(1, std::min(n_tiles, sm_count() / kSlices));
  jpegl_k16_bf16_kernel<<<kSlices * walkers, kThreads, kSmem, stream>>>(
      (const __nv_bfloat16*)z, (const __nv_bfloat16*)w, bias, bias_bf16,
      (__nv_bfloat16*)out, g.M, g.Wl, walkers);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* z, const void* w, const void* bias, int bias_bf16, void* out, int B,
           int Hl, int Wl, int C, int c_out, int k, void* stream_ptr) {
  const long long M = (long long)B * Hl * Wl;
  const long long N = (long long)k * k * c_out;
  if (M == 0) return 0;
  if (C < 1 || c_out < 1 || k < 1 || M > (1LL << 31) - kTM || N > 65535LL * kTN ||
      N * C > (1LL << 31) - 1)
    return (int)cudaErrorInvalidValue;
  const int kc = k * c_out;
  const bool rows = kc % kTN == 0 && kc * (int)sizeof(T) % 16 == 0 && aligned16(out);
  const Geometry g{(int)M, (int)N, C, Wl, k, kc, c_out, rows};
  const cudaStream_t s = (cudaStream_t)stream_ptr;
  if (sizeof(T) == 2 && C == k16::kC && k == k16::kK && c_out == k16::kCo && aligned16(z) &&
      aligned16(w) && aligned16(out))
    return launch_k16(z, w, bias, bias_bf16, out, g, s);
  if (C * (int)sizeof(T) % 16 == 0 && aligned16(z))
    return launch_tiled<T, 16>(z, w, bias, bias_bf16, out, g, s);
  return launch_tiled<T, (int)sizeof(T)>(z, w, bias, bias_bf16, out, g, s);
}

}  // namespace

extern "C" int jpegl_synthesize_f32(const void* z, const void* w, const void* bias,
                                    int bias_bf16, void* out, int B, int Hl, int Wl, int C,
                                    int c_out, int k, void* stream) {
  return launch<float>(z, w, bias, bias_bf16, out, B, Hl, Wl, C, c_out, k, stream);
}

extern "C" int jpegl_synthesize_bf16(const void* z, const void* w, const void* bias,
                                     int bias_bf16, void* out, int B, int Hl, int Wl, int C,
                                     int c_out, int k, void* stream) {
  return launch<__nv_bfloat16>(z, w, bias, bias_bf16, out, B, Hl, Wl, C, c_out, k, stream);
}
