// Final stage of the two-layer residual decoder on Hopper: depth-to-space by
// 8 of the phase-space mid tensor, then a SAME k x k stride-2 transposed
// convolution, plus bias. One fused pass: the depth-to-spaced mid tensor is
// never written out.
//
// Replaces the TPU kernel shallow_ntc_tpu/ops/pallas/twolayer_final.py
// (final_deconv_phase and its Pallas bodies), porting its contract -- a
// matmul against a folded weight matrix in the input's type with float32
// accumulation -- and none of its TPU tactics (128-lane block padding, width
// taps by pltpu.roll, batch pairs). Any batch, height and width; k <= 7,
// c_in <= 16, any c_out.
//
// Layouts (C innermost everywhere, TF depth-to-space order):
//   mid   [B, H, W, 64 * c_in]   channel ((X % 8) * 8 + (Y % 8)) * c_in + ci
//                                holds mid pixel (8h + X % 8, 8w + Y % 8)
//   w     [k, k, c_in, c_out]    flax deconv kernel (unflipped), in mid's type
//   widx  [ceil(c_out / 4), ND * ND, 16, 16] int32: the folding, below, as
//         an index into w (k * k * c_in * c_out where the weight is zero),
//         built once per geometry by ops/twolayer_final.fold_index
//   bias  [c_out]                float32 or bfloat16 (bias_bf16), widened and
//                                added in float32
//   out   [B, 16H, 16W, c_out]
// Geometry: output row O = 2X + r reads mid row X + d with kernel row
// t = p0 - r + 2d, p0 = k - 1 - max(k - 2, 0) / 2, for each t in [0, k);
// columns likewise. So the 2x2 output quad (2X + r, 2Y + s) of mid pixel
// (X, Y) reads the mid neighbourhood (X + d, Y + e), d, e in [D0, 1], with
// D0 = -1 for k <= 6 and -2 for k = 7 (ND = 3 or 4 taps per axis). Rows
// outside the image read zeros (SAME).
//
// Bound on this card (NVIDIA H100 80GB HBM3, 700 W): bytes. At the
// flagship's decode (B=8, mid 32x48 phase pixels, c_in = 12, c_out = 3,
// k = 5, bfloat16) the kernel must read 18.9 MB and write 18.9 MB: 11.3 us
// at 3.35 TB/s. Its 225 useful FMAs per output pixel make 1.42 GFLOP, 21 us
// at the card's 67 TFLOP/s of float32 on the CUDA cores, so the CUDA cores
// alone cannot reach even half the bound: the work goes to the tensor
// cores, as on the TPU.
//
// Design: each mid pixel's 2x2 output quad is one row of a GEMM.
//   M: mid pixels; K: taps x c_in, c_in padded to 16, so one k16 step (two
//   k8 steps in float32) is one tap; N: 4 parities x 4 output channels, two
//   n8 tiles, one pass per 4 output channels. B is the phase-folded kernel,
//   zero where a tap does not reach a parity.
// A CTA (8 warps) covers one phase row and kTW = 8 phase columns: 8 mid rows
// x 64 mid columns, 8 x 4 m16 tiles.
//   1. The mid tile and its halo (rows D0..8, columns D0..64) come into
//      shared memory by cp.async, each pixel padded to 16 channels (zeros,
//      and zeros outside the image, by src-size 0), in pieces of the largest
//      of 16, 8 or 4 bytes that divides a pixel's c_in values (8 bytes in
//      bfloat16 at c_in = 12, so not the 16-byte copies a padded pixel would
//      need; bfloat16 with odd c_in takes plain 2-byte loads). A warp's
//      pieces are contiguous runs of a phase pixel's mid row (8 c_in values).
//      The 16-byte units of a pixel are XOR-swizzled by column, so the
//      ldmatrix rows of a tap, shifted by any (d, e), are free of bank
//      conflicts.
//   2. The folded weights of one chunk of 4 output channels are gathered
//      through widx into shared memory in fragment order (one 16-byte load
//      per lane and tap), split into TF32 heads and tails in float32; the
//      wrapper launches nothing but the kernel.
//   3. Per tap the warps load A fragments by ldmatrix from the tile shifted
//      by (d, e) and run mma.sync: m16n8k16 bf16, or 3xTF32 m16n8k8 in
//      float32 (a*b = ah*bh + ah*bl + al*bh, float32-accurate; K <= 256, so
//      no per-step flush). A bf16 warp owns 2 mid rows of 2 column tiles and
//      holds the 9 taps' B fragments in registers, so one A fragment serves
//      both rows where taps reach them; a float32 warp owns one row.
//      Accumulators start at the bias, in float32, and are rounded once.
//   4. Each warp gathers its output rows in shared memory and writes them as
//      16-byte vector stores: with c_out <= 4 each is one contiguous run.
// Measured (scripts/torch_final_deconv_bench.py, NVIDIA H100 80GB HBM3,
// 700 W): 0.026 ms at the decode shape, 0.014 ms at B=1 f32 and 0.015 ms at
// B=8 mid 16x16 f32. Timed alone, the decode's loads take 0.009 ms, its
// stores 0.010 ms and its weight staging and GEMM 0.018 ms: the phases
// overlap little. Measured no faster and left out: persistent CTAs with a
// double-buffered tile, skipping the MMAs of B's zero tap rows, 4 mid rows
// per bf16 warp (spills), 4-column tiles.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kTW = 8;                    // phase columns per CTA
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMt = 8 * kTW / 16;         // m16 column tiles in a mid row
constexpr int kCols = 8 * kTW + 8;        // tile columns (halo included), a multiple of 8
constexpr int kOutCols = 16 * kTW;        // output columns per CTA
constexpr int kCoChunk = 4;               // output channels per GEMM pass (N = 16)

template <typename T> struct Cfg {
  static constexpr int kPixBytes = 16 * (int)sizeof(T);  // a pixel padded to 16 channels
  // 16-byte fragment loads per lane and tap: bf16 B; TF32 heads, then tails, of 2 k8 steps.
  static constexpr int kQ = sizeof(T) == 2 ? 1 : 4;
  // Mid rows per warp: bf16 shares each A fragment between 2 rows (4 rows
  // spill at 85 registers); float32 is bound by its 3xTF32 MMAs and keeps 1.
  static constexpr int kR = sizeof(T) == 2 ? 2 : 1;
};

template <typename T, int ND> struct Geo {
  static constexpr int kD0 = 2 - ND;              // first tap offset d
  static constexpr int kRows = ND + 7;            // mid rows D0..8
  static constexpr int kColsUsed = 8 * kTW + ND - 1;
  static constexpr int kTaps = ND * ND;
  static constexpr int kTileBytes = kRows * kCols * Cfg<T>::kPixBytes;
  static constexpr int kWBytes = kTaps * Cfg<T>::kQ * 32 * 16;
  static constexpr int kStageBytes = kWarps * 2 * kOutCols * kCoChunk * (int)sizeof(T);
  static constexpr int kSmem = kTileBytes + kWBytes + kStageBytes;
};

__device__ __forceinline__ float load_bias(const void* bias, int bias_bf16, int co) {
  return bias_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[co])
                   : static_cast<const float*>(bias)[co];
}
template <typename T> __device__ __forceinline__ T from_f32(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// The 16-byte unit of column j's pixel at which unit u is stored: 8
// consecutive columns put any one unit in 8 different bank quads.
template <typename T> __device__ __forceinline__ int swizzle(int u, int j) {
  return sizeof(T) == 2 ? u ^ ((j >> 2) & 1) : u ^ ((j >> 1) & 3);
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
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

// x = hi + lo with hi rounded to TF32 (10 mantissa bits, nearest, ties away)
// by integer ops, and lo = x - hi exact in float32; the tensor core reads
// only lo's top 10 mantissa bits, which leaves an error below 2^-21 |x|.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// The folded weights of one chunk (w gathered through widx, zero at index
// n_w) -> shared memory in fragment order, as uint4 [tap][q][lane]. bf16
// (m16n8k16): a lane's words are (n-tile 0: b0, b1, n-tile 1: b0, b1), b0 =
// B[2 tig, 2 tig + 1][g], b1 the same 8 rows on. float32 (m16n8k8): q = k8
// step (heads), 2 + k8 step (tails); words as in bf16 with b0 = B[tig][g],
// b1 = B[tig + 4][g]. Each thread holds one (k, n) of every tap; all its
// index loads go out before the gathers that use them, so the whole build
// waits for two round trips to L2, not two per tap.
template <typename T, int ND>
__device__ __forceinline__ void stage_weights(const T* __restrict__ w,
                                              const int* __restrict__ widx, int n_w,
                                              int chunk, uint4* wsm) {
  constexpr int kTaps = ND * ND;
  static_assert(kThreads == 256, "one (k, n) of each tap per thread");
  const int t = threadIdx.x;
  int k, n;
  if constexpr (sizeof(T) == 2) {  // t = (lane, word, half)
    const int half = t & 1, word = (t >> 1) & 3, ln = t >> 3;
    k = 2 * (ln & 3) + 8 * (word & 1) + half;
    n = 8 * (word >> 1) + (ln >> 2);
  } else {  // t = (k8 step, lane, word)
    const int word = t & 3, ln = (t >> 2) & 31, ks = t >> 7;
    k = 8 * ks + (ln & 3) + 4 * (word & 1);
    n = 8 * (word >> 1) + (ln >> 2);
  }
  const int* idx = widx + chunk * kTaps * 256 + k * 16 + n;
  int iv[kTaps];
#pragma unroll
  for (int tap = 0; tap < kTaps; ++tap) iv[tap] = __ldg(idx + tap * 256);
#pragma unroll
  for (int tap = 0; tap < kTaps; ++tap) {
    const T v = iv[tap] < n_w ? __ldg(w + iv[tap]) : from_f32<T>(0.f);
    if constexpr (sizeof(T) == 2) {
      reinterpret_cast<T*>(wsm)[tap * 256 + t] = v;
    } else {
      uint32_t hi, lo;
      split_tf32(v, hi, lo);
      reinterpret_cast<uint32_t*>(wsm)[tap * 512 + t] = hi;
      reinterpret_cast<uint32_t*>(wsm)[tap * 512 + 256 + t] = lo;
    }
  }
}

template <typename T, int ND, int P>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 ? 3 : 2)
final_deconv_kernel(const T* __restrict__ mid, const T* __restrict__ w,
                    const int* __restrict__ widx, const void* __restrict__ bias,
                    int bias_bf16, T* __restrict__ out, int H, int W, int c_in, int c_out,
                    int n_w) {
  using G = Geo<T, ND>;
  constexpr int kPixBytes = Cfg<T>::kPixBytes;
  constexpr int kQP = kPixBytes / P;  // pieces per padded pixel
  static_assert(P >= (int)sizeof(T) && P <= 16, "piece size");
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* tile = smem;
  uint4* wsm = reinterpret_cast<uint4*>(smem + G::kTileBytes);
  T* stage = reinterpret_cast<T*>(smem + G::kTileBytes + G::kWBytes);

  const int tiles_w = (W + kTW - 1) / kTW;
  const int tw = blockIdx.x % tiles_w;
  const int bh = blockIdx.x / tiles_w;  // b * H + h
  const int h = bh % H;
  const int w0 = tw * kTW;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // 1. The mid tile, mid rows 8h + D0 .. 8h + 8, columns 8 w0 + D0 .. 8 w0 + 8 kTW.
  // A thread copies piece q of columns j, j + kThreads / kQP, ... in every
  // row: its column offset and smem place are fixed, and row i, mid row
  // 8h + D0 + i, lies in phase row h + ((D0 + i) >> 3) at row (D0 + i) & 7,
  // both known at compile time. Offsets within an image are 32-bit.
  {
    constexpr int kColStep = kThreads / kQP;
    const int byte = threadIdx.x % kQP * P;
    const bool data = byte < c_in * (int)sizeof(T);  // else channel padding: zeros
    const int c_phase = 64 * c_in, row_stride = W * c_phase;
    const T* img = mid + (long long)(bh - h) * row_stride + byte / (int)sizeof(T);  // batch b
    for (int j = threadIdx.x / kQP; j < G::kColsUsed; j += kColStep) {
      const int y = 8 * w0 + G::kD0 + j;
      const bool col_ok = data && y >= 0 && y < 8 * W;
      const int col_off = (y >> 3) * c_phase + (y & 7) * c_in;
      unsigned char* dst = tile + j * kPixBytes + (swizzle<T>(byte >> 4, j) << 4) + (byte & 15);
#pragma unroll
      for (int i = 0; i < G::kRows; ++i) {
        const int dh = (G::kD0 + i) >> 3, a = (G::kD0 + i) & 7;
        const bool ok = col_ok && (dh == 0 || (dh < 0 ? h > 0 : h + 1 < H));
        const int off = ok ? (h + dh) * row_stride + a * 8 * c_in + col_off : 0;
        copy_piece<P>(dst + i * kCols * kPixBytes, img + off, ok);
      }
    }
  }

  // Warp w owns kR mid rows from row0 and kC m16 column tiles from ct0. In
  // bf16 (kR = 2) an A fragment of tile row row0 + i serves each of the
  // warp's output rows row0 + i - dy that some tap row dy reaches: a third
  // fewer ldmatrix than one row per warp. float32 (kR = 1) loads each A
  // fragment once anyway.
  constexpr int kR = Cfg<T>::kR, kC = 4 / kR;
  static_assert(kR * kC * kWarps == 8 * kMt, "every (row, column tile) once");
  const int row0 = warp / (kMt / kC) * kR, ct0 = warp % (kMt / kC) * kC;
  const int g = lane >> 2, tig = lane & 3;
  const int arow = (lane & 7) + ((lane >> 3) & 1) * 8;  // ldmatrix: this lane's A row
  const int aunit = lane >> 4;                          // and 16-byte unit
  const uint32_t tile_s = smem_addr(tile) + (row0 * kCols + 16 * ct0) * kPixBytes;
  T* st = stage + warp * 2 * kOutCols * kCoChunk;
  const int warp_cols = max(0, min(32 * kC, 16 * min(kTW, W - w0) - 32 * ct0));
  const int n_chunks = (c_out + kCoChunk - 1) / kCoChunk;

  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    if (chunk) __syncthreads();  // every warp is done with the last chunk's weights
    stage_weights<T, ND>(w, widx, n_w, chunk, wsm);
    if (!chunk) {
      asm volatile("cp.async.commit_group;");
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncthreads();

    // 2. The GEMM: acc[xr][c][n-tile = r] holds (mid row row0 + xr, column
    // 16 (ct0 + c) + g (+8), parity (r, s = tig / 2), channel 4 chunk + 2 (tig
    // % 2) (+1)).
    float acc[kR][kC][2][4];
    const int co = kCoChunk * chunk + 2 * (tig & 1);
    const float bias0 = co < c_out ? load_bias(bias, bias_bf16, co) : 0.f;
    const float bias1 = co + 1 < c_out ? load_bias(bias, bias_bf16, co + 1) : 0.f;
#pragma unroll
    for (int xr = 0; xr < kR; ++xr)
#pragma unroll
      for (int c = 0; c < kC; ++c)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          acc[xr][c][nt][0] = acc[xr][c][nt][2] = bias0;
          acc[xr][c][nt][1] = acc[xr][c][nt][3] = bias1;
        }
    if constexpr (sizeof(T) == 2) {
      constexpr bool kHoldB = ND == 3;  // the 9 taps' B fragments fit in registers
      uint4 bq[kHoldB ? ND * ND : 1];
      if constexpr (kHoldB) {
#pragma unroll
        for (int tap = 0; tap < ND * ND; ++tap) bq[tap] = wsm[tap * 32 + lane];
      }
#pragma unroll
      for (int i = 0; i < kR + ND - 1; ++i) {
#pragma unroll
        for (int dx = 0; dx < ND; ++dx) {
          const int j0 = arow + dx;  // 16 c leaves the swizzle unchanged
          const uint32_t a_row = tile_s + (i * kCols + j0) * kPixBytes + (swizzle<T>(aunit, j0) << 4);
#pragma unroll
          for (int c = 0; c < kC; ++c) {
            uint32_t a[4];
            ldmatrix_x4(a, a_row + 16 * c * kPixBytes);
#pragma unroll
            for (int xr = 0; xr < kR; ++xr) {
              const int dy = i - xr;
              if (dy < 0 || dy >= ND) continue;
              const uint4 b = kHoldB ? bq[kHoldB ? dy * ND + dx : 0] : wsm[(dy * ND + dx) * 32 + lane];
              mma_bf16(acc[xr][c][0], a, b.x, b.y);
              mma_bf16(acc[xr][c][1], a, b.z, b.w);
            }
          }
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < kR + ND - 1; ++i) {
#pragma unroll
        for (int dx = 0; dx < ND; ++dx) {
          const int j0 = arow + dx;
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
            const uint32_t a_row = tile_s + (i * kCols + j0) * kPixBytes +
                                   (swizzle<T>(2 * ks + aunit, j0) << 4);
#pragma unroll
            for (int xr = 0; xr < kR; ++xr) {
              const int dy = i - xr;
              if (dy < 0 || dy >= ND) continue;
              const int tap = dy * ND + dx;
              const uint4 bh4 = wsm[(tap * 4 + ks) * 32 + lane];
              const uint4 bl4 = wsm[(tap * 4 + 2 + ks) * 32 + lane];
#pragma unroll
              for (int c = 0; c < kC; ++c) {
                uint32_t a[4], ah[4], al[4];
                ldmatrix_x4(a, a_row + 16 * c * kPixBytes);
#pragma unroll
                for (int v = 0; v < 4; ++v) split_tf32(__uint_as_float(a[v]), ah[v], al[v]);
                mma_tf32(acc[xr][c][0], al, bh4.x, bh4.y);
                mma_tf32(acc[xr][c][0], ah, bl4.x, bl4.y);
                mma_tf32(acc[xr][c][0], ah, bh4.x, bh4.y);
                mma_tf32(acc[xr][c][1], al, bh4.z, bh4.w);
                mma_tf32(acc[xr][c][1], ah, bl4.z, bl4.w);
                mma_tf32(acc[xr][c][1], ah, bh4.z, bh4.w);
              }
            }
          }
        }
      }
    }

    // 3. This warp's 2 kR output rows 16h + 2 (row0 + xr) + r, columns
    // 32 ct0 .. 32 (ct0 + kC), gathered as [2 kR][32 kC][nco] and written out.
    const int nco = min(kCoChunk, c_out - kCoChunk * chunk);
#pragma unroll
    for (int xr = 0; xr < kR; ++xr)
#pragma unroll
      for (int c = 0; c < kC; ++c)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int col = 2 * (16 * c + g + 8 * hf) + (tig >> 1);
            T* dst = st + ((2 * xr + r) * 32 * kC + col) * nco;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int cl = 2 * (tig & 1) + e;
              if (cl < nco) dst[cl] = from_f32<T>(acc[xr][c][r][2 * hf + e]);
            }
          }
    __syncwarp();
    // Output row 16 h + 2 row0 + rr = 16 (b H + h) + 2 row0 + rr.
    T* dst0 = out + ((16LL * bh + 2 * row0) * 16 * W + 16 * w0 + 32 * ct0) * c_out;
    const long long row_len = 16LL * W * c_out;
#pragma unroll
    for (int rr = 0; rr < 2 * kR; ++rr) {
      T* dst = dst0 + rr * row_len;
      const T* src = st + rr * 32 * kC * nco;
      if (nco == c_out) {  // one contiguous run of warp_cols * c_out values
        const int n16 = warp_cols * c_out * (int)sizeof(T) / 16;
        for (int v = lane; v < n16; v += 32)
          reinterpret_cast<uint4*>(dst)[v] = reinterpret_cast<const uint4*>(src)[v];
      } else {
        for (int v = lane; v < warp_cols * nco; v += 32) {
          const int px = v / nco;
          dst[px * c_out + kCoChunk * chunk + (v - px * nco)] = src[v];
        }
      }
    }
    __syncwarp();
  }
}

template <typename T, int ND, int P>
int launch_p(const void* mid, const void* w, const void* widx, const void* bias,
             int bias_bf16, void* out, int B, int H, int W, int c_in, int c_out, int k,
             cudaStream_t stream) {
  constexpr int kSmem = Geo<T, ND>::kSmem;
  if (kSmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        final_deconv_kernel<T, ND, P>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (long long)B * H * ((W + kTW - 1) / kTW);
  final_deconv_kernel<T, ND, P><<<(unsigned)blocks, kThreads, kSmem, stream>>>(
      (const T*)mid, (const T*)w, (const int*)widx, bias, bias_bf16, (T*)out, H, W, c_in, c_out,
      k * k * c_in * c_out);
  return (int)cudaGetLastError();
}

template <typename T, int ND>
int launch_nd(const void* mid, const void* w, const void* widx, const void* bias,
              int bias_bf16, void* out, int B, int H, int W, int c_in, int c_out, int k,
              cudaStream_t stream) {
  const int row_bytes = c_in * (int)sizeof(T);  // one mid pixel's values
  if (row_bytes % 16 == 0)
    return launch_p<T, ND, 16>(mid, w, widx, bias, bias_bf16, out, B, H, W, c_in, c_out, k, stream);
  if (row_bytes % 8 == 0)
    return launch_p<T, ND, 8>(mid, w, widx, bias, bias_bf16, out, B, H, W, c_in, c_out, k, stream);
  if (row_bytes % 4 == 0)
    return launch_p<T, ND, 4>(mid, w, widx, bias, bias_bf16, out, B, H, W, c_in, c_out, k, stream);
  if constexpr (sizeof(T) == 2)
    return launch_p<T, ND, 2>(mid, w, widx, bias, bias_bf16, out, B, H, W, c_in, c_out, k, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch(const void* mid, const void* w, const void* widx, const void* bias,
           int bias_bf16, void* out, int B, int H, int W, int c_in, int c_out, int k,
           void* stream) {
  if ((long long)B * H * W == 0) return 0;
  if (k < 1 || k > 7 || c_in < 1 || c_in > 16 || c_out < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return k == 7 ? launch_nd<T, 4>(mid, w, widx, bias, bias_bf16, out, B, H, W, c_in, c_out, k, s)
                : launch_nd<T, 3>(mid, w, widx, bias, bias_bf16, out, B, H, W, c_in, c_out, k, s);
}

}  // namespace

extern "C" int final_deconv_f32(const void* mid, const void* w, const void* widx,
                                const void* bias, int bias_bf16, void* out, int B, int H, int W,
                                int c_in, int c_out, int k, void* stream) {
  return launch<float>(mid, w, widx, bias, bias_bf16, out, B, H, W, c_in, c_out, k, stream);
}

extern "C" int final_deconv_bf16(const void* mid, const void* w, const void* widx,
                                 const void* bias, int bias_bf16, void* out, int B, int H, int W,
                                 int c_in, int c_out, int k, void* stream) {
  return launch<__nv_bfloat16>(mid, w, widx, bias, bias_bf16, out, B, H, W, c_in, c_out, k, stream);
}
