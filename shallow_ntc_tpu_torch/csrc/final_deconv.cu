// Final stage of the two-layer residual decoder on Hopper: depth-to-space by
// 8 of the phase-space mid tensor, then a SAME k x k stride-2 transposed
// convolution, plus bias. One fused pass: the depth-to-spaced mid tensor is
// never written out.
//
// Replaces the TPU kernel shallow_ntc_tpu/ops/pallas/twolayer_final.py
// (final_deconv_phase and its rolled Pallas bodies), porting its contract and
// none of its TPU tactics (128-lane block padding, width taps by pltpu.roll,
// batch pairs). Any batch and any height are taken.
//
// Layouts (C innermost everywhere, TF depth-to-space order):
//   mid   [B, H, W, 64 * c_in]   channel ((X % 8) * 8 + (Y % 8)) * c_in + ci
//                                holds mid pixel (8h + X % 8, 8w + Y % 8)
//   w     [k, k, c_in, c_out]    flax deconv kernel (unflipped), float32
//   bias  [c_out]                float32
//   out   [B, 16H, 16W, c_out]
// Geometry: output row O = 2X + r reads mid row X + d with kernel row
// t = p0 - r + 2d, p0 = k - 1 - max(k - 2, 0) / 2, for each t in [0, k);
// columns likewise. Rows outside the image read zeros (SAME).
//
// Bound on the H100: bytes. Each mid value is read and each output value is
// written once (~150 FLOP per output value at the flagship's k=5, c_in=12,
// c_out=3, far below the ridge). Design: one thread per output pixel, all
// c_out channels in registers (in chunks of 4), float32 accumulation; the
// <= ceil(k/2)^2 valid taps each read c_in contiguous mid values, which
// neighbouring threads share through L1. Weights are read through the
// read-only cache. Coalesced channel stores and shared-memory row tiles are
// later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kCoChunk = 4;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void final_deconv_kernel(const T* __restrict__ mid,
                                    const float* __restrict__ w,
                                    const float* __restrict__ bias,
                                    T* __restrict__ out, int B, int H, int W,
                                    int c_in, int c_out, int k) {
  const long long Ho = 16LL * H, Wo = 16LL * W;
  const long long n_pix = (long long)B * Ho * Wo;
  const long long pix = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= n_pix) return;
  const int ow = (int)(pix % Wo);
  const long long t0 = pix / Wo;
  const int oh = (int)(t0 % Ho);
  const int b = (int)(t0 / Ho);

  const int p0 = k - 1 - max(k - 2, 0) / 2;
  const int xh = oh >> 1, rh = oh & 1;
  const int yw = ow >> 1, rw = ow & 1;
  const int mid_h = 8 * H, mid_w = 8 * W;
  const int c_phase = 64 * c_in;
  // Kernel taps t with t = p0 - r + 2d: t has the parity of p0 - r.
  const int th0 = (p0 - rh) & 1;
  const int tw0 = (p0 - rw) & 1;

  T* dst = out + pix * c_out;
  for (int co0 = 0; co0 < c_out; co0 += kCoChunk) {
    const int n = min(kCoChunk, c_out - co0);
    float acc[kCoChunk];
#pragma unroll
    for (int j = 0; j < kCoChunk; ++j) acc[j] = j < n ? __ldg(bias + co0 + j) : 0.f;

    for (int th = th0; th < k; th += 2) {
      const int x = xh + (th - p0 + rh) / 2;
      if (x < 0 || x >= mid_h) continue;
      for (int tw = tw0; tw < k; tw += 2) {
        const int y = yw + (tw - p0 + rw) / 2;
        if (y < 0 || y >= mid_w) continue;
        const T* src = mid + (((long long)b * H + (x >> 3)) * W + (y >> 3)) * c_phase
                       + ((x & 7) * 8 + (y & 7)) * c_in;
        const float* wt = w + ((long long)(th * k + tw) * c_in) * c_out + co0;
        for (int ci = 0; ci < c_in; ++ci) {
          const float v = to_f32(src[ci]);
#pragma unroll
          for (int j = 0; j < kCoChunk; ++j)
            if (j < n) acc[j] = fmaf(v, __ldg(wt + ci * c_out + j), acc[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kCoChunk; ++j)
      if (j < n) store(dst + co0 + j, acc[j]);
  }
}

template <typename T>
int launch(const void* mid, const void* w, const void* bias, void* out, int B,
           int H, int W, int c_in, int c_out, int k, void* stream) {
  const long long n_pix = (long long)B * 16 * H * 16 * W;
  if (n_pix == 0) return 0;
  const int threads = 256;
  const long long blocks = (n_pix + threads - 1) / threads;
  final_deconv_kernel<T><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const T*)mid, (const float*)w, (const float*)bias, (T*)out, B, H, W,
      c_in, c_out, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int final_deconv_f32(const void* mid, const void* w, const void* bias,
                                void* out, int B, int H, int W, int c_in,
                                int c_out, int k, void* stream) {
  return launch<float>(mid, w, bias, out, B, H, W, c_in, c_out, k, stream);
}

extern "C" int final_deconv_bf16(const void* mid, const void* w, const void* bias,
                                 void* out, int B, int H, int W, int c_in,
                                 int c_out, int k, void* stream) {
  return launch<__nv_bfloat16>(mid, w, bias, out, B, H, W, c_in, c_out, k, stream);
}
