// Fused Gaussian blur + Determinant-of-Hessian for one pyramid ladder level.
//
// Replaces the TPU kernels hesaff_tpu/ops/pallas_blur.py: blur_doh
// (pallas_blur.py:196) and blur_doh_tiled (pallas_blur.py:146).  The
// whole-level versus tiled split there is a VMEM budget artefact; one
// tiled kernel serves every level here.
//
// What bounds it on an H100: device-memory traffic.  A level reads one
// float plane and writes two (12 bytes a pixel; 8 in blur-only mode)
// against ~70 float operations a pixel for the default ladder (taps
// k <= 15), below the card's float32 operations-per-byte balance.  The
// design:
//   - a 64 x 32 output tile a 256-thread block (the halo adds 88% at
//     k = 15 to the input a tile reads, where 32 x 16 tiles added 200%);
//   - the tap count a template parameter for the ladder's k = 1, 9, 11,
//     13, 15 (1 is the identity that copies level 0 and gives its DoH),
//     so both passes run fully unrolled over a register sliding window;
//     one generic instance loops over any other odd k <= 255 (the
//     ladders of larger initial sigmas: 37 taps at sigma 4), its halo
//     of up to 127 px a side sized at run time;
//   - the row pass (along H) reads the input straight from device
//     memory into that window, a thread a 17-row strip of one column
//     (neighbouring threads read neighbouring words; the halo's re-reads
//     hit the caches), with clamped row and column indices for the
//     replicate border; the column pass reads it from shared memory, a
//     thread an 11-column strip of one row, each element once; the
//     shared row strides are odd, so neither pass conflicts.  (A version
//     that first staged the input tile in shared memory with 16-byte
//     loads was slower on the H100; PERF.md has both times.)
//   - the blurred tile stays in shared memory for the DoH stencil: the
//     level costs one read and two writes;
//   - input and outputs as planes at a given stride, so a level is read
//     from and written into a slot of a (..., L, H, W) ladder stack; a
//     null response pointer skips the DoH (the first-level blur).
//
// Semantics (bit-equal to the plain PyTorch version when built with
// --fmad=false): replicate border by index clamping (clamping the
// input columns equals edge-padding the row-blurred image), the row pass
// (along H) before the column pass, taps summed in index order, and
// DoH = (Lxx*Lyy - Lxy^2) * norm2 with Lxy = (I[r-1,c+1] - I[r-1,c-1]
// + I[r+1,c-1] - I[r+1,c+1]) / 4, zero on the image's 1-px frame.

#include <cuda_runtime.h>

#define TW 64            // output tile width
#define TH 32            // output tile height
#define BW (TW + 2)      // blurred tile with the DoH stencil's 1-px frame
#define BH (TH + 2)
#define SBW (BW + 1)     // its shared row stride (odd: no bank conflicts)
#define THREADS 256
#define SR 17            // rows of a row-pass strip (BH = 2 strips)
#define SC 11            // columns of a column-pass strip (BW = 6 strips)
#define MAX_TAPS 255
static_assert(BH % SR == 0 && BW % SC == 0, "strips must tile the tile");

struct Taps {
  float t[MAX_TAPS];
};

// Geometry for radius R: the row pass gives NV columns from c0 - 1 - R,
// kept at an odd stride SVW, for BH rows from r0 - 1.
struct Geo {
  int R, NV, SVW;
  __host__ __device__ Geo(int k) {
    R = k / 2;
    NV = BW + 2 * R;
    SVW = NV | 1;
  }
  __host__ __device__ size_t shmem() const {
    return sizeof(float) * ((size_t)BH * SVW + (size_t)BH * SBW);
  }
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Taps applied down a register window: out[m] = sum_i t[i] * w[m + i],
// in tap order.
template <int K, int N>
__device__ __forceinline__ void taps_down(const float (&w)[N + K - 1],
                                          float* dst, int dstride,
                                          const Taps& taps) {
#pragma unroll
  for (int m = 0; m < N; ++m) {
    float acc = taps.t[0] * w[m];
#pragma unroll
    for (int i = 1; i < K; ++i) acc = acc + taps.t[i] * w[m + i];
    dst[m * dstride] = acc;
  }
}

// K: the tap count (0: any, read from k)
template <int K>
__global__ void __launch_bounds__(THREADS) blur_doh_kernel(
    const float* __restrict__ in, long long in_stride,
    float* __restrict__ blur, float* __restrict__ resp, long long out_stride,
    int H, int W, Taps taps, int k, float norm2) {
  extern __shared__ float sm[];
  const Geo g(K > 0 ? K : k);
  float* s_v = sm;                    // BH x SVW after the row pass
  float* s_b = sm + BH * g.SVW;       // BH x SBW after both

  const float* src = in + blockIdx.z * in_stride;
  const int r0 = blockIdx.y * TH;
  const int c0 = blockIdx.x * TW;
  const int tid = threadIdx.x;

  // row pass (along H): a thread blurs SR rows of one column
  for (int e = tid; e < (BH / SR) * g.NV; e += THREADS) {
    const int j = e % g.NV, s = e / g.NV;
    const float* col = src + clampi(c0 - 1 - g.R + j, 0, W - 1);
    const int rb = r0 - 1 - g.R + s * SR;
    float* dst = s_v + s * SR * g.SVW + j;
    if constexpr (K > 0) {
      float w[SR + K - 1];
#pragma unroll
      for (int i = 0; i < SR + K - 1; ++i)
        w[i] = __ldg(col + (size_t)clampi(rb + i, 0, H - 1) * W);
      taps_down<K, SR>(w, dst, g.SVW, taps);
    } else {
      for (int m = 0; m < SR; ++m) {
        const float* at = col + (size_t)clampi(rb + m, 0, H - 1) * W;
        float acc = taps.t[0] * __ldg(at);
        for (int i = 1; i < k; ++i)
          acc = acc + taps.t[i] *
                __ldg(col + (size_t)clampi(rb + m + i, 0, H - 1) * W);
        dst[m * g.SVW] = acc;
      }
    }
  }
  __syncthreads();

  // column pass: a thread blurs SC columns of one row (lanes on rows)
  for (int e = tid; e < BH * (BW / SC); e += THREADS) {
    const int rr = e % BH, s = e / BH;
    const float* row = s_v + rr * g.SVW + s * SC;
    float* dst = s_b + rr * SBW + s * SC;
    if constexpr (K > 0) {
      float w[SC + K - 1];
#pragma unroll
      for (int i = 0; i < SC + K - 1; ++i) w[i] = row[i];
      taps_down<K, SC>(w, dst, 1, taps);
    } else {
      for (int m = 0; m < SC; ++m) {
        float acc = taps.t[0] * row[m];
        for (int i = 1; i < k; ++i) acc = acc + taps.t[i] * row[m + i];
        dst[m] = acc;
      }
    }
  }
  __syncthreads();

  float* bout = blur + blockIdx.z * out_stride;
  float* rout = resp ? resp + blockIdx.z * out_stride : nullptr;
#pragma unroll
  for (int it = 0; it < TH * TW / THREADS; ++it) {
    const int e = tid + it * THREADS;
    const int rr = e / TW, cc = e % TW;
    const int gr = r0 + rr, gc = c0 + cc;
    if (gr >= H || gc >= W) continue;
    const float* b = s_b + (rr + 1) * SBW + (cc + 1);
    const float c = b[0];
    const size_t at = (size_t)gr * W + gc;
    bout[at] = c;
    if (!rout) continue;
    float out = 0.0f;
    if (gr > 0 && gr < H - 1 && gc > 0 && gc < W - 1) {
      const float lxx = (b[-1] - 2.0f * c) + b[1];
      const float lyy = (b[-SBW] - 2.0f * c) + b[SBW];
      const float d1 = b[-SBW + 1];  // (r-1, c+1)
      const float d2 = b[-SBW - 1];  // (r-1, c-1)
      const float d3 = b[SBW - 1];   // (r+1, c-1)
      const float d4 = b[SBW + 1];   // (r+1, c+1)
      const float lxy = (((d1 - d2) + d3) - d4) * 0.25f;
      out = (lxx * lyy - lxy * lxy) * norm2;
    }
    rout[at] = out;
  }
}

template <int K>
static int launch(const float* in, long long in_stride, float* blur,
                  float* resp, long long out_stride, int n, int H, int W,
                  const Taps& t, int k, float norm2, cudaStream_t stream) {
  const Geo g(k);
  if (g.shmem() > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        blur_doh_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)g.shmem());
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, n);
  blur_doh_kernel<K><<<grid, THREADS, g.shmem(), stream>>>(
      in, in_stride, blur, resp, out_stride, H, W, t, k, norm2);
  return (int)cudaGetLastError();
}

// n (H, W) float planes: plane i of the input at in + i * in_stride,
// of the outputs at blur / resp + i * out_stride (elements); resp may be
// null (blur only).  taps: host array of k floats (k odd, k <= MAX_TAPS).
// Returns cudaGetLastError().
extern "C" int hesaff_blur_doh(const float* in, long long in_stride,
                               float* blur, float* resp,
                               long long out_stride, int n, int H, int W,
                               const float* taps, int k, float norm2,
                               void* stream) {
  if (k < 1 || k > MAX_TAPS || (k & 1) == 0 || n > 65535 || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  Taps t;
  for (int i = 0; i < MAX_TAPS; ++i) t.t[i] = i < k ? taps[i] : 0.0f;
  cudaStream_t s = (cudaStream_t)stream;
  switch (k) {
    case 1: return launch<1>(in, in_stride, blur, resp, out_stride, n, H, W,
                             t, k, norm2, s);
    case 9: return launch<9>(in, in_stride, blur, resp, out_stride, n, H, W,
                             t, k, norm2, s);
    case 11: return launch<11>(in, in_stride, blur, resp, out_stride, n, H,
                               W, t, k, norm2, s);
    case 13: return launch<13>(in, in_stride, blur, resp, out_stride, n, H,
                               W, t, k, norm2, s);
    case 15: return launch<15>(in, in_stride, blur, resp, out_stride, n, H,
                               W, t, k, norm2, s);
    default: return launch<0>(in, in_stride, blur, resp, out_stride, n, H, W,
                              t, k, norm2, s);
  }
}
