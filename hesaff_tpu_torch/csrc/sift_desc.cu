// 128-D SIFT descriptors of normalised patches, one block per patch.
//
// Replaces the TPU kernel hesaff_tpu/ops/pallas_sift.py:
// sift_descriptors_pallas (pallas_sift.py:171, pallas_call at :198).
//
// What bounds it on an H100: neither side by much.  A patch is read
// once (41 x 41 floats, 6.7 KB) and 128 floats are written; the work
// per patch is ~1.7k gradient / atan2 evaluations and ~60k multiply-adds
// of the separable trilinear binning.  The TPU kernel packed 128 patches
// into the lanes of a transposed (pixel, patch) block and needed a
// polynomial atan2 because its compiler has none; here a block owns one
// patch in shared memory, uses atan2f, bins with the separable spatial
// weights in two passes (rows, then columns) and reduces in fixed tree
// order, with no atomics, so the result is deterministic.
//
// Semantics (sift.sift_descriptors, the plain version): mean and sigma
// over the binary support of the circular mask (sigma < 1e-4 leaves the
// patch unchanged), else clamp(128 + 50 (x - mean) / sigma, 0, 255);
// unhalved central differences, one-sided at the edges; magnitude times
// the mask; orientation o = ob (atan2(gy, gx) + 2 pi) / (2 pi) split
// over bins floor(o) % ob and the next with weights 1 - frac, frac;
// spatial weights W (P x sb) in both directions; L2 normalise, clip at
// max_bin, renormalise only if a bin was clipped, and
// min(floor(512 v), 255).  Bins are written in the reference order
// ((row bin * sb + column bin) * ob + orientation).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define THREADS 128

__device__ float block_sum(float v, float* s_red) {
  s_red[threadIdx.x] = v;
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s)
      s_red[threadIdx.x] = s_red[threadIdx.x] + s_red[threadIdx.x + s];
    __syncthreads();
  }
  const float total = s_red[0];
  __syncthreads();
  return total;
}

__global__ void __launch_bounds__(THREADS) sift_kernel(
    const float* __restrict__ patches, int P,
    const float* __restrict__ circ, const float* __restrict__ spatial,
    int sb, int ob, float n_support, float max_bin, float* __restrict__ out) {
  extern __shared__ float sm[];
  const int PP = P * P;
  const int nb = sb * sb * ob;
  float* s_x = sm;                     // PP
  float* s_circ = s_x + PP;            // PP
  float* s_val = s_circ + PP;          // PP: mask * magnitude
  float* s_w1 = s_val + PP;            // PP: orientation split weight
  float* s_W = s_w1 + PP;              // P x sb spatial weights
  float* s_t = s_W + P * sb;           // sb x P x ob row-binned
  float* s_red = s_t + sb * P * ob;    // THREADS
  int* s_b0 = (int*)(s_red + THREADS); // PP: lower orientation bin

  const int k = blockIdx.x;
  const int tid = threadIdx.x;
  const float* pin = patches + (size_t)k * PP;
  for (int e = tid; e < PP; e += THREADS) {
    s_x[e] = pin[e];
    s_circ[e] = circ[e];
  }
  for (int e = tid; e < P * sb; e += THREADS) s_W[e] = spatial[e];
  __syncthreads();

  // photometric normalisation over the support disc
  float a = 0.0f;
  for (int e = tid; e < PP; e += THREADS)
    a = a + (s_circ[e] > 0.0f ? s_x[e] : 0.0f);
  const float mean = block_sum(a, s_red) / n_support;
  a = 0.0f;
  for (int e = tid; e < PP; e += THREADS) {
    const float d = mean - s_x[e];
    a = a + (s_circ[e] > 0.0f ? d * d : 0.0f);
  }
  const float sd = sqrtf(block_sum(a, s_red) / n_support);
  if (!(sd < 0.0001f)) {
    const float fac = 50.0f / sd;
    for (int e = tid; e < PP; e += THREADS) {
      const float v = 128.0f + fac * (s_x[e] - mean);
      s_x[e] = v < 0.0f ? 0.0f : (v > 255.0f ? 255.0f : v);
    }
  }
  __syncthreads();

  // gradients, magnitude and orientation split
  const float two_pi = (float)(2.0 * M_PI);
  for (int e = tid; e < PP; e += THREADS) {
    const int r = e / P, c = e - (e / P) * P;
    const float* v = s_x + e;
    const float gx = c == 0 ? v[1] - v[0]
                   : (c == P - 1 ? v[0] - v[-1] : v[1] - v[-1]);
    const float gy = r == 0 ? v[P] - v[0]
                   : (r == P - 1 ? v[0] - v[-P] : v[P] - v[-P]);
    const float mag = sqrtf(gx * gx + gy * gy);
    const float ori = atan2f(gy, gx);
    const float o = ((float)ob * (ori + two_pi)) / two_pi;
    const float bo0 = floorf(o);
    s_val[e] = s_circ[e] * mag;
    s_w1[e] = o - bo0;
    s_b0[e] = ((int)bo0) % ob;
  }
  __syncthreads();

  // rows: t[br, c, o] = sum_r W[r, br] * w_o(r, c)
  for (int e = tid; e < sb * P * ob; e += THREADS) {
    const int o = e % ob, c = (e / ob) % P, br = e / (ob * P);
    float acc = 0.0f;
    for (int r = 0; r < P; ++r) {
      const int i = r * P + c;
      const int b0 = s_b0[i];
      const int b1 = b0 + 1 == ob ? 0 : b0 + 1;
      const float w1 = s_w1[i];
      const float wt = b0 == o ? 1.0f - w1 : (b1 == o ? w1 : 0.0f);
      acc = acc + s_W[r * sb + br] * (s_val[i] * wt);
    }
    s_t[e] = acc;
  }
  __syncthreads();

  // columns: desc[br, bc, o] = sum_c W[c, bc] * t[br, c, o]
  float d = 0.0f;
  if (tid < nb) {
    const int o = tid % ob, bc = (tid / ob) % sb, br = tid / (ob * sb);
    for (int c = 0; c < P; ++c)
      d = d + s_W[c * sb + bc] * s_t[(br * P + c) * ob + o];
  }
  const float norm = sqrtf(block_sum(d * d, s_red));
  const float v = d / norm;
  const float clipped = v > max_bin ? max_bin : v;
  const int changed = __syncthreads_or(tid < nb && v > max_bin);
  const float norm2 =
      sqrtf(block_sum(tid < nb ? clipped * clipped : 0.0f, s_red));
  const float res = changed ? clipped / norm2 : clipped;
  if (tid < nb) {
    const float q = floorf(512.0f * res);
    out[(size_t)k * nb + tid] = q > 255.0f ? 255.0f : q;
  }
}

// patches: (K, P, P) float32; circ: (P, P) float32 circular mask;
// spatial: (P, sb) float32 spatial bin weights; n_support: the count of
// circ > 0.  out: (K, sb*sb*ob) float32 quantised values.  Returns
// cudaGetLastError().
extern "C" int hesaff_sift_desc(const float* patches, int K, int P,
                                const float* circ, const float* spatial,
                                int sb, int ob, float n_support,
                                float max_bin, float* out, void* stream) {
  if (P < 3 || sb < 1 || ob < 1 || sb * sb * ob > THREADS)
    return (int)cudaErrorInvalidValue;
  if (K == 0) return (int)cudaGetLastError();
  const size_t shmem = sizeof(float) * ((size_t)5 * P * P + P * sb +
                                        (size_t)sb * P * ob + THREADS);
  if (shmem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      sift_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (err != cudaSuccess) return (int)err;
  sift_kernel<<<K, THREADS, shmem, (cudaStream_t)stream>>>(
      patches, P, circ, spatial, sb, ob, n_support, max_bin, out);
  return (int)cudaGetLastError();
}
