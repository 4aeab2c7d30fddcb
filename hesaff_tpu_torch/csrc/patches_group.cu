// Fused patch pipeline of a keypoint group: affine warp of the ws x ws
// workspace, OpenCV anti-alias blur and 41 x 41 bilinear subsample, one
// block per keypoint.
//
// Replaces the TPU kernel hesaff_tpu/ops/pallas_patches.py:
// patches_pallas (pallas_patches.py:521, pallas_call at :604), entered
// through extract_group_pallas (:643) and extract_group_pallas_scaled
// (:722).
//
// What bounds it on an H100: the per-keypoint arithmetic, not memory.
// A keypoint reads its workspace's samples (4 taps each, mostly from
// L2: neighbouring keypoints overlap) and writes one 41 x 41 patch, but
// the folded operator costs ~2 * ws * 41 * (KMAX + 1) + 2 * 41^2 *
// (KMAX + 1) flops on top of the ws^2 bilinear samples.  The workspace
// itself does not fit in shared memory (385^2 floats at the largest
// full-resolution group, 2049^2 at extract_batch's largest bucket), so
// it is never stored: the block walks it in tiles of TJ rows x TQ
// columns, samples each tile into shared memory, accumulates
// T = WS_rows . R^T (TJ x 41) over the column tiles, and then adds
// R[:, rows] . T into the 41 x 41 accumulator.  R (41 x ws) is stored
// as its band of KMAX + 1 columns per row, so shared memory is
// O(TJ*TQ + 41*(KMAX+2) + 41^2) whatever the workspace.  The TPU kernel
// DMA'd (8, 128)-aligned source windows into VMEM and sampled them with
// one-hot matmuls; a direct 4-tap gather from device memory gives the
// same samples.  Every sum runs in a fixed order, so results are
// deterministic.
//
// Semantics (ops/cuda_patches.py, patches_group_plain): for q, j in
// [0, ws): eff(q) = q - (ws >> 1); the sample sits at
// wx = x + eff(q) * a11, wy = (y + eff(q) * a21) + eff(j) * a22 and is
// bilinear (x blend first); it reads 0 and marks the keypoint bad unless
// 0 <= floor(wx) < W - 1 and 0 <= floor(wy) < H - 1.  R's row p: pos =
// (ws >> 1) + (p - P/2) * its, f = pos - floor(pos), band start
// floor(pos) - KMAX/2, entry m = taps[m] * (1 - f) + taps[m - 1] * f
// for columns in [0, ws - 1], plus the replicate-border mass
// (prefix / suffix sums of the taps, hat-weighted at floor(pos) and
// floor(pos) + 1) at columns 0 and ws - 1.  patch = R . WS . R^T.
// Inactive slots write a zero patch and bad = 1.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define THREADS 256
#define TJ 16
#define TQ 128
#define MAX_P 64

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void __launch_bounds__(THREADS) patches_kernel(
    const float* __restrict__ src, int H, int W,
    const int32_t* __restrict__ img_idx, const float* __restrict__ xs,
    const float* __restrict__ ys, const float* __restrict__ a11s,
    const float* __restrict__ a21s, const float* __restrict__ a22s,
    const int32_t* __restrict__ wss, const float* __restrict__ itss,
    const float* __restrict__ taps, const uint8_t* __restrict__ active,
    int kmax, int P, float* __restrict__ out, int32_t* __restrict__ bad) {
  extern __shared__ float sm[];
  const int KW = kmax + 1;
  float* s_taps = sm;                        // kmax
  float* s_pre = s_taps + kmax;              // KW: sum of taps[t < j]
  float* s_suf = s_pre + KW;                 // KW: sum of taps[t >= j]
  float* s_R = s_suf + KW;                   // P x KW band of R
  float* s_acc = s_R + P * KW;               // P x P patch
  float* s_T = s_acc + P * P;                // TJ x P
  float* s_tile = s_T + TJ * P;              // TJ x TQ workspace tile
  float* s_f = s_tile + TJ * TQ;             // P
  float* s_cl = s_f + P;                     // P
  float* s_cr = s_cl + P;                    // P
  int* s_start = (int*)(s_cr + P);           // P: band start column

  const int k = blockIdx.x;
  const int tid = threadIdx.x;
  const int PP = P * P;
  float* patch = out + (size_t)k * PP;
  if (!active[k]) {
    for (int e = tid; e < PP; e += THREADS) patch[e] = 0.0f;
    if (tid == 0) bad[k] = 1;
    return;
  }
  const int w = wss[k];
  const int r = kmax >> 1;
  const float its = itss[k];
  for (int t = tid; t < kmax; t += THREADS)
    s_taps[t] = taps[(size_t)k * kmax + t];
  __syncthreads();
  for (int j = tid; j < KW; j += THREADS) {
    float a = 0.0f;
    for (int t = 0; t < j; ++t) a = a + s_taps[t];
    s_pre[j] = a;
    float b = 0.0f;
    for (int t = kmax - 1; t >= j; --t) b = b + s_taps[t];
    s_suf[j] = b;
  }
  __syncthreads();
  const float ofs = (float)(w >> 1);
  for (int p = tid; p < P; p += THREADS) {
    const float kf = (float)(p - (P >> 1));
    const float pos = ofs + kf * its;
    const float p0f = floorf(pos);
    const float f = pos - p0f;
    const int p0 = (int)p0f;
    s_start[p] = p0 - r;
    s_f[p] = f;
    s_cl[p] = (1.0f - f) * s_pre[clampi(r - p0, 0, kmax)] +
              f * s_pre[clampi(r - p0 - 1, 0, kmax)];
    s_cr[p] = (1.0f - f) * s_suf[clampi(w - p0 + r, 0, kmax)] +
              f * s_suf[clampi(w - p0 - 1 + r, 0, kmax)];
  }
  __syncthreads();
  for (int e = tid; e < P * KW; e += THREADS) {
    const int p = e / KW, m = e - (e / KW) * KW;
    const int col = s_start[p] + m;
    const float f = s_f[p];
    float v = 0.0f;
    if (col >= 0 && col < w) {
      const float t0 = m < kmax ? s_taps[m] : 0.0f;
      const float t1 = m >= 1 ? s_taps[m - 1] : 0.0f;
      v = t0 * (1.0f - f) + t1 * f;
      if (col == 0) v = v + s_cl[p];
      if (col == w - 1) v = v + s_cr[p];
    }
    s_R[e] = v;
  }
  for (int e = tid; e < PP; e += THREADS) s_acc[e] = 0.0f;

  const float* img = src + (size_t)img_idx[k] * H * W;
  const float x = xs[k], y = ys[k];
  const float a11 = a11s[k], a21 = a21s[k], a22 = a22s[k];
  const float half = (float)(w >> 1);
  const float fW1 = (float)(W - 1), fH1 = (float)(H - 1);
  bool touched = false;
  for (int j0 = 0; j0 < w; j0 += TJ) {
    for (int e = tid; e < TJ * P; e += THREADS) s_T[e] = 0.0f;
    for (int q0 = 0; q0 < w; q0 += TQ) {
      for (int e = tid; e < TJ * TQ; e += THREADS) {
        const int j = j0 + e / TQ, q = q0 + (e % TQ);
        float v = 0.0f;
        if (j < w && q < w) {
          const float effq = (float)q - half, effj = (float)j - half;
          const float wx = x + effq * a11;
          const float wy = (y + effq * a21) + effj * a22;
          const float x0f = floorf(wx), y0f = floorf(wy);
          if (x0f >= 0.0f && x0f < fW1 && y0f >= 0.0f && y0f < fH1) {
            const float fx = wx - x0f, fy = wy - y0f;
            const float* s = img + (size_t)(int)y0f * W + (int)x0f;
            const float xa = (1.0f - fx) * s[0] + fx * s[1];
            const float xb = (1.0f - fx) * s[W] + fx * s[W + 1];
            v = (1.0f - fy) * xa + fy * xb;
          } else {
            touched = true;
          }
        }
        s_tile[e] = v;
      }
      __syncthreads();
      // T[jj, p'] += sum over the tile's columns in R[p']'s band
      const int qhi = min(q0 + TQ, w);
      for (int e = tid; e < TJ * P; e += THREADS) {
        const int jj = e / P, pp = e - (e / P) * P;
        if (j0 + jj >= w) continue;
        const int st = s_start[pp];
        const int lo = max(st, q0), hi = min(st + KW, qhi);
        const float* tr = s_tile + jj * TQ - q0;
        const float* rr = s_R + pp * KW - st;
        float a = 0.0f;
        for (int c = lo; c < hi; ++c) a = a + tr[c] * rr[c];
        s_T[e] = s_T[e] + a;
      }
      __syncthreads();
    }
    // acc[p, p'] += sum over the tile's rows in R[p]'s band
    const int jhi = min(j0 + TJ, w);
    for (int e = tid; e < PP; e += THREADS) {
      const int p = e / P, pp = e - (e / P) * P;
      const int st = s_start[p];
      const int lo = max(st, j0), hi = min(st + KW, jhi);
      const float* rr = s_R + p * KW - st;
      float a = 0.0f;
      for (int j = lo; j < hi; ++j) a = a + rr[j] * s_T[(j - j0) * P + pp];
      s_acc[e] = s_acc[e] + a;
    }
    __syncthreads();
  }
  const int any_bad = __syncthreads_or(touched ? 1 : 0);
  for (int e = tid; e < PP; e += THREADS) patch[e] = s_acc[e];
  if (tid == 0) bad[k] = any_bad ? 1 : 0;
}

// src: (B, H, W) float32, contiguous.  Per keypoint (K): img_idx, ws
// int32; x, y, a11, a21, a22, its float32 (source pixels); taps
// (K, kmax) float32; active uint8.  Outputs: out (K, P, P) float32, bad
// (K) int32.  Returns cudaGetLastError().
extern "C" int hesaff_patches_group(
    const float* src, int B, int H, int W, const int32_t* img_idx,
    const float* x, const float* y, const float* a11, const float* a21,
    const float* a22, const int32_t* ws, const float* its, const float* taps,
    const uint8_t* active, int kmax, int K, int P, float* out, int32_t* bad,
    void* stream) {
  if (B < 1 || H < 2 || W < 2 || kmax < 1 || kmax % 2 == 0 || P < 1 ||
      P > MAX_P)
    return (int)cudaErrorInvalidValue;
  if (K == 0) return (int)cudaGetLastError();
  const int KW = kmax + 1;
  const size_t shmem =
      sizeof(float) * ((size_t)kmax + 2 * KW + (size_t)P * KW + P * P +
                       TJ * P + TJ * TQ + 4 * P);
  if (shmem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      patches_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shmem);
  if (err != cudaSuccess) return (int)err;
  patches_kernel<<<K, THREADS, shmem, (cudaStream_t)stream>>>(
      src, H, W, img_idx, x, y, a11, a21, a22, ws, its, taps, active, kmax, P,
      out, bad);
  return (int)cudaGetLastError();
}
