// Baumberg-Lindeberg affine shape adaptation, one warp per keypoint.
//
// Replaces the TPU kernel hesaff_tpu/ops/pallas_affine.py: _call_kernel
// (pallas_affine.py:474, pallas_call at :518), entered through
// adapt_flat_pallas (:556).
//
// What bounds it on an H100: the steps and the latency of the longest
// keypoint's chain of them, not bytes.  A keypoint runs up to 16
// dependent Baumberg steps (sample the grid, gradients, three warp sums,
// a serial 2x2 chain of IEEE square roots and divisions), and a launch
// cannot end before its longest chain; the grid's footprint (20-50 px a
// side) stays in L1/L2 from step to step.  A step is ~1,400
// instructions of one warp (~40 float operations a sample under
// --fmad=false, 12 samples a lane, and the chain), so the large
// launches are bound by issue and the small ones by one chain's length.
// What the design does about it:
// - the grid side G is a template parameter (an instance for 19, the
//   configuration's, and a generic one for any G whose grid and mask fit
//   the shared memory, G <= 107, that walks the grid in batches of 8
//   samples a lane; above G = 49 its block takes more than the default
//   48 KB of shared memory), so each lane's sample offsets are
//   computed once before the step loop and its 12 samples are unrolled:
//   all 48 gathers of a step are issued before the first is used, one
//   round trip a step rather than twelve;
// - the grid is persistent (as many blocks as fit on the SMs, at <= 128
//   registers a thread for 16 warps an SM) and a warp takes its next
//   slot from a device-side counter (zeroed by the entry point on the
//   stream, no host sync) when it finishes one, so a 16-step chain
//   holds one warp rather than a block of four, and the short chains
//   flow around it; an inactive slot is written and skipped at once;
// - a keypoint stays on one warp: spread over four warps (the ordered
//   sums kept in one) its small launches ran faster but its large ones
//   slower, the six launches of a batch 3-7% slower in all, and over two
//   warps 20% slower (PERF.md, PR 6);
// - the 120 x 120 sampling window is not staged: it is several times
//   the grid's footprint, which the caches already hold.
//
// Semantics: hesaff_tpu/affine_shape.py:_adapt_one with the quantize_x
// sampler (warp.py:95-168): window origin r0 = clip(int(ly) - win/2, 0,
// H - win); a sample outside the image reads 0 and does not drop the
// keypoint; a sample inside the image but outside the window sets
// `violated`; unhalved gradients, one-sided at the grid edges; SMM sums
// divided by the grid size (lane-strided partial sums in index order,
// then an xor butterfly: the plain version sums in this order too, so
// kernel and plain version agree bit for bit); linalg.inv_sqrt_2x2 /
// eigenvalues_2x2 operation by operation; ratio_bef starts at 0 so the
// first iteration may converge.  Inactive slots write ok = 0, U = I,
// iters = 0.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define WARPS 4
#define SHMEM_MAX 232448  // bytes of shared memory a block may use
#define FULL 0xffffffffu
// samples a lane gathers together in the generic instance
#define GENERIC_BATCH 8

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}
__device__ __forceinline__ float nmax(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : (a > b ? a : b);
}
__device__ __forceinline__ float nmin(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : (a < b ? a : b);
}

// Grid offsets (column - G/2, row - G/2) of samples n = base + lane +
// 32 s, s < SB; 0 past the grid.
template <int SB>
__device__ __forceinline__ void grid_offsets(int base, int lane, int G,
                                             float (&fi)[SB],
                                             float (&fj)[SB]) {
  const int half = G >> 1;
#pragma unroll
  for (int s = 0; s < SB; ++s) {
    const int n = base + lane + 32 * s;
    const int jr = n / G, ic = n - jr * G;
    const bool in = n < G * G;
    fi[s] = in ? (float)(ic - half) : 0.0f;
    fj[s] = in ? (float)(jr - half) : 0.0f;
  }
}

struct Frame {
  const float* img;  // the keypoint's plane
  int W;
  float fW1, fH1, lx, ly, r0, c0, lim;
};

// Bilinear samples n = base + lane + 32 s (s < SB) of the warped grid
// into s_val.  Every gather of the batch is issued before the first is
// used; a sample outside the image reads the plane's first pixels and
// is zeroed.  Returns whether a sample of this lane lies inside the
// image but outside the window.
template <int SB>
__device__ __forceinline__ bool sample_batch(
    const Frame& f, const float (&fi)[SB], const float (&fj)[SB], int base,
    int lane, int N, float a11r, float a12r, float a21r, float a22r,
    float* s_val) {
  float fx[SB], fy[SB], q00[SB], q01[SB], q10[SB], q11[SB];
  bool inb[SB];
  bool oow = false;
#pragma unroll
  for (int s = 0; s < SB; ++s) {
    const float wx = (f.lx + fi[s] * a11r) + fj[s] * a12r;
    const float wy = (f.ly + fi[s] * a21r) + fj[s] * a22r;
    const float x0f = floorf(wx), y0f = floorf(wy);
    inb[s] = base + lane + 32 * s < N && x0f >= 0.0f && y0f >= 0.0f &&
             x0f < f.fW1 && y0f < f.fH1;
    fx[s] = wx - x0f;
    fy[s] = wy - y0f;
    const int o = inb[s] ? (int)y0f * f.W + (int)x0f : 0;
    q00[s] = f.img[o];
    q01[s] = f.img[o + 1];
    q10[s] = f.img[o + f.W];
    q11[s] = f.img[o + f.W + 1];
    const float dy = y0f - f.r0, dx = x0f - f.c0;
    oow = oow || (inb[s] && (dy < 0.0f || dy > f.lim || dx < 0.0f ||
                             dx > f.lim));
  }
  // keeps the scheduler from pulling each sample's arithmetic up to its
  // own gathers, which would wait on them one sample at a time
  __syncwarp();
#pragma unroll
  for (int s = 0; s < SB; ++s) {
    const float qa = (1.0f - fx[s]) * q00[s] + fx[s] * q01[s];
    const float qb = (1.0f - fx[s]) * q10[s] + fx[s] * q11[s];
    const float v = (1.0f - fy[s]) * qa + fy[s] * qb;
    const int n = base + lane + 32 * s;
    if (n < N) s_val[n] = inb[s] ? v : 0.0f;
  }
  return oow;
}

// Masked second-moment terms of grid sample n, added to the lane's sums.
__device__ __forceinline__ void smm_add(const float* s_val,
                                        const float* s_mask, int n, int G,
                                        float& pa, float& pb, float& pc) {
  const int jr = n / G, ic = n - jr * G;
  const float* v = s_val + n;
  const float gx = ic == 0 ? v[1] - v[0]
                 : (ic == G - 1 ? v[0] - v[-1] : v[1] - v[-1]);
  const float gy = jr == 0 ? v[G] - v[0]
                 : (jr == G - 1 ? v[0] - v[-G] : v[G] - v[-G]);
  const float m = s_mask[n];
  pa = pa + (gx * gx) * m;
  pb = pb + (gx * gy) * m;
  pc = pc + (gy * gy) * m;
}

// GC: the grid side at compile time (0: the generic instance, side g).
template <int GC>
__global__ void __launch_bounds__(32 * WARPS, 4) affine_kernel(
    const float* __restrict__ stack, long long s_img, long long s_lvl, int H,
    int W, const int32_t* __restrict__ img_idx,
    const int32_t* __restrict__ src, const float* __restrict__ lx_,
    const float* __restrict__ ly_, const float* __restrict__ ratio_,
    const uint8_t* __restrict__ active, int K,
    const float* __restrict__ mask, int g, int win, int max_iter,
    float conv_thr, float aniso_max, int32_t* __restrict__ ok_out,
    float* __restrict__ u_out, int32_t* __restrict__ iters_out,
    int* __restrict__ next, unsigned long long* __restrict__ steps_total) {
  constexpr int SB = GC ? (GC * GC + 31) / 32 : GENERIC_BATCH;
  const int G = GC ? GC : g;
  const int N = G * G;
  extern __shared__ float sm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* s_mask = sm;
  float* s_val = sm + N + warp * N;
  for (int e = threadIdx.x; e < N; e += blockDim.x) s_mask[e] = mask[e];
  __syncthreads();

  float fi[SB], fj[SB];
  if (GC) grid_offsets<SB>(0, lane, G, fi, fj);
  const float npx = (float)N;
  Frame f;
  f.W = W;
  f.fW1 = (float)(W - 1);
  f.fH1 = (float)(H - 1);
  f.lim = (float)(win - 2);

  // the first slot of a warp is its index in the grid; the rest come
  // from the counter, past those
  const int first = gridDim.x * WARPS;
  int warp_steps = 0;  // Baumberg steps this warp ran, over its slots
  for (int k = blockIdx.x * WARPS + warp; k < K;) {
    if (!active[k]) {
      if (lane == 0) {
        ok_out[k] = 0;
        u_out[4 * k + 0] = 1.0f;
        u_out[4 * k + 1] = 0.0f;
        u_out[4 * k + 2] = 0.0f;
        u_out[4 * k + 3] = 1.0f;
        iters_out[k] = 0;
      }
    } else {
      f.img = stack + img_idx[k] * s_img + src[k] * s_lvl;
      f.lx = lx_[k];
      f.ly = ly_[k];
      const float ratio = ratio_[k];
      f.r0 = (float)clampi((int)f.ly - win / 2, 0, H - win);
      f.c0 = (float)clampi((int)f.lx - win / 2, 0, W - win);

      float u11 = 1.0f, u12 = 0.0f, u21 = 0.0f, u22 = 1.0f;
      float ratio_bef = 0.0f;
      bool converged = false, violated = false;
      int conv_iter = 0;
      int ran = max_iter;  // steps run, as adapt_batch_plain counts them

      for (int l = 0; l < max_iter; ++l) {
        const float a11r = u11 * ratio, a12r = u12 * ratio;
        const float a21r = u21 * ratio, a22r = u22 * ratio;
        bool oow = false;
        if (GC) {
          oow = sample_batch<SB>(f, fi, fj, 0, lane, N, a11r, a12r, a21r,
                                 a22r, s_val);
        } else {
          for (int base = 0; base < N; base += 32 * SB) {
            grid_offsets<SB>(base, lane, G, fi, fj);
            const bool o = sample_batch<SB>(f, fi, fj, base, lane, N, a11r,
                                            a12r, a21r, a22r, s_val);
            oow = oow || o;
          }
        }
        violated = violated || __any_sync(FULL, oow);
        __syncwarp();

        // lane-strided partial sums in index order
        float pa = 0.0f, pb = 0.0f, pc = 0.0f;
        if (GC) {
#pragma unroll
          for (int s = 0; s < SB; ++s) {
            const int n = lane + 32 * s;
            if (n < N) smm_add(s_val, s_mask, n, G, pa, pb, pc);
          }
        } else {
          for (int n = lane; n < N; n += 32)
            smm_add(s_val, s_mask, n, G, pa, pb, pc);
        }
        __syncwarp();  // s_val is rewritten by the next iteration
        for (int o = 16; o > 0; o >>= 1) {
          pa = pa + __shfl_xor_sync(FULL, pa, o);
          pb = pb + __shfl_xor_sync(FULL, pb, o);
          pc = pc + __shfl_xor_sync(FULL, pc, o);
        }
        // every lane holds the same sums; take lane 0's to be explicit
        const float a = __shfl_sync(FULL, pa, 0) / npx;
        const float b = __shfl_sync(FULL, pb, 0) / npx;
        const float c = __shfl_sync(FULL, pc, 0) / npx;

        // inv_sqrt_2x2 (linalg.py:84-111)
        const bool nz = b != 0.0f;
        const float r_angle = nz ? (c - a) / (2.0f * b) : 0.0f;
        const float root = sqrtf(1.0f + r_angle * r_angle);
        const float t = r_angle >= 0.0f ? 1.0f / (r_angle + root)
                                        : -1.0f / (-r_angle + root);
        float cs = 1.0f / sqrtf(1.0f + t * t);
        float sn = t * cs;
        if (!nz) {
          cs = 1.0f;
          sn = 0.0f;
        }
        float x = 1.0f / sqrtf(((cs * cs) * a - ((2.0f * cs) * sn) * b) +
                               (sn * sn) * c);
        float z = 1.0f / sqrtf(((sn * sn) * a + ((2.0f * cs) * sn) * b) +
                               (cs * cs) * c);
        const float d = sqrtf(x * z);
        x = x / d;
        z = z / d;
        const float il1 = nmax(x, z), il2 = nmin(x, z);
        const float ia = (cs * cs) * x + (sn * sn) * z;
        const float ib = ((-cs) * sn) * x + (sn * cs) * z;
        const float ic = (sn * sn) * x + (cs * cs) * z;
        const float ratio_act = 1.0f - il2 / il1;

        const float n11 = ia * u11 + ib * u21;
        const float n12 = ia * u12 + ib * u22;
        const float n21 = ib * u11 + ic * u21;
        const float n22 = ib * u12 + ic * u22;

        // eigenvalues_2x2 (linalg.py:114-126)
        const float trace = n11 + n22;
        const float delta1 = trace * trace - 4.0f * (n11 * n22 - n12 * n21);
        const bool is_real = delta1 >= 0.0f;
        const float delta = sqrtf(nmax(delta1, 0.0f));
        const float l1 = (trace + delta) / 2.0f;
        const float l2 = (trace - delta) / 2.0f;
        const bool aniso_bad = !is_real || (l1 / l2 > aniso_max) ||
                               (l2 / l1 > aniso_max);
        const bool just_conv = (ratio_act < conv_thr) &&
                               (ratio_bef < conv_thr) && !aniso_bad;

        u11 = n11;
        u12 = n12;
        u21 = n21;
        u22 = n22;
        ratio_bef = ratio_act;
        if (just_conv) {
          conv_iter = l;
          converged = true;
        }
        if (aniso_bad || just_conv) {
          ran = l + 1;
          break;
        }
      }
      warp_steps += ran;
      if (lane == 0) {
        ok_out[k] = (converged && !violated) ? 1 : 0;
        u_out[4 * k + 0] = u11;
        u_out[4 * k + 1] = u12;
        u_out[4 * k + 2] = u21;
        u_out[4 * k + 3] = u22;
        iters_out[k] = conv_iter;
      }
    }
    int t = 0;
    if (lane == 0) t = atomicAdd(next, 1);
    k = first + __shfl_sync(FULL, t, 0);
  }
  if (steps_total != nullptr && lane == 0 && warp_steps > 0)
    atomicAdd(steps_total, (unsigned long long)warp_steps);
}

template <int GC>
static int launch(const float* stack, long long s_img, long long s_lvl,
                  int H, int W, const int32_t* img_idx, const int32_t* src,
                  const float* lx, const float* ly, const float* ratio,
                  const uint8_t* active, int K, const float* mask, int G,
                  int win, int max_iter, float conv_thr, float aniso_max,
                  int32_t* ok, float* u, int32_t* iters, int* next,
                  unsigned long long* steps, cudaStream_t stream) {
  const size_t shmem = sizeof(float) * (size_t)G * G * (1 + WARPS);
  int dev, sms, per_sm;
  cudaError_t err = cudaSuccess;
  if (shmem > 48 * 1024)
    err = cudaFuncSetAttribute(affine_kernel<GC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)shmem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, affine_kernel<GC>, 32 * WARPS, shmem);
  if (err == cudaSuccess) err = cudaMemsetAsync(next, 0, sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  const long long want = (K + WARPS - 1) / WARPS;
  const long long fit = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int blocks = (int)(want < fit ? want : fit);
  affine_kernel<GC><<<blocks, 32 * WARPS, shmem, stream>>>(
      stack, s_img, s_lvl, H, W, img_idx, src, lx, ly, ratio, active, K,
      mask, G, win, max_iter, conv_thr, aniso_max, ok, u, iters, next,
      steps);
  return (int)cudaGetLastError();
}

// The instance grid side G takes: 0 the one for 19, 1 the generic one,
// -1 none (G < 3, or a grid and mask over the shared memory).  *shmem:
// the block's bytes.
extern "C" int hesaff_affine_instance(int G, long long* shmem) {
  *shmem = (long long)(sizeof(float) * (size_t)G * G * (1 + WARPS));
  if (G < 3 || *shmem > SHMEM_MAX) return -1;
  return G == 19 ? 0 : 1;
}

// stack: float planes; keypoint k samples the plane at
// stack + img_idx[k] * s_img + src[k] * s_lvl (elements), rows of W
// contiguous floats.  mask: G*G floats.  Outputs: ok (K) i32, u (K,4)
// f32, iters (K) i32.  next: one int of device scratch (the slot
// counter, zeroed here on the stream).  steps: null, or one int64 on
// the device to which the Baumberg steps every active keypoint ran are
// added (one atomic a warp).  Returns the first CUDA error.
extern "C" int hesaff_affine_adapt(
    const float* stack, long long s_img, long long s_lvl, int H, int W,
    const int32_t* img_idx, const int32_t* src, const float* lx,
    const float* ly, const float* ratio, const uint8_t* active, int K,
    const float* mask, int G, int win, int max_iter, float conv_thr,
    float aniso_max, int32_t* ok, float* u, int32_t* iters, int* next,
    long long* steps, void* stream) {
  long long shmem = 0;
  const int inst = hesaff_affine_instance(G, &shmem);
  if (inst < 0 || win < 2 || win > H || win > W)
    return (int)cudaErrorInvalidValue;
  if (K == 0) return (int)cudaGetLastError();
  return (inst == 0 ? launch<19> : launch<0>)(
      stack, s_img, s_lvl, H, W, img_idx, src, lx, ly, ratio, active, K,
      mask, G, win, max_iter, conv_thr, aniso_max, ok, u, iters, next,
      (unsigned long long*)steps, (cudaStream_t)stream);
}
