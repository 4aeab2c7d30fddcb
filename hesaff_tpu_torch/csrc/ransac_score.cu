// Every RANSAC hypothesis' inlier count under the Sampson distance (K8):
// counts[h] = #{n : sampson(F_h, x_n, x'_n) < threshold}, for H
// fundamental matrices at N correspondences, with no (H, N) value ever
// stored.
//
// Replaces no TPU kernel: the JAX package scores its hypotheses with
// batched products left to XLA (hesaff_tpu/ransac.py), and the port's
// plain version is ransac._f_residuals followed by a compare and a sum.
// ransac._ransac calls this kernel, through ops/cuda_ransac, for the
// fundamental model on the card; the counts equal the plain version's
// bit for bit: each distance takes the same float32 operations in the
// same order, every product and sum rounded alone (__fmul_rn and
// __fadd_rn are never contracted, and the build keeps --fmad=false), the
// denominator clamped at 1e-12 where a NaN stays NaN (torch.clamp_min),
// the quotient correctly rounded (__fdiv_rn) and compared below the
// float32 threshold.  A NaN model counts no match.
//
// What bounds it on an H100: the float32 pipe.  The inputs are tiny (36
// bytes a model, 16 a match), and a pair of the sequential matcher is
// 10,000 hypotheses at up to ~55,000 matches, ~5.5e8 distances of ~45
// instructions each (20 for F x1's rows and F^T x2's first two, 5 for
// the numerator, 7 for the denominator, the clamp, the division's
// reciprocal and refinement, the compare and the count).  Written
// through cuBLAS as (H, N, 3) planes the same work read and wrote ~12 GB
// of device memory a pair.  What the design does about it:
// - each thread keeps PER_THREAD hypotheses' nine coefficients and
//   running counts in registers, so a match read once from shared memory
//   feeds PER_THREAD independent chains (instruction-level parallelism
//   for the four-cycle float pipe);
// - a CTA of THREADS threads holds HYPS hypotheses and walks one chunk of
//   the matches in tiles of TILE float4 (x, y, u, v), double-buffered
//   with cp.async; every thread reads each match of a tile as a broadcast;
// - the grid's second dimension cuts N into chunks, chosen by the
//   wrapper (cuda_ransac.plan) so that ~16 CTAs land on each SM even
//   where H gives only a few dozen CTAs of hypotheses;
// - a CTA adds its counts into the zeroed (H,) int32 output with integer
//   atomics: the sums do not depend on the order, so the result is
//   deterministic.
// One launch a call (after a memset of the counts) on the caller's
// stream, and no host sync.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 128
#define PER_THREAD 4
#define HYPS (THREADS * PER_THREAD)  // hypotheses a CTA holds
#define TILE 256                     // matches a stage holds (4 KB)
#define STAGES 2

__device__ __forceinline__ void copy16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int PENDING>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

// 1 where F's Sampson distance at (x, y) <-> (u, v) is under thr, in the
// operation order of ransac._f_residuals (and benchmark/reference/
// pairs.sampson): a, b, c = the rows of F x1, at, bt = the first two of
// F^T x2, num = (u a + v b + c)^2, den = a a + b b + at at + bt bt.
__device__ __forceinline__ int inlier(const float* f, float4 p, float thr) {
  const float x = p.x, y = p.y, u = p.z, v = p.w;
  const float a = __fadd_rn(__fadd_rn(__fmul_rn(f[0], x), __fmul_rn(f[1], y)),
                            f[2]);
  const float b = __fadd_rn(__fadd_rn(__fmul_rn(f[3], x), __fmul_rn(f[4], y)),
                            f[5]);
  const float c = __fadd_rn(__fadd_rn(__fmul_rn(f[6], x), __fmul_rn(f[7], y)),
                            f[8]);
  const float at = __fadd_rn(
      __fadd_rn(__fmul_rn(f[0], u), __fmul_rn(f[3], v)), f[6]);
  const float bt = __fadd_rn(
      __fadd_rn(__fmul_rn(f[1], u), __fmul_rn(f[4], v)), f[7]);
  const float e = __fadd_rn(__fadd_rn(__fmul_rn(u, a), __fmul_rn(v, b)), c);
  const float num = __fmul_rn(e, e);
  float den = __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)),
                __fmul_rn(at, at)),
      __fmul_rn(bt, bt));
  // clamp_min(1e-12): a NaN fails the compare and stays NaN
  den = den < 1e-12f ? 1e-12f : den;
  return __fdiv_rn(num, den) < thr;
}

// grid (ceil(H / HYPS), chunks): CTA (bx, by) scores hypotheses
// [bx HYPS, (bx + 1) HYPS) at matches [by chunk, (by + 1) chunk)
__global__ void __launch_bounds__(THREADS)
    ransac_score_kernel(const float* __restrict__ models, int H,
                        const float4* __restrict__ matches, int N,
                        float thr, int chunk, int* __restrict__ counts) {
  __shared__ __align__(16) float4 tile[STAGES][TILE];
  const int t = threadIdx.x;
  const int h0 = blockIdx.x * HYPS + t;
  float f[PER_THREAD][9];
  int cnt[PER_THREAD];
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    // a slot past H scores the last model again and writes nothing
    const int h = min(h0 + k * THREADS, H - 1);
#pragma unroll
    for (int i = 0; i < 9; ++i) f[k][i] = models[(size_t)h * 9 + i];
    cnt[k] = 0;
  }
  const int begin = blockIdx.y * chunk;
  const int end = min(N, begin + chunk);
  const int tiles = (end - begin + TILE - 1) / TILE;

  auto load = [&](int i) {
    const int base = begin + i * TILE;
    float4* dst = tile[i % STAGES];
    for (int j = t; j < TILE && base + j < end; j += THREADS)
      copy16(dst + j, matches + base + j);
    commit();
  };
  load(0);
  for (int i = 0; i < tiles; ++i) {
    if (i + 1 < tiles) {
      load(i + 1);
      wait_groups<1>();
    } else {
      wait_groups<0>();
    }
    __syncthreads();
    const float4* m = tile[i % STAGES];
    const int len = min(TILE, end - (begin + i * TILE));
#pragma unroll 2
    for (int j = 0; j < len; ++j) {
      const float4 p = m[j];
#pragma unroll
      for (int k = 0; k < PER_THREAD; ++k) cnt[k] += inlier(f[k], p, thr);
    }
    // the next load overwrites this stage
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int h = h0 + k * THREADS;
    if (h < H && cnt[k] != 0) atomicAdd(counts + h, cnt[k]);
  }
}

// models: (H, 3, 3) float32, row-major; matches: (N,) float4 (x, y, u, v),
// 16-byte aligned; counts: (H,) int32, zeroed here.  chunk: matches a CTA
// of the grid's second dimension walks, a multiple of TILE; chunks =
// ceil(N / chunk).
extern "C" int hesaff_ransac_score(const float* models, int H,
                                   const void* matches, int N, float thr,
                                   int chunk, int chunks, int* counts,
                                   void* stream) {
  if (H < 1 || N < 1 || chunk < TILE || chunk % TILE != 0 || chunks < 1 ||
      chunks > 65535 || (long long)(chunks - 1) * chunk >= N ||
      (long long)chunks * chunk < N || ((uintptr_t)matches & 15) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(counts, 0, (size_t)H * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((H + HYPS - 1) / HYPS, chunks);
  ransac_score_kernel<<<grid, THREADS, 0, st>>>(
      models, H, (const float4*)matches, N, thr, chunk, counts);
  return (int)cudaGetLastError();
}
