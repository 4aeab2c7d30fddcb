// Fused patch pipeline of a keypoint group: affine warp of the ws x ws
// workspace, OpenCV anti-alias blur and 41 x 41 bilinear subsample, one
// block per keypoint.
//
// Replaces the TPU kernel hesaff_tpu/ops/pallas_patches.py:
// patches_pallas (pallas_patches.py:521, pallas_call at :604), entered
// through extract_group_pallas (:643) and extract_group_pallas_scaled
// (:722).
//
// What bounds it on an H100: the arithmetic and the latency of each
// keypoint's chain of steps, not memory.  A keypoint reads its
// workspace's samples (4 taps each, mostly from L1 / L2: neighbouring
// samples and keypoints overlap) and writes one 41 x 41 patch, about
// 0.1 ms of bytes for the serving path's six groups; the folded
// operator patch = R . WS . R^T costs 2 * ws * 41 * band + 2 * 41^2 *
// band flops (band: the keypoint's own blur width + 1) on top of ~10
// flops a bilinear sample, about 7 GFLOP a batch, also ~0.1 ms of f32
// FMA.  What held the first version far above both: one 256-thread
// block and a fixed 16 x 128 sampling tile whatever the workspace, so a
// ws <= 49 keypoint left most threads idle; both products as serial dot
// products that loaded both operands from shared memory for each
// multiply-add; a band as wide as the bucket's largest keypoint; fmad
// off in the products.
//
// The design:
// - Tile geometries picked from the bucket's KMAX (kGeoms, chosen by
//   timing, PERF.md PR 4): four warps with the whole ws <= 52 workspace
//   in shared memory (30 KB, seven blocks an SM), eight warps with the
//   whole ws <= 97 workspace (one strip, one chunk, 75 KB, three blocks
//   an SM), or eight warps over strips of 44 rows x 196-column chunks
//   for larger workspaces.  Any ws runs in any of them; only the speed
//   differs.  Patches of more than 64 px (MAX_P) take a fifth, generic
//   geometry: eight warps whose patch accumulator lives in shared
//   memory (P x P4 floats, not NA tiles of registers a thread), a loop
//   over as many tile passes as the patch needs, and a chunk of
//   max(128, P4) columns, so that the strip's rows of R^T fit the
//   sample buffer; a patch of up to ~148 px fits the 232,448 bytes with
//   the tails' KMAX, and past that the wrapper raises.  A block holds
//   one keypoint: shared memory a keypoint sets the occupancy, and
//   several keypoints a block would need as much each (launch bounds
//   cap the registers to match).
// - A strip is sampled in one pass (each thread four rows of one
//   column, all sixteen taps in flight, stored as one 16-byte word of
//   the transposed strip WS^T[q][j]); R is stored dense and transposed,
//   RQ[c][p], for the chunk, and only its nonzero band entries are
//   computed (the rest is zero-filled).
// - Register tiling for both products: T = WS . R^T in tiles of 4 (or
//   2) workspace rows x 4 patch columns, patch = R . T in tiles of 4
//   (or 2) patch rows x 4 patch columns, the patch held in registers
//   across strips.  Each step of the unrolled inner loop loads one
//   16-byte word of each operand and issues 16 (8) fmaf, instead of two
//   loads per multiply-add.
// - The loops run over the keypoint's own band: R's nonzero columns for
//   a block of patch rows lie in [first nonzero tap, last nonzero tap +
//   1] shifted by the row's floor(pos), so a keypoint whose taps are
//   narrower than KMAX does no work on the zero taps.  A warp iterates
//   over the union of its lanes' ranges (one shared loop, warp-uniform
//   loads; the extra terms multiply exact zeros of R).
// - The two products use explicit fmaf(); the rest of the file keeps
//   --fmad=false, so the sample coordinates wx, wy and their floor
//   round exactly as the plain version's and the bad flags agree.
// - The per-keypoint prefix / suffix sums of the taps (the blur's
//   replicate-border mass) are two warp scans.
// - The reads are a data-dependent affine gather, not tiles, so TMA
//   does not fit; samples are direct 4-tap loads through L1.  The TPU
//   kernel DMA'd (8, 128)-aligned source windows into VMEM and sampled
//   them with one-hot matmuls.  Tensor cores are not used (PERF.md, PR
//   4: what remains is latency and the gathers, not FMA throughput).
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
#include <limits.h>
#include <math.h>
#include <stdint.h>

#define MAX_P 64
#define FULL 0xffffffffu

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// TR consecutive floats (TR = 2 or 4) from 4 * TR-byte aligned shared
// memory
template <int TR>
__device__ __forceinline__ void load_rows(const float* s, float* v) {
  if (TR == 4) {
    const float4 a = *(const float4*)s;
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
  } else {
    const float2 a = *(const float2*)s;
    v[0] = a.x;
    v[1] = a.y;
  }
}

// One register tile of a product: c[i][.] (+)= sum_q a[q * as + i] *
// b[q * bs + .] over q in [lo, hi), TR rows of a (a 4 * TR-byte word)
// against 4 columns of b (16 bytes) a step, fmaf in q order.
template <int TR>
__device__ __forceinline__ void tile_fma(const float* a, int as,
                                         const float* b, int bs, int lo,
                                         int hi, float (&c)[TR][4]) {
#pragma unroll 4
  for (int q = lo; q < hi; ++q) {
    float av[TR];
    load_rows<TR>(a + q * as, av);
    const float4 bv = *(const float4*)(b + q * bs);
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      c[i][0] = fmaf(av[i], bv.x, c[i][0]);
      c[i][1] = fmaf(av[i], bv.y, c[i][1]);
      c[i][2] = fmaf(av[i], bv.z, c[i][2]);
      c[i][3] = fmaf(av[i], bv.w, c[i][3]);
    }
  }
}

// Per-keypoint state of R in shared memory.
struct RView {
  const float* tp;   // taps with one zero on each side: tp[m + 1] = taps[m]
  const int* st;     // band start floor(pos) - KMAX/2 per patch row
  const float* f;    // pos - floor(pos)
  const float* cl;   // replicate-border mass at column 0
  const float* cr;   // and at column ws - 1
  int P, kmax, w;
};

// R[p][c], the plain version's arithmetic (fold_operator)
__device__ __forceinline__ float r_entry(const RView& R, int c, int p) {
  if (p >= R.P || c >= R.w) return 0.0f;
  const int m = c - R.st[p];
  float v = 0.0f;
  if (m >= 0 && m <= R.kmax) {
    const float f = R.f[p];
    v = R.tp[m + 1] * (1.0f - f) + R.tp[m] * f;
  }
  if (c == 0) v = v + R.cl[p];
  if (c == R.w - 1) v = v + R.cr[p];
  return v;
}

// dst[(c - c0) * P4 + p] = R[p][c] for c in [c0, c0 + n): zeros, then
// each row's entries inside its nonzero range [cs[p], ce[p]), TPB / 8
// lanes a row.  Ends with a barrier.
template <int TPB>
__device__ __forceinline__ void fill_rt(const RView& R, float* dst, int c0,
                                        int n, int P4, const int* cs,
                                        const int* ce) {
  constexpr int LPR = TPB / 8;
  float4* d4 = (float4*)dst;
  for (int e = threadIdx.x; e < n * P4 / 4; e += TPB)
    d4[e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  __syncthreads();
  for (int p = threadIdx.x / LPR; p < R.P; p += 8) {
    const int hi = min(ce[p], c0 + n);
    for (int c = max(cs[p], c0) + threadIdx.x % LPR; c < hi; c += LPR)
      dst[(c - c0) * P4 + p] = r_entry(R, c, p);
  }
  __syncthreads();
}

// SR: workspace rows a strip, CW: columns a chunk, TR: rows of a
// register tile, NA: patch tiles a thread, MINB: blocks an SM should
// hold (it caps the registers a thread); SACC: the patch accumulates in
// shared memory over tile passes (NA unused) and a chunk spans
// max(CW, P4) columns.
template <int TPB, int TR, int SR, int CW, int NA, int MINB, bool SACC>
__global__ void __launch_bounds__(TPB, MINB) patches_kernel(
    const float* __restrict__ src, int H, int W,
    const int32_t* __restrict__ img_idx, const float* __restrict__ xs,
    const float* __restrict__ ys, const float* __restrict__ a11s,
    const float* __restrict__ a21s, const float* __restrict__ a22s,
    const int32_t* __restrict__ wss, const float* __restrict__ itss,
    const float* __restrict__ taps, const uint8_t* __restrict__ active,
    int kmax, int P, float* __restrict__ out, int32_t* __restrict__ bad) {
  // strip pitch: a multiple of 4 whose quarter is odd, so that the
  // sampling's 16-byte stores (lanes on consecutive columns) do not
  // collide in a bank
  constexpr int SRP = ((SR / 4) % 2 == 1) ? SR : SR + 4;
  extern __shared__ __align__(16) float sm[];
  const int P4 = (P + 3) & ~3, NPB = P4 / 4, NRB = (P + TR - 1) / TR;
  const int CWv = SACC ? max(CW, P4) : CW;
  float* s_rq = sm;                      // CWv x P4: R^T of the chunk
  float* s_t = s_rq + CWv * P4;          // SR x P4: T of the strip
  float* s_ws = s_t + SR * P4;           // CWv x SRP: WS^T (or R^T rows)
  float* s_tp = s_ws + CWv * SRP;        // kmax + 2
  float* s_pre = s_tp + kmax + 2;        // kmax + 1: sum of taps[t < j]
  float* s_suf = s_pre + kmax + 1;       // kmax + 1: sum of taps[t >= j]
  float* s_f = s_suf + kmax + 1;         // P4
  float* s_cl = s_f + P4;                // P4
  float* s_cr = s_cl + P4;               // P4
  int* s_st = (int*)(s_cr + P4);         // P4
  int* s_cs = s_st + P4;                 // P4: a row's nonzero columns
  int* s_ce = s_cs + P4;                 // P4
  int* s_tlo = s_ce + P4;                // NPB: union of 4 rows' ranges
  int* s_thi = s_tlo + NPB;              // NPB
  int* s_alo = s_thi + NPB;              // NRB: union of TR rows' ranges
  int* s_ahi = s_alo + NRB;              // NRB
  int* s_band = s_ahi + NRB;             // first, last nonzero tap
  // SACC: NRB * TR x P4, the patch's sums, at the next 16-byte boundary
  float* s_acc =
      (float*)(((uintptr_t)(s_band + 2) + 15) & ~(uintptr_t)15);

  const int k = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int PP = P * P;
  float* patch = out + (size_t)k * PP;
  if (!active[k]) {
    for (int e = tid; e < PP; e += TPB) patch[e] = 0.0f;
    if (tid == 0) bad[k] = 1;
    return;
  }
  const int w = wss[k];
  const int r = kmax >> 1;
  const float its = itss[k];
  // the keypoint's parameters, loaded early: their latency hides behind
  // the operator's set-up
  const float* img = src + (size_t)img_idx[k] * H * W;
  const float x = xs[k], y = ys[k];
  const float a11 = a11s[k], a21 = a21s[k], a22 = a22s[k];
  for (int t = tid; t < kmax + 2; t += TPB)
    s_tp[t] = (t >= 1 && t <= kmax) ? taps[(size_t)k * kmax + t - 1] : 0.0f;
  __syncthreads();
  // warp 0: prefix sums and the band; warp 1: suffix sums
  if (warp == 0) {
    float carry = 0.0f;
    int lo = INT_MAX, hi = -1;
    for (int base = 0; base < kmax; base += 32) {
      const int t = base + lane;
      const float v = t < kmax ? s_tp[t + 1] : 0.0f;
      float sum = v;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(FULL, sum, o);
        if (lane >= o) sum = sum + u;
      }
      if (t < kmax) s_pre[t + 1] = carry + sum;
      carry = carry + __shfl_sync(FULL, sum, 31);
      const unsigned nz = __ballot_sync(FULL, v != 0.0f);
      if (nz) {
        lo = min(lo, base + __ffs(nz) - 1);
        hi = max(hi, base + 31 - __clz(nz));
      }
    }
    if (lane == 0) {
      s_pre[0] = 0.0f;
      s_band[0] = lo;
      s_band[1] = hi;
    }
  } else if (warp == 1) {
    float carry = 0.0f;
    for (int base = 0; base < kmax; base += 32) {
      const int t = kmax - 1 - (base + lane);
      float sum = t >= 0 ? s_tp[t + 1] : 0.0f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(FULL, sum, o);
        if (lane >= o) sum = sum + u;
      }
      if (t >= 0) s_suf[t] = carry + sum;
      carry = carry + __shfl_sync(FULL, sum, 31);
    }
    if (lane == 0) s_suf[kmax] = 0.0f;
  }
  __syncthreads();
  const float ofs = (float)(w >> 1);
  const int blo = s_band[0], bhi = s_band[1];
  for (int p = tid; p < P4; p += TPB) {
    if (p < P) {
      const float kf = (float)(p - (P >> 1));
      const float pos = ofs + kf * its;
      const float p0f = floorf(pos);
      const float f = pos - p0f;
      const int p0 = (int)p0f;
      const float cl = (1.0f - f) * s_pre[clampi(r - p0, 0, kmax)] +
                       f * s_pre[clampi(r - p0 - 1, 0, kmax)];
      const float cr = (1.0f - f) * s_suf[clampi(w - p0 + r, 0, kmax)] +
                       f * s_suf[clampi(w - p0 - 1 + r, 0, kmax)];
      s_st[p] = p0 - r;
      s_f[p] = f;
      s_cl[p] = cl;
      s_cr[p] = cr;
      // nonzero entries: m in [blo, bhi + 1], and the border masses
      int cs = w, ce = 0;
      if (blo <= bhi) {
        cs = p0 - r + blo;
        ce = p0 - r + bhi + 2;
      }
      if (cl != 0.0f) cs = min(cs, 0);
      if (cr != 0.0f) ce = max(ce, w);
      s_cs[p] = max(cs, 0);
      s_ce[p] = min(ce, w);
    } else {
      s_st[p] = 0;
      s_f[p] = 0.0f;
      s_cl[p] = 0.0f;
      s_cr[p] = 0.0f;
      s_cs[p] = INT_MAX;
      s_ce[p] = INT_MIN;
    }
  }
  __syncthreads();
  for (int b = tid; b < NPB + NRB; b += TPB) {
    const int n = b < NPB ? 4 : TR, p0 = b < NPB ? 4 * b : TR * (b - NPB);
    int lo = INT_MAX, hi = INT_MIN;
    for (int i = 0; i < n && p0 + i < P; ++i) {
      lo = min(lo, s_cs[p0 + i]);
      hi = max(hi, s_ce[p0 + i]);
    }
    if (b < NPB) {
      s_tlo[b] = lo;
      s_thi[b] = hi;
    } else {
      s_alo[b - NPB] = lo;
      s_ahi[b - NPB] = hi;
    }
  }
  RView R;
  R.tp = s_tp;
  R.st = s_st;
  R.f = s_f;
  R.cl = s_cl;
  R.cr = s_cr;
  R.P = P;
  R.kmax = kmax;
  R.w = w;
  const bool single = w <= CWv;  // one chunk: R^T of all columns stays
  if (single) fill_rt<TPB>(R, s_rq, 0, w, P4, s_cs, s_ce);

  const float half = (float)(w >> 1);
  const float fW1 = (float)(W - 1), fH1 = (float)(H - 1);
  bool touched = false;
  float acc[NA][TR][4];
#pragma unroll
  for (int s = 0; s < NA; ++s)
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[s][i][c] = 0.0f;
  if (SACC) {
    // read first after the first chunk's barriers
    float4* a4 = (float4*)s_acc;
    for (int e = tid; e < NRB * TR * NPB; e += TPB)
      a4[e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }

  for (int j0 = 0; j0 < w; j0 += SR) {
    const int jend = min(j0 + SR, w);
    for (int q0 = 0; q0 < w; q0 += CWv) {
      const int qend = min(q0 + CWv, w);
      __syncthreads();  // the previous step's readers are done
      if (!single) fill_rt<TPB>(R, s_rq, q0, qend - q0, P4, s_cs, s_ce);
      // sample WS^T[q - q0][j - j0], four rows of one column a thread
      // (one 16-byte store): only the strip's rows (rounded up to 4,
      // zeros past the workspace) and the chunk's columns inside the
      // workspace; the products never read the rest
      const int nq = qend - q0, nj4 = (jend - j0 + 3) & ~3;
      for (int e = tid; e < nq * (nj4 >> 2); e += TPB) {
        const int jg = e / nq, qq = e - jg * nq;
        const int q = q0 + qq;
        const float effq = (float)q - half;
        const float wx = x + effq * a11;
        const float x0f = floorf(wx);
        const float fx = wx - x0f;
        const bool xin = x0f >= 0.0f && x0f < fW1;
        const float yq = y + effq * a21;
        // the four rows' addresses first (pixel 0 where a sample is
        // outside), then all sixteen loads, so that they are in flight
        // together
        const float* sp[4];
        float fy[4];
        bool in[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = j0 + 4 * jg + i;
          const float effj = (float)j - half;
          const float wy = yq + effj * a22;
          const float y0f = floorf(wy);
          in[i] = xin && y0f >= 0.0f && y0f < fH1;
          touched = touched || (j < w && !in[i]);
          in[i] = in[i] && j < w;
          fy[i] = wy - y0f;
          sp[i] = in[i] ? img + (size_t)(int)y0f * W + (int)x0f : img;
        }
        float t00[4], t01[4], t10[4], t11[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          t00[i] = __ldg(sp[i]);
          t01[i] = __ldg(sp[i] + 1);
          t10[i] = __ldg(sp[i] + W);
          t11[i] = __ldg(sp[i] + W + 1);
        }
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float xa = (1.0f - fx) * t00[i] + fx * t01[i];
          const float xb = (1.0f - fx) * t10[i] + fx * t11[i];
          v[i] = in[i] ? (1.0f - fy[i]) * xa + fy[i] * xb : 0.0f;
        }
        *(float4*)(s_ws + qq * SRP + 4 * jg) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
      __syncthreads();
      // T[j][p'] (+)= sum_q WS[j][q] R[p'][q] over the chunk, for the
      // strip's row groups inside the workspace
      const int njt = (jend - j0 + TR - 1) / TR;
      for (int t0 = 0; t0 < NPB * njt; t0 += TPB) {
        const int t = t0 + tid;
        const bool has = t < NPB * njt;
        const int pb = has ? t / njt : 0, jg = has ? t - pb * njt : 0;
        int lo = has ? max(s_tlo[pb], q0) : INT_MAX;
        int hi = has ? min(s_thi[pb], qend) : INT_MIN;
        lo = __reduce_min_sync(FULL, lo);
        hi = __reduce_max_sync(FULL, hi);
        float c[TR][4];
#pragma unroll
        for (int i = 0; i < TR; ++i)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) c[i][cc] = 0.0f;
        tile_fma<TR>(s_ws + TR * jg - q0 * SRP, SRP, s_rq + 4 * pb - q0 * P4,
                     P4, lo, hi, c);
        if (has) {
#pragma unroll
          for (int i = 0; i < TR; ++i) {
            float4* dst = (float4*)(s_t + (TR * jg + i) * P4 + 4 * pb);
            float4 o = q0 == 0 ? make_float4(0.0f, 0.0f, 0.0f, 0.0f) : *dst;
            o.x = o.x + c[i][0];
            o.y = o.y + c[i][1];
            o.z = o.z + c[i][2];
            o.w = o.w + c[i][3];
            *dst = o;
          }
        }
      }
    }
    __syncthreads();
    // R^T rows of the strip: the chunk's own when it spans the
    // workspace, else filled into the (now free) sample buffer
    const float* rj;
    if (single) {
      rj = s_rq + j0 * P4;
    } else {
      fill_rt<TPB>(R, s_ws, j0, jend - j0, P4, s_cs, s_ce);
      rj = s_ws;
    }
    // patch[p][p'] += sum_j R[p][j] T[j][p'] over the strip
    if (SACC) {
      for (int t0 = 0; t0 < NRB * NPB; t0 += TPB) {
        const int t = t0 + tid;
        const bool has = t < NRB * NPB;
        const int rb = has ? t / NPB : 0, pb = has ? t - rb * NPB : 0;
        int lo = has ? max(s_alo[rb], j0) : INT_MAX;
        int hi = has ? min(s_ahi[rb], jend) : INT_MIN;
        lo = __reduce_min_sync(FULL, lo);
        hi = __reduce_max_sync(FULL, hi);
        float* arow = s_acc + (TR * rb) * P4 + 4 * pb;
        float c[TR][4];
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          const float4 o = *(const float4*)(arow + i * P4);
          c[i][0] = o.x;
          c[i][1] = o.y;
          c[i][2] = o.z;
          c[i][3] = o.w;
        }
        tile_fma<TR>(rj + TR * rb - j0 * P4, P4, s_t + 4 * pb - j0 * P4, P4,
                     lo, hi, c);
        if (has) {
#pragma unroll
          for (int i = 0; i < TR; ++i)
            *(float4*)(arow + i * P4) =
                make_float4(c[i][0], c[i][1], c[i][2], c[i][3]);
        }
      }
    }
#pragma unroll
    for (int s = 0; s < (SACC ? 0 : NA); ++s) {
      const int t = s * TPB + tid;
      const bool has = t < NRB * NPB;
      const int rb = has ? t / NPB : 0, pb = has ? t - rb * NPB : 0;
      int lo = has ? max(s_alo[rb], j0) : INT_MAX;
      int hi = has ? min(s_ahi[rb], jend) : INT_MIN;
      lo = __reduce_min_sync(FULL, lo);
      hi = __reduce_max_sync(FULL, hi);
      tile_fma<TR>(rj + TR * rb - j0 * P4, P4, s_t + 4 * pb - j0 * P4, P4,
                   lo, hi, acc[s]);
    }
  }
  const int any_bad = __syncthreads_or(touched ? 1 : 0);
  if (SACC) {
    for (int e = tid; e < PP; e += TPB) {
      const int p = e / P;
      patch[e] = s_acc[p * P4 + (e - p * P)];
    }
  }
#pragma unroll
  for (int s = 0; s < (SACC ? 0 : NA); ++s) {
    const int t = s * TPB + tid;
    if (t >= NRB * NPB) continue;
    const int rb = t / NPB, pb = t - rb * NPB;
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int p = TR * rb + i;
      if (p >= P) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (4 * pb + c < P) patch[p * P + 4 * pb + c] = acc[s][i][c];
    }
  }
  if (tid == 0) bad[k] = any_bad ? 1 : 0;
}

struct Geom {
  void (*kernel)(const float*, int, int, const int32_t*, const float*,
                 const float*, const float*, const float*, const float*,
                 const int32_t*, const float*, const float*, const uint8_t*,
                 int, int, float*, int32_t*);
  int tpb, tr, sr, cw, na;
  bool sacc;
};

#define GEOM(TPB, TR, SR, CW, NA, MINB, SACC) \
  {patches_kernel<TPB, TR, SR, CW, NA, MINB, SACC>, TPB, TR, SR, CW, NA, SACC}

// 0: four warps, ws <= 52 in one piece; 1: eight warps, ws <= 97 in one
// piece; 2: eight warps over strips of 44 rows x 196-column chunks; 3:
// any patch size up to MAX_P (two patch tiles a thread); 4: any larger
// patch, accumulated in shared memory (the generic geometry)
static const Geom kGeoms[] = {
    GEOM(128, 4, 52, 52, 1, 7, false),
    GEOM(256, 4, 100, 97, 1, 3, false),
    GEOM(256, 2, 44, 196, 1, 2, false),
    GEOM(256, 2, 44, 128, 2, 1, false),
    GEOM(256, 4, 44, 128, 1, 1, true),
};

// columns of a chunk (the kernel's CWv)
static int geom_cw(const Geom& v, int P) {
  const int P4 = (P + 3) & ~3;
  return v.sacc && P4 > v.cw ? P4 : v.cw;
}

static size_t geom_shmem(const Geom& v, int kmax, int P) {
  const size_t P4 = (size_t)((P + 3) & ~3), cw = (size_t)geom_cw(v, P);
  const size_t srp = ((v.sr / 4) % 2 == 1) ? v.sr : v.sr + 4;
  const size_t npb = P4 / 4, nrb = (size_t)((P + v.tr - 1) / v.tr);
  // SACC: the accumulator and up to 3 floats of padding before it
  const size_t floats = cw * P4 + (size_t)v.sr * P4 + cw * srp +
                        (kmax + 2) + 2 * (kmax + 1) + 3 * P4 +
                        (v.sacc ? nrb * v.tr * P4 + 3 : 0);
  const size_t ints = 3 * P4 + 2 * npb + 2 * nrb + 2;
  return 4 * (floats + ints);
}

static bool geom_fits(const Geom& v, int kmax, int P) {
  const int P4 = (P + 3) & ~3;
  const int srp = ((v.sr / 4) % 2 == 1) ? v.sr : v.sr + 4;
  const int tiles = ((P + v.tr - 1) / v.tr) * (P4 / 4);
  return (v.sacc || tiles <= v.na * v.tpb) &&
         v.sr * P4 <= geom_cw(v, P) * srp &&
         geom_shmem(v, kmax, P) <= 232448;
}

// The geometry (index into kGeoms) a launch takes, or -1 where none fits
// the shared memory.
static int pick_geom(int kmax, int P) {
  if (P > MAX_P) return geom_fits(kGeoms[4], kmax, P) ? 4 : -1;
  // KMAX at the default smoothing: 11 in the 49 bucket, 21 in the 97
  // bucket, 43 in the 193 bucket and the 385 tail's, 57-71 in the
  // larger tails
  int g = kmax <= 11 ? 0 : (kmax <= 21 ? 1 : 2);
  if (!geom_fits(kGeoms[g], kmax, P)) g = 3;
  return geom_fits(kGeoms[g], kmax, P) ? g : -1;
}

// The geometry hesaff_patches_group would take for (kmax, P), and the
// bytes of shared memory its block needs (for the generic geometry's
// limit, also where it does not fit).
extern "C" int hesaff_patches_geometry(int kmax, int P, long long* shmem) {
  const int g = pick_geom(kmax, P);
  *shmem = (long long)geom_shmem(kGeoms[g < 0 ? 4 : g], kmax, P);
  return g;
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
  if (B < 1 || H < 2 || W < 2 || kmax < 1 || kmax % 2 == 0 || P < 1)
    return (int)cudaErrorInvalidValue;
  if (K == 0) return (int)cudaGetLastError();
  const int g = pick_geom(kmax, P);
  if (g < 0) return (int)cudaErrorInvalidValue;
  const Geom& v = kGeoms[g];
  const size_t shmem = geom_shmem(v, kmax, P);
  cudaError_t err = cudaFuncSetAttribute(
      v.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (err != cudaSuccess) return (int)err;
  v.kernel<<<K, v.tpb, shmem, (cudaStream_t)stream>>>(
      src, H, W, img_idx, x, y, a11, a21, a22, ws, its, taps, active, kmax, P,
      out, bad);
  return (int)cudaGetLastError();
}
