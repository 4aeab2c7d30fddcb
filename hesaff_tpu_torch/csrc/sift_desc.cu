// SIFT descriptors (128-D at the reference's bins) of normalised patches,
// one warp per patch.
// Two instances: the one below for the reference's 41 px patches and
// 4 x 4 x 8 bins (any P <= 64 with sb * ob dividing 32), and a generic
// one after it for any other patch side and bin layout.
//
// Replaces the TPU kernel hesaff_tpu/ops/pallas_sift.py:
// sift_descriptors_pallas (pallas_sift.py:171, pallas_call at :198).
//
// What bounds it on an H100: the work, not the bytes.  A patch is read
// once (41 x 41 floats, 6.7 KB) and 128 bytes or floats are written,
// against ~1.2k gradient / atan2 / orientation-split evaluations and
// ~5k multiply-adds of binning a patch, with IEEE sqrt and division.
// The TPU kernel packed 128 patches into the lanes of a transposed
// (pixel, patch) block and needed a polynomial atan2; here:
//   - one warp a patch, NW patches a block; the spatial weights and
//     their non-zero ranges sit in shared memory once a block, which
//     walks its patches in a loop (a persistent grid); no block barrier
//     after set-up; mean, sigma and norms are warp shuffles; the patch
//     comes in by cp.async, every load of it in flight at once;
//   - the row binning is a gather over the non-zero band only: a lane
//     owns a column (the central 32 columns, then the outer P - 32), the
//     warp walks the support rows of that column group together, so
//     neighbouring lanes read neighbouring words, and each lane adds its
//     pixel's two orientation terms into the (at most two) row bins
//     whose weight is not zero, in row order, into sums t[br, o, c] kept
//     in its own memory bank (no conflicts, no atomics: deterministic).
//     Every term of the full sum that is left out is an exact +0 and
//     every term is >= 0, so t is bit-equal to the dense sum over all
//     41 rows;
//   - t is then transposed over the dead patch to an odd row stride, so
//     that the column pass, a lane's 4 outputs (one column bin, four
//     row bins) summed over that bin's non-zero columns in column
//     order, reads 32 banks at once;
//   - a masked entry reads a slot's patch only where its valid flag is
//     set, writes uint8 rows and zero rows for the other slots, so the
//     serving path needs no gather, scatter or host sync around it.
// What holds it back (H100 measurements): issue slots and latency of
// the row pass, ~62 warp steps a patch of which the outer group's 23
// run 9 of 32 lanes, and the atan2, sqrt and division each step.

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

#define NW 4                 // warps (patches in flight) a block
#define FULL 0xffffffffu

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v = v + __shfl_xor_sync(FULL, v, m);
  return v;
}

// Patch pin (PP floats) into the warp's s_x by cp.async, every load in
// flight at once, then its photometric normalisation over the support
// disc (circ > 0): mean and sigma by warp shuffles; sigma < 1e-4 leaves
// it unchanged, else clamp(128 + 50 (x - mean) / sigma, 0, 255).
__device__ __forceinline__ void load_normalised(float* s_x, const float* pin,
                                                const float* circ, int PP,
                                                int lane, float n_support) {
  for (int e = lane; e < PP; e += 32) {
    const unsigned dst = (unsigned)__cvta_generic_to_shared(s_x + e);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(dst), "l"(pin + e));
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  float a = 0.0f;
  for (int e = lane; e < PP; e += 32)
    a = a + (__ldg(circ + e) > 0.0f ? s_x[e] : 0.0f);
  const float mean = warp_sum(a) / n_support;
  a = 0.0f;
  for (int e = lane; e < PP; e += 32) {
    const float d = mean - s_x[e];
    a = a + (__ldg(circ + e) > 0.0f ? d * d : 0.0f);
  }
  const float sd = sqrtf(warp_sum(a) / n_support);
  if (!(sd < 0.0001f)) {
    const float fac = 50.0f / sd;
    for (int e = lane; e < PP; e += 32) {
      const float v = 128.0f + fac * (s_x[e] - mean);
      s_x[e] = v < 0.0f ? 0.0f : (v > 255.0f ? 255.0f : v);
    }
  }
}

// Column of group g (0: the central 32 columns, 1: the P - 32 outer
// ones) that `lane` owns, or -1.
__device__ __forceinline__ int group_col(int g, int lane, int P) {
  if (P <= 32) return g == 0 && lane < P ? lane : -1;
  const int off = (P - 32) / 2;
  if (g == 0) return off + lane;
  if (lane >= P - 32) return -1;
  return lane < off ? lane : lane + 32;
}

template <bool U8>
__global__ void __launch_bounds__(NW * 32) sift_kernel(
    const float* __restrict__ patches, const uint8_t* __restrict__ valid,
    int K, int P, const float* __restrict__ circ,
    const float* __restrict__ spatial, int sb, int ob, float n_support,
    float max_bin, void* __restrict__ out) {
  extern __shared__ float sm[];
  const int PP = P * P;
  const int nb = sb * sb * ob;
  const int nq = sb * ob;                  // (row bin, orientation) pairs
  const int n2 = P > 32 ? P - 32 : 0;      // columns of group 1
  const int TT = nq + 1;                   // row stride of tT (odd)
  const int XS = PP > P * TT ? PP : P * TT;
  float* s_W = sm;                         // P x sb spatial weights
  float* s_warp = s_W + P * sb;            // NW x (XS + nq * (32 + n2))
  int* s_blo = (int*)(s_warp + NW * (XS + nq * (32 + n2)));
  int* s_bhi = s_blo + P;                  // non-zero row bins of row r
  int* s_clo = s_bhi + P;                  // non-zero columns of bin b
  int* s_chi = s_clo + sb;
  int* s_glo = s_chi + sb;                 // support rows of group g
  int* s_ghi = s_glo + 2;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int e = tid; e < P * sb; e += NW * 32) s_W[e] = spatial[e];
  __syncthreads();
  for (int r = tid; r < P; r += NW * 32) {
    int lo = sb, hi = -1;
    for (int b = 0; b < sb; ++b)
      if (s_W[r * sb + b] != 0.0f) { lo = min(lo, b); hi = b; }
    s_blo[r] = lo;
    s_bhi[r] = hi;
  }
  for (int b = tid; b < sb; b += NW * 32) {
    int lo = P, hi = -1;
    for (int c = 0; c < P; ++c)
      if (s_W[c * sb + b] != 0.0f) { lo = min(lo, c); hi = c; }
    s_clo[b] = lo;
    s_chi[b] = hi;
  }
  if (warp == 0) {
    for (int g = 0; g < 2; ++g) {
      const int c = group_col(g, lane, P);
      int lo = P, hi = -1;
      if (c >= 0)
        for (int r = 0; r < P; ++r)
          if (circ[r * P + c] > 0.0f) { lo = min(lo, r); hi = r; }
      lo = __reduce_min_sync(FULL, lo);
      hi = __reduce_max_sync(FULL, hi);
      if (lane == 0) { s_glo[g] = lo; s_ghi[g] = hi; }
    }
  }
  __syncthreads();

  float* s_x = s_warp + warp * (XS + nq * (32 + n2));  // the patch; tT
  float* s_t1 = s_x + XS;                  // t of group 0: [q][32]
  float* s_t2 = s_t1 + nq * 32;            // t of group 1: [q][n2]
  const float two_pi = (float)(2.0 * M_PI);

  for (int k = blockIdx.x * NW + warp; k < K; k += gridDim.x * NW) {
    __syncwarp();  // the previous patch's reads are done
    if (valid && !valid[k]) {
      for (int i = lane; i < nb; i += 32) {
        if (U8) ((uint8_t*)out)[(size_t)k * nb + i] = 0;
        else ((float*)out)[(size_t)k * nb + i] = 0.0f;
      }
      continue;
    }

    load_normalised(s_x, patches + (size_t)k * PP, circ, PP, lane,
                    n_support);
    __syncwarp();

    // rows: the warp walks a column group's support rows together, a
    // lane a column (neighbouring lanes read neighbouring words); each
    // lane adds its pixels' terms, in row order, into its own bank of t
    for (int g = 0; g < 2; ++g) {
      const int c = group_col(g, lane, P);
      float* tc = g == 0 ? s_t1 + lane : s_t2 + lane;
      const int ts = g == 0 ? 32 : n2;
      if (c < 0) continue;
      for (int q = 0; q < nq; ++q) tc[q * ts] = 0.0f;
      const int rhi = s_ghi[g];
      for (int r = s_glo[g]; r <= rhi; ++r) {
        const int e = r * P + c;
        const float* v = s_x + e;
        const float gx = c == 0 ? v[1] - v[0]
                       : (c == P - 1 ? v[0] - v[-1] : v[1] - v[-1]);
        const float gy = r == 0 ? v[P] - v[0]
                       : (r == P - 1 ? v[0] - v[-P] : v[P] - v[-P]);
        const float mag = sqrtf(gx * gx + gy * gy);
        const float ori = atan2f(gy, gx);
        const float o = ((float)ob * (ori + two_pi)) / two_pi;
        const float bo0 = floorf(o);
        const float f1 = o - bo0;
        // o lies in [ob / 2, 3 ob / 2]: one subtraction is the modulo
        const int b = (int)bo0;
        const int b0 = b >= ob ? b - ob : b;
        const int b1 = b0 + 1 == ob ? 0 : b0 + 1;
        // outside the support disc val is +0 and so is every term
        const float val = __ldg(circ + e) * mag;
        const float v0 = val * (1.0f - f1);
        const float v1 = val * f1;
        // a row has at most two non-zero bins, blo and blo + 1; the four
        // sums differ (b1 != b0 as ob >= 2), so their loads go out
        // together before the stores
        const int blo = s_blo[r];
        if (blo > s_bhi[r]) continue;
        const float w0 = s_W[r * sb + blo];
        const float w1 = blo + 1 < sb ? s_W[r * sb + blo + 1] : 0.0f;
        float* t00 = tc + (blo * ob + b0) * ts;
        float* t01 = tc + (blo * ob + b1) * ts;
        if (w1 != 0.0f) {
          float* t10 = t00 + ob * ts;
          float* t11 = t01 + ob * ts;
          const float x00 = *t00, x01 = *t01, x10 = *t10, x11 = *t11;
          *t00 = x00 + w0 * v0;
          *t01 = x01 + w0 * v1;
          *t10 = x10 + w1 * v0;
          *t11 = x11 + w1 * v1;
        } else {
          const float x00 = *t00, x01 = *t01;
          *t00 = x00 + w0 * v0;
          *t01 = x01 + w0 * v1;
        }
      }
    }
    __syncwarp();
    // t into tT[c][q] over the dead patch, so that the column pass reads
    // 32 banks at once
    for (int g = 0; g < 2; ++g) {
      const int c = group_col(g, lane, P);
      if (c < 0) continue;
      const float* tc = g == 0 ? s_t1 + lane : s_t2 + lane;
      const int ts = g == 0 ? 32 : n2;
      for (int q0 = 0; q0 < nq; q0 += 8) {
        float v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) v[u] = q0 + u < nq ? tc[(q0 + u) * ts] : 0.0f;
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (q0 + u < nq) s_x[c * TT + q0 + u] = v[u];
      }
    }
    __syncwarp();

    // columns: desc[br, bc, o] = sum_c W[c, bc] * t[br, o, c] in column
    // order; a lane owns outputs lane + 32 j
    // (i = lane + 32 j: bc and o are the lane's, br = j)
    float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    {
      const int o = lane % ob, bc = (lane / ob) % sb;
      const float* tq = s_x + o;
      const int chi = s_chi[bc];
      for (int cc = s_clo[bc]; cc <= chi; ++cc) {
        const float w = s_W[cc * sb + bc];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (lane + 32 * j < nb)
            d[j] = d[j] + w * tq[cc * TT + ((lane + 32 * j) / (ob * sb)) * ob];
      }
    }
    float ss = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) ss = ss + d[j] * d[j];
    const float norm = sqrtf(warp_sum(ss));
    float cl[4];
    bool over = false;
    float ss2 = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool in = lane + 32 * j < nb;
      const float v = d[j] / norm;
      over = over || (in && v > max_bin);
      cl[j] = v > max_bin ? max_bin : v;
      ss2 = ss2 + (in ? cl[j] * cl[j] : 0.0f);
    }
    const bool changed = __any_sync(FULL, over);
    const float norm2 = sqrtf(warp_sum(ss2));
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = lane + 32 * j;
      if (i >= nb) continue;
      const float res = changed ? cl[j] / norm2 : cl[j];
      const float f = floorf(512.0f * res);
      const float qv = f > 255.0f ? 255.0f : f;
      if (U8) ((uint8_t*)out)[(size_t)k * nb + i] = (uint8_t)__float2uint_rz(qv);
      else ((float*)out)[(size_t)k * nb + i] = qv;
    }
  }
}

// The generic instance: any patch side P, any sb >= 1 and ob >= 1 whose
// block fits the shared memory (the one above takes P <= 64 and sb * ob
// dividing 32, the reference's 41 px and 4 x 4 x 8 bins).  Same
// semantics and the same order of every sum as the instance above:
//   - one warp a patch, nw (1-4) patches a block, as many as the
//     shared memory holds;
//   - rows: lanes cover ceil(P / 32) groups of 32 consecutive columns,
//     a lane a column; the warp walks a group's support rows together
//     and each lane adds its pixel's terms, in row order, into its own
//     column of t[q][c] (q = row bin * ob + orientation), kept at an odd
//     row stride TS so that the column pass reads distinct banks;
//   - columns: a lane owns outputs lane + 32 j for as many j as nb
//     needs, each summed over its column bin's non-zero columns in
//     column order into the warp's nb accumulators in shared memory;
//   - ob = 1: both orientation terms fall into bin 0, added as one
//     term val * ((1 - frac) + frac), as the plain version's one-hot
//     split gives it.
template <bool U8>
__global__ void __launch_bounds__(NW * 32) sift_generic_kernel(
    const float* __restrict__ patches, const uint8_t* __restrict__ valid,
    int K, int P, const float* __restrict__ circ,
    const float* __restrict__ spatial, int sb, int ob, float n_support,
    float max_bin, void* __restrict__ out) {
  extern __shared__ float sm[];
  const int nw = blockDim.x >> 5;
  const int PP = P * P;
  const int nb = sb * sb * ob;
  const int nq = sb * ob;
  const int TS = P | 1;                    // row stride of t (odd)
  const int NG = (P + 31) / 32;            // column groups
  const int WS = PP + nq * TS + nb;        // floats a warp
  float* s_W = sm;                         // P x sb spatial weights
  float* s_warp = s_W + P * sb;            // nw x WS
  int* s_blo = (int*)(s_warp + nw * WS);
  int* s_bhi = s_blo + P;                  // non-zero row bins of row r
  int* s_clo = s_bhi + P;                  // non-zero columns of bin b
  int* s_chi = s_clo + sb;
  int* s_glo = s_chi + sb;                 // support rows of group g
  int* s_ghi = s_glo + NG;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int e = tid; e < P * sb; e += blockDim.x) s_W[e] = spatial[e];
  __syncthreads();
  for (int r = tid; r < P; r += blockDim.x) {
    int lo = sb, hi = -1;
    for (int b = 0; b < sb; ++b)
      if (s_W[r * sb + b] != 0.0f) { lo = min(lo, b); hi = b; }
    s_blo[r] = lo;
    s_bhi[r] = hi;
  }
  for (int b = tid; b < sb; b += blockDim.x) {
    int lo = P, hi = -1;
    for (int c = 0; c < P; ++c)
      if (s_W[c * sb + b] != 0.0f) { lo = min(lo, c); hi = c; }
    s_clo[b] = lo;
    s_chi[b] = hi;
  }
  for (int g = warp; g < NG; g += nw) {
    const int c = 32 * g + lane;
    int lo = P, hi = -1;
    if (c < P)
      for (int r = 0; r < P; ++r)
        if (circ[r * P + c] > 0.0f) { lo = min(lo, r); hi = r; }
    lo = __reduce_min_sync(FULL, lo);
    hi = __reduce_max_sync(FULL, hi);
    if (lane == 0) { s_glo[g] = lo; s_ghi[g] = hi; }
  }
  __syncthreads();

  float* s_x = s_warp + warp * WS;         // the patch
  float* s_t = s_x + PP;                   // t: [q][TS]
  float* s_d = s_t + nq * TS;              // the nb descriptor sums
  const float two_pi = (float)(2.0 * M_PI);

  for (int k = blockIdx.x * nw + warp; k < K; k += gridDim.x * nw) {
    __syncwarp();  // the previous patch's reads are done
    if (valid && !valid[k]) {
      for (int i = lane; i < nb; i += 32) {
        if (U8) ((uint8_t*)out)[(size_t)k * nb + i] = 0;
        else ((float*)out)[(size_t)k * nb + i] = 0.0f;
      }
      continue;
    }

    load_normalised(s_x, patches + (size_t)k * PP, circ, PP, lane,
                    n_support);
    for (int e = lane; e < nq * TS; e += 32) s_t[e] = 0.0f;
    __syncwarp();

    // rows: a lane a column of group g, its pixels' terms in row order
    for (int g = 0; g < NG; ++g) {
      const int c = 32 * g + lane;
      if (c >= P) continue;
      float* tc = s_t + c;
      const int rhi = s_ghi[g];
      for (int r = s_glo[g]; r <= rhi; ++r) {
        const int blo = s_blo[r];
        if (blo > s_bhi[r]) continue;
        const int e = r * P + c;
        const float* v = s_x + e;
        const float gx = c == 0 ? v[1] - v[0]
                       : (c == P - 1 ? v[0] - v[-1] : v[1] - v[-1]);
        const float gy = r == 0 ? v[P] - v[0]
                       : (r == P - 1 ? v[0] - v[-P] : v[P] - v[-P]);
        const float mag = sqrtf(gx * gx + gy * gy);
        const float ori = atan2f(gy, gx);
        const float o = ((float)ob * (ori + two_pi)) / two_pi;
        const float bo0 = floorf(o);
        const float f1 = o - bo0;
        // o lies in [ob / 2, 3 ob / 2]: one subtraction is the modulo
        const int b = (int)bo0;
        const int b0 = b >= ob ? b - ob : b;
        const int b1 = b0 + 1 == ob ? 0 : b0 + 1;
        // outside the support disc val is +0 and so is every term
        const float val = __ldg(circ + e) * mag;
        const float w0 = s_W[r * sb + blo];
        const float w1 = blo + 1 < sb ? s_W[r * sb + blo + 1] : 0.0f;
        float* t00 = tc + (blo * ob + b0) * TS;
        if (ob == 1) {
          const float v01 = val * ((1.0f - f1) + f1);
          *t00 = *t00 + w0 * v01;
          if (w1 != 0.0f) t00[TS] = t00[TS] + w1 * v01;
          continue;
        }
        const float v0 = val * (1.0f - f1);
        const float v1 = val * f1;
        float* t01 = tc + (blo * ob + b1) * TS;
        const float x00 = *t00, x01 = *t01;
        *t00 = x00 + w0 * v0;
        *t01 = x01 + w0 * v1;
        if (w1 != 0.0f) {
          float* t10 = t00 + ob * TS;
          float* t11 = t01 + ob * TS;
          const float x10 = *t10, x11 = *t11;
          *t10 = x10 + w1 * v0;
          *t11 = x11 + w1 * v1;
        }
      }
    }
    __syncwarp();

    // columns: desc[br, bc, o] = sum_c W[c, bc] * t[br, o, c] in column
    // order, outputs lane + 32 j
    float ss = 0.0f;
    for (int i = lane; i < nb; i += 32) {
      const int o = i % ob, bc = (i / ob) % sb, br = i / (ob * sb);
      const float* tq = s_t + (br * ob + o) * TS;
      float d = 0.0f;
      const int chi = s_chi[bc];
      for (int cc = s_clo[bc]; cc <= chi; ++cc)
        d = d + s_W[cc * sb + bc] * tq[cc];
      s_d[i] = d;
      ss = ss + d * d;
    }
    const float norm = sqrtf(warp_sum(ss));
    bool over = false;
    float ss2 = 0.0f;
    for (int i = lane; i < nb; i += 32) {
      const float v = s_d[i] / norm;
      over = over || v > max_bin;
      const float cl = v > max_bin ? max_bin : v;
      s_d[i] = cl;
      ss2 = ss2 + cl * cl;
    }
    const bool changed = __any_sync(FULL, over);
    const float norm2 = sqrtf(warp_sum(ss2));
    for (int i = lane; i < nb; i += 32) {
      const float cl = s_d[i];
      const float res = changed ? cl / norm2 : cl;
      const float f = floorf(512.0f * res);
      const float qv = f > 255.0f ? 255.0f : f;
      if (U8) ((uint8_t*)out)[(size_t)k * nb + i] = (uint8_t)__float2uint_rz(qv);
      else ((float*)out)[(size_t)k * nb + i] = qv;
    }
  }
}

// Shared memory of the generic instance's block of nw warps.
static size_t generic_shmem(int P, int sb, int ob, int nw) {
  const size_t PP = (size_t)P * P, nq = (size_t)sb * ob;
  const size_t nb = nq * sb, TS = (size_t)(P | 1), NG = (P + 31) / 32;
  return sizeof(float) * ((size_t)P * sb + nw * (PP + nq * TS + nb)) +
         sizeof(int) * (2 * (size_t)P + 2 * sb + 2 * NG);
}

template <bool U8>
static int launch_generic(const float* patches, const uint8_t* valid, int K,
                          int P, const float* circ, const float* spatial,
                          int sb, int ob, float n_support, float max_bin,
                          void* out, cudaStream_t stream) {
  int nw = NW;
  while (nw > 1 && generic_shmem(P, sb, ob, nw) > 232448) --nw;
  const size_t shmem = generic_shmem(P, sb, ob, nw);
  if (shmem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      sift_generic_kernel<U8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shmem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, sift_generic_kernel<U8>, nw * 32, shmem);
  if (err != cudaSuccess) return (int)err;
  const long long need = ((long long)K + nw - 1) / nw;
  const long long cap = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  const int blocks = (int)(need < cap ? need : cap);
  sift_generic_kernel<U8><<<blocks, nw * 32, shmem, stream>>>(
      patches, valid, K, P, circ, spatial, sb, ob, n_support, max_bin, out);
  return (int)cudaGetLastError();
}

template <bool U8>
static int launch(const float* patches, const uint8_t* valid, int K, int P,
                  const float* circ, const float* spatial, int sb, int ob,
                  float n_support, float max_bin, void* out,
                  cudaStream_t stream) {
  const size_t PP = (size_t)P * P, nq = (size_t)sb * ob;
  const size_t n2 = P > 32 ? P - 32 : 0;
  const size_t XS = PP > P * (nq + 1) ? PP : P * (nq + 1);
  const size_t shmem = sizeof(float) * ((size_t)P * sb +
                                        NW * (XS + nq * (32 + n2))) +
                       sizeof(int) * (2 * (size_t)P + 2 * sb + 4);
  if (shmem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      sift_kernel<U8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shmem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, sift_kernel<U8>, NW * 32, shmem);
  if (err != cudaSuccess) return (int)err;
  const long long need = ((long long)K + NW - 1) / NW;
  const long long cap = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  const int blocks = (int)(need < cap ? need : cap);
  sift_kernel<U8><<<blocks, NW * 32, shmem, stream>>>(
      patches, valid, K, P, circ, spatial, sb, ob, n_support, max_bin, out);
  return (int)cudaGetLastError();
}

// The instance (P, sb, ob) takes: 0 the one for P <= 64 with sb * ob
// dividing 32 and ob >= 2, 1 the generic one where its block of one warp
// fits the shared memory, -1 none.  *shmem: the generic block's bytes.
extern "C" int hesaff_sift_instance(int P, int sb, int ob,
                                    long long* shmem) {
  *shmem = P >= 3 && sb >= 1 && ob >= 1
               ? (long long)generic_shmem(P, sb, ob, 1) : 0;
  if (P >= 3 && P <= 64 && sb >= 1 && ob >= 2 && sb * sb * ob <= 128 &&
      32 % (sb * ob) == 0)
    return 0;
  return P >= 3 && sb >= 1 && ob >= 1 && *shmem <= 232448 ? 1 : -1;
}

// patches: (K, P, P) float32; valid: (K,) bool or null (every slot);
// circ: (P, P) float32 circular mask; spatial: (P, sb) float32 spatial
// bin weights; n_support: the count of circ > 0.  out: (K, sb*sb*ob)
// uint8 when u8 is set (zero rows where valid is false), else float32
// quantised values.  Launches the instance hesaff_sift_instance names.
// Returns cudaGetLastError().
extern "C" int hesaff_sift_desc(const float* patches, const uint8_t* valid,
                                int K, int P, const float* circ,
                                const float* spatial, int sb, int ob,
                                float n_support, float max_bin, int u8,
                                void* out, void* stream) {
  long long shmem = 0;
  const int inst = hesaff_sift_instance(P, sb, ob, &shmem);
  if (inst < 0 || K < 0) return (int)cudaErrorInvalidValue;
  if (K == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (inst == 1)
    return u8 ? launch_generic<true>(patches, valid, K, P, circ, spatial, sb,
                                     ob, n_support, max_bin, out, s)
              : launch_generic<false>(patches, valid, K, P, circ, spatial,
                                      sb, ob, n_support, max_bin, out, s);
  return u8 ? launch<true>(patches, valid, K, P, circ, spatial, sb, ob,
                           n_support, max_bin, out, s)
            : launch<false>(patches, valid, K, P, circ, spatial, sb, ob,
                            n_support, max_bin, out, s);
}
