// Detection levels: 3x3x3 NMS and the dense localisation solve, shared
// by two kernels:
//   K2 detect_walk_kernel: every detection level of an octave in one
//      launch, with the bounded localisation walk from every pixel (the
//      dense path, octaves under 2^23 px);
//   K3 detect_maps_kernel: the maps of one level alone (the sparse walk
//      of larger octaves and detect_level).
//
// K2 replaces the TPU kernel hesaff_tpu/ops/pallas_detect.py:
// detect_walk_pallas (pallas_detect.py:324, kernel body
// _make_walk_kernel at :176), which the JAX package calls once per
// level.
//
// What bounds K2 on an H100: the per-pixel arithmetic, not memory.  The
// function reads 5 response planes and 3 blurs and writes 3 levels of
// ok, cell, cand and the 5-float field table, about 110 bytes an octave
// pixel (0.27 ms at 16 x 640 x 800 on 3.35 TB/s); a pixel's record costs
// a pivoted 3x3 solve with four divisions and ten finite differences
// under --fmad=false (walk decisions hang on ulps of the solve, so it
// rounds as the plain version does), plus the 26-neighbour NMS and the
// edge test at each output pixel.  The walk itself is data-dependent
// control flow.  The TPU composed the walk as four 9-way selects over
// whole planes carrying cell + accept bit packed into one float (exact
// only below 2^23 pixels).  Here:
// - one launch covers all levels of the octave (grid x = tile column x
//   level, level fastest, so the three level blocks of a tile run side
//   by side and share its five response planes through L2), and writes
//   straight into (B, nl, ...) outputs: the caller reshapes instead of
//   stacking per-level results;
// - a block owns a 64 x 32 output tile (rows x columns; the fastest of
//   four tiles timed, PERF.md PR 4) and computes one record byte (move, stop,
//   stop-accept, candidate, edge) for the tile plus a halo of iters-1
//   pixels (the walk's reach): 72 x 40 records for 64 x 32 outputs at
//   iters 5, 1.41 records an output pixel (16 x 32 had 1.875);
// - the three input tiles come in by 16-byte cp.async copies where a
//   row chunk lies inside the image on a 16-byte boundary, and by
//   clamped scalar loads at the image border (the replicate border; a
//   TMA tile fills with zeros out of bounds, so it does not fit);
// - the NMS, the edge test and the table run at output pixels only (the
//   halo needs the solve alone), and the NMS takes fmaxf / fminf with one
//   "any NaN among the 27" flag, which gives the NaN-propagating max's
//   candidates bit for bit;
// - the table is planar (B, nl, 5, H, W): five coalesced plane stores;
// - cells stay int32, so the 2^23-pixel limit is gone, and no plane of
//   intermediate maps reaches device memory.
//
// K3 replaces detect_maps_pallas (pallas_detect.py:139, kernel body
// _make_kernel at :37).  It reads 12 bytes and writes 19 a pixel
// (maps as four floats, the nan / edge / mask flags as one byte each),
// so the bytes bound the function on an H100; what held the first port
// (one thread a pixel on a 32 x 8 shared tile) was its instruction
// stream instead: 27 shared loads and 52 compares for the NMS and ~25
// shared loads for the differences a pixel, around the --fmad=false
// solve with its divisions, whose pivot rows, indexed at run time,
// compiled to ~250 compares and predicated moves.  The design cuts that
// stream to what the solve needs:
// - a warp walks a strip of 30 output columns down 16 rows, each row of
//   the three planes loaded once, straight into a rolling register
//   window of three rows (one coalesced 128-byte row a plane; the halo
//   is 32/30 columns and 18/16 rows, and is re-read from L2);
// - horizontal neighbours come from the next lanes by shuffles, and
//   the 3x3x3 max and min separably (the planes' max of a row, then
//   over three rows, then over three lanes), with PTX's NaN-propagating
//   max / min so that no separate NaN flag is kept;
// - the maps go out as one 16-byte store a pixel;
// - the row loop is unrolled three times, so the window rotates without
//   copies, and the solve picks its pivot rows by value (K2 shares it).
// The solve and the edge division stay operation for operation, and
// they are most of what is left: the kernel is still bound by issue,
// not by bytes.  The TPU's row blocks with an 8-row halo, its (8, 128)
// padding and its VMEM-sized block search have no counterpart, so any
// width runs.
//
// Semantics follow hesaff_tpu/detect.py (_localization_maps,
// _walk_dense) and pallas_detect.py:37-115, 194-310 operation by
// operation: edge replication at the image border, strict NMS where
// ties survive, nan_to_num before the move test (an infinite b moves),
// edge_bad read at the start pixel, ok = cand & keep & ~edge_bad(start)
// & stop_ok(final).  Built with --fmad=false so the solve rounds as the
// plain PyTorch version does.
//
// Padded mode (hesaff_tpu/detect.py:603-623, pallas_detect.py:333): when
// a batch is edge-padded to a shape bucket, both entries take an optional
// device array of each image's (plane's) true rows and columns and narrow
// the start-pixel window `keep` to it, where the TPU path ANDed a
// (B, H, W) window onto ok and cand after the kernel.  A start pixel's
// candidate flag carries the window into ok, so nothing else changes:
// the neighbourhoods, the solve and the walk's safety border keep the
// padded dimensions, as in the JAX package.

#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

// K2 block size
#define WTHREADS 256
// K2 output tile, rows x columns
#define WTH 64
#define WTW 32

// record byte: flags in bits 0-3, row step + 1 in bits 4-5, column
// step + 1 in bits 6-7
#define F_STOP 1
#define F_STOPOK 2
#define F_CAND 4
#define F_EDGE 8

struct Params {
  int border, safety, iters;
  float pos_thr, neg_thr, edge_thr, max_shift, shift_lim, final_thr;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ float nan_to_num(float v) {
  if (isnan(v)) return 0.0f;
  if (isinf(v)) return v > 0.0f ? FLT_MAX : -FLT_MAX;
  return v;
}

// pivoted 3x3 solve, pivot order and operation order of
// hesaff_tpu/ops/linalg.py:solve3x3_parts
__device__ void solve3x3(const float a[3][3], const float bb[3], float* x0,
                         float* x1, float* x2) {
  const bool p1 = fabsf(a[1][0]) > fabsf(a[0][0]);
  const float vp = p1 ? fabsf(a[1][0]) : fabsf(a[0][0]);
  const bool p2 = fabsf(a[2][0]) > vp;
  // rows in pivot order (i0, i1, i2) = (2, 1, 0), (1, 0, 2) or (0, 1, 2),
  // picked by value: indexing by a run-time row would cost a chain of
  // predicated moves a value
  float row0[3], row1[3], row2[3];
  for (int j = 0; j < 3; ++j) {
    row0[j] = p2 ? a[2][j] : (p1 ? a[1][j] : a[0][j]);
    row1[j] = p2 ? a[1][j] : (p1 ? a[0][j] : a[1][j]);
    row2[j] = p2 ? a[0][j] : a[2][j];
  }
  const float b0 = p2 ? bb[2] : (p1 ? bb[1] : bb[0]);
  float b1 = p2 ? bb[1] : (p1 ? bb[0] : bb[1]);
  float b2 = p2 ? bb[0] : bb[2];

  const float f1 = row1[0] / row0[0];
  const float r11 = row1[1] - f1 * row0[1];
  const float r12 = row1[2] - f1 * row0[2];
  b1 = b1 - f1 * b0;
  const float f2 = row2[0] / row0[0];
  const float r21 = row2[1] - f2 * row0[1];
  const float r22_ = row2[2] - f2 * row0[2];
  b2 = b2 - f2 * b0;

  const bool sw = fabsf(r11) < fabsf(r21);
  const float q10 = sw ? r21 : r11, q11 = sw ? r22_ : r12;
  const float q20 = sw ? r11 : r21, q21 = sw ? r12 : r22_;
  const float b1n = sw ? b2 : b1;
  float b2n = sw ? b1 : b2;

  const float f3 = q20 / q10;
  const float r22 = q21 - f3 * q11;
  b2n = b2n - f3 * b1n;

  *x2 = b2n / r22;
  *x1 = (b1n - q11 * *x2) / q10;
  *x0 = ((b0 - row0[2] * *x2) - row0[1] * *x1) / row0[0];
}

#define AT(a, dr, dc) a[ci + (dr) * IW + (dc)]

// Strict 3x3x3 NMS at one pixel: the pixel's value sits at index ci of
// the three IW-wide shared tiles sl / sc / sh (low, cur, high), whose
// 1-px neighbourhood is in the tiles too.  fmaxf / fminf drop NaN, so
// one flag over the 27 values stands in for jnp.maximum's propagation:
// a NaN anywhere made the plain version's max NaN and both tests false.
__device__ __forceinline__ bool nms_cand(const float* sl, const float* sc,
                                         const float* sh, int ci, int IW,
                                         const Params& p) {
  const float c = AT(sc, 0, 0);
  float mx = c, mn = c;
  bool nan = isnan(c);
#pragma unroll
  for (int dr = -1; dr <= 1; ++dr)
#pragma unroll
    for (int dc = -1; dc <= 1; ++dc) {
      const float a = AT(sl, dr, dc), b = AT(sh, dr, dc);
      mx = fmaxf(mx, fmaxf(a, b));
      mn = fminf(mn, fminf(a, b));
      nan = nan | isnan(a) | isnan(b);
      if (dr != 0 || dc != 0) {
        const float v = AT(sc, dr, dc);
        mx = fmaxf(mx, v);
        mn = fminf(mn, v);
        nan = nan | isnan(v);
      }
    }
  return !nan && (((c > p.pos_thr) && (c >= mx)) ||
                  ((c < p.neg_thr) && (c <= mn)));
}

// Finite differences, pivoted solve and val of one pixel from its
// stencil: c and its neighbours in cur (l / r: column -1 / +1, u / d:
// row -1 / +1), lo and hi the pixel in the levels below and above with
// their neighbours.  b0, b1, b2, val are raw (NaN where the solve is
// singular); the callers sanitise them.
struct Fit {
  float b0, b1, b2, val, dxx, dyy, dxy;
};

__device__ __forceinline__ Fit fit_vals(
    float c, float c_l, float c_r, float c_u, float c_d, float c_ul,
    float c_ur, float c_dl, float c_dr, float lo, float lo_l, float lo_r,
    float lo_u, float lo_d, float hi, float hi_l, float hi_r, float hi_u,
    float hi_d) {
  const float dxx = (c_l - 2.0f * c) + c_r;
  const float dyy = (c_u - 2.0f * c) + c_d;
  const float dss = (lo - 2.0f * c) + hi;
  const float dxy = 0.25f * (((c_dr - c_dl) - c_ur) + c_ul);
  const float dxs = 0.25f * (((hi_r - hi_l) - lo_r) + lo_l);
  const float dys = 0.25f * (((hi_d - hi_u) - lo_d) + lo_u);
  const float dx = 0.5f * (c_r - c_l);
  const float dy = 0.5f * (c_d - c_u);
  const float ds = 0.5f * (hi - lo);
  const float A[3][3] = {{dxx, dxy, dxs}, {dxy, dyy, dys}, {dxs, dys, dss}};
  const float rhs[3] = {-dx, -dy, -ds};
  Fit m;
  solve3x3(A, rhs, &m.b0, &m.b1, &m.b2);
  m.val = c + 0.5f * ((dx * m.b0 + dy * m.b1) + ds * m.b2);
  m.dxx = dxx;
  m.dyy = dyy;
  m.dxy = dxy;
  return m;
}

// fit_vals at index ci of the shared tiles (indexing as nms_cand)
__device__ __forceinline__ Fit fit_at(const float* sl, const float* sc,
                                      const float* sh, int ci, int IW) {
  return fit_vals(AT(sc, 0, 0), AT(sc, 0, -1), AT(sc, 0, 1), AT(sc, -1, 0),
                  AT(sc, 1, 0), AT(sc, -1, -1), AT(sc, -1, 1), AT(sc, 1, -1),
                  AT(sc, 1, 1), AT(sl, 0, 0), AT(sl, 0, -1), AT(sl, 0, 1),
                  AT(sl, -1, 0), AT(sl, 1, 0), AT(sh, 0, 0), AT(sh, 0, -1),
                  AT(sh, 0, 1), AT(sh, -1, 0), AT(sh, 1, 0));
}
#undef AT

__device__ __forceinline__ bool nan_of(const Fit& m) {
  return isnan(m.b0) || isnan(m.b1) || isnan(m.b2);
}

__device__ __forceinline__ bool edge_bad_of(const Fit& m, const Params& p) {
  const float edge_den = m.dxx * m.dyy - m.dxy * m.dxy;
  const float edge_score = ((m.dxx + m.dyy) * (m.dxx + m.dyy)) / edge_den;
  return (edge_score >= p.edge_thr) || (edge_score < 0.0f);
}

// The walk's record of one pixel at image (gr, gc): stop, stop-accept
// and the step (_walk_dense's move, border, shift and weak tests).
__device__ __forceinline__ uint8_t walk_record(const Fit& m, int gr, int gc,
                                               int H, int W,
                                               const Params& p) {
  const bool nan_flag = nan_of(m);
  const float cb0 = nan_to_num(m.b0), cb1 = nan_to_num(m.b1);
  const float cb2 = nan_to_num(m.b2), cval = nan_to_num(m.val);
  const bool mpx = cb0 > p.max_shift, mnx = cb0 < -p.max_shift;
  const bool mpy = cb1 > p.max_shift, mny = cb1 < -p.max_shift;
  const bool border_bad = (mpx && !(gc < W - p.safety)) ||
                          (mnx && !(gc > p.safety)) ||
                          (mpy && !(gr < H - p.safety)) ||
                          (mny && !(gr > p.safety));
  const int stc = (mpx ? 1 : 0) + (mnx ? -1 : 0);
  const int str = (mpy ? 1 : 0) + (mny ? -1 : 0);
  const bool moved = stc != 0 || str != 0;
  const bool stop = nan_flag || border_bad || !moved;
  const bool shift_bad = fabsf(cb0) > p.shift_lim ||
                         fabsf(cb1) > p.shift_lim ||
                         fabsf(cb2) > p.shift_lim;
  const bool weak = fabsf(cval) < p.final_thr;
  const bool stop_ok = !nan_flag && !border_bad && !shift_bad && !weak;
  return (uint8_t)((stop ? F_STOP : 0) | (stop_ok ? F_STOPOK : 0) |
                   ((str + 1) << 4) | ((stc + 1) << 6));
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Tile geometry of K2 for TW output columns and a walk reach (halo) of
// `halo` px: the three input tiles are rows of this many floats,
// starting at the 16-byte aligned column at or left of c0 - halo - 1.
__host__ __device__ __forceinline__ int walk_tile_iw(int TW, int halo) {
  // worst-case column offset 3, the stencils' 2 px, rounded up to 4
  return (3 + TW + 2 * halo + 2 + 3) & ~3;
}

// One block: a WTH x WTW output tile of one level of one image.
__global__ void __launch_bounds__(WTHREADS) detect_walk_kernel(
    const float* __restrict__ resps, const float* __restrict__ blurs,
    long long r_sb, long long r_sl, long long b_sb, long long b_sl,
    uint8_t* __restrict__ ok_out, int32_t* __restrict__ cell_out,
    float* __restrict__ tab_out, uint8_t* __restrict__ cand_out,
    const int32_t* __restrict__ vhw, int nl, int H, int W, int vec,
    Params p) {
  extern __shared__ __align__(16) float sm[];
  const int HALO = p.iters - 1;  // walk reach
  const int RH = WTH + 2 * HALO, RW = WTW + 2 * HALO;
  const int IH = RH + 2, IW = walk_tile_iw(WTW, HALO);
  float* sl = sm;
  float* sc = sl + IH * IW;
  float* sh = sc + IH * IW;
  uint8_t* rec = (uint8_t*)(sh + IH * IW);

  const int lvl = blockIdx.x % nl;  // detection level lvl + 1 of the ladder
  const int r0 = blockIdx.y * WTH, c0 = (blockIdx.x / nl) * WTW;
  const int b = blockIdx.z;
  const float* lo = resps + b * r_sb + lvl * r_sl;
  const float* cu = lo + r_sl;
  const float* hi = cu + r_sl;
  const float* bl = blurs + b * b_sb + (lvl + 1) * b_sl;
  const size_t HW = (size_t)H * W;
  const size_t plane = (size_t)b * nl + lvl;
  const int tid = threadIdx.x;
  const int cs = (c0 - HALO - 1) & ~3;  // aligned first tile column
  const int xoff = c0 - HALO - 1 - cs;
  // the start-pixel window: the image's true size when it is padded
  const int hk = vhw ? min(H, vhw[2 * b]) : H;
  const int wk = vhw ? min(W, vhw[2 * b + 1]) : W;

  const int nq = IW >> 2;
  for (int e = tid; e < IH * nq; e += WTHREADS) {
    const int rr = e / nq, k = e - (e / nq) * nq;
    const size_t row = (size_t)clampi(r0 - HALO - 1 + rr, 0, H - 1) * W;
    const int gc = cs + 4 * k;
    const int d = rr * IW + 4 * k;
    if (vec && gc >= 0 && gc + 3 < W) {
      cp_async16(sl + d, lo + row + gc);
      cp_async16(sc + d, cu + row + gc);
      cp_async16(sh + d, hi + row + gc);
    } else {
      for (int i = 0; i < 4; ++i) {
        const size_t g = row + clampi(gc + i, 0, W - 1);
        sl[d + i] = lo[g];
        sc[d + i] = cu[g];
        sh[d + i] = hi[g];
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // output pixels: record, NMS, edge test, table and cand
  for (int e = tid; e < WTH * WTW; e += WTHREADS) {
    const int tr = e / WTW, tc = e % WTW;
    const int gr = r0 + tr, gc = c0 + tc;
    const int ri = tr + HALO, ci = tc + HALO;
    const int si = (ri + 1) * IW + ci + 1 + xoff;
    const Fit m = fit_at(sl, sc, sh, si, IW);
    uint8_t f = walk_record(m, gr, gc, H, W, p);
    if (gr < H && gc < W) {
      const bool keep = gr >= p.border && gr < hk - p.border &&
                        gc >= p.border && gc < wk - p.border;
      const bool cand = keep && nms_cand(sl, sc, sh, si, IW, p);
      f |= (cand ? F_CAND : 0) | (edge_bad_of(m, p) ? F_EDGE : 0);
      const size_t g = (size_t)gr * W + gc;
      const float lb = bl[g - (gc > 0 ? 1 : 0)];
      const float cbv = bl[g];
      const float rb = bl[g + (gc < W - 1 ? 1 : 0)];
      float* t = tab_out + plane * 5 * HW + g;
      t[0] = nan_to_num(m.b0);
      t[HW] = nan_to_num(m.b1);
      t[2 * HW] = nan_to_num(m.b2);
      t[3 * HW] = nan_to_num(m.val);
      t[4 * HW] = (lb - 2.0f * cbv) + rb;
      cand_out[plane * HW + g] = cand ? 1 : 0;
    }
    rec[ri * RW + ci] = f;
  }

  // the halo ring: the walk's records alone
  const int ring_tb = 2 * HALO * RW;
  for (int e = tid; e < ring_tb + 2 * HALO * WTH; e += WTHREADS) {
    int ri, ci;
    if (e < ring_tb) {
      ri = e / RW;
      ci = e - ri * RW;
      if (ri >= HALO) ri += WTH;
    } else {
      const int e2 = e - ring_tb, k = e2 % (2 * HALO);
      ri = HALO + e2 / (2 * HALO);
      ci = k < HALO ? k : WTW + k;
    }
    const int si = (ri + 1) * IW + ci + 1 + xoff;
    rec[ri * RW + ci] = walk_record(fit_at(sl, sc, sh, si, IW),
                                    r0 - HALO + ri, c0 - HALO + ci, H, W, p);
  }
  __syncthreads();

  for (int e = tid; e < WTH * WTW; e += WTHREADS) {
    const int tr = e / WTW, tc = e % WTW;
    const int gr = r0 + tr, gc = c0 + tc;
    if (gr >= H || gc >= W) continue;
    int qr = gr, qc = gc;
    for (int it = 0; it < p.iters - 1; ++it) {
      const uint8_t f = rec[(qr - r0 + HALO) * RW + (qc - c0 + HALO)];
      if (f & F_STOP) break;
      qr = clampi(qr + ((f >> 4) & 3) - 1, 0, H - 1);
      qc = clampi(qc + ((f >> 6) & 3) - 1, 0, W - 1);
    }
    const uint8_t f0 = rec[(tr + HALO) * RW + (tc + HALO)];
    const uint8_t ff = rec[(qr - r0 + HALO) * RW + (qc - c0 + HALO)];
    const size_t g = plane * HW + (size_t)gr * W + gc;
    ok_out[g] = ((f0 & F_CAND) && !(f0 & F_EDGE) && (ff & F_STOPOK)) ? 1 : 0;
    cell_out[g] = qr * W + qc;
  }
}

// K3: the maps alone.  A warp walks M3_ROWS output rows of a strip of
// M3_COLS columns: lane i holds image column c0 - 1 + i (clamped: the
// replicate border), so lanes 1..M3_COLS are output pixels and lanes 0
// and 31 the stencils' halo.  Each row of the three planes is loaded
// once (one row ahead of its use) into a rolling window of rows r - 1,
// r, r + 1; a pixel's left and right neighbours come from the next
// lanes by shuffles, and the 3x3x3 max and min are taken separably: the
// three planes' max of a row, then over the three rows, then over the
// three lanes.
#define M3_COLS 30
#define M3_ROWS 16
#define M3_WARPS 4

// max / min that return NaN when either input is NaN (jnp.maximum's
// rule), so a NaN among the 27 fails both NMS tests as in the plain
// version
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float from_left(float v) {
  return __shfl_up_sync(0xffffffffu, v, 1);
}
__device__ __forceinline__ float from_right(float v) {
  return __shfl_down_sync(0xffffffffu, v, 1);
}

// One row of K3's window at the lane's column: the three planes' values,
// cur's left and right neighbours, and the planes' max and min.
struct MapsRow {
  float lo, cu, hi, cl, cr, mx, mn;
};

__device__ __forceinline__ void maps_row_in(MapsRow& w, float lo, float cu,
                                            float hi) {
  w.lo = lo;
  w.cu = cu;
  w.hi = hi;
  w.cl = from_left(cu);
  w.cr = from_right(cu);
  w.mx = max_nan(max_nan(lo, cu), hi);
  w.mn = min_nan(min_nan(lo, cu), hi);
}

struct MapsOut {
  float4* maps;
  uint8_t *nan, *edge, *mask;
};

// The maps of row r at the lane's column from the window's rows r - 1
// (u), r (m) and r + 1 (d); hk bounds the mask's rows (the plane's true
// height, or H).
__device__ __forceinline__ void maps_at(const MapsRow& u, const MapsRow& m,
                                        const MapsRow& d, int r, int gc,
                                        int hk, int W, bool out_col,
                                        bool keep_c, const Params& p,
                                        const MapsOut& o) {
  const float cx = max_nan(max_nan(u.mx, m.mx), d.mx);
  const float cm = min_nan(min_nan(u.mn, m.mn), d.mn);
  const float mx = max_nan(max_nan(from_left(cx), cx), from_right(cx));
  const float mn = min_nan(min_nan(from_left(cm), cm), from_right(cm));
  const Fit f = fit_vals(m.cu, m.cl, m.cr, u.cu, d.cu, u.cl, u.cr, d.cl,
                         d.cr, m.lo, from_left(m.lo), from_right(m.lo), u.lo,
                         d.lo, m.hi, from_left(m.hi), from_right(m.hi), u.hi,
                         d.hi);
  if (out_col) {
    const bool keep = keep_c && r >= p.border && r < hk - p.border;
    const bool cand = ((m.cu > p.pos_thr) && (m.cu >= mx)) ||
                      ((m.cu < p.neg_thr) && (m.cu <= mn));
    const int g = r * W + gc;
    o.maps[g] = make_float4(nan_to_num(f.b0), nan_to_num(f.b1),
                            nan_to_num(f.b2), nan_to_num(f.val));
    o.nan[g] = nan_of(f) ? 1 : 0;
    o.edge[g] = edge_bad_of(f, p) ? 1 : 0;
    o.mask[g] = (cand && keep) ? 1 : 0;
  }
}

__global__ void __launch_bounds__(32 * M3_WARPS) detect_maps_kernel(
    const float* __restrict__ low, const float* __restrict__ cur,
    const float* __restrict__ high, long long s_low, long long s_cur,
    long long s_high, float4* __restrict__ maps_out,
    uint8_t* __restrict__ nan_out, uint8_t* __restrict__ edge_out,
    uint8_t* __restrict__ mask_out, const int32_t* __restrict__ vhw, int H,
    int W, Params p) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = (blockIdx.y * M3_WARPS + warp) * M3_ROWS;
  if (r0 >= H) return;
  const int n = blockIdx.z;
  const int gc = blockIdx.x * M3_COLS - 1 + lane;
  // the start-pixel window: the plane's true size when it is padded
  const int hk = vhw ? min(H, vhw[2 * n]) : H;
  const int wk = vhw ? min(W, vhw[2 * n + 1]) : W;
  const float* lo = low + n * s_low + clampi(gc, 0, W - 1);
  const float* cu = cur + n * s_cur + clampi(gc, 0, W - 1);
  const float* hi = high + n * s_high + clampi(gc, 0, W - 1);
  const bool out_col = lane >= 1 && lane <= M3_COLS && gc < W;
  const bool keep_c = gc >= p.border && gc < wk - p.border;
  const size_t plane = (size_t)n * H * W;
  const MapsOut o = {maps_out + plane, nan_out + plane, edge_out + plane,
                     mask_out + plane};

  // the window's rows r - 1, r, r + 1 rotate through w0, w1, w2 (the
  // loop is unrolled three times so that no row is copied); row r + 2
  // is loaded one row ahead of its use
  MapsRow w0, w1, w2;
  int q = clampi(r0 - 1, 0, H - 1) * W;
  maps_row_in(w0, lo[q], cu[q], hi[q]);
  q = r0 * W;
  maps_row_in(w1, lo[q], cu[q], hi[q]);
  q = min(r0 + 1, H - 1) * W;
  float ln = lo[q], cn = cu[q], hn = hi[q];
  const int rend = min(r0 + M3_ROWS, H);
#define MAPS_STEP(U, M, D, r)                                  \
  {                                                            \
    maps_row_in(D, ln, cn, hn);                                \
    q = min((r) + 2, H - 1) * W;                               \
    ln = lo[q];                                                \
    cn = cu[q];                                                \
    hn = hi[q];                                                \
    maps_at(U, M, D, r, gc, hk, W, out_col, keep_c, p, o);     \
  }
#pragma unroll 1
  for (int r = r0; r < rend; r += 3) {
    MAPS_STEP(w0, w1, w2, r);
    if (r + 1 >= rend) break;
    MAPS_STEP(w1, w2, w0, r + 1);
    if (r + 2 >= rend) break;
    MAPS_STEP(w2, w0, w1, r + 2);
  }
#undef MAPS_STEP
}

// K2 entry: every detection level of one octave.  resps: B x L (H, W)
// float DoH planes, plane (b, l) at resps + b * r_sb + l * r_sl
// (elements; rows contiguous), L >= nl + 2; blurs likewise with
// b_sb / b_sl, L >= nl + 1.  Detection level l (1-based) reads resps l-1,
// l, l+1 and blur l.  Outputs are contiguous: ok (B,nl,H,W) u8, cell
// (B,nl,H,W) i32, tab (B,nl,5,H,W) f32 = [b0, b1, b2, val, Lxx] planes,
// cand (B,nl,H,W) u8.  vhw: null, or B (rows, columns) int32 pairs on
// the device, each image's true size when it is edge-padded: start
// pixels then lie in [border, rows - border) x [border, columns -
// border); the stencils, the solve and the walk's safety border keep
// the padded H x W.  Returns cudaGetLastError().
extern "C" int hesaff_detect_walk_octave(
    const float* resps, const float* blurs, long long r_sb, long long r_sl,
    long long b_sb, long long b_sl, uint8_t* ok, int32_t* cell, float* tab,
    uint8_t* cand, const int32_t* vhw, int B, int nl, int H, int W,
    int border, float pos_thr, float neg_thr, float edge_thr,
    float max_shift, int safety, int iters, float shift_lim,
    float final_thr, void* stream) {
  if (iters < 1 || iters > 16 || nl < 1 || B < 1 || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.border = border;
  p.safety = safety;
  p.iters = iters;
  p.pos_thr = pos_thr;
  p.neg_thr = neg_thr;
  p.edge_thr = edge_thr;
  p.max_shift = max_shift;
  p.shift_lim = shift_lim;
  p.final_thr = final_thr;
  const int halo = iters - 1;
  const size_t rec = (size_t)(WTH + 2 * halo) * (WTW + 2 * halo);
  const size_t inp = (size_t)(WTH + 2 * halo + 2) * walk_tile_iw(WTW, halo);
  const size_t shmem = 3 * inp * sizeof(float) + rec;
  cudaError_t err = cudaFuncSetAttribute(
      detect_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shmem);
  if (err != cudaSuccess) return (int)err;
  // 16-byte copies need every plane's rows on 16-byte boundaries
  const int vec = ((uintptr_t)resps % 16 == 0) && r_sb % 4 == 0 &&
                  r_sl % 4 == 0 && W % 4 == 0;
  const long long tiles_x = (W + WTW - 1) / WTW;
  if (tiles_x * nl > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)(tiles_x * nl), (H + WTH - 1) / WTH, B);
  detect_walk_kernel<<<grid, WTHREADS, shmem, (cudaStream_t)stream>>>(
      resps, blurs, r_sb, r_sl, b_sb, b_sl, ok, cell, tab, cand, vhw, nl, H,
      W, vec, p);
  return (int)cudaGetLastError();
}

// K3 entry.  low/cur/high: n (H, W) float planes, plane k of each at
// base + k * stride (elements; rows contiguous).  Outputs are
// contiguous: maps (n,H,W,4) f32 = [b0, b1, b2, val] with NaN -> 0 and
// +-inf -> +-FLT_MAX (16-byte aligned), nan / edge / mask (n,H,W) one
// byte each.  vhw: null, or n (rows, columns) int32 pairs on the device,
// each plane's true size when it is edge-padded (the mask's window, as
// in hesaff_detect_walk_octave).  Returns cudaGetLastError().
extern "C" int hesaff_detect_maps(
    const float* low, const float* cur, const float* high, long long s_low,
    long long s_cur, long long s_high, float* maps, uint8_t* nan_flag,
    uint8_t* edge, uint8_t* mask, const int32_t* vhw, int n, int H, int W,
    int border, float pos_thr, float neg_thr, float edge_thr,
    void* stream) {
  Params p = {};
  p.border = border;
  p.pos_thr = pos_thr;
  p.neg_thr = neg_thr;
  p.edge_thr = edge_thr;
  if (n < 1 || n > 65535 || H < 1 || W < 1 || (long long)H * W > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const int rows = M3_ROWS * M3_WARPS;
  dim3 grid((W + M3_COLS - 1) / M3_COLS, (H + rows - 1) / rows, n);
  detect_maps_kernel<<<grid, 32 * M3_WARPS, 0, (cudaStream_t)stream>>>(
      low, cur, high, s_low, s_cur, s_high, (float4*)maps, nan_flag, edge,
      mask, vhw, H, W, p);
  return (int)cudaGetLastError();
}
