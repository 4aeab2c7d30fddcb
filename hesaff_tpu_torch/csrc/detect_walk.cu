// One detection level: 3x3x3 NMS and the dense localisation solve,
// shared by two kernels through pixel_maps():
//   K2 detect_walk_kernel adds the bounded localisation walk from every
//      pixel (the dense path, octaves under 2^23 px);
//   K3 detect_maps_kernel writes the maps alone (the sparse walk of
//      larger octaves and detect_level).
//
// K2 replaces the TPU kernel hesaff_tpu/ops/pallas_detect.py:
// detect_walk_pallas (pallas_detect.py:324, kernel body
// _make_walk_kernel at :176).
//
// What bounds it on an H100: the per-pixel arithmetic (26-neighbour
// max/min, ten finite differences, a pivoted 3x3 solve with four
// divisions, the edge test) over four input planes, about 150 float
// operations against 16 bytes read and 33 bytes written a pixel; and
// the walk, which is data-dependent control flow.  The TPU composed the
// walk as four 9-way selects over whole planes carrying cell + accept
// bit packed into one float (exact only below 2^23 pixels).  Here each
// block computes the per-pixel records of its tile plus a halo of
// iters-1 pixels (the walk's reach) into shared memory, one byte per
// pixel (move, stop, stop-accept, candidate, edge), and then every
// output pixel walks directly: at most iters-1 steps, stop where the
// record says stop, else step.  Cells stay int32, so the 2^23-pixel
// limit is gone, and no plane of intermediate maps reaches device
// memory.
//
// K3 replaces detect_maps_pallas (pallas_detect.py:139, kernel body
// _make_kernel at :37).  It reads 12 bytes and writes 19 a pixel
// (maps as four floats, the nan / edge / mask flags as one byte each)
// for about 150 float operations, so on an H100 the bytes bound it.
// One thread per pixel over a 32 x 8 tile whose three planes sit in
// shared memory with a 1-px halo: each input is read once from device
// memory (the halo's re-reads mostly hit L2), the maps go out as one
// 16-byte store.  The TPU's row blocks with an 8-row halo, its (8, 128)
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

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#define TW 32
#define TH 16

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

// jnp.maximum / jnp.minimum: NaN propagates
__device__ __forceinline__ float nmax(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : (a > b ? a : b);
}
__device__ __forceinline__ float nmin(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : (a < b ? a : b);
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
  const int i0 = p2 ? 2 : (p1 ? 1 : 0);
  const int i1 = p2 ? 1 : (p1 ? 0 : 1);
  const int i2 = p2 ? 0 : 2;
  float row0[3], row1[3], row2[3];
  for (int j = 0; j < 3; ++j) {
    row0[j] = a[i0][j];
    row1[j] = a[i1][j];
    row2[j] = a[i2][j];
  }
  const float b0 = bb[i0];
  float b1 = bb[i1];
  float b2 = bb[i2];

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

// NMS, finite differences, pivoted solve and edge test at one pixel:
// the pixel's value sits at index ci of the three IW-wide shared tiles
// sl / sc / sh (low, cur, high), whose 1-px neighbourhood is in the
// tiles too.  b0, b1, b2, val are raw (NaN where the solve is
// singular); the callers sanitise them.
struct PixelMaps {
  float b0, b1, b2, val;
  bool cand, edge_bad, nan_flag;
};

__device__ __forceinline__ PixelMaps pixel_maps(const float* sl,
                                                const float* sc,
                                                const float* sh, int ci,
                                                int IW, const Params& p) {
#define AT(a, dr, dc) a[ci + (dr) * IW + (dc)]
  const float c = AT(sc, 0, 0);

  float mx = c, mn = c;
  for (int dr = -1; dr <= 1; ++dr)
    for (int dc = -1; dc <= 1; ++dc) {
      mx = nmax(mx, AT(sl, dr, dc));
      mn = nmin(mn, AT(sl, dr, dc));
      if (dr != 0 || dc != 0) {
        mx = nmax(mx, AT(sc, dr, dc));
        mn = nmin(mn, AT(sc, dr, dc));
      }
      mx = nmax(mx, AT(sh, dr, dc));
      mn = nmin(mn, AT(sh, dr, dc));
    }
  const bool cand = ((c > p.pos_thr) && (c >= mx)) ||
                    ((c < p.neg_thr) && (c <= mn));

  const float dxx = (AT(sc, 0, -1) - 2.0f * c) + AT(sc, 0, 1);
  const float dyy = (AT(sc, -1, 0) - 2.0f * c) + AT(sc, 1, 0);
  const float dss = (AT(sl, 0, 0) - 2.0f * c) + AT(sh, 0, 0);
  const float dxy = 0.25f * (((AT(sc, 1, 1) - AT(sc, 1, -1)) -
                              AT(sc, -1, 1)) + AT(sc, -1, -1));
  const float dxs = 0.25f * (((AT(sh, 0, 1) - AT(sh, 0, -1)) -
                              AT(sl, 0, 1)) + AT(sl, 0, -1));
  const float dys = 0.25f * (((AT(sh, 1, 0) - AT(sh, -1, 0)) -
                              AT(sl, 1, 0)) + AT(sl, -1, 0));
  const float dx = 0.5f * (AT(sc, 0, 1) - AT(sc, 0, -1));
  const float dy = 0.5f * (AT(sc, 1, 0) - AT(sc, -1, 0));
  const float ds = 0.5f * (AT(sh, 0, 0) - AT(sl, 0, 0));
  const float A[3][3] = {{dxx, dxy, dxs}, {dxy, dyy, dys}, {dxs, dys, dss}};
  const float rhs[3] = {-dx, -dy, -ds};
  float b0, b1, b2;
  solve3x3(A, rhs, &b0, &b1, &b2);
  const float val = c + 0.5f * ((dx * b0 + dy * b1) + ds * b2);

  const float edge_den = dxx * dyy - dxy * dxy;
  const float edge_score = ((dxx + dyy) * (dxx + dyy)) / edge_den;
  const bool edge_bad = (edge_score >= p.edge_thr) || (edge_score < 0.0f);
  const bool nan_flag = isnan(b0) || isnan(b1) || isnan(b2);
#undef AT
  PixelMaps m;
  m.b0 = b0;
  m.b1 = b1;
  m.b2 = b2;
  m.val = val;
  m.cand = cand;
  m.edge_bad = edge_bad;
  m.nan_flag = nan_flag;
  return m;
}

__global__ void detect_walk_kernel(
    const float* __restrict__ low, const float* __restrict__ cur,
    const float* __restrict__ high, const float* __restrict__ blur,
    long long s_low, long long s_cur, long long s_high, long long s_blur,
    uint8_t* __restrict__ ok_out, int32_t* __restrict__ cell_out,
    float* __restrict__ tab_out, uint8_t* __restrict__ cand_out, int H,
    int W, Params p) {
  extern __shared__ float sm[];
  const int HALO = p.iters - 1;        // walk reach
  const int RH = TH + 2 * HALO, RW = TW + 2 * HALO;
  const int IH = RH + 2, IW = RW + 2;  // + the stencils' 1-px reach
  float* sl = sm;
  float* sc = sl + IH * IW;
  float* sh = sc + IH * IW;
  uint8_t* flag = (uint8_t*)(sh + IH * IW);
  uint8_t* move = flag + RH * RW;

  const int n = blockIdx.z;
  const float* lo = low + n * s_low;
  const float* cu = cur + n * s_cur;
  const float* hi = high + n * s_high;
  const float* bl = blur + n * s_blur;
  const size_t out_plane = (size_t)n * H * W;
  const int r0 = blockIdx.y * TH, c0 = blockIdx.x * TW;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nt = blockDim.x * blockDim.y;

  for (int e = tid; e < IH * IW; e += nt) {
    const int rr = e / IW, cc = e - (e / IW) * IW;
    const int gr = clampi(r0 - HALO - 1 + rr, 0, H - 1);
    const int gc = clampi(c0 - HALO - 1 + cc, 0, W - 1);
    const size_t g = (size_t)gr * W + gc;
    sl[e] = lo[g];
    sc[e] = cu[g];
    sh[e] = hi[g];
  }
  __syncthreads();

  for (int e = tid; e < RH * RW; e += nt) {
    const int rr = e / RW, cc = e - (e / RW) * RW;
    const int gr = r0 - HALO + rr, gc = c0 - HALO + cc;
    const PixelMaps m =
        pixel_maps(sl, sc, sh, (rr + 1) * IW + (cc + 1), IW, p);
    const bool keep = gr >= p.border && gr < H - p.border &&
                      gc >= p.border && gc < W - p.border;
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
    const bool stop = m.nan_flag || border_bad || !moved;
    const bool shift_bad = fabsf(cb0) > p.shift_lim ||
                           fabsf(cb1) > p.shift_lim ||
                           fabsf(cb2) > p.shift_lim;
    const bool weak = fabsf(cval) < p.final_thr;
    const bool stop_ok = !m.nan_flag && !border_bad && !shift_bad && !weak;

    flag[e] = (stop ? F_STOP : 0) | (stop_ok ? F_STOPOK : 0) |
              (m.cand && keep ? F_CAND : 0) | (m.edge_bad ? F_EDGE : 0);
    move[e] = (uint8_t)((str + 1) | ((stc + 1) << 2));

    if (rr >= HALO && rr < HALO + TH && cc >= HALO && cc < HALO + TW &&
        gr < H && gc < W) {
      const size_t g = (size_t)gr * W + gc;
      const float lb = bl[g - (gc > 0 ? 1 : 0)];
      const float cbv = bl[g];
      const float rb = bl[g + (gc < W - 1 ? 1 : 0)];
      float* t = tab_out + (out_plane + g) * 5;
      t[0] = cb0;
      t[1] = cb1;
      t[2] = cb2;
      t[3] = cval;
      t[4] = (lb - 2.0f * cbv) + rb;
      cand_out[out_plane + g] = (m.cand && keep) ? 1 : 0;
    }
  }
  __syncthreads();

  for (int e = tid; e < TH * TW; e += nt) {
    const int tr = e / TW, tc = e - (e / TW) * TW;
    const int gr = r0 + tr, gc = c0 + tc;
    if (gr >= H || gc >= W) continue;
    int qr = gr, qc = gc;
    for (int it = 0; it < p.iters - 1; ++it) {
      const int li = (qr - r0 + HALO) * RW + (qc - c0 + HALO);
      if (flag[li] & F_STOP) break;
      const int m = move[li];
      qr = clampi(qr + (m & 3) - 1, 0, H - 1);
      qc = clampi(qc + ((m >> 2) & 3) - 1, 0, W - 1);
    }
    const uint8_t f0 = flag[(tr + HALO) * RW + (tc + HALO)];
    const uint8_t ff = flag[(qr - r0 + HALO) * RW + (qc - c0 + HALO)];
    const size_t g = out_plane + (size_t)gr * W + gc;
    ok_out[g] = ((f0 & F_CAND) && !(f0 & F_EDGE) && (ff & F_STOPOK)) ? 1 : 0;
    cell_out[g] = qr * W + qc;
  }
}

// K3: the maps alone, one thread per pixel of an MH x MW tile whose
// three input planes sit in shared memory with the stencils' 1-px halo
// (edge-replicated at the image border).
#define MW 32
#define MH 8

__global__ void detect_maps_kernel(
    const float* __restrict__ low, const float* __restrict__ cur,
    const float* __restrict__ high, long long s_low, long long s_cur,
    long long s_high, float4* __restrict__ maps_out,
    uint8_t* __restrict__ nan_out, uint8_t* __restrict__ edge_out,
    uint8_t* __restrict__ mask_out, int H, int W, Params p) {
  constexpr int IW = MW + 2, IH = MH + 2;
  __shared__ float sl[IH * IW], sc[IH * IW], sh[IH * IW];
  const int n = blockIdx.z;
  const float* lo = low + n * s_low;
  const float* cu = cur + n * s_cur;
  const float* hi = high + n * s_high;
  const int r0 = blockIdx.y * MH, c0 = blockIdx.x * MW;
  const int tid = threadIdx.y * MW + threadIdx.x;

  for (int e = tid; e < IH * IW; e += MH * MW) {
    const int rr = e / IW, cc = e - (e / IW) * IW;
    const int gr = clampi(r0 - 1 + rr, 0, H - 1);
    const int gc = clampi(c0 - 1 + cc, 0, W - 1);
    const size_t g = (size_t)gr * W + gc;
    sl[e] = lo[g];
    sc[e] = cu[g];
    sh[e] = hi[g];
  }
  __syncthreads();

  const int gr = r0 + threadIdx.y, gc = c0 + threadIdx.x;
  if (gr >= H || gc >= W) return;
  const PixelMaps m = pixel_maps(
      sl, sc, sh, (threadIdx.y + 1) * IW + (threadIdx.x + 1), IW, p);
  const bool keep = gr >= p.border && gr < H - p.border &&
                    gc >= p.border && gc < W - p.border;
  const size_t g = (size_t)n * H * W + (size_t)gr * W + gc;
  maps_out[g] = make_float4(nan_to_num(m.b0), nan_to_num(m.b1),
                            nan_to_num(m.b2), nan_to_num(m.val));
  nan_out[g] = m.nan_flag ? 1 : 0;
  edge_out[g] = m.edge_bad ? 1 : 0;
  mask_out[g] = (m.cand && keep) ? 1 : 0;
}

// low/cur/high/blur: n (H, W) float planes, plane k of each at
// base + k * stride (elements; rows contiguous).  Outputs are
// contiguous: ok (n,H,W) u8, cell (n,H,W) i32, tab (n,H,W,5) f32,
// cand (n,H,W) u8.  Returns cudaGetLastError().
extern "C" int hesaff_detect_walk(
    const float* low, const float* cur, const float* high, const float* blur,
    long long s_low, long long s_cur, long long s_high, long long s_blur,
    uint8_t* ok, int32_t* cell, float* tab, uint8_t* cand, int n, int H,
    int W, int border, float pos_thr, float neg_thr, float edge_thr,
    float max_shift, int safety, int iters, float shift_lim,
    float final_thr, void* stream) {
  if (iters < 1 || iters > 16) return (int)cudaErrorInvalidValue;
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
  const size_t rec = (size_t)(TH + 2 * halo) * (TW + 2 * halo);
  const size_t inp = (size_t)(TH + 2 * halo + 2) * (TW + 2 * halo + 2);
  const size_t shmem = 3 * inp * sizeof(float) + 2 * rec;
  dim3 block(32, 8);
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, n);
  detect_walk_kernel<<<grid, block, shmem, (cudaStream_t)stream>>>(
      low, cur, high, blur, s_low, s_cur, s_high, s_blur, ok, cell, tab,
      cand, H, W, p);
  return (int)cudaGetLastError();
}

// K3 entry.  low/cur/high: n (H, W) float planes as for
// hesaff_detect_walk.  Outputs are contiguous: maps (n,H,W,4) f32 =
// [b0, b1, b2, val] with NaN -> 0 and +-inf -> +-FLT_MAX (16-byte
// aligned), nan / edge / mask (n,H,W) one byte each.  Returns
// cudaGetLastError().
extern "C" int hesaff_detect_maps(
    const float* low, const float* cur, const float* high, long long s_low,
    long long s_cur, long long s_high, float* maps, uint8_t* nan_flag,
    uint8_t* edge, uint8_t* mask, int n, int H, int W, int border,
    float pos_thr, float neg_thr, float edge_thr, void* stream) {
  Params p = {};
  p.border = border;
  p.pos_thr = pos_thr;
  p.neg_thr = neg_thr;
  p.edge_thr = edge_thr;
  dim3 block(MW, MH);
  dim3 grid((W + MW - 1) / MW, (H + MH - 1) / MH, n);
  detect_maps_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      low, cur, high, s_low, s_cur, s_high, (float4*)maps, nan_flag, edge,
      mask, H, W, p);
  return (int)cudaGetLastError();
}
