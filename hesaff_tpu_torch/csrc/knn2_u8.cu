// Exact 2-NN of uint8 rows under squared L2 (K7), with int8 tensor-core
// products and the running (best, second) kept on chip.
//
// Replaces no TPU kernel: the JAX package's knn2 (hesaff_tpu/match.py)
// is a blocked float32 loop left to XLA, which the port's match.knn2
// keeps as its plain version (CPU tensors, float32 indexes, a one-row
// database).  This kernel takes its place where query and database are
// uint8 rows of 128 on the card, and gives the same idx / dist / dist2
// bit for bit.
//
// What bounds it on an H100: the products and, beside them, the
// epilogue.  An Oxford5k query is ~2,750 rows against a 16.33 M-row
// index, 2 x Nq x M x 128 = 1.15e13 exact uint8 operations: 5.8 ms at
// the int8 tensor cores' 1,979 TOP/s, where reading the 2.1 GB index once
// takes 0.62 ms.  Every (query, row) pair, ~4.5e10 a query, then needs
// its |d|^2 folded in and a compare against the running second.
// What the design does about it:
// - products: wgmma m64n256k32 u8 x u8 -> s32, both operands K-major in
//   128-byte-swizzled shared memory (a row is 128 bytes, four k-steps of
//   32); int32 sums of 128 products below 2^23 are exact;
// - a CTA holds a tile of 128 query rows (two consumer warpgroups of 64)
//   for a whole strip of the index, which streams in tiles of 256 rows
//   through a 4-stage TMA ring fed by one producer thread, each tile with
//   its 256 keys (|d|^2 + BIAS, precomputed);
// - the epilogue runs on the float pipe where it can: a query row's order
//   depends only on k = |d|^2 - 2 q.d + BIAS (|q|^2 is constant per row),
//   an integer in (0, 2^24) whose bits, read as a float, are k 2^-149, so
//   one exact float multiply-add of the accumulator's and the key's bits
//   gives k's bits; a three-way integer min folds a pair of columns into
//   a chunk's least k, and one compare a query row and tile against the
//   running second skips all but the rare tile that can change the row's
//   (best k, its row, second k), which is then folded in exactly;
// - the two consumer warpgroups take the tensor cores in turns (an
//   ordered pair of barriers): one runs its products while the other
//   reduces its accumulators.  The overlap is partial on the card: the
//   products alone take ~6.8 ms at the Oxford5k shape, the epilogue alone
//   ~5.4 ms, both 11.4 ms (an epilogue overlapping the next half tile's
//   products inside one warpgroup measured slower);
// - persistent CTAs walk (query tile, strip) items with the query tile
//   fastest, so the query tiles that read one strip run together and the
//   strip comes from device memory once and from L2 after that; the
//   number of strips is chosen by the wrapper from Nq, M and the SM count
//   (cuda_knn2.plan) so that every SM gets the same number of items;
// - three launches a call and no host sync: the keys of every index row
//   (one pass over the index into an int32 scratch, padded to whole tiles
//   with a key that never ranks), the strips (one partial (best k, row,
//   second k) per query row and strip), and a merge of each row's
//   partials in strip order that writes dist = float(|q|^2 + k - BIAS).
//
// Semantics: match.knn2's.  Squared distances of uint8 rows are integers
// below 2^24, exact in int32 and in float32.  Ties keep the lowest
// database row (argmin within a block and a strict < across blocks, in
// the plain version); dist2 is the second smallest distance counted with
// multiplicity, so duplicate minima give dist2 == dist.  Needs M >= 2
// (the plain version's single-row padding is not this kernel's).

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <limits.h>
#include <stdint.h>

#define DIM 128      // bytes a row
#define QROWS 128    // query rows a CTA holds: two warpgroups of 64
#define DROWS 256    // index rows a stage holds
#define STAGES 4
#define THREADS 384  // two consumer warpgroups, one producer warpgroup
// k = |d|^2 - 2 q.d + BIAS lies in (0, 2^24) for uint8 rows of 128
// (|q|^2 - |q - d|^2 = 2 q.d - |d|^2 <= 128 * 255^2 < BIAS); a padding
// row's key, 0.5f, stays above every real k
#define BIAS (1 << 23)
#define PAD_KEY 0x3F000000
#define FULL 0xffffffffu

// shared memory, from a 1024-byte aligned base (the swizzle's period)
#define Q_BYTES (QROWS * DIM)
#define D_BYTES (DROWS * DIM)
#define OFF_D (2 * Q_BYTES)
#define OFF_N (OFF_D + STAGES * D_BYTES)
#define OFF_BAR (OFF_N + STAGES * DROWS * 4)
#define N_BARS (2 * STAGES + 6)
#define SMEM_BYTES (OFF_BAR + N_BARS * 8 + 1024)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait until the barrier's phase differs from `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// A (cols 128 bytes, rows) box of a 2-D uint8 tensor map into shared
// memory, 128-byte swizzled; rows past the tensor read as zero.
__device__ __forceinline__ void tma_rows(void* dst, const CUtensorMap* map,
                                         int row, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_"
      "tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(0), "r"(row)
      : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// wgmma descriptor of a K-major tile of 128-byte rows, 128-byte swizzle:
// 8-row groups 1024 bytes apart (SBO); the leading offset is unused.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void fence_acc(int (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define A4(i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3])
#define A16(i) A4(i), A4(i + 4), A4(i + 8), A4(i + 12)
#define A64(i) A16(i), A16(i + 16), A16(i + 32), A16(i + 48)

// d (64 x 256, s32) = A (64 x 32 u8) . B (256 x 32 u8)^T (+ d if acc).
// Thread t of the warpgroup holds d[4i + 2h + j] at row
// 16 (t / 32) + (t % 32) / 4 + 8h, column 8i + 2 (t % 4) + j.
__device__ __forceinline__ void wgmma_u8(int (&d)[128], uint64_t a,
                                         uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.u8.u8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : A64(0), A64(64)
      : "l"(a), "l"(b), "r"(acc));
}

// The first tile of strip k of S over DT tiles.
__device__ __forceinline__ int strip_tile(int k, int DT, int S) {
  return (int)((long long)k * DT / S);
}

// Fold value v of index row `row` into a query row's (best, its row,
// second); rows arrive in increasing order, so a tie keeps the first.
__device__ __forceinline__ void take(int v, int row, int& b, int& bi,
                                     int& s) {
  if (v < b) {
    s = b;
    b = v;
    bi = row;
  } else if (v < s) {
    s = v;
  }
}

// Merge the (best, row, second) of the four lanes that share a query row
// (their columns interleave, so a tie keeps the lower row).
__device__ __forceinline__ void merge_lanes(int& b, int& bi, int& s) {
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    const int ob = __shfl_xor_sync(FULL, b, off);
    const int oi = __shfl_xor_sync(FULL, bi, off);
    const int os = __shfl_xor_sync(FULL, s, off);
    if (ob < b || (ob == b && oi < bi)) {
      s = min(os, b);
      b = ob;
      bi = oi;
    } else {
      s = min(s, ob);
    }
  }
}

// k = key - 2 p, as the float pipe computes it: key's and p's bits read
// as floats are key 2^-149 and p 2^-149 (p < 2^23, key < 2^24), so the
// fused multiply-add is exact and its bits are the integer key - 2 p.
__device__ __forceinline__ int fold(int p, float key) {
  return __float_as_int(fmaf(__int_as_float(p), -2.0f, key));
}

// One tile's accumulators into the thread's two query rows.  keys: the
// tile's 256 keys; row0: the index row of the thread's column 0.  A
// row's k of a column is one multiply-add on the float pipe, and the
// least k of each of four chunks of 16 columns a three-way integer min a
// column pair, the chunks' minima independent of each other.  A row
// whose least k of the tile is not below its second is unchanged (one
// compare and branch a row and tile); otherwise each chunk whose least k
// is below the second is folded in exactly, element by element.
__device__ __forceinline__ void epilogue(const int (&d)[128],
                                         const int* keys, int row0,
                                         int lane, int (&b)[2],
                                         int (&bi)[2], int (&s)[2]) {
  const int2* key2 = reinterpret_cast<const int2*>(keys) + (lane & 3);
  int m[2][4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    m[0][c] = m[1][c] = INT_MAX;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = 8 * c + u;
      const int2 n = key2[4 * i];
      const float nx = __int_as_float(n.x), ny = __int_as_float(n.y);
      m[0][c] = min(m[0][c], min(fold(d[4 * i], nx), fold(d[4 * i + 1], ny)));
      m[1][c] =
          min(m[1][c], min(fold(d[4 * i + 2], nx), fold(d[4 * i + 3], ny)));
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (min(min(m[h][0], m[h][1]), min(m[h][2], m[h][3])) >= s[h]) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (m[h][c] >= s[h]) continue;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = 8 * c + u;
        const int2 n = key2[4 * i];
        take(n.x - 2 * d[4 * i + 2 * h], row0 + 8 * i, b[h], bi[h], s[h]);
        take(n.y - 2 * d[4 * i + 2 * h + 1], row0 + 8 * i + 1, b[h], bi[h],
             s[h]);
      }
    }
  }
}

// The key of every index row, |d|^2 + BIAS, and PAD_KEY for the padding
// rows up to Mpad (a whole number of tiles).  Eight lanes a row, 16 bytes
// each.
__global__ void knn2_keys_kernel(const uint8_t* __restrict__ db,
                                 long long M, long long Mpad,
                                 int* __restrict__ keys) {
  const long long n = Mpad * 8;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       g < n; g += step) {
    const long long row = g >> 3;
    unsigned acc = 0;
    if (row < M) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(db + row * DIM) +
                            (g & 7));
      acc = __dp4a(v.x, v.x, acc);
      acc = __dp4a(v.y, v.y, acc);
      acc = __dp4a(v.z, v.z, acc);
      acc = __dp4a(v.w, v.w, acc);
    }
    acc += __shfl_xor_sync(FULL, acc, 1);
    acc += __shfl_xor_sync(FULL, acc, 2);
    acc += __shfl_xor_sync(FULL, acc, 4);
    if ((g & 7) == 0) keys[row] = row < M ? (int)acc + BIAS : PAD_KEY;
  }
}

// part: three (S, Nq) int32 planes, the best k, its row and the second k
// of each query row over each strip.
__global__ void __launch_bounds__(THREADS, 1)
    knn2_strips_kernel(__grid_constant__ const CUtensorMap qmap,
                       __grid_constant__ const CUtensorMap dmap,
                       const int* __restrict__ keys, int Nq, int QT, int DT,
                       int S, int* __restrict__ part) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* qbuf = smem;
  uint8_t* dbuf = smem + OFF_D;
  int* nbuf = reinterpret_cast<int*>(smem + OFF_N);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + OFF_BAR);
  uint64_t* empty = full + STAGES;
  uint64_t* qfull = empty + STAGES;
  uint64_t* qempty = qfull + 2;
  uint64_t* order = qempty + 2;  // order[w]: warpgroup w's turn
  const int n_items = QT * S;

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&qfull[i], 1);
      mbar_init(&qempty[i], 8);
      mbar_init(&order[i], 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: one thread keeps the query slots and the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 256) {
      int st = 0, qs = 0;
      uint32_t ph = 0, qph = 0;
      for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
        const int qt = it % QT, strip = it / QT;
        mbar_wait(&qempty[qs], qph ^ 1);
        mbar_expect_tx(&qfull[qs], Q_BYTES);
        tma_rows(qbuf + qs * Q_BYTES, &qmap, qt * QROWS, &qfull[qs]);
        if (++qs == 2) {
          qs = 0;
          qph ^= 1;
        }
        const int t1 = strip_tile(strip + 1, DT, S);
        for (int t = strip_tile(strip, DT, S); t < t1; ++t) {
          mbar_wait(&empty[st], ph ^ 1);
          mbar_expect_tx(&full[st], D_BYTES + DROWS * 4);
          tma_rows(dbuf + st * D_BYTES, &dmap, t * DROWS, &full[st]);
          bulk_copy(nbuf + st * DROWS, keys + (size_t)t * DROWS, DROWS * 4,
                    &full[st]);
          if (++st == STAGES) {
            st = 0;
            ph ^= 1;
          }
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns query rows 64 wg .. 64 wg + 63 of the
    // tile; the thread, rows r and r + 8 of its warp's 16
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    int st = 0, qs = 0;
    uint32_t ph = 0, qph = 0, oph = wg == 0 ? 1 : 0;
    int d[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0;
    for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
      const int qt = it % QT, strip = it / QT;
      const int t0 = strip_tile(strip, DT, S);
      const int t1 = strip_tile(strip + 1, DT, S);
      mbar_wait(&qfull[qs], qph);
      const uint64_t adesc = sw128_desc(qbuf + qs * Q_BYTES + wg * 64 * DIM);
      int b[2] = {INT_MAX, INT_MAX}, bi[2] = {0, 0}, s[2] = {INT_MAX, INT_MAX};
      for (int t = t0; t < t1; ++t) {
        mbar_wait(&full[st], ph);
        const uint64_t bdesc = sw128_desc(dbuf + st * D_BYTES);
        mbar_wait(&order[wg], oph);
        oph ^= 1;
        fence_acc(d);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int k = 0; k < 4; ++k)  // a k-step of 32 bytes: +2 in 16 B
          wgmma_u8(d, adesc + 2 * k, bdesc + 2 * k, k);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        fence_acc(d);
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(&order[wg ^ 1]);  // the other warpgroup's turn
          if (t == t1 - 1) mbar_arrive(&qempty[qs]);
        }
        epilogue(d, nbuf + st * DROWS, t * DROWS + 2 * (lane & 3), lane, b,
                 bi, s);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[st]);
        if (++st == STAGES) {
          st = 0;
          ph ^= 1;
        }
      }
      if (++qs == 2) {
        qs = 0;
        qph ^= 1;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        merge_lanes(b[h], bi[h], s[h]);
        const int r = qt * QROWS + wg * 64 + warp * 16 + (lane >> 2) + 8 * h;
        if ((lane & 3) == 0 && r < Nq) {
          part[(size_t)strip * Nq + r] = b[h];
          part[(size_t)(S + strip) * Nq + r] = bi[h];
          part[(size_t)(2 * S + strip) * Nq + r] = s[h];
        }
      }
    }
  }
}

// Each query row's partials in strip order (a strict <: the lower strip
// keeps a tie), then dist = |q|^2 + k - BIAS in float32 (exact below
// 2^24).
__global__ void knn2_merge_kernel(const uint8_t* __restrict__ q, int Nq,
                                  int S, const int* __restrict__ part,
                                  int32_t* __restrict__ idx,
                                  float* __restrict__ dist,
                                  float* __restrict__ dist2) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= Nq) return;
  int b = INT_MAX, bi = 0, s = INT_MAX;
  for (int k = 0; k < S; ++k) {
    const int pb = part[(size_t)k * Nq + r];
    if (pb < b) {
      s = min(b, part[(size_t)(2 * S + k) * Nq + r]);
      b = pb;
      bi = part[(size_t)(S + k) * Nq + r];
    } else {
      s = min(s, pb);
    }
  }
  const uint4* row = reinterpret_cast<const uint4*>(q + (size_t)r * DIM);
  unsigned n = 0;
#pragma unroll
  for (int k = 0; k < DIM / 16; ++k) {
    const uint4 v = row[k];
    n = __dp4a(v.x, v.x, n);
    n = __dp4a(v.y, v.y, n);
    n = __dp4a(v.z, v.z, n);
    n = __dp4a(v.w, v.w, n);
  }
  idx[r] = bi;
  dist[r] = (float)((int)n + b - BIAS);
  dist2[r] = (float)((int)n + s - BIAS);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the process's libcuda (which the CUDA
// runtime has loaded already), so that the library links nothing more.
static EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (h == nullptr) h = dlopen("libcuda.so.1", RTLD_NOW);
    if (h != nullptr)
      fn = (EncodeTiled)dlsym(h, "cuTensorMapEncodeTiled");
  }
  return fn;
}

// A map of `rows` rows of 128 bytes read in boxes of `box` rows.
static bool rows_map(EncodeTiled enc, CUtensorMap* map, const uint8_t* p,
                     long long rows, int box) {
  const cuuint64_t dims[2] = {DIM, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {DIM};
  const cuuint32_t boxd[2] = {DIM, (cuuint32_t)box};
  const cuuint32_t estr[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, (void*)p, dims, strides,
             boxd, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// q: (Nq, 128) uint8, db: (M, 128) uint8, both contiguous and 16-byte
// aligned on the device.  S strips (1 <= S <= ceil(M / 256)) over `ctas`
// persistent CTAs.  Scratch: keys, ceil(M / 256) * 256 int32; part,
// 3 * S * Nq int32.  Outputs idx (Nq) int32, dist / dist2 (Nq) float32.
// Three launches on `stream`.  Returns the first CUDA error.
extern "C" int hesaff_knn2_u8(const uint8_t* q, int Nq, const uint8_t* db,
                              long long M, int S, int ctas, int n_sm,
                              int* keys, int* part, int32_t* idx, float* dist,
                              float* dist2, void* stream) {
  const long long DT = (M + DROWS - 1) / DROWS;
  if (Nq < 1 || M < 2 || S < 1 || S > DT || ctas < 1 || n_sm < 1 ||
      DT * DROWS > INT_MAX || (long long)Nq * S * 3 > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorSharedObjectInitFailed;
  CUtensorMap qmap, dmap;
  if (!rows_map(enc, &qmap, q, Nq, QROWS) ||
      !rows_map(enc, &dmap, db, M, DROWS))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      knn2_strips_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const long long Mpad = DT * DROWS;
  const long long nb = (Mpad * 8 + 255) / 256;
  knn2_keys_kernel<<<(int)(nb < 16LL * n_sm ? nb : 16LL * n_sm), 256, 0,
                     st>>>(db, M, Mpad, keys);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  knn2_strips_kernel<<<ctas, THREADS, SMEM_BYTES, st>>>(
      qmap, dmap, keys, Nq, (Nq + QROWS - 1) / QROWS, (int)DT, S, part);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  knn2_merge_kernel<<<(Nq + 127) / 128, 128, 0, st>>>(q, Nq, S, part, idx,
                                                     dist, dist2);
  return (int)cudaGetLastError();
}
