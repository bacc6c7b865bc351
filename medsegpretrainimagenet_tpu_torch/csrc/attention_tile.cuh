// Tensor-core attention body for one (window, head) pair, shared by the
// kernels of window_attention.cu (K1) and image_attention.cu (K2), in bf16
// and in float32.  The two kernels differ only in where a pair's q, k, v
// and out lie: each hands attend_pairs a small addressing functor, and this
// header does the rest (the buffers, the pipeline over a block's pairs, the
// grid and the instance for D padded to 16).  An #include is textual, so
// each kernel compiles this body as it would its own copy.
//
// A pair is q, k, v: (n, d) of the element type T (bf16 or float) with
// n <= 64 and d <= 64.  In shared memory each operand is a tile of T with
// DP + V columns: DP = d rounded up to 16 (a template parameter) and V = 16
// bytes of padding (8 bf16, 4 floats), so that rows stay 16-byte aligned
// for cp.async and the fragment reads fall in distinct banks (below); the
// q tile has n rounded up to the 16 rows of an mma strip, the k and v
// tiles n rounded up to the keys of a k-step (16 in bf16, 8 in TF32).  In
// bf16 the 8 columns of padding put the eight 16-byte rows of an ldmatrix
// phase in distinct banks (a 64-byte stride would put rows 0, 2, 4 and 6
// on the same ones).  Outside rows < n and columns < d every
// tile holds zeros, which keeps the padding exact in both products: a zero
// column of q and k adds nothing to q.k^T, and a zero row of v meets a zero
// probability.
//
// Four warps each take a 16-row strip of the query rows and keep the
// whole strip's attention in registers (the scheme of Dao's FA-2), with
// float32 accumulators:
//   S = (q * scale) . k^T  S in 32 float registers (8 n-tiles of 8 keys);
//   S += bias, then mask   float32, from (n, ldb) tiles in shared memory;
//                          columns >= n are -inf;
//   P = softmax(S)         row max and sum across the quad of lanes that
//                          shares a row, e * (1 / s) in float32, kept in
//                          registers: the accumulator layout of S is the A
//                          layout of P.V (for float32 with the k-index read
//                          as below), so P never goes back to shared memory;
//   O = P . v              O in DP/2 float registers, written into the
//                          strip's own rows of the q tile, from where the
//                          kernel stores it with 16-byte writes.
//
// bf16 (attend_strip on bf16 tiles): mma.sync.m16n8k16 with bf16 operands
// from ldmatrix (.trans for v); the rounding points are the JAX package's:
// q * scale rounded to bf16 (the scale rounded to bf16 first), float32
// logits, bias, mask and softmax, probabilities rounded to bf16 before P.V,
// which sums in float32.  Only the order of the float32 sums inside the two
// products differs from the plain version, so the bf16 output is within a
// rounding step of it.
//
// float32 (attend_strip on float tiles): mma.sync.m16n8k8 with TF32
// operands, split three ways.  One TF32 pass keeps 10 mantissa bits and
// reads a max |kernel - plain| of about 1.5e-3 at swin_unet_224's shapes,
// 15 times the float32 bar of 1e-4.  So each operand x becomes hi =
// cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi), and each product tile is
// lo.hi + hi.lo + hi.hi into float32 accumulators (the dropped lo.lo term is
// about 2^-22 of the product): within a few float32 rounding steps of the
// plain version, as close to float64 as plain float32 is.  q is multiplied
// by scale in float32 before the split, as the plain version does; the
// probabilities are split like any other operand.  Where trouble lies:
// - ldmatrix moves 16-bit elements only, so the TF32 fragments are 32-bit
//   shared-memory reads (g = lane / 4, t = lane % 4): A a0..a3 = (g, t),
//   (g + 8, t), (g, t + 4), (g + 8, t + 4); B b0, b1 = (k = t, n = g),
//   (k = t + 4, n = g); C c0..c3 = (g, 2t), (g, 2t + 1), (g + 8, 2t),
//   (g + 8, 2t + 1).
// - The C layout of S is not the A layout of P.V.  It becomes it without a
//   shuffle if P.V's k-index kappa of k-step kk is read as key kk*8 + 2t for
//   kappa = t and kk*8 + 2t + 1 for kappa = t + 4 (a sum over k does not
//   care in which order it takes its terms): then a0..a3 = c0, c2, c1, c3,
//   and the B fragment of v comes from rows kk*8 + 2t and kk*8 + 2t + 1.
// - Banks: a row stride of DP + 4 floats is 4 or 20 modulo 32, so g * LD +
//   t (q and k) and 2t * LD + g (v) fall on 32 distinct banks.
// - Shared memory: at N = 49 two pair buffers of (64 + 2 x 56) x (DP + 4)
//   floats are 50.7 KB at D = 32 and 95.7 KB at D = 64, and the bias and
//   mask tables 11 KB each.  A masked block at D = 32 takes 72.6 KB, so
//   three fit on an SM (with k and v padded to 64 rows too, 77.2 KB, two);
//   plan lifts the kernel's limit, and one block still fits at D = 64 with
//   a mask (117.7 KB).
// - Registers: S is 32 floats, O DP/2, a k-step's split fragment of q 8.
// - The kernel sums in another order than the plain version: the float32
//   checks hold it to the unchanged bars of 1e-4 max and 1e-6 mean.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace tile {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

// elements of T in 16 bytes: one cp.async, and the row padding of a tile
template <class T>
__host__ __device__ constexpr int vec_elems() {
  return static_cast<int>(16 / sizeof(T));
}

// rows of the q tile: n rounded up to the 16 rows of an mma strip
__host__ __device__ constexpr int rows_padded(int n) {
  return (n + 15) / 16 * 16;
}

// row stride (floats) of the bias and mask tiles: at least n and 8 more
// than a multiple of 16, so the float2 reads of a C fragment (8 rows, 4
// lanes each) fall in distinct banks in each half-warp phase
__host__ __device__ inline int table_stride(int n) {
  return (n + 7) / 16 * 16 + 8;
}

// rows of the k and v tiles: n rounded up to the keys of a k-step of P.v,
// 16 in bf16 (also the 16 keys of an ldmatrix x4 of k), 8 in TF32
template <class T>
__host__ __device__ constexpr int key_rows(int n) {
  return std::is_same<T, bf16>::value ? rows_padded(n) : (n + 7) / 8 * 8;
}

// elements of one pair buffer of T: the q tile, then the k and v tiles
template <class T, int DP>
__host__ __device__ inline int pair_elems(int n) {
  return (rows_padded(n) + 2 * key_rows<T>(n)) * (DP + vec_elems<T>());
}

// bytes of shared memory for two pair buffers and the bias (and mask) tile
template <class T, int DP>
__host__ __device__ inline size_t smem_bytes(int n, bool masked) {
  return 2 * sizeof(T) * pair_elems<T, DP>(n) +
         (masked ? 2 : 1) * sizeof(float) * n * table_stride(n);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// wait until at most one committed group of this thread is in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// c += a . b on one m16n8k16 tile, bf16 operands, float32 accumulators
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b on one m16n8k8 tile, TF32 operands, float32 accumulators
__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo to about 2^-22 |x|, hi and lo rounded to TF32 (nearest, ties
// away from zero) as the 32-bit patterns an mma takes
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

// c += a . b in split TF32: the two small cross terms first, then hi . hi.
// b holds the B fragment {hi b0, hi b1, lo b0, lo b1}.
__device__ __forceinline__ void mma_split(float (&c)[4],
                                          const uint32_t (&a_hi)[4],
                                          const uint32_t (&a_lo)[4],
                                          const uint32_t (&b)[4]) {
  mma_tf32(c, a_lo, b[0], b[1]);
  mma_tf32(c, a_hi, b[2], b[3]);
  mma_tf32(c, a_hi, b[0], b[1]);
}

// two floats rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&r);
}

// a packed bf16 pair times s, each product rounded to bf16: the product of
// two bf16 values is exact in float32, so this is bf16 multiplication
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t x, float s) {
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
  return pack_bf16(f.x * s, f.y * s);
}

// Warp `warp`'s strip of the pair in q, k, v (tiles of T as described
// above): rows warp*16 .. warp*16 + 15 of out = softmax(q*scale_t . k^T +
// bias (+ mask)) . v, left as T in the same rows of q (rows < n only).
// bias and mask (or null) are (n, ldb) float tiles.  Returns the rows it
// wrote, 0 if the strip lies wholly past n.  The products are the element
// type's (bf16 tiles or split TF32, the branches below); the softmax
// between them is shared, and the bf16 instance compiles the statements of
// the bf16-only body it replaced, in their order.
template <int DP, class T>
__device__ __forceinline__ int attend_strip(T* q, const T* k, const T* v,
                                            const float* bias,
                                            const float* mask, int ldb, int n,
                                            float scale_t, int warp,
                                            int lane) {
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  constexpr int LD = DP + vec_elems<T>();
  const int r0 = warp * 16;
  if (r0 >= n) return 0;
  const int g = lane >> 2;  // row of the fragment (and row + 8)
  const int tq = lane & 3;  // column (pair) of the fragment

  // S = (q * scale) . k^T in 8 n-tiles of 8 keys
  float s[8][4];
  if constexpr (kBf16) {
    constexpr int KS = DP / 16;  // k-steps of q.k^T
    // A fragments of q * scale, rounded to bf16
    uint32_t qa[KS][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      ldsm_x4(qa[kk],
              q + (r0 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int r = 0; r < 4; ++r)
        qa[kk][r] = scale_bf16x2(qa[kk][r], scale_t);
    }

    // one x4 ldmatrix of k gives the B fragments of two n-tiles
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[nt][r] = 0.f;
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      if (jp * 16 >= n) continue;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const int key = jp * 16 + (lane & 7) + ((lane >> 4) << 3);
        uint32_t b[4];
        ldsm_x4(b, k + key * LD + kk * 16 + ((lane >> 3) & 1) * 8);
        mma(s[2 * jp], qa[kk], b[0], b[1]);
        mma(s[2 * jp + 1], qa[kk], b[2], b[3]);
      }
    }
  } else {
    constexpr int KS = DP / 8;  // k-steps of q.k^T
    // per k-step the A fragment of q (rows g and g + 8, columns tq and
    // tq + 4) is scaled and split once, against the B fragments of up to 8
    // n-tiles of k (key g, columns tq and tq + 4)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[nt][r] = 0.f;
    const float* qf = q + (r0 + g) * LD + tq;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a_hi[4], a_lo[4];
      split_tf32(qf[kk * 8] * scale_t, a_hi[0], a_lo[0]);
      split_tf32(qf[8 * LD + kk * 8] * scale_t, a_hi[1], a_lo[1]);
      split_tf32(qf[kk * 8 + 4] * scale_t, a_hi[2], a_lo[2]);
      split_tf32(qf[8 * LD + kk * 8 + 4] * scale_t, a_hi[3], a_lo[3]);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt * 8 >= n) continue;
        const float* kf = k + (nt * 8 + g) * LD + kk * 8 + tq;
        uint32_t b[4];
        split_tf32(kf[0], b[0], b[2]);
        split_tf32(kf[4], b[1], b[3]);
        mma_split(s[nt], a_hi, a_lo, b);
      }
    }
  }

  // + bias, then + mask, in float32; columns >= n to -inf; row max.
  // s[nt][2*half + e] is row r0 + g + 8*half, column nt*8 + 2*tq + e.
  float row_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int j = nt * 8 + 2 * tq;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = r0 + g + 8 * half;
      float x0 = s[nt][2 * half], x1 = s[nt][2 * half + 1];
      if (i < n && j < n) {  // j + 1 <= ldb - 1: the tile is that wide
        const float2 b = *reinterpret_cast<const float2*>(bias + i * ldb + j);
        x0 += b.x;
        x1 += b.y;
        if (mask != nullptr) {
          const float2 m =
              *reinterpret_cast<const float2*>(mask + i * ldb + j);
          x0 += m.x;
          x1 += m.y;
        }
      }
      if (j >= n) x0 = -INFINITY;
      if (j + 1 >= n) x1 = -INFINITY;
      s[nt][2 * half] = x0;
      s[nt][2 * half + 1] = x1;
      row_max[half] = fmaxf(row_max[half], fmaxf(x0, x1));
    }
  }
  float row_sum[2] = {0.f, 0.f};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    row_max[half] = fmaxf(row_max[half],
                          __shfl_xor_sync(0xffffffffu, row_max[half], 1));
    row_max[half] = fmaxf(row_max[half],
                          __shfl_xor_sync(0xffffffffu, row_max[half], 2));
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      s[nt][r] = expf(s[nt][r] - row_max[r >> 1]);
      row_sum[r >> 1] += s[nt][r];
    }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    row_sum[half] += __shfl_xor_sync(0xffffffffu, row_sum[half], 1);
    row_sum[half] += __shfl_xor_sync(0xffffffffu, row_sum[half], 2);
  }

  // e times the correctly rounded 1/s, within an ulp of e / s in float32: a
  // division per element takes its slow path on the subnormal e^-100 of
  // every masked entry
  const float inv[2] = {__frcp_rn(row_sum[0]), __frcp_rn(row_sum[1])};
  if constexpr (kBf16) {
    constexpr int KS = DP / 16;  // n-tile pairs of P.v
    // P as A fragments, rounded to bf16: k-step kk (keys 16kk..16kk+15) is
    // n-tiles 2kk, 2kk+1
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        pa[kk][half] = pack_bf16(s[2 * kk][2 * half] * inv[half],
                                 s[2 * kk][2 * half + 1] * inv[half]);
        pa[kk][2 + half] = pack_bf16(s[2 * kk + 1][2 * half] * inv[half],
                                     s[2 * kk + 1][2 * half + 1] * inv[half]);
      }

    // O = P . v: one x4 ldmatrix.trans of v gives two n-tiles of 8 columns
    float o[DP / 8][4];
#pragma unroll
    for (int nt = 0; nt < DP / 8; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) o[nt][r] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk * 16 >= n) continue;
#pragma unroll
      for (int dp = 0; dp < KS; ++dp) {
        const int key = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        uint32_t b[4];
        ldsm_x4_trans(b, v + key * LD + dp * 16 + (lane >> 4) * 8);
        mma(o[2 * dp], pa[kk], b[0], b[1]);
        mma(o[2 * dp + 1], pa[kk], b[2], b[3]);
      }
    }

    // O in bf16 into the strip's rows of q (no other warp reads them)
    __syncwarp();
#pragma unroll
    for (int nt = 0; nt < DP / 8; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = r0 + g + 8 * half;
        if (i < n)
          *reinterpret_cast<uint32_t*>(q + i * LD + nt * 8 + 2 * tq) =
              pack_bf16(o[nt][2 * half], o[nt][2 * half + 1]);
      }
    __syncwarp();
  } else {
    constexpr int KS = DP / 8;  // n-tiles of P.v
    // O = P . v: k-step kk is n-tile kk of S, its accumulator read as the A
    // fragment (a0..a3 = c0, c2, c1, c3: keys kk*8 + 2tq and + 1), split,
    // against v's rows kk*8 + 2tq and kk*8 + 2tq + 1 at column nt*8 + g
    float o[KS][4];
#pragma unroll
    for (int nt = 0; nt < KS; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) o[nt][r] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      if (kk * 8 >= n) continue;
      uint32_t a_hi[4], a_lo[4];
      split_tf32(s[kk][0] * inv[0], a_hi[0], a_lo[0]);
      split_tf32(s[kk][2] * inv[1], a_hi[1], a_lo[1]);
      split_tf32(s[kk][1] * inv[0], a_hi[2], a_lo[2]);
      split_tf32(s[kk][3] * inv[1], a_hi[3], a_lo[3]);
      const float* vf = v + (kk * 8 + 2 * tq) * LD + g;
#pragma unroll
      for (int nt = 0; nt < KS; ++nt) {
        uint32_t b[4];
        split_tf32(vf[nt * 8], b[0], b[2]);
        split_tf32(vf[LD + nt * 8], b[1], b[3]);
        mma_split(o[nt], a_hi, a_lo, b);
      }
    }

    // O into the strip's rows of q (no other warp reads them)
    __syncwarp();
#pragma unroll
    for (int nt = 0; nt < KS; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = r0 + g + 8 * half;
        if (i < n)
          *reinterpret_cast<float2*>(q + i * LD + nt * 8 + 2 * tq) =
              make_float2(o[nt][2 * half], o[nt][2 * half + 1]);
      }
    __syncwarp();
  }
  return min(16, n - r0);
}

// zero `elems` values of T at p (16-byte aligned, a multiple of 16 bytes)
template <class T>
__device__ __forceinline__ void zero_tiles(T* p, int elems, int tid) {
  uint4* p4 = reinterpret_cast<uint4*>(p);
  for (int i = tid; i < elems / vec_elems<T>(); i += kThreads)
    p4[i] = make_uint4(0, 0, 0, 0);
}

// an (n, n) float table from device memory into an (n, ldb) tile, one warp
// per row, with 4-byte cp.async (rows of n floats need not be 16-byte
// aligned): the copies join the first pair's group and wait with it
__device__ __forceinline__ void load_table(float* dst, const float* src,
                                           int n, int ldb, int warp,
                                           int lane) {
  for (int i = warp; i < n; i += kWarps)
    for (int j = lane; j < n; j += 32)
      cp_async4(dst + i * ldb + j, src + i * n + j);
}

// The pairs of this block.  The grid (plan) is, head fastest,
// blockIdx.x = (chunk * n_w + w) * heads + h: a block takes one group, a
// (window mod n_w, head) that shares one bias (and mask) tile, and walks
// `per` of its `images` images from img0 on, `count` of them (fewer in the
// last chunk).
struct Pairs {
  int h, w, img0, count;
};

__device__ __forceinline__ Pairs block_pairs(int heads, int n_w, int per,
                                             int images) {
  const int group = blockIdx.x / heads;
  const int img0 = group / n_w * per;
  return {static_cast<int>(blockIdx.x % heads), group % n_w, img0,
          min(per, images - img0)};
}

// A block's walk over its `count` pairs, the kernels' whole body for either
// element type At::Elem.  `at` is the kernel's addressing: at.q, at.k, at.v
// and at.out, and the element offsets at.src(t) of pair t in q, k and v,
// at.src_token(i) of its token i from there, at.dst(t) and at.dst_token(i)
// the same in out.  bias and mask (or null) point at the group's (n, n)
// float tables.  `smem` holds two pair buffers and the bias (and mask)
// tile, smem_bytes.  Each pair comes with 16-byte cp.async (vec: d a
// multiple of the 16-byte width, 8 bf16 or 4 floats, and every operand
// 16-byte aligned) or one element at a time, into the buffer the pair
// before last used, while the tensor cores attend the last one; each warp
// stores its strip of out from the q tile, 16 bytes at a time.
template <int DP, class At>
__device__ __forceinline__ void attend_pairs(const At& at,
                                             unsigned char* smem,
                                             const float* bias,
                                             const float* mask, int n, int d,
                                             int count, float scale,
                                             bool vec) {
  using T = typename At::Elem;
  constexpr int V = vec_elems<T>();
  constexpr int LD = DP + V;
  constexpr int CPR = DP / V;  // 16-byte chunks of a padded row
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ldb = table_stride(n);
  const int qe = rows_padded(n) * LD;  // elements of the q tile
  // of the k tile and the v tile: in bf16 the q tile's, as the compiler
  // sees (separate offsets cost the bf16 body registers and time)
  const int ke = std::is_same<T, bf16>::value ? qe : key_rows<T>(n) * LD;
  const int pe = qe + 2 * ke;  // of a pair buffer, pair_elems
  T* buf = reinterpret_cast<T*>(smem);
  float* bias_s = reinterpret_cast<float*>(buf + 2 * pe);
  float* mask_s = mask == nullptr ? nullptr : bias_s + n * ldb;
  // bf16 multiplies q by the scale rounded to bf16, float32 by the scale
  const float scale_t = std::is_same<T, bf16>::value
                            ? __bfloat162float(__float2bfloat16(scale))
                            : scale;

  zero_tiles(buf, 2 * pe, tid);
  load_table(bias_s, bias, n, ldb, warp, lane);
  if (mask_s != nullptr) load_table(mask_s, mask, n, ldb, warp, lane);
  __syncthreads();  // the zeros land before any copy into the buffers

  auto load = [&](int t, T* dst) {
    const size_t pair = at.src(t);
    if (vec) {
      for (int idx = tid; idx < n * CPR; idx += kThreads) {
        const int i = idx / CPR, c = idx - i * CPR;
        if (c * V >= d) continue;
        const size_t src = pair + at.src_token(i) + c * V;
        T* to = dst + i * LD + c * V;
        cp_async16(to, at.q + src);
        cp_async16(to + qe, at.k + src);
        cp_async16(to + qe + ke, at.v + src);
      }
    } else {
      for (int idx = tid; idx < n * DP; idx += kThreads) {
        const int i = idx / DP, c = idx - i * DP;
        if (c >= d) continue;
        const size_t src = pair + at.src_token(i) + c;
        T* to = dst + i * LD + c;
        to[0] = at.q[src];
        to[qe] = at.k[src];
        to[qe + ke] = at.v[src];
      }
    }
  };
  // the warp's rows r0 .. r0 + rows - 1 of out, from rows of the q tile
  auto store = [&](int t, const T* from, int rows) {
    const size_t pair = at.dst(t);
    const int r0 = warp * 16;
    if (vec) {
      for (int idx = lane; idx < rows * CPR; idx += 32) {
        const int i = r0 + idx / CPR, c = idx % CPR;
        if (c * V < d)
          *reinterpret_cast<uint4*>(at.out + pair + at.dst_token(i) + c * V) =
              *reinterpret_cast<const uint4*>(from + i * LD + c * V);
      }
    } else {
      for (int idx = lane; idx < rows * DP; idx += 32) {
        const int i = r0 + idx / DP, c = idx % DP;
        if (c < d) at.out[pair + at.dst_token(i) + c] = from[i * LD + c];
      }
    }
  };

  load(0, buf);
  cp_async_commit();
  for (int t = 0; t < count; ++t) {
    T* cur = buf + (t & 1) * pe;
    if (t + 1 < count) load(t + 1, buf + ((t + 1) & 1) * pe);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const int rows = attend_strip<DP, T>(cur, cur + qe, cur + qe + ke,
                                         bias_s, mask_s, ldb, n, scale_t,
                                         warp, lane);
    if (rows > 0) store(t, cur, rows);
    __syncthreads();
  }
}

// The grid of a kernel whose block takes one group of pairs that share a
// bias (and mask) tile and walks `per` of the group's `images` pairs: as
// many blocks as fit on the card at once (so the tile is loaded as few
// times as the card's width allows), at least one per group.  Also lifts
// the kernel's dynamic shared-memory limit to `smem`.
inline cudaError_t plan(const void* kernel, size_t smem, long long groups,
                        int images, int* per, long long* blocks) {
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int device = 0, sms = 0, resident = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  if (resident < 1) return cudaErrorInvalidConfiguration;
  long long chunks = static_cast<long long>(sms) * resident / groups;
  chunks = chunks < 1 ? 1 : (chunks > images ? images : chunks);
  *per = static_cast<int>((images + chunks - 1) / chunks);
  *blocks = groups * ((images + *per - 1) / *per);
  return *blocks > 0x7fffffffLL ? cudaErrorInvalidValue : cudaSuccess;
}

// Plan the grid of `kernel` for `groups` groups of `images` pairs each and
// launch it on `stream` as kernel(args..., per).  Returns
// cudaGetLastError() after the launch, or the error that refused it.
template <class... Params, class... Args>
inline int launch(void (*kernel)(Params...), size_t smem, long long groups,
                  int images, void* stream, Args... args) {
  int per = 0;
  long long blocks = 0;
  const cudaError_t err = plan(reinterpret_cast<const void*>(kernel), smem,
                               groups, images, &per, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(args..., per);
  return static_cast<int>(cudaGetLastError());
}

// f(std::integral_constant<int, DP>()) for d padded to DP, a multiple of
// 16: one instance of the body for each of D <= 16, 32, 48 and 64
template <class F>
inline int with_padded_d(int d, F&& f) {
  switch ((d + 15) / 16) {
    case 1:
      return f(std::integral_constant<int, 16>());
    case 2:
      return f(std::integral_constant<int, 32>());
    case 3:
      return f(std::integral_constant<int, 48>());
    default:
      return f(std::integral_constant<int, 64>());
  }
}

}  // namespace tile
