// Tensor-core attention backward for one (window, head) pair, shared by the
// kernels of window_attention_bwd.cu (K1's backward) and
// image_attention_bwd.cu (K2's), in bf16 and in float32.  As in the
// forward's attention_tile.cuh, the two kernels differ only in where a
// pair's operands lie: each hands grad_pairs an addressing functor, and
// this header does the rest (the buffers, the pipeline over a block's
// pairs, the dS partials and their sum).
//
// A pair is q, k, v and the output's cotangent g: (n, d) of T (bf16 or
// float), n <= 64, d <= 64.  It computes, with the rounding points of the
// JAX package's custom VJP _fused_bwd:
//   P  = softmax(q*scale . k^T + bias (+ mask))   recomputed, as forward
//   dV = P^T . g
//   dP = g . v^T
//   dS = P o (dP - rowsum(dP o P))                float32
//   dQ = scale * dS . k,  dK = scale * dS^T . q
// and adds dS, in float32, to the running sum that becomes dbias (summed
// over windows) and dmask (summed over images and heads).
//
// What bounds it on the H100: device-memory bytes.  A pair reads q, k, v
// and g and writes dq, dk and dv, 7 * n*d*itemsize bytes, for 4 products
// of 2*n*n*d operations each (the S recompute besides): at N = 49, D = 32
// about 28 FLOP per byte in bf16, far under the card's ridges.  So the
// design makes one pass over those bytes and keeps everything else on the
// chip:
// - S and P are recomputed in registers, one 16-row mma strip per warp
//   (a window's whole row fits it), as the forward computes them: no
//   logsumexp is saved, and the forward's operator is unchanged;
// - phase 1, per warp and its strip of query rows: S, P, dP = g . v^T
//   and dS in registers (dP has S's accumulator layout, so the row sum
//   of dP o P is a quad shuffle), dQ = dS . k from the registers (dS's
//   accumulator layout is the A layout of the next product, as P's is in
//   the forward), and P and dS into two tiles of shared memory;
// - phase 2, per warp and its strip of key rows: the transposed products
//   dV = P^T . g and dK = dS^T . q sum over the query rows of all four
//   warps, so they read P and dS from those tiles: in bf16 with
//   ldmatrix.trans (the tiles stored as [query][key] are the A operand's
//   transpose), in float32 with 32-bit reads;
// - q, k, v and g come in by 16-byte cp.async, double-buffered across a
//   block's pairs; dq, dk and dv are staged in the pair's own q, k and v
//   tiles (after the last read of each) and leave with 16-byte stores;
// - a block takes one (window mod nW, head) and walks its images (the
//   forward's grid, tile::plan), so its bias and mask tiles load once and
//   each thread keeps its strip's running sum of dS in registers; at the
//   end the block writes that sum as an (n, n) float32 partial, and a
//   second small launch (sum_partials) adds the partials in a fixed order
//   into dbias (H, N, N) and dmask (nW, N, N): no float atomics, so the
//   same inputs give bit-equal gradients run to run.
//
// bf16: mma.sync.m16n8k16, float32 accumulators.  q*scale is rounded to
// bf16 with the scale rounded first (the forward's S); q, k, v and g are
// bf16 already, so every product of them is exact in float32.  P and dS
// are float32 (as in _fused_bwd, and the plain version
// window_attention_backward); they enter the products that take them (dV,
// dQ, dK) split into two bf16 operands, hi = bf16(x) and lo = bf16(x -
// hi), as lo.b + hi.b, so that they keep about 16 significant bits.  A
// single bf16 rounding of P and dS reads a mean |kernel - plain| of about
// 3e-4 on swin_unet_224's gradients, as much as a kernel that dropped its
// bias (3e-3 at most ten times more): the split brings it to about 5e-7,
// under the forward's bf16 mean bar of 1e-5, and the bf16 gradients are
// then within one bf16 rounding step of the plain version.
//
// float32: the forward's split TF32, mma.sync.m16n8k8, each operand x as
// hi = tf32(x) and lo = tf32(x - hi), each product lo.hi + hi.lo + hi.hi:
// within a few float32 rounding steps of the plain version (one TF32 pass
// misses the float32 bars, as for the forward).
//
// Padding.  In the q, k, v and g tiles, rows >= n and columns >= d hold
// zeros, as in the forward.  A padded query row has S = 0 on the keys
// < n, so P is uniform there, not zero; its g row is zero, so its dP and
// dS are zero and its P meets a zero row of g in dV: it adds nothing to
// dV, dK or the dS sum.  Keys >= n have S = -inf and P = 0.  The staged
// outputs are zero in the columns >= d (they sum products with zero
// columns), so the tiles stay zero there.
//
// Shared memory (elements of T unless said): two pair buffers of four
// (rows_padded(n), DP + V) tiles, the P and dS tiles (rows_padded(n), 72;
// in bf16 a hi and a lo tile of each), the bias and mask tables ((n, ldb)
// floats).  At N = 49, D = 32 a masked bf16 block takes 99.8 KB (two fit
// on an SM), a float32 one 132.5 KB (one).
// Banks: the P and dS tiles' stride of 72 elements puts the bf16 strips'
// 32-bit stores and the ldmatrix.trans rows of phase 2 in distinct banks,
// and the float32 float2 stores and A reads (8t + g) too; the float32 B
// reads of g and q in phase 2 (t * (DP + 4) + g) meet 2-way conflicts.
#pragma once

#include "attention_tile.cuh"

namespace tile {

// row stride (elements of T) of the P and dS tiles: 64 keys and 8 of
// padding
constexpr int kProbLd = 72;

// elements of T of one pair buffer: the q, k, v and g tiles
template <class T, int DP>
__host__ __device__ inline int grad_pair_elems(int n) {
  return 4 * rows_padded(n) * (DP + vec_elems<T>());
}

// tiles of P and dS: in bf16 a hi and a lo tile of each
template <class T>
__host__ __device__ constexpr int prob_tiles() {
  return std::is_same<T, bf16>::value ? 4 : 2;
}

// bytes of shared memory: two pair buffers, the P and dS tiles, the bias
// (and mask) table
template <class T, int DP>
__host__ __device__ inline size_t grad_smem_bytes(int n, bool masked) {
  return sizeof(T) * (2 * grad_pair_elems<T, DP>(n) +
                      prob_tiles<T>() * rows_padded(n) * kProbLd) +
         (masked ? 2 : 1) * sizeof(float) * n * table_stride(n);
}

// x0, x1 as hi + lo, each a packed pair of bf16 (lo = bf16(x - hi)), to
// about 2^-16 |x|
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  hi = pack_bf16(x0, x1);
  const float2 h =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi));
  lo = pack_bf16(x0 - h.x, x1 - h.y);
}

// c[nt] = (a * scale) . b^T for rows r0 .. r0 + 15 of the tile a against
// the rows (keys) of the tile b, in 8 n-tiles of 8 keys; n-tiles wholly
// past n stay 0.  bf16: a * scale rounded to bf16 (kScale) from ldmatrix
// fragments, as the forward's S; float: a * scale in float32, split TF32.
template <int DP, bool kScale, class T>
__device__ __forceinline__ void strip_abt(const T* a, const T* b, int r0,
                                          int n, float scale, int lane,
                                          float (&c)[8][4]) {
  constexpr int LD = DP + vec_elems<T>();
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) c[nt][r] = 0.f;
  if constexpr (std::is_same<T, bf16>::value) {
    constexpr int KS = DP / 16;
    uint32_t fa[KS][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      ldsm_x4(fa[kk], a + (r0 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
      if constexpr (kScale) {
#pragma unroll
        for (int r = 0; r < 4; ++r) fa[kk][r] = scale_bf16x2(fa[kk][r], scale);
      }
    }
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      if (jp * 16 >= n) continue;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const int key = jp * 16 + (lane & 7) + ((lane >> 4) << 3);
        uint32_t fb[4];
        ldsm_x4(fb, b + key * LD + kk * 16 + ((lane >> 3) & 1) * 8);
        mma(c[2 * jp], fa[kk], fb[0], fb[1]);
        mma(c[2 * jp + 1], fa[kk], fb[2], fb[3]);
      }
    }
  } else {
    constexpr int KS = DP / 8;
    const float* af = a + (r0 + g) * LD + tq;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const float s = kScale ? scale : 1.f;
      uint32_t a_hi[4], a_lo[4];
      split_tf32(af[kk * 8] * s, a_hi[0], a_lo[0]);
      split_tf32(af[8 * LD + kk * 8] * s, a_hi[1], a_lo[1]);
      split_tf32(af[kk * 8 + 4] * s, a_hi[2], a_lo[2]);
      split_tf32(af[8 * LD + kk * 8 + 4] * s, a_hi[3], a_lo[3]);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt * 8 >= n) continue;
        const float* bf = b + (nt * 8 + g) * LD + kk * 8 + tq;
        uint32_t fb[4];
        split_tf32(bf[0], fb[0], fb[2]);
        split_tf32(bf[4], fb[1], fb[3]);
        mma_split(c[nt], a_hi, a_lo, fb);
      }
    }
  }
}

// S (the accumulators of strip rows r0 ..) to P in place, as the forward:
// + bias (+ mask) in float32, keys >= n to -inf, e = exp(S - row max),
// P = e * (the correctly rounded 1 / sum e).  s[nt][2*half + e] is row
// r0 + g + 8*half, column nt*8 + 2*tq + e.
__device__ __forceinline__ void strip_softmax(float (&s)[8][4],
                                              const float* bias,
                                              const float* mask, int ldb,
                                              int n, int r0, int lane) {
  const int g = lane >> 2, tq = lane & 3;
  float row_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int j = nt * 8 + 2 * tq;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = r0 + g + 8 * half;
      float x0 = s[nt][2 * half], x1 = s[nt][2 * half + 1];
      if (i < n && j < n) {
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
  const float inv[2] = {__frcp_rn(row_sum[0]), __frcp_rn(row_sum[1])};
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) s[nt][r] *= inv[r >> 1];
}

// Phase 1 of warp `warp`'s strip of query rows r0 = 16*warp ..: P and dS
// into the tiles p_s and ds_s (rows of the strip, the key columns below
// rows_padded(n); in bf16 their hi parts, the lo parts in the tiles
// `lo` elements further), dQ = dS . k (not yet scaled) into dq, dS added
// to acc.  The strip lies below n.
template <int DP, class T>
__device__ __forceinline__ void grad_queries(
    const T* q, const T* k, const T* v, const T* g, T* p_s, T* ds_s,
    const float* bias, const float* mask, int ldb, int n, float scale_t,
    int r0, int lane, int lo, float (&dq)[DP / 8][4], float (&acc)[8][4]) {
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  constexpr int LD = DP + vec_elems<T>();
  const int gr = lane >> 2, tq = lane & 3;
  const int key_tiles = rows_padded(n) / 8;  // n-tiles phase 2 reads

  float p[8][4], ds[8][4];
  strip_abt<DP, true>(q, k, r0, n, scale_t, lane, p);
  strip_softmax(p, bias, mask, ldb, n, r0, lane);
  strip_abt<DP, false>(g, v, r0, n, 1.f, lane, ds);  // dP

  // dS = P o (dP - rowsum(dP o P)); keys >= n have P = 0 and dP = 0
  float dot[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) dot[r >> 1] += ds[nt][r] * p[nt][r];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    dot[half] += __shfl_xor_sync(0xffffffffu, dot[half], 1);
    dot[half] += __shfl_xor_sync(0xffffffffu, dot[half], 2);
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      ds[nt][r] = p[nt][r] * (ds[nt][r] - dot[r >> 1]);
      acc[nt][r] += ds[nt][r];
    }

#pragma unroll
  for (int nt = 0; nt < DP / 8; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) dq[nt][r] = 0.f;
  if constexpr (kBf16) {
    // P and dS split into bf16 hi and lo: the A fragments of k-step kk
    // (keys 16kk .. 16kk + 15) are n-tiles 2kk and 2kk + 1, and the same
    // packed pairs go into the tiles
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t da_hi[4], da_lo[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int nt = 2 * kk + e;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          uint32_t p_hi, p_lo;
          split_bf16(p[nt][2 * half], p[nt][2 * half + 1], p_hi, p_lo);
          split_bf16(ds[nt][2 * half], ds[nt][2 * half + 1],
                     da_hi[2 * e + half], da_lo[2 * e + half]);
          if (nt >= key_tiles) continue;
          const int at = (r0 + gr + 8 * half) * kProbLd + nt * 8 + 2 * tq;
          *reinterpret_cast<uint32_t*>(p_s + at) = p_hi;
          *reinterpret_cast<uint32_t*>(p_s + lo + at) = p_lo;
          *reinterpret_cast<uint32_t*>(ds_s + at) = da_hi[2 * e + half];
          *reinterpret_cast<uint32_t*>(ds_s + lo + at) = da_lo[2 * e + half];
        }
      }
      // dQ += dS . k over these keys: one x4 ldmatrix.trans of k gives two
      // n-tiles of 8 columns (the forward's P . v), lo first
      if (kk * 16 >= n) continue;
#pragma unroll
      for (int dp = 0; dp < DP / 16; ++dp) {
        const int key = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        uint32_t b[4];
        ldsm_x4_trans(b, k + key * LD + dp * 16 + (lane >> 4) * 8);
        mma(dq[2 * dp], da_lo, b[0], b[1]);
        mma(dq[2 * dp + 1], da_lo, b[2], b[3]);
        mma(dq[2 * dp], da_hi, b[0], b[1]);
        mma(dq[2 * dp + 1], da_hi, b[2], b[3]);
      }
    }
  } else {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (nt >= key_tiles) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int at = (r0 + gr + 8 * half) * kProbLd + nt * 8 + 2 * tq;
        *reinterpret_cast<float2*>(p_s + at) =
            make_float2(p[nt][2 * half], p[nt][2 * half + 1]);
        *reinterpret_cast<float2*>(ds_s + at) =
            make_float2(ds[nt][2 * half], ds[nt][2 * half + 1]);
      }
    }
    // dQ = dS . k: k-step kk is n-tile kk of dS, its accumulator read as
    // the A fragment (a0..a3 = c0, c2, c1, c3: keys kk*8 + 2tq and + 1),
    // split, against k's rows kk*8 + 2tq and + 1 (the forward's P . v)
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      if (kk * 8 >= n) continue;
      uint32_t a_hi[4], a_lo[4];
      split_tf32(ds[kk][0], a_hi[0], a_lo[0]);
      split_tf32(ds[kk][2], a_hi[1], a_lo[1]);
      split_tf32(ds[kk][1], a_hi[2], a_lo[2]);
      split_tf32(ds[kk][3], a_hi[3], a_lo[3]);
      const float* kf = k + (kk * 8 + 2 * tq) * LD + gr;
#pragma unroll
      for (int nt = 0; nt < DP / 8; ++nt) {
        uint32_t b[4];
        split_tf32(kf[nt * 8], b[0], b[2]);
        split_tf32(kf[LD + nt * 8], b[1], b[3]);
        mma_split(dq[nt], a_hi, a_lo, b);
      }
    }
  }
}

// c = x^T . y for key rows j0 .. j0 + 15: x is the (query, key) tile p_s
// or ds_s (stride kProbLd; in bf16 its hi part, the lo part `lo` elements
// further), y the (query, DP) tile g or q; the sum runs over the query
// rows below n.  bf16: A fragments of x^T by ldmatrix.trans of x, lo.y
// then hi.y, B fragments of y by ldmatrix.trans; float: 32-bit reads,
// split TF32.
template <int DP, class T>
__device__ __forceinline__ void strip_atb(const T* x, const T* y, int j0,
                                          int n, int lane, int lo,
                                          float (&c)[DP / 8][4]) {
  constexpr int LD = DP + vec_elems<T>();
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int nt = 0; nt < DP / 8; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) c[nt][r] = 0.f;
  if constexpr (std::is_same<T, bf16>::value) {
#pragma unroll
    for (int kq = 0; kq < 4; ++kq) {
      if (kq * 16 >= n) continue;
      // matrix lane >> 3: keys + ((lane >> 3) & 1) * 8, queries +
      // (lane >> 4) * 8; the rows of memory are queries
      const T* xa = x + (kq * 16 + ((lane >> 4) << 3) + (lane & 7)) *
                            kProbLd +
                        j0 + ((lane >> 3) & 1) * 8;
      uint32_t a_hi[4], a_lo[4];
      ldsm_x4_trans(a_hi, xa);
      ldsm_x4_trans(a_lo, xa + lo);
#pragma unroll
      for (int dp = 0; dp < DP / 16; ++dp) {
        const int query = kq * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        uint32_t b[4];
        ldsm_x4_trans(b, y + query * LD + dp * 16 + (lane >> 4) * 8);
        mma(c[2 * dp], a_lo, b[0], b[1]);
        mma(c[2 * dp + 1], a_lo, b[2], b[3]);
        mma(c[2 * dp], a_hi, b[0], b[1]);
        mma(c[2 * dp + 1], a_hi, b[2], b[3]);
      }
    }
  } else {
#pragma unroll
    for (int kq = 0; kq < 8; ++kq) {
      if (kq * 8 >= n) continue;
      // A (m16 x k8): a0..a3 = (key g, query t), (g + 8, t), (g, t + 4),
      // (g + 8, t + 4); B (k8 x n8): b0, b1 = (query t, column g), (t + 4,
      // g)
      const T* xf = x + (kq * 8 + tq) * kProbLd + j0 + g;
      uint32_t a_hi[4], a_lo[4];
      split_tf32(xf[0], a_hi[0], a_lo[0]);
      split_tf32(xf[8], a_hi[1], a_lo[1]);
      split_tf32(xf[4 * kProbLd], a_hi[2], a_lo[2]);
      split_tf32(xf[4 * kProbLd + 8], a_hi[3], a_lo[3]);
      const T* yf = y + (kq * 8 + tq) * LD + g;
#pragma unroll
      for (int nt = 0; nt < DP / 8; ++nt) {
        uint32_t b[4];
        split_tf32(yf[nt * 8], b[0], b[2]);
        split_tf32(yf[4 * LD + nt * 8], b[1], b[3]);
        mma_split(c[nt], a_hi, a_lo, b);
      }
    }
  }
}

// the accumulators c * s of rows r0 .. r0 + 15 (those below n) into the
// same rows of the (rows, DP + V) tile t, rounded to T
template <int DP, class T>
__device__ __forceinline__ void stage(T* t, const float (&c)[DP / 8][4],
                                      float s, int r0, int n, int lane) {
  constexpr int LD = DP + vec_elems<T>();
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int nt = 0; nt < DP / 8; ++nt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = r0 + g + 8 * half;
      if (i >= n) continue;
      const float x0 = c[nt][2 * half] * s, x1 = c[nt][2 * half + 1] * s;
      if constexpr (std::is_same<T, bf16>::value)
        *reinterpret_cast<uint32_t*>(t + i * LD + nt * 8 + 2 * tq) =
            pack_bf16(x0, x1);
      else
        *reinterpret_cast<float2*>(t + i * LD + nt * 8 + 2 * tq) =
            make_float2(x0, x1);
    }
}

// A block's walk over its `count` pairs.  `at` is the kernel's addressing:
// at.q, at.k, at.v, at.g and at.dq, at.dk, at.dv; at.src(t) and
// at.src_token(i) place pair t's token i in q, k, v, dq, dk and dv,
// at.dst(t) and at.dst_token(i) in g.  bias and mask (or null) point at
// the group's (n, n) float tables, `smem` holds grad_smem_bytes.  partial
// (or null: neither dbias nor dmask is asked for) is this block's (n, n)
// float32 tile of the summed dS.  vec: 16-byte loads and stores (d a
// multiple of the 16-byte width, every operand 16-byte aligned), else one
// element at a time.
template <int DP, class At>
__device__ __forceinline__ void grad_pairs(const At& at, unsigned char* smem,
                                           const float* bias,
                                           const float* mask, float* partial,
                                           int n, int d, int count,
                                           float scale, bool vec) {
  using T = typename At::Elem;
  constexpr int V = vec_elems<T>();
  constexpr int LD = DP + V;
  constexpr int CPR = DP / V;  // 16-byte chunks of a padded row
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = warp * 16;  // the warp's strip: query rows, then key rows
  const int ldb = table_stride(n);
  const int te = rows_padded(n) * LD;  // elements of a tile
  const int pe = 4 * te;               // of a pair buffer: q, k, v, g
  const int pt = rows_padded(n) * kProbLd;  // elements of a P or dS tile
  T* buf = reinterpret_cast<T*>(smem);
  T* p_s = buf + 2 * pe;  // then dS, then (bf16) the lo tiles of both
  T* ds_s = p_s + pt;
  float* bias_s = reinterpret_cast<float*>(p_s + prob_tiles<T>() * pt);
  float* mask_s = mask == nullptr ? nullptr : bias_s + n * ldb;
  // S multiplies q by the scale rounded to bf16 in bf16, as the forward;
  // dq and dk are scaled in float32
  const float scale_t = std::is_same<T, bf16>::value
                            ? __bfloat162float(__float2bfloat16(scale))
                            : scale;

  zero_tiles(buf, 2 * pe + prob_tiles<T>() * pt, tid);
  load_table(bias_s, bias, n, ldb, warp, lane);
  if (mask_s != nullptr) load_table(mask_s, mask, n, ldb, warp, lane);
  __syncthreads();  // the zeros land before any copy into the buffers

  auto load = [&](int t, T* to) {
    const size_t pair = at.src(t), gpair = at.dst(t);
    if (vec) {
      for (int idx = tid; idx < n * CPR; idx += kThreads) {
        const int i = idx / CPR, c = idx - i * CPR;
        if (c * V >= d) continue;
        const size_t src = pair + at.src_token(i) + c * V;
        T* dst = to + i * LD + c * V;
        cp_async16(dst, at.q + src);
        cp_async16(dst + te, at.k + src);
        cp_async16(dst + 2 * te, at.v + src);
        cp_async16(dst + 3 * te, at.g + gpair + at.dst_token(i) + c * V);
      }
    } else {
      for (int idx = tid; idx < n * DP; idx += kThreads) {
        const int i = idx / DP, c = idx - i * DP;
        if (c >= d) continue;
        const size_t src = pair + at.src_token(i) + c;
        T* dst = to + i * LD + c;
        dst[0] = at.q[src];
        dst[te] = at.k[src];
        dst[2 * te] = at.v[src];
        dst[3 * te] = at.g[gpair + at.dst_token(i) + c];
      }
    }
  };
  // the warp's rows r0 .. r0 + rows - 1 of dq, dk and dv, staged in the
  // q, k and v tiles of `from`
  auto store = [&](int t, const T* from, int rows) {
    const size_t pair = at.src(t);
    if (vec) {
      for (int idx = lane; idx < rows * CPR; idx += 32) {
        const int i = r0 + idx / CPR, c = idx % CPR;
        if (c * V >= d) continue;
        const size_t off = pair + at.src_token(i) + c * V;
        const T* row = from + i * LD + c * V;
        *reinterpret_cast<uint4*>(at.dq + off) =
            *reinterpret_cast<const uint4*>(row);
        *reinterpret_cast<uint4*>(at.dk + off) =
            *reinterpret_cast<const uint4*>(row + te);
        *reinterpret_cast<uint4*>(at.dv + off) =
            *reinterpret_cast<const uint4*>(row + 2 * te);
      }
    } else {
      for (int idx = lane; idx < rows * DP; idx += 32) {
        const int i = r0 + idx / DP, c = idx % DP;
        if (c >= d) continue;
        const size_t off = pair + at.src_token(i) + c;
        const T* row = from + i * LD + c;
        at.dq[off] = row[0];
        at.dk[off] = row[te];
        at.dv[off] = row[2 * te];
      }
    }
  };

  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[nt][r] = 0.f;
  const bool active = r0 < n;
  const int rows = active ? min(16, n - r0) : 0;

  load(0, buf);
  cp_async_commit();
  for (int t = 0; t < count; ++t) {
    T* cur = buf + (t & 1) * pe;
    T *q = cur, *k = cur + te, *v = cur + 2 * te, *g = cur + 3 * te;
    if (t + 1 < count) load(t + 1, buf + ((t + 1) & 1) * pe);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    float dq[DP / 8][4];
    if (active)
      grad_queries<DP, T>(q, k, v, g, p_s, ds_s, bias_s, mask_s, ldb, n,
                          scale_t, r0, lane, 2 * pt, dq, acc);
    __syncthreads();  // P and dS whole; k and v read for the last time
    if (active) {
      float c[DP / 8][4];
      strip_atb<DP, T>(p_s, g, r0, n, lane, 2 * pt, c);  // dV = P^T . g
      stage<DP, T>(v, c, 1.f, r0, n, lane);
      strip_atb<DP, T>(ds_s, q, r0, n, lane, 2 * pt, c);  // dK = dS^T . q
      stage<DP, T>(k, c, scale, r0, n, lane);
    }
    __syncthreads();  // q read for the last time
    if (active) {
      stage<DP, T>(q, dq, scale, r0, n, lane);
      __syncwarp();
      store(t, cur, rows);
    }
    __syncthreads();  // the buffer is free for pair t + 2
  }

  if (partial != nullptr && active) {
    const int g = lane >> 2, tq = lane & 3;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = r0 + g + 8 * half, j = nt * 8 + 2 * tq + e;
          if (i < n && j < n) partial[i * n + j] = acc[nt][2 * half + e];
        }
  }
}

// dbias[h] = the sum of the partials of head h's blocks, dmask[w] = that
// of window w's, in a fixed order (chunks, then windows or heads).  The
// partial of block (chunk * n_w + w) * heads + h is the (n, n) tile at
// partial + that * nn.  dbias or dmask may be null.  static: each kernel
// library holds its own.
static __global__ void __launch_bounds__(256)
sum_partials(const float* __restrict__ partial, float* __restrict__ dbias,
             float* __restrict__ dmask, int heads, int n_w, int chunks,
             int nn) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const long long nb = dbias == nullptr ? 0 : static_cast<long long>(heads) * nn;
  if (e < nb) {
    const int h = static_cast<int>(e / nn), ij = static_cast<int>(e % nn);
    float s = 0.f;
    for (int c = 0; c < chunks; ++c)
      for (int w = 0; w < n_w; ++w)
        s += partial[((static_cast<long long>(c) * n_w + w) * heads + h) * nn +
                     ij];
    dbias[e] = s;
  } else if (dmask != nullptr &&
             e < nb + static_cast<long long>(n_w) * nn) {
    const long long f = e - nb;
    const int w = static_cast<int>(f / nn), ij = static_cast<int>(f % nn);
    float s = 0.f;
    for (int c = 0; c < chunks; ++c)
      for (int h = 0; h < heads; ++h)
        s += partial[((static_cast<long long>(c) * n_w + w) * heads + h) * nn +
                     ij];
    dmask[f] = s;
  }
}

// The number of blocks (and so of partial tiles) a backward launch of
// `kernel` takes for `groups` groups of `images` pairs: tile::plan's grid.
inline long long grad_blocks(const void* kernel, size_t smem,
                             long long groups, int images) {
  int per = 0;
  long long blocks = 0;
  const cudaError_t err = plan(kernel, smem, groups, images, &per, &blocks);
  return err == cudaSuccess ? blocks : -static_cast<long long>(err);
}

// Launch the backward `kernel` for `groups` groups (heads fastest) of
// `images` pairs on `stream` as kernel(args..., partial, per), then, if
// partial is not null, sum_partials into dbias and dmask (either may be
// null).  partial must hold `tiles` tiles of n * n floats, at least
// grad_blocks of them.  Returns cudaGetLastError() after the launches, or
// the error that refused one.
template <class... Params, class... Args>
inline int grad_launch(void (*kernel)(Params...), size_t smem,
                       long long groups, int heads, int images, int n,
                       float* partial, long long tiles, float* dbias,
                       float* dmask, void* stream, Args... args) {
  int per = 0;
  long long blocks = 0;
  cudaError_t err = plan(reinterpret_cast<const void*>(kernel), smem, groups,
                         images, &per, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (partial != nullptr && blocks > tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(args...,
                                                               partial, per);
  err = cudaGetLastError();
  if (err != cudaSuccess || partial == nullptr) return static_cast<int>(err);
  const int n_w = static_cast<int>(groups / heads);
  const long long outputs =
      (dbias == nullptr ? 0 : static_cast<long long>(heads) * n * n) +
      (dmask == nullptr ? 0 : static_cast<long long>(n_w) * n * n);
  if (outputs == 0) return cudaSuccess;
  sum_partials<<<static_cast<unsigned>((outputs + 255) / 256), 256, 0, s>>>(
      partial, dbias, dmask, heads, n_w, static_cast<int>(blocks / groups),
      n * n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tile
