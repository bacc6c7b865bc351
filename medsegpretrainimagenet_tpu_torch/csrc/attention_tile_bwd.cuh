// Tensor-core attention backward for one (window, head) pair, shared by the
// kernels of window_attention_bwd.cu (K1's backward) and
// image_attention_bwd.cu (K2's), in bf16 and in float32.  As in the
// forward's attention_tile.cuh, the two kernels differ only in where a
// pair's operands lie: each hands grad_pairs (grad_pairs_f32 in float32)
// an addressing functor, and this header does the rest (the buffers, the
// pipeline over a block's pairs, the dS partials and their sum).
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
// about 28 FLOP per byte in bf16, far under the card's ridges.  So both
// instances make one pass over those bytes and keep everything else on the
// chip; the bf16 one (grad_pairs) so:
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
//   warps, so they read P and dS from those tiles with ldmatrix.trans
//   (the tiles stored as [query][key] are the A operand's transpose);
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
// float32: the forward's split TF32, each operand x as hi = tf32(x) and lo
// = tf32(x - hi), each product lo.hi + hi.lo + hi.hi: within a few float32
// rounding steps of the plain version (one TF32 pass misses the float32
// bars, as for the forward).  Its own body, grad_pairs_f32 below, is laid
// out for the H100 (the float32 section at the end of this file).
//
// Padding.  In the q, k, v and g tiles, rows >= n and columns >= d hold
// zeros, as in the forward.  A padded query row has S = 0 on the keys
// < n, so P is uniform there, not zero; its g row is zero, so its dP and
// dS are zero and its P meets a zero row of g in dV: it adds nothing to
// dV, dK or the dS sum.  Keys >= n have S = -inf and P = 0.  The staged
// outputs are zero in the columns >= d (they sum products with zero
// columns), so the tiles stay zero there.
//
// bf16 shared memory (elements of T unless said): two pair buffers of
// four (rows_padded(n), DP + V) tiles, the P and dS tiles (rows_padded(n),
// 72) as a hi and a lo tile of each, the bias and mask tables ((n, ldb)
// floats).  At N = 49, D = 32 a masked block takes 99.8 KB (two fit on an
// SM).  Banks: the P and dS tiles' stride of 72 elements puts the strips'
// 32-bit stores and the ldmatrix.trans rows of phase 2 in distinct banks.
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

template <int DP>
__host__ __device__ inline size_t grad_smem_bytes_f32(int n);

// bytes of shared memory: in bf16 two pair buffers, the P and dS tiles,
// the bias (and mask) table; float32: grad_smem_bytes_f32
template <class T, int DP>
__host__ __device__ inline size_t grad_smem_bytes(int n, bool masked) {
  if constexpr (std::is_same<T, float>::value) return grad_smem_bytes_f32<DP>(n);
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
// past n stay 0.  bf16 only: a * scale rounded to bf16 (kScale) from
// ldmatrix fragments, as the forward's S.
template <int DP, bool kScale, class T>
__device__ __forceinline__ void strip_abt(const T* a, const T* b, int r0,
                                          int n, float scale, int lane,
                                          float (&c)[8][4]) {
  static_assert(std::is_same<T, bf16>::value, "the bf16 body");
  constexpr int LD = DP + vec_elems<T>();
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) c[nt][r] = 0.f;
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

// Phase 1 (bf16) of warp `warp`'s strip of query rows r0 = 16*warp ..: P
// and dS into the tiles p_s and ds_s (rows of the strip, the key columns
// below rows_padded(n); their hi parts, the lo parts in the tiles `lo`
// elements further), dQ = dS . k (not yet scaled) into dq, dS added
// to acc.  The strip lies below n.
template <int DP, class T>
__device__ __forceinline__ void grad_queries(
    const T* q, const T* k, const T* v, const T* g, T* p_s, T* ds_s,
    const float* bias, const float* mask, int ldb, int n, float scale_t,
    int r0, int lane, int lo, float (&dq)[DP / 8][4], float (&acc)[8][4]) {
  static_assert(std::is_same<T, bf16>::value, "the bf16 body");
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
}

// c = x^T . y for key rows j0 .. j0 + 15: x is the (query, key) tile p_s
// or ds_s (stride kProbLd; its hi part, the lo part `lo` elements
// further), y the (query, DP) tile g or q; the sum runs over the query
// rows below n.  bf16 only: A fragments of x^T by ldmatrix.trans of x,
// lo.y then hi.y, B fragments of y by ldmatrix.trans.
template <int DP, class T>
__device__ __forceinline__ void strip_atb(const T* x, const T* y, int j0,
                                          int n, int lane, int lo,
                                          float (&c)[DP / 8][4]) {
  static_assert(std::is_same<T, bf16>::value, "the bf16 body");
  constexpr int LD = DP + vec_elems<T>();
#pragma unroll
  for (int nt = 0; nt < DP / 8; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) c[nt][r] = 0.f;
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
}

// the accumulators c * s of rows r0 .. r0 + 15 (those below n) into the
// same rows of the (rows, DP + V) bf16 tile t, rounded to bf16
template <int DP, class T>
__device__ __forceinline__ void stage(T* t, const float (&c)[DP / 8][4],
                                      float s, int r0, int n, int lane) {
  static_assert(std::is_same<T, bf16>::value, "the bf16 body");
  constexpr int LD = DP + vec_elems<T>();
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int nt = 0; nt < DP / 8; ++nt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = r0 + g + 8 * half;
      if (i >= n) continue;
      const float x0 = c[nt][2 * half] * s, x1 = c[nt][2 * half + 1] * s;
      *reinterpret_cast<uint32_t*>(t + i * LD + nt * 8 + 2 * tq) =
          pack_bf16(x0, x1);
    }
}

// A block's walk over its `count` pairs in bf16 (float32:
// grad_pairs_f32).  `at` is the kernel's addressing:
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
  static_assert(std::is_same<T, bf16>::value, "the bf16 body");
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

// ---------------------------------------------------------------------------
// float32: split TF32 through the warpgroup's tensor cores
// ---------------------------------------------------------------------------
//
// One block of four warps, one warpgroup, takes a pair at a time, as in
// bf16; what the float32 instance does otherwise:
// - Each operand is split once per pair.  When a pair lands, every thread
//   splits the 16-byte chunks it loaded (ld.global, 16 bytes a thread; a
//   warp takes four rows of eight chunks, whole 128-byte lines of 32
//   floats) into TF32 hi and lo tiles of k, v, g and q (and keeps q
//   itself, for S's q * scale); the products read those tiles and split
//   nothing of them again.  P is split once, where phase 2 reads it; dS
//   once in each product that takes it (dQ from the registers, dK from
//   shared memory): hi and lo tiles of dS would cost 12.5 KB at N = 49 and
//   the second block an SM.  The split is integer arithmetic
//   (split_tf32_bits): cvt.rna.tf32.f32 takes four instructions on
//   sm_90a, and a pair splits about 160 values a thread.
// - S = (q * scale) . k^T and dP = g . v^T run on wgmma.mma_async
//   m64n64k8 TF32: the warpgroup's 64 query rows are a whole pair, and
//   each warp gets the 16-row strip of the accumulators that mma.sync gave
//   it (the same register layout, so the softmax and dS code is the
//   bf16 one's).  S takes q * scale split in registers (A: each warp its
//   own rows), dP the g tiles (A) and both take k or v (B) from shared
//   memory; the three products lo.hi, hi.lo, hi.hi of a k-step are three
//   instructions, and S's twelve and dP's twelve are in flight together
//   (the softmax of S runs while dP's finish).
// - dQ = dS . k, dV = P^T . g and dK = dS^T . q stay on mma.sync
//   m16n8k8: TF32 wgmma takes its operands K-major only (a transpose from
//   shared memory is for 16-bit types), and these three need k, g and q
//   K-major along the tokens.  dV and dK on wgmma, from g and q tiles
//   stored transposed when a pair lands and A split in registers, were
//   built and measured slower (their A registers, rewritten each k-step,
//   hold each step's six wgmma back), and k^T for dQ would cost the 17 KB
//   that keep a second block on the SM.  They read the pre-split k, g and
//   q with 32-bit loads, and issue their three terms n-tile by n-tile
//   (mma_split_tiles: consecutive mma's add into different accumulators);
//   dV and dK take turns in one walk over the queries.
// - Two blocks fit on an SM at N = 49, D = 32 (eight warps, two per
//   scheduler), so one block's loads, barriers and softmax hide behind the
//   other's products: 112,608 bytes a block, with one pair buffer (the
//   second block hides the copies), the bias and the mask summed into one
//   table when a block loads them (its (window, head) is fixed), and the P
//   and dS tiles at the 56-float stride the 49 keys need.
// - Three barriers a pair (the pair landed; P and dS whole; the outputs
//   stored).  The next pair's loads go out (DP <= 32) when phase 2
//   starts and land after its barrier.
//
// The summed table moves S's rounding: S + (bias + mask) where the JAX
// package takes (S + bias) + mask.  Under Swin's shift mask (0 or -100)
// the two differ only where the mask is -100 and P is e^-100 of the row's
// largest: nothing reaches a gradient.
//
// Tiles (floats): q, k, v, g as wgmma's K-major core-matrix layout without
// swizzle, 4-float chunks of a row: element (row, col) of a tile of R rows
// at ((col / 4) * R + row) * 4 + col % 4 (eight rows of a chunk are one
// 128-byte core matrix; core matrices lie 128 bytes apart along the rows
// and R * 16 bytes along K).  The row counts set the banks:
// - k: kKeyRows = 65, the 64 keys of an n64 B operand and an odd stride,
//   so dQ's B reads (keys 2t and 2t + 1, column g) fall in 32 distinct
//   banks (a quarter warp's 16-byte stores meet 2-way conflicts);
// - v, g and q: kGradRows = 68, 64 rows (an n64 B or m64 A operand) and R
//   = 4 modulo 8, so phase 2's B reads (query t, column g) and a quarter
//   warp's 16-byte stores (four rows of two chunks) fall in distinct
//   banks; q itself r8 + 4 rows for the same stores;
// - P and dS: [query][key], r8 rows of ldp = r8 | 8 floats (8 or 24
//   modulo 32: phase 2's A reads (query t, key g) and phase 1's float2
//   stores in distinct banks); keys past ldp read the next row, which only
//   key rows past n take;
// - the summed table, (n, ldb).
// Outside rows < n and columns < d every tile holds zeros, as in bf16;
// the tiles' 64 rows make the wgmma operands whole.  dq, dk and dv are
// staged in the q, v and k tiles after their last read, and leave with
// 16-byte stores.

// rows of the k tiles, and of the v, g and q tiles
constexpr int kKeyRows = 65;
constexpr int kGradRows = 68;

// the float32 tiles' row counts for n tokens
struct F32Rows {
  int r8;   // n rounded up to the 8 rows of a TF32 k-step
  int rq;   // rows of q: r8 + 4
  int ldp;  // row stride of the P and dS tiles
  __host__ __device__ explicit F32Rows(int n)
      : r8((n + 7) / 8 * 8), rq((n + 7) / 8 * 8 + 4),
        ldp((n + 7) / 8 * 8 | 8) {}
};

// bytes of shared memory of the float32 body: the k, v, g and q hi and lo
// tiles, q, the P and dS tiles, the summed table
template <int DP>
__host__ __device__ inline size_t grad_smem_bytes_f32(int n) {
  const F32Rows r(n);
  return sizeof(float) *
         (static_cast<size_t>(DP) *
              (2 * kKeyRows + 6 * kGradRows + r.rq) +
          2 * r.r8 * r.ldp + n * table_stride(n));
}

// element (row, col) of a core-matrix tile of `rows` rows
__device__ __forceinline__ int cm(int row, int col, int rows) {
  return ((col >> 2) * rows + row) * 4 + (col & 3);
}

// wgmma's shared-memory descriptor of the K-major operand whose k-step
// starts at p, in a core-matrix tile of `rows` rows: no swizzle, the
// leading (K) byte offset rows * 16, the stride (M or N) byte offset 128
__device__ __forceinline__ uint64_t wgmma_desc(const float* p, int rows) {
  return ((smem_addr(p) & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(rows) << 16) | (uint64_t{8} << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N of this warpgroup's committed groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// order the accumulators' uses after a wgmma_wait
__device__ __forceinline__ void wgmma_hold(float (&d)[8][4]) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+f"(d[nt][r])::"memory");
}

// this thread's shared-memory writes seen by the async proxy (wgmma)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d += a . b on m64n64k8 TF32: a this warp's 16 rows in registers (the
// mma.sync m16n8k8 A layout), b a descriptor; d[nt][r] is the mma.sync
// accumulator layout of n-tile nt
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += a . b on m64n64k8 TF32, both from descriptors
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(a), "l"(b), "r"(1));
}

// x = hi + lo as split_tf32 gives them, for finite x, in integer
// arithmetic: cvt.rna.tf32.f32 takes four instructions on sm_90a (a test
// for infinities and NaN among them), while half a TF32 unit added to the
// bit pattern and the 13 low bits cleared round the magnitude to nearest,
// ties away from zero, in two (the CPU model's tf32_round).  A NaN stays a
// NaN or becomes an infinity, and the gradients show either.
__device__ __forceinline__ void split_tf32_bits(float x, uint32_t& hi,
                                                uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xFFFFE000u;
}

// a float4 split into TF32 hi and lo, written at hi + at and lo + at
__device__ __forceinline__ void put_split(float* hi, float* lo, int at,
                                          float4 x) {
  uint4 h, l;
  split_tf32_bits(x.x, h.x, l.x);
  split_tf32_bits(x.y, h.y, l.y);
  split_tf32_bits(x.z, h.z, l.z);
  split_tf32_bits(x.w, h.w, l.w);
  *reinterpret_cast<uint4*>(hi + at) = h;
  *reinterpret_cast<uint4*>(lo + at) = l;
}

// c[x][nt] += a[x] . b[x][nt] over the n-tiles of one k-step in split
// TF32 for G products (b[x][nt] = {hi b0, hi b1, lo b0, lo b1}, as
// mma_split takes it): the term lo.hi for every n-tile, then hi.lo, then
// hi.hi, so that consecutive mma's add into different accumulators; each
// accumulator still adds mma_split's three terms in its order.
template <int G, int NT>
__device__ __forceinline__ void mma_split_tiles(float (&c)[G][NT][4],
                                                const uint32_t (&a_hi)[G][4],
                                                const uint32_t (&a_lo)[G][4],
                                                const uint32_t (&b)[G][NT][4]) {
#pragma unroll
  for (int x = 0; x < G; ++x)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      mma_tf32(c[x][nt], a_lo[x], b[x][nt][0], b[x][nt][1]);
#pragma unroll
  for (int x = 0; x < G; ++x)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      mma_tf32(c[x][nt], a_hi[x], b[x][nt][2], b[x][nt][3]);
#pragma unroll
  for (int x = 0; x < G; ++x)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      mma_tf32(c[x][nt], a_hi[x], b[x][nt][0], b[x][nt][1]);
}

// The float32 tiles of a block (floats; see above).
template <int DP>
struct F32Tiles {
  float *k_hi, *k_lo, *v_hi, *v_lo, *g_hi, *g_lo, *q_hi, *q_lo, *q, *p, *ds,
      *table;
  __device__ F32Tiles(unsigned char* smem, const F32Rows& r) {
    k_hi = reinterpret_cast<float*>(smem);
    k_lo = k_hi + kKeyRows * DP;
    v_hi = k_lo + kKeyRows * DP;
    v_lo = v_hi + kGradRows * DP;
    g_hi = v_lo + kGradRows * DP;
    g_lo = g_hi + kGradRows * DP;
    q_hi = g_lo + kGradRows * DP;
    q_lo = q_hi + kGradRows * DP;
    q = q_lo + kGradRows * DP;
    p = q + r.rq * DP;
    ds = p + r.r8 * r.ldp;
    table = ds + r.r8 * r.ldp;
  }
};

// Phase 1 (float32) of warp `warp`'s strip of query rows r0 = 16*warp ..:
// S and dP for the warpgroup's 64 rows (every warp issues the wgmma, also
// one whose strip lies past n), then for the strip: P, dS (added to acc)
// into the P and dS tiles (rows below r8, keys below r8), dQ = scale * dS
// . k staged in the strip's rows of the q tile.
template <int DP>
__device__ __forceinline__ void grad_queries_f32(const F32Tiles<DP>& t,
                                                 const F32Rows& r, int ldb,
                                                 int n, float scale, int r0,
                                                 int lane,
                                                 float (&acc)[8][4]) {
  constexpr int KS = DP / 8;  // k-steps of S and dP
  const int gr = lane >> 2, tq = lane & 3;

  // S's A fragments: q * scale in float32 (as the plain version), split;
  // a0..a3 = (row g, column t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
  uint32_t qa_hi[KS][4], qa_lo[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + gr + 8 * (e & 1), col = kk * 8 + tq + 4 * (e >> 1);
      const float x = row < r.r8 ? t.q[cm(row, col, r.rq)] * scale : 0.f;
      split_tf32_bits(x, qa_hi[kk][e], qa_lo[kk][e]);
    }
  float s[8][4], dp[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {  // S = (q * scale) . k^T
    const uint64_t hi = wgmma_desc(t.k_hi + 8 * kk * kKeyRows, kKeyRows);
    const uint64_t lo = wgmma_desc(t.k_lo + 8 * kk * kKeyRows, kKeyRows);
    wgmma_rs(s, qa_lo[kk], hi);
    wgmma_rs(s, qa_hi[kk], lo);
    wgmma_rs(s, qa_hi[kk], hi);
  }
  wgmma_commit();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {  // dP = g . v^T
    const uint64_t a_hi = wgmma_desc(t.g_hi + 8 * kk * kGradRows, kGradRows);
    const uint64_t a_lo = wgmma_desc(t.g_lo + 8 * kk * kGradRows, kGradRows);
    const uint64_t hi = wgmma_desc(t.v_hi + 8 * kk * kGradRows, kGradRows);
    const uint64_t lo = wgmma_desc(t.v_lo + 8 * kk * kGradRows, kGradRows);
    wgmma_ss(dp, a_lo, hi);
    wgmma_ss(dp, a_hi, lo);
    wgmma_ss(dp, a_hi, hi);
  }
  wgmma_commit();
  wgmma_wait<1>();
  wgmma_hold(s);
  strip_softmax(s, t.table, nullptr, ldb, n, r0, lane);  // P in s
  wgmma_wait<0>();
  wgmma_hold(dp);
  if (r0 >= n) return;

  // dS = P o (dP - rowsum(dP o P)) in dp; keys >= n have P = 0 and dP = 0
  float dot[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dot[e >> 1] += dp[nt][e] * s[nt][e];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    dot[half] += __shfl_xor_sync(0xffffffffu, dot[half], 1);
    dot[half] += __shfl_xor_sync(0xffffffffu, dot[half], 2);
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dp[nt][e] = s[nt][e] * (dp[nt][e] - dot[e >> 1]);
      acc[nt][e] += dp[nt][e];
    }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    if (nt * 8 >= r.r8) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r0 + gr + 8 * half;
      if (row >= r.r8) continue;
      const int at = row * r.ldp + nt * 8 + 2 * tq;
      *reinterpret_cast<float2*>(t.p + at) =
          make_float2(s[nt][2 * half], s[nt][2 * half + 1]);
      *reinterpret_cast<float2*>(t.ds + at) =
          make_float2(dp[nt][2 * half], dp[nt][2 * half + 1]);
    }
  }

  // dQ = dS . k: k-step kk is n-tile kk of dS, its accumulator read as the
  // A fragment (a0..a3 = c0, c2, c1, c3: keys kk*8 + 2tq and + 1), split,
  // against k's rows kk*8 + 2tq and + 1 (the forward's P . v)
  float dq[1][DP / 8][4];
#pragma unroll
  for (int nt = 0; nt < DP / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[0][nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    if (kk * 8 >= n) continue;
    uint32_t a_hi[1][4], a_lo[1][4], b[1][DP / 8][4];
    split_tf32_bits(dp[kk][0], a_hi[0][0], a_lo[0][0]);
    split_tf32_bits(dp[kk][2], a_hi[0][1], a_lo[0][1]);
    split_tf32_bits(dp[kk][1], a_hi[0][2], a_lo[0][2]);
    split_tf32_bits(dp[kk][3], a_hi[0][3], a_lo[0][3]);
    const int key = kk * 8 + 2 * tq;
#pragma unroll
    for (int nt = 0; nt < DP / 8; ++nt) {
      const int b0 = cm(key, nt * 8 + gr, kKeyRows), b1 = b0 + 4;
      b[0][nt][0] = __float_as_uint(t.k_hi[b0]);
      b[0][nt][1] = __float_as_uint(t.k_hi[b1]);
      b[0][nt][2] = __float_as_uint(t.k_lo[b0]);
      b[0][nt][3] = __float_as_uint(t.k_lo[b1]);
    }
    mma_split_tiles(dq, a_hi, a_lo, b);
  }
  // staged in the strip's rows of q, which only this warp has read
#pragma unroll
  for (int nt = 0; nt < DP / 8; ++nt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = r0 + gr + 8 * half;
      if (i < n)
        *reinterpret_cast<float2*>(t.q + cm(i, nt * 8 + 2 * tq, r.rq)) =
            make_float2(dq[0][nt][2 * half] * scale,
                        dq[0][nt][2 * half + 1] * scale);
    }
}

// Phase 2 (float32) for key rows j0 .. j0 + 15: c[0] = P^T . g (dV) and
// c[1] = dS^T . q (dK), in one walk over the query rows below r8, so that
// eight accumulators take turns.  P and dS (stride ldp) are split where
// they are read; g and q come from their hi and lo tiles.  A (m16 x k8):
// a0..a3 = (key g, query t), (g + 8, t), (g, t + 4), (g + 8, t + 4); B
// (k8 x n8): b0, b1 = (query t, column g), (t + 4, g).
template <int DP>
__device__ __forceinline__ void grad_keys_f32(const F32Tiles<DP>& t,
                                              const F32Rows& r, int j0,
                                              int lane,
                                              float (&c)[2][DP / 8][4]) {
  const int gr = lane >> 2, tq = lane & 3;
  const float* const x[2] = {t.p, t.ds};
  const float* const y_hi[2] = {t.g_hi, t.q_hi};
  const float* const y_lo[2] = {t.g_lo, t.q_lo};
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int nt = 0; nt < DP / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[s][nt][e] = 0.f;
#pragma unroll
  for (int kq = 0; kq < 8; ++kq) {
    if (kq * 8 >= r.r8) continue;
    uint32_t a_hi[2][4], a_lo[2][4], b[2][DP / 8][4];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const float* xf = x[s] + (kq * 8 + tq) * r.ldp + j0 + gr;
      split_tf32_bits(xf[0], a_hi[s][0], a_lo[s][0]);
      split_tf32_bits(xf[8], a_hi[s][1], a_lo[s][1]);
      split_tf32_bits(xf[4 * r.ldp], a_hi[s][2], a_lo[s][2]);
      split_tf32_bits(xf[4 * r.ldp + 8], a_hi[s][3], a_lo[s][3]);
#pragma unroll
      for (int nt = 0; nt < DP / 8; ++nt) {
        const int b0 = cm(kq * 8 + tq, nt * 8 + gr, kGradRows), b1 = b0 + 16;
        b[s][nt][0] = __float_as_uint(y_hi[s][b0]);
        b[s][nt][1] = __float_as_uint(y_hi[s][b1]);
        b[s][nt][2] = __float_as_uint(y_lo[s][b0]);
        b[s][nt][3] = __float_as_uint(y_lo[s][b1]);
      }
    }
    mma_split_tiles(c, a_hi, a_lo, b);
  }
}

// the accumulators c * s of rows j0 .. j0 + 15 (those below n) into the
// same rows of the core-matrix tile t of `rows` rows
template <int DP>
__device__ __forceinline__ void stage_f32(float* t, int rows,
                                          const float (&c)[DP / 8][4],
                                          float s, int j0, int n, int lane) {
  const int gr = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int nt = 0; nt < DP / 8; ++nt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = j0 + gr + 8 * half;
      if (i < n)
        *reinterpret_cast<float2*>(t + cm(i, nt * 8 + 2 * tq, rows)) =
            make_float2(c[nt][2 * half] * s, c[nt][2 * half + 1] * s);
    }
}

// A block's walk over its `count` pairs in float32: grad_pairs' contract
// (`smem` holds grad_smem_bytes_f32), with the float32 design above.
template <int DP, class At>
__device__ __forceinline__ void grad_pairs_f32(const At& at,
                                               unsigned char* smem,
                                               const float* bias,
                                               const float* mask,
                                               float* partial, int n, int d,
                                               int count, float scale,
                                               bool vec) {
  static_assert(std::is_same<typename At::Elem, float>::value,
                "the float32 body");
  constexpr int CH = DP / 4;    // 16-byte chunks of a row
  constexpr int SLOTS = CH / 2;  // of a tile's chunks, per thread
  // the next pair's loads go out while phase 2 runs (their registers are
  // free then) up to D 32; wider heads load them when the pair lands
  constexpr bool kEarly = DP <= 32;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = warp * 16;  // the warp's strip: query rows, then key rows
  const int ldb = table_stride(n);
  const F32Rows r(n);
  const F32Tiles<DP> t(smem, r);

  zero_tiles(t.k_hi, static_cast<int>(t.table - t.k_hi), tid);
  for (int idx = tid; idx < n * n; idx += kThreads) {
    const int i = idx / n;
    t.table[i * ldb + idx - i * n] =
        bias[idx] + (mask == nullptr ? 0.f : mask[idx]);
  }
  __syncthreads();  // the zeros and the table before any pair lands

  // slot s of this thread: chunk c of row i of every tile.  A warp takes
  // four rows of eight chunks (whole 128-byte lines of a row of 32
  // floats), the four lanes of a quad four rows of one chunk, so that a
  // quarter warp's 16-byte stores (rows stride R = 4 modulo 8) fall in
  // distinct banks.
  auto slot = [&](int s, int& i, int& c) {
    const int idx = s * kThreads + tid;
    const int quad = idx / (4 * CH), rem = idx - quad * 4 * CH;
    c = rem >> 2;
    i = quad * 4 + (rem & 3);
    return i < n && c * 4 < d;
  };
  float4 x[4][SLOTS];
  auto fetch = [&](int p) {
    const size_t pair = at.src(p), gpair = at.dst(p);
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      int i, c;
      if (!slot(s, i, c)) continue;
      const size_t src = pair + at.src_token(i) + c * 4;
      x[0][s] = __ldg(reinterpret_cast<const float4*>(at.q + src));
      x[1][s] = __ldg(reinterpret_cast<const float4*>(at.k + src));
      x[2][s] = __ldg(reinterpret_cast<const float4*>(at.v + src));
      x[3][s] = __ldg(reinterpret_cast<const float4*>(
          at.g + gpair + at.dst_token(i) + c * 4));
    }
  };
  auto land = [&](int p) {
    if (vec) {
      if (!kEarly) fetch(p);
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) {
        int i, c;
        if (!slot(s, i, c)) continue;
        *reinterpret_cast<float4*>(t.q + cm(i, c * 4, r.rq)) = x[0][s];
        put_split(t.q_hi, t.q_lo, cm(i, c * 4, kGradRows), x[0][s]);
        put_split(t.k_hi, t.k_lo, cm(i, c * 4, kKeyRows), x[1][s]);
        put_split(t.v_hi, t.v_lo, cm(i, c * 4, kGradRows), x[2][s]);
        put_split(t.g_hi, t.g_lo, cm(i, c * 4, kGradRows), x[3][s]);
      }
    } else {
      const size_t pair = at.src(p), gpair = at.dst(p);
      for (int idx = tid; idx < n * DP; idx += kThreads) {
        const int i = idx / DP, c = idx - i * DP;
        if (c >= d) continue;
        const size_t src = pair + at.src_token(i) + c;
        uint32_t hi, lo;
        t.q[cm(i, c, r.rq)] = at.q[src];
        split_tf32_bits(at.q[src], hi, lo);
        t.q_hi[cm(i, c, kGradRows)] = __uint_as_float(hi);
        t.q_lo[cm(i, c, kGradRows)] = __uint_as_float(lo);
        split_tf32_bits(at.k[src], hi, lo);
        t.k_hi[cm(i, c, kKeyRows)] = __uint_as_float(hi);
        t.k_lo[cm(i, c, kKeyRows)] = __uint_as_float(lo);
        split_tf32_bits(at.v[src], hi, lo);
        t.v_hi[cm(i, c, kGradRows)] = __uint_as_float(hi);
        t.v_lo[cm(i, c, kGradRows)] = __uint_as_float(lo);
        split_tf32_bits(at.g[gpair + at.dst_token(i) + c], hi, lo);
        t.g_hi[cm(i, c, kGradRows)] = __uint_as_float(hi);
        t.g_lo[cm(i, c, kGradRows)] = __uint_as_float(lo);
      }
    }
    fence_async_smem();
  };
  // the warp's rows r0 .. r0 + rows - 1 of dq, dk and dv, staged in the
  // q, v and k tiles; a warp stores four rows of eight chunks
  auto store = [&](int p, int rows) {
    const size_t pair = at.src(p);
    if (vec) {
#pragma unroll
      for (int s = 0; s < CH / 2; ++s) {
        const int idx = s * 32 + lane;
        const int quad = idx / (4 * CH), rem = idx - quad * 4 * CH;
        const int c = rem >> 2, rr = quad * 4 + (rem & 3);
        if (rr >= rows || c * 4 >= d) continue;
        const int i = r0 + rr;
        const size_t off = pair + at.src_token(i) + c * 4;
        *reinterpret_cast<float4*>(at.dq + off) =
            *reinterpret_cast<const float4*>(t.q + cm(i, c * 4, r.rq));
        *reinterpret_cast<float4*>(at.dk + off) =
            *reinterpret_cast<const float4*>(t.v_hi +
                                             cm(i, c * 4, kGradRows));
        *reinterpret_cast<float4*>(at.dv + off) =
            *reinterpret_cast<const float4*>(t.k_hi + cm(i, c * 4, kKeyRows));
      }
    } else {
      for (int idx = lane; idx < rows * DP; idx += 32) {
        const int i = r0 + idx / DP, c = idx % DP;
        if (c >= d) continue;
        const size_t off = pair + at.src_token(i) + c;
        at.dq[off] = t.q[cm(i, c, r.rq)];
        at.dk[off] = t.v_hi[cm(i, c, kGradRows)];
        at.dv[off] = t.k_hi[cm(i, c, kKeyRows)];
      }
    }
  };

  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  const bool active = r0 < n;
  const int rows = active ? min(16, n - r0) : 0;

  if (kEarly && vec && count > 0) fetch(0);
  for (int p = 0; p < count; ++p) {
    land(p);
    __syncthreads();  // the pair landed
    grad_queries_f32<DP>(t, r, ldb, n, scale, r0, lane, acc);
    __syncthreads();  // P and dS whole; k and v read for the last time
    if (kEarly && vec && p + 1 < count) fetch(p + 1);
    if (active) {
      float c[2][DP / 8][4];
      grad_keys_f32<DP>(t, r, r0, lane, c);
      stage_f32<DP>(t.k_hi, kKeyRows, c[0], 1.f, r0, n, lane);  // dV
      stage_f32<DP>(t.v_hi, kGradRows, c[1], scale, r0, n, lane);  // dK
      __syncwarp();
      store(p, rows);
    }
    __syncthreads();  // the outputs left; the tiles are free for the next
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

// The shared memory (bytes, into *smem_out) a block of the backward
// `kernel` takes and the blocks of it an SM holds at once (*blocks), as
// plan sizes the grid.  Returns 0 or the CUDA error.
inline int grad_residency(const void* kernel, size_t smem, int* smem_out,
                          int* blocks) {
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                        kThreads, smem);
  *smem_out = static_cast<int>(smem);
  return static_cast<int>(err);
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
