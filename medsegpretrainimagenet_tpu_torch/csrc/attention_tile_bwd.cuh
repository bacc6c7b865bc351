// Tensor-core attention backward for one (window, head) pair, shared by the
// kernels of window_attention_bwd.cu (K1's backward) and
// image_attention_bwd.cu (K2's), in bf16 and in float32.  As in the
// forward's attention_tile.cuh, the two kernels differ only in where a
// pair's operands lie: each hands grad_pairs_bf16 (grad_pairs_f32 in
// float32) an addressing functor, and this header does the rest (the
// tiles, the walk over a block's pairs, the dS partials and their sum).
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
// chip:
// - S and P are recomputed on the chip, each warp holding the 16 query
//   rows of its strip (a window's whole row fits it), as the forward
//   computes them: no logsumexp is saved, and the forward's operator is
//   unchanged;
// - phase 1, per warp and its strip of query rows: S, P, dP = g . v^T
//   and dS in registers (dP has S's accumulator layout, so the row sum
//   of dP o P is a quad shuffle), dQ = dS . k from the registers (dS's
//   accumulator layout is the A layout of the next product, as P's is in
//   the forward), and P and dS into tiles of shared memory;
// - phase 2, per warp and its strip of key rows: the transposed products
//   dV = P^T . g and dK = dS^T . q sum over the query rows of all four
//   warps, so they read P and dS from those tiles;
// - a block takes one (window mod nW, head) and walks its images (the
//   forward's grid, tile::plan), so its bias and mask load once, summed
//   into one table, and each thread keeps its strip's running sum of dS
//   in registers; at the end the block writes that sum as an (n, n)
//   float32 partial, and a second small launch (sum_partials) adds the
//   partials in a fixed order into dbias (H, N, N) and dmask (nW, N, N):
//   no float atomics, so the same inputs give bit-equal gradients run to
//   run.
//
// The summed table moves S's rounding: S + (bias + mask) where the JAX
// package takes (S + bias) + mask.  Under Swin's shift mask (0 or -100)
// the two differ only where the mask is -100 and P is e^-100 of the row's
// largest: nothing reaches a gradient.
//
// bf16 (grad_pairs_bf16, the last section of this file): float32
// accumulators on the warpgroup's wgmma.  q*scale is rounded to bf16 with
// the scale rounded first (the forward's S); q, k, v and g are bf16
// already, so every product of them is exact in float32.  P and dS are
// float32 (as in _fused_bwd, and the plain version
// window_attention_backward); they enter the products that take them (dV,
// dQ, dK) split into two bf16 operands, hi = bf16(x) and lo = bf16(x -
// hi), as lo.b + hi.b, so that they keep about 16 significant bits.  A
// single bf16 rounding of P and dS reads a mean |kernel - plain| of about
// 3e-4 on swin_unet_224's gradients, as much as a kernel that dropped its
// bias (3e-3 at most ten times more): the split brings it to about 5e-7,
// under the forward's bf16 mean bar of 1e-5, and the bf16 gradients are
// then within one bf16 rounding step of the plain version.
//
// float32 (grad_pairs_f32): the forward's split TF32, each operand x as
// hi = tf32(x) and lo = tf32(x - hi), each product lo.hi + hi.lo + hi.hi:
// within a few float32 rounding steps of the plain version (one TF32 pass
// misses the float32 bars, as for the forward).
//
// Padding.  In the q, k, v and g tiles, rows >= n and columns >= d hold
// zeros, as in the forward.  A padded query row has S = 0 on the keys
// < n, so P is uniform there, not zero; its g row is zero, so its dP and
// dS are zero and its P meets a zero row of g in dV: it adds nothing to
// dV, dK or the dS sum.  Keys >= n have S = -inf and P = 0.
#pragma once

#include <cuda.h>  // CUtensorMap: the maps are encoded through the runtime

#include "attention_tile.cuh"

namespace tile {

template <int DP>
__host__ __device__ inline size_t grad_smem_bytes_f32(int n);
template <int DP>
__host__ __device__ inline size_t grad_smem_bytes_bf16(int n);

// bytes of shared memory a block of the backward takes (grad_smem_bytes_f32
// or grad_smem_bytes_bf16; both hold one summed table, masked or not)
template <class T, int DP>
__host__ __device__ inline size_t grad_smem_bytes(int n, bool masked) {
  if constexpr (std::is_same<T, float>::value) return grad_smem_bytes_f32<DP>(n);
  return grad_smem_bytes_bf16<DP>(n);
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

// ---------------------------------------------------------------------------
// bf16: the five products on wgmma, the loads by TMA, three blocks an SM
// ---------------------------------------------------------------------------
//
// One block of four warps, one warpgroup, takes a pair at a time.  The
// warpgroup's m64 covers a whole pair (n <= 64), and each warp gets the
// 16-row strip of every accumulator that mma.sync gave it (the same
// register layout), so the softmax and dS code is the float32 body's.  A
// pair's five products are wgmma.mma_async m64nNk16 bf16, float32
// accumulators:
// - S = (q * scale) . k^T, N 64 keys: A q * scale rounded to bf16 in
//   registers (ldmatrix), B k, K-major;
// - dP = g . v^T, N 64: A g and B v from shared memory, K-major; S and dP
//   are in flight together, and the softmax of S runs while dP finishes;
// - dQ = dS . k, N = W (d padded to 16, 32 or 64): A dS hi and lo from the
//   registers (dS's accumulator layout is the register A layout), B k,
//   MN-major (k is [key][d]: N contiguous);
// - dV = P^T . g and dK = dS^T . q, M 64 keys, N = W, in flight together:
//   A the P and dS tiles, MN-major (they are [query][key]: M contiguous),
//   B g and q, MN-major.
// P and dS keep their hi + lo split, so each product that takes them is
// two wgmma, lo first.  Phase 1 writes P and dS (hi and lo) with stmatrix
// straight into the swizzled MN-major layout that phase 2's descriptors
// read; dQ is issued after those stores and waited for before the barrier
// that makes P and dS whole (held in flight through phase 2, its 32 A
// registers cost spills at three blocks an SM).
//
// Tiles.  q, k, v and g are 64 rows of W bf16, one swizzle span a row
// (32, 64 or 128 bytes: CU_TENSOR_MAP_SWIZZLE_32B, 64B, 128B, and the
// descriptors' layout of the same name), so that the TMA writes each tile
// as every descriptor reads it; the P and dS tiles (hi and lo) are 64 x 64
// bf16 in the 128-byte swizzle; then the summed table, 64 rows of
// kTableLd floats, and the mbarrier.  Every tile starts at a multiple of
// 1024 bytes (the swizzle's period), so the swizzle of an address is that
// of its offset in the tile.  At N = 49, D = 32 a block takes 67,592
// bytes (K2 196 more for its token offsets): three blocks (twelve warps)
// an SM, and the registers are held to 168 a thread for them.
//
// Loads.  One thread issues a pair's q, k, v and g as tensor-map copies
// (cp.async.bulk.tensor) into the tiles; they complete on the mbarrier,
// which every thread waits on.  The copies write W columns (the map's
// columns >= d are out of bounds, so zeros) of rows < n; rows >= n stay
// zero from one clear a block.  The next pair's copies go out as soon as
// every warp's products are done, while the warps store the outputs, and
// the other two blocks of the SM hide the rest: with two stages of these
// tiles (and the table of n rows: 76,528 bytes, still three blocks) a
// swin_224_train step's backward read 0.615 and 0.658 ms on K1 and K2
// against one stage's 0.590 and 0.639 (an H100 80GB HBM3 at 700 W,
// ops/kernel_ab.py; PERF.md).  The first pair's copies go out before the
// block sums its table.  Where the TMA cannot go (a row whose bytes are
// not a multiple of 16, an operand that is not 16-byte aligned: the host
// decides by shape and alignment, never by a failed launch) every thread
// copies elements into the same swizzled tiles.
//
// Outputs.  dq, dk and dv are staged, in bf16, in the warp's own 16 rows
// of the P and dS tiles (its strip: query rows for dq, key rows for dk
// and dv), which only this warp writes next, and leave with 16-byte
// stores (element stores where the TMA does not go).  Two barriers a pair:
// P and dS whole; every warp's products done.

// the width (bf16 columns) of the bf16 body's q, k, v and g tiles for d
// padded to DP: a power of two, so that a row is one swizzle span
__host__ __device__ constexpr int bf16_width(int dp) {
  return dp <= 16 ? 16 : dp <= 32 ? 32 : 64;
}

// rows of every bf16 tile: wgmma's m64
constexpr int kTileRows = 64;
// bytes of a P or dS tile: [query][key], 128-byte rows
constexpr int kProbBytes = kTileRows * kTileRows * 2;

// row stride (floats) of the bf16 body's summed table: 64 keys and 8 more
// (the float2 reads of a C fragment in distinct banks, as table_stride)
constexpr int kTableLd = 72;

// bytes of shared memory of the bf16 body: the q, k, v and g tiles, the P
// and dS tiles (hi and lo), the summed table (64 rows), the mbarrier
template <int DP>
__host__ __device__ inline size_t grad_smem_bytes_bf16(int n) {
  return 4 * kTileRows * 2 * bf16_width(DP) + 4 * kProbBytes +
         sizeof(float) * kTileRows * kTableLd + sizeof(uint64_t);
}

// byte offset of 16-byte chunk `chunk` of row `row` in a tile of RB-byte
// rows swizzled over RB bytes (RB 32, 64 or 128: the TMA's and wgmma's
// swizzle, the chunk index XOR address bits 7 .. up)
template <int RB>
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * RB + ((chunk ^ ((row * RB >> 7) & (RB / 16 - 1))) << 4);
}

// wgmma's descriptor of an operand at p in a tile of RB-byte rows swizzled
// over RB bytes: K-major (rows along M or N, K along a row: the k-step
// starts 32 bytes further a step) or MN-major (rows along K, M or N along
// a row, one swizzle span wide); in both the stride byte offset is the 8
// rows of a swizzle period, and the leading byte offset is not read (one
// span along K, or along M or N)
template <int RB>
__device__ __forceinline__ uint64_t desc_bf16(const void* p) {
  constexpr uint64_t layout = RB == 128 ? 1 : RB == 64 ? 2 : 3;
  return ((smem_addr(p) & 0x3FFFFu) >> 4) | (uint64_t{1} << 16) |
         (static_cast<uint64_t>(8 * RB >> 4) << 32) | (layout << 62);
}

// d = a . b + (add ? d : 0) on m64nNk16 bf16, a this warp's 16 rows in
// registers (the mma.sync m16n8k16 A layout), b a descriptor (TB:
// MN-major); d[nt][r] is the mma.sync accumulator layout of n-tile nt.  A
// chain's first product takes add = 0, so its accumulators need no
// zeros.
template <int N, int TB>
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[N / 8][4],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int add = 1) {
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(add),
          "n"(TB));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(add),
          "n"(TB));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(add),
          "n"(TB));
  }
}

// d = a . b + (add ? d : 0) on m64nNk16 bf16, both from descriptors (TA,
// TB: MN-major)
template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_bf16_ss(float (&d)[N / 8][4],
                                              uint64_t a, uint64_t b,
                                              int add = 1) {
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, %35, %36;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "l"(a), "l"(b), "r"(add), "n"(TA), "n"(TB));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15}, "
        "%16, %17, p, 1, 1, %19, %20;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
        : "l"(a), "l"(b), "r"(add), "n"(TA), "n"(TB));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p, 1, 1, %11, %12;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
        : "l"(a), "l"(b), "r"(add), "n"(TA), "n"(TB));
  }
}

// order the accumulators' uses after a wgmma_wait (wgmma_hold, any N)
template <int NT>
__device__ __forceinline__ void hold_acc(float (&d)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+f"(d[nt][r])::"memory");
}

__device__ __forceinline__ void stsm_x4(void* p, const uint32_t (&r)[4]) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::
          "r"(smem_addr(p)),
      "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
      : "memory");
}

// wait until every cp.async of this thread has landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive on bar and expect `bytes` of copies to complete on it
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// wait until bar's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// a box of the tensor map at `map` (a kernel parameter) at the
// coordinates c, into shared memory at dst, completing on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

// keep the registers of in-flight wgmma A operands live until here
template <int A>
__device__ __forceinline__ void hold_regs(uint32_t (&r)[A][4]) {
#pragma unroll
  for (int a = 0; a < A; ++a)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[a][e])::"memory");
}

template <int A, int B>
__device__ __forceinline__ void hold_regs(uint32_t (&r)[A][B][4]) {
#pragma unroll
  for (int a = 0; a < A; ++a)
#pragma unroll
    for (int b = 0; b < B; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[a][b][e])::"memory");
}

// The bf16 tiles of a block (bytes, see above)
template <int W>
struct Bf16Tiles {
  static constexpr int RB = 2 * W;  // bytes of a q, k, v or g row
  static constexpr int TILE = kTileRows * RB;
  unsigned char *q, *k, *v, *g, *p_hi, *p_lo, *ds_hi, *ds_lo;
  float* table;
  uint64_t* bar;
  __device__ explicit Bf16Tiles(unsigned char* smem) {
    q = smem;
    k = q + TILE;
    v = k + TILE;
    g = v + TILE;
    p_hi = g + TILE;
    p_lo = p_hi + kProbBytes;
    ds_hi = p_lo + kProbBytes;
    ds_lo = ds_hi + kProbBytes;
    table = reinterpret_cast<float*>(ds_lo + kProbBytes);
    bar = reinterpret_cast<uint64_t*>(table + kTileRows * kTableLd);
  }
};

// S (the accumulators of strip rows r0 ..) to P in place, the bf16 body's
// softmax: + the summed table (64 rows of kTableLd: -inf at keys >= n, 0
// on the rows >= n, so that nothing here tests a row or a key), e =
// 2^((S - row max) * log2 e) (exp2f: ex2.approx and a guard against
// denormals, about five instructions where expf takes ten; the CPU model
// follows it), P = e * (the correctly rounded 1 /
// sum e).  s[nt][2*half + e] is row r0 + g + 8*half, column nt*8 + 2*tq +
// e.
__device__ __forceinline__ void strip_softmax_bf16(float (&s)[8][4],
                                                   const float* table,
                                                   int r0, int lane) {
  const int g = lane >> 2, tq = lane & 3;
  float row_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float2 b = *reinterpret_cast<const float2*>(
          table + (r0 + g + 8 * half) * kTableLd + nt * 8 + 2 * tq);
      s[nt][2 * half] += b.x;
      s[nt][2 * half + 1] += b.y;
      row_max[half] = fmaxf(row_max[half],
                            fmaxf(s[nt][2 * half], s[nt][2 * half + 1]));
    }
  float row_sum[2] = {0.f, 0.f};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    row_max[half] = fmaxf(row_max[half],
                          __shfl_xor_sync(0xffffffffu, row_max[half], 1));
    row_max[half] = fmaxf(row_max[half],
                          __shfl_xor_sync(0xffffffffu, row_max[half], 2));
  }
  constexpr float kLog2e = 1.4426950408889634f;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      s[nt][r] = exp2f((s[nt][r] - row_max[r >> 1]) * kLog2e);
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

// Phase 1 (bf16) of the warp's strip of query rows r0 = 16*warp .. (every
// warp, also one whose strip lies past n: the wgmma take the warpgroup):
// S and dP, P and dS (added to acc), P and dS hi and lo into the strip's
// rows of their tiles; then dQ = dS . k (not yet scaled) into dq, issued
// and committed: the caller fences the tiles' stores and then waits for
// it.  da holds dQ's A fragments (dS hi and lo by k-step) until then.
template <int W>
__device__ __forceinline__ void grad_queries_bf16(
    const Bf16Tiles<W>& t, float scale_t, int r0, int lane,
    float (&dq)[W / 8][4], float (&acc)[8][4], uint32_t (&da)[4][2][4]) {
  constexpr int RB = Bf16Tiles<W>::RB;
  constexpr int KS = W / 16;  // k-steps of S and dP

  // S's A fragments: q * scale_t, rounded to bf16
  uint32_t qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    ldsm_x4(qa[kk], t.q + swz<RB>(r0 + (lane & 15), 2 * kk + (lane >> 4)));
#pragma unroll
    for (int r = 0; r < 4; ++r) qa[kk][r] = scale_bf16x2(qa[kk][r], scale_t);
  }
  float s[8][4], dp[8][4];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)  // S = (q * scale) . k^T
    wgmma_bf16_rs<64, 0>(s, qa[kk], desc_bf16<RB>(t.k + 32 * kk), kk > 0);
  wgmma_commit();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)  // dP = g . v^T
    wgmma_bf16_ss<64, 0, 0>(dp, desc_bf16<RB>(t.g + 32 * kk),
                            desc_bf16<RB>(t.v + 32 * kk), kk > 0);
  wgmma_commit();
  wgmma_wait<1>();
  hold_acc(s);
  hold_regs(qa);
  strip_softmax_bf16(s, t.table, r0, lane);  // P in s
  wgmma_wait<0>();
  hold_acc(dp);

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

  // P and dS split into bf16 hi and lo: the A fragments of k-step kk
  // (keys 16kk .. 16kk + 15) are n-tiles 2kk and 2kk + 1, and one
  // stmatrix x4 puts the same four registers (the strip's rows r0 .. r0 +
  // 15 of those keys) into a tile; lane l gives row l & 7 of matrix l >> 3
  const int row = r0 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t pa[2][4];
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int nt = 2 * kk + e;
        split_bf16(s[nt][2 * half], s[nt][2 * half + 1], pa[0][2 * e + half],
                   pa[1][2 * e + half]);
        split_bf16(dp[nt][2 * half], dp[nt][2 * half + 1],
                   da[kk][0][2 * e + half], da[kk][1][2 * e + half]);
      }
    const int at = swz<128>(row, 2 * kk + (lane >> 4));
    stsm_x4(t.p_hi + at, pa[0]);
    stsm_x4(t.p_lo + at, pa[1]);
    stsm_x4(t.ds_hi + at, da[kk][0]);
    stsm_x4(t.ds_lo + at, da[kk][1]);
  }

  // dQ = dS . k, lo then hi a k-step (keys >= n have dS = 0 and zero
  // rows of k; every k-step goes out, as a wgmma on a branch would
  // serialize them all)
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t b = desc_bf16<RB>(t.k + kk * 16 * RB);
    wgmma_bf16_rs<W, 1>(dq, da[kk][1], b, kk > 0);
    wgmma_bf16_rs<W, 1>(dq, da[kk][0], b);
  }
  wgmma_commit();
}

// Phase 2 (bf16): dV = P^T . g and dK = dS^T . q over the 64 query rows
// (a padded row has a zero row of g and of dS), each warp's accumulators
// its 16 key rows; issued, committed and waited for.
template <int W>
__device__ __forceinline__ void grad_keys_bf16(const Bf16Tiles<W>& t,
                                               float (&dv)[W / 8][4],
                                               float (&dk)[W / 8][4]) {
  constexpr int RB = Bf16Tiles<W>::RB;
  wgmma_fence();
#pragma unroll
  for (int kq = 0; kq < 4; ++kq) {
    const int a = kq * 16 * 128, b = kq * 16 * RB;
    wgmma_bf16_ss<W, 1, 1>(dv, desc_bf16<128>(t.p_lo + a),
                           desc_bf16<RB>(t.g + b), kq > 0);
    wgmma_bf16_ss<W, 1, 1>(dk, desc_bf16<128>(t.ds_lo + a),
                           desc_bf16<RB>(t.q + b), kq > 0);
    wgmma_bf16_ss<W, 1, 1>(dv, desc_bf16<128>(t.p_hi + a),
                           desc_bf16<RB>(t.g + b));
    wgmma_bf16_ss<W, 1, 1>(dk, desc_bf16<128>(t.ds_hi + a),
                           desc_bf16<RB>(t.q + b));
  }
  wgmma_commit();
  wgmma_wait<0>();
}

// the accumulators c * s of the strip's rows r0 .. r0 + 15 into the same
// rows of the 128-byte swizzled tile x, rounded to bf16
template <int W>
__device__ __forceinline__ void stage_bf16(unsigned char* x,
                                           const float (&c)[W / 8][4],
                                           float s, int r0, int lane) {
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int nt = 0; nt < W / 8; ++nt)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      *reinterpret_cast<uint32_t*>(x + swz<128>(r0 + g + 8 * half, nt) +
                                   4 * tq) =
          pack_bf16(c[nt][2 * half] * s, c[nt][2 * half + 1] * s);
}

// A block's walk over its `count` pairs in bf16.  `at` is the kernel's
// addressing: at.q, at.k, at.v, at.g and at.dq, at.dk, at.dv; at.src(t)
// and at.src_token(i) place pair t's token i in q, k, v, dq, dk and dv,
// at.dst(t) and at.dst_token(i) in g; at.issue(t, tiles) issues pair t's
// tensor-map copies.  bias and mask (or null) point at the group's (n, n)
// float tables, `smem` (1024-byte aligned) holds grad_smem_bytes_bf16.
// partial (or null: neither dbias nor dmask is asked for) is this block's
// (n, n) float32 tile of the summed dS.  tma: the loads by tensor map and
// 16-byte stores (d a multiple of 8, every operand 16-byte aligned), else
// element by element.
template <int DP, class At>
__device__ __forceinline__ void grad_pairs_bf16(const At& at,
                                                unsigned char* smem,
                                                const float* bias,
                                                const float* mask,
                                                float* partial, int n, int d,
                                                int count, float scale,
                                                bool tma) {
  static_assert(std::is_same<typename At::Elem, bf16>::value,
                "the bf16 body");
  constexpr int W = bf16_width(DP);
  constexpr int RB = Bf16Tiles<W>::RB;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = warp * 16;  // the warp's strip: query rows, then key rows
  const Bf16Tiles<W> tiles(smem);
  // S multiplies q by the scale rounded to bf16 in bf16, as the forward;
  // dq and dk are scaled in float32
  const float scale_t = __bfloat162float(__float2bfloat16(scale));

  // the group's bias and mask, n * n floats each, copied whole into the P
  // tiles (which the first pair writes later) by 4-byte cp.async, all in
  // flight at once
  float* raw = reinterpret_cast<float*>(tiles.p_hi);
  for (int idx = tid; idx < n * n; idx += kThreads) {
    cp_async4(raw + idx, bias + idx);
    if (mask != nullptr) cp_async4(raw + n * n + idx, mask + idx);
  }
  cp_async_commit();
  zero_tiles(reinterpret_cast<bf16*>(smem),
             static_cast<int>((tiles.p_hi - smem) / 2), tid);
  if (tid == 0) mbar_init(tiles.bar, 1);
  fence_async_smem();  // the zeros before any copy or product
  __syncthreads();

  // pair p into the tiles: by tensor map (thread 0), or every thread's
  // elements
  auto load = [&](int p) {
    if (tma) {
      if (tid == 0) {
        mbar_expect(tiles.bar, 4 * n * RB);
        at.issue(p, tiles);
      }
      return;
    }
    const size_t pair = at.src(p), gpair = at.dst(p);
    for (int idx = tid; idx < n * d; idx += kThreads) {
      const int i = idx / d, c = idx - i * d;
      const int to = swz<RB>(i, c >> 3) + 2 * (c & 7);
      const size_t src = pair + at.src_token(i) + c;
      *reinterpret_cast<bf16*>(tiles.q + to) = at.q[src];
      *reinterpret_cast<bf16*>(tiles.k + to) = at.k[src];
      *reinterpret_cast<bf16*>(tiles.v + to) = at.v[src];
      *reinterpret_cast<bf16*>(tiles.g + to) =
          at.g[gpair + at.dst_token(i) + c];
    }
    fence_async_smem();
  };
  // the strip's rows of dq (query rows), dk and dv (key rows), below n,
  // staged in the strip's rows of the P hi, P lo and dS hi tiles
  auto store = [&](int p) {
    const size_t pair = at.src(p);
    const int rows = min(16, n - r0);
    if (tma) {
      constexpr int CH = W / 8;  // 16-byte chunks of a staged row
#pragma unroll
      for (int k = 0; k < CH / 2; ++k) {
        const int idx = 32 * k + lane, rr = idx / CH, c = idx % CH;
        if (rr >= rows || 8 * c >= d) continue;
        const int from = swz<128>(r0 + rr, c);
        const size_t off = pair + at.src_token(r0 + rr) + 8 * c;
        *reinterpret_cast<uint4*>(at.dq + off) =
            *reinterpret_cast<const uint4*>(tiles.p_hi + from);
        *reinterpret_cast<uint4*>(at.dk + off) =
            *reinterpret_cast<const uint4*>(tiles.p_lo + from);
        *reinterpret_cast<uint4*>(at.dv + off) =
            *reinterpret_cast<const uint4*>(tiles.ds_hi + from);
      }
      return;
    }
    for (int idx = lane; idx < rows * d; idx += 32) {
      const int rr = idx / d, c = idx - rr * d;
      const int from = swz<128>(r0 + rr, c >> 3) + 2 * (c & 7);
      const size_t off = pair + at.src_token(r0 + rr) + c;
      at.dq[off] = *reinterpret_cast<const bf16*>(tiles.p_hi + from);
      at.dk[off] = *reinterpret_cast<const bf16*>(tiles.p_lo + from);
      at.dv[off] = *reinterpret_cast<const bf16*>(tiles.ds_hi + from);
    }
  };

  // the first pair's copies go out, then the table is summed while they
  // land
  if (count > 0) load(0);
  cp_async_wait_all();
  __syncthreads();  // the bias and mask landed
  for (int idx = tid; idx < kTileRows * kTileRows; idx += kThreads) {
    const int i = idx / kTileRows, j = idx % kTileRows;
    float x = -INFINITY;
    if (j < n)
      x = i >= n ? 0.f
                 : raw[i * n + j] +
                       (mask == nullptr ? 0.f : raw[(n + i) * n + j]);
    tiles.table[i * kTableLd + j] = x;
  }
  __syncthreads();  // the table whole; the P tiles free

  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  for (int p = 0; p < count; ++p) {
    // the tiles' addresses, opaque to the compiler: it rebuilds the wgmma
    // descriptors from them a pair (uniform instructions) rather than
    // keep 28 of them in registers through the walk
    unsigned char* base = smem;
    asm volatile("" : "+l"(base));
    const Bf16Tiles<W> t(base);
    if (tma)
      mbar_wait(t.bar, p & 1);  // the pair landed
    else
      __syncthreads();
    __syncwarp();  // the strip's staged outputs stored
    float dq[W / 8][4];
    uint32_t da[4][2][4];
    grad_queries_bf16<W>(t, scale_t, r0, lane, dq, acc, da);
    fence_async_smem();
    wgmma_wait<0>();  // dQ, so that its A registers are free for phase 2
    hold_regs(da);
    hold_acc(dq);
    __syncthreads();  // P and dS whole
    float dv[W / 8][4], dk[W / 8][4];
    grad_keys_bf16<W>(t, dv, dk);
    hold_acc(dv);
    hold_acc(dk);
    // the tiles of q, k, v and g are free for the next pair, those of P
    // and dS for the staged outputs
    __syncthreads();  // every warp's products done
    if (p + 1 < count) load(p + 1);
    if (r0 < n) {
      stage_bf16<W>(t.p_hi, dq, scale, r0, lane);
      stage_bf16<W>(t.p_lo, dk, scale, r0, lane);
      stage_bf16<W>(t.ds_hi, dv, 1.f, r0, lane);
      __syncwarp();
      store(p);
    }
  }

  if (partial != nullptr && r0 < n) {
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
// partial + that * nn.  dbias or dmask may be null.  Each sum walks its
// partials as one loop, unrolled, so that a thread has several loads in
// flight (the additions stay in order).  static: each kernel library
// holds its own.
static __global__ void __launch_bounds__(256)
sum_partials(const float* __restrict__ partial, float* __restrict__ dbias,
             float* __restrict__ dmask, int heads, int n_w, int chunks,
             int nn) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const long long nb = dbias == nullptr ? 0 : static_cast<long long>(heads) * nn;
  if (e < nb) {
    const int h = static_cast<int>(e / nn), ij = static_cast<int>(e % nn);
    const int blocks = chunks * n_w;  // block c * n_w + w of head h
    float s = 0.f;
#pragma unroll 32
    for (int b = 0; b < blocks; ++b)
      s += partial[(static_cast<long long>(b) * heads + h) * nn + ij];
    dbias[e] = s;
  } else if (dmask != nullptr &&
             e < nb + static_cast<long long>(n_w) * nn) {
    const long long f = e - nb;
    const int w = static_cast<int>(f / nn), ij = static_cast<int>(f % nn);
    const int blocks = chunks * heads;  // chunk b / heads, head b % heads
    float s = 0.f;
#pragma unroll 32
    for (int b = 0; b < blocks; ++b) {
      const int c = b / heads;
      s += partial[((static_cast<long long>(c) * n_w + w) * heads + b -
                    c * heads) * nn + ij];
    }
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

// cuTensorMapEncodeTiled, reached through the runtime's driver entry
// points (the libraries link no -lcuda); null if the driver has none
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled map_encoder() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return EncodeTiled{nullptr};
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// an encoder's failure as the launch's error code: 10000 + its CUresult
constexpr int kMapError = 10000;

// *map*: the bf16 tensor at `base` of `rank` dimensions (innermost first:
// dims, the byte strides of dims 1 .., the box), copied into tiles of
// rows of w bf16 swizzled over the row (bf16_width); 0 or kMapError + the
// encoder's error
inline int encode_bf16(CUtensorMap* map, const void* base, int rank,
                       const cuuint64_t* dims, const cuuint64_t* strides,
                       const cuuint32_t* box, int w) {
  const EncodeTiled encode = map_encoder();
  if (encode == nullptr) return kMapError + CUDA_ERROR_NOT_FOUND;
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, static_cast<cuuint32_t>(rank),
      const_cast<void*>(base), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      w == 16   ? CU_TENSOR_MAP_SWIZZLE_32B
      : w == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                : CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kMapError + static_cast<int>(r);
}

// the blocks an SM should hold of the bf16 backward for d padded to DP:
// three at D <= 32 (the registers capped for them), else as they come
__host__ __device__ constexpr int grad_min_blocks_bf16(int dp) {
  return dp <= 32 ? 3 : 1;
}

}  // namespace tile
