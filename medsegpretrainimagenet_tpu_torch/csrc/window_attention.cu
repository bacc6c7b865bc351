// Window attention forward for NVIDIA Hopper (sm_90a).
//
//   out[b, h] = softmax(q[b, h] . k[b, h]^T * scale + bias[h]
//                       (+ mask[b mod nW])) . v[b, h]
//
// q, k, v, out: (B_, H, N, D) contiguous, bf16 or float32; bias: (H, N, N)
// float32; mask: (nW, N, N) float32 or absent.  N <= 64 and D <= 64.
//
// Replaces medsegpretrainimagenet_tpu/ops/window_attention.py:
// _pallas_window_attention (the Pallas TPU kernel, body _pallas_kernel).
// As there, the (N, N) logits and probabilities never leave on-chip memory.
//
// What bounds it on the H100: device-memory bytes.  The call must read q, k
// and v and write out, 4 * B_*H*N*D*itemsize bytes, for 2 * 2*B_*H*N*N*D
// operations: at N = 49, D = 32 in bf16 that is about 24 FLOP per byte, far
// under the card's ridge of about 295 FLOP per byte.
//
// The bf16 kernel (window_attention_bf16) is built for that bound:
// - the two products run on tensor cores, mma.sync.m16n8k16 on bf16 tiles
//   with float32 accumulators, with the probabilities kept in registers
//   between them (attention_tile.cuh; 128 mma per pair at N = 49, D = 32);
// - q, k and v stay bf16 in shared memory, in rows padded against ldmatrix
//   bank conflicts; a pair is one contiguous N*D run of each operand,
//   loaded with 16-byte cp.async, the per-thread offsets free of any
//   division but by the compile-time D padded to 16 (a template parameter:
//   16, 32, 48 or 64, one instance of the same body each);
// - a block walks several pairs, double-buffered: the next pair's loads are
//   in flight while the tensor cores work on this one;
// - the pairs of a block share one (window mod nW, head): it walks images,
//   so it reads its bias tile (and, for SW-MSA, its mask tile) from L2 once
//   into shared memory instead of once per pair.  The grid is as many
//   blocks as fit on the card at once (tile::plan).
// A D that is not a multiple of 8, or an operand not 16-byte aligned, is
// loaded and stored one element at a time by the same kernel.  All of this
// is tile::attend_pairs; this file gives it only K1's addressing
// (WindowsLayout).
//
// The float32 kernel (window_attention_f32) keeps the first
// design: one block per (window, head) pair, scalar FMAs on the CUDA cores
// over float32 copies in shared memory.  Tensor cores would take float32 as
// TF32, which keeps about three decimal digits and misses the 1e-4 bar that
// the float32 checks hold the kernel to.
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at a 700 W power
// limit, the 14 calls of one bf16 forward of swin_unet_224 at batch 24,
// L2-cold: 0.357 ms, 35 % of their 0.126 ms bytes bound (the first design,
// on CUDA cores: 2.10 ms; SDPA: 1.85 ms).  Per call and shape: PERF.md.
//
// Rounding points follow the JAX reference (_xla_window_attention) in both
// kernels: q is multiplied by scale in the input dtype (the scale rounded
// to it first) before the product, logits, bias, mask and the softmax are
// float32, and the probabilities are rounded to the input dtype before P.V,
// which accumulates in float32.  The float32 kernel also sums in the plain
// version's order; the bf16 one sums inside the mma tiles, so its output is
// within a bf16 rounding step of the plain version, not equal to it.
#include "attention_tile.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxN = 64;
constexpr int kMaxD = 64;

__global__ void __launch_bounds__(kThreads)
window_attention_f32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ bias,
                     const float* __restrict__ mask, float* __restrict__ out,
                     int heads, int n, int d, int n_w, float scale) {
  // rows padded by one float, so a warp walking a column (k[j][c] over j,
  // v[j][c] over c) touches 32 distinct banks
  extern __shared__ float smem[];
  const int ld = d + 1;
  const int lp = n + 1;
  float* qs = smem;          // n x ld: q * scale
  float* ks = qs + n * ld;   // n x ld
  float* vs = ks + n * ld;   // n x ld
  float* ps = vs + n * ld;   // n x lp: logits, then probabilities

  const int bh = blockIdx.x;  // (window, head), head fastest as in memory
  const int b = bh / heads;
  const int h = bh - b * heads;
  const size_t base = static_cast<size_t>(bh) * n * d;

  for (int idx = threadIdx.x; idx < n * d; idx += blockDim.x) {
    const int i = idx / d;
    const int c = idx - i * d;
    qs[i * ld + c] = q[base + idx] * scale;
    ks[i * ld + c] = k[base + idx];
    vs[i * ld + c] = v[base + idx];
  }
  __syncthreads();

  const float* bias_h = bias + static_cast<size_t>(h) * n * n;
  const float* mask_w =
      mask == nullptr ? nullptr : mask + static_cast<size_t>(b % n_w) * n * n;
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
    const int i = idx / n;
    const int j = idx - i * n;
    const float* qi = qs + i * ld;
    const float* kj = ks + j * ld;
    float acc = 0.f;
    for (int c = 0; c < d; ++c) acc = fmaf(qi[c], kj[c], acc);
    acc += bias_h[idx];
    if (mask_w != nullptr) acc += mask_w[idx];
    ps[i * lp + j] = acc;
  }
  __syncthreads();

  // row softmax, one warp per row; n <= 64, so each lane holds two columns
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int i = warp; i < n; i += blockDim.x / 32) {
    float* row = ps + i * lp;
    const bool has0 = lane < n;
    const bool has1 = lane + 32 < n;
    const float x0 = has0 ? row[lane] : -INFINITY;
    const float x1 = has1 ? row[lane + 32] : -INFINITY;
    float m = fmaxf(x0, x1);
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float e0 = has0 ? expf(x0 - m) : 0.f;
    const float e1 = has1 ? expf(x1 - m) : 0.f;
    float s = e0 + e1;
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (has0) row[lane] = e0 / s;
    if (has1) row[lane + 32] = e1 / s;
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < n * d; idx += blockDim.x) {
    const int i = idx / d;
    const int c = idx - i * d;
    const float* pi = ps + i * lp;
    float acc = 0.f;
    for (int j = 0; j < n; ++j) acc = fmaf(pi[j], vs[j * ld + c], acc);
    out[base + idx] = acc;
  }
}

using tile::bf16;

// Pair t of a block, image img0 + t of window w and head h, is one
// contiguous n * d run of q, k, v and out, at ((img0 + t) * n_w + w) *
// heads + h runs from the start.
struct WindowsLayout {
  const bf16 *q, *k, *v;
  bf16* out;
  tile::Pairs p;
  int heads, n_w;
  size_t pair;  // n * d
  int d;

  __device__ size_t src(int t) const {
    return ((static_cast<size_t>(p.img0 + t) * n_w + p.w) * heads + p.h) *
           pair;
  }
  __device__ size_t src_token(int i) const { return i * d; }
  __device__ size_t dst(int t) const { return src(t); }
  __device__ size_t dst_token(int i) const { return i * d; }
};

template <int DP>
__global__ void __launch_bounds__(tile::kThreads)
window_attention_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const float* __restrict__ bias,
                      const float* __restrict__ mask, bf16* __restrict__ out,
                      int heads, int n, int d, int n_w, int images,
                      float scale, int vec8, int per) {
  extern __shared__ __align__(16) unsigned char tile_smem[];
  const tile::Pairs p = tile::block_pairs(heads, n_w, per, images);
  const WindowsLayout at{q, k, v, out, p, heads, n_w,
                         static_cast<size_t>(n) * d, d};
  tile::attend_pairs<DP>(
      at, tile_smem, bias + p.h * static_cast<size_t>(n) * n,
      mask == nullptr ? nullptr : mask + p.w * static_cast<size_t>(n) * n, n,
      d, p.count, scale, vec8);
}

// the shapes both kernels take; n_w is 1 without a mask
bool takes(int windows, int heads, int n, int d, int n_w) {
  return windows >= 1 && heads >= 1 && n >= 1 && n <= kMaxN && d >= 1 &&
         d <= kMaxD && n_w >= 1 && windows % n_w == 0;
}

}  // namespace

// C entry points, bound with ctypes.  mask may be null (W-MSA); n_w is then
// ignored.  bf16 runs the tensor-core kernel, float32 the scalar one.  Each
// returns cudaGetLastError() after the launch: 0 on success.
extern "C" int window_attention_fwd_bf16(const void* q, const void* k,
                                         const void* v, const void* bias,
                                         const void* mask, void* out,
                                         int windows, int heads, int n, int d,
                                         int n_w, float scale, void* stream) {
  if (mask == nullptr) n_w = 1;
  if (!takes(windows, heads, n, d, n_w))
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t addresses =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out);
  const int vec8 = d % 8 == 0 && addresses % 16 == 0;
  return tile::with_padded_d(d, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    return tile::launch(
        window_attention_bf16<DP>, tile::smem_bytes<DP>(n, mask != nullptr),
        static_cast<long long>(n_w) * heads, windows / n_w, stream,
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const float*>(bias),
        static_cast<const float*>(mask), static_cast<bf16*>(out), heads, n, d,
        n_w, windows / n_w, scale, vec8);
  });
}

extern "C" int window_attention_fwd_f32(const void* q, const void* k,
                                        const void* v, const void* bias,
                                        const void* mask, void* out,
                                        int windows, int heads, int n, int d,
                                        int n_w, float scale, void* stream) {
  if (mask == nullptr) n_w = 1;
  if (!takes(windows, heads, n, d, n_w))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (3 * n * (d + 1) + n * (n + 1));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        window_attention_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  window_attention_f32<<<windows * heads, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<float*>(out), heads, n, d,
      n_w, scale);
  return static_cast<int>(cudaGetLastError());
}
