// Window attention forward for NVIDIA Hopper (sm_90a).
//
//   out[b, h] = softmax(q[b, h] . k[b, h]^T * scale + bias[h]
//                       (+ mask[b mod nW])) . v[b, h]
//
// q, k, v, out: (B_, H, N, D) contiguous, bf16 or float32; bias: (H, N, N)
// float32; mask: (nW, N, N) float32 or absent.  N <= 64 and D <= 64.
//
// Replaces medsegpretrainimagenet_tpu/ops/window_attention.py:
// _pallas_window_attention (the Pallas TPU kernel, body _pallas_kernel),
// in both of its element types.  As there, the (N, N) logits and
// probabilities never leave on-chip memory.
//
// What bounds it on the H100: device-memory bytes.  The call must read q, k
// and v and write out, 4 * B_*H*N*D*itemsize bytes, for 2 * 2*B_*H*N*N*D
// operations: at N = 49, D = 32 that is about 24 FLOP per byte in bf16 and
// 12 in float32, far under the card's ridges: about 295 FLOP per byte on
// bf16 tensor cores, and 49 at the third of the TF32 rate that three
// split-TF32 products leave.
//
// One kernel, window_attention<T, DP>, for T = bf16 and float, built for
// that bound:
// - the two products run on tensor cores with the probabilities kept in
//   registers between them (attention_tile.cuh): mma.sync.m16n8k16 on bf16
//   tiles (128 mma per pair at N = 49, D = 32), or on float32 tiles
//   mma.sync.m16n8k8 in split TF32, three TF32 products per tile so that
//   the float32 output keeps the float32 bars (672 mma per pair);
// - q, k and v stay in their type in shared memory, in rows padded against
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
// A D that is not a multiple of the 16-byte width (8 bf16, 4 floats), or
// an operand not 16-byte aligned, is loaded and stored one element at a
// time by the same kernel.  All of this is tile::attend_pairs; this file
// gives it only K1's addressing (WindowsLayout).
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at a 700 W power
// limit, L2-cold: the 14 bf16 calls of one forward of swin_unet_224 at
// batch 24, 0.357 ms, 35 % of their 0.126 ms bytes bound (the first design,
// on CUDA cores: 2.10 ms; SDPA: 1.85 ms); the 8 float32 calls of one Swin
// encoder forward of robustness_224 (32 probes at 224), 0.573 to 0.599 ms,
// 29 to 30 % of their 0.173 ms bound (the first, scalar float32 design:
// 1.387 ms; SDPA in float32: 1.373 to 1.393 ms).  Per call and shape:
// PERF.md.
//
// Rounding points follow the JAX reference (_xla_window_attention): q is
// multiplied by scale in the input dtype (the scale rounded to it first)
// before the product, logits, bias, mask and the softmax are float32, and
// the probabilities are rounded to the input dtype before P.V, which
// accumulates in float32.  Both instances sum inside the mma tiles, in
// another order than the plain version: the bf16 output is within a bf16
// rounding step of it, the float32 output within a few float32 ones.
#include "attention_tile.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 64;
constexpr int kMaxD = 64;

using tile::bf16;

// Pair t of a block, image img0 + t of window w and head h, is one
// contiguous n * d run of q, k, v and out, at ((img0 + t) * n_w + w) *
// heads + h runs from the start.
template <class T>
struct WindowsLayout {
  using Elem = T;
  const T *q, *k, *v;
  T* out;
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

template <class T, int DP>
__global__ void __launch_bounds__(tile::kThreads)
window_attention(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ bias,
                 const float* __restrict__ mask, T* __restrict__ out,
                 int heads, int n, int d, int n_w, int images, float scale,
                 int vec, int per) {
  extern __shared__ __align__(16) unsigned char tile_smem[];
  const tile::Pairs p = tile::block_pairs(heads, n_w, per, images);
  const WindowsLayout<T> at{q, k, v, out, p, heads, n_w,
                            static_cast<size_t>(n) * d, d};
  tile::attend_pairs<DP>(
      at, tile_smem, bias + p.h * static_cast<size_t>(n) * n,
      mask == nullptr ? nullptr : mask + p.w * static_cast<size_t>(n) * n, n,
      d, p.count, scale, vec);
}

// the shapes the kernel takes; n_w is 1 without a mask
bool takes(int windows, int heads, int n, int d, int n_w) {
  return windows >= 1 && heads >= 1 && n >= 1 && n <= kMaxN && d >= 1 &&
         d <= kMaxD && n_w >= 1 && windows % n_w == 0;
}

template <class T>
int forward(const void* q, const void* k, const void* v, const void* bias,
            const void* mask, void* out, int windows, int heads, int n,
            int d, int n_w, float scale, void* stream) {
  if (mask == nullptr) n_w = 1;
  if (!takes(windows, heads, n, d, n_w))
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t addresses =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out);
  const int vec = d % tile::vec_elems<T>() == 0 && addresses % 16 == 0;
  return tile::with_padded_d(d, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    return tile::launch(
        window_attention<T, DP>, tile::smem_bytes<T, DP>(n, mask != nullptr),
        static_cast<long long>(n_w) * heads, windows / n_w, stream,
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const float*>(bias),
        static_cast<const float*>(mask), static_cast<T*>(out), heads, n, d,
        n_w, windows / n_w, scale, vec);
  });
}

}  // namespace

// C entry points, bound with ctypes, one per element type of the same
// tensor-core kernel.  mask may be null (W-MSA); n_w is then ignored.  Each
// returns cudaGetLastError() after the launch: 0 on success.
extern "C" int window_attention_fwd_bf16(const void* q, const void* k,
                                         const void* v, const void* bias,
                                         const void* mask, void* out,
                                         int windows, int heads, int n, int d,
                                         int n_w, float scale, void* stream) {
  return forward<bf16>(q, k, v, bias, mask, out, windows, heads, n, d, n_w,
                       scale, stream);
}

extern "C" int window_attention_fwd_f32(const void* q, const void* k,
                                        const void* v, const void* bias,
                                        const void* mask, void* out,
                                        int windows, int heads, int n, int d,
                                        int n_w, float scale, void* stream) {
  return forward<float>(q, k, v, bias, mask, out, windows, heads, n, d, n_w,
                        scale, stream);
}
