// Window attention backward for NVIDIA Hopper (sm_90a): the gradient of
// window_attention.cu's forward,
//
//   out[b, h] = softmax(q[b, h] . k[b, h]^T * scale + bias[h]
//                       (+ mask[b mod nW])) . v[b, h],
//
// given g = d loss / d out: dq, dk, dv (B_, H, N, D) of the inputs' type,
// dbias (H, N, N) float32 and, when asked for, dmask (nW, N, N) float32.
// q, k, v, g: (B_, H, N, D) contiguous, bf16 or float32; bias (H, N, N)
// and mask (nW, N, N) or absent, float32.  N <= 64 and D <= 64.
//
// The port's counterpart of the JAX package's custom VJP of the Pallas
// kernel _pallas_window_attention (medsegpretrainimagenet_tpu/ops/
// window_attention.py: _fused_bwd, which recomputes the probabilities in
// XLA), with _fused_bwd's rounding points.  The plain PyTorch version is
// window_attention_backward in ops/window_attention.py.
//
// What bounds it on the H100: device-memory bytes (q, k, v and g read, dq,
// dk and dv written: 7 * B_*H*N*D*itemsize; about 28 FLOP per byte in
// bf16 at N = 49, D = 32).  One kernel, window_attention_bwd<T, DP>, for T
// = bf16 and float, makes one pass over those bytes with the probabilities
// recomputed on the chip (attention_tile_bwd.cuh: tile::grad_pairs), and
// tile::sum_partials adds the blocks' dS sums into dbias and dmask in a
// fixed order.  This file gives the body only K1's addressing: pair t of a
// block is one contiguous N*D run of each of q, k, v, g, dq, dk and dv.
#include "attention_tile_bwd.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 64;
constexpr int kMaxD = 64;

using tile::bf16;

// Pair t of a block, image img0 + t of window w and head h, is one
// contiguous n * d run of every operand, at ((img0 + t) * n_w + w) * heads
// + h runs from the start.
template <class T>
struct WindowsGrad {
  using Elem = T;
  const T *q, *k, *v, *g;
  T *dq, *dk, *dv;
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
window_attention_bwd(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ g,
                     const float* __restrict__ bias,
                     const float* __restrict__ mask, T* __restrict__ dq,
                     T* __restrict__ dk, T* __restrict__ dv, int heads, int n,
                     int d, int n_w, int images, float scale, int vec,
                     float* __restrict__ partial, int per) {
  extern __shared__ __align__(16) unsigned char tile_smem[];
  const tile::Pairs p = tile::block_pairs(heads, n_w, per, images);
  const WindowsGrad<T> at{q, k, v, g, dq, dk, dv, p, heads, n_w,
                          static_cast<size_t>(n) * d, d};
  tile::grad_pairs<DP>(
      at, tile_smem, bias + p.h * static_cast<size_t>(n) * n,
      mask == nullptr ? nullptr : mask + p.w * static_cast<size_t>(n) * n,
      partial == nullptr
          ? nullptr
          : partial + blockIdx.x * static_cast<size_t>(n) * n,
      n, d, p.count, scale, vec);
}

// the shapes the kernel takes; n_w is 1 without a mask
bool takes(int windows, int heads, int n, int d, int n_w) {
  return windows >= 1 && heads >= 1 && n >= 1 && n <= kMaxN && d >= 1 &&
         d <= kMaxD && n_w >= 1 && windows % n_w == 0;
}

template <class T>
long long tiles(int windows, int heads, int n, int d, int n_w, int masked) {
  if (!masked) n_w = 1;
  if (!takes(windows, heads, n, d, n_w))
    return -static_cast<long long>(cudaErrorInvalidValue);
  return tile::with_padded_d(d, [&](auto dp) -> long long {
    constexpr int DP = decltype(dp)::value;
    return tile::grad_blocks(
        reinterpret_cast<const void*>(window_attention_bwd<T, DP>),
        tile::grad_smem_bytes<T, DP>(n, masked != 0),
        static_cast<long long>(n_w) * heads, windows / n_w);
  });
}

template <class T>
int backward(const void* q, const void* k, const void* v, const void* g,
             const void* bias, const void* mask, void* dq, void* dk,
             void* dv, void* partial, long long n_tiles, void* dbias,
             void* dmask, int windows, int heads, int n, int d, int n_w,
             float scale, void* stream) {
  if (mask == nullptr) n_w = 1;
  if (!takes(windows, heads, n, d, n_w) ||
      (dmask != nullptr && mask == nullptr) ||
      ((dbias != nullptr || dmask != nullptr) && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t addresses =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(g) |
      reinterpret_cast<uintptr_t>(dq) | reinterpret_cast<uintptr_t>(dk) |
      reinterpret_cast<uintptr_t>(dv);
  const int vec = d % tile::vec_elems<T>() == 0 && addresses % 16 == 0;
  return tile::with_padded_d(d, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    return tile::grad_launch(
        window_attention_bwd<T, DP>,
        tile::grad_smem_bytes<T, DP>(n, mask != nullptr),
        static_cast<long long>(n_w) * heads, heads, windows / n_w, n,
        static_cast<float*>(partial), n_tiles, static_cast<float*>(dbias),
        static_cast<float*>(dmask), stream, static_cast<const T*>(q),
        static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(g), static_cast<const float*>(bias),
        static_cast<const float*>(mask), static_cast<T*>(dq),
        static_cast<T*>(dk), static_cast<T*>(dv), heads, n, d, n_w,
        windows / n_w, scale, vec);
  });
}

}  // namespace

// C entry points, bound with ctypes.
//
// window_attention_bwd_tiles_{bf16,f32}: the number of (n, n) float32
// partial tiles a backward at these shapes needs (masked: a mask is given),
// or minus a CUDA error.
//
// window_attention_bwd_{bf16,f32}: mask may be null (W-MSA; n_w is then
// ignored).  partial (n_tiles tiles of n * n floats) is scratch for the
// blocks' dS sums; dbias and dmask are written if not null (dmask only
// with a mask), and partial may be null when both are.  Each returns
// cudaGetLastError() after the launches: 0 on success.
extern "C" long long window_attention_bwd_tiles_bf16(int windows, int heads,
                                                     int n, int d, int n_w,
                                                     int masked) {
  return tiles<bf16>(windows, heads, n, d, n_w, masked);
}

extern "C" long long window_attention_bwd_tiles_f32(int windows, int heads,
                                                    int n, int d, int n_w,
                                                    int masked) {
  return tiles<float>(windows, heads, n, d, n_w, masked);
}

extern "C" int window_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* g,
    const void* bias, const void* mask, void* dq, void* dk, void* dv,
    void* partial, long long n_tiles, void* dbias, void* dmask, int windows,
    int heads, int n, int d, int n_w, float scale, void* stream) {
  return backward<bf16>(q, k, v, g, bias, mask, dq, dk, dv, partial, n_tiles,
                        dbias, dmask, windows, heads, n, d, n_w, scale,
                        stream);
}

extern "C" int window_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* g,
    const void* bias, const void* mask, void* dq, void* dk, void* dv,
    void* partial, long long n_tiles, void* dbias, void* dmask, int windows,
    int heads, int n, int d, int n_w, float scale, void* stream) {
  return backward<float>(q, k, v, g, bias, mask, dq, dk, dv, partial,
                         n_tiles, dbias, dmask, windows, heads, n, d, n_w,
                         scale, stream);
}
