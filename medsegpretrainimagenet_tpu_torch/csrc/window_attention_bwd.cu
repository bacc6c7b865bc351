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
// bf16 at N = 49, D = 32).  Two kernels, window_attention_bwd_bf16<DP> and
// window_attention_bwd<float, DP>, make one pass over those bytes with the
// probabilities recomputed on the chip (attention_tile_bwd.cuh:
// tile::grad_pairs_bf16, every product on wgmma and the loads by tensor
// map; tile::grad_pairs_f32, split TF32), and tile::sum_partials adds the
// blocks' dS sums into dbias and dmask in a fixed order.  This file gives
// the bodies only K1's addressing: pair t of a block is one contiguous N*D
// run of each of q, k, v, g, dq, dk and dv, and in bf16 a box of n rows of
// a 2-D tensor map over each of q, k, v and g, (B_*H*N, D) with a box of
// (n, D padded to 16, 32 or 64: the columns >= D read as zeros).
#include "attention_tile_bwd.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <chrono>

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

// ... and in bf16 the tensor maps of q, k, v and g: pair t is the box of n
// rows from row src(t) / d
struct WindowsGradBf16 : WindowsGrad<bf16> {
  const CUtensorMap *mq, *mk, *mv, *mg;
  int n;

  template <class Tiles>
  __device__ void issue(int t, const Tiles& x) const {
    const int row = (((p.img0 + t) * n_w + p.w) * heads + p.h) * n;
    tile::tma_load(x.q, mq, x.bar, 0, row);
    tile::tma_load(x.k, mk, x.bar, 0, row);
    tile::tma_load(x.v, mv, x.bar, 0, row);
    tile::tma_load(x.g, mg, x.bar, 0, row);
  }
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
  const float* bias_w = bias + p.h * static_cast<size_t>(n) * n;
  const float* mask_w =
      mask == nullptr ? nullptr : mask + p.w * static_cast<size_t>(n) * n;
  float* partial_b = partial == nullptr
                         ? nullptr
                         : partial + blockIdx.x * static_cast<size_t>(n) * n;
  static_assert(std::is_same<T, float>::value, "bf16: the kernel below");
  tile::grad_pairs_f32<DP>(at, tile_smem, bias_w, mask_w, partial_b, n, d,
                           p.count, scale, vec);
}

// The bf16 instance: mq, mk, mv and mg map q, k, v and g (tma: they are
// used; else zeros, and every thread copies elements)
template <int DP>
__global__ void __launch_bounds__(tile::kThreads,
                                  tile::grad_min_blocks_bf16(DP))
window_attention_bwd_bf16(
    const __grid_constant__ CUtensorMap mq,
    const __grid_constant__ CUtensorMap mk,
    const __grid_constant__ CUtensorMap mv,
    const __grid_constant__ CUtensorMap mg, const bf16* __restrict__ q,
    const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ g, const float* __restrict__ bias,
    const float* __restrict__ mask, bf16* __restrict__ dq,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int heads, int n, int d,
    int n_w, int images, float scale, int tma, float* __restrict__ partial,
    int per) {
  extern __shared__ __align__(1024) unsigned char tile_smem_bf16[];
  const tile::Pairs p = tile::block_pairs(heads, n_w, per, images);
  const WindowsGradBf16 at{{q, k, v, g, dq, dk, dv, p, heads, n_w,
                            static_cast<size_t>(n) * d, d},
                           &mq, &mk, &mv, &mg, n};
  const float* bias_w = bias + p.h * static_cast<size_t>(n) * n;
  const float* mask_w =
      mask == nullptr ? nullptr : mask + p.w * static_cast<size_t>(n) * n;
  float* partial_b = partial == nullptr
                         ? nullptr
                         : partial + blockIdx.x * static_cast<size_t>(n) * n;
  tile::grad_pairs_bf16<DP>(at, tile_smem_bf16, bias_w, mask_w, partial_b, n,
                            d, p.count, scale, tma);
}

// the backward kernel of element type T for d padded to DP
template <class T, int DP>
const void* kernel_of() {
  if constexpr (std::is_same<T, bf16>::value)
    return reinterpret_cast<const void*>(window_attention_bwd_bf16<DP>);
  else
    return reinterpret_cast<const void*>(window_attention_bwd<T, DP>);
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
        kernel_of<T, DP>(), tile::grad_smem_bytes<T, DP>(n, masked != 0),
        static_cast<long long>(n_w) * heads, windows / n_w);
  });
}

template <class T>
int residency(int n, int d, int masked, int* smem, int* blocks) {
  if (!takes(1, 1, n, d, 1)) return static_cast<int>(cudaErrorInvalidValue);
  return tile::with_padded_d(d, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    return tile::grad_residency(kernel_of<T, DP>(),
                                tile::grad_smem_bytes<T, DP>(n, masked != 0),
                                smem, blocks);
  });
}

// the bf16 tensor maps of q, k, v and g: (B_*H*N, D) each, the box n rows
// of the tiles' width; 0 or the encoder's error (tile::kMapError + ...)
int windows_maps(CUtensorMap (&maps)[4], const void* q, const void* k,
                 const void* v, const void* g, int windows, int heads, int n,
                 int d) {
  const int w = tile::bf16_width((d + 15) / 16 * 16);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(windows) * heads * n};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d) * sizeof(bf16)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(w),
                             static_cast<cuuint32_t>(n)};
  const void* bases[4] = {q, k, v, g};
  for (int i = 0; i < 4; ++i) {
    const int err = tile::encode_bf16(&maps[i], bases[i], 2, dims, strides,
                                      box, w);
    if (err != 0) return err;
  }
  return 0;
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
    if constexpr (std::is_same<T, bf16>::value) {
      CUtensorMap maps[4] = {};
      if (vec) {
        const int err = windows_maps(maps, q, k, v, g, windows, heads, n, d);
        if (err != 0) return err;
      }
      return tile::grad_launch(
          window_attention_bwd_bf16<DP>, tile::grad_smem_bytes<T, DP>(n, true),
          static_cast<long long>(n_w) * heads, heads, windows / n_w, n,
          static_cast<float*>(partial), n_tiles, static_cast<float*>(dbias),
          static_cast<float*>(dmask), stream, maps[0], maps[1], maps[2],
          maps[3], static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(g),
          static_cast<const float*>(bias), static_cast<const float*>(mask),
          static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv),
          heads, n, d, n_w, windows / n_w, scale, vec);
    } else {
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
    }
  });
}

}  // namespace

// C entry points, bound with ctypes.
//
// window_attention_bwd_tiles_{bf16,f32}: the number of (n, n) float32
// partial tiles a backward at these shapes needs (masked: a mask is given),
// or minus a CUDA error.
//
// window_attention_bwd_residency_{bf16,f32}: the shared memory (bytes) a
// block of the backward kernel takes at these shapes and how many such
// blocks an SM holds at once (four warps each); 0 or a CUDA error.
//
// window_attention_bwd_{bf16,f32}: mask may be null (W-MSA; n_w is then
// ignored).  partial (n_tiles tiles of n * n floats) is scratch for the
// blocks' dS sums; dbias and dmask are written if not null (dmask only
// with a mask), and partial may be null when both are.  Each returns
// cudaGetLastError() after the launches: 0 on success; in bf16 the tensor
// maps' encoder's failure as 10000 + its CUresult.
//
// window_attention_bwd_encode_us_bf16: the host microseconds a bf16 call
// at these shapes spends encoding its four tensor maps, the mean of
// `reps` encodings; minus the error if one fails.
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

extern "C" int window_attention_bwd_residency_bf16(int n, int d, int masked,
                                                  int* smem, int* blocks) {
  return residency<bf16>(n, d, masked, smem, blocks);
}

extern "C" int window_attention_bwd_residency_f32(int n, int d, int masked,
                                                 int* smem, int* blocks) {
  return residency<float>(n, d, masked, smem, blocks);
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

extern "C" double window_attention_bwd_encode_us_bf16(
    const void* q, const void* k, const void* v, const void* g, int windows,
    int heads, int n, int d, int reps) {
  if (!takes(windows, heads, n, d, 1) || reps < 1)
    return -static_cast<double>(cudaErrorInvalidValue);
  CUtensorMap maps[4];
  const auto t0 = std::chrono::steady_clock::now();
  for (int r = 0; r < reps; ++r) {
    const int err = windows_maps(maps, q, k, v, g, windows, heads, n, d);
    if (err != 0) return -static_cast<double>(err);
  }
  const std::chrono::duration<double, std::micro> us =
      std::chrono::steady_clock::now() - t0;
  return us.count() / reps;
}
