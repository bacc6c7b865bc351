// Image-layout window attention backward for NVIDIA Hopper (sm_90a): the
// gradient of image_attention.cu's forward (window partition, head split,
// attention, head merge and window reverse in one kernel), straight in the
// image layout:
//
//   qkv (B, Rh, Rw, 3C), g = d loss / d out (B, Rh, Rw, C)
//     -> dqkv (B, Rh, Rw, 3C), dbias (H, N, N), dmask (nWr * nWc, N, N)
//
// For window (i, j) of image b and head h, q, k and v are channels h*D,
// C + h*D and 2C + h*D of qkv at the window's pixels (token t = a * w + c
// is pixel (i * w + a, j * w + c)), g is channels h*D of g there, and dq,
// dk and dv land at the same channels of dqkv as q, k and v: every channel
// of every pixel of dqkv is written once, and no permute runs around the
// kernel.  qkv, g, dqkv: contiguous, bf16 or float32; bias and mask (or
// absent) float32, mask row i * nWc + j for window (i, j).  The image is
// a rectangle (a band of rows under spatial sharding, with its rows of the
// shift mask), N = w * w <= 64, D = C / H <= 64.
//
// The port's counterpart of the JAX package's custom VJP of the Pallas
// kernel _pallas_image_attention (medsegpretrainimagenet_tpu/ops/
// window_attention.py: _fused_image_bwd, the vjp of the XLA op sequence,
// whose attention part is _fused_bwd's arithmetic).  The plain PyTorch
// version is image_attention_backward in ops/window_attention.py.
//
// What bounds it on the H100: device-memory bytes (qkv and g read, dqkv
// written: 7C * B*Rh*Rw * itemsize; the windows-layout path would add a
// partition and a merge copy of each).  One kernel, image_attention_bwd<T,
// DP> for T = bf16 and float, runs K1's backward body
// (attention_tile_bwd.cuh: tile::grad_pairs, tile::grad_pairs_f32) with
// K2's addressing: a head's token is a run of D values of its pixel,
// loaded and stored 16 bytes at a time, a block keeps its window's token
// offsets in shared memory, and a block takes one (window, head) and walks
// the images.
#include "attention_tile_bwd.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 64;
constexpr int kMaxD = 64;

using tile::bf16;

// Pair t of a block is head h of window (wi, wj) of image img0 + t.  Its
// token i lies tok[i] = a * Rw + c pixels (i = a * w + c) from the window's
// top-left pixel; q, k, v (and dq, dk, dv) are D channels at h*D, C + h*D
// and 2C + h*D of each pixel of qkv (dqkv), g D channels at h*D of each
// pixel of g.
template <class T>
struct ImageGrad {
  using Elem = T;
  const T *q, *k, *v, *g;  // qkv + h*D, + C, + 2C; g + h*D
  T *dq, *dk, *dv;         // dqkv + h*D, + C, + 2C
  const int* tok;          // n token offsets, in shared memory
  int img0, rows, cols, w, wi, wj;
  size_t c3, channels;  // elements from a pixel to the next: qkv, g

  __device__ size_t corner(int t) const {
    return (static_cast<size_t>(img0 + t) * rows + wi * w) * cols + wj * w;
  }
  __device__ size_t src(int t) const { return corner(t) * c3; }
  __device__ size_t src_token(int i) const { return tok[i] * c3; }
  __device__ size_t dst(int t) const { return corner(t) * channels; }
  __device__ size_t dst_token(int i) const { return tok[i] * channels; }
};

template <class T, int DP>
__global__ void __launch_bounds__(tile::kThreads)
image_attention_bwd(const T* __restrict__ qkv, const T* __restrict__ g,
                    const float* __restrict__ bias,
                    const float* __restrict__ mask, T* __restrict__ dqkv,
                    int rows, int cols, int channels, int heads, int w,
                    int images, float scale, int vec,
                    float* __restrict__ partial, int per) {
  extern __shared__ __align__(16) unsigned char tile_smem[];
  const int n = w * w;
  const int d = channels / heads;
  const int n_wc = cols / w;
  // group w of block_pairs is the window i * nWc + j of the nWr x nWc grid
  const tile::Pairs p =
      tile::block_pairs(heads, (rows / w) * n_wc, per, images);
  int* tok = reinterpret_cast<int*>(
      tile_smem + tile::grad_smem_bytes<T, DP>(n, mask != nullptr));
  for (int t = threadIdx.x; t < n; t += tile::kThreads) {
    const int a = t / w;
    tok[t] = a * cols + (t - a * w);  // grad_pairs syncs before reading it
  }
  const T* q = qkv + p.h * d;
  T* dq = dqkv + p.h * d;
  const ImageGrad<T> at{q,
                        q + channels,
                        q + 2 * channels,
                        g + p.h * d,
                        dq,
                        dq + channels,
                        dq + 2 * channels,
                        tok,
                        p.img0,
                        rows,
                        cols,
                        w,
                        p.w / n_wc,
                        p.w % n_wc,
                        3 * static_cast<size_t>(channels),
                        static_cast<size_t>(channels)};
  const float* bias_w = bias + p.h * static_cast<size_t>(n) * n;
  const float* mask_w =
      mask == nullptr ? nullptr : mask + p.w * static_cast<size_t>(n) * n;
  float* partial_b = partial == nullptr
                         ? nullptr
                         : partial + blockIdx.x * static_cast<size_t>(n) * n;
  if constexpr (std::is_same<T, float>::value)
    tile::grad_pairs_f32<DP>(at, tile_smem, bias_w, mask_w, partial_b, n, d,
                             p.count, scale, vec);
  else
    tile::grad_pairs<DP>(at, tile_smem, bias_w, mask_w, partial_b, n, d,
                         p.count, scale, vec);
}

// the shapes the kernel takes
bool takes(int batch, int rows, int cols, int channels, int heads,
           int window) {
  return batch >= 1 && window >= 1 && rows >= window && rows % window == 0 &&
         cols >= window && cols % window == 0 && heads >= 1 &&
         channels % heads == 0 && window * window <= kMaxN &&
         channels / heads >= 1 && channels / heads <= kMaxD;
}

template <class T>
size_t smem_bytes(int n, int d, bool masked) {
  return tile::with_padded_d(d, [&](auto dp) {
           constexpr int DP = decltype(dp)::value;
           return static_cast<int>(tile::grad_smem_bytes<T, DP>(n, masked));
         }) +
         sizeof(int) * n;
}

template <class T>
long long tiles(int batch, int rows, int cols, int channels, int heads,
                int window, int masked) {
  if (!takes(batch, rows, cols, channels, heads, window))
    return -static_cast<long long>(cudaErrorInvalidValue);
  const int n = window * window;
  const long long groups =
      static_cast<long long>(rows / window) * (cols / window) * heads;
  return tile::with_padded_d(channels / heads, [&](auto dp) -> long long {
    constexpr int DP = decltype(dp)::value;
    return tile::grad_blocks(
        reinterpret_cast<const void*>(image_attention_bwd<T, DP>),
        smem_bytes<T>(n, channels / heads, masked != 0), groups, batch);
  });
}

template <class T>
int residency(int window, int d, int masked, int* smem, int* blocks) {
  if (!takes(1, window, window, d, 1, window))
    return static_cast<int>(cudaErrorInvalidValue);
  return tile::with_padded_d(d, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    return tile::grad_residency(
        reinterpret_cast<const void*>(image_attention_bwd<T, DP>),
        smem_bytes<T>(window * window, d, masked != 0), smem, blocks);
  });
}

template <class T>
int backward(const void* qkv, const void* g, const void* bias,
             const void* mask, void* dqkv, void* partial, long long n_tiles,
             void* dbias, void* dmask, int batch, int rows, int cols,
             int channels, int heads, int window, float scale,
             void* stream) {
  if (!takes(batch, rows, cols, channels, heads, window) ||
      (dmask != nullptr && mask == nullptr) ||
      ((dbias != nullptr || dmask != nullptr) && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n = window * window;
  const long long groups =
      static_cast<long long>(rows / window) * (cols / window) * heads;
  const uintptr_t addresses = reinterpret_cast<uintptr_t>(qkv) |
                              reinterpret_cast<uintptr_t>(g) |
                              reinterpret_cast<uintptr_t>(dqkv);
  const int vec =
      (channels / heads) % tile::vec_elems<T>() == 0 && addresses % 16 == 0;
  return tile::with_padded_d(channels / heads, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    return tile::grad_launch(
        image_attention_bwd<T, DP>,
        smem_bytes<T>(n, channels / heads, mask != nullptr), groups, heads,
        batch, n, static_cast<float*>(partial), n_tiles,
        static_cast<float*>(dbias), static_cast<float*>(dmask), stream,
        static_cast<const T*>(qkv), static_cast<const T*>(g),
        static_cast<const float*>(bias), static_cast<const float*>(mask),
        static_cast<T*>(dqkv), rows, cols, channels, heads, window, batch,
        scale, vec);
  });
}

}  // namespace

// C entry points, bound with ctypes.
//
// image_attention_bwd_tiles_{bf16,f32}: the number of (n, n) float32
// partial tiles a backward at these shapes needs (masked: a mask is given),
// or minus a CUDA error.
//
// image_attention_bwd_residency_{bf16,f32}: the shared memory (bytes) a
// block of the backward kernel takes for a window of window^2 tokens and
// heads of d channels, and how many such blocks an SM holds at once (four
// warps each); 0 or a CUDA error.
//
// image_attention_bwd_{bf16,f32}: mask may be null (W-MSA).  partial
// (n_tiles tiles of n * n floats) is scratch for the blocks' dS sums;
// dbias and dmask are written if not null (dmask only with a mask), and
// partial may be null when both are.  Each returns cudaGetLastError() after
// the launches: 0 on success.
extern "C" long long image_attention_bwd_tiles_bf16(int batch, int rows,
                                                    int cols, int channels,
                                                    int heads, int window,
                                                    int masked) {
  return tiles<bf16>(batch, rows, cols, channels, heads, window, masked);
}

extern "C" long long image_attention_bwd_tiles_f32(int batch, int rows,
                                                   int cols, int channels,
                                                   int heads, int window,
                                                   int masked) {
  return tiles<float>(batch, rows, cols, channels, heads, window, masked);
}

extern "C" int image_attention_bwd_residency_bf16(int window, int d,
                                                 int masked, int* smem,
                                                 int* blocks) {
  return residency<bf16>(window, d, masked, smem, blocks);
}

extern "C" int image_attention_bwd_residency_f32(int window, int d,
                                                int masked, int* smem,
                                                int* blocks) {
  return residency<float>(window, d, masked, smem, blocks);
}

extern "C" int image_attention_bwd_bf16(const void* qkv, const void* g,
                                        const void* bias, const void* mask,
                                        void* dqkv, void* partial,
                                        long long n_tiles, void* dbias,
                                        void* dmask, int batch, int rows,
                                        int cols, int channels, int heads,
                                        int window, float scale,
                                        void* stream) {
  return backward<bf16>(qkv, g, bias, mask, dqkv, partial, n_tiles, dbias,
                        dmask, batch, rows, cols, channels, heads, window,
                        scale, stream);
}

extern "C" int image_attention_bwd_f32(const void* qkv, const void* g,
                                       const void* bias, const void* mask,
                                       void* dqkv, void* partial,
                                       long long n_tiles, void* dbias,
                                       void* dmask, int batch, int rows,
                                       int cols, int channels, int heads,
                                       int window, float scale,
                                       void* stream) {
  return backward<float>(qkv, g, bias, mask, dqkv, partial, n_tiles, dbias,
                         dmask, batch, rows, cols, channels, heads, window,
                         scale, stream);
}
