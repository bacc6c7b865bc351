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
// partition and a merge copy of each).  Two kernels,
// image_attention_bwd_bf16<DP> and image_attention_bwd<float, DP>, run K1's
// backward bodies (attention_tile_bwd.cuh: tile::grad_pairs_bf16,
// tile::grad_pairs_f32) with K2's addressing: a head's token is a run of D
// values of its pixel, stored 16 bytes at a time, a block takes one
// (window, head) and walks the images.  In bf16 the loads are boxes of
// 5-D tensor maps over qkv, (D, 3H, Rw, Rh, B), and g, (D, H, Rw, Rh, B),
// a box (D padded to 16, 32 or 64, 1, w, w, 1) at the head's channels: its
// rows are the window's tokens in order, and the columns >= D read as
// zeros.  A block keeps its window's token offsets in shared memory for
// its stores, and for its loads where the maps cannot go (and in
// float32).
#include "attention_tile_bwd.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <chrono>

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

// ... and in bf16 the tensor maps of qkv and g: pair t is the box at
// channel block h (q), H + h (k), 2H + h (v) of qkv and h of g, window
// (wi, wj) of image img0 + t
struct ImageGradBf16 : ImageGrad<bf16> {
  const CUtensorMap *mqkv, *mg;
  int h, heads;

  template <class Tiles>
  __device__ void issue(int t, const Tiles& x) const {
    const int c = wj * w, r = wi * w, b = img0 + t;
    tile::tma_load(x.q, mqkv, x.bar, 0, h, c, r, b);
    tile::tma_load(x.k, mqkv, x.bar, 0, heads + h, c, r, b);
    tile::tma_load(x.v, mqkv, x.bar, 0, 2 * heads + h, c, r, b);
    tile::tma_load(x.g, mg, x.bar, 0, h, c, r, b);
  }
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
  static_assert(std::is_same<T, float>::value, "bf16: the kernel below");
  tile::grad_pairs_f32<DP>(at, tile_smem, bias_w, mask_w, partial_b, n, d,
                           p.count, scale, vec);
}

// The bf16 instance: mqkv and mg map qkv and g (tma: they are used; else
// zeros, and every thread copies elements)
template <int DP>
__global__ void __launch_bounds__(tile::kThreads,
                                  tile::grad_min_blocks_bf16(DP))
image_attention_bwd_bf16(const __grid_constant__ CUtensorMap mqkv,
                         const __grid_constant__ CUtensorMap mg,
                         const bf16* __restrict__ qkv,
                         const bf16* __restrict__ g,
                         const float* __restrict__ bias,
                         const float* __restrict__ mask,
                         bf16* __restrict__ dqkv, int rows, int cols,
                         int channels, int heads, int w, int images,
                         float scale, int tma, float* __restrict__ partial,
                         int per) {
  extern __shared__ __align__(1024) unsigned char tile_smem_bf16[];
  const int n = w * w;
  const int d = channels / heads;
  const int n_wc = cols / w;
  const tile::Pairs p =
      tile::block_pairs(heads, (rows / w) * n_wc, per, images);
  int* tok = reinterpret_cast<int*>(
      tile_smem_bf16 + tile::grad_smem_bytes<bf16, DP>(n, mask != nullptr));
  for (int t = threadIdx.x; t < n; t += tile::kThreads) {
    const int a = t / w;
    tok[t] = a * cols + (t - a * w);  // the body syncs before reading it
  }
  const bf16* q = qkv + p.h * d;
  bf16* dq = dqkv + p.h * d;
  const ImageGradBf16 at{{q, q + channels, q + 2 * channels, g + p.h * d, dq,
                          dq + channels, dq + 2 * channels, tok, p.img0, rows,
                          cols, w, p.w / n_wc, p.w % n_wc,
                          3 * static_cast<size_t>(channels),
                          static_cast<size_t>(channels)},
                         &mqkv, &mg, p.h, heads};
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
    return reinterpret_cast<const void*>(image_attention_bwd_bf16<DP>);
  else
    return reinterpret_cast<const void*>(image_attention_bwd<T, DP>);
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
    return tile::grad_blocks(kernel_of<T, DP>(),
                             smem_bytes<T>(n, channels / heads, masked != 0),
                             groups, batch);
  });
}

template <class T>
int residency(int window, int d, int masked, int* smem, int* blocks) {
  if (!takes(1, window, window, d, 1, window))
    return static_cast<int>(cudaErrorInvalidValue);
  return tile::with_padded_d(d, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    return tile::grad_residency(
        kernel_of<T, DP>(), smem_bytes<T>(window * window, d, masked != 0),
        smem, blocks);
  });
}

// the bf16 tensor maps of qkv, (D, 3H, Rw, Rh, B), and g, (D, H, Rw, Rh,
// B), the box (the tiles' width, 1, w, w, 1); 0 or the encoder's error
// (tile::kMapError + ...)
int image_maps(CUtensorMap (&maps)[2], const void* qkv, const void* g,
               int batch, int rows, int cols, int channels, int heads,
               int window) {
  const int d = channels / heads;
  const int w = tile::bf16_width((d + 15) / 16 * 16);
  const cuuint32_t box[5] = {static_cast<cuuint32_t>(w), 1,
                             static_cast<cuuint32_t>(window),
                             static_cast<cuuint32_t>(window), 1};
  for (int i = 0; i < 2; ++i) {
    const cuuint64_t pixel = (i == 0 ? 3 : 1) * static_cast<cuuint64_t>(
                                                    channels) * sizeof(bf16);
    const cuuint64_t dims[5] = {static_cast<cuuint64_t>(d),
                                static_cast<cuuint64_t>((i == 0 ? 3 : 1) *
                                                        heads),
                                static_cast<cuuint64_t>(cols),
                                static_cast<cuuint64_t>(rows),
                                static_cast<cuuint64_t>(batch)};
    const cuuint64_t strides[4] = {d * sizeof(bf16), pixel, pixel * cols,
                                   pixel * cols * rows};
    const int err = tile::encode_bf16(&maps[i], i == 0 ? qkv : g, 5, dims,
                                      strides, box, w);
    if (err != 0) return err;
  }
  return 0;
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
    if constexpr (std::is_same<T, bf16>::value) {
      CUtensorMap maps[2] = {};
      if (vec) {
        const int err =
            image_maps(maps, qkv, g, batch, rows, cols, channels, heads,
                       window);
        if (err != 0) return err;
      }
      return tile::grad_launch(
          image_attention_bwd_bf16<DP>,
          smem_bytes<T>(n, channels / heads, mask != nullptr), groups, heads,
          batch, n, static_cast<float*>(partial), n_tiles,
          static_cast<float*>(dbias), static_cast<float*>(dmask), stream,
          maps[0], maps[1], static_cast<const T*>(qkv),
          static_cast<const T*>(g), static_cast<const float*>(bias),
          static_cast<const float*>(mask), static_cast<T*>(dqkv), rows, cols,
          channels, heads, window, batch, scale, vec);
    } else {
      return tile::grad_launch(
          image_attention_bwd<T, DP>,
          smem_bytes<T>(n, channels / heads, mask != nullptr), groups, heads,
          batch, n, static_cast<float*>(partial), n_tiles,
          static_cast<float*>(dbias), static_cast<float*>(dmask), stream,
          static_cast<const T*>(qkv), static_cast<const T*>(g),
          static_cast<const float*>(bias), static_cast<const float*>(mask),
          static_cast<T*>(dqkv), rows, cols, channels, heads, window, batch,
          scale, vec);
    }
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
// the launches: 0 on success; in bf16 the tensor maps' encoder's failure
// as 10000 + its CUresult.
//
// image_attention_bwd_encode_us_bf16: the host microseconds a bf16 call at
// these shapes spends encoding its two tensor maps, the mean of `reps`
// encodings; minus the error if one fails.
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

extern "C" double image_attention_bwd_encode_us_bf16(
    const void* qkv, const void* g, int batch, int rows, int cols,
    int channels, int heads, int window, int reps) {
  if (!takes(batch, rows, cols, channels, heads, window) || reps < 1)
    return -static_cast<double>(cudaErrorInvalidValue);
  CUtensorMap maps[2];
  const auto t0 = std::chrono::steady_clock::now();
  for (int r = 0; r < reps; ++r) {
    const int err =
        image_maps(maps, qkv, g, batch, rows, cols, channels, heads, window);
    if (err != 0) return -static_cast<double>(err);
  }
  const std::chrono::duration<double, std::micro> us =
      std::chrono::steady_clock::now() - t0;
  return us.count() / reps;
}
