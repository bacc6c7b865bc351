// Image-layout window attention forward for NVIDIA Hopper (sm_90a).
//
// One kernel does window partition, head split, attention, head merge and
// window reverse: for window (i, j) of image b and head h,
//
//   out[b, win(i, j), h*D:(h+1)*D] = softmax(q . k^T * scale + bias[h]
//                                            (+ mask[i * nWc + j])) . v
//
// where q, k and v are channels h*D, C + h*D and 2C + h*D of qkv at the
// window's pixels: token t = a * w + c of window (i, j) is pixel
// (i * w + a, j * w + c).  qkv: (B, Rh, Rw, 3C) contiguous, bf16 or
// float32; out: (B, Rh, Rw, C) of the same type; bias: (H, N, N) float32;
// mask: (nWr * nWc, N, N) float32 or absent, with nWr = Rh / w, nWc = Rw / w
// and N = w * w.  N <= 64 and D = C / H <= 64.  The image is a rectangle:
// under spatial sharding each process holds a band of Rh = Rw / S rows of
// a square image, with the rows of the global shift mask that its windows
// take (mask row i * nWc + j is the row-major window index, so a band's
// rows are one contiguous slice of them).
//
// Replaces medsegpretrainimagenet_tpu/ops/window_attention.py:
// _pallas_image_attention (the Pallas TPU kernel, body _pallas_image_kernel),
// in both of its element types.  As there, the partitioned windows, the
// split heads and the (N, N) logits never touch device memory.  The TPU
// kernel's batch blocking (b_blk, for its ~16 MB VMEM budget) and its
// sublane-concat token flatten (a Mosaic reshape limit) have no
// counterpart: a block computes its own offsets.
//
// What bounds it on the H100: device-memory bytes.  The call must read qkv
// and write out, (3C + C) * B*Rh*Rw * itemsize bytes, for 2 * 2*B*nW*H*N*N*D
// operations: at N = 49, D = 32 that is about 24 FLOP per byte in bf16 and
// 12 in float32, far under the card's ridges (window_attention.cu).  It
// moves no more than those bytes, where the windows-layout path
// (partition, head split, K1, head merge, reverse) writes and reads each of
// them again in four layout copies.
//
// One kernel, image_attention<T, DP> for T = bf16 and float, runs K1's
// tensor-core body (attention_tile.cuh: mma.sync on bf16 tiles, or split
// TF32 on float32 tiles, probabilities kept in registers, double-buffered
// pairs, a block walking the images of one (window, head) so that its bias
// and mask tiles are read once) with its own addressing:
// - a head's token is a run of D values at channel h*D, C + h*D or
//   2C + h*D of its pixel, 16-byte cp.async per operand per token (D/8 in
//   bf16, D/4 in float32), and its output a run at h*D of the same pixel of
//   out, stored with 16-byte writes;
// - a block keeps a table of its window's token offsets (a*Rw + c pixels
//   from the window's corner) in shared memory, so the loads do no
//   division but by the compile-time D padded to 16;
// - a block takes one head: the whole window of all heads would not fit in
//   shared memory at level 3 of swin_unet_224 (49 x 2304 x 2 B = 225 KB).
// A D that is not a multiple of the 16-byte width (8 bf16, 4 floats), or a
// tensor not 16-byte aligned, is loaded and stored one element at a time by
// the same kernel: with D a multiple of it, every run h*D, C + h*D, 2C + h*D
// and every pixel's 3C stride keep the 16-byte alignment of qkv.  The body
// is tile::attend_pairs; this file gives it only K2's addressing
// (ImageLayout).
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at a 700 W power
// limit, L2-cold: the 14 bf16 calls of one forward of swin_unet_224 at
// batch 24, 0.376 ms, 33 % of their 0.126 ms bytes bound (the first design,
// on CUDA cores: 2.19 ms; the K1 path with its layout copies: 1.65 ms); the
// 8 float32 calls of one Swin encoder forward of robustness_224 (32 probes
// at 224), 0.575 to 0.591 ms, 29 to 30 % of their 0.173 ms bound (the
// first, scalar float32 design: 1.439 ms).  Per call and shape: PERF.md.
//
// Rounding points follow the JAX reference (_xla_image_attention, which
// calls _xla_window_attention), and so K1's: q is multiplied by scale in
// the input dtype before the product, logits and the softmax are float32,
// and the probabilities are rounded to the input dtype before P.V, which
// accumulates in float32.  K1 and K2 run the same body and give the same
// values in each type.
#include "attention_tile.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 64;
constexpr int kMaxD = 64;

using tile::bf16;

// Pair t of a block is head h of window (wi, wj) of image img0 + t.  Its
// token i lies tok[i] = a * Rw + c pixels (i = a * w + c) from the window's
// top-left pixel; q, k and v are D channels at h*D, C + h*D and 2C + h*D
// of each pixel of qkv, out D channels at h*D of each pixel of out.
template <class T>
struct ImageLayout {
  using Elem = T;
  const T *q, *k, *v;  // qkv + h*D, + C, + 2C
  T* out;              // out + h*D
  const int* tok;      // n token offsets, in shared memory
  int img0, rows, cols, w, wi, wj;
  size_t c3, channels;  // elements from a pixel to the next: qkv, out

  // the window's top-left pixel: row wi * w of image img0 + t, rows of
  // cols pixels
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
image_attention(const T* __restrict__ qkv, const float* __restrict__ bias,
                const float* __restrict__ mask, T* __restrict__ out,
                int rows, int cols, int channels, int heads, int w,
                int images, float scale, int vec, int per) {
  extern __shared__ __align__(16) unsigned char tile_smem[];
  const int n = w * w;
  const int d = channels / heads;
  const int n_wc = cols / w;
  // group w of block_pairs is the window i * nWc + j of the nWr x nWc grid
  const tile::Pairs p =
      tile::block_pairs(heads, (rows / w) * n_wc, per, images);
  int* tok = reinterpret_cast<int*>(
      tile_smem + tile::smem_bytes<T, DP>(n, mask != nullptr));
  for (int t = threadIdx.x; t < n; t += tile::kThreads) {
    const int a = t / w;
    tok[t] = a * cols + (t - a * w);  // attend_pairs syncs before reading it
  }
  const T* q = qkv + p.h * d;
  const ImageLayout<T> at{q, q + channels, q + 2 * channels, out + p.h * d,
                          tok, p.img0, rows, cols, w, p.w / n_wc, p.w % n_wc,
                          3 * static_cast<size_t>(channels),
                          static_cast<size_t>(channels)};
  tile::attend_pairs<DP>(
      at, tile_smem, bias + p.h * static_cast<size_t>(n) * n,
      mask == nullptr ? nullptr : mask + p.w * static_cast<size_t>(n) * n, n,
      d, p.count, scale, vec);
}

// the shapes the kernel takes
bool takes(int batch, int rows, int cols, int channels, int heads,
           int window) {
  return batch >= 1 && window >= 1 && rows >= window && rows % window == 0 &&
         cols >= window && cols % window == 0 && heads >= 1 && channels % heads == 0 && window * window <= kMaxN &&
         channels / heads >= 1 && channels / heads <= kMaxD;
}

template <class T>
int forward(const void* qkv, const void* bias, const void* mask, void* out,
            int batch, int rows, int cols, int channels, int heads,
            int window, float scale, void* stream) {
  if (!takes(batch, rows, cols, channels, heads, window))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n = window * window;
  const long long n_w =
      static_cast<long long>(rows / window) * (cols / window);
  const uintptr_t addresses =
      reinterpret_cast<uintptr_t>(qkv) | reinterpret_cast<uintptr_t>(out);
  const int vec =
      (channels / heads) % tile::vec_elems<T>() == 0 && addresses % 16 == 0;
  return tile::with_padded_d(channels / heads, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    return tile::launch(
        image_attention<T, DP>,
        tile::smem_bytes<T, DP>(n, mask != nullptr) + sizeof(int) * n,
        n_w * heads, batch, stream, static_cast<const T*>(qkv),
        static_cast<const float*>(bias), static_cast<const float*>(mask),
        static_cast<T*>(out), rows, cols, channels, heads, window, batch,
        scale, vec);
  });
}

}  // namespace

// C entry points, bound with ctypes, one per element type of the same
// tensor-core kernel.  mask may be null (W-MSA).  Each returns
// cudaGetLastError() after the launch: 0 on success.
extern "C" int image_attention_fwd_bf16(const void* qkv, const void* bias,
                                        const void* mask, void* out,
                                        int batch, int rows, int cols,
                                        int channels, int heads, int window,
                                        float scale, void* stream) {
  return forward<bf16>(qkv, bias, mask, out, batch, rows, cols, channels,
                       heads, window, scale, stream);
}

extern "C" int image_attention_fwd_f32(const void* qkv, const void* bias,
                                       const void* mask, void* out, int batch,
                                       int rows, int cols, int channels,
                                       int heads, int window, float scale,
                                       void* stream) {
  return forward<float>(qkv, bias, mask, out, batch, rows, cols, channels,
                        heads, window, scale, stream);
}
