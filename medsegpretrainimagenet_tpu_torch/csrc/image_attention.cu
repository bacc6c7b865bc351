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
// (i * w + a, j * w + c).  qkv: (B, R, R, 3C) contiguous, bf16 or float32;
// out: (B, R, R, C) of the same type; bias: (H, N, N) float32; mask:
// (nWc * nWc, N, N) float32 or absent, with nWc = R / w and N = w * w.
// N <= 64 and D = C / H <= 64.
//
// Replaces medsegpretrainimagenet_tpu/ops/window_attention.py:
// _pallas_image_attention (the Pallas TPU kernel, body _pallas_image_kernel).
// As there, the partitioned windows, the split heads and the (N, N) logits
// never touch device memory.  The TPU kernel's batch blocking (b_blk, for
// its ~16 MB VMEM budget) and its sublane-concat token flatten (a Mosaic
// reshape limit) have no counterpart: a block computes its own offsets.
//
// What bounds it on the H100: device-memory bytes.  The call must read qkv
// and write out, (3C + C) * B*R*R * itemsize bytes, for 2 * 2*B*nW*H*N*N*D
// operations: at N = 49, D = 32 in bf16 that is about 24 FLOP per byte, far
// under the card's ridge of about 295 FLOP per byte.  It moves no more than
// those bytes, where the windows-layout path (partition, head split, K1,
// head merge, reverse) writes and reads each of them again in four layout
// copies.
//
// The bf16 kernel (image_attention_bf16) runs K1's tensor-core body
// (attention_tile.cuh: mma.sync on bf16 tiles, probabilities kept in
// registers, bf16 shared memory, double-buffered pairs, a block walking the
// images of one (window, head) so that its bias and mask tiles are read
// once) with its own addressing:
// - a head's token is a run of D values at channel h*D, C + h*D or
//   2C + h*D of its pixel, D/8 16-byte cp.async per operand per token (four
//   at D = 32), and its output a run at h*D of the same pixel of out,
//   stored with 16-byte writes;
// - a block keeps a table of its window's token offsets (a*R + c pixels
//   from the window's corner) in shared memory, so the loads do no
//   division but by the compile-time D padded to 16;
// - a block takes one head: the whole window of all heads would not fit in
//   shared memory at level 3 of swin_unet_224 (49 x 2304 x 2 B = 225 KB).
// A D that is not a multiple of 8, or a tensor not 16-byte aligned, is
// loaded and stored one element at a time by the same kernel.  The body is
// tile::attend_pairs; this file gives it only K2's addressing (ImageLayout).
//
// The float32 kernel (image_attention_f32) keeps the first
// design: one block per (image, window, head), scalar FMAs over float32
// copies in shared memory.  Tensor cores would take float32 as TF32 and
// miss the 1e-4 bar of the float32 checks.
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at a 700 W power
// limit, the 14 calls of one bf16 forward of swin_unet_224 at batch 24,
// L2-cold: 0.376 ms, 33 % of their 0.126 ms bytes bound (the first design,
// on CUDA cores: 2.19 ms; the K1 path with its layout copies: 1.65 ms).
// Per call and shape: PERF.md.
//
// Rounding points follow the JAX reference (_xla_image_attention, which
// calls _xla_window_attention), and so K1's: q is multiplied by scale in
// the input dtype before the product, logits and the softmax are float32,
// and the probabilities are rounded to the input dtype before P.V, which
// accumulates in float32.  The two bf16 kernels run the same body and give
// the same values; the float32 kernel also equals the plain version.
#include "attention_tile.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxN = 64;
constexpr int kMaxD = 64;

__global__ void __launch_bounds__(kThreads)
image_attention_f32(const float* __restrict__ qkv,
                    const float* __restrict__ bias,
                    const float* __restrict__ mask, float* __restrict__ out,
                    int res, int channels, int heads, int w, float scale) {
  // rows padded by one float, so a warp walking a column (k[j][c] over j,
  // v[j][c] over c) touches 32 distinct banks
  extern __shared__ float smem[];
  const int n = w * w;
  const int d = channels / heads;
  const int ld = d + 1;
  const int lp = n + 1;
  float* qs = smem;          // n x ld: q * scale
  float* ks = qs + n * ld;   // n x ld
  float* vs = ks + n * ld;   // n x ld
  float* ps = vs + n * ld;   // n x lp: logits, then probabilities

  // blockIdx.x = ((b * nWc + i) * nWc + j) * heads + h: head fastest, then
  // the windows in the order of the windows layout
  const int n_wc = res / w;
  const int h = blockIdx.x % heads;
  const int win = blockIdx.x / heads;      // (b * nWc + i) * nWc + j
  const int wj = win % n_wc;
  const int wi = (win / n_wc) % n_wc;
  const int b = win / (n_wc * n_wc);
  // pixel index of the window's top-left pixel in the (B, R, R) stack;
  // token t = a * w + c of the window is pixel corner + a * R + c
  const size_t corner = (static_cast<size_t>(b) * res + wi * w) * res + wj * w;
  const size_t c3 = 3 * static_cast<size_t>(channels);
  const float* q = qkv + corner * c3 + static_cast<size_t>(h) * d;
  const float* k = q + channels;
  const float* v = q + 2 * channels;

  for (int idx = threadIdx.x; idx < n * d; idx += blockDim.x) {
    const int i = idx / d;
    const int c = idx - i * d;
    const int a = i / w;
    const size_t at = (static_cast<size_t>(a) * res + (i - a * w)) * c3 + c;
    qs[i * ld + c] = q[at] * scale;
    ks[i * ld + c] = k[at];
    vs[i * ld + c] = v[at];
  }
  __syncthreads();

  const float* bias_h = bias + static_cast<size_t>(h) * n * n;
  // window (i, j) takes mask row i * nWc + j, as in the TPU kernel
  const float* mask_w =
      mask == nullptr ? nullptr
                      : mask + static_cast<size_t>(wi * n_wc + wj) * n * n;
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

  // head h of the output: channels h*D..(h+1)*D of the window's pixels
  float* o = out + corner * channels + static_cast<size_t>(h) * d;
  for (int idx = threadIdx.x; idx < n * d; idx += blockDim.x) {
    const int i = idx / d;
    const int c = idx - i * d;
    const int a = i / w;
    const float* pi = ps + i * lp;
    float acc = 0.f;
    for (int j = 0; j < n; ++j) acc = fmaf(pi[j], vs[j * ld + c], acc);
    o[(static_cast<size_t>(a) * res + (i - a * w)) * channels + c] = acc;
  }
}

using tile::bf16;

// Pair t of a block is head h of window (wi, wj) of image img0 + t.  Its
// token i lies tok[i] = a * R + c pixels (i = a * w + c) from the window's
// top-left pixel; q, k and v are D channels at h*D, C + h*D and 2C + h*D
// of each pixel of qkv, out D channels at h*D of each pixel of out.
struct ImageLayout {
  const bf16 *q, *k, *v;  // qkv + h*D, + C, + 2C
  bf16* out;              // out + h*D
  const int* tok;         // n token offsets, in shared memory
  int img0, res, w, wi, wj;
  size_t c3, channels;    // elements from a pixel to the next: qkv, out

  __device__ size_t corner(int t) const {
    return (static_cast<size_t>(img0 + t) * res + wi * w) * res + wj * w;
  }
  __device__ size_t src(int t) const { return corner(t) * c3; }
  __device__ size_t src_token(int i) const { return tok[i] * c3; }
  __device__ size_t dst(int t) const { return corner(t) * channels; }
  __device__ size_t dst_token(int i) const { return tok[i] * channels; }
};

template <int DP>
__global__ void __launch_bounds__(tile::kThreads)
image_attention_bf16(const bf16* __restrict__ qkv,
                     const float* __restrict__ bias,
                     const float* __restrict__ mask, bf16* __restrict__ out,
                     int res, int channels, int heads, int w, int images,
                     float scale, int vec8, int per) {
  extern __shared__ __align__(16) unsigned char tile_smem[];
  const int n = w * w;
  const int d = channels / heads;
  const int n_wc = res / w;
  // group w of block_pairs is the window i * nWc + j of the grid
  const tile::Pairs p = tile::block_pairs(heads, n_wc * n_wc, per, images);
  int* tok = reinterpret_cast<int*>(
      tile_smem + tile::smem_bytes<DP>(n, mask != nullptr));
  for (int t = threadIdx.x; t < n; t += tile::kThreads) {
    const int a = t / w;
    tok[t] = a * res + (t - a * w);  // attend_pairs syncs before reading it
  }
  const bf16* q = qkv + p.h * d;
  const ImageLayout at{q, q + channels, q + 2 * channels, out + p.h * d,
                       tok, p.img0, res, w, p.w / n_wc, p.w % n_wc,
                       3 * static_cast<size_t>(channels),
                       static_cast<size_t>(channels)};
  tile::attend_pairs<DP>(
      at, tile_smem, bias + p.h * static_cast<size_t>(n) * n,
      mask == nullptr ? nullptr : mask + p.w * static_cast<size_t>(n) * n, n,
      d, p.count, scale, vec8);
}

// the shapes both kernels take
bool takes(int batch, int res, int channels, int heads, int window) {
  return batch >= 1 && window >= 1 && res >= window && res % window == 0 &&
         heads >= 1 && channels % heads == 0 && window * window <= kMaxN &&
         channels / heads >= 1 && channels / heads <= kMaxD;
}

}  // namespace

// C entry points, bound with ctypes.  mask may be null (W-MSA).  bf16 runs
// the tensor-core kernel, float32 the scalar one.  Each returns
// cudaGetLastError() after the launch: 0 on success.
extern "C" int image_attention_fwd_bf16(const void* qkv, const void* bias,
                                        const void* mask, void* out,
                                        int batch, int res, int channels,
                                        int heads, int window, float scale,
                                        void* stream) {
  if (!takes(batch, res, channels, heads, window))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n = window * window;
  const long long n_w = static_cast<long long>(res / window) * (res / window);
  const uintptr_t addresses =
      reinterpret_cast<uintptr_t>(qkv) | reinterpret_cast<uintptr_t>(out);
  const int vec8 = (channels / heads) % 8 == 0 && addresses % 16 == 0;
  return tile::with_padded_d(channels / heads, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    return tile::launch(
        image_attention_bf16<DP>,
        tile::smem_bytes<DP>(n, mask != nullptr) + sizeof(int) * n,
        n_w * heads, batch, stream, static_cast<const bf16*>(qkv),
        static_cast<const float*>(bias), static_cast<const float*>(mask),
        static_cast<bf16*>(out), res, channels, heads, window, batch, scale,
        vec8);
  });
}

extern "C" int image_attention_fwd_f32(const void* qkv, const void* bias,
                                       const void* mask, void* out, int batch,
                                       int res, int channels, int heads,
                                       int window, float scale,
                                       void* stream) {
  if (!takes(batch, res, channels, heads, window))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n = window * window;
  const int d = channels / heads;
  const long long n_wc = res / window;
  const long long blocks =
      static_cast<long long>(batch) * n_wc * n_wc * heads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (3 * n * (d + 1) + n * (n + 1));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        image_attention_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  image_attention_f32<<<static_cast<unsigned>(blocks), kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<float*>(out), res,
      channels, heads, window, scale);
  return static_cast<int>(cudaGetLastError());
}
