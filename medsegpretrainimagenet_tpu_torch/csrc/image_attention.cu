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
// under the card's ridge of about 295 FLOP per byte.  What the design does
// about it is the point of the kernel: it moves no more than those bytes,
// where the windows-layout path (partition, head split, K1, head merge,
// reverse) writes and reads each of them again in four layout copies.  It
// does nothing yet about the rest: one block per (image, window, head),
// each token of a head read as one run of D contiguous values (64 bytes at
// D = 32 in bf16), N such runs per operand, operands widened to float32 in
// shared memory, scalar FMAs, no tensor cores, no vector loads.
//
// Rounding points follow the JAX reference (_xla_image_attention, which
// calls _xla_window_attention), and so K1's (window_attention.cu), whose
// per-window body this kernel repeats with image-layout addressing: q is
// multiplied by scale in the input dtype before the product, logits and
// the softmax are float32, and the probabilities are rounded to the input
// dtype before P.V, which accumulates in float32.  The two kernels give the
// same values.  The body is repeated rather than shared because K1 built
// from a shared header ran about 5 % slower on the H100 (PERF.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxN = 64;
constexpr int kMaxD = 64;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

// x rounded to T and widened back: the value a T-typed tensor would hold
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
image_attention_kernel(const T* __restrict__ qkv,
                       const float* __restrict__ bias,
                       const float* __restrict__ mask, T* __restrict__ out,
                       int res, int channels, int heads, int w, float scale) {
  // rows padded by one float, so a warp walking a column (k[j][c] over j,
  // v[j][c] over c) touches 32 distinct banks
  extern __shared__ float smem[];
  const int n = w * w;
  const int d = channels / heads;
  const int ld = d + 1;
  const int lp = n + 1;
  float* qs = smem;          // n x ld: q * scale, rounded to T
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
  const T* q = qkv + corner * c3 + static_cast<size_t>(h) * d;
  const T* k = q + channels;
  const T* v = q + 2 * channels;
  const float scale_t = round_to<T>(scale);

  for (int idx = threadIdx.x; idx < n * d; idx += blockDim.x) {
    const int i = idx / d;
    const int c = idx - i * d;
    const int a = i / w;
    const size_t at = (static_cast<size_t>(a) * res + (i - a * w)) * c3 + c;
    qs[i * ld + c] = round_to<T>(to_float(q[at]) * scale_t);
    ks[i * ld + c] = to_float(k[at]);
    vs[i * ld + c] = to_float(v[at]);
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
    if (has0) row[lane] = round_to<T>(e0 / s);
    if (has1) row[lane + 32] = round_to<T>(e1 / s);
  }
  __syncthreads();

  // head h of the output: channels h*D..(h+1)*D of the window's pixels
  T* o = out + corner * channels + static_cast<size_t>(h) * d;
  for (int idx = threadIdx.x; idx < n * d; idx += blockDim.x) {
    const int i = idx / d;
    const int c = idx - i * d;
    const int a = i / w;
    const float* pi = ps + i * lp;
    float acc = 0.f;
    for (int j = 0; j < n; ++j) acc = fmaf(pi[j], vs[j * ld + c], acc);
    o[(static_cast<size_t>(a) * res + (i - a * w)) * channels + c] =
        from_float<T>(acc);
  }
}

template <typename T>
int launch(const void* qkv, const void* bias, const void* mask, void* out,
           int batch, int res, int channels, int heads, int window,
           float scale, void* stream) {
  if (batch < 1 || window < 1 || res < window || res % window != 0 ||
      heads < 1 || channels % heads != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n = window * window;
  const int d = channels / heads;
  const long long n_wc = res / window;
  const long long blocks =
      static_cast<long long>(batch) * n_wc * n_wc * heads;
  if (n > kMaxN || d < 1 || d > kMaxD || blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (3 * n * (d + 1) + n * (n + 1));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        image_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  image_attention_kernel<T>
      <<<static_cast<unsigned>(blocks), kThreads, smem,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(qkv), static_cast<const float*>(bias),
          static_cast<const float*>(mask), static_cast<T*>(out), res,
          channels, heads, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points, bound with ctypes.  mask may be null (W-MSA).  Each
// returns cudaGetLastError() after the launch: 0 on success.
extern "C" int image_attention_fwd_bf16(const void* qkv, const void* bias,
                                        const void* mask, void* out,
                                        int batch, int res, int channels,
                                        int heads, int window, float scale,
                                        void* stream) {
  return launch<__nv_bfloat16>(qkv, bias, mask, out, batch, res, channels,
                               heads, window, scale, stream);
}

extern "C" int image_attention_fwd_f32(const void* qkv, const void* bias,
                                       const void* mask, void* out, int batch,
                                       int res, int channels, int heads,
                                       int window, float scale,
                                       void* stream) {
  return launch<float>(qkv, bias, mask, out, batch, res, channels, heads,
                       window, scale, stream);
}
