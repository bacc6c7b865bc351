// LayerNorm forward and backward for NVIDIA Hopper (sm_90a).
//
//   y[r, c] = (x[r, c] - mean[r]) * rstd[r] * gamma[c] + beta[c],
//   mean[r] = sum_c x[r, c] / C,
//   rstd[r] = 1 / sqrt(sum_c (x[r, c] - mean[r])^2 / C + eps)
//
// x: (rows, C) contiguous, bf16, fp16 or float32, read in its own type;
// gamma, beta: (C,) float32; y: (rows, C) float32, bf16 or fp16 (the
// promoted type, or the compute type of a half-output LayerNorm, rounded to
// nearest as a cast rounds); mean, rstd: (rows,) float32, kept for the
// backward.  The backward reads x, dy (y's type), mean, rstd and gamma once
// and writes dx in x's type; each block sums its rows' dgamma and dbeta
// terms in registers and shared memory into a (blocks, 2, C) scratch, and
// medseg_layer_norm_gamma_beta_sum adds the blocks up in a fixed order: no
// float atomics, so two runs give the same bits.  Statistics and the affine
// part are float32 whatever the types.
//
// No TPU kernel is replaced: the JAX package leaves flax's LayerNorm to
// XLA, which fuses it into its neighbours.  This kernel takes the place of
// the port's plain path (a cast of x to float32, then ATen's
// vectorized_layer_norm_kernel, layer_norm_grad_input_kernel,
// GammaBetaBackwardCUDAKernel and a cast of dx back to x's type).
//
// What bounds it on the H100: device-memory bytes.  A row of C elements
// takes a few operations an element against 6 to 8 bytes in the forward
// (x in, y out) and 8 to 12 in the backward (x, dy in, dx out).  ATen gives
// every row a block of its own; the Swin U-Net's rows are 96 to 1536
// elements, 384 bytes at the narrowest, so the card spends its time
// starting blocks and not moving bytes.  The design here:
// - one row lives in the registers of a group of G lanes, E elements a
//   lane, G and E fixed at compile time for each width the models build
//   (96: 8 lanes a row, 4 rows a warp; 192: 16 lanes; 384: a warp; 768: a
//   warp; 1536: two warps), so mean and variance are two passes over
//   registers and the group reduces with shuffles (two warps: and through
//   shared memory);
// - every load and store is 16 bytes where the chunk of a lane allows it,
//   neighbouring lanes on neighbouring chunks;
// - a block of 256 threads walks many rows (as many blocks as fit on the
//   card at once), so every SM keeps tens of KB of loads in flight;
// - the cast of x is a conversion in registers: no float32 copy of x is
//   written or saved.
// Any other width, or an operand that is not 16-byte aligned, takes the
// general instance of the same function: a warp a row, three passes over
// the row (the second and third from L1 and L2), the backward's partial
// sums kept per warp in the scratch.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <limits.h>
#include <stdint.h>

#include <initializer_list>
#include <mutex>
#include <vector>

namespace {

using bf16 = __nv_bfloat16;
using f16 = __half;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// the gamma-beta sum: 32 columns a block, kSlices slices of the slots
constexpr int kSlices = 16;

// element types, as the C entry points name them
enum Kind { kF32 = 0, kBF16 = 1, kF16 = 2 };
// error codes beyond CUDA's
constexpr int kErrKind = 10001;      // an element type it does not take
constexpr int kErrShape = 10003;     // rows < 0, C < 1, or slots not a grid

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(f16 v) { return __half2float(v); }

template <class T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ f16 from_float<f16>(float v) {
  return __float2half_rn(v);
}

template <class T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

// the widest of 16 bytes' worth of T, half that, ... that divides E: the
// chunk of consecutive elements a lane holds, in x's type
template <class T, int E>
__host__ __device__ constexpr int chunk_elems() {
  int v = 16 / static_cast<int>(sizeof(T));
  while (E % v) v /= 2;
  return v;
}

// K consecutive elements of type T to and from floats, in packs of at most
// 16 bytes
template <int K, class T>
__device__ __forceinline__ void load_chunk(const T* p, float* r) {
  constexpr int P = K < 16 / static_cast<int>(sizeof(T))
                        ? K
                        : 16 / static_cast<int>(sizeof(T));
#pragma unroll
  for (int s = 0; s < K / P; ++s) {
    const Pack<T, P> pk = reinterpret_cast<const Pack<T, P>*>(p)[s];
#pragma unroll
    for (int i = 0; i < P; ++i) r[s * P + i] = to_float(pk.v[i]);
  }
}

template <int K, class T>
__device__ __forceinline__ void store_chunk(T* p, const float* r) {
  constexpr int P = K < 16 / static_cast<int>(sizeof(T))
                        ? K
                        : 16 / static_cast<int>(sizeof(T));
#pragma unroll
  for (int s = 0; s < K / P; ++s) {
    Pack<T, P> pk;
#pragma unroll
    for (int i = 0; i < P; ++i) pk.v[i] = from_float<T>(r[s * P + i]);
    reinterpret_cast<Pack<T, P>*>(p)[s] = pk;
  }
}

// A row of C = G * E elements in the registers of G lanes: element k of
// lane l is column ((k / K) * G + l) * K + k % K, chunks of K consecutive
// columns, neighbouring lanes on neighbouring chunks.
template <int G, int E, int K>
struct RowMap {
  static constexpr int C = G * E;
  __device__ static int col(int lane, int k) {
    return ((k / K) * G + lane) * K + k % K;
  }
  template <class T>
  __device__ static void load(const T* row, int lane, float (&r)[E]) {
#pragma unroll
    for (int j = 0; j < E / K; ++j)
      load_chunk<K>(row + (j * G + lane) * K, r + j * K);
  }
  template <class T>
  __device__ static void store(T* row, int lane, const float (&r)[E]) {
#pragma unroll
    for (int j = 0; j < E / K; ++j)
      store_chunk<K>(row + (j * G + lane) * K, r + j * K);
  }
};

// The sums of a and b over the G lanes of a row, in every lane of it.  A
// butterfly leaves the same bits in every lane; rows of two or more warps
// add the warps' sums through shared memory in warp order.  Every thread of
// the block calls it (the row loop runs alike in all of them).
template <int G>
__device__ __forceinline__ void group_sum(float& a, float& b, float* red) {
  constexpr int L = G < 32 ? G : 32;
#pragma unroll
  for (int o = L / 2; o > 0; o /= 2) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  if constexpr (G > 32) {
    constexpr int W = G / 32;
    const int warp = threadIdx.x / 32, first = warp / W * W;
    if (threadIdx.x % 32 == 0) {
      red[2 * warp] = a;
      red[2 * warp + 1] = b;
    }
    __syncthreads();
    a = 0.f;
    b = 0.f;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      a += red[2 * (first + i)];
      b += red[2 * (first + i) + 1];
    }
    __syncthreads();
  }
}

__device__ __forceinline__ float warp_sum(float a) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) a += __shfl_xor_sync(0xffffffffu, a, o);
  return a;
}

// ---------------------------------------------------------------------------
// Register instances: C = G * E, a row to a group of G lanes.  They take C
// as the general instance does, unused, so that one launch serves both.
// ---------------------------------------------------------------------------

template <class Tin, class Tout, int G, int E>
__global__ void __launch_bounds__(kThreads)
    medseg_layer_norm_fwd(const Tin* __restrict__ x,
                          const float* __restrict__ gamma,
                          const float* __restrict__ beta, Tout* __restrict__ y,
                          float* __restrict__ mean, float* __restrict__ rstd,
                          long long rows, int /* C */, float eps) {
  using Map = RowMap<G, E, chunk_elems<Tin, E>()>;
  constexpr int C = Map::C, R = kThreads / G;
  __shared__ float red[G > 32 ? 2 * kWarps : 1];
  const int group = threadIdx.x / G, lane = threadIdx.x % G;
  float g[E], b[E];
  Map::load(gamma, lane, g);
  Map::load(beta, lane, b);
  const long long batches = (rows + R - 1) / R;
  for (long long t = blockIdx.x; t < batches; t += gridDim.x) {
    const long long row = t * R + group;
    const bool live = row < rows;
    float v[E];
    if (live) {
      Map::load(x + row * C, lane, v);
    } else {
#pragma unroll
      for (int k = 0; k < E; ++k) v[k] = 0.f;
    }
    float s = 0.f, unused = 0.f;
#pragma unroll
    for (int k = 0; k < E; ++k) s += v[k];
    group_sum<G>(s, unused, red);
    const float mu = s * (1.f / C);
    float q = 0.f;
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const float d = v[k] - mu;
      q += d * d;
    }
    group_sum<G>(q, unused, red);
    const float rs = rsqrtf(q * (1.f / C) + eps);
    if (live) {
#pragma unroll
      for (int k = 0; k < E; ++k) v[k] = (v[k] - mu) * rs * g[k] + b[k];
      Map::store(y + row * C, lane, v);
      if (lane == 0) {
        mean[row] = mu;
        rstd[row] = rs;
      }
    }
  }
}

// dx (if dx is not null) and, if partial is not null, this block's sums of
// dy * xhat and dy over its rows: partial[blockIdx.x][0 or 1][C]
template <class Tin, class Tg, int G, int E>
__global__ void __launch_bounds__(kThreads)
    medseg_layer_norm_bwd(const Tg* __restrict__ dy, const Tin* __restrict__ x,
                          const float* __restrict__ mean,
                          const float* __restrict__ rstd,
                          const float* __restrict__ gamma,
                          Tin* __restrict__ dx, float* __restrict__ partial,
                          long long rows, int /* C */) {
  using Map = RowMap<G, E, chunk_elems<Tin, E>()>;
  constexpr int C = Map::C, R = kThreads / G;
  __shared__ float red[G > 32 ? 2 * kWarps : 1];
  __shared__ float sums[R * C];
  const int group = threadIdx.x / G, lane = threadIdx.x % G;
  float g[E], dgamma[E], dbeta[E];
  Map::load(gamma, lane, g);
#pragma unroll
  for (int k = 0; k < E; ++k) dgamma[k] = dbeta[k] = 0.f;
  const long long batches = (rows + R - 1) / R;
  for (long long t = blockIdx.x; t < batches; t += gridDim.x) {
    const long long row = t * R + group;
    const bool live = row < rows;
    float xv[E], gv[E], mu = 0.f, rs = 0.f;
    if (live) {
      Map::load(x + row * C, lane, xv);
      Map::load(dy + row * C, lane, gv);
      mu = mean[row];
      rs = rstd[row];
    } else {
#pragma unroll
      for (int k = 0; k < E; ++k) xv[k] = gv[k] = 0.f;
    }
    float a = 0.f, c = 0.f;
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const float xh = (xv[k] - mu) * rs;
      dgamma[k] += gv[k] * xh;
      dbeta[k] += gv[k];
      const float gw = gv[k] * g[k];
      xv[k] = xh;
      gv[k] = gw;
      a += gw;
      c += gw * xh;
    }
    group_sum<G>(a, c, red);
    if (live && dx != nullptr) {
      a *= 1.f / C;
      c *= 1.f / C;
#pragma unroll
      for (int k = 0; k < E; ++k) xv[k] = rs * (gv[k] - a - xv[k] * c);
      Map::store(dx + row * C, lane, xv);
    }
  }
  if (partial == nullptr) return;
  // the block's groups added in group order, column by column
  float* out = partial + static_cast<long long>(blockIdx.x) * 2 * C;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int k = 0; k < E; ++k)
      sums[group * C + Map::col(lane, k)] = half ? dbeta[k] : dgamma[k];
    __syncthreads();
    for (int col = threadIdx.x; col < C; col += kThreads) {
      float s = 0.f;
      for (int r = 0; r < R; ++r) s += sums[r * C + col];
      out[half * C + col] = s;
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// The general instance: any C, a row to a warp
// ---------------------------------------------------------------------------

template <class Tin, class Tout>
__global__ void __launch_bounds__(kThreads)
    medseg_layer_norm_fwd_rows(const Tin* __restrict__ x,
                               const float* __restrict__ gamma,
                               const float* __restrict__ beta,
                               Tout* __restrict__ y, float* __restrict__ mean,
                               float* __restrict__ rstd, long long rows, int c,
                               float eps) {
  const int lane = threadIdx.x % 32;
  for (long long row = static_cast<long long>(blockIdx.x) * kWarps +
                       threadIdx.x / 32;
       row < rows; row += static_cast<long long>(gridDim.x) * kWarps) {
    const Tin* xr = x + row * c;
    float s = 0.f;
    for (int i = lane; i < c; i += 32) s += to_float(xr[i]);
    const float mu = warp_sum(s) / c;
    float q = 0.f;
    for (int i = lane; i < c; i += 32) {
      const float d = to_float(xr[i]) - mu;
      q += d * d;
    }
    const float rs = rsqrtf(warp_sum(q) / c + eps);
    for (int i = lane; i < c; i += 32)
      y[row * c + i] =
          from_float<Tout>((to_float(xr[i]) - mu) * rs * gamma[i] + beta[i]);
    if (lane == 0) {
      mean[row] = mu;
      rstd[row] = rs;
    }
  }
}

// partial (if not null): a (2, C) slot a warp, which the warp zeroes first
template <class Tin, class Tg>
__global__ void __launch_bounds__(kThreads)
    medseg_layer_norm_bwd_rows(const Tg* __restrict__ dy,
                               const Tin* __restrict__ x,
                               const float* __restrict__ mean,
                               const float* __restrict__ rstd,
                               const float* __restrict__ gamma,
                               Tin* __restrict__ dx,
                               float* __restrict__ partial, long long rows,
                               int c) {
  const int lane = threadIdx.x % 32;
  const long long slot =
      static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  float* sums = partial == nullptr ? nullptr : partial + slot * 2 * c;
  if (sums != nullptr)
    for (int i = lane; i < 2 * c; i += 32) sums[i] = 0.f;
  for (long long row = slot; row < rows;
       row += static_cast<long long>(gridDim.x) * kWarps) {
    const Tin* xr = x + row * c;
    const Tg* gr = dy + row * c;
    const float mu = mean[row], rs = rstd[row];
    float a = 0.f, b = 0.f;
    for (int i = lane; i < c; i += 32) {
      const float gw = to_float(gr[i]) * gamma[i];
      a += gw;
      b += gw * (to_float(xr[i]) - mu) * rs;
    }
    a = warp_sum(a) / c;
    b = warp_sum(b) / c;
    for (int i = lane; i < c; i += 32) {
      const float xh = (to_float(xr[i]) - mu) * rs, gv = to_float(gr[i]);
      if (dx != nullptr)
        dx[row * c + i] = from_float<Tin>(rs * (gv * gamma[i] - a - xh * b));
      if (sums != nullptr) {
        sums[i] += gv * xh;
        sums[c + i] += gv;
      }
    }
  }
}

// dgamma[col], dbeta[col] = the sums over the slots of partial[slot][0 or
// 1][col], in a fixed order: slice y adds slots y, y + kSlices, ... in
// turn, then the slices are added in slice order
__global__ void __launch_bounds__(32 * kSlices)
    medseg_layer_norm_gamma_beta_sum(const float* __restrict__ partial,
                                     long long slots, int c,
                                     float* __restrict__ dgamma,
                                     float* __restrict__ dbeta) {
  __shared__ float acc[kSlices][33];
  const int col = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (col < 2 * c) {
#pragma unroll 4
    for (long long i = threadIdx.y; i < slots; i += kSlices)
      s += partial[i * 2 * c + col];
  }
  acc[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && col < 2 * c) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < kSlices; ++k) t += acc[k][threadIdx.x];
    if (col < c)
      dgamma[col] = t;
    else
      dbeta[col - c] = t;
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

// The register instances, (C, lanes a row, elements a lane); every other C
// takes the general instance.
#define MEDSEG_LAYER_NORM_WIDTHS(X) \
  X(96, 8, 12)                      \
  X(192, 16, 12)                    \
  X(384, 32, 12)                    \
  X(768, 32, 24)                    \
  X(1536, 64, 24)

// true where every pointer is 16-byte aligned (a null one counts as
// aligned): the register instances load and store in packs of 16 bytes
bool aligned(std::initializer_list<const void*> pointers) {
  for (const void* p : pointers)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

// the SMs of the current device times the blocks of *kernel* resident on
// one SM: asked of CUDA once for each kernel instance and device
cudaError_t most_blocks(const void* kernel, long long* most) {
  struct Known {
    const void* kernel;
    int device;
    long long most;
  };
  static std::mutex lock;
  static std::vector<Known> known;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const std::lock_guard<std::mutex> hold(lock);
  for (const Known& k : known)
    if (k.kernel == kernel && k.device == device) {
      *most = k.most;
      return cudaSuccess;
    }
  int sms = 0, resident = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel,
                                                        kThreads, 0);
  if (err != cudaSuccess) return err;
  *most = static_cast<long long>(sms) * (resident > 0 ? resident : 1);
  known.push_back({kernel, device, *most});
  return cudaSuccess;
}

// as many blocks of the kernel as fit on the card at once, and no more
// than the rows need: lanes a row, kThreads / lanes rows a block
template <class... P>
cudaError_t grid_of(void (*kernel)(P...), long long rows, int lanes,
                    int* grid) {
  long long most = 0;
  const cudaError_t err =
      most_blocks(reinterpret_cast<const void*>(kernel), &most);
  if (err != cudaSuccess) return err;
  const long long batches = (rows + kThreads / lanes - 1) / (kThreads / lanes);
  *grid = static_cast<int>(batches < most ? (batches > 0 ? batches : 1)
                                          : most);
  return cudaSuccess;
}

// kernel on *grid* blocks, each argument cast to its parameter's type
template <class... P, class... A>
int launch(void (*kernel)(P...), int grid, cudaStream_t stream,
           A... args) {
  kernel<<<grid, kThreads, 0, stream>>>(static_cast<P>(args)...);
  return static_cast<int>(cudaGetLastError());
}

// f(Tin{}, Tout{}) for the two element types named by their kinds, or
// *other* for a kind it does not take
template <class R, class F>
R with_kinds(int x_kind, int y_kind, R other, F&& f) {
  auto second = [&](auto xt) -> R {
    switch (y_kind) {
      case kF32: return f(xt, float{});
      case kBF16: return f(xt, bf16{});
      case kF16: return f(xt, f16{});
    }
    return other;
  };
  switch (x_kind) {
    case kF32: return second(float{});
    case kBF16: return second(bf16{});
    case kF16: return second(f16{});
  }
  return other;
}

// f(kernel, lanes a row, slots a block) for the backward instance of these
// operands: the register instance of C where it has one and *packed*, else
// the general instance (a warp a row, a slot a warp); *other* for a kind
// it does not take
template <class R, class F>
R with_backward(int x_kind, int dy_kind, int c, bool packed, R other,
                F&& f) {
  return with_kinds(x_kind, dy_kind, other, [&](auto xt, auto gt) -> R {
    using Tin = decltype(xt);
    using Tg = decltype(gt);
    if (packed) {
      switch (c) {
#define MEDSEG_CASE(C, G, E) \
  case C:                    \
    return f(medseg_layer_norm_bwd<Tin, Tg, G, E>, G, 1);
        MEDSEG_LAYER_NORM_WIDTHS(MEDSEG_CASE)
#undef MEDSEG_CASE
      }
    }
    return f(medseg_layer_norm_bwd_rows<Tin, Tg>, 32, kWarps);
  });
}

}  // namespace

// C entry points, bound with ctypes.  Kinds: 0 float32, 1 bfloat16, 2
// float16.  Each takes the register instance of C where there is one and
// every operand it loads or stores in packs is 16-byte aligned, else the
// general instance, and returns cudaGetLastError() after its launches, or
// one of the codes above: 0 on success.

extern "C" int medseg_layer_norm_forward(const void* x, int x_kind,
                                         const void* gamma, const void* beta,
                                         void* y, int y_kind, void* mean,
                                         void* rstd, long long rows, int c,
                                         float eps, void* stream) {
  if (rows < 0 || c < 1) return kErrShape;
  if (rows == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool packed = aligned({x, gamma, beta, y});
  return with_kinds(x_kind, y_kind, kErrKind, [&](auto xt, auto yt) {
    using Tin = decltype(xt);
    using Tout = decltype(yt);
    const auto run = [&](auto kernel, int lanes) {
      int grid = 0;
      const cudaError_t err = grid_of(kernel, rows, lanes, &grid);
      if (err != cudaSuccess) return static_cast<int>(err);
      return launch(kernel, grid, st, x, gamma, beta, y, mean, rstd, rows, c,
                    eps);
    };
    if (packed) {
      switch (c) {
#define MEDSEG_CASE(C, G, E) \
  case C:                    \
    return run(medseg_layer_norm_fwd<Tin, Tout, G, E>, G);
        MEDSEG_LAYER_NORM_WIDTHS(MEDSEG_CASE)
#undef MEDSEG_CASE
      }
    }
    return run(medseg_layer_norm_fwd_rows<Tin, Tout>, 32);
  });
}

// The number of (2, C) float32 slots of the backward's scratch (its
// partial) for these operands: the blocks (register instances) or warps
// (general) of its grid, or minus an error code.
extern "C" long long medseg_layer_norm_backward_slots(
    const void* dy, int dy_kind, const void* x, int x_kind,
    const void* gamma, const void* dx, long long rows, int c) {
  if (rows < 1 || c < 1) return -kErrShape;
  return with_backward(
      x_kind, dy_kind, c, aligned({dy, x, gamma, dx}),
      -static_cast<long long>(kErrKind),
      [&](auto kernel, int lanes, int per_block) -> long long {
        int grid = 0;
        const cudaError_t err = grid_of(kernel, rows, lanes, &grid);
        return err == cudaSuccess ? static_cast<long long>(grid) * per_block
                                  : -static_cast<long long>(err);
      });
}

// dx (null: not written) in x's type; with partial (slots * 2 * C floats,
// slots from medseg_layer_norm_backward_slots for the same operands, which
// sets the grid) dgamma and dbeta (C floats each), else neither.
extern "C" int medseg_layer_norm_backward(
    const void* dy, int dy_kind, const void* x, int x_kind, const void* mean,
    const void* rstd, const void* gamma, void* dx, void* partial,
    long long slots, void* dgamma, void* dbeta, long long rows, int c,
    void* stream) {
  if (rows < 0 || c < 1) return kErrShape;
  if (rows == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_backward(
      x_kind, dy_kind, c, aligned({dy, x, gamma, dx}), kErrKind,
      [&](auto kernel, int lanes, int per_block) -> int {
        int grid = 0;
        if (partial == nullptr) {
          const cudaError_t err = grid_of(kernel, rows, lanes, &grid);
          if (err != cudaSuccess) return static_cast<int>(err);
        } else {
          if (slots < 1 || slots % per_block || slots / per_block > INT_MAX)
            return kErrShape;
          grid = static_cast<int>(slots / per_block);
        }
        const int err = launch(kernel, grid, st, dy, x, mean, rstd, gamma, dx,
                               partial, rows, c);
        if (err != 0 || partial == nullptr) return err;
        medseg_layer_norm_gamma_beta_sum<<<(2 * c + 31) / 32,
                                           dim3(32, kSlices), 0, st>>>(
            static_cast<const float*>(partial), slots, c,
            static_cast<float*>(dgamma), static_cast<float*>(dbeta));
        return static_cast<int>(cudaGetLastError());
      });
}
