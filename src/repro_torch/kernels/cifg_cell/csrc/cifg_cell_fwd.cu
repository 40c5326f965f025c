// CIFG-LSTM cell forward for Hopper (sm_90a).
//
// Replaces src/repro/kernels/cifg_cell/cifg_cell.py::cell_fwd (the Pallas
// kernel _fwd_kernel / _gates). One recurrent step, given the hoisted input
// projection zx = x_t @ w_x + b_gates:
//
//   z   = zx + h @ w_h            product in the compute dtype, f32 sum
//   f   = sigmoid(z_f + 1)        forget bias 1
//   o   = sigmoid(z_o),  g = tanh(z_g)
//   c'  = f * c + (1 - f) * g     CIFG: i = 1 - f
//   h'  = o * tanh(c')
//
// Layout: the model's natural one, row-major and contiguous:
//   zx (B, 3H) f32, h and c (B, H) f32, w_h (H, 3H) in the compute dtype
//   (bf16 or f32), gate columns [f | o | g]; outputs h' and c' (B, H) f32.
// Ragged B and H are masked here; nothing is padded by the caller.
//
// What bounds it on an H100: at serving decode (B=256, H=256, bf16) one step
// moves about 2.2 MB (w_h 0.39 MB, zx 0.79 MB, h, c, h', c' 1.05 MB) for
// 0.1 GFLOP. At 3.35 TB/s that is about 0.7 us of memory traffic, against
// about 0.1 us of bf16 tensor-core work: the kernel is bound by memory and,
// at this size, by its launch.
//
// What this simple design does about it: every byte of zx, h, c, h' and c'
// is read or written once, coalesced, and the three gate products, the gate
// math and the state update are fused into one pass, so no (B, 3H) gate
// block goes to device memory. Each block owns a 16-row x 32-column tile of
// the output and stages tiles of h and of the three matching w_h column
// slices in shared memory; w_h (0.39 MB) is re-read by each row tile from
// L2. The products run as f32 FMAs on CUDA cores, not on tensor cores:
// wgmma, TMA and a persistent kernel over time are for later work.
//
// Where it stands: the design does not reach that bound. At B=256 its 128
// blocks give each SM one block of 8 warps, and at B=1 its 8 blocks leave
// the rest of the card idle; either way one SM runs a k-loop of 5
// shared-memory loads per 6 FMAs for every output pair, and that loop, not
// device memory, sets the time (PERF.md has the numbers from chip_smoke.py).
// More outputs per thread from each load, and K split across warps with a
// fixed-order sum, are the next steps.
//
// Determinism: each output element sums over k in ascending order with one
// f32 FMA per term, whatever B is and wherever the row sits. The serving
// engine (B = slots) therefore matches the single-session reference (B = 1)
// bit for bit in the cell.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 32;                // hidden columns per block (one per lane)
constexpr int kThreadRows = 8;           // warps per block
constexpr int kRowsPerThread = 2;
constexpr int kRows = kThreadRows * kRowsPerThread;  // 16 rows per block
constexpr int kTileK = 32;               // depth of one staged tile

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Round an f32 value to the compute dtype (round to nearest even), keep f32.
template <typename T>
__device__ __forceinline__ float round_cd(float x);
template <>
__device__ __forceinline__ float round_cd<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_cd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

template <typename T>
__global__ void __launch_bounds__(kCols * kThreadRows)
cifg_cell_fwd_kernel(const float* __restrict__ zx, const float* __restrict__ h,
                     const float* __restrict__ c, const T* __restrict__ w_h,
                     float* __restrict__ h_out, float* __restrict__ c_out,
                     int B, int H) {
  __shared__ float sh_h[kRows][kTileK];
  __shared__ float sh_w[3][kTileK][kCols];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kCols + tx;
  const int col0 = blockIdx.x * kCols;
  const int row0 = blockIdx.y * kRows;
  const long long H3 = 3LL * H;

  float acc[3][kRowsPerThread];
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) acc[g][r] = 0.0f;

  for (int k0 = 0; k0 < H; k0 += kTileK) {
    // h tile, rounded to the compute dtype as the reference casts h
    for (int i = tid; i < kRows * kTileK; i += kCols * kThreadRows) {
      const int r = i / kTileK, kk = i % kTileK;
      const int row = row0 + r, k = k0 + kk;
      sh_h[r][kk] = (row < B && k < H)
                        ? round_cd<T>(h[(long long)row * H + k]) : 0.0f;
    }
    // the three gate column slices of w_h for this tile's k range
    for (int i = tid; i < 3 * kTileK * kCols; i += kCols * kThreadRows) {
      const int g = i / (kTileK * kCols);
      const int rem = i % (kTileK * kCols);
      const int kk = rem / kCols, jj = rem % kCols;
      const int k = k0 + kk, col = col0 + jj;
      sh_w[g][kk][jj] = (k < H && col < H)
                            ? to_f32<T>(w_h[(long long)k * H3 + (long long)g * H + col])
                            : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      const float wf = sh_w[0][kk][tx];
      const float wo = sh_w[1][kk][tx];
      const float wg = sh_w[2][kk][tx];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const float hv = sh_h[ty * kRowsPerThread + r][kk];
        acc[0][r] = fmaf(hv, wf, acc[0][r]);
        acc[1][r] = fmaf(hv, wo, acc[1][r]);
        acc[2][r] = fmaf(hv, wg, acc[2][r]);
      }
    }
    __syncthreads();
  }

  const int j = col0 + tx;
  if (j >= H) return;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int row = row0 + ty * kRowsPerThread + r;
    if (row >= B) continue;
    const float* zrow = zx + (long long)row * H3;
    const float zf = zrow[j] + acc[0][r];
    const float zo = zrow[H + j] + acc[1][r];
    const float zg = zrow[2 * H + j] + acc[2][r];
    const float f = sigmoid_f32(zf + 1.0f);
    const float o = sigmoid_f32(zo);
    const float g = tanhf(zg);
    const long long idx = (long long)row * H + j;
    const float cn = f * c[idx] + (1.0f - f) * g;
    c_out[idx] = cn;
    h_out[idx] = o * tanhf(cn);
  }
}

template <typename T>
int launch(const float* zx, const float* h, const float* c, const void* w_h,
           float* h_out, float* c_out, int B, int H, cudaStream_t stream) {
  const dim3 block(kCols, kThreadRows);
  const dim3 grid((H + kCols - 1) / kCols, (B + kRows - 1) / kRows);
  cifg_cell_fwd_kernel<T><<<grid, block, 0, stream>>>(
      zx, h, c, static_cast<const T*>(w_h), h_out, c_out, B, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, loaded with ctypes. w_is_bf16 selects the compute
// dtype of w_h (1 = bf16, 0 = f32). Returns the cudaError_t of the launch
// (0 on success); a bad argument returns cudaErrorInvalidValue.
extern "C" int cifg_cell_fwd(const float* zx, const float* h, const float* c,
                             const void* w_h, int w_is_bf16, float* h_out,
                             float* c_out, int B, int H, void* stream) {
  if (B < 1 || H < 1 || B > 65535 * kRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_is_bf16) {
    return launch<__nv_bfloat16>(zx, h, c, w_h, h_out, c_out, B, H, s);
  }
  return launch<float>(zx, h, c, w_h, h_out, c_out, B, H, s);
}
