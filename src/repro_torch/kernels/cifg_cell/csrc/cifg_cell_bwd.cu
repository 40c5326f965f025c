// CIFG-LSTM cell backward for Hopper (sm_90a).
//
// Replaces src/repro/kernels/cifg_cell/cifg_cell.py::cell_bwd (the Pallas
// kernel _bwd_kernel). The reverse of one recurrent step, given the step's
// inputs and the cotangents dh', dc' of its outputs:
//
//   z    = zx + h @ w_h                  recomputed as cifg_cell_fwd.cu does
//   f    = sigmoid(z_f + 1), o = sigmoid(z_o), g = tanh(z_g)
//   t    = tanh(f * c + (1 - f) * g)
//   dct  = dc' + dh' * o * (1 - t^2)
//   dz   = [dct (c - g) f (1 - f) | dh' t o (1 - o) | dct (1 - f)(1 - g^2)]
//   dzx  = dz,   dc = dct * f
//   dh   = dz @ w_h^T                    over the 3H gate outputs
//   dw_h = h^T @ dz                      over the B rows
//
// The two products run on operands rounded to the compute dtype (bf16 or
// f32) with f32 sums, as the Pallas kernel's dot_generals do.
//
// Layout: the model's natural one, row-major and contiguous: zx (B, 3H) f32,
// w_h (H, 3H) in the compute dtype, h, c, dh', dc' (B, H) f32; outputs dzx
// (B, 3H), dh and dc (B, H), dw_h (H, 3H), all f32. Ragged B and H are
// masked here; nothing is padded by the caller.
//
// Structure: four launches on the caller's stream, all from one tiled
// product kernel and one elementwise kernel:
//   1. acc  = round(h) @ w_h    into the dzx buffer (no zx yet);
//   2. gates and dz, elementwise: z = zx + acc exactly as the forward kernel
//      adds them, dz overwrites acc in place, dc is written;
//   3. dh   = round(dz) @ w_h^T;
//   4. dw_h = round(h)^T @ round(dz).
// Each output element of a product is one f32 FMA chain over k in ascending
// order starting from 0, which is the forward kernel's order for z, so the
// recomputed gates are bitwise the forward's, and every result is the same
// bits on every run (no atomics, no split sums).
//
// What bounds it on an H100: at a training step (B=10, H=256, bf16) the
// step reads zx 31 KB, w_h 393 KB, h, c, dh', dc' 41 KB and writes dzx 31 KB,
// dh and dc 20 KB, dw_h 786 KB: about 1.3 MB, 0.4 us at 3.35 TB/s, for
// 12 MFLOP, nothing for the tensor cores. At B=256 it moves about 4.3 MB
// (1.3 us). The (H, 3H) f32 dw_h is the largest single transfer; it is
// tiled across 192 blocks of 32x32 outputs. The products run as f32 FMAs on
// CUDA cores with 32x32 tiles staged in shared memory (each tile load
// coalesced along the operand's contiguous dimension): simple, not fast.
// Four launches where one would do, no tensor cores, and dh's 24 serial
// k-tiles over only 8 blocks at B=10 are what a faster version removes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;       // output tile edge and depth of a k tile
constexpr int kThreadRows = 8;  // threads per tile column: 4 rows each
constexpr int kRowsPerThread = kTile / kThreadRows;

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

// C (M, N) f32 = sum over k of round(A(m, k)) * round(B(k, n)), A and B read
// through strides, both operands rounded to the compute dtype TC; one FMA
// chain per output over k ascending.
template <typename TA, typename TB, typename TC>
__global__ void __launch_bounds__(kTile * kThreadRows)
strided_mm_kernel(const TA* __restrict__ A, long long a_sm, long long a_sk,
                  const TB* __restrict__ Bm, long long b_sk, long long b_sn,
                  float* __restrict__ C, int M, int N, int K) {
  __shared__ float sa[kTile][kTile + 1];
  __shared__ float sb[kTile][kTile + 1];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kTile + tx;
  const int n0 = blockIdx.x * kTile;
  const int m0 = blockIdx.y * kTile;

  float acc[kRowsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) acc[r] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kTile) {
    // Consecutive threads walk the operand's contiguous dimension, so
    // every tile load is coalesced whichever way the operand is read.
    for (int i = tid; i < kTile * kTile; i += kTile * kThreadRows) {
      const int lo = i % kTile, hi = i / kTile;
      // A tile sa[m][k]: m fast when A's rows are contiguous (a_sm == 1)
      const int ra = a_sm == 1 ? lo : hi, qa = a_sm == 1 ? hi : lo;
      const int m = m0 + ra, ka = k0 + qa;
      sa[ra][qa] = (m < M && ka < K)
                       ? round_cd<TC>(to_f32<TA>(A[m * a_sm + ka * a_sk]))
                       : 0.0f;
      // B tile sb[k][n]: k fast when B's columns are contiguous (b_sk == 1)
      const int rb = b_sk == 1 ? lo : hi, qb = b_sk == 1 ? hi : lo;
      const int kb = k0 + rb, n = n0 + qb;
      sb[rb][qb] = (kb < K && n < N)
                       ? round_cd<TC>(to_f32<TB>(Bm[kb * b_sk + n * b_sn]))
                       : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kTile; ++kk) {
      const float bv = sb[kk][tx];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        acc[r] = fmaf(sa[ty * kRowsPerThread + r][kk], bv, acc[r]);
      }
    }
    __syncthreads();
  }

  const int n = n0 + tx;
  if (n >= N) return;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int m = m0 + ty * kRowsPerThread + r;
    if (m < M) C[(long long)m * N + n] = acc[r];
  }
}

// Gates and dz, one thread per (row, hidden column). dz_acc holds h @ w_h on
// entry and dz on exit, in the same places (each thread owns its three).
__global__ void cifg_gates_bwd_kernel(const float* __restrict__ zx,
                                      const float* __restrict__ c,
                                      const float* __restrict__ dh_new,
                                      const float* __restrict__ dc_new,
                                      float* __restrict__ dz_acc,
                                      float* __restrict__ dc, int B, int H) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * H) return;
  const long long row = idx / H;
  const int j = static_cast<int>(idx % H);
  const long long base = row * 3LL * H;
  const float zf = zx[base + j] + dz_acc[base + j];
  const float zo = zx[base + H + j] + dz_acc[base + H + j];
  const float zg = zx[base + 2 * H + j] + dz_acc[base + 2 * H + j];
  const float f = sigmoid_f32(zf + 1.0f);
  const float o = sigmoid_f32(zo);
  const float g = tanhf(zg);
  const float cv = c[idx];
  const float t = tanhf(f * cv + (1.0f - f) * g);
  const float dhv = dh_new[idx];
  const float dct = dc_new[idx] + dhv * o * (1.0f - t * t);
  dz_acc[base + j] = dct * (cv - g) * f * (1.0f - f);
  dz_acc[base + H + j] = dhv * t * o * (1.0f - o);
  dz_acc[base + 2 * H + j] = dct * (1.0f - f) * (1.0f - g * g);
  dc[idx] = dct * f;
}

template <typename TA, typename TB, typename TC>
cudaError_t strided_mm(const TA* A, long long a_sm, long long a_sk,
                       const TB* Bm, long long b_sk, long long b_sn, float* C,
                       int M, int N, int K, cudaStream_t stream) {
  const dim3 block(kTile, kThreadRows);
  const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile);
  strided_mm_kernel<TA, TB, TC><<<grid, block, 0, stream>>>(
      A, a_sm, a_sk, Bm, b_sk, b_sn, C, M, N, K);
  return cudaGetLastError();
}

template <typename T>
int launch(const float* zx, const T* w_h, const float* h, const float* c,
           const float* dh_new, const float* dc_new, float* dzx, float* dh,
           float* dc, float* dwh, int B, int H, cudaStream_t s) {
  const long long H3 = 3LL * H;
  cudaError_t err;
  // 1. acc = round(h) @ w_h : (B, H) @ (H, 3H) into dzx
  err = strided_mm<float, T, T>(h, H, 1, w_h, H3, 1, dzx, B, 3 * H, H, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // 2. gates, dz (in place over acc), dc
  const long long n = (long long)B * H;
  const int threads = 256;
  cifg_gates_bwd_kernel<<<static_cast<unsigned>((n + threads - 1) / threads),
                          threads, 0, s>>>(zx, c, dh_new, dc_new, dzx, dc, B,
                                           H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // 3. dh = round(dz) @ w_h^T : A(m=b, k) = dz[b, k], B(k, n=i) = w_h[i, k]
  err = strided_mm<float, T, T>(dzx, H3, 1, w_h, 1, H3, dh, B, H, 3 * H, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // 4. dw_h = round(h)^T @ round(dz) : A(m=i, k=b) = h[b, i],
  //    B(k=b, n) = dz[b, n]
  err = strided_mm<float, float, T>(h, 1, H, dzx, H3, 1, dwh, H, 3 * H, B, s);
  return static_cast<int>(err);
}

}  // namespace

// Plain C entry point, loaded with ctypes. w_is_bf16 selects the compute
// dtype of w_h (1 = bf16, 0 = f32). Returns the cudaError_t of the launches
// (0 on success); a bad argument returns cudaErrorInvalidValue.
extern "C" int cifg_cell_bwd(const float* zx, const void* w_h, int w_is_bf16,
                             const float* h, const float* c,
                             const float* dh_new, const float* dc_new,
                             float* dzx, float* dh, float* dc, float* dwh,
                             int B, int H, void* stream) {
  if (B < 1 || H < 1 || (B + kTile - 1) / kTile > 65535 ||
      (H + kTile - 1) / kTile > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_is_bf16) {
    return launch<__nv_bfloat16>(
        zx, static_cast<const __nv_bfloat16*>(w_h), h, c, dh_new, dc_new,
        dzx, dh, dc, dwh, B, H, s);
  }
  return launch<float>(zx, static_cast<const float*>(w_h), h, c, dh_new,
                       dc_new, dzx, dh, dc, dwh, B, H, s);
}
