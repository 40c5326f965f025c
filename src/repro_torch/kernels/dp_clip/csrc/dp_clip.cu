// DP-FedAvg per-client clip kernels for Hopper (sm_90a).
//
// Replaces src/repro/kernels/dp_clip/dp_clip.py::sumsq (_sumsq_kernel) and
// ::clip_accumulate_2d (_clip_acc_kernel). Two entry points over one flat
// f32 leaf of any length n (no (256, 128) tile padding: the tail is masked):
//
//   dp_sumsq(x, n)                       -> sum of x^2
//   dp_clip_accumulate(acc, delta, f, n) -> out = acc + f * delta
//
// Determinism. The round sum must be the same bits whatever the cohort is
// cut into, so the sum of squares is taken in a fixed order: stage 1 runs a
// number of blocks fixed by n alone (never by the card); each thread adds
// its grid-strided elements in index order, each block reduces its threads
// by a fixed shared-memory tree and writes one partial; stage 2 is one block
// that adds the partials the same way. No atomics.
//
// The accumulate computes __fmul_rn then __fadd_rn, two rounded operations,
// so nvcc cannot contract them into one FMA: that is the reference's
// arithmetic (acc + factor * delta in f32) and makes the kernel bitwise
// equal to its plain PyTorch version. factor is read from device memory (it
// is computed on the card from the sum of squares; reading it back to the
// host would stop the host once per client). A factor of 0 over finite
// garbage in delta adds exactly +-0, leaving acc unchanged.
//
// What bounds them on an H100: both are streaming passes with one or two
// reads and at most one write per element and a few operations each, so
// memory bounds them. At the largest leaf of the paper's model (the
// 10240 x 96 embedding, 983,040 f32) sumsq reads 3.93 MB (1.17 us at
// 3.35 TB/s) and the accumulate moves 11.8 MB (3.5 us). The design reads
// and writes each element once, coalesced (consecutive threads on
// consecutive elements); vector loads and folding a chunk of clients in one
// pass are left for later.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1024;        // stage-1 partials (ops.MAX_BLOCKS)
constexpr long long kPerBlock = 4LL * kThreads;  // elements per block, at least

// Fixed-shape tree sum of kThreads values in shared memory; result in s[0].
__device__ __forceinline__ void block_tree_sum(float* s) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    __syncthreads();
    if (tid < stride) s[tid] = s[tid] + s[tid + stride];
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
sumsq_stage1(const float* __restrict__ x, long long n,
             float* __restrict__ partials) {
  __shared__ float s[kThreads];
  const long long step = (long long)gridDim.x * kThreads;
  float acc = 0.0f;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += step) {
    const float v = x[i];
    acc = __fadd_rn(acc, __fmul_rn(v, v));
  }
  s[threadIdx.x] = acc;
  block_tree_sum(s);
  if (threadIdx.x == 0) partials[blockIdx.x] = s[0];
}

__global__ void __launch_bounds__(kThreads)
sumsq_stage2(const float* __restrict__ partials, int count,
             float* __restrict__ out) {
  __shared__ float s[kThreads];
  float acc = 0.0f;
  for (int i = threadIdx.x; i < count; i += kThreads) {
    acc = __fadd_rn(acc, partials[i]);
  }
  s[threadIdx.x] = acc;
  block_tree_sum(s);
  if (threadIdx.x == 0) *out = s[0];
}

__global__ void __launch_bounds__(kThreads)
clip_accumulate_kernel(const float* acc, const float* __restrict__ delta,
                       const float* __restrict__ factor, float* out,
                       long long n) {
  const float f = *factor;
  const long long step = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += step) {
    out[i] = __fadd_rn(acc[i], __fmul_rn(f, delta[i]));
  }
}

int stage1_blocks(long long n) {
  long long b = (n + kPerBlock - 1) / kPerBlock;
  if (b < 1) b = 1;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return static_cast<int>(b);
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each returns the cudaError_t of
// its launches (0 on success); a bad argument returns cudaErrorInvalidValue.
// partials must hold kMaxBlocks floats.
extern "C" int dp_sumsq(const float* x, long long n, float* partials,
                        float* out, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = stage1_blocks(n);
  sumsq_stage1<<<blocks, kThreads, 0, s>>>(x, n, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sumsq_stage2<<<1, kThreads, 0, s>>>(partials, blocks, out);
  return static_cast<int>(cudaGetLastError());
}

// out may alias acc (each element is read and written by one thread).
extern "C" int dp_clip_accumulate(const float* acc, const float* delta,
                                  const float* factor, float* out,
                                  long long n, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long blocks = (n + kPerBlock - 1) / kPerBlock;
  if (blocks > 8 * 132) blocks = 8 * 132;   // grid-stride beyond that
  clip_accumulate_kernel<<<static_cast<int>(blocks), kThreads, 0, s>>>(
      acc, delta, factor, out, n);
  return static_cast<int>(cudaGetLastError());
}
