// DP-FedAvg per-client clip kernels for Hopper (sm_90a).
//
// Replaces src/repro/kernels/dp_clip/dp_clip.py::sumsq (_sumsq_kernel) and
// ::clip_accumulate_2d (_clip_acc_kernel). Two entry points over one flat
// f32 leaf of any length n (no (256, 128) tile padding: the tail is masked):
//
//   dp_sumsq(x, n) -> sum of x^2
//   dp_clip_accumulate(acc, deltas[0..C), f[0..C), out, C, n)
//                  -> out = ((acc + f_0 d_0) + f_1 d_1) + ... + f_C-1 d_C-1
//
// The accumulate folds a whole chunk of C clients (1 <= C <= 32) in one
// pass, slot by slot in order, which is reduction.slot_fold's association;
// C = 1 is one client's acc + f * delta.
//
// Determinism. The round sum must be the same bits whatever the cohort is
// cut into, so the sum of squares is taken in a fixed order: stage 1 runs a
// number of blocks fixed by n alone (never by the card); each thread adds
// its grid-strided elements in index order, each block reduces its threads
// by a fixed shared-memory tree and writes one partial; stage 2 is one block
// that adds the partials the same way. No atomics.
//
// Every step of the accumulate is __fmul_rn then __fadd_rn, two rounded
// operations, so nvcc cannot contract them into one FMA: that is the
// reference's arithmetic (acc + factor * delta in f32). Each element is
// folded by one thread in slot order, so one launch over C slots gives the
// same bits as C launches of one slot, as C chunks of any sizes, and as the
// plain version. The factors are a device array (computed on the card from
// the sums of squares; reading them back would stop the host once per
// client); each block loads them into shared memory once. A factor of 0
// over finite garbage in delta adds exactly +-0, leaving acc unchanged.
//
// What bounds them on an H100: both are streaming passes with a few
// operations per element, so memory bounds them. At the largest leaf of the
// paper's model (the 10240 x 96 embedding, 983,040 f32) sumsq reads 3.93 MB
// (1.17 us at 3.35 TB/s); the accumulate of C clients moves (8 + 4C) n + 4C
// bytes: 11.8 MB for C = 1 (3.5 us), 70.8 MB for a chunk of 16 (21.1 us).
// Folding the chunk in one pass reads acc and writes out once per chunk,
// not once per client (2.7x fewer bytes per client at C = 16). The
// loads are 16-byte float4 where n % 4 == 0 and every pointer is 16-byte
// aligned (a scalar tail otherwise); each thread owns one float4 and issues
// the load of acc and of the first 8 deltas (the only one for C = 1) before
// it waits for the factors, so its loads are in flight together.

#include <cuda_runtime.h>
#include <stdint.h>

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

constexpr int kMaxChunk = 32;           // clients per accumulate launch
constexpr int kAccThreads = 256;        // threads per accumulate block

// The chunk's delta pointers, passed by value as a kernel parameter (no
// host-to-device copy; a CUDA graph captures them with the launch).
struct Deltas {
  const float* p[kMaxChunk];
};

__device__ __forceinline__ float fold1(float a, float f, float x) {
  return __fadd_rn(a, __fmul_rn(f, x));
}
__device__ __forceinline__ float4 fold1(float4 a, float f, float4 x) {
  return make_float4(fold1(a.x, f, x.x), fold1(a.y, f, x.y),
                     fold1(a.z, f, x.z), fold1(a.w, f, x.w));
}

// Per thread, one unit: a float4 (T = float4) or one element (T = float)
// at offset i of acc, of every delta and of out; kGroup delta loads are
// issued together.
template <typename T, int kGroup>
struct Unit {
  T a, x[kGroup];

  // acc and the first kGroup deltas, issued before the factors are needed
  __device__ __forceinline__ void load(const float* acc, const Deltas& d,
                                       int C, long long i) {
    a = reinterpret_cast<const T*>(acc)[i];
#pragma unroll
    for (int g = 0; g < kGroup; ++g)
      if (g < C) x[g] = __ldg(reinterpret_cast<const T*>(d.p[g]) + i);
  }

  // the fold in slot order, kGroup delta loads in flight at a time
  __device__ __forceinline__ void fold(const Deltas& d, const float* fs,
                                       float* out, int C, long long i) {
    for (int c0 = 0; c0 < C; c0 += kGroup) {
      if (c0 > 0) {
#pragma unroll
        for (int g = 0; g < kGroup; ++g)
          if (c0 + g < C)
            x[g] = __ldg(reinterpret_cast<const T*>(d.p[c0 + g]) + i);
      }
#pragma unroll
      for (int g = 0; g < kGroup; ++g)
        if (c0 + g < C) a = fold1(a, fs[c0 + g], x[g]);
    }
    reinterpret_cast<T*>(out)[i] = a;
  }
};

// units [0, n4) are float4s, units [n4, n4 + tail) the scalar elements
// 4 n4 + (unit - n4); one unit per thread. kGroup is 1 for one client (few
// registers: a full SM of threads in flight) and 8 for a chunk.
template <int kGroup>
__global__ void __launch_bounds__(kAccThreads)
clip_accumulate_kernel(const float* acc, const Deltas d,
                       const float* __restrict__ factors, float* out, int C,
                       long long n4, long long tail) {
  __shared__ float fs[kMaxChunk];
  if (threadIdx.x < C) fs[threadIdx.x] = factors[threadIdx.x];
  const long long u = (long long)blockIdx.x * kAccThreads + threadIdx.x;
  const long long e = 4 * n4 + (u - n4);     // the scalar element, u >= n4
  Unit<float4, kGroup> v4;
  Unit<float, kGroup> v1;
  if (u < n4) {
    v4.load(acc, d, C, u);
  } else if (u < n4 + tail) {
    v1.load(acc, d, C, e);
  }
  __syncthreads();                           // the factors are in fs
  if (u < n4) {
    v4.fold(d, fs, out, C, u);
  } else if (u < n4 + tail) {
    v1.fold(d, fs, out, C, e);
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

// deltas is a host array of C device pointers, each to n floats; factors a
// device array of C floats. out may alias acc (each element is read and
// written by one thread); no delta may alias out.
extern "C" int dp_clip_accumulate(const float* acc,
                                  const float* const* deltas,
                                  const float* factors, float* out, int C,
                                  long long n, void* stream) {
  if (n < 0 || C < 1 || C > kMaxChunk || deltas == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  Deltas d{};
  bool aligned = n % 4 == 0 && reinterpret_cast<uintptr_t>(acc) % 16 == 0 &&
                 reinterpret_cast<uintptr_t>(out) % 16 == 0;
  for (int c = 0; c < C; ++c) {
    d.p[c] = deltas[c];
    aligned = aligned && reinterpret_cast<uintptr_t>(deltas[c]) % 16 == 0;
  }
  const long long n4 = aligned ? n / 4 : 0;
  const long long tail = n - 4 * n4;
  const long long blocks = (n4 + tail + kAccThreads - 1) / kAccThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 1) {
    clip_accumulate_kernel<1><<<static_cast<unsigned>(blocks), kAccThreads,
                                0, s>>>(acc, d, factors, out, C, n4, tail);
  } else {
    clip_accumulate_kernel<8><<<static_cast<unsigned>(blocks), kAccThreads,
                                0, s>>>(acc, d, factors, out, C, n4, tail);
  }
  return static_cast<int>(cudaGetLastError());
}
