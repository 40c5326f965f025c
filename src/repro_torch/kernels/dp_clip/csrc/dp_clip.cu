// DP-FedAvg per-client clip kernels for Hopper (sm_90a).
//
// Replaces src/repro/kernels/dp_clip/dp_clip.py::sumsq (_sumsq_kernel) and
// ::clip_accumulate_2d (_clip_acc_kernel). Entry points over f32 leaves of
// any length n (no (256, 128) tile padding: the tail is masked):
//
//   dp_sumsq_chunk(leaves[C][L], sizes[L], C, L, S, scales[C], ss_in[C])
//       -> ss[c] = ((ss_in[c] + sumsq(leaf c,0)) + sumsq(leaf c,1)) + ...,
//          norm[c] = sqrt(ss[c]),
//          factor[c] = min(1, S / max(norm[c], 1e-12)) * scale[c]
//   dp_sumsq(x, n) -> sumsq(x), the C = 1, L = 1 call of the same kernels
//   dp_clip_accumulate(acc, deltas[0..C), f[0..C), out, C, n)
//                  -> out = ((acc + f_0 d_0) + f_1 d_1) + ... + f_C-1 d_C-1
//
// The sum of squares takes a whole chunk of C clients, all L leaves of each,
// in one wrapper call of two kernels: stage 1 reduces fixed segments of every
// leaf of every slot to partials; stage 2 (one block per slot) folds each
// leaf's partials, adds the leaves in order from +0.0 (Python's sum over the
// sorted leaves) and forms the norm and the clip factor in its epilogue. The
// factor is bitwise what core.clipping.clip_factor and the mask product give
// on the card: torch divides a Python scalar by a tensor as a reciprocal
// then a product, so 1/x correctly rounded (__frcp_rn) then a rounded
// product with S (__fmul_rn), with torch.clamp's NaN rule; the norm is
// __fsqrt_rn. A client of more than 40 leaves takes one launch per 40
// leaves: each starts from the sums the one before left (ss_in; +0.0 for
// the first), which is the same sequence of additions, and only the last
// forms the norm and the factor.
//
// The accumulate folds a whole chunk of C clients (1 <= C <= 32) in one
// pass, slot by slot in order, which is reduction.slot_fold's association;
// C = 1 is one client's acc + f * delta.
//
// Determinism. The round sum must be the same bits whatever the cohort is
// cut into, so a client's sum of squares is taken in an order fixed by the
// leaf sizes alone: never by C, the slot's position, the pointers'
// alignment or the card. A leaf of n elements is cut into nb(n) segments
// (blocks); thread t of segment s adds x^2 of the groups of four elements
// u = 256 s + t + 256 nb k, k = 0, 1, ..., each element in index order
// (__fmul_rn then __fadd_rn; elements past n count as +0, which leaves the
// sum unchanged); each block reduces its threads by a fixed shared-memory
// tree into its own partial; stage 2 adds a leaf's partials the same way.
// A group is one 16-byte load where the leaf is 16-byte aligned and four
// loads otherwise, added in the same order. No atomics.
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
// operations per element, so memory bounds them. For a chunk of 16 clients
// of the paper's model (1,278,720 f32 each) the sum of squares reads
// 81.8 MB (24.4 us at 3.35 TB/s); the accumulate of C clients moves
// (8 + 4C) n + 4C bytes: at the largest leaf (the 10240 x 96 embedding,
// 983,040 f32) 11.8 MB for C = 1 (3.5 us), 70.8 MB for a chunk of 16
// (21.1 us). Folding the chunk in one pass reads acc and writes out once
// per chunk, not once per client (2.7x fewer bytes per client at C = 16).
// The sum of squares keeps four 16-byte loads in flight per thread; the
// accumulate's loads are 16-byte float4 where n % 4 == 0 and every pointer
// is 16-byte aligned (a scalar tail otherwise); each thread owns one float4
// and issues the load of acc and of the first 8 deltas (the only one for
// C = 1) before it waits for the factors, so its loads are in flight
// together.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1024;        // segments of one leaf, at most
constexpr int kUnroll = 4;              // groups of four in flight a thread
constexpr long long kGroupsPerBlock = (long long)kThreads * kUnroll;
constexpr int kMaxPtrs = 416;           // slot x leaf pointers a launch
constexpr int kMaxLeaves = 40;          // leaves a slot

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

// The chunk's leaves and the block map, passed by value as a kernel
// parameter (no host-to-device copy; a CUDA graph captures them with the
// launch; within the 4 KB parameter limit). Leaf l of slot c is
// p[c * L + l]; its segments are blocks first[l] .. first[l + 1] - 1 of the
// slot's first[L] blocks.
struct Chunk {
  const float* p[kMaxPtrs];
  long long n[kMaxLeaves];
  int first[kMaxLeaves + 1];
  int C, L;
};

__device__ __forceinline__ float add_sq(float acc, float v) {
  return __fadd_rn(acc, __fmul_rn(v, v));
}

// Group u (elements 4u .. 4u + 3) of a leaf of n elements, 0 past n.
__device__ __forceinline__ float4 load_group(const float* x, long long n,
                                             bool vec, long long u) {
  if (vec && 4 * u + 3 < n)
    return __ldg(reinterpret_cast<const float4*>(x) + u);
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    v[i] = 4 * u + i < n ? __ldg(x + 4 * u + i) : 0.0f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

__global__ void __launch_bounds__(kThreads)
sumsq_stage1(const Chunk a, float* __restrict__ partials) {
  __shared__ float s[kThreads];
  const int per_slot = a.first[a.L];
  const int c = blockIdx.x / per_slot;
  const int r = blockIdx.x - c * per_slot;
  int l = 0;
  while (a.first[l + 1] <= r) ++l;
  const long long seg = r - a.first[l];
  const long long nb = a.first[l + 1] - a.first[l];
  const float* x = a.p[c * a.L + l];
  const long long n = a.n[l];
  const long long groups = (n + 3) / 4;
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const long long step = nb * kThreads;
  float acc = 0.0f;
  for (long long u = seg * kThreads + threadIdx.x; u < groups;
       u += kUnroll * step) {
    float4 v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k)
      v[k] = u + k * step < groups ? load_group(x, n, vec, u + k * step)
                                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      acc = add_sq(acc, v[k].x);
      acc = add_sq(acc, v[k].y);
      acc = add_sq(acc, v[k].z);
      acc = add_sq(acc, v[k].w);
    }
  }
  s[threadIdx.x] = acc;
  block_tree_sum(s);
  if (threadIdx.x == 0) partials[blockIdx.x] = s[0];
}

// One block per slot: each leaf's partials by the fixed tree, the leaves
// added in order from +0.0, then the norm and the clip factor.
__global__ void __launch_bounds__(kThreads)
sumsq_stage2(const Chunk a, const float* __restrict__ partials,
             float clip_norm, const float* __restrict__ scales,
             const float* ss_in, float* ss_out, float* __restrict__ norm_out,
             float* __restrict__ factor_out) {
  __shared__ float s[kThreads];
  const int c = blockIdx.x;
  const int per_slot = a.first[a.L];
  // ss_out may be ss_in: every thread reads it here, thread 0 writes it last
  float ss = ss_in != nullptr ? ss_in[c] : 0.0f;
  for (int l = 0; l < a.L; ++l) {
    const float* part = partials + (long long)c * per_slot + a.first[l];
    const int count = a.first[l + 1] - a.first[l];
    float acc = 0.0f;
    for (int i = threadIdx.x; i < count; i += kThreads)
      acc = __fadd_rn(acc, part[i]);
    s[threadIdx.x] = acc;
    block_tree_sum(s);
    ss = __fadd_rn(ss, s[0]);
    __syncthreads();                     // s[0] is read before the next leaf
  }
  if (threadIdx.x != 0) return;
  ss_out[c] = ss;
  if (norm_out == nullptr) return;
  // torch.sqrt; torch.clamp(min=1e-12), which keeps a NaN; clip_norm / x as
  // torch computes it, reciprocal(x) * clip_norm; torch.clamp(max=1.0)
  const float norm = __fsqrt_rn(ss);
  const float lo = isnan(norm) ? norm : fmaxf(norm, 1e-12f);
  const float q = __fmul_rn(__frcp_rn(lo), clip_norm);
  float f = isnan(q) ? q : fminf(q, 1.0f);
  if (scales != nullptr) f = __fmul_rn(f, scales[c]);
  norm_out[c] = norm;
  factor_out[c] = f;
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

// segments of a leaf of n elements: one per 1024 groups of four, 1 to
// kMaxBlocks
int stage1_blocks(long long n) {
  long long b = ((n + 3) / 4 + kGroupsPerBlock - 1) / kGroupsPerBlock;
  if (b < 1) b = 1;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return static_cast<int>(b);
}

int sumsq_chunk(const float* const* leaves, const long long* sizes, int C,
                int L, float clip_norm, const float* scales,
                const float* ss_in, float* partials, long long partials_len,
                float* ss, float* norms, float* factors, cudaStream_t s) {
  if (C < 1 || L < 1 || L > kMaxLeaves || (long long)C * L > kMaxPtrs ||
      leaves == nullptr || sizes == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Chunk a{};
  a.C = C;
  a.L = L;
  a.first[0] = 0;
  for (int l = 0; l < L; ++l) {
    if (sizes[l] < 0) return static_cast<int>(cudaErrorInvalidValue);
    a.n[l] = sizes[l];
    a.first[l + 1] = a.first[l] + stage1_blocks(sizes[l]);
  }
  for (int i = 0; i < C * L; ++i) a.p[i] = leaves[i];
  const long long blocks = (long long)C * a.first[L];
  if (partials_len < blocks || blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  sumsq_stage1<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(a,
                                                                  partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sumsq_stage2<<<C, kThreads, 0, s>>>(a, partials, clip_norm, scales, ss_in,
                                      ss, norms, factors);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each returns the cudaError_t of
// its launches (0 on success); a bad argument returns cudaErrorInvalidValue.

// leaves is a host array of C * L device pointers, slot-major (leaf l of
// slot c at c * L + l), sizes a host array of the L leaf lengths (the same
// for every slot); scales a device array of C floats or null (no mask);
// ss_in a device array of C floats to start the sums from, or null (+0.0),
// and it may be ss; partials a device array of partials_len >= C *
// (segments of a slot) floats; ss a device array of C floats; norms and
// factors device arrays of C floats, or both null (the sums only).
// C * L <= 416, L <= 40.
extern "C" int dp_sumsq_chunk(const float* const* leaves,
                              const long long* sizes, int C, int L,
                              float clip_norm, const float* scales,
                              const float* ss_in, float* partials,
                              long long partials_len, float* ss,
                              float* norms, float* factors, void* stream) {
  if ((norms == nullptr) != (factors == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return sumsq_chunk(leaves, sizes, C, L, clip_norm, scales, ss_in, partials,
                     partials_len, ss, norms, factors,
                     static_cast<cudaStream_t>(stream));
}

// The sum of squares of one leaf: dp_sumsq_chunk at C = 1, L = 1, without
// the epilogue. partials must hold kMaxBlocks floats.
extern "C" int dp_sumsq(const float* x, long long n, float* partials,
                        float* out, void* stream) {
  return sumsq_chunk(&x, &n, 1, 1, 0.0f, nullptr, nullptr, partials,
                     kMaxBlocks, out, nullptr, nullptr,
                     static_cast<cudaStream_t>(stream));
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
