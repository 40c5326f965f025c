// Flash attention forward for Hopper (sm_90a): causal, sliding-window or
// bidirectional, with grouped KV heads.
//
// Replaces src/repro/kernels/flash_attention/flash_attention.py::
// flash_attention_bhsd (the Pallas kernel _flash_kernel) together with its
// wrapper's layout work (ops.py: the (B,S,H,hd) -> (B,H,S,hd) transposes,
// jnp.repeat of the KV heads and the padding of S to 128). For one
// (batch b, head h, tile of query rows) it walks the KV tiles with the
// online softmax: running max m, normaliser l and the output accumulator,
// all float32,
//
//   s_ij = (q_i . k_j) * scale,   scale = 1/sqrt(hd)
//   key j is valid for query i when j < Sk, and j <= i if causal, and
//   j > i - window if window > 0
//   o_i  = sum_j exp(s_ij - m_i) v_j / sum_j exp(s_ij - m_i) over valid j
//
// and a row with no valid key gives 0 (the l == 0 -> 1 guard).
//
// Layout: q (B, Sq, H, hd) and k, v (B, Sk, KV, hd), read through their
// batch, sequence and head strides (the last dim contiguous), bf16 or f32;
// head h reads KV head h / (H / KV), so nothing is transposed, repeated or
// padded. The output is (B, Sq, H, hd), contiguous, in q's dtype.
//
// What bounds it on an H100: at zamba2-2.7b's prefill (B 4, S 512, 32 heads,
// hd 80, causal, bf16) one call reads q, k and v (31 MB) and writes o
// (10 MB), about 12.5 us at 3.35 TB/s, and its causal half of QK^T and PV
// is 5.4 GFLOP, about 5.5 us at the 989 TFLOP/s of the bf16 tensor cores:
// the bytes set the bound.
//
// What this simple design does about it: each q, k and v element is read
// from device memory once per (query tile, KV tile) pair that needs it; the
// scores and probabilities never leave the SM. A block of 8 warps owns 64
// query rows (8 per warp); it stages the 64-row Q tile and one 64-key K and
// V tile at a time in shared memory as float32. Lanes walk keys for
// QK^T (K rows padded to hd + 1 floats, so the lanes hit distinct banks)
// and the head dim for PV; the row statistics stay in registers, reduced
// with warp shuffles, and each warp's 8 rows of probabilities go through
// shared memory that only that warp touches. KV tiles wholly above the
// diagonal (causal) or wholly before the window are skipped, not masked.
// head_dim may be any size up to 128 (zamba2's is 80).
//
// Where it stands: the products are float32 FMAs on the CUDA cores, fed
// from shared memory, so the kernel is far from that bound. mma/wgmma on
// bf16 tiles, with TMA loads, is the redesign.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;                        // query rows per block
constexpr int kBK = 64;                        // keys per KV tile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = kBQ / kWarps;     // 8
constexpr int kKeysPerLane = kBK / 32;         // 2
constexpr int kMaxHd = 128;
constexpr int kMaxDJ = kMaxHd / 32;            // head-dim columns per lane

inline int smem_floats(int hd) {
  return kBQ * hd + kBK * (hd + 1) + kBK * hd + kBQ * kBK;
}

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct Strides {
  long long b, s, h;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, Strides qs,
                 Strides ks, Strides vs, Strides os, int Sq, int Sk, int H,
                 int KV, int hd, int causal, int window, float scale) {
  extern __shared__ float smem[];
  const int ldk = hd + 1;
  float* Qs = smem;                  // [kBQ][hd]
  float* Ks = Qs + kBQ * hd;         // [kBK][ldk]
  float* Vs = Ks + kBK * ldk;        // [kBK][hd]
  float* Ps = Vs + kBK * hd;         // [kBQ][kBK], rows private to a warp

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r0 = warp * kRowsPerWarp;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;

  for (int i = tid; i < kBQ * hd; i += kThreads) {
    const int r = i / hd, d = i - r * hd;
    Qs[i] = q0 + r < Sq ? to_f32<T>(qb[(q0 + r) * qs.s + d]) : 0.0f;
  }

  // keys this tile of queries can see: [k_lo, k_hi)
  const int q_last = min(q0 + kBQ, Sq) - 1;
  const int k_hi = causal ? min(Sk, q_last + 1) : Sk;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kMaxDJ];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int dj = 0; dj < kMaxDJ; ++dj) acc[i][dj] = 0.0f;
  }

  for (int kt0 = (k_lo / kBK) * kBK; kt0 < k_hi; kt0 += kBK) {
    __syncthreads();   // Q staged; the previous K and V tiles consumed
    for (int i = tid; i < kBK * hd; i += kThreads) {
      const int j = i / hd, d = i - j * hd;
      const int kj = kt0 + j;
      const bool in = kj < Sk;
      Ks[j * ldk + d] = in ? to_f32<T>(kb[kj * ks.s + d]) : 0.0f;
      Vs[j * hd + d] = in ? to_f32<T>(vb[kj * vs.s + d]) : 0.0f;
    }
    __syncthreads();

    // scores: lanes walk keys lane and lane + 32, the warp's 8 rows share
    // each K load
    float s[kRowsPerWarp][kKeysPerLane];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
      for (int c = 0; c < kKeysPerLane; ++c) s[i][c] = 0.0f;
    for (int d = 0; d < hd; ++d) {
      float kv[kKeysPerLane];
#pragma unroll
      for (int c = 0; c < kKeysPerLane; ++c) kv[c] = Ks[(lane + 32 * c) * ldk + d];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float qv = Qs[(r0 + i) * hd + d];
#pragma unroll
        for (int c = 0; c < kKeysPerLane; ++c) s[i][c] = fmaf(qv, kv[c], s[i][c]);
      }
    }

    // online softmax, one row at a time across the warp
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int qi = q0 + r0 + i;
      bool ok[kKeysPerLane];
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < kKeysPerLane; ++c) {
        const int kj = kt0 + lane + 32 * c;
        ok[c] = kj < Sk && (!causal || kj <= qi) &&
                (window <= 0 || kj > qi - window);
        s[i][c] *= scale;
        if (ok[c]) mx = fmaxf(mx, s[i][c]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      // no valid key yet in this row: nothing to rescale, every p is 0
      const float alpha = m_new == -INFINITY ? 1.0f : expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < kKeysPerLane; ++c) {
        const float p = ok[c] ? expf(s[i][c] - m_new) : 0.0f;
        Ps[(r0 + i) * kBK + lane + 32 * c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int dj = 0; dj < kMaxDJ; ++dj) acc[i][dj] *= alpha;
    }
    __syncwarp();

    // acc += P V: lanes walk the head dim, the warp reads its own P rows
    for (int j = 0; j < kBK; ++j) {
      float pv[kRowsPerWarp];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) pv[i] = Ps[(r0 + i) * kBK + j];
#pragma unroll
      for (int dj = 0; dj < kMaxDJ; ++dj) {
        const int d = lane + 32 * dj;
        if (d < hd) {
          const float vv = Vs[j * hd + d];
#pragma unroll
          for (int i = 0; i < kRowsPerWarp; ++i)
            acc[i][dj] = fmaf(pv[i], vv, acc[i][dj]);
        }
      }
    }
    __syncwarp();      // Ps is rewritten by the next tile
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int qi = q0 + r0 + i;
    if (qi >= Sq) continue;
    const float inv = 1.0f / (l[i] == 0.0f ? 1.0f : l[i]);
    T* orow = o + b * os.b + qi * os.s + h * os.h;
#pragma unroll
    for (int dj = 0; dj < kMaxDJ; ++dj) {
      const int d = lane + 32 * dj;
      if (d < hd) orow[d] = from_f32<T>(acc[i][dj] * inv);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o,
           const long long* st, int B, int Sq, int Sk, int H, int KV, int hd,
           int causal, int window, cudaStream_t stream) {
  const int bytes = smem_floats(hd) * static_cast<int>(sizeof(float));
  // raise the block's shared-memory limit to the most asked for so far (one
  // card per process), so that a launch inside a CUDA-graph capture, after
  // a warm-up call, sets no attribute
  static int configured = 0;
  if (bytes > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = bytes;
  }
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), qs, ks, vs, os, Sq, Sk,
      H, KV, hd, causal, window, 1.0f / sqrtf(static_cast<float>(hd)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, loaded with ctypes. strides holds 12 element strides:
// (batch, sequence, head) of q, k, v and o in that order. is_bf16 selects
// the element type (1 = bf16, 0 = f32) of all four tensors. Returns the
// cudaError_t of the launch (0 on success); shapes the kernel does not take
// return cudaErrorInvalidValue.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o,
                                   const long long* strides, int is_bf16,
                                   int B, int Sq, int Sk, int H, int KV,
                                   int hd, int causal, int window,
                                   void* stream) {
  if (B < 1 || B > 65535 || Sq < 1 || Sk < 1 || H < 1 || H > 65535 ||
      KV < 1 || H % KV || hd < 1 || hd > kMaxHd || window < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch<__nv_bfloat16>(q, k, v, o, strides, B, Sq, Sk, H, KV, hd,
                                 causal, window, s);
  }
  return launch<float>(q, k, v, o, strides, B, Sq, Sk, H, KV, hd, causal,
                       window, s);
}
