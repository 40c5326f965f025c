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
// and a row with no valid key gives 0 (the l == 0 guard).
//
// Layout: q (B, Sq, H, hd) and k, v (B, Sk, KV, hd), read through their
// batch, sequence and head strides (the last dim contiguous), bf16 or f32;
// head h reads KV head h / (H / KV), so nothing is transposed, repeated or
// padded. The output is (B, Sq, H, hd) in q's dtype, written through its
// strides. hd may be any size (zamba2's is 80, stablelm-12b's 160); B and H
// up to 65535.
//
// What bounds it on an H100: at zamba2-2.7b's prefill (B 4, S 512, 32 heads,
// hd 80, causal, bf16) one call reads q, k and v (31 MB) and writes o
// (10 MB), 12.5 us at 3.35 TB/s, and its causal half of QK^T and PV is
// 5.4 GFLOP, 5.4 us at the 989 TFLOP/s of the bf16 tensor cores: the bytes
// set the bound.
//
// Two kernels, chosen by the inputs' type in the entry point (a dispatch on
// the dtype, not a fallback: each type has exactly one kernel):
//
// bf16 (the served path): flash_fwd_tc_kernel, on the tensor cores. A block
// of 4 warps owns 64 query rows, 16 per warp. Q's tile is copied to shared
// memory once and its A fragments (ldmatrix) stay in registers. K and V
// come in 64-key tiles, kept in bf16 in shared memory in two stages: the
// next tile's 16-byte cp.async.cg copies are in flight while the current
// one computes. S = Q K^T and O += P V run through
// mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 (K's B fragments by
// ldmatrix, V's by ldmatrix.trans); the row max and sum stay in registers,
// reduced across the 4 threads that share a row of the accumulator; P is
// rounded to bf16 in registers and fed back as the A operand of PV (the f32
// C fragment of m16n8k16 has the bf16 A fragment's layout), so neither S
// nor P touches shared memory; O (16 x hd_pad f32 per warp) stays in
// registers across the KV tiles and is divided by l once at the end.
// Shared-memory rows are padded to hd_pad + 8 bf16 (hd_pad = hd rounded up
// to 16, the pad columns zero-filled), which keeps ldmatrix free of bank
// conflicts for every hd_pad (a 16-byte-aligned row of 4 (2m + 1) words).
// Tiles wholly above the diagonal or wholly before the window are skipped;
// the element mask runs only on tiles that cross the diagonal, the
// window's edge or Sk; query tiles are launched heaviest first so that the
// causal triangle leaves no tail of idle SMs. Where hd % 8 or an address or
// stride is not a multiple of 16 bytes, the tiles are copied with plain
// 2-byte loads instead of cp.async (the same kernel and arithmetic).
//
// Numerics of the bf16 kernel: QK^T of bf16 inputs with f32 accumulation is
// exact in its products, only the order of the sums differs; P is rounded to
// bf16 before PV, which the TPU kernel (and this file's f32 kernel) keep in
// f32, as the reference's plain attention rounds its probabilities to the
// compute dtype before PV. The result stays within 2e-2 of the plain
// version, the tolerance of the bf16 output's own rounding.
//
// f32: flash_fwd_f32_kernel, float32 FMAs on the CUDA cores, fed from
// shared memory (no bf16 tensor-core form computes f32 inputs to 1e-5), for
// every hd. A block of 8 warps owns 64 query rows (8 per warp) and at most
// 128 output columns: the head dim is cut into n_os = ceil(hd / 128) output
// slices, one block per (query tile, slice), so n_os = 1 up to hd 128. For
// each 64-key tile it forms QK^T over slices of 64 head-dim columns of Q
// and K, staged in shared memory one slice at a time as float32 (zero past
// hd, so a partial slice adds exactly 0; K rows padded to 65 floats, so the
// lanes hit distinct banks), one fmaf chain over d per score; lanes walk
// keys for QK^T and the head dim for PV, and each warp's 8 rows of
// probabilities go through shared memory that only that warp touches. Every
// block of a query tile forms the same scores in the same order, so the
// online-softmax statistics agree across its slices; each writes its own
// columns of O. Only the checks of the port against its CPU path run it;
// the served path is bf16.
//
// bf16 with hd > 128 (the wide route; hd <= 128 never takes it):
// flash_fwd_tc_wide_kernel, the output slices and QK^T head-dim slices of
// the f32 kernel with the tensor-core kernel's mma.sync fragments, masks and
// softmax, the tiles copied with cp.async and waited for at once (one
// stage). QK^T is formed n_os times: at hd 160 the products are 1.5 times
// what one pass needs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;                        // query rows per block
constexpr int kBK = 64;                        // keys per KV tile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = kBQ / kWarps;     // 8
constexpr int kKeysPerLane = kBK / 32;         // 2
constexpr int kMaxHd = 128;
constexpr int kMaxDJ = kMaxHd / 32;            // head-dim columns per lane

struct Strides {
  long long b, s, h;
};

// float32 (see the top of the file): the output columns [o0, o0 + ow) of
// one query tile, QK^T over head-dim slices of kDS columns. blockIdx.x =
// query tile * n_os + output slice.
constexpr int kDS = 64;                        // QK^T head-dim slice

inline int f32_smem_floats() {
  return kBQ * kDS + kBK * (kDS + 1) + kBK * kMaxHd + kBQ * kBK;
}

__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     Strides qs, Strides ks, Strides vs, Strides os, int Sq,
                     int Sk, int H, int KV, int hd, int ow, int n_os,
                     int causal, int window, float scale) {
  extern __shared__ float smem[];
  constexpr int ldk = kDS + 1;
  float* Qs = smem;                  // [kBQ][kDS]
  float* Ks = Qs + kBQ * kDS;        // [kBK][ldk]
  float* Vs = Ks + kBK * ldk;        // [kBK][ow]
  float* Ps = Vs + kBK * kMaxHd;     // [kBQ][kBK], rows private to a warp

  const int q0 = (blockIdx.x / n_os) * kBQ;
  const int o0 = (blockIdx.x % n_os) * ow;
  const int ow_valid = min(ow, hd - o0);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r0 = warp * kRowsPerWarp;

  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + kvh * ks.h;
  const float* vb = v + b * vs.b + kvh * vs.h;

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
    float s[kRowsPerWarp][kKeysPerLane];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
      for (int c = 0; c < kKeysPerLane; ++c) s[i][c] = 0.0f;
    for (int d0 = 0; d0 < hd; d0 += kDS) {
      const int dn = min(kDS, hd - d0);
      __syncthreads();   // the previous slice's Q and K consumed
      for (int i = tid; i < kBQ * kDS; i += kThreads) {
        const int r = i / kDS, d = i - r * kDS;
        Qs[i] = q0 + r < Sq && d < dn ? qb[(q0 + r) * qs.s + d0 + d] : 0.0f;
        Ks[r * ldk + d] =
            kt0 + r < Sk && d < dn ? kb[(kt0 + r) * ks.s + d0 + d] : 0.0f;
      }
      __syncthreads();
      for (int d = 0; d < dn; ++d) {
        float kv[kKeysPerLane];
#pragma unroll
        for (int c = 0; c < kKeysPerLane; ++c)
          kv[c] = Ks[(lane + 32 * c) * ldk + d];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          const float qv = Qs[(r0 + i) * kDS + d];
#pragma unroll
          for (int c = 0; c < kKeysPerLane; ++c)
            s[i][c] = fmaf(qv, kv[c], s[i][c]);
        }
      }
    }

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

    __syncthreads();     // the previous tile's V consumed
    for (int i = tid; i < kBK * ow; i += kThreads) {
      const int j = i / ow, d = i - j * ow;
      Vs[i] = kt0 + j < Sk && d < ow_valid ? vb[(kt0 + j) * vs.s + o0 + d]
                                           : 0.0f;
    }
    __syncthreads();

    for (int j = 0; j < kBK; ++j) {
      float pv[kRowsPerWarp];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) pv[i] = Ps[(r0 + i) * kBK + j];
#pragma unroll
      for (int dj = 0; dj < kMaxDJ; ++dj) {
        const int d = lane + 32 * dj;
        if (d < ow_valid) {
          const float vv = Vs[j * ow + d];
#pragma unroll
          for (int i = 0; i < kRowsPerWarp; ++i)
            acc[i][dj] = fmaf(pv[i], vv, acc[i][dj]);
        }
      }
    }
    __syncwarp();        // Ps is rewritten by the next tile
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int qi = q0 + r0 + i;
    if (qi >= Sq) continue;
    const float inv = 1.0f / (l[i] == 0.0f ? 1.0f : l[i]);
    float* orow = o + b * os.b + qi * os.s + h * os.h + o0;
#pragma unroll
    for (int dj = 0; dj < kMaxDJ; ++dj) {
      const int d = lane + 32 * dj;
      if (d < ow_valid) orow[d] = acc[i][dj] * inv;
    }
  }
}

int launch_f32(const void* q, const void* k, const void* v, void* o,
               const long long* st, int B, int Sq, int Sk, int H, int KV,
               int hd, int causal, int window, cudaStream_t stream) {
  const int bytes = f32_smem_floats() * static_cast<int>(sizeof(float));
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int n_os = (hd + kMaxHd - 1) / kMaxHd;
  const int ow = (hd + n_os - 1) / n_os;
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  const dim3 grid((Sq + kBQ - 1) / kBQ * n_os, H, B);
  flash_fwd_f32_kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), qs, ks, vs, os,
      Sq, Sk, H, KV, hd, ow, n_os, causal, window,
      1.0f / sqrtf(static_cast<float>(hd)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

namespace {
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kBQ = 64;                  // query rows per block, 16 per warp
constexpr int kBK = 64;                  // keys per KV tile
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;               // K/V tiles in flight

// bf16 elements per shared-memory row: hd_pad + 8, so that the 8 rows one
// ldmatrix phase reads fall on 8 distinct 16-byte bank groups
__host__ __device__ constexpr int row_len(int hd_pad) { return hd_pad + 8; }
__host__ __device__ constexpr int smem_bytes(int hd_pad) {
  return (kBQ + 2 * kStages * kBK) * row_len(hd_pad) *
         static_cast<int>(sizeof(bf16));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; src_bytes 0 writes zeros and
// reads nothing
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned addr,
                                              unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col): bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x by the SFU (relative error about 2^-22; 2^-inf = 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Copy ROWS rows of hd elements, row r at src + r * row_stride, into
// dst[r][0:hd_pad] (row_len(HD_PAD) apart): rows >= rows_valid and columns
// >= hd become 0. vec: 16-byte cp.async (hd % 8 == 0, 16-byte aligned
// rows); else plain 2-byte loads and stores. src's row 0 is in range.
template <int HD_PAD, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long row_stride,
                                          int rows_valid, int hd, bool vec) {
  constexpr int LD = row_len(HD_PAD);
  constexpr int kChunks = HD_PAD / 8;
  if (vec) {
    for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
      const int r = i / kChunks, c = i - r * kChunks;
      const bool in = r < rows_valid && c * 8 < hd;
      const bf16* g = in ? src + r * row_stride + c * 8 : src;
      cp_async16(smem_addr(dst + r * LD + c * 8), g, in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * HD_PAD; i += kThreads) {
      const int r = i / HD_PAD, d = i - r * HD_PAD;
      dst[r * LD + d] = r < rows_valid && d < hd ? src[r * row_stride + d]
                                                 : __float2bfloat16_rn(0.0f);
    }
  }
}

struct Strides {
  long long b, s, h;
};

// flags: bit 0 — q, k, v take 16-byte copies; bit 1 — o takes 4-byte
// stores of column pairs
template <int HD_PAD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o,
                    Strides qs, Strides ks, Strides vs, Strides os, int Sq,
                    int Sk, int H, int KV, int hd, int causal, int window,
                    float scale_log2, int flags) {
  constexpr int LD = row_len(HD_PAD);
  constexpr int NK = HD_PAD / 16;        // k-steps of Q K^T
  constexpr int ND = HD_PAD / 8;         // n-tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);    // [kBQ][LD]
  bf16* Ks = Qs + kBQ * LD;                         // [kStages][kBK][LD]
  bf16* Vs = Ks + kStages * kBK * LD;               // [kStages][kBK][LD]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;  // heaviest tiles first
  const int kvh = h / (H / KV);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;               // accumulator row (and row + 8)
  const int tig = lane & 3;              // accumulator column pair
  const bool vec = flags & 1;

  const bf16* kb = k + b * ks.b + kvh * ks.h;
  const bf16* vb = v + b * vs.b + kvh * vs.h;

  // keys this tile of queries can see: [k_lo, k_hi)
  const int q_last = min(q0 + kBQ, Sq) - 1;
  const int k_hi = causal ? min(Sk, q_last + 1) : Sk;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kt_first = (k_lo / kBK) * kBK;
  const int n_tiles = k_hi > kt_first ? (k_hi - kt_first + kBK - 1) / kBK : 0;

  // copy groups, oldest first: Q with K of tile 0, V of tile 0, then per
  // tile i + 1 its K (issued before tile i's QK^T) and its V (issued after
  // tile i's softmax), so that QK^T waits only for K and PV only for V
  load_tile<HD_PAD, kBQ>(Qs, q + b * qs.b + h * qs.h + q0 * qs.s, qs.s,
                         Sq - q0, hd, vec);
  if (n_tiles > 0) {
    load_tile<HD_PAD, kBK>(Ks, kb + kt_first * ks.s, ks.s, Sk - kt_first, hd,
                           vec);
  }
  cp_async_commit();
  if (n_tiles > 0) {
    load_tile<HD_PAD, kBK>(Vs, vb + kt_first * vs.s, vs.s, Sk - kt_first, hd,
                           vec);
  }
  cp_async_commit();

  unsigned qf[NK][4];
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY};   // rows g and g + 8, raw scores
  float l[2] = {0.0f, 0.0f};             // this thread's part of the sum

  for (int it = 0; it < n_tiles; ++it) {
    const int kt0 = kt_first + it * kBK;
    const int st = it & 1;
    const bool more = it + 1 < n_tiles;
    const int nk = kt0 + kBK;            // the next tile's first key
    if (more) {
      // K's other stage was last read by tile i - 1's QK^T, before the
      // barrier that preceded its PV
      load_tile<HD_PAD, kBK>(Ks + (st ^ 1) * kBK * LD, kb + nk * ks.s, ks.s,
                             Sk - nk, hd, vec);
      cp_async_commit();
      cp_async_wait<2>();                // K of this tile (and Q) landed
    } else {
      cp_async_wait<1>();
    }
    __syncthreads();

    if (it == 0) {
      // Q's A fragments: lanes 0-15 address rows 0-15 at column 0 of a
      // k-step, lanes 16-31 the same rows at column 8
      const bf16* qrow = Qs + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
#pragma unroll
      for (int kk = 0; kk < NK; ++kk)
        ldsm_x4(smem_addr(qrow + kk * 16), qf[kk]);
    }

    // S = Q K^T: 8 n-tiles of 8 keys. One x4 ldmatrix gives the B
    // fragments of two n-tiles (keys +0..7 and +8..15) at one k-step.
    const bf16* Kt = Ks + st * kBK * LD;
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        unsigned bk[4];
        const int key = jp * 16 + (lane & 7) + ((lane >> 4) << 3);
        ldsm_x4(smem_addr(Kt + key * LD + kk * 16 + ((lane >> 3) & 1) * 8),
                bk);
        mma_bf16(s[2 * jp], qf[kk], bk[0], bk[1]);
        mma_bf16(s[2 * jp + 1], qf[kk], bk[2], bk[3]);
      }
    }

    // mask only tiles that cross Sk, the diagonal or the window's edge
    const bool edge = kt0 + kBK > Sk || (causal && kt0 + kBK - 1 > q0) ||
                      (window > 0 && kt0 <= q0 + kBQ - 1 - window);
    if (edge) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = kt0 + 8 * j + 2 * tig + (e & 1);
          const int qi = q0 + warp * 16 + g + 8 * (e >> 1);
          const bool ok = kj < Sk && (!causal || kj <= qi) &&
                          (window <= 0 || kj > qi - window);
          if (!ok) s[j][e] = -INFINITY;
        }
    }

    // online softmax on the raw scores, the 4 threads of a row reducing
    // its max; p = 2^(s * scale_log2 - m * scale_log2), one FFMA and one
    // ex2 per score
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * rr], s[j][2 * rr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[rr], mx);
      // no valid key yet in this row: every p is 0, nothing to rescale
      const float ms = m_new == -INFINITY ? 0.0f : m_new * scale_log2;
      const float alpha = fast_exp2(m[rr] * scale_log2 - ms);
      m[rr] = m_new;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 2 * rr; e < 2 * rr + 2; ++e) {
          s[j][e] = fast_exp2(fmaf(s[j][e], scale_log2, -ms));
          sum += s[j][e];
        }
      l[rr] = l[rr] * alpha + sum;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        acc[n][2 * rr] *= alpha;
        acc[n][2 * rr + 1] *= alpha;
      }
    }

    if (more) {
      // V's other stage was last read by tile i - 1's PV, before the
      // barrier above
      load_tile<HD_PAD, kBK>(Vs + (st ^ 1) * kBK * LD, vb + nk * vs.s, vs.s,
                             Sk - nk, hd, vec);
      cp_async_commit();
      cp_async_wait<2>();                // V of this tile landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // O += P V: P's bf16 A fragment for keys 16t..16t+15 is the C fragment
    // of n-tiles 2t and 2t + 1; V's B fragments by ldmatrix.trans, two
    // n-tiles of 8 dims per x4
    const bf16* Vt = Vs + st * kBK * LD;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const unsigned pa[4] = {pack_bf16x2(s[2 * t][0], s[2 * t][1]),
                              pack_bf16x2(s[2 * t][2], s[2 * t][3]),
                              pack_bf16x2(s[2 * t + 1][0], s[2 * t + 1][1]),
                              pack_bf16x2(s[2 * t + 1][2], s[2 * t + 1][3])};
      const bf16* vrow =
          Vt + (16 * t + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
          (lane >> 4) * 8;
#pragma unroll
      for (int np = 0; np < ND / 2; ++np) {
        unsigned bv[4];
        ldsm_x4_trans(smem_addr(vrow + np * 16), bv);
        mma_bf16(acc[2 * np], pa, bv[0], bv[1]);
        mma_bf16(acc[2 * np + 1], pa, bv[2], bv[3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float sum = l[rr];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = sum > 0.0f ? 1.0f / sum : 0.0f;
    const int qi = q0 + warp * 16 + g + 8 * rr;
    if (qi >= Sq) continue;
    bf16* orow = o + b * os.b + qi * os.s + h * os.h;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int d = 8 * n + 2 * tig;
      const float v0 = acc[n][2 * rr] * inv, v1 = acc[n][2 * rr + 1] * inv;
      if (d + 1 < hd && (flags & 2)) {
        *reinterpret_cast<__nv_bfloat162*>(orow + d) =
            __floats2bfloat162_rn(v0, v1);
      } else {
        if (d < hd) orow[d] = __float2bfloat16_rn(v0);
        if (d + 1 < hd) orow[d + 1] = __float2bfloat16_rn(v1);
      }
    }
  }
}

template <int HD_PAD>
int launch(const void* q, const void* k, const void* v, void* o,
           const long long* st, int B, int Sq, int Sk, int H, int KV, int hd,
           int causal, int window, cudaStream_t stream) {
  constexpr int bytes = smem_bytes(HD_PAD);
  // set once per instantiation, so that a launch inside a CUDA-graph
  // capture, after a warm-up call, sets no attribute
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_tc_kernel<HD_PAD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  auto al = [](const void* p, uintptr_t a) {
    return reinterpret_cast<uintptr_t>(p) % a == 0;
  };
  bool vec = hd % 8 == 0 && al(q, 16) && al(k, 16) && al(v, 16);
  for (int i = 0; i < 9; ++i) vec = vec && st[i] % 8 == 0;
  const bool pairs = hd % 2 == 0 && al(o, 4) && st[9] % 2 == 0 &&
                     st[10] % 2 == 0 && st[11] % 2 == 0;
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  const dim3 grid(H, B, (Sq + kBQ - 1) / kBQ);
  flash_fwd_tc_kernel<HD_PAD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), qs, ks, vs, os, Sq,
      Sk, H, KV, hd, causal, window,
      1.4426950408889634f / sqrtf(static_cast<float>(hd)),
      (vec ? 1 : 0) | (pairs ? 2 : 0));
  return static_cast<int>(cudaGetLastError());
}

// hd > 128, bf16 (see the top of the file): the output columns [o0, o0 +
// ow_valid) of one query tile, OW_PAD (a multiple of 16, at most 128) wide;
// QK^T over head-dim slices of kDS columns. blockIdx.z = (query tile * n_os
// + output slice), heaviest query tiles first.
constexpr int kDS = 64;
__host__ __device__ constexpr int wide_smem_bytes(int ow_pad) {
  return (2 * kBQ * row_len(kDS) + kBK * row_len(ow_pad)) *
         static_cast<int>(sizeof(bf16));
}

template <int OW_PAD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_tc_wide_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ o,
                         Strides qs, Strides ks, Strides vs, Strides os,
                         int Sq, int Sk, int H, int KV, int hd, int n_os,
                         int causal, int window, float scale_log2,
                         int flags) {
  constexpr int LDS = row_len(kDS);
  constexpr int LDV = row_len(OW_PAD);
  constexpr int ND = OW_PAD / 8;         // n-tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);    // [kBQ][LDS]
  bf16* Ks = Qs + kBQ * LDS;                        // [kBK][LDS]
  bf16* Vs = Ks + kBK * LDS;                        // [kBK][LDV]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int zt = gridDim.z - 1 - blockIdx.z;
  const int q0 = zt / n_os * kBQ;
  const int o0 = zt % n_os * OW_PAD;
  const int ow_valid = min(OW_PAD, hd - o0);
  const int kvh = h / (H / KV);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const bool vec = flags & 1;

  const bf16* qb = q + b * qs.b + h * qs.h + q0 * qs.s;
  const bf16* kb = k + b * ks.b + kvh * ks.h;
  const bf16* vb = v + b * vs.b + kvh * vs.h + o0;

  const int q_last = min(q0 + kBQ, Sq) - 1;
  const int k_hi = causal ? min(Sk, q_last + 1) : Sk;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.0f, 0.0f};

  for (int kt0 = (k_lo / kBK) * kBK; kt0 < k_hi; kt0 += kBK) {
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
    for (int d0 = 0; d0 < hd; d0 += kDS) {
      __syncthreads();   // the previous slice's Q and K consumed
      load_tile<kDS, kBQ>(Qs, qb + d0, qs.s, Sq - q0, min(kDS, hd - d0), vec);
      load_tile<kDS, kBK>(Ks, kb + kt0 * ks.s + d0, ks.s, Sk - kt0,
                          min(kDS, hd - d0), vec);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      const bf16* qrow = Qs + (warp * 16 + (lane & 15)) * LDS + (lane >> 4) * 8;
#pragma unroll
      for (int kk = 0; kk < kDS / 16; ++kk) {
        unsigned qf[4];
        ldsm_x4(smem_addr(qrow + kk * 16), qf);
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          unsigned bk[4];
          const int key = jp * 16 + (lane & 7) + ((lane >> 4) << 3);
          ldsm_x4(smem_addr(Ks + key * LDS + kk * 16 + ((lane >> 3) & 1) * 8),
                  bk);
          mma_bf16(s[2 * jp], qf, bk[0], bk[1]);
          mma_bf16(s[2 * jp + 1], qf, bk[2], bk[3]);
        }
      }
    }

    const bool edge = kt0 + kBK > Sk || (causal && kt0 + kBK - 1 > q0) ||
                      (window > 0 && kt0 <= q0 + kBQ - 1 - window);
    if (edge) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = kt0 + 8 * j + 2 * tig + (e & 1);
          const int qi = q0 + warp * 16 + g + 8 * (e >> 1);
          const bool ok = kj < Sk && (!causal || kj <= qi) &&
                          (window <= 0 || kj > qi - window);
          if (!ok) s[j][e] = -INFINITY;
        }
    }

#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * rr], s[j][2 * rr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[rr], mx);
      const float ms = m_new == -INFINITY ? 0.0f : m_new * scale_log2;
      const float alpha = fast_exp2(m[rr] * scale_log2 - ms);
      m[rr] = m_new;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 2 * rr; e < 2 * rr + 2; ++e) {
          s[j][e] = fast_exp2(fmaf(s[j][e], scale_log2, -ms));
          sum += s[j][e];
        }
      l[rr] = l[rr] * alpha + sum;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        acc[n][2 * rr] *= alpha;
        acc[n][2 * rr + 1] *= alpha;
      }
    }

    __syncthreads();     // the previous tile's V consumed
    load_tile<OW_PAD, kBK>(Vs, vb + kt0 * vs.s, vs.s, Sk - kt0, ow_valid, vec);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const unsigned pa[4] = {pack_bf16x2(s[2 * t][0], s[2 * t][1]),
                              pack_bf16x2(s[2 * t][2], s[2 * t][3]),
                              pack_bf16x2(s[2 * t + 1][0], s[2 * t + 1][1]),
                              pack_bf16x2(s[2 * t + 1][2], s[2 * t + 1][3])};
      const bf16* vrow =
          Vs + (16 * t + (lane & 7) + ((lane >> 3) & 1) * 8) * LDV +
          (lane >> 4) * 8;
#pragma unroll
      for (int np = 0; np < ND / 2; ++np) {
        unsigned bv[4];
        ldsm_x4_trans(smem_addr(vrow + np * 16), bv);
        mma_bf16(acc[2 * np], pa, bv[0], bv[1]);
        mma_bf16(acc[2 * np + 1], pa, bv[2], bv[3]);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float sum = l[rr];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = sum > 0.0f ? 1.0f / sum : 0.0f;
    const int qi = q0 + warp * 16 + g + 8 * rr;
    if (qi >= Sq) continue;
    bf16* orow = o + b * os.b + qi * os.s + h * os.h + o0;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int d = 8 * n + 2 * tig;
      const float v0 = acc[n][2 * rr] * inv, v1 = acc[n][2 * rr + 1] * inv;
      if (d + 1 < ow_valid && (flags & 2)) {
        *reinterpret_cast<__nv_bfloat162*>(orow + d) =
            __floats2bfloat162_rn(v0, v1);
      } else {
        if (d < ow_valid) orow[d] = __float2bfloat16_rn(v0);
        if (d + 1 < ow_valid) orow[d + 1] = __float2bfloat16_rn(v1);
      }
    }
  }
}

template <int OW_PAD>
int launch_wide(const void* q, const void* k, const void* v, void* o,
                const long long* st, int B, int Sq, int Sk, int H, int KV,
                int hd, int n_os, int causal, int window,
                cudaStream_t stream) {
  constexpr int bytes = wide_smem_bytes(OW_PAD);   // under 48 KB: no opt-in
  auto al = [](const void* p, uintptr_t a) {
    return reinterpret_cast<uintptr_t>(p) % a == 0;
  };
  bool vec = hd % 8 == 0 && al(q, 16) && al(k, 16) && al(v, 16);
  for (int i = 0; i < 9; ++i) vec = vec && st[i] % 8 == 0;
  const bool pairs = hd % 2 == 0 && al(o, 4) && st[9] % 2 == 0 &&
                     st[10] % 2 == 0 && st[11] % 2 == 0;
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  const dim3 grid(H, B, (Sq + kBQ - 1) / kBQ * n_os);
  flash_fwd_tc_wide_kernel<OW_PAD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), qs, ks, vs, os, Sq,
      Sk, H, KV, hd, n_os, causal, window,
      1.4426950408889634f / sqrtf(static_cast<float>(hd)),
      (vec ? 1 : 0) | (pairs ? 2 : 0));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc
}  // namespace

// Plain C entry point, loaded with ctypes. strides holds 12 element strides:
// (batch, sequence, head) of q, k, v and o in that order. is_bf16 selects
// the element type (1 = bf16, 0 = f32) of all four tensors, and with it the
// kernel: bf16 runs on the tensor cores (hd > 128 on their wide route),
// f32 on the CUDA cores. Returns the cudaError_t of the launch (0
// on success); shapes the kernels do not take return cudaErrorInvalidValue.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o,
                                   const long long* strides, int is_bf16,
                                   int B, int Sq, int Sk, int H, int KV,
                                   int hd, int causal, int window,
                                   void* stream) {
  const int n_os = (hd + kMaxHd - 1) / kMaxHd;   // output slices
  if (B < 1 || B > 65535 || Sq < 1 || Sk < 1 || H < 1 || H > 65535 ||
      KV < 1 || H % KV || hd < 1 || window < 0 ||
      (long long)((Sq + tc::kBQ - 1) / tc::kBQ) * n_os > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16) {
    return launch_f32(q, k, v, o, strides, B, Sq, Sk, H, KV, hd, causal,
                      window, s);
  }
  if (hd > kMaxHd) {
    // each slice ceil(hd / n_os) columns, rounded up to 16: 80 to 128
    switch (((hd + n_os - 1) / n_os + 15) / 16 * 16) {
#define FLASH_WIDE_CASE(P)                                                   \
  case P:                                                                    \
    return tc::launch_wide<P>(q, k, v, o, strides, B, Sq, Sk, H, KV, hd,     \
                              n_os, causal, window, s);
      FLASH_WIDE_CASE(80)
      FLASH_WIDE_CASE(96)
      FLASH_WIDE_CASE(112)
      FLASH_WIDE_CASE(128)
#undef FLASH_WIDE_CASE
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch ((hd + 15) / 16 * 16) {
#define FLASH_TC_CASE(P)                                                    \
  case P:                                                                   \
    return tc::launch<P>(q, k, v, o, strides, B, Sq, Sk, H, KV, hd, causal, \
                         window, s);
    FLASH_TC_CASE(16)
    FLASH_TC_CASE(32)
    FLASH_TC_CASE(48)
    FLASH_TC_CASE(64)
    FLASH_TC_CASE(80)
    FLASH_TC_CASE(96)
    FLASH_TC_CASE(112)
    FLASH_TC_CASE(128)
#undef FLASH_TC_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
