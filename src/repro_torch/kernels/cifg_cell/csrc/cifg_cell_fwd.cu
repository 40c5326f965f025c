// CIFG-LSTM recurrence forward for Hopper (sm_90a): a whole sequence in one
// launch, w_h resident on chip for every step.
//
// Replaces src/repro/kernels/cifg_cell/cifg_cell.py::cell_fwd (the Pallas
// kernel _fwd_kernel / _gates), scanned over time as the reference's
// cifg_states does. Each step, given the hoisted input projection
// zx_t = x_t @ w_x + b_gates:
//
//   z   = zx_t + h @ w_h          product in the compute dtype, f32 sum
//   f   = sigmoid(z_f + 1)        forget bias 1
//   o   = sigmoid(z_o),  g = tanh(z_g)
//   c'  = f * c + (1 - f) * g     CIFG: i = 1 - f
//   h'  = o * tanh(c')
//
// Layout: the model's own, row-major and contiguous: zx (S, B, 3H) f32,
// h0 and c0 (B, H) f32, w_h (H, 3H) in the compute dtype (bf16 or f32),
// gate columns [f | o | g]; outputs hs and cs (S, B, H) f32, the state after
// every step. One step is this kernel at S = 1.
//
// A client axis: C independent recurrences in one launch, each with its
// own inputs and outputs (zx (C, S, B, 3H), h0 and c0 (C, B, H), hs and cs
// (C, S, B, H)) and either its own w_h (C, H, 3H) — a cohort chunk in
// training, where each client holds its own parameters (the reference
// vmaps cell_fwd over the chunk, which adds a grid axis of clients) — or
// one w_h shared by all (client stride 0). gridDim.z = C on both routes;
// every cluster offsets its pointers by its client and loads its client's
// slice of w_h. The one-client entry is the C = 1 call of the same kernel.
//
// What bounds it on an H100: a training sequence (S 16, B 10, H 256, bf16)
// moves about 1.2 MB (zx, w_h, hs, cs) for 0.06 GFLOP: about 0.4 us of
// memory traffic. The recurrence is serial, so the real limit is S times one
// step's latency: a chain of tensor-core products, the gate math and one
// exchange of h between the blocks that share the hidden columns.
//
// The design: one thread-block cluster of 8 CTAs per tile of 16 batch rows.
// CTA r owns hidden columns [r*CW, (r+1)*CW), CW = ceil(H / 8) <= 32, and
// with them the f, o and g columns of w_h, so the gate math and the c update
// stay inside the CTA (c lives in registers for all S steps). Each CTA
// loads its slice of w_h once (H x 96 values, padded): in bf16 every warp
// keeps its 16 gate columns as mma A fragments in registers (64 registers
// at H 256); in f32 the slice stays in shared memory (96 KB at H 256). Per
// step:
//   * bf16: z^T = w_h^T h^T on the tensor cores (mma.sync m16n8k16, f32
//     accumulate), the batch on the n side: 6 warps x 2 n-tiles, the k-steps
//     in two interleaved accumulator chains added in a fixed order;
//     f32: 6 warps x 32 lanes, each thread one gate column and 8 rows, k
//     ascending, one FMA per term, w from shared memory, h as broadcast
//     float4 (3 loads per 8 FMAs; the old kernel made 5 per 6);
//   * zx_{t+1} is loaded into registers while step t's products run;
//   * the gates, c' and h' for the CTA's (column, row) pairs; h' and c' go to
//     hs[t] and cs[t]; h' (rounded to the compute dtype, as the reference
//     casts h) is stored into every peer CTA's next h buffer through
//     distributed shared memory. h is double-buffered, so each step ends in
//     one cluster barrier.
// Registers are held to two CTAs per SM (__launch_bounds__), so that the
// 16 clusters of a 256-row decode tick are resident at once. That is the
// route for H <= 256 (8 CTAs x 32 columns).
//
// Wider cells (H > 256) take the wide route, a second kernel of this file
// (cifg_seq_wide_kernel): a cluster of 16 CTAs (a non-portable size) per 16
// batch rows, CTA r owning hidden columns [r*CW, (r+1)*CW), CW = ceil(H/16),
// in groups of 32. h is exchanged through global memory: each step reads
// the state h_{t-1} (h0, or hs[t-1], which the peers wrote before the
// step's cluster barrier) in k-tiles of 64 through L2, rounded to the
// compute dtype as it is loaded, and c_{t-1} is read back from cs[t-1] by
// the thread that wrote it. w_h is resident where the CTA's slice fits in
// shared memory (one group of columns: H <= 512; 104 KB bf16, 192 KB f32 at
// H 512) and streamed beyond that: a 64-row tile of the group's gate columns
// loaded from global memory (L2) beside each tile of h. Where the slice
// fits, resident is the faster form (PERF.md has both times). Products:
// bf16 mma.sync m16n8k16 with A = w^T from ldmatrix.trans, one accumulator
// chain over k ascending; f32 FMAs, k ascending. One cluster barrier a
// step. The route is chosen by H alone, never by B or S.
//
// Where it stands (chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W): a
// step of the H <= 256 route costs about 2 us; at S = 1 loading the slice
// of w_h dominates.
// Removal builds time a step without one of its parts: -DCIFG_SKIP_PRODUCT,
// -DCIFG_SKIP_GATES, -DCIFG_SKIP_EXCHANGE or -DCIFG_SKIP_BARRIER compile
// that part out (the results are then wrong; only the time counts). The
// script is repro_torch/kernels/removal.py, the split is in PERF.md.
//
// Determinism: each output element is a fixed sequence of operations on its
// own row's data: the same k-steps in the same accumulator chains (bf16), or
// k ascending with one FMA per term (f32), whatever B is and wherever the
// row sits, on either route. So a row's result does not depend on the
// batch, hs[t] of an S-step launch equals the state after a launch over the
// first t+1 steps, and equals t+1 chained S = 1 launches, bit for bit. The
// same holds across clients: a client's results are the same bits whatever
// C is and wherever the client sits (a cluster touches its client's data
// only).
//
// Occupancy: the clusters of a launch are C x ceil(B / 16); a cluster sits
// inside one GPC, so a launch with more clusters than the card holds at
// once (cifg_cell_fwd_max_clusters) runs in waves.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCluster = 8;              // CTAs per cluster (portable size)
constexpr int kRows = 16;                // batch rows per cluster
constexpr int kColsCta = 32;             // hidden columns per CTA, padded
constexpr int kM = 3 * kColsCta;         // gate columns per CTA
constexpr int kWarps = kM / 16;          // one 16-column m-tile per warp
constexpr int kThreads = 32 * kWarps;    // 192
constexpr int kMaxH = kCluster * kColsCta;   // 256
constexpr int kMaxKSteps = kMaxH / 16;
constexpr int kPairs = kColsCta * kRows;     // (column, row) pairs per CTA
constexpr int kPairsPerThread = (kPairs + kThreads - 1) / kThreads;  // 3
constexpr int kZld = kRows + 1;          // z staging row stride (floats)
constexpr int kWld = kM + 8;             // bf16 w slice row stride (elements)
constexpr int kLoadBatch = 16;           // w_h loads in flight per thread
constexpr int kChains = 2;               // bf16: interleaved k-step chains

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n\t"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ uint32_t peer_addr(uint32_t local, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(local), "r"(rank));
  return out;
}

__device__ __forceinline__ void st_peer(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" :: "r"(addr), "f"(v)
               : "memory");
}

__device__ __forceinline__ void st_peer(uint32_t addr, __nv_bfloat16 v) {
  asm volatile("st.shared::cluster.u16 [%0], %1;"
               :: "r"(addr), "h"(__bfloat16_as_ushort(v)) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// Shared memory of one CTA, K padded to a multiple of 16:
//   bf16: w slice [KP][kWld] bf16, h [2][kRows][KP + 8] bf16, z [kM][kZld];
//   f32:  w slice [KP][kM] f32,   h [2][KP][kRows] f32 (transposed), z.
template <typename T>
__host__ __device__ constexpr int w_bytes(int KP) {
  return sizeof(T) == 2 ? KP * kWld * 2 : KP * kM * 4;
}
template <typename T>
__host__ __device__ constexpr int h_buf_elems(int KP) {
  return sizeof(T) == 2 ? kRows * (KP + 8) : KP * kRows;
}
template <typename T>
__host__ __device__ constexpr int smem_bytes(int KP) {
  return w_bytes<T>(KP) + 2 * h_buf_elems<T>(KP) * static_cast<int>(sizeof(T))
         + kM * kZld * 4;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
cifg_seq_kernel(const float* __restrict__ zx, const float* __restrict__ h0,
                const float* __restrict__ c0, const T* __restrict__ w_h,
                long long w_client, float* __restrict__ hs,
                float* __restrict__ cs, int S, int B, int H) {
  constexpr bool kBf16 = sizeof(T) == 2;
  // this cluster's client
  {
    const long long z = blockIdx.z, BH = (long long)B * H;
    zx += z * S * BH * 3;
    h0 += z * BH;
    c0 += z * BH;
    w_h += z * w_client;
    hs += z * S * BH;
    cs += z * S * BH;
  }
  extern __shared__ __align__(16) unsigned char smem[];
  const int KP = (H + 15) & ~15;
  T* ws = reinterpret_cast<T*>(smem);
  T* hb = reinterpret_cast<T*>(smem + w_bytes<T>(KP));
  float* zs = reinterpret_cast<float*>(
      smem + w_bytes<T>(KP) + 2 * h_buf_elems<T>(KP) * sizeof(T));
  const int hbuf = h_buf_elems<T>(KP);
  const int hld = KP + 8;                // bf16 h row stride

  const int rank = static_cast<int>(cluster_rank());
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int CW = (H + kCluster - 1) / kCluster;
  const int col0 = rank * CW;
  const int row0 = blockIdx.y * kRows;
  const int nrows = min(kRows, B - row0);
  const long long H3 = 3LL * H;

  // the CTA's slice of w_h: local gate column m = g * 32 + jj is global
  // column g * H + col0 + jj; padding (k >= H, jj >= CW, col >= H) is 0.
  // Every thread keeps kLoadBatch loads in flight before it stores: 16-byte
  // loads where the columns and w_h allow them, else one value per load.
  constexpr int kVec = 16 / sizeof(T);
  if (CW % kVec == 0 && H % kVec == 0 &&
      reinterpret_cast<uintptr_t>(w_h) % 16 == 0) {
    constexpr int kChunks = kM / kVec;           // 16-byte chunks per row
    for (int base = tid; base < KP * kChunks; base += kThreads * kLoadBatch) {
      uint4 v[kLoadBatch];
#pragma unroll
      for (int u = 0; u < kLoadBatch; ++u) {
        const int i = base + u * kThreads;
        const int k = i / kChunks, m = (i - k * kChunks) * kVec;
        const int g = m / kColsCta, jj = m - g * kColsCta;
        const int col = col0 + jj;
        v[u] = (k < H && jj < CW && col < H)
                   ? *reinterpret_cast<const uint4*>(
                         w_h + k * H3 + (long long)g * H + col)
                   : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kLoadBatch; ++u) {
        const int i = base + u * kThreads;
        const int k = i / kChunks, m = (i - k * kChunks) * kVec;
        if (k < KP)
          *reinterpret_cast<uint4*>(&ws[k * (kBf16 ? kWld : kM) + m]) = v[u];
      }
    }
  } else {
    const int m = tid % kM;
    const int g = m / kColsCta, jj = m - g * kColsCta;
    const int col = col0 + jj;
    const bool in = jj < CW && col < H;
    const T* src = w_h + (long long)g * H + col;
    constexpr int kRowStep = kThreads / kM;      // 2
    for (int k0 = tid / kM; k0 < KP; k0 += kRowStep * kLoadBatch) {
      T v[kLoadBatch];
#pragma unroll
      for (int u = 0; u < kLoadBatch; ++u) {
        const int k = k0 + u * kRowStep;
        v[u] = (in && k < H) ? src[k * H3] : from_f32<T>(0.0f);
      }
#pragma unroll
      for (int u = 0; u < kLoadBatch; ++u) {
        const int k = k0 + u * kRowStep;
        if (k < KP) ws[k * (kBf16 ? kWld : kM) + m] = v[u];
      }
    }
  }
  // both h buffers zeroed (padding rows and columns stay 0), then h0 rounded
  // to the compute dtype into buffer 0
  for (int i = tid; i < 2 * hbuf; i += kThreads) hb[i] = from_f32<T>(0.0f);
  __syncthreads();
  for (int i = tid; i < nrows * H; i += kThreads) {
    const int b = i / H, k = i - b * H;
    const T v = from_f32<T>(h0[(long long)(row0 + b) * H + k]);
    hb[kBf16 ? b * hld + k : k * kRows + b] = v;
  }

  // the thread's (column, row) pairs: c in registers, zx prefetched
  int pj[kPairsPerThread], pb[kPairsPerThread];
  bool live[kPairsPerThread];
  float creg[kPairsPerThread];
  float zcur[kPairsPerThread][3], znext[kPairsPerThread][3];
#pragma unroll
  for (int i = 0; i < kPairsPerThread; ++i) {
    const int p = tid + i * kThreads;
    pj[i] = p % kColsCta;
    pb[i] = p / kColsCta;
    live[i] = p < kPairs && pj[i] < CW && col0 + pj[i] < H && pb[i] < nrows;
    const long long r = row0 + pb[i];
    creg[i] = live[i] ? c0[r * H + col0 + pj[i]] : 0.0f;
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      zcur[i][g] =
          live[i] ? zx[r * H3 + (long long)g * H + col0 + pj[i]] : 0.0f;
      znext[i][g] = 0.0f;
    }
  }
  __syncthreads();

  // bf16: the warp's 16 gate columns of w_h^T as mma A fragments
  const int nks = KP / 16;
  const int m0 = warp * 16;
  uint32_t afr[kBf16 ? kMaxKSteps : 1][4];
  if constexpr (kBf16) {
#pragma unroll
    for (int ks = 0; ks < kMaxKSteps; ++ks) {
      if (ks < nks) {
        const int k = ks * 16 + (lane & 7) + ((lane >> 4) << 3);
        const int m = m0 + ((lane >> 3) & 1) * 8;
        ldmatrix_x4_trans(afr[ks], &ws[k * kWld + m]);
      }
    }
  }
  // every CTA of the cluster is running before any peer store
  cluster_sync();

  const int g8 = lane >> 2, t4 = lane & 3;
  for (int t = 0; t < S; ++t) {
    const int cur = t & 1;
    if (t + 1 < S) {
      const float* zrow = zx + (long long)(t + 1) * B * H3;
#pragma unroll
      for (int i = 0; i < kPairsPerThread; ++i) {
#pragma unroll
        for (int g = 0; g < 3; ++g)
          if (live[i])
            znext[i][g] = zrow[(row0 + pb[i]) * H3 + (long long)g * H +
                               col0 + pj[i]];
      }
    }

    const T* hcur = hb + cur * hbuf;
    if constexpr (kBf16) {
      float acc[2][kChains][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < kChains; ++e)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[n][e][i] = 0.0f;
#ifndef CIFG_SKIP_PRODUCT
#pragma unroll
      for (int ks = 0; ks < kMaxKSteps; ++ks) {
        if (ks < nks) {
          uint32_t bf[4];
          const int n = (lane & 7) + ((lane >> 4) << 3);
          ldmatrix_x4(bf, &hcur[n * hld + ks * 16 + ((lane >> 3) & 1) * 8]);
          mma_bf16(acc[0][ks % kChains], afr[ks], bf[0], bf[1]);
          mma_bf16(acc[1][ks % kChains], afr[ks], bf[2], bf[3]);
        }
      }
#endif
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int m = m0 + g8 + (i >= 2 ? 8 : 0);
          const int b = n * 8 + 2 * t4 + (i & 1);
          zs[m * kZld + b] = acc[n][0][i] + acc[n][1][i];
        }
    } else {
      const int m = tid % kM;
      const int half = tid / kM;
      float acc[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) acc[r] = 0.0f;
      const float* hf = reinterpret_cast<const float*>(hcur);
      const float* wf = reinterpret_cast<const float*>(ws);
#ifndef CIFG_SKIP_PRODUCT
      for (int k = 0; k < H; ++k) {
        const float w = wf[k * kM + m];
        const float4 ha = *reinterpret_cast<const float4*>(
            &hf[k * kRows + half * 8]);
        const float4 hb4 = *reinterpret_cast<const float4*>(
            &hf[k * kRows + half * 8 + 4]);
        acc[0] = fmaf(ha.x, w, acc[0]);
        acc[1] = fmaf(ha.y, w, acc[1]);
        acc[2] = fmaf(ha.z, w, acc[2]);
        acc[3] = fmaf(ha.w, w, acc[3]);
        acc[4] = fmaf(hb4.x, w, acc[4]);
        acc[5] = fmaf(hb4.y, w, acc[5]);
        acc[6] = fmaf(hb4.z, w, acc[6]);
        acc[7] = fmaf(hb4.w, w, acc[7]);
      }
#endif
#pragma unroll
      for (int r = 0; r < 8; ++r) zs[m * kZld + half * 8 + r] = acc[r];
    }
    __syncthreads();

    // gates, state update, outputs; h' to every CTA's next buffer
    T* hnext = hb + (cur ^ 1) * hbuf;
    float* hs_t = hs + (long long)t * B * H;
    float* cs_t = cs + (long long)t * B * H;
#pragma unroll
    for (int i = 0; i < kPairsPerThread; ++i) {
      if (!live[i]) continue;
      const int jj = pj[i], b = pb[i];
      const float zf = zcur[i][0] + zs[jj * kZld + b];
      const float zo = zcur[i][1] + zs[(kColsCta + jj) * kZld + b];
      const float zg = zcur[i][2] + zs[(2 * kColsCta + jj) * kZld + b];
#ifdef CIFG_SKIP_GATES
      const float cn = zf + zg + creg[i];
      const float hn = zo + cn;
#else
      const float f = sigmoid_f32(zf + 1.0f);
      const float o = sigmoid_f32(zo);
      const float g = tanhf(zg);
      const float cn = f * creg[i] + (1.0f - f) * g;
      const float hn = o * tanhf(cn);
#endif
      creg[i] = cn;
      const long long idx = (long long)(row0 + b) * H + col0 + jj;
      hs_t[idx] = hn;
      cs_t[idx] = cn;
#ifndef CIFG_SKIP_EXCHANGE
      if (t + 1 < S) {
        const int col = col0 + jj;
        const uint32_t local = kBf16 ? smem_u32(&hnext[b * hld + col])
                                     : smem_u32(&hnext[col * kRows + b]);
        const T v = from_f32<T>(hn);
#pragma unroll
        for (int r = 0; r < kCluster; ++r) st_peer(peer_addr(local, r), v);
      }
#endif
#pragma unroll
      for (int g2 = 0; g2 < 3; ++g2) zcur[i][g2] = znext[i][g2];
    }
    // h' of every CTA is in place before the next step's products; no peer
    // store follows the last step, so a CTA may then exit
#ifndef CIFG_SKIP_BARRIER
    if (t + 1 < S) cluster_sync();
#endif
  }
}

constexpr int kMaxDevices = 64;

// Function attributes hold per device: set() runs at the first launch on
// each device and not again, so a launch inside a CUDA-graph capture after
// a first call sets no attribute. done[] is the kernel's own flag array.
template <typename F>
cudaError_t configure_once(bool* done, F set) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = set();
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

// The launch of the H <= 256 route: its grid, block, shared memory and
// cluster; the function attribute set once per device.
template <typename T>
cudaError_t seq_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr,
                       int C, int B, int H) {
  // the most shared memory any width takes
  static bool configured[kMaxDevices] = {};
  const cudaError_t set = configure_once(configured, [] {
    return cudaFuncSetAttribute(cifg_seq_kernel<T>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem_bytes<T>(kMaxH));
  });
  if (set != cudaSuccess) return set;
  const int KP = (H + 15) & ~15;
  cfg = {};
  cfg.gridDim = dim3(kCluster, (B + kRows - 1) / kRows, C);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes<T>(KP);
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

template <typename T>
int launch(const float* zx, const float* h0, const float* c0, const void* w_h,
           long long w_client, float* hs, float* cs, int C, int S, int B,
           int H, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = seq_config<T>(cfg, attr, C, B, H);
  if (err != cudaSuccess) return static_cast<int>(err);
  cfg.stream = stream;
  err = cudaLaunchKernelEx(&cfg, cifg_seq_kernel<T>, zx, h0, c0,
                           static_cast<const T*>(w_h), w_client, hs, cs, S,
                           B, H);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------- the wide route

constexpr int kWideCluster = 16;         // CTAs per cluster (non-portable)
constexpr int kWideThreads = kThreads;   // 6 warps x 16 gate columns
constexpr int kKT = 64;                  // k-tile of h (and of w, streamed)
constexpr int kWideResidentH = kWideCluster * kColsCta;   // 512

template <typename T>
__host__ __device__ constexpr int wide_ldw() {
  return sizeof(T) == 2 ? kWld : kM;     // w row stride (elements)
}
template <typename T>
__host__ __device__ constexpr int wide_ht_elems() {
  // bf16: h tile [kRows][kKT + 8]; f32: [kKT][kRows] (transposed)
  return sizeof(T) == 2 ? kRows * (kKT + 8) : kKT * kRows;
}
// w (the whole slice, KP rows, or one kKT-row tile), the h tile, z staging
template <typename T>
__host__ __device__ constexpr int wide_smem_bytes(int KP, bool resident) {
  return (resident ? KP : kKT) * wide_ldw<T>() * static_cast<int>(sizeof(T))
         + wide_ht_elems<T>() * static_cast<int>(sizeof(T)) + kM * kZld * 4;
}

// rows [k0, k0 + rows) of the gate columns g * H + colbase + jj (jj < ncols)
// of w_h into dst[(k - k0) * ldw + g * 32 + jj]; 0 past H and ncols
template <typename T>
__device__ __forceinline__ void load_w_rows(T* dst, const T* __restrict__ w_h,
                                            int k0, int rows, int H,
                                            int colbase, int ncols) {
  constexpr int ldw = wide_ldw<T>();
  constexpr int kRowStep = kWideThreads / kM;     // 2
  const long long H3 = 3LL * H;
  const int m = threadIdx.x % kM;
  const int g = m / kColsCta, jj = m - g * kColsCta;
  const bool in = jj < ncols;
  const T* src = w_h + (long long)g * H + colbase + jj;
  for (int r0 = threadIdx.x / kM; r0 < rows; r0 += kRowStep * kLoadBatch) {
    T v[kLoadBatch];
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int r = r0 + u * kRowStep;
      v[u] = (in && r < rows && k0 + r < H) ? src[(k0 + r) * H3]
                                           : from_f32<T>(0.0f);
    }
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int r = r0 + u * kRowStep;
      if (r < rows) dst[r * ldw + m] = v[u];
    }
  }
}

// columns [k0, k0 + kKT) of rows row0 .. row0 + nrows - 1 of the f32 state
// hprev (row stride H), rounded to the compute dtype; 0 past H and nrows.
// Loaded through L2 (ld.global.cg): the peers wrote it in this launch.
template <typename T>
__device__ __forceinline__ void load_h_tile(T* ht, const float* hprev,
                                            int row0, int nrows, int k0,
                                            int H) {
  constexpr bool kBf16 = sizeof(T) == 2;
  for (int i = threadIdx.x; i < kRows * kKT; i += kWideThreads) {
    const int b = i / kKT, kk = i - b * kKT, k = k0 + kk;
    const float v = (b < nrows && k < H)
                        ? __ldcg(hprev + (long long)(row0 + b) * H + k)
                        : 0.0f;
    ht[kBf16 ? b * (kKT + 8) + kk : kk * kRows + b] = from_f32<T>(v);
  }
}

template <typename T, bool kResident>
__global__ void __launch_bounds__(kWideThreads, 1)
cifg_seq_wide_kernel(const float* __restrict__ zx,
                     const float* __restrict__ h0,
                     const float* __restrict__ c0, const T* __restrict__ w_h,
                     long long w_client, float* hs, float* cs, int S, int B,
                     int H) {
  constexpr bool kBf16 = sizeof(T) == 2;
  // this cluster's client
  {
    const long long z = blockIdx.z, BH = (long long)B * H;
    zx += z * S * BH * 3;
    h0 += z * BH;
    c0 += z * BH;
    w_h += z * w_client;
    hs += z * S * BH;
    cs += z * S * BH;
  }
  constexpr int ldw = wide_ldw<T>();
  constexpr int hld = kKT + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int KP = (H + 15) & ~15;
  const int w_elems = (kResident ? KP : kKT) * ldw;
  T* ws = reinterpret_cast<T*>(smem);
  T* ht = reinterpret_cast<T*>(smem + w_elems * sizeof(T));
  float* zs = reinterpret_cast<float*>(
      smem + (w_elems + wide_ht_elems<T>()) * sizeof(T));

  const int rank = static_cast<int>(cluster_rank());
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int CW = (H + kWideCluster - 1) / kWideCluster;
  const int col0 = rank * CW;
  const int groups = (CW + kColsCta - 1) / kColsCta;
  const int row0 = blockIdx.y * kRows;
  const int nrows = min(kRows, B - row0);
  const long long H3 = 3LL * H;
  const long long BH = (long long)B * H;

  // resident: one group of columns, its slice loaded once
  if constexpr (kResident)
    load_w_rows<T>(ws, w_h, 0, KP, H, col0, max(0, min(CW, H - col0)));

  const int m0 = warp * 16;
  const int g8 = lane >> 2, t4 = lane & 3;
  for (int t = 0; t < S; ++t) {
    const float* hprev = t == 0 ? h0 : hs + (long long)(t - 1) * BH;
    const float* cprev = t == 0 ? c0 : cs + (long long)(t - 1) * BH;
    const float* zrow = zx + (long long)t * B * H3;
    float* hs_t = hs + (long long)t * BH;
    float* cs_t = cs + (long long)t * BH;
    for (int grp = 0; grp < groups; ++grp) {
      const int gcol = col0 + grp * kColsCta;
      const int gn = max(0, min(min(kColsCta, CW - grp * kColsCta),
                                H - gcol));
      float acc[kBf16 ? 2 : 8][kBf16 ? 4 : 1];
#pragma unroll
      for (int a = 0; a < (kBf16 ? 2 : 8); ++a)
#pragma unroll
        for (int i = 0; i < (kBf16 ? 4 : 1); ++i) acc[a][i] = 0.0f;
      for (int k0 = 0; k0 < H; k0 += kKT) {
        // the previous tile's products and group's gates are done
        __syncthreads();
        load_h_tile<T>(ht, hprev, row0, nrows, k0, H);
        if constexpr (!kResident)
          load_w_rows<T>(ws, w_h, k0, kKT, H, gcol, gn);
        __syncthreads();
        const T* wt = kResident ? ws + k0 * ldw : ws;
#ifndef CIFG_SKIP_PRODUCT
        if constexpr (kBf16) {
          const int nks = min(kKT, KP - k0) / 16;
          for (int ks = 0; ks < nks; ++ks) {
            uint32_t a[4], bf[4];
            const int k = ks * 16 + (lane & 7) + ((lane >> 4) << 3);
            ldmatrix_x4_trans(a, &wt[k * ldw + m0 + ((lane >> 3) & 1) * 8]);
            const int n = (lane & 7) + ((lane >> 4) << 3);
            ldmatrix_x4(bf, &ht[n * hld + ks * 16 + ((lane >> 3) & 1) * 8]);
            mma_bf16(acc[0], a, bf[0], bf[1]);
            mma_bf16(acc[1], a, bf[2], bf[3]);
          }
        } else {
          const int m = tid % kM;
          const int half = tid / kM;
          const float* hf = reinterpret_cast<const float*>(ht);
          const float* wf = reinterpret_cast<const float*>(wt);
          const int kn = min(kKT, H - k0);
          for (int kk = 0; kk < kn; ++kk) {
            const float w = wf[kk * kM + m];
            const float4 ha = *reinterpret_cast<const float4*>(
                &hf[kk * kRows + half * 8]);
            const float4 hb4 = *reinterpret_cast<const float4*>(
                &hf[kk * kRows + half * 8 + 4]);
            acc[0][0] = fmaf(ha.x, w, acc[0][0]);
            acc[1][0] = fmaf(ha.y, w, acc[1][0]);
            acc[2][0] = fmaf(ha.z, w, acc[2][0]);
            acc[3][0] = fmaf(ha.w, w, acc[3][0]);
            acc[4][0] = fmaf(hb4.x, w, acc[4][0]);
            acc[5][0] = fmaf(hb4.y, w, acc[5][0]);
            acc[6][0] = fmaf(hb4.z, w, acc[6][0]);
            acc[7][0] = fmaf(hb4.w, w, acc[7][0]);
          }
        }
#endif
      }
      if constexpr (kBf16) {
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int m = m0 + g8 + (i >= 2 ? 8 : 0);
            const int b = n * 8 + 2 * t4 + (i & 1);
            zs[m * kZld + b] = acc[n][i];
          }
      } else {
        const int m = tid % kM;
        const int half = tid / kM;
#pragma unroll
        for (int r = 0; r < 8; ++r) zs[m * kZld + half * 8 + r] = acc[r][0];
      }
      __syncthreads();

      // gates and the state update of the group's (column, row) pairs; each
      // pair is the same thread every step, so it reads back its own c
#pragma unroll
      for (int i = 0; i < kPairsPerThread; ++i) {
        const int p = tid + i * kWideThreads;
        const int jj = p % kColsCta, b = p / kColsCta;
        if (p >= kPairs || jj >= gn || b >= nrows) continue;
        const long long r = row0 + b;
        const int col = gcol + jj;
        const float zf = zrow[r * H3 + col] + zs[jj * kZld + b];
        const float zo =
            zrow[r * H3 + H + col] + zs[(kColsCta + jj) * kZld + b];
        const float zg =
            zrow[r * H3 + 2 * H + col] + zs[(2 * kColsCta + jj) * kZld + b];
        const float c = cprev[r * H + col];
#ifdef CIFG_SKIP_GATES
        const float cn = zf + zg + c;
        const float hn = zo + cn;
#else
        const float f = sigmoid_f32(zf + 1.0f);
        const float o = sigmoid_f32(zo);
        const float g = tanhf(zg);
        const float cn = f * c + (1.0f - f) * g;
        const float hn = o * tanhf(cn);
#endif
        hs_t[r * H + col] = hn;
        cs_t[r * H + col] = cn;
      }
    }
    // every CTA's h_t is in global memory before the next step reads it
#ifndef CIFG_SKIP_BARRIER
    if (t + 1 < S) cluster_sync();
#endif
  }
}

template <typename T, bool kResident>
cudaError_t wide_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr,
                        int C, int B, int H) {
  static bool configured[kMaxDevices] = {};
  const cudaError_t set = configure_once(configured, [] {
    cudaError_t err = cudaFuncSetAttribute(
        cifg_seq_wide_kernel<T, kResident>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        wide_smem_bytes<T>(kWideResidentH, kResident));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          cifg_seq_wide_kernel<T, kResident>,
          cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return err;
  });
  if (set != cudaSuccess) return set;
  cfg = {};
  cfg.gridDim = dim3(kWideCluster, (B + kRows - 1) / kRows, C);
  cfg.blockDim = dim3(kWideThreads, 1, 1);
  cfg.dynamicSmemBytes = wide_smem_bytes<T>((H + 15) & ~15, kResident);
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kWideCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

template <typename T, bool kResident>
int launch_wide(const float* zx, const float* h0, const float* c0,
                const void* w_h, long long w_client, float* hs, float* cs,
                int C, int S, int B, int H, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = wide_config<T, kResident>(cfg, attr, C, B, H);
  if (err != cudaSuccess) return static_cast<int>(err);
  cfg.stream = stream;
  err = cudaLaunchKernelEx(&cfg, cifg_seq_wide_kernel<T, kResident>, zx, h0,
                           c0, static_cast<const T*>(w_h), w_client, hs, cs,
                           S, B, H);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_any(const float* zx, const float* h0, const float* c0,
               const void* w_h, long long w_client, float* hs, float* cs,
               int C, int S, int B, int H, cudaStream_t s) {
  if (H <= kMaxH)
    return launch<T>(zx, h0, c0, w_h, w_client, hs, cs, C, S, B, H, s);
  if (H <= kWideResidentH)
    return launch_wide<T, true>(zx, h0, c0, w_h, w_client, hs, cs, C, S, B,
                                H, s);
  return launch_wide<T, false>(zx, h0, c0, w_h, w_client, hs, cs, C, S, B, H,
                               s);
}

// The most clusters of the route at H the card holds at once.
template <typename T>
int max_clusters(int B, int H, int* out) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err;
  if (H <= kMaxH) {
    err = seq_config<T>(cfg, attr, 1, B, H);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(out, cifg_seq_kernel<T>, &cfg);
  } else if (H <= kWideResidentH) {
    err = wide_config<T, true>(cfg, attr, 1, B, H);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(
          out, cifg_seq_wide_kernel<T, true>, &cfg);
  } else {
    err = wide_config<T, false>(cfg, attr, 1, B, H);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(
          out, cifg_seq_wide_kernel<T, false>, &cfg);
  }
  return static_cast<int>(err);
}

}  // namespace

// Plain C entry point, loaded with ctypes: S steps of the recurrence from
// (h0, c0) for each of C clients, writing the state after each step into
// hs[c, t] and cs[c, t]. w_is_bf16 selects the compute dtype of w_h (1 =
// bf16, 0 = f32); w_per_client 1 gives each client its own w_h (C, H, 3H),
// 0 one w_h (H, 3H) for all. The route follows H: the 8-CTA resident kernel
// up to 256, the 16-CTA wide kernel beyond (w_h resident up to 512,
// streamed above). Returns the cudaError_t of the launch (0 on success); C,
// S, B or H below 1 return cudaErrorInvalidValue.
extern "C" int cifg_cell_seq_fwd(const float* zx, const float* h0,
                                 const float* c0, const void* w_h,
                                 int w_is_bf16, int w_per_client, float* hs,
                                 float* cs, int C, int S, int B, int H,
                                 void* stream) {
  if (C < 1 || S < 1 || B < 1 || H < 1 || B > 65535 * kRows || C > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long w_client = w_per_client ? 3LL * H * H : 0;
  if (w_is_bf16) {
    return launch_any<__nv_bfloat16>(zx, h0, c0, w_h, w_client, hs, cs, C, S,
                                     B, H, s);
  }
  return launch_any<float>(zx, h0, c0, w_h, w_client, hs, cs, C, S, B, H, s);
}

// The most clusters of the route at (B, H) that the card holds at once
// (cudaOccupancyMaxActiveClusters), into *out. Returns the cudaError_t.
extern "C" int cifg_cell_fwd_max_clusters(int w_is_bf16, int B, int H,
                                          int* out) {
  if (B < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  return w_is_bf16 ? max_clusters<__nv_bfloat16>(B, H, out)
                   : max_clusters<float>(B, H, out);
}
