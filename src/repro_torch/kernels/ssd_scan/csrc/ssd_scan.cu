// Mamba-2 chunked SSD scan for Hopper (sm_90a), from a zero state.
//
// Replaces src/repro/kernels/ssd_scan/ssd_scan.py::ssd_scan_kernel (the
// Pallas kernel _ssd_kernel). For one (batch b, head h) and chunks of
// Q = 128 tokens, with a = dt * A and cum its running sum inside the chunk:
//
//   y_intra[q] = sum_{s <= q} (C_q . B_s) exp(cum_q - cum_s) dt_s x_s
//   y_inter[q] = exp(cum_q) C_q . state            (state carried, p x N)
//   y[q]       = y_intra[q] + y_inter[q]
//   state'     = exp(cum_{Q-1}) state + sum_s x_s (dt_s exp(cum_{Q-1} - cum_s) B_s)
//
// Layout: the model's own, row-major and contiguous: x (B, S, H, p) and
// Bm, Cm (B, S, N) (one group: no head axis) in float32 or bfloat16 (read in
// that dtype and converted in registers, which is exact), dt (B, S, H) and
// A float32, (H,) shared by every batch row or (B, H) one row each (a chunk
// of clients folded into the batch, each client's A on its rows); outputs
// y (B, S, H, p) and the final state (B, H, p, N), float32. S is a
// multiple of Q (the wrapper pads with dt = 0, as the reference's ops.py
// does). Scratch from the wrapper: the chunk states
// (B, S/Q, H, p, N) and the chunk decays (B, S/Q, H), float32.
//
// What bounds it on an H100: at zamba2-2.7b's prefill (B 4, S 512, H 80,
// p 64, N 64) one call reads x, dt, B and C and writes y and the state:
// about 69 MB with bf16 inputs (y alone is 42 MB of f32), 21 us at
// 3.35 TB/s. The function needs about 3.72 GFLOP of f32 products (the lower
// triangle of C.B^T once per (b, chunk), since every head shares it; per
// head the lower triangle of W.x, C.state and the state update), which this
// kernel runs as three TF32 products each: about 23 us at a third of the
// tensor cores' 495 TFLOP/s, plus 0.04 GFLOP of scalings on the CUDA
// cores. So the products, just ahead of the bytes, set the bound.
//
// The design: the split of Mamba-2's own GPU kernels, in three kernels.
//   1. ssd_chunk_state_kernel: per (b, chunk, group of heads), each head's
//      chunk state from zero, x^T (dt exp(cum_end - cum) B), and its decay
//      exp(cum_end); all chunks in parallel.
//   2. ssd_state_pass_kernel: per (b, h, p, n) element, the walk over the
//      chunks: the state entering chunk c replaces chunk c's own state in
//      place, and the state after the last chunk is the output.
//   3. ssd_chunk_scan_kernel: per (b, chunk, group of heads), C.B^T's lower
//      triangle once, kept in shared memory for every head of the group;
//      per head y = (C.B^T o L o dt) x + (exp(cum) C) state_in^T, written
//      once.
// The group size spreads the blocks over the card's SMs (heads_per_block);
// a head's arithmetic is the same whatever group it is in. Kernels 1 and 3 run 16
// warps a block (one block per SM) and load the next head's x and dt into
// registers while the current head computes. All products run on the
// tensor cores in 3xTF32 (mma.sync m16n8k8): each f32 operand is split into
// a TF32 high part and a TF32 remainder, and a_lo b_hi + a_hi b_lo +
// a_hi b_hi are accumulated in f32, which keeps about the accuracy of f32
// products (one pass of TF32 keeps about three digits). exp is taken only
// where s <= q: above the diagonal cum_q - cum_s > 0 and could overflow.
// Shared-memory rows are padded so that no fragment load has a bank
// conflict. p and N are padded with zeros to 64 or 128 (one instantiation
// each; 206 KB of shared memory in kernel 3 at p = N = 128).
//
// p or N above 128 (the wide route, an instantiation of its own; narrower
// shapes never take it) is cut into slices of 64 or 128, whichever pads
// less, within the same shared memory. The p columns of x, y and the state
// are independent, so each p-slice is a block of its own in kernels 1 and
// 3; the n columns of a chunk state are independent too, so kernel 1 also
// takes one block per n-slice. Kernel 3 contracts N in C.B^T and in
// C.state: it stages B and C one n-slice at a time and adds each slice's
// C.B^T tile into the one in shared memory (the tile's owner warp is the
// same for every slice), and per head it adds each slice's C.state product
// into the same accumulators, restaging that slice of C. Kernel 2 is
// elementwise and takes any p and N.
//
// Where it stands (chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W): a
// call at zamba2's shape takes about 11 times that bound, two thirds of it
// in kernel 3, whose warps each build their 3xTF32 fragments from shared
// memory; W formed once per head and wgmma are the next steps (PERF.md).
//
// Removal builds time a call without one part of kernel 3: -DSSD_SKIP_CB
// (C.B^T), -DSSD_SKIP_INTRA (W x) or -DSSD_SKIP_INTER (C.state) compile
// that part out (the results are then wrong; only the time counts). The
// script is repro_torch/kernels/removal.py, the split is in PERF.md.
//
// Determinism: every sum has a fixed order and no atomics; a batch row's
// and a head's results do not depend on the other rows or heads of the call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kQ = 128;                       // chunk (the reference's CHUNK)
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPassThreads = 256;             // ssd_state_pass_kernel
constexpr int kMaxP = 128;
constexpr int kMaxN = 128;
constexpr int kCbLd = kQ + 4;                 // C.B^T row stride (floats)
constexpr int kStageBatch = 8;                // loads in flight per thread

// shared floats of each kernel for padded widths PP, NP (64 or 128)
inline __host__ __device__ int state_smem_floats(int PP, int NP) {
  return kQ * (NP + 8) + kQ * (PP + 8) + 3 * kQ;
}
inline __host__ __device__ int scan_union_floats(int PP, int NP) {
  const int bs = kQ * (NP + 4), xs = kQ * (PP + 8), st = PP * (NP + 4);
  return bs > xs ? (bs > st ? bs : st) : (xs > st ? xs : st);
}
inline __host__ __device__ int scan_smem_floats(int PP, int NP) {
  return kQ * (NP + 4) + kQ * kCbLd + scan_union_floats(PP, NP) + 3 * kQ;
}

__device__ __forceinline__ float ld_f32(const float* p) { return *p; }
__device__ __forceinline__ float ld_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  const float r = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(r));
}

// d += a b, one m16n8k8 TF32 product with f32 accumulate
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// An A fragment (m16k8) or B fragment (k8n8) of f32 values split into TF32
// high parts and remainders.
struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(float v0, float v1, float v2,
                                      float v3) {
    split_tf32(v0, hi[0], lo[0]);
    split_tf32(v1, hi[1], lo[1]);
    split_tf32(v2, hi[2], lo[2]);
    split_tf32(v3, hi[3], lo[3]);
  }
};
struct FragB {
  uint32_t hi[2], lo[2];
  __device__ __forceinline__ void set(float v0, float v1) {
    split_tf32(v0, hi[0], lo[0]);
    split_tf32(v1, hi[1], lo[1]);
  }
};

// acc[i] += a b[i] for kN n-tiles, in 3xTF32: the three passes (a_lo b_hi,
// a_hi b_lo, a_hi b_hi) each run over all n-tiles, so consecutive products
// are independent
template <int kN>
__device__ __forceinline__ void mma3(float (*acc)[4], const FragA& a,
                                     const FragB* b) {
#pragma unroll
  for (int i = 0; i < kN; ++i) mma_tf32(acc[i], a.lo, b[i].hi);
#pragma unroll
  for (int i = 0; i < kN; ++i) mma_tf32(acc[i], a.hi, b[i].lo);
#pragma unroll
  for (int i = 0; i < kN; ++i) mma_tf32(acc[i], a.hi, b[i].hi);
}

// dst[r * ld + col] = load(r, col) for r < rows, col < cols (cols a
// multiple of 16, at most 128, so it divides the block): a thread keeps one
// column and steps down the rows, with kStageBatch loads in flight before
// it stores; no division per element
template <typename F>
__device__ __forceinline__ void stage(float* dst, int ld, int rows, int cols,
                                      F load) {
  const int col = threadIdx.x % cols;
  const int step = kThreads / cols;
  for (int r0 = threadIdx.x / cols; r0 < rows; r0 += step * kStageBatch) {
    float v[kStageBatch];
#pragma unroll
    for (int k = 0; k < kStageBatch; ++k) {
      const int r = r0 + k * step;
      if (r < rows) v[k] = load(r, col);
    }
#pragma unroll
    for (int k = 0; k < kStageBatch; ++k) {
      const int r = r0 + k * step;
      if (r < rows) dst[r * ld + col] = v[k];
    }
  }
}

__device__ __forceinline__ float2 ld_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// One head's chunk of x (kQ x PP, zero past P) and dt, prefetched into
// registers while the previous head computes, then stored to shared memory.
// A thread keeps the column pair (j, j + 1) and rows q0, q0 + kStep, ...;
// the pair is one load when P is even and x is aligned for it.
template <typename T, int PP>
struct HeadPrefetch {
  static constexpr int kStep = kThreads / (PP / 2);
  static constexpr int kRowsEach = kQ / kStep;
  float2 xv[kRowsEach];
  float dtv;
  // columns j_off .. j_off + PP of x (j_off even: a p-slice's first)
  __device__ __forceinline__ void load(const T* x, const float* dt,
                                       long long t0, int h, int H, int P,
                                       int j_off) {
    const int j = 2 * (threadIdx.x % (PP / 2));
    const int q0 = threadIdx.x / (PP / 2);
    const long long row = (long long)H * P;
    const T* src = x + (t0 + q0) * row + (long long)h * P + j_off + j;
    const int jp = j_off + j;
    const bool pairs =
        P % 2 == 0 && reinterpret_cast<uintptr_t>(x) % (2 * sizeof(T)) == 0;
    if (pairs) {
#pragma unroll
      for (int k = 0; k < kRowsEach; ++k)
        xv[k] = jp < P ? ld_pair(src + k * kStep * row) : make_float2(0.f, 0.f);
    } else {
#pragma unroll
      for (int k = 0; k < kRowsEach; ++k) {
        xv[k].x = jp < P ? ld_f32(src + k * kStep * row) : 0.0f;
        xv[k].y = jp + 1 < P ? ld_f32(src + k * kStep * row + 1) : 0.0f;
      }
    }
    if (threadIdx.x < kQ) dtv = dt[(t0 + threadIdx.x) * H + h];
  }
  __device__ __forceinline__ void store(float* Xs, int ldx,
                                        float* dts) const {
    const int j = 2 * (threadIdx.x % (PP / 2));
    const int q0 = threadIdx.x / (PP / 2);
#pragma unroll
    for (int k = 0; k < kRowsEach; ++k)
      *reinterpret_cast<float2*>(&Xs[(q0 + k * kStep) * ldx + j]) = xv[k];
    if (threadIdx.x < kQ) dts[threadIdx.x] = dtv;
  }
};

// cum = running sum of dt * A over the chunk, by warp 0: 4 per lane, then a
// shuffle scan of the lane totals. Kernels 1 and 3 both call this, so their
// cum are the same bits.
__device__ __forceinline__ void chunk_cum(const float* dts, float a_h,
                                          float* cum, int lane) {
  float v[4];
  float run = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    run = __fadd_rn(run, __fmul_rn(dts[lane * 4 + k], a_h));
    v[k] = run;
  }
  float tot = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, tot, off);
    if (lane >= off) tot = __fadd_rn(tot, o);
  }
  const float before = __fsub_rn(tot, run);
#pragma unroll
  for (int k = 0; k < 4; ++k) cum[lane * 4 + k] = __fadd_rn(before, v[k]);
}

// 1. chunk states from zero: st_c[j][n] = sum_s x[s][j] f_s B[s][n],
//    f_s = dt_s exp(cum_end - cum_s); M = j, N = n, K = s. A warp owns one
//    16-row m-tile and two 8-column n-tiles. WIDE: blockIdx.x = (n-slice *
//    n_ps + p-slice) * groups + group, the block's columns j_off + [0, PP)
//    and n_off + [0, NP).
template <typename T, int PP, int NP, bool WIDE>
__global__ void __launch_bounds__(kThreads, 1)
ssd_chunk_state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                       const T* __restrict__ Bm, const float* __restrict__ A,
                       float* __restrict__ chunk_states,
                       float* __restrict__ decay, int S, int H, int P, int N,
                       int G, int n_ps, int a_stride) {
  extern __shared__ __align__(16) float smem[];
  constexpr int ldb = NP + 8, ldx = PP + 8;
  float* Bs = smem;                   // [kQ][ldb]
  float* Xs = Bs + kQ * ldb;          // [kQ][ldx]
  float* dts = Xs + kQ * ldx;         // [kQ]
  float* cum = dts + kQ;              // [kQ]
  float* fs = cum + kQ;               // [kQ]

  const int b = blockIdx.z, c = blockIdx.y;
  const int nc = gridDim.y;
  const int groups = (H + G - 1) / G;
  const int slice = WIDE ? blockIdx.x / groups : 0;
  const int j_off = WIDE ? slice % n_ps * PP : 0;
  const int n_off = WIDE ? slice / n_ps * NP : 0;
  const int h_begin = (WIDE ? blockIdx.x % groups : blockIdx.x) * G;
  const int h_end = min(H, h_begin + G);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const long long t0 = (long long)b * S + (long long)c * kQ;

  HeadPrefetch<T, PP> pre;
  pre.load(x, dt, t0, h_begin, H, P, j_off);
  stage(Bs, ldb, kQ, NP, [&](int q, int n) {
    return n_off + n < N ? ld_f32(&Bm[(t0 + q) * N + n_off + n]) : 0.0f;
  });
  constexpr int MT = PP / 16, NG = NP / 16;
  for (int h = h_begin; h < h_end; ++h) {
    pre.store(Xs, ldx, dts);
    __syncthreads();
    if (h + 1 < h_end) pre.load(x, dt, t0, h + 1, H, P, j_off);
    if (warp == 0) chunk_cum(dts, A[b * a_stride + h], cum, lane);
    __syncthreads();
    if (tid < kQ) fs[tid] = dts[tid] * expf(cum[kQ - 1] - cum[tid]);
    if (tid == 0 && slice == 0)
      decay[((long long)b * nc + c) * H + h] = expf(cum[kQ - 1]);
    __syncthreads();

    float* out = chunk_states + (((long long)b * nc + c) * H + h) * P * N;
    for (int u = warp; u < MT * NG; u += kWarps) {
      const int mt = u % MT, ng = u / MT;
      float acc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
      const int j0 = mt * 16 + g8;
#pragma unroll 4
      for (int s0 = 0; s0 < kQ; s0 += 8) {
        const int sa = s0 + t4, sb = sa + 4;
        FragA a;
        a.set(Xs[sa * ldx + j0], Xs[sa * ldx + j0 + 8], Xs[sb * ldx + j0],
              Xs[sb * ldx + j0 + 8]);
        const float fa = fs[sa], fb = fs[sb];
        FragB bf[2];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int n = ng * 16 + nt * 8 + g8;
          bf[nt].set(fa * Bs[sa * ldb + n], fb * Bs[sb * ldb + n]);
        }
        mma3<2>(acc, a, bf);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; i += 2) {
          const int j = j_off + mt * 16 + g8 + (i >= 2 ? 8 : 0);
          const int n = n_off + ng * 16 + nt * 8 + 2 * t4;
          if (j >= P) continue;
          if (N % 2 == 0 && n < N) {
            *reinterpret_cast<float2*>(&out[j * N + n]) =
                make_float2(acc[nt][i], acc[nt][i + 1]);
          } else {
            if (n < N) out[j * N + n] = acc[nt][i];
            if (n + 1 < N) out[j * N + n + 1] = acc[nt][i + 1];
          }
        }
      }
    }
    __syncthreads();   // the next head overwrites Xs, dts, cum and fs
  }
}

// 2. the walk over the chunks, one thread per (b, h, j, n): the state
//    entering chunk c replaces chunk c's own state; the last is the output.
//    Up to 8 chunks' loads are in flight before the walk uses them.
__global__ void __launch_bounds__(kPassThreads)
ssd_state_pass_kernel(float* __restrict__ chunk_states,
                      const float* __restrict__ decay,
                      float* __restrict__ state_out, int B, int nc, int H,
                      int PN) {
  const long long e = (long long)blockIdx.x * kPassThreads + threadIdx.x;
  const long long per_b = (long long)H * PN;
  if (e >= B * per_b) return;
  const long long b = e / per_b;
  const long long rest = e - b * per_b;
  const int h = static_cast<int>(rest / PN);
  float run = 0.0f;
  for (int c0 = 0; c0 < nc; c0 += 8) {
    float own[8], dec[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (c0 + k < nc) {
        own[k] = chunk_states[(b * nc + c0 + k) * per_b + rest];
        dec[k] = decay[(b * nc + c0 + k) * H + h];
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (c0 + k < nc) {
        chunk_states[(b * nc + c0 + k) * per_b + rest] = run;
        run = dec[k] * run + own[k];
      }
    }
  }
  state_out[b * per_b + rest] = run;
}

// 3. per (b, chunk, group of heads): C.B^T's lower triangle once, then per
//    head y = W x + (exp(cum) C) state_in^T with W = C.B^T o L o dt. A warp
//    owns the m-tiles {w % 4, 7 - w % 4} (equal shares of the triangle) and
//    a quarter of the head dim's n-tiles. WIDE: blockIdx.x = p-slice *
//    groups + group (y's columns j_off + [0, PP)), N in n_ns slices of NP.
template <typename T, int PP, int NP, bool WIDE>
__global__ void __launch_bounds__(kThreads, 1)
ssd_chunk_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                      const T* __restrict__ Bm, const T* __restrict__ Cm,
                      const float* __restrict__ A,
                      const float* __restrict__ states_in,
                      float* __restrict__ y, int S, int H, int P, int N,
                      int G, int a_stride) {
  extern __shared__ __align__(16) float smem[];
  constexpr int ldc = NP + 4, ldx = PP + 8, lds = NP + 4;
  float* Cs = smem;                          // [kQ][ldc]
  float* CB = Cs + kQ * ldc;                 // [kQ][kCbLd]
  float* U = CB + kQ * kCbLd;                // B, then x, then the state
  float* dts = U + scan_union_floats(PP, NP);
  float* cum = dts + kQ;
  float* eq = cum + kQ;                      // exp(cum)
  float* Bs = U;                             // [kQ][ldc]
  float* Xs = U;                             // [kQ][ldx]
  float* St = U;                             // [PP][lds]: state_in[j][n]

  const int b = blockIdx.z, c = blockIdx.y;
  const int nc = gridDim.y;
  const int groups = (H + G - 1) / G;
  const int j_off = WIDE ? blockIdx.x / groups * PP : 0;
  const int n_ns = WIDE ? (N + NP - 1) / NP : 1;
  const int h_begin = (WIDE ? blockIdx.x % groups : blockIdx.x) * G;
  const int h_end = min(H, h_begin + G);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const long long t0 = (long long)b * S + (long long)c * kQ;

  // the n-slice of C (Cs) and of B (Bs) starting at column n_off
  auto stage_c = [&](int n_off) {
    stage(Cs, ldc, kQ, NP, [&](int q, int n) {
      return n_off + n < N ? ld_f32(&Cm[(t0 + q) * N + n_off + n]) : 0.0f;
    });
  };
  auto stage_b = [&](int n_off) {
    stage(Bs, ldc, kQ, NP, [&](int q, int n) {
      return n_off + n < N ? ld_f32(&Bm[(t0 + q) * N + n_off + n]) : 0.0f;
    });
  };

  HeadPrefetch<T, PP> pre;
  pre.load(x, dt, t0, h_begin, H, P, j_off);
  for (int ns = 0; ns < n_ns; ++ns) {
    if (ns > 0) {
      __syncthreads();   // the previous slice's Cs and Bs consumed
    }
    stage_c(ns * NP);
    stage_b(ns * NP);
    __syncthreads();

    // C.B^T on the tiles that touch the lower triangle: m-tile mi (16 rows
    // q) with n-tiles ni <= 2 mi + 1 (8 columns s each), 72 tiles; the three
    // passes in three accumulators, added in a fixed order; each n-slice
    // after the first adds its tile into CB (the same warp owns it)
#ifndef SSD_SKIP_CB
    for (int i = warp; i < 72; i += kWarps) {
      int mi = 0;
      while ((mi + 1) * (mi + 2) <= i) ++mi;
      const int ni = i - mi * (mi + 1);
      const int q0 = mi * 16 + g8, s = ni * 8 + g8;
      float acc[3][4] = {};
#pragma unroll 2
      for (int n0 = 0; n0 < NP; n0 += 8) {
        FragA a;
        a.set(Cs[q0 * ldc + n0 + t4], Cs[(q0 + 8) * ldc + n0 + t4],
              Cs[q0 * ldc + n0 + t4 + 4], Cs[(q0 + 8) * ldc + n0 + t4 + 4]);
        FragB bf;
        bf.set(Bs[s * ldc + n0 + t4], Bs[s * ldc + n0 + t4 + 4]);
        mma_tf32(acc[0], a.lo, bf.hi);
        mma_tf32(acc[1], a.hi, bf.lo);
        mma_tf32(acc[2], a.hi, bf.hi);
      }
      const int col = ni * 8 + 2 * t4;
      float* cb[4] = {&CB[q0 * kCbLd + col], &CB[q0 * kCbLd + col + 1],
                      &CB[(q0 + 8) * kCbLd + col],
                      &CB[(q0 + 8) * kCbLd + col + 1]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v = (acc[0][e] + acc[1][e]) + acc[2][e];
        *cb[e] = ns == 0 ? v : *cb[e] + v;
      }
    }
#endif
  }
  __syncthreads();   // Bs is dead: its space takes x

  constexpr int kNtq = PP / 8 / 4;           // n-tiles per warp
  const int jt0 = (warp >> 2) * kNtq;
  const int mtile[2] = {warp & 3, 7 - (warp & 3)};
  for (int h = h_begin; h < h_end; ++h) {
    pre.store(Xs, ldx, dts);
    __syncthreads();
    if (h + 1 < h_end) pre.load(x, dt, t0, h + 1, H, P, j_off);
    if (warp == 0) chunk_cum(dts, A[b * a_stride + h], cum, lane);
    __syncthreads();
    if (tid < kQ) eq[tid] = expf(cum[tid]);

    float acc[2][kNtq][4];
#pragma unroll
    for (int mm = 0; mm < 2; ++mm)
#pragma unroll
      for (int nt = 0; nt < kNtq; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mm][nt][i] = 0.0f;

    // intra-chunk: W x over s <= q
#ifndef SSD_SKIP_INTRA
#pragma unroll
    for (int mm = 0; mm < 2; ++mm) {
      const int q0 = mtile[mm] * 16 + g8, q1 = q0 + 8;
      const float cq0 = cum[q0], cq1 = cum[q1];
      const int s_end = (mtile[mm] + 1) * 16;
#pragma unroll 2
      for (int s0 = 0; s0 < s_end; s0 += 8) {
        const int sa = s0 + t4, sb = sa + 4;
        const float ca = cum[sa], cb = cum[sb];
        const float da = dts[sa], db = dts[sb];
        FragA a;
        a.set(sa <= q0 ? CB[q0 * kCbLd + sa] * expf(cq0 - ca) * da : 0.0f,
              sa <= q1 ? CB[q1 * kCbLd + sa] * expf(cq1 - ca) * da : 0.0f,
              sb <= q0 ? CB[q0 * kCbLd + sb] * expf(cq0 - cb) * db : 0.0f,
              sb <= q1 ? CB[q1 * kCbLd + sb] * expf(cq1 - cb) * db : 0.0f);
        FragB bf[kNtq];
#pragma unroll
        for (int nt = 0; nt < kNtq; ++nt) {
          const int j = (jt0 + nt) * 8 + g8;
          bf[nt].set(Xs[sa * ldx + j], Xs[sb * ldx + j]);
        }
        mma3<kNtq>(acc[mm], a, bf);
      }
    }
#endif
    __syncthreads();   // x is dead: its space takes the state

    // inter-chunk: (exp(cum_q) C_q) . state_in, zero for the first chunk;
    // with more than one n-slice each is staged again per head
#ifndef SSD_SKIP_INTER
    for (int ns = 0; c > 0 && ns < n_ns; ++ns) {
      const int n_off = ns * NP;
      const float* src = states_in +
                         (((long long)b * nc + c) * H + h) * P * N + n_off;
      if (ns > 0) __syncthreads();   // the previous slice's Cs, St consumed
      if (n_ns > 1) stage_c(n_off);
      stage(St, lds, PP, NP, [&](int j, int n) {
        return (j_off + j < P && n_off + n < N) ? src[(j_off + j) * N + n]
                                                : 0.0f;
      });
      __syncthreads();
#pragma unroll
      for (int mm = 0; mm < 2; ++mm) {
        const int q0 = mtile[mm] * 16 + g8, q1 = q0 + 8;
        const float e0 = eq[q0], e1 = eq[q1];
#pragma unroll 2
        for (int n0 = 0; n0 < NP; n0 += 8) {
          const int na = n0 + t4, nb = na + 4;
          FragA a;
          a.set(e0 * Cs[q0 * ldc + na], e1 * Cs[q1 * ldc + na],
                e0 * Cs[q0 * ldc + nb], e1 * Cs[q1 * ldc + nb]);
          FragB bf[kNtq];
#pragma unroll
          for (int nt = 0; nt < kNtq; ++nt) {
            const int j = (jt0 + nt) * 8 + g8;
            bf[nt].set(St[j * lds + na], St[j * lds + nb]);
          }
          mma3<kNtq>(acc[mm], a, bf);
        }
      }
    }
#endif

#pragma unroll
    for (int mm = 0; mm < 2; ++mm)
#pragma unroll
      for (int nt = 0; nt < kNtq; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; i += 2) {
          const int q = mtile[mm] * 16 + g8 + (i >= 2 ? 8 : 0);
          const int j = j_off + (jt0 + nt) * 8 + 2 * t4;
          float* dst = y + ((t0 + q) * H + h) * P + j;
          if (P % 2 == 0 && j < P) {
            *reinterpret_cast<float2*>(dst) =
                make_float2(acc[mm][nt][i], acc[mm][nt][i + 1]);
          } else {
            if (j < P) dst[0] = acc[mm][nt][i];
            if (j + 1 < P) dst[1] = acc[mm][nt][i + 1];
          }
        }
      }
    __syncthreads();   // the next head overwrites x / the state, dt and cum
  }
}

// Heads per block. Kernels 1 and 3 run one block per SM, so a split into
// `groups` blocks per (b, chunk) takes ceil(B nc groups / sms) rounds of up
// to G = ceil(H / groups) heads each, and every block also stages its
// chunk's B and C (and forms C.B^T in kernel 3), about one head's work. The
// G with the least rounds x (G + 1) wins, the fewest groups among equals.
inline int heads_per_block(int B, int nc, int H, int sms) {
  int best_G = H;
  long long best = -1;
  for (int G = H; G >= 1; --G) {
    const long long groups = (H + G - 1) / G;
    const long long rounds = ((long long)B * nc * groups + sms - 1) / sms;
    const long long cost = rounds * (G + 1);
    if (best < 0 || cost < best) {
      best = cost;
      best_G = G;
    }
  }
  return best_G;
}

template <typename T, int PP, int NP, bool WIDE>
cudaError_t set_smem_limits() {
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_state_kernel<T, PP, NP, WIDE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, state_smem_floats(PP, NP) * 4);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(
      ssd_chunk_scan_kernel<T, PP, NP, WIDE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, scan_smem_floats(PP, NP) * 4);
}

template <typename T, int PP, int NP, bool WIDE>
int launch_sized(const T* x, const float* dt, const T* Bm, const T* Cm,
                 const float* A, float* y, float* state, float* chunk_states,
                 float* decay, int B, int S, int H, int P, int N,
                 int a_stride, int sms, cudaStream_t stream) {
  const int nc = S / kQ;
  // the wide route's slices: blocks per (b, chunk) grow with the p-slices
  const int n_ps = WIDE ? (P + PP - 1) / PP : 1;
  const int n_ns = WIDE ? (N + NP - 1) / NP : 1;
  const int G = heads_per_block(B * n_ps, nc, H, sms);
  const int groups = (H + G - 1) / G;
  const dim3 grid(groups * n_ps, nc, B);
  ssd_chunk_state_kernel<T, PP, NP, WIDE>
      <<<dim3(groups * n_ps * n_ns, nc, B), kThreads,
         state_smem_floats(PP, NP) * 4, stream>>>(
          x, dt, Bm, A, chunk_states, decay, S, H, P, N, G, n_ps, a_stride);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long elems = (long long)B * H * P * N;
  ssd_state_pass_kernel<<<static_cast<unsigned>((elems + kPassThreads - 1) /
                                                kPassThreads),
                          kPassThreads, 0, stream>>>(chunk_states, decay,
                                                     state, B, nc, H, P * N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_chunk_scan_kernel<T, PP, NP, WIDE>
      <<<grid, kThreads, scan_smem_floats(PP, NP) * 4, stream>>>(
          x, dt, Bm, Cm, A, chunk_states, y, S, H, P, N, G, a_stride);
  return static_cast<int>(cudaGetLastError());
}

// The slice width of a dimension above 128: 128 unless slices of 64 pad
// less (p = 192: three of 64, not two of 128)
inline int wide_slice(int d) {
  return (d + 127) / 128 * 128 <= (d + 63) / 64 * 64 ? 128 : 64;
}

// p and N are padded to 64 or 128 (zeros), one instantiation each; above
// 128 the wide route's slices
template <typename T>
int launch(const void* x, const float* dt, const void* Bm, const void* Cm,
           const float* A, float* y, float* state, float* chunk_states,
           float* decay, int B, int S, int H, int P, int N, int a_stride,
           cudaStream_t stream) {
  // the card's SM count and every instantiation's shared-memory limit,
  // read and set once (one card per process; a launch inside a CUDA-graph
  // capture after a first call then queries and sets nothing)
  static bool configured = false;
  static int sms = 0;
  if (!configured) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) err = set_smem_limits<T, 64, 64, false>();
    if (err == cudaSuccess) err = set_smem_limits<T, 64, 128, false>();
    if (err == cudaSuccess) err = set_smem_limits<T, 128, 64, false>();
    if (err == cudaSuccess) err = set_smem_limits<T, 128, 128, false>();
    if (err == cudaSuccess) err = set_smem_limits<T, 64, 64, true>();
    if (err == cudaSuccess) err = set_smem_limits<T, 64, 128, true>();
    if (err == cudaSuccess) err = set_smem_limits<T, 128, 64, true>();
    if (err == cudaSuccess) err = set_smem_limits<T, 128, 128, true>();
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(Bm);
  const T* ct = static_cast<const T*>(Cm);
#define SSD_LAUNCH(PP, NP)                                                   \
  return launch_sized<T, PP, NP, false>(xt, dt, bt, ct, A, y, state,        \
                                        chunk_states, decay, B, S, H, P, N, \
                                        a_stride, sms, stream)
#define SSD_LAUNCH_WIDE(PP, NP)                                             \
  return launch_sized<T, PP, NP, true>(xt, dt, bt, ct, A, y, state,        \
                                       chunk_states, decay, B, S, H, P, N, \
                                       a_stride, sms, stream)
  if (P > kMaxP || N > kMaxN) {
    const int pp = P > kMaxP ? wide_slice(P) : (P <= 64 ? 64 : 128);
    const int np = N > kMaxN ? wide_slice(N) : (N <= 64 ? 64 : 128);
    if (pp == 64) {
      if (np == 64) SSD_LAUNCH_WIDE(64, 64);
      SSD_LAUNCH_WIDE(64, 128);
    }
    if (np == 64) SSD_LAUNCH_WIDE(128, 64);
    SSD_LAUNCH_WIDE(128, 128);
  }
  if (P <= 64) {
    if (N <= 64) SSD_LAUNCH(64, 64);
    SSD_LAUNCH(64, 128);
  }
  if (N <= 64) SSD_LAUNCH(128, 64);
  SSD_LAUNCH(128, 128);
#undef SSD_LAUNCH
#undef SSD_LAUNCH_WIDE
}

}  // namespace

// Plain C entry point, loaded with ctypes. x, Bm and Cm are bf16 when
// in_is_bf16 is 1, else float32. A holds one row of H values per batch row
// b at A + b * a_stride: a_stride 0 shares one row (the model's A), a_stride
// >= H gives each row its own (a chunk of clients, each with its own A).
// Runs the three kernels on `stream`.
// Returns the cudaError_t of the launches (0 on success); shapes the kernel
// does not take return cudaErrorInvalidValue.
extern "C" int ssd_scan_fwd(const void* x, const float* dt, const void* Bm,
                            const void* Cm, const float* A, float* y,
                            float* state, float* chunk_states, float* decay,
                            int in_is_bf16, int B, int S, int H, int P, int N,
                            int a_stride, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || S < kQ || S % kQ || S / kQ > 65535 ||
      P < 1 || N < 1 || (a_stride != 0 && a_stride < H)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_is_bf16) {
    return launch<__nv_bfloat16>(x, dt, Bm, Cm, A, y, state, chunk_states,
                                 decay, B, S, H, P, N, a_stride, s);
  }
  return launch<float>(x, dt, Bm, Cm, A, y, state, chunk_states, decay, B, S,
                       H, P, N, a_stride, s);
}
