// CIFG-LSTM cell backward for Hopper (sm_90a): the reverse of one step
// (cifg_cell_bwd) and the reverse recursion of a whole sequence in one
// launch (cifg_cell_bwd_seq).
//
// Both replace src/repro/kernels/cifg_cell/cifg_cell.py::cell_bwd (the
// Pallas kernel _bwd_kernel). The sequence form is where training runs that
// math: the reverse loop of the time-fused backward (the reference's
// src/repro/kernels/cifg_cell/ops.py::_cifg_sequence_bwd), which hoists the
// gate recompute and dW_h out of the loop as two large products.
//
// ---------------------------------------------------------- cifg_cell_bwd
//
// The reverse of one recurrent step, given the step's inputs and the
// cotangents dh', dc' of its outputs:
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
// order starting from 0, so every result is the same bits on every run (no
// atomics, no split sums).
//
// What bounds it on an H100: at a decode-gradient step (B=10, H=256, bf16)
// the step reads zx 31 KB, w_h 393 KB, h, c, dh', dc' 41 KB and writes dzx
// 31 KB, dh and dc 20 KB, dw_h 786 KB: about 1.3 MB, 0.4 us at 3.35 TB/s,
// for 12 MFLOP. The products run as f32 FMAs on CUDA cores with 32x32 tiles
// staged in shared memory: simple, not fast. It runs only through
// cifg_step's gradient (a gradient through decode_step).
//
// ------------------------------------------------------ cifg_cell_bwd_seq
//
// For s = S-1 .. 0, from (dh, dc) = (dh_fin, dc_fin):
//
//   f = sigmoid(z_f + 1), o = sigmoid(z_o), g = tanh(z_g), t = tanh(c_s)
//   A = o (1 - t^2), Bf = (c_{s-1} - g) f (1 - f), Co = t o (1 - o),
//   Dg = (1 - f)(1 - g^2)
//   dh  += dhs[s];  dct = dc + dh A
//   dz_s = [dct Bf | dh Co | dct Dg]
//   dh   = dz_s @ w_h^T   (f32, over the 3H gate columns);  dc = dct f
//
// given z (S, B, 3H) (the gate pre-activations, recomputed by the caller
// in one product), cs (S, B, H) and c0 (B, H) (c_{-1} = c0), the cotangents
// dhs (S, B, H), dh_fin and dc_fin (B, H), and w_h (H, 3H), all f32; it
// writes dz (S, B, 3H) and the final (dh, dc) as dh0 and dc0 (B, H). The
// product is f32 as in the reference (w_h.astype(f32).T).
//
// What bounds it on an H100: at a training client batch (S 16, B 10,
// H 256) it moves about 2.1 MB (0.63 us at 3.35 TB/s) and does 63 MFLOP of
// f32 products (0.94 us at 67 TFLOP/s). The recursion is serial, so the real
// limit is S times one step's latency: the elementwise update, one exchange
// of dz between the blocks that share the hidden columns, and the product.
//
// The design, for H <= 256: one cluster of 8 CTAs per tile of 16 batch
// rows. CTA r owns hidden columns j in [r*CW, (r+1)*CW), CW = ceil(H/8) <=
// 32, keeps the f32 rows w_h[j, :] (32 x 3H: 96 KB at H 256) in shared
// memory for the whole sequence, and keeps its (dh, dc)[:, j] in registers.
// Per step each CTA forms the dz columns of its three gates (they need only
// dh[:, j] and dc[:, j]), writes them to dz and stores them into every
// peer's dz buffer with st.shared::cluster (double-buffered), then one
// cluster barrier, then each CTA forms dh[:, j] = dz @ w_h[j, :]^T over all
// 3H columns from its own shared memory. Thread (j, warp) holds rows warp and
// warp + 8. The product runs as f32 FMAs on the CUDA cores: at B 10 it is
// 245 k FMAs per CTA a step, and it keeps the reference's f32 product, one
// rounding per term, each output summed by one thread. Each output is four
// FMA chains (the columns m = 4i + q, q = 0..3, m ascending, as a float4
// load gives them) added as (q0 + q1) + (q2 + q3). Every warp reads the
// whole w_h slice from shared memory each step, and that traffic bounds the
// product. Two other products were tried on the H100 and were not faster:
// four warps of four rows each, which read w_h half as often but leave one
// warp a scheduler waiting on latency; and 3xTF32 on the tensor cores in
// four warps of m16n8 tiles, which must split both operands every step. The
// next step's elementwise inputs are loaded while the product runs.
//
// H > 256 (the wide route): a cluster of 16 CTAs, CW = ceil(H/16) columns
// each in groups of 32. dz is exchanged through global memory: after the
// step's cluster barrier each CTA reads dz_s of all columns back in tiles
// of 64 columns through L2, and (dh, dc)[:, j] live in dh0 and dc0, read
// and written by the thread that owns them. The rows w_h[j, :] are resident
// where the slice fits (one group: H <= 512, 192 KB at H 512) and streamed
// from L2 tile by tile beside dz beyond that; where the slice fits,
// resident is the faster form (PERF.md has both times). The route is chosen
// by H alone, never by B or S.
//
// A client axis: C independent recursions in one launch (a cohort chunk in
// training, each client with its own parameters): z (C, S, B, 3H), cs and
// dhs (C, S, B, H), c0, dh_fin and dc_fin (C, B, H), w_h (C, H, 3H); dz, dh0
// and dc0 with the same leading C. gridDim.z = C on both routes; every
// cluster offsets its pointers by its client. The one-client entry is the
// C = 1 call.
//
// Determinism: every output element is a fixed sequence of operations on
// its row's data, whatever B is and wherever the row sits: the same run on
// the same inputs gives the same bits, and no sum is split across threads
// or blocks; there are no atomics. A client's results are the same bits
// whatever C is and wherever the client sits.
//
// Removal builds: -DCIFGB_SKIP_ELEMENTWISE, -DCIFGB_SKIP_EXCHANGE,
// -DCIFGB_SKIP_BARRIER and -DCIFGB_SKIP_PRODUCT compile that part of the
// H <= 256 route out (the results are then wrong; only the time counts;
// repro_torch/kernels/removal.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// ------------------------------------------------------ the sequence form

constexpr int kSeqCluster = 8;           // CTAs per cluster, H <= 256
constexpr int kSeqWideCluster = 16;      // CTAs per cluster, H > 256
constexpr int kSeqRows = 16;             // batch rows per cluster
constexpr int kSeqCols = 32;             // hidden columns per CTA (group)
constexpr int kSeqThreads = 256;         // 8 warps: lane = column, 2 rows
constexpr int kSeqMaxH = kSeqCluster * kSeqCols;          // 256
constexpr int kSeqResidentH = kSeqWideCluster * kSeqCols; // 512
constexpr int kMT = 64;                  // columns of dz per tile (wide)

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

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

// The elementwise reverse step of one (row, column) pair: given the step's
// z (three gates), c_s, c_{s-1}, dhs[s] and the running (dh, dc), writes the
// three dz values and returns dc; dh is consumed.
struct Pair {
  float zf, zo, zg, c, cp, dhs;
};

__device__ __forceinline__ void reverse_step(const Pair& in, float dh_run,
                                             float& dc_run, float* dz3) {
#ifdef CIFGB_SKIP_ELEMENTWISE
  const float dh = dh_run + in.dhs;
  const float dct = dc_run + dh * in.zf;
  dz3[0] = dct + in.c;
  dz3[1] = dh + in.zo;
  dz3[2] = dct + in.zg + in.cp;
  dc_run = dct;
#else
  const float f = sigmoid_f32(in.zf + 1.0f);
  const float o = sigmoid_f32(in.zo);
  const float g = tanhf(in.zg);
  const float t = tanhf(in.c);
  const float A = o * (1.0f - t * t);
  const float Bf = (in.cp - g) * f * (1.0f - f);
  const float Co = t * o * (1.0f - o);
  const float Dg = (1.0f - f) * (1.0f - g * g);
  const float dh = dh_run + in.dhs;
  const float dct = dc_run + dh * A;
  dz3[0] = dct * Bf;
  dz3[1] = dh * Co;
  dz3[2] = dct * Dg;
  dc_run = dct * f;
#endif
}

__device__ __forceinline__ Pair load_pair(const float* z, const float* cs,
                                          const float* c0, const float* dhs,
                                          int s, long long r, int j, int B,
                                          int H) {
  const long long H3 = 3LL * H;
  const long long BH = (long long)B * H;
  const float* zr = z + (long long)s * B * H3 + r * H3;
  Pair p;
  p.zf = zr[j];
  p.zo = zr[H + j];
  p.zg = zr[2 * H + j];
  p.c = cs[(long long)s * BH + r * H + j];
  p.cp = s > 0 ? cs[(long long)(s - 1) * BH + r * H + j] : c0[r * H + j];
  p.dhs = dhs[(long long)s * BH + r * H + j];
  return p;
}

// four FMA chains, columns m = 4i + q in chain q, m ascending
__device__ __forceinline__ void fma4(float4& a, const float4& d,
                                     const float4& w) {
  a.x = fmaf(d.x, w.x, a.x);
  a.y = fmaf(d.y, w.y, a.y);
  a.z = fmaf(d.z, w.z, a.z);
  a.w = fmaf(d.w, w.w, a.w);
}

__device__ __forceinline__ float fold4(const float4& a) {
  return (a.x + a.y) + (a.z + a.w);
}

// Shared memory of the H <= 256 kernel: w rows [32][W3 + 4], dz [2][16][W3]
__host__ __device__ constexpr int seq_smem_bytes(int H) {
  return (kSeqCols * (round4(3 * H) + 4) + 2 * kSeqRows * round4(3 * H)) * 4;
}

__global__ void __launch_bounds__(kSeqThreads, 1)
cifg_bwd_seq_kernel(const float* __restrict__ z, const float* __restrict__ cs,
                    const float* __restrict__ c0,
                    const float* __restrict__ dhs,
                    const float* __restrict__ dh_fin,
                    const float* __restrict__ dc_fin,
                    const float* __restrict__ w_h, long long w_client,
                    float* __restrict__ dz, float* __restrict__ dh0,
                    float* __restrict__ dc0, int S, int B, int H) {
  // this cluster's client
  {
    const long long zc = blockIdx.z, BH = (long long)B * H;
    z += zc * S * BH * 3;
    cs += zc * S * BH;
    c0 += zc * BH;
    dhs += zc * S * BH;
    dh_fin += zc * BH;
    dc_fin += zc * BH;
    w_h += zc * w_client;
    dz += zc * S * BH * 3;
    dh0 += zc * BH;
    dc0 += zc * BH;
  }
  extern __shared__ __align__(16) float sm[];
  const int W3 = round4(3 * H);
  const int wld = W3 + 4;
  float* ws = sm;                        // [kSeqCols][wld]
  float* dzs = sm + kSeqCols * wld;      // [2][kSeqRows][W3]

  const int rank = static_cast<int>(cluster_rank());
  const int tid = threadIdx.x;
  const int jj = tid & 31;
  const int warp = tid >> 5;
  const int CW = (H + kSeqCluster - 1) / kSeqCluster;
  const int j = rank * CW + jj;
  const bool col_live = jj < CW && j < H;
  const int row0 = blockIdx.y * kSeqRows;
  const int nrows = min(kSeqRows, B - row0);
  const long long H3 = 3LL * H;

  // the CTA's rows of w_h (0 past H and CW), with eight 16-byte loads in
  // flight a thread where the rows allow them, and both dz buffers zeroed:
  // the padding columns [3H, W3) stay 0
  const int H3i = 3 * H;
  if (H3i % 4 == 0 && reinterpret_cast<uintptr_t>(w_h) % 16 == 0) {
    const int n4 = W3 / 4;
    for (int base = tid; base < kSeqCols * n4; base += kSeqThreads * 8) {
      float4 v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = base + u * kSeqThreads;
        const int q = i / n4, m = (i - q * n4) * 4;
        const int jq = rank * CW + q;
        v[u] = (i < kSeqCols * n4 && q < CW && jq < H && m < H3i)
                   ? __ldg(reinterpret_cast<const float4*>(
                         w_h + (long long)jq * H3 + m))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = base + u * kSeqThreads;
        const int q = i / n4, m = (i - q * n4) * 4;
        if (i < kSeqCols * n4)
          *reinterpret_cast<float4*>(&ws[q * wld + m]) = v[u];
      }
    }
  } else {
    for (int i = tid; i < kSeqCols * W3; i += kSeqThreads) {
      const int q = i / W3, m = i - q * W3;
      const int jq = rank * CW + q;
      ws[q * wld + m] = (q < CW && jq < H && m < H3i)
                            ? w_h[(long long)jq * H3 + m] : 0.0f;
    }
  }
  for (int i = tid; i < 2 * kSeqRows * W3; i += kSeqThreads) dzs[i] = 0.0f;

  // thread (jj, warp): rows warp and warp + 8 of the tile
  bool live[2];
  float dh_run[2], dc_run[2];
  Pair cur[2], nxt[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int b = warp + 8 * q;
    live[q] = col_live && b < nrows;
    const long long r = row0 + b;
    dh_run[q] = live[q] ? dh_fin[r * H + j] : 0.0f;
    dc_run[q] = live[q] ? dc_fin[r * H + j] : 0.0f;
    if (live[q]) cur[q] = load_pair(z, cs, c0, dhs, S - 1, r, j, B, H);
  }
  __syncthreads();
  // every CTA of the cluster is running and zeroed before any peer store
  cluster_sync();

  const float* wrow = ws + jj * wld;
  for (int s = S - 1; s >= 0; --s) {
    float* dzb = dzs + (s & 1) * kSeqRows * W3;
    float* dz_s = dz + (long long)s * B * H3;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (!live[q]) continue;
      const int b = warp + 8 * q;
      float d[3];
      reverse_step(cur[q], dh_run[q], dc_run[q], d);
      const long long r = row0 + b;
#pragma unroll
      for (int g = 0; g < 3; ++g) dz_s[r * H3 + g * H + j] = d[g];
#ifndef CIFGB_SKIP_EXCHANGE
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        const uint32_t local = smem_u32(&dzb[b * W3 + g * H + j]);
#pragma unroll
        for (int p = 0; p < kSeqCluster; ++p)
          st_peer(peer_addr(local, p), d[g]);
      }
#endif
    }
    // the next step's inputs, in flight during the barrier and the product
    if (s > 0) {
#pragma unroll
      for (int q = 0; q < 2; ++q)
        if (live[q])
          nxt[q] = load_pair(z, cs, c0, dhs, s - 1, row0 + warp + 8 * q, j,
                             B, H);
    }
#ifndef CIFGB_SKIP_BARRIER
    cluster_sync();
#else
    __syncthreads();
#endif
    // dh[:, j] = dz_s @ w_h[j, :]^T for rows warp and warp + 8
#ifndef CIFGB_SKIP_PRODUCT
    float4 a0 = make_float4(0.f, 0.f, 0.f, 0.f), a1 = a0;
    const float* d0 = dzb + warp * W3;
    const float* d1 = dzb + (warp + 8) * W3;
    if (warp + 8 < nrows) {
#pragma unroll 4
      for (int m = 0; m < W3; m += 4) {
        const float4 w4 = *reinterpret_cast<const float4*>(wrow + m);
        fma4(a0, *reinterpret_cast<const float4*>(d0 + m), w4);
        fma4(a1, *reinterpret_cast<const float4*>(d1 + m), w4);
      }
    } else if (warp < nrows) {
#pragma unroll 4
      for (int m = 0; m < W3; m += 4) {
        const float4 w4 = *reinterpret_cast<const float4*>(wrow + m);
        fma4(a0, *reinterpret_cast<const float4*>(d0 + m), w4);
      }
    }
    dh_run[0] = fold4(a0);
    dh_run[1] = fold4(a1);
#endif
#pragma unroll
    for (int q = 0; q < 2; ++q) cur[q] = nxt[q];
  }
#ifdef CIFGB_SKIP_BARRIER
  cluster_sync();   // no CTA exits while a peer may still store into it
#endif
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    if (!live[q]) continue;
    const long long r = row0 + warp + 8 * q;
    dh0[r * H + j] = dh_run[q];
    dc0[r * H + j] = dc_run[q];
  }
}

// Shared memory of the wide kernel: w rows [32][W3 + 4] (resident) or
// [32][kMT + 4] (a streamed tile), then the dz tile [16][kMT]
__host__ __device__ constexpr int seq_wide_smem_bytes(int H, bool resident) {
  return (kSeqCols * ((resident ? round4(3 * H) : kMT) + 4)
          + kSeqRows * kMT) * 4;
}

template <bool kResident>
__global__ void __launch_bounds__(kSeqThreads, 1)
cifg_bwd_seq_wide_kernel(const float* __restrict__ z,
                         const float* __restrict__ cs,
                         const float* __restrict__ c0,
                         const float* __restrict__ dhs,
                         const float* __restrict__ dh_fin,
                         const float* __restrict__ dc_fin,
                         const float* __restrict__ w_h, long long w_client,
                         float* dz, float* dh0, float* dc0, int S, int B,
                         int H) {
  // this cluster's client
  {
    const long long zc = blockIdx.z, BH = (long long)B * H;
    z += zc * S * BH * 3;
    cs += zc * S * BH;
    c0 += zc * BH;
    dhs += zc * S * BH;
    dh_fin += zc * BH;
    dc_fin += zc * BH;
    w_h += zc * w_client;
    dz += zc * S * BH * 3;
    dh0 += zc * BH;
    dc0 += zc * BH;
  }
  extern __shared__ __align__(16) float sm[];
  const int H3i = 3 * H;
  const int W3 = round4(H3i);
  const int wld = (kResident ? W3 : kMT) + 4;
  float* ws = sm;                             // [kSeqCols][wld]
  float* dzt = sm + kSeqCols * wld;           // [kSeqRows][kMT]

  const int rank = static_cast<int>(cluster_rank());
  const int tid = threadIdx.x;
  const int jj = tid & 31;
  const int warp = tid >> 5;
  const int CW = (H + kSeqWideCluster - 1) / kSeqWideCluster;
  const int col0 = rank * CW;
  const int groups = (CW + kSeqCols - 1) / kSeqCols;
  const int row0 = blockIdx.y * kSeqRows;
  const int nrows = min(kSeqRows, B - row0);
  const long long H3 = 3LL * H;

  if constexpr (kResident) {                  // one group of columns
    for (int i = tid; i < kSeqCols * W3; i += kSeqThreads) {
      const int q = i / W3, m = i - q * W3;
      ws[q * wld + m] = (q < CW && col0 + q < H && m < H3i)
                            ? w_h[(long long)(col0 + q) * H3 + m] : 0.0f;
    }
  }

  for (int s = S - 1; s >= 0; --s) {
    const float* dz_in = dz + (long long)s * B * H3;
    // the elementwise step of every pair the thread owns; (dh, dc) are
    // carried in dh0 and dc0 by the thread that owns the pair
    for (int grp = 0; grp < groups; ++grp) {
      const int j = col0 + grp * kSeqCols + jj;
      if (grp * kSeqCols + jj >= CW || j >= H) continue;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int b = warp + 8 * q;
        if (b >= nrows) continue;
        const long long r = row0 + b;
        const float dh_r = s == S - 1 ? dh_fin[r * H + j] : dh0[r * H + j];
        float dc_r = s == S - 1 ? dc_fin[r * H + j] : dc0[r * H + j];
        float d[3];
        reverse_step(load_pair(z, cs, c0, dhs, s, r, j, B, H), dh_r, dc_r, d);
#pragma unroll
        for (int g = 0; g < 3; ++g)
          dz[(long long)s * B * H3 + r * H3 + g * H + j] = d[g];
        dc0[r * H + j] = dc_r;
      }
    }
    // every CTA's dz_s is in global memory before any CTA reads it
    cluster_sync();
    for (int grp = 0; grp < groups; ++grp) {
      const int gcol = col0 + grp * kSeqCols;
      const int gn = max(0, min(min(kSeqCols, CW - grp * kSeqCols),
                                H - gcol));
      float4 a0 = make_float4(0.f, 0.f, 0.f, 0.f), a1 = a0;
      for (int m0 = 0; m0 < W3; m0 += kMT) {
        __syncthreads();                      // the previous tile is used
        for (int i = tid; i < kSeqRows * kMT; i += kSeqThreads) {
          const int b = i / kMT, mm = i - b * kMT;
          dzt[i] = (b < nrows && m0 + mm < H3i)
                       ? __ldcg(dz_in + (row0 + b) * H3 + m0 + mm) : 0.0f;
        }
        if constexpr (!kResident) {
          for (int i = tid; i < kSeqCols * kMT; i += kSeqThreads) {
            const int q = i / kMT, mm = i - q * kMT;
            ws[q * wld + mm] = (q < gn && m0 + mm < H3i)
                                   ? w_h[(long long)(gcol + q) * H3 + m0 + mm]
                                   : 0.0f;
          }
        }
        __syncthreads();
        const float* wrow = ws + jj * wld + (kResident ? m0 : 0);
        const float* d0 = dzt + warp * kMT;
        const float* d1 = dzt + (warp + 8) * kMT;
        const int mn = min(kMT, W3 - m0);
        if (warp + 8 < nrows) {
          for (int m = 0; m < mn; m += 4) {
            const float4 w4 = *reinterpret_cast<const float4*>(wrow + m);
            fma4(a0, *reinterpret_cast<const float4*>(d0 + m), w4);
            fma4(a1, *reinterpret_cast<const float4*>(d1 + m), w4);
          }
        } else if (warp < nrows) {
          for (int m = 0; m < mn; m += 4) {
            const float4 w4 = *reinterpret_cast<const float4*>(wrow + m);
            fma4(a0, *reinterpret_cast<const float4*>(d0 + m), w4);
          }
        }
      }
      if (jj < gn) {
        const int j = gcol + jj;
        if (warp < nrows) dh0[(long long)(row0 + warp) * H + j] = fold4(a0);
        if (warp + 8 < nrows)
          dh0[(long long)(row0 + warp + 8) * H + j] = fold4(a1);
      }
    }
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

cudaError_t seq_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr,
                       int C, int B, int H) {
  static bool configured[kMaxDevices] = {};
  const cudaError_t set = configure_once(configured, [] {
    return cudaFuncSetAttribute(cifg_bwd_seq_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                seq_smem_bytes(kSeqMaxH));
  });
  if (set != cudaSuccess) return set;
  cfg = {};
  cfg.gridDim = dim3(kSeqCluster, (B + kSeqRows - 1) / kSeqRows, C);
  cfg.blockDim = dim3(kSeqThreads, 1, 1);
  cfg.dynamicSmemBytes = seq_smem_bytes(H);
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kSeqCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

int launch_seq(const float* z, const float* cs, const float* c0,
               const float* dhs, const float* dh_fin, const float* dc_fin,
               const float* w_h, long long w_client, float* dz, float* dh0,
               float* dc0, int C, int S, int B, int H, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = seq_config(cfg, attr, C, B, H);
  if (err != cudaSuccess) return static_cast<int>(err);
  cfg.stream = stream;
  err = cudaLaunchKernelEx(&cfg, cifg_bwd_seq_kernel, z, cs, c0, dhs, dh_fin,
                           dc_fin, w_h, w_client, dz, dh0, dc0, S, B, H);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <bool kResident>
cudaError_t seq_wide_config(cudaLaunchConfig_t& cfg,
                            cudaLaunchAttribute* attr, int C, int B, int H) {
  static bool configured[kMaxDevices] = {};
  const cudaError_t set = configure_once(configured, [] {
    cudaError_t err = cudaFuncSetAttribute(
        cifg_bwd_seq_wide_kernel<kResident>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        seq_wide_smem_bytes(kSeqResidentH, kResident));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          cifg_bwd_seq_wide_kernel<kResident>,
          cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return err;
  });
  if (set != cudaSuccess) return set;
  cfg = {};
  cfg.gridDim = dim3(kSeqWideCluster, (B + kSeqRows - 1) / kSeqRows, C);
  cfg.blockDim = dim3(kSeqThreads, 1, 1);
  cfg.dynamicSmemBytes = seq_wide_smem_bytes(H, kResident);
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kSeqWideCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

template <bool kResident>
int launch_seq_wide(const float* z, const float* cs, const float* c0,
                    const float* dhs, const float* dh_fin,
                    const float* dc_fin, const float* w_h, long long w_client,
                    float* dz, float* dh0, float* dc0, int C, int S, int B,
                    int H, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = seq_wide_config<kResident>(cfg, attr, C, B, H);
  if (err != cudaSuccess) return static_cast<int>(err);
  cfg.stream = stream;
  err = cudaLaunchKernelEx(&cfg, cifg_bwd_seq_wide_kernel<kResident>, z, cs,
                           c0, dhs, dh_fin, dc_fin, w_h, w_client, dz, dh0,
                           dc0, S, B, H);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
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

// Plain C entry point, loaded with ctypes: the reverse recursion of a whole
// sequence (see the header) for each of C clients, each with its own w_h,
// all tensors f32 and contiguous. The route follows H: the 8-CTA kernel up
// to 256, the 16-CTA wide kernel beyond (w_h resident up to 512, streamed
// above). Returns the cudaError_t of the launch (0 on success); C, S, B or
// H below 1 return cudaErrorInvalidValue.
extern "C" int cifg_cell_bwd_seq(const float* z, const float* cs,
                                 const float* c0, const float* dhs,
                                 const float* dh_fin, const float* dc_fin,
                                 const float* w_h, float* dz, float* dh0,
                                 float* dc0, int C, int S, int B, int H,
                                 void* stream) {
  if (C < 1 || S < 1 || B < 1 || H < 1 || B > 65535 * kSeqRows ||
      C > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long w_client = 3LL * H * H;
  if (H <= kSeqMaxH)
    return launch_seq(z, cs, c0, dhs, dh_fin, dc_fin, w_h, w_client, dz, dh0,
                      dc0, C, S, B, H, st);
  if (H <= kSeqResidentH)
    return launch_seq_wide<true>(z, cs, c0, dhs, dh_fin, dc_fin, w_h,
                                 w_client, dz, dh0, dc0, C, S, B, H, st);
  return launch_seq_wide<false>(z, cs, c0, dhs, dh_fin, dc_fin, w_h,
                                w_client, dz, dh0, dc0, C, S, B, H, st);
}

// The most clusters of the sequence form's route at (B, H) that the card
// holds at once (cudaOccupancyMaxActiveClusters), into *out.
extern "C" int cifg_cell_bwd_seq_max_clusters(int B, int H, int* out) {
  if (B < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err;
  if (H <= kSeqMaxH) {
    err = seq_config(cfg, attr, 1, B, H);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(out, cifg_bwd_seq_kernel, &cfg);
  } else if (H <= kSeqResidentH) {
    err = seq_wide_config<true>(cfg, attr, 1, B, H);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(
          out, cifg_bwd_seq_wide_kernel<true>, &cfg);
  } else {
    err = seq_wide_config<false>(cfg, attr, 1, B, H);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(
          out, cifg_bwd_seq_wide_kernel<false>, &cfg);
  }
  return static_cast<int>(err);
}
