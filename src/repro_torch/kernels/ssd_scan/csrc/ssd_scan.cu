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
// Layout: the model's own, row-major and contiguous, all float32:
//   x (B, S, H, p), dt (B, S, H), Bm and Cm (B, S, N) (one group: no head
//   axis), A (H,); outputs y (B, S, H, p) and the final state (B, H, p, N).
//   S is a multiple of Q (the wrapper pads with dt = 0, as the reference's
//   ops.py does).
//
// What bounds it on an H100: at zamba2-2.7b's prefill (B 4, S 512, H 80,
// p 64, N 64) one call reads x (42 MB), dt, B and C and writes y (42 MB):
// about 26 us of memory traffic at 3.35 TB/s. The float32 arithmetic the
// function needs is about 3.75 GFLOP (the lower triangle of C.B^T once per
// (b, chunk), since every head shares it; per head its scalings, the lower
// triangle of W.x, C.state and the state update), about 56 us at the
// 67 TFLOP/s of the CUDA cores. So the work, not the bytes, sets the bound.
// This kernel does about 1.3 GFLOP more, as it forms C.B^T in every head.
//
// What this simple design does about it: one block per (b, h) walks the
// chunks in order, in place of the TPU's sequential grid axis and its VMEM
// state scratch. The chunk's x, B, C and dt, the (N x p) state and a
// 32 x Q tile of the weights W = (C.B^T o L o dt) live in shared memory
// (about 131 KB at N 64, 211 KB at N 128, above the 48 KB default, so the
// entry point raises the block's limit). Rows of B and C are padded to
// N + 1 floats, so the lanes of a warp, which walk s, hit distinct banks.
// Each warp owns 4 rows of every W tile and the same rows of y, so the
// W tile needs only __syncwarp between its product and its use. exp is
// taken only where s <= q: above the diagonal cum_q - cum_s > 0 and could
// overflow (the TPU kernel forms exp over the whole square and selects).
// The products are float32 FMAs on the CUDA cores, read from shared memory
// at about 0.75 loads per FMA, so shared-memory bandwidth, not the FMA
// rate, limits each SM; the tensor cores are unused.
//
// Left for later work: C.B^T is the same for all H heads of one (b, chunk)
// (a single group), and this kernel recomputes it in each of the H blocks;
// computing it once per (b, chunk), and the intra-chunk products on the
// tensor cores (wgmma), are the redesign.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kQ = 128;                       // chunk (the reference's CHUNK)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowTile = 32;                  // rows of one W tile
constexpr int kRowsPerWarp = kRowTile / kWarps;   // 4
constexpr int kMaxP = 128;
constexpr int kMaxN = 128;
constexpr int kMaxPJ = kMaxP / 32;            // head-dim columns per lane
constexpr int kMaxSmemBytes = 232448;         // per block on an H100

inline int smem_floats(int P, int N) {
  return 2 * kQ * (N + 1) + kQ * P + N * P + kRowTile * kQ + 3 * kQ;
}

__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ Bm, const float* __restrict__ Cm,
                const float* __restrict__ A, float* __restrict__ y,
                float* __restrict__ state_out, int S, int H, int P, int N) {
  extern __shared__ float smem[];
  const int ldn = N + 1;
  float* Cs = smem;                   // [kQ][ldn]
  float* Bs = Cs + kQ * ldn;          // [kQ][ldn]
  float* xs = Bs + kQ * ldn;          // [kQ][P]
  float* st = xs + kQ * P;            // [N][P]: the state, transposed
  float* Wt = st + N * P;             // [kRowTile][kQ]
  float* cum = Wt + kRowTile * kQ;    // [kQ]
  float* dts = cum + kQ;              // [kQ]
  float* fs = dts + kQ;               // [kQ]: dt_s exp(cum_{Q-1} - cum_s)

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float a_h = A[h];

  for (int i = tid; i < N * P; i += kThreads) st[i] = 0.0f;

  for (int c0 = 0; c0 < S; c0 += kQ) {
    const long long t0 = (long long)b * S + c0;   // first row of the chunk
    for (int i = tid; i < kQ * P; i += kThreads) {
      const int q = i / P, j = i - q * P;
      xs[i] = x[((t0 + q) * H + h) * P + j];
    }
    for (int i = tid; i < kQ * N; i += kThreads) {
      const int q = i / N, n = i - q * N;
      Bs[q * ldn + n] = Bm[(t0 + q) * N + n];
      Cs[q * ldn + n] = Cm[(t0 + q) * N + n];
    }
    if (tid < kQ) dts[tid] = dt[(t0 + tid) * H + h];
    __syncthreads();

    // cum = running sum of dt * A over the chunk: warp 0, 4 per lane, then
    // a shuffle scan of the lane totals
    if (warp == 0) {
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
    __syncthreads();

    const int r0 = warp * kRowsPerWarp;
    for (int q0 = 0; q0 < kQ; q0 += kRowTile) {
      const int ns = q0 / 32 + 1;     // 32-wide groups of s with s <= q0 + 31

      // W tile: Wt[r][s] = (C_q . B_s) exp(cum_q - cum_s) dt_s, q = q0 + r,
      // for s <= q; 0 above the diagonal. Lanes walk s, the warp's 4 rows
      // share each B load.
      {
        float acc[kRowsPerWarp][4];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[i][k] = 0.0f;
        for (int n = 0; n < N; ++n) {
          float cv[kRowsPerWarp];
#pragma unroll
          for (int i = 0; i < kRowsPerWarp; ++i)
            cv[i] = Cs[(q0 + r0 + i) * ldn + n];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (k < ns) {
              const float bv = Bs[(lane + 32 * k) * ldn + n];
#pragma unroll
              for (int i = 0; i < kRowsPerWarp; ++i)
                acc[i][k] = fmaf(cv[i], bv, acc[i][k]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          const int q = q0 + r0 + i;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (k < ns) {
              const int s = lane + 32 * k;
              Wt[(r0 + i) * kQ + s] =
                  s <= q ? acc[i][k] * expf(cum[q] - cum[s]) * dts[s] : 0.0f;
            }
          }
        }
      }
      __syncwarp();

      // y rows of the tile: W.x over s < 32 ns, plus exp(cum_q) C_q . state
      // from the state carried in (zero for the first chunk). Lanes walk
      // the head dim.
      {
        float yi[kRowsPerWarp][kMaxPJ];
        float ye[kRowsPerWarp][kMaxPJ];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
          for (int m = 0; m < kMaxPJ; ++m) yi[i][m] = ye[i][m] = 0.0f;
        const int s_end = 32 * ns;
        for (int s = 0; s < s_end; ++s) {
          float wv[kRowsPerWarp];
#pragma unroll
          for (int i = 0; i < kRowsPerWarp; ++i) wv[i] = Wt[(r0 + i) * kQ + s];
#pragma unroll
          for (int m = 0; m < kMaxPJ; ++m) {
            const int j = lane + 32 * m;
            if (j < P) {
              const float xv = xs[s * P + j];
#pragma unroll
              for (int i = 0; i < kRowsPerWarp; ++i)
                yi[i][m] = fmaf(wv[i], xv, yi[i][m]);
            }
          }
        }
        if (c0 > 0) {
          for (int n = 0; n < N; ++n) {
            float cv[kRowsPerWarp];
#pragma unroll
            for (int i = 0; i < kRowsPerWarp; ++i)
              cv[i] = Cs[(q0 + r0 + i) * ldn + n];
#pragma unroll
            for (int m = 0; m < kMaxPJ; ++m) {
              const int j = lane + 32 * m;
              if (j < P) {
                const float sv = st[n * P + j];
#pragma unroll
                for (int i = 0; i < kRowsPerWarp; ++i)
                  ye[i][m] = fmaf(cv[i], sv, ye[i][m]);
              }
            }
          }
        }
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          const int q = q0 + r0 + i;
          const float eq = expf(cum[q]);
#pragma unroll
          for (int m = 0; m < kMaxPJ; ++m) {
            const int j = lane + 32 * m;
            if (j < P) y[((t0 + q) * H + h) * P + j] = yi[i][m] + eq * ye[i][m];
          }
        }
      }
      __syncwarp();   // the next tile overwrites this warp's rows of Wt
    }

    // state update, once every warp has read the state carried in
    if (tid < kQ) fs[tid] = dts[tid] * expf(cum[kQ - 1] - cum[tid]);
    __syncthreads();
    const float decay = expf(cum[kQ - 1]);
    for (int n0 = warp * 4; n0 < N; n0 += kWarps * 4) {
      float acc[4][kMaxPJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int m = 0; m < kMaxPJ; ++m) acc[i][m] = 0.0f;
      for (int s = 0; s < kQ; ++s) {
        const float f = fs[s];
        float bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          bv[i] = n0 + i < N ? f * Bs[s * ldn + n0 + i] : 0.0f;
#pragma unroll
        for (int m = 0; m < kMaxPJ; ++m) {
          const int j = lane + 32 * m;
          if (j < P) {
            const float xv = xs[s * P + j];
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i][m] = fmaf(bv[i], xv, acc[i][m]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = n0 + i;
        if (n >= N) continue;
#pragma unroll
        for (int m = 0; m < kMaxPJ; ++m) {
          const int j = lane + 32 * m;
          if (j < P) st[n * P + j] = decay * st[n * P + j] + acc[i][m];
        }
      }
    }
    __syncthreads();   // the next chunk overwrites xs, Bs, Cs and reads st
  }

  for (int i = tid; i < P * N; i += kThreads) {
    const int j = i / N, n = i - j * N;
    state_out[(((long long)b * H + h) * P + j) * N + n] = st[n * P + j];
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. Returns the cudaError_t of the
// launch (0 on success); shapes the kernel does not take return
// cudaErrorInvalidValue.
extern "C" int ssd_scan_fwd(const float* x, const float* dt, const float* Bm,
                            const float* Cm, const float* A, float* y,
                            float* state, int B, int S, int H, int P, int N,
                            void* stream) {
  if (B < 1 || B > 65535 || H < 1 || S < kQ || S % kQ ||
      P < 1 || P > kMaxP || N < 1 || N > kMaxN) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int bytes = smem_floats(P, N) * static_cast<int>(sizeof(float));
  if (bytes > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  // raise the block's shared-memory limit to the most asked for so far (one
  // card per process), so that a launch inside a CUDA-graph capture, after
  // a warm-up call, sets no attribute
  static int configured = 0;
  if (bytes > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = bytes;
  }
  ssd_scan_kernel<<<dim3(H, B), kThreads, bytes,
                    static_cast<cudaStream_t>(stream)>>>(
      x, dt, Bm, Cm, A, y, state, S, H, P, N);
  return static_cast<int>(cudaGetLastError());
}
