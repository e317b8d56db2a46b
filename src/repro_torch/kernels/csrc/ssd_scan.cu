// Mamba2 SSD chunked scan for Hopper (sm_90a): zamba2's sequence mixer.
//
//   h_t = exp(ld_t) h_{t-1} + b_t x_t^T ,   y_t = h_t^T c_t
//
// x (BH, L, P), ld (BH, L), b and c (BH, L, N) -> y (BH, L, P), all f32.
// Per chunk of Q steps, with s the in-chunk cumulative sum of ld:
//
//   G[t, u]  = (c_t . b_u) exp(s_t - s_u)           for u <= t, else 0
//   Y        = G X + diag(exp(s)) C h_prev
//   h_next   = exp(s_{Q-1}) h_prev + sum_u exp(s_{Q-1} - s_u) b_u x_u^T
//
// Replaces the TPU kernel `_ssd_kernel` / `ssd_scan_pallas` in
// src/repro/kernels/ssd_scan.py (body :27, pl.pallas_call :77).  On the
// TPU the chunk axis is a sequential grid axis and the (N, P) state sits in
// VMEM scratch between grid steps.  Blocks on Hopper run in no order, so
// here one block owns one bh row and loops over its chunks, with the state
// in shared memory.  L must be a multiple of Q (the wrapper pads it with
// zero steps, which leave the state unchanged); Q must be a multiple of 8
// and N, P multiples of 4 (the wrapper pads N and P with zeros).
//
// Per chunk, in shared memory: X[u][p], B[u][n] (scaled by
// exp(s_{Q-1} - s_u) before the state update), the transposes Bt[n][u] and
// Ct[n][t], Gt[u][t] and h[n][p].  Each of the three products is a tiled
// loop in which a thread owns a small output tile in registers and reads
// both operands as float4 rows of k-major arrays.  G is formed only on and
// below the diagonal: exp(s_t - s_u) is never evaluated for u > t, where
// it can overflow (the reference masks before exp for the same reason; in
// CUDA inf * 0 is NaN), and Y's product stops at the tile's last row.  All
// arithmetic is f32 FMAs outside the tensor cores.
//
// Bound: bytes.  At zamba2's forward (BH = 160, L = 2048, P = N = 64,
// Q = 128) one call moves 4 BH L (2P + 2N + 1) = 336,855,040 B (0.1006 ms
// at 3.35 TB/s).  The least work is the exact recurrence's 5 N P FLOP per
// step (3 N P to update h, 2 N P for y), 6.71e9 FLOP (0.1002 ms at 67
// TFLOP/s f32); the chunked form computed here does BH (L/Q)(2 T N + 2 T P
// + 4 Q N P) = 1.078e10 FLOP over the causal half, T = Q(Q+1)/2 (0.16 ms
// at f32), and buys its parallelism over time with them.  At 217,600 B of
// shared memory per block one block fits on an SM, and BH = 160 blocks
// fill the 132 SMs in two waves; a chunk-parallel two-pass design and
// tensor-core (TF32) products are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// Offsets (in floats) of the per-block shared arrays for chunk q, state n
// x p.  Every offset and row stride is a multiple of 4 floats, so float4
// accesses stay aligned.
struct Layout {
  int lq;              // row stride of the arrays indexed [.][time]
  int x, bn, bt, ct, gt, h, s, total;
};

__host__ __device__ inline Layout make_layout(int q, int n, int p) {
  Layout o;
  o.lq = q + 4;        // breaks the bank pattern of the transposed stores
  int off = 0;
  o.x = off;  off += q * p;
  o.bn = off; off += q * n;
  o.bt = off; off += n * o.lq;
  o.ct = off; off += n * o.lq;
  o.gt = off; off += q * o.lq;
  o.h = off;  off += n * p;
  o.s = off;  off += q;
  o.total = off;
  return o;
}

// acc[i][j] += sum_{k0 <= k < k1} A[k * lda + r0 + i] * B[k * ldb + c0 + j]
template <int TM, int TN>
__device__ __forceinline__ void tile_fma(float (&acc)[TM][TN],
                                         const float* __restrict__ a, int lda,
                                         int r0, const float* __restrict__ b,
                                         int ldb, int c0, int k0, int k1) {
  for (int k = k0; k < k1; ++k) {
    float av[TM], bv[TN];
#pragma unroll
    for (int i = 0; i < TM; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(a + k * lda + r0 + i);
      av[i] = v.x; av[i + 1] = v.y; av[i + 2] = v.z; av[i + 3] = v.w;
    }
#pragma unroll
    for (int j = 0; j < TN; j += 4) {
      const float4 v = *reinterpret_cast<const float4*>(b + k * ldb + c0 + j);
      bv[j] = v.x; bv[j + 1] = v.y; bv[j + 2] = v.z; bv[j + 3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// In-place inclusive prefix sum of s[0..q) by warp 0: each lane sums a run
// of consecutive steps, the lanes' totals are scanned with shuffles, and
// each lane rewrites its run.
__device__ __forceinline__ void chunk_cumsum(float* s, int q) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const int per = (q + 31) / 32;
  const int lo = min(q, lane * per), hi = min(q, lo + per);
  float tot = 0.0f;
  for (int i = lo; i < hi; ++i) tot += s[i];
  float inc = tot;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += up;
  }
  float run = inc - tot;
  for (int i = lo; i < hi; ++i) {
    run += s[i];
    s[i] = run;
  }
}

__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ ld,
                const float* __restrict__ bm, const float* __restrict__ cm,
                float* __restrict__ y, long long l, int p, int n, int q) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Layout lay = make_layout(q, n, p);
  float* xs = smem + lay.x;
  float* bn = smem + lay.bn;
  float* bt = smem + lay.bt;
  float* ct = smem + lay.ct;
  float* gt = smem + lay.gt;
  float* hs = smem + lay.h;
  float* ss = smem + lay.s;
  const int lq = lay.lq;
  const int tid = threadIdx.x;

  const long long row = blockIdx.x;
  const float* xr = x + row * l * p;
  const float* ldr = ld + row * l;
  const float* br = bm + row * l * n;
  const float* cr = cm + row * l * n;
  float* yr = y + row * l * p;

  for (int i = tid; i < n * p; i += kThreads) hs[i] = 0.0f;

  const long long chunks = l / q;
  for (long long c = 0; c < chunks; ++c) {
    const long long t0 = c * q;
    // -- load the chunk (coalesced reads; B and C also stored transposed)
    for (int i = tid; i < q * p; i += kThreads) xs[i] = xr[t0 * p + i];
    for (int i = tid; i < q * n; i += kThreads) {
      const int u = i / n, k = i - u * n;
      const float bv = br[t0 * n + i];
      bn[i] = bv;
      bt[k * lq + u] = bv;
      ct[k * lq + u] = cr[t0 * n + i];
    }
    for (int i = tid; i < q; i += kThreads) ss[i] = ldr[t0 + i];
    __syncthreads();
    chunk_cumsum(ss, q);
    __syncthreads();

    // -- G on and below the diagonal, stored transposed: Gt[u][t]
    const int nt8 = q / 8;
    for (int tile = tid; tile < nt8 * nt8; tile += kThreads) {
      const int tr = tile / nt8, tc = tile - tr * nt8;
      if (tc > tr) continue;
      const int r0 = tr * 8, c0 = tc * 8;
      float acc[8][8] = {};
      tile_fma<8, 8>(acc, ct, lq, r0, bt, lq, c0, 0, n);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int u = c0 + j;
        float g[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int t = r0 + i;
          g[i] = u <= t ? acc[i][j] * expf(ss[t] - ss[u]) : 0.0f;
        }
        float4* dst = reinterpret_cast<float4*>(gt + u * lq + r0);
        dst[0] = make_float4(g[0], g[1], g[2], g[3]);
        dst[1] = make_float4(g[4], g[5], g[6], g[7]);
      }
    }
    // -- scale B's rows for the state update: B[u] exp(s_{Q-1} - s_u)
    const float last = ss[q - 1];
    for (int i = tid; i < q * n; i += kThreads) {
      const int u = i / n;
      bn[i] *= expf(last - ss[u]);
    }
    __syncthreads();

    // -- Y = G X + diag(exp(s)) C h_prev, tiles of 8 steps x 4 columns
    const int np4 = p / 4;
    for (int tile = tid; tile < nt8 * np4; tile += kThreads) {
      const int tr = tile / np4, tc = tile - tr * np4;
      const int r0 = tr * 8, c0 = tc * 4;
      float acc[8][4] = {};
      tile_fma<8, 4>(acc, gt, lq, r0, xs, p, c0, 0, r0 + 8);
      float inter[8][4] = {};
      tile_fma<8, 4>(inter, ct, lq, r0, hs, p, c0, 0, n);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float e = expf(ss[r0 + i]);
        float4 out;
        out.x = fmaf(e, inter[i][0], acc[i][0]);
        out.y = fmaf(e, inter[i][1], acc[i][1]);
        out.z = fmaf(e, inter[i][2], acc[i][2]);
        out.w = fmaf(e, inter[i][3], acc[i][3]);
        *reinterpret_cast<float4*>(yr + (t0 + r0 + i) * p + c0) = out;
      }
    }
    __syncthreads();

    // -- h = exp(s_{Q-1}) h + (scaled B)^T X, tiles of 4 x 4 (each thread
    //    owns its tile of h, so the update is in place)
    const float decay = expf(last);
    const int nn4 = n / 4;
    for (int tile = tid; tile < nn4 * np4; tile += kThreads) {
      const int tr = tile / np4, tc = tile - tr * np4;
      const int r0 = tr * 4, c0 = tc * 4;
      float acc[4][4] = {};
      tile_fma<4, 4>(acc, bn, n, r0, xs, p, c0, 0, q);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float4* hrow = reinterpret_cast<float4*>(hs + (r0 + i) * p + c0);
        float4 hv = *hrow;
        hv.x = fmaf(decay, hv.x, acc[i][0]);
        hv.y = fmaf(decay, hv.y, acc[i][1]);
        hv.z = fmaf(decay, hv.z, acc[i][2]);
        hv.w = fmaf(decay, hv.w, acc[i][3]);
        *hrow = hv;
      }
    }
    __syncthreads();
  }
}

}  // namespace

// Launches on `stream` of CUDA device `device` and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a shape
// the kernel does not take.  Pointers are device pointers to contiguous
// float32 x (bh, l, p), ld (bh, l), b and c (bh, l, n) and y (bh, l, p).
// The library links its own CUDA runtime, so it selects the device itself.
extern "C" int ssd_scan_launch(const void* x, const void* ld, const void* b,
                               const void* c, void* y, long long bh,
                               long long l, int p, int n, int q,
                               void* stream, int device) {
  if (q <= 0 || q % 8 != 0 || n <= 0 || n % 4 != 0 || p <= 0 || p % 4 != 0 ||
      l % q != 0 || bh > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bh == 0 || l == 0) return 0;
  // more than the 227 KB a block can opt into fails the attribute call
  const int smem = make_layout(q, n, p).total * 4;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(ssd_scan_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_kernel<<<static_cast<unsigned int>(bh), kThreads,
                    static_cast<size_t>(smem),
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(ld),
      static_cast<const float*>(b), static_cast<const float*>(c),
      static_cast<float*>(y), l, p, n, q);
  return static_cast<int>(cudaGetLastError());
}
