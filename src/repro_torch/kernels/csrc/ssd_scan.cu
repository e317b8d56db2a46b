// Mamba2 SSD chunked scan for Hopper (sm_90a): zamba2's sequence mixer.
//
//   h_t = exp(ld_t) h_{t-1} + b_t x_t^T ,   y_t = h_t^T c_t
//
// x (BH, L, P), ld (BH, L) -> y (BH, L, P), all f32.  Rows of x come in
// groups of `heads` consecutive rows that share one row of b and c, so b
// and c are (BH / heads, L, N); heads = 1 is the per-row form.  Per chunk
// of Q steps, with s the in-chunk cumulative sum of ld:
//
//   G[t, u]  = (c_t . b_u) exp(s_t - s_u)           for u <= t, else 0
//   Y        = G X + diag(exp(s)) C h_prev
//   h_next   = exp(s_{Q-1}) h_prev + sum_u exp(s_{Q-1} - s_u) b_u x_u^T
//
// Replaces the TPU kernel `_ssd_kernel` / `ssd_scan_pallas` in
// src/repro/kernels/ssd_scan.py (body :27, pl.pallas_call :77).  On the
// TPU the chunk axis is a sequential grid axis and the (N, P) state sits in
// VMEM scratch between grid steps.  Blocks on Hopper run in no order, so
// the scan is the Mamba2 paper's own decomposition (arXiv:2405.21060, §6),
// three launches on one stream:
//
//   1. ssd_state_kernel, one block per (group, chunk, tile of heads):
//      stages the chunk's B once, then per head the chunk state
//      S = B^T diag(exp(s_{Q-1} - s)) X into the scratch `states`
//      (BH, L/Q, N, P) and the chunk's total log-decay into `tot`.
//   2. ssd_pass_kernel, one thread per (row, 4 state entries): the short
//      sequential pass over the chunks, turning each S in place into the
//      state entering its chunk: h_prev[0] = 0, h_prev[c+1] =
//      exp(tot_c) h_prev[c] + S_c.
//   3. ssd_out_kernel, one block per (group, chunk, head tile): forms C B^T
//      once for all heads of the tile (on and below the diagonal), then per
//      head the causal decay-masked G, the diagonal block G X and the
//      off-diagonal term diag(exp s) C h_prev, and writes y once.
//
// Every product runs on the tensor cores (mma.sync m16n8k8, TF32 inputs,
// f32 accumulation).  Plain TF32 keeps ~11 bits of each input, too few
// for the scan's 3e-4 tolerance, so each operand is cut into a TF32 big
// part and a TF32 small part and three products (small*big, big*small,
// big*big) restore f32 accuracy ("3xTF32"; the small products go to their
// own accumulators).
// Operands are read from shared memory as mma fragments; row strides are
// padded so that fragment loads hit 32 distinct banks.  exp(s_t - s_u) is
// never used above the diagonal, where it can overflow (inf * 0 is NaN in
// CUDA): the select drops it, and G's product stops at each 16-row tile's
// last row.  L must be a multiple of Q (the wrapper pads it with zero
// steps, which leave the state unchanged); Q must be a multiple of 16, N
// of 16 and P of 8 (the wrapper pads N and P with zeros, which change no
// real output).  The state scratch is the wrapper's (torch.empty).
//
// Bound.  At zamba2's forward (B = 2, 80 heads, L = 2048, P = N = 64,
// Q = 128) the grouped form must move x and y (2 x 83,886,080 B), the
// log-decay (1,310,720 B) and the head-shared B and C (2 x 1,048,576 B):
// 171,180,032 B, 0.0511 ms at 3.35 TB/s.  The exact recurrence needs
// 6.71e9 FLOP (0.1002 ms at 67 TFLOP/s f32).  The chunked form computed
// here needs C B^T once per (group, chunk), and G X, the chunk states and
// the off-diagonal term per head: 8.11e9 FLOP over the causal half, 0.0164
// ms at 495 TFLOP/s TF32 and 0.0491 ms as 3xTF32.  So the grouped form is
// bound by its bytes, 0.0511 ms.  (The per-row form, which forms C B^T for
// every row, does 1.078e10 FLOP, 0.0653 ms as 3xTF32, and moves 0.1006 ms
// of bytes.)  This design also writes and reads the chunk states (3 x
// 41,943,040 B at that shape) and reads x twice, so it moves about 2.5x
// the bound's bytes, and its time goes to fragment loads and the split
// arithmetic around the mma.sync products more than to either bound.
//
// Occupancy.  ssd_out_kernel holds C, C B^T and two (X, h_prev) buffers,
// the first over B: 214,016 B at Q = 128, N = P = 64, so one 16-warp block
// per SM; the grid has (BH / heads) (L / Q) ceil(heads / 4) blocks, 640 at
// the forward (4.85 waves over 132 SMs).  ssd_state_kernel holds B and two
// X buffers, 111,616 B: two 8-warp blocks per SM, tiles of 10 heads, 256
// blocks at the forward.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;      // ssd_state_kernel, ssd_pass_kernel
constexpr int kWarps = kThreads / 32;
constexpr int kOutThreads = 512;   // ssd_out_kernel: 4 warps per scheduler
constexpr int kOutWarps = kOutThreads / 32;
// heads per block: the output pass keeps >= 4 waves at zamba2's forward
// (640 blocks of one per SM); the state pass, two blocks per SM, gains from
// longer blocks (256)
constexpr int kStateHeadsPerBlock = 10;
constexpr int kOutHeadsPerBlock = 4;

// Row strides (floats) of shared operands: a [row][k] operand needs a
// stride of 4 mod 16 floats, a [k][col] operand 8 mod 16, for its fragment
// loads to hit 32 distinct banks.
__host__ __device__ inline int pad_rk(int x) { return (x + 15) / 16 * 16 + 4; }
__host__ __device__ inline int pad_kn(int x) { return (x + 15) / 16 * 16 + 8; }

// Offsets (floats) of ssd_state_kernel's shared arrays.
// Two X buffers: the next head's X is copied while this head computes.
struct StateLayout {
  int ldb, ldx;
  int bs, xs0, xs1, s, w, total;
};

__host__ __device__ inline StateLayout state_layout(int q, int n, int p) {
  StateLayout o;
  o.ldb = pad_kn(n);   // B[u][n] is the A operand read [k][row]
  o.ldx = pad_kn(p);
  o.bs = 0;
  o.xs0 = o.bs + q * o.ldb;
  o.xs1 = o.xs0 + q * o.ldx;
  o.s = o.xs1 + q * o.ldx;
  o.w = o.s + q;
  o.total = o.w + q;
  return o;
}

// Offsets (floats) of ssd_out_kernel's shared arrays.  Two (X, h_prev)
// buffers: the next head's are copied while this head computes.  Buffer 0's
// X reuses B's space once C B^T is formed, so head i uses buffer (i + 1) % 2.
struct OutLayout {
  int ldc, ldb, ldx, ldcb, ldh;
  int cs, x0, cb, x1, h0, h1, s, es, total;
};

__host__ __device__ inline OutLayout out_layout(int q, int n, int p) {
  OutLayout o;
  o.ldc = pad_rk(n);
  o.ldb = pad_rk(n);   // B[u][n] is the B operand read [col][k]
  o.ldx = pad_kn(p);
  o.ldcb = pad_rk(q);
  o.ldh = pad_kn(p);
  o.cs = 0;
  o.x0 = o.cs + q * o.ldc;
  const int bx = q * (o.ldb > o.ldx ? o.ldb : o.ldx);
  o.cb = o.x0 + bx;
  o.x1 = o.cb + q * o.ldcb;
  o.h0 = o.x1 + q * o.ldx;
  o.h1 = o.h0 + n * o.ldh;
  o.s = o.h1 + n * o.ldh;
  o.es = o.s + q;
  o.total = o.es + q;
  return o;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `pending` (0 or 1) committed groups are in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows x cols floats (cols a multiple of 4) from global rows of `gld`
// floats into shared rows of `sld` floats, 16 bytes per copy.
__device__ __forceinline__ void copy_tile(float* dst, int sld,
                                          const float* src, long long gld,
                                          int rows, int cols) {
  const int c4 = cols / 4;
  for (int i = threadIdx.x; i < rows * c4; i += blockDim.x) {
    const int r = i / c4, c = (i - r * c4) * 4;
    cp_async16(dst + r * sld + c, src + r * gld + c);
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

constexpr float kLog2e = 1.4426950408889634f;

// 2^x in one special-function instruction (relative error < 2^-22)
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// x ~ hi + lo, each a TF32 value.  The split cuts hi by dropping x's low
// 13 mantissa bits (one logic op, where a conversion instruction costs more
// issue slots), so x - hi is exact in f32 and lo keeps its top 11 bits:
// |x - hi - lo| < 2^-20 |x|.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One warp: acc[j] += A (16 rows) x B (columns 8j .. 8j + 8) over
// k in [k0, k1), k1 - k0 a multiple of 8.  a_at(r, k) gives A's element at
// tile row r, b_at(k, col) B's at tile column col; both read shared memory.
// Fragment layouts of mma.m16n8k8 .tf32 (PTX ISA): lane = 4 g + t holds
// A (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4); B (t, g), (t + 4, g);
// C (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
template <int NT, class AF, class BF>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], int ntiles,
                                         int k0, int k1, AF a_at, BF b_at) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // the small-part products go to their own accumulators: two independent
  // chains of tensor-core ops per tile, added once at the end
  float lo[NT][4] = {};
#pragma unroll 2
  for (int k = k0; k < k1; k += 8) {
    uint32_t ah[4], al[4];
    split_tf32(a_at(g, k + t), ah[0], al[0]);
    split_tf32(a_at(g + 8, k + t), ah[1], al[1]);
    split_tf32(a_at(g, k + t + 4), ah[2], al[2]);
    split_tf32(a_at(g + 8, k + t + 4), ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < ntiles) {
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(b_at(k + t, 8 * j + g), bh0, bl0);
        split_tf32(b_at(k + t + 4, 8 * j + g), bh1, bl1);
        mma_tf32(lo[j], al, bh0, bh1);
        mma_tf32(lo[j], ah, bl0, bl1);
        mma_tf32(acc[j], ah, bh0, bh1);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += lo[j][e];
}

// Write a warp's accumulators: rows r0 + {g, g + 8}, columns c0 + 8j + 2t
// and the next, into a row-major array of row stride ld.
template <int NT>
__device__ __forceinline__ void store_tile(float* dst, long long ld, int r0,
                                           int c0, int ntiles,
                                           const float (&acc)[NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j < ntiles) {
      const int col = c0 + 8 * j + 2 * t;
      *reinterpret_cast<float2*>(dst + (r0 + g) * ld + col) =
          make_float2(acc[j][0], acc[j][1]);
      *reinterpret_cast<float2*>(dst + (r0 + g + 8) * ld + col) =
          make_float2(acc[j][2], acc[j][3]);
    }
  }
}

// blockIdx.x -> (group, chunk, heads [h0, h1) of a tile of `per` heads)
struct BlockWork {
  long long g, c;
  int h0, h1;
};

__device__ __forceinline__ BlockWork block_work(long long nc, int heads,
                                                int per) {
  const int tiles = (heads + per - 1) / per;
  const long long id = blockIdx.x;
  BlockWork w;
  const long long rest = id / tiles;
  w.h0 = static_cast<int>(id - rest * tiles) * per;
  w.h1 = min(heads, w.h0 + per);
  w.c = rest % nc;
  w.g = rest / nc;
  return w;
}

__global__ void __launch_bounds__(kThreads)
ssd_state_kernel(const float* __restrict__ x, const float* __restrict__ ld,
                 const float* __restrict__ bm, float* __restrict__ states,
                 float* __restrict__ tot, int heads, long long nc,
                 long long l, int p, int n, int q) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const StateLayout lay = state_layout(q, n, p);
  float* bs = smem + lay.bs;
  float* ss = smem + lay.s;
  float* ws = smem + lay.w;
  const int tid = threadIdx.x, warp = tid >> 5;
  const BlockWork bw = block_work(nc, heads, kStateHeadsPerBlock);
  const long long t0 = bw.c * q;
  const long long row0 = bw.g * heads;

  copy_tile(bs, lay.ldb, bm + (bw.g * l + t0) * n, n, q, n);
  copy_tile(smem + lay.xs0, lay.ldx, x + ((row0 + bw.h0) * l + t0) * p, p, q,
            p);
  cp_async_commit();
  for (int h = bw.h0; h < bw.h1; ++h) {
    const long long row = row0 + h;
    const float* xs = smem + ((h - bw.h0) & 1 ? lay.xs1 : lay.xs0);
    __syncthreads();   // the previous head is done with its X, ss and ws
    const bool next = h + 1 < bw.h1;
    if (next) {
      copy_tile(smem + ((h - bw.h0) & 1 ? lay.xs0 : lay.xs1), lay.ldx,
                x + ((row + 1) * l + t0) * p, p, q, p);
      cp_async_commit();
    }
    for (int i = tid; i < q; i += kThreads) ss[i] = ld[row * l + t0 + i];
    cp_async_wait(next);
    __syncthreads();
    chunk_cumsum(ss, q);
    __syncthreads();
    const float last = ss[q - 1];
    for (int i = tid; i < q; i += kThreads) ws[i] = expf(last - ss[i]);
    if (tid == 0) tot[row * nc + bw.c] = last;
    __syncthreads();

    // S (N x P) = (diag(w) B)^T X: 16-row tiles of N by 32-column blocks
    float* dst = states + (row * nc + bw.c) * n * p;
    const int mt = n / 16, pbs = (p + 31) / 32;
    for (int item = warp; item < mt * pbs; item += kWarps) {
      const int m0 = (item % mt) * 16, p0 = (item / mt) * 32;
      const int ntiles = min(4, (p - p0) / 8);
      float acc[4][4] = {};
      warp_mma(
          acc, ntiles, 0, q,
          [&](int r, int u) { return bs[u * lay.ldb + m0 + r] * ws[u]; },
          [&](int u, int col) { return xs[u * lay.ldx + p0 + col]; });
      store_tile(dst, p, m0, p0, ntiles, acc);
    }
  }
}

// The chunk states of one row are read kPassDepth at a time, all loads in
// flight before the dependent updates.
constexpr int kPassDepth = 8;

__global__ void __launch_bounds__(kThreads)
ssd_pass_kernel(float* __restrict__ states, const float* __restrict__ tot,
                long long rows, long long nc, long long np4) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= rows * np4) return;
  const long long row = idx / np4, e = idx - row * np4;
  float4* st = reinterpret_cast<float4*>(states) + row * nc * np4 + e;
  const float* tr = tot + row * nc;
  float4 h = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (long long c0 = 0; c0 < nc; c0 += kPassDepth) {
    float4 sv[kPassDepth];
    float d[kPassDepth];
#pragma unroll
    for (int i = 0; i < kPassDepth; ++i) {
      if (c0 + i < nc) {
        sv[i] = st[(c0 + i) * np4];
        d[i] = tr[c0 + i];
      }
    }
#pragma unroll
    for (int i = 0; i < kPassDepth; ++i) {
      if (c0 + i < nc) {
        st[(c0 + i) * np4] = h;
        const float dc = expf(d[i]);
        h.x = fmaf(dc, h.x, sv[i].x);
        h.y = fmaf(dc, h.y, sv[i].y);
        h.z = fmaf(dc, h.z, sv[i].z);
        h.w = fmaf(dc, h.w, sv[i].w);
      }
    }
  }
}

__global__ void __launch_bounds__(kOutThreads)
ssd_out_kernel(const float* __restrict__ x, const float* __restrict__ ld,
               const float* __restrict__ bm, const float* __restrict__ cm,
               const float* __restrict__ states, float* __restrict__ y,
               int heads, long long nc, long long l, int p, int n, int q) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const OutLayout lay = out_layout(q, n, p);
  float* cs = smem + lay.cs;
  float* bs = smem + lay.x0;   // B, then buffer 0's X
  float* cbs = smem + lay.cb;
  float* ss = smem + lay.s;
  float* es = smem + lay.es;
  const int tid = threadIdx.x, warp = tid >> 5;
  const BlockWork bw = block_work(nc, heads, kOutHeadsPerBlock);
  const long long t0 = bw.c * q;
  const long long row0 = bw.g * heads;
  const int qt = q / 16;

  // group 0: C and B; group 1: the first head's X and h_prev (buffer 1)
  copy_tile(cs, lay.ldc, cm + (bw.g * l + t0) * n, n, q, n);
  copy_tile(bs, lay.ldb, bm + (bw.g * l + t0) * n, n, q, n);
  cp_async_commit();
  copy_tile(smem + lay.x1, lay.ldx, x + ((row0 + bw.h0) * l + t0) * p, p, q,
            p);
  copy_tile(smem + lay.h1, lay.ldh, states + ((row0 + bw.h0) * nc + bw.c) *
            n * p, p, n, p);
  cp_async_commit();
  cp_async_wait(1);
  __syncthreads();

  // C B^T once for the tile's heads, on and below the diagonal: whole
  // 8-column tiles up to each 16-row tile's last row
  const int ubs = (q + 63) / 64;
  for (int item = warp; item < qt * ubs; item += kOutWarps) {
    const int m0 = (item % qt) * 16, u0 = (item / qt) * 64;
    if (u0 > m0 + 15) continue;
    const int ntiles = min(8, (m0 + 16 - u0) / 8);
    float acc[8][4] = {};
    warp_mma(
        acc, ntiles, 0, n,
        [&](int r, int k) { return cs[(m0 + r) * lay.ldc + k]; },
        [&](int k, int col) { return bs[(u0 + col) * lay.ldb + k]; });
    store_tile(cbs, lay.ldcb, m0, u0, ntiles, acc);
  }

  for (int h = bw.h0; h < bw.h1; ++h) {
    const long long row = row0 + h;
    const int buf = (h - bw.h0 + 1) & 1;
    const float* xs = smem + (buf ? lay.x1 : lay.x0);
    const float* hs = smem + (buf ? lay.h1 : lay.h0);
    __syncthreads();   // C B^T is formed; the previous head is done
    const bool next = h + 1 < bw.h1;
    if (next) {        // into the other buffer (B's space for the 2nd head)
      copy_tile(smem + (buf ? lay.x0 : lay.x1), lay.ldx,
                x + ((row + 1) * l + t0) * p, p, q, p);
      copy_tile(smem + (buf ? lay.h0 : lay.h1), lay.ldh,
                states + ((row + 1) * nc + bw.c) * n * p, p, n, p);
      cp_async_commit();
    }
    for (int i = tid; i < q; i += kOutThreads) ss[i] = ld[row * l + t0 + i];
    cp_async_wait(next);
    __syncthreads();
    chunk_cumsum(ss, q);
    __syncthreads();
    for (int i = tid; i < q; i += kOutThreads) {
      const float si = ss[i];
      es[i] = expf(si);
      ss[i] = si * kLog2e;   // G's decay is 2^(ss[t] - ss[u]) below
    }
    __syncthreads();

    // Y tiles of 16 rows by 32 columns; odd column blocks walk the rows
    // backwards, so a warp's causal work is balanced across its items
    float* dst = y + (row * l + t0) * p;
    const int pbs = (p + 31) / 32;
    for (int item = warp; item < qt * pbs; item += kOutWarps) {
      const int pb = item / qt, mi = item - pb * qt;
      const int m0 = ((pb & 1) ? qt - 1 - mi : mi) * 16, p0 = pb * 32;
      const int ntiles = min(4, (p - p0) / 8);
      float acc[4][4] = {};
      warp_mma(
          acc, ntiles, 0, m0 + 16,
          [&](int r, int u) {
            const int t = m0 + r;
            return u <= t ? cbs[t * lay.ldcb + u] * ex2_approx(ss[t] - ss[u])
                          : 0.0f;
          },
          [&](int u, int col) { return xs[u * lay.ldx + p0 + col]; });
      warp_mma(
          acc, ntiles, 0, n,
          [&](int r, int k) { return cs[(m0 + r) * lay.ldc + k] * es[m0 + r]; },
          [&](int k, int col) { return hs[k * lay.ldh + p0 + col]; });
      store_tile(dst, p, m0, p0, ntiles, acc);
    }
  }
}

cudaError_t run(const float* x, const float* ld, const float* b,
                const float* c, float* y, float* states, float* tot,
                long long bh, int heads, long long l, int p, int n, int q,
                cudaStream_t stream) {
  const int smem1 = state_layout(q, n, p).total * 4;
  const int smem3 = out_layout(q, n, p).total * 4;
  // more than the 227 KB a block can opt into fails the attribute call
  cudaError_t err = cudaFuncSetAttribute(
      ssd_state_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_out_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem3);
  if (err != cudaSuccess) return err;
  const long long nc = l / q;
  const auto blocks = [&](int per) {
    return static_cast<unsigned int>((bh / heads) * nc *
                                     ((heads + per - 1) / per));
  };
  ssd_state_kernel<<<blocks(kStateHeadsPerBlock), kThreads, smem1,
                     stream>>>(x, ld, b, states, tot, heads, nc, l, p, n, q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long np4 = static_cast<long long>(n) * p / 4;
  const long long pass_blocks = (bh * np4 + kThreads - 1) / kThreads;
  ssd_pass_kernel<<<static_cast<unsigned int>(pass_blocks), kThreads, 0,
                    stream>>>(states, tot, bh, nc, np4);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_out_kernel<<<blocks(kOutHeadsPerBlock), kOutThreads, smem3,
                   stream>>>(x, ld, b, c, states, y, heads, nc, l, p, n, q);
  return cudaGetLastError();
}

}  // namespace

// Launches the three kernels on `stream` of CUDA device `device` and
// returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a
// shape the kernels do not take.  Pointers are 16-byte aligned device
// pointers to contiguous float32 x (bh, l, p), ld (bh, l), b and c
// (bh / heads, l, n), y (bh, l, p), and the scratch states (bh, l / q, n,
// p) and tot (bh, l / q).  The library links its own CUDA runtime, so it
// selects the device itself.
extern "C" int ssd_scan_launch(const void* x, const void* ld, const void* b,
                               const void* c, void* y, void* states,
                               void* tot, long long bh, int heads,
                               long long l, int p, int n, int q, void* stream,
                               int device) {
  if (q <= 0 || q % 16 != 0 || n <= 0 || n % 16 != 0 || p <= 0 ||
      p % 8 != 0 || l % q != 0 || heads <= 0 || bh % heads != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bh == 0 || l == 0) return 0;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* xf = static_cast<const float*>(x);
  const auto* lf = static_cast<const float*>(ld);
  const auto* bf = static_cast<const float*>(b);
  const auto* cf = static_cast<const float*>(c);
  auto* yf = static_cast<float*>(y);
  auto* sf = static_cast<float*>(states);
  auto* tf = static_cast<float*>(tot);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      run(xf, lf, bf, cf, yf, sf, tf, bh, heads, l, p, n, q, s));
}
