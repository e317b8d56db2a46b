// Fused attention forward for Hopper (sm_90a), f32 end to end.
//
//   O[b, i, h] = softmax_j( mask(cap(scale · q[b, i, h] · k[b, j, h / rep])) )
//                · v[b, j, h / rep]
//
// q (B, Sq, H, hd), k and v (B, Skv, KV, hd), rep = H / KV (GQA), any
// strides with the last one 1, in the port's own layout; o (B, Sq, H, hd)
// contiguous.  Query row i sits at global position i + q_offset; key j at
// position j.  The mask is the composed path's (models/attention._sdpa,
// _sdpa_online): causal keeps j <= i + q_offset, a window w keeps
// j > i + q_offset - w, and a masked score is -1e30, so a row with no key
// left takes the uniform softmax over all Skv keys, as masked_fill and
// softmax give it.  cap is the logit softcap, cap · tanh(x / cap) after the
// scale.
//
// Replaces no TPU kernel: the JAX package has no Pallas attention kernel
// and leaves attention to XLA.  It is added because the port's composed
// attention builds the whole (B, H, Sq, Skv) f32 logits tensor in device
// memory and makes five passes over it (the product, the scale, the mask,
// the softmax, the second product), and computes the full square where a
// causal mask needs half.
//
// Bound.  At minicpm-2B's scoring call (B = 24, 36 heads of 64, L = 2048,
// causal) the work is 2 · hd FLOP for the score and 2 · hd for the value of
// each of the L (L + 1) / 2 query-key pairs per head: 4.641e11 FLOP, 6.93
// ms at 67 TFLOP/s (f32 FFMA; the configuration keeps TF32 off, so no
// tensor core).  q, k, v and o are 1.81e9 B, 0.54 ms at 3.35 TB/s.  So the
// call is bound by its arithmetic.  (The hybrid's shared block, B = 32, 32
// heads of 80: 6.875e11 FLOP, 10.26 ms; 2.68e9 B, 0.80 ms.)
//
// Design.  One block of 128 threads per (tile of 64 query rows, batch and
// head); blockIdx.x walks the query tiles from the last, so within each
// head the longest causal rows start first, and the blocks of one head run
// together and share its K and V in L2.  The block's Q tile is loaded once,
// scaled, and kept transposed in shared memory.  K and V stream in tiles of
// 64 keys through one K slot and one V slot filled by cp.async: the next
// K tile is loaded while the softmax and P·V of this one run, the V tile
// while S = Q·Kᵀ runs; three barriers per tile.  Each thread owns an 8 × 4 micro-tile
// of S (rows rg·4 + {0..3} and 32 + rg·4 + {0..3}, keys cg + 16·{0..3})
// and the same 8 rows of O (hd / 16 columns), all in registers as FFMA
// accumulators; the 16 threads of a row group are one half-warp, so row
// maxima and sums are four shuffles.  The online softmax works in base 2
// (exp2f on scores pre-scaled by log2 e) with the running max, normaliser
// and O rescale in registers.  P goes through shared memory once per tile
// (transposed, for the P·V micro-tile).  No score or probability is written
// to device memory.  Tiles that the causal mask or the window masks for
// every row of the block are never loaded: their entries would add
// exp(-1e30 - m) = 0 exactly.  A block that holds a row with no key left
// visits every tile, so that row gets the composed path's uniform answer.
// Tiles that no row masks skip the per-entry mask.  Keys past Skv score
// -inf and their V rows are zero-filled.  Shared-memory row strides are
// padded by 4 floats so that the 16-byte loads of a quarter-warp hit 32
// distinct banks.  hd is a template parameter (64, 80, 128); a block holds
// 69,632 / 82,176 / 119,808 B of shared memory, three / two / one blocks
// per SM.  No TF32, no fast math: the products are f32 FFMA, the
// exponentials exp2f, the cap tanhf.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per tile
constexpr int kThreads = 128;    // 8 row groups x 16 column groups
constexpr int kRows = 8;         // rows of S and O per thread
constexpr int kCols = 4;         // keys of S per thread
constexpr int kLdQ = kBQ + 4;    // row stride of Q^T and P^T (floats)
constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Tile {
  static constexpr int kLdKV = HD + 4;       // row stride of K and V
  static constexpr int kOCols = HD / 16;     // O columns per thread
  static constexpr int kQ = 0;               // offsets in floats
  static constexpr int kK = kQ + HD * kLdQ;
  static constexpr int kV = kK + kBK * kLdKV;
  static constexpr int kP = kV + kBK * kLdKV;
  static constexpr int kFloats = kP + kBK * kLdQ;
  static constexpr int kMinBlocks = HD <= 64 ? 3 : (HD <= 80 ? 2 : 1);
  static_assert(HD % 16 == 0 && HD >= 64 && HD <= 128, "head dim");
};

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  long long q_sb, q_ss, q_sh;   // strides in floats: batch, position, head
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int heads, kv_heads, sq, skv;
  int q_offset;
  int window;                   // 0: no window
  int causal;
  float qscale;                 // scale · log2 e, or scale under a cap
  float cap;                    // 0: no cap
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;   // 0 source bytes: the 16 are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every group but the newest N has landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows of the thread's micro-tile: rg·4 + {0..3}, then 32 + rg·4 + {0..3}
__device__ __forceinline__ int row_of(int rg, int i) {
  return rg * 4 + (i & 3) + (i >> 2) * 32;
}

// K or V rows t·kBK … t·kBK + kBK − 1 into a [kBK][HD + 4] slot
template <int HD>
__device__ __forceinline__ void load_kv(float* slot, const float* g,
                                        long long stride, int t, int skv) {
  constexpr int kChunks = HD / 4;
  constexpr int kLd = Tile<HD>::kLdKV;
#pragma unroll
  for (int i = 0; i < kBK * kChunks / kThreads; ++i) {
    const int idx = static_cast<int>(threadIdx.x) + i * kThreads;
    const int r = idx / kChunks;
    const int c = idx % kChunks;
    const int key = t * kBK + r;
    const bool valid = key < skv;
    cp_async16(slot + r * kLd + c * 4,
               valid ? g + key * stride + c * 4 : g, valid);
  }
}

// whether query position pos has no key left under the mask
__device__ __forceinline__ bool no_key(const Params& p, int pos) {
  const int lo = p.window > 0 ? max(0, pos - p.window + 1) : 0;
  const int hi = p.causal ? min(p.skv, pos + 1) : p.skv;
  return lo >= hi;
}

__device__ __forceinline__ float component(const float4& f, int i) {
  return i == 0 ? f.x : (i == 1 ? f.y : (i == 2 ? f.z : f.w));
}

template <int HD>
__global__ void __launch_bounds__(kThreads, Tile<HD>::kMinBlocks)
    attn_fwd_kernel(Params p, int b0) {
  using T = Tile<HD>;
  constexpr int kOCols = T::kOCols;
  constexpr int kLd = T::kLdKV;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qs = smem + T::kQ;   // [HD][kLdQ]: Q^T, pre-scaled
  float* ks = smem + T::kK;   // [kBK][kLd]
  float* vs = smem + T::kV;   // [kBK][kLd]
  float* ps = smem + T::kP;   // [kBK][kLdQ]: P^T

  const int tid = static_cast<int>(threadIdx.x);
  const int rg = tid >> 4;
  const int cg = tid & 15;
  const int qt = static_cast<int>(gridDim.x - 1 - blockIdx.x);
  const int b = b0 + static_cast<int>(blockIdx.y) / p.heads;
  const int h = static_cast<int>(blockIdx.y) % p.heads;
  const int kvh = h / (p.heads / p.kv_heads);
  const int q0 = qt * kBQ;
  const int nrows = min(kBQ, p.sq - q0);
  const float* qg = p.q + b * p.q_sb + h * p.q_sh;
  const float* kg = p.k + b * p.k_sb + kvh * p.k_sh;
  const float* vg = p.v + b * p.v_sb + kvh * p.v_sh;

  // the key tiles some row of the block reads
  const int first = p.q_offset + q0;          // position of row 0
  const int last = first + nrows - 1;
  int lo = 0;
  int hi = p.skv;
  if (!(no_key(p, first) || no_key(p, last))) {
    if (p.causal) hi = min(hi, last + 1);
    if (p.window > 0) lo = max(0, first - p.window + 1);
  }
  const int t_lo = lo / kBK;
  const int t_hi = (hi + kBK - 1) / kBK;

  if (t_lo < t_hi) load_kv<HD>(ks, kg, p.k_ss, t_lo, p.skv);
  cp_async_commit();
  {  // Q, scaled and transposed; rows past Sq are zero
    constexpr int kChunks = HD / 4;
#pragma unroll
    for (int i = 0; i < kBQ * kChunks / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / kChunks;
      const int c = idx % kChunks;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < nrows)
        x = __ldg(reinterpret_cast<const float4*>(
            qg + (q0 + r) * p.q_ss + c * 4));
      qs[(c * 4 + 0) * kLdQ + r] = x.x * p.qscale;
      qs[(c * 4 + 1) * kLdQ + r] = x.y * p.qscale;
      qs[(c * 4 + 2) * kLdQ + r] = x.z * p.qscale;
      qs[(c * 4 + 3) * kLdQ + r] = x.w * p.qscale;
    }
  }

  float o[kRows][kOCols];
  float m[kRows];
  float l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kOCols; ++c) o[i][c] = 0.f;
  }
  const float cap_l2 = p.cap * kLog2e;
  const float inv_cap = p.cap > 0.f ? 1.f / p.cap : 0.f;

  for (int t = t_lo; t < t_hi; ++t) {
    cp_async_wait<0>();    // K_t has landed
    __syncthreads();       // … for every thread (Q too, on the first
                           // tile), and every thread is done with V_{t-1}
                           // and P_{t-1}
    load_kv<HD>(vs, vg, p.v_ss, t, p.skv);
    cp_async_commit();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4   // faster on the H100 than a full unroll (PERF.md)
    for (int d4 = 0; d4 < HD / 4; ++d4) {
      float4 kf[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        kf[j] = *reinterpret_cast<const float4*>(ks + (cg + 16 * j) * kLd +
                                                 d4 * 4);
#pragma unroll
      for (int dd = 0; dd < 4; ++dd) {
        const float* qrow = qs + (d4 * 4 + dd) * kLdQ;
        const float4 qa = *reinterpret_cast<const float4*>(qrow + rg * 4);
        const float4 qb =
            *reinterpret_cast<const float4*>(qrow + 32 + rg * 4);
        const float qv[kRows] = {qa.x, qa.y, qa.z, qa.w,
                                 qb.x, qb.y, qb.z, qb.w};
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < kCols; ++j)
            s[i][j] = fmaf(qv[i], component(kf[j], dd), s[i][j]);
      }
    }
    __syncthreads();       // every thread is done with K_t
    if (t + 1 < t_hi) load_kv<HD>(ks, kg, p.k_ss, t + 1, p.skv);
    cp_async_commit();

    // cap, mask, and the online softmax in base 2
    const int k0 = t * kBK;
    const bool masked_tile =
        k0 + kBK > p.skv || (p.causal && k0 + kBK - 1 > first) ||
        (p.window > 0 && k0 <= last - p.window);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int pos = first + row_of(rg, i);
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        float x = s[i][j];
        if (p.cap > 0.f) x = cap_l2 * tanhf(x * inv_cap);
        if (masked_tile) {
          const int key = k0 + cg + 16 * j;
          if (key >= p.skv)
            x = -CUDART_INF_F;
          else if ((p.causal && key > pos) ||
                   (p.window > 0 && key <= pos - p.window))
            x = kMasked;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = exp2f(m[i] - m_new);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        s[i][j] = exp2f(s[i][j] - m_new);
        sum += s[i][j];
      }
      l[i] = l[i] * corr + sum;   // this thread's keys; summed at the end
#pragma unroll
      for (int c = 0; c < kOCols; ++c) o[i][c] *= corr;
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      float* prow = ps + (cg + 16 * j) * kLdQ;
      *reinterpret_cast<float4*>(prow + rg * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
      *reinterpret_cast<float4*>(prow + 32 + rg * 4) =
          make_float4(s[4][j], s[5][j], s[6][j], s[7][j]);
    }
    cp_async_wait<1>();    // V_t has landed (K_{t+1} may not have)
    __syncthreads();       // … and every thread's P is written

#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float* prow = ps + kk * kLdQ;
      const float4 pa = *reinterpret_cast<const float4*>(prow + rg * 4);
      const float4 pb = *reinterpret_cast<const float4*>(prow + 32 + rg * 4);
      const float pv[kRows] = {pa.x, pa.y, pa.z, pa.w,
                               pb.x, pb.y, pb.z, pb.w};
      const float* vrow = vs + kk * kLd;
      float vv[kOCols];
      const float4 va = *reinterpret_cast<const float4*>(vrow + cg * 4);
      vv[0] = va.x;
      vv[1] = va.y;
      vv[2] = va.z;
      vv[3] = va.w;
      if constexpr (kOCols == 8) {
        const float4 vb =
            *reinterpret_cast<const float4*>(vrow + 64 + cg * 4);
        vv[4] = vb.x;
        vv[5] = vb.y;
        vv[6] = vb.z;
        vv[7] = vb.w;
      } else if constexpr (kOCols == 5) {
        vv[4] = vrow[64 + cg];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < kOCols; ++c)
          o[i][c] = fmaf(pv[i], vv[c], o[i][c]);
    }
  }

  float* og = p.o + ((static_cast<long long>(b) * p.sq + q0) * p.heads + h) *
                        HD;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    float li = l[i];
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
      li += __shfl_xor_sync(0xffffffffu, li, off);
    const int r = row_of(rg, i);
    if (r >= nrows) continue;
    li = fmaxf(li, 1e-30f);   // no key at all (Skv = 0): 0, as composed
    float* orow = og + static_cast<long long>(r) * p.heads * HD;
    *reinterpret_cast<float4*>(orow + cg * 4) =
        make_float4(o[i][0] / li, o[i][1] / li, o[i][2] / li, o[i][3] / li);
    if constexpr (kOCols == 8)
      *reinterpret_cast<float4*>(orow + 64 + cg * 4) = make_float4(
          o[i][4] / li, o[i][5] / li, o[i][6] / li, o[i][7] / li);
    else if constexpr (kOCols == 5)
      orow[64 + cg] = o[i][4] / li;
  }
}

template <int HD>
cudaError_t run(const Params& p, int batch, cudaStream_t stream) {
  const int bytes = Tile<HD>::kFloats * 4;
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const unsigned tiles = static_cast<unsigned>((p.sq + kBQ - 1) / kBQ);
  const int per = 65535 / p.heads;   // grid.y holds at most 65535
  for (int b0 = 0; b0 < batch; b0 += per) {
    const dim3 grid(tiles, static_cast<unsigned>(min(per, batch - b0) *
                                                 p.heads));
    attn_fwd_kernel<HD><<<grid, kThreads, bytes, stream>>>(p, b0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" int attn_fwd_launch(const void* q, const void* k, const void* v,
                               void* o, long long q_sb, long long q_ss,
                               long long q_sh, long long k_sb,
                               long long k_ss, long long k_sh,
                               long long v_sb, long long v_ss,
                               long long v_sh, int batch, int sq, int skv,
                               int heads, int kv_heads, int hd, int q_offset,
                               int window, int causal, float scale,
                               float cap, void* stream, int device) {
  if (batch < 0 || sq < 0 || skv < 0 || heads <= 0 || kv_heads <= 0 ||
      heads % kv_heads != 0 || heads > 65535 || window < 0 || cap < 0.f)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || sq == 0) return 0;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.o = static_cast<float*>(o);
  p.q_sb = q_sb;
  p.q_ss = q_ss;
  p.q_sh = q_sh;
  p.k_sb = k_sb;
  p.k_ss = k_ss;
  p.k_sh = k_sh;
  p.v_sb = v_sb;
  p.v_ss = v_ss;
  p.v_sh = v_sh;
  p.heads = heads;
  p.kv_heads = kv_heads;
  p.sq = sq;
  p.skv = skv;
  p.q_offset = q_offset;
  p.window = window;
  p.causal = causal;
  p.qscale = cap > 0.f ? scale : scale * kLog2e;
  p.cap = cap;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return static_cast<int>(run<64>(p, batch, s));
    case 80:
      return static_cast<int>(run<80>(p, batch, s));
    case 128:
      return static_cast<int>(run<128>(p, batch, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
