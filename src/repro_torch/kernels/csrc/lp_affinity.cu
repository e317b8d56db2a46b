// Block-affinity histogram for Hopper (sm_90a): the hot loop of k-way
// label-propagation refinement.
//
//   aff[b, v, c] = sum_j wgt[v, j] * [labels[b, nbr[v, j]] == c]
//
// Replaces the TPU kernel `_affinity_kernel` / `affinity_pallas` in
// src/repro/kernels/lp_affinity.py (body :30, pl.pallas_call :64).  On the
// TPU, XLA gathered labels[nbr] before the kernel, k was padded to 128 and
// the batch came from vmap; here the gather is fused, k is not padded, and
// one launch covers all B rows.
//
// Design.  A block of kT threads owns kT consecutive vertices, one thread
// per vertex.  It stages the tile's wgt and nbr rows into shared memory,
// kChunk slots at a time with 16-byte loads, laid
// out [slot][vertex] so that each thread then reads its own row without
// bank conflicts.  The staged tile serves every one of the B label rows:
// when dmax fits one chunk (the main path's dmax = 8) the ELL is read once
// per launch.  Per row b, each thread gathers its slots' labels (padding,
// wgt == 0, becomes -1 and is never gathered) and sums on chip, never in
// device memory:
//   - k <= 32: in registers, a template on the k bucket (4, 8, 16, 32);
//     each live slot does a compare and a predicated add on every
//     accumulator, so no register is indexed at run time;
//   - k > 32: in a per-thread histogram in shared memory laid out
//     [class][thread] (conflict-free), in slices of at most kSliceMax
//     classes, so every k runs.
// Each warp then writes its 32 vertices' outputs through a per-warp
// transpose buffer: for k <= 32 the warp's (32, k) tile of the row is one
// contiguous block written by neighbouring lanes to neighbouring
// addresses; for k > 32 each store covers 32 consecutive classes of one
// vertex (128 bytes).  No atomics, and every (b, v, c) sum adds its live
// slots in order j = 0, 1, ...; the plain version adds +0.0 for the other
// slots, which changes no value.  So the result equals the plain PyTorch
// version bit for bit.
// Labels outside [0, k) contribute nothing, as in the one-hot reference.
//
// Bound: memory.  One call must read the whole weight array
// (n_pad*dmax*4 bytes: it marks the live slots), the neighbour ids of live
// slots only (4 bytes each) and the labels (B*n_pad*4), and write the
// output (B*n_pad*k*4); it does one addition per live slot and row.  At
// the 1M-vertex main path (B=1, n_pad=2^20, dmax=8, k=16, 4,190,208 live
// slots) that is 121,618,432 bytes, 0.0363 ms at 3.35 TB/s; the output is
// 55% of it.  This kernel also reads the padding slots' ids (16.8 MB more
// there), which the coalesced staging cannot skip.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kT = 128;          // vertices (threads) per block
constexpr int kWarps = kT / 32;
constexpr int kChunk = 32;       // ELL slots staged per pass
constexpr int kSliceMax = 128;   // classes per shared-histogram slice

// Shared-memory plan of one launch, in 4-byte words.
struct Plan {
  int dc;        // slots staged per pass
  int nchunks;   // passes over dmax
  int kr;        // register bucket (4, 8, 16, 32), or 0: shared histogram
  int ts;        // row stride of the per-warp transpose buffer
  int ks;        // histogram slice (classes), 0 in the register path
  int words;
};

Plan make_plan(int dmax, int k) {
  Plan p;
  p.dc = dmax < kChunk ? dmax : kChunk;
  p.nchunks = dmax == 0 ? 0 : (dmax + p.dc - 1) / p.dc;
  p.kr = k <= 4 ? 4 : k <= 8 ? 8 : k <= 16 ? 16 : k <= 32 ? 32 : 0;
  if (p.kr) {
    p.ts = k | 1;              // odd: each lane's row on its own bank
    p.ks = 0;
  } else {
    p.ts = 33;
    const int slices = (k + kSliceMax - 1) / kSliceMax;
    const int per = (k + slices - 1) / slices;
    p.ks = (per + 31) / 32 * 32;
  }
  p.words = 3 * kT * p.dc + kWarps * 32 * p.ts + p.ks * kT;
  return p;
}

// Stage slots [j0, j0 + width) of the tile's rows into sw/sn[slot][vertex]
// with 16-byte loads (dmax and width are multiples of 4); rows past n_pad
// read as padding (wgt 0).
__device__ void stage(const int* __restrict__ nbr,
                      const float* __restrict__ wgt, float* sw, int* sn,
                      long long v0, long long n_pad, int dmax, int j0,
                      int width) {
  const int q4 = width / 4;
  for (int i = threadIdx.x; i < kT * q4; i += kT) {
    const int r = i / q4, j = (i - r * q4) * 4;
    const long long v = v0 + r;
    float4 w = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    int4 nb = make_int4(0, 0, 0, 0);
    if (v < n_pad) {
      const long long off = v * dmax + j0 + j;
      w = *reinterpret_cast<const float4*>(wgt + off);
      nb = *reinterpret_cast<const int4*>(nbr + off);
    }
    sw[j * kT + r] = w.x;
    sw[(j + 1) * kT + r] = w.y;
    sw[(j + 2) * kT + r] = w.z;
    sw[(j + 3) * kT + r] = w.w;
    sn[j * kT + r] = nb.x;
    sn[(j + 1) * kT + r] = nb.y;
    sn[(j + 2) * kT + r] = nb.z;
    sn[(j + 3) * kT + r] = nb.w;
  }
}

// This thread's labels of its staged slots: sl[j][tid] = labels[nbr] for a
// live slot, -1 for padding (its id is never read).
__device__ __forceinline__ void gather(const float* sw, const int* sn,
                                       int* sl, const int* __restrict__ lrow,
                                       int width) {
  const int t = threadIdx.x;
#pragma unroll 8
  for (int j = 0; j < width; ++j) {
    const int i = j * kT + t;
    sl[i] = sw[i] != 0.0f ? lrow[sn[i]] : -1;
  }
}

template <int KR>
__global__ void __launch_bounds__(kT)
lp_affinity_kernel(const int* __restrict__ nbr, const float* __restrict__ wgt,
                   const int* __restrict__ labels, float* __restrict__ aff,
                   long long batch, long long n_pad, int dmax, int k,
                   Plan plan) {
  extern __shared__ float4 smem4[];
  float* sw = reinterpret_cast<float*>(smem4);
  int* sn = reinterpret_cast<int*>(sw + kT * plan.dc);
  int* sl = sn + kT * plan.dc;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* tb = reinterpret_cast<float*>(sl + kT * plan.dc) +
              warp * 32 * plan.ts;
  float* hist = reinterpret_cast<float*>(sl + kT * plan.dc) +
                kWarps * 32 * plan.ts;

  const long long v0 = static_cast<long long>(blockIdx.x) * kT;
  const long long row0 = v0 + warp * 32;
  const int rows = static_cast<int>(
      row0 >= n_pad ? 0 : (n_pad - row0 < 32 ? n_pad - row0 : 32));
  const bool once = plan.nchunks <= 1;
  if (once && plan.nchunks == 1) {
    stage(nbr, wgt, sw, sn, v0, n_pad, dmax, 0, dmax);
    __syncthreads();
  }

  for (long long b = 0; b < batch; ++b) {
    const int* lrow = labels + b * n_pad;
    if (once) gather(sw, sn, sl, lrow, dmax);
    if constexpr (KR > 0) {
      float acc[KR];
#pragma unroll
      for (int c = 0; c < KR; ++c) acc[c] = 0.0f;
      for (int ch = 0; ch < plan.nchunks; ++ch) {
        const int j0 = ch * plan.dc;
        const int width = dmax - j0 < plan.dc ? dmax - j0 : plan.dc;
        if (!once) {
          __syncthreads();
          stage(nbr, wgt, sw, sn, v0, n_pad, dmax, j0, width);
          __syncthreads();
          gather(sw, sn, sl, lrow, width);
        }
        for (int j = 0; j < width; ++j) {
          const int lab = sl[j * kT + tid];
          if (static_cast<unsigned>(lab) >= static_cast<unsigned>(k)) continue;
          const float w = sw[j * kT + tid];
#pragma unroll
          for (int c = 0; c < KR; ++c)
            if (lab == c) acc[c] += w;
        }
      }
      // the warp's (32, k) tile of row b is contiguous in aff
#pragma unroll
      for (int c = 0; c < KR; ++c)
        if (c < k) tb[lane * plan.ts + c] = acc[c];
      __syncwarp();
      float* dst = aff + (b * n_pad + row0) * k;
      int r = lane / k, c = lane - r * k;   // (row, class) of element i
      const int dr = 32 / k, dc = 32 - dr * k;
      for (int i = lane; i < rows * k; i += 32) {
        dst[i] = tb[r * plan.ts + c];
        r += dr;
        c += dc;
        if (c >= k) {
          c -= k;
          ++r;
        }
      }
      __syncwarp();
    } else {
      float* h = hist + tid;   // this thread's column, [class][thread]
      for (int c0 = 0; c0 < k; c0 += plan.ks) {
        const int kw = k - c0 < plan.ks ? k - c0 : plan.ks;
        for (int c = 0; c < kw; ++c) h[c * kT] = 0.0f;
        for (int ch = 0; ch < plan.nchunks; ++ch) {
          const int j0 = ch * plan.dc;
          const int width = dmax - j0 < plan.dc ? dmax - j0 : plan.dc;
          if (!once) {
            __syncthreads();
            stage(nbr, wgt, sw, sn, v0, n_pad, dmax, j0, width);
            __syncthreads();
            gather(sw, sn, sl, lrow, width);
          }
          for (int j = 0; j < width; ++j) {
            const int d = sl[j * kT + tid] - c0;
            if (static_cast<unsigned>(d) >= static_cast<unsigned>(kw))
              continue;
            h[d * kT] += sw[j * kT + tid];
          }
        }
        // transpose 32 classes at a time: each lane reads its own column,
        // then each store writes 32 consecutive classes of one vertex
        for (int cb = 0; cb < kw; cb += 32) {
          const int cw = kw - cb < 32 ? kw - cb : 32;
          for (int j = 0; j < cw; ++j) tb[lane * 33 + j] = h[(cb + j) * kT];
          __syncwarp();
          if (lane < cw)
            for (int r = 0; r < rows; ++r)
              aff[(b * n_pad + row0 + r) * k + c0 + cb + lane] =
                  tb[r * 33 + lane];
          __syncwarp();
        }
      }
    }
  }
}

template <int KR>
cudaError_t launch(const int* nbr, const float* wgt, const int* labels,
                   float* aff, long long batch, long long n_pad, int dmax,
                   int k, const Plan& plan, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(plan.words) * 4;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lp_affinity_kernel<KR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const long long blocks = (n_pad + kT - 1) / kT;
  lp_affinity_kernel<KR><<<static_cast<unsigned int>(blocks), kT, smem,
                           stream>>>(nbr, wgt, labels, aff, batch, n_pad,
                                     dmax, k, plan);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` of CUDA device `device` and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a shape
// the kernel does not take.  Pointers are 16-byte aligned device pointers
// to contiguous int32 nbr (n_pad, dmax), float32 wgt (n_pad, dmax), int32
// labels (batch, n_pad) and float32 aff (batch, n_pad, k); dmax is a
// multiple of 4 (the wrapper pads it with zero-weight slots).  The library
// links its own CUDA runtime, so it selects the device itself.
extern "C" int lp_affinity_launch(const void* nbr, const void* wgt,
                                  const void* labels, void* aff,
                                  long long batch, long long n_pad, int dmax,
                                  int k, void* stream, int device) {
  if (k < 1 || dmax < 0 || dmax % 4 != 0 ||
      reinterpret_cast<uintptr_t>(nbr) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(wgt) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch * n_pad == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const Plan plan = make_plan(dmax, k);
  const int* n = static_cast<const int*>(nbr);
  const float* w = static_cast<const float*>(wgt);
  const int* l = static_cast<const int*>(labels);
  float* a = static_cast<float*>(aff);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (plan.kr) {
    case 4: err = launch<4>(n, w, l, a, batch, n_pad, dmax, k, plan, s); break;
    case 8: err = launch<8>(n, w, l, a, batch, n_pad, dmax, k, plan, s); break;
    case 16: err = launch<16>(n, w, l, a, batch, n_pad, dmax, k, plan, s); break;
    case 32: err = launch<32>(n, w, l, a, batch, n_pad, dmax, k, plan, s); break;
    default: err = launch<0>(n, w, l, a, batch, n_pad, dmax, k, plan, s); break;
  }
  return static_cast<int>(err);
}
