// Per-net pin-count histogram for Hopper (sm_90a): the hot loop of
// hypergraph LP refinement.
//
//   cnt[b, e, c]   = sum_{p in net e} mask[p] * [labels[b, pins[p]] == c]
//   score[b, e, c] = netw[e] * cnt[b, e, c]          (ELL entry only)
//
// Replaces the TPU kernel `_pin_affinity_kernel` / `pin_affinity_pallas`
// in src/repro/kernels/pin_affinity.py (body :33, pl.pallas_call :71).  On
// the TPU, XLA gathered labels[pins] before the kernel, k was padded to 128,
// the batch came from vmap and the pins came as an (e_pad, pmax) ELL padded
// to pow2(max net size).  Here the gather is fused, k is the scan's block
// bucket (not padded to 128), one launch covers all B label rows, and one
// kernel body reads the pins in either of two addressings, a template
// parameter:
//   - CSR (the main path): net e's pins are [eptr[e], eptr[e+1]) of the
//     flat pin list already on the card (PinCoo.pv / .mask); writes cnt
//     only, the one output the refinement scan reads.
//   - ELL: net e's pins are [e*pmax, (e+1)*pmax) of the (e_pad, pmax)
//     view, mask-0 slots skipped (mask == 0 is the only padding mark: a
//     padding slot's id may alias a real vertex, so it is never gathered);
//     writes cnt and score, as the TPU kernel did (ops.pin_count).
//
// Design.  A warp owns 32 consecutive nets; their pins are contiguous in
// both addressings.  The warp stages them into its own shared-memory window
// of kWindow = 256 pins with coalesced 16-byte loads, every load of a lane
// in flight at once (the ELL entry reads an id group only after its masks
// show a live slot: most of its slots are padding).  A window starts at the
// first net not yet counted and takes every net that ends inside it; a net
// that is not split always fits one, so no count is carried between
// windows and one staged window serves all B rows.  For each row the warp
// gathers the window's labels (neighbouring lanes, neighbouring pins, 8
// loads in flight per lane; the labels, B*n_pad*4 bytes, stay in the 50 MB
// L2).  The window's nf nets are then counted from shared memory by groups
// of L lanes, L the largest power of two with L*nf <= 32: one lane per net
// when the window holds 32 nets (the CSR's usual case); 8 lanes per row of
// a 64-slot ELL, which would otherwise leave 28 lanes idle.  The lanes of a
// group split the net's classes, not its pins: lane q walks all of the
// net's pins in order and counts those whose class is q mod L.  On the ELL
// the group first finds the row's last live slot (each lane scans every
// L-th mask), so the walk stops there and not at the row's padded end.
// The window is small so that 12 KB of shared memory per block lets ~48
// warps share an SM: a warp's chain of round trips (offsets, pins, labels,
// store) is latency, which only many warps in flight hide.
// Counts stay on chip:
//   - k <= 32: in registers, a template on the k bucket (4, 8, 16, 32): a
//     compare and a predicated add per class, no run-time register index;
//     a group's partial counts meet by `__shfl_xor_sync` (in a window net
//     only one lane holds a class's count; the others add +0.0), and its
//     first lane writes the net's k counts with 16-byte stores;
//   - k > 32: in a per-lane column of a [class][thread] shared-memory
//     histogram (row stride kT+1: conflict-free), in slices of at most
//     kSliceMax classes, summed over the group's columns.
// Skewed nets: a CSR net of more than kLong pins would stall its warp, so
// such nets are split: the warp's ns split nets are counted together
// straight from device memory, by groups of 32/ns lanes (here lane q
// takes pins q, q + L, ..., four loads in flight), and each group's
// partial counts meet in a fixed order (a `__shfl_xor_sync` butterfly, or
// a sum over the group's shared-memory columns).  The ELL entry splits no
// row while pmax <= kEllShort, and every row above it, where a row no
// longer fits one window.  A warp whose nets hold no pin (the padding nets
// past m) only writes zeros.
//
// Exactness.  No atomics: every result is the same on every run.  A net
// counted from a window adds each class's pins in order, as the plain
// versions do (their other terms are +0.0), so it equals them bit for bit
// even for float masks.  A split net adds in another order: integer (0/1)
// masks still give exact counts; float masks differ by rounding, within
// 1e-5 of the count (abs + relative; a split net may sum thousands of
// weights in float32).
//
// Bound: memory.  The CSR call must read the ids and masks of the real pins
// (eptr[e_pad] of them), the offsets ((e_pad+1)*4 bytes) and the labels,
// and write cnt (B*e_pad*k*4); its additions (B per live pin) are far
// fewer than the bytes.  At the kahypar main path's level-0 shape (B=1,
// e_pad=2^18, k=8, n_pad=2^17, 707,640 pins) that is 15,622,596 bytes,
// 0.0047 ms at 3.35 TB/s.  The ELL entry must read the whole mask (it marks
// the live slots), the ids of live slots, netw of nets with a live pin and
// the labels, and write both outputs: 87,765,216 bytes, 0.0262 ms, there.
// The design reads each needed byte about once: pins and masks with
// coalesced 16-byte loads, ids only of groups with a live slot, offsets
// once per lane; cnt leaves in 16-byte stores.  At that size one launch is
// dominated by its latency chain (offsets, pins, labels, store) and the
// launch itself, not by bandwidth (PERF.md has the times).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kWarps = 4;
constexpr int kT = kWarps * 32;    // threads per block: 128 nets
constexpr int kLong = 32;          // CSR nets above this are split
constexpr int kEllShort = 253;     // ELL rows up to this are not split
constexpr int kWindow = 256;       // pins staged per warp pass (> kLong + 3,
                                   // >= kEllShort + 3: a net fits one)
constexpr int kGroups = kWindow / 4 / 32;   // 16-byte groups per lane
constexpr int kSliceMax = 64;      // classes per shared-histogram slice
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const int* pins;       // pin ids, flat
  const float* mask;     // pin weights, flat
  const float* netw;     // (e_pad,), ELL entry only
  const int* labels;     // (batch, n_pad)
  float* cnt;            // (batch, e_pad, k)
  float* score;          // (batch, e_pad, k), ELL entry only
  int batch, e_pad, n_pad, k;
  int long_min;          // nets with more pins than this are split
  int ks;                // shared-histogram slice (k > 32), else 0
};

// Net e's pin range [x, y) in the flat pin arrays.  kSparse: most slots
// are padding, so an id group is read only after its masks show a live
// slot (a second round trip); else ids and masks load together.
struct Csr {
  static constexpr bool kSparse = false;
  const int* eptr;
  __device__ __forceinline__ int2 range(int e) const {
    return make_int2(eptr[e], eptr[e + 1]);
  }
};

struct Ell {
  static constexpr bool kSparse = true;
  int pmax;
  __device__ __forceinline__ int2 range(int e) const {
    return make_int2(e * pmax, e * pmax + pmax);
  }
};

// Stage pins [w, w + kWindow) of the warp's range [lo, hi) into sp / sm;
// slots outside the range read as padding (mask 0).  w is a multiple of 4
// and the arrays are 16-byte aligned, so whole 4-pin groups load as one
// int4/float4.  Every load of a lane is issued before any is used.
template <bool kSparse>
__device__ __forceinline__ void stage(const Args& a, int* sp, float* sm,
                                      int w, int lo, int hi, int lane) {
  float4 m[kGroups];
  int4 id[kGroups];
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const int j = w + 4 * (lane + 32 * g);
    m[g] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    id[g] = make_int4(0, 0, 0, 0);
    if (j >= lo && j + 3 < hi) {
      m[g] = __ldg(reinterpret_cast<const float4*>(a.mask + j));
      if (!kSparse) id[g] = __ldg(reinterpret_cast<const int4*>(a.pins + j));
    } else if (j + 3 >= lo && j < hi) {   // the range's ragged ends
      float mv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      int iv[4] = {0, 0, 0, 0};
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (j + u >= lo && j + u < hi) {
          mv[u] = __ldg(a.mask + j + u);
          iv[u] = __ldg(a.pins + j + u);
        }
      m[g] = make_float4(mv[0], mv[1], mv[2], mv[3]);
      id[g] = make_int4(iv[0], iv[1], iv[2], iv[3]);
    }
  }
  if (kSparse) {
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int j = w + 4 * (lane + 32 * g);
      if (j >= lo && j + 3 < hi &&
          (m[g].x != 0.0f || m[g].y != 0.0f || m[g].z != 0.0f ||
           m[g].w != 0.0f))
        id[g] = __ldg(reinterpret_cast<const int4*>(a.pins + j));
    }
  }
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    reinterpret_cast<float4*>(sm)[lane + 32 * g] = m[g];
    reinterpret_cast<int4*>(sp)[lane + 32 * g] = id[g];
  }
}

// The staged window's labels for one row: sl[j] = lrow[sp[j]] on a live
// slot, -1 on padding (its id is never read).
__device__ __forceinline__ void gather(const int* sp, const float* sm,
                                       int* sl, const int* __restrict__ lrow,
                                       int lane) {
#pragma unroll
  for (int j = lane; j < kWindow; j += 32)
    sl[j] = sm[j] != 0.0f ? __ldg(lrow + sp[j]) : -1;
}

// One lane's k counts (and their net-weighted scores) as a row of the
// outputs: 16-byte stores when k fills the register bucket.
template <bool kScore, int KR>
__device__ __forceinline__ void write_row(const Args& a, const float* acc,
                                          long long row, float w) {
  float* c_out = a.cnt + row * a.k;
  float* s_out = kScore ? a.score + row * a.k : nullptr;
  if (KR % 4 == 0 && a.k == KR) {
#pragma unroll
    for (int q = 0; q < KR / 4; ++q) {
      const float4 v = make_float4(acc[4 * q], acc[4 * q + 1],
                                   acc[4 * q + 2], acc[4 * q + 3]);
      reinterpret_cast<float4*>(c_out)[q] = v;
      if (kScore)
        reinterpret_cast<float4*>(s_out)[q] =
            make_float4(w * v.x, w * v.y, w * v.z, w * v.w);
    }
  } else {
#pragma unroll
    for (int c = 0; c < KR; ++c)
      if (c < a.k) {
        c_out[c] = acc[c];
        if (kScore) s_out[c] = w * acc[c];
      }
  }
}

// Lane q of a group of L lanes counts pins x + q, x + q + L, ... of [x, y)
// for row lrow, passing each live pin to add(label, mask); four pins per
// lane in flight.
template <class Add>
__device__ __forceinline__ void split_pins(const Args& a, const int* lrow,
                                           int x, int y, int q, int L,
                                           Add add) {
  for (int j0 = x + q; j0 < y; j0 += 4 * L) {
    float m[4];
    int lab[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + L * u;
      m[u] = j < y ? __ldg(a.mask + j) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      lab[u] = m[u] != 0.0f ? __ldg(a.pins + j0 + L * u) : -1;
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (lab[u] >= 0) lab[u] = __ldg(lrow + lab[u]);
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (m[u] != 0.0f) add(lab[u], m[u]);
  }
}

// Position of the k-th (from 0) set bit of mask; k < popc(mask).
__device__ __forceinline__ int nth_set(unsigned mask, int k) {
  int pos = 0;
  for (int width = 16; width; width >>= 1) {
    const int low = __popc(mask & ((1u << width) - 1));
    if (k >= low) {
      k -= low;
      mask >>= width;
      pos += width;
    }
  }
  return pos;
}

// The warp's lanes in groups of L = 1 << lg, the largest power of two with
// L * nf <= 32 for the nf set bits of a mask (nf >= 1): group g serves the
// net of lane n, the g-th set bit; lane q of the group takes every L-th pin.
struct Groups {
  int lg, g, q, n;
  bool active;
};

__device__ __forceinline__ Groups groups_of(unsigned mask, int lane) {
  Groups r;
  const int nf = __popc(mask);
  r.lg = 31 - __clz(32 / nf);
  r.g = lane >> r.lg;
  r.q = lane & ((1 << r.lg) - 1);
  r.active = r.g < nf;
  r.n = r.active ? nth_set(mask, r.g) : 0;
  return r;
}

template <class Addr, bool kScore, int KR>
__global__ void __launch_bounds__(kT)
pin_count_kernel(Addr addr, Args a) {
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int* sp = reinterpret_cast<int*>(smem4) + warp * 3 * kWindow;  // ids
  float* sm = reinterpret_cast<float*>(sp + kWindow);             // masks
  int* sl = sp + 2 * kWindow;                                      // labels
  float* hist = reinterpret_cast<float*>(smem4) + kWarps * 3 * kWindow;
  float* col = hist + tid;            // this lane's column, stride kT + 1

  const int e0 = (blockIdx.x * kWarps + warp) * 32;
  if (e0 >= a.e_pad) return;          // warp-uniform: no block barrier below
  const int e = e0 + lane;
  int2 r = addr.range(e < a.e_pad ? e : a.e_pad - 1);
  if (e >= a.e_pad) r.x = r.y;        // past the last net: empty
  const int s = r.x, t = r.y;
  const int lo = __shfl_sync(kFull, s, 0), hi = __shfl_sync(kFull, t, 31);
  const int slice = KR > 0 ? a.k : a.ks;
  float acc[KR > 0 ? KR : 1];

  if (lo == hi) {                     // no pins (padding nets): all zeros
    if (e < a.e_pad)
      for (int b = 0; b < a.batch; ++b) {
        const long long row = static_cast<long long>(b) * a.e_pad + e;
        if constexpr (KR > 0) {
#pragma unroll
          for (int c = 0; c < KR; ++c) acc[c] = 0.0f;
          write_row<kScore, KR>(a, acc, row, 0.0f);
        } else {
          for (int c = 0; c < a.k; ++c) {
            a.cnt[row * a.k + c] = 0.0f;
            if (kScore) a.score[row * a.k + c] = 0.0f;
          }
        }
      }
    return;
  }
  const bool split = e < a.e_pad && t - s > a.long_min;
  const unsigned splits = __ballot_sync(kFull, split);
  const float w = kScore && e < a.e_pad ? __ldg(a.netw + e) : 0.0f;

  // Count one live pin into this lane's partial counts of classes
  // [c0, c0 + kw); labels outside them (and -1, padding) hit nothing.
  auto count = [&](int lab, float m, int c0, int kw) {
    if constexpr (KR > 0) {
      if (static_cast<unsigned>(lab) >= static_cast<unsigned>(a.k)) return;
#pragma unroll
      for (int c = 0; c < KR; ++c)
        if (lab == c) acc[c] += m;
    } else {
      const int d = lab - c0;
      if (static_cast<unsigned>(d) < static_cast<unsigned>(kw))
        col[d * (kT + 1)] += m;
    }
  };
  auto zero = [&](int kw) {
    if constexpr (KR > 0) {
#pragma unroll
      for (int c = 0; c < KR; ++c) acc[c] = 0.0f;
    } else {
      for (int c = 0; c < kw; ++c) col[c * (kT + 1)] = 0.0f;
    }
  };
  // Sum each group's partial counts in a fixed order and write its net's
  // row: a shuffle butterfly and 16-byte stores by the group's first lane,
  // or, from shared memory, classes q, q + L, ... by lane q.
  auto finish = [&](const Groups& gr, long long row, float wn, int c0,
                    int kw) {
    if constexpr (KR > 0) {
      for (int off = 1 << gr.lg >> 1; off; off >>= 1)
#pragma unroll
        for (int c = 0; c < KR; ++c)
          acc[c] += __shfl_xor_sync(kFull, acc[c], off);
      if (gr.active && gr.q == 0) write_row<kScore, KR>(a, acc, row, wn);
    } else {
      __syncwarp();
      if (gr.active)
        for (int c = gr.q; c < kw; c += 1 << gr.lg) {
          const float* hrow = hist + c * (kT + 1) + warp * 32 +
                              (gr.g << gr.lg);
          float v = 0.0f;
          for (int l = 0; l < 1 << gr.lg; ++l) v += hrow[l];
          a.cnt[row * a.k + c0 + c] = v;
          if (kScore) a.score[row * a.k + c0 + c] = wn * v;
        }
      __syncwarp();
    }
  };

  // -- split nets: counted from device memory by groups of lanes ---------
  if (splits) {
    const Groups gr = groups_of(splits, lane);
    const int x = __shfl_sync(kFull, s, gr.n);
    const int tn = __shfl_sync(kFull, t, gr.n);
    const int y = gr.active ? tn : x;   // idle lanes count nothing
    const float wn = __shfl_sync(kFull, w, gr.n);
    for (int b = 0; b < a.batch; ++b) {
      const int* lrow = a.labels + static_cast<long long>(b) * a.n_pad;
      const long long row = static_cast<long long>(b) * a.e_pad + e0 + gr.n;
      for (int c0 = 0; c0 < a.k; c0 += slice) {
        const int kw = a.k - c0 < slice ? a.k - c0 : slice;
        zero(kw);
        split_pins(a, lrow, x, y, gr.q, 1 << gr.lg,
                   [&](int lab, float m) { count(lab, m, c0, kw); });
        finish(gr, row, wn, c0, kw);
      }
    }
  }

  // -- the other nets, one window at a time ---------------------------------
  // A window starts at the first net not yet counted and takes every net
  // that ends inside it; a net of at most long_min <= kWindow - 3 pins
  // always fits one, so no count is carried from window to window.  Its
  // nets are counted from shared memory by groups of lanes (one lane per
  // net when the window holds 32 nets, as it usually does on the CSR; 8
  // per net on a 64-slot ELL, whose rows are mostly padding), lane q of a
  // group taking the classes q mod L and all of the net's pins in order.
  bool done = split || e >= a.e_pad;
  for (;;) {
    const unsigned first =
        __reduce_min_sync(kFull, done ? UINT_MAX : static_cast<unsigned>(s));
    if (first == UINT_MAX) break;
    const int w0 = static_cast<int>(first) & ~3;
    const bool fits = !done && t <= w0 + kWindow;
    // >= 1 net fits: the one starting at `first`
    const Groups gr = groups_of(__ballot_sync(kFull, fits), lane);
    const int lmask = (1 << gr.lg) - 1;
    const int jx = __shfl_sync(kFull, s, gr.n) - w0;
    int jy = __shfl_sync(kFull, t, gr.n) - w0;
    const float wn = __shfl_sync(kFull, w, gr.n);
    __syncwarp();
    stage<Addr::kSparse>(a, sp, sm, w0, lo, hi, lane);
    if (Addr::kSparse) {                // stop at the row's last live slot
      __syncwarp();
      int last = jx - 1;
      if (gr.active)
        for (int j = jx + gr.q; j < jy; j += 1 << gr.lg)
          if (sm[j] != 0.0f) last = j;
      for (int off = 1 << gr.lg >> 1; off; off >>= 1)
        last = max(last, __shfl_xor_sync(kFull, last, off));
      jy = last + 1;
    }
    for (int b = 0; b < a.batch; ++b) {
      const int* lrow = a.labels + static_cast<long long>(b) * a.n_pad;
      const long long row = static_cast<long long>(b) * a.e_pad + e0 + gr.n;
      __syncwarp();
      gather(sp, sm, sl, lrow, lane);
      __syncwarp();
      for (int c0 = 0; c0 < a.k; c0 += slice) {
        const int kw = a.k - c0 < slice ? a.k - c0 : slice;
        zero(kw);
        if (gr.active)
          for (int j = jx; j < jy; ++j) {
            const int lab = sl[j];
            if (((lab - c0) & lmask) == gr.q) count(lab, sm[j], c0, kw);
          }
        finish(gr, row, wn, c0, kw);
      }
    }
    done = done || fits;
  }
}

// For k > 32: the shared-histogram slice.
void plan(Args& a, int kr) {
  a.ks = 0;
  if (!kr) {
    const int slices = (a.k + kSliceMax - 1) / kSliceMax;
    const int per = (a.k + slices - 1) / slices;
    a.ks = (per + 31) / 32 * 32;
  }
}

size_t smem_bytes(const Args& a) {
  return (static_cast<size_t>(kWarps) * 3 * kWindow +
          static_cast<size_t>(a.ks) * (kT + 1)) * 4;
}

template <class Addr, bool kScore, int KR>
cudaError_t launch_kr(const Addr& addr, const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(a);   // <= 45,312 B: no opt-in needed
  const unsigned blocks = static_cast<unsigned>((a.e_pad + kT - 1) / kT);
  pin_count_kernel<Addr, kScore, KR><<<blocks, kT, smem, stream>>>(addr, a);
  return cudaGetLastError();
}

template <class Addr, bool kScore>
cudaError_t launch(const Addr& addr, Args a, cudaStream_t stream) {
  const int kr = a.k <= 4 ? 4 : a.k <= 8 ? 8 : a.k <= 16 ? 16
                 : a.k <= 32 ? 32 : 0;
  plan(a, kr);
  switch (kr) {
    case 4: return launch_kr<Addr, kScore, 4>(addr, a, stream);
    case 8: return launch_kr<Addr, kScore, 8>(addr, a, stream);
    case 16: return launch_kr<Addr, kScore, 16>(addr, a, stream);
    case 32: return launch_kr<Addr, kScore, 32>(addr, a, stream);
    default: return launch_kr<Addr, kScore, 0>(addr, a, stream);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Both launchers run on `stream` of CUDA device `device` and return
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for inputs
// the kernel does not take.  Pointers are device pointers to contiguous
// arrays; pins and mask are 16-byte aligned.  The library links its own
// CUDA runtime, so it selects the device itself.
//
// ELL addressing: int32 pins (e_pad, pmax), float32 mask (e_pad, pmax),
// float32 netw (e_pad,), int32 labels (batch, n_pad) → float32 cnt and score
// (batch, e_pad, k).
extern "C" int pin_count_launch(const void* pins, const void* mask,
                                const void* netw, const void* labels,
                                void* cnt, void* score, long long batch,
                                long long e_pad, long long n_pad, int pmax,
                                int k, void* stream, int device) {
  if (k < 1 || pmax < 0 || batch < 0 || e_pad < 0 || n_pad < 0 ||
      e_pad * pmax >= INT_MAX || n_pad >= INT_MAX || batch >= INT_MAX ||
      !aligned16(pins) || !aligned16(mask))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch * e_pad == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  Args a{};
  a.pins = static_cast<const int*>(pins);
  a.mask = static_cast<const float*>(mask);
  a.netw = static_cast<const float*>(netw);
  a.labels = static_cast<const int*>(labels);
  a.cnt = static_cast<float*>(cnt);
  a.score = static_cast<float*>(score);
  a.batch = static_cast<int>(batch);
  a.e_pad = static_cast<int>(e_pad);
  a.n_pad = static_cast<int>(n_pad);
  a.k = k;
  a.long_min = pmax <= kEllShort ? INT_MAX : -1;
  return static_cast<int>(launch<Ell, true>(Ell{pmax}, a,
                                            static_cast<cudaStream_t>(stream)));
}

// CSR addressing: int32 eptr (e_pad + 1,), int32 pins and float32 mask
// (npins,) with eptr[e_pad] <= npins, int32 labels (batch, n_pad) → float32
// cnt (batch, e_pad, k).  Pins past eptr[e_pad] lie in no net and are never
// read.
extern "C" int pin_count_csr_launch(const void* eptr, const void* pins,
                                    const void* mask, const void* labels,
                                    void* cnt, long long batch,
                                    long long e_pad, long long n_pad,
                                    long long npins, int k, void* stream,
                                    int device) {
  if (k < 1 || batch < 0 || e_pad < 0 || n_pad < 0 || npins < 0 ||
      e_pad >= INT_MAX || npins >= INT_MAX || n_pad >= INT_MAX ||
      batch >= INT_MAX || !aligned16(pins) || !aligned16(mask))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch * e_pad == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  Args a{};
  a.pins = static_cast<const int*>(pins);
  a.mask = static_cast<const float*>(mask);
  a.netw = nullptr;
  a.labels = static_cast<const int*>(labels);
  a.cnt = static_cast<float*>(cnt);
  a.score = nullptr;
  a.batch = static_cast<int>(batch);
  a.e_pad = static_cast<int>(e_pad);
  a.n_pad = static_cast<int>(n_pad);
  a.k = k;
  a.long_min = kLong;
  return static_cast<int>(launch<Csr, false>(
      Csr{static_cast<const int*>(eptr)}, a,
      static_cast<cudaStream_t>(stream)));
}
