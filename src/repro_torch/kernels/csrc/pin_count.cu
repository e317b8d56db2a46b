// Per-net pin-count histogram for Hopper (sm_90a): the hot loop of
// hypergraph LP refinement.
//
//   cnt[b, e, c]   = sum_j mask[e, j] * [labels[b, pins[e, j]] == c]
//   score[b, e, c] = netw[e] * cnt[b, e, c]
//
// Replaces the TPU kernel `_pin_affinity_kernel` / `pin_affinity_pallas`
// in src/repro/kernels/pin_affinity.py (body :33, pl.pallas_call :71).  On
// the TPU, XLA gathered labels[pins] before the kernel, k was padded to 128
// and the batch came from vmap; here the gather is fused, k is the scan's
// block bucket (not padded to 128), and one launch covers all B candidate
// rows.  Both outputs are written, as on the TPU.
//
// Design: one thread per (row b, net e).  The thread owns its 2k outputs,
// zeroes its counts and walks its pmax pin slots in order, skipping padding
// (mask == 0 is the only padding mark: a padding slot's pin id n_pad-1 may
// be a real vertex when n == n_pad, so it is never read), and adds mask[e,j]
// (not 1) to block labels[b, pins[e, j]] when that label is in [0, k).  No
// atomics, and every count is summed in slot order, so the result is the
// same on every run and equals the plain PyTorch version, which adds the
// slots in the same order, bit for bit even for float masks.
//
// Bound: memory.  One call must read the whole mask (e_pad*pmax*4 bytes:
// it marks the live slots), the pin ids of live slots only (4 bytes each),
// netw of the nets with a live pin, and the labels (B*n_pad*4), and write
// cnt and score (2*B*e_pad*k*4).  At the kahypar main path's level-0 shape
// (B=1, e_pad=2^18, pmax=64, k=8, n_pad=2^17, 707,640 live pins in 131,072
// nets) that is 87,765,216 bytes, 0.0262 ms at 3.35 TB/s; the additions
// are far fewer than the bytes.  This first
// version reads each pin row once per batch row, with a stride of pmax
// ints between neighbouring threads, and updates its counts in device
// memory; coalesced loads and register histograms are later work.

#include <cuda_runtime.h>

namespace {

__global__ void pin_count_kernel(const int* __restrict__ pins,
                                 const float* __restrict__ mask,
                                 const float* __restrict__ netw,
                                 const int* __restrict__ labels,
                                 float* __restrict__ cnt,
                                 float* __restrict__ score, long long batch,
                                 long long e_pad, long long n_pad, int pmax,
                                 int k) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= batch * e_pad) return;
  const long long b = t / e_pad;
  const long long e = t - b * e_pad;
  float* c_out = cnt + t * k;
  float* s_out = score + t * k;
  for (int c = 0; c < k; ++c) c_out[c] = 0.0f;
  const int* prow = pins + e * pmax;
  const float* mrow = mask + e * pmax;
  const int* lrow = labels + b * n_pad;
  for (int j = 0; j < pmax; ++j) {
    const float m = mrow[j];
    if (m == 0.0f) continue;
    const int lab = lrow[prow[j]];
    if (lab < 0 || lab >= k) continue;
    c_out[lab] += m;
  }
  const float w = netw[e];
  for (int c = 0; c < k; ++c) s_out[c] = w * c_out[c];
}

}  // namespace

// Launches on `stream` of CUDA device `device` and returns
// cudaGetLastError() (0 on success).  Pointers are device pointers to
// contiguous int32 pins (e_pad, pmax), float32 mask (e_pad, pmax), float32
// netw (e_pad,), int32 labels (batch, n_pad) and float32 cnt and score
// (batch, e_pad, k).  The library links its own CUDA runtime, so it selects
// the device itself.
extern "C" int pin_count_launch(const void* pins, const void* mask,
                                const void* netw, const void* labels,
                                void* cnt, void* score, long long batch,
                                long long e_pad, long long n_pad, int pmax,
                                int k, void* stream, int device) {
  const long long total = batch * e_pad;
  if (total == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  pin_count_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(pins), static_cast<const float*>(mask),
      static_cast<const float*>(netw), static_cast<const int*>(labels),
      static_cast<float*>(cnt), static_cast<float*>(score), batch, e_pad,
      n_pad, pmax, k);
  return static_cast<int>(cudaGetLastError());
}
