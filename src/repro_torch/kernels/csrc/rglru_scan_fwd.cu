// RG-LRU linear recurrence for Hopper (sm_90a), behind a plain C interface
// that repro_torch/kernels/rglru_scan.py loads with ctypes.
//
// Replaces the TPU kernel src/repro/kernels/rglru_scan.py::_rglru_kernel
// (launched by rglru_scan_fwd, pallas_call at :65). It computes the same
// function,
//
//     h_t = exp(log_a_t) * h_{t-1} + x_t,   h_{-1} = 0,
//
// over (B, S, W) f32 inputs, sequentially in time and in linear space with
// h carried in f32, as the TPU kernel does: a log-space prefix scan would
// lose precision where log_a is near -20. With `reverse` set it runs the
// time-reversed, shifted recurrence of the backward pass,
//
//     h_t = exp(log_a_{t+1}) * h_{t+1} + x_t,   from t = S-1 down to 0,
//
// which, fed the output gradient as x, is the gradient of x (and, times
// exp(log_a_t) h_{t-1}, of log_a).
//
// What bounds it: the card must read log_a and x once and write h once,
// 12 bytes per element (at the recurrentgemma-9b shape B=1, S=2048,
// W=4096: 100.7 MB, 30 us at 3.35 TB/s); the arithmetic (one exp and one
// FMA per element) is negligible. This first kernel is far from that
// bound: the time loop is serial, so at B=1, W=4096 only 4096 threads
// (64 blocks of 64) have work, on 64 of the 132 SMs, and each waits on
// device-memory latency once per group of steps.
//
// Design (simple and right first; a chunked two-pass scan that fills the
// card is later work):
//   * one thread owns one (b, w) column and keeps h in a register while it
//     walks the S steps; neighbouring threads take neighbouring w, so each
//     step's loads and stores are coalesced;
//   * the TPU kernel's sequential chunk axis becomes groups of U steps:
//     the next group's log_a and x are loaded into registers while the
//     current group's dependent FMA chain runs, so U loads per input are
//     in flight at once (they do not depend on h);
//   * inputs are read through their batch and time strides (the last
//     dimension must be contiguous); the output is contiguous (B, S, W).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 64;  // columns per block
constexpr int U = 32;        // steps per group loaded ahead

struct Args {
  const float* la;
  const float* x;
  float* h;
  int S, W;
  long long la_sb, la_ss, x_sb, x_ss;
};

// Loads group g (steps t = first + dir*u, u < U) of the column into
// a / v. In reverse the decay of step t is log_a_{t+1} (0 at t = S-1,
// where the carried h is still 0).
template <bool REV>
__device__ __forceinline__ void load_group(const Args& p, const float* lab,
                                           const float* xb, int first,
                                           float (&a)[U], float (&v)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int t = REV ? first - u : first + u;
    const bool in = REV ? t >= 0 : t < p.S;
    const int ta = REV ? t + 1 : t;
    a[u] = (in && ta < p.S) ? lab[(long long)ta * p.la_ss] : 0.f;
    v[u] = in ? xb[(long long)t * p.x_ss] : 0.f;
  }
}

template <bool REV>
__global__ void __launch_bounds__(THREADS) rglru_scan_kernel(Args p) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (w >= p.W) return;
  const float* lab = p.la + b * p.la_sb + w;
  const float* xb = p.x + b * p.x_sb + w;
  float* hb = p.h + (long long)b * p.S * p.W + w;

  float a[U], v[U], na[U], nv[U];
  const int n_groups = (p.S + U - 1) / U;
  int first = REV ? p.S - 1 : 0;
  load_group<REV>(p, lab, xb, first, a, v);
  float acc = 0.f;
  for (int g = 0; g < n_groups; ++g) {
    const int next = REV ? first - U : first + U;
    if (g + 1 < n_groups) load_group<REV>(p, lab, xb, next, na, nv);
#pragma unroll
    for (int u = 0; u < U; ++u) a[u] = expf(a[u]);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = REV ? first - u : first + u;
      if (REV ? t >= 0 : t < p.S) {
        acc = a[u] * acc + v[u];
        hb[(long long)t * p.W] = acc;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      a[u] = na[u];
      v[u] = nv[u];
    }
    first = next;
  }
}

}  // namespace

// log_a, x: (B, S, W) float32 with a contiguous last dimension, read
// through the given batch and time strides (in elements); h: a contiguous
// (B, S, W) float32 buffer. reverse: 0 = forward recurrence, 1 = the
// backward's reversed, shifted one. Returns the cudaError_t of the launch
// (0 = ok).
extern "C" int repro_rglru_scan_fwd(const void* log_a, const void* x,
                                    void* h, int B, int S, int W,
                                    long long la_sb, long long la_ss,
                                    long long x_sb, long long x_ss,
                                    int reverse, void* stream) {
  if (B < 1 || S < 1 || W < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  const Args p{static_cast<const float*>(log_a), static_cast<const float*>(x),
               static_cast<float*>(h), S, W, la_sb, la_ss, x_sb, x_ss};
  const dim3 grid((W + THREADS - 1) / THREADS, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (reverse)
    rglru_scan_kernel<true><<<grid, THREADS, 0, st>>>(p);
  else
    rglru_scan_kernel<false><<<grid, THREADS, 0, st>>>(p);
  return (int)cudaGetLastError();
}
