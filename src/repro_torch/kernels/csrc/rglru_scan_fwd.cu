// RG-LRU linear recurrence for Hopper (sm_90a), behind a plain C interface
// that repro_torch/kernels/rglru_scan.py loads with ctypes.
//
// Replaces the TPU kernel src/repro/kernels/rglru_scan.py::_rglru_kernel
// (launched by rglru_scan_fwd, pallas_call at :65). It computes the same
// function,
//
//     h_t = exp(log_a_t) * h_{t-1} + x_t,   h_{-1} = 0,
//
// over (B, S, W) f32 inputs with h in f32. With `reverse` set it runs the
// time-reversed, shifted recurrence of the backward pass,
//
//     h_t = exp(log_a_{t+1}) * h_{t+1} + x_t,   from t = S-1 down to 0,
//
// which, fed the output gradient as x, is the gradient of x. The fused
// backward entry also takes the forward's output h and writes the
// gradient of log_a beside it, dlog_a_t = (gx_t * exp(log_a_t)) * h_{t-1}
// (h_{-1} = 0), in the same pass.
//
// What bounds it: bytes. The least the card must move is each input read
// once and each output written once: 12 bytes an element forward (log_a,
// x, h), 20 in the fused backward (log_a, g, h; gx, dlog_a). At the
// recurrentgemma-9b shape B=1, S=2048, W=4096 that is 100.7 MB, 30 us at
// 3.35 TB/s, forward; the arithmetic (one exp and one FMA an element) is
// negligible. The three passes below move about 20 bytes an element
// forward (log_a and x read twice, h written once) and 28 in the fused
// backward, so they can come within 1.7x and 1.4x of those bounds.
//
// Design. One thread per (b, w) column walking all S steps fills 4096
// threads at that shape, 64 of the 132 SMs, each a serial chain of 2048
// dependent FMAs. Here time is cut into chunks of L steps and the walk
// runs in three kernels on the caller's stream, over f32 scratch (B, nc,
// W) the wrapper allocates (nc = ceil(S / L)):
//   1. rglru_summary_kernel, grid (W/128, nc, B): one thread per (b,
//      chunk, w) runs the chunk from h = 0 to its end value e_k, and sums
//      the chunk's log decays in f32 into A_k = exp(sum), exponentiated
//      once;
//   2. rglru_carry_kernel, grid (W/128, B): one thread per (b, w) walks
//      the nc chunks in order, c_0 = 0, c_{k+1} = A_k c_k + e_k (32 steps
//      at S = 2048), loading A and e U chunks at a time;
//   3. rglru_rescan_kernel, grid (W/128, nc, B): one thread per (b, chunk,
//      w) runs the chunk again from c_k with the TPU kernel's own step
//      exp(log_a) h + x and writes h (and, fused, dlog_a).
// That is B W nc threads, 131072 at the path shape with L = 64; the
// neighbouring threads of a warp take neighbouring w, so every load and
// store is coalesced. Inside a chunk, the next U steps of log_a and x are
// loaded into registers while the current group's dependent FMA chain
// runs. Reverse mode walks each chunk and the chunks from the end, and
// its decay is the next step's: a chunk's first step (t = hi - 1) takes
// log_a_hi from the following chunk (none at t = S - 1, where the carry
// is 0), and each later step the exp of the log_a its predecessor
// loaded, so each element's exp is taken once and is also the exp(log_a_t)
// of the fused dlog_a. Inputs are read through their batch and time
// strides (the last dimension contiguous); the outputs are contiguous
// (B, S, W). There are no atomics and the order of every sum is fixed,
// so two calls give the same bits.
//
// Departure from the TPU kernel: the TPU kernel carries h through every
// step; here the carry crosses a chunk boundary through the chunk's
// summary, the combine of the JAX package's production scan
// (src/repro/models/rglru.py::rglru_scan_xla: (la1 + la2, exp(la2) b1 +
// b2)). The decay is summed in log space only within a chunk and
// exponentiated once, never as exp(-cumsum) (the precision trap the
// Pallas docstring names for log_a near -20) and never as a product of
// per-step exps.
//
// repro_rglru_scan_plan exports L, each pass's grid and threads and the
// scratch bytes; rglru_scan.py::rglru_plan, the Python mirror the CPU
// tests check, is held against it on the card.

#include <cuda_runtime.h>

namespace {

constexpr int L = 64;         // steps per chunk
constexpr int U = 8;          // steps (chunks in the carry pass) loaded ahead
constexpr int THREADS = 128;  // columns per block
constexpr int N_PASSES = 3;   // summary, carry, rescan

struct Args {
  const float* la;   // log_a (B, S, W), strides la_sb, la_ss
  const float* x;    // x, or the output gradient in reverse
  const float* hf;   // fused backward: the forward's output h
  float* h;          // output (B, S, W), contiguous
  float* dla;        // fused backward: dlog_a (B, S, W), contiguous
  float* e;          // scratch (B, nc, W): chunk end value from h = 0
  float* A;          // scratch (B, nc, W): chunk decay exp(sum log_a)
  float* c;          // scratch (B, nc, W): carry into the chunk
  int S, W, nc;
  long long la_sb, la_ss, x_sb, x_ss, hf_sb, hf_ss;
};

struct Plan {
  int nc;
  dim3 grid[N_PASSES];
  long long scratch_bytes;
};

int make_plan(int B, int S, int W, Plan& pl) {
  if (B < 1 || S < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const long long nc = ((long long)S + L - 1) / L;
  if (B > 65535 || nc > 65535) return (int)cudaErrorInvalidValue;
  const unsigned gx = (unsigned)((W + THREADS - 1) / THREADS);
  pl.nc = (int)nc;
  pl.grid[0] = dim3(gx, (unsigned)nc, (unsigned)B);
  pl.grid[1] = dim3(gx, (unsigned)B, 1);
  pl.grid[2] = dim3(gx, (unsigned)nc, (unsigned)B);
  pl.scratch_bytes = 3LL * 4 * B * nc * W;
  return 0;
}

// Step i of a chunk [lo, lo + n) is t = lo + i, or lo + n - 1 - i in
// reverse. Loads steps i0 .. i0 + U - 1 of the column: log_a_t, x_t and,
// fused, h_{t-1}.
template <bool REV, bool FUSED>
__device__ __forceinline__ void load_group(const Args& p, const float* lab,
                                           const float* xb, const float* hb,
                                           int lo, int n, int i0,
                                           float (&a)[U], float (&v)[U],
                                           float (&hp)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int i = i0 + u;
    const int t = REV ? lo + n - 1 - i : lo + i;
    const bool in = i < n;
    a[u] = in ? lab[(long long)t * p.la_ss] : 0.f;
    v[u] = in ? xb[(long long)t * p.x_ss] : 0.f;
    hp[u] = (FUSED && in && t > 0) ? hb[(long long)(t - 1) * p.hf_ss]
                                   : 0.f;
  }
}

// Runs the recurrence over chunk k of column (b, w) from `acc`; adds the
// chunk's log decays, in step order, to `logsum`; calls
// visit(t, h_t, exp(log_a_t), h_{t-1} of the forward) after each step.
// Returns the value after the chunk's last step.
template <bool REV, bool FUSED, class Visit>
__device__ __forceinline__ float walk_chunk(const Args& p, int b, int k,
                                            int w, float acc, float& logsum,
                                            Visit visit) {
  const int lo = k * L;
  const int n = min(L, p.S - lo);
  const float* lab = p.la + b * p.la_sb + w;
  const float* xb = p.x + b * p.x_sb + w;
  const float* hb = FUSED ? p.hf + b * p.hf_sb + w : nullptr;
  // reverse: the decay of step t is log_a_{t+1}; the chunk's first step
  // takes log_a_hi from the next chunk (none at the end, carry 0 there)
  float lprev = 0.f, eprev = 0.f;
  if (REV && lo + n < p.S) {
    lprev = lab[(long long)(lo + n) * p.la_ss];
    eprev = expf(lprev);
  }
  float a[U], v[U], hp[U], na[U], nv[U], nhp[U];
  load_group<REV, FUSED>(p, lab, xb, hb, lo, n, 0, a, v, hp);
  for (int i0 = 0; i0 < n; i0 += U) {
    if (i0 + U < n)
      load_group<REV, FUSED>(p, lab, xb, hb, lo, n, i0 + U, na, nv, nhp);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (i0 + u < n) {
        float lg, dec;
        if (REV) {
          lg = lprev;
          dec = eprev;
          lprev = a[u];
          eprev = expf(a[u]);
        } else {
          lg = a[u];
          dec = eprev = expf(a[u]);
        }
        logsum += lg;
        acc = dec * acc + v[u];
        visit(REV ? lo + n - 1 - (i0 + u) : lo + i0 + u, acc, eprev, hp[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      a[u] = na[u];
      v[u] = nv[u];
      hp[u] = nhp[u];
    }
  }
  return acc;
}

template <bool REV>
__global__ void __launch_bounds__(THREADS) rglru_summary_kernel(Args p) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  const int k = blockIdx.y, b = blockIdx.z;
  if (w >= p.W) return;
  float logsum = 0.f;
  const float e = walk_chunk<REV, false>(p, b, k, w, 0.f, logsum,
                                         [](int, float, float, float) {});
  const long long ci = ((long long)b * p.nc + k) * p.W + w;
  p.e[ci] = e;
  p.A[ci] = expf(logsum);
}

template <bool REV>
__global__ void __launch_bounds__(THREADS) rglru_carry_kernel(Args p) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (w >= p.W) return;
  const long long base = (long long)b * p.nc * p.W + w;
  float c = 0.f;
  for (int j0 = 0; j0 < p.nc; j0 += U) {
    float A[U], E[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u;
      const long long o = base + (long long)(REV ? p.nc - 1 - j : j) * p.W;
      A[u] = j < p.nc ? p.A[o] : 0.f;
      E[u] = j < p.nc ? p.e[o] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u;
      if (j < p.nc) {
        p.c[base + (long long)(REV ? p.nc - 1 - j : j) * p.W] = c;
        c = A[u] * c + E[u];
      }
    }
  }
}

template <bool REV, bool FUSED>
__global__ void __launch_bounds__(THREADS) rglru_rescan_kernel(Args p) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  const int k = blockIdx.y, b = blockIdx.z;
  if (w >= p.W) return;
  float* hb = p.h + (long long)b * p.S * p.W + w;
  float* db = FUSED ? p.dla + (long long)b * p.S * p.W + w : nullptr;
  const long long ci = ((long long)b * p.nc + k) * p.W + w;
  float logsum = 0.f;
  walk_chunk<REV, FUSED>(
      p, b, k, w, p.c[ci], logsum,
      [&](int t, float acc, float ea, float hprev) {
        hb[(long long)t * p.W] = acc;
        if constexpr (FUSED) db[(long long)t * p.W] = (acc * ea) * hprev;
      });
}

template <bool REV, bool FUSED>
int launch(Args p, int B, cudaStream_t st) {
  Plan pl;
  if (int err = make_plan(B, p.S, p.W, pl)) return err;
  p.nc = pl.nc;
  rglru_summary_kernel<REV><<<pl.grid[0], THREADS, 0, st>>>(p);
  if (cudaError_t err = cudaGetLastError()) return (int)err;
  rglru_carry_kernel<REV><<<pl.grid[1], THREADS, 0, st>>>(p);
  if (cudaError_t err = cudaGetLastError()) return (int)err;
  rglru_rescan_kernel<REV, FUSED><<<pl.grid[2], THREADS, 0, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// out: the chunk length L, the chunk count, the scratch bytes, then for
// each pass (summary, carry, rescan) its grid x, y, z and threads: 15
// numbers. Returns 0, or cudaErrorInvalidValue for a shape the kernels do
// not take (B or the chunk count above 65535).
extern "C" int repro_rglru_scan_plan(int B, int S, int W, long long* out) {
  Plan pl;
  if (int err = make_plan(B, S, W, pl)) return err;
  out[0] = L;
  out[1] = pl.nc;
  out[2] = pl.scratch_bytes;
  for (int i = 0; i < N_PASSES; ++i) {
    out[3 + 4 * i] = pl.grid[i].x;
    out[4 + 4 * i] = pl.grid[i].y;
    out[5 + 4 * i] = pl.grid[i].z;
    out[6 + 4 * i] = THREADS;
  }
  return 0;
}

// log_a, x: (B, S, W) float32 with a contiguous last dimension, read
// through the given batch and time strides (in elements); h: a contiguous
// (B, S, W) float32 output; e, A, c: float32 scratch of B * nc * W each.
// reverse: 0 = forward recurrence, 1 = the backward's reversed, shifted
// one. Returns the cudaError_t of the first launch that failed (0 = ok).
extern "C" int repro_rglru_scan_fwd(const void* log_a, const void* x,
                                    void* h, void* e, void* A, void* c,
                                    int B, int S, int W, long long la_sb,
                                    long long la_ss, long long x_sb,
                                    long long x_ss, int reverse,
                                    void* stream) {
  Args p{static_cast<const float*>(log_a), static_cast<const float*>(x),
         nullptr, static_cast<float*>(h), nullptr, static_cast<float*>(e),
         static_cast<float*>(A), static_cast<float*>(c), S, W, 0, la_sb,
         la_ss, x_sb, x_ss, 0, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return reverse ? launch<true, false>(p, B, st)
                 : launch<false, false>(p, B, st);
}

// The fused backward: g (the gradient of h) and hf (the forward's output)
// as log_a above, each through its own batch and time strides; writes
// dx (the reverse recurrence over g) and dlog_a, both contiguous (B, S, W)
// float32. Scratch and return value as above.
extern "C" int repro_rglru_scan_bwd(const void* log_a, const void* g,
                                    const void* hf, void* dx, void* dlog_a,
                                    void* e, void* A, void* c, int B, int S,
                                    int W, long long la_sb, long long la_ss,
                                    long long g_sb, long long g_ss,
                                    long long hf_sb, long long hf_ss,
                                    void* stream) {
  Args p{static_cast<const float*>(log_a), static_cast<const float*>(g),
         static_cast<const float*>(hf), static_cast<float*>(dx),
         static_cast<float*>(dlog_a), static_cast<float*>(e),
         static_cast<float*>(A), static_cast<float*>(c), S, W, 0, la_sb,
         la_ss, g_sb, g_ss, hf_sb, hf_ss};
  return launch<true, true>(p, B, static_cast<cudaStream_t>(stream));
}
