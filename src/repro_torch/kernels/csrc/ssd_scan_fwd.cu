// Mamba-2 SSD chunked scan forward for Hopper (sm_90a), behind a plain C
// interface that repro_torch/kernels/ssd_scan.py loads with ctypes.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::_ssd_kernel
// (launched by ssd_scan_fwd, pallas_call at :90). It computes the same
// function: for each chunk of Q steps, with la = cumsum(dA_log) inside the
// chunk,
//   y     = (C B^T o exp(la_i - la_j) [i >= j]) x + exp(la_i) (C state^T)
//   state = exp(la_last) state + (exp(la_last - la) x)^T B
// with the (P, N) state carried in f32 from chunk to chunk; y and the final
// state are f32. B and C (B, S, N) are shared by all heads.
//
// What bounds it: at the mamba2-2.7b training shape (B=1, S=1024, H=80,
// P=64, N=128, Q=128) the card must move about 45 MB (xh and y in f32,
// 21 MB each, the final state 2.6 MB), 13.5 us at 3.35 TB/s, and do
// 3.4 GFLOP (C B^T's lower triangle once per chunk, then per head and
// chunk the causal Q x Q x P product, C state^T and the state update, each
// Q x P x N), 50.4 us in f32 on the CUDA cores (67 TFLOP/s). So operations
// bound it, as long as it computes in f32 as the TPU kernel does.
//
// Design: the TPU grid walks the chunks of one (batch, head) in order and
// carries the state in VMEM. Here that walk is the only sequential part,
// and it is cut down to a pass over (P, N) states; everything else is
// parallel over chunks and heads. Four kernels on the caller's stream,
// with f32 scratch the wrapper allocates (repro_ssd_scan_plan exports the
// grids and the shared memory; the card checks hold ssd_scan.py::ssd_plan,
// the Python mirror the CPU tests use, against it):
//   1. ssd_gram_kernel, grid (B*nc, Q/32 + H/8): G = C B^T of a chunk,
//      lower triangle, once per chunk for all heads (32-row strips, 4 x 4
//      register tiles), and in the other blocks La = cumsum(dA_log) per
//      (chunk, head), one warp scan per head (summed in f64, rounded once).
//      Scratch G (B, nc, Q, Q), La (B, nc, H, Q).
//   2. ssd_states_kernel, grid (B*nc*H, P/64, N/128): the chunk's own state
//      s_c = (exp(La_Q - La) x)^T B, 4 x 8 register tiles. Scratch
//      (B, nc, H, P, N).
//   3. ssd_state_pass_kernel, grid (P*N/256, B*H): one thread per state
//      element walks the nc chunks, states_in[c] = s (written in place over
//      s_c[c]), s = exp(La_Q[c]) s + s_c[c]; the last s is the final state.
//      It loads 8 chunks ahead of its stores, so it is bound by bytes
//      (about 45 MB through L2 at this shape), not by one load's latency.
//   4. ssd_chunk_scan_kernel, grid (B*nc*H, P/64): y = exp(La_i) (C_i
//      states_in^T) + (G o exp(La_i - La_j) [i >= j]) x, 8 x 4 register
//      tiles, each row reducing over j <= i only; y is written once.
// Every product is an f32 FMA from shared memory, register-tiled, so the
// numerics are those of the single-kernel version and of the TPU kernel,
// and the f32 rate is the yardstick. Tiles are filled with four
// independent loads a thread, neighbouring threads on neighbouring
// addresses; a tile stored transposed (for float4 reads of its columns)
// takes four rows a thread and writes them as one float4, which keeps the
// stores free of bank conflicts. Each block has 256 threads, at most
// 128 registers a thread and at most 103 KB of shared memory, so two fit
// on an SM. No atomics: the result is deterministic.
// The decay is masked in the exponent: exp(La_i - La_j) is taken only for
// j <= i (above the diagonal the difference is >= 0 and overflows to inf
// at full-width decays, and inf * 0 would be NaN).
// Templated on the type of B and C (f32 or bf16); xh and dA_log are f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int QMAX = 128;      // chunk rows a tile holds (Q <= 128)
constexpr int PT = 64;         // head-dim columns per block, passes 2 and 4
constexpr int NT = 128;        // state columns per tile
constexpr int GS = 32;         // G rows per pass-1 block
constexpr int QLD = QMAX + 4;  // row of a tile stored transposed (floats)
constexpr int SLD = PT + 4;    // row of the transposed state tile
constexpr float NEG_INF = -1.0e30f;  // exp(NEG_INF) = 0

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void fma4(float (&acc)[4], float a, float4 b) {
  acc[0] = fmaf(a, b.x, acc[0]);
  acc[1] = fmaf(a, b.y, acc[1]);
  acc[2] = fmaf(a, b.z, acc[2]);
  acc[3] = fmaf(a, b.w, acc[3]);
}

// Transposed tiles are filled four rows at a time: a thread reads
// v[k] = p[k * stride] for k < rows (0 past them, nothing unless `in`),
// neighbouring threads reading neighbouring columns (coalesced), and
// stores the four as one float4 of the transposed row (with rows of
// QLD or SLD floats, 8 neighbouring threads' float4s cover all 32 banks)
template <typename T>
__device__ __forceinline__ void load_col4(float (&v)[4], const T* p,
                                          long long stride, int rows,
                                          bool in) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
    v[k] = in && k < rows ? to_f32(p[k * stride]) : 0.f;
}

// Row tiles: a thread reads four neighbouring elements v[k] = p[k] for
// k < n (0 past them, nothing unless `in`), four loads in flight at once
template <typename T>
__device__ __forceinline__ void load_row4(float (&v)[4], const T* p, int n,
                                          bool in) {
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = in && k < n ? to_f32(p[k]) : 0.f;
}

__device__ __forceinline__ void st4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// ---- pass 1: G = C B^T (lower triangle) and La = cumsum(dA_log)

// La of one (batch, chunk, head) by one warp: each lane sums E <= 4
// consecutive steps, then a shuffle scan over the lanes. The sums are f64
// and La is rounded to f32 once: an f32 scan in this order would round
// differently from a sequential f32 sum (the plain version's), by about
// 1e-5 of y's scale at full-width decays; the rounded f64 sum is as close
// to the exact one as f32 allows
__device__ void chunk_cumsum(const float* __restrict__ a,
                             float* __restrict__ out, long long step0, int H,
                             int Q, int lane) {
  const int E = (Q + 31) / 32;
  double v[4];
  double run = 0.0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int t = lane * E + e;
    run += e < E && t < Q ? a[(step0 + t) * H] : 0.f;
    v[e] = run;
  }
  double x = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  double before = __shfl_up_sync(0xffffffffu, x, 1);  // the lanes below
  if (lane == 0) before = 0.0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int t = lane * E + e;
    if (e < E && t < Q) out[t] = (float)(before + v[e]);
  }
}

// blockIdx.y < Q/GS: a strip of G; past them: La for 8 heads, a warp each
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
ssd_gram_kernel(const float* __restrict__ a, const T* __restrict__ Bm,
                const T* __restrict__ Cm, float* __restrict__ G,
                float* __restrict__ La, int S, int H, int N, int Q, int nc,
                long long b_sb, long long b_ss, long long c_sb,
                long long c_ss) {
  extern __shared__ float4 smem4[];
  float* Cs = reinterpret_cast<float*>(smem4);  // GS x NT, the strip's C
  float* Bt = Cs + GS * NT;                     // NT x QLD, B transposed

  const int bc = blockIdx.x, strip = blockIdx.y;
  const int b = bc / nc, c = bc % nc;
  const long long t0 = (long long)c * Q;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nstrip = (Q + GS - 1) / GS;
  if (strip >= nstrip) {
    const int h = (strip - nstrip) * (THREADS / 32) + warp;
    if (h < H)
      chunk_cumsum(a + h, La + ((long long)bc * H + h) * Q,
                   (long long)b * S + t0, H, Q, lane);
    return;
  }

  const int i0 = strip * GS;
  const int jpad = i0 + GS;  // columns j < jpad (j <= i for the strip)
  const T* Cb = Cm + b * c_sb;
  const T* Bb = Bm + b * b_sb;
  // rows i0 + 4 warp + r, columns 4 lane + cc
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) acc[r][cc] = 0.f;
  for (int n0 = 0; n0 < N; n0 += NT) {
    const int nn = min(NT, N - n0);
    __syncthreads();
#pragma unroll 4
    for (int g = tid; g < GS * NT / 4; g += THREADS) {
      const int r = g / (NT / 4), n = 4 * (g % (NT / 4));
      float v[4];
      load_row4(v, Cb + (t0 + i0 + r) * c_ss + n0 + n, nn - n, i0 + r < Q);
      st4(Cs + r * NT + n, v);
    }
#pragma unroll 4
    for (int g = tid; g < NT * jpad / 4; g += THREADS) {
      const int n = g % NT, j = 4 * (g / NT);
      float v[4];
      load_col4(v, Bb + (t0 + j) * b_ss + n0 + n, b_ss, Q - j, n < nn);
      st4(Bt + n * QLD + j, v);
    }
    __syncthreads();
    if (4 * lane < jpad) {
      for (int n = 0; n < nn; ++n) {
        const float4 bv = ld4(Bt + n * QLD + 4 * lane);
#pragma unroll
        for (int r = 0; r < 4; ++r)
          fma4(acc[r], Cs[(4 * warp + r) * NT + n], bv);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + 4 * warp + r;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int j = 4 * lane + cc;
      if (i < Q && j <= i) G[((long long)bc * Q + i) * Q + j] = acc[r][cc];
    }
  }
}

// ---- pass 2: the chunk's own state s_c = (exp(La_Q - La) x)^T B
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
ssd_states_kernel(const float* __restrict__ x, const float* __restrict__ La,
                  const T* __restrict__ Bm, float* __restrict__ sc, int S,
                  int H, int P, int N, int Q, int nc, long long b_sb,
                  long long b_ss) {
  extern __shared__ float4 smem4[];
  float* Xs = reinterpret_cast<float*>(smem4);  // QMAX x PT, decayed x
  float* Bs = Xs + QMAX * PT;                   // QMAX x NT
  float* De = Bs + QMAX * NT;                   // QMAX, exp(La_Q - La_j)

  const int bch = blockIdx.x;  // ((b * nc) + c) * H + h
  const int h = bch % H, c = (bch / H) % nc, b = bch / H / nc;
  const int p0 = blockIdx.y * PT, n0 = blockIdx.z * NT;
  const long long t0 = (long long)c * Q;
  const int tid = threadIdx.x;
  const float* la = La + (long long)bch * Q;
  const float last = la[Q - 1];
  const T* Bb = Bm + b * b_sb;

  for (int j = tid; j < Q; j += THREADS) De[j] = expf(last - la[j]);
  __syncthreads();
#pragma unroll 4
  for (int g = tid; g < Q * PT / 4; g += THREADS) {
    const int j = g / (PT / 4), p = 4 * (g % (PT / 4));
    float v[4];
    load_row4(v, x + (((long long)b * S + t0 + j) * H + h) * P + p0 + p,
              P - p0 - p, true);
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] *= De[j];
    st4(Xs + j * PT + p, v);
  }
#pragma unroll 4
  for (int g = tid; g < Q * NT / 4; g += THREADS) {
    const int j = g / (NT / 4), n = 4 * (g % (NT / 4));
    float v[4];
    load_row4(v, Bb + (t0 + j) * b_ss + n0 + n, N - n0 - n, true);
    st4(Bs + j * NT + n, v);
  }
  __syncthreads();

  // rows p = 4 ty + r; columns n = 4 tx + cc (lo) and 64 + 4 tx + cc (hi)
  const int ty = tid / 16, tx = tid % 16;
  float lo[4][4], hi[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) lo[r][cc] = hi[r][cc] = 0.f;
  for (int j = 0; j < Q; ++j) {
    const float4 xv = ld4(Xs + j * PT + 4 * ty);
    const float4 b0 = ld4(Bs + j * NT + 4 * tx);
    const float4 b1 = ld4(Bs + j * NT + 64 + 4 * tx);
    const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      fma4(lo[r], xr[r], b0);
      fma4(hi[r], xr[r], b1);
    }
  }
  float* out = sc + (long long)bch * P * N;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int p = p0 + 4 * ty + r;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int n = n0 + 4 * tx + cc;
      if (p < P && n < N) out[(long long)p * N + n] = lo[r][cc];
      if (p < P && n + 64 < N) out[(long long)p * N + n + 64] = hi[r][cc];
    }
  }
}

// ---- pass 3: states entering each chunk, in place over s_c
__global__ void __launch_bounds__(THREADS)
ssd_state_pass_kernel(const float* __restrict__ La, float* __restrict__ sc,
                      float* __restrict__ st, int H, int PN, int Q, int nc) {
  const int e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= PN) return;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  // each group of up to 8 chunks loads all its values before the first
  // store, so a thread keeps 8 loads in flight rather than one
  constexpr int AHEAD = 8;
  float s = 0.f;
  for (int c0 = 0; c0 < nc; c0 += AHEAD) {
    float own[AHEAD], dec[AHEAD];
#pragma unroll
    for (int k = 0; k < AHEAD; ++k) {
      const long long bch = ((long long)b * nc + c0 + k) * H + h;
      own[k] = c0 + k < nc ? sc[bch * PN + e] : 0.f;
      dec[k] = c0 + k < nc ? expf(La[bch * Q + Q - 1]) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < AHEAD; ++k) {
      if (c0 + k < nc) {
        sc[(((long long)b * nc + c0 + k) * H + h) * PN + e] = s;
        s = dec[k] * s + own[k];
      }
    }
  }
  st[(long long)bh * PN + e] = s;
}

// ---- pass 4: y = exp(La_i) (C_i states_in^T) + (G o decay) x
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
ssd_chunk_scan_kernel(const float* __restrict__ x,
                      const float* __restrict__ La,
                      const float* __restrict__ G, const T* __restrict__ Cm,
                      const float* __restrict__ s_in, float* __restrict__ y,
                      int S, int H, int P, int N, int Q, int nc,
                      long long c_sb, long long c_ss) {
  extern __shared__ float4 smem4[];
  float* Ls = reinterpret_cast<float*>(smem4);  // QMAX, La of the chunk
  float* R = Ls + QMAX;
  // inter-chunk term: C transposed and the state tile transposed
  float* Ct = R;               // NT x QLD
  float* St = Ct + NT * QLD;   // NT x SLD
  // then, over the same space, the intra-chunk term
  float* Mt = R;               // QMAX x QLD, Mt[j][i] = G[i][j] decay
  float* Xs = Mt + QMAX * QLD;  // QMAX x PT

  const int bch = blockIdx.x;
  const int h = bch % H, c = (bch / H) % nc, b = bch / H / nc;
  const int bc = bch / H;
  const int p0 = blockIdx.y * PT;
  const long long t0 = (long long)c * Q;
  const int tid = threadIdx.x;
  const T* Cb = Cm + b * c_sb;
  for (int i = tid; i < QMAX; i += THREADS)
    Ls[i] = i < Q ? La[(long long)bch * Q + i] : 0.f;

  // rows i = 8 ty + r, columns p = 4 tx + cc
  const int ty = tid / 16, tx = tid % 16;
  float acc[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) acc[r][cc] = 0.f;

  const float* sb = s_in + (long long)bch * P * N;
  for (int n0 = 0; n0 < N; n0 += NT) {
    const int nn = min(NT, N - n0);
    __syncthreads();
    // transposed tiles: consecutive threads take consecutive rows, so
    // the column stores fall on consecutive banks
#pragma unroll 4
    for (int g = tid; g < NT * QMAX / 4; g += THREADS) {
      const int n = g % NT, r = 4 * (g / NT);
      float v[4];
      load_col4(v, Cb + (t0 + r) * c_ss + n0 + n, c_ss, Q - r, n < nn);
      st4(Ct + n * QLD + r, v);
    }
#pragma unroll 4
    for (int g = tid; g < NT * PT / 4; g += THREADS) {
      const int n = g % NT, p = 4 * (g / NT);
      float v[4];
      load_col4(v, sb + (long long)(p0 + p) * N + n0 + n, N, P - p0 - p,
                n < nn);
      st4(St + n * SLD + p, v);
    }
    __syncthreads();
    for (int n = 0; n < nn; ++n) {
      const float4 c0 = ld4(Ct + n * QLD + 8 * ty);
      const float4 c1 = ld4(Ct + n * QLD + 8 * ty + 4);
      const float4 sv = ld4(St + n * SLD + 4 * tx);
      const float cr[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
      for (int r = 0; r < 8; ++r) fma4(acc[r], cr[r], sv);
    }
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const float d = expf(Ls[8 * ty + r]);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) acc[r][cc] *= d;
  }

  __syncthreads();  // done with Ct and St
  const float* Gb = G + (long long)bc * Q * Q;
#pragma unroll 4
  for (int g = tid; g < QMAX * QMAX / 4; g += THREADS) {
    const int j = g % QMAX, i = 4 * (g / QMAX);
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const bool in = i + k < Q && j <= i + k;
      // the exponent is masked before the exp
      v[k] = (in ? Gb[(long long)(i + k) * Q + j] : 0.f) *
             expf(in ? Ls[i + k] - Ls[j] : NEG_INF);
    }
    st4(Mt + j * QLD + i, v);
  }
#pragma unroll 4
  for (int g = tid; g < QMAX * PT / 4; g += THREADS) {
    const int j = g / (PT / 4), p = 4 * (g % (PT / 4));
    float v[4];
    load_row4(v, x + (((long long)b * S + t0 + j) * H + h) * P + p0 + p,
              P - p0 - p, j < Q);
    st4(Xs + j * PT + p, v);
  }
  __syncthreads();
  const int jmax = min(Q, 8 * ty + 8);  // row 8 ty + 7 reduces over j <= it
  for (int j = 0; j < jmax; ++j) {
    const float4 m0 = ld4(Mt + j * QLD + 8 * ty);
    const float4 m1 = ld4(Mt + j * QLD + 8 * ty + 4);
    const float4 xv = ld4(Xs + j * PT + 4 * tx);
    const float mr[8] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w};
#pragma unroll
    for (int r = 0; r < 8; ++r) fma4(acc[r], mr[r], xv);
  }

#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = 8 * ty + r;
    if (i >= Q) continue;
    float* yr = y + (((long long)b * S + t0 + i) * H + h) * P + p0;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc)
      if (p0 + 4 * tx + cc < P) yr[4 * tx + cc] = acc[r][cc];
  }
}

// dynamic shared memory of each pass (bytes)
constexpr size_t SMEM_GRAM = sizeof(float) * (GS * NT + NT * QLD);
constexpr size_t SMEM_STATES =
    sizeof(float) * (QMAX * PT + QMAX * NT + QMAX);
constexpr size_t SMEM_SCAN =
    sizeof(float) *
    (QMAX + (NT * QLD + NT * SLD > QMAX * QLD + QMAX * PT
                 ? NT * QLD + NT * SLD
                 : QMAX * QLD + QMAX * PT));

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// grid and dynamic shared memory of each pass, in launch order: gram,
// chunk states, state pass, chunk scan (all of THREADS threads); the
// launch uses these and repro_ssd_scan_plan exports them
struct Pass {
  dim3 grid;
  size_t smem;
};

void plan_passes(int B, int S, int H, int P, int N, int Q, Pass (&p)[4]) {
  const int nc = S / Q;
  const int pb = (P + PT - 1) / PT, nb = (N + NT - 1) / NT;
  const int nstrip = (Q + GS - 1) / GS;
  const int hblocks = (H + THREADS / 32 - 1) / (THREADS / 32);
  p[0] = {dim3(B * nc, nstrip + hblocks), SMEM_GRAM};
  p[1] = {dim3(B * nc * H, pb, nb), SMEM_STATES};
  p[2] = {dim3((P * N + THREADS - 1) / THREADS, B * H), 0};
  p[3] = {dim3(B * nc * H, pb), SMEM_SCAN};
}

template <typename T>
cudaError_t launch(const void* x, const void* a, const void* Bm,
                   const void* Cm, void* y, void* st, void* G, void* La,
                   void* sc, int B, int S, int H, int P, int N, int Q,
                   long long b_sb, long long b_ss, long long c_sb,
                   long long c_ss, cudaStream_t stream) {
  const int nc = S / Q;
  const float* xf = static_cast<const float*>(x);
  const float* af = static_cast<const float*>(a);
  float* Gf = static_cast<float*>(G);
  float* Lf = static_cast<float*>(La);
  float* scf = static_cast<float*>(sc);
  cudaError_t err;
  if ((err = allow_smem(ssd_gram_kernel<T>, SMEM_GRAM)) != cudaSuccess ||
      (err = allow_smem(ssd_states_kernel<T>, SMEM_STATES)) != cudaSuccess ||
      (err = allow_smem(ssd_chunk_scan_kernel<T>, SMEM_SCAN)) != cudaSuccess)
    return err;

  Pass p[4];
  plan_passes(B, S, H, P, N, Q, p);
  ssd_gram_kernel<T><<<p[0].grid, THREADS, p[0].smem, stream>>>(
      af, static_cast<const T*>(Bm), static_cast<const T*>(Cm), Gf, Lf, S, H,
      N, Q, nc, b_sb, b_ss, c_sb, c_ss);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_states_kernel<T><<<p[1].grid, THREADS, p[1].smem, stream>>>(
      xf, Lf, static_cast<const T*>(Bm), scf, S, H, P, N, Q, nc, b_sb, b_ss);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_state_pass_kernel<<<p[2].grid, THREADS, p[2].smem, stream>>>(
      Lf, scf, static_cast<float*>(st), H, P * N, Q, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_chunk_scan_kernel<T><<<p[3].grid, THREADS, p[3].smem, stream>>>(
      xf, Lf, Gf, static_cast<const T*>(Cm), scf, static_cast<float*>(y), S,
      H, P, N, Q, nc, c_sb, c_ss);
  return cudaGetLastError();
}

}  // namespace

// The launch plan of one call, as the launch computes it: for each of the
// four passes in launch order, out[5 i ..] = {grid x, grid y, grid z,
// threads, dynamic shared memory in bytes}. Returns 0, or
// cudaErrorInvalidValue for sizes the launch refuses.
extern "C" int repro_ssd_scan_plan(int B, int S, int H, int P, int N, int Q,
                                   long long* out) {
  if (B < 1 || S < 1 || H < 1 || P < 1 || N < 1 || Q < 1 || Q > QMAX ||
      S % Q != 0)
    return (int)cudaErrorInvalidValue;
  Pass p[4];
  plan_passes(B, S, H, P, N, Q, p);
  for (int i = 0; i < 4; ++i) {
    out[5 * i] = p[i].grid.x;
    out[5 * i + 1] = p[i].grid.y;
    out[5 * i + 2] = p[i].grid.z;
    out[5 * i + 3] = THREADS;
    out[5 * i + 4] = (long long)p[i].smem;
  }
  return 0;
}

// dtype (of B and C): 0 = float32, 1 = bfloat16. x (B,S,H,P) and a (B,S,H)
// are contiguous float32; B and C are (B,S,N) with a contiguous last
// dimension and the given batch / step strides in elements; y (B,S,H,P)
// and st (B,H,P,N) are contiguous float32 outputs; G (B,nc,Q,Q), La
// (B,nc,H,Q) and sc (B,nc,H,P,N) are float32 scratch. Q divides S and is
// at most 128. Returns the cudaError_t of the first launch that failed
// (0 = ok).
extern "C" int repro_ssd_scan_fwd(const void* x, const void* a,
                                  const void* Bm, const void* Cm, void* y,
                                  void* st, void* G, void* La, void* sc,
                                  int dtype, int B, int S, int H, int P,
                                  int N, int Q, long long b_sb,
                                  long long b_ss, long long c_sb,
                                  long long c_ss, void* stream) {
  if (B < 1 || S < 1 || H < 1 || P < 1 || N < 1 || Q < 1 || Q > QMAX ||
      S % Q != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(x, a, Bm, Cm, y, st, G, La, sc, B, S, H, P, N,
                              Q, b_sb, b_ss, c_sb, c_ss, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, a, Bm, Cm, y, st, G, La, sc, B, S, H,
                                      P, N, Q, b_sb, b_ss, c_sb, c_ss, s);
  return (int)cudaErrorInvalidValue;
}
