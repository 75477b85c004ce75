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
// 21 MB each, the final state 2.6 MB), about 14 us at 3.35 TB/s, and do
// about 3.4 GFLOP (C B^T once per chunk, then per head and chunk the
// masked Q x Q x P product, C state^T and the state update, each
// Q x P x N), about 50 us in f32 on the CUDA cores (67 TFLOP/s). So the
// bound is operations, as long as the kernel keeps f32 as the TPU kernel
// does. This first kernel uses f32 FMA from shared memory; mma / wgmma on
// the three products is later work.
//
// Design (simple and correct first):
//   * the TPU grid (B, H, chunks) with a sequential chunk axis and a VMEM
//     (P, N) carry becomes one block per (batch, head, 16 head-dim
//     columns): y[:, p] and state[p, :] read only x[:, p], so splitting P
//     gives 320 blocks at the training shape (a (b, h) grid alone would
//     give 80 for 132 SMs). The chunk loop runs inside the block with the
//     16 x N state slice in shared memory;
//   * per chunk, the block loads B and C (Q x N, as f32, rows padded to
//     N+1 floats so column walks fall on distinct banks), its x slice and
//     dA_log, takes the cumsum, and builds the masked, decayed G tile
//     M[i][j] = (C_i . B_j) exp(la_i - la_j) for j <= i, else 0, with an
//     8 x 8 register tile per thread. C B^T does not depend on the head;
//     each block recomputes it rather than reading it from another pass;
//   * the decay is masked in the exponent: exp(la_i - la_j) is computed
//     only for j <= i (above the diagonal the difference is >= 0 and
//     overflows to inf at full-width decays, and inf * 0 would be NaN);
//   * y rows are reduced over j <= i only; the state update follows y so
//     the inter-chunk term reads the state from before the chunk.
// Templated on the type of B and C (f32 or bf16); xh and dA_log are f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int PB = 16;        // head-dim columns per block
constexpr int THREADS = 256;  // 16 x 16 threads for the G tile
constexpr int TILE = 8;       // G rows / cols per thread (16 * 8 = 128)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_fwd_kernel(const float* __restrict__ x, const float* __restrict__ a,
               const T* __restrict__ Bm, const T* __restrict__ Cm,
               float* __restrict__ y, float* __restrict__ st, int S, int H,
               int P, int N, int Q, long long b_sb, long long b_ss,
               long long c_sb, long long c_ss) {
  extern __shared__ float smem[];
  const int NS = N + 1;
  const int QS = Q + 1;
  float* Bs = smem;             // Q x NS
  float* Cs = Bs + Q * NS;      // Q x NS
  float* Ms = Cs + Q * NS;      // Q x QS, masked decayed C B^T
  float* Xs = Ms + Q * QS;      // Q x PB
  float* Ss = Xs + Q * PB;      // PB x NS, the state slice
  float* La = Ss + PB * NS;     // Q, cumulative log decay in the chunk
  float* De = La + Q;           // Q, exp(la_last - la_j)

  const int tid = threadIdx.x;
  const int pblocks = (P + PB - 1) / PB;
  const int p0 = (blockIdx.x % pblocks) * PB;
  const int h = (blockIdx.x / pblocks) % H;
  const int b = blockIdx.x / pblocks / H;
  const int np = min(PB, P - p0);
  const T* Bb = Bm + b * b_sb;
  const T* Cb = Cm + b * c_sb;

  for (int i = tid; i < PB * NS; i += THREADS) Ss[i] = 0.f;

  const int nc = S / Q;
  for (int c = 0; c < nc; ++c) {
    const long long t0 = (long long)c * Q;
    __syncthreads();  // the previous chunk is done with every tile
    for (int i = tid; i < Q * N; i += THREADS) {
      const int r = i / N, n = i % N;
      Bs[r * NS + n] = to_f32(Bb[(t0 + r) * b_ss + n]);
      Cs[r * NS + n] = to_f32(Cb[(t0 + r) * c_ss + n]);
    }
    for (int i = tid; i < Q * PB; i += THREADS) {
      const int r = i / PB, pp = i % PB;
      Xs[i] = pp < np
                  ? x[(((long long)b * S + t0 + r) * H + h) * P + p0 + pp]
                  : 0.f;
    }
    if (tid == 0) {
      float s = 0.f;
      for (int r = 0; r < Q; ++r) {
        s += a[((long long)b * S + t0 + r) * H + h];
        La[r] = s;
      }
    }
    __syncthreads();
    for (int r = tid; r < Q; r += THREADS) De[r] = expf(La[Q - 1] - La[r]);

    // M = (C B^T) o exp(la_i - la_j) on and below the diagonal
    {
      const int ty = tid / 16, tx = tid % 16;
      float acc[TILE][TILE];
#pragma unroll
      for (int i = 0; i < TILE; ++i)
#pragma unroll
        for (int j = 0; j < TILE; ++j) acc[i][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[TILE], bv[TILE];
#pragma unroll
        for (int i = 0; i < TILE; ++i) {
          const int r = ty + 16 * i;
          cv[i] = r < Q ? Cs[r * NS + n] : 0.f;
          const int col = tx + 16 * i;
          bv[i] = col < Q ? Bs[col * NS + n] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < TILE; ++i)
#pragma unroll
          for (int j = 0; j < TILE; ++j)
            acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < TILE; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < TILE; ++j) {
          const int col = tx + 16 * j;
          if (r < Q && col < Q)
            Ms[r * QS + col] =
                col <= r ? acc[i][j] * expf(La[r] - La[col]) : 0.f;
        }
      }
    }
    __syncthreads();

    // y = M x + exp(la) (C state^T), state from before this chunk
    {
      const int pp = tid % PB;
      for (int r = tid / PB; r < Q; r += THREADS / PB) {
        float intra = 0.f;
        for (int j = 0; j <= r; ++j)
          intra = fmaf(Ms[r * QS + j], Xs[j * PB + pp], intra);
        float inter = 0.f;
        for (int n = 0; n < N; ++n)
          inter = fmaf(Cs[r * NS + n], Ss[pp * NS + n], inter);
        if (pp < np)
          y[(((long long)b * S + t0 + r) * H + h) * P + p0 + pp] =
              intra + expf(La[r]) * inter;
      }
    }
    __syncthreads();

    // state = exp(la_last) state + (exp(la_last - la) x)^T B
    {
      const float dec = expf(La[Q - 1]);
      for (int i = tid; i < PB * N; i += THREADS) {
        const int pp = i / N, n = i % N;
        float acc = 0.f;
        for (int j = 0; j < Q; ++j)
          acc = fmaf(De[j] * Xs[j * PB + pp], Bs[j * NS + n], acc);
        Ss[pp * NS + n] = Ss[pp * NS + n] * dec + acc;
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < np * N; i += THREADS) {
    const int pp = i / N, n = i % N;
    st[(((long long)b * H + h) * P + p0 + pp) * N + n] = Ss[pp * NS + n];
  }
}

size_t smem_bytes(int Q, int N) {
  return sizeof(float) * ((size_t)2 * Q * (N + 1) + (size_t)Q * (Q + 1) +
                          (size_t)Q * PB + (size_t)PB * (N + 1) + 2 * Q);
}

template <typename T>
cudaError_t launch(const void* x, const void* a, const void* Bm,
                   const void* Cm, void* y, void* st, int B, int S, int H,
                   int P, int N, int Q, long long b_sb, long long b_ss,
                   long long c_sb, long long c_ss, cudaStream_t stream) {
  const size_t smem = smem_bytes(Q, N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)B * H * ((P + PB - 1) / PB);
  ssd_fwd_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(a),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      static_cast<float*>(y), static_cast<float*>(st), S, H, P, N, Q, b_sb,
      b_ss, c_sb, c_ss);
  return cudaGetLastError();
}

}  // namespace

// dtype (of B and C): 0 = float32, 1 = bfloat16. x (B,S,H,P) and a (B,S,H)
// are contiguous float32; B and C are (B,S,N) with a contiguous last
// dimension and the given batch / step strides in elements; y (B,S,H,P)
// and st (B,H,P,N) are contiguous float32 outputs. Q divides S and is at
// most 128. Returns the cudaError_t of the launch (0 = ok).
extern "C" int repro_ssd_scan_fwd(const void* x, const void* a,
                                  const void* Bm, const void* Cm, void* y,
                                  void* st, int dtype, int B, int S, int H,
                                  int P, int N, int Q, long long b_sb,
                                  long long b_ss, long long c_sb,
                                  long long c_ss, void* stream) {
  if (B < 1 || S < 1 || H < 1 || P < 1 || N < 1 || Q < 1 ||
      Q > 16 * TILE || S % Q != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(x, a, Bm, Cm, y, st, B, S, H, P, N, Q, b_sb,
                              b_ss, c_sb, c_ss, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, a, Bm, Cm, y, st, B, S, H, P, N, Q,
                                      b_sb, b_ss, c_sb, c_ss, s);
  return (int)cudaErrorInvalidValue;
}
