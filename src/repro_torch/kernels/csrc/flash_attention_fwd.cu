// Flash-attention forward for Hopper (sm_90a), behind a plain C interface
// that repro_torch/kernels/flash_attention.py loads with ctypes.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_attn_kernel
// (launched by flash_attention_fwd, pallas_call at :126). It computes the
// same function: GQA online-softmax attention, scale 1/sqrt(D), optional
// tanh logit softcap, masks for padded keys (col < Skv), causal (col <= row)
// and sliding window (col > row - window); masked scores are -1e30; m, l and
// acc are carried in f32 and the output is acc / max(l, 1e-30) in q's dtype.
//
// What bounds it: at the serve prefill shape (B=1, S=1024, Hq=Hkv=64,
// D=128, causal, bf16) the card must move q, k, v and o once (67 MB, about
// 20 us at 3.35 TB/s) and do 2*S^2*D*H = 17.2 GFLOP (about 17 us on the bf16
// tensor cores), so the bound is memory. At the recurrentgemma-9b training
// shape (B=1, S=2048, Hq=16, Hkv=1, D=256, causal, window 2048, bf16) it
// moves 36 MB (11 us) and does 34.4 GFLOP (35 us), so there operations bound
// it. This first kernel is far from either bound:
// it does all arithmetic in f32 FMA on the CUDA cores (67 TFLOP/s peak) and
// feeds them from shared memory.
//
// Design (simple and correct first; wgmma, TMA and warp specialisation are
// later work):
//   * one thread block owns one (batch, q-head, tile of 128 query rows);
//     for D <= 128 one thread owns one query row, keeping acc[D] and the
//     row's scores for one kv tile in registers. At D = 256, acc[D] alone
//     would pass the 255-register limit and spill, so two neighbouring
//     threads (lanes 2r and 2r+1 of a warp) share a row: each keeps half
//     of acc, takes half of each q.k dot product and adds its partner's
//     half with one shuffle, and both run the row's softmax. The halves
//     interleave in groups of 4 columns, so the two lanes' float4 reads of
//     one K or V row fall on distinct banks;
//   * the TPU kernel's sequential kv grid axis becomes a loop over 32-key
//     tiles inside the block; each tile of K and V is loaded once into
//     shared memory (as f32) and shared by the block's 128 rows, which is
//     also how a GQA group's kv head is read by each of its q heads;
//   * kv tiles wholly outside the causal or window extent of the block's
//     rows are skipped, so a causal layer does about half the work and a
//     window layer never starts on a fully masked leading tile;
//   * the public (B, S, H, D) layout is read through its strides (the last
//     dimension must be contiguous); the output is contiguous (B, Sq, Hq, D)
//     and is staged through shared memory so its stores are coalesced.
// Templated on D in {32, 64, 128, 256} and on the input type (f32 or bf16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 128;  // query rows per block
constexpr int BK = 32;   // keys per kv tile
constexpr float NEG_INF = -1.0e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// threads per query row: 2 at D = 256 (see the design note), else 1
template <int D>
__host__ __device__ constexpr int split() {
  return D > 128 ? 2 : 1;
}

// Row stride of the q / output tile in shared memory: padded by 4 floats
// per thread of a row, so the float4 reads of neighbouring rows fall on
// distinct banks.
template <int D>
__host__ __device__ constexpr int q_stride() {
  return D + 4 * split<D>();
}

template <int D>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(BQ * q_stride<D>() + 2 * BK * D);
}

template <int D, typename T>
__global__ void __launch_bounds__(BQ * split<D>())
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, T* __restrict__ o, int Sq, int Skv,
                int Hq, int Hkv, long long q_sb, long long q_ss,
                long long q_sh, long long k_sb, long long k_ss,
                long long k_sh, long long v_sb, long long v_ss,
                long long v_sh, int causal, int window, float logit_cap,
                float scale) {
  constexpr int SPLIT = split<D>();
  constexpr int DH = D / SPLIT;   // acc columns per thread
  constexpr int NT = BQ * SPLIT;  // threads per block
  constexpr int QS = q_stride<D>();
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // BQ x QS
  float* Ks = Qs + BQ * QS;                     // BK x D
  float* Vs = Ks + BK * D;                      // BK x D

  const int tid = threadIdx.x;
  const int r_tile = tid / SPLIT;     // this thread's row of the tile
  const int part = tid % SPLIT;       // and its share of the columns
  // heaviest causal tiles first, so the tail of the grid is short
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int b = blockIdx.y / Hq;
  const int h = blockIdx.y % Hq;
  const int hk = h / (Hq / Hkv);
  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D;
    const int row = q0 + r;
    const float x = row < Sq ? to_f32(qb[row * q_ss + c]) : 0.f;
    Qs[r * QS + c] = x * scale;
  }

  // kv tiles that can hold an unmasked key for some row of this block
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int kv_end = causal ? min(Skv, q_last + 1) : Skv;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = kv_begin / BK;
  const int t_end = (kv_end + BK - 1) / BK;

  const int row = q0 + r_tile;
  // acc[c + i] holds column (c * SPLIT + part * 4 + i) for c = 0, 4, ...
  float acc[DH];
#pragma unroll
  for (int c = 0; c < DH; ++c) acc[c] = 0.f;
  float m = NEG_INF, l = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile is consumed (and Qs is written)
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, c = i % D;
      const int col = k0 + r;
      const bool in = col < Skv;
      Ks[i] = in ? to_f32(kb[col * k_ss + c]) : 0.f;
      Vs[i] = in ? to_f32(vb[col * v_ss + c]) : 0.f;
    }
    __syncthreads();

    float s[BK];
#pragma unroll
    for (int j = 0; j < BK; ++j) s[j] = 0.f;
    const float* qrow = Qs + r_tile * QS + part * 4;
#pragma unroll 4
    for (int c = 0; c < DH; c += 4) {
      const int d = c * SPLIT;
      const float4 q4 = *reinterpret_cast<const float4*>(qrow + d);
      const float* kcol = Ks + part * 4 + d;
#pragma unroll
      for (int j = 0; j < BK; ++j) {
        const float4 k4 = *reinterpret_cast<const float4*>(kcol + j * D);
        s[j] = fmaf(q4.x, k4.x, s[j]);
        s[j] = fmaf(q4.y, k4.y, s[j]);
        s[j] = fmaf(q4.z, k4.z, s[j]);
        s[j] = fmaf(q4.w, k4.w, s[j]);
      }
    }
    if constexpr (SPLIT == 2) {
      // both lanes of a row run every tile, so the whole warp takes part
#pragma unroll
      for (int j = 0; j < BK; ++j)
        s[j] += __shfl_xor_sync(0xffffffffu, s[j], 1);
    }

    float mt = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float x = s[j];
      if (logit_cap > 0.f) x = tanhf(x / logit_cap) * logit_cap;
      const int col = k0 + j;
      bool ok = col < Skv;
      if (causal) ok = ok && col <= row;
      if (window > 0) ok = ok && col > row - window;
      s[j] = ok ? x : NEG_INF;
      mt = fmaxf(mt, s[j]);
    }
    // online softmax with the -1e30 fill of the TPU kernel: a row whose
    // first tiles are all masked carries p = 1 there, and the first
    // unmasked score's correction exp(-1e30 - m) = 0 cancels it
    const float m_new = fmaxf(m, mt);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      s[j] = expf(s[j] - m_new);
      psum += s[j];
    }
    l = l * corr + psum;
    m = m_new;
#pragma unroll
    for (int c = 0; c < DH; ++c) acc[c] *= corr;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = s[j];
      const float* vrow = Vs + j * D + part * 4;
#pragma unroll
      for (int c = 0; c < DH; c += 4) {
        const float4 v4 = *reinterpret_cast<const float4*>(vrow + c * SPLIT);
        acc[c] = fmaf(p, v4.x, acc[c]);
        acc[c + 1] = fmaf(p, v4.y, acc[c + 1]);
        acc[c + 2] = fmaf(p, v4.z, acc[c + 2]);
        acc[c + 3] = fmaf(p, v4.w, acc[c + 3]);
      }
    }
  }

  __syncthreads();  // every thread is done with Qs: reuse it for the output
  const float den = fmaxf(l, 1e-30f);
  float* orow = Qs + r_tile * QS + part * 4;
#pragma unroll
  for (int c = 0; c < DH; c += 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) orow[c * SPLIT + i] = acc[c + i] / den;
  }
  __syncthreads();
  T* ob = o + ((long long)b * Sq * Hq + h) * D;
  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D;
    const int orow_i = q0 + r;
    if (orow_i < Sq)
      store_as(ob + (long long)orow_i * Hq * D + c, Qs[r * QS + c]);
  }
}

struct Args {
  const void *q, *k, *v;
  void* o;
  int B, Sq, Skv, Hq, Hkv;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int causal, window;
  float logit_cap, scale;
  cudaStream_t stream;
};

template <int D, typename T>
cudaError_t launch(const Args& a) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.B * a.Hq);
  attn_fwd_kernel<D, T><<<grid, BQ * split<D>(), smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o), a.Sq, a.Skv, a.Hq,
      a.Hkv, a.q_sb, a.q_ss, a.q_sh, a.k_sb, a.k_ss, a.k_sh, a.v_sb, a.v_ss,
      a.v_sh, a.causal, a.window, a.logit_cap, a.scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const Args& a) {
  switch (D) {
    case 32: return launch<32, T>(a);
    case 64: return launch<64, T>(a);
    case 128: return launch<128, T>(a);
    case 256: return launch<256, T>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the last
// dimension of q, k and v must be contiguous, and o is a contiguous
// (B, Sq, Hq, D) buffer. Returns the cudaError_t of the launch (0 = ok).
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int Sq, int Skv, int Hq, int Hkv, int D, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, int causal, int window,
    float logit_cap, float scale, void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || Hkv < 1 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, B, Sq, Skv, Hq, Hkv, q_sb, q_ss, q_sh, k_sb, k_ss,
               k_sh, v_sb, v_ss, v_sh, causal, window, logit_cap, scale,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return (int)launch_d<float>(D, a);
  if (dtype == 1) return (int)launch_d<__nv_bfloat16>(D, a);
  return (int)cudaErrorInvalidValue;
}
