// Flash-attention forward for Hopper (sm_90a), behind a plain C interface
// that repro_torch/kernels/flash_attention.py loads with ctypes.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_attn_kernel
// (launched by flash_attention_fwd, pallas_call at :126). It computes the
// same function (the bf16 kernel with two departures, both named below:
// where the scale is applied, and P rounded to bf16 for P V): GQA online-softmax attention, scale 1/sqrt(D), optional
// tanh logit softcap, masks for padded keys (col < Skv), causal (col <= row)
// and sliding window (col > row - window); masked scores are -1e30; m, l and
// acc are carried in f32 and the output is acc / max(l, 1e-30) in q's dtype.
//
// What bounds it: at the serve prefill shape (B=1, S=1024, Hq=Hkv=64,
// D=128, causal, bf16) the card must move q, k, v and o once (67 MB, 20.0 us
// at 3.35 TB/s) and do 4*D*H*(S*(S+1)/2) = 17.2 GFLOP (17.4 us on the bf16
// tensor cores at 989 TFLOP/s), so memory bounds it, with the operations
// close behind. At the recurrentgemma-9b training shape (B=1, S=2048,
// Hq=16, Hkv=1, D=256, causal, window 2048, bf16) it moves 36 MB (10.8 us)
// and does 34.4 GFLOP (34.8 us): operations bound it. Either way the
// kernel has to run its products on the tensor cores: the f32 CUDA cores
// (67 TFLOP/s) alone need 257 and 513 us for them.
//
// bf16 inputs: attn_fwd_mma_kernel, in the FlashAttention-2 style.
//   * One block owns (batch, q head, BQ query rows); each of its BQ/16 warps
//     owns 16 rows and runs their whole softmax on its own. BQ = 128 for
//     D <= 64, else 64 (at D = 128 two blocks of 4 warps share an SM and
//     do not wait on each other's barriers); BK = 64 keys per kv tile, 32
//     at D = 256, where each thread keeps a 16 x 256 f32 output share of
//     128 floats. (repro_flash_attention_plan exports these constants;
//     the card checks hold flash_attention.py::flash_plan, the Python
//     mirror the CPU tests use, against it.)
//   * Q, and K / V tiles double-buffered, sit in shared memory as bf16 (no
//     f32 copy), copied with 16-byte cp.async (zero-filled past Sq / Skv).
//     K and V of a tile are separate groups: the products S = Q K^T wait
//     for K only, and the next K tile is in flight while S, the softmax
//     and P V run; the next V tile while P V and the next S run. Rows are
//     padded by 16 bytes, so the eight 16-byte rows an ldmatrix phase
//     reads fall on distinct banks.
//   * S = Q K^T on mma.sync.m16n8k16 (bf16 in, f32 accumulate), with Q and
//     K fragments from ldmatrix. For D <= 128 the warp keeps its Q fragments
//     in registers; at D = 256 it re-reads them from shared memory for each
//     kv tile, which keeps the instance free of spills.
//   * The scale multiplies the f32 scores (the first departure: the TPU
//     kernel scales q in f32 before the product instead; the two agree
//     exactly at D = 64 and 256, where 1/sqrt(D) is a power of two, and
//     within an f32 rounding otherwise), folded with log2(e): scores, m and the corrections live
//     in the log2 domain, so each exponential is one ex2. Softcap, masks
//     and the online softmax follow in f32 registers, the row max and row
//     sum over the 4 lanes of a quad. Masks run on edge tiles only (padded
//     keys, the diagonal, the window's lower edge).
//   * P stays in registers: the S accumulator is repacked as bf16 A
//     fragments and multiplied by V (ldmatrix.trans) on the tensor cores.
//     This is the second departure from the TPU kernel, which keeps p in
//     f32 for p v: here each p is rounded to bf16 (a relative error of at
//     most 2^-8) before the product, while l sums the unrounded f32 p.
//     Against an f32 reference the output then errs by a bf16 rounding of
//     the output plus up to about as much again from P; the checks hold
//     it to 2^-6 of the largest output of its row.
//   * kv tiles wholly outside the causal or window extent of the block's
//     rows are not loaded; a warp skips the products of a tile that holds
//     no unmasked pair for its 16 rows. q tiles run heaviest first. There
//     are no atomics and no split over keys, so results are deterministic.
//   * The output goes through the warp's own Q rows in shared memory and
//     leaves as coalesced 16-byte stores into a contiguous (B, Sq, Hq, D).
//   q, k and v are read through their (B, S, H) strides; the last dimension
//   is contiguous and every pointer and stride is a multiple of 16 bytes
//   (the wrapper checks).
//   With 16 rows per warp every K and V fragment is read from shared memory
//   once per 16 query rows: at D = 128 a kv tile costs a warp 64 ldmatrix
//   x4 (256 shared-memory wavefronts) for 128 mma, so shared memory, not
//   the tensor cores, caps it near half their peak.
//
// f32 inputs keep the first kernel, attn_fwd_fma_kernel: all products in f32
// FMA on the CUDA cores, one thread per query row (two at D = 256). The f32
// bars of the tests (2e-5) need f32 products, which bf16 tensor cores do not
// give; no main path runs attention in f32, so it carries no tensor-core
// path.
//
// Both are templated on D in {32, 64, 128, 256}.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1.0e30f;

// The kv tiles [t_begin, t_end) of BK keys that can hold an unmasked key
// for some row of the block of query rows [q0, q0 + BQ): both kernels
// load these and no others (repro_flash_attention_tiles exports it, so
// the wrapper's Python mirror can be held against it)
__host__ __device__ inline void kv_tile_range(int q0, int BQ, int BK, int Sq,
                                              int Skv, int causal, int window,
                                              int& t_begin, int& t_end) {
  const int q_last = (q0 + BQ < Sq ? q0 + BQ : Sq) - 1;
  const int kv_end = causal ? (Skv < q_last + 1 ? Skv : q_last + 1) : Skv;
  const int kv_begin = window > 0 ? (q0 - window + 1 > 0 ? q0 - window + 1
                                                         : 0)
                                  : 0;
  t_begin = kv_begin / BK;
  t_end = (kv_end + BK - 1) / BK;
}

// Whether the kv tile of BK keys from k0 holds an unmasked pair for the 16
// query rows from r_lo: the tensor-core kernel's warp runs the tile's
// products only then (exported as repro_flash_attention_warp_live)
__host__ __device__ inline bool warp_tile_live(int k0, int r_lo, int BK,
                                               int Sq, int causal,
                                               int window) {
  return r_lo < Sq && !(causal && k0 > r_lo + 15) &&
         !(window > 0 && k0 + BK - 1 <= r_lo - window);
}

// ------------------------------------------------------------------ f32

constexpr int FMA_BQ = 128;  // query rows per block
constexpr int FMA_BK = 32;   // keys per kv tile

// threads per query row: 2 at D = 256 (one thread's acc[256] would spill),
// else 1. The two lanes of a row keep half of acc each, take half of each
// q.k product and add their partner's half with one shuffle; the halves
// interleave in groups of 4 columns so their float4 reads hit distinct banks
template <int D>
__host__ __device__ constexpr int fma_split() {
  return D > 128 ? 2 : 1;
}

// q / output tile row: padded by 4 floats per thread of a row
template <int D>
__host__ __device__ constexpr int fma_q_stride() {
  return D + 4 * fma_split<D>();
}

template <int D>
__host__ __device__ constexpr size_t fma_smem_bytes() {
  return sizeof(float) * (size_t)(FMA_BQ * fma_q_stride<D>() + 2 * FMA_BK * D);
}

template <int D>
__global__ void __launch_bounds__(FMA_BQ * fma_split<D>())
attn_fwd_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o,
                    int Sq, int Skv, int Hq, int Hkv, long long q_sb,
                    long long q_ss, long long q_sh, long long k_sb,
                    long long k_ss, long long k_sh, long long v_sb,
                    long long v_ss, long long v_sh, int causal, int window,
                    float logit_cap, float scale) {
  constexpr int SPLIT = fma_split<D>();
  constexpr int DH = D / SPLIT;      // acc columns per thread
  constexpr int NT = FMA_BQ * SPLIT;  // threads per block
  constexpr int QS = fma_q_stride<D>();
  constexpr int BQ = FMA_BQ, BK = FMA_BK;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // BQ x QS
  float* Ks = Qs + BQ * QS;                     // BK x D
  float* Vs = Ks + BK * D;                      // BK x D

  const int tid = threadIdx.x;
  const int r_tile = tid / SPLIT;
  const int part = tid % SPLIT;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest first
  const int b = blockIdx.y / Hq;
  const int h = blockIdx.y % Hq;
  const int hk = h / (Hq / Hkv);
  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + hk * k_sh;
  const float* vb = v + b * v_sb + hk * v_sh;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D;
    const int row = q0 + r;
    Qs[r * QS + c] = row < Sq ? qb[row * q_ss + c] * scale : 0.f;
  }

  int t_begin, t_end;
  kv_tile_range(q0, BQ, BK, Sq, Skv, causal, window, t_begin, t_end);

  const int row = q0 + r_tile;
  // acc[c + i] holds column (c * SPLIT + part * 4 + i) for c = 0, 4, ...
  float acc[DH];
#pragma unroll
  for (int c = 0; c < DH; ++c) acc[c] = 0.f;
  float m = NEG_INF, l = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BK;
    __syncthreads();
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, c = i % D;
      const int col = k0 + r;
      const bool in = col < Skv;
      Ks[i] = in ? kb[col * k_ss + c] : 0.f;
      Vs[i] = in ? vb[col * v_ss + c] : 0.f;
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
  float* ob = o + ((long long)b * Sq * Hq + h) * D;
  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D;
    const int orow_i = q0 + r;
    if (orow_i < Sq) ob[(long long)orow_i * Hq * D + c] = Qs[r * QS + c];
  }
}

// ------------------------------------------------------------------ bf16

using bf16 = __nv_bfloat16;

template <int D>
struct Mma {
  static constexpr int BQ = D <= 64 ? 128 : 64;  // query rows per block
  static constexpr int BK = D <= 128 ? 64 : 32;   // keys per kv tile
  static constexpr int THREADS = BQ / 16 * 32;    // one warp per 16 rows
  static constexpr int LD = D + 8;                // padded smem row (bf16)
  static constexpr bool Q_IN_REGS = D <= 128;
  // Q tile, then 2 stages of (K tile, V tile)
  static constexpr size_t SMEM = sizeof(bf16) * (size_t)LD * (BQ + 4 * BK);
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !in (the source address must
// still be valid: callers pass a row inside the tensor)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

constexpr float LOG2E = 1.4426950408889634f;

// 2^x (ex2.approx: 2 ulp; 2^-1e30 = 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

template <int D>
__global__ void __launch_bounds__(Mma<D>::THREADS)
attn_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o, int Sq,
                    int Skv, int Hq, int Hkv, long long q_sb, long long q_ss,
                    long long q_sh, long long k_sb, long long k_ss,
                    long long k_sh, long long v_sb, long long v_ss,
                    long long v_sh, int causal, int window, float logit_cap,
                    float scale) {
  using C = Mma<D>;
  constexpr int BQ = C::BQ, BK = C::BK, LD = C::LD, NT = C::THREADS;
  constexpr int DC = D / 8;   // 16-byte chunks per row
  constexpr int KD = D / 16;  // k steps of S = Q K^T
  constexpr int NS = BK / 8;  // n tiles of S
  constexpr int NO = D / 8;   // n tiles of O
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);  // BQ x LD
  bf16* Ks = Qs + BQ * LD;                    // 2 stages x BK x LD
  bf16* Vs = Ks + 2 * BK * LD;                // 2 stages x BK x LD

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tig = lane & 3;  // mma fragment row / column
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest first
  const int b = blockIdx.y / Hq;
  const int h = blockIdx.y % Hq;
  const int hk = h / (Hq / Hkv);
  const bf16* qb = q + b * q_sb + h * q_sh;
  const bf16* kb = k + b * k_sb + hk * k_sh;
  const bf16* vb = v + b * v_sb + hk * v_sh;

  for (int i = tid; i < BQ * DC; i += NT) {
    const int r = i / DC, c = i % DC;
    const int row = q0 + r;
    cp_async16(Qs + r * LD + c * 8, qb + (row < Sq ? row : 0) * q_ss + c * 8,
               row < Sq);
  }
  cp_async_commit();

  // kv tiles that can hold an unmasked key for some row of this block
  int t_begin, t_end;
  kv_tile_range(q0, BQ, BK, Sq, Skv, causal, window, t_begin, t_end);

  // one K or V tile into a stage, as its own cp.async group
  auto load_tile = [&](bf16* dst, const bf16* src, long long s_ss, int t) {
    for (int i = tid; i < BK * DC; i += NT) {
      const int r = i / DC, c = i % DC;
      const int col = t * BK + r;
      cp_async16(dst + r * LD + c * 8,
                 src + (col < Skv ? col : 0) * s_ss + c * 8, col < Skv);
    }
    cp_async_commit();
  };
  if (t_begin < t_end) {
    load_tile(Ks, kb, k_ss, t_begin);
    load_tile(Vs, vb, v_ss, t_begin);
  }

  const int r_lo = q0 + warp * 16;  // this warp's first row
  const int row0 = r_lo + g, row1 = row0 + 8;
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // m and the scores are kept in the log2 domain (scaled by log2(e)), so
  // each exponential is one ex2
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  const float score_mul = logit_cap > 0.f ? scale / logit_cap : scale * LOG2E;
  const float cap_mul = logit_cap * LOG2E;
  unsigned qf[C::Q_IN_REGS ? KD : 1][4];
  const bf16* qw = Qs + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;

  for (int t = t_begin; t < t_end; ++t) {
    const int stage = (t - t_begin) & 1;
    const bool next = t + 1 < t_end;
    const bf16* ks = Ks + stage * BK * LD;
    const bf16* vs = Vs + stage * BK * LD;
    cp_async_wait<1>();  // Q and K_t have landed; V_t may be in flight
    __syncthreads();     // ... for every thread, and the other stage is free
    if (next) load_tile(Ks + (stage ^ 1) * BK * LD, kb, k_ss, t + 1);
    if constexpr (C::Q_IN_REGS) {
      if (t == t_begin) {  // Q has landed with the first K tile
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) ldsm_x4(qf[kk], qw + kk * 16);
      }
    }
    const int k0 = t * BK;
    // the warp's 16 rows hold an unmasked pair in this tile; and some
    // pair of the tile is masked for them
    const bool live = warp_tile_live(k0, r_lo, BK, Sq, causal, window);
    const bool edge = k0 + BK > Skv || (causal && k0 + BK - 1 > r_lo) ||
                      (window > 0 && k0 <= r_lo + 15 - window);
    float s[NS][4];
    if (live) {
#pragma unroll
      for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        unsigned a[4];
        if constexpr (C::Q_IN_REGS) {
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = qf[kk][i];
        } else {
          ldsm_x4(a, qw + kk * 16);
        }
#pragma unroll
        for (int j = 0; j < NS; j += 2) {
          unsigned bk[4];  // b0, b1 of n tile j, then of n tile j + 1
          ldsm_x4(bk, ks + (j * 8 + (lane & 7) + ((lane >> 4) & 1) * 8) * LD +
                          kk * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(s[j], a, bk[0], bk[1]);
          mma_bf16(s[j + 1], a, bk[2], bk[3]);
        }
      }

      // scale and softcap in f32, to the log2 domain; masks on edge tiles
      // only. s[j][e] is (row0 for e < 2, else row1; column
      // k0 + 8 j + 2 tig + (e & 1))
      if (logit_cap > 0.f) {
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[j][e] = tanhf(s[j][e] * score_mul) * cap_mul;
      } else {
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] *= score_mul;
      }
      if (edge) {
#pragma unroll
        for (int j = 0; j < NS; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = k0 + j * 8 + tig * 2 + (e & 1);
            const int row = e < 2 ? row0 : row1;
            bool ok = col < Skv;
            if (causal) ok = ok && col <= row;
            if (window > 0) ok = ok && col > row - window;
            if (!ok) s[j][e] = NEG_INF;
          }
        }
      }
      float mt0 = NEG_INF, mt1 = NEG_INF;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        mt0 = fmaxf(mt0, fmaxf(s[j][0], s[j][1]));
        mt1 = fmaxf(mt1, fmaxf(s[j][2], s[j][3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mt0 = fmaxf(mt0, __shfl_xor_sync(0xffffffffu, mt0, off));
        mt1 = fmaxf(mt1, __shfl_xor_sync(0xffffffffu, mt1, off));
      }
      // online softmax with the -1e30 fill of the TPU kernel: a row whose
      // first tiles are all masked carries p = 1 there, and the first
      // unmasked score's correction exp(-1e30 - m) = 0 cancels it
      const float mn0 = fmaxf(m0, mt0), mn1 = fmaxf(m1, mt1);
      const float c0 = exp2_approx(m0 - mn0), c1 = exp2_approx(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float ps0 = 0.f, ps1 = 0.f;  // this lane's share of the row sums
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        s[j][0] = exp2_approx(s[j][0] - mn0);
        s[j][1] = exp2_approx(s[j][1] - mn0);
        s[j][2] = exp2_approx(s[j][2] - mn1);
        s[j][3] = exp2_approx(s[j][3] - mn1);
        ps0 += s[j][0] + s[j][1];
        ps1 += s[j][2] + s[j][3];
      }
      l0 = l0 * c0 + ps0;
      l1 = l1 * c1 + ps1;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[n][0] *= c0;
        acc[n][1] *= c0;
        acc[n][2] *= c1;
        acc[n][3] *= c1;
      }
    }

    if (next) {
      cp_async_wait<1>();  // V_t has landed; K_t+1 may be in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (next) load_tile(Vs + (stage ^ 1) * BK * LD, vb, v_ss, t + 1);
    if (live) {
      // O += P V: the S accumulator of n tiles 2 kk, 2 kk + 1 is the A
      // fragment of k step kk
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const unsigned a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                               pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                               pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int n = 0; n < NO; n += 2) {
          unsigned bv[4];  // b0, b1 of n tile n, then of n tile n + 1
          ldsm_x4_trans(bv, vs + (kk * 16 + (lane & 7) +
                                  ((lane >> 3) & 1) * 8) * LD +
                                n * 8 + ((lane >> 4) & 1) * 8);
          mma_bf16(acc[n], a, bv[0], bv[1]);
          mma_bf16(acc[n + 1], a, bv[2], bv[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  // the warp's 16 Q rows hold its output tile, then 16-byte stores
  bf16* os = Qs + warp * 16 * LD;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    *reinterpret_cast<__nv_bfloat162*>(os + g * LD + n * 8 + tig * 2) =
        __floats2bfloat162_rn(acc[n][0] * inv0, acc[n][1] * inv0);
    *reinterpret_cast<__nv_bfloat162*>(os + (g + 8) * LD + n * 8 + tig * 2) =
        __floats2bfloat162_rn(acc[n][2] * inv1, acc[n][3] * inv1);
  }
  __syncwarp();
  bf16* ob = o + ((long long)b * Sq * Hq + h) * D;
  for (int i = lane; i < 16 * DC; i += 32) {
    const int r = i / DC, c = i % DC;
    const int row = r_lo + r;
    if (row < Sq)
      *reinterpret_cast<uint4*>(ob + (long long)row * Hq * D + c * 8) =
          *reinterpret_cast<const uint4*>(os + r * LD + c * 8);
  }
}

// ------------------------------------------------------------------ launch

struct Args {
  const void *q, *k, *v;
  void* o;
  int B, Sq, Skv, Hq, Hkv;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int causal, window;
  float logit_cap, scale;
  cudaStream_t stream;
};

template <typename T, typename K>
cudaError_t launch(K kernel, int BQ, int threads, size_t smem,
                   const Args& a) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.B * a.Hq);
  kernel<<<grid, threads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o), a.Sq, a.Skv, a.Hq,
      a.Hkv, a.q_sb, a.q_ss, a.q_sh, a.k_sb, a.k_ss, a.k_sh, a.v_sb, a.v_ss,
      a.v_sh, a.causal, a.window, a.logit_cap, a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const Args& a) {
  return launch<float>(attn_fwd_fma_kernel<D>, FMA_BQ, FMA_BQ * fma_split<D>(),
                       fma_smem_bytes<D>(), a);
}

template <int D>
cudaError_t launch_bf16(const Args& a) {
  using C = Mma<D>;
  return launch<bf16>(attn_fwd_mma_kernel<D>, C::BQ, C::THREADS, C::SMEM, a);
}

// the launch constants of the instance for (dtype, D); false if there is
// none
struct Plan {
  int bq, bk, threads;
  size_t smem;
};

template <int D>
Plan plan_of(int dtype) {
  if (dtype == 0)
    return {FMA_BQ, FMA_BK, FMA_BQ * fma_split<D>(), fma_smem_bytes<D>()};
  return {Mma<D>::BQ, Mma<D>::BK, Mma<D>::THREADS, Mma<D>::SMEM};
}

bool find_plan(int dtype, int D, Plan& p) {
  if (dtype != 0 && dtype != 1) return false;
  switch (D) {
    case 32: p = plan_of<32>(dtype); return true;
    case 64: p = plan_of<64>(dtype); return true;
    case 128: p = plan_of<128>(dtype); return true;
    case 256: p = plan_of<256>(dtype); return true;
  }
  return false;
}

}  // namespace

// The launch constants of the instance for (dtype, D), as the launch uses
// them: out = {query rows per block, keys per kv tile, threads, dynamic
// shared memory in bytes}. Returns 0, or cudaErrorInvalidValue.
extern "C" int repro_flash_attention_plan(int dtype, int D, long long* out) {
  Plan p;
  if (!find_plan(dtype, D, p)) return (int)cudaErrorInvalidValue;
  out[0] = p.bq;
  out[1] = p.bk;
  out[2] = p.threads;
  out[3] = (long long)p.smem;
  return 0;
}

// The kv tiles out = {t_begin, t_end} that the block of the (dtype, D)
// instance starting at query row q0 loads. Returns 0, or
// cudaErrorInvalidValue.
extern "C" int repro_flash_attention_tiles(int dtype, int D, int q0, int Sq,
                                           int Skv, int causal, int window,
                                           int* out) {
  Plan p;
  if (!find_plan(dtype, D, p)) return (int)cudaErrorInvalidValue;
  kv_tile_range(q0, p.bq, p.bk, Sq, Skv, causal, window, out[0], out[1]);
  return 0;
}

// 1 if the bfloat16 instance's warp owning the 16 query rows from r_lo runs
// the products of the kv tile from key k0, else 0; -1 for no instance.
extern "C" int repro_flash_attention_warp_live(int D, int k0, int r_lo,
                                               int Sq, int causal,
                                               int window) {
  Plan p;
  if (!find_plan(1, D, p)) return -1;
  return warp_tile_live(k0, r_lo, p.bk, Sq, causal, window) ? 1 : 0;
}

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the last
// dimension of q, k and v must be contiguous (for bfloat16 the pointers and
// strides also 16-byte aligned), and o is a contiguous (B, Sq, Hq, D)
// buffer. Returns the cudaError_t of the launch (0 = ok).
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
  if (dtype == 0) {
    switch (D) {
      case 32: return (int)launch_f32<32>(a);
      case 64: return (int)launch_f32<64>(a);
      case 128: return (int)launch_f32<128>(a);
      case 256: return (int)launch_f32<256>(a);
    }
  } else if (dtype == 1) {
    switch (D) {
      case 32: return (int)launch_bf16<32>(a);
      case 64: return (int)launch_bf16<64>(a);
      case 128: return (int)launch_bf16<128>(a);
      case 256: return (int)launch_bf16<256>(a);
    }
  }
  return (int)cudaErrorInvalidValue;
}
