// flash_bwd: the gradient of flash_fwd (dq, dk, dv given dout), for the
// training step's attention on the card.
//
// Replaces: no TPU kernel. The Pallas _flash_kernel
// (quoracle_tpu/ops/flash_attention.py:37) has no backward, so
// jax.grad through it raises; the port's flash_attend is a
// torch.autograd.Function whose backward is this kernel. It differentiates
// exactly what flash_fwd computes: the same mask (kv_idx < kv_len,
// kv_idx + kv_pos_offset <= q_pos, the optional sliding window), GQA by
// head-index mapping, and a query row that sees no key (output 0) has a
// zero gradient and adds nothing to dk/dv. Inputs fp32 or bf16; every sum
// in fp32; gradients in the input's dtype.
//
// The FlashAttention-2 backward, without atomics so that a rerun is
// bit-equal (the trainer's resume is checked that way), in two kernels
// launched back to back on the caller's stream:
//   1. dq, grid (ceil(T/BQ), H, B): per block BQ query rows of one head.
//      Pass A streams the visible keys once for the rows' log-sum-exp
//      (recomputed here rather than taken from flash_fwd, which serving
//      launches unchanged); delta = rowsum(dout * out); both go to an fp32
//      scratch [B, H, T]. Pass B streams the keys again: P = exp(S - lse),
//      dP = dout V^T, dS = P (dP - delta), dq += dS K.
//   2. dk/dv, grid (ceil(S/BKV), KV, B): per block BKV keys of one KV
//      head, looping over the query tiles of all G heads of its group (the
//      GQA sum in fp32, in a fixed order): dv += P^T dout, dk += dS^T q.
//      Query tiles that see none of the block's keys (before them under
//      the causal mask, past the window) are skipped.
//
// What bounds it on an H100: the backward does ~2.5x the forward's
// operations on the visible keys (S, dP, dv, dk, dq: five products of the
// forward's two, plus the lse recompute here and S/dP again in the dk/dv
// kernel); at the training shapes (fp32, T = 256, hd = 128) that is ~60
// FLOPs per byte of q/k/v/out/dout/dq/dk/dv, so the tensor cores would make it
// memory bound, while these scalar fp32 FMAs (the common.cuh scheme:
// 16-byte shared-memory reads feeding four FMAs) make it bound by the
// FP32 pipe. A wgmma/TMA design is the owed redesign (ROADMAP Queue 2).
#include "common.cuh"

using namespace qtt;

namespace {

template <int HD>
struct Bwd {
  static_assert(HD == 128 || HD == 256, "head_dim 128 or 256");
  static constexpr int C = HD / 128;        // output columns per thread
  static constexpr int RS = HD + 4;         // padded fp32 row stride
  // dq kernel: BQ query rows, BK keys a tile
  static constexpr int BQ = 32;
  static constexpr int BK = HD == 128 ? 64 : 32;
  static constexpr int SS = BK + 4;
  static constexpr int DQ_Q = 0;
  static constexpr int DQ_DO = DQ_Q + BQ * RS;
  static constexpr int DQ_K = DQ_DO + BQ * RS;
  static constexpr int DQ_V = DQ_K + BK * RS;
  static constexpr int DQ_S = DQ_V + BK * RS;
  static constexpr int DQ_FLOATS = DQ_S + BQ * SS;
  static constexpr size_t DQ_BYTES = DQ_FLOATS * sizeof(float);
  // dk/dv kernel: BKV keys, BQ2 query rows a tile
  static constexpr int BKV = HD == 128 ? 32 : 16;
  static constexpr int BQ2 = HD == 128 ? 64 : 32;
  static constexpr int TS = BQ2 + 4;
  static constexpr int KV_K = 0;
  static constexpr int KV_V = KV_K + BKV * RS;
  static constexpr int KV_Q = KV_V + BKV * RS;
  static constexpr int KV_DO = KV_Q + BQ2 * RS;
  static constexpr int KV_PT = KV_DO + BQ2 * RS;
  static constexpr int KV_DST = KV_PT + BKV * TS;
  static constexpr int KV_FLOATS = KV_DST + BKV * TS;
  static constexpr size_t KV_BYTES = KV_FLOATS * sizeof(float);
};

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// row r of query position p sees key index s (absolute position s + off)
__device__ __forceinline__ bool sees(int p, int s, int lim, int off,
                                     int window) {
  const int kp = s + off;
  return s < lim && kp <= p && (window < 0 || p - kp < window);
}

// S[i][j] = q_i . k_j and dP[i][j] = do_i . v_j for one tile: thread owns
// key j = tid % NK and rows i = tid / NK + g * (THREADS / NK). With
// want_dp false only S is computed. Results stay in the thread's
// registers (s_out, dp_out), indexed by g.
template <int HD, int NQ, int NK, bool WANT_DP>
__device__ __forceinline__ void tile_dots(const float* q, const float* dout,
                                          const float* k, const float* v,
                                          float (&s_out)[NQ * NK / THREADS],
                                          float (&dp_out)[NQ * NK / THREADS]) {
  constexpr int RS = HD + 4;
  constexpr int GROUPS = THREADS / NK;
  constexpr int RPT = NQ / GROUPS;
  const int j = threadIdx.x % NK;
  const int i0 = threadIdx.x / NK;
#pragma unroll
  for (int g = 0; g < RPT; ++g) {
    s_out[g] = 0.f;
    dp_out[g] = 0.f;
  }
  const float* kr = k + j * RS;
  const float* vr = v + j * RS;
#pragma unroll 2
  for (int d = 0; d < HD; d += 4) {
    const float4 kd = *reinterpret_cast<const float4*>(kr + d);
    float4 vd;
    if (WANT_DP) vd = *reinterpret_cast<const float4*>(vr + d);
#pragma unroll
    for (int g = 0; g < RPT; ++g) {
      const int i = i0 + g * GROUPS;
      s_out[g] = dot4(*reinterpret_cast<const float4*>(q + i * RS + d), kd,
                      s_out[g]);
      if (WANT_DP)
        dp_out[g] = dot4(*reinterpret_cast<const float4*>(dout + i * RS + d),
                         vd, dp_out[g]);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ out,
                    const T* __restrict__ dout, const int* __restrict__ qpos,
                    const int* __restrict__ kv_len,
                    const int* __restrict__ kv_off, T* __restrict__ dq,
                    float* __restrict__ lse_g, float* __restrict__ delta_g,
                    int n_t, int n_s, int n_h, int n_kv, int window,
                    float scale) {
  using L = Bwd<HD>;
  constexpr int BQ = L::BQ, BK = L::BK, RS = L::RS, SS = L::SS, C = L::C;
  constexpr int PER = BQ * BK / THREADS;
  extern __shared__ __align__(16) float sm[];
  __shared__ int qp[BQ];
  __shared__ float m_s[BQ], l_s[BQ], lse_s[BQ], delta_s[BQ];
  float* Qs = sm + L::DQ_Q;
  float* DOs = sm + L::DQ_DO;
  float* Ks = sm + L::DQ_K;
  float* Vs = sm + L::DQ_V;
  float* Ss = sm + L::DQ_S;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int t0 = blockIdx.x * BQ;
  const int nq = min(BQ, n_t - t0);
  const int kvh = h / (n_h / n_kv);
  const int lim = min(n_s, kv_len[b]);
  const int off = kv_off[b];
  const size_t q_row = (size_t)n_h * HD;
  const size_t kv_row = (size_t)n_kv * HD;
  const T* qb = q + (size_t)b * n_t * q_row + (size_t)h * HD;
  const T* ob = out + (size_t)b * n_t * q_row + (size_t)h * HD;
  const T* dob = dout + (size_t)b * n_t * q_row + (size_t)h * HD;
  const T* kb = k + (size_t)b * n_s * kv_row + (size_t)kvh * HD;
  const T* vb = v + (size_t)b * n_s * kv_row + (size_t)kvh * HD;

  if (threadIdx.x < BQ) {
    const int i = threadIdx.x;
    qp[i] = i < nq ? qpos[b * n_t + t0 + i] : 0;
    m_s[i] = NEG_INF;
    l_s[i] = 0.f;
  }
  load_rows<T, HD>(Qs, RS, BQ, [&](int r) {
    return r < nq ? qb + (size_t)(t0 + r) * q_row : (const T*)nullptr;
  }, scale);
  load_rows<T, HD>(DOs, RS, BQ, [&](int r) {
    return r < nq ? dob + (size_t)(t0 + r) * q_row : (const T*)nullptr;
  }, 1.f);
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // delta = rowsum(dout * out), one warp a row
  for (int r = warp; r < BQ; r += THREADS / 32) {
    float acc = 0.f;
    if (r < nq) {
      const T* orow = ob + (size_t)(t0 + r) * q_row;
      for (int d = lane; d < HD; d += 32)
        acc = fmaf(DOs[r * RS + d], to_float(orow[d]), acc);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) delta_s[r] = acc;
  }

  int q_lo = qp[0], q_hi = qp[0];
  for (int r = 1; r < nq; ++r) {
    q_lo = min(q_lo, qp[r]);
    q_hi = max(q_hi, qp[r]);
  }
  const int hi = min(lim, q_hi - off + 1);
  int lo = window >= 0 ? max(0, q_lo - off - window + 1) : 0;
  lo = (lo / BK) * BK;
  auto visible = [&](int i, int s) {
    return i < nq && sees(qp[i], s, lim, off, window);
  };
  auto load_kv = [&](float* dst, const T* base, int key0) {
    load_rows<T, HD>(dst, RS, BK, [&](int jj) {
      const int s = key0 + jj;
      return s < hi ? base + (size_t)s * kv_row : (const T*)nullptr;
    }, 1.f);
  };

  const int j = threadIdx.x % BK;
  const int i0 = threadIdx.x / BK;
  constexpr int GROUPS = THREADS / BK;
  float s_reg[PER], dp_reg[PER];

  // pass A: the rows' log-sum-exp over the visible keys
  for (int key0 = lo; key0 < hi; key0 += BK) {
    load_kv(Ks, kb, key0);
    __syncthreads();
    tile_dots<HD, BQ, BK, false>(Qs, DOs, Ks, Vs, s_reg, dp_reg);
#pragma unroll
    for (int g = 0; g < PER; ++g) {
      const int i = i0 + g * GROUPS;
      Ss[i * SS + j] = visible(i, key0 + j) ? s_reg[g] : NEG_INF;
    }
    __syncthreads();
    for (int r = warp; r < nq; r += THREADS / 32) {
      float mx = NEG_INF;
      for (int jj = lane; jj < BK; jj += 32) mx = fmaxf(mx, Ss[r * SS + jj]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int jj = lane; jj < BK; jj += 32)
        if (visible(r, key0 + jj)) sum += expf(Ss[r * SS + jj] - m_new);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        l_s[r] = l_s[r] * expf(m_old - m_new) + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
  }
  if (threadIdx.x < nq) {
    const int r = threadIdx.x;
    // a row that sees nothing has P = 0 everywhere (the mask, not lse,
    // keeps it so); 0 is stored for it
    lse_s[r] = l_s[r] > 0.f ? m_s[r] + logf(l_s[r]) : 0.f;
    const size_t at = ((size_t)b * n_h + h) * n_t + t0 + r;
    lse_g[at] = lse_s[r];
    delta_g[at] = delta_s[r];
  }
  __syncthreads();

  // pass B: dq = scale * sum_j dS_ij k_j; thread owns column
  // threadIdx.x + 128 c of all BQ rows
  float acc[C][BQ];
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int r = 0; r < BQ; ++r) acc[c][r] = 0.f;
  for (int key0 = lo; key0 < hi; key0 += BK) {
    load_kv(Ks, kb, key0);
    load_kv(Vs, vb, key0);
    __syncthreads();
    tile_dots<HD, BQ, BK, true>(Qs, DOs, Ks, Vs, s_reg, dp_reg);
#pragma unroll
    for (int g = 0; g < PER; ++g) {
      const int i = i0 + g * GROUPS;
      const float p = visible(i, key0 + j) ? expf(s_reg[g] - lse_s[i]) : 0.f;
      Ss[i * SS + j] = p * (dp_reg[g] - delta_s[i]);
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int d = threadIdx.x + 128 * c;
#pragma unroll 2
      for (int jj = 0; jj < BK; jj += 4) {
        const float4 kj = make_float4(Ks[jj * RS + d], Ks[(jj + 1) * RS + d],
                                      Ks[(jj + 2) * RS + d],
                                      Ks[(jj + 3) * RS + d]);
#pragma unroll
        for (int r = 0; r < BQ; ++r)
          acc[c][r] = dot4(*reinterpret_cast<const float4*>(Ss + r * SS + jj),
                           kj, acc[c][r]);
      }
    }
    __syncthreads();
  }
  T* dqb = dq + (size_t)b * n_t * q_row + (size_t)h * HD;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int d = threadIdx.x + 128 * c;
#pragma unroll
    for (int r = 0; r < BQ; ++r)
      if (r < nq) dqb[(size_t)(t0 + r) * q_row + d] = from_float<T>(acc[c][r] * scale);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const int* __restrict__ qpos,
                      const int* __restrict__ kv_len,
                      const int* __restrict__ kv_off,
                      const float* __restrict__ lse_g,
                      const float* __restrict__ delta_g, T* __restrict__ dk,
                      T* __restrict__ dv, int n_t, int n_s, int n_h,
                      int n_kv, int window, float scale) {
  using L = Bwd<HD>;
  constexpr int BKV = L::BKV, BQ = L::BQ2, RS = L::RS, TS = L::TS, C = L::C;
  constexpr int PER = BQ * BKV / THREADS;
  constexpr int GROUPS = THREADS / BKV;
  extern __shared__ __align__(16) float sm[];
  __shared__ int qp[BQ];
  __shared__ float lse_s[BQ], delta_s[BQ];
  float* Ks = sm + L::KV_K;
  float* Vs = sm + L::KV_V;
  float* Qs = sm + L::KV_Q;
  float* DOs = sm + L::KV_DO;
  float* PT = sm + L::KV_PT;
  float* DST = sm + L::KV_DST;

  const int b = blockIdx.z;
  const int kvh = blockIdx.y;
  const int s0 = blockIdx.x * BKV;
  const int G = n_h / n_kv;
  const int lim = min(n_s, kv_len[b]);
  const int off = kv_off[b];
  const size_t q_row = (size_t)n_h * HD;
  const size_t kv_row = (size_t)n_kv * HD;
  const T* kb = k + (size_t)b * n_s * kv_row + (size_t)kvh * HD;
  const T* vb = v + (size_t)b * n_s * kv_row + (size_t)kvh * HD;
  // the keys of this block that any query may see: [s0, s_end)
  const int s_end = min(s0 + BKV, lim);

  float dk_acc[C][BKV], dv_acc[C][BKV];
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int jj = 0; jj < BKV; ++jj) {
      dk_acc[c][jj] = 0.f;
      dv_acc[c][jj] = 0.f;
    }

  if (s0 < s_end) {
    load_rows<T, HD>(Ks, RS, BKV, [&](int jj) {
      return s0 + jj < s_end ? kb + (size_t)(s0 + jj) * kv_row
                             : (const T*)nullptr;
    }, 1.f);
    load_rows<T, HD>(Vs, RS, BKV, [&](int jj) {
      return s0 + jj < s_end ? vb + (size_t)(s0 + jj) * kv_row
                             : (const T*)nullptr;
    }, 1.f);
    const int j = threadIdx.x % BKV;
    const int i0 = threadIdx.x / BKV;
    float s_reg[PER], dp_reg[PER];
    for (int hh = 0; hh < G; ++hh) {
      const int h = kvh * G + hh;
      const T* qb = q + (size_t)b * n_t * q_row + (size_t)h * HD;
      const T* dob = dout + (size_t)b * n_t * q_row + (size_t)h * HD;
      const size_t st = ((size_t)b * n_h + h) * n_t;
      for (int t0 = 0; t0 < n_t; t0 += BQ) {
        const int nq = min(BQ, n_t - t0);
        __syncthreads();          // the last tile's readers are done
        if (threadIdx.x < BQ) {
          const int i = threadIdx.x;
          qp[i] = i < nq ? qpos[b * n_t + t0 + i] : 0;
          lse_s[i] = i < nq ? lse_g[st + t0 + i] : 0.f;
          delta_s[i] = i < nq ? delta_g[st + t0 + i] : 0.f;
        }
        __syncthreads();
        int q_lo = qp[0], q_hi = qp[0];
        for (int r = 1; r < nq; ++r) {
          q_lo = min(q_lo, qp[r]);
          q_hi = max(q_hi, qp[r]);
        }
        // every key after every query, or every key out of every
        // query's window: the tile adds nothing
        if (s0 + off > q_hi) continue;
        if (window >= 0 && q_lo - (s_end - 1 + off) >= window) continue;
        load_rows<T, HD>(Qs, RS, BQ, [&](int r) {
          return r < nq ? qb + (size_t)(t0 + r) * q_row : (const T*)nullptr;
        }, scale);
        load_rows<T, HD>(DOs, RS, BQ, [&](int r) {
          return r < nq ? dob + (size_t)(t0 + r) * q_row : (const T*)nullptr;
        }, 1.f);
        __syncthreads();
        tile_dots<HD, BQ, BKV, true>(Qs, DOs, Ks, Vs, s_reg, dp_reg);
#pragma unroll
        for (int g = 0; g < PER; ++g) {
          const int i = i0 + g * GROUPS;
          const bool vis = i < nq && sees(qp[i], s0 + j, lim, off, window);
          const float p = vis ? expf(s_reg[g] - lse_s[i]) : 0.f;
          PT[j * TS + i] = p;
          DST[j * TS + i] = p * (dp_reg[g] - delta_s[i]);
        }
        __syncthreads();
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int d = threadIdx.x + 128 * c;
          for (int ii = 0; ii < BQ; ii += 4) {
            const float4 do4 = make_float4(
                DOs[ii * RS + d], DOs[(ii + 1) * RS + d],
                DOs[(ii + 2) * RS + d], DOs[(ii + 3) * RS + d]);
            const float4 q4 = make_float4(
                Qs[ii * RS + d], Qs[(ii + 1) * RS + d],
                Qs[(ii + 2) * RS + d], Qs[(ii + 3) * RS + d]);
#pragma unroll
            for (int jj = 0; jj < BKV; ++jj) {
              dv_acc[c][jj] = dot4(
                  *reinterpret_cast<const float4*>(PT + jj * TS + ii), do4,
                  dv_acc[c][jj]);
              dk_acc[c][jj] = dot4(
                  *reinterpret_cast<const float4*>(DST + jj * TS + ii), q4,
                  dk_acc[c][jj]);
            }
          }
        }
      }
    }
  }
  // every key of the block is written: 0 where no query sees it
  T* dkb = dk + (size_t)b * n_s * kv_row + (size_t)kvh * HD;
  T* dvb = dv + (size_t)b * n_s * kv_row + (size_t)kvh * HD;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int d = threadIdx.x + 128 * c;
#pragma unroll
    for (int jj = 0; jj < BKV; ++jj) {
      const int s = s0 + jj;
      if (s < n_s) {
        dkb[(size_t)s * kv_row + d] = from_float<T>(dk_acc[c][jj]);
        dvb[(size_t)s * kv_row + d] = from_float<T>(dv_acc[c][jj]);
      }
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const int* qpos, const int* kv_len,
           const int* kv_off, void* dq, void* dk, void* dv, float* lse,
           float* delta, int n_b, int n_t, int n_s, int n_h, int n_kv,
           int window, float scale, cudaStream_t stream) {
  using L = Bwd<HD>;
  if (n_kv < 1 || n_h % n_kv) return (int)cudaErrorInvalidValue;
  auto dq_kern = flash_bwd_dq_kernel<T, HD>;
  auto kv_kern = flash_bwd_dkdv_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      dq_kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L::DQ_BYTES);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kv_kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)L::KV_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid_q((n_t + L::BQ - 1) / L::BQ, n_h, n_b);
  dq_kern<<<grid_q, THREADS, L::DQ_BYTES, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)out, (const T*)dout,
      qpos, kv_len, kv_off, (T*)dq, lse, delta, n_t, n_s, n_h, n_kv, window,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid_kv((n_s + L::BKV - 1) / L::BKV, n_kv, n_b);
  kv_kern<<<grid_kv, THREADS, L::KV_BYTES, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, qpos, kv_len,
      kv_off, lse, delta, (T*)dk, (T*)dv, n_t, n_s, n_h, n_kv, window,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; window < 0 = no sliding window.
// q/out/dout/dq [B,T,H,hd], k/v/dk/dv [B,S,KV,hd] in that dtype, all
// contiguous; lse and delta are fp32 scratch of B*H*T floats each.
// Returns a cudaError_t; nonzero means a kernel did not launch.
extern "C" int flash_bwd(const void* q, const void* k, const void* v,
                         const void* out, const void* dout, const void* qpos,
                         const void* kv_len, const void* kv_off, void* dq,
                         void* dk, void* dv, void* lse, void* delta,
                         int n_b, int n_t, int n_s, int n_h, int n_kv,
                         int head_dim, int window, float scale, int dtype,
                         void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int* qp = (const int*)qpos;
  const int* kl = (const int*)kv_len;
  const int* ko = (const int*)kv_off;
  float* ls = (float*)lse;
  float* dl = (float*)delta;
  if (dtype == 0 && head_dim == 128)
    return launch<float, 128>(q, k, v, out, dout, qp, kl, ko, dq, dk, dv, ls,
                              dl, n_b, n_t, n_s, n_h, n_kv, window, scale, st);
  if (dtype == 0 && head_dim == 256)
    return launch<float, 256>(q, k, v, out, dout, qp, kl, ko, dq, dk, dv, ls,
                              dl, n_b, n_t, n_s, n_h, n_kv, window, scale, st);
  if (dtype == 1 && head_dim == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, out, dout, qp, kl, ko, dq, dk,
                                      dv, ls, dl, n_b, n_t, n_s, n_h, n_kv,
                                      window, scale, st);
  if (dtype == 1 && head_dim == 256)
    return launch<__nv_bfloat16, 256>(q, k, v, out, dout, qp, kl, ko, dq, dk,
                                      dv, ls, dl, n_b, n_t, n_s, n_h, n_kv,
                                      window, scale, st);
  return (int)cudaErrorInvalidValue;
}
