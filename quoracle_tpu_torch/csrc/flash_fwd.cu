// flash_fwd: causal GQA attention of a query chunk against a dense padded
// KV buffer, for dense prefill chunks of at least 256 tokens.
//
// Replaces: quoracle_tpu/ops/flash_attention.py, _flash_kernel (the
// Pallas TPU kernel behind flash_attend). Same contract: q [B,T,H,hd],
// k/v [B,S,KV,hd], q_positions [B,T], kv_len [B], kv_pos_offset [B];
// masks kv_idx < kv_len, kv_idx + offset <= q_pos, and the optional
// sliding window; query head h reads KV head h / (H/KV); online softmax
// in fp32; a row with nothing visible writes 0; output in q's dtype.
//
// What bounds it on an H100: at the main path's shapes (T = 1024, S =
// 1088, hd = 128, G = 4) the causal attention does ~8.5 GFLOP on ~20 MB
// of q/k/v/out, ~400 FLOPs per byte, above the bf16 tensor-core ridge
// (~295): the least time is the operations over 989 TFLOP/s. The first
// version (PR 1) ran scalar fp32 FMAs at ~12 TFLOP/s, widened every bf16
// tile to fp32 in shared memory and read each K/V tile once per query
// head.
//
// What the design does about it (bf16, tc_attention.cuh): a block is TQ =
// 64 / G queries times the G heads of one KV head, grid (KV, ceil(T/TQ),
// B), so each K/V tile is read once per KV head and feeds 64 score rows;
// S = QK^T and PV run as bf16 mma.sync with fp32 sums, K/V stream in bf16
// through a 2-stage cp.async ring, the softmax stays in registers, and
// only tiles on an edge (the causal diagonal, kv_len, the window) are
// masked per element. Causal query blocks differ in length, so the
// longest start first. The KV loop runs only over [max(0, min_qpos -
// offset - window + 1), min(S, kv_len, max_qpos - offset + 1)), work the
// TPU kernel does and need not. fp32 (the reference dtype, held to 1e-5)
// keeps common.cuh's scalar path: 32 query rows of one head per block.
// wgmma fed by TMA is the next redesign.
#include "common.cuh"
#include "tc_attention.cuh"

using namespace qtt;

namespace {

constexpr int ROWS = 32;          // query rows per block

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ qpos,
                 const int* __restrict__ kv_len,
                 const int* __restrict__ kv_off, T* __restrict__ out,
                 int n_t, int n_s, int n_h, int n_kv, int window,
                 float scale) {
  extern __shared__ __align__(16) float sm[];
  using L = Smem<HD, ROWS>;
  __shared__ int qp[ROWS];
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int t0 = blockIdx.x * ROWS;
  const int R = min(ROWS, n_t - t0);
  const int kvh = h / (n_h / n_kv);
  const int len = kv_len[b];
  const int off = kv_off[b];

  if (threadIdx.x < ROWS)
    qp[threadIdx.x] = threadIdx.x < R ? qpos[b * n_t + t0 + threadIdx.x] : 0;
  init_stats<HD, ROWS>(sm);
  load_rows<T, HD>(sm + L::Q, L::QS, R, [&](int r) {
    return q + ((size_t)(b * n_t + t0 + r) * n_h + h) * HD;
  }, scale);
  __syncthreads();

  int q_lo = qp[0], q_hi = qp[0];
  for (int r = 1; r < R; ++r) {
    q_lo = min(q_lo, qp[r]);
    q_hi = max(q_hi, qp[r]);
  }
  // keys past `hi` or before `lo` are masked for every row of the block
  const int lim = min(n_s, len);
  const int hi = min(lim, q_hi - off + 1);
  int lo = window >= 0 ? max(0, q_lo - off - window + 1) : 0;
  lo = (lo / BK) * BK;

  auto visible = [&](int r, int s) {
    const int kp = s + off;
    const int p = qp[r];
    return s < lim && kp <= p && (window < 0 || p - kp < window);
  };
  const size_t kv_row = (size_t)n_kv * HD;
  const T* kb = k + (size_t)b * n_s * kv_row + (size_t)kvh * HD;
  const T* vb = v + (size_t)b * n_s * kv_row + (size_t)kvh * HD;

  float acc[HD / 128][ROWS];
#pragma unroll
  for (int c = 0; c < HD / 128; ++c)
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[c][r] = 0.f;

  for (int key0 = lo; key0 < hi; key0 += BK) {
    load_rows<T, HD>(sm + L::K, L::KS, BK, [&](int j) {
      const int s = key0 + j;
      return s < hi ? kb + (size_t)s * kv_row : (const T*)nullptr;
    }, 1.f);
    load_rows<T, HD>(sm + L::V, HD, BK, [&](int j) {
      const int s = key0 + j;
      return s < hi ? vb + (size_t)s * kv_row : (const T*)nullptr;
    }, 1.f);
    __syncthreads();
    tile_update<HD, ROWS>(sm, R, key0, visible, acc);
  }

  write_rows<HD, ROWS>(sm, R, [&](int r) {
    return out + ((size_t)(b * n_t + t0 + r) * n_h + h) * HD;
  }, acc);
}

// bf16: one block = TQ queries x the G heads of KV head blockIdx.x. Under
// the causal mask a later query block sees more keys, so the grid is
// (KV, ceil(T/TQ), B) and blockIdx.y counts query blocks from the last:
// blocks start in that order, every head's longest first, and the short
// ones fill in behind instead of a long one finishing alone.
template <int HD>
__global__ void __launch_bounds__(tc::THREADS)
flash_fwd_tc_kernel(const tc::bf16* __restrict__ q,
                    const tc::bf16* __restrict__ k,
                    const tc::bf16* __restrict__ v,
                    const int* __restrict__ qpos,
                    const int* __restrict__ kv_len,
                    const int* __restrict__ kv_off,
                    tc::bf16* __restrict__ out, int n_t, int n_s, int n_h,
                    int n_kv, int window, float scale) {
  extern __shared__ __align__(128) unsigned char tc_smem[];
  __shared__ int qp[tc::ROWS];
  const int b = blockIdx.z;
  const int kvh = blockIdx.x;
  const int G = n_h / n_kv;
  const int TQ = tc::ROWS / G;
  const int t0 = (gridDim.y - 1 - blockIdx.y) * TQ;
  const int nt = min(TQ, n_t - t0);     // queries of this block
  const int len = kv_len[b];
  const int off = kv_off[b];
  if (threadIdx.x < nt) qp[threadIdx.x] = qpos[b * n_t + t0 + threadIdx.x];
  __syncthreads();

  int q_lo = qp[0], q_hi = qp[0];
  for (int t = 1; t < nt; ++t) {
    q_lo = min(q_lo, qp[t]);
    q_hi = max(q_hi, qp[t]);
  }
  const int lim = min(n_s, len);
  const int hi = min(lim, q_hi - off + 1);
  int lo = window >= 0 ? max(0, q_lo - off - window + 1) : 0;
  lo = (lo / tc::Cfg<HD>::BN) * tc::Cfg<HD>::BN;

  // the keys each of this thread's rows sees: s < kv_len (and S), s +
  // off <= pos, pos - (s + off) < window, i.e. [pos - off - window + 1,
  // min(lim, pos - off + 1)); nothing for a row without a query
  bool live[2];
  int vis_lo[2], vis_hi[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = tc::my_row(i) / G;
    live[i] = t < nt;
    const int p = live[i] ? qp[t] - off : -1;
    vis_hi[i] = live[i] ? min(lim, p + 1) : 0;
    vis_lo[i] = window >= 0 ? p - window + 1 : 0;
  }
  auto full = [&](int key0) {
    const int key1 = key0 + tc::Cfg<HD>::BN - 1;
    return key1 < lim && key1 + off <= q_lo &&
           (window < 0 || q_hi - (key0 + off) < window);
  };
  const size_t kv_row = (size_t)n_kv * HD;
  const tc::bf16* kb = k + (size_t)b * n_s * kv_row + (size_t)kvh * HD;
  const tc::bf16* vb = v + (size_t)b * n_s * kv_row + (size_t)kvh * HD;
  auto q_row = [&](int r) {
    const int t = r / G;
    return t < nt ? q + ((size_t)(b * n_t + t0 + t) * n_h + kvh * G +
                         (r - t * G)) * HD
                  : (const tc::bf16*)nullptr;
  };

  tc::State<HD> st;
  st.init();
  tc::attend<HD>(tc_smem, q_row, kb, vb, kv_row, lo, hi,
                 [&](int key0) { return kb + (size_t)key0 * kv_row; },
                 vis_lo, vis_hi, full, scale, st);
  st.finish();

  // normalized rows in bf16; a row with l == 0 saw nothing and writes 0
  const int quad = threadIdx.x % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!live[i]) continue;
    const int r = tc::my_row(i);
    const int t = r / G;
    tc::bf16* o = out + ((size_t)(b * n_t + t0 + t) * n_h + kvh * G +
                         (r - t * G)) * HD + 2 * quad;
    const float inv = st.l[i] > 0.f ? 1.f / st.l[i] : 0.f;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d)
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * d) = __floats2bfloat162_rn(
          st.acc[d][2 * i] * inv, st.acc[d][2 * i + 1] * inv);
  }
}

template <int HD>
int launch_tc(const void* q, const void* k, const void* v, const int* qpos,
              const int* kv_len, const int* kv_off, void* out, int n_b,
              int n_t, int n_s, int n_h, int n_kv, int window, float scale,
              cudaStream_t stream) {
  const int G = n_h / n_kv;
  if (G < 1 || G > tc::ROWS) return (int)cudaErrorInvalidValue;
  const int TQ = tc::ROWS / G;
  auto kern = flash_fwd_tc_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      tc::Cfg<HD>::BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n_kv, (n_t + TQ - 1) / TQ, n_b);
  kern<<<grid, tc::THREADS, tc::Cfg<HD>::BYTES, stream>>>(
      (const tc::bf16*)q, (const tc::bf16*)k, (const tc::bf16*)v, qpos,
      kv_len, kv_off, (tc::bf16*)out, n_t, n_s, n_h, n_kv, window, scale);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const int* qpos,
           const int* kv_len, const int* kv_off, void* out, int n_b,
           int n_t, int n_s, int n_h, int n_kv, int window, float scale,
           cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Smem<HD, ROWS>::BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n_t + ROWS - 1) / ROWS, n_h, n_b);
  kern<<<grid, THREADS, Smem<HD, ROWS>::BYTES, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, qpos, kv_len, kv_off, (T*)out,
      n_t, n_s, n_h, n_kv, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (scalar fp32 path), 1 = bfloat16 (tensor cores).
// window < 0 = no sliding window.
// Returns a cudaError_t; nonzero means the kernel did not launch.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const void* qpos, const void* kv_len,
                         const void* kv_off, void* out, int n_b, int n_t,
                         int n_s, int n_h, int n_kv, int head_dim,
                         int window, float scale, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int* qp = (const int*)qpos;
  const int* kl = (const int*)kv_len;
  const int* ko = (const int*)kv_off;
  if (dtype == 0 && head_dim == 128)
    return launch<float, 128>(q, k, v, qp, kl, ko, out, n_b, n_t, n_s, n_h,
                              n_kv, window, scale, st);
  if (dtype == 0 && head_dim == 256)
    return launch<float, 256>(q, k, v, qp, kl, ko, out, n_b, n_t, n_s, n_h,
                              n_kv, window, scale, st);
  if (dtype == 1 && head_dim == 128)
    return launch_tc<128>(q, k, v, qp, kl, ko, out, n_b, n_t, n_s, n_h,
                          n_kv, window, scale, st);
  if (dtype == 1 && head_dim == 256)
    return launch_tc<256>(q, k, v, qp, kl, ko, out, n_b, n_t, n_s, n_h,
                          n_kv, window, scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* qtt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
