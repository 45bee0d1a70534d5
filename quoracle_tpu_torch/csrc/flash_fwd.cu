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
// What bounds it on an H100: at the main path's shapes (T = 512, hd =
// 128) the attention does ~128 FLOPs per byte of q/k/v/out, below the
// bf16 tensor-core ridge (~295) but far above what fp32 CUDA-core FMAs
// reach, so this first kernel is bound by its own arithmetic: scalar
// fp32 FMAs fed from shared memory, not by HBM.
//
// What the design does about it: each block loads its 32 query rows
// once, streams each key tile through shared memory once for all 32 rows
// (16-byte shared reads, each feeding 4 FMAs per row), and never reads a
// tile that every row of the block masks out: the KV loop runs only over
// [max(0, min_qpos - offset - window + 1), min(S, kv_len, max_qpos -
// offset + 1)), work the TPU kernel does and need not. Ragged T and S are
// masked, never padded by copies. Tensor cores (mma/wgmma), TMA and a
// pipelined tile ring are later work; PERF.md keeps its time beside the
// bound.
#include "common.cuh"

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

// dtype: 0 = float32, 1 = bfloat16. window < 0 = no sliding window.
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
    return launch<__nv_bfloat16, 128>(q, k, v, qp, kl, ko, out, n_b, n_t,
                                      n_s, n_h, n_kv, window, scale, st);
  if (dtype == 1 && head_dim == 256)
    return launch<__nv_bfloat16, 256>(q, k, v, qp, kl, ko, out, n_b, n_t,
                                      n_s, n_h, n_kv, window, scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* qtt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
