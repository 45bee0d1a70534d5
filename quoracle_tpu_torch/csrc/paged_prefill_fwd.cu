// paged_prefill_fwd: the direct tier's prefill piece, a whole suffix chunk
// against the row's resident prefix pages, as unnormalized online-softmax
// partials.
//
// Replaces: quoracle_tpu/ops/paged_attention.py, _paged_prefill_kernel
// (the Pallas TPU kernel behind paged_prefill_attend). Same contract:
// q [B,T,H,hd]; k/v pages [n_pages,page,KV,hd]; tables [B,maxp];
// kv_lens [B] resident prefix tokens. Every pool token precedes every
// chunk token, so prefix key s is visible to chunk query t when
// s < kv_len and, under a window W, kv_len + t - s < W (the row's absolute
// offset cancels). Writes acc [B,T,H,hd], m [B,T,H], l [B,T,H] in fp32
// for every one of the T query rows (padding rows included, as the TPU
// kernel computes its padded chunk); a row that sees no key writes
// (0, NEG_INF, 0) exactly. The engine merges these with the dense
// intra-chunk piece in plain PyTorch.
//
// What bounds it on an H100: each block reads the row's visible prefix
// pages once and does 4·hd FLOPs per (query row, key) pair; with tq·G = 32
// score rows a page byte feeds ~32 FLOPs, far under the ~295 FLOPs per
// byte where the tensor cores would bound it, so the least time is the
// bytes of the prefix pages (read once per KV head) over HBM bandwidth.
// Here, though, the loads are re-read by each of the ceil(T/tq) query
// blocks of the row and the FMAs are scalar fp32, so it runs well above
// that bound.
//
// What the design does about it: the TPU kernel's grid was (B, T/128) and
// carried all KV heads of 128 queries per program, sized for VMEM. Here
// the grid is (B, ceil(T/tq), KV) with tq = 32 / G queries (8 at
// llama-3-8b), so one block's 32 score rows are tq queries times the G
// heads of one KV head and every page read is shared by them; the grid
// has enough blocks (T/8 * KV per row) to fill the card. Rows past T are
// skipped; tiles wholly outside the block's window are not loaded. A
// tensor-core (mma/wgmma) version with split-K over long prefixes is
// later work.
#include "common.cuh"

using namespace qtt;

namespace {

template <typename T, int HD, int ROWS>
__global__ void __launch_bounds__(THREADS)
paged_prefill_fwd_kernel(const T* __restrict__ q,
                         const T* __restrict__ k_pages,
                         const T* __restrict__ v_pages,
                         const int* __restrict__ tables,
                         const int* __restrict__ kv_lens,
                         float* __restrict__ acc_out,
                         float* __restrict__ m_out,
                         float* __restrict__ l_out, int n_t, int tq,
                         int n_h, int n_kv, int page, int maxp, int window,
                         float scale) {
  extern __shared__ __align__(16) float sm[];
  using L = Smem<HD, ROWS>;
  const int b = blockIdx.x;
  const int t0 = blockIdx.y * tq;
  const int kvh = blockIdx.z;
  const int G = n_h / n_kv;
  const int nt = min(tq, n_t - t0);    // query rows of this block
  const int R = nt * G;                // score rows: query-major
  const int kv_len = kv_lens[b];
  const int* table = tables + (size_t)b * maxp;

  // keys [lo, hi): within the table and the prefix; the block's first
  // query sees the window's lowest key (kv_len + t0 - s < W)
  const int hi = min(kv_len, maxp * page);
  int lo = 0;
  if (window >= 0) lo = max(0, kv_len + t0 - window + 1);
  lo = (lo / BK) * BK;

  init_stats<HD, ROWS>(sm);
  load_rows<T, HD>(sm + L::Q, L::QS, R, [&](int r) {
    const int t = r / G;
    const int h = kvh * G + (r - t * G);
    return q + (((size_t)b * n_t + t0 + t) * n_h + h) * HD;
  }, scale);
  __syncthreads();

  auto visible = [&](int r, int s) {
    const int t = t0 + r / G;
    return s < hi && (window < 0 || kv_len + t - s < window);
  };
  const size_t kv_row = (size_t)n_kv * HD;
  auto key_ptr = [&](const T* pages, int s) {
    if (s >= hi) return (const T*)nullptr;
    const int p = s / page;
    const size_t pid = (size_t)table[p];
    return pages + (pid * page + (s - p * page)) * kv_row + (size_t)kvh * HD;
  };

  float acc[HD / 128][ROWS];
#pragma unroll
  for (int c = 0; c < HD / 128; ++c)
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[c][r] = 0.f;

  for (int key0 = lo; key0 < hi; key0 += BK) {
    load_rows<T, HD>(sm + L::K, L::KS, BK,
                     [&](int j) { return key_ptr(k_pages, key0 + j); }, 1.f);
    load_rows<T, HD>(sm + L::V, HD, BK,
                     [&](int j) { return key_ptr(v_pages, key0 + j); }, 1.f);
    __syncthreads();
    tile_update<HD, ROWS>(sm, R, key0, visible, acc);
  }

  auto row_index = [&](int r) {
    const int t = r / G;
    const int h = kvh * G + (r - t * G);
    return ((size_t)b * n_t + t0 + t) * n_h + h;
  };
  write_partials<HD, ROWS>(
      sm, R, [&](int r) { return acc_out + row_index(r) * HD; },
      [&](int r) { return m_out + row_index(r); },
      [&](int r) { return l_out + row_index(r); }, acc);
}

template <typename T, int HD>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const int* tables, const int* kv_lens, float* acc, float* m,
           float* l, int n_rows, int n_t, int tq, int n_h, int n_kv,
           int page, int maxp, int window, float scale,
           cudaStream_t stream) {
  // one 32-row instantiation: tq * G <= 32 is the wrapper's contract
  constexpr int ROWS = 32;
  if (tq * (n_h / n_kv) > ROWS) return (int)cudaErrorInvalidValue;
  auto kern = paged_prefill_fwd_kernel<T, HD, ROWS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Smem<HD, ROWS>::BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n_rows, (n_t + tq - 1) / tq, n_kv);
  kern<<<grid, THREADS, Smem<HD, ROWS>::BYTES, stream>>>(
      (const T*)q, (const T*)k_pages, (const T*)v_pages, tables, kv_lens,
      acc, m, l, n_t, tq, n_h, n_kv, page, maxp, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q and pages); acc/m/l are float32.
// window < 0 = no sliding window. The caller guarantees tq * (H / KV) <=
// 32 and page % 64 == 0. Returns a cudaError_t; nonzero = not launched.
extern "C" int paged_prefill_fwd(const void* q, const void* k_pages,
                                 const void* v_pages, const void* tables,
                                 const void* kv_lens, void* acc, void* m,
                                 void* l, int n_rows, int n_t, int tq,
                                 int n_h, int n_kv, int head_dim, int page,
                                 int maxp, int window, float scale,
                                 int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int* tb = (const int*)tables;
  const int* kl = (const int*)kv_lens;
  float* a = (float*)acc;
  float* mm = (float*)m;
  float* ll = (float*)l;
  if (dtype == 0 && head_dim == 128)
    return launch<float, 128>(q, k_pages, v_pages, tb, kl, a, mm, ll, n_rows,
                              n_t, tq, n_h, n_kv, page, maxp, window, scale,
                              st);
  if (dtype == 0 && head_dim == 256)
    return launch<float, 256>(q, k_pages, v_pages, tb, kl, a, mm, ll, n_rows,
                              n_t, tq, n_h, n_kv, page, maxp, window, scale,
                              st);
  if (dtype == 1 && head_dim == 128)
    return launch<__nv_bfloat16, 128>(q, k_pages, v_pages, tb, kl, a, mm, ll,
                                      n_rows, n_t, tq, n_h, n_kv, page, maxp,
                                      window, scale, st);
  if (dtype == 1 && head_dim == 256)
    return launch<__nv_bfloat16, 256>(q, k_pages, v_pages, tb, kl, a, mm, ll,
                                      n_rows, n_t, tq, n_h, n_kv, page, maxp,
                                      window, scale, st);
  return (int)cudaErrorInvalidValue;
}
