// ragged_fwd: unified ragged paged attention over a token-major flat
// batch, for every sessioned prefill chunk (tq = 8) and every decode step
// (tq = 1).
//
// Replaces: quoracle_tpu/ops/paged_attention.py, _ragged_kernel (the
// Pallas TPU kernel behind ragged_attend). Same contract: q [NB*tq,H,hd];
// k/v pages [n_pages,page,KV,hd]; block_tables [NB,maxp];
// block_meta [NB,3] = (kv_len, qpos0, nq). Block i streams only its
// row's visible pages [p_lo, ceil(min(kv_len, qpos0 + nq) / page)), with
// p_lo set by the window, masks s < kv_len, s <= qpos, t < nq and the
// window, and writes the normalized fp32 output (inert blocks, nq = 0,
// and rows t >= nq write 0).
//
// What bounds it on an H100: one grid block per (tq-token block, KV
// head) serves tq * G score rows (32 for llama-3-8b chunks, 4 in
// decode). Decode does ~2 FLOPs per byte of pages it reads, so its least
// time is the bytes of the visible pages over HBM bandwidth; at batch
// 1-4 and a few hundred resident tokens the grid is tiny (NB * KV
// blocks), so it runs latency-bound, well above that bound.
//
// What the design does about it: the block reads its own block_meta row
// and page-table row from global memory (the counterpart of the TPU's
// scalar prefetch), streams exactly the visible pages, one KV head's
// 64-key half page at a time through shared memory, and shares each
// page read among all G query heads of that KV head (GQA), so a page is
// read once per block rather than once per query head. The row count is
// a template argument: decode blocks (tq = 1, 4 rows at llama-3-8b) run
// the 4-row instantiation and spend no cycles on the 28 rows a 32-row
// block would carry; chunk blocks run the 32-row one. Inert blocks skip
// the page loop. Double-buffered page copies (cp.async / TMA) and
// splitting long rows across blocks for decode are later work.
#include "common.cuh"

using namespace qtt;

namespace {

template <typename T, int HD, int ROWS>
__global__ void __launch_bounds__(THREADS)
ragged_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                  const T* __restrict__ v_pages,
                  const int* __restrict__ tables,
                  const int* __restrict__ meta, float* __restrict__ out,
                  int tq, int n_h, int n_kv, int page, int maxp, int window,
                  float scale) {
  extern __shared__ __align__(16) float sm[];
  using L = Smem<HD, ROWS>;
  const int i = blockIdx.x;
  const int kvh = blockIdx.y;
  const int G = n_h / n_kv;
  const int R = tq * G;            // score rows (<= ROWS): query-major
  const int kv_len = meta[i * 3 + 0];
  const int qpos0 = meta[i * 3 + 1];
  const int nq = meta[i * 3 + 2];
  // last visible key + 1: nothing past the block's last query is visible
  const int kv_hi = min(kv_len, qpos0 + nq);
  const int p_lo = window >= 0 ? max(qpos0 + 1 - window, 0) / page : 0;
  const int* table = tables + (size_t)i * maxp;

  init_stats<HD, ROWS>(sm);
  load_rows<T, HD>(sm + L::Q, L::QS, R, [&](int r) {
    const int t = r / G;
    const int h = kvh * G + (r - t * G);
    return q + ((size_t)(i * tq + t) * n_h + h) * HD;
  }, scale);
  __syncthreads();

  auto visible = [&](int r, int s) {
    const int t = r / G;
    const int qpos = qpos0 + t;
    return t < nq && s < kv_len && s <= qpos &&
           (window < 0 || qpos - s < window);
  };
  const size_t kv_row = (size_t)n_kv * HD;
  auto key_ptr = [&](const T* pages, int s) {
    const int p = s / page;
    if (s >= kv_hi || p >= maxp) return (const T*)nullptr;
    const size_t pid = (size_t)table[p];
    return pages + (pid * page + (s - p * page)) * kv_row + (size_t)kvh * HD;
  };

  float acc[HD / 128][ROWS];
#pragma unroll
  for (int c = 0; c < HD / 128; ++c)
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[c][r] = 0.f;

  const int hi = nq > 0 ? kv_hi : 0;      // inert blocks read no page
  for (int key0 = p_lo * page; key0 < hi; key0 += BK) {
    load_rows<T, HD>(sm + L::K, L::KS, BK,
                     [&](int j) { return key_ptr(k_pages, key0 + j); }, 1.f);
    load_rows<T, HD>(sm + L::V, HD, BK,
                     [&](int j) { return key_ptr(v_pages, key0 + j); }, 1.f);
    __syncthreads();
    tile_update<HD, ROWS>(sm, R, key0, visible, acc);
  }

  write_rows<HD, ROWS>(sm, R, [&](int r) {
    const int t = r / G;
    const int h = kvh * G + (r - t * G);
    return out + ((size_t)(i * tq + t) * n_h + h) * HD;
  }, acc);
}

template <typename T, int HD, int ROWS>
int launch_rows(const void* q, const void* k_pages, const void* v_pages,
                const int* tables, const int* meta, float* out,
                int n_blocks, int tq, int n_h, int n_kv, int page, int maxp,
                int window, float scale, cudaStream_t stream) {
  auto kern = ragged_fwd_kernel<T, HD, ROWS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Smem<HD, ROWS>::BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n_blocks, n_kv);
  kern<<<grid, THREADS, Smem<HD, ROWS>::BYTES, stream>>>(
      (const T*)q, (const T*)k_pages, (const T*)v_pages, tables, meta, out,
      tq, n_h, n_kv, page, maxp, window, scale);
  return (int)cudaGetLastError();
}

// 4 score rows cover every decode block of the catalog (tq = 1, G <= 4);
// 32 cover the tq = 8 chunk blocks (G <= 4).
template <typename T, int HD>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const int* tables, const int* meta, float* out, int n_blocks,
           int tq, int n_h, int n_kv, int page, int maxp, int window,
           float scale, cudaStream_t stream) {
  const int rows = tq * (n_h / n_kv);
  if (rows <= 4)
    return launch_rows<T, HD, 4>(q, k_pages, v_pages, tables, meta, out,
                                 n_blocks, tq, n_h, n_kv, page, maxp,
                                 window, scale, stream);
  if (rows <= 32)
    return launch_rows<T, HD, 32>(q, k_pages, v_pages, tables, meta, out,
                                  n_blocks, tq, n_h, n_kv, page, maxp,
                                  window, scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q and pages); out is always float32.
// window < 0 = no sliding window. The caller guarantees tq * (H / KV) <=
// 32 and page % 64 == 0. Returns a cudaError_t; nonzero = not launched.
extern "C" int ragged_fwd(const void* q, const void* k_pages,
                          const void* v_pages, const void* tables,
                          const void* meta, void* out, int n_blocks, int tq,
                          int n_h, int n_kv, int head_dim, int page,
                          int maxp, int window, float scale, int dtype,
                          void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int* tb = (const int*)tables;
  const int* mt = (const int*)meta;
  float* o = (float*)out;
  if (dtype == 0 && head_dim == 128)
    return launch<float, 128>(q, k_pages, v_pages, tb, mt, o, n_blocks, tq,
                              n_h, n_kv, page, maxp, window, scale, st);
  if (dtype == 0 && head_dim == 256)
    return launch<float, 256>(q, k_pages, v_pages, tb, mt, o, n_blocks, tq,
                              n_h, n_kv, page, maxp, window, scale, st);
  if (dtype == 1 && head_dim == 128)
    return launch<__nv_bfloat16, 128>(q, k_pages, v_pages, tb, mt, o,
                                      n_blocks, tq, n_h, n_kv, page, maxp,
                                      window, scale, st);
  if (dtype == 1 && head_dim == 256)
    return launch<__nv_bfloat16, 256>(q, k_pages, v_pages, tb, mt, o,
                                      n_blocks, tq, n_h, n_kv, page, maxp,
                                      window, scale, st);
  return (int)cudaErrorInvalidValue;
}
