// ragged_q8_fwd: unified ragged paged attention over INT8 pages with one
// fp32 scale per (token, kv-head), for every sessioned prefill chunk
// (tq = 8) and every decode step (tq = 1) of an engine built with
// quantize_kv.
//
// Replaces: quoracle_tpu/ops/paged_attention.py, _ragged_kernel_q8 (the
// Pallas TPU kernel behind ragged_attend(k_scale=, v_scale=)). Same
// contract as ragged_fwd.cu: q [NB*tq,H,hd] fp32 or bf16; k/v pages int8
// [n_pages,page,KV,hd]; k/v scales fp32 [n_pages,KV,page]; block_tables
// [NB,maxp]; block_meta [NB,3] = (kv_len, qpos0, nq). Block i streams
// only its row's visible pages [p_lo, ceil(min(kv_len, qpos0 + nq) /
// page)), masks s < kv_len, s <= qpos, t < nq and the window, and writes
// the normalized fp32 output (inert blocks, nq = 0, and rows t >= nq
// write 0).
//
// Order of the dequantization: the TPU kernel scales score columns by
// K's scale (q.(k s) = (q.k) s) and probability columns by V's scale
// ((p s).v = p.(v s)), because on the TPU a page's [KV, page] scale block
// broadcasts along lanes for free. Here every key row is multiplied by its
// own scale as the 64-key tile is loaded into the fp32 shared tile
// (common.cuh's load_rows_scaled, one scale read per 16-byte chunk of 16
// int8 values): the tile then holds exactly the fp32 values of the plain
// twin's k.float() * scale, so this kernel computes what ragged_fwd
// computes over those values and keeps ragged_fwd's fp32 tolerance. Both
// orders are exact rewrites of the same sums; this one costs one multiply
// per loaded element and needs no change to the shared tile update.
//
// What bounds it on an H100: decode does ~2 FLOPs per byte of pages it
// reads, so its least time is the bytes of the visible pages over HBM
// bandwidth. int8 halves the page bytes (hd int8 values and 4 bytes of
// scale per key, KV head and tensor instead of 2 hd bf16 bytes): at the
// main path's decode inputs (3 rows of ~850 resident keys) the bytes bound
// is about 1.6 us against ragged_fwd's 3.1 us. At batch 1-4 the grid (NB,
// KV) is small and each block walks its row's tiles serially, so, like
// ragged_fwd, it runs latency-bound well above that bound.
//
// What the design does about it: the grid and tiles of ragged_fwd. The
// block reads its own block_meta row and page-table row, streams exactly
// the visible pages one KV head's 64-key half page at a time, and shares
// each page read among the G query heads of that KV head. A tile's scales
// for one KV head are 64 contiguous floats of the page's [KV, page] block.
// The row count is a template argument (4 rows for decode blocks, 32 for
// chunk blocks). Tensor cores (wgmma), TMA double buffering and split-K
// over long rows are later work.
#include "common.cuh"

using namespace qtt;

namespace {

template <typename T, int HD, int ROWS>
__global__ void __launch_bounds__(THREADS)
ragged_q8_fwd_kernel(const T* __restrict__ q,
                     const int8_t* __restrict__ k_pages,
                     const int8_t* __restrict__ v_pages,
                     const float* __restrict__ k_scale,
                     const float* __restrict__ v_scale,
                     const int* __restrict__ tables,
                     const int* __restrict__ meta, float* __restrict__ out,
                     int tq, int n_h, int n_kv, int page, int maxp,
                     int window, float scale) {
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
  // key s of this block's row: its page id, or -1 past the visible keys
  auto page_of = [&](int s) {
    const int p = s / page;
    return (s >= kv_hi || p >= maxp) ? -1 : table[p];
  };
  const size_t kv_row = (size_t)n_kv * HD;
  auto key_ptr = [&](const int8_t* pages, int s) {
    const int pid = page_of(s);
    if (pid < 0) return (const int8_t*)nullptr;
    return pages + ((size_t)pid * page + (s % page)) * kv_row +
           (size_t)kvh * HD;
  };
  // scale of key s for this KV head: [n_pages, KV, page] layout
  auto key_scale = [&](const float* scales, int s) {
    const int pid = page_of(s);
    if (pid < 0) return 0.f;
    return scales[((size_t)pid * n_kv + kvh) * page + (s % page)];
  };

  float acc[HD / 128][ROWS];
#pragma unroll
  for (int c = 0; c < HD / 128; ++c)
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[c][r] = 0.f;

  const int hi = nq > 0 ? kv_hi : 0;      // inert blocks read no page
  for (int key0 = p_lo * page; key0 < hi; key0 += BK) {
    load_rows_scaled<int8_t, HD>(
        sm + L::K, L::KS, BK,
        [&](int j) { return key_ptr(k_pages, key0 + j); },
        [&](int j) { return key_scale(k_scale, key0 + j); });
    load_rows_scaled<int8_t, HD>(
        sm + L::V, HD, BK,
        [&](int j) { return key_ptr(v_pages, key0 + j); },
        [&](int j) { return key_scale(v_scale, key0 + j); });
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
int launch_rows(const void* q, const int8_t* k_pages, const int8_t* v_pages,
                const float* k_scale, const float* v_scale, const int* tables,
                const int* meta, float* out, int n_blocks, int tq, int n_h,
                int n_kv, int page, int maxp, int window, float scale,
                cudaStream_t stream) {
  auto kern = ragged_q8_fwd_kernel<T, HD, ROWS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Smem<HD, ROWS>::BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n_blocks, n_kv);
  kern<<<grid, THREADS, Smem<HD, ROWS>::BYTES, stream>>>(
      (const T*)q, k_pages, v_pages, k_scale, v_scale, tables, meta, out,
      tq, n_h, n_kv, page, maxp, window, scale);
  return (int)cudaGetLastError();
}

// 4 score rows cover every decode block of the catalog (tq = 1, G <= 4);
// 32 cover the tq = 8 chunk blocks (G <= 4).
template <typename T, int HD>
int launch(const void* q, const int8_t* k_pages, const int8_t* v_pages,
           const float* k_scale, const float* v_scale, const int* tables,
           const int* meta, float* out, int n_blocks, int tq, int n_h,
           int n_kv, int page, int maxp, int window, float scale,
           cudaStream_t stream) {
  const int rows = tq * (n_h / n_kv);
  if (rows <= 4)
    return launch_rows<T, HD, 4>(q, k_pages, v_pages, k_scale, v_scale,
                                 tables, meta, out, n_blocks, tq, n_h, n_kv,
                                 page, maxp, window, scale, stream);
  if (rows <= 32)
    return launch_rows<T, HD, 32>(q, k_pages, v_pages, k_scale, v_scale,
                                  tables, meta, out, n_blocks, tq, n_h, n_kv,
                                  page, maxp, window, scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q); pages are int8, scales float32,
// out is always float32. window < 0 = no sliding window. The caller
// guarantees tq * (H / KV) <= 32 and page % 64 == 0. Returns a
// cudaError_t; nonzero = not launched.
extern "C" int ragged_q8_fwd(const void* q, const void* k_pages,
                             const void* v_pages, const void* k_scale,
                             const void* v_scale, const void* tables,
                             const void* meta, void* out, int n_blocks,
                             int tq, int n_h, int n_kv, int head_dim,
                             int page, int maxp, int window, float scale,
                             int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int8_t* kp = (const int8_t*)k_pages;
  const int8_t* vp = (const int8_t*)v_pages;
  const float* ks = (const float*)k_scale;
  const float* vs = (const float*)v_scale;
  const int* tb = (const int*)tables;
  const int* mt = (const int*)meta;
  float* o = (float*)out;
  if (dtype == 0 && head_dim == 128)
    return launch<float, 128>(q, kp, vp, ks, vs, tb, mt, o, n_blocks, tq,
                              n_h, n_kv, page, maxp, window, scale, st);
  if (dtype == 0 && head_dim == 256)
    return launch<float, 256>(q, kp, vp, ks, vs, tb, mt, o, n_blocks, tq,
                              n_h, n_kv, page, maxp, window, scale, st);
  if (dtype == 1 && head_dim == 128)
    return launch<__nv_bfloat16, 128>(q, kp, vp, ks, vs, tb, mt, o,
                                      n_blocks, tq, n_h, n_kv, page, maxp,
                                      window, scale, st);
  if (dtype == 1 && head_dim == 256)
    return launch<__nv_bfloat16, 256>(q, kp, vp, ks, vs, tb, mt, o,
                                      n_blocks, tq, n_h, n_kv, page, maxp,
                                      window, scale, st);
  return (int)cudaErrorInvalidValue;
}
