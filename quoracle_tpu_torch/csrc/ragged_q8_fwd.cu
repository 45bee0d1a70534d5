// ragged_q8_fwd: unified ragged paged attention over INT8 pages with one
// fp32 scale per (token, kv-head), for every sessioned prefill chunk
// (tq = 8) and every decode step (tq = 1) of an engine built with
// quantize_kv.
//
// Replaces: quoracle_tpu/ops/paged_attention.py, _ragged_kernel_q8 (the
// Pallas TPU kernel behind ragged_attend(k_scale=, v_scale=)). Same
// contract as ragged_fwd.cu: q [NB*tq,H,hd] fp32 or bf16; k/v pages int8
// [n_pages,page,KV,hd]; k/v scales fp32 [n_pages,KV,page]; block_tables
// [NB,maxp]; block_meta [NB,3] = (kv_len, qpos0, nq). Block i sees keys
// s < kv_len, s <= qpos, t < nq and the window, and writes the
// normalized fp32 output (inert blocks, nq = 0, and rows t >= nq write
// 0).
//
// Order of the dequantization: the TPU kernel scales score columns by
// K's scale (q.(k s) = (q.k) s) and probability columns by V's scale
// ((p s).v = p.(v s)), because on the TPU a page's [KV, page] scale block
// broadcasts along lanes for free. Here every int8 element becomes the
// fp32 product int8 x its key's scale as it is read from the tile: the
// very values of the plain twin's k.float() * scale, so this kernel keeps
// the fp32 tolerance of the float kernels. Both orders are exact rewrites
// of the same sums.
//
// What bounds it on an H100: decode does ~2 FLOPs per byte of pages it
// reads, so its least time is the bytes of the visible pages over HBM
// bandwidth. int8 halves the page bytes (hd int8 values and 4 bytes of
// scale per key, KV head and tensor instead of 2 hd bf16 bytes): at the
// main path's decode inputs (3 rows of ~850 resident keys) the bytes
// bound is about 1.6 us. With one block per (block, KV head) the grid is
// 24 live blocks on 132 SMs, each walking its row's ~13 tiles one DRAM
// round trip after another: latency-bound, far above that bound.
//
// What the design does about it: split_kv.cuh's split-K core with int8
// pages, the block of ragged_fwd.cu plus the scales (skv::ragged_block).
// The grid is (NB, KV, S): a block serves the tq * G score rows of one KV
// head (4 in decode, 32 in a chunk block; a page read once per KV head)
// over one share of the block's visible keys, and the S shares' partials
// merge, and normalize, in a second launch. The int8 K/V rows and the
// stage's 64 scales per tensor stream through a cp.async ring; decode
// blocks run the barrier-free 4-row loop, chunk blocks the 32-row one.
// Inert blocks read no page.
#include "split_kv.cuh"

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
                     const int* __restrict__ meta, int tq, int n_h,
                     int n_kv, int page, int maxp, int window, float scale,
                     skv::Out out) {
  extern __shared__ __align__(16) unsigned char sm[];
  skv::ragged_block<T, int8_t, HD, ROWS>(sm, q, k_pages, v_pages, k_scale,
                                         v_scale, tables, meta, tq, n_h,
                                         n_kv, page, maxp, window, scale,
                                         out);
}

template <typename T, int HD, int ROWS>
int launch_rows(const void* q, const int8_t* k_pages, const int8_t* v_pages,
                const float* k_scale, const float* v_scale, const int* tables,
                const int* meta, const skv::Out& out, int n_blocks, int tq,
                int n_h, int n_kv, int page, int maxp, int window,
                float scale, int splits, cudaStream_t stream) {
  return skv::launch<int8_t, HD, ROWS, true>(
      ragged_q8_fwd_kernel<T, HD, ROWS>, n_blocks, n_kv, splits, out, stream,
      (const T*)q, k_pages, v_pages, k_scale, v_scale, tables, meta, tq, n_h,
      n_kv, page, maxp, window, scale);
}

// 4 score rows cover every decode block of the catalog (tq = 1, G <= 4),
// 8 the G = 8 decode blocks and tq = 8 chunks at G = 1, 32 the tq = 8
// chunk blocks (G <= 4).
template <typename T, int HD>
int launch(const void* q, const int8_t* k_pages, const int8_t* v_pages,
           const float* k_scale, const float* v_scale, const int* tables,
           const int* meta, const skv::Out& out, int n_blocks, int tq,
           int n_h, int n_kv, int page, int maxp, int window, float scale,
           int splits, cudaStream_t stream) {
  const int rows = tq * (n_h / n_kv);
  if (rows <= 4)
    return launch_rows<T, HD, 4>(q, k_pages, v_pages, k_scale, v_scale,
                                 tables, meta, out, n_blocks, tq, n_h, n_kv,
                                 page, maxp, window, scale, splits, stream);
  if (rows <= 8)
    return launch_rows<T, HD, 8>(q, k_pages, v_pages, k_scale, v_scale,
                                 tables, meta, out, n_blocks, tq, n_h, n_kv,
                                 page, maxp, window, scale, splits, stream);
  if (rows <= 32)
    return launch_rows<T, HD, 32>(q, k_pages, v_pages, k_scale, v_scale,
                                  tables, meta, out, n_blocks, tq, n_h, n_kv,
                                  page, maxp, window, scale, splits, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q); pages are int8, scales float32,
// out is always float32. window < 0 = no sliding window. splits: the
// share count S; with S > 1, workspace holds NB * tq * H * S *
// (head_dim + 2) floats (every share writes its slot, so it needs no
// clearing). The caller guarantees tq * (H / KV) <= 32 and page % 64 ==
// 0. Returns a cudaError_t; nonzero = not launched.
extern "C" int ragged_q8_fwd(const void* q, const void* k_pages,
                             const void* v_pages, const void* k_scale,
                             const void* v_scale, const void* tables,
                             const void* meta, void* out, void* workspace,
                             int n_blocks, int tq, int n_h, int n_kv,
                             int head_dim, int page, int maxp, int window,
                             int splits, float scale, int dtype,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int8_t* kp = (const int8_t*)k_pages;
  const int8_t* vp = (const int8_t*)v_pages;
  const float* ks = (const float*)k_scale;
  const float* vs = (const float*)v_scale;
  const int* tb = (const int*)tables;
  const int* mt = (const int*)meta;
  const skv::Out o{(float*)out, nullptr, nullptr, (float*)workspace,
                   n_blocks * tq * n_h};
  if (splits > 1 && workspace == nullptr) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && head_dim == 128)
    return launch<float, 128>(q, kp, vp, ks, vs, tb, mt, o, n_blocks, tq,
                              n_h, n_kv, page, maxp, window, scale, splits,
                              st);
  if (dtype == 0 && head_dim == 256)
    return launch<float, 256>(q, kp, vp, ks, vs, tb, mt, o, n_blocks, tq,
                              n_h, n_kv, page, maxp, window, scale, splits,
                              st);
  if (dtype == 1 && head_dim == 128)
    return launch<__nv_bfloat16, 128>(q, kp, vp, ks, vs, tb, mt, o,
                                      n_blocks, tq, n_h, n_kv, page, maxp,
                                      window, scale, splits, st);
  if (dtype == 1 && head_dim == 256)
    return launch<__nv_bfloat16, 256>(q, kp, vp, ks, vs, tb, mt, o,
                                      n_blocks, tq, n_h, n_kv, page, maxp,
                                      window, scale, splits, st);
  return (int)cudaErrorInvalidValue;
}
