// ragged_fwd: unified ragged paged attention over a token-major flat
// batch, for every sessioned prefill chunk (tq = 8) and every decode step
// (tq = 1).
//
// Replaces: quoracle_tpu/ops/paged_attention.py, _ragged_kernel (the
// Pallas TPU kernel behind ragged_attend). Same contract: q [NB*tq,H,hd];
// k/v pages [n_pages,page,KV,hd]; block_tables [NB,maxp];
// block_meta [NB,3] = (kv_len, qpos0, nq). Block i sees keys s < kv_len,
// s <= qpos, t < nq and the window, and writes the normalized fp32 output
// (inert blocks, nq = 0, and rows t >= nq write 0).
//
// What bounds it on an H100: decode does ~2 FLOPs per byte of pages it
// reads, so its least time is the bytes of the visible pages over HBM
// bandwidth: ~3 us at the main path's decode tick (3 live rows of ~850
// resident keys in bf16). The first version (PR 1, common.cuh's scalar
// core) ran one block per (block, KV head): 24 live blocks on 132 SMs,
// each walking its row's ~13 tiles with a synchronous load of K, then V,
// then three barrier-separated phases a tile, ~30x above that bound.
//
// What the design does about it: split_kv.cuh's split-K core with pages
// in q's dtype, the block of ragged_q8_fwd.cu without scales
// (skv::ragged_block). The grid is (NB, KV, S): a block serves the tq * G
// score rows of one KV head (a page read once per KV head) over one share
// of the block's visible keys, and the S shares' partials merge, and
// normalize, in a second launch from the same entry point. K/V stream in
// the pages' dtype through a cp.async ring; decode blocks run the
// barrier-free 4- or 8-row loop, chunk blocks the 32-row one. Inert
// blocks read no page.
//
// The math stays scalar fp32, so fp32 and bf16 keep the 1e-5 bar against
// the plain twin. Tensor cores would serve only the 32-row chunk blocks,
// 64 of the main path's 2048 launches, and bf16 P for the P.V product
// would need a looser bar.
#include "split_kv.cuh"

using namespace qtt;

namespace {

template <typename T, int HD, int ROWS>
__global__ void __launch_bounds__(THREADS)
ragged_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                  const T* __restrict__ v_pages,
                  const int* __restrict__ tables,
                  const int* __restrict__ meta, int tq, int n_h, int n_kv,
                  int page, int maxp, int window, float scale,
                  skv::Out out) {
  extern __shared__ __align__(16) unsigned char sm[];
  skv::ragged_block<T, T, HD, ROWS>(sm, q, k_pages, v_pages, nullptr,
                                    nullptr, tables, meta, tq, n_h, n_kv,
                                    page, maxp, window, scale, out);
}

template <typename T, int HD, int ROWS>
int launch_rows(const void* q, const void* k_pages, const void* v_pages,
                const int* tables, const int* meta, const skv::Out& out,
                int n_blocks, int tq, int n_h, int n_kv, int page, int maxp,
                int window, float scale, int splits, cudaStream_t stream) {
  return skv::launch<T, HD, ROWS, true>(
      ragged_fwd_kernel<T, HD, ROWS>, n_blocks, n_kv, splits, out, stream,
      (const T*)q, (const T*)k_pages, (const T*)v_pages, tables, meta, tq,
      n_h, n_kv, page, maxp, window, scale);
}

// 4 score rows cover every decode block of the catalog (tq = 1, G <= 4),
// 8 the G = 8 decode blocks and tq = 8 chunks at G = 1, 32 the tq = 8
// chunk blocks (G <= 4).
template <typename T, int HD>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const int* tables, const int* meta, const skv::Out& out,
           int n_blocks, int tq, int n_h, int n_kv, int page, int maxp,
           int window, float scale, int splits, cudaStream_t stream) {
  const int rows = tq * (n_h / n_kv);
  if (rows <= 4)
    return launch_rows<T, HD, 4>(q, k_pages, v_pages, tables, meta, out,
                                 n_blocks, tq, n_h, n_kv, page, maxp,
                                 window, scale, splits, stream);
  if (rows <= 8)
    return launch_rows<T, HD, 8>(q, k_pages, v_pages, tables, meta, out,
                                 n_blocks, tq, n_h, n_kv, page, maxp,
                                 window, scale, splits, stream);
  if (rows <= 32)
    return launch_rows<T, HD, 32>(q, k_pages, v_pages, tables, meta, out,
                                  n_blocks, tq, n_h, n_kv, page, maxp,
                                  window, scale, splits, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q and pages); out is always float32.
// window < 0 = no sliding window. splits: the share count S; with S > 1,
// workspace holds NB * tq * H * S * (head_dim + 2) floats (every share
// writes its slot, so it needs no clearing). The caller guarantees tq *
// (H / KV) <= 32 and page % 64 == 0. Returns a cudaError_t; nonzero = not
// launched.
extern "C" int ragged_fwd(const void* q, const void* k_pages,
                          const void* v_pages, const void* tables,
                          const void* meta, void* out, void* workspace,
                          int n_blocks, int tq, int n_h, int n_kv,
                          int head_dim, int page, int maxp, int window,
                          int splits, float scale, int dtype,
                          void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int* tb = (const int*)tables;
  const int* mt = (const int*)meta;
  const skv::Out o{(float*)out, nullptr, nullptr, (float*)workspace,
                   n_blocks * tq * n_h};
  if (splits > 1 && workspace == nullptr) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && head_dim == 128)
    return launch<float, 128>(q, k_pages, v_pages, tb, mt, o, n_blocks, tq,
                              n_h, n_kv, page, maxp, window, scale, splits,
                              st);
  if (dtype == 0 && head_dim == 256)
    return launch<float, 256>(q, k_pages, v_pages, tb, mt, o, n_blocks, tq,
                              n_h, n_kv, page, maxp, window, scale, splits,
                              st);
  if (dtype == 1 && head_dim == 128)
    return launch<__nv_bfloat16, 128>(q, k_pages, v_pages, tb, mt, o,
                                      n_blocks, tq, n_h, n_kv, page, maxp,
                                      window, scale, splits, st);
  if (dtype == 1 && head_dim == 256)
    return launch<__nv_bfloat16, 256>(q, k_pages, v_pages, tb, mt, o,
                                      n_blocks, tq, n_h, n_kv, page, maxp,
                                      window, scale, splits, st);
  return (int)cudaErrorInvalidValue;
}
