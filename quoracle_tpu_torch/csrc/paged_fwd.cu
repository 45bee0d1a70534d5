// paged_fwd: the direct tier's decode piece, one query per row against the
// row's resident pool pages, as unnormalized online-softmax partials.
//
// Replaces: quoracle_tpu/ops/paged_attention.py, _paged_kernel (the
// Pallas TPU kernel behind paged_attend). Same contract: q [B,H,hd];
// k/v pages [n_pages,page,KV,hd]; tables [B,maxp]; meta [B,4] =
// (kv_len, kv_off, q_pos, qlo). Pool index idx sits at absolute position
// pos = kv_off + idx and is visible when idx < kv_len, pos <= q_pos and
// pos > qlo (qlo = q_pos - window, or INT32_MIN). Writes acc [B,H,hd],
// m [B,H], l [B,H] in fp32; a row that sees no key writes (0, NEG_INF, 0)
// exactly. The engine merges these with the dense tail piece (tokens
// generated this call) in plain PyTorch.
//
// What bounds it on an H100: a decode step reads every visible page once
// and does ~2 FLOPs per byte, so its least time is the visible pages'
// bytes over HBM bandwidth (~3 us at the consensus round's 3 rows of
// ~810 keys in bf16). At that batch a grid of one block per (row, KV
// head) is 32 blocks on 132 SMs, each walking ~13 tiles one DRAM round
// trip after another: latency-bound, ~30x above the bound.
//
// What the design does about it: split_kv.cuh's split-K core. The grid is
// (B, KV, S): a block holds the G = H/KV query heads of one KV head (so a
// page is read once per KV head) and one share of the row's visible keys,
// and the S shares' partials merge in a second launch. K/V tiles stream
// through a cp.async ring in the pages' dtype, and a decode block's warps
// each own a quarter of every tile, so the tile loop has no block
// barrier. The block reads its own meta and page-table row (the
// counterpart of scalar prefetch) and works out its visible range [lo,
// hi) on the device; S comes from the host (split_count), which never
// reads kv_len.
#include "split_kv.cuh"

using namespace qtt;

namespace {

template <typename T, int HD, int ROWS>
__global__ void __launch_bounds__(THREADS)
paged_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                 const T* __restrict__ v_pages,
                 const int* __restrict__ tables,
                 const int* __restrict__ meta, int n_h, int n_kv, int page,
                 int maxp, float scale, skv::Out out) {
  extern __shared__ __align__(16) unsigned char sm[];
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int G = n_h / n_kv;
  const int kv_len = meta[b * 4 + 0];
  const int kv_off = meta[b * 4 + 1];
  const int q_pos = meta[b * 4 + 2];
  const int qlo = meta[b * 4 + 3];

  // keys [lo, hi) are visible: idx < kv_len (within the table),
  // pos <= q_pos, pos > qlo; 64-bit so that qlo = INT32_MIN cannot wrap
  long long hi = min((long long)kv_len, (long long)maxp * page);
  hi = min(hi, (long long)q_pos - kv_off + 1);
  hi = max(hi, 0LL);
  long long lo = max((long long)qlo - kv_off + 1, 0LL);
  lo = min(lo, hi);
  const int lo_i = (int)lo;
  const int hi_i = (int)hi;
  const size_t row0 = (size_t)b * n_h + (size_t)kvh * G;
  skv::run_share<T, T, HD, ROWS, false>(
      sm, tables + (size_t)b * maxp, G, lo_i, hi_i,
      [=](int) { return make_int2(lo_i, hi_i); },
      [=](int r) { return q + (row0 + r) * HD; },
      [=](int r) { return row0 + r; }, k_pages, v_pages, nullptr, nullptr,
      n_kv, kvh, page, scale, out);
}

template <typename T, int HD, int ROWS>
int launch_rows(const void* q, const void* k_pages, const void* v_pages,
                const int* tables, const int* meta, const skv::Out& out,
                int n_rows, int n_h, int n_kv, int page, int maxp,
                float scale, int splits, cudaStream_t stream) {
  return skv::launch<T, HD, ROWS, false>(
      paged_fwd_kernel<T, HD, ROWS>, n_rows, n_kv, splits, out, stream,
      (const T*)q, (const T*)k_pages, (const T*)v_pages, tables, meta, n_h,
      n_kv, page, maxp, scale);
}

// 4 score rows cover G <= 4 (llama-3-8b, MHA), 8 the G = 8 models, 32
// anything up to the wrapper's limit.
template <typename T, int HD>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const int* tables, const int* meta, const skv::Out& out,
           int n_rows, int n_h, int n_kv, int page, int maxp, float scale,
           int splits, cudaStream_t stream) {
  const int rows = n_h / n_kv;
  if (rows <= 4)
    return launch_rows<T, HD, 4>(q, k_pages, v_pages, tables, meta, out,
                                 n_rows, n_h, n_kv, page, maxp, scale,
                                 splits, stream);
  if (rows <= 8)
    return launch_rows<T, HD, 8>(q, k_pages, v_pages, tables, meta, out,
                                 n_rows, n_h, n_kv, page, maxp, scale,
                                 splits, stream);
  if (rows <= 32)
    return launch_rows<T, HD, 32>(q, k_pages, v_pages, tables, meta, out,
                                  n_rows, n_h, n_kv, page, maxp, scale,
                                  splits, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q and pages); acc/m/l are float32.
// splits: the share count S; with S > 1, workspace holds
// B * H * S * (head_dim + 2) floats (every share writes its slot, so it
// needs no clearing). The caller guarantees H / KV <= 32 and page % 64
// == 0. Returns a cudaError_t; nonzero = not launched.
extern "C" int paged_fwd(const void* q, const void* k_pages,
                         const void* v_pages, const void* tables,
                         const void* meta, void* acc, void* m, void* l,
                         void* workspace, int n_rows, int n_h, int n_kv,
                         int head_dim, int page, int maxp, int splits,
                         float scale, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int* tb = (const int*)tables;
  const int* mt = (const int*)meta;
  const skv::Out out{(float*)acc, (float*)m, (float*)l, (float*)workspace,
                     n_rows * n_h};
  if (splits > 1 && workspace == nullptr) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && head_dim == 128)
    return launch<float, 128>(q, k_pages, v_pages, tb, mt, out, n_rows, n_h,
                              n_kv, page, maxp, scale, splits, st);
  if (dtype == 0 && head_dim == 256)
    return launch<float, 256>(q, k_pages, v_pages, tb, mt, out, n_rows, n_h,
                              n_kv, page, maxp, scale, splits, st);
  if (dtype == 1 && head_dim == 128)
    return launch<__nv_bfloat16, 128>(q, k_pages, v_pages, tb, mt, out,
                                      n_rows, n_h, n_kv, page, maxp, scale,
                                      splits, st);
  if (dtype == 1 && head_dim == 256)
    return launch<__nv_bfloat16, 256>(q, k_pages, v_pages, tb, mt, out,
                                      n_rows, n_h, n_kv, page, maxp, scale,
                                      splits, st);
  return (int)cudaErrorInvalidValue;
}
