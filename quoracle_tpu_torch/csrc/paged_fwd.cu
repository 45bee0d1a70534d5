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
// bytes over HBM bandwidth. At the consensus round's batch (4 row slots)
// the grid is B * KV = 32 blocks on 132 SMs, each walking its pages
// serially, so it runs latency-bound well above that bound.
//
// What the design does about it: where the TPU kernel ran one program per
// row over all heads (kv heads flattened into lanes for Mosaic's tiling),
// here the grid is (B, KV): a block holds the G = H/KV query heads of one
// KV head (4 score rows at llama-3-8b), so each page is read once per KV
// head and shared by its G heads, and the row count is a template
// argument sized to G. The block reads its own meta and page-table row
// (the counterpart of scalar prefetch) and streams only the tiles that
// hold visible keys: ceil(kv_len / 64) of them, fewer under a window.
// cp.async/TMA double buffering and split-K over long rows are later work.
#include "common.cuh"

using namespace qtt;

namespace {

template <typename T, int HD, int ROWS>
__global__ void __launch_bounds__(THREADS)
paged_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                 const T* __restrict__ v_pages,
                 const int* __restrict__ tables,
                 const int* __restrict__ meta, float* __restrict__ acc_out,
                 float* __restrict__ m_out, float* __restrict__ l_out,
                 int n_h, int n_kv, int page, int maxp, float scale) {
  extern __shared__ __align__(16) float sm[];
  using L = Smem<HD, ROWS>;
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int G = n_h / n_kv;
  const int R = G;                     // score rows: the KV head's q heads
  const int kv_len = meta[b * 4 + 0];
  const int kv_off = meta[b * 4 + 1];
  const int q_pos = meta[b * 4 + 2];
  const int qlo = meta[b * 4 + 3];
  const int* table = tables + (size_t)b * maxp;

  // keys [lo, hi) can be visible: idx < kv_len (within the table),
  // pos <= q_pos, pos > qlo; 64-bit so that qlo = INT32_MIN cannot wrap
  const long long cap = (long long)maxp * page;
  long long hi = kv_len < cap ? kv_len : cap;
  const long long causal_hi = (long long)q_pos - kv_off + 1;
  if (causal_hi < hi) hi = causal_hi;
  long long lo = (long long)qlo - kv_off + 1;
  if (lo < 0) lo = 0;
  lo = (lo / BK) * BK;

  init_stats<HD, ROWS>(sm);
  load_rows<T, HD>(sm + L::Q, L::QS, R, [&](int r) {
    return q + ((size_t)b * n_h + kvh * G + r) * HD;
  }, scale);
  __syncthreads();

  auto visible = [&](int r, int s) {
    const int pos = kv_off + s;
    return s < kv_len && s < cap && pos <= q_pos && pos > qlo;
  };
  const size_t kv_row = (size_t)n_kv * HD;
  auto key_ptr = [&](const T* pages, long long s) {
    if (s >= hi) return (const T*)nullptr;
    const int p = (int)(s / page);
    const size_t pid = (size_t)table[p];
    return pages + (pid * page + (size_t)(s - (long long)p * page)) * kv_row +
           (size_t)kvh * HD;
  };

  float acc[HD / 128][ROWS];
#pragma unroll
  for (int c = 0; c < HD / 128; ++c)
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[c][r] = 0.f;

  for (long long key0 = lo; key0 < hi; key0 += BK) {
    load_rows<T, HD>(sm + L::K, L::KS, BK,
                     [&](int j) { return key_ptr(k_pages, key0 + j); }, 1.f);
    load_rows<T, HD>(sm + L::V, HD, BK,
                     [&](int j) { return key_ptr(v_pages, key0 + j); }, 1.f);
    __syncthreads();
    tile_update<HD, ROWS>(sm, R, (int)key0, visible, acc);
  }

  const size_t row0 = (size_t)b * n_h + kvh * G;
  write_partials<HD, ROWS>(
      sm, R, [&](int r) { return acc_out + (row0 + r) * HD; },
      [&](int r) { return m_out + row0 + r; },
      [&](int r) { return l_out + row0 + r; }, acc);
}

template <typename T, int HD, int ROWS>
int launch_rows(const void* q, const void* k_pages, const void* v_pages,
                const int* tables, const int* meta, float* acc, float* m,
                float* l, int n_rows, int n_h, int n_kv, int page, int maxp,
                float scale, cudaStream_t stream) {
  auto kern = paged_fwd_kernel<T, HD, ROWS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Smem<HD, ROWS>::BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n_rows, n_kv);
  kern<<<grid, THREADS, Smem<HD, ROWS>::BYTES, stream>>>(
      (const T*)q, (const T*)k_pages, (const T*)v_pages, tables, meta, acc,
      m, l, n_h, n_kv, page, maxp, scale);
  return (int)cudaGetLastError();
}

// 4 score rows cover G <= 4 (llama-3-8b, MHA), 8 the G = 8 models, 32
// anything up to the wrapper's limit.
template <typename T, int HD>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const int* tables, const int* meta, float* acc, float* m,
           float* l, int n_rows, int n_h, int n_kv, int page, int maxp,
           float scale, cudaStream_t stream) {
  const int rows = n_h / n_kv;
  if (rows <= 4)
    return launch_rows<T, HD, 4>(q, k_pages, v_pages, tables, meta, acc, m,
                                 l, n_rows, n_h, n_kv, page, maxp, scale,
                                 stream);
  if (rows <= 8)
    return launch_rows<T, HD, 8>(q, k_pages, v_pages, tables, meta, acc, m,
                                 l, n_rows, n_h, n_kv, page, maxp, scale,
                                 stream);
  if (rows <= 32)
    return launch_rows<T, HD, 32>(q, k_pages, v_pages, tables, meta, acc, m,
                                  l, n_rows, n_h, n_kv, page, maxp, scale,
                                  stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q and pages); acc/m/l are float32.
// The caller guarantees H / KV <= 32 and page % 64 == 0. Returns a
// cudaError_t; nonzero = not launched.
extern "C" int paged_fwd(const void* q, const void* k_pages,
                         const void* v_pages, const void* tables,
                         const void* meta, void* acc, void* m, void* l,
                         int n_rows, int n_h, int n_kv, int head_dim,
                         int page, int maxp, float scale, int dtype,
                         void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int* tb = (const int*)tables;
  const int* mt = (const int*)meta;
  float* a = (float*)acc;
  float* mm = (float*)m;
  float* ll = (float*)l;
  if (dtype == 0 && head_dim == 128)
    return launch<float, 128>(q, k_pages, v_pages, tb, mt, a, mm, ll,
                              n_rows, n_h, n_kv, page, maxp, scale, st);
  if (dtype == 0 && head_dim == 256)
    return launch<float, 256>(q, k_pages, v_pages, tb, mt, a, mm, ll,
                              n_rows, n_h, n_kv, page, maxp, scale, st);
  if (dtype == 1 && head_dim == 128)
    return launch<__nv_bfloat16, 128>(q, k_pages, v_pages, tb, mt, a, mm, ll,
                                      n_rows, n_h, n_kv, page, maxp, scale,
                                      st);
  if (dtype == 1 && head_dim == 256)
    return launch<__nv_bfloat16, 256>(q, k_pages, v_pages, tb, mt, a, mm, ll,
                                      n_rows, n_h, n_kv, page, maxp, scale,
                                      st);
  return (int)cudaErrorInvalidValue;
}
