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
// What bounds it on an H100: a block reads the row's visible prefix pages
// of one KV head and does 4·hd FLOPs per (score row, key) pair; at 64
// score rows a page byte feeds ~64 FLOPs, under the ~295 FLOPs per byte
// of the bf16 tensor-core ridge, so the least time is the prefix pages'
// bytes (read once per KV head) over HBM bandwidth. The first version
// (PR 2) ran scalar fp32 FMAs over bf16 tiles widened to fp32, 32 score
// rows a block, and so streamed each prefix through 16 query blocks per
// row at the main path's T = 128.
//
// What the design does about it (bf16, tc_attention.cuh): grid (B,
// ceil(T/TQ), KV) with TQ = 64 / G queries (16 at llama-3-8b), so a block
// holds 64 score rows, tq queries times the G heads of one KV head, and
// every page read feeds all of them; bf16 mma.sync with fp32 sums, K/V in
// bf16 through a 2-stage cp.async ring. A 64-key (hd 256: 32-key) tile
// lies inside one page (the wrapper enforces page % 64 == 0), so a tile
// costs one table read and rows at stride KV·hd. Tiles wholly outside the
// block's window are not loaded; only edge tiles are masked per element.
// fp32 keeps common.cuh's scalar path (32 rows, tq = 32 / G). Split-K
// over long prefixes for short chunks is later work.
#include "common.cuh"
#include "tc_attention.cuh"

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

// bf16: one block = tq chunk queries x the G heads of KV head blockIdx.z
template <int HD>
__global__ void __launch_bounds__(tc::THREADS)
paged_prefill_fwd_tc_kernel(const tc::bf16* __restrict__ q,
                            const tc::bf16* __restrict__ k_pages,
                            const tc::bf16* __restrict__ v_pages,
                            const int* __restrict__ tables,
                            const int* __restrict__ kv_lens,
                            float* __restrict__ acc_out,
                            float* __restrict__ m_out,
                            float* __restrict__ l_out, int n_t, int tq,
                            int n_h, int n_kv, int page, int maxp,
                            int window, float scale) {
  extern __shared__ __align__(128) unsigned char tc_smem[];
  constexpr int BN = tc::Cfg<HD>::BN;
  const int b = blockIdx.x;
  const int t0 = blockIdx.y * tq;
  const int kvh = blockIdx.z;
  const int G = n_h / n_kv;
  const int nt = min(tq, n_t - t0);    // chunk queries of this block
  const int kv_len = kv_lens[b];
  const int* table = tables + (size_t)b * maxp;

  // keys [lo, hi): within the table and the prefix; the block's first
  // query sees the window's lowest key (kv_len + t0 - s < W)
  const int hi = min(kv_len, maxp * page);
  int lo = 0;
  if (window >= 0) lo = max(0, kv_len + t0 - window + 1);
  lo = (lo / BN) * BN;

  // the keys each of this thread's rows sees: s < hi and kv_len + t - s <
  // window, i.e. [kv_len + t - window + 1, hi); nothing for a row past T
  bool live[2];
  int vis_lo[2], vis_hi[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = tc::my_row(i) / G;
    live[i] = t < nt;
    vis_hi[i] = live[i] ? hi : 0;
    vis_lo[i] = window >= 0 ? kv_len + t0 + t - window + 1 : 0;
  }
  const int t_last = t0 + nt - 1;
  auto full = [&](int key0) {
    return key0 + BN <= hi && (window < 0 || kv_len + t_last - key0 < window);
  };
  const size_t kv_row = (size_t)n_kv * HD;
  auto tile_base = [&](int key0) {
    const int p = key0 / page;        // the tile lies inside this page
    return k_pages + ((size_t)table[p] * page + (key0 - p * page)) * kv_row +
           (size_t)kvh * HD;
  };
  auto q_row = [&](int r) {
    const int t = r / G;
    return t < nt ? q + (((size_t)b * n_t + t0 + t) * n_h + kvh * G +
                         (r - t * G)) * HD
                  : (const tc::bf16*)nullptr;
  };

  tc::State<HD> st;
  st.init();
  tc::attend<HD>(tc_smem, q_row, k_pages, v_pages, kv_row, lo, hi,
                 tile_base, vis_lo, vis_hi, full, scale, st);
  st.finish();

  // partials; a row that saw no key writes exactly (0, NEG_INF, 0)
  const int quad = threadIdx.x % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!live[i]) continue;
    const int r = tc::my_row(i);
    const int t = r / G;
    const size_t row = ((size_t)b * n_t + t0 + t) * n_h + kvh * G + (r - t * G);
    const bool seen = st.l[i] > 0.f;
    float* a = acc_out + row * HD + 2 * quad;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d)
      *reinterpret_cast<float2*>(a + 8 * d) =
          seen ? make_float2(st.acc[d][2 * i], st.acc[d][2 * i + 1])
               : make_float2(0.f, 0.f);
    if (quad == 0) {
      m_out[row] = seen ? st.m[i] : NEG_INF;
      l_out[row] = seen ? st.l[i] : 0.f;
    }
  }
}

template <int HD>
int launch_tc(const void* q, const void* k_pages, const void* v_pages,
              const int* tables, const int* kv_lens, float* acc, float* m,
              float* l, int n_rows, int n_t, int tq, int n_h, int n_kv,
              int page, int maxp, int window, float scale,
              cudaStream_t stream) {
  // tq * G <= 64 and page % 64 == 0 are the wrapper's contract
  if (tq < 1 || tq * (n_h / n_kv) > tc::ROWS || page % 64)
    return (int)cudaErrorInvalidValue;
  auto kern = paged_prefill_fwd_tc_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      tc::Cfg<HD>::BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n_rows, (n_t + tq - 1) / tq, n_kv);
  kern<<<grid, tc::THREADS, tc::Cfg<HD>::BYTES, stream>>>(
      (const tc::bf16*)q, (const tc::bf16*)k_pages, (const tc::bf16*)v_pages,
      tables, kv_lens, acc, m, l, n_t, tq, n_h, n_kv, page, maxp, window,
      scale);
  return (int)cudaGetLastError();
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

// dtype: 0 = float32 (scalar path, tq * (H / KV) <= 32), 1 = bfloat16
// (tensor cores, tq * (H / KV) <= 64), for q and pages; acc/m/l are
// float32. window < 0 = no sliding window. The caller guarantees page %
// 64 == 0. Returns a cudaError_t; nonzero = not launched.
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
    return launch_tc<128>(q, k_pages, v_pages, tb, kl, a, mm, ll, n_rows, n_t,
                          tq, n_h, n_kv, page, maxp, window, scale, st);
  if (dtype == 1 && head_dim == 256)
    return launch_tc<256>(q, k_pages, v_pages, tb, kl, a, mm, ll, n_rows, n_t,
                          tq, n_h, n_kv, page, maxp, window, scale, st);
  return (int)cudaErrorInvalidValue;
}
