// Ragged paged attention: slot b carries tq query tokens at global positions
// q_starts[b] + [0, tq) and attends its own KV pages causally, up to
// ctx_lens[b], with an online softmax in f32. Chunked prefill of slots that
// sit at different offsets runs as one launch.
//
// Replaces: paddle_tpu/ops/pallas/paged_attention.py `_ragged_kernel` (called
// from `ragged_paged_attention`). On the TPU the page axis is a sequential
// grid dimension carrying (m, l, acc) in VMEM, and every page of the table is
// DMA'd whether or not it is visible; here the page walk is a loop inside one
// block and stops at the block's causal horizon.
//
// What bounds it on the H100: at the serving path's shape (8 slots, 128-token
// chunks, 32 heads of d = 128, contexts up to 768) the bytes are q, o and the
// live K/V, about 65 MB, over 3.35 TB/s: ~0.02 ms. The flops (4 d per visible
// (row, key) pair, ~5 GFLOP) over 989 TFLOP/s take ~0.005 ms, so bytes bound
// it. This kernel does its arithmetic on CUDA cores in f32 and is limited by
// shuffles and shared-memory traffic, far above that bound; wgmma tiles are
// a later PR's work.
//
// Design: one block per (slot, kv head, tile of 32 query rows of that head's
// group). A group's rows are the rep query heads of the kv head at every
// chunk offset, ordered (offset, head), so a tile covers a contiguous range
// of offsets and its horizon is min(ctx_len, q_start + last offset + 1): keys
// past it are never loaded. The block walks the slot's pages up to that
// horizon and updates its running softmax once per page through
// `ptt::online_softmax_page` (common.cuh), the same routine the decode kernel
// (paged_attention.cu) calls, as the reference's `_ragged_kernel` and
// `_decode_kernel` both update per page. Row r sees the keys of a page up to
// its own position; the others weigh exactly 0, so a row with no visible key
// (an inactive slot, ctx_len 0) emits zeros (l clamped to 1e-30, as in the
// reference). With tq = 1 and q_start = ctx_len - 1 every row sees every key
// below ctx_len, the rows are the rep heads of one offset, and the
// arithmetic is the decode kernel's, bit for bit. Table ids are clamped to
// [0, n_pages). d is any multiple of 16 up to 256.
//
// Two builds, chosen by the wrapper (`paged_route`, as the decode kernel's):
// "direct" (`ragged_kernel`) reads each page's rows from device memory
// inside the per-page step (0.100 ms for the verify pass at the serving
// shape, 8 slots x T = 4, on the H100); "staged" (`ragged_staged_kernel`)
// walks a ring of pages staged in shared memory by TMA, several pages
// ahead (`ptt::PageRing`, common.cuh), and runs the same per-page step on
// the staged rows (0.022 ms). Its tile holds kTile rows (4, 16 or 32, the
// fewest that cover the group's rows: the verify pass at T = 4 is 4 rows
// of one head, or 16 of a GQA group of 4), so its accumulators and shared
// memory follow the rows it has; with 4 or 16 rows the step runs in its
// grouped form (kRowsCT > 0: the logits of (row, token) groups summed by
// `ptt::warp_sum_many`, `warp_sum`'s trees with the shuffles shared; P V
// on quads of outputs). A row's arithmetic depends on neither the tile
// nor the build, so tq = 1 rows and verify rows keep the decode kernel's
// bits.
#include "common.cuh"

namespace {

using ptt::from_f32;
using ptt::kNegInf;
using ptt::to_f32;

constexpr int kThreads = 256;
constexpr int kRows = 32;                          // query rows per block
constexpr int kAcc = kRows * 256 / kThreads;       // outputs per thread: d <= 256

template <typename T>
__global__ void __launch_bounds__(kThreads)
ragged_kernel(const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
              const int* __restrict__ table, const int* __restrict__ ctx_lens,
              const int* __restrict__ q_starts, const int* __restrict__ active,
              T* __restrict__ out, int tq, int h, int h_kv, int d, int p, int n_pages,
              int max_pages, int n_tiles, float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;                 // [kRows][d], pre-scaled
  float* s_s = q_s + kRows * d;      // [kRows][p] logits, then weights
  float* m_s = s_s + kRows * p;      // [kRows] running max
  float* l_s = m_s + kRows;          // [kRows] running sum
  float* a_s = l_s + kRows;          // [kRows] this page's rescale factor

  const int rep = h / h_kv;
  const int tile = blockIdx.x % n_tiles;
  const int g = (blockIdx.x / n_tiles) % h_kv;
  const int b = blockIdx.x / (n_tiles * h_kv);
  const int r0 = tile * kRows;
  const int n_rows = min(kRows, rep * tq - r0);
  const int tid = threadIdx.x;

  const int q_start = q_starts[b];
  int ctx = ctx_lens[b];
  if (active != nullptr && active[b] == 0) ctx = 0;
  ctx = min(ctx, max_pages * p);
  const int n_keys = max(0, min(ctx, q_start + (r0 + n_rows - 1) / rep + 1));

  // row rr of the tile is query offset (r0 + rr) / rep, head g * rep + (r0 + rr) % rep
  for (int e = tid; e < n_rows * d; e += kThreads) {
    const int rr = e / d, f = e % d, r = r0 + rr;
    q_s[e] = to_f32(q[(((size_t)b * tq + r / rep) * h + g * rep + r % rep) * d + f]) * scale;
  }
  for (int r = tid; r < n_rows; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  __syncthreads();

  const size_t tok_stride = (size_t)h_kv * d;
  const int n_pg = (n_keys + p - 1) / p;
  for (int pi = 0; pi < n_pg; ++pi) {
    const int page = min(max(table[(size_t)b * max_pages + pi], 0), n_pages - 1);
    const int valid = min(p, n_keys - pi * p);
    const size_t base = (size_t)page * p * tok_stride + (size_t)g * d;
    const int first = q_start - pi * p + 1;   // keys of this page row 0's offset sees
    // token loops left to the compiler: with 16 outputs per thread,
    // unrolling p.v 8 or 16 deep measured slower on the H100
    ptt::online_softmax_page<kThreads, kAcc, 0, 0>(
        q_s, n_rows, d, kp + base, vp + base, tok_stride, valid,
        [=](int rr) { return first + (r0 + rr) / rep; }, s_s, p, m_s, l_s, a_s, acc);
  }

#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int e = tid + i * kThreads;
    if (e < n_rows * d) {
      const int rr = e / d, f = e % d, r = r0 + rr;
      out[(((size_t)b * tq + r / rep) * h + g * rep + r % rep) * d + f] =
          from_f32<T>(acc[i] / fmaxf(l_s[rr], 1e-30f));
    }
  }
}

// The staged build: the direct kernel's walk over a ring of pages staged
// in shared memory, with tiles of kTile rows (layout: the ring, then q_s
// [kTile][d], s_s [kTile][p], m_s, l_s, a_s [kTile]). kTokG > 0: step 1 in
// groups of kTile rows x kTokG tokens; 0: the per-token loop.
template <typename T, int kTile, int kTokG>
__global__ void __launch_bounds__(kThreads, kTile <= 16 ? 2 : 1)
ragged_staged_kernel(const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap, int use_maps,
                     const T* __restrict__ q, const T* __restrict__ kp,
                     const T* __restrict__ vp, const int* __restrict__ table,
                     const int* __restrict__ ctx_lens, const int* __restrict__ q_starts,
                     const int* __restrict__ active, T* __restrict__ out, int tq, int h,
                     int h_kv, int d, int p, int n_pages, int max_pages, int n_tiles,
                     float scale, int stages) {
  constexpr int kTileAcc = kTile * 256 / kThreads;   // outputs per thread: d <= 256
  extern __shared__ __align__(128) unsigned char staged_smem[];
  const int rep = h / h_kv;
  const int tile = blockIdx.x % n_tiles;
  const int g = (blockIdx.x / n_tiles) % h_kv;
  const int b = blockIdx.x / (n_tiles * h_kv);
  const int r0 = tile * kTile;
  const int n_rows = min(kTile, rep * tq - r0);
  const int tid = threadIdx.x;

  const int q_start = q_starts[b];
  int ctx = ctx_lens[b];
  if (active != nullptr && active[b] == 0) ctx = 0;
  ctx = min(ctx, max_pages * p);
  const int n_keys = max(0, min(ctx, q_start + (r0 + n_rows - 1) / rep + 1));

  // shared memory: the ring (from 128 bytes), its barriers, then q_s
  // [kTile][d] pre-scaled, s_s [kTile][p] logits then weights, m_s, l_s, a_s
  // [kTile] (running max, running sum, this page's rescale factor) and the
  // walk's page ids
  unsigned char* base = staged_smem + ((128u - (ptt::smem_u32(staged_smem) & 127u)) & 127u);
  T* ring_rows = reinterpret_cast<T*>(base);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + (size_t)stages * 2 * p * d * sizeof(T));
  float* q_s = reinterpret_cast<float*>(bars + stages);
  float* s_s = q_s + kTile * d;
  float* m_s = s_s + kTile * p;
  float* l_s = m_s + kTile;
  float* a_s = l_s + kTile;
  int* pid_s = reinterpret_cast<int*>(a_s + kTile);
  const ptt::PageRing<T> ring{ring_rows, bars, kp + (size_t)g * d, vp + (size_t)g * d,
                              use_maps ? &kmap : nullptr, use_maps ? &vmap : nullptr,
                              pid_s, (size_t)h_kv * d, stages, p, d, n_pages, n_keys, g * d};

  // the walk's page ids, read once (an issue then waits on no device load)
  const int n_pg = ring.pages();
  for (int i = tid; i < n_pg; i += kThreads)
    pid_s[i] = min(max(table[(size_t)b * max_pages + i], 0), n_pages - 1);
  ring.init();
  __syncthreads();
  for (int pi = 0; pi < min(stages, n_pg); ++pi) ring.issue(pi);

  for (int e = tid; e < n_rows * d; e += kThreads) {
    const int rr = e / d, f = e % d, r = r0 + rr;
    q_s[e] = to_f32(q[(((size_t)b * tq + r / rep) * h + g * rep + r % rep) * d + f]) * scale;
  }
  for (int r = tid; r < n_rows; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  float acc[kTileAcc];
#pragma unroll
  for (int i = 0; i < kTileAcc; ++i) acc[i] = 0.f;
  __syncthreads();

  for (int pi = 0; pi < n_pg; ++pi) {
    ring.wait(pi);
    const int first = q_start - pi * p + 1;   // keys of this page row 0's offset sees
    ptt::online_softmax_page<kThreads, kTileAcc, 0, 8, kTokG ? kTile : 0,
                             kTokG ? kTokG : 1>(
        q_s, n_rows, d, ring.k(pi), ring.v(pi), (size_t)d, ring.valid(pi),
        [=](int rr) { return first + (r0 + rr) / rep; }, s_s, p, m_s, l_s, a_s, acc);
    // the routine ended on a block barrier: the stage is free
    if (pi + stages < n_pg) ring.issue(pi + stages);
  }

  if constexpr (kTokG > 0) {
    // the routine's quads: acc[4 i + c] is output 4 (u % (d / 4)) + c of
    // tile row u / (d / 4), u = tid + i * kThreads
    const int dq = d >> 2;
#pragma unroll
    for (int i = 0; i < kTileAcc / 4; ++i) {
      const int u = tid + i * kThreads;
      if (u < n_rows * dq) {
        const int rr = u / dq, f = 4 * (u - rr * dq), r = r0 + rr;
        const float l = fmaxf(l_s[rr], 1e-30f);
        T* o = out + (((size_t)b * tq + r / rep) * h + g * rep + r % rep) * d + f;
#pragma unroll
        for (int c = 0; c < 4; ++c) o[c] = from_f32<T>(acc[4 * i + c] / l);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kTileAcc; ++i) {
      const int e = tid + i * kThreads;
      if (e < n_rows * d) {
        const int rr = e / d, f = e % d, r = r0 + rr;
        out[(((size_t)b * tq + r / rep) * h + g * rep + r % rep) * d + f] =
            from_f32<T>(acc[i] / fmaxf(l_s[rr], 1e-30f));
      }
    }
  }
}

template <typename T, int kTile, int kTokG>
cudaError_t launch_staged(const void* q, const void* kp, const void* vp, const int* table,
                          const int* ctx, const int* starts, const int* active, void* out,
                          int b, int tq, int h, int h_kv, int d, int p, int n_pages,
                          int max_pages, float scale, int stages, int device,
                          cudaStream_t s) {
  const int rep = h / h_kv;
  const int n_tiles = (rep * tq + kTile - 1) / kTile;
  // + 128: the ring's start is rounded up to 128 bytes
  const size_t smem = 128 + ptt::PageRing<T>::bytes(stages, p, d) +
                      sizeof(float) * ((size_t)kTile * d + (size_t)kTile * p + 3 * kTile) +
                      sizeof(int) * (size_t)max_pages;
  CUtensorMap kmap{}, vmap{};
  const bool maps = ptt::PageRing<T>::maps_fit(p, d);
  if (maps && !(ptt::pool_map<T>(&kmap, kp, n_pages, p, h_kv, d) &&
                ptt::pool_map<T>(&vmap, vp, n_pages, p, h_kv, d)))
    return cudaErrorInvalidValue;
  auto kernel = ragged_staged_kernel<T, kTile, kTokG>;
  static ptt::SmemOptIn opt_in;
  cudaError_t err = opt_in.allow(kernel, smem, device);
  if (err != cudaSuccess) return err;
  kernel<<<b * h_kv * n_tiles, kThreads, smem, s>>>(
      kmap, vmap, maps ? 1 : 0, static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), table, ctx, starts, active, static_cast<T*>(out), tq, h,
      h_kv, d, p, n_pages, max_pages, n_tiles, scale, stages);
  return cudaSuccess;
}

// the tile by the group's rows (rep * tq): up to 4 rows, groups of 4 rows x
// 8 tokens; up to 16, 16 x 2; more, tiles of 32 rows on the per-token loop
template <typename T>
cudaError_t staged(const void* q, const void* kp, const void* vp, const int* table,
                   const int* ctx, const int* starts, const int* active, void* out, int b,
                   int tq, int h, int h_kv, int d, int p, int n_pages, int max_pages,
                   float scale, int stages, int device, cudaStream_t s) {
  const int rows = (h / h_kv) * tq;
  if (rows <= 4)
    return launch_staged<T, 4, 8>(q, kp, vp, table, ctx, starts, active, out, b, tq, h,
                                  h_kv, d, p, n_pages, max_pages, scale, stages, device, s);
  if (rows <= 16)
    return launch_staged<T, 16, 2>(q, kp, vp, table, ctx, starts, active, out, b, tq, h,
                                   h_kv, d, p, n_pages, max_pages, scale, stages, device, s);
  return launch_staged<T, kRows, 0>(q, kp, vp, table, ctx, starts, active, out, b, tq, h,
                                    h_kv, d, p, n_pages, max_pages, scale, stages, device, s);
}

template <typename T>
cudaError_t launch(const void* q, const void* kp, const void* vp, const int* table,
                   const int* ctx, const int* starts, const int* active, void* out, int b,
                   int tq, int h, int h_kv, int d, int p, int n_pages, int max_pages,
                   float scale, cudaStream_t s) {
  const int rep = h / h_kv;
  const int n_tiles = (rep * tq + kRows - 1) / kRows;
  const size_t smem = sizeof(float) * ((size_t)kRows * d + (size_t)kRows * p + 3 * kRows);
  cudaError_t err = ptt::allow_smem(ragged_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  ragged_kernel<T><<<b * h_kv * n_tiles, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp), table,
      ctx, starts, active, static_cast<T*>(out), tq, h, h_kv, d, p, n_pages, max_pages,
      n_tiles, scale);
  return cudaSuccess;
}

}  // namespace

// q and out: [b, tq, h, d]; pages [n_pages, p, h_kv, d]; table [b, max_pages];
// ctx_lens, q_starts and active [b] int32 (active may be null: every slot
// live). dtype: 0 = float32, 1 = bfloat16 (q, pages and out share it).
// stages: 0 takes the direct build, 2..ptt::kRingMaxStages the staged build
// with a ring of that many pages (the pools then start on 16 bytes).
extern "C" int ptt_ragged_paged_attention(const void* q, const void* k_pages,
                                          const void* v_pages, const void* table,
                                          const void* ctx_lens, const void* q_starts,
                                          const void* active, void* out, int b, int tq,
                                          int h, int h_kv, int d, int p, int n_pages,
                                          int max_pages, float scale, int dtype, int stages,
                                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (h_kv <= 0 || h % h_kv != 0 || d % 16 != 0 || d <= 0 ||
      d > 32 * ptt::kPageMaxDLane || tq <= 0 || p <= 0 || n_pages <= 0 || max_pages <= 0 ||
      (stages != 0 && (stages < 2 || stages > ptt::kRingMaxStages)))
    return (int)cudaErrorInvalidValue;
  if (b == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(table);
  const int* cl = static_cast<const int*>(ctx_lens);
  const int* st = static_cast<const int*>(q_starts);
  const int* ac = static_cast<const int*>(active);
  if (dtype == 1 && stages)
    err = staged<__nv_bfloat16>(q, k_pages, v_pages, tb, cl, st, ac, out, b, tq, h, h_kv, d,
                                p, n_pages, max_pages, scale, stages, device, s);
  else if (dtype == 0 && stages)
    err = staged<float>(q, k_pages, v_pages, tb, cl, st, ac, out, b, tq, h, h_kv, d, p,
                        n_pages, max_pages, scale, stages, device, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(q, k_pages, v_pages, tb, cl, st, ac, out, b, tq, h, h_kv, d,
                                p, n_pages, max_pages, scale, s);
  else if (dtype == 0)
    err = launch<float>(q, k_pages, v_pages, tb, cl, st, ac, out, b, tq, h, h_kv, d, p,
                        n_pages, max_pages, scale, s);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
