// Fused cosine scores + exact top-k for 1:N gallery search.
//
// Replaces the TPU kernels tf_face_toolbox_tpu/ops/pallas_topk.py
// (_kernel, launched by cosine_topk_impl, for an f32 or bf16 store; and
// _kernel_q, launched by cosine_topk_q_impl, for an int8 store). Both
// compute probes (B, D) . store (cap, D)^T, add a per-row bias (-2e9 on
// tombstoned rows), score rows >= n_valid as -2e9, and return the top k
// per probe: scores descending, ties to the smallest row index. The
// (B, cap) score matrix never reaches device memory.
//
// The TPU kernel walks the store in order and carries one running set
// across its sequential grid. CTAs run in parallel here, so the search
// has two stages:
//
// 1. A partial kernel, grid (row slices x probe tiles), keeps sorted
//    per-probe lists of its slice in shared memory and writes them to
//    a workspace. One warp per probe filters a tile's scores against
//    the probe's current k-th best and inserts the few that beat it.
// 2. topk_merge_kernel, one CTA per probe, merges the slices' sorted
//    lists pairwise (each element's rank = its own position + a binary
//    search in the other list) into the final (B, k).
//
// Order everywhere is (score desc, index asc), so ties go to the
// smallest index and the merge is exact. Rows at or beyond the store's
// end never enter a list; masked and tombstoned rows score -2e9, below
// any live row. k is at most 1024 (checked by the wrapper).
//
// f32 and bf16 stores (kernel 3): topk_stream_kernel. What bounds it on
// an H100: device memory at small batches (the store is 4 or 2 bytes a
// value and each value meets few probes), and at 64 probes on an f32
// store the FMA pipe (products must stay exact f32: no TF32). What the
// design does about each:
// - An asynchronous ring of 3-4 stages in shared memory. A stage holds
//   one 128-byte column chunk of 256 store rows and of the probe tile,
//   filled by cp.async (16 bytes a thread, eight threads on each
//   row's contiguous 128 bytes, zero-filled past the row, the store or
//   the batch). Stages t+1 .. t+S-1 stay in flight while chunk t is
//   scored and while a finished tile's scores are selected, so the
//   store stream does not stop for the selection pass.
// - Rows are 144 bytes apart in a stage (128 + 16 of padding), so eight
//   neighbouring rows fall in eight distinct 16-byte bank groups: the
//   f32 row loads and the ldmatrix reads are free of bank conflicts.
// - f32: each thread owns an R-rows x P-probes micro-tile (8 x 8 at 64
//   probes) and reads both operands as float4 from the stage: the probe
//   float4 is one broadcast for the whole warp, so a thread does 16-32
//   FMAs per 16-byte shared load. Each (row, probe) is one fmaf chain
//   over D in index order, across chunks.
// - bf16: each warp scores 32 rows against every probe slot with
//   mma.sync m16n8k16 (f32 accumulate), A from the store rows and B
//   from the probe rows, both by ldmatrix.
// - The probe slots follow the batch (1-8, 16, 32, 64 for f32; 8, 16,
//   32, 64 for bf16), and up to 64 probes share a CTA, so B=1 does B=1's
//   work and B=64 reads the store once.
// The host's launch plan (ops/topk.py launch_plan) sizes probes per
// CTA, slots and stages from one shared-memory budget; run_topk_stream
// recomputes that sum and refuses a plan that disagrees.
//
// int8 store (kernel 4): topk_partial_kernel, unchanged: a CTA
// keeps up to 32 int8 probes in shared memory and streams its slice in
// 64-row tiles; four warps score with mma.sync m16n8k32 s8 -> s32 from
// 16-byte loads straight into registers (within each 64-byte chunk of a
// row the reduction index is permuted alike for both operands), then
// rescale as float(acc) * probe scale * row scale, each product
// rounded, as the plain version does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTileRows = kWarps * 16;  // store rows scored per step
constexpr int kMergeThreads = 256;
constexpr int kMaxK = 1024;
constexpr int kMaxSmem = 232448;
constexpr float kMasked = -2e9f;
constexpr unsigned kFull = 0xffffffffu;

enum Mode { kF32 = 0, kBF16 = 1, kS8 = 2 };

struct TopkParams {
  const unsigned char* store;  // (cap, d) f32 | bf16 | s8
  const float* row_scale;      // (cap,) int8 store only
  const float* bias;           // (cap,) or null
  const unsigned char* probes; // (b, d) in the store's dtype
  const float* probe_scale;    // (b,) int8 store only
  float* part_s;               // (slices, b, k) workspace
  int* part_i;
  int n_valid, cap, d_bytes, b, k, per_cta, slice_rows;
  int probe_stride;            // int8 kernel: probe tile row bytes
  int stages;                  // f32 / bf16 kernel: ring stages
};

// (s1, i1) ranks ahead of (s2, i2): higher score, then smaller index.
__device__ __forceinline__ bool before(float s1, int i1, float s2, int i2) {
  return s1 > s2 || (s1 == s2 && i1 < i2);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Score of probe slot pr against store row `row`, after the bias and
// the n_valid mask (the plain version's order: (acc*ps)*gs, + bias).
template <int MODE, typename Acc>
__device__ __forceinline__ float finish(const TopkParams& p, const float* pscale,
                                        Acc acc, int pr, int row) {
  float v;
  if constexpr (MODE == kS8) {
    const float gs = row < p.cap ? __ldg(p.row_scale + row) : 0.f;
    v = __fmul_rn(__fmul_rn(__int2float_rn((int)acc), pscale[pr]), gs);
  } else {
    v = (float)acc;
  }
  if (row < p.n_valid) {
    if (p.bias != nullptr) v = __fadd_rn(v, __ldg(p.bias + row));
  } else {
    v = kMasked;
  }
  return v;
}

// int8: each warp scores 16 store rows (two n8 tiles) against 16*MT
// probe slots (MT m16 tiles). Per 64-byte chunk of a row, lane (g, q)
// loads bytes [16q, 16q+16) of row g: words 0-1 feed the first mma and
// words 2-3 the second. The probe fragments use the same permutation of
// the reduction index, so the sum is the plain dot.
template <int MT>
__device__ void tile_scores_s8(const TopkParams& p, const unsigned char* ptile,
                               const float* pscale, float* scores, int row0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  int acc[MT][2][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][t][e] = 0;

  const unsigned char* src[2];
  bool ok[2];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int row = row0 + warp * 16 + t * 8 + g;
    ok[t] = row < p.cap;
    src[t] = p.store + (size_t)(ok[t] ? row : 0) * p.d_bytes;
  }
#pragma unroll 4
  for (int c = 0; c < p.d_bytes; c += 64) {
    const int off = c + q * 16;
    const bool in = off < p.d_bytes;
    uint4 bw[2];
#pragma unroll
    for (int t = 0; t < 2; ++t)
      bw[t] = (ok[t] && in) ? __ldg(reinterpret_cast<const uint4*>(src[t] + off))
                            : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const uint4 lo = *reinterpret_cast<const uint4*>(
          ptile + (m * 16 + g) * p.probe_stride + off);
      const uint4 hi = *reinterpret_cast<const uint4*>(
          ptile + (m * 16 + g + 8) * p.probe_stride + off);
      const uint32_t a1[4] = {lo.x, hi.x, lo.y, hi.y};
      const uint32_t a2[4] = {lo.z, hi.z, lo.w, hi.w};
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        mma_s8(acc[m][t], a1, bw[t].x, bw[t].y);
        mma_s8(acc[m][t], a2, bw[t].z, bw[t].w);
      }
    }
  }
  // C fragment: e = 0,1 -> probe slot g, e = 2,3 -> g + 8; column 2q + (e & 1)
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pr = m * 16 + g + (e >> 1) * 8;
        const int col = warp * 16 + t * 8 + 2 * q + (e & 1);
        scores[pr * kTileRows + col] =
            finish<kS8>(p, pscale, acc[m][t][e], pr, row0 + col);
      }
}

// Insert (cs, ci), known to rank ahead of the list's last entry, into a
// sorted list of k entries; the last entry drops out. Whole warp.
__device__ void insert_sorted(float* ls, int* li, int k, float cs, int ci, int lane) {
  int lo = 0, hi = k - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (before(ls[mid], li[mid], cs, ci)) lo = mid + 1;
    else hi = mid;
  }
  const int pos = lo;
  // shift [pos, k-2] up by one, top 32-entry chunk first
  for (int base = ((k - 2) >> 5) << 5; base >= (pos & ~31); base -= 32) {
    const int j = base + lane;
    const bool mv = j >= pos && j <= k - 2;
    float v = 0.f;
    int vi = 0;
    if (mv) {
      v = ls[j];
      vi = li[j];
    }
    __syncwarp();
    if (mv) {
      ls[j + 1] = v;
      li[j + 1] = vi;
    }
    __syncwarp();
  }
  if (lane == 0) {
    ls[pos] = cs;
    li[pos] = ci;
  }
  __syncwarp();
}

// One warp per probe slot: keep the tile's ROWS scores (row stride
// STRIDE floats) that beat the slot's k-th best. After the first k rows
// few do, so the ballot is usually 0.
template <int WARPS, int ROWS, int STRIDE>
__device__ void select_tile(float* ls, int* li, const float* scores, int k,
                            int n_here, int row0, int row_end) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int pr = warp; pr < n_here; pr += WARPS) {
    float* Ls = ls + pr * k;
    int* Li = li + pr * k;
    float bar_s = Ls[k - 1];
    int bar_i = Li[k - 1];
    for (int half = 0; half < ROWS / 32; ++half) {
      const int col = half * 32 + lane;
      const int gi = row0 + col;
      const float s = scores[pr * STRIDE + col];
      unsigned m = __ballot_sync(kFull, gi < row_end && before(s, gi, bar_s, bar_i));
      while (m) {
        const int src = __ffs(m) - 1;
        m &= m - 1;
        const float cs = __shfl_sync(kFull, s, src);
        const int ci = __shfl_sync(kFull, gi, src);
        if (!before(cs, ci, bar_s, bar_i)) continue;  // the bar rose meanwhile
        insert_sorted(Ls, Li, k, cs, ci, lane);
        bar_s = Ls[k - 1];
        bar_i = Li[k - 1];
      }
    }
  }
}

// Each CTA writes its sorted partial lists to the workspace.
__device__ void write_partial(const TopkParams& p, const float* ls, const int* li,
                              int b0, int n_here, int warps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int pr = warp; pr < n_here; pr += warps) {
    const size_t base = ((size_t)blockIdx.x * p.b + b0 + pr) * p.k;
    for (int j = lane; j < p.k; j += 32) {
      p.part_s[base + j] = ls[pr * p.k + j];
      p.part_i[base + j] = li[pr * p.k + j];
    }
  }
}

template <int MT>
__global__ void __launch_bounds__(kThreads) topk_partial_kernel(const TopkParams p) {
  constexpr int PP = 16 * MT;
  extern __shared__ uint4 smem[];
  unsigned char* ptile = reinterpret_cast<unsigned char*>(smem);
  float* pscale = reinterpret_cast<float*>(ptile + PP * p.probe_stride);
  float* scores = pscale + PP;
  float* ls = scores + PP * kTileRows;
  int* li = reinterpret_cast<int*>(ls + p.per_cta * p.k);

  const int b0 = blockIdx.y * p.per_cta;
  const int n_here = min(p.per_cta, p.b - b0);
  const int row_begin = blockIdx.x * p.slice_rows;
  const int row_end = min(row_begin + p.slice_rows, p.cap);

  // probe tile, zero beyond D and beyond the batch
  const int words = p.probe_stride / 16;
  for (int e = threadIdx.x; e < PP * words; e += kThreads) {
    const int pr = e / words, w = e - pr * words;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (pr < n_here && w * 16 < p.d_bytes)
      v = reinterpret_cast<const uint4*>(p.probes + (size_t)(b0 + pr) * p.d_bytes)[w];
    reinterpret_cast<uint4*>(ptile + pr * p.probe_stride)[w] = v;
  }
  for (int pr = threadIdx.x; pr < PP; pr += kThreads)
    pscale[pr] = pr < n_here ? p.probe_scale[b0 + pr] : 0.f;
  for (int e = threadIdx.x; e < p.per_cta * p.k; e += kThreads) {
    ls[e] = -INFINITY;
    li[e] = INT_MAX;
  }
  __syncthreads();

  for (int row0 = row_begin; row0 < row_end; row0 += kTileRows) {
    tile_scores_s8<MT>(p, ptile, pscale, scores, row0);
    __syncthreads();
    select_tile<kWarps, kTileRows, kTileRows>(ls, li, scores, p.k, n_here, row0,
                                              row_end);
    __syncthreads();
  }
  write_partial(p, ls, li, b0, n_here, kWarps);
}

// ---- kernel 3: f32 / bf16 store through the cp.async ring ----

constexpr int kSWarps = 8;
constexpr int kSThreads = kSWarps * 32;
constexpr int kSRows = 256;                  // store rows per tile
constexpr int kChunk = 128;                  // bytes of a row per stage
constexpr int kRowStride = kChunk + 16;      // 144: conflict-free
constexpr int kScoreStride = kSRows + 4;     // floats; bf16 writes
constexpr int kMaxStages = 4;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most stages - 2 groups of this thread are pending
__device__ __forceinline__ void cp_async_wait_ring(int stages) {
  if (stages >= 4) asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else if (stages == 3) asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// Fill one stage with column chunk dc of store rows [row0, row0 + 256)
// and of the CTA's probe slots; zeros past the row, the store and the
// batch. Eight threads cover each row's 128 contiguous bytes.
template <int NS>
__device__ __forceinline__ void fill_stage(const TopkParams& p, unsigned char* stage,
                                           int row0, int dc, int b0, int n_here) {
  const int off0 = dc * kChunk;
  for (int e = threadIdx.x; e < (kSRows + NS) * 8; e += kSThreads) {
    const int r = e >> 3;
    const int off = off0 + (e & 7) * 16;
    const unsigned char* src;
    bool ok;
    if (r < kSRows) {
      ok = row0 + r < p.cap;
      src = p.store + (size_t)(row0 + r) * p.d_bytes + off;
    } else {
      ok = r - kSRows < n_here;
      src = p.probes + (size_t)(b0 + r - kSRows) * p.d_bytes + off;
    }
    ok = ok && off < p.d_bytes;
    cp_async16(stage + r * kRowStride + (e & 7) * 16, ok ? src : p.store, ok ? 16 : 0);
  }
}

// f32 micro-tile: P probes (one broadcast float4 per warp) x R rows
// (32 consecutive rows per load across the warp's lanes).
template <int NS>
struct F32Tile {
  static constexpr int P = NS < 8 ? NS : 8;
  static constexpr int PG = NS / P;              // probe groups
  static constexpr int WR = kSWarps / PG;        // warps per probe group
  static constexpr int R = kSRows / (WR * 32);   // rows per thread
  static_assert(PG * P == NS && WR * PG == kSWarps && R * WR * 32 == kSRows,
                "f32 slots must be 1-8, 16, 32 or 64");
  float acc[R][P];

  __device__ __forceinline__ int pg() const { return (threadIdx.x >> 5) % PG; }
  __device__ __forceinline__ int row(int j) const {
    return ((threadIdx.x >> 5) / PG) * 32 * R + j * 32 + (threadIdx.x & 31);
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < R; ++j)
#pragma unroll
      for (int i = 0; i < P; ++i) acc[j][i] = 0.f;
  }
  // one chunk of 32 values, in index order
  __device__ __forceinline__ void step(const unsigned char* stage) {
    const unsigned char* rows = stage;
    const unsigned char* probes = stage + (kSRows + pg() * P) * kRowStride;
#pragma unroll 2
    for (int kk = 0; kk < kChunk; kk += 16) {
      float4 gv[R];
#pragma unroll
      for (int j = 0; j < R; ++j)
        gv[j] = *reinterpret_cast<const float4*>(rows + row(j) * kRowStride + kk);
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const float4 pv = *reinterpret_cast<const float4*>(probes + i * kRowStride + kk);
#pragma unroll
        for (int j = 0; j < R; ++j) {
          acc[j][i] = fmaf(pv.x, gv[j].x, acc[j][i]);
          acc[j][i] = fmaf(pv.y, gv[j].y, acc[j][i]);
          acc[j][i] = fmaf(pv.z, gv[j].z, acc[j][i]);
          acc[j][i] = fmaf(pv.w, gv[j].w, acc[j][i]);
        }
      }
    }
  }
  __device__ __forceinline__ void store(const TopkParams& p, float* scores, int row0) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int col = row(j);
#pragma unroll
      for (int i = 0; i < P; ++i)
        scores[(pg() * P + i) * kScoreStride + col] =
            finish<kF32>(p, nullptr, acc[j][i], 0, row0 + col);
    }
  }
};

// bf16: warp w scores rows [32w, 32w + 32) (two m16 tiles) against the
// NS probe slots (NS / 8 n8 tiles), mma.sync m16n8k16, A and B by
// ldmatrix from the stage.
template <int NS>
struct BF16Tile {
  static_assert(NS % 8 == 0 && NS <= 64, "bf16 slots must be 8, 16, 32 or 64");
  static constexpr int NT = NS / 8;
  float acc[2][NT][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
  }
  __device__ __forceinline__ void step(const unsigned char* stage) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    // A: lane l addresses row l % 16 of the m16 tile, k half l / 16
    const unsigned char* a_src = stage + (warp * 32 + (lane & 15)) * kRowStride +
                                 (lane >> 4) * 16;
    // B: lane l addresses probe (l / 16) * 8 + l % 8, k half (l / 8) & 1
    // (x2 for one n8 tile: lanes 16-31 mirror 0-15, inside the stage)
    const int bl = NT == 1 ? (lane & 15) : lane;
    const unsigned char* b_src = stage +
        (kSRows + (bl >> 4) * 8 + (bl & 7)) * kRowStride + ((bl >> 3) & 1) * 16;
#pragma unroll
    for (int kk = 0; kk < kChunk; kk += 32) {
      uint32_t a[2][4];
      ldmatrix_x4(a[0], a_src + kk);
      ldmatrix_x4(a[1], a_src + 16 * kRowStride + kk);
      if constexpr (NT == 1) {
        uint32_t b[2];
        ldmatrix_x2(b, b_src + kk);
        mma_bf16(acc[0][0], a[0], b[0], b[1]);
        mma_bf16(acc[1][0], a[1], b[0], b[1]);
      } else {
#pragma unroll
        for (int n = 0; n < NT; n += 2) {
          uint32_t b[4];
          ldmatrix_x4(b, b_src + n * 8 * kRowStride + kk);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            mma_bf16(acc[m][n], a[m], b[0], b[1]);
            mma_bf16(acc[m][n + 1], a[m], b[2], b[3]);
          }
        }
      }
    }
  }
  // C fragment: e = 0,1 -> row g, e = 2,3 -> row g + 8; probe 2q + (e & 1)
  __device__ __forceinline__ void store(const TopkParams& p, float* scores, int row0) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = warp * 32 + m * 16 + g + (e >> 1) * 8;
          scores[(n * 8 + 2 * q + (e & 1)) * kScoreStride + col] =
              finish<kBF16>(p, nullptr, acc[m][n][e], 0, row0 + col);
        }
  }
};

// Stage bytes of the ring for NS probe slots; the plan's budget is
// stages * ring_stage_bytes + score tile + running lists.
__host__ __device__ constexpr int ring_stage_bytes(int ns) {
  return (kSRows + ns) * kRowStride;
}

template <int MODE, int NS>
__global__ void __launch_bounds__(kSThreads, 1) topk_stream_kernel(const TopkParams p) {
  using Tile = typename std::conditional<MODE == kF32, F32Tile<NS>, BF16Tile<NS>>::type;
  extern __shared__ uint4 smem[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(smem);
  float* scores = reinterpret_cast<float*>(ring + p.stages * ring_stage_bytes(NS));
  float* ls = scores + NS * kScoreStride;
  int* li = reinterpret_cast<int*>(ls + p.per_cta * p.k);

  const int b0 = blockIdx.y * p.per_cta;
  const int n_here = min(p.per_cta, p.b - b0);
  const int row_begin = blockIdx.x * p.slice_rows;
  const int row_end = min(row_begin + p.slice_rows, p.cap);
  const int n_dc = (p.d_bytes + kChunk - 1) / kChunk;
  const int total = (row_end - row_begin + kSRows - 1) / kSRows * n_dc;
  const int S = p.stages;

  for (int e = threadIdx.x; e < p.per_cta * p.k; e += kSThreads) {
    ls[e] = -INFINITY;
    li[e] = INT_MAX;
  }
  // prologue: chunks 0 .. S-2 in flight; one commit group per chunk
  for (int c = 0; c < S - 1; ++c) {
    if (c < total)
      fill_stage<NS>(p, ring + c * ring_stage_bytes(NS), row_begin + c / n_dc * kSRows,
                     c % n_dc, b0, n_here);
    cp_async_commit();
  }
  Tile tile;
  tile.zero();
  for (int c = 0; c < total; ++c) {
    cp_async_wait_ring(S);
    // chunk c has landed for every thread, and every thread is done
    // with the stage chunk c - 1 used, which the next fill reuses
    __syncthreads();
    const int nx = c + S - 1;
    if (nx < total)
      fill_stage<NS>(p, ring + (nx % S) * ring_stage_bytes(NS),
                     row_begin + nx / n_dc * kSRows, nx % n_dc, b0, n_here);
    cp_async_commit();
    tile.step(ring + (c % S) * ring_stage_bytes(NS));
    if (c % n_dc == n_dc - 1) {
      const int row0 = row_begin + c / n_dc * kSRows;
      tile.store(p, scores, row0);
      tile.zero();
      __syncthreads();
      // the next tile's scores are written after the next loop-top
      // barrier, so this pass has the score tile to itself
      select_tile<kSWarps, kSRows, kScoreStride>(ls, li, scores, p.k, n_here, row0,
                                                 row_end);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  write_partial(p, ls, li, b0, n_here, kSWarps);
}

// entries of the sorted list (s, i)[0:n] that rank ahead of (cs, ci)
__device__ __forceinline__ int count_before(const float* s, const int* i, int n,
                                            float cs, int ci) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (before(s[mid], i[mid], cs, ci)) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// entries that rank ahead of or equal to (cs, ci)
__device__ __forceinline__ int count_not_after(const float* s, const int* i, int n,
                                               float cs, int ci) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (!before(cs, ci, s[mid], i[mid])) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kMergeThreads)
topk_merge_kernel(const float* part_s, const int* part_i, int slices, int b, int k,
                  float* out_s, int* out_i) {
  extern __shared__ uint4 smem[];
  float* cs = reinterpret_cast<float*>(smem);
  int* ci = reinterpret_cast<int*>(cs + k);
  float* ns = reinterpret_cast<float*>(ci + k);
  int* ni = reinterpret_cast<int*>(ns + k);
  float* ls = reinterpret_cast<float*>(ni + k);
  int* li = reinterpret_cast<int*>(ls + k);
  const int probe = blockIdx.x;
  for (int j = threadIdx.x; j < k; j += kMergeThreads) {
    cs[j] = part_s[(size_t)probe * k + j];
    ci[j] = part_i[(size_t)probe * k + j];
  }
  for (int s = 1; s < slices; ++s) {
    const size_t base = ((size_t)s * b + probe) * k;
    for (int j = threadIdx.x; j < k; j += kMergeThreads) {
      ls[j] = part_s[base + j];
      li[j] = part_i[base + j];
    }
    __syncthreads();
    // stable merge: the running list's entries go ahead of equal ones
    for (int j = threadIdx.x; j < k; j += kMergeThreads) {
      const int r1 = j + count_before(ls, li, k, cs[j], ci[j]);
      if (r1 < k) {
        ns[r1] = cs[j];
        ni[r1] = ci[j];
      }
      const int r2 = j + count_not_after(cs, ci, k, ls[j], li[j]);
      if (r2 < k) {
        ns[r2] = ls[j];
        ni[r2] = li[j];
      }
    }
    __syncthreads();
    float* ts = cs;
    cs = ns;
    ns = ts;
    int* ti = ci;
    ci = ni;
    ni = ti;
  }
  for (int j = threadIdx.x; j < k; j += kMergeThreads) {
    out_s[(size_t)probe * k + j] = cs[j];
    out_i[(size_t)probe * k + j] = ci[j];
  }
}

template <typename Kernel>
int launch(Kernel kern, const TopkParams& p, int threads, int slices, size_t smem,
           cudaStream_t st) {
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_ptiles = (p.b + p.per_cta - 1) / p.per_cta;
  kern<<<dim3(slices, n_ptiles), threads, smem, st>>>(p);
  return (int)cudaGetLastError();
}

// Arguments both partial kernels need; slice_rows a multiple of `tile`.
bool valid_args(const TopkParams& p, int slices, int tile) {
  return p.b > 0 && p.k >= 1 && p.k <= kMaxK && p.cap >= p.k && p.d_bytes > 0 &&
         p.d_bytes % 16 == 0 && p.per_cta >= 1 && p.slice_rows > 0 &&
         p.slice_rows % tile == 0 && slices >= 1 &&
         (long long)slices * p.slice_rows >= p.cap &&
         (long long)(slices - 1) * p.slice_rows < p.cap && p.n_valid >= 0 &&
         p.n_valid <= p.cap && (p.b + p.per_cta - 1) / p.per_cta <= 65535;
}

int merge(const TopkParams& p, int slices, void* out_s, void* out_i, cudaStream_t st) {
  topk_merge_kernel<<<p.b, kMergeThreads, (size_t)p.k * 24, st>>>(
      p.part_s, p.part_i, slices, p.b, p.k, static_cast<float*>(out_s),
      static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}

int run_topk_q(TopkParams p, int mt, int slices, void* out_s, void* out_i, int device,
               void* stream) {
  if (!valid_args(p, slices, kTileRows) || (mt != 1 && mt != 2) || p.per_cta > 16 * mt)
    return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // row stride = 64 (mod 128) bytes: lanes reading rows g and g+1 of the
  // probe tile in one 128-byte phase hit disjoint banks
  p.probe_stride = ((p.d_bytes + 127) / 128) * 128 + 64;
  const size_t pp = 16 * (size_t)mt;
  const size_t smem = pp * p.probe_stride + pp * 4 + pp * kTileRows * 4 +
                      (size_t)p.per_cta * p.k * 8;
  if (smem > (size_t)kMaxSmem) return -2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int status = mt == 1 ? launch(topk_partial_kernel<1>, p, kThreads, slices, smem, st)
                       : launch(topk_partial_kernel<2>, p, kThreads, slices, smem, st);
  if (status != 0) return status;
  return merge(p, slices, out_s, out_i, st);
}

template <int MODE>
int launch_stream(const TopkParams& p, int slots, int slices, size_t smem,
                  cudaStream_t st) {
#define TFFT_SLOTS(NS) \
  case NS: return launch(topk_stream_kernel<MODE, NS>, p, kSThreads, slices, smem, st);
  if constexpr (MODE == kF32) {
    switch (slots) {
      TFFT_SLOTS(1) TFFT_SLOTS(2) TFFT_SLOTS(3) TFFT_SLOTS(4) TFFT_SLOTS(5)
      TFFT_SLOTS(6) TFFT_SLOTS(7) TFFT_SLOTS(8) TFFT_SLOTS(16) TFFT_SLOTS(32)
      TFFT_SLOTS(64)
    }
  } else {
    switch (slots) { TFFT_SLOTS(8) TFFT_SLOTS(16) TFFT_SLOTS(32) TFFT_SLOTS(64) }
  }
#undef TFFT_SLOTS
  return -1;
}

bool valid_slots(int mode, int slots) {
  if (mode == kBF16) return slots == 8 || slots == 16 || slots == 32 || slots == 64;
  return (slots >= 1 && slots <= 8) || slots == 16 || slots == 32 || slots == 64;
}

// -1: arguments the kernel does not take; -2: a plan whose shared-memory
// sum disagrees with smem_bytes or does not fit.
int run_topk_stream(int mode, TopkParams p, int slots, int slices, long long smem_bytes,
                    void* out_s, void* out_i, int device, void* stream) {
  if (!valid_args(p, slices, kSRows) || !valid_slots(mode, slots) || p.per_cta > slots ||
      p.stages < 2 || p.stages > kMaxStages)
    return -1;
  const long long smem = (long long)p.stages * ring_stage_bytes(slots) +
                         (long long)slots * kScoreStride * 4 + (long long)p.per_cta * p.k * 8;
  if (smem != smem_bytes || smem > kMaxSmem) return -2;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int status = mode == kF32 ? launch_stream<kF32>(p, slots, slices, (size_t)smem, st)
                            : launch_stream<kBF16>(p, slots, slices, (size_t)smem, st);
  if (status != 0) return status;
  return merge(p, slices, out_s, out_i, st);
}

}  // namespace

// f32 (store_bf16 = 0) or bf16 store; probes in the store's dtype. The
// plan (per_cta, slots, stages, slice_rows, slices, smem_bytes) comes
// from ops/topk.py launch_plan.
extern "C" int tfft_topk(const void* store, const void* probes, const void* bias, int n_valid,
                         int cap, int d, int b, int k, int per_cta, int slots, int stages,
                         int slice_rows, int slices, int smem_bytes, int store_bf16,
                         void* part_s, void* part_i, void* out_s, void* out_i, int device,
                         void* stream) {
  TopkParams p = {};
  p.store = static_cast<const unsigned char*>(store);
  p.bias = static_cast<const float*>(bias);
  p.probes = static_cast<const unsigned char*>(probes);
  p.part_s = static_cast<float*>(part_s);
  p.part_i = static_cast<int*>(part_i);
  p.n_valid = n_valid;
  p.cap = cap;
  p.d_bytes = d * (store_bf16 ? 2 : 4);
  p.b = b;
  p.k = k;
  p.per_cta = per_cta;
  p.slice_rows = slice_rows;
  p.stages = stages;
  return run_topk_stream(store_bf16 ? kBF16 : kF32, p, slots, slices, smem_bytes, out_s,
                         out_i, device, stream);
}

// int8 store with per-row scales; int8 probes with per-probe scales.
extern "C" int tfft_topk_q(const void* store, const void* row_scale, const void* probes,
                           const void* probe_scale, const void* bias, int n_valid, int cap,
                           int d, int b, int k, int per_cta, int mt, int slice_rows,
                           int slices, void* part_s, void* part_i, void* out_s, void* out_i,
                           int device, void* stream) {
  TopkParams p = {};
  p.store = static_cast<const unsigned char*>(store);
  p.row_scale = static_cast<const float*>(row_scale);
  p.bias = static_cast<const float*>(bias);
  p.probes = static_cast<const unsigned char*>(probes);
  p.probe_scale = static_cast<const float*>(probe_scale);
  p.part_s = static_cast<float*>(part_s);
  p.part_i = static_cast<int*>(part_i);
  p.n_valid = n_valid;
  p.cap = cap;
  p.d_bytes = d;
  p.b = b;
  p.k = k;
  p.per_cta = per_cta;
  p.slice_rows = slice_rows;
  return run_topk_q(p, mt, slices, out_s, out_i, device, stream);
}
