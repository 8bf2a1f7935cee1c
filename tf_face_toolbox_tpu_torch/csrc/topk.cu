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
// 1. topk_partial_kernel, grid (row slices x probe tiles). A CTA keeps
//    its tile of up to 32 probes in shared memory and streams its slice
//    of the store in 64-row tiles. Four warps score a tile (16 rows
//    each): mma.sync m16n8k16 bf16 -> f32 for a bf16 store, m16n8k32
//    s8 -> s32 for int8 (rescaled as float(acc) * probe scale * row
//    scale, each product rounded, as the plain version does), and f32
//    FMAs for an f32 store (f32 products must stay exact: no TF32). The
//    scores land in shared memory; then one warp per probe filters them
//    against the probe's current k-th best and inserts the few that
//    beat it into a sorted list in shared memory. Each CTA writes its
//    sorted partial lists to a workspace.
// 2. topk_merge_kernel, one CTA per probe, merges the slices' sorted
//    lists pairwise (each element's rank = its own position + a binary
//    search in the other list) into the final (B, k).
//
// Order everywhere is (score desc, index asc), so ties go to the
// smallest index and the merge is exact. Rows at or beyond the store's
// end never enter a list; masked and tombstoned rows score -2e9, below
// any live row. k is at most 1024 (checked by the wrapper).
//
// What bounds it on an H100: device memory. The store is read once per
// probe tile (1 B/value int8, 2 bf16, 4 f32), and the products are far
// below the tensor cores' rate at B <= 32 per tile. Gallery fragments
// are 16-byte loads straight from device memory into registers; within
// each 64-byte chunk of a row the reduction index is permuted the same
// way for the probe (A) and store (B) fragments, which lets each lane
// feed two mma's from one load. Not yet done (later work): cp.async or
// TMA pipelining, wgmma, and overlapping selection with the loads.

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
  int n_valid, cap, d_bytes, b, k, per_cta, slice_rows, probe_stride;
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

// bf16 / int8: each warp scores 16 store rows (two n8 tiles) against
// 16*MT probe slots (MT m16 tiles). Per 64-byte chunk of a row, lane
// (g, q) loads bytes [16q, 16q+16) of row g: words 0-1 feed the first
// mma and words 2-3 the second. The probe fragments use the same
// permutation of the reduction index, so the sum is the plain dot.
template <int MODE, int MT>
__device__ void tile_scores_mma(const TopkParams& p, const unsigned char* ptile,
                                const float* pscale, float* scores, int row0) {
  using Acc = typename std::conditional<MODE == kS8, int, float>::type;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  Acc acc[MT][2][4];
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
        if constexpr (MODE == kS8) {
          mma_s8(acc[m][t], a1, bw[t].x, bw[t].y);
          mma_s8(acc[m][t], a2, bw[t].z, bw[t].w);
        } else {
          mma_bf16(acc[m][t], a1, bw[t].x, bw[t].y);
          mma_bf16(acc[m][t], a2, bw[t].z, bw[t].w);
        }
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
            finish<MODE>(p, pscale, acc[m][t][e], pr, row0 + col);
      }
}

// f32: lane (r, h) of a warp scores store row r of the warp's 16 against
// the probe slots 2j + h, in sequential f32 FMAs (exact f32 products).
template <int MT>
__device__ void tile_scores_f32(const TopkParams& p, const unsigned char* ptile,
                                float* scores, int row0) {
  constexpr int NP = 8 * MT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane & 15, h = lane >> 4;
  const int col = warp * 16 + r;
  const int row = row0 + col;
  const bool ok = row < p.cap;
  const float* grow = reinterpret_cast<const float*>(
      p.store + (size_t)(ok ? row : 0) * p.d_bytes);
  const int d = p.d_bytes / 4;
  float acc[NP];
#pragma unroll
  for (int j = 0; j < NP; ++j) acc[j] = 0.f;
#pragma unroll 2
  for (int kk = 0; kk < d; kk += 4) {
    const float4 gv = ok ? __ldg(reinterpret_cast<const float4*>(grow + kk))
                         : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      const float4 pv = *reinterpret_cast<const float4*>(
          ptile + (2 * j + h) * p.probe_stride + kk * 4);
      acc[j] = fmaf(pv.x, gv.x, acc[j]);
      acc[j] = fmaf(pv.y, gv.y, acc[j]);
      acc[j] = fmaf(pv.z, gv.z, acc[j]);
      acc[j] = fmaf(pv.w, gv.w, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    const int pr = 2 * j + h;
    scores[pr * kTileRows + col] = finish<kF32>(p, nullptr, acc[j], pr, row);
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

// One warp per probe slot: keep the tile's scores that beat the slot's
// k-th best. After the first k rows few do, so the ballot is usually 0.
__device__ void select_tile(float* ls, int* li, const float* scores, int k,
                            int n_here, int row0, int row_end) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int pr = warp; pr < n_here; pr += kWarps) {
    float* Ls = ls + pr * k;
    int* Li = li + pr * k;
    float bar_s = Ls[k - 1];
    int bar_i = Li[k - 1];
    for (int half = 0; half < kTileRows / 32; ++half) {
      const int col = half * 32 + lane;
      const int gi = row0 + col;
      const float s = scores[pr * kTileRows + col];
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

template <int MODE, int MT>
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
    pscale[pr] = (MODE == kS8 && pr < n_here) ? p.probe_scale[b0 + pr] : 0.f;
  for (int e = threadIdx.x; e < p.per_cta * p.k; e += kThreads) {
    ls[e] = -INFINITY;
    li[e] = INT_MAX;
  }
  __syncthreads();

  for (int row0 = row_begin; row0 < row_end; row0 += kTileRows) {
    if constexpr (MODE == kF32) tile_scores_f32<MT>(p, ptile, scores, row0);
    else tile_scores_mma<MODE, MT>(p, ptile, pscale, scores, row0);
    __syncthreads();
    select_tile(ls, li, scores, p.k, n_here, row0, row_end);
    __syncthreads();
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int pr = warp; pr < n_here; pr += kWarps) {
    const size_t base = ((size_t)blockIdx.x * p.b + b0 + pr) * p.k;
    for (int j = lane; j < p.k; j += 32) {
      p.part_s[base + j] = ls[pr * p.k + j];
      p.part_i[base + j] = li[pr * p.k + j];
    }
  }
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

template <int MODE, int MT>
int launch_partial(const TopkParams& p, int slices, size_t smem, cudaStream_t st) {
  auto kern = topk_partial_kernel<MODE, MT>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_ptiles = (p.b + p.per_cta - 1) / p.per_cta;
  kern<<<dim3(slices, n_ptiles), kThreads, smem, st>>>(p);
  return (int)cudaGetLastError();
}

int run_topk(int mode, TopkParams p, int mt, int slices, void* out_s, void* out_i,
             int device, void* stream) {
  if (p.b <= 0 || p.k < 1 || p.k > kMaxK || p.cap < p.k || p.d_bytes <= 0 ||
      p.d_bytes % 16 != 0 || (mt != 1 && mt != 2) || p.per_cta < 1 ||
      p.per_cta > 16 * mt || p.slice_rows <= 0 || p.slice_rows % kTileRows != 0 ||
      slices < 1 || (long long)slices * p.slice_rows < p.cap || p.n_valid < 0 ||
      p.n_valid > p.cap || (p.b + p.per_cta - 1) / p.per_cta > 65535)
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
  int status;
  if (mode == kF32) status = mt == 1 ? launch_partial<kF32, 1>(p, slices, smem, st)
                                     : launch_partial<kF32, 2>(p, slices, smem, st);
  else if (mode == kBF16) status = mt == 1 ? launch_partial<kBF16, 1>(p, slices, smem, st)
                                           : launch_partial<kBF16, 2>(p, slices, smem, st);
  else status = mt == 1 ? launch_partial<kS8, 1>(p, slices, smem, st)
                        : launch_partial<kS8, 2>(p, slices, smem, st);
  if (status != 0) return status;
  topk_merge_kernel<<<p.b, kMergeThreads, (size_t)p.k * 24, st>>>(
      p.part_s, p.part_i, slices, p.b, p.k, static_cast<float*>(out_s),
      static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}

}  // namespace

// f32 (store_bf16 = 0) or bf16 store; probes in the store's dtype.
extern "C" int tfft_topk(const void* store, const void* probes, const void* bias, int n_valid,
                         int cap, int d, int b, int k, int per_cta, int mt, int slice_rows,
                         int slices, int store_bf16, void* part_s, void* part_i, void* out_s,
                         void* out_i, int device, void* stream) {
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
  return run_topk(store_bf16 ? kBF16 : kF32, p, mt, slices, out_s, out_i, device, stream);
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
  return run_topk(kS8, p, mt, slices, out_s, out_i, device, stream);
}
