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
// 1. topk_stream_kernel, grid (row slices x probe tiles), keeps a sorted
//    running list per probe of its slice and leaves it in a (slices, B,
//    k) workspace. One warp per probe filters a tile's scores against
//    the probe's current k-th best and inserts the few that beat it.
//    The lists live in shared memory when the plan fits them there
//    beside the ring (at least min(B, 8) probes a CTA, one a warp), and
//    are copied to the workspace at the end; past that k they live in
//    the CTA's own slice of the workspace from the start.
// 2. topk_merge_kernel, one CTA per probe, merges the slices' sorted
//    lists pairwise (each element's rank = its own position + a binary
//    search in the other list) into the final (B, k): all at once in a
//    tree when every list fits shared memory twice, else one slice at a
//    time (three lists of k in shared memory, or in a global scratch).
//
// Order everywhere is (score desc, index asc), so ties go to the
// smallest index and the merge is exact. Rows at or beyond the store's
// end never enter a list; masked and tombstoned rows score -2e9, below
// any live row. Any k up to the store's rows.
//
// What bounds it on an H100: device memory at small batches (the store
// is 4, 2 or 1 bytes a value and each value meets few probes), and at
// 64 probes on an f32 store the FMA pipe (products must stay exact f32:
// no TF32). What the design does about each:
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
// - bf16 and int8 (kernel 4): each warp scores 32 rows against every
//   probe slot with mma.sync, m16n8k16 bf16 -> f32 or m16n8k32 s8 ->
//   s32, A from the store rows and B from the probe rows, both by
//   ldmatrix. A 128-byte chunk is 64 bf16 or 128 int8 dimensions. int8
//   scores are float(acc) * probe scale * row scale, each product
//   rounded, as the plain version does; the int32 sums are exact in any
//   order, so kernel 4 is bit-equal to its plain version.
// - The probe slots follow the batch (1-8, 16, 32, 64 for f32; 8, 16,
//   32, 64 for bf16 and int8), and up to 64 probes share a CTA, so B=1
//   does B=1's work and B=64 reads the store once.
// - What is left per 256-row tile runs between barriers, while only the
//   ring's loads are in flight, so it is kept short: the tile's row
//   scales and bias arrive with its last chunk (no wait on device
//   memory); the scores are finished in registers, and only the (probe,
//   32-row group) pairs holding a score that beats the probe's bar are
//   flagged, written to the score tile and scanned; for k <= 32 a
//   probe's list sits in its warp's registers during the scan.
// The host's launch plan (ops/topk.py launch_plan) sizes probes per
// CTA, slots, stages and the lists' place from one shared-memory
// budget; run_topk_stream recomputes that sum and refuses a plan that
// disagrees.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kSWarps = 8;
constexpr int kSThreads = kSWarps * 32;
constexpr int kSRows = 256;                  // store rows per tile
constexpr int kChunk = 128;                  // bytes of a row per stage
constexpr int kRowStride = kChunk + 16;      // 144: conflict-free
constexpr int kScoreStride = kSRows + 4;     // floats; mma writes
constexpr int kMaxStages = 4;
constexpr int kMergeThreads = 256;
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
  int stages;                  // ring stages
  int shared_lists;            // 1: lists in shared memory; 0: in part_s / part_i
};

// (s1, i1) ranks ahead of (s2, i2): higher score, then smaller index.
__device__ __forceinline__ bool before(float s1, int i1, float s2, int i2) {
  return s1 > s2 || (s1 == s2 && i1 < i2);
}

// mma.sync, chosen by the accumulator: bf16 x bf16 -> f32 (m16n8k16) or
// s8 x s8 -> s32 (m16n8k32). Both take a 16-row x 32-byte A slab and an
// 8-column x 32-byte B slab in the same registers: lane (g, q) holds
// bytes [4q, 4q + 4) and [16 + 4q, 16 + 4q + 4) of row g (PTX ISA, the
// mma fragment layouts), so one ldmatrix addressing feeds both.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Score of one (probe, store row) pair after the bias and the n_valid
// mask, in the plain version's order: (acc*ps)*gs, + bias. ps and gs are
// the probe and row scales of an int8 store (unused otherwise).
template <int MODE, typename Acc>
__device__ __forceinline__ float finish(const TopkParams& p, Acc acc, float ps, float gs,
                                        float bias, int row) {
  float v;
  if constexpr (MODE == kS8) {
    v = __fmul_rn(__fmul_rn(__int2float_rn((int)acc), ps), gs);
  } else {
    v = (float)acc;
  }
  if (row < p.n_valid) {
    if (p.bias != nullptr) v = __fadd_rn(v, bias);
  } else {
    v = kMasked;
  }
  return v;
}

// A finished score kept in its accumulator register until it is written.
__device__ __forceinline__ void keep(float& a, float v) { a = v; }
__device__ __forceinline__ void keep(int& a, float v) { a = __float_as_int(v); }
__device__ __forceinline__ float kept(float a) { return a; }
__device__ __forceinline__ float kept(int a) { return __int_as_float(a); }

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

// Insert (cs, ci), known to rank ahead of the list's last entry, into a
// sorted list of k entries; the last entry drops out. Whole warp. A
// list that is not full yet ends in (-inf, INT_MAX) entries, which stay
// where they are: only the filled entries at or after the new one move
// up, 128 a round (four loads a lane in flight), the top ones first.
// No row has the index INT_MAX, so a list is full when its last index
// is another, even if its last score is -inf (a -inf bias).
__device__ void insert_sorted(float* ls, int* li, int k, float cs, int ci, int lane) {
  const int pos = count_before(ls, li, k, cs, ci);
  const int top = li[k - 1] == INT_MAX ? count_before(ls, li, k, -INFINITY, INT_MAX) - 1
                                       : k - 2;
  for (int hi = top; hi >= pos; hi -= 128) {
    float v[4];
    int vi[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = hi - u * 32 - lane;
      if (j >= pos) {
        v[u] = ls[j];
        vi[u] = li[j];
      }
    }
    __syncwarp();
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = hi - u * 32 - lane;
      if (j >= pos) {
        ls[j + 1] = v[u];
        li[j + 1] = vi[u];
      }
    }
    __syncwarp();
  }
  if (lane == 0) {
    ls[pos] = cs;
    li[pos] = ci;
  }
  __syncwarp();
}

// One probe's flagged 32-row groups of the score tile (`srow`: its
// row): every score that beats the bar goes to insert(cs, ci), which
// updates the bar. Whole warp.
template <typename Insert>
__device__ __forceinline__ void scan_groups(uint64_t f, const float* srow, int row0,
                                            int row_end, const float& bar_s,
                                            const int& bar_i, Insert insert) {
  const int lane = threadIdx.x & 31;
  for (int grp = 0; grp < kSRows / 32; ++grp) {
    if (((f >> (8 * grp)) & 0xff) == 0) continue;
    const int gi = row0 + grp * 32 + lane;
    const float s = srow[grp * 32 + lane];
    unsigned m = __ballot_sync(kFull, gi < row_end && before(s, gi, bar_s, bar_i));
    while (m) {
      const int src = __ffs(m) - 1;
      m &= m - 1;
      const float cs = __shfl_sync(kFull, s, src);
      const int ci = __shfl_sync(kFull, gi, src);
      if (before(cs, ci, bar_s, bar_i)) insert(cs, ci);  // else the bar rose meanwhile
    }
  }
}

// One warp per probe slot: keep the tile's scores that beat the slot's
// k-th best. After the first k rows few do: the tile's store flagged
// the (probe, 32-row group) pairs that hold a score beating the bar of
// that moment (the bar only rises, so an unflagged group has nothing),
// and only those are scanned. For k <= 32 the list sits in the warp's
// registers for the pass (entry j in lane j): an insert is a ballot
// for its rank and a shuffle up, where insert_sorted is a serial binary
// search and a shift in shared memory (on an H100 at 10^7 rows, B=64,
// k=20, insert_sorted alone took 19% longer for bf16, 28% for int8).
__device__ void select_tile(float* ls, int* li, const float* scores,
                            const unsigned char* flags, int k, int n_here, int row0,
                            int row_end) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int pr = warp; pr < n_here; pr += kSWarps) {
    const uint64_t f = *reinterpret_cast<const uint64_t*>(flags + pr * 8);
    if (f == 0) continue;
    float* Ls = ls + (size_t)pr * k;
    int* Li = li + (size_t)pr * k;
    const float* srow = scores + pr * kScoreStride;
    if (k <= 32) {
      float s_j = lane < k ? Ls[lane] : -INFINITY;
      int i_j = lane < k ? Li[lane] : INT_MAX;
      float bar_s = __shfl_sync(kFull, s_j, k - 1);
      int bar_i = __shfl_sync(kFull, i_j, k - 1);
      scan_groups(f, srow, row0, row_end, bar_s, bar_i, [&](float cs, int ci) {
        const int pos = __popc(__ballot_sync(kFull, lane < k && before(s_j, i_j, cs, ci)));
        const float up_s = __shfl_up_sync(kFull, s_j, 1);
        const int up_i = __shfl_up_sync(kFull, i_j, 1);
        if (lane == pos) {
          s_j = cs;
          i_j = ci;
        } else if (lane > pos) {
          s_j = up_s;
          i_j = up_i;
        }
        bar_s = __shfl_sync(kFull, s_j, k - 1);
        bar_i = __shfl_sync(kFull, i_j, k - 1);
      });
      if (lane < k) {
        Ls[lane] = s_j;
        Li[lane] = i_j;
      }
      __syncwarp();
    } else {
      float bar_s = Ls[k - 1];
      int bar_i = Li[k - 1];
      scan_groups(f, srow, row0, row_end, bar_s, bar_i, [&](float cs, int ci) {
        insert_sorted(Ls, Li, k, cs, ci, lane);
        bar_s = Ls[k - 1];
        bar_i = Li[k - 1];
      });
    }
  }
}

// A CTA whose lists are in shared memory copies them to its slice of
// the workspace.
__device__ void write_partial(const TopkParams& p, const float* ls, const int* li, int b0,
                              int n_here) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int pr = warp; pr < n_here; pr += kSWarps) {
    const size_t base = ((size_t)blockIdx.x * p.b + b0 + pr) * p.k;
    for (int j = lane; j < p.k; j += 32) {
      p.part_s[base + j] = ls[(size_t)pr * p.k + j];
      p.part_i[base + j] = li[(size_t)pr * p.k + j];
    }
  }
}

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
// batch. Eight threads cover each row's 128 contiguous bytes. With the
// tile's last chunk come its 256 row scales (int8) and bias values, so
// that its scores never wait on device memory.
template <int NS>
__device__ __forceinline__ void fill_stage(const TopkParams& p, unsigned char* stage,
                                           int row0, int dc, int n_dc, int b0,
                                           int n_here) {
  if (dc == n_dc - 1) {
    float* side = reinterpret_cast<float*>(stage + (kSRows + NS) * kRowStride);
    for (int e = threadIdx.x; e < kSRows / 2; e += kSThreads) {
      const bool is_bias = e >= kSRows / 4;
      const float* src = is_bias ? p.bias : p.row_scale;
      if (src == nullptr) continue;
      const int r = row0 + (e % (kSRows / 4)) * 4;
      const int bytes = p.cap - r >= 4 ? 16 : max(0, (p.cap - r) * 4);
      cp_async16(side + (is_bias ? kSRows : 0) + (e % (kSRows / 4)) * 4,
                 bytes ? src + r : src, bytes);
    }
  }
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
  // flags[probe][group] = 1 where one of the warp's rows in that 32-row
  // group beats the probe's current bar; only flagged scores reach the
  // score tile (`side`: the tile's staged bias values).
  __device__ __forceinline__ void store(const TopkParams& p, const float*, const float* side,
                                        float* scores, unsigned char* flags, const float* ls,
                                        const int* li, int n_here, int row0, int row_end) {
    const int lane = threadIdx.x & 31;
    float gb[R];
    unsigned hit[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      gb[j] = p.bias != nullptr ? side[kSRows + row(j)] : 0.f;
      hit[j] = 0;
    }
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int pr = pg() * P + i;
      const float bar_s = pr < n_here ? ls[(size_t)pr * p.k + p.k - 1] : INFINITY;
      const int bar_i = pr < n_here ? li[(size_t)pr * p.k + p.k - 1] : 0;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int r = row0 + row(j);
        acc[j][i] = finish<kF32>(p, acc[j][i], 0.f, 0.f, gb[j], r);
        if (r < row_end && before(acc[j][i], r, bar_s, bar_i)) hit[j] |= 1u << i;
      }
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const unsigned m = __reduce_or_sync(kFull, hit[j]);
      if (lane < P) flags[(pg() * P + lane) * 8 + row(j) / 32] = (m >> lane) & 1;
#pragma unroll
      for (int i = 0; i < P; ++i)
        if ((m >> i) & 1) scores[(pg() * P + i) * kScoreStride + row(j)] = acc[j][i];
    }
  }
};

// bf16 and int8: warp w scores rows [32w, 32w + 32) (two m16 tiles)
// against the NS probe slots (NS / 8 n8 tiles), one mma.sync per 32
// bytes of the chunk, A and B by ldmatrix from the stage.
template <int MODE, int NS>
struct MmaTile {
  static_assert(NS % 8 == 0 && NS <= 64, "bf16 and int8 slots must be 8, 16, 32 or 64");
  static constexpr int NT = NS / 8;
  using Acc = typename std::conditional<MODE == kS8, int, float>::type;
  Acc acc[2][NT][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] = Acc(0);
  }
  __device__ __forceinline__ void step(const unsigned char* stage) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    // A: lane l addresses row l % 16 of the m16 tile, 16-byte half l / 16
    const unsigned char* a_src = stage + (warp * 32 + (lane & 15)) * kRowStride +
                                 (lane >> 4) * 16;
    // B: lane l addresses probe (l / 16) * 8 + l % 8, half (l / 8) & 1
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
        mma(acc[0][0], a[0], b[0], b[1]);
        mma(acc[1][0], a[1], b[0], b[1]);
      } else {
#pragma unroll
        for (int n = 0; n < NT; n += 2) {
          uint32_t b[4];
          ldmatrix_x4(b, b_src + n * 8 * kRowStride + kk);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            mma(acc[m][n], a[m], b[0], b[1]);
            mma(acc[m][n + 1], a[m], b[2], b[3]);
          }
        }
      }
    }
  }
  // C fragment: e = 0,1 -> row g, e = 2,3 -> row g + 8; probe 2q + (e & 1).
  // The warp's rows are 32-row group `warp`, so flags[probe][warp] = 1
  // where one of them beats the probe's bar; only flagged probes' scores
  // reach the score tile.
  __device__ __forceinline__ void store(const TopkParams& p, const float* pscale,
                                        const float* side, float* scores,
                                        unsigned char* flags, const float* ls,
                                        const int* li, int n_here, int row0, int row_end) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, q = lane & 3;
    // this thread's four rows (m, h): col = warp * 32 + m * 16 + h * 8 + g,
    // with their staged row scales (int8) and bias values
    float gs[2][2], gb[2][2];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = warp * 32 + m * 16 + h * 8 + g;
        gs[m][h] = MODE == kS8 ? side[col] : 0.f;
        gb[m][h] = p.bias != nullptr ? side[kSRows + col] : 0.f;
      }
    uint32_t mask[2] = {0u, 0u};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {  // probe slot n * 8 + 2q + c: C element e = 2h + c
        const int pr = n * 8 + 2 * q + c;
        const float ps = MODE == kS8 ? pscale[pr] : 0.f;
        const float bar_s = pr < n_here ? ls[(size_t)pr * p.k + p.k - 1] : INFINITY;
        const int bar_i = pr < n_here ? li[(size_t)pr * p.k + p.k - 1] : 0;
        bool hit = false;
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int col = warp * 32 + m * 16 + h * 8 + g;
            const float v =
                finish<MODE>(p, acc[m][n][2 * h + c], ps, gs[m][h], gb[m][h], row0 + col);
            keep(acc[m][n][2 * h + c], v);
            hit |= row0 + col < row_end && before(v, row0 + col, bar_s, bar_i);
          }
        if (hit) mask[n >> 2] |= 1u << (pr & 31);  // pr < 32 exactly when n < 4
      }
    mask[0] = __reduce_or_sync(kFull, mask[0]);
    if (lane < NS) flags[lane * 8 + warp] = (mask[0] >> lane) & 1;
    if constexpr (NS > 32) {
      mask[1] = __reduce_or_sync(kFull, mask[1]);
      flags[(lane + 32) * 8 + warp] = (mask[1] >> lane) & 1;
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (((mask[n >> 2] >> ((n & 3) * 8)) & 0xff) == 0) continue;  // no slot of n8 tile n
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            scores[(n * 8 + 2 * q + c) * kScoreStride + warp * 32 + m * 16 + h * 8 + g] =
                kept(acc[m][n][2 * h + c]);
    }
  }
};

// Stage bytes of the ring for NS probe slots: the rows' and probes'
// chunk, then the tile's row scales and bias (256 f32 each). The plan's
// budget is stages * ring_stage_bytes + score tile + flags (8 bytes a
// slot) + int8 probe scales + the running lists when they are in
// shared memory.
__host__ __device__ constexpr int ring_stage_bytes(int ns) {
  return (kSRows + ns) * kRowStride + 2 * kSRows * 4;
}

template <int MODE, int NS>
__global__ void __launch_bounds__(kSThreads, 1) topk_stream_kernel(const TopkParams p) {
  using Tile =
      typename std::conditional<MODE == kF32, F32Tile<NS>, MmaTile<MODE, NS>>::type;
  extern __shared__ uint4 smem[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(smem);
  float* scores = reinterpret_cast<float*>(ring + p.stages * ring_stage_bytes(NS));
  unsigned char* flags = reinterpret_cast<unsigned char*>(scores + NS * kScoreStride);
  float* pscale = reinterpret_cast<float*>(flags + NS * 8);  // int8: probe scales
  float* ls = pscale + (MODE == kS8 ? NS : 0);
  int* li = reinterpret_cast<int*>(ls + (size_t)p.per_cta * p.k);

  const int b0 = blockIdx.y * p.per_cta;
  const int n_here = min(p.per_cta, p.b - b0);
  const int row_begin = blockIdx.x * p.slice_rows;
  const int row_end = min(row_begin + p.slice_rows, p.cap);
  const int n_dc = (p.d_bytes + kChunk - 1) / kChunk;
  const int total = (row_end - row_begin + kSRows - 1) / kSRows * n_dc;
  const int S = p.stages;

  if (!p.shared_lists) {
    // the lists are this CTA's own slice of the workspace, where the
    // merge reads them
    const size_t base = ((size_t)blockIdx.x * p.b + b0) * p.k;
    ls = p.part_s + base;
    li = p.part_i + base;
  }
  if constexpr (MODE == kS8)
    for (int pr = threadIdx.x; pr < NS; pr += kSThreads)
      pscale[pr] = pr < n_here ? p.probe_scale[b0 + pr] : 0.f;
  for (size_t e = threadIdx.x; e < (size_t)n_here * p.k; e += kSThreads) {
    ls[e] = -INFINITY;
    li[e] = INT_MAX;
  }
  // prologue: chunks 0 .. S-2 in flight; one commit group per chunk
  for (int c = 0; c < S - 1; ++c) {
    if (c < total)
      fill_stage<NS>(p, ring + c * ring_stage_bytes(NS), row_begin + c / n_dc * kSRows,
                     c % n_dc, n_dc, b0, n_here);
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
                     row_begin + nx / n_dc * kSRows, nx % n_dc, n_dc, b0, n_here);
    cp_async_commit();
    unsigned char* stage = ring + (c % S) * ring_stage_bytes(NS);
    tile.step(stage);
    if (c % n_dc == n_dc - 1) {
      const int row0 = row_begin + c / n_dc * kSRows;
      tile.store(p, pscale, reinterpret_cast<const float*>(stage + (kSRows + NS) * kRowStride),
                 scores, flags, ls, li, n_here, row0, row_end);
      tile.zero();
      __syncthreads();
      // the next tile's scores and flags are written after the next
      // loop-top barrier, so this pass has them to itself
      select_tile(ls, li, scores, flags, p.k, n_here, row0, row_end);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  if (p.shared_lists) {
    __syncthreads();
    write_partial(p, ls, li, b0, n_here);
  }
}

// The merge takes every slice's list into shared memory at once when
// two copies of them fit there.
__host__ __device__ constexpr bool tree_merge(int slices, int k) {
  return (long long)slices * k * 16 <= kMaxSmem;
}

// One CTA per probe. Tree merge (tree_merge): all slices' lists load at
// once and merge pairwise in ceil(log2(slices)) rounds, every pair and
// every entry at once. Otherwise the slices fold into a running list
// one at a time; the running, next and incoming lists (k entries each)
// are in shared memory, or in the probe's k x 24 bytes of `scratch`
// when they do not fit there.
__global__ void __launch_bounds__(kMergeThreads)
topk_merge_kernel(const float* part_s, const int* part_i, int slices, int b, int k,
                  int* scratch, float* out_s, int* out_i) {
  extern __shared__ uint4 smem[];
  const int probe = blockIdx.x;
  if (tree_merge(slices, k)) {
    const int all = slices * k;
    float* as = reinterpret_cast<float*>(smem);
    int* ai = reinterpret_cast<int*>(as + all);
    float* bs = reinterpret_cast<float*>(ai + all);
    int* bi = reinterpret_cast<int*>(bs + all);
    for (int e = threadIdx.x; e < all; e += kMergeThreads) {
      const int s = e / k;
      const size_t src = ((size_t)s * b + probe) * k + (e - s * k);
      as[e] = part_s[src];
      ai[e] = part_i[src];
    }
    __syncthreads();
    for (int n = slices; n > 1; n = (n + 1) / 2) {
      // list l's entry j goes to list l / 2 at j + the entries of list
      // l ^ 1 ahead of it (an even list's entries go ahead of equal ones)
      for (int e = threadIdx.x; e < n * k; e += kMergeThreads) {
        const int l = e / k, other = l ^ 1;
        int r = e - l * k;
        if (other < n)
          r += (l & 1) ? count_not_after(as + other * k, ai + other * k, k, as[e], ai[e])
                       : count_before(as + other * k, ai + other * k, k, as[e], ai[e]);
        if (r < k) {
          bs[(l >> 1) * k + r] = as[e];
          bi[(l >> 1) * k + r] = ai[e];
        }
      }
      __syncthreads();
      float* ts = as;
      as = bs;
      bs = ts;
      int* ti = ai;
      ai = bi;
      bi = ti;
    }
    for (int j = threadIdx.x; j < k; j += kMergeThreads) {
      out_s[(size_t)probe * k + j] = as[j];
      out_i[(size_t)probe * k + j] = ai[j];
    }
    return;
  }
  float* cs = scratch != nullptr ? reinterpret_cast<float*>(scratch + (size_t)probe * k * 6)
                                 : reinterpret_cast<float*>(smem);
  int* ci = reinterpret_cast<int*>(cs + k);
  float* ns = reinterpret_cast<float*>(ci + k);
  int* ni = reinterpret_cast<int*>(ns + k);
  float* ls = reinterpret_cast<float*>(ni + k);
  int* li = reinterpret_cast<int*>(ls + k);
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
int launch(Kernel kern, const TopkParams& p, int slices, size_t smem, cudaStream_t st) {
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_ptiles = (p.b + p.per_cta - 1) / p.per_cta;
  kern<<<dim3(slices, n_ptiles), kSThreads, smem, st>>>(p);
  return (int)cudaGetLastError();
}

// Arguments the stream kernel takes; slice_rows a multiple of its tile.
bool valid_args(const TopkParams& p, int slices) {
  return p.b > 0 && p.k >= 1 && p.cap >= p.k && p.d_bytes > 0 && p.d_bytes % 16 == 0 &&
         p.per_cta >= 1 && p.slice_rows > 0 && p.slice_rows % kSRows == 0 && slices >= 1 &&
         (long long)slices * p.slice_rows >= p.cap &&
         (long long)(slices - 1) * p.slice_rows < p.cap && p.n_valid >= 0 &&
         p.n_valid <= p.cap && (p.b + p.per_cta - 1) / p.per_cta <= 65535;
}

int merge(const TopkParams& p, int slices, int* scratch, void* out_s, void* out_i,
          cudaStream_t st) {
  const size_t smem = tree_merge(slices, p.k) ? (size_t)slices * p.k * 16
                      : scratch != nullptr    ? 0
                                              : (size_t)p.k * 24;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        topk_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  topk_merge_kernel<<<p.b, kMergeThreads, smem, st>>>(
      p.part_s, p.part_i, slices, p.b, p.k, scratch, static_cast<float*>(out_s),
      static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}

template <int MODE>
int launch_stream(const TopkParams& p, int slots, int slices, size_t smem,
                  cudaStream_t st) {
#define TFFT_SLOTS(NS) \
  case NS: return launch(topk_stream_kernel<MODE, NS>, p, slices, smem, st);
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
  if (mode != kF32) return slots == 8 || slots == 16 || slots == 32 || slots == 64;
  return (slots >= 1 && slots <= 8) || slots == 16 || slots == 32 || slots == 64;
}

// -1: arguments the kernels do not take; -2: a plan whose shared-memory
// sum or merge scratch disagrees with the arguments, or does not fit.
int run_topk_stream(int mode, TopkParams p, int slots, int slices, long long smem_bytes,
                    void* merge_scratch, void* out_s, void* out_i, int device, void* stream) {
  if (!valid_args(p, slices) || !valid_slots(mode, slots) || p.per_cta > slots ||
      p.stages < 2 || p.stages > kMaxStages ||
      (mode == kS8 && (p.row_scale == nullptr || p.probe_scale == nullptr)))
    return -1;
  const long long smem = (long long)p.stages * ring_stage_bytes(slots) +
                         (long long)slots * (kScoreStride * 4 + 8) +
                         (mode == kS8 ? slots * 4 : 0) +
                         (p.shared_lists ? (long long)p.per_cta * p.k * 8 : 0);
  if (smem != smem_bytes || smem > kMaxSmem) return -2;
  if ((!tree_merge(slices, p.k) && (long long)p.k * 24 > kMaxSmem) !=
      (merge_scratch != nullptr))
    return -2;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int status = mode == kF32    ? launch_stream<kF32>(p, slots, slices, (size_t)smem, st)
               : mode == kBF16 ? launch_stream<kBF16>(p, slots, slices, (size_t)smem, st)
                               : launch_stream<kS8>(p, slots, slices, (size_t)smem, st);
  if (status != 0) return status;
  return merge(p, slices, static_cast<int*>(merge_scratch), out_s, out_i, st);
}

TopkParams make_params(const void* store, const void* probes, const void* bias, int n_valid,
                       int cap, int d_bytes, int b, int k, int per_cta, int stages,
                       int slice_rows, int shared_lists, void* part_s, void* part_i) {
  TopkParams p = {};
  p.store = static_cast<const unsigned char*>(store);
  p.bias = static_cast<const float*>(bias);
  p.probes = static_cast<const unsigned char*>(probes);
  p.part_s = static_cast<float*>(part_s);
  p.part_i = static_cast<int*>(part_i);
  p.n_valid = n_valid;
  p.cap = cap;
  p.d_bytes = d_bytes;
  p.b = b;
  p.k = k;
  p.per_cta = per_cta;
  p.slice_rows = slice_rows;
  p.stages = stages;
  p.shared_lists = shared_lists;
  return p;
}

}  // namespace

// f32 (store_bf16 = 0) or bf16 store; probes in the store's dtype. The
// plan (per_cta, slots, stages, slice_rows, slices, smem_bytes,
// shared_lists) comes from ops/topk.py launch_plan; merge_scratch is
// (b, 6k) int32 when k x 24 bytes exceed shared memory, else null.
extern "C" int tfft_topk(const void* store, const void* probes, const void* bias, int n_valid,
                         int cap, int d, int b, int k, int store_bf16, int per_cta, int slots,
                         int stages, int slice_rows, int slices, int smem_bytes,
                         int shared_lists, void* part_s, void* part_i, void* merge_scratch,
                         void* out_s, void* out_i, int device, void* stream) {
  TopkParams p = make_params(store, probes, bias, n_valid, cap, d * (store_bf16 ? 2 : 4), b, k,
                             per_cta, stages, slice_rows, shared_lists, part_s, part_i);
  return run_topk_stream(store_bf16 ? kBF16 : kF32, p, slots, slices, smem_bytes,
                         merge_scratch, out_s, out_i, device, stream);
}

// int8 store with per-row scales; int8 probes with per-probe scales.
// The same plan arguments as tfft_topk.
extern "C" int tfft_topk_q(const void* store, const void* row_scale, const void* probes,
                           const void* probe_scale, const void* bias, int n_valid, int cap,
                           int d, int b, int k, int per_cta, int slots, int stages,
                           int slice_rows, int slices, int smem_bytes, int shared_lists,
                           void* part_s, void* part_i, void* merge_scratch, void* out_s,
                           void* out_i, int device, void* stream) {
  TopkParams p = make_params(store, probes, bias, n_valid, cap, d, b, k, per_cta, stages,
                             slice_rows, shared_lists, part_s, part_i);
  p.row_scale = static_cast<const float*>(row_scale);
  p.probe_scale = static_cast<const float*>(probe_scale);
  return run_topk_stream(kS8, p, slots, slices, smem_bytes, merge_scratch, out_s, out_i,
                         device, stream);
}
