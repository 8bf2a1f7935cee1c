// Fused eval input stage: u8 -> bilinear resize -> optional flip ->
// tf.image per-image standardization -> f32 or bf16.
//
// Replaces the TPU kernel tf_face_toolbox_tpu/ops/pallas_preprocess.py
// (_kernel, launched by fused_preprocess). That kernel resizes with two
// dense matrix products on the MXU and bakes the flip into a second
// width matrix. Here each output value is two 2-tap interpolations
// (height, then width) read from the source rows staged in shared
// memory.
//
// What bounds it on an H100: device memory, 43 KB of u8 in and 75 KB
// of bf16 out an image at 120 -> 112 x 3, a few FMAs a value. Short of
// that, the SM's own costs decide: instructions and shared-memory loads
// a value, the cycles a warp's global store takes whatever its width,
// and a CTA's copy, arithmetic and stores running in series. So:
//
// - A cluster of 1, 2 or 4 CTAs shares an image, each CTA a band of
//   output rows (rank r: rows [r * band_rows, (r + 1) * band_rows)).
// - A CTA stages the source rows its band's taps read in shared memory,
//   one maximal run of rows at a time (a "seg"), each rounded out to
//   the copy's alignment: one cp.async.bulk a run, completing on an
//   mbarrier, where the tensor's base and size are multiples of 16
//   bytes; else 4-byte cp.async, or byte loads. Runs come in
//   chunks that fit; on the main path a band is one chunk of one run,
//   and that run (the band's "lead") comes by value with the launch, so
//   the copy starts before any table is read.
// - Thread t owns output column t % tc and the band's rows t / tc, +
//   tr, ...; a column is an RGB pixel (its three channels share one set
//   of taps, the channel an immediate offset of the loads) or, for other
//   channel counts, one value of a row. Its column taps sit in four
//   registers, loaded once, the flip only choosing which column's taps.
//   Lanes hold neighbouring columns, so their byte loads fall in a few
//   consecutive words (no bank conflicts). A row's taps are one 16-byte
//   entry that the lanes of a warp share.
// - Each resized value is computed once into registers and used by the
//   sum, the squared deviations and the write. The CTA's partial sums
//   go to every CTA of the cluster through distributed shared memory,
//   one cluster barrier each, and every CTA adds them in rank order, so
//   all agree on the mean and std.
// - The band's output is staged in shared memory at its global
//   address's offset in 16 bytes and leaves in 16-byte stores (a
//   warp's 2-byte stores cost about as many cycles as its 16-byte
//   ones).
// - Where every band is one chunk, the copy bulk and an image a whole
//   number of 16 bytes, the plan persists: the launch holds only the
//   CTAs the card runs at once, and each walks several images, copying
//   the next one's band into a second staging buffer while it computes
//   this one.
//
// The plan (cluster, band rows, threads and their columns and rows,
// the instance, copy mode, chunks, runs, staged and shared-memory
// bytes) comes from launch_plan in ops/fused_preprocess.py with its
// tables; this side checks it and returns -2 for a plan that does not
// fit or does not suit the tensors.
//
// Numerics follow the TPU kernel: the tap weights are the nonzeros of
// the same _bilinear_matrix rows (built by the Python wrapper, so they
// are bit-identical), height is interpolated before width, mean and
// variance use the two-pass population form, and the std is floored
// at 1/sqrt(out_h*out_w*C) (passed in, computed in double on the host).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kSmemMax = 232448;
constexpr int kReserved = 512;  // warp partials, cluster slots, the mbarrier
constexpr int kMaxCluster = 4;
constexpr int kLead = 8;        // a band's lead, see PreParams

enum CopyMode { kBulk = 0, kAsync4 = 1, kBytes = 2 };

struct PreParams {
  const uint8_t* images;
  const int* flips;   // null: no image flipped
  const int* w_idx;   // (out_w, 2) source columns of each output column
  const float* w_wt;  // (out_w, 2) their weights
  const int* chunks;  // (n_chunks, 4): output rows [lo, hi), runs [a, e)
  const int* segs;    // (n_segs, 4): first source row, rows, staged offset, 0
  // (out_h, 4): byte offset of the row's run in the image, staged
  // offset of its first tap's row, the two weights' bits (the second
  // tap's row is the next one where its weight is not 0)
  const int4* rows;
  void* out;
  int n, in_h, in_w, ch, out_h, out_w, out_bf16;
  int cluster, band_rows, tc, tr, jc, copy, persist, stage_bytes, out_stage_bytes;
  float inv_sqrt_n;
  // per rank: chunk range [c_first, c_end), the first chunk's output
  // rows [lo, hi) and runs [a, e), its first run's source row and rows
  int lead[kMaxCluster][kLead];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Phase stamps, built only with -DTFFT_PRE_STAMPS (bench_preprocess
// --stamps): thread 0 of each CTA writes kStamps u64 a CTA: the SM, the
// global timer at entry and exit (ns), and clock64 at each phase below.
#ifdef TFFT_PRE_STAMPS
constexpr int kStamps = 10;
__device__ unsigned long long* g_stamps;
__device__ __forceinline__ void stamp(int i) {
  if (threadIdx.x == 0 && g_stamps != nullptr)
    g_stamps[(size_t)blockIdx.x * kStamps + 3 + i] = clock64();
}
__device__ __forceinline__ void stamp_timer(int i) {
  if (threadIdx.x != 0 || g_stamps == nullptr) return;
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  g_stamps[(size_t)blockIdx.x * kStamps + 1 + i] = t;
  if (i == 0) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    g_stamps[(size_t)blockIdx.x * kStamps] = sm;
  }
}
#else
__device__ __forceinline__ void stamp(int) {}
__device__ __forceinline__ void stamp_timer(int) {}
#endif

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Sum of v over the CTA, in every thread; scratch holds one float a warp.
__device__ __forceinline__ float cta_sum(float v, float* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = lane < (int)(blockDim.x >> 5) ? scratch[lane] : 0.f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum over the cluster: each CTA stores its partial into slot[rank] of
// every CTA (through distributed shared memory), one cluster barrier,
// then every CTA adds the slots in rank order.
__device__ __forceinline__ float cluster_sum(float part, float* slots, int cluster,
                                             int rank) {
  if (cluster == 1) return part;
  cg::cluster_group cl = cg::this_cluster();
  if ((int)threadIdx.x < cluster) *cl.map_shared_rank(slots + rank, threadIdx.x) = part;
  cl.sync();
  float total = 0.f;
  for (int r = 0; r < cluster; ++r) total += slots[r];
  return total;
}

__host__ __device__ __forceinline__ int copy_align(int copy) {
  return copy == kBytes ? 1 : (copy == kAsync4 ? 4 : 16);
}

// Copy `rows` source rows of the image at img_off from row `first` into
// the staging area at `dst`, rounded out to the copy's alignment. bulk:
// the calling thread alone issues one cp.async.bulk on the mbarrier;
// async and bytes: every thread of the CTA copies its pieces.
__device__ __forceinline__ void copy_run(const PreParams& p, size_t img_off, int first,
                                         int rows, uint8_t* dst, uint64_t* bar) {
  const int row_bytes = p.in_w * p.ch;
  const int align = copy_align(p.copy);
  const size_t start = img_off + (size_t)first * row_bytes;
  const size_t from = start & ~(size_t)(align - 1);
  const size_t to = (start + (size_t)rows * row_bytes + align - 1) & ~(size_t)(align - 1);
  if (p.copy == kBulk) {
    const uint32_t bytes = (uint32_t)(to - from);
    // the staging area's earlier reads (generic proxy) before this write
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(
                     smem_addr(bar)),
                 "r"(bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
        "l"(p.images + from), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
    return;
  }
  const int pieces = (int)((to - from) / align);
  for (int i = threadIdx.x; i < pieces; i += blockDim.x) {
    const uint8_t* src = p.images + from + (size_t)i * align;
    if (p.copy == kAsync4) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst + 4 * i)),
                   "l"(src)
                   : "memory");
    } else {
      dst[i] = __ldg(src);
    }
  }
}

// Start copying runs [a, e) of a chunk (all but the first when `skip`,
// which the lead already issued). finish_chunk waits for the copy.
__device__ void issue_runs(const PreParams& p, size_t img_off, int a, int e, bool skip,
                           uint8_t* stage, uint64_t* bar) {
  if (skip) ++a;
  if (p.copy == kBulk) {
    for (int k = a + threadIdx.x; k < e; k += blockDim.x)
      copy_run(p, img_off, p.segs[4 * k], p.segs[4 * k + 1], stage + p.segs[4 * k + 2], bar);
  } else {
    for (int k = a; k < e; ++k)
      copy_run(p, img_off, p.segs[4 * k], p.segs[4 * k + 1], stage + p.segs[4 * k + 2], bar);
  }
}

// Fill the row taps of a chunk's output rows [o_lo, o_hi): the staged
// offsets of each row's two source rows and their weights.
__device__ void fill_rows(const PreParams& p, size_t img_off, int o_lo, int o_hi, int band_lo,
                          int4* row_tab) {
  const int row_bytes = p.in_w * p.ch;
  const int align = copy_align(p.copy);
  for (int o = o_lo + threadIdx.x; o < o_hi; o += blockDim.x) {
    const int4 r = p.rows[o];
    const int r0 = r.y + (int)((img_off + (size_t)r.x) & (size_t)(align - 1));
    row_tab[o - band_lo] = make_int4(r0, r0 + (r.w != 0 ? row_bytes : 0), r.z, r.w);
  }
}

// Wait until the chunk's copy and row taps are visible to every thread
// (bulk: the mbarrier's phase of this chunk's parity).
__device__ void finish_chunk(const PreParams& p, uint64_t* bar, int phase) {
  if (p.copy == kAsync4)
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  if (p.copy == kBulk) {
    if (threadIdx.x == 0)
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
                   : "memory");
    mbar_wait(bar, (uint32_t)phase);
  }
}

// u8 -> f32 without the quarter-rate I2F: 2^23 + u as a float, minus
// 2^23 (exact for u < 2^23)
__device__ __forceinline__ float u8f(uint32_t u) {
  return __int_as_float(0x4B000000u | u) - 8388608.f;
}

// Column col's taps for an image: byte offsets in a staged source row
// of its two source values (CW = 3: the first channel of its two source
// pixels; CW = 1: a value, its channel folded in), and their weights.
template <int CW>
__device__ __forceinline__ int4 column_taps(const PreParams& p, int col, bool flip) {
  int wo = col, c = 0;
  if (CW == 1) {
    wo = col / p.ch;
    c = col - wo * p.ch;
  }
  const int ws = flip ? p.out_w - 1 - wo : wo;
  return make_int4(__ldg(p.w_idx + 2 * ws) * p.ch + c, __ldg(p.w_idx + 2 * ws + 1) * p.ch + c,
                   __float_as_int(__ldg(p.w_wt + 2 * ws)),
                   __float_as_int(__ldg(p.w_wt + 2 * ws + 1)));
}

// VALS values a thread, launched with up to MAXT threads (the register
// cap); CW = 3: a column is an output pixel of 3 channels (one set of
// taps, the channel an immediate offset); CW = 1: a column is one output
// value. WIDE: a thread owns jc > 1 columns (an output row wider than
// the CTA), their taps reloaded as the slots walk them. Slot s is the
// thread's column s % jc of its row s / jc. A CTA walks images
// blockIdx.x / cluster, + gridDim.x / cluster, ...: one of them unless
// the plan persists, and then the next image's band is copied into the
// second staging buffer while this one's is computed.
template <int VALS, int MAXT, int CW, bool WIDE>
__global__ void __launch_bounds__(MAXT, 1) preprocess_kernel(const PreParams p) {
  constexpr int NS = VALS / CW;
  stamp_timer(0);
  stamp(0);
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* stages = smem;  // one staging buffer, two when the plan persists
  int4* row_tab = reinterpret_cast<int4*>(smem + p.stage_bytes * (p.persist ? 2 : 1));
  uint8_t* out_stage = reinterpret_cast<uint8_t*>(row_tab + p.band_rows);
  float* scratch = reinterpret_cast<float*>(out_stage + p.out_stage_bytes);  // 2 x 32
  float* slots = scratch + 64;                                                // 2 x kMaxCluster
  uint64_t* bars = reinterpret_cast<uint64_t*>(slots + 2 * kMaxCluster);     // one a buffer

  const int tid = threadIdx.x;
  const int groups = gridDim.x / p.cluster;
  int img = blockIdx.x / p.cluster;
  const int rank = blockIdx.x - img * p.cluster;
  const int* lead = p.lead[rank];
  const bool has_rows = lead[0] < lead[1];
  const int band_lo = rank * p.band_rows;
  const int band_n = max(0, min(p.out_h - band_lo, p.band_rows));
  const size_t image_bytes = (size_t)p.in_h * p.in_w * p.ch;
  const int row_out = p.out_w * p.ch;
  const int ncols = CW == 3 ? p.out_w : row_out;

  // the cluster's CTAs have started before any stores into another's
  // shared memory (the wait is before the first cluster_sum)
  if (p.cluster > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  // the first image's lead run first: it needs no table
  if (p.copy == kBulk) {
    if (tid == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bars)) : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bars + 1))
                   : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      if (has_rows) copy_run(p, img * image_bytes, lead[6], lead[7], stages, bars);
    }
    __syncthreads();  // the mbarriers' init, before other threads' runs
  } else if (has_rows) {
    copy_run(p, img * image_bytes, lead[6], lead[7], stages, bars);
  }
  if (has_rows) {
    issue_runs(p, img * image_bytes, lead[4], lead[5], true, stages, bars);
    fill_rows(p, img * image_bytes, lead[2], lead[3], band_lo, row_tab);
  }

  // this thread's columns and rows
  const int tc = tid % p.tc;
  const int g = tid / p.tc;
  const int my_rows = g < p.tr && g < band_n ? (band_n - g + p.tr - 1) / p.tr : 0;
  const int n_slots = my_rows * p.jc;
  const float total_n = float(p.out_h) * float(row_out);
  const int elem = p.out_bf16 ? 2 : 4;
  uint8_t* gout = static_cast<uint8_t*>(p.out);
  stamp(1);

  int buf = 0, uses0 = 0, uses1 = 0;  // each buffer's mbarrier phases
  for (int it = 0; img < p.n; ++it, img += groups) {
    const size_t img_off = (size_t)img * image_bytes;
    // the image's flip, and this thread's first column's taps for it
    // (loaded while the copy is in flight)
    const bool flip = p.flips != nullptr && __ldg(p.flips + img) != 0;
    const int4 taps = column_taps<CW>(p, tc, flip);
    uint8_t* stage = stages + buf * p.stage_bytes;
    // the next image's band into the other buffer (read by no thread
    // since the last image's barriers)
    const int next = img + groups;
    if (p.persist && has_rows && next < p.n) {
      uint8_t* other = stages + (buf ^ 1) * p.stage_bytes;
      if (tid == 0) copy_run(p, (size_t)next * image_bytes, lead[6], lead[7], other, bars + (buf ^ 1));
      issue_runs(p, (size_t)next * image_bytes, lead[4], lead[5], true, other, bars + (buf ^ 1));
    }

    float vals[NS][CW];
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int c = 0; c < CW; ++c) vals[s][c] = 0.f;

    for (int cidx = lead[0]; cidx < lead[1]; ++cidx) {
      int o_lo = lead[2], o_hi = lead[3];
      if (cidx > lead[0]) {
        const int4 chk = reinterpret_cast<const int4*>(p.chunks)[cidx];
        o_lo = chk.x;
        o_hi = chk.y;
        __syncthreads();  // the last chunk's reads are done
        issue_runs(p, img_off, chk.z, chk.w, false, stage, bars + buf);
        fill_rows(p, img_off, o_lo, o_hi, band_lo, row_tab);
      }
      finish_chunk(p, bars + buf, (buf ? uses1++ : uses0++) & 1);
      if (it == 0 && cidx == lead[0]) stamp(2);
      const int r_lo = o_lo - band_lo, r_hi = o_hi - band_lo;
      int4 tp = taps;
      int i = 0, row = g;
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const int col = tc + i * p.tc;
        if (s < n_slots && row >= r_lo && row < r_hi && (!WIDE || col < ncols)) {
          const int4 rt = row_tab[row];
          const float a0 = __int_as_float(rt.z), a1 = __int_as_float(rt.w);
          const float b0 = __int_as_float(tp.z), b1 = __int_as_float(tp.w);
          const uint8_t* q00 = stage + rt.x + tp.x;
          const uint8_t* q01 = stage + rt.x + tp.y;
          const uint8_t* q10 = stage + rt.y + tp.x;
          const uint8_t* q11 = stage + rt.y + tp.y;
#pragma unroll
          for (int c = 0; c < CW; ++c) {
            const float y0 = a0 * u8f(q00[c]) + a1 * u8f(q10[c]);
            const float y1 = a0 * u8f(q01[c]) + a1 * u8f(q11[c]);
            vals[s][c] = b0 * y0 + b1 * y1;
          }
        }
        if (WIDE) {
          if (++i == p.jc) {
            i = 0;
            row += p.tr;
          }
          const int cn = tc + i * p.tc;
          if (cn < ncols) tp = column_taps<CW>(p, cn, flip);
        } else {
          row += p.tr;
        }
      }
    }
    if (it == 0) stamp(3);

    if (it == 0 && p.cluster > 1) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    // four partial sums, for the adds' latency; invalid slots hold 0
    float s4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int c = 0; c < CW; ++c) s4[(s * CW + c) & 3] += vals[s][c];
    const float part = (s4[0] + s4[1]) + (s4[2] + s4[3]);
    const float mean = cluster_sum(cta_sum(part, scratch), slots, p.cluster, rank) / total_n;
    if (it == 0) stamp(4);

    float q4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const int col = WIDE ? tc + (s % p.jc) * p.tc : tc;
      if (s < n_slots && (!WIDE || col < ncols)) {
#pragma unroll
        for (int c = 0; c < CW; ++c) {
          const float d = vals[s][c] - mean;
          q4[(s * CW + c) & 3] += d * d;
        }
      }
    }
    const float qpart = (q4[0] + q4[1]) + (q4[2] + q4[3]);
    const float var =
        cluster_sum(cta_sum(qpart, scratch + 32), slots + kMaxCluster, p.cluster, rank) / total_n;
    // one reciprocal for the image: within an f32 step of the division
    const float inv = 1.f / fmaxf(sqrtf(var), p.inv_sqrt_n);
    if (it == 0) stamp(5);

    // the band's output, staged in shared memory at the global address's
    // offset in 16 bytes (the last image's pieces were read before the
    // reductions' barriers), then written in 16-byte pieces (elements at
    // the ends)
    const size_t g0 = ((size_t)img * p.out_h + band_lo) * row_out * elem;
    const size_t gend = g0 + (size_t)band_n * row_out * elem;
    const size_t gbase = g0 & ~(size_t)15;
    {
      int i = 0, row = g;
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const int col = tc + i * p.tc;
        if (s < n_slots && (!WIDE || col < ncols)) {
          uint8_t* dst = out_stage + (g0 - gbase) + ((size_t)row * row_out + col * CW) * elem;
#pragma unroll
          for (int c = 0; c < CW; ++c) {
            const float v = (vals[s][c] - mean) * inv;
            if (p.out_bf16)
              reinterpret_cast<__nv_bfloat16*>(dst)[c] = __float2bfloat16_rn(v);
            else
              reinterpret_cast<float*>(dst)[c] = v;
          }
        }
        if (WIDE && ++i < p.jc) continue;
        i = 0;
        row += p.tr;
      }
    }
    __syncthreads();
    size_t v0 = (g0 + 15) & ~(size_t)15, v1 = gend & ~(size_t)15;
    if (v0 >= v1) v0 = v1 = gend;
    for (size_t at = v0 + 16 * (size_t)tid; at < v1; at += 16 * (size_t)blockDim.x)
      *reinterpret_cast<uint4*>(gout + at) =
          *reinterpret_cast<const uint4*>(out_stage + (at - gbase));
    const int n_head = (int)((v0 - g0) / elem), n_ends = n_head + (int)((gend - v1) / elem);
    for (int k = tid; k < n_ends; k += blockDim.x) {
      const size_t at = k < n_head ? g0 + (size_t)k * elem : v1 + (size_t)(k - n_head) * elem;
      if (elem == 2)
        *reinterpret_cast<uint16_t*>(gout + at) =
            *reinterpret_cast<const uint16_t*>(out_stage + (at - gbase));
      else
        *reinterpret_cast<uint32_t*>(gout + at) =
            *reinterpret_cast<const uint32_t*>(out_stage + (at - gbase));
    }
    if (it == 0) stamp(6);
    if (p.persist) buf ^= 1;
  }
  stamp_timer(1);
}

using Kernel = void (*)(PreParams);

// The instances, as ops/fused_preprocess.py's INSTANCES lists them.
struct Instance {
  int vals, maxt, cw, wide;
  Kernel kernel;
};
const Instance kInstances[] = {
    {84, 448, 3, 0, preprocess_kernel<84, 448, 3, false>},
    {42, 896, 3, 0, preprocess_kernel<42, 896, 3, false>},
    {96, 448, 1, 0, preprocess_kernel<96, 448, 1, false>},
    {48, 896, 1, 0, preprocess_kernel<48, 896, 1, false>},
    {16, 1024, 1, 1, preprocess_kernel<16, 1024, 1, true>},
};
constexpr int kNumInstances = sizeof(kInstances) / sizeof(kInstances[0]);

// What the host has asked of the driver for each instance on each
// device, so that a launch repeats neither call: the shared memory
// allowed, and for the last launch configuration how many images (CTAs
// or clusters) the card holds at once.
constexpr int kMaxDevices = 16;
int g_smem_set[kMaxDevices][kNumInstances];
struct Resident {
  int threads, smem, cluster, groups;
};
Resident g_resident[kMaxDevices][kNumInstances];

}  // namespace

// One plan's launch, built once by the Python wrapper (ctypes structure
// _Launch in ops/fused_preprocess.py: the same fields in the same
// order): the column taps, the plan's chunks, segs and rows tables in
// one int32 tensor, the shape, the plan, each band's lead.
struct PreLaunch {
  const void* w_idx;
  const void* w_wt;
  const void* tables;
  int n, in_h, in_w, ch, out_h, out_w, out_bf16;
  float inv_sqrt_n;
  int cluster, band_rows, threads, tc, tr, jc, vals, maxt, cw, wide, copy, persist;
  int n_chunks, n_segs, stage_bytes, out_stage_bytes, smem_bytes;
  int lead[kMaxCluster][kLead];
};

// This side checks the plan. -1: arguments the kernel does not take;
// -2: a plan whose cluster, instance, threads or columns are out of
// range, whose registers do not hold its band, whose shared-memory sum
// is not its own or does not fit, whose copy mode does not suit the
// tensors' alignment, whose persistence its bands or images do not
// allow, or whose cluster cannot be resident.
extern "C" int tfft_preprocess(const PreLaunch* L, const void* images, const void* flips,
                               void* out, int device, void* stream) {
  if (L == nullptr || images == nullptr || out == nullptr || L->tables == nullptr ||
      L->w_idx == nullptr || L->w_wt == nullptr)
    return -1;
  const int n = L->n, ch = L->ch, cluster = L->cluster, band_rows = L->band_rows;
  if (n <= 0 || L->in_h <= 0 || L->in_w <= 0 || ch <= 0 || L->out_h <= 0 || L->out_w <= 0)
    return -1;
  if (device < 0 || device >= kMaxDevices) return -1;
  const long long row_out = (long long)L->out_w * ch;
  if (cluster != 1 && cluster != 2 && cluster != 4) return -2;
  if (band_rows < 1 || (long long)band_rows * cluster < L->out_h || L->n_chunks < 1 ||
      L->n_segs < 1)
    return -2;
  int inst = -1;
  for (int k = 0; k < kNumInstances; ++k)
    if (kInstances[k].vals == L->vals && kInstances[k].maxt == L->maxt &&
        kInstances[k].cw == L->cw && kInstances[k].wide == L->wide)
      inst = k;
  if (inst < 0 || (L->cw == 3 && ch != 3)) return -2;
  // threads cover the columns, jc > 1 only on the wide instance, every
  // thread's slots fit its registers
  const int threads = L->threads, tc = L->tc, tr = L->tr, jc = L->jc;
  const long long ncols = L->cw == 3 ? L->out_w : row_out;
  if (threads < 32 || threads % 32 || threads > L->maxt || tc < 1 || tr < 1 || jc < 1) return -2;
  if ((long long)tc * tr > threads || (long long)tc * jc < ncols || tc > ncols) return -2;
  if ((jc > 1) != (L->wide != 0)) return -2;
  if ((long long)jc * ((band_rows + tr - 1) / tr) * L->cw > L->vals) return -2;
  const long long image_bytes = (long long)L->in_h * L->in_w * ch;
  if (L->copy < kBulk || L->copy > kBytes) return -2;
  const int align = copy_align(L->copy);
  if (n * image_bytes % align || reinterpret_cast<uintptr_t>(images) % align) return -2;
  // persisting: one chunk a band, bulk copies, and runs whose offsets in
  // 16 bytes are the same in every image (so the row taps are too)
  if (L->persist && (L->copy != kBulk || L->n_chunks > cluster || image_bytes % 16)) return -2;
  const int elem = L->out_bf16 ? 2 : 4;
  if (reinterpret_cast<uintptr_t>(out) % 16) return -2;
  if (L->out_stage_bytes != ((long long)band_rows * row_out * elem + 15 + 15) / 16 * 16) return -2;
  const long long smem = (long long)L->stage_bytes * (L->persist ? 2 : 1) +
                         (long long)band_rows * 16 + L->out_stage_bytes + kReserved;
  if (L->stage_bytes < 0 || L->stage_bytes % 16 || smem != L->smem_bytes || smem > kSmemMax)
    return -2;
  if ((long long)n * cluster > 0x7fffffffLL) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;

  PreParams p;
  const int* t = static_cast<const int*>(L->tables);
  p.images = static_cast<const uint8_t*>(images);
  p.flips = static_cast<const int*>(flips);
  p.w_idx = static_cast<const int*>(L->w_idx);
  p.w_wt = static_cast<const float*>(L->w_wt);
  p.chunks = t;
  p.segs = t + 4 * L->n_chunks;
  p.rows = reinterpret_cast<const int4*>(p.segs + 4 * L->n_segs);  // 16-byte entries
  p.out = out;
  p.n = n;
  p.in_h = L->in_h;
  p.in_w = L->in_w;
  p.ch = ch;
  p.out_h = L->out_h;
  p.out_w = L->out_w;
  p.out_bf16 = L->out_bf16;
  p.cluster = cluster;
  p.band_rows = band_rows;
  p.tc = tc;
  p.tr = tr;
  p.jc = jc;
  p.copy = L->copy;
  p.persist = L->persist;
  p.stage_bytes = L->stage_bytes;
  p.out_stage_bytes = L->out_stage_bytes;
  p.inv_sqrt_n = L->inv_sqrt_n;
  for (int r = 0; r < kMaxCluster; ++r)
    for (int k = 0; k < kLead; ++k) p.lead[r][k] = r < cluster ? L->lead[r][k] : 0;

  Kernel kernel = kInstances[inst].kernel;
  if (g_smem_set[device][inst] < smem) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    g_smem_set[device][inst] = (int)smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(n * cluster));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  // how many images (clusters) can be resident at once: a cluster must
  // be, and a persisting plan launches no more than that
  Resident& res = g_resident[device][inst];
  if (!(res.threads == threads && res.smem == smem && res.cluster == cluster)) {
    int groups = 0;
    if (cluster > 1) {
      err = cudaOccupancyMaxActiveClusters(&groups, reinterpret_cast<const void*>(kernel), &cfg);
    } else {
      int per_sm = 0, sms = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, reinterpret_cast<const void*>(kernel), threads, smem);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
      groups = per_sm * sms;
    }
    if (err != cudaSuccess) return (int)err;
    res = {threads, (int)smem, cluster, groups};
  }
  if (res.groups < 1) return -2;
  if (L->persist && res.groups < n) cfg.gridDim = dim3((unsigned)(res.groups * cluster));
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

#ifdef TFFT_PRE_STAMPS
// Where the stamps go: (grid, kStamps) u64 on the device, or null.
extern "C" int tfft_preprocess_stamps(void* buf) {
  return (int)cudaMemcpyToSymbol(g_stamps, &buf, sizeof(buf));
}
#endif

// Message for a status returned by any entry point of this library.
extern "C" const char* tfft_error_string(int status) {
  if (status == -2) return "launch plan refused (does not fit, or not its own)";
  if (status < 0) return "invalid arguments";
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
