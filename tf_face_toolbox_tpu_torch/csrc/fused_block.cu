// One BN-folded stride-1 bottleneck block in one launch, bf16 in and
// out, f32 accumulation:
//
//   y1  = bf16(relu(x . W1 + b1))                 1x1 reduce
//   y2  = bf16(relu(sum_taps y1_shift . W2_tap + b2))   3x3 SAME
//   y3  = y2 . W3 + b3                            1x1 expand
//   out = bf16(relu(bf16(y3) + x))                identity block
//   out = bf16(relu(bf16(y3) + bf16(x . Wp + bp)))   entry (projection)
//
// Replaces the TPU kernel tf_face_toolbox_tpu/serving/fused_block.py
// (_kernel, launched by fused_bottleneck_stack), which runs a whole
// stage's run of blocks with G whole images resident in VMEM. On the
// H100 a 28x28x256 bf16 map is 400 KB per image, past the 227 KB of
// shared memory a CTA may hold, so the Python wrapper launches this
// kernel once per block and each CTA owns an output tile of th x tw
// pixels of G images. The rounding points are the TPU kernel's code
// (fused_block.py:133-147), not its docstring: the residual add happens
// in the compute dtype.
//
// What bounds it on an H100: at the main path's shapes the three GEMMs
// are compute-bound once y1 and y2 stay on chip (a stage-0 block at 28x28
// does ~0.6 GFLOP for 0.8 MB of device traffic per image), as long as
// the weights (up to 4.5 MB bf16 per block), which every CTA needs
// whole, are read once per CTA and not once per warp.
//
// Design: y1 and y2 live in shared memory. On a tiled map (th x tw
// tiles of a map wider than 16, or one whose whole image does not fit)
// y1 is computed on the (th+2)x(tw+2) halo tile, whose rows outside the
// image are 0. Where the tile is the whole image, y1 is computed on the
// G*H*W image rows only, beside one zero row that the kernel clears,
// and for each of y2's taps a lane addresses the y1 row of its shifted
// pixel, or the zero row where that pixel is outside the image (an
// out-of-image tap multiplies zeros either way, so the sums are the
// same). Whole images may run on a cluster of two CTAs on neighbouring
// SMs that share the same G images: CTA rank r computes columns
// [r N/2, (r+1) N/2) of y1, y2, the projection and y3, streams only
// those weight rows, and stores its y1 and y2 values into both CTAs'
// shared memory (the peer's through the cluster's distributed shared
// memory), with a cluster barrier where a lone CTA has __syncthreads.
// Each GEMM phase (y1; y2's nine taps; the
// projection; y3) walks its [M x N] output in n-blocks of NB columns,
// and for each n-block the CTA walks K in 64-element chunks (y2: tap by
// tap, k ascending in each). Each (NB x 64) weight slab is copied once
// per CTA by cp.async into a ring of 2-3 stages whose rows are padded to
// 144 bytes, so that ldmatrix is conflict-free. All 8 warps compute
// their 32 x 64 share of the CTA's [M x NB] block against the staged
// slab with mma.sync m16n8k16 (f32 accumulators, at most 64 a thread):
// B fragments come from ldmatrix on the slab, the A fragments of y1 and
// y2 from ldmatrix on y1s / y2s (for y2's taps each lane addresses its
// own shifted row, so the shift costs nothing), and x, the A
// operand of y1 and of the projection, from device memory once per
// n-block. Two instances: where two CTAs' shared memory fits an SM (the
// 28x28 stage), one capped at 128 registers a thread, whose warps load
// x per 16-wide step and leave its latency to the other CTA; else one
// CTA an SM, whose warps load x's next chunk while they multiply the
// current one. The projection's bf16 result waits in the output tensor
// until y3's epilogue adds it (the same thread, in a pair too: the
// projection and y3 of a column stay in one CTA). SAME zero-pads y1,
// not x. The K order (taps ascending, k ascending in 16-steps) and the
// rounding points do not depend on the staging, the tiling or the
// column split, so the result does not either. The host plan
// (launch_plan in serving/fused_block.py) decides the tiles, images a
// CTA, cluster, NBs, stages and instance; tfft_bottleneck_block checks
// that they fit and that the shared-memory sum is theirs. wgmma, TMA
// and several blocks per launch are later work.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMI = 2;                  // 16-row m tiles per warp
constexpr int kNT = 8;                  // 8-column n tiles per warp
constexpr int kWarpCols = kNT * 8;      // a warp owns 32 x 64 outputs of an n-block
constexpr int kPad = 8;                 // y1s / y2s row padding (bf16), avoids bank conflicts
constexpr int kChunk = 64;              // K elements of a ring stage: 128 bytes a row
constexpr int kRowStride = kChunk + 8;  // 144 bytes: conflict-free ldmatrix
constexpr int kSmemMax = 227 * 1024;    // 232,448 bytes, a CTA's most
constexpr int kSmemPerSm = 228 * 1024;  // an SM's, of which 1 KB per CTA is the system's
constexpr int kSmemPerCta = 1024;

typedef __nv_bfloat16 bf16;

struct BlockParams {
  const bf16* x;
  bf16* out;
  const bf16* w1;  // (B, Cin)
  const bf16* w2;  // (B, 9, B): [n][tap][k]
  const bf16* w3;  // (C, B)
  const bf16* wp;  // (C, Cin) or null (identity block)
  const float* b1;
  const float* b2;
  const float* b3;
  const float* bp;
  int n, h, w, cin, b, c;
  int th, tw, g;  // tile rows, tile columns, images per CTA
  int tiles_y, tiles_x;
  int nb[3];      // n-block columns: y1, y2, y3 and the projection
  int stages;     // ring stages
  int ring_rows;  // rows of a ring stage: the largest n-block
  int cluster;    // CTAs sharing a tile's images, each half the columns: 1 or 2
};

__device__ __forceinline__ uint32_t ldg32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void store2(bf16* p, float v0, float v1) {
  __nv_bfloat162 t;
  t.x = __float2bfloat16_rn(v0);
  t.y = __float2bfloat16_rn(v1);
  *reinterpret_cast<__nv_bfloat162*>(p) = t;
}

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
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
  if (stages >= 3) asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// Pixel of row r of the output tile (r < g*th*tw): image, y, x.
struct Pix {
  int img, y, x;
  bool valid;
};

__device__ __forceinline__ Pix tile_pixel(const BlockParams& p, int r, int n0, int ty0, int tx0) {
  const int per = p.th * p.tw;
  const int g = r / per, rem = r % per;
  Pix q;
  q.img = n0 + g;
  q.y = ty0 + rem / p.tw;
  q.x = tx0 + rem % p.tw;
  q.valid = q.img < p.n && q.y < p.h && q.x < p.w;
  return q;
}

__device__ __forceinline__ const bf16* x_row(const BlockParams& p, int img, int y, int x) {
  img = min(img, p.n - 1);
  y = min(max(y, 0), p.h - 1);
  x = min(max(x, 0), p.w - 1);
  return p.x + ((size_t)(img * p.h + y) * p.w + x) * p.cin;
}

// One GEMM phase: [M x N] = sum over segs x K of A . W^T, where row n
// of weight segment s starts at w + n * w_ld + s * k.
struct Gemm {
  const bf16* w;
  int w_ld, n, k, segs, m, nb;
};

// Copy the weight slab of ring chunk t (n-block, segment, 64-wide K
// chunk, in the order the phase walks them) into a stage: nb rows of up
// to 128 bytes, 16 bytes a thread; rows past N are zeros.
__device__ __forceinline__ void fill_stage(const Gemm& G, bf16* stage, int t, int nblocks,
                                           int kch) {
  const int per_nb = G.segs * kch;
  const int nblk = (t / per_nb) % nblocks, r = t % per_nb;
  const int seg = r / kch, k0 = (r % kch) * kChunk;
  const int pieces = min(kChunk, G.k - k0) / 8;
  const int n0 = nblk * G.nb;
  const bf16* base = G.w + (size_t)seg * G.k + k0;
  for (int e = threadIdx.x; e < G.nb * 8; e += kThreads) {
    const int row = e >> 3, pc = e & 7;
    if (pc >= pieces) continue;
    const int n = n0 + row;
    cp_async16(stage + row * kRowStride + pc * 8,
               base + (size_t)min(n, G.n - 1) * G.w_ld + pc * 8, n < G.n ? 16 : 0);
  }
}

// A in device memory: x rows (y1 on the halo tile, or on the output
// tile where it is the whole image; the projection on the output
// tile). Each lane reads its rows grp and grp + 8 of an m
// tile. kPrefetch (one CTA an SM, registers to spare): a chunk's
// fragments are issued together while the chunk before it is
// multiplied. Otherwise (two CTAs an SM, 128 registers a thread, the
// other CTA's warps hide the latency) each 16-wide step loads its own.
template <bool kPrefetch>
struct GlobalA {
  const BlockParams* p;
  int n0, ty0, tx0, m;
  bool halo;
  const bf16* row[kMI][2];
  int k0;                            // the chunk being multiplied
  uint32_t f[kChunk / 16][kMI][4];   // its fragments (kPrefetch)
  uint32_t nx[kChunk / 16][kMI][4];  // the next chunk's, in flight (kPrefetch)

  __device__ __forceinline__ void rows(int i, int mtile) {
    const int grp = (threadIdx.x & 31) >> 2;
    const int hh = p->th + 2, hw = p->tw + 2;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = min(mtile * 16 + hf * 8 + grp, m - 1);
      if (halo) {
        const int g = r / (hh * hw), rem = r % (hh * hw);
        row[i][hf] = x_row(*p, n0 + g, ty0 - 1 + rem / hw, tx0 - 1 + rem % hw);
      } else {
        const Pix q = tile_pixel(*p, r, n0, ty0, tx0);
        row[i][hf] = x_row(*p, q.img, q.y, q.x);
      }
    }
  }

  __device__ __forceinline__ void load(uint32_t (&a)[4], int i, int k) const {
    k += (threadIdx.x & 3) * 2;
    a[0] = ldg32(row[i][0] + k);
    a[1] = ldg32(row[i][1] + k);
    a[2] = ldg32(row[i][0] + k + 8);
    a[3] = ldg32(row[i][1] + k + 8);
  }

  __device__ __forceinline__ void prefetch(int next_k0, int width, const bool (&valid)[kMI]) {
    if constexpr (kPrefetch) {
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk)
#pragma unroll
        for (int i = 0; i < kMI; ++i)
          if (valid[i] && kk * 16 < width) load(nx[kk][i], i, next_k0 + kk * 16);
    }
  }

  // first: the pass's first chunk, which nothing prefetched
  __device__ __forceinline__ void begin(int, int chunk_k0, int width, const bool (&valid)[kMI],
                                        bool first) {
    k0 = chunk_k0;
    if constexpr (kPrefetch) {
      if (first) prefetch(chunk_k0, width, valid);
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk)
#pragma unroll
        for (int i = 0; i < kMI; ++i)
#pragma unroll
          for (int r = 0; r < 4; ++r) f[kk][i][r] = nx[kk][i][r];
    }
  }

  __device__ __forceinline__ void frag(int kk, int i, uint32_t (&a)[4]) const {
    if constexpr (kPrefetch) {
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = f[kk][i][r];
    } else {
      load(a, i, k0 + kk * 16);
    }
  }
};

// A in shared memory by ldmatrix: y1s for y2's taps, y2s for y3.
// Lane l addresses row (l & 15), columns 8 * (l >> 4), of each m tile.
enum ARows { kRows, kHaloTaps, kWholeTaps };

template <int kMode>  // kRows (y3), y2's taps on the halo tile or on whole images
struct SharedA {
  const bf16* base;
  int ld, m;
  int th, tw;
  int zero_row;  // kWholeTaps: the y1s row of zeros
  int row[kMI];  // this lane's ldmatrix row of each m tile (halo: at tap (0, 0))
  int yx[kMI];   // kWholeTaps: its pixel, y << 16 | x
  int tap[kMI];  // kWholeTaps: its row at the current tap
  const bf16* at;

  __device__ __forceinline__ void rows(int i, int mtile) {
    const int r = min(mtile * 16 + (threadIdx.x & 15), m - 1);
    if constexpr (kMode == kHaloTaps) {
      const int hw = tw + 2, per = th * tw;
      const int g = r / per, rem = r % per;
      row[i] = g * (th + 2) * hw + (rem / tw) * hw + rem % tw;
    } else {
      row[i] = r;
      if constexpr (kMode == kWholeTaps) {
        const int rem = r % (th * tw);
        yx[i] = (rem / tw) << 16 | (rem % tw);
      }
    }
  }

  __device__ __forceinline__ void prefetch(int, int, const bool (&)[kMI]) {}

  __device__ __forceinline__ void begin(int seg, int k0, int, const bool (&)[kMI], bool) {
    if constexpr (kMode == kWholeTaps) {
      at = base + k0 + ((threadIdx.x >> 4) & 1) * 8;
      const int dy = seg / 3 - 1, dx = seg % 3 - 1;
#pragma unroll
      for (int i = 0; i < kMI; ++i) {
        // the shifted pixel's row, or the zero row outside the image
        const int y = (yx[i] >> 16) + dy, x = (yx[i] & 0xffff) + dx;
        tap[i] = (unsigned)y < (unsigned)th && (unsigned)x < (unsigned)tw
                     ? row[i] + dy * tw + dx : zero_row;
      }
    } else {
      const int shift = kMode == kHaloTaps ? (seg / 3) * (tw + 2) + seg % 3 : 0;
      at = base + (size_t)shift * ld + k0 + ((threadIdx.x >> 4) & 1) * 8;
    }
  }

  __device__ __forceinline__ void frag(int kk, int i, uint32_t (&a)[4]) const {
    if constexpr (kMode == kWholeTaps) {
      ldmatrix_x4(a, at + (size_t)tap[i] * ld + kk * 16);
    } else {
      ldmatrix_x4(a, at + (size_t)row[i] * ld + kk * 16);
    }
  }
};

__device__ __forceinline__ void zero(float (&acc)[kMI][kNT][4]) {
#pragma unroll
  for (int i = 0; i < kMI; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
}

// Run one phase through the ring. Warps form a warps_m x warps_n grid
// over an n-block (warps_n = NB / 64); warp (wm, wn) owns m tiles
// wm, wm + warps_m of each pass over M and the 64 columns wn * 64 on.
// epi(r, col0, acc[i], hf) gets this lane's rows grp / grp + 8 (hf) of
// each finished m tile, for columns col0 + 8j + t2, +1. kLean (the
// 128-register instance): fewer fragments live at a time, which keeps
// it free of spills; the other order is the faster one at one CTA an
// SM (on an H100: 6-10% at the 14x14, 7x7 and 4x4 stages).
template <bool kLean, class Src, class Epi>
__device__ __forceinline__ void gemm_phase(const Gemm& G, Src& src, bf16* ring,
                                           int stage_elems, int stages, Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2;
  const int warps_n = G.nb / kWarpCols, warps_m = kWarps / warps_n;
  const int wm = warp % warps_m, wn = warp / warps_m;
  const int mt = (G.m + 15) / 16;
  const int tiles_pass = warps_m * kMI;
  const int passes = (mt + tiles_pass - 1) / tiles_pass;
  const int nblocks = (G.n + G.nb - 1) / G.nb;
  const int kch = (G.k + kChunk - 1) / kChunk;
  const int total = passes * nblocks * G.segs * kch;
  // this lane's ldmatrix address in a stage: n-tile pair rows, k half
  const int b_off = (wn * kWarpCols + ((lane >> 4) << 3) + (lane & 7)) * kRowStride +
                    ((lane >> 3) & 1) * 8;

  for (int s = 0; s < stages - 1; ++s) {
    if (s < total) fill_stage(G, ring + s * stage_elems, s, nblocks, kch);
    cp_async_commit();
  }
  int t = 0;
  for (int pass = 0; pass < passes; ++pass) {
    bool valid[kMI];
#pragma unroll
    for (int i = 0; i < kMI; ++i) {
      const int mtile = pass * tiles_pass + i * warps_m + wm;
      valid[i] = mtile < mt;
      if (valid[i]) src.rows(i, mtile);
    }
    for (int nblk = 0; nblk < nblocks; ++nblk) {
      const int col0 = nblk * G.nb + wn * kWarpCols;
      const bool active = valid[0] && col0 < G.n;
      float acc[kMI][kNT][4];
      zero(acc);
      for (int seg = 0; seg < G.segs; ++seg) {
        for (int k0 = 0; k0 < G.k; k0 += kChunk, ++t) {
          cp_async_wait_ring(stages);
          // chunk t has landed for every thread, and every thread is
          // done with the stage chunk t - 1 used, which the fill reuses
          __syncthreads();
          const int f = t + stages - 1;
          if (f < total) fill_stage(G, ring + (f % stages) * stage_elems, f, nblocks, kch);
          cp_async_commit();
          if (!active) continue;
          const int width = min(kChunk, G.k - k0);
          src.begin(seg, k0, width, valid, nblk == 0 && seg == 0 && k0 == 0);
          // the pass's next chunk: next k, next segment, next n-block
          if (k0 + kChunk < G.k)
            src.prefetch(k0 + kChunk, min(kChunk, G.k - k0 - kChunk), valid);
          else if (seg + 1 < G.segs || nblk + 1 < nblocks)
            src.prefetch(0, min(kChunk, G.k), valid);
          const bf16* slab = ring + (t % stages) * stage_elems + b_off;
#pragma unroll
          for (int kk = 0; kk < kChunk / 16; ++kk) {
            if (kk * 16 >= width) break;
            if constexpr (kLean) {
              // both m tiles' A, then B a pair of n tiles at a time
              uint32_t a[kMI][4];
#pragma unroll
              for (int i = 0; i < kMI; ++i)
                if (valid[i]) src.frag(kk, i, a[i]);
#pragma unroll
              for (int j = 0; j < kNT; j += 2) {
                uint32_t r4[4];
                ldmatrix_x4(r4, slab + j * 8 * kRowStride + kk * 16);
                const uint32_t b0[2] = {r4[0], r4[1]}, b1[2] = {r4[2], r4[3]};
#pragma unroll
                for (int i = 0; i < kMI; ++i) {
                  if (!valid[i]) continue;
                  mma16816(acc[i][j], a[i], b0);
                  mma16816(acc[i][j + 1], a[i], b1);
                }
              }
            } else {
              // all eight n tiles' B, then each m tile's A
              uint32_t bq[kNT][2];
#pragma unroll
              for (int j = 0; j < kNT; j += 2) {
                uint32_t r4[4];
                ldmatrix_x4(r4, slab + j * 8 * kRowStride + kk * 16);
                bq[j][0] = r4[0];
                bq[j][1] = r4[1];
                bq[j + 1][0] = r4[2];
                bq[j + 1][1] = r4[3];
              }
#pragma unroll
              for (int i = 0; i < kMI; ++i) {
                if (!valid[i]) continue;
                uint32_t a[4];
                src.frag(kk, i, a);
#pragma unroll
                for (int j = 0; j < kNT; ++j) mma16816(acc[i][j], a, bq[j]);
              }
            }
          }
        }
      }
      if (!active) continue;
#pragma unroll
      for (int i = 0; i < kMI; ++i) {
        if (!valid[i]) continue;
        const int mtile = pass * tiles_pass + i * warps_m + wm;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = mtile * 16 + hf * 8 + grp;
          if (r < G.m) epi(r, col0, acc[i], hf);
        }
      }
    }
  }
}

// kCtasPerSm: 2 where two halo tiles' shared memory fits an SM (the
// compiler then keeps a thread to 128 registers), else 1. kWhole: the
// tile is the whole image (halo-free y1, per-tap rows, pairs allowed;
// one CTA an SM, since its addressing does not fit 128 registers
// without spills); else a halo tile, whose code carries none of that.
template <int kCtasPerSm, bool kWhole>
__global__ void __launch_bounds__(kThreads, kCtasPerSm) bottleneck_kernel(const BlockParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = p.b + kPad;
  const int hh = p.th + 2, hw = p.tw + 2;
  constexpr bool whole = kWhole;
  const int m2 = p.g * p.th * p.tw;             // tile rows (y2, output)
  const int m1 = whole ? m2 : p.g * hh * hw;    // y1's rows: the image's, or the halo's
  bf16* y1s = reinterpret_cast<bf16*>(smem_raw);
  bf16* y2s = y1s + (size_t)(whole ? m1 + 1 : m1) * ld;  // whole: + the zero row
  bf16* ring = y2s + (size_t)m2 * ld;
  const int stage_elems = p.ring_rows * kRowStride;

  const bool pair = kWhole && p.cluster == 2;
  const int rank = pair ? (int)cg::this_cluster().block_rank() : 0;
  int blk = pair ? blockIdx.x / 2 : blockIdx.x;
  const int tx0 = (blk % p.tiles_x) * p.tw;
  blk /= p.tiles_x;
  const int ty0 = (blk % p.tiles_y) * p.th;
  const int n0 = (blk / p.tiles_y) * p.g;
  const int t2 = (threadIdx.x & 3) * 2;
  // this CTA's columns: [c1, c1 + n1) of y1 and y2, [c3, c3 + n3) of the
  // projection and y3
  const int n1 = pair ? p.b / 2 : p.b, c1 = rank * n1;
  const int n3 = pair ? p.c / 2 : p.c, c3 = rank * n3;
  bf16* peer_y1s = nullptr;
  bf16* peer_y2s = nullptr;
  if (pair) {
    cg::cluster_group cluster = cg::this_cluster();
    peer_y1s = cluster.map_shared_rank(y1s, rank ^ 1);
    peer_y2s = cluster.map_shared_rank(y2s, rank ^ 1);
    // the peer has started (its shared memory is live) before any store to it
    cluster.sync();
  }
  // between phases: every y1 (y2) value of both CTAs stored, and the
  // ring free for the next phase's fill
  auto phase_sync = [&]() {
    if (pair) cg::this_cluster().sync();
    else __syncthreads();
  };
  if (whole)
    for (int e = threadIdx.x; e < ld; e += kThreads)
      y1s[(size_t)m1 * ld + e] = __float2bfloat16(0.f);

  // ---- y1 = bf16(relu(x . W1 + b1)): on the halo tile (0 outside the
  // image), or on the whole images' rows
  {
    GlobalA<kCtasPerSm == 1> src{&p, n0, ty0, tx0, m1, !whole};
    const Gemm G{p.w1 + (size_t)c1 * p.cin, p.cin, n1, p.cin, 1, m1, p.nb[0]};
    gemm_phase<kCtasPerSm == 2>(G, src, ring, stage_elems, p.stages,
               [&](int r, int col0, const float (&a)[kNT][4], int hf) {
                 bool inside;
                 if (whole) {
                   inside = n0 + r / (p.h * p.w) < p.n;
                 } else {
                   const int g = r / (hh * hw), rem = r % (hh * hw);
                   const int y = ty0 - 1 + rem / hw, x = tx0 - 1 + rem % hw;
                   inside = n0 + g < p.n && y >= 0 && y < p.h && x >= 0 && x < p.w;
                 }
#pragma unroll
                 for (int j = 0; j < kNT; ++j) {
                   const int lc = col0 + j * 8 + t2;
                   if (lc >= n1) continue;
                   const int col = c1 + lc;
                   const float v0 = inside ? fmaxf(a[j][2 * hf] + p.b1[col], 0.f) : 0.f;
                   const float v1 = inside ? fmaxf(a[j][2 * hf + 1] + p.b1[col + 1], 0.f) : 0.f;
                   store2(y1s + (size_t)r * ld + col, v0, v1);
                   if (pair) store2(peer_y1s + (size_t)r * ld + col, v0, v1);
                 }
               });
  }
  phase_sync();

  // ---- y2 = bf16(relu(conv3x3(y1) + b2)) on the tile: nine tap GEMMs
  {
    SharedA<whole ? kWholeTaps : kHaloTaps> src{y1s, ld, m2, p.th, p.tw, m1};
    const Gemm G{p.w2 + (size_t)c1 * 9 * p.b, 9 * p.b, n1, p.b, 9, m2, p.nb[1]};
    gemm_phase<kCtasPerSm == 2>(G, src, ring, stage_elems, p.stages,
               [&](int r, int col0, const float (&a)[kNT][4], int hf) {
#pragma unroll
                 for (int j = 0; j < kNT; ++j) {
                   const int lc = col0 + j * 8 + t2;
                   if (lc >= n1) continue;
                   const int col = c1 + lc;
                   const float v0 = fmaxf(a[j][2 * hf] + p.b2[col], 0.f);
                   const float v1 = fmaxf(a[j][2 * hf + 1] + p.b2[col + 1], 0.f);
                   store2(y2s + (size_t)r * ld + col, v0, v1);
                   if (pair) store2(peer_y2s + (size_t)r * ld + col, v0, v1);
                 }
               });
  }
  phase_sync();

  // ---- entry block: bf16(x . Wp + bp) into out, where y3's epilogue
  // reads it back (the same thread, the same element)
  if (p.wp != nullptr) {
    GlobalA<kCtasPerSm == 1> src{&p, n0, ty0, tx0, m2, false};
    const Gemm G{p.wp + (size_t)c3 * p.cin, p.cin, n3, p.cin, 1, m2, p.nb[2]};
    gemm_phase<kCtasPerSm == 2>(G, src, ring, stage_elems, p.stages,
               [&](int r, int col0, const float (&a)[kNT][4], int hf) {
                 const Pix q = tile_pixel(p, r, n0, ty0, tx0);
                 if (!q.valid) return;
                 bf16* o = p.out + ((size_t)(q.img * p.h + q.y) * p.w + q.x) * p.c;
#pragma unroll
                 for (int j = 0; j < kNT; ++j) {
                   const int lc = col0 + j * 8 + t2;
                   if (lc >= n3) continue;
                   const int col = c3 + lc;
                   store2(o + col, a[j][2 * hf] + p.bp[col], a[j][2 * hf + 1] + p.bp[col + 1]);
                 }
               });
    __syncthreads();
  }

  // ---- out = bf16(relu(bf16(y2 . W3 + b3) + shortcut)), straight to device memory
  {
    SharedA<kRows> src{y2s, ld, m2, p.th, p.tw, 0};
    const Gemm G{p.w3 + (size_t)c3 * p.b, p.b, n3, p.b, 1, m2, p.nb[2]};
    gemm_phase<kCtasPerSm == 2>(G, src, ring, stage_elems, p.stages,
               [&](int r, int col0, const float (&a)[kNT][4], int hf) {
                 const Pix q = tile_pixel(p, r, n0, ty0, tx0);
                 if (!q.valid) return;
                 const size_t pix = (size_t)(q.img * p.h + q.y) * p.w + q.x;
                 const bf16* s = p.wp != nullptr ? p.out + pix * p.c : p.x + pix * p.cin;
#pragma unroll
                 for (int j = 0; j < kNT; ++j) {
                   const int lc = col0 + j * 8 + t2;
                   if (lc >= n3) continue;
                   const int col = c3 + lc;
                   const float t0 = round_bf16(a[j][2 * hf] + p.b3[col]);
                   const float t1 = round_bf16(a[j][2 * hf + 1] + p.b3[col + 1]);
                   const __nv_bfloat162 sv = *reinterpret_cast<const __nv_bfloat162*>(s + col);
                   store2(p.out + pix * p.c + col, fmaxf(t0 + __bfloat162float(sv.x), 0.f),
                          fmaxf(t1 + __bfloat162float(sv.y), 0.f));
                 }
               });
  }
  // no CTA of a pair leaves while its peer may still address its
  // shared memory
  if (pair) cg::this_cluster().sync();
}

// y1s and y2s: whole images hold y1's image rows and one zero row,
// tiles y1's halo
size_t tile_bytes(int th, int tw, int g, int b, bool whole) {
  const size_t rows = whole ? (size_t)2 * g * th * tw + 1
                            : (size_t)g * ((th + 2) * (tw + 2) + th * tw);
  return rows * (b + kPad) * sizeof(bf16);
}

// an n-block the warps can tile: warps_n = nb / 64 shares a row of the grid
bool valid_nb(int nb) {
  return nb > 0 && nb % kWarpCols == 0 && kWarps % (nb / kWarpCols) == 0;
}

}  // namespace

// The plan (th, tw, g, nb1..nb3, stages, ctas_per_sm, cluster,
// smem_bytes) comes from launch_plan in serving/fused_block.py, which
// decides it; this side only checks it. -1: arguments the kernel does
// not take; -2: a plan that does not fit in shared memory, whose
// shared-memory sum is not the one its tiles, n-blocks and stages need,
// whose two CTAs an SM do not fit or run whole images, or whose pair is
// not on whole images, does not split B and C into halves of a multiple
// of 16, or cannot be resident (the grid, groups x cluster, is a whole
// number of pairs by construction).
extern "C" int tfft_bottleneck_block(const void* x, void* out, const void* w1, const void* b1,
                                     const void* w2, const void* b2, const void* w3,
                                     const void* b3, const void* wp, const void* bp, int n,
                                     int h, int w, int cin, int b, int c, int th, int tw, int g,
                                     int nb1, int nb2, int nb3, int stages, int ctas_per_sm,
                                     int cluster, int smem_bytes, int device, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || cin % 16 || b % 16 || c % 16 || cin <= 0 || b <= 0 ||
      c <= 0)
    return -1;
  if (wp == nullptr && cin != c) return -1;
  if (th < 1 || th > h || tw < 1 || tw > w || g < 1 || g > n || !valid_nb(nb1) ||
      !valid_nb(nb2) || !valid_nb(nb3) || stages < 2 || stages > 3 || ctas_per_sm < 1 ||
      ctas_per_sm > 2 || cluster < 1 || cluster > 2)
    return -1;
  const bool whole = th == h && tw == w;
  if (cluster == 2 && (!whole || (b / 2) % 16 || (c / 2) % 16)) return -2;
  const int ring_rows = nb1 > nb2 ? (nb1 > nb3 ? nb1 : nb3) : (nb2 > nb3 ? nb2 : nb3);
  const size_t smem = tile_bytes(th, tw, g, b, whole) +
                      (size_t)stages * ring_rows * kRowStride * sizeof(bf16);
  if (smem > (size_t)kSmemMax || smem != (size_t)smem_bytes ||
      (ctas_per_sm == 2 && (whole || 2 * (smem + kSmemPerCta) > (size_t)kSmemPerSm)))
    return -2;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;

  BlockParams p;
  p.x = static_cast<const bf16*>(x);
  p.out = static_cast<bf16*>(out);
  p.w1 = static_cast<const bf16*>(w1);
  p.w2 = static_cast<const bf16*>(w2);
  p.w3 = static_cast<const bf16*>(w3);
  p.wp = static_cast<const bf16*>(wp);
  p.b1 = static_cast<const float*>(b1);
  p.b2 = static_cast<const float*>(b2);
  p.b3 = static_cast<const float*>(b3);
  p.bp = static_cast<const float*>(bp);
  p.n = n;
  p.h = h;
  p.w = w;
  p.cin = cin;
  p.b = b;
  p.c = c;
  p.th = th;
  p.tw = tw;
  p.g = g;
  p.nb[0] = nb1;
  p.nb[1] = nb2;
  p.nb[2] = nb3;
  p.stages = stages;
  p.ring_rows = ring_rows;
  p.cluster = cluster;
  p.tiles_y = (h + th - 1) / th;
  p.tiles_x = (w + tw - 1) / tw;
  const long long grid = (long long)((n + g - 1) / g) * p.tiles_y * p.tiles_x * cluster;
  if (grid > 0x7fffffffLL) return -1;

  void (*kernel)(BlockParams) =
      whole ? bottleneck_kernel<1, true>
            : (ctas_per_sm == 2 ? bottleneck_kernel<2, false> : bottleneck_kernel<1, false>);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  if (cluster == 1) {
    kernel<<<(unsigned)grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, reinterpret_cast<const void*>(kernel), &cfg);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return -2;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
