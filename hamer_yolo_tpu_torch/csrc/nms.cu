// K1: greedy NMS keep mask over score-sorted candidates, one thread-block
// cluster per image.
//
// Replaces the TPU kernel hamer_yolo_tpu/ops/nms_pallas.py:greedy_nms_keep
// (_nms_kernel). Same contract: boxes (B, K, 4) f32 xyxy, score-sorted and
// class-shifted; active (B, K) {0, 1}; thr scalar -> keep (B, K). active and
// keep are f32 (greedy_nms_keep) or bool (non_max_suppression's entry). The
// keep set equals that of the plain version (ops/nms.py:greedy_nms_keep_ref,
// the JAX scan _greedy_suppress) bit for bit, for any K up to 2048.
//
// What bounds it on the H100: neither bytes (B K 24) nor operations (an IoU
// for each pair of active candidates) but latency: the launch, a few
// cluster barriers, and the greedy scan, which is sequential by definition.
// So the kernel computes only what the keep set depends on, spreads that
// over the card, and makes the scan's serial steps as few as the result
// allows. Each reduction below is exact:
//
// - Row i of the suppression mask is read only when i is kept, which needs
//   active[i]; bit (i, j) changes only alive[j], which counts only where
//   active[j]. The IoU is bitwise symmetric: fminf, fmaxf and the sum of the
//   two areas commute, and each area is the same instructions for either
//   box. A kept i cannot suppress a j < i that was kept, since that j would
//   have suppressed i first. So only the pairs i < j with both candidates
//   active get a bit; the diagonal, the lower triangle and the rows and
//   columns of inactive candidates are never built.
// - Where the intersection is 0, the IoU is 0 / max(union, 1e-12) = +-0
//   whatever the union, and the bit is 0 > thr: exact for any thr, negative
//   or NaN included. Elsewhere the bit is the __fdiv_rn quotient > thr (the
//   quotient is computed for every pair, with no branch, and used only
//   there).
// - The mask is spread over the card: C = min(ceil(K / 32), 16) CTAs of 1024
//   threads per image, one cluster (non-portable past 8 CTAs). Each CTA
//   stages every box and its area in shared memory. The mask is built in
//   tasks of (block of 32 rows, word of 32 columns, quarter of the rows),
//   spread over every warp of the cluster: a lane holds its column's box in
//   registers, the task's active rows come two at a time, and __ballot_sync
//   packs each row's word. The words go by distributed shared memory to the
//   CTA that keeps the block's rows: the first CTA, where the scan reads
//   them, while the triangle of rows fits in 68 KB (K <= 1024); past that,
//   block q to CTA q % C. Each row is stored from word i / 32 on, word w of
//   a block's 32 rows together. The first CTA also gets each row's diagonal
//   word (its bits in its own word) and a flag for each row with a bit set.
// - After a cluster barrier, one warp of the first CTA scans a word of 32
//   candidates at a time, lane l holding words l and l + 32 of alive &
//   active. It goes straight to the next word with an alive candidate whose
//   row has a bit (__ballot_sync + __ffs): the alive candidates before it
//   are kept and suppress nothing. Inside the word, the kept set is the
//   fixed point of kept = alive & ~(OR of the kept rows' diagonal words)
//   (__reduce_or_sync): unique, since bit i depends only on the bits below
//   it, and reached in a few rounds, since the bits below n are final after
//   n. Then the kept rows' later words are ORed into the later words of
//   alive (32 rows' words by 16-byte loads, from shared memory up to K =
//   1024, from the CTA that keeps them past that). So the serial steps are
//   the words with work, at most K / 32, and each step's loads are issued
//   together. A last cluster barrier keeps every CTA's rows until the scan
//   is done; the first CTA writes the keep mask.
//
// The IoU is geometry/boxes.box_iou's arithmetic op for op, inter /
// max(area_i + area_j - inter, 1e-12) tested > thr in f32, with the _rn
// intrinsics, and the file is built with --fmad=false. No fast math.
//
// The diagnostic build -DHYT_NMS_DIAG=1 (chip_gemm.py --k1 --variant tail)
// is the design that lost: the same CTAs without a cluster, the rows and
// flags in a workspace in device memory, each CTA fencing and counting
// itself on a per-image counter, and the CTA that completes the count
// resetting it and scanning, reading the rows from L2 (PERF.md, section 6,
// has both designs' times).
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

#ifndef HYT_NMS_DIAG
#define HYT_NMS_DIAG 0
#endif

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;  // CTAs of an image: a non-portable cluster past 8
constexpr int kMaxK = 2048;      // the alive mask in two words a lane
constexpr unsigned kFull = 0xffffffffu;

constexpr int kLocalWords = 17408;  // 68 KB: every row of K = 1024 in one CTA

// Where the rows live. W blocks of 32 candidates (and words of a row); row i
// of block q = i / 32 holds its words q..W-1 only. Block q's 32 rows lie in
// CTA q % P, after that CTA's earlier blocks: P = 1, all in the first CTA,
// where the scan reads them, while they take at most kLocalWords; else P = C.
__host__ __device__ __forceinline__ int row_stripes(int W, int C) {
  return 16 * W * (W + 1) <= kLocalWords ? 1 : C;
}
// Block q's first word in its CTA.
__host__ __device__ __forceinline__ int block_offset(int q, int W, int P) {
  const int m = q / P, o = q % P;
  return 32 * (m * (W - o) - P * m * (m - 1) / 2);
}
// The words of the first CTA's blocks, the most of any CTA.
__host__ __device__ __forceinline__ int stripe_words(int W, int P) {
  const int M = (W + P - 1) / P;
  return 32 * (M * W - P * M * (M - 1) / 2);
}

// The launch of one K: C CTAs per image, and the shared memory of a CTA: all
// boxes (float4) and their areas, its rows, the active bits and the keep
// bits (W words each), and, used in the first CTA only, every block's row
// flags (W words) and every row's diagonal word (32 W words).
struct Geometry {
  int ctas;
  size_t smem;
};

Geometry geometry(int K) {
  Geometry g;
  const int W = (K + 31) / 32;
  g.ctas = W < kMaxCluster ? W : kMaxCluster;
  g.smem = (size_t)K * 20 + ((size_t)stripe_words(W, row_stripes(W, g.ctas)) + 35 * W) * 4;
  return g;
}

__device__ __forceinline__ bool is_active(float v) { return v > 0.5f; }
__device__ __forceinline__ bool is_active(uint8_t v) { return v != 0; }

__device__ __forceinline__ float box_area(float4 a) {
  return __fmul_rn(__fsub_rn(a.z, a.x), __fsub_rn(a.w, a.y));
}

// iou(a, c) > thr, as box_iou computes it; 0 > thr where the boxes do not
// intersect (the quotient is then +-0: computed all the same, no branch).
__device__ __forceinline__ bool suppresses(float4 a, float area_a, float4 c, float area_c,
                                           float thr) {
  const float iw = fmaxf(__fsub_rn(fminf(a.z, c.z), fmaxf(a.x, c.x)), 0.0f);
  const float ih = fmaxf(__fsub_rn(fminf(a.w, c.w), fmaxf(a.y, c.y)), 0.0f);
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_c), inter);
  const bool over = __fdiv_rn(inter, fmaxf(uni, 1e-12f)) > thr;
  return inter == 0.0f ? 0.0f > thr : over;
}

// Diagnostic builds (chip_gemm.py --k1 --variant; keep masks wrong but for
// 1): HYT_NMS_DIAG=1 the tail form without a cluster (kTail: rows in ws,
// counters); 2 leaves out the scan, 3 the rows and the scan (the keep mask
// is then active itself); 5 traces the first CTA of the first image: the SM
// clock at each step, from the start, in the first words of its keep mask,
// then the words the scan took, its rounds and the cluster's SMs; 6 leaves
// out the stores of the rows but the diagonal words; 7 the IoU arithmetic
// (a bit is then area_i > area_j).
constexpr int kDiag = HYT_NMS_DIAG;
#if HYT_NMS_DIAG == 5
#define NMS_STAMP(k) \
  if (tid == 0) trace[k] = clock()
#else
#define NMS_STAMP(k)
#endif

template <typename IoT, bool kTail>
__global__ void __launch_bounds__(kThreads, 2)
nms_keep_kernel(const float* __restrict__ boxes, const IoT* __restrict__ active, float thr,
                IoT* __restrict__ keep, int K, int C, uint32_t* __restrict__ ws,
                unsigned* __restrict__ counters) {
  extern __shared__ float4 smem[];
  const int W = (K + 31) >> 5;
  const int P = row_stripes(W, C);
  float4* sbox = smem;
  uint32_t* srow = reinterpret_cast<uint32_t*>(smem + K);  // this CTA's blocks of rows
  float* sarea = reinterpret_cast<float*>(srow + stripe_words(W, P));
  uint32_t* sact = reinterpret_cast<uint32_t*>(sarea + K);
  uint32_t* skeep = sact + W;
  uint32_t* sflag = skeep + W;    // the first CTA's: block q's row flags
  uint32_t* sdiag = sflag + W;    // the first CTA's: row i's word i / 32
  __shared__ int s_last;
  __shared__ unsigned trace[11 + kMaxCluster];  // HYT_NMS_DIAG == 5: stamps, counts, SMs
  unsigned words_done = 0, rounds = 0;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  NMS_STAMP(0);
  if (kDiag == 5 && tid == 0) trace[4] = ~0u, trace[3] = 0;
  const int b = blockIdx.y;
  const int rank = kTail ? (int)blockIdx.x : (int)cluster_ctarank();
  const IoT* act = active + (size_t)b * K;
  uint32_t* grow = ws + (size_t)b * (stripe_words(W, 1) + W);  // kTail: P = 1, then flags
  uint32_t* gflag = grow + stripe_words(W, 1);

  if (tid < W) sflag[tid] = 0;
  __syncwarp();
  if constexpr (!kTail) cluster_arrive();  // the flags zeroed; waited for before the rows

  // Boxes, areas and active bits: a thread per candidate, all loads at once.
  const float* bx = boxes + (size_t)b * K * 4;
  const bool vec = (reinterpret_cast<uintptr_t>(bx) & 15) == 0;
  for (int j0 = 0; j0 < K; j0 += kThreads) {
    const int j = j0 + tid;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    bool on = false;
    if (j < K) {
      v = vec ? reinterpret_cast<const float4*>(bx)[j]
              : make_float4(bx[4 * j], bx[4 * j + 1], bx[4 * j + 2], bx[4 * j + 3]);
      on = is_active(act[j]);
    }
    const uint32_t bits = __ballot_sync(kFull, on);
    if (j < K) {
      sbox[j] = v;
      sarea[j] = box_area(v);
    }
    if (lane == 0 && (j >> 5) < W) sact[j >> 5] = bits;
  }
  __syncthreads();
  NMS_STAMP(1);
  if constexpr (!kTail) cluster_wait();  // every CTA of the cluster runs
  NMS_STAMP(2);

  // The rows of the active candidates, in tasks of (block q, word w >= q,
  // quarter h) spread over every warp of the cluster: a lane holds column j =
  // 32 w + lane in registers, and the task's rows i come two at a time, a
  // ballot packing word w of row i, (iou(i, j) > thr) for the active j > i,
  // into the shared memory of the CTA that keeps block q (distributed shared
  // memory; the first CTA gets the diagonal words too), where word w of the
  // block's 32 rows lie together, at (w - q) 32. The rows with a bit are
  // flagged in the first CTA.
  const int warps = (kTail ? (int)gridDim.x : C) * kWarps;
  int q = 0, rest = rank * kWarps + warp;
  uint32_t* flags = kTail ? gflag : cluster_map(sflag, 0);
  uint32_t* diags = kTail ? nullptr : cluster_map(sdiag, 0);
  while (true) {
    while (q < W && rest >= 4 * (W - q)) rest -= 4 * (W - q++);
    if (q >= W || kDiag == 3) break;
    const int w = q + (rest >> 2);
    const int j = (w << 5) + lane;
    const bool col = (sact[w] >> lane) & 1u;  // no bit past K
    float4 c = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float area_c = 0.0f;
    if (col) {
      c = sbox[j];
      area_c = sarea[j];
    }
    uint32_t* rows = (kTail ? grow + block_offset(q, W, 1)
                            : cluster_map(srow, q % P) + block_offset(q, W, P)) +
                     (w - q) * 32;
    const bool diag = !kTail && w == q;
    uint32_t todo = sact[q] & (0xffu << (8 * (rest & 3)));
    uint32_t flagged = 0;
    while (todo) {  // warp-uniform
      const int r0 = __ffs(todo) - 1;
      todo &= todo - 1;
      const int r1 = todo ? __ffs(todo) - 1 : r0;  // r0 again when one row is left
      todo &= todo - 1;
      const int i0 = (q << 5) + r0, i1 = (q << 5) + r1;
      const bool b0 = col & (j > i0) &
                      (kDiag == 7 ? sarea[i0] > area_c
                                  : suppresses(sbox[i0], sarea[i0], c, area_c, thr));
      const bool b1 = col & (j > i1) &
                      (kDiag == 7 ? sarea[i1] > area_c
                                  : suppresses(sbox[i1], sarea[i1], c, area_c, thr));
      const uint32_t w0 = __ballot_sync(kFull, b0), w1 = __ballot_sync(kFull, b1);
      if (lane == r0) {
        if (kDiag != 6) rows[r0] = w0;
        if (diag) diags[i0] = w0;
      }
      if (lane == r1) {
        if (kDiag != 6) rows[r1] = w1;
        if (diag) diags[i1] = w1;
      }
      flagged |= (w0 ? 1u << r0 : 0u) | (w1 ? 1u << r1 : 0u);
    }
    if (lane == 0 && flagged) atomicOr(&flags[q], flagged);
    rest += warps;
  }
  if (kDiag == 5 && lane == 0) {
    atomicMax(&trace[3], (unsigned)clock());
    atomicMin(&trace[4], (unsigned)clock());
  }
  __syncthreads();
  NMS_STAMP(5);

  if constexpr (kTail) {
    __threadfence();  // this thread's rows and flags before the count
    __syncthreads();
    if (tid == 0) s_last = atomicAdd(&counters[b], 1u) == gridDim.x - 1;
    __syncthreads();
    if (!s_last) return;
    if (tid == 0) counters[b] = 0;  // ready for the next launch
    __threadfence();
  } else {
    if (kDiag == 5 && tid == 0) {
      unsigned sm;
      asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
      cluster_map(trace, 0)[11 + rank] = sm;
    }
    __syncwarp();
    cluster_arrive();  // every CTA's rows, diagonal words and flags, released
    cluster_wait();
  }
  NMS_STAMP(6);

  // The scan, a word (32 candidates) at a time, in one warp: lane l holds
  // words l and l + 32 of alive & active (cand) and of the row flags.
  const bool scanner = kTail || rank == 0;
  if (scanner && warp == 0) {
    uint32_t cand[2], flag[2], pend[2];  // pend: alive, flagged, not yet applied
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int w = lane + 32 * k;
      cand[k] = w < W ? sact[w] : 0u;
      flag[k] = w >= W ? 0u : kTail ? __ldcg(&gflag[w]) : sflag[w];
      if (kTail && w < W) gflag[w] = 0;  // ready for the next launch
      pend[k] = cand[k] & flag[k];
    }
    while (kDiag != 2 && kDiag != 3) {
      // w: the first word with an alive candidate whose row has a bit; the
      // alive candidates of the words before it are kept and suppress nothing
      int k = 0;
      uint32_t vote = __ballot_sync(kFull, pend[0] != 0u);
      if (!vote) {
        vote = __ballot_sync(kFull, pend[1] != 0u);
        if (!vote) break;
        k = 1;
      }
      const int src = __ffs(vote) - 1;
      const int w = src + 32 * k;
      const uint32_t c = __shfl_sync(kFull, k ? cand[1] : cand[0], src);
      const uint32_t f = __shfl_sync(kFull, k ? flag[1] : flag[0], src);
      // Inside the word: lane l holds word w of row 32 w + l (its bits j >
      // i), and kept = c & ~(the OR of the kept rows' words) by fixed-point
      // iteration. The fixed point is unique (bit i depends only on bits
      // below i) and the greedy result; the bits below n are final after n
      // rounds, and a round that changes nothing has reached it.
      const int i = (w << 5) + lane;
      uint32_t d = 0;
      if ((f >> lane) & 1u) {
        if constexpr (kTail)
          d = __ldcg(&grow[block_offset(w, W, 1) + lane]);
        else
          d = sdiag[i];
      }
      d &= ~((2u << lane) - 1u);  // bits j > i only, as built: at most 33 rounds
      uint32_t kept = c;
      while (true) {
        const uint32_t next = c & ~__reduce_or_sync(kFull, ((kept >> lane) & 1u) ? d : 0u);
        ++rounds;
        if (next == kept) break;
        kept = next;
      }
      ++words_done;
      if (lane == src) {
        if (k) {
          cand[1] = kept;
          pend[1] = 0;
        } else {
          cand[0] = kept;
          pend[0] = 0;
        }
      }
      // The later words: the OR of the kept flagged rows' words, read from
      // the CTA that keeps them (the first one while K <= 1024), all 32 rows'
      // words at once, 16 bytes a load (those of rows not kept or not
      // flagged, maybe never built, are masked out).
      const uint32_t kf = kept & f;
      if (!kf) continue;
      auto apply = [&](const uint32_t* rows) {
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const int ww = lane + 32 * kk;
          if (ww > w && ww < W) {
            const uint32_t* col = rows + (ww - w) * 32;  // word ww of the 32 rows
            uint32_t v[32];
#pragma unroll
            for (int t = 0; t < 32; t += 4) {
              if constexpr (kTail) {
#pragma unroll
                for (int u = t; u < t + 4; ++u) v[u] = (kf >> u) & 1u ? __ldcg(&col[u]) : 0u;
              } else {
                const uint4 x = reinterpret_cast<const uint4*>(col)[t >> 2];
                v[t] = x.x, v[t + 1] = x.y, v[t + 2] = x.z, v[t + 3] = x.w;
              }
            }
            uint32_t acc = 0;
#pragma unroll
            for (int t = 0; t < 32; ++t) acc |= (kf >> t) & 1u ? v[t] : 0u;
            cand[kk] &= ~acc;
            pend[kk] = cand[kk] & flag[kk];
          }
        }
      };
      if (kTail)
        apply(grow + block_offset(w, W, 1));
      else if (P == 1)  // in this CTA: plain shared-memory loads
        apply(srow + block_offset(w, W, 1));
      else
        apply(cluster_map(srow, w % P) + block_offset(w, W, P));
    }
#pragma unroll
    for (int k = 0; k < 2; ++k)
      if (lane + 32 * k < W) skeep[lane + 32 * k] = cand[k];
    NMS_STAMP(7);
    if (kDiag == 5 && lane == 0) trace[9] = words_done, trace[10] = rounds;
  }
  if (scanner) {
    __syncthreads();
    if constexpr (!kTail) cluster_arrive();  // the scan has read every row it needs
    IoT* out = keep + (size_t)b * K;
    for (int j = tid; j < K; j += kThreads)
      out[j] = static_cast<IoT>((skeep[j >> 5] >> (j & 31)) & 1u);
    if constexpr (kDiag == 5) {
      __syncthreads();
      NMS_STAMP(8);
      if (tid < 11 + C && b == 0 && sizeof(IoT) == 4)
        reinterpret_cast<unsigned*>(out)[tid] = tid < 9 ? trace[tid] - trace[0] : trace[tid];
    }
    if constexpr (!kTail) cluster_wait();
  } else if constexpr (!kTail) {
    cluster_arrive();
    cluster_wait();
  }
}

__global__ void nms_floor_kernel() {}

// The diagnostic form's workspace and per-image counters (zeroed once),
// grown as needed; made before a CUDA graph captures the launch (the first,
// eager run of a captured program makes it). A buffer outgrown by a larger
// (B, K) is never freed: a graph captured on it replays into it for as long
// as the graph lives.
int tail_workspace(int B, int K, cudaStream_t st, uint32_t** ws, unsigned** counters) {
  static uint32_t* g_ws = nullptr;
  static unsigned* g_counters = nullptr;
  static size_t g_words = 0;
  static int g_images = 0;
  const int W = (K + 31) / 32;
  const size_t words = (size_t)B * (stripe_words(W, 1) + W);
  cudaError_t err = cudaSuccess;
  if (words > g_words) {
    g_words = 0;
    if ((err = cudaMalloc(&g_ws, words * 4)) != cudaSuccess) return (int)err;
    if ((err = cudaMemsetAsync(g_ws, 0, words * 4, st)) != cudaSuccess) return (int)err;  // flags
    g_words = words;
  }
  if (B > g_images) {
    g_images = 0;
    if ((err = cudaMalloc(&g_counters, (size_t)B * 4)) != cudaSuccess) return (int)err;
    if ((err = cudaMemsetAsync(g_counters, 0, (size_t)B * 4, st)) != cudaSuccess) return (int)err;
    g_images = B;
  }
  *ws = g_ws;
  *counters = g_counters;
  return 0;
}

// Raise the kernel's shared-memory limit to the most any K takes, and allow
// clusters past 8 CTAs, once per device.
template <typename Kernel>
int set_attributes(Kernel kernel, bool* done) {
  int dev = 0, sms = 0;
  if (const int rc = current_sms(&dev, &sms)) return rc;
  if (done[dev]) return 0;
  size_t smem = 0;
  for (int K = 32; K <= kMaxK; K += 32) smem = geometry(K).smem > smem ? geometry(K).smem : smem;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  done[dev] = true;
  return 0;
}

cudaLaunchConfig_t launch_config(const Geometry& g, int B, bool cluster, cudaStream_t st,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g.ctas, B, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = g.smem;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = g.ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster ? 1 : 0;
  return cfg;
}

template <typename IoT>
int launch_keep(const void* boxes, const void* active, float thr, void* keep, int B, int K,
                cudaStream_t st) {
  constexpr bool kTail = kDiag == 1;
  auto kernel = nms_keep_kernel<IoT, kTail>;
  static bool done[MAX_DEVICES] = {};
  if (const int rc = set_attributes(kernel, done)) return rc;
  const Geometry g = geometry(K);
  uint32_t* ws = nullptr;
  unsigned* counters = nullptr;
  if (kTail) {
    if (const int rc = tail_workspace(B, K, st, &ws, &counters)) return rc;
  }
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(g, B, !kTail, st, attr);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, (const float*)boxes,
                                             (const IoT*)active, thr, (IoT*)keep, K, g.ctas,
                                             ws, counters);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

}  // namespace

// keep = K1(boxes, active, thr); bool_io: active and keep are bool (1 byte),
// else f32.
extern "C" int hyt_nms_keep(const void* boxes, const void* active, float thr, void* keep, int B,
                            int K, int bool_io, void* stream) {
  if (K <= 0 || K > kMaxK || B <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return bool_io ? launch_keep<uint8_t>(boxes, active, thr, keep, B, K, st)
                 : launch_keep<float>(boxes, active, thr, keep, B, K, st);
}

// The launch floor: an empty kernel launched as K1 is at (B, K), with its
// grid, cluster and shared memory; or, with parent_grid, as K1 was launched
// before its redesign (one CTA of 256 threads per image, no cluster).
extern "C" int hyt_nms_floor(int B, int K, int parent_grid, void* stream) {
  if (K <= 0 || K > kMaxK || B <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (parent_grid) {
    nms_floor_kernel<<<B, 256, 0, st>>>();
    return (int)cudaGetLastError();
  }
  static bool done[MAX_DEVICES] = {};
  if (const int rc = set_attributes(nms_floor_kernel, done)) return rc;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(geometry(K), B, true, st, attr);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, nms_floor_kernel);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}
