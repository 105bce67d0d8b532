// The appearance embedding's backward with a fixed summation order, for
// Hopper (sm_90a). Replaces no TPU kernel: the JAX package's OneHotEmbed
// (switch_nerf_tpu/models/common.py) takes its gradient as a one-hot
// matmul, which XLA sums in one fixed order on every run, so a resumed JAX
// run repeats the uninterrupted one bit for bit. The port's gather
// (F.embedding) needs a scatter-sum backward; this one gives the same bits
// on every run, so a resumed run on the card repeats an uninterrupted one.
//
// dW[n, f] = sum of g[r, f] over the rows r with idx[r] == n, in ascending
// r, in fp32 from 0: the order of the plain version (a CPU index_add_).
// Two launches, no library kernel:
//
//  1. embedding_bwd_group, one CTA of 1,024 threads, groups the rows by
//     index with a counting sort that knows the key range [0, N). In the
//     port's chunks a ray's samples lie together, so an index comes in
//     runs of hundreds of equal rows, and the pass works on runs: each
//     warp walks a contiguous segment of the rows once (coalesced loads,
//     eight 32-row steps in flight) and finds the run heads by ballot; a
//     scan over the warps puts the runs in row order; integer atomics count
//     each index's rows (they only count); a scan of the counts gives
//     offsets[N + 1] and the list of indices that have rows; one warp
//     places the runs in row order (32 a step, __match_any_sync for runs
//     of one index within a step, so no place depends on an atomic's
//     order); then each warp writes perm, every index's rows in ascending
//     order, for its share of the runs. The counts sit in shared memory
//     while N fits (kSmemCountBytes), in the workspace above that. An index
//     outside [0, N) stops the kernel (__trap).
//  2. embedding_bwd_sum, kSumCtasPerSm CTAs an SM at most, first writes
//     zeros to the table rows no index names, then takes the indices that
//     have rows, each over a slab of features (F split so that the items
//     fill the grid, 8 to 512 features), as work items. An item's rows
//     stream from g through a kStages-deep cp.async ring (16-byte copies
//     where F, the row stride and g allow), the perm entries of the tile
//     after next loaded while the current tile is added. Each thread adds
//     its feature's column of a tile one row after another into a
//     register: one sequential fp32 chain per (n, f), the plain version's
//     bits.
//
// Bound: bytes. The call reads g once (S x F x 4 B, 6.3 MB for a
// 32,768-row chunk at F = 48) and the indices (S x 8 B) and writes dW
// (N x F x 4 B); one add a gradient entry. What holds it back: the
// grouping pass runs on one SM, a chain of dependent steps; an item's
// chain of adds is sequential (4 cycles an add), so an index that takes
// every row of a chunk waits on its chain; and runs placed 32 at a time,
// so inputs where every row is its own run take longest. Plain C
// interface, loaded with ctypes (switch_nerf_torch/ops/embedding.py).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kAll = 0xffffffffu;
constexpr int kGroupThreads = 1024;
constexpr int kWarps = kGroupThreads / 32;
constexpr int kBatch = 8;  // 32-row steps whose loads are in flight at once
constexpr int kPlaceBatch = 4;  // and 32-run steps in step 4
constexpr size_t kSmemCountBytes = 96 * 1024;
constexpr long long kIntRows = 1LL << 30;  // below this, rows fit an int

constexpr int kSumThreads = 128;
constexpr int kSumCtasPerSm = 3;
constexpr int kStages = 4;
constexpr int kStageFloats = 4096;  // 16 KB a stage
constexpr int kSlab = 512;          // features a work item sums, at most
constexpr int kMinSlab = 8;         // and at least (32 B), where F allows
constexpr int kPerThread = kSlab / kSumThreads;

// ------------------------------------------------------------ grouping ----

template <typename T>
__device__ __forceinline__ T warp_inclusive_sum(T v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T u = __shfl_up_sync(kAll, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

// The sum of a warp-uniform v over the warps before this one; total gets
// the sum over all. Every thread of the CTA calls it; scratch holds 32.
template <typename T>
__device__ T warp_exclusive_sum(T v, T* scratch, T& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) scratch[lane] = warp_inclusive_sum(scratch[lane]);
  __syncthreads();
  total = scratch[kWarps - 1];
  const T before = warp ? scratch[warp - 1] : T(0);
  __syncthreads();
  return before;
}

__device__ __forceinline__ void count_add(int* p, int v) { atomicAdd(p, v); }
__device__ __forceinline__ void count_add(long long* p, long long v) {
  atomicAdd(reinterpret_cast<unsigned long long*>(p),
            static_cast<unsigned long long>(v));
}

// Walks rows [a, b), one warp's segment, 32 rows a step with kBatch
// steps' loads in flight, and calls step(r, heads) for each step: r this
// lane's row (past b on the last steps), heads the ballot of the step's
// run heads (a row whose index differs from the row before's; row 0 is
// one). Stops the kernel on an index outside [0, N).
template <typename Row, typename Step>
__device__ __forceinline__ void walk_rows(const long long* idx, Row a, Row b,
                                          int N, Step step) {
  const int lane = threadIdx.x & 31;
  long long carry = a > 0 && a < b ? idx[a - 1] : -1;
  bool bad = false;
  for (Row r0 = a; r0 < b; r0 += 32 * kBatch) {
    long long k[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const Row r = r0 + u * 32 + lane;
      k[u] = r < b ? idx[r] : -1;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const Row r = r0 + u * 32 + lane;
      const bool in = r < b;
      bad |= in && (k[u] < 0 || k[u] >= N);
      long long prev = __shfl_up_sync(kAll, k[u], 1);
      if (lane == 0) prev = carry;
      carry = __shfl_sync(kAll, k[u], 31);
      step(r, __ballot_sync(kAll, in && k[u] != prev));
    }
  }
  if (bad) __trap();
}

// counts [N]: global workspace, or nullptr for shared memory (N Rows of
// dynamic shared memory). Each warp takes a contiguous segment of the rows
// (and of the table), so every load is coalesced.
template <typename Row>
__global__ void __launch_bounds__(kGroupThreads, 1)
embedding_bwd_group(const long long* __restrict__ idx, Row S, int N,
                    Row* __restrict__ offsets, Row* __restrict__ perm,
                    Row* __restrict__ run_start, Row* __restrict__ run_shift,
                    int* __restrict__ run_key, int* __restrict__ nz,
                    int* __restrict__ nz_count, Row* counts) {
  extern __shared__ __align__(16) unsigned char count_smem[];
  __shared__ Row scratch[32];
  __shared__ int iscratch[32];
  Row* cnt = counts ? counts : reinterpret_cast<Row*>(count_smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  for (int n = tid; n < N; n += kGroupThreads) cnt[n] = 0;
  const Row seg = (S + kWarps - 1) / kWarps;
  const Row a = min((Row)warp * seg, S), b = min(a + seg, S);

  // 1. the runs in row order: run_start, run_key. A warp's run heads wait
  //    at the front of its rows of perm (written in step 5) until the
  //    scan gives their places.
  Row heads = 0, runs;
  walk_rows(idx, a, b, N, [&](Row r, unsigned h) {
    if (h >> lane & 1u) perm[a + heads + __popc(h & below)] = r;
    heads += __popc(h);
  });
  const Row first_run = warp_exclusive_sum<Row>(heads, scratch, runs);
  for (Row i = lane; i < heads; i += 32) {
    const Row r = perm[a + i];
    run_start[first_run + i] = r;
    run_key[first_run + i] = (int)idx[r];
  }
  __syncthreads();

  // 2. rows per index (the atomics only count)
  for (Row i = tid; i < runs; i += kGroupThreads)
    count_add(&cnt[run_key[i]],
              (i + 1 < runs ? run_start[i + 1] : S) - run_start[i]);
  __syncthreads();

  // 3. offsets, the indices with rows in ascending order, cursors
  {
    const int nseg = (N + kWarps - 1) / kWarps;
    const int na = min(warp * nseg, N), nb = min(na + nseg, N);
    Row rows = 0;
    int used = 0;
    for (int n0 = na; n0 < nb; n0 += 32 * kBatch) {
      Row c[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int n = n0 + u * 32 + lane;
        c[u] = n < nb ? cnt[n] : 0;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        rows += c[u];
        used += c[u] != 0;
      }
    }
    rows = __shfl_sync(kAll, warp_inclusive_sum(rows), 31);
    used = __shfl_sync(kAll, warp_inclusive_sum(used), 31);
    Row total;
    int used_total;
    Row at = warp_exclusive_sum<Row>(rows, scratch, total);
    int slot = warp_exclusive_sum<int>(used, iscratch, used_total);
    for (int n0 = na; n0 < nb; n0 += 32 * kBatch) {
      Row c[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int n = n0 + u * 32 + lane;
        c[u] = n < nb ? cnt[n] : 0;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int n = n0 + u * 32 + lane;
        const Row incl = warp_inclusive_sum(c[u]);
        const unsigned has = __ballot_sync(kAll, c[u] != 0);
        if (n < nb) {
          offsets[n] = at + incl - c[u];
          cnt[n] = at + incl - c[u];
          if (c[u]) nz[slot + __popc(has & below)] = n;
        }
        at += __shfl_sync(kAll, incl, 31);
        slot += __popc(has);
      }
    }
    if (tid == 0) {
      offsets[N] = S;
      *nz_count = used_total;
    }
  }
  __syncthreads();

  // 4. each run's place in its index's rows, in row order: one warp, 32
  //    runs a step, kPlaceBatch steps' loads at once; runs of one index
  //    within a step by lane order. run_shift: the place minus the start.
  if (warp == 0) {
    for (Row j0 = 0; j0 < runs; j0 += 32 * kPlaceBatch) {
      int key[kPlaceBatch];
      Row start[kPlaceBatch], len[kPlaceBatch];
#pragma unroll
      for (int u = 0; u < kPlaceBatch; ++u) {
        const Row i = j0 + u * 32 + lane;
        key[u] = -1 - lane;  // no index: a lane of its own
        start[u] = len[u] = 0;
        if (i < runs) {
          key[u] = run_key[i];
          start[u] = run_start[i];
          len[u] = (i + 1 < runs ? run_start[i + 1] : S) - start[u];
        }
      }
#pragma unroll
      for (int u = 0; u < kPlaceBatch; ++u) {
        const Row i = j0 + u * 32 + lane;
        const unsigned peers = __match_any_sync(kAll, key[u]);
        const unsigned lower = peers & below;
        Row before = 0;  // rows of this index's runs in lower lanes
        if (__any_sync(kAll, lower != 0)) {
#pragma unroll
          for (int l = 0; l < 32; ++l) {
            const Row v = __shfl_sync(kAll, len[u], l);
            if (lower >> l & 1u) before += v;
          }
        }
        const Row base = i < runs ? cnt[key[u]] : 0;
        __syncwarp();
        if (i < runs) {
          run_shift[i] = base + before - start[u];
          if ((peers >> lane) == 1u) cnt[key[u]] = base + before + len[u];
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();

  // 5. perm: each warp writes the rows of an equal share of the runs, 32
  //    runs a step, one run at a time across the lanes
  const Row share = (runs + kWarps - 1) / kWarps;
  const Row ja = min((Row)warp * share, runs), jb = min(ja + share, runs);
  for (Row j0 = ja; j0 < jb; j0 += 32) {
    const Row i = j0 + lane;
    Row start = 0, len = 0, shift = 0;
    if (i < jb) {
      start = run_start[i];
      len = (i + 1 < runs ? run_start[i + 1] : S) - start;
      shift = run_shift[i];
    }
    const int n = (int)min((Row)32, jb - j0);
    for (int l = 0; l < n; ++l) {
      const Row s0 = __shfl_sync(kAll, start, l);
      const Row ln = __shfl_sync(kAll, len, l);
      const Row to = __shfl_sync(kAll, shift, l) + s0;
      for (Row q = lane; q < ln; q += 32) perm[to + q] = s0 + q;
    }
  }
}

// ----------------------------------------------------------------- sum ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int V>
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  if constexpr (V == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                     smem_u32(dst)),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                     smem_u32(dst)),
                 "l"(src)
                 : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// V: floats a copy (4: 16 bytes, when F, the row stride and g allow; else
// 1). A work item is one index's rows over a slab of features: the slabs
// split F so that the items fill the grid, down to kMinSlab features and
// up to kSlab. Row r of a tile sits at stage + r * slab.
template <int V, typename Row>
__global__ void __launch_bounds__(kSumThreads)
embedding_bwd_sum(const float* __restrict__ g, long long ldg,
                  const Row* __restrict__ offsets, const Row* __restrict__ perm,
                  const int* __restrict__ nz, const int* __restrict__ nz_count,
                  float* __restrict__ dw, int N, int F) {
  // floats a tile (a quarter of the stage for 4-byte copies, so that a
  // thread's copies stay in registers)
  constexpr int kTile = V == 4 ? kStageFloats : kStageFloats / 4;
  constexpr int kCopies = kTile / V / kSumThreads;  // a thread's, a tile
  extern __shared__ __align__(16) float ring[];  // [kStages][kStageFloats]
  const int tid = threadIdx.x;
  const int K = *nz_count;
  // the table rows no index names (while K is in flight)
  for (int n = blockIdx.x; n < N; n += gridDim.x)
    if (offsets[n] == offsets[n + 1])
      for (int f = tid; f < F; f += kSumThreads)
        dw[(long long)n * F + f] = 0.0f;
  int slabs = K > 0 ? (int)gridDim.x / K : 1;
  slabs = min(slabs, (F + kMinSlab - 1) / kMinSlab);
  slabs = max(slabs, (F + kSlab - 1) / kSlab);
  slabs = max(slabs, 1);
  const int slab = ((F + slabs - 1) / slabs + V - 1) / V * V;
  slabs = (F + slab - 1) / slab;
  const int tile_rows = kTile / slab;
  const long long items = (long long)K * slabs;
  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    const int n = nz[it / slabs];
    const int f0 = (int)(it % slabs) * slab;
    const int fb = min(slab, F - f0);
    const int chunks = fb / V;  // copies a row
    // copy c of a tile: row r0 + c * dr (+ 1 on a carry), float k0 + ...
    const int r0 = tid / chunks, k0 = tid - r0 * chunks;
    const int dr = kSumThreads / chunks, dk = kSumThreads - dr * chunks;
    const Row* rows = perm + offsets[n];
    const Row count = offsets[n + 1] - offsets[n];
    const long long tiles = (count + tile_rows - 1) / tile_rows;
    auto tile_len = [&](long long t) {
      return (int)min((Row)tile_rows, count - (Row)t * tile_rows);
    };
    // the source rows of this thread's copies of tile t
    Row src[kCopies];
    auto fetch = [&](long long t) {
      if (t >= tiles) return;
      const Row* q = rows + (Row)t * tile_rows;
      const int len = tile_len(t);
      int r = r0, k = k0;
#pragma unroll
      for (int c = 0; c < kCopies; ++c) {
        if (r < len) src[c] = q[r];
        r += dr;
        k += dk;
        if (k >= chunks) k -= chunks, ++r;
      }
    };
    auto issue = [&](long long t) {
      if (t < tiles) {
        float* stage = ring + (t % kStages) * kStageFloats;
        const int len = tile_len(t);
        int r = r0, k = k0;
#pragma unroll
        for (int c = 0; c < kCopies; ++c) {
          if (r < len)
            copy_async<V>(stage + r * slab + k * V,
                          g + (long long)src[c] * ldg + f0 + k * V);
          r += dr;
          k += dk;
          if (k >= chunks) k -= chunks, ++r;
        }
      }
      copy_commit();
    };
    float acc[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) acc[j] = 0.0f;
    for (int s = 0; s < kStages - 1; ++s) {
      fetch(s);
      issue(s);
    }
    fetch(kStages - 1);
    for (long long t = 0; t < tiles; ++t) {
      copy_wait<kStages - 2>();
      __syncthreads();  // tile t landed; tile t - 1's stage is free
      issue(t + kStages - 1);
      fetch(t + kStages);  // in flight while tile t is added
      const float* stage = ring + (t % kStages) * kStageFloats;
      const int len = tile_len(t);
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        const int f = tid + j * kSumThreads;
        if (f < fb) {
          float a = acc[j];
#pragma unroll 16
          for (int r = 0; r < len; ++r) a += stage[r * slab + f];
          acc[j] = a;
        }
      }
    }
    copy_wait<0>();
    __syncthreads();  // the ring is free for the next item
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int f = tid + j * kSumThreads;
      if (f < fb) dw[(long long)n * F + f0 + f] = acc[j];
    }
  }
}

// ---------------------------------------------------------------- host ----

size_t align16(size_t b) { return (b + 15) & ~(size_t)15; }

// The workspace's pieces, in order, for S rows over N table rows.
template <typename Row>
struct Layout {
  Row *offsets, *perm, *run_start, *run_shift, *counts;
  int *run_key, *nz, *nz_count;
  size_t bytes;
  Layout(unsigned char* base, long long S, int N) {
    size_t at = 0;
    auto take = [&](size_t b) {
      unsigned char* p = base ? base + at : nullptr;
      at += align16(b);
      return p;
    };
    offsets = reinterpret_cast<Row*>(take(((size_t)N + 1) * sizeof(Row)));
    perm = reinterpret_cast<Row*>(take((size_t)S * sizeof(Row)));
    run_start = reinterpret_cast<Row*>(take((size_t)S * sizeof(Row)));
    run_shift = reinterpret_cast<Row*>(take((size_t)S * sizeof(Row)));
    run_key = reinterpret_cast<int*>(take((size_t)S * sizeof(int)));
    nz = reinterpret_cast<int*>(take((size_t)N * sizeof(int)));
    nz_count = reinterpret_cast<int*>(take(sizeof(int)));
    const bool global = (size_t)N * sizeof(Row) > kSmemCountBytes;
    counts = global ? reinterpret_cast<Row*>(take((size_t)N * sizeof(Row)))
                    : nullptr;
    bytes = at;
  }
};

constexpr int kRingBytes = kStages * kStageFloats * (int)sizeof(float);
constexpr int kMaxDevices = 64;
int g_sms[kMaxDevices];  // a device's SM count, once its kernels are set up

// The kernels' shared-memory limits, once a device.
template <typename Row>
cudaError_t set_limits() {
  cudaError_t err = cudaFuncSetAttribute(
      embedding_bwd_group<Row>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemCountBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(embedding_bwd_sum<4, Row>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kRingBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(embedding_bwd_sum<1, Row>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kRingBytes);
  return err;
}

template <typename Row>
int launch(const float* g, long long ldg, const long long* idx, float* dw,
           unsigned char* ws, long long S, int N, int F, int sms,
           cudaStream_t stream) {
  Layout<Row> L(ws, S, N);
  const int count_smem = L.counts ? 0 : (int)((size_t)N * sizeof(Row));
  embedding_bwd_group<Row><<<1, kGroupThreads, count_smem, stream>>>(
      idx, (Row)S, N, L.offsets, L.perm, L.run_start, L.run_shift, L.run_key,
      L.nz, L.nz_count, L.counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const bool vec4 = F % 4 == 0 && ldg % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(g) % 16 == 0;
  // work items: at most min(N, S) indices times their slabs
  const long long items =
      (S < N ? S : (long long)N) * ((F + kMinSlab - 1) / kMinSlab);
  const long long most = (long long)sms * kSumCtasPerSm;
  long long grid = items > N ? items : N;
  if (grid > most) grid = most;
  auto sum = vec4 ? embedding_bwd_sum<4, Row> : embedding_bwd_sum<1, Row>;
  sum<<<(int)grid, kSumThreads, kRingBytes, stream>>>(
      g, ldg, L.offsets, L.perm, L.nz, L.nz_count, dw, N, F);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of workspace embedding_bwd needs for S rows over an N-row table.
extern "C" long long embedding_bwd_workspace_bytes(long long S, int N) {
  return S < kIntRows ? (long long)Layout<int>(nullptr, S, N).bytes
                      : (long long)Layout<long long>(nullptr, S, N).bytes;
}

// g [S, F] fp32 rows ldg floats apart (last stride 1), idx [S] int64, dw
// [N, F] fp32 (every row written), ws embedding_bwd_workspace_bytes(S, N)
// bytes. Returns a cudaError_t code (0 = launched).
extern "C" int embedding_bwd(int device, const void* g, long long ldg,
                             const void* idx, void* dw, void* ws, long long S,
                             int N, int F, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (N <= 0 || S < 0 || F <= 0 || F > 8192) return (int)cudaErrorInvalidValue;
  int sms = device >= 0 && device < kMaxDevices ? g_sms[device] : 0;
  if (sms == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err == cudaSuccess) err = set_limits<int>();
    if (err == cudaSuccess) err = set_limits<long long>();
    if (err != cudaSuccess) return (int)err;
    if (device >= 0 && device < kMaxDevices) g_sms[device] = sms;
  }
  auto args = [&](auto row) {
    using Row = decltype(row);
    return launch<Row>(static_cast<const float*>(g), ldg,
                       static_cast<const long long*>(idx),
                       static_cast<float*>(dw),
                       static_cast<unsigned char*>(ws), S, N, F, sms,
                       static_cast<cudaStream_t>(stream));
  };
  return S < kIntRows ? args(0) : args(0LL);
}

extern "C" const char* embedding_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
