// Per-expert L-layer MLP chain, fp32, for Hopper (sm_90a), on the tensor
// cores in split precision ("3xTF32"): every fp32 chain kernel. The
// forward, K1 (expert_chain.cu, rows in place), K3 (fused_dispatch.cu,
// rows gathered through the slot->token map) and K1R (ragged_chain.cu,
// expert-sorted rows); the backward, K2 (expert_chain_bwd.cu), K4
// (fused_dispatch_bwd.cu) and K2R (ragged_chain_bwd.cu). Both are
// templated on the row source (rows.cuh).
//
// Replaces the fp32 case of the Pallas _fwd_kernel and _bwd_kernel of
// switch_nerf_tpu/ops/expert_kernel.py (K1, K2) and ops/fused_dispatch.py
// (K3, K4): Building and Mission Bay under --no_amp; and of the JAX
// package's ExpertMLP.ragged (switch_nerf_tpu/models/experts.py:79, one
// jax.lax.ragged_dot per layer) and its autograd: Bungee's training path.
// One 32,768-row chunk at E4 M256 L7 is 2*N*M^2*L = 30.1 GFLOP forward
// and 60.1 GFLOP for the gradient's products, against ~75 MB of rows, W
// and gradients: bound by operations. On the CUDA cores (67 TFLOP/s)
// that is 0.449 / 0.898 ms.
// A single TF32 product keeps ~11 bits and misses the fp32 limit (1e-4
// against the plain chain). Split each operand a into hi = rna_tf32(a) and
// lo = rna_tf32(a - hi) and sum hi*hi' + hi*lo' + lo*hi' (lo*lo' ~ 2^-22
// relative is dropped): the error stays near fp32's, at three TF32
// products, a bound of 3 * FLOPs / 494.7 TFLOP/s = 0.182 / 0.365 ms. The
// tensor cores add each k8 block into their accumulator with truncation,
// so a long chain of products in one accumulator drifts (well past the
// plain chain's error against float64 over one layer on an H100): every
// stage's products go into a fresh accumulator, small before large, which
// is then added to the running sum by a rounded fp32 add.
//
// wgmma takes tf32 operands from shared memory only K-major (the transpose
// bits exist for 16-bit types only), so:
//  - A comes from registers: each thread loads its fragment of the fp32
//    activation tile from shared memory and splits it there.
//  - B (the weights) is split once per call by tf32_split_weights into a
//    workspace: W_l^T for the forward (its K-major B) or W_l as stored for
//    the backward (the K-major B of gh = G_l W_l^T), as hi and lo arrays
//    [2, L*E, M, M] (2 x 7.3 MB at E4 M256 L7). A producer warp streams
//    them through an mbarrier ring of TMA loads (16 k a stage, hi and lo,
//    64-byte swizzle), running ahead across layers.
//
// Forward (chain_fwd_tf32: K1, K3, K1R): one CTA owns 64 rows of one
// expert. fp32 doubles shared memory, so 128 rows with
// h and xin (2 x 128 KB) do not fit in 227 KB: the CTA holds the 64-row
// tile h in shared memory (fp32, row stride M + 4 floats: the A-fragment
// loads are free of bank conflicts) and two consumer warpgroups each
// produce half of the output columns (m64n{M/2}k8), so each thread keeps
// its skip input xin in registers beside its accumulators. Budget at
// M = 256: W ring 4 x 32 KB + h 65 KB (+ ReLU masks, 2 KB a layer, in the
// backward) = 194 KB (211 KB at L = 7). Rows come in by a cp.async copy
// (K3's and K4's: the token rows the slot map names) zero-filled past the
// expert's last row and leave by stores that stop there. K1's, K3's and
// K4's grid is (ceil(C / 64), E), K1R's and K2R's (ceil(N / 64), E), a CTA
// past its expert's rows exiting at once. Per layer, in the plain chain's
// order: z = h W_l + b_l, skip: z += xin, xin = z; ReLU
// unless last; the two warpgroups meet at a named barrier before and after
// rewriting h.
//
// Backward pass 1 (chain_bwd_tf32), on the same 64-row tiles, ring and
// warpgroups: the recompute of layers 0..L-2 runs on the CUDA cores in the
// plain chain's summation order, so its ReLU masks are the plain version's
// bit for bit (a 3xTF32 recompute flips the masks of activations within
// ~1e-7 of zero, and a flipped mask moves a whole row of dx: see the note
// at the pass); it writes each layer's input H_l to hsave [L, ws_rows, M]
// and keeps the masks as bits in shared memory. The reverse sweep then
// runs on the 3xTF32 mainloop with B = W_l: g (+ gxin) masked, gxin
// updated, G_l to shared memory, transposed and split into gsave
// [2, L, M, ws_rows] (hi, lo: the K-major B of pass 2), gh = G_l W_l^T;
// dx = gh + gxin. gxin waits between skip layers in the thread's own
// elements of dx (the registers hold acc, a stage's accumulator and the A
// fragments); nothing else is read back from device memory.
//
// Every row source (rows.cuh) runs this pass. In place (K2) and gathered
// (K4: the producer's cp.async copy reads the token rows the slot map
// names) the layout is padded [E, C, M]: expert e's workspace segment
// starts at e * padded_seg_rows(C), C rounded up to whole 64-row tiles, so
// a tile's rows past C stay in its own segment (zero gradients there, as
// past a ragged expert's rows). Their ReLU masks stay bits in shared
// memory up to bwd_max_layers, as K2R's; deeper chains read each layer's
// mask back from hsave's H_{l+1} > 0 (the same bit: H_{l+1} is the ReLU's
// output, skip input added first), so they take 32 layers at every width.
//
// Width 512 (Mission Bay's trunk under --no_amp). The M = 256 layout does
// not fit: the 64-row fp32 tile is 132,096 B and the W ring 131,072 B,
// over the 232,448 B a block has; each consumer's M/2 = 256 columns would
// need 128 accumulators a thread, 128 more for the stage's fresh sum and
// 128 for xin, over the 232-register budget. So at M = 512 each layer runs
// in four passes of 128 columns (TCfg::kPasses): in pass p both consumer
// warpgroups produce columns 128p .. 128p + 127, 64 each (m64n64k8), over
// the whole k = 0 .. 511 of h. A stage holds 16 k of 128 columns (16 KB)
// and the ring four of them (64 KB): ring + tile = 196 KB, + 4 KB of ReLU
// masks a layer in the backward (223 KB at L = 7; bwd_max_layers 9).
// h may be rewritten only after every pass has read it whole, so the
// earlier passes' results wait: in the forward in registers (4 x 32 a
// thread), with the skip input out of the registers, in the thread's own
// elements of out (x until the first skip layer; K3's x is the token
// array, so K3 writes the gathered tile to out once after the load), as
// the backward keeps gxin in dx; in the backward's recompute in hsave's
// layer l + 1 (written
// there anyway) and in its sweep in the tile's block of gsave's layer
// l - 1 (written there only later), each read back by the thread that
// wrote it. Two passes of 256 columns (32 KB stages, two of them) held
// 2 x 64 accumulators and spilled ~2 KB a thread in both kernels, and so
// did the held accumulators of the backward's sweep at 128 columns; the
// layout above spills nothing. Pass 2 and the reduction are width-generic
// (128 x 128 dW tiles). PERF.md has the times.
//
// Backward pass 2 (chain_dw_tf32): dW_l = H_l^T G_l over rows. One CTA per
// (128 x 128 dW tile, chunk of kChunkRows rows, layer) (rows.cuh: the
// ragged chunks from the counts, the padded layout's E x ceil(C / 2048)
// from C: 16 x 16 x 7 = 1,792 CTAs at E8 C4096 M512 L7): A = H_l^T
// from registers (TMA-loaded H tiles, split per thread), B = G_l^T hi / lo
// by TMA; db = the column sums of G_l (hi + lo) from the same stages.
// Partial sums per chunk, then reduce_partials (rows.cuh) in ascending
// chunk order: no atomics, the same bits on every run, exact zeros for an
// expert with no rows.
#pragma once

#include <type_traits>

#include "chain_sm90.cuh"

namespace tf32 {

using namespace sm90;  // PTX helpers: mbarrier, TMA, wgmma fences, setmaxnreg

constexpr int kWg = 128;                // one warpgroup
constexpr int kThreads = 3 * kWg;       // producer + two consumers
constexpr int kRows = 64;               // rows of one expert per CTA
constexpr int kStageK = 16;             // k per W stage: rows of 64 bytes
constexpr int kRingBytes = 131072;      // the W ring
constexpr int kMaxStages = 8;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
static_assert(kRows == kPadSegRows, "padded workspace segments: whole tiles");

// ------------------------------------------------------------- split ----
__device__ __forceinline__ uint32_t rna_tf32(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(a));
  return r;
}

// a = hi + lo (+ ~2^-22 |a|), both tf32.
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = rna_tf32(a);
  lo = rna_tf32(a - __uint_as_float(hi));
}

// D[64 x N] (+)= A[64 x 8] B[8 x N], tf32 in, fp32 accumulate; A from
// registers (thread t: rows 16w + t%32/4 (+8), k t%4 (+4)), B K-major from
// shared memory.
template <int N>
struct WgmmaTf32;

template <>
struct WgmmaTf32<32> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaTf32<64> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaTf32<128> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaTf32<256> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};
// ------------------------------------------------- shared layout ----
// A pass: the output columns the two consumer warpgroups produce in one
// sweep over k (every column up to M = 256; a quarter of them at M = 512).
template <int M>
struct TCfg {
  static constexpr int kPassN = M <= 256 ? M : 128;  // columns of a pass
  static constexpr int kPasses = M / kPassN;         // 4 at M = 512
  static constexpr int kNW = kPassN / 2;             // a consumer's, a pass
  static constexpr int kAcc = kNW / 2;               // fp32 a thread
  static constexpr int kLd = M + 4;                  // h row stride, floats
  static constexpr int kHBytes = kRows * kLd * 4;
  static constexpr int kHalfBytes = kPassN * kStageK * 4;  // hi or lo
  static constexpr int kStageBytes = 2 * kHalfBytes;
  static constexpr int kRing = kPasses == 1 ? kRingBytes : 65536;
  static constexpr int kStages = kRing / kStageBytes < kMaxStages
                                     ? kRing / kStageBytes
                                     : kMaxStages;
  static constexpr int kKChunks = M / kStageK;
  static constexpr int kMaskWords = M / 32;          // mask words a row
  static constexpr int kMaskLayer = kRows * kMaskWords;  // bits [row][col]
  // the backward's recompute (CUDA cores): kRPassN output columns a pass;
  // a consumer thread takes 8 rows by kRCols columns, kRGroups groups of
  // kRVec adjacent ones (one vector load of W a group and k)
  static constexpr int kRPassN = M < 256 ? M : 256;
  static constexpr int kRPasses = M / kRPassN;       // 2 at M = 512
  static constexpr int kRCols = kRPassN / 32;
  static constexpr int kRVec = kRCols < 4 ? kRCols : 4;
  static constexpr int kRGroups = kRCols / kRVec;
  static_assert(kRPassN * kStageK * 4 <= kStageBytes, "a pass fits a stage");
};

// Offsets inside the (1024-aligned) dynamic shared memory of a chain CTA.
template <int M>
struct TSmem {
  int ring, h, mask, bars, bytes;
  __host__ __device__ TSmem(int L, bool masks) {
    using C = TCfg<M>;
    ring = 0;
    h = ring + C::kStages * C::kStageBytes;
    mask = h + C::kHBytes;
    bars = mask + (masks ? (L - 1) * C::kMaskLayer * 4 : 0);
    bytes = bars + (2 * C::kStages + 1) * 8 + 1024;  // + alignment slack
  }
};

// The most layers whose ReLU masks (L - 1 layers of bits) fit the
// backward's pass 1 shared memory on this device: 17 at M = 256, 9 at
// M = 512 on an H100. K2R's depth limit; in place and gathered launches
// read deeper chains' masks back from hsave.
template <int M>
inline int max_layers(int device) {
  int limit = 0;
  if (cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  int L = 0;
  while (L < 32 && TSmem<M>(L + 1, true).bytes <= limit) ++L;
  return L;
}

inline int bwd_max_layers(int device, int M) {
  switch (M) {
    case 64:
      return max_layers<64>(device);
    case 128:
      return max_layers<128>(device);
    case 256:
      return max_layers<256>(device);
    case 512:
      return max_layers<512>(device);
    default:
      return 0;
  }
}

// ----------------------------------------------------------- weights ----
// wsplit [2, L*E, M, M] fp32 holding tf32 values, the hi and lo of W_l^T
// (row n holds column n of W_l: the forward's B) or, with `as_stored`, of
// W_l itself (the B of the backward's gh = G_l W_l^T). A 32 x 32 tile per
// CTA, transposed through shared memory: W read once, the split written
// once.
__global__ void __launch_bounds__(256)
tf32_split_weights(const float* __restrict__ w, float* __restrict__ wsplit,
                   int LE, int M, int as_stored) {
  __shared__ float tile[32][33];
  const long long mm = (long long)M * M;
  const float* src = w + blockIdx.z * mm;
  float* hi_out = wsplit + blockIdx.z * mm;
  float* lo_out = wsplit + ((long long)LE + blockIdx.z) * mm;
  const int tx = threadIdx.x, k0 = blockIdx.y * 32, n0 = blockIdx.x * 32;
  for (int ty = threadIdx.y; ty < 32; ty += 8)
    tile[ty][tx] = src[(long long)(k0 + ty) * M + n0 + tx];
  __syncthreads();
  for (int ty = threadIdx.y; ty < 32; ty += 8) {
    long long at;
    float v;
    if (as_stored) {
      at = (long long)(k0 + ty) * M + n0 + tx;
      v = tile[ty][tx];
    } else {  // [n][k]
      at = (long long)(n0 + ty) * M + k0 + tx;
      v = tile[tx][ty];
    }
    uint32_t hi, lo;
    split(v, hi, lo);
    hi_out[at] = __uint_as_float(hi);
    lo_out[at] = __uint_as_float(lo);
  }
}

// ----------------------------------------------------------- producer ----
// Stream k chunk kc (16 k) of the split weights of block z (sel * L*E +
// l * E + e; lo at z + L*E), rows n0 .. n0 + kPassN (one pass's output
// columns), into the next ring stage: hi then lo, each kPassN rows of 64
// bytes. Waits for the stage to be free, which a fresh ring's first
// kStages stages are.
template <int M>
__device__ __forceinline__ void produce_w(const CUtensorMap* w_map,
                                          uint8_t* ring, uint64_t* full,
                                          uint64_t* empty, int z, int LE,
                                          int kc, int n0, int& stage,
                                          uint32_t& phase) {
  using C = TCfg<M>;
  mbar_wait(&empty[stage], phase ^ 1);
  mbar_expect_tx(&full[stage], C::kStageBytes);
  uint8_t* dst = ring + stage * C::kStageBytes;
  tma_load(dst, w_map, &full[stage], kc * kStageK, n0, z);
  tma_load(dst + C::kHalfBytes, w_map, &full[stage], kc * kStageK, n0,
           z + LE);
  if (++stage == C::kStages) {
    stage = 0;
    phase ^= 1;
  }
}

// Rows [row0, row0 + 64) of expert er's rows into h (row stride kLd) by
// cp.async, by producer thread t; zeros past the expert's last row (from a
// valid address). Row r of the expert is x's row er.base + r, or with
// kGather the token row idx[er.base + r] of x [n_src, M]: an index out of
// range stops the kernel (device-side assert).
template <int M, int SRC>
__device__ __forceinline__ void copy_rows_in(float* h, const float* x,
                                             const int* idx, int n_src,
                                             const ExpertRows& er, int row0,
                                             int t) {
  constexpr int kChunks = M / 4;  // 16-byte chunks a row
#pragma unroll 4
  for (int i = t; i < kRows * kChunks; i += kWg) {
    const int r = i / kChunks, ch = i % kChunks;
    const bool in = row0 + r < er.count;
    long long row = er.base + row0 + r;
    if (SRC == kGather && in) {
      row = idx[row];
      if (row < 0 || row >= n_src) __trap();
    }
    const float* src = in ? x + row * M + ch * 4 : x;
    cp_async16(smem_u32(h + r * TCfg<M>::kLd + ch * 4), src, in ? 16u : 0u);
  }
}

// ----------------------------------------------------------- consumer ----
// Accumulator element (4j + 2half + i) of consumer thread t sits at row
// 16*warp + lane/4 + 8*half of the tile and column col0 + 8j +
// 2*(lane%4) + i, where col0 = p * kPassN + cw * kNW is the first column
// of warpgroup cw in pass p.

// acc = h @ B for one layer over this warpgroup's kNW output columns of a
// pass: A is the whole 64-row tile h (fp32, split in registers), B the
// split weights of the pass's columns streamed through the ring. One stage = two k8 steps of three products.
// The tensor cores add each k8 block into the accumulator with truncation
// (on an H100, chaining all 96 products of a layer into one accumulator
// left several times the plain fp32 chain's error against float64), so
// each stage sums into a fresh accumulator, the small products (hi*lo,
// lo*hi) before the large (hi*hi), and is added to acc with a rounded fp32
// add: the plain chain's error against float64, measured.
template <int M>
__device__ __forceinline__ void tf32_product(float (&acc)[TCfg<M>::kAcc],
                                             const float* h, uint32_t ring,
                                             uint64_t* full, uint64_t* empty,
                                             int& stage, uint32_t& phase,
                                             int cw, int t) {
  using C = TCfg<M>;
  float part[C::kAcc];
  const int lane = t & 31;
  const float* h0 = h + ((t >> 5) * 16 + (lane >> 2)) * C::kLd + (lane & 3);
  const float* h1 = h0 + 8 * C::kLd;
#pragma unroll 1
  for (int kc = 0; kc < C::kKChunks; ++kc) {
    uint32_t ahi[2][4], alo[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int k = kc * kStageK + ks * 8;
      split(h0[k], ahi[ks][0], alo[ks][0]);
      split(h1[k], ahi[ks][1], alo[ks][1]);
      split(h0[k + 4], ahi[ks][2], alo[ks][2]);
      split(h1[k + 4], ahi[ks][3], alo[ks][3]);
    }
    mbar_wait(&full[stage], phase);
    const uint32_t b = ring + stage * C::kStageBytes + cw * C::kNW * 64;
    fence_acc(part);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const uint64_t bhi = desc_kmajor64(b + ks * 32);
      const uint64_t blo = desc_kmajor64(b + C::kHalfBytes + ks * 32);
      WgmmaTf32<C::kNW>::mma(part, ahi[ks], blo, ks != 0);
      WgmmaTf32<C::kNW>::mma(part, alo[ks], bhi, 1);
    }
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
      WgmmaTf32<C::kNW>::mma(part, ahi[ks], desc_kmajor64(b + ks * 32), 1);
    wg_commit();
    wg_wait<0>();
    fence_acc(part);
    mbar_arrive(&empty[stage]);
#pragma unroll
    for (int i = 0; i < C::kAcc; ++i) acc[i] = kc ? acc[i] + part[i] : part[i];
    if (++stage == C::kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
}

// The forward epilogue of layer l for this thread's elements, in the plain
// chain's order: z = acc + b_l; skip: z += xin, ReLU unless last, xin = z;
// else ReLU unless last. z is left in acc and, unless last, written to h.
template <int M>
__device__ __forceinline__ void fwd_epilogue(float (&acc)[TCfg<M>::kAcc],
                                             float (&xin)[TCfg<M>::kAcc],
                                             float* h, const float* bias,
                                             bool skip, bool last, int col0,
                                             int t) {
  using C = TCfg<M>;
  const int lane = t & 31;
  const int r0 = (t >> 5) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < C::kNW / 8; ++j) {
    const int c = col0 + 8 * j + 2 * (lane & 3);
    const float2 b2 = __ldg(reinterpret_cast<const float2*>(bias + c));
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = 4 * j + 2 * half;
      float z0 = acc[i] + b2.x, z1 = acc[i + 1] + b2.y;
      if (skip) {
        z0 += xin[i];
        z1 += xin[i + 1];
      }
      if (!last) {
        z0 = fmaxf(z0, 0.0f);
        z1 = fmaxf(z1, 0.0f);
      }
      if (skip) {
        xin[i] = z0;
        xin[i + 1] = z1;
      }
      acc[i] = z0;
      acc[i + 1] = z1;
      if (!last)
        *reinterpret_cast<float2*>(h + (r0 + 8 * half) * C::kLd + c) =
            make_float2(z0, z1);
    }
  }
}

// Move this thread's elements (columns from col0) between v and rows
// base + row0 .. of a [., M] array: LOAD zero-fills rows at or past
// `count`, a store skips them (count = kRows: every row of the tile).
template <int M, bool LOAD>
__device__ __forceinline__ void move_rows(float (&v)[TCfg<M>::kAcc],
                                          float* mem, long long base,
                                          int row0, int count, int col0,
                                          int t) {
  using C = TCfg<M>;
  const int lane = t & 31;
  const int r0 = (t >> 5) * 16 + (lane >> 2);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    const bool in = row0 + r < count;
    float* row = mem + (base + row0 + r) * M + col0 + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < C::kNW / 8; ++j) {
      const int i = 4 * j + 2 * half;
      float2* p = reinterpret_cast<float2*>(row + 8 * j);
      if (LOAD) {
        const float2 f = in ? *p : make_float2(0.0f, 0.0f);
        v[i] = f.x;
        v[i + 1] = f.y;
      } else if (in) {
        *p = make_float2(v[i], v[i + 1]);
      }
    }
  }
}

// This thread's elements of h (columns from col0) -> v.
template <int M>
__device__ __forceinline__ void read_tile(float (&v)[TCfg<M>::kAcc],
                                          const float* h, int col0, int t) {
  using C = TCfg<M>;
  const int lane = t & 31;
  const int r0 = (t >> 5) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < C::kNW / 8; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float2 f = *reinterpret_cast<const float2*>(
          h + (r0 + 8 * half) * C::kLd + col0 + 8 * j + 2 * (lane & 3));
      v[4 * j + 2 * half] = f.x;
      v[4 * j + 2 * half + 1] = f.y;
    }
}

// Move this thread's elements (columns from col0) between v and the tile's
// block of a [M, ws_rows] workspace layer (element (r, c) at c * ws_rows +
// ws_row0 + r): where the sweep's earlier passes wait at M = 512.
template <int M, bool LOAD>
__device__ __forceinline__ void move_held(float (&v)[TCfg<M>::kAcc],
                                          float* layer, long long ws_rows,
                                          long long ws_row0, int col0,
                                          int t) {
  using C = TCfg<M>;
  const int lane = t & 31;
  const long long r0 = ws_row0 + (t >> 5) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < C::kNW / 8; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        float* at = layer + (long long)(col0 + 8 * j + 2 * (lane & 3) + q) *
                                ws_rows + r0 + 8 * half;
        if (LOAD)
          v[4 * j + 2 * half + q] = *at;
        else
          *at = v[4 * j + 2 * half + q];
      }
}

// The tile's G_l (in h) -> gsave's hi and lo layers [M, ws_rows], columns
// ws_row0 .. + 64: consumer warp cw*4 + t/32 takes columns n of h in steps
// of 8, each lane rows lane and lane + 32 (128-byte stores).
template <int M>
__device__ __forceinline__ void store_g_transposed(const float* h, float* ghi,
                                                   float* glo,
                                                   long long ws_rows,
                                                   long long ws_row0, int cw,
                                                   int t) {
  const int warp = cw * 4 + (t >> 5), lane = t & 31;
#pragma unroll 4
  for (int n = warp; n < M; n += 8) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = lane + 32 * half;
      uint32_t hi, lo;
      split(h[r * TCfg<M>::kLd + n], hi, lo);
      const long long at = (long long)n * ws_rows + ws_row0 + r;
      ghi[at] = __uint_as_float(hi);
      glo[at] = __uint_as_float(lo);
    }
  }
}

// ------------------------------------------------------- K1, K3, K1R ----
// w_map over the split weights [2, L*E, M, M] (W_l^T hi, lo). The rows
// (rows.cuh): kRagged x, out [N, M] sorted by expert with idx the counts
// [E]; in place x, out [E, cap, M]; kGather the token rows x [n_src, M]
// that idx [E * cap] names, out [E, cap, M].
template <int M, int SRC>
__global__ void __launch_bounds__(kThreads, 1)
chain_fwd_tf32(const __grid_constant__ CUtensorMap w_map,
               const float* __restrict__ x, const int* __restrict__ idx,
               int n_src, const float* __restrict__ bs,
               float* __restrict__ out, int E, int cap, int L,
               unsigned skip_mask) {
  using C = TCfg<M>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const TSmem<M> lay(L, false);
  uint8_t* ring = smem + lay.ring;
  float* h = reinterpret_cast<float*>(smem + lay.h);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bars);
  uint64_t* empty = full + C::kStages;
  uint64_t* x_full = empty + C::kStages;

  const int e = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const ExpertRows er = expert_rows<SRC>(idx, e, cap);
  if (row0 >= er.count) return;  // past its rows
  const int LE = L * E;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * kWg);
    }
    mbar_init(x_full, kWg);
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < kWg) {  // producer
    constexpr int K = C::kKChunks;
    const int t = threadIdx.x;
    int stage = 0;
    uint32_t phase = 0;
    auto load_w = [&](int j) {  // W stage j: layer, pass, k chunk
      produce_w<M>(&w_map, ring, full, empty, (j / (C::kPasses * K)) * E + e,
                   LE, j % K, (j / K) % C::kPasses * C::kPassN, stage,
                   phase);
    };
    const int n_w = L * C::kPasses * K;
    copy_rows_in<M, SRC>(h, x, idx, n_src, er, row0, t);
    int j = 0;
    if (t == 0)  // a fresh ring: these do not block
      for (; j < n_w && j < C::kStages; ++j) load_w(j);
    cp_async_wait_all();
    mbar_arrive(x_full);
    regs_dec<kProducerRegs>();
    if (t == 0)
      for (; j < n_w; ++j) load_w(j);
  } else {  // consumers
    regs_inc<kConsumerRegs>();
    const int cw = threadIdx.x / kWg - 1;
    const int t = threadIdx.x % kWg;
    // one pass: the skip input in registers; more: in this thread's own
    // elements of out, and until the first skip layer in x's (in place,
    // ragged) or, gathered, in out's, where it is written after the load
    float acc[C::kPasses][C::kAcc], xin[C::kPasses == 1 ? C::kAcc : 1];
    bool xin_in_out = SRC == kGather;
    int stage = 0;
    uint32_t phase = 0;
    mbar_wait(x_full, 0);
    if constexpr (C::kPasses == 1) {
      read_tile<M>(xin, h, cw * C::kNW, t);
    } else if (SRC == kGather && skip_mask != 0) {
#pragma unroll
      for (int p = 0; p < C::kPasses; ++p) {
        const int col0 = p * C::kPassN + cw * C::kNW;
        float xp[C::kAcc];
        read_tile<M>(xp, h, col0, t);
        move_rows<M, false>(xp, out, er.base, row0, er.count, col0, t);
      }
    }
    for (int l = 0; l < L; ++l) {
      const bool last = l == L - 1;
      const bool skip = (skip_mask >> l) & 1u;
#pragma unroll
      for (int p = 0; p < C::kPasses; ++p)
        tf32_product<M>(acc[p], h, smem_u32(ring), full, empty, stage,
                        phase, cw, t);
      named_sync(1, 2 * kWg);  // every read of h is done
      const float* bias = bs + ((size_t)l * E + e) * M;
#pragma unroll
      for (int p = 0; p < C::kPasses; ++p) {
        const int col0 = p * C::kPassN + cw * C::kNW;
        if constexpr (C::kPasses == 1) {
          fwd_epilogue<M>(acc[p], xin, h, bias, skip, last, col0, t);
        } else {
          float xp[C::kAcc];
          if (skip)
            move_rows<M, true>(xp, xin_in_out ? out : const_cast<float*>(x),
                               er.base, row0, er.count, col0, t);
          fwd_epilogue<M>(acc[p], xp, h, bias, skip, last, col0, t);
          if (skip && !last)
            move_rows<M, false>(xp, out, er.base, row0, er.count, col0, t);
        }
      }
      if (skip) xin_in_out = true;
      if (!last) named_sync(1, 2 * kWg);  // h holds layer l + 1's input
    }
#pragma unroll
    for (int p = 0; p < C::kPasses; ++p)
      move_rows<M, false>(acc[p], out, er.base, row0, er.count,
                          p * C::kPassN + cw * C::kNW, t);
  }
}

// ------------------------------------------------------- K2R pass 1 ----
// The recompute runs on the CUDA cores, in the plain chain's order: each
// output is one fp32 FMA chain over k = 0 .. M-1 from zero, then + b_l
// (+ xin), then ReLU, as cuBLAS's fp32 product and the plain version
// compute it. The reverse sweep multiplies by each layer's ReLU mask, a
// discontinuous function of the recomputed activations: a recompute on
// the 3xTF32 mainloop, ~1e-7 off the plain chain, flipped masks of
// activations that close to zero and moved whole rows of dx (one row of
// 4,096 off by 2.2e-2 on an H100). Bit for bit the plain forward's
// activations give the plain masks; the products after them (the sweep,
// pass 2) tolerate rounding and run in 3xTF32. (cuBLAS sums in k order
// for every expert of hundreds of rows measured; for an expert of a few
// rows it may take another order, and a mask can differ there.)
//
// Consumer thread ct (0..255) of the recompute owns rows 8 * (ct / 32) ..
// + 7 and, in pass p, the columns p * kRPassN + 32 kRVec g + kRVec lane + q
// (g < kRGroups, q < kRVec; lane = ct % 32) of the tile: each k a warp
// reads its 8 rows of h by broadcast loads (a float4 covers 4 k) and each
// thread its columns of W by kRGroups vector loads, each warp-wide load
// conflict-free (at M >= 256: 64 FMAs a thread per 2 16-byte loads of W,
// where one column a load gave 32 FMAs per 4). A thread tile of 8 x 16
// (one pass at M = 512) ran slower on an H100: its 128 accumulators leave
// too few registers to keep the loads in flight. W_l streams through the
// ring as it is stored (16 k rows of one pass's columns a stage, 32-column
// boxes of 128-byte rows, no swizzle).

// kRVec (2 or 4) adjacent floats, and component q of them.
template <int V>
using FVec = typename std::conditional<V == 4, float4, float2>::type;

__device__ __forceinline__ float comp(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

__device__ __forceinline__ float comp(const float2& v, int q) {
  return q == 0 ? v.x : v.y;
}

template <int V>
__device__ __forceinline__ FVec<V> fvec(const float (&z)[V]) {
  if constexpr (V == 4)
    return make_float4(z[0], z[1], z[2], z[3]);
  else
    return make_float2(z[0], z[1]);
}

// The exact W_l rows of k chunk kc of block z, columns n0 .. n0 + kRPassN,
// into the next ring stage.
template <int M>
__device__ __forceinline__ void produce_w_exact(const CUtensorMap* w32_map,
                                                uint8_t* ring, uint64_t* full,
                                                uint64_t* empty, int z,
                                                int kc, int n0, int& stage,
                                                uint32_t& phase) {
  using C = TCfg<M>;
  mbar_wait(&empty[stage], phase ^ 1);
  mbar_expect_tx(&full[stage], C::kRPassN * kStageK * 4);
  uint8_t* dst = ring + stage * C::kStageBytes;
#pragma unroll
  for (int p = 0; p < C::kRPassN / 32; ++p)
    tma_load(dst + p * kStageK * 128, w32_map, &full[stage], n0 + 32 * p,
             kc * kStageK, z);
  if (++stage == C::kStages) {
    stage = 0;
    phase ^= 1;
  }
}

// acc = h @ W_l over one pass's columns on the CUDA cores (see above):
// every output one FMA chain over k = 0 .. M-1 in order.
template <int M>
__device__ __forceinline__ void f32_product(
    float (&acc)[8][TCfg<M>::kRCols], const float* h, const uint8_t* ring,
    uint64_t* full, uint64_t* empty, int& stage, uint32_t& phase, int ct) {
  using C = TCfg<M>;
  constexpr int V = C::kRVec, G = C::kRGroups;
  const int lane = ct & 31;
  const float* hrow = h + (ct >> 5) * 8 * C::kLd;
  // this thread's first column in a stage (boxes of 32 columns x 16 k)
  const int woff = lane * V / 32 * (kStageK * 32) + lane * V % 32;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < V * G; ++j) acc[i][j] = 0.0f;
#pragma unroll 1
  for (int kc = 0; kc < C::kKChunks; ++kc) {
    mbar_wait(&full[stage], phase);
    const float* w =
        reinterpret_cast<const float*>(ring + stage * C::kStageBytes) + woff;
#pragma unroll
    for (int k4 = 0; k4 < kStageK; k4 += 4) {
      float4 a[8];  // rows 8w .. + 7, k4 .. k4 + 3 (broadcast loads)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(hrow + i * C::kLd +
                                                kc * kStageK + k4);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        FVec<V> b[G];
#pragma unroll
        for (int g = 0; g < G; ++g)
          b[g] = *reinterpret_cast<const FVec<V>*>(
              w + g * V * (kStageK * 32) + (k4 + u) * 32);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float av = comp(a[i], u);
#pragma unroll
          for (int g = 0; g < G; ++g)
#pragma unroll
            for (int q = 0; q < V; ++q)
              acc[i][g * V + q] = fmaf(av, comp(b[g], q), acc[i][g * V + q]);
        }
      }
    }
    mbar_arrive(&empty[stage]);
    if (++stage == C::kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
}

// The recompute's epilogue of layer l (never the last) for the columns
// of one pass (from col0): z = acc + b_l, at a skip layer z += xin, then
// ReLU; z -> h (unless h is null), -> hsave's layer l + 1 (rows
// ws_row0 ..) and, with kBits, the mask bits (z > 0) of each (row, 32
// columns) -> mask [64][M / 32], each word ORed over the 32 / kRVec lanes
// that hold its columns. xin is the hsave layer this thread wrote its skip
// input to (H_0, or the output of the last skip layer): read back by the
// thread that wrote it, so the registers hold only acc.
template <int M, bool kBits>
__device__ __forceinline__ void f32_epilogue(
    float (&acc)[8][TCfg<M>::kRCols], float* h, const float* bias,
    const float* xin, float* hsave_l, uint32_t* mask, int col0, int ct) {
  using C = TCfg<M>;
  constexpr int V = C::kRVec, G = C::kRGroups;
  const int lane = ct & 31, r0 = (ct >> 5) * 8;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int c = col0 + g * 32 * V + lane * V;
    float b[V];
#pragma unroll
    for (int q = 0; q < V; ++q) b[q] = __ldg(bias + c + q);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const long long row = (long long)(r0 + i) * M;
      FVec<V> xv{};
      if (xin != nullptr)
        xv = *reinterpret_cast<const FVec<V>*>(xin + row + c);
      float z[V];
      uint32_t bits = 0;
#pragma unroll
      for (int q = 0; q < V; ++q) {
        z[q] = acc[i][g * V + q] + b[q];
        if (xin != nullptr) z[q] += comp(xv, q);
        z[q] = fmaxf(z[q], 0.0f);
        bits |= (z[q] > 0.0f ? 1u : 0u) << q;
      }
      const FVec<V> out = fvec<V>(z);
      if (h != nullptr)
        *reinterpret_cast<FVec<V>*>(h + (r0 + i) * C::kLd + c) = out;
      *reinterpret_cast<FVec<V>*>(hsave_l + row + c) = out;
      if constexpr (kBits) {
        bits <<= c % 32;
#pragma unroll
        for (int s = 1; s < 32 / V; s <<= 1)
          bits |= __shfl_xor_sync(0xffffffffu, bits, s);
        if (c % 32 == 0) mask[(r0 + i) * C::kMaskWords + c / 32] = bits;
      }
    }
  }
}

// The sweep's step of layer l on this thread's elements of one pass
// (columns from col0), in the plain backward's order: g (+ gxin at a skip
// layer), times the ReLU mask of H_{l+1} unless last; gxin = g at a skip
// layer (in dx; zero until the first skip layer); G_l -> h. The mask: with
// kBits the recompute's bits in shared memory (mask), else H_{l+1} > 0 read
// from hsave's layer l + 1 (hnext, at the tile's first row): the same bit,
// since H_{l+1} is the ReLU's output.
template <int M, bool kBits>
__device__ __forceinline__ void sweep_stage(
    const float (&v)[TCfg<M>::kAcc], float* h, const uint32_t* mask,
    const float* hnext, float* dx, long long base, int row0, int count,
    int col0, bool last, bool skip, bool gxin_in_dx, int t) {
  using C = TCfg<M>;
  const int lane = t & 31;
  const int r0 = (t >> 5) * 16 + (lane >> 2);
  float gxin[C::kAcc];
  if (skip) {
    if (gxin_in_dx) {
      move_rows<M, true>(gxin, dx, base, row0, count, col0, t);
    } else {
#pragma unroll
      for (int i = 0; i < C::kAcc; ++i) gxin[i] = 0.0f;
    }
  }
  // this thread's mask words: rows r0 and r0 + 8, its kNW columns (bit
  // c - col0 - 32 w of word w: column c)
  uint32_t mw[2][C::kNW / 32];
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int w = 0; w < C::kNW / 32; ++w) {
      if constexpr (kBits) {
        mw[half][w] =
            last ? ~0u : mask[(r0 + 8 * half) * C::kMaskWords + col0 / 32 + w];
      } else if (last) {
        mw[half][w] = ~0u;
      } else {  // this thread's 8 columns of the word, 2 at a time
        uint32_t bits = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int sh = 8 * j + 2 * (lane & 3);
          const float2 hn = *reinterpret_cast<const float2*>(
              hnext + (long long)(r0 + 8 * half) * M + col0 + 32 * w + sh);
          bits |= (hn.x > 0.0f ? 1u : 0u) << sh;
          bits |= (hn.y > 0.0f ? 2u : 0u) << sh;
        }
        mw[half][w] = bits;
      }
    }
#pragma unroll
  for (int j2 = 0; j2 < C::kNW / 8; ++j2) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = 4 * j2 + 2 * half;
      const int r = r0 + 8 * half;
      const int c = col0 + 8 * j2 + 2 * (lane & 3);
      float g0 = v[i], g1 = v[i + 1];
      if (skip) {
        g0 += gxin[i];
        g1 += gxin[i + 1];
      }
      // g * (H_{l+1} > 0): columns c, c + 1 are bits 8 (j2 % 4) + 2 q
      // (+ 1) of word j2 / 4
      const uint32_t bits =
          mw[half][j2 / 4] >> (8 * (j2 & 3) + 2 * (lane & 3));
      if (!(bits & 1u)) g0 = 0.0f;
      if (!(bits & 2u)) g1 = 0.0f;
      if (skip) {
        gxin[i] = g0;
        gxin[i + 1] = g1;
      }
      *reinterpret_cast<float2*>(h + r * C::kLd + c) = make_float2(g0, g1);
    }
  }
  if (skip) move_rows<M, false>(gxin, dx, base, row0, count, col0, t);
}

// dx = gh + gxin (gxin in dx once a skip layer has passed) for this
// thread's elements of one pass.
template <int M>
__device__ __forceinline__ void finish_dx(float (&acc)[TCfg<M>::kAcc],
                                          float* dx, long long base,
                                          int row0, int count, int col0,
                                          bool gxin_in_dx, int t) {
  using C = TCfg<M>;
  if (gxin_in_dx) {
    float gxin[C::kAcc];
    move_rows<M, true>(gxin, dx, base, row0, count, col0, t);
#pragma unroll
    for (int i = 0; i < C::kAcc; ++i) acc[i] += gxin[i];
  }
  move_rows<M, false>(acc, dx, base, row0, count, col0, t);
}

// w_map: the split W_l (hi, lo) [2, L*E, M, M] for the sweep; w32_map: W
// [L*E, M, M] itself for the recompute; hsave [L, ws_rows, M]; gsave
// [2, L, M, ws_rows] (G_l^T hi, lo). The rows (rows.cuh): kRagged x [N, M]
// sorted by expert with idx the counts [E]; in place x [E, cap, M]; kGather
// the token rows x [n_src, M] that idx [E * cap] names. g and dx are
// [N, M] (kRagged) or [E, cap, M]. The ReLU masks: with kBits the
// recompute keeps them as bits in shared memory (L - 1 layers of them:
// bwd_max_layers, K2R's depth limit); without, the sweep reads
// H_{l+1} > 0 back from hsave, so in place and gathered launches take 32
// layers at every width (bits up to bwd_max_layers, hsave past it).
// kSweep false stops after the recompute: its time alone, for
// chip_smoke.py's profiled split (nothing reads its outputs).
template <int M, int SRC, bool kBits, bool kSweep>
__global__ void __launch_bounds__(kThreads, 1)
chain_bwd_tf32(const __grid_constant__ CUtensorMap w_map,
               const __grid_constant__ CUtensorMap w32_map,
               const float* __restrict__ x, const int* __restrict__ idx,
               int n_src, const float* __restrict__ bs,
               const float* __restrict__ g,
               float* dx, float* hsave,  // written, then read back
               float* __restrict__ gsave, long long ws_rows, int E, int cap,
               int L, unsigned skip_mask) {
  using C = TCfg<M>;
  constexpr int V = C::kRVec;
  static_assert(kBits || SRC != kRagged, "ragged rows keep mask bits");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const TSmem<M> lay(L, kBits);
  uint8_t* ring = smem + lay.ring;
  float* h = reinterpret_cast<float*>(smem + lay.h);
  uint32_t* masks = reinterpret_cast<uint32_t*>(smem + lay.mask);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bars);
  uint64_t* empty = full + C::kStages;
  uint64_t* x_full = empty + C::kStages;

  const int e = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  ExpertRows er = expert_rows<SRC>(idx, e, cap);
  if (SRC != kRagged) er.ws = e * padded_seg_rows(cap);
  if (row0 >= er.count) return;  // past its rows
  const int LE = L * E;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * kWg);
    }
    mbar_init(x_full, kWg);
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < kWg) {  // producer
    // W_0 .. W_{L-2} as stored for the recompute, then the split
    // W_{L-1} .. W_0 for the sweep; each layer pass by pass
    constexpr int K = C::kKChunks;
    constexpr int PK = C::kPasses * K;    // the sweep's stages a layer
    constexpr int RK = C::kRPasses * K;   // the recompute's
    const int n_fwd = (L - 1) * RK;
    const int t = threadIdx.x;
    int stage = 0;
    uint32_t phase = 0;
    auto load_w = [&](int j) {
      if (j < n_fwd) {
        produce_w_exact<M>(&w32_map, ring, full, empty, (j / RK) * E + e,
                           j % K, (j / K) % C::kRPasses * C::kRPassN, stage,
                           phase);
      } else {
        const int r = j - n_fwd;
        produce_w<M>(&w_map, ring, full, empty, (L - 1 - r / PK) * E + e,
                     LE, r % K, (r / K) % C::kPasses * C::kPassN, stage,
                     phase);
      }
    };
    const int n_w = n_fwd + (kSweep ? L * PK : 0);
    copy_rows_in<M, SRC>(h, x, idx, n_src, er, row0, t);
    int j = 0;
    if (t == 0)
      for (; j < n_w && j < C::kStages; ++j) load_w(j);
    cp_async_wait_all();
    mbar_arrive(x_full);
    regs_dec<kProducerRegs>();
    if (t == 0)
      for (; j < n_w; ++j) load_w(j);
  } else {  // consumers
    regs_inc<kConsumerRegs>();
    // this tile's first row in a workspace layer and in x, g, dx: formed
    // here, so that no address is held in a register across setmaxnreg
    long long ws_row0 = er.ws + row0, base = er.base;
    asm volatile("" : "+l"(ws_row0), "+l"(base));
    const int ct = threadIdx.x - kWg;
    const int cw = ct / kWg;
    const int t = ct % kWg;
    int stage = 0;
    uint32_t phase = 0;
    mbar_wait(x_full, 0);

    {  // recompute: H_l -> hsave (kRagged: masks of layers 0..L-2 -> bits)
      const int lane = ct & 31, r0 = (ct >> 5) * 8;
      float acc[8][C::kRCols];
#pragma unroll
      for (int j2 = 0; j2 < C::kMaskWords; ++j2)
#pragma unroll
        for (int i = 0; i < 8; ++i)  // H_0
          hsave[(ws_row0 + r0 + i) * M + lane + 32 * j2] =
              h[(r0 + i) * C::kLd + lane + 32 * j2];
      int xin_layer = 0;  // the hsave layer holding the skip input
      for (int l = 0; l < L - 1; ++l) {
        const bool skip = (skip_mask >> l) & 1u;
        float* next = hsave + ((l + 1) * ws_rows + ws_row0) * M;
        // each pass's results go to hsave (and the masks) at once; h, which
        // every pass reads whole, takes them after the last pass, the
        // earlier passes' read back by the thread that wrote them
#pragma unroll
        for (int p = 0; p < C::kRPasses; ++p) {
          const bool final_pass = p == C::kRPasses - 1;
          f32_product<M>(acc, h, ring, full, empty, stage, phase, ct);
          if (final_pass) named_sync(1, 2 * kWg);  // every read of h done
          f32_epilogue<M, kBits>(
              acc, final_pass ? h : nullptr, bs + ((size_t)l * E + e) * M,
              skip ? hsave + (xin_layer * ws_rows + ws_row0) * M : nullptr,
              next, masks + l * C::kMaskLayer, p * C::kRPassN, ct);
        }
        for (int p = 0; p < C::kRPasses - 1; ++p)
#pragma unroll
          for (int g = 0; g < C::kRGroups; ++g)
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const int c = p * C::kRPassN + g * 32 * V + lane * V;
              *reinterpret_cast<FVec<V>*>(h + (r0 + i) * C::kLd + c) =
                  *reinterpret_cast<const FVec<V>*>(
                      next + (long long)(r0 + i) * M + c);
            }
        if (skip) xin_layer = l + 1;
        named_sync(1, 2 * kWg);
      }
    }
    if constexpr (!kSweep) return;
    // with one layer nothing above synchronised after the copy of H_0,
    // which reads h: the sweep rewrites h
    if (L == 1) named_sync(1, 2 * kWg);

    // reverse sweep, a pass's columns at a time. The gradient coming into
    // layer l is g at the last layer (zero past the expert's rows), else
    // layer l + 1's products, in registers (acc). With more than one pass
    // (M = 512) acc holds only the last pass's: the earlier passes' wait in
    // the tile's block of gsave's hi layer l (which this sweep writes only
    // later, at layer l), read back by the thread that wrote them. gxin,
    // zero until the first skip layer, is kept in this thread's elements
    // of dx (written and read back by the same thread) rather than in
    // registers: acc, a stage's fresh accumulator and the A fragments fill
    // them.
    float acc[C::kAcc];
    if constexpr (C::kPasses == 1)
      move_rows<M, true>(acc, const_cast<float*>(g), base, row0, er.count,
                         cw * C::kNW, t);
    bool gxin_in_dx = false;
    for (int l = L - 1; l >= 0; --l) {
      const bool last = l == L - 1;
      const bool skip = (skip_mask >> l) & 1u;
      const uint32_t* mask = masks + l * C::kMaskLayer;
      const float* hnext =
          kBits || last ? nullptr : hsave + ((l + 1) * ws_rows + ws_row0) * M;
#pragma unroll 1
      for (int p = 0; p < C::kPasses; ++p) {
        const int col0 = p * C::kPassN + cw * C::kNW;
        if constexpr (C::kPasses == 1) {
          sweep_stage<M, kBits>(acc, h, mask, hnext, dx, base, row0, er.count,
                                col0, last, skip, gxin_in_dx, t);
        } else {
          float v[C::kAcc];
          if (last) {
            move_rows<M, true>(v, const_cast<float*>(g), base, row0,
                               er.count, col0, t);
          } else if (p < C::kPasses - 1) {
            move_held<M, true>(v, gsave + (long long)l * M * ws_rows,
                               ws_rows, ws_row0, col0, t);
          } else {
#pragma unroll
            for (int i = 0; i < C::kAcc; ++i) v[i] = acc[i];
          }
          sweep_stage<M, kBits>(v, h, mask, hnext, dx, base, row0, er.count,
                                col0, last, skip, gxin_in_dx, t);
        }
      }
      if (skip) gxin_in_dx = true;
      named_sync(1, 2 * kWg);  // h holds G_l
      store_g_transposed<M>(h, gsave + (long long)l * M * ws_rows,
                            gsave + (long long)(L + l) * M * ws_rows, ws_rows,
                            ws_row0, cw, t);
#pragma unroll 1
      for (int p = 0; p < C::kPasses; ++p) {
        tf32_product<M>(acc, h, smem_u32(ring), full, empty, stage, phase,
                        cw, t);
        if constexpr (C::kPasses > 1) {
          const int col0 = p * C::kPassN + cw * C::kNW;
          if (l == 0)
            finish_dx<M>(acc, dx, base, row0, er.count, col0, gxin_in_dx, t);
          else if (p < C::kPasses - 1)
            move_held<M, false>(acc, gsave + (long long)(l - 1) * M * ws_rows,
                                ws_rows, ws_row0, col0, t);
        }
      }
      named_sync(1, 2 * kWg);  // every read of h is done
    }
    if constexpr (C::kPasses == 1)
      finish_dx<M>(acc, dx, base, row0, er.count, cw * C::kNW, gxin_in_dx, t);
  }
}

// ------------------------------------------------------- K2R pass 2 ----
template <int M>
struct DwTf32 {
  static constexpr int kTM = M < 128 ? M : 128;   // dW rows per CTA
  static constexpr int kTN = kTM;                  // dW columns per CTA
  static constexpr int kConsumers = kTM / 64;
  static constexpr int kThreads = kWg * (1 + kConsumers);
  static constexpr int kAcc = kTN / 2;             // fp32 a thread
  static constexpr int kK = 32;                    // rows of H, G a stage
  static constexpr int kHBox = kK * 32 * 4;        // 32 rows x 32 columns
  static constexpr int kHBytes = kTM / 32 * kHBox;
  static constexpr int kGHalf = kTN * kK * 4;      // G^T hi or lo: kTN x 128 B
  static constexpr int kStageBytes = kHBytes + 2 * kGHalf;
  static constexpr int kStages =
      163840 / kStageBytes < 4 ? 163840 / kStageBytes : 4;
  static constexpr int kBytes = kStages * kStageBytes + 2 * kStages * 8 + 1024;
};

// Element (r, m) of a stage's H tile: 32-column boxes of 32 rows of 128 B
// with the 128-byte swizzle (16-byte chunk index XOR row % 8).
__device__ __forceinline__ uint32_t h_at(int r, int m) {
  return (m >> 5) * DwTf32<64>::kHBox + r * 128 +
         ((((m & 31) >> 2) ^ (r & 7)) << 4) + ((m & 3) << 2);
}

// Element (n, r) of a stage's G^T hi or lo: rows n of 128 B, swizzled.
__device__ __forceinline__ uint32_t g_at(int n, int r) {
  return n * 128 + (((r >> 2) ^ (n & 7)) << 4) + ((r & 3) << 2);
}

// One CTA: dW rows m0 .. + kTM, columns n0 .. + kTN (blockIdx.x), one
// chunk (blockIdx.y), one layer (blockIdx.z); each consumer warpgroup 64
// rows (m64n{kTN}k8), each stage 32 rows of H and G summed into a fresh
// accumulator (small products first) and added to acc with a rounded add,
// as tf32_product. h_map: hsave [L, ws_rows, M], boxes 32 x 32; g_map:
// gsave [2L, M, ws_rows], boxes of 32 rows x kTN columns; both with the
// 128-byte swizzle. dwp / dbp: the partials [L, chunks, M, M] /
// [L, chunks, M] (rows.cuh). The chunks: kRagged's from the counts [E] on
// the device, the padded layout's (in place, gathered) from cap.
template <int M, int SRC>
__global__ void __launch_bounds__(DwTf32<M>::kThreads, 1)
chain_dw_tf32(const __grid_constant__ CUtensorMap h_map,
              const __grid_constant__ CUtensorMap g_map,
              float* __restrict__ dwp, float* __restrict__ dbp,
              const int* __restrict__ counts, int E, int cap) {
  using D = DwTf32<M>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + D::kStages *
                                               D::kStageBytes);
  uint64_t* empty = full + D::kStages;
  const ChunkRows cr = chunk_rows<SRC>(counts, E, cap, blockIdx.y);
  if (cr.e < 0) return;  // past the last chunk
  const int m0 = blockIdx.x / (M / D::kTN) * D::kTM;
  const int n0 = blockIdx.x % (M / D::kTN) * D::kTN;
  const int l = blockIdx.z, L = gridDim.z;
  const int steps = (cr.count + D::kK - 1) / D::kK;
  const long long z = (long long)l * gridDim.y + blockIdx.y;  // partial
  if (threadIdx.x == 0) {
    for (int s = 0; s < D::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], D::kConsumers * kWg);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < kWg) {  // producer
    if constexpr (D::kConsumers == 2) regs_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int s = 0; s < steps; ++s) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_expect_tx(&full[stage], D::kStageBytes);
        uint8_t* hs = ring + stage * D::kStageBytes;
        uint8_t* gs = hs + D::kHBytes;
        const int row = (int)cr.ws + s * D::kK;
        for (int p = 0; p < D::kTM / 32; ++p)
          tma_load(hs + p * D::kHBox, &h_map, &full[stage], m0 + 32 * p, row,
                   l);
        tma_load(gs, &g_map, &full[stage], row, n0, l);
        tma_load(gs + D::kGHalf, &g_map, &full[stage], row, n0, L + l);
        if (++stage == D::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {  // consumers
    if constexpr (D::kConsumers == 2) regs_inc<kConsumerRegs>();
    const int cw = threadIdx.x / kWg - 1;
    const int t = threadIdx.x % kWg;
    const int lane = t & 31, q = lane & 3;
    const int ma = cw * 64 + (t >> 5) * 16 + (lane >> 2);  // A rows ma, ma+8
    const int n = cw * kWg + t;                      // db column n0 + n
    const bool do_db = m0 == 0 && n < D::kTN;
    float db_acc = 0.0f, db_err = 0.0f;
    float acc[D::kAcc], part[D::kAcc];
    int stage = 0;
    uint32_t phase = 0;
#pragma unroll 1
    for (int s = 0; s < steps; ++s) {
      mbar_wait(&full[stage], phase);
      const uint8_t* hs = ring + stage * D::kStageBytes;
      const uint8_t* gs = hs + D::kHBytes;
      uint32_t ahi[4][4], alo[4][4];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const int r = 8 * ks + q;
        split(*reinterpret_cast<const float*>(hs + h_at(r, ma)), ahi[ks][0],
              alo[ks][0]);
        split(*reinterpret_cast<const float*>(hs + h_at(r, ma + 8)),
              ahi[ks][1], alo[ks][1]);
        split(*reinterpret_cast<const float*>(hs + h_at(r + 4, ma)),
              ahi[ks][2], alo[ks][2]);
        split(*reinterpret_cast<const float*>(hs + h_at(r + 4, ma + 8)),
              ahi[ks][3], alo[ks][3]);
      }
      const uint32_t gb = smem_u32(gs);
      fence_acc(part);
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        WgmmaTf32<D::kTN>::mma(part, ahi[ks],
                               desc_kmajor(gb + D::kGHalf + ks * 32), ks != 0);
        WgmmaTf32<D::kTN>::mma(part, alo[ks], desc_kmajor(gb + ks * 32), 1);
      }
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        WgmmaTf32<D::kTN>::mma(part, ahi[ks], desc_kmajor(gb + ks * 32), 1);
      wg_commit();
      if (do_db) {  // rows in ascending order, compensated (Kahan) sums
#pragma unroll 8
        for (int r = 0; r < D::kK; ++r) {
          const float v = *reinterpret_cast<const float*>(gs + g_at(n, r)) +
                          *reinterpret_cast<const float*>(gs + D::kGHalf +
                                                          g_at(n, r));
          const float y = v - db_err;
          const float sum = db_acc + y;
          db_err = (sum - db_acc) - y;
          db_acc = sum;
        }
      }
      wg_wait<0>();
      fence_acc(part);
      mbar_arrive(&empty[stage]);
#pragma unroll
      for (int i = 0; i < D::kAcc; ++i) acc[i] = s ? acc[i] + part[i] : part[i];
      if (++stage == D::kStages) {
        stage = 0;
        phase ^= 1;
      }
    }

    float* out = dwp + z * M * M;
#pragma unroll
    for (int j = 0; j < D::kTN / 8; ++j) {
      const int c = n0 + 8 * j + 2 * q;
      *reinterpret_cast<float2*>(out + (size_t)(m0 + ma) * M + c) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(out + (size_t)(m0 + ma + 8) * M + c) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
    if (do_db) dbp[z * M + n0 + n] = db_acc;
  }
}

// ------------------------------------------------------------- host ----
// The split weights (tf32_split_weights) and a tensor map over them:
// [2 * L*E, M, M] fp32, boxes of 16 k x one pass's kPassN rows with the
// 64-byte swizzle.
template <int M>
int split_weights(CUtensorMap* w_map, const float* ws, float* wsplit, int LE,
                  bool as_stored, cudaStream_t stream) {
  tf32_split_weights<<<dim3(M / 32, M / 32, LE), dim3(32, 8), 0, stream>>>(
      ws, wsplit, LE, M, as_stored ? 1 : 0);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return make_map(w_map, wsplit, M, M, 2LL * LE, kStageK, TCfg<M>::kPassN,
                  CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
}

// rows: N with kRagged, else the capacity C.
template <int M, int SRC>
int launch_fwd_width(const float* x, const int* idx, int n_src,
                     const float* ws, const float* bs, float* wsplit,
                     float* out, int E, int rows, int L, unsigned skip_mask,
                     cudaStream_t stream) {
  CUtensorMap w_map;
  int rc = split_weights<M>(&w_map, ws, wsplit, L * E, false, stream);
  if (rc != 0) return rc;
  const int smem = TSmem<M>(L, false).bytes;
  auto kern = chain_fwd_tf32<M, SRC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3((rows + kRows - 1) / kRows, E), kThreads, smem, stream>>>(
      w_map, x, idx, n_src, bs, out, E, rows, L, skip_mask);
  return (int)cudaGetLastError();
}

// Pass 1 with the masks as bits (kBits) or read back from hsave.
template <int M, int SRC, bool kBits, bool kSweep>
int launch_pass1(const CUtensorMap& w_map, const CUtensorMap& w32_map,
                 const float* x, const int* idx, int n_src, const float* bs,
                 const float* g, float* dx, float* hsave, float* gsave,
                 long long ws_rows, int E, int rows, int L,
                 unsigned skip_mask, cudaStream_t stream) {
  const int smem = TSmem<M>(L, kBits).bytes;
  auto kern = chain_bwd_tf32<M, SRC, kBits, kSweep>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3((rows + kRows - 1) / kRows, E), kThreads, smem, stream>>>(
      w_map, w32_map, x, idx, n_src, bs, g, dx, hsave, gsave, ws_rows, E,
      rows, L, skip_mask);
  return (int)cudaGetLastError();
}

// rows: N with kRagged, else the capacity C. bits: the masks of L - 1
// layers fit pass 1's shared memory (always so with kRagged).
template <int M, int SRC, bool kSweep>
int launch_bwd_width(const float* x, const int* idx, int n_src,
                     const float* ws, const float* bs, const float* g,
                     float* dx, float* hsave, float* gsave, float* wsplit,
                     float* dw, float* db, float* dwp, float* dbp, int E,
                     int rows, int L, unsigned skip_mask, bool bits,
                     cudaStream_t stream) {
  const long long ws_rows = bwd_ws_rows<SRC>(rows, E);
  CUtensorMap w_map, w32_map, h_map, g_map;
  int rc = split_weights<M>(&w_map, ws, wsplit, L * E, true, stream);
  if (rc != 0) return rc;
  if ((rc = make_map(&w32_map, ws, M, M, (long long)L * E, 32, kStageK,
                     CU_TENSOR_MAP_SWIZZLE_NONE,
                     CU_TENSOR_MAP_DATA_TYPE_FLOAT32)) != 0)
    return rc;
  if ((rc = make_map(&h_map, hsave, M, ws_rows, L, 32, DwTf32<M>::kK,
                     CU_TENSOR_MAP_SWIZZLE_128B,
                     CU_TENSOR_MAP_DATA_TYPE_FLOAT32)) != 0)
    return rc;
  if ((rc = make_map(&g_map, gsave, (int)ws_rows, M, 2LL * L, DwTf32<M>::kK,
                     DwTf32<M>::kTN, CU_TENSOR_MAP_SWIZZLE_128B,
                     CU_TENSOR_MAP_DATA_TYPE_FLOAT32)) != 0)
    return rc;

  if constexpr (SRC == kRagged)
    rc = launch_pass1<M, SRC, true, kSweep>(w_map, w32_map, x, idx, n_src, bs,
                                            g, dx, hsave, gsave, ws_rows, E,
                                            rows, L, skip_mask, stream);
  else if (bits)
    rc = launch_pass1<M, SRC, true, kSweep>(w_map, w32_map, x, idx, n_src, bs,
                                            g, dx, hsave, gsave, ws_rows, E,
                                            rows, L, skip_mask, stream);
  else
    rc = launch_pass1<M, SRC, false, kSweep>(w_map, w32_map, x, idx, n_src,
                                             bs, g, dx, hsave, gsave, ws_rows,
                                             E, rows, L, skip_mask, stream);
  if (rc != 0) return rc;
  if constexpr (!kSweep) return 0;

  using D = DwTf32<M>;
  auto kern2 = chain_dw_tf32<M, SRC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern2, cudaFuncAttributeMaxDynamicSharedMemorySize, D::kBytes);
  if (err != cudaSuccess) return (int)err;
  const int chunks = bwd_chunks<SRC>(rows, E);
  kern2<<<dim3((M / D::kTM) * (M / D::kTN), chunks, L), D::kThreads, D::kBytes,
            stream>>>(h_map, g_map, dwp, dbp, idx, E, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_reduce_partials<SRC>(dwp, dbp, idx, dw, db, E, M, L, chunks,
                                     stream, rows);
}

// The forward. Returns a cudaError_t code (0 = launched). Rows as
// chain_fwd_tf32's (rows: N with kRagged, else the capacity C), fp32;
// ws [L, E, M, M], bs [L, E, 1, M]; wsplit a workspace of 2 * L*E*M*M
// floats. Widths other than 64/128/256/512 are refused with
// cudaErrorInvalidValue; the Python wrappers check first.
template <int SRC>
inline int launch_chain_fwd(int device, const void* x, const int* idx,
                            int n_src, const void* ws, const void* bs,
                            void* wsplit, void* out, int E, int rows, int M,
                            int L, unsigned skip_mask, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (E <= 0 || rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* w = static_cast<const float*>(ws);
  const float* b = static_cast<const float*>(bs);
  float* wsp = static_cast<float*>(wsplit);
  float* y = static_cast<float*>(out);
  switch (M) {
    case 64:
      return launch_fwd_width<64, SRC>(xf, idx, n_src, w, b, wsp, y, E, rows,
                                       L, skip_mask, s);
    case 128:
      return launch_fwd_width<128, SRC>(xf, idx, n_src, w, b, wsp, y, E,
                                        rows, L, skip_mask, s);
    case 256:
      return launch_fwd_width<256, SRC>(xf, idx, n_src, w, b, wsp, y, E,
                                        rows, L, skip_mask, s);
    case 512:
      return launch_fwd_width<512, SRC>(xf, idx, n_src, w, b, wsp, y, E,
                                        rows, L, skip_mask, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The backward. Rows as chain_bwd_tf32's (rows: N with kRagged, else the
// capacity C); hsave [L, bwd_ws_rows, M] and gsave [2, L, M, bwd_ws_rows]
// fp32 workspaces; wsplit 2 * L*E*M*M floats; dw [L, E, M, M], db
// [L, E, 1, M]; dwp / dbp the partials [L, bwd_chunks, M, M] /
// [L, bwd_chunks, M] (rows.cuh). kSweep false: pass 1's recompute alone
// (chain_bwd_tf32).
template <int SRC, bool kSweep = true>
inline int launch_chain_bwd(int device, const void* x, const int* idx,
                            int n_src, const void* ws, const void* bs,
                            const void* g, void* dx, void* hsave, void* gsave,
                            void* wsplit, float* dw, float* db, float* dwp,
                            float* dbp, int E, int rows, int M, int L,
                            unsigned skip_mask, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // the depth whose masks fit pass 1's shared memory as bits: K2R's limit;
  // in place and gathered, deeper chains read them back from hsave
  const int bit_layers = bwd_max_layers(device, M);
  const int limit = SRC == kRagged ? bit_layers : 32;
  if (E <= 0 || rows <= 0 || L < 1 || L > limit)
    return (int)cudaErrorInvalidValue;
  const bool bits = L <= bit_layers;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* w = static_cast<const float*>(ws);
  const float* b = static_cast<const float*>(bs);
  const float* gy = static_cast<const float*>(g);
  float* dxf = static_cast<float*>(dx);
  float* hs = static_cast<float*>(hsave);
  float* gs = static_cast<float*>(gsave);
  float* wsp = static_cast<float*>(wsplit);
  switch (M) {
    case 64:
      return launch_bwd_width<64, SRC, kSweep>(
          xf, idx, n_src, w, b, gy, dxf, hs, gs, wsp, dw, db, dwp, dbp, E,
          rows, L, skip_mask, bits, s);
    case 128:
      return launch_bwd_width<128, SRC, kSweep>(
          xf, idx, n_src, w, b, gy, dxf, hs, gs, wsp, dw, db, dwp, dbp, E,
          rows, L, skip_mask, bits, s);
    case 256:
      return launch_bwd_width<256, SRC, kSweep>(
          xf, idx, n_src, w, b, gy, dxf, hs, gs, wsp, dw, db, dwp, dbp, E,
          rows, L, skip_mask, bits, s);
    case 512:
      return launch_bwd_width<512, SRC, kSweep>(
          xf, idx, n_src, w, b, gy, dxf, hs, gs, wsp, dw, db, dwp, dbp, E,
          rows, L, skip_mask, bits, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace tf32
