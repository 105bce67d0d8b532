// Per-expert L-layer MLP chain, bf16 forward, for Hopper (sm_90a): the
// mainloop of K1 (expert_chain.cu), of K3 (fused_dispatch.cu), of K1R
// (ragged_chain.cu) and of the first passes of K2, K4 and K2R
// (chain_bwd_sm90.cuh).
//
// Replaces the bf16 case of switch_nerf_tpu/ops/expert_kernel.py:_fwd_call
// (Pallas _fwd_kernel) and, with kGather (rows.cuh), of
// switch_nerf_tpu/ops/fused_dispatch.py:_fwd_call (_gather_block +
// _chain_fwd_from). One launch at the Building shape (E8 C4096 M256 L7)
// does 2*E*C*M^2*L = 30.1 GFLOP against ~41 MB of x, W and out: far above
// the H100's ~295 FLOP/B ridge, so it is bound by tensor-core operations,
// and the only way to the full rate is wgmma.
//
// Design:
//  - One CTA owns 128 rows of one expert: two consumer warpgroups of 64
//    rows each run one wgmma m64nMk16 chain apiece (fp32 accumulators in
//    registers, M/2 a thread), and one producer warp issues every TMA load.
//    setmaxnreg gives the consumers 232 registers and the producer 40.
//  - At M = 512 (Cfg::kSplit) m64n256 is wgmma's widest product and M/2
//    accumulators a thread would not fit in 232 registers, so a CTA owns 64
//    rows and each consumer warpgroup half of the columns (m64n256k16, 128
//    accumulators a thread). Both read the whole tile as A, so they meet at
//    a 256-thread barrier before either rewrites its columns and again
//    before the next product. The 64 KB tile, the skip input and a 2-stage
//    64 KB W ring fill ~200 KB. W is reused over 64 rows instead of 128:
//    each CTA streams its expert's L x 512 x 512 bf16 from L2 (3.7 MB at
//    L = 7), 1.88 GB a launch at E8 C4096 against 235 MB at M = 256.
//  - The 128-row activation tile h and the skip input xin stay in shared
//    memory across all L layers, in the 128-byte-swizzled K-major layout
//    the wgmma A descriptor reads (64-column panels of 128 rows). A
//    warpgroup reads only its own 64 rows, so it waits for its own
//    products, rewrites its rows in place and syncs with a 128-thread named
//    barrier: the two warpgroups drift apart and one's epilogue overlaps the
//    other's products.
//  - W_l [M_in, M_out] is an MN-major B operand (transpose bit set). The
//    producer streams it through a 64 KB ring of 32-row stages (4 at
//    M = 256; full/empty mbarriers) and runs ahead across layer boundaries,
//    since W does not depend on the activations; one load feeds both
//    warpgroups.
//  - The epilogue keeps the TPU kernel's order and roundings, in packed
//    bf16x2: z = bf16(acc), z = bf16(z + b_l), at a skip layer
//    z = bf16(z + xin) and xin = z, then ReLU unless last. Its stores follow
//    the swizzle (16-byte chunk index XOR row % 8), and a fence.proxy.async
//    makes them visible to the next wgmma. The bias rows sit in shared
//    memory, loaded once.
//  - Input and output move by TMA over 3-D tensor maps [E, C, M]: rows past
//    C within an expert are zero-filled on load and clipped on store.
//    Tensor maps are encoded on the host for each call, through
//    cudaGetDriverEntryPoint, so the library needs no -lcuda.
//  - kGather (K3, K4): TMA cannot gather rows, so the input tile comes from
//    tokens[idx[e * C + row]] by cp.async instead, copied by the whole
//    producer warpgroup (one 16-byte chunk a lane, one coalesced row per
//    warp request at M = 256) into the same swizzled layout, zero-filled
//    past C. Each producer thread waits for its copies, fences them to the
//    async proxy and arrives on the input barrier (count 128). Thread 0
//    starts the ring's first W stages before that wait, so the gather
//    overlaps them, and only then enters the blocking part of the W
//    stream. Everything after the input tile is K1's.
//  - kRagged (K1R, K2R; rows.cuh): x [N, M] sorted by expert, counts on
//    the device. A TMA box cannot stop at an expert's last row, so the
//    input tile comes in by kGather's cp.async copy (row off[e] + r,
//    zero-filled past counts[e]), and each consumer warpgroup stores its
//    rows of the output with 16-byte stores that stop at the expert's last
//    row. A CTA whose tile starts past counts[e] exits at once.
// wgmma sums k in another order than cuBLAS: the result is no longer
// bit-equal to the plain chain, and stays within bf16 rounding of it.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "rows.cuh"

namespace sm90 {

constexpr int kWgThreads = 128;           // one warpgroup
constexpr int kThreads = 3 * kWgThreads;  // producer + two consumers
constexpr int kTileRows = 128;            // rows of one expert per CTA
constexpr int kBox = 64;                  // TMA box: 64 columns x 64 rows
constexpr int kBoxBytes = kBox * kBox * 2;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

// ------------------------------------------------------------- PTX ----
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// Wait until the barrier has completed the phase of the given parity.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Generic-proxy shared-memory writes -> visible to TMA and wgmma.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// 16 bytes global -> shared through L2 only; src_bytes 0 zero-fills (src
// must still be a valid address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// The committed TMA stores have finished reading shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// The committed TMA stores are complete.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(R));
}

// Keep the compiler from moving accumulator reads across wgmma.
template <int N>
__device__ __forceinline__ void fence_acc(float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(acc[i])::"memory");
}

// wgmma shared-memory descriptor. lbo/sbo in bytes; swizzle 1 = 128 B,
// 2 = 64 B.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo,
                                              uint32_t swizzle = 1) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(swizzle) << 62);
}

// K-major operand with the 128-byte swizzle: rows of 128 B, 8-row groups
// 1024 B apart; k16 steps move the start by 32 B inside the swizzle atom.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) {
  return make_desc(addr, 16, 1024);
}

// K-major operand with the 64-byte swizzle: rows of 64 B (32 k), 8-row
// groups 512 B apart.
__device__ __forceinline__ uint64_t desc_kmajor64(uint32_t addr) {
  return make_desc(addr, 16, 512, 2);
}

// MN-major operand stored as 64-wide panels of `panel` bytes (rows of
// 128 B along k): LBO steps between panels along M/N, SBO between 8-row
// groups along k; k16 steps move the start by 2048 B.
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr,
                                                 uint32_t panel) {
  return make_desc(addr, panel, 1024);
}

// D[64 x N] (+)= A[64 x 16] B[16 x N], bf16 in, fp32 accumulate.
// TA / TB: the transpose (MN-major) bits of A and B.
template <int N, int TA, int TB>
struct Wgmma;

template <int TA, int TB>
struct Wgmma<64, TA, TB> {
  static __device__ __forceinline__ void mma(float* d, uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, %35, %36;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB>
struct Wgmma<128, TA, TB> {
  static __device__ __forceinline__ void mma(float* d, uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, %67, %68;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB>
struct Wgmma<256, TA, TB> {
  static __device__ __forceinline__ void mma(float* d, uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, %131, %132;\n}\n"
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
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
};

// Byte offset of element (r, c) in a tile of ROWS rows stored as 64-column
// panels with the 128-byte swizzle (the layout TMA writes with
// CU_TENSOR_MAP_SWIZZLE_128B and wgmma reads).
template <int ROWS>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (c >> 6) * (ROWS * 128) + r * 128 +
         ((((c >> 3) & 7) ^ (r & 7)) << 4) + ((c & 7) << 1);
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

// ------------------------------------------------- shared layout ----
// Up to M = 256 a CTA owns kTileRows rows and consumer warpgroup cw rows
// 64cw .. 64cw + 63 at full width; with kSplit (M = 512) a CTA owns 64 rows
// and warpgroup cw columns cw * M/2 .. of all of them: its "part".
template <int M>
struct Cfg {
  static constexpr bool kSplit = M > 256;
  static constexpr int kRows = kSplit ? kBox : kTileRows;  // rows per CTA
  static constexpr int kWN = kSplit ? M / 2 : M;     // columns of a part
  static constexpr int kStageK = 32;                 // k per W stage
  static constexpr int kStageBytes = kStageK * M * 2;
  static constexpr int kStages =                     // a 64 KB ring, <= 8
      65536 / kStageBytes < 8 ? 65536 / kStageBytes : 8;
  static constexpr int kTileBytes = kRows * M * 2;
  static constexpr int kPanelBytes = kRows * 128;    // 64 cols x kRows rows
  static constexpr int kKChunks = M / kStageK;
  static constexpr int kAcc = kWN / 2;               // fp32 per thread
  static constexpr int kMaskWords = kWN / 64;        // kAcc bits
  // the first tile row and column of warpgroup cw's part
  static __device__ __forceinline__ int row_of(int cw) {
    return kSplit ? 0 : cw * kBox;
  }
  static __device__ __forceinline__ int col_of(int cw) {
    return kSplit ? cw * kWN : 0;
  }
};

// Sync the consumer threads that read warpgroup cw's part of the tile: its
// own 128, or with kSplit both warpgroups (each reads all columns as A).
template <int M>
__device__ __forceinline__ void part_sync(int cw) {
  if constexpr (Cfg<M>::kSplit)
    named_sync(1, 2 * kWgThreads);
  else
    named_sync(1 + cw, kWgThreads);
}

// Offsets inside the (1024-aligned) dynamic shared memory of a chain CTA.
template <int M>
struct Smem {
  int h, xin, ring, bias, mask, bars, bytes;
  __host__ __device__ Smem(int L, bool masks) {
    using C = Cfg<M>;
    h = 0;
    xin = h + C::kTileBytes;
    ring = xin + C::kTileBytes;
    bias = ring + C::kStages * C::kStageBytes;
    mask = bias + ((L * M * 2 + 15) & ~15);
    bars = mask + (masks ? (L - 1) * 2 * kWgThreads * C::kMaskWords * 4 : 0);
    // full + empty per stage, the input tile, one g tile per warpgroup
    bytes = bars + (2 * C::kStages + 3) * 8 + 1024;  // + alignment slack
  }
};

// The L bias rows of expert e -> shared memory, by all threads of the CTA.
template <int M>
__device__ __forceinline__ void load_bias(__nv_bfloat16* bias,
                                          const __nv_bfloat16* bs, int E,
                                          int e, int L) {
  for (int i = threadIdx.x; i < L * M / 2; i += blockDim.x) {
    const int l = i / (M / 2), v = i % (M / 2);
    reinterpret_cast<__nv_bfloat162*>(bias + l * M)[v] =
        reinterpret_cast<const __nv_bfloat162*>(bs + ((size_t)l * E + e) *
                                                         M)[v];
  }
}

// ----------------------------------------------------------- producer ----
// Stream k chunk kc of W_l (z = l * E + e) into the next ring stage, 32 k
// per stage. FWD: 32-row slices of W_l (the MN-major B of h @ W_l), one
// 64 x 32 box per 64-column panel (map: 128-byte swizzle). Otherwise:
// 32-column slices of W_l (the K-major B of g @ W_l^T), one 32 x 64 box per
// 64 rows (map: 64-byte swizzle, rows of 64 B). Waits for the stage to be
// free, which a fresh ring's first kStages stages are.
template <int M, bool FWD>
__device__ __forceinline__ void produce_stage(const CUtensorMap* w_map,
                                              uint8_t* ring, uint64_t* full,
                                              uint64_t* empty, int z, int kc,
                                              int& stage, uint32_t& phase) {
  using C = Cfg<M>;
  constexpr int kPart = C::kStageBytes / (M / kBox);  // bytes per box
  mbar_wait(&empty[stage], phase ^ 1);
  mbar_expect_tx(&full[stage], C::kStageBytes);
  uint8_t* dst = ring + stage * C::kStageBytes;
#pragma unroll
  for (int p = 0; p < M / kBox; ++p) {
    if (FWD)
      tma_load(dst + p * kPart, w_map, &full[stage], p * kBox,
               kc * C::kStageK, z);
    else
      tma_load(dst + p * kPart, w_map, &full[stage], kc * C::kStageK,
               p * kBox, z);
  }
  if (++stage == C::kStages) {
    stage = 0;
    phase ^= 1;
  }
}

// Load rows [row, row + rows) of a [., C, M] tensor map into a tile of
// `tile_rows` rows at dst, starting at tile row `at`.
template <int M>
__device__ __forceinline__ void load_rows(uint8_t* dst, const CUtensorMap* map,
                                          uint64_t* bar, int row, int rows,
                                          int at, int tile_rows, int z) {
  for (int r = 0; r < rows; r += kBox)
#pragma unroll
    for (int p = 0; p < M / kBox; ++p)
      tma_load(dst + p * tile_rows * 128 + (at + r) * 128, map, bar, p * kBox,
               row + r, z);
}

// The rows a kGather or kRagged kernel reads and writes without tensor
// maps. kGather: tile row r of expert e is tokens[idx[e * C + r]], every
// index in [0, n_src). kRagged: tokens is x [N, M] (n_src = C = N), idx
// the counts [E], out the output [N, M] (the backward's dx) and grad the
// backward's cotangent [N, M].
struct Gather {
  const __nv_bfloat16* tokens;
  const int* idx;
  int n_src;
  int C;
  __nv_bfloat16* out;
  const __nv_bfloat16* grad;
};

// Start the cp.async copies of the kRows-row tile at row0 of expert e (rows
// er) into h and xin, by producer thread t (0..127). Warp w owns tile rows
// kRows/4 * w ..: lane j finds the source of its row j (kGather: reads
// and checks its index), and each step copies 32 chunks of 16 bytes (half a
// row at M = 512, one at 256, two at 128, four at 64) with the row's source
// taken from its lane by a shuffle. Rows past the expert's last are
// zero-filled from a valid address. An index out of range stops the kernel
// (device-side assert).
template <int M, int SRC>
__device__ __forceinline__ void gather_rows(uint8_t* h, uint8_t* xin,
                                            const Gather& g,
                                            const ExpertRows& er, int row0,
                                            int t) {
  constexpr int kRows = Cfg<M>::kRows;
  constexpr int kWarpRows = kRows / 4;       // rows per producer warp
  constexpr int kChunks = M / 8;             // 16-byte chunks per row
  const int warp = t >> 5, lane = t & 31;
  const int my_row = row0 + kWarpRows * warp + lane;
  int tok = -1;                              // -1: past the expert's rows
  if (lane < kWarpRows && my_row < er.count) {
    if (SRC == kGather) {
      tok = g.idx[er.base + my_row];
      if (tok < 0 || tok >= g.n_src) __trap();
    } else {
      tok = (int)(er.base + my_row);
    }
  }
  const uint32_t h_s = smem_u32(h), x_s = smem_u32(xin);
#pragma unroll 4
  for (int f = lane; f < kWarpRows * kChunks; f += 32) {
    const int rw = f / kChunks;              // row in the warp's kWarpRows
    const int ch = f % kChunks;
    const int src_row = __shfl_sync(0xffffffffu, tok, rw);
    const int r = kWarpRows * warp + rw;
    const __nv_bfloat16* src =
        src_row >= 0 ? g.tokens + (size_t)src_row * M + ch * 8 : g.tokens;
    const uint32_t bytes = src_row >= 0 ? 16u : 0u;
    const uint32_t off = swz<kRows>(r, ch * 8);
    cp_async16(h_s + off, src, bytes);
    cp_async16(x_s + off, src, bytes);
  }
}

// The producer warpgroup's start, by producer thread t: with kGather or
// kRagged, start the tile's row copies, let thread 0 fill the fresh ring's
// first stages (load_w(j) loads W stage j), wait for the copies, fence them
// to the async proxy (wgmma reads through it) and arrive on x_full (count
// 128). In place, thread 0 loads the tile into h and xin by TMA. Returns
// the number of W stages thread 0 has started. Thread 0 arrives before it
// blocks on a ring stage: those clear only once the consumers, who wait
// for x_full, run.
template <int M, int SRC, typename LoadW>
__device__ __forceinline__ int produce_input(const CUtensorMap* x_map,
                                             const Gather& g,
                                             const ExpertRows& er,
                                             uint8_t* h, uint8_t* xin,
                                             uint64_t* x_full, int e,
                                             int row0, int t, int n_w,
                                             LoadW load_w) {
  using C = Cfg<M>;
  int j = 0;
  if constexpr (SRC != kInPlace) {
    gather_rows<M, SRC>(h, xin, g, er, row0, t);
    if (t == 0)
      for (; j < n_w && j < C::kStages; ++j) load_w(j);
    cp_async_wait_all();
    fence_async_smem();
    mbar_arrive(x_full);
    __syncwarp();
  } else if (t == 0) {
    mbar_expect_tx(x_full, 2 * C::kTileBytes);
    load_rows<M>(h, x_map, x_full, row0, C::kRows, 0, C::kRows, e);
    load_rows<M>(xin, x_map, x_full, row0, C::kRows, 0, C::kRows, e);
  }
  return j;
}

// Copy the part of warpgroup `cw` (64 rows) between the tile and rows
// base + row .. of a [., M] array, by warpgroup thread t, in 16-byte
// chunks (consecutive threads, consecutive chunks of a row). Only rows
// row + r < count move; a load zero-fills the part's other rows. kRagged's
// loads and stores: a TMA box would cross into the next expert.
template <int M, bool LOAD>
__device__ __forceinline__ void copy_rows(__nv_bfloat16* mem, uint8_t* tile,
                                          int cw, int t, long long base,
                                          int row, int count) {
  using C = Cfg<M>;
  constexpr int kChunks = C::kWN / 8;
  const int r0 = C::row_of(cw), c0 = C::col_of(cw);
#pragma unroll 4
  for (int i = t; i < kBox * kChunks; i += kWgThreads) {
    const int r = i / kChunks, ch = i % kChunks;
    uint4* s = reinterpret_cast<uint4*>(
        tile + swz<C::kRows>(r0 + r, c0 + ch * 8));
    const bool in = row + r < count;
    uint4* gm = reinterpret_cast<uint4*>(mem + (base + row + r) * M + c0 +
                                         ch * 8);
    if (LOAD)
      *s = in ? *gm : make_uint4(0u, 0u, 0u, 0u);
    else if (in)
      *gm = *s;
  }
}

// Store the part of warpgroup `cw` to rows [row, row + 64) of a [., C, M]
// tensor map (clipped at C).
template <int M>
__device__ __forceinline__ void store_rows(const CUtensorMap* map,
                                           const uint8_t* tile, int cw,
                                           int row, int z) {
  using C = Cfg<M>;
#pragma unroll
  for (int p = 0; p < C::kWN / kBox; ++p) {
    const int pp = C::col_of(cw) / kBox + p;
    tma_store(map, tile + pp * C::kPanelBytes + C::row_of(cw) * 128,
              pp * kBox, row, z);
  }
  bulk_commit();
}

// Load rows [row, row + 64) of a [., C, M] tensor map into the part of
// warpgroup `cw` (zero-filled past C): kBox * kWN * 2 bytes on bar.
template <int M>
__device__ __forceinline__ void load_part(uint8_t* tile, const CUtensorMap* map,
                                          uint64_t* bar, int cw, int row,
                                          int z) {
  using C = Cfg<M>;
#pragma unroll
  for (int p = 0; p < C::kWN / kBox; ++p) {
    const int pp = C::col_of(cw) / kBox + p;
    tma_load(tile + pp * C::kPanelBytes + C::row_of(cw) * 128, map, bar,
             pp * kBox, row, z);
  }
}

// ----------------------------------------------------------- consumer ----
// acc = A @ B for one layer, A = the 64 rows of warpgroup cw's part of the
// tile at `a` (K-major, all M columns), B streamed through the ring:
// MN-major slices of W (TB = 1) or K-major slices (TB = 0), the part's
// columns of them. Each stage is released once its products are done; the
// products of a stage stay in flight while the next stage's are issued.
template <int M, int TB>
__device__ __forceinline__ void layer_product(float (&acc)[Cfg<M>::kAcc],
                                              uint32_t a, uint32_t ring,
                                              uint64_t* full, uint64_t* empty,
                                              int& stage, uint32_t& phase,
                                              int cw) {
  using C = Cfg<M>;
  // a stage holds one box of kStageK x 64 (TB = 1) or 64 x kStageK per 64
  // columns of B
  const uint32_t b_part = C::col_of(cw) / kBox * (C::kStageBytes / (M / kBox));
  fence_acc(acc);
  wg_fence();
  int prev = 0;
#pragma unroll 1
  for (int kc = 0; kc < C::kKChunks; ++kc) {
    mbar_wait(&full[stage], phase);
    const uint32_t b = ring + stage * C::kStageBytes + b_part;
#pragma unroll
    for (int ks = 0; ks < C::kStageK / 16; ++ks) {
      // k = 32 kc + 16 ks: panel k / 64 of the tile, 2 (k % 64) bytes in
      const uint64_t da = desc_kmajor(a + (kc >> 1) * C::kPanelBytes +
                                      (kc & 1) * 64 + ks * 32);
      const uint64_t db =
          TB ? desc_mnmajor(b + ks * 2048, C::kStageK * 128)
             : desc_kmajor64(b + ks * 32);
      Wgmma<C::kWN, 0, TB>::mma(acc, da, db, (kc | ks) != 0);
    }
    wg_commit();
    if (kc > 0) {
      wg_wait<1>();
      mbar_arrive(&empty[prev]);
    }
    prev = stage;
    if (++stage == C::kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  wg_wait<0>();
  fence_acc(acc);
  mbar_arrive(&empty[prev]);
}

// Accumulator element (4j + 2half + i) of thread t sits at row
// 16*warp + lane/4 + 8*half and column 8j + 2*(lane%4) + i of the
// warpgroup's part (64 rows, kWN columns).

// The forward epilogue of layer l for this warpgroup's rows of h (in place).
// With `mask` set, also records the ReLU mask (output > 0) as bits, one
// word per 32 accumulator elements, laid out [word][consumer thread].
template <int M>
__device__ __forceinline__ void fwd_epilogue(float (&acc)[Cfg<M>::kAcc],
                                             uint8_t* h, uint8_t* xin,
                                             const __nv_bfloat16* bias,
                                             bool skip, bool last,
                                             uint32_t* mask, int cw, int t) {
  using C = Cfg<M>;
  const int lane = t & 31;
  const int r0 = C::row_of(cw) + (t >> 5) * 16 + (lane >> 2);
  const int q = lane & 3;
  const __nv_bfloat162 zero2 = __float2bfloat162_rn(0.0f);
  uint32_t bits[C::kMaskWords];
#pragma unroll
  for (int w = 0; w < C::kMaskWords; ++w) bits[w] = 0u;
#pragma unroll
  for (int j = 0; j < C::kWN / 8; ++j) {
    const int c = C::col_of(cw) + 8 * j + 2 * q;
    const __nv_bfloat162 b2 = *reinterpret_cast<const __nv_bfloat162*>(bias + c);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = 4 * j + 2 * half;
      const uint32_t off = swz<C::kRows>(r0 + 8 * half, c);
      // a bf16x2 add rounds the exact sum once: the plain version's fp32
      // add and bf16 cast give the same value
      __nv_bfloat162 z =
          __hadd2(__float22bfloat162_rn(make_float2(acc[i], acc[i + 1])), b2);
      if (skip) {
        __nv_bfloat162* xp = reinterpret_cast<__nv_bfloat162*>(xin + off);
        z = __hadd2(z, *xp);
        if (!last) z = __hmax2(z, zero2);
        *xp = z;
      } else if (!last) {
        z = __hmax2(z, zero2);
      }
      *reinterpret_cast<__nv_bfloat162*>(h + off) = z;
      bits[i / 32] |= (__low2float(z) > 0.0f ? 1u : 0u) << (i % 32);
      bits[i / 32] |= (__high2float(z) > 0.0f ? 1u : 0u) << ((i + 1) % 32);
    }
  }
  if (mask != nullptr) {
#pragma unroll
    for (int w = 0; w < C::kMaskWords; ++w)
      mask[w * 2 * kWgThreads + cw * kWgThreads + t] = bits[w];
  }
}

// ------------------------------------------------------ K1, K3, K1R ----
// x_map is read in place, g otherwise; out_map is written unless kRagged
// (g.out then).
template <int M, int SRC>
__global__ void __launch_bounds__(kThreads, 1)
chain_fwd_sm90(const __grid_constant__ CUtensorMap x_map,
               const __grid_constant__ CUtensorMap w_map,
               const __grid_constant__ CUtensorMap out_map,
               const __nv_bfloat16* __restrict__ bs, const Gather g, int E,
               int L, unsigned skip_mask) {
  using C = Cfg<M>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const Smem<M> lay(L, false);
  uint8_t* h = smem + lay.h;
  uint8_t* xin = smem + lay.xin;
  uint8_t* ring = smem + lay.ring;
  __nv_bfloat16* bias = reinterpret_cast<__nv_bfloat16*>(smem + lay.bias);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bars);
  uint64_t* empty = full + C::kStages;
  uint64_t* x_full = empty + C::kStages;

  const int e = blockIdx.y;
  const int row0 = blockIdx.x * C::kRows;
  const ExpertRows er = expert_rows<SRC>(g.idx, e, g.C);
  if (SRC == kRagged && row0 >= er.count) return;  // past its rows
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * kWgThreads);
    }
    mbar_init(x_full, SRC != kInPlace ? kWgThreads : 1);
    fence_barrier_init();
  }
  load_bias<M>(bias, bs, E, e, L);
  __syncthreads();

  if (threadIdx.x < kWgThreads) {  // producer
    int stage = 0;
    uint32_t phase = 0;
    auto load_w = [&](int j) {  // W stage j: layer j / kKChunks
      produce_stage<M, true>(&w_map, ring, full, empty,
                             (j / C::kKChunks) * E + e, j % C::kKChunks,
                             stage, phase);
    };
    const int n_w = L * C::kKChunks;
    int j = produce_input<M, SRC>(&x_map, g, er, h, xin, x_full, e, row0,
                                  threadIdx.x, n_w, load_w);
    regs_dec<kProducerRegs>();
    if (threadIdx.x == 0)
      for (; j < n_w; ++j) load_w(j);
  } else {  // consumers
    regs_inc<kConsumerRegs>();
    const int cw = threadIdx.x / kWgThreads - 1;
    const int t = threadIdx.x % kWgThreads;
    const uint32_t a = smem_u32(h) + C::row_of(cw) * 128;
    float acc[C::kAcc];
    int stage = 0;
    uint32_t phase = 0;
    mbar_wait(x_full, 0);
    for (int l = 0; l < L; ++l) {
      layer_product<M, 1>(acc, a, smem_u32(ring), full, empty, stage, phase,
                          cw);
      // kSplit: the other warpgroup still reads these columns as A
      if constexpr (C::kSplit) part_sync<M>(cw);
      fwd_epilogue<M>(acc, h, xin, bias + l * M, (skip_mask >> l) & 1u,
                      l == L - 1, nullptr, cw, t);
      fence_async_smem();
      part_sync<M>(cw);
    }
    if constexpr (SRC == kRagged) {
      copy_rows<M, false>(g.out, h, cw, t, er.base, row0 + C::row_of(cw),
                          er.count);
    } else if (t == 0) {
      store_rows<M>(&out_map, h, cw, row0 + C::row_of(cw), e);
      bulk_wait();
    }
  }
}

// ------------------------------------------------------------- host ----
// A 3-D tensor map over [outer, rows, M] (M contiguous) with boxes of
// box_m x box_rows: bf16, 64 x 64 with the 128-byte swizzle unless given
// (fp32: chain_tf32.cuh). cuTensorMapEncodeTiled comes from libcuda
// through the runtime's entry-point query, so the library needs no -lcuda.
inline int make_map(CUtensorMap* map, const void* ptr, int m, long long rows,
                    long long outer, int box_m = kBox, int box_rows = kBox,
                    CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B,
                    CUtensorMapDataType dtype =
                        CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return (int)cudaErrorNotSupported;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  const cuuint64_t dims[3] = {(cuuint64_t)m, (cuuint64_t)rows,
                              (cuuint64_t)outer};
  const cuuint64_t elem = dtype == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? 4 : 2;
  const cuuint64_t strides[2] = {(cuuint64_t)m * elem,
                                 (cuuint64_t)m * elem * (cuuint64_t)rows};
  const cuuint32_t box[3] = {(cuuint32_t)box_m, (cuuint32_t)box_rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = encode(
      map, dtype, 3, const_cast<void*>(ptr), dims,
      strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The input of a chain launch: x [E, C, M] read in place (a tensor map), or
// the rows g names (kGather, kRagged).
template <int SRC>
inline int input_map(CUtensorMap* x_map, Gather* g, const void* src,
                     const int* idx, int n_src, int M, int E, int C) {
  *g = Gather{static_cast<const __nv_bfloat16*>(src), idx, n_src, C,
              nullptr, nullptr};
  if (SRC != kInPlace) {
    *x_map = CUtensorMap{};  // not read
    return 0;
  }
  return make_map(x_map, src, M, C, E);
}

// A chain launch's [E, C, M] output or dx by tensor map, or (kRagged) the
// [C, M] array itself through g (store: g->out, else g->grad is set by the
// caller).
template <int SRC>
inline int output_map(CUtensorMap* map, Gather* g, void* out, int M, int E,
                      int C) {
  if (SRC == kRagged) {
    g->out = static_cast<__nv_bfloat16*>(out);
    *map = CUtensorMap{};  // not written
    return 0;
  }
  return make_map(map, out, M, C, E);
}

template <int M, int SRC>
int launch_fwd_width(const void* src, const int* idx, int n_src,
                     const void* ws, const void* bs, void* out, int E, int C,
                     int L, unsigned skip_mask, cudaStream_t stream) {
  CUtensorMap x_map, w_map, out_map;
  Gather g;
  int rc;
  if ((rc = input_map<SRC>(&x_map, &g, src, idx, n_src, M, E, C)) != 0)
    return rc;
  if ((rc = make_map(&w_map, ws, M, M, (long long)L * E, kBox,
                     Cfg<M>::kStageK)) != 0)
    return rc;
  if ((rc = output_map<SRC>(&out_map, &g, out, M, E, C)) != 0) return rc;
  const int smem = Smem<M>(L, false).bytes;
  auto kern = chain_fwd_sm90<M, SRC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((C + Cfg<M>::kRows - 1) / Cfg<M>::kRows, E);
  kern<<<grid, kThreads, smem, stream>>>(
      x_map, w_map, out_map, static_cast<const __nv_bfloat16*>(bs), g, E, L,
      skip_mask);
  return (int)cudaGetLastError();
}

// Returns a cudaError_t code (0 = launched). src is x [E, C, M], with
// kGather the token rows [n_src, M] that idx [E * C] names, with kRagged
// x [C, M] sorted by expert and idx the counts [E] (out is then [C, M]).
// Widths other than 64/128/256/512 are refused with cudaErrorInvalidValue;
// the Python wrappers check first.
template <int SRC>
int launch_chain_fwd(int device, const void* src, const int* idx, int n_src,
                     const void* ws, const void* bs, void* out, int E, int C,
                     int M, int L, unsigned skip_mask, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (E <= 0 || C <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (M) {
    case 64:
      return launch_fwd_width<64, SRC>(src, idx, n_src, ws, bs, out, E, C, L,
                                       skip_mask, s);
    case 128:
      return launch_fwd_width<128, SRC>(src, idx, n_src, ws, bs, out, E, C, L,
                                        skip_mask, s);
    case 256:
      return launch_fwd_width<256, SRC>(src, idx, n_src, ws, bs, out, E, C, L,
                                        skip_mask, s);
    case 512:
      return launch_fwd_width<512, SRC>(src, idx, n_src, ws, bs, out, E, C, L,
                                        skip_mask, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace sm90
