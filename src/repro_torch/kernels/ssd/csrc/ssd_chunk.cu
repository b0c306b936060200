// Mamba-2 SSD intra-chunk block — the Hopper kernel of the port's chunked
// SSD (models/mamba2.py::ssd_chunked).
//
// Replaces the TPU kernel ssd_chunk_pallas of the JAX package
// (src/repro/kernels/ssd/kernel.py, body _ssd_kernel).
//
// For every chunk bc and head h, over the chunk's rows q, t < Q:
//   y[q]  = sum_{t <= q} rnd(exp(cs[q] - cs[t]) * (C[q] . B[t])) * xdt[t]
//   state = sum_t B[t]^T (exp(cs[Q-1] - cs[t]) * xdt[t])            (N, P)
// where cs is the inclusive cumulative decay (f32), rnd rounds to xdt's
// dtype (as the plain version rounds (C.B^T)oL before its product with
// xdt), y is written in xdt's dtype and the state in f32.  Tensors come
// with strides (the last axis contiguous), so the model's
// (B, nc, Q, H, P) activations are read as (B*nc, H, Q, P) views, and a
// group of B and C shared by all heads is a stride-0 head axis: nothing
// is repeated in memory.
//
// Design:
//   * One launch, two roles.  grid.x = ceil(Q/64) y tiles (longest
//     causal rows first) then the state tiles, grid.y = head blocks,
//     grid.z = BC, so the CTAs of one chunk run together and share its
//     B, C and xdt in L2.  A y CTA takes 64 rows of q and walks the
//     64-row t tiles up to its diagonal (the TPU kernel's whole (Q, Q)
//     block, cut into the causal tiles); a state CTA walks every t tile.
//   * bf16 (ssd_wgmma_kernel), for Hopper, HB warpgroups a CTA:
//     - Heads that share B and C (mamba2's one group: a stride-0 head
//       axis) come two to a CTA (HB = 2), one warpgroup each: B and C
//       are staged once for both, and each warpgroup computes 32 of the
//       64 t columns of S = C_q B_t^T and they swap halves through
//       shared memory, so C B^T is done once a head pair.  A state CTA
//       takes one head and two 64-row n blocks, one a warpgroup, so its
//       split (below) is done once for both.  Per-head B and C (and f32)
//       take one warpgroup, one head, one n block (HB = 1), same code.
//       256 threads, 124 registers and 97 KB at P = 64: two CTAs, 16
//       warps an SM (one warpgroup a CTA with two heads in registers,
//       or three ring stages, measured slower: fewer warps an SM).
//     - Ring: thread 0 issues TMA copies (maps over the tensors' own
//       strides, built on the host through cudaGetDriverEntryPoint,
//       passed __grid_constant__): C_q once, then (B_t, xdt_t of the
//       CTA's heads, one box) into a 2-stage ring on mbarriers, so tile
//       t + 1 is in flight while tile t is in the math.  The hardware
//       zero-fills rows past Q, heads past H, columns past N (B, C are
//       taken in 64-column blocks) and P = 16 up to 32.
//     - y: S on wgmma m64n32k16 (m64n64k16 at HB = 1; both K-major,
//       128-byte swizzle); the decay 2^(cs[q] log2 e - cs[t] log2 e)
//       (ex2.approx, one MUFU op) on S's accumulator, masked entries
//       (t > q, rows past Q; only on the diagonal and ragged tiles) set
//       to 0 without it, rounded to bf16 and packed as wgmma's A
//       fragments; y_h += that * xdt_h,t on wgmma with xdt read
//       row-major through the transpose bit (as flash_attention.cu's
//       P V).  y leaves through shared memory by a TMA store.
//     - state: to_end * xdt_t in f32 (to_end by expf), split into three
//       bf16 parts (high, remainder, remainder of the remainder: ~2^-24,
//       what the f32 state needs; B is bf16, exact in either), written
//       by all threads at the same swizzled offsets as xdt's tile; then
//       state += B_t^T part_k on wgmma, smallest part first, B_t^T as
//       register fragments (ldmatrix.trans, once a tile for the three
//       parts) and the parts MN-major in shared memory.  (A 3-stage ring
//       for the state, which fits the same shared memory, was measured
//       no faster.)
//   * f32 (ssd_simt_kernel): CUDA-core fmaf, no TF32.  256 threads; in a
//     y CTA thread (ty, tx) owns a 4x4 block of the 64x64 S tile and rows
//     4ty..4ty+3 of y at columns tx + 16j; in a state CTA it owns rows
//     4ty..4ty+3 of the state at the same columns.  One head a CTA.
//
// Bound: at mamba2-370m's served prefill (4 x 2048 tokens: BC = 32,
// H = 32, Q = 256, N = 128, P = 64, bf16, B and C one group) the least
// traffic reads xdt (33.6 MB), B and C once per group (4.2 MB) and cs
// (1 MB), and writes y (33.6 MB) and the f32 state (33.6 MB): ~106 MB,
// 31.6 us at 3.35 TB/s.  The tensor work this kernel does there,
// C B^T once a head pair (5.4 GFLOP; 10.7 once a head), rnd(S o L) xdt
// (5.4) and the state's three parts (12.9), 23.6 GFLOP, is 24 us at the
// bf16 tensor peak: bytes bound it.
#include <cuda.h>          // CUtensorMap and its enums (no -lcuda: the
                           // encoder comes from cudaGetDriverEntryPoint)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BQ = 64;           // q rows (y role) or n rows (state role)
constexpr int BT = 64;           // t rows per staged tile

struct Args {
    const void* xdt;             // (BC, H, Q, P) xdt's dtype
    const void* b;               // (BC, H, Q, N) xdt's dtype
    const void* c;               // (BC, H, Q, N) xdt's dtype
    const float* cs;             // (BC, H, Q) f32
    void* y;                     // (BC, H, Q, P) xdt's dtype
    float* state;                // (BC, H, N, P) f32, contiguous
    int H, Q, N, P;
    int x0;                      // grid.x offset: 0, or the y tiles
                                 // skipped by a state-only launch
    int hpg;                     // heads per group of B and C: 1 or H
    // element strides of (bc, h, q); the last axis is contiguous
    long long xb, xh, xq, bb, bh, bq, cb, ch, cq, sb, sh, sq, yb, yh, yq;
};

__device__ __forceinline__ int tiles(int n, int t) { return (n + t - 1) / t; }

// ---------------------------------------------- bf16, wgmma + TMA ring

constexpr int WG = 128;           // one warpgroup: 4 warps x 16 rows
constexpr int STAGES = 2;         // ring depth: tile j sits in stage
                                  // j % STAGES
constexpr int SPLIT = 3;          // bf16 parts of to_end * xdt
constexpr int BLK = 64 * 128;     // bytes of a 64-row, 128-byte column block

// A 64-row bf16 tile of W columns is stored as column blocks of 64 rows
// x RB bytes (RB = 128, or 64 at W = 32), one TMA box each, swizzled as
// TMA's SWIZZLE_128B / SWIZZLE_64B write them and wgmma's B128 / B64
// layouts read them.  B and C tiles (W = N, padded to 64s by TMA's zero
// fill) take 128-byte blocks; xdt tiles take W = PT, P padded to 32.
template <int PT>
struct XTile {
    static constexpr int RB = 2 * PT < 128 ? 2 * PT : 128;   // row bytes
    static constexpr int NCB = 2 * PT / RB;                  // col blocks
    static constexpr int BYTES = 64 * PT * 2;                // one head
    static constexpr uint64_t LAYOUT = RB == 128 ? 1 : 2;    // B128 / B64
};

__device__ __forceinline__ uint32_t smem_u32(const void* p)
{
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 :: "r"(bar) : "memory");
}

// one arrival that also announces `bytes` of TMA writes to come
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes)
{
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}

// spin until the barrier's phase `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity)
{
    asm volatile(
        "{\n.reg .pred done;\n"
        "WAIT_%=:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
        "@!done bra WAIT_%=;\n}\n"
        :: "r"(bar), "r"(parity) : "memory");
}

// one box of a 4-D tensor map at coordinates (c0, c1, c2, c3) into dst;
// completes on `bar`; the hardware zero-fills what lies outside the
// tensor
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap& map,
                                        uint32_t bar, int c0, int c1,
                                        int c2, int c3)
{
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier"
        "::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
        :: "r"(dst), "l"((uint64_t)&map), "r"(c0), "r"(c1), "r"(c2),
           "r"(c3), "r"(bar)
        : "memory");
}

// rows r0.. of a B or C tile (the group's (q, n) matrix), all of N
__device__ __forceinline__ void tma_bc(uint32_t dst, const CUtensorMap& map,
                                       uint32_t bar, int ncb, int r0, int g,
                                       int bc)
{
    for (int cb = 0; cb < ncb; ++cb)
        tma_box(dst + cb * BLK, map, bar, cb * 64, r0, g, bc);
}

// rows r0.. of xdt for heads h0 .. h0+HB-1: one box per column block,
// laid out [column block][head][row], so each head's column block is a
// swizzled 64-row tile of its own
template <int PT, int HB>
__device__ __forceinline__ void tma_x(uint32_t dst, const CUtensorMap& map,
                                      uint32_t bar, int r0, int h0, int bc)
{
    using X = XTile<PT>;
#pragma unroll
    for (int cb = 0; cb < X::NCB; ++cb)
        tma_box(dst + cb * HB * 64 * X::RB, map, bar, cb * X::RB / 2, r0,
                h0, bc);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi)
{
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle layout (1 = B128, 2 = B64)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout)
{
    return (uint64_t)((addr & 0x3FFFF) >> 4) |
           ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
           ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// K-major operand in 128-byte blocks (n contiguous: C_q, B_t for C B^T):
// k-step ks (16 columns) of a 64-row tile
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int ks)
{
    const uint32_t col = ks * 32;
    return smem_desc(tile + (col / 128) * BLK + col % 128, 16, 1024, 1);
}

// MN-major operand (read with the transpose bit): k-step kk (16 rows) of
// a 64-row tile whose rows are the reduction axis (t); column blocks of
// RB bytes lie `lbo` bytes apart, 8-row groups 8 * RB
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int kk,
                                                 int rb, uint32_t lbo,
                                                 uint64_t layout)
{
    return smem_desc(tile + kk * 16 * rb, lbo, 8 * rb, layout);
}

__device__ __forceinline__ void wgmma_fence()
{
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit()
{
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait()
{
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads across a wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N])
{
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

#define WG_ACC8(o)                                                        \
    "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]),          \
    "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])
#define WG_REGS16                                                         \
    "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define WG_REGS32 WG_REGS16 ", %16, %17, %18, %19, %20, %21, %22, %23, "   \
    "%24, %25, %26, %27, %28, %29, %30, %31"
#define WG_REGS64 WG_REGS32 ", %32, %33, %34, %35, %36, %37, %38, %39, "   \
    "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "   \
    "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"

// S (64 x NT, f32) (+)= C (64 x 16) * B^T (16 x NT), both K-major in
// shared memory; S += only when accumulate != 0
template <int NT>
__device__ __forceinline__ void wgmma_cb(float (&d)[NT / 2], uint64_t da,
                                         uint64_t db, int accumulate);

template <>
__device__ __forceinline__ void wgmma_cb<32>(float (&d)[16], uint64_t da,
                                             uint64_t db, int accumulate)
{
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {" WG_REGS16
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : WG_ACC8(0), WG_ACC8(8)
        : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_cb<64>(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate)
{
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" WG_REGS32
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : WG_ACC8(0), WG_ACC8(8), WG_ACC8(16), WG_ACC8(24)
        : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x N) += A (64 x 16, bf16 fragments in registers, mma.sync's A
// layout) * B (16 x N, MN-major in shared memory: xdt or a part of the
// state's split)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db)
{
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {" WG_REGS16
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : WG_ACC8(0), WG_ACC8(8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db)
{
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" WG_REGS32
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : WG_ACC8(0), WG_ACC8(8), WG_ACC8(16), WG_ACC8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db)
{
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" WG_REGS64
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : WG_ACC8(0), WG_ACC8(8), WG_ACC8(16), WG_ACC8(24),
          WG_ACC8(32), WG_ACC8(40), WG_ACC8(48), WG_ACC8(56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// A fragments of B_t^T (mma.sync's A layout: this warp's 16 n rows by
// 16 t) for the k-steps kk = 0..3 of a [t][n] tile of 64 rows of 128
// bytes in 128-byte swizzle, by ldmatrix.trans: lanes 8m .. 8m+7 give
// the rows of matrix m, t = 16 kk + 8 (m >> 1) + lane % 8, n chunk
// 2 warp + (m & 1)
__device__ __forceinline__ void load_bt(uint32_t (&a)[4][4], uint32_t tile,
                                        int warp, int lane)
{
    const int m = lane >> 3, c = 2 * warp + (m & 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
        const int t = 16 * kk + 8 * (m >> 1) + (lane & 7);
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
            "{%0, %1, %2, %3}, [%4];\n"
            : "=r"(a[kk][0]), "=r"(a[kk][1]), "=r"(a[kk][2]), "=r"(a[kk][3])
            : "r"(tile + t * 128 + ((c ^ (t & 7)) << 4)));
    }
}

constexpr float LOG2E = 1.4426950408889634f;

// 2^x in one MUFU operation (ex2.approx.ftz; results below 2^-126 flush
// to 0): y's decay exp(cs[q] - cs[t]) = 2^(cs[q] log2 e - cs[t] log2 e),
// rounded to bf16 after it.  The state's to_end, carried in f32, keeps
// expf.
__device__ __forceinline__ float ex2(float x)
{
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// named barrier over the CTA's warpgroups (id 0 is __syncthreads')
__device__ __forceinline__ void bar_sync(int id, int threads)
{
    asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// dynamic shared memory of the kernel, 1024 bytes of alignment slack
// included: the larger of the y role's C_q, ring of (B_t, xdt_t of HB
// heads) and S exchange, and the state role's ring of (B_t's HB n
// blocks, xdt_t of its head) and parts of to_end * xdt
size_t wg_smem_bytes(int N, int PT, int HB)
{
    const size_t ncb = (N + 63) / 64, xt = (size_t)64 * PT * 2;
    const size_t xch = HB > 1 ? (size_t)HB * 16 * WG * 4 : 0;
    const size_t y = ncb * BLK + STAGES * (ncb * BLK + HB * xt) + xch;
    const size_t st = STAGES * (HB * BLK + xt) + SPLIT * xt;
    return 1024 + (y > st ? y : st);
}

// rnd(S o L) as wgmma's A fragments.  S's t columns 0-31 are in lo,
// 32-63 in hi: element 4 * n8 + e is row r0 (e = 0, 1) or r0 + 8 (e = 2,
// 3), t column 8 * n8 + 2 * t4 + (e & 1).  L = 2^(csq - cst) where t <=
// q < Q, else 0 (without ex2: MASK tiles only).
template <bool MASK>
__device__ __forceinline__ void decay_pack(const float (&lo)[16],
                                           const float (&hi)[16],
                                           uint32_t (&pf)[4][4],
                                           const float* ct,
                                           const float (&csq)[2],
                                           const int (&qrow)[2], int t0,
                                           int t4, int Q)
{
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8) {
        const float2 c2 = *reinterpret_cast<const float2*>(
            &ct[8 * n8 + 2 * t4]);
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int row = e >> 1, q = qrow[row];
            const int t = t0 + 8 * n8 + 2 * t4 + (e & 1);
            const bool keep = !MASK || (t <= q && q < Q);
            const float sv = n8 < 4 ? lo[4 * n8 + e] : hi[4 * n8 + e - 16];
            v[e] = keep ? sv * ex2(csq[row] - ((e & 1) ? c2.y : c2.x))
                        : 0.f;
        }
        pf[n8 >> 1][2 * (n8 & 1)] = pack_bf16(v[0], v[1]);
        pf[n8 >> 1][2 * (n8 & 1) + 1] = pack_bf16(v[2], v[3]);
    }
}

// decay_pack on the diagonal and ragged tiles, its unmasked copy below
__device__ __forceinline__ void decay_tile(bool mask, const float (&lo)[16],
                                           const float (&hi)[16],
                                           uint32_t (&pf)[4][4],
                                           const float* ct,
                                           const float (&csq)[2],
                                           const int (&qrow)[2], int t0,
                                           int t4, int Q)
{
    if (mask)
        decay_pack<true>(lo, hi, pf, ct, csq, qrow, t0, t4, Q);
    else
        decay_pack<false>(lo, hi, pf, ct, csq, qrow, t0, t4, Q);
}

// The y tile of q rows q0.. for heads h0 .. h0+HB-1 of one group, one
// warpgroup a head (a head past H computes on TMA's zeros and stores
// nothing).  For each t tile up to the diagonal: S = C_q B_t^T once (with
// two heads each warpgroup computes 32 of its t columns and they swap
// halves through shared memory), then each warpgroup applies its head's
// decay exp(cs[q] - cs[t]) (masked entries are 0, exp never evaluated),
// rounds to bf16 and adds that * xdt_h,t to its head's y, on wgmma.
template <int PT, int HB>
__device__ void y_tile(const CUtensorMap& tx, const CUtensorMap& tb,
                       const CUtensorMap& tc, const CUtensorMap& ty,
                       const Args& a, int bc, int h0,
                       int q0, uint32_t b0, uint32_t base,
                       float (*cst)[HB][64])
{
    using X = XTile<PT>;
    constexpr int NT = 64 / HB;        // S columns this warpgroup computes
    const int Q = a.Q, N = a.N, ncb = (N + 63) / 64;
    const int g = h0 / a.hpg;
    const uint32_t Cs = base;
    const uint32_t stage_bytes = ncb * BLK + HB * X::BYTES;
    auto bst = [&](int j) {
        return base + ncb * BLK + (j % STAGES) * stage_bytes;
    };
    auto xst = [&](int j) { return bst(j) + ncb * BLK; };
    // S halves: float4 i4 of thread tw of warpgroup w at (w * 4 + i4) * WG + tw
    float4* xch = reinterpret_cast<float4*>(__cvta_shared_to_generic(
        base + ncb * BLK + STAGES * stage_bytes));
    // the n-th use of a stage completes its barrier's phase n
    auto full = [&](int j) { return b0 + 8 * (1 + j % STAGES); };
    auto par = [](int j) { return (uint32_t)(j / STAGES) & 1u; };

    const int tid = threadIdx.x, wg = tid / WG, tw = tid % WG;
    const int warp = tw >> 5, lane = tw & 31;
    const int t4 = lane & 3, r0 = warp * 16 + (lane >> 2);
    const int h = h0 + wg;             // this warpgroup's head
    const int qrow[2] = {q0 + r0, q0 + r0 + 8};
    const int nt = q0 / 64 + 1;        // t tiles up to the diagonal
    const float* sp = a.cs + bc * a.sb;
    // cs log2 e of one t tile for the HB heads: thread tid < HB * 64
    // loads head h0 + tid / 64, row tid % 64
    auto cs_at = [&](int t0) {
        const int t = t0 + tid % 64, hh = h0 + tid / 64;
        return tid < HB * 64 && t < Q && hh < a.H
            ? __ldg(sp + hh * a.sh + t * a.sq) * LOG2E : 0.f;
    };

    if (tid == 0) {
        for (int i = 0; i < 1 + STAGES; ++i) mbar_init(b0 + 8 * i);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        mbar_expect(b0, ncb * BLK);
        tma_bc(Cs, tc, b0, ncb, q0, g, bc);
        for (int j = 0; j < STAGES && j < nt; ++j) {
            mbar_expect(full(j), stage_bytes);
            tma_bc(bst(j), tb, full(j), ncb, j * 64, g, bc);
            tma_x<PT, HB>(xst(j), tx, full(j), j * 64, h0, bc);
        }
    }
    float csq[2];
#pragma unroll
    for (int row = 0; row < 2; ++row)
        csq[row] = qrow[row] < Q && h < a.H
            ? __ldg(sp + h * a.sh + qrow[row] * a.sq) * LOG2E : 0.f;
    if (tid < HB * 64) cst[0][tid / 64][tid % 64] = cs_at(0);
    __syncthreads();                   // barriers and cs of tile 0 ready

    float acc[PT / 2];
#pragma unroll
    for (int i = 0; i < PT / 2; ++i) acc[i] = 0.f;
    uint32_t pf[4][4];

    mbar_wait(b0, 0);
    for (int j = 0; j < nt; ++j) {
        const int t0 = j * 64;
        if (j > 0) {
            __syncthreads();           // tile j-1's stage, cs, S are free
            const int f = j + STAGES - 1;  // the tile that refills it
            if (tid == 0 && f < nt) {
                mbar_expect(full(f), stage_bytes);
                tma_bc(bst(f), tb, full(f), ncb, f * 64, g, bc);
                tma_x<PT, HB>(xst(f), tx, full(f), f * 64, h0, bc);
            }
        }
        const float next = j + 1 < nt ? cs_at(t0 + 64) : 0.f;

        mbar_wait(full(j), par(j));
        float sh[NT / 2];
        wgmma_fence();
        for (int ks = 0; ks < N / 16; ++ks)
            wgmma_cb<NT>(sh, kmajor_desc(Cs, ks),
                         kmajor_desc(bst(j) + wg * NT * 128, ks), ks);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sh);
        // below the diagonal tile and above the ragged edge every entry
        // is kept: the mask is a branch the whole CTA takes
        const float* ct = &cst[j & 1][wg][0];
        const bool mask = j == nt - 1 || q0 + 64 > Q;
        if constexpr (HB == 1) {
            float lo[16], hi[16];
#pragma unroll
            for (int i = 0; i < 16; ++i) {
                lo[i] = sh[i];
                hi[i] = sh[16 + i];
            }
            decay_tile(mask, lo, hi, pf, ct, csq, qrow, t0, t4, Q);
        } else {
            // warpgroup w computed t columns 32w .. 32w+31: swap halves
#pragma unroll
            for (int i4 = 0; i4 < 4; ++i4)
                xch[(wg * 4 + i4) * WG + tw] = make_float4(
                    sh[4 * i4], sh[4 * i4 + 1], sh[4 * i4 + 2],
                    sh[4 * i4 + 3]);
            bar_sync(1, WG * HB);
            float ot[16];              // the other warpgroup's half
#pragma unroll
            for (int i4 = 0; i4 < 4; ++i4) {
                const float4 o = xch[((1 - wg) * 4 + i4) * WG + tw];
                ot[4 * i4] = o.x;
                ot[4 * i4 + 1] = o.y;
                ot[4 * i4 + 2] = o.z;
                ot[4 * i4 + 3] = o.w;
            }
            if (wg == 0)
                decay_tile(mask, sh, ot, pf, ct, csq, qrow, t0, t4, Q);
            else
                decay_tile(mask, ot, sh, pf, ct, csq, qrow, t0, t4, Q);
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
            wgmma_rs<PT>(acc, pf[kk],
                         mnmajor_desc(xst(j) + wg * 64 * X::RB, kk, X::RB,
                                      HB * 64 * X::RB, X::LAYOUT));
        wgmma_commit();
        if (tid < HB * 64) cst[(j + 1) & 1][tid / 64][tid % 64] = next;
        wgmma_wait<0>();
        fence_regs(acc);
    }

    if (h >= a.H) return;
    // y through shared memory (this head's part of stage 0, free now) in
    // xdt's swizzled tile layout, stored by TMA: rows past Q, columns
    // past P are clipped
    const uint32_t yt = bst(0) + ncb * BLK + wg * 64 * X::RB;
    unsigned char* gyt = reinterpret_cast<unsigned char*>(
        __cvta_shared_to_generic(yt));
#pragma unroll
    for (int row = 0; row < 2; ++row) {
        const int r = r0 + 8 * row;
#pragma unroll
        for (int dn = 0; dn < PT / 8; ++dn) {
            const int cbyte = (dn * 8 + 2 * t4) * 2;
            const int o = r * X::RB + cbyte % X::RB;
            const int sw = o ^ (((o >> 7) & (X::RB == 128 ? 7 : 3)) << 4);
            *reinterpret_cast<uint32_t*>(
                gyt + cbyte / X::RB * HB * 64 * X::RB + sw) =
                pack_bf16(acc[4 * dn + 2 * row], acc[4 * dn + 2 * row + 1]);
        }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bar_sync(2 + wg, WG);
    if (tw == 0) {
#pragma unroll
        for (int cb = 0; cb < X::NCB; ++cb)
            asm volatile(
                "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
                " [%0, {%1, %2, %3, %4}], [%5];\n"
                :: "l"((uint64_t)&ty), "r"(cb * X::RB / 2), "r"(q0), "r"(h),
                   "r"(bc), "r"(yt + cb * HB * 64 * X::RB)
                : "memory");
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
}

// The state of head h, rows n0 .. n0 + 64 HB - 1, one warpgroup a 64-row
// n block.  For each t tile: B_t's n blocks and the head's xdt_t; all
// threads split to_end * xdt in f32 into three bf16 parts (each takes
// what the ones before left, so they carry the f32 product to ~2^-24,
// as the plain version's f32 state needs) once for every n block, then
// each warpgroup adds B_t^T part_k for k = 2, 1, 0 on wgmma.
template <int PT, int HB>
__device__ void state_tile(const CUtensorMap& tx1, const CUtensorMap& tb,
                           const Args& a, int bc, int h, int n0,
                           uint32_t b0, uint32_t base, float* te)
{
    using X = XTile<PT>;
    const int Q = a.Q, N = a.N, g = h / a.hpg;
    const uint32_t stage_bytes = HB * BLK + X::BYTES;
    auto bst = [&](int j) { return base + (j % STAGES) * stage_bytes; };
    auto xst = [&](int j) { return bst(j) + HB * BLK; };
    // part k: a tile of xdt's layout, one head
    const uint32_t parts = base + STAGES * stage_bytes;
    unsigned char* gparts = reinterpret_cast<unsigned char*>(
        __cvta_shared_to_generic(parts));
    const unsigned char* gbase = reinterpret_cast<const unsigned char*>(
        __cvta_shared_to_generic(base));
    auto full = [&](int j) { return b0 + 8 * (1 + j % STAGES); };
    auto par = [](int j) { return (uint32_t)(j / STAGES) & 1u; };

    const int tid = threadIdx.x, wg = tid / WG, tw = tid % WG;
    const int warp = tw >> 5, lane = tw & 31;
    const int t4 = lane & 3, r0 = warp * 16 + (lane >> 2);
    const int nt = (Q + 63) / 64;
    const float* sp = a.cs + bc * a.sb + h * a.sh;
    // to_end of one t tile: thread tid < 64 takes row tid
    const bool mine = tid < 64 && h < a.H;
    const float cend = mine ? __ldg(sp + (Q - 1) * a.sq) : 0.f;
    auto cs_at = [&](int t0) {
        return mine && t0 + tid < Q ? __ldg(sp + (t0 + tid) * a.sq) : 0.f;
    };
    auto to_end = [&](float c, int t0) {
        return mine && t0 + tid < Q ? expf(cend - c) : 0.f;
    };
    auto issue = [&](int j) {          // thread 0: tile j into its stage
        mbar_expect(full(j), stage_bytes);
        for (int w = 0; w < HB; ++w)
            tma_box(bst(j) + w * BLK, tb, full(j), n0 + 64 * w, j * 64, g,
                    bc);
        tma_x<PT, 1>(xst(j), tx1, full(j), j * 64, h, bc);
    };

    if (tid == 0) {
        for (int i = 0; i < 1 + STAGES; ++i) mbar_init(b0 + 8 * i);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        for (int j = 0; j < STAGES && j < nt; ++j) issue(j);
    }
    if (tid < 64) te[tid] = to_end(cs_at(0), 0);
    __syncthreads();                   // barriers and to_end of tile 0

    float acc[PT / 2];
#pragma unroll
    for (int i = 0; i < PT / 2; ++i) acc[i] = 0.f;

    for (int j = 0; j < nt; ++j) {
        const int t0 = j * 64;
        if (j > 0) {
            wgmma_wait<0>();           // tile j-1's products are done
            fence_regs(acc);
            __syncthreads();           // ... in every warp: parts free
            const int f = j + STAGES - 1;  // the tile that refills
            if (tid == 0 && f < nt) issue(f);  // tile j-1's stage
        }
        const float next = j + 1 < nt ? cs_at(t0 + 64) : 0.f;
        mbar_wait(full(j), par(j));
        uint32_t bt[4][4];             // B_t^T of this warpgroup's n block
        load_bt(bt, bst(j) + wg * BLK, warp, lane);

        // the split: 16-byte chunks at the same swizzled offset in xdt's
        // stage and in each part; a chunk's row is its t
        const unsigned char* xs = gbase + (xst(j) - base);
        const float* tj = te + (j & 1) * 64;
        for (int o = tid; o < X::BYTES / 16; o += WG * HB) {
            const int w = o * 16;
            const float tv = tj[(w % (64 * X::RB)) / X::RB];
            const uint4 raw = *reinterpret_cast<const uint4*>(xs + w);
            const bf16* xv = reinterpret_cast<const bf16*>(&raw);
            uint32_t pk[SPLIT][4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                float w0 = __bfloat162float(xv[2 * i]) * tv;
                float w1 = __bfloat162float(xv[2 * i + 1]) * tv;
#pragma unroll
                for (int k = 0; k < SPLIT; ++k) {
                    const __nv_bfloat162 p2 = __floats2bfloat162_rn(w0, w1);
                    pk[k][i] = *reinterpret_cast<const uint32_t*>(&p2);
                    w0 -= __low2float(p2);
                    w1 -= __high2float(p2);
                }
            }
#pragma unroll
            for (int k = 0; k < SPLIT; ++k)
                *reinterpret_cast<uint4*>(gparts + k * X::BYTES + w) =
                    make_uint4(pk[k][0], pk[k][1], pk[k][2], pk[k][3]);
        }
        // the parts, written by threads, are read by wgmma (async proxy)
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();

        wgmma_fence();
#pragma unroll
        for (int k = SPLIT - 1; k >= 0; --k)   // smallest part first
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
                wgmma_rs<PT>(acc, bt[kk],
                             mnmajor_desc(parts + k * X::BYTES, kk, X::RB,
                                          64 * X::RB, X::LAYOUT));
        wgmma_commit();
        // to_end of tile j + 1, while the products run
        if (tid < 64) te[((j + 1) & 1) * 64 + tid] = to_end(next, t0 + 64);
    }
    wgmma_wait<0>();
    fence_regs(acc);

    if (h >= a.H) return;
    float* stp = a.state + ((long long)bc * a.H + h) * N * a.P;
#pragma unroll
    for (int row = 0; row < 2; ++row) {
        const int n = n0 + 64 * wg + r0 + 8 * row;
        if (n >= N) continue;
#pragma unroll
        for (int dn = 0; dn < PT / 8; ++dn) {
            const int c = dn * 8 + 2 * t4;
            if (c < a.P)
                *reinterpret_cast<float2*>(&stp[(long long)n * a.P + c]) =
                    make_float2(acc[4 * dn + 2 * row],
                                acc[4 * dn + 2 * row + 1]);
        }
    }
}

// HB = 1 or 2 warpgroups: a y CTA takes HB heads of a group, a state
// CTA one head and HB n blocks (two CTAs an SM at HB = 2, P <= 64)
template <int PT, int HB>
__global__ void __launch_bounds__(WG * HB, HB == 2 && PT <= 64 ? 2 : 1)
ssd_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                 const __grid_constant__ CUtensorMap tx1,
                 const __grid_constant__ CUtensorMap tb,
                 const __grid_constant__ CUtensorMap tc,
                 const __grid_constant__ CUtensorMap ty, Args a)
{
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __shared__ __align__(8) uint64_t bars[1 + STAGES];
    __shared__ __align__(16) float cs_s[2][HB][64];
    const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
    const int nq = (a.Q + 63) / 64, x = blockIdx.x + a.x0;
    const int h0 = blockIdx.y * HB, bc = blockIdx.z;
    if (x < nq)                        // longest causal rows first
        y_tile<PT, HB>(tx, tb, tc, ty, a, bc, h0, (nq - 1 - x) * 64,
                       smem_u32(bars), base, cs_s);
    else                               // head h0 + x' % HB, n blocks
        state_tile<PT, HB>(tx1, tb, a, bc, h0 + (x - nq) % HB,
                           (x - nq) / HB * 64 * HB, smem_u32(bars), base,
                           &cs_s[0][0][0]);
}

// ------------------------------------------------------------- f32 SIMT

constexpr int SIMT_THREADS = 256;
constexpr int LDT = BQ + 4;       // row stride of the f32 tiles

size_t simt_smem_bytes(int N, int P)
{
    // y: Ct, Bt (N, LDT), Pt (BT, LDT), Xs (BT, P), cs of q and t;
    // state: Bd (BT, LDT), Xs (BT, P), to_end (BT)
    const size_t y = 4 * (2 * (size_t)N * LDT + (size_t)BT * LDT +
                          (size_t)BT * P + BQ + BT);
    const size_t st = 4 * ((size_t)BT * LDT + (size_t)BT * P + BT);
    return y > st ? y : st;
}

template <int P>
__device__ void y_tile_simt(const Args& a, int bc, int h, int q0,
                            float* smem)
{
    constexpr int PJ = P / 16;
    const int N = a.N, Q = a.Q;
    float* Ct = smem;                  // Ct[n * LDT + r]
    float* Bt = Ct + N * LDT;          // Bt[n * LDT + r]
    float* Pt = Bt + N * LDT;          // Pt[t * LDT + r]
    float* Xs = Pt + BT * LDT;         // Xs[t * P + p]
    float* csq = Xs + BT * P;
    float* cst = csq + BQ;

    const float* xp = (const float*)a.xdt + bc * a.xb + h * a.xh;
    const float* bp = (const float*)a.b + bc * a.bb + h * a.bh;
    const float* cp = (const float*)a.c + bc * a.cb + h * a.ch;
    const float* sp = a.cs + bc * a.sb + h * a.sh;
    float* yp = (float*)a.y + bc * a.yb + h * a.yh;
    const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

#pragma unroll 4
    for (int e = tid; e < BQ * N; e += SIMT_THREADS) {
        const int r = e / N, n = e % N, q = q0 + r;
        Ct[n * LDT + r] = q < Q ? __ldg(cp + q * a.cq + n) : 0.f;
    }
    for (int r = tid; r < BQ; r += SIMT_THREADS)
        csq[r] = q0 + r < Q ? __ldg(sp + (q0 + r) * a.sq) : 0.f;

    float acc[4][PJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < PJ; ++j) acc[i][j] = 0.f;

    const int nt = q0 / BT + 1;
    for (int jt = 0; jt < nt; ++jt) {
        const int t0 = jt * BT;
        __syncthreads();               // Bt, Pt, Xs and cst free again
#pragma unroll 4
        for (int e = tid; e < BT * N; e += SIMT_THREADS) {
            const int r = e / N, n = e % N, t = t0 + r;
            Bt[n * LDT + r] = t < Q ? __ldg(bp + t * a.bq + n) : 0.f;
        }
#pragma unroll 4
        for (int e = tid; e < BT * P; e += SIMT_THREADS) {
            const int r = e / P, p = e % P, t = t0 + r;
            Xs[r * P + p] = t < Q ? __ldg(xp + t * a.xq + p) : 0.f;
        }
        for (int r = tid; r < BT; r += SIMT_THREADS)
            cst[r] = t0 + r < Q ? __ldg(sp + (t0 + r) * a.sq) : 0.f;
        __syncthreads();

        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
        for (int n = 0; n < N; ++n) {
            const float4 cv = *reinterpret_cast<const float4*>(
                &Ct[n * LDT + ty * 4]);
            const float4 bv = *reinterpret_cast<const float4*>(
                &Bt[n * LDT + tx * 4]);
            const float ca[4] = {cv.x, cv.y, cv.z, cv.w};
            const float ba[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    s[i][j] = fmaf(ca[i], ba[j], s[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int ql = ty * 4 + i, q = q0 + ql;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int tl = tx * 4 + j, t = t0 + tl;
                float v = 0.f;
                if (t <= q && q < Q) v = s[i][j] * expf(csq[ql] - cst[tl]);
                Pt[tl * LDT + ql] = v;
            }
        }
        __syncthreads();

#pragma unroll 4
        for (int t = 0; t < BT; ++t) {
            const float4 pv = *reinterpret_cast<const float4*>(
                &Pt[t * LDT + ty * 4]);
            const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
            for (int j = 0; j < PJ; ++j) {
                const float xv = Xs[t * P + tx + 16 * j];
#pragma unroll
                for (int i = 0; i < 4; ++i)
                    acc[i][j] = fmaf(pa[i], xv, acc[i][j]);
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int q = q0 + ty * 4 + i;
        if (q >= Q) continue;
#pragma unroll
        for (int j = 0; j < PJ; ++j) yp[q * a.yq + tx + 16 * j] = acc[i][j];
    }
}

template <int P>
__device__ void state_tile_simt(const Args& a, int bc, int h, int n0,
                                float* smem)
{
    constexpr int PJ = P / 16;
    const int N = a.N, Q = a.Q;
    float* Bd = smem;                  // Bd[t * LDT + n], B * to_end
    float* Xs = Bd + BT * LDT;         // Xs[t * P + p]
    float* te = Xs + BT * P;

    const float* xp = (const float*)a.xdt + bc * a.xb + h * a.xh;
    const float* bp = (const float*)a.b + bc * a.bb + h * a.bh;
    const float* sp = a.cs + bc * a.sb + h * a.sh;
    const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
    const float cend = __ldg(sp + (Q - 1) * a.sq);

    float acc[4][PJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < PJ; ++j) acc[i][j] = 0.f;

    const int nt = tiles(Q, BT);
    for (int jt = 0; jt < nt; ++jt) {
        const int t0 = jt * BT;
        __syncthreads();               // Bd, Xs and te free again
        for (int r = tid; r < BT; r += SIMT_THREADS)
            te[r] = t0 + r < Q ? expf(cend - __ldg(sp + (t0 + r) * a.sq))
                               : 0.f;
#pragma unroll 4
        for (int e = tid; e < BT * P; e += SIMT_THREADS) {
            const int r = e / P, p = e % P, t = t0 + r;
            Xs[r * P + p] = t < Q ? __ldg(xp + t * a.xq + p) : 0.f;
        }
        __syncthreads();
#pragma unroll 4
        for (int e = tid; e < BT * BQ; e += SIMT_THREADS) {
            const int r = e / BQ, nl = e % BQ, t = t0 + r, n = n0 + nl;
            Bd[r * LDT + nl] = t < Q && n < N
                ? __ldg(bp + t * a.bq + n) * te[r] : 0.f;
        }
        __syncthreads();

#pragma unroll 4
        for (int t = 0; t < BT; ++t) {
            const float4 bv = *reinterpret_cast<const float4*>(
                &Bd[t * LDT + ty * 4]);
            const float ba[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
            for (int j = 0; j < PJ; ++j) {
                const float xv = Xs[t * P + tx + 16 * j];
#pragma unroll
                for (int i = 0; i < 4; ++i)
                    acc[i][j] = fmaf(ba[i], xv, acc[i][j]);
            }
        }
    }

    float* stp = a.state + ((long long)bc * a.H + h) * N * P;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int n = n0 + ty * 4 + i;
        if (n >= N) continue;
#pragma unroll
        for (int j = 0; j < PJ; ++j)
            stp[(long long)n * P + tx + 16 * j] = acc[i][j];
    }
}

template <int P>
__global__ void __launch_bounds__(SIMT_THREADS)
ssd_simt_kernel(Args a)
{
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    const int nq = tiles(a.Q, BQ), x = blockIdx.x + a.x0;
    const int h = blockIdx.y, bc = blockIdx.z;
    if (x < nq)
        y_tile_simt<P>(a, bc, h, (nq - 1 - x) * BQ, smem);
    else
        state_tile_simt<P>(a, bc, h, (x - nq) * BQ, smem);
}

// ---------------------------------------------------------------- launch

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, size_t* allowed)
{
    if (bytes <= 48 * 1024 || bytes <= *allowed) return cudaSuccess;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e == cudaSuccess) *allowed = bytes;
    return e;
}

template <int P>
int launch_simt(const Args& a, dim3 grid, cudaStream_t stream)
{
    static size_t allowed = 0;
    const size_t smem = simt_smem_bytes(a.N, P);
    cudaError_t e = allow_smem(ssd_simt_kernel<P>, smem, &allowed);
    if (e != cudaSuccess) return (int)e;
    ssd_simt_kernel<P><<<grid, SIMT_THREADS, smem, stream>>>(a);
    return (int)cudaGetLastError();
}

typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up at first use (no link to libcuda)
EncodeTiledFn encode_tiled()
{
    static EncodeTiledFn fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        const cudaError_t e = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
        const cudaError_t e = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
        if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
            fn = (EncodeTiledFn)p;
    }
    return fn;
}

// A 4-D tensor map over a bf16 tensor of `dims` (innermost first, that
// one contiguous) with element strides `st` of dims 1-3, read in boxes
// of `box`; a dim of one element gets a nominal stride (never stepped)
bool make_map(CUtensorMap* map, const void* ptr, const cuuint64_t (&dims)[4],
              const long long (&st)[3], const cuuint32_t (&box)[4],
              int row_bytes)
{
    const EncodeTiledFn encode = encode_tiled();
    if (encode == nullptr) return false;
    cuuint64_t strides[3];
    for (int i = 0; i < 3; ++i)
        strides[i] = dims[i + 1] == 1 ? 16 : (cuuint64_t)st[i] * 2;
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                  const_cast<void*>(ptr), dims, strides, box, unit,
                  CU_TENSOR_MAP_INTERLEAVE_NONE,
                  row_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                   : CU_TENSOR_MAP_SWIZZLE_64B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int PT, int HB>
int launch_wgmma(const Args& a, dim3 grid, int BC, cudaStream_t stream)
{
    using X = XTile<PT>;
    static size_t allowed = 0;
    const size_t smem = wg_smem_bytes(a.N, PT, HB);
    cudaError_t e = allow_smem(ssd_wgmma_kernel<PT, HB>, smem, &allowed);
    if (e != cudaSuccess) return (int)e;
    // xdt (p, q, head, bc) in boxes of one column block x 64 rows x HB
    // heads; B and C (n, q, group, bc) in 64 x 64 boxes
    const cuuint64_t G = (cuuint64_t)(a.H / a.hpg);
    const cuuint64_t xd[4] = {(cuuint64_t)a.P, (cuuint64_t)a.Q,
                              (cuuint64_t)a.H, (cuuint64_t)BC};
    const cuuint64_t bd[4] = {(cuuint64_t)a.N, (cuuint64_t)a.Q, G,
                              (cuuint64_t)BC};
    const cuuint32_t xbox[4] = {X::RB / 2, 64, HB, 1};
    const cuuint32_t bbox[4] = {64, 64, 1, 1};
    const cuuint32_t xbox1[4] = {X::RB / 2, 64, 1, 1};
    CUtensorMap tx, tx1, tb, tc, ty;
    if (!make_map(&tx, a.xdt, xd, {a.xq, a.xh, a.xb}, xbox, X::RB) ||
        !make_map(&tx1, a.xdt, xd, {a.xq, a.xh, a.xb}, xbox1, X::RB) ||
        !make_map(&tb, a.b, bd, {a.bq, a.bh, a.bb}, bbox, 128) ||
        !make_map(&tc, a.c, bd, {a.cq, a.ch, a.cb}, bbox, 128) ||
        !make_map(&ty, a.y, xd, {a.yq, a.yh, a.yb}, xbox1, X::RB))
        return (int)cudaErrorInvalidValue;
    ssd_wgmma_kernel<PT, HB><<<grid, WG * HB, smem, stream>>>(tx, tx1, tb,
                                                              tc, ty, a);
    return (int)cudaGetLastError();
}

template <int PT>
int launch_pt(const Args& a, dim3 grid, int BC, int hb, cudaStream_t s)
{
    if (hb == 1) return launch_wgmma<PT, 1>(a, grid, BC, s);
    if (hb == 2) return launch_wgmma<PT, 2>(a, grid, BC, s);
    return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// xdt (BC, H, Q, P), b and c (BC, H, Q, N), cs (BC, H, Q) f32 and y
// (BC, H, Q, P), each with element strides (bc, h, q) and a contiguous
// last axis; state (BC, H, N, P) f32 contiguous.  dtype: 0 = f32 (the
// SIMT kernel), 1 = bf16 (the wgmma kernel: 16-byte aligned bases and
// strides a multiple of 8).  N % 16 == 0, P in {16, 32, 64, 128}.
// Heads come in groups of heads_per_group sharing B and C (1, or H with
// a stride-0 head axis); a bf16 CTA takes heads_per_cta of them (1, or
// 2 where they share B and C).  role: 0 = y and state
// (what the wrapper launches), 1 = the y tiles alone, 2 = the state
// tiles alone (a bench's split of the time).  Launches on `stream`;
// returns the cudaError_t of the launch (0 = ok).
int ssd_chunk_launch_role(
    const void* xdt, const void* b, const void* c, const void* cs,
    void* y, void* state, int BC, int H, int Q, int N, int P,
    long long xb, long long xh, long long xq,
    long long bb, long long bh, long long bq,
    long long cb, long long ch, long long cq,
    long long sb, long long sh, long long sq,
    long long yb, long long yh, long long yq,
    int dtype, int heads_per_group, int heads_per_cta, int role,
    void* stream)
{
    const int hpg = heads_per_group, hb = heads_per_cta;
    if (BC <= 0 || BC > 65535 || H <= 0 || H > 65535 || Q <= 0 ||
        N <= 0 || N % 16 != 0 || dtype < 0 || dtype > 1 || role < 0 ||
        role > 2 || (hpg != 1 && hpg != H) || hb < 1 ||
        (hb > 1 && (hpg != H || bh != 0 || ch != 0 || dtype == 0)))
        return (int)cudaErrorInvalidValue;
    // state CTAs: f32 one a 64-row n tile; bf16 HB a block of 64 HB
    // rows, one a head
    const int nq = (Q + BQ - 1) / BQ,
              nn = hb * ((N + BQ * hb - 1) / (BQ * hb));
    const Args a{xdt, b, c, (const float*)cs, y, (float*)state, H, Q, N, P,
                 role == 2 ? nq : 0, hpg,
                 xb, xh, xq, bb, bh, bq, cb, ch, cq, sb, sh, sq,
                 yb, yh, yq};
    const dim3 grid(role == 0 ? nq + nn : role == 1 ? nq : nn,
                    (H + hb - 1) / hb, BC);
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0) {
        if (hb != 1) return (int)cudaErrorInvalidValue;
        switch (P) {
        case 16: return launch_simt<16>(a, grid, s);
        case 32: return launch_simt<32>(a, grid, s);
        case 64: return launch_simt<64>(a, grid, s);
        case 128: return launch_simt<128>(a, grid, s);
        default: return (int)cudaErrorInvalidValue;
        }
    }
    switch (P) {
    case 16:                           // padded to 32 by TMA's zero fill
    case 32: return launch_pt<32>(a, grid, BC, hb, s);
    case 64: return launch_pt<64>(a, grid, BC, hb, s);
    case 128: return launch_pt<128>(a, grid, BC, hb, s);
    default: return (int)cudaErrorInvalidValue;
    }
}

// The wrapper's entry: ssd_chunk_launch_role with role 0.
int ssd_chunk_launch(
    const void* xdt, const void* b, const void* c, const void* cs,
    void* y, void* state, int BC, int H, int Q, int N, int P,
    long long xb, long long xh, long long xq,
    long long bb, long long bh, long long bq,
    long long cb, long long ch, long long cq,
    long long sb, long long sh, long long sq,
    long long yb, long long yh, long long yq,
    int dtype, int heads_per_group, int heads_per_cta, void* stream)
{
    return ssd_chunk_launch_role(xdt, b, c, cs, y, state, BC, H, Q, N, P,
                                 xb, xh, xq, bb, bh, bq, cb, ch, cq, sb, sh,
                                 sq, yb, yh, yq, dtype, heads_per_group,
                                 heads_per_cta, 0, stream);
}

// The dynamic shared memory a CTA of ssd_chunk_launch requests at
// d_state n: the bf16 kernel's (wgmma != 0) with xdt tiles of pt columns
// and hb warpgroups, or the f32 kernel's at P = pt.
size_t ssd_smem_query(int n, int pt, int hb, int wgmma)
{
    return wgmma ? wg_smem_bytes(n, pt, hb) : simt_smem_bytes(n, pt);
}

const char* ssd_chunk_error_string(int err)
{
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
