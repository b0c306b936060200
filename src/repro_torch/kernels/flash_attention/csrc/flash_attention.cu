// Flash attention forward (causal or not, GQA) — the Hopper kernel of
// the port's prefill attention (models/attention.py::apply_attn_full).
//
// Replaces the TPU kernel flash_attention of the JAX package
// (src/repro/kernels/flash_attention/kernel.py, body _flash_kernel).
//
// For every batch b, head h and query row i < Sq:
//   o[b,h,i] = softmax_j(q[b,h,i] . k[b,h/rep,j] * scale) . v[b,h/rep,j]
// over j <= i when causal (then Sk == Sq, which the wrapper checks), all
// j < Sk otherwise; rep = H / KH; q and k have DQK columns, v and o DV,
// and the wrapper passes scale = DQK^-1/2.  With softcap > 0 each scaled
// score x becomes softcap * tanh(x / softcap) before the mask (the logit
// soft-cap of the JAX model's chunked_attention); 0 leaves it as it is.
// Sk != Sq is cross-attention
// (models/attention.py::apply_cross_attn: decoder queries against the
// encoder's frames).  The scores, the running max m, the running sum l and the accumulator are
// f32; q, k, v and o are f32 or bf16.  Tensors come with strides (the
// last axis contiguous), so the model's (B, S, H, D) projections are
// read in place.
//
// Design:
//   * (DQK, DV) is (32, 32), (64, 64), (128, 128) or (192, 128), the
//     last for multi-head latent attention's prefill (128 + 64 rope
//     columns of q and k, 128 of v).  One CTA per (b, h, 64-row query
//     tile); the
//     grid runs the query tiles in reverse, so the longest causal rows
//     start first.  A loop
//     inside the CTA walks the 64-row key/value tiles (the TPU kernel's
//     sequential grid axis), staging each in shared memory, with the
//     online softmax in f32.  Tiles wholly above the diagonal are never
//     loaded; the diagonal tile and the ragged edges (any Sq, Sk >= 1;
//     the TPU kernel needs one S with S % bq == 0) mask elementwise with
//     -1e30, as the TPU kernel does.  Sq sets the query grid and the q
//     rows; Sk the key tiles, the K/V loads and the key masks.
//   * f32 (flash_simt_kernel): CUDA-core fmaf.  256 threads; thread
//     (ty, tx) owns a 4x4 block of the 64x64 score tile and the same 4
//     rows of the output accumulator (DV/16 columns), so the softmax
//     rescale is local; row maxima and sums reduce over the 16 threads
//     of a row with shuffles.  Q and K are staged transposed (d-major),
//     P transposed, V row-major, so the inner loops read float4s
//     (float2s of V at DV = 32).
//   * bf16 (flash_fwd_bf16_kernel), for Hopper: one warpgroup (128
//     threads, 16 query rows a warp) per CTA.
//     - Ring: thread 0 issues TMA copies (cp.async.bulk.tensor.4d, maps
//       over (d, s, head, b) with the tensors' own strides, built on the
//       host through cudaGetDriverEntryPoint, passed __grid_constant__)
//       of the Q tile and of the K and V tiles into a 2-stage K ring and
//       a 2-stage V ring; each tile completes on its own mbarrier, so
//       tile t + 1 is in flight while tile t is in the math and the
//       compute warps spend no instructions on copies.  The hardware
//       zero-fills rows >= Sq (Q) or >= Sk (K, V); keys >= Sk are still masked, as a zero key
//       scores 0, not -inf.  (16-byte cp.async copies into the same
//       ring took 0.0461 ms against TMA's 0.0384 at Yi-6B's prefill on
//       an H100 80GB HBM3 at 700 W.)
//     - S = Q K^T: wgmma m64n64k16 with Q and K in 128-byte-swizzled
//       shared memory (64-byte at D = 32); K's row-major (key, d) tile
//       is K-major for K^T.
//     - O += P V: wgmma m64nDVk16 with A = P from registers (the score
//       accumulator rounded to bf16 and packed, mma.sync's A layout)
//       and B = V read row-major from shared memory with the transpose
//       bit: no transposed copy of V and no fragment loads.
//     - Schedule (as FlashAttention-3 does within a warpgroup): S(t)
//       and P V(t-1) are issued back to back, and the softmax of tile t
//       runs while P V(t-1) finishes; every wgmma wait in the loop is
//       unconditional, so ptxas keeps them asynchronous.  One
//       __syncthreads per key tile tells thread 0 that the stages it
//       refills are free.
//     - Roundings: P is rounded to bf16 before P V and O is divided by
//       l (times 1/l) once at the end, as before; exp is ex2.approx.ftz
//       of a fused scale-and-subtract in log2 units.
//     - Soft-cap: the kernel branches once, on softcap > 0, into one of
//       two compiled key loops (flash_fwd_bf16_cta<.., CAP>); the capped
//       one takes tanhf of every score of every tile before the mask.
//       At Yi-6B's prefill the capped loop takes 0.064 ms against the
//       uncapped 0.038 (H100 80GB HBM3, 700 W, tools/flash_bench.py); a
//       branch a tile took 0.053 capped but cost the uncapped loop 2-4 %.
//     - Resources at D = 128: 80 KB of tiles (Q 16 KB + 2 x (K 16 KB +
//       V 16 KB)) + 1 KB of alignment slack + 40 bytes of barriers, 138
//       registers a thread (ptxas; 106 at D = 64, 90 at D = 32), so 2
//       CTAs per SM by shared memory; at Yi-6B's prefill 1024 CTAs run
//       in 3.9 waves of 264.  At (192, 128) a Q or K tile is three
//       128-byte column blocks (24 KB) and q.k^T 12 k-steps; 105 KB of
//       tiles (Q 24 KB + 2 x (K 24 KB + V 16 KB)) still let 2 CTAs share
//       an SM, and the accumulators are D = 128's.
//
// Bound: at Yi-6B's prefill (B=4, H=32, KH=4, S=512, D=128, bf16,
// causal) the least work is 4*B*H*D*S(S+1)/2 = 8.6 GFLOP (8.7 us at the
// bf16 tensor peak) and the least traffic reads q, k, v and writes o
// once: 38 MB (11.3 us at 3.35 TB/s), so bytes bound it.  Each CTA
// reads its kv head's tiles up to the diagonal, so k and v are read
// ~S/128 * H/KH times over (~147 MB from L2 at that shape).  What holds
// the kernel back is the work between the products (softmax, rescale,
// waits) in a single warpgroup with 2 of them per SM.  Tried and
// dropped: a third ring stage (slower), and two warpgroups sharing
// 128-row query tiles (half the L2 reads), which needed 186 registers
// with cp.async copies (1 CTA per SM) and spilled when capped at 128
// (2 CTAs per SM); both ran slower.
#include <cuda.h>          // CUtensorMap and its enums (no -lcuda: the
                           // encoder comes from cudaGetDriverEntryPoint)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;           // query rows per CTA
constexpr int BK = 64;           // key rows per tile

struct Strides {                 // element strides of (b, h, s); d is 1
    long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

// key tiles of the query tile at q0: all of them, or (causal, Sk == Sq)
// those up to the diagonal
__device__ __forceinline__ int key_tiles(int Sk, int q0, int causal)
{
    const int n = (Sk + BK - 1) / BK;
    if (!causal) return n;
    const int last = (q0 + BQ - 1) / BK + 1;
    return last < n ? last : n;
}

// ------------------------------------------------------------------ SIMT

constexpr int SIMT_THREADS = 256;
constexpr int LDT = BQ + 4;      // row stride of the transposed tiles

// floats of the K-or-V buffer: K transposed (DQK, LDT) or V (BK, DV)
template <int DQK, int DV>
__host__ __device__ constexpr size_t simt_kv_floats()
{
    return (size_t)DQK * LDT > (size_t)BK * DV ? (size_t)DQK * LDT
                                               : (size_t)BK * DV;
}

template <int DQK, int DV>
constexpr size_t simt_smem_bytes()
{
    // Qt (DQK, LDT), the K-or-V buffer, Pt (BK, LDT)
    return sizeof(float) * ((size_t)DQK * LDT + simt_kv_floats<DQK, DV>()
                            + (size_t)BK * LDT);
}

template <int DQK, int DV>
__global__ void __launch_bounds__(SIMT_THREADS)
flash_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, int Sq,
                  int Sk, int rep, Strides st, float scale, int causal,
                  float softcap)
{
    // thread (ty, tx) owns output columns g * 16 * VW + tx * VW + j
    constexpr int VW = DV >= 64 ? 4 : 2;
    constexpr int NG = DV / (16 * VW);
    extern __shared__ float4 smem4[];
    float* Qt = reinterpret_cast<float*>(smem4);   // Qt[d * LDT + r]
    float* KV = Qt + DQK * LDT;  // K as KV[d * LDT + r], V as KV[r * DV + d]
    float* Pt = KV + simt_kv_floats<DQK, DV>();    // Pt[c * LDT + r]

    const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
    const int h = blockIdx.y, b = blockIdx.z, kvh = h / rep;
    const float* qp = q + b * st.qb + h * st.qh;
    const float* kp = k + b * st.kb + kvh * st.kh;
    const float* vp = v + b * st.vb + kvh * st.vh;
    float* op = o + b * st.ob + h * st.oh;
    const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

    for (int e = tid; e < BQ * DQK; e += SIMT_THREADS) {
        const int r = e / DQK, d = e % DQK, i = q0 + r;
        Qt[d * LDT + r] = i < Sq ? qp[i * st.qs + d] : 0.f;
    }

    float m[4], l[4], acc[4][DV / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = NEG_INF;
        l[i] = 0.f;
#pragma unroll
        for (int c = 0; c < DV / 16; ++c) acc[i][c] = 0.f;
    }

    const int nt = key_tiles(Sk, q0, causal);
    for (int t = 0; t < nt; ++t) {
        const int k0 = t * BK;
        __syncthreads();                     // KV and Pt free again
        for (int e = tid; e < BK * DQK; e += SIMT_THREADS) {
            const int r = e / DQK, d = e % DQK, j = k0 + r;
            KV[d * LDT + r] = j < Sk ? kp[j * st.ks + d] : 0.f;
        }
        __syncthreads();

        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
        for (int d = 0; d < DQK; ++d) {
            const float4 a = *reinterpret_cast<const float4*>(
                &Qt[d * LDT + ty * 4]);
            const float4 c = *reinterpret_cast<const float4*>(
                &KV[d * LDT + tx * 4]);
            const float av[4] = {a.x, a.y, a.z, a.w};
            const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    s[i][j] = fmaf(av[i], cv[j], s[i][j]);
        }

#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int qi = q0 + ty * 4 + i;
            float mx = NEG_INF;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int kj = k0 + tx * 4 + j;
                float x = s[i][j] * scale;
                if (softcap > 0.f) x = softcap * tanhf(x / softcap);
                if (kj >= Sk || (causal && kj > qi)) x = NEG_INF;
                s[i][j] = x;
                mx = fmaxf(mx, x);
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float m_new = fmaxf(m[i], mx);
            const float alpha = expf(m[i] - m_new);
            float rs = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float p = expf(s[i][j] - m_new);
                s[i][j] = p;
                rs += p;
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                rs += __shfl_xor_sync(0xffffffffu, rs, off);
            l[i] = l[i] * alpha + rs;
            m[i] = m_new;
#pragma unroll
            for (int c = 0; c < DV / 16; ++c) acc[i][c] *= alpha;
        }

        __syncthreads();                     // every thread is done with K
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
                Pt[(tx * 4 + j) * LDT + ty * 4 + i] = s[i][j];
        for (int e = tid; e < BK * DV; e += SIMT_THREADS) {
            const int r = e / DV, d = e % DV, j = k0 + r;
            KV[r * DV + d] = j < Sk ? vp[j * st.vs + d] : 0.f;
        }
        __syncthreads();

#pragma unroll 4
        for (int c = 0; c < BK; ++c) {
            const float4 p4 = *reinterpret_cast<const float4*>(
                &Pt[c * LDT + ty * 4]);
            const float pr[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
            for (int g = 0; g < NG; ++g) {
                const float* vrow = &KV[c * DV + g * 16 * VW + tx * VW];
                float vv[VW];
                if constexpr (VW == 4) {
                    const float4 v4 = *reinterpret_cast<const float4*>(vrow);
                    vv[0] = v4.x; vv[1] = v4.y; vv[2] = v4.z; vv[3] = v4.w;
                } else {
                    const float2 v2 = *reinterpret_cast<const float2*>(vrow);
                    vv[0] = v2.x; vv[1] = v2.y;
                }
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < VW; ++j)
                        acc[i][g * VW + j] =
                            fmaf(pr[i], vv[j], acc[i][g * VW + j]);
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int qi = q0 + ty * 4 + i;
        if (qi >= Sq) continue;
        const float lv = fmaxf(l[i], 1e-30f);
#pragma unroll
        for (int g = 0; g < NG; ++g)
#pragma unroll
            for (int j = 0; j < VW; ++j)
                op[qi * st.os + g * 16 * VW + tx * VW + j] =
                    acc[i][g * VW + j] / lv;
    }
}

// ------------------------------------------------------------ bf16 tiles

constexpr int FA_THREADS = 128;   // one warpgroup: 4 warps x 16 query rows
constexpr int STAGES = 2;   // K/V ring depth (key tile t in stage t & 1)

// A 64-row bf16 tile of D columns is stored as D*2/RB column blocks of
// 64 rows x RB bytes (RB = 128, or 64 at D = 32), one TMA box each,
// swizzled as TMA's SWIZZLE_128B / SWIZZLE_64B write them and wgmma's
// B128 / B64 layouts read them: the 16-byte chunk index within a row
// is XORed with bits 7.. of the byte offset.  Tiles start on 1024-byte
// boundaries.
template <int D>
struct TileShape {
    static constexpr int RB = 2 * D < 128 ? 2 * D : 128;  // row bytes
    static constexpr int BLOCK = 64 * RB;   // bytes of one column block
    static constexpr int BYTES = 64 * D * 2;
    static constexpr uint64_t LAYOUT = RB == 128 ? 1 : 2;  // B128 / B64
};

template <int DQK, int DV>
constexpr size_t fa_smem_bytes()
{
    // 1024 bytes of alignment slack, Q, STAGES x (K, V)
    return 1024 + (size_t)(1 + STAGES) * TileShape<DQK>::BYTES
           + (size_t)STAGES * TileShape<DV>::BYTES;
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

// rows r0 .. r0+63 of head h, batch b of a (B, heads, rows, D) tensor
// into the swizzled tile at dst, one TMA box (RB bytes x 64 rows) per
// column block; the hardware zero-fills rows past the map's and signals
// `bar`
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap& map,
                                         uint32_t bar, int r0, int h, int b)
{
    using T = TileShape<D>;
    mbar_expect(bar, T::BYTES);
#pragma unroll
    for (int cb = 0; cb < 2 * D / T::RB; ++cb)
        asm volatile(
            "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier"
            "::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
            :: "r"(dst + cb * T::BLOCK), "l"((uint64_t)&map),
               "r"(cb * T::RB / 2), "r"(r0), "r"(h), "r"(b), "r"(bar)
            : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi)
{
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// ------------------------------------------------------- wgmma helpers

// shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle layout (1 = B128, 2 = B64)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout)
{
    return (uint64_t)((addr & 0x3FFFF) >> 4) |
           ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
           ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// K-major operand (d contiguous): k-step ks (16 columns) of a 64-row
// tile; 8-row groups lie 8 * RB bytes apart
template <int D>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int ks)
{
    using T = TileShape<D>;
    const uint32_t col = ks * 32;
    return smem_desc(tile + (col / T::RB) * T::BLOCK + col % T::RB, 16,
                     8 * T::RB, T::LAYOUT);
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

// d (64 x 64, f32) (+)= a (64 x 16) * b (16 x 64), both K-major in
// shared memory; d += only when accumulate != 0
__device__ __forceinline__ void wgmma_64x64_ss(float (&d)[32], uint64_t da,
                                               uint64_t db, int accumulate)
{
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31 "
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(accumulate));
}


// MN-major operand (read with the transpose bit): k-step kk (16 rows)
// of a 64-row tile whose rows are the reduction axis; its column blocks
// lie BLOCK bytes apart (LBO) and its 8-row groups 8 * RB bytes (SBO)
template <int D>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int kk)
{
    using T = TileShape<D>;
    return smem_desc(tile + kk * 16 * T::RB, T::BLOCK, 8 * T::RB,
                     T::LAYOUT);
}

// d (64 x N, f32) += a (64 x 16, bf16 fragments in registers, laid out
// as mma.sync's A) * b (16 x N, MN-major in shared memory)
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
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15 "
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db)
{
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31 "
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db)
{
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63 "
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

constexpr float LOG2E = 1.4426950408889634f;

// S = Q K^T for one key tile: 64 x 64 f32 in wgmma's accumulator layout
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[BK / 2], uint32_t Qs,
                                         uint32_t Ks)
{
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
        wgmma_64x64_ss(s, kmajor_desc<D>(Qs, ks), kmajor_desc<D>(Ks, ks),
                       ks);
    wgmma_commit();
}

// O += P V for one key tile: P from registers, V row-major in shared
// memory, read with the transpose bit
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         const uint32_t (&pf)[BK / 16][4],
                                         uint32_t Vs)
{
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<D>(acc, pf[kk], mnmajor_desc<D>(Vs, kk));
    wgmma_commit();
}

// 2^x, flushing results below 2^-126 to 0 (one MUFU operation)
__device__ __forceinline__ float ex2(float x)
{
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// The online softmax of one score tile in wgmma's accumulator layout:
// s[4 * n8 + e] is row r0 (e = 0, 1) or r0 + 8 (e = 2, 3) of the
// thread's warp, key k0 + n8 * 8 + 2 * t4 + (e & 1).  With a soft-cap
// (CAP) every score of every tile first becomes cap tanh(s sc), sc =
// scale / cap, before any mask: a masked key must stay at -1e30, not
// come back as -cap.  Masks the keys >= Sk and, when causal, above the
// diagonal; leaves P in s, updates m and l (m in log2 units: scores
// times sl2, which is scale log2 e, or log2 e once capped), and gives
// alpha, the factor for O.
template <bool CAP>
__device__ __forceinline__ void softmax_tile(
    float (&s)[BK / 2], float (&m)[2], float (&l)[2], float (&alpha)[2],
    int k0, int q0, int Sk, int causal, const int (&qrow)[2], int t4,
    float sl2, float cap, float sc)
{
    const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > q0);
    if (CAP) {
        // tanhf, not tanh.approx.f32: the approximation's 2^-11
        // relative error is ~0.025 of a score at cap 50
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) s[i] = cap * tanhf(s[i] * sc);
    }
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
        const int row = (i >> 1) & 1;
        if (edge) {
            const int kj = k0 + (i >> 2) * 8 + 2 * t4 + (i & 1);
            if (kj >= Sk || (causal && kj > qrow[row])) s[i] = NEG_INF;
        }
        mx[row] = fmaxf(mx[row], s[i]);
    }
    float m_new[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int row = 0; row < 2; ++row) {
        mx[row] = fmaxf(mx[row], __shfl_xor_sync(0xffffffffu, mx[row], 1));
        mx[row] = fmaxf(mx[row], __shfl_xor_sync(0xffffffffu, mx[row], 2));
        m_new[row] = fmaxf(m[row], mx[row] * sl2);
        alpha[row] = ex2(m[row] - m_new[row]);
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
        const float p = ex2(fmaf(s[i], sl2, -m_new[(i >> 1) & 1]));
        s[i] = p;
        rs[(i >> 1) & 1] += p;
    }
#pragma unroll
    for (int row = 0; row < 2; ++row) {
        rs[row] += __shfl_xor_sync(0xffffffffu, rs[row], 1);
        rs[row] += __shfl_xor_sync(0xffffffffu, rs[row], 2);
        l[row] = l[row] * alpha[row] + rs[row];
        m[row] = m_new[row];
    }
}

// P rounded to bf16, as mma.sync's A fragments of 16 keys each
__device__ __forceinline__ void pack_p(const float (&s)[BK / 2],
                                       uint32_t (&pf)[BK / 16][4])
{
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j)
            pf[kk][j] = pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
}

// One CTA of flash_fwd_bf16_kernel, with the soft-cap (CAP) or without:
// the kernel picks one of the two for the whole CTA, so the key loop
// without a cap holds none of the cap's instructions.  smem_raw is the
// dynamic shared memory, bars the kernel's 5 barriers.
template <int DQK, int DV, bool CAP>
__device__ __forceinline__ void flash_fwd_bf16_cta(
    const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
    __nv_bfloat16* __restrict__ o, int Sq, int Sk, int rep,
    const Strides& st, float scale, int causal, float softcap,
    unsigned char* smem_raw, uint64_t* bars)
{
    constexpr uint32_t QK_BYTES = TileShape<DQK>::BYTES;
    constexpr uint32_t V_BYTES = TileShape<DV>::BYTES;
    const uint32_t base =
        ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;
    // Q, then the K ring, then the V ring; tile t sits in stage t & 1
    // (every tile is a multiple of 1024 bytes, so each stays aligned)
    const uint32_t Qs = base;
    auto kst = [&](int t) { return base + (1 + (t & 1)) * QK_BYTES; };
    auto vst = [&](int t) {
        return base + 3 * QK_BYTES + (t & 1) * V_BYTES;
    };

    // full barriers: Q, K stages 0-1, V stages 0-1; the n-th use of a
    // stage completes phase n, so key tile t waits on parity (t >> 1) & 1
    const uint32_t bq = (uint32_t)__cvta_generic_to_shared(bars);
    auto kbar = [&](int t) { return bq + 8 * (1 + (t & 1)); };
    auto vbar = [&](int t) { return bq + 8 * (3 + (t & 1)); };
    auto par = [](int t) { return (uint32_t)(t >> 1) & 1u; };

    const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
    const int h = blockIdx.y, b = blockIdx.z, kvh = h / rep;
    __nv_bfloat16* op = o + b * st.ob + h * st.oh;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int t4 = lane & 3;
    // this thread's rows of the warp's 16: r0 and r0 + 8
    const int r0 = warp * 16 + (lane >> 2);
    const int qrow[2] = {q0 + r0, q0 + r0 + 8};
    // scores in log2 units: capped scores are already scaled
    const float sl2 = CAP ? LOG2E : scale * LOG2E;
    const float sc = CAP ? scale / softcap : 0.f;
    const int nt = key_tiles(Sk, q0, causal);

    // thread 0 issues every copy: Q, K0, K1 and V0 now, then K(t+1) and
    // V(t) at the top of iteration t, once the barrier there has shown
    // that every warp is done with the stages they overwrite
    if (tid == 0) {
#pragma unroll
        for (int i = 0; i < 5; ++i) mbar_init(bq + 8 * i);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        tma_tile<DQK>(Qs, tq, bq, q0, h, b);
        tma_tile<DQK>(kst(0), tk, kbar(0), 0, kvh, b);
        if (nt > 1) tma_tile<DQK>(kst(1), tk, kbar(1), BK, kvh, b);
        tma_tile<DV>(vst(0), tv, vbar(0), 0, kvh, b);
    }
    __syncthreads();                 // the barriers are initialised

    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, alpha[2];
    float acc[DV / 2];              // O in wgmma's accumulator layout
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
    float s[BK / 2];
    uint32_t pf[BK / 16][4];

    mbar_wait(bq, 0);
    mbar_wait(kbar(0), 0);
    issue_qk<DQK>(s, Qs, kst(0));
    wgmma_wait<0>();
    fence_regs(s);
    softmax_tile<CAP>(s, m, l, alpha, 0, q0, Sk, causal, qrow, t4, sl2,
                      softcap, sc);
    pack_p(s, pf);

    // iteration t: S(t) and P V(t-1) are in flight together, and the
    // softmax of tile t runs while P V(t-1) finishes
    for (int t = 1; t < nt; ++t) {
        __syncthreads();             // S(t-1) and P V(t-2) are done
        if (tid == 0) {
            if (t + 1 < nt)
                tma_tile<DQK>(kst(t + 1), tk, kbar(t + 1), (t + 1) * BK,
                              kvh, b);
            tma_tile<DV>(vst(t), tv, vbar(t), t * BK, kvh, b);
        }
        mbar_wait(kbar(t), par(t));
        issue_qk<DQK>(s, Qs, kst(t));
#pragma unroll
        for (int i = 0; i < DV / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
        mbar_wait(vbar(t - 1), par(t - 1));
        issue_pv<DV>(acc, pf, vst(t - 1));
        wgmma_wait<1>();             // S(t)
        fence_regs(s);
        softmax_tile<CAP>(s, m, l, alpha, t * BK, q0, Sk, causal, qrow,
                          t4, sl2, softcap, sc);
        wgmma_wait<0>();             // P V(t-1)
        fence_regs(acc);
        pack_p(s, pf);
    }

    mbar_wait(vbar(nt - 1), par(nt - 1));
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
    issue_pv<DV>(acc, pf, vst(nt - 1));
    wgmma_wait<0>();
    fence_regs(acc);

#pragma unroll
    for (int row = 0; row < 2; ++row) {
        const int qi = qrow[row];
        if (qi >= Sq) continue;
        const float inv = 1.f / fmaxf(l[row], 1e-30f);
#pragma unroll
        for (int dn = 0; dn < DV / 8; ++dn) {
            const int c = dn * 8 + 2 * t4;
            *reinterpret_cast<uint32_t*>(&op[qi * st.os + c]) =
                pack_bf16(acc[4 * dn + 2 * row] * inv,
                          acc[4 * dn + 2 * row + 1] * inv);
        }
    }
}

template <int DQK, int DV>
__global__ void __launch_bounds__(FA_THREADS)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      __nv_bfloat16* __restrict__ o, int Sq, int Sk,
                      int rep, Strides st, float scale, int causal,
                      float softcap)
{
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __shared__ __align__(8) uint64_t bars[5];
    // one uniform branch for the CTA, not one a tile (the header's
    // Soft-cap note)
    if (softcap > 0.f)
        flash_fwd_bf16_cta<DQK, DV, true>(tq, tk, tv, o, Sq, Sk, rep, st,
                                          scale, causal, softcap, smem_raw,
                                          bars);
    else
        flash_fwd_bf16_cta<DQK, DV, false>(tq, tk, tv, o, Sq, Sk, rep, st,
                                           scale, causal, softcap,
                                           smem_raw, bars);
}

// ---------------------------------------------------------------- launch

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes)
{
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int DQK, int DV>
int launch_simt(const void* q, const void* k, const void* v, void* o,
                dim3 grid, int Sq, int Sk, int rep, const Strides& st,
                float scale, int causal, float softcap, cudaStream_t stream)
{
    constexpr size_t smem = simt_smem_bytes<DQK, DV>();
    static bool ready = false;
    if (!ready) {
        cudaError_t e = allow_smem(flash_simt_kernel<DQK, DV>, smem);
        if (e != cudaSuccess) return (int)e;
        ready = true;
    }
    flash_simt_kernel<DQK, DV><<<grid, SIMT_THREADS, smem, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)o, Sq,
        Sk, rep, st, scale, causal, softcap);
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

// A 4-D tensor map over (d, s, head, b) of a bf16 (B, heads, S, D)
// tensor with element strides (sb, sh, ss), in boxes of RB bytes x 64
// rows swizzled as the tiles are; rows past S read as zeros.  Q's map
// has Sq rows, K's and V's Sk.
template <int D>
bool make_map(CUtensorMap* map, const void* ptr, int B, int heads, int S,
              long long sb, long long sh, long long ss)
{
    using T = TileShape<D>;
    const EncodeTiledFn encode = encode_tiled();
    if (encode == nullptr) return false;
    const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S,
                                (cuuint64_t)heads, (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                                   (cuuint64_t)sb * 2};
    const cuuint32_t box[4] = {T::RB / 2, 64, 1, 1};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                  const_cast<void*>(ptr), dims, strides, box, unit,
                  CU_TENSOR_MAP_INTERLEAVE_NONE,
                  T::RB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                               : CU_TENSOR_MAP_SWIZZLE_64B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DQK, int DV>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                dim3 grid, int Sq, int Sk, int rep, const Strides& st,
                float scale, int causal, float softcap, cudaStream_t stream)
{
    constexpr size_t smem = fa_smem_bytes<DQK, DV>();
    static bool ready = false;
    if (!ready) {
        cudaError_t e = allow_smem(flash_fwd_bf16_kernel<DQK, DV>, smem);
        if (e != cudaSuccess) return (int)e;
        ready = true;
    }
    const int B = grid.z, H = grid.y, KH = H / rep;
    CUtensorMap tq, tk, tv;
    if (!make_map<DQK>(&tq, q, B, H, Sq, st.qb, st.qh, st.qs) ||
        !make_map<DQK>(&tk, k, B, KH, Sk, st.kb, st.kh, st.ks) ||
        !make_map<DV>(&tv, v, B, KH, Sk, st.vb, st.vh, st.vs))
        return (int)cudaErrorInvalidValue;
    flash_fwd_bf16_kernel<DQK, DV><<<grid, FA_THREADS, smem, stream>>>(
        tq, tk, tv, (__nv_bfloat16*)o, Sq, Sk, rep, st, scale, causal,
        softcap);
    return (int)cudaGetLastError();
}

template <int DQK, int DV>
int launch_d(const void* q, const void* k, const void* v, void* o,
             dim3 grid, int Sq, int Sk, int rep, const Strides& st,
             float scale, int causal, float softcap, int dtype,
             cudaStream_t stream)
{
    if (dtype == 0)
        return launch_simt<DQK, DV>(q, k, v, o, grid, Sq, Sk, rep, st, scale,
                                    causal, softcap, stream);
    return launch_bf16<DQK, DV>(q, k, v, o, grid, Sq, Sk, rep, st, scale,
                                causal, softcap, stream);
}

}  // namespace

extern "C" {

// q (B, H, Sq, D), k (B, KH, Sk, D), v (B, KH, Sk, Dv), o (B, H, Sq,
// Dv), each with element strides (b, h, s) and a contiguous last axis;
// (D, Dv) is one of the pairs the switch below takes; causal needs
// Sq == Sk; softcap > 0 caps the scaled scores at softcap tanh(. /
// softcap), 0 leaves them (a negative or non-finite cap is refused).
// dtype: 0 = f32
// (the SIMT kernel), 1 = bf16 (the wgmma kernel).  Launches on `stream`;
// returns the cudaError_t of the launch (0 = ok).
int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o,
    int B, int H, int KH, int Sq, int Sk, int D, int Dv,
    long long qb, long long qh, long long qs,
    long long kb, long long kh, long long ks,
    long long vb, long long vh, long long vs,
    long long ob, long long oh, long long os,
    float scale, int causal, float softcap, int dtype, void* stream)
{
    if (B <= 0 || H <= 0 || KH <= 0 || Sq <= 0 || Sk <= 0 || H % KH != 0 ||
        (causal && Sq != Sk) || dtype < 0 || dtype > 1 ||
        !(softcap >= 0.f && softcap <= FLT_MAX))
        return (int)cudaErrorInvalidValue;
    const Strides st{qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os};
    const dim3 grid((Sq + BQ - 1) / BQ, H, B);
    const int rep = H / KH;
    cudaStream_t s = (cudaStream_t)stream;
    switch (D * 1000 + Dv) {
    case 32032:
        return launch_d<32, 32>(q, k, v, o, grid, Sq, Sk, rep, st,
                                scale, causal, softcap, dtype, s);
    case 64064:
        return launch_d<64, 64>(q, k, v, o, grid, Sq, Sk, rep, st,
                                scale, causal, softcap, dtype, s);
    case 128128:
        return launch_d<128, 128>(q, k, v, o, grid, Sq, Sk, rep, st,
                                  scale, causal, softcap, dtype, s);
    case 192128:
        return launch_d<192, 128>(q, k, v, o, grid, Sq, Sk, rep, st,
                                  scale, causal, softcap, dtype, s);
    default:
        return (int)cudaErrorInvalidValue;
    }
}

// The dynamic shared memory flash_attention_launch requests at head dims
// (dqk, dv): the bf16 kernel's (bf16 != 0) or the f32 kernel's; 0 for a
// pair it does not take.
size_t flash_smem_query(int dqk, int dv, int bf16)
{
    switch (dqk * 1000 + dv) {
    case 32032:
        return bf16 ? fa_smem_bytes<32, 32>() : simt_smem_bytes<32, 32>();
    case 64064:
        return bf16 ? fa_smem_bytes<64, 64>() : simt_smem_bytes<64, 64>();
    case 128128:
        return bf16 ? fa_smem_bytes<128, 128>()
                    : simt_smem_bytes<128, 128>();
    case 192128:
        return bf16 ? fa_smem_bytes<192, 128>()
                    : simt_smem_bytes<192, 128>();
    default:
        return 0;
    }
}

const char* flash_attention_error_string(int err)
{
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
