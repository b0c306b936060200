// Mamba-2 SSD intra-chunk block — the Hopper kernel of the port's chunked
// SSD (models/mamba2.py::ssd_chunked).
//
// Replaces the TPU kernel ssd_chunk_pallas of the JAX package
// (src/repro/kernels/ssd/kernel.py, body _ssd_kernel).
//
// For every chunk bc and head h, over the chunk's rows q, t < Q:
//   y[q]  = sum_{t <= q} rnd(exp(cs[q] - cs[t]) * (C[q] . B[t])) * xdt[t]
//   state = sum_t (B[t] * exp(cs[Q-1] - cs[t]))^T xdt[t]          (N, P)
// where cs is the inclusive cumulative decay (f32), rnd rounds to xdt's
// dtype (as the plain version rounds (C.B^T)oL before its product with
// xdt), y is written in xdt's dtype and the state in f32.  Tensors come
// with strides (the last axis contiguous), so the model's
// (B, nc, Q, H, P) activations are read as (B*nc, H, Q, P) views, and a
// group of B and C shared by all heads is a stride-0 head axis: nothing
// is repeated in memory.
//
// Design (a simple kernel that is right; speed comes later):
//   * One launch, two roles.  grid.x = ceil(Q/64) y tiles + ceil(N/64)
//     state tiles, grid.y = H, grid.z = BC.  A y CTA takes 64 rows of q
//     and walks the 64-row t tiles up to its diagonal (the TPU kernel's
//     whole (Q, Q) block, cut into the causal tiles); a state CTA takes
//     64 rows of n and walks every t tile.  The decay exp(cs[q]-cs[t]) is
//     built from the (Q,) cs in shared memory, never from device memory;
//     masked entries (t > q, and the ragged rows past Q, which load as
//     zeros) are set to 0 without evaluating exp, so exp(+large) never
//     meets a 0.
//   * bf16 (ssd_mma_kernel): tensor cores via mma.sync m16n8k16 (bf16 in,
//     f32 accumulate), 4 warps of 16 rows.  y: S = C_q B_t^T lands in the
//     accumulator layout, is scaled by the decay, rounded to bf16 and
//     reused as the A operand of S xdt_t (as flash_attention.cu reuses its
//     probabilities).  state: B_t * to_end is formed in f32 and split into
//     three bf16 parts (high, remainder, remainder of the remainder), each
//     multiplied by xdt_t on the tensor cores, so the state carries the
//     f32 product to ~2^-24 as the plain version does (xdt is bf16, exact
//     in either).  C, B are staged row-major, xdt and B*to_end
//     transposed, rows padded by 8 elements so fragment loads are free of
//     bank conflicts.
//   * f32 (ssd_simt_kernel): CUDA-core fmaf, no TF32.  256 threads; in a
//     y CTA thread (ty, tx) owns a 4x4 block of the 64x64 S tile and rows
//     4ty..4ty+3 of y at columns tx + 16j; in a state CTA it owns rows
//     4ty..4ty+3 of the state at the same columns.
//   * Tiles are staged with 16-byte loads through the read-only path
//     (__ldg, which cannot alias the shared-memory stores), a batch of
//     four in flight per thread before any store.  The bf16 inputs
//     therefore need 16-byte aligned rows (strides a multiple of 8).
//     wgmma, TMA, cp.async and warp specialisation come later.
//
// Bound: at mamba2-370m's served prefill (4 x 2048 tokens: BC = 32,
// H = 32, Q = 256, N = 128, P = 64, bf16, B and C one group) the least
// traffic reads xdt (33.6 MB), B and C once per group (4.2 MB) and cs
// (1 MB), and writes y (33.6 MB) and the f32 state (33.6 MB): ~106 MB,
// 31.6 us at 3.35 TB/s.  The least work, 2*Q*N*P for the state and
// Q(Q+1)/2*(2N + 2P) for the causal half of C B^T and S xdt, is 17 GFLOP,
// 17 us at the bf16 tensor peak: bytes bound it.
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
    // element strides of (bc, h, q); the last axis is contiguous
    long long xb, xh, xq, bb, bh, bq, cb, ch, cq, sb, sh, sq, yb, yh, yq;
};

__device__ __forceinline__ int tiles(int n, int t) { return (n + t - 1) / t; }

// ------------------------------------------------------- bf16, mma.sync

constexpr int MMA_THREADS = 128;  // 4 warps x 16 rows
constexpr int LDX = BT + 8;       // row stride of the transposed tiles
constexpr int SPLIT = 3;          // bf16 parts of B*to_end in the state

__device__ __forceinline__ uint32_t ld_u32(const bf16* p)
{
    return *reinterpret_cast<const uint32_t*>(p);
}

constexpr int VEC = 8;            // bf16 per 16-byte load
constexpr int BATCH = 4;          // 16-byte loads in flight per thread

// 8 bf16 of device memory through the read-only path, which cannot alias
// the shared-memory stores of the staging loops
__device__ __forceinline__ uint4 ldg_vec(const bf16* p)
{
    return __ldg(reinterpret_cast<const uint4*>(p));
}

// BT rows g0.. of a bf16 tile, `cols` wide, into S[r * lds + c]
// (row-major), zeros past row `valid`: 16-byte loads, a batch of them in
// flight before the shared-memory stores
__device__ __forceinline__ void stage_rows(const bf16* src, long long stride,
                                           int g0, int valid, int cols,
                                           bf16* S, int lds, int tid)
{
    const int per_row = cols / VEC, total = BT * per_row;
    for (int base = tid; base < total; base += BATCH * MMA_THREADS) {
        uint4 v[BATCH];
#pragma unroll
        for (int i = 0; i < BATCH; ++i) {
            const int e = base + i * MMA_THREADS;
            const int r = e / per_row, c = (e % per_row) * VEC;
            v[i] = e < total && g0 + r < valid
                ? ldg_vec(src + (g0 + r) * stride + c)
                : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int i = 0; i < BATCH; ++i) {
            const int e = base + i * MMA_THREADS;
            if (e < total) {
                const int r = e / per_row, c = (e % per_row) * VEC;
                *reinterpret_cast<uint4*>(&S[r * lds + c]) = v[i];
            }
        }
    }
}

// the 16-byte loads of a (BT, CB) block to be stored transposed: rows
// g0.., zeros past row `valid` or column `cvalid`.  Load i of this
// thread is row e % BT, columns (e / BT) * VEC.., e = tid + i *
// MMA_THREADS: neighbouring threads take neighbouring rows, so the
// transposed 16-bit stores fall in distinct banks.
constexpr int CB = BATCH * MMA_THREADS * VEC / BT;    // 64 columns
__device__ __forceinline__ void load_cols(const bf16* src, long long stride,
                                          int g0, int valid, int cvalid,
                                          int tid, uint4 v[BATCH])
{
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
        const int e = tid + i * MMA_THREADS;
        const int r = e % BT, c = (e / BT) * VEC;
        v[i] = c < cvalid && g0 + r < valid
            ? ldg_vec(src + (g0 + r) * stride + c)
            : make_uint4(0u, 0u, 0u, 0u);
    }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi)
{
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// c += a (16x16, row) * b (16x8, col); bf16 in, f32 accumulate
__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1)
{
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// xdt rows t0 .. t0+BT-1 transposed into Xt[p * LDX + r], zeros past Q
template <int P>
__device__ __forceinline__ void stage_xt(const bf16* xp, long long xq,
                                         int t0, int Q, bf16* Xt, int tid)
{
#pragma unroll
    for (int c0 = 0; c0 < P; c0 += CB) {
        uint4 v[BATCH];
        load_cols(xp + c0, xq, t0, Q, P - c0, tid, v);
#pragma unroll
        for (int i = 0; i < BATCH; ++i) {
            const int e = tid + i * MMA_THREADS;
            const int r = e % BT, c = c0 + (e / BT) * VEC;
            if (c >= P) continue;
            const bf16* h = reinterpret_cast<const bf16*>(&v[i]);
#pragma unroll
            for (int j = 0; j < VEC; ++j) Xt[(c + j) * LDX + r] = h[j];
        }
    }
}

size_t mma_smem_bytes(int N, int P)
{
    // y: Cs (BQ, N+8), Bs (BT, N+8), Xt (P, LDX) bf16, cs of q and t f32;
    // state: the three parts of B*to_end (3, BQ, LDX), Xt (P, LDX) bf16,
    // to_end (BT) f32
    const size_t xt = 2 * (size_t)P * LDX;
    const size_t y = 2 * (size_t)(BQ + BT) * (N + 8) + xt + 4 * (BQ + BT);
    const size_t st = 2 * SPLIT * (size_t)BQ * LDX + xt + 4 * BT;
    return y > st ? y : st;
}

template <int P>
__device__ void y_tile_mma(const Args& a, int bc, int h, int q0,
                           unsigned char* smem)
{
    const int N = a.N, Q = a.Q, LDN = N + 8;
    bf16* Cs = reinterpret_cast<bf16*>(smem);   // Cs[r * LDN + n]
    bf16* Bs = Cs + BQ * LDN;                   // Bs[r * LDN + n]
    bf16* Xt = Bs + BT * LDN;                   // Xt[p * LDX + r]
    float* csq = reinterpret_cast<float*>(Xt + P * LDX);
    float* cst = csq + BQ;

    const bf16* xp = (const bf16*)a.xdt + bc * a.xb + h * a.xh;
    const bf16* bp = (const bf16*)a.b + bc * a.bb + h * a.bh;
    const bf16* cp = (const bf16*)a.c + bc * a.cb + h * a.ch;
    const float* sp = a.cs + bc * a.sb + h * a.sh;
    bf16* yp = (bf16*)a.y + bc * a.yb + h * a.yh;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;

    stage_rows(cp, a.cq, q0, Q, N, Cs, LDN, tid);
    for (int r = tid; r < BQ; r += MMA_THREADS)
        csq[r] = q0 + r < Q ? __ldg(sp + (q0 + r) * a.sq) : 0.f;

    // this thread's rows of the warp's 16: r0 and r0 + 8
    const int r0 = warp * 16 + g;
    const int qrow[2] = {q0 + r0, q0 + r0 + 8};

    float acc[P / 8][4];
#pragma unroll
    for (int dn = 0; dn < P / 8; ++dn)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;

    const int nt = q0 / BT + 1;        // t tiles up to the diagonal
    for (int j = 0; j < nt; ++j) {
        const int t0 = j * BT;
        __syncthreads();               // Bs, Xt and cst free again
        stage_rows(bp, a.bq, t0, Q, N, Bs, LDN, tid);
        stage_xt<P>(xp, a.xq, t0, Q, Xt, tid);
        for (int r = tid; r < BT; r += MMA_THREADS)
            cst[r] = t0 + r < Q ? __ldg(sp + (t0 + r) * a.sq) : 0.f;
        __syncthreads();

        // S = C_q B_t^T (16 x 64 per warp)
        float s[BT / 8][4];
#pragma unroll
        for (int n8 = 0; n8 < BT / 8; ++n8)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[n8][e] = 0.f;
        for (int ks = 0; ks < N / 16; ++ks) {
            const int c = ks * 16 + 2 * t4;
            const uint32_t af[4] = {
                ld_u32(&Cs[r0 * LDN + c]), ld_u32(&Cs[(r0 + 8) * LDN + c]),
                ld_u32(&Cs[r0 * LDN + c + 8]),
                ld_u32(&Cs[(r0 + 8) * LDN + c + 8]),
            };
#pragma unroll
            for (int n8 = 0; n8 < BT / 8; ++n8) {
                const bf16* br = &Bs[(n8 * 8 + g) * LDN + c];
                mma_16816(s[n8], af, ld_u32(br), ld_u32(br + 8));
            }
        }

        // accumulator layout: e = 0, 1 -> row r0, e = 2, 3 -> row r0 + 8;
        // t column n8 * 8 + 2 * t4 + (e & 1).  t <= q < Q keeps an entry.
#pragma unroll
        for (int n8 = 0; n8 < BT / 8; ++n8)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int row = e >> 1, q = qrow[row];
                const int tl = n8 * 8 + 2 * t4 + (e & 1), t = t0 + tl;
                float v = 0.f;
                if (t <= q && q < Q)
                    v = s[n8][e] * expf(csq[r0 + 8 * row] - cst[tl]);
                s[n8][e] = v;
            }

        // y += rnd(S) xdt_t
#pragma unroll
        for (int kk = 0; kk < BT / 16; ++kk) {
            const uint32_t af[4] = {
                pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]),
            };
#pragma unroll
            for (int dn = 0; dn < P / 8; ++dn) {
                const bf16* xr = &Xt[(dn * 8 + g) * LDX + kk * 16 + 2 * t4];
                mma_16816(acc[dn], af, ld_u32(xr), ld_u32(xr + 8));
            }
        }
    }

#pragma unroll
    for (int row = 0; row < 2; ++row) {
        const int q = qrow[row];
        if (q >= Q) continue;
#pragma unroll
        for (int dn = 0; dn < P / 8; ++dn) {
            const int c = dn * 8 + 2 * t4;
            *reinterpret_cast<uint32_t*>(&yp[q * a.yq + c]) =
                pack_bf16(acc[dn][2 * row], acc[dn][2 * row + 1]);
        }
    }
}

template <int P>
__device__ void state_tile_mma(const Args& a, int bc, int h, int n0,
                               unsigned char* smem)
{
    const int N = a.N, Q = a.Q;
    // Bs[k * BQ * LDX + n * LDX + r]: part k of B[t][n0 + n] * to_end[t]
    bf16* Bs = reinterpret_cast<bf16*>(smem);
    bf16* Xt = Bs + SPLIT * BQ * LDX;           // Xt[p * LDX + r]
    float* te = reinterpret_cast<float*>(Xt + P * LDX);

    const bf16* xp = (const bf16*)a.xdt + bc * a.xb + h * a.xh;
    const bf16* bp = (const bf16*)a.b + bc * a.bb + h * a.bh;
    const float* sp = a.cs + bc * a.sb + h * a.sh;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const float cend = __ldg(sp + (Q - 1) * a.sq);
    const int r0 = warp * 16 + g;

    float acc[P / 8][4];
#pragma unroll
    for (int dn = 0; dn < P / 8; ++dn)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;

    const int nt = tiles(Q, BT);
    for (int j = 0; j < nt; ++j) {
        const int t0 = j * BT;
        __syncthreads();               // Bs, Xt and te free again
        for (int r = tid; r < BT; r += MMA_THREADS)
            te[r] = t0 + r < Q ? expf(cend - __ldg(sp + (t0 + r) * a.sq))
                               : 0.f;
        static_assert(CB == BQ, "one load batch covers the n tile");
        uint4 v[BATCH];                // B rows t0.., columns n0..n0+BQ
        load_cols(bp + n0, a.bq, t0, Q, N - n0, tid, v);
        stage_xt<P>(xp, a.xq, t0, Q, Xt, tid);
        __syncthreads();               // te is ready
#pragma unroll
        for (int i = 0; i < BATCH; ++i) {
            const int e = tid + i * MMA_THREADS;
            const int r = e % BT, c = (e / BT) * VEC;
            const bf16* h = reinterpret_cast<const bf16*>(&v[i]);
#pragma unroll
            for (int j = 0; j < VEC; ++j) {
                // the parts sum to B * to_end: each takes what the ones
                // before left (exact in f32), rounded to bf16
                float w = __bfloat162float(h[j]) * te[r];
#pragma unroll
                for (int k = 0; k < SPLIT; ++k) {
                    const bf16 part = __float2bfloat16_rn(w);
                    Bs[k * BQ * LDX + (c + j) * LDX + r] = part;
                    w -= __bfloat162float(part);
                }
            }
        }
        __syncthreads();

#pragma unroll
        for (int kk = 0; kk < BT / 16; ++kk) {
            const int c = kk * 16 + 2 * t4;
            uint32_t af[SPLIT][4];
#pragma unroll
            for (int k = 0; k < SPLIT; ++k) {
                const bf16* bk = Bs + k * BQ * LDX;
                af[k][0] = ld_u32(&bk[r0 * LDX + c]);
                af[k][1] = ld_u32(&bk[(r0 + 8) * LDX + c]);
                af[k][2] = ld_u32(&bk[r0 * LDX + c + 8]);
                af[k][3] = ld_u32(&bk[(r0 + 8) * LDX + c + 8]);
            }
#pragma unroll
            for (int dn = 0; dn < P / 8; ++dn) {
                const bf16* xr = &Xt[(dn * 8 + g) * LDX + c];
                const uint32_t b0 = ld_u32(xr), b1 = ld_u32(xr + 8);
                // smallest part first
#pragma unroll
                for (int k = SPLIT - 1; k >= 0; --k)
                    mma_16816(acc[dn], af[k], b0, b1);
            }
        }
    }

    float* stp = a.state + ((long long)bc * a.H + h) * N * P;
#pragma unroll
    for (int row = 0; row < 2; ++row) {
        const int n = n0 + r0 + 8 * row;
        if (n >= N) continue;
#pragma unroll
        for (int dn = 0; dn < P / 8; ++dn) {
            const int c = dn * 8 + 2 * t4;
            *reinterpret_cast<float2*>(&stp[(long long)n * P + c]) =
                make_float2(acc[dn][2 * row], acc[dn][2 * row + 1]);
        }
    }
}

template <int P>
__global__ void __launch_bounds__(MMA_THREADS)
ssd_mma_kernel(Args a)
{
    extern __shared__ float4 smem4[];
    unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
    const int nq = tiles(a.Q, BQ);
    const int h = blockIdx.y, bc = blockIdx.z;
    if ((int)blockIdx.x < nq)          // longest causal rows first
        y_tile_mma<P>(a, bc, h, (nq - 1 - blockIdx.x) * BQ, smem);
    else
        state_tile_mma<P>(a, bc, h, (blockIdx.x - nq) * BQ, smem);
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
    const int nq = tiles(a.Q, BQ);
    const int h = blockIdx.y, bc = blockIdx.z;
    if ((int)blockIdx.x < nq)
        y_tile_simt<P>(a, bc, h, (nq - 1 - blockIdx.x) * BQ, smem);
    else
        state_tile_simt<P>(a, bc, h, (blockIdx.x - nq) * BQ, smem);
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
int launch_p(const Args& a, dim3 grid, int dtype, cudaStream_t stream)
{
    static size_t allowed_simt = 0, allowed_mma = 0;
    if (dtype == 0) {
        const size_t smem = simt_smem_bytes(a.N, P);
        cudaError_t e = allow_smem(ssd_simt_kernel<P>, smem, &allowed_simt);
        if (e != cudaSuccess) return (int)e;
        ssd_simt_kernel<P><<<grid, SIMT_THREADS, smem, stream>>>(a);
    } else {
        const size_t smem = mma_smem_bytes(a.N, P);
        cudaError_t e = allow_smem(ssd_mma_kernel<P>, smem, &allowed_mma);
        if (e != cudaSuccess) return (int)e;
        ssd_mma_kernel<P><<<grid, MMA_THREADS, smem, stream>>>(a);
    }
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// xdt (BC, H, Q, P), b and c (BC, H, Q, N), cs (BC, H, Q) f32 and y
// (BC, H, Q, P), each with element strides (bc, h, q) and a contiguous
// last axis; state (BC, H, N, P) f32 contiguous.  dtype: 0 = f32 (the
// SIMT kernel), 1 = bf16 (the mma kernel).  N % 16 == 0, P in
// {16, 32, 64, 128}.  Launches on `stream`; returns the cudaError_t of
// the launch (0 = ok).
int ssd_chunk_launch(
    const void* xdt, const void* b, const void* c, const void* cs,
    void* y, void* state, int BC, int H, int Q, int N, int P,
    long long xb, long long xh, long long xq,
    long long bb, long long bh, long long bq,
    long long cb, long long ch, long long cq,
    long long sb, long long sh, long long sq,
    long long yb, long long yh, long long yq,
    int dtype, void* stream)
{
    if (BC <= 0 || BC > 65535 || H <= 0 || H > 65535 || Q <= 0 ||
        N <= 0 || N % 16 != 0 || dtype < 0 || dtype > 1)
        return (int)cudaErrorInvalidValue;
    const Args a{xdt, b, c, (const float*)cs, y, (float*)state, H, Q, N, P,
                 xb, xh, xq, bb, bh, bq, cb, ch, cq, sb, sh, sq,
                 yb, yh, yq};
    const dim3 grid((Q + BQ - 1) / BQ + (N + BQ - 1) / BQ, H, BC);
    cudaStream_t s = (cudaStream_t)stream;
    switch (P) {
    case 16: return launch_p<16>(a, grid, dtype, s);
    case 32: return launch_p<32>(a, grid, dtype, s);
    case 64: return launch_p<64>(a, grid, dtype, s);
    case 128: return launch_p<128>(a, grid, dtype, s);
    default: return (int)cudaErrorInvalidValue;
    }
}

const char* ssd_chunk_error_string(int err)
{
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
