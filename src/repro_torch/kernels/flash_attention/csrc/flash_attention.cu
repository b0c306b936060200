// Flash attention forward (causal or not, GQA) — the Hopper kernel of
// the port's prefill attention (models/attention.py::apply_attn_full).
//
// Replaces the TPU kernel flash_attention of the JAX package
// (src/repro/kernels/flash_attention/kernel.py, body _flash_kernel).
//
// For every batch b, head h and query row i < S:
//   o[b,h,i] = softmax_j(q[b,h,i] . k[b,h/rep,j] * D^-1/2) . v[b,h/rep,j]
// over j <= i when causal, all j < S otherwise; rep = H / KH.  The
// scores, the running max m, the running sum l and the accumulator are
// f32; q, k, v and o are f32 or bf16.  Tensors come with strides (the
// last axis contiguous), so the model's (B, S, H, D) projections are
// read in place.
//
// Design (a simple kernel that is right; speed comes later):
//   * D is 32, 64 or 128.  One CTA per (b, h, 64-row query tile); the
//     grid runs the query tiles in reverse, so the longest causal rows
//     start first.  A loop
//     inside the CTA walks the 64-row key/value tiles (the TPU kernel's
//     sequential grid axis), staging each in shared memory, with the
//     online softmax in f32.  Tiles wholly above the diagonal are never
//     loaded; the diagonal tile and the ragged edge (any S >= 1; the TPU
//     kernel needs S % bq == 0) mask elementwise with -1e30, as the TPU
//     kernel does.
//   * f32 (flash_simt_kernel): CUDA-core fmaf.  256 threads; thread
//     (ty, tx) owns a 4x4 block of the 64x64 score tile and the same 4
//     rows of the output accumulator (D/16 columns), so the softmax
//     rescale is local; row maxima and sums reduce over the 16 threads
//     of a row with shuffles.  Q and K are staged transposed (d-major),
//     P transposed, V row-major, so the inner loops read float4s
//     (float2s of V at D = 32).
//   * bf16 (flash_mma_bf16_kernel): tensor cores via mma.sync
//     m16n8k16 (bf16 in, f32 accumulate).  4 warps, 16 query rows each;
//     the Q fragments stay in registers, S = Q K^T lands in the mma
//     accumulator layout, which is reused as the A operand of P V after
//     rounding P to bf16 (as the plain version rounds its probabilities
//     to q's dtype).  K is staged row-major and V transposed in shared
//     memory, rows padded by 8 elements so fragment loads are free of
//     bank conflicts.  wgmma, TMA and warp specialisation come later.
//
// Bound: at Yi-6B's prefill (B=4, H=32, KH=4, S=512, D=128, bf16,
// causal) the least work is 4*B*H*D*S(S+1)/2 = 8.6 GFLOP (8.7 us at the
// bf16 tensor peak) and the least traffic reads q, k, v and writes o
// once: 38 MB (11.3 us at 3.35 TB/s), so bytes bound it.  Each CTA
// reads its kv head's tiles up to the diagonal, so k and v are read
// ~S/128 * H/KH times over; those reads mostly hit the 50 MB L2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;           // query rows per CTA
constexpr int BK = 64;           // key rows per tile

struct Strides {                 // element strides of (b, h, s); d is 1
    long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

__device__ __forceinline__ int key_tiles(int S, int q0, int causal)
{
    const int n = (S + BK - 1) / BK;
    if (!causal) return n;
    const int last = (q0 + BQ - 1) / BK + 1;
    return last < n ? last : n;
}

// ------------------------------------------------------------------ SIMT

constexpr int SIMT_THREADS = 256;
constexpr int LDT = BQ + 4;      // row stride of the transposed tiles

template <int D>
constexpr size_t simt_smem_bytes()
{
    // Qt (D, LDT), a K-or-V buffer (D, LDT) >= (BK, D), Pt (BK, LDT)
    return sizeof(float) * (2 * (size_t)D * LDT + (size_t)BK * LDT);
}

template <int D>
__global__ void __launch_bounds__(SIMT_THREADS)
flash_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, int S,
                  int rep, Strides st, float scale, int causal)
{
    // thread (ty, tx) owns output columns g * 16 * VW + tx * VW + j
    constexpr int VW = D >= 64 ? 4 : 2;
    constexpr int NG = D / (16 * VW);
    extern __shared__ float4 smem4[];
    float* Qt = reinterpret_cast<float*>(smem4);   // Qt[d * LDT + r]
    float* KV = Qt + D * LDT;    // K as KV[d * LDT + r], V as KV[r * D + d]
    float* Pt = KV + D * LDT;    // Pt[c * LDT + r]

    const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
    const int h = blockIdx.y, b = blockIdx.z, kvh = h / rep;
    const float* qp = q + b * st.qb + h * st.qh;
    const float* kp = k + b * st.kb + kvh * st.kh;
    const float* vp = v + b * st.vb + kvh * st.vh;
    float* op = o + b * st.ob + h * st.oh;
    const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

    for (int e = tid; e < BQ * D; e += SIMT_THREADS) {
        const int r = e / D, d = e % D, i = q0 + r;
        Qt[d * LDT + r] = i < S ? qp[i * st.qs + d] : 0.f;
    }

    float m[4], l[4], acc[4][D / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = NEG_INF;
        l[i] = 0.f;
#pragma unroll
        for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;
    }

    const int nt = key_tiles(S, q0, causal);
    for (int t = 0; t < nt; ++t) {
        const int k0 = t * BK;
        __syncthreads();                     // KV and Pt free again
        for (int e = tid; e < BK * D; e += SIMT_THREADS) {
            const int r = e / D, d = e % D, j = k0 + r;
            KV[d * LDT + r] = j < S ? kp[j * st.ks + d] : 0.f;
        }
        __syncthreads();

        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) {
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
                if (kj >= S || (causal && kj > qi)) x = NEG_INF;
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
            for (int c = 0; c < D / 16; ++c) acc[i][c] *= alpha;
        }

        __syncthreads();                     // every thread is done with K
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
                Pt[(tx * 4 + j) * LDT + ty * 4 + i] = s[i][j];
        for (int e = tid; e < BK * D; e += SIMT_THREADS) {
            const int r = e / D, d = e % D, j = k0 + r;
            KV[r * D + d] = j < S ? vp[j * st.vs + d] : 0.f;
        }
        __syncthreads();

#pragma unroll 4
        for (int c = 0; c < BK; ++c) {
            const float4 p4 = *reinterpret_cast<const float4*>(
                &Pt[c * LDT + ty * 4]);
            const float pr[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
            for (int g = 0; g < NG; ++g) {
                const float* vrow = &KV[c * D + g * 16 * VW + tx * VW];
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
        if (qi >= S) continue;
        const float lv = fmaxf(l[i], 1e-30f);
#pragma unroll
        for (int g = 0; g < NG; ++g)
#pragma unroll
            for (int j = 0; j < VW; ++j)
                op[qi * st.os + g * 16 * VW + tx * VW + j] =
                    acc[i][g * VW + j] / lv;
    }
}

// ------------------------------------------------------- bf16, mma.sync

constexpr int MMA_THREADS = 128;  // 4 warps x 16 query rows
constexpr int LDV = BK + 8;       // row stride of the transposed V tile

template <int D>
constexpr size_t mma_smem_bytes()
{
    // Qs (BQ, D+8), Ks (BK, D+8), Vt (D, BK+8), bf16
    return 2 * ((size_t)BQ * (D + 8) + (size_t)BK * (D + 8) +
                (size_t)D * LDV);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p)
{
    return *reinterpret_cast<const uint32_t*>(p);
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

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_mma_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ o, int S, int rep,
                      Strides st, float scale, int causal)
{
    constexpr int LDS = D + 8;
    extern __shared__ float4 smem4[];
    __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem4);
    __nv_bfloat16* Ks = Qs + BQ * LDS;       // Ks[r * LDS + d]
    __nv_bfloat16* Vt = Ks + BK * LDS;       // Vt[d * LDV + r]

    const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
    const int h = blockIdx.y, b = blockIdx.z, kvh = h / rep;
    const __nv_bfloat16* qp = q + b * st.qb + h * st.qh;
    const __nv_bfloat16* kp = k + b * st.kb + kvh * st.kh;
    const __nv_bfloat16* vp = v + b * st.vb + kvh * st.vh;
    __nv_bfloat16* op = o + b * st.ob + h * st.oh;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;

    for (int e = tid; e < BQ * D / 2; e += MMA_THREADS) {
        const int r = e / (D / 2), c = (e % (D / 2)) * 2, i = q0 + r;
        *reinterpret_cast<uint32_t*>(&Qs[r * LDS + c]) =
            i < S ? ld_u32(qp + i * st.qs + c) : 0u;
    }
    __syncthreads();

    // this thread's rows of the warp's 16: r0 and r0 + 8
    const int r0 = warp * 16 + g;
    uint32_t qf[D / 16][4];
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
        const int c = ks * 16 + 2 * t4;
        qf[ks][0] = ld_u32(&Qs[r0 * LDS + c]);
        qf[ks][1] = ld_u32(&Qs[(r0 + 8) * LDS + c]);
        qf[ks][2] = ld_u32(&Qs[r0 * LDS + c + 8]);
        qf[ks][3] = ld_u32(&Qs[(r0 + 8) * LDS + c + 8]);
    }
    const int qrow[2] = {q0 + r0, q0 + r0 + 8};

    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    float acc[D / 8][4];
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;

    const int nt = key_tiles(S, q0, causal);
    for (int t = 0; t < nt; ++t) {
        const int k0 = t * BK;
        __syncthreads();                     // Ks and Vt free again
        for (int e = tid; e < BK * D / 2; e += MMA_THREADS) {
            // K: neighbouring threads take neighbouring column pairs
            const int r = e / (D / 2), c = (e % (D / 2)) * 2, j = k0 + r;
            *reinterpret_cast<uint32_t*>(&Ks[r * LDS + c]) =
                j < S ? ld_u32(kp + j * st.ks + c) : 0u;
            // V: neighbouring threads take neighbouring rows, so the
            // transposed 16-bit stores fall in distinct banks
            const int rv = e % BK, cv = (e / BK) * 2, jv = k0 + rv;
            uint32_t w = jv < S ? ld_u32(vp + jv * st.vs + cv) : 0u;
            const __nv_bfloat162 pair =
                *reinterpret_cast<const __nv_bfloat162*>(&w);
            Vt[cv * LDV + rv] = pair.x;
            Vt[(cv + 1) * LDV + rv] = pair.y;
        }
        __syncthreads();

        float s[BK / 8][4];
#pragma unroll
        for (int n8 = 0; n8 < BK / 8; ++n8) {
#pragma unroll
            for (int e = 0; e < 4; ++e) s[n8][e] = 0.f;
            const __nv_bfloat16* kr = &Ks[(n8 * 8 + g) * LDS + 2 * t4];
#pragma unroll
            for (int ks = 0; ks < D / 16; ++ks)
                mma_16816(s[n8], qf[ks], ld_u32(kr + ks * 16),
                          ld_u32(kr + ks * 16 + 8));
        }

        // accumulator layout: e = 0, 1 -> row r0, e = 2, 3 -> row r0 + 8;
        // key column n8 * 8 + 2 * t4 + (e & 1)
        float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
        for (int n8 = 0; n8 < BK / 8; ++n8)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int row = e >> 1;
                const int kj = k0 + n8 * 8 + 2 * t4 + (e & 1);
                float x = s[n8][e] * scale;
                if (kj >= S || (causal && kj > qrow[row])) x = NEG_INF;
                s[n8][e] = x;
                mx[row] = fmaxf(mx[row], x);
            }
        float alpha[2], m_new[2], rs[2] = {0.f, 0.f};
#pragma unroll
        for (int row = 0; row < 2; ++row) {
            mx[row] = fmaxf(mx[row], __shfl_xor_sync(0xffffffffu, mx[row], 1));
            mx[row] = fmaxf(mx[row], __shfl_xor_sync(0xffffffffu, mx[row], 2));
            m_new[row] = fmaxf(m[row], mx[row]);
            alpha[row] = expf(m[row] - m_new[row]);
        }
#pragma unroll
        for (int n8 = 0; n8 < BK / 8; ++n8)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float p = expf(s[n8][e] - m_new[e >> 1]);
                s[n8][e] = p;
                rs[e >> 1] += p;
            }
#pragma unroll
        for (int row = 0; row < 2; ++row) {
            rs[row] += __shfl_xor_sync(0xffffffffu, rs[row], 1);
            rs[row] += __shfl_xor_sync(0xffffffffu, rs[row], 2);
            l[row] = l[row] * alpha[row] + rs[row];
            m[row] = m_new[row];
        }
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn) {
            acc[dn][0] *= alpha[0];
            acc[dn][1] *= alpha[0];
            acc[dn][2] *= alpha[1];
            acc[dn][3] *= alpha[1];
        }

#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
            const uint32_t a[4] = {
                pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]),
            };
#pragma unroll
            for (int dn = 0; dn < D / 8; ++dn) {
                const __nv_bfloat16* vr =
                    &Vt[(dn * 8 + g) * LDV + kk * 16 + 2 * t4];
                mma_16816(acc[dn], a, ld_u32(vr), ld_u32(vr + 8));
            }
        }
    }

#pragma unroll
    for (int row = 0; row < 2; ++row) {
        const int qi = qrow[row];
        if (qi >= S) continue;
        const float lv = fmaxf(l[row], 1e-30f);
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn) {
            const int c = dn * 8 + 2 * t4;
            *reinterpret_cast<uint32_t*>(&op[qi * st.os + c]) =
                pack_bf16(acc[dn][2 * row] / lv, acc[dn][2 * row + 1] / lv);
        }
    }
}

// ---------------------------------------------------------------- launch

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes)
{
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int D>
int launch_simt(const void* q, const void* k, const void* v, void* o,
                dim3 grid, int S, int rep, const Strides& st, float scale,
                int causal, cudaStream_t stream)
{
    constexpr size_t smem = simt_smem_bytes<D>();
    static bool ready = false;
    if (!ready) {
        cudaError_t e = allow_smem(flash_simt_kernel<D>, smem);
        if (e != cudaSuccess) return (int)e;
        ready = true;
    }
    flash_simt_kernel<D><<<grid, SIMT_THREADS, smem, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)o, S,
        rep, st, scale, causal);
    return (int)cudaGetLastError();
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               dim3 grid, int S, int rep, const Strides& st, float scale,
               int causal, cudaStream_t stream)
{
    constexpr size_t smem = mma_smem_bytes<D>();
    static bool ready = false;
    if (!ready) {
        cudaError_t e = allow_smem(flash_mma_bf16_kernel<D>, smem);
        if (e != cudaSuccess) return (int)e;
        ready = true;
    }
    flash_mma_bf16_kernel<D><<<grid, MMA_THREADS, smem, stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, (__nv_bfloat16*)o, S, rep, st, scale,
        causal);
    return (int)cudaGetLastError();
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, void* o,
             dim3 grid, int S, int rep, const Strides& st, float scale,
             int causal, int dtype, cudaStream_t stream)
{
    if (dtype == 0)
        return launch_simt<D>(q, k, v, o, grid, S, rep, st, scale, causal,
                              stream);
    return launch_mma<D>(q, k, v, o, grid, S, rep, st, scale, causal,
                         stream);
}

}  // namespace

extern "C" {

// q (B, H, S, D), k and v (B, KH, S, D), o (B, H, S, D), each with
// element strides (b, h, s) and a contiguous last axis.  dtype: 0 = f32
// (the SIMT kernel), 1 = bf16 (the mma kernel).  Launches on `stream`;
// returns the cudaError_t of the launch (0 = ok).
int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o,
    int B, int H, int KH, int S, int D,
    long long qb, long long qh, long long qs,
    long long kb, long long kh, long long ks,
    long long vb, long long vh, long long vs,
    long long ob, long long oh, long long os,
    float scale, int causal, int dtype, void* stream)
{
    if (B <= 0 || H <= 0 || KH <= 0 || S <= 0 || H % KH != 0 ||
        dtype < 0 || dtype > 1)
        return (int)cudaErrorInvalidValue;
    const Strides st{qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os};
    const dim3 grid((S + BQ - 1) / BQ, H, B);
    const int rep = H / KH;
    cudaStream_t s = (cudaStream_t)stream;
    switch (D) {
    case 32:
        return launch_d<32>(q, k, v, o, grid, S, rep, st, scale, causal,
                            dtype, s);
    case 64:
        return launch_d<64>(q, k, v, o, grid, S, rep, st, scale, causal,
                            dtype, s);
    case 128:
        return launch_d<128>(q, k, v, o, grid, S, rep, st, scale, causal,
                             dtype, s);
    default:
        return (int)cudaErrorInvalidValue;
    }
}

const char* flash_attention_error_string(int err)
{
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
