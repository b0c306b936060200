// k fused leapfrog steps of the 4th-order acoustic wave equation for a
// batch of shots — the Hopper kernel of the FWI forward engine.
//
// Replaces the TPU kernels of the JAX package (src/repro/kernels/stencil/
// kernel.py):
//   * wave_block_shots_stream_pallas  (streamed shot batch)
//   * wave_block_shots_pallas         (VMEM-resident shot batch)
// and, through the S=1 view the Python wrapper takes for 2-D fields,
//   * wave_block_stream_pallas and wave_block_pallas  (single shot).
// Hopper has no "resident" form: 227 KB of shared memory holds no
// 600x600 field, so one tiled kernel serves all four entry points.
//
// Per inner step j of k, on every cell of the field:
//   pn = (2*cur - prevd + v2dt2*lap4(cur)) * sponge
//   pn[src_z[s], src_x[s]] += src_vals[s, j]
//   traces[s, j, :] = pn[receiver_row, :]
//   prevd = cur * sponge;  cur = pn
// Outputs p_k, prevd_k (S, NZ, NX) and traces (S, k, NX).
//
// Design:
//   * One CTA owns a TZ x TX output tile and loops over its shots (all
//     of them, or every G-th where the wrapper spreads the shots over G
//     CTAs per tile, grid z) on a (TZ + 2kH) x (TX + 2kH) window, H = 2.
//     Ghost-zone trapezoid: the stale values beyond an interior window
//     edge creep in H cells per step, so after k steps the owned tile is
//     exact; step j skips the column pairs and strips that lie wholly
//     outside the window shrunk by (j+1)*H.  Cells outside the field are
//     never written and read as 0: the reference's zero halo.
//   * A fixed thread -> cell map: a thread owns a strip of R rows of a
//     pair of window columns for all k steps and all shots.  Its cells'
//     current and damped-previous values, v2dt2 and sponge live in
//     registers (the model fields loaded once per CTA); z neighbours
//     inside the strip and the pair's own x neighbours come from
//     registers.  Shared memory holds only the current and the next
//     field (ping-pong, one barrier a step): per row a thread reads the
//     two columns on either side as two 8-byte loads and writes its pair
//     as one.  Every cell of a strip is computed branch-free, so the 2R
//     cells interleave; the source and the receiver are a fix-up taken
//     only by the thread that holds the cell.
//   * R = 4 or 8, and one or two CTAs per SM (launch bounds of 768 / 576
//     or 512 / 256 threads), as the wrapper picks by the window's size.
//   * The Laplacian adds in the reference's order (centre, then
//     ((z-d + z+d) + x-d) + x+d for d = 1, 2), and the file is built with
//     --fmad=false, so the result is bitwise equal to the plain PyTorch
//     version (kernels/stencil/ref.py).
//
// Bound: memory.  Per block the least traffic reads p, p_prev, v2dt2 and
// sponge once and writes p_k, prevd_k and the traces:
//   4 * ((4S + 2) * NZ * NX + S * k * NX) bytes,
// against 17 f32 flops per cell-step: 7.6 flop/byte at S = 4, k = 8,
// below the H100's f32 ridge of 20 (67 TFLOP/s over 3.35 TB/s).  The
// kernel is bound by its instruction rate instead: each CTA computes
// ~1.9x its owned cell-steps at (32, 64), k = 8 (the trapezoid), ~20
// instructions each, and reads its shots' windows
// (TZ + 4k)(TX + 4k) / (TZ * TX) times over (3x), mostly from L2.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int HALO = 2;
constexpr float TWO_C0 = (float)(2.0 * (-5.0 / 2.0));
constexpr float C1 = (float)(4.0 / 3.0);
constexpr float C2 = (float)(-1.0 / 12.0);

// Launch bounds by rows per thread R and CTAs per SM: the register
// budget 65536 / (threads * CTAS) holds the 8R values of state and the
// work in flight (85 / 113 registers at one CTA, 64 / 128 at two).
template <int R, int CTAS>
struct Bounds {
    static constexpr int threads = CTAS == 2 ? (R == 4 ? 512 : 256)
                                             : (R == 4 ? 768 : 576);
};

// rows of a window of wz rows rounded up to whole strips of R
template <int R>
__host__ __device__ constexpr int window_rows(int wz)
{
    return (wz + R - 1) / R * R;
}

__device__ __forceinline__ float2 ld2(const float* p)
{
    return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ void st2(float* p, float2 v)
{
    *reinterpret_cast<float2*>(p) = v;
}

// One step of a strip: R rows of a pair of window columns (c0, c0+1).
// `a`/`b` point at the strip's first cell (r0, c0) in the current and
// next field.  z neighbours inside the strip and the pair's own x
// neighbours come from `cur`; the two columns on either side and the
// rows beyond the strip's ends are 8-byte loads from `a`.  Every cell
// is computed (no branch per cell, so the 2R cells interleave); with
// MASK, cells outside the field (rows outside [in_lo, in_hi), the
// second column unless c1_in) are held at 0.
template <int R, bool MASK>
__device__ __forceinline__ void step_strip(
    float2 (&cur)[R], float2 (&prv)[R], const float2 (&vw)[R],
    const float2 (&sw)[R], const float* a, float* b, int wx, int in_lo,
    int in_hi, bool c1_in)
{
    float2 m2 = ld2(a - 2 * wx), m1 = ld2(a - wx);
    const float2 u1 = ld2(a + R * wx), u2 = ld2(a + (R + 1) * wx);
#pragma unroll
    for (int i = 0; i < R; ++i) {
        const float2 ce = cur[i];
        const float2 d1 = i + 1 < R ? cur[i + 1] : u1;
        const float2 d2 = i + 2 < R ? cur[i + 2] : (i + 2 == R ? u1 : u2);
        const float2 l = ld2(a + i * wx - 2);        // columns c0-2, c0-1
        const float2 r = ld2(a + i * wx + 2);        // columns c0+2, c0+3
        const float2 v = vw[i], s = sw[i];
        float lap0 = TWO_C0 * ce.x;
        lap0 = lap0 + C1 * (((m1.x + d1.x) + l.y) + ce.y);
        lap0 = lap0 + C2 * (((m2.x + d2.x) + l.x) + r.x);
        float lap1 = TWO_C0 * ce.y;
        lap1 = lap1 + C1 * (((m1.y + d1.y) + ce.x) + r.x);
        lap1 = lap1 + C2 * (((m2.y + d2.y) + l.y) + r.y);
        float2 pn, pd;
        pn.x = ((2.f * ce.x - prv[i].x) + v.x * lap0) * s.x;
        pn.y = ((2.f * ce.y - prv[i].y) + v.y * lap1) * s.y;
        pd.x = ce.x * s.x;
        pd.y = ce.y * s.y;
        if (MASK) {
            const bool row_in = i >= in_lo && i < in_hi;
            pn.x = row_in ? pn.x : 0.f;
            pd.x = row_in ? pd.x : 0.f;
            pn.y = row_in && c1_in ? pn.y : 0.f;
            pd.y = row_in && c1_in ? pd.y : 0.f;
        }
        st2(b + i * wx, pn);
        prv[i] = pd;
        cur[i] = pn;
        m2 = m1;
        m1 = ce;
    }
}

template <int R, int CTAS>
__global__ void __launch_bounds__(Bounds<R, CTAS>::threads, CTAS)
wave_block_shots_kernel(
    const float* __restrict__ p, const float* __restrict__ pp,
    const float* __restrict__ v2dt2, const float* __restrict__ sponge,
    const float* __restrict__ src_vals, int sv_stride,
    const int* __restrict__ src_z, const int* __restrict__ src_x,
    float* __restrict__ p_out, float* __restrict__ pp_out,
    float* __restrict__ traces,
    int ns, int nz, int nx, int k, int rrow, int tz, int tx)
{
    extern __shared__ __align__(16) float smem[];
    const int reach = k * HALO;
    const int wz = tz + 2 * reach;
    const int wx = tx + 2 * reach;           // even: tx is
    // each buffer holds the window's rows padded to whole strips, with
    // HALO zero rows above and below
    const int bsize = (window_rows<R>(wz) + 2 * HALO) * wx;
    for (int i = threadIdx.x; i < 2 * bsize; i += blockDim.x)
        smem[i] = 0.f;                       // zero halo and padding
    float* cur_w = smem + HALO * wx;         // current field
    float* nxt_w = cur_w + bsize;            // next field

    const int pairs = wx / 2;
    const int c = threadIdx.x % pairs * 2;   // this thread's columns c, c+1
    const int r0 = threadIdx.x / pairs * R;  // and the first row of its strip
    const int z0 = blockIdx.y * tz;          // owned tile origin
    const int x0 = blockIdx.x * tx;
    const int gz0 = z0 - reach;              // window origin in the field
    const int gx0 = x0 - reach;              // (even)
    const int gx = gx0 + c;
    const bool c0_in = gx >= 0 && gx < nx;   // c+1 is in the field only if
    const bool c1_in = gx + 1 < nx && c0_in; // c is (gx even)
    // strip rows i in [in_lo, in_hi) lie in the field (and the window)
    const int in_lo = max(0, -gz0) - r0;
    const int in_hi = min(wz, nz - gz0) - r0;
    const bool all_in = in_lo <= 0 && in_hi >= R && c1_in;
    const size_t plane = (size_t)nz * nx;
    const ptrdiff_t g0 = (ptrdiff_t)(gz0 + r0) * nx + gx;   // cell i=0
    const int s0 = r0 * wx + c;              // its shared index
    const bool own = c >= reach && c < reach + tx && c0_in;
    const int rx_i = own && rrow >= z0 && rrow < z0 + tz
        ? rrow - gz0 - r0 : -1;              // receiver row in the strip

    // model fields, once for every shot
    float2 vw[R], sw[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
        const bool rin = i >= in_lo && i < in_hi;
        const ptrdiff_t g = g0 + (ptrdiff_t)i * nx;
        vw[i].x = rin && c0_in ? v2dt2[g] : 0.f;
        vw[i].y = rin && c1_in ? v2dt2[g + 1] : 0.f;
        sw[i].x = rin && c0_in ? sponge[g] : 0.f;
        sw[i].y = rin && c1_in ? sponge[g + 1] : 0.f;
    }
    __syncthreads();                         // zeroing before any write

    for (int s = blockIdx.z; s < ns; s += gridDim.z) {
        float2 cur[R], prv[R];
        const float* ps = p + s * plane;
        const float* pps = pp + s * plane;
#pragma unroll
        for (int i = 0; i < R; ++i) {
            const bool rin = i >= in_lo && i < in_hi;
            const bool in0 = rin && c0_in, in1 = rin && c1_in;
            const ptrdiff_t g = g0 + (ptrdiff_t)i * nx;
            cur[i].x = in0 ? ps[g] : 0.f;
            cur[i].y = in1 ? ps[g + 1] : 0.f;
            prv[i].x = in0 ? pps[g] : 0.f;
            prv[i].y = in1 ? pps[g + 1] : 0.f;
            st2(cur_w + s0 + i * wx, cur[i]);
        }
        __syncthreads();

        // the source cell, if it is in the field and in this thread's
        // strip and columns: (row in the strip, column 0 or 1)
        const int sz = src_z[s], sx = src_x[s];
        const bool src_here = sz >= 0 && sz < nz && sx >= 0 && sx < nx
            && (sx - gx0 - c) >> 1 == 0 && (unsigned)(sz - gz0 - r0) < R;
        const int src_i = sz - gz0 - r0;
        const int src_c = sx - gx0 - c;
        const float* sv = src_vals + (size_t)s * sv_stride;
        float* tr = traces + (size_t)s * k * nx + gx;
        const float* a = cur_w + s0;         // current field, cell i=0
        float* b = nxt_w + s0;               // next field
        for (int j = 0; j < k; ++j) {
            const int lo = (j + 1) * HALO;   // trapezoid: shrink per step
            // whole column pairs and strips outside the live region skip
            if (c0_in && c >= lo && c < wx - lo && r0 + R > lo
                && r0 < wz - lo) {
                if (all_in)
                    step_strip<R, false>(cur, prv, vw, sw, a, b, wx,
                                         in_lo, in_hi, c1_in);
                else
                    step_strip<R, true>(cur, prv, vw, sw, a, b, wx,
                                        in_lo, in_hi, c1_in);
                if (src_here) {              // pn[src] += src_vals[s, j]
                    const float amp = sv[j];
#pragma unroll
                    for (int i = 0; i < R; ++i) {
                        if (i == src_i) {
                            if (src_c == 0) cur[i].x = cur[i].x + amp;
                            else cur[i].y = cur[i].y + amp;
                            st2(b + i * wx, cur[i]);
                        }
                    }
                }
                if ((unsigned)rx_i < R) {    // traces[s, j, :] = pn[rrow, :]
#pragma unroll
                    for (int i = 0; i < R; ++i) {
                        if (i == rx_i) {
                            tr[(size_t)j * nx] = cur[i].x;
                            if (c1_in) tr[(size_t)j * nx + 1] = cur[i].y;
                        }
                    }
                }
            }
            __syncthreads();
            const float* t = a;              // next -> current
            a = b;
            b = const_cast<float*>(t);
        }

        if (own) {
            float* po = p_out + s * plane;
            float* ppo = pp_out + s * plane;
#pragma unroll
            for (int i = 0; i < R; ++i) {
                const int r = r0 + i;
                if (r >= reach && r < reach + tz && i >= in_lo && i < in_hi) {
                    const ptrdiff_t g = g0 + (ptrdiff_t)i * nx;
                    po[g] = cur[i].x;
                    ppo[g] = prv[i].x;
                    if (c1_in) {
                        po[g + 1] = cur[i].y;
                        ppo[g + 1] = prv[i].y;
                    }
                }
            }
        }
    }
}

// dynamic shared memory of one CTA: two buffers of the window's rows in
// whole strips of R + 2 HALO rows (kernel.py::smem_bytes)
template <int R>
size_t block_smem_bytes(int k, int tz, int tx)
{
    const int wz = tz + 2 * k * HALO, wx = tx + 2 * k * HALO;
    return 2 * (size_t)(window_rows<R>(wz) + 2 * HALO) * wx * sizeof(float);
}

template <int R, int CTAS>
int launch(const float* p, const float* pp, const float* v2dt2,
           const float* sponge, const float* src_vals, int sv_stride,
           const int* src_z, const int* src_x, float* p_out, float* pp_out,
           float* traces, int ns, int nz, int nx, int k, int rrow, int tz,
           int tx, int groups, cudaStream_t stream)
{
    const int wz = tz + 2 * k * HALO, wx = tx + 2 * k * HALO;
    const int threads = wx / 2 * ((wz + R - 1) / R);
    if (tx % 2 || groups < 1 || threads > Bounds<R, CTAS>::threads)
        return (int)cudaErrorInvalidConfiguration;
    const size_t smem = block_smem_bytes<R>(k, tz, tx);
    static size_t smem_allowed = 48 * 1024;
    auto* fn = wave_block_shots_kernel<R, CTAS>;
    if (smem > smem_allowed) {
        cudaError_t e = cudaFuncSetAttribute(
            fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
        smem_allowed = smem;
    }
    dim3 grid((nx + tx - 1) / tx, (nz + tz - 1) / tz, groups);
    fn<<<grid, threads, smem, stream>>>(
        p, pp, v2dt2, sponge, src_vals, sv_stride, src_z, src_x,
        p_out, pp_out, traces, ns, nz, nx, k, rrow, tz, tx);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` with `rows` (4 or 8) rows per thread, launch
// bounds for `ctas` (1 or 2) CTAs per SM and the shots spread over
// `groups` CTAs per tile; returns the cudaError_t of the launch (0 = ok).
int wave_block_shots_launch(
    const float* p, const float* pp, const float* v2dt2, const float* sponge,
    const float* src_vals, int sv_stride, const int* src_z, const int* src_x,
    float* p_out, float* pp_out, float* traces,
    int ns, int nz, int nx, int k, int rrow, int tz, int tx, int rows,
    int ctas, int groups, void* stream)
{
    cudaStream_t st = (cudaStream_t)stream;
#define WB_ARGS p, pp, v2dt2, sponge, src_vals, sv_stride, src_z, src_x, \
    p_out, pp_out, traces, ns, nz, nx, k, rrow, tz, tx, groups, st
    if (rows == 4 && ctas == 1) return launch<4, 1>(WB_ARGS);
    if (rows == 4 && ctas == 2) return launch<4, 2>(WB_ARGS);
    if (rows == 8 && ctas == 1) return launch<8, 1>(WB_ARGS);
    if (rows == 8 && ctas == 2) return launch<8, 2>(WB_ARGS);
#undef WB_ARGS
    return (int)cudaErrorInvalidValue;
}

// The dynamic shared memory wave_block_shots_launch requests for a
// (tz, tx) tile at k steps and `rows` rows per thread (0 for a row
// count it does not take).
size_t wave_block_smem_bytes(int k, int tz, int tx, int rows)
{
    if (rows == 4) return block_smem_bytes<4>(k, tz, tx);
    if (rows == 8) return block_smem_bytes<8>(k, tz, tx);
    return 0;
}

const char* wave_block_error_string(int err)
{
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
