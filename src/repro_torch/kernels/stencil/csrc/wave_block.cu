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
// Design (a simple kernel that is right; speed comes later):
//   * One CTA owns a TZ x TX output tile and loops over the shots, so the
//     v2dt2 / sponge windows are read once for the whole batch (the point
//     of the TPU's shot batching).
//   * It loads a (TZ + 2kH) x (TX + 2kH) window (H = 2) into shared
//     memory.  Cells outside the field load as 0 in every array and are
//     never written, which is the zero halo of the reference.
//   * Ghost-zone trapezoid: the stale values beyond an interior window
//     edge creep in H cells per step, so step j computes only the window
//     shrunk by (j+1)*H on every side; after k steps the owned tile is
//     exact.  The source is injected in every window that holds it.
//   * Three rotating field buffers (cur, prevd, next) need one barrier
//     per step: a thread writes next and prevd only at its own cell.
//   * The Laplacian adds in the reference's order (centre, then
//     ((z-d + z+d) + x-d) + x+d for d = 1, 2), and the file is built with
//     --fmad=false, so the result is bitwise equal to the plain PyTorch
//     version (kernels/stencil/ref.py).
//
// Bound: memory.  Per block the least traffic reads p, p_prev, v2dt2 and
// sponge once and writes p_k, prevd_k and the traces:
//   4 * ((4S + 2) * NZ * NX + S * k * NX) bytes,
// against 17 f32 flops per cell-step: 7.6 flop/byte at S = 4, k = 8,
// below the H100's f32 ridge of 20 (67 TFLOP/s over 3.35 TB/s).  Each
// CTA reads its shots' windows (TZ + 4k)(TX + 4k) / (TZ * TX) times over
// (4x at 32 x 32, k = 8); the overlap with its neighbours mostly hits L2.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int HALO = 2;
constexpr float TWO_C0 = (float)(2.0 * (-5.0 / 2.0));
constexpr float C1 = (float)(4.0 / 3.0);
constexpr float C2 = (float)(-1.0 / 12.0);

__global__ void __launch_bounds__(256)
wave_block_shots_kernel(
    const float* __restrict__ p, const float* __restrict__ pp,
    const float* __restrict__ v2dt2, const float* __restrict__ sponge,
    const float* __restrict__ src_vals, int sv_stride,
    const int* __restrict__ src_z, const int* __restrict__ src_x,
    float* __restrict__ p_out, float* __restrict__ pp_out,
    float* __restrict__ traces,
    int ns, int nz, int nx, int k, int rrow, int tz, int tx)
{
    extern __shared__ float smem[];
    const int reach = k * HALO;
    const int wz = tz + 2 * reach;
    const int wx = tx + 2 * reach;
    const int wsize = wz * wx;
    float* vw = smem;
    float* sw = vw + wsize;
    float* buf0 = sw + wsize;
    float* buf1 = buf0 + wsize;
    float* buf2 = buf1 + wsize;

    const int z0 = blockIdx.y * tz;          // owned tile origin
    const int x0 = blockIdx.x * tx;
    const int gz0 = z0 - reach;              // window origin in the field
    const int gx0 = x0 - reach;
    const int ty = threadIdx.y, txi = threadIdx.x;
    const int by = blockDim.y, bx = blockDim.x;
    const size_t plane = (size_t)nz * nx;
    const bool own_rx = rrow >= z0 && rrow < z0 + tz;

    // shared model windows, loaded once for every shot; the third field
    // buffer starts at 0 so its out-of-field cells read as the zero halo
    for (int r = ty; r < wz; r += by) {
        const int gz = gz0 + r;
        const bool zin = gz >= 0 && gz < nz;
        for (int c = txi; c < wx; c += bx) {
            const int gx = gx0 + c;
            const bool in = zin && gx >= 0 && gx < nx;
            const size_t g = (size_t)gz * nx + gx;
            const int i = r * wx + c;
            vw[i] = in ? v2dt2[g] : 0.f;
            sw[i] = in ? sponge[g] : 0.f;
            buf2[i] = 0.f;
        }
    }

    for (int s = 0; s < ns; ++s) {
        __syncthreads();                     // last shot's stores are done
        float* cur = buf0;
        float* prv = buf1;
        float* nxt = buf2;
        const float* ps = p + s * plane;
        const float* pps = pp + s * plane;
        for (int r = ty; r < wz; r += by) {
            const int gz = gz0 + r;
            const bool zin = gz >= 0 && gz < nz;
            for (int c = txi; c < wx; c += bx) {
                const int gx = gx0 + c;
                const bool in = zin && gx >= 0 && gx < nx;
                const size_t g = (size_t)gz * nx + gx;
                const int i = r * wx + c;
                cur[i] = in ? ps[g] : 0.f;
                prv[i] = in ? pps[g] : 0.f;
            }
        }
        __syncthreads();

        const int sr = src_z[s] - gz0;       // source cell in the window
        const int sc = src_x[s] - gx0;
        float* tr = traces + (size_t)s * k * nx;
        for (int j = 0; j < k; ++j) {
            const int lo = (j + 1) * HALO;   // trapezoid: shrink per step
            const int rz1 = wz - lo, rx1 = wx - lo;
            const float amp = src_vals[(size_t)s * sv_stride + j];
            for (int r = lo + ty; r < rz1; r += by) {
                const int gz = gz0 + r;
                if (gz < 0 || gz >= nz) continue;
                for (int c = lo + txi; c < rx1; c += bx) {
                    const int gx = gx0 + c;
                    if (gx < 0 || gx >= nx) continue;
                    const int i = r * wx + c;
                    const float ce = cur[i];
                    float lap = TWO_C0 * ce;
                    lap = lap + C1 * (((cur[i - wx] + cur[i + wx])
                                       + cur[i - 1]) + cur[i + 1]);
                    lap = lap + C2 * (((cur[i - 2 * wx] + cur[i + 2 * wx])
                                       + cur[i - 2]) + cur[i + 2]);
                    float pn = ((2.f * ce - prv[i]) + vw[i] * lap) * sw[i];
                    if (r == sr && c == sc) pn = pn + amp;
                    nxt[i] = pn;
                    prv[i] = ce * sw[i];
                    if (own_rx && gz == rrow && c >= reach && c < reach + tx)
                        tr[(size_t)j * nx + gx] = pn;
                }
            }
            __syncthreads();
            float* t = cur;                  // next -> cur; old cur is free
            cur = nxt;
            nxt = t;
        }

        float* po = p_out + s * plane;
        float* ppo = pp_out + s * plane;
        for (int r = reach + ty; r < reach + tz; r += by) {
            const int gz = gz0 + r;
            if (gz >= nz) break;
            for (int c = reach + txi; c < reach + tx; c += bx) {
                const int gx = gx0 + c;
                if (gx >= nx) break;
                const size_t g = (size_t)gz * nx + gx;
                const int i = r * wx + c;
                po[g] = cur[i];
                ppo[g] = prv[i];
            }
        }
    }
}

// Dynamic shared memory of one CTA: five (tz + 2kH) x (tx + 2kH) windows.
size_t smem_bytes(int k, int tz, int tx)
{
    const size_t wz = tz + 2 * k * HALO, wx = tx + 2 * k * HALO;
    return 5 * wz * wx * sizeof(float);
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
int wave_block_shots_launch(
    const float* p, const float* pp, const float* v2dt2, const float* sponge,
    const float* src_vals, int sv_stride, const int* src_z, const int* src_x,
    float* p_out, float* pp_out, float* traces,
    int ns, int nz, int nx, int k, int rrow, int tz, int tx, void* stream)
{
    static size_t smem_allowed = 48 * 1024;
    const size_t smem = smem_bytes(k, tz, tx);
    if (smem > smem_allowed) {
        cudaError_t e = cudaFuncSetAttribute(
            wave_block_shots_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
        smem_allowed = smem;
    }
    dim3 grid((nx + tx - 1) / tx, (nz + tz - 1) / tz, 1);
    dim3 block(32, 8, 1);
    wave_block_shots_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
        p, pp, v2dt2, sponge, src_vals, sv_stride, src_z, src_x,
        p_out, pp_out, traces, ns, nz, nx, k, rrow, tz, tx);
    return (int)cudaGetLastError();
}

const char* wave_block_error_string(int err)
{
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
