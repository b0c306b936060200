// One leapfrog step of the 4th-order acoustic wave equation for a batch
// of shots, with no source and no receiver — the Hopper kernel of the
// step-at-a-time engine (fwi/solver.py::make_scan_runner) and of the
// paper's calibration sweep that times it (fwi/calibrate.py).
//
// Replaces the TPU kernel wave_step_pallas of the JAX package
// (src/repro/kernels/stencil/kernel.py, body _wave_kernel), which the JAX
// engine vmaps over shots; here the whole batch is one launch.
//
// On every cell of every shot s:
//   p_next[s]   = ((2*p[s] - p_prev[s]) + v2dt2*lap4(p[s])) * sponge
//   p_damped[s] = p[s] * sponge
// with a zero halo at the field edge.  Outputs (S, NZ, NX) each.
//
// Design (a simple kernel that is right; speed comes later):
//   * One CTA owns a TZ x TX output tile (a launch argument; any NZ and
//     NX, the ragged edge masked) and loops over the shots, so the
//     v2dt2 / sponge tiles are read from HBM once for the whole batch.
//   * Per shot it loads a (TZ + 4) x (TX + 4) window of p into shared
//     memory; cells outside the field load as 0, which is the
//     reference's zero pad.  p_prev is read straight from HBM at the
//     thread's own cell (each value is used once).
//   * The Laplacian adds in the reference's order (centre, then
//     ((z-d + z+d) + x-d) + x+d for d = 1, 2; kernels/stencil/ref.py::
//     laplacian_of_padded), not in the Pallas kernel's z-ring-then-x-ring
//     order, and the file is built with --fmad=false, so the result is
//     bitwise equal to the plain PyTorch version.
//
// Bound: memory.  The least traffic reads p and p_prev per shot and the
// two model fields once, and writes two fields per shot:
//   4 * (4S + 2) * NZ * NX bytes,
// against 17 f32 flops per cell: about 1 flop/byte, far below the H100's
// f32 ridge of 20 (67 TFLOP/s over 3.35 TB/s).  Each CTA reads its p
// window (TZ + 4)(TX + 4) / (TZ * TX) times over (1.27x at 32 x 32); the
// overlap with its neighbours mostly hits L2.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int HALO = 2;
constexpr float TWO_C0 = (float)(2.0 * (-5.0 / 2.0));
constexpr float C1 = (float)(4.0 / 3.0);
constexpr float C2 = (float)(-1.0 / 12.0);

__global__ void __launch_bounds__(256)
wave_step_shots_kernel(
    const float* __restrict__ p, const float* __restrict__ pp,
    const float* __restrict__ v2dt2, const float* __restrict__ sponge,
    float* __restrict__ p_next, float* __restrict__ p_damped,
    int ns, int nz, int nx, int tz, int tx)
{
    extern __shared__ float smem[];
    const int wz = tz + 2 * HALO;
    const int wx = tx + 2 * HALO;
    float* win = smem;                       // (wz, wx) window of p[s]
    float* vt = win + wz * wx;               // (tz, tx) v2dt2 tile
    float* st = vt + tz * tx;                // (tz, tx) sponge tile

    const int z0 = blockIdx.y * tz;          // owned tile origin
    const int x0 = blockIdx.x * tx;
    const int ty = threadIdx.y, txi = threadIdx.x;
    const int by = blockDim.y, bx = blockDim.x;
    const size_t plane = (size_t)nz * nx;

    // shared model tiles, loaded once for every shot
    for (int r = ty; r < tz; r += by) {
        const int gz = z0 + r;
        for (int c = txi; c < tx; c += bx) {
            const int gx = x0 + c;
            const bool in = gz < nz && gx < nx;
            const size_t g = (size_t)gz * nx + gx;
            vt[r * tx + c] = in ? v2dt2[g] : 0.f;
            st[r * tx + c] = in ? sponge[g] : 0.f;
        }
    }

    for (int s = 0; s < ns; ++s) {
        __syncthreads();                     // last shot's reads are done
        const float* ps = p + s * plane;
        for (int r = ty; r < wz; r += by) {
            const int gz = z0 - HALO + r;
            const bool zin = gz >= 0 && gz < nz;
            for (int c = txi; c < wx; c += bx) {
                const int gx = x0 - HALO + c;
                const bool in = zin && gx >= 0 && gx < nx;
                win[r * wx + c] = in ? ps[(size_t)gz * nx + gx] : 0.f;
            }
        }
        __syncthreads();

        const float* pps = pp + s * plane;
        float* pno = p_next + s * plane;
        float* pdo = p_damped + s * plane;
        for (int r = ty; r < tz; r += by) {
            const int gz = z0 + r;
            if (gz >= nz) break;
            for (int c = txi; c < tx; c += bx) {
                const int gx = x0 + c;
                if (gx >= nx) break;
                const size_t g = (size_t)gz * nx + gx;
                const int i = (r + HALO) * wx + (c + HALO);
                const float ce = win[i];
                float lap = TWO_C0 * ce;
                lap = lap + C1 * (((win[i - wx] + win[i + wx])
                                   + win[i - 1]) + win[i + 1]);
                lap = lap + C2 * (((win[i - 2 * wx] + win[i + 2 * wx])
                                   + win[i - 2]) + win[i + 2]);
                const float sp = st[r * tx + c];
                pno[g] = ((2.f * ce - pps[g]) + vt[r * tx + c] * lap) * sp;
                pdo[g] = ce * sp;
            }
        }
    }
}

// Dynamic shared memory of one CTA: the haloed p window and two tiles.
size_t smem_bytes(int tz, int tx)
{
    const size_t wz = tz + 2 * HALO, wx = tx + 2 * HALO;
    return (wz * wx + 2 * (size_t)tz * tx) * sizeof(float);
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
int wave_step_shots_launch(
    const float* p, const float* pp, const float* v2dt2, const float* sponge,
    float* p_next, float* p_damped, int ns, int nz, int nx, int tz, int tx,
    void* stream)
{
    static size_t smem_allowed = 48 * 1024;
    const size_t smem = smem_bytes(tz, tx);
    if (smem > smem_allowed) {
        cudaError_t e = cudaFuncSetAttribute(
            wave_step_shots_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
        smem_allowed = smem;
    }
    dim3 grid((nx + tx - 1) / tx, (nz + tz - 1) / tz, 1);
    dim3 block(32, 8, 1);
    wave_step_shots_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
        p, pp, v2dt2, sponge, p_next, p_damped, ns, nz, nx, tz, tx);
    return (int)cudaGetLastError();
}

const char* wave_step_error_string(int err)
{
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
