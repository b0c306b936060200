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
// Design: a streaming register kernel, with no shared memory and no
// barrier.
//   * A thread owns V adjacent columns (V = 4, 2 or 1, as NX and the
//     tensors' alignment allow: one 16-, 8- or 4-byte access per row)
//     and walks down a strip of R rows (R = 4; 2 where the grid is
//     small; the wrapper picks it).  The rows z-2 .. z+2 of p sit in a
//     register queue; each row step loads one new row of p and the
//     thread's own cells of p_prev (streaming), v2dt2 and sponge, and
//     stores its cells of p_next and p_damped (streaming).  The next
//     row's loads are issued before this row is computed, in a loop
//     that is not unrolled (unrolled, ptxas hoisted every row's loads
//     and spilled).
//   * The lanes of a segment (a warp, or 8 or 16 of its lanes on narrow
//     tiles) own contiguous columns, so the x neighbours come from the
//     lanes beside by __shfl_*_sync; the segment's two edge lanes load
//     the two halo columns on their side.
//   * A CTA owns a TZ x TX tile of one shot: TX / V lanes across and
//     TZ / R strips down.  The shot is the fastest-varying block index,
//     so the S CTAs of one tile run together and re-read v2dt2 and
//     sponge from L2 (measured faster at every shape than a CTA that
//     loops over the shots).
//   * Strips that reach past the field (the first and last rows, a
//     ragged last tile) take a masked copy of the row step in which rows
//     and columns outside the field read as 0 (the zero halo) and are
//     not stored; all others take the unmasked one.  The choice is made
//     per warp, so every shuffle runs in step.
//   * The Laplacian adds in the reference's order (centre, then
//     ((z-d + z+d) + x-d) + x+d for d = 1, 2; kernels/stencil/ref.py::
//     laplacian_of_padded), and the file is built with --fmad=false, so
//     the result is bitwise equal to the plain PyTorch version.
//
// Bound: memory.  The least traffic reads p and p_prev per shot and the
// two model fields once, and writes two fields per shot:
//   4 * (4S + 2) * NZ * NX bytes,
// against 17 f32 flops per cell: about 1 flop/byte, far below the H100's
// f32 ridge of 20 (67 TFLOP/s over 3.35 TB/s).  Each strip re-reads the
// 4 rows of p around it ((R + 4) / R of p) and each shot's CTA re-reads
// v2dt2 and sponge; both mostly hit L2, so the HBM traffic stays close
// to the least.  The kernel moves those bytes at 85 % of the HBM rate
// at (4, 4096, 4096) on an H100 SXM at 700 W (PERF.md §6), within 7 %
// of PyTorch's add at the same size (tools/step_bench.py).
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int HALO = 2;
constexpr float TWO_C0 = (float)(2.0 * (-5.0 / 2.0));
constexpr float C1 = (float)(4.0 / 3.0);
constexpr float C2 = (float)(-1.0 / 12.0);
constexpr unsigned FULL = 0xffffffffu;
// Most threads of one CTA by the columns a thread owns: 1024 / V, so a
// tile of TX columns and TZ rows launches alike at every V.  Launch
// bounds give 4 columns up to 85 registers (3 CTAs of 256 per SM: the
// queue, one row in flight and the neighbours hold 48 floats), 1 or 2
// columns 64.
template <int V>
constexpr int max_threads() { return 1024 / V; }
template <int V>
constexpr int min_ctas() { return V == 4 ? 3 : V == 2 ? 2 : 1; }

// V floats at g: p and the model fields through the read-only path,
// p_prev with the streaming hint (each value is read once)
template <int V, bool STREAM>
__device__ __forceinline__ void load(float (&o)[V], const float* g)
{
    if constexpr (V == 4) {
        const float4* q = reinterpret_cast<const float4*>(g);
        const float4 t = STREAM ? __ldcs(q) : __ldg(q);
        o[0] = t.x; o[1] = t.y; o[2] = t.z; o[3] = t.w;
    } else if constexpr (V == 2) {
        const float2* q = reinterpret_cast<const float2*>(g);
        const float2 t = STREAM ? __ldcs(q) : __ldg(q);
        o[0] = t.x; o[1] = t.y;
    } else {
        o[0] = STREAM ? __ldcs(g) : __ldg(g);
    }
}

template <int V>
__device__ __forceinline__ void store(float* g, const float (&v)[V])
{
    if constexpr (V == 4) {
        __stcs(reinterpret_cast<float4*>(g),
               make_float4(v[0], v[1], v[2], v[3]));
    } else if constexpr (V == 2) {
        __stcs(reinterpret_cast<float2*>(g), make_float2(v[0], v[1]));
    } else {
        __stcs(g, v[0]);
    }
}

template <int V>
__device__ __forceinline__ void zero(float (&o)[V])
{
#pragma unroll
    for (int j = 0; j < V; ++j) o[j] = 0.f;
}

// The row z of p at the thread's columns: 0 where MASK and the row or
// the columns lie outside the field.
template <int V, bool MASK>
__device__ __forceinline__ void load_row(float (&o)[V], const float* ps,
                                         int z, int x, int nz, int nx)
{
    if (MASK) {
        zero(o);
        if (z >= 0 && z < nz && x < nx)
            load<V, false>(o, ps + (size_t)z * nx + x);
    } else {
        load<V, false>(o, ps + (size_t)z * nx + x);
    }
}

// The x neighbours of the thread's V cells of row `c`: e[0..1] the two
// columns left of x, e[2..V+1] the cells, e[V+2..V+3] the two right of
// them.  From the lanes beside by shuffles within a segment of `seg`
// lanes; the segment's edge lanes load the columns beyond it from `row`
// (the row's start in p), 0 outside the field.
template <int V>
__device__ __forceinline__ void neighbours(
    float (&e)[V + 4], const float (&c)[V], const float* row, bool zin,
    int x, int nx, int sl, int seg)
{
#pragma unroll
    for (int j = 0; j < V; ++j) e[j + 2] = c[j];
    if constexpr (V >= 2) {
        e[0] = __shfl_up_sync(FULL, c[V - 2], 1, seg);
        e[1] = __shfl_up_sync(FULL, c[V - 1], 1, seg);
        e[V + 2] = __shfl_down_sync(FULL, c[0], 1, seg);
        e[V + 3] = __shfl_down_sync(FULL, c[1], 1, seg);
        // x and the columns beyond the segment are even: 8-byte pairs,
        // both inside the field or both outside (NX is even)
        if (sl == 0) {
            float2 h = make_float2(0.f, 0.f);
            if (zin && x >= 2 && x <= nx)
                h = __ldg(reinterpret_cast<const float2*>(row + x - 2));
            e[0] = h.x; e[1] = h.y;
        }
        if (sl == seg - 1) {
            float2 h = make_float2(0.f, 0.f);
            if (zin && x + V < nx)
                h = __ldg(reinterpret_cast<const float2*>(row + x + V));
            e[V + 2] = h.x; e[V + 3] = h.y;
        }
    } else {
        e[0] = __shfl_up_sync(FULL, c[0], 2, seg);
        e[1] = __shfl_up_sync(FULL, c[0], 1, seg);
        e[3] = __shfl_down_sync(FULL, c[0], 1, seg);
        e[4] = __shfl_down_sync(FULL, c[0], 2, seg);
        if (sl < 2)
            e[0] = zin && x >= 2 && x - 2 < nx ? __ldg(row + x - 2) : 0.f;
        if (sl < 1)
            e[1] = zin && x >= 1 && x - 1 < nx ? __ldg(row + x - 1) : 0.f;
        if (sl >= seg - 1)
            e[3] = zin && x + 1 < nx ? __ldg(row + x + 1) : 0.f;
        if (sl >= seg - 2)
            e[4] = zin && x + 2 < nx ? __ldg(row + x + 2) : 0.f;
    }
}

// The row z's cells of p_prev (streaming), v2dt2 and sponge at the
// thread's columns; 0 where MASK and the cell lies outside the field.
template <int V, bool MASK>
__device__ __forceinline__ void load_cells(
    float (&pv)[V], float (&vv)[V], float (&sv)[V],
    const float* __restrict__ pps, const float* __restrict__ v2dt2,
    const float* __restrict__ sponge, int z, int x, int nz, int nx)
{
    if (MASK) {
        zero(pv); zero(vv); zero(sv);
        if (z >= nz || x >= nx) return;
    }
    const size_t g = (size_t)z * nx + x;
    load<V, true>(pv, pps + g);
    load<V, false>(vv, v2dt2 + g);
    load<V, false>(sv, sponge + g);
}

// One strip of one shot: `rows` rows from z0 of the thread's V columns
// at x.  `ps`, `pps`, `pno`, `pdo` point at the shot's planes.  A
// software pipeline one row deep: the loads of row z+1 (p's row z+3,
// the cells of p_prev, v2dt2 and sponge) are issued before row z is
// computed, so they fly while it is; the loop is not unrolled, which
// keeps the registers to the queue and one row in flight.
template <int V, bool MASK>
__device__ __forceinline__ void strip(
    const float* __restrict__ ps, const float* __restrict__ pps,
    const float* __restrict__ v2dt2, const float* __restrict__ sponge,
    float* __restrict__ pno, float* __restrict__ pdo,
    int nz, int nx, int z0, int rows, int x, int sl, int seg)
{
    float m2[V], m1[V], c[V], p1[V], p2[V], pv[V], vv[V], sv[V];
    load_row<V, MASK>(m2, ps, z0 - 2, x, nz, nx);
    load_row<V, MASK>(m1, ps, z0 - 1, x, nz, nx);
    load_row<V, MASK>(c, ps, z0, x, nz, nx);
    load_row<V, MASK>(p1, ps, z0 + 1, x, nz, nx);
    load_row<V, MASK>(p2, ps, z0 + 2, x, nz, nx);
    load_cells<V, MASK>(pv, vv, sv, pps, v2dt2, sponge, z0, x, nz, nx);
#pragma unroll 1
    for (int i = 0; i < rows; ++i) {
        const int z = z0 + i;
        float np2[V], npv[V], nvv[V], nsv[V];
        if (i + 1 < rows) {
            load_row<V, MASK>(np2, ps, z + 3, x, nz, nx);
            load_cells<V, MASK>(npv, nvv, nsv, pps, v2dt2, sponge, z + 1,
                                x, nz, nx);
        }
        float e[V + 4];
        neighbours<V>(e, c, ps + (size_t)z * nx, !MASK || z < nz, x, nx,
                      sl, seg);
        float pn[V], pd[V];
#pragma unroll
        for (int j = 0; j < V; ++j) {
            const float ce = c[j];
            float lap = TWO_C0 * ce;
            lap = lap + C1 * (((m1[j] + p1[j]) + e[j + 1]) + e[j + 3]);
            lap = lap + C2 * (((m2[j] + p2[j]) + e[j]) + e[j + 4]);
            pn[j] = ((2.f * ce - pv[j]) + vv[j] * lap) * sv[j];
            pd[j] = ce * sv[j];
        }
        if (!MASK || (z < nz && x < nx)) {
            const size_t g = (size_t)z * nx + x;
            store<V>(pno + g, pn);
            store<V>(pdo + g, pd);
        }
#pragma unroll
        for (int j = 0; j < V; ++j) {
            m2[j] = m1[j]; m1[j] = c[j]; c[j] = p1[j]; p1[j] = p2[j];
            p2[j] = np2[j]; pv[j] = npv[j]; vv[j] = nvv[j]; sv[j] = nsv[j];
        }
    }
}

// Block b: shot b % ns of tile b / ns (tiles x fastest).  Thread: lane
// `col` of `lanes` across (V columns each), strip `grp` of `rows` rows
// down.
template <int V>
__global__ void __launch_bounds__(max_threads<V>(), min_ctas<V>())
wave_step_kernel(
    const float* __restrict__ p, const float* __restrict__ pp,
    const float* __restrict__ v2dt2, const float* __restrict__ sponge,
    float* __restrict__ p_next, float* __restrict__ p_damped,
    int ns, int nz, int nx, int tz, int tx, int rows, int lanes,
    int tiles_x)
{
    const int b = blockIdx.x;
    const int t = b / ns;
    const int col = threadIdx.x % lanes;
    const int grp = threadIdx.x / lanes;
    const int seg = lanes < 32 ? lanes : 32;
    const int sl = col % seg;
    const int x = (t % tiles_x) * tx + col * V;
    const int z0 = (t / tiles_x) * tz + grp * rows;
    const int xend = x + (seg - sl) * V;          // past the segment
    const bool edge = z0 < HALO || z0 + rows + HALO > nz || xend > nx;
    const bool masked = __any_sync(FULL, edge);
    const size_t o = (size_t)(b % ns) * nz * nx;
    if (masked)
        strip<V, true>(p + o, pp + o, v2dt2, sponge, p_next + o,
                       p_damped + o, nz, nx, z0, rows, x, sl, seg);
    else
        strip<V, false>(p + o, pp + o, v2dt2, sponge, p_next + o,
                        p_damped + o, nz, nx, z0, rows, x, sl, seg);
}

template <int V>
cudaError_t launch(const float* p, const float* pp, const float* v2dt2,
                   const float* sponge, float* p_next, float* p_damped,
                   int ns, int nz, int nx, int tz, int tx, int rows,
                   cudaStream_t stream)
{
    const int lanes = tx / V;
    const int tiles_x = (nx + tx - 1) / tx;
    const long long blocks = (long long)((nz + tz - 1) / tz) * tiles_x * ns;
    const int threads = lanes * (tz / rows);
    wave_step_kernel<V><<<(unsigned)blocks, threads, 0, stream>>>(
        p, pp, v2dt2, sponge, p_next, p_damped, ns, nz, nx, tz, tx, rows,
        lanes, tiles_x);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
// The wrapper (kernel.py::step_launch) picks a tile (tz, tx), V = vec,
// R = rows that the kernel takes: tx = lanes * vec,
// lanes 8 or 16 or a multiple of 32, tz a multiple of rows, at most
// 1024 / vec threads, a whole number of warps.
int wave_step_shots_launch(
    const float* p, const float* pp, const float* v2dt2, const float* sponge,
    float* p_next, float* p_damped, int ns, int nz, int nx, int tz, int tx,
    int vec, int rows, void* stream)
{
    if (vec < 1 || tx % vec || rows < 1 || tz % rows)
        return (int)cudaErrorInvalidValue;
    const int lanes = tx / vec;
    const int threads = lanes * (tz / rows);
    if (!(lanes == 8 || lanes == 16 || lanes % 32 == 0)
        || threads % 32 || threads > 1024 / vec)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    switch (vec) {
    case 4:
        return (int)launch<4>(p, pp, v2dt2, sponge, p_next, p_damped, ns,
                              nz, nx, tz, tx, rows, st);
    case 2:
        return (int)launch<2>(p, pp, v2dt2, sponge, p_next, p_damped, ns,
                              nz, nx, tz, tx, rows, st);
    case 1:
        return (int)launch<1>(p, pp, v2dt2, sponge, p_next, p_damped, ns,
                              nz, nx, tz, tx, rows, st);
    default:
        return (int)cudaErrorInvalidValue;
    }
}

const char* wave_step_error_string(int err)
{
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
