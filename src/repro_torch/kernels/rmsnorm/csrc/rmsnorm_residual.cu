// Fused residual-add + RMSNorm over the rows of an (N, d) activation —
// the Hopper kernel at every residual -> norm seam of the port's decoder
// (models/transformer.py), in prefill (N = B*S) and decode (N = B).
//
// Replaces the TPU kernel rmsnorm_residual_pallas of the JAX package
// (src/repro/kernels/rmsnorm/kernel.py, body _rmsnorm_kernel).
//
// On every row n:
//   h[n]   = x[n] + res[n]                       (in f32)
//   out[n] = h[n] * rsqrt(mean(h[n]^2) + eps) * scale
// returning (out, h) in x's dtype (f32 or bf16); scale is f32.
//
// Bound: memory.  The least traffic reads x and res and writes out and
// h once, plus the scale: 4*N*d*sizeof(T) + 4*d bytes, against ~5 flops
// per element — far below any ridge.  At Yi-6B's prefill block
// (2048 x 4096, bf16) that is 67 MB, 20 us at 3.35 TB/s; a decode row
// block (4 x 4096) is one DRAM round trip and a launch.
//
// Design: one pass, the row in registers.
//   * A row belongs to `tpr` threads (whole warps) of one CTA; a CTA
//     holds `rows` rows (blockDim = (tpr, rows)), so narrow rows still
//     fill an SM.  kernel.py::launch_shape picks tpr, rows and NV from
//     the width; the launch checks them.
//   * Each thread owns NV accesses of VEC elements: 16 bytes (8 bf16 or
//     4 f32) where d is a multiple of VEC and every pointer is 16-byte
//     aligned, else one element (the scalar path: the same kernel at
//     VEC = 1).  Consecutive threads own consecutive accesses, so a warp
//     reads 512 contiguous bytes an instruction.
//   * Every load is issued before any arithmetic: x, res and the
//     matching f32 scale.  h is formed in f32 registers and stored at
//     once; h^2 is summed in f32, reduced by warp shuffles, then across
//     the row's warps through one word of shared memory a warp (no
//     barrier where a row is one warp).  out = (h * r) * scale with
//     r = rsqrtf(ms + eps), in the plain version's order, from the same
//     registers.  No copy of the row in shared memory, no second pass:
//     each input byte is read once and each output byte written once.
//   * Only the order of the sum of squares differs from the plain
//     version; h is one f32 add and one rounding, bitwise equal.
//   * A decode row split over a thread-block cluster, its partial sums
//     exchanged through distributed shared memory, measured slower than
//     one CTA a row (PERF.md): the two cluster barriers cost more
//     than the spread loads save.
//
// Why CUDA and not Triton: Triton would serve this reduction equally
// well, but CUDA keeps the port's one build path (nvcc into a plain C
// library loaded with ctypes, kernels/build.py) for every kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int WARP = 32;
// threads a CTA may hold (kernel.py::MAX_THREADS): 128 registers each
constexpr int MAX_THREADS = 512;

// VEC elements of T as one access: a 16-byte word, or one element
template <typename T, int VEC> struct Pack;

template <> struct Pack<float, 4> {
    using Raw = uint4;
    static __device__ __forceinline__ Raw zero()
    {
        return make_uint4(0u, 0u, 0u, 0u);
    }
    static __device__ __forceinline__ void unpack(const Raw& r, float* f)
    {
        f[0] = __uint_as_float(r.x);
        f[1] = __uint_as_float(r.y);
        f[2] = __uint_as_float(r.z);
        f[3] = __uint_as_float(r.w);
    }
    static __device__ __forceinline__ Raw pack(const float* f)
    {
        return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                          __float_as_uint(f[2]), __float_as_uint(f[3]));
    }
};

template <> struct Pack<float, 1> {
    using Raw = float;
    static __device__ __forceinline__ Raw zero() { return 0.f; }
    static __device__ __forceinline__ void unpack(const Raw& r, float* f)
    {
        f[0] = r;
    }
    static __device__ __forceinline__ Raw pack(const float* f)
    {
        return f[0];
    }
};

// two bf16 (round to nearest even) in one word, the first in the low half
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi)
{
    return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo))
        | ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

template <> struct Pack<__nv_bfloat16, 8> {
    using Raw = uint4;
    static __device__ __forceinline__ Raw zero()
    {
        return make_uint4(0u, 0u, 0u, 0u);
    }
    static __device__ __forceinline__ void unpack(const Raw& r, float* f)
    {
        const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            f[2 * i] = __uint_as_float(w[i] << 16);
            f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
        }
    }
    static __device__ __forceinline__ Raw pack(const float* f)
    {
        return make_uint4(bf16x2(f[0], f[1]), bf16x2(f[2], f[3]),
                          bf16x2(f[4], f[5]), bf16x2(f[6], f[7]));
    }
};

template <> struct Pack<__nv_bfloat16, 1> {
    using Raw = __nv_bfloat16;
    static __device__ __forceinline__ Raw zero()
    {
        return __float2bfloat16_rn(0.f);
    }
    static __device__ __forceinline__ void unpack(const Raw& r, float* f)
    {
        f[0] = __bfloat162float(r);
    }
    static __device__ __forceinline__ Raw pack(const float* f)
    {
        return __float2bfloat16_rn(f[0]);
    }
};

// the VEC f32 scales of access j: float4 words, or one float
template <int VEC>
__device__ __forceinline__ void load_scale(
    const float* __restrict__ scale, int j, bool ok, float* s)
{
    if constexpr (VEC % 4 == 0) {
        const float4* sv = reinterpret_cast<const float4*>(scale)
            + (size_t)j * (VEC / 4);
#pragma unroll
        for (int q = 0; q < VEC / 4; ++q) {
            const float4 t = ok ? sv[q] : make_float4(0.f, 0.f, 0.f, 0.f);
            s[4 * q] = t.x;
            s[4 * q + 1] = t.y;
            s[4 * q + 2] = t.z;
            s[4 * q + 3] = t.w;
        }
    } else {
        s[0] = ok ? scale[j] : 0.f;
    }
}

template <typename T, int VEC, int NV>
__global__ void __launch_bounds__(MAX_THREADS)
rmsnorm_residual_kernel(
    const T* __restrict__ x, const T* __restrict__ res,
    const float* __restrict__ scale, T* __restrict__ out,
    T* __restrict__ h_out, int n, int d, float eps)
{
    using P = Pack<T, VEC>;
    using Raw = typename P::Raw;
    // per row of the CTA: its warps' sums
    extern __shared__ float red[];
    const int tpr = blockDim.x;
    const int warps = tpr / WARP;
    const int row = blockIdx.x * blockDim.y + threadIdx.y;
    const bool live = row < n;
    const int nvec = d / VEC;
    const int tx = threadIdx.x;
    const size_t base = (size_t)(live ? row : 0) * nvec;
    const Raw* xv = reinterpret_cast<const Raw*>(x) + base;
    const Raw* rv = reinterpret_cast<const Raw*>(res) + base;
    Raw* ov = reinterpret_cast<Raw*>(out) + base;
    Raw* hv = reinterpret_cast<Raw*>(h_out) + base;

    // every load of the thread, before any arithmetic
    Raw xr[NV], rr[NV];
    float s[NV][VEC];
#pragma unroll
    for (int k = 0; k < NV; ++k) {
        const int j = tx + k * tpr;
        const bool ok = live && j < nvec;
        xr[k] = ok ? xv[j] : P::zero();
        rr[k] = ok ? rv[j] : P::zero();
        load_scale<VEC>(scale, j, ok, s[k]);
    }

    float h[NV][VEC];
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
        float a[VEC], b[VEC];
        P::unpack(xr[k], a);
        P::unpack(rr[k], b);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
            h[k][i] = a[i] + b[i];
            acc = acc + h[k][i] * h[k][i];
        }
        const int j = tx + k * tpr;
        if (live && j < nvec) hv[j] = P::pack(h[k]);
    }

    // the row's sum: the warp, then the row's warps
#pragma unroll
    for (int off = WARP / 2; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (warps > 1) {
        float* part = red + threadIdx.y * warps;
        if ((tx & (WARP - 1)) == 0) part[tx / WARP] = acc;
        __syncthreads();
        acc = 0.f;
        for (int w = 0; w < warps; ++w) acc = acc + part[w];
    }

    const float r = rsqrtf(acc / (float)d + eps);
#pragma unroll
    for (int k = 0; k < NV; ++k) {
        const int j = tx + k * tpr;
        if (live && j < nvec) {
            float o[VEC];
#pragma unroll
            for (int i = 0; i < VEC; ++i) o[i] = h[k][i] * r * s[k][i];
            ov[j] = P::pack(o);
        }
    }
}

// dynamic shared memory of one CTA: an f32 sum for each warp of each of
// its rows (kernel.py::rmsnorm_smem_bytes)
size_t rmsnorm_smem_bytes(int rows, int warps)
{
    return (size_t)rows * warps * sizeof(float);
}

struct Args {
    const void* x;
    const void* res;
    const float* scale;
    void* out;
    void* h;
    int n, d;
    float eps;
    int vec, nv, tpr, rows;
    cudaStream_t stream;
};

template <typename T, int VEC, int NV>
int launch(const Args& a)
{
    const size_t smem = rmsnorm_smem_bytes(a.rows, a.tpr / WARP);
    const unsigned grid = (unsigned)((a.n + a.rows - 1) / a.rows);
    const dim3 block((unsigned)a.tpr, (unsigned)a.rows);
    rmsnorm_residual_kernel<T, VEC, NV><<<grid, block, smem, a.stream>>>(
        (const T*)a.x, (const T*)a.res, a.scale, (T*)a.out, (T*)a.h, a.n,
        a.d, a.eps);
    return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Args& a)
{
    constexpr int V = 16 / sizeof(T);
    if (a.vec == V) {
        switch (a.nv) {
        case 1: return launch<T, V, 1>(a);
        case 2: return launch<T, V, 2>(a);
        case 4: return launch<T, V, 4>(a);
        case 8:
            // f32 rows above 8192 (a bf16 row of MAX_D takes 4)
            if constexpr (sizeof(T) == 4) return launch<T, V, 8>(a);
            return (int)cudaErrorInvalidValue;
        default: return (int)cudaErrorInvalidValue;
        }
    }
    if (a.vec != 1) return (int)cudaErrorInvalidValue;
    switch (a.nv) {
    case 1: return launch<T, 1, 1>(a);
    case 2: return launch<T, 1, 2>(a);
    case 4: return launch<T, 1, 4>(a);
    case 8: return launch<T, 1, 8>(a);
    case 16: return launch<T, 1, 16>(a);
    case 32: return launch<T, 1, 32>(a);
    default: return (int)cudaErrorInvalidValue;
    }
}

bool aligned16(const void* p)
{
    return ((uintptr_t)p & 15u) == 0;
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = bf16.  (vec, nv, tpr, rows) is the launch shape
// (kernel.py::launch_shape): elements an access, accesses a thread,
// threads a row, rows a CTA.  Returns cudaErrorInvalidValue on a shape
// the kernel cannot run, else the cudaError_t of the launch on `stream`
// (0 = ok).
int rmsnorm_residual_launch(
    const void* x, const void* res, const float* scale, void* out, void* h,
    int n, int d, float eps, int dtype, int vec, int nv, int tpr, int rows,
    void* stream)
{
    if (n <= 0 || d <= 0 || vec <= 0 || nv <= 0 || rows <= 0
        || tpr < WARP || tpr % WARP != 0
        || (long long)tpr * rows > MAX_THREADS || d % vec != 0
        || (long long)nv * tpr < d / vec)           // the threads hold the row
        return (int)cudaErrorInvalidValue;
    if (vec > 1 && !(aligned16(x) && aligned16(res) && aligned16(scale)
                     && aligned16(out) && aligned16(h)))
        return (int)cudaErrorInvalidValue;
    const Args a{x, res, scale, out, h, n, d, eps, vec, nv, tpr, rows,
                 (cudaStream_t)stream};
    if (dtype == 0) return dispatch<float>(a);
    if (dtype == 1) return dispatch<__nv_bfloat16>(a);
    return (int)cudaErrorInvalidValue;
}

// The dynamic shared memory rmsnorm_residual_launch requests for a CTA
// of `rows` rows of `warps` warps.
size_t rmsnorm_smem_query(int rows, int warps)
{
    return rmsnorm_smem_bytes(rows, warps);
}

const char* rmsnorm_residual_error_string(int err)
{
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
