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
// Design (a simple kernel that is right; speed comes later):
//   * One CTA of 256 threads per row (any N, any d that fits the shared
//     memory: d <= 58,000 or so, far above 8192).  Threads stride the
//     row, so the loads of a warp are contiguous.
//   * Pass 1 reads x and res once, forms h in f32, writes h in x's
//     dtype, keeps the f32 h in shared memory and sums h^2 in f32; the
//     sum reduces with warp shuffles, then across the 8 warps in shared
//     memory.
//   * Pass 2 normalises the f32 h from shared memory: (h * r) * scale,
//     in the plain version's order, with r = rsqrtf(ms + eps) (the
//     same rsqrtf PyTorch's CUDA rsqrt uses).  Only the order of the
//     sum differs from the plain version.
//
// Bound: memory.  The least traffic reads x and res and writes out and
// h once, plus the scale: 4*N*d*sizeof(T) + 4*d bytes, against ~5 flops
// per element — far below any ridge.  At Yi-6B's prefill block
// (2048 x 4096, bf16) that is 67 MB, 20 us at 3.35 TB/s.
//
// Why CUDA and not Triton: Triton would serve this reduction equally
// well, but CUDA keeps the port's one build path (nvcc into a plain C
// library loaded with ctypes, kernels/build.py) for every kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v)
{
    return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v)
{
    return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v)
{
    return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
rmsnorm_residual_kernel(
    const T* __restrict__ x, const T* __restrict__ res,
    const float* __restrict__ scale, T* __restrict__ out,
    T* __restrict__ h_out, int d, float eps)
{
    extern __shared__ float hs[];            // (d,) f32 h of this row
    __shared__ float partial[THREADS / 32];
    const size_t base = (size_t)blockIdx.x * d;
    const T* xr = x + base;
    const T* rr = res + base;

    float acc = 0.f;
    for (int c = threadIdx.x; c < d; c += THREADS) {
        const float h = to_f32(xr[c]) + to_f32(rr[c]);
        hs[c] = h;
        h_out[base + c] = from_f32<T>(h);
        acc = acc + h * h;
    }
    for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (lane == 0) partial[warp] = acc;
    __syncthreads();
    if (warp == 0) {
        float s = lane < THREADS / 32 ? partial[lane] : 0.f;
        for (int off = 16; off > 0; off >>= 1)
            s += __shfl_xor_sync(0xffffffffu, s, off);
        if (lane == 0) partial[0] = s;
    }
    __syncthreads();
    const float ms = partial[0] / (float)d;
    const float r = rsqrtf(ms + eps);
    for (int c = threadIdx.x; c < d; c += THREADS)
        out[base + c] = from_f32<T>(hs[c] * r * scale[c]);
}

// dynamic shared memory of one CTA: the row's f32 h
// (kernel.py::rmsnorm_smem_bytes)
size_t rmsnorm_smem_bytes(int d)
{
    return (size_t)d * sizeof(float);
}

template <typename T>
int launch(const void* x, const void* res, const float* scale, void* out,
           void* h, int n, int d, float eps, cudaStream_t stream)
{
    static size_t smem_allowed = 48 * 1024;
    const size_t smem = rmsnorm_smem_bytes(d);
    if (smem > smem_allowed) {
        cudaError_t e = cudaFuncSetAttribute(
            rmsnorm_residual_kernel<T>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
        smem_allowed = smem;
    }
    rmsnorm_residual_kernel<T><<<n, THREADS, smem, stream>>>(
        (const T*)x, (const T*)res, scale, (T*)out, (T*)h, d, eps);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = bf16.  Launches on `stream`; returns the
// cudaError_t of the launch (0 = ok).
int rmsnorm_residual_launch(
    const void* x, const void* res, const float* scale, void* out, void* h,
    int n, int d, float eps, int dtype, void* stream)
{
    if (n <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0)
        return launch<float>(x, res, scale, out, h, n, d, eps, s);
    if (dtype == 1)
        return launch<__nv_bfloat16>(x, res, scale, out, h, n, d, eps, s);
    return (int)cudaErrorInvalidValue;
}

// The dynamic shared memory rmsnorm_residual_launch requests at row
// width d.
size_t rmsnorm_smem_query(int d)
{
    return rmsnorm_smem_bytes(d);
}

const char* rmsnorm_residual_error_string(int err)
{
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
