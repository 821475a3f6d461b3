// Farthest-point sampling on Hopper (sm_90a).
//
// Replaces the TPU kernel slide_tpu/ops/pallas/fps.py::fps_pallas (kernel body
// _fps_kernel): for each cloud, K-1 rounds of {distance of every point to the
// last pick, running minimum, first-max argmax with ties to the lowest index};
// the first `num_forced` picks are forced to 0..num_forced-1 and every row has
// its own start index.  Distances run over all D channels, the definition of
// the plain version (slide_tpu_torch/ops/fps.py::fps_plain); at D=3 that is
// the TPU kernel's xyz[..., :3].
//
// What bounds it on this card: neither bytes (the cloud is read once) nor
// arithmetic (9 flops per point per round), but the serial chain of K rounds,
// each ending in one block-wide argmax and two __syncthreads.  Design:
//   - one block per cloud, up to 1024 threads; thread t owns points
//     t, t + blockDim, ... and keeps their running minima in registers
//     (PPT of them, a template parameter: 4 at N=4096);
//   - the cloud sits in shared memory, channel-major (D x N), so a round reads
//     no device memory at all;
//   - argmax: per-thread scan, warp shuffles on the key (dist, -index), one
//     32-entry shared-memory pass across warps, winner broadcast through
//     shared memory;
//   - every __syncthreads sits in control flow that is the same for all
//     threads of the block.
// Indices must equal the plain version's exactly, so each distance is
// ((dx*dx + dy*dy) + dz*dz) with round-to-nearest intrinsics: no FMA
// contraction, the same rounding as the separate PyTorch ops.

#include <cuda_runtime.h>
#include <climits>
#include <cmath>

namespace {

constexpr int kMaxThreads = 1024;

__device__ __forceinline__ void keep_max(float& d, int& i, float od, int oi) {
    if (od > d || (od == d && oi < i)) {
        d = od;
        i = oi;
    }
}

template <int PPT>
__global__ void __launch_bounds__(kMaxThreads)
fps_kernel(const float* __restrict__ xyz, const int* __restrict__ start,
           int* __restrict__ out, int N, int D, int K, int num_forced) {
    extern __shared__ float pts[];  // D x N, channel-major
    __shared__ float warp_d[32];
    __shared__ int warp_i[32];
    __shared__ int picked;

    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int nwarps = blockDim.x >> 5;

    const float* src = xyz + static_cast<size_t>(b) * N * D;
    for (int j = tid; j < N * D; j += blockDim.x) {
        const int p = j / D;
        pts[(j - p * D) * N + p] = src[j];
    }
    float mind[PPT];
#pragma unroll
    for (int q = 0; q < PPT; ++q) mind[q] = INFINITY;

    int* row = out + static_cast<size_t>(b) * K;
    int last = start[b];
    if (tid == 0) row[0] = last;
    __syncthreads();

    for (int i = 1; i < K; ++i) {
        float best_d = -1.0f;
        int best_i = INT_MAX;
#pragma unroll
        for (int q = 0; q < PPT; ++q) {
            const int j = tid + q * blockDim.x;
            if (j < N) {
                float acc = 0.0f;
                for (int c = 0; c < D; ++c) {
                    const float diff = __fsub_rn(pts[c * N + j], pts[c * N + last]);
                    const float sq = __fmul_rn(diff, diff);
                    acc = c == 0 ? sq : __fadd_rn(acc, sq);
                }
                const float m = fminf(mind[q], acc);
                mind[q] = m;
                if (m > best_d) {  // j grows with q: strict > keeps the lowest index
                    best_d = m;
                    best_i = j;
                }
            }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            const float od = __shfl_down_sync(0xffffffffu, best_d, off);
            const int oi = __shfl_down_sync(0xffffffffu, best_i, off);
            keep_max(best_d, best_i, od, oi);
        }
        if (lane == 0) {
            warp_d[warp] = best_d;
            warp_i[warp] = best_i;
        }
        __syncthreads();
        if (warp == 0) {
            best_d = lane < nwarps ? warp_d[lane] : -1.0f;
            best_i = lane < nwarps ? warp_i[lane] : INT_MAX;
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
                const float od = __shfl_down_sync(0xffffffffu, best_d, off);
                const int oi = __shfl_down_sync(0xffffffffu, best_i, off);
                keep_max(best_d, best_i, od, oi);
            }
            if (lane == 0) picked = i < num_forced ? i : best_i;
        }
        __syncthreads();
        last = picked;
        if (tid == 0) row[i] = last;
    }
}

template <int PPT>
cudaError_t launch(const float* xyz, const int* start, int* out, int B, int N,
                   int D, int K, int num_forced, int threads, size_t smem,
                   cudaStream_t stream) {
    // dynamic and static shared memory together may pass the default 48 KB
    // (at N=4096, D=3 the cloud alone is 48 KB), so always raise the limit
    const cudaError_t e = cudaFuncSetAttribute(
        fps_kernel<PPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    fps_kernel<PPT><<<B, threads, smem, stream>>>(xyz, start, out, N, D, K,
                                                 num_forced);
    return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  All pointers are
// device pointers: xyz (B, N, D) f32 contiguous, start (B,) i32, out (B, K) i32.
extern "C" int slide_fps(const float* xyz, const int* start, int* out, int B,
                         int N, int D, int K, int num_forced, int device,
                         void* stream) {
    if (B <= 0 || N <= 0 || D <= 0 || K <= 0 || K > N)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int threads = N >= kMaxThreads ? kMaxThreads : ((N + 31) / 32) * 32;
    const int ppt = (N + threads - 1) / threads;
    const size_t smem = static_cast<size_t>(D) * N * sizeof(float);
    auto s = static_cast<cudaStream_t>(stream);
    if (ppt <= 1) e = launch<1>(xyz, start, out, B, N, D, K, num_forced, threads, smem, s);
    else if (ppt <= 2) e = launch<2>(xyz, start, out, B, N, D, K, num_forced, threads, smem, s);
    else if (ppt <= 4) e = launch<4>(xyz, start, out, B, N, D, K, num_forced, threads, smem, s);
    else if (ppt <= 8) e = launch<8>(xyz, start, out, B, N, D, K, num_forced, threads, smem, s);
    else if (ppt <= 16) e = launch<16>(xyz, start, out, B, N, D, K, num_forced, threads, smem, s);
    else e = cudaErrorInvalidValue;
    return static_cast<int>(e);
}

extern "C" const char* slide_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
