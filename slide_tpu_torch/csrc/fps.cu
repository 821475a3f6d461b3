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
// each ending in one block-wide argmax.  Design (one barrier a round):
//   - one block per cloud, `threads` threads (the wrapper's choice per N);
//     thread t owns points t, t + threads, ... and keeps their running minima
//     in registers (PPT of them, a template parameter), and at D = 3 (up to
//     8 points a thread) their coordinates too; the cloud also sits in shared
//     memory, channel-major (D x N), where a round reads the pick's
//     coordinates (and otherwise the owned points' ones);
//   - argmax as the TPU kernel takes it: the largest distance, then the
//     lowest index among the points that hold it.  In a warp that is two
//     redux.sync instructions: the max of the distances' bits (non-negative
//     floats order as unsigned ints), then the min of the indices of the
//     lanes that hold it (the others give INT_MAX);
//   - across warps: each warp's lane 0 writes its pair into a slot of a table
//     double-buffered by the round's parity; one __syncthreads; then every
//     warp reads all the slots and reduces them itself with the same two
//     instructions, so there is no second barrier and no broadcast.  A warp
//     may run a round ahead and write the other buffer; it cannot run two
//     ahead, since that needs every warp past the next barrier;
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
constexpr int kMaxPpt = 32;

// The most threads a block may have with PPT points a thread (PPT minima in
// registers, and with kRegs 3 PPT coordinates).
template <int PPT>
__host__ __device__ constexpr int max_threads() {
    return PPT <= 16 ? 1024 : 512;
}

// The (distance bits, index) pair that wins over the warp: the largest
// distance, ties to the lowest index.  Lanes with no point give (0, INT_MAX).
__device__ __forceinline__ int warp_argmax(unsigned bits, int idx) {
    const unsigned top = __reduce_max_sync(0xffffffffu, bits);
    return __reduce_min_sync(0xffffffffu, bits == top ? idx : INT_MAX);
}

// kRegs: D = 3 and the owned points' coordinates in registers (PPT <= 8);
// else they are read from shared memory each round.
template <int PPT, bool kRegs>
__global__ void __launch_bounds__(max_threads<PPT>())
fps_kernel(const float* __restrict__ xyz, const int* __restrict__ start,
           int* __restrict__ out, int N, int D, int K, int num_forced) {
    extern __shared__ float pts[];  // D x N, channel-major
    __shared__ unsigned slot_d[2][32];
    __shared__ int slot_i[2][32];

    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int nwarps = blockDim.x >> 5;
    const int nt = blockDim.x;

    const float* src = xyz + static_cast<size_t>(b) * N * D;
    for (int j = tid; j < N * D; j += nt) {
        const int p = j / D;
        pts[(j - p * D) * N + p] = src[j];
    }
    float mind[PPT], px[kRegs ? PPT : 1], py[kRegs ? PPT : 1], pz[kRegs ? PPT : 1];
#pragma unroll
    for (int q = 0; q < PPT; ++q) {
        mind[q] = INFINITY;
        if (kRegs) {
            const int j = min(tid + q * nt, N - 1);
            px[q] = src[3 * j];
            py[q] = src[3 * j + 1];
            pz[q] = src[3 * j + 2];
        }
    }

    int* row = out + static_cast<size_t>(b) * K;
    int last = start[b];
    if (tid == 0) row[0] = last;
    __syncthreads();

    for (int i = 1; i < K; ++i) {
        float best_d = -1.0f;
        int best_i = INT_MAX;
        if (kRegs) {
            const float lx = pts[last], ly = pts[N + last], lz = pts[2 * N + last];
#pragma unroll
            for (int q = 0; q < PPT; ++q) {
                const int j = tid + q * nt;
                const float dx = __fsub_rn(px[q], lx);
                const float dy = __fsub_rn(py[q], ly);
                const float dz = __fsub_rn(pz[q], lz);
                const float acc = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                            __fmul_rn(dz, dz));
                const float m = fminf(mind[q], acc);
                mind[q] = m;
                // j grows with q: strict > keeps the lowest index
                if (j < N && m > best_d) {
                    best_d = m;
                    best_i = j;
                }
            }
        } else {
#pragma unroll
            for (int q = 0; q < PPT; ++q) {
                const int j = tid + q * nt;
                if (j < N) {
                    float acc = 0.0f;
                    for (int c = 0; c < D; ++c) {
                        const float diff = __fsub_rn(pts[c * N + j], pts[c * N + last]);
                        const float sq = __fmul_rn(diff, diff);
                        acc = c == 0 ? sq : __fadd_rn(acc, sq);
                    }
                    const float m = fminf(mind[q], acc);
                    mind[q] = m;
                    if (m > best_d) {
                        best_d = m;
                        best_i = j;
                    }
                }
            }
        }
        const unsigned bits = best_i == INT_MAX ? 0u : __float_as_uint(best_d);
        const unsigned top = __reduce_max_sync(0xffffffffu, bits);
        const int wi = __reduce_min_sync(0xffffffffu, bits == top ? best_i : INT_MAX);
        const int par = i & 1;
        if (lane == 0) {
            slot_d[par][warp] = top;
            slot_i[par][warp] = wi;
        }
        __syncthreads();
        const unsigned od = lane < nwarps ? slot_d[par][lane] : 0u;
        const int oi = lane < nwarps ? slot_i[par][lane] : INT_MAX;
        const int pick = warp_argmax(od, oi);
        last = i < num_forced ? i : pick;
        if (tid == 0) row[i] = last;
    }
}

template <int PPT>
cudaError_t launch(const float* xyz, const int* start, int* out, int B, int N,
                   int D, int K, int num_forced, int threads, size_t smem,
                   cudaStream_t stream) {
    if (threads > max_threads<PPT>()) return cudaErrorInvalidValue;
    const auto kernel = D == 3 && PPT <= 8 ? fps_kernel<PPT, true> : fps_kernel<PPT, false>;
    // dynamic and static shared memory together may pass the default 48 KB
    // (at N=4096, D=3 the cloud alone is 48 KB), so always raise the limit
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    kernel<<<B, threads, smem, stream>>>(xyz, start, out, N, D, K, num_forced);
    return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  All pointers are
// device pointers: xyz (B, N, D) f32 contiguous, start (B,) i32, out (B, K) i32.
// threads: the block's threads (the wrapper's `threads_for(N)`), a multiple
// of 32 up to 1024 that leaves at most 32 points a thread.
extern "C" int slide_fps(const float* xyz, const int* start, int* out, int B,
                         int N, int D, int K, int num_forced, int threads, int device,
                         void* stream) {
    if (B <= 0 || N <= 0 || D <= 0 || K <= 0 || K > N || threads < 32 ||
        threads > kMaxThreads || threads % 32)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int ppt = (N + threads - 1) / threads;
    const size_t smem = static_cast<size_t>(D) * N * sizeof(float);
    auto s = static_cast<cudaStream_t>(stream);
    if (ppt <= 1) e = launch<1>(xyz, start, out, B, N, D, K, num_forced, threads, smem, s);
    else if (ppt <= 2) e = launch<2>(xyz, start, out, B, N, D, K, num_forced, threads, smem, s);
    else if (ppt <= 4) e = launch<4>(xyz, start, out, B, N, D, K, num_forced, threads, smem, s);
    else if (ppt <= 8) e = launch<8>(xyz, start, out, B, N, D, K, num_forced, threads, smem, s);
    else if (ppt <= 16) e = launch<16>(xyz, start, out, B, N, D, K, num_forced, threads, smem, s);
    else if (ppt <= kMaxPpt) e = launch<32>(xyz, start, out, B, N, D, K, num_forced, threads, smem, s);
    else e = cudaErrorInvalidValue;
    return static_cast<int>(e);
}

extern "C" const char* slide_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
