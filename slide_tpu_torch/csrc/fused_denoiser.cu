// K1: the whole ConditionalPointNet2 forward (the fused denoiser) on Hopper
// (sm_90a), one launch per forward.  Its layer table, `Spec`, is in
// fused_spec.cuh (shared with K2, fused_denoiser_bwd.cu).
//
// Replaces the TPU kernel slide_tpu/models/fused_denoiser.py::_pallas_forward
// (body _forward_tile): per cloud, pairwise squared distances, kNN, the SA
// tower (grouping, InjectionMLP, attention pool), the KnnFP tower and the
// head.  The plain version is slide_tpu_torch/models/fused_denoiser.py::
// fused_forward_plain; the layer table below is its `TABLE`, field for field.
//
// What bounds it on this card: operations.  The weight products of one
// latent-net forward are ~1.06 GFLOP per cloud against ~0.9 MB of weights
// (14.7 MB per net, read by every cloud), far above the card's ~20 flops per
// byte in fp32; the kp net is ~77 MFLOP.  Everything is fp32 FFMA (no tensor
// cores: no TF32, so the result stays the plain version's to fp32 rounding).
// Design, simple first:
//   - one cluster of 8 blocks (256 threads each) per cloud.  A cloud's
//     GroupNorm statistics are reductions over all its rows, so the blocks of
//     a cloud must meet after every step: a cluster barrier does that, with
//     no cross-cluster synchronisation.  At batch 16 that is 128 blocks, two
//     per SM (the kernel is held to 128 registers so that two fit);
//   - the blocks walk the layer table (offsets and widths read at run time),
//     so the kp and latent nets share one compiled kernel;
//   - every 1x1 conv is a tiled product: the cluster's blocks take turns over
//     the 64 x 64 output tiles, 4 x 4 outputs per thread in registers, depth
//     16 through shared memory, the next depth slice prefetched into
//     registers while this one is multiplied; bias, ReLU and the residual sum
//     ride in its epilogue;
//   - activations (up to 256 slot rows x 521 channels per tensor) live in a
//     per-cloud scratch in device memory, small enough to stay in L2: five
//     row buffers, the level features, the GroupNorm statistics and the
//     t / class vector.  Blocks write it with plain stores and read it with
//     ld.global.cg (past L1), after a cluster barrier (release / acquire at
//     cluster scope).  Weights are read from device memory / L2;
//   - GroupNorm: one warp of the cluster per group sums x and x^2, a barrier,
//     then the cluster normalises, applies ReLU and adds the t / class vector;
//   - every block keeps its own copy of the points, the distances, the kNN
//     picks and the embeddings in shared memory;
//   - distances and kNN picks round exactly as the plain version: each sum
//     and product is a separate round-to-nearest operation (no FMA), and the
//     K rounds of masked argmin take the lowest index on ties;
//   - every barrier (block or cluster) sits in control flow that depends only
//     on the table, the same for all threads of the cluster.
// Faster forms, for later: tensor-core products (TF32 changes the numbers),
// a thread tile larger than 4 x 4, fewer barriers by fusing GroupNorm's
// statistics into the product's epilogue, activations in distributed shared
// memory.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cmath>

#include "fused_spec.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace slide_fused;

struct alignas(16) Smem {
    float As[BK][BM + 4];   // A tile, depth-major; +4 spreads the stores over banks
    float Bs[BK][BN];
    float dist[kMaxN * kMaxN];
    int knn[kMaxN * kMaxN];
    float xyz[kMaxN * 3];
    float t4[kMaxVec];
    float cls[kMaxVec];
    float mean[kMaxGroups];
    float inv[kMaxGroups];
};

__shared__ Smem sm;

// Where one thread stands: its block's rank in the cloud's cluster and its
// index in the block; work is dealt out over the cluster's kGThreads threads.
struct Ctx {
    const float* __restrict__ w;   // packed weights
    float* stats;                  // the cloud's GroupNorm mean / inv (2 x 32)
    float* vec;                    // the cloud's injection vector (kMaxVec)
    int tid, rank;
    __device__ int gtid() const { return rank * kThreads + tid; }
};

// Every block of the cloud's cluster has finished the last step, and its
// writes to the cloud's scratch are visible (release / acquire at cluster
// scope; scratch is read with ld.global.cg, past L1).
__device__ __forceinline__ void cluster_sync() { cg::this_cluster().sync(); }

__device__ __forceinline__ float ld(const float* p) { return __ldcg(p); }

// out[r, c] (= or +=) relu?(A[r, :] . W[:, c] + bias[c]) for r < R, c < cout.
// A rows have stride lda; out rows ldo.  The cluster's blocks take turns
// over the 64 x 64 output tiles.  Ends with cluster_sync.
__device__ __noinline__ void gemm(Ctx cx, const float* A, int lda, int R,
                                  const Dense& d, float* out, int ldo,
                                  bool accumulate, bool relu) {
    const float* __restrict__ W = cx.w + d.w;
    const float* bias = d.b >= 0 ? cx.w + d.b : nullptr;
    const int K = d.cin, C = d.cout;
    const int tid = cx.tid;
    const int tx = tid & 15, ty = tid >> 4;
    const int ntn = (C + BN - 1) / BN, tiles = ((R + BM - 1) / BM) * ntn;
    for (int t = cx.rank; t < tiles; t += kCluster) {
        const int m0 = (t / ntn) * BM, n0 = (t % ntn) * BN;
        float acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
        float ra[4], rb[4];
        auto fetch = [&](int k0) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int e = tid + q * kThreads;
                const int row = e >> 4, kk = e & 15;        // A: 64 rows x 16
                const int r = m0 + row, k = k0 + kk;
                ra[q] = (r < R && k < K) ? ld(A + (size_t)r * lda + k) : 0.0f;
                const int kb = e >> 6, col = e & 63;        // W: 16 x 64 cols
                const int kw = k0 + kb, c = n0 + col;
                rb[q] = (kw < K && c < C) ? __ldg(W + (size_t)kw * C + c) : 0.0f;
            }
        };
        fetch(0);
        for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int e = tid + q * kThreads;
                sm.As[e & 15][e >> 4] = ra[q];
                sm.Bs[e >> 6][e & 63] = rb[q];
            }
            __syncthreads();
            if (k0 + BK < K) fetch(k0 + BK);
#pragma unroll
            for (int kk = 0; kk < BK; ++kk) {
                const float4 a = *reinterpret_cast<const float4*>(&sm.As[kk][ty * 4]);
                const float4 b = *reinterpret_cast<const float4*>(&sm.Bs[kk][tx * 4]);
                const float av[4] = {a.x, a.y, a.z, a.w};
                const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
            }
            __syncthreads();
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int r = m0 + ty * 4 + i;
            if (r >= R) continue;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int c = n0 + tx * 4 + j;
                if (c >= C) continue;
                float v = acc[i][j];
                if (bias) v += __ldg(bias + c);
                float* o = out + (size_t)r * ldo + c;
                if (accumulate) v = ld(o) + v;
                if (relu) v = fmaxf(v, 0.0f);
                *o = v;
            }
        }
    }
    cluster_sync();
}

// cx.vec[c] = v . W[:, c] + bias[c] for one vector v in shared memory: one
// warp of the cluster per output, its lanes splitting the depth.  Ends with
// cluster_sync.
__device__ void gemv(Ctx cx, const float* v, const Dense& d) {
    const float* __restrict__ W = cx.w + d.w;
    const int lane = cx.tid & 31;
    for (int c = cx.gtid() >> 5; c < d.cout; c += kCluster * kWarps) {
        float acc = 0.0f;
        for (int k = lane; k < d.cin; k += 32)
            acc = fmaf(v[k], __ldg(W + (size_t)k * d.cout + c), acc);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
        if (lane == 0) cx.vec[c] = d.b >= 0 ? acc + __ldg(cx.w + d.b + c) : acc;
    }
    cluster_sync();
}

// Tail GroupNorm over a cloud's R rows of C channels (rows dense), in place;
// then relu and + addv[c] if asked.  One warp of the cluster per group sums
// x and x^2; then the cluster normalises.  Ends with cluster_sync.
__device__ void group_norm(Ctx cx, float* x, int R, int C, const Norm& nd,
                           bool relu, const float* addv) {
    const int G = nd.g, cn = C - C % G, gs = cn / G;
    const int lane = cx.tid & 31;
    const int cnt = R * gs;
    for (int g = cx.gtid() >> 5; g < G; g += kCluster * kWarps) {
        float s = 0.0f, s2 = 0.0f;
        for (int e = lane; e < cnt; e += 32) {
            const int r = e / gs;
            const float v = ld(x + (size_t)r * C + g * gs + (e - r * gs));
            s += v;
            s2 = fmaf(v, v, s2);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            s += __shfl_xor_sync(0xffffffffu, s, off);
            s2 += __shfl_xor_sync(0xffffffffu, s2, off);
        }
        if (lane == 0) {
            const float mean = s / static_cast<float>(cnt);
            const float var = fmaxf(s2 / static_cast<float>(cnt) - mean * mean, 0.0f);
            cx.stats[g] = mean;
            cx.stats[kMaxGroups + g] = 1.0f / sqrtf(var + 1e-5f);
        }
    }
    cluster_sync();
    if (cx.tid < G) {
        sm.mean[cx.tid] = ld(cx.stats + cx.tid);
        sm.inv[cx.tid] = ld(cx.stats + kMaxGroups + cx.tid);
    }
    __syncthreads();
    const float* scale = cx.w + nd.s;
    const float* shift = cx.w + nd.b;
    for (int e = cx.gtid(); e < R * C; e += kGThreads) {
        const int c = e % C;
        float v = ld(x + e);
        if (c < cn) {
            const int g = c / gs;
            v = (v - sm.mean[g]) * sm.inv[g];
            v = v * __ldg(scale + c) + __ldg(shift + c);
        }
        if (relu) v = fmaxf(v, 0.0f);
        if (addv) v += ld(addv + c);
        x[e] = v;
    }
    cluster_sync();
}

// InjectionMLP on R rows of x (width conv[0].cin); layers alternate between
// A and B.  Returns the buffer holding the result (width of the last conv).
__device__ float* mlp(Ctx cx, const Mlp& m, const float* x, int R, float* A,
                      float* B) {
    const float* in = x;
    float* o = A;
    for (int l = 0; l < m.n_layers; ++l) {
        const Dense& cv = m.conv[l];
        gemm(cx, in, cv.cin, R, cv, o, cv.cout, false, false);
        const float* addv = nullptr;
        if (l == 0 && m.inject_t) {
            gemv(cx, sm.t4, m.fc_t);
            addv = cx.vec;
        }
        if (l == 1 && m.inject_c) {
            gemv(cx, sm.cls, m.fc_c);
            addv = cx.vec;
        }
        group_norm(cx, o, R, cv.cout, m.norm[l], true, addv);
        in = o;
        o = (o == A) ? B : A;
    }
    float* h = const_cast<float*>(in);
    const int c0 = m.conv[0].cin, cl = m.conv[m.n_layers - 1].cout;
    if (m.res == 2) {
        gemm(cx, x, c0, R, m.res_conv, h, cl, true, false);
    } else {
        for (int e = cx.gtid(); e < R * cl; e += kGThreads) h[e] = ld(h + e) + ld(x + e);
        cluster_sync();
    }
    return h;
}

// AttentionPool with every slot valid.  feat (n x cq), grouped and value
// (n*k rows); T, U, S are free row buffers; out (n x c_out).
__device__ void attention(Ctx cx, const Att& a, const float* feat,
                          const float* grouped, const float* value, int n, int k,
                          float* T, float* U, float* S, float* out) {
    const int R = n * k;
    const int c1 = a.feat_conv.cout, c2 = a.grouped_conv.cout, ct = c1 + c2;
    const int inter = a.w_conv_1.cout, co = a.w_conv_2.cout;
    gemm(cx, feat, a.feat_conv.cin, n, a.feat_conv, S, c1, false, true);
    for (int e = cx.gtid(); e < R * c1; e += kGThreads) {
        const int r = e / c1, c = e - r * c1;
        T[(size_t)r * ct + c] = ld(S + (r / k) * c1 + c);
    }
    gemm(cx, grouped, a.grouped_conv.cin, R, a.grouped_conv, T + c1, ct, false, true);
    group_norm(cx, T, R, ct, a.w_norm_1, false, nullptr);
    gemm(cx, T, ct, R, a.w_conv_1, U, inter, false, true);
    group_norm(cx, U, R, inter, a.w_norm_2, false, nullptr);
    gemm(cx, U, inter, R, a.w_conv_2, S, co, false, false);
    gemm(cx, value, a.out_conv.cin, R, a.out_conv, T, co, false, false);
    group_norm(cx, T, R, co, a.out_norm, true, nullptr);
    // softmax over the k slots of each point, per channel, max-shifted
    for (int e = cx.gtid(); e < n * co; e += kGThreads) {
        const int i = e / co, c = e - i * co;
        const float* s = S + (size_t)i * k * co + c;
        const float* v = T + (size_t)i * k * co + c;
        float mx = ld(s);
        for (int j = 1; j < k; ++j) mx = fmaxf(mx, ld(s + (size_t)j * co));
        float sum = 0.0f;
        for (int j = 0; j < k; ++j) sum += expf(ld(s + (size_t)j * co) - mx);
        float acc = 0.0f;
        for (int j = 0; j < k; ++j)
            acc += ld(v + (size_t)j * co) * (expf(ld(s + (size_t)j * co) - mx) / sum);
        out[(size_t)i * co + c] = acc;
    }
    cluster_sync();
}

// The k nearest points of every point (k rounds of masked argmin over the
// distance rows, ties to the lowest index) into sm.knn (n x k); every block
// of the cluster makes its own copy.
__device__ void knn_select(Ctx cx, int n, int k) {
    if (cx.tid < n) {
        const int i = cx.tid;
        unsigned taken = 0u;
        for (int s = 0; s < k; ++s) {
            int best = -1;
            float bd = 0.0f;
            for (int j = 0; j < n; ++j) {
                if ((taken >> j) & 1u) continue;
                const float dj = sm.dist[i * n + j];
                if (best < 0 || dj < bd) {
                    best = j;
                    bd = dj;
                }
            }
            taken |= 1u << best;
            sm.knn[i * k + s] = best;
        }
    }
    __syncthreads();
}

// SA grouping of every point's k neighbours: [feat, rel, abs?, center?].
// full: slot j is point j (k == n); else the kNN picks.
__device__ void group_sa(Ctx cx, float* X, const float* feat, int cf, int n,
                         int k, bool full, bool inc_abs, bool inc_cen) {
    const int cg = cf + 3 + 3 * int(inc_abs) + 3 * int(inc_cen);
    const int R = n * k;
    const float* xyz = sm.xyz;
    for (int e = cx.gtid(); e < R * cg; e += kGThreads) {
        const int r = e / cg, c = e - r * cg;
        const int i = r / k, s = r - i * k;
        const int j = full ? s : sm.knn[i * k + s];
        float v;
        if (c < cf) {
            v = ld(feat + j * cf + c);
        } else {
            int q = c - cf;
            if (q < 3) {
                v = xyz[j * 3 + q] - xyz[i * 3 + q];
            } else {
                q -= 3;
                if (inc_abs && q < 3) v = xyz[j * 3 + q];
                else v = xyz[i * 3 + (inc_abs ? q - 3 : q)];
            }
        }
        X[e] = v;
    }
    cluster_sync();
}

// KnnFP grouping: [feat, dist, weight, abs, rel, center] (cf + 11 channels).
__device__ void group_knn(Ctx cx, float* X, const float* feat, int cf, int n, int k) {
    const int cg = cf + 11;
    const int R = n * k;
    const float* xyz = sm.xyz;
    for (int e = cx.gtid(); e < R * cg; e += kGThreads) {
        const int r = e / cg, c = e - r * cg;
        const int i = r / k, s = r - i * k;
        const int j = sm.knn[i * k + s];
        float v;
        if (c < cf) {
            v = ld(feat + j * cf + c);
        } else if (c == cf) {
            v = sm.dist[i * n + j];
        } else if (c == cf + 1) {
            float sum = 0.0f;
            for (int t = 0; t < k; ++t)
                sum += 1.0f / (sm.dist[i * n + sm.knn[i * k + t]] + 1e-8f);
            v = (1.0f / (sm.dist[i * n + j] + 1e-8f)) / sum;
        } else {
            const int q = c - cf - 2;
            if (q < 3) v = xyz[j * 3 + q];
            else if (q < 6) v = xyz[j * 3 + q - 3] - xyz[i * 3 + q - 3];
            else v = xyz[i * 3 + q - 6];
        }
        X[e] = v;
    }
    cluster_sync();
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 2)
fused_denoiser_kernel(const float* __restrict__ pc, const float* __restrict__ t4,
                      const float* __restrict__ cls, const float* __restrict__ wts,
                      const Spec* __restrict__ spec, float* __restrict__ scratch,
                      float* __restrict__ out) {
    const Spec& sp = *spec;
    const int b = blockIdx.x / kCluster, tid = threadIdx.x;
    const int n = sp.n, din = sp.din;
    float* cs = scratch + (size_t)b * sp.cloud_floats;
    const Ctx cx{wts, cs + sp.stats, cs + sp.vec, tid,
                 static_cast<int>(cg::this_cluster().block_rank())};
    float* buf[kBuffers];
    for (int i = 0; i < kBuffers; ++i) buf[i] = cs + sp.buf[i];
    float* lvl[kMaxLevels + 1];
    for (int i = 0; i <= kMaxLevels; ++i) lvl[i] = cs + sp.lvl[i];
    int lw[kMaxLevels + 1];

    // inputs: every block keeps xyz and the embeddings in shared memory;
    // level 0 = [pc[:, 3:], xyz] goes to scratch
    const float* p = pc + (size_t)b * n * din;
    for (int e = tid; e < n * 3; e += kThreads) sm.xyz[e] = p[(e / 3) * din + e % 3];
    for (int e = tid; e < sp.t4; e += kThreads) sm.t4[e] = t4[(size_t)b * sp.t4 + e];
    for (int e = tid; e < sp.cls; e += kThreads) sm.cls[e] = cls[(size_t)b * sp.cls + e];
    for (int e = cx.gtid(); e < n * din; e += kGThreads) {
        const int i = e / din, c = e - i * din;
        lvl[0][e] = c < din - 3 ? p[i * din + 3 + c] : p[i * din + c - (din - 3)];
    }
    lw[0] = din;
    __syncthreads();
    // squared distances, rounded as the plain version rounds them
    for (int e = tid; e < n * n; e += kThreads) {
        const int i = e / n, j = e - i * n;
        const float* a = sm.xyz + 3 * i;
        const float* c = sm.xyz + 3 * j;
        const float si = __fadd_rn(__fadd_rn(__fmul_rn(a[0], a[0]), __fmul_rn(a[1], a[1])),
                                   __fmul_rn(a[2], a[2]));
        const float sj = __fadd_rn(__fadd_rn(__fmul_rn(c[0], c[0]), __fmul_rn(c[1], c[1])),
                                   __fmul_rn(c[2], c[2]));
        const float xy = __fadd_rn(__fadd_rn(__fmul_rn(a[0], c[0]), __fmul_rn(a[1], c[1])),
                                   __fmul_rn(a[2], c[2]));
        sm.dist[e] = fmaxf(__fsub_rn(__fadd_rn(si, sj), __fmul_rn(2.0f, xy)), 0.0f);
    }
    cluster_sync();

    // SA tower
    for (int l = 0; l < sp.n_sa; ++l) {
        const SA& s = sp.sa[l];
        const int k = s.k;
        if (k < n) knn_select(cx, n, k);
        group_sa(cx, buf[0], lvl[l], lw[l], n, k, k == n, sp.inc_abs, sp.inc_cen);
        float* h = mlp(cx, s.mlp, buf[0], n * k, buf[1], buf[2]);
        float* other = h == buf[1] ? buf[2] : buf[1];
        attention(cx, s.att, lvl[l], buf[0], h, n, k, buf[3], other, buf[4], lvl[l + 1]);
        lw[l + 1] = s.att.w_conv_2.cout;
    }

    // KnnFP tower, top-down
    for (int l = sp.n_fp - 1; l >= 0; --l) {
        const FP& f = sp.fp[l];
        const int k = f.k;
        knn_select(cx, n, k);
        group_knn(cx, buf[0], lvl[l + 1], lw[l + 1], n, k);
        float* h = mlp(cx, f.mlp1, buf[0], n * k, buf[1], buf[2]);
        float* other = h == buf[1] ? buf[2] : buf[1];
        const int ci = f.att.w_conv_2.cout;
        attention(cx, f.att, lvl[l], buf[0], h, n, k, buf[3], other, buf[4], buf[0]);
        // nf = [interp, skip, xyz] into the free buffer h
        const int cs_ = lw[l], cn = ci + cs_ + 3;
        for (int e = cx.gtid(); e < n * cn; e += kGThreads) {
            const int i = e / cn, c = e - i * cn;
            float v;
            if (c < ci) v = ld(buf[0] + i * ci + c);
            else if (c < ci + cs_) v = ld(lvl[l] + i * cs_ + c - ci);
            else v = sm.xyz[i * 3 + c - ci - cs_];
            h[e] = v;
        }
        cluster_sync();
        const float* o = mlp(cx, f.mlp2, h, n, buf[3], buf[4]);
        const int co = f.mlp2.conv[f.mlp2.n_layers - 1].cout;
        for (int e = cx.gtid(); e < n * co; e += kGThreads) lvl[l][e] = ld(o + e);
        lw[l] = co;
        cluster_sync();
    }

    // head: [level 0, xyz] -> conv -> GN -> relu -> conv
    const int hin = lw[0] + 3;
    for (int e = cx.gtid(); e < n * hin; e += kGThreads) {
        const int i = e / hin, c = e - i * hin;
        buf[0][e] = c < lw[0] ? ld(lvl[0] + i * lw[0] + c) : sm.xyz[i * 3 + c - lw[0]];
    }
    cluster_sync();
    gemm(cx, buf[0], hin, n, sp.head1, buf[1], sp.head1.cout, false, false);
    group_norm(cx, buf[1], n, sp.head1.cout, sp.head_norm, true, nullptr);
    gemm(cx, buf[1], sp.head1.cout, n, sp.head_out, out + (size_t)b * n * sp.out_dim,
         sp.out_dim, false, false);
}

}  // namespace

// The int32 entries of the layer table (sizeof(Spec) / 4), for the wrapper to
// check its table against.
extern "C" int slide_fused_table_ints() {
    return static_cast<int>(sizeof(Spec) / sizeof(int));
}

// Returns the cudaError_t of the launch (0 on success).  All pointers are
// device pointers: pc (B, n, din), t4 (B, t4), cls (B, cls), weights, the
// int32 table, scratch (B x cloud_floats), out (B, n, out_dim); f32
// contiguous.  The table's widths are checked by the wrapper.  One cluster
// of kCluster blocks per cloud.
extern "C" int slide_fused_denoiser(const float* pc, const float* t4, const float* cls,
                                    const float* weights, const int* table,
                                    float* scratch, float* out, int B, int device,
                                    void* stream) {
    if (B <= 0) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    fused_denoiser_kernel<<<B * kCluster, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        pc, t4, cls, weights, reinterpret_cast<const Spec*>(table), scratch, out);
    return static_cast<int>(cudaGetLastError());
}
