// K2: the backward of the fused denoiser (the VJP of K1's forward) on Hopper
// (sm_90a), one launch per backward.
//
// Replaces the TPU kernel slide_tpu/models/fused_denoiser.py::_pallas_backward
// (jax.vjp of _forward_tile inside one Pallas kernel, weight gradients summed
// over the sequential grid).  Per cloud b it takes the cotangent g[b]
// (n x out_dim) and returns d(pc)[b], d(t4)[b], d(cls)[b]; the weight
// gradient d(flat) is summed over the batch.  Its plain version is autograd
// through slide_tpu_torch/models/fused_denoiser.py::fused_forward_plain
// (fused_backward_plain).  The layer table is fused_spec.cuh's `Spec`.
//
// What bounds it on this card: operations.  Recompute, d(input) and d(weight)
// are three weight products per layer, ~3x K1's (kp ~7.4 GFLOP, latent ~101
// GFLOP at batch 32), against a few MB of weights; all fp32 FFMA (no TF32, so
// the result stays the plain version's to fp32 rounding).
// Design, simple first (K1's, extended):
//   - one cluster of 8 blocks (256 threads each) per cloud; the blocks meet at
//     cluster barriers after every step, as in K1;
//   - the cloud's forward is recomputed with every activation the backward
//     reads kept in a per-cloud tape in device memory (offsets from the table:
//     conv outputs, GroupNorm inputs, outputs and statistics, attention scores
//     and softmax weights, grouped rows, level features); then the layers are
//     walked in reverse;
//   - every product is one generic tiled product with strides (64 x 64 output
//     tiles, 4 x 4 per thread): the forward's X W, the backward's dY W^T and
//     X^T dY.  Loads follow whichever operand axis is contiguous;
//   - GroupNorm backward: one warp per group sums dxhat and dxhat (x - mean),
//     one thread per channel sums the scale and bias gradients; the variance's
//     clip at 0 passes 1 above, 0 below and 0.5 at the tie (jnp.maximum's and
//     torch.maximum's rule); the distances' clamp likewise;
//   - gathers become scatter-adds inside the cloud, deterministic: each source
//     point sums, in a fixed order, over the (query, slot) pairs that picked
//     it.  kNN picks are recomputed from the distances (rounded as K1 rounds
//     them) and carry no gradient;
//   - weight gradients: each cloud writes its own partial (B x flat, zeroed by
//     the wrapper), every element by one thread; a second small kernel sums
//     the partials over b in order.  Two launches give equal results;
//   - every barrier sits in control flow that depends only on the table.
// Faster forms, for later: the products of K1's list (tensor cores with
// 3xTF32, larger thread tiles), a tape in distributed shared memory, the
// per-channel reductions fused into the products' epilogues.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cmath>

#include "fused_spec.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace slide_fused;

struct alignas(16) Smem {
    float As[BK][BM + 4];
    float Bs[BK][BN];
    float dist[kMaxN * kMaxN];
    int knn[kMaxN * kMaxN];
    float xyz[kMaxN * 3];
    float t4[kMaxVec];
    float cls[kMaxVec];
    float mean[kMaxGroups];
    float inv[kMaxGroups];
    float var[kMaxGroups];     // the variance before the clip
    float sdx[kMaxGroups];     // GroupNorm backward: sum of dxhat per group
    float sdxc[kMaxGroups];    // and of dxhat (x - mean)
};

__shared__ Smem sm;

struct Ctx {
    const float* __restrict__ w;   // packed weights
    float* dw;                     // this cloud's weight-gradient partial
    float* tape;                   // this cloud's scratch
    float* stat;                   // GroupNorm backward sums (2 x 32)
    float* vec;                    // the injection vector / its gradient
    int tid, rank;
    __device__ int gtid() const { return rank * kThreads + tid; }
};

__device__ __forceinline__ void cluster_sync() { cg::this_cluster().sync(); }

__device__ __forceinline__ float ld(const float* p) { return __ldcg(p); }

// Gradient of max(a, 0) with respect to a: 1 above, 0.5 at the tie, 0 below.
__device__ __forceinline__ float clamp_grad(float a) {
    return a > 0.0f ? 1.0f : (a == 0.0f ? 0.5f : 0.0f);
}

// out[r*ldo + c] (= or +=) relu?(sum_k A(r,k) B(k,c) + bias[c]) for r < R,
// c < C, with A(r,k) = A[r*sar + k*sak] and B(k,c) = B[k*sbk + c*sbc].  The
// cluster's blocks take turns over the 64 x 64 output tiles.  Ends with
// cluster_sync.
__device__ __noinline__ void gemm(Ctx cx, const float* A, int sar, int sak,
                                  const float* B, int sbk, int sbc, int R, int C,
                                  int K, const float* bias, float* out, int ldo,
                                  bool accumulate, bool relu) {
    const int tid = cx.tid;
    const int tx = tid & 15, ty = tid >> 4;
    const bool a_depth_fast = sak == 1;     // neighbouring threads, neighbouring k
    const bool b_cols_fast = sbc == 1;      // neighbouring threads, neighbouring c
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
                const int row = a_depth_fast ? e >> 4 : e & 63;
                const int kk = a_depth_fast ? e & 15 : e >> 6;
                const int r = m0 + row, k = k0 + kk;
                ra[q] = (r < R && k < K) ? ld(A + (size_t)r * sar + (size_t)k * sak) : 0.0f;
                const int kb = b_cols_fast ? e >> 6 : e & 15;
                const int col = b_cols_fast ? e & 63 : e >> 4;
                const int kw = k0 + kb, c = n0 + col;
                rb[q] = (kw < K && c < C) ? ld(B + (size_t)kw * sbk + (size_t)c * sbc) : 0.0f;
            }
        };
        fetch(0);
        for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int e = tid + q * kThreads;
                if (a_depth_fast) sm.As[e & 15][e >> 4] = ra[q];
                else sm.As[e >> 6][e & 63] = ra[q];
                if (b_cols_fast) sm.Bs[e >> 6][e & 63] = rb[q];
                else sm.Bs[e & 15][e >> 4] = rb[q];
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
                if (bias) v += ld(bias + c);
                float* o = out + (size_t)r * ldo + c;
                if (accumulate) v = ld(o) + v;
                if (relu) v = fmaxf(v, 0.0f);
                *o = v;
            }
        }
    }
    cluster_sync();
}

// y = relu?(x W + b): x (R rows, stride ldx), y (stride ldy)
__device__ void dense_fwd(Ctx cx, const float* x, int ldx, int R, const Dense& d,
                          float* y, int ldy, bool accumulate, bool relu) {
    gemm(cx, x, ldx, 1, cx.w + d.w, d.cout, 1, R, d.cout, d.cin,
         d.b >= 0 ? cx.w + d.b : nullptr, y, ldy, accumulate, relu);
}

// out[c] += sum_r y[r*ldy + c] for c < C.  Ends with cluster_sync.
__device__ void colsum_add(Ctx cx, const float* y, int ldy, int R, int C, float* out) {
    for (int c = cx.gtid(); c < C; c += kGThreads) {
        float s = 0.0f;
        for (int r = 0; r < R; ++r) s += ld(y + (size_t)r * ldy + c);
        out[c] = ld(out + c) + s;
    }
    cluster_sync();
}

// d W += x^T dy, d b += sum_r dy (this cloud's partial)
__device__ void dense_dw(Ctx cx, const float* x, int ldx, const float* dy, int ldy,
                         int R, const Dense& d) {
    gemm(cx, x, 1, ldx, dy, ldy, 1, d.cin, d.cout, R, nullptr, cx.dw + d.w, d.cout,
         true, false);
    if (d.b >= 0) colsum_add(cx, dy, ldy, R, d.cout, cx.dw + d.b);
}

// dx (= or +=) dy W^T
__device__ void dense_dx(Ctx cx, const float* dy, int ldy, int R, const Dense& d,
                         float* dx, int ldx, bool accumulate) {
    gemm(cx, dy, ldy, 1, cx.w + d.w, 1, d.cout, R, d.cin, d.cout, nullptr, dx, ldx,
         accumulate, false);
}

// buf[r, c] = 0 where ref[r, c] <= 0 (the relu's gradient)
__device__ void relu_mask(Ctx cx, float* buf, int ldb, const float* ref, int ldr,
                          int R, int C) {
    for (int e = cx.gtid(); e < R * C; e += kGThreads) {
        const int r = e / C, c = e - r * C;
        if (!(ld(ref + (size_t)r * ldr + c) > 0.0f)) buf[(size_t)r * ldb + c] = 0.0f;
    }
    cluster_sync();
}

// cx.vec[c] = v . W[:, c] + bias[c] (K1's gemv)
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

__device__ void load_stats(Ctx cx, const float* st, int G) {
    if (cx.tid < G) {
        sm.mean[cx.tid] = ld(st + cx.tid);
        sm.inv[cx.tid] = ld(st + kMaxGroups + cx.tid);
        sm.var[cx.tid] = ld(st + 2 * kMaxGroups + cx.tid);
    }
    __syncthreads();
}

// Tail GroupNorm of x (R rows x C, dense) into y, then relu if asked; the
// statistics (mean, inverse std, variance before the clip) go to st.
__device__ void gn_fwd(Ctx cx, const float* x, float* y, float* st, int R, int C,
                       const Norm& nd, bool relu) {
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
            const float a = s2 / static_cast<float>(cnt) - mean * mean;
            st[g] = mean;
            st[kMaxGroups + g] = 1.0f / sqrtf(fmaxf(a, 0.0f) + 1e-5f);
            st[2 * kMaxGroups + g] = a;
        }
    }
    cluster_sync();
    load_stats(cx, st, G);
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
        y[e] = v;
    }
    cluster_sync();
}

// GroupNorm backward in place: dy (R x C, dense) becomes dx, for the input x
// and the statistics st of gn_fwd; scale / bias gradients go to the partial.
__device__ void gn_bwd(Ctx cx, float* dy, const float* x, const float* st, int R,
                       int C, const Norm& nd) {
    const int G = nd.g, cn = C - C % G, gs = cn / G;
    const int lane = cx.tid & 31;
    const int cnt = R * gs;
    const float* scale = cx.w + nd.s;
    load_stats(cx, st, G);
    for (int g = cx.gtid() >> 5; g < G; g += kCluster * kWarps) {
        float s = 0.0f, sc = 0.0f;
        const float mean = sm.mean[g];
        for (int e = lane; e < cnt; e += 32) {
            const int r = e / gs, c = g * gs + (e - r * gs);
            const float dxh = ld(dy + (size_t)r * C + c) * __ldg(scale + c);
            s += dxh;
            sc = fmaf(dxh, ld(x + (size_t)r * C + c) - mean, sc);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            s += __shfl_xor_sync(0xffffffffu, s, off);
            sc += __shfl_xor_sync(0xffffffffu, sc, off);
        }
        if (lane == 0) {
            cx.stat[g] = s;
            cx.stat[kMaxGroups + g] = sc;
        }
    }
    for (int c = cx.gtid(); c < cn; c += kGThreads) {
        const int g = c / gs;
        float gb = 0.0f, gsc = 0.0f;
        for (int r = 0; r < R; ++r) {
            const float d = ld(dy + (size_t)r * C + c);
            gb += d;
            gsc = fmaf(d, (ld(x + (size_t)r * C + c) - sm.mean[g]) * sm.inv[g], gsc);
        }
        cx.dw[nd.s + c] = ld(cx.dw + nd.s + c) + gsc;
        cx.dw[nd.b + c] = ld(cx.dw + nd.b + c) + gb;
    }
    cluster_sync();
    if (cx.tid < G) {
        sm.sdx[cx.tid] = ld(cx.stat + cx.tid);
        sm.sdxc[cx.tid] = ld(cx.stat + kMaxGroups + cx.tid);
    }
    __syncthreads();
    const float fcnt = static_cast<float>(cnt);
    for (int e = cx.gtid(); e < R * C; e += kGThreads) {
        const int c = e % C;
        if (c >= cn) continue;                     // the tail passes through
        const int g = c / gs;
        const float inv = sm.inv[g];
        const float dxh = ld(dy + e) * __ldg(scale + c);
        const float dvar = sm.sdxc[g] * (-0.5f * inv * inv * inv) * clamp_grad(sm.var[g]);
        dy[e] = dxh * inv + (2.0f * dvar * (ld(x + e) - sm.mean[g]) - inv * sm.sdx[g]) / fcnt;
    }
    cluster_sync();
}

// ---------------------------------------------------------------------------
// Forward with the tape

__device__ __forceinline__ const float* layer_out(Ctx cx, const Mlp& m, int l) {
    const bool inj = (l == 0 && m.inject_t) || (l == 1 && m.inject_c);
    return cx.tape + (inj ? m.h[l] : m.a[l]);
}

// InjectionMLP on R rows of x; its output goes to the tape (m.out).
__device__ void mlp_fwd(Ctx cx, const Mlp& m, const float* x, int R) {
    const float* in = x;
    for (int l = 0; l < m.n_layers; ++l) {
        const Dense& cv = m.conv[l];
        float* z = cx.tape + m.z[l];
        float* a = cx.tape + m.a[l];
        dense_fwd(cx, in, cv.cin, R, cv, z, cv.cout, false, false);
        const bool inj_t = l == 0 && m.inject_t, inj_c = l == 1 && m.inject_c;
        if (inj_t) gemv(cx, sm.t4, m.fc_t);
        if (inj_c) gemv(cx, sm.cls, m.fc_c);
        gn_fwd(cx, z, a, cx.tape + m.st[l], R, cv.cout, m.norm[l], true);
        if (inj_t || inj_c) {
            float* h = cx.tape + m.h[l];
            for (int e = cx.gtid(); e < R * cv.cout; e += kGThreads)
                h[e] = ld(a + e) + ld(cx.vec + e % cv.cout);
            cluster_sync();
        }
        in = layer_out(cx, m, l);
    }
    const int c0 = m.conv[0].cin, cl = m.conv[m.n_layers - 1].cout;
    float* out = cx.tape + m.out;
    for (int e = cx.gtid(); e < R * cl; e += kGThreads)
        out[e] = m.res == 2 ? ld(in + e) : ld(in + e) + ld(x + e);
    cluster_sync();
    if (m.res == 2) dense_fwd(cx, x, c0, R, m.res_conv, out, cl, true, false);
}

// AttentionPool with every slot valid: feat (n x cq), grouped, value (n*k
// rows); out (n x c_out, row stride ldo); tmp a free buffer.
__device__ void att_fwd(Ctx cx, const Att& a, const float* feat, const float* grouped,
                        const float* value, int n, int k, float* out, int ldo,
                        float* tmp) {
    const int R = n * k;
    const int c1 = a.feat_conv.cout, ct = a.w_conv_1.cin;
    const int inter = a.w_conv_1.cout, co = a.w_conv_2.cout;
    float* T = cx.tape + a.t;
    dense_fwd(cx, feat, a.feat_conv.cin, n, a.feat_conv, tmp, c1, false, true);
    for (int e = cx.gtid(); e < R * c1; e += kGThreads) {
        const int r = e / c1, c = e - r * c1;
        T[(size_t)r * ct + c] = ld(tmp + (r / k) * c1 + c);
    }
    dense_fwd(cx, grouped, a.grouped_conv.cin, R, a.grouped_conv, T + c1, ct, false, true);
    gn_fwd(cx, T, cx.tape + a.tn, cx.tape + a.st1, R, ct, a.w_norm_1, false);
    dense_fwd(cx, cx.tape + a.tn, ct, R, a.w_conv_1, cx.tape + a.u, inter, false, true);
    gn_fwd(cx, cx.tape + a.u, cx.tape + a.un, cx.tape + a.st2, R, inter, a.w_norm_2, false);
    dense_fwd(cx, cx.tape + a.un, inter, R, a.w_conv_2, cx.tape + a.s, co, false, false);
    dense_fwd(cx, value, a.out_conv.cin, R, a.out_conv, cx.tape + a.v, co, false, false);
    gn_fwd(cx, cx.tape + a.v, cx.tape + a.vn, cx.tape + a.st3, R, co, a.out_norm, true);
    const float* S = cx.tape + a.s;
    const float* V = cx.tape + a.vn;
    float* W = cx.tape + a.w;
    for (int e = cx.gtid(); e < n * co; e += kGThreads) {
        const int i = e / co, c = e - i * co;
        const size_t base = (size_t)i * k * co + c;
        float mx = ld(S + base);
        for (int j = 1; j < k; ++j) mx = fmaxf(mx, ld(S + base + (size_t)j * co));
        float sum = 0.0f;
        for (int j = 0; j < k; ++j) sum += expf(ld(S + base + (size_t)j * co) - mx);
        float acc = 0.0f;
        for (int j = 0; j < k; ++j) {
            const float w = expf(ld(S + base + (size_t)j * co) - mx) / sum;
            W[base + (size_t)j * co] = w;
            acc += ld(V + base + (size_t)j * co) * w;
        }
        out[(size_t)i * ldo + c] = acc;
    }
    cluster_sync();
}

// K1's kNN: k rounds of masked argmin, ties to the lowest index, into sm.knn.
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

__device__ __forceinline__ int pick(int i, int s, int k, bool full) {
    return full ? s : sm.knn[i * k + s];
}

// SA grouping [feat, rel, abs?, center?] (K1's group_sa)
__device__ void group_sa(Ctx cx, float* X, const float* feat, int cf, int n, int k,
                         bool full, bool inc_abs, bool inc_cen) {
    const int cgw = cf + 3 + 3 * int(inc_abs) + 3 * int(inc_cen);
    const float* xyz = sm.xyz;
    for (int e = cx.gtid(); e < n * k * cgw; e += kGThreads) {
        const int r = e / cgw, c = e - r * cgw;
        const int i = r / k, j = pick(i, r - i * k, k, full);
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

// KnnFP grouping [feat, dist, weight, abs, rel, center] (K1's group_knn)
__device__ void group_knn(Ctx cx, float* X, const float* feat, int cf, int n, int k) {
    const int cgw = cf + 11;
    const float* xyz = sm.xyz;
    for (int e = cx.gtid(); e < n * k * cgw; e += kGThreads) {
        const int r = e / cgw, c = e - r * cgw;
        const int i = r / k, j = sm.knn[r];
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

// Squared distance before the clamp, rounded as K1 and the plain version.
__device__ __forceinline__ float sqdist_raw(const float* a, const float* c) {
    const float si = __fadd_rn(__fadd_rn(__fmul_rn(a[0], a[0]), __fmul_rn(a[1], a[1])),
                               __fmul_rn(a[2], a[2]));
    const float sj = __fadd_rn(__fadd_rn(__fmul_rn(c[0], c[0]), __fmul_rn(c[1], c[1])),
                               __fmul_rn(c[2], c[2]));
    const float xy = __fadd_rn(__fadd_rn(__fmul_rn(a[0], c[0]), __fmul_rn(a[1], c[1])),
                               __fmul_rn(a[2], c[2]));
    return __fsub_rn(__fadd_rn(si, sj), __fmul_rn(2.0f, xy));
}

// ---------------------------------------------------------------------------
// Backward

// The injection's gradient: dvec[c] = sum_r dh[r, c]; then fc's weight and
// bias gradients and d(v) (the t or class embedding) added to gacc.
__device__ void inject_bwd(Ctx cx, const float* dh, int R, int C, const Dense& fc,
                           const float* v, float* gacc) {
    for (int c = cx.gtid(); c < C; c += kGThreads) {
        float s = 0.0f;
        for (int r = 0; r < R; ++r) s += ld(dh + (size_t)r * C + c);
        cx.vec[c] = s;
        if (fc.b >= 0) cx.dw[fc.b + c] = ld(cx.dw + fc.b + c) + s;
    }
    cluster_sync();
    for (int e = cx.gtid(); e < fc.cin * C; e += kGThreads) {
        const int kk = e / C, c = e - kk * C;
        cx.dw[fc.w + e] = ld(cx.dw + fc.w + e) + v[kk] * ld(cx.vec + c);
    }
    for (int kk = cx.gtid(); kk < fc.cin; kk += kGThreads) {
        float s = 0.0f;
        for (int c = 0; c < C; ++c) s = fmaf(__ldg(cx.w + fc.w + (size_t)kk * C + c), ld(cx.vec + c), s);
        gacc[kk] = ld(gacc + kk) + s;
    }
    cluster_sync();
}

// InjectionMLP backward.  P: d(out) (R x cl), overwritten; Q: a free buffer;
// dx (R x c0) is written (acc_dx false) or added to.
__device__ void mlp_bwd(Ctx cx, const Mlp& m, const float* x, int R, float* P, float* Q,
                        float* dx, bool acc_dx, float* gt4, float* gcls) {
    const int L = m.n_layers, c0 = m.conv[0].cin, cl = m.conv[L - 1].cout;
    if (m.res == 2) {
        dense_dw(cx, x, c0, P, cl, R, m.res_conv);
        dense_dx(cx, P, cl, R, m.res_conv, dx, c0, acc_dx);
    } else {
        for (int e = cx.gtid(); e < R * cl; e += kGThreads)
            dx[e] = acc_dx ? ld(dx + e) + ld(P + e) : ld(P + e);
        cluster_sync();
    }
    for (int l = L - 1; l >= 0; --l) {
        const Dense& cv = m.conv[l];
        const int cout = cv.cout;
        if (l == 0 && m.inject_t) inject_bwd(cx, P, R, cout, m.fc_t, sm.t4, gt4);
        if (l == 1 && m.inject_c) inject_bwd(cx, P, R, cout, m.fc_c, sm.cls, gcls);
        const float* a = cx.tape + m.a[l];
        for (int e = cx.gtid(); e < R * cout; e += kGThreads)
            Q[e] = ld(a + e) > 0.0f ? ld(P + e) : 0.0f;
        cluster_sync();
        gn_bwd(cx, Q, cx.tape + m.z[l], cx.tape + m.st[l], R, cout, m.norm[l]);
        const float* in = l == 0 ? x : layer_out(cx, m, l - 1);
        dense_dw(cx, in, cv.cin, Q, cout, R, cv);
        if (l == 0) dense_dx(cx, Q, cout, R, cv, dx, c0, true);
        else dense_dx(cx, Q, cout, R, cv, P, cv.cin, false);
    }
}

// AttentionPool backward.  dout (n x co, row stride ldd); dfeat (n x cq) is
// added to; dgrouped (n*k x cg) and dvalue (n*k x out_conv.cin) are written.
__device__ void att_bwd(Ctx cx, const Att& a, const float* feat, const float* grouped,
                        const float* value, int n, int k, const float* dout, int ldd,
                        float* dfeat, float* dgrouped, float* dvalue, float* Q1,
                        float* Q2, float* Q3) {
    const int R = n * k;
    const int c1 = a.feat_conv.cout, ct = a.w_conv_1.cin;
    const int inter = a.w_conv_1.cout, co = a.w_conv_2.cout;
    const float* W = cx.tape + a.w;
    const float* Vn = cx.tape + a.vn;
    // the pooled sum and the softmax over slots
    for (int e = cx.gtid(); e < n * co; e += kGThreads) {
        const int i = e / co, c = e - i * co;
        const size_t base = (size_t)i * k * co + c;
        const float go = ld(dout + (size_t)i * ldd + c);
        float swd = 0.0f;
        for (int j = 0; j < k; ++j) {
            const size_t r = base + (size_t)j * co;
            const float w = ld(W + r);
            Q1[r] = go * w;
            swd += w * (go * ld(Vn + r));
        }
        for (int j = 0; j < k; ++j) {
            const size_t r = base + (size_t)j * co;
            const float w = ld(W + r);
            Q2[r] = w * (go * ld(Vn + r) - swd);
        }
    }
    cluster_sync();
    // value path: relu(GroupNorm(value W_out + b))
    relu_mask(cx, Q1, co, Vn, co, R, co);
    gn_bwd(cx, Q1, cx.tape + a.v, cx.tape + a.st3, R, co, a.out_norm);
    dense_dw(cx, value, a.out_conv.cin, Q1, co, R, a.out_conv);
    dense_dx(cx, Q1, co, R, a.out_conv, dvalue, a.out_conv.cin, false);
    // scores: GroupNorm(relu(GroupNorm(relu([f1, g1])) W1)) W2
    dense_dw(cx, cx.tape + a.un, inter, Q2, co, R, a.w_conv_2);
    dense_dx(cx, Q2, co, R, a.w_conv_2, Q3, inter, false);
    gn_bwd(cx, Q3, cx.tape + a.u, cx.tape + a.st2, R, inter, a.w_norm_2);
    relu_mask(cx, Q3, inter, cx.tape + a.u, inter, R, inter);
    dense_dw(cx, cx.tape + a.tn, ct, Q3, inter, R, a.w_conv_1);
    dense_dx(cx, Q3, inter, R, a.w_conv_1, Q2, ct, false);
    gn_bwd(cx, Q2, cx.tape + a.t, cx.tape + a.st1, R, ct, a.w_norm_1);
    relu_mask(cx, Q2, ct, cx.tape + a.t, ct, R, ct);
    // f1 was broadcast over the k slots: sum them
    for (int e = cx.gtid(); e < n * c1; e += kGThreads) {
        const int i = e / c1, c = e - i * c1;
        float s = 0.0f;
        for (int j = 0; j < k; ++j) s += ld(Q2 + (size_t)(i * k + j) * ct + c);
        Q3[e] = s;
    }
    cluster_sync();
    dense_dw(cx, feat, a.feat_conv.cin, Q3, c1, n, a.feat_conv);
    dense_dx(cx, Q3, c1, n, a.feat_conv, dfeat, a.feat_conv.cin, true);
    dense_dw(cx, grouped, a.grouped_conv.cin, Q2 + c1, ct, R, a.grouped_conv);
    dense_dx(cx, Q2 + c1, ct, R, a.grouped_conv, dgrouped, a.grouped_conv.cin, false);
}

// d of the SA grouping: the feature rows back to their source points (each
// point sums over the (query, slot) pairs that picked it, in order), the
// coordinate channels into gxyz.
__device__ void group_sa_bwd(Ctx cx, const float* dX, int cf, int n, int k, bool full,
                             bool inc_abs, bool inc_cen, float* dfeat, float* gxyz) {
    const int cgw = cf + 3 + 3 * int(inc_abs) + 3 * int(inc_cen);
    const int cen = cf + 3 + 3 * int(inc_abs);
    for (int e = cx.gtid(); e < n * cf; e += kGThreads) {
        const int p = e / cf, c = e - p * cf;
        float s = 0.0f;
        for (int i = 0; i < n; ++i)
            for (int sl = 0; sl < k; ++sl)
                if (pick(i, sl, k, full) == p) s += ld(dX + (size_t)(i * k + sl) * cgw + c);
        dfeat[e] = ld(dfeat + e) + s;
    }
    for (int e = cx.gtid(); e < n * 3; e += kGThreads) {
        const int p = e / 3, q = e - p * 3;
        float s = 0.0f;
        for (int i = 0; i < n; ++i)
            for (int sl = 0; sl < k; ++sl) {
                const float* row = dX + (size_t)(i * k + sl) * cgw;
                const float rel = ld(row + cf + q);
                if (pick(i, sl, k, full) == p) {
                    s += rel;
                    if (inc_abs) s += ld(row + cf + 3 + q);
                }
                if (i == p) {
                    s -= rel;
                    if (inc_cen) s += ld(row + cen + q);
                }
            }
        gxyz[e] = ld(gxyz + e) + s;
    }
    cluster_sync();
}

// d of the KnnFP grouping: features and coordinates as above; the distance
// and weight channels into gdist at (query, pick).
__device__ void group_knn_bwd(Ctx cx, const float* dX, int cf, int n, int k,
                              float* dfeat, float* gxyz, float* gdist) {
    const int cgw = cf + 11;
    for (int e = cx.gtid(); e < n * cf; e += kGThreads) {
        const int p = e / cf, c = e - p * cf;
        float s = 0.0f;
        for (int r = 0; r < n * k; ++r)
            if (sm.knn[r] == p) s += ld(dX + (size_t)r * cgw + c);
        dfeat[e] = ld(dfeat + e) + s;
    }
    for (int e = cx.gtid(); e < n * 3; e += kGThreads) {
        const int p = e / 3, q = e - p * 3;
        float s = 0.0f;
        for (int r = 0; r < n * k; ++r) {
            const float* row = dX + (size_t)r * cgw + cf + 2;
            const float rel = ld(row + 3 + q);
            if (sm.knn[r] == p) s += ld(row + q) + rel;
            if (r / k == p) s += ld(row + 6 + q) - rel;
        }
        gxyz[e] = ld(gxyz + e) + s;
    }
    // weight_t = recip_t / S, recip_t = 1 / (d_t + 1e-8), S = sum_t recip_t;
    // the picks of one query are distinct, so each (query, pick) is one thread's
    for (int i = cx.gtid(); i < n; i += kGThreads) {
        float S = 0.0f, swr = 0.0f;
        for (int t = 0; t < k; ++t) {
            const float rt = 1.0f / (sm.dist[i * n + sm.knn[i * k + t]] + 1e-8f);
            S += rt;
            swr += ld(dX + (size_t)(i * k + t) * cgw + cf + 1) * rt;
        }
        for (int t = 0; t < k; ++t) {
            const int j = sm.knn[i * k + t];
            const float rt = 1.0f / (sm.dist[i * n + j] + 1e-8f);
            const float* row = dX + (size_t)(i * k + t) * cgw;
            const float drecip = ld(row + cf + 1) / S - swr / (S * S);
            gdist[i * n + j] = ld(gdist + i * n + j) + ld(row + cf) - drecip * (rt * rt);
        }
    }
    cluster_sync();
}

// d of the distances max((|x|^2 + |y|^2) - 2<x, y>, 0) into gxyz.
__device__ void dist_bwd(Ctx cx, int n, const float* gdist, float* gxyz) {
    for (int e = cx.gtid(); e < n * 3; e += kGThreads) {
        const int p = e / 3, q = e - p * 3;
        const float* xp = sm.xyz + 3 * p;
        float s = 0.0f;
        for (int j = 0; j < n; ++j) {
            if (j == p) continue;                  // d/dx of a self-distance is 0
            const float gsum = ld(gdist + p * n + j) + ld(gdist + j * n + p);
            if (gsum == 0.0f) continue;
            const float* xj = sm.xyz + 3 * j;
            s += gsum * clamp_grad(sqdist_raw(xp, xj)) * 2.0f * (xp[q] - xj[q]);
        }
        gxyz[e] = ld(gxyz + e) + s;
    }
    cluster_sync();
}

__device__ void zero(Ctx cx, float* p, int count) {
    for (int e = cx.gtid(); e < count; e += kGThreads) p[e] = 0.0f;
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 2)
fused_denoiser_bwd_kernel(const float* __restrict__ pc, const float* __restrict__ t4,
                          const float* __restrict__ cls, const float* __restrict__ gout,
                          const float* __restrict__ wts, const Spec* __restrict__ spec,
                          float* __restrict__ scratch, float* __restrict__ partial,
                          size_t flat_size, float* __restrict__ dpc,
                          float* __restrict__ dt4, float* __restrict__ dcls) {
    const Spec& sp = *spec;
    const int b = blockIdx.x / kCluster, tid = threadIdx.x;
    const int n = sp.n, din = sp.din;
    float* tape = scratch + (size_t)b * sp.bwd_floats;
    const Ctx cx{wts, partial + (size_t)b * flat_size, tape, tape + sp.gstat,
                 tape + sp.tvec, tid, static_cast<int>(cg::this_cluster().block_rank())};
    float* flvl[kMaxLevels + 1];
    float* gf[kMaxLevels + 1];
    float* gg[kMaxLevels + 1];
    for (int i = 0; i <= kMaxLevels; ++i) {
        flvl[i] = tape + sp.flvl[i];
        gf[i] = tape + sp.gf[i];
        gg[i] = tape + sp.gg[i];
    }
    float* gbuf[kGradBuffers];
    for (int i = 0; i < kGradBuffers; ++i) gbuf[i] = tape + sp.gbuf[i];
    float* gdist = tape + sp.gdist;
    float* gxyz = tape + sp.gxyz;
    float* gt4 = tape + sp.gvec;
    float* gcls = gt4 + sp.t4;
    int lw[kMaxLevels + 1];     // widths of the SA levels' features F_l
    int lg[kMaxLevels + 1];     // widths of the KnnFP levels' features G_l

    // ---- forward, keeping the tape (K1's order of work)
    const float* p = pc + (size_t)b * n * din;
    for (int e = tid; e < n * 3; e += kThreads) sm.xyz[e] = p[(e / 3) * din + e % 3];
    for (int e = tid; e < sp.t4; e += kThreads) sm.t4[e] = t4[(size_t)b * sp.t4 + e];
    for (int e = tid; e < sp.cls; e += kThreads) sm.cls[e] = cls[(size_t)b * sp.cls + e];
    for (int e = cx.gtid(); e < n * din; e += kGThreads) {
        const int i = e / din, c = e - i * din;
        flvl[0][e] = c < din - 3 ? p[i * din + 3 + c] : p[i * din + c - (din - 3)];
    }
    lw[0] = din;
    __syncthreads();
    for (int e = tid; e < n * n; e += kThreads) {
        const int i = e / n, j = e - i * n;
        sm.dist[e] = fmaxf(sqdist_raw(sm.xyz + 3 * i, sm.xyz + 3 * j), 0.0f);
    }
    cluster_sync();

    for (int l = 0; l < sp.n_sa; ++l) {
        const SA& s = sp.sa[l];
        const int k = s.k;
        if (k < n) knn_select(cx, n, k);
        float* X = tape + s.x;
        group_sa(cx, X, flvl[l], lw[l], n, k, k == n, sp.inc_abs, sp.inc_cen);
        mlp_fwd(cx, s.mlp, X, n * k);
        const int co = s.att.w_conv_2.cout;
        att_fwd(cx, s.att, flvl[l], X, tape + s.mlp.out, n, k, flvl[l + 1], co, gbuf[0]);
        lw[l + 1] = co;
    }
    lg[sp.n_fp] = lw[sp.n_fp];
    for (int l = sp.n_fp - 1; l >= 0; --l) {
        const FP& f = sp.fp[l];
        const int k = f.k;
        knn_select(cx, n, k);
        const float* src = l + 1 == sp.n_fp ? flvl[l + 1] : tape + sp.fp[l + 1].mlp2.out;
        float* X = tape + f.x;
        group_knn(cx, X, src, lg[l + 1], n, k);
        mlp_fwd(cx, f.mlp1, X, n * k);
        const int ci = f.att.w_conv_2.cout, cs = lw[l], cn = ci + cs + 3;
        float* nf = tape + f.nf;
        att_fwd(cx, f.att, flvl[l], X, tape + f.mlp1.out, n, k, nf, cn, gbuf[0]);
        for (int e = cx.gtid(); e < n * (cs + 3); e += kGThreads) {
            const int i = e / (cs + 3), c = e - i * (cs + 3);
            nf[i * cn + ci + c] = c < cs ? ld(flvl[l] + i * cs + c) : sm.xyz[i * 3 + c - cs];
        }
        cluster_sync();
        mlp_fwd(cx, f.mlp2, nf, n);
        lg[l] = f.mlp2.conv[f.mlp2.n_layers - 1].cout;
    }
    // head: [G_0, xyz] -> conv -> GN -> relu (-> conv)
    const float* src0 = sp.n_fp > 0 ? tape + sp.fp[0].mlp2.out : flvl[0];
    const int w0 = sp.n_fp > 0 ? lg[0] : lw[0];
    const int hw = w0 + 3, hc = sp.head1.cout;
    float* hin = tape + sp.hin;
    for (int e = cx.gtid(); e < n * hw; e += kGThreads) {
        const int i = e / hw, c = e - i * hw;
        hin[e] = c < w0 ? ld(src0 + i * w0 + c) : sm.xyz[i * 3 + c - w0];
    }
    cluster_sync();
    dense_fwd(cx, hin, hw, n, sp.head1, tape + sp.hz, hc, false, false);
    gn_fwd(cx, tape + sp.hz, tape + sp.ha, tape + sp.hst, n, hc, sp.head_norm, true);

    // ---- backward
    for (int l = 0; l <= sp.n_sa; ++l) zero(cx, gf[l], n * lw[l]);
    for (int l = 0; l < sp.n_fp; ++l) zero(cx, gg[l], n * lg[l]);
    zero(cx, gdist, n * n);
    zero(cx, gxyz, n * 3);
    zero(cx, gt4, sp.t4 + sp.cls);
    cluster_sync();

    const float* g = gout + (size_t)b * n * sp.out_dim;
    dense_dw(cx, tape + sp.ha, hc, g, sp.out_dim, n, sp.head_out);
    dense_dx(cx, g, sp.out_dim, n, sp.head_out, gbuf[0], hc, false);
    relu_mask(cx, gbuf[0], hc, tape + sp.ha, hc, n, hc);
    gn_bwd(cx, gbuf[0], tape + sp.hz, tape + sp.hst, n, hc, sp.head_norm);
    dense_dw(cx, hin, hw, gbuf[0], hc, n, sp.head1);
    dense_dx(cx, gbuf[0], hc, n, sp.head1, gbuf[1], hw, false);
    float* g0 = sp.n_fp > 0 ? gg[0] : gf[0];
    for (int e = cx.gtid(); e < n * w0; e += kGThreads) {
        const int i = e / w0, c = e - i * w0;
        g0[e] = ld(g0 + e) + ld(gbuf[1] + i * hw + c);
    }
    for (int e = cx.gtid(); e < n * 3; e += kGThreads)
        gxyz[e] = ld(gxyz + e) + ld(gbuf[1] + (e / 3) * hw + w0 + e % 3);
    cluster_sync();

    for (int l = 0; l < sp.n_fp; ++l) {
        const FP& f = sp.fp[l];
        const int k = f.k, R = n * k;
        const int ci = f.att.w_conv_2.cout, cs = lw[l], cn = ci + cs + 3;
        const float* X = tape + f.x;
        mlp_bwd(cx, f.mlp2, tape + f.nf, n, gg[l], gbuf[0], gbuf[3], false, gt4, gcls);
        for (int e = cx.gtid(); e < n * cn; e += kGThreads) {
            const int i = e / cn, c = e - i * cn;
            const float v = ld(gbuf[3] + e);
            if (c < ci) gbuf[5][i * ci + c] = v;
            else if (c < ci + cs) gf[l][i * cs + c - ci] = ld(gf[l] + i * cs + c - ci) + v;
        }
        for (int e = cx.gtid(); e < n * 3; e += kGThreads)
            gxyz[e] = ld(gxyz + e) + ld(gbuf[3] + (e / 3) * cn + ci + cs + e % 3);
        cluster_sync();
        att_bwd(cx, f.att, flvl[l], X, tape + f.mlp1.out, n, k, gbuf[5], ci, gf[l],
                gbuf[3], gbuf[4], gbuf[0], gbuf[1], gbuf[2]);
        mlp_bwd(cx, f.mlp1, X, R, gbuf[4], gbuf[0], gbuf[3], true, gt4, gcls);
        knn_select(cx, n, k);
        float* target = l + 1 == sp.n_fp ? gf[l + 1] : gg[l + 1];
        group_knn_bwd(cx, gbuf[3], lg[l + 1], n, k, target, gxyz, gdist);
    }
    for (int l = sp.n_sa - 1; l >= 0; --l) {
        const SA& s = sp.sa[l];
        const int k = s.k, R = n * k;
        const float* X = tape + s.x;
        att_bwd(cx, s.att, flvl[l], X, tape + s.mlp.out, n, k, gf[l + 1], lw[l + 1],
                gf[l], gbuf[3], gbuf[4], gbuf[0], gbuf[1], gbuf[2]);
        mlp_bwd(cx, s.mlp, X, R, gbuf[4], gbuf[0], gbuf[3], true, gt4, gcls);
        if (k < n) knn_select(cx, n, k);
        group_sa_bwd(cx, gbuf[3], lw[l], n, k, k == n, sp.inc_abs, sp.inc_cen, gf[l], gxyz);
    }
    dist_bwd(cx, n, gdist, gxyz);

    // outputs: d(pc) from level 0 ([pc[:, 3:], xyz]) and the coordinates
    for (int e = cx.gtid(); e < n * din; e += kGThreads) {
        const int i = e / din, c = e - i * din;
        dpc[(size_t)b * n * din + e] = c < 3
            ? ld(gxyz + i * 3 + c) + ld(gf[0] + i * din + din - 3 + c)
            : ld(gf[0] + i * din + c - 3);
    }
    for (int e = cx.gtid(); e < sp.t4; e += kGThreads) dt4[(size_t)b * sp.t4 + e] = ld(gt4 + e);
    for (int e = cx.gtid(); e < sp.cls; e += kGThreads)
        dcls[(size_t)b * sp.cls + e] = ld(gcls + e);
}

// d(flat)[e] = sum over b, in order, of the clouds' partials.
__global__ void sum_partials_kernel(const float* __restrict__ partial, int B, size_t size,
                                    float* __restrict__ out) {
    for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < size;
         e += (size_t)gridDim.x * blockDim.x) {
        float s = 0.0f;
        for (int b = 0; b < B; ++b) s += partial[(size_t)b * size + e];
        out[e] = s;
    }
}

}  // namespace

// Returns the cudaError_t of the launches (0 on success).  All pointers are
// device pointers, f32 contiguous: pc (B, n, din), t4 (B, t4), cls (B, cls),
// g (B, n, out_dim), weights (flat_size), the int32 table, scratch
// (B x bwd_floats), partial (B x flat_size, zeroed), dpc, dt4, dcls (the
// inputs' shapes), dflat (flat_size).  One cluster of kCluster blocks per
// cloud, then the sum over the batch.
extern "C" int slide_fused_denoiser_bwd(const float* pc, const float* t4, const float* cls,
                                        const float* g, const float* weights,
                                        const int* table, float* scratch, float* partial,
                                        float* dpc, float* dt4, float* dcls, float* dflat,
                                        int B, long long flat_size, int device,
                                        void* stream) {
    if (B <= 0 || flat_size <= 0) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    fused_denoiser_bwd_kernel<<<B * kCluster, kThreads, 0, s>>>(
        pc, t4, cls, g, weights, reinterpret_cast<const Spec*>(table), scratch, partial,
        static_cast<size_t>(flat_size), dpc, dt4, dcls);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    const long long blocks = (flat_size + 255) / 256;
    sum_partials_kernel<<<static_cast<int>(blocks < 4096 ? blocks : 4096), 256, 0, s>>>(
        partial, B, static_cast<size_t>(flat_size), dflat);
    return static_cast<int>(cudaGetLastError());
}
