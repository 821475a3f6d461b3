// K2: the backward of the fused denoiser (the VJP of K1's forward) on Hopper
// (sm_90a): three launches in one C entry point.
//
// Replaces the TPU kernel slide_tpu/models/fused_denoiser.py::_pallas_backward
// (jax.vjp of _forward_tile inside one Pallas kernel, weight gradients summed
// over the sequential grid).  Per cloud b it takes the cotangent g[b]
// (n x out_dim) and returns d(pc)[b], d(t4)[b], d(cls)[b]; the weight
// gradient d(flat) is summed over the batch.  Its plain version is autograd
// through slide_tpu_torch/models/fused_denoiser.py::fused_forward_plain
// (fused_backward_plain); the weight-gradient launch's is
// weight_grads_plain.  The tables are fused_spec.cuh's `Spec` and `Spec2`.
//
// What bounds it on this card: operations (the recompute, d input and d
// weight products, three per layer: kp ~7.4 GFLOP, latent ~101 GFLOP at batch
// 32, run as 3xTF32 on the tensor cores), and in practice, per cloud, the
// latency of a chain of ~83 products and ~57 GroupNorms.
// Design (K1's, fused_common.cuh, extended to the backward):
//   - the chain: one cluster of CL blocks per cloud (the plan's choice: 4 at
//     two blocks per SM for the kp net, so that the card holds a training
//     batch of 32 in one wave; 8 at one for the latent net).  Block r
//     owns points [r P, (r + 1) P) and their grouped rows through the
//     recompute and the backward.  The tape (every activation the backward
//     reads, offsets from the tables) is the cloud's in device memory, rows
//     in order, so a block's rows are one run that it alone writes and reads;
//     steps on rows end in the compute warps' named barrier;
//   - across blocks only what the math needs, each behind one cluster-wide
//     arrival: a GroupNorm's sums (forward: formed in the epilogue of the
//     products that wrote its input; backward: of dx^ and dx^ (x - mean) per
//     group) through distributed shared memory; a level's features, which
//     the next grouping reads across owners; the grouped rows' gradients,
//     which each owner scatters back to its points (each sums, in a fixed
//     order, the rows that picked it); the distance gradient; the injection
//     vectors' gradients (each block's column sums, then d t4 / d cls, each
//     block over its share of the embedding);
//   - products on the tensor cores at fp32 accuracy (3xTF32: K1's loop,
//     fused_common.cuh::gemm_t, each 8-deep step summed in fresh
//     accumulators): the
//     recompute's X W and the backward's d input = dY W^T, the latter over
//     a transposed copy of the weights that the wrapper gathers each call
//     (read through the same ring of multicast bulk copies as a forward
//     product: the stage of a (cin, cout) weight's transpose is a depth slice
//     of dY's width, so no bank-conflicted transposed reads);
//   - weight gradients off the chain: d W of a layer feeds nothing in the
//     backward, so the chain writes each product's dY to the tape beside its
//     X (over a GroupNorm's input, which nothing else reads afterwards, or
//     into fields of their own), and each block its row of the GroupNorm
//     affines' and the injections' column sums.  A second launch computes
//     every d W = sum over the batch of X_b^T dY_b and d b = sum of dY_b:
//     one grouped launch over all layers (a list of jobs and their blocks,
//     a 128 x 128 output tile and a depth part each, from the plan), depth =
//     the batch's rows (131072 at 64 points and batch 32), 3xTF32; a third
//     launch sums the parts in order.  No per-cloud partials of the weights;
//   - a batch whose tape the card should not hold at once runs in tiles of
//     clouds (the wrapper's plan, `PackedNet.k2_tiles`, as the JAX package's
//     backward runs its batch over a sequential grid): one call of the entry
//     point per tile, in order, each over its own clouds' rows and a tape the
//     size of a tile; the parts' sum of every tile after the first adds to
//     d(flat), so the tiles' weight gradients sum in a fixed order;
//   - deterministic: no atomics; every sum in a fixed order; two launches
//     give equal results.  kNN picks are recomputed from the distances
//     (rounded as K1 rounds them) and carry no gradient; the clamps (the
//     distances at 0, the GroupNorm variance at 0) pass 0.5 at the tie;
//   - control flow around every barrier depends only on the tables; a
//     product out of the stream's order, or a wait over 2^32 cycles, traps.

#include <cuda_runtime.h>
#include <climits>
#include <cmath>
#include <cstdint>

#include "fused_common.cuh"

namespace {

using namespace slide_fused;

// K2's per-block constants, in shared memory after the ring's barriers and
// the Plan (every thread reads them there).
struct Bwd {
    const Spec* sp;     // the tables' copies in shared memory
    const Spec2* s2;
    float* tape;        // this cloud's tape
    const float* g;     // this cloud's cotangent (n x out_dim)
    const float* t4;    // this cloud's embeddings
    const float* cls;
    int size;           // floats of the weights (the transposed copy follows)
};

static_assert((2 * kStages + 1) * 8 + sizeof(Plan) + sizeof(Bwd) <= 512,
              "the ring's barriers, the Plan and K2's constants fit in 128 floats");

// Gradient of max(a, 0) with respect to a: 1 above, 0.5 at the tie, 0 below.
__device__ __forceinline__ float clamp_grad(float a) {
    return a > 0.0f ? 1.0f : (a == 0.0f ? 0.5f : 0.0f);
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

// The product with dense d on the block's R rows of A (device memory, stride
// lda), or with its transpose (kT: d input = dY W^T, over the transposed
// copy): the stream's next entry, else the kernel traps.
template <int CL>
__device__ void dense(Ctx& cx, const Bwd& bw, const Dense& d, bool kT, const float* A, int lda,
                      int R, const Out& o) {
    const int cin = kT ? d.cout : d.cin, cout = kT ? d.cin : d.cout;
    const Stream st = next_product(cx, kT ? bw.size + d.w : d.w, cin, cout, R);
    const float* bias = !kT && d.b >= 0 ? cx.pl->w + d.b : nullptr;
    // the fewest tiles per warp that cover the width (8 warps x 8 columns)
    const int ntw = (cout + 63) / 64;
    if (st.mt == 2) {
        if (ntw <= 1) gemm_t<2, 1, false, CL>(cx, st, bias, A, 0, lda, R, o);
        else if (ntw <= 2) gemm_t<2, 2, false, CL>(cx, st, bias, A, 0, lda, R, o);
        else if (ntw <= 4) gemm_t<2, 4, false, CL>(cx, st, bias, A, 0, lda, R, o);
        else gemm_t<2, 8, false, CL>(cx, st, bias, A, 0, lda, R, o);
    } else {
        if (ntw <= 1) gemm_t<1, 1, false, CL>(cx, st, bias, A, 0, lda, R, o);
        else if (ntw <= 2) gemm_t<1, 2, false, CL>(cx, st, bias, A, 0, lda, R, o);
        else if (ntw <= 4) gemm_t<1, 4, false, CL>(cx, st, bias, A, 0, lda, R, o);
        else if (ntw <= 8) gemm_t<1, 8, false, CL>(cx, st, bias, A, 0, lda, R, o);
        else gemm_t<1, 16, false, CL>(cx, st, bias, A, 0, lda, R, o);
    }
}

// Where a product writes: rows of stride ld, from column col; rep copies of
// each row (a point's value to its slots); relu after the bias; `acc` adds;
// `stats` forms the following GroupNorm's sums.
__device__ __forceinline__ Out out_to(float* p, int ld, int col = 0, int rep = 1,
                                      bool relu = false, bool acc = false, bool stats = false) {
    return Out{p, ld, col, rep, relu, acc, false, stats};
}

// ---------------------------------------------------------------------------
// The recompute

// The injection vector v . W + b into shared memory (vecs), every block all
// of it; v is the cloud's embedding.
__device__ __noinline__ void gemv(Ctx& cx, const Bwd& bw, const Dense& d, const float* v) {
    const int K = d.cin, C = d.cout;
    const float* __restrict__ W = cx.pl->w + d.w;
    float* vec = fused_smem + bw.s2->vecs;
    if (C >= kCompute) {
        for (int c = TID; c < C; c += kCompute) {
            float acc = 0.0f;
#pragma unroll 8
            for (int k = 0; k < K; ++k) acc = fmaf(__ldg(v + k), __ldg(W + (size_t)k * C + c), acc);
            vec[c] = d.b >= 0 ? acc + __ldg(cx.pl->w + d.b + c) : acc;
        }
        compute_sync();
        return;
    }
    // fewer outputs than threads: S threads per output, each over a part of
    // the depth, summed in order
    float* part = fused_smem + bw.s2->cs;
    const int S = kCompute / C, sub = TID / C, c = TID - sub * C;
    if (sub < S) {
        const int a = sub * K / S, e = (sub + 1) * K / S;
        float acc = 0.0f;
#pragma unroll 8
        for (int k = a; k < e; ++k) acc = fmaf(__ldg(v + k), __ldg(W + (size_t)k * C + c), acc);
        part[sub * C + c] = acc;
    }
    compute_sync();
    if (TID < C) {
        float s = 0.0f;
        for (int q = 0; q < S; ++q) s += part[q * C + TID];
        vec[TID] = d.b >= 0 ? s + __ldg(cx.pl->w + d.b + TID) : s;
    }
    compute_sync();
}

// Tail GroupNorm of x (the block's R rows, stride C; the cloud has Rc rows)
// into a, relu after it if asked, and a + the injection vector into h
// (`vec`).  The per-column sums of x over the block's rows are in the red
// table (the product that wrote x); per group they meet across the cluster
// in rank order.  The statistics (mean, inverse std, variance before the
// clip) go to the tape at st (from block 0).
template <int CL>
__device__ __noinline__ void gn_fwd(Ctx& cx, const Bwd& bw, const float* x, float* a, float* h,
                                    float* st, int R, int Rc, int C, const Norm& nd, bool relu,
                                    bool vec) {
    const Spec2& s2 = *bw.s2;
    const int G = nd.g, cn = C - C % G, gs = cn / G;
    float* part = part_slot(cx, s2.part);
    float* red = fused_smem + s2.red;
    if (TID < G) {
        float gsum = 0.0f, gsum2 = 0.0f;
        for (int c = TID * gs; c < (TID + 1) * gs; ++c) {
            gsum += red[2 * c];
            gsum2 += red[2 * c + 1];
        }
        part[TID] = gsum;
        part[kMaxGroups + TID] = gsum2;
    }
    cluster_arrive_wait<CL>(cx);
    for (int c = TID; c < 2 * C; c += kCompute) red[c] = 0.0f;
    float* gn = fused_smem + s2.gn;
    if (TID < G) {
        const float2 q = cluster_pair_sum<CL>(part, TID);
        const float cnt = static_cast<float>(Rc * gs);
        const float m = q.x / cnt;
        const float var = q.y / cnt - m * m;
        const float inv = 1.0f / sqrtf(fmaxf(var, 0.0f) + 1e-5f);
        gn[TID] = m;
        gn[kMaxGroups + TID] = inv;
        if (cx.pl->rank == 0) {
            st[TID] = m;
            st[kMaxGroups + TID] = inv;
            st[2 * kMaxGroups + TID] = var;
        }
    }
    compute_sync();
    const float* w = cx.pl->w;
    const float* vv = fused_smem + s2.vecs;
    for (int e = TID; e < R * C; e += kCompute) {
        const int c = e % C;
        float v = x[e];
        if (c < cn) {
            const int gi = c / gs;
            v = (v - gn[gi]) * gn[kMaxGroups + gi] * __ldg(w + nd.s + c) + __ldg(w + nd.b + c);
        }
        if (relu) v = fmaxf(v, 0.0f);
        a[e] = v;
        if (vec) h[e] = v + vv[c];
    }
    compute_sync();
}

// InjectionMLP on the block's rows (kf rows a point) of the tape's xoff
// rows; its output goes to the tape (m.out).
template <int CL>
__device__ __noinline__ void mlp_fwd(Ctx& cx, const Bwd& bw, const Mlp& m, int xoff, int kf) {
    const int R = cx.pl->Pr * kf, Rc = cx.pl->n * kf, row0 = cx.pl->pt0 * kf;
    float* T = bw.tape;
    const int c0 = m.conv[0].cin;
    int in = xoff, ldin = c0;
    for (int l = 0; l < m.n_layers; ++l) {
        const Dense& cv = m.conv[l];
        const int cout = cv.cout;
        float* z = T + m.z[l] + (size_t)row0 * cout;
        dense<CL>(cx, bw, cv, false, T + in + (size_t)row0 * ldin, ldin, R,
                  out_to(z, cout, 0, 1, false, false, true));
        const bool it = l == 0 && m.inject_t, ic = l == 1 && m.inject_c;
        if (it) gemv(cx, bw, m.fc_t, bw.t4);
        if (ic) gemv(cx, bw, m.fc_c, bw.cls);
        gn_fwd<CL>(cx, bw, z, T + m.a[l] + (size_t)row0 * cout, T + m.h[l] + (size_t)row0 * cout,
                   T + m.st[l], R, Rc, cout, m.norm[l], true, it || ic);
        in = it || ic ? m.h[l] : m.a[l];
        ldin = cout;
    }
    const int cl = m.conv[m.n_layers - 1].cout;
    float* out = T + m.out + (size_t)row0 * cl;
    const float* src = T + in + (size_t)row0 * cl;
    const float* x = T + xoff + (size_t)row0 * c0;
    for (int e = TID; e < R * cl; e += kCompute)
        out[e] = m.res == 2 ? src[e] : src[e] + x[e];
    compute_sync();
    if (m.res == 2)
        dense<CL>(cx, bw, m.res_conv, false, x, c0, R, out_to(out, cl, 0, 1, false, true));
}

// AttentionPool with every slot valid, on the block's points: feat (the
// level's features, stride fld), grouped and value (the tape's rows); the
// pooled features go to dst (the block's rows, stride dld).
template <int CL>
__device__ __noinline__ void att_fwd(Ctx& cx, const Bwd& bw, const Att& a, int feat, int fld,
                                     int grouped, int value, int k, float* dst, int dld) {
    const int Pr = cx.pl->Pr, pt0 = cx.pl->pt0;
    const int R = Pr * k, Rc = cx.pl->n * k, row0 = pt0 * k;
    const int c1 = a.feat_conv.cout, ct = a.w_conv_1.cin;
    const int inter = a.w_conv_1.cout, co = a.w_conv_2.cout;
    const int gcin = a.grouped_conv.cin, vcin = a.out_conv.cin;
    float* T = bw.tape;
    float* t = T + a.t + (size_t)row0 * ct;
    float* tn = T + a.tn + (size_t)row0 * ct;
    float* u = T + a.u + (size_t)row0 * inter;
    float* un = T + a.un + (size_t)row0 * inter;
    float* s = T + a.s + (size_t)row0 * co;
    float* v = T + a.v + (size_t)row0 * co;
    float* vn = T + a.vn + (size_t)row0 * co;
    float* wt = T + a.w + (size_t)row0 * co;
    dense<CL>(cx, bw, a.grouped_conv, false, T + grouped + (size_t)row0 * gcin, gcin, R,
              out_to(t, ct, c1, 1, true, false, true));
    dense<CL>(cx, bw, a.feat_conv, false, T + feat + (size_t)pt0 * fld, fld, Pr,
              out_to(t, ct, 0, k, true, false, true));
    gn_fwd<CL>(cx, bw, t, tn, nullptr, T + a.st1, R, Rc, ct, a.w_norm_1, false, false);
    dense<CL>(cx, bw, a.w_conv_1, false, tn, ct, R, out_to(u, inter, 0, 1, true, false, true));
    gn_fwd<CL>(cx, bw, u, un, nullptr, T + a.st2, R, Rc, inter, a.w_norm_2, false, false);
    dense<CL>(cx, bw, a.w_conv_2, false, un, inter, R, out_to(s, co));
    dense<CL>(cx, bw, a.out_conv, false, T + value + (size_t)row0 * vcin, vcin, R,
              out_to(v, co, 0, 1, false, false, true));
    gn_fwd<CL>(cx, bw, v, vn, nullptr, T + a.st3, R, Rc, co, a.out_norm, true, false);
    // softmax over each point's k slots, per channel, max-shifted
    for (int e = TID; e < Pr * co; e += kCompute) {
        const int il = e / co, c = e - il * co;
        const size_t base = (size_t)il * k * co + c;
        float mx = s[base];
        for (int j = 1; j < k; ++j) mx = fmaxf(mx, s[base + (size_t)j * co]);
        float sum = 0.0f;
        for (int j = 0; j < k; ++j) sum += expf(s[base + (size_t)j * co] - mx);
        float acc = 0.0f;
        for (int j = 0; j < k; ++j) {
            const size_t r = base + (size_t)j * co;
            const float w = expf(s[r] - mx) / sum;
            wt[r] = w;
            acc += vn[r] * w;
        }
        dst[(size_t)il * dld + c] = acc;
    }
    compute_sync();
}

// K1's kNN for every point of the cloud (each block all of them, a thread a
// point): fused_common.cuh's knn_row over its distance row.
static_assert(kMaxN <= kCompute, "knn_all: a compute thread per point");
__device__ __noinline__ void knn_all(const Bwd& bw, int n, int k) {
    const Spec2& s2 = *bw.s2;
    const float* dist = fused_smem + s2.dist;
    int* knn = reinterpret_cast<int*>(fused_smem + s2.knn);
    if (TID < n) knn_row(dist + TID * n, n, k, knn + TID * s2.kmax);
    compute_sync();
}

__device__ __forceinline__ int pick(const Bwd& bw, int i, int s, bool full) {
    return full ? s : reinterpret_cast<const int*>(fused_smem + bw.s2->knn)[i * bw.s2->kmax + s];
}

// SA grouping [feat, rel, abs?, center?] of the block's rows into X (K1's
// group_sa); feat is the level's features (every block's: read from L2).
__device__ __noinline__ void group_sa(Ctx& cx, const Bwd& bw, const float* feat, float* X, int cf,
                                      int k, bool full) {
    const Spec& sp = *bw.sp;
    const bool inc_abs = sp.inc_abs, inc_cen = sp.inc_cen;
    const int cgw = cf + 3 + 3 * int(inc_abs) + 3 * int(inc_cen);
    const float* xyz = fused_smem + bw.s2->xyz;
    for (int e = TID; e < cx.pl->Pr * k * cgw; e += kCompute) {
        const int r = e / cgw, c = e - r * cgw;
        const int il = r / k, s = r - il * k, i = cx.pl->pt0 + il;
        const int j = pick(bw, i, s, full);
        float v;
        if (c < cf) {
            v = __ldcg(feat + (size_t)j * cf + c);
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
    compute_sync();
}

// KnnFP grouping [feat, dist, weight, abs, rel, center] (K1's group_knn).
__device__ __noinline__ void group_knn(Ctx& cx, const Bwd& bw, const float* feat, float* X,
                                       int cf, int k) {
    const Spec2& s2 = *bw.s2;
    const int cgw = cf + 11, n = cx.pl->n;
    const float* xyz = fused_smem + s2.xyz;
    const float* dist = fused_smem + s2.dist;
    const int* knn = reinterpret_cast<const int*>(fused_smem + s2.knn);
    for (int e = TID; e < cx.pl->Pr * k * cgw; e += kCompute) {
        const int r = e / cgw, c = e - r * cgw;
        const int il = r / k, s = r - il * k, i = cx.pl->pt0 + il;
        const int j = knn[i * s2.kmax + s];
        float v;
        if (c < cf) {
            v = __ldcg(feat + (size_t)j * cf + c);
        } else if (c == cf) {
            v = dist[i * n + j];
        } else if (c == cf + 1) {
            float sum = 0.0f;
            for (int q = 0; q < k; ++q) sum += 1.0f / (dist[i * n + knn[i * s2.kmax + q]] + 1e-8f);
            v = (1.0f / (dist[i * n + j] + 1e-8f)) / sum;
        } else {
            const int q = c - cf - 2;
            if (q < 3) v = xyz[j * 3 + q];
            else if (q < 6) v = xyz[j * 3 + q - 3] - xyz[i * 3 + q - 3];
            else v = xyz[i * 3 + q - 6];
        }
        X[e] = v;
    }
    compute_sync();
}

// ---------------------------------------------------------------------------
// The backward

// GroupNorm backward on the block's R rows (stride C): dy, masked by pre > 0
// where given (a relu after the GroupNorm), becomes dx, written over x (the
// GroupNorm's input), masked by x > 0 when `post` (a relu before it).  The
// per-column sums over the block's rows of dy and dy (x - mean) give this
// block's row of d scale / d bias (the tape at nd.p, for the weight-gradient
// launch) and, per group and met across the cluster in rank order, the sums
// of dx^ and dx^ (x - mean) that dx needs.
template <int CL>
__device__ __noinline__ void gn_bwd(Ctx& cx, const Bwd& bw, const float* dy, const float* pre,
                                    float* x, const float* st, int R, int Rc, int C,
                                    const Norm& nd, bool post) {
    const Spec2& s2 = *bw.s2;
    const int G = nd.g, cn = C - C % G, gs = cn / G;
    const float* w = cx.pl->w;
    float* gn = fused_smem + s2.gn;   // mean, inverse std, variance, sum dx^, sum dx^ (x - mean)
    if (TID < G) {
        gn[TID] = __ldcg(st + TID);
        gn[kMaxGroups + TID] = __ldcg(st + kMaxGroups + TID);
        gn[2 * kMaxGroups + TID] = __ldcg(st + 2 * kMaxGroups + TID);
    }
    compute_sync();
    // per column: sums over the block's rows of dy and dy (x - mean); a
    // chunk of cw <= 256 columns at a time, rpt = 256 / cw threads per column
    // each over every rpt-th row, their partials (in vecs) summed in order
    float* cs = fused_smem + s2.cs;
    float* pp = fused_smem + s2.vecs;
    float* prow = bw.tape + nd.p + (size_t)cx.pl->rank * 2 * C;
    for (int c0 = 0; c0 < cn; c0 += kCompute) {
        const int cw = min(kCompute, cn - c0), rpt = kCompute / cw;
        const int q = TID / cw, c = c0 + TID - q * cw;
        if (q < rpt) {
            const int gi = c / gs;
            const float m = gn[gi];
            float s1 = 0.0f, s2_ = 0.0f;
            for (int r = q; r < R; r += rpt) {
                float d = dy[(size_t)r * C + c];
                if (pre && !(pre[(size_t)r * C + c] > 0.0f)) d = 0.0f;
                s1 += d;
                s2_ = fmaf(d, x[(size_t)r * C + c] - m, s2_);
            }
            pp[q * cw + c - c0] = s1;
            pp[kMaxVec / 2 + q * cw + c - c0] = s2_;
        }
        compute_sync();
        if (TID < cw) {
            const int c = c0 + TID;
            float s1 = 0.0f, s2_ = 0.0f;
            for (int u = 0; u < rpt; ++u) {
                s1 += pp[u * cw + TID];
                s2_ += pp[kMaxVec / 2 + u * cw + TID];
            }
            cs[c] = s1;
            cs[kMaxVec + c] = s2_;
            prow[c] = s2_ * gn[kMaxGroups + c / gs];
            prow[C + c] = s1;
        }
        compute_sync();
    }
    float* part = part_slot(cx, s2.part);
    if (TID < G) {
        float a = 0.0f, b = 0.0f;
        for (int c = TID * gs; c < (TID + 1) * gs; ++c) {
            const float sc = __ldg(w + nd.s + c);
            a = fmaf(sc, cs[c], a);
            b = fmaf(sc, cs[kMaxVec + c], b);
        }
        part[TID] = a;
        part[kMaxGroups + TID] = b;
    }
    cluster_arrive_wait<CL>(cx);
    if (TID < G) {
        const float2 q = cluster_pair_sum<CL>(part, TID);
        gn[3 * kMaxGroups + TID] = q.x;
        gn[4 * kMaxGroups + TID] = q.y;
    }
    compute_sync();
    const float cnt = static_cast<float>(Rc * gs);
    for (int e = TID; e < R * C; e += kCompute) {
        const int c = e % C;
        float d = dy[e];
        if (pre && !(pre[e] > 0.0f)) d = 0.0f;
        const float xv = x[e];
        float v = d;                                  // the tail passes through
        if (c < cn) {
            const int gi = c / gs;
            const float inv = gn[kMaxGroups + gi];
            const float dxh = d * __ldg(w + nd.s + c);
            const float dvar = gn[4 * kMaxGroups + gi] * (-0.5f * inv * inv * inv) *
                               clamp_grad(gn[2 * kMaxGroups + gi]);
            v = dxh * inv +
                (2.0f * dvar * (xv - gn[gi]) - inv * gn[3 * kMaxGroups + gi]) / cnt;
        }
        if (post && !(xv > 0.0f)) v = 0.0f;
        x[e] = v;
    }
    compute_sync();
}

// d of an injection: d v += W . dvec on this block's share of v (the cloud's
// t or class embedding; gv its gradient), dvec the blocks' rows at dv summed
// in rank order.  After a cluster-wide arrival that follows the rows.
template <int CL>
__device__ __noinline__ void inject_bwd(Ctx& cx, const Bwd& bw, const Dense& fc, int dv, float* gv) {
    const int C = fc.cout, K = fc.cin;
    float* vec = fused_smem + bw.s2->vecs;
    for (int c = TID; c < C; c += kCompute) {
        float s = 0.0f;
        for (int r = 0; r < CL; ++r) s += __ldcg(bw.tape + dv + (size_t)r * C + c);
        vec[c] = s;
    }
    compute_sync();
    const float* __restrict__ W = cx.pl->w + fc.w;
    const int kb = cx.pl->rank * K / CL, ke = (cx.pl->rank + 1) * K / CL;
    for (int i = kb + TID; i < ke; i += kCompute) {
        float s = 0.0f;
        for (int c = 0; c < C; ++c) s = fmaf(__ldg(W + (size_t)i * C + c), vec[c], s);
        gv[i] += s;
    }
    compute_sync();
}

// InjectionMLP backward on the block's rows: d(out) is the tape's m.dout;
// dx (the block's rows of the input's gradient, stride c0) is written
// (acc_dx false) or added to; P is a free row buffer.  Each conv's dY is
// left over its z.
template <int CL>
__device__ __noinline__ void mlp_bwd(Ctx& cx, const Bwd& bw, const Mlp& m, int kf, float* dx,
                                     bool acc_dx, float* P) {
    const int R = cx.pl->Pr * kf, Rc = cx.pl->n * kf, row0 = cx.pl->pt0 * kf;
    const int L = m.n_layers, c0 = m.conv[0].cin, cl = m.conv[L - 1].cout;
    float* T = bw.tape;
    const float* dout = T + m.dout + (size_t)row0 * cl;
    if (m.res == 2) {
        dense<CL>(cx, bw, m.res_conv, true, dout, cl, R, out_to(dx, c0, 0, 1, false, acc_dx));
    } else {
        for (int e = TID; e < R * cl; e += kCompute) dx[e] = acc_dx ? dx[e] + dout[e] : dout[e];
        compute_sync();
    }
    const float* dy = dout;
    float* gt4 = T + bw.s2->gvec;
    for (int l = L - 1; l >= 0; --l) {
        const Dense& cv = m.conv[l];
        const int cout = cv.cout;
        const bool it = l == 0 && m.inject_t, ic = l == 1 && m.inject_c;
        if (it || ic) {
            // this block's row of d(injection vector): the column sums of dy
            float* row = T + (it ? m.dvt : m.dvc) + (size_t)cx.pl->rank * cout;
            for (int c = TID; c < cout; c += kCompute) {
                float s = 0.0f;
                for (int r = 0; r < R; ++r) s += dy[(size_t)r * cout + c];
                row[c] = s;
            }
        }
        float* z = T + m.z[l] + (size_t)row0 * cout;
        gn_bwd<CL>(cx, bw, dy, T + m.a[l] + (size_t)row0 * cout, z, T + m.st[l], R, Rc, cout,
                   m.norm[l], false);
        if (it) inject_bwd<CL>(cx, bw, m.fc_t, m.dvt, gt4);
        if (ic) inject_bwd<CL>(cx, bw, m.fc_c, m.dvc, gt4 + bw.sp->t4);
        if (l == 0) {
            dense<CL>(cx, bw, cv, true, z, cout, R, out_to(dx, c0, 0, 1, false, true));
        } else {
            dense<CL>(cx, bw, cv, true, z, cout, R, out_to(P, cv.cin));
            dy = P;
        }
    }
}

// AttentionPool backward on the block's points.  dout (the block's points'
// rows, stride dld); dfeat (stride fld) is added to; dgrouped (stride of the
// grouped rows) and dvalue (the tape's rows) are written; Q1-Q3 are free
// row buffers.  The products' dY are left over s, v, u and t, and in df.
template <int CL>
__device__ __noinline__ void att_bwd(Ctx& cx, const Bwd& bw, const Att& a, int k,
                                     const float* dout, int dld, float* dfeat, int fld,
                                     float* dgrouped, float* dvalue, float* Q1, float* Q2,
                                     float* Q3) {
    const int Pr = cx.pl->Pr, pt0 = cx.pl->pt0;
    const int R = Pr * k, Rc = cx.pl->n * k, row0 = pt0 * k;
    const int c1 = a.feat_conv.cout, ct = a.w_conv_1.cin;
    const int inter = a.w_conv_1.cout, co = a.w_conv_2.cout;
    float* T = bw.tape;
    float* t = T + a.t + (size_t)row0 * ct;
    float* u = T + a.u + (size_t)row0 * inter;
    float* s = T + a.s + (size_t)row0 * co;
    float* v = T + a.v + (size_t)row0 * co;
    const float* vn = T + a.vn + (size_t)row0 * co;
    const float* wt = T + a.w + (size_t)row0 * co;
    // the pooled sum and the softmax over slots: d vn into Q1, d scores over s
    for (int e = TID; e < Pr * co; e += kCompute) {
        const int il = e / co, c = e - il * co;
        const size_t base = (size_t)il * k * co + c;
        const float go = dout[(size_t)il * dld + c];
        float swd = 0.0f;
        for (int j = 0; j < k; ++j) {
            const size_t r = base + (size_t)j * co;
            const float w = wt[r];
            Q1[r] = go * w;
            swd += w * (go * vn[r]);
        }
        for (int j = 0; j < k; ++j) {
            const size_t r = base + (size_t)j * co;
            s[r] = wt[r] * (go * vn[r] - swd);
        }
    }
    compute_sync();
    // value path: relu(GroupNorm(value W_out + b))
    gn_bwd<CL>(cx, bw, Q1, vn, v, T + a.st3, R, Rc, co, a.out_norm, false);
    dense<CL>(cx, bw, a.out_conv, true, v, co, R, out_to(dvalue, a.out_conv.cin));
    // scores: GroupNorm(relu(GroupNorm(relu([f1, g1])) W1)) W2
    dense<CL>(cx, bw, a.w_conv_2, true, s, co, R, out_to(Q3, inter));
    gn_bwd<CL>(cx, bw, Q3, nullptr, u, T + a.st2, R, Rc, inter, a.w_norm_2, true);
    dense<CL>(cx, bw, a.w_conv_1, true, u, inter, R, out_to(Q2, ct));
    gn_bwd<CL>(cx, bw, Q2, nullptr, t, T + a.st1, R, Rc, ct, a.w_norm_1, true);
    // f1 was broadcast over the k slots: sum them
    float* df = T + a.df + (size_t)pt0 * c1;
    for (int e = TID; e < Pr * c1; e += kCompute) {
        const int il = e / c1, c = e - il * c1;
        float sum = 0.0f;
        for (int j = 0; j < k; ++j) sum += t[(size_t)(il * k + j) * ct + c];
        df[e] = sum;
    }
    compute_sync();
    dense<CL>(cx, bw, a.feat_conv, true, df, c1, Pr, out_to(dfeat, fld, 0, 1, false, true));
    dense<CL>(cx, bw, a.grouped_conv, true, t + c1, ct, R,
              out_to(dgrouped, a.grouped_conv.cin));
}

// For each of the block's points p, the cloud's rows i k + s whose slot s of
// query i picked p, ascending (each query picks p at most once).
__device__ __noinline__ void pick_lists(Ctx& cx, const Bwd& bw, int k, bool full) {
    const int n = cx.pl->n;
    int* lists = reinterpret_cast<int*>(fused_smem + bw.s2->picks);
    if (TID < cx.pl->Pr) {
        const int p = cx.pl->pt0 + TID;
        int* list = lists + TID * (n + 1);
        int cnt = 0;
        for (int i = 0; i < n; ++i)
            for (int s = 0; s < k; ++s)
                if (pick(bw, i, s, full) == p) list[1 + cnt++] = i * k + s;
        list[0] = cnt;
    }
    compute_sync();
}

// d of the SA grouping for the block's points: their feature rows sum the
// rows that picked them (dX: the cloud's grouped rows' gradients, every
// block's, stride cgw); the coordinate channels into gxyz.
__device__ __noinline__ void group_sa_bwd(Ctx& cx, const Bwd& bw, const float* dX, int cf, int k,
                                          float* dfeat, float* gxyz) {
    const Spec& sp = *bw.sp;
    const bool inc_abs = sp.inc_abs, inc_cen = sp.inc_cen;
    const int cgw = cf + 3 + 3 * int(inc_abs) + 3 * int(inc_cen);
    const int cen = cf + 3 + 3 * int(inc_abs), n = cx.pl->n;
    const int* lists = reinterpret_cast<const int*>(fused_smem + bw.s2->picks);
    for (int e = TID; e < cx.pl->Pr * cf; e += kCompute) {
        const int il = e / cf, c = e - il * cf;
        const int* list = lists + il * (n + 1);
        float s = 0.0f;
        for (int q = 0; q < list[0]; ++q) s += __ldcg(dX + (size_t)list[1 + q] * cgw + c);
        dfeat[e] += s;
    }
    for (int e = TID; e < cx.pl->Pr * 3; e += kCompute) {
        const int il = e / 3, q = e - il * 3, p = cx.pl->pt0 + il;
        const int* list = lists + il * (n + 1);
        float s = 0.0f;
        for (int j = 0; j < list[0]; ++j) {
            const float* row = dX + (size_t)list[1 + j] * cgw;
            s += __ldcg(row + cf + q);
            if (inc_abs) s += __ldcg(row + cf + 3 + q);
        }
        for (int sl = 0; sl < k; ++sl) {
            const float* row = dX + (size_t)(p * k + sl) * cgw;
            s -= __ldcg(row + cf + q);
            if (inc_cen) s += __ldcg(row + cen + q);
        }
        gxyz[e] += s;
    }
    compute_sync();
}

// d of the KnnFP grouping for the block's points: features and coordinates
// as above; the distance and weight channels of the block's queries into
// gdist at (query, pick).
__device__ __noinline__ void group_knn_bwd(Ctx& cx, const Bwd& bw, const float* dX, int cf, int k,
                                           float* dfeat, float* gxyz, float* gdist) {
    const Spec2& s2 = *bw.s2;
    const int cgw = cf + 11, n = cx.pl->n;
    const int* lists = reinterpret_cast<const int*>(fused_smem + s2.picks);
    const int* knn = reinterpret_cast<const int*>(fused_smem + s2.knn);
    const float* dist = fused_smem + s2.dist;
    for (int e = TID; e < cx.pl->Pr * cf; e += kCompute) {
        const int il = e / cf, c = e - il * cf;
        const int* list = lists + il * (n + 1);
        float s = 0.0f;
        for (int q = 0; q < list[0]; ++q) s += __ldcg(dX + (size_t)list[1 + q] * cgw + c);
        dfeat[e] += s;
    }
    for (int e = TID; e < cx.pl->Pr * 3; e += kCompute) {
        const int il = e / 3, q = e - il * 3, p = cx.pl->pt0 + il;
        const int* list = lists + il * (n + 1);
        float s = 0.0f;
        for (int j = 0; j < list[0]; ++j) {
            const float* row = dX + (size_t)list[1 + j] * cgw + cf + 2;
            s += __ldcg(row + q) + __ldcg(row + 3 + q);
        }
        for (int sl = 0; sl < k; ++sl) {
            const float* row = dX + (size_t)(p * k + sl) * cgw + cf + 2;
            s += __ldcg(row + 6 + q) - __ldcg(row + 3 + q);
        }
        gxyz[e] += s;
    }
    // weight_t = recip_t / S, recip_t = 1 / (d_t + 1e-8), S = sum_t recip_t;
    // the picks of one query are distinct, so each (query, pick) is one thread's
    if (TID < cx.pl->Pr) {
        const int i = cx.pl->pt0 + TID;
        float S = 0.0f, swr = 0.0f;
        for (int t = 0; t < k; ++t) {
            const float rt = 1.0f / (dist[i * n + knn[i * s2.kmax + t]] + 1e-8f);
            S += rt;
            swr += __ldcg(dX + (size_t)(i * k + t) * cgw + cf + 1) * rt;
        }
        for (int t = 0; t < k; ++t) {
            const int j = knn[i * s2.kmax + t];
            const float rt = 1.0f / (dist[i * n + j] + 1e-8f);
            const float* row = dX + (size_t)(i * k + t) * cgw;
            const float drecip = __ldcg(row + cf + 1) / S - swr / (S * S);
            gdist[i * n + j] += __ldcg(row + cf) - drecip * (rt * rt);
        }
    }
    compute_sync();
}

// d of the distances max((|x|^2 + |y|^2) - 2<x, y>, 0) into the block's
// points' gxyz; gdist is every block's.
__device__ __noinline__ void dist_bwd(Ctx& cx, const Bwd& bw, const float* gdist, float* gxyz) {
    const int n = cx.pl->n;
    const float* xyz = fused_smem + bw.s2->xyz;
    for (int e = TID; e < cx.pl->Pr * 3; e += kCompute) {
        const int il = e / 3, q = e - il * 3, p = cx.pl->pt0 + il;
        const float* xp = xyz + 3 * p;
        float s = 0.0f;
        for (int j = 0; j < n; ++j) {
            if (j == p) continue;                  // d/dx of a self-distance is 0
            const float gsum = __ldcg(gdist + p * n + j) + __ldcg(gdist + j * n + p);
            if (gsum == 0.0f) continue;
            const float* xj = xyz + 3 * j;
            s += gsum * clamp_grad(sqdist_raw(xp, xj)) * 2.0f * (xp[q] - xj[q]);
        }
        gxyz[e] += s;
    }
    compute_sync();
}

// One cluster of CL blocks per cloud; kBlocks blocks per SM (the plan's).
template <int CL, int kBlocks>
__global__ void __launch_bounds__(block_threads<kBlocks>(), kBlocks)
fused_denoiser_bwd_kernel(const float* __restrict__ pc, const float* __restrict__ t4,
                          const float* __restrict__ cls, const float* __restrict__ gout,
                          const float* __restrict__ wts, const Spec* __restrict__ spec,
                          const Spec2* __restrict__ spec2, int size,
                          float* __restrict__ scratch, float* __restrict__ dpc,
                          float* __restrict__ dt4, float* __restrict__ dcls) {
    float* smem = fused_smem;
    const int tid = threadIdx.x;
    constexpr int threads = block_threads<kBlocks>();
    // both tables into shared memory (where the layout says)
    {
        const int toff = __ldg(&spec2->table), toff2 = __ldg(&spec2->table2);
        const int* src = reinterpret_cast<const int*>(spec);
        int* dst = reinterpret_cast<int*>(smem + toff);
        for (int e = tid; e < static_cast<int>(sizeof(Spec) / sizeof(int)); e += threads)
            dst[e] = __ldg(src + e);
        src = reinterpret_cast<const int*>(spec2);
        dst = reinterpret_cast<int*>(smem + toff2);
        for (int e = tid; e < static_cast<int>(sizeof(Spec2) / sizeof(int)); e += threads)
            dst[e] = __ldg(src + e);
    }
    __syncthreads();
    const Spec& sp = *reinterpret_cast<const Spec*>(smem + __ldg(&spec2->table));
    const Spec2& s2 = *reinterpret_cast<const Spec2*>(smem + __ldg(&spec2->table2));
    const int rank = static_cast<int>(cg::this_cluster().block_rank());
    const int b = blockIdx.x / CL;
    const int n = sp.n, din = sp.din, P = s2.pts;
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + s2.bars);
    uint64_t* full = bars;
    uint64_t* empty = bars + kStages;
    uint64_t* arrive = bars + 2 * kStages;
    float* ring = smem + s2.ring;
    if (tid == 0) {
        for (int s = 0; s < kStages; ++s) {
            mbar_init(full + s, 1);
            mbar_init(empty + s, CL * (kCompute / 32));
        }
        mbar_init(arrive, CL);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    // the ring starts zeroed (a product reads whole 8-row steps of a stage;
    // rows past its depth meet zeros in A, and must be finite); the
    // products' column sums for GroupNorm start from 0
    for (int e = tid; e < kStages * s2.stage; e += threads) ring[e] = 0.0f;
    for (int e = s2.red + tid; e < s2.vecs; e += threads) smem[e] = 0.0f;
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    const int pt0 = min(rank * P, n), Pr = min(P, n - pt0);
    float* tape = scratch + (size_t)b * s2.bwd_floats;
    // every block keeps all points' xyz and distances (rounded as the plain
    // version rounds them); level 0 = [pc[:, 3:], xyz] of its own points
    const float* p = pc + (size_t)b * n * din;
    {
        float* xyz = smem + s2.xyz;
        for (int e = tid; e < n * 3; e += threads) xyz[e] = p[(e / 3) * din + e % 3];
        float* l0 = tape + s2.flvl[0];
        for (int e = tid; e < Pr * din; e += threads) {
            const int il = e / din, c = e - il * din, i = pt0 + il;
            l0[(size_t)i * din + c] = c < din - 3 ? p[i * din + 3 + c] : p[i * din + c - (din - 3)];
        }
        __syncthreads();
        float* dist = smem + s2.dist;
        for (int e = tid; e < n * n; e += threads) {
            const int i = e / n, j = e - i * n;
            dist[e] = fmaxf(sqdist_raw(xyz + 3 * i, xyz + 3 * j), 0.0f);
        }
    }
    cluster_sync_all();   // barriers initialised, level 0 written, in every block

    Plan* plan = reinterpret_cast<Plan*>(bars + 2 * kStages + 1);
    Bwd* bwp = reinterpret_cast<Bwd*>(plan + 1);
    if (tid == 0) {
        plan->sp = &sp;
        plan->stream = s2.stream;
        plan->w = wts;
        plan->gblk = nullptr;
        plan->vpart = nullptr;
        plan->full = full;
        plan->empty = empty;
        plan->arrive = arrive;
        plan->ring_off = s2.ring;
        plan->stage = s2.stage;
        plan->nst = s2.n_stream;
        plan->red_off = s2.red;
        plan->rank = rank;
        plan->n = n;
        plan->P = P;
        plan->Pr = Pr;
        plan->pt0 = pt0;
        plan->pj = 0;
        plan->pe = plan->pp = plan->pk = 0;
        bwp->sp = &sp;
        bwp->s2 = &s2;
        bwp->tape = tape;
        bwp->g = gout + (size_t)b * n * sp.out_dim;
        bwp->t4 = t4 + (size_t)b * sp.t4;
        bwp->cls = cls + (size_t)b * sp.cls;
        bwp->size = size;
    }
    __syncthreads();
    Ctx cx;
    cx.pl = plan;
    cx.j = 0;
    cx.na = 0;
    cx.pos = 0;
    if (tid >= kCompute) {
        if (kBlocks == 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 80;" ::: "memory");
        if (tid == kCompute) produce<CL>(cx);
        cluster_sync_all();
        return;
    }
    if (kBlocks == 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 208;" ::: "memory");
    const Bwd& bw = *bwp;
    const float* xyz = smem + s2.xyz;
    int lw[kMaxLevels + 1];     // widths of the SA levels' features F_l
    int lg[kMaxLevels + 1];     // widths of the KnnFP levels' features G_l
    lw[0] = din;

    // ---- the recompute, keeping the tape (K1's order of work)
    for (int l = 0; l < sp.n_sa; ++l) {
        const SA& s = sp.sa[l];
        const int k = s.k, cgw = s.mlp.conv[0].cin;
        if (k < n) knn_all(bw, n, k);
        group_sa(cx, bw, tape + s2.flvl[l], tape + s.x + (size_t)pt0 * k * cgw, lw[l], k, k == n);
        mlp_fwd<CL>(cx, bw, s.mlp, s.x, k);
        const int co = s.att.w_conv_2.cout;
        att_fwd<CL>(cx, bw, s.att, s2.flvl[l], lw[l], s.x, s.mlp.out, k,
                    tape + s2.flvl[l + 1] + (size_t)pt0 * co, co);
        lw[l + 1] = co;
        cluster_arrive_wait<CL>(cx);   // level l + 1 visible to the next grouping
    }
    lg[sp.n_fp] = lw[sp.n_fp];
    for (int l = sp.n_fp - 1; l >= 0; --l) {
        const FP& f = sp.fp[l];
        const int k = f.k, cgw = f.mlp1.conv[0].cin;
        knn_all(bw, n, k);
        const int src = l + 1 == sp.n_fp ? s2.flvl[l + 1] : sp.fp[l + 1].mlp2.out;
        group_knn(cx, bw, tape + src, tape + f.x + (size_t)pt0 * k * cgw, lg[l + 1], k);
        mlp_fwd<CL>(cx, bw, f.mlp1, f.x, k);
        const int ci = f.att.w_conv_2.cout, cs = lw[l], cn = ci + cs + 3;
        float* nf = tape + f.nf + (size_t)pt0 * cn;
        att_fwd<CL>(cx, bw, f.att, s2.flvl[l], lw[l], f.x, f.mlp1.out, k, nf, cn);
        const float* fl = tape + s2.flvl[l] + (size_t)pt0 * cs;
        for (int e = tid; e < Pr * (cs + 3); e += kCompute) {
            const int il = e / (cs + 3), c = e - il * (cs + 3);
            nf[il * cn + ci + c] = c < cs ? fl[il * cs + c] : xyz[(pt0 + il) * 3 + c - cs];
        }
        compute_sync();
        mlp_fwd<CL>(cx, bw, f.mlp2, f.nf, 1);
        lg[l] = f.mlp2.conv[f.mlp2.n_layers - 1].cout;
        cluster_arrive_wait<CL>(cx);   // level l visible to the next grouping
    }
    // head: [G_0, xyz] -> conv -> GN -> relu (-> conv)
    const int src0 = sp.n_fp > 0 ? sp.fp[0].mlp2.out : s2.flvl[0];
    const int w0 = sp.n_fp > 0 ? lg[0] : lw[0];
    const int hw = w0 + 3, hc = sp.head1.cout;
    float* hin = tape + s2.hin + (size_t)pt0 * hw;
    float* hz = tape + s2.hz + (size_t)pt0 * hc;
    float* ha = tape + s2.ha + (size_t)pt0 * hc;
    for (int e = tid; e < Pr * hw; e += kCompute) {
        const int il = e / hw, c = e - il * hw;
        hin[e] = c < w0 ? tape[src0 + (size_t)(pt0 + il) * w0 + c] : xyz[(pt0 + il) * 3 + c - w0];
    }
    compute_sync();
    dense<CL>(cx, bw, sp.head1, false, hin, hw, Pr, out_to(hz, hc, 0, 1, false, false, true));
    gn_fwd<CL>(cx, bw, hz, ha, nullptr, tape + s2.hst, Pr, n, hc, sp.head_norm, true, false);

    // ---- the backward: the block's rows of the accumulators start at 0
    float* gxyz = tape + s2.gxyz + (size_t)pt0 * 3;
    float* gdist = tape + s2.gdist;
    float* gt4 = tape + s2.gvec;
    for (int l = 0; l <= sp.n_sa; ++l)
        for (int e = tid; e < Pr * lw[l]; e += kCompute)
            tape[s2.gf[l] + (size_t)pt0 * lw[l] + e] = 0.0f;
    for (int l = 0; l < sp.n_fp; ++l)
        for (int e = tid; e < Pr * lg[l]; e += kCompute)
            tape[sp.fp[l].mlp2.dout + (size_t)pt0 * lg[l] + e] = 0.0f;
    for (int e = tid; e < Pr * n; e += kCompute) gdist[(size_t)pt0 * n + e] = 0.0f;
    for (int e = tid; e < Pr * 3; e += kCompute) gxyz[e] = 0.0f;
    for (int i = rank * sp.t4 / CL + tid; i < (rank + 1) * sp.t4 / CL; i += kCompute) gt4[i] = 0.0f;
    for (int i = rank * sp.cls / CL + tid; i < (rank + 1) * sp.cls / CL; i += kCompute)
        gt4[sp.t4 + i] = 0.0f;
    compute_sync();
    // the row buffers: a block's rows start at its first row x gld (any
    // width up to gld); gbuf[3], whose rows the other blocks read, holds the
    // cloud's grouped rows in order at their own width
    float* gbuf[kGradBuffers];
    for (int i = 0; i < kGradBuffers; ++i) gbuf[i] = tape + s2.gbuf[i];
    const size_t gld = s2.gld;

    // head
    {
        float* d0 = gbuf[0] + pt0 * gld;
        float* d1 = gbuf[1] + pt0 * gld;
        dense<CL>(cx, bw, sp.head_out, true, bw.g + (size_t)pt0 * sp.out_dim, sp.out_dim, Pr,
                  out_to(d0, hc));
        gn_bwd<CL>(cx, bw, d0, ha, hz, tape + s2.hst, Pr, n, hc, sp.head_norm, false);
        dense<CL>(cx, bw, sp.head1, true, hz, hc, Pr, out_to(d1, hw));
        float* g0 = tape + (sp.n_fp > 0 ? sp.fp[0].mlp2.dout : s2.gf[0]) + (size_t)pt0 * w0;
        for (int e = tid; e < Pr * w0; e += kCompute) g0[e] += d1[(e / w0) * hw + e % w0];
        for (int e = tid; e < Pr * 3; e += kCompute) gxyz[e] += d1[(e / 3) * hw + w0 + e % 3];
        compute_sync();
    }

    for (int l = 0; l < sp.n_fp; ++l) {
        const FP& f = sp.fp[l];
        const int k = f.k, cgw = f.mlp1.conv[0].cin, row0 = pt0 * k;
        const int ci = f.att.w_conv_2.cout, cs = lw[l], cn = ci + cs + 3;
        float* dnf = gbuf[4] + pt0 * gld;
        float* dint = gbuf[5] + pt0 * gld;
        float* gfl = tape + s2.gf[l] + (size_t)pt0 * cs;
        mlp_bwd<CL>(cx, bw, f.mlp2, 1, dnf, false, gbuf[0] + pt0 * gld);
        for (int e = tid; e < Pr * cn; e += kCompute) {
            const int il = e / cn, c = e - il * cn;
            const float v = dnf[e];
            if (c < ci) dint[il * ci + c] = v;
            else if (c < ci + cs) gfl[il * cs + c - ci] += v;
            else gxyz[il * 3 + c - ci - cs] += v;
        }
        compute_sync();
        float* dg = gbuf[3] + (size_t)row0 * cgw;
        att_bwd<CL>(cx, bw, f.att, k, dint, ci, gfl, cs, dg,
                    tape + f.mlp1.dout + (size_t)row0 * f.att.out_conv.cin, gbuf[0] + row0 * gld,
                    gbuf[2] + row0 * gld, gbuf[1] + row0 * gld);
        mlp_bwd<CL>(cx, bw, f.mlp1, k, dg, true, gbuf[0] + row0 * gld);
        cluster_arrive_wait<CL>(cx);   // every block's grouped rows' gradients
        knn_all(bw, n, k);
        pick_lists(cx, bw, k, false);
        const int tgt = l + 1 == sp.n_fp ? s2.gf[l + 1] : sp.fp[l + 1].mlp2.dout;
        group_knn_bwd(cx, bw, gbuf[3], lg[l + 1], k, tape + tgt + (size_t)pt0 * lg[l + 1], gxyz,
                      gdist);
    }
    for (int l = sp.n_sa - 1; l >= 0; --l) {
        const SA& s = sp.sa[l];
        const int k = s.k, cgw = s.mlp.conv[0].cin, row0 = pt0 * k;
        float* dg = gbuf[3] + (size_t)row0 * cgw;
        float* gfl = tape + s2.gf[l] + (size_t)pt0 * lw[l];
        att_bwd<CL>(cx, bw, s.att, k, tape + s2.gf[l + 1] + (size_t)pt0 * lw[l + 1], lw[l + 1],
                    gfl, lw[l], dg, tape + s.mlp.dout + (size_t)row0 * s.att.out_conv.cin,
                    gbuf[0] + row0 * gld, gbuf[2] + row0 * gld, gbuf[1] + row0 * gld);
        mlp_bwd<CL>(cx, bw, s.mlp, k, dg, true, gbuf[0] + row0 * gld);
        cluster_arrive_wait<CL>(cx);   // every block's grouped rows' gradients
        if (k < n) knn_all(bw, n, k);
        pick_lists(cx, bw, k, k == n);
        group_sa_bwd(cx, bw, gbuf[3], lw[l], k, gfl, gxyz);
    }
    cluster_arrive_wait<CL>(cx);       // every block's rows of gdist
    dist_bwd(cx, bw, gdist, gxyz);
    if (cx.pos != cx.pl->nst) __trap();

    // outputs: d(pc) from level 0 ([pc[:, 3:], xyz]) and the coordinates
    const float* gf0 = tape + s2.gf[0] + (size_t)pt0 * din;
    for (int e = tid; e < Pr * din; e += kCompute) {
        const int il = e / din, c = e - il * din;
        dpc[((size_t)b * n + pt0) * din + e] =
            c < 3 ? gxyz[il * 3 + c] + gf0[il * din + din - 3 + c] : gf0[il * din + c - 3];
    }
    for (int i = rank * sp.t4 / CL + tid; i < (rank + 1) * sp.t4 / CL; i += kCompute)
        dt4[(size_t)b * sp.t4 + i] = gt4[i];
    for (int i = rank * sp.cls / CL + tid; i < (rank + 1) * sp.cls / CL; i += kCompute)
        dcls[(size_t)b * sp.cls + i] = gt4[sp.t4 + i];
    cluster_sync_all();   // no block leaves while others may still reach its shared memory
}

// ---------------------------------------------------------------------------
// The weight gradients: d W = sum over clouds b and their rows r of
// X_b[r]^T dY_b[r], d bias = sum dY_b[r], for every job of the list (one per
// weight and per GroupNorm affine), over the output tiles of the tile list;
// block = (tile, depth part).  Each part writes its own copy of the tile
// (wpart[part]); sum_parts_kernel adds the parts in order.

constexpr int kDwTile = 128;            // DW_TILE: output tile of in x out
constexpr int kDwRows = 32;             // depth rows a stage
constexpr int kDwStages = 3;            // stages in flight
constexpr int kDwLd = kDwTile + 8;      // staged rows' stride: a fragment's loads hit 32 banks
constexpr int kJob = 12;                // ints per job (`_k2_jobs`)
constexpr int kBlockInts = 8;           // ints per entry of the block list
enum { kTape = 0, kFromT4 = 1, kFromCls = 2, kFromG = 3 };

struct Sources {
    const float* tape;
    const float* t4;
    const float* cls;
    const float* g;
    long long tape_floats;              // per cloud
    int t4n, clsn, gn;
};

__device__ __forceinline__ const float* source(const Sources& src, int kind, int b) {
    switch (kind) {
        case kFromT4: return src.t4 + (size_t)b * src.t4n;
        case kFromCls: return src.cls + (size_t)b * src.clsn;
        case kFromG: return src.g + (size_t)b * src.gn;
        default: return src.tape + (size_t)b * src.tape_floats;
    }
}

// 4 bytes from global into shared memory, asynchronously; zeros when !valid
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(valid ? 4 : 0)
                 : "memory");
}

// Shared memory of weight_grad_kernel: kDwStages x (X rows, dY rows).
constexpr int kDwSmemBytes = kDwStages * 2 * kDwRows * kDwLd * 4;

// Block = one entry of the block list [job, first in, first out, depth part,
// parts]: the tile's 128 x 128 outputs over the part's depth rows, staged 32
// rows at a time through a ring of kDwStages buffers filled by cp.async two
// stages ahead of the products; 8 warps of 64 x 32.  The part's sums go to
// wpart[part].
__global__ void __launch_bounds__(256, 2)
weight_grad_kernel(const int* __restrict__ jobs, const int* __restrict__ blocks,
                   const Sources src, int B, float* __restrict__ wpart, long long size) {
    using Rows = float[kDwRows][kDwLd];
    Rows* Xs = reinterpret_cast<Rows*>(fused_smem);
    Rows* Ys = reinterpret_cast<Rows*>(fused_smem + kDwStages * kDwRows * kDwLd);
    const int* tl = blocks + kBlockInts * blockIdx.x;
    const int* jb = jobs + kJob * __ldg(tl);
    const int m0 = __ldg(tl + 1), n0 = __ldg(tl + 2), part = __ldg(tl + 3), parts = __ldg(tl + 4);
    const int dst_w = __ldg(jb), dst_b = __ldg(jb + 1), cin = __ldg(jb + 2), cout = __ldg(jb + 3);
    const int R = __ldg(jb + 4), xk = __ldg(jb + 5), xoff = __ldg(jb + 6), xld = __ldg(jb + 7);
    const int yk = __ldg(jb + 8), yoff = __ldg(jb + 9), yld = __ldg(jb + 10);
    const int D = B * R, steps = (D + kDwRows - 1) / kDwRows;
    const int s0 = part * steps / parts, s1 = (part + 1) * steps / parts;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int wm = (warp & 1) * 64, wn = (warp >> 1) * 32;
    const bool bias = dst_b >= 0 && m0 == 0;
    // a thread copies column col of rows row0, row0 + 2, ... of a stage; the
    // depth index d = b R + r advances by 2 from row to row
    const int col = tid & (kDwTile - 1), row0 = tid >> 7;
    const bool cx_ = m0 + col < cin, cy_ = n0 + col < cout;
    auto stage = [&](int st, int buf) {
        int d = st * kDwRows + row0, b = d / R, r = d - b * R;
#pragma unroll 4
        for (int row = row0; row < kDwRows; row += 2) {
            const bool in = d < D;
            const float* xs = in && cx_ ? source(src, xk, b) + xoff + (size_t)r * xld + m0 + col
                                        : src.tape;
            const float* ys = in && cy_ ? source(src, yk, b) + yoff + (size_t)r * yld + n0 + col
                                        : src.tape;
            cp_async4(&Xs[buf][row][col], xs, in && cx_);
            cp_async4(&Ys[buf][row][col], ys, in && cy_);
            d += 2;
            r += 2;
            while (r >= R) {
                r -= R;
                ++b;
            }
        }
        asm volatile("cp.async.commit_group;" ::: "memory");
    };
    float acc[4][4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;
    float bsum = 0.0f;
    for (int i = 0; i < kDwStages - 1; ++i) {
        if (s0 + i < s1) stage(s0 + i, i);
        else asm volatile("cp.async.commit_group;" ::: "memory");
    }
    for (int st = s0; st < s1; ++st) {
        const int cur = (st - s0) % kDwStages;
        // stage st has landed, and every warp is done with the buffer that
        // stage st + kDwStages - 1 goes into (it held stage st - 1)
        asm volatile("cp.async.wait_group %0;" ::"n"(kDwStages - 2) : "memory");
        __syncthreads();
        if (st + kDwStages - 1 < s1) stage(st + kDwStages - 1, (cur + kDwStages - 1) % kDwStages);
        else asm volatile("cp.async.commit_group;" ::: "memory");
        if (cin > 0) {
#pragma unroll
            for (int kk = 0; kk < kDwRows; kk += 8) {
                uint32_t bh[4][2], bl[4][2];
#pragma unroll
                for (int jn = 0; jn < 4; ++jn) {
                    split(Ys[cur][kk + t][wn + jn * 8 + g], bh[jn][0], bl[jn][0]);
                    split(Ys[cur][kk + t + 4][wn + jn * 8 + g], bh[jn][1], bl[jn][1]);
                }
#pragma unroll
                for (int mt = 0; mt < 4; ++mt) {
                    uint32_t ah[4], al[4];
                    const int m = wm + mt * 16 + g;
                    split(Xs[cur][kk + t][m], ah[0], al[0]);
                    split(Xs[cur][kk + t][m + 8], ah[1], al[1]);
                    split(Xs[cur][kk + t + 4][m], ah[2], al[2]);
                    split(Xs[cur][kk + t + 4][m + 8], ah[3], al[3]);
                    // fresh accumulators per step, added in fp32 (as gemm_t)
                    float c[4][4];
#pragma unroll
                    for (int jn = 0; jn < 4; ++jn)
#pragma unroll
                        for (int q = 0; q < 4; ++q) c[jn][q] = 0.0f;
#pragma unroll
                    for (int jn = 0; jn < 4; ++jn) mma_tf32(c[jn], al, bh[jn][0], bh[jn][1]);
#pragma unroll
                    for (int jn = 0; jn < 4; ++jn) mma_tf32(c[jn], ah, bl[jn][0], bl[jn][1]);
#pragma unroll
                    for (int jn = 0; jn < 4; ++jn) mma_tf32(c[jn], ah, bh[jn][0], bh[jn][1]);
#pragma unroll
                    for (int jn = 0; jn < 4; ++jn)
#pragma unroll
                        for (int q = 0; q < 4; ++q) acc[mt][jn][q] += c[jn][q];
                }
            }
        }
        if (bias && tid < kDwTile)
            for (int row = 0; row < kDwRows; ++row) bsum += Ys[cur][row][tid];
    }
    float* out = wpart + (size_t)part * size;
    if (cin > 0) {
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
            for (int jn = 0; jn < 4; ++jn)
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const int m = m0 + wm + mt * 16 + g + (q >> 1) * 8;
                    const int c = n0 + wn + jn * 8 + 2 * t + (q & 1);
                    if (m < cin && c < cout) out[dst_w + (size_t)m * cout + c] = acc[mt][jn][q];
                }
    }
    if (bias && tid < kDwTile && n0 + tid < cout) out[dst_b + n0 + tid] = bsum;
}

// d(flat)[e] = sum over the depth parts, in order; added to d(flat) when
// `accumulate` (a batch tile after the first).
__global__ void sum_parts_kernel(const float* __restrict__ wpart, int parts, long long size,
                                 int accumulate, float* __restrict__ out) {
    for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < size;
         e += (long long)gridDim.x * blockDim.x) {
        float s = 0.0f;
        for (int q = 0; q < parts; ++q) s += wpart[(size_t)q * size + e];
        out[e] = accumulate ? out[e] + s : s;
    }
}

template <int CL, int kBlocks>
cudaError_t launch_chain(const float* pc, const float* t4, const float* cls, const float* g,
                         const float* wcat, const Spec* table, const Spec2* table2, int size,
                         float* scratch, float* dpc, float* dt4, float* dcls, int B,
                         int smem_bytes, cudaStream_t stream) {
    const auto kernel = fused_denoiser_bwd_kernel<CL, kBlocks>;
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return e;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(B * CL, 1, 1);
    cfg.blockDim = dim3(block_threads<kBlocks>(), 1, 1);
    cfg.dynamicSmemBytes = static_cast<size_t>(smem_bytes);
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CL;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, kernel, pc, t4, cls, g, wcat, table, table2, size, scratch,
                              dpc, dt4, dcls);
}

template <int CL, int kBlocks>
cudaError_t max_clusters(int smem_bytes, int* clusters) {
    const auto kernel = fused_denoiser_bwd_kernel<CL, kBlocks>;
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return e;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(CL * 128, 1, 1);
    cfg.blockDim = dim3(block_threads<kBlocks>(), 1, 1);
    cfg.dynamicSmemBytes = static_cast<size_t>(smem_bytes);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CL;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
}

// The two placements the plan picks (`_k2_plan`): 4 blocks per cloud at 2
// per SM, or 8 at 1.
bool placement_ok(int cluster, int occupancy) {
    return (cluster == 4 && occupancy == 2) || (cluster == 8 && occupancy == 1);
}

}  // namespace

// The int32 entries of K2's own table (sizeof(Spec2) / 4).
extern "C" int slide_fused_table2_ints() {
    return static_cast<int>(sizeof(Spec2) / sizeof(int));
}

// Returns the cudaError_t of the launches (0 on success).  All pointers are
// device pointers, f32 contiguous unless said: pc (B, n, din), t4 (B, t4),
// cls (B, cls), g (B, n, out_dim), wcat (2 x size: the weights, then with
// every dense kernel transposed), the int32 tables, scratch (B x
// bwd_floats), the int32 jobs and block list (n_tiles entries) of the weight
// gradient and its parts' sums (parts x size); dpc, dt4, dcls (the inputs' shapes), dflat
// (size).  The chain: one cluster of `cluster` blocks per cloud,
// `occupancy` blocks per SM, smem_bytes of shared memory each (the plan's);
// then the weight gradient, then its parts' sum, written to dflat or, when
// `accumulate` (a batch tile after the first), added to it.
extern "C" int slide_fused_denoiser_bwd(const float* pc, const float* t4, const float* cls,
                                        const float* g, const float* wcat, const int* table,
                                        const int* table2, float* scratch, const int* jobs,
                                        const int* tiles, int n_tiles, int parts, float* wpart,
                                        float* dpc, float* dt4, float* dcls, float* dflat, int B,
                                        int size, int cluster, int occupancy, int smem_bytes,
                                        long long bwd_floats, int t4n, int clsn, int gn,
                                        int accumulate, int device, void* stream) {
    if (B <= 0 || size <= 0 || n_tiles <= 0 || parts <= 0 || smem_bytes <= 0 ||
        !placement_ok(cluster, occupancy))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const Spec* sp = reinterpret_cast<const Spec*>(table);
    const Spec2* sp2 = reinterpret_cast<const Spec2*>(table2);
    if (cluster == 4)
        e = launch_chain<4, 2>(pc, t4, cls, g, wcat, sp, sp2, size, scratch, dpc, dt4, dcls, B,
                               smem_bytes, s);
    else
        e = launch_chain<8, 1>(pc, t4, cls, g, wcat, sp, sp2, size, scratch, dpc, dt4, dcls, B,
                               smem_bytes, s);
    if (e != cudaSuccess) return static_cast<int>(e);
    const Sources src{scratch, t4, cls, g, bwd_floats, t4n, clsn, gn};
    e = cudaFuncSetAttribute(weight_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kDwSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    weight_grad_kernel<<<n_tiles, 256, kDwSmemBytes, s>>>(jobs, tiles, src, B, wpart, size);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    const long long blocks = (static_cast<long long>(size) + 255) / 256;
    sum_parts_kernel<<<static_cast<int>(blocks < 4096 ? blocks : 4096), 256, 0, s>>>(
        wpart, parts, size, accumulate, dflat);
    return static_cast<int>(cudaGetLastError());
}

// How many of K2's chain clusters the card holds at once with the given
// plan, into *clusters (cudaOccupancyMaxActiveClusters); returns the
// cudaError_t.
extern "C" int slide_fused_bwd_max_clusters(int smem_bytes, int cluster, int occupancy,
                                            int device, int* clusters) {
    if (!placement_ok(cluster, occupancy)) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (cluster == 4) e = max_clusters<4, 2>(smem_bytes, clusters);
    else e = max_clusters<8, 1>(smem_bytes, clusters);
    return static_cast<int>(e);
}
