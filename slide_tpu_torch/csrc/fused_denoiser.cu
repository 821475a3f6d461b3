// K1: the whole ConditionalPointNet2 forward (the fused denoiser) on Hopper
// (sm_90a), one launch per forward.  Its layer table, `Spec`, is in
// fused_spec.cuh, and the PTX, the weight ring and the product loop it is
// built from are in fused_common.cuh; K2 (fused_denoiser_bwd.cu) shares
// both.
//
// Replaces the TPU kernel slide_tpu/models/fused_denoiser.py::_pallas_forward
// (body _forward_tile): per cloud, pairwise squared distances, kNN, the SA
// tower (grouping, InjectionMLP, attention pool), the KnnFP tower and the
// head.  The plain version is slide_tpu_torch/models/fused_denoiser.py::
// fused_forward_plain; the layer table is its `TABLE`, field for field, and
// the plan below (placements, strides, the weight stream) is computed there
// (`pack_weights`).
//
// What bounds it on this card: operations (the fp32 bound of the weight
// products: latent ~1.06 GFLOP per cloud against 14.7 MB of weights, kp ~77
// MFLOP against 1.6 MB), and in practice the latency of a chain of 42
// products and 27 GroupNorms per forward.
// Design:
//   - one cluster of 8 blocks per cloud.  Block r owns points
//     [r P, (r + 1) P), P = ceil(n / 8), and every grouped row i k + s of
//     them: each 1x1 conv, bias, relu, residual, the attention's softmax over
//     a point's k slots, the KnnFP level's second MLP and the head are local
//     to the block;
//   - activations stay in the block's shared memory from layer to layer: two
//     row buffers (row stride 4 mod 8: a fragment's loads hit 32 banks), and
//     products write in place (each pass keeps its whole output in registers
//     until every warp has read its input rows).  Where a row buffer does not
//     fit (up to 16384 grouped rows per cloud at 128 points), the table places
//     it in the block's device scratch and the same code reads it there;
//   - across blocks only what the math needs: a GroupNorm's per-group sums
//     (x and x^2 over the block's rows, formed in the epilogue of the
//     products that wrote x) go to the other blocks through distributed
//     shared memory, with one cluster-wide arrival per GroupNorm (an mbarrier
//     in every block, each block arriving on all eight); a level's features
//     stay with their owners and the next grouping reads its neighbours' rows
//     there (a gathered copy of a latent level, 32 KB, would not fit beside
//     the row buffers);
//   - products on the tensor cores at fp32 accuracy (3xTF32): each operand is
//     split into a TF32 high part and the TF32 rounding of the rest, and
//     a_lo b_hi + a_hi b_lo + a_hi b_hi of each 8-deep step accumulate in
//     fresh fp32 accumulators, then in fp32 into the running sums
//     (mma.sync.m16n8k8.tf32; fused_common.cuh::gemm_t, K2's loop too).  Rows are the M side (16 or 32 per pass),
//     output channels the N side spread over the 8 compute warps; the inner
//     loop is branch-free (one instantiation per tiles-per-warp count);
//   - weights multicast to the cluster: each depth slice W[k0:k0+bk, :] of a
//     (cin, cout) weight is one contiguous span; the 8 blocks each copy an
//     eighth of it with one cp.async.bulk .multicast::cluster into all 8
//     blocks' shared memory, into a ring of 2 stages guarded by mbarriers
//     (full: bytes landed; empty: all 64 compute warps of the cluster done).
//     A producer warp per block starts the copies, running ahead across
//     layers through the table's list of products (`Stream`); the cluster
//     reads each weight from L2 once per cloud per pass;
//   - registers and occupancy: at one block per SM the producer is a whole
//     warpgroup that gives its registers to the two compute warpgroups
//     (setmaxnreg: 208 each; with 9 warps the cap is 168 and the products
//     spill).  A plan that fits in half the shared memory runs two blocks per
//     SM (the table's `occupancy`): an H100 holds 15 clusters of 8 at one
//     block per SM, 30 at two, so the kp net's batch of 16 runs in one wave;
//   - the table is copied into shared memory (the helpers read it through a
//     pointer); the block's constants and the producer's cursor live there
//     too (`Plan`): local memory would go to L2 (L1 is what shared memory
//     leaves of 256 KB);
//   - the t and class injection vectors are formed at the start, each block
//     over an eighth of the depth; their partial sums meet at the first
//     GroupNorm that uses them;
//   - distances and kNN picks round exactly as the plain version: each sum
//     and product a separate round-to-nearest operation (no FMA), and the k
//     rounds of masked argmin take the lowest index on ties;
//   - control flow around every barrier depends only on the table, the same
//     for all blocks of the cluster.  Each product checks that it is the
//     stream's next entry and traps otherwise, and a wait of more than 2^32
//     cycles traps, so a table that disagrees with the kernel fails instead
//     of hanging.

#include <cuda_runtime.h>
#include <cmath>
#include <cstdint>
#include <cstring>

#include "fused_common.cuh"

namespace {

using namespace slide_fused;

// The product with dense d: the stream's next entry (else the kernel traps).
__device__ void gemm(Ctx& cx, const Dense& d, const float* A, int lda, int R, const Out& o) {
    const Stream st = next_product(cx, d.w, d.cin, d.cout, R);
    const float* bias = d.b >= 0 ? cx.pl->w + d.b : nullptr;
    if (__isShared(A)) {
        // the fewest tiles per warp that cover the width (8 warps x 8 columns)
        const int aoff = static_cast<int>(A - fused_smem), ntw = (st.cout + 63) / 64;
        if (st.mt == 2) {
            if (ntw <= 1) gemm_t<2, 1, true, kCluster>(cx, st, bias, nullptr, aoff, lda, R, o);
            else if (ntw <= 2) gemm_t<2, 2, true, kCluster>(cx, st, bias, nullptr, aoff, lda, R, o);
            else if (ntw <= 4) gemm_t<2, 4, true, kCluster>(cx, st, bias, nullptr, aoff, lda, R, o);
            else gemm_t<2, 8, true, kCluster>(cx, st, bias, nullptr, aoff, lda, R, o);
        } else {
            if (ntw <= 1) gemm_t<1, 1, true, kCluster>(cx, st, bias, nullptr, aoff, lda, R, o);
            else if (ntw <= 2) gemm_t<1, 2, true, kCluster>(cx, st, bias, nullptr, aoff, lda, R, o);
            else if (ntw <= 4) gemm_t<1, 4, true, kCluster>(cx, st, bias, nullptr, aoff, lda, R, o);
            else if (ntw <= 8) gemm_t<1, 8, true, kCluster>(cx, st, bias, nullptr, aoff, lda, R, o);
            else gemm_t<1, 16, true, kCluster>(cx, st, bias, nullptr, aoff, lda, R, o);
        }
    } else {
        if (st.mt == 2) gemm_t<2, 8, false, kCluster>(cx, st, bias, A, 0, lda, R, o);
        else gemm_t<1, 16, false, kCluster>(cx, st, bias, A, 0, lda, R, o);
    }
}

// This block's partial of v . W[:, c] over its eighth of the depth, for every
// output c, into the cloud's injection partials at voff.
__device__ __noinline__ void inject_partial(Ctx& cx, const Dense& d, const float* v, int voff) {
    const int K = d.cin, C = d.cout;
    const int kb = cx.pl->rank * K / kCluster, ke = (cx.pl->rank + 1) * K / kCluster;
    const float* __restrict__ W = cx.pl->w + d.w;
    float* dst = cx.pl->vpart + (size_t)cx.pl->rank * cx.pl->sp->inj + voff;
    if (C >= kCompute) {
        for (int c = TID; c < C; c += kCompute) {
            float acc = 0.0f;
#pragma unroll 8
            for (int k = kb; k < ke; ++k)
                acc = fmaf(__ldg(v + k), __ldg(W + (size_t)k * C + c), acc);
            dst[c] = acc;
        }
        return;
    }
    // fewer outputs than threads: S threads per output, each over a part of
    // the block's depth, summed in order
    float* red = fused_smem + cx.pl->sp->red;
    const int S = kCompute / C, sub = TID / C, c = TID - sub * C;
    if (sub < S) {
        const int len = ke - kb, a = kb + sub * len / S, e = kb + (sub + 1) * len / S;
        float acc = 0.0f;
#pragma unroll 8
        for (int k = a; k < e; ++k) acc = fmaf(__ldg(v + k), __ldg(W + (size_t)k * C + c), acc);
        red[sub * C + c] = acc;
    }
    compute_sync();
    if (TID < C) {
        float s = 0.0f;
        for (int q = 0; q < S; ++q) {
            s += red[q * C + TID];
            red[q * C + TID] = 0.0f;   // the products' column sums start from 0
        }
        dst[TID] = s;
    }
    compute_sync();
}

__device__ __noinline__ void inject_mlp(Ctx& cx, const Mlp& m, const float* t4, const float* cls) {
    if (m.inject_t) inject_partial(cx, m.fc_t, t4, m.vt);
    if (m.inject_c) inject_partial(cx, m.fc_c, cls, m.vc);
}

// Tail GroupNorm over the cloud's rows of x (this block's R rows, stride ld,
// C channels; the cloud has Rc rows), in place; then relu and + the injection
// vector fc . v (partials at voff) if fc is given.  The per-column sums over
// the block's rows are in the red table (the products that wrote x formed
// them, `Out::stats`); they are summed per group in a fixed order and zeroed
// for the next GroupNorm.  Threads work by column: a column chunk of cw <=
// 256 channels, rpt = 256 / cw threads per column, each over every rpt-th
// row.  x lies in shared memory at float offset xoff (kShared) or in device
// memory.
template <bool kShared>
__device__ __noinline__ void group_norm_t(Ctx& cx, float* xg, int xoff, int ld, int R, int Rc,
                                          int C, const Norm& nd, bool relu, const Dense* fc,
                                          int voff) {
    const Spec& sp = *cx.pl->sp;
    float* x = kShared ? fused_smem + xoff : xg;
    const int G = nd.g, cn = C - C % G, gs = cn / G;
    float* part = part_slot(cx, sp.part);
    float* red = fused_smem + sp.red;
    if (TID < G) {
        float gsum = 0.0f, gsum2 = 0.0f;
        for (int c = TID * gs; c < (TID + 1) * gs; ++c) {
            gsum += red[2 * c];
            gsum2 += red[2 * c + 1];
        }
        part[TID] = gsum;
        part[kMaxGroups + TID] = gsum2;
    }
    cluster_arrive_wait<kCluster>(cx);
    for (int c = TID; c < 2 * C; c += kCompute) red[c] = 0.0f;
    float* mean = fused_smem + sp.gn;
    float* inv = mean + kMaxGroups;
    if (TID < G) {
        const float2 q = cluster_pair_sum<kCluster>(part, TID);
        const float s = q.x, s2 = q.y;
        const float cnt = static_cast<float>(Rc * gs);
        const float m = s / cnt;
        const float var = fmaxf(s2 / cnt - m * m, 0.0f);
        mean[TID] = m;
        inv[TID] = 1.0f / sqrtf(var + 1e-5f);
    }
    float* vec = fused_smem + sp.vecs;
    if (fc) {
        for (int c = TID; c < C; c += kCompute) {
            float qv[kCluster];
#pragma unroll
            for (int r = 0; r < kCluster; ++r)
                qv[r] = __ldcg(cx.pl->vpart + (size_t)r * sp.inj + voff + c);
            float v = 0.0f;
#pragma unroll
            for (int r = 0; r < kCluster; ++r) v += qv[r];
            vec[c] = fc->b >= 0 ? v + __ldg(cx.pl->w + fc->b + c) : v;
        }
    }
    compute_sync();
    for (int c0 = 0; c0 < C; c0 += kCompute) {
        const int cw = min(kCompute, C - c0), rpt = kCompute / cw;
        const int q = TID / cw, c = c0 + TID - q * cw;
        if (q >= rpt) continue;
        const bool norm = c < cn;
        float m = 0.0f, a = 1.0f, sc = 1.0f, sh = 0.0f;
        if (norm) {
            const int gi = c / gs;
            m = mean[gi];
            a = inv[gi];
            sc = __ldg(cx.pl->w + nd.s + c);
            sh = __ldg(cx.pl->w + nd.b + c);
        }
        const float add = fc ? vec[c] : 0.0f;
#pragma unroll 4
        for (int r = q; r < R; r += rpt) {
            float* px = x + (size_t)r * ld + c;
            float v = *px;
            if (norm) v = (v - m) * a * sc + sh;
            if (relu) v = fmaxf(v, 0.0f);
            if (fc) v += add;
            *px = v;
        }
    }
    compute_sync();
}

__device__ void group_norm(Ctx& cx, float* x, int ld, int R, int Rc, int C, const Norm& nd,
                           bool relu, const Dense* fc, int voff) {
    if (__isShared(x))
        group_norm_t<true>(cx, nullptr, static_cast<int>(x - fused_smem), ld, R, Rc, C, nd, relu, fc,
                           voff);
    else
        group_norm_t<false>(cx, x, 0, ld, R, Rc, C, nd, relu, fc, voff);
}

// InjectionMLP on the block's R rows of X (stride xld) into H (stride ld):
// the first layer reads X, the others work in place; then the residual.
__device__ __noinline__ void mlp(Ctx& cx, const Mlp& m, const float* X, int xld, float* H, int ld,
                                 int R, int Rc) {
    for (int l = 0; l < m.n_layers; ++l) {
        const Dense& cv = m.conv[l];
        gemm(cx, cv, l == 0 ? X : H, l == 0 ? xld : ld, R, Out{H, ld, 0, 1, false, false, l > 0, true});
        const bool it = l == 0 && m.inject_t, ic = l == 1 && m.inject_c;
        group_norm(cx, H, ld, R, Rc, cv.cout, m.norm[l], true,
                   it ? &m.fc_t : (ic ? &m.fc_c : nullptr), it ? m.vt : m.vc);
    }
    const int cl = m.conv[m.n_layers - 1].cout;
    if (m.res == 2) {
        gemm(cx, m.res_conv, X, xld, R, Out{H, ld, 0, 1, false, true, false, false});
    } else {
        for (int c0 = 0; c0 < cl; c0 += kCompute) {
            const int cw = min(kCompute, cl - c0), rpt = kCompute / cw;
            const int q = TID / cw, c = c0 + TID - q * cw;
            if (q < rpt)
                for (int r = q; r < R; r += rpt) H[(size_t)r * ld + c] += X[(size_t)r * xld + c];
        }
        compute_sync();
    }
}

// AttentionPool with every slot valid, on the block's points.  X holds the
// grouped rows (stride ld), V the value rows; feat the points' features
// (stride fld).  Writes the pooled features (Pr x c_out) to dst (stride dld).
__device__ __noinline__ void attention(Ctx& cx, const Att& a, const float* feat, int fld, float* X,
                                       float* V, int ld, int k, float* dst, int dld) {
    const int R = cx.pl->Pr * k, Rc = cx.pl->n * k;
    const int c1 = a.feat_conv.cout, ct = c1 + a.grouped_conv.cout, co = a.w_conv_2.cout;
    gemm(cx, a.grouped_conv, X, ld, R, Out{X, ld, c1, 1, true, false, true, true});
    gemm(cx, a.feat_conv, feat, fld, cx.pl->Pr, Out{X, ld, 0, k, true, false, false, true});
    group_norm(cx, X, ld, R, Rc, ct, a.w_norm_1, false, nullptr, 0);
    gemm(cx, a.w_conv_1, X, ld, R, Out{X, ld, 0, 1, true, false, true, true});
    group_norm(cx, X, ld, R, Rc, a.w_conv_1.cout, a.w_norm_2, false, nullptr, 0);
    gemm(cx, a.w_conv_2, X, ld, R, Out{X, ld, 0, 1, false, false, true, false});
    gemm(cx, a.out_conv, V, ld, R, Out{V, ld, 0, 1, false, false, true, true});
    group_norm(cx, V, ld, R, Rc, co, a.out_norm, true, nullptr, 0);
    // softmax over each point's k slots, per channel, max-shifted
    for (int e = TID; e < cx.pl->Pr * co; e += kCompute) {
        const int i = e / co, c = e - i * co;
        const float* s = X + (size_t)i * k * ld + c;
        const float* v = V + (size_t)i * k * ld + c;
        float mx = s[0];
        for (int j = 1; j < k; ++j) mx = fmaxf(mx, s[(size_t)j * ld]);
        float sum = 0.0f, acc = 0.0f;
        for (int j = 0; j < k; ++j) {
            const float e = expf(s[(size_t)j * ld] - mx);
            sum += e;
            acc = fmaf(v[(size_t)j * ld], e, acc);
        }
        dst[(size_t)i * dld + c] = acc / sum;
    }
    compute_sync();
}

// The k nearest points of each owned point (fused_common.cuh's knn_row over
// its distance row: k rounds of masked argmin, ties to the lowest index).
__device__ __noinline__ void knn_select(Ctx& cx, int k) {
    const Spec& sp = *cx.pl->sp;
    const float* dist = fused_smem + sp.dist;
    int* knn = reinterpret_cast<int*>(fused_smem + sp.knn);
    if (TID < cx.pl->Pr) {
        const int i = TID, n = cx.pl->n;
        knn_row(dist + i * n, n, k, knn + i * sp.kmax);
    }
    compute_sync();
}

// Feature row of point j at level l, in the shared memory of the block that
// owns it.
__device__ __forceinline__ const float* level_row(Ctx& cx, int l, int j) {
    const int owner = j / cx.pl->P;
    const Spec& sp = *cx.pl->sp;
    const float* base = fused_smem + sp.lvl[l] + (size_t)(j - owner * cx.pl->P) * sp.lcap[l];
    return cg::this_cluster().map_shared_rank(base, owner);
}

// SA grouping of each owned point's k neighbours: [feat, rel, abs?, center?]
// into X (stride ld).  full: slot j is point j (k == n); else the kNN picks.
__device__ __noinline__ void group_sa(Ctx& cx, float* X, int ld, int l, int cf, int k, bool full) {
    const Spec& sp = *cx.pl->sp;
    const bool inc_abs = sp.inc_abs, inc_cen = sp.inc_cen;
    const int cg_ = cf + 3 + 3 * int(inc_abs) + 3 * int(inc_cen);
    const float* xyz = fused_smem + sp.xyz;
    const int* knn = reinterpret_cast<const int*>(fused_smem + sp.knn);
    for (int e = TID; e < cx.pl->Pr * k * cg_; e += kCompute) {
        const int r = e / cg_, c = e - r * cg_;
        const int il = r / k, s = r - il * k, i = cx.pl->pt0 + il;
        const int j = full ? s : knn[il * sp.kmax + s];
        float v;
        if (c < cf) {
            v = level_row(cx, l, j)[c];
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
        X[(size_t)r * ld + c] = v;
    }
    compute_sync();
}

// KnnFP grouping: [feat, dist, weight, abs, rel, center] (cf + 11 channels).
__device__ __noinline__ void group_knn(Ctx& cx, float* X, int ld, int l, int cf, int k) {
    const Spec& sp = *cx.pl->sp;
    const int cg_ = cf + 11, n = cx.pl->n;
    const float* xyz = fused_smem + sp.xyz;
    const float* dist = fused_smem + sp.dist;
    const int* knn = reinterpret_cast<const int*>(fused_smem + sp.knn);
    for (int e = TID; e < cx.pl->Pr * k * cg_; e += kCompute) {
        const int r = e / cg_, c = e - r * cg_;
        const int il = r / k, s = r - il * k, i = cx.pl->pt0 + il;
        const int j = knn[il * sp.kmax + s];
        float v;
        if (c < cf) {
            v = level_row(cx, l, j)[c];
        } else if (c == cf) {
            v = dist[il * n + j];
        } else if (c == cf + 1) {
            float sum = 0.0f;
            for (int q = 0; q < k; ++q)
                sum += 1.0f / (dist[il * n + knn[il * sp.kmax + q]] + 1e-8f);
            v = (1.0f / (dist[il * n + j] + 1e-8f)) / sum;
        } else {
            const int q = c - cf - 2;
            if (q < 3) v = xyz[j * 3 + q];
            else if (q < 6) v = xyz[j * 3 + q - 3] - xyz[i * 3 + q - 3];
            else v = xyz[i * 3 + q - 6];
        }
        X[(size_t)r * ld + c] = v;
    }
    compute_sync();
}

// kBlocks blocks per SM: 2 when the plan fits in half the shared memory
// (the table's `occupancy`), so that twice the clusters run at once.
template <int kBlocks>
__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(block_threads<kBlocks>(), kBlocks)
fused_denoiser_kernel(const float* __restrict__ pc, const float* __restrict__ t4,
                      const float* __restrict__ cls, const float* __restrict__ wts,
                      const __grid_constant__ Spec spec, float* __restrict__ scratch,
                      float* __restrict__ out) {
    float* smem = fused_smem;
    const Spec& sp = spec;
    const int rank = static_cast<int>(cg::this_cluster().block_rank());
    const int b = blockIdx.x / kCluster, tid = threadIdx.x;
    constexpr int threads = block_threads<kBlocks>();
    const int n = sp.n, din = sp.din, P = sp.pts;
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + sp.bars);
    uint64_t* full = bars;
    uint64_t* empty = bars + kStages;
    uint64_t* arrive = bars + 2 * kStages;
    float* ring = smem + sp.ring;
    if (tid == 0) {
        for (int s = 0; s < kStages; ++s) {
            mbar_init(full + s, 1);
            mbar_init(empty + s, kCluster * (kCompute / 32));
        }
        mbar_init(arrive, kCluster);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    // the table, into shared memory: the helpers read it through a pointer,
    // and there a read costs what a shared-memory read costs
    {
        const int* src = reinterpret_cast<const int*>(&spec);
        int* dst = reinterpret_cast<int*>(smem + sp.table);
        for (int e = tid; e < static_cast<int>(sizeof(Spec) / sizeof(int)); e += threads)
            dst[e] = src[e];
    }
    // the ring starts zeroed (a product reads whole 8-row steps of a stage;
    // rows past its depth meet zeros in A, and must be finite)
    for (int e = tid; e < kStages * sp.stage; e += threads) ring[e] = 0.0f;
    // the products' column sums for GroupNorm start from 0 (red is followed
    // by vecs in the plan)
    for (int e = sp.red + tid; e < sp.vecs; e += threads) smem[e] = 0.0f;
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    const int pt0 = min(rank * P, n), Pr = min(P, n - pt0);
    // inputs: every block keeps all points' xyz; level 0 = [pc[:, 3:], xyz]
    // of its own points
    const float* p = pc + (size_t)b * n * din;
    {
        float* xyz = smem + sp.xyz;
        for (int e = tid; e < n * 3; e += threads) xyz[e] = p[(e / 3) * din + e % 3];
        float* l0 = smem + sp.lvl[0];
        for (int e = tid; e < Pr * din; e += threads) {
            const int il = e / din, c = e - il * din, i = pt0 + il;
            l0[il * sp.lcap[0] + c] = c < din - 3 ? p[i * din + 3 + c] : p[i * din + c - (din - 3)];
        }
    }
    cluster_sync_all();   // barriers initialised, level 0 written, in every block

    float* cs = scratch + (size_t)b * sp.cloud_floats;
    // the block's plan: after the ring's barriers, in shared memory
    Plan* plan = reinterpret_cast<Plan*>(bars + 2 * kStages + 1);
    if (tid == 0) {
        plan->sp = reinterpret_cast<const Spec*>(smem + sp.table);
        plan->w = wts;
        plan->gblk = cs + (size_t)rank * sp.blk_floats;
        plan->vpart = cs + sp.vec;
        plan->full = full;
        plan->empty = empty;
        plan->arrive = arrive;
        plan->ring_off = sp.ring;
        plan->stage = sp.stage;
        plan->nst = sp.n_stream;
        plan->stream = plan->sp->stream;
        plan->red_off = sp.red;
        plan->rank = rank;
        plan->n = n;
        plan->P = P;
        plan->Pr = Pr;
        plan->pt0 = pt0;
        plan->pj = 0;
        plan->pe = plan->pp = plan->pk = 0;
    }
    __syncthreads();
    Ctx cx;
    cx.pl = plan;
    cx.j = 0;
    cx.na = 0;
    cx.pos = 0;
    if (tid >= kCompute) {
        if (kBlocks == 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 80;" ::: "memory");
        if (tid == kCompute) produce<kCluster>(cx);
        cluster_sync_all();
        return;
    }
    if (kBlocks == 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 208;" ::: "memory");
    float* B0 = sp.bglob[0] ? cx.pl->gblk + sp.buf[0] : smem + sp.buf[0];
    float* B1 = sp.bglob[1] ? cx.pl->gblk + sp.buf[1] : smem + sp.buf[1];
    float* pb = smem + sp.pbuf;
    const float* xyz = smem + sp.xyz;

    // the injection vectors' partial sums (met at the first GroupNorm)
    const float* t4b = t4 + (size_t)b * sp.t4;
    const float* clsb = cls + (size_t)b * sp.cls;
    for (int l = 0; l < sp.n_sa; ++l) inject_mlp(cx, sp.sa[l].mlp, t4b, clsb);
    for (int l = 0; l < sp.n_fp; ++l) {
        inject_mlp(cx, sp.fp[l].mlp1, t4b, clsb);
        inject_mlp(cx, sp.fp[l].mlp2, t4b, clsb);
    }
    // squared distances of the owned points' rows, rounded as the plain
    // version rounds them
    {
        float* dist = smem + sp.dist;
        for (int e = tid; e < Pr * n; e += kCompute) {
            const int il = e / n, j = e - il * n;
            const float* a = xyz + 3 * (pt0 + il);
            const float* c = xyz + 3 * j;
            const float si = __fadd_rn(__fadd_rn(__fmul_rn(a[0], a[0]), __fmul_rn(a[1], a[1])),
                                       __fmul_rn(a[2], a[2]));
            const float sj = __fadd_rn(__fadd_rn(__fmul_rn(c[0], c[0]), __fmul_rn(c[1], c[1])),
                                       __fmul_rn(c[2], c[2]));
            const float xy = __fadd_rn(__fadd_rn(__fmul_rn(a[0], c[0]), __fmul_rn(a[1], c[1])),
                                       __fmul_rn(a[2], c[2]));
            dist[e] = fmaxf(__fsub_rn(__fadd_rn(si, sj), __fmul_rn(2.0f, xy)), 0.0f);
        }
        compute_sync();
    }
    int lw[kMaxLevels + 1];
    lw[0] = din;

    // SA tower
    for (int l = 0; l < sp.n_sa; ++l) {
        const SA& s = sp.sa[l];
        const int k = s.k, ld = s.ld;
        if (k < n) knn_select(cx, k);
        group_sa(cx, B0, ld, l, lw[l], k, k == n);
        mlp(cx, s.mlp, B0, ld, B1, ld, Pr * k, n * k);
        attention(cx, s.att, smem + sp.lvl[l], sp.lcap[l], B0, B1, ld, k, smem + sp.lvl[l + 1],
                  sp.lcap[l + 1]);
        lw[l + 1] = s.att.w_conv_2.cout;
        cluster_arrive_wait<kCluster>(cx);   // level l + 1 visible to the next grouping
    }

    // KnnFP tower, top-down
    for (int l = sp.n_fp - 1; l >= 0; --l) {
        const FP& f = sp.fp[l];
        const int k = f.k, ld = f.ld;
        knn_select(cx, k);
        group_knn(cx, B0, ld, l + 1, lw[l + 1], k);
        mlp(cx, f.mlp1, B0, ld, B1, ld, Pr * k, n * k);
        const int ci = f.att.w_conv_2.cout;
        attention(cx, f.att, smem + sp.lvl[l], sp.lcap[l], B0, B1, ld, k, pb, sp.pld);
        // nf = [interp, skip, xyz] of the owned points
        const int cs_ = lw[l];
        for (int e = tid; e < Pr * (cs_ + 3); e += kCompute) {
            const int il = e / (cs_ + 3), c = e - il * (cs_ + 3);
            pb[il * sp.pld + ci + c] = c < cs_ ? smem[sp.lvl[l] + il * sp.lcap[l] + c]
                                               : xyz[(pt0 + il) * 3 + c - cs_];
        }
        compute_sync();
        mlp(cx, f.mlp2, pb, sp.pld, B0, ld, Pr, n);
        const int co = f.mlp2.conv[f.mlp2.n_layers - 1].cout;
        for (int e = tid; e < Pr * co; e += kCompute) {
            const int il = e / co, c = e - il * co;
            smem[sp.lvl[l] + il * sp.lcap[l] + c] = B0[(size_t)il * ld + c];
        }
        lw[l] = co;
        cluster_arrive_wait<kCluster>(cx);   // level l visible to the next grouping
    }

    // head: [level 0, xyz] -> conv -> GN -> relu -> conv
    const int hin = lw[0] + 3;
    for (int e = tid; e < Pr * hin; e += kCompute) {
        const int il = e / hin, c = e - il * hin;
        pb[il * sp.pld + c] = c < lw[0] ? smem[sp.lvl[0] + il * sp.lcap[0] + c]
                                        : xyz[(pt0 + il) * 3 + c - lw[0]];
    }
    compute_sync();
    gemm(cx, sp.head1, pb, sp.pld, Pr, Out{B0, sp.hld, 0, 1, false, false, false, true});
    group_norm(cx, B0, sp.hld, Pr, n, sp.head1.cout, sp.head_norm, true, nullptr, 0);
    gemm(cx, sp.head_out, B0, sp.hld, Pr,
         Out{out + ((size_t)b * n + pt0) * sp.out_dim, sp.out_dim, 0, 1, false, false, false,
             false});
    if (cx.pos != sp.n_stream) __trap();
    cluster_sync_all();   // no block leaves while others may still reach its shared memory
}

}  // namespace

// The int32 entries of the layer table (sizeof(Spec) / 4), for the wrapper to
// check its table against.
extern "C" int slide_fused_table_ints() {
    return static_cast<int>(sizeof(Spec) / sizeof(int));
}

// Returns the cudaError_t of the launch (0 on success).  pc (B, n, din), t4
// (B, t4), cls (B, cls), weights (16-byte aligned), scratch (B x
// cloud_floats) and out (B, n, out_dim) are device pointers, f32 contiguous;
// table is the int32 layer table in host memory (it travels as the kernel's
// parameter, read through the constant cache).  smem_bytes is the table's
// `smem_bytes`.  The table's widths are checked by the wrapper.  One cluster
// of kCluster blocks per cloud, block_threads() threads each.
extern "C" int slide_fused_denoiser(const float* pc, const float* t4, const float* cls,
                                    const float* weights, const int* table,
                                    float* scratch, float* out, int B, int smem_bytes,
                                    int device, void* stream) {
    if (B <= 0 || smem_bytes <= 0) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    Spec spec;
    std::memcpy(&spec, table, sizeof(Spec));
    const auto kernel = spec.occupancy == 2 ? fused_denoiser_kernel<2> : fused_denoiser_kernel<1>;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int threads = spec.occupancy == 2 ? block_threads<2>() : block_threads<1>();
    kernel<<<B * kCluster, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
        pc, t4, cls, weights, spec, scratch, out);
    return static_cast<int>(cudaGetLastError());
}

// How many of K1's clusters the card holds at once with smem_bytes of
// dynamic shared memory per block and the given occupancy (the table's),
// into *clusters (cudaOccupancyMaxActiveClusters); returns the cudaError_t.
extern "C" int slide_fused_max_clusters(int smem_bytes, int occupancy, int device,
                                        int* clusters) {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    const auto kernel = occupancy == 2 ? fused_denoiser_kernel<2> : fused_denoiser_kernel<1>;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kCluster * 128, 1, 1);
    cfg.blockDim = dim3(occupancy == 2 ? block_threads<2>() : block_threads<1>(), 1, 1);
    cfg.dynamicSmemBytes = static_cast<size_t>(smem_bytes);
    return static_cast<int>(cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg));
}
