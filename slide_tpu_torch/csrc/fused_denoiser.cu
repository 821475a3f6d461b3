// K1: the whole ConditionalPointNet2 forward (the fused denoiser) on Hopper
// (sm_90a), one launch per forward.  Its layer table, `Spec`, is in
// fused_spec.cuh (shared with K2, fused_denoiser_bwd.cu).
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
//     fit (up to 1024 rows per cloud), the table places it in the block's
//     device scratch and the same code reads it there;
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
//     a_lo b_hi + a_hi b_lo + a_hi b_hi accumulate in fp32
//     (mma.sync.m16n8k8.tf32).  Rows are the M side (16 or 32 per pass),
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

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cmath>
#include <cstdint>
#include <cstring>

#include "fused_spec.cuh"

namespace cg = cooperative_groups;

// The block's dynamic shared memory (the plan's offsets are in floats from
// here).  Indexing it directly, not through a pointer held elsewhere, lets
// the compiler use shared-memory loads.
extern __shared__ __align__(128) float k1_smem[];

namespace {

using namespace slide_fused;

constexpr int kCompute = 256;                 // the 8 compute warps

// A block: two compute warpgroups and the weight producer.  At one block per
// SM the producer is a whole warpgroup (one warp of it works) that gives its
// registers to the compute warps (setmaxnreg: 208 each, where 9 warps would
// leave 168); at two blocks per SM, one producer warp and no exchange.
template <int kBlocks>
__host__ __device__ constexpr int block_threads() {
    return kBlocks == 1 ? kCompute + 128 : kCompute + 32;
}
constexpr int kStages = 2;                    // the weight ring's depth

// ---------------------------------------------------------------------------
// PTX

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The compute warps meet (named barrier 1; the producer warp never joins).
__device__ __forceinline__ void compute_sync() {
    asm volatile("bar.sync 1, %0;" ::"r"(kCompute) : "memory");
}

// Every thread of the cluster (at the start and the end only).
__device__ __forceinline__ void cluster_sync_all() {
    asm volatile("barrier.cluster.arrive.release;\n\tbarrier.cluster.wait.acquire;" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
                 : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
                 "r"(bytes)
                 : "memory");
}

// Arrive on the barrier at the same place in block `rank` of the cluster,
// releasing at cluster scope what this thread wrote (kRelease) or only
// ordering its own reads before the arrival (a ring stage given back).
template <bool kRelease>
__device__ __forceinline__ void mbar_arrive_at(uint64_t* bar, int rank) {
    uint32_t remote;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                 : "=r"(remote)
                 : "r"(smem_addr(bar)), "r"(rank));
    if (kRelease)
        asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(remote)
                     : "memory");
    else
        asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];" ::"r"(remote) : "memory");
}

// Whether the phase of the given parity has completed; acquire at cta scope
// (bytes that a bulk copy brought) or cluster scope (what other blocks
// released).
template <bool kCluster_>
__device__ __forceinline__ bool mbar_done(uint32_t addr, uint32_t parity) {
    uint32_t ok;
    if (kCluster_)
        asm volatile(
            "{\n\t.reg .pred p;\n\t"
            "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n\t"
            "selp.u32 %0, 1, 0, p;\n}"
            : "=r"(ok)
            : "r"(addr), "r"(parity)
            : "memory");
    else
        asm volatile(
            "{\n\t.reg .pred p;\n\t"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
            "selp.u32 %0, 1, 0, p;\n}"
            : "=r"(ok)
            : "r"(addr), "r"(parity)
            : "memory");
    return ok != 0;
}

// Wait for that phase.  A wait of more than 2^32 cycles (seconds; a whole
// forward takes milliseconds) means the blocks disagree about the table:
// trap, so that the launch fails instead of hanging.
template <bool kCluster_>
__device__ __forceinline__ void mbar_wait_(uint64_t* bar, uint32_t parity) {
    const uint32_t addr = smem_addr(bar);
    if (mbar_done<kCluster_>(addr, parity)) return;
    const long long t0 = clock64();
    while (!mbar_done<kCluster_>(addr, parity))
        if (clock64() - t0 > (1ll << 32)) __trap();
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    mbar_wait_<false>(bar, parity);
}

__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
    mbar_wait_<true>(bar, parity);
}

// bytes from global memory into the same shared-memory place of every block
// of the cluster; each block's barrier there counts them.
__device__ __forceinline__ void bulk_multicast(void* dst, const void* src, uint32_t bytes,
                                               uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster"
        " [%0], [%1], %2, [%3], %4;" ::"r"(smem_addr(dst)),
        "l"(src), "r"(bytes), "r"(smem_addr(bar)), "h"(static_cast<uint16_t>((1u << kCluster) - 1))
        : "memory");
}

// x rounded to TF32 (10 mantissa bits), to nearest, ties away from zero:
// cvt.rna.tf32.f32's result, in two integer operations
__device__ __forceinline__ uint32_t tf32(float x) {
    return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, both TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
    hi = tf32(x);
    lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// The block's constants and the producer's cursor live in shared memory
// (`Plan`, read by every thread); each thread carries only its counters
// (stage, cluster arrival, stream position), which advance identically in
// every thread.  Thread ids come from threadIdx.

struct Plan {
    const Spec* sp;         // the table's copy in shared memory
    const float* w;         // packed weights
    float* gblk;            // the block's device scratch
    float* vpart;           // the cloud's injection partials, [block][inj]
    uint64_t* full;         // ring: bytes landed, per stage
    uint64_t* empty;        // ring: the cluster's 64 warps done, per stage
    uint64_t* arrive;       // the cluster-wide arrival of the warps
    int ring_off, stage, nst;
    int rank, n, P, Pr, pt0;  // points per cloud / per block / owned here; first owned
    uint32_t pj;            // the producer: next ring stage to fill, from stream
    int pe, pp, pk;         // entry pe, pass pp, depth pk on
};

struct Ctx {
    Plan* pl;
    uint32_t j;             // next ring stage to read
    uint32_t na;            // cluster arrivals so far
    int pos;                // next stream entry
};

static_assert((2 * kStages + 1) * 8 + sizeof(Plan) <= 256,
              "the ring's barriers and K1's Plan fit in the table's first 64 floats");

#define TID (static_cast<int>(threadIdx.x))
#define WARP (static_cast<int>(threadIdx.x) >> 5)
#define LANE (static_cast<int>(threadIdx.x) & 31)

// All compute warps of the cluster have reached this point; what each block
// wrote before it (shared or device memory) is visible to the others.
__device__ __noinline__ void cluster_arrive_wait(Ctx& cx) {
    compute_sync();
    if (TID < kCluster) mbar_arrive_at<true>(cx.pl->arrive, TID);
    mbar_wait_cluster(cx.pl->arrive, cx.na & 1u);
    ++cx.na;
}

// Fill ring stage cx.pl->pj with the stream's next depth slice (the producer
// of each block, once its slot is free): this block's share of it, copied to
// all blocks.
__device__ void fill_stage(Ctx& cx) {
    const Spec& sp = *cx.pl->sp;
    const Stream st = sp.stream[cx.pl->pe];
    const uint32_t s = cx.pl->pj % kStages;
    const int rows = min(st.bk, st.cin - cx.pl->pk);
    const float* src = cx.pl->w + st.w + (size_t)cx.pl->pk * st.cout;
    float* dst = k1_smem + cx.pl->ring_off + (size_t)s * cx.pl->stage;
    uint64_t* bar = cx.pl->full + s;
    // one span, rounded up to 16 bytes (into the tensor's padding), an
    // eighth from each block
    const uint32_t bytes = (static_cast<uint32_t>(rows * st.cout) * 4u + 15u) & ~15u;
    mbar_expect_tx(bar, bytes);
    const uint32_t chunk = ((bytes + kCluster - 1) / kCluster + 15u) & ~15u;
    const uint32_t lo = static_cast<uint32_t>(cx.pl->rank) * chunk;
    if (lo < bytes)
        bulk_multicast(reinterpret_cast<char*>(dst) + lo, reinterpret_cast<const char*>(src) + lo,
                       min(chunk, bytes - lo), bar);
    ++cx.pl->pj;
    cx.pl->pk += st.bk;
    if (cx.pl->pk >= st.cin) {
        cx.pl->pk = 0;
        if (++cx.pl->pp >= st.passes) {
            cx.pl->pp = 0;
            ++cx.pl->pe;
        }
    }
}

// The producer (lane 0 of the warp after the compute warps): every stage of
// the stream in order, each into its slot once the whole cluster has given
// the slot back.
__device__ __noinline__ void produce(Ctx& cx) {
    Plan& pl = *cx.pl;
    while (pl.pe < pl.nst) {
        if (pl.pj >= static_cast<uint32_t>(kStages))
            mbar_wait(pl.empty + pl.pj % kStages, (pl.pj / kStages - 1) & 1u);
        fill_stage(cx);
    }
}

// Where a product writes: row r, channel c of the output goes to
// p[(r * rep + s) * ld + col + c] for s < rep (rep > 1: a point's value to
// each of its slots); `acc` adds to what is there; relu after the bias.
// `stats`: the GroupNorm that follows takes its sums from here: the sums of
// v and v^2 over the block's rows of column col + c are added to the red
// table, at 2 (col + c) and 2 (col + c) + 1.
struct Out {
    float* p;
    int ld, col, rep;
    bool relu, acc;
    bool inplace;   // the output shares A's buffer
    bool stats;
};

// out = A W (+ bias) for the block's R rows of A (stride lda), K = cin deep,
// C = cout wide: passes of 16 MT rows, each warp holding MT x NTW tiles of
// 16 x 8.  Depth slices come from the ring; every compute warp takes every
// stage (and gives it back) even when it has no tile.  A lies in shared
// memory at float offset aoff (kSharedA) or in device memory at A.  Rows
// past R are read clamped to row R - 1 and never written; depth past K is
// read as 0 from A (the ring is zeroed at the start, then holds only
// weights, so its stale rows are finite).
template <int MT, int NTW, bool kSharedA>
__device__ __noinline__ void gemm_t(Ctx& cx, const Stream st, const float* bias,
                                    const float* A, int aoff, int lda, int R, const Out o) {
    const int K = st.cin, C = st.cout, nt = (C + 7) >> 3;
    const int warp = WARP, lane = LANE, g = lane >> 2, t = lane & 3;
    const int stage = cx.pl->stage, ring = cx.pl->ring_off;
    uint64_t* full = cx.pl->full;
    uint64_t* empty = cx.pl->empty;
    uint32_t j = cx.j;
    const float* As = kSharedA ? k1_smem + aoff : A;
    constexpr int RP = 16 * MT;
    for (int p = 0; p < st.passes; ++p) {
        const int r0 = p * RP;
        const bool live = r0 < R && warp < nt;
        const bool m1 = MT > 1 && r0 + 16 < R;
        int roff[MT][2];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
            roff[m][0] = min(r0 + m * 16 + g, R - 1) * lda;
            roff[m][1] = min(r0 + m * 16 + g + 8, R - 1) * lda;
        }
        float acc[MT][NTW][4];
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int jn = 0; jn < NTW; ++jn)
#pragma unroll
                for (int q = 0; q < 4; ++q) acc[m][jn][q] = 0.0f;
        for (int k0 = 0; k0 < K; k0 += st.bk) {
            const uint32_t s = j % kStages;
            mbar_wait(full + s, (j / kStages) & 1u);
            const float* Ws = k1_smem + ring + s * stage;
            const int kn = min(st.bk, K - k0);
            if (live) {
                for (int kk = 0; kk < kn; kk += 8) {
                    uint32_t ah[MT][4], al[MT][4];
                    const int ka = k0 + kk + t, kb = ka + 4;
                    const bool va = ka < K, vb = kb < K;
                    const int ca = va ? ka : 0, cb = vb ? kb : 0;
#pragma unroll
                    for (int m = 0; m < MT; ++m) {
                        const float v0 = As[roff[m][0] + ca], v1 = As[roff[m][1] + ca];
                        const float v2 = As[roff[m][0] + cb], v3 = As[roff[m][1] + cb];
                        split(va ? v0 : 0.0f, ah[m][0], al[m][0]);
                        split(va ? v1 : 0.0f, ah[m][1], al[m][1]);
                        split(vb ? v2 : 0.0f, ah[m][2], al[m][2]);
                        split(vb ? v3 : 0.0f, ah[m][3], al[m][3]);
                    }
                    const float* w0 = Ws + (kk + t) * C + g;
                    const float* w1 = w0 + 4 * C;
                    // two tiles at a time: the three products of each, each
                    // round over both tiles and all row tiles (2 MT
                    // independent accumulators back to back).  Branch-free:
                    // a tile past the width multiplies zeros, a row tile
                    // past R clamped rows, and neither is written
                    constexpr int U = NTW < 2 ? 1 : 2;
#pragma unroll
                    for (int jn = 0; jn < NTW; jn += U) {
                        uint32_t bh[U][2], bl[U][2];
#pragma unroll
                        for (int u = 0; u < U; ++u) {
                            const int tile = warp + 8 * (jn + u);
                            const int col = min(tile, nt - 1) * 8;
                            split(tile < nt ? w0[col] : 0.0f, bh[u][0], bl[u][0]);
                            split(tile < nt ? w1[col] : 0.0f, bh[u][1], bl[u][1]);
                        }
#pragma unroll
                        for (int u = 0; u < U; ++u)
#pragma unroll
                            for (int m = 0; m < MT; ++m)
                                mma_tf32(acc[m][jn + u], al[m], bh[u][0], bh[u][1]);
#pragma unroll
                        for (int u = 0; u < U; ++u)
#pragma unroll
                            for (int m = 0; m < MT; ++m)
                                mma_tf32(acc[m][jn + u], ah[m], bl[u][0], bl[u][1]);
#pragma unroll
                        for (int u = 0; u < U; ++u)
#pragma unroll
                            for (int m = 0; m < MT; ++m)
                                mma_tf32(acc[m][jn + u], ah[m], bh[u][0], bh[u][1]);
                    }
                }
            }
            // this warp is done with the stage, in every block's count
            __syncwarp();
            if (lane < kCluster) mbar_arrive_at<false>(empty + s, lane);
            ++j;
        }
        // every warp has read its rows of A: an output in the same buffer may
        // overwrite them
        if (o.inplace) compute_sync();
        if (live) {
            float bv[NTW][2];
#pragma unroll
            for (int jn = 0; jn < NTW; ++jn) {
                const int c = (warp + 8 * jn) * 8 + 2 * t;
                bv[jn][0] = bias && c < C ? __ldg(bias + c) : 0.0f;
                bv[jn][1] = bias && c + 1 < C ? __ldg(bias + c + 1) : 0.0f;
            }
            const bool plain = o.rep == 1 && !o.acc && __isShared(o.p);
            float* os = plain ? k1_smem + (o.p - k1_smem) + o.col : nullptr;
            float* red = k1_smem + cx.pl->sp->red + 2 * o.col;
#pragma unroll
            for (int jn = 0; jn < NTW; ++jn) {
                const int tile = warp + 8 * jn;
                if (tile >= nt) continue;
                // this thread's two columns: sums of v and v^2 over its rows
                float sm[2] = {0.0f, 0.0f}, sq[2] = {0.0f, 0.0f};
#pragma unroll
                for (int m = 0; m < MT; ++m) {
                    if (m == 1 && !m1) continue;
#pragma unroll
                    for (int q = 0; q < 4; ++q) {
                        const int r = r0 + m * 16 + g + (q >> 1) * 8;
                        const int c = tile * 8 + 2 * t + (q & 1);
                        if (r >= R || c >= C) continue;
                        float v = acc[m][jn][q] + bv[jn][q & 1];
                        if (o.relu) v = fmaxf(v, 0.0f);
                        sm[q & 1] += v;
                        sq[q & 1] = fmaf(v, v, sq[q & 1]);
                        if (plain) {
                            os[r * o.ld + c] = v;
                            continue;
                        }
                        for (int s = 0; s < o.rep; ++s) {
                            float* dst = o.p + ((size_t)r * o.rep + s) * o.ld + o.col + c;
                            *dst = o.acc ? *dst + v : v;
                        }
                    }
                }
                if (o.stats) {
                    // over the 8 row groups g (lanes t, t + 4, ...), then the
                    // column's owner (g = 0; the same lane in every pass) adds
                    // them to the table: the sum runs in a fixed order
#pragma unroll
                    for (int off = 4; off < 32; off <<= 1)
#pragma unroll
                        for (int u = 0; u < 2; ++u) {
                            sm[u] += __shfl_xor_sync(0xffffffffu, sm[u], off);
                            sq[u] += __shfl_xor_sync(0xffffffffu, sq[u], off);
                        }
                    const int c = tile * 8 + 2 * t;
                    if (g == 0)
#pragma unroll
                        for (int u = 0; u < 2; ++u)
                            if (c + u < C) {
                                red[2 * (c + u)] += sm[u] * o.rep;
                                red[2 * (c + u) + 1] += sq[u] * o.rep;
                            }
                }
            }
        }
    }
    compute_sync();
    cx.j = j;
}

// The product with dense d: the stream's next entry (else the kernel traps).
__device__ void gemm(Ctx& cx, const Dense& d, const float* A, int lda, int R, const Out& o) {
    if (cx.pos >= cx.pl->sp->n_stream) __trap();
    const Stream st = cx.pl->sp->stream[cx.pos];
    if (st.w != d.w || st.cin != d.cin || st.cout != d.cout || R > st.passes * 16 * st.mt)
        __trap();
    ++cx.pos;
    const float* bias = d.b >= 0 ? cx.pl->w + d.b : nullptr;
    if (__isShared(A)) {
        // the fewest tiles per warp that cover the width (8 warps x 8 columns)
        const int aoff = static_cast<int>(A - k1_smem), ntw = (st.cout + 63) / 64;
        if (st.mt == 2) {
            if (ntw <= 1) gemm_t<2, 1, true>(cx, st, bias, nullptr, aoff, lda, R, o);
            else if (ntw <= 2) gemm_t<2, 2, true>(cx, st, bias, nullptr, aoff, lda, R, o);
            else if (ntw <= 4) gemm_t<2, 4, true>(cx, st, bias, nullptr, aoff, lda, R, o);
            else gemm_t<2, 8, true>(cx, st, bias, nullptr, aoff, lda, R, o);
        } else {
            if (ntw <= 1) gemm_t<1, 1, true>(cx, st, bias, nullptr, aoff, lda, R, o);
            else if (ntw <= 2) gemm_t<1, 2, true>(cx, st, bias, nullptr, aoff, lda, R, o);
            else if (ntw <= 4) gemm_t<1, 4, true>(cx, st, bias, nullptr, aoff, lda, R, o);
            else if (ntw <= 8) gemm_t<1, 8, true>(cx, st, bias, nullptr, aoff, lda, R, o);
            else gemm_t<1, 16, true>(cx, st, bias, nullptr, aoff, lda, R, o);
        }
    } else {
        if (st.mt == 2) gemm_t<2, 8, false>(cx, st, bias, A, 0, lda, R, o);
        else gemm_t<1, 16, false>(cx, st, bias, A, 0, lda, R, o);
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
    float* red = k1_smem + cx.pl->sp->red;
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
    float* x = kShared ? k1_smem + xoff : xg;
    const int G = nd.g, cn = C - C % G, gs = cn / G;
    float* part = k1_smem + sp.part + (cx.na & 1u) * 2 * kMaxGroups;
    float* red = k1_smem + sp.red;
    if (TID < G) {
        float gsum = 0.0f, gsum2 = 0.0f;
        for (int c = TID * gs; c < (TID + 1) * gs; ++c) {
            gsum += red[2 * c];
            gsum2 += red[2 * c + 1];
        }
        part[TID] = gsum;
        part[kMaxGroups + TID] = gsum2;
    }
    cluster_arrive_wait(cx);
    for (int c = TID; c < 2 * C; c += kCompute) red[c] = 0.0f;
    float* mean = k1_smem + sp.gn;
    float* inv = mean + kMaxGroups;
    if (TID < G) {
        cg::cluster_group cl = cg::this_cluster();
        float qs[kCluster], qs2[kCluster];
#pragma unroll
        for (int r = 0; r < kCluster; ++r) {
            const float* q = cl.map_shared_rank(part, r);
            qs[r] = q[TID];
            qs2[r] = q[kMaxGroups + TID];
        }
        float s = 0.0f, s2 = 0.0f;
#pragma unroll
        for (int r = 0; r < kCluster; ++r) {
            s += qs[r];
            s2 += qs2[r];
        }
        const float cnt = static_cast<float>(Rc * gs);
        const float m = s / cnt;
        const float var = fmaxf(s2 / cnt - m * m, 0.0f);
        mean[TID] = m;
        inv[TID] = 1.0f / sqrtf(var + 1e-5f);
    }
    float* vec = k1_smem + sp.vecs;
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
        group_norm_t<true>(cx, nullptr, static_cast<int>(x - k1_smem), ld, R, Rc, C, nd, relu, fc,
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

// The k nearest points of each owned point (k rounds of masked argmin over
// its distance row, ties to the lowest index).
__device__ __noinline__ void knn_select(Ctx& cx, int k) {
    const Spec& sp = *cx.pl->sp;
    const float* dist = k1_smem + sp.dist;
    int* knn = reinterpret_cast<int*>(k1_smem + sp.knn);
    if (TID < cx.pl->Pr) {
        const int i = TID, n = cx.pl->n;
        unsigned taken = 0u;
        for (int s = 0; s < k; ++s) {
            int best = -1;
            float bd = 0.0f;
            for (int j = 0; j < n; ++j) {
                if ((taken >> j) & 1u) continue;
                const float dj = dist[i * n + j];
                if (best < 0 || dj < bd) {
                    best = j;
                    bd = dj;
                }
            }
            taken |= 1u << best;
            knn[i * sp.kmax + s] = best;
        }
    }
    compute_sync();
}

// Feature row of point j at level l, in the shared memory of the block that
// owns it.
__device__ __forceinline__ const float* level_row(Ctx& cx, int l, int j) {
    const int owner = j / cx.pl->P;
    const Spec& sp = *cx.pl->sp;
    const float* base = k1_smem + sp.lvl[l] + (size_t)(j - owner * cx.pl->P) * sp.lcap[l];
    return cg::this_cluster().map_shared_rank(base, owner);
}

// SA grouping of each owned point's k neighbours: [feat, rel, abs?, center?]
// into X (stride ld).  full: slot j is point j (k == n); else the kNN picks.
__device__ __noinline__ void group_sa(Ctx& cx, float* X, int ld, int l, int cf, int k, bool full) {
    const Spec& sp = *cx.pl->sp;
    const bool inc_abs = sp.inc_abs, inc_cen = sp.inc_cen;
    const int cg_ = cf + 3 + 3 * int(inc_abs) + 3 * int(inc_cen);
    const float* xyz = k1_smem + sp.xyz;
    const int* knn = reinterpret_cast<const int*>(k1_smem + sp.knn);
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
    const float* xyz = k1_smem + sp.xyz;
    const float* dist = k1_smem + sp.dist;
    const int* knn = reinterpret_cast<const int*>(k1_smem + sp.knn);
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
    float* smem = k1_smem;
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
        if (tid == kCompute) produce(cx);
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
        cluster_arrive_wait(cx);   // level l + 1 visible to the next grouping
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
        cluster_arrive_wait(cx);   // level l visible to the next grouping
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
