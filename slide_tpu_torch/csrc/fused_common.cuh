// What K1 (fused_denoiser.cu) and K2 (fused_denoiser_bwd.cu) share: the PTX
// they are built from, the block's plan, the cluster-wide arrival, the weight
// ring (multicast bulk copies into a ring of stages guarded by mbarriers, fed
// by a producer warp in the order of a list of products, `Stream`) and the
// product loop on the tensor cores at fp32 accuracy (3xTF32).  CL is the
// cluster's size in blocks (K1 runs 8; K2 4 or 8, its plan's choice).
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "fused_spec.cuh"

// The block's dynamic shared memory (the plans' offsets are in floats from
// here).  Indexing it directly, not through a pointer held elsewhere, lets
// the compiler use shared-memory loads.
extern __shared__ __align__(128) float fused_smem[];

namespace slide_fused {

namespace cg = cooperative_groups;

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
// kernel takes milliseconds) means the blocks disagree about the table:
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
template <int CL>
__device__ __forceinline__ void bulk_multicast(void* dst, const void* src, uint32_t bytes,
                                               uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster"
        " [%0], [%1], %2, [%3], %4;" ::"r"(smem_addr(dst)),
        "l"(src), "r"(bytes), "r"(smem_addr(bar)), "h"(static_cast<uint16_t>((1u << CL) - 1))
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
    const Stream* stream;   // the kernel's list of products (in shared memory)
    const float* w;         // packed weights
    float* gblk;            // K1: the block's device scratch
    float* vpart;           // K1: the cloud's injection partials, [block][inj]
    uint64_t* full;         // ring: bytes landed, per stage
    uint64_t* empty;        // ring: the cluster's compute warps done, per stage
    uint64_t* arrive;       // the cluster-wide arrival of the warps
    int ring_off, stage, nst, red_off;
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
              "the ring's barriers and the Plan fit in the table's first 64 floats");

#define TID (static_cast<int>(threadIdx.x))
#define WARP (static_cast<int>(threadIdx.x) >> 5)
#define LANE (static_cast<int>(threadIdx.x) & 31)

// All compute warps of the cluster have reached this point; what each block
// wrote before it (shared or device memory) is visible to the others.
template <int CL>
__device__ __noinline__ void cluster_arrive_wait(Ctx& cx) {
    compute_sync();
    if (TID < CL) mbar_arrive_at<true>(cx.pl->arrive, TID);
    mbar_wait_cluster(cx.pl->arrive, cx.na & 1u);
    ++cx.na;
}

// This block's slot of the cluster's exchange table (`part`, 2 x kMaxGroups
// floats, double-buffered by the arrival's parity): a block fills it, then
// arrives; after the arrival `cluster_pair_sum` reads every block's.
__device__ __forceinline__ float* part_slot(const Ctx& cx, int part_off) {
    return fused_smem + part_off + (cx.na & 1u) * 2 * kMaxGroups;
}

// (sum over the cluster's blocks of part[i], of part[kMaxGroups + i]), in
// rank order; `part` is this block's slot of the last arrival.
template <int CL>
__device__ __forceinline__ float2 cluster_pair_sum(const float* part, int i) {
    cg::cluster_group cl = cg::this_cluster();
    float qs[CL], qs2[CL];
#pragma unroll
    for (int r = 0; r < CL; ++r) {
        const float* q = cl.map_shared_rank(part, r);
        qs[r] = q[i];
        qs2[r] = q[kMaxGroups + i];
    }
    float s = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int r = 0; r < CL; ++r) {
        s += qs[r];
        s2 += qs2[r];
    }
    return make_float2(s, s2);
}

// Fill ring stage cx.pl->pj with the stream's next depth slice (the producer
// of each block, once its slot is free): this block's share of it, copied to
// all blocks.
template <int CL>
__device__ void fill_stage(Ctx& cx) {
    const Stream st = cx.pl->stream[cx.pl->pe];
    const uint32_t s = cx.pl->pj % kStages;
    const int rows = min(st.bk, st.cin - cx.pl->pk);
    const float* src = cx.pl->w + st.w + (size_t)cx.pl->pk * st.cout;
    float* dst = fused_smem + cx.pl->ring_off + (size_t)s * cx.pl->stage;
    uint64_t* bar = cx.pl->full + s;
    // one span, rounded up to 16 bytes (into the tensor's padding), a CL-th
    // from each block
    const uint32_t bytes = (static_cast<uint32_t>(rows * st.cout) * 4u + 15u) & ~15u;
    mbar_expect_tx(bar, bytes);
    const uint32_t chunk = ((bytes + CL - 1) / CL + 15u) & ~15u;
    const uint32_t lo = static_cast<uint32_t>(cx.pl->rank) * chunk;
    if (lo < bytes)
        bulk_multicast<CL>(reinterpret_cast<char*>(dst) + lo,
                           reinterpret_cast<const char*>(src) + lo, min(chunk, bytes - lo), bar);
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
template <int CL>
__device__ __noinline__ void produce(Ctx& cx) {
    Plan& pl = *cx.pl;
    while (pl.pe < pl.nst) {
        if (pl.pj >= static_cast<uint32_t>(kStages))
            mbar_wait(pl.empty + pl.pj % kStages, (pl.pj / kStages - 1) & 1u);
        fill_stage<CL>(cx);
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
// memory at float offset aoff (kSharedA; K1's activations) or in device
// memory at A (K1's rows in device scratch, K2's tape).  Rows past R are
// read clamped to row R - 1 and never written; depth past K is read as 0
// from A (the ring is zeroed at the start, then holds only weights, so its
// stale rows are finite).  Each 8-deep step's three products go into fresh
// accumulators, which are then added to the running sums in fp32: the
// tensor cores add into an accumulator truncating to its exponent, so over
// a long depth a sum that cancels loses more than an fp32 sum would (on an
// H100 an output of the latent net's score layer in K2 came out 15x further
// from float64 than with fp32 sums; tests/test_torch_cuda.py builds such a
// sum for K1).
template <int MT, int NTW, bool kSharedA, int CL>
__device__ __noinline__ void gemm_t(Ctx& cx, const Stream st, const float* bias,
                                    const float* A, int aoff, int lda, int R, const Out o) {
    const int K = st.cin, C = st.cout, nt = (C + 7) >> 3;
    const int warp = WARP, lane = LANE, g = lane >> 2, t = lane & 3;
    const int stage = cx.pl->stage, ring = cx.pl->ring_off;
    uint64_t* full = cx.pl->full;
    uint64_t* empty = cx.pl->empty;
    uint32_t j = cx.j;
    const float* As = kSharedA ? fused_smem + aoff : A;
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
            const float* Ws = fused_smem + ring + s * stage;
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
                        // the step's three products into fresh accumulators,
                        // then added to the sums
                        float c[U][MT][4];
#pragma unroll
                        for (int u = 0; u < U; ++u)
#pragma unroll
                            for (int m = 0; m < MT; ++m)
#pragma unroll
                                for (int q = 0; q < 4; ++q) c[u][m][q] = 0.0f;
#pragma unroll
                        for (int u = 0; u < U; ++u)
#pragma unroll
                            for (int m = 0; m < MT; ++m)
                                mma_tf32(c[u][m], al[m], bh[u][0], bh[u][1]);
#pragma unroll
                        for (int u = 0; u < U; ++u)
#pragma unroll
                            for (int m = 0; m < MT; ++m)
                                mma_tf32(c[u][m], ah[m], bl[u][0], bl[u][1]);
#pragma unroll
                        for (int u = 0; u < U; ++u)
#pragma unroll
                            for (int m = 0; m < MT; ++m)
                                mma_tf32(c[u][m], ah[m], bh[u][0], bh[u][1]);
#pragma unroll
                        for (int u = 0; u < U; ++u)
#pragma unroll
                            for (int m = 0; m < MT; ++m)
#pragma unroll
                                for (int q = 0; q < 4; ++q) acc[m][jn + u][q] += c[u][m][q];
                    }
                }
            }
            // this warp is done with the stage, in every block's count
            __syncwarp();
            if (lane < CL) mbar_arrive_at<false>(empty + s, lane);
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
            float* os = plain ? fused_smem + (o.p - fused_smem) + o.col : nullptr;
            float* red = fused_smem + cx.pl->red_off + 2 * o.col;
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

// The k nearest of the n points by one point's distance row: k rounds of
// masked argmin, ties to the lowest index, into picks[0..k).  The taken
// points are kMaskWords 64-bit words in registers (point j: bit j % 64 of
// word j / 64; the words are indexed by unrolled constants only).
__device__ __forceinline__ void knn_row(const float* __restrict__ dist, int n, int k,
                                        int* __restrict__ picks) {
    uint64_t taken[kMaskWords];
#pragma unroll
    for (int w = 0; w < kMaskWords; ++w) taken[w] = 0ull;
    for (int s = 0; s < k; ++s) {
        int best = -1;
        float bd = 0.0f;
#pragma unroll
        for (int w = 0; w < kMaskWords; ++w) {
            const uint64_t mask = taken[w];
            const int j0 = 64 * w, j1 = min(n, j0 + 64);
            for (int j = j0; j < j1; ++j) {
                if ((mask >> (j - j0)) & 1ull) continue;
                const float dj = dist[j];
                if (best < 0 || dj < bd) {
                    best = j;
                    bd = dj;
                }
            }
        }
#pragma unroll
        for (int w = 0; w < kMaskWords; ++w)
            if ((best >> 6) == w) taken[w] |= 1ull << (best & 63);
        picks[s] = best;
    }
}

// The stream's next entry, checked against the product the caller runs
// (weights at offset w, cin x cout, R rows): a product out of order traps.
__device__ __forceinline__ Stream next_product(Ctx& cx, int w, int cin, int cout, int R) {
    if (cx.pos >= cx.pl->nst) __trap();
    const Stream st = cx.pl->stream[cx.pos];
    if (st.w != w || st.cin != cin || st.cout != cout || R > st.passes * 16 * st.mt) __trap();
    ++cx.pos;
    return st;
}

}  // namespace slide_fused
