// The layer table shared by K1 (fused_denoiser.cu) and K2
// (fused_denoiser_bwd.cu): the `Spec` struct below is the Python `TABLE` of
// slide_tpu_torch/models/fused_denoiser.py, field by field, all ints, and
// `Spec2`, K2's own table, is its `TABLE2`.  The wrappers check their sizes
// (slide_fused_table_ints) against the tables.
#pragma once

namespace slide_fused {

constexpr int kCluster = 8;                  // K1: blocks per cloud
constexpr int kMaxLayers = 6;
constexpr int kMaxLevels = 4;
// points a cloud: the kNN keeps its taken points in kMaskWords 64-bit words,
// and K2 keeps the cloud's n x n distances and n x kmax picks in every
// block's shared memory (128 KB at 128 points, beside the weight ring)
constexpr int kMaxN = 128;
constexpr int kMaskWords = (kMaxN + 63) / 64;
constexpr int kMaxVec = 1024;
constexpr int kMaxGroups = 32;
constexpr int kGradBuffers = 6;
constexpr int kMaxStream = 128;            // K1: weight products per forward
constexpr int kMaxStream2 = 256;           // K2: the recompute's and the backward's

struct Dense { int w, b, cin, cout; };   // offsets into the weights; b < 0: none
// scale/bias offsets, channels, groups; K2's tape of the blocks' d scale /
// d bias sums
struct Norm { int s, b, c, g, p; };
// The fields after the weights are K2's tape: offsets into its per-cloud
// scratch (z conv output, a after GroupNorm + relu, h after the injection,
// st the GroupNorm's mean / inverse std / variance before the clip, out the
// MLP's output after the residual; dout its gradient, dvt / dvc the blocks'
// sums of the injection vectors' gradients).
struct Mlp {
    int n_layers, inject_t, inject_c, res;   // res 1: + x, 2: + res_conv(x)
    Dense conv[kMaxLayers];
    Norm norm[kMaxLayers];
    Dense fc_t, fc_c, res_conv;
    int z[kMaxLayers], a[kMaxLayers], h[kMaxLayers], st[kMaxLayers], out, dout, dvt, dvc;
    int vt, vc;                              // K1: its t and class vectors
};
struct Att {
    Dense feat_conv, grouped_conv;
    Norm w_norm_1;
    Dense w_conv_1;
    Norm w_norm_2;
    Dense w_conv_2, out_conv;
    Norm out_norm;
    int t, tn, st1, u, st2, un, s, v, st3, vn, w, df;   // K2's tape
};
// ld: K1's row stride at this level
struct SA { int k; Mlp mlp; Att att; int x; int ld; };
struct FP { int k; Mlp mlp1; Att att; Mlp mlp2; int x, nf; int ld; };
// One weight product of K1's forward (K2's), in the order it runs them: the
// weight's depth slices of bk rows stream through the cluster's ring, once
// per pass of 16 * mt rows
struct Stream { int w, cin, cout, bk, passes, mt; };
struct Spec {
    int n, din, out_dim, t4, cls, inc_abs, inc_cen, n_sa, n_fp, cloud_floats;
    // K1's plan (offsets in floats): points per block, dynamic shared memory
    // bytes, blocks per SM, device floats per block and where the injection partials start,
    // this table's copy, the weight ring, the two row buffers (bglob 1: in
    // the block's device scratch, else shared), the point buffer, the blocks'
    // own level features and the small tables
    int pts, smem_bytes, occupancy, blk_floats, vec, inj;
    int bars, table, ring, stage;
    int buf[2], bglob[2];
    int pbuf, pld, hld;
    int lvl[kMaxLevels + 1], lcap[kMaxLevels + 1];
    int dist, knn, kmax, xyz, part, gn, red, vecs;
    int n_stream;
    Stream stream[kMaxStream];
    SA sa[kMaxLevels];
    FP fp[kMaxLevels];
    Dense head1;
    Norm head_norm;
    Dense head_out;
};
// K2's plan (blocks per cloud and per SM, points per block; shared memory
// offsets in floats: barriers and plan, both tables' copies, the weight
// ring, the small tables), its per-cloud floats, the level features before
// the KnnFP tower, the head's tape, the gradient buffers and accumulators,
// and its products: the recompute's, then the backward's
struct Spec2 {
    int cluster, occupancy, pts, smem_bytes;
    int bars, table, table2, ring, stage;
    int xyz, dist, knn, kmax, picks, part, gn;
    int red, vecs, cs;
    int bwd_floats;
    int flvl[kMaxLevels + 1];
    int hin, hz, hst, ha;
    int gbuf[kGradBuffers], gld;
    int gf[kMaxLevels + 1];
    int gdist, gxyz, gvec;
    int n_stream;
    Stream stream[kMaxStream2];
};

}  // namespace slide_fused
