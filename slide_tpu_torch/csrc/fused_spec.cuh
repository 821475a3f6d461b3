// The layer table shared by K1 (fused_denoiser.cu) and K2
// (fused_denoiser_bwd.cu): the `Spec` struct below is the Python `TABLE` of
// slide_tpu_torch/models/fused_denoiser.py, field by field, all ints.  The
// wrappers check its size (slide_fused_table_ints) against the table.
#pragma once

namespace slide_fused {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 8;                  // blocks per cloud
constexpr int kGThreads = kThreads * kCluster;
constexpr int kMaxLayers = 6;
constexpr int kMaxLevels = 4;
constexpr int kMaxN = 32;
constexpr int kMaxVec = 1024;
constexpr int kMaxGroups = 32;
constexpr int kBuffers = 5;
constexpr int kGradBuffers = 6;
constexpr int BM = 64, BN = 64, BK = 16;

struct Dense { int w, b, cin, cout; };   // offsets into the weights; b < 0: none
struct Norm { int s, b, c, g; };         // scale/bias offsets, channels, groups
// The fields after the weights are K2's tape: offsets into its per-cloud
// scratch (z conv output, a after GroupNorm + relu, h after the injection,
// st the GroupNorm's mean / inverse std / variance before the clip, out the
// MLP's output after the residual).
struct Mlp {
    int n_layers, inject_t, inject_c, res;   // res 1: + x, 2: + res_conv(x)
    Dense conv[kMaxLayers];
    Norm norm[kMaxLayers];
    Dense fc_t, fc_c, res_conv;
    int z[kMaxLayers], a[kMaxLayers], h[kMaxLayers], st[kMaxLayers], out;
};
struct Att {
    Dense feat_conv, grouped_conv;
    Norm w_norm_1;
    Dense w_conv_1;
    Norm w_norm_2;
    Dense w_conv_2, out_conv;
    Norm out_norm;
    int t, tn, st1, u, st2, un, s, v, st3, vn, w;   // K2's tape
};
struct SA { int k; Mlp mlp; Att att; int x; };
struct FP { int k; Mlp mlp1; Att att; Mlp mlp2; int x, nf; };
struct Spec {
    int n, din, out_dim, t4, cls, inc_abs, inc_cen, n_sa, n_fp, cloud_floats;
    int stats, vec;                  // K1 scratch offsets: GroupNorm statistics, vector
    int buf[kBuffers];
    int lvl[kMaxLevels + 1];
    SA sa[kMaxLevels];
    FP fp[kMaxLevels];
    Dense head1;
    Norm head_norm;
    Dense head_out;
    // K2: per-cloud floats, level features before the KnnFP tower, the
    // head's tape, and the gradient buffers
    int bwd_floats;
    int flvl[kMaxLevels + 1];
    int hin, hz, hst, ha;
    int gbuf[kGradBuffers];
    int gf[kMaxLevels + 1];
    int gg[kMaxLevels + 1];
    int gdist, gxyz, gvec, gstat, tvec;
};

}  // namespace slide_fused
