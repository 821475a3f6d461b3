"""The port's network blocks against the flax ones, weights copied by
`load_flax_params`, all fp32 on the CPU.  Tolerance atol 3e-5 plus rtol 1e-5
(`assert_close`): the same formulas with sums taken in another order, through
up to six layers whose GroupNorms divide by small group variances."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import slide_tpu.nn as jnn
from slide_tpu.nn.distributions import DiagonalGaussian as JGaussian
from slide_tpu.nn.neighborhood import group_all as j_group_all
import slide_tpu_torch.nn as tnn
from torch_port_helpers import assert_close, run_pair, to_np

ATOL = 3e-5
ATT = {"use_attention_module": True, "attention_bn": True,
       "transform_grouped_feat_out": True, "last_activation": True,
       "add_attention_to_FeatureMapper_module": True}


def _x(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def test_calc_t_emb_and_swish():
    ts = np.arange(0, 40, 3).astype(np.int32)
    np.testing.assert_allclose(to_np(tnn.calc_t_emb(torch.as_tensor(ts), 64)),
                               to_np(jnn.calc_t_emb(jnp.asarray(ts), 64)), atol=ATOL)
    x = _x(0, 50)
    np.testing.assert_allclose(to_np(tnn.swish(torch.as_tensor(x))),
                               to_np(jnn.swish(jnp.asarray(x))), atol=ATOL)


def test_calc_t_emb_late_steps():
    # f32 sin/cos of angles up to ~1000 rad: one ulp of the angle is 6e-5,
    # and the two frameworks' exp of the frequencies may differ by an ulp
    ts = np.array([0, 250, 500, 999], np.int32)
    np.testing.assert_allclose(to_np(tnn.calc_t_emb(torch.as_tensor(ts), 128)),
                               to_np(jnn.calc_t_emb(jnp.asarray(ts), 128)), atol=2e-4)


@pytest.mark.parametrize("groups,channels,shape", [(32, 64, (2, 5, 64)),
                                                   (32, 35, (2, 4, 3, 35)),
                                                   (16, 16, (3, 16))])
def test_tail_group_norm(groups, channels, shape):
    x = _x(1, *shape, scale=3.0) + 1.0
    jout, tout, _ = run_pair(jnn.TailGroupNorm(groups, channels),
                             tnn.TailGroupNorm(groups, channels), [x])
    assert_close(jout, tout, ATOL)
    if channels % groups:
        np.testing.assert_array_equal(to_np(tout)[..., -3:], x[..., -3:])


@pytest.mark.parametrize("channels_per_group", [1, 2])
def test_group_norm_statistics_sum_in_float64(channels_per_group):
    # a GroupNorm over (points x neighbours) rows with a mean of ~2 spreads:
    # E[x^2] - E[x]^2 cancels, and fp32 sums over the strided (rows,
    # channels) axes (the CPU's reduction) carry the output ~1e-5 off; the
    # port sums each group laid out contiguously, in float64, and stays at
    # the output's own fp32 rounding, for fp32 input, and runs wholly in
    # float64 for float64 input
    g = 32
    c = g * channels_per_group
    gen = torch.Generator().manual_seed(0)
    x = (2.0 + torch.randn((2, 1024, 32, c), generator=gen, dtype=torch.float64)) * \
        torch.linspace(0.5, 3.0, c, dtype=torch.float64)
    norm = tnn.GroupNorm(g, c)
    with torch.no_grad():
        norm.weight.copy_(torch.linspace(0.5, 1.5, c))
        norm.bias.copy_(torch.linspace(-0.2, 0.2, c))
        want = norm.double()(x)
        got = norm.float()(x.float()).double()
        xg = x.float().reshape(2, -1, g, channels_per_group)
        mean = xg.mean(dim=(1, 3), keepdim=True)
        var = (xg * xg).mean(dim=(1, 3), keepdim=True) - mean * mean
        strided = ((xg - mean) * torch.rsqrt(var + norm.eps) * norm.weight.reshape(g, -1)
                   + norm.bias.reshape(g, -1)).reshape(x.shape).double()
    size = float(want.abs().max())
    err, err_strided = float((got - want).abs().max()) / size, \
        float((strided - want).abs().max()) / size
    print(f"of the output's size: the port {err}, strided fp32 sums {err_strided}")
    assert want.dtype == torch.float64 and err <= 1e-6


@pytest.mark.parametrize("bn_first,truncate_last,bias", [(False, False, False),
                                                         (True, False, True),
                                                         (False, True, True)])
def test_shared_mlp(bn_first, truncate_last, bias):
    dims = (12, 40, 33)
    x = _x(2, 2, 6, 4, 12)
    kw = dict(bn=True, bn_first=bn_first, bias=bias, truncate_last=truncate_last)
    jout, tout, _ = run_pair(jnn.SharedMLP(dims, **kw), tnn.SharedMLP(dims, **kw), [x])
    assert_close(jout, tout, ATOL)


@pytest.mark.parametrize("case", ["t_and_cond", "second_cond", "first_conv_res",
                                  "res_identity", "bn_first_swish"])
def test_injection_mlp(case):
    b = 2
    spec = (16, 32, 32, 48)
    kw = dict(bias=True)
    call = {}
    dims = {}
    first_in = 16
    if case == "t_and_cond":
        kw.update(include_t=True, include_condition=True, res_connect=True)
        call = {"t_emb": _x(3, b, 24), "condition_emb": _x(4, b, 10)}
        dims = dict(t_emb_dim=24, condition_dim=10)
    elif case == "second_cond":
        kw.update(include_condition=True, include_second_condition=True)
        call = {"condition_emb": _x(3, b, 20), "second_condition_emb": _x(4, b, 7)}
        dims = dict(condition_dim=20, second_condition_dim=7)
    elif case == "first_conv_res":
        first_in = 9
        kw.update(first_conv=True, first_conv_in_channel=9, res_connect=True)
    elif case == "res_identity":
        spec = (32, 32, 32)
        first_in = 32
        kw.update(res_connect=True)
    else:
        kw.update(bn_first=True, activation="swish", include_t=True, res_connect=True)
        call = {"t_emb": _x(3, b, 24)}
        dims = dict(t_emb_dim=24)
    x = _x(5, b, 6, 4, first_in)
    jout, tout, _ = run_pair(jnn.InjectionMLP(spec, **kw),
                             tnn.InjectionMLP(spec, **kw, **dims), [x], call)
    assert_close(jout, tout, ATOL)


def test_injection_mlp_rejects_missing_embedding():
    m = tnn.InjectionMLP((8, 8, 8), include_t=True, t_emb_dim=4)
    with pytest.raises(ValueError):
        m(torch.zeros(1, 3, 8))


def test_timestep_embedder():
    ts = np.array([0, 7, 31], np.int32)
    jout, tout, _ = run_pair(jnn.layers.TimestepEmbedder(32), tnn.TimestepEmbedder(32),
                             [ts])
    assert_close(jout, tout, ATOL)


@pytest.mark.parametrize("counted", [True, False])
@pytest.mark.parametrize("last_activation", [True, False])
def test_attention_pool(counted, last_activation):
    b, m, k = 2, 5, 6
    feat, grouped, out = _x(6, b, m, 7), _x(7, b, m, k, 40), _x(8, b, m, k, 24)
    count = np.random.default_rng(6).integers(0, k + 1, (b, m)).astype(np.int32) \
        if counted else "all"
    kw = dict(attention_bn=True, transform_grouped_feat_out=True,
              last_activation=last_activation)
    jout, tout, _ = run_pair(jnn.AttentionPool(max(7, 32), max(40, 32), 24, **kw),
                             tnn.AttentionPool(7, 40, 24, **kw),
                             [feat, grouped, out, count])
    assert_close(jout, tout, ATOL)


@pytest.mark.parametrize("neighbor_def,subset", [("nn", True), ("radius", True),
                                                 ("radius", False)])
def test_query_and_group(neighbor_def, subset):
    from slide_tpu.nn import query_and_group as jq
    xyz, new_xyz, feat = _x(9, 2, 40, 3), _x(10, 2, 12, 3), _x(11, 2, 40, 5)
    kw = dict(nsample=8, radius=0.6, neighbor_def=neighbor_def, use_xyz=True,
              include_abs_coordinate=True, include_center_coordinate=True,
              subset=subset)
    tf, tc = tnn.query_and_group(torch.as_tensor(xyz), torch.as_tensor(new_xyz),
                                 torch.as_tensor(feat), **kw)
    jf, jc = jq(jnp.asarray(xyz), jnp.asarray(new_xyz), jnp.asarray(feat), **kw)
    assert_close(jf, tf, ATOL)
    np.testing.assert_array_equal(to_np(tc), to_np(jc))


def test_group_knn_features_and_group_all():
    from slide_tpu.nn import group_knn_features as jg
    x, y, f = _x(12, 2, 20, 3), _x(13, 2, 9, 3), _x(14, 2, 9, 4)
    assert_close(jg(jnp.asarray(x), jnp.asarray(y), jnp.asarray(f), 4),
                 tnn.group_knn_features(torch.as_tensor(x), torch.as_tensor(y),
                                        torch.as_tensor(f), 4), ATOL)
    assert_close(j_group_all(jnp.asarray(x), jnp.asarray(f[:, :1].repeat(20, 1))),
                 tnn.group_all(torch.as_tensor(x),
                               torch.as_tensor(f[:, :1].repeat(20, 1))), ATOL)


def _sa_kwargs(first_conv):
    return dict(npoint=10, mlp_spec=(6, 16, 16, 32), nsample=8, neighbor_def="nn",
                use_xyz=True, include_abs_coordinate=True,
                include_center_coordinate=True, include_t=True, include_condition=True,
                bias=True, res_connect=True, first_conv=first_conv,
                first_conv_in_channel=6, bn_first=first_conv, attention_setting=ATT)


@pytest.mark.parametrize("n,first_conv", [(40, False), (40, True), (10, False)])
def test_sa_module(n, first_conv):
    # n > npoint runs FPS (start 0) and gathers; n == npoint keeps every point
    kw = _sa_kwargs(first_conv)
    xyz, feat = _x(15, 2, n, 3), _x(16, 2, n, 6)
    call = {"t_emb": _x(17, 2, 12), "condition_emb": _x(18, 2, 5)}
    jout, tout, _ = run_pair(jnn.SAModule(**kw),
                             tnn.SAModule(**kw, t_emb_dim=12, condition_dim=5),
                             [xyz, feat], call)
    assert_close(jout, tout, ATOL)


@pytest.mark.parametrize("pooling", ["max", "avg"])
def test_sa_module_without_attention(pooling):
    kw = dict(_sa_kwargs(False), attention_setting=None)
    xyz, feat = _x(15, 2, 30, 3), _x(16, 2, 30, 6)
    call = {"t_emb": _x(17, 2, 12), "condition_emb": _x(18, 2, 5), "pooling": pooling}
    jout, tout, _ = run_pair(jnn.SAModule(**kw),
                             tnn.SAModule(**kw, t_emb_dim=12, condition_dim=5),
                             [xyz, feat], call)
    assert_close(jout, tout, ATOL)


@pytest.mark.parametrize("include_grouper", [False, True])
def test_fp_module(include_grouper):
    kw = dict(mlp_spec=(8 + 5, 16, 16), include_t=True, include_condition=True,
              bias=True, res_connect=True, include_grouper=include_grouper,
              radius=0.8, nsample=6, neighbor_def="nn")
    unknown, known = _x(19, 2, 24, 3), _x(20, 2, 8, 3)
    uf, kf = _x(21, 2, 24, 5), _x(22, 2, 8, 8)
    call = {"t_emb": _x(23, 2, 12), "condition_emb": _x(24, 2, 5)}
    jout, tout, _ = run_pair(jnn.FPModule(**kw),
                             tnn.FPModule(**kw, t_emb_dim=12, condition_dim=5),
                             [unknown, known, uf, kf], call)
    assert_close(jout, tout, ATOL)


@pytest.mark.parametrize("att", [True, False])
def test_knn_fp_module(att):
    # decoder widths 16 -> 24 with a 5-wide skip, as `_build_fp_stack` builds
    kw = dict(mlp1_spec=(24, 16, 16), mlp2_spec=(16 + 5, 16, 16), k=4, include_t=True,
              include_condition=True, bias=True, res_connect=True,
              attention_setting=ATT if att else None)
    unknown, known = _x(25, 2, 20, 3), _x(26, 2, 8, 3)
    uf, kf = _x(27, 2, 20, 5), _x(28, 2, 8, 24)
    call = {"t_emb": _x(29, 2, 12), "condition_emb": _x(30, 2, 5)}
    jout, tout, _ = run_pair(jnn.KnnFPModule(**kw),
                             tnn.KnnFPModule(**kw, t_emb_dim=12, condition_dim=5),
                             [unknown, known, uf, kf], call)
    assert_close(jout, tout, ATOL)


@pytest.mark.parametrize("neighbor_def", ["nn", "radius"])
def test_feature_map_module(neighbor_def):
    kw = dict(mlp_spec=(10, 24, 24), k=4, radius=0.7, neighbor_def=neighbor_def,
              use_xyz=True, include_abs_coordinate=True, bn=True, bn_first=False,
              bias=True, res_connect=True, attention_setting=ATT, query_feature_dim=7)
    xyz, feat = _x(31, 2, 9, 3), _x(32, 2, 9, 10)
    new_xyz, q = _x(33, 2, 30, 3), _x(34, 2, 30, 7)
    jout, tout, _ = run_pair(jnn.FeatureMapModule(**kw), tnn.FeatureMapModule(**kw),
                             [xyz, feat, new_xyz], {"features_at_new_xyz": q,
                                                    "subset": False})
    assert_close(jout, tout, ATOL)


def test_diagonal_gaussian():
    params = _x(35, 2, 7, 8, scale=3.0)
    noise = _x(36, 2, 7, 4)
    jg = JGaussian.from_parameters(jnp.asarray(params))
    tg = tnn.DiagonalGaussian.from_parameters(torch.as_tensor(params))
    np.testing.assert_allclose(to_np(tg.mode()), to_np(jg.mode()), atol=ATOL)
    np.testing.assert_allclose(to_np(tg.sample(torch.as_tensor(noise))),
                               to_np(jg.mean + jg.std * jnp.asarray(noise)), atol=ATOL)
    np.testing.assert_allclose(to_np(tg.kl()), to_np(jg.kl()), rtol=1e-5)
