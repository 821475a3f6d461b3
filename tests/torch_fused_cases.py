"""The port's fused denoiser (`slide_tpu_torch/models/fused_denoiser.py`) and
FastDPM samplers (`slide_tpu_torch/diffusion/fastdpm.py`) against the JAX
package on the CPU, at 16 points and, up to the kernels' limit, at 40, 64,
96 and 128.  Inputs, weights and noise are made with numpy from a
seed (JAX chains' noise is rebuilt from their key splits and replayed through
`noise_fn`).  The JAX fused forward runs its own CPU path
(`fused_forward(..., use_pallas=False)`, plain jnp, jitted).

Tolerances: 2e-5 abs + 1e-5 rel between the port's plain fused forward and
JAX's (the same fp32 arithmetic, sums in another order); 1e-4 abs + 1e-4 rel
against the port's module (as the JAX package holds its fused path to its
flax module); 1e-4 on five-step chains; schedules equal; 1e-5 on FastDPM
chains with a closed-form network."""

import copy
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slide_tpu.configs import keypoint_ddpm_config as j_kp_config
from slide_tpu.configs import latent_ddpm_config as j_lat_config
from slide_tpu.diffusion import eps as jeps
from slide_tpu.diffusion import fastdpm as jfast
from slide_tpu.diffusion import x0 as jx0
from slide_tpu.models import fused_denoiser as jf
from slide_tpu_torch import diffusion as td
from slide_tpu_torch.diffusion import fastdpm as tfast
from slide_tpu_torch.models import ConditionalPointNet2
from slide_tpu_torch.models import fused_denoiser as tf
from slide_tpu_torch.pipeline import DEFAULT_CKPTS
from slide_tpu_torch.weights import load_flax_params, load_inference_params
from torch_port_helpers import assert_close, fast_jit, flax_params_of, to_np

N = 16


def _narrow(cfg_fn, nsample=None):
    cfg = copy.deepcopy(cfg_fn()["pointnet_config"])
    cfg.update(t_dim=16, class_condition_dim=16)
    cfg["architecture"].update(feature_dim=[16, 32, 32], decoder_feature_dim=[16, 32, 32],
                               mlp_depth=2, decoder_mlp_depth=2)
    if nsample is not None:
        cfg["architecture"]["nsample"] = nsample
    return cfg


def _perturbed_net(cfg, seed):
    """A port module with every weight moved off its init value."""
    net = ConditionalPointNet2(cfg)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in net.parameters():
            p.add_(torch.as_tensor(0.1 * rng.standard_normal(tuple(p.shape)),
                                   dtype=torch.float32))
    return net.eval()


_CASES = {}


def _case(name):
    """(config, port module, flax params, din) of one test network, built once:
    `kp` the narrow kp net (both SA levels group all 16 points), `lat_topk`
    the narrow latent net with SA nsample 6 < N on the first level (the kNN
    gather path), `kp_ckpt` the shipped kp preset with the committed
    checkpoint."""
    if name not in _CASES:
        if name == "kp_ckpt":
            cfg = copy.deepcopy(j_kp_config()["pointnet_config"])
            params = load_inference_params(str(DEFAULT_CKPTS["kp"]))
            net = load_flax_params(ConditionalPointNet2(cfg), params).eval()
        else:
            cfg = (_narrow(j_kp_config) if name == "kp"
                   else _narrow(j_lat_config, nsample=[6, 16]))
            net = _perturbed_net(cfg, seed=len(name))
            params = flax_params_of(net)
        _CASES[name] = (cfg, net, params, 3 + cfg["in_fea_dim"])
    return _CASES[name]


def _inputs(b, din, seed, n=N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n, din)).astype(np.float32)
    ts = rng.integers(0, 1000, b).astype(np.int32)
    label = rng.integers(0, 13, b).astype(np.int32)
    return x, ts, label


def _jax_fused(cfg, params, n=N):
    spec = jf.build_spec(cfg, n)
    weights = jf.extract_weights(params)
    return jax.jit(lambda x, ts, lbl: jf.fused_forward(spec, weights, x, ts, lbl,
                                                        use_pallas=False))


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


@pytest.mark.parametrize("cfg_fn", [j_kp_config, j_lat_config])
def test_spec_equals_jax(cfg_fn):
    cfg = cfg_fn("airplane")["pointnet_config"]
    assert tf.supports_config(cfg) and jf.supports_config(cfg)
    assert tf.build_spec(cfg, N) == jf.build_spec(cfg, N)


@pytest.mark.parametrize("change", ["bn_first", "include_local_feature", "npoint", "K"])
def test_unsupported_configs_are_rejected(change):
    cfg = copy.deepcopy(j_kp_config("airplane")["pointnet_config"])
    if change in ("bn_first", "include_local_feature"):
        cfg[change] = True
        assert not tf.supports_config(cfg) and not jf.supports_config(cfg)
    else:
        cfg["architecture"].update(npoint=[8, 16]) if change == "npoint" else \
            cfg["architecture"].update(K=17)
        assert tf.supports_config(cfg)
        with pytest.raises(ValueError):
            jf.build_spec(cfg, N)
    with pytest.raises(ValueError):
        tf.build_spec(cfg, N)
    assert tf.make_fused_net_fn(cfg, ConditionalPointNet2(j_kp_config()["pointnet_config"]),
                                N) is None


def test_packed_table_reads_back():
    cfg, net, _, _ = _case("kp")
    fn = tf.make_fused_net_fn(cfg, net, N)
    ints = fn.packed.table.tolist()
    assert len(ints) == tf.table_ints()
    assert tf.encode_table(tf.TABLE, fn.packed.layout) == ints
    flat, lay = fn.packed.flat, fn.packed.layout
    w = lay["sa"][1]["att"]["w_conv_2"]
    want = net.sa_modules_1.attention.w_conv_2
    got = flat[w["w"]:w["w"] + w["cin"] * w["cout"]].view(w["cin"], w["cout"])
    assert torch.equal(got, want.weight.t())
    assert torch.equal(flat[w["b"]:w["b"] + w["cout"]], want.bias)
    assert lay["sa"][0]["mlp"]["n_layers"] == 2 and lay["fp"][0]["mlp1"]["res"] == 2
    assert lay["n_sa"] == 2 and lay["sa"][2]["k"] == 0   # unused slots are zeros


@pytest.mark.parametrize("cfg_fn,n,occupancy,rows_in_device_memory", [
    ("kp", 16, 2, [0, 0]),       # fits in half the shared memory: two blocks per SM
    ("lat", 16, 1, [0, 0]),      # every activation in shared memory, one block per SM
    ("lat", 32, 2, [1, 1]),      # 1024 grouped rows per cloud: rows in device memory
    ("kp", 64, 2, [1, 1]),       # 4096 grouped rows per cloud
    ("lat", 64, 2, [1, 1]),
    ("kp", 128, 2, [1, 1]),      # 16384 grouped rows per cloud
    ("lat", 128, 1, [1, 1]),     # too large for two blocks per SM
])
def test_k1_plan_placements(cfg_fn, n, occupancy, rows_in_device_memory, monkeypatch):
    # K1's plan takes the first of K1_PLACEMENTS that fits, at the shipped
    # widths; limited to two blocks per SM, the latent net at 16 points puts
    # its row buffers in device memory
    from slide_tpu_torch.configs import keypoint_ddpm_config, latent_ddpm_config
    cfg = {"kp": keypoint_ddpm_config, "lat": latent_ddpm_config}[cfg_fn](
        "airplane", num_keypoints=n)["pointnet_config"]
    net = ConditionalPointNet2(cfg)
    lay = tf.pack_weights(net, tf.build_spec(cfg, n)).layout
    limit = {1: tf.K1_SMEM_BYTES, 2: tf.K1_SMEM_BYTES_2}
    assert (lay["occupancy"], lay["bglob"]) == (occupancy, rows_in_device_memory)
    assert lay["smem_bytes"] <= limit[occupancy]
    assert (lay["blk_floats"] > 0) == any(rows_in_device_memory)
    if (cfg_fn, n) == ("lat", 16):
        monkeypatch.setattr(tf, "K1_PLACEMENTS",
                            tuple(p for p in tf.K1_PLACEMENTS if p[0] == 2))
        lay = tf.pack_weights(net, tf.build_spec(cfg, n)).layout
        assert (lay["occupancy"], lay["bglob"]) == (2, [1, 1])
        assert lay["smem_bytes"] <= limit[2] and lay["blk_floats"] > 0


@pytest.mark.parametrize("name", ["kp", "lat_topk", "kp_ckpt"])
def test_plain_matches_jax_fused(name):
    cfg, net, params, din = _case(name)
    x, ts, label = _inputs(3, din, seed=1)
    want = _jax_fused(cfg, params)(x, ts, label)
    got = tf.make_fused_net_fn(cfg, net, N)(*_t(x, ts, label))
    assert_close(want, got, atol=2e-5)


@pytest.mark.parametrize("name", ["kp", "lat_topk", "kp_ckpt"])
def test_plain_matches_the_module(name):
    cfg, net, _, din = _case(name)
    x, ts, label = _t(*_inputs(4, din, seed=2))
    with torch.no_grad():
        want = net(x, ts=ts, label=label)
    got = tf.make_fused_net_fn(cfg, net, N)(x, ts, label)
    np.testing.assert_allclose(to_np(got), to_np(want), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", ["lat_topk", "kp_ckpt"])
def test_duplicate_points_stay_finite(name):
    # equal points have distance 0 and a kNN weight 1 / 1e-8: huge, but finite
    cfg, net, _, din = _case(name)
    x, ts, label = _inputs(2, din, seed=3)
    x[:, 1] = x[:, 0]
    x[:, 2] = x[:, 0]
    x[:, 7:] = x[:, 6:7]
    got = tf.make_fused_net_fn(cfg, net, N)(*_t(x, ts, label))
    assert got.shape == (2, N, din) and torch.isfinite(got).all()


# ---------------------------------------------------------------------------
# Past 32 points, up to the kernels' limit of 64: the narrow nets with every
# level's npoint = N and SA nsample [N, 16], so that the first SA level groups
# all points in index order and the second and the KnnFP levels pick by kNN

def _wide_case(name, n):
    """(config, port module, flax params, din) of a narrow net at n points."""
    cfg = _narrow(j_kp_config if name == "kp" else j_lat_config, nsample=[n, 16])
    cfg["architecture"]["npoint"] = [n, n]
    net = _perturbed_net(cfg, seed=n + len(name))
    return cfg, net, flax_params_of(net), 3 + cfg["in_fea_dim"]


@pytest.mark.parametrize("name,n", [
    ("kp", 64), ("lat", 64),
    ("kp", 40),           # five points a block, not a power of two
])
def test_plain_matches_jax_fused_past_32_points(name, n):
    cfg, net, params, din = _wide_case(name, n)
    assert tf.scope_error(cfg, n) is None
    x, ts, label = _inputs(3, din, seed=n, n=n)
    x[:, n - 1] = x[:, 33]                 # a duplicate past index 31
    spec = jf.build_spec(cfg, n)
    weights = jf.extract_weights(params)
    want = fast_jit(lambda xx, tt, ll: jf.fused_forward(spec, weights, xx, tt, ll,
                                                         use_pallas=False), x, ts, label)
    fn = tf.make_fused_net_fn(cfg, net, n)
    assert fn.packed.layout["n"] == n
    got = fn(*_t(x, ts, label))
    assert got.shape == (3, n, din)
    assert_close(want, got, atol=2e-5)


@pytest.mark.parametrize("k", [8, 16, 64])
def test_knn_ties_past_index_31_match_jax(k):
    # integer coordinates (every distance exact in both packages) with
    # copies of points below 32 placed past it: equal distances everywhere,
    # decided by the lowest index.  The port's kNN (the stable sort the
    # plain version and the kernels' masked argmin agree with) against JAX's
    # `_topk_onehot`, the TPU kernel's
    rng = np.random.default_rng(k)
    xyz = rng.integers(-2, 3, (2, 64, 3)).astype(np.float32)
    xyz[:, 40:48] = xyz[:, 3:11]
    xyz[:, 63] = xyz[:, 0]
    xyz[:, 33] = xyz[:, 5]
    d = tf.pairwise_sqdist(torch.as_tensor(xyz))
    jd = jf._pairwise_sqdist(jnp.asarray(xyz))
    np.testing.assert_array_equal(to_np(d), np.asarray(jd))
    want = np.asarray(jnp.argmax(jf._topk_onehot(jd, k), axis=-1))
    got = to_np(tf.knn_from_sqdist(d, k))
    np.testing.assert_array_equal(got, want)
    assert (got >= 32).any() and all(len(set(row)) == k for row in got.reshape(-1, k))



# Past 64 points, up to the kernels' limit of 128: the kNN keeps its taken
# points in two 64-bit words; the narrow nets as above (the first SA level
# groups all points, the second and the KnnFP levels pick by kNN)

@pytest.mark.parametrize("name,n", [("kp", 128), ("lat", 128), ("kp", 96)])
def test_plain_matches_jax_fused_past_64_points(name, n):
    cfg, net, params, din = _wide_case(name, n)
    assert tf.scope_error(cfg, n) is None
    x, ts, label = _inputs(2, din, seed=n + 1, n=n)
    x[:, n - 1] = x[:, 70]                 # duplicates past index 63, the last at n - 1
    x[:, 66] = x[:, 2]
    spec = jf.build_spec(cfg, n)
    weights = jf.extract_weights(params)
    want = fast_jit(lambda xx, tt, ll: jf.fused_forward(spec, weights, xx, tt, ll,
                                                         use_pallas=False), x, ts, label)
    fn = tf.make_fused_net_fn(cfg, net, n)
    assert fn.packed.layout["n"] == n
    got = fn(*_t(x, ts, label))
    assert got.shape == (2, n, din)
    assert_close(want, got, atol=2e-5)


@pytest.mark.parametrize("k", [8, 100, 128])
def test_knn_ties_past_index_63_match_jax(k):
    # as at 64 points, at 128: integer coordinates, copies of points below
    # 64 placed past it and at index 127, ties decided by the lowest index
    rng = np.random.default_rng(k + 1)
    xyz = rng.integers(-2, 3, (2, 128, 3)).astype(np.float32)
    xyz[:, 90:100] = xyz[:, 5:15]
    xyz[:, 127] = xyz[:, 0]
    xyz[:, 64] = xyz[:, 63]
    d = tf.pairwise_sqdist(torch.as_tensor(xyz))
    jd = jf._pairwise_sqdist(jnp.asarray(xyz))
    np.testing.assert_array_equal(to_np(d), np.asarray(jd))
    want = np.asarray(jnp.argmax(jf._topk_onehot(jd, k), axis=-1))
    got = to_np(tf.knn_from_sqdist(d, k))
    np.testing.assert_array_equal(got, want)
    assert (got >= 64).any() and all(len(set(row)) == k for row in got.reshape(-1, k))

def test_presets_are_in_the_fused_scope_up_to_64_points(monkeypatch):
    # both shipped DDPM presets at every cloud size from 17 to 128 points:
    # in the scope, and both kernels' plans fit the card; 129 names the limit.
    # The plans do not read the weights' values: their copies (2 s a pack at
    # full width) are left out
    from slide_tpu_torch.configs import keypoint_ddpm_config, latent_ddpm_config
    monkeypatch.setattr(tf, "pack_flat", lambda sources: torch.zeros(0))
    monkeypatch.setattr(tf, "_transpose_gather", lambda rec, size: torch.zeros(0))
    for cfg_fn in (keypoint_ddpm_config, latent_ddpm_config):
        net = ConditionalPointNet2(cfg_fn("airplane")["pointnet_config"])
        for n in range(17, 129):
            cfg = cfg_fn("airplane", num_keypoints=n)["pointnet_config"]
            assert tf.scope_error(cfg, n) is None, (cfg_fn.__name__, n)
            packed = tf.pack_weights(net, tf.build_spec(cfg, n))
            assert packed.layout["n"] == n and packed.layout["smem_bytes"] <= tf.K1_SMEM_BYTES
            assert packed.layout2["smem_bytes"] <= tf.K1_SMEM_BYTES
        cfg = cfg_fn("airplane", num_keypoints=129)["pointnet_config"]
        assert "at most 128 points" in tf.scope_error(cfg, 129)


# The packed tables of the shipped 16-point nets (sha256 of the int32
# entries of TABLE, TABLE2, K2's jobs and its block list), as packed before
# the kernels took 64 points: the main path's plans stay as they were
PLANS_16 = {
    "kp": ("0d012393c1dc49fdea166873bb928fd7e13cdeba55b23ac4fd585d711999be9b",
           "f6f78771bd25dc665b0fef37b2ca8e8dd154a2639b97daf57d94d6aa406b4ae7",
           "a883fa4f0ad2d0ab51cc27d4a18e80c8612a05136369001448a3b8bc0e58c815",
           "6d4f2235a3fda710c0e8318cf8992a242bc94a3c4e3632c4eabd08bdb7da2c9a"),
    "lat": ("b6bc5743610a361b201e6e9ecb0b4b2d94deda02cf76a8c48b3c6f9a79fa278a",
            "f5be2b1c527f0d45ec3a220c20860b90e815dd7863b105bf60b96d65089ed006",
            "86dd6312bf9a177cb035b3ae4feb633fac8ca87df8238812c7164ab9526feefa",
            "85bde9b96069b50f7ec6f86d7d048f6cbb4f6cdd7648a921f8f7e30b462619c6"),
}


@pytest.mark.parametrize("name", ["kp", "lat"])
def test_16_point_plans_are_unchanged(name):
    from slide_tpu_torch.configs import keypoint_ddpm_config, latent_ddpm_config
    cfg = {"kp": keypoint_ddpm_config, "lat": latent_ddpm_config}[name](
        "airplane")["pointnet_config"]
    p = tf.pack_weights(ConditionalPointNet2(cfg), tf.build_spec(cfg, 16))

    def sha(ints):
        return hashlib.sha256(np.asarray(ints, np.int32).tobytes()).hexdigest()

    got = (sha(tf.encode_table(tf.TABLE, p.layout)), sha(tf.encode_table(tf.TABLE2, p.layout2)),
           sha(p.jobs.numpy()), sha(p.tiles.numpy()))
    assert got == PLANS_16[name]


# ---------------------------------------------------------------------------
# K1's product arithmetic (3xTF32 on the tensor cores), emulated on the CPU:
# does it keep the card's gate (K1 within 1e-4 of the fp32 plain version)?

K1_ATOL = 1e-4


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits), to nearest, ties away from zero,
    through its int32 view: K1's rounding (cvt.rna.tf32.f32)."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def test_tf32_rounding():
    # ties go away from zero; below half an ulp (2^-10) rounds down
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11, -(1.0 + 2 ** -11),
                      1.0 + 2 ** -12, -7.25])
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -9, -(1.0 + 2 ** -10), 1.0, -7.25])
    assert torch.equal(_tf32(x), want)
    hi = _tf32(x)
    assert torch.equal(_tf32(hi), hi)


def _dense_3xtf32(x, flat, d):
    """K1's weight product: x and W split into TF32 hi + lo parts, the three
    products lo.hi + hi.lo + hi.hi summed in fp32, then the bias.  The
    injection vectors (one row per cloud) stay fp32, as in K1."""
    if x.dim() < 3:
        return _PLAIN_DENSE(x, flat, d)
    w = flat[d["w"]:d["w"] + d["cin"] * d["cout"]].view(d["cin"], d["cout"])
    xh, wh = _tf32(x), _tf32(w)
    xl, wl = _tf32(x - xh), _tf32(w - wh)
    y = torch.matmul(xl, wh) + torch.matmul(xh, wl) + torch.matmul(xh, wh)
    if d["b"] >= 0:
        y = y + flat[d["b"]:d["b"] + d["cout"]]
    return y


_PLAIN_DENSE = tf._dense


@pytest.mark.parametrize("name", ["kp", "lat"])
def test_3xtf32_products_keep_the_k1_gate(name, monkeypatch):
    cfg = (j_kp_config if name == "kp" else j_lat_config)("airplane")["pointnet_config"]
    net = load_flax_params(ConditionalPointNet2(cfg),
                           load_inference_params(str(DEFAULT_CKPTS[name]))).eval()
    fn = tf.make_fused_net_fn(cfg, net, N)
    x, ts, label = _t(*_inputs(5, 3 + cfg["in_fea_dim"], seed=11))
    with torch.no_grad():
        t4, cls = net.t_embedder(ts), net.class_emb(label.long())
        want = tf.fused_forward_plain(fn.spec, fn.packed, x, t4, cls)
        monkeypatch.setattr(tf, "_dense", _dense_3xtf32)
        got = tf.fused_forward_plain(fn.spec, fn.packed, x, t4, cls)
    err = float((got - want).abs().max())
    assert 0 < err <= K1_ATOL, err


# K2's product arithmetic, emulated on the CPU: the recompute's products and
# both of the backward's (d input = dY W^T on the chain, d W = X^T dY in the
# weight-gradient launch) in 3xTF32; the injections' (one row a cloud) stay
# fp32 on the chain, their d W is 3xTF32 too.  Does it keep K2's gate?

K2_TOL = 1e-4


def _mm_3xtf32(a, b):
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return torch.matmul(al, bh) + torch.matmul(ah, bl) + torch.matmul(ah, bh)


class _DenseK2(torch.autograd.Function):
    """y = x W with K2's arithmetic in both directions (`rows`: x has a row
    per grouped slot or point, as the chain's products; else one per cloud,
    as an injection)."""

    @staticmethod
    def forward(ctx, x, w, rows):
        ctx.save_for_backward(x, w)
        ctx.rows = rows
        return _mm_3xtf32(x, w) if rows else torch.matmul(x, w)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        dx = _mm_3xtf32(gy, w.t()) if ctx.rows else torch.matmul(gy, w.t())
        dw = _mm_3xtf32(x.reshape(-1, x.shape[-1]).t(), gy.reshape(-1, gy.shape[-1]))
        return dx, dw, None


def _dense_k2(x, flat, d):
    w = flat[d["w"]:d["w"] + d["cin"] * d["cout"]].view(d["cin"], d["cout"])
    y = _DenseK2.apply(x, w, x.dim() == 3)
    if d["b"] >= 0:
        y = y + flat[d["b"]:d["b"] + d["cout"]]
    return y


@pytest.fixture
def one_thread():
    # the reference's search reruns a float64 backward of many small
    # operations: with a thread pool per test process they crowd the cores
    # when the tests run in several processes at once (tens of times slower)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", ["kp", "lat"])
def test_3xtf32_products_keep_the_k2_gate(name, monkeypatch, one_thread):
    cfg = (j_kp_config if name == "kp" else j_lat_config)("airplane")["pointnet_config"]
    net = load_flax_params(ConditionalPointNet2(cfg),
                           load_inference_params(str(DEFAULT_CKPTS[name]))).eval()
    packed = tf.pack_weights(net, tf.build_spec(cfg, N))
    din = 3 + cfg["in_fea_dim"]
    x, ts, label = _t(*_inputs(2, din, seed=12))
    g = torch.as_tensor(np.random.default_rng(13).standard_normal((2, N, din)),
                        dtype=torch.float32)
    with torch.no_grad():
        t4, cls = net.t_embedder(ts), net.class_emb(label.long())
    with monkeypatch.context() as m:
        m.setattr(tf, "_dense", _dense_k2)
        got = tf.fused_backward_plain(packed, x, t4, cls, g)
    want, _ = tf.fused_backward_reference(packed, x, t4, cls, g, got, tol=K2_TOL)
    for what, a, w in zip(("d pc", "d t4", "d cls", "d flat"), got, want):
        err, bound = float((a.double() - w).abs().max()), K2_TOL * max(1.0, float(w.abs().max()))
        assert 0 < err <= bound, (what, err, bound)


def _chain_noise(key, shape, steps):
    """A JAX chain's draws: the first split for x_T, then one per step."""
    key, k = jax.random.split(key)
    draws = [jax.random.normal(k, shape)]
    for _ in range(steps):
        key, k = jax.random.split(key)
        draws.append(jax.random.normal(k, shape))
    return [torch.as_tensor(np.array(d)) for d in draws]


def _replay(draws):
    it = iter(draws)
    return lambda shape: next(it)


@pytest.mark.parametrize("sampler", ["ddpm", "fastdpm"])
def test_fused_kp_chain_matches_jax(sampler):
    cfg, net, params, _ = _case("kp")
    b, steps = 2, 5
    label = np.array([0, 4], np.int32)
    jfn = jf.make_fused_net_fn(cfg, params, N, use_pallas=False)
    tfn = tf.make_fused_net_fn(cfg, net, N)
    key = jax.random.key(7)
    shape = (b, N, 3)
    jsched = jeps.calc_diffusion_hyperparams(100 if sampler == "fastdpm" else steps,
                                             1e-4, 0.02)
    tsched = td.calc_diffusion_hyperparams(jsched.T, 1e-4, 0.02)

    def jnet(x, ts):
        return jfn(x, ts, jnp.asarray(label))

    def tnet(x, ts):
        return tfn(x, ts, torch.as_tensor(label))

    if sampler == "ddpm":
        want = jax.jit(lambda k: jeps.diffusion_sampling(jnet, k, shape, jsched))(key)
        got = td.diffusion_sampling(tnet, shape, tsched, _replay(_chain_noise(key, shape,
                                                                            steps)))
    else:
        dc = {"T": 100, "beta_0": 1e-4, "beta_T": 0.02}
        want = jax.jit(lambda k: jfast.fast_sampling(
            jnet, k, shape, jsched, dc, length=steps, sampling_method="step",
            schedule="quadratic", kappa=0.5))(key)
        got = tfast.fast_sampling(tnet, shape, tsched, dc,
                                  _replay(_chain_noise(key, shape, steps)), length=steps,
                                  sampling_method="step", schedule="quadratic", kappa=0.5)
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-4)


def test_fused_kp_chain_at_64_points_matches_jax():
    # five DDPM steps of the narrow kp net at 64 points, JAX's draws replayed
    cfg, net, params, _ = _wide_case("kp", 64)
    b, steps, n = 2, 5, 64
    label = np.array([3, 9], np.int32)
    jfn = jf.make_fused_net_fn(cfg, params, n, use_pallas=False)
    tfn = tf.make_fused_net_fn(cfg, net, n)
    key = jax.random.key(9)
    shape = (b, n, 3)
    jsched = jeps.calc_diffusion_hyperparams(steps, 1e-4, 0.02)
    want = fast_jit(lambda k: jeps.diffusion_sampling(
        lambda x, ts: jfn(x, ts, jnp.asarray(label)), k, shape, jsched), key)
    got = td.diffusion_sampling(lambda x, ts: tfn(x, ts, torch.as_tensor(label)), shape,
                                td.calc_diffusion_hyperparams(steps, 1e-4, 0.02),
                                _replay(_chain_noise(key, shape, steps)))
    assert got.shape == shape
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-4)


def test_fused_lat_chain_matches_jax():
    cfg, net, params, din = _case("lat_topk")
    b, steps = 2, 5
    label = np.array([1, 2], np.int32)
    jfn = jf.make_fused_net_fn(cfg, params, N, use_pallas=False)
    tfn = tf.make_fused_net_fn(cfg, net, N)
    kp = np.random.default_rng(4).standard_normal((b, N, 3)).astype(np.float32)
    sdc = dict(j_lat_config()["standard_diffusion_config"], num_diffusion_timesteps=steps)
    key = jax.random.key(8)
    shape = (b, N, din)
    want = jax.jit(lambda k: jx0.x0_denoise(
        lambda x, ts: jfn(x, ts, jnp.asarray(label)), k, shape,
        jx0.X0Schedule.from_config(sdc), keypoint=jnp.asarray(kp), keypoint_dim=3))(key)
    got = td.x0_denoise(lambda x, ts: tfn(x, ts, torch.as_tensor(label)), shape,
                        td.X0Schedule.from_config(sdc),
                        _replay(_chain_noise(key, shape, steps)),
                        keypoint=torch.as_tensor(kp), keypoint_dim=3)
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-4)


# ---------------------------------------------------------------------------
# FastDPM

_DC = {"T": 1000, "beta_0": 1e-4, "beta_T": 0.02}


@pytest.mark.parametrize("schedule", ["linear", "quadratic"])
@pytest.mark.parametrize("s", [5, 50])
def test_fastdpm_schedules_equal_jax(schedule, s):
    np.testing.assert_array_equal(tfast.get_var_noise(s, _DC, schedule),
                                  jfast.get_var_noise(s, _DC, schedule))
    assert tfast.get_step_steps(s, _DC, schedule) == jfast.get_step_steps(s, _DC, schedule)
    eta = jfast.get_var_noise(s, _DC, schedule)
    jsched = jeps.calc_diffusion_hyperparams(1000, 1e-4, 0.02)
    tsched = td.calc_diffusion_hyperparams(1000, 1e-4, 0.02)
    np.testing.assert_allclose(tfast.precompute_var_steps(tsched, eta, 1e-4, 0.02),
                               jfast.precompute_var_steps(jsched, eta, 1e-4, 0.02),
                               rtol=0, atol=1e-6)
    assert tfast.diffusion_config_of(tsched) == jfast.diffusion_config_of(jsched)


def _closed_form_nets():
    # a network stand-in with the samplers' signature: depends on x and t
    def jnet(x, ts):
        return 0.3 * jnp.tanh(x) + 1e-3 * ts[:, None, None].astype(jnp.float32)

    def tnet(x, ts):
        return 0.3 * torch.tanh(x) + 1e-3 * ts[:, None, None].float()

    return jnet, tnet


@pytest.mark.parametrize("method", ["var", "step"])
def test_fast_sampling_closed_form(method):
    jnet, tnet = _closed_form_nets()
    shape, s = (3, N, 3), 5
    key = jax.random.key(21)
    dc = {"T": 200, "beta_0": 1e-4, "beta_T": 0.02}
    want = jfast.fast_sampling(jnet, key, shape, jeps.calc_diffusion_hyperparams(200, 1e-4,
                                                                                 0.02),
                               dc, length=s, sampling_method=method, kappa=0.5)
    got = tfast.fast_sampling(tnet, shape, td.calc_diffusion_hyperparams(200, 1e-4, 0.02),
                              dc, _replay(_chain_noise(key, shape, s)), length=s,
                              sampling_method=method, kappa=0.5)
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("kappa", [0.0, 0.5])
def test_fast_x0_denoise_closed_form(kappa):
    jnet, tnet = _closed_form_nets()
    shape, s = (2, N, 9), 5
    key = jax.random.key(22)
    kp = np.random.default_rng(5).standard_normal((2, N, 3)).astype(np.float32)
    sdc = dict(j_lat_config()["standard_diffusion_config"], num_diffusion_timesteps=100)
    want = jfast.fast_x0_denoise(jnet, key, shape, jx0.X0Schedule.from_config(sdc),
                                 length=s, kappa=kappa, keypoint=jnp.asarray(kp),
                                 keypoint_dim=3)
    got = tfast.fast_x0_denoise(tnet, shape, td.X0Schedule.from_config(sdc),
                                _replay(_chain_noise(key, shape, s)), length=s,
                                kappa=kappa, keypoint=torch.as_tensor(kp), keypoint_dim=3)
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-5)
    np.testing.assert_array_equal(to_np(got)[..., :3], kp)
