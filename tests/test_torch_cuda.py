"""Tests of the port's CUDA kernels (FPS, the fused denoiser and its
backward) on the card; they skip without one.

On a machine with the card, `nvcc` and no JAX, run them from the repository
root with `python3 -m pytest --noconftest -q tests/test_torch_cuda.py` (the
root conftest imports JAX).  This file imports neither JAX nor the JAX
package."""

import pytest
import torch

from slide_tpu_torch import _build
from slide_tpu_torch.ops import fps


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,num_forced", [(64, 16, 0), (512, 256, 0), (2049, 100, 2),
                                            (4096, 2048, 0), (10000, 64, 0)])
def test_fps_kernel_matches_plain(cuda, n, k, num_forced):
    gen = torch.Generator(device=cuda).manual_seed(n)
    xyz = torch.randn((5, n, 3), generator=gen, device=cuda)
    start = torch.randint(0, n, (5,), generator=gen, device=cuda, dtype=torch.int32)
    if num_forced:
        start.zero_()
    assert torch.equal(fps.fps_cuda(xyz, k, start, num_forced),
                       fps.fps_plain(xyz, k, start, num_forced))


@pytest.mark.cuda
def test_fps_kernel_all_channels_and_ties(cuda):
    # six channels (the distance runs over all of them) and a grid with ties
    gen = torch.Generator(device=cuda).manual_seed(1)
    xyz = torch.randint(-2, 3, (4, 300, 6), generator=gen, device=cuda).float()
    start = torch.tensor([0, 7, 299, 150], dtype=torch.int32, device=cuda)
    assert torch.equal(fps.fps_cuda(xyz, 40, start), fps.fps_plain(xyz, 40, start))


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,b", [(512, 256, 16), (256, 128, 16), (128, 64, 16), (64, 16, 16),
                                   (2048, 1024, 16), (1024, 256, 16), (256, 64, 16),
                                   (4096, 2048, 16), (2049, 16, 32)])
def test_fps_kernel_ties_at_the_main_path_shapes(cuda, n, k, b):
    # the decode's nine shapes and training's: every point has two copies
    # (and a grid of values), so that ties decide picks; random starts
    gen = torch.Generator(device=cuda).manual_seed(n + k)
    half = torch.randint(-3, 4, (b, (n + 1) // 2, 3), generator=gen, device=cuda).float()
    xyz = torch.cat([half, half], dim=1)[:, :n].contiguous()
    start = torch.randint(0, n, (b,), generator=gen, device=cuda, dtype=torch.int32)
    assert torch.equal(fps.fps_cuda(xyz, k, start), fps.fps_plain(xyz, k, start))


@pytest.mark.cuda
def test_fps_wrapper_counts_launches_and_checks_inputs(cuda):
    xyz = torch.randn((2, 128, 3), device=cuda)
    before = _build.launch_counts["fps"]
    fps.furthest_point_sample(xyz, 8)
    fps.furthest_point_sample(xyz[..., :3], 8, start_idx=torch.tensor([3, 5]))
    assert _build.launch_counts["fps"] == before + 2
    start = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        fps.fps_cuda(xyz.double(), 8, start)
    with pytest.raises(ValueError):
        fps.fps_cuda(torch.randn((2, 3, 128), device=cuda).transpose(1, 2), 8, start)
    with pytest.raises(ValueError):
        fps.fps_cuda(torch.randn((2, 20000, 3), device=cuda), 8, start)


# ---------------------------------------------------------------------------
# K1, the fused denoiser (csrc/fused_denoiser.cu), against its plain version
# on the card, with the committed checkpoints.  Both are fp32 (TF32 off);
# sums run in other orders, so they agree to atol 1e-4 on outputs of
# magnitude ~1-4 (the JAX package's own fused-vs-module tolerance).

K1_ATOL = 1e-4


@pytest.fixture(scope="module")
def fused_nets():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    from slide_tpu_torch.configs import keypoint_ddpm_config, latent_ddpm_config
    from slide_tpu_torch.models import ConditionalPointNet2
    from slide_tpu_torch.models.fused_denoiser import make_fused_net_fn
    from slide_tpu_torch.pipeline import DEFAULT_CKPTS
    from slide_tpu_torch.weights import load_flax_params, load_inference_params
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    nets = {}
    for name, cfg_fn, din in [("kp", keypoint_ddpm_config, 3),
                              ("lat", latent_ddpm_config, 51)]:
        cfg = cfg_fn("airplane")["pointnet_config"]
        net = ConditionalPointNet2(cfg)
        load_flax_params(net, load_inference_params(str(DEFAULT_CKPTS[name])))
        net = net.cuda().eval()
        nets[name] = (net, make_fused_net_fn(cfg, net, 16), din)
    return nets


def _k1_inputs(net, b, din, seed, duplicates=False):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    pc = torch.randn((b, 16, din), generator=gen, device="cuda")
    if duplicates:
        pc[:, 1] = pc[:, 0]          # two equal points, and a third near them
        pc[:, 2] = pc[:, 0]
        pc[:, 5, :3] = pc[:, 0, :3] + 1e-4
    ts = torch.randint(0, 1000, (b,), generator=gen, device="cuda")
    label = torch.randint(0, 13, (b,), generator=gen, device="cuda")
    with torch.no_grad():
        return pc, net.t_embedder(ts).contiguous(), net.class_emb(label).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["kp", "lat"])
@pytest.mark.parametrize("b", [1, 5, 16, 33])
@pytest.mark.parametrize("duplicates", [False, True])
def test_k1_matches_plain(fused_nets, name, b, duplicates):
    from slide_tpu_torch.models import fused_denoiser as fd
    net, fn, din = fused_nets[name]
    pc, t4, cls = _k1_inputs(net, b, din, seed=b, duplicates=duplicates)
    got = fd.fused_forward_cuda(fn.packed, pc, t4, cls)
    want = fd.fused_forward_plain(fn.spec, fn.packed, pc, t4, cls)
    torch.cuda.synchronize()
    assert got.shape == (b, 16, din)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=K1_ATOL, rtol=0)


def _random_fused_net(cfg, n, seed):
    """A fused net over random weights: the JAX package's initialisers, then
    every parameter (biases and GroupNorm affines included) moved by 0.1 x
    N(0, 1)."""
    from slide_tpu_torch.models import ConditionalPointNet2
    from slide_tpu_torch.models.fused_denoiser import make_fused_net_fn
    from slide_tpu_torch.train.driver import init_params
    gen = torch.Generator().manual_seed(seed)
    net = init_params(ConditionalPointNet2(cfg), gen)
    with torch.no_grad():
        for p in net.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=gen))
    net = net.cuda().eval()
    return net, make_fused_net_fn(cfg, net, n)


@pytest.mark.cuda
@pytest.mark.parametrize("case,n,b", [
    ("lat32", 32, 3),     # 1024 grouped rows per cloud, widths up to 779: rows in device memory
    ("kp8", 8, 5),        # one point per block
    ("kp", 16, 300),      # 2400 blocks: several waves
])
def test_k1_matches_plain_scope(cuda, case, n, b):
    # K1 at the edges of its stated scope, random weights, against its plain
    # version at atol 1e-4
    from slide_tpu_torch.configs import keypoint_ddpm_config, latent_ddpm_config
    from slide_tpu_torch.models import fused_denoiser as fd
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg_fn = latent_ddpm_config if case.startswith("lat") else keypoint_ddpm_config
    cfg = cfg_fn("airplane", num_keypoints=n)["pointnet_config"]
    assert fd.scope_error(cfg, n) is None
    net, fn = _random_fused_net(cfg, n, seed=n + b)
    din = 3 + cfg["in_fea_dim"]
    gen = torch.Generator(device="cuda").manual_seed(b)
    pc = torch.randn((b, n, din), generator=gen, device="cuda")
    ts = torch.randint(0, 1000, (b,), generator=gen, device="cuda")
    label = torch.randint(0, 13, (b,), generator=gen, device="cuda")
    with torch.no_grad():
        t4, cls = net.t_embedder(ts).contiguous(), net.class_emb(label).contiguous()
        got = fd.fused_forward_cuda(fn.packed, pc, t4, cls)
        want = fd.fused_forward_plain(fn.spec, fn.packed, pc, t4, cls)
    torch.cuda.synchronize()
    assert got.shape == (b, n, din) and torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=K1_ATOL, rtol=0)


@pytest.mark.cuda
def test_k1_wrapper_counts_launches_and_checks_inputs(fused_nets):
    from slide_tpu_torch.models import fused_denoiser as fd
    net, fn, din = fused_nets["kp"]
    pc, t4, cls = _k1_inputs(net, 4, din, seed=0)
    ts = torch.zeros(4, dtype=torch.int32, device="cuda")
    label = torch.zeros(4, dtype=torch.int64, device="cuda")
    before = _build.launch_counts["fused_denoiser"]
    fn(pc, ts, label)
    fd.fused_forward(fn.spec, fn.packed, pc, t4, cls)
    assert _build.launch_counts["fused_denoiser"] == before + 2
    with pytest.raises(TypeError):
        fd.fused_forward_cuda(fn.packed, pc.double(), t4, cls)
    with pytest.raises(ValueError):
        fd.fused_forward_cuda(fn.packed, pc.transpose(0, 1).contiguous().transpose(0, 1),
                              t4, cls)
    with pytest.raises(ValueError):
        fd.fused_forward_cuda(fn.packed, torch.randn((4, 16, 51), device="cuda"), t4, cls)
    with pytest.raises(ValueError):
        fd.fused_forward_cuda(fn.packed, pc, t4[:, :100].contiguous(), cls)
    with pytest.raises(ValueError):
        fd.fused_forward_cuda(fn.packed, pc.cpu(), t4, cls)
    assert _build.launch_counts["fused_denoiser"] == before + 2


# ---------------------------------------------------------------------------
# K2, the fused denoiser's backward (csrc/fused_denoiser_bwd.cu), against its
# plain version (autograd through fused_forward_plain) run in float64 on the
# same inputs and weights (at exact duplicates the fp32 plain version's
# d(pc) sums terms of ~1e7 that cancel): every element of each gradient
# within 1e-4 x max(1, max |plain|).  A relu whose input lies within fp32
# rounding of 0 (a tie) passes its gradient in one fp32 backward and not in
# another; the reference resolves such ties as K2 did
# (`fused_backward_reference`, chip_smoke.py's K2_TOL).

K2_TOL = 1e-4


def _k2_within(got, want) -> bool:
    """Every element of each gradient within K2_TOL x max(1, max |want|)."""
    return all(bool(torch.isfinite(a).all()) and
               float((a.double() - w).abs().max()) <= K2_TOL * max(1.0, float(w.abs().max()))
               for a, w in zip(got, want))


def _k2_close(fn, pc, t4, cls, g, got, what):
    from slide_tpu_torch.models import fused_denoiser as fd
    want, _ = fd.fused_backward_reference(fn.packed, pc, t4, cls, g, got, tol=K2_TOL)
    for name, a, w in zip(("d pc", "d t4", "d cls", "d flat"), got, want):
        assert torch.isfinite(a).all(), f"{what}: {name} not finite"
        err, bound = float((a.double() - w).abs().max()), K2_TOL * max(1.0, float(w.abs().max()))
        assert err <= bound, f"{what}: {name} differs by {err}, bound {bound}"


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["kp", "lat"])
@pytest.mark.parametrize("b", [1, 5, 32, 33])
@pytest.mark.parametrize("duplicates", [False, True])
def test_k2_matches_plain(fused_nets, name, b, duplicates):
    from slide_tpu_torch.models import fused_denoiser as fd
    net, fn, din = fused_nets[name]
    pc, t4, cls = _k1_inputs(net, b, din, seed=100 + b, duplicates=duplicates)
    if duplicates:
        pc[:, 5] = pc[:, 0]          # exact duplicates only: d = 0 on both sides
    g = torch.randn((b, 16, din), generator=torch.Generator(device="cuda").manual_seed(b),
                    device="cuda")
    got = fd.fused_backward_cuda(fn.packed, pc, t4, cls, g)
    again = fd.fused_backward_cuda(fn.packed, pc, t4, cls, g)
    _k2_close(fn, pc, t4, cls, g, got, f"{name} batch {b}")
    for a, c in zip(got, again):
        assert torch.equal(a, c)               # deterministic: two launches equal


@pytest.mark.cuda
@pytest.mark.parametrize("case,n,b", [
    ("lat32", 32, 3),     # 1024 grouped rows per cloud, widths up to 779
    ("kp8", 8, 5),        # two points per block
    ("kp", 16, 300),      # 300 clusters: several waves
])
def test_k2_matches_plain_scope(cuda, case, n, b):
    # K2 at the edges of the fused scope (K1's), random weights, against the
    # float64 reference at the K2 gate; two launches equal
    from slide_tpu_torch.configs import keypoint_ddpm_config, latent_ddpm_config
    from slide_tpu_torch.models import fused_denoiser as fd
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg_fn = latent_ddpm_config if case.startswith("lat") else keypoint_ddpm_config
    cfg = cfg_fn("airplane", num_keypoints=n)["pointnet_config"]
    assert fd.scope_error(cfg, n) is None
    net, fn = _random_fused_net(cfg, n, seed=n + b)
    din = 3 + cfg["in_fea_dim"]
    gen = torch.Generator(device="cuda").manual_seed(b)
    pc = torch.randn((b, n, din), generator=gen, device="cuda")
    g = torch.randn((b, n, din), generator=gen, device="cuda")
    ts = torch.randint(0, 1000, (b,), generator=gen, device="cuda")
    label = torch.randint(0, 13, (b,), generator=gen, device="cuda")
    with torch.no_grad():
        t4, cls = net.t_embedder(ts).contiguous(), net.class_emb(label).contiguous()
    got = fd.fused_backward_cuda(fn.packed, pc, t4, cls, g)
    again = fd.fused_backward_cuda(fn.packed, pc, t4, cls, g)
    for a, c in zip(got, again):
        assert torch.equal(a, c)
    # Cloud by cloud (the reference's search for relu ties is per launch, and
    # 300 clouds hold more ties than it tries): each cloud alone gives the
    # batch's d pc, d t4, d cls; its four gradients are held to the K2 gate
    # against the float64 reference with its own ties resolved.  The
    # batch's d flat is held to the sum of the clouds' references.
    want_flat = torch.zeros_like(got[3], dtype=torch.float64)
    for c in range(b):
        one = [x[c:c + 1].contiguous() for x in (pc, t4, cls, g)]
        mine = fd.fused_backward_cuda(fn.packed, *one)
        for a, x in zip(mine[:3], got[:3]):
            assert torch.equal(a, x[c:c + 1])
        want, _ = fd.fused_backward_reference(fn.packed, *one, mine, tol=K2_TOL)
        assert _k2_within(mine, want), f"{case} cloud {c}"
        want_flat += want[3]
    assert _k2_within(got[3:], [want_flat]), case


@pytest.mark.cuda
def test_k2_wrapper_counts_launches_and_checks_inputs(fused_nets):
    from slide_tpu_torch.models import fused_denoiser as fd
    from slide_tpu_torch.configs import keypoint_ddpm_config
    net, fn, din = fused_nets["kp"]
    pc, t4, cls = _k1_inputs(net, 4, din, seed=0)
    g = torch.randn((4, 16, din), device="cuda")
    before = _build.launch_counts["fused_denoiser_bwd"]
    fd.fused_backward_cuda(fn.packed, pc, t4, cls, g)
    # the training entry point: one K1 and one K2 launch per forward/backward
    apply = fd.make_fused_train_fn(keypoint_ddpm_config()["pointnet_config"], net, 16)
    k1 = _build.launch_counts["fused_denoiser"]
    ts = torch.zeros(4, dtype=torch.int32, device="cuda")
    apply(pc, ts, torch.zeros(4, dtype=torch.int64, device="cuda")).square().mean().backward()
    assert _build.launch_counts["fused_denoiser_bwd"] == before + 2
    assert _build.launch_counts["fused_denoiser"] == k1 + 1
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in net.parameters())
    net.zero_grad(set_to_none=True)
    with pytest.raises(TypeError):
        fd.fused_backward_cuda(fn.packed, pc, t4, cls, g.double())
    with pytest.raises(ValueError):
        fd.fused_backward_cuda(fn.packed, pc, t4, cls,
                               g.transpose(0, 1).contiguous().transpose(0, 1))
    with pytest.raises(ValueError):
        fd.fused_backward_cuda(fn.packed, pc, t4, cls, g[:, :8].contiguous())
    with pytest.raises(ValueError):
        fd.fused_backward_cuda(fn.packed, pc, t4, cls, g.cpu())
    with pytest.raises(ValueError):
        fd.fused_backward_cuda(fn.packed, pc, t4, cls, g, fn.packed.flat[:-32].contiguous())
    assert _build.launch_counts["fused_denoiser_bwd"] == before + 2
