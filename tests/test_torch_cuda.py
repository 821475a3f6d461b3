"""Tests of the port's CUDA kernels (FPS, the fused denoiser and its
backward) and of the mesh stages (DPSR, the extraction, the SAP net) on the
card; they skip without one.

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


def _scope_points(b, n, din, gen):
    """Random clouds; past 64 points with copies of points past index 63
    placed at index 127 and past it (picks tied at distance 0 across the kNN
    mask's two words, decided by the lowest index)."""
    pc = torch.randn((b, n, din), generator=gen, device="cuda")
    if n > 64:
        pc[:, n - 1, :3] = pc[:, 70, :3]
        pc[:, 90, :3] = pc[:, 3, :3]
    return pc


def _scope_config(case, n):
    """The shipped preset of `case` at n points; past 32 points with SA
    nsample [n, 16], so that the first level groups all points and the
    second, as every KnnFP level, picks by kNN (picks past index 31)."""
    from slide_tpu_torch.configs import keypoint_ddpm_config, latent_ddpm_config
    cfg_fn = latent_ddpm_config if case.startswith("lat") else keypoint_ddpm_config
    cfg = cfg_fn("airplane", num_keypoints=n)["pointnet_config"]
    if n > 32:
        cfg["architecture"]["nsample"] = [n, 16]
    return cfg


@pytest.mark.cuda
@pytest.mark.parametrize("case,n,b", [
    ("lat32", 32, 3),     # 1024 grouped rows per cloud, widths up to 779: rows in device memory
    ("kp8", 8, 5),        # one point per block
    ("kp", 16, 300),      # 2400 blocks: several waves
    ("kp64", 64, 16),     # 4096 grouped rows per cloud
    ("lat64", 64, 3),
    ("kp40", 40, 5),      # five points a block
    ("kp128", 128, 3),    # the kernels' limit: 16384 grouped rows per cloud
    ("lat128", 128, 2),
])
def test_k1_matches_plain_scope(cuda, case, n, b):
    # K1 at the edges of its stated scope, random weights, against its plain
    # version at atol 1e-4
    from slide_tpu_torch.models import fused_denoiser as fd
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _scope_config(case, n)
    assert fd.scope_error(cfg, n) is None
    net, fn = _random_fused_net(cfg, n, seed=n + b)
    din = 3 + cfg["in_fea_dim"]
    gen = torch.Generator(device="cuda").manual_seed(b)
    pc = _scope_points(b, n, din, gen)
    ts = torch.randint(0, 1000, (b,), generator=gen, device="cuda")
    label = torch.randint(0, 13, (b,), generator=gen, device="cuda")
    with torch.no_grad():
        t4, cls = net.t_embedder(ts).contiguous(), net.class_emb(label).contiguous()
        got = fd.fused_forward_cuda(fn.packed, pc, t4, cls)
        want = fd.fused_forward_plain(fn.spec, fn.packed, pc, t4, cls)
    torch.cuda.synchronize()
    assert got.shape == (b, n, din) and torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=K1_ATOL, rtol=0)


# K1's products on a deep sum that cancels: two input channels of the
# latent net carry CANCEL_BIG at every point, alone in their 8-deep steps
# (the channels beside them are 0), and every product that reads them has
# the second one's weights the negation of the first one's, so that each
# such output is a sum of O(1) terms taken between two terms of ~CANCEL_BIG
# / 10 that cancel.  A tensor-core accumulator held over the whole depth
# truncates the O(1) terms to the big ones' exponent; fp32 running sums of
# fresh per-step accumulators round them.  K1 against the plain version run
# in float64 must lie no further from it than the plain fp32 version does
# (each as max |got - float64| / max(1, max |float64|)).  Measured on an
# H100 (random latent-net weights, batch 16, 8 products cancelling): the
# plain fp32 version 1.29e-4; K1 summing the whole depth in one accumulator
# 3.57e-4 (2.8x; 1.38e-3 from the plain version, beyond K1's 1e-4 gate),
# K1 with fresh accumulators per 8-deep step 5.4e-5 (0.42x).
CANCEL_BIG = 1e4
CANCEL_RATIO = 1.0


def _cancelling_flat(fd, spec, packed, pc, t4, cls):
    """packed.flat with, in every product whose input carries the two big
    channels, the second channel's weight row set to minus the first's."""
    flat = packed.flat.clone()
    real = fd._dense
    done = set()
    for _ in range(8):
        flagged = []

        def probe(x, fl, d):
            big = (x.abs() >= CANCEL_BIG / 2).reshape(-1, x.shape[-1]).all(dim=0)
            cols = torch.nonzero(big).flatten().tolist()
            if cols and d["w"] not in done:
                flagged.append((d, cols))
            return real(x, fl, d)

        fd._dense = probe
        try:
            fd.fused_forward_plain(spec, packed, pc, t4, cls, flat=flat)
        finally:
            fd._dense = real
        if not flagged:
            return flat, len(done)
        for d, cols in flagged:
            assert len(cols) == 2, cols
            w = flat[d["w"]:d["w"] + d["cin"] * d["cout"]].view(d["cin"], d["cout"])
            w[cols[1]] = -w[cols[0]]
            done.add(d["w"])
    raise AssertionError("the big channels still reach a new product")


@pytest.mark.cuda
def test_k1_cancelling_deep_sum_against_float64(cuda):
    from slide_tpu_torch.configs import latent_ddpm_config
    from slide_tpu_torch.models import fused_denoiser as fd
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = latent_ddpm_config("airplane")["pointnet_config"]
    net, fn = _random_fused_net(cfg, 16, seed=5)
    b, feat = 16, cfg["in_fea_dim"]
    gen = torch.Generator(device="cuda").manual_seed(7)
    pc = torch.randn((b, 16, 3 + feat), generator=gen, device="cuda")
    # feature 0 and the last feature big, each alone in its 8-deep step
    pc[..., 3:3 + 8] = 0.0
    pc[..., 3 + feat - 8:3 + feat] = 0.0
    pc[..., 3] = CANCEL_BIG
    pc[..., 3 + feat - 1] = CANCEL_BIG
    ts = torch.randint(0, 1000, (b,), generator=gen, device="cuda")
    label = torch.randint(0, 13, (b,), generator=gen, device="cuda")
    with torch.no_grad():
        t4, cls = net.t_embedder(ts).contiguous(), net.class_emb(label).contiguous()
        flat, n_products = _cancelling_flat(fd, fn.spec, fn.packed, pc, t4, cls)
        got = fd.fused_forward_cuda(fn.packed, pc, t4, cls, flat=flat)
        plain = fd.fused_forward_plain(fn.spec, fn.packed, pc, t4, cls, flat=flat)
        want = fd.fused_forward_plain(fn.spec, fn.packed, pc.double(), t4.double(),
                                      cls.double(), flat=flat.double())
    torch.cuda.synchronize()
    scale = max(1.0, float(want.abs().max()))
    k1_err = float((got.double() - want).abs().max()) / scale
    plain_err = float((plain.double() - want).abs().max()) / scale
    k1_vs_plain = float((got - plain).abs().max())
    print(f"k1 cancelling sum: K1 {k1_err:.3e}, plain fp32 {plain_err:.3e} of "
          f"{scale:.3f} from float64; K1 vs plain {k1_vs_plain:.3e}; {n_products} products cancel")
    assert torch.isfinite(got).all()
    assert k1_err <= CANCEL_RATIO * plain_err, (k1_err, plain_err)


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
    ("kp64", 64, 16),     # 4096 grouped rows per cloud
    ("lat64", 64, 3),
    ("kp40", 40, 5),
    ("kp128", 128, 3),    # the kernels' limit: 16384 grouped rows per cloud
    ("lat128", 128, 2),
])
def test_k2_matches_plain_scope(cuda, case, n, b):
    # K2 at the edges of the fused scope (K1's), random weights, against the
    # float64 reference at the K2 gate; two launches equal
    from slide_tpu_torch.models import fused_denoiser as fd
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _scope_config(case, n)
    assert fd.scope_error(cfg, n) is None
    net, fn = _random_fused_net(cfg, n, seed=n + b)
    din = 3 + cfg["in_fea_dim"]
    gen = torch.Generator(device="cuda").manual_seed(b)
    pc = _scope_points(b, n, din, gen)
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
def test_past_64_points_the_card_raises(cuda):
    # on the card, as on the CPU, nothing falls back to the module: 129
    # points raise naming the limit, and a batch tile whose scratch the card
    # cannot hold raises naming its size
    from slide_tpu_torch.configs import latent_ddpm_config
    from slide_tpu_torch.models import ConditionalPointNet2
    from slide_tpu_torch.models import fused_denoiser as fd
    cfg = latent_ddpm_config("airplane", num_keypoints=129)["pointnet_config"]
    net = ConditionalPointNet2(cfg).cuda()
    with pytest.raises(ValueError, match="at most 128 points.*fused=False"):
        fd.make_fused_net_fn(cfg, net, 129)
    with pytest.raises(ValueError, match="at most 128 points.*fused=False"):
        fd.make_fused_train_fn(cfg, net, 129)
    cfg = latent_ddpm_config("airplane", num_keypoints=128)["pointnet_config"]
    packed = fd.make_fused_train_fn(cfg, net, 128).packed
    b = -(-100 * 2**30 // (4 * packed.layout2["bwd_floats"]))     # 100 GiB of tape
    with pytest.raises(torch.cuda.OutOfMemoryError, match=f"K2 needs .*batch of {b}"):
        packed.bwd_scratch_for(b)
    assert packed.bwd_scratch is None


@pytest.mark.cuda
def test_k2_tiles_match_one_launch(fused_nets, monkeypatch):
    # K2 in batch tiles (one launch a tile, `PackedNet.k2_tiles`; the tape
    # budget lowered to three clouds') against one launch of the whole
    # batch: each cloud's rows of d pc, d t4 and d cls equal (a cloud's
    # chain does not see the others), d flat within the K2 gate of the
    # whole launch's (the tiles' weight sums added in order)
    from slide_tpu_torch.models import fused_denoiser as fd
    for name in ("kp", "lat"):
        net, fn, din = fused_nets[name]
        pc, t4, cls = _k1_inputs(net, 7, din, seed=70)
        g = torch.randn((7, 16, din), generator=torch.Generator(device="cuda").manual_seed(7),
                        device="cuda")
        whole = fd.fused_backward_cuda(fn.packed, pc, t4, cls, g)
        monkeypatch.setattr(fd, "K2_TAPE_FLOATS", 3 * fn.packed.layout2["bwd_floats"])
        assert fn.packed.k2_tiles(7) == [(0, 2), (2, 4), (4, 7)]
        before = _build.launch_counts["fused_denoiser_bwd"]
        tiled = fd.fused_backward_cuda(fn.packed, pc, t4, cls, g)
        again = fd.fused_backward_cuda(fn.packed, pc, t4, cls, g)
        monkeypatch.undo()
        assert _build.launch_counts["fused_denoiser_bwd"] == before + 6
        for a, c in zip(tiled, again):
            assert torch.equal(a, c)
        for a, w in zip(tiled[:3], whole[:3]):
            assert torch.equal(a, w)
        assert _k2_within(tiled[3:], [whole[3].double()]), name


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


# ---------------------------------------------------------------------------
# The mesh stages on the card against the same code on the CPU: DPSR (its
# scatter adds in no fixed order there, cuFFT rounds otherwise), the
# extraction against the numpy oracle, the full-width SAP net (TF32 off).

DPSR_CARD_ATOL = 1e-5       # chip_smoke.py's DPSR_ATOL (measured 5.4e-7 here)
# the full-width SAP net card vs CPU, the card's kNN replayed, of max(1, max
# |output|): measured 0.00047 of 335.9 (1.4e-6) once GroupNorm sums in
# float64 (0.0062 before)
SAP_NET_CARD_ATOL = 1e-5
# DPSR's gradient (points, normals) card vs CPU at 128^3, of the gradient's
# largest element: measured 5.7e-7 and 4.7e-7 (the CPU's own distance from
# float64 3.6e-7)
DPSR_GRAD_TOL = 5e-6
# each operation of the SAP net's first SA level in fp32 against float64 on
# the same input, of the output's size: measured at most 6.7e-7 (the
# injection MLP) on the card and the CPU, GroupNorms 1.8e-7
LEVEL0_TOL = 2e-6


def _sphere_points(b, n, seed):
    gen = torch.Generator().manual_seed(seed)
    d = torch.randn((b, n, 3), generator=gen)
    nrm = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    scale = 0.8 + 0.2 * torch.rand((b, n, 1), generator=gen)
    return torch.clamp(0.5 + 0.3 * nrm * scale, 0.0, 0.99), nrm


@pytest.mark.cuda
def test_dpsr_card_matches_cpu(cuda):
    from slide_tpu_torch.sap import DPSR
    from slide_tpu_torch.sap.dpsr import _irfftn, point_rasterize
    v, n = _sphere_points(2, 20480, 0)
    solver = DPSR((128,) * 3, sig=2)
    want = solver(v, n)
    got = solver.to(cuda)(v.to(cuda), n.to(cuda))
    assert got.shape == (2, 128, 128, 128) and torch.isfinite(got).all()
    err = float((got.cpu() - want).abs().max())
    print(f"dpsr card vs cpu: {err} of max {float(want.abs().max())}")
    assert err <= DPSR_CARD_ATOL
    # the inverse alone on one spectrum: cuFFT's multi-dimensional real
    # inverse reads the non-Hermitian zero and Nyquist bins of DPSR's
    # spectrum otherwise than the CPU's; `_irfftn` reads them as the CPU does
    ras = point_rasterize(v, n, (128,) * 3)
    spec = torch.fft.rfftn(ras, dim=(2, 3, 4))[:, 0] * (1j * solver.omega[..., 0].cpu())
    cpu = torch.fft.irfftn(spec, s=(128,) * 3, dim=(1, 2, 3))
    library = float((torch.fft.irfftn(spec.to(cuda), s=(128,) * 3, dim=(1, 2, 3)).cpu()
                     - cpu).abs().max())
    written_out = float((_irfftn(spec.to(cuda), (128,) * 3).cpu() - cpu).abs().max())
    print(f"inverse card vs cpu: irfftn {library}, _irfftn {written_out} "
          f"of max {float(cpu.abs().max())}")
    assert written_out <= 1e-5 * float(cpu.abs().max())


def _noisy_sphere(r, seed, noise=0.04):
    gen = torch.Generator().manual_seed(seed)
    ax = torch.arange(r, dtype=torch.float64) / (r - 1.0) - 0.5
    x, y, z = torch.meshgrid(ax, ax, ax, indexing="ij")
    return (0.35 - torch.sqrt(x * x + y * y + z * z)
            + noise * torch.randn((r, r, r), generator=gen, dtype=torch.float64)).float()


@pytest.mark.cuda
@pytest.mark.parametrize("level", [0.0, 0.05])
def test_marching_card_matches_the_numpy_oracle(cuda, level):
    from mesh_compare import assert_same_mesh
    from slide_tpu_torch.sap import (count_cells_and_faces, marching_tetrahedra_device,
                                     marching_tetrahedra_numpy, mesh_to_host)
    vols = torch.stack([_noisy_sphere(64, 1), _noisy_sphere(64, 2), _noisy_sphere(64, 3, 0.0)])
    mesh = marching_tetrahedra_device(vols.to(cuda), level)
    cells, faces = count_cells_and_faces(vols.to(cuda), level)
    assert torch.equal(cells, mesh["n_cells"]) and torch.equal(faces, mesh["n_faces"])
    for i in range(3):
        assert_same_mesh(mesh_to_host(mesh, i),
                         marching_tetrahedra_numpy(vols[i].numpy(), level))


@pytest.mark.cuda
def test_extract_and_sample_on_the_card(cuda):
    from slide_tpu_torch.sap import extract_and_sample_device
    vols = torch.stack([_noisy_sphere(64, 4), torch.full((64, 64, 64), 2.0)]).to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    pts, nrm, n_faces, n_cells, _ = extract_and_sample_device(vols, gen, 2048)
    assert pts.device.type == "cuda" and pts.shape == (2, 2048, 3)
    assert int(n_faces[0]) > 0 and int(n_faces[1]) == 0 and int(n_cells[1]) == 0
    assert torch.isfinite(pts[0]).all() and torch.isnan(pts[1]).all()
    norms = torch.linalg.vector_norm(nrm[0], dim=-1)
    assert float((norms - 1).abs().max()) < 1e-4


def _record_knn(monkeypatch):
    """Record every kNN search of the neighbourhood modules: (query, points,
    k) and the (sqdists, idx) it returned, on the host."""
    import slide_tpu_torch.nn.neighborhood as nb
    calls, real = [], nb.knn_points

    def recording(query, points, k):
        sqd, idx = real(query, points, k)
        calls.append([t.cpu() for t in (query, points, sqd, idx)])
        return sqd, idx

    monkeypatch.setattr(nb, "knn_points", recording)
    return calls


def _replay_knn(monkeypatch, calls):
    """Hand the recorded searches to a run on the CPU.  Its own search on
    the same points must give the recorded distances to fp32 rounding of
    ||x||^2 - 2<x, y> + ||y||^2 and the same neighbour sets, or sets that
    part at a tie (the float64 distances of the points in one set and not
    the other within that rounding).  Returns the iterator, which counts
    the rows that part at a tie."""
    import slide_tpu_torch.nn.neighborhood as nb
    from slide_tpu_torch.ops.neighbors import knn_points

    class Replay:
        """The recorded calls, and the count of rows that part at a tie."""

        def __init__(self):
            self.calls, self.ties = iter(calls), 0

        def __iter__(self):
            return self

        def __next__(self):
            return next(self.calls)

    replay = Replay()

    def replaying(query, points, k):
        c_query, c_points, c_sqd, c_idx = next(replay)
        assert torch.equal(query, c_query) and torch.equal(points, c_points)
        scale = (query.square().sum(-1).amax() + points.square().sum(-1).amax()).item()
        tol = 1e-6 * scale
        sqd, idx = knn_points(query, points, k)
        own = torch.gather(((query[:, :, None].double() - points[:, None].double()) ** 2).sum(-1),
                           2, c_idx)
        assert float((own - c_sqd.double()).abs().max()) <= tol
        differ = (torch.sort(idx, -1)[0] != torch.sort(c_idx, -1)[0]).any(-1)
        for b, m in differ.nonzero().tolist():
            d64 = ((query[b, m].double() - points[b].double()) ** 2).sum(-1)
            sym = list(set(idx[b, m].tolist()) ^ set(c_idx[b, m].tolist()))
            assert float(d64[sym].max() - d64[sym].min()) <= tol
            replay.ties += 1
        return c_sqd, c_idx

    monkeypatch.setattr(nb, "knn_points", replaying)
    return replay


def _record_fps(monkeypatch):
    """Record the picks of the SA levels' FPS calls, on the host."""
    import slide_tpu_torch.nn.modules as modules
    picks, real = [], modules.furthest_point_sample

    def recording(xyz, k, *args, **kwargs):
        idx = real(xyz, k, *args, **kwargs)
        picks.append(idx.cpu())
        return idx

    monkeypatch.setattr(modules, "furthest_point_sample", recording)
    return picks


def _run_by_level(net, xm, label):
    """The net's output and each SA / FP level's and the head's, as float64
    on the host."""
    levels, handles = {}, []
    for name, mod in net.named_children():
        if name.startswith(("sa_", "fp_")) or name == "head_conv_out":
            def keep(m, args, out, name=name):
                levels[name] = (out[1] if isinstance(out, tuple) else out).cpu().double()
            handles.append(mod.register_forward_hook(keep))
    try:
        with torch.no_grad():
            out = net(xm, ts=None, label=label).cpu()
    finally:
        for h in handles:
            h.remove()
    return out, levels


def _float64_by_level(monkeypatch, net, xm, label, knn_calls, picks):
    """The CPU module run in float64 on the card's FPS picks and kNN searches,
    the squared distances as the card's fp32 gave them: what is left between
    it and a fp32 run is that run's rounding elsewhere."""
    import copy

    import slide_tpu_torch.nn.modules as modules
    import slide_tpu_torch.nn.neighborhood as nb
    knn, fps_picks = iter(knn_calls), iter(picks)

    def replaying(query, points, k):
        c_query, _, c_sqd, c_idx = next(knn)
        assert float((query - c_query.double()).abs().max()) <= 1e-4
        return c_sqd.double(), c_idx

    monkeypatch.setattr(nb, "knn_points", replaying)
    monkeypatch.setattr(modules, "furthest_point_sample", lambda xyz, k, *a, **kw: next(fps_picks))
    out = _run_by_level(copy.deepcopy(net).double(), xm.double(), label)
    assert next(knn, None) is None and next(fps_picks, None) is None
    return out


def _sap_net_and_cloud():
    """The shipped SAP net with the committed weights (eval mode, TF32 off)
    and an ellipsoid's surface and normals, mirrored: 2 x 2048 points."""
    from slide_tpu_torch.configs import upsampler_config
    from slide_tpu_torch.models import ConditionalPointNet2
    from slide_tpu_torch.pipeline import DEFAULT_CKPTS
    from slide_tpu_torch.sap import mirror_and_concat
    from slide_tpu_torch.weights import load_flax_params, load_inference_params
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    net = ConditionalPointNet2(upsampler_config()["pointnet_config"])
    load_flax_params(net, load_inference_params(str(DEFAULT_CKPTS["sap"]), -1))
    net.eval()
    gen = torch.Generator().manual_seed(0)
    axes = torch.tensor([0.45, 0.15, 0.3])
    p = torch.randn((2, 2048, 3), generator=gen)
    p = p / torch.linalg.vector_norm(p, dim=-1, keepdim=True) * axes
    nrm = p / axes ** 2
    nrm = nrm / torch.linalg.vector_norm(nrm, dim=-1, keepdim=True)
    xm = mirror_and_concat(torch.cat([p, nrm], dim=-1), axis=2, attach_label=True,
                           generator=gen)[0]
    return net, xm, torch.zeros(2, dtype=torch.int64)


@pytest.mark.cuda
def test_full_width_sap_net_card_matches_cpu(cuda, monkeypatch):
    # The KnnFP levels weight each neighbour by 1 / (d + 1e-8), and every
    # query coincides with one of its neighbours, whose squared distance is
    # fp32 rounding noise of the order of 1e-8: noise of 1e-8 there moves the
    # outputs (up to ~340) by 0.03.  So the card's distances and neighbour
    # sets, held to the CPU's first, are handed to the CPU run.  Both runs
    # are then read against the float64 forward on the same searches, level
    # by level, which shows how far each one's own fp32 rounding carries.
    net, xm, label = _sap_net_and_cloud()
    calls = _record_knn(monkeypatch)
    picks = _record_fps(monkeypatch)
    before = _build.launch_counts["fps"]
    got, got_levels = _run_by_level(net.to(cuda), xm.to(cuda), label.to(cuda))
    assert _build.launch_counts["fps"] == before + 4       # the four SA levels on K3
    card_calls, card_picks = list(calls), list(picks)
    with torch.no_grad():
        own = net.cpu()(xm, ts=None, label=label)
    replay = _replay_knn(monkeypatch, card_calls)
    want, want_levels = _run_by_level(net, xm, label)
    assert next(replay, None) is None and len(card_calls) == 8 and len(card_picks) == 4
    assert got.shape == (2, 4096, 30)
    err = float((got - want).abs().max())
    print(f"sap net card vs cpu: {err} of max {float(want.abs().max())} with the card's "
          f"kNN replayed, {float((got - own).abs().max())} without; neighbour sets that "
          f"part at a tie: {replay.ties}")
    out64, levels64 = _float64_by_level(monkeypatch, net, xm, label, card_calls, card_picks)
    print(f"against float64 on the card's searches: card {float((got - out64).abs().max())}, "
          f"cpu {float((want - out64).abs().max())}")
    for name, ref in levels64.items():
        print(f"  {name}: max {float(ref.abs().max())}, card "
              f"{float((got_levels[name] - ref).abs().max())}, cpu "
              f"{float((want_levels[name] - ref).abs().max())}")
    assert err <= SAP_NET_CARD_ATOL * max(1.0, float(want.abs().max()))


@pytest.mark.cuda
def test_sap_level0_rounding_by_operation(cuda):
    # The full-width SAP net's first SA level, operation by operation: each
    # is run alone in fp32, on the card and on the CPU, on the input the
    # float64 run handed it (cast to fp32), and held to the float64 run's
    # output of that operation, within LEVEL0_TOL of the output's size.
    # Each GroupNorm also with its statistics summed three ways: over the
    # strided (rows, channels) axes in fp32, over each group laid out
    # contiguously in fp32, and so in float64 (the port's form): (mean's
    # error of max |mean|, var's largest error relative to its group's var,
    # the output's error of max |output|).  The CPU's strided fp32 sums over
    # a group's 32768 elements (measured: var 5.8e-5 off, the output 1.4e-5)
    # are coarser than the card's (3.1e-7, 2.4e-7); the products round alike
    # on both.
    import copy

    from slide_tpu_torch.nn.layers import GroupNorm
    net, xm, label = _sap_net_and_cloud()
    net64 = copy.deepcopy(net).double()
    seen, handles = {}, []
    for name, mod in net64.sa_modules_0.named_modules():
        if name and not list(mod.children()) or name in ("mlp", "attention"):
            def keep(m, args, kwargs, out, name=name):
                seen[name] = (args, kwargs, out.detach())
            handles.append(mod.register_forward_hook(keep, with_kwargs=True))
    with torch.no_grad():
        net64(xm.double(), ts=None, label=label)
    for h in handles:
        h.remove()
    level = net.sa_modules_0
    rows = {}
    def cast(a, dev):
        if not torch.is_tensor(a):
            return a
        return a.detach().to(dev, torch.float32 if a.is_floating_point() else a.dtype)

    for name, (args, kwargs, want) in seen.items():
        mod = level.get_submodule(name)
        got = {}
        for dev in ("cpu", cuda):
            with torch.no_grad():
                out = mod.to(dev)(*[cast(a, dev) for a in args],
                                  **{k: cast(v, dev) for k, v in kwargs.items()})
            got[str(dev)] = out.double().cpu()
            mod.cpu()
        size = float(want.abs().max())
        rows[name] = {k: float((v - want).abs().max()) / size for k, v in got.items()}
        if isinstance(mod, GroupNorm):
            x = args[0]
            xg = x.reshape(x.shape[0], -1, mod.num_groups, x.shape[-1] // mod.num_groups)
            m64 = xg.mean(dim=(1, 3), keepdim=True)
            q64 = (xg * xg).mean(dim=(1, 3), keepdim=True)
            v64 = q64 - m64 * m64
            rows[name]["mean2_over_var"] = float((q64 / v64).max())
            forms = {
                "strided": lambda t: t.mean(dim=(1, 3), keepdim=True),
                "contiguous": lambda t: t.transpose(1, 2).reshape(t.shape[0], t.shape[2], -1)
                .mean(dim=-1)[:, None, :, None],
                "contiguous_float64": lambda t: t.transpose(1, 2).reshape(
                    t.shape[0], t.shape[2], -1).mean(dim=-1, dtype=torch.float64)[:, None, :, None]}
            w64 = mod.weight.double().reshape(xg.shape[2:])
            b64 = mod.bias.double().reshape(xg.shape[2:])
            y64 = (xg - m64) * torch.rsqrt(v64 + mod.eps) * w64 + b64
            for dev in ("cpu", cuda):
                x32 = xg.float().to(dev)
                w, b = w64.float().to(dev), b64.float().to(dev)
                for form, red in forms.items():
                    m, q = red(x32).float(), red(x32 * x32).float()
                    var = torch.maximum(q - m * m, m.new_zeros(()))
                    y = ((x32 - m) * (torch.rsqrt(var + mod.eps) * w) + b).double().cpu()
                    m, var = m.double().cpu(), var.double().cpu()
                    rows[name][f"{dev}_{form}"] = (
                        float((m - m64).abs().max() / m64.abs().max()),
                        float(((var - v64) / v64).abs().max()),
                        float((y - y64).abs().max() / y64.abs().max()))
    for name, row in rows.items():
        print(f"  {name}: {row}")
    assert all(rows[name][k] <= LEVEL0_TOL for name in rows for k in ("cpu", str(cuda)))


@pytest.mark.cuda
def test_dpsr_backward_card_matches_cpu(cuda):
    # the gradient of sum(tanh(phi) * g) with respect to the points and the
    # normals at 128^3: the card's raster and grid_interp's backward
    # (scatter-adds) sum in no fixed order; both fp32 sides are held to the
    # float64 run
    from slide_tpu_torch.sap import DPSR
    v, n = _sphere_points(2, 20480, 1)
    g = torch.randn((2, 128, 128, 128), generator=torch.Generator().manual_seed(2))
    grads = {}
    for key, dev, dtype in (("cpu", "cpu", torch.float32), ("card", cuda, torch.float32),
                            ("float64", "cpu", torch.float64)):
        solver = DPSR((128,) * 3, sig=2).to(dev, dtype)
        vv = v.to(dev, dtype).clone().requires_grad_(True)
        nn_ = n.to(dev, dtype).clone().requires_grad_(True)
        (torch.tanh(solver(vv, nn_)) * g.to(dev, dtype)).sum().backward()
        grads[key] = (vv.grad.double().cpu(), nn_.grad.double().cpu())
    for i, what in enumerate(("points", "normals")):
        ref = grads["float64"][i]
        size = float(ref.abs().max())
        errs = {k: float((grads[k][i] - ref).abs().max()) for k in ("cpu", "card")}
        card_cpu = float((grads["card"][i] - grads["cpu"][i]).abs().max())
        print(f"dpsr d{what}: max {size}, card vs float64 {errs['card']}, cpu vs float64 "
              f"{errs['cpu']}, card vs cpu {card_cpu}")
        assert torch.isfinite(grads["card"][i]).all()
        assert card_cpu <= DPSR_GRAD_TOL * size


def _psr_tree(tmp_path, dev):
    from slide_tpu_torch.data import write_synthetic_shapenet_psr
    return write_synthetic_shapenet_psr(str(tmp_path / "data"), models_per_split=2,
                                        num_points=3000, psr_res=128, psr_from_points=True,
                                        shape_variety=True, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("round_trip", [False, True])
def test_upsampler_training_step_launches(cuda, tmp_path, round_trip):
    # the shipped SAP preset at batch 2 on 128^3 grids written on the card:
    # each step runs K3 in the SAP net's four SA levels; with the committed
    # AE's round trip also the keypoints (1), the encoder's levels (4) and
    # the decode's nine calls: 18; never K1 or K2
    from slide_tpu_torch.configs import autoencoder_config, upsampler_config
    from slide_tpu_torch.pipeline import DEFAULT_CKPTS
    from slide_tpu_torch.train.driver import train_upsampler
    from slide_tpu_torch.weights import load_inference_params
    cfg = upsampler_config(batch_size=2)
    cfg["shapenet_psr_dataset_config"].update(categories=["02691156"], repeat_dataset=1)
    cfg["train_config"].update(root_directory=str(tmp_path / "exp"), iters_per_logging=1)
    ae_params = None
    if round_trip:
        cfg["autoencoder_config"] = autoencoder_config("airplane")
        cfg["autoencoder_config"]["noise_magnitude"] = 0.02
        ae_params = load_inference_params(str(DEFAULT_CKPTS["ae"]), -1)
    root = _psr_tree(tmp_path, cuda)
    _build.launch_counts.clear()
    state, losses = train_upsampler(cfg, ae_params=ae_params, data_dir=root, max_iters=2,
                                    verbose=False)
    assert state.step == 2 and all(torch.isfinite(torch.tensor([l for _, l in losses])))
    assert dict(_build.launch_counts) == {"fps": 2 * (18 if round_trip else 4)}


# ---------------------------------------------------------------------------
# Autoencoder and feature-DDPM training on the card: the chamfer losses and
# `encode` against the CPU, one step of each task with its exact launches.

# encode of the committed AE at full width, card against CPU with the card's
# kNN picks replayed: measured 5.2e-6 of 3.24 here (H100 80GB HBM3) once
# GroupNorm sums its statistics in float64 (1.59e-3 before, the CPU's fp32
# sums over groups of one channel); the bound is chip_smoke.py's ENCODE_TOL
ENCODE_CARD_TOL = 5e-5      # of max(1, max |output|)


def _ae_cloud(b, n, seed):
    gen = torch.Generator().manual_seed(seed)
    d = torch.randn((b, n, 3), generator=gen)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    axes = torch.tensor([0.45, 0.15, 0.3])
    nrm = d / axes
    return torch.cat([d * axes, nrm / torch.linalg.vector_norm(nrm, dim=-1, keepdim=True)], -1)


@pytest.mark.cuda
def test_chamfer_card_matches_cpu(cuda):
    # the same nearest-neighbour picks (fp32, TF32 off, ties to the lowest
    # index), then the same losses and gradients to fp32 rounding
    from slide_tpu_torch.ops import calc_cd, chamfer_parts
    torch.backends.cuda.matmul.allow_tf32 = False
    out, gt = _ae_cloud(4, 512, 0), _ae_cloud(4, 512, 1)
    out[:, :, :3] += 0.01 * torch.randn(out[:, :, :3].shape,
                                        generator=torch.Generator().manual_seed(2))
    res = {}
    for dev in ("cpu", cuda):
        parts = chamfer_parts(gt[..., :3].to(dev), out[..., :3].to(dev))
        o = out.to(dev).clone().requires_grad_(True)
        r = calc_cd(o, gt.to(dev), calc_f1=True, f1_threshold=1e-4, normal_loss_type="mse")
        (r["cd_p"] + 0.1 * r["cd_feature_p"]).sum().backward()
        res[str(dev)] = ({k: v.detach().cpu() for k, v in r.items()}, o.grad.cpu(),
                         [parts[k].cpu() for k in ("idx_x", "idx_y")])
    (want, gwant, iwant), (got, ggot, igot) = res["cpu"], res[str(cuda)]
    assert all(torch.equal(a, b) for a, b in zip(igot, iwant))
    for key in want:
        assert float((got[key] - want[key]).abs().max()) <= 1e-6, key
    assert float((ggot - gwant).abs().max()) <= 1e-6 * max(1.0, float(gwant.abs().max()))


@pytest.mark.cuda
def test_full_width_encode_card_matches_cpu(cuda, monkeypatch):
    from slide_tpu_torch.configs import autoencoder_config
    from slide_tpu_torch.models import build_autoencoder
    from slide_tpu_torch.pipeline import DEFAULT_CKPTS
    from slide_tpu_torch.train.driver import sample_train_keypoints
    from slide_tpu_torch.weights import load_flax_params, load_inference_params
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = autoencoder_config()
    ae = build_autoencoder(cfg["pointnet_config"])
    load_flax_params(ae, load_inference_params(str(DEFAULT_CKPTS["ae"]), -1))
    ae.eval()
    x = _ae_cloud(2, 2048, 3)
    kp = sample_train_keypoints(x[..., :3], cfg["shapenet_psr_dataset_config"],
                                torch.Generator().manual_seed(4))
    label = torch.zeros(2, dtype=torch.int64)
    gen = torch.Generator().manual_seed(5)
    noises = [torch.randn((2, 16, 16), generator=gen), torch.randn((2, 16, 32), generator=gen)]
    calls = _record_knn(monkeypatch)
    before = _build.launch_counts["fps"]
    it = iter(noises)
    with torch.no_grad():
        got = ae.to(cuda).encode(x.to(cuda), kp.to(cuda), label=label.to(cuda),
                                 noise_fn=lambda s: next(it).to(cuda)).cpu()
    assert _build.launch_counts["fps"] == before + 4      # the encoder's SA levels on K3
    card_calls = list(calls)
    replay = _replay_knn(monkeypatch, card_calls)
    it = iter(noises)
    with torch.no_grad():
        want = ae.cpu().encode(x, kp, label=label, noise_fn=lambda s: next(it))
    assert next(replay, None) is None and got.shape == (2, 16, 48)
    err = float((got - want).abs().max())
    print(f"encode card vs cpu: {err} of max {float(want.abs().max())}; kNN sets that part "
          f"at a tie: {replay.ties}")
    assert err <= ENCODE_CARD_TOL * max(1.0, float(want.abs().max()))


def _small_tree(tmp_path):
    from slide_tpu_torch.data import write_synthetic_shapenet_psr
    return write_synthetic_shapenet_psr(str(tmp_path / "data"), models_per_split=4,
                                        num_points=3000, with_psr=False)


@pytest.mark.cuda
def test_ae_training_step_launches(cuda, tmp_path):
    # the shipped AE at batch 2: each step runs K3 15 times (keypoints, the
    # encoder's four SA levels, the decode's nine calls, the targets), no K1
    from slide_tpu_torch.configs import autoencoder_config
    from slide_tpu_torch.train.driver import train_autoencoder
    cfg = autoencoder_config("airplane", batch_size=2)
    cfg["shapenet_psr_dataset_config"]["repeat_dataset"] = 1
    cfg["train_config"].update(root_directory=str(tmp_path / "exp"), iters_per_logging=1)
    root = _small_tree(tmp_path)
    _build.launch_counts.clear()
    state, losses = train_autoencoder(cfg, data_dir=root, max_iters=2, verbose=False)
    assert state.step == 2 and all(torch.isfinite(torch.tensor([l for _, l in losses])))
    assert dict(_build.launch_counts) == {"fps": 30}


@pytest.mark.cuda
def test_latent_training_step_launches(cuda, tmp_path):
    # the shipped latent DDPM at batch 2 over the committed AE: each step one
    # K1, one K2 and five K3 (the keypoints, the frozen encoder's SA levels)
    from slide_tpu_torch.configs import latent_ddpm_config
    from slide_tpu_torch.pipeline import DEFAULT_CKPTS
    from slide_tpu_torch.train.driver import train_latent_ddpm
    from slide_tpu_torch.weights import load_inference_params
    cfg = latent_ddpm_config("airplane", batch_size=2)
    cfg["shapenet_psr_dataset_config"]["repeat_dataset"] = 1
    cfg["train_config"].update(root_directory=str(tmp_path / "exp"), iters_per_logging=1)
    root = _small_tree(tmp_path)
    _build.launch_counts.clear()
    state, losses = train_latent_ddpm(cfg, load_inference_params(str(DEFAULT_CKPTS["ae"]), -1),
                                      data_dir=root, max_iters=2, verbose=False)
    assert state.step == 2 and all(torch.isfinite(torch.tensor([l for _, l in losses])))
    assert dict(_build.launch_counts) == {"fps": 10, "fused_denoiser": 2,
                                          "fused_denoiser_bwd": 2}


# ---------------------------------------------------------------------------
# Evaluation on the card: the EMD (plain PyTorch) against the CPU's, and the
# position DDPM's checkpoint-time evaluation through K1.

# card vs CPU at 2048 points, of the largest value: the distance within
# chip_smoke.py's EMD_CARD_RTOL (measured 1.3e-6 on an H100), its gradient
# within EMD_GRAD_CARD_RTOL (measured 1.76e-4 in two runs): each gradient
# element sums the match's row, and the match's weights exp(-16384 d) carry
# a rounding gap of d into them 16384-fold, so the gradient's small elements
# differ more.  A faulty run lies far beyond it: the same card run with TF32
# products in the distances must differ from the CPU by more than
# EMD_TF32_FLOOR (on the CPU, TF32-rounded inputs of the inner products put
# the gradient 1.5 of its size away; the match kept in the backward, 5e7)
EMD_CARD_RTOL = 1e-4
EMD_GRAD_CARD_RTOL = 5e-4
EMD_TF32_FLOOR = 10 * EMD_GRAD_CARD_RTOL


@pytest.mark.cuda
def test_emd_card_matches_cpu(cuda):
    # 2048-point clouds (the evaluation's size): the distance and its
    # gradient, card against CPU; fp32 sums in other orders, through weights
    # exp(-16384 d) that multiply a rounding gap of d by 16384
    from slide_tpu_torch.ops.emd import earth_mover_distance
    gen = torch.Generator().manual_seed(0)
    a = torch.randn((4, 2048, 3), generator=gen) * torch.tensor([0.3, 0.2, 0.1])
    b = torch.randn((4, 2048, 3), generator=gen) * torch.tensor([0.25, 0.2, 0.15])

    def run(dev):
        x = a.detach().to(dev).requires_grad_(True)
        y = b.detach().to(dev).requires_grad_(True)
        d = earth_mover_distance(x, y)
        d.sum().backward()
        return [t.detach().cpu() for t in (d, x.grad, y.grad)]

    def gaps(got, want):
        d_err = float(((got[0] - want[0]).abs() / want[0].abs()).max())
        g_err = max(float((g - w).abs().max() / w.abs().max())
                    for g, w in zip(got[1:], want[1:]))
        return d_err, g_err

    tf32 = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        want, got = run("cpu"), run("cuda")
        torch.backends.cuda.matmul.allow_tf32 = True
        faulty = run("cuda")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    d_err, g_err = gaps(got, want)
    tf32_err = gaps(faulty, want)[1]
    print(f"emd card vs cpu: distance {d_err:.3e}, gradient {g_err:.3e} (relative); "
          f"with TF32 products, gradient {tf32_err:.3e}")
    assert d_err <= EMD_CARD_RTOL and g_err <= EMD_GRAD_CARD_RTOL
    assert tf32_err > EMD_TF32_FLOOR


@pytest.mark.cuda
def test_generation_eval_launches(cuda, tmp_path):
    # train_position_ddpm with its eval hook at batch 2, T=20: two steps (one
    # K1, one K2, one K3 each), a checkpoint, then 6 shapes sampled in
    # batches of 4 by the raw weights and both EMA shadows, fused: exactly
    # T x 2 batches x 3 weight sets K1 launches more
    import os
    import numpy as np
    from slide_tpu_torch.configs import keypoint_ddpm_config
    from slide_tpu_torch.train.driver import experiment_dirs, train_position_ddpm
    cfg = keypoint_ddpm_config("airplane", batch_size=2)
    cfg["diffusion_config"]["T"] = 20
    cfg["shapenet_psr_dataset_config"].update(repeat_dataset=1, eval_batch_size=4,
                                              num_samples_tested=6)
    cfg["train_config"].update(root_directory=str(tmp_path / "exp"), iters_per_logging=1,
                               epochs_per_ckpt=1)
    root = _small_tree(tmp_path)
    _build.launch_counts.clear()
    state, _ = train_position_ddpm(cfg, data_dir=root, max_iters=2, eval_hook="auto",
                                   verbose=False)
    assert state.step == 2
    assert dict(_build.launch_counts) == {"fps": 2, "fused_denoiser": 2 + 20 * 2 * 3,
                                          "fused_denoiser_bwd": 2}
    out = os.path.join(experiment_dirs(cfg)[0], "eval_result")
    for sub in ("", "model_ema_0.99900", "model_ema_0.99990"):
        with np.load(os.path.join(out, sub, "shapenet_psr_generated_data_16_pts_iter_1.npz")) as d:
            assert d["points"].shape == (6, 16, 3) and np.isfinite(d["points"]).all()


# ---------------------------------------------------------------------------
# The x0 engine's position step and the dual-tower conditional net on the
# card.

X0_MIXED = {"beta_schedule": "linear", "beta_start": 1e-4, "beta_end": 0.02,
            "num_diffusion_timesteps": 1000, "data_clamp_range": 1.0,
            "model_output_scale_factor": 1.0, "loss_type": "mixed_cd_t_epsilon_mse",
            "t_trunction": 500, "normal_loss_type": "mse"}
# the x0 loss's cotangent at the denoiser's output, card against float64
# (the card's chamfer picks replayed), of its largest element
X0_COTANGENT_RTOL = 1e-4


@pytest.mark.cuda
def test_x0_step_gradient_card_matches_float64(cuda, monkeypatch):
    # The kp preset's denoiser (weights from init_params) fused on the card
    # (K1 forward, K2 backward) under the x0 loss at batch 8, half the clouds
    # below the truncation (the chamfer term), against the module run in
    # float64 on the CPU on the card's chamfer picks (a float64 pick may part
    # from the card's only at a tie, 1e-6 of the clouds' squared scale): the
    # loss, and the loss's cotangent at the denoiser's output; then K2 on the
    # step's own core inputs and cotangent against its float64 reference, the
    # relu ties resolved as K2 resolved them (K2_TOL).
    import copy
    from slide_tpu_torch.configs import keypoint_ddpm_config
    from slide_tpu_torch.diffusion import X0Schedule, x0_training_loss
    from slide_tpu_torch.models import ConditionalPointNet2
    from slide_tpu_torch.models import fused_denoiser as fd
    from slide_tpu_torch.ops import chamfer
    from slide_tpu_torch.train.driver import init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    pc = keypoint_ddpm_config()["pointnet_config"]
    net = init_params(ConditionalPointNet2(pc), torch.Generator().manual_seed(0))
    net64 = copy.deepcopy(net).double()
    gen = torch.Generator().manual_seed(1)
    x = 0.4 * torch.randn((8, 16, 3), generator=gen)
    z = torch.randn((8, 16, 3), generator=gen)
    ts = torch.tensor([3, 60, 200, 450, 510, 700, 880, 999])
    label = torch.tensor([0, 1, 2, 3, 4, 5, 6, 0])
    real, recorded, ties = chamfer.pairwise_sqdist, {}, [0]

    def recording(a, b):
        d = real(a, b)
        recorded.update(a=a.detach().cpu(), b=b.detach().cpu(), d=d.cpu())
        return d

    def replaying(a, b):
        own, d = real(a, b), recorded["d"]
        tol = 1e-6 * float(recorded["a"].square().sum(-1).max()
                           + recorded["b"].square().sum(-1).max())
        d64 = ((recorded["a"].double()[:, :, None] - recorded["b"].double()[:, None]) ** 2).sum(-1)
        for dim in (2, 1):
            mine, card = own.argmin(dim), d.argmin(dim)
            for row in (mine != card).nonzero().tolist():
                gap = d64.select(dim, int(mine[tuple(row)]))[tuple(row)] - \
                    d64.select(dim, int(card[tuple(row)]))[tuple(row)]
                assert abs(float(gap)) <= tol
                ties[0] += 1
        return d

    outs = {}

    def run(key, net_fn, dev, dtype):
        sched = X0Schedule.from_config(X0_MIXED, dev)

        def keep(xt, t):
            out = net_fn(xt, t)
            out.retain_grad()
            outs[key] = (xt.detach(), out)
            return out
        loss = x0_training_loss(keep, x.to(dev, dtype), sched, loss_type=X0_MIXED["loss_type"],
                                normal_loss_type="mse", ts=ts.to(dev), z=z.to(dev, dtype))
        loss["training_loss"].backward()
        return float(loss["training_loss"])

    card = net.to(cuda)
    apply = fd.make_fused_train_fn(pc, card, 16)
    monkeypatch.setattr(chamfer, "pairwise_sqdist", recording)
    before = dict(_build.launch_counts)
    loss = run("card", lambda xt, t: apply(xt, t, label.to(cuda)), cuda, torch.float32)
    torch.cuda.synchronize()
    assert _build.launch_counts["fused_denoiser"] == before.get("fused_denoiser", 0) + 1
    assert _build.launch_counts["fused_denoiser_bwd"] == before.get("fused_denoiser_bwd", 0) + 1
    monkeypatch.setattr(chamfer, "pairwise_sqdist", replaying)
    loss64 = run("float64", lambda xt, t: net64(xt, ts=t, label=label), "cpu", torch.float64)
    g, g64 = outs["card"][1].grad.cpu().double(), outs["float64"][1].grad
    err = float((g - g64).abs().max())
    print(f"x0 step: loss {loss} (float64 {loss64}), cotangent card vs float64 {err} of "
          f"{float(g64.abs().max())}, chamfer ties {ties[0]}")
    assert abs(loss - loss64) <= 1e-5 * abs(loss64)
    assert err <= X0_COTANGENT_RTOL * float(g64.abs().max())
    # K2 on the step's core: the input it saw and the cotangent it was given
    pc_in = outs["card"][0].contiguous()
    with torch.no_grad():
        t4 = card.t_embedder(ts.to(cuda)).contiguous()
        cls = card.class_emb(label.to(cuda)).contiguous()
    cot = outs["card"][1].grad.contiguous()
    got = fd.fused_backward_cuda(apply.packed, pc_in, t4, cls, cot)
    _k2_close(apply, pc_in, t4, cls, cot, got, "x0 step")


# the dual-tower net's forward on 2048-point clouds with normals, card and
# CPU each against float64 on the card's kNN searches and FPS picks, of
# max(1, max |float64|) (chip_smoke.py's COND_NET_TOL)
COND_NET_TOL = 1e-4


@pytest.mark.cuda
def test_conditional_net_card_matches_cpu(cuda, monkeypatch):
    # keypoint_conditional_generation's net at the keypoint preset's widths
    # (tests/conditional_layout.py), weights from init_params, conditioned
    # on 16 keypoints: the main tower's and the condition tower's SA levels
    # run K3 (four launches); the card's searches and picks go to the CPU run
    # (held to the CPU's own first, ties counted) and to a float64 run
    import copy
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from conditional_layout import conditional_task_config
    from slide_tpu_torch.models import ConditionalPointNet2
    from slide_tpu_torch.ops import sample_keypoints
    from slide_tpu_torch.train.driver import init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = conditional_task_config("keypoint_conditional_generation")
    net = init_params(ConditionalPointNet2(cfg["pointnet_config"]),
                      torch.Generator().manual_seed(0)).eval()
    gen = torch.Generator().manual_seed(2)
    pts = torch.randn((2, 2048, 3), generator=gen) * torch.tensor([0.4, 0.15, 0.3])
    nrm = torch.nn.functional.normalize(torch.randn((2, 2048, 3), generator=gen), dim=-1)
    x = torch.cat([pts, nrm], dim=-1)
    cond, _ = sample_keypoints(pts, 16)
    ts, label = torch.tensor([3, 700]), torch.tensor([0, 5])
    calls = _record_knn(monkeypatch)
    picks = _record_fps(monkeypatch)
    before = _build.launch_counts["fps"]
    with torch.no_grad():
        card = net.to(cuda)(x.to(cuda), ts=ts.to(cuda), label=label.to(cuda),
                            condition=cond.to(cuda)).cpu().double()
    assert _build.launch_counts["fps"] == before + 4
    card_calls, card_picks = list(calls), list(picks)
    replay = _replay_knn(monkeypatch, card_calls)
    fps_it = iter(card_picks)

    def cpu_fps(xyz, k, *args, **kwargs):
        want = next(fps_it)
        assert torch.equal(fps.furthest_point_sample(xyz, k, *args, **kwargs), want)
        return want

    monkeypatch.setattr("slide_tpu_torch.nn.modules.furthest_point_sample", cpu_fps)
    net = net.cpu()
    with torch.no_grad():
        cpu = net(x, ts=ts, label=label, condition=cond).double()
    assert next(replay, None) is None and next(fps_it, None) is None
    knn = iter(card_calls)

    def float64_knn(query, points, k):
        c_query, _, c_sqd, c_idx = next(knn)
        assert float((query - c_query.double()).abs().max()) <= 1e-4
        return c_sqd.double(), c_idx

    monkeypatch.setattr("slide_tpu_torch.nn.neighborhood.knn_points", float64_knn)
    fps_it = iter(card_picks)
    monkeypatch.setattr("slide_tpu_torch.nn.modules.furthest_point_sample",
                        lambda xyz, k, *a, **kw: next(fps_it))
    with torch.no_grad():
        ref = copy.deepcopy(net).double()(x.double(), ts=ts, label=label,
                                          condition=cond.double())
    scale = max(1.0, float(ref.abs().max()))
    errs = {"card": float((card - ref).abs().max()), "cpu": float((cpu - ref).abs().max()),
            "card_vs_cpu": float((card - cpu).abs().max())}
    print(f"conditional net: {errs} of {scale}; kNN ties {replay.ties}")
    assert card.shape == (2, 2048, 6)
    assert max(errs.values()) <= COND_NET_TOL * scale


# ---------------------------------------------------------------------------
# The corpus on the card, PVCNN2 at full width, the host's native marching


@pytest.mark.cuda
def test_assemble_card_matches_cpu(cuda, tmp_path):
    # every augmentation on, the same handed-in draws: gathers equal, the
    # arithmetic within 1e-6 of the cloud's size (a mean, a few products)
    from slide_tpu_torch import data as tdata
    root = tdata.write_synthetic_shapenet_psr(str(tmp_path / "data"), models_per_split=8,
                                              num_points=600, psr_res=16)
    ds = tdata.ShapesPSRDataset(root, split="train", categories=["02691156"],
                                num_gt_points=256, load_psr=True, repeat_dataset=3)
    corpus = tdata.DeviceCorpus.from_dataset(ds)
    trainset = {"npoints": 256, "scale": 0.5, "centered_to_centroid": True,
                "augmentation": {"mirror_prob": 0.5, "noise_magnitude": 0.02,
                                 "translation_magnitude": 0.1, "augm_scale": 1.2}}
    assemble = tdata.make_assemble_fn(trainset)
    idx = torch.tensor([0, 23, 5, 5, 17, 9, 12, 2], dtype=torch.int32)
    draws = tdata.draw_assembly(trainset, 8, 600, torch.Generator().manual_seed(3))
    want = assemble(corpus, idx, draws=draws)
    got = assemble(corpus.to(cuda), idx.to(cuda), draws={k: v.to(cuda) for k, v in draws.items()})
    for k in ("label", "psr"):
        assert torch.equal(got[k].cpu(), want[k])
    for k in ("points", "normals"):
        err = float((got[k].cpu() - want[k]).abs().max())
        assert err <= 1e-6 * max(1.0, float(want[k].abs().max())), (k, err)
    own = assemble(corpus.to(cuda), idx.to(cuda), torch.Generator(device=cuda).manual_seed(0))
    assert own["points"].shape == (8, 256, 3) and own["points"].device.type == "cuda"


@pytest.mark.cuda
def test_full_width_pvcnn2_card_matches_float64(cuda):
    # PVD's widths (embed 64, SA centres 1024/256/64/16, voxels 32/16/8,
    # attention) at 2048 points with normals, two clouds: the card against
    # the float64 CPU module on the card's FPS, ball-query and 3-NN picks
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pick_replay import pvcnn2_picks_replayed
    from slide_tpu_torch.models import PVCNN2
    from slide_tpu_torch.train.driver import init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    net = init_params(PVCNN2(in_dim=6, out_dim=6), torch.Generator().manual_seed(0)).eval()
    gen = torch.Generator().manual_seed(4)
    pts = torch.randn((2, 2048, 3), generator=gen) * torch.tensor([0.4, 0.15, 0.3])
    nrm = torch.nn.functional.normalize(torch.randn((2, 2048, 3), generator=gen), dim=-1)
    x = torch.cat([pts, nrm], dim=-1)
    ts = torch.tensor([3, 700])
    before = _build.launch_counts["fps"]
    card, ref, picks = pvcnn2_picks_replayed(net.to(cuda), (x.to(cuda), None, ts.to(cuda)),
                                             (x.double(), None, ts), "cpu", torch.float64)
    assert _build.launch_counts["fps"] == before + 4
    assert picks == 4 + 4 + 4 and card.shape == (2, 2048, 6)
    scale = max(1.0, float(ref.abs().max()))
    err = float((card - ref).abs().max())
    print(f"PVCNN2 card vs float64: {err} of {scale}")
    assert err <= 1e-4 * scale


@pytest.mark.cuda
def test_native_and_device_marching_agree(cuda):
    # one 96^3 field: the card's extraction and the host's native pass give
    # the same mesh (the mesh gate: faces with their winding, vertices,
    # normals), each against the numpy oracle too
    import os
    import sys
    import numpy as np
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mesh_compare import assert_same_mesh
    from slide_tpu_torch.sap import marching, marching_gpu
    r = 96
    x = np.linspace(-1, 1, r)
    gx, gy, gz = np.meshgrid(x, x, x, indexing="ij")
    vol = (0.5 - np.sqrt(gx ** 2 + gy ** 2 + gz ** 2)
           + 0.2 * np.sin(4 * gx) * np.cos(3 * gy)).astype(np.float32)
    native = marching.marching_tetrahedra(vol)
    mesh = marching_gpu.marching_tetrahedra_device(torch.as_tensor(vol, device=cuda)[None], 0.0)
    device = marching_gpu.mesh_to_host(mesh, 0)
    oracle = marching.marching_tetrahedra_numpy(vol)
    # the device mesh of a bare grid is in grid units, as the host's
    assert_same_mesh(device, oracle)
    assert_same_mesh(native, oracle)
    assert_same_mesh(device, native)


# ---------------------------------------------------------------------------
# Data-parallel training on one card: two ranks as two processes over gloo
# (NCCL refuses two ranks on one device)


@pytest.mark.cuda
def test_two_rank_gloo_step_on_one_card_matches_one_process(cuda, tmp_path):
    # the keypoint DDPM's step at full width, 16 rows a rank, against one
    # process's step on the 32 rows with the same draws: every gradient
    # element within GRAD_RTOL / GRAD_ATOL, the ranks' parameters bit-equal
    from torch_parallel_cases import run_ranks
    ranks = run_ranks("card", str(tmp_path), device="cuda", timeout=600)
    ref = ranks[0]
    print(f"gradient gap {ref['gap']:.3e} of {ref['largest']:.3e}, {ref['beyond']} beyond")
    assert ref["beyond"] == 0
    assert abs(ref["loss"] - ref["ref_loss"]) <= 1e-5 * abs(ref["ref_loss"])
    assert ranks[1]["digest"] == ref["digest"]
