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


# ---------------------------------------------------------------------------
# The mesh stages on the card against the same code on the CPU: DPSR (its
# scatter adds in no fixed order there, cuFFT rounds otherwise), the
# extraction against the numpy oracle, the full-width SAP net (TF32 off).

DPSR_CARD_ATOL = 1e-5       # chip_smoke.py's DPSR_ATOL (measured 5.4e-7 here)
SAP_NET_CARD_ATOL = 1e-4    # of max(1, max |output|)


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


@pytest.mark.cuda
def test_full_width_sap_net_card_matches_cpu(cuda, monkeypatch):
    # The KnnFP levels weight each neighbour by 1 / (d + 1e-8), and every
    # query coincides with one of its neighbours, whose squared distance is
    # fp32 rounding noise of the order of 1e-8: noise of 1e-8 there moves the
    # outputs (up to ~340) by 0.03.  So the card's distances and neighbour
    # sets, held to the CPU's first, are handed to the CPU run.  Both runs
    # are then read against the float64 forward on the same searches, level
    # by level, which shows how far each one's own fp32 rounding carries.
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
    # an ellipsoid's surface and normals, mirrored: 2 x 2048 points
    gen = torch.Generator().manual_seed(0)
    axes = torch.tensor([0.45, 0.15, 0.3])
    p = torch.randn((2, 2048, 3), generator=gen)
    p = p / torch.linalg.vector_norm(p, dim=-1, keepdim=True) * axes
    nrm = p / axes ** 2
    nrm = nrm / torch.linalg.vector_norm(nrm, dim=-1, keepdim=True)
    xm = mirror_and_concat(torch.cat([p, nrm], dim=-1), axis=2, attach_label=True,
                           generator=gen)[0]
    label = torch.zeros(2, dtype=torch.int64)
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


# ---------------------------------------------------------------------------
# Autoencoder and feature-DDPM training on the card: the chamfer losses and
# `encode` against the CPU, one step of each task with its exact launches.

# encode of the committed AE at full width, card against CPU with the card's
# kNN picks replayed: the encoder's first layers normalise groups of one
# channel, so fp32 rounding alone carries features ~1e-3 from float64
# (tests/test_torch_ae.py); measured 1.59e-3 of 3.24 here (H100 80GB HBM3);
# the bound is chip_smoke.py's ENCODE_TOL
ENCODE_CARD_TOL = 2e-3      # of max(1, max |output|)


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
