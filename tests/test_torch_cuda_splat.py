"""splatfacto's ops and a generfacto step on the card against the CPU.

These tests need a CUDA device; without one every test skips with a
reason. The module imports no JAX, so it runs on a machine with a card
and no JAX installation:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_splat.py

- The tile rasterizer against the scan on the card (no tile overflows):
  rgb and accumulation within 3e-5, as the JAX package's test holds them.
- The scan compositor's two-pass backward (`composite_chunks`) against
  autograd of the plain scan on the card: relative L2 1e-4 per input.
- A splatfacto frame of a seeded pool on the card against the CPU: rgb
  within 1e-4.
- One generfacto step (a narrow configuration, the normals and shading
  on, the draws given, the CPU's samples replayed on the card) on the
  card against the CPU: losses within 4e-4
  relative, every group's gradient within 1e-3 relative L2 (the f32 step
  limits of chip_smoke.py's phase 9); the step launches the hash forward,
  table gradient, position gradient and its VJP.
"""

import numpy as np
import pytest
import torch

from nerfstudio_thermal_torch.configs.method_configs import get_method_config, setup_trainer
from nerfstudio_thermal_torch.models import splatfacto as sf
from nerfstudio_thermal_torch.ops import splat_compose, splat_tiles
from nerfstudio_thermal_torch.ops.cuda import hash_encoding as th
from nerfstudio_thermal_torch.utils.precision import pin_precision

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)

H, W = 40, 56


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    pin_precision()
    return torch.device("cuda")


def raster_scene(device, n=160, seed=3):
    r = np.random.default_rng(seed)
    xys = r.uniform([-4, -4], [W + 4, H + 4], (n, 2))
    sig = r.uniform(0.8, 5.0 / 3.0, n)
    conic = np.stack([1 / sig**2, r.uniform(-0.2, 0.2, n) / sig**2, 1 / sig**2], -1)
    arrays = (xys, r.uniform(0.5, 5.0, n), conic, np.ceil(3.0 * sig), r.uniform(0.05, 1.0, n),
              r.uniform(0, 1, (n, 3)))
    out = [torch.tensor(a, dtype=torch.float32, device=device) for a in arrays]
    alive = torch.tensor(r.uniform(0, 1, n) > 0.1, device=device)
    bg = torch.tensor([0.2, 0.4, 0.6], device=device)
    return (*out, alive, bg)


def test_tiles_match_scan_on_the_card(cuda):
    xys, depths, conics, radii, opac, colors, alive, bg = raster_scene(cuda)
    with torch.no_grad():
        scan = sf.rasterize(xys, depths, conics, radii, opac, colors, alive, H, W, bg, chunk=64)
        tiles = splat_tiles.rasterize_tiles(xys, depths, conics, radii, opac, colors, alive, H, W, bg, capacity=192)
    for a, b in zip(tiles[:2], scan[:2]):
        torch.testing.assert_close(a, b, atol=3e-5, rtol=0)


def test_composite_backward_matches_plain_scan_on_the_card(cuda):
    xys, depths, conics, radii, opac, colors, alive, _ = raster_scene(cuda, n=128, seed=5)
    depths, order = torch.sort(depths)
    ys, xs = torch.meshgrid(torch.arange(H, device=cuda) + 0.5, torch.arange(W, device=cuda) + 0.5, indexing="ij")
    pix = torch.stack([xs.reshape(-1), ys.reshape(-1)], -1).float()
    chunks = [t[order].reshape(4, 32, *t.shape[1:]) for t in (xys, conics, radii, opac * alive, colors, depths)]
    leaves = [c.clone().requires_grad_(i not in (2,)) for i, c in enumerate(chunks)]
    r = np.random.default_rng(1)
    cot = [torch.tensor(r.normal(size=s), dtype=torch.float32, device=cuda) for s in ((H * W, 3), (H * W, 1), (H * W,))]
    diff = [leaves[i] for i in (0, 1, 3, 4, 5)]
    got = torch.autograd.grad(splat_compose.composite_chunks(pix, *leaves), diff, cot)
    want = torch.autograd.grad(splat_compose.composite_chunks_plain(pix, *leaves), diff, cot)
    for g, w in zip(got, want):
        assert float(torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w)) <= 1e-4


def test_splatfacto_frame_matches_the_cpu(cuda):
    method = get_method_config("splatfacto")
    m = method.model
    m.num_random, m.max_num_gaussians, m.random_scale = 2000, 3000, 2.0
    aabb = np.array([[-1, -1, -1], [1, 1, 1]], np.float32)
    from nerfstudio_thermal_torch.cameras.cameras import Cameras

    c2w = torch.eye(4)[:3][None].clone()
    c2w[0, 2, 3] = 3.0
    cams = Cameras(camera_to_worlds=c2w, fx=torch.tensor([60.0]), fy=torch.tensor([60.0]), cx=torch.tensor([40.0]),
                   cy=torch.tensor([32.0]), width=torch.tensor([80]), height=torch.tensor([64]))
    frames = {}
    for device in ("cpu", cuda):
        model = sf.SplatfactoModel(m, aabb, 1, device=device, seed=0)
        model.init_extra_state()
        frames[str(device)] = model.render_camera_device(cams, 0)["rgb"].cpu()
    torch.testing.assert_close(frames["cuda"], frames["cpu"], atol=1e-4, rtol=0)


def tiny_generfacto():
    method = get_method_config("generfacto")
    m = method.model
    m.render_resolution = 32
    m.num_levels, m.log2_hashmap_size, m.max_res, m.hidden_dim = 8, 14, 128, 32
    m.proposal_net_args_list = [
        {"hidden_dim": 16, "log2_hashmap_size": 12, "num_levels": 5, "max_res": 64},
        {"hidden_dim": 16, "log2_hashmap_size": 12, "num_levels": 5, "max_res": 128},
    ]
    m.num_proposal_samples_per_ray, m.num_nerf_samples_per_ray = (32, 16), 16
    m.start_normals_training = m.start_lambertian_training = 0
    method.datamanager.resolution = 32
    return method


def generfacto_draws(num_rays: int, levels: int, device):
    r = np.random.default_rng(11)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    return {"light": t(r.normal(size=3)), "shade": t(0.9), "background": t(r.uniform(size=3)), "choice": t(0.7),
            "uniforms": [t(r.uniform(size=(num_rays, 1))) for _ in range(levels)]}


def test_generfacto_step_matches_the_cpu(cuda, tmp_path):
    """The card replays the CPU's samples (chip_smoke.replaying_samples):
    sampled on its own, a position ~1e-5 away may cross a hash-grid cell
    face, where the density's position gradient (the normals) jumps."""
    from chip_smoke import recording_samples, replaying_samples

    out, samples = {}, []
    for device in ("cpu", cuda):
        trainer = setup_trainer(tiny_generfacto(), base_dir=tmp_path / str(device), device=device)
        trainer.setup()
        batch = {k: torch.as_tensor(np.asarray(v), device=device) for k, v in trainer.datamanager.next_train(0).items()}
        before = {k: getattr(th, k).launches for k in ("hash_encode_fwd", "hash_encode_bwd_table",
                                                       "hash_encode_bwd_pos", "hash_encode_bwd_pos_vjp")}
        with recording_samples(samples) if device == "cpu" else replaying_samples(samples, device):
            scalars = trainer._train_step(trainer.state, batch, draws=generfacto_draws(32 * 32, 3, device))
        launched = {k: getattr(th, k).launches - v for k, v in before.items()}
        grads = {f"{g}/{i}": p.grad.detach().cpu() for g, ps in trainer.model.param_groups().items()
                 for i, p in enumerate(ps)}
        out[str(device)] = ({k: float(v) for k, v in scalars.items()}, grads, launched)
    (cpu_s, cpu_g, _), (card_s, card_g, launched) = out["cpu"], out["cuda"]
    assert launched == {"hash_encode_fwd": 3, "hash_encode_bwd_table": 3, "hash_encode_bwd_pos": 1,
                        "hash_encode_bwd_pos_vjp": 1}
    for k, v in cpu_s.items():
        assert abs(card_s[k] - v) <= 4e-4 * abs(v) + 1e-9, k
    for k, w in cpu_g.items():
        assert float(torch.linalg.vector_norm(card_g[k] - w) / torch.linalg.vector_norm(w).clamp(min=1e-30)) <= 1e-3, k
