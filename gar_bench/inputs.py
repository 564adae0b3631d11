"""Everything a run feeds to the program and to the reference, made from the
run's seed: the face model, the GAR's weights, each batch's draws and the
inversion's targets. Plain PyTorch; it imports nothing of the program.

Random streams: ``stream(seed, name, index)`` seeds a ``torch.Generator``
on the device from the run's seed (any whole number, also beyond 32 bits),
a stream name and an index, so every batch's draws depend only on its
index, and a traced run draws the same inputs as an untraced one.
"""

from __future__ import annotations

import hashlib
import math

import torch

from gar_bench.reference import gar


def stream(seed: int, name: str, index: int = 0, device="cuda") -> torch.Generator:
    h = hashlib.sha256(f"{int(seed)}/{name}/{int(index)}".encode()).digest()
    return torch.Generator(device=device).manual_seed(int.from_bytes(h[:8], "little") >> 1)


def sphere_face(nu: int, nv: int, radius: float):
    """The UV-sphere 'face' mesh: vertices ``[nu * nv, 3]`` (rings of
    ``nv`` points at ``nu`` polar angles in ``[1e-3, pi - 1e-3]``) and
    triangles ``[2 (nu - 1) nv, 3]``, two a quad."""
    th = torch.linspace(1e-3, math.pi - 1e-3, nu, dtype=torch.float64)
    ph = torch.arange(nv, dtype=torch.float64) * (2 * math.pi / nv)
    T, Ph = torch.meshgrid(th, ph, indexing="ij")
    pts = torch.stack([radius * torch.sin(T) * torch.cos(Ph), radius * torch.cos(T),
                       radius * torch.sin(T) * torch.sin(Ph)], -1).reshape(-1, 3).float()
    idx = torch.arange(nu * nv).reshape(nu, nv)
    a, d = idx[:-1], idx[1:]
    b, c = torch.roll(a, -1, 1), torch.roll(d, -1, 1)
    tri = torch.stack([torch.stack([a, b, c], -1), torch.stack([a, c, d], -1)], 1)
    return pts, tri.reshape(-1, 3)


def face_model(mesh: dict, seed: int, device="cuda"):
    """A linear morphable model over the sphere face, of BFM 2009's
    dimensions: ``{"mean" [3 nv], "basis" [D, 3 nv], "sigma" [D]}`` and the
    triangles ``[nf, 3]`` (int64). The basis holds smooth random fields
    (``sin`` of a random plane wave times a random direction, times
    ``basis_scale``), drawn from the seed on the device."""
    pts, tri = sphere_face(mesh["nu"], mesh["nv"], mesh["radius"])
    pts, tri = pts.to(device), tri.to(device)
    d = mesh["shape_dim"] + mesh["expression_dim"]
    g = stream(seed, "face", 0, device)
    freqs = 0.5 + 2.5 * torch.rand(d, 3, generator=g, device=device)
    phases = 2 * math.pi * torch.rand(d, 1, generator=g, device=device)
    dirs = torch.randn(d, 3, generator=g, device=device)
    dirs = dirs / dirs.norm(dim=-1, keepdim=True)
    field = torch.sin(pts @ (freqs.t() * math.pi) + phases.t())  # [n, d]
    basis = (field.t()[:, :, None] * dirs[:, None, :] * mesh["basis_scale"]).reshape(d, -1)
    sigma = torch.cat([torch.full((mesh["shape_dim"],), mesh["sigma_shape"]),
                       torch.full((mesh["expression_dim"],), mesh["sigma_expression"])])
    return {"mean": pts.reshape(-1), "basis": basis.contiguous(),
            "sigma": sigma.to(device)}, tri


def weights(cfg: dict, seed: int, device="cuda") -> dict[str, torch.Tensor]:
    """The GAR's parameters by name (``reference/gar.py::param_spec``),
    from one normal draw on the device, scaled by kind."""
    spec = gar.param_spec(cfg)
    total = sum(math.prod(shape) for _, shape, _ in spec)
    flat = torch.randn(total, generator=stream(seed, "weights", 0, device), device=device)
    out, at = {}, 0
    for name, shape, kind in spec:
        n = math.prod(shape)
        t = flat[at:at + n].reshape(shape)
        at += n
        if kind == "w_map":
            t = t / cfg["lr_mlp"]
        elif kind == "b_map":
            t = torch.zeros_like(t)
        elif kind in ("b", "noise"):
            t = 0.1 * t
        elif kind == "b_mod":
            t = 1.0 + 0.1 * t
        out[name] = t.contiguous()
    return out


def render_draws(seed: int, index: int, batch: int, cfg: dict, traffic: dict, face: dict,
                 device="cuda") -> dict[str, torch.Tensor]:
    """Batch ``index``'s draws: latents ``z`` ``[B, D]``, 3DMM coefficients
    ``x`` ``[B, D_face]`` from the prior, pose ``[B, 7]`` (yaw, pitch, roll,
    tx, ty, tz, log-scale) and one noise map ``[B, 1, r, r]`` per layer."""
    g = stream(seed, "render", index, device)
    z = torch.randn(batch, cfg["style_dim"], generator=g, device=device)
    x = torch.randn(batch, face["sigma"].shape[0], generator=g, device=device) * face["sigma"]
    pose = torch.randn(batch, 7, generator=g, device=device) * torch.tensor(
        traffic["pose_std"], device=device)
    noise = [torch.randn(batch, 1, r, r, generator=g, device=device)
             for r in gar.noise_shapes(cfg["size"])]
    return {"z": z, "x": x, "pose": pose, "noise": noise}


def targets(seed: int, batch: int, size: int, grid: int, device="cuda") -> torch.Tensor:
    """Smooth random images ``[B, 3, size, size]`` in (-1, 1): a ``grid``
    x ``grid`` normal field, bicubically enlarged, through ``tanh``."""
    g = stream(seed, "targets", 0, device)
    base = torch.randn(batch, 3, grid, grid, generator=g, device=device)
    return torch.tanh(torch.nn.functional.interpolate(base, size=(size, size), mode="bicubic",
                                                      align_corners=False))


def mean_latent_seed(seed: int) -> int:
    """Seed of the CPU generator whose 4096 latents give the mean latent."""
    h = hashlib.sha256(f"{int(seed)}/mean_latent".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def mean_latent_draws(seed: int, n: int, dim: int) -> torch.Tensor:
    """The mean latent's ``n`` latents ``[n, dim]``, drawn on the CPU (as the
    projector draws them)."""
    return torch.randn(n, dim, generator=torch.Generator().manual_seed(mean_latent_seed(seed)))
