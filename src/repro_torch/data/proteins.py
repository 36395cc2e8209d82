"""Synthetic protein-structure universe + PDB-like text parsing (a copy
of ``repro.data.proteins``, numpy only, with a chunked generator).

PDB itself is not available offline, so benchmarks and tests run on a
synthetic universe designed to preserve the *statistical* properties the
paper's claims depend on:

  * family structure — proteins come in families (a prototype backbone
    plus per-member noise, local refolds, and length jitter), so the
    Q-distance distribution is multimodal and clusterable, like PDB;
  * self-avoiding-walk-like backbones with realistic bond length (3.8 Å
    between consecutive C-alpha atoms) and persistence (folded-globule
    radius of gyration ~ N^(1/3));
  * a heavy-tailed chain-length distribution (log-normal, clipped) — the
    paper's Fig. 6 argument (long chains are rare) holds by construction;
  * random global rotation + translation per chain, so nothing downstream
    may depend on the lab frame (embedding invariance is load-bearing).

`generate_dataset` is reproducible (seed-keyed) and chunked so the
500k-chain scale of PDB is generatable if wanted; benchmarks default to a
few tens of thousands of chains to stay CPU-friendly.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np

BOND_LENGTH = 3.8  # C-alpha to C-alpha distance in Angstroms


class ProteinDataset(NamedTuple):
    coords: np.ndarray  # (M, L_max, 3) float32, zero-padded
    lengths: np.ndarray  # (M,) int32
    family: np.ndarray  # (M,) int32 — generative family id (diagnostics only)


@dataclasses.dataclass(frozen=True)
class ProteinGenConfig:
    n_proteins: int = 20_000
    n_families: int = 200
    families_per_superfamily: int = 5  # two-level similarity hierarchy
    max_length: int = 512
    min_length: int = 30
    length_lognorm_mean: float = 4.9  # median ~134 residues (PDB-like)
    length_lognorm_sigma: float = 0.55
    member_noise: float = 0.6  # Angstrom jitter within a family
    family_noise: float = 2.0  # jitter of a family proto vs its superfamily
    family_refold: float = 0.25  # fraction of a family proto locally refolded
    refold_fraction: float = 0.3  # members with an extra local refold
    compactness: float = 0.65  # 0 = pure random walk, 1 = strongly globular


def _random_walk(rng: np.random.Generator, n: int, compactness: float) -> np.ndarray:
    """Persistent self-attracting random walk -> globule-like backbone."""
    steps = rng.normal(size=(n - 1, 3))
    steps /= np.linalg.norm(steps, axis=1, keepdims=True)
    pts = np.zeros((n, 3), np.float64)
    for i in range(1, n):
        d = steps[i - 1]
        # bias the step back toward the centroid for compactness
        centroid = pts[:i].mean(axis=0)
        back = centroid - pts[i - 1]
        nb = np.linalg.norm(back)
        if nb > 1e-9:
            d = (1 - compactness) * d + compactness * 0.15 * back / nb
            d /= np.linalg.norm(d)
        pts[i] = pts[i - 1] + BOND_LENGTH * d
    return pts


def _random_rotation(rng: np.random.Generator) -> np.ndarray:
    """Haar-uniform 3x3 rotation via QR of a Gaussian matrix."""
    a = rng.normal(size=(3, 3))
    q, r = np.linalg.qr(a)
    q *= np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q


def _refold_window(rng, pts, frac, compactness):
    """Re-run a random walk over a random window covering ~frac of pts."""
    n = pts.shape[0]
    w = max(10, int(n * frac))
    if n <= w + 2:
        return pts
    w0 = rng.integers(0, n - w)
    seg = _random_walk(rng, w, compactness)
    pts = pts.copy()
    pts[w0 : w0 + w] = seg - seg.mean(axis=0) + pts[w0 : w0 + w].mean(axis=0)
    return pts


def _universe(rng: np.random.Generator, cfg: ProteinGenConfig):
    """Family prototypes of the two-level similarity hierarchy
    (superfamily -> family), drawn first from the dataset's stream."""
    n_super = max(1, cfg.n_families // cfg.families_per_superfamily)
    super_len = np.clip(
        rng.lognormal(cfg.length_lognorm_mean, cfg.length_lognorm_sigma, n_super),
        cfg.min_length,
        cfg.max_length,
    ).astype(np.int32)
    super_protos = [_random_walk(rng, int(l), cfg.compactness) for l in super_len]
    # family prototypes: perturbed + partially-refolded superfamily protos
    prototypes = []
    for f in range(cfg.n_families):
        base = super_protos[f % n_super]
        pts = base + rng.normal(scale=cfg.family_noise, size=base.shape)
        pts = _refold_window(rng, pts, cfg.family_refold * rng.random(), cfg.compactness)
        prototypes.append(pts)
    return prototypes


def _member(rng: np.random.Generator, base: np.ndarray, cfg: ProteinGenConfig) -> np.ndarray:
    """One family member: trimmed, jittered, maybe locally refolded, posed."""
    n = base.shape[0]
    # length jitter: trim or keep
    trim = rng.integers(0, max(1, n // 64))
    side = rng.integers(0, 2)
    pts = base[trim:] if side == 0 else base[: n - trim]
    pts = pts.copy()
    # member noise
    pts += rng.normal(scale=cfg.member_noise, size=pts.shape)
    # occasional local refold: re-run a random walk over a random window
    if rng.random() < cfg.refold_fraction and pts.shape[0] > 20:
        w0 = rng.integers(0, pts.shape[0] - 15)
        w1 = min(pts.shape[0], w0 + rng.integers(10, 40))
        seg = _random_walk(rng, w1 - w0, cfg.compactness)
        pts[w0:w1] = seg - seg.mean(axis=0) + pts[w0:w1].mean(axis=0)
    # random pose
    return pts @ _random_rotation(rng).T + rng.normal(scale=50.0, size=(1, 3))


def iter_dataset(seed: int, cfg: ProteinGenConfig = ProteinGenConfig(),
                 chunk_size: int = 65536):
    """`generate_dataset` in chunks of ``chunk_size`` chains, so the
    518k-chain scale of PDB never holds its (M, L_max, 3) coordinates in
    host memory at once. The chunks concatenate to exactly
    `generate_dataset(seed, cfg)`: one random stream, consumed in the same
    order."""
    rng = np.random.default_rng(seed)
    prototypes = _universe(rng, cfg)
    family = rng.integers(0, cfg.n_families, cfg.n_proteins).astype(np.int32)
    for s in range(0, cfg.n_proteins, chunk_size):
        m = min(chunk_size, cfg.n_proteins - s)
        coords = np.zeros((m, cfg.max_length, 3), np.float32)
        lengths = np.zeros(m, np.int32)
        for i in range(m):
            pose = _member(rng, prototypes[family[s + i]], cfg)
            L = min(pose.shape[0], cfg.max_length)
            coords[i, :L] = pose[:L]
            lengths[i] = L
        yield ProteinDataset(coords=coords, lengths=lengths, family=family[s:s + m])


def generate_dataset(seed: int, cfg: ProteinGenConfig = ProteinGenConfig()) -> ProteinDataset:
    """Two-level similarity hierarchy (superfamily -> family -> member) so
    the Q-distance distribution has the intermediate-similarity mass the
    paper's range-0.3/0.5 queries depend on (a flat family model makes
    every query trivially easy — recall saturates at 1.0)."""
    return next(iter_dataset(seed, cfg, chunk_size=max(cfg.n_proteins, 1)))


# ------------------------------------------------------------- PDB parsing


def parse_pdb_ca(text: str, max_length: int = 512) -> tuple[np.ndarray, int]:
    """Parse C-alpha ATOM records from PDB-format text -> (L_max, 3), length.

    Minimal, column-oriented per the PDB fixed-width spec. Lets real PDB
    files be dropped into the same pipeline when available.
    """
    pts = []
    for line in text.splitlines():
        if line.startswith(("ATOM", "HETATM")) and line[12:16].strip() == "CA":
            try:
                pts.append(
                    (float(line[30:38]), float(line[38:46]), float(line[46:54]))
                )
            except ValueError:
                continue
        if len(pts) >= max_length:
            break
    out = np.zeros((max_length, 3), np.float32)
    n = len(pts)
    if n:
        out[:n] = np.asarray(pts, np.float32)
    return out, n
