"""NequIP (arXiv:2101.03164): E(3)-equivariant interatomic potential (the
port of ``repro/models/nequip.py``).

Features are direct sums of real-SO(3) irreps f_l: [N, C, 2l+1], l<=l_max.
Each interaction layer builds edge messages via Clebsch-Gordan tensor
products of neighbor features with spherical harmonics of the edge vector,
weighted by a learned radial function of the interatomic distance (Bessel
RBF + polynomial cutoff), aggregated with a segment sum (``index_add``),
and mixed with self-interactions + gated nonlinearities.

The real-basis Wigner-3j intertwiners are computed on the host from first
principles (Racah's formula + complex->real change of basis): a copy of
the reference's numpy code, so both packages couple with the same float32
tensors.  Forces are ``-dE/dpos`` by ``torch.autograd.grad``.

Sharded as the reference's train step: ``src`` and ``dst`` split over the
edges, node tensors and parameters whole.  On DTensors each layer's edge
stage (``edge_messages``) runs on each rank's own edges
(``local_edge_sums``) and its message sums are all-reduced; the node stage
takes DTensor's own rules.
"""
from __future__ import annotations

import dataclasses
import math
from functools import lru_cache
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import is_dtensor, local_edge_sums, reduced
from repro_torch.models.params import carry_params, draw_params


# ---------------------------------------------------------------------------
# Clebsch-Gordan / real Wigner-3j machinery (host-side, numpy)
# ---------------------------------------------------------------------------

def _fact(n: int) -> float:
    return float(math.factorial(n))


def clebsch_gordan(j1: int, m1: int, j2: int, m2: int, j3: int, m3: int) -> float:
    """<j1 m1 j2 m2 | j3 m3> via Racah's formula (integer spins)."""
    if m3 != m1 + m2 or j3 < abs(j1 - j2) or j3 > j1 + j2:
        return 0.0
    if abs(m1) > j1 or abs(m2) > j2 or abs(m3) > j3:
        return 0.0
    pref = math.sqrt(
        (2 * j3 + 1)
        * _fact(j1 + j2 - j3) * _fact(j1 - j2 + j3) * _fact(-j1 + j2 + j3)
        / _fact(j1 + j2 + j3 + 1)
    )
    pref *= math.sqrt(
        _fact(j1 + m1) * _fact(j1 - m1) * _fact(j2 + m2)
        * _fact(j2 - m2) * _fact(j3 + m3) * _fact(j3 - m3)
    )
    s = 0.0
    for k in range(0, j1 + j2 - j3 + 1):
        denoms = [
            k, j1 + j2 - j3 - k, j1 - m1 - k, j2 + m2 - k,
            j3 - j2 + m1 + k, j3 - j1 - m2 + k,
        ]
        if any(d < 0 for d in denoms):
            continue
        s += (-1.0) ** k / np.prod([_fact(d) for d in denoms])
    return pref * s


def _real_basis(l: int) -> np.ndarray:
    """U[m_real, mu_complex]: real SH as combinations of complex SH
    (Condon-Shortley phases)."""
    dim = 2 * l + 1
    U = np.zeros((dim, dim), dtype=complex)
    for m in range(-l, l + 1):
        i = m + l
        if m > 0:
            U[i, -m + l] = 1.0 / math.sqrt(2.0)
            U[i, m + l] = (-1.0) ** m / math.sqrt(2.0)
        elif m == 0:
            U[i, l] = 1.0
        else:
            n = -m
            U[i, -n + l] = 1j / math.sqrt(2.0)
            U[i, n + l] = -1j * (-1.0) ** n / math.sqrt(2.0)
    return U


@lru_cache(maxsize=None)
def real_w3j(l1: int, l2: int, l3: int) -> np.ndarray:
    """Real-basis intertwiner C[m1, m2, m3]: the coupling tensor such that
    (f ⊗ g)_{m3} = sum_{m1 m2} C[m1,m2,m3] f_{m1} g_{m2} is equivariant."""
    cg = np.zeros((2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1))
    for mu1 in range(-l1, l1 + 1):
        for mu2 in range(-l2, l2 + 1):
            mu3 = mu1 + mu2
            if abs(mu3) <= l3:
                cg[mu1 + l1, mu2 + l2, mu3 + l3] = clebsch_gordan(
                    l1, mu1, l2, mu2, l3, mu3
                )
    U1, U2, U3 = _real_basis(l1), _real_basis(l2), _real_basis(l3)
    out = np.einsum("ia,jb,kc,abc->ijk", U1, U2, np.conj(U3), cg)
    if np.abs(out.imag).max() > np.abs(out.real).max():
        out = out.imag
    else:
        out = out.real
    norm = np.linalg.norm(out)
    return (out / norm if norm > 1e-12 else out).astype(np.float32)


def spherical_harmonics(u: torch.Tensor, l_max: int) -> List[torch.Tensor]:
    """Real SH (normalization-free per l) of unit vectors u [E, 3], ordered
    m=-l..l with (x, y, z) = u.  Matches the _real_basis convention."""
    x, y, z = u[:, 0], u[:, 1], u[:, 2]
    out = [torch.ones_like(x)[:, None]]
    if l_max >= 1:
        out.append(torch.stack([y, z, x], dim=-1))
    if l_max >= 2:
        s3 = math.sqrt(3.0)
        out.append(
            torch.stack(
                [
                    s3 * x * y,
                    s3 * y * z,
                    0.5 * (3 * z * z - 1.0),
                    s3 * x * z,
                    0.5 * s3 * (x * x - y * y),
                ],
                dim=-1,
            )
        )
    return out


# ---------------------------------------------------------------------------
# config / params
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NequIPConfig:
    name: str
    n_layers: int = 5
    d_hidden: int = 32        # channels per irrep
    l_max: int = 2
    n_rbf: int = 8
    cutoff: float = 5.0
    n_species: int = 16
    dtype: Any = torch.float32

    @property
    def paths(self) -> List[Tuple[int, int, int]]:
        ps = []
        for l1 in range(self.l_max + 1):
            for l2 in range(self.l_max + 1):
                for l3 in range(abs(l1 - l2), min(l1 + l2, self.l_max) + 1):
                    ps.append((l1, l2, l3))
        return ps


def _layout(cfg: NequIPConfig) -> Dict:
    """The reference's parameter tree with ``(shape, scale)`` leaves."""
    C = cfg.d_hidden

    def dense(shape, scale=None):
        return (shape, scale if scale is not None else 1.0 / math.sqrt(shape[0]))

    def zeros(n):
        return ((n,), None)

    layers = [{
        # radial MLP: rbf -> hidden -> per-path-channel weights
        "rad_w1": dense((cfg.n_rbf, 32)),
        "rad_b1": zeros(32),
        "rad_w2": dense((32, len(cfg.paths) * C)),
        # per-l self-interaction + message mixing (channel mixes)
        "self": [dense((C, C)) for _ in range(cfg.l_max + 1)],
        "msg": [dense((C, C)) for _ in range(cfg.l_max + 1)],
        # gates: scalars for each l>0 irrep
        "gate_w": dense((C, cfg.l_max * C)),
        "gate_b": zeros(cfg.l_max * C),
    } for _ in range(cfg.n_layers)]
    return {
        "species_embed": dense((cfg.n_species, C), scale=1.0),
        "layers": layers,
        "energy_w1": dense((C, C)),
        "energy_b1": zeros(C),
        "energy_w2": dense((C, 1)),
    }


def init_nequip(cfg: NequIPConfig, generator: torch.Generator, device=None) -> Dict:
    return draw_params(_layout(cfg), cfg.dtype, generator, device)


def params_from_numpy(tree: Dict, cfg: NequIPConfig, device=None) -> Dict:
    """The reference's ``init_nequip`` tree as numpy arrays -> the port's."""
    return carry_params(_layout(cfg), tree, cfg.dtype, device)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _seg_sum(values: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    return values.new_zeros((n,) + tuple(values.shape[1:])).index_add(0, ids, values)


def _bessel_rbf(d, n_rbf: int, cutoff: float):
    """Bessel radial basis with smooth polynomial cutoff envelope."""
    d = torch.clamp(d, min=1e-6)
    n = torch.arange(1, n_rbf + 1, dtype=d.dtype, device=d.device)
    rbf = torch.sin(n * math.pi * d[:, None] / cutoff) / d[:, None]
    x = d / cutoff
    env = torch.where(x < 1.0, 1.0 - 6 * x**5 + 15 * x**4 - 10 * x**3, 0.0)
    return rbf * env[:, None]


def _w3js(cfg: NequIPConfig, device) -> Dict[Tuple[int, int, int], torch.Tensor]:
    return {p: torch.as_tensor(real_w3j(*p), dtype=cfg.dtype, device=device)
            for p in cfg.paths}


def _geometry(pos, src, dst, cfg: NequIPConfig):
    """The edges' spherical harmonics ([E, 2l+1] per l) and Bessel RBF
    [E, n_rbf]."""
    r = pos[dst] - pos[src]
    d = torch.linalg.norm(r, dim=-1)
    u = r / torch.clamp(d, min=1e-6)[:, None]
    return spherical_harmonics(u, cfg.l_max), _bessel_rbf(d, cfg.n_rbf, cfg.cutoff)


def edge_messages(pos, src, dst, feats, lp, cfg: NequIPConfig, geometry=None):
    """One interaction layer's edge stage on plain tensors: the radial MLP,
    the tensor products of ``feats[l1][src]`` with the edges' harmonics, and
    their sums into ``dst``.  Returns the per-``l`` messages [N, C, 2l+1].
    ``geometry`` is ``_geometry(pos, src, dst, cfg)``, computed here unless
    given."""
    Y, rbf = geometry if geometry is not None else _geometry(pos, src, dst, cfg)
    N, C = feats[0].shape[0], cfg.d_hidden
    w3js = _w3js(cfg, pos.device)
    h = F.silu(rbf @ lp["rad_w1"] + lp["rad_b1"])
    radial = (h @ lp["rad_w2"]).reshape(-1, len(cfg.paths), C)  # [E, P, C]

    msgs = [pos.new_zeros((N, C, 2 * l + 1)) for l in range(cfg.l_max + 1)]
    for pi, (l1, l2, l3) in enumerate(cfg.paths):
        f_src = feats[l1][src]                      # [E, C, 2l1+1]
        tp = torch.einsum("eci,ej,ijk->eck", f_src, Y[l2], w3js[(l1, l2, l3)])
        tp = tp * radial[:, pi, :, None]
        msgs[l3] = msgs[l3] + _seg_sum(tp, dst, N)
    return msgs


_RADIAL = ("rad_w1", "rad_b1", "rad_w2")


def _sharded_edge_messages(pos, src, dst, feats, lp, cfg: NequIPConfig):
    """``edge_messages`` on DTensors, each rank on its own edges: every
    edge-sized tensor is made from the rank's ``src`` / ``dst`` rows, node
    tensors and parameters go in whole, and the messages come back summed
    over the ranks."""
    def local(s, d, p, *rest):
        radial = dict(zip(_RADIAL, rest[:len(_RADIAL)]))
        return tuple(edge_messages(p, s, d, list(rest[len(_RADIAL):]), radial, cfg))

    msgs = local_edge_sums(local, src, dst, pos, *(lp[k] for k in _RADIAL), *feats,
                           n_out=len(feats))
    return [reduced(m) for m in msgs]


def nequip_forward(params, batch, cfg: NequIPConfig):
    """batch: {species [N], pos [N,3], src [E], dst [E], (graph_id [N],
    n_graphs)}.  Returns per-graph (or total) energy [G].  On DTensors
    (``src`` and ``dst`` sharded over the edges, the rest whole) each
    layer's edge stage runs on each rank's own edges."""
    species, pos = batch["species"], batch["pos"].to(cfg.dtype)
    src, dst = batch["src"], batch["dst"]
    N, C = species.shape[0], cfg.d_hidden
    sharded = any(is_dtensor(t) for t in (pos, src, dst))
    geometry = None if sharded else _geometry(pos, src, dst, cfg)

    # initial features: scalars from species embedding; higher l zero
    feats = [pos.new_zeros((N, C, 2 * l + 1)) for l in range(cfg.l_max + 1)]
    feats[0] = params["species_embed"][species][:, :, None]

    for lp in params["layers"]:
        if sharded:
            msgs = _sharded_edge_messages(pos, src, dst, feats, lp, cfg)
        else:
            msgs = edge_messages(pos, src, dst, feats, lp, cfg, geometry)

        new_feats = []
        for l in range(cfg.l_max + 1):
            f = torch.einsum("nci,cd->ndi", feats[l], lp["self"][l]) + torch.einsum(
                "nci,cd->ndi", msgs[l], lp["msg"][l])
            new_feats.append(f)
        # gated nonlinearity: scalars -> SiLU; l>0 gated by learned scalars
        scalars = new_feats[0][:, :, 0]
        gates = torch.sigmoid(scalars @ lp["gate_w"] + lp["gate_b"]).reshape(
            N, cfg.l_max, C)
        out_feats = [F.silu(scalars)[:, :, None]]
        for l in range(1, cfg.l_max + 1):
            out_feats.append(new_feats[l] * gates[:, l - 1, :, None])
        feats = out_feats

    atom_e = F.silu(feats[0][:, :, 0] @ params["energy_w1"] + params["energy_b1"])
    atom_e = (atom_e @ params["energy_w2"])[:, 0]       # [N]
    gid = batch.get("graph_id")
    if gid is not None:
        n_graphs = batch.get("n_graphs") or int(gid.max()) + 1
        return _seg_sum(atom_e, gid, n_graphs)
    return torch.sum(atom_e)[None]


def nequip_energy_forces(params, batch, cfg: NequIPConfig):
    """(total energy, forces = -dE/dpos [N, 3]), the gradient taken with
    ``torch.autograd.grad`` with respect to a ``pos`` that requires it."""
    with torch.enable_grad():
        pos = batch["pos"].detach().to(cfg.dtype).requires_grad_(True)
        e = nequip_forward(params, {**batch, "pos": pos}, cfg).sum()
        (grad,) = torch.autograd.grad(e, pos)
    return e.detach(), -grad


__all__ = [
    "NequIPConfig",
    "clebsch_gordan",
    "real_w3j",
    "spherical_harmonics",
    "init_nequip",
    "params_from_numpy",
    "edge_messages",
    "nequip_forward",
    "nequip_energy_forces",
]
