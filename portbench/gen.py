"""The benchmark's data, made from ``--seed`` on the device.

A frozen copy of the distributions of the port's synthetic generator
(``io/synthetic.py``), written for a ``torch.Generator`` on the card so a
10M-match history takes a few large calls instead of a host loop:

  * players: latent skill N(1500, 400); rank points for 35% (ranked) and
    15% (blitz) of them, latent plus N(0, 150) / N(0, 200), floored at 1;
    skill tier ``clip(int((latent - 600) / 85), -1, 29)``;
  * activity: Zipf weights ``1 / rank^s`` clipped to a share cap and
    renormalised until stable, shuffled over the players;
  * matches: a mode uniform over the six modes (3v3 for the first four,
    5v5 for the last two), 0.5% unsupported, 2% AFK; 2 x 5 distinct
    players drawn by activity, the first ``team_size`` of each half
    playing; team 0 wins with probability
    ``1 / (1 + exp(-gap / (400 * team_size)))`` of the latent-skill gap.

The same seed gives the same data on the same device. The stream is not
byte-equal to ``io/synthetic.py``'s for a seed (that one draws with
numpy on the host); its distributions are the same.
"""

from __future__ import annotations

import numpy as np
import torch

N_MODES = 6
UNSUPPORTED_MODE_ID = -1
MAX_TEAM = 5
#: Team size by mode id (casual, ranked, blitz, br are 3v3; 5v5_* are 5).
MODE_TEAM_SIZE = (3, 3, 3, 3, 5, 5)


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator for one named sub-stream of a run's seed."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream * 7_919) % (2**63 - 1))
    return g


def make_players(n: int, seed: int, device) -> dict[str, torch.Tensor]:
    """Latent skill and seed features of ``n`` players, on ``device``."""
    g = generator(seed, 1, device)
    f64 = dict(dtype=torch.float64, device=device, generator=g)
    latent = torch.randn(n, **f64) * 400.0 + 1500.0
    has_ranked = torch.rand(n, **f64) < 0.35
    has_blitz = torch.rand(n, **f64) < 0.15
    nan = torch.full((n,), float("nan"), dtype=torch.float64, device=device)
    rp_ranked = torch.where(
        has_ranked, (latent + torch.randn(n, **f64) * 150.0).clamp(min=1.0), nan)
    rp_blitz = torch.where(
        has_blitz, (latent + torch.randn(n, **f64) * 200.0).clamp(min=1.0), nan)
    tier = ((latent - 600.0) / 85.0).to(torch.int32).clamp(-1, 29)
    return {"latent": latent, "rank_points_ranked": rp_ranked,
            "rank_points_blitz": rp_blitz, "skill_tier": tier}


def activity_cdf(n_players: int, concentration: float, cap: float | None,
                 g: torch.Generator, device) -> torch.Tensor:
    """Cumulative activity weights over the players (float64, last = 1)."""
    ranks = torch.arange(1, n_players + 1, dtype=torch.float64, device=device)
    w = 1.0 / ranks**concentration
    if cap is not None:
        cap = max(cap, 1.0 / n_players)
        for _ in range(64):
            clipped = torch.minimum(w, cap * w.sum())
            if torch.equal(clipped, w):
                break
            w = clipped
    w = w[torch.randperm(n_players, generator=g, device=device)]
    cdf = torch.cumsum(w / w.sum(), 0)
    cdf[-1] = 1.0
    return cdf


def _draw(cdf: torch.Tensor, shape, g: torch.Generator) -> torch.Tensor:
    u = torch.rand(shape, dtype=torch.float64, device=cdf.device, generator=g)
    return torch.searchsorted(cdf, u, right=True).clamp_(max=cdf.numel() - 1)


def make_stream(n: int, latent: torch.Tensor, seed: int,
                concentration: float, cap: float | None,
                afk_rate: float = 0.02, unsupported_rate: float = 0.005,
                structure_seed: int | None = None,
                chunk: int = 2_000_000) -> dict[str, np.ndarray]:
    """``n`` matches over the players of ``latent``; host numpy arrays in
    the port's stream layout: ``player_idx [n, 2, 5]`` int32 (-1 = empty
    slot), ``winner``, ``mode_id`` int32, ``afk`` bool.

    ``structure_seed`` (default: ``seed``) draws the history's shape:
    which activity ranks meet in which match, the modes and the AFK
    flags. ``seed`` then relabels the players (a permutation of the rows)
    and draws the outcomes from ``latent``. Every seed of one structure
    therefore asks the same work of a rater, in other players' names:
    the same conflicts, so the same schedule up to the relabelling."""
    device = latent.device
    g = generator(seed if structure_seed is None else structure_seed, 2, device)
    relabel = torch.randperm(latent.numel(), generator=generator(seed, 4, device),
                             device=device)
    cdf = activity_cdf(latent.numel(), concentration, cap, g, device)
    mode = torch.randint(0, N_MODES, (n,), generator=g, device=device,
                         dtype=torch.int32)
    unsupported = torch.rand(n, generator=g, device=device) < unsupported_rate
    mode[unsupported] = UNSUPPORTED_MODE_ID
    afk = torch.rand(n, generator=g, device=device) < afk_rate
    sizes = torch.tensor(MODE_TEAM_SIZE, dtype=torch.int32, device=device)
    team = torch.where(mode >= 0, sizes[mode.clamp(min=0).long()], 3)
    win_u = torch.rand(n, dtype=torch.float64, device=device,
                       generator=generator(seed, 5, device))
    out_idx = np.empty((n, 2, MAX_TEAM), np.int32)
    out_win = np.empty(n, np.int32)
    cols = torch.arange(MAX_TEAM, device=device)
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        k = hi - lo
        flat = _draw(cdf, (k, 2 * MAX_TEAM), g)
        need = torch.arange(k, device=device)
        for _ in range(64):
            srt = flat[need].sort(dim=1).values
            dup = (srt[:, 1:] == srt[:, :-1]).any(dim=1)
            need = need[dup]
            if need.numel() == 0:
                break
            flat[need] = _draw(cdf, (need.numel(), 2 * MAX_TEAM), g)
        else:
            raise RuntimeError("could not draw distinct players")
        ts = team[lo:hi, None]
        live = cols[None, :] < ts
        pidx = relabel[torch.stack((flat[:, :MAX_TEAM], flat[:, MAX_TEAM:]), 1)]
        pidx = torch.where(live[:, None, :], pidx, -1)
        skill = torch.where(live[:, None, :], latent[pidx.clamp(min=0)], 0.0)
        gap = skill[:, 0].sum(1) - skill[:, 1].sum(1)
        p_win = 1.0 / (1.0 + torch.exp(-gap / (400.0 * ts[:, 0])))
        out_win[lo:hi] = (win_u[lo:hi] >= p_win).to(torch.int32).cpu().numpy()
        out_idx[lo:hi] = pidx.to(torch.int32).cpu().numpy()
    return {"player_idx": out_idx, "winner": out_win,
            "mode_id": mode.cpu().numpy(), "afk": afk.cpu().numpy()}
