"""The comparison that decides ``correct``: each compared frame the timed
path produced against the reference's frame at the same pose and time,
both clipped to the displayed [0, 1] range. The number compared is the
largest |RGB difference| of any pixel of any compared frame
(``max_abs``); its limit is the configuration's ``max_abs_limit``. The
share of pixels more than the configuration's ``pixel_tolerance`` apart
(the project's parity reading) is recorded beside it."""
from __future__ import annotations

import torch


def pixels_off_pct(img: torch.Tensor, ref: torch.Tensor,
                   tolerance: float) -> float:
    """Percent of pixels whose max |RGB difference| > tolerance."""
    if img.shape != ref.shape:
        raise ValueError(f"frame {tuple(img.shape)} vs reference "
                         f"{tuple(ref.shape)}")
    a = torch.clamp(img[..., :3].to(ref.device, torch.float32), 0.0, 1.0)
    b = torch.clamp(ref[..., :3].to(torch.float32), 0.0, 1.0)
    d = (a - b).abs().amax(dim=-1)
    # a NaN pixel is off
    off = (d > tolerance) | torch.isnan(d)
    return 100.0 * off.to(torch.float64).mean().item()


def numbers(img: torch.Tensor, ref: torch.Tensor, tolerance: float) -> dict:
    """The largest |RGB difference| (clipped; a NaN reads infinite), the
    compared number, beside the share of pixels off by more than
    `tolerance` and the mean |RGB difference|, for the record."""
    a = torch.clamp(img[..., :3].to(ref.device, torch.float32), 0.0, 1.0)
    b = torch.clamp(ref[..., :3].to(torch.float32), 0.0, 1.0)
    d = (a - b).abs()
    worst = d.max().item() if not torch.isnan(d).any() else float("inf")
    return {"max_abs": worst,
            "pixels_off_pct": pixels_off_pct(img, ref, tolerance),
            "mean_abs": d.mean().item()}


def sample_frames(rng, count: int, below: int) -> list:
    """`count` distinct frame indices below `below`, drawn from rng."""
    return sorted(int(i) for i in rng.choice(below, size=count,
                                             replace=False))
