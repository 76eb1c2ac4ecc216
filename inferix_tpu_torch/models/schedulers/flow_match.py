"""Flow-matching noise schedule (port of
`inferix_tpu/models/schedulers/flow_match.py`): shifted sigmas
`shift*s/(1+(shift-1)*s)` over linspace(sigma_max..sigma_min), timestep ->
sigma by the nearest timestep, `add_noise = (1-sigma)*x0 + sigma*noise` and
`x0 = x_t - sigma_t * flow`. Tables are built in float64 on the host; the
device math is float32.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from ...core.device import resolve_device


NUM_TRAIN_TIMESTEPS = 1000


@dataclasses.dataclass(frozen=True)
class FlowMatchSchedule:
    sigmas: torch.Tensor      # [1000] float32
    timesteps: torch.Tensor   # [1000] float32

    @classmethod
    def create(cls, shift: float = 8.0,
               device: str | torch.device = "cuda") -> "FlowMatchSchedule":
        """The JAX package's `FlowMatchSchedule.create` at its defaults (1000
        inference steps over sigma 1..0 with the extra step dropped)."""
        device = resolve_device(device)
        sigmas = np.linspace(1.0, 0.0, NUM_TRAIN_TIMESTEPS + 1, dtype=np.float64)[:-1]
        sigmas = shift * sigmas / (1.0 + (shift - 1.0) * sigmas)
        return cls(
            sigmas=torch.as_tensor(sigmas, dtype=torch.float32, device=device),
            timesteps=torch.as_tensor(sigmas * NUM_TRAIN_TIMESTEPS,
                                      dtype=torch.float32, device=device),
        )

    def timestep_id(self, timestep: torch.Tensor) -> torch.Tensor:
        t = timestep.float()
        return torch.argmin(
            (self.timesteps[None, :] - t.reshape(-1)[:, None]).abs(), dim=1
        ).reshape(t.shape)

    def sigma_at(self, timestep: torch.Tensor) -> torch.Tensor:
        return self.sigmas[self.timestep_id(timestep)]

    def _sigma_like(self, timestep: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        sigma = self.sigma_at(timestep)
        return sigma.reshape(sigma.shape + (1,) * (x.dim() - sigma.dim()))

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor,
                  timestep: torch.Tensor) -> torch.Tensor:
        """Corrupt x0 to noise level `timestep` (broadcast over x0's leading
        dims, per frame in the semi-AR loop)."""
        sigma = self._sigma_like(timestep, x0)
        out = (1.0 - sigma) * x0.float() + sigma * noise.float()
        return out.to(noise.dtype)

    def flow_to_x0(self, flow_pred: torch.Tensor, xt: torch.Tensor,
                   timestep: torch.Tensor) -> torch.Tensor:
        sigma = self._sigma_like(timestep, xt)
        return (xt.float() - sigma * flow_pred.float()).to(xt.dtype)


def warp_denoising_steps(schedule: FlowMatchSchedule,
                         denoising_step_list: Sequence[int]) -> Tuple[float, ...]:
    """Map nominal step indices through the shifted schedule (timesteps[1000
    - step], with a trailing zero). Host-side."""
    ts = np.concatenate([schedule.timesteps.cpu().numpy(), [0.0]])
    n = schedule.timesteps.shape[0]
    return tuple(float(ts[n - s]) for s in denoising_step_list)
