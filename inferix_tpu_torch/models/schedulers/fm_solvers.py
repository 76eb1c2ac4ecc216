"""Multistep flow-matching samplers for the many-step CFG path (port of
`inferix_tpu/models/schedulers/fm_solvers.py`).

For the flow-matching parameterization x_t = (1 - s) x0 + s eps, with the
model predicting v = eps - x0:
- `FlowDPMSolverMultistep`: DPM-Solver++(2M): data prediction D = x - s v,
  lambda L = log((1 - s) / s), first order x' = (s'/s) x - (1 - s')(e^-h - 1) D
  with h = L' - L, and from the second step on D_bar = (1 + 1/2r) D -
  (1/2r) D_prev with r = h_prev / h. Its scalars are float32 tensors, as
  the JAX solver computes them.
- `FlowUniPCMultistep`: the UniPC predictor-corrector (B(h) = e^h - 1, "bh2",
  predict x0, orders 1-3): each step corrects the incoming sample with the
  fresh model output and the history (UniC), then predicts the next sample
  (UniP). The step index is a Python int, so every scalar coefficient is
  computed on the host in float64; the tensor combinations run in float32.
Both take `step(flow_pred, step_index, sample, state)` and return the next
sample in the sample's dtype and the next state.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch


class SolverState(NamedTuple):
    """DPM-Solver++ history carried between steps."""

    prev_d: torch.Tensor      # previous data prediction (zeros before the first)
    prev_valid: torch.Tensor  # bool scalar: history available
    prev_h: torch.Tensor      # previous log-SNR step (float32 scalar)


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class FlowDPMSolverMultistep:
    """Stateless solver definition; timesteps built on the host."""

    sigmas: np.ndarray      # [N+1] descending, the last sigma_min (>= 0)
    timesteps: np.ndarray   # [N] sigmas[:-1] * 1000

    @classmethod
    def create(cls, num_steps: int, shift: float = 5.0,
               sigma_min: float = 0.003 / 1.002,
               sigma_max: float = 1.0) -> "FlowDPMSolverMultistep":
        sigmas = np.linspace(sigma_max, sigma_min, num_steps + 1)
        sigmas = shift * sigmas / (1 + (shift - 1) * sigmas)
        return cls(sigmas=sigmas, timesteps=(sigmas[:-1] * 1000.0))

    def init_state(self, sample_shape, dtype: torch.dtype = torch.float32,
                   device="cpu") -> SolverState:
        return SolverState(prev_d=torch.zeros(tuple(sample_shape), dtype=dtype, device=device),
                           prev_valid=torch.tensor(False, device=device),
                           prev_h=torch.zeros((), dtype=torch.float32, device=device))

    @staticmethod
    def _lam(s: torch.Tensor) -> torch.Tensor:
        s = torch.clamp(s, 1e-6, 1 - 1e-6)
        return torch.log((1 - s) / s)

    def step(self, flow_pred: torch.Tensor, step_index: int, sample: torch.Tensor,
             state: SolverState) -> Tuple[torch.Tensor, SolverState]:
        """One multistep update at step_index."""
        dev = sample.device
        s = _f32(self.sigmas[step_index], dev)
        s_next = _f32(self.sigmas[step_index + 1], dev)
        x = sample.float()
        d = x - s * flow_pred.float()
        h = self._lam(s_next) - self._lam(s)
        alpha_next = 1.0 - s_next
        # the 2M correction once there is history
        one = torch.ones((), device=dev)
        r = state.prev_h / torch.where(h == 0, one, h)
        inv2r = 1 / (2 * torch.where(r == 0, one, r))
        d_used = torch.where(state.prev_valid, (1 + inv2r) * d - inv2r * state.prev_d, d)
        x_next = (s_next / s) * x - alpha_next * (torch.exp(-h) - 1.0) * d_used
        return x_next.to(sample.dtype), SolverState(
            prev_d=d.to(state.prev_d.dtype), prev_valid=torch.tensor(True, device=dev),
            prev_h=h)


class UniPCState(NamedTuple):
    """UniPC history: m_hist holds the last `solver_order` x0 predictions,
    newest last (entries before the first step are zeros and never read);
    last_sample is the previous step's sample before its prediction (the
    corrector's x_{t-1})."""

    m_hist: torch.Tensor      # [order, *sample_shape]
    last_sample: torch.Tensor


def _unipc_coeffs(hh: float, rks: np.ndarray, order: int, variant: str):
    """Host-side UniPC B(h) coefficients: the Vandermonde R in rks and b
    from the phi-k recursion. Returns (R, b) float64."""
    h_phi_1 = np.expm1(hh)
    h_phi_k = h_phi_1 / hh - 1
    b_h = hh if variant == "bh1" else np.expm1(hh)
    R, b = [], []
    factorial_i = 1.0
    for i in range(1, order + 1):
        R.append(np.power(rks, i - 1))
        b.append(h_phi_k * factorial_i / b_h)
        factorial_i *= i + 1
        h_phi_k = h_phi_k / hh - 1 / factorial_i
    return np.stack(R), np.asarray(b)


@dataclasses.dataclass(frozen=True)
class FlowUniPCMultistep:
    """UniPC multistep predictor-corrector for flow matching, with the
    reference CFG pipeline's defaults: solver_order 2, predict_x0,
    solver_type "bh2", lower_order_final, final sigma 0."""

    sigmas: np.ndarray      # [N+1] descending, the last 0
    timesteps: np.ndarray   # [N]
    solver_order: int = 2
    solver_type: str = "bh2"

    @classmethod
    def create(cls, num_steps: int, shift: float = 5.0, solver_order: int = 2,
               solver_type: str = "bh2") -> "FlowUniPCMultistep":
        # linspace over [1 - 1/1000, 0), shifted, then a final sigma of 0
        sigmas = np.linspace(1.0 - 1.0 / 1000.0, 0.0, num_steps + 1)[:-1]
        sigmas = shift * sigmas / (1 + (shift - 1) * sigmas)
        timesteps = sigmas * 1000.0
        return cls(sigmas=np.concatenate([sigmas, [0.0]]), timesteps=timesteps,
                   solver_order=solver_order, solver_type=solver_type)

    def init_state(self, sample_shape, dtype: torch.dtype = torch.float32,
                   device="cpu") -> UniPCState:
        shape = tuple(sample_shape)
        return UniPCState(
            m_hist=torch.zeros((self.solver_order,) + shape, dtype=dtype, device=device),
            last_sample=torch.zeros(shape, dtype=dtype, device=device))

    def _lambda(self, i: int) -> float:
        s = float(self.sigmas[i])
        with np.errstate(divide="ignore"):
            return float(np.log(1.0 - s) - np.log(s))

    def _order_pred(self, i: int) -> int:
        # lower_order_final and the multistep warm-up
        return max(1, min(self.solver_order, len(self.timesteps) - i, i + 1))

    def _b_h(self, hh: float) -> float:
        return float(hh if self.solver_type == "bh1" else np.expm1(hh))

    def step(self, flow_pred: torch.Tensor, step_index: int, sample: torch.Tensor,
             state: UniPCState) -> Tuple[torch.Tensor, UniPCState]:
        """UniC, then UniP, at step_index."""
        i = int(step_index)
        x = sample.float()
        sigma_i = float(self.sigmas[i])
        # the flow prediction as an x0 prediction: x0 = x - s v
        m_t = x - sigma_i * flow_pred.float()
        hist = state.m_hist.float()

        # ---- corrector (UniC) on the incoming sample ----
        if i > 0:
            c_order = self._order_pred(i - 1)
            lam_s0 = self._lambda(i - 1)
            h = self._lambda(i) - lam_s0
            rks, d1s = [], []
            for j in range(1, c_order):
                rk = (self._lambda(i - (j + 1)) - lam_s0) / h
                rks.append(rk)
                d1s.append((hist[-(j + 1)] - hist[-1]) / rk)
            rks.append(1.0)
            hh = -h  # predict_x0
            if c_order == 1:
                rhos_c = np.asarray([0.5])
            else:
                R, b = _unipc_coeffs(hh, np.asarray(rks), c_order, self.solver_type)
                rhos_c = np.linalg.solve(R, b)
            alpha_t = 1.0 - sigma_i
            x_t_ = (sigma_i / float(self.sigmas[i - 1])) * state.last_sample.float() \
                - alpha_t * float(np.expm1(hh)) * hist[-1]
            corr_res = sum(float(rhos_c[j]) * d1s[j] for j in range(len(d1s))) if d1s else 0.0
            d1_t = m_t - hist[-1]
            x = x_t_ - alpha_t * self._b_h(hh) * (corr_res + float(rhos_c[-1]) * d1_t)

        # ---- push the history ----
        hist = torch.cat([hist[1:], m_t[None]], dim=0)

        # ---- predictor (UniP) ----
        p_order = self._order_pred(i)
        sigma_next = float(self.sigmas[i + 1])
        lam_i = self._lambda(i)
        h = self._lambda(i + 1) - lam_i
        rks, d1s = [], []
        for j in range(1, p_order):
            rk = (self._lambda(i - j) - lam_i) / h
            rks.append(rk)
            d1s.append((hist[-(j + 1)] - hist[-1]) / rk)
        hh = -h
        alpha_next = 1.0 - sigma_next
        if d1s:
            if p_order == 2:
                rhos_p = np.asarray([0.5])
            else:
                R, b = _unipc_coeffs(hh, np.asarray(rks + [1.0]), p_order,
                                     self.solver_type)
                rhos_p = np.linalg.solve(R[:-1, :-1], b[:-1])
            pred_res = sum(float(rhos_p[j]) * d1s[j] for j in range(len(d1s)))
        else:
            pred_res = 0.0
        ratio = (sigma_next / sigma_i) if sigma_i > 0 else 0.0
        x_next = ratio * x - alpha_next * float(np.expm1(hh)) * hist[-1] \
            - alpha_next * self._b_h(hh) * pred_res
        return x_next.to(sample.dtype), UniPCState(
            m_hist=hist.to(state.m_hist.dtype), last_sample=x.to(state.last_sample.dtype))
