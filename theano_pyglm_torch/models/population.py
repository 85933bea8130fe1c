"""Population model — N coupled GLMs plus a network prior.

Port of :mod:`theano_pyglm_tpu.models.population`. One function

    log_joint(params, data) = Σ_n LL_n(params, data) + Σ_components log-prior

evaluated for all N neurons at once: the per-neuron likelihood factorizes,
so the population's currents are batched matmuls. ``prepare_data`` builds
the design tensors once; ``simulate`` generates spikes with a Python loop
over time on the population's device.

The exp-Poisson likelihood in float32 goes through the fused Poisson
log-likelihood op (ops/kernels.py): on a CUDA device its value+grad runs the
hand-written kernel K2 and a value-only evaluation (under ``torch.no_grad``)
runs K1. ``use_fused=False`` selects the plain per-neuron torch path.

Long recordings: with ``time_chunk`` the likelihood is a sum over time
blocks of that many bins (the last one ragged). With
``prepare_data(materialize_design=False)`` the (T, N, B) spike design is
never built: each block rebuilds its own from the spikes with the exact
L-bin causal halo. The plain path checkpoints each block
(``torch.utils.checkpoint``), so its backward pass holds one block at a
time. The fused path launches one kernel per block per evaluation (the JAX
package skips its fused op under chunking); K2 keeps no design for the
backward pass, so a rebuilt block's design is freed once its launch
returns.
"""

from __future__ import annotations

import copy
from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from theano_pyglm_torch.models.components import (
    combined_weights,
    make_bias,
    make_bkgd,
    make_impulse,
    make_nlin,
    make_observation,
)
from theano_pyglm_torch.models.network import make_graph, make_weights
from theano_pyglm_torch.models.spec import validate_spec
from theano_pyglm_torch.ops.basis import create_basis
from theano_pyglm_torch.ops.convolve import convolve_with_basis, upsample_stim
from theano_pyglm_torch.ops.kernels import fused_poisson_ll
from theano_pyglm_torch.utils.dtypes import default_float

__all__ = ["Population"]

_TIME_KEYS = ("X_imp", "X_stim", "X_st")  # data entries with a leading time axis besides S


class Population:
    """A population of N coupled GLMs, built from a nested-dict model spec
    (see :mod:`theano_pyglm_torch.models.zoo` for templates).

    The instance holds only static structure (spec, bases, component
    records) plus the ``device`` and ``dtype`` its tensors live in; all state
    lives in the params dict and the data dict.
    """

    def __init__(
        self,
        spec: dict,
        use_fused: bool = True,
        time_chunk: Optional[int] = None,
        device=None,
        dtype: Optional[torch.dtype] = None,
    ):
        """``use_fused``: evaluate the exp-Poisson likelihood in float32
        through the fused op (the hand-written kernels on a CUDA device, their
        plain torch version on the CPU). ``time_chunk``: evaluate the
        likelihood in time blocks of this many bins (see the module note);
        with ``prepare_data(materialize_design=False)`` memory is bounded by
        the block instead of T·N·B. ``device`` defaults to the current CUDA
        device; pass ``device="cpu"`` for the CPU."""
        validate_spec(spec)
        self.spec = copy.deepcopy(spec)
        self.N = int(spec["N"])
        self.dt = float(spec.get("dt", 1e-3))
        self.use_fused = bool(use_fused)
        self.time_chunk = int(time_chunk) if time_chunk else None
        # the card unless the caller asks for the CPU; no check, no fall-back
        self.device = torch.device(device if device is not None else "cuda")
        self.dtype = dtype if dtype is not None else default_float()

        # -- bases (numpy, built once)
        imp_spec = dict(spec.get("impulse", {"type": "basis"}))
        imp_basis_spec = dict(imp_spec.get("basis", {"type": "cosine", "n_bas": 5}))
        imp_basis_spec.setdefault("dt", self.dt)
        imp_basis_spec.setdefault("dt_max", imp_spec.get("dt_max", 0.1))
        self.basis_imp = np.asarray(create_basis(imp_basis_spec))
        self.B_imp = self.basis_imp.shape[1]
        self.L_imp = self.basis_imp.shape[0]

        bkgd_spec = dict(spec.get("bkgd", {"type": "none"}))
        self.D_stim = int(bkgd_spec.get("D_stim", 1))
        if bkgd_spec.get("type", "none") != "none":
            stim_basis_spec = dict(bkgd_spec.get("basis", {"type": "cosine", "n_bas": 5}))
            stim_basis_spec.setdefault("dt", self.dt)
            stim_basis_spec.setdefault("dt_max", bkgd_spec.get("dt_max", 0.3))
            self.basis_stim = np.asarray(create_basis(stim_basis_spec))
            self.B_stim = self.basis_stim.shape[1]
        else:
            self.basis_stim = None
            self.B_stim = 0

        # -- components
        N = self.N
        self.bias = make_bias(dict(spec.get("bias", {})), N)
        self.bkgd = make_bkgd(bkgd_spec, N, self.B_stim, self.D_stim)
        self.impulse = make_impulse(imp_spec, N, self.B_imp)
        self.nlin = make_nlin(dict(spec.get("nlin", {"type": "exp"})))
        self.observation = make_observation(dict(spec.get("observation", {"type": "poisson"})))
        net_spec = dict(spec.get("network", {}))
        self.graph = make_graph(dict(net_spec.get("graph", {"type": "complete"})), N)
        self.weights = make_weights(dict(net_spec.get("weight", {"type": "constant"})), N)

        self._current_components = [self.bias, self.bkgd, self.impulse]
        self._prior_components = [self.bias, self.bkgd, self.impulse]

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device).to(self.dtype)

    # --- parameters -------------------------------------------------------

    def sample(self, generator: torch.Generator) -> dict:
        """Draw a full parameter dict from the prior.

        Draws happen on the generator's device, in the population's dtype,
        and land on the population's device: a CPU generator gives the same
        parameters for a CPU and a CUDA population.
        """
        params: dict = {}
        for comp in self._prior_components + [self.graph, self.weights]:
            params.update(comp.sample(generator, self.dtype))
        return {k: v.to(self.device) for k, v in params.items()}

    def coupling(self, params) -> torch.Tensor:
        """Effective coupling G = A ∘ W, shape (N_post, N_pre)."""
        return params["A"] * self.weights.effective_W(params)

    # --- data -------------------------------------------------------------

    def prepare_data(
        self,
        S,
        stim=None,
        stim_dt: Optional[float] = None,
        materialize_design: bool = True,
    ) -> dict:
        """Precompute the design tensors.

        Args:
          S: (T, N) spike counts (float or int, array or tensor).
          stim: optional (T_stim, D) stimulus at interval ``stim_dt``
                (defaults to the bin width ``dt``).
          materialize_design: build X_imp (T,N,B) up front (default). With
                False only the spikes are kept (no 'X_imp', no centering) and
                the likelihood rebuilds each time block's design from them;
                it needs ``time_chunk`` on the Population.
        Returns:
          data dict on the population's device and dtype with 'S' (T,N),
          '_neg_log_S_factorial', 'X_imp' (T,N,B_imp) centered by column with
          its means in '_X_imp_mean' (N,B_imp) and, if the model has a
          stimulus component, 'X_stim' (T, D·B_stim) or 'X_st' (T,D,B_stim).
        """
        S = self._tensor(S)
        T = S.shape[0]
        data = {
            "S": S,
            # Poisson normalizer Σ log S!, constant in the params: folded in
            # once here so the fused likelihood path skips the (T, N) pass.
            "_neg_log_S_factorial": -torch.lgamma(S + 1.0).sum(),
        }
        if materialize_design:
            X_imp = convolve_with_basis(S, self._tensor(self.basis_imp))
            # Center the spike design columns (an exact reparameterization:
            # the column means re-enter the currents as a per-pair constant).
            # This removes the dominant correlation between every coupling
            # weight and the bias, which conditions both L-BFGS and HMC.
            X_mean = X_imp.mean(0)  # (N_pre, B)
            data["X_imp"] = X_imp - X_mean[None]
            data["_X_imp_mean"] = X_mean
        if self.basis_stim is not None:
            if stim is None:
                raise ValueError("model has a stimulus component but no stim given")
            data.update(self._stim_design(stim, stim_dt, T))
        return data

    def _stim_design(self, stim, stim_dt, T) -> dict:
        stim = self._tensor(stim)
        if stim.ndim == 1:
            stim = stim[:, None]
        if stim_dt is not None and stim_dt != self.dt:
            stim = upsample_stim(stim, stim_dt, self.dt, T)
        X = convolve_with_basis(stim[:T], self._tensor(self.basis_stim))  # (T, D, Bs)
        if self.spec["bkgd"]["type"] == "spatiotemporal":
            return {"X_st": X}
        return {"X_stim": X.reshape(T, -1)}

    # --- densities ---------------------------------------------------------

    def currents(self, params, data) -> dict:
        """Per-component additive currents, each (T, N)."""
        d = dict(data)
        d["_G"] = self.coupling(params)
        return {c.name: c.current(params, d) for c in self._current_components}

    def total_current(self, params, data) -> torch.Tensor:
        d = dict(data)
        d["_G"] = self.coupling(params)
        I = torch.zeros_like(data["S"])
        for c in self._current_components:
            I = I + c.current(params, d)
        return I

    def _chunked(self, data) -> bool:
        """The likelihood runs in time blocks: ``time_chunk`` set and
        shorter than the recording. Otherwise it needs the materialized
        design."""
        if self.time_chunk is not None and data["S"].shape[0] > self.time_chunk:
            return True
        if "X_imp" not in data:
            raise ValueError(
                "data was prepared with materialize_design=False; build the "
                "Population with time_chunk=<bins> so the likelihood can "
                "stream the design per time block"
            )
        return False

    def _block(self, data, t0: int) -> dict:
        """The data dict of the time block that starts at bin ``t0``: its
        rows of S and of the time-indexed designs, and the rest of ``data``
        as it is. Without X_imp the block's design is rebuilt from spike rows
        [t0 − L, t1) (zeros before t = 0): the exact history of a strictly
        causal L-lag convolution, cut to the block's rows."""
        S = data["S"]
        T, N = S.shape
        L, t1 = self.L_imp, min(t0 + self.time_chunk, T)
        d = {k: v for k, v in data.items() if k not in _TIME_KEYS}
        d["S"] = S[t0:t1]
        for k in _TIME_KEYS:
            if k in data:
                d[k] = data[k][t0:t1]
        if "X_imp" not in data:
            lo = max(t0 - L, 0)
            halo = torch.cat([S.new_zeros((L - (t0 - lo), N)), S[lo:t1]])
            d["X_imp"] = convolve_with_basis(halo, self._tensor(self.basis_imp))[L:]
        return d

    def log_likelihood_per_neuron(self, params, data) -> torch.Tensor:
        """(N,) spike log-likelihood per postsynaptic neuron (factorizes)."""
        if self._chunked(data):
            return self._ll_per_neuron_chunked(params, data)
        I = self.total_current(params, data)
        ll = self.observation.log_likelihood(data["S"], I, self.nlin, self.dt)
        return ll.sum(0)

    def _ll_per_neuron_chunked(self, params, data) -> torch.Tensor:
        """(N,) log-likelihood as a sum over time blocks (the JAX package's
        ``lax.map`` over blocks under ``jax.checkpoint``). Each block's
        forward runs again in the backward pass, so neither holds more than
        one block's design and currents."""
        G = self.coupling(params)

        def block_ll(t0):
            # the design is rebuilt inside, so the checkpoint keeps none
            d = self._block(data, t0)
            d["_G"] = G
            I = torch.zeros_like(d["S"])
            for c in self._current_components:
                I = I + c.current(params, d)
            return self.observation.log_likelihood(d["S"], I, self.nlin, self.dt).sum(0)

        total = 0.0
        for t0 in range(0, data["S"].shape[0], self.time_chunk):
            if torch.is_grad_enabled():
                total = total + checkpoint(block_ll, t0, use_reentrant=False)
            else:
                total = total + block_ll(t0)
        return total

    def _fused_active(self, data) -> bool:
        """The fused path: exp-Poisson, float32, opted in. Float64 (CPU
        verification) runs the plain per-neuron path."""
        return (
            self.use_fused
            and self.nlin.name == "exp"
            and self.observation.name == "poisson"
            and data["S"].dtype == torch.float32
        )

    def log_likelihood(self, params, data) -> torch.Tensor:
        if not self._fused_active(data):
            return self.log_likelihood_per_neuron(params, data).sum()
        U = combined_weights(self.impulse.effective(params), self.coupling(params))
        mean = data.get("_X_imp_mean")
        offset = None if mean is None else (mean.reshape(-1) @ U)[None, :]
        starts = range(0, data["S"].shape[0], self.time_chunk) if self._chunked(data) else (None,)
        ll = 0.0
        for t0 in starts:
            # one kernel launch per block: the block's design, rebuilt or a
            # slice, is dropped once the launch returns (K2 keeps dU and
            # dI_rest for the backward pass, not X_f)
            d = data if t0 is None else self._block(data, t0)
            X_f = d["X_imp"].reshape(d["S"].shape[0], self.N * self.B_imp)
            I_rest = self.bias.current(params, d) + self.bkgd.current(params, d)
            if offset is not None:
                I_rest = I_rest + offset
            ll = ll + fused_poisson_ll(X_f, U, I_rest, d["S"], self.dt)
            del d, X_f
        const = data.get("_neg_log_S_factorial")
        if const is None:
            const = -torch.lgamma(data["S"] + 1.0).sum()
        return ll + const

    def log_prior(self, params) -> torch.Tensor:
        lp = 0.0
        for comp in self._prior_components + [self.graph, self.weights]:
            lp = lp + comp.log_prior(params)
        return lp

    def log_joint(self, params, data) -> torch.Tensor:
        return self.log_likelihood(params, data) + self.log_prior(params)

    # --- simulation ---------------------------------------------------------

    def effective_filters(self, params) -> torch.Tensor:
        """(N_post, N_pre, L) coupling filters h = G ∘ (w_eff · basisᵀ)."""
        w_eff = self.impulse.effective(params)  # (N, N, B)
        h = torch.einsum("npb,lb->npl", w_eff, self._tensor(self.basis_imp))
        return h * self.coupling(params)[:, :, None]

    @torch.no_grad()
    def simulate(
        self,
        generator: torch.Generator,
        params,
        T: int,
        stim=None,
        stim_dt: Optional[float] = None,
        rate_max: float = 1e4,
    ):
        """Forward-generate spikes for T bins.

        A Python loop over time on the population's device. Each step
        contracts an (L, N) buffer of the last L bins of spikes with the
        effective (N, N, L) filters — the strictly-causal counterpart of
        :func:`ops.convolve.convolve_with_basis` — clips the rate at
        ``rate_max`` (spikes/s) to keep runaway self-excitation finite, and
        draws the bin's spikes with ``generator``, which must live on the
        population's device.

        Returns:
          (S, rates): spike counts (T, N) and rates λ in spikes/s (T, N).
        """
        if self.basis_stim is not None and stim is None:
            raise ValueError("model has a stimulus component but no stim given")
        N, L = self.N, self.L_imp
        I_base = params["bias"][None, :].expand(T, N)
        if self.basis_stim is not None:
            fake = {"S": I_base}
            fake.update(self._stim_design(stim, stim_dt, T))
            I_base = I_base + self.bkgd.current(params, fake)

        # The buffer is an (L, N) window of a zero-padded spike record:
        # rows t .. t+L-1 of S_pad hold bins t-L .. t-1, so buffer row j is
        # lag L-j. H[(j, p), n] = h[n, p, L-1-j] turns the contraction into
        # one (L·N) @ (L·N, N) product per step.
        h = self.effective_filters(params)
        H = torch.flip(h, dims=(2,)).permute(2, 1, 0).reshape(L * N, N)
        S_pad = torch.zeros((T + L, N), dtype=self.dtype, device=self.device)
        rates = torch.empty((T, N), dtype=self.dtype, device=self.device)
        for t in range(T):
            I = I_base[t] + S_pad[t : t + L].reshape(-1) @ H
            rate = torch.clamp(self.nlin.rate(I), 0.0, rate_max)
            S_pad[t + L] = self.observation.sample(generator, rate, self.dt)
            rates[t] = rate
        return S_pad[L:], rates
