"""The port's held-out predictive log-likelihood
(theano_pyglm_torch/inference/predictive.py) against the JAX package, on
the CPU."""

import numpy as np
import torch

import theano_pyglm_torch as pt
import theano_pyglm_tpu as tpu
from theano_pyglm_torch.inference import predictive as pred_t
from theano_pyglm_torch.inference.mcmc import gibbs_sample
from theano_pyglm_tpu.inference import predictive as pred_j
from torch_parity import build_pair_light, rel_err


def test_predictive_log_likelihood_matches_jax():
    """The same stack of 7 prior draws on the same held-out data: 1e-10 in
    float64, whatever the batch; the MAP form is the log-likelihood."""
    spec = tpu.make_model("sparse_weighted_model", 3)
    pop_j, pop_t, p_j, p_t, d_j, d_t = build_pair_light(spec, T=200)
    draws = [pop_t.sample(torch.Generator().manual_seed(s)) for s in range(7)]
    stack = {k: np.stack([d[k].numpy() for d in draws]) for k in draws[0]}
    want = float(pred_j.predictive_log_likelihood(pop_j, stack, d_j))
    for batch in (32, 3, 1):
        got = pred_t.predictive_log_likelihood(pop_t, stack, d_t, batch=batch)
        assert got.ndim == 0 and rel_err(got, want) < 1e-10, batch
    assert rel_err(pred_t.map_heldout_log_likelihood(pop_t, p_t, d_t),
                   pred_j.map_heldout_log_likelihood(pop_j, p_j, d_j)) < 1e-10


def test_predictive_beats_a_prior_draw():
    """Mirrors the JAX package's test: posterior draws of a sampler run on
    the first 300 bins predict the last 100 better than a prior draw, in
    float32 through the fused path's plain version."""
    spec = tpu.make_model("sparse_weighted_model", 2, bkgd={"type": "none"})
    pop = pt.Population(spec, device="cpu")
    true = pop.sample(torch.Generator().manual_seed(0))
    S, _ = pop.simulate(torch.Generator().manual_seed(1), true, 400)
    d_tr, d_ho = pop.prepare_data(S[:300]), pop.prepare_data(S[300:])
    samples, _, _ = gibbs_sample(pop, d_tr, torch.Generator().manual_seed(2), n_samples=20, n_warmup=20,
                                 n_leapfrog=3, chunk_size=20)
    pll = float(pred_t.predictive_log_likelihood(pop, samples, d_ho))
    rand = float(pop.log_likelihood(pop.sample(torch.Generator().manual_seed(99)), d_ho))
    assert np.isfinite(pll) and pll > rand - 50.0
