#!/usr/bin/env python3
"""The flagship's posterior figures from its saved draws, on the PyTorch
port: the counterpart of ``scripts/flagship_figures.py``.

Reads ``flagship_samples.npz`` (written by
``theano_pyglm_torch.scripts.rgc_flagship``) and writes to
``<resultsDir>/figures/``:

- ``network_posterior.png``: the true A∘W, the posterior-mean coupling and
  the edge posterior P(A_ij | data);
- ``latent_locations.png``: posterior draws of the latent locations, each
  aligned to the generating locations by the orthogonal Procrustes
  solution (``plotting.procrustes_align``: the distance posterior is
  invariant under rotations and reflections, which the sampler mixes),
  against the generating configuration.

  python3 -m theano_pyglm_torch.scripts.flagship_figures [-r results/rgc_flagship_torch] [--n_loc_draws 200]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from theano_pyglm_torch.plotting import plot_network, procrustes_align

__all__ = ["main"]


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--resultsDir", "-r", type=str, default="results/rgc_flagship_torch")
    p.add_argument("--n_loc_draws", type=int, default=200,
                   help="posterior location draws to scatter (thinned evenly)")
    args = p.parse_args(argv)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with np.load(os.path.join(args.resultsDir, "flagship_samples.npz")) as z:
        A, W, locs = z["samples/A"], z["samples/W"], z["samples/locs"]  # (n, C, N, N), (n, C, N, D)
        A_true, W_true, locs_true = z["true_params/A"], z["true_params/W"], z["true_params/locs"]
    figdir = os.path.join(args.resultsDir, "figures")
    os.makedirs(figdir, exist_ok=True)
    written = []

    # network recovery
    fig, axes = plt.subplots(1, 3, figsize=(13, 4))
    plot_network(axes[0], A_true * W_true, "true A∘W")
    plot_network(axes[1], (A * W).mean(axis=(0, 1)), "posterior mean A∘W")
    im = axes[2].imshow(A.mean(axis=(0, 1)), cmap="viridis", vmin=0, vmax=1)
    axes[2].set_title("edge posterior P(A|data)")
    axes[2].set_xlabel("presynaptic")
    axes[2].set_ylabel("postsynaptic")
    fig.colorbar(im, ax=axes[2], fraction=0.046)
    fig.tight_layout()
    written.append(os.path.join(figdir, "network_posterior.png"))
    fig.savefig(written[-1], dpi=110)
    plt.close(fig)

    # latent locations, every draw aligned to the truth
    n, C, N, D = locs.shape
    draws = locs.reshape(n * C, N, D)[:: max(1, (n * C) // args.n_loc_draws)]
    aligned = np.stack([procrustes_align(x, locs_true) for x in draws])
    fig, ax = plt.subplots(figsize=(6, 6))
    colors = plt.cm.tab20(np.arange(N) % 20)
    for i in range(N):
        ax.scatter(aligned[:, i, 0], aligned[:, i, 1], s=5, alpha=0.25, color=colors[i], linewidths=0)
    ax.scatter(locs_true[:, 0], locs_true[:, 1], s=90, marker="x", color="black", label="true", zorder=3)
    ax.set_title(f"latent-location posterior ({aligned.shape[0]} draws, Procrustes-aligned to truth)")
    ax.set_aspect("equal")
    ax.legend(loc="upper right")
    fig.tight_layout()
    written.append(os.path.join(figdir, "latent_locations.png"))
    fig.savefig(written[-1], dpi=110)
    plt.close(fig)
    print(f"wrote {written[0]} and {written[1]}")
    return written


if __name__ == "__main__":
    main()
