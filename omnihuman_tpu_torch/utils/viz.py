"""Visual-debugging helpers (port of omnihuman_tpu/utils/viz.py).

`detailed_model_output_visualization`: target / output / |diff| heatmaps,
an error histogram and the error statistics (reference
seaweed_apt/helper.py:20-120). `VisualizationHook`: per-layer activation
capture through the DiT's `collect_layers` taps (models/wan_dit.py) and
plots of their statistics (reference graph.py:16-165, hooks replaced by
the taps, as in JAX).

matplotlib is imported only when a plot is drawn; without it the plotting
calls raise ImportError saying so.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from omnihuman_tpu_torch.utils.logging import logger


def pyplot():
    """matplotlib.pyplot on the Agg back end, or a clear ImportError."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("the visualisation helpers draw with matplotlib, "
                          "which is not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _np(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def detailed_model_output_visualization(
    target, output, save_path: str = "model_output_visualization.png",
    channel: int = 0, frame: int = 0,
) -> Dict[str, float]:
    """Target / output / |diff| heatmaps, error histogram and statistics
    (reference helper.py:20-120). Arrays or tensors [C, F, H, W] or
    [B, C, F, H, W] (the first sample is drawn)."""
    plt = pyplot()
    t, o = _np(target), _np(output)
    if t.ndim == 5:
        t, o = t[0], o[0]
    t2d, o2d = t[channel, frame], o[channel, frame]
    diff = np.abs(t2d - o2d)
    err = (t - o).ravel()
    rmse = float(np.sqrt(np.mean(err ** 2)))

    fig, axes = plt.subplots(2, 2, figsize=(11, 9))
    for ax, (img, title) in zip(
            axes.flat[:3],
            [(t2d, "target"), (o2d, "output"), (diff, "|target-output|")]):
        im = ax.imshow(img, cmap="viridis")
        ax.set_title(title)
        fig.colorbar(im, ax=ax, fraction=0.046)
    axes[1, 1].hist(err, bins=80, color="tab:red", alpha=0.7)
    axes[1, 1].set_title(f"error histogram (rmse={rmse:.4f})")
    fig.tight_layout()
    fig.savefig(save_path, dpi=110)
    plt.close(fig)

    stats = {
        "rmse": rmse,
        "mae": float(np.mean(np.abs(err))),
        "max_err": float(np.max(np.abs(err))),
        "target_std": float(t.std()),
        "output_std": float(o.std()),
    }
    logger.info(f"viz saved -> {save_path}; {stats}")
    return stats


class VisualizationHook:
    """Per-layer activation statistics and plots (reference
    graph.py:16-165), the activations from the DiT's `collect_layers`."""

    def __init__(self, output_dir: str = "viz"):
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)

    @torch.no_grad()
    def capture(self, model, x, t, context, *, seq_len, rope_sin, rope_cos,
                layers: Optional[Sequence[int]] = None, **kw
                ) -> Dict[int, np.ndarray]:
        """{layer: [B, seq_len, dim] fp32} of one forward of `model` (a
        WanModel; every layer unless `layers` names some)."""
        layers = tuple(layers if layers is not None
                       else range(model.cfg.num_layers))
        _, taps = model(x, t, context, seq_len=seq_len, rope_sin=rope_sin,
                        rope_cos=rope_cos, collect_layers=layers, **kw)
        return {k: _np(v) for k, v in taps.items()}

    def plot_layer_stats(self, taps: Dict[int, np.ndarray],
                         name: str = "layer_stats") -> str:
        plt = pyplot()
        idx = sorted(taps)
        means = [float(taps[i].mean()) for i in idx]
        stds = [float(taps[i].std()) for i in idx]
        norms = [float(np.linalg.norm(taps[i]) / taps[i].size ** 0.5)
                 for i in idx]

        fig, axes = plt.subplots(1, 3, figsize=(14, 4))
        for ax, (ys, title) in zip(axes, [(means, "mean"), (stds, "std"),
                                          (norms, "rms norm")]):
            ax.plot(idx, ys, marker="o")
            ax.set_xlabel("layer")
            ax.set_title(f"activation {title}")
        fig.tight_layout()
        path = os.path.join(self.output_dir, f"{name}.png")
        fig.savefig(path, dpi=110)
        plt.close(fig)
        return path

    def plot_attention_token_norm(self, taps: Dict[int, np.ndarray],
                                  layer: int,
                                  name: str = "token_norms") -> str:
        plt = pyplot()
        norms = np.linalg.norm(taps[layer][0], axis=-1)     # [S]
        fig, ax = plt.subplots(figsize=(10, 3))
        ax.plot(norms)
        ax.set_title(f"layer {layer} per-token activation norm")
        ax.set_xlabel("token")
        fig.tight_layout()
        path = os.path.join(self.output_dir, f"{name}_L{layer}.png")
        fig.savefig(path, dpi=110)
        plt.close(fig)
        return path
