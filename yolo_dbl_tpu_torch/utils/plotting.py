"""Training curves (port of `plot_results`, yolo_dbl_tpu/utils/plotting.py:90).

Best effort, as in the JAX facade: it needs matplotlib, which the caller
may lack, and the facade ignores its failures.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


def plot_results(history: List[Dict], save_path: Optional[str] = None):
    """One panel per numeric key of the per-epoch history (but `epoch` and
    `seconds`), saved to `save_path`."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    keys = [k for k in history[0] if isinstance(history[0][k], (int, float)) and k not in ("epoch", "seconds")]
    cols = min(len(keys), 4)
    rows = int(np.ceil(len(keys) / cols))
    fig, axes = plt.subplots(rows, cols, figsize=(4 * cols, 3 * rows), squeeze=False)
    for i, k in enumerate(keys):
        ax = axes[i // cols][i % cols]
        ax.plot([e.get(k, np.nan) for e in history])
        ax.set_title(k, fontsize=9)
        ax.grid(alpha=0.3)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=110)
        plt.close(fig)
    return fig
