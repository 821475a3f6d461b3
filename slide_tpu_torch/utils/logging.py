"""Scalar logging (counterpart: `slide_tpu/utils/logging.py`): scalars
stream to a JSONL file, one {"tag", "step", "value", "time"} per line, with
an optional matplotlib curve; `AverageMeter` keeps a running mean."""

from __future__ import annotations

import json
import os
import time


class AverageMeter:
    """The last value, the sum, the count and the mean of what it is given;
    optionally logs each value."""

    def __init__(self, name: str = "", world_size: int = 1):
        self.name = name
        self.world_size = world_size
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1, logger: "ScalarLogger | None" = None,
               global_step: int | None = None):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count
        if logger is not None:
            logger.scalar(self.name, val, global_step)


class ScalarLogger:
    """Appends scalars to `<log_dir>/<filename>`."""

    def __init__(self, log_dir: str, filename: str = "scalars.jsonl"):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, filename)
        self._fh = open(self.path, "a")

    def scalar(self, tag: str, value, step=None):
        self._fh.write(json.dumps({"tag": tag, "step": step, "value": float(value),
                                   "time": time.time()}) + "\n")
        self._fh.flush()

    def close(self):
        self._fh.close()

    def plot(self, tag: str, out_png: str | None = None) -> str:
        """The curve of `tag` as a PNG; matplotlib is imported here."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        steps, vals = [], []
        with open(self.path) as f:
            for line in f:
                rec = json.loads(line)
                if rec["tag"] == tag:
                    steps.append(rec["step"])
                    vals.append(rec["value"])
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.plot(steps, vals)
        ax.set_xlabel("step")
        ax.set_ylabel(tag)
        out_png = out_png or self.path.replace(".jsonl", f"_{tag}.png")
        fig.tight_layout()
        fig.savefig(out_png, dpi=100)
        plt.close(fig)
        return out_png
