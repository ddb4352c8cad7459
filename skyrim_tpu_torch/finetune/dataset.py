"""Training dataset over the CDS dataset-factory layout (port of
skyrim_tpu/finetune/dataset.py).

Reads the per-slice NetCDFs and ``metadata.json`` that ``CDS.create_dataset``
writes (data/cds.py) and yields (x, y) training pairs as numpy arrays:
x = ``n_history`` consecutive frames, y = the next ``frames_out``.  The
index, the shuffled batch order for a given ``numpy.random.Generator`` and
the statistics are the JAX package's.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from skyrim_tpu_torch.io.netcdf import read_netcdf


class FineTuneDataset:
    def __init__(
        self,
        root: str | Path,
        n_history: int = 1,
        frames_out: int = 1,
        channels: list[str] | None = None,
    ):
        self.root = Path(root)
        meta_path = self.root / "metadata.json"
        if not meta_path.exists():
            raise FileNotFoundError(f"no metadata.json under {self.root}")
        self.meta = json.loads(meta_path.read_text())
        self.n_history = n_history
        self.frames_out = frames_out
        self.channels = channels or self.meta["channels"]
        # (file, start frame) of every window, slice by slice
        self._index: list[tuple[str, int]] = []
        self._cache: dict[str, np.ndarray] = {}
        window = n_history + frames_out
        for fname in self.meta["files"]:
            n_frames = self._load(fname).shape[0]
            for s in range(0, n_frames - window + 1):
                self._index.append((fname, s))

    def _load(self, fname: str) -> np.ndarray:
        """A slice's frames (time, channel, lat, lon) in ``channels``' order,
        float32, read once."""
        if fname not in self._cache:
            field = read_netcdf(self.root / fname).sel(channel=self.channels)
            self._cache[fname] = field.data.astype(np.float32)
        return self._cache[fname]

    def __len__(self) -> int:
        return len(self._index)

    def __getitem__(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        fname, s = self._index[i]
        data = self._load(fname)
        x = data[s : s + self.n_history]
        y = data[s + self.n_history : s + self.n_history + self.frames_out]
        return x, y

    def batches(self, batch_size: int, rng: np.random.Generator | None = None):
        """Shuffled minibatches → (B, hist, C, H, W), (B, out, C, H, W); a
        last partial batch is dropped."""
        order = np.arange(len(self))
        if rng is not None:
            rng.shuffle(order)
        for ofs in range(0, len(order) - batch_size + 1, batch_size):
            idx = order[ofs : ofs + batch_size]
            xs, ys = zip(*(self[i] for i in idx))
            yield np.stack(xs), np.stack(ys)

    def normalization_stats(self) -> tuple[np.ndarray, np.ndarray]:
        """Per-channel (mean, std) over every frame and point of every slice:
        the squares summed in float64, the variance clipped at 1e-12."""
        total, total2, count = 0.0, 0.0, 0
        for fname in self.meta["files"]:
            d = self._load(fname)
            total = total + d.sum(axis=(0, 2, 3))
            total2 = total2 + (d.astype(np.float64) ** 2).sum(axis=(0, 2, 3))
            count += d.shape[0] * d.shape[2] * d.shape[3]
        mean = total / count
        std = np.sqrt(np.maximum(total2 / count - mean**2, 1e-12))
        return mean.astype(np.float32), std.astype(np.float32)
