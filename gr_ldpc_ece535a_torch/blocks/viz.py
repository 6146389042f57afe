"""Headless visualization sinks: the analog of the Qt GUI sinks.

The port's numpy and matplotlib copy of ``gr_ldpc_ece535a_tpu/blocks/viz.py``
(matplotlib is imported when a plot renders, not before). Where matplotlib
is not installed, the sink renders nothing: it says so once and the
flowgraph runs on (the JAX sink raises ImportError there).

The reference's example flowgraphs observe the live signal through GNU Radio
Qt GUI sinks — time, histogram, constellation, and frequency displays
(examples/example1.grc, example4.grc: qtgui histogram/time sinks fed through
uchar_to_float; SURVEY.md section 5 "Visual observability via Qt GUI
sinks"). A GUI event loop has no place in a headless pipeline, so the
equivalent here is a sink that buffers a window of the stream and renders
the same four views to a PNG when the flowgraph stops (or every
``refresh_items`` items, for long-running receive chains).

Rendering follows restrained instrument-display conventions: one axis per
figure, a single recessive data hue, neutral ink for all text, and a light
dotted grid behind the marks.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

from .base import Block

__all__ = ["PlotSink"]

# Single-series instrument styling: one data hue, neutral ink/grid.
_DATA = "#3d6ce0"
_INK = "#3a3a3a"
_GRID = "#d5d5d5"

_KINDS = ("time", "histogram", "const", "freq")


def _style(ax, title: str, xlabel: str, ylabel: str) -> None:
    ax.set_title(title, color=_INK, fontsize=11)
    ax.set_xlabel(xlabel, color=_INK, fontsize=9)
    ax.set_ylabel(ylabel, color=_INK, fontsize=9)
    ax.tick_params(colors=_INK, labelsize=8)
    ax.grid(True, linestyle=":", linewidth=0.6, color=_GRID)
    for side in ("top", "right"):
        ax.spines[side].set_visible(False)
    for side in ("left", "bottom"):
        ax.spines[side].set_color(_GRID)


class PlotSink(Block):
    """Render a window of the stream to a PNG file.

    kind: "time" (amplitude vs item index; real+imag traces for complex
    input), "histogram" (value distribution, like the reference example1's
    Qt histogram sinks), "const" (I/Q scatter, the constellation view), or
    "freq" (averaged periodogram power spectrum).

    dtype selects the input port type (complex64 for symbol taps, uint8 for
    byte taps — the reference feeds bytes through uchar_to_float first; this
    sink converts internally). The newest ``max_items`` items are kept, so a
    long run plots its tail window, matching the scope-like behavior of the
    GUI sinks.
    """

    out_dtype = None
    name = "plot_sink"

    def __init__(self, path: str = "plot.png", kind: str = "time",
                 dtype=np.complex64, max_items: int = 8192,
                 bins: int = 100, fft_size: int = 1024,
                 samp_rate: float = 1.0,
                 refresh_items: Optional[int] = None) -> None:
        super().__init__()
        if kind not in _KINDS:
            raise ValueError(f"unknown plot kind {kind!r}; use one of {_KINDS}")
        self.in_dtype = np.dtype(dtype)
        self.path = Path(path)
        self.kind = kind
        self.max_items = int(max_items)
        self.bins = int(bins)
        self.fft_size = int(fft_size)
        self.samp_rate = float(samp_rate)
        self.refresh_items = refresh_items
        self.n_renders = 0
        self.skipped = False     # a render was skipped: no matplotlib
        self._buf = np.empty(0, self.in_dtype)
        self._since_render = 0

    def work(self, data):
        n = len(data)
        self._buf = np.concatenate([self._buf, np.asarray(data, self.in_dtype)])
        if len(self._buf) > self.max_items:
            self._buf = self._buf[-self.max_items:]
        self._since_render += n
        if self.refresh_items and self._since_render >= self.refresh_items:
            self._since_render = 0
            self.render()
        return n, None

    def stop(self) -> None:
        if len(self._buf):
            self.render()

    # -- rendering ---------------------------------------------------------

    def _values(self) -> np.ndarray:
        x = self._buf
        if np.issubdtype(self.in_dtype, np.complexfloating):
            return x
        return x.astype(np.float32)

    def render(self) -> Optional[Path]:
        try:
            import matplotlib
        except ImportError:
            if not self.skipped:
                print(f"{self.name}: matplotlib is not installed; "
                      f"{self.path} is not rendered")
            self.skipped = True
            return None
        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        x = self._values()
        fig, ax = plt.subplots(figsize=(6.4, 4.0), dpi=110)
        try:
            getattr(self, f"_plot_{self.kind}")(ax, x)
            fig.tight_layout()
            self.path.parent.mkdir(parents=True, exist_ok=True)
            fig.savefig(self.path, facecolor="white")
        finally:
            plt.close(fig)
        self.n_renders += 1
        return self.path

    def _plot_time(self, ax, x) -> None:
        n = min(len(x), 2048)
        t = np.arange(n)
        if np.iscomplexobj(x):
            ax.plot(t, x[-n:].real, color=_DATA, linewidth=1.0, label="re")
            ax.plot(t, x[-n:].imag, color="#c2643c", linewidth=1.0,
                    label="im")
            ax.legend(frameon=False, fontsize=8, labelcolor=_INK)
        else:
            ax.plot(t, x[-n:], color=_DATA, linewidth=1.0)
        _style(ax, "time", "item", "amplitude")

    def _plot_histogram(self, ax, x) -> None:
        v = np.concatenate([x.real, x.imag]) if np.iscomplexobj(x) else x
        ax.hist(v, bins=self.bins, color=_DATA, edgecolor="white",
                linewidth=0.3)
        _style(ax, "histogram", "value", "count")

    def _plot_const(self, ax, x) -> None:
        v = x if np.iscomplexobj(x) else x.astype(np.complex64)
        n = min(len(v), 4096)
        ax.scatter(v[-n:].real, v[-n:].imag, s=9, color=_DATA, alpha=0.5,
                   linewidths=0)
        ax.set_aspect("equal", adjustable="datalim")
        _style(ax, "constellation", "I", "Q")

    def _plot_freq(self, ax, x) -> None:
        nfft = min(self.fft_size, max(8, len(x)))
        v = x.astype(np.complex64)
        if len(v) < nfft:  # nfft is floored at 8; zero-pad tiny buffers
            v = np.pad(v, (0, nfft - len(v)))
        nseg = max(1, len(v) // nfft)
        segs = v[: nseg * nfft].reshape(nseg, nfft)
        win = np.hanning(nfft).astype(np.float32)
        spec = np.fft.fftshift(np.fft.fft(segs * win, axis=1), axes=1)
        psd = (np.abs(spec) ** 2).mean(0) / (np.sum(win**2) * self.samp_rate)
        freqs = np.fft.fftshift(np.fft.fftfreq(nfft, d=1.0 / self.samp_rate))
        ax.plot(freqs, 10.0 * np.log10(psd + 1e-20), color=_DATA,
                linewidth=1.0)
        _style(ax, "power spectrum", "frequency", "dB")
