"""Typed configuration for the pipeline, receiver, channel, and simulator.

Every hardcoded constant in the reference becomes a field with the
reference's value as default, so `ReceiverConfig()` reproduces the stock
ldpc_decoder_cb behavior exactly:

  method=0            make(int method), include/ldpc_ece535a/ldpc_decoder_cb.h:35
  iterations=5        lib/ldpc_decoder_cb_impl.cc:40
  error_threshold     M/8 (None -> derived), :141-142
  max_errors=10       :171
  code="block_32_64"  the hardcoded 32x64 H, :63-96

Configs round-trip YAML (`from_yaml`/`to_yaml`) and build the corresponding
runtime objects (`make_block`, etc.).

The counterpart of ``gr_ldpc_ece535a_tpu/utils/config.py``, with the same
fields, so a config that either package saved (``to_dict``/``to_yaml``)
loads in the other. ``make_block(device=...)`` builds the port's blocks on
``device`` (the card by default); ``SimConfig.run`` is the port's
``sim.run_waterfall``, whose ``device`` goes through ``kwargs``.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional, Sequence

__all__ = ["ReceiverConfig", "ChannelConfig", "SimConfig", "PipelineConfig"]


class _YamlMixin:
    @classmethod
    def from_dict(cls, d: dict):
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"{cls.__name__}: unknown keys {sorted(unknown)}")
        return cls(**d)

    @classmethod
    def from_yaml(cls, path: str | Path):
        import yaml
        return cls.from_dict(yaml.safe_load(Path(path).read_text()) or {})

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_yaml(self, path: str | Path) -> None:
        import yaml
        Path(path).write_text(yaml.safe_dump(self.to_dict(), sort_keys=False))


@dataclasses.dataclass
class ReceiverConfig(_YamlMixin):
    """Decoder block + frame-sync state machine parameters."""

    code: str = "block_32_64"
    method: int = 0                       # 0=LogDomain 1=SumProduct 2=BitFlip 3=Hard
    iterations: int = 5
    error_threshold: Optional[int] = None  # None -> M // 8
    max_errors: int = 10
    search_window: int = 1024             # batched symbol-slip width (ours)
    verbose: bool = True

    def make_block(self, device="cuda"):
        from ..blocks import LdpcDecoderBlock
        from ..codes import get_code
        return LdpcDecoderBlock(
            method=self.method, code=get_code(self.code),
            iterations=self.iterations, error_threshold=self.error_threshold,
            max_errors=self.max_errors, search_window=self.search_window,
            verbose=self.verbose, device=device)


@dataclasses.dataclass
class ChannelConfig(_YamlMixin):
    """AWGN / channel-model parameters (example4.grc slider conventions)."""

    ebn0_db: Optional[float] = None       # simulator-convention AWGN
    noise_voltage: float = 0.0            # GRC channel_model amplitude
    freq_offset: float = 0.0
    phase_offset: float = 0.0
    seed: int = 0

    def make_block(self, device="cuda"):
        from ..blocks import AwgnBlock, ChannelModelBlock
        if self.ebn0_db is not None:
            return AwgnBlock(self.ebn0_db, seed=self.seed)
        return ChannelModelBlock(
            noise_voltage=self.noise_voltage, freq_offset=self.freq_offset,
            phase_offset=self.phase_offset, seed=self.seed, device=device)


@dataclasses.dataclass
class SimConfig(_YamlMixin):
    """Waterfall sweep parameters (reference experiment defaults,
    apps/ldpc_lapack.cpp:540-543 — scaled up in frames_per_point)."""

    code: str = "sim_50_100"
    start_db: float = -7.0
    stop_db: float = 10.0
    step_db: float = 0.5
    frames_per_point: int = 30_000
    iterations: int = 5
    methods: Sequence[str] = ("hard", "bitflip", "minsum", "sumproduct")
    seed: int = 0

    def run(self, **kwargs):
        import numpy as np
        from ..sim import run_waterfall
        grid = np.arange(self.start_db, self.stop_db + self.step_db / 2,
                         self.step_db)
        return run_waterfall(
            code=self.code, ebn0_db=grid,
            frames_per_point=self.frames_per_point,
            iterations=self.iterations, methods=tuple(self.methods),
            seed=self.seed, **kwargs)


@dataclasses.dataclass
class PipelineConfig(_YamlMixin):
    """Top-level config: receiver + channel (nested dicts in YAML)."""

    receiver: dict = dataclasses.field(default_factory=dict)
    channel: dict = dataclasses.field(default_factory=dict)

    def receiver_config(self) -> ReceiverConfig:
        return ReceiverConfig.from_dict(self.receiver)

    def channel_config(self) -> ChannelConfig:
        return ChannelConfig.from_dict(self.channel)
