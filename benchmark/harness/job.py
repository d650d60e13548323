"""What one run of one cell is given, and the program's config built from it."""

from __future__ import annotations

import dataclasses
import gc
import sys
import time
from dataclasses import dataclass, field

import torch

from harness.manifest import Cell


@dataclass
class Job:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    config: dict = field(default_factory=dict)   # the configuration
    traffic: dict = field(default_factory=dict)  # the traffic mix
    _mark: float = field(default_factory=time.perf_counter)

    @classmethod
    def of(cls, cell: Cell, seed: int, seconds: float, trace: bool, device) -> "Job":
        return cls(cell, seed, seconds, trace, torch.device(device), dict(cell.config),
                   dict(cell.traffic))

    def program_config(self):
        """The program's ``ExperimentConfig`` of the configuration, with the
        run's seed (which seeds the training step's per-step draws)."""
        from spatiotemporal_variable_separation_tpu_torch.core.config import ExperimentConfig

        names = {f.name for f in dataclasses.fields(ExperimentConfig)}
        kw = {k: v for k, v in self.config.items() if k in names}
        return ExperimentConfig(**{**kw, "seed": self.seed}).validate()

    def stage(self, name: str) -> None:
        """Print the seconds since the last stage (a set-up breakdown)."""
        self.sync()
        now = time.perf_counter()
        print(f"set-up {name}: {now - self._mark:.3f} s", file=sys.stderr)
        self._mark = now

    def weights(self) -> dict:
        """The run's weights, drawn from its seed on its device."""
        from reference.data import derive
        from reference.params import make_weights, spec

        return make_weights(spec(self.config), derive(self.seed, "weights"), self.device)

    def free(self) -> None:
        """Return what was freed to the device."""
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
