"""Recompute-Offload-Keep (ROK) curve (paper §4.3, Fig. 11), a copy of
the JAX package's `repro/core/rok.py` (which imports nothing of JAX; the
port keeps its own copy).

Each training run is a point: x = activations memory peak, y = model
throughput. Model throughput is the paper's definition (Megatron [77]):
the *algorithmic* FLOPs of the training step — independent of whether
activations were recomputed — divided by the measured step time.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass
from typing import Dict, List, Sequence


@dataclass(frozen=True)
class RokPoint:
    strategy: str            # "keep" | "offload" | "recompute"
    batch_size: int
    peak_activation_bytes: int
    step_time_s: float
    model_flops: float       # algorithmic FLOPs per step (6*N*tokens)

    @property
    def throughput_flops_per_s(self) -> float:
        return self.model_flops / self.step_time_s

    def as_dict(self) -> Dict:
        d = asdict(self)
        d["throughput_flops_per_s"] = self.throughput_flops_per_s
        return d


def model_flops_per_step(n_params: int, tokens: int) -> float:
    """6ND — forward (2ND) + backward (4ND), recompute NOT counted
    (model throughput is hardware/software-agnostic, §4.3)."""
    return 6.0 * float(n_params) * float(tokens)


def dominates(a: RokPoint, b: RokPoint) -> bool:
    """a dominates b: no more memory AND no less throughput."""
    return (a.peak_activation_bytes <= b.peak_activation_bytes
            and a.throughput_flops_per_s >= b.throughput_flops_per_s
            and (a.peak_activation_bytes < b.peak_activation_bytes
                 or a.throughput_flops_per_s > b.throughput_flops_per_s))


def pareto_front(points: Sequence[RokPoint]) -> List[RokPoint]:
    front = [p for p in points
             if not any(dominates(q, p) for q in points if q is not p)]
    return sorted(front, key=lambda p: p.peak_activation_bytes)


def save_curve(points: Sequence[RokPoint], path: str) -> None:
    with open(path, "w") as f:
        json.dump([p.as_dict() for p in points], f, indent=1)


def load_curve(path: str) -> List[RokPoint]:
    with open(path) as f:
        raw = json.load(f)
    return [RokPoint(r["strategy"], r["batch_size"],
                     r["peak_activation_bytes"], r["step_time_s"],
                     r["model_flops"]) for r in raw]
