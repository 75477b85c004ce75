"""Step builders of the jit engine, after the JAX package's
`repro/launch/steps.py` (`make_host_train_step`,
`make_overlap_train_step`; no mesh). Each returns what `TrainLoop`
drives: `(params, opt_state, batches) -> (params, opt_state, metrics)`,
`batches` being one step's list of micro-batches.

The port's jit engine is the staged engine (`core/engine.py`) with its
placement from `RunSettings.activation_policy`, so a step is
`engine.train_step`. The metrics are the JAX step's (`ce`, `tokens`,
`loss`, and `moe_lb` / `moe_z` for an MoE model) plus the engine's
`StepReport` under `report` (not a number, so the loop's JSONL and the
session's rows skip it).
"""
from __future__ import annotations

from typing import Callable, Dict

from repro_torch.runtime.trainer import batch_tokens


def _metrics(rep, batches) -> Dict:
    out = {"ce": rep.extra.get("ce", rep.loss),
           "tokens": float(sum(batch_tokens(b) for b in batches))}
    for k in ("moe_lb", "moe_z"):
        if k in rep.extra:
            out[k] = rep.extra[k]
    out.update(loss=rep.loss, report=rep)
    return out


def make_host_train_step(engine) -> Callable:
    """The serial step: forward, backward and the optimizer's fused
    update (the caller's TrainLoop stages the optimizer state between
    steps with `host_offload="opt_state"`)."""

    def step_fn(params, opt_state, batches):
        params, opt_state, rep = engine.train_step(params, opt_state,
                                                   batches)
        return params, opt_state, _metrics(rep, batches)

    return step_fn


def make_overlap_train_step(engine, opt_bridge) -> Callable:
    """The overlap step: backward hands each layer's gradients to the
    bridge (`engine.settings.opt_sink` is `opt_bridge`), whose worker
    updates that layer while backward goes on; `finish_step` joins it
    and updates the rest of the tree. `opt_state` is the bridge's light
    `(step, None, None)` once it is seeded; a full state seeds it (init
    and resume both land here)."""
    if engine.settings.opt_sink is not opt_bridge:
        raise ValueError("the engine's settings.opt_sink must be the "
                         "bridge the step drives")

    def finish(grads, opt_state, params):
        return opt_bridge.finish_step(params, grads)

    def step_fn(params, opt_state, batches):
        opt_bridge.ensure_seeded(opt_state, params)
        opt_bridge.begin_step(params, int(opt_state.step))
        params, opt_state, rep = engine.train_step(params, opt_state,
                                                   batches, update=finish)
        return params, opt_state, _metrics(rep, batches)

    return step_fn


__all__ = ["make_host_train_step", "make_overlap_train_step"]
